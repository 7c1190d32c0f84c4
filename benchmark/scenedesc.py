"""A scene as plain data: the textures, materials, meshes and spheres a
scene file adds, in the order it adds them.

Both sides are built from one description. ``replay`` makes the same calls
on the program's ``SceneBuilder`` (texture and material ids are the order of
addition on both), and the plain reference reads the same lists
(``reference/render.py``). The description imports nothing of the
program.
"""

from __future__ import annotations

import numpy as np

# the colour the reference renderer gives a texture whose file is missing
MISSING_TEXTURE_COLOR = (1.0, 0.0, 1.0)


class SceneDesc:
    """The calls that make a scene, recorded with the signatures of the
    program's ``SceneBuilder`` (``models/scene.py``)."""

    def __init__(self):
        self.calls = []
        self.textures = []   # dicts: kind solid | checker | image
        self.materials = []  # dicts: kind pbr | metal | dielectric | light
        self.meshes = []     # (positions [P,3], uvs [P,2], indices [F,3], mat)
        self.spheres = []    # (c0, c1, t0, t1, radius, mat)

    def _record(self, name, *args, **kwargs):
        self.calls.append((name, args, kwargs))

    def add_solid_texture(self, color) -> int:
        self._record("add_solid_texture", tuple(color))
        self.textures.append(dict(kind="solid", c0=tuple(color)))
        return len(self.textures) - 1

    def add_checker_texture(self, even, odd) -> int:
        self._record("add_checker_texture", tuple(even), tuple(odd))
        self.textures.append(dict(kind="checker", c0=tuple(even),
                                  c1=tuple(odd)))
        return len(self.textures) - 1

    def add_image_texture(self, image) -> int:
        """``image`` uint8 ``[H, W, 3]``; None is a missing file, which
        renders as the magenta sentinel colour."""
        self._record("add_image_texture", image)
        if image is None:
            self.textures.append(dict(kind="solid",
                                      c0=MISSING_TEXTURE_COLOR))
        else:
            self.textures.append(dict(
                kind="image", image=np.asarray(image, np.float32)))
        return len(self.textures) - 1

    def add_pbr_material(self, albedo_tex=-1, normal_tex=-1, metallic_tex=-1,
                         roughness_tex=-1, base_color=(1.0, 1.0, 1.0, 1.0),
                         metallic=0.0, roughness=0.0) -> int:
        self._record("add_pbr_material", albedo_tex=albedo_tex,
                     normal_tex=normal_tex, metallic_tex=metallic_tex,
                     roughness_tex=roughness_tex, base_color=base_color,
                     metallic=metallic, roughness=roughness)
        self.materials.append(dict(
            kind="pbr", albedo=albedo_tex, normal=normal_tex,
            metal=metallic_tex, rough=roughness_tex,
            base_color=tuple(base_color), metallic=float(metallic),
            roughness=float(roughness)))
        return len(self.materials) - 1

    def add_metal_material(self, albedo, fuzz=0.0) -> int:
        self._record("add_metal_material", tuple(albedo), fuzz)
        self.materials.append(dict(kind="metal", albedo=tuple(albedo),
                                   fuzz=min(float(fuzz), 1.0)))
        return len(self.materials) - 1

    def add_dielectric_material(self, ior) -> int:
        self._record("add_dielectric_material", ior)
        self.materials.append(dict(kind="dielectric", ior=float(ior)))
        return len(self.materials) - 1

    def add_light_material(self, color) -> int:
        """A light of one solid colour (``SceneBuilder`` adds the colour's
        texture first)."""
        self._record("add_light_material", color=tuple(color))
        self.textures.append(dict(kind="solid", c0=tuple(color)))
        self.materials.append(dict(kind="light", color=tuple(color)))
        return len(self.materials) - 1

    def add_mesh(self, positions, texcoords, indices, material) -> None:
        self._record("add_mesh", positions, texcoords, indices, material)
        self.meshes.append((np.asarray(positions, np.float32).reshape(-1, 3),
                            np.asarray(texcoords, np.float32).reshape(-1, 2),
                            np.asarray(indices, np.int64).reshape(-1, 3),
                            material))

    def add_sphere(self, center, radius, material, center1=None,
                   time0=0.0, time1=1.0) -> None:
        self._record("add_sphere", tuple(center), radius, material,
                     center1=None if center1 is None else tuple(center1),
                     time0=time0, time1=time1)
        c0 = tuple(float(x) for x in center)
        c1 = c0 if center1 is None else tuple(float(x) for x in center1)
        self.spheres.append((c0, c1, float(time0), float(time1),
                             float(radius), material))

    def replay(self, target):
        """Make every recorded call on ``target``, in order."""
        for name, args, kwargs in self.calls:
            getattr(target, name)(*args, **kwargs)
        return target
