"""Asset-free scene presets (counterpart of ``models/presets.py``).

Each preset returns ``(SceneData, RenderConfig)``, the scene on
``device``: the card unless the caller asks for ``"cpu"``. The parts of the
flagship scene that need no asset files are ported (the ground, the HDR
light, the sentinel-textured iron sphere and the mirror sphere); the
Master Chief glTF and its loader wait until the asset is in the
repository. ``flagship_standin`` puts a procedural relief mesh with the
chief's triangle count in the chief's place.

Asset files are read from ``data_dir`` (default: ``$SRT_DATA_DIR``, else
``data/`` at the repository root). A missing file yields the reference's
magenta sentinel texture, as in the reference itself.
"""

from __future__ import annotations

import os

import numpy as np

from sexy_raytracer_tpu_torch.models.scene import SceneBuilder
from sexy_raytracer_tpu_torch.utils.config import CameraConfig, RenderConfig
from sexy_raytracer_tpu_torch.utils.png import read_png

# the Master Chief mesh's triangle count (2 * 39**2)
CHIEF_TRIANGLES = 3042


def default_data_dir() -> str:
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.environ.get("SRT_DATA_DIR", os.path.join(repo, "data"))


def _add_ground_and_lights(b: SceneBuilder) -> None:
    """Shared furniture of the flagship scene (reference main.cpp:89-144)."""
    checker = b.add_checker_texture((0.2, 0.3, 0.1), (0.9, 0.9, 0.9))
    ground = b.add_pbr_material(albedo_tex=checker)
    b.add_sphere((0.0, -1000.0, 0.0), 1000.0, ground, time0=0.0, time1=1.0)
    light = b.add_light_material(color=(250.2, 220.9, 110.2))
    b.add_sphere((-7.0, 4.0, 6.0), 1.0, light)


def _add_iron_and_metal(b: SceneBuilder, data_dir: str) -> None:
    # rustediron PBR sphere (main.cpp:133-141). The reference asks for
    # "-2x1"-suffixed files that do not exist in its data, so its textures
    # are magenta sentinels — reproduced via read_png -> None.
    iron_albedo = b.add_image_texture(
        read_png(os.path.join(data_dir, "rustediron2_basecolor-2x1.png"), 3)
    )
    iron_normal = b.add_image_texture(
        read_png(os.path.join(data_dir, "rustediron2_normal-2x1.png"), 3)
    )
    iron_metal = b.add_image_texture(
        read_png(os.path.join(data_dir, "rustediron2_metallic-2x1.png"), 1)
    )
    iron_rough = b.add_image_texture(
        read_png(os.path.join(data_dir, "rustediron2_roughness-2x1.png"), 1)
    )
    iron = b.add_pbr_material(
        albedo_tex=iron_albedo,
        normal_tex=iron_normal,
        metallic_tex=iron_metal,
        roughness_tex=iron_rough,
        base_color=(1.0, 1.0, 1.0, 1.0),
    )
    b.add_sphere((-3.0, 1.0, 0.0), 1.0, iron)

    metal = b.add_metal_material((0.7, 0.6, 0.5), 0.0)  # main.cpp:143-144
    b.add_sphere((3.0, 1.0, 0.0), 1.0, metal)


def _flagship_camera() -> CameraConfig:
    # reference main.cpp:163-172
    return CameraConfig(
        eye=(0.0, 3.0, 5.0),
        look_at=(0.0, 2.5, 0.0),
        up=(0.0, 1.0, 0.0),
        vfov_degrees=70.0,
        aperture=0.1,
        focus_dist=10.0,
        time0=0.0,
        time1=1.0,
    )


def add_relief_mesh(b, n: int = 39) -> None:
    """Add a procedural relief of ``2 n^2`` triangles in the chief's place.

    The terrain heightfield of ``tools/profile.py`` (an ``n x n`` quad
    grid over [-30, 30]^2, height ``2 sin(0.4x) cos(0.3z) + 0.5 sin(1.7x)``)
    is stood upright, scaled to 3 x 3 units around (0, 2.5, 0), and wound
    so that every face looks towards the flagship eye at (0, 3, 5): the
    find kernels cull back faces. Its PBR material samples an image albedo
    and an image normal map, both made in memory, so the atlas gather and
    normal mapping run. ``b`` is this package's ``SceneBuilder`` or the
    JAX package's: both take the same numpy inputs.
    """
    xs = np.linspace(-30.0, 30.0, n + 1)
    X, Z = np.meshgrid(xs, xs, indexing="ij")
    Y = 2.0 * np.sin(X * 0.4) * np.cos(Z * 0.3) + 0.5 * np.sin(X * 1.7)
    s = 1.5 / 30.0
    verts = np.stack([X * s, 2.5 - Z * s, Y * s], axis=-1).reshape(-1, 3)
    gi, gj = np.meshgrid(np.arange(n + 1), np.arange(n + 1), indexing="ij")
    uvs = np.stack([gi / n, gj / n], axis=-1).reshape(-1, 2)
    ii, jj = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    a = (ii * (n + 1) + jj).ravel()
    c = a + (n + 1)
    idx = np.concatenate(
        [np.stack([a, a + 1, c], 1), np.stack([a + 1, c + 1, c], 1)]
    )
    # face the eye: flip every triangle whose normal points away from it
    v0, v1, v2 = verts[idx[:, 0]], verts[idx[:, 1]], verts[idx[:, 2]]
    normal = np.cross(v1 - v0, v2 - v0)
    to_eye = np.array([0.0, 3.0, 5.0]) - (v0 + v1 + v2) / 3.0
    away = np.sum(normal * to_eye, axis=1) < 0.0
    idx[away] = idx[away][:, [0, 2, 1]]

    ki, kj = np.meshgrid(np.arange(32), np.arange(32), indexing="ij")
    albedo = (np.stack([ki, kj, ki ^ kj], axis=-1) * 8).astype(np.uint8)
    ang = (2.0 * np.pi / 32.0) * np.stack([ki, kj], axis=-1)
    normal_map = np.concatenate(
        [128.0 + 40.0 * np.sin(ang), np.full((32, 32, 1), 240.0)], axis=-1
    ).astype(np.uint8)
    mat = b.add_pbr_material(
        albedo_tex=b.add_image_texture(albedo),
        normal_tex=b.add_image_texture(normal_map),
        base_color=(0.9, 0.8, 0.7, 1.0),
        metallic=0.2,
        roughness=0.5,
    )
    b.add_mesh(verts, uvs, idx, mat)


def flagship_standin(n: int = 39, spp: int = 8, height: int = 720,
                     data_dir: str | None = None, device="cuda",
                     build_bvh: bool = False):
    """The flagship scene with the relief mesh in place of Master Chief.

    Same composition order as ``masterchief`` (reference main.cpp:54-154):
    the mesh, then the ground and light, then the iron and mirror spheres,
    under the flagship camera. ``n = 389`` is the big scene: the
    ``tools/profile.py`` terrain size, 302,642 triangles, past the resident
    find's limit (``ops/intersect.PALLAS_RESIDENT_MAX_TRIS``).

    No BVH by default: this preset has no JAX counterpart, its find
    kernels need none, and with one every train step that moves a sphere
    would refit it (``diff/params.merge_params``).
    """
    data_dir = data_dir or default_data_dir()
    b = SceneBuilder()
    add_relief_mesh(b, n)
    _add_ground_and_lights(b)
    _add_iron_and_metal(b, data_dir)
    scene = b.build(build_bvh=build_bvh, device=device)
    cfg = RenderConfig(
        width=int(height * 16 / 9),
        height=height,
        samples_per_pixel=spp,
        max_bounce=4,
        camera=_flagship_camera(),
    )
    return scene, cfg


def shirley_spheres(seed: int = 4, spp: int = 16, height: int = 240,
                    device="cuda"):
    """The book's random-sphere field (reference main.cpp:92-122).
    Deterministic via a seeded numpy Generator."""
    rng = np.random.default_rng(seed)
    b = SceneBuilder()

    checker = b.add_checker_texture((0.2, 0.3, 0.1), (0.9, 0.9, 0.9))
    b.add_sphere((0, -1000, 0), 1000.0, b.add_pbr_material(albedo_tex=checker))

    for a in range(-11, 11):
        for bb in range(-11, 11):
            choose = rng.random()
            center = np.array(
                [a + 0.9 * rng.random(), 0.2, bb + 0.9 * rng.random()]
            )
            if np.linalg.norm(center - np.array([4.0, 0.2, 0.0])) <= 0.9:
                continue
            if choose < 0.8:
                albedo = rng.random(3) * rng.random(3)
                # reference ctor pbrMetallicRoughness(color3f) wraps the
                # color in a solidColor albedo map (material.h:25-28)
                mat = b.add_pbr_material(
                    albedo_tex=b.add_solid_texture(albedo)
                )
                center2 = center + np.array([0.0, rng.random() * 0.5, 0.0])
                b.add_sphere(center, 0.2, mat, center1=center2)
            elif choose < 0.95:
                albedo = 0.5 + 0.5 * rng.random(3)
                fuzz = 0.5 * rng.random()
                b.add_sphere(center, 0.2, b.add_metal_material(albedo, fuzz))
            else:
                b.add_sphere(center, 0.2, b.add_dielectric_material(1.5))

    b.add_sphere((0, 1, 0), 1.0, b.add_dielectric_material(1.5))
    b.add_sphere(
        (-4, 1, 0),
        1.0,
        b.add_pbr_material(albedo_tex=b.add_solid_texture((0.4, 0.2, 0.1))),
    )
    b.add_sphere((4, 1, 0), 1.0, b.add_metal_material((0.7, 0.6, 0.5), 0.0))

    scene = b.build(device=device)
    cfg = RenderConfig(
        width=int(height * 16 / 9),
        height=height,
        samples_per_pixel=spp,
        max_bounce=4,
        camera=CameraConfig(
            eye=(13.0, 2.0, 3.0),
            look_at=(0.0, 0.0, 0.0),
            vfov_degrees=20.0,
            aperture=0.1,
            focus_dist=10.0,
        ),
    )
    return scene, cfg


def rustediron_globe(data_dir: str | None = None, spp: int = 64,
                     height: int = 480, device="cuda"):
    """The rusted-iron PBR globe under the flagship furniture."""
    data_dir = data_dir or default_data_dir()
    b = SceneBuilder()
    _add_ground_and_lights(b)
    _add_iron_and_metal(b, data_dir)
    scene = b.build(device=device)
    cfg = RenderConfig(
        width=int(height * 16 / 9),
        height=height,
        samples_per_pixel=spp,
        max_bounce=4,
        camera=_flagship_camera(),
    )
    return scene, cfg
