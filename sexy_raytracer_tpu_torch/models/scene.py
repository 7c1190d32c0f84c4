"""Flat SoA scene representation + host-side builder.

Counterpart of ``sexy_raytracer_tpu/models/scene.py``. The builder is a
numpy copy of the JAX package's (that package cannot be imported where
there is no JAX), and ``build()`` produces exactly the arrays the JAX
``build(device=False)`` produces, BVH included, as torch tensors under
the same field names. ``scene_from_numpy`` carries a JAX scene across.

The scene is a struct-of-arrays ``NamedTuple`` of tensors, mirroring the
reference's ``hittableIndexed`` (reference hittableindexed.h:24-38): real
UVs, material indices, sphere leaves and precomputed triangle
intersection data.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import NamedTuple, Optional

import numpy as np
import torch

from sexy_raytracer_tpu_torch.models.bvh import build_bvh as _build_bvh
from sexy_raytracer_tpu_torch.models.clusters import triangle_order

# Material kinds (reference material.h classes)
MAT_PBR = 0          # pbrMetallicRoughness, material.h:23
MAT_METAL = 1        # metal, material.h:87
MAT_DIELECTRIC = 2   # dielectric, material.h:104
MAT_LIGHT = 3        # diffuseLight, material.h:139

# Texture kinds (reference texture.h classes)
TEX_NONE = -1
TEX_SOLID = 0        # solidColor, texture.h:18
TEX_CHECKER = 1      # checker, texture.h:34
TEX_IMAGE = 2        # imagePNG/image3bpp, texture.h:54,109

# Magenta sentinel returned for missing image files (reference texture.h:131)
MISSING_TEXTURE_COLOR = (1.0, 0.0, 1.0)


class SceneData(NamedTuple):
    """Scene tensors; counts are static via ``.shape``.

    Triangles are stored with fully precomputed plane/edge data so that
    intersection is dot products only (see ops/intersect.py):

      ``t = -(N.o + d) / (N.dir)`` and edge tests ``q_i.p - c_i >= 0`` where
      ``q_i = N x e_i`` and ``c_i = q_i . v_i`` — algebraically identical to
      the reference's cross-product inside tests (reference model.h:136-154).
    """

    # -- triangles [T] ---------------------------------------------------
    tri_v0: torch.Tensor      # [T,3]
    tri_v1: torch.Tensor      # [T,3]
    tri_v2: torch.Tensor      # [T,3]
    tri_uv0: torch.Tensor     # [T,2]
    tri_uv1: torch.Tensor     # [T,2]
    tri_uv2: torch.Tensor     # [T,2]
    tri_mat: torch.Tensor     # [T] int32

    # -- spheres [S] (moving: lerp c0->c1 over [t0,t1], sphere.h:47-52) --
    sph_c0: torch.Tensor      # [S,3]
    sph_c1: torch.Tensor      # [S,3]
    sph_t0: torch.Tensor      # [S]
    sph_t1: torch.Tensor      # [S]
    sph_radius: torch.Tensor  # [S]
    sph_mat: torch.Tensor     # [S] int32

    # -- materials [M] ---------------------------------------------------
    mat_type: torch.Tensor        # [M] int32, MAT_*
    mat_base_color: torch.Tensor  # [M,4] pbr albedo factor / metal albedo rgb
    mat_metallic: torch.Tensor    # [M] pbr metallic factor
    mat_roughness: torch.Tensor   # [M] pbr roughness factor
    mat_fuzz: torch.Tensor        # [M] metal fuzz
    mat_ior: torch.Tensor         # [M] dielectric index of refraction
    mat_albedo_tex: torch.Tensor  # [M] int32 texture id or -1
    mat_normal_tex: torch.Tensor  # [M] int32
    mat_metallic_tex: torch.Tensor   # [M] int32 (red channel / 255, material.h:191)
    mat_roughness_tex: torch.Tensor  # [M] int32 (green channel / 255, material.h:197)
    mat_mr_tex: torch.Tensor      # [M] int32 combined metallic-roughness map.
    #   Parity note: the reference *loads* this map (model.h:430-437) but its
    #   scatter() never samples it (material.h:190-200 test the separate
    #   maps, which the glTF path leaves null) — we record it for fidelity
    #   and likewise never sample it in quirk-faithful mode.
    mat_emit_tex: torch.Tensor    # [M] int32 emission texture (diffuseLight)

    # -- baked shading pack (fast path; see bake notes in build()) -------
    # Per-material 8-channel map pack: albedo texel rgb, normal texel rgb,
    # metallic (map channel 0), roughness (map channel 1) — all 0-255
    # reference scale. ONE gather per shaded ray replaces four separate
    # atlas fetches; this is also the inverse-rendering texture target.
    shade_atlas: torch.Tensor     # [Lm,Hm,Wm,8] float32
    mat_pack_layer: torch.Tensor  # [M] int32 layer or -1
    mat_pack_w: torch.Tensor      # [M] int32
    mat_pack_h: torch.Tensor      # [M] int32
    # Per-slot texture kinds: 0 = none (use the scalar factor), 2 =
    # procedural checker evaluated inline from the hit point (a solid
    # texture in a slot is a checker with equal colors), 3 = image baked
    # into the shading pack. Albedo additionally has 1 = solid (the
    # reference's solid-PBR ctor semantics, material.h:165-167).
    mat_albedo_kind: torch.Tensor  # [M] int32: 0 none, 1 solid, 2 checker, 3 image
    mat_normal_kind: torch.Tensor  # [M] int32: 0/2/3
    mat_metal_kind: torch.Tensor   # [M] int32: 0/2/3
    mat_rough_kind: torch.Tensor   # [M] int32: 0/2/3
    mat_emit_kind: torch.Tensor    # [M] int32: 1 solid (default black), 2, 3
    mat_albedo_c0: torch.Tensor    # [M,3] solid color / checker even
    mat_albedo_c1: torch.Tensor    # [M,3] checker odd
    mat_emit_rgb: torch.Tensor     # [M,3] solid emission / checker even
    mat_emit_c1: torch.Tensor      # [M,3] emission checker odd
    mat_metal_cc: torch.Tensor     # [M,2] checker even/odd *red* channel
    mat_rough_cc: torch.Tensor     # [M,2] checker even/odd *green* channel
    mat_normal_c0: torch.Tensor    # [M,3] normal-slot checker even
    mat_normal_c1: torch.Tensor    # [M,3] normal-slot checker odd

    # -- texture table [K] ----------------------------------------------
    tex_type: torch.Tensor    # [K] int32, TEX_*
    tex_color0: torch.Tensor  # [K,3] solid color / checker even (texture.h:40)
    tex_color1: torch.Tensor  # [K,3] checker odd
    tex_layer: torch.Tensor   # [K] int32 atlas layer for TEX_IMAGE
    tex_w: torch.Tensor       # [K] int32 image width
    tex_h: torch.Tensor       # [K] int32 image height
    atlas: torch.Tensor       # [L,H,W,3] float32, raw 0-255 texel scale to
    #   match reference texture.h:147 (consumers divide by 255,
    #   material.h:166). Differentiable inverse-rendering target.

    # -- BVH over all primitives (see models/bvh.py) ---------------------
    # Interior node i: children bvh_left/right[i] >= 0 are node ids.
    # Leaf: bvh_left[i] == -1, bvh_right[i] = global primitive id
    # (tri idx in [0,T), sphere idx T+[0,S)). Root is node 0
    # (flattening invariant of reference bvh.h:112-148 / model.h:271).
    bvh_min: torch.Tensor     # [N,3]
    bvh_max: torch.Tensor     # [N,3]
    bvh_left: torch.Tensor    # [N] int32
    bvh_right: torch.Tensor   # [N] int32
    bvh_skip: torch.Tensor    # [N] int32 preorder escape index — enables the
    #   stackless threaded traversal (models/bvh.py compute_skip)

    # -- derived triangle intersection pack (see prepare()) -------------
    tri_n: torch.Tensor       # [T,3] unnormalized geometric normal (model.h:276)
    tri_d: torch.Tensor       # [T]   plane offset  -N.v0 (model.h:125)
    tri_q: torch.Tensor       # [T,3,3] q_i = N x e_i edge test vectors
    tri_c: torch.Tensor       # [T,3]   c_i = q_i . v_i edge test offsets

    # -- triangle cluster AABBs for the lockstep cull kernel -------------
    # Triangles are stored in spatial (BVH-DFS) order; cluster c covers
    # triangles [c*CLUSTER_SIZE, (c+1)*CLUSTER_SIZE) (models/clusters.py,
    # consumed by ops/pallas_find.py). Static per scene (not trainable).
    cluster_min: torch.Tensor  # [NC,3]
    cluster_max: torch.Tensor  # [NC,3]

    # ------------------------------------------------------------------
    @property
    def num_triangles(self) -> int:
        return self.tri_v0.shape[0]

    @property
    def num_spheres(self) -> int:
        return self.sph_c0.shape[0]

    @property
    def num_materials(self) -> int:
        return self.mat_type.shape[0]

    @property
    def num_textures(self) -> int:
        return self.tex_type.shape[0]

    @property
    def num_bvh_nodes(self) -> int:
        return self.bvh_min.shape[0]

    @property
    def device(self) -> torch.device:
        return self.tri_v0.device

    def to(self, device) -> "SceneData":
        """The same scene with every tensor on ``device``."""
        return SceneData(*(a.to(device) for a in self))


def scene_from_numpy(fields, device="cuda") -> SceneData:
    """A scene given as numpy arrays -> ``SceneData`` of tensors on
    ``device`` (the card unless the caller asks for ``"cpu"``).

    ``fields`` is a mapping of field name to array, or any NamedTuple with
    the same field names, such as the JAX package's
    ``SceneBuilder.build(device=False)`` or a ``jax.device_get`` of its
    scene. Dtypes are kept (float32 and int32).
    """
    if hasattr(fields, "_asdict"):
        fields = fields._asdict()
    missing = [k for k in SceneData._fields if k not in fields]
    if missing:
        raise KeyError(f"scene fields missing: {missing}")
    return SceneData(**tensors_from_numpy(
        {k: fields[k] for k in SceneData._fields}, device))


def tensors_from_numpy(arrays, device="cuda") -> dict:
    """A mapping of name -> array -> a dict of name -> tensor on ``device``,
    dtypes kept. An array is anything ``np.array`` reads (numpy, a JAX
    array) and is copied; a tensor is moved to ``device`` as it is. It
    carries scenes, initial parameters and trained parameters across.
    """
    return {k: v.to(device) if torch.is_tensor(v)
            else torch.from_numpy(np.array(v, copy=True)).to(device)
            for k, v in arrays.items()}


def prepare_triangles(tri_v0, tri_v1, tri_v2):
    """Precompute the triangle plane/edge pack, of numpy arrays or of
    tensors.

    ``N`` is the unnormalized cross of edges exactly as the reference's
    ``triangle::getNormal`` (model.h:276-283); edge vectors follow the
    inside-test order of model.h:136-154 (e0 at v0, e1 at v1, e2 at v2).
    """
    if torch.is_tensor(tri_v0):
        cross, stack = torch.linalg.cross, torch.stack
    else:
        cross, stack = np.cross, np.stack
    n = cross(tri_v1 - tri_v0, tri_v2 - tri_v0)
    d = -(n * tri_v0).sum(-1)
    e0 = tri_v1 - tri_v0
    e1 = tri_v2 - tri_v1
    e2 = tri_v0 - tri_v2
    q0 = cross(n, e0)
    q1 = cross(n, e1)
    q2 = cross(n, e2)
    c0 = (q0 * tri_v0).sum(-1)
    c1 = (q1 * tri_v1).sum(-1)
    c2 = (q2 * tri_v2).sum(-1)
    q = stack([q0, q1, q2], -2)  # [T,3,3]
    c = stack([c0, c1, c2], -1)  # [T,3]
    return n, d, q, c


class SceneBuilder:
    """Host-side scene assembly -> ``SceneData``.

    Mirrors the reference's scene construction flow (main.cpp:54-154): add
    textures, materials, meshes, and spheres, then ``build()`` flattens
    everything into SoA numpy arrays and wraps them as tensors.
    """

    def __init__(self):
        self._textures = []  # dicts
        self._images = []    # list of np arrays [H,W,3] float32 (0-255 scale)
        self._materials = []
        self._tri_v = []     # list of ([P,3] positions, [P,2] uvs, [F,3] idx, mat)
        self._spheres = []

    # -- textures --------------------------------------------------------
    def add_solid_texture(self, color) -> int:
        self._textures.append(
            dict(type=TEX_SOLID, color0=tuple(color), color1=(0, 0, 0), image=-1)
        )
        return len(self._textures) - 1

    def add_checker_texture(self, even, odd) -> int:
        # reference texture.h:34-52 (even/odd selected by sin product sign)
        self._textures.append(
            dict(type=TEX_CHECKER, color0=tuple(even), color1=tuple(odd), image=-1)
        )
        return len(self._textures) - 1

    def add_image_texture(self, image: Optional[np.ndarray]) -> int:
        """``image``: uint8/float ``[H,W,3]``; None -> magenta sentinel solid
        (reference texture.h:117-131)."""
        if image is None:
            self._textures.append(
                dict(
                    type=TEX_SOLID,
                    color0=MISSING_TEXTURE_COLOR,
                    color1=(0, 0, 0),
                    image=-1,
                )
            )
            return len(self._textures) - 1
        img = np.asarray(image, dtype=np.float32)
        if img.ndim == 2:
            img = img[..., None]
        if img.shape[-1] == 1:
            img = np.repeat(img, 3, axis=-1)
        elif img.shape[-1] == 4:
            img = img[..., :3]
        self._images.append(img)
        self._textures.append(
            dict(
                type=TEX_IMAGE,
                color0=(0, 0, 0),
                color1=(0, 0, 0),
                image=len(self._images) - 1,
            )
        )
        return len(self._textures) - 1

    # -- materials -------------------------------------------------------
    def add_pbr_material(
        self,
        albedo_tex: int = TEX_NONE,
        normal_tex: int = TEX_NONE,
        metallic_tex: int = TEX_NONE,
        roughness_tex: int = TEX_NONE,
        mr_tex: int = TEX_NONE,
        base_color=(1.0, 1.0, 1.0, 1.0),
        metallic: float = 0.0,
        roughness: float = 0.0,
    ) -> int:
        """pbrMetallicRoughness (reference material.h:23-85).

        The reference's 9 constructor overloads collapse to keyword args.
        A solid-color convenience: pass ``albedo_tex=builder.add_solid_texture(c)``
        to reproduce the ``pbrMetallicRoughness(color3f)`` ctor (material.h:25-28)
        — including its /255 scatter quirk (material.h:165-167).
        """
        self._materials.append(
            dict(
                type=MAT_PBR,
                base_color=tuple(base_color),
                metallic=metallic,
                roughness=roughness,
                fuzz=0.0,
                ior=1.0,
                albedo_tex=albedo_tex,
                normal_tex=normal_tex,
                metallic_tex=metallic_tex,
                roughness_tex=roughness_tex,
                mr_tex=mr_tex,
                emit_tex=TEX_NONE,
            )
        )
        return len(self._materials) - 1

    def add_metal_material(self, albedo, fuzz: float = 0.0) -> int:
        # reference material.h:87-102; fuzz clamped to <= 1 (material.h:89)
        self._materials.append(
            dict(
                type=MAT_METAL,
                base_color=(albedo[0], albedo[1], albedo[2], 1.0),
                metallic=0.0,
                roughness=0.0,
                fuzz=min(float(fuzz), 1.0),
                ior=1.0,
                albedo_tex=TEX_NONE,
                normal_tex=TEX_NONE,
                metallic_tex=TEX_NONE,
                roughness_tex=TEX_NONE,
                mr_tex=TEX_NONE,
                emit_tex=TEX_NONE,
            )
        )
        return len(self._materials) - 1

    def add_dielectric_material(self, ior: float) -> int:
        # reference material.h:104-137
        self._materials.append(
            dict(
                type=MAT_DIELECTRIC,
                base_color=(1.0, 1.0, 1.0, 1.0),
                metallic=0.0,
                roughness=0.0,
                fuzz=0.0,
                ior=float(ior),
                albedo_tex=TEX_NONE,
                normal_tex=TEX_NONE,
                metallic_tex=TEX_NONE,
                roughness_tex=TEX_NONE,
                mr_tex=TEX_NONE,
                emit_tex=TEX_NONE,
            )
        )
        return len(self._materials) - 1

    def add_light_material(self, color=None, emit_tex: int = TEX_NONE) -> int:
        # reference material.h:139-154
        if color is not None:
            emit_tex = self.add_solid_texture(color)
        self._materials.append(
            dict(
                type=MAT_LIGHT,
                base_color=(0.0, 0.0, 0.0, 1.0),
                metallic=0.0,
                roughness=0.0,
                fuzz=0.0,
                ior=1.0,
                albedo_tex=TEX_NONE,
                normal_tex=TEX_NONE,
                metallic_tex=TEX_NONE,
                roughness_tex=TEX_NONE,
                mr_tex=TEX_NONE,
                emit_tex=emit_tex,
            )
        )
        return len(self._materials) - 1

    # -- geometry --------------------------------------------------------
    def add_mesh(self, positions, texcoords, indices, material: int) -> None:
        """Indexed triangle mesh (one glTF primitive, reference model.h:51-75).

        ``positions`` [P,3], ``texcoords`` [P,2] (may be None -> zeros),
        ``indices`` [F,3] vertex indices.
        """
        positions = np.asarray(positions, dtype=np.float32).reshape(-1, 3)
        indices = np.asarray(indices, dtype=np.int64).reshape(-1, 3)
        if texcoords is None:
            texcoords = np.zeros((positions.shape[0], 2), dtype=np.float32)
        texcoords = np.asarray(texcoords, dtype=np.float32).reshape(-1, 2)
        self._tri_v.append((positions, texcoords, indices, material))

    def add_sphere(
        self,
        center,
        radius: float,
        material: int,
        center1=None,
        time0: float = 0.0,
        time1: float = 1.0,
    ) -> None:
        """Sphere / moving sphere (reference sphere.h:11-15)."""
        c0 = tuple(center)
        c1 = c0 if center1 is None else tuple(center1)
        self._spheres.append((c0, c1, float(time0), float(time1), float(radius), material))

    # -- build -----------------------------------------------------------
    def build(self, build_bvh: bool = True, device="cuda") -> SceneData:
        """Flatten the scene -> ``SceneData`` of tensors on ``device``: the
        card unless the caller asks for ``"cpu"``. Without a card the
        default raises torch's own error; there is no fallback.

        ``build_bvh``: build the median-split BVH over every primitive
        (``models/bvh.py``) into the ``bvh_*`` fields, as the JAX package
        does by default. The find kernels cull clusters and need no BVH;
        the skip-link traversal ``find_hit(method="bvh")`` does. Without
        it, or for an empty scene, the ``bvh_*`` fields are empty.
        """
        fields = self._build_numpy()
        if build_bvh and (fields["tri_v0"].shape[0]
                          + fields["sph_c0"].shape[0]) > 0:
            bvh = _build_bvh(SimpleNamespace(**fields))
            fields.update(bvh_min=bvh.node_min, bvh_max=bvh.node_max,
                          bvh_left=bvh.left, bvh_right=bvh.right,
                          bvh_skip=bvh.skip)
        return scene_from_numpy(fields, device)

    def _build_numpy(self) -> dict:
        f32, i32 = np.float32, np.int32

        # triangles
        v0s, v1s, v2s, uv0s, uv1s, uv2s, tmats = [], [], [], [], [], [], []
        for positions, texcoords, indices, mat in self._tri_v:
            v0s.append(positions[indices[:, 0]])
            v1s.append(positions[indices[:, 1]])
            v2s.append(positions[indices[:, 2]])
            uv0s.append(texcoords[indices[:, 0]])
            uv1s.append(texcoords[indices[:, 1]])
            uv2s.append(texcoords[indices[:, 2]])
            tmats.append(np.full(indices.shape[0], mat, dtype=i32))

        def cat(parts, empty_shape):
            if parts:
                return np.concatenate(parts, axis=0)
            return np.zeros(empty_shape, dtype=f32)

        tri_v0 = cat(v0s, (0, 3)).astype(f32)
        tri_v1 = cat(v1s, (0, 3)).astype(f32)
        tri_v2 = cat(v2s, (0, 3)).astype(f32)
        tri_uv0 = cat(uv0s, (0, 2)).astype(f32)
        tri_uv1 = cat(uv1s, (0, 2)).astype(f32)
        tri_uv2 = cat(uv2s, (0, 2)).astype(f32)
        tri_mat = (
            np.concatenate(tmats) if tmats else np.zeros((0,), dtype=i32)
        )

        # spatial (BVH-DFS) triangle ordering + cluster AABBs for the
        # cluster cull (models/clusters.py, ops/find.py). Rendering is
        # order-independent (true closest hit — the traversal-order quirk
        # of model.h:128 is deliberately dropped), so permuting here is
        # semantics-preserving.
        order, cluster_min, cluster_max = triangle_order(tri_v0, tri_v1, tri_v2)
        if order.size:
            tri_v0, tri_v1, tri_v2 = tri_v0[order], tri_v1[order], tri_v2[order]
            tri_uv0, tri_uv1, tri_uv2 = tri_uv0[order], tri_uv1[order], tri_uv2[order]
            tri_mat = tri_mat[order]

        # spheres
        S = len(self._spheres)
        sph_c0 = np.zeros((S, 3), f32)
        sph_c1 = np.zeros((S, 3), f32)
        sph_t0 = np.zeros((S,), f32)
        sph_t1 = np.ones((S,), f32)
        sph_radius = np.zeros((S,), f32)
        sph_mat = np.zeros((S,), i32)
        for i, (c0, c1, t0, t1, r, m) in enumerate(self._spheres):
            sph_c0[i], sph_c1[i] = c0, c1
            sph_t0[i], sph_t1[i], sph_radius[i], sph_mat[i] = t0, t1, r, m

        # materials (always at least one so gathers are safe)
        mats = self._materials or [
            dict(
                type=MAT_PBR,
                base_color=(1, 1, 1, 1),
                metallic=0.0,
                roughness=0.0,
                fuzz=0.0,
                ior=1.0,
                albedo_tex=TEX_NONE,
                normal_tex=TEX_NONE,
                metallic_tex=TEX_NONE,
                roughness_tex=TEX_NONE,
                mr_tex=TEX_NONE,
                emit_tex=TEX_NONE,
            )
        ]
        M = len(mats)
        mat_type = np.array([m["type"] for m in mats], i32)
        mat_base_color = np.array([m["base_color"] for m in mats], f32)
        mat_metallic = np.array([m["metallic"] for m in mats], f32)
        mat_roughness = np.array([m["roughness"] for m in mats], f32)
        mat_fuzz = np.array([m["fuzz"] for m in mats], f32)
        mat_ior = np.array([m["ior"] for m in mats], f32)
        mat_albedo_tex = np.array([m["albedo_tex"] for m in mats], i32)
        mat_normal_tex = np.array([m["normal_tex"] for m in mats], i32)
        mat_metallic_tex = np.array([m["metallic_tex"] for m in mats], i32)
        mat_roughness_tex = np.array([m["roughness_tex"] for m in mats], i32)
        mat_mr_tex = np.array([m["mr_tex"] for m in mats], i32)
        mat_emit_tex = np.array([m["emit_tex"] for m in mats], i32)

        # textures + atlas
        texs = self._textures or [
            dict(type=TEX_SOLID, color0=(0, 0, 0), color1=(0, 0, 0), image=-1)
        ]
        K = len(texs)
        tex_type = np.array([t["type"] for t in texs], i32)
        tex_color0 = np.array([t["color0"] for t in texs], f32)
        tex_color1 = np.array([t["color1"] for t in texs], f32)
        tex_layer = np.full((K,), -1, i32)
        tex_w = np.ones((K,), i32)
        tex_h = np.ones((K,), i32)
        if self._images:
            max_h = max(im.shape[0] for im in self._images)
            max_w = max(im.shape[1] for im in self._images)
            atlas = np.zeros((len(self._images), max_h, max_w, 3), f32)
            for li, im in enumerate(self._images):
                atlas[li, : im.shape[0], : im.shape[1]] = im
            for ti, t in enumerate(texs):
                if t["image"] >= 0:
                    im = self._images[t["image"]]
                    tex_layer[ti] = t["image"]
                    tex_h[ti] = im.shape[0]
                    tex_w[ti] = im.shape[1]
        else:
            atlas = np.zeros((1, 1, 1, 3), f32)

        # -- bake the per-material shading pack --------------------------
        # One 8-channel layer per PBR material that references any map
        # beyond a procedural albedo: channels 0-2 albedo texel, 3-5 normal
        # texel, 6 metallic (map channel 0, material.h:191), 7 roughness
        # (map channel 1, material.h:197) — all 0-255 reference scale.
        # Image maps of differing resolution are co-baked at the material's
        # max resolution with integer-ratio-exact nearest resampling; solid
        # maps (including magenta missing-file sentinels) bake as constant
        # texels, so the flagship's sentinel-textured iron sphere is exact.
        mat_pack_layer = np.full((M,), -1, i32)
        mat_pack_w = np.ones((M,), i32)
        mat_pack_h = np.ones((M,), i32)
        mat_albedo_kind = np.zeros((M,), i32)
        mat_normal_kind = np.zeros((M,), i32)
        mat_metal_kind = np.zeros((M,), i32)
        mat_rough_kind = np.zeros((M,), i32)
        mat_emit_kind = np.ones((M,), i32)  # solid black by default
        mat_albedo_c0 = np.zeros((M, 3), f32)
        mat_albedo_c1 = np.zeros((M, 3), f32)
        mat_emit_rgb = np.zeros((M, 3), f32)
        mat_emit_c1 = np.zeros((M, 3), f32)
        mat_metal_cc = np.zeros((M, 2), f32)
        mat_rough_cc = np.zeros((M, 2), f32)
        mat_normal_c0 = np.zeros((M, 3), f32)
        mat_normal_c1 = np.zeros((M, 3), f32)
        pack_layers = []

        def _resample(img, H, W):
            h, w = img.shape[:2]
            jj = (np.arange(H) * h) // H
            ii = (np.arange(W) * w) // W
            return img[jj[:, None], ii[None, :]]

        for mi, m in enumerate(mats):
            et = m["emit_tex"]
            if et >= 0:
                t = texs[et]
                if t["type"] == TEX_SOLID:
                    mat_emit_kind[mi] = 1
                    mat_emit_rgb[mi] = t["color0"]
                elif t["type"] == TEX_CHECKER:
                    # emitted = checker value = color * 255 (texture.h:45-47
                    # via material.h:148-151, raw — no /255 in diffuseLight);
                    # stored pre-scaled so shade just selects
                    mat_emit_kind[mi] = 2
                    mat_emit_rgb[mi] = np.asarray(t["color0"], f32) * 255.0
                    mat_emit_c1[mi] = np.asarray(t["color1"], f32) * 255.0
                else:
                    # image emission: bake the texel into this material's
                    # own pack layer channels 0:3. Light materials never
                    # use the PBR slots, so the layer is otherwise free.
                    if m["type"] == MAT_PBR:
                        # user-input validation must survive python -O
                        # (ADVICE r2): an assert here would let the
                        # emission bake overwrite the PBR map pack layer
                        raise NotImplementedError(
                            "image emission on a PBR material would "
                            "collide with its map pack"
                        )
                    mat_emit_kind[mi] = 3
                    img = self._images[t["image"]]
                    H, W = img.shape[:2]
                    pack = np.zeros((H, W, 8), f32)
                    pack[..., 0:3] = img
                    mat_pack_layer[mi] = len(pack_layers)
                    mat_pack_h[mi] = H
                    mat_pack_w[mi] = W
                    pack_layers.append(pack)
            if m["type"] != MAT_PBR:
                continue
            a = texs[m["albedo_tex"]] if m["albedo_tex"] >= 0 else None
            if a is None:
                mat_albedo_kind[mi] = 0
            elif a["type"] == TEX_SOLID:
                mat_albedo_kind[mi] = 1
                mat_albedo_c0[mi] = a["color0"]
            elif a["type"] == TEX_CHECKER:
                mat_albedo_kind[mi] = 2
                mat_albedo_c0[mi] = a["color0"]
                mat_albedo_c1[mi] = a["color1"]
            else:
                mat_albedo_kind[mi] = 3

            # procedural (checker/solid) textures in non-albedo slots are
            # evaluated inline by the shader from the hit point (they are
            # functions of p, not uv — unbakeable); a solid texture in a
            # slot is a checker with equal colors. Image slots co-bake.
            slot_texs = {}
            for slot, ti in (
                ("albedo", m["albedo_tex"] if mat_albedo_kind[mi] == 3 else -1),
                ("normal", m["normal_tex"]),
                ("metal", m["metallic_tex"]),
                ("rough", m["roughness_tex"]),
            ):
                if ti < 0:
                    continue
                t = texs[ti]
                if slot != "albedo" and t["type"] != TEX_IMAGE:
                    # store the *texture value* the reference would return:
                    # solidColor -> raw color (texture.h:26-28), checker ->
                    # color * 255 (texture.h:45-47). Consumers then apply
                    # their own scaling exactly like material.h does.
                    scale = 255.0 if t["type"] == TEX_CHECKER else 1.0
                    v0 = np.asarray(t["color0"], f32) * scale
                    v1 = (
                        np.asarray(t["color1"], f32) * 255.0
                        if t["type"] == TEX_CHECKER
                        else v0
                    )
                    if slot == "normal":
                        # shade applies normalIntToFloat((v-128)/128)
                        mat_normal_kind[mi] = 2
                        mat_normal_c0[mi] = v0
                        mat_normal_c1[mi] = v1
                    elif slot == "metal":
                        # effective metallic = red channel / 255
                        # (material.h:191)
                        mat_metal_kind[mi] = 2
                        mat_metal_cc[mi] = (v0[0] / 255.0, v1[0] / 255.0)
                    else:
                        # effective roughness = green channel / 255
                        # (material.h:197)
                        mat_rough_kind[mi] = 2
                        mat_rough_cc[mi] = (v0[1] / 255.0, v1[1] / 255.0)
                    continue
                slot_texs[slot] = t
            if not slot_texs:
                continue
            dims = [
                self._images[t["image"]].shape[:2]
                for t in slot_texs.values()
                if t["image"] >= 0
            ]
            H = max((d[0] for d in dims), default=1)
            W = max((d[1] for d in dims), default=1)
            pack = np.zeros((H, W, 8), f32)

            def _baked(t, H=H, W=W):
                if t["image"] >= 0:
                    return _resample(self._images[t["image"]], H, W)
                return np.broadcast_to(
                    np.asarray(t["color0"], f32), (H, W, 3)
                )

            if "albedo" in slot_texs:
                pack[..., 0:3] = _baked(slot_texs["albedo"])
            if "normal" in slot_texs:
                pack[..., 3:6] = _baked(slot_texs["normal"])
                mat_normal_kind[mi] = 3
            if "metal" in slot_texs:
                pack[..., 6] = _baked(slot_texs["metal"])[..., 0]
                mat_metal_kind[mi] = 3
            if "rough" in slot_texs:
                pack[..., 7] = _baked(slot_texs["rough"])[..., 1]
                mat_rough_kind[mi] = 3
            mat_pack_layer[mi] = len(pack_layers)
            mat_pack_h[mi] = H
            mat_pack_w[mi] = W
            pack_layers.append(pack)

        if pack_layers:
            Hm = max(p.shape[0] for p in pack_layers)
            Wm = max(p.shape[1] for p in pack_layers)
            shade_atlas = np.zeros((len(pack_layers), Hm, Wm, 8), f32)
            for li, p in enumerate(pack_layers):
                shade_atlas[li, : p.shape[0], : p.shape[1]] = p
        else:
            shade_atlas = np.zeros((1, 1, 1, 8), f32)

        tri_n, tri_d, tri_q, tri_c = prepare_triangles(tri_v0, tri_v1, tri_v2)

        return dict(
            tri_v0=tri_v0,
            tri_v1=tri_v1,
            tri_v2=tri_v2,
            tri_uv0=tri_uv0,
            tri_uv1=tri_uv1,
            tri_uv2=tri_uv2,
            tri_mat=tri_mat,
            sph_c0=sph_c0,
            sph_c1=sph_c1,
            sph_t0=sph_t0,
            sph_t1=sph_t1,
            sph_radius=sph_radius,
            sph_mat=sph_mat,
            mat_type=mat_type,
            mat_base_color=mat_base_color,
            mat_metallic=mat_metallic,
            mat_roughness=mat_roughness,
            mat_fuzz=mat_fuzz,
            mat_ior=mat_ior,
            mat_albedo_tex=mat_albedo_tex,
            mat_normal_tex=mat_normal_tex,
            mat_metallic_tex=mat_metallic_tex,
            mat_roughness_tex=mat_roughness_tex,
            mat_mr_tex=mat_mr_tex,
            mat_emit_tex=mat_emit_tex,
            shade_atlas=shade_atlas,
            mat_pack_layer=mat_pack_layer,
            mat_pack_w=mat_pack_w,
            mat_pack_h=mat_pack_h,
            mat_albedo_kind=mat_albedo_kind,
            mat_normal_kind=mat_normal_kind,
            mat_metal_kind=mat_metal_kind,
            mat_rough_kind=mat_rough_kind,
            mat_emit_kind=mat_emit_kind,
            mat_albedo_c0=mat_albedo_c0,
            mat_albedo_c1=mat_albedo_c1,
            mat_emit_rgb=mat_emit_rgb,
            mat_emit_c1=mat_emit_c1,
            mat_metal_cc=mat_metal_cc,
            mat_rough_cc=mat_rough_cc,
            mat_normal_c0=mat_normal_c0,
            mat_normal_c1=mat_normal_c1,
            tex_type=tex_type,
            tex_color0=tex_color0,
            tex_color1=tex_color1,
            tex_layer=tex_layer,
            tex_w=tex_w,
            tex_h=tex_h,
            atlas=atlas,
            bvh_min=np.zeros((0, 3), f32),
            bvh_max=np.zeros((0, 3), f32),
            bvh_left=np.zeros((0,), i32),
            bvh_right=np.zeros((0,), i32),
            bvh_skip=np.zeros((0,), i32),
            tri_n=tri_n.astype(f32),
            tri_d=tri_d.astype(f32),
            tri_q=tri_q.astype(f32),
            tri_c=tri_c.astype(f32),
            cluster_min=cluster_min,
            cluster_max=cluster_max,
        )

