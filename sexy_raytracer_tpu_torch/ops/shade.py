"""Material shading: BRDF evaluation and next-ray sampling (counterpart of
``ops/shade.py``).

All four material models are evaluated on the whole wavefront and the
result is selected by material id, with ``torch.where`` in the JAX order
(shade.py:72-343). Per-ray material parameters ride three gathers: the
packed float rows ``[M, 30]`` and int rows ``[M, 9]`` (``table_lookup``,
one-hot backward) and one texel of the baked 8-channel shading atlas
(``atlas_lookup``, whose backward is the dense histogram, kernel 7 on the
card). ``jnp.maximum``/``minimum``/``clip`` become ``mathx.maximum``/
``minimum``/``clip``, which split a tie's gradient as JAX does.

``material_packs`` also feeds the fused shade kernel (ops/fused.py);
``shade`` is the reference integrator's (render/integrator.py).

Reference semantics (quirks included, since they define the images) are
those of the JAX module's docstring: the reference's F0 of 0.4, the albedo
factor applied twice, metal absorbed below the surface, Schlick
reflect/refract with total internal reflection, and lights that never
scatter.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sexy_raytracer_tpu_torch.models.scene import (
    MAT_DIELECTRIC,
    MAT_LIGHT,
    MAT_METAL,
    MAT_PBR,
)
from sexy_raytracer_tpu_torch.ops.lookup import atlas_lookup, table_lookup
from sexy_raytracer_tpu_torch.utils.mathx import (
    EPSILON,
    PI,
    clip,
    dot,
    maximum,
    minimum,
    near_zero,
    normal_int_to_float,
    reflect,
    refract,
    unit_vector,
)


class ScatterSample(NamedTuple):
    attenuation: torch.Tensor  # [R,3] throughput multiplier
    emitted: torch.Tensor      # [R,3] emitted radiance at the hit
    direction: torch.Tensor    # [R,3] next ray direction
    scattered: torch.Tensor    # [R] bool — False terminates the path


# -- BRDF terms (pbr.h:58-81) ------------------------------------------------
# JAX's ``x ** 2`` and ``x ** 5`` are integer powers (repeated products)

def trowbridge_reitz_ndf(n_dot_h, roughness):
    alpha = roughness * roughness
    alpha2 = alpha * alpha
    q = n_dot_h * n_dot_h * (alpha2 - 1.0) + 1.0
    # the 1e-12 guard of the r = 0, NdotH = 1 point (shade.py:84-89)
    return alpha2 / maximum(PI * (q * q), 1e-12)


def schlick_gaf(n_dot_v, roughness):
    rp1 = roughness + 1.0
    k = (rp1 * rp1) / 8.0
    return n_dot_v / (n_dot_v * (1.0 - k) + k)


def fresnel_epic(f0, h_dot_v):
    power = torch.exp2((-5.55473 * h_dot_v - 6.98316) * h_dot_v)
    return f0 + (1.0 - f0) * power[..., None]


# -- packed material rows ------------------------------------------------------

def material_packs(scene):
    """Packed material tables: float rows [M,30], int rows [M,9]."""
    mat_f = torch.cat(
        [
            scene.mat_base_color,                # 0:4
            scene.mat_metallic[:, None],         # 4
            scene.mat_roughness[:, None],        # 5
            scene.mat_fuzz[:, None],             # 6
            scene.mat_ior[:, None],              # 7
            scene.mat_albedo_c0,                 # 8:11
            scene.mat_albedo_c1,                 # 11:14
            scene.mat_emit_rgb,                  # 14:17
            scene.mat_emit_c1,                   # 17:20
            scene.mat_metal_cc,                  # 20:22
            scene.mat_rough_cc,                  # 22:24
            scene.mat_normal_c0,                 # 24:27
            scene.mat_normal_c1,                 # 27:30
        ],
        dim=1,
    )
    mat_i = torch.stack(
        [
            scene.mat_type,          # 0
            scene.mat_albedo_kind,   # 1
            scene.mat_normal_kind,   # 2
            scene.mat_metal_kind,    # 3
            scene.mat_rough_kind,    # 4
            scene.mat_pack_layer,    # 5
            scene.mat_pack_w,        # 6
            scene.mat_pack_h,        # 7
            scene.mat_emit_kind,     # 8
        ],
        dim=1,
    )
    return mat_f, mat_i


def _sample_pack(scene, mat, uv):
    """One fetch from the baked 8-channel shading atlas (0-255 scale):
    nearest neighbour, u clamped, v flipped (texture.h:129-147)."""
    L, H, W, C = scene.shade_atlas.shape
    layer = maximum(mat["pack_layer"], 0)
    w = mat["pack_w"]
    h = mat["pack_h"]
    uu = clip(uv[..., 0], 0.0, 1.0)
    vv = 1.0 - clip(uv[..., 1], 0.0, 1.0)
    xi = torch.minimum((uu * w).to(torch.int32), w - 1)
    yj = torch.minimum((vv * h).to(torch.int32), h - 1)
    flat = (layer * H + yj) * W + xi
    return atlas_lookup(scene.shade_atlas.reshape(L * H, W, C), flat)


# -- material models -----------------------------------------------------------

def _shade_pbr(scene, mat, pack, rec, ray_dir, unit_sphere_dir, checker_odd):
    base_rgb = mat["base_color"][..., :3]
    kind = mat["albedo_kind"]
    odd = checker_odd  # [R] bool: sign of sin(10x)sin(10y)sin(10z) < 0

    # procedural albedo values (texture.h:26-28, 42-48)
    checker = torch.where(odd[..., None], mat["albedo_c1"],
                          mat["albedo_c0"]) * 255.0
    map_val = torch.where((kind == 1)[..., None], mat["albedo_c0"],
                          pack[..., 0:3])
    map_val = torch.where((kind == 2)[..., None], checker, map_val)
    # textured: sample / 255 (material.h:165-167); untextured: factor rgb
    attenuation = torch.where((kind == 0)[..., None], base_rgb,
                              map_val / 255.0)

    # normal slot: image texel from the pack, or an inline checker/solid
    # value (both feed normalIntToFloat, material.h:171-186)
    nk = mat["normal_kind"]
    nm_val = torch.where(
        (nk == 2)[..., None],
        torch.where(odd[..., None], mat["normal_c1"], mat["normal_c0"]),
        pack[..., 3:6],
    )
    nm = normal_int_to_float(nm_val)
    # TBN columns: tangent, bitangent, normal (material.h:179-185)
    world_nm = (rec.tangent * nm[..., 0:1] + rec.bitangent * nm[..., 1:2]
                + rec.normal * nm[..., 2:3])
    normal = torch.where((nk != 0)[..., None], unit_vector(world_nm),
                         rec.normal)

    # metallic = map red channel / 255 (material.h:191)
    mk = mat["metal_kind"]
    m_checker = torch.where(odd, mat["metal_cc"][..., 1],
                            mat["metal_cc"][..., 0])
    m = torch.where(mk == 3, pack[..., 6] / 255.0, mat["metallic"])
    m = clip(torch.where(mk == 2, m_checker, m), 0.0, 1.0)
    m = torch.where(mk == 0, mat["metallic"], m)

    # roughness = map green channel / 255 (material.h:197)
    rk = mat["rough_kind"]
    r_checker = torch.where(odd, mat["rough_cc"][..., 1],
                            mat["rough_cc"][..., 0])
    r = torch.where(rk == 3, pack[..., 7] / 255.0, mat["roughness"])
    r = clip(torch.where(rk == 2, r_checker, r), 0.0, 1.0)
    r = torch.where(rk == 0, mat["roughness"], r)

    # scatter direction (material.h:203-208)
    scatter_dir = normal + unit_sphere_dir
    degenerate = near_zero(scatter_dir)
    scatter_dir = torch.where(degenerate[..., None], normal, scatter_dir)
    scatter_dir = unit_vector(scatter_dir)

    view = -unit_vector(ray_dir)
    half = unit_vector(scatter_dir + view)

    n_dot_l = maximum(dot(normal, scatter_dir), 0.0)
    n_dot_h = maximum(dot(normal, half), 0.0)
    h_dot_v = maximum(dot(half, view), 0.0)
    n_dot_v = maximum(dot(normal, view), 0.0)

    f0 = (1.0 - m[..., None]) * 0.4 + m[..., None] * base_rgb  # material.h:228
    d = trowbridge_reitz_ndf(n_dot_h, r)
    f = fresnel_epic(f0, h_dot_v)
    g = schlick_gaf(n_dot_l, r) * schlick_gaf(n_dot_v, r)

    diffuse = (attenuation / PI) * (1.0 - f) * (1.0 - m[..., None]) * base_rgb
    specular = ((d * g)[..., None] * f
                / (4.0 * n_dot_v * n_dot_l + EPSILON)[..., None])
    out_attenuation = (diffuse + specular) * n_dot_l[..., None]
    return out_attenuation, scatter_dir


def _shade_metal(mat, rec, ray_dir, ball_sample):
    albedo = mat["base_color"][..., :3]
    fuzz = mat["fuzz"]
    reflected = reflect(unit_vector(ray_dir), rec.normal)
    direction = reflected + fuzz[..., None] * ball_sample
    ok = dot(direction, rec.normal) > 0.0  # material.h:96
    return albedo, direction, ok


def _shade_dielectric(mat, rec, ray_dir, uniform_sample):
    ir = mat["ior"]
    ratio = torch.where(rec.front_face, 1.0 / ir, ir)
    unit_dir = unit_vector(ray_dir)
    cos_theta = minimum(dot(rec.normal, -unit_dir), 1.0)
    sin_theta = torch.sqrt(maximum(1.0 - cos_theta * cos_theta, 0.0))
    cannot_refract = ratio * sin_theta > 1.0
    r0 = (1.0 - ratio) / (1.0 + ratio)
    r0 = r0 * r0
    x = 1.0 - cos_theta
    reflectance = r0 + (1.0 - r0) * (x * ((x * x) * (x * x)))
    do_reflect = cannot_refract | (reflectance > uniform_sample)
    direction = torch.where(
        do_reflect[..., None],
        reflect(unit_dir, rec.normal),
        refract(unit_dir, rec.normal, ratio),
    )
    return torch.ones_like(direction), direction


def shade(scene, rec, ray_dir, rand) -> ScatterSample:
    """Evaluate all materials and select by id (shade.py:261-343).

    ``rand`` is a dict with pre-drawn per-ray randomness:
      ``unit_vector`` [R,3] (PBR scatter), ``unit_ball`` [R,3] (metal fuzz),
      ``uniform`` [R] (dielectric reflect/refract choice).
    """
    mat_f, mat_i = material_packs(scene)
    gf = table_lookup(mat_f, rec.mat_id)
    gi = table_lookup(mat_i, rec.mat_id)
    mat = {
        "base_color": gf[:, 0:4],
        "metallic": gf[:, 4],
        "roughness": gf[:, 5],
        "fuzz": gf[:, 6],
        "ior": gf[:, 7],
        "albedo_c0": gf[:, 8:11],
        "albedo_c1": gf[:, 11:14],
        "emit_rgb": gf[:, 14:17],
        "emit_c1": gf[:, 17:20],
        "metal_cc": gf[:, 20:22],
        "rough_cc": gf[:, 22:24],
        "normal_c0": gf[:, 24:27],
        "normal_c1": gf[:, 27:30],
        "type": gi[:, 0],
        "albedo_kind": gi[:, 1],
        "normal_kind": gi[:, 2],
        "metal_kind": gi[:, 3],
        "rough_kind": gi[:, 4],
        "pack_layer": gi[:, 5],
        "pack_w": gi[:, 6],
        "pack_h": gi[:, 7],
        "emit_kind": gi[:, 8],
    }
    mtype = mat["type"]
    pack = _sample_pack(scene, mat, rec.uv)

    # checker parity shared by every procedural slot (texture.h:42-48)
    sines = (torch.sin(10.0 * rec.p[..., 0]) * torch.sin(10.0 * rec.p[..., 1])
             * torch.sin(10.0 * rec.p[..., 2]))
    checker_odd = sines < 0.0

    pbr_att, pbr_dir = _shade_pbr(scene, mat, pack, rec, ray_dir,
                                  rand["unit_vector"], checker_odd)
    met_att, met_dir, met_ok = _shade_metal(mat, rec, ray_dir,
                                            rand["unit_ball"])
    die_att, die_dir = _shade_dielectric(mat, rec, ray_dir, rand["uniform"])
    # diffuseLight: the emit texture's raw value at the hit (material.h:
    # 148-151): solid colour, checker, or an image texel of its pack layer
    ek = mat["emit_kind"]
    emit_val = torch.where(
        (ek == 2)[..., None],
        torch.where(checker_odd[..., None], mat["emit_c1"], mat["emit_rgb"]),
        torch.where((ek == 3)[..., None], pack[..., 0:3], mat["emit_rgb"]),
    )
    emitted = torch.where((mtype == MAT_LIGHT)[..., None], emit_val, 0.0)

    def sel(mask, a, b):
        return torch.where(mask[..., None] if a.ndim > 1 else mask, a, b)

    att = sel(mtype == MAT_PBR, pbr_att, torch.zeros_like(pbr_att))
    att = sel(mtype == MAT_METAL, met_att, att)
    att = sel(mtype == MAT_DIELECTRIC, die_att, att)

    direction = sel(mtype == MAT_PBR, pbr_dir, ray_dir)
    direction = sel(mtype == MAT_METAL, met_dir, direction)
    direction = sel(mtype == MAT_DIELECTRIC, die_dir, direction)

    scattered = mtype == MAT_PBR
    scattered = torch.where(mtype == MAT_METAL, met_ok, scattered)
    scattered = scattered | (mtype == MAT_DIELECTRIC)
    # MAT_LIGHT: never scatters (material.h:144-146)

    return ScatterSample(
        attenuation=att,
        emitted=emitted,
        direction=direction,
        scattered=scattered & rec.hit,
    )
