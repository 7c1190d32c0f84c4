"""Wavefront path-tracing integrators (counterpart of
``render/integrator.py``).

The reference's depth-4 recursion (reference main.cpp:33-52) as a fixed
number of bounce steps over a wavefront with an ``alive`` mask — exactly
equivalent because depth-out returns black (main.cpp:36-37):

    radiance = sum_k emitted_k * prod_{j<k} att_j   (+ background on miss)

``trace_rays_fused``, the port's default on both devices: each bounce runs
the find kernel, the row gathers, the hit-record kernel, the atlas texel
gather and the shade kernel (ops/find.py, ops/fused.py); on CPU tensors
the kernel wrappers run their plain versions. ``trace_rays_reference``
is the unfused integrator of plain torch ops (``hit_data``, ``shade``)
around the find kernel, taken with ``fused=False``. Ray ``time`` is fixed
along a path (material.h:93).

The radiance is differentiable in the scene's float fields, as in
``integrator.py:325-418``: through the carry across bounces, the triangle,
sphere, material and atlas gathers (ops/lookup.py) and the two kernels'
VJPs. Hit search, the integer rows of the packs and the sphere-uv normal
are stop-gradient.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from sexy_raytracer_tpu_torch.models.scene import MAT_LIGHT
from sexy_raytracer_tpu_torch.ops.find import find_occluded
from sexy_raytracer_tpu_torch.ops.fused import (
    hitrec_fused,
    shade_carry_fused,
)
from sexy_raytracer_tpu_torch.ops.intersect import (
    T_MIN_DEFAULT,
    emissive_sphere_hit,
    emissive_spheres,
    find_hit,
    hit_data,
)
from sexy_raytracer_tpu_torch.ops.lookup import atlas_lookup, table_lookup
from sexy_raytracer_tpu_torch.ops.shade import material_packs, shade
from sexy_raytracer_tpu_torch.utils import rng
from sexy_raytracer_tpu_torch.utils.mathx import PI

_BIG = 3.0e38


def scene_no_emissive_tris(scene) -> bool:
    """True iff no triangle's material is emissive.

    Gates the last-bounce visibility shortcut: an emissive triangle would
    be misclassified as an occluder there.
    """
    tm = scene.tri_mat.cpu().numpy()
    if tm.size == 0:
        return True
    mt = scene.mat_type.cpu().numpy()
    return not bool(np.any(mt[tm] == MAT_LIGHT))


def trace_rays(scene, org, dir, time, keys, background, max_bounce: int,
               method: str = "auto", fused=None,
               last_bounce_vis: bool = False):
    """Path-trace a wavefront; returns radiance ``[R, 3]``
    (integrator.py:31-60).

    ``fused=False`` takes the reference integrator, which ignores
    ``last_bounce_vis``; ``True`` and ``None`` take the fused one. The
    JAX package's ``None`` takes the fused integrator only on a TPU and
    its jnp one elsewhere; the port's kernels serve both devices, so its
    ``None`` keeps the fused integrator everywhere.
    """
    if fused is None or fused:
        return trace_rays_fused(scene, org, dir, time, keys, background,
                                max_bounce, method, last_bounce_vis)
    return trace_rays_reference(scene, org, dir, time, keys, background,
                                max_bounce, method)


def trace_rays_reference(scene, org, dir, time, keys, background,
                         max_bounce: int, method: str = "auto"):
    """The reference (unfused) integrator, counterpart of
    ``trace_rays_jnp`` (integrator.py:85): radiance ``[R, 3]``.

    Each bounce runs ``find_hit`` (per-ray ``t_min``, 3e38 on dead lanes,
    so they miss everything), ``hit_data`` on the winners, the bounce's
    draws ``bits(fold_in(key, 100 + b), (6,))`` (those of
    ``bounce_uniforms``), ``shade``, and the carry update. Gradients flow
    through the record, the shading and the carry; hit search is
    stop-gradient. The JAX version rematerialises each bounce for the
    backward (``jax.checkpoint``), a TPU memory measure; autograd here
    keeps every bounce's intermediates instead.
    """
    R = org.shape[0]
    dev = org.device
    background = torch.as_tensor(background, dtype=torch.float32, device=dev)
    thr = torch.ones((R, 3), device=dev)
    rad = torch.zeros((R, 3), device=dev)
    alive = torch.ones((R,), dtype=torch.bool, device=dev)
    for b in range(max_bounce):
        t_min = torch.where(alive, T_MIN_DEFAULT, _BIG)
        prim, _ = find_hit(scene, org.contiguous(), dir.contiguous(), time,
                           t_min=t_min, method=method)
        rec = hit_data(scene, org, dir, time, prim)
        u = rng.per_ray_uniform_block(rng.fold_in(keys, 100 + b), 6)
        rand = {
            "unit_vector": rng.unit_vector_from_uniforms(u[:, 0], u[:, 1]),
            "unit_ball": rng.in_unit_sphere_from_uniforms(u[:, 2], u[:, 3],
                                                          u[:, 4]),
            "uniform": u[:, 5],
        }
        samp = shade(scene, rec, dir, rand)

        miss = alive & ~rec.hit
        rad = rad + torch.where(miss[:, None], thr * background, 0.0)
        rad = rad + torch.where((alive & rec.hit)[:, None],
                                thr * samp.emitted, 0.0)
        alive_next = alive & rec.hit & samp.scattered
        thr = torch.where(alive_next[:, None], thr * samp.attenuation, thr)
        org = torch.where(alive_next[:, None], rec.p, org)
        dir = torch.where(alive_next[:, None], samp.direction, dir)
        alive = alive_next
    return rad


def bounce_uniforms(keys, max_bounce: int):
    """Per-bounce draws ``[R, B, 6]``: ``bits(fold_in(k, 100 + b), (6,))``
    as U[0,1) floats, for every ray key and bounce."""
    b = torch.arange(max_bounce, dtype=torch.int64, device=keys.device)
    bkeys = rng.fold_in(keys[:, None, :], 100 + b)
    return rng.uniforms_from_bits(rng.bits(bkeys, 6))


def trace_rays_fused(scene, org, dir, time, keys, background,
                     max_bounce: int, method: str = "auto",
                     last_bounce_vis: bool = False):
    """Fused-kernel integrator: radiance ``[R, 3]`` for rays ``org``/``dir``
    ``[R, 3]`` at ``time`` ``[R]``, with per-ray keys ``[R, 2]``.

    ``last_bounce_vis``: at the last bounce only the closest hit's emission
    matters, so the closest-hit search factors into a closest-emissive-
    sphere solve plus the any-hit occlusion kernel. Valid only when no
    triangle is emissive (``scene_no_emissive_tris``); it needs a bounce to
    replace, so it is ignored at ``max_bounce == 0``.
    """
    R = org.shape[0]
    dev = org.device
    T = scene.tri_v0.shape[0]
    S = scene.sph_c0.shape[0]
    L, H, W, C = scene.shade_atlas.shape
    last_bounce_vis = last_bounce_vis and max_bounce >= 1
    background = torch.as_tensor(background, dtype=torch.float32, device=dev)
    f32 = torch.float32

    # -- scene-only packs, once per wavefront --
    if last_bounce_vis:
        # before any of the wavefront's work is queued: the index costs
        # the host one wait on an almost empty stream
        emissive = emissive_spheres(scene)
    if T > 0:
        tri_pack = torch.cat(
            [scene.tri_v0, scene.tri_v1, scene.tri_v2,
             scene.tri_uv0, scene.tri_uv1, scene.tri_uv2,
             scene.tri_mat.view(f32)[:, None]], dim=1,
        )  # [T, 16]; the material id rides as raw bits
    if S > 0:
        sph_pack = torch.cat(
            [scene.sph_c0, scene.sph_c1, scene.sph_t0[:, None],
             scene.sph_t1[:, None], scene.sph_radius[:, None],
             scene.sph_mat.view(f32)[:, None]], dim=1,
        )  # [S, 10]
    mat_f, mat_i = material_packs(scene)
    mat_all = torch.cat([mat_f, mat_i.view(f32)], dim=1)  # [M, 30 + 9]
    n_matf = mat_f.shape[1]
    atlas2d = scene.shade_atlas.reshape(L * H, W, C)

    # -- per-bounce uniforms for all bounces: [R, B, 6] --
    u = bounce_uniforms(keys, max_bounce)

    def rand_rows(b):
        """Bounce b's draws as rows [7, R]: unit vector (3), point in the
        unit ball (3), uniform — rng's transforms, componentized."""
        z = 1.0 - 2.0 * u[:, b, 0]
        r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
        phi = (2.0 * PI) * u[:, b, 1]
        z2 = 1.0 - 2.0 * u[:, b, 2]
        r2 = torch.sqrt(torch.clamp(1.0 - z2 * z2, min=0.0))
        phi2 = (2.0 * PI) * u[:, b, 3]
        s = u[:, b, 4] ** (1.0 / 3.0)
        return torch.stack([
            r * torch.cos(phi), r * torch.sin(phi), z,
            s * r2 * torch.cos(phi2), s * r2 * torch.sin(phi2), s * z2,
            u[:, b, 5],
        ])

    bg_rows = background[:, None].expand(3, R)

    # carry = the shade kernel's output stack:
    # org(3) dir(3) thr(3) rad(3) alive pad(3)
    carry = torch.cat([
        org.T, dir.T,
        torch.ones((3, R), device=dev), torch.zeros((3, R), device=dev),
        torch.ones((1, R), device=dev), torch.zeros((3, R), device=dev),
    ]).contiguous()

    def rays_of(carry):
        alive = carry[12] > 0.5
        t_min = torch.where(alive, T_MIN_DEFAULT, _BIG)
        return carry[0:3].T, carry[3:6].T, alive, t_min

    def shade_from_prim(carry, rand, prim, bg_rows_b, tris_possible=True):
        """Everything after hit search: row gathers + the two kernels."""
        _, _, _, t_min = rays_of(carry)
        hit = prim >= 0
        is_tri = hit & (prim < T)
        is_sph = hit & (prim >= T)
        if T > 0 and tris_possible:
            g = table_lookup(
                tri_pack, torch.clamp(torch.where(is_tri, prim, 0), 0, T - 1))
            tri_mat = g[:, 15].detach().view(torch.int32)
            gT = g[:, :15].T
        else:
            tri_mat = torch.zeros((R,), dtype=torch.int32, device=dev)
            gT = torch.zeros((15, R), device=dev)
        if S > 0:
            s = table_lookup(
                sph_pack,
                torch.clamp(torch.where(is_sph, prim - T, 0), 0, S - 1))
            sph_mat = s[:, 9].detach().view(torch.int32)
            sT = s[:, :9].T
        else:
            sph_mat = torch.zeros((R,), dtype=torch.int32, device=dev)
            sT = torch.zeros((9, R), device=dev)

        hf = torch.cat([
            carry[0:6], time[None], gT, sT, t_min[None],
            is_tri.to(f32)[None], is_sph.to(f32)[None],
        ]).contiguous()
        ho = hitrec_fused(hf)

        mat_id = torch.where(is_tri, tri_mat, torch.where(is_sph, sph_mat, 0))
        gall = table_lookup(mat_all, mat_id)
        gf = gall[:, :n_matf]
        gi = gall[:, n_matf:].detach().view(torch.int32)

        # atlas texel fetch at the hit uv (ops/shade._sample_pack). The
        # kernel emits the triangle uv; sphere lanes get the spherical uv
        # of their stop-gradient outward normal here (sphere.h:32-38)
        u_, v_ = ho[12], ho[13]
        if S > 0:
            sign = torch.where(ho[15] > 0.5, 1.0, -1.0)
            nrm = ho[3:6].detach()
            ox, oy, oz = nrm[0] * sign, nrm[1] * sign, nrm[2] * sign
            theta = torch.acos(torch.clamp(-oy, -1.0, 1.0))
            phi = torch.atan2(-oz, ox) + math.pi
            u_ = torch.where(is_sph, phi / (2.0 * math.pi), u_)
            v_ = torch.where(is_sph, theta / math.pi, v_)
        layer = torch.clamp(gi[:, 5], min=0)
        tw = gi[:, 6]
        th = gi[:, 7]
        uu = torch.clamp(u_, 0.0, 1.0)
        vv = 1.0 - torch.clamp(v_, 0.0, 1.0)
        xi = torch.minimum((uu * tw).to(torch.int32), tw - 1)
        yj = torch.minimum((vv * th).to(torch.int32), th - 1)
        flat = (layer * H + yj) * W + xi
        pack = atlas_lookup(atlas2d, flat)

        sf = torch.cat([
            carry[0:13], ho[0:12], ho[15][None], hit.to(f32)[None],
            gf.T, pack.T, rand, bg_rows_b,
        ]).contiguous()
        si = gi[:, [0, 1, 2, 3, 4, 8]].T.contiguous()
        return shade_carry_fused(sf, si)

    n_full = max_bounce - 1 if last_bounce_vis else max_bounce
    for b in range(n_full):
        org_f, dir_f, _, t_min = rays_of(carry)
        prim, _ = find_hit(scene, org_f.contiguous(), dir_f.contiguous(),
                           time, t_min=t_min, method=method)
        carry = shade_from_prim(carry, rand_rows(b), prim, bg_rows)

    if last_bounce_vis:
        with torch.no_grad():
            org_f, dir_f, alive, t_min = rays_of(carry)
            org_f, dir_f = org_f.contiguous(), dir_f.contiguous()
            t_em, em_prim = emissive_sphere_hit(scene, org_f, dir_f, time,
                                                t_min, emissive)
            emis = scene.mat_type[scene.sph_mat.long()] == MAT_LIGHT
            bound = torch.where(
                alive, torch.where(torch.isfinite(t_em), t_em, _BIG), -_BIG)
            occ = find_occluded(scene, org_f, dir_f, time, bound,
                                t_min=t_min, sphere_occluder=~emis)
            prim = torch.where(~occ & torch.isfinite(t_em), em_prim, -1)
        # occluded lanes hit a non-emissive prim: no background, no
        # emission -> a miss with zero background
        bg_tail = torch.where(occ[None], 0.0, bg_rows)
        carry = shade_from_prim(carry, rand_rows(max_bounce - 1), prim,
                                bg_tail, tris_possible=False)
    return carry[9:12].T
