"""Hit finding and differentiable hit records (counterpart of
``ops/intersect.py``).

``find_hit`` is a non-differentiable index search returning the winning
global primitive id (triangles first, then spheres; -1 = miss) and its t.
Its production paths are the cluster-culled CUDA kernels of
``ops/find.py`` (resident, and streamed for big scenes);
``find_hit_bruteforce`` is the plain referee with the evaluation order of
the JAX package's tiled scan.

Semantics (reference model.h:104-181, sphere.h:54-83): triangles are
back-face culled with ``n.dir <= -eps``, tested with three edge
half-spaces at the hit point, and accepted for ``t >= t_min``; spheres
take the nearest root ``>= t_min`` of the half-b quadratic, with the
center lerped at the ray's time. The true closest hit is kept.

``hit_data`` recomputes the differentiable hit record of known winners
(``intersect.py:305-512``) in plain torch, in the JAX order of operations:
the reference integrator's record, through which its gradients flow.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sexy_raytracer_tpu_torch.models.scene import MAT_LIGHT
from sexy_raytracer_tpu_torch.ops.lookup import table_lookup
from sexy_raytracer_tpu_torch.utils.mathx import (
    EPSILON,
    PI,
    clip,
    cross,
    dot,
    maximum,
    safe_sqrt,
    unit_vector,
)

T_MIN_DEFAULT = 0.001  # reference main.cpp:39

# Past this many triangles ``method="auto"`` takes the streamed
# find, as the JAX package does (intersect.py:47-50).
PALLAS_RESIDENT_MAX_TRIS = 120_000


def _per_ray_t_min(t_min, org):
    R = org.shape[0]
    if t_min is None:
        t_min = T_MIN_DEFAULT
    if not torch.is_tensor(t_min) or t_min.ndim == 0:
        return torch.full((R,), float(t_min), dtype=torch.float32,
                          device=org.device)
    return t_min.to(torch.float32)


def sphere_center(scene, s_idx, time):
    """Moving-sphere center at ray time (reference sphere.h:47-52)."""
    c0 = scene.sph_c0[s_idx]
    c1 = scene.sph_c1[s_idx]
    t0 = scene.sph_t0[s_idx]
    t1 = scene.sph_t1[s_idx]
    moving = torch.any(c0 != c1, dim=-1)
    denom = torch.where(t1 == t0, 1.0, t1 - t0)
    frac = (time - t0) / denom
    return torch.where(moving[..., None], c0 + frac[..., None] * (c1 - c0), c0)


def _tri_candidates(scene, org, dir, t_min, tile):
    """Closest valid triangle per ray, tile by tile -> (t [R], idx [R])."""
    T = scene.tri_v0.shape[0]
    R = org.shape[0]
    best_t = torch.full((R,), float("inf"), device=org.device)
    best_i = torch.full((R,), -1, dtype=torch.int32, device=org.device)
    ox, oy, oz = org[:, 0:1], org[:, 1:2], org[:, 2:3]
    dx, dy, dz = dir[:, 0:1], dir[:, 1:2], dir[:, 2:3]
    for s in range(0, T, tile):
        n = scene.tri_n[s:s + tile]
        d = scene.tri_d[s:s + tile]
        q = scene.tri_q[s:s + tile]
        c = scene.tri_c[s:s + tile]
        # component-explicit, in the order of the find kernels, so that
        # the paths agree to the rounding on near-edge rays
        ndir = dx * n[:, 0] + dy * n[:, 1] + dz * n[:, 2]
        a_n = ox * n[:, 0] + oy * n[:, 1] + oz * n[:, 2] + d
        plane_ok = ndir <= -EPSILON
        t = -a_n / torch.where(plane_ok, ndir, -1.0)
        px = ox + t * dx
        py = oy + t * dy
        pz = oz + t * dz
        ok = plane_ok & (t >= t_min[:, None])
        for k in range(3):
            ok &= (q[:, k, 0] * px + q[:, k, 1] * py + q[:, k, 2] * pz
                   - c[:, k]) >= 0.0
        t = torch.where(ok, t, float("inf"))
        tile_best, tile_arg = torch.min(t, dim=1)
        better = tile_best < best_t
        best_t = torch.where(better, tile_best, best_t)
        best_i = torch.where(better, (tile_arg + s).to(torch.int32), best_i)
    return best_t, best_i


def sphere_roots(scene, org, dir, time, t_min, t_max=float("inf")):
    """Per-(ray, sphere) nearest valid root (reference sphere.h:54-72).

    Returns ``(root [R,S], valid [R,S])``.
    """
    S = scene.sph_c0.shape[0]
    s_idx = torch.arange(S, device=org.device)
    center = sphere_center(scene, s_idx[None, :], time[:, None])  # [R,S,3]
    oc = org[:, None, :] - center
    dr = dir[:, None, :]
    a = (dir[:, 0] * dir[:, 0] + dir[:, 1] * dir[:, 1]
         + dir[:, 2] * dir[:, 2])[:, None]
    half_b = oc[..., 0] * dr[..., 0] + oc[..., 1] * dr[..., 1] \
        + oc[..., 2] * dr[..., 2]
    r = scene.sph_radius[None, :]
    cterm = (oc[..., 0] * oc[..., 0] + oc[..., 1] * oc[..., 1]
             + oc[..., 2] * oc[..., 2]) - r * r
    disc = half_b * half_b - a * cterm
    has = disc >= 0.0
    sqrtd = torch.sqrt(torch.where(has, disc, 0.0))
    safe_a = torch.where(a == 0.0, 1.0, a)
    root0 = (-half_b - sqrtd) / safe_a
    root1 = (-half_b + sqrtd) / safe_a
    tmin = t_min[:, None]
    ok0 = has & (root0 >= tmin) & (root0 <= t_max)
    ok1 = has & (root1 >= tmin) & (root1 <= t_max)
    return torch.where(ok0, root0, root1), ok0 | ok1


def _sph_candidates(scene, org, dir, time, t_min):
    """Closest sphere per ray -> (t [R] (+inf = none), sphere idx [R])."""
    S = scene.sph_c0.shape[0]
    R = org.shape[0]
    if S == 0:
        return (torch.full((R,), float("inf"), device=org.device),
                torch.full((R,), -1, dtype=torch.int32, device=org.device))
    root, valid = sphere_roots(scene, org, dir, time, t_min)
    best, arg = torch.min(torch.where(valid, root, float("inf")), dim=1)
    return best, torch.where(torch.isfinite(best), arg.to(torch.int32), -1)


def emissive_spheres(scene):
    """Indices ``[E]`` (int64) of the emissive spheres; one host sync on
    the card, so a caller that asks many times computes it once."""
    return torch.nonzero(
        scene.mat_type[scene.sph_mat.long()] == MAT_LIGHT).flatten()


def emissive_sphere_hit(scene, org, dir, time, t_min, emissive=None):
    """Closest EMISSIVE-sphere hit -> ``(t [R] (+inf = none), prim [R])``.

    ``prim`` is the global primitive id (T + sphere index, -1 = none). Used
    by the last-bounce visibility shortcut (render/integrator.py). Only the
    spheres ``emissive`` (``emissive_spheres(scene)``, computed here when
    not given) are tested: the same roots, and the same first-minimum
    winner, as a pass over every sphere masked to the emissive ones.
    """
    idx = emissive_spheres(scene) if emissive is None else emissive
    sub = scene._replace(sph_c0=scene.sph_c0[idx], sph_c1=scene.sph_c1[idx],
                         sph_t0=scene.sph_t0[idx], sph_t1=scene.sph_t1[idx],
                         sph_radius=scene.sph_radius[idx])
    best, arg = _sph_candidates(sub, org, dir, time, t_min)
    if idx.numel():
        arg = torch.where(arg >= 0, idx[arg.clamp(min=0).long()], -1)
    T = scene.tri_v0.shape[0]
    return best, torch.where(arg >= 0, arg + T, -1).to(torch.int32)


def find_hit_bruteforce(scene, org, dir, time, t_min=None, tri_tile=512):
    """All-primitives closest hit. Returns ``(prim_id [R] int32, t [R])``."""
    t_min = _per_ray_t_min(t_min, org)
    tri_t, tri_i = _tri_candidates(scene, org, dir, t_min, tri_tile)
    sph_t, sph_i = _sph_candidates(scene, org, dir, time, t_min)
    T = scene.tri_v0.shape[0]
    use_sph = sph_t < tri_t
    t = torch.where(use_sph, sph_t, tri_t)
    prim = torch.where(use_sph, T + sph_i, tri_i)
    prim = torch.where(torch.isfinite(t), prim, -1).to(torch.int32)
    return prim, t


@torch.no_grad()
def find_hit(scene, org, dir, time, t_min=None, method="auto"):
    """Dispatch hit finding -> ``(prim [R] int32, t [R] float32)``;
    stop-gradient, whatever the method. Each kernel-backed method runs its
    CUDA kernel on CUDA tensors and its plain version on CPU tensors.

    ``method``:
      * ``auto`` — ``pallas`` up to ``PALLAS_RESIDENT_MAX_TRIS`` triangles,
        ``streamed`` past it (on both devices: the JAX package sends CPU
        big scenes to ``bvh`` instead, which finds the same closest hit);
      * ``pallas`` — the cluster-culled find (ops/find.py);
      * ``pallas_nocull`` — the same with culling disabled (test aid);
      * ``streamed`` — the streamed find for big scenes (ops/find.py);
      * ``pallas_mxu`` — the brute-force weight-stack kernel (ops/brute.py);
      * ``bruteforce`` — the tiled plain scan;
      * ``bvh`` — the skip-link BVH traversal, the correctness referee
        (ops/bvh_traverse.py; needs a scene built with its BVH).
    """
    if method == "auto" and scene.tri_v0.shape[0] > PALLAS_RESIDENT_MAX_TRIS:
        method = "streamed"
    if method == "streamed":
        from sexy_raytracer_tpu_torch.ops.find import find_hit_streamed

        return find_hit_streamed(scene, org, dir, time, t_min)
    if method in ("auto", "pallas", "pallas_nocull"):
        from sexy_raytracer_tpu_torch.ops.find import find_hit_clustered

        return find_hit_clustered(scene, org, dir, time, t_min,
                                  cull=(method != "pallas_nocull"))
    if method == "pallas_mxu":
        from sexy_raytracer_tpu_torch.ops.brute import find_hit_brute

        return find_hit_brute(scene, org, dir, time, t_min)
    if method == "bvh":
        from sexy_raytracer_tpu_torch.ops.bvh_traverse import find_hit_bvh

        return find_hit_bvh(scene, org, dir, time, t_min)
    if method == "bruteforce":
        return find_hit_bruteforce(scene, org, dir, time, t_min)
    raise ValueError(f"unknown find_hit method {method!r}")


# ---------------------------------------------------------------------------
# the differentiable hit record (intersect.py:305-512)
# ---------------------------------------------------------------------------

class HitRecord(NamedTuple):
    """SoA hit record (reference hittable.h:9-22, arrays over rays)."""

    p: torch.Tensor           # [R,3] hit point
    normal: torch.Tensor      # [R,3] shading normal (flipped to face the ray)
    tangent: torch.Tensor     # [R,3]
    bitangent: torch.Tensor   # [R,3]
    uv: torch.Tensor          # [R,2]
    t: torch.Tensor           # [R]
    front_face: torch.Tensor  # [R] bool
    mat_id: torch.Tensor      # [R] int32 (0 where miss; see hit mask)
    hit: torch.Tensor         # [R] bool


def _triangle_record(scene, org, dir, tri_id):
    """Recompute the triangle hit data for known winners (model.h:156-181).

    One packed-row gather ``[T, 16]``, the material id riding as raw bits
    (intersect.py:305-326); the gradient reaches the scene's vertex and uv
    fields through it, and stops at the uv of the hit (intersect.py:354).
    """
    f32 = torch.float32
    i = torch.clamp(tri_id, 0, max(scene.tri_v0.shape[0] - 1, 0))
    pack = torch.cat(
        [scene.tri_v0, scene.tri_v1, scene.tri_v2,
         scene.tri_uv0, scene.tri_uv1, scene.tri_uv2,
         scene.tri_mat.view(f32)[:, None]], dim=1,
    )  # [T, 16]
    g = table_lookup(pack, i)
    v0, v1, v2 = g[:, 0:3], g[:, 3:6], g[:, 6:9]
    uv0, uv1, uv2 = g[:, 9:11], g[:, 11:13], g[:, 13:15]
    mat = g[:, 15].detach().view(torch.int32)
    n = cross(v1 - v0, v2 - v0)

    ndir = dot(n, dir)
    d = -dot(n, v0)
    safe = torch.where(ndir == 0.0, -1.0, ndir)
    t = -(dot(n, org) + d) / safe
    p = org + t[..., None] * dir

    # inverse-distance "barycentric" weights (model.h:157-166); uv feeds
    # only nearest-neighbour lookups, so its gradient is stopped
    def invdist(v):
        dv = p - v
        return 1.0 / maximum(safe_sqrt(dot(dv, dv)), 1e-20)

    r0, r1, r2 = invdist(v0), invdist(v1), invdist(v2)
    denom = r0 + r1 + r2
    r0, r1, r2 = r0 / denom, r1 / denom, r2 / denom
    u = r0 * uv0[..., 0] + r1 * uv1[..., 0] + r2 * uv2[..., 0]
    v = 1.0 - (r0 * uv0[..., 1] + r1 * uv1[..., 1] + r2 * uv2[..., 1])
    uv = torch.stack([u, v], dim=-1).detach()

    outward = unit_vector(n)
    # back-face culling guarantees front hits (model.h:122-123)
    front = dot(dir, outward) < 0.0
    normal = torch.where(front[..., None], outward, -outward)

    # tangent basis from UV-space edge deltas (model.h:214-235)
    e0 = v1 - v0
    e1 = v2 - v0
    duv0 = uv1 - uv0
    duv1 = uv2 - uv0
    f = duv0[..., 0] * duv1[..., 1] - duv1[..., 0] * duv0[..., 1]
    f = torch.where(f == 0.0, EPSILON, f)
    inv_f = 1.0 / f
    tangent = unit_vector(
        inv_f[..., None] * (duv1[..., 1:2] * e0 - duv0[..., 1:2] * e1))
    bitangent = unit_vector(
        inv_f[..., None] * (-duv1[..., 0:1] * e0 + duv0[..., 0:1] * e1))
    return p, normal, tangent, bitangent, uv, t, front, mat


def _sphere_record(scene, org, dir, time, sph_id, t_min):
    """Recompute the sphere hit data for known winners (sphere.h:54-106),
    from one packed-row gather ``[S, 10]`` (intersect.py:380-439)."""
    f32 = torch.float32
    i = torch.clamp(sph_id, 0, max(scene.sph_c0.shape[0] - 1, 0))
    pack = torch.cat(
        [scene.sph_c0, scene.sph_c1, scene.sph_t0[:, None],
         scene.sph_t1[:, None], scene.sph_radius[:, None],
         scene.sph_mat.view(f32)[:, None]], dim=1,
    )  # [S, 10]
    g = table_lookup(pack, i)
    c0, c1 = g[:, 0:3], g[:, 3:6]
    t0, t1, r = g[:, 6], g[:, 7], g[:, 8]
    mat = g[:, 9].detach().view(torch.int32)
    moving = torch.any(c0 != c1, dim=-1)
    denom = torch.where(t1 == t0, 1.0, t1 - t0)
    frac = (time - t0) / denom
    center = torch.where(moving[..., None], c0 + frac[..., None] * (c1 - c0),
                         c0)
    oc = org - center
    a = dot(dir, dir)
    half_b = dot(oc, dir)
    c = dot(oc, oc) - r * r
    disc = half_b * half_b - a * c
    sqrtd = safe_sqrt(disc)  # finite gradient for non-winner garbage lanes
    safe_a = torch.where(a == 0.0, 1.0, a)
    root0 = (-half_b - sqrtd) / safe_a
    root1 = (-half_b + sqrtd) / safe_a
    t = torch.where(root0 >= t_min, root0, root1)
    p = org + t[..., None] * dir
    outward = unit_vector(p - center)  # no /radius (sphere.h:76)
    front = dot(dir, outward) < 0.0
    normal = torch.where(front[..., None], outward, -outward)

    # spherical uv of the stop-gradient outward normal (sphere.h:32-38)
    out_sg = outward.detach()
    theta = torch.acos(clip(-out_sg[..., 1], -1.0, 1.0))
    phi = torch.atan2(-out_sg[..., 2], out_sg[..., 0]) + PI
    uv = torch.stack([phi / (2.0 * PI), theta / PI], dim=-1)

    # tangent basis (sphere.h:96-106)
    near_pole = (1.0 - torch.abs(outward[..., 1])) < EPSILON
    b = torch.where(near_pole[..., None],
                    outward.new_tensor([0.0, 0.0, -1.0]),
                    outward.new_tensor([0.0, 1.0, 0.0]))
    tangent = unit_vector(cross(b, outward))
    bitangent = unit_vector(cross(outward, tangent))
    return p, normal, tangent, bitangent, uv, t, front, mat


def hit_data(scene, org, dir, time, prim_id, t_min=None) -> HitRecord:
    """Differentiable hit record for rays whose winner is ``prim_id``
    (intersect.py:442-512). Where ``prim_id < 0`` the record contents are
    arbitrary but finite and ``hit`` is False."""
    R = org.shape[0]
    dev = org.device
    t_min = _per_ray_t_min(t_min, org)
    T = scene.tri_v0.shape[0]
    S = scene.sph_c0.shape[0]
    hit = prim_id >= 0
    is_tri = hit & (prim_id < T)
    is_sph = hit & (prim_id >= T)

    tri = (_triangle_record(scene, org, dir, torch.where(is_tri, prim_id, 0))
           if T > 0 else None)
    sph = (_sphere_record(scene, org, dir, time,
                          torch.where(is_sph, prim_id - T, 0), t_min)
           if S > 0 else None)
    if tri is None and sph is None:
        zeros3 = torch.zeros((R, 3), device=dev)
        return HitRecord(
            p=zeros3, normal=zeros3, tangent=zeros3, bitangent=zeros3,
            uv=torch.zeros((R, 2), device=dev),
            t=torch.full((R,), float("inf"), device=dev),
            front_face=torch.zeros((R,), dtype=torch.bool, device=dev),
            mat_id=torch.zeros((R,), dtype=torch.int32, device=dev),
            hit=torch.zeros((R,), dtype=torch.bool, device=dev),
        )
    if tri is None:
        fields = sph
    elif sph is None:
        fields = tri
    else:
        fields = tuple(
            torch.where(is_tri.reshape(is_tri.shape + (1,) * (a.ndim - 1)),
                        a, b)
            for a, b in zip(tri, sph))

    p, normal, tangent, bitangent, uv, t, front, mat = fields
    return HitRecord(
        p=p, normal=normal, tangent=tangent, bitangent=bitangent, uv=uv,
        t=torch.where(hit, t, float("inf")),
        front_face=front & hit,
        mat_id=torch.where(hit, mat, 0).to(torch.int32),
        hit=hit,
    )
