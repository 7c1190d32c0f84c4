"""BVH traversal hit finding, stackless threaded (skip-link) form
(counterpart of ``sexy_raytracer_tpu/ops/bvh_traverse.py``), in plain
torch. It is the correctness referee for the big-scene find kernels; the
JAX package has no kernel here either.

The tree is threaded with preorder skip links (models/bvh.py
``compute_skip``): an interior box hit descends to ``node + 1`` (the
preorder left child), a miss or a leaf jumps to ``skip[node]``. One loop
steps every unfinished ray by one node, vectorised over rays, until every
ray's node is past the last one.

Traversal semantics follow bvhNode::hit (reference bvh.h:97-105): node
boxes are tested against [t_min, current-best-t] so subtrees are pruned as
the closest hit shrinks; leaf hits respect the current best. The three
formulas are the JAX traversal's, not the find kernels': the triangle test
in the ``q @ org + t * (q @ dir) - c`` form, the sphere root bounded by the
best t, and the slab test with ``inv_dir = 1 / dir``, where ``0 * inf``
gives NaN and NaN fails ``hi > lo``.
"""

from __future__ import annotations

import torch

from sexy_raytracer_tpu_torch.ops.intersect import _per_ray_t_min
from sexy_raytracer_tpu_torch.utils.mathx import EPSILON

_BIG = 3.0e38


def _dot3(a, b):
    return a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1] + a[:, 2] * b[:, 2]


def _tri_hit(scene, i, org, dir, t_min):
    """Triangle ``i`` per ray -> t, or BIG where it is not hit."""
    n = scene.tri_n[i]
    ndir = _dot3(n, dir)
    plane_ok = ndir <= -EPSILON
    t = -(_dot3(n, org) + scene.tri_d[i]) / torch.where(plane_ok, ndir, 1.0)
    q = scene.tri_q[i]                       # [R, 3, 3]
    c = scene.tri_c[i]                       # [R, 3]
    qo = (q[..., 0] * org[:, None, 0] + q[..., 1] * org[:, None, 1]
          + q[..., 2] * org[:, None, 2])
    qd = (q[..., 0] * dir[:, None, 0] + q[..., 1] * dir[:, None, 1]
          + q[..., 2] * dir[:, None, 2])
    w = qo + t[:, None] * qd - c
    ok = plane_ok & (w >= 0.0).all(dim=1) & (t >= t_min)
    return torch.where(ok, t, _BIG)


def _sph_hit(scene, s, org, dir, time, t_max, t_min):
    """Sphere ``s`` per ray -> the nearest root in [t_min, t_max], or BIG."""
    c0 = scene.sph_c0[s]
    c1 = scene.sph_c1[s]
    st0, st1 = scene.sph_t0[s], scene.sph_t1[s]
    moving = torch.any(c0 != c1, dim=-1)
    denom = torch.where(st1 == st0, 1.0, st1 - st0)
    frac = (time - st0) / denom
    center = torch.where(moving[:, None], c0 + frac[:, None] * (c1 - c0), c0)
    oc = org - center
    a = _dot3(dir, dir)
    half_b = _dot3(oc, dir)
    r = scene.sph_radius[s]
    cterm = _dot3(oc, oc) - r * r
    disc = half_b * half_b - a * cterm
    has = disc >= 0.0
    sqrtd = torch.sqrt(torch.where(has, disc, 0.0))
    safe_a = torch.where(a == 0.0, 1.0, a)
    r0 = (-half_b - sqrtd) / safe_a
    r1 = (-half_b + sqrtd) / safe_a
    ok0 = has & (r0 >= t_min) & (r0 <= t_max)
    ok1 = has & (r1 >= t_min) & (r1 <= t_max)
    root = torch.where(ok0, r0, r1)
    return torch.where(ok0 | ok1, root, _BIG)


def _aabb_hit(scene, node, org, inv_dir, t_max, t_min):
    """Slab test (aabb.h:13-24) with IEEE inf semantics on zero
    components: a NaN from ``0 * inf`` propagates and fails ``hi > lo``."""
    t0 = (scene.bvh_min[node] - org) * inv_dir
    t1 = (scene.bvh_max[node] - org) * inv_dir
    tmin = torch.minimum(t0, t1).amax(dim=1)
    tmax = torch.maximum(t0, t1).amin(dim=1)
    lo = torch.maximum(tmin, t_min)
    hi = torch.minimum(tmax, t_max)
    return hi > lo


@torch.no_grad()
def find_hit_bvh(scene, org, dir, time, t_min=None):
    """BVH-traversal hit finding; same contract as ``find_hit_bruteforce``:
    ``(prim [R] int32 (-1 = miss), t [R] (+inf = miss))``."""
    if scene.bvh_min.shape[0] == 0:
        raise ValueError("scene has no BVH; build with build_bvh=True")
    R = org.shape[0]
    dev = org.device
    t_min = _per_ray_t_min(t_min, org)
    T = scene.tri_v0.shape[0]
    S = scene.sph_c0.shape[0]
    N = scene.bvh_left.shape[0]
    left_all = scene.bvh_left.long()
    right_all = scene.bvh_right.long()
    skip_all = scene.bvh_skip.long()
    inv_dir = 1.0 / dir  # inf on zero components, like the reference

    node = torch.zeros((R,), dtype=torch.int64, device=dev)
    best_t = torch.full((R,), _BIG, device=dev)
    best_i = torch.full((R,), -1, dtype=torch.int64, device=dev)
    live = torch.arange(R, device=dev)
    while live.numel():
        n = node[live]
        o, d, tm, bt = org[live], dir[live], t_min[live], best_t[live]
        box_ok = _aabb_hit(scene, n, o, inv_dir[live], bt, tm)
        left = left_all[n]
        prim = right_all[n]
        is_leaf = left == -1
        # leaf: primitive test (the prim id encodes the kind); interior
        # lanes index a clamped row, as JAX's gathers clamp
        if T > 0 and S > 0:
            t_prim = torch.where(
                prim < T,
                _tri_hit(scene, torch.clamp(prim, 0, T - 1), o, d, tm),
                _sph_hit(scene, torch.clamp(prim - T, 0, S - 1), o, d,
                         time[live], bt, tm))
        elif T > 0:
            t_prim = _tri_hit(scene, torch.clamp(prim, 0, T - 1), o, d, tm)
        else:
            t_prim = _sph_hit(scene, torch.clamp(prim - T, 0, S - 1), o, d,
                              time[live], bt, tm)
        take = is_leaf & box_ok & (t_prim < bt)
        best_t[live] = torch.where(take, t_prim, bt)
        best_i[live] = torch.where(take, prim, best_i[live])
        # threaded step: descend on an interior box hit, else escape
        nxt = torch.where(box_ok & ~is_leaf, n + 1, skip_all[n])
        node[live] = nxt
        live = live[nxt < N]
    t = torch.where(best_t < _BIG, best_t, float("inf"))
    prim = torch.where(torch.isfinite(t), best_i, -1).to(torch.int32)
    return prim, t
