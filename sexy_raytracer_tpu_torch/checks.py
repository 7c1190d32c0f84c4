"""Comparison rules that the tests and ``chip_smoke.py`` hold the port's
kernels to, and the inputs and test counts of the hit-search walk. The
renderer and the kernels' modules never import this module.

A VJP is compared with autograd of the plain math at a tolerance
(``VJP_TOL``), so the check says something only where the values stand
well above it. A train step's cotangents are tiny (the loss is a mean over
every pixel, channel and sample), so its VJPs can lie below ``atol`` and a
kernel returning zeros would pass: callers scale the cotangent to unit
size first (``unit_cotangent``, the VJP is linear in it) and show that the
check rejects a wrong kernel on those lanes (``vjp_check_power``).

Kernels 1, 8 and 2 walk cluster tiles (``ops/find._lane_walk``);
``walk_counts`` counts the (ray, triangle) tests of a call four ways
(listed, executed, live, needed), and ``hard_wavefronts`` and
``resident_wavefronts`` make the wavefronts that stress the walk.
"""

from __future__ import annotations

import numpy as np
import torch

from sexy_raytracer_tpu_torch.models.clusters import CLUSTER_SIZE
from sexy_raytracer_tpu_torch.ops import find

# the VJPs' tolerance against autograd of the plain math: the adjoint sums
# its terms in another order
VJP_TOL = dict(atol=2e-5, rtol=1e-4)
# share of rays that may leave VJP_TOL, all of them ill-conditioned
VJP_BUDGET = 0.01


def unit_cotangent(g):
    """``g`` scaled to a largest magnitude of 1 (unchanged if all zero)."""
    scale = g.abs().amax()
    return g / scale if bool(scale > 0) else g


def ill_conditioned_lanes(hf, ho):
    """Rays whose hit-record VJP is ill-conditioned in float32 -> bool [R].

    ``hf`` is the hit record's input stack, ``ho`` its output. Triangle
    lanes whose uv triangle is nearly degenerate (the sine of the angle
    between its uv edges below 0.1: the tangent frame divides by the uv
    determinant), and sphere lanes within 1e-3 of a pole (the tangent is
    the cross of two nearly parallel vectors, ROADMAP.md queue 3; every hit
    on the flagship's ground sphere is one). There one f32 rounding of an
    input can move the VJP past a fixed tolerance, in the JAX package as
    much as here. Checks allow a budget of such lanes outside the tolerance
    (``vjp_outside``) instead of loosening it everywhere.
    """
    uv = hf[16:22]
    du0 = uv[2:4] - uv[0:2]
    du1 = uv[4:6] - uv[0:2]
    f = du0[0] * du1[1] - du1[0] * du0[1]
    norms = torch.linalg.vector_norm(du0, dim=0) * \
        torch.linalg.vector_norm(du1, dim=0)
    tri = hf[32] > 0.5
    flat_uv = (f != 0.0) & (f.abs() < 0.1 * norms)
    pole = (1.0 - ho[4].abs()) < 1e-3
    return torch.where(tri, flat_uv, pole)


def vjp_outside(got, want, ill=None):
    """Rays where a VJP ``got`` [K, R] leaves ``VJP_TOL`` of ``want``.
    Raises if one of them is not in ``ill`` (bool [R]) or if there are
    more than ``VJP_BUDGET`` of the rays; returns their count."""
    outside = ~torch.isclose(got, want, **VJP_TOL).all(dim=0)
    n = int(outside.sum())
    if ill is None:
        ill = torch.zeros_like(outside)
    if bool((outside & ~ill).any()) or n > VJP_BUDGET * outside.numel():
        raise AssertionError(
            f"VJP: {n} of {outside.numel()} rays outside atol "
            f"{VJP_TOL['atol']} rtol {VJP_TOL['rtol']}, "
            f"{int((outside & ~ill).sum())} of them well-conditioned "
            f"(budget: {VJP_BUDGET:.0%} of the rays, ill-conditioned only)")
    return n


def rejects(got, want, ill=None):
    """Whether ``vjp_outside(got, want, ill)`` fails."""
    try:
        vjp_outside(got, want, ill)
    except AssertionError:
        return True
    return False


def flip_row(x, k):
    """A copy of ``x`` [K, R] with row ``k``'s sign flipped."""
    x = x.clone()
    x[k] = -x[k]
    return x


def vjp_check_power(got, want, ill=None):
    """Shows that ``vjp_outside(got, want, ill)`` would fail a wrong kernel
    on these inputs: one that returns zeros, and one that returns ``got``
    with any single row's sign flipped, for every row that carries
    gradient (above ``atol`` on a well-conditioned ray). Raises if such a
    wrong result would pass or if no row carries gradient; returns the
    number of rows that do."""
    if ill is None:
        ill = torch.zeros(want.shape[1], dtype=torch.bool, device=want.device)
    if not rejects(torch.zeros_like(got), want, ill):
        raise AssertionError("VJP check: a kernel returning zeros would pass")
    rows = [k for k in range(want.shape[0])
            if bool(((want[k].abs() > VJP_TOL["atol"]) & ~ill).any())]
    if not rows:
        raise AssertionError("VJP check: no row carries gradient above atol")
    for k in rows:
        if not rejects(flip_row(got, k), want, ill):
            raise AssertionError(f"VJP check: row {k} with its sign flipped "
                                 "would pass")
    return len(rows)


# ---------------------------------------------------------------------------
# the hit-search walk of kernels 8 and 2: test counts and hard wavefronts
# ---------------------------------------------------------------------------

_BIG = 3.0e38
# rays of one warp of kernels 8 and 2: 32 lanes of two rays (kernel 1's
# warps hold 32 * find.FIND_RAYS_PER_LANE)
WALK_WARP_RAYS = 64


def _slab(o, d, t_min, lo, hi):
    """Exact per-ray slab test (``ops/find._cull_rows``'s formulas),
    broadcasting rays ``o, d`` [..., 3], ``t_min`` [...] against boxes
    ``lo, hi`` [..., 3] -> (hit, t_near)."""
    t_near = t_min
    t_far = torch.full_like(t_min, _BIG)
    for a in range(3):
        o_a, d_a = o[..., a], d[..., a]
        zero = d_a == 0.0
        inv = 1.0 / torch.where(zero, 1.0, d_a)
        near = (lo[..., a] - o_a) * inv
        far = (hi[..., a] - o_a) * inv
        lo_t = torch.minimum(near, far)
        hi_t = torch.maximum(near, far)
        inside = (o_a >= lo[..., a]) & (o_a <= hi[..., a])
        lo_t = torch.where(zero, torch.where(inside, -_BIG, _BIG), lo_t)
        hi_t = torch.where(zero, torch.where(inside, _BIG, -_BIG), hi_t)
        t_near = torch.maximum(t_near, lo_t)
        t_far = torch.minimum(t_far, hi_t)
    return t_far > t_near, t_near


def needed_tests(rays, state, cmin, cmax, n_tris, ck):
    """Per ray, the triangles of the clusters (boxes ``cmin``, ``cmax``
    [NC, 3] of ``ck`` triangles each, ``n_tris`` in all) that its exact
    slab test enters before ``state`` (its final best t, or its any-hit
    bound; <= 0: none), summed over the rays [R, 8+]."""
    nc = cmin.shape[0]
    size = (n_tris - torch.arange(nc, device=rays.device) * ck) \
        .clamp(0, ck).double()
    total = 0.0
    for r0 in range(0, rays.shape[0], 16384):
        rb = rays[r0:r0 + 16384]
        s = state[r0:r0 + 16384, None]
        hit, t_near = _slab(rb[:, None, 0:3], rb[:, None, 3:6],
                            rb[:, 7:8].expand(-1, nc), cmin[None], cmax[None])
        enter = hit & (t_near < s) & (s > 0.0)
        total += float((enter.double() * size).sum())
    return int(total)


def walk_counts(closest, args, cmin, cmax, warp_rays=WALK_WARP_RAYS):
    """The (ray, triangle) tests of a call of a walk kernel, 1 or 8
    (``closest``: ``find_closest``'s or ``find_streamed``'s arguments) or
    2 (``find_any``'s), by the walk of ``ops/find._lane_walk`` ->
    {listed, executed, live, needed}:

    * listed: every ray of a block on every tile the block visits before
      its block-wide early out, times the tile's triangles: what the
      worklists alone ask for, without the per-ray test (the tests the
      first resident kernel 1 executed);
    * executed: the rays of every warp (``warp_rays`` rays) that runs the
      test loop on a tile, times the tile's triangles;
    * live: the rays whose exact slab test (``_slab``, the cluster's own
      box) enters the tile's cluster before their current best t (or
      bound), times the tile's triangles;
    * needed: per ray, the triangles of every cluster that its exact slab
      test enters before its final best t (closest hit) or its bound (any
      hit; none for a ray resolved before the walk).
    """
    if closest:
        lists, rays, pack, boxes, sph, n_tris = args
        state = find._sphere_tc(rays, sph).amin(dim=1)
    else:
        lists, rays, _, pack, boxes, n_tris = args
        state = rays[:, 8].clone()
    bound = state.clone()
    ck = pack.shape[1]
    nb = lists.shape[0]
    RB = rays.shape[0] // nb
    nc = (lists.shape[1] - 1) // 2
    listed = executed = live = 0
    for b0, b1 in find._block_chunks(nb, pack, RB):
        st = state[b0 * RB:b1 * RB].view(b1 - b0, RB)
        rays_b = rays[b0 * RB:b1 * RB].reshape(b1 - b0, RB, -1)
        lst = lists[b0:b1]
        active = torch.ones(b1 - b0, dtype=torch.bool, device=rays.device)
        for k in range(nc):
            active &= (k < lst[:, 0]) \
                & (lst[:, 1 + nc + k] < find._worst_bits(st))
            blk = active.nonzero().squeeze(1)
            if blk.numel() == 0:
                break
            listed += blk.numel() * RB * ck
            c = lst[blk, 1 + k].long()
            s = st[blk]
            rb = rays_b[blk]
            hit, t_near = _slab(rb[..., 0:3], rb[..., 3:6], rb[..., 7],
                                cmin[c][:, None], cmax[c][:, None])
            live += int((hit & (t_near < s) & (s > 0.0)).sum()) * ck
            tested = (s.view(torch.int32) > lst[blk, 1 + nc + k][:, None]) \
                & find._lane_enters(rb, boxes[c], s)
            warps = tested.reshape(blk.numel(), -1, warp_rays).any(dim=2)
            executed += int(warps.sum()) * warp_rays * ck
            t, valid = find._tile_t(pack[c], rb)
            if closest:
                tile_t = torch.where(valid, t, _BIG).amin(dim=2)
                st[blk] = torch.where(tested & (tile_t < s), tile_t, s)
            else:
                occ = (valid & (t < s[..., None])).any(dim=2)
                st[blk] = torch.where(tested & occ, -_BIG, s)
    return dict(listed=listed, executed=executed, live=live,
                needed=needed_tests(rays, state if closest else bound, cmin,
                                    cmax, n_tris, ck))


def occlusion_by_closest_hit(scene, org, dir, time, t_min, t_bound,
                             sphere_occluder):
    """The any-hit flags that the closest hit implies -> bool [R]: a ray
    is occluded when its bound is negative, when an occluder sphere's
    nearest valid root lies before the bound, or when its closest triangle
    hit (``find_streamed`` over the uncut interval cull, no sphere) lies
    before the bound. A witness for ``find_any`` that shares neither its
    regrouping nor its walk."""
    R = org.shape[0]
    rays, _ = find._ray_table(
        [org[:, 0], org[:, 1], org[:, 2], dir[:, 0], dir[:, 1], dir[:, 2],
         time, t_min], {7: _BIG}, find.STREAM_RAY_BLOCK)
    cmin, cmax = find._cluster_boxes(scene)
    lists = find.cluster_lists_block(org, dir, t_min, cmin, cmax,
                                     ray_block=find.STREAM_RAY_BLOCK)
    pack, _ = find._pack_triangles(scene)
    no_sph = torch.zeros((8, 8), device=org.device)
    t_tri, prim = find.find_streamed(lists, rays, pack,
                                     find._lane_boxes(cmin, cmax), no_sph,
                                     scene.tri_v0.shape[0])
    tc = find._sphere_tc(rays[:R], find._pack_spheres(scene, sphere_occluder))
    sph = torch.where(tc < t_bound[:, None], tc, _BIG).amin(dim=1) < _BIG
    return (t_bound < 0.0) | sph | ((prim[:R] >= 0) & (t_tri[:R] < t_bound))


def hard_wavefronts(scene, n=8192, seed=11):
    """Wavefronts that stress the walks of kernels 8 and 2, as
    {name: (org, dir, time, t_min, t_bound)} on the scene's device:

    * ``sphere``: origins 1-5 units above the ground over a 20 x 20 patch
      around the mesh, 85% aimed down, so most any-hit rays die on the
      ground sphere; half the bounds 3e38, half in [0.5, 20);
    * ``dead blocks``: the same with rays 0-2047 and 4096-5119 dead
      (t_min 3e38, bound -3e38): whole ray blocks with nothing to do;
    * ``ties``: from 2 units in front of the mesh towards the first
      vertex, and the midpoint of the first edge, of each cluster's
      triangles: rays through vertices and edges that clusters share, whose
      hits tie exactly or nearly.
    """
    dev = scene.tri_v0.device
    r = np.random.default_rng(seed)
    org = np.stack([r.uniform(-10, 10, n), r.uniform(1, 5, n),
                    r.uniform(-10, 10, n)], axis=1)
    d = r.normal(size=(n, 3))
    down = r.random(n) < 0.85
    d[down, 1] = -np.abs(d[down, 1]) - 1.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    time = r.uniform(0, 1, n)
    t_min = np.full(n, 1e-3)
    bound = np.where(r.random(n) < 0.5, _BIG, r.uniform(0.5, 20.0, n))
    waves = {"sphere": (org, d, time, t_min, bound)}
    dead = np.zeros(n, bool)
    dead[:2048] = dead[4096:5120] = True
    waves["dead blocks"] = (org, d, time, np.where(dead, _BIG, t_min),
                            np.where(dead, -_BIG, bound))
    v0 = scene.tri_v0.cpu().numpy().astype(np.float64)
    v1 = scene.tri_v1.cpu().numpy().astype(np.float64)
    firsts = np.arange(0, v0.shape[0], CLUSTER_SIZE)
    targets = np.concatenate([v0[firsts], 0.5 * (v0[firsts] + v1[firsts])])
    targets = np.resize(targets, (n, 3))
    src = targets + np.array([0.0, 0.0, 2.0]) \
        + r.normal(0, 0.3, (n, 3)) * np.array([1.0, 1.0, 0.0])
    dt = targets - src
    dt /= np.linalg.norm(dt, axis=1, keepdims=True)
    waves["ties"] = (src, dt, np.zeros(n), t_min, np.full(n, _BIG))
    return {k: tuple(torch.tensor(x, dtype=torch.float32, device=dev)
                     for x in v) for k, v in waves.items()}


def resident_wavefronts(scene, n=2048, seed=17):
    """Wavefronts that stress kernel 1's walk on a resident scene, as
    {name: (org, dir, time, t_min)} float32 numpy arrays (the tests hand
    the same rays to the JAX package), around the scene's triangles:

    * ``ties``: ``hard_wavefronts``'s rays through vertices and edges that
      clusters share;
    * ``per-ray t_min``: rays from around the mesh, t_min in [1e-3, 3);
    * ``dead lanes``: the same with 30% of the lanes dead (t_min 3e38)
      and rays 256-383 all dead: a whole block of nothing to do;
    * ``zero components``: rays at the mesh along an axis or in an axis
      plane, one or two direction components exactly 0;
    * ``inside boxes``: rays from the centres of the clusters' boxes, in
      every direction.
    """
    r = np.random.default_rng(seed)
    v = scene.tri_v0.cpu().numpy().astype(np.float64)
    lo, hi = v.min(axis=0), v.max(axis=0)
    mid, ext = 0.5 * (lo + hi), 0.5 * (hi - lo) + 0.5

    def unit(d):
        return d / np.linalg.norm(d, axis=1, keepdims=True)

    org = mid + r.uniform(-3.0, 3.0, (n, 3)) * ext
    d = unit(mid + r.uniform(-1.0, 1.0, (n, 3)) * ext - org)
    time = r.uniform(0, 1, n)
    t_min = r.uniform(1e-3, 3.0, n)
    dead = r.random(n) < 0.3
    dead[256:384] = True
    # along an axis, or in an axis plane, from outside the mesh's box
    axis = r.integers(0, 3, n)
    dz = np.zeros((n, 3))
    dz[np.arange(n), axis] = np.where(r.random(n) < 0.5, 1.0, -1.0)
    plane = r.random(n) < 0.5
    other = (axis + 1) % 3
    dz[plane, other[plane]] = r.uniform(-1.0, 1.0, plane.sum())
    dz = unit(dz)
    oz = mid + r.uniform(-0.8, 0.8, (n, 3)) * ext - 2.5 * dz * ext.max()
    cmin = scene.cluster_min.cpu().numpy().astype(np.float64)
    cmax = scene.cluster_max.cpu().numpy().astype(np.float64)
    centre = 0.5 * (cmin + cmax)[r.integers(0, max(len(cmin), 1), n)] \
        if len(cmin) else org
    waves = {
        "per-ray t_min": (org, d, time, t_min),
        "dead lanes": (org, d, time, np.where(dead, _BIG, 1e-3)),
        "zero components": (oz, dz, time, np.full(n, 1e-3)),
        "inside boxes": (centre, unit(r.normal(size=(n, 3))), time,
                         np.full(n, 1e-3)),
    }
    if len(v):
        o_t, d_t, tm_t, tmin_t, _ = hard_wavefronts(scene, n, seed)["ties"]
        waves["ties"] = tuple(x.cpu().numpy() for x in (o_t, d_t, tm_t,
                                                        tmin_t))
    return {k: tuple(np.asarray(x, np.float32) for x in w)
            for k, w in waves.items()}
