"""Cluster-culled closest-hit and any-hit search (counterpart of
``sexy_raytracer_tpu/ops/pallas_find.py:235-1109``).

Three kernels and kernel 2's regrouping pass, each with a plain PyTorch
version beside it:

* ``find_closest`` replaces the TPU's ``_find_kernel`` (pallas_find.py:170,
  via ``find_hit_clustered`` :521): the closest hit per ray over its
  128-ray block's culled cluster worklist, plus every sphere.
* ``find_any`` replaces ``_occluded_kernel`` (pallas_find.py:681, via
  ``find_occluded`` :765): is there a non-emissive primitive with t in
  [t_min, t_bound)? ``any_regroup`` (from the same TPU kernel's sphere
  test, pallas_find.py:689) resolves the rays that an occluder sphere or
  a negative bound decides and moves them behind the live ones before the
  cull; kernel 2 walks the live rays in dense blocks, and each dies on its
  first occluder.
* ``find_streamed`` replaces ``_find_streamed_kernel`` (pallas_find.py:893,
  via ``find_hit_streamed`` :980): the closest hit for big scenes, over
  worklists of clusters from the per-block interval cull
  ``cluster_lists_block``.

Kernels 1, 8 and 2 share a walk (``_lane_walk``): front to back over a
block's clusters with the early out at every tile, each ray testing only
the tiles whose padded box its own slab test enters before its best t (or
bound). ``find_streamed_plain`` is the plain version of both closest-hit
kernels. The wrappers launch the CUDA kernel (csrc/find.cu) on CUDA
tensors and run the plain version on CPU tensors; there is no fallback
between them.

Data layout (the TPU kernel's, but for the triangle pack):

* triangle pack ``[NC, CK, 16]``: for each of cluster c's CK =
  CLUSTER_SIZE triangles its 16 floats n(3), d, q0(3), c0, q1(3), c1,
  q2(3), c2 (zero padded: n = 0 never passes the plane test), so that a
  cluster's tile is one contiguous 16 KB copy and a triangle four 16-byte
  words (the TPU's ``[NC, 16, CK]`` transposed);
* sphere pack ``[Spad, 8]``: center base(3), center delta(3), radius,
  valid — the center at time t is ``base + delta * t``;
* rays ``[Rpad, 8]`` (``[Rpad, 9]`` with t_bound for the any-hit query):
  ox oy oz dx dy dz time t_min; pad lanes have t_min = 3e38 (dead);
* worklists ``[NB, 1 + 2 NC]`` int32, one row per block of rays: the
  count of active clusters, their ids front to back, and their
  block-min entry distances as order-preserving int32 bits;
* cluster boxes ``[NC, 8]``: lo xyz, 0, hi xyz, 0, padded
  (``_lane_boxes``; kernel 1's from the triangles, ``_tri_boxes``).

The triangle pack and the padded boxes are derived from the scene once
(``_derived``) and rebuilt only when their source tensors change.

The kernels keep the JAX package's formulas and evaluation order, and
the CUDA build disables FMA contraction, so a kernel and its plain
version agree bit for bit on the same inputs.
"""

from __future__ import annotations

import weakref

import torch

from sexy_raytracer_tpu_torch.models.clusters import (
    CLUSTER_SIZE,
    cluster_bounds_device,
)
from sexy_raytracer_tpu_torch.ops import _cuda
from sexy_raytracer_tpu_torch.ops.intersect import (
    _per_ray_t_min,
    _sph_candidates,
)
from sexy_raytracer_tpu_torch.utils.mathx import EPSILON

# Rays per CUDA block and per worklist row of kernels 1 and 2. The TPU
# grows its ray block to fit the worklists into scalar memory; the card
# reads them from device memory, so the block stays at the size that culls
# finest.
RAY_BLOCK = 128
# Kernel 1's rays a consumer lane (CLOSEST_RPT in csrc/find.cu)
FIND_RAYS_PER_LANE = 1
_BIG = 3.0e38
# Above this many clusters the exact per-ray cull's [NC, R] intermediates
# dominate and the JAX package switches to a per-block interval cull.
PER_RAY_CULL_MAX_CLUSTERS = 512
# Elements of one [blocks, RAY_BLOCK, CK] intermediate of the plain find;
# bounds its memory at large wavefronts.
_PLAIN_CHUNK_ELEMS = 1 << 24
# (ray, sphere) pairs of one block of the plain sphere test: 1 MiB a
# float32 temporary, which the CPU's caches hold (the test's speed there)
_TC_BLOCK_PAIRS = 1 << 18
# Rays per block of the streamed find: four consumer warps of 64 rays
# (the any-hit kernel takes RAY_BLOCK: two).
STREAM_RAY_BLOCK = 256
# Memory budget of the interval cull: (block, box) pairs per pass. Each of
# its [pairs, 3] float32 intermediates takes 96 MiB at the budget; past it
# the cull runs over groups of blocks, which gives the same rows.
CULL_PAIRS_MAX = 1 << 23

FIND_CLOSEST = _cuda.Kernel(
    "srt_find_closest", "pippiippiiiipp",
    source="sexy_raytracer_tpu_torch/csrc/find.cu",
    replaces="sexy_raytracer_tpu/ops/pallas_find.py:170 (_find_kernel)",
)
FIND_ANY = _cuda.Kernel(
    "srt_find_any", "pipppiipiiip",
    source="sexy_raytracer_tpu_torch/csrc/find.cu",
    replaces="sexy_raytracer_tpu/ops/pallas_find.py:681 (_occluded_kernel)",
)
ANY_REGROUP = _cuda.Kernel(
    "srt_any_regroup", "pppppipiippppp",
    source="sexy_raytracer_tpu_torch/csrc/find.cu",
    replaces="sexy_raytracer_tpu/ops/pallas_find.py:689 (_occluded_kernel's "
             "occluder spheres)",
)
# rays per block of the regrouping pass's flag and scatter kernels
_REGROUP_BLOCK = 256
FIND_STREAMED = _cuda.Kernel(
    "srt_find_streamed", "pippiippiiiipp",
    source="sexy_raytracer_tpu_torch/csrc/find.cu",
    replaces="sexy_raytracer_tpu/ops/pallas_find.py:893 "
             "(_find_streamed_kernel)",
)


# ---------------------------------------------------------------------------
# packs and worklists (plain torch, shared by both kernels)
# ---------------------------------------------------------------------------

def _derived(fn):
    """``fn(*tensors)``, kept for the last tensors it was called with: a
    second call with the same tensor objects, none of them changed in
    place since, returns the kept result (which callers only read)."""
    last = {}

    def call(*tensors):
        key = [(weakref.ref(t), t._version) for t in tensors]
        if len(key) == len(last.get("key", ())) and all(
                r() is t and v == t._version
                for (r, v), t in zip(last["key"], tensors)):
            return last["out"]
        out = fn(*tensors)
        last.update(key=key, out=out)
        return out

    return call


def _pack_triangles(scene):
    """[NC, CK, 16] plane/edge pack: per triangle n(3), d, then q and c
    interleaved by edge (q0(3) c0 q1(3) c1 q2(3) c2); and NC."""
    return _triangle_pack(scene.tri_n, scene.tri_d, scene.tri_q, scene.tri_c)


@_derived
def _triangle_pack(tri_n, tri_d, q, c):
    T = tri_n.shape[0]
    ck = CLUSTER_SIZE
    nc = -(-T // ck)
    rows = [
        tri_n[:, 0], tri_n[:, 1], tri_n[:, 2], tri_d,
        q[:, 0, 0], q[:, 0, 1], q[:, 0, 2], c[:, 0],
        q[:, 1, 0], q[:, 1, 1], q[:, 1, 2], c[:, 1],
        q[:, 2, 0], q[:, 2, 1], q[:, 2, 2], c[:, 2],
    ]
    pack = torch.zeros((nc * ck, 16), dtype=torch.float32,
                       device=tri_n.device)
    pack[:T] = torch.stack(rows, dim=1)
    return pack.reshape(nc, ck, 16), nc


def _pack_spheres(scene, occluder=None):
    """[Spad, 8] columns: center base(3), center delta(3), radius, valid.

    ``occluder`` [S] bool clears the valid column of spheres that do not
    block light (the any-hit query skips emissive spheres).
    """
    S = scene.sph_c0.shape[0]
    spad = max(8, -(-S // 8) * 8)
    cols = torch.zeros((spad, 8), dtype=torch.float32,
                       device=scene.sph_c0.device)
    if S == 0:
        return cols
    c0, c1, t0, t1 = scene.sph_c0, scene.sph_c1, scene.sph_t0, scene.sph_t1
    moving = torch.any(c0 != c1, dim=-1)
    denom = torch.where(t1 == t0, 1.0, t1 - t0)
    delta = torch.where(moving[:, None], (c1 - c0) / denom[:, None], 0.0)
    cols[:S, 0:3] = c0 - delta * t0[:, None]
    cols[:S, 3:6] = delta
    cols[:S, 6] = scene.sph_radius
    cols[:S, 7] = 1.0 if occluder is None else occluder.to(torch.float32)
    return cols


def cluster_lists(org, dir, t_min, cmin, cmax, t_max=None,
                  ray_block=RAY_BLOCK):
    """Compacted per-block active-cluster lists [NB, 1 + 2 NC] int32.

    A cluster is active for block b if any of its rays enters the
    cluster's AABB at t in [t_min, t_max) (zero-direction-safe slab test,
    aabb.h:11-27; conservative, never a false miss). Rays with
    t_min >= 3e38 (dead lanes) activate nothing. Active ids are ordered by
    the block-min entry distance so the kernel shrinks best_t early.
    """
    if cmin.shape[0] > PER_RAY_CULL_MAX_CLUSTERS:
        return cluster_lists_block(org, dir, t_min, cmin, cmax, t_max,
                                   ray_block)
    R = org.shape[0]
    nb = -(-R // ray_block)
    pad_r = nb * ray_block - R
    o_rows = torch.nn.functional.pad(org.T, (0, pad_r))
    d_rows = torch.nn.functional.pad(dir.T, (0, pad_r))
    t_min_row = torch.nn.functional.pad(t_min, (0, pad_r), value=_BIG)[None]
    t_max_row = None
    if t_max is not None:
        t_max_row = torch.nn.functional.pad(t_max, (0, pad_r),
                                            value=-_BIG)[None]
    return _cull_rows(o_rows, d_rows, t_min_row, t_max_row, cmin, cmax, nb,
                      ray_block)


def _cull_rows(o_rows, d_rows, t_min_row, t_max_row, cmin, cmax, nb,
               ray_block):
    """Exact per-ray cull on row-major ray data -> lists [NB, 1 + 2 NC].

    o_rows/d_rows: [3, Rp]; t_min_row/t_max_row: [1, Rp].
    """
    NC = cmin.shape[0]
    Rp = o_rows.shape[1]
    t_near = t_min_row.expand(NC, Rp)
    t_far = torch.full((NC, Rp), _BIG, device=o_rows.device)
    for a in range(3):
        o_a = o_rows[a:a + 1]
        d_a = d_rows[a:a + 1]
        zero = d_a == 0.0
        inv = 1.0 / torch.where(zero, 1.0, d_a)
        lo_c = cmin[:, a][:, None]
        hi_c = cmax[:, a][:, None]
        near = (lo_c - o_a) * inv
        far = (hi_c - o_a) * inv
        lo = torch.minimum(near, far)
        hi = torch.maximum(near, far)
        inside = (o_a >= lo_c) & (o_a <= hi_c)
        lo = torch.where(zero, torch.where(inside, -_BIG, _BIG), lo)
        hi = torch.where(zero, torch.where(inside, _BIG, -_BIG), hi)
        t_near = torch.maximum(t_near, lo)
        t_far = torch.minimum(t_far, hi)
    hit = t_far > t_near
    if t_max_row is not None:
        hit &= t_near < t_max_row

    entry = torch.where(hit, t_near, _BIG)
    hit = hit.reshape(NC, nb, ray_block).any(dim=2).T          # [NB, NC]
    entry = entry.reshape(NC, nb, ray_block).amin(dim=2).T
    count = hit.sum(dim=1, dtype=torch.int32)
    # actives first, front-to-back by block-min entry distance
    order = torch.sort(torch.where(hit, entry, _BIG), dim=1,
                       stable=True).indices
    return _lists_with_entries(count, order, entry)


def _lists_with_entries(count, order, entry):
    """[NB, 1 + NC + NC] rows: count, front-to-back cluster ids, then the
    matching entry distances as order-preserving int32 bits (non-negative
    f32s compare identically as ints)."""
    entry_sorted = torch.gather(entry, 1, order)
    entry_bits = torch.clamp(entry_sorted, min=0.0).view(torch.int32)
    return torch.cat(
        [count[:, None], order.to(torch.int32), entry_bits], dim=1
    ).contiguous()


def cluster_lists_block(org, dir, t_min, cmin, cmax, t_max=None,
                        ray_block=RAY_BLOCK):
    """Per-block *interval* cull (pallas_find.py:389-514): O(NB x NC), no
    per-ray blowup; the lists of scenes past ``PER_RAY_CULL_MAX_CLUSTERS``
    clusters, of the streamed find and of the big scenes' occlusion.

    Each ray block is summarized by its origin AABB, per-component
    direction range and t bounds; the slab test then runs in interval
    arithmetic: if ANY (origin, direction) in the block's bounds could
    enter the box, the box is active. Strictly conservative (a superset
    of the exact per-ray cull's actives), so hits are never lost. The
    formulas and their order are JAX's: the ``d -> 0+`` cases, ``eps``,
    the ``zero_ok`` straddle and ``dead_block`` keep the cull
    conservative, and ``torch.minimum``/``maximum`` propagate NaN as
    ``jnp`` does. Past ``CULL_PAIRS_MAX`` (block, box) pairs the blocks are
    culled in groups: a block's row depends on its own rays only.
    """
    step = max(1, CULL_PAIRS_MAX // max(1, cmin.shape[0])) * ray_block
    if org.shape[0] <= step:
        return _interval_cull(org, dir, t_min, cmin, cmax, t_max, ray_block)
    return torch.cat([
        _interval_cull(org[r0:r0 + step], dir[r0:r0 + step],
                       t_min[r0:r0 + step], cmin, cmax,
                       None if t_max is None else t_max[r0:r0 + step],
                       ray_block)
        for r0 in range(0, org.shape[0], step)])


def _interval_cull(org, dir, t_min, cmin, cmax, t_max, ray_block):
    """``cluster_lists_block`` on one group of blocks."""
    R = org.shape[0]
    nb = -(-R // ray_block)
    pad_r = nb * ray_block - R

    alive = (t_min < _BIG)[:, None]
    o_lo = torch.where(alive, org, _BIG)
    o_hi = torch.where(alive, org, -_BIG)
    d_lo = torch.where(alive, dir, _BIG)
    d_hi = torch.where(alive, dir, -_BIG)
    tmin_b = torch.where(alive[:, 0], t_min, _BIG)
    if t_max is not None:
        tmax_r = torch.where(alive[:, 0], t_max, -_BIG)
    else:
        tmax_r = torch.where(alive[:, 0], _BIG, -_BIG)
    pad = torch.nn.functional.pad
    if pad_r:
        o_lo = pad(o_lo, (0, 0, 0, pad_r), value=_BIG)
        o_hi = pad(o_hi, (0, 0, 0, pad_r), value=-_BIG)
        d_lo = pad(d_lo, (0, 0, 0, pad_r), value=_BIG)
        d_hi = pad(d_hi, (0, 0, 0, pad_r), value=-_BIG)
        tmin_b = pad(tmin_b, (0, pad_r), value=_BIG)
        tmax_r = pad(tmax_r, (0, pad_r), value=-_BIG)

    o_lo = o_lo.reshape(nb, ray_block, 3).amin(dim=1)     # [NB, 3]
    o_hi = o_hi.reshape(nb, ray_block, 3).amax(dim=1)
    d_lo = d_lo.reshape(nb, ray_block, 3).amin(dim=1)
    d_hi = d_hi.reshape(nb, ray_block, 3).amax(dim=1)
    t0 = tmin_b.reshape(nb, ray_block).amin(dim=1)        # [NB]
    t1 = tmax_r.reshape(nb, ray_block).amax(dim=1)
    dead_block = t0 >= _BIG

    # per (block, box, axis): a = cmin - o >= a_lo, b = cmax - o <= b_hi,
    # direction d in [dl, dh]
    a_lo = cmin[None] - o_hi[:, None]                     # [NB, NC, 3]
    b_hi = cmax[None] - o_lo[:, None]
    dl = d_lo[:, None]
    dh = d_hi[:, None]
    eps = torch.tensor(1e-30, device=org.device)
    mx, mn, where = torch.maximum, torch.minimum, torch.where

    def div(num, den):
        return num / mx(den, eps)

    # earliest entry / latest exit on each axis over the interval box; an
    # entry minimum must allow d -> 0+ blowing the quotient to -inf when
    # the numerator can be negative (origin range straddles the slab)
    pos_ok = dh > 0.0
    ent_pos = where(
        pos_ok,
        where(a_lo >= 0.0, div(a_lo, dh),
              where(dl > 0.0, div(a_lo, dl), -_BIG)),
        _BIG)
    ext_pos = where(
        pos_ok,
        where(b_hi >= 0.0, div(b_hi, mx(dl, eps)), div(b_hi, dh)),
        -_BIG)
    # negative directions enter at the cmax side; with m = -d in (0, -dl],
    # entry = (-b) / m, exit = (-a) / m
    neg_ok = dl < 0.0
    ent_neg = where(
        neg_ok,
        where(-b_hi >= 0.0, div(-b_hi, -dl),
              where(dh < 0.0, div(-b_hi, -dh), -_BIG)),
        _BIG)
    ext_neg = where(
        neg_ok,
        where(a_lo <= 0.0, div(-a_lo, mx(-dh, eps)), div(-a_lo, -dl)),
        -_BIG)
    # zero-direction possibility: the slab overlaps the origin range
    zero_ok = (dl <= 0.0) & (dh >= 0.0) & (a_lo <= 0.0) & (b_hi >= 0.0)
    ent = where(zero_ok, -_BIG, mn(ent_pos, ent_neg))
    ext = where(zero_ok, _BIG, mx(ext_pos, ext_neg))

    t_near = mx(ent.amax(dim=-1), t0[:, None])            # [NB, NC]
    t_far = ext.amin(dim=-1)
    hit = (t_far > t_near) & (t_near < t1[:, None])
    hit &= ~dead_block[:, None]

    count = hit.sum(dim=1, dtype=torch.int32)
    entry = where(hit, t_near, _BIG)
    order = torch.sort(entry, dim=1, stable=True).indices
    return _lists_with_entries(count, order, entry)


def _uncull_lists(nb, nc, device):
    """Every cluster for every block, with zero entry bits (no early out)."""
    ids = torch.arange(nc, dtype=torch.int32, device=device).expand(nb, nc)
    return torch.cat(
        [torch.full((nb, 1), nc, dtype=torch.int32, device=device), ids,
         torch.zeros((nb, nc), dtype=torch.int32, device=device)], dim=1
    ).contiguous()


def _ray_table(columns, pad_values, ray_block=RAY_BLOCK):
    """[R] columns -> [Rpad, K] float32 ray table padded to whole blocks."""
    rays = torch.stack([c.to(torch.float32) for c in columns], dim=1)
    R = rays.shape[0]
    nb = -(-R // ray_block)
    pad = nb * ray_block - R
    if pad:
        fill = torch.zeros((pad, rays.shape[1]), device=rays.device)
        for col, value in pad_values.items():
            fill[:, col] = value
        rays = torch.cat([rays, fill])
    return rays.contiguous(), nb


def _scene_lists(scene, org, dir, t_min, t_max, nb, cull):
    """Triangle pack and worklists for a wavefront."""
    T = scene.tri_v0.shape[0]
    dev = org.device
    if T == 0:
        pack = torch.zeros((0, CLUSTER_SIZE, 16), device=dev)
        return pack, torch.zeros((nb, 1), dtype=torch.int32, device=dev)
    tri_pack, nc = _pack_triangles(scene)
    if cull and scene.cluster_min.shape[0] == nc:
        lists = cluster_lists(org, dir, t_min, scene.cluster_min,
                              scene.cluster_max, t_max=t_max)
    else:
        lists = _uncull_lists(nb, nc, dev)
    return tri_pack, lists


# ---------------------------------------------------------------------------
# closest hit
# ---------------------------------------------------------------------------

@torch.no_grad()
def find_hit_clustered(scene, org, dir, time, t_min=None, cull=True):
    """Closest hit for a ray wavefront. Returns (prim [R] int32, t [R]).
    Stop-gradient, as JAX (pallas_find.py:538-541): the packs are built
    without recording a graph.

    ``prim``: global primitive id (triangles then spheres), -1 = miss.
    ``t_min`` may be a scalar or per-ray [R]; rays with ``t_min >= 3e38``
    are dead (miss everything, excluded from the cull lists).
    """
    R = org.shape[0]
    t, prim = find_closest(*resident_inputs(scene, org, dir, time, t_min,
                                            cull))
    t, prim = t[:R], prim[:R]
    return prim, torch.where(prim >= 0, t, float("inf"))


@torch.no_grad()
def resident_inputs(scene, org, dir, time, t_min=None, cull=True):
    """The arguments of ``find_closest`` for a wavefront: (lists, rays,
    pack, boxes, sph_pack, n_tris). The lists come from the per-ray cull of
    the scene's cluster boxes for ``RAY_BLOCK``-ray blocks (every cluster
    without ``cull``), bounded by the closest sphere hits; the walk's
    padded boxes from the triangles' current positions (``_tri_boxes``), so
    that a box never misses its cluster's triangles."""
    t_min = _per_ray_t_min(t_min, org)
    rays, nb = _ray_table(
        [org[:, 0], org[:, 1], org[:, 2], dir[:, 0], dir[:, 1], dir[:, 2],
         time, t_min], {7: _BIG})
    # the closest sphere hit bounds each ray: clusters wholly beyond it
    # cannot change the answer (without triangles there is nothing to cull)
    sph_bound = None
    if scene.sph_c0.shape[0] > 0 and scene.tri_v0.shape[0] > 0:
        sph_bound, _ = _sph_candidates(scene, org, dir, time, t_min)
    pack, lists = _scene_lists(scene, org, dir, t_min, sph_bound, nb, cull)
    if pack.shape[0]:
        boxes = _tri_boxes(scene.tri_v0, scene.tri_v1, scene.tri_v2)
    else:
        boxes = torch.zeros((0, 8), device=rays.device)
    return lists, rays, pack, boxes, _pack_spheres(scene), \
        scene.tri_v0.shape[0]


def find_closest(lists, rays, pack, boxes, sph_pack, n_tris):
    """Closest hit per ray over the resident worklists of ``RAY_BLOCK``-ray
    blocks -> (t [Rpad] f32, prim [Rpad] int32; -1 = miss).

    Launches the CUDA kernel on CUDA tensors (csrc/find.cu), runs
    ``find_streamed_plain`` (the walk of ``_lane_walk``, spheres first) on
    CPU tensors.

    Kernel note. Replaces ``_find_kernel`` (pallas_find.py:170), which
    stages each active cluster's [16, CK] slab in VMEM and tests every lane
    of its ray block against it. What bounds it on the card is the test
    loop, ~37 float32 operations per (ray, triangle) test, times the tests
    it makes. The first port ran that design: one thread a ray, every lane
    of a 128-ray block on every tile the block visited until a block-wide
    early out, 16 scalar shared-memory loads a test; at bounces 1 and 2 of
    the frame its blocks listed 3.3x and 16x the tests their rays need. It
    now runs the cluster walk of ``find_streamed`` on the same lists and in
    the same order: a per-ray slab test against the padded box of each
    cluster, a warp that no ray needs skipping the tile, a triangle read as
    four 16-byte words; tiles arrive by one bulk copy each into a ring of
    two stages. The walk's test loop is a chain of dependent operations,
    so kernel 1 runs one ray a lane: four consumer warps a 128-ray block,
    which on the H100 beat two rays a lane and 256-ray blocks at every
    bounce (``PERF.md``). Spheres come first;
    a triangle replaces the best only if strictly nearer.
    """
    if not rays.is_cuda:
        return find_streamed_plain(lists, rays, pack, boxes, sph_pack,
                                   n_tris)
    nb = _check_walk_args(lists, rays, pack, boxes, 8, RAY_BLOCK)
    _check_sph(sph_pack, rays.device)
    Rpad = rays.shape[0]
    out_t = torch.empty(Rpad, dtype=torch.float32, device=rays.device)
    out_i = torch.empty(Rpad, dtype=torch.int32, device=rays.device)
    FIND_CLOSEST.launch(
        rays.device,
        _cuda.ptr(lists), lists.shape[1], _cuda.ptr(rays), _cuda.ptr(pack),
        pack.shape[0], pack.shape[1], _cuda.ptr(boxes), _cuda.ptr(sph_pack),
        sph_pack.shape[0], n_tris, RAY_BLOCK, nb,
        _cuda.ptr(out_t), _cuda.ptr(out_i),
    )
    return out_t, out_i


def _check_sph(sph_pack, device):
    if sph_pack.device != device or sph_pack.dtype != torch.float32 \
            or not sph_pack.is_contiguous() or sph_pack.ndim != 2 \
            or sph_pack.shape[1] != 8:
        raise ValueError("sph_pack must be a contiguous float32 [Spad, 8] "
                         f"tensor on {device}")


def _sphere_tc(rays, sph_pack):
    """Per (ray, sphere) nearest valid root, else BIG: [n, Spad].

    In blocks of about ``_TC_BLOCK_PAIRS`` (ray, sphere) pairs, whose
    temporaries stay small, and only for the rays that could take a root:
    each pair's arithmetic is the same, and a ray is skipped (BIG) only
    where no root can reach its t_min. Both roots lie within (|o - c| + r)
    / |d| of 0 (disc <= |d|^2 r^2 by Cauchy-Schwarz), and |o - c| <= |o| +
    max |c0| + max |dc| |time|. The test's terms are products of up to four
    such lengths, so the skip also needs |d| and that bound within [1e-9,
    1e9]: then no term overflows, and rounding moves a root by far less
    than the 4x margin. Dead rays (t_min 3e38) are the ones this skips."""
    s = sph_pack
    d_len = rays[:, 3:6].norm(dim=1)
    far = rays[:, 0:3].norm(dim=1) + s[:, 0:3].norm(dim=1).max() \
        + s[:, 3:6].norm(dim=1).max() * rays[:, 6].abs() + s[:, 6].abs().max()
    skip = (far <= 1e9) & (d_len >= 1e-9) & (d_len <= 1e9) \
        & (rays[:, 7] > 4.0 * far / d_len)
    out = torch.full((rays.shape[0], s.shape[0]), _BIG, device=rays.device)
    rows = torch.nonzero(~skip).flatten()
    block = max(512, _TC_BLOCK_PAIRS // max(1, s.shape[0]))
    for i in range(0, rows.numel(), block):
        r = rows[i:i + block]
        out[r] = _sphere_tc_block(rays[r], s)
    return out


def _sphere_tc_block(rays, sph_pack):
    ox, oy, oz = rays[:, 0:1], rays[:, 1:2], rays[:, 2:3]
    dx, dy, dz = rays[:, 3:4], rays[:, 4:5], rays[:, 5:6]
    tm, t_min = rays[:, 6:7], rays[:, 7:8]
    s = sph_pack
    cx = s[:, 0] + s[:, 3] * tm
    cy = s[:, 1] + s[:, 4] * tm
    cz = s[:, 2] + s[:, 5] * tm
    ocx, ocy, ocz = ox - cx, oy - cy, oz - cz
    a = dx * dx + dy * dy + dz * dz
    half_b = ocx * dx + ocy * dy + ocz * dz
    cterm = ocx * ocx + ocy * ocy + ocz * ocz - s[:, 6] * s[:, 6]
    disc = half_b * half_b - a * cterm
    has = disc >= 0.0
    sq = torch.sqrt(torch.where(has, disc, 0.0))
    safe_a = torch.where(a == 0.0, 1.0, a)
    root0 = (-half_b - sq) / safe_a
    root1 = (-half_b + sq) / safe_a
    s_valid = s[:, 7] > 0.0
    ok0 = has & (root0 >= t_min) & s_valid
    ok1 = has & (root1 >= t_min) & s_valid
    return torch.where(ok0, root0, torch.where(ok1, root1, _BIG))


def _tile_t(tile, rays_b):
    """One cluster tile per block against its rays: [n, CK, 16] x
    [n, BR, 8+] -> (t [n, BR, CK], valid [n, BR, CK])."""
    ox, oy, oz = rays_b[..., 0:1], rays_b[..., 1:2], rays_b[..., 2:3]
    dx, dy, dz = rays_b[..., 3:4], rays_b[..., 4:5], rays_b[..., 5:6]
    t_min = rays_b[..., 7:8]
    r = [tile[:, None, :, i] for i in range(16)]
    ndir = dx * r[0] + dy * r[1] + dz * r[2]
    a_n = ox * r[0] + oy * r[1] + oz * r[2] + r[3]
    plane_ok = ndir <= -EPSILON
    t = -a_n / torch.where(plane_ok, ndir, -1.0)
    px = ox + t * dx
    py = oy + t * dy
    pz = oz + t * dz
    e0 = r[4] * px + r[5] * py + r[6] * pz - r[7]
    e1 = r[8] * px + r[9] * py + r[10] * pz - r[11]
    e2 = r[12] * px + r[13] * py + r[14] * pz - r[15]
    valid = plane_ok & (e0 >= 0.0) & (e1 >= 0.0) & (e2 >= 0.0) & (t >= t_min)
    return t, valid


def _worst_bits(x):
    """The block's largest best-t (or bound) as int32 bits: [n, BR] -> [n]."""
    return x.view(torch.int32).amax(dim=1)


def _block_chunks(nb, tri_pack, ray_block=RAY_BLOCK):
    ck = max(tri_pack.shape[1], 1)
    step = max(1, _PLAIN_CHUNK_ELEMS // (ray_block * ck))
    return [(b0, min(nb, b0 + step)) for b0 in range(0, nb, step)]


# ---------------------------------------------------------------------------
# the cluster walk of kernels 1, 8 and 2: per-lane boxes, the plain walk
# ---------------------------------------------------------------------------

def _cluster_boxes(scene):
    """The scene's cluster AABBs [NC, 3] x 2 (derived where the scene has
    no cluster metadata)."""
    nc = -(-scene.tri_v0.shape[0] // CLUSTER_SIZE)
    if scene.cluster_min.shape[0] == nc:
        return scene.cluster_min, scene.cluster_max
    return cluster_bounds_device(scene.tri_v0, scene.tri_v1, scene.tri_v2)


def _padded_boxes(cmin, cmax):
    """[NC, 8] float32 rows (lo xyz, 0, hi xyz, 0): the cluster boxes that
    the walk's per-ray slab test reads, padded on every side by 1e-5 of
    the scene's extent (1 + its largest coordinate), far above the float32
    rounding of that test and of the triangle test, so a ray the test
    turns away has no hit in the box."""
    real = (cmin <= cmax).all(dim=1, keepdim=True)
    ext = torch.where(real, torch.maximum(cmin.abs(), cmax.abs()), 0.0)
    m = 1e-5 * (1.0 + ext.amax()) if cmin.numel() else 0.0
    zero = torch.zeros_like(cmin[:, :1])
    return torch.cat([cmin - m, zero, cmax + m, zero], dim=1).contiguous()


# the padded boxes of the given cluster boxes (kernels 8 and 2), kept for
# the box tensors they were last made of
_lane_boxes = _derived(_padded_boxes)


@_derived
def _tri_boxes(v0, v1, v2):
    """The padded boxes of the clusters of the triangles ``v0, v1, v2``
    [T, 3] as they are now (kernel 1), kept for the vertex tensors they
    were last made of."""
    return _padded_boxes(*cluster_bounds_device(v0, v1, v2))


def _lane_enters(rays_b, boxes, best):
    """The walk's per-ray slab test (csrc/find.cu ``lane_enters``): does
    each ray of ``rays_b`` [n, RB, 8+] enter its block's box ``boxes``
    [n, 8] before ``best`` [n, RB]? The per-ray cull's formulas; min and
    max as C's ``fminf``/``fmaxf``."""
    t_near = rays_b[..., 7]
    t_far = torch.full_like(t_near, _BIG)
    for a in range(3):
        o, d = rays_b[..., a], rays_b[..., 3 + a]
        lo, hi = boxes[:, None, a], boxes[:, None, 4 + a]
        zero = d == 0.0
        inv = 1.0 / torch.where(zero, 1.0, d)
        near = (lo - o) * inv
        far = (hi - o) * inv
        inside = (o >= lo) & (o <= hi)
        lo_t = torch.where(zero, torch.where(inside, -_BIG, _BIG),
                           torch.fmin(near, far))
        hi_t = torch.where(zero, torch.where(inside, _BIG, -_BIG),
                           torch.fmax(near, far))
        t_near = torch.fmax(t_near, lo_t)
        t_far = torch.fmin(t_far, hi_t)
    return (t_far > t_near) & (t_near < best)


def _lane_walk(lists, rays, pack, boxes, state, index=None):
    """The walk of kernels 8 (``index`` given: closest hit) and 2 (any
    hit) on ``state`` [Rpad] (best t, or bound), vectorized over blocks of
    ``Rpad // NB`` rays: each block's clusters front to back; a ray tests
    a tile when its state lies beyond the tile's entry distance and its
    slab test enters the padded box before it; a block stops where no ray
    lies beyond the entry. Closest hit: strict '<', the lowest id within
    a tile, the earlier tile across tiles. Updates ``state`` (and
    ``index``) in place."""
    Rpad = rays.shape[0]
    nb = lists.shape[0]
    if nb == 0 or pack.shape[0] == 0:
        return
    RB = Rpad // nb
    nc = (lists.shape[1] - 1) // 2
    ck = pack.shape[1]
    big_id = torch.tensor(2 ** 30, dtype=torch.int32, device=rays.device)
    lane = torch.arange(ck, dtype=torch.int32, device=rays.device)
    for b0, b1 in _block_chunks(nb, pack, RB):
        st = state[b0 * RB:b1 * RB].view(b1 - b0, RB)
        ix = None if index is None else index[b0 * RB:b1 * RB].view(
            b1 - b0, RB)
        rays_b = rays[b0 * RB:b1 * RB].reshape(b1 - b0, RB, -1)
        lst = lists[b0:b1]
        active = torch.ones(b1 - b0, dtype=torch.bool, device=rays.device)
        for k in range(nc):
            active &= (k < lst[:, 0]) \
                & (lst[:, 1 + nc + k] < _worst_bits(st))
            blk = active.nonzero().squeeze(1)
            if blk.numel() == 0:
                break
            c = lst[blk, 1 + k].long()
            s = st[blk]
            live = (s.view(torch.int32) > lst[blk, 1 + nc + k][:, None]) \
                & _lane_enters(rays_b[blk], boxes[c], s)
            t, valid = _tile_t(pack[c], rays_b[blk])
            if index is None:
                hit = (valid & (t < s[..., None])).any(dim=2)
                st[blk] = torch.where(live & hit, -_BIG, s)
                continue
            tcl = torch.where(valid, t, _BIG)
            tile_t = tcl.amin(dim=2)
            win = torch.where(
                tcl <= tile_t[..., None],
                (c[:, None] * ck).to(torch.int32)[..., None] + lane,
                big_id).amin(dim=2)
            better = live & (tile_t < s)
            st[blk] = torch.where(better, tile_t, s)
            ix[blk] = torch.where(better, win, ix[blk])


def _check_walk_args(lists, rays, pack, boxes, n_cols, ray_block):
    """Validate what kernels 8 and 2 read; returns the block count."""
    dev = rays.device
    for name, x, dtype in (("lists", lists, torch.int32),
                           ("rays", rays, torch.float32),
                           ("pack", pack, torch.float32),
                           ("boxes", boxes, torch.float32)):
        if x.device != dev or x.dtype != dtype or not x.is_contiguous():
            raise ValueError(
                f"{name}: need a contiguous {dtype} tensor on {dev}, got "
                f"{x.dtype} on {x.device} (contiguous={x.is_contiguous()})"
            )
    nb = lists.shape[0]
    if rays.ndim != 2 or rays.shape != (nb * ray_block, n_cols):
        raise ValueError(f"rays must be [{nb} * {ray_block}, {n_cols}] for "
                         f"{nb} list rows, got {tuple(rays.shape)}")
    nc = pack.shape[0]
    if pack.ndim != 3 or pack.shape[2] != 16 or pack.shape[1] > 512 \
            or pack.shape[1] % 4:
        raise ValueError(f"pack must be [NC, CK <= 512, a multiple of 4, "
                         f"16], got {tuple(pack.shape)}")
    if lists.shape[1] != 1 + 2 * nc or boxes.shape != (nc, 8):
        raise ValueError(f"lists {tuple(lists.shape)} and boxes "
                         f"{tuple(boxes.shape)} do not fit {nc} clusters")
    return nb


# ---------------------------------------------------------------------------
# closest hit, streamed clusters (big scenes)
# ---------------------------------------------------------------------------

@torch.no_grad()
def find_hit_streamed(scene, org, dir, time, t_min=None):
    """Closest hit for scenes past the resident limit (the function of
    pallas_find.py:980-1109). Returns (prim [R] int32, t [R]);
    stop-gradient.

    The interval cull (``cluster_lists_block``) over the cluster boxes
    gives each block of ``STREAM_RAY_BLOCK`` rays its worklist, bounded by
    the rays' closest sphere hits, and the kernel walks the survivors.
    """
    R = org.shape[0]
    t, prim = find_streamed(*streamed_inputs(scene, org, dir, time, t_min))
    t, prim = t[:R], prim[:R]
    return prim, torch.where(prim >= 0, t, float("inf"))


@torch.no_grad()
def streamed_inputs(scene, org, dir, time, t_min=None):
    """The arguments of ``find_streamed`` for a wavefront: (lists, rays,
    pack, boxes, sph_pack, n_tris).

    The JAX package culls superclusters of 16 clusters for 512-ray blocks,
    sized for the TPU's DMA and its scalar-memory worklists; the card
    reads worklists from device memory, so the lists hold single clusters
    for blocks of ``STREAM_RAY_BLOCK`` rays (on the H100, 256-ray blocks
    beat 128-ray ones at bounces 1 and 2 of the big frame and matched them
    at bounce 0, ``PERF.md``).
    """
    t_min = _per_ray_t_min(t_min, org)
    rays, _ = _ray_table(
        [org[:, 0], org[:, 1], org[:, 2], dir[:, 0], dir[:, 1], dir[:, 2],
         time, t_min], {7: _BIG}, STREAM_RAY_BLOCK)
    pack, _ = _pack_triangles(scene)                    # [NC, CK, 16]
    cmin, cmax = _cluster_boxes(scene)
    sph_bound = None
    if scene.sph_c0.shape[0] > 0:
        sph_bound, _ = _sph_candidates(scene, org, dir, time, t_min)
    lists = cluster_lists_block(org, dir, t_min, cmin, cmax, t_max=sph_bound,
                                ray_block=STREAM_RAY_BLOCK)
    return lists, rays, pack, _lane_boxes(cmin, cmax), _pack_spheres(scene), \
        scene.tri_v0.shape[0]


def find_streamed(lists, rays, pack, boxes, sph_pack, n_tris):
    """Closest hit per ray over cluster worklists -> (t [Rpad] f32, prim
    [Rpad] int32; -1 = miss).

    Launches the CUDA kernel on CUDA tensors (csrc/find.cu), runs
    ``find_streamed_plain`` on CPU tensors.

    Kernel note. Replaces ``_find_streamed_kernel`` (pallas_find.py:893),
    which double-buffers 128 KB supercluster slabs into VMEM for 512-ray
    blocks. What bounds it on the card is the test loop, ~37 float32
    operations per (ray, triangle) test, and how many tests the walk makes:
    a 16-cluster unit checked for the early out only at its end, and a
    block of 512 rays that tests every tile for every lane, ran ~153 G
    tests on the big frame's bounce-1 chunk. The design: 256-triangle
    cluster tiles for blocks of 128 or 256 rays, front to back with the
    early out at every tile; per ray a slab test against the cluster's
    padded box, so a warp whose rays all miss the box skips the tile, and
    a warp vote that skips triangles no live ray faces; two rays a lane,
    so each triangle read from shared memory (four 16-byte loads) serves
    two tests; a producer lane that keeps a ring of three stages filled,
    one bulk copy of a cluster's [CK, 16] tile each, with ``mbarrier``
    completion. Spheres come first; a triangle replaces the best only if
    strictly nearer.
    """
    if not rays.is_cuda:
        return find_streamed_plain(lists, rays, pack, boxes, sph_pack,
                                   n_tris)
    nb = _check_walk_args(lists, rays, pack, boxes, 8, STREAM_RAY_BLOCK)
    _check_sph(sph_pack, rays.device)
    Rpad = rays.shape[0]
    out_t = torch.empty(Rpad, dtype=torch.float32, device=rays.device)
    out_i = torch.empty(Rpad, dtype=torch.int32, device=rays.device)
    FIND_STREAMED.launch(
        rays.device,
        _cuda.ptr(lists), lists.shape[1], _cuda.ptr(rays), _cuda.ptr(pack),
        pack.shape[0], pack.shape[1], _cuda.ptr(boxes), _cuda.ptr(sph_pack),
        sph_pack.shape[0], n_tris, STREAM_RAY_BLOCK, nb, _cuda.ptr(out_t),
        _cuda.ptr(out_i),
    )
    return out_t, out_i


def find_streamed_plain(lists, rays, pack, boxes, sph_pack, n_tris):
    """Plain PyTorch version of ``find_streamed``: spheres first, then the
    walk of ``_lane_walk`` (the same lists, order, per-ray test, early out
    and tie rule)."""
    tc = _sphere_tc(rays, sph_pack)
    best = tc.amin(dim=1)
    srow = torch.arange(tc.shape[1], dtype=torch.int32, device=rays.device)
    index = torch.where(tc <= best[:, None], n_tris + srow,
                        2 ** 30).amin(dim=1).to(torch.int32)
    index = torch.where(best < _BIG, index, -1)
    if n_tris > 0:
        _lane_walk(lists, rays, pack, boxes, best, index)
    return best, torch.where(best < _BIG, index, -1)


# ---------------------------------------------------------------------------
# any hit (last-bounce occlusion)
# ---------------------------------------------------------------------------

@torch.no_grad()
def find_occluded(scene, org, dir, time, t_bound, t_min=None,
                  sphere_occluder=None):
    """Any-hit query: per ray, does a NON-emissive primitive hit with
    ``t_min <= t < t_bound``? Returns bool [R]. Stop-gradient, as JAX
    (pallas_find.py:788-792).

    ``t_bound`` [R]: the closest emissive hit's t (3e38 when the lane hit
    no emissive prim). Negative t_bound marks dead lanes (reported
    occluded; callers mask with ``alive``). ``sphere_occluder`` [S] bool:
    which spheres block light. Every triangle is an occluder, so callers
    gate on ``scene_no_emissive_tris``.
    """
    R = org.shape[0]
    lists, rays, perm, pack, boxes, n_tris = occluded_inputs(
        scene, org, dir, time, t_bound, t_min, sphere_occluder)
    return find_any(lists, rays, perm, pack, boxes, n_tris)[:R] > 0


@torch.no_grad()
def occluded_inputs(scene, org, dir, time, t_bound, t_min=None,
                    sphere_occluder=None):
    """The arguments of ``find_any`` for a wavefront: (lists, rays, perm,
    pack, boxes, n_tris).

    ``any_regroup`` tests the occluder spheres and regroups the wavefront,
    live rays first; the cull sees the resolved rays as dead, so blocks of
    them get empty lists.
    """
    t_min = _per_ray_t_min(t_min, org)
    rays, perm, cull_t_min, cull_t_max = any_regroup(
        org, dir, time, t_min, t_bound,
        _pack_spheres(scene, sphere_occluder))
    pack, lists = _scene_lists(scene, rays[:, 0:3], rays[:, 3:6], cull_t_min,
                               cull_t_max, rays.shape[0] // RAY_BLOCK,
                               cull=True)
    if pack.shape[0]:
        boxes = _lane_boxes(*_cluster_boxes(scene))
    else:
        boxes = torch.zeros((0, 8), device=rays.device)
    return lists, rays, perm, pack, boxes, scene.tri_v0.shape[0]


def any_regroup(org, dir, time, t_min, t_bound, sph_pack):
    """Kernel 2's wavefront, resolved where the spheres decide and
    regrouped -> (rays [Rpad, 9], perm [Rpad] int32, cull_t_min [Rpad],
    cull_t_max [Rpad]), Rpad = R rounded up to whole ``RAY_BLOCK``s.

    A ray is resolved when its bound is negative (dead) or an occluder
    sphere of ``sph_pack`` has its nearest valid root before the bound
    (the kernel's formulas, ``_sphere_tc``); its bound becomes -3e38. The
    ray table ox oy oz dx dy dz time t_min bound is partitioned stably,
    live rays first, each part in wavefront order (pad rows are dead);
    ``perm[r]`` is the wavefront index of row r. The cull's t_min is
    3e38 and its t_max 0 on resolved rows, t_min and the bound elsewhere.

    Launches the CUDA pass on CUDA tensors (csrc/find.cu
    ``srt_any_regroup``: a flag-and-count kernel, a scan of the block
    counts and a scatter, from one C call), runs ``any_regroup_plain`` on
    CPU tensors. It replaces the sphere test of ``_occluded_kernel``
    (pallas_find.py:689-728), which the TPU ran inside the kernel.
    """
    if not org.is_cuda:
        return any_regroup_plain(org, dir, time, t_min, t_bound, sph_pack)
    org, dir, time, t_min, t_bound = (
        x.to(torch.float32).contiguous()
        for x in (org, dir, time, t_min, t_bound))
    R = org.shape[0]
    dev = org.device
    if org.shape != (R, 3) or dir.shape != (R, 3) \
            or any(x.shape != (R,) for x in (time, t_min, t_bound)) \
            or any(x.device != dev for x in (dir, time, t_min, t_bound)):
        raise ValueError(f"any_regroup: need org, dir [R, 3] and time, "
                         f"t_min, t_bound [R] on {dev}")
    if sph_pack.device != dev or sph_pack.dtype != torch.float32 \
            or not sph_pack.is_contiguous() or sph_pack.ndim != 2 \
            or sph_pack.shape[1] != 8:
        raise ValueError(f"sph_pack must be a contiguous float32 [Spad, 8] "
                         f"tensor on {dev}")
    Rpad = -(-R // RAY_BLOCK) * RAY_BLOCK
    n_blocks = -(-Rpad // _REGROUP_BLOCK)
    scratch = torch.empty(Rpad + 2 * n_blocks + 1, dtype=torch.int32,
                          device=dev)
    rays = torch.empty((Rpad, 9), dtype=torch.float32, device=dev)
    perm = torch.empty(Rpad, dtype=torch.int32, device=dev)
    cull = torch.empty((2, Rpad), dtype=torch.float32, device=dev)
    ANY_REGROUP.launch(
        dev, _cuda.ptr(org), _cuda.ptr(dir), _cuda.ptr(time),
        _cuda.ptr(t_min), _cuda.ptr(t_bound), R, _cuda.ptr(sph_pack),
        sph_pack.shape[0], Rpad, _cuda.ptr(scratch), _cuda.ptr(rays),
        _cuda.ptr(perm), _cuda.ptr(cull[0]), _cuda.ptr(cull[1]),
    )
    return rays, perm, cull[0], cull[1]


def any_regroup_plain(org, dir, time, t_min, t_bound, sph_pack):
    """Plain PyTorch version of ``any_regroup``: the sphere test of
    ``_sphere_tc``, then a stable sort on the resolved flag."""
    rays, _ = _ray_table(
        [org[:, 0], org[:, 1], org[:, 2], dir[:, 0], dir[:, 1], dir[:, 2],
         time, t_min, t_bound], {7: _BIG, 8: -_BIG})
    tc = _sphere_tc(rays, sph_pack)
    occ = torch.where(tc < rays[:, 8:9], tc, _BIG).amin(dim=1) < _BIG
    resolved = occ | (rays[:, 8] < 0.0)
    perm = torch.sort(resolved.to(torch.uint8), stable=True).indices
    rays = rays[perm]
    resolved = resolved[perm]
    rays[:, 8] = torch.where(resolved, -_BIG, rays[:, 8])
    return rays, perm.to(torch.int32), \
        torch.where(resolved, _BIG, rays[:, 7]), \
        torch.where(resolved, 0.0, rays[:, 8])


def find_any(lists, rays, perm, pack, boxes, n_tris):
    """Occlusion flag per wavefront ray -> [Rpad] int32 (1 = a valid hit
    before the ray's bound, or a ray resolved before: dead or occluded by
    a sphere), from the regrouped table of ``occluded_inputs``.

    Launches the CUDA kernel on CUDA tensors (csrc/find.cu), runs
    ``find_any_plain`` on CPU tensors.

    Kernel note. Replaces ``_occluded_kernel`` (pallas_find.py:681). What
    bounded the first port was divergence: most last-bounce rays die on
    the ground sphere, yet every lane of a block ran every tile the block
    visited, idle or stopped at its first occluder by a per-lane break.
    The design: the rays resolved before any triangle work leave the
    wavefront before the cull (``any_regroup``); the kernel takes the
    live rays regrouped into dense blocks (blocks of resolved rays have
    empty lists and leave at once) and writes each flag to its ray's own
    index; it walks the tiles as ``find_streamed`` does (the same ring,
    layout and per-ray box test), an occluder ends a ray's tests by a
    predicate, a warp leaves a tile once its rays are resolved and a tile
    that no ray enters is skipped by the warp. Any hit is free of order,
    so the flags equal the first port's on the same wavefront.
    """
    if not rays.is_cuda:
        return find_any_plain(lists, rays, perm, pack, boxes, n_tris)
    nb = _check_walk_args(lists, rays, pack, boxes, 9, RAY_BLOCK)
    if perm.device != rays.device or perm.dtype != torch.int32 \
            or perm.shape != (rays.shape[0],) or not perm.is_contiguous():
        raise ValueError(f"perm must be a contiguous int32 [{rays.shape[0]}] "
                         f"tensor on {rays.device}")
    out = torch.empty(rays.shape[0], dtype=torch.int32, device=rays.device)
    FIND_ANY.launch(
        rays.device,
        _cuda.ptr(lists), lists.shape[1], _cuda.ptr(rays), _cuda.ptr(perm),
        _cuda.ptr(pack), pack.shape[0], pack.shape[1], _cuda.ptr(boxes),
        n_tris, RAY_BLOCK, nb, _cuda.ptr(out),
    )
    return out


def find_any_plain(lists, rays, perm, pack, boxes, n_tris):
    """Plain PyTorch version of ``find_any``: the walk of ``_lane_walk``
    on the regrouped rays, each flag written to its ray's own index."""
    bound = rays[:, 8].clone()
    if n_tris > 0:
        _lane_walk(lists, rays, pack, boxes, bound)
    out = torch.empty(rays.shape[0], dtype=torch.int32, device=rays.device)
    out[perm.long()] = (bound < 0.0).to(torch.int32)
    return out
