"""Brute-force closest-triangle search over a plane/edge weight stack
(counterpart of ``sexy_raytracer_tpu/ops/pallas_intersect.py``), reached
with ``find_hit(method="pallas_mxu")``: the JAX package's round-1
comparison path, kept for comparison.

The triangle test is phrased as two products with a ``[4, 4 Tpad]`` weight
stack ``W`` of the precomputed plane/edge vectors:

    org4 = [ox, oy, oz, 1],  dir4 = [dx, dy, dz, 0]
    a = org4 . W   -> per triangle [org.n + d | org.q_i - c_i]   (i = 0..2)
    b = dir4 . W   -> per triangle [dir.n     | dir.q_i        ]
    t = -a_n / b_n
    edge_i = a_qi + t * b_qi            (>= 0 inside, model.h:136-154)
    valid  = (b_n <= -eps) & edges & (t >= t_min)

``W``'s columns are grouped per ``TRI_TILE``-triangle tile as
``[n | q0 | q1 | q2]``. The edges are the ``a + t b`` form, not the
clustered kernels' at-``p`` form, so near-edge rays may resolve
differently from ``method="pallas"``.

``tri_brute`` launches the CUDA kernel ``srt_tri_brute`` (csrc/brute.cu) on
CUDA tensors and runs ``tri_brute_plain`` on CPU tensors. The kernel reads
the weights packed triangle-major (``pack_weights``), splits the triangle
axis into slices when the ray blocks alone do not fill the card
(``launch_shape``) and merges the slices' partial hits (``merge_plain``),
and lets a warp skip a triangle that no lane's range test passes
(``range_maybe_plain``); each part's plain version here is used by the
tests only.
"""

from __future__ import annotations

import torch

from sexy_raytracer_tpu_torch.ops import _cuda
from sexy_raytracer_tpu_torch.ops.intersect import (
    T_MIN_DEFAULT,
    _sph_candidates,
    find_hit_bruteforce,
)
from sexy_raytracer_tpu_torch.utils.mathx import EPSILON

RAY_BLOCK = 256      # rays per CUDA block (the TPU kernel's rays per program)
TRI_TILE = 512       # triangles per tile of W; a slice is whole tiles
# blocks a launch aims at for each SM when it splits the triangle axis:
# about nine waves of the seven blocks an SM holds (55 registers, 160
# threads, 24.6 KB, ptxas), so that no SM idles behind the slowest blocks
# (fewer slices left the card idle: `tools.find_split brute --slices`,
# PERF.md)
BLOCKS_PER_SM = 64
RAYS_PER_LANE = 2    # rays a lane of the kernel (RPT in csrc/brute.cu)
_BIG = 3.0e38
# a best t or t_min below this takes no part in the range test (its
# product with a plane's |b_n| >= EPSILON might leave the normal range)
_RANGE_TINY = 2.0 ** -100
# rays per chunk of the plain version: bounds its [rays, 4 TRI_TILE]
# intermediates at 64 MB
_PLAIN_ROWS = 8192

# the shape of the last launch of kernel 9, set where it launches: {rays,
# slices, blocks}
LAST_LAUNCH = {}

TRI_BRUTE = _cuda.Kernel(
    "srt_tri_brute", "pppiifiipppp",
    source="sexy_raytracer_tpu_torch/csrc/brute.cu",
    replaces="sexy_raytracer_tpu/ops/pallas_intersect.py:53 (_tri_kernel)",
)


def build_weights(scene):
    """[4, 4 Tpad] weight stack, columns tile-grouped as [n|q0|q1|q2]
    (pallas_intersect.py:98-121)."""
    n, d, q, c = scene.tri_n, scene.tri_d, scene.tri_q, scene.tri_c
    T = n.shape[0]
    n_tiles = max(1, -(-T // TRI_TILE))
    pad = n_tiles * TRI_TILE - T
    wn = torch.cat([n, d[:, None]], dim=1)                        # [T, 4]
    wq = [torch.cat([q[:, i, :], -c[:, i:i + 1]], dim=1) for i in range(3)]
    mats = [torch.nn.functional.pad(m, (0, 0, 0, pad))
            .reshape(n_tiles, TRI_TILE, 4) for m in [wn] + wq]
    stacked = torch.cat(mats, dim=1)                 # [n_tiles, 4 TT, 4]
    return stacked.reshape(n_tiles * 4 * TRI_TILE, 4).T.contiguous()


def pack_weights(w):
    """``w`` [4, 4 Tpad] triangle-major -> [Tpad, 16]: triangle j's row is
    its four column groups n|q0|q1|q2, each the 4 weights of rows 0-3."""
    n_tiles = w.shape[1] // (4 * TRI_TILE)
    return w.view(4, n_tiles, 4, TRI_TILE).permute(1, 3, 2, 0) \
        .reshape(n_tiles * TRI_TILE, 16).contiguous()


def launch_shape(rays, n_tiles, n_sms, slices=None):
    """(ray blocks, slices) of a launch over ``rays`` (a multiple of
    RAY_BLOCK) and ``n_tiles`` tiles on a card of ``n_sms`` SMs: the fewest
    slices that make BLOCKS_PER_SM blocks an SM, at most one a tile;
    ``slices`` forces the count (clipped to the tiles)."""
    blocks = rays // RAY_BLOCK
    if slices is None:
        slices = -(-BLOCKS_PER_SM * n_sms // max(blocks, 1))
    return blocks, max(1, min(n_tiles, slices))


def ray4(org, dir):
    """(org4, dir4) [Rpad, 4]: ``[o, 1]`` and ``[d, 0]`` rows padded with
    zeros to whole blocks of RAY_BLOCK rays."""
    pad = (-org.shape[0]) % RAY_BLOCK
    ones = torch.ones((org.shape[0], 1), device=org.device)
    org4 = torch.cat([org, ones], dim=1)
    dir4 = torch.cat([dir, torch.zeros_like(ones)], dim=1)
    return (torch.nn.functional.pad(org4, (0, 0, 0, pad)).contiguous(),
            torch.nn.functional.pad(dir4, (0, 0, 0, pad)).contiguous())


@torch.no_grad()
def find_hit_brute(scene, org, dir, time, t_min=None):
    """Closest hit by the brute-force kernel -> ``(prim [R] int32, t [R])``
    (``find_hit_pallas``, pallas_intersect.py:163-201).

    The kernel takes one scalar ``t_min``: a per-ray ``t_min`` goes to
    ``find_hit_bruteforce``, as in the JAX package. Spheres come from
    ``_sph_candidates`` and win when strictly nearer.
    """
    R = org.shape[0]
    if t_min is None:
        t_min_scalar = T_MIN_DEFAULT
    elif not torch.is_tensor(t_min) or t_min.ndim == 0:
        t_min_scalar = float(t_min)
    else:
        return find_hit_bruteforce(scene, org, dir, time, t_min)
    t_min_vec = torch.full((R,), t_min_scalar, dtype=torch.float32,
                           device=org.device)

    T = scene.tri_v0.shape[0]
    if T > 0:
        tri_t, tri_i = tri_brute(*ray4(org, dir), build_weights(scene),
                                 t_min_scalar)
        tri_t, tri_i = tri_t[:R], tri_i[:R]
        tri_t = torch.where(tri_i >= 0, tri_t, float("inf"))
    else:
        tri_t = torch.full((R,), float("inf"), device=org.device)
        tri_i = torch.full((R,), -1, dtype=torch.int32, device=org.device)

    sph_t, sph_i = _sph_candidates(scene, org, dir, time, t_min_vec)
    use_sph = sph_t < tri_t
    t = torch.where(use_sph, sph_t, tri_t)
    prim = torch.where(use_sph, T + sph_i, tri_i)
    prim = torch.where(torch.isfinite(t), prim, -1).to(torch.int32)
    return prim, t


def tri_brute(org4, dir4, w, t_min, _slices=None):
    """Closest triangle per ray -> (t [Rpad] f32 (3e38 = miss), idx [Rpad]
    int32 (-1 = miss)) for ``org4``/``dir4`` [Rpad, 4] and ``w`` [4, 4 Tpad].

    Launches the CUDA kernel on CUDA tensors (csrc/brute.cu), one C call
    (the slice kernel, and the merge where it splits), with the slice count
    of ``launch_shape`` (``_slices``, for tests and tools, forces it), and
    records the shape in ``LAST_LAUNCH``; runs ``tri_brute_plain`` on CPU
    tensors.

    Kernel note. Replaces ``_tri_kernel`` (pallas_intersect.py:53), which
    ran the two contractions on the MXU. Their depth is 4, so here they are
    four multiplies and three adds per column on the FP32 pipes, not tensor
    cores (the JAX module records the MXU form at ~3% use,
    pallas_find.py:7-10). Bound: the float32 operations the data needs,
    at most 64 a (ray, triangle) pair (two 4-deep products for each of the
    four column groups, the divide and the three edges), fewer where the
    plane or an edge rejects it (``tools/find_split.py``
    ``brute_scan_counts``); the weights are read once per block, from L2.
    The kernel issues instructions, not bytes: it reads a triangle as four
    broadcast 16-byte shared loads (the three edge groups only where a
    lane of the warp passes the range test), tests two rays a lane,
    splits the triangle axis when the rays are few, and keeps the stages
    coming through a bulk-copy ring (csrc/brute.cu). The contract is the
    function as the JAX tests run it on the CPU (float32 products); a TPU
    run of the same kernel may round the products on the MXU.
    """
    if not org4.is_cuda:
        return tri_brute_plain(org4, dir4, w, t_min)
    _check_brute_args(org4, dir4, w)
    Rpad = org4.shape[0]
    n_tiles = w.shape[1] // (4 * TRI_TILE)
    n_sms = torch.cuda.get_device_properties(org4.device).multi_processor_count
    nb, n_slices = launch_shape(Rpad, n_tiles, n_sms, _slices)
    pack = pack_weights(w)
    out_t = torch.empty(Rpad, dtype=torch.float32, device=org4.device)
    out_i = torch.empty(Rpad, dtype=torch.int32, device=org4.device)
    part_t, part_i = out_t, out_i
    if n_slices > 1:
        part_t = torch.empty((n_slices, Rpad), dtype=torch.float32,
                             device=org4.device)
        part_i = torch.empty((n_slices, Rpad), dtype=torch.int32,
                             device=org4.device)
    TRI_BRUTE.launch(
        org4.device,
        _cuda.ptr(org4), _cuda.ptr(dir4), _cuda.ptr(pack), n_tiles,
        n_slices, float(t_min), RAY_BLOCK, nb,
        _cuda.ptr(part_t), _cuda.ptr(part_i), _cuda.ptr(out_t),
        _cuda.ptr(out_i),
    )
    LAST_LAUNCH.update(rays=Rpad, slices=n_slices, blocks=nb * n_slices)
    return out_t, out_i


def tri_brute_plain(org4, dir4, w, t_min):
    """Plain PyTorch version of ``tri_brute``: the kernel's products in its
    order (``x w0 + y w1 + z w2 + w w3``, one operation at a time), its
    formulas, and its tie rule (the lowest index within a tile, a strictly
    smaller t across tiles). Rays go in chunks of ``_PLAIN_ROWS``."""
    Rpad = org4.shape[0]
    n_tiles = w.shape[1] // (4 * TRI_TILE)
    t_min = torch.tensor(t_min, dtype=torch.float32)
    out_t = torch.empty((Rpad,), device=org4.device)
    out_i = torch.empty((Rpad,), dtype=torch.int32, device=org4.device)
    for r0 in range(0, Rpad, _PLAIN_ROWS):
        o = [org4[r0:r0 + _PLAIN_ROWS, i:i + 1] for i in range(4)]
        d = [dir4[r0:r0 + _PLAIN_ROWS, i:i + 1] for i in range(4)]
        best_t = torch.full((o[0].shape[0],), _BIG, device=org4.device)
        best_i = torch.full_like(best_t, -1, dtype=torch.int32)
        for k in range(n_tiles):
            wk = w[:, k * 4 * TRI_TILE:(k + 1) * 4 * TRI_TILE]
            a = o[0] * wk[0] + o[1] * wk[1] + o[2] * wk[2] + o[3] * wk[3]
            b = d[0] * wk[0] + d[1] * wk[1] + d[2] * wk[2] + d[3] * wk[3]
            a_n, b_n = a[:, :TRI_TILE], b[:, :TRI_TILE]
            plane_ok = b_n <= -EPSILON
            t = -a_n / torch.where(plane_ok, b_n, 1.0)
            valid = plane_ok & (t >= t_min)
            for i in (1, 2, 3):
                cols = slice(i * TRI_TILE, (i + 1) * TRI_TILE)
                valid &= (a[:, cols] + t * b[:, cols]) >= 0.0
            t = torch.where(valid, t, _BIG)
            tile_t, tile_arg = torch.min(t, dim=1)
            better = tile_t < best_t
            best_t = torch.where(better, tile_t, best_t)
            best_i = torch.where(better, (k * TRI_TILE + tile_arg)
                                 .to(torch.int32), best_i)
        out_t[r0:r0 + _PLAIN_ROWS] = best_t
        out_i[r0:r0 + _PLAIN_ROWS] = torch.where(best_t < _BIG, best_i, -1)
    return out_t, out_i


def _check_brute_args(org4, dir4, w):
    """Validate what the brute kernel reads."""
    dev = org4.device
    for name, x in (("org4", org4), ("dir4", dir4), ("w", w)):
        if x.device != dev or x.dtype != torch.float32 \
                or not x.is_contiguous():
            raise ValueError(
                f"{name}: need a contiguous float32 tensor on {dev}, got "
                f"{x.dtype} on {x.device} (contiguous={x.is_contiguous()})")
    Rpad = org4.shape[0]
    if org4.shape != (Rpad, 4) or dir4.shape != (Rpad, 4) \
            or Rpad % RAY_BLOCK:
        raise ValueError(f"org4/dir4 must be [nb * {RAY_BLOCK}, 4], got "
                         f"{tuple(org4.shape)}, {tuple(dir4.shape)}")
    if w.ndim != 2 or w.shape[0] != 4 or w.shape[1] % (4 * TRI_TILE):
        raise ValueError(f"w must be [4, 4 * {TRI_TILE} * n_tiles], got "
                         f"{tuple(w.shape)}")


# --- the range test: which lanes the exact test might take ------------------


def far_bound(best_t):
    """The far side of the range test: ``best_t`` two ulps up where it is
    at least 2^-100, else +inf (no far rejection)."""
    up = (best_t.view(torch.int32) + 2).view(torch.float32)
    return torch.where(best_t >= _RANGE_TINY, up, float("inf"))


def near_bound(t_min):
    """The near side of the range test: ``t_min`` three ulps down where it
    is at least 2^-100, else NaN (no near rejection)."""
    t_min = torch.as_tensor(t_min, dtype=torch.float32)
    down = (t_min.view(torch.int32) - 3).view(torch.float32)
    return torch.where(t_min >= _RANGE_TINY, down, float("nan"))


def range_maybe_plain(a_n, b_n, best_t, t_min):
    """Plain version of the kernel's range test: False where the exact
    test cannot take the triangle (``valid and t < best_t`` is false),
    with no divide.

    With ``B = -b_n``, the exact test's ``t = fl(a_n / B)``. A lane passes
    when ``plane_ok``, ``a_n < fl(far_bound(best_t) B)`` and not ``a_n <=
    fl(near_bound(t_min) B)``. Why a lane that fails cannot be taken
    (u = 2^-24, float32 rounding to nearest, IEEE products and divide):

    * far: for ``best_t >= 2^-100``, ``hi = best_t + 2 ulps >= best_t (1 +
      2^-23)``, and ``hi B >= 2^-123`` is normal (``B >= EPSILON = 2^-23``),
      so ``fl(hi B) >= hi B (1 - u) > best_t B``. Then ``a_n >= fl(hi B)``
      gives ``a_n / B >= best_t`` and, rounding being monotone, ``t >=
      best_t``: not strictly nearer. If ``fl(hi B)`` overflows, or ``hi``
      is +inf, only ``a_n = +inf`` fails, whose t is +inf or NaN.
    * near: for ``t_min >= 2^-100``, ``lo = t_min - 3 ulps``, two ulps of
      ``lo`` below the float before ``t_min``, ``p``; so ``fl(lo B) <= lo
      B (1 + u) <= p B``, and ``a_n <= fl(lo B)`` gives ``t <= p < t_min``.
      If ``fl(lo B)`` overflows, every finite ``a_n`` lies below ``lo B``
      (so ``t <= lo``) and ``a_n = +inf`` has t = +inf, never below a best
      t. ``lo`` is NaN (no lane fails) where ``t_min`` is smaller or NaN.
    * ``plane_ok`` false, or ``a_n`` NaN: the exact test rejects.

    ``best_t`` must be finite and at most 3e38, as the kernel's bests are.
    """
    B = -b_n
    plane_ok = b_n <= -EPSILON
    return plane_ok & (a_n < far_bound(best_t) * B) \
        & ~(a_n <= near_bound(t_min) * B)


# --- the split of the triangle axis and the merge ----------------------------


def slice_tiles(n_tiles, slices):
    """Tile ranges [k0, k1) of the ``slices`` runs of the triangle axis,
    as the kernel cuts them: slice s starts at tile s n_tiles // slices."""
    if not 1 <= slices <= n_tiles:
        raise ValueError(f"slices must be in [1, {n_tiles}], got {slices}")
    return [(s * n_tiles // slices, (s + 1) * n_tiles // slices)
            for s in range(slices)]


def merge_plain(part_t, part_i):
    """Plain version of the merge: the partial ``(t, id)`` of each slice
    [S, Rpad], in slice order, with the scan's strict ``<`` -> (t, idx).
    The slices run in index order, so this is the whole scan's result: the
    smallest t, on an equal t the lowest id."""
    best_t, best_i = part_t[0], part_i[0]
    for s in range(1, part_t.shape[0]):
        better = part_t[s] < best_t
        best_t = torch.where(better, part_t[s], best_t)
        best_i = torch.where(better, part_i[s], best_i)
    return best_t, best_i


def tri_brute_split_plain(org4, dir4, w, t_min, slices):
    """Plain version of the split search: ``tri_brute_plain`` on each
    slice's tiles, ids made global, then ``merge_plain``."""
    TW = 4 * TRI_TILE
    parts = []
    for k0, k1 in slice_tiles(w.shape[1] // TW, slices):
        t, i = tri_brute_plain(org4, dir4, w[:, k0 * TW:k1 * TW].contiguous(),
                               t_min)
        parts.append((t, torch.where(i >= 0, i + k0 * TRI_TILE, i)))
    return merge_plain(torch.stack([t for t, _ in parts]),
                       torch.stack([i for _, i in parts]))
