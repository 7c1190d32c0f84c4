"""Dense weighted histogram: the scatter-free backward of the large row
gathers (counterpart of ``sexy_raytracer_tpu/ops/histogram.py:96-267``).

    dense_histogram(idx, vals, n_bins)[i, c] = sum_{r: idx[r] == i} vals[r, c]

Out-of-range ids and rows whose values are all zero are dropped (the JAX
contract, histogram.py:96-105,187-188). ``dense_histogram`` replaces the
TPU's ``_direct_kernel`` (histogram.py:122): on CUDA tensors it makes one
call into ``csrc/histogram.cu``, whose three passes need no torch glue; on
CPU tensors it runs ``dense_histogram_plain``.

Both sum in the order of ``plan``, which depends on the shapes alone: a
bin's entries within each chunk of ``CHUNK`` entries in ascending entry
order, those chunk partials in ascending chunk order within each slice of
``per_slice`` chunks, then the slices in ascending order, every fold
starting from +0. The JAX kernel sums chunk by chunk too. So the result is
deterministic and the kernel and its plain version agree bit for bit; see
the kernel's note in the source for the passes and their bound.

``dense_histogram_sorted`` is the sort + cumsum + segment-sum histogram
(``histogram.py:108,270-346``), which the JAX package keeps for A/B
comparison: ``sorted_segments`` (torch glue, both devices) and ``place``,
which launches the placement kernel that replaces ``_place_kernel``
(``histogram.py:59``) on CUDA tensors and runs ``place_plain`` on CPU
tensors. Unlike ``dense_histogram`` it keeps all-zero rows, and a bin's
sum is a difference of two float32 prefix sums, so its rounding error
scales with the largest prefix sum, not with the bin.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sexy_raytracer_tpu_torch.ops import _cuda

HISTOGRAM = _cuda.Kernel(
    "srt_histogram", "piipiiiiiiiipp",
    source="sexy_raytracer_tpu_torch/csrc/histogram.cu",
    replaces="sexy_raytracer_tpu/ops/histogram.py:122 (_direct_kernel)",
)
PLACE = _cuda.Kernel(
    "srt_place", "pppiip",
    source="sexy_raytracer_tpu_torch/csrc/histogram.cu",
    replaces="sexy_raytracer_tpu/ops/histogram.py:59 (_place_kernel)",
)

WIN = 2048  # output bins per placement window (histogram.py:46)

# the dense histogram's plan (csrc/histogram.cu has the same CHUNK and
# ACC_BYTES): entries per chunk; the widest combine window, and the shared
# accumulator of one window, which narrows it for wide rows; combine blocks
# that fill the card (two per SM of an H100's 132); the cap on the slice
# sums' scratch
CHUNK = 1024
WINDOW_MAX = 2048
ACC_BYTES = 64 * 1024
MIN_BLOCKS = 264
SCRATCH_BYTES = 16 << 20


class Plan(NamedTuple):
    n_chunks: int   # ceil(R / CHUNK)
    win: int        # bins per combine window
    n_windows: int  # ceil(n_bins / win)
    slices: int     # slices of the chunk range, summed last
    per_slice: int  # chunks per slice (the last may hold fewer)


def plan(R: int, n_bins: int, C: int) -> Plan:
    """The summation plan of an ``[R]``-entry histogram into ``[n_bins, C]``.

    A window is ``WINDOW_MAX`` bins, halved while its accumulator
    (``win * C`` floats) exceeds ``ACC_BYTES``. The chunks are split into
    slices when there are fewer windows than ``MIN_BLOCKS``, so that
    ``n_windows * slices`` blocks fill the card, with at most one slice per
    chunk and ``slices * n_bins * C`` floats within ``SCRATCH_BYTES``.
    Shapes alone decide it, never the device, so the card and the plain
    version sum in one order.
    """
    n_chunks = -(-R // CHUNK)
    win = WINDOW_MAX
    while win > 1 and win * C * 4 > ACC_BYTES:
        win //= 2
    if win * C * 4 > ACC_BYTES:
        raise ValueError(f"dense_histogram: a row of {C} channels does not "
                         f"fit the {ACC_BYTES}-byte window accumulator")
    n_windows = -(-n_bins // win)
    slices = max(1, min(n_chunks, -(-MIN_BLOCKS // max(n_windows, 1)),
                        SCRATCH_BYTES // max(n_bins * C * 4, 1)))
    per_slice = max(1, -(-n_chunks // slices))
    slices = max(1, -(-n_chunks // per_slice))
    return Plan(n_chunks, win, n_windows, slices, per_slice)


def scratch_words(p: Plan, n_bins: int, C: int) -> int:
    """Float32 words of the kernel's scratch: the chunk partials and their
    bins, the window directory (each chunk's first run in each window, as
    the JAX kernel's worklist has a row per window), and with more than one
    slice the slice sums."""
    sums = p.slices * n_bins * C if p.slices > 1 else 0
    return p.n_chunks * (CHUNK * (C + 1) + p.n_windows + 1) + sums


def dense_histogram(idx, vals, n_bins: int):
    """[R] int32 or int64 ids, [R, C] float32 values -> [n_bins, C] float32
    sums; one launch of the kernel on CUDA tensors."""
    if not vals.is_cuda:
        return dense_histogram_plain(idx, vals, n_bins)
    if vals.dim() != 2 or vals.dtype != torch.float32 \
            or idx.dtype not in (torch.int32, torch.int64) \
            or idx.shape != vals.shape[:1] or idx.device != vals.device \
            or not 0 <= n_bins < 2 ** 31 or vals.shape[0] >= 2 ** 31:
        raise ValueError(f"dense_histogram: need [R] int32 or int64 ids and "
                         f"[R, C] float32 values on one device, R and n_bins "
                         f"below 2^31, got {tuple(idx.shape)} {idx.dtype} "
                         f"{idx.device}, {tuple(vals.shape)} {vals.dtype} "
                         f"{vals.device} and n_bins {n_bins}")
    R, C = vals.shape
    # the kernel reads both through their strides (a backward's cotangent
    # is often a view), as C ints
    if max(idx.stride() + vals.stride(), default=0) >= 2 ** 31:
        idx, vals = idx.contiguous(), vals.contiguous()
    p = plan(R, n_bins, C)
    out = torch.empty((n_bins, C), dtype=torch.float32, device=vals.device)
    scratch = torch.empty(scratch_words(p, n_bins, C), dtype=torch.float32,
                          device=vals.device)
    HISTOGRAM.launch(vals.device, _cuda.ptr(idx),
                     int(idx.dtype == torch.int64), idx.stride(0),
                     _cuda.ptr(vals), *vals.stride(), R, n_bins, C, p.win,
                     p.slices, p.per_slice, _cuda.ptr(scratch),
                     _cuda.ptr(out))
    return out


def _ordered_sums(key, vals):
    """Sum the rows of ``vals`` that share a key, each group in the order
    its rows come, one float32 add at a time from +0, vectorised over the
    groups (step j adds every group's j-th row) -> (the groups' keys,
    ascending; their [G, C] sums)."""
    key, order = torch.sort(key, stable=True)
    vals = vals[order]
    n = key.shape[0]
    head = torch.ones(n, dtype=torch.bool, device=key.device)
    head[1:] = key[1:] != key[:-1]
    starts = head.nonzero().squeeze(1)
    counts = torch.diff(starts, append=starts.new_full((1,), n))
    sums = torch.zeros((starts.shape[0], vals.shape[1]), dtype=torch.float32,
                       device=vals.device)
    for j in range(int(counts.max()) if n else 0):
        g = (counts > j).nonzero().squeeze(1)
        sums[g] = sums[g] + vals[starts[g] + j]
    return key[starts], sums


def dense_histogram_plain(idx, vals, n_bins: int):
    """Plain version of ``dense_histogram``: the plan's three folds (a
    chunk's entries, a slice's chunks, the slices) in torch."""
    vals = vals.to(torch.float32)
    R, C = vals.shape
    out = torch.zeros((n_bins, C), dtype=torch.float32, device=vals.device)
    if n_bins == 0:
        return out
    p = plan(R, n_bins, C)
    idx = idx.to(torch.int64)
    keep = (idx >= 0) & (idx < n_bins) & (vals != 0.0).any(dim=1)
    r = keep.nonzero().squeeze(1)
    # each chunk's bins, in ascending entry order
    key, part = _ordered_sums(r // CHUNK * n_bins + idx[r], vals[r])
    # each slice's chunks, ascending: key is (chunk, bin), ascending
    key, sums = _ordered_sums(key // n_bins // p.per_slice * n_bins
                              + key % n_bins, part)
    # the slices, ascending: key is (slice, bin), ascending
    bins, total = _ordered_sums(key % n_bins, sums)
    out[bins] = total
    return out


def sorted_segments(idx, vals, n_bins: int):
    """The sort-based histogram's glue (``histogram.py:282-313``), in torch
    on either device -> ``(tex_u [K] int32, seg [K, C] float32,
    win_starts [NW + 1] int32)``.

    Out-of-range ids go to a sentinel that sorts last and is never placed;
    the entries are stable-sorted by id and their values summed in a
    float32 cumsum; ``tex_u`` holds each unique in-range id once, ``seg``
    its segment sum (the cumsum at the segment's end less the previous
    segment's), and ``win_starts[w]`` the first entry of ``tex_u`` at or
    past bin ``w * WIN``, for the ``NW = ceil(n_bins / WIN)`` windows.
    """
    idx = idx.to(torch.int64)
    key = torch.where((idx >= 0) & (idx < n_bins), idx, n_bins)
    sorted_key, perm = torch.sort(key, stable=True)
    sorted_vals = vals.to(torch.float32)[perm]
    # one 1-D scan per channel: torch scans a non-innermost dimension of a
    # CUDA tensor with one thread per column, serially along the rows
    S = torch.stack([torch.cumsum(sorted_vals[:, c].contiguous(), dim=0)
                     for c in range(vals.shape[1])], dim=1) \
        if vals.shape[1] else sorted_vals
    end = torch.ones_like(sorted_key, dtype=torch.bool)
    end[:-1] = sorted_key[1:] != sorted_key[:-1]
    end &= sorted_key < n_bins
    tex_u = sorted_key[end]
    S_u = S[end]
    seg = S_u - torch.cat([S_u.new_zeros((1, S_u.shape[1])), S_u[:-1]])
    n_windows = -(-n_bins // WIN)
    bounds = torch.arange(n_windows + 1, dtype=torch.int64,
                          device=idx.device) * WIN
    win_starts = torch.searchsorted(tex_u, bounds)
    return (tex_u.to(torch.int32), seg.contiguous(),
            win_starts.to(torch.int32))


def place(tex_u, seg, win_starts, n_bins: int):
    """``out[tex_u[e]] = seg[e]`` into ``[n_bins, C]`` zeros: launches the
    placement kernel on CUDA tensors, runs ``place_plain`` on CPU ones.
    ``tex_u`` must be sorted, unique and in range, as ``sorted_segments``
    gives it."""
    if not seg.is_cuda:
        return place_plain(tex_u, seg, win_starts, n_bins)
    K, C = seg.shape
    n_windows = -(-n_bins // WIN)
    if seg.dtype != torch.float32 or tex_u.dtype != torch.int32 \
            or win_starts.dtype != torch.int32 or tex_u.shape != (K,) \
            or win_starts.shape != (n_windows + 1,) \
            or not (tex_u.is_cuda and win_starts.is_cuda):
        raise ValueError(
            f"place: need int32 tex_u [K], float32 seg [K, C] and int32 "
            f"win_starts [{n_windows + 1}] on one CUDA device, got "
            f"{tuple(tex_u.shape)} {tex_u.dtype} {tex_u.device}, "
            f"{tuple(seg.shape)} {seg.dtype}, {tuple(win_starts.shape)} "
            f"{win_starts.dtype} {win_starts.device}")
    tex_u, seg, win_starts = (t.contiguous() for t in (tex_u, seg, win_starts))
    out = torch.empty((n_bins, C), dtype=torch.float32, device=seg.device)
    if n_windows and C:
        PLACE.launch(seg.device, _cuda.ptr(tex_u), _cuda.ptr(seg),
                     _cuda.ptr(win_starts), n_bins, C, _cuda.ptr(out))
    return out


def place_plain(tex_u, seg, win_starts, n_bins: int):
    """Plain version of ``place``: zeros and one ``index_copy_``
    (``win_starts`` is unused; the kernel's windows need it)."""
    out = torch.zeros((n_bins, seg.shape[1]), dtype=torch.float32,
                      device=seg.device)
    return out.index_copy_(0, tex_u.long(), seg)


def dense_histogram_sorted(idx, vals, n_bins: int):
    """[R] int ids, [R, C] values -> [n_bins, C] float32 sums, by sort and
    cumsum (``histogram.py:108``): ``sorted_segments`` then ``place``."""
    if vals.is_cuda and (idx.shape != vals.shape[:1]
                         or idx.device != vals.device):
        raise ValueError(f"dense_histogram_sorted: need [R] ids and [R, C] "
                         f"values on one device, got {tuple(idx.shape)} "
                         f"{idx.device} and {tuple(vals.shape)} {vals.device}")
    return place(*sorted_segments(idx, vals, n_bins), n_bins)


def dense_histogram_sorted_plain(idx, vals, n_bins: int):
    """Plain version of ``dense_histogram_sorted``: the same glue, then
    ``place_plain``."""
    return place_plain(*sorted_segments(idx, vals, n_bins), n_bins)
