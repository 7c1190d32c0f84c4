"""Dense weighted histogram: the scatter-free backward of the large row
gathers (counterpart of ``sexy_raytracer_tpu/ops/histogram.py:96-267``).

    dense_histogram(idx, vals, n_bins)[i, c] = sum_{r: idx[r] == i} vals[r, c]

Out-of-range ids and rows whose values are all zero are dropped (the JAX
contract, histogram.py:96-105,187-188). ``dense_histogram`` replaces the
TPU's ``_direct_kernel`` (histogram.py:122): on CUDA tensors it launches
the kernel of ``csrc/histogram.cu``, on CPU tensors it runs
``dense_histogram_plain``.

Both sum each bin's entries in ascending entry order, one add at a time,
so the result is deterministic and the two agree bit for bit. The glue
shared by both (``_segments``) stable-sorts the kept entries by bin, as
the JAX prologue orders its chunk worklists; see the kernel's note in the
source for its design and bound.

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

import torch

from sexy_raytracer_tpu_torch.ops import _cuda

HISTOGRAM = _cuda.Kernel(
    "srt_histogram", source="sexy_raytracer_tpu_torch/csrc/histogram.cu",
    replaces="sexy_raytracer_tpu/ops/histogram.py:122 (_direct_kernel)",
)
PLACE = _cuda.Kernel(
    "srt_place", source="sexy_raytracer_tpu_torch/csrc/histogram.cu",
    replaces="sexy_raytracer_tpu/ops/histogram.py:59 (_place_kernel)",
)

WIN = 2048  # output bins per placement window (histogram.py:46)


def _segments(idx, vals, n_bins):
    """(order [K] int32, starts [n_bins + 1] int32): the kept entries
    stable-sorted by bin, and bin i's slice ``order[starts[i]:starts[i+1]]``.
    """
    idx = idx.to(torch.int64)
    keep = (idx >= 0) & (idx < n_bins) & (vals != 0.0).any(dim=1)
    key = torch.where(keep, idx, n_bins)  # dropped entries sort last
    sorted_key, order = torch.sort(key, stable=True)
    bins = torch.arange(n_bins + 1, dtype=torch.int64, device=idx.device)
    starts = torch.searchsorted(sorted_key, bins)
    return order.to(torch.int32), starts.to(torch.int32)


def dense_histogram(idx, vals, n_bins: int):
    """[R] int ids, [R, C] float32 values -> [n_bins, C] float32 sums."""
    if not vals.is_cuda:
        return dense_histogram_plain(idx, vals, n_bins)
    R, C = vals.shape
    if vals.dtype != torch.float32 or idx.shape != (R,) \
            or idx.device != vals.device:
        raise ValueError(f"dense_histogram: need [R] ids and [R, C] float32 "
                         f"values on one device, got {tuple(idx.shape)} "
                         f"{idx.device} and {tuple(vals.shape)} {vals.dtype} "
                         f"{vals.device}")
    vals = vals.contiguous()
    order, starts = _segments(idx, vals, n_bins)
    out = torch.empty((n_bins, C), dtype=torch.float32, device=vals.device)
    HISTOGRAM.launch(vals.device, _cuda.ptr(starts), _cuda.ptr(order),
                     _cuda.ptr(vals), n_bins, C, _cuda.ptr(out))
    return out


def dense_histogram_plain(idx, vals, n_bins: int):
    """Plain version of ``dense_histogram``: the same segments, summed in
    the same order, vectorised over bins (step k adds every bin's k-th
    entry)."""
    vals = vals.to(torch.float32)
    order, starts = _segments(idx, vals, n_bins)
    order, starts = order.long(), starts.long()
    counts = starts[1:] - starts[:-1]
    out = torch.zeros((n_bins, vals.shape[1]), dtype=torch.float32,
                      device=vals.device)
    n_steps = int(counts.max()) if n_bins else 0
    for k in range(n_steps):
        bins = (counts > k).nonzero().squeeze(1)
        out[bins] = out[bins] + vals[order[starts[bins] + k]]
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
