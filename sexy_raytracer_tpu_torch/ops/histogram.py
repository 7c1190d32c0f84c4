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
"""

from __future__ import annotations

import torch

from sexy_raytracer_tpu_torch.ops import _cuda

HISTOGRAM = _cuda.Kernel(
    "srt_histogram", source="sexy_raytracer_tpu_torch/csrc/histogram.cu",
    replaces="sexy_raytracer_tpu/ops/histogram.py:122 (_direct_kernel)",
)


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
