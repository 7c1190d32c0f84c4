"""Arithmetic on what a run records: percentiles of step intervals, and a
profiler trace reduced to device busy time, idle gaps, the share of
PyTorch's own kernels and the operations that took most time; and the
readers that several per-layer metrics share (``metrics/<name>.py``
imports its ``read`` from here).

The event arithmetic follows the program's ``tools/devtime.py`` (device
events by name, CUPTI's kernel names for the port's own kernels), copied
here and frozen so that the yardstick does not move with the program.
Times are microseconds as the profiler gives them.
"""

from __future__ import annotations

import bisect
import math
from collections import defaultdict


def percentile(values, q):
    """The nearest-rank ``q``-th percentile (0 < q <= 100): the smallest
    value with at least ``q`` percent of the values at or below it."""
    if not values:
        raise ValueError("no values")
    s = sorted(values)
    return s[max(0, math.ceil(q / 100.0 * len(s)) - 1)]


def merge(intervals):
    """Sorted disjoint union of ``(start, end)`` intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy_us(device_events):
    """Microseconds in which at least one device operation ran."""
    return sum(b - a for a, b in merge(
        (s, s + d) for _, s, d in device_events))


def idle_gaps(device_events, start, end):
    """The stretches of ``[start, end]`` with nothing on the device, as
    ``(start, end)`` pairs."""
    gaps, t = [], start
    for a, b in merge((s, s + d) for _, s, d in device_events):
        if a > t:
            gaps.append((t, min(a, end)))
        t = max(t, b)
    if t < end:
        gaps.append((t, end))
    return [(a, b) for a, b in gaps if b > a]


# PyTorch's own device work: ATen's kernels (at::native, at::cuda and the
# cub passes it instantiates), the cuBLAS and CUTLASS matrix products a
# torch.matmul starts, and copies and fills
_ATEN_MARKS = ("at::", "at_cuda_detail", "gemm", "cutlass", "cublas",
               "splitKreduce", "Memcpy", "Memset")


def is_aten(name: str) -> bool:
    return any(m in name for m in _ATEN_MARKS)


def aten_share(device_events):
    """Device time of PyTorch's own operations over all device time."""
    total = sum(d for _, _, d in device_events)
    if total <= 0:
        return None
    return sum(d for n, _, d in device_events if is_aten(n)) / total


def top_ops(device_events, n=10):
    """``[[name, seconds], ...]``: the device operations by total time."""
    by = defaultdict(float)
    for name, _, d in device_events:
        by[name] += d
    top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
    return [[name[:120], us / 1e6] for name, us in top]


def gaps_by_host(device_events, host_events, start, end, n=10):
    """``[[name, seconds], ...]``: the device's idle time grouped by the
    innermost host event running where each gap starts (on the card the
    CUDA runtime's calls, such as a launch or a synchronisation), "host"
    where none is: Python and PyTorch's host work between calls."""
    host = sorted(host_events, key=lambda e: e[1])
    starts = [e[1] for e in host]
    by = defaultdict(float)
    for a, b in idle_gaps(device_events, start, end):
        i = bisect.bisect_right(starts, a)
        name = "host"
        best = None
        for j in range(i - 1, max(-1, i - 400), -1):
            hn, hs, hd = host[j]
            if hs <= a < hs + hd and (best is None or hs > best):
                best, name = hs, hn
        by[name] += b - a
    top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
    return [[name[:120], us / 1e6] for name, us in top]


# -- readers shared by the files of ``metrics/`` (each ``read(ctx)``: the
# metric, or None where the run has nothing to read). The manifest's
# ``workloads`` of each metric chooses the cells that report it.

def idle_pct(ctx):
    """The traced stretch's wall time with no kernel, copy or fill on the
    card, in percent. Unclipped: busy time over the wall time is a fault
    of the count, and the harness refuses the run before this is read."""
    if not ctx.busy_s or not ctx.window_s:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)


def aten_share_pct(ctx):
    """PyTorch's own device work over all device time, in percent."""
    share = aten_share(ctx.device_events) if ctx.device_events else None
    return None if share is None else 100.0 * share


def launches_per_unit(ctx):
    """The port's kernel launches in the window over its frames or steps."""
    if not ctx.window_units:
        return None
    return ctx.launches / ctx.window_units
