"""Kernel 6 (``csrc/fused.cu`` ``shade_bwd_kernel``) against its
roofline over the traced steps: the least time for the work of its
launches (``roofline/shade_bwd.py``, bound by bytes) over their device
time."""

from benchmark.roofline import peaks, shade_bwd

KERNEL = "shade_bwd_kernel"


def read(ctx):
    times = [d for n, _, d in ctx.device_events if KERNEL in n]
    if not times:
        return None
    least = len(times) * peaks.least_seconds(
        shade_bwd.bytes_per_launch(ctx.shapes["rays_per_launch"]))
    return 100.0 * least / (sum(times) / 1e6)
