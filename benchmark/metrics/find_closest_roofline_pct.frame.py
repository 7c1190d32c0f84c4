"""Kernel 1 (``csrc/find.cu`` ``find_closest_kernel``) against its
roofline over the traced frames: the least time for the work of its
launches (``roofline/find_closest.py``, bound by bytes) over their
device time. A launch's rays are the frame's real rays over its chunks
(``shapes["rays_per_launch"]``): the pad of a short last chunk is no
work."""

from benchmark.roofline import find_closest, peaks

KERNEL = "find_closest_kernel"


def read(ctx):
    times = [d for n, _, d in ctx.device_events if KERNEL in n]
    if not times:
        return None
    s = ctx.shapes
    least = len(times) * peaks.least_seconds(find_closest.bytes_per_launch(
        s["rays_per_launch"], s["triangles"], s["spheres"]))
    return 100.0 * least / (sum(times) / 1e6)
