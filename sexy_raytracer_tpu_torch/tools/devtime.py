"""Device time of a function from a ``torch.profiler`` run (counterpart of
``tools/tputime.py``).

``device_time`` and ``op_breakdown`` run ``fn`` over ``argsets`` under the
profiler and sum the recorded events by name: on the card, the device's
events (kernels, including the port's own, which CUPTI records under their
``__global__`` names, and copies and fills); where no device event was
recorded, as on CPU tensors, the CPU ops' self times.
"""

from __future__ import annotations

from collections import defaultdict

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from sexy_raytracer_tpu_torch.utils.profiling import sync

__all__ = ["device_time", "op_breakdown", "profile_events"]


def profile_events(fn, argsets, n):
    """Run ``fn(*argsets[i % len(argsets)])`` ``n`` times under the
    profiler, after one call outside it -> ``(kind, events)``: ``kind`` is
    "cuda" or "cpu", ``events`` a list of ``(track, name, microseconds)``
    with the stream (or the CPU thread) as the track."""
    sync(fn(*argsets[0]))
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        for i in range(n):
            out = fn(*argsets[i % len(argsets)])
        sync(out)
    events = prof.events()
    device = [(f"stream {e.device_resource_id}", e.name,
               e.time_range.elapsed_us())
              for e in events if e.device_type == DeviceType.CUDA]
    if device:
        return "cuda", device
    return "cpu", [(f"thread {e.thread}", e.name, e.self_cpu_time_total)
                   for e in events if e.device_type == DeviceType.CPU]


def _by_name(events):
    """{name: [total ms, count]}."""
    by_name = defaultdict(lambda: [0.0, 0])
    for _, name, us in events:
        by_name[name][0] += us / 1e3
        by_name[name][1] += 1
    return dict(by_name)


def device_time(label, fn, argsets, n=6, top=0):
    """Print and return the device ms per call (on the CPU: the ops' self
    time per call), with the ``top`` names that take most of it."""
    kind, events = profile_events(fn, argsets, n)
    by_name = _by_name(events)
    total = sum(ms for ms, _ in by_name.values()) / n
    print(f"{label:56s} {total:9.3f} ms/call ({kind})", flush=True)
    for name, (ms, count) in sorted(by_name.items(),
                                    key=lambda kv: -kv[1][0])[:top]:
        print(f"    {ms / n:9.3f} ms  x{count / n:<6g} {name[:100]}")
    return total


def op_breakdown(fn, argsets, n=3, top=30):
    """Print the ``top`` names by time per call -> {name: [ms, count]}
    totals over the ``n`` calls."""
    kind, events = profile_events(fn, argsets, n)
    by_name = _by_name(events)
    print(f"per call, {kind} events:", flush=True)
    for name, (ms, count) in sorted(by_name.items(),
                                    key=lambda kv: -kv[1][0])[:top]:
        print(f"{ms / n:9.3f} ms  x{count / n:<6g} {name[:110]}")
    return by_name
