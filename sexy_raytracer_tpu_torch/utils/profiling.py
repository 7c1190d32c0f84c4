"""Profiling helpers: a throughput meter and trace capture (counterpart of
``utils/profiling.py``).

``Meter`` accumulates paths, rays and seconds over render or train steps
and reports them as one JSON line with the JAX package's keys. A step's
time counts only once the device is done: ``sync`` waits for the device
of the step's result. ``trace`` wraps a region in ``torch.profiler`` and
writes a Chrome trace (open it in Perfetto or chrome://tracing).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass
from pathlib import Path

import torch

# the default trace directory, under the checkout's build/
TRACE_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_trace"


def _first_tensor(value):
    """The first tensor leaf of nested dicts (in sorted key order, as
    ``jax.tree.leaves``), lists and tuples; None if there is none."""
    if torch.is_tensor(value):
        return value
    if isinstance(value, dict):
        items = [value[k] for k in sorted(value)]
    elif isinstance(value, (list, tuple)):
        items = value
    else:
        return None
    for item in items:
        leaf = _first_tensor(item)
        if leaf is not None:
            return leaf
    return None


def sync(value=None) -> None:
    """Wait until the device of ``value``'s first tensor leaf is done;
    ``None`` and CPU tensors return at once."""
    leaf = _first_tensor(value)
    if leaf is not None and leaf.is_cuda:
        torch.cuda.synchronize(leaf.device)


@dataclass
class Meter:
    """Accumulating throughput meter for render and train loops.

    >>> m = Meter("render")
    >>> with m.step(paths=131072, bounces=4) as s: s.value = fn()
    >>> print(m.report())
    """

    name: str
    paths: int = 0
    rays: int = 0
    seconds: float = 0.0
    steps: int = 0

    @contextlib.contextmanager
    def step(self, paths: int, bounces: int = 1):
        class _S:
            value = None

        s = _S()
        t0 = time.perf_counter()
        yield s
        sync(s.value)
        self.seconds += time.perf_counter() - t0
        self.paths += paths
        self.rays += paths * bounces
        self.steps += 1

    @property
    def mrays_per_s(self) -> float:
        return self.rays / max(self.seconds, 1e-9) / 1e6

    @property
    def mpaths_per_s(self) -> float:
        return self.paths / max(self.seconds, 1e-9) / 1e6

    def report(self) -> str:
        return json.dumps(
            {
                "meter": self.name,
                "steps": self.steps,
                "seconds": round(self.seconds, 3),
                "mpaths_per_s": round(self.mpaths_per_s, 3),
                "mrays_per_s": round(self.mrays_per_s, 3),
            }
        )


@contextlib.contextmanager
def trace(log_dir: str | os.PathLike = TRACE_DIR):
    """Profile the wrapped region with ``torch.profiler`` (CPU, and CUDA
    where a card is present) and write its Chrome trace into ``log_dir``.
    Yields the profiler; its ``trace_path`` is set on exit."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.trace_path = os.path.join(
        log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json")
    prof.export_chrome_trace(prof.trace_path)
