"""Profiling helpers: a throughput meter, trace capture, and the spans
and counters of the entry layers (counterpart of ``utils/profiling.py``).

``Meter`` accumulates paths, rays and seconds over render or train steps
and reports them as one JSON line with the JAX package's keys. A step's
time counts only once the device is done: ``sync`` waits for the device
of the step's result. ``trace`` wraps a region in ``torch.profiler`` and
writes a Chrome trace (open it in Perfetto or chrome://tracing) and, beside
it, the span log.

Spans and counters record exactly while a torch profiler is recording
(``torch.autograd._profiler_enabled()``); otherwise each call costs that
one check and returns a shared no-op. A new log starts with ``trace``,
and with the first call of a recording that follows a call that found no
profiler. ``span(name)`` opens ``record_function(name)``, so the
span lies on the profiler's timeline (where the profiler records the
host's activity; one that records only the device's shows no span), and
logs ``(name, parent, start ns, end ns)`` on the same Unix clock (the
parent is the innermost open span of the thread, -1 at the top);
``device=True`` also records a CUDA event on the current stream at each
edge, resolved only when read. ``wait(site)`` is the span ``wait.<site>``
around a statement at which the host blocks on the device, and counts
the site. ``tally(name, slots, fn, *args)`` adds ``fn(*args)``, a count
left on its device, and ``slots`` to a counter. ``snapshot`` reads the
log of the newest recording.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import threading
import time
from dataclasses import dataclass
from pathlib import Path

import torch
from torch.autograd import _profiler_enabled

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


# -- spans and counters -------------------------------------------------------

# The log is the process's, like the profiler it follows: spans take no
# argument to carry it. Each record: [name, parent, start ns, end ns,
# start event, end event]; ``_lock`` guards the log and the counts, the
# stack of open spans is per thread.
_log: list = []
_waits: collections.Counter = collections.Counter()
_tallies: dict = {}
_lock = threading.Lock()
_thread = threading.local()
_recording = False


def _stack() -> list:
    stack = getattr(_thread, "stack", None)
    if stack is None:
        stack = _thread.stack = []
    return stack


def _new_log() -> None:
    global _recording, _log
    _recording = True
    _log = []
    _waits.clear()
    _tallies.clear()
    _stack().clear()


def _on() -> bool:
    """True while a profiler records; a new recording starts a new log."""
    global _recording
    if not _profiler_enabled():
        _recording = False
        return False
    if not _recording:
        _new_log()
    return True


class _Span:
    __slots__ = ("name", "device", "rec", "index", "label")

    def __init__(self, name: str, device: bool):
        self.name, self.device = name, device

    def __enter__(self):
        stack = _stack()
        self.rec = [self.name, stack[-1] if stack else -1, time.time_ns(),
                    None, None, None]
        with _lock:
            self.index = len(_log)
            _log.append(self.rec)
        stack.append(self.index)
        self.label = torch.profiler.record_function(self.name)
        self.label.__enter__()
        if self.device:
            self.rec[4] = torch.cuda.Event(enable_timing=True)
            self.rec[4].record()
        return self

    def __exit__(self, *exc):
        if self.device:
            self.rec[5] = torch.cuda.Event(enable_timing=True)
            self.rec[5].record()
        self.label.__exit__(*exc)
        self.rec[3] = time.time_ns()
        stack = _stack()
        if stack and stack[-1] == self.index:
            stack.pop()
        return False


_OFF = contextlib.nullcontext()


def span(name: str, device: bool = False):
    """A context manager: the span ``name`` while tracing, else a no-op.
    ``device``: also time the span on the current CUDA stream."""
    return _Span(name, device) if _on() else _OFF


def wait(site: str):
    """The span ``wait.<site>`` around a statement at which the host
    blocks on the device, counted by site, while tracing."""
    if not _on():
        return _OFF
    with _lock:
        _waits[site] += 1
    return _Span("wait." + site, False)


def tally(name: str, slots: int, fn, *args) -> None:
    """While tracing, add ``fn(*args)`` (a count, left on its device until
    read) and ``slots`` to the counter ``name``; else nothing is called."""
    if not _on():
        return
    count = fn(*args)
    with _lock:
        counts, total = _tallies.get(name, ([], 0))
        counts.append(count)
        _tallies[name] = (counts, total + slots)


def snapshot() -> dict:
    """The newest recording's log as plain data: ``spans``, one ``[name,
    parent, start ns, end ns, self ns, device ms]`` a span in opening
    order (self: the duration less the time its closed children cover;
    device: event to event; None where open or without events);
    ``waits``, the counts by site; ``tallies``, each counter's ``[total,
    slots]``. Reading waits for the spans' end events and the counts."""
    own = [None if r[3] is None else r[3] - r[2] for r in _log]
    for r in _log:
        if r[1] >= 0 and r[3] is not None and own[r[1]] is not None:
            own[r[1]] -= r[3] - r[2]
    rows = []
    for r, o in zip(_log, own):
        ms = None
        if r[4] is not None and r[5] is not None:
            r[5].synchronize()
            ms = r[4].elapsed_time(r[5])
        rows.append([r[0], r[1], r[2], r[3], o, ms])
    return {
        "spans": rows,
        "waits": dict(_waits),
        "tallies": {k: [sum(int(c) for c in counts), slots]
                    for k, (counts, slots) in _tallies.items()},
    }


@contextlib.contextmanager
def trace(log_dir: str | os.PathLike = TRACE_DIR):
    """Profile the wrapped region with ``torch.profiler`` (CPU, and CUDA
    where a card is present) and write its Chrome trace and its span log
    (``snapshot``, JSON) into ``log_dir``. Yields the profiler; its
    ``trace_path`` and ``spans_path`` are set on exit."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        # a log of its own, also straight after another recording
        _new_log()
        yield prof
    stem = os.path.join(log_dir, f"trace-{os.getpid()}-{time.time_ns()}")
    prof.trace_path = stem + ".json"
    prof.export_chrome_trace(prof.trace_path)
    prof.spans_path = stem + ".spans.json"
    with open(prof.spans_path, "w") as f:
        json.dump(snapshot(), f)
