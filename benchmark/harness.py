"""The benchmark harness: one run of one cell.

``python benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` reads ``BENCHMARK.json``, finds the cell's configuration
file, its traffic file (``traffic/<traffic>.json``, which names its loop
in ``loops/``) and its limits (``limits/<cell>.json``), builds the cell,
measures it for ``--seconds``, checks what the timed path produced against
the plain reference, and prints one JSON line as the last line of
standard output. With ``--trace 1`` it profiles a short steady stretch of
the window and prints the cell's per-layer metrics, each read by its own
file in ``metrics/``.

A run needs a CUDA device: without one it exits with code 2 and prints
no result. Nothing here imports JAX or the JAX package.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "sexy_raytracer_tpu")
PORT = "sexy_raytracer_tpu_torch"
# the prefix of the spans the loops put around each unit of work
LABEL = "bench."
# the device's busy time may pass the traced stretch's host-clock wall
# time by this share (the two clocks' rounding) before the run is refused
BUSY_SLACK = 0.01


class RunError(RuntimeError):
    """A run that cannot give a result."""


# -- the manifest and a cell's files -------------------------------------------

def load_manifest(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def find_cell(name: str, root: Path = ROOT) -> SimpleNamespace:
    """Everything one cell needs, found by the names in the manifest."""
    man = load_manifest(root)
    work = {w["name"]: w for w in man["workloads"]}
    if name not in work:
        raise RunError(f"no workload {name!r} in BENCHMARK.json")
    w = work[name]
    conf = {c["name"]: c for c in man["configs"]}[w["config"]]
    bench = root / man["paths"][0]
    traffic = _json(bench / "traffic" / f"{w['traffic']}.json")
    limits_path = bench / "limits" / f"{name}.json"
    limits = _json(limits_path) if limits_path.exists() else {}

    def applies(m):
        return "workloads" not in m or name in m["workloads"]

    e2e = [m for m in man["end_to_end"] if applies(m)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in man["per_layer"]
                 if applies(m) and m["moves"] in e2e_names]
    return SimpleNamespace(
        name=name, workload=w, config=_json(root / conf["file"]),
        traffic=traffic, limits=limits, end_to_end=e2e,
        per_layer=per_layer, bench=bench)


def loop_of(cell):
    return importlib.import_module(f"benchmark.loops.{cell.traffic["loop"]}")


def reader(metric: str, bench: Path = BENCH):
    """The function ``read(ctx)`` of ``metrics/<metric>.py``."""
    path = bench / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics." + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# -- the device ----------------------------------------------------------------

class Device:
    """The run's device: a CUDA card, or the CPU where a test drives the
    harness without one. Events and synchronisation are no-ops on the
    CPU, where the host clock stands in for the device's."""

    def __init__(self, torch, name: str):
        self.torch = torch
        self.name = name
        self.cuda = name.startswith("cuda")

    def sync(self):
        if self.cuda:
            self.torch.cuda.synchronize()

    def event(self):
        if self.cuda:
            ev = self.torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return _HostEvent()

    def upload(self, t):
        """``t`` on the device without waiting for it: from pinned memory,
        the copy queues behind the work before it (a copy from pageable
        memory waits for the device to drain)."""
        if self.cuda:
            return t.pin_memory().to(self.name, non_blocking=True)
        return t.to(self.name)

    def reset_peak(self):
        if self.cuda:
            self.torch.cuda.reset_peak_memory_stats()

    def peak_bytes(self) -> int:
        return int(self.torch.cuda.max_memory_allocated()) if self.cuda else 0


class _HostEvent:
    def __init__(self):
        self.t = time.perf_counter()

    def elapsed_time(self, other) -> float:
        return (other.t - self.t) * 1e3

    def synchronize(self):
        pass


# -- the traced stretch ----------------------------------------------------------

class NoTrace:
    """No trace: the window runs for its seconds alone."""
    active = False
    done = False

    def tick(self, units, elapsed):
        pass

    def close(self):
        pass


class Tracer:
    """Profiles ``units`` units of work once ``start_s`` seconds of the
    window have passed: device events and host operations, and the
    stretch's wall time between two synchronisations. The window goes on
    while it is active, so the stretch always has its units."""

    def __init__(self, dev: Device, start_s: float, units: int):
        self.dev, self.start_s, self.units = dev, start_s, units
        self.active = self.done = False
        self.prof = None
        self.first = self.last = self.n_units = 0
        self.wall = 0.0

    def tick(self, units, elapsed):
        """Called after each unit of the window: ``units`` done so far,
        ``elapsed`` seconds since the window opened."""
        self.last = units
        if not self.active and not self.done and elapsed >= self.start_s:
            from torch.profiler import ProfilerActivity, profile
            # on the card, the device's activity alone: kernels, copies,
            # fills and the CUDA runtime's calls on the host, without the
            # per-operator host hooks that would slow the host and widen
            # the gaps being measured
            self.prof = profile(activities=[
                ProfilerActivity.CUDA if self.dev.cuda
                else ProfilerActivity.CPU])
            self.dev.sync()
            self.prof.__enter__()
            self.t0 = time.perf_counter()
            self.first = units
            self.active = True
        elif self.active and units - self.first >= self.units:
            self.close()

    def close(self):
        if not self.active:
            return
        self.dev.sync()
        self.wall = time.perf_counter() - self.t0
        self.prof.__exit__(None, None, None)
        self.active, self.done = False, True
        self.n_units = self.last - self.first

    def events(self):
        """(device events, host events, start us, end us): each event
        ``(name, start us, duration us)``."""
        from torch.autograd import DeviceType
        dev, host = [], []
        for e in self.prof.events():
            item = (e.name, e.time_range.start, e.time_range.elapsed_us())
            if e.device_type == DeviceType.CUDA:
                # a record_function label is also put on the device's
                # timeline, over the work it spans: no operation of its own
                if not (getattr(e, "is_user_annotation", False)
                        or e.name.startswith(LABEL)):
                    dev.append(item)
            elif e.device_type == DeviceType.CPU:
                host.append(item)
        starts = [s for _, s, _ in host] or [0]
        ends = [s + d for _, s, d in host] or [0]
        return dev, host, min(starts), max(ends)


def make_tracer(dev, trace: int, traffic: dict, seconds: float):
    if not trace:
        return NoTrace()
    if dev.cuda:
        # the first profiler of a process starts CUPTI, which takes
        # seconds: do it here, not inside the window
        import torch
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]):
            torch.ones(1, device=dev.name).add_(1)
            dev.sync()
    start = min(float(traffic["trace_after_s"]), seconds / 3.0)
    return Tracer(dev, start, int(traffic["trace_units"]))


# -- one run ---------------------------------------------------------------------

def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def launch_counter():
    """(reset, read) over every port kernel's launch count."""
    from sexy_raytracer_tpu_torch.ops import _cuda

    def reset():
        for k in _cuda.KERNELS:
            k.launches = 0

    def read():
        return sum(k.launches for k in _cuda.KERNELS)

    return reset, read


def run_cell(cell, seed: int, seconds: float, trace: int, dev: Device,
             t_start: float, control: str | None = None, log=None) -> dict:
    """Set up, measure, check: the result line's fields."""
    import torch

    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    drv = loop_of(cell)
    state = drv.setup(cell, seed, dev, log)
    reset_launches, read_launches = launch_counter()
    setup_peak = dev.peak_bytes()
    dev.sync()
    setup_s = time.perf_counter() - t_start
    tracer = make_tracer(dev, trace, cell.traffic, seconds)
    dev.reset_peak()
    reset_launches()
    win = drv.window(state, seconds, tracer, dev)
    tracer.close()
    launches = read_launches()
    window_peak = dev.peak_bytes()
    log(f"card: {power_limit()}")
    log(f"window: {win.units} {win.unit}s in {win.wall:.4f} s")

    metrics, extra = {}, {}
    e2e = drv.end_to_end(win, setup_s, window_peak)
    for m in cell.end_to_end:
        if m["name"] in e2e:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    for line in getattr(win, "notes", []):
        log(line)
    if trace:
        metrics = {}
        ctx = trace_context(cell, tracer, win, launches, dev)
        for m in cell.per_layer:
            value = reader(m["name"], cell.bench)(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if tracer.done and dev.cuda:
            extra["busy_s"] = ctx.busy_s
            extra["window_s"] = ctx.window_s
            extra["breakdown"] = ctx.breakdown

    program = drv.release(state, win)
    del state
    if dev.cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    readings = drv.check(cell, seed, program, dev, log, control=control)
    log(f"check took {time.perf_counter() - t_check:.2f} s")
    # a reading with no limit, or a limit with no reading, is not correct
    checks = {k: {"value": v, "limit": cell.limits.get(k)}
              for k, v in readings.items()}
    correct = all(v["limit"] is not None and v["value"] <= v["limit"]
                  for v in checks.values()) \
        and set(checks) == set(cell.limits)
    for k, v in checks.items():
        log(f"check {k}: {v['value']!r} (limit {v['limit']!r})")
    device = {"platform": "gpu" if dev.cuda else "cpu",
              "kind": torch.cuda.get_device_name() if dev.cuda else "cpu",
              "count": 1,
              "memory_peak_bytes": max(setup_peak, window_peak)}
    for k in ("busy_s", "window_s"):
        if k in extra:
            device[k] = extra[k]
    out = {"correct": bool(correct), "attempted": win.units,
           "failed": win.failed, "metrics": metrics, "device": device}
    if "breakdown" in extra:
        out["breakdown"] = extra["breakdown"]
    out["checks"] = checks
    return out


def trace_context(cell, tracer, win, launches, dev):
    """What the per-layer readers read."""
    from benchmark import devtrace

    ctx = SimpleNamespace(
        kind=win.unit, cell=cell.name, traffic=cell.traffic,
        window_units=win.units, launches=launches, shapes=win.shapes,
        device_events=[], host_events=[], busy_s=None, window_s=None,
        traced_units=0, breakdown=None)
    if not tracer.done:
        return ctx
    dev_ev, host_ev, h0, h1 = tracer.events()
    ctx.device_events, ctx.host_events = dev_ev, host_ev
    ctx.traced_units = tracer.n_units
    ctx.window_s = tracer.wall
    if dev_ev:
        ctx.busy_s = devtrace.busy_us(dev_ev) / 1e6
        if ctx.busy_s > ctx.window_s * (1.0 + BUSY_SLACK):
            raise RunError(
                f"device busy {ctx.busy_s!r} s over the traced stretch's "
                f"{ctx.window_s!r} s: the count of busy time is wrong")
        start = min(h0, min(s for _, s, _ in dev_ev))
        end = max(h1, max(s + d for _, s, d in dev_ev))
        ctx.breakdown = {
            "device_ops": devtrace.top_ops(dev_ev),
            "idle_gaps": devtrace.gaps_by_host(dev_ev, host_ev, start, end),
        }
    return ctx


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv, t_start: float) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="one run of one cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        cell = find_cell(args.workload)
        import torch

        chips = int(cell.workload["chips"])
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            raise RunError(f"needs {chips} CUDA device(s); found "
                           f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.set_num_threads(2)
        import sexy_raytracer_tpu_torch as port
        if not Path(port.__file__).resolve().is_relative_to(ROOT):
            raise RunError(f"{PORT} is not this checkout's: {port.__file__}")
        from sexy_raytracer_tpu_torch.ops import _cuda
        _cuda.library()
        dev = Device(torch, "cuda")
        out = run_cell(cell, args.seed, args.seconds, args.trace, dev,
                       t_start)
    except RunError as e:
        print(f"benchmark: {e}", file=sys.stderr, flush=True)
        return 2
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: forbidden modules loaded: {bad}", file=sys.stderr,
              flush=True)
        return 3
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main(sys.argv[1:], time.perf_counter()))
