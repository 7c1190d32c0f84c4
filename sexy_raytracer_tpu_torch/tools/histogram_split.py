"""Where the dense histogram's time goes, and what one kernel launch costs
the host.

    python -m sexy_raytracer_tpu_torch.tools.histogram_split [split|e2e]
        [--out JSON]

On the card only. For each input (the train step's bounce-0 atlas backward,
the chief atlas's size ``wide_input``, the skewed ``skewed_input``) it
prints the kept-entry count and the longest segment (entries in the
hottest bin), the median time of ``dense_histogram`` and of ``index_add_``
on the kept rows by CUDA events, and the profiler's device time per call
split by kernel name, with the number of device kernels per call; and the
device time of the placement kernel's wrapper beside ``index_copy_``'s at
the tools' first A/B case. It also prints the host microseconds per
``Kernel.launch`` of the placement kernel on a one-row table (a launch that
does no work) and per ``place`` call, over 1,000 calls. ``e2e`` times the
frame and the train step. ``chip_smoke.py`` builds its scene and train
step with ``train_setup``, captures wrapper calls with ``capture_calls``
and times steps with ``run_steps``, as this tool does. It uses only what
every version of the port since the placement kernel has, so it measures
an older checkout as well.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import tempfile
import time

import numpy as np
import torch

from sexy_raytracer_tpu_torch.diff.inverse import (
    make_optimizer,
    make_train_step,
    sample_tile_ids,
)
from sexy_raytracer_tpu_torch.diff.params import extract_params
from sexy_raytracer_tpu_torch.models import presets
from sexy_raytracer_tpu_torch.ops import _cuda, histogram
from sexy_raytracer_tpu_torch.render.camera import Camera
from sexy_raytracer_tpu_torch.render.integrator import scene_no_emissive_tris
from sexy_raytracer_tpu_torch.render.renderer import render_image
from sexy_raytracer_tpu_torch.tools import profile as tprofile
from sexy_raytracer_tpu_torch.tools.devtime import profile_events
from sexy_raytracer_tpu_torch.utils import rng

TRAIN_PIXELS, TRAIN_SPB = 32768, 4          # bench.py:204-205


def train_setup(device):
    """The flagship stand-in at 720p, 8 spp, with no asset files, and the
    bench's train step on it (bench.py:201-236): 32,768 pixels at spb 4, a
    constant 0.5 target -> (scene, cfg, camera, pixel ids, target,
    new_step); ``new_step()`` makes the step and its initial state."""
    with tempfile.TemporaryDirectory() as no_assets:
        scene, cfg = presets.flagship_standin(n=39, spp=8, height=720,
                                              data_dir=no_assets,
                                              device=device)
    camera = Camera.from_config(cfg.camera, cfg.aspect, device=device)
    vis_ok = scene_no_emissive_tris(scene)
    ids = torch.from_numpy(sample_tile_ids(
        np.random.default_rng(0), cfg.width, cfg.height, TRAIN_PIXELS)) \
        .to(device)
    tgt = torch.full((TRAIN_PIXELS, 3), 0.5, device=device)

    def new_step():
        step = make_train_step(cfg, make_optimizer(extract_params(scene),
                                                   1e-3),
                               spb=TRAIN_SPB, last_bounce_vis=vis_ok)
        return step, step.init(extract_params(scene))

    return scene, cfg, camera, ids, tgt, new_step


def run_steps(step, state, scene, camera, ids, tgt, n, first_key, device):
    """``n`` train steps with keys ``first_key``, ``first_key + 1``, ...,
    then a synchronize -> (state, [loss, ...], host seconds per step)."""
    losses = []
    t0 = time.perf_counter()
    for i in range(n):
        state, loss = step(state, scene, camera, ids, tgt,
                           rng.key(first_key + i, device))
        losses.append(loss)
    torch.cuda.synchronize()
    return state, losses, (time.perf_counter() - t0) / n


def capture_calls(modules, names, run):
    """Run ``run()`` with each wrapper ``names[i]`` of ``modules[i]``
    recording (copies of) the arguments of every call; returns
    {name: [args, ...]} in call order."""
    seen = {name: [] for name in names}
    saved = []
    for mod, name in zip(modules, names):
        fn = getattr(mod, name)
        saved.append((mod, name, fn))

        def rec(*args, _fn=fn, _name=name):
            seen[_name].append(tuple(
                a.clone() if hasattr(a, "clone") else a for a in args))
            return _fn(*args)

        setattr(mod, name, rec)
    try:
        run()
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    return seen


def train_step_input(device="cuda"):
    """``(idx, vals, n_bins)`` of the last ``dense_histogram`` call (bounce
    0's atlas backward, the most live rays) of one train step."""
    scene, cfg, camera, ids, tgt, new_step = train_setup(device)
    step, state = new_step()
    return capture_calls([histogram], ["dense_histogram"], lambda: step(
        state, scene, camera, ids, tgt, rng.key(0, device))
    )["dense_histogram"][-1]


def end_to_end(device="cuda", frames=2, n_steps=8):
    """The frame and train-step times: host clock around ``render_image``
    of the 1280x720, 8-spp frame after one warm-up frame, and the mean of
    ``n_steps`` train steps after 2 warm-up steps (``run_steps``, as
    ``chip_smoke.py`` phase 6)."""
    scene, cfg, camera, ids, tgt, new_step = train_setup(device)
    render_image(scene, cfg)
    frame_s = []
    for _ in range(frames):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        render_image(scene, cfg)
        torch.cuda.synchronize()
        frame_s.append(time.perf_counter() - t0)
    step, state = new_step()
    args = (scene, camera, ids, tgt)
    state, _, _ = run_steps(step, state, *args, 2, 100, device)
    _, losses, step_s = run_steps(step, state, *args, n_steps, 1, device)
    return dict(frame_s=frame_s, step_ms=step_s * 1e3, steps=n_steps,
                loss=float(losses[-1]))


def wide_input(device="cuda"):
    """The chief atlas's size (JAX histogram.py:207-209): 786,432 bins x 8,
    524,288 entries in 128-entry screen tiles that each hit a 16 x 8 texel
    patch, 10% random ids, 20% all-zero rows."""
    wz = np.random.default_rng(9)
    n_wide, r_wide = 768 * 1024, 524288
    bx = wz.integers(0, 1024 - 16, r_wide // 128)
    by = wz.integers(0, 768 - 8, r_wide // 128)
    e = np.arange(128)
    idx = ((by[:, None] + e // 16) * 1024 + bx[:, None] + e % 16).reshape(-1)
    rnd = wz.random(r_wide) < 0.1
    idx[rnd] = wz.integers(0, n_wide, int(rnd.sum()))
    vals = wz.normal(size=(r_wide, 8))
    vals[wz.random(r_wide) < 0.2] = 0.0
    return (torch.tensor(idx, dtype=torch.int32, device=device),
            torch.tensor(vals, dtype=torch.float32, device=device), n_wide)


def skewed_input(device="cuda", R=131072, n_bins=1024, C=8, hot=0.9):
    """The train step's shape with ``hot`` of the entries in one bin (a
    texel that every ray of a flat-lit patch reads), the rest uniform,
    10% of the rows all zero."""
    r = np.random.default_rng(17)
    idx = r.integers(0, n_bins, R)
    idx[r.random(R) < hot] = 517
    vals = r.normal(size=(R, C))
    vals[r.random(R) < 0.1] = 0.0
    return (torch.tensor(idx, dtype=torch.int32, device=device),
            torch.tensor(vals, dtype=torch.float32, device=device), n_bins)


def segment_stats(idx, vals, n_bins):
    """Entries, kept entries, bins hit and the longest segment (entries in
    the hottest bin) of a histogram's input."""
    keep = (idx >= 0) & (idx < n_bins) & (vals != 0).any(dim=1)
    counts = torch.bincount(idx[keep].long(), minlength=n_bins)
    return dict(entries=idx.numel(), kept=int(keep.sum()),
                bins_hit=int((counts > 0).sum()),
                longest_segment=int(counts.max()) if n_bins else 0,
                n_bins=n_bins, channels=vals.shape[1])


def events_ms(fn, reps=20):
    """Median ms of ``fn()`` by CUDA events around each call (which also
    count the host's launch path)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_split(fn, n=10):
    """The profiler's device time of ``fn()`` per call -> (total ms, or
    None where events were lost; kernels per call; {kernel name: ms per
    call}). Every call launches the same kernels, so a kernel recorded a
    number of times that is not a multiple of ``n`` shows lost events."""
    _, ev = profile_events(fn, [()], n)
    by, count = {}, {}
    for _, name, us in ev:
        by[name] = by.get(name, 0.0) + us / 1e3 / n
        count[name] = count.get(name, 0) + 1
    whole = all(c % n == 0 for c in count.values())
    return (sum(by.values()) if whole else None), len(ev) / n, by


def index_add(idx, vals, n_bins):
    """The one PyTorch call for the same sums, on the kept rows."""
    keep = (idx >= 0) & (idx < n_bins) & (vals != 0).any(dim=1)
    i, v = idx[keep].long(), vals[keep]
    return lambda: torch.zeros((n_bins, v.shape[1]), device=v.device) \
        .index_add_(0, i, v)


def index_copy(tex_u, seg, win_starts, n_bins):
    """The one PyTorch call for the placement: ``index_copy_`` into
    zeros."""
    i = tex_u.long()
    return lambda: torch.zeros((n_bins, seg.shape[1]), device=seg.device) \
        .index_copy_(0, i, seg)


def place_split(device="cuda"):
    """The profiler's device time per call (``device_split``) of the
    placement wrapper ``place`` and of ``index_copy_``, of the whole
    ``dense_histogram_sorted`` and of ``index_add_``, at the tools' first
    A/B case (``tools.profile`` "atlas coherent") -> {name: split}."""
    _, idx, vals, n_bins = next(tprofile.histogram_inputs(
        tprofile.HISTOGRAM_CASES[:1], device))
    glue = (*histogram.sorted_segments(idx, vals, n_bins), n_bins)
    return {
        "place": device_split(lambda: histogram.place(*glue)),
        "index_copy_": device_split(index_copy(*glue)),
        "dense_histogram_sorted": device_split(
            lambda: histogram.dense_histogram_sorted(idx, vals, n_bins)),
        "index_add_": device_split(index_add(idx, vals, n_bins)),
    }


def histogram_rows(inputs):
    """One row per ``(label, (idx, vals, n_bins))``: stats, events and
    device split of ``dense_histogram`` and of ``index_add_``."""
    rows = []
    for label, inp in inputs:
        lib = index_add(*inp)
        total, kernels, by = device_split(
            lambda: histogram.dense_histogram(*inp))
        lib_total, lib_kernels, _ = device_split(lib)
        rows.append(dict(
            case=label, **segment_stats(*inp),
            ms=events_ms(lambda: histogram.dense_histogram(*inp)),
            library_ms=events_ms(lib), device_ms=total,
            kernels_per_call=kernels, device_by_kernel=by,
            library_device_ms=lib_total, library_kernels_per_call=lib_kernels))
    return rows


def launch_path_us(device="cuda", n=1000):
    """Host microseconds per ``PLACE.launch`` on a one-row table with no
    entries and per ``place`` call on the same inputs, over ``n`` calls
    each after a warm-up; the device work of each is one block zeroing one
    float."""
    tex_u = torch.zeros(0, dtype=torch.int32, device=device)
    seg = torch.zeros((0, 1), dtype=torch.float32, device=device)
    ws = torch.zeros(2, dtype=torch.int32, device=device)
    out = torch.empty((1, 1), dtype=torch.float32, device=device)
    dev = out.device
    args = (_cuda.ptr(tex_u), _cuda.ptr(seg), _cuda.ptr(ws), 1, 1,
            _cuda.ptr(out))

    def per_call(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return (t1 - t0) / n * 1e6

    return dict(launch_us=per_call(lambda: histogram.PLACE.launch(dev, *args)),
                place_us=per_call(lambda: histogram.place(tex_u, seg, ws, 1)),
                calls=n)


def nvidia_smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("cmd", nargs="?", default="split",
                    choices=["split", "e2e"],
                    help="split: the histogram and launch-path rows; e2e: "
                         "the frame and train-step times")
    ap.add_argument("--out", default=None, help="also write the rows here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("histogram_split: needs a CUDA device")
    smi = nvidia_smi()
    print(smi, flush=True)
    dev = torch.device("cuda:0")
    _cuda.build()
    if args.cmd == "e2e":
        result = dict(device=smi, **end_to_end(dev))
        print(json.dumps(result), flush=True)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(result, f, indent=1)
        return
    result = dict(device=smi, launch_path=launch_path_us(dev))
    print(f"launch path: {json.dumps(result['launch_path'])}", flush=True)
    result["histogram"] = histogram_rows([
        ("train step, bounce 0", train_step_input(dev)),
        ("wide (chief atlas)", wide_input(dev)),
        ("skewed", skewed_input(dev)),
    ])
    for row in result["histogram"]:
        print(json.dumps(row), flush=True)
    result["place"] = {k: dict(device_ms=v[0], kernels_per_call=v[1])
                       for k, v in place_split(dev).items()}
    print(f"place: {json.dumps(result['place'])}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
