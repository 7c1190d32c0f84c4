"""Where the hit search's time goes: kernels 1 (``find_closest``), 8
(``find_streamed``) and 2 (``find_any``) at the frame's, the train
step's and the big frame's shapes, with the tests their walks make.

    python -m sexy_raytracer_tpu_torch.tools.find_split \
        [walk|resident|host|sass] [--out JSON] [--sass-out TXT]

``walk`` (the default), on the card: captures the wrapper calls of the
flagship frame's mid chunk (kernel 2 and its regrouping pass, first:
late in a process the profiler loses device events), of one mid chunk
of the big frame (``flagship_standin(n=389)``, 302,642 triangles; kernel
8 at bounces 0, 1 and 2, kernel 2 and the pass on the last bounce), and
65,536 primary rays of the big scene; for each kernel it prints the
median time by CUDA events, the device time by the profiler, and the
executed, live and needed (ray, triangle) tests of
``checks.walk_counts``; for the pass, its times. The bound from the needed
tests is ``needed x 37`` float32 operations over 67 TFLOP/s. ``resident``, on
the card: kernel 1 at bounces 0, 1 and 2 of the flagship frame's mid
chunk (524,288 rays) and at bounce 0 of one train step (131,072), each
with the same counts and hashes of its lists and rays and of its output
(``shade_split.digest``). ``host``, on the card: the launch paths of
kernels 1 and 4 at bounce 0 of the frame chunk and of the train step
(kernel 4's train call through its autograd Function): ms by CUDA events
around each call, the same with the card kept busy while the host
launches (``torch.cuda._sleep`` before the first event: the host path
hidden), device ms by the profiler, and host microseconds per call of the
whole wrapper, of its ``Kernel.launch`` and of the C entry inside that
(``Kernel._fn``); it uses only what the wrappers and ``Kernel`` have had
since PR 4, so it also measures an older checkout. ``sass``
writes ``cuobjdump -sass`` of the built library and counts, in each find
kernel's innermost loops, the shared-memory loads and the float32
instructions.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import statistics
import tempfile
import time

import torch

from sexy_raytracer_tpu_torch.checks import WALK_WARP_RAYS, walk_counts
from sexy_raytracer_tpu_torch.models import presets
from sexy_raytracer_tpu_torch.ops import _cuda, find
from sexy_raytracer_tpu_torch.render import renderer
from sexy_raytracer_tpu_torch.render.camera import Camera
from sexy_raytracer_tpu_torch.tools.histogram_split import (
    capture_calls,
    device_split,
    events_ms,
    nvidia_smi,
    train_setup,
)
from sexy_raytracer_tpu_torch.tools.shade_split import digest
from sexy_raytracer_tpu_torch.utils import rng

BIG_N, BIG_SPP = 389, 8
OPS_PER_TEST = 37            # chip_smoke.py: float32 operations of one test
F32_FLOPS_PER_S = 67e12


def _row(label, closest, fn, args, scene, reps, warp_rays=WALK_WARP_RAYS,
         **extra):
    ms = events_ms(fn, reps)
    dev_ms, n_k, _ = device_split(fn, n=min(reps, 5))
    c = walk_counts(closest, args, scene.cluster_min, scene.cluster_max,
                    warp_rays)
    row = dict(case=label, rays=args[1].shape[0], ms=ms, device_ms=dev_ms,
               kernels_per_call=n_k, **extra, **c,
               needed_bound_ms=c["needed"] * OPS_PER_TEST
               / F32_FLOPS_PER_S * 1e3,
               executed_bound_ms=c["executed"] * OPS_PER_TEST
               / F32_FLOPS_PER_S * 1e3)
    print(json.dumps(row), flush=True)
    return row


def _pass_row(label, args, reps):
    fn = lambda: find.any_regroup(*args)  # noqa: E731
    dev_ms, n_k, _ = device_split(fn, n=min(reps, 5))
    row = dict(case=label, rays=args[0].shape[0], ms=events_ms(fn, reps),
               device_ms=dev_ms, kernels_per_call=n_k)
    print(json.dumps(row), flush=True)
    return row


def big_setup(device):
    """The big scene (``flagship_standin(n=389)``) at 720p, 8 spp, and what
    ``render_pixels`` needs for its mid chunk (as ``chip_smoke.py`` phase
    7) -> (scene, cfg, camera, chunk pixel ids, render kwargs, the
    chunk's first 65,536 pixel ids)."""
    with tempfile.TemporaryDirectory() as no_assets:
        big, cfg = presets.flagship_standin(n=BIG_N, spp=BIG_SPP, height=720,
                                            data_dir=no_assets, device=device)
    camera = Camera.from_config(cfg.camera, cfg.aspect, device=device)
    W, H = cfg.width, cfg.height
    spb = min(cfg.samples_per_batch, BIG_SPP)
    chunk = min(cfg.rays_per_chunk // spb, W * H)
    order = renderer.tile_pixel_order(W, H)
    mid = (-(-W * H // chunk) // 2) * chunk
    ids = torch.from_numpy(order[mid:mid + chunk]).to(device)
    kw = dict(width=W, height=H, spb=spb, spp_total=BIG_SPP,
              max_bounce=cfg.max_bounce, last_bounce_vis=True)
    return big, cfg, camera, ids, kw, order[mid:mid + 65536]


def walk_rows(device):
    rows = []
    # the flagship frame's mid chunk (kernel 2 once per chunk)
    setup = train_setup(device)
    scene = setup[0]
    calls = _frame_chunk_calls(setup, device, ["any_regroup", "find_any"])
    rows.append(_pass_row("frame chunk, regrouping pass",
                          calls["any_regroup"][0], 20))
    args = calls["find_any"][0]
    rows.append(_row("frame chunk", False, lambda: find.find_any(*args),
                     args, scene, 20))
    del calls, scene
    big, cfg, camera, ids, kw, primary = big_setup(device)
    key = rng.key(cfg.seed, device=device)
    bg = torch.tensor(cfg.background, device=device)
    calls = capture_calls([find, find, find],
                          ["find_streamed", "any_regroup", "find_any"],
                          lambda: renderer.render_pixels(
                              big, camera, ids, 0, key, bg, **kw))
    rows.append(_pass_row("big chunk last bounce, regrouping pass",
                          calls["any_regroup"][0], 10))
    for b, args in enumerate(calls["find_streamed"]):
        rows.append(_row(f"big chunk bounce {b}", True,
                         lambda a=args: find.find_streamed(*a), args, big,
                         3 if b else 5))
    args = calls["find_any"][0]
    rows.append(_row("big chunk last bounce", False,
                     lambda: find.find_any(*args), args, big, 10))
    del calls
    # 65,536 tile-ordered primary rays (chip_smoke.py phase 7.2)
    W, H = cfg.width, cfg.height
    pid = torch.from_numpy(primary).to(device)
    k = rng.ray_keys_2d(key, pid, torch.zeros_like(pid))
    uc = rng.per_ray_uniform_block(k, 5)
    u = ((pid % W).float() + uc[:, 0]) / (W - 1)
    v = ((H - (pid // W).float()) + uc[:, 1]) / (H - 1)
    o, d, t = camera.get_rays(u, v, uc[:, 2:5])
    args = find.streamed_inputs(big, o, d, t)
    rows.append(_row("65536 primary rays", True,
                     lambda: find.find_streamed(*args), args, big, 10))
    return rows


def _frame_chunk_calls(setup, device, names):
    """The wrapper calls ``names`` of ``ops/find`` made by the flagship
    frame's mid chunk (as ``chip_smoke.py`` phase 3), ``setup`` being
    ``train_setup(device)`` -> {name: [args, ...]}."""
    scene, fcfg, fcam = setup[:3]
    key = rng.key(fcfg.seed, device=device)
    bg = torch.tensor(fcfg.background, device=device)
    P = fcfg.width * fcfg.height
    spb = fcfg.samples_per_batch
    chunk = min(fcfg.rays_per_chunk // spb, P)
    mid = (-(-P // chunk) // 2) * chunk
    fids = torch.from_numpy(renderer.tile_pixel_order(
        fcfg.width, fcfg.height)[mid:mid + chunk]).to(device)
    return capture_calls([find] * len(names), names, lambda: (
        renderer.render_pixels(
            scene, fcam, fids, 0, key, bg, width=fcfg.width,
            height=fcfg.height, spb=spb, spp_total=fcfg.samples_per_pixel,
            max_bounce=fcfg.max_bounce, last_bounce_vis=True)))


def resident_inputs(device):
    """Kernel 1's arguments on the main paths -> [(label, args)]: bounces
    0, 1 and 2 of the flagship frame's mid chunk, and bounce 0 of one
    train step (bench.py's 131,072 paths); and the scene."""
    setup = train_setup(device)
    scene, _, cam, ids, tgt, new_step = setup
    calls = _frame_chunk_calls(setup, device, ["find_closest"])
    out = [(f"frame chunk bounce {b}", a)
           for b, a in enumerate(calls["find_closest"])]
    step, state = new_step()
    train = capture_calls([find], ["find_closest"], lambda: step(
        state, scene, cam, ids, tgt, rng.key(0, device)))["find_closest"]
    out.append(("train step bounce 0", train[0]))
    return scene, out


def resident_rows(device):
    """Kernel 1 on its main-path inputs, each row with hashes of its lists
    and rays and of its output."""
    scene, inputs = resident_inputs(device)
    rows = []
    for label, args in inputs:
        rows.append(_row(f"kernel 1, {label}", True,
                         lambda a=args: find.find_closest(*a), args, scene,
                         20, warp_rays=32 * find.FIND_RAYS_PER_LANE,
                         in_sha=digest(*args[:2]),
                         out_sha=digest(*find.find_closest(*args))))
    return rows


def _host_us(fn, n=200):
    """Host microseconds per call of ``fn`` over ``n`` calls in a row."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


def _hidden_ms(fn, reps=20, sleep_cycles=2_000_000):
    """Median ms of ``fn()`` by CUDA events, the card kept busy (about a
    millisecond) while the host launches it: device time and the gaps
    between kernels on the card, without the host's launch path."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep_cycles)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _launch_us(fn, kernel, n=200):
    """Host microseconds per call of ``fn`` spent in ``kernel.launch`` and
    in the C entry inside it -> (launch us, entry us)."""
    fn()
    torch.cuda.synchronize()
    spent = dict(launch=0.0, entry=0.0)
    launch, entry = kernel.launch, kernel._fn

    def timed_entry(*a):
        t = time.perf_counter()
        err = entry(*a)
        spent["entry"] += time.perf_counter() - t
        return err

    def timed_launch(*a):
        t = time.perf_counter()
        launch(*a)
        spent["launch"] += time.perf_counter() - t

    kernel._fn, kernel.launch = timed_entry, timed_launch
    try:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    finally:
        kernel._fn = entry
        del kernel.launch
    return spent["launch"] / n * 1e6, spent["entry"] / n * 1e6


def host_rows(device):
    """Kernels 1 and 4 at bounce 0 of the frame chunk and of the train
    step: events, hidden-host events and device ms, and host us of the
    wrapper, its ``Kernel.launch`` and the C entry."""
    from sexy_raytracer_tpu_torch.ops import fused
    from sexy_raytracer_tpu_torch.tools import shade_split

    _, k1 = resident_inputs(device)
    k1 = dict(k1)
    stacks = {case: args["shade"]
              for case, args in shade_split.inputs(device).items()}
    cases = [
        ("kernel 1, frame chunk bounce 0", find.FIND_CLOSEST,
         lambda a=k1["frame chunk bounce 0"]: find.find_closest(*a)),
        ("kernel 1, train step bounce 0", find.FIND_CLOSEST,
         lambda a=k1["train step bounce 0"]: find.find_closest(*a)),
        ("kernel 4, frame chunk", fused.SHADE,
         lambda a=stacks["frame chunk"]: fused.shade_carry_fused(
             a[0].detach(), a[1])),
        ("kernel 4, train step (autograd Function)", fused.SHADE,
         lambda a=stacks["train step"]: fused.shade_carry_fused(*a)),
    ]
    rows = []
    for label, kernel, fn in cases:
        dev_ms, n_k, _ = device_split(fn, n=5)
        launch_us, entry_us = _launch_us(fn, kernel)
        row = dict(case=label, ms=events_ms(fn, 20), hidden_ms=_hidden_ms(fn),
                   device_ms=dev_ms, kernels_per_call=n_k,
                   wrapper_us=_host_us(fn), launch_us=launch_us,
                   entry_us=entry_us)
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


_F32 = re.compile(r"\b(FADD|FMUL|FFMA|FSETP|FMNMX|FSEL|MUFU|FCHK|FSET)\b")
_LDS = re.compile(r"\bLDS(\.\w+)*\b")


def sass_loops(sass, kernel):
    """Innermost loops of ``kernel`` in ``cuobjdump -sass`` text: for each
    backward branch whose body holds no other loop, its instruction
    count, shared-memory loads (by width) and float32 instructions."""
    funcs = re.split(r"\n\s*Function : ", sass)
    body = next((f for f in funcs if kernel in f.split("\n", 1)[0]), "")
    ins = []
    for line in body.splitlines():
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if m:
            ins.append((int(m.group(1), 16), m.group(2)))
    addr = {a: i for i, (a, _) in enumerate(ins)}
    loops = []
    for i, (a, text) in enumerate(ins):
        m = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", text)
        if m and int(m.group(1), 16) < a and int(m.group(1), 16) in addr:
            loops.append((addr[int(m.group(1), 16)], i))
    inner = [(s, e) for s, e in loops
             if not any(s <= s2 and e2 <= e and (s2, e2) != (s, e)
                        for s2, e2 in loops)]
    out = []
    for s, e in inner:
        seg = [t for _, t in ins[s:e + 1]]
        lds = {}
        for t in seg:
            m = _LDS.search(t)
            if m:
                lds[m.group(0)] = lds.get(m.group(0), 0) + 1
        out.append(dict(instructions=len(seg), lds=lds,
                        f32=sum(bool(_F32.search(t)) for t in seg)))
    return sorted(out, key=lambda r: -r["f32"])


def sass_rows(out_path):
    lib = _cuda.build()
    tool = os.path.join(os.path.dirname(_cuda._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    if out_path:
        with open(out_path, "w") as f:
            f.write(sass)
    rows = {}
    names = [ln.split("Function : ", 1)[1].strip()
             for ln in sass.splitlines() if "Function : " in ln]
    for name in names:
        if "find_" in name and "_kernel" in name:
            rows[name] = sass_loops(sass, name)[:3]
            print(f"{name}: innermost loops {json.dumps(rows[name])}",
                  flush=True)
    rows["ptxas"] = {k: v for k, v in _cuda.ptxas_report().items()
                     if "find_" in k}
    for k, v in rows["ptxas"].items():
        print(f"ptxas: {k}: {json.dumps(v)}", flush=True)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("cmd", nargs="?", default="walk",
                    choices=["walk", "resident", "host", "sass"])
    ap.add_argument("--out", default=None, help="also write the rows here")
    ap.add_argument("--sass-out", default=None,
                    help="sass: write the library's SASS here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("find_split: needs a CUDA device")
    smi = nvidia_smi()
    print(smi, flush=True)
    dev = torch.device("cuda:0")
    _cuda.build()
    if args.cmd == "walk":
        result = dict(device=smi, rows=walk_rows(dev))
    elif args.cmd == "resident":
        result = dict(device=smi, rows=resident_rows(dev))
    elif args.cmd == "host":
        result = dict(device=smi, rows=host_rows(dev))
    else:
        result = dict(device=smi, sass=sass_rows(args.sass_out))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
