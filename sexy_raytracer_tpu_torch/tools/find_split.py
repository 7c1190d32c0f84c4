"""Where the hit search's time goes: kernels 1 (``find_closest``), 8
(``find_streamed``) and 2 (``find_any``) at the frame's, the train
step's and the big frame's shapes, with the tests their walks make.

    python -m sexy_raytracer_tpu_torch.tools.find_split \
        [walk|resident|host|sass|brute] [--out JSON] [--sass-out TXT]

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
instructions, and in kernel 9's test loop its instructions by class per
(ray, triangle) test (``brute_sass``; ``--sass-in`` reads a saved dump
instead, on any machine). ``brute``, on the card: kernel 9
(``brute.tri_brute``) on row 9's input (the n = 39 stand-in's 524,288
camera rays of the frame's mid chunk), row 9b's (8,192 bounce-1 rays of
the big frame's mid chunk: its run of 32 blocks whose primary rays hit
the most triangles), the same blocks' bounce-0 rays and the big scene's
4,096 fuzz rays, as ``chip_smoke.py`` phase 7.1 makes them: the median
ms by CUDA events, the device ms by the profiler, the blocks launched,
digests of the inputs and the output, the output's bit differences from
``tri_brute_plain``, and (``brute.range_maybe_plain`` where the tree has
it) the share of (32-ray warp, triangle) pairs in which no lane has
``plane_ok`` and in which no lane passes the range test, and the bound
from the float32 operations the data needs (``brute_scan_counts``). Its
timing and digests use only what ``ops/brute.py`` has had since its
first version, so it also measures an older checkout; ``--slices`` runs
kernel 9 at each of these slice counts where the tree takes one
(``tri_brute``'s ``_slices``), ``--quick`` leaves out the plain version
and the counts.
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

import numpy as np
import torch

from sexy_raytracer_tpu_torch.checks import WALK_WARP_RAYS, walk_counts
from sexy_raytracer_tpu_torch.models import presets
from sexy_raytracer_tpu_torch.ops import _cuda, brute, find
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


def camera_rays(camera, key, pixel_ids, n_samples, W, H):
    """The primary rays ``render_pixels`` traces for these pixels
    (``chip_smoke.py`` phase 7) -> (org, dir, time)."""
    pid = pixel_ids.repeat_interleave(n_samples)
    sid = torch.arange(n_samples, dtype=torch.int32,
                       device=pixel_ids.device).repeat(pixel_ids.shape[0])
    k = rng.ray_keys_2d(key, pid, sid)
    uc = rng.per_ray_uniform_block(k, 5)
    u = ((pid % W).float() + uc[:, 0]) / (W - 1)
    v = ((H - (pid // W).float()) + uc[:, 1]) / (H - 1)
    return camera.get_rays(u, v, uc[:, 2:5])


def fuzz_rays(device, n=4096):
    """``chip_smoke.py``'s fuzz origins and directions (bench.py:123-128)."""
    fz = np.random.default_rng(42)
    fo = torch.tensor(fz.normal(0, 3.0, (n, 3)), dtype=torch.float32,
                      device=device)
    fd = fz.normal(size=(n, 3))
    fd = torch.tensor(fd / np.linalg.norm(fd, axis=1, keepdims=True),
                      dtype=torch.float32, device=device)
    return fo, fd


def brute_inputs(device, sub=8192):
    """Kernel 9's inputs ``(org4, dir4, w, t_min)`` as ``chip_smoke.py``
    phase 7.1 makes them -> [(label, inputs)]: row 9, row 9b (``sub``
    bounce-1 rays), the same run of bounce-0 rays and the big scene's fuzz
    rays."""
    scene, cfg = train_setup(device)[:2]
    camera = Camera.from_config(cfg.camera, cfg.aspect, device=device)
    W, H, spb = cfg.width, cfg.height, cfg.samples_per_batch
    chunk = min(cfg.rays_per_chunk // spb, W * H)
    mid = (-(-W * H // chunk) // 2) * chunk
    ids = torch.from_numpy(renderer.tile_pixel_order(W, H)[mid:mid + chunk]) \
        .to(device)
    o, d, _ = camera_rays(camera, rng.key(cfg.seed, device=device), ids, spb,
                          W, H)
    out = [("row 9: n=39 camera rays",
            (*brute.ray4(o, d), brute.build_weights(scene), 0.001))]
    del scene, o, d
    big, bcfg, bcam, bids, kw, _ = big_setup(device)
    key = rng.key(bcfg.seed, device=device)
    bg = torch.tensor(bcfg.background, device=device)
    calls = capture_calls([find], ["find_streamed"], lambda: (
        renderer.render_pixels(big, bcam, bids, 0, key, bg, **kw)))
    calls = calls["find_streamed"]
    rbs = find.STREAM_RAY_BLOCK
    nbs = sub // rbs
    _, p0 = find.find_streamed(*calls[0])
    TB = big.tri_v0.shape[0]
    on_tri = ((p0 >= 0) & (p0 < TB)).reshape(-1, rbs).sum(dim=1)
    b0 = int(on_tri.unfold(0, nbs, 1).sum(dim=1).argmax())
    wb = brute.build_weights(big)
    for bounce, label in ((1, "row 9b: big bounce 1"), (0, "big bounce 0")):
        rays = calls[bounce][1][b0 * rbs:(b0 + nbs) * rbs]
        out.append((label, (*brute.ray4(rays[:, 0:3].contiguous(),
                                        rays[:, 3:6].contiguous()), wb,
                            0.001)))
    out.append(("big fuzz", (*brute.ray4(*fuzz_rays(device)), wb, 0.001)))
    return out


def brute_scan_counts(org4, dir4, w, t_min, warp=32, rows=4096):
    """One scan of kernel 9's (ray, triangle) pairs in index order, each
    ray at its best t before each triangle, -> the share of (``warp``-ray
    warp, triangle) pairs in which no lane has ``plane_ok`` and the share
    in which no lane passes the range test (``brute.range_maybe_plain``;
    the kernel takes its far bound from the best t at the start of each
    128-triangle stage, so it skips at most these shares), the same shares
    of (ray, triangle) pairs, and ``needed_ops``: the float32 operations
    this data needs, the kernel's bound:

    * each pair of a ray whose dir4 is not all zero and a triangle whose
      plane group (its four n|d weights) is not all zero (else b_n is +-0
      or NaN, never plane_ok: the pad rays and triangles): the plane
      group's two products, 11 operations where the ray is ``[o, 1], [d,
      0]`` and the triangle's w3 words are finite (``x w0 + y w1 + z w2 +
      w3``, ``dx w0 + dy w1 + dz w2``: exact there, csrc/brute.cu dot_o),
      else 14;
    * each pair with ``plane_ok``: the divide;
    * each pair with ``plane_ok`` and ``t`` in ``[t_min, best t)``: its
      edge groups up to the first that fails, each its two products and
      ``a + t b`` (13, else 16).
    """
    tt = brute.TRI_TILE
    n_tiles = w.shape[1] // (4 * tt)
    groups = w.view(4, n_tiles, 4, tt)                # [row, tile, group, j]
    tri_real = (groups[:, :, 0] != 0).any(dim=0).reshape(-1)
    tri_finite = torch.isfinite(groups[3]).all(dim=1).reshape(-1)
    ray_real = (dir4 != 0).any(dim=1)
    ray_unit = (org4[:, 3] == 1.0) & (dir4[:, 3] == 0.0)
    sums = dict(no_plane=0, no_range=0, lane_no_plane=0, lane_no_range=0,
                needed_ops=0)
    for r0 in range(0, org4.shape[0], rows):
        o = [org4[r0:r0 + rows, i:i + 1] for i in range(4)]
        d = [dir4[r0:r0 + rows, i:i + 1] for i in range(4)]
        best = torch.full((o[0].shape[0], 1), brute._BIG, device=org4.device)
        for k in range(n_tiles):
            wk = w[:, k * 4 * tt:(k + 1) * 4 * tt]
            a = o[0] * wk[0] + o[1] * wk[1] + o[2] * wk[2] + o[3] * wk[3]
            b = d[0] * wk[0] + d[1] * wk[1] + d[2] * wk[2] + d[3] * wk[3]
            a_n, b_n = a[:, :tt], b[:, :tt]
            plane_ok = b_n <= -brute.EPSILON
            t = -a_n / torch.where(plane_ok, b_n, 1.0)
            edge = [(a[:, i * tt:(i + 1) * tt] + t * b[:, i * tt:(i + 1) * tt])
                    >= 0.0 for i in (1, 2, 3)]
            valid = plane_ok & (t >= t_min) & edge[0] & edge[1] & edge[2]
            run = torch.minimum(torch.cummin(
                torch.where(valid, t, brute._BIG), dim=1).values, best)
            before = torch.cat([best, run[:, :-1]], dim=1)
            maybe = brute.range_maybe_plain(a_n, b_n, before, t_min)
            best = run[:, -1:]
            sums["lane_no_plane"] += int((~plane_ok).sum())
            sums["lane_no_range"] += int((~maybe).sum())
            sums["no_plane"] += int((~plane_ok.reshape(-1, warp, tt)
                                     .any(dim=1)).sum())
            sums["no_range"] += int((~maybe.reshape(-1, warp, tt)
                                     .any(dim=1)).sum())
            cols = slice(k * tt, (k + 1) * tt)
            real = ray_real[r0:r0 + rows, None] & tri_real[None, cols]
            prod = torch.where(ray_unit[r0:r0 + rows, None]
                               & tri_finite[None, cols], 11, 14)
            in_range = plane_ok & (t >= t_min) & (t < before)
            edges = (in_range.int() + (in_range & edge[0]).int()
                     + (in_range & edge[0] & edge[1]).int())
            sums["needed_ops"] += int(torch.where(
                real, prod + plane_ok.int() + edges * (prod + 2), 0)
                .sum(dtype=torch.int64))
    pairs = org4.shape[0] * n_tiles * tt
    return dict(no_plane=sums["no_plane"] * warp / pairs,
                no_range=sums["no_range"] * warp / pairs,
                lane_no_plane=sums["lane_no_plane"] / pairs,
                lane_no_range=sums["lane_no_range"] / pairs,
                needed_ops=sums["needed_ops"])


def brute_rows(device, slices=(None,), quick=False):
    """Kernel 9 on ``brute_inputs``, once for each slice count in
    ``slices`` (None: the wrapper's own): times, the slices and blocks it
    launched, digests, bit differences from the plain version, and the
    counts of ``brute_scan_counts`` with the bound from its needed
    operations."""
    launched = getattr(brute, "LAST_LAUNCH", None)
    rows = []
    for label, inp in brute_inputs(device):
        org4, _, w, t_min = inp
        n_tiles = w.shape[1] // (4 * brute.TRI_TILE)
        tests = org4.shape[0] * n_tiles * brute.TRI_TILE
        counts = None
        for n_slices in slices:
            kw = {} if n_slices is None else dict(_slices=n_slices)
            fn = lambda: brute.tri_brute(*inp, **kw)  # noqa: E731
            out = fn()
            row = dict(case=label, rays=org4.shape[0], tiles=n_tiles,
                       tests=tests, ms=events_ms(fn, 10),
                       in_sha=digest(*inp[:3]), out_sha=digest(*out),
                       hits=int((out[1] >= 0).sum()))
            row.update(dict(slices=1, blocks=org4.shape[0] // brute.RAY_BLOCK)
                       if launched is None else
                       dict(slices=launched["slices"],
                            blocks=launched["blocks"]))
            dev_ms, n_k, by = device_split(fn, n=5)
            row.update(device_ms=dev_ms, kernels_per_call=n_k,
                       device_by_kernel=by)
            if not quick and n_slices == slices[0]:
                t_p, i_p = brute.tri_brute_plain(*inp)
                row["t_bits_differ"] = int((out[0].view(torch.int32)
                                            != t_p.view(torch.int32)).sum())
                row["ids_differ"] = int((out[1] != i_p).sum())
                if hasattr(brute, "range_maybe_plain"):
                    counts = brute_scan_counts(*inp)
            if counts is not None:
                row.update(counts, bound_ms=counts["needed_ops"]
                           / F32_FLOPS_PER_S * 1e3)
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


def _sass_ins(sass, kernel):
    """[(address, instruction text)] of the first function of
    ``cuobjdump -sass`` text whose name holds ``kernel``."""
    funcs = re.split(r"\n\s*Function : ", sass)
    body = next((f for f in funcs if kernel in f.split("\n", 1)[0]), "")
    ins = []
    for line in body.splitlines():
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if m:
            ins.append((int(m.group(1), 16), m.group(2)))
    return ins


def _opcode(text):
    """The opcode of one SASS instruction, its predicate guard dropped."""
    return re.sub(r"^@!?U?P\w+\s+", "", text).split()[0]


# kernel 9's instruction classes, by opcode (``.`` suffixes dropped)
_BRUTE_CLASSES = {
    "lds": ("LDS",),
    "f32": ("FADD", "FMUL"),
    "divide": ("MUFU", "FFMA", "FCHK"),
    "compare_select": ("FSETP", "FSEL", "FSET", "FMNMX", "ISETP", "SEL",
                       "PLOP3", "P2R", "R2P"),
    "vote": ("VOTE",),
    "branch": ("BRA", "BSSY", "BSYNC", "CALL", "RET", "WARPSYNC"),
}


def _classes(ops):
    row = {"instructions": len(ops)}
    for cls, names in _BRUTE_CLASSES.items():
        row[cls] = sum(op.split(".")[0] in names for op in ops)
    row["other"] = row["instructions"] - sum(row[c] for c in _BRUTE_CLASSES)
    return row


def brute_sass(sass, kernel="tri_brute_kernel", rays_per_lane=1):
    """Kernel 9's test loops in ``cuobjdump -sass`` text (the innermost
    loops that divide), in order of their float32 instructions (the first
    is the one ``ray4``'s rays run where the kernel has two), each per
    (ray, triangle) test: its instructions by class (``full``: every
    instruction of the loop, as a test that runs in full executes them;
    ``skip``: those outside the branches that follow the first warp vote
    of each triangle, as a test whose warp no lane passes executes them),
    and the instructions of a test whose warp stops at each vote
    (``stop``). A loop's tests are its divides (one ``MUFU.RCP`` each),
    its triangles those over ``rays_per_lane``, its votes in each
    triangle's order."""
    ins = _sass_ins(sass, kernel)
    addr = {a: i for i, (a, _) in enumerate(ins)}
    loops = []
    for i, (a, text) in enumerate(ins):
        m = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", text)
        if m and int(m.group(1), 16) < a and int(m.group(1), 16) in addr:
            loops.append((addr[int(m.group(1), 16)], i))
    inner = [(s, e) for s, e in loops
             if not any(s <= s2 and e2 <= e and (s2, e2) != (s, e)
                        for s2, e2 in loops)]
    rows = []
    for s0, e0 in inner:
        seg = ins[s0:e0 + 1]
        ops = [_opcode(t) for _, t in seg]
        tests = sum(o.startswith("MUFU.RCP") for o in ops)
        if not tests:
            continue
        tris = max(1, tests // rays_per_lane)
        guards = []       # per vote: the loop positions its branch skips
        for i, (a, text) in enumerate(seg):
            m = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", text)
            voted = any(o.startswith("VOTE") for o in ops[max(0, i - 4):i])
            if m and text.startswith("@") and int(m.group(1), 16) > a \
                    and voted:
                end = int(m.group(1), 16)
                guards.append({j for j, (a2, _) in enumerate(seg)
                               if a < a2 < end})
        levels = len(guards) // tris

        def kept(level):
            out = set()
            for k in range(tris):
                out |= guards[k * levels + level]
            return [o for j, o in enumerate(ops) if j not in out]

        lds = {}
        for o in ops:
            if o.startswith("LDS"):
                lds[o] = lds.get(o, 0) + 1
        full = _classes(ops)
        rows.append(dict(
            loop_instructions=len(ops), tests_per_iteration=tests,
            triangles_per_iteration=tris, votes_per_triangle=levels, lds=lds,
            full_per_test={k: v / tests for k, v in full.items()},
            skip_per_test=({k: v / tests for k, v in _classes(kept(0)).items()}
                           if levels else None),
            stop_per_test=[len(kept(v)) / tests for v in range(levels)]))
    rows.sort(key=lambda r: r["full_per_test"]["f32"])
    return rows or None


def sass_rows(out_path, sass=None):
    if sass is None:
        lib = _cuda.build()
        tool = os.path.join(os.path.dirname(_cuda._nvcc()), "cuobjdump")
        sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                              text=True, check=True).stdout
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
    rows["tri_brute_kernel"] = brute_sass(
        sass, rays_per_lane=getattr(brute, "RAYS_PER_LANE", 1))
    print(f"tri_brute_kernel: {json.dumps(rows['tri_brute_kernel'])}",
          flush=True)
    rows["ptxas"] = {k: v for k, v in _cuda.ptxas_report().items()
                     if "find_" in k or "brute" in k}
    for k, v in rows["ptxas"].items():
        print(f"ptxas: {k}: {json.dumps(v)}", flush=True)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("cmd", nargs="?", default="walk",
                    choices=["walk", "resident", "host", "sass", "brute"])
    ap.add_argument("--out", default=None, help="also write the rows here")
    ap.add_argument("--sass-out", default=None,
                    help="sass: write the library's SASS here")
    ap.add_argument("--sass-in", default=None,
                    help="sass: count in this saved SASS (no card needed)")
    ap.add_argument("--slices", default=None,
                    help="brute: kernel 9's slice counts, comma-separated "
                         "('auto': the wrapper's own; the default)")
    ap.add_argument("--quick", action="store_true",
                    help="brute: leave out the plain version and the shares")
    args = ap.parse_args(argv)
    if args.cmd == "sass" and args.sass_in:
        with open(args.sass_in) as f:
            result = dict(sass=sass_rows(args.sass_out, f.read()))
    else:
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
        elif args.cmd == "brute":
            slices = (None,) if args.slices is None else tuple(
                None if x == "auto" else int(x)
                for x in args.slices.split(","))
            result = dict(device=smi, rows=brute_rows(dev, slices,
                                                      args.quick))
        else:
            result = dict(device=smi, sass=sass_rows(args.sass_out))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
