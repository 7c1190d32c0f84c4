#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--out PNG] [--profile TXT]

Phases, one result line each; any failure raises and the script exits
nonzero without a result line:

1. the device: torch's name for it, and nvidia-smi's name and power limit;
2. the build of the CUDA kernels from ``sexy_raytracer_tpu_torch/csrc``;
3. each kernel against its plain PyTorch version on the same inputs, at the
   main paths' shapes and on a 4,096-ray fuzz wavefront:
   * forward kernels on the 524,288-ray chunk through the centre of the
     720p frame: the find kernels must return the same prim ids and
     occlusion flags, or differ only on near ties (for a flag: the closest
     occluder, emissive spheres excluded, lies at the ray's bound); the
     fused kernels must agree within atol 2e-5, rtol 1e-5;
   * backward kernels on the inputs of one train step (131,072 paths) and
     of the fuzz wavefront's backward: the hit-record and shade VJPs, with
     the cotangent scaled to unit size, within atol 2e-5, rtol 1e-4 of
     autograd of the plain math, with at most 1% of the rays outside and
     those ill-conditioned (``checks.vjp_outside``), and a check shown to
     reject a zero VJP and each gradient row with its sign flipped
     (``checks.vjp_check_power``); the histogram bit for bit against its
     plain version and across two launches, and within float32 summation
     error of ``index_add_`` on the kept rows, also at the chief atlas's
     786,432 bins x 8 channels with 524,288 entries;
   median times of kernel, plain version and (for the histogram) the one
   PyTorch call that computes the same function, from CUDA events, and the
   least time the card could take (bytes over 3.35 TB/s or float32
   operations over 67 TFLOP/s, whichever is larger);
4. a full 1280x720, 8-spp, 4-bounce frame of the flagship stand-in scene
   through ``render_image``, with the launch counters reset before it and
   read after it: find 3 times, occlusion once, hit record and shade 4
   times per chunk, no backward kernel; the image must vary, the radiance
   be finite, a second frame be identical, and at least 5% of primary rays
   must first hit a triangle;
5. frame time and Mrays/s (paths x 4 bounces);
6. the train step (bench.py:201-242 on one card): a gradient gate on 4,096
   pixels at spb 2 against the same loss on the CPU (relative loss 1e-3,
   relative gradient 1e-2, bench.py:192), then 2 warm-up and 8 timed steps
   of ``make_train_step`` with ``make_optimizer(params, 1e-3)`` on 32,768
   pixels at spb 4 with the launch counters reset before the timed steps:
   per step find 3, occlusion 1, hit record 4, shade 4 and each backward
   kernel 4 times; every trained parameter must move and stay finite.

The last three lines are the kernels' JSON record, nvidia-smi's
"name, power.limit" line, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

FIND_TIE = "|t_kernel - t_plain| <= 1e-3 * min(t) + 1e-5"
# the card's peaks for the bound (H100 SXM data sheet, at 700 W)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
# float32 operations of one find test (csrc/find.cu tri_hit, sphere_tc):
# multiplies, adds, subtractions, negations and the divide
OPS_PER_PAIR = 37
OPS_PER_SPHERE_TEST = 31
TRAIN_PIXELS, TRAIN_SPB = 32768, 4          # bench.py:204-205


def log(msg):
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps):
    """Median device time of ``fn`` in ms, from CUDA events."""
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


def elementwise_ops_per_ray(torch, fn, stacks):
    """Float operations per ray of ``fn(*stacks)`` ([K, R] stacks), counted
    by dispatching the plain version on the CPU: each arithmetic aten op
    counts one per output element."""
    from torch.utils._python_dispatch import TorchDispatchMode

    arith = {"add", "sub", "rsub", "mul", "div", "neg", "sqrt", "rsqrt",
             "reciprocal", "exp2", "sin", "cos", "abs", "maximum", "minimum",
             "clamp", "pow", "where", "sum"}

    class Count(TorchDispatchMode):
        ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.__name__.split(".")[0].rstrip("_")
            if name in arith and hasattr(out, "numel") \
                    and out.dtype.is_floating_point:
                Count.ops += out.numel()
            return out

    cpu = [s[:, :256].cpu().contiguous() for s in stacks]
    with Count():
        fn(*cpu)
    return Count.ops / 256


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "chip_smoke_720p.png"),
                    help="where to write the frame (PNG)")
    ap.add_argument("--profile", default=None,
                    help="also profile one frame chunk and one train step "
                         "with torch.profiler and write their per-kernel "
                         "tables here")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available()"
                         " is false); the port's kernels need an NVIDIA GPU")

    from sexy_raytracer_tpu_torch.diff.inverse import (
        _loss_fn,
        make_optimizer,
        make_train_step,
        sample_tile_ids,
    )
    from sexy_raytracer_tpu_torch.diff.params import (
        DEFAULT_TRAINABLE,
        extract_params,
    )
    from sexy_raytracer_tpu_torch import checks
    from sexy_raytracer_tpu_torch.models import presets
    from sexy_raytracer_tpu_torch.ops import _cuda, find, fused, histogram
    from sexy_raytracer_tpu_torch.ops.intersect import find_hit
    from sexy_raytracer_tpu_torch.render import integrator, renderer
    from sexy_raytracer_tpu_torch.render.camera import Camera
    from sexy_raytracer_tpu_torch.utils import color, rng
    from sexy_raytracer_tpu_torch.utils.png import write_png

    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 1. device ----------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    log(f"device: {kind} | nvidia-smi: {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    # ---- 2. build -----------------------------------------------------
    _cuda.build()
    info = _cuda.build_info
    log(f"build: {info['seconds']:.2f} s"
        f"{' (cached)' if info['cached'] else ''} -> {info['path']}")
    for line in info.get("log", "").splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    # ---- scene and frame configuration ---------------------------------
    with tempfile.TemporaryDirectory() as no_assets:
        scene, cfg = presets.flagship_standin(n=39, spp=8, height=720,
                                              data_dir=no_assets, device=dev)
    T = scene.num_triangles
    W, H, spp, spb = cfg.width, cfg.height, cfg.samples_per_pixel, \
        cfg.samples_per_batch
    P = W * H
    chunk = min(cfg.rays_per_chunk // spb, P)
    n_chunks = -(-P // chunk)
    log(f"scene: flagship stand-in, {T} triangles in "
        f"{scene.cluster_min.shape[0]} clusters, {scene.num_spheres} "
        f"spheres, atlas {tuple(scene.shade_atlas.shape)}; {W}x{H}, {spp} "
        f"spp, {cfg.max_bounce} bounces, {chunk * spb} paths per chunk, "
        f"{n_chunks} chunks")
    camera = Camera.from_config(cfg.camera, cfg.aspect, device=dev)
    base_key = rng.key(cfg.seed, device=dev)
    background = torch.tensor(cfg.background, device=dev)
    order = renderer.tile_pixel_order(W, H)
    vis_ok = integrator.scene_no_emissive_tris(scene)
    train_ids = torch.from_numpy(sample_tile_ids(
        np.random.default_rng(0), W, H, TRAIN_PIXELS)).to(dev)
    train_tgt = torch.full((TRAIN_PIXELS, 3), 0.5, device=dev)

    def train_step_fn():
        step = make_train_step(cfg, make_optimizer(extract_params(scene),
                                                   1e-3),
                               spb=TRAIN_SPB, last_bounce_vis=vis_ok)
        return step, step.init(extract_params(scene))

    # ---- 3. kernels against their plain versions -----------------------
    fwd_wrappers = [(find, "find_closest"), (find, "find_any"),
                    (integrator, "hitrec_fused"),
                    (integrator, "shade_carry_fused")]
    bwd_wrappers = [(fused, "hitrec_bwd"), (fused, "shade_bwd"),
                    (histogram, "dense_histogram")]

    mid = (n_chunks // 2) * chunk
    ids = torch.from_numpy(order[mid:mid + chunk]).to(dev)
    main_inputs = capture_calls(*zip(*fwd_wrappers), lambda: (
        renderer.render_pixels(
            scene, camera, ids, 0, base_key, background, width=W, height=H,
            spb=spb, spp_total=spp, max_bounce=cfg.max_bounce,
            last_bounce_vis=True)))
    main_inputs = {k: v[0] for k, v in main_inputs.items()}

    def one_train_step():
        step, state = train_step_fn()
        step(state, scene, camera, train_ids, train_tgt, rng.key(0, dev))

    # the backward's last call is bounce 0's: the most live rays
    main_inputs.update({k: v[-1] for k, v in capture_calls(
        *zip(*bwd_wrappers), one_train_step).items()})

    fz = np.random.default_rng(42)            # bench.py:123-128
    fo = torch.tensor(fz.normal(0, 3.0, (4096, 3)), dtype=torch.float32,
                      device=dev)
    fd = fz.normal(size=(4096, 3))
    fd = torch.tensor(fd / np.linalg.norm(fd, axis=1, keepdims=True),
                      dtype=torch.float32, device=dev)
    ft = torch.tensor(fz.uniform(0, 1, 4096), dtype=torch.float32,
                      device=dev)
    fkeys = rng.ray_keys_2d(base_key, torch.arange(4096, device=dev),
                            torch.zeros(4096, dtype=torch.int64, device=dev))
    fw = torch.tensor(fz.uniform(0.5, 1.5, (4096, 3)), dtype=torch.float32,
                      device=dev)

    def fuzz_backward():
        params = {k: v.clone().requires_grad_(True)
                  for k, v in extract_params(scene).items()}
        rad = integrator.trace_rays_fused(
            scene._replace(**params), fo, fd, ft, fkeys, background,
            cfg.max_bounce, last_bounce_vis=True)
        torch.autograd.grad((rad * fw).sum(), list(params.values()))

    fuzz_inputs = {k: v[0] for k, v in capture_calls(
        *zip(*fwd_wrappers), lambda: integrator.trace_rays_fused(
            scene, fo, fd, ft, fkeys, background, cfg.max_bounce,
            last_bounce_vis=True)).items()}
    fuzz_inputs.update({k: v[-1] for k, v in capture_calls(
        *zip(*bwd_wrappers), fuzz_backward).items()})

    # the chief atlas's size (histogram.py:207-209): 786,432 bins x 8,
    # 524,288 entries in 128-entry screen tiles that each hit a 16 x 8
    # texel patch, 10% random ids, 20% all-zero rows
    wz = np.random.default_rng(9)
    n_wide, r_wide = 768 * 1024, 524288
    bx = wz.integers(0, 1024 - 16, r_wide // 128)
    by = wz.integers(0, 768 - 8, r_wide // 128)
    e = np.arange(128)
    wide_idx = ((by[:, None] + e // 16) * 1024 + bx[:, None] + e % 16)
    wide_idx = wide_idx.reshape(-1)
    rnd = wz.random(r_wide) < 0.1
    wide_idx[rnd] = wz.integers(0, n_wide, int(rnd.sum()))
    wide_vals = wz.normal(size=(r_wide, 8))
    wide_vals[wz.random(r_wide) < 0.2] = 0.0
    wide_inputs = (torch.tensor(wide_idx, dtype=torch.int32, device=dev),
                   torch.tensor(wide_vals, dtype=torch.float32, device=dev),
                   n_wide)

    # the whole integrator on the card against the same trace on the CPU,
    # where every wrapper runs its plain version (the path the CPU tests
    # hold to the JAX package): 0.5% of rays may leave the tolerance on
    # an f32 edge flip, as in tests/test_torch_render.py
    rad_gpu = integrator.trace_rays_fused(
        scene, fo, fd, ft, fkeys, background, cfg.max_bounce,
        last_bounce_vis=True).cpu()
    rad_cpu = integrator.trace_rays_fused(
        scene.to("cpu"), fo.cpu(), fd.cpu(), ft.cpu(), fkeys.cpu(),
        background.cpu(), cfg.max_bounce, last_bounce_vis=True)
    close = torch.isclose(rad_gpu, rad_cpu, atol=2e-5, rtol=1e-5).all(dim=1)
    log(f"trace 4096 rays x {cfg.max_bounce} bounces, card vs CPU: "
        f"{int((~close).sum())} rays outside atol 2e-5 rtol 1e-5, max abs "
        f"err {float((rad_gpu - rad_cpu).abs().max()):.3g}")
    if float(close.float().mean()) < 0.995:
        raise AssertionError("card and CPU traces disagree on > 0.5% of rays")

    def closest_occluder(rays, tri, sph, n):
        """(prim, t) of the closest occluder of each ray in a ray table:
        every triangle, and the spheres the occlusion pack marks valid
        (emissive spheres are cleared there), from the plain version."""
        rt, nb = find._ray_table(list(rays[:, :8].unbind(1)), {7: 3.0e38})
        lists = find._uncull_lists(nb, tri.shape[0], rays.device)
        t, prim = find.find_closest_plain(lists, rt, tri, sph, n)
        return prim[:rays.shape[0]], t[:rays.shape[0]]

    def near_tie(a, b):
        a = torch.where(torch.isfinite(a) & (a < 1e38), a, 1e30)
        b = torch.where(torch.isfinite(b) & (b < 1e38), b, 1e30)
        return (a - b).abs() <= 1e-3 * torch.minimum(a, b) + 1e-5

    def check_find_closest(inp):
        lists, rays, tri, sph, n = inp
        t_k, p_k = find.find_closest(lists, rays, tri, sph, n)
        t_p, p_p = find.find_closest_plain(lists, rays, tri, sph, n)
        dis = p_k != p_p
        n_dis = int(dis.sum())
        if n_dis and not bool(near_tie(t_k[dis], t_p[dis]).all()):
            raise AssertionError(f"find_closest: {n_dis} prim ids differ "
                                 f"beyond the near-tie rule ({FIND_TIE})")
        same = ~dis & (p_k >= 0)
        err = float((t_k[same] - t_p[same]).abs().max()) if same.any() else 0.0
        return err, n_dis, f"{n_dis} of {p_k.numel()} prim ids differ " \
                           f"(near ties), {int((p_k >= 0).sum())} hits"

    def check_find_any(inp):
        lists, rays, tri, sph, n = inp
        o_k = find.find_any(lists, rays, tri, sph, n)
        o_p = find.find_any_plain(lists, rays, tri, sph, n)
        dis = (o_k != o_p).nonzero().squeeze(1)
        if dis.numel():
            # a flag may flip only where the closest occluder lies at the
            # bound (the emissive hit's t) within the near-tie rule
            p_c, t_c = closest_occluder(rays[dis], tri, sph, n)
            bound = rays[dis, 8]
            if not bool(((p_c >= 0) & (bound > 0.0)
                         & near_tie(t_c, bound)).all()):
                raise AssertionError(f"find_any: {dis.numel()} flags differ "
                                     "beyond a near tie with the bound")
        err = float((o_k - o_p).abs().max())
        return err, int(dis.numel()), \
            f"{dis.numel()} of {o_k.numel()} flags differ (near ties), " \
            f"{int(o_k.sum())} occluded"

    def check_fused(kernel, plain):
        def check(inp):
            got, want = kernel(*inp), plain(*inp)
            torch.testing.assert_close(got, want, atol=2e-5, rtol=1e-5)
            inexact = int((got.view(torch.int32) != want.view(torch.int32))
                          .sum())
            return float((got - want).abs().max()), inexact, \
                f"{inexact} of {got.numel()} values not bit-equal"
        return check

    def check_vjp(kernel, plain, ill_of=None):
        def check(inp):
            # the train step's cotangents are ~1e-6 (a mean over every
            # pixel, channel and sample), its VJPs near atol; the VJP is
            # linear in the cotangent, so scaled to unit size it stands
            # well above atol and a wrong kernel cannot pass
            raw = inp[-1]
            inp = (*inp[:-1], checks.unit_cotangent(raw))
            got, want = kernel(*inp), plain(*inp)
            ill = None if ill_of is None else ill_of(*inp)
            n_out = checks.vjp_outside(got, want, ill)
            rows = checks.vjp_check_power(got, want, ill)
            # what the same check could see on the unscaled cotangent
            raw_want = plain(*inp[:-1], raw)
            zero_raw = "fail" if checks.rejects(torch.zeros_like(raw_want),
                                                raw_want, ill) else "pass"
            nz = [k for k in range(raw_want.shape[0])
                  if bool(raw_want[k].any())]
            caught = sum(checks.rejects(checks.flip_row(raw_want, k),
                                        raw_want, ill) for k in nz)
            note = f"cotangent scaled to max 1; {n_out} of {got.shape[1]} " \
                   f"rays outside atol 2e-5 rtol 1e-4 (ill-conditioned, " \
                   f"budget 1%); the check rejects a zero VJP and each of " \
                   f"the {rows} rows with gradient sign-flipped (unscaled, " \
                   f"max |g| {float(raw.abs().max()):.3g}: a zero VJP " \
                   f"would {zero_raw}, a sign flip is caught on {caught} " \
                   f"of {len(nz)} nonzero rows)"
            if ill is not None:
                note += f"; {int(ill.sum())} ill-conditioned rays"
            return float((got - want).abs().max()), n_out, note
        return check

    def kept(idx, vals, n_bins):
        """The histogram's kept entries: in range and not all zero."""
        return (idx >= 0) & (idx < n_bins) & (vals != 0).any(dim=1)

    def check_histogram(inp):
        got = histogram.dense_histogram(*inp)
        again = histogram.dense_histogram(*inp)
        want = histogram.dense_histogram_plain(*inp)
        bits = got.view(torch.int32)
        if not torch.equal(bits, want.view(torch.int32)):
            raise AssertionError("dense_histogram: kernel and plain version "
                                 "differ")
        if not torch.equal(bits, again.view(torch.int32)):
            raise AssertionError("dense_histogram: two launches differ")
        # the wrapper's mask and sort feed kernel and plain version alike;
        # index_add_ on the kept rows does not use them. Two summation
        # orders of a bin's n entries differ by at most 2 n u sum|v|
        # (u = 2^-24, the float32 bound of recursive summation)
        idx, vals, n_bins = inp
        keep = kept(*inp)
        i = idx[keep].long()
        lib = library_histogram(*inp)()
        n = torch.bincount(i, minlength=n_bins).to(torch.float32)[:, None]
        abs_sum = torch.zeros_like(lib).index_add_(0, i, vals[keep].abs())
        err = (got - lib).abs()
        if not bool((err <= 2.0 * n * 2.0 ** -24 * abs_sum).all()):
            raise AssertionError("dense_histogram: differs from index_add_ "
                                 "beyond float32 summation error")
        return 0.0, 0, f"bit-equal to the plain version and across two " \
                       f"launches; within 2 n u sum|v| of index_add_ (max " \
                       f"abs diff {float(err.max()):.3g}); " \
                       f"{int(keep.sum())} of {idx.numel()} entries kept"

    def hit_ill(hf, g):
        return checks.ill_conditioned_lanes(hf, fused.hitrec_math(hf))

    def library_histogram(idx, vals, n_bins):
        """The one PyTorch call for the same sums, on the kept rows."""
        keep = kept(idx, vals, n_bins)
        i, v = idx[keep].long(), vals[keep]
        return lambda: torch.zeros((n_bins, v.shape[1]), device=v.device) \
            .index_add_(0, i, v)

    # bytes and float32 operations each kernel's function needs
    def bytes_of(*tensors, out=()):
        return sum(t.numel() * t.element_size() for t in (*tensors, *out))

    def find_pairs(closest, lists, rays, tri, sph, n):
        """(ray, triangle) tests a find kernel makes on these inputs: the
        walk of ``find_closest_plain`` / ``find_any_plain``, counting each
        lane of a block for every tile the block visits (closest hit), or
        each live lane up to its first occluder (any hit)."""
        RB, BIG = find.RAY_BLOCK, find._BIG
        nc, ck = tri.shape[0], tri.shape[2]
        if n == 0 or nc == 0:
            return 0
        pairs = 0
        for b0, b1 in find._block_chunks(rays.shape[0] // RB, tri):
            rb = rays[b0 * RB:b1 * RB]
            tc = find._sphere_tc(rb, sph)
            if closest:
                bnd = tc.amin(dim=1)
            else:
                occ = torch.where(tc < rb[:, 8, None], tc, BIG).amin(dim=1)
                bnd = torch.where(occ < BIG, -BIG, rb[:, 8])
            bnd = bnd.reshape(b1 - b0, RB)
            rays_b = rb.reshape(b1 - b0, RB, -1)
            lst = lists[b0:b1]
            active = torch.ones(b1 - b0, dtype=torch.bool, device=rays.device)
            for k in range(nc):
                active &= (k < lst[:, 0]) \
                    & (lst[:, 1 + nc + k] < find._worst_bits(bnd))
                blk = active.nonzero().squeeze(1)
                if blk.numel() == 0:
                    break
                t, valid = find._tile_t(tri[lst[blk, 1 + k].long()],
                                        rays_b[blk])
                if closest:
                    pairs += t.numel()
                    tile_t = torch.where(valid, t, BIG).amin(dim=2)
                    bnd[blk] = torch.minimum(bnd[blk], tile_t)
                else:
                    hits = valid & (t < bnd[blk][..., None])
                    hit = hits.any(dim=2)
                    first = hits.to(torch.int32).argmax(dim=2) + 1
                    tested = torch.where(hit, first, ck)
                    pairs += int(torch.where(bnd[blk] > -BIG, tested, 0)
                                 .sum())
                    bnd[blk] = torch.where(hit, -BIG, bnd[blk])
        return pairs

    def find_bound(name, inp):
        lists, rays, tri, sph, n = inp
        pairs = find_pairs(name == "find_closest", *inp)
        ops = pairs * OPS_PER_PAIR \
            + rays.shape[0] * sph.shape[0] * OPS_PER_SPHERE_TEST
        out_bytes = rays.shape[0] * (8 if name == "find_closest" else 4)
        return bytes_of(lists, rays, tri, sph) + out_bytes, ops, \
            f"{pairs} (ray, triangle) tests"

    def stack_bound(plain, inp, n_out_rows):
        stacks = [t for t in inp if hasattr(t, "shape")]
        R = stacks[0].shape[1]
        ops = elementwise_ops_per_ray(torch, plain, stacks) * R
        return bytes_of(*stacks) + n_out_rows * 4 * R, ops, \
            f"{ops / R:.0f} float ops per ray (plain version, counted)"

    def histogram_bound(inp):
        idx, vals, n_bins = inp
        return bytes_of(idx, vals) + n_bins * vals.shape[1] * 4, \
            vals.numel(), "one add per entry and channel"

    kernel_checks = {
        "find_closest": (check_find_closest, find.find_closest,
                         find.find_closest_plain, find.FIND_CLOSEST,
                         lambda i: find_bound("find_closest", i)),
        "find_any": (check_find_any, find.find_any, find.find_any_plain,
                     find.FIND_ANY, lambda i: find_bound("find_any", i)),
        "hitrec_fused": (check_fused(fused.hitrec_fused, fused.hitrec_math),
                         fused.hitrec_fused, fused.hitrec_math, fused.HITREC,
                         lambda i: stack_bound(fused.hitrec_math, i,
                                               fused.NHO)),
        "shade_carry_fused": (
            check_fused(fused.shade_carry_fused, fused.shade_carry_math),
            fused.shade_carry_fused, fused.shade_carry_math, fused.SHADE,
            lambda i: stack_bound(fused.shade_carry_math, i, fused.NSO)),
        "hitrec_bwd": (
            check_vjp(fused.hitrec_bwd, fused.hitrec_vjp_plain, hit_ill),
            fused.hitrec_bwd, fused.hitrec_vjp_plain, fused.HITREC_BWD,
            lambda i: stack_bound(fused.hitrec_vjp_plain, i, fused.NHF)),
        "shade_bwd": (
            check_vjp(fused.shade_bwd, fused.shade_vjp_plain),
            fused.shade_bwd, fused.shade_vjp_plain, fused.SHADE_BWD,
            lambda i: stack_bound(fused.shade_vjp_plain, i, fused.NSF)),
        "dense_histogram": (check_histogram, histogram.dense_histogram,
                            histogram.dense_histogram_plain,
                            histogram.HISTOGRAM, histogram_bound),
    }
    records = {}
    for name, (check, kern, plain, handle, bound_of) in \
            kernel_checks.items():
        cases = [("main", main_inputs), ("fuzz", fuzz_inputs)]
        if name == "dense_histogram":
            cases.append(("wide", {name: wide_inputs}))
        for label, inputs in cases:
            inp = inputs[name]
            err, mismatches, note = check(inp)
            torch.cuda.synchronize()
            shape = tuple(inp[1].shape) if name.startswith(("find", "dense")) \
                else tuple(inp[0].shape)
            line = f"kernel {name} [{label} {shape}]: max_abs_err {err:.3g}; " \
                   f"{note}"
            if label in ("main", "wide"):
                ms = time_ms(torch, lambda: kern(*inp), 20)
                plain_ms = time_ms(torch, lambda: plain(*inp), 5)
                lib_ms = time_ms(torch, library_histogram(*inp), 20) \
                    if name == "dense_histogram" else None
                n_bytes, n_ops, work = bound_of(inp)
                t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
                t_ops = n_ops / F32_FLOPS_PER_S * 1e3
                bound_ms = max(t_bytes, t_ops)
                bound_by = "bytes" if t_bytes >= t_ops else "operations"
                line += f"; kernel {ms:.4f} ms, plain {plain_ms:.3f} ms" \
                        + ("" if lib_ms is None else
                           f", library {lib_ms:.4f} ms") \
                        + f", bound {bound_ms:.4f} ms by {bound_by} " \
                          f"({n_bytes / 1e6:.1f} MB, {n_ops / 1e6:.1f} M " \
                          f"ops: {work}) (median, CUDA events, {smi})"
                rec = dict(
                    name=name, route="cuda", source=handle.source,
                    replaces=handle.replaces.split(" ")[0],
                    launches=None, max_abs_err=err, mismatches=mismatches,
                    ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                    bound_by=bound_by, library_ms=lib_ms, shape=list(shape))
                if label == "main":
                    records[name] = rec
                else:
                    records[name]["wide"] = {k: rec[k] for k in (
                        "shape", "ms", "plain_ms", "bound_ms", "bound_by",
                        "library_ms")}
            log(line)
    del main_inputs, fuzz_inputs, wide_inputs

    def reset_counts():
        torch.cuda.synchronize()
        for k in _cuda.KERNELS:
            k.launches = 0

    def read_counts():
        torch.cuda.synchronize()
        return {k.symbol: k.launches for k in _cuda.KERNELS}

    # ---- 4. the frame, counted ------------------------------------------
    reset_counts()
    t0 = time.perf_counter()
    img = renderer.render_image(scene, cfg)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts()

    expect = {"srt_find_closest": 3 * n_chunks, "srt_find_any": n_chunks,
              "srt_hitrec": 4 * n_chunks, "srt_shade": 4 * n_chunks,
              "srt_hitrec_bwd": 0, "srt_shade_bwd": 0, "srt_histogram": 0}
    log(f"frame launches: {counts} (expected {expect})")
    if counts != expect:
        raise AssertionError(f"launch counts {counts} != {expect}")
    for name, c in kernel_checks.items():
        records[name]["launches_by_path"] = {"frame": counts[c[3].symbol]}

    t0 = time.perf_counter()
    accum = renderer.render_accumulate(scene, cfg)
    torch.cuda.synchronize()
    seconds_again = time.perf_counter() - t0
    if not np.isfinite(accum).all():
        raise AssertionError("non-finite radiance in the frame")
    again = color.to_uint8(color.resolve(accum, spp))
    if not np.array_equal(again, img):
        raise AssertionError("a second frame differs from the first")
    if img.shape != (H, W, 3) or img.std() < 5.0:
        raise AssertionError(f"frame is constant or misshapen: {img.shape}, "
                             f"std {img.std():.2f}")

    # primary rays of every pixel (sample 0): share that hits a triangle
    pid = torch.arange(P, dtype=torch.int32, device=dev)
    keys = rng.ray_keys_2d(base_key, pid, torch.zeros_like(pid))
    ucam = rng.per_ray_uniform_block(keys, 5)
    u = ((pid % W).float() + ucam[:, 0]) / (W - 1)
    v = ((H - (pid // W).float()) + ucam[:, 1]) / (H - 1)
    o, d, tm = camera.get_rays(u, v, ucam[:, 2:5])
    prim, _ = find_hit(scene, o, d, tm)
    tri_share = float(((prim >= 0) & (prim < T)).float().mean())
    log(f"frame: {W}x{H}, mean {img.mean():.2f}, std {img.std():.2f}, "
        f"finite radiance, repeatable; primary rays hitting a triangle "
        f"{100 * tri_share:.2f}%")
    if tri_share < 0.05:
        raise AssertionError(f"only {100 * tri_share:.2f}% of primary rays "
                             "hit a triangle (need >= 5%)")
    write_png(args.out, img)

    # ---- 5. frame time ------------------------------------------------
    paths = P * spp
    mrays = paths * cfg.max_bounce / seconds / 1e6
    log(f"frame time: {seconds:.3f} s for {paths} paths, {mrays:.2f} Mrays/s "
        f"(paths x {cfg.max_bounce}); repeat {seconds_again:.3f} s; {smi}; "
        f"image {args.out}")

    # ---- 6. the train step ----------------------------------------------
    # gradient gate (bench.py:140-199): the card's kernels against the plain
    # versions on the CPU, same loss, pixels, samples and key
    gate_ids = torch.from_numpy(sample_tile_ids(np.random.default_rng(7), W,
                                                H, 4096))

    def gate(device):
        sc = scene.to(device)
        params = {k: v.clone().requires_grad_(True)
                  for k, v in extract_params(sc).items()}
        loss = _loss_fn(
            params, sc, Camera.from_config(cfg.camera, cfg.aspect,
                                           device=device),
            gate_ids.to(device), torch.full((4096, 3), 0.25, device=device),
            0, rng.key(5, device), background.to(device), width=W, height=H,
            spb=2, spp_total=spp, max_bounce=cfg.max_bounce, method="auto",
            last_bounce_vis=vis_ok)
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True)
        return float(loss.detach()), {
            k: (torch.zeros_like(p) if g is None else g).cpu().double()
            for (k, p), g in zip(params.items(), grads)}

    loss_k, g_k = gate(dev)
    loss_p, g_p = gate("cpu")
    rel_v = abs(loss_k - loss_p) / max(abs(loss_p), 1e-12)
    rel_g = {k: float((g_k[k] - g_p[k]).abs().max())
             / max(float(g_p[k].abs().max()), 1e-12) for k in g_p}
    log(f"gradient gate (4096 pixels, spb 2, card vs CPU): loss "
        f"{loss_k:.6f} vs {loss_p:.6f}, rel {rel_v:.2e}; rel grad "
        + ", ".join(f"{k} {v:.2e}" for k, v in rel_g.items()))
    if rel_v > 1e-3 or max(rel_g.values()) > 1e-2:
        raise AssertionError(f"gradient gate failed: rel_loss={rel_v:.2e} "
                             f"rel_grad={max(rel_g.values()):.2e}")

    step, state = train_step_fn()
    params0 = {k: v.clone() for k, v in state.params.items()}
    for i in range(2):  # warm-up
        state, loss = step(state, scene, camera, train_ids, train_tgt,
                           rng.key(100 + i, dev))
    n_steps = 8
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    losses = []
    for i in range(n_steps):
        state, loss = step(state, scene, camera, train_ids, train_tgt,
                           rng.key(i + 1, dev))
        losses.append(loss)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / n_steps
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    expect = {"srt_find_closest": 3 * n_steps, "srt_find_any": n_steps,
              "srt_hitrec": 4 * n_steps, "srt_shade": 4 * n_steps,
              "srt_hitrec_bwd": 4 * n_steps, "srt_shade_bwd": 4 * n_steps,
              "srt_histogram": 4 * n_steps}
    log(f"train launches over {n_steps} steps: {counts} (expected {expect})")
    if counts != expect:
        raise AssertionError(f"launch counts {counts} != {expect}")
    for name, c in kernel_checks.items():
        records[name]["launches_by_path"]["train"] = counts[c[3].symbol]
        records[name]["launches"] = records[name]["launches_by_path"][
            "train" if c[3].symbol.endswith(("_bwd", "histogram"))
            else "frame"]
    losses = [float(x) for x in losses]
    moved = {k: float((state.params[k] - params0[k]).abs().max())
             for k in DEFAULT_TRAINABLE}
    finite = all(bool(torch.isfinite(v).all()) for v in state.params.values())
    log(f"train params moved (max abs): "
        + ", ".join(f"{k} {v:.3g}" for k, v in moved.items())
        + f"; all finite: {finite}; losses {losses[0]:.6f} .. "
          f"{losses[-1]:.6f}")
    if not finite or not all(np.isfinite(losses)) \
            or min(moved.values()) <= 0.0:
        raise AssertionError("a trained parameter did not move or is not "
                             "finite")
    rays = TRAIN_PIXELS * TRAIN_SPB * cfg.max_bounce
    log(f"train step: {step_s * 1e3:.3f} ms, {rays / step_s / 1e6:.2f} "
        f"Mrays/s ({TRAIN_PIXELS} pixels x spb {TRAIN_SPB} x "
        f"{cfg.max_bounce} bounces, mean of {n_steps} steps, host clock); "
        f"peak memory {peak / 2**20:.1f} MiB; {smi}")

    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        with open(args.profile, "w") as f:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                renderer.render_pixels(
                    scene, camera, ids, 0, base_key, background, width=W,
                    height=H, spb=spb, spp_total=spp,
                    max_bounce=cfg.max_bounce,
                    last_bounce_vis=True).sum().item()
            f.write(f"{kind}, {smi}: one {chunk * spb}-path frame chunk\n"
                    + prof.key_averages().table(sort_by="cuda_time_total",
                                                row_limit=40) + "\n")
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                state, loss = step(state, scene, camera, train_ids,
                                   train_tgt, rng.key(99, dev))
                float(loss)
            f.write(f"{kind}, {smi}: one train step of "
                    f"{TRAIN_PIXELS * TRAIN_SPB} paths\n"
                    + prof.key_averages().table(sort_by="cuda_time_total",
                                                row_limit=40) + "\n")
        log(f"profiles of one chunk and one train step written to "
            f"{args.profile}")

    log(json.dumps({"kernels": list(records.values())}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
