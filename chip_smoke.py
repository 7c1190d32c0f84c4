#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--out PNG] [--profile TXT]

Phases, one result line each; any failure raises and the script exits
nonzero without a result line:

1. the device: torch's name for it, and nvidia-smi's name and power limit;
2. the build of the CUDA kernels from ``sexy_raytracer_tpu_torch/csrc``;
3. each kernel against its plain PyTorch version on the same inputs, at the
   main path's shapes (the 524,288-ray chunk through the centre of the
   720p frame) and on a 4,096-ray fuzz wavefront: the find kernels must
   return the same prim ids and occlusion flags, or differ only on near
   ties (for a flag: the closest occluder, emissive spheres excluded, lies
   at the ray's bound), the fused kernels must agree within atol 2e-5,
   rtol 1e-5; median times of both, from CUDA events;
4. a full 1280x720, 8-spp, 4-bounce frame of the flagship stand-in scene
   through ``render_image``, with the launch counters reset before it and
   read after it: every kernel of the path must have run, find 3 times,
   occlusion once, hit record and shade 4 times per chunk; the image must
   vary, the radiance be finite, a second frame be identical, and at least
   5% of primary rays must first hit a triangle;
5. frame time and Mrays/s (paths x 4 bounces).

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


def capture_first_calls(modules, names, run):
    """Run ``run()`` with each wrapper ``names[i]`` of ``modules[i]``
    recording the arguments of its first call; returns {name: args}."""
    seen = {}
    saved = []
    for mod, name in zip(modules, names):
        fn = getattr(mod, name)
        saved.append((mod, name, fn))

        def rec(*args, _fn=fn, _name=name):
            seen.setdefault(_name, tuple(
                a.clone() if hasattr(a, "clone") else a for a in args))
            return _fn(*args)

        setattr(mod, name, rec)
    try:
        run()
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    return seen


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "chip_smoke_720p.png"),
                    help="where to write the frame (PNG)")
    ap.add_argument("--profile", default=None,
                    help="also profile one chunk with torch.profiler and "
                         "write its per-kernel table here")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available()"
                         " is false); the port's kernels need an NVIDIA GPU")

    from sexy_raytracer_tpu_torch.models import presets
    from sexy_raytracer_tpu_torch.ops import _cuda, find, fused
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
                                              data_dir=no_assets)
    scene = scene.to(dev)
    T = scene.num_triangles
    W, H, spp, spb = cfg.width, cfg.height, cfg.samples_per_pixel, \
        cfg.samples_per_batch
    P = W * H
    chunk = min(cfg.rays_per_chunk // spb, P)
    n_chunks = -(-P // chunk)
    log(f"scene: flagship stand-in, {T} triangles in "
        f"{scene.cluster_min.shape[0]} clusters, {scene.num_spheres} "
        f"spheres; {W}x{H}, {spp} spp, {cfg.max_bounce} bounces, "
        f"{chunk * spb} paths per chunk, {n_chunks} chunks")
    camera = Camera.from_config(cfg.camera, cfg.aspect, device=dev)
    base_key = rng.key(cfg.seed, device=dev)
    background = torch.tensor(cfg.background, device=dev)
    order = renderer.tile_pixel_order(W, H)

    # ---- 3. kernels against their plain versions -----------------------
    wrappers = [(find, "find_closest"), (find, "find_any"),
                (integrator, "hitrec_fused"),
                (integrator, "shade_carry_fused")]
    mods, names = zip(*wrappers)

    mid = (n_chunks // 2) * chunk
    ids = torch.from_numpy(order[mid:mid + chunk]).to(dev)
    main_inputs = capture_first_calls(mods, names, lambda: renderer.render_pixels(
        scene, camera, ids, 0, base_key, background, width=W, height=H,
        spb=spb, spp_total=spp, max_bounce=cfg.max_bounce,
        last_bounce_vis=True))

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
    fuzz_inputs = capture_first_calls(
        mods, names, lambda: integrator.trace_rays_fused(
            scene, fo, fd, ft, fkeys, background, cfg.max_bounce,
            last_bounce_vis=True))

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

    checks = {
        "find_closest": (check_find_closest, find.find_closest,
                         find.find_closest_plain, find.FIND_CLOSEST),
        "find_any": (check_find_any, find.find_any, find.find_any_plain,
                     find.FIND_ANY),
        "hitrec_fused": (check_fused(fused.hitrec_fused, fused.hitrec_math),
                         fused.hitrec_fused, fused.hitrec_math, fused.HITREC),
        "shade_carry_fused": (
            check_fused(fused.shade_carry_fused, fused.shade_carry_math),
            fused.shade_carry_fused, fused.shade_carry_math, fused.SHADE),
    }
    records = {}
    for name, (check, kern, plain, handle) in checks.items():
        for label, inputs in (("main", main_inputs), ("fuzz", fuzz_inputs)):
            inp = inputs[name]
            err, mismatches, note = check(inp)
            torch.cuda.synchronize()
            shape = tuple(inp[1].shape) if name.startswith("find") \
                else tuple(inp[0].shape)
            line = f"kernel {name} [{label} {shape}]: max_abs_err {err:.3g}; " \
                   f"{note}"
            if label == "main":
                ms = time_ms(torch, lambda: kern(*inp), 20)
                plain_ms = time_ms(torch, lambda: plain(*inp), 5)
                line += f"; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms " \
                        f"(median, CUDA events, {smi})"
                records[name] = dict(
                    name=name, route="cuda", source=handle.source,
                    replaces=handle.replaces.split(" ")[0],
                    launches=None, max_abs_err=err, mismatches=mismatches,
                    ms=ms, plain_ms=plain_ms)
            log(line)

    # ---- 4. the frame, counted ------------------------------------------
    for k in _cuda.KERNELS:
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img = renderer.render_image(scene, cfg)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = {k.symbol: k.launches for k in _cuda.KERNELS}

    expect = {"srt_find_closest": 3 * n_chunks, "srt_find_any": n_chunks,
              "srt_hitrec": 4 * n_chunks, "srt_shade": 4 * n_chunks}
    log(f"frame launches: {counts} (expected {expect})")
    if counts != expect:
        raise AssertionError(f"launch counts {counts} != {expect}")
    for name, handle in ((n, c[3]) for n, c in checks.items()):
        records[name]["launches"] = counts[handle.symbol]

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

    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            renderer.render_pixels(
                scene, camera, ids, 0, base_key, background, width=W,
                height=H, spb=spb, spp_total=spp, max_bounce=cfg.max_bounce,
                last_bounce_vis=True).sum().item()
        table = prof.key_averages().table(sort_by="cuda_time_total",
                                          row_limit=40)
        with open(args.profile, "w") as f:
            f.write(f"{kind}, {smi}: one {chunk * spb}-path chunk\n{table}\n")
        log(f"profile of one chunk written to {args.profile}")

    log(json.dumps({"kernels": list(records.values())}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
