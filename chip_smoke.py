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
     720p frame: kernel 1 the same prim ids and t bits as its plain walk,
     also at bounces 1 and 2 of the chunk and at bounce 0 of the train
     step, each bounded by the tests its rays need (at bounce 0 beside
     the bound from the listed tests), kernel 2 the same occlusion flags,
     its regrouping pass the same ray table and permutation; the hit
     record (kernel 3) and kernel 4 bit for bit, kernel 4 also on the
     train step's wavefront and at two ragged widths; kernels
     3, 4 and 6 timed beside their copy floors (``fused.stack_copy``),
     kernel 6 also on a copy of its stacks whose rows are not 16-byte
     aligned (it then reads device memory instead of bulk-copying its
     tiles), bit-equal to its output on the stacks;
   * backward kernels on the inputs of one train step (131,072 paths) and
     of the fuzz wavefront's backward: the hit-record and shade VJPs, with
     the cotangent scaled to unit size, within atol 2e-5, rtol 1e-4 of
     autograd of the plain math, with at most 1% of the rays outside and
     those ill-conditioned (``checks.vjp_outside``), and a check shown to
     reject a zero VJP and each gradient row with its sign flipped
     (``checks.vjp_check_power``); the histogram's three passes bit for
     bit against its plan-order plain version and across two launches,
     and within float32 summation error of ``index_add_`` on the kept
     rows, also at the chief atlas's 786,432 bins x 8 channels with
     524,288 entries and where one bin holds 90% of the entries;
   median times of kernel, plain version and (for the histogram) the one
   PyTorch call that computes the same function, from CUDA events, and the
   least time the card could take (bytes over 3.35 TB/s or float32
   operations over 67 TFLOP/s, whichever is larger); the histogram's and
   ``index_add_``'s device time per call and kernels per call from the
   profiler; the host microseconds per kernel launch (``Kernel.launch``
   and ``place``); the same device times of kernel 10's wrapper and
   ``index_copy_``, and of the whole sorted histogram and ``index_add_``
   (phase 8's first A/B shape; read here, early: later profiler runs lost
   events);
4. a full 1280x720, 8-spp, 4-bounce frame of the flagship stand-in scene
   through ``render_image``, with the launch counters reset before it and
   read after it: find 3 times, occlusion and its regrouping pass once,
   hit record and shade 4 times per chunk, no backward kernel; the image must vary, the radiance
   be finite, a second frame be identical, and at least 5% of primary rays
   must first hit a triangle;
5. frame time and Mrays/s (paths x 4 bounces);
6. the train step (bench.py:201-242 on one card): a gradient gate on 4,096
   pixels at spb 2 against the same loss on the CPU (relative loss 1e-3,
   relative gradient 1e-2, bench.py:192), then 2 warm-up and 8 timed steps
   of ``make_train_step`` with ``make_optimizer(params, 1e-3)`` on 32,768
   pixels at spb 4 with the launch counters reset before the timed steps:
   per step find 3, occlusion and its pass 1, hit record 4, shade 4 and
   each backward kernel 4 times; every trained parameter must move and
   stay finite.

7. the big scene, ``flagship_standin(n=389)``: 302,642 triangles in 1,183
   clusters (past the resident find's 120,000-triangle limit and the
   per-ray cull's 512 clusters), its BVH built by the native builder (name
   and time printed):
   * the streamed find (kernel 8) against its plain version at each
     bounce of the mid chunk (524,288 rays; t bit for bit, prim ids equal
     or near ties; timed with the plain version and the bound from the
     tests the rays need, the executed and live tests beside it), and on
     8,192-ray sub-wavefronts of bounce 0 and bounce 1 where the primary
     rays hit the most triangles, and on the fuzz wavefront; occlusion
     (kernel 2) and its regrouping pass against their plain versions on
     the chunk's last-bounce wavefront, timed likewise, flags, ray tables
     and permutations equal; kernels 8 and 2 and the pass on
     ``checks.hard_wavefronts``: most lanes dying on the ground sphere,
     whole blocks dead, and rays through vertices and edges that clusters
     share (exact ties), kernel 2's flags also equal to those that
     kernel 8's closest hits imply (``checks.occlusion_by_closest_hit``);
     the brute-force find (kernel 9) bit for bit
     against its plain version (t bits and ids) on the bounce-0 and
     bounce-1 sub-wavefronts and the fuzz wavefront, timed on bounce 1
     and on the n = 39 stand-in with the mid chunk's 524,288 camera rays
     after a counted run of its own path, ``find_hit(method="pallas_mxu")``,
     with the slices and blocks its wrapper launched, its bound from the
     operations the data needs, and its SASS instructions a test (in
     full, and where the warp stops at each vote; null where the reading
     finds no loop);
   * four referees (streamed, resident on block-culled lists, BVH,
     bruteforce) agree on 65,536 tile-ordered primary rays, with kernel
     1's and kernel 8's times and tests at that shape;
   * a counted 1280x720, ``BIG_SPP``-spp, 4-bounce frame: per chunk the
     streamed find 3 times, occlusion and its pass once, hit record and
     shade 4 times,
     no other kernel; finite, repeatable, at least 5% of primary rays on
     a triangle; its time and Mrays/s.

8. the tools and the reference integrator:
   * the sorted histogram's placement (kernel 10) bit for bit against its
     plain version and across two launches, at the four A/B shapes of
     ``tools.profile histogram``, on all-unique ids and on a fuzz with
     negative and out-of-range ids (C 1 and 3); the whole
     ``dense_histogram_sorted`` within 2 n u max|S| of ``index_add_``, of
     its plain version and of a second call (its float32 cumsum is not
     bitwise repeatable on the card);
     median times of kernel, wrapper, plain versions, ``index_copy_`` and
     ``index_add_``, and the byte bound;
   * ``tools.profile.cmd_histogram`` counted: kernel 10 once per sorted
     call, kernel 7 once per direct call, nothing else;
   * ``trace_rays(fused=False)`` on the train step's 131,072 paths: kernel
     1 once per bounce and nothing else, finite, within the 0.5% mismatch
     budget of the fused integrator; both timed; one backward of the train
     loss on 4,096 pixels through it: kernel 7 once per bounce (the
     atlas), gradients within relative 5e-4 of the fused path's;
   * ``tools.profile`` step and xplane on the stand-in, and
     ``_bigscene_one`` at 3,042 and 304,000 triangles in subprocesses;
     the profiler's device events name every ctypes kernel of the train
     step and the sorted histogram; the phase's seconds.

9. inverse rendering on the card (``inverse_render``, ``Camera.from_params``,
   ``sphere_silhouette_loss``), on the stand-in at 1280x720, 4 bounces:
   * the target is the port's own 16-spp render of the true scene (seed
     7); the atlas's colour channels are perturbed to ``x * 0.3 + 90``
     and only they train (a channel mask), in an ROI around the relief
     (tools/run_inverse_experiment.py phase 1);
   * a common-random-numbers run of 50 steps of 8,192 pixels at spb 16
     (131,072 paths a step), lr 1e-2, after a 2-step warm-up call, with
     the launch counters reset before it and read after it: phase 6's
     counts per step, kernel 5 three times (bounce 0's hit record needs
     no gradient when only the atlas trains), no other kernel; finite
     losses, the last 10 below the first 5 on average, the ROI MSE of a
     16-spp re-render lower than the perturbed scene's, channels 3-7
     bit-equal, channels 0-2 moved; ms a step (the call / 50), Mrays/s,
     the same steps bare (no loop) and the gap to phase 6's step;
   * five steps of stage A of the run's phase 1b: the tile-averaged
     linear loss against the linear target, an 8x coarser atlas delta
     upsampled by a ``param_transform``; finite, the delta moved;
   * the camera gradients of tests/test_grad.py:101-150 on the card
     against the same on CPU tensors (relative loss 1e-3, gradient 1e-2);
   * the silhouette gradient of the iron sphere displaced 0.2 radii in the
     image plane, n_edge 256, on the card against CPU tensors (relative
     1e-2), finite and nonzero, and its time a call.

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
# the big scene: the tools/profile.py terrain, 2 * 389^2 triangles
BIG_N, BIG_SPP = 389, 8


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


# phase 9: the inverse loop (tools/run_inverse_experiment.py phase 1 and
# stage A of phase 1b at the bench's train width)
INV_SEED, INV_SPB, INV_PIXELS, INV_STEPS = 7, 16, 8192, 50
COARSE = 8  # the coarse atlas delta's factor (run_inverse_experiment.py:211)


def resolved_of(torch, acc, spp):
    """Accumulated radiance -> the gamma-2 resolve, clamped to [0, 0.999]
    (inverse.py's loss and tools/run_inverse_experiment.py's target)."""
    return torch.clamp(torch.sqrt(torch.clamp(acc / spp, min=1e-8)), 0.0,
                       0.999)


def inverse_phase(torch, dev, scene, cfg, relief, train_per_step, step6_s,
                  reset_counts, read_counts, smi):
    """Phase 9: ``inverse_render`` and ``sphere_silhouette_loss`` on the
    stand-in at 1280x720, 4 bounces, with the kernels on the card.

    ``relief``: [H, W] bool, the pixels whose primary ray hits the mesh.
    ``train_per_step``: phase 6's launch counts per train step; ``step6_s``
    its seconds per step. Returns the CRN run's launch counts.
    """
    import dataclasses

    from sexy_raytracer_tpu_torch.diff import (
        extract_params,
        inverse_render,
        sphere_silhouette_loss,
    )
    from sexy_raytracer_tpu_torch.diff.inverse import (
        _loss_fn,
        make_optimizer,
        make_train_step,
        sample_tile_ids,
    )
    from sexy_raytracer_tpu_torch.models.scene import SceneBuilder
    from sexy_raytracer_tpu_torch.render import renderer
    from sexy_raytracer_tpu_torch.render.camera import Camera
    from sexy_raytracer_tpu_torch.render.integrator import (
        scene_no_emissive_tris,
    )
    from sexy_raytracer_tpu_torch.utils import rng
    from sexy_raytracer_tpu_torch.utils.mathx import clip

    t9 = time.perf_counter()
    W, H = cfg.width, cfg.height
    cfg16 = dataclasses.replace(cfg, samples_per_pixel=INV_SPB, seed=INV_SEED)
    cam16 = Camera.from_config(cfg16.camera, cfg16.aspect, device=dev)

    def render16(sc):
        return torch.from_numpy(renderer.render_accumulate(sc, cfg16)).to(dev)

    # the target: the port's own 16-spp render of the true scene
    t0 = time.perf_counter()
    target_lin = render16(scene)
    target = resolved_of(torch, target_lin, INV_SPB)
    target_s = time.perf_counter() - t0
    rows = torch.nonzero(relief.any(dim=1))[:, 0]
    cols = torch.nonzero(relief.any(dim=0))[:, 0]
    roi = (max(int(rows[0]) - 8, 0), min(int(rows[-1]) + 9, H),
           max(int(cols[0]) - 8, 0), min(int(cols[-1]) + 9, W))

    # the perturbation of run_inverse_experiment.py:78-98 and its mask
    true_atlas = scene.shade_atlas
    pert_atlas = true_atlas.clone()
    pert_atlas[..., 0:3] = clip(true_atlas[..., 0:3] * 0.3 + 90.0, 0.0,
                                255.0)
    perturbed = scene._replace(shade_atlas=pert_atlas)
    chan = torch.zeros((1, 1, 1, 8), device=dev)
    chan[..., 0:3] = 1.0
    kw = dict(pixels_per_step=INV_PIXELS, spb=INV_SPB, learning_rate=1e-2,
              seed=7, trainable=("shade_atlas",),
              grad_masks={"shade_atlas": chan}, roi=roi, loss_type="mse",
              crn_key=rng.key(INV_SEED, dev), progress=False)
    inverse_render(perturbed, target, cfg16, n_steps=2, **kw)  # warm-up
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    opt, losses = inverse_render(perturbed, target, cfg16,
                                 n_steps=INV_STEPS, **kw)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / INV_STEPS
    counts = read_counts()
    # phase 6's counts per step, but kernel 5 at bounces 1-3 only: with the
    # atlas the one trained field, bounce 0's hit record has no input that
    # needs a gradient (the camera and the geometry are constants)
    expect = {k: INV_STEPS * v for k, v in train_per_step.items()}
    expect["srt_hitrec_bwd"] = INV_STEPS * (train_per_step["srt_hitrec_bwd"]
                                            - 1)
    log(f"inverse launches over {INV_STEPS} CRN steps: {counts} (expected "
        f"{expect}: phase 6's per step, kernel 5 at bounces 1-3)")
    if counts != expect:
        raise AssertionError(f"launch counts {counts} != {expect}")

    first5, last10 = float(np.mean(losses[:5])), float(np.mean(losses[-10:]))
    r0, r1, c0, c1 = roi

    def roi_mse(sc):
        img = resolved_of(torch, render16(sc), INV_SPB)
        return float(((img - target)[r0:r1, c0:c1] ** 2).mean())

    mse_pert, mse_opt = roi_mse(perturbed), roi_mse(opt)
    same37 = torch.equal(opt.shade_atlas[..., 3:], true_atlas[..., 3:])
    moved = float((opt.shade_atlas[..., 0:3] - pert_atlas[..., 0:3]).abs()
                  .max())
    rays = INV_PIXELS * INV_SPB * cfg.max_bounce
    log(f"inverse CRN run: {INV_STEPS} steps of {INV_PIXELS} pixels x spb "
        f"{INV_SPB} in ROI {roi} (target {target_s:.2f} s); losses "
        f"first 5 {first5:.6g}, last 10 {last10:.6g}; ROI MSE of a 16-spp "
        f"re-render: perturbed {mse_pert:.6g}, result {mse_opt:.6g}; atlas "
        f"channels 3-7 bit-equal: {same37}, channels 0-2 moved (max abs) "
        f"{moved:.4g}")
    if not np.isfinite(losses).all() or not last10 < first5 \
            or not mse_opt < mse_pert or not same37 or not moved > 0.0:
        raise AssertionError("the CRN inverse run did not converge as "
                             "required")

    # the bare steps of the same run (optimiser, masks, key, and the
    # loop's tile draws with their target rows, made and uploaded first)
    # without the loop around them
    params = {"shade_atlas": pert_atlas}
    bare = make_train_step(
        cfg16, make_optimizer(params, 1e-2, decay_steps=INV_STEPS),
        spb=INV_SPB, grad_masks={"shade_atlas": chan},
        last_bounce_vis=scene_no_emissive_tris(scene))
    draws = np.random.default_rng(kw["seed"])
    ids = [torch.from_numpy(sample_tile_ids(draws, W, H, INV_PIXELS,
                                            roi=roi)).to(dev)
           for _ in range(INV_STEPS)]
    tgts = [target.reshape(-1, 3)[i] for i in ids]
    st = bare.init(params)
    for i in range(2):
        st, _ = bare(st, perturbed, cam16, ids[i], tgts[i], kw["crn_key"])
    st = bare.init(params)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(INV_STEPS):
        st, _ = bare(st, perturbed, cam16, ids[i], tgts[i], kw["crn_key"])
    torch.cuda.synchronize()
    bare_s = (time.perf_counter() - t0) / INV_STEPS
    log(f"inverse step: {step_s * 1e3:.3f} ms, "
        f"{rays / step_s / 1e6:.2f} Mrays/s ({INV_PIXELS} pixels x spb "
        f"{INV_SPB} x {cfg.max_bounce} bounces, the {INV_STEPS}-step call "
        f"synchronized / {INV_STEPS}, host clock); the same step bare "
        f"{bare_s * 1e3:.3f} ms, loop overhead {(step_s - bare_s) * 1e3:.3f}"
        f" ms; phase 6's step {step6_s * 1e3:.3f} ms, gap "
        f"{(step_s - step6_s) * 1e3:.3f} ms; {smi}")

    # stage A of phase 1b: no CRN, the tile-averaged linear loss against
    # the linear target, optimising an 8x coarser atlas delta
    L, AH, AW, _ = pert_atlas.shape

    def transform_a(p):
        delta = p["d8"].repeat_interleave(COARSE, 1) \
            .repeat_interleave(COARSE, 2)
        atlas = torch.cat([pert_atlas[..., 0:3] + delta, pert_atlas[..., 3:]],
                          dim=-1)
        return {"shade_atlas": clip(atlas, 0.0, 255.0)}

    d8 = torch.zeros((L, AH // COARSE, AW // COARSE, 3), device=dev)
    opt_a, losses_a = inverse_render(
        perturbed, target_lin / INV_SPB, cfg16, n_steps=5,
        pixels_per_step=INV_PIXELS, spb=INV_SPB, learning_rate=0.5, seed=13,
        init_params={"d8": d8}, param_transform=transform_a, roi=roi,
        loss_type="tile_linear", huber_delta=0.5, progress=False)
    moved_a = float((opt_a.shade_atlas[..., 0:3] - pert_atlas[..., 0:3])
                    .abs().max())
    log(f"inverse non-CRN run (tile_linear, coarse {COARSE}x delta "
        f"{tuple(d8.shape)}, 5 steps): losses "
        + ", ".join(f"{x:.6g}" for x in losses_a)
        + f"; atlas colour moved (max abs) {moved_a:.4g}")
    if not np.isfinite(losses_a).all() or not moved_a > 0.0 \
            or not torch.equal(opt_a.shade_atlas[..., 3:],
                               pert_atlas[..., 3:]):
        raise AssertionError("the non-CRN inverse run failed")

    # camera gradients (tests/test_grad.py:101-150) on the card against
    # the same on CPU tensors, bench.py:192's gate
    def camera_grads(device):
        b = SceneBuilder()
        b.add_sphere((0, 0, 0), 1.0,
                     b.add_pbr_material(base_color=(0.7, 0.6, 0.5, 1.0),
                                        metallic=0.2, roughness=0.5))
        sc = b.build(build_bvh=False, device=device)
        eye = torch.tensor([0.0, 0.0, 4.0], device=device, requires_grad=True)
        vfov = torch.tensor(40.0, device=device, requires_grad=True)
        cam = Camera.from_params(eye, torch.zeros(3, device=device),
                                 torch.tensor([0.0, 1.0, 0.0], device=device),
                                 vfov, 1.0, 0.0, 4.0)
        pix = torch.tensor([16 * 7 + 7, 16 * 7 + 8, 16 * 8 + 7, 16 * 8 + 8],
                           dtype=torch.int32, device=device)
        loss = _loss_fn(extract_params(sc, ("mat_base_color",)), sc, cam,
                        pix, torch.full((4, 3), 0.5, device=device), 0,
                        rng.key(1, device),
                        torch.tensor((0.6, 0.7, 0.8), device=device),
                        width=16, height=16, spb=4, spp_total=4,
                        max_bounce=2, method="auto")
        g = torch.autograd.grad(loss, [eye, vfov])
        return float(loss.detach()), [x.detach().cpu().double() for x in g]

    loss_k, g_k = camera_grads(dev)
    loss_p, g_p = camera_grads("cpu")
    rel_v = abs(loss_k - loss_p) / max(abs(loss_p), 1e-12)
    rel_g = [float((a - b).abs().max()) / max(float(b.abs().max()), 1e-12)
             for a, b in zip(g_k, g_p)]
    log(f"camera gradients (card vs CPU): loss {loss_k:.6f} vs {loss_p:.6f}"
        f", rel {rel_v:.2e}; d/d eye {g_k[0].tolist()} vs {g_p[0].tolist()},"
        f" d/d vfov {float(g_k[1]):.6g} vs {float(g_p[1]):.6g}; rel grad "
        f"{rel_g[0]:.2e}, {rel_g[1]:.2e}")
    if rel_v > 1e-3 or max(rel_g) > 1e-2 or float(g_p[0].abs().max()) == 0:
        raise AssertionError("camera gradient gate failed")

    # the silhouette gradient of the iron sphere, displaced 0.2 radii in
    # the image plane, against the true target
    iron = int(torch.nonzero((scene.sph_c0.cpu() == torch.tensor(
        [-3.0, 1.0, 0.0])).all(dim=1))[0, 0])
    radius = float(scene.sph_radius[iron])
    shift = 0.2 * radius * (0.8 * cam16.u_axis + 0.6 * cam16.v_axis)
    center = scene.sph_c0[iron] + shift

    def silhouette(device):
        sc = scene.to(device)
        c = center.to(device).clone().requires_grad_(True)

        def put(field):
            return torch.cat([field[:iron], c[None], field[iron + 1:]])

        sc = sc._replace(sph_c0=put(sc.sph_c0), sph_c1=put(sc.sph_c1))
        loss = sphere_silhouette_loss(
            sc, Camera.from_config(cfg16.camera, cfg16.aspect, device=device),
            target.to(device), [iron], rng.key(INV_SEED, device), width=W,
            height=H, max_bounce=cfg.max_bounce, background=cfg.background,
            n_edge=256)
        (g,) = torch.autograd.grad(loss, c)
        return float(loss.detach()), g.detach().cpu().double()

    value, g_sk = silhouette(dev)
    _, g_sp = silhouette("cpu")
    sil_ms = time_ms(torch, lambda: silhouette(dev), 5)
    rel_s = float((g_sk - g_sp).norm() / max(float(g_sp.norm()), 1e-30))
    log(f"silhouette (iron sphere {iron} moved {shift.tolist()}, n_edge "
        f"256, {W}x{H}): value {value}, grad card {g_sk.tolist()} vs CPU "
        f"{g_sp.tolist()}, rel {rel_s:.2e}; {sil_ms:.3f} ms a call with its "
        f"gradient (median of 5, CUDA events, {smi})")
    if not bool(torch.isfinite(g_sk).all()) or float(g_sk.norm()) == 0.0 \
            or rel_s > 1e-2:
        raise AssertionError("silhouette gradient gate failed")
    log(f"phase 9: {time.perf_counter() - t9:.1f} s")
    return counts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "chip_smoke_720p.png"),
                    help="where to write the frame (PNG)")
    ap.add_argument("--profile", default=None,
                    help="also profile one frame chunk, one train step and "
                         "one chunk of the big frame with torch.profiler "
                         "and write their per-kernel tables here")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available()"
                         " is false); the port's kernels need an NVIDIA GPU")

    from sexy_raytracer_tpu_torch.diff.inverse import _loss_fn, sample_tile_ids
    from sexy_raytracer_tpu_torch.diff.params import (
        DEFAULT_TRAINABLE,
        extract_params,
    )
    from sexy_raytracer_tpu_torch import checks
    from sexy_raytracer_tpu_torch.models import bvh, presets
    from sexy_raytracer_tpu_torch.models.scene import MAT_LIGHT
    from sexy_raytracer_tpu_torch.ops import (
        _cuda,
        brute,
        find,
        fused,
        histogram,
        intersect,
    )
    from sexy_raytracer_tpu_torch.ops.intersect import find_hit
    from sexy_raytracer_tpu_torch.render import integrator, renderer
    from sexy_raytracer_tpu_torch.render.camera import Camera
    from sexy_raytracer_tpu_torch.tools import (
        find_split,
        histogram_split,
        shade_split,
    )
    from sexy_raytracer_tpu_torch.tools.histogram_split import (
        TRAIN_PIXELS,
        TRAIN_SPB,
        capture_calls,
        run_steps,
    )
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
    # the flagship stand-in at 720p, 8 spp, and the bench's train step
    scene, cfg, camera, train_ids, train_tgt, train_step_fn = \
        histogram_split.train_setup(dev)
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
    base_key = rng.key(cfg.seed, device=dev)
    background = torch.tensor(cfg.background, device=dev)
    order = renderer.tile_pixel_order(W, H)
    vis_ok = integrator.scene_no_emissive_tris(scene)

    # ---- 3. kernels against their plain versions -----------------------
    K1_WARP_RAYS = 32 * find.FIND_RAYS_PER_LANE   # rays of a kernel-1 warp
    fwd_wrappers = [(find, "find_closest"), (find, "any_regroup"),
                    (find, "find_any"),
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

    # kernel 1 at bounces 1 and 2 of the same chunk (the record's rows
    # keep bounce 0)
    later_bounces = {f"bounce {b}": v for b, v in enumerate(capture_calls(
        [find], ["find_closest"], lambda: renderer.render_pixels(
            scene, camera, ids, 0, base_key, background, width=W, height=H,
            spb=spb, spp_total=spp, max_bounce=cfg.max_bounce,
            last_bounce_vis=True))["find_closest"]) if b}
    # the backward's last call is bounce 0's: the most live rays; the
    # forward's first, bounce 0's (kernels 1 and 4 on the train wavefront)
    train_calls = capture_calls(
        *zip(*(bwd_wrappers + [(find, "find_closest"),
                               (integrator, "shade_carry_fused")])),
        one_train_step)
    main_inputs.update({k: train_calls[k][-1] for _, k in bwd_wrappers})
    train_inputs = {k: train_calls[k][0]
                    for k in ("find_closest", "shade_carry_fused")}
    del train_calls

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

    # the chief atlas's size (786,432 bins x 8, 524,288 entries), and one
    # bin holding 90% of the train step's 131,072 entries
    wide_inputs = histogram_split.wide_input(dev)
    skew_inputs = histogram_split.skewed_input(dev)

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

    def near_tie(a, b):
        a = torch.where(torch.isfinite(a) & (a < 1e38), a, 1e30)
        b = torch.where(torch.isfinite(b) & (b < 1e38), b, 1e30)
        return (a - b).abs() <= 1e-3 * torch.minimum(a, b) + 1e-5

    def check_find_closest(inp):
        t_k, p_k = find.find_closest(*inp)
        t_p, p_p = find.find_streamed_plain(*inp)
        t_dis = t_k.view(torch.int32) != t_p.view(torch.int32)
        if not torch.equal(p_k, p_p) or bool(t_dis.any()):
            raise AssertionError(
                f"find_closest: {int((p_k != p_p).sum())} prim ids and "
                f"{int(t_dis.sum())} t differ from the plain walk")
        return 0.0, 0, f"prim ids and t bit-equal to the plain walk, " \
                       f"{int((p_k >= 0).sum())} hits, " \
                       f"{int(((p_k >= 0) & (p_k < T)).sum())} on triangles"

    def check_any_regroup(inp):
        got = find.any_regroup(*inp)
        want = find.any_regroup_plain(*inp)
        for name, g, w in zip(("rays", "perm", "cull t_min", "cull t_max"),
                              got, want):
            if not torch.equal(g.view(torch.int32), w.view(torch.int32)):
                raise AssertionError(f"any_regroup: {name} differs from the "
                                     "plain version")
        live = int((got[0][:, 8] >= 0.0).sum())
        return 0.0, 0, f"rays, perm and cull bounds bit-equal to the " \
                       f"plain version; {live} of {got[0].shape[0]} rays live"

    def check_find_any(inp):
        o_k = find.find_any(*inp)
        o_p = find.find_any_plain(*inp)
        n_dis = int((o_k != o_p).sum())
        if n_dis:
            raise AssertionError(f"find_any: {n_dis} flags differ from the "
                                 "plain version")
        live = int((inp[1][:, 8] >= 0.0).sum())
        return 0.0, 0, f"flags equal; {int(o_k.sum())} of {o_k.numel()} " \
                       f"occluded; {live} live rays regrouped into " \
                       f"{-(-live // find.RAY_BLOCK)} blocks"

    def check_fused(kernel, plain):
        def check(inp):
            got, want = kernel(*inp), plain(*inp)
            inexact = int((got.view(torch.int32) != want.view(torch.int32))
                          .sum())
            if inexact:
                raise AssertionError(f"{inexact} values differ from the "
                                     "plain version's bits")
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
        # index_add_ on the kept rows shares nothing with the kernel's
        # passes or the plan-order plain version. Two summation
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

    def walk_bound(closest, scene_of, warp_rays=checks.WALK_WARP_RAYS):
        """Bound of kernels 1 and 8 (closest) and 2 from the tests these
        inputs need (``checks.walk_counts``, warps of ``warp_rays`` rays),
        with the executed, live and listed counts beside it. Bytes: of the
        worklists, each row's count and its live entries (an id and an
        entry distance each); every other input and the output whole."""
        def bound(inp):
            sc_ = scene_of(inp)
            c = checks.walk_counts(closest, inp, sc_.cluster_min,
                                   sc_.cluster_max, warp_rays)
            lists, rays = inp[0], inp[1]
            n_sph = inp[4].shape[0] if closest else 0
            ops = c["needed"] * OPS_PER_PAIR \
                + rays.shape[0] * n_sph * OPS_PER_SPHERE_TEST
            out = rays.shape[0] * (8 if closest else 4)
            list_bytes = 4 * (lists.shape[0] + 2 * int(lists[:, 0].sum()))
            return list_bytes + out + bytes_of(
                *(x for x in inp[1:] if hasattr(x, "shape"))), ops, \
                f"{c['needed']} needed (ray, triangle) tests, " \
                f"{c['live']} live, {c['executed']} executed, " \
                f"{c['listed']} listed"
        return bound

    def regroup_bound(inp):
        org, dir, time, t_min, t_bound, sph = inp
        R = org.shape[0]
        Rpad = -(-R // find.RAY_BLOCK) * find.RAY_BLOCK
        # the ray table, perm and the cull's two bounds out
        return bytes_of(org, dir, time, t_min, t_bound, sph) \
            + Rpad * 4 * (9 + 1 + 2), \
            R * sph.shape[0] * OPS_PER_SPHERE_TEST, \
            f"{R} rays x {sph.shape[0]} sphere tests"

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
                         find.find_streamed_plain, find.FIND_CLOSEST,
                         walk_bound(True, lambda i: scene, K1_WARP_RAYS)),
        "any_regroup": (check_any_regroup, find.any_regroup,
                        find.any_regroup_plain, find.ANY_REGROUP,
                        regroup_bound),
        "find_any": (check_find_any, find.find_any, find.find_any_plain,
                     find.FIND_ANY, walk_bound(False, lambda i: scene)),
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
    def check_only(name, inp, check, label):
        """Hold a kernel to its plain version on ``inp``; log one line."""
        err, _, note = check(inp)
        torch.cuda.synchronize()
        log(f"kernel {name} [{label} {tuple(shape_of(name, inp))}]: "
            f"max_abs_err {err:.3g}; {note}")

    def shape_of(name, inp):
        """The wavefront's shape: the stack for the fused kernels, the ray
        table (or the histogram's values) for the others."""
        return list(inp[0 if name.startswith(("hitrec", "shade")) else 1]
                    .shape)

    def record(name, handle, inp, check, kern, plain, bound_of, label,
               reps=20, plain_reps=5, library=None):
        """Hold a kernel to its plain version on ``inp``, time both (and
        ``library``, the one PyTorch call for the same function, where
        there is one) with CUDA events, compute the bound; log one line and
        return the kernel's record."""
        err, mismatches, note = check(inp)
        torch.cuda.synchronize()
        ms = time_ms(torch, lambda: kern(*inp), reps)
        plain_ms = time_ms(torch, lambda: plain(*inp), plain_reps)
        lib_ms = None if library is None else time_ms(torch, library, reps)
        n_bytes, n_ops, work = bound_of(inp)
        t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
        t_ops = n_ops / F32_FLOPS_PER_S * 1e3
        bound_ms = max(t_bytes, t_ops)
        bound_by = "bytes" if t_bytes >= t_ops else "operations"
        shape = shape_of(name, inp)
        log(f"kernel {name} [{label} {tuple(shape)}]: max_abs_err {err:.3g}; "
            f"{note}; kernel {ms:.4f} ms, plain {plain_ms:.3f} ms"
            + ("" if lib_ms is None else f", library {lib_ms:.4f} ms")
            + f", bound {bound_ms:.4f} ms by {bound_by} ({n_bytes / 1e6:.1f} "
              f"MB, {n_ops / 1e6:.1f} M ops: {work}) (median, CUDA events, "
              f"{smi})")
        return dict(name=name, route="cuda", source=handle.source,
                    replaces=handle.replaces.split(" ")[0], launches=None,
                    max_abs_err=err, mismatches=mismatches, ms=ms,
                    plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                    library_ms=lib_ms, shape=shape, case=label, work=work)

    records = {}
    for name, (check, kern, plain, handle, bound_of) in \
            kernel_checks.items():
        hist = name == "dense_histogram"
        inp = main_inputs[name]
        records[name] = record(
            name, handle, inp, check, kern, plain, bound_of, "main",
            library=library_histogram(*inp) if hist else None)
        check_only(name, fuzz_inputs[name], check, "fuzz")
        if hist:
            for label, hin in (("wide", wide_inputs), ("skewed", skew_inputs)):
                rec = record(name, handle, hin, check, kern, plain, bound_of,
                             label, library=library_histogram(*hin))
                records[name][label] = {k: rec[k] for k in (
                    "shape", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms")}

    # kernel 1 at bounces 1 and 2 of the chunk and at bounce 0 of the
    # train step, each bounded by the tests its rays need; at bounce 0 also
    # the bound from the listed tests (every lane of a block on every tile
    # the block visits: what the first kernel 1 executed)
    keys1 = ("case", "shape", "ms", "plain_ms", "bound_ms", "bound_by",
             "work")
    k1 = records["find_closest"]
    k1["bounces"] = [{k: k1[k] for k in keys1}]
    for label, inp in (*later_bounces.items(),
                       ("train bounce 0", train_inputs["find_closest"])):
        rec = record("find_closest", find.FIND_CLOSEST, inp,
                     check_find_closest, find.find_closest,
                     find.find_streamed_plain,
                     kernel_checks["find_closest"][4], label, 20, 3)
        k1["bounces"].append({k: rec[k] for k in keys1})
    inp = main_inputs["find_closest"]
    listed = checks.walk_counts(True, inp, scene.cluster_min,
                                scene.cluster_max)["listed"]
    lists, rays, pack, boxes, sph, _ = inp
    listed_ms = max(
        bytes_of(lists, rays, pack, sph) / HBM_BYTES_PER_S * 1e3
        + rays.shape[0] * 8 / HBM_BYTES_PER_S * 1e3,
        (listed * OPS_PER_PAIR + rays.shape[0] * sph.shape[0]
         * OPS_PER_SPHERE_TEST) / F32_FLOPS_PER_S * 1e3)
    k1["listed_bound_ms"] = listed_ms
    log(f"kernel find_closest [main]: bound {k1['bound_ms']:.4f} ms from "
        f"the tests its rays need; {listed_ms:.4f} ms from the {listed} "
        f"listed tests (every lane of a block on every tile it visits)")
    del later_bounces

    # kernel 4 beside its copy floor (the same stacks streamed by a kernel
    # of the first shade kernel's shape that does no shading), on the
    # train wavefront, and at two ragged widths: R - 3 (not a multiple of
    # 4: no bulk copy) and a last tile of 4 rays
    k4 = records["shade_carry_fused"]
    sf, si = main_inputs["shade_carry_fused"]
    copy = fused.stack_copy(sf, si)
    if not torch.equal(copy.view(torch.int32),
                       fused.stack_copy_plain(sf, si).view(torch.int32)):
        raise AssertionError("stack_copy: kernel and plain version differ")
    k4["copy_ms"] = time_ms(torch, lambda: fused.stack_copy(sf, si), 20)
    log(f"kernel shade_carry_fused [main]: copy floor {k4['copy_ms']:.4f} ms "
        f"(stack_copy, median, CUDA events), kernel {k4['ms']:.4f} ms, bound "
        f"{k4['bound_ms']:.4f} ms ({smi})")
    rec = record("shade_carry_fused", fused.SHADE,
                 train_inputs["shade_carry_fused"], kernel_checks[
                     "shade_carry_fused"][0], fused.shade_carry_fused,
                 fused.shade_carry_math,
                 lambda i: stack_bound(fused.shade_carry_math, i, fused.NSO),
                 "train bounce 0")
    k4["train"] = {k: rec[k] for k in keys1[:-1]}
    R = sf.shape[1]
    tile = fused.SHADE_TILE_RAYS
    for label, r in (("R - 3", R - 3),
                     ("last tile of 4", (R // tile - 1) * tile + 4)):
        check_only("shade_carry_fused",
                   (sf[:, :r].contiguous(), si[:, :r].contiguous()),
                   kernel_checks["shade_carry_fused"][0], label)
    del train_inputs, copy, sf, si

    # kernels 3 (frame chunk) and 6 (train step) beside their copy floors,
    # and kernel 6 on a copy of the same stacks whose base lies 4 bytes
    # past a 16-byte boundary (it then reads device memory, not its bulk
    # copy), which must give the same bits
    floors = {"hitrec_fused": lambda hf: ((hf,), None, fused.NHO),
              "shade_bwd": lambda sf, si, g: ((sf, g), si, fused.NSF)}
    for name, floor in floors.items():
        rec, inp, kern = records[name], main_inputs[name], \
            kernel_checks[name][1]
        f32, ints, n_out = floor(*inp)
        f32 = torch.cat(f32)
        if not torch.equal(
                fused.stack_copy(f32, ints, n_out).view(torch.int32),
                fused.stack_copy_plain(f32, ints, n_out).view(torch.int32)):
            raise AssertionError(f"stack_copy ({name}'s stacks): kernel and "
                                 "plain version differ")
        rec["copy_ms"] = time_ms(
            torch, lambda: fused.stack_copy(f32, ints, n_out), 20)
        text = ""
        if name == "shade_bwd":
            off = tuple(shade_split.unaligned(x) for x in inp)
            n_dis = int((kern(*inp).view(torch.int32)
                         != kern(*off).view(torch.int32)).sum())
            if n_dis:
                raise AssertionError(f"{name}: {n_dis} values differ on a "
                                     "copy of its stacks that is not "
                                     "aligned")
            rec["unaligned_ms"] = time_ms(torch, lambda: kern(*off), 20)
            text = (f"{rec['unaligned_ms']:.4f} ms on a copy whose rows "
                    "are not 16-byte aligned (bit-equal), ")
            del off
        log(f"kernel {name} [main]: copy floor {rec['copy_ms']:.4f} ms "
            f"(stack_copy), kernel {rec['ms']:.4f} ms, {text}bound "
            f"{rec['bound_ms']:.4f} ms (median, CUDA events, {smi})")
        del f32, ints

    # device time per call from the profiler's device events (CUDA events
    # around one call also count the host's launch gaps), early in the
    # process: profiler runs long after the first one lost device events
    def ms_text(ms):
        return "not measured (events lost)" if ms is None else f"{ms:.4f} ms"

    # kernel 7's device time per call, split by kernel, beside index_add_'s
    for label, hin in (("main", main_inputs["dense_histogram"]),
                       ("wide", wide_inputs), ("skewed", skew_inputs)):
        dev_ms, n_k, by = histogram_split.device_split(
            lambda: histogram.dense_histogram(*hin))
        lib_ms, lib_k, _ = histogram_split.device_split(
            library_histogram(*hin))
        stats = histogram_split.segment_stats(*hin)
        log(f"dense_histogram [{label}] device time per call by the "
            f"profiler: {ms_text(dev_ms)} in {n_k:g} kernels ("
            + ", ".join(f"{k.split('::')[-1].split('(')[0]} {v:.4f}"
                        for k, v in by.items())
            + f"); index_add_ {ms_text(lib_ms)} in {lib_k:g} kernels; "
              f"{stats['kept']} of {stats['entries']} entries kept, longest "
              f"segment {stats['longest_segment']}, {stats['bins_hit']} bins "
              f"hit ({smi})")
        if n_k > 3:
            raise AssertionError(f"dense_histogram [{label}]: {n_k:g} device "
                                 "kernels per call (at most 3)")
        sub = records["dense_histogram"] if label == "main" \
            else records["dense_histogram"][label]
        sub.update(device_ms=dev_ms, kernels_per_call=n_k,
                   library_device_ms=lib_ms, segments=stats)

    # the launch path every kernel shares, on a launch that does no work
    lp = histogram_split.launch_path_us(dev)
    log(f"launch path, host us per call over {lp['calls']} calls ({smi}): "
        f"Kernel.launch {lp['launch_us']:.2f}, place() {lp['place_us']:.2f}")
    # kernel 10 (reported with its phase 8.1 record) and index_copy_, the
    # whole sorted histogram and index_add_, at the tools' first A/B case
    dev10 = histogram_split.place_split(dev)
    log(f"device time per call by the profiler (atlas coherent, {smi}): "
        + "; ".join(f"{k} {ms_text(v[0])} in {v[1]:g} kernels"
                    for k, v in dev10.items())
        + "; place_kernel alone " + (", ".join(
            f"{v:.4f} ms" for name, v in dev10["place"][2].items()
            if "place_kernel" in name) or "not among the events"))
    del main_inputs, fuzz_inputs, wide_inputs, skew_inputs

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

    expect = {k.symbol: 0 for k in _cuda.KERNELS}
    expect.update({"srt_find_closest": 3 * n_chunks, "srt_find_any": n_chunks,
                   "srt_any_regroup": n_chunks,
                   "srt_hitrec": 4 * n_chunks, "srt_shade": 4 * n_chunks})
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
    relief = ((prim >= 0) & (prim < T)).reshape(H, W)
    tri_share = float(relief.float().mean())
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
    train_args = (scene, camera, train_ids, train_tgt)
    state, _, _ = run_steps(step, state, *train_args, 2, 100, dev)  # warm-up
    n_steps = 8
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    state, losses, step_s = run_steps(step, state, *train_args, n_steps, 1,
                                      dev)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    expect = {k.symbol: 0 for k in _cuda.KERNELS}
    expect.update({"srt_find_closest": 3 * n_steps, "srt_find_any": n_steps,
                   "srt_any_regroup": n_steps,
                   "srt_hitrec": 4 * n_steps, "srt_shade": 4 * n_steps,
                   "srt_hitrec_bwd": 4 * n_steps,
                   "srt_shade_bwd": 4 * n_steps,
                   "srt_histogram": 4 * n_steps})
    log(f"train launches over {n_steps} steps: {counts} (expected {expect})")
    if counts != expect:
        raise AssertionError(f"launch counts {counts} != {expect}")
    train_per_step = {k: v // n_steps for k, v in expect.items()}
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


    # ---- 7. the big scene -----------------------------------------------
    # the tools/profile.py terrain size: 302,642 triangles, past the
    # resident find's limit and the per-ray cull's
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as no_assets:
        big, big_cfg = presets.flagship_standin(
            n=BIG_N, spp=BIG_SPP, height=720, data_dir=no_assets, device=dev)
    scene_s = time.perf_counter() - t0
    TB = big.num_triangles
    n_prims = TB + big.num_spheres
    builder = bvh.builder_for(n_prims)
    t0 = time.perf_counter()
    tree = bvh.build_bvh(big)
    bvh_s = time.perf_counter() - t0
    big = big._replace(**{
        f"bvh_{k}": torch.from_numpy(getattr(tree, v)).to(dev) for k, v in
        (("min", "node_min"), ("max", "node_max"), ("left", "left"),
         ("right", "right"), ("skip", "skip"))})
    NCB = big.cluster_min.shape[0]
    if TB <= intersect.PALLAS_RESIDENT_MAX_TRIS \
            or NCB <= find.PER_RAY_CULL_MAX_CLUSTERS:
        raise AssertionError("the big scene is not past the resident limits")
    big_spb = min(big_cfg.samples_per_batch, BIG_SPP)
    big_chunk = min(big_cfg.rays_per_chunk // big_spb, P)
    big_chunks = -(-P // big_chunk)

    def camera_rays(pixel_ids, n_samples):
        """The primary rays render_pixels traces for these pixels."""
        pid = pixel_ids.repeat_interleave(n_samples)
        sid = torch.arange(n_samples, dtype=torch.int32,
                           device=dev).repeat(pixel_ids.shape[0])
        k = rng.ray_keys_2d(base_key, pid, sid)
        uc = rng.per_ray_uniform_block(k, 5)
        u = ((pid % W).float() + uc[:, 0]) / (W - 1)
        v = ((H - (pid // W).float()) + uc[:, 1]) / (H - 1)
        return camera.get_rays(u, v, uc[:, 2:5])

    # 7.1 kernels 8, 2 and 9 against their plain versions
    big_ids = torch.from_numpy(order[mid:mid + big_chunk]).to(dev)
    big_calls = capture_calls([find, find, find],
                              ["find_streamed", "any_regroup", "find_any"],
                              lambda: renderer.render_pixels(
                                  big, camera, big_ids, 0, base_key,
                                  background, width=W, height=H,
                                  spb=big_spb, spp_total=BIG_SPP,
                                  max_bounce=big_cfg.max_bounce,
                                  last_bounce_vis=True))
    streamed_calls = big_calls["find_streamed"]
    log(f"big scene: flagship stand-in n={BIG_N}, {TB} triangles in {NCB} "
        f"clusters; scene built in {scene_s:.2f} s; BVH of "
        f"{tree.left.shape[0]} nodes by the {builder} builder in "
        f"{bvh_s:.3f} s; {W}x{H}, {BIG_SPP} spp, {big_chunk * big_spb} "
        f"paths per chunk, {big_chunks} chunks")

    # sub-wavefronts of SUB rays: the run of blocks whose primary rays hit
    # the most triangles, at bounce 0 and at bounce 1 (kernel 9's plain
    # version is slow), and the fuzz wavefront
    SUB = 8192
    RBS = find.STREAM_RAY_BLOCK
    nbs = SUB // RBS
    _, p0 = find.find_streamed(*streamed_calls[0])
    on_tri = ((p0 >= 0) & (p0 < TB)).reshape(-1, RBS).sum(dim=1)
    b0 = int(on_tri.unfold(0, nbs, 1).sum(dim=1).argmax())

    def sub_streamed(call):
        lists, rays = call[:2]
        return (lists[b0:b0 + nbs].contiguous(),
                rays[b0 * RBS:(b0 + nbs) * RBS].contiguous(), *call[2:])

    fuzz_t_min = torch.full((4096,), 0.001, device=dev)
    streamed_cases = [
        ("bounce 0", sub_streamed(streamed_calls[0])),
        ("bounce 1", sub_streamed(streamed_calls[1])),
        ("fuzz", find.streamed_inputs(big, fo, fd, ft, fuzz_t_min)),
    ]

    def check_find_streamed(inp):
        t_k, p_k = find.find_streamed(*inp)
        t_p, p_p = find.find_streamed_plain(*inp)
        if not torch.equal(t_k.view(torch.int32), t_p.view(torch.int32)):
            raise AssertionError("find_streamed: t differs from the plain "
                                 "version")
        dis = p_k != p_p
        n_dis = int(dis.sum())
        if n_dis and not bool(near_tie(t_k[dis], t_p[dis]).all()):
            raise AssertionError(f"find_streamed: {n_dis} prim ids differ "
                                 f"beyond the near-tie rule ({FIND_TIE})")
        return 0.0, n_dis, f"t bit-equal, {n_dis} of {p_k.numel()} prim " \
                           f"ids differ (near ties), " \
                           f"{int((p_k >= 0).sum())} hits, " \
                           f"{int(((p_k >= 0) & (p_k < TB)).sum())} on " \
                           f"triangles"

    def check_tri_brute(inp):
        t_k, i_k = brute.tri_brute(*inp)
        t_p, i_p = brute.tri_brute_plain(*inp)
        n_dis = int((i_k != i_p).sum())
        n_bits = int((t_k.view(torch.int32) != t_p.view(torch.int32)).sum())
        if n_dis or n_bits:
            raise AssertionError(f"tri_brute: {n_dis} ids and {n_bits} t "
                                 "values differ from the plain version")
        return 0.0, 0, f"t bit-equal, ids equal, " \
                       f"{int((i_k >= 0).sum())} hits of {i_k.numel()} rays"

    def brute_launched(rays):
        """{slices, blocks} of kernel 9's last launch, as its wrapper
        recorded them; that launch must have been over ``rays`` rays."""
        last = dict(brute.LAST_LAUNCH)
        if last.get("rays") != rays:
            raise AssertionError(f"tri_brute: last launch {last}, not over "
                                 f"{rays} rays")
        return dict(slices=last["slices"], blocks=last["blocks"])

    def brute_bound(inp):
        """The bytes read and written once, and the float32 operations this
        data needs (``find_split.brute_scan_counts``: the plane group of
        each real pair, the divide where plane_ok, the edges in range)."""
        org4, dir4, w, t_min = inp
        pairs = org4.shape[0] * (w.shape[1] // 4)
        ops = find_split.brute_scan_counts(*inp)["needed_ops"]
        return bytes_of(org4, dir4, w) + org4.shape[0] * 8, ops, \
            f"{pairs} (ray, triangle) tests, {ops / pairs:.2f} needed " \
            f"operations a test"

    def brute_inputs(org, dir):
        return (*brute.ray4(org, dir), brute.build_weights(big), 0.001)

    # kernel 8 at the big frame chunk's full width, each bounce (bounce 1
    # is the record's main shape), and kernel 2 on its last bounce
    streamed_bound = walk_bound(True, lambda i: big)
    per_bounce = []
    for bounce, call in enumerate(streamed_calls):
        rec = record("find_streamed", find.FIND_STREAMED, call,
                     check_find_streamed, find.find_streamed,
                     find.find_streamed_plain, streamed_bound,
                     f"chunk bounce {bounce}", 5, 1)
        per_bounce.append({k: rec[k] for k in (
            "case", "shape", "ms", "plain_ms", "bound_ms", "bound_by",
            "mismatches")})
        if bounce == 1:
            records["find_streamed"] = rec
    records["find_streamed"]["bounces"] = per_bounce
    rec = record("find_any", find.FIND_ANY, big_calls["find_any"][0],
                 check_find_any, find.find_any, find.find_any_plain,
                 walk_bound(False, lambda i: big), "big chunk last bounce",
                 10, 1)
    records["find_any"]["big_last_bounce"] = {k: rec[k] for k in (
        "case", "shape", "ms", "plain_ms", "bound_ms", "bound_by")}
    rec = record("any_regroup", find.ANY_REGROUP,
                 big_calls["any_regroup"][0], check_any_regroup,
                 find.any_regroup, find.any_regroup_plain, regroup_bound,
                 "big chunk last bounce", 10, 3)
    records["any_regroup"]["big_last_bounce"] = {k: rec[k] for k in (
        "case", "shape", "ms", "plain_ms", "bound_ms", "bound_by")}
    del streamed_calls, big_calls
    for label, inp in streamed_cases:
        check_only("find_streamed", inp, check_find_streamed, label)
    # both kernels where most lanes die on the ground sphere, where whole
    # blocks are dead, and on rays through vertices and edges that
    # clusters share (exact ties); kernel 2's flags also against those
    # that kernel 8's closest hits imply
    emis_big = big.mat_type[big.sph_mat.long()] == MAT_LIGHT
    for label, (o_h, d_h, t_h, tm_h, b_h) in \
            checks.hard_wavefronts(big).items():
        check_only("find_streamed",
                   find.streamed_inputs(big, o_h, d_h, t_h, tm_h),
                   check_find_streamed, label)
        check_only("any_regroup", (o_h, d_h, t_h, tm_h, b_h,
                                   find._pack_spheres(big, ~emis_big)),
                   check_any_regroup, label)
        inp_h = find.occluded_inputs(big, o_h, d_h, t_h, b_h, t_min=tm_h,
                                     sphere_occluder=~emis_big)
        check_only("find_any", inp_h, check_find_any, label)
        occ_h = find.find_any(*inp_h)[:o_h.shape[0]] > 0
        want_h = checks.occlusion_by_closest_hit(big, o_h, d_h, t_h, tm_h,
                                                 b_h, ~emis_big)
        if not torch.equal(occ_h, want_h):
            raise AssertionError(
                f"find_any [{label}]: {int((occ_h != want_h).sum())} flags "
                "differ from those of the closest hits")
        log(f"find_any [{label}]: flags equal to those of kernel 8's "
            f"closest hits and the occluder spheres")
    # kernel 9 on the big scene: the bounce-0 and fuzz rays checked, the
    # bounce-1 rays checked and timed
    sub_rays = {label: inp[1] for label, inp in streamed_cases[:2]}
    check_only("tri_brute", brute_inputs(sub_rays["bounce 0"][:, 0:3],
                                         sub_rays["bounce 0"][:, 3:6]),
               check_tri_brute, "big bounce 0")
    check_only("tri_brute", brute_inputs(fo, fd), check_tri_brute,
               "big fuzz")
    inp9b = brute_inputs(sub_rays["bounce 1"][:, 0:3],
                         sub_rays["bounce 1"][:, 3:6])
    rec = record("tri_brute", brute.TRI_BRUTE, inp9b, check_tri_brute,
                 brute.tri_brute, brute.tri_brute_plain, brute_bound,
                 "big bounce 1", 5, 3)
    big_brute = {k: rec[k] for k in (
        "shape", "ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err")}
    big_brute.update(brute_launched(inp9b[0].shape[0]))
    del inp9b
    # kernel 9 where its comparison meant something: the n = 39 stand-in
    # and the mid chunk's 524,288 camera rays, on its own path
    # find_hit(method="pallas_mxu") with the launch counters read
    o9, d9, t9 = camera_rays(ids, spb)
    reset_counts()
    p9, _ = find_hit(scene, o9, d9, t9, method="pallas_mxu")
    counts9 = read_counts()
    want9 = {k: 0 for k in counts9}
    want9["srt_tri_brute"] = 1
    log(f"pallas_mxu path launches: {counts9}")
    if counts9 != want9:
        raise AssertionError(f"launch counts {counts9} != {want9}")
    inp9 = (*brute.ray4(o9, d9), brute.build_weights(scene), 0.001)
    shape9 = brute_launched(inp9[0].shape[0])      # the path's own launch
    records["tri_brute"] = record("tri_brute", brute.TRI_BRUTE, inp9,
                                  check_tri_brute, brute.tri_brute,
                                  brute.tri_brute_plain, brute_bound,
                                  "n=39 camera", 20, 3)
    records["tri_brute"]["big"] = big_brute
    records["tri_brute"].update(shape9)
    log(f"kernel tri_brute: {shape9['slices']} slice(s) in "
        f"{shape9['blocks']} blocks on n=39 camera rays (pallas_mxu), "
        f"{big_brute['slices']} in {big_brute['blocks']} on big bounce 1")
    # the SASS of its test loops (the first is the one ray4's rays run):
    # a reading of the compiler's output, null where it finds no loop
    try:
        sass9 = find_split.brute_sass(subprocess.run(
            [os.path.join(os.path.dirname(_cuda._nvcc()), "cuobjdump"),
             "-sass", info["path"]], capture_output=True, text=True,
            check=True).stdout, rays_per_lane=brute.RAYS_PER_LANE)
    except (OSError, subprocess.CalledProcessError) as e:
        log(f"kernel tri_brute: no SASS ({e})")
        sass9 = []
    records["tri_brute"]["sass_per_test"] = None
    if sass9:
        records["tri_brute"]["sass_per_test"] = dict(
            full=sass9[0]["full_per_test"]["instructions"],
            stop=sass9[0]["stop_per_test"])
        log(f"kernel tri_brute: SASS instructions a test of ray4's rays "
            f"{json.dumps(sass9[0]['full_per_test'])} in full, "
            f"{sass9[0]['stop_per_test']} where the warp stops at each vote "
            f"(the first: it skips the triangle)")
    else:
        log("kernel tri_brute: no test loop found in the SASS; "
            "sass_per_test is null")
    records["tri_brute"]["launches_by_path"] = {
        "pallas_mxu": counts9["srt_tri_brute"]}
    records["tri_brute"]["launches"] = counts9["srt_tri_brute"]
    p9_ref, _ = find_hit(scene, o9, d9, t9, method="pallas")
    log(f"pallas_mxu vs pallas on those rays: "
        f"{int((p9 != p9_ref).sum())} of {p9.numel()} prim ids differ "
        f"(the edge forms differ, ops/brute.py)")
    del o9, d9, t9, inp9, p9, p9_ref, streamed_cases, sub_rays

    # 7.2 the referees agree on 65,536 tile-ordered primary rays
    o_r, d_r, t_r = camera_rays(
        torch.from_numpy(order[mid:mid + 65536]).to(dev), 1)
    ref = {}
    ref_s = {}
    for method in ("streamed", "pallas", "bvh", "bruteforce"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref[method] = find_hit(big, o_r, d_r, t_r, method=method)
        torch.cuda.synchronize()
        ref_s[method] = time.perf_counter() - t0
    p_ref, t_ref = ref["bruteforce"]
    for method in ("streamed", "pallas", "bvh"):
        p_m, t_m = ref[method]
        dis = p_m != p_ref
        if int(dis.sum()) and not bool(near_tie(t_m[dis], t_ref[dis]).all()):
            raise AssertionError(f"find_hit({method}) disagrees with the "
                                 "bruteforce referee beyond near ties")
        log(f"referee {method}: {int(dis.sum())} of 65536 prim ids differ "
            f"from bruteforce (near ties); {ref_s[method]:.3f} s")
    cl = capture_calls([find], ["find_closest"], lambda: find_hit(
        big, o_r, d_r, t_r, method="pallas"))["find_closest"][0]
    st = find.streamed_inputs(big, o_r, d_r, t_r)
    k1_ms = time_ms(torch, lambda: find.find_closest(*cl), 10)
    k8_ms = time_ms(torch, lambda: find.find_streamed(*st), 10)
    tri_hits = int(((p_ref >= 0) & (p_ref < TB)).sum())
    k1_tests = checks.walk_counts(True, cl, big.cluster_min,
                                  big.cluster_max, K1_WARP_RAYS)
    k8_tests = checks.walk_counts(True, st, big.cluster_min,
                                  big.cluster_max)

    def counts_text(c):
        return ", ".join(f"{c[k]} {k}" for k in ("listed", "executed",
                                                 "live", "needed"))

    log(f"65536 primary rays on {TB} triangles ({tri_hits} hit a triangle): "
        f"find_closest (kernel 1, 128-ray block-culled lists of {NCB} "
        f"clusters) {k1_ms:.4f} ms, {counts_text(k1_tests)} tests; "
        f"find_streamed (kernel 8, 256-ray lists) {k8_ms:.4f} ms, "
        f"{counts_text(k8_tests)} tests (median of 10, CUDA events, {smi})")
    records["find_streamed"]["primary_65536"] = dict(
        find_streamed_ms=k8_ms, find_closest_ms=k1_ms,
        find_closest_tests=k1_tests, **k8_tests)
    del ref, cl, st, o_r, d_r, t_r

    # 7.3 the full-width frame, counted
    reset_counts()
    t0 = time.perf_counter()
    img_big = renderer.render_image(big, big_cfg)
    torch.cuda.synchronize()
    big_seconds = time.perf_counter() - t0
    counts = read_counts()
    expect = {k: 0 for k in counts}
    expect.update({"srt_find_streamed": 3 * big_chunks,
                   "srt_find_any": big_chunks,
                   "srt_any_regroup": big_chunks,
                   "srt_hitrec": 4 * big_chunks,
                   "srt_shade": 4 * big_chunks})
    log(f"big frame launches: {counts} (expected {expect})")
    if counts != expect:
        raise AssertionError(f"launch counts {counts} != {expect}")
    for name, sym in (("find_streamed", "srt_find_streamed"),
                      ("tri_brute", "srt_tri_brute")):
        records[name].setdefault("launches_by_path", {})["big_frame"] = \
            counts[sym]
    records["find_streamed"]["launches"] = counts["srt_find_streamed"]
    for name, c in kernel_checks.items():
        records[name]["launches_by_path"]["big_frame"] = counts[c[3].symbol]
    t0 = time.perf_counter()
    accum = renderer.render_accumulate(big, big_cfg)
    torch.cuda.synchronize()
    big_again = time.perf_counter() - t0
    if not np.isfinite(accum).all():
        raise AssertionError("non-finite radiance in the big frame")
    if not np.array_equal(color.to_uint8(color.resolve(accum, BIG_SPP)),
                          img_big):
        raise AssertionError("a second big frame differs from the first")
    if img_big.shape != (H, W, 3) or img_big.std() < 5.0:
        raise AssertionError("big frame is constant or misshapen")
    prim, _ = find_hit(big, o, d, tm)
    big_share = float(((prim >= 0) & (prim < TB)).float().mean())
    if big_share < 0.05:
        raise AssertionError(f"only {100 * big_share:.2f}% of primary rays "
                             "hit a triangle of the big scene (need >= 5%)")
    big_paths = P * BIG_SPP
    log(f"big frame: {W}x{H}, {BIG_SPP} spp, {big_cfg.max_bounce} bounces, "
        f"{TB} triangles: {big_seconds:.3f} s, "
        f"{big_paths * big_cfg.max_bounce / big_seconds / 1e6:.2f} Mrays/s "
        f"(paths x {big_cfg.max_bounce}); repeat {big_again:.3f} s, "
        f"identical; finite; mean {img_big.mean():.2f}, std "
        f"{img_big.std():.2f}; primary rays hitting a triangle "
        f"{100 * big_share:.2f}%; {smi}")
    write_png(os.path.splitext(args.out)[0] + "_big.png", img_big)

    # ---- 8. the tools and the reference integrator ---------------------
    from sexy_raytracer_tpu_torch.tools import devtime
    from sexy_raytracer_tpu_torch.tools import profile as tprofile

    t8 = time.perf_counter()

    def prefix_atol(idx, vals, n_bins):
        """Per channel, 2 n u max_k |S_k| (u = 2^-24): a bin of the sorted
        histogram is a difference of two float32 prefix sums S of the
        id-sorted values, so its error scales with the largest of them."""
        if idx.numel() == 0:
            return torch.zeros(vals.shape[1], device=vals.device)
        keep = (idx >= 0) & (idx < n_bins)
        order = torch.sort(torch.where(keep, idx.long(), n_bins),
                           stable=True)[1]
        S = vals[order].double().cumsum(0)
        return (2.0 * idx.numel() * 2.0 ** -24 * S.abs().amax(0)).float()

    def library_sorted(idx, vals, n_bins):
        """The one PyTorch call for the whole function: index_add_ of the
        in-range entries."""
        keep = (idx >= 0) & (idx < n_bins)
        i, v = idx[keep].long(), vals[keep]
        return lambda: torch.zeros((n_bins, v.shape[1]), device=v.device) \
            .index_add_(0, i, v)

    def check_place(inp):
        got = histogram.place(*inp)
        again = histogram.place(*inp)
        want = histogram.place_plain(*inp)
        bits = got.view(torch.int32)
        if not torch.equal(bits, want.view(torch.int32)):
            raise AssertionError("place: kernel and plain version differ")
        if not torch.equal(bits, again.view(torch.int32)):
            raise AssertionError("place: two launches differ")
        return 0.0, 0, f"bit-equal to the plain version and across two " \
                       f"launches; {inp[0].numel()} unique ids in " \
                       f"{inp[2].numel() - 1} windows"

    def check_sorted(inp):
        # the glue's float32 cumsum is CUB's decoupled look-back scan on
        # the card, whose association varies from run to run: the whole
        # wrapper is held to the prefix-sum bound, kernel 10 alone (on
        # fixed glue outputs, check_place) bit for bit
        got = histogram.dense_histogram_sorted(*inp)
        again = histogram.dense_histogram_sorted(*inp)
        want = histogram.dense_histogram_sorted_plain(*inp)
        lib = library_sorted(*inp)()
        atol = prefix_atol(*inp)
        err = (got - lib).abs()
        for name, other in (("index_add_", lib), ("its plain version", want),
                            ("a second call", again)):
            if not bool(((got - other).abs() <= atol).all()):
                raise AssertionError(f"dense_histogram_sorted: differs from "
                                     f"{name} beyond the prefix-sum bound")
        n_rerun = int((got.view(torch.int32) != again.view(torch.int32))
                      .sum())
        return float(err.max()) if err.numel() else 0.0, n_rerun, \
            f"within 2 n u max|S| (up to {float(atol.max()):.3g}) of " \
            f"index_add_ (max abs diff {float(err.max()):.3g}), of its " \
            f"plain version (max {float((got - want).abs().max()):.3g}) " \
            f"and of a second call ({n_rerun} values not bit-equal, max " \
            f"{float((got - again).abs().max()):.3g})"

    def place_bound(inp):
        tex_u, seg, win_starts, n_bins = inp
        return bytes_of(tex_u, seg) + n_bins * seg.shape[1] * 4, 0, \
            "read tex_u and seg once, write the table once"

    def sorted_bound(inp):
        idx, vals, n_bins = inp
        return bytes_of(idx, vals) + n_bins * vals.shape[1] * 4, \
            vals.numel(), "one add per entry and channel"

    # 8.1 kernel 10 at the tools' A/B shapes, and the whole wrapper
    ab = []
    for case, idx, vals, n_bins in tprofile.histogram_inputs(
            tprofile.HISTOGRAM_CASES, dev):
        glue = (*histogram.sorted_segments(idx, vals, n_bins), n_bins)
        k10 = record("place", histogram.PLACE, glue, check_place,
                     histogram.place, histogram.place_plain, place_bound,
                     case, library=histogram_split.index_copy(*glue))
        k10w = record("dense_histogram_sorted", histogram.PLACE,
                      (idx, vals, n_bins), check_sorted,
                      histogram.dense_histogram_sorted,
                      histogram.dense_histogram_sorted_plain, sorted_bound,
                      case, library=library_sorted(idx, vals, n_bins))
        ab.append((k10, k10w))

    keys10 = ("case", "shape", "ms", "plain_ms", "bound_ms", "bound_by",
              "library_ms", "max_abs_err")
    records["place"] = ab[0][0]
    records["place"]["ab"] = [{k: r[k] for k in keys10} for r, _ in ab]
    records["place"]["wrapper"] = [{k: r[k] for k in keys10} for _, r in ab]
    records["place"]["device_ms"] = {k: v[0] for k, v in dev10.items()}
    records["place"]["launch_path_us"] = lp
    fz8 = np.random.default_rng(8)
    extra = [("all-unique",
              torch.arange(2048, dtype=torch.int32, device=dev) * 2,
              torch.ones((2048, 4), device=dev), 4096)]
    for C in (1, 3):
        extra.append((f"fuzz C={C}", torch.tensor(
            fz8.integers(-500, 70001 + 500, 50000), dtype=torch.int32,
            device=dev), torch.tensor(fz8.normal(size=(50000, C)),
                                      dtype=torch.float32, device=dev), 70001))
    for case, idx, vals, n_bins in extra:
        check_only("place", (*histogram.sorted_segments(idx, vals, n_bins),
                             n_bins), check_place, case)
        check_only("dense_histogram_sorted", (idx, vals, n_bins),
                   check_sorted, case)
    if not torch.equal(histogram.dense_histogram_sorted(*extra[0][1:]),
                       library_sorted(*extra[0][1:])()):  # integer sums
        raise AssertionError("dense_histogram_sorted: unit counts of the "
                             "all-unique case are not exact")
    del ab, extra

    # 8.2 the tools' direct-vs-sorted A/B through its function, counted
    hist_reps = 10
    reset_counts()
    hist_rows = tprofile.cmd_histogram(dev, reps=hist_reps)
    counts = read_counts()
    calls = len(tprofile.HISTOGRAM_CASES) * (hist_reps + 1)
    expect = {k: 0 for k in counts}
    expect.update({"srt_histogram": calls, "srt_place": calls})
    log(f"profile histogram launches: {counts} (expected {expect})")
    if counts != expect:
        raise AssertionError(f"launch counts {counts} != {expect}")
    log("profile histogram (host clock, mean of 10 after a warm-up, "
        f"{smi}): " + json.dumps(hist_rows))
    records["place"]["launches"] = counts["srt_place"]
    records["place"]["launches_by_path"] = {
        "profile_histogram": counts["srt_place"]}
    records["dense_histogram"]["launches_by_path"]["profile_histogram"] = \
        counts["srt_histogram"]

    # 8.3 the reference integrator on the train step's 131,072 paths
    w8 = tprofile.bench_inputs(dev)
    trace8 = (w8["scene"], w8["org"], w8["dirs"], w8["times"], w8["keys"],
              background, cfg.max_bounce)
    reset_counts()
    rad_ref = integrator.trace_rays(*trace8, fused=False)
    counts = read_counts()
    expect = {k: 0 for k in counts}
    expect["srt_find_closest"] = cfg.max_bounce
    log(f"reference integrator launches, one call: {counts} (expected "
        f"{expect})")
    if counts != expect:
        raise AssertionError(f"launch counts {counts} != {expect}")
    records["find_closest"]["launches_by_path"]["reference"] = \
        counts["srt_find_closest"]
    rad_fus = integrator.trace_rays(*trace8)
    if not bool(torch.isfinite(rad_ref).all()):
        raise AssertionError("non-finite radiance from the reference "
                             "integrator")
    close = torch.isclose(rad_ref, rad_fus, atol=2e-5, rtol=1e-5).all(dim=1)
    ref_ms = time_ms(torch, lambda: integrator.trace_rays(
        *trace8, fused=False), 5)
    fus_ms = time_ms(torch, lambda: integrator.trace_rays(*trace8), 5)
    vis_ms = time_ms(torch, lambda: integrator.trace_rays(
        *trace8, last_bounce_vis=True), 5)
    log(f"reference vs fused integrator, {rad_ref.shape[0]} paths x "
        f"{cfg.max_bounce} bounces: {int((~close).sum())} rays outside atol "
        f"2e-5 rtol 1e-5 (budget 0.5%), max abs diff "
        f"{float((rad_ref - rad_fus).abs().max()):.3g}; reference "
        f"{ref_ms:.3f} ms, fused {fus_ms:.3f} ms, fused with the last-bounce "
        f"shortcut {vis_ms:.3f} ms (median of 5, CUDA events, {smi})")
    if float(close.float().mean()) < 0.995:
        raise AssertionError("reference and fused integrators disagree on "
                             "> 0.5% of rays")
    del rad_ref, rad_fus, close

    def loss_grads(fused):
        params = {k: v.clone().requires_grad_(True)
                  for k, v in extract_params(scene).items()}
        loss = _loss_fn(
            params, scene, camera, gate_ids.to(dev),
            torch.full((4096, 3), 0.25, device=dev), 0, rng.key(5, dev),
            background, width=W, height=H, spb=2, spp_total=spp,
            max_bounce=cfg.max_bounce, method="auto", fused=fused)
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True)
        return float(loss.detach()), {
            k: (torch.zeros_like(p) if g is None else g).double()
            for (k, p), g in zip(params.items(), grads)}

    reset_counts()
    loss_r, g_r = loss_grads(False)
    counts = read_counts()
    expect = {k: 0 for k in counts}
    expect.update({"srt_find_closest": cfg.max_bounce,
                   "srt_histogram": cfg.max_bounce})
    log(f"reference loss backward launches (4096 pixels, spb 2): {counts} "
        f"(expected {expect}: the atlas backward once per bounce)")
    if counts != expect:
        raise AssertionError(f"launch counts {counts} != {expect}")
    records["dense_histogram"]["launches_by_path"]["reference_backward"] = \
        counts["srt_histogram"]
    loss_f, g_f = loss_grads(None)
    rel_g = {k: float((g_r[k] - g_f[k]).abs().max())
             / max(float(g_f[k].abs().max()), 1e-10) for k in g_f}
    finite = all(bool(torch.isfinite(g).all()) for g in g_r.values())
    log(f"reference vs fused gradients (4096 pixels, spb 2): loss "
        f"{loss_r:.6f} vs {loss_f:.6f}; rel grad "
        + ", ".join(f"{k} {v:.2e}" for k, v in rel_g.items())
        + f"; finite: {finite}")
    if not finite or max(rel_g.values()) >= 5e-4 \
            or abs(loss_r - loss_f) > 1e-3 * abs(loss_f):
        raise AssertionError("reference and fused gradients differ beyond "
                             "relative 5e-4")

    # 8.4 the tools' step, xplane and big-scene points
    step_rows = tprofile.cmd_step(dev)
    xplane_rows = tprofile.cmd_xplane(dev)
    # do the profiler's device events name the kernels launched through
    # ctypes? (the train step launches kernels 1 and 3-7, the sorted
    # histogram kernel 10)
    probe = next(tprofile.histogram_inputs(tprofile.HISTOGRAM_CASES[:1],
                                           dev))[1:]
    _, ev = devtime.profile_events(
        lambda: histogram.dense_histogram_sorted(*probe), [()], 1)
    seen = {e[1] for e in ev} | set(xplane_rows)
    found = {fn: any(f"::{fn}(" in s or f"::{fn}<" in s for s in seen)
             for fn in ("find_closest_kernel", "hitrec_kernel",
                        "shade_staged_kernel", "hitrec_bwd_kernel",
                        "shade_bwd_kernel", "chunk_reduce_kernel",
                        "window_combine_kernel", "slice_sum_kernel",
                        "place_kernel")}
    log(f"torch.profiler device events name the kernels: {found}")
    if not all(found.values()):
        raise AssertionError("torch.profiler's device events name no "
                             "launch of " + ", ".join(
                                 fn for fn, ok in found.items() if not ok))
    bigscene_out = os.path.splitext(args.out)[0] + "_bigscene.json"
    big_rows = tprofile.cmd_bigscene(dev, bigscene_out,
                                     runs=((3042, None), (304000, None)))
    if len(big_rows) != 2 or min(r["hits"] for r in big_rows) <= 0:
        raise AssertionError(f"_bigscene_one failed: {big_rows}")
    records["place"]["tools"] = dict(step=step_rows, bigscene=big_rows)
    log(f"phase 8: {time.perf_counter() - t8:.1f} s")

    # ---- 9. inverse rendering on the card --------------------------------
    counts = inverse_phase(torch, dev, scene, cfg, relief, train_per_step,
                           step_s, reset_counts, read_counts, smi)
    for name, c in kernel_checks.items():
        records[name]["launches_by_path"]["inverse"] = counts[c[3].symbol]

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
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                renderer.render_pixels(
                    big, camera, big_ids, 0, base_key, background, width=W,
                    height=H, spb=big_spb, spp_total=BIG_SPP,
                    max_bounce=big_cfg.max_bounce,
                    last_bounce_vis=True).sum().item()
            f.write(f"{kind}, {smi}: one {big_chunk * big_spb}-path chunk "
                    f"of the big frame ({TB} triangles)\n"
                    + prof.key_averages().table(sort_by="cuda_time_total",
                                                row_limit=40) + "\n")
        log(f"profiles of one chunk, one train step and one big-frame chunk "
            f"written to {args.profile}")

    if sorted(r["source"] + r["replaces"] for r in records.values()) != \
            sorted(k.source + k.replaces.split(" ")[0] for k in _cuda.KERNELS
                   if k.replaces):
        raise AssertionError("the kernels' record does not list every "
                             "kernel of the library once")
    log(json.dumps({"kernels": list(records.values())}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
