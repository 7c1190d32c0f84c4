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

10. the Shirley field, ``shirley_parity(seed=42)`` at 1280x720, 8 spp, 4
    bounces, aperture 0.1 (no triangles; up to 488 spheres: glass, fuzzy
    metal, moving diffuse), rendered by the command line's ``main(["render",
    ...])`` in this process with the launch counters around it (per chunk
    the find 3 times, occlusion and its pass once, hit record and shade 4
    times, no other kernel); finite, a second render identical, the image
    varying; glass, fuzzy metal and moving diffuse spheres each hit by at
    least 0.1% of the frame's primary rays; 4,096 pixels (half spread over
    the frame, half on glass) against the same ``render_pixels`` call on
    CPU tensors within the trace parity budget (atol 2e-5, rtol 1e-5, 0.5%
    of pixels; the rays that differ are named if any do); the frame time
    and Mrays/s; kernel 1, kernel 2 and its pass at the centre chunk, each
    beside its plain version's time and its bound from the sphere tests
    its rays need;
10b. the glTF path: the stand-in's relief mesh written as a ``.gltf``
    (embedded base64) and a ``.glb`` (a TRS node over a matrix node), each
    with the albedo PNG and the normal map, loaded by
    ``presets.masterchief(asset=...)`` onto the flagship furniture and
    equal to ``flagship_standin(n=39)`` in every field; the ``.glb``
    scene's counted 720p, 8-spp frame (phase 4's checks); the command line
    in a subprocess: ``render --preset square`` on the ``.gltf`` at 720p,
    exiting 0 and writing a PNG of its size;
10c. the command line's ``main(["inverse", "--preset", "shirley_parity",
    "--height", "180", ...])`` in this process: 3 steps of 4,096 pixels at
    spb 4 against phase 10's frame downscaled, then the 64-spp preview,
    with the launch counters around it (per step phase 4's counts of one
    call and kernels 5, 6 and 7 four times each, then the preview's frame
    counts, no other kernel); every call of kernels 5, 6 and 7 in the last
    step held to its plain version with phase 3's checks (the field's
    glass, fuzz and moving-sphere rows; the field samples no texture, so
    kernel 7's rows there are all zero); 3 finite losses, a preview of
    its size.

11. the mesh paths (``parallel/``, ``make_train_step(mesh=)``,
    ``inverse_render(mesh=)``, ``graft_entry``):
    11a. one rank over NCCL on a (1, 1) mesh: ``render_sharded`` of the
    stand-in at 720p, 8 spp, counted (phase 4's counts), its float image
    phase 4's bit for bit; three ``make_train_step(mesh=)`` steps of
    phase 6's batch, counted (phase 6's counts per step), losses and
    parameters bit-equal to the same steps without a mesh; five steps of
    phase 9's ``inverse_render`` with and without the mesh, bit-equal;
    the frame's seconds and the step's ms beside the same without the
    mesh, in turns, and phases 5-6;
    11b. two ranks sharing the card over gloo (NCCL refuses two ranks on
    one GPU; the phase names gloo itself): the (2, 1) frame within the
    trace parity budget of 11a's (the pixels outside named), the (1, 2)
    frame within atol 2e-5, rtol 1e-4 (tests/test_parallel.py:53); three
    steps on (2, 1), bit-identical across the ranks, losses within
    relative 1e-5 of 11a's steps without a mesh, step 0's gradient within
    bench.py:192's gate; the seconds, which are no scaling figure;
    11c. ``graft_entry.entry()``'s fn on the card ([2048, 3], finite), and
    ``python -m sexy_raytracer_tpu_torch.graft_entry dryrun 1`` (one NCCL
    rank on the card, its default) in a subprocess, exiting 0 with its
    line.

12. the root tools' counterparts (``sexy_raytracer_tpu_torch/tools/``),
    each through its own functions, counted, with its artifacts in a
    temporary directory:
    12a. ``run_inverse_experiment`` phases 1, 1b and 1c on the 240p
    stand-in at ``TOOL_STEPS`` steps a stage and ``TOOL_SIL_STEPS``
    silhouette steps: per step phase 9's counts, plus the 240p x 128-spp
    target and re-renders (frame counts), one trace of the edge rays a
    silhouette step; finite losses, the exact objective falling in
    phases 1 and 1b, the iron sphere's centre moving towards the truth;
    12b. ``run_flagship_render``'s command line at 720p, ``TOOL_SPP`` spp,
    4 a batch (frame counts, the report's keys, its checkpoint removed
    once the frame is whole), then a render interrupted
    after one chunk and resumed from its checkpoint, bit-equal to the
    uninterrupted one, and within the trace parity budget of phase 4's
    frame;
    12c. ``run_scaling_curve``'s one-rank NCCL point in a subprocess
    (bruteforce find: kernels 3 and 4 only), its chunk bit-equal to the
    same ``render_pixels`` call here;
    12d. ``check_find_referee`` on 131,072 random rays: no kernel-vs-
    bruteforce mismatch outside the near-tie rule, each adjudicated in
    float64; kernel 1 once, then 7 calls a timed mode;
    12e. ``diag_r5`` at 131,072 rays: its launches, compaction parity 0 on
    each bounce wavefront; the phase's seconds.

The last three lines are the kernels' JSON record, nvidia-smi's
"name, power.limit" line, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import dataclasses
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
    its seconds per step. Returns the CRN run's launch counts and its
    setup (the perturbed scene, target, config and ``inverse_render``
    arguments).
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
    return counts, dict(scene=perturbed, target=target, cfg=cfg16, kw=kw)


# phase 10: the Shirley field (glass, fuzz, motion, aperture) through the
# command line, and phase 10b: the glTF/GLB loader on the stand-in's mesh
SHIRLEY_SEED, SHIRLEY_SPP, SHIRLEY_HEIGHT = 42, 8, 720
SHIRLEY_CPU_PIXELS = 4096
MIN_KIND_SHARE = 0.001   # of the frame's primary rays, per material kind
GLTF_SPP, GLTF_HEIGHT = 8, 720
CLI_STEPS, CLI_PIXELS, CLI_SPB, CLI_PREVIEW_SPP = 3, 4096, 4, 64


def frame_plan(cfg):
    """(render_pixels calls, pixels a chunk) of ``render_accumulate``."""
    P = cfg.width * cfg.height
    spb = min(cfg.samples_per_batch, cfg.samples_per_pixel)
    chunk = max(1, min(cfg.rays_per_chunk // spb, P))
    return -(-P // chunk) * -(-cfg.samples_per_pixel // spb), chunk


def frame_counts(kernels, calls, find="srt_find_closest"):
    """The launch counts a counted frame of ``calls`` render_pixels calls
    must show: the find 3 times, occlusion and its pass once, hit record and
    shade 4 times a call, no other kernel."""
    expect = {k.symbol: 0 for k in kernels}
    expect.update({find: 3 * calls, "srt_find_any": calls,
                   "srt_any_regroup": calls, "srt_hitrec": 4 * calls,
                   "srt_shade": 4 * calls})
    return expect


def primary_rays(torch, rng, camera, base_key, W, H, ids):
    """Sample 0's camera rays of pixels ``ids`` (renderer.render_pixels)."""
    keys = rng.ray_keys_2d(base_key, ids, torch.zeros_like(ids))
    ucam = rng.per_ray_uniform_block(keys, 5)
    u = ((ids % W).float() + ucam[:, 0]) / (W - 1)
    v = ((H - (ids // W).float()) + ucam[:, 1]) / (H - 1)
    return camera.get_rays(u, v, ucam[:, 2:5])


def shirley_phase(torch, dev, out_dir, reset_counts, read_counts, smi):
    """Phase 10: ``shirley_parity`` at 1280x720, 8 spp, rendered by the
    command line in this process with the launch counters around it;
    the frame's checks, the material kinds its primary rays hit, 4,096
    pixels against the same ``render_pixels`` call on CPU tensors, and
    kernels 1 and 2 at the centre chunk beside their sphere-test bounds.
    Returns (launch counts, the PNG's path, kernels 1 and 2's timings)."""
    from sexy_raytracer_tpu_torch import __main__ as cli
    from sexy_raytracer_tpu_torch.models import presets
    from sexy_raytracer_tpu_torch.models.scene import (
        MAT_DIELECTRIC,
        MAT_METAL,
        MAT_PBR,
    )
    from sexy_raytracer_tpu_torch.ops import _cuda, find, fused
    from sexy_raytracer_tpu_torch.ops.intersect import find_hit
    from sexy_raytracer_tpu_torch.render import integrator, renderer
    from sexy_raytracer_tpu_torch.render.camera import Camera
    from sexy_raytracer_tpu_torch.tools.histogram_split import capture_calls
    from sexy_raytracer_tpu_torch.utils import color, rng
    from sexy_raytracer_tpu_torch.utils.png import read_png

    t10 = time.perf_counter()
    scene, cfg = presets.shirley_parity(seed=SHIRLEY_SEED, spp=SHIRLEY_SPP,
                                        height=SHIRLEY_HEIGHT, device=dev)
    W, H, spp = cfg.width, cfg.height, cfg.samples_per_pixel
    P, S = W * H, scene.num_spheres
    calls, chunk = frame_plan(cfg)
    sph_mat = scene.sph_mat.long()
    kind = scene.mat_type[sph_mat]
    fuzzy = (kind == MAT_METAL) & (scene.mat_fuzz[sph_mat] > 0)
    moving = (kind == MAT_PBR) & (scene.sph_c1 != scene.sph_c0).any(dim=1)
    log(f"shirley field: seed {SHIRLEY_SEED}, {S} spheres "
        f"({int((kind == MAT_DIELECTRIC).sum())} glass, {int(fuzzy.sum())} "
        f"fuzzy metal, {int(moving.sum())} moving diffuse), "
        f"{scene.num_triangles} triangles; {W}x{H}, {spp} spp, "
        f"{cfg.max_bounce} bounces, aperture {cfg.camera.aperture}, "
        f"{calls} chunks of {chunk * min(cfg.samples_per_batch, spp)} paths")
    if not 0 < S <= 488 or scene.num_triangles:
        raise AssertionError(f"the field has {S} spheres and "
                             f"{scene.num_triangles} triangles")

    out = os.path.join(out_dir, "shirley_720p.png")
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rc = cli.main(["render", "--preset", "shirley_parity", "--height",
                   str(SHIRLEY_HEIGHT), "--spp", str(SHIRLEY_SPP), "--out",
                   out])
    torch.cuda.synchronize()
    cli_seconds = time.perf_counter() - t0
    counts = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    expect = frame_counts(_cuda.KERNELS, calls)
    log(f"shirley frame launches (the command line's render): {counts} "
        f"(expected {expect}); peak device memory {peak_gb:.2f} GB")
    if rc != 0 or counts != expect:
        raise AssertionError(f"render exited {rc}; launch counts {counts} "
                             f"!= {expect}")
    img = read_png(out, 3)

    t0 = time.perf_counter()
    accum = renderer.render_accumulate(scene, cfg)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if not np.isfinite(accum).all():
        raise AssertionError("non-finite radiance in the Shirley frame")
    if not np.array_equal(color.to_uint8(color.resolve(accum, spp)), img):
        raise AssertionError("a second Shirley frame differs from the "
                             "command line's")
    if img is None or img.shape != (H, W, 3) or img.std() < 5.0:
        raise AssertionError("Shirley frame is constant or misshapen")

    # the material kinds the frame's primary rays hit (sample 0)
    camera = Camera.from_config(cfg.camera, cfg.aspect, device=dev)
    base_key = rng.key(cfg.seed, device=dev)
    pid = torch.arange(P, dtype=torch.int32, device=dev)
    prim, _ = find_hit(scene, *primary_rays(torch, rng, camera, base_key,
                                            W, H, pid))
    sph = (prim - scene.num_triangles).clamp(min=0).long()
    on = prim >= 0
    shares = {name: float((on & sel[sph]).float().mean())
              for name, sel in (("glass", kind == MAT_DIELECTRIC),
                                ("fuzzy metal", fuzzy),
                                ("moving diffuse", moving))}
    paths = P * spp
    mrays = paths * cfg.max_bounce / seconds / 1e6
    log(f"shirley frame: {seconds:.3f} s for {paths} paths, {mrays:.2f} "
        f"Mrays/s (paths x {cfg.max_bounce}); the command line's render "
        f"{cli_seconds:.3f} s with the scene's build; identical, finite; "
        f"mean {img.mean():.2f}, std {img.std():.2f}; primary rays on "
        + ", ".join(f"{k} {100 * v:.3f}%" for k, v in shares.items())
        + f"; {smi}")
    low = {k: v for k, v in shares.items() if v < MIN_KIND_SHARE}
    if low:
        raise AssertionError(f"material kinds hit by < "
                             f"{100 * MIN_KIND_SHARE}% of primary rays: {low}")

    # 4,096 pixels on the card and on the CPU: the same ids (half spread
    # over the frame, half among the pixels whose primary ray hits glass),
    # sample start, key and spb
    glass_px = torch.nonzero(on & (kind == MAT_DIELECTRIC)[sph]).flatten()
    half = SHIRLEY_CPU_PIXELS // 2
    pick = torch.linspace(0, glass_px.numel() - 1, half,
                          device=dev).round().long()
    spread = torch.linspace(0, P - 1, half, device=dev).round().long()
    ids = torch.cat([spread, glass_px[pick]]).to(torch.int32)
    bg = torch.tensor(cfg.background, device=dev)
    kw = dict(width=W, height=H, spb=min(cfg.samples_per_batch, spp),
              spp_total=spp, max_bounce=cfg.max_bounce, last_bounce_vis=True)
    gpu = renderer.render_pixels(scene, camera, ids, 0, base_key, bg,
                                 **kw).cpu()
    t0 = time.perf_counter()
    cpu_scene = scene.to("cpu")
    cam_cpu = Camera.from_config(cfg.camera, cfg.aspect, device="cpu")
    cpu = renderer.render_pixels(cpu_scene, cam_cpu, ids.cpu(), 0,
                                 base_key.cpu(), bg.cpu(), **kw)
    cpu_s = time.perf_counter() - t0
    close = torch.isclose(gpu, cpu, atol=2e-5, rtol=1e-5).all(dim=1)
    n_out = int((~close).sum())
    note = ""
    if n_out:
        # which rays differ: each sample alone, and the material its
        # primary ray hits
        bad = ids[~close.to(dev)]
        diff_rays = 0
        for s0 in range(kw["spb"]):
            one = dict(kw, spb=1)
            g1 = renderer.render_pixels(scene, camera, bad, s0, base_key, bg,
                                        **one).cpu()
            c1 = renderer.render_pixels(cpu_scene, cam_cpu, bad.cpu(), s0,
                                        base_key.cpu(), bg.cpu(), **one)
            diff_rays += int((~torch.isclose(g1, c1, atol=2e-5, rtol=1e-5)
                              .all(dim=1)).sum())
        first = kind[sph[bad.long()]].tolist()
        note = (f"; {diff_rays} of {bad.numel() * kw['spb']} rays of those "
                f"pixels differ; their primary hits by material type "
                f"{ {t: first.count(t) for t in sorted(set(first))} }")
    log(f"shirley {SHIRLEY_CPU_PIXELS} pixels x spb {kw['spb']}, card vs CPU "
        f"(CPU {cpu_s:.1f} s): {n_out} pixels outside atol 2e-5 rtol 1e-5 "
        f"(budget 0.5%), max abs err {float((gpu - cpu).abs().max()):.3g}"
        + note)
    if float(close.float().mean()) < 0.995:
        raise AssertionError("card and CPU disagree on > 0.5% of the "
                             "Shirley pixels")

    # kernels 1-4 at the centre chunk against their plain versions, bit for
    # bit (kernels 3 and 4 on bounce 1's stacks: glass, fuzz and moving
    # rows among them); kernels 1 and 2 (and its pass) timed beside the
    # bound from the sphere tests their rays need (every live ray against
    # every sphere, OPS_PER_SPHERE_TEST each) or from the bytes they move
    order = renderer.tile_pixel_order(W, H)
    mid = (-(-P // chunk) // 2) * chunk
    mids = torch.from_numpy(order[mid:mid + chunk]).to(dev)
    got = capture_calls(
        [find, find, find, integrator, integrator],
        ["find_closest", "any_regroup", "find_any", "hitrec_fused",
         "shade_carry_fused"],
        lambda: renderer.render_pixels(scene, camera, mids, 0, base_key, bg,
                                       **kw))
    k1 = got["find_closest"][0]
    reg = got["any_regroup"][0]
    k2 = got["find_any"][0]
    held = {
        "find_closest (bounce 0)": (find.find_closest, find.find_streamed_plain,
                                    k1),
        "any_regroup": (find.any_regroup, find.any_regroup_plain, reg),
        "find_any": (find.find_any, find.find_any_plain, k2),
        "hitrec_fused (bounce 1)": (fused.hitrec_fused, fused.hitrec_math,
                                    got["hitrec_fused"][1]),
        "shade_carry_fused (bounce 1)": (fused.shade_carry_fused,
                                         fused.shade_carry_math,
                                         got["shade_carry_fused"][1]),
    }
    for name, (kern, plain, inp) in held.items():
        a, b = kern(*inp), plain(*inp)
        a, b = (a, b) if torch.is_tensor(a) else (torch.cat(
            [x.reshape(-1).view(torch.int32) for x in a]), torch.cat(
            [x.reshape(-1).view(torch.int32) for x in b]))
        same = (a.view(torch.int32) == b.view(torch.int32)) \
            | (a.isnan() & b.isnan() if a.is_floating_point() else False)
        if not bool(same.all()):
            raise AssertionError(f"shirley {name}: {int((~same).sum())} "
                                 "values differ from the plain version")
    hf = got["hitrec_fused"][1][0]
    sf, si = got["shade_carry_fused"][1]
    lanes = sf[26] > 0.5
    log("shirley centre chunk: kernels 1, 2, the pass, 3 and 4 bit-equal to "
        "their plain versions; bounce 1's stacks: "
        f"{int((lanes & (si[0] == MAT_DIELECTRIC)).sum())} glass, "
        f"{int((lanes & (si[0] == MAT_METAL) & (sf[fused.SF_GF + 6] > 0)).sum())}"
        f" fuzzy metal, "
        f"{int(((hf[33] > 0.5) & (hf[22:25] != hf[25:28]).any(dim=0)).sum())}"
        f" moving-sphere lanes of {sf.shape[1]}")

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts
                   if hasattr(t, "numel"))

    def timed(name, n_bytes, n_tests, what):
        kern, plain, inp = held[name]
        ms = time_ms(torch, lambda: kern(*inp), 20)
        plain_ms = time_ms(torch, lambda: plain(*inp), 5)
        t_b = n_bytes / HBM_BYTES_PER_S * 1e3
        t_o = n_tests * OPS_PER_SPHERE_TEST / F32_FLOPS_PER_S * 1e3
        bound_by = "bytes" if t_b >= t_o else "operations"
        log(f"shirley {name} [centre chunk, {what}]: {ms:.4f} ms, plain "
            f"{plain_ms:.3f} ms, bound {max(t_b, t_o):.4f} ms by {bound_by} "
            f"({n_tests} sphere tests x {OPS_PER_SPHERE_TEST} ops, "
            f"{n_bytes / 1e6:.1f} MB) (median, CUDA events, {smi})")
        return {"ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_b, t_o),
                "bound_by": bound_by, "sphere_tests": n_tests, "case": what}

    live1 = int((k1[1][:, 7] < 1e38).sum())
    n_sph = int((k1[4][:, 7] > 0).sum())
    live_r = int(((reg[4] > reg[3]) & (reg[3] < 1e38)).sum())
    n_occ = int((reg[5][:, 7] > 0).sum())
    timings = {
        "find_closest": timed(
            "find_closest (bounce 0)", nbytes(*k1) + 8 * k1[1].shape[0],
            live1 * n_sph, f"bounce 0, {live1} live rays x {n_sph} spheres"),
        "any_regroup": timed(
            "any_regroup", nbytes(*reg) + 4 * 12 * k2[1].shape[0],
            live_r * n_occ,
            f"last bounce, {live_r} live rays x {n_occ} occluder spheres"),
        "find_any": timed(
            "find_any", nbytes(*k2) + 4 * k2[1].shape[0], 0,
            f"last bounce, no triangles: {int((k2[1][:, 8] >= 0).sum())} "
            f"rays left live by the pass"),
    }
    log(f"phase 10: {time.perf_counter() - t10:.1f} s")
    return counts, out, timings


def gltf_phase(torch, dev, out_dir, reset_counts, read_counts, smi):
    """Phase 10b: the stand-in's relief mesh written as a ``.gltf``
    (embedded base64 buffer and images) and as a ``.glb`` (a TRS node over
    a matrix node; the stored vertices undo the nodes' exact transform),
    loaded by ``presets.masterchief`` onto the flagship furniture; both
    scenes equal ``flagship_standin(n=39)``'s; the ``.glb`` scene's
    counted 720p frame; then the command line in a subprocess: ``render
    --preset square`` on the ``.gltf``. Returns the frame's launch
    counts."""
    import base64

    from sexy_raytracer_tpu_torch.models import presets
    from sexy_raytracer_tpu_torch.models.scene import SceneBuilder, SceneData
    from sexy_raytracer_tpu_torch.ops import _cuda
    from sexy_raytracer_tpu_torch.ops.intersect import find_hit
    from sexy_raytracer_tpu_torch.render import renderer
    from sexy_raytracer_tpu_torch.render.camera import Camera
    from sexy_raytracer_tpu_torch.tools.gltf_doc import GltfDoc
    from sexy_raytracer_tpu_torch.utils import color, rng
    from sexy_raytracer_tpu_torch.utils.png import read_png, write_png

    t10 = time.perf_counter()
    # the relief's mesh, images and factors, as add_relief_mesh makes them
    rec = SceneBuilder()
    presets.add_relief_mesh(rec)
    (pos, uv, idx, _), = rec._tri_v
    albedo, normal = (rec._images[i].astype(np.uint8) for i in (0, 1))
    mat = rec._materials[0]
    pngs = []
    for i, img in enumerate((albedo, normal)):
        path = os.path.join(out_dir, f"relief_{i}.png")
        write_png(path, img)
        with open(path, "rb") as f:
            pngs.append(f.read())

    # the .glb's nodes: parent TRS (T (0, 8, 0), 180 degrees about Y,
    # S (2, 0.5, 4)) over a child matrix (S (0.25, 4, 0.5), T (0, -16, 0)):
    # world = diag(-0.5, 2, -2), no translation, exact in float32
    lin = np.diag([-0.5, 2.0, -2.0])
    child = np.eye(4)
    child[:3, :3] = np.diag([0.25, 4.0, 0.5])
    child[:3, 3] = (0.0, -16.0, 0.0)

    def document(positions, images_in_buffer):
        d = GltfDoc()
        tex = [d.image(data=b) if images_in_buffer else d.image(
            uri="data:image/png;base64," + base64.b64encode(b).decode())
            for b in pngs]
        m = d.material(base=tex[0], normal=tex[1],
                       baseColorFactor=[float(x) for x in mat["base_color"]],
                       metallicFactor=float(mat["metallic"]),
                       roughnessFactor=float(mat["roughness"]))
        d.mesh([d.primitive(positions, uv, idx, m)])
        d.doc["scenes"] = [{"nodes": [0]}]
        return d

    d = document(pos, False)
    d.doc["nodes"] = [{"mesh": 0}]
    gltf_path = os.path.join(out_dir, "relief.gltf")
    with open(gltf_path, "wb") as f:
        f.write(d.embedded())
    d = document(pos.astype(np.float64) @ np.linalg.inv(lin).T, True)
    d.doc["nodes"] = [{"children": [1], "translation": [0.0, 8.0, 0.0],
                       "rotation": [0.0, 1.0, 0.0, 0.0],
                       "scale": [2.0, 0.5, 4.0]},
                      {"mesh": 0, "matrix": child.T.ravel().tolist()}]
    glb_path = os.path.join(out_dir, "relief.glb")
    with open(glb_path, "wb") as f:
        f.write(d.glb())

    # both loaded onto the flagship furniture, the stand-in beside them
    # (its iron textures read from the same directory: the sentinels)
    standin, cfg = presets.flagship_standin(n=39, spp=GLTF_SPP,
                                            height=GLTF_HEIGHT,
                                            data_dir=out_dir, device=dev,
                                            build_bvh=True)
    sc_gltf, cfg_gltf = presets.masterchief(
        data_dir=out_dir, spp=GLTF_SPP, height=cfg.height,
        asset="relief.gltf", device=dev)
    sc_glb, _ = presets.masterchief(data_dir=out_dir, spp=GLTF_SPP,
                                    height=cfg.height, asset="relief.glb",
                                    device=dev)
    for name in SceneData._fields:
        a, b, c = (getattr(x, name) for x in (sc_gltf, sc_glb, standin))
        if not (torch.equal(a, b) and torch.equal(a, c)):
            raise AssertionError(f"the loaded scenes' {name} differs from "
                                 "the stand-in's")
    if cfg_gltf != cfg:
        raise AssertionError("the glTF preset's config differs")
    T = sc_glb.num_triangles
    log(f"glTF: relief.gltf ({os.path.getsize(gltf_path)} B, embedded "
        f"base64) and relief.glb ({os.path.getsize(glb_path)} B, TRS node "
        f"over a matrix node): {T} triangles, uint32 indices, 2 PNG "
        f"textures; both scenes equal flagship_standin(n=39)'s in every "
        f"field, bit for bit (the nodes' transform is exact in float32)")

    calls, _ = frame_plan(cfg)
    W, H = cfg.width, cfg.height
    reset_counts()
    t0 = time.perf_counter()
    img = renderer.render_image(sc_glb, cfg)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts()
    expect = frame_counts(_cuda.KERNELS, calls)
    log(f"glb frame launches: {counts} (expected {expect})")
    if counts != expect:
        raise AssertionError(f"launch counts {counts} != {expect}")
    accum = renderer.render_accumulate(sc_glb, cfg)
    if not np.isfinite(accum).all():
        raise AssertionError("non-finite radiance in the glb frame")
    if not np.array_equal(color.to_uint8(color.resolve(accum, GLTF_SPP)),
                          img):
        raise AssertionError("a second glb frame differs from the first")
    if img.shape != (H, W, 3) or img.std() < 5.0:
        raise AssertionError("glb frame is constant or misshapen")
    camera = Camera.from_config(cfg.camera, cfg.aspect, device=dev)
    pid = torch.arange(W * H, dtype=torch.int32, device=dev)
    prim, _ = find_hit(sc_glb, *primary_rays(
        torch, rng, camera, rng.key(cfg.seed, device=dev), W, H, pid))
    share = float(((prim >= 0) & (prim < T)).float().mean())
    paths = W * H * GLTF_SPP
    log(f"glb frame: {W}x{H}, {GLTF_SPP} spp, {cfg.max_bounce} bounces: "
        f"{seconds:.3f} s, {paths * cfg.max_bounce / seconds / 1e6:.2f} "
        f"Mrays/s (paths x {cfg.max_bounce}); repeatable, finite; mean "
        f"{img.mean():.2f}, std {img.std():.2f}; primary rays hitting a "
        f"triangle {100 * share:.2f}%; {smi}")
    if share < 0.05:
        raise AssertionError(f"only {100 * share:.2f}% of primary rays hit "
                             "a triangle (need >= 5%)")

    # the command line's entry point in a subprocess: the .gltf rendered
    # as square.gltf
    os.replace(gltf_path, os.path.join(out_dir, "square.gltf"))
    png = os.path.join(out_dir, "cli_render.png")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "sexy_raytracer_tpu_torch", "render",
         "--preset", "square", "--data-dir", out_dir, "--height", str(H),
         "--spp", str(GLTF_SPP), "--out", png],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
        text=True, timeout=600)
    tail = [ln for ln in proc.stderr.splitlines() if ln.strip()][-3:]
    log(f"cli render: exit {proc.returncode} in "
        f"{time.perf_counter() - t0:.1f} s; " + " | ".join(tail))
    got = read_png(png, 3) if os.path.exists(png) else None
    if proc.returncode != 0 or got is None or got.shape[:2] != (H, W):
        raise AssertionError(f"cli render failed:\n{proc.stderr[-3000:]}")
    log(f"phase 10b: {time.perf_counter() - t10:.1f} s")
    return counts


def cli_inverse_phase(torch, dev, out_dir, shirley_png, reset_counts,
                      read_counts, hold):
    """Phase 10c: the command line's ``main(["inverse", "--preset",
    "shirley_parity", ...])`` in this process against phase 10's frame
    downscaled to 320x180: 3 steps of 4,096 pixels at spb 4, then the
    64-spp preview, with the launch counters around it; every call of
    kernels 5, 6 and 7 in the last step held to its plain version by
    ``hold(name, inputs, label)`` (phase 3's checks); 3 finite losses and
    a PNG of the size. Returns the launch counts."""
    from sexy_raytracer_tpu_torch import __main__ as cli
    from sexy_raytracer_tpu_torch.models import presets
    from sexy_raytracer_tpu_torch.ops import _cuda, fused, histogram
    from sexy_raytracer_tpu_torch.tools.histogram_split import capture_calls
    from sexy_raytracer_tpu_torch.utils.png import read_png, write_png

    t10 = time.perf_counter()
    target = read_png(shirley_png, 3).astype(np.float64)
    th, tw = target.shape[0] // 4, target.shape[1] // 4
    small = target.reshape(th, 4, tw, 4, 3).mean(axis=(1, 3))
    tgt = os.path.join(out_dir, "shirley_target.png")
    write_png(tgt, np.round(small).astype(np.uint8))
    png = os.path.join(out_dir, "cli_inverse.png")
    losses_path = os.path.join(out_dir, "losses.json")
    argv = ["inverse", "--preset", "shirley_parity", "--height", str(th),
            "--target", tgt, "--steps", str(CLI_STEPS), "--pixels-per-step",
            str(CLI_PIXELS), "--spb", str(CLI_SPB), "--preview-spp",
            str(CLI_PREVIEW_SPP), "--losses-out", losses_path, "--out", png]
    # per step one forward call (phase 4's counts) and kernels 5-7 at each
    # of its 4 bounces (the spheres train, so bounce 0's hit record needs
    # its gradient too); then the preview frame
    _, cfg = presets.shirley_parity(height=th, device=dev)
    preview_calls, _ = frame_plan(dataclasses.replace(
        cfg, samples_per_pixel=CLI_PREVIEW_SPP))
    expect = frame_counts(_cuda.KERNELS, CLI_STEPS + preview_calls)
    expect.update({k: 4 * CLI_STEPS for k in (
        "srt_hitrec_bwd", "srt_shade_bwd", "srt_histogram")})
    rcs = []
    reset_counts()
    t0 = time.perf_counter()
    got = capture_calls(
        [fused, fused, histogram],
        ["hitrec_bwd", "shade_bwd", "dense_histogram"],
        lambda: rcs.append(cli.main(argv)))
    seconds = time.perf_counter() - t0
    counts = read_counts()
    log(f"cli inverse launches ({CLI_STEPS} steps of {CLI_PIXELS} pixels x "
        f"spb {CLI_SPB}, then the {tw}x{th} {CLI_PREVIEW_SPP}-spp preview "
        f"in {preview_calls} calls): {counts} (expected {expect}); "
        f"{seconds:.1f} s with the scene's build")
    if rcs != [0] or counts != expect:
        raise AssertionError(f"inverse exited {rcs}; launch counts {counts} "
                             f"!= {expect}")
    # the last step's calls, bounce 3 first (the backward's order); the
    # last bounce's hit record gets a zero cotangent (no later bounce reads
    # it), so there is nothing to hold (tests/test_torch_cuda.py)
    held = 0
    for name, calls in got.items():
        for b, inp in zip((3, 2, 1, 0), calls[-4:]):
            label = f"cli inverse step {CLI_STEPS} bounce {b}"
            if name == "hitrec_bwd" and not bool(inp[-1].any()):
                log(f"kernel {name} [{label}]: zero cotangent, not held")
                continue
            hold(name, inp, label)
            held += 1
    if held < 11:
        raise AssertionError(f"cli inverse: {held} of the last step's 12 "
                             "backward calls held (need 11)")
    img = read_png(png, 3) if os.path.exists(png) else None
    with open(losses_path) as f:
        losses = json.load(f)
    log(f"cli inverse: preview {None if img is None else img.shape}, "
        f"losses {losses}")
    if img is None or img.shape[:2] != (th, tw):
        raise AssertionError("cli inverse wrote no preview of the size")
    if len(losses) != CLI_STEPS or not np.isfinite(losses).all():
        raise AssertionError(f"cli inverse wrote losses {losses}")
    log(f"phase 10c: {time.perf_counter() - t10:.1f} s")
    return counts


# phase 11: the mesh paths
MESH_STEPS, MESH_INV_STEPS, MESH_TIMED_STEPS = 3, 5, 8


def mesh_phase(torch, dev, scene, cfg, camera, frame_float, frame_s,
               train_ids, train_tgt, step6_s, inverse_setup, train_per_step,
               n_chunks, reset_counts, read_counts, smi):
    """Phase 11a: one NCCL rank, a (1, 1) mesh on this card. The sharded
    frame (counted) equals phase 4's float image bit for bit; three train
    steps with the mesh (counted) equal three without it, and five steps of
    phase 9's ``inverse_render`` likewise; the frame's seconds and the
    step's ms beside the same without a mesh, in turns, and phases 5-6.
    Returns the sharded frame's and steps' launch counts and the reference
    of the steps without a mesh (losses, step 0's loss and gradients)."""
    import torch.distributed as dist

    from sexy_raytracer_tpu_torch.diff.inverse import (
        inverse_render,
        make_optimizer,
        make_train_step,
    )
    from sexy_raytracer_tpu_torch.diff.params import extract_params
    from sexy_raytracer_tpu_torch.models.scene import SceneData
    from sexy_raytracer_tpu_torch.ops import _cuda
    from sexy_raytracer_tpu_torch.parallel import (
        init_distributed,
        make_mesh,
        render_sharded,
        shard_rays,
    )
    from sexy_raytracer_tpu_torch.parallel.mesh import free_port
    from sexy_raytracer_tpu_torch.render import renderer
    from sexy_raytracer_tpu_torch.render.integrator import (
        scene_no_emissive_tris,
    )
    from sexy_raytracer_tpu_torch.tools.histogram_split import (
        TRAIN_SPB,
        run_steps,
    )
    from sexy_raytracer_tpu_torch.utils import rng

    t11 = time.perf_counter()
    init_distributed(f"127.0.0.1:{free_port()}", 1, 0, device=dev)
    try:
        want = "nccl" if dev.type == "cuda" else "gloo"
        if dist.get_backend() != want:
            raise AssertionError(f"backend {dist.get_backend()}, not {want}")
        mesh = make_mesh(1, 1, device_type=dev.type)

        reset_counts()
        t0 = time.perf_counter()
        img = render_sharded(scene, cfg, mesh)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        frame_n = read_counts()
        expect = frame_counts(_cuda.KERNELS, n_chunks)
        log(f"sharded frame launches, (1, 1) mesh over NCCL: {frame_n} "
            f"(expected {expect})")
        if frame_n != expect:
            raise AssertionError(f"launch counts {frame_n} != {expect}")
        differ = np.argwhere((img != frame_float).any(axis=-1))
        if img.shape != frame_float.shape or len(differ):
            raise AssertionError(
                f"the sharded frame differs from phase 4's in {len(differ)} "
                f"pixels (row, col), first {differ[:8].tolist()}")
        frame_s_by = {"plain": [], "mesh": []}
        for name in ("plain", "mesh", "mesh", "plain"):
            t0 = time.perf_counter()
            if name == "plain":
                renderer.render(scene, cfg)
            else:
                render_sharded(scene, cfg, mesh)
            torch.cuda.synchronize()
            frame_s_by[name].append(time.perf_counter() - t0)
        sharded_s, plain_s = frame_s_by["mesh"], frame_s_by["plain"]
        log(f"sharded frame on a (1, 1) mesh: bit-equal to phase 4's float "
            f"image; the first {first_s:.3f} s (with the NCCL "
            f"communicators' set-up), then {sharded_s[0]:.3f} / "
            f"{sharded_s[1]:.3f} s, without the mesh {plain_s[0]:.3f} / "
            f"{plain_s[1]:.3f} s in turns (plain, mesh, mesh, plain: mesh - "
            f"plain {(sum(sharded_s) - sum(plain_s)) / 2 * 1e3:.1f} ms a "
            f"frame); phase 5's frame {frame_s:.3f} s (host clock, {smi})")

        vis_ok = scene_no_emissive_tris(scene)

        def new_step(m):
            step = make_train_step(
                cfg, make_optimizer(extract_params(scene), 1e-3),
                spb=TRAIN_SPB, last_bounce_vis=vis_ok, mesh=m)
            return step, step.init(extract_params(scene))

        plain, p_state = new_step(None)
        sharded, s_state = new_step(mesh)
        loss0, grads0 = plain.value_and_grad(p_state.params, scene, camera,
                                             train_ids, train_tgt,
                                             rng.key(0, dev))
        p_state, p_losses, _ = run_steps(plain, p_state, scene, camera,
                                         train_ids, train_tgt, MESH_STEPS, 0,
                                         dev)
        s_ids, s_tgt = shard_rays(train_ids, mesh), shard_rays(train_tgt, mesh)
        reset_counts()
        s_state, s_losses, _ = run_steps(sharded, s_state, scene, camera,
                                         s_ids, s_tgt, MESH_STEPS, 0, dev)
        step_n = read_counts()
        expect = {k: MESH_STEPS * v for k, v in train_per_step.items()}
        log(f"sharded train launches over {MESH_STEPS} steps: {step_n} "
            f"(expected {expect})")
        if step_n != expect:
            raise AssertionError(f"launch counts {step_n} != {expect}")
        p_losses = [float(x) for x in p_losses]
        s_losses = [float(x) for x in s_losses]
        same = [k for k in p_state.params
                if torch.equal(p_state.params[k], s_state.params[k])]
        log(f"sharded train steps on a (1, 1) mesh: losses {s_losses}, "
            f"without the mesh {p_losses}; parameters bit-equal: "
            f"{len(same)} of {len(p_state.params)}")
        if s_losses != p_losses or len(same) != len(p_state.params):
            raise AssertionError("the (1, 1) mesh's steps differ from the "
                                 "steps without a mesh")
        step_ms = {"plain": [], "mesh": []}
        for name in ("plain", "mesh", "mesh", "plain"):
            if name == "plain":
                p_state, _, sec = run_steps(plain, p_state, scene, camera,
                                            train_ids, train_tgt,
                                            MESH_TIMED_STEPS, 100, dev)
            else:
                s_state, _, sec = run_steps(sharded, s_state, scene, camera,
                                            s_ids, s_tgt, MESH_TIMED_STEPS,
                                            100, dev)
            step_ms[name].append(sec * 1e3)
        log(f"sharded train step: {step_ms['mesh'][0]:.3f} / "
            f"{step_ms['mesh'][1]:.3f} ms, without the mesh "
            f"{step_ms['plain'][0]:.3f} / {step_ms['plain'][1]:.3f} ms in "
            f"turns (plain, mesh, mesh, plain; mean of {MESH_TIMED_STEPS} "
            f"steps each, host clock); phase 6's step {step6_s * 1e3:.3f} "
            f"ms; {smi}")

        inv = inverse_setup
        runs = [inverse_render(inv["scene"], inv["target"], inv["cfg"],
                               n_steps=MESH_INV_STEPS, mesh=m, **inv["kw"])
                for m in (None, mesh)]
        (opt_p, losses_p), (opt_s, losses_s) = runs
        differ = [k for k in SceneData._fields
                  if not torch.equal(getattr(opt_p, k), getattr(opt_s, k))]
        log(f"inverse_render on a (1, 1) mesh, {MESH_INV_STEPS} steps of "
            f"phase 9's CRN run: losses {losses_s}, without the mesh "
            f"{losses_p}; scene fields that differ: {differ}")
        if losses_s != losses_p or differ:
            raise AssertionError("inverse_render(mesh=) differs from the "
                                 "call without a mesh")
    finally:
        dist.destroy_process_group()
    log(f"phase 11a: {time.perf_counter() - t11:.1f} s")
    return frame_n, step_n, img, dict(
        losses=p_losses, loss0=float(loss0),
        grads0={k: g.double().cpu() for k, g in grads0.items()})


def _two_ranks_on_one_card(device_type):
    """A rank of phase 11b: the stand-in's frame on (2, 1) and (1, 2)
    meshes, then three train steps of phase 6's batch on (2, 1), with step
    0's loss and gradient."""
    import torch

    from sexy_raytracer_tpu_torch.diff.inverse import (
        make_optimizer,
        make_train_step,
    )
    from sexy_raytracer_tpu_torch.diff.params import extract_params
    from sexy_raytracer_tpu_torch.parallel import (
        make_mesh,
        render_sharded,
        shard_rays,
    )
    from sexy_raytracer_tpu_torch.parallel.mesh import mesh_device
    from sexy_raytracer_tpu_torch.render.integrator import (
        scene_no_emissive_tris,
    )
    from sexy_raytracer_tpu_torch.tools.histogram_split import (
        TRAIN_SPB,
        run_steps,
        train_setup,
    )
    from sexy_raytracer_tpu_torch.utils import rng

    meshes = {shape: make_mesh(*shape, device_type=device_type)
              for shape in ((2, 1), (1, 2))}
    dev = mesh_device(meshes[(2, 1)])
    scene, cfg, camera, ids, tgt, _ = train_setup(dev)
    out = {"frames": {}, "frame_s": {}}
    for shape, mesh in meshes.items():
        t0 = time.perf_counter()
        out["frames"][shape] = render_sharded(scene, cfg, mesh)
        torch.cuda.synchronize()
        out["frame_s"][shape] = time.perf_counter() - t0
    mesh = meshes[(2, 1)]
    step = make_train_step(cfg, make_optimizer(extract_params(scene), 1e-3),
                           spb=TRAIN_SPB,
                           last_bounce_vis=scene_no_emissive_tris(scene),
                           mesh=mesh)
    state = step.init(extract_params(scene))
    ids, tgt = shard_rays(ids, mesh), shard_rays(tgt, mesh)
    loss0, grads0 = step.value_and_grad(state.params, scene, camera, ids,
                                        tgt, rng.key(0, dev))
    state, losses, step_s = run_steps(step, state, scene, camera, ids, tgt,
                                      MESH_STEPS, 0, dev)
    out.update(losses=[float(x) for x in losses], step_s=step_s,
               params={k: v.cpu() for k, v in state.params.items()},
               loss0=float(loss0),
               grads0={k: g.double().cpu() for k, g in grads0.items()})
    return out


def gloo_phase(torch, frame_img, train_ref, smi):
    """Phase 11b: two ranks on this one card over gloo (NCCL refuses two
    ranks on one GPU): the (2, 1) frame within the trace parity budget of
    11a's, the (1, 2) frame within JAX's sharded tolerance; three steps on
    (2, 1) bit-identical across the ranks, their losses within relative
    1e-5 of 11a's steps without a mesh, step 0's gradient within
    bench.py:192's gate."""
    from sexy_raytracer_tpu_torch.parallel import spawn

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    ranks = spawn(_two_ranks_on_one_card, 2, "gloo", "cuda", "cuda",
                  timeout=600)
    phase_s = time.perf_counter() - t0
    for shape in ((2, 1), (1, 2)):
        a, b = (r["frames"][shape] for r in ranks)
        if not np.array_equal(a, b):
            raise AssertionError(f"the ranks' {shape} frames differ")
        if shape == (2, 1):
            close = np.isclose(a, frame_img, atol=2e-5, rtol=1e-5).all(-1)
            out = np.argwhere(~close)
            text = (f"{len(out)} of {close.size} pixels outside atol 2e-5 "
                    f"rtol 1e-5 (budget 0.5%): {out[:20].tolist()}")
            ok = close.mean() >= 0.995
        else:
            close = np.isclose(a, frame_img, atol=2e-5, rtol=1e-4)
            text = (f"{int((~close).sum())} values outside atol 2e-5 rtol "
                    "1e-4")
            ok = close.all()
        log(f"sharded frame on a {shape} mesh (2 gloo ranks, one card): "
            f"{int((a != frame_img).any(-1).sum())} pixels not bit-equal to "
            f"11a's; {text}; max abs diff "
            f"{float(np.abs(a - frame_img).max()):.3g}")
        if not ok:
            raise AssertionError(f"the {shape} frame is outside its tolerance")
    r0, r1 = ranks
    same = r0["losses"] == r1["losses"] and all(
        torch.equal(r0["params"][k], r1["params"][k]) for k in r0["params"])
    rel = [abs(a - b) / abs(b) for a, b in zip(r0["losses"],
                                               train_ref["losses"])]
    rel0 = abs(r0["loss0"] - train_ref["loss0"]) / abs(train_ref["loss0"])
    rel_g = {k: float((r0["grads0"][k] - g).abs().max())
             / max(float(g.abs().max()), 1e-12)
             for k, g in train_ref["grads0"].items()}
    log(f"sharded train steps on a (2, 1) mesh (2 gloo ranks, one card): "
        f"losses {r0['losses']}, the same on both ranks with bit-identical "
        f"parameters: {same}; relative to one rank's steps on the same "
        f"batch {[f'{x:.2e}' for x in rel]}; step 0 loss rel {rel0:.2e}, rel "
        f"grad " + ", ".join(f"{k} {v:.2e}" for k, v in rel_g.items()))
    if not same or max(rel) > 1e-5 or rel0 > 1e-3 \
            or max(rel_g.values()) > 1e-2:
        raise AssertionError("the two ranks' steps are not bit-identical or "
                             "not within tolerance of one rank's")
    log(f"2 gloo ranks on one card (they share it: no scaling figure): "
        f"frames (2, 1) "
        + " / ".join(f"{r['frame_s'][(2, 1)]:.3f}" for r in ranks)
        + " s, (1, 2) "
        + " / ".join(f"{r['frame_s'][(1, 2)]:.3f}" for r in ranks)
        + f" s (first frames of each process); step "
        + " / ".join(f"{r['step_s'] * 1e3:.3f}" for r in ranks)
        + f" ms (mean of {MESH_STEPS}, host clock); phase {phase_s:.1f} s "
          f"with the spawn; {smi}")


def graft_phase(torch, dev):
    """Phase 11c: ``graft_entry.entry()``'s fn on the card, and
    ``dryrun_multichip(1)`` over NCCL in a subprocess."""
    from sexy_raytracer_tpu_torch import graft_entry

    fn, args = graft_entry.entry()
    out = fn(*args)
    torch.cuda.synchronize()
    finite = bool(torch.isfinite(out).all())
    log(f"graft_entry.entry(): fn(*example_args) -> {tuple(out.shape)} "
        f"{out.dtype} on {out.device}, finite: {finite}, mean "
        f"{float(out.mean()):.4f}")
    if tuple(out.shape) != (2048, 3) or not finite \
            or out.device.type != "cuda":
        raise AssertionError("entry()'s fn failed")
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "sexy_raytracer_tpu_torch.graft_entry",
         "dryrun", "1"],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
        text=True, timeout=600)
    line = [x for x in r.stdout.splitlines()
            if x.startswith("dryrun_multichip(1): ok")]
    log(f"graft_entry dryrun 1 (NCCL): exit {r.returncode} in "
        f"{time.perf_counter() - t0:.1f} s; {line}")
    if r.returncode != 0 or not line:
        raise AssertionError(f"dryrun_multichip(1) failed:\n{r.stdout}\n"
                             f"{r.stderr[-4000:]}")


# phase 12: the root tools' counterparts (sexy_raytracer_tpu_torch/tools/)
# at shortened length: steps of each inverse stage, silhouette steps, and
# the flagship render's spp; the referee and the diagnostics at full size
TOOL_STEPS, TOOL_SIL_STEPS, TOOL_SPP = 10, 20, 8


def counts_of(kernels, per_call, calls=1):
    """The launch counts of ``calls`` runs of ``per_call`` ({symbol: n}),
    every other kernel 0."""
    expect = {k.symbol: 0 for k in kernels}
    for k, v in per_call.items():
        expect[k] += calls * v
    return expect


def add_counts(*counts):
    return {k: sum(c[k] for c in counts) for k in counts[0]}


def tools_phase(torch, dev, train_per_step, frame_float, reset_counts,
                read_counts, smi):
    """Phase 12: each ported tool through its own functions on the card,
    counted: the inverse experiment's phases 1, 1b and 1c (``TOOL_STEPS``
    steps a stage, ``TOOL_SIL_STEPS`` silhouette steps; finite losses, the
    exact objective falling in phases 1 and 1b, the iron sphere moving
    towards the truth); the flagship render's command line at 720p,
    ``TOOL_SPP`` spp, interrupted after a chunk and resumed bit-equal,
    within the trace parity budget of phase 4's frame; the scaling
    curve's one-rank NCCL point in a subprocess, its chunk bit-equal to
    ``render_pixels`` here; the referee (no kernel-vs-bruteforce mismatch
    outside the near-tie rule) and the diagnostics (compaction parity 0)
    at 131,072 rays. Returns the launch counts by tool."""
    from sexy_raytracer_tpu_torch.models import presets
    from sexy_raytracer_tpu_torch.ops import _cuda
    from sexy_raytracer_tpu_torch.render import renderer
    from sexy_raytracer_tpu_torch.render.camera import Camera
    from sexy_raytracer_tpu_torch.tools import check_find_referee as referee
    from sexy_raytracer_tpu_torch.tools import diag_r5
    from sexy_raytracer_tpu_torch.tools import run_flagship_render as flagship
    from sexy_raytracer_tpu_torch.tools import run_inverse_experiment as inv
    from sexy_raytracer_tpu_torch.tools import run_scaling_curve as scaling
    from sexy_raytracer_tpu_torch.utils import color, rng

    t12 = time.perf_counter()
    K = _cuda.KERNELS
    by_tool = {}
    # per step: phase 6's counts, kernel 5 at bounces 1-3 (phase 9)
    inv_step = dict(train_per_step)
    inv_step["srt_hitrec_bwd"] -= 1
    # a trace without the last-bounce shortcut: find, hit record, shade
    # at each of the 4 bounces
    trace4 = {"srt_find_closest": 4, "srt_hitrec": 4, "srt_shade": 4}

    def frame_calls(cfg):
        return frame_counts(K, frame_plan(cfg)[0])

    arts = inv.ART, flagship.ART
    with tempfile.TemporaryDirectory() as art:
        # 12a. the inverse experiment
        inv.ART = art
        _, cfg240, _ = presets.flagship(height=inv.HEIGHT,
                                        spp=inv.TARGET_SPP, device=dev)
        frame240 = frame_calls(cfg240)
        report, t0 = {}, time.perf_counter()
        reset_counts()
        crn = inv.phase1_crn(report, dev, n_steps=TOOL_STEPS)
        got = inv_counts = read_counts()
        # the target, the recovered and the perturbed re-render
        want = add_counts(frame240, frame240, frame240,
                          counts_of(K, inv_step, TOOL_STEPS))
        log(f"tools: inverse phase 1 (CRN, {TOOL_STEPS} steps) launches "
            f"{got} (expected {want}: 3 frames of 240p x "
            f"{inv.TARGET_SPP} spp, phase 9's counts a step)")
        if got != want:
            raise AssertionError(f"launch counts {got} != {want}")
        stages = {"0": {}, "0b": {}, "A": {}, "B": {}}
        reset_counts()
        nocrn = inv.phase1b_stochastic(
            report, dev, stage_kw={s: dict(n_steps=TOOL_STEPS)
                                   for s in stages})
        got = read_counts()
        want = add_counts(frame240, counts_of(K, inv_step, 4 * TOOL_STEPS))
        inv_counts = add_counts(inv_counts, got)
        log(f"tools: inverse phase 1b (4 stages of {TOOL_STEPS} steps) "
            f"launches {got} (expected {want}: the recovered re-render, "
            f"phase 9's counts a step)")
        if got != want:
            raise AssertionError(f"launch counts {got} != {want}")
        reset_counts()
        inv.phase1c_silhouette(report, dev, n_steps=TOOL_SIL_STEPS)
        got = read_counts()
        want = counts_of(K, trace4, TOOL_SIL_STEPS)
        log(f"tools: inverse phase 1c ({TOOL_SIL_STEPS} silhouette steps, "
            f"n_edge 512) launches {got} (expected {want}: one trace of "
            f"the edge rays a step)")
        if got != want:
            raise AssertionError(f"launch counts {got} != {want}")
        by_tool["inverse_tool"] = add_counts(inv_counts, got)
        for s, part in zip(stages, np.split(np.asarray(nocrn), 4)):
            stages[s] = [float(x) for x in part]
        # each step draws other tiles, so a short run's per-step losses
        # need not fall; the exact objective (deterministic re-renders
        # against the target in the ROI) must
        log(f"tools: inverse losses, CRN {crn[0]:.6g} -> {crn[-1]:.6g}; "
            "1b stages "
            + ", ".join(f"{s} {v[0]:.6g} -> {v[-1]:.6g}"
                        for s, v in stages.items())
            + f"; exact objective, perturbed / recovered: CRN "
              f"{report['crn_exact_mse_ratio']}, no CRN "
              f"{report['nocrn_exact_mse_ratio']}; silhouette centre error "
              f"{report['silhouette_center_err_start']:.4f} -> "
              f"{report['silhouette_center_err_final']:.4f}; "
              f"{time.perf_counter() - t0:.1f} s")
        finite = np.isfinite(crn).all() and np.isfinite(nocrn).all()
        if not finite or not report["crn_exact_mse_ratio"] > 1.0 \
                or not report["nocrn_exact_mse_ratio"] > 1.0 \
                or not report["silhouette_center_err_final"] \
                < report["silhouette_center_err_start"]:
            raise AssertionError("the short inverse stages failed")

        # 12b. the flagship render: its command line, then a render
        # interrupted after one chunk and resumed from its checkpoint
        flagship.ART = art
        _, cfg720, _ = presets.flagship(height=flagship.HEIGHT, spp=TOOL_SPP,
                                        device=dev)
        cfg720 = dataclasses.replace(cfg720, samples_per_batch=4)
        calls, chunk = frame_plan(cfg720)
        t0 = time.perf_counter()
        reset_counts()
        rc = flagship.main(["--spp", str(TOOL_SPP)])
        got = read_counts()
        want = frame_counts(K, calls)
        with open(os.path.join(art, "report.json")) as f:
            keys = sorted(json.load(f))
        log(f"tools: flagship command line ({TOOL_SPP} spp, 4 a batch, "
            f"{calls} render_pixels calls) exit {rc}, launches {got} "
            f"(expected {want}); report keys {keys}")
        left = os.path.exists(flagship.checkpoint_path(
            presets.flagship_name(), TOOL_SPP))
        if rc != 0 or got != want or left or keys != sorted(
                ["scene", "device", "spp", "method", "wall_s",
                 "mpaths_per_s"]):
            raise AssertionError("the flagship command line failed "
                                 f"(checkpoint left: {left})")
        full, _, _ = flagship.render(TOOL_SPP, device=dev)

        class Interrupt(Exception):
            pass

        per_chunk = calls // -(-cfg720.width * cfg720.height // chunk)
        real, seen = renderer.render_pixels, [0]

        def cut(*a, **kw):
            seen[0] += 1
            if seen[0] > per_chunk:
                raise Interrupt()
            return real(*a, **kw)

        ckpt = os.path.join(art, "interrupted.npz")
        renderer.render_pixels = cut
        try:
            flagship.render(TOOL_SPP, device=dev, checkpoint=ckpt)
            raise AssertionError("the render was not interrupted")
        except Interrupt:
            pass
        finally:
            renderer.render_pixels = real
        resumed, _, _ = flagship.render(TOOL_SPP, device=dev,
                                        checkpoint=ckpt)
        img = color.resolve(full, TOOL_SPP)
        close = np.isclose(img, frame_float, atol=2e-5, rtol=1e-5).all(-1)
        log(f"tools: flagship render interrupted after {per_chunk} "
            f"render_pixels calls (one chunk) and resumed: bit-equal to the "
            f"uninterrupted render: {np.array_equal(resumed, full)}; against "
            f"phase 4's frame {int((~close).sum())} of {close.size} pixels "
            f"outside atol 2e-5 rtol 1e-5 (budget 0.5%), max abs diff "
            f"{float(np.abs(img - frame_float).max()):.3g}; "
            f"{time.perf_counter() - t0:.1f} s")
        if not np.array_equal(resumed, full) or close.mean() < 0.995:
            raise AssertionError("the flagship render's resume or parity "
                                 "failed")
        by_tool["flagship_tool"] = got
    inv.ART, flagship.ART = arts

    # 12c. the scaling curve's one-rank NCCL point, in a subprocess
    t0 = time.perf_counter()
    row, chunk_rad = scaling.measure(1, "cuda")
    scene240, cfg240, _ = presets.flagship(height=scaling.HEIGHT,
                                           spp=scaling.SPP_TOTAL, device=dev)
    ids = torch.from_numpy(renderer.tile_pixel_order(
        cfg240.width, cfg240.height)[:scaling.PIXELS]).to(dev)
    here = renderer.render_pixels(
        scene240, Camera.from_config(cfg240.camera, cfg240.aspect,
                                     device=dev),
        ids, 2 * scaling.REPS, rng.key(0, dev),
        torch.tensor(cfg240.background, device=dev), width=cfg240.width,
        height=cfg240.height, spb=scaling.SPB, spp_total=scaling.SPP_TOTAL,
        max_bounce=cfg240.max_bounce, method="bruteforce").cpu().numpy()
    launched = {k: v for k, v in row["launches_per_chunk"].items() if v}
    log(f"tools: scaling curve, one NCCL rank in a subprocess: "
        f"{row['seconds_per_chunk'] * 1e3:.3f} ms a chunk, "
        f"{row['mrays_per_s']:.3f} Mrays/s ({scaling.PIXELS} pixels x spb "
        f"{scaling.SPB} x 4 bounces, bruteforce find); launches a chunk "
        f"{launched} (the find is plain PyTorch: the hit record and shade "
        f"at each bounce, no last-bounce shortcut); its chunk bit-equal to "
        f"render_pixels here: {np.array_equal(chunk_rad, here)}; "
        f"{time.perf_counter() - t0:.1f} s with the spawn ({smi})")
    if launched != {"srt_hitrec": 4, "srt_shade": 4} \
            or not np.array_equal(chunk_rad, here):
        raise AssertionError("the scaling curve's one-rank point failed")

    # 12d. the referee: kernel 1 once, then 7 calls a timed mode
    t0 = time.perf_counter()
    reset_counts()
    res = referee.run(dev)
    got = read_counts()
    want = counts_of(K, {"srt_find_closest": 1 + len(referee.MODES) * 7})
    log(f"tools: referee {json.dumps(res)}; launches {got} (expected "
        f"{want}); {time.perf_counter() - t0:.1f} s")
    if got != want or res["outside_tie_rule"] or res["rays"] != referee.R:
        raise AssertionError("the referee found mismatches outside the "
                             "near-tie rule")
    by_tool["referee"] = got

    # 12e. the diagnostics: finds a population, compactions, frame calls
    t0 = time.perf_counter()
    reset_counts()
    res = diag_r5.run(dev)
    got = read_counts()
    n_pop, n_bounce = 6, 3
    finds = (n_bounce + n_pop * (1 + diag_r5.TIMED)
             + n_bounce * (1 + diag_r5.TIMED + 2))
    frames = len(diag_r5.FRAME_REGIONS) * (1 + diag_r5.FRAME_TIMED)
    want = add_counts(counts_of(K, {"srt_find_closest": finds}),
                      counts_of(K, trace4, frames))
    parity = {k: v for k, v in res.items() if k.startswith("compact_parity")}
    log(f"tools: diag {json.dumps(res)}; launches {got} (expected {want}); "
        f"{time.perf_counter() - t0:.1f} s")
    if got != want or len(parity) != n_bounce or any(parity.values()):
        raise AssertionError("the diagnostics' launches or compaction "
                             "parity failed")
    by_tool["diag"] = got
    log(f"phase 12: {time.perf_counter() - t12:.1f} s")
    return by_tool


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

    expect = frame_counts(_cuda.KERNELS, n_chunks)
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
    frame_float = color.resolve(accum, spp)
    again = color.to_uint8(frame_float)
    if not np.array_equal(again, img):
        raise AssertionError("a second frame differs from the first")
    if img.shape != (H, W, 3) or img.std() < 5.0:
        raise AssertionError(f"frame is constant or misshapen: {img.shape}, "
                             f"std {img.std():.2f}")

    # primary rays of every pixel (sample 0): share that hits a triangle
    pid = torch.arange(P, dtype=torch.int32, device=dev)
    o, d, tm = primary_rays(torch, rng, camera, base_key, W, H, pid)
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
    expect = frame_counts(_cuda.KERNELS, big_chunks, find="srt_find_streamed")
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
    counts, inverse_setup = inverse_phase(
        torch, dev, scene, cfg, relief, train_per_step, step_s, reset_counts,
        read_counts, smi)
    for name, c in kernel_checks.items():
        records[name]["launches_by_path"]["inverse"] = counts[c[3].symbol]

    # ---- 10. the Shirley field, the glTF path and the command line -------
    with tempfile.TemporaryDirectory() as out_dir:
        counts, shirley_png, timings = shirley_phase(
            torch, dev, out_dir, reset_counts, read_counts, smi)
        counts_b = gltf_phase(torch, dev, out_dir, reset_counts, read_counts,
                              smi)
        counts_c = cli_inverse_phase(
            torch, dev, out_dir, shirley_png, reset_counts, read_counts,
            lambda name, inp, label: check_only(
                name, inp, kernel_checks[name][0], label))
    for name, c in kernel_checks.items():
        records[name]["launches_by_path"]["shirley"] = counts[c[3].symbol]
        records[name]["launches_by_path"]["gltf"] = counts_b[c[3].symbol]
        records[name]["launches_by_path"]["cli_inverse"] = \
            counts_c[c[3].symbol]
    for name, t in timings.items():
        records[name]["shirley"] = t

    # ---- 11. the mesh paths: parallel/, make_train_step(mesh=), graft_entry
    frame_n, step_n, frame11, train_ref = mesh_phase(
        torch, dev, scene, cfg, camera, frame_float, seconds, train_ids,
        train_tgt, step_s, inverse_setup, train_per_step, n_chunks,
        reset_counts, read_counts, smi)
    for name, c in kernel_checks.items():
        records[name]["launches_by_path"]["sharded_frame"] = \
            frame_n[c[3].symbol]
        records[name]["launches_by_path"]["sharded_step"] = \
            step_n[c[3].symbol]
    gloo_phase(torch, frame11, train_ref, smi)
    graft_phase(torch, dev)
    del frame11, train_ref

    # ---- 12. the root tools' counterparts --------------------------------
    by_tool = tools_phase(torch, dev, train_per_step, frame_float,
                          reset_counts, read_counts, smi)
    for name, c in kernel_checks.items():
        for tool, counts in by_tool.items():
            records[name]["launches_by_path"][tool] = counts[c[3].symbol]

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
