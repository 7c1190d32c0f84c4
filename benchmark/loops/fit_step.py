"""Fit steps back to back: one user fitting the texel pack to a target
image by gradient descent with common random numbers, a closed loop.

Set-up renders the target from the true scene at ``target_spp`` samples
with the run's CRN key (``render_accumulate``, kept in memory), perturbs
the pack's colour channels to ``x * scale + offset``, and builds the
program's train step (``make_train_step``: MSE of the resolved render,
Adam with the channel mask, a cosine decay over ``decay_steps``). Each
step then does what ``inverse_render``'s loop does: draw
``pixels_per_step`` pixels in 128-pixel tiles inside the region of
interest, gather their target, take the step with the CRN key, and update
the parameters' running average. Set-up takes the first ``checked_steps``
steps through that same call and keeps their losses, the first gradient
as the optimizer holds it and the parameters' change; the window goes on
from that state. The window keeps the states before and after its last
``window_checked_steps`` steps (the step builds new tensors, so no copy)
and those steps' pixels and losses. The check follows the set-up steps
with the plain reference from the perturbed pack, and the window's last
steps from the program's parameters and moments before them, at the step
count the loop itself has counted.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from types import SimpleNamespace

import numpy as np
import torch

from benchmark import compare, devtrace, harness
from benchmark.loops import common
from benchmark.reference import fit as ref_fit
from benchmark.reference import render as ref
from benchmark.reference import rng as ref_rng
from sexy_raytracer_tpu_torch.diff.inverse import (
    make_optimizer,
    make_train_step,
)
from sexy_raytracer_tpu_torch.render.camera import Camera
from sexy_raytracer_tpu_torch.render.integrator import scene_no_emissive_tris
from sexy_raytracer_tpu_torch.render.renderer import render_accumulate
from sexy_raytracer_tpu_torch.utils import rng

PARAM = "shade_atlas"


def sample_tile_ids(rs, width, height, n_pixels, roi, tile_w=16, tile_h=8):
    """``n_pixels`` pixel ids in random ``tile_w x tile_h`` screen tiles
    inside ``roi`` (row0, row1, col0, col1), tiles on the ceil-grid with
    the last row and column clamped inward."""
    n_tiles = max(1, n_pixels // (tile_w * tile_h))
    r0, r1, c0, c1 = roi
    ntx = max(1, -(-(c1 - c0) // tile_w))
    nty = max(1, -(-(r1 - r0) // tile_h))
    x0 = np.minimum(np.minimum(c0 + rs.integers(0, ntx, size=n_tiles) * tile_w,
                               max(c1 - tile_w, c0)), max(width - tile_w, 0))
    y0 = np.minimum(np.minimum(r0 + rs.integers(0, nty, size=n_tiles) * tile_h,
                               max(r1 - tile_h, r0)), max(height - tile_h, 0))
    y = np.minimum(y0[:, None, None] + np.arange(tile_h)[None, :, None],
                   height - 1)
    x = np.minimum(x0[:, None, None] + np.arange(tile_w)[None, None, :],
                   width - 1)
    ids = (y * width + x).reshape(-1)
    if ids.size < n_pixels:
        ids = np.concatenate([ids, ids[:n_pixels - ids.size]])
    return ids[:n_pixels].astype(np.int32)


def perturb(atlas, tr):
    """The colour channels moved to ``x * scale + offset`` in [0, 255]."""
    lo, hi = tr["channels"]
    out = atlas.clone()
    out[..., lo:hi] = torch.clamp(
        atlas[..., lo:hi] * tr["perturb_scale"] + tr["perturb_offset"],
        0.0, 255.0)
    return out


def channel_mask(tr, like):
    lo, hi = tr["channels"]
    m = torch.zeros((1, 1, 1, like.shape[-1]), dtype=like.dtype,
                    device=like.device)
    m[..., lo:hi] = 1.0
    return m


def crn_seed(seed):
    return int(seed) % (1 << 32)


def setup(cell, seed, dev, log):
    tr = cell.traffic
    W, H = tr["width"], tr["height"]
    desc, scene, cfg = common.program_scene(cell, seed, dev, W, H,
                                            tr["target_spp"])
    cfg = dataclasses.replace(cfg, seed=crn_seed(seed),
                              samples_per_batch=tr["target_spb"],
                              rays_per_chunk=tr["rays_per_chunk"])
    lin = render_accumulate(scene, cfg)
    target = np.clip(np.sqrt(np.clip(lin / tr["target_spp"], 1e-8, None)),
                     0, 0.999)
    target_flat = torch.as_tensor(target, dtype=torch.float32,
                                  device=dev.name).reshape(H * W, 3)
    scene = scene._replace(shade_atlas=perturb(scene.shade_atlas, tr))
    params = {PARAM: scene.shade_atlas}
    opt = make_optimizer(params, tr["learning_rate"],
                         decay_steps=tr["decay_steps"])
    step = make_train_step(
        cfg, opt, spb=tr["spb"], method="auto",
        grad_masks={PARAM: channel_mask(tr, scene.shade_atlas)},
        loss_type="mse", last_bounce_vis=scene_no_emissive_tris(scene))
    st = SimpleNamespace(
        desc=desc, cfg=cfg, tr=tr, scene=scene, step=step,
        state=step.init(params), target_flat=target_flat, ema=None,
        camera=Camera.from_config(cfg.camera, cfg.aspect, device=dev.name),
        key=rng.key(crn_seed(seed), device=dev.name),
        rs=np.random.default_rng(int(seed) % (1 << 63)), seed=seed,
        dev=dev, b1=opt.b1, steps=0)
    start = st.state.params[PARAM].clone()
    losses, batches = [], []
    for k in range(tr["checked_steps"]):
        ids, loss = one_step(st)
        batches.append(ids)
        losses.append(float(loss))
        if k == 0:
            grad_norm = compare.norm(first_grad(st, None, st.state))
    st.readings = dict(losses=losses, grad_norm=grad_norm,
                       change_norm=compare.norm(st.state.params[PARAM]
                                                - start))
    st.batches = batches
    log(f"set-up steps: losses {losses}")
    return st


def first_grad(st, before, after):
    """The gradient of the step from ``before`` (None: fresh moments) to
    ``after`` as the optimizer took it, from its first moments."""
    mu = after.opt_state.mu[PARAM]
    if before is not None:
        mu = mu - st.b1 * before.opt_state.mu[PARAM]
    return mu / (1.0 - st.b1)


def one_step(st):
    """One step of ``inverse_render``'s loop."""
    tr = st.tr
    ids = sample_tile_ids(st.rs, tr["width"], tr["height"],
                          tr["pixels_per_step"], tr["roi"])
    ids_dev = st.dev.upload(torch.from_numpy(ids))
    st.state, loss = st.step(st.state, st.scene, st.camera, ids_dev,
                             st.target_flat[ids_dev], st.key)
    with torch.no_grad():
        a = 1.0 - tr["param_ema"]
        st.ema = dict(st.state.params) if st.ema is None else {
            k: e + a * (st.state.params[k] - e) for k, e in st.ema.items()}
    st.steps += 1
    return ids, loss


def window(st, seconds, tracer, dev):
    from torch.profiler import record_function

    losses = []
    k = st.tr["window_checked_steps"]
    states, batches = deque([st.state], maxlen=k + 1), deque(maxlen=k)
    marks = [dev.event()]
    ahead = int(st.tr["steps_ahead"])
    waited = 0.0
    t0 = time.perf_counter()
    n = 0
    while time.perf_counter() - t0 < seconds or tracer.active:
        if n >= ahead:
            # at most ``ahead`` steps in flight: the card stays fed while
            # the host stalls, and the last wait is bounded
            tw = time.perf_counter()
            marks[n + 1 - ahead].synchronize()
            waited += time.perf_counter() - tw
        with record_function(harness.LABEL + "step"):
            ids, loss = one_step(st)
        losses.append(loss)
        states.append(st.state)
        batches.append(ids)
        marks.append(dev.event())
        n += 1
        tracer.tick(n, time.perf_counter() - t0)
    dev.sync()
    wall = time.perf_counter() - t0
    intervals = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    failed = int((~torch.isfinite(torch.stack(losses))).sum()) if losses \
        else 0
    sc = st.scene
    tr = st.tr
    states = list(states)
    followed = SimpleNamespace(
        count0=st.steps - len(batches), batches=list(batches),
        start={"params": states[0].params[PARAM].cpu(),
               "mu": states[0].opt_state.mu[PARAM].cpu(),
               "nu": states[0].opt_state.nu[PARAM].cpu()},
        readings=dict(
            losses=[float(x) for x in losses[-len(batches):]],
            grad_norm=compare.norm(first_grad(st, states[0], states[1])),
            change_norm=compare.norm(states[-1].params[PARAM]
                                     - states[0].params[PARAM])))
    return SimpleNamespace(
        unit="step", units=n, wall=wall, failed=failed, intervals=intervals,
        followed=followed,
        notes=[f"step intervals: median {devtrace.percentile(intervals, 50):.4f}"
               f" ms, p95 {devtrace.percentile(intervals, 95):.4f} ms, "
               f"{len(intervals)} steps; the host waited {waited:.4f} s "
               f"on steps in flight"] if intervals else [],
        shapes=dict(rays_per_launch=tr["pixels_per_step"] * tr["spb"],
                    triangles=int(sc.tri_v0.shape[0]),
                    spheres=int(sc.sph_c0.shape[0])))


def end_to_end(win, setup_s, window_peak):
    out = {"setup_s": setup_s, "step_ms": win.wall * 1e3 / max(win.units, 1),
           "peak_mem_gib": window_peak / 2**30}
    if win.intervals:
        out["step_ms_p95"] = devtrace.percentile(win.intervals, 95)
    return out


def release(st, win):
    return SimpleNamespace(desc=st.desc, cfg=st.cfg, tr=st.tr,
                           readings=st.readings, batches=st.batches,
                           followed=win.followed, seed=st.seed)


def reference_readings(cell, prog, dev, dtype, start=None, batches=None,
                       count0=0):
    """The reference following ``batches`` (default: the set-up's) in
    ``dtype``, from ``start`` (the pack and its moments; default: the
    perturbed pack with fresh moments) at step ``count0``."""
    tr, cfg = prog.tr, prog.cfg
    sc = ref.scene_arrays(prog.desc, dev.name, dtype)
    cam = ref.camera(cell.config["camera"], cfg.width / cfg.height, dev.name,
                     dtype)
    true = sc["atlas"]
    if start is None:
        atlas, moments = perturb(true, tr), {}
    else:
        atlas, moments = (
            start["params"].to(dev.name, dtype),
            {k: start[k].to(dev.name, dtype) for k in ("mu", "nu")})
    out = ref_fit.fit(
        sc, cam, atlas, true,
        [torch.from_numpy(b).to(dev.name)
         for b in (prog.batches if batches is None else batches)],
        ref_rng.key(crn_seed(prog.seed), dev.name), width=cfg.width,
        height=cfg.height, spb=tr["spb"], target_spp=tr["target_spp"],
        max_bounce=cfg.max_bounce, background=cfg.background,
        mask=channel_mask(tr, true),
        lr=tr["learning_rate"] * tr["texel_rate_factor"],
        decay_steps=tr["decay_steps"], block=tr["reference_block"],
        count0=count0, **moments)
    return dict(losses=out["losses"], grad_norm=compare.norm(out["grad1"]),
                change_norm=compare.norm(out["change"]))


def check(cell, seed, prog, dev, log, control=None):
    """The set-up's steps from the perturbed pack, then the window's last
    steps from the program's state before them: the reference in float32
    against the program (or, for the control, the reference in a lower
    precision put in its place)."""
    fw = prog.followed
    window = dict(start=fw.start, batches=fw.batches, count0=fw.count0)
    want = reference_readings(cell, prog, dev, torch.float32)
    want_w = reference_readings(cell, prog, dev, torch.float32, **window)
    if control:
        low = compare.CONTROL_DTYPES[control]
        got = reference_readings(cell, prog, dev, low)
        got_w = reference_readings(cell, prog, dev, low, **window)
    else:
        got, got_w = prog.readings, fw.readings
    log(f"reference: {want}; window steps {fw.count0 + 1}-"
        f"{fw.count0 + len(fw.batches)}: {want_w}")
    log(f"checked:   {got}; window steps: {got_w}")
    out = compare.fit_readings(got, want)
    out.update({"window_" + k: v
                for k, v in compare.fit_readings(got_w, want_w).items()})
    return out
