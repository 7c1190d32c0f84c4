"""Flagship inverse-rendering experiments on the port (counterpart of the
root ``tools/run_inverse_experiment.py``, with its phases, step counts,
learning rates, seeds, ROI and report keys).

    python -m sexy_raytracer_tpu_torch.tools.run_inverse_experiment \\
        [--phases 1,1b,1c,2] [--device cuda|cpu]

Phases (all by default):

  1   CRN self-recovery at 240p: the atlas's colour channels perturbed to
      ``x * 0.3 + 90``, every step tracing the target's own samples
      (common random numbers). Bar: exact-MSE ratio >= 10x.
  1b  the same without CRN, coarse to fine: a per-layer affine (stage 0,
      then a settle, 0b), an 8x-coarse atlas delta (A), the full atlas
      (B). Bar: exact-MSE ratio >= 5x.
  1c  the iron sphere's position by silhouette gradients alone, under
      Adam at 2e-2. Bar: centre error < 0.15.
  2   720p against the reference golden ``images/test-5kx720p.png``
      (skipped when it is absent).

The scene is ``presets.masterchief`` when its asset is present, else the
flagship stand-in at the same height and spp (``presets.flagship``); the
first line printed names it, and the report records it as ``"scene"``.
Everything runs on the card unless ``--device cpu`` asks for the CPU.
Artifacts go to ``ART`` (``artifacts/torch/inverse/``); ``report.json``
there is merged across partial runs, so phases can run separately.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import time

import numpy as np
import torch

from sexy_raytracer_tpu_torch.diff.inverse import Adam, inverse_render
from sexy_raytracer_tpu_torch.diff.silhouette import sphere_silhouette_loss
from sexy_raytracer_tpu_torch.models import presets
from sexy_raytracer_tpu_torch.render.camera import Camera
from sexy_raytracer_tpu_torch.render.renderer import render_accumulate
from sexy_raytracer_tpu_torch.tools.histogram_split import nvidia_smi
from sexy_raytracer_tpu_torch.tools.run_flagship_render import GOLDEN
from sexy_raytracer_tpu_torch.utils import rng
from sexy_raytracer_tpu_torch.utils.mathx import clip
from sexy_raytracer_tpu_torch.utils.png import read_png, write_png

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
ART = os.path.join(REPO, "artifacts", "torch", "inverse")
HEIGHT, TARGET_SPP = 240, 128   # the self-recovery target
ROI = (40, 236, 40, 260)        # chief + iron at 240p
F = 8                           # stage A's coarse factor
IRON = 2  # ground(0) light(1) iron(2) metal(3), presets.masterchief
GOLDEN_STEPS = 2000             # phase 2's fit
CANVAS_W, CANVAS_H, MARGIN = 770, 440, 48   # loss_curves.png


def resolved_of(lin, spp):
    return np.clip(np.sqrt(np.clip(lin / spp, 1e-8, None)), 0, 0.999)


def mse(a, b, roi=None):
    """Mean squared difference, inside ``ROI`` when ``roi`` is truthy."""
    d = (a - b) ** 2
    if roi:
        r0, r1, c0, c1 = ROI
        d = d[r0:r1, c0:c1]
    return float(d.mean())


def to_u8(x):
    return np.clip(x, 0, 255).astype(np.uint8)


def chan_mask():
    """The gradient mask that trains the atlas's colour channels 0-2."""
    m = np.zeros((1, 1, 1, 8), np.float32)
    m[..., 0:3] = 1.0
    return m


def cache_path(kind, name, cfg, device):
    """A render cached in ``ART``, named by scene, height, spp and device
    type, so that it is reused only for the render that made it."""
    return os.path.join(ART, f"{kind}_{name}_{cfg.height}p_"
                        f"{cfg.samples_per_pixel}spp_"
                        f"{torch.device(device).type}.npz")


def make_target_240p(device):
    """(scene, cfg, target_lin, target_resolved, scene name) for the
    self-recovery phases; the target's radiance is cached in ``ART``
    (a fixed seed renders the same target again)."""
    scene, cfg, name = presets.flagship(height=HEIGHT, spp=TARGET_SPP,
                                        device=device)
    target_npz = cache_path("target", name, cfg, device)
    if os.path.exists(target_npz):
        target_lin = np.load(target_npz)["accum"]
    else:
        print(f"rendering self-target ({HEIGHT}p/{TARGET_SPP}spp)...",
              flush=True)
        target_lin = render_accumulate(scene, cfg, method="auto",
                                       progress=True)
        np.savez(target_npz, accum=target_lin)
    return scene, cfg, target_lin, resolved_of(target_lin, TARGET_SPP), name


def perturb_atlas(scene):
    """(true atlas, perturbed atlas) as numpy, and the scene with the
    perturbed atlas on its device: colour channels to ``x * 0.3 + 90``."""
    true_atlas = scene.shade_atlas.cpu().numpy()
    pert_atlas = true_atlas.copy()
    pert_atlas[..., 0:3] = np.clip(true_atlas[..., 0:3] * 0.3 + 90.0, 0, 255)
    return true_atlas, pert_atlas, scene._replace(
        shade_atlas=torch.from_numpy(pert_atlas).to(scene.device))


# phase 1b's reparameterisations: maps from the optimised params to the
# atlas, over a base atlas (each stage starts from the last stage's atlas)

def up(d):
    """An ``F``x coarser delta ``[L, AH/F, AW/F, 3]`` at full resolution."""
    return d.repeat_interleave(F, 1).repeat_interleave(F, 2)


def transform_0(base, p):
    """Stage 0: a per-layer, per-channel affine of the base's colour."""
    ch = base[..., 0:3] * p["scale"][:, None, None, :] \
        + p["offset"][:, None, None, :]
    atlas = torch.cat([ch, base[..., 3:]], dim=-1)
    return {"shade_atlas": clip(atlas, 0.0, 255.0)}


# stage 0b: a fresh affine composed on stage 0's atlas, the same map
transform_0b = transform_0


def transform_a(base, p):
    """Stage A: the base plus an upsampled coarse colour delta."""
    atlas = torch.cat([base[..., 0:3] + up(p["d8"]), base[..., 3:]], dim=-1)
    return {"shade_atlas": clip(atlas, 0.0, 255.0)}


def transform_b(p):
    """Stage B: the full-resolution atlas itself."""
    return {"shade_atlas": clip(p["atlas_fr"], 0.0, 255.0)}


def render_resolved(scene, cfg):
    return resolved_of(render_accumulate(scene, cfg, method="auto"),
                       cfg.samples_per_pixel)


def eval_recovery(report, prefix, scene_true_atlas, pert_atlas, opt_scene,
                  target, cfg, losses, name):
    """The exact objective: deterministic re-renders of the perturbed and
    the recovered scene (``name``) against the target in the ROI -> their
    ratio; the visible texels' error, and the recovered atlas and render
    as PNGs."""
    r_opt = render_resolved(opt_scene, cfg)
    pert_npz = cache_path("render_pert", name, cfg, opt_scene.device)
    if os.path.exists(pert_npz):
        r_pert = np.load(pert_npz)["img"]
    else:
        r_pert = render_resolved(opt_scene._replace(
            shade_atlas=torch.from_numpy(pert_atlas).to(opt_scene.device)),
            cfg)
        np.savez(pert_npz, img=r_pert)

    mse_pert = mse(r_pert, target, roi=True)
    mse_opt = mse(r_opt, target, roi=True)
    ratio = mse_pert / max(mse_opt, 1e-12)
    report.update({
        f"{prefix}_loss_first5": float(np.mean(losses[:5])),
        f"{prefix}_loss_last30": float(np.mean(losses[-30:])),
        f"{prefix}_exact_mse_perturbed": mse_pert,
        f"{prefix}_exact_mse_recovered": mse_opt,
        f"{prefix}_exact_mse_ratio": round(ratio, 2),
    })
    opt_atlas = opt_scene.shade_atlas.cpu().numpy()
    moved = np.abs(opt_atlas - pert_atlas).max(axis=-1) > 1.0
    if moved.any():
        e_pert = np.abs(
            pert_atlas[..., 0:3] - scene_true_atlas[..., 0:3])[moved]
        e_opt = np.abs(opt_atlas[..., 0:3]
                       - scene_true_atlas[..., 0:3])[moved]
        report[f"{prefix}_visible_texels"] = int(moved.sum())
        report[f"{prefix}_visible_texel_mae_before"] = float(e_pert.mean())
        report[f"{prefix}_visible_texel_mae_after"] = float(e_opt.mean())
    write_png(os.path.join(ART, f"atlas_recovered_{prefix}.png"),
              to_u8(opt_atlas[0, ..., 0:3]))
    write_png(os.path.join(ART, f"render_recovered_{prefix}.png"),
              to_u8(r_opt * 255.99))
    return ratio


def crn_stage(perturbed, target, cfg, *, n_steps=900, pixels_per_step=8192,
              spb=128, progress=True):
    """Phase 1's fit: the atlas's colour channels, every step tracing with
    the target's key ``rng.key(cfg.seed)``."""
    return inverse_render(
        perturbed, target, cfg,
        n_steps=n_steps, pixels_per_step=pixels_per_step, spb=spb,
        learning_rate=1e-2, method="auto", seed=7,
        trainable=("shade_atlas",),
        grad_masks={"shade_atlas": chan_mask()},
        roi=ROI, loss_type="mse",
        crn_key=rng.key(cfg.seed, device=perturbed.device),
        progress=progress, log_every=100,
    )


def phase1_crn(report, device="cuda", **stage_kw):
    """CRN upper bound: ``crn_stage`` (``stage_kw`` overrides its
    length), then the exact objective."""
    scene, cfg, target_lin, target, name = make_target_240p(device)
    true_atlas, pert_atlas, perturbed = perturb_atlas(scene)
    write_png(os.path.join(ART, "atlas_true.png"),
              to_u8(true_atlas[0, ..., 0:3]))
    write_png(os.path.join(ART, "atlas_pert.png"),
              to_u8(pert_atlas[0, ..., 0:3]))
    write_png(os.path.join(ART, "render_target.png"), to_u8(target * 255.99))

    t0 = time.time()
    print("phase 1 (CRN)...", flush=True)
    opt, losses = crn_stage(perturbed, target, cfg, **stage_kw)
    report["optimize_240p_s"] = round(time.time() - t0, 1)
    with open(os.path.join(ART, "losses_240p.json"), "w") as f:
        json.dump(losses, f)
    ratio = eval_recovery(report, "crn", true_atlas, pert_atlas, opt,
                          target, cfg, losses, name)
    # legacy top-level keys (the JAX report's shape)
    report["exact_mse_ratio"] = round(ratio, 2)
    report["pass_mse_improved"] = bool(ratio >= 10.0)
    return losses


def _affine_init(L):
    return {"scale": np.ones((L, 3), np.float32),
            "offset": np.zeros((L, 3), np.float32)}


def stage_0(perturbed, target_linear, cfg, *, n_steps=1200,
            pixels_per_step=16384, spb=32, progress=True):
    """Stage 0: the affine of the perturbed atlas, tile-averaged linear
    loss. Drift budget (the JAX tool's probe): the per-step gradient SNR
    is ~0.3 at this batch, so 1,200 cosine-decayed steps at 3e-2 cover the
    scale's excursion (1 -> 3.33) with ~2x margin."""
    return inverse_render(
        perturbed, target_linear, cfg,
        n_steps=n_steps, pixels_per_step=pixels_per_step, spb=spb,
        learning_rate=3e-2, method="auto", seed=12,
        init_params=_affine_init(perturbed.shade_atlas.shape[0]),
        lr_overrides={"offset": 3.0},
        param_transform=functools.partial(transform_0, perturbed.shade_atlas),
        roi=ROI, loss_type="tile_linear", huber_delta=0.5,
        progress=progress, log_every=50,
    )


def stage_0b(perturbed, atlas_0, target_linear, cfg, *, n_steps=600,
             pixels_per_step=16384, spb=32, progress=True):
    """Stage 0b, the settle: a fresh affine on stage 0's atlas at 6x lower
    rate, which corrects stage 0's drift-limited residual."""
    return inverse_render(
        perturbed, target_linear, cfg,
        n_steps=n_steps, pixels_per_step=pixels_per_step, spb=spb,
        learning_rate=5e-3, method="auto", seed=15,
        init_params=_affine_init(atlas_0.shape[0]),
        lr_overrides={"offset": 0.5},
        param_transform=functools.partial(transform_0b, atlas_0),
        roi=ROI, loss_type="tile_linear", huber_delta=0.5,
        progress=progress, log_every=100,
    )


def stage_a(perturbed, atlas_0, target_linear, cfg, *, n_steps=400,
            pixels_per_step=8192, spb=32, progress=True):
    """Stage A: an ``F``x-coarse colour delta on stage 0b's atlas."""
    L, AH, AW, _ = atlas_0.shape
    return inverse_render(
        perturbed, target_linear, cfg,
        n_steps=n_steps, pixels_per_step=pixels_per_step, spb=spb,
        learning_rate=0.5, method="auto", seed=13,
        init_params={"d8": np.zeros((L, AH // F, AW // F, 3), np.float32)},
        param_transform=functools.partial(transform_a, atlas_0),
        roi=ROI, loss_type="tile_linear", huber_delta=0.5,
        progress=progress, log_every=100,
    )


def stage_b(perturbed, atlas_a, target_linear, cfg, *, n_steps=400,
            pixels_per_step=8192, spb=128, progress=True):
    """Stage B: per-texel refinement under the per-pixel linear Huber at
    spb 128 (the tile loss cannot see per-texel detail)."""
    return inverse_render(
        perturbed, target_linear, cfg,
        n_steps=n_steps, pixels_per_step=pixels_per_step, spb=spb,
        learning_rate=0.25, method="auto", seed=14,
        init_params={"atlas_fr": atlas_a},
        param_transform=transform_b,
        grad_masks={"atlas_fr": chan_mask()},
        roi=ROI, loss_type="linear_mse", huber_delta=0.05,
        progress=progress, log_every=100,
    )


def phase1b_stochastic(report, device="cuda", stage_kw=None):
    """Non-CRN recovery, coarse to fine (bar >= 5x). ``stage_kw``: stage
    name ("0", "0b", "A", "B") -> overrides of that stage's length."""
    stage_kw = stage_kw or {}
    scene, cfg, target_lin, target, name = make_target_240p(device)
    true_atlas, pert_atlas, perturbed = perturb_atlas(scene)
    target_linear = target_lin / TARGET_SPP  # tile_linear: linear radiance

    t0 = time.time()
    print("phase 1b stage 0 (affine, no CRN, tile_linear)...", flush=True)
    opt_0, losses_0 = stage_0(perturbed, target_linear, cfg,
                              **stage_kw.get("0", {}))
    print("phase 1b stage 0b (affine settle)...", flush=True)
    opt_0b, losses_0b = stage_0b(perturbed, opt_0.shade_atlas, target_linear,
                                 cfg, **stage_kw.get("0b", {}))
    print("phase 1b stage A (coarse 8x, no CRN, tile_linear)...", flush=True)
    opt_a, losses_a = stage_a(perturbed, opt_0b.shade_atlas, target_linear,
                              cfg, **stage_kw.get("A", {}))
    print("phase 1b stage B (full-res, no CRN, linear huber)...", flush=True)
    opt_b, losses_b = stage_b(perturbed, opt_a.shade_atlas, target_linear,
                              cfg, **stage_kw.get("B", {}))
    report["optimize_240p_nocrn_s"] = round(time.time() - t0, 1)
    losses = losses_0 + losses_0b + losses_a + losses_b
    with open(os.path.join(ART, "losses_240p_nocrn.json"), "w") as f:
        json.dump(losses, f)
    ratio = eval_recovery(report, "nocrn", true_atlas, pert_atlas, opt_b,
                          target, cfg, losses, name)
    report["pass_nocrn_5x"] = bool(ratio >= 5.0)
    return losses


def with_center(scene, sphere, c):
    """The scene with ``sphere``'s centre (both motion endpoints) ``c``."""
    def put(field):
        return torch.cat([field[:sphere], c[None], field[sphere + 1:]])

    return scene._replace(sph_c0=put(scene.sph_c0), sph_c1=put(scene.sph_c1))


def silhouette_fit(scene, cfg, camera, target, sphere, c_start, *, n_steps,
                   n_edge=512):
    """``n_steps`` steps of Adam at 2e-2 (optax.adam: b1 0.9, b2 0.999, eps
    1e-8, a constant rate) on ``sphere``'s centre under
    ``sphere_silhouette_loss`` alone, step ``i`` with key
    ``rng.key(100 + i)`` -> the centres after each step (numpy)."""
    dev = scene.device
    target = torch.as_tensor(target, dtype=torch.float32, device=dev)
    c = torch.as_tensor(c_start, dtype=torch.float32, device=dev)
    opt = Adam({"c": 2e-2})
    state = opt.init({"c": c})
    centres = []
    for i in range(n_steps):
        cg = c.clone().requires_grad_(True)
        loss = sphere_silhouette_loss(
            with_center(scene, sphere, cg), camera, target, [sphere],
            rng.key(100 + i, device=dev), width=cfg.width,
            height=cfg.height, max_bounce=cfg.max_bounce,
            background=cfg.background, n_edge=n_edge, method="auto")
        (g,) = torch.autograd.grad(loss, cg)
        updates, state = opt.update({"c": g}, state)
        c = c + updates["c"]
        centres.append(c.cpu().numpy())
    return centres


def phase1c_silhouette(report, device="cuda", n_steps=200, n_edge=512):
    """Iron-sphere position recovery by boundary gradients."""
    scene, cfg, target_lin, target, _ = make_target_240p(device)
    if float(scene.sph_radius[IRON]) != 1.0:
        raise AssertionError("sphere IRON is not the iron sphere")
    c_true = scene.sph_c0[IRON].cpu().numpy()
    if not np.allclose(c_true, [-3.0, 1.0, 0.0]):
        raise AssertionError("sphere IRON is not the iron sphere")

    disp = np.array([0.10, 0.08, -0.07], np.float32)  # |d| ~ 0.146
    camera = Camera.from_config(cfg.camera, cfg.aspect, device=scene.device)
    t0 = time.time()
    centres = silhouette_fit(scene, cfg, camera, target, IRON,
                             c_true + disp, n_steps=n_steps, n_edge=n_edge)
    errs = [float(np.linalg.norm(disp))]
    for i, c in enumerate(centres):
        if i % 20 == 0 or i == n_steps - 1:
            errs.append(float(np.linalg.norm(c - c_true)))
            print(f"  step {i}: center err {errs[-1]:.4f}", flush=True)
    err_final = float(np.linalg.norm(centres[-1] - c_true))
    report.update({
        "silhouette_center_err_start": float(np.linalg.norm(disp)),
        "silhouette_center_err_final": round(err_final, 4),
        "silhouette_err_curve": [round(e, 4) for e in errs],
        "silhouette_seconds": round(time.time() - t0, 1),
        "pass_silhouette_recovery": bool(err_final < 0.15),
    })
    return err_final


def phase2_golden(report, device="cuda"):
    """720p against the reference golden, the densely observed material
    factors from a perturbed start; skipped without the golden."""
    golden = read_png(GOLDEN, 3)
    if golden is None:
        print("golden unavailable; skipping phase 2")
        return None
    scene720, cfg720, _ = presets.flagship(height=720, device=device)
    print(f"phase 2: {GOLDEN_STEPS} steps vs test-5kx720p.png (720p)...",
          flush=True)
    t0 = time.time()
    bc = scene720.mat_base_color.clone()
    bc[:, :3] *= 0.6
    pert720 = scene720._replace(mat_base_color=bc,
                                mat_albedo_c0=scene720.mat_albedo_c0 * 0.6)
    opt720, losses720 = inverse_render(
        pert720, golden.astype(np.float32) / 255.0, cfg720,
        n_steps=GOLDEN_STEPS, pixels_per_step=8192, spb=16,
        learning_rate=2e-3, method="auto", seed=11,
        trainable=("mat_base_color", "mat_metallic",
                   "mat_roughness", "mat_albedo_c0", "mat_albedo_c1"),
        loss_type="huber",
        progress=True, log_every=200,
    )
    report["optimize_720p_s"] = round(time.time() - t0, 1)
    with open(os.path.join(ART, "losses_720p.json"), "w") as f:
        json.dump(losses720, f)
    # converged floor: the last two quarters agree within noise
    q = len(losses720) // 4
    report.update({
        "loss720_first5": float(np.mean(losses720[:5])),
        "loss720_last200": float(np.mean(losses720[-200:])),
        "loss720_floor_q3": float(np.mean(losses720[2 * q:3 * q])),
        "loss720_floor_q4": float(np.mean(losses720[3 * q:])),
    })

    cfg_r = dataclasses.replace(cfg720, samples_per_pixel=64)
    rec = render_resolved(opt720, cfg_r)
    pert_r = render_resolved(pert720, cfg_r)
    write_png(os.path.join(ART, "golden_720p.png"), to_u8(golden))
    write_png(os.path.join(ART, "render_720p_perturbed.png"),
              to_u8(pert_r * 255.99))
    write_png(os.path.join(ART, "render_720p_recovered.png"),
              to_u8(rec * 255.99))
    g = golden.astype(np.float64) / 255.0
    report["golden720_mae_perturbed"] = float(np.abs(pert_r - g).mean())
    report["golden720_mae_recovered"] = float(np.abs(rec - g).mean())
    return losses720


CURVE_COLOURS = ((31, 119, 180), (255, 127, 14), (44, 160, 44),
                 (214, 39, 40))


def draw_loss_curves(curves, path):
    """One semilog polyline per curve ({name: losses}) on a white canvas
    with an axes box, as uint8 RGB written to ``path`` -> {name: colour}.
    Step runs along x; log10 of the loss along y over the positive losses
    of all curves."""
    img = np.full((CANVAS_H, CANVAS_W, 3), 255, np.uint8)
    x0, x1, y0, y1 = MARGIN, CANVAS_W - MARGIN, MARGIN, CANVAS_H - MARGIN
    img[y0:y1 + 1, [x0, x1]] = 0
    img[[y0, y1], x0:x1 + 1] = 0
    with np.errstate(divide="ignore", invalid="ignore"):
        logs = {k: np.log10(np.asarray(v, np.float64))
                for k, v in curves.items()}
    finite = np.concatenate([v[np.isfinite(v)] for v in logs.values()]
                            + [np.zeros(0)])
    lo, hi = (finite.min(), finite.max()) if finite.size else (0.0, 1.0)
    hi = hi if hi > lo else lo + 1.0
    n_max = max(max(len(v) for v in logs.values()) - 1, 1)
    legend = {}
    for k, (name, ls) in enumerate(logs.items()):
        colour = CURVE_COLOURS[k % len(CURVE_COLOURS)]
        legend[name] = list(colour)
        ok = np.isfinite(ls)
        xs = x0 + (x1 - x0) * np.arange(len(ls))[ok] / n_max
        ys = y1 - (y1 - y0) * (ls[ok] - lo) / (hi - lo)
        if xs.size == 1:
            xs, ys = np.repeat(xs, 2), np.repeat(ys, 2)
        for xa, ya, xb, yb in zip(xs[:-1], ys[:-1], xs[1:], ys[1:]):
            n = int(max(abs(xb - xa), abs(yb - ya))) + 2
            px = np.rint(np.linspace(xa, xb, n)).astype(int)
            py = np.rint(np.linspace(ya, yb, n)).astype(int)
            img[py, px] = colour
        img[y0 + 8 + 12 * k:y0 + 12 + 12 * k, x1 - 40:x1 - 8] = colour
    write_png(path, img)
    return legend


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m sexy_raytracer_tpu_torch.tools.run_inverse_experiment",
        description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default="1,1b,1c,2",
                    help="comma list from {1,1b,1c,2}")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) | cpu: where everything runs")
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))
    name = presets.flagship_name()
    print(f"scene: {name}", flush=True)
    label = nvidia_smi() if torch.device(args.device).type == "cuda" \
        else "cpu"
    print(f"device: {label}", flush=True)

    os.makedirs(ART, exist_ok=True)
    report_path = os.path.join(ART, "report.json")
    report = {}
    if os.path.exists(report_path):
        with open(report_path) as f:
            report = json.load(f)
    report.update(scene=name, device=label)
    t_all = time.time()

    curves = {}
    if "1" in phases:
        curves["240p CRN"] = phase1_crn(report, args.device)
    if "1b" in phases:
        curves["240p stochastic (coarse-to-fine)"] = phase1b_stochastic(
            report, args.device)
    if "1c" in phases:
        phase1c_silhouette(report, args.device)
    if "2" in phases:
        l7 = phase2_golden(report, args.device)
        if l7:
            curves["720p vs golden"] = l7

    if curves:
        report["loss_curves"] = draw_loss_curves(
            curves, os.path.join(ART, "loss_curves.png"))

    report["total_s"] = round(time.time() - t_all, 1)
    with open(report_path, "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
