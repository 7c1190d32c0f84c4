"""Per-pixel statistical parity of the port against the reference binary
on the Shirley random-sphere field: ``tests/test_shirley_statistical.py``
with the port's CPU path as the renderer, at the same size (320x180, 48
spp in batches of 8), seed and z-thresholds.

The field (``presets.shirley_parity``) is built from the reference
binary's 64-bit LCG, so both renderers trace the same spheres: dielectric
glass, fuzzy metal, moving (motion-blurred) diffuse spheres and aperture
blur. The port renders through ``render_pixels``, the frame path of
``render_accumulate`` (the fused integrator with the last-bounce
shortcut), in independent batches that give its per-pixel variance.
"""

import dataclasses
import os
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sexy_raytracer_tpu_torch.models import presets  # noqa: E402
from sexy_raytracer_tpu_torch.render.camera import Camera  # noqa: E402
from sexy_raytracer_tpu_torch.render.integrator import (  # noqa: E402
    scene_no_emissive_tris,
)
from sexy_raytracer_tpu_torch.render.renderer import render_pixels  # noqa: E402
from sexy_raytracer_tpu_torch.utils import rng  # noqa: E402
from sexy_raytracer_tpu_torch.utils.png import read_png  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
REFORACLE = os.path.join(HERE, "reforacle", "reforacle")

W, H = 320, 180
SPP = 48
SPB = 8  # K = SPP/SPB independent batches for the variance estimate
SEED = 42
CHUNK = 1024  # pixels a call: 8,192 rays x 486 spheres on the CPU


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One thread: tier-1 runs six test files at once, and this file's
    eager [rays, spheres] passes gain little from more threads than the
    contention costs the other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def reforacle_linear(tmp_path_factory):
    if not os.path.exists(REFORACLE):
        pytest.skip("reforacle binary unavailable")
    work = tmp_path_factory.mktemp("reforacle")
    out = str(work / f"shirley_{W}x{H}_{SPP}.png")
    subprocess.run(
        [REFORACLE, str(W), str(H), str(SPP), "4", out, "shirley",
         str(SEED)],
        cwd=str(work), check=True, timeout=1200,
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
    )
    png = read_png(out, 3).astype(np.float64)
    lo = (png / 256.0) ** 2
    hi = ((png + 1.0) / 256.0) ** 2
    return 0.5 * (lo + hi), ((hi - lo) ** 2) / 12.0, png


@pytest.fixture(scope="module")
def ours_batches():
    scene, cfg = presets.shirley_parity(seed=SEED, spp=SPP, height=H,
                                        device="cpu")
    cfg = dataclasses.replace(cfg, width=W, height=H)
    cam = Camera.from_config(cfg.camera, cfg.aspect, device="cpu")
    bg = torch.tensor(cfg.background, dtype=torch.float32)
    key = rng.key(cfg.seed)
    vis_ok = scene_no_emissive_tris(scene)
    pid_all = np.arange(W * H, dtype=np.int32)
    batches = np.zeros((SPP // SPB, W * H, 3), np.float32)
    for start in range(0, W * H, CHUNK):
        ids = torch.from_numpy(pid_all[start:start + CHUNK])
        for k in range(SPP // SPB):
            out = render_pixels(
                scene, cam, ids, k * SPB, key, bg, width=W, height=H,
                spb=SPB, spp_total=SPP, max_bounce=cfg.max_bounce,
                last_bounce_vis=vis_ok)
            batches[k, start:start + ids.shape[0]] = out.numpy()
    return batches.reshape(SPP // SPB, H, W, 3) / SPB


def test_shirley_statistical_parity(reforacle_linear, ours_batches):
    ref_mean, ref_qvar, ref_png = reforacle_linear
    K = ours_batches.shape[0]
    our_mean = ours_batches.mean(axis=0).astype(np.float64)
    var_batch = ours_batches.var(axis=0, ddof=1).astype(np.float64)

    clamped = (ref_png >= 255) | (np.sqrt(np.maximum(our_mean, 0)) >= 0.999)

    # per-pixel median |z|: a systematic shading difference in the
    # dielectric / fuzzy-metal / motion-blur / depth-of-field paths
    denom = np.sqrt(2.0 * var_batch / K + ref_qvar + 1e-12)
    z_pix = np.abs(our_mean - ref_mean) / denom
    med_pix = float(np.median(z_pix[~clamped]))
    assert med_pix < 1.1, f"pixel median |z| {med_pix} — systematic diff"

    # 8x8-block z-test (tail control under glass-caustic fireflies), the
    # quantisation error fully correlated within a block
    BS = 8
    Hb, Wb = H // BS, W // BS

    def blocks(x, red=np.mean):
        return red(x[:Hb * BS, :Wb * BS].reshape(Hb, BS, Wb, BS, 3),
                   axis=(1, 3))

    bad = blocks(clamped.astype(float), np.max) > 0
    ref_b = blocks(ref_mean)
    our_b = blocks(our_mean)
    qvar_b = blocks(ref_qvar)
    bb = ours_batches[:, :Hb * BS, :Wb * BS].reshape(
        K, Hb, BS, Wb, BS, 3
    ).mean(axis=(2, 4)).astype(np.float64)
    var_bb = bb.var(axis=0, ddof=1) / K
    z_b = np.where(
        bad, 0.0,
        np.abs(our_b - ref_b) / np.sqrt(2.0 * var_bb + qvar_b + 1e-12),
    )
    zv = z_b[~bad]
    assert float(np.median(zv)) < 2.0, f"block median |z| {np.median(zv)}"
    assert float((z_b > 5.0).mean()) < 0.04, (
        f"frac block |z|>5 = {(z_b > 5.0).mean()}"
    )
    assert float((z_b > 8.0).mean()) < 0.015, (
        f"frac block |z|>8 = {(z_b > 8.0).mean()}"
    )

    # region means in linear space (clamp-censored): sky / field / the
    # three hero spheres' band / near-field depth-of-field blur
    cm = ~clamped
    for name, (r0, r1, c0, c1), tol in [
        ("sky", (0, 40, 0, W), 0.006),
        ("far_field", (75, 95, 40, 280), 0.008),
        ("hero_band", (60, 110, 100, 220), 0.010),
        ("near_ground", (140, 180, 0, W), 0.008),
    ]:
        sel = cm[r0:r1, c0:c1]
        m_o = np.where(sel, our_mean[r0:r1, c0:c1], 0).sum((0, 1))
        m_r = np.where(sel, ref_mean[r0:r1, c0:c1], 0).sum((0, 1))
        n = np.maximum(sel.sum((0, 1)), 1)
        d = np.abs(m_o / n - m_r / n)
        assert (d < tol).all(), f"region {name}: |mean diff| {d} >= {tol}"
