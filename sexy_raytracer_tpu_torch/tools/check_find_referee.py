"""An f64 referee of kernel-vs-bruteforce find mismatches, and the
kernel's time on tile-coherent rays (counterpart of the root
``tools/check_find_referee.py``).

    python -m sexy_raytracer_tpu_torch.tools.check_find_referee [--device cuda|cpu]

On ``R`` = 131,072 random camera rays of the 720p flagship (the stand-in
without the Master Chief asset; the first line printed names it),
``find_hit(method="pallas")`` (kernel 1 on the card) against
``method="bruteforce"``: every ray whose prim ids differ is a near tie
(``|t_new - t_bf| <= 1e-3 min(t) + 1e-5``) or not, and the first 300 are
adjudicated by the closest triangle in float64 from first principles.
Then the kernel's device time (``tools.devtime``) on tiled, row and
random rays. The last line printed is the result as JSON.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from sexy_raytracer_tpu_torch.models import presets
from sexy_raytracer_tpu_torch.ops.intersect import find_hit
from sexy_raytracer_tpu_torch.render.camera import Camera
from sexy_raytracer_tpu_torch.tools.histogram_split import nvidia_smi
from sexy_raytracer_tpu_torch.tools.devtime import device_time
from sexy_raytracer_tpu_torch.utils import rng

R = 131072
TW, TH = 32, 16  # pixel tile -> 512-ray block
ADJUDICATED = 300
MODES = ("tiled", "rows", "random")
TIMED_SETS = 4


def tile_order_ids(width, height):
    """All pixel ids in 32x16-tile-major order."""
    xs = np.arange(0, width, TW)
    ys = np.arange(0, height, TH)
    ids = []
    for y0 in ys:
        for x0 in xs:
            yy, xx = np.meshgrid(
                np.arange(y0, min(y0 + TH, height)),
                np.arange(x0, min(x0 + TW, width)),
                indexing="ij",
            )
            ids.append((yy * width + xx).ravel())
    return np.concatenate(ids)


def make_rays(camera, width, height, seed, mode, tiled=None):
    """``R`` camera rays from key ``rng.key(seed)``: pixel ids from a
    random 512-aligned start in tile order (``tiled``, pass
    ``tile_order_ids``), a random start in row order (``rows``), or at
    random (``random``); sub-pixel, lens and time draws from
    ``rng.split(key, 3)``."""
    dev = camera.origin.device
    key = rng.key(seed, device=dev)
    word = int(rng.bits(key, 1)[0])
    if mode == "tiled":
        start = word % ((tiled.size - R) // 512) * 512
        pid = torch.from_numpy(tiled[start:start + R].astype(np.int64)) \
            .to(dev)
    elif mode == "rows":
        pid = word % (width * height - R) + torch.arange(R, device=dev)
    else:
        pid = rng.bits(key, R) % (width * height)
    k2 = rng.split(key, 3)
    u = ((pid % width).float() + rng.uniform(k2[0], (R,))) / (width - 1)
    v = ((height - pid // width).float() + rng.uniform(k2[1], (R,))) \
        / (height - 1)
    return camera.get_rays(u, v, rng.uniform(k2[2], (R, 3)))


def f64_tri_all(v0, v1, v2, o, d):
    """The closest front-facing triangle hit at t >= 1e-3 of one ray, in
    float64 from first principles (cross-product edge tests) -> (index or
    -1, t)."""
    n = np.cross(v1 - v0, v2 - v0)
    ndir = n @ d
    plane_ok = ndir <= -1.19209290e-07
    tt = -((n * (o - v0)).sum(1)) / np.where(plane_ok, ndir, -1.0)
    p = o[None, :] + tt[:, None] * d[None, :]
    e0 = ((np.cross(n, v1 - v0)) * (p - v0)).sum(1)
    e1 = ((np.cross(n, v2 - v1)) * (p - v1)).sum(1)
    e2 = ((np.cross(n, v0 - v2)) * (p - v2)).sum(1)
    ok = plane_ok & (e0 >= 0) & (e1 >= 0) & (e2 >= 0) & (tt >= 1e-3)
    tt = np.where(ok, tt, np.inf)
    i = np.argmin(tt)
    return (i if np.isfinite(tt[i]) else -1), tt[i]


def near_tie(t1, t0):
    a = np.where(np.isfinite(t1), t1, 1e30)
    b = np.where(np.isfinite(t0), t0, 1e30)
    return np.abs(a - b) <= 1e-3 * np.minimum(a, b) + 1e-5


def referee(scene, org, dirs, times):
    """Kernel-vs-bruteforce prim ids on these rays, each mismatch a near
    tie or not, the first ``ADJUDICATED`` judged in float64 -> counts."""
    p1, t1 = find_hit(scene, org, dirs, times, method="pallas")
    p0, t0 = find_hit(scene, org, dirs, times, method="bruteforce")
    p1, t1, p0, t0 = (x.cpu().numpy() for x in (p1, t1, p0, t0))
    orgn = org.cpu().numpy().astype(np.float64)
    dirn = dirs.cpu().numpy().astype(np.float64)
    v0, v1, v2 = (getattr(scene, k).cpu().numpy().astype(np.float64)
                  for k in ("tri_v0", "tri_v1", "tri_v2"))
    T = v0.shape[0]
    mis = np.nonzero(p1 != p0)[0]
    tie = near_tie(t1[mis], t0[mis])
    verdicts = {"new_correct": 0, "bf_correct": 0, "neither": 0}
    for i in mis[:ADJUDICATED]:
        ref_i, _ = f64_tri_all(v0, v1, v2, orgn[i], dirn[i])
        n1 = p1[i] if p1[i] < T else -1
        n0 = p0[i] if p0[i] < T else -1
        key = "new_correct" if ref_i == n1 else (
            "bf_correct" if ref_i == n0 else "neither")
        verdicts[key] += 1
    return dict(rays=int(p1.size), mismatches=int(mis.size),
                near_ties=int(tie.sum()),
                outside_tie_rule=int((~tie).sum()),
                adjudicated=int(min(mis.size, ADJUDICATED)), **verdicts)


def run(device="cuda"):
    """The referee on random rays, then the kernel's device ms per call
    by mode -> the result."""
    scene, cfg, name = presets.flagship(device=device)
    camera = Camera.from_config(cfg.camera, cfg.aspect, device=device)
    W, H = cfg.width, cfg.height
    tiled = tile_order_ids(W, H)

    label = nvidia_smi() if torch.device(device).type == "cuda" else "cpu"
    result = {"scene": name, "device": label}
    result.update(referee(scene, *make_rays(camera, W, H, 1, "random")))
    print(f"mismatches: {result['mismatches']}/{result['rays']} "
          f"({result['near_ties']} near ties, {result['outside_tie_rule']} "
          "outside the tie rule)")
    print(f"referee({result['adjudicated']} sampled): new-correct "
          f"{result['new_correct']}, bf-correct {result['bf_correct']}, "
          f"neither {result['neither']}")

    def f_new(s, o, d, t):
        return find_hit(s, o, d, t, method="pallas")

    result["ms"] = {}
    for mode in MODES:
        sets = [(scene, *make_rays(camera, W, H, s, mode, tiled))
                for s in range(TIMED_SETS)]
        result["ms"][mode] = device_time(f"new kernel {mode}", f_new, sets)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m sexy_raytracer_tpu_torch.tools.check_find_referee",
        description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) | cpu: where the rays are traced")
    args = ap.parse_args(argv)
    print(f"scene: {presets.flagship_name()}", flush=True)
    print(json.dumps(run(args.device)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
