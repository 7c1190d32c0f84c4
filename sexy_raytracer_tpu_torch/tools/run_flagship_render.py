"""The flagship 720p render on the port (counterpart of the root
``tools/run_flagship_render.py``): the scene at 1280x720 with
checkpoint/resume, the full PNG and a 360p downsample, and full-image
region statistics against the reference golden ``images/test-5kx720p.png``
when it is present (the iron-sphere region is excluded: its textures are
absent from the reference's data, texture.h:131).

    python -m sexy_raytracer_tpu_torch.tools.run_flagship_render \\
        [--spp 1000] [--method auto] [--device cuda|cpu]

The scene is ``presets.masterchief`` when its asset is present, else the
flagship stand-in (``presets.flagship``); the first line printed names
it, and the report records it as ``"scene"``. Output goes to ``ART``
(``artifacts/torch/flagship/``). The checkpoint there is named by scene,
height and spp, and is removed once the render is whole, so a rerun
renders anew; a run that resumes an interrupted one reports
``resumed_from_unit`` and times only the units it traced, so its
``mpaths_per_s`` is null.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from sexy_raytracer_tpu_torch.models import presets
from sexy_raytracer_tpu_torch.render.renderer import render_accumulate
from sexy_raytracer_tpu_torch.tools.histogram_split import nvidia_smi
from sexy_raytracer_tpu_torch.utils import color as colorlib
from sexy_raytracer_tpu_torch.utils.png import read_png, write_png

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
ART = os.path.join(REPO, "artifacts", "torch", "flagship")
# the reference's images/ beside its data/
GOLDEN = os.path.join(os.path.dirname(presets.default_data_dir()), "images",
                      "test-5kx720p.png")
HEIGHT = 720

# 240p region map (tests/test_golden.py) scaled x3 to 720p; tolerances on
# LINEAR region means (golden squared), chief looser per VALIDATION.md §4
REGIONS = {
    "sky": ((0, 150), (0, 300), 0.01),
    "ground_right": ((600, 708), (900, 1272), 0.015),
    "metal_sphere": ((435, 540), (870, 1080), 0.03),
    "chief_torso": ((198, 330), (579, 699), 0.05),
    "chief_legs": ((429, 600), (579, 699), 0.05),
}


def render(spp, method="auto", device="cuda", checkpoint=None):
    """The flagship at ``HEIGHT`` with ``spp`` samples, 4 a batch ->
    (radiance sums [H, W, 3], seconds, scene name)."""
    scene, cfg, name = presets.flagship(height=HEIGHT, spp=spp,
                                        device=device)
    # one render_pixels call per 4 samples of a pixel chunk
    cfg = dataclasses.replace(cfg, samples_per_batch=4)
    t0 = time.time()
    accum = render_accumulate(scene, cfg, method=method, progress=True,
                              checkpoint=checkpoint)
    return accum, time.time() - t0, name


def checkpoint_path(name, spp):
    """The render's checkpoint in ``ART``, named by scene, height and
    spp, so that no other render resumes it."""
    return os.path.join(ART, f"checkpoint_{name}_{HEIGHT}p_{spp}spp.npz")


def region_report(accum, spp, golden):
    """The ``region_*`` entries, ``regions_pass`` and ``regions_failed``
    of ``accum`` against the golden (uint8 [H, W, 3])."""
    g = golden.astype(np.float64) / 255.0
    lin_ours = np.clip(accum / spp, 0.0, 0.998)
    report, failures = {}, []
    for name, (rows, cols, tol) in REGIONS.items():
        ours = lin_ours[rows[0]:rows[1], cols[0]:cols[1]].mean(axis=(0, 1))
        ref = (g[rows[0]:rows[1], cols[0]:cols[1]] ** 2).mean(axis=(0, 1))
        err = float(np.abs(ours - ref).max())
        report[f"region_{name}"] = {
            "ours": [round(float(x), 4) for x in ours],
            "golden": [round(float(x), 4) for x in ref],
            "max_err": round(err, 4),
            "tol": tol,
            "pass": bool(err <= tol),
        }
        if err > tol:
            failures.append(name)
    report["regions_pass"] = not failures
    report["regions_failed"] = failures
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m sexy_raytracer_tpu_torch.tools.run_flagship_render",
        description=__doc__.split("\n")[0])
    ap.add_argument("--spp", type=int, default=1000)
    ap.add_argument("--method", default="auto")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) | cpu: where the scene is traced")
    args = ap.parse_args(argv)
    print(f"scene: {presets.flagship_name()}", flush=True)
    label = nvidia_smi() if torch.device(args.device).type == "cuda" \
        else "cpu"
    print(f"device: {label}", flush=True)
    os.makedirs(ART, exist_ok=True)

    print(f"rendering 1280x{HEIGHT} @ {args.spp} spp ({args.method})...",
          flush=True)
    ckpt = checkpoint_path(presets.flagship_name(), args.spp)
    resumed = int(np.load(ckpt)["units_done"]) if os.path.exists(ckpt) \
        else None
    accum, wall, name = render(args.spp, args.method, args.device,
                               checkpoint=ckpt)
    os.remove(ckpt)
    print(f"done in {wall:.1f}s", flush=True)
    H, W = accum.shape[:2]

    resolved = colorlib.resolve(accum, args.spp)
    img = colorlib.to_uint8(resolved)
    write_png(os.path.join(ART, f"render_{HEIGHT}p_{args.spp}spp.png"), img)
    write_png(os.path.join(ART, f"render_{HEIGHT // 2}p.png"), img[::2, ::2])

    report = {"scene": name, "device": label, "spp": args.spp,
              "method": args.method, "wall_s": round(wall, 1),
              "mpaths_per_s": round(W * H * args.spp / wall / 1e6, 3)}
    if resumed is not None:
        report.update(resumed_from_unit=resumed, mpaths_per_s=None)
    golden = read_png(GOLDEN, 3)
    if golden is not None:
        report.update(region_report(accum, args.spp, golden))
    with open(os.path.join(ART, "report.json"), "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
