"""Where the hit search's time goes: kernels 8 (``find_streamed``) and 2
(``find_any``) at the big frame's and the frame's shapes, with the tests
their walks make.

    python -m sexy_raytracer_tpu_torch.tools.find_split [walk|sass]
        [--out JSON] [--sass-out TXT]

``walk`` (the default), on the card: captures the wrapper calls of the
flagship frame's mid chunk (kernel 2 and its regrouping pass, first:
late in a process the profiler loses device events), of one mid chunk
of the big frame (``flagship_standin(n=389)``, 302,642 triangles; kernel
8 at bounces 0, 1 and 2, kernel 2 and the pass on the last bounce), and
65,536 primary rays of the big scene; for each kernel it prints the
median time by CUDA events, the device time by the profiler, and the
executed, live and needed (ray, triangle) tests of
``checks.walk_counts``; for the pass, its times. The bound from the needed
tests is ``needed x 37`` float32 operations over 67 TFLOP/s. ``sass``
writes ``cuobjdump -sass`` of the built library and counts, in each find
kernel's innermost loops, the shared-memory loads and the float32
instructions.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import tempfile

import torch

from sexy_raytracer_tpu_torch.checks import walk_counts
from sexy_raytracer_tpu_torch.models import presets
from sexy_raytracer_tpu_torch.ops import _cuda, find
from sexy_raytracer_tpu_torch.render import renderer
from sexy_raytracer_tpu_torch.render.camera import Camera
from sexy_raytracer_tpu_torch.tools.histogram_split import (
    capture_calls,
    device_split,
    events_ms,
    nvidia_smi,
    train_setup,
)
from sexy_raytracer_tpu_torch.utils import rng

BIG_N, BIG_SPP = 389, 8
OPS_PER_TEST = 37            # chip_smoke.py: float32 operations of one test
F32_FLOPS_PER_S = 67e12


def _row(label, closest, fn, args, scene, reps):
    ms = events_ms(fn, reps)
    dev_ms, n_k, _ = device_split(fn, n=min(reps, 5))
    counts = walk_counts(closest, args, scene.cluster_min, scene.cluster_max)
    row = dict(case=label, rays=args[1].shape[0], ms=ms, device_ms=dev_ms,
               kernels_per_call=n_k, **counts,
               needed_bound_ms=counts["needed"] * OPS_PER_TEST
               / F32_FLOPS_PER_S * 1e3,
               executed_bound_ms=counts["executed"] * OPS_PER_TEST
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
    scene, fcfg, fcam, _, _, _ = train_setup(device)
    key = rng.key(fcfg.seed, device=device)
    bg = torch.tensor(fcfg.background, device=device)
    P = fcfg.width * fcfg.height
    spb = fcfg.samples_per_batch
    chunk = min(fcfg.rays_per_chunk // spb, P)
    mid = (-(-P // chunk) // 2) * chunk
    fids = torch.from_numpy(renderer.tile_pixel_order(
        fcfg.width, fcfg.height)[mid:mid + chunk]).to(device)
    calls = capture_calls([find, find], ["any_regroup", "find_any"],
                          lambda: renderer.render_pixels(
        scene, fcam, fids, 0, key, bg, width=fcfg.width, height=fcfg.height,
        spb=spb, spp_total=fcfg.samples_per_pixel,
        max_bounce=fcfg.max_bounce, last_bounce_vis=True))
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


def sass_rows(out_path):
    lib = _cuda.build()
    tool = os.path.join(os.path.dirname(_cuda._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    if out_path:
        with open(out_path, "w") as f:
            f.write(sass)
    rows = {}
    for k in ("find_closest_kernel", "find_any_kernel",
              "find_streamed_kernel"):
        rows[k] = sass_loops(sass, k)[:3]
        print(f"{k}: innermost loops {json.dumps(rows[k])}", flush=True)
    log = _cuda.build_info.get("log", "")
    rows["ptxas"] = [ln.strip() for ln in log.splitlines()
                     if "find" in ln or "registers" in ln or "spill" in ln]
    for ln in rows["ptxas"]:
        print(f"ptxas: {ln}", flush=True)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("cmd", nargs="?", default="walk", choices=["walk", "sass"])
    ap.add_argument("--out", default=None, help="also write the rows here")
    ap.add_argument("--sass-out", default=None,
                    help="sass: write the library's SASS here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("find_split: needs a CUDA device")
    smi = nvidia_smi()
    print(smi, flush=True)
    dev = torch.device("cuda:0")
    _cuda.build()
    if args.cmd == "walk":
        result = dict(device=smi, rows=walk_rows(dev))
    else:
        result = dict(device=smi, sass=sass_rows(args.sass_out))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
