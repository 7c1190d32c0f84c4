"""Round-5 diagnostics on the port (counterpart of the root
``tools/diag_r5.py``): where the train step and the frame driver spend
their time, and what dead-lane compaction would buy.

    python -m sexy_raytracer_tpu_torch.tools.diag_r5 [--json] [--device cuda|cpu]

On the 720p flagship (the stand-in without the Master Chief asset; the
first line printed names it), ``R`` = 131,072 rays a population:

  1. ``find_hit`` cost for: tile-ordered primaries (the top of the
     screen), random-tile primaries (the train step's batch), the frame's
     middle chunk, and the real bounce 1-3 wavefronts of the train batch
     (scattered rays and alive masks from tracing);
  2. the same bounce wavefronts with the dead lanes compacted to a dense
     prefix (a stable partition), and the compacted find's prim ids
     against the plain find's (its parity count, 0 when they agree);
  3. ``ops/find.cluster_lists`` (the cull) alone, with its mean and max
     active clusters per block;
  4. one ``render_pixels`` dispatch (spb 1) per screen region.

Times are host clock over ``n`` calls after one, with
``torch.cuda.synchronize`` around the loop on the card. ``--json`` also
writes the results to ``JSON_OUT`` and prints them as the last line.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import tempfile
import time

import numpy as np
import torch

from sexy_raytracer_tpu_torch.diff.inverse import sample_tile_ids
from sexy_raytracer_tpu_torch.models import presets
from sexy_raytracer_tpu_torch.ops.find import cluster_lists
from sexy_raytracer_tpu_torch.ops.intersect import (
    T_MIN_DEFAULT,
    find_hit,
    hit_data,
)
from sexy_raytracer_tpu_torch.ops.shade import shade
from sexy_raytracer_tpu_torch.render.camera import Camera
from sexy_raytracer_tpu_torch.render.renderer import (
    render_pixels,
    tile_pixel_order,
)
from sexy_raytracer_tpu_torch.tools.histogram_split import nvidia_smi
from sexy_raytracer_tpu_torch.utils import rng
from sexy_raytracer_tpu_torch.utils.profiling import sync

R = 131072
TIMED, FRAME_TIMED = 8, 4
FRAME_REGIONS = ((0, "top"), (3, "mid"), (6, "bottom"))
JSON_OUT = os.path.join(tempfile.gettempdir(), "diag_r5.json")


def timeit(name, fn, *args, n=TIMED, results=None):
    """ms per call of ``fn(*args)`` over ``n`` calls after one, the card
    synchronized before and after the loop."""
    sync(fn(*args))
    t0 = time.time()
    for _ in range(n):
        out = fn(*args)
    sync(out)
    dt = (time.time() - t0) / n * 1e3
    print(f"{name:56s} {dt:9.2f} ms", flush=True)
    if results is not None:
        results[name] = round(dt, 3)
    return dt


def find_compact(scene, org, dir, tm, t_min):
    """``find_hit``'s prim ids with the live lanes (t_min < 1e38) moved to
    a dense prefix, in order, and the result scattered back."""
    n = org.shape[0]
    alive = t_min < 1e38
    na = torch.cumsum(alive.to(torch.int32), 0)
    nd = torch.cumsum((~alive).to(torch.int32), 0)
    pos = torch.where(alive, na - 1, na[-1] + nd - 1).long()
    dest = torch.zeros((n,), dtype=torch.long, device=org.device)
    dest[pos] = torch.arange(n, device=org.device)
    p, _ = find_hit(scene, org[dest].contiguous(), dir[dest].contiguous(),
                    tm[dest], t_min=t_min[dest], method="auto")
    return p[pos]


def find_plain(scene, org, dir, tm, t_min):
    return find_hit(scene, org, dir, tm, t_min=t_min, method="auto")[0]


def advance(scene, org, dir, tm, keys, bounce):
    """One bounce of the reference integrator's pieces: the closest hit,
    its record, the bounce's draws and the scatter -> (org, dir, alive)."""
    t_min = torch.full((org.shape[0],), T_MIN_DEFAULT, device=org.device)
    prim, _ = find_hit(scene, org, dir, tm, t_min=t_min, method="auto")
    rec = hit_data(scene, org, dir, tm, prim)
    u = rng.per_ray_uniform_block(rng.fold_in(keys, 100 + bounce), 6)
    rand = {
        "unit_vector": rng.unit_vector_from_uniforms(u[..., 0], u[..., 1]),
        "unit_ball": rng.in_unit_sphere_from_uniforms(
            u[..., 2], u[..., 3], u[..., 4]),
        "uniform": u[..., 5],
    }
    samp = shade(scene, rec, dir, rand)
    alive = rec.hit & samp.scattered
    org2 = torch.where(alive[..., None], rec.p, org)
    dir2 = torch.where(alive[..., None], samp.direction, dir)
    return org2.contiguous(), dir2.contiguous(), alive


def run(device="cuda"):
    """The four measurements -> results by name."""
    scene, cfg, name = presets.flagship(device=device)
    camera = Camera.from_config(cfg.camera, cfg.aspect, device=device)
    W, H = cfg.width, cfg.height
    label = nvidia_smi() if torch.device(device).type == "cuda" else "cpu"
    results = {"scene": name, "device": label}
    base_key = rng.key(0, device=device)

    order = tile_pixel_order(W, H)
    rng_np = np.random.default_rng(0)

    def primary(pids):
        pid = torch.from_numpy(np.asarray(pids, np.int32)).to(device)
        keys = rng.ray_keys_2d(base_key, pid, torch.zeros_like(pid))
        u5 = rng.per_ray_uniform_block(keys, 5)
        u = ((pid % W).float() + u5[..., 0]) / (W - 1)
        v = ((H - (pid // W).float()) + u5[..., 1]) / (H - 1)
        org, d, t = camera.get_rays(u, v, u5[..., 2:5])
        return org.contiguous(), d.contiguous(), t, keys

    t_min0 = torch.full((R,), T_MIN_DEFAULT, device=device)
    pops = {}
    o, d, t, _ = primary(order[:R])
    pops["primary_top(bench fwd)"] = (o, d, t, t_min0)
    o2, d2, t2, k2 = primary(sample_tile_ids(rng_np, W, H, R))
    pops["primary_random_tiles(train)"] = (o2, d2, t2, t_min0)
    o3, d3, t3, _ = primary(order[3 * R:4 * R])
    pops["primary_mid_frame"] = (o3, d3, t3, t_min0)

    # real bounce wavefronts of the train batch
    org_b, dir_b = o2, d2
    alive_b = torch.ones((R,), dtype=torch.bool, device=device)
    bounce_pops = {}
    for b in range(3):
        org_b, dir_b, a = advance(scene, org_b, dir_b, t2, k2, b)
        alive_b = alive_b & a
        frac = float(alive_b.float().mean())
        print(f"bounce {b + 1}: alive fraction {frac:.3f}", flush=True)
        results[f"alive_frac_b{b + 1}"] = round(frac, 4)
        t_min = torch.where(alive_b, T_MIN_DEFAULT, 3.0e38)
        bounce_pops[f"bounce{b + 1}_wavefront"] = (org_b, dir_b, t2, t_min)
    pops.update(bounce_pops)

    # 1/2. the find per population, plain and compacted
    for pop, args in pops.items():
        timeit(f"find[{pop}]", find_plain, scene, *args, results=results)
    for pop, args in bounce_pops.items():
        timeit(f"find_compacted[{pop}]", find_compact, scene, *args,
               results=results)
        mism = int((find_plain(scene, *args)
                    != find_compact(scene, *args)).sum())
        print(f"  compaction parity: {mism} mismatches", flush=True)
        results[f"compact_parity[{pop}]"] = mism

    # 3. the cull alone
    def cull_only(org, dir, t_min):
        return cluster_lists(org, dir, t_min, scene.cluster_min,
                             scene.cluster_max)

    for pop in ("primary_random_tiles(train)", "bounce2_wavefront"):
        org, dir, _, t_min = pops[pop]
        timeit(f"cluster_lists[{pop}]", cull_only, org, dir, t_min,
               results=results)
        cnt = cull_only(org, dir, t_min)[:, 0].cpu().numpy()
        print(f"  active clusters/block: mean {cnt.mean():.1f} "
              f"max {cnt.max()} blocks {cnt.shape[0]}", flush=True)
        results[f"cull_mean_active[{pop}]"] = round(float(cnt.mean()), 2)
        results[f"cull_max_active[{pop}]"] = int(cnt.max())

    # 4. one frame-driver dispatch per screen region (spb 1, fused path)
    fwd = functools.partial(
        render_pixels, width=W, height=H, spb=1,
        spp_total=cfg.samples_per_pixel, max_bounce=cfg.max_bounce,
        method="auto")
    bg = torch.tensor(cfg.background, dtype=torch.float32, device=device)
    for i, region in FRAME_REGIONS:
        fpix = torch.from_numpy(order[i * R:(i + 1) * R]).to(device)
        timeit(f"frame_dispatch[{region}]", fwd, scene, camera, fpix, 0,
               base_key, bg, n=FRAME_TIMED, results=results)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m sexy_raytracer_tpu_torch.tools.diag_r5",
        description=__doc__.split("\n")[0])
    ap.add_argument("--json", action="store_true",
                    help=f"also write the results to {JSON_OUT}")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) | cpu: where the rays are traced")
    args = ap.parse_args(argv)
    print(f"scene: {presets.flagship_name()}", flush=True)
    results = run(args.device)
    if args.json:
        with open(JSON_OUT, "w") as f:
            json.dump(results, f, indent=1)
        print(json.dumps(results))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
