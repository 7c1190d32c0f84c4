"""Profiling tool of the port (counterpart of ``tools/profile.py``).

Subcommands:
  step           component timings of the flagship train step (find /
                 hit_data / shade / fwd trace, fused and reference / loss
                 fwd / loss fwd+bwd), on the bench's ray distribution
                 (random screen tiles)
  xplane         torch.profiler table of the one-device train step: device
                 ops per step and the per-op device times
  histogram      direct-vs-sorted dense_histogram A/B at the bench's sizes
  bigscene       find-hit throughput over scene size (resident cluster
                 kernel vs streamed cluster kernel), each size in a
                 subprocess; the rows go to ``--out``
  _bigscene_one  one size of that sweep

Usage:
  python -m sexy_raytracer_tpu_torch.tools.profile <subcommand>
      [--device cuda|cpu] [--tris T] [--method M] [--out JSON]
      [--width 320 --height 204]

Run it as a module (``-m``): as a script its name would shadow the
standard library's ``profile``. Everything runs on the card unless
``--device cpu`` asks for the CPU; each subcommand's sizes are parameters
of its function, with the JAX tool's sizes as defaults. The flagship
asset is not in the repository, so the scene is
``presets.flagship_standin(n=39)``, the relief of the chief's 3,042
triangles. Times are host-clock means over calls that end in a device
synchronise.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from sexy_raytracer_tpu_torch.diff.inverse import (
    _loss_fn,
    make_optimizer,
    make_train_step,
    sample_tile_ids,
)
from sexy_raytracer_tpu_torch.diff.params import extract_params
from sexy_raytracer_tpu_torch.models import presets
from sexy_raytracer_tpu_torch.models.scene import SceneBuilder
from sexy_raytracer_tpu_torch.ops.histogram import (
    dense_histogram,
    dense_histogram_sorted,
)
from sexy_raytracer_tpu_torch.ops.intersect import (
    PALLAS_RESIDENT_MAX_TRIS,
    find_hit,
    hit_data,
)
from sexy_raytracer_tpu_torch.ops.shade import shade
from sexy_raytracer_tpu_torch.render.camera import Camera
from sexy_raytracer_tpu_torch.render.integrator import scene_no_emissive_tris
from sexy_raytracer_tpu_torch.render.renderer import (
    render_pixels,
    tile_pixel_order,
)
from sexy_raytracer_tpu_torch.tools.devtime import profile_events
from sexy_raytracer_tpu_torch.utils import rng
from sexy_raytracer_tpu_torch.utils.profiling import sync

_ROOT = Path(__file__).resolve().parents[2]
BIGSCENE_OUT = _ROOT / "build" / "bigscene_crossover.json"
HISTOGRAM_CASES = (
    ("atlas coherent", 131072, 524288, 8, True),
    ("atlas uniform (worst case)", 131072, 524288, 8, False),
    ("tripack", 131072, 3042, 16, True),
    ("atlas 4-bounce batch", 524288, 524288, 8, True),
)
BIGSCENE_RUNS = ((3042, None), (50000, None), (110000, None), (304000, None),
                 (304000, "bvh"), (600000, None))


def _timeit(name, fn, *args, n=10):
    """Mean ms of ``fn(*args)`` over ``n`` calls after one warm-up call."""
    out = fn(*args)
    sync(out)
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*args)
    sync(out)
    dt = (time.perf_counter() - t0) / n * 1e3
    print(f"{name:46s} {dt:9.2f} ms", flush=True)
    return dt


def _standin(device, n, height):
    scene, cfg = presets.flagship_standin(n=n, height=height, device=device)
    print(f"scene: flagship stand-in (presets.flagship_standin(n={n})), "
          f"{scene.num_triangles} triangles, {cfg.width}x{cfg.height}, "
          f"device {device}", flush=True)
    return scene, cfg


def bench_inputs(device="cuda", pixels=32768, spb=4, n=39, height=720):
    """The bench workload: the stand-in and ``pixels * spb`` camera paths
    through random screen tiles (profile.py:68-96)."""
    scene, cfg = _standin(device, n, height)
    camera = Camera.from_config(cfg.camera, cfg.aspect, device=device)
    ids = torch.from_numpy(sample_tile_ids(
        np.random.default_rng(0), cfg.width, cfg.height, pixels)).to(device)
    pid = ids.repeat_interleave(spb)
    sid = torch.arange(spb, dtype=torch.int32, device=device).repeat(pixels)
    keys = rng.ray_keys_2d(rng.key(1, device), pid, sid)
    ucam = rng.per_ray_uniform_block(keys, 5)
    x = (pid % cfg.width).to(torch.float32)
    y = (pid // cfg.width).to(torch.float32)
    u = (x + ucam[:, 0]) / (cfg.width - 1)
    v = ((cfg.height - y) + ucam[:, 1]) / (cfg.height - 1)
    org, dirs, times = camera.get_rays(u, v, ucam[:, 2:5])
    return dict(scene=scene, cfg=cfg, camera=camera, pid=ids, keys=keys,
                org=org, dirs=dirs, times=times, spb=spb)


def train_step_inputs(device="cuda", pixels=32768, spb=4, n=39, height=720,
                      last_bounce_vis=None):
    """(step, state, scene, camera, pixel ids, target) of the bench's train
    step on one device: ``make_train_step`` with
    ``make_optimizer(params, 1e-3)``, a constant 0.5 target.
    ``last_bounce_vis=None`` takes it where the scene allows it."""

    scene, cfg = _standin(device, n, height)
    camera = Camera.from_config(cfg.camera, cfg.aspect, device=device)
    params = extract_params(scene)
    if last_bounce_vis is None:
        last_bounce_vis = scene_no_emissive_tris(scene)
    step = make_train_step(cfg, make_optimizer(params, 1e-3), spb=spb,
                           method="auto", last_bounce_vis=last_bounce_vis)
    ids = torch.from_numpy(sample_tile_ids(
        np.random.default_rng(0), cfg.width, cfg.height, pixels)).to(device)
    tgt = torch.full((pixels, 3), 0.5, device=device)
    return step, step.init(params), scene, camera, ids, tgt


def cmd_step(device="cuda", pixels=32768, spb=4, n=39, height=720, reps=10):
    """Component timings of the train step (profile.py:99-157) -> {row:
    ms}."""

    w = bench_inputs(device, pixels, spb, n, height)
    scene, cfg, camera, pid, keys = (w["scene"], w["cfg"], w["camera"],
                                     w["pid"], w["keys"])
    rays = (w["org"], w["dirs"], w["times"])
    background = torch.tensor(cfg.background, device=device)
    R = pid.shape[0] * spb

    def find(o, d, tm):
        return find_hit(scene, o, d, tm, method="pallas")

    def record(o, d, tm):
        return hit_data(scene, o, d, tm, find(o, d, tm)[0])

    def fwd_shade(o, d, tm):
        un = rng.per_ray_uniform_block(keys, 6)
        rand = {
            "unit_vector": rng.unit_vector_from_uniforms(un[:, 0], un[:, 1]),
            "unit_ball": rng.in_unit_sphere_from_uniforms(
                un[:, 2], un[:, 3], un[:, 4]),
            "uniform": un[:, 5],
        }
        return shade(scene, record(o, d, tm), d, rand)

    kw = dict(width=cfg.width, height=cfg.height, spb=spb,
              spp_total=cfg.samples_per_pixel, max_bounce=4, method="auto")

    def trace(fused):
        return lambda: render_pixels(scene, camera, pid, 0, rng.key(0, device),
                                     background, fused=fused, **kw)

    params = extract_params(scene)
    tgt = torch.full((pid.shape[0], 3), 0.5, device=device)

    def loss(p):
        return _loss_fn(p, scene, camera, pid, tgt, 0, rng.key(0, device),
                        background, **kw)

    def loss_grad():
        p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        return torch.autograd.grad(loss(p), list(p.values()),
                                   allow_unused=True)

    rows = {}
    rows["find_hit"] = _timeit("find_hit (cluster kernel incl. lists)", find,
                               *rays, n=reps)
    rows["find + hit_data"] = _timeit("find + hit_data", record, *rays,
                                      n=reps)
    rows["find + hit_data + shade"] = _timeit(
        "find + hit_data + shade (1 bounce)", fwd_shade, *rays, n=reps)
    rows["fwd trace"] = _timeit(f"full fwd trace (4 bounces, {R} paths)",
                                trace(None), n=reps)
    rows["fwd trace, reference"] = _timeit(
        "  the same, reference integrator", trace(False), n=reps)
    rows["loss fwd"] = _timeit("loss fwd", loss, params, n=reps)
    rows["loss fwd+bwd"] = _timeit("loss fwd+bwd (bench step sans optimizer)",
                                   loss_grad, n=reps)
    return rows


def cmd_xplane(device="cuda", pixels=32768, spb=4, n=39, height=720,
               steps=3, top=25):
    """torch.profiler over ``steps`` train steps (profile.py:160-231):
    the steady step time, device ops per step and the ``top`` ops by
    device time -> every op's {name: [ms per step, count per step]}."""
    step, state, scene, camera, pix, tgt = train_step_inputs(
        device, pixels, spb, n, height, last_bounce_vis=False)
    for _ in range(2):
        state, loss = step(state, scene, camera, pix, tgt, rng.key(0, device))
        float(loss)
    t0 = time.perf_counter()
    for i in range(4):
        state, loss = step(state, scene, camera, pix, tgt, rng.key(i, device))
    float(loss)
    print(f"steady step: {(time.perf_counter() - t0) / 4 * 1e3:.2f} ms",
          flush=True)

    def run():
        return step(state, scene, camera, pix, tgt, rng.key(0, device))[1]

    kind, events = profile_events(run, [()], steps)
    table = {}
    for _, name, us in events:
        ms, count = table.get(name, (0.0, 0))
        table[name] = (ms + us / 1e3, count + 1)
    print(f"{kind} ops/step: {len(events) // steps}")
    rows = {name: [ms / steps, count / steps] for name, (ms, count) in
            sorted(table.items(), key=lambda kv: -kv[1][0])}
    for name, (ms, count) in list(rows.items())[:top]:
        print(f"{ms:9.3f} ms  x{count:<6g} {name[:100]}")
    return rows


def histogram_inputs(cases=HISTOGRAM_CASES, device="cuda"):
    """Yield ``(name, idx, vals, n_bins)`` of each A/B case, made as
    profile.py:243-255 makes them: coherent ids ``base * 37 % N`` of
    ``N // 40`` bases, or uniform ones, and unit normal values."""
    rng = np.random.default_rng(3)
    for name, R, N, C, clustered in cases:
        if clustered:
            base = rng.integers(0, N // 40, size=R)
            idx = (base * 37 % N).astype(np.int32)
        else:
            idx = rng.integers(0, N, size=R).astype(np.int32)
        vals = rng.normal(size=(R, C)).astype(np.float32)
        yield (name, torch.from_numpy(idx).to(device),
               torch.from_numpy(vals).to(device), N)


def cmd_histogram(device="cuda", cases=HISTOGRAM_CASES, reps=10):
    """Direct vs sorted dense histogram (profile.py:234-259) -> rows."""
    rows = []
    for name, idx, vals, N in histogram_inputs(cases, device):
        rows.append(dict(
            case=name, entries=idx.shape[0], bins=N, channels=vals.shape[1],
            direct_ms=_timeit(f"direct  {name}", dense_histogram, idx, vals,
                              N, n=reps),
            sorted_ms=_timeit(f"sorted  {name}", dense_histogram_sorted,
                              idx, vals, N, n=reps),
        ))
    return rows


def cmd_bigscene(device="cuda", out=BIGSCENE_OUT, runs=BIGSCENE_RUNS,
                 width=320, height=204, timeout=1200):
    """Each size in a subprocess (a fault costs one point), with a
    ``width`` x ``height`` camera; the rows are written to ``out`` as JSON
    -> rows."""
    rows = []
    for T, method in runs:
        cmd = [sys.executable, "-m", "sexy_raytracer_tpu_torch.tools.profile",
               "_bigscene_one", "--tris", str(T), "--device", str(device),
               "--width", str(width), "--height", str(height)]
        if method:
            cmd += ["--method", method]
        r = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=timeout, cwd=_ROOT)
        line = [ln for ln in r.stdout.splitlines() if ln.startswith("{")]
        if r.returncode == 0 and line:
            rows.append(json.loads(line[-1]))
            print(line[-1], flush=True)
        else:
            print(f"T={T}: FAILED\n{r.stdout[-500:]}\n{r.stderr[-500:]}",
                  flush=True)
    out = Path(out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(rows, indent=2))
    print(f"wrote {out}")
    return rows


def cmd_bigscene_one(tris=304000, method=None, device="cuda", width=320,
                     height=204, reps=10):
    """One scene size (profile.py:290-364): a tessellated terrain
    heightfield seen by a pinhole camera in tile-coherent ray order; the
    mean find time -> its JSON row."""

    n = int(np.sqrt(tris / 2.0))          # n x n quad grid -> 2 n^2 tris
    xs = np.linspace(-30, 30, n + 1)
    X, Z = np.meshgrid(xs, xs, indexing="ij")
    Y = 2.0 * np.sin(X * 0.4) * np.cos(Z * 0.3) + 0.5 * np.sin(X * 1.7)
    verts = np.stack([X, Y, Z], axis=-1).reshape(-1, 3)
    ii, jj = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    a = (ii * (n + 1) + jj).ravel()
    c = a + (n + 1)
    idx = np.concatenate([np.stack([a, a + 1, c], 1),
                          np.stack([a + 1, c + 1, c], 1)])
    b = SceneBuilder()
    m = b.add_pbr_material(base_color=(0.5, 0.5, 0.5, 1.0))
    b.add_mesh(verts, None, idx, m)
    scene = b.build(build_bvh=True, device=device)
    T = scene.num_triangles

    order = tile_pixel_order(width, height)
    px = (order % width).astype(np.float32)
    py = (order // width).astype(np.float32)
    u = (px + 0.5) / width - 0.5
    v = (py + 0.5) / height - 0.5
    eye = np.array([0.0, 18.0, 42.0], np.float32)
    fwd = np.array([0.0, -0.45, -1.0])
    fwd /= np.linalg.norm(fwd)
    right = np.array([1.0, 0.0, 0.0])
    up = np.cross(right, fwd)
    d3 = (fwd[None] + 1.3 * u[:, None] * right[None]
          + 1.3 * 0.64 * v[:, None] * up[None]).astype(np.float32)
    R = d3.shape[0]
    org = torch.from_numpy(np.tile(eye[None], (R, 1))).to(device)
    dirs = torch.from_numpy(d3).to(device)
    times = torch.zeros((R,), device=device)

    method = method or ("pallas" if T <= PALLAS_RESIDENT_MAX_TRIS
                        else "streamed")
    dt = _timeit(f"find_hit {method}, {T} triangles",
                 lambda: find_hit(scene, org, dirs, times, method=method),
                 n=reps) / 1e3
    prim, _ = find_hit(scene, org, dirs, times, method=method)
    row = {
        "tris": T, "method": method, "rays": R,
        "find_ms": round(dt * 1e3, 2),
        "mrays_per_s": round(R / dt / 1e6, 3),
        "hits": int((prim >= 0).sum()),
        "device": (torch.cuda.get_device_name(torch.device(device))
                   if torch.device(device).type == "cuda" else "cpu"),
    }
    print(json.dumps(row), flush=True)
    return row


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("cmd", choices=["step", "xplane", "histogram", "bigscene",
                                   "_bigscene_one"])
    p.add_argument("--tris", type=int, default=304000)
    p.add_argument("--method", default=None)
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")
    p.add_argument("--out", default=str(BIGSCENE_OUT),
                   help="where bigscene writes its rows (JSON)")
    p.add_argument("--width", type=int, default=320,
                   help="the big-scene camera's width in pixels")
    p.add_argument("--height", type=int, default=204,
                   help="the big-scene camera's height in pixels")
    args = p.parse_args(argv)
    dev = args.device
    if args.cmd == "step":
        cmd_step(dev)
    elif args.cmd == "xplane":
        cmd_xplane(dev)
    elif args.cmd == "histogram":
        cmd_histogram(dev)
    elif args.cmd == "bigscene":
        cmd_bigscene(dev, args.out, width=args.width, height=args.height)
    else:
        cmd_bigscene_one(args.tris, args.method, dev, args.width,
                         args.height)


if __name__ == "__main__":
    main()
