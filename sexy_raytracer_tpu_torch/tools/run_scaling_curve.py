"""The strong-scaling curve of the sharded chunk renderer (counterpart of
the root ``tools/run_scaling_curve.py``).

Measures ``make_sharded_chunk_fn``'s throughput on 1, 2, 4 and 8 ranks at
a fixed total work (8,192 pixels of the 240p flagship at spb 2, 64 spp in
all, ``method="bruteforce"``; 3 chunks after a settling one) and writes
``OUT`` (``artifacts/torch/scaling.json``; ``scaling_cpu.json`` for CPU
ranks). Each count runs in a fresh group of ranks (``parallel.spawn``):

    python -m sexy_raytracer_tpu_torch.tools.run_scaling_curve            # NCCL ranks, one card each
    python -m sexy_raytracer_tpu_torch.tools.run_scaling_curve --device cpu   # gloo ranks on the CPU
    python -m sexy_raytracer_tpu_torch.tools.run_scaling_curve --n 4      # one measurement

On the cards a count above ``torch.cuda.device_count()`` is not run: the
artifact lists it as not measured, with the reason (NCCL takes one card a
rank, and ranks sharing a card over gloo measure no scaling). CPU ranks
share the host's cores, one torch thread each: as the JAX tool's virtual
CPU devices, they measure the sharding's mechanics, not multi-chip
scaling (the artifact's WARNING).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch
import torch.distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
OUT_DIR = os.path.join(REPO, "artifacts", "torch")
COUNTS = (1, 2, 4, 8)
# the fixed total work of one chunk, whatever the rank count
PIXELS, SPB, SPP_TOTAL, HEIGHT, REPS = 8192, 2, 64, 240, 3


def _measure_rank(n, device_type, pixels, height):
    """One rank: the chunk renderer on an (n, 1) mesh -> (row, the whole
    chunk's radiance [pixels, 3] as numpy, gathered over the ranks)."""
    from sexy_raytracer_tpu_torch.models import presets
    from sexy_raytracer_tpu_torch.ops import _cuda
    from sexy_raytracer_tpu_torch.parallel.mesh import (
        RAY_AXIS,
        make_mesh,
        mesh_device,
        shard_rays,
    )
    from sexy_raytracer_tpu_torch.parallel.render import make_sharded_chunk_fn
    from sexy_raytracer_tpu_torch.render.camera import Camera
    from sexy_raytracer_tpu_torch.render.renderer import tile_pixel_order
    from sexy_raytracer_tpu_torch.utils import rng
    from sexy_raytracer_tpu_torch.utils.profiling import sync

    mesh = make_mesh(n, 1, device_type=device_type)
    dev = mesh_device(mesh)
    scene, cfg, _ = presets.flagship(height=height, spp=SPP_TOTAL,
                                     device=dev)
    camera = Camera.from_config(cfg.camera, cfg.aspect, device=dev)
    fn = make_sharded_chunk_fn(
        mesh, width=cfg.width, height=cfg.height, spb=SPB,
        spp_total=SPP_TOTAL, max_bounce=cfg.max_bounce, method="bruteforce")
    ids = shard_rays(tile_pixel_order(cfg.width, cfg.height)[:pixels], mesh)
    key = rng.key(0, device=dev)
    bg = torch.tensor(cfg.background, dtype=torch.float32, device=dev)

    out = fn(scene, camera, ids, 0, key, bg)
    sync(out)  # first launches + settle
    for k in _cuda.KERNELS:
        k.launches = 0
    dist.barrier()
    t0 = time.time()
    for i in range(REPS):
        out = fn(scene, camera, ids, 2 * (i + 1), key, bg)
    sync(out)
    dist.barrier()
    dt = (time.time() - t0) / REPS
    parts = [torch.empty_like(out) for _ in range(n)]
    dist.all_gather(parts, out, group=mesh.get_group(RAY_AXIS))
    rays = pixels * SPB * cfg.max_bounce
    row = {"n_devices": n, "seconds_per_chunk": dt,
           "mrays_per_s": rays / dt / 1e6,
           "launches_per_chunk": {k.symbol: k.launches / REPS
                                  for k in _cuda.KERNELS}}
    return row, torch.cat(parts).cpu().numpy()


def measure(n, device="cuda", pixels=PIXELS, height=HEIGHT):
    """``n`` new ranks (NCCL on ``n`` cards, or gloo on the CPU) ->
    (rank 0's row, the chunk's radiance)."""
    from sexy_raytracer_tpu_torch.parallel.mesh import spawn

    device_type = torch.device(device).type
    backend = "nccl" if device_type == "cuda" else "gloo"
    return spawn(_measure_rank, n, backend, device_type, n, device_type,
                 pixels, height)[0]


def curve(device="cuda", counts=COUNTS, **size):
    """Every count of ``counts`` that the device can hold -> (the artifact,
    {n: chunk radiance})."""
    is_cuda = torch.device(device).type == "cuda"
    have = torch.cuda.device_count() if is_cuda else None
    rows, chunks, not_measured = [], {}, []
    for n in counts:
        if is_cuda and n > have:
            not_measured.append({
                "n_devices": n,
                "reason": f"{n} NCCL ranks need {n} cards; this machine has "
                          f"{have}, and ranks that share a card over gloo "
                          "measure no scaling"})
            print(not_measured[-1], flush=True)
            continue
        row, chunks[n] = measure(n, device, **size)
        rows.append(row)
        print(row, flush=True)

    cores = os.cpu_count() or 1
    for r in rows:
        n = r["n_devices"]
        r["speedup_vs_1"] = round(r["mrays_per_s"] / rows[0]["mrays_per_s"],
                                  3)
        ideal = n if is_cuda else min(n, cores)
        r["efficiency_vs_core_ceiling"] = round(
            r["mrays_per_s"] / (rows[0]["mrays_per_s"] * ideal), 3)
    if is_cuda:
        art = {
            "WARNING": (
                f"{have} card(s) on this machine: only the counts in rows "
                "ran, one NCCL rank a card; the counts in not_measured "
                "were not run and are no scaling evidence."),
            "devices": "cuda",
            "note": ("strong scaling, fixed total work, one rank a card; "
                     "efficiency_vs_core_ceiling = measured / (1-rank rate "
                     "x n)"),
        }
    else:
        art = {
            "WARNING": (
                f"{cores} physical CPU cores emulating the devices (gloo "
                "ranks, one torch thread each) — this measures SPMD "
                "sharding MECHANICS only, NOT multi-chip scaling evidence. "
                "Multi-card scaling shows only in the rows of a run on the "
                "cards; cross-process exactness is shown by "
                "tests/test_torch_parallel.py instead."),
            "devices": "cpu",
            "host_physical_cores": cores,
            "note": (
                "strong scaling, fixed total work, gloo ranks share "
                f"{cores} cores: ideal speedup saturates at {cores}; "
                "efficiency_vs_core_ceiling = measured / (1-rank rate x "
                "min(n, cores))"),
        }
    art.update(rows=rows, not_measured=not_measured)
    return art, chunks


def out_path(device):
    cpu = torch.device(device).type != "cuda"
    return os.path.join(OUT_DIR, "scaling_cpu.json" if cpu else "scaling.json")


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m sexy_raytracer_tpu_torch.tools.run_scaling_curve",
        description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=None,
                    help="one measurement on N ranks")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: NCCL ranks, one card each) | cpu "
                         "(gloo ranks)")
    args = ap.parse_args(argv)
    from sexy_raytracer_tpu_torch.models import presets
    from sexy_raytracer_tpu_torch.tools.histogram_split import nvidia_smi

    print(f"scene: {presets.flagship_name()}", flush=True)
    label = nvidia_smi() if torch.device(args.device).type == "cuda" \
        else "cpu"
    print(f"device: {label}", flush=True)
    size = dict(pixels=PIXELS, height=HEIGHT)
    if args.n:
        print(json.dumps(measure(args.n, args.device, **size)[0]))
        return 0
    art, _ = curve(args.device, COUNTS, **size)
    art.update(scene=presets.flagship_name(), device=label)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(out_path(args.device), "w") as f:
        json.dump(art, f, indent=2)
    print(json.dumps(art, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
