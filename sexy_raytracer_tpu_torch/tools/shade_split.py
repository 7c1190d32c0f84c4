"""Where kernel 4's time goes (shade + carry, ``fused.shade_carry_fused``),
beside its copy floor, and kernel 6 (its VJP) at the train step.

    python -m sexy_raytracer_tpu_torch.tools.shade_split [--out JSON]

On the card. Captures the shade stacks of the flagship frame's mid chunk
(bounce 0, 524,288 rays) and of one train step (bounce 0, 131,072 rays,
bench.py's paths), and for each prints the median ms by CUDA events (20
launches) and the device ms by the profiler of the shade kernel and of
its copy floor (``fused.stack_copy``: the same stacks streamed by a kernel
that does no shading), the byte bound (the stacks read once, 16 rows
written, at 3.35 TB/s), and each kernel's registers from ptxas with the
occupancy they and its shared memory allow. Then kernel 6 at the train
step's bounce-0 backward. Each row holds a hash of its inputs and outputs
(``digest``): two checkouts whose digests agree computed the same bits.
"""

from __future__ import annotations

import argparse
import hashlib
import json

import torch

from sexy_raytracer_tpu_torch.ops import _cuda, fused
from sexy_raytracer_tpu_torch.render import integrator, renderer
from sexy_raytracer_tpu_torch.tools.histogram_split import (
    capture_calls,
    device_split,
    events_ms,
    nvidia_smi,
    train_setup,
)
from sexy_raytracer_tpu_torch.utils import rng

HBM_BYTES_PER_S = 3.35e12
# an H100 SM: registers, threads, resident blocks, shared memory for blocks
SM_REGISTERS, SM_THREADS, SM_BLOCKS, SM_SMEM = 65536, 2048, 32, 233472


def occupancy(registers, threads, smem):
    """Resident warps per SM for blocks of ``threads`` threads using
    ``registers`` a thread and ``smem`` bytes (registers are allocated in
    units of 256 a warp; 1 KB of shared memory a block is reserved) ->
    (blocks, warps, share of the SM's 64 warps)."""
    warps = -(-threads // 32)
    per_warp = -(-max(registers, 1) * 32 // 256) * 256
    blocks = min(SM_BLOCKS, SM_THREADS // (warps * 32),
                 (SM_REGISTERS // per_warp) // warps)
    if smem:
        blocks = min(blocks, SM_SMEM // (smem + 1024))
    return blocks, blocks * warps, blocks * warps / 64


def kernel_report(fragment):
    """ptxas's entries whose mangled name holds ``fragment``."""
    return {k: v for k, v in _cuda.ptxas_report().items() if fragment in k}


def inputs(device):
    """{label: (sf, si)} of the frame chunk's and the train step's first
    shade call, and the train step's last ``shade_bwd`` arguments (bounce
    0's backward)."""
    scene, cfg, cam, ids, tgt, new_step = train_setup(device)
    key = rng.key(cfg.seed, device=device)
    bg = torch.tensor(cfg.background, device=device)
    P = cfg.width * cfg.height
    spb = cfg.samples_per_batch
    chunk = min(cfg.rays_per_chunk // spb, P)
    mid = (-(-P // chunk) // 2) * chunk
    fids = torch.from_numpy(renderer.tile_pixel_order(
        cfg.width, cfg.height)[mid:mid + chunk]).to(device)
    frame = capture_calls([integrator], ["shade_carry_fused"], lambda: (
        renderer.render_pixels(
            scene, cam, fids, 0, key, bg, width=cfg.width, height=cfg.height,
            spb=spb, spp_total=cfg.samples_per_pixel,
            max_bounce=cfg.max_bounce, last_bounce_vis=True)))
    step, state = new_step()
    train = capture_calls(
        [integrator, fused], ["shade_carry_fused", "shade_bwd"],
        lambda: step(state, scene, cam, ids, tgt, rng.key(0, device)))
    return {"frame chunk": frame["shade_carry_fused"][0],
            "train step": train["shade_carry_fused"][0]}, \
        train["shade_bwd"][-1]


def digest(*tensors):
    """A short hash of the tensors' bytes: equal digests from two
    checkouts show bit-equal inputs or outputs."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _timed(fn, reps=20):
    dev_ms, n_k, _ = device_split(fn, n=5)
    return dict(ms=events_ms(fn, reps), device_ms=dev_ms, kernels=n_k)


def shade_rows(device):
    stacks, bwd = inputs(device)
    rows = []
    for label, (sf, si) in stacks.items():
        R = sf.shape[1]
        n_bytes = (fused.NSF + fused.NSI + fused.NSO) * 4 * R
        row = dict(case=label, rays=R, bytes=n_bytes,
                   bound_ms=n_bytes / HBM_BYTES_PER_S * 1e3,
                   shade=_timed(lambda: fused.shade_carry_fused(sf, si)),
                   in_sha=digest(sf, si),
                   out_sha=digest(fused.shade_carry_fused(sf, si)),
                   copy=_timed(lambda: fused.stack_copy(sf, si)))
        print(json.dumps(row), flush=True)
        rows.append(row)
    row = dict(case="kernel 6, train step bounce 0 backward",
               rays=bwd[0].shape[1], **_timed(lambda: fused.shade_bwd(*bwd)),
               in_sha=digest(*bwd), out_sha=digest(fused.shade_bwd(*bwd)))
    print(json.dumps(row), flush=True)
    rows.append(row)
    return rows


def register_rows():
    """Registers, shared memory, spills and occupancy of the shade
    kernels (forward, copy floor, backward) from the build's ptxas
    report. The staged kernel runs a tile's rays and one producer warp,
    with its ring of stages in dynamic shared memory; the others run 256
    threads."""
    rows = []
    for frag in ("shade_staged_kernel", "stack_copy_kernel",
                 "shade_bwd_kernel"):
        for name, rep in kernel_report(frag).items():
            threads, smem = 256, rep["smem"]
            if frag == "shade_staged_kernel":
                tr, stages = fused.SHADE_TILE_RAYS, fused.SHADE_STAGES
                threads = tr + 32
                smem += stages * (fused.NSF + fused.NSI) * tr * 4 \
                    + 16 * stages
            blocks, warps, occ = occupancy(rep["registers"], threads, smem)
            rows.append(dict(kernel=name, threads=threads,
                             registers=rep["registers"], smem=smem,
                             spill=rep["spill"], blocks_per_sm=blocks,
                             warps_per_sm=warps, occupancy=occ))
            print(json.dumps(rows[-1]), flush=True)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None, help="also write the rows here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("shade_split: needs a CUDA device")
    smi = nvidia_smi()
    print(smi, flush=True)
    dev = torch.device("cuda:0")
    _cuda.build()
    result = dict(device=smi, registers=register_rows(),
                  rows=shade_rows(dev))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
