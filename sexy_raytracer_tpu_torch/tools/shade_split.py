"""Where the time of the shade-family kernels goes: kernel 3 (the hit
record, ``fused.hitrec_fused``), kernel 4 (shade + carry,
``fused.shade_carry_fused``) and their VJPs, kernels 5 (``hitrec_bwd``)
and 6 (``shade_bwd``), each beside its copy floor.

    python -m sexy_raytracer_tpu_torch.tools.shade_split [--out JSON]

On the card. Captures the stacks of the flagship frame's mid chunk (bounce
0, 524,288 rays) and of one train step (bounce 0, 131,072 rays, bench.py's
paths): kernels 3 and 4 at both; kernels 5 and 6 at the train step's
bounce-0 backward and at the frame chunk with a cotangent drawn from a
seed. For each it prints the median ms by CUDA events (20 launches) and
the device ms by the profiler of the kernel, for kernels 4 and 6 also on
unaligned copies of their stacks (``unaligned``: they then read device
memory instead of bulk-copying their tiles), and of its copy floor
(``fused.stack_copy``: the same stacks streamed by a kernel of the first
kernels' launch shape that does no math), the byte bound (each input
read once, the output written once, at 3.35 TB/s), a hash of the inputs
and of the output (``digest``: two checkouts whose digests agree
computed the same bits), how many output values differ in their bits
from the plain version's on the card, and for kernels 4 and 6 how many
warps hold no ray with a hit (``hit_mix``). Kernel 6 also at every
bounce of the train step's backward and of the frame chunk (its shade
stacks with a seeded cotangent), where the later bounces hold more warps
with no hit (``bounce_rows``). Then each kernel's registers, stack frame
and spills from ptxas, with the occupancy they and its shared memory
allow, its SASS instructions by class (``sass_mix``), and for kernel 3
how many 32-ray warps of each hit-record call of the frame chunk and the
train step hold triangle lanes only, sphere or miss lanes only, or both
(``warp_mix``).
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


def launch_shapes():
    """{a fragment of the kernel's name in ptxas's report: (threads a
    block, dynamic shared memory a block)} of the shade-family kernels and
    their copy floor, as their C entries launch them (kernel 4 through its
    ring)."""
    tr, stages = fused.SHADE_TILE_RAYS, fused.SHADE_STAGES
    threads = fused.BLOCK_THREADS
    return {
        "hitrec_kernel": (threads, 0),
        "shade_staged_kernel": (tr + 32, stages * (
            (fused.NSF + fused.NSI) * tr * 4 + 16)),
        "hitrec_bwd_kernel": (threads, 0),
        "shade_bwd_kernel": (fused.SHADE_BWD_TILE_RAYS, 0),
        "stack_copy_kernel": (threads, 0),
    }


def _warp_counts(flag, warp):
    """Per warp of ``warp`` rays, how many rays have ``flag``; a last, part
    warp is padded with copies of its last ray."""
    pad = -flag.shape[0] % warp
    if pad:
        flag = torch.cat([flag, flag[-1:].expand(pad)])
    return flag.view(-1, warp).sum(dim=1)


def warp_mix(hf, warp=32):
    """Warps of ``warp`` rays of a hit-record stack (row 32: the lane
    takes the triangle branch) -> {"triangle": warps of triangle lanes
    only, "sphere or miss": of the other lanes only, "mixed": of both,
    "warps"}. A last, part warp counts by its rays."""
    n_tri = _warp_counts(hf[32] > 0.5, warp)
    return {"triangle": int((n_tri == warp).sum()),
            "sphere or miss": int((n_tri == 0).sum()),
            "mixed": int(((n_tri > 0) & (n_tri < warp)).sum()),
            "warps": int(n_tri.numel())}


def hit_mix(sf, warp=32):
    """Warps of ``warp`` rays of a shade stack (row 26: the ray has a
    hit) -> {"no hit": warps whose rays all miss or are dead, which kernel
    6 runs without the forward, "warps"}."""
    n_hit = _warp_counts(sf[26] > 0.5, warp)
    return {"no hit": int((n_hit == 0).sum()), "warps": int(n_hit.numel())}


def inputs(device):
    """{"frame chunk" | "train step": {kernel: its arguments}} for kernels
    3 and 4 at bounce 0 of the frame's mid chunk and of a train step, and
    5 and 6 at the train step's bounce-0 backward (its last ``hitrec_bwd``
    and ``shade_bwd`` calls) and at the frame chunk's stacks with a
    cotangent of standard normals (seed 0); "hitrec calls": every hit
    record stack of the chunk and of the step, by bounce; "shade_bwd
    calls": kernel 6's arguments at every bounce of the step's backward
    and, with such a cotangent, of the chunk's shade stacks, by bounce."""
    scene, cfg, cam, ids, tgt, new_step = train_setup(device)
    key = rng.key(cfg.seed, device=device)
    bg = torch.tensor(cfg.background, device=device)
    P = cfg.width * cfg.height
    spb = cfg.samples_per_batch
    chunk = min(cfg.rays_per_chunk // spb, P)
    mid = (-(-P // chunk) // 2) * chunk
    fids = torch.from_numpy(renderer.tile_pixel_order(
        cfg.width, cfg.height)[mid:mid + chunk]).to(device)
    names = ["hitrec_fused", "shade_carry_fused"]
    frame = capture_calls([integrator] * 2, names, lambda: (
        renderer.render_pixels(
            scene, cam, fids, 0, key, bg, width=cfg.width, height=cfg.height,
            spb=spb, spp_total=cfg.samples_per_pixel,
            max_bounce=cfg.max_bounce, last_bounce_vis=True)))
    step, state = new_step()
    train = capture_calls(
        [integrator] * 2 + [fused] * 2, names + ["hitrec_bwd", "shade_bwd"],
        lambda: step(state, scene, cam, ids, tgt, rng.key(0, device)))
    (hf,), (sf, si) = frame["hitrec_fused"][0], frame["shade_carry_fused"][0]
    gen = torch.Generator(device=device).manual_seed(0)
    gh = torch.randn((fused.NHO, hf.shape[1]), generator=gen, device=device)
    frame_bwd = [c + (torch.randn((fused.NSO, c[0].shape[1]), generator=gen,
                                  device=device),)
                 for c in frame["shade_carry_fused"]]
    return {
        "frame chunk": {
            "hitrec": (hf,), "shade": (sf, si), "hitrec_bwd": (hf, gh),
            "shade_bwd": frame_bwd[0],
            "hitrec calls": [c[0] for c in frame["hitrec_fused"]],
            "shade_bwd calls": frame_bwd},
        "train step": {
            "hitrec": train["hitrec_fused"][0],
            "shade": train["shade_carry_fused"][0],
            "hitrec_bwd": train["hitrec_bwd"][-1],
            "shade_bwd": train["shade_bwd"][-1],
            "hitrec calls": [c[0] for c in train["hitrec_fused"]],
            # the backward runs the bounces last to first
            "shade_bwd calls": train["shade_bwd"][::-1]},
    }


def unaligned(x):
    """A copy of ``x`` whose base lies 4 bytes past a 16-byte boundary:
    kernels 4 and 6 read it from device memory, not with bulk copies."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    y = buf[1:].view(x.shape)
    y.copy_(x)
    return y


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


def calls(args):
    """{kernel: (the call on ``args[kernel]``, its plain version's call,
    its copy floor's call, bytes the function must move)} of kernels 3-6;
    each copy floor streams the kernel's f32 inputs stacked into one and
    its int rows."""
    NHF, NHO, NSF, NSO = fused.NHF, fused.NHO, fused.NSF, fused.NSO

    def floor(f32, si, n_out):
        f = torch.cat([t.detach() for t in f32])
        return lambda: fused.stack_copy(f, si, n_out)

    hf, = args["hitrec"]
    sf, si = args["shade"]
    bh, gh = args["hitrec_bwd"]
    bs, bi, gs = args["shade_bwd"]
    R, Rb = hf.shape[1], bh.shape[1]
    return {
        "kernel 3": (lambda: fused.hitrec_fused(hf),
                     lambda: fused.hitrec_math(hf.detach()),
                     floor([hf], None, NHO), (NHF + NHO) * 4 * R),
        "kernel 4": (lambda: fused.shade_carry_fused(sf, si),
                     lambda: fused.shade_carry_math(sf.detach(), si),
                     floor([sf], si, NSO),
                     (NSF + fused.NSI + NSO) * 4 * sf.shape[1]),
        "kernel 5": (lambda: fused.hitrec_bwd(bh, gh),
                     lambda: fused.hitrec_vjp_plain(bh, gh),
                     floor([bh, gh], None, NHF), (2 * NHF + NHO) * 4 * Rb),
        "kernel 6": (lambda: fused.shade_bwd(bs, bi, gs),
                     lambda: fused.shade_vjp_plain(bs, bi, gs),
                     floor([bs, gs], bi, NSF),
                     (2 * NSF + fused.NSI + NSO) * 4 * bs.shape[1]),
    }


# the kernels with a second path, taken on unaligned copies of their
# stacks: they then read device memory instead of bulk-copying their tiles
_UNALIGNED = {"kernel 4": fused.shade_carry_fused, "kernel 6": fused.shade_bwd}


def kernel_rows(inp):
    """Kernels 3-6 at the frame chunk and the train step of ``inp``
    (``inputs``), each beside its copy floor and its bound, with the
    digests of inputs and output and the count of output values whose
    bits differ from the plain version's; and kernel 3's warp mix at
    every bounce of both."""
    rows = []
    for case, args in inp.items():
        for kernel, (call, plain, copy, n_bytes) in calls(args).items():
            arg = args[{"kernel 3": "hitrec", "kernel 4": "shade",
                        "kernel 5": "hitrec_bwd",
                        "kernel 6": "shade_bwd"}[kernel]]
            out = call().detach()
            row = dict(case=f"{kernel}, {case}", rays=arg[0].shape[1],
                       bytes=n_bytes,
                       bound_ms=n_bytes / HBM_BYTES_PER_S * 1e3,
                       kernel=_timed(call), copy=_timed(copy),
                       in_sha=digest(*arg), out_sha=digest(out),
                       plain_differs=int((out.view(torch.int32) != plain()
                                          .view(torch.int32)).sum()),
                       values=out.numel())
            if kernel in _UNALIGNED:
                off = tuple(unaligned(t.detach()) for t in arg)
                row["unaligned"] = _timed(
                    lambda: _UNALIGNED[kernel](*off))
                row["warps"] = hit_mix(arg[0].detach())
            print(json.dumps(row), flush=True)
            rows.append(row)
        row = dict(case=f"kernel 3 warp mix, {case}", bounces=[
            warp_mix(hf) for hf in args["hitrec calls"]])
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def bounce_rows(inp):
    """Kernel 6 at every bounce of the frame chunk and the train step of
    ``inp`` (``inputs``): its time, its warps with no hit and the digest
    of its output."""
    rows = []
    for case, args in inp.items():
        for b, (sf, si, g) in enumerate(args["shade_bwd calls"]):
            call = lambda: fused.shade_bwd(sf, si, g)  # noqa: E731
            row = dict(case=f"kernel 6 bounce {b}, {case}", rays=sf.shape[1],
                       kernel=_timed(call), warps=hit_mix(sf.detach()),
                       in_sha=digest(sf, si, g), out_sha=digest(call()))
            print(json.dumps(row), flush=True)
            rows.append(row)
    return rows


def register_rows():
    """Registers, stack frame, spills, shared memory and occupancy of the
    shade-family kernels and their copy floors from the build's ptxas
    report, at the block shape and dynamic shared memory each is
    launched with (``launch_shapes``)."""
    shapes = launch_shapes()
    rows = []
    for name, rep in _cuda.ptxas_report().items():
        frag = next((f for f in shapes if f in name), None)
        if frag is None:
            continue
        threads, dyn = shapes[frag]
        smem = rep["smem"] + dyn
        blocks, warps, occ = occupancy(rep["registers"], threads, smem)
        rows.append(dict(kernel=name, threads=threads,
                         registers=rep["registers"], stack=rep["stack"],
                         spill=rep["spill"], smem=smem,
                         blocks_per_sm=blocks, warps_per_sm=warps,
                         occupancy=occ))
        print(json.dumps(rows[-1]), flush=True)
    return rows


# instruction classes of ``sass_mix``, by opcode
_SASS_CLASSES = {
    "f32": ("FADD", "FMUL", "FFMA", "FSETP", "FMNMX", "FSEL", "FCHK", "FSET"),
    "mufu": ("MUFU",), "lds": ("LDS",), "sts": ("STS",),
    "local": ("LDL", "STL"), "global": ("LDG", "STG"),
    "branch": ("BRA", "CALL", "RET", "BSSY", "BSYNC", "WARPSYNC"),
}


def sass_mix(sass, fragment):
    """Instructions of each function of ``cuobjdump -sass`` text whose name
    holds ``fragment`` -> {name: {"instructions": n, class: n, ...}}, a
    static count (each instruction once, whatever the branches run)."""
    import re

    out = {}
    for func in re.split(r"\n\s*Function : ", sass)[1:]:
        name = func.split("\n", 1)[0].strip()
        if fragment not in name:
            continue
        ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)",
                         func)
        row = {"instructions": len(ops)}
        for cls, names in _SASS_CLASSES.items():
            row[cls] = sum(op in names for op in ops)
        out[name] = row
    return out


def sass_rows():
    """``sass_mix`` of the shade-family kernels in the built library."""
    import os
    import subprocess

    tool = os.path.join(os.path.dirname(_cuda._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(_cuda.build())],
                          capture_output=True, text=True, check=True).stdout
    rows = {}
    for frag in launch_shapes():
        rows.update(sass_mix(sass, frag))
    for name, row in rows.items():
        print(json.dumps(dict(kernel=name, **row)), flush=True)
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
    result = dict(device=smi, registers=register_rows(), sass=sass_rows())
    inp = inputs(dev)
    result["rows"] = kernel_rows(inp)
    result["bounces"] = bounce_rows(inp)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
