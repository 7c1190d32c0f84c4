"""The RNG kernels (``csrc/rng.cu``: ``rng.ray_keys_and_camera`` and
``rng.bounce_draws``) at the main path's shapes, beside their bound.

    python -m sexy_raytracer_tpu_torch.tools.rng_split [--out JSON]

On the card. For the frame chunk (524,288 paths) and the fit step
(1,048,576), 4 bounces each: both kernels held to their plain int64
versions bit for bit; the median ms of each kernel and of the pair by CUDA
events (20 calls), the pair's device ms by the profiler, the plain pair's
ms (3 calls); the SASS instructions of each kernel a thread by opcode
(``cuobjdump``, NOPs left out: the kernels have no loops, so every thread
runs each instruction once, bar the early exit) and the bound, the
largest of the bytes at 3.35 TB/s and of each pipe's instructions at its
rate: the INT32 pipe's (``ALU``: adds, logic, shifts, compares) at 64
lanes an SM a clock, the multiply-add pipe's integer ``IMAD`` forms at
64, the conversions (``I2F``) at 16, and every instruction at the dispatch
rate of 128 (four warp schedulers); 132 SMs at 1.98 GHz, the H100 SXM's
boost clock.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess

import numpy as np
import torch

from sexy_raytracer_tpu_torch.ops import _cuda
from sexy_raytracer_tpu_torch.tools.histogram_split import (
    device_split,
    events_ms,
    nvidia_smi,
)
from sexy_raytracer_tpu_torch.utils import rng

HBM_BYTES_PER_S = 3.35e12
SM_CLOCKS_PER_S = 132 * 1.98e9
# thread instructions an SM a clock: each pipe's, and the dispatch rate
PIPE_RATES = {"alu": 64, "imad": 64, "conversion": 16, "dispatch": 128}
ALU = ("IADD3", "LOP3", "SHF", "ISETP", "LEA", "SEL", "PRMT", "IMNMX",
       "IABS", "VIADD", "IADD")
SHAPES = (("frame chunk", 524288), ("fit step", 1048576))
BOUNCES = 4
KERNELS = ("ray_keys_kernel", "bounce_kernel")


def sass_instructions(sass=None) -> dict:
    """Instructions of each RNG kernel in ``cuobjdump -sass`` text (the
    built library's by default), NOPs left out -> {kernel: {pipe: n}} for
    the pipes of ``PIPE_RATES`` (``dispatch``: all of them) and
    {kernel: {opcode: n}}."""
    if sass is None:
        tool = os.path.join(os.path.dirname(_cuda._nvcc()), "cuobjdump")
        sass = subprocess.run([tool, "-sass", str(_cuda.build())],
                              capture_output=True, text=True,
                              check=True).stdout
    out = {}
    for func in re.split(r"\n\s*Function : ", sass)[1:]:
        name = func.split("\n", 1)[0].strip()
        kernel = next((k for k in KERNELS if k in name), None)
        if kernel is None:
            continue
        ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)",
                         func)
        ops = [op for op in ops if op != "NOP"]
        by_op = {op: ops.count(op) for op in sorted(set(ops))}
        pipes = dict(
            alu=sum(n for op, n in by_op.items() if op in ALU),
            imad=sum(n for op, n in by_op.items() if op.startswith("IMAD")),
            conversion=sum(n for op, n in by_op.items()
                           if op in ("I2F", "F2I")),
            dispatch=len(ops))
        out[kernel] = dict(pipes=pipes, opcodes=by_op)
    return out


def ops_ms(threads: dict, instructions: dict) -> tuple:
    """The least ms of ``threads`` ({kernel: threads}) by the busiest pipe
    -> (ms, pipe)."""
    ms = {pipe: sum(n * instructions[k]["pipes"][pipe]
                    for k, n in threads.items()) / (rate * SM_CLOCKS_PER_S)
          * 1e3 for pipe, rate in PIPE_RATES.items()}
    pipe = max(ms, key=ms.get)
    return ms[pipe], pipe


def bound(R: int, B: int, instructions: dict) -> dict:
    """The pair's bound at ``R`` paths and ``B`` bounces: bytes (the ids
    read, the keys written and read back, the draws written) and the
    threads' instructions by the busiest pipe."""
    n_bytes = R * (4 + 4 + 16 + 20) + R * 16 + R * B * 24
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops, pipe = ops_ms({"ray_keys_kernel": R, "bounce_kernel": R * B},
                         instructions)
    return dict(bytes=n_bytes, bytes_ms=bytes_ms, ops_ms=t_ops, pipe=pipe,
                bound_ms=max(bytes_ms, t_ops),
                bound_by="operations" if t_ops >= bytes_ms else "bytes")


def inputs(R: int, device, seed: int = 2147483653):
    """A base key and ``[R]`` int32 pixel ids of a 720p frame and sample
    ids, as ``render_pixels`` hands them over."""
    r = np.random.default_rng(seed % 2 ** 32)
    pid = torch.tensor(r.integers(0, 1280 * 720, R), dtype=torch.int32,
                       device=device)
    sid = torch.tensor(r.integers(0, 5000, R), dtype=torch.int32,
                       device=device)
    return rng.key(seed, device), pid, sid


def rows(device, instructions: dict) -> list:
    out = []
    for label, R in SHAPES:
        base_key, pid, sid = inputs(R, device)
        keys, ucam = rng.ray_keys_and_camera(base_key, pid, sid)
        u = rng.bounce_draws(keys, BOUNCES)
        keys_p, ucam_p = rng.ray_keys_and_camera_plain(base_key, pid, sid)
        u_p = rng.bounce_draws_plain(keys_p, BOUNCES)
        differ = int((keys != keys_p).sum()) \
            + int((ucam.view(torch.int32) != ucam_p.view(torch.int32)).sum()) \
            + int((u.view(torch.int32) != u_p.view(torch.int32)).sum())
        del keys_p, ucam_p, u_p

        def pair():
            k, _ = rng.ray_keys_and_camera(base_key, pid, sid)
            return rng.bounce_draws(k, BOUNCES)

        def plain_pair():
            k, _ = rng.ray_keys_and_camera_plain(base_key, pid, sid)
            return rng.bounce_draws_plain(k, BOUNCES)

        device_ms, n_kernels, _ = device_split(pair)
        row = dict(
            case=label, paths=R, bounces=BOUNCES, values_differing=differ,
            keys_ms=events_ms(lambda: rng.ray_keys_and_camera(
                base_key, pid, sid)),
            bounce_ms=events_ms(lambda: rng.bounce_draws(keys, BOUNCES)),
            pair_ms=events_ms(pair), device_ms=device_ms,
            device_kernels=n_kernels, plain_ms=events_ms(plain_pair, 3),
            **bound(R, BOUNCES, instructions))
        print(json.dumps(row), flush=True)
        if differ:
            raise AssertionError(f"{label}: {differ} values differ from the "
                                 "plain version")
        out.append(row)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None, help="also write the rows here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("rng_split: needs a CUDA device")
    smi = nvidia_smi()
    print(smi, flush=True)
    _cuda.build()
    registers = {name: rep for name, rep in _cuda.ptxas_report().items()
                 if any(k in name for k in KERNELS)}
    instructions = sass_instructions()
    print(json.dumps(dict(registers=registers, instructions=instructions)),
          flush=True)
    result = dict(device=smi, registers=registers, instructions=instructions,
                  rows=rows(torch.device("cuda:0"), instructions))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
