"""The readings the limits of ``limits/<cell>.json`` are set from, at the
cell's own size, on the card, in one process.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--control-seeds 1,2,3] [--faults half,altered --fault-seeds 1,2,3] \
        [--seconds 2] [--out build/calibrate/<cell>.json]

For each seed: the program's set-up and a short window at the cell's own
load, then the check against the reference (the program's readings); on
the control seeds, the same run's reference in the control's precision put
in the program's place (the control's readings); on the fault seeds, a
run with each fault of ``faults.py`` planted. Prints one line a reading
and, with ``--out``, writes them all as JSON. The benchmark's own runs
never run this.
"""

from __future__ import annotations

import json
import os
import sys
import time

if __name__ == "__main__":
    # the checkout's root on the path, in place of this script's folder
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

from benchmark import faults, harness  # noqa: E402


def seeds_of(text):
    return [int(s) for s in text.split(",") if s.strip()] if text else []


def one(cell, drv, seed, seconds, dev, controls=()):
    """{"program": readings, control: readings, ...} of one seed."""
    def log(*a):
        print(*a, file=sys.stderr, flush=True)

    st = drv.setup(cell, seed, dev, log)
    win = drv.window(st, seconds, harness.NoTrace(), dev)
    prog = drv.release(st, win)
    del st
    torch.cuda.empty_cache()
    out = {"program": drv.check(cell, seed, prog, dev, log), "units": win.units}
    for c in controls:
        out[c] = drv.check(cell, seed, prog, dev, log, control=c)
    return out


def main(argv):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    cell = harness.find_cell(args.workload)
    drv = harness.loop_of(cell)
    dev = harness.Device(torch, "cuda")
    from sexy_raytracer_tpu_torch.ops import _cuda
    _cuda.library()
    rows = []
    ctl = set(seeds_of(args.control_seeds))
    for seed in sorted(set(seeds_of(args.seeds)) | ctl):
        t0 = time.perf_counter()
        r = one(cell, drv, seed, args.seconds, dev,
                controls=("bf16",) if seed in ctl else ())
        for kind, readings in r.items():
            if kind == "units":
                continue
            rows.append({"seed": seed, "kind": kind, **readings})
            print(json.dumps(rows[-1]), flush=True)
        print(f"seed {seed}: {time.perf_counter() - t0:.1f} s, "
              f"{r['units']} units", file=sys.stderr, flush=True)
    for fault in [f for f in args.faults.split(",") if f]:
        for seed in seeds_of(args.fault_seeds):
            with faults.planted(drv, fault):
                r = one(cell, drv, seed, args.seconds, dev)
            rows.append({"seed": seed, "kind": f"fault:{fault}",
                         **r["program"]})
            print(json.dumps(rows[-1]), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"workload": args.workload,
                       "card": harness.power_limit(), "rows": rows}, f,
                      indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
