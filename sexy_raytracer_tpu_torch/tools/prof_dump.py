"""Per-op events of the train step with their tracks (counterpart of
``tools/prof_dump.py``).

Profiles four train steps of the bench's configuration on one device and
prints the top (track, op) pairs by time per step: on the card the
device's events with their CUDA stream, on the CPU the ops' self times
with their thread.

Usage: python -m sexy_raytracer_tpu_torch.tools.prof_dump [--device cpu]

The JAX tool's ``--hlo`` wrote the optimized HLO of the jitted step. Eager
PyTorch compiles no program for the step, so there is nothing to dump:
the flag is refused with a message saying so.
"""

from __future__ import annotations

import argparse
import sys
from collections import defaultdict

from sexy_raytracer_tpu_torch.tools.devtime import profile_events
from sexy_raytracer_tpu_torch.tools.profile import train_step_inputs
from sexy_raytracer_tpu_torch.utils import rng

HLO_REFUSAL = ("prof_dump: --hlo has no counterpart in the port: the JAX "
               "tool dumped XLA's optimized HLO of the jitted train step, "
               "and eager PyTorch compiles no program to dump")


def main(argv=None, steps=4, top=70, **sizes):
    """``sizes``: ``pixels``, ``spb``, ``n``, ``height`` of
    ``profile.train_step_inputs`` -> {(track, name): [ms, count]} per
    step."""
    argv = sys.argv[1:] if argv is None else list(argv)
    if "--hlo" in argv:
        print(HLO_REFUSAL, file=sys.stderr)
        raise SystemExit(2)
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    step, state, scene, camera, pix, tgt = train_step_inputs(args.device,
                                                             **sizes)
    for _ in range(2):
        state, loss = step(state, scene, camera, pix, tgt,
                           rng.key(0, args.device))
        float(loss)

    def run():
        return step(state, scene, camera, pix, tgt,
                    rng.key(1, args.device))[1]

    kind, events = profile_events(run, [()], steps)
    agg = defaultdict(lambda: [0.0, 0])
    for track, name, us in events:
        agg[(track, name)][0] += us / 1e3 / steps
        agg[(track, name)][1] += 1
    print(f"per step, {kind} events, {steps} steps:")
    rows = sorted(agg.items(), key=lambda kv: -kv[1][0])[:top]
    for (track, name), (ms, count) in rows:
        print(f"{ms:9.3f} ms  x{count // steps:<4d} [{track[:28]:28s}] "
              f"{name[:90]}")
    return dict(rows)


if __name__ == "__main__":
    main()
