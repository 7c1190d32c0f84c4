"""Per-op device-time breakdown of the flagship train step (counterpart of
``tools/prof_step.py``).

Builds the bench's train step on one device (32,768 pixels x spb 4 =
131,072 paths, method auto, the last-bounce shortcut where the scene
allows it) on the stand-in scene and prints the device time per step and
the top ops by device time (``tools/devtime.py``).

Usage: python -m sexy_raytracer_tpu_torch.tools.prof_step [top_n]
           [--device cpu]
"""

from __future__ import annotations

import argparse

from sexy_raytracer_tpu_torch.tools.devtime import device_time, op_breakdown
from sexy_raytracer_tpu_torch.tools.profile import train_step_inputs
from sexy_raytracer_tpu_torch.utils import rng


def main(argv=None, reps=6, **sizes):
    """Profile ``reps`` steps; ``sizes``: ``pixels``, ``spb``, ``n``,
    ``height`` of ``profile.train_step_inputs`` -> the op table."""
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("top_n", nargs="?", type=int, default=40)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    step, state, scene, camera, pix, tgt = train_step_inputs(args.device,
                                                             **sizes)
    # steady state: one step first
    state, loss = step(state, scene, camera, pix, tgt, rng.key(0, args.device))
    float(loss)

    def run(state):
        return step(state, scene, camera, pix, tgt,
                    rng.key(1, args.device))[1]

    paths = pix.shape[0] * sizes.get("spb", 4)
    device_time(f"train_step({paths} paths)", run, [(state,)], n=reps)
    return op_breakdown(run, [(state,)], n=reps, top=args.top_n)


if __name__ == "__main__":
    main()
