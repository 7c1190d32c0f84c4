"""CLI: render the preset scenes / run inverse rendering on the card
(counterpart of ``sexy_raytracer_tpu/__main__.py``).

The subcommands, flags and defaults are the JAX package's, plus
``--device`` (``cuda`` by default; ``cpu`` runs every kernel's plain
PyTorch version, as the tests do). Scenes are built on that device and
traced there; nothing falls back to the CPU. The JAX package's ``bench``
subcommand has no counterpart yet.

Examples:
    python -m sexy_raytracer_tpu_torch render --preset shirley_parity \\
        --height 720 --spp 8 --out shirley.png
    python -m sexy_raytracer_tpu_torch render --preset square \\
        --data-dir data --height 240 --spp 16 --device cpu
    python -m sexy_raytracer_tpu_torch inverse --preset shirley_parity \\
        --height 180 --target target.png --steps 200 --losses-out losses.json
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time


def _add_render_args(p):
    p.add_argument("--preset", default="masterchief",
                   help="shirley | shirley_parity | cube | rustediron | "
                        "masterchief | masterchief_glb | square | scene")
    p.add_argument("--data-dir", default=None)
    p.add_argument("--spp", type=int, default=None)
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--max-bounce", type=int, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--method", default="auto",
                   help="auto | bruteforce | pallas | pallas_mxu | bvh")
    p.add_argument("--samples-per-batch", type=int, default=None)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) | cpu: where the scene is built "
                        "and traced")


def _build(args):
    """The preset's ``(scene, config)`` with the flags applied, as the JAX
    CLI applies them: a zero ``--spp``, ``--height``, ``--max-bounce`` or
    ``--samples-per-batch`` is ignored, and ``--data-dir`` is not passed
    to ``shirley``."""
    from sexy_raytracer_tpu_torch.models import presets

    if args.preset not in presets.PRESETS:
        raise SystemExit(
            f"unknown preset {args.preset!r}; available: "
            + ", ".join(sorted(presets.PRESETS))
        )
    kwargs = {"device": args.device}
    if args.data_dir and args.preset != "shirley":
        kwargs["data_dir"] = args.data_dir
    if args.spp:
        kwargs["spp"] = args.spp
    if args.height:
        kwargs["height"] = args.height
    scene, cfg = presets.PRESETS[args.preset](**kwargs)
    updates = {}
    if args.max_bounce:
        updates["max_bounce"] = args.max_bounce
    if args.seed is not None:
        updates["seed"] = args.seed
    if args.samples_per_batch:
        updates["samples_per_batch"] = args.samples_per_batch
    if updates:
        cfg = dataclasses.replace(cfg, **updates)
    return scene, cfg


def cmd_render(args):
    from sexy_raytracer_tpu_torch.render.renderer import render_image
    from sexy_raytracer_tpu_torch.utils.png import write_png

    scene, cfg = _build(args)
    print(
        f"rendering {args.preset}: {cfg.width}x{cfg.height}, "
        f"{cfg.samples_per_pixel} spp, {cfg.max_bounce} bounces, "
        f"{scene.num_triangles} tris, {scene.num_spheres} spheres",
        file=sys.stderr,
    )
    t0 = time.time()
    img = render_image(
        scene, cfg, method=args.method, progress=True,
        checkpoint=args.checkpoint,
    )
    dt = time.time() - t0
    paths = cfg.width * cfg.height * cfg.samples_per_pixel
    print(
        f"done in {dt:.1f}s — {paths / dt / 1e6:.2f} Mpaths/s "
        f"({paths * cfg.max_bounce / dt / 1e6:.1f} Mray-casts/s)",
        file=sys.stderr,
    )
    write_png(args.out, img)
    print(f"wrote {args.out}", file=sys.stderr)


def cmd_inverse(args):
    import numpy as np

    from sexy_raytracer_tpu_torch.diff.inverse import inverse_render
    from sexy_raytracer_tpu_torch.render.renderer import render_image
    from sexy_raytracer_tpu_torch.utils.png import read_png, write_png

    scene, cfg = _build(args)
    target = read_png(args.target, channels=3)
    if target is None:
        print(f"cannot read target {args.target}", file=sys.stderr)
        return 1
    if target.shape[:2] != (cfg.height, cfg.width):
        print(
            f"target is {target.shape[1]}x{target.shape[0]}, "
            f"render is {cfg.width}x{cfg.height}",
            file=sys.stderr,
        )
        return 1
    target_f = target.astype(np.float32) / 255.0
    scene_opt, losses = inverse_render(
        scene, target_f, cfg,
        n_steps=args.steps,
        pixels_per_step=args.pixels_per_step,
        spb=args.spb,
        learning_rate=args.lr,
        method=args.method,
    )
    print(
        f"loss: first {losses[0]:.6f}, "
        f"min {min(losses):.6f}, last {losses[-1]:.6f} "
        f"({len(losses)} steps)",
        file=sys.stderr,
    )
    if args.losses_out:
        with open(args.losses_out, "w") as f:
            json.dump(losses, f)
        print(f"wrote {args.losses_out}", file=sys.stderr)
    if args.out:
        preview = render_image(
            scene_opt,
            dataclasses.replace(cfg, samples_per_pixel=args.preview_spp),
            method=args.method,
        )
        write_png(args.out, preview)
        print(f"wrote {args.out}", file=sys.stderr)
    return 0


def main(argv=None):
    parser = argparse.ArgumentParser(prog="sexy_raytracer_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("render", help="render a preset scene to PNG")
    _add_render_args(p)
    p.add_argument("--out", default="test.png")
    p.add_argument("--checkpoint", default=None,
                   help="npz checkpoint path for resumable renders")
    p.set_defaults(fn=cmd_render)

    p = sub.add_parser("inverse", help="inverse rendering against a target")
    _add_render_args(p)
    p.add_argument("--target", required=True)
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--pixels-per-step", type=int, default=4096)
    p.add_argument("--spb", type=int, default=4)
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--out", default=None)
    p.add_argument("--preview-spp", type=int, default=64)
    p.add_argument("--losses-out", default=None,
                   help="write the per-step loss curve as JSON")
    p.set_defaults(fn=cmd_inverse)

    args = parser.parse_args(argv)
    return args.fn(args) or 0


if __name__ == "__main__":
    sys.exit(main())
