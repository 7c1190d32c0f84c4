"""Entry points for an outside caller (counterpart of the root
``__graft_entry__.py``).

``entry(device)``        -> (fn, example_args): the forward render step
                           (``render_pixels``, 2,048 pixels at spb 2) on the
                           flagship scene, one device.
``dryrun_multichip(n)``  -> spawns ``n`` ranks, builds the ("rays",
                           "samples") mesh (2-D when ``n`` is even) and runs
                           ONE sharded train step (forward render, pixel
                           MSE, backward, the gradient all-reduce over both
                           axes, Adam) on tiny shapes of the flagship scene
                           (the stand-in without the asset). The ranks
                           take ``n`` cards over NCCL, unless the caller
                           asks for CPU ranks over gloo (``device="cpu"``,
                           the JAX package's virtual CPU mesh).

    python -m sexy_raytracer_tpu_torch.graft_entry                         # entry() on the card
    python -m sexy_raytracer_tpu_torch.graft_entry dryrun 1                # 1 card, NCCL
    python -m sexy_raytracer_tpu_torch.graft_entry dryrun 4 --device cpu   # 4 CPU ranks, gloo
"""

from __future__ import annotations

import argparse
import os
import sys

import torch


def _flagship_scene(device, fallback="shirley_spheres"):
    """Master Chief when the data directory holds its assets, else the
    preset ``fallback`` names."""
    from sexy_raytracer_tpu_torch.models import presets

    data_dir = presets.default_data_dir()
    if os.path.isdir(data_dir):
        try:
            return presets.masterchief(data_dir=data_dir, device=device)
        except (FileNotFoundError, OSError):
            pass
    return getattr(presets, fallback)(device=device)


def entry(device="cuda"):
    """The forward step on the flagship scene and its example args."""
    from sexy_raytracer_tpu_torch.render.camera import Camera
    from sexy_raytracer_tpu_torch.render.renderer import render_pixels
    from sexy_raytracer_tpu_torch.utils import rng

    scene, cfg = _flagship_scene(device)
    camera = Camera.from_config(cfg.camera, cfg.aspect, device=device)
    base_key = rng.key(0, device=device)
    background = torch.tensor(cfg.background, dtype=torch.float32,
                              device=device)
    pixel_ids = torch.arange(2048, dtype=torch.int32, device=device)

    def fn(scene, camera, pixel_ids, sample_start, base_key, background):
        return render_pixels(
            scene, camera, pixel_ids, sample_start, base_key, background,
            width=cfg.width, height=cfg.height, spb=2,
            spp_total=cfg.samples_per_pixel, max_bounce=cfg.max_bounce,
            method="auto")

    return fn, (scene, camera, pixel_ids, 0, base_key, background)


def _dryrun_rank(n_devices: int, device_type: str) -> float:
    """One rank of ``dryrun_multichip``: the sharded train step -> loss."""
    from sexy_raytracer_tpu_torch.diff.inverse import Adam, make_train_step
    from sexy_raytracer_tpu_torch.diff.params import extract_params
    from sexy_raytracer_tpu_torch.parallel.mesh import (
        RAY_AXIS,
        axis_size,
        make_mesh,
        mesh_device,
        shard_rays,
    )
    from sexy_raytracer_tpu_torch.render.camera import Camera
    from sexy_raytracer_tpu_torch.utils import rng
    from sexy_raytracer_tpu_torch.utils.config import RenderConfig

    # 2-D when possible: rays (the data-parallel axis) x samples
    n_samples = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    mesh = make_mesh(n_rays=n_devices // n_samples, n_samples=n_samples,
                     device_type=device_type)
    dev = mesh_device(mesh)
    # without the asset, the stand-in: on shirley_spheres these pixels see
    # glass and sky alone at 2 bounces, so no parameter has a gradient
    scene, flagship = _flagship_scene(dev, fallback="flagship_standin")
    cfg = RenderConfig(width=32, height=16, samples_per_pixel=8, max_bounce=2,
                       camera=flagship.camera)
    camera = Camera.from_config(cfg.camera, cfg.aspect, device=dev)

    params = extract_params(scene)
    optimizer = Adam({k: 1e-3 for k in params})  # optax.adam(1e-3)
    step = make_train_step(cfg, optimizer, spb=2, method="bruteforce",
                           mesh=mesh)
    state = step.init(params)
    C = 4 * axis_size(mesh, RAY_AXIS)
    # the centre of the image (the top rows are sky: zero gradients)
    mid = (cfg.height // 2) * cfg.width + cfg.width // 2
    pixel_ids = shard_rays(mid + torch.arange(C, dtype=torch.int32), mesh)
    target = shard_rays(torch.full((C, 3), 0.5), mesh)
    state, loss = step(state, scene, camera, pixel_ids, target,
                       rng.key(0, device=dev))
    loss = float(loss)
    if not torch.isfinite(torch.tensor(loss)):
        raise AssertionError(f"non-finite loss {loss}")
    if not any(bool((state.params[k] != params[k]).any()) for k in params):
        raise AssertionError("the optimizer update changed no parameter")
    return loss


def dryrun_multichip(n_devices: int, device: str = "cuda") -> float:
    """One full sharded train step on ``n_devices`` ranks -> its loss.

    ``n_devices`` cards over NCCL, which must exist; with ``device="cpu"``,
    CPU ranks over gloo (JAX's virtual CPU mesh).
    """
    from sexy_raytracer_tpu_torch.parallel.mesh import spawn

    if torch.device(device).type == "cuda":
        have = torch.cuda.device_count()
        if have < n_devices:
            raise RuntimeError(f"need {n_devices} devices, have {have}")
        backend = "nccl"
    else:
        backend = "gloo"
    losses = spawn(_dryrun_rank, n_devices, backend, device, n_devices,
                   device)
    if len(set(losses)) != 1:
        raise AssertionError(f"the ranks' losses differ: {losses}")
    print(f"dryrun_multichip({n_devices}): ok, loss={losses[0]:.6f}",
          flush=True)
    return losses[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m sexy_raytracer_tpu_torch.graft_entry",
        description="entry()'s forward step, or `dryrun N`: one sharded "
                    "train step on N ranks")
    ap.add_argument("command", nargs="?", choices=["dryrun"])
    ap.add_argument("n_devices", nargs="?", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="the ranks' device: cuda (NCCL, the default) or "
                         "cpu (gloo)")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    if args.command == "dryrun":
        dryrun_multichip(args.n_devices, args.device)
    else:
        fn, example_args = entry(args.device)
        out = fn(*example_args)
        print("entry() ok:", tuple(out.shape), out.dtype)
    return 0


if __name__ == "__main__":
    sys.exit(main())
