"""Rank bodies for tests/test_torch_parallel.py and
tests/test_torch_distributed.py, run by ``parallel.spawn`` on gloo ranks.

The scene and config are tests/test_parallel.py's (32x24, 8 spp, 3
bounces, 256 paths a chunk, spb 4). This module imports no JAX, so a
spawned rank starts with torch and the port alone.
"""

import numpy as np
import torch
import torch.distributed as dist

from sexy_raytracer_tpu_torch.diff.inverse import (
    Adam,
    inverse_render,
    make_train_step,
)
from sexy_raytracer_tpu_torch.diff.params import extract_params
from sexy_raytracer_tpu_torch.models.scene import SceneBuilder
from sexy_raytracer_tpu_torch.parallel.mesh import make_mesh, shard_rays
from sexy_raytracer_tpu_torch.parallel.render import render_sharded
from sexy_raytracer_tpu_torch.render.camera import Camera
from sexy_raytracer_tpu_torch.render.renderer import render
from sexy_raytracer_tpu_torch.utils import rng
from sexy_raytracer_tpu_torch.utils.config import CameraConfig, RenderConfig

# tests/test_parallel.py:72's batch: 64 pixels from row 8, spb 2, a 0.4
# target, Adam at 1e-2, keys 0, 1, 2
PIX = np.arange(32 * 8, 32 * 8 + 64, dtype=np.int32)
TGT = np.full((64, 3), 0.4, np.float32)
TRAIN_SPB, TRAIN_LR, TRAIN_STEPS = 2, 1e-2, 3
# the inverse loop of tests/test_torch_distributed.py, on cfg(**INV_CFG):
# two 128-pixel tiles a step (255 pixels is rounded down to 254 on two ray
# shards); 2 bounces, which JAX's step compiles in about half the time of 3
INV = dict(n_steps=3, spb=2, method="bruteforce", progress=False)
INV_CFG = dict(max_bounce=2)
INV_PIXELS = (256, 255)


def scene():
    """tests/test_parallel.py:21-30's scene."""
    b = SceneBuilder()
    checker = b.add_checker_texture((0.2, 0.3, 0.1), (0.9, 0.9, 0.9))
    b.add_sphere((0, -1000, 0), 1000.0, b.add_pbr_material(albedo_tex=checker))
    b.add_sphere((-2, 1, 0), 1.0, b.add_light_material(color=(10, 9, 7)))
    b.add_sphere((2, 1, 0), 1.0, b.add_metal_material((0.7, 0.6, 0.5), 0.0))
    mat = b.add_pbr_material(base_color=(0.9, 0.3, 0.3, 1.0))
    b.add_mesh([[-1, 0, -2], [1, 0, -2], [0, 2, -2]], None, [[0, 1, 2]], mat)
    return b.build(build_bvh=False, device="cpu")


def cfg(**kw):
    """tests/test_parallel.py:33-41's config."""
    base = dict(
        width=32, height=24, samples_per_pixel=8, max_bounce=3,
        rays_per_chunk=256, samples_per_batch=4,
        camera=CameraConfig(eye=(0, 2, 6), look_at=(0, 1, 0),
                            vfov_degrees=45.0, aperture=0.0, focus_dist=6.0),
    )
    base.update(kw)
    return RenderConfig(**base)


def inverse_target():
    """A flat 0.4 target image for the inverse loop."""
    return np.full((24, 32, 3), 0.4, np.float32)


def train_steps(mesh=None, pixel_ids=PIX, target=TGT):
    """Three steps of test_parallel.py:72's train step (on ``mesh``, with
    this rank's slice of the batch) -> (losses, params on the CPU)."""
    sc = scene()
    c = cfg()
    params = extract_params(sc)
    step = make_train_step(c, Adam({k: TRAIN_LR for k in params}),
                           spb=TRAIN_SPB, method="bruteforce", mesh=mesh)
    state = step.init(params)
    cam = Camera.from_config(c.camera, c.aspect, device="cpu")
    if mesh is not None:
        pixel_ids, target = shard_rays(pixel_ids, mesh), \
            shard_rays(target, mesh)
    else:
        pixel_ids, target = torch.as_tensor(pixel_ids), \
            torch.as_tensor(target)
    losses = []
    for i in range(TRAIN_STEPS):
        state, loss = step(state, sc, cam, pixel_ids, target, rng.key(i))
        losses.append(float(loss))
    return losses, {k: v.clone() for k, v in state.params.items()}


def four_ranks():
    """On 4 ranks: the sharded frames on (4, 1) and (2, 2) meshes (and at
    10 spp on (2, 2)), and three train steps on each mesh."""
    out = {}
    for shape in ((4, 1), (2, 2)):
        mesh = make_mesh(*shape, device_type="cpu")
        out[shape] = render_sharded(scene(), cfg(), mesh, method="bruteforce")
        out[shape + ("train",)] = train_steps(mesh)
    out["spp10"] = render_sharded(
        scene(), cfg(samples_per_pixel=10), mesh, method="bruteforce")
    return out


def one_rank():
    """On a (1, 1) mesh and with no mesh, in the same process: the frame
    and three train steps each."""
    mesh = make_mesh(1, 1, device_type="cpu")
    return dict(
        frame=render_sharded(scene(), cfg(), mesh, method="bruteforce"),
        frame_plain=render(scene(), cfg(), method="bruteforce"),
        train=train_steps(mesh), train_plain=train_steps(None))


def two_ranks_inverse():
    """On a (2, 1) mesh: three steps of ``inverse_render`` at each of
    ``INV_PIXELS`` pixels a step -> ({pixels: (losses, the returned
    scene's trained fields)}, the meshes of the wrong size refused)."""
    refused = []
    for shape in (dict(n_rays=2, n_samples=2), dict(n_rays=3),
                  dict(n_samples=3)):
        try:
            make_mesh(**shape, device_type="cpu")
        except ValueError:
            refused.append(shape)
    mesh = make_mesh(2, 1, device_type="cpu")
    runs = {}
    for n in INV_PIXELS:
        opt, losses = inverse_render(scene(), inverse_target(),
                                     cfg(**INV_CFG), mesh=mesh,
                                     pixels_per_step=n, **INV)
        runs[n] = losses, {k: v.clone()
                           for k, v in extract_params(opt).items()}
    return runs, refused


def rank_1_fails():
    """Rank 1 raises while rank 0 waits for it in a collective."""
    if dist.get_rank() == 1:
        raise RuntimeError("rank 1 fails")
    dist.all_reduce(torch.ones(1))
