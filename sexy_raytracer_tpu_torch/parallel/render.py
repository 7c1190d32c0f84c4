"""Data-parallel rendering over the ("rays", "samples") mesh (counterpart
of ``sexy_raytracer_tpu/parallel/render.py``).

Each chunk's pixel ids are sharded over the ``"rays"`` axis; when the mesh
has a ``"samples"`` axis, each sample shard traces its own ``spb`` sample
ids and the partial radiance sums are added over that axis with an
all-reduce. The RNG is keyed by (pixel, sample), never by rank, so the
image is the single-device image whatever the mesh.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from sexy_raytracer_tpu_torch.parallel.mesh import (
    RAY_AXIS,
    SAMPLE_AXIS,
    axis_size,
    mesh_device,
    replicate_scene,
    shard_rays,
)
from sexy_raytracer_tpu_torch.render.camera import Camera
from sexy_raytracer_tpu_torch.render.integrator import scene_no_emissive_tris
from sexy_raytracer_tpu_torch.render.renderer import (
    render_pixels,
    tile_pixel_order,
)
from sexy_raytracer_tpu_torch.utils import color as colorlib
from sexy_raytracer_tpu_torch.utils import rng
from sexy_raytracer_tpu_torch.utils.config import RenderConfig


def make_sharded_chunk_fn(mesh, *, width, height, spb, spp_total,
                          max_bounce, method="auto", last_bounce_vis=False):
    """The chunk renderer of one rank -> ``f(scene, camera, pixel_ids,
    sample_start, base_key, background) -> [C_local, 3]`` radiance sums of
    ``spb * n_sample_shards`` samples for this rank's pixel ids (its
    ``shard_rays`` slice of the chunk): ``spb`` samples from ``sample_start
    + sample_shard * spb``, summed over the sample axis. Every rank of the
    mesh must call it with the same ``sample_start``.
    """
    sample_offset = mesh.get_local_rank(SAMPLE_AXIS) * spb
    samples_group = mesh.get_group(SAMPLE_AXIS)

    def fn(scene, camera, pixel_ids, sample_start, base_key, background):
        partial = render_pixels(
            scene, camera, pixel_ids, sample_start + sample_offset, base_key,
            background, width=width, height=height, spb=spb,
            spp_total=spp_total, max_bounce=max_bounce, method=method,
            last_bounce_vis=last_bounce_vis)
        dist.all_reduce(partial, group=samples_group)
        return partial

    return fn


def render_sharded(scene, config: RenderConfig, mesh,
                   camera: Camera | None = None, method: str = "auto",
                   progress: bool = False) -> np.ndarray:
    """Full data-parallel render -> resolved float image ``[H, W, 3]``,
    the same on every rank (the ray shards are gathered after each chunk).

    Every rank calls it with the same scene and config. A chunk holds
    ``rays_per_chunk // spb`` pixels rounded down to a multiple of the ray
    shards, in tile order, the last one padded with pixel 0; rounds of
    ``spb * n_sample_shards`` samples run until ``spp`` is reached, and the
    samples of the last round past ``spp`` are masked out by
    ``render_pixels``, so the sum is the spp-sample estimator for any spp.
    """
    W, H = config.width, config.height
    spp = config.samples_per_pixel
    n_ray_shards = axis_size(mesh, RAY_AXIS)
    n_sample_shards = axis_size(mesh, SAMPLE_AXIS)
    spb = min(config.samples_per_batch, max(1, spp // n_sample_shards))
    spp_per_round = spb * n_sample_shards
    dev = mesh_device(mesh)
    scene = replicate_scene(scene, mesh)
    camera = Camera.from_config(config.camera, config.aspect, device=dev) \
        if camera is None else camera.to(dev)
    base_key = rng.key(config.seed, device=dev)
    background = torch.tensor(config.background, dtype=torch.float32,
                              device=dev)

    P = W * H
    chunk = max(n_ray_shards,
                min(config.rays_per_chunk // spb, P)
                // n_ray_shards * n_ray_shards)
    fn = make_sharded_chunk_fn(
        mesh, width=W, height=H, spb=spb, spp_total=spp,
        max_bounce=config.max_bounce, method=method,
        last_bounce_vis=scene_no_emissive_tris(scene))
    rays_group = mesh.get_group(RAY_AXIS)
    show = progress and dist.get_rank() == 0

    order = tile_pixel_order(W, H)
    accum = np.zeros((P, 3), np.float32)
    for start in range(0, P, chunk):
        ids = order[start:min(start + chunk, P)]
        n_valid = ids.shape[0]
        if n_valid < chunk:
            ids = np.pad(ids, (0, chunk - n_valid))
        ids_dev = shard_rays(ids, mesh)
        chunk_accum = torch.zeros((ids_dev.shape[0], 3), device=dev)
        s0 = 0
        while s0 < spp:
            chunk_accum = chunk_accum + fn(scene, camera, ids_dev, s0,
                                           base_key, background)
            s0 += spp_per_round
        parts = [torch.empty_like(chunk_accum) for _ in range(n_ray_shards)]
        dist.all_gather(parts, chunk_accum, group=rays_group)
        accum[ids[:n_valid]] = torch.cat(parts).cpu().numpy()[:n_valid]
        if show:
            print(f"\rpixels {min(start + chunk, P)}/{P}", end="", flush=True)
    if show:
        print()
    return colorlib.resolve(accum.reshape(H, W, 3), spp)
