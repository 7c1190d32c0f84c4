"""Render driver: pixel grid -> chunked wavefronts -> accumulated image
(counterpart of ``render/renderer.py``).

Pixels are traced in fixed-size chunks of ``rays_per_chunk`` paths
(``samples_per_batch`` samples per pixel); each chunk's radiance sums stay
on the device until the chunk is done and are then downloaded. That
download, the chunk's two uploads from pageable memory and the frame's
few are where ``render_accumulate`` may block the host on the device (its
``wait`` sites, ``utils/profiling.py``). (pixel, sample) pairs key the
counter-based RNG, so the image is independent of chunking.

Pixel-to-viewport mapping replicates main.cpp:209-211:
    u = (x + rand) / (W-1),  v = ((H - y) + rand) / (H-1)
(with the reference's vertical flip, so row 0 is the top of the image).
"""

from __future__ import annotations

import os
import time
import zlib

import numpy as np
import torch

from sexy_raytracer_tpu_torch.render.camera import Camera
from sexy_raytracer_tpu_torch.render.integrator import (
    scene_no_emissive_tris,
    trace_rays,
)
from sexy_raytracer_tpu_torch.utils import color as colorlib
from sexy_raytracer_tpu_torch.utils import profiling, rng
from sexy_raytracer_tpu_torch.utils.config import RenderConfig
from sexy_raytracer_tpu_torch.utils.profiling import Meter


def render_pixels(scene, camera: Camera, pixel_ids, sample_start: int,
                  base_key, background, *, width: int, height: int,
                  spb: int, spp_total: int, max_bounce: int,
                  method: str = "auto", fused=None,
                  last_bounce_vis: bool = False):
    """Trace ``spb`` samples per pixel id -> radiance sums ``[C, 3]``.

    ``pixel_ids`` [C] int32 on the scene's device; samples
    ``sample_start .. sample_start + spb - 1``, of which those at or past
    ``spp_total`` are dropped (the overshoot mask, renderer.py:71-76).
    ``fused=False`` traces with the reference integrator
    (``integrator.trace_rays``).
    """
    C = pixel_ids.shape[0]
    dev = pixel_ids.device
    pid = pixel_ids.repeat_interleave(spb)
    sid = sample_start + torch.arange(spb, dtype=torch.int32,
                                      device=dev).repeat(C)
    with profiling.span("rng", device=dev.type == "cuda"):
        keys, ucam = rng.ray_keys_and_camera(base_key, pid, sid)

    x = (pid % width).to(torch.float32)
    y = (pid // width).to(torch.float32)
    u = (x + ucam[:, 0]) / (width - 1)
    v = ((height - y) + ucam[:, 1]) / (height - 1)

    org, direction, ray_time = camera.get_rays(u, v, ucam[:, 2:5])
    radiance = trace_rays(scene, org, direction, ray_time, keys, background,
                          max_bounce, method, fused=fused,
                          last_bounce_vis=last_bounce_vis)
    radiance = torch.where((sid < spp_total)[:, None], radiance, 0.0)
    return radiance.reshape(C, spb, 3).sum(dim=1)


def tile_pixel_order(width: int, height: int, tile_w: int = 32,
                     tile_h: int = 16) -> np.ndarray:
    """All pixel ids in tile-major order -> [W*H] int32.

    Consecutive pixels form 2D screen tiles, so the fixed-size ray blocks
    of the find kernel see spatially coherent rays and cull well.
    """
    ids = []
    for y0 in range(0, height, tile_h):
        for x0 in range(0, width, tile_w):
            yy = np.arange(y0, min(y0 + tile_h, height))
            xx = np.arange(x0, min(x0 + tile_w, width))
            ids.append((yy[:, None] * width + xx[None, :]).ravel())
    return np.concatenate(ids).astype(np.int32)


def render_accumulate(scene, config: RenderConfig, camera: Camera | None = None,
                      method: str = "auto", progress: bool = False,
                      checkpoint: str | None = None) -> np.ndarray:
    """Raw accumulated radiance (sum over samples) ``[H, W, 3]`` float32.

    Traces on the scene's device. ``checkpoint``: optional npz path for
    resumable renders, with the JAX package's keys: after every
    (chunk, sample-batch) unit the accumulator and progress counter are
    saved; a rerun with the same config resumes, and the counter-based RNG
    makes the result identical to an uninterrupted run. ``progress``
    prints a pixel counter and, at the end, the chunks' ``Meter`` report
    (renderer.py:153-247).

    While a profiler records, the call is the span ``render``, each chunk
    ``render.chunk`` and each sample batch ``render.batch``; every
    statement that may block the host on the device (an upload from
    pageable memory, a read back) is a ``wait`` site.
    """
    with profiling.span("render"):
        return _accumulate(scene, config, camera, method, progress,
                           checkpoint)


def _accumulate(scene, config, camera, method, progress, checkpoint):
    W, H = config.width, config.height
    spp = config.samples_per_pixel
    spb = min(config.samples_per_batch, spp)
    dev = scene.device
    if camera is None:
        with profiling.wait("camera"):
            camera = Camera.from_config(config.camera, config.aspect,
                                        device=dev)
    with profiling.wait("key"):
        base_key = rng.key(config.seed, device=dev)
    with profiling.wait("background"):
        background = torch.tensor(config.background, dtype=torch.float32,
                                  device=dev)

    P = W * H
    chunk = max(1, min(config.rays_per_chunk // spb, P))
    vis_ok = scene_no_emissive_tris(scene)
    accum = np.zeros((P, 3), np.float32)
    units_done = 0

    order = tile_pixel_order(W, H)
    # units_done attributes completed chunks to pixel sets via this order;
    # a checkpoint made under another order restarts instead of resuming
    order_hash = np.uint32(zlib.crc32(order.tobytes()))

    if checkpoint is not None and os.path.exists(checkpoint):
        saved = np.load(checkpoint)
        if (
            saved["shape"].tolist() == [H, W]
            and int(saved["spp"]) == spp
            and int(saved["seed"]) == config.seed
            and int(saved["chunk"]) == chunk
            and int(saved["spb"]) == spb
            and "order_hash" in saved
            and np.uint32(saved["order_hash"]) == order_hash
        ):
            accum = saved["accum"]
            units_done = int(saved["units_done"])
            if progress:
                print(f"resuming from {checkpoint} (unit {units_done})")
        elif progress:
            print(f"checkpoint {checkpoint} incompatible; restarting")

    meter = Meter("render_accumulate")
    unit = 0
    for start in range(0, P, chunk):
        with profiling.span("render.chunk"):
            ids = order[start:min(start + chunk, P)]
            n_valid = ids.shape[0]
            if n_valid < chunk:
                ids = np.pad(ids, (0, chunk - n_valid))
            ids_dev = None
            chunk_accum = None
            for s0 in range(0, spp, spb):
                if unit < units_done:
                    unit += 1
                    continue
                if ids_dev is None:
                    chunk_t0 = time.perf_counter()
                    chunk_paths = 0
                    with profiling.wait("ids"):
                        ids_dev = torch.from_numpy(ids).to(dev)
                    rows = accum[ids]
                    with profiling.wait("accum"):
                        chunk_accum = torch.from_numpy(rows).to(dev)
                n_s = min(spb, spp - s0)  # final batch may be partial
                with profiling.span("render.batch"):
                    chunk_accum = chunk_accum + render_pixels(
                        scene, camera, ids_dev, s0, base_key, background,
                        width=W, height=H, spb=n_s, spp_total=spp,
                        max_bounce=config.max_bounce, method=method,
                        last_bounce_vis=vis_ok,
                    )
                chunk_paths += n_valid * n_s
                unit += 1
            if ids_dev is not None:
                # the download waits for the chunk: the sync point
                with profiling.wait("download"):
                    rows = chunk_accum.cpu()
                accum[ids[:n_valid]] = rows.numpy()[:n_valid]
                meter.seconds += time.perf_counter() - chunk_t0
                meter.paths += chunk_paths
                meter.rays += chunk_paths * config.max_bounce
                meter.steps += 1
                units_done = unit
                if checkpoint is not None:
                    np.savez(
                        checkpoint, accum=accum, units_done=units_done,
                        shape=np.asarray([H, W]), spp=spp, seed=config.seed,
                        chunk=chunk, spb=spb, order_hash=order_hash,
                    )
        if progress:
            print(f"\rpixels {min(start + chunk, P)}/{P}", end="", flush=True)
    if progress:
        print()
        print(meter.report(), flush=True)
    return accum.reshape(H, W, 3)


def render(scene, config: RenderConfig, camera: Camera | None = None,
           method: str = "auto", progress: bool = False,
           checkpoint: str | None = None) -> np.ndarray:
    """Full render -> resolved (gamma-encoded) float image ``[H, W, 3]``."""
    accum = render_accumulate(scene, config, camera, method, progress,
                              checkpoint)
    return colorlib.resolve(accum, config.samples_per_pixel)


def render_image(scene, config: RenderConfig, camera: Camera | None = None,
                 method: str = "auto", progress: bool = False,
                 checkpoint: str | None = None) -> np.ndarray:
    """Full render -> uint8 RGB image ``[H, W, 3]`` (gamma-2, color.h)."""
    return colorlib.to_uint8(
        render(scene, config, camera, method, progress, checkpoint)
    )
