"""Run-time configuration (counterpart of ``sexy_raytracer_tpu/utils/config.py``).

Same fields and defaults as the JAX package, so that a config means the same
render in both.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    """Camera parameters (reference camera.h:10-38, defaults main.cpp:163-172)."""

    eye: Tuple[float, float, float] = (0.0, 3.0, 5.0)
    look_at: Tuple[float, float, float] = (0.0, 2.5, 0.0)
    up: Tuple[float, float, float] = (0.0, 1.0, 0.0)
    vfov_degrees: float = 70.0
    aperture: float = 0.1
    focus_dist: float = 10.0
    time0: float = 0.0
    time1: float = 1.0


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """One render job (reference main.cpp:156-242 flagship defaults)."""

    width: int = 1280
    height: int = 720
    samples_per_pixel: int = 5000
    max_bounce: int = 4
    background: Tuple[float, float, float] = (0.53, 0.81, 0.92)  # main.cpp:170
    camera: CameraConfig = dataclasses.field(default_factory=CameraConfig)
    seed: int = 0
    # Paths traced per chunk (chunk_pixels * samples_per_batch); one chunk
    # is one wavefront through the per-bounce kernels.
    rays_per_chunk: int = 1 << 19
    # Samples traced per pixel in one wavefront.
    samples_per_batch: int = 8

    @property
    def aspect(self) -> float:
        return self.width / self.height
