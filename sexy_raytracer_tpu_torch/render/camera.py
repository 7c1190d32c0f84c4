"""Thin-lens camera with shutter-time sampling (counterpart of
``render/camera.py:23-138``; reference camera.h:10-50).

The camera is a NamedTuple of float32 tensors. ``from_params`` derives the
basis with the same float32 operations as the JAX ``from_params``, so a
camera made on the card and one made by the JAX package generate the same
rays, and gradients reach every tensor it was given (``create`` and
``from_config`` go through it).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sexy_raytracer_tpu_torch.utils import rng
from sexy_raytracer_tpu_torch.utils.config import CameraConfig
from sexy_raytracer_tpu_torch.utils.mathx import cross, deg2rad, unit_vector


class Camera(NamedTuple):
    origin: torch.Tensor       # [3]
    lower_left: torch.Tensor   # [3]
    horizontal: torch.Tensor   # [3]
    vertical: torch.Tensor     # [3]
    u_axis: torch.Tensor       # [3] lens-offset basis (camera.h:25 'hor')
    v_axis: torch.Tensor       # [3] lens-offset basis (camera.h:26 'vert')
    lens_radius: torch.Tensor  # scalar
    time0: torch.Tensor        # scalar
    time1: torch.Tensor        # scalar

    @staticmethod
    def from_params(eye, look_at, up, vfov_degrees, aspect, aperture,
                    focus_dist, time0=0.0, time1=1.0,
                    device=None) -> "Camera":
        """Differentiable camera derivation (reference camera.h:19-37;
        ``render/camera.py:35-78``).

        Every argument may be a tensor that requires grad: the look-at
        basis, the viewport and the lens radius are torch expressions of
        them, so autograd reaches eye, look_at, up, vfov, aspect, aperture,
        focus_dist and the shutter times. A float32 tensor already on
        ``device`` (or any device when ``device`` is None) is used as it
        is, not copied.
        """
        def f32(x):
            return torch.as_tensor(x, dtype=torch.float32, device=device)

        eye, look_at, up = f32(eye), f32(look_at), f32(up)
        theta = deg2rad(f32(vfov_degrees))
        vp_height = 2.0 * torch.tan(theta / 2.0)
        vp_width = aspect * vp_height

        w = unit_vector(eye - look_at)
        u = unit_vector(cross(up, w))
        v = unit_vector(cross(w, u))

        focus_dist = f32(focus_dist)
        horizontal = focus_dist * vp_width * u
        vertical = focus_dist * vp_height * v
        lower_left = eye - horizontal / 2.0 - vertical / 2.0 - focus_dist * w
        return Camera(
            origin=eye,
            lower_left=lower_left,
            horizontal=horizontal,
            vertical=vertical,
            u_axis=u,
            v_axis=v,
            lens_radius=f32(aperture) / 2.0,
            time0=f32(time0),
            time1=f32(time1),
        )

    @staticmethod
    def create(eye, look_at, up, vfov_degrees, aspect, aperture, focus_dist,
               time0=0.0, time1=1.0, device=None) -> "Camera":
        """Convenience over :meth:`from_params` (the same math)."""
        return Camera.from_params(eye, look_at, up, vfov_degrees, aspect,
                                  aperture, focus_dist, time0, time1,
                                  device=device)

    @staticmethod
    def from_config(cfg: CameraConfig, aspect: float, device=None) -> "Camera":
        return Camera.create(
            cfg.eye, cfg.look_at, cfg.up, cfg.vfov_degrees, aspect,
            cfg.aperture, cfg.focus_dist, cfg.time0, cfg.time1, device=device,
        )

    def to(self, device) -> "Camera":
        return Camera(*(a.to(device) for a in self))

    def get_rays(self, s, t, uniforms):
        """Rays for viewport coords ``s``/``t`` [R] (camera.h:40-50).

        ``uniforms``: [R, 3] U[0,1) draws — (disk_u, disk_v, time).
        Directions are deliberately left unnormalized, like the reference.
        Returns ``(org [R,3], dir [R,3], time [R])``.
        """
        rd = self.lens_radius * rng.in_unit_disk_from_uniforms(
            uniforms[..., 0], uniforms[..., 1]
        )
        offset = rd[..., 0:1] * self.u_axis + rd[..., 1:2] * self.v_axis
        org = self.origin + offset
        direction = (
            self.lower_left
            + s[..., None] * self.horizontal
            + t[..., None] * self.vertical
            - self.origin
            - offset
        )
        time = self.time0 + (self.time1 - self.time0) * uniforms[..., 2]
        return org, direction, time
