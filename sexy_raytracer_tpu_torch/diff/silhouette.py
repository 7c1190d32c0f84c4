"""Boundary (silhouette) gradients for sphere positions (counterpart of
``sexy_raytracer_tpu/diff/silhouette.py``).

Hit topology is stop-gradient, so gradients reach a sphere's position only
through the shading of what its rays hit. A featureless sphere (the
flagship's iron and mirror spheres) shades the same wherever it sits, so
its position gets no restoring gradient from the interior. The missing
piece is the boundary term of the image loss: for a region whose
silhouette moves with the parameter c,

    d/dc sum (I - T)^2 = interior term + contour integral over the edge of
        [(L_in - T)^2 - (L_out - T)^2] (v . n) ds

with L_in / L_out the radiance just inside / outside the edge and v . n
the edge point's image-space normal velocity. A sphere's silhouette is an
analytic cone around the centre direction, so the edge is sampled without
an edge-detection pass (edge sampling, specialised to spheres).

``sphere_silhouette_loss`` is a surrogate: its value is 0, and its
gradient w.r.t. ``sph_c0`` / ``sph_radius`` is the contour estimate. The
radiances, residuals and arc weights are detached; only the analytic edge
position ``psi`` carries gradient. It adds to the interior train loss.

Approximations, as in the JAX package: the pinhole edge (the thin lens
blurs the true edge by about lens_radius / focus_dist radians); the edge
at the sphere's centre-time position; L_in / L_out from rays ``eps_px``
pixels off the edge.
"""

from __future__ import annotations

import math

import torch

from sexy_raytracer_tpu_torch.models.scene import SceneData
from sexy_raytracer_tpu_torch.render.integrator import trace_rays
from sexy_raytracer_tpu_torch.utils import rng
from sexy_raytracer_tpu_torch.utils.mathx import (
    clip,
    cross,
    dot,
    maximum,
    unit_vector,
)


def _focus_and_width(camera):
    """(unit w axis, focus distance along -w, viewport width)."""
    w_ax = cross(camera.u_axis, camera.v_axis)      # = unit(eye - look_at)
    h_len = torch.sqrt(torch.sum(camera.horizontal * camera.horizontal))
    fd = -torch.sum((camera.lower_left - camera.origin
                     + camera.horizontal / 2 + camera.vertical / 2) * w_ax)
    return w_ax, fd, h_len


def _edge_geometry(camera, center, radius, phis):
    """Analytic silhouette directions and viewport coords of one sphere
    (silhouette.py:56-98).

    Returns viewport coords ``s``, ``t`` [K] (differentiable in center and
    radius) and the detached unit directions ``v`` [K, 3], ``d_hat``,
    ``a1``, ``a2`` and the cone's ``sin_t``, ``cos_t``.
    """
    eye = camera.origin
    d = center - eye
    dist = torch.sqrt(torch.sum(d * d))
    d_hat = d / dist
    sin_t = clip(radius / dist, 1e-6, 1.0 - 1e-6)
    cos_t = torch.sqrt(1.0 - sin_t * sin_t)

    # orthonormal frame around d_hat (a fixed helper axis not parallel)
    helper = torch.where(torch.abs(d_hat.detach()[1]) < 0.9,
                         d_hat.new_tensor([0.0, 1.0, 0.0]),
                         d_hat.new_tensor([1.0, 0.0, 0.0]))
    a1 = unit_vector(cross(d_hat, helper))
    a2 = cross(d_hat, a1)

    # silhouette directions: the cone of half-angle theta around d_hat
    v = (cos_t * d_hat[None, :]
         + sin_t * (torch.cos(phis)[:, None] * a1[None, :]
                    + torch.sin(phis)[:, None] * a2[None, :]))   # [K, 3]

    # viewport coords of a direction from the eye (the pinhole inverse of
    # get_rays: dir(s, t) = (s - .5) h + (t - .5) v - fd w)
    u_ax, v_ax = camera.u_axis, camera.v_axis
    w_ax, fd, h_len = _focus_and_width(camera)
    v_len = torch.sqrt(torch.sum(camera.vertical * camera.vertical))
    depth = -dot(v, w_ax)                           # [K], > 0 if visible
    s = 0.5 + dot(v, u_ax) * fd / (depth * h_len)
    t = 0.5 + dot(v, v_ax) * fd / (depth * v_len)
    return (s, t, v.detach(), d_hat.detach(), a1.detach(), a2.detach(),
            sin_t.detach(), cos_t.detach())


def sphere_silhouette_loss(scene, camera, target_resolved, sphere_ids, key, *,
                           width: int, height: int, max_bounce: int,
                           background, n_edge: int = 256,
                           eps_px: float = 0.75, method: str = "auto",
                           fused=None):
    """Surrogate loss (silhouette.py:101-204): value 0; its gradient w.r.t.
    ``sph_c0`` / ``sph_radius`` is the silhouette contour term of the
    full-image resolved MSE ``mean((I - target)^2)``.

    ``target_resolved``: [H, W, 3] 0..1 (gamma-2 resolved), on or off the
    scene's device. ``sphere_ids``: the sphere indices to differentiate.
    ``key``: a ``[2]`` key; sphere ``n`` draws its edge phase from
    ``fold_in(key, n)``. The 2 ``n_edge`` in/out rays of each sphere are
    traced by ``trace_rays`` on the detached scene (``fused=None``: the
    fused integrator).
    """
    dev = scene.device
    target_resolved = torch.as_tensor(target_resolved, dtype=torch.float32,
                                      device=dev)
    background = torch.as_tensor(background, dtype=torch.float32, device=dev)
    flat = SceneData(*(a.detach() for a in scene))
    total = torch.zeros((), device=dev)
    # the angle one pixel subtends at the image centre (the in/out offset)
    _, fd, h_len = _focus_and_width(camera)
    px_angle = h_len / fd / width
    ray_ids = torch.arange(2 * n_edge, dtype=torch.int32, device=dev)

    for n, i in enumerate(sphere_ids):
        center = scene.sph_c0[i]
        radius = scene.sph_radius[i]
        kk = rng.fold_in(key, n)
        xi = rng.uniform(kk)
        phis = (2.0 * math.pi) * (
            (torch.arange(n_edge, dtype=torch.float32, device=dev) + xi)
            / n_edge)
        s, t, _, d_hat, a1, a2, sin_t, _ = _edge_geometry(
            camera, center, radius, phis)

        # edge pixel positions (float) and the integer lookup pixels
        x_px = s * (width - 1)
        y_px = height - t * (height - 1)
        xs, ys = x_px.detach(), y_px.detach()
        xi_i = clip(xs.to(torch.int32), 0, width - 1).long()
        yi_i = clip(ys.to(torch.int32), 0, height - 1).long()
        on_screen = (xs >= 0) & (xs <= width - 1) & (ys >= 0) \
            & (ys <= height - 1)
        tgt = target_resolved[yi_i, xi_i]                       # [K, 3]

        # in/out rays: the silhouette direction turned by ~eps_px pixels
        # toward / away from the centre direction
        delta = eps_px * px_angle.detach()
        sin_in = torch.sin(torch.arcsin(sin_t) - delta)
        sin_out = torch.sin(torch.arcsin(sin_t) + delta)
        cos_in = torch.sqrt(1.0 - sin_in * sin_in)
        cos_out = torch.sqrt(maximum(1.0 - sin_out * sin_out, 0.0))
        ring = (torch.cos(phis)[:, None] * a1[None, :]
                + torch.sin(phis)[:, None] * a2[None, :])
        v_in = cos_in * d_hat[None, :] + sin_in * ring
        v_out = cos_out * d_hat[None, :] + sin_out * ring

        org = camera.origin.detach().expand(2 * n_edge, 3).contiguous()
        dirs = torch.cat([v_in, v_out], dim=0).detach()
        times = torch.full((2 * n_edge,), 0.5, device=dev)
        keys = rng.ray_keys_2d(kk, ray_ids, torch.zeros_like(ray_ids))
        with torch.no_grad():
            rad = trace_rays(flat, org, dirs, times, keys, background,
                             max_bounce, method, fused=fused)   # [2K, 3]
        rad_res = clip(torch.sqrt(clip(rad, 1e-8, None)), 0.0, 0.999)
        L_in = rad_res[:n_edge]
        L_out = rad_res[n_edge:]

        # image-space outward normal and the differentiable displacement
        nx = xs - torch.mean(xs)
        ny = ys - torch.mean(ys)
        nlen = torch.sqrt(nx * nx + ny * ny) + 1e-8
        nx, ny = nx / nlen, ny / nlen
        psi = x_px * nx + y_px * ny                             # [K]

        # arc weight: perimeter in pixels / K; loss-jump density per px^2
        perim = 2.0 * math.pi * torch.mean(nlen)
        jump = torch.sum((L_in - tgt) ** 2 - (L_out - tgt) ** 2, dim=1)
        wk = (torch.where(on_screen, jump, 0.0)
              * perim / n_edge / (width * height * 3.0)).detach()
        total = total + torch.sum(wk * (psi - psi.detach()))
    return total
