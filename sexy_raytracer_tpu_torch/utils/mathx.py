"""Constants and vector helpers (counterpart of ``utils/mathx.py``).

Vectors are ``[..., 3]`` tensors with the component on the last axis.
Dot products are written out component by component, left to right, so
that they round like the JAX package's fused kernels and the CUDA kernels.
"""

from __future__ import annotations

import numpy as np
import torch

# reference globals.h:14 — epsilon = FLT_EPSILON
EPSILON = float(np.finfo(np.float32).eps)
PI = 3.1415926535897932385


def deg2rad(degrees):
    # reference globals.h:26
    return degrees * PI / 180.0


def dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def maximum(x, c):
    """``jnp.maximum(x, c)`` for a constant ``c``: a tie splits the gradient
    half and half, as in JAX (``torch.clamp`` gives it all to ``x``)."""
    return torch.maximum(x, x.new_tensor(c))


def minimum(x, c):
    """``jnp.minimum(x, c)``, with JAX's tie rule (see ``maximum``)."""
    return torch.minimum(x, x.new_tensor(c))


def clip(x, lo, hi):
    """``jnp.clip(x, lo, hi)``; either bound may be None."""
    if lo is not None:
        x = maximum(x, lo)
    return x if hi is None else minimum(x, hi)


def safe_sqrt(x, eps=1e-24):
    """``sqrt(max(x, eps))`` (mathx.safe_sqrt)."""
    return torch.sqrt(maximum(x, eps))


def unit_vector(v):
    """Normalize, returning ``v`` unchanged for zero-length inputs."""
    len2 = dot(v, v)[..., None]
    return torch.where(len2 == 0.0, v, v / safe_sqrt(len2))


def near_zero(v):
    # reference vec3.h:49
    return torch.all(torch.abs(v) < 1e-8, dim=-1)


def reflect(v, n):
    # reference vec3.h:76
    return v - 2.0 * dot(v, n)[..., None] * n


def refract(uv, n, eta_i_over_eta_t):
    # reference vec3.h:80-86 (safe_sqrt: finite gradient at the total
    # internal reflection boundary)
    cos_theta = minimum(dot(n, -uv), 1.0)
    r_out_perp = eta_i_over_eta_t[..., None] * (uv + cos_theta[..., None] * n)
    r_out_parallel = (
        -safe_sqrt(torch.abs(1.0 - dot(r_out_perp, r_out_perp)))[..., None]
        * n
    )
    return r_out_perp + r_out_parallel


def normal_int_to_float(n):
    """Map a 0-255-scale normal-map texel to [-1, 1] (reference vec3.h:103)."""
    return (n - 128.0) / 128.0


def cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)
