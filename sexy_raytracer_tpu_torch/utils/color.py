"""Radiance accumulation -> displayable image (counterpart of ``utils/color.py``).

Reproduces the reference's output transform (reference color.h:25-41):
divide by samples-per-pixel, gamma-2 encode via sqrt, scale by
``256 * clamp(c, 0, 0.999)``, quantize to uint8.
"""

from __future__ import annotations

import numpy as np


def resolve(accum_rgb, num_samples):
    """Sum-of-samples radiance ``[..., 3]`` float32 -> float image in [0, 1)."""
    scale = np.float32(1.0 / num_samples)
    c = np.sqrt(np.clip(np.asarray(accum_rgb, np.float32) * scale, 0.0, None))
    return np.clip(c, 0.0, 0.999)


def to_uint8(resolved_rgb):
    """Quantize a resolved [0,1) image exactly like reference color.h:37-39."""
    arr = np.asarray(resolved_rgb)
    return (256.0 * np.clip(arr, 0.0, 0.999)).astype(np.uint8)
