"""Counter-based random numbers, bit-exact with ``jax.random`` (threefry2x32).

Counterpart of ``sexy_raytracer_tpu/utils/rng.py``. The JAX package keys
every ray by its (pixel, sample) pair through ``jax.random.fold_in`` and
draws its per-bounce uniforms with ``jax.random.bits``. This module
computes the same 32-bit words, so the port traces exactly the rays the
JAX package traces and the two can be compared sample by sample.

It follows ``jax._src.prng`` with ``jax_threefry_partitionable=True`` (the
default since jax 0.5):

* ``key(seed)`` is the pair ``(0, seed & 0xFFFFFFFF)``: with 64-bit
  types off (jax's default), the seed is cast to 32 bits, so a negative
  or 64-bit seed keeps only its low word;
* ``fold_in(k, d)`` is ``threefry2x32(k, (0, d))``;
* ``bits(k, (n,))`` is ``x0 ^ x1`` of ``threefry2x32(k, (0, i))``, i < n;
* ``split(k, n)[i]`` is ``fold_in(k, i)`` (partitionable threefry);
* ``uniform(k, shape)`` takes 23 bits of ``bits(k, shape)`` as a float's
  mantissa, as ``jax.random.uniform`` does; the per-ray draws of the
  integrator take 24 (``uniforms_from_bits``).

A key is an int64 tensor ``[..., 2]`` holding two uint32 words. Words are
kept in int64 and masked to 32 bits after every add, since torch's uint32
arithmetic is incomplete.
"""

from __future__ import annotations

import math

import torch

from sexy_raytracer_tpu_torch.utils.mathx import PI

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 hash with 20 rounds; all arguments broadcast."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def key(seed: int, device=None):
    """``jax.random.key(seed)`` as a ``[2]`` key tensor: ``(0, seed mod
    2^32)``, as jax gives it with 64-bit types off."""
    return torch.tensor([0, int(seed) & _MASK], dtype=torch.int64,
                        device=device)


def fold_in(keys, data):
    """``jax.random.fold_in`` over a batch: keys ``[..., 2]``, data ints."""
    if not torch.is_tensor(data):
        data = torch.tensor(data, dtype=torch.int64, device=keys.device)
    data = data.to(torch.int64) & _MASK
    y0, y1 = threefry2x32(keys[..., 0], keys[..., 1], 0, data)
    return torch.stack([y0, y1], dim=-1)


def bits(keys, n: int):
    """``jax.random.bits(k, (n,))`` per key: ``[..., 2]`` -> ``[..., n]``
    uint32 words in int64."""
    i = torch.arange(n, dtype=torch.int64, device=keys.device)
    y0, y1 = threefry2x32(keys[..., 0:1], keys[..., 1:2], 0, i)
    return y0 ^ y1


def split(keys, n: int = 2):
    """``jax.random.split(k, n)`` per key: ``[..., 2]`` -> ``[..., n, 2]``.

    Under partitionable threefry subkey ``i`` is ``fold_in(k, i)``.
    """
    i = torch.arange(n, dtype=torch.int64, device=keys.device)
    return fold_in(keys[..., None, :], i)


def uniform(keys, shape=(), lo=0.0, hi=1.0):
    """``jax.random.uniform(k, shape, minval=lo, maxval=hi)`` (float32)
    per key: ``[..., 2]`` -> ``[..., *shape]``, bit for bit.

    The top 23 bits of each word fill the mantissa of a float in [1, 2)
    (exponent bits 0x3F800000), less one; then ``u * (hi - lo) + lo``,
    floored at ``lo``. XLA fuses that multiply-add into one rounding;
    here the product is exact in float64 and the sum is rounded from
    there (``lo = 0, hi = 1`` is exact either way).
    """
    shape = tuple(shape)
    words = bits(keys, math.prod(shape))
    u = ((words >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    u = u.reshape(tuple(keys.shape[:-1]) + shape)
    lo = torch.tensor(lo, dtype=torch.float32, device=keys.device)
    hi = torch.tensor(hi, dtype=torch.float32, device=keys.device)
    u = (u.double() * (hi - lo).double() + lo.double()).float()
    return torch.maximum(lo, u)


def ray_keys_2d(base_key, pid, sid):
    """One key per (pixel, sample) pair via a two-level fold-in."""
    return fold_in(fold_in(base_key, pid), sid)


def uniforms_from_bits(words):
    """uint32 words -> U[0,1) float32 with 24-bit resolution."""
    return (words >> 8).to(torch.float32) * (1.0 / (1 << 24))


def per_ray_uniform_block(keys, n: int):
    """[R] keys -> [R, n] iid U[0,1) floats (24-bit resolution)."""
    return uniforms_from_bits(bits(keys, n))


def unit_vector_from_uniforms(u, v):
    """U[0,1)^2 -> uniform direction on S^2."""
    z = 1.0 - 2.0 * u
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = (2.0 * PI) * v
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def in_unit_sphere_from_uniforms(u, v, w):
    """U[0,1)^3 -> uniform point in the unit ball."""
    return unit_vector_from_uniforms(u, v) * (w ** (1.0 / 3.0))[..., None]


def in_unit_disk_from_uniforms(u, v):
    """U[0,1)^2 -> uniform point in the unit disk."""
    r = torch.sqrt(u)
    theta = (2.0 * PI) * v
    return torch.stack([r * torch.cos(theta), r * torch.sin(theta)], dim=-1)
