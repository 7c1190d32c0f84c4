"""Counter-based random numbers of the plain reference: threefry2x32 with
20 rounds, the key and fold-in rules of ``jax.random`` under partitionable
threefry, as the program under test draws them.

A key is an int64 tensor ``[..., 2]`` of two 32-bit words; words stay in
int64 and are masked to 32 bits after every add. Frozen: the benchmark's
own copy, independent of the program.
"""

from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k0, k1, x0, x1):
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def key(seed: int, device=None):
    """The key of ``seed``: ``(0, seed mod 2**32)``."""
    return torch.tensor([0, int(seed) & MASK], dtype=torch.int64,
                        device=device)


def fold_in(keys, data):
    if not torch.is_tensor(data):
        data = torch.tensor(data, dtype=torch.int64, device=keys.device)
    data = data.to(torch.int64) & MASK
    y0, y1 = threefry2x32(keys[..., 0], keys[..., 1], 0, data)
    return torch.stack([y0, y1], dim=-1)


def bits(keys, n: int):
    """``n`` 32-bit words per key: ``[..., 2]`` -> ``[..., n]``."""
    i = torch.arange(n, dtype=torch.int64, device=keys.device)
    y0, y1 = threefry2x32(keys[..., 0:1], keys[..., 1:2], 0, i)
    return y0 ^ y1


def uniforms(keys, n: int):
    """``[R]`` keys -> ``[R, n]`` U[0, 1) float32 draws of 24 bits."""
    return (bits(keys, n) >> 8).to(torch.float32) * (1.0 / (1 << 24))


def ray_keys(base_key, pid, sid):
    """One key per (pixel, sample) pair: two fold-ins."""
    return fold_in(fold_in(base_key, pid), sid)
