"""Brute-force closest-triangle search over a plane/edge weight stack
(counterpart of ``sexy_raytracer_tpu/ops/pallas_intersect.py``), reached
with ``find_hit(method="pallas_mxu")``: the JAX package's round-1
comparison path, kept for comparison.

The triangle test is phrased as two products with a ``[4, 4 Tpad]`` weight
stack ``W`` of the precomputed plane/edge vectors:

    org4 = [ox, oy, oz, 1],  dir4 = [dx, dy, dz, 0]
    a = org4 . W   -> per triangle [org.n + d | org.q_i - c_i]   (i = 0..2)
    b = dir4 . W   -> per triangle [dir.n     | dir.q_i        ]
    t = -a_n / b_n
    edge_i = a_qi + t * b_qi            (>= 0 inside, model.h:136-154)
    valid  = (b_n <= -eps) & edges & (t >= t_min)

``W``'s columns are grouped per ``TRI_TILE``-triangle tile as
``[n | q0 | q1 | q2]``. The edges are the ``a + t b`` form, not the
clustered kernels' at-``p`` form, so near-edge rays may resolve
differently from ``method="pallas"``.

``tri_brute`` launches the CUDA kernel ``srt_tri_brute`` (csrc/find.cu) on
CUDA tensors and runs ``tri_brute_plain`` on CPU tensors.
"""

from __future__ import annotations

import torch

from sexy_raytracer_tpu_torch.ops import _cuda
from sexy_raytracer_tpu_torch.ops.intersect import (
    T_MIN_DEFAULT,
    _sph_candidates,
    find_hit_bruteforce,
)
from sexy_raytracer_tpu_torch.utils.mathx import EPSILON

RAY_BLOCK = 256      # rays per CUDA block (the TPU kernel's rays per program)
TRI_TILE = 512       # triangles per tile of W
_BIG = 3.0e38
# rays per chunk of the plain version: bounds its [rays, 4 TRI_TILE]
# intermediates at 64 MB
_PLAIN_ROWS = 8192

TRI_BRUTE = _cuda.Kernel(
    "srt_tri_brute", "pppifiipp",
    source="sexy_raytracer_tpu_torch/csrc/find.cu",
    replaces="sexy_raytracer_tpu/ops/pallas_intersect.py:53 (_tri_kernel)",
)


def build_weights(scene):
    """[4, 4 Tpad] weight stack, columns tile-grouped as [n|q0|q1|q2]
    (pallas_intersect.py:98-121)."""
    n, d, q, c = scene.tri_n, scene.tri_d, scene.tri_q, scene.tri_c
    T = n.shape[0]
    n_tiles = max(1, -(-T // TRI_TILE))
    pad = n_tiles * TRI_TILE - T
    wn = torch.cat([n, d[:, None]], dim=1)                        # [T, 4]
    wq = [torch.cat([q[:, i, :], -c[:, i:i + 1]], dim=1) for i in range(3)]
    mats = [torch.nn.functional.pad(m, (0, 0, 0, pad))
            .reshape(n_tiles, TRI_TILE, 4) for m in [wn] + wq]
    stacked = torch.cat(mats, dim=1)                 # [n_tiles, 4 TT, 4]
    return stacked.reshape(n_tiles * 4 * TRI_TILE, 4).T.contiguous()


def ray4(org, dir):
    """(org4, dir4) [Rpad, 4]: ``[o, 1]`` and ``[d, 0]`` rows padded with
    zeros to whole blocks of RAY_BLOCK rays."""
    pad = (-org.shape[0]) % RAY_BLOCK
    ones = torch.ones((org.shape[0], 1), device=org.device)
    org4 = torch.cat([org, ones], dim=1)
    dir4 = torch.cat([dir, torch.zeros_like(ones)], dim=1)
    return (torch.nn.functional.pad(org4, (0, 0, 0, pad)).contiguous(),
            torch.nn.functional.pad(dir4, (0, 0, 0, pad)).contiguous())


@torch.no_grad()
def find_hit_brute(scene, org, dir, time, t_min=None):
    """Closest hit by the brute-force kernel -> ``(prim [R] int32, t [R])``
    (``find_hit_pallas``, pallas_intersect.py:163-201).

    The kernel takes one scalar ``t_min``: a per-ray ``t_min`` goes to
    ``find_hit_bruteforce``, as in the JAX package. Spheres come from
    ``_sph_candidates`` and win when strictly nearer.
    """
    R = org.shape[0]
    if t_min is None:
        t_min_scalar = T_MIN_DEFAULT
    elif not torch.is_tensor(t_min) or t_min.ndim == 0:
        t_min_scalar = float(t_min)
    else:
        return find_hit_bruteforce(scene, org, dir, time, t_min)
    t_min_vec = torch.full((R,), t_min_scalar, dtype=torch.float32,
                           device=org.device)

    T = scene.tri_v0.shape[0]
    if T > 0:
        tri_t, tri_i = tri_brute(*ray4(org, dir), build_weights(scene),
                                 t_min_scalar)
        tri_t, tri_i = tri_t[:R], tri_i[:R]
        tri_t = torch.where(tri_i >= 0, tri_t, float("inf"))
    else:
        tri_t = torch.full((R,), float("inf"), device=org.device)
        tri_i = torch.full((R,), -1, dtype=torch.int32, device=org.device)

    sph_t, sph_i = _sph_candidates(scene, org, dir, time, t_min_vec)
    use_sph = sph_t < tri_t
    t = torch.where(use_sph, sph_t, tri_t)
    prim = torch.where(use_sph, T + sph_i, tri_i)
    prim = torch.where(torch.isfinite(t), prim, -1).to(torch.int32)
    return prim, t


def tri_brute(org4, dir4, w, t_min):
    """Closest triangle per ray -> (t [Rpad] f32 (3e38 = miss), idx [Rpad]
    int32 (-1 = miss)) for ``org4``/``dir4`` [Rpad, 4] and ``w`` [4, 4 Tpad].

    Launches the CUDA kernel on CUDA tensors (csrc/find.cu), runs
    ``tri_brute_plain`` on CPU tensors.

    Kernel note. Replaces ``_tri_kernel`` (pallas_intersect.py:53), which
    ran the two contractions on the MXU. Their depth is 4, so here they are
    four multiplies and three adds per column on the FP32 pipes, not tensor
    cores (the JAX module records the MXU form at ~3% use,
    pallas_find.py:7-10). One thread per ray in blocks of RAY_BLOCK; the
    block stages each tile's [4, 4 TRI_TILE] weights (32 KB) in shared
    memory, every thread reads the same word (broadcast). Bound: the
    operations, 64 per (ray, triangle) pair (two 4-deep products for each
    of the four column groups, the divide and the three edges); the
    weights are read once per block, from L2. The contract is the function as the
    JAX tests run it on the CPU (float32 products); a TPU run of the same
    kernel may round the products on the MXU.
    """
    if not org4.is_cuda:
        return tri_brute_plain(org4, dir4, w, t_min)
    nb = _check_brute_args(org4, dir4, w)
    Rpad = org4.shape[0]
    out_t = torch.empty(Rpad, dtype=torch.float32, device=org4.device)
    out_i = torch.empty(Rpad, dtype=torch.int32, device=org4.device)
    TRI_BRUTE.launch(
        org4.device,
        _cuda.ptr(org4), _cuda.ptr(dir4), _cuda.ptr(w),
        w.shape[1] // (4 * TRI_TILE), float(t_min), RAY_BLOCK, nb,
        _cuda.ptr(out_t), _cuda.ptr(out_i),
    )
    return out_t, out_i


def tri_brute_plain(org4, dir4, w, t_min):
    """Plain PyTorch version of ``tri_brute``: the kernel's products in its
    order (``x w0 + y w1 + z w2 + w w3``, one operation at a time), its
    formulas, and its tie rule (the lowest index within a tile, a strictly
    smaller t across tiles). Rays go in chunks of ``_PLAIN_ROWS``."""
    Rpad = org4.shape[0]
    n_tiles = w.shape[1] // (4 * TRI_TILE)
    t_min = torch.tensor(t_min, dtype=torch.float32)
    out_t = torch.empty((Rpad,), device=org4.device)
    out_i = torch.empty((Rpad,), dtype=torch.int32, device=org4.device)
    for r0 in range(0, Rpad, _PLAIN_ROWS):
        o = [org4[r0:r0 + _PLAIN_ROWS, i:i + 1] for i in range(4)]
        d = [dir4[r0:r0 + _PLAIN_ROWS, i:i + 1] for i in range(4)]
        best_t = torch.full((o[0].shape[0],), _BIG, device=org4.device)
        best_i = torch.full_like(best_t, -1, dtype=torch.int32)
        for k in range(n_tiles):
            wk = w[:, k * 4 * TRI_TILE:(k + 1) * 4 * TRI_TILE]
            a = o[0] * wk[0] + o[1] * wk[1] + o[2] * wk[2] + o[3] * wk[3]
            b = d[0] * wk[0] + d[1] * wk[1] + d[2] * wk[2] + d[3] * wk[3]
            a_n, b_n = a[:, :TRI_TILE], b[:, :TRI_TILE]
            plane_ok = b_n <= -EPSILON
            t = -a_n / torch.where(plane_ok, b_n, 1.0)
            valid = plane_ok & (t >= t_min)
            for i in (1, 2, 3):
                cols = slice(i * TRI_TILE, (i + 1) * TRI_TILE)
                valid &= (a[:, cols] + t * b[:, cols]) >= 0.0
            t = torch.where(valid, t, _BIG)
            tile_t, tile_arg = torch.min(t, dim=1)
            better = tile_t < best_t
            best_t = torch.where(better, tile_t, best_t)
            best_i = torch.where(better, (k * TRI_TILE + tile_arg)
                                 .to(torch.int32), best_i)
        out_t[r0:r0 + _PLAIN_ROWS] = best_t
        out_i[r0:r0 + _PLAIN_ROWS] = torch.where(best_t < _BIG, best_i, -1)
    return out_t, out_i


def _check_brute_args(org4, dir4, w):
    """Validate what the brute kernel reads; returns the block count."""
    dev = org4.device
    for name, x in (("org4", org4), ("dir4", dir4), ("w", w)):
        if x.device != dev or x.dtype != torch.float32 \
                or not x.is_contiguous():
            raise ValueError(
                f"{name}: need a contiguous float32 tensor on {dev}, got "
                f"{x.dtype} on {x.device} (contiguous={x.is_contiguous()})")
    Rpad = org4.shape[0]
    if org4.shape != (Rpad, 4) or dir4.shape != (Rpad, 4) \
            or Rpad % RAY_BLOCK:
        raise ValueError(f"org4/dir4 must be [nb * {RAY_BLOCK}, 4], got "
                         f"{tuple(org4.shape)}, {tuple(dir4.shape)}")
    if w.ndim != 2 or w.shape[0] != 4 or w.shape[1] % (4 * TRI_TILE):
        raise ValueError(f"w must be [4, 4 * {TRI_TILE} * n_tiles], got "
                         f"{tuple(w.shape)}")
    return Rpad // RAY_BLOCK
