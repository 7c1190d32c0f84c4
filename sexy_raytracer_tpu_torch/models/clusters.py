"""Spatial triangle clustering for the find kernel (a copy of
``sexy_raytracer_tpu/models/clusters.py:32-121``: numpy on the host,
torch for the bounds of trained vertices).

The find kernel (ops/find.py) tests triangles in tiles of ``CLUSTER_SIZE``
and skips whole tiles whose AABB a ray block misses. Triangles are ordered
by a median-split BVH DFS so that consecutive triangles are spatially
coherent, and the order is cut into consecutive clusters.
"""

from __future__ import annotations

import os

import numpy as np
import torch

# triangles per cluster tile; the environment override is shared with the
# JAX package so that both build the same scene order.
CLUSTER_SIZE = int(os.environ.get("SRT_CLUSTER_SIZE", "256"))
_BIG = 3.0e38


def cluster_bounds_device(tri_v0, tri_v1, tri_v2, ck=None):
    """Re-derive cluster AABBs on the device from (trained) vertices.

    The partition is static — cluster ``c`` covers scene-order triangles
    ``[c*ck, (c+1)*ck)`` — so the bounds are a segment min/max over it.
    Without this, the find kernel tests trained geometry against stale
    boxes and drops hits. Flat axes are padded +-1e-4 like the host path
    (model.h:199-204). Returns ``(cluster_min, cluster_max)`` [NC, 3].
    """
    if ck is None:
        ck = CLUSTER_SIZE
    T = tri_v0.shape[0]
    if T == 0:
        empty = tri_v0.new_zeros((0, 3))
        return empty, empty.clone()
    tmin = torch.minimum(torch.minimum(tri_v0, tri_v1), tri_v2)
    tmax = torch.maximum(torch.maximum(tri_v0, tri_v1), tri_v2)
    flat = tmin == tmax
    tmin = torch.where(flat, tmin - 1e-4, tmin)
    tmax = torch.where(flat, tmax + 1e-4, tmax)
    nc = -(-T // ck)
    pad = nc * ck - T
    tmin = torch.nn.functional.pad(tmin, (0, 0, 0, pad), value=_BIG)
    tmax = torch.nn.functional.pad(tmax, (0, 0, 0, pad), value=-_BIG)
    return (tmin.reshape(nc, ck, 3).amin(dim=1),
            tmax.reshape(nc, ck, 3).amax(dim=1))


def dfs_order(pmin: np.ndarray, pmax: np.ndarray) -> np.ndarray:
    """Median-split DFS order of primitives given their AABBs -> [P] int32."""
    P = pmin.shape[0]
    centroids = 0.5 * (pmin + pmax)
    out = np.empty((P,), np.int64)
    n_out = 0
    stack = [np.arange(P, dtype=np.int64)]
    while stack:
        prims = stack.pop()
        if prims.size <= 2:
            out[n_out : n_out + prims.size] = prims
            n_out += prims.size
            continue
        ext = centroids[prims].max(axis=0) - centroids[prims].min(axis=0)
        axis = int(np.argmax(ext))
        order = np.argsort(pmin[prims, axis], kind="stable")
        prims = prims[order]
        mid = prims.size // 2
        stack.append(prims[mid:])   # popped second
        stack.append(prims[:mid])   # popped first -> left-to-right DFS
    if n_out != P:
        raise RuntimeError(f"dfs_order emitted {n_out} of {P} primitives")
    return out.astype(np.int32)


def triangle_order(tri_v0, tri_v1, tri_v2, ck=None):
    """Spatial permutation + cluster AABBs for the kernel tiles.

    Returns ``(order [T], cluster_min [NC,3], cluster_max [NC,3])`` where
    triangle ``order[i]`` of the input becomes triangle ``i`` of the scene
    and cluster ``c`` covers permuted triangles ``[c*ck, (c+1)*ck)``.
    Triangle AABBs are padded +-1e-4 on flat axes like the reference
    (model.h:199-204) so the slab test can't miss axis-aligned geometry.
    """
    if ck is None:
        ck = CLUSTER_SIZE
    v0 = np.asarray(tri_v0, np.float64)
    v1 = np.asarray(tri_v1, np.float64)
    v2 = np.asarray(tri_v2, np.float64)
    T = v0.shape[0]
    if T == 0:
        return (
            np.zeros((0,), np.int32),
            np.zeros((0, 3), np.float32),
            np.zeros((0, 3), np.float32),
        )
    tmin = np.minimum(np.minimum(v0, v1), v2)
    tmax = np.maximum(np.maximum(v0, v1), v2)
    flat = tmin == tmax
    tmin = np.where(flat, tmin - 1e-4, tmin)
    tmax = np.where(flat, tmax + 1e-4, tmax)

    order = dfs_order(tmin, tmax)
    n_clusters = -(-T // ck)
    cmin = np.full((n_clusters, 3), np.inf)
    cmax = np.full((n_clusters, 3), -np.inf)
    for c in range(n_clusters):
        sel = order[c * ck : (c + 1) * ck]
        cmin[c] = tmin[sel].min(axis=0)
        cmax[c] = tmax[sel].max(axis=0)
    return order, cmin.astype(np.float32), cmax.astype(np.float32)
