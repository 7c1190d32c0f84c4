"""Host-side BVH build + flatten, and the device refit (a copy of
``sexy_raytracer_tpu/models/bvh.py``: the builders in numpy, the refit in
torch).

Semantics of the reference's median-split builder (reference bvh.h:55-95)
with its one nondeterminism fixed: the reference picks a *random* split axis
per node from the global mt19937 (bvh.h:60); we pick the largest-extent axis
of the primitive-box centroids — deterministic and measurably better trees.
Primitives are sorted per node by AABB minimum on the chosen axis exactly as
``boxCompare`` (bvh.h:34-41), split at the median, and recursed.

The tree is flattened depth-first with the root at index 0, matching the
layout invariant of the reference's GPU export (bvh.h:112-148: interior
children >= 0; leaf marker -1 at model.h:271, tested by compute.glsl:171).
Leaves store one primitive: ``left == -1`` and ``right`` = global primitive
id (triangle index in ``[0, T)``, sphere index ``T + [0, S)``).

Primitive boxes replicate the reference:
  * triangle AABB padded +-1e-4 on flat axes (model.h:199-204),
  * sphere AABB = union of the radius boxes at time0 and time1
    (sphere.h:85-94) and ``surroundingBox`` = component-wise min/max union
    (aabb.h:33-43).

At ``NATIVE_MIN_PRIMS`` primitives and above the native builder
(``native/bvh_native.py``) builds the tree when a C++ toolchain is present;
the numpy path is the fallback and the correctness oracle for it. Both
produce bit-identical trees.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# the native builder takes over from this many primitives (the JAX
# package's rule, models/bvh.py:110)
NATIVE_MIN_PRIMS = 512
_BIG = 3.0e38


class FlatBVH(NamedTuple):
    node_min: np.ndarray  # [N,3] float32
    node_max: np.ndarray  # [N,3] float32
    left: np.ndarray      # [N] int32; -1 marks a leaf
    right: np.ndarray     # [N] int32; child id, or primitive id at leaves
    skip: np.ndarray = None  # [N] int32; preorder escape index (see below)


def _host(x) -> np.ndarray:
    """A scene field as a numpy array (tensors on any device)."""
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def compute_skip(left: np.ndarray, right: np.ndarray) -> np.ndarray:
    """Skip links for stackless traversal: ``skip[i]`` = the first preorder
    node AFTER node i's subtree (N for the last spine).

    With the preorder invariant (an interior node's left child is ``i+1``),
    traversal needs no stack at all: descend to ``i+1`` on a box hit,
    jump to ``skip[i]`` on a miss or leaf — the threaded-tree form GPU
    tracers use.
    """
    n = left.shape[0]
    skip = np.empty((n,), np.int32)
    stack = [(0, n)]
    while stack:
        node, esc = stack.pop()
        skip[node] = esc
        l, r = int(left[node]), int(right[node])
        if l != -1:
            stack.append((r, esc))
            stack.append((l, r))
    return skip


def primitive_bounds(scene, time0: float = 0.0, time1: float = 1.0):
    """AABBs for all primitives as ``([P,3] min, [P,3] max)`` numpy arrays.

    Order: triangles ``[0,T)`` then spheres ``T+[0,S)`` (global prim ids).
    ``scene`` is anything with the scene's field names: a ``SceneData``
    (on any device) or a namespace of numpy arrays.
    """
    tri_v0 = _host(scene.tri_v0)
    tri_v1 = _host(scene.tri_v1)
    tri_v2 = _host(scene.tri_v2)
    tmin = np.minimum(np.minimum(tri_v0, tri_v1), tri_v2)
    tmax = np.maximum(np.maximum(tri_v0, tri_v1), tri_v2)
    flat = tmin == tmax  # pad flat axes (model.h:199-204)
    tmin = np.where(flat, tmin - 1e-4, tmin)
    tmax = np.where(flat, tmax + 1e-4, tmax)

    c0 = _host(scene.sph_c0)
    c1 = _host(scene.sph_c1)
    st0 = _host(scene.sph_t0)
    st1 = _host(scene.sph_t1)
    r = _host(scene.sph_radius)[:, None]

    def center_at(t):
        denom = np.where(st1 == st0, 1.0, st1 - st0)[:, None]
        frac = ((t - st0) / denom.squeeze(-1))[:, None]
        moving = np.any(c0 != c1, axis=-1, keepdims=True)
        return np.where(moving, c0 + frac * (c1 - c0), c0)

    ca, cb = center_at(time0), center_at(time1)
    smin = np.minimum(ca - r, cb - r)
    smax = np.maximum(ca + r, cb + r)

    pmin = np.concatenate([tmin, smin], axis=0).astype(np.float32)
    pmax = np.concatenate([tmax, smax], axis=0).astype(np.float32)
    return pmin, pmax


def builder_for(n_prims: int) -> str:
    """Which builder ``build_bvh`` uses for ``n_prims`` primitives:
    ``"native"`` (C++, compiled at first use) or ``"numpy"``."""
    if n_prims >= NATIVE_MIN_PRIMS:
        from sexy_raytracer_tpu_torch.native import bvh_native

        if bvh_native.available():
            return "native"
    return "numpy"


def build_bvh(scene, time0: float = 0.0, time1: float = 1.0) -> FlatBVH:
    pmin, pmax = primitive_bounds(scene, time0, time1)
    P = pmin.shape[0]
    if P == 0:
        raise ValueError("cannot build a BVH over an empty scene")

    if builder_for(P) == "native":
        from sexy_raytracer_tpu_torch.native import bvh_native

        bvh = bvh_native.build(pmin, pmax)
    else:
        bvh = build_bvh_numpy(pmin, pmax)
    if bvh.skip is None:
        bvh = bvh._replace(skip=compute_skip(bvh.left, bvh.right))
    return bvh


def build_bvh_numpy(pmin: np.ndarray, pmax: np.ndarray) -> FlatBVH:
    """Median-split build over primitive boxes; see module docstring."""
    P = pmin.shape[0]
    centroids = 0.5 * (pmin + pmax)

    n_nodes = 2 * P - 1
    node_min = np.zeros((n_nodes, 3), np.float32)
    node_max = np.zeros((n_nodes, 3), np.float32)
    left = np.full((n_nodes,), -1, np.int32)
    right = np.full((n_nodes,), -1, np.int32)

    next_node = [0]

    # Iterative DFS with an explicit stack: (prim index array, parent slot).
    # Preorder emission => root ends up at index 0 (bvh.h:112-148 invariant).
    def alloc() -> int:
        idx = next_node[0]
        next_node[0] += 1
        return idx

    root_prims = np.arange(P, dtype=np.int64)
    stack = [(root_prims, None, 0)]  # (prims, parent, which-child)
    while stack:
        prims, parent, which = stack.pop()
        node = alloc()
        if parent is not None:
            if which == 0:
                left[parent] = node
            else:
                right[parent] = node

        bmin = pmin[prims].min(axis=0)
        bmax = pmax[prims].max(axis=0)
        node_min[node] = bmin
        node_max[node] = bmax

        if prims.size == 1:
            left[node] = -1
            right[node] = np.int32(prims[0])
            continue

        ext = centroids[prims].max(axis=0) - centroids[prims].min(axis=0)
        axis = int(np.argmax(ext))
        order = np.argsort(pmin[prims, axis], kind="stable")
        prims = prims[order]
        mid = prims.size // 2
        # Push right first so left is emitted first (preorder, like the
        # reference's left-then-right DFS at bvh.h:120-130).
        stack.append((prims[mid:], node, 1))
        stack.append((prims[:mid], node, 0))

    assert next_node[0] == n_nodes
    return FlatBVH(node_min, node_max, left, right)


@torch.no_grad()
def refit_bvh_device(scene, time0: float = 0.0, time1: float = 1.0):
    """Recompute BVH node bounds on the scene's device for trained geometry.

    The tree topology (``bvh_left/right``) is static; only the bounds go
    stale when inverse rendering moves triangle vertices or sphere centers.
    Leaf bounds come from the primitive tensors (mirroring
    :func:`primitive_bounds`), then vectorised child-union passes propagate
    upward until nothing changes — one level per pass, so any tree depth
    converges exactly (the JAX package runs the same passes in a
    ``lax.while_loop``). Stop-gradient: the bounds feed only hit search.
    Returns ``(bvh_min, bvh_max)`` tensors.
    """
    tmin = torch.minimum(torch.minimum(scene.tri_v0, scene.tri_v1),
                         scene.tri_v2)
    tmax = torch.maximum(torch.maximum(scene.tri_v0, scene.tri_v1),
                         scene.tri_v2)
    flat = tmin == tmax
    tmin = torch.where(flat, tmin - 1e-4, tmin)
    tmax = torch.where(flat, tmax + 1e-4, tmax)

    c0, c1 = scene.sph_c0, scene.sph_c1
    st0, st1 = scene.sph_t0, scene.sph_t1
    r = scene.sph_radius[:, None]
    moving = torch.any(c0 != c1, dim=-1, keepdim=True)
    denom = torch.where(st1 == st0, 1.0, st1 - st0)[:, None]

    def center_at(t):
        frac = (t - st0)[:, None] / denom
        return torch.where(moving, c0 + frac * (c1 - c0), c0)

    ca, cb = center_at(time0), center_at(time1)
    smin = torch.minimum(ca - r, cb - r)
    smax = torch.maximum(ca + r, cb + r)

    pmin = torch.cat([tmin, smin], dim=0).detach()
    pmax = torch.cat([tmax, smax], dim=0).detach()
    P = pmin.shape[0]
    left, right = scene.bvh_left.long(), scene.bvh_right.long()
    N = left.shape[0]

    is_leaf = (left == -1)[:, None]
    leaf_min = pmin[torch.clamp(right, 0, P - 1)]
    leaf_max = pmax[torch.clamp(right, 0, P - 1)]
    l = torch.clamp(left, 0, N - 1)
    rr = torch.clamp(right, 0, N - 1)
    node_min = torch.where(is_leaf, leaf_min, _BIG)
    node_max = torch.where(is_leaf, leaf_max, -_BIG)
    while True:
        new_min = torch.where(
            is_leaf, leaf_min, torch.minimum(node_min[l], node_min[rr]))
        new_max = torch.where(
            is_leaf, leaf_max, torch.maximum(node_max[l], node_max[rr]))
        changed = bool(torch.any(new_min != node_min)
                       | torch.any(new_max != node_max))
        node_min, node_max = new_min, new_max
        if not changed:
            return node_min, node_max


def validate_bvh(bvh: FlatBVH, pmin: np.ndarray, pmax: np.ndarray) -> None:
    """Structural sanity checks (used by tests and the native-builder
    oracle). Raises ``AssertionError`` on the first violation."""
    n = bvh.left.shape[0]
    P = pmin.shape[0]
    assert n == 2 * P - 1
    seen = np.zeros(P, dtype=bool)
    stack = [0]
    visited = 0
    while stack:
        i = stack.pop()
        visited += 1
        if bvh.left[i] == -1:
            prim = bvh.right[i]
            assert 0 <= prim < P
            assert not seen[prim]
            seen[prim] = True
            assert np.all(bvh.node_min[i] <= pmin[prim] + 1e-6)
            assert np.all(bvh.node_max[i] >= pmax[prim] - 1e-6)
        else:
            l, r = int(bvh.left[i]), int(bvh.right[i])
            for ch in (l, r):
                assert 0 <= ch < n
                assert np.all(bvh.node_min[i] <= bvh.node_min[ch] + 1e-6)
                assert np.all(bvh.node_max[i] >= bvh.node_max[ch] - 1e-6)
            stack.extend((l, r))
    assert visited == n
    assert seen.all()
