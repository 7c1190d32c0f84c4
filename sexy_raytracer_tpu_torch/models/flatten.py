"""Export the scene in the reference's GPU-flattened record format
(counterpart of ``sexy_raytracer_tpu/models/flatten.py``: the scene is
moved to the host once, then flattened by the same numpy).

The reference flattens its BVH + primitives into an array of
``hittableIndexed`` records for the (disabled) compute-shader path
(reference hittableindexed.h:24-38, hittablevector.h:27-31,
bvh.h:112-148) — 16 vec4 fields per record, std430-padded. That layout is
the reference's own roadmap for array-based traversal; our native scene
form (SceneData) is its done-right successor, and this module converts
between the two:

  * ``to_indexed``: SceneData -> the reference record layout, with the
    reference's stub fields filled properly (real UVs and material indices
    where the reference wrote debug tags, model.h:261-271; sphere leaves
    carry geometry where the reference emitted nothing, sphere.h:21-27).
  * interior nodes: ``left_and_right`` child ids, ``box_min/max`` —
    identical to bvhNode::populateVector (bvh.h:112-148).
  * leaf marker: ``left_and_right[0] == -1`` (model.h:271, tested by
    compute.glsl:171).

Record layout (float32 [N, 16, 4]):
  rows 0-2: triangle vertex positions (w=0) | sphere: row0 = center0,
            row1 = center1, row2 = (t0, t1, radius, prim_kind=1)
  rows 3-5: triangle vertex UVs (zw=0)
  row 6:    (mat_index, prim_kind, global_prim_id, 0) as int bits
  row 7:    box_min (w=0)
  row 8:    box_max (w=0)
  row 9:    (left, right, -, -) as int bits; left == -1 marks a leaf
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

PRIM_TRIANGLE = 0
PRIM_SPHERE = 1

N_ROWS = 10


class IndexedScene(NamedTuple):
    records: np.ndarray  # [N, N_ROWS, 4] float32 (int fields bit-cast)

    @property
    def num_records(self) -> int:
        return self.records.shape[0]


def _as_int(x):
    return x.view(np.int32)


def _host(scene):
    return scene.numpy() if hasattr(scene, "numpy") else scene


def to_indexed(scene) -> IndexedScene:
    """Flatten a built SceneData (with BVH) into the record array."""
    scene = _host(scene)
    bvh_left = np.asarray(scene.bvh_left)
    bvh_right = np.asarray(scene.bvh_right)
    if bvh_left.shape[0] == 0:
        raise ValueError("scene has no BVH; build with build_bvh=True")
    n = bvh_left.shape[0]
    T = np.asarray(scene.tri_v0).shape[0]

    rec = np.zeros((n, N_ROWS, 4), np.float32)
    rec_i = rec.view(np.int32)

    is_leaf = bvh_left == -1
    interior = ~is_leaf

    # interior nodes (bvh.h:112-148)
    rec_i[interior, 9, 0] = bvh_left[interior]
    rec_i[interior, 9, 1] = bvh_right[interior]
    rec[:, 7, :3] = np.asarray(scene.bvh_min)
    rec[:, 8, :3] = np.asarray(scene.bvh_max)

    # leaves
    leaf_ids = np.where(is_leaf)[0]
    prim = bvh_right[leaf_ids]
    rec_i[leaf_ids, 9, 0] = -1  # leaf marker (model.h:271)
    rec_i[leaf_ids, 9, 1] = -1

    tri_mask = prim < T
    tri_nodes = leaf_ids[tri_mask]
    tri_prims = prim[tri_mask]
    if tri_prims.size:
        v = [np.asarray(scene.tri_v0), np.asarray(scene.tri_v1),
             np.asarray(scene.tri_v2)]
        uv = [np.asarray(scene.tri_uv0), np.asarray(scene.tri_uv1),
              np.asarray(scene.tri_uv2)]
        for k in range(3):
            rec[tri_nodes, k, :3] = v[k][tri_prims]
            rec[tri_nodes, 3 + k, :2] = uv[k][tri_prims]
        rec_i[tri_nodes, 6, 0] = np.asarray(scene.tri_mat)[tri_prims]
        rec_i[tri_nodes, 6, 1] = PRIM_TRIANGLE
        rec_i[tri_nodes, 6, 2] = tri_prims

    sph_nodes = leaf_ids[~tri_mask]
    sph_prims = prim[~tri_mask] - T
    if sph_prims.size:
        rec[sph_nodes, 0, :3] = np.asarray(scene.sph_c0)[sph_prims]
        rec[sph_nodes, 1, :3] = np.asarray(scene.sph_c1)[sph_prims]
        rec[sph_nodes, 2, 0] = np.asarray(scene.sph_t0)[sph_prims]
        rec[sph_nodes, 2, 1] = np.asarray(scene.sph_t1)[sph_prims]
        rec[sph_nodes, 2, 2] = np.asarray(scene.sph_radius)[sph_prims]
        rec_i[sph_nodes, 6, 0] = np.asarray(scene.sph_mat)[sph_prims]
        rec_i[sph_nodes, 6, 1] = PRIM_SPHERE
        rec_i[sph_nodes, 6, 2] = prim[~tri_mask]

    return IndexedScene(records=rec)


def validate_indexed(indexed: IndexedScene, scene) -> None:
    """Invariants of the reference layout: root at 0, interior children in
    range, every primitive reachable exactly once (bvh.h/model.h)."""
    scene = _host(scene)
    rec = indexed.records
    rec_i = rec.view(np.int32)
    n = rec.shape[0]
    T = np.asarray(scene.tri_v0).shape[0]
    S = np.asarray(scene.sph_c0).shape[0]
    seen = np.zeros(T + S, bool)
    stack = [0]
    visited = 0
    while stack:
        i = stack.pop()
        visited += 1
        left = rec_i[i, 9, 0]
        if left == -1:
            prim = rec_i[i, 6, 2]
            assert not seen[prim]
            seen[prim] = True
        else:
            right = rec_i[i, 9, 1]
            assert 0 <= left < n and 0 <= right < n
            stack.extend((int(left), int(right)))
    assert visited == n
    assert seen.all()
