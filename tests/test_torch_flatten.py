"""The port's flattened record export (``models/flatten.py``): a mirror of
``tests/test_flatten.py`` on a port scene, and ``to_indexed`` of one scene
from both packages, bit for bit."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from sexy_raytracer_tpu.models import flatten as jflatten  # noqa: E402
from sexy_raytracer_tpu.models.scene import SceneBuilder as JBuilder  # noqa: E402
from sexy_raytracer_tpu_torch.models import presets as tpresets  # noqa: E402
from sexy_raytracer_tpu_torch.models.flatten import (  # noqa: E402
    N_ROWS,
    PRIM_SPHERE,
    PRIM_TRIANGLE,
    IndexedScene,
    to_indexed,
    validate_indexed,
)
from sexy_raytracer_tpu_torch.models.scene import SceneBuilder as TBuilder  # noqa: E402


def _builder(B, seed):
    """tests/test_flatten.py's scene, for either builder."""
    rng = np.random.default_rng(seed)
    b = B()
    mat = b.add_pbr_material()
    mat2 = b.add_metal_material((0.7, 0.6, 0.5), 0.1)
    for _ in range(20):
        b.add_mesh(rng.normal(size=(3, 3)) * 2, rng.random((3, 2)),
                   [[0, 1, 2]], mat)
    for _ in range(5):
        b.add_sphere(rng.normal(size=3) * 3, 0.5, mat2)
    return b


def test_roundtrip_invariants():
    scene = _builder(TBuilder, 1234).build(build_bvh=True, device="cpu")
    indexed = to_indexed(scene)
    assert isinstance(indexed, IndexedScene)
    assert indexed.records.shape == (scene.num_bvh_nodes, N_ROWS, 4)
    assert indexed.records.dtype == np.float32
    validate_indexed(indexed, scene)

    rec = indexed.records
    rec_i = rec.view(np.int32)
    s = scene.numpy()
    assert rec_i[0, 9, 0] >= 0
    leaves = rec_i[:, 9, 0] == -1
    tri_leaves = leaves & (rec_i[:, 6, 1] == PRIM_TRIANGLE)
    sph_leaves = leaves & (rec_i[:, 6, 1] == PRIM_SPHERE)
    assert tri_leaves.sum() == scene.num_triangles
    assert sph_leaves.sum() == scene.num_spheres
    node = np.where(tri_leaves)[0][0]
    prim = rec_i[node, 6, 2]
    np.testing.assert_allclose(rec[node, 0, :3], s.tri_v0[prim])
    np.testing.assert_allclose(rec[node, 3, :2], s.tri_uv0[prim])
    assert rec_i[node, 6, 0] == s.tri_mat[prim]
    node = np.where(sph_leaves)[0][0]
    prim = rec_i[node, 6, 2] - scene.num_triangles
    np.testing.assert_allclose(rec[node, 0, :3], s.sph_c0[prim])
    assert rec[node, 2, 2] == s.sph_radius[prim]


@pytest.mark.parametrize("case", ["random", "shirley_parity", "standin"])
def test_to_indexed_matches_jax(case):
    """The same scene built by both packages flattens to the same record
    bits; the JAX package's validator accepts the port's records."""
    if case == "random":
        tscene = _builder(TBuilder, 7).build(device="cpu")
        jscene = _builder(JBuilder, 7).build(device=False)
    elif case == "shirley_parity":
        from sexy_raytracer_tpu.models import presets as jpresets

        tscene, _ = tpresets.shirley_parity(height=18, spp=1, device="cpu")
        jscene = jax.device_get(jpresets.shirley_parity(height=18, spp=1)[0])
    else:
        bt, bj = TBuilder(), JBuilder()
        tpresets.add_relief_mesh(bt, 9)
        tpresets.add_relief_mesh(bj, 9)
        for b in (bt, bj):
            b.add_sphere((0.0, -1000.0, 0.0), 1000.0, b.add_pbr_material())
            b.add_sphere((1.0, 1.0, 0.0), 0.5, b.add_metal_material(
                (0.7, 0.6, 0.5), 0.2), center1=(1.0, 1.5, 0.0))
        tscene, jscene = bt.build(device="cpu"), bj.build(device=False)
    got = to_indexed(tscene).records
    want = jflatten.to_indexed(jscene).records
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    jflatten.validate_indexed(jflatten.IndexedScene(got), jscene)


def test_to_indexed_needs_a_bvh():
    scene = _builder(TBuilder, 3).build(build_bvh=False, device="cpu")
    with pytest.raises(ValueError, match="no BVH"):
        to_indexed(scene)
