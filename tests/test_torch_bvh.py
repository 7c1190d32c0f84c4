"""The port's BVH (``models/bvh.py``, ``native/``) and its skip-link
referee (``ops/bvh_traverse.py``) against the JAX package: bit-equal
trees from both builders, the refit of trained geometry, and the
traversal's hits. Prim ids of the traversal are exact or a near tie
(``|t - t_ref| <= 1e-3 min(t) + 1e-5``): the packages evaluate the same
formulas, and XLA may round a dot product otherwise."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from sexy_raytracer_tpu.models import bvh as jbvh  # noqa: E402
from sexy_raytracer_tpu.models.scene import SceneBuilder as JBuilder  # noqa: E402
from sexy_raytracer_tpu.ops.bvh_traverse import find_hit_bvh as j_bvh  # noqa: E402
from sexy_raytracer_tpu_torch.models import bvh as tbvh  # noqa: E402
from sexy_raytracer_tpu_torch.models.scene import (  # noqa: E402
    SceneBuilder as TBuilder,
)
from sexy_raytracer_tpu_torch.native import bvh_native  # noqa: E402
from sexy_raytracer_tpu_torch.ops import intersect as tint  # noqa: E402
from sexy_raytracer_tpu_torch.ops.bvh_traverse import find_hit_bvh  # noqa: E402

FIELDS = ("node_min", "node_max", "left", "right", "skip")


def _prims(kind, B, n_tris=200, n_sph=40, seed=0):
    """A builder of ``kind``: triangles, static spheres, or triangles and
    moving spheres (tests/test_bvh_traverse.py:11-21), from one seed."""
    r = np.random.default_rng(seed)
    b = B()
    mat = b.add_pbr_material()
    if kind != "static_spheres":
        for _ in range(n_tris):
            b.add_mesh(r.normal(size=(3, 3)) * 3, None, [[0, 1, 2]], mat)
    if kind != "triangles":
        for _ in range(n_sph):
            c = r.normal(size=3) * 4
            c1 = c + r.normal(size=3) * 0.3 if kind == "moving" else None
            b.add_sphere(c, 0.2 + r.random(), mat, center1=c1)
    return b


def _assert_same_tree(got, want):
    for name in FIELDS:
        g, w = np.asarray(getattr(got, name)), np.asarray(getattr(want, name))
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("kind", ["triangles", "static_spheres", "moving"])
def test_numpy_builder_matches_jax(kind):
    """Primitive boxes, the median-split tree and its skip links equal the
    JAX package's bit for bit, as does the default ``build()``."""
    jscene = _prims(kind, JBuilder).build(build_bvh=False, device=False)
    tscene = _prims(kind, TBuilder).build(build_bvh=False, device="cpu")
    jb = jbvh.primitive_bounds(jscene)
    tb = tbvh.primitive_bounds(tscene)
    for g, w in zip(tb, jb):
        np.testing.assert_array_equal(g, w)
    want = jbvh.build_bvh_numpy(*jb)
    want = want._replace(skip=jbvh.compute_skip(want.left, want.right))
    got = tbvh.build_bvh_numpy(*tb)
    got = got._replace(skip=tbvh.compute_skip(got.left, got.right))
    _assert_same_tree(got, want)
    tbvh.validate_bvh(got, *tb)
    built = _prims(kind, TBuilder).build(device="cpu")
    assert tbvh.builder_for(tb[0].shape[0]) == "numpy"
    _assert_same_tree(tbvh.FlatBVH(built.bvh_min, built.bvh_max,
                                   built.bvh_left, built.bvh_right,
                                   built.bvh_skip), want)


@pytest.mark.parametrize("n", [512, 3042])
def test_native_builder_matches_numpy(n):
    """At NATIVE_MIN_PRIMS and above the native builder builds the tree; it
    is bit-equal to the numpy builder (tests/test_native.py) and builds
    into build/, not into the package."""
    r = np.random.default_rng(n)
    centers = r.normal(size=(n, 3)).astype(np.float32) * 10
    half = (0.01 + r.random((n, 3)).astype(np.float32)) * 2
    pmin, pmax = centers - half, centers + half
    assert bvh_native.available(), "g++ is present here"
    assert tbvh.builder_for(n) == "native"
    assert tbvh.builder_for(tbvh.NATIVE_MIN_PRIMS - 1) == "numpy"
    a = tbvh.build_bvh_numpy(pmin, pmax)
    b = bvh_native.build(pmin, pmax)
    for name in FIELDS[:4]:
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    tbvh.validate_bvh(b, pmin, pmax)
    lib = bvh_native.library_path()
    assert lib.exists() and lib.parent.name == "sexy_raytracer_tpu_torch" \
        and lib.parent.parent.name == "build"


def test_validate_bvh_rejects_a_broken_tree():
    scene = _prims("moving", TBuilder).build(device="cpu")
    pmin, pmax = tbvh.primitive_bounds(scene)
    tree = tbvh.FlatBVH(*(getattr(scene, f).numpy() for f in
                          ("bvh_min", "bvh_max", "bvh_left", "bvh_right",
                           "bvh_skip")))
    tbvh.validate_bvh(tree, pmin, pmax)
    leaf = int(np.nonzero(tree.left == -1)[0][0])
    shrunk = tree.node_max.copy()
    shrunk[leaf] -= 1.0
    with pytest.raises(AssertionError):
        tbvh.validate_bvh(tree._replace(node_max=shrunk), pmin, pmax)


@pytest.mark.parametrize("kind", ["triangles", "moving"])
def test_find_hit_bvh_matches_jax_and_bruteforce(kind):
    jscene = jax.device_put(_prims(kind, JBuilder).build(device=False))
    tscene = _prims(kind, TBuilder).build(device="cpu")
    r = np.random.default_rng(5)
    R = 1024
    org = (r.normal(size=(R, 3)) * 4).astype(np.float32)
    d = r.normal(size=(R, 3)).astype(np.float32)
    d[:64, 1:] = 0.0            # axis-aligned: 0 * inf in the slab test
    tm = r.random(R).astype(np.float32)
    t_min = np.where(r.random(R) < 0.1, 3.0e38, 1e-3).astype(np.float32)
    args_t = [torch.from_numpy(x) for x in (org, d, tm, t_min)]
    p_j, t_j = map(np.asarray, j_bvh(jscene, *map(jnp.asarray,
                                                  (org, d, tm, t_min))))
    p_t, t_t = tint.find_hit(tscene, *args_t[:3], t_min=args_t[3],
                             method="bvh")
    p_t, t_t = p_t.numpy(), t_t.numpy()
    p_b, t_b = tint.find_hit_bruteforce(tscene, *args_t[:3], t_min=args_t[3])
    for p0, t0 in ((p_j, t_j), (p_b.numpy(), t_b.numpy())):
        dis = p_t != p0
        assert dis.sum() <= 2          # tests/test_bvh_traverse.py:33
        if dis.any():
            a, b = np.where(np.isfinite(t_t), t_t, 1e30)[dis], \
                np.where(np.isfinite(t0), t0, 1e30)[dis]
            assert (np.abs(a - b) <= 1e-3 * np.minimum(a, b) + 1e-5).all()
    assert (p_t[t_min >= 3.0e38] == -1).all()
    assert (p_t >= 0).sum() > 100
    with pytest.raises(ValueError):
        find_hit_bvh(_prims(kind, TBuilder).build(build_bvh=False,
                                                  device="cpu"),
                     *args_t[:3])


def test_refit_matches_jax():
    """Moved vertices and moving-sphere centres: ``refit_bvh_device`` gives JAX's node bounds bit for bit, and they
    enclose the moved primitives."""
    jscene = _prims("moving", JBuilder).build(device=False)
    tscene = _prims("moving", TBuilder).build(device="cpu")
    r = np.random.default_rng(2)
    moved = {k: (np.asarray(getattr(jscene, k))
                 + r.normal(0, 0.3, getattr(jscene, k).shape)
                 ).astype(np.float32)
             for k in ("tri_v0", "tri_v1", "tri_v2", "sph_c0", "sph_c1")}
    jmoved = jax.device_put(jscene)._replace(
        **{k: jnp.asarray(v) for k, v in moved.items()})
    tmoved = tscene._replace(**{k: torch.from_numpy(v)
                                for k, v in moved.items()})
    want = [np.asarray(x) for x in jbvh.refit_bvh_device(jmoved)]
    got = [x.numpy() for x in tbvh.refit_bvh_device(tmoved)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert not np.array_equal(got[0], tscene.bvh_min.numpy())
    tree = tbvh.FlatBVH(got[0], got[1], tscene.bvh_left.numpy(),
                        tscene.bvh_right.numpy())
    tbvh.validate_bvh(tree, *tbvh.primitive_bounds(tmoved))
