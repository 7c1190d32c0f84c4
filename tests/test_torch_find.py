"""The port's cluster-culled find (plain versions of the CUDA kernels on
CPU) against the JAX package: the Pallas kernels in interpret mode and the
brute-force referee, on fuzz and camera wavefronts with dead lanes and
per-ray t_min."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from sexy_raytracer_tpu.models import presets as jpresets  # noqa: E402
from sexy_raytracer_tpu.models.scene import SceneBuilder as JBuilder  # noqa: E402
from sexy_raytracer_tpu.ops import pallas_find as jfind  # noqa: E402
from sexy_raytracer_tpu.ops import intersect as jint  # noqa: E402
from sexy_raytracer_tpu.render.camera import Camera as JCamera  # noqa: E402
from sexy_raytracer_tpu_torch import checks  # noqa: E402
from sexy_raytracer_tpu_torch.models import presets as tpresets  # noqa: E402
from sexy_raytracer_tpu_torch.models.clusters import CLUSTER_SIZE  # noqa: E402
from sexy_raytracer_tpu_torch.models.scene import scene_from_numpy  # noqa: E402
from sexy_raytracer_tpu_torch.ops import find as tfind  # noqa: E402
from sexy_raytracer_tpu_torch.ops import intersect as tint  # noqa: E402
from sexy_raytracer_tpu_torch.ops.find import (  # noqa: E402
    ANY_REGROUP,
    FIND_ANY,
    FIND_CLOSEST,
)

BIG = 3.0e38


def _near_tie_ok(p1, t1, p0, t0):
    """tests/test_pallas_find.py:30-46: winners may differ only on near-
    exact t ties; agreeing hits agree in t."""
    dis = p1 != p0
    assert dis.mean() < 0.01, f"{dis.sum()}/{dis.size} winner mismatches"
    if dis.any():
        tt1 = np.where(np.isfinite(t1[dis]), t1[dis], 1e30)
        tt0 = np.where(np.isfinite(t0[dis]), t0[dis], 1e30)
        near_tie = np.abs(tt1 - tt0) <= 1e-3 * np.minimum(tt1, tt0) + 1e-5
        assert near_tie.all(), "winner mismatch beyond tie tolerance"
    agree = (p1 == p0) & (p0 >= 0)
    np.testing.assert_allclose(t1[agree], t0[agree], rtol=2e-4, atol=1e-4)


@pytest.fixture(scope="module")
def scenes():
    b = JBuilder()
    tpresets.add_relief_mesh(b, 15)
    jpresets._add_ground_and_lights(b)
    jpresets._add_iron_and_metal(b, "/nonexistent-data-dir")
    jscene = b.build(build_bvh=False, device=False)
    return jax.device_put(jscene), scene_from_numpy(jscene, "cpu")


def _fuzz(n, seed):
    r = np.random.default_rng(seed)
    org = r.normal(0, 3.0, (n, 3)) + np.array([0.0, 2.5, 1.0])
    d = r.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    times = r.uniform(0, 1, n)
    t_min = np.where(r.random(n) < 0.15, BIG, r.uniform(0.001, 0.5, n))
    return [x.astype(np.float32) for x in (org, d, times, t_min)]


def _camera(n, seed):
    r = np.random.default_rng(seed)
    cam = JCamera.from_config(jpresets._flagship_camera(), 32 / 24)
    u = jnp.asarray(r.uniform(0.2, 0.8, n), jnp.float32)
    v = jnp.asarray(r.uniform(0.1, 0.9, n), jnp.float32)
    o, d, t = cam.get_rays(u, v, jnp.asarray(r.random((n, 3)), jnp.float32))
    t_min = np.where(r.random(n) < 0.1, BIG, 0.001)
    return [np.asarray(x, np.float32) for x in (o, d, t, t_min)]


def _both(arrs):
    return ([jnp.asarray(a) for a in arrs],
            [torch.from_numpy(np.array(a)) for a in arrs])


WAVEFRONTS = {"fuzz": lambda: _fuzz(2048, 3), "camera": lambda: _camera(2048, 5)}


@pytest.mark.parametrize("wave", sorted(WAVEFRONTS))
def test_clustered_matches_pallas_and_bruteforce(scenes, wave):
    jscene, tscene = scenes
    (jo, jd, jt, jtm), (to, td, tt, ttm) = _both(WAVEFRONTS[wave]())
    before = FIND_CLOSEST.launches
    p_t, t_t = tint.find_hit(tscene, to, td, tt, t_min=ttm)
    assert FIND_CLOSEST.launches == before   # CPU tensors: the plain version
    p_t, t_t = p_t.numpy(), t_t.numpy()
    p_j, t_j = map(np.asarray, jint.find_hit(jscene, jo, jd, jt, t_min=jtm,
                                             method="pallas"))
    _near_tie_ok(p_t, t_t, p_j, t_j)
    p_b, t_b = map(np.asarray, jint.find_hit_bruteforce(jscene, jo, jd, jt,
                                                        t_min=jtm))
    _near_tie_ok(p_t, t_t, p_b, t_b)
    dead = np.asarray(jtm) >= BIG
    assert (p_t[dead] == -1).all() and np.isinf(t_t[dead]).all()
    assert (p_t[~dead] >= 0).mean() > 0.3
    if wave == "camera":
        assert ((p_t >= 0) & (p_t < tscene.num_triangles)).mean() > 0.2


@pytest.mark.parametrize("wave", sorted(WAVEFRONTS))
def test_bruteforce_and_nocull_match(scenes, wave):
    jscene, tscene = scenes
    (jo, jd, jt, jtm), (to, td, tt, ttm) = _both(WAVEFRONTS[wave]())
    p_b, t_b = map(np.asarray, jint.find_hit_bruteforce(jscene, jo, jd, jt,
                                                        t_min=jtm))
    for method in ("bruteforce", "pallas_nocull"):
        p, t = tint.find_hit(tscene, to, td, tt, t_min=ttm, method=method)
        _near_tie_ok(p.numpy(), t.numpy(), p_b, t_b)


def test_cluster_lists_match(scenes):
    jscene, tscene = scenes
    (jo, jd, jt, jtm), (to, td, tt, ttm) = _both(_camera(2048, 9))
    bound_j, _ = jint._sph_candidates(jscene, jo, jd, jt, jtm)
    bound_t, _ = tint._sph_candidates(tscene, to, td, tt, ttm)
    np.testing.assert_allclose(bound_t.numpy(), np.asarray(bound_j),
                               rtol=1e-5)
    # the cull itself, on the same bound: exactly the JAX worklists
    bound_t = torch.from_numpy(np.array(bound_j))
    lj = np.asarray(jfind.cluster_lists(jo, jd, jtm, jscene.cluster_min,
                                        jscene.cluster_max, t_max=bound_j,
                                        ray_block=tfind.RAY_BLOCK))
    lt = tfind.cluster_lists(to, td, ttm, tscene.cluster_min,
                             tscene.cluster_max, t_max=bound_t).numpy()
    assert lt.shape == lj.shape and lt.dtype == np.int32
    np.testing.assert_array_equal(lt[:, 0], lj[:, 0])
    nc = tscene.cluster_min.shape[0]
    for row_t, row_j in zip(lt, lj):
        k = row_t[0]
        np.testing.assert_array_equal(row_t[1:1 + k], row_j[1:1 + k])
        np.testing.assert_array_equal(row_t[1 + nc:1 + nc + k],
                                      row_j[1 + nc:1 + nc + k])
    assert lt[:, 0].max() > 0


def test_packs_match(scenes):
    jscene, tscene = scenes
    jp, nc = jfind._pack_triangles(jscene)
    tp, tnc = tfind._pack_triangles(tscene)
    assert nc == tnc
    # the port's pack is JAX's [NC, 16, CK] transposed: [NC, CK, 16]
    np.testing.assert_array_equal(tp.numpy(),
                                  np.asarray(jp).transpose(0, 2, 1))
    np.testing.assert_array_equal(tfind._pack_spheres(tscene).numpy(),
                                  np.asarray(jfind._pack_spheres(jscene)))


@pytest.mark.parametrize("wave", sorted(WAVEFRONTS))
def test_occluded_matches_pallas(scenes, wave):
    """Lane by lane: equal, or the closest hit is a near tie with the
    emissive bound."""
    jscene, tscene = scenes
    (jo, jd, jt, jtm), (to, td, tt, ttm) = _both(WAVEFRONTS[wave]())
    t_em, _ = jint.emissive_sphere_hit(jscene, jo, jd, jt, jtm)
    alive = np.asarray(jtm) < BIG
    t_em = np.asarray(t_em)
    bound = np.where(alive, np.where(np.isfinite(t_em), t_em, BIG),
                     -BIG).astype(np.float32)
    emis = (np.asarray(jscene.mat_type)[np.asarray(jscene.sph_mat)] == 3)
    occ_j = np.asarray(jfind.find_occluded(
        jscene, jo, jd, jt, jnp.asarray(bound), t_min=jtm,
        sphere_occluder=jnp.asarray(~emis)))
    before = FIND_ANY.launches
    occ_t = tfind.find_occluded(
        tscene, to, td, tt, torch.from_numpy(bound), t_min=ttm,
        sphere_occluder=torch.from_numpy(~emis)).numpy()
    assert FIND_ANY.launches == before
    assert occ_t[~alive].all()
    dis = occ_t != occ_j
    if dis.any():
        p, t = jint.find_hit_bruteforce(jscene, jo, jd, jt, t_min=jtm)
        t = np.asarray(t)[dis]
        b = bound[dis]
        assert (np.abs(t - b) <= 1e-3 * np.minimum(t, b) + 1e-5).all()
    # any-hit contract: occluded exactly when the closest hit is not the
    # emissive prim at the bound
    p_em = np.asarray(jint.emissive_sphere_hit(jscene, jo, jd, jt, jtm)[1])
    p_c = np.asarray(jint.find_hit_bruteforce(jscene, jo, jd, jt,
                                              t_min=jtm)[0])
    want = ~((p_c == p_em) & (p_em >= 0)) & (p_c >= 0) | ~alive
    assert (occ_t == want).mean() > 0.99


@pytest.mark.parametrize("method", ["streamed", "pallas_mxu", "bvh"])
def test_every_method_matches_bruteforce(scenes, method):
    """Every method of the JAX dispatch (intersect.py:254-298) is ported:
    on CPU tensors each runs its plain version and finds the referee's
    closest hit. ``bvh`` needs the scene's tree."""
    jscene, tscene = scenes
    if method == "bvh":
        tscene = scene_from_numpy(
            jax.device_get(jscene)._replace(**_jax_tree(jscene)), "cpu")
    (jo, jd, jt, jtm), (to, td, tt, ttm) = _both(_fuzz(2048, 4))
    p, t = tint.find_hit(tscene, to, td, tt, t_min=ttm, method=method)
    p_b, t_b = map(np.asarray, jint.find_hit_bruteforce(jscene, jo, jd, jt,
                                                        t_min=jtm))
    _near_tie_ok(p.numpy(), t.numpy(), p_b, t_b)
    with pytest.raises(ValueError):
        tint.find_hit(tscene, to, td, tt, method="no-such-method")


def _jax_tree(jscene):
    """The JAX package's BVH of a scene, as its ``bvh_*`` fields."""
    from sexy_raytracer_tpu.models.bvh import build_bvh

    bvh = build_bvh(jax.device_get(jscene))
    return dict(bvh_min=bvh.node_min, bvh_max=bvh.node_max,
                bvh_left=bvh.left, bvh_right=bvh.right, bvh_skip=bvh.skip)


def test_needed_tests_counter_on_a_toy():
    """``checks.needed_tests`` by hand: two clusters of CK = 4
    (the second holds 2 of the 6 triangles), unit boxes at x in [0, 1]
    and [2, 3]. A +x ray with best t 2.5 enters the first box only (4
    tests); the same ray with best 3e38 enters both (6); a +y ray misses
    both; a dead ray and a resolved any-hit lane (state -3e38) need none."""
    from sexy_raytracer_tpu_torch.checks import needed_tests

    cmin = torch.tensor([[0.0, 0.0, 0.0], [2.0, 0.0, 0.0]])
    cmax = torch.tensor([[1.0, 1.0, 1.0], [3.0, 1.0, 1.0]])
    o = [-1.0, 0.5, 0.5]
    rays = torch.tensor([o + [1, 0, 0, 0, 1e-3], o + [1, 0, 0, 0, 1e-3],
                         o + [0, 1, 0, 0, 1e-3], o + [1, 0, 0, 0, BIG],
                         o + [1, 0, 0, 0, 1e-3]], dtype=torch.float32)
    state = torch.tensor([2.5, BIG, BIG, BIG, -BIG])
    assert needed_tests(rays, state, cmin, cmax, 6, 4) == 10
    assert needed_tests(rays[:1], torch.tensor([2.0]), cmin, cmax, 6, 4) == 4
    assert needed_tests(rays[:1], torch.tensor([0.5]), cmin, cmax, 6, 4) == 0


@pytest.mark.parametrize("wave", sorted(WAVEFRONTS))
def test_any_regroup_partitions_the_wavefront(scenes, wave):
    """Kernel 2's regrouping pass (plain version on the CPU): the ray
    table padded to whole blocks and split stably, live rays first; a ray
    is resolved exactly when its bound is negative or an occluder
    sphere's nearest valid root lies before it, and every resolved ray is
    occluded by JAX's ``find_occluded``."""
    jscene, tscene = scenes
    (jo, jd, jt, jtm), (to, td, tt, ttm) = _both(WAVEFRONTS[wave]())
    t_em, _ = jint.emissive_sphere_hit(jscene, jo, jd, jt, jtm)
    t_em = np.asarray(t_em)
    bound = np.where(np.asarray(jtm) < BIG,
                     np.where(np.isfinite(t_em), t_em, BIG),
                     -BIG).astype(np.float32)
    emis = (np.asarray(jscene.mat_type)[np.asarray(jscene.sph_mat)] == 3)
    occ_j = np.asarray(jfind.find_occluded(
        jscene, jo, jd, jt, jnp.asarray(bound), t_min=jtm,
        sphere_occluder=jnp.asarray(~emis)))
    sph = tfind._pack_spheres(tscene, torch.from_numpy(~emis))
    tb = torch.from_numpy(bound)
    before = ANY_REGROUP.launches
    rays, perm, cull_t_min, cull_t_max = tfind.any_regroup(
        to, td, tt, ttm, tb, sph)
    assert ANY_REGROUP.launches == before   # CPU tensors: the plain version
    R, Rpad = 2048, rays.shape[0]
    assert Rpad % tfind.RAY_BLOCK == 0 and rays.shape == (Rpad, 9)
    perm = perm.numpy()
    np.testing.assert_array_equal(np.sort(perm), np.arange(Rpad))
    live = rays[:, 8].numpy() >= 0.0
    n_live = int(live.sum())
    assert live[:n_live].all() and not live[n_live:].any()
    assert (np.diff(perm[:n_live]) > 0).all()
    assert (np.diff(perm[n_live:]) > 0).all()
    # each row is its wavefront ray's, the bound -3e38 once resolved
    table = np.concatenate(
        [np.stack([to.numpy()[:, 0], to.numpy()[:, 1], to.numpy()[:, 2],
                   td.numpy()[:, 0], td.numpy()[:, 1], td.numpy()[:, 2],
                   tt.numpy(), ttm.numpy(), bound], axis=1),
         np.tile(np.array([0, 0, 0, 0, 0, 0, 0, BIG, -BIG], np.float32),
                 (Rpad - R, 1))]).astype(np.float32)
    want = table[perm]
    want[~live, 8] = -BIG
    np.testing.assert_array_equal(rays.numpy(), want)
    # resolved: a negative bound, or an occluder sphere before it
    tc = tfind._sphere_tc(torch.from_numpy(table), sph).numpy()
    by_sphere = (np.where(tc < table[:, 8:9], tc, BIG).min(axis=1) < BIG)
    np.testing.assert_array_equal(~live, (table[perm, 8] < 0) | by_sphere[perm])
    resolved = np.zeros(Rpad, bool)
    resolved[perm] = ~live
    assert occ_j[resolved[:R]].all()
    assert resolved[:R].sum() > 0 and (~resolved[:R]).sum() > 0
    np.testing.assert_array_equal(cull_t_min.numpy(),
                                  np.where(live, want[:, 7], BIG))
    np.testing.assert_array_equal(cull_t_max.numpy(),
                                  np.where(live, want[:, 8], 0.0))


def test_scene_packs_are_derived_once(scenes):
    """The triangle pack and the walk's padded boxes are kept for the
    tensors they came from, and rebuilt for new tensors or after an
    in-place change."""
    _, tscene = scenes
    pack, nc = tfind._pack_triangles(tscene)
    assert tfind._pack_triangles(tscene)[0] is pack
    cmin, cmax = tscene.cluster_min.clone(), tscene.cluster_max.clone()
    boxes = tfind._lane_boxes(cmin, cmax)
    assert tfind._lane_boxes(cmin, cmax) is boxes
    fresh = tfind._lane_boxes(cmin.clone(), cmax)
    assert fresh is not boxes and torch.equal(fresh, boxes)
    cmin += 1.0
    moved = tfind._lane_boxes(cmin, cmax)
    assert moved is not boxes
    assert torch.equal(moved, tfind._lane_boxes(cmin.clone(), cmax.clone()))
    assert not torch.equal(moved, boxes)
    moved_tri = tscene._replace(tri_d=tscene.tri_d + 1.0)
    pack2, _ = tfind._pack_triangles(moved_tri)
    assert pack2 is not pack
    np.testing.assert_array_equal(pack2[..., 3].numpy(),
                                  np.where(pack[..., 0:3].numpy().any(axis=2),
                                           pack[..., 3].numpy() + 1.0, 0.0))


# ---------------------------------------------------------------------------
# kernel 1 on the cluster walk: its plain version (``find_streamed_plain``
# on ``resident_inputs``) on hard wavefronts, against the JAX package
# ---------------------------------------------------------------------------

HARD = ("ties", "per-ray t_min", "dead lanes", "zero components",
        "inside boxes")


def _same_as_bruteforce(tscene, to, td, tt, ttm, p, t):
    """The port's bruteforce referee computes each test in the walk's
    formulas and order: prim ids equal but where an exact t tie falls
    between two clusters (the walk takes the one first in its block's
    list, the referee the lowest id), t bit for bit."""
    p_b, t_b = tint.find_hit_bruteforce(tscene, to, td, tt, t_min=ttm)
    p, t, p_b, t_b = (x.numpy() for x in (p, t, p_b, t_b))
    np.testing.assert_array_equal(t.view(np.int32), t_b.view(np.int32))
    dis = p != p_b
    assert (p[dis] // CLUSTER_SIZE != p_b[dis] // CLUSTER_SIZE).all()


def _edge_margin(tscene, org, dir, prim):
    """Smallest barycentric coordinate, in float64, where each ray meets
    the plane of its triangle ``prim``."""
    v0, v1, v2 = (getattr(tscene, k).numpy().astype(np.float64)[prim]
                  for k in ("tri_v0", "tri_v1", "tri_v2"))
    o, d = org.astype(np.float64), dir.astype(np.float64)
    e1, e2, tv = v1 - v0, v2 - v0, o - v0
    pv = np.cross(d, e2)
    det = (e1 * pv).sum(axis=1)
    u = (tv * pv).sum(axis=1) / det
    v = (d * np.cross(tv, e1)).sum(axis=1) / det
    return np.minimum(np.minimum(u, v), 1.0 - u - v)


# Flipped rays (differing ids, not a near tie) on the ``ties`` wavefront,
# measured against find_hit_clustered and find_hit_bruteforce alike at
# seeds 17 (the test's), 1, 2, 3 and 4 of ``checks.resident_wavefronts``:
# 64, 59, 65, 57 and 66 of 2,048 rays (at most 3.22%). On every one of
# them the nearer of the two hits meets its triangle within 7e-7 of an
# edge (barycentric, float64).
TIES_FLIP_SHARE_MAX = 0.035
EDGE_MARGIN_MAX = 2e-6


def _near_ties_or_edge_flips(tscene, arrs, p_t, t_t, p_j, t_j):
    """Against JAX on rays aimed at the vertices and edges that clusters
    share: a quarter of the closest hits are exact ties, which XLA's
    rounding of the plane and edge sums (a few ulps from torch's, ROADMAP
    queue 3) breaks either way, and on a few rays the edge test itself
    (``q . p - c >= 0`` at 0) falls the other way, so that ray hits the
    next triangle or misses. Differing ids must be near ties, or such an
    edge flip: the nearer hit lies on an edge of its triangle to float32
    rounding, on at most ``TIES_FLIP_SHARE_MAX`` of the rays; agreeing t
    within the JAX package's rule."""
    dis = p_t != p_j
    tt = np.where(np.isfinite(t_t), t_t, 1e30)
    tj = np.where(np.isfinite(t_j), t_j, 1e30)
    near = np.abs(tt - tj) <= 1e-3 * np.minimum(tt, tj) + 1e-5
    flip = dis & ~near
    assert flip.mean() <= TIES_FLIP_SHARE_MAX, f"{flip.sum()} flipped rays"
    nearer = np.where(tt < tj, p_t, p_j)[flip]
    assert ((nearer >= 0) & (nearer < tscene.num_triangles)).all()
    margin = _edge_margin(tscene, arrs[0][flip], arrs[1][flip], nearer)
    assert (np.abs(margin) <= EDGE_MARGIN_MAX).all(), margin
    agree = ~dis & (p_j >= 0)
    np.testing.assert_allclose(t_t[agree], t_j[agree], rtol=2e-4, atol=1e-4)


@pytest.mark.parametrize("wave", HARD)
def test_resident_walk_matches_jax(scenes, wave):
    """Kernel 1's plain walk on 128-ray resident lists against the port's
    bruteforce referee, which computes each test in the same formulas and
    order (prim ids equal but for exact ties between clusters, t bit for
    bit), and against JAX's ``find_hit_clustered`` (the Pallas kernel in
    interpret mode) and ``find_hit_bruteforce``: prim ids equal but for
    near ties, t within the JAX package's rule (rtol 2e-4) where they
    agree, since XLA rounds the plane and edge sums up to 2e-4 apart on
    grazing rays; dead lanes miss."""
    jscene, tscene = scenes
    arrs = checks.resident_wavefronts(tscene)[wave]
    (jo, jd, jt, jtm), (to, td, tt, ttm) = _both(arrs)
    before = FIND_CLOSEST.launches
    p_t, t_t = tint.find_hit(tscene, to, td, tt, t_min=ttm)
    assert FIND_CLOSEST.launches == before   # CPU tensors: the plain version
    _same_as_bruteforce(tscene, to, td, tt, ttm, p_t, t_t)
    p_t, t_t = p_t.numpy(), t_t.numpy()
    T = tscene.num_triangles
    p_j, t_j = map(np.asarray, jfind.find_hit_clustered(jscene, jo, jd, jt,
                                                        t_min=jtm))
    p_b, t_b = map(np.asarray, jint.find_hit_bruteforce(jscene, jo, jd, jt,
                                                        t_min=jtm))
    for p_r, t_r in ((p_j, t_j), (p_b, t_b)):
        if wave == "ties":
            _near_ties_or_edge_flips(tscene, arrs, p_t, t_t, p_r, t_r)
        else:
            _near_tie_ok(p_t, t_t, p_r, t_r)
    dead = np.asarray(jtm) >= BIG
    assert (p_t[dead] == -1).all()
    assert ((p_t >= 0) & (p_t < T)).sum() > 50


@pytest.mark.parametrize("wave", HARD)
def test_resident_walk_without_cull_finds_the_closest_hit(scenes, wave):
    """``pallas_nocull``: every cluster in every row with entry 0, so no
    early out and the per-ray box test alone skips tiles; the same hits
    as the culled walk and the port's bruteforce referee."""
    _, tscene = scenes
    to, td, tt, ttm = (torch.from_numpy(x) for x in
                       checks.resident_wavefronts(tscene)[wave])
    lists = tfind.resident_inputs(tscene, to, td, tt, ttm, cull=False)[0]
    nc = tscene.cluster_min.shape[0]
    assert (lists[:, 0] == nc).all() and (lists[:, 1 + nc:] == 0).all()
    p, t = tint.find_hit(tscene, to, td, tt, t_min=ttm,
                         method="pallas_nocull")
    p_c, _ = tint.find_hit(tscene, to, td, tt, t_min=ttm, method="pallas")
    np.testing.assert_array_equal(p.numpy(), p_c.numpy())
    _same_as_bruteforce(tscene, to, td, tt, ttm, p, t)


@pytest.mark.parametrize("kind", ["no triangles", "spheres only"])
def test_resident_walk_without_triangles(kind):
    """A scene with nothing in it, and one with spheres only: no list
    rows to walk, the spheres' closest hit (JAX's) or a miss."""
    b = JBuilder()
    if kind == "spheres only":
        jpresets._add_ground_and_lights(b)
    jscene = b.build(build_bvh=False, device=False)
    tscene = scene_from_numpy(jscene, "cpu")
    (jo, jd, jt, jtm), (to, td, tt, ttm) = _both(_fuzz(1024, 6))
    lists, rays, pack, boxes, sph, n = tfind.resident_inputs(
        tscene, to, td, tt, ttm)
    assert n == 0 and pack.shape == (0, CLUSTER_SIZE, 16)
    assert boxes.shape == (0, 8) and rays.shape == (1024, 8)
    p, t = tint.find_hit(tscene, to, td, tt, t_min=ttm)
    p_b, t_b = map(np.asarray, jint.find_hit_bruteforce(
        jax.device_put(jscene), jo, jd, jt, t_min=jtm))
    np.testing.assert_array_equal(p.numpy(), p_b)
    if kind == "no triangles":
        assert (p.numpy() == -1).all() and np.isinf(t.numpy()).all()
    else:
        assert (p.numpy() >= 0).sum() > 100
        np.testing.assert_allclose(t.numpy()[p_b >= 0], t_b[p_b >= 0],
                                   rtol=1e-6)


def test_resident_boxes_follow_the_triangles(scenes):
    """Kernel 1's padded boxes come from the triangles as they are now:
    moved in place, the boxes are rebuilt, and the walk finds the moved
    triangles where the cull's (stale) boxes still list them."""
    _, tscene = scenes
    v0, v1, v2 = (x.clone() for x in (tscene.tri_v0, tscene.tri_v1,
                                      tscene.tri_v2))
    boxes = tfind._tri_boxes(v0, v1, v2)
    assert tfind._tri_boxes(v0, v1, v2) is boxes
    cmin, cmax = tscene.cluster_min, tscene.cluster_max
    pad = boxes[:, 0:3] - cmin
    assert (pad < 0).all() and (boxes[:, 4:7] > cmax).all()
    for v in (v0, v1, v2):
        v[:, 1] += 0.25          # in place: the same tensors, new version
    moved = tfind._tri_boxes(v0, v1, v2)
    assert moved is not boxes
    np.testing.assert_allclose((moved[:, 1] - boxes[:, 1]).numpy(), 0.25,
                               atol=1e-5)
    # the scene moved by a small step that its cluster boxes still cover:
    # every hit that the bruteforce referee finds, the walk finds
    from sexy_raytracer_tpu_torch.diff.params import merge_params

    step = torch.tensor([0.0, 1e-3, 0.0])
    small = merge_params(tscene, {k: getattr(tscene, k) + step
                                  for k in ("tri_v0", "tri_v1", "tri_v2")})
    (_, _, _, _), (to, td, tt, ttm) = _both(_camera(2048, 21))
    p, t = tint.find_hit(small, to, td, tt, t_min=ttm, method="pallas")
    p_b, t_b = tint.find_hit_bruteforce(small, to, td, tt, t_min=ttm)
    _near_tie_ok(p.numpy(), t.numpy(), p_b.numpy(), t_b.numpy())


@pytest.mark.parametrize("warp_rays", [32, 64])
def test_walk_counts_on_a_toy(warp_rays):
    """``checks.walk_counts`` by hand, on one 128-ray block of +x rays
    through two unit boxes (clusters of CK = 4, 6 triangles) at x in
    [0, 1] and [2, 3]: both tiles listed for every lane (2 x 128 x 4 = 1024
    listed tests); rays 0-31 live for both boxes, the rest dead, so one
    warp runs the test loop on each tile, 32 rays (kernel 1, one ray a
    lane) or 64 (kernels 8 and 2, two)."""
    cmin = torch.tensor([[0.0, 0.0, 0.0], [2.0, 0.0, 0.0]])
    cmax = torch.tensor([[1.0, 1.0, 1.0], [3.0, 1.0, 1.0]])
    rays = torch.zeros((128, 8))
    rays[:, 0:3] = torch.tensor([-1.0, 0.5, 0.5])
    rays[:, 3] = 1.0
    rays[:, 7] = 1e-3
    rays[32:, 7] = BIG
    pack = torch.zeros((2, 4, 16))           # no triangle faces any ray
    entry = torch.tensor([1.0, 3.0]).view(torch.int32)
    lists = torch.tensor([[2, 0, 1, int(entry[0]), int(entry[1])]],
                         dtype=torch.int32)
    boxes = tfind._lane_boxes(cmin, cmax)
    c = checks.walk_counts(True, (lists, rays, pack, boxes,
                                  torch.zeros((8, 8)), 6), cmin, cmax,
                           warp_rays)
    assert c == dict(listed=1024, executed=2 * warp_rays * 4,
                     live=2 * 32 * 4, needed=32 * 6)


@pytest.mark.parametrize("n_rays", [1, 511, 512, 1300])
@pytest.mark.parametrize("scale", ["unit", "extreme"])
def test_cpu_sphere_blocks_match_one_pass(n_rays, scale, monkeypatch):
    """The plain sphere test runs in blocks (here of 512 rays) and skips
    the rays no root can reach: the same bits as one pass over every ray,
    also for magnitudes where the skip's bound no longer holds (origins
    and directions from 1e-30 to 1e30, t_min near 3e38, inf and NaN)."""
    monkeypatch.setattr(tfind, "_TC_BLOCK_PAIRS", 512 * 37)
    r = np.random.default_rng(n_rays)
    rays = torch.tensor(r.normal(size=(n_rays, 9)), dtype=torch.float32)
    g = torch.Generator().manual_seed(n_rays)
    dead = torch.rand(n_rays, generator=g) < 0.4
    rays[:, 7] = torch.where(dead, 3.0e38, 1e-3)
    if scale == "extreme":
        mag = 10.0 ** torch.randint(-30, 31, (n_rays, 9), generator=g)
        rays[:, :7] = rays[:, :7] * mag[:, :7]
        rays[:, 7] = torch.where(dead, torch.tensor(
            [3.0e38, 1e30, 1e20, 3.4e38])[torch.arange(n_rays) % 4], 1e-3)
        rays[::7, 0] = float("inf")
        rays[::11, 4] = float("nan")
    sph = torch.tensor(r.normal(size=(37, 8)), dtype=torch.float32)
    sph[:, 6] = 0.5
    sph[:, 7] = (torch.arange(37) % 5 != 0).float()
    if scale == "extreme":
        # a sphere of radius 1e18 and dead rays at its surface: half_b^2
        # overflows while a * c does not, so the far root is +inf >= 3e38
        sph[36] = torch.tensor([0, 0, 0, 0, 0, 0, 1e18, 1])
        k = torch.arange(min(n_rays, 4))
        rays[k] = 0.0
        rays[k, 0] = torch.tensor([1e18, 1.1e18, 1e18, 5e17])[k]
        rays[k, 3] = torch.tensor([100.0, 100.0, 30.0, 1000.0])[k]
        rays[k, 7] = 3.0e38
    got = tfind._sphere_tc(rays, sph)
    want = tfind._sphere_tc_block(rays, sph)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert n_rays < 500 or bool((got < BIG).any())


def test_cpu_emissive_hit_matches_the_masked_pass():
    """``emissive_sphere_hit`` tests the emissive spheres alone: the same t
    bits and the same winner (the first of equal roots) as the masked pass
    over every sphere, with two lights at one place, a light behind
    another and a scene with no light; with its index given or not."""
    from sexy_raytracer_tpu_torch.models.scene import (
        MAT_LIGHT,
        SceneBuilder,
    )

    b = SceneBuilder()
    light = b.add_light_material(color=(4.0, 4.0, 4.0))
    grey = b.add_pbr_material()
    for c, m in (((0, 0, -5), grey), ((0, 0, -6), light), ((1, 0, -6), grey),
                 ((0, 0, -6), light), ((0, 0, -9), light), ((2, 1, -4), grey)):
        b.add_sphere(c, 1.0, m, center1=(c[0], c[1] + 0.3, c[2]))
    scene = b.build(build_bvh=False, device="cpu")
    org, d, t, _ = (torch.from_numpy(x) for x in _fuzz(2048, 3))
    d = torch.where(torch.rand(2048, 1) < 0.5,
                    torch.tensor([0.0, 0.0, -1.0]) + 0.1 * d, d)
    t_min = torch.full((2048,), 1e-3)
    emis = scene.mat_type[scene.sph_mat.long()] == MAT_LIGHT
    for sc in (scene, scene._replace(mat_type=torch.zeros_like(
            scene.mat_type))):
        e = emis if sc is scene else torch.zeros_like(emis)
        root, valid = tint.sphere_roots(sc, org, d, t, t_min)
        t_want, a_want = torch.min(
            torch.where(valid & e[None, :], root, float("inf")), dim=1)
        a_want = torch.where(torch.isfinite(t_want), a_want, -1)
        for given in (None, tint.emissive_spheres(sc)):
            t_got, p_got = tint.emissive_sphere_hit(sc, org, d, t, t_min,
                                                    given)
            assert torch.equal(t_got.view(torch.int32),
                               t_want.view(torch.int32))
            assert torch.equal(p_got, a_want.to(torch.int32))
        assert bool((p_got >= 0).any()) == (sc is scene)
