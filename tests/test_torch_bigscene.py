"""The port's big-scene hit search against the JAX package: the per-block
interval cull, the streamed cluster find (plain version of its CUDA
kernel), the size dispatch of ``find_hit``, the block-culled resident
find and occlusion, the brute-force weight-stack find, and a 4-bounce
trace through all of them. The JAX side runs as its own tests run it:
Pallas in interpret mode.

Tolerances: worklists are exact (the interval cull is single IEEE
operations in both packages); prim ids are exact or a near tie,
``|t - t_ref| <= 1e-3 min(t) + 1e-5``, with agreeing hits within rtol
2e-4, atol 1e-4 (tests/test_pallas_find.py:30-46); radiance as
tests/test_torch_render.py (0.5% of rays may leave atol 2e-5, rtol 1e-5
where an f32 edge flips a path).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from sexy_raytracer_tpu.models import presets as jpresets  # noqa: E402
from sexy_raytracer_tpu.models.scene import SceneBuilder as JBuilder  # noqa: E402
from sexy_raytracer_tpu.ops import intersect as jint  # noqa: E402
from sexy_raytracer_tpu.ops import pallas_find as jfind  # noqa: E402
from sexy_raytracer_tpu.ops.pallas_intersect import (  # noqa: E402
    _build_weights,
    find_hit_pallas,
)
from sexy_raytracer_tpu.render import integrator as jintegrator  # noqa: E402
from sexy_raytracer_tpu.render.camera import Camera as JCamera  # noqa: E402
from sexy_raytracer_tpu.utils import rng as jrng  # noqa: E402
from sexy_raytracer_tpu_torch.models import presets as tpresets  # noqa: E402
from sexy_raytracer_tpu_torch.models.scene import scene_from_numpy  # noqa: E402
from sexy_raytracer_tpu_torch.ops import brute as tbrute  # noqa: E402
from sexy_raytracer_tpu_torch.ops import find as tfind  # noqa: E402
from sexy_raytracer_tpu_torch.ops import intersect as tint  # noqa: E402
from sexy_raytracer_tpu_torch.render import integrator as tintegrator  # noqa: E402

BIG = 3.0e38


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The plain versions here work on small tensors; one intra-op thread
    keeps them from contending with the suite's other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _near_tie_ok(p1, t1, p0, t0):
    """Winners may differ only on near-exact t ties; agreeing hits agree
    in t (tests/test_pallas_find.py:30-46)."""
    dis = p1 != p0
    assert dis.mean() < 0.01, f"{dis.sum()}/{dis.size} winner mismatches"
    if dis.any():
        tt1 = np.where(np.isfinite(t1[dis]), t1[dis], 1e30)
        tt0 = np.where(np.isfinite(t0[dis]), t0[dis], 1e30)
        near_tie = np.abs(tt1 - tt0) <= 1e-3 * np.minimum(tt1, tt0) + 1e-5
        assert near_tie.all(), "winner mismatch beyond tie tolerance"
    agree = (p1 == p0) & (p0 >= 0)
    np.testing.assert_allclose(t1[agree], t0[agree], rtol=2e-4, atol=1e-4)


def _standin(n):
    """(JAX scene, port scene on the CPU): the relief of n x n quads in
    the flagship composition, without a BVH."""
    b = JBuilder()
    tpresets.add_relief_mesh(b, n)
    jpresets._add_ground_and_lights(b)
    jpresets._add_iron_and_metal(b, "/nonexistent-data-dir")
    jscene = b.build(build_bvh=False, device=False)
    return jax.device_put(jscene), scene_from_numpy(jscene, "cpu")


@pytest.fixture(scope="module")
def relief39():
    return _standin(39)        # 3,042 triangles, 12 clusters


@pytest.fixture(scope="module")
def soup():
    """tests/test_pallas_find.py:185-199: a 9,000-triangle soup (36
    clusters) and a sphere, 1,024 rays."""
    r = np.random.default_rng(1234)
    T = 9000
    c = r.uniform(-8, 8, (T, 3))
    v = [c + r.normal(0, 0.15, (T, 3)) for _ in range(3)]
    b = JBuilder()
    m = b.add_pbr_material(base_color=(0.5, 0.5, 0.5, 1.0))
    idx = np.stack([np.arange(T), np.arange(T) + T, np.arange(T) + 2 * T], 1)
    b.add_mesh(np.concatenate(v), None, idx, m)
    b.add_sphere((0, 0, -14), 2.0, m)
    jscene = b.build(build_bvh=False, device=False)
    org = r.normal(0, 8.0, (1024, 3))
    d = r.normal(size=(1024, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    times = r.uniform(0, 1, 1024)
    rays = [x.astype(np.float32) for x in (org, d, times)]
    return jax.device_put(jscene), scene_from_numpy(jscene, "cpu"), rays


def _rays(kind, n=1024, seed=3):
    """(org, dir, t_min) around the relief: random, axis-aligned or dead."""
    r = np.random.default_rng(seed)
    org = r.normal(0, 2.0, (n, 3)) + np.array([0.0, 2.5, 1.0])
    d = r.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    if kind == "axis":
        d = np.zeros((n, 3))
        d[np.arange(n), r.integers(0, 3, n)] = r.choice([-1.0, 1.0], n)
    t_min = np.where(r.random(n) < 0.1, BIG, 1e-3)
    if kind == "dead":
        t_min = np.full(n, BIG)
    return [x.astype(np.float32) for x in (org, d, t_min)]


def _both(arrs):
    return ([jnp.asarray(a) for a in arrs],
            [torch.from_numpy(np.array(a)) for a in arrs])


@pytest.mark.parametrize("kind", ["random", "axis", "dead"])
def test_cluster_lists_block_matches_jax(relief39, kind):
    """The interval cull's worklists equal JAX's, and each block's active
    set holds the exact per-ray cull's (test_block_cull_superset_of_exact,
    which needs the chief asset, on the relief)."""
    jscene, tscene = relief39
    (jo, jd, jtm), (to, td, ttm) = _both(_rays(kind))
    cmin, cmax = tscene.cluster_min, tscene.cluster_max
    bound = np.where(np.asarray(jtm) < BIG, 6.0, -BIG).astype(np.float32)
    for t_max in (None, bound):
        lj = np.asarray(jfind.cluster_lists_block(
            jo, jd, jtm, jscene.cluster_min, jscene.cluster_max,
            t_max=None if t_max is None else jnp.asarray(t_max),
            ray_block=tfind.RAY_BLOCK))
        lt = tfind.cluster_lists_block(
            to, td, ttm, cmin, cmax,
            t_max=None if t_max is None else torch.from_numpy(t_max)).numpy()
        assert lt.dtype == np.int32 and lt.shape == lj.shape == (8, 25)
        np.testing.assert_array_equal(lt, lj)
        exact = tfind.cluster_lists(
            to, td, ttm, cmin, cmax,
            t_max=None if t_max is None else torch.from_numpy(t_max)).numpy()
        for row_e, row_b in zip(exact, lt):
            assert set(row_e[1:1 + row_e[0]]) <= set(row_b[1:1 + row_b[0]])
    if kind == "dead":
        assert (lt[:, 0] == 0).all()
    else:
        assert lt[:, 0].min() > 0


@pytest.mark.parametrize("max_supers", [1024, 2])
def test_streamed_matches_jax(soup, monkeypatch, max_supers):
    """Port's plain streamed find vs JAX's interpret run; at MAX_SUPERS = 2
    JAX doubles its supercluster to 32 clusters (2 slabs). The port's walk
    does not depend on it: its lists hold single clusters for blocks of
    STREAM_RAY_BLOCK rays."""
    jscene, tscene, rays = soup
    monkeypatch.setattr(jfind, "MAX_SUPERS", max_supers)
    (jo, jd, jt), (to, td, tt) = _both(rays)
    p_j, t_j = map(np.asarray, jfind.find_hit_streamed(jscene, jo, jd, jt))
    before = tfind.FIND_STREAMED.launches
    p_t, t_t = tfind.find_hit_streamed(tscene, to, td, tt)
    assert tfind.FIND_STREAMED.launches == before  # CPU: the plain version
    p_t, t_t = p_t.numpy(), t_t.numpy()
    _near_tie_ok(p_t, t_t, p_j, t_j)
    p_b, t_b = tint.find_hit_bruteforce(tscene, to, td, tt)
    np.testing.assert_array_equal(p_t, p_b.numpy())
    assert (p_t >= 0).sum() > 50 and (p_t == tscene.num_triangles).any()
    # the walk's grouping: one list entry per 256-triangle cluster, one
    # row per block of STREAM_RAY_BLOCK rays; the pack's tiles as they are
    nc = tscene.cluster_min.shape[0]
    lists, rays_t, pack, boxes, _, _ = tfind.streamed_inputs(
        tscene, to, td, tt)
    assert nc == 36 and pack.shape == (nc, 256, 16) and boxes.shape == (nc, 8)
    assert lists.shape == (1024 // tfind.STREAM_RAY_BLOCK, 1 + 2 * nc)
    assert rays_t.shape == (1024, 8) and lists[:, 0].max() <= nc


def test_auto_dispatches_streamed_past_the_resident_limit(relief39,
                                                          monkeypatch):
    """``auto`` takes the streamed find once T > PALLAS_RESIDENT_MAX_TRIS
    (intersect.py:269-277), and the resident find below it."""
    _, tscene = relief39
    calls = []

    def spy(*args, **kw):
        calls.append("streamed")
        return real(*args, **kw)

    real = tfind.find_hit_streamed
    monkeypatch.setattr(tfind, "find_hit_streamed", spy)
    (_, _, _), (to, td, ttm) = _both(_rays("random", 256))
    time = torch.zeros(256)
    p_res, _ = tint.find_hit(tscene, to, td, time, t_min=ttm)
    assert calls == []
    monkeypatch.setattr(tint, "PALLAS_RESIDENT_MAX_TRIS", 0)
    p_str, _ = tint.find_hit(tscene, to, td, time, t_min=ttm)
    assert calls == ["streamed"]
    np.testing.assert_array_equal(p_str.numpy(), p_res.numpy())


@pytest.mark.parametrize("query", ["closest", "occluded"])
def test_block_cull_above_per_ray_limit_matches_jax(relief39, monkeypatch,
                                                    query):
    """Past PER_RAY_CULL_MAX_CLUSTERS (patched to 4 in both packages) the
    resident find and the occlusion query run on block-culled lists."""
    jscene, tscene = relief39
    monkeypatch.setattr(jfind, "PER_RAY_CULL_MAX_CLUSTERS", 4)
    monkeypatch.setattr(tfind, "PER_RAY_CULL_MAX_CLUSTERS", 4)
    seen = []
    real = tfind.cluster_lists_block
    monkeypatch.setattr(tfind, "cluster_lists_block",
                        lambda *a, **k: seen.append(1) or real(*a, **k))
    r = np.random.default_rng(8)
    rays = _rays("random", 1024, seed=5)
    time = r.uniform(0, 1, 1024).astype(np.float32)
    (jo, jd, jtm), (to, td, ttm) = _both(rays)
    jt, tt = jnp.asarray(time), torch.from_numpy(time)
    if query == "closest":
        p_j, t_j = map(np.asarray, jint.find_hit(jscene, jo, jd, jt,
                                                 t_min=jtm, method="pallas"))
        p_t, t_t = tint.find_hit(tscene, to, td, tt, t_min=ttm)
        _near_tie_ok(p_t.numpy(), t_t.numpy(), p_j, t_j)
        assert ((p_t >= 0) & (p_t < tscene.num_triangles)).sum() > 20
    else:
        t_em, _ = jint.emissive_sphere_hit(jscene, jo, jd, jt, jtm)
        t_em = np.asarray(t_em)
        alive = np.asarray(jtm) < BIG
        bound = np.where(alive, np.where(np.isfinite(t_em), t_em, BIG),
                         -BIG).astype(np.float32)
        emis = (np.asarray(jscene.mat_type)[np.asarray(jscene.sph_mat)] == 3)
        occ_j = np.asarray(jfind.find_occluded(
            jscene, jo, jd, jt, jnp.asarray(bound), t_min=jtm,
            sphere_occluder=jnp.asarray(~emis)))
        occ_t = tfind.find_occluded(
            tscene, to, td, tt, torch.from_numpy(bound), t_min=ttm,
            sphere_occluder=torch.from_numpy(~emis)).numpy()
        dis = occ_t != occ_j
        if dis.any():  # only where the closest hit is a near tie with t_em
            _, t_c = jint.find_hit_bruteforce(jscene, jo, jd, jt, t_min=jtm)
            t_c, b = np.asarray(t_c)[dis], bound[dis]
            assert (np.abs(t_c - b) <= 1e-3 * np.minimum(t_c, b) + 1e-5).all()
        assert occ_t[~alive].all() and (~occ_t).sum() > 10
    assert seen, "the block cull did not run"


@pytest.mark.parametrize("t_min", [None, 0.05])
def test_brute_matches_jax(relief39, t_min):
    """The weight-stack brute-force find (plain version of kernel 9) vs
    JAX's ``find_hit_pallas`` in interpret mode."""
    jscene, tscene = relief39
    (jo, jd, _), (to, td, _) = _both(_rays("random", 1024, seed=11))
    r = np.random.default_rng(12)
    time = r.uniform(0, 1, 1024).astype(np.float32)
    jt, tt = jnp.asarray(time), torch.from_numpy(time)
    np.testing.assert_array_equal(tbrute.build_weights(tscene).numpy(),
                                  np.asarray(_build_weights(jscene)[0]))
    p_j, t_j = map(np.asarray, find_hit_pallas(jscene, jo, jd, jt,
                                               t_min=t_min))
    before = tbrute.TRI_BRUTE.launches
    p_t, t_t = tint.find_hit(tscene, to, td, tt, t_min=t_min,
                             method="pallas_mxu")
    assert tbrute.TRI_BRUTE.launches == before
    _near_tie_ok(p_t.numpy(), t_t.numpy(), p_j, t_j)
    assert ((p_t >= 0) & (p_t < tscene.num_triangles)).sum() > 50
    p_b, t_b = tint.find_hit_bruteforce(tscene, to, td, tt, t_min=t_min)
    _near_tie_ok(p_t.numpy(), t_t.numpy(), p_b.numpy(), t_b.numpy())


def test_brute_per_ray_t_min_goes_to_bruteforce(relief39, monkeypatch):
    """A per-ray t_min skips the kernel in both packages
    (pallas_intersect.py:177-181)."""
    jscene, tscene = relief39
    (jo, jd, jtm), (to, td, ttm) = _both(_rays("random", 256, seed=13))
    jt = jnp.zeros(256)
    p_j, _ = find_hit_pallas(jscene, jo, jd, jt, t_min=jtm)
    p_jb, _ = jint.find_hit_bruteforce(jscene, jo, jd, jt, t_min=jtm)
    np.testing.assert_array_equal(np.asarray(p_j), np.asarray(p_jb))
    monkeypatch.setattr(tbrute, "tri_brute", None)  # must not be called
    p, t = tint.find_hit(tscene, to, td, torch.zeros(256), t_min=ttm,
                         method="pallas_mxu")
    p_b, t_b = tint.find_hit_bruteforce(tscene, to, td, torch.zeros(256),
                                        t_min=ttm)
    np.testing.assert_array_equal(p.numpy(), p_b.numpy())


@pytest.mark.parametrize("vis", [False, True])
def test_trace_through_the_big_scene_path_matches_jax(monkeypatch, vis):
    """The slice as a whole: 2,048 flagship-camera paths, 4 bounces, on
    the relief at n = 67 (8,978 triangles, 36 clusters).
    The port runs ``auto`` with both limits patched, so it goes through
    the streamed find and the block cull; JAX runs ``streamed`` with its
    cull limit patched alike."""
    jscene, tscene = _standin(67)
    assert tscene.cluster_min.shape[0] == 36
    monkeypatch.setattr(tint, "PALLAS_RESIDENT_MAX_TRIS", 0)
    monkeypatch.setattr(tfind, "PER_RAY_CULL_MAX_CLUSTERS", 4)
    monkeypatch.setattr(jfind, "PER_RAY_CULL_MAX_CLUSTERS", 4)
    streamed = []
    real = tfind.find_hit_streamed
    monkeypatch.setattr(tfind, "find_hit_streamed",
                        lambda *a, **k: streamed.append(1) or real(*a, **k))

    cam = JCamera.from_config(jpresets._flagship_camera(), 32 / 24)
    R = 2048
    pid = jnp.arange(R, dtype=jnp.int32) % (32 * 24)
    keys = jrng.ray_keys_2d(jax.random.key(7), pid, pid // (32 * 24))
    ucam = jrng.per_ray_uniform_block(keys, 5)
    u = ((pid % 32).astype(jnp.float32) + ucam[..., 0]) / 31
    v = ((24 - pid // 32).astype(jnp.float32) + ucam[..., 1]) / 23
    org, dirs, times = cam.get_rays(u, v, ucam[..., 2:5])
    bg = (0.5, 0.7, 0.9)
    want = np.asarray(jintegrator.trace_rays_fused(
        jscene, org, dirs, times, keys, jnp.asarray(bg, jnp.float32), 4,
        method="streamed", last_bounce_vis=vis))
    got = tintegrator.trace_rays_fused(
        tscene, *(torch.from_numpy(np.array(x)) for x in (org, dirs, times)),
        torch.from_numpy(np.asarray(jax.random.key_data(keys), np.int64)),
        torch.tensor(bg), 4, last_bounce_vis=vis).numpy()
    assert len(streamed) == (3 if vis else 4)
    assert got.shape == want.shape == (R, 3) and np.isfinite(got).all()
    close = np.isclose(got, want, atol=2e-5, rtol=1e-5).all(axis=1)
    assert close.mean() >= 0.995, f"{(~close).sum()}/{R} rays outside"
    assert got.max() > 0.1


@pytest.mark.parametrize("kind", ["random", "axis"])
def test_cluster_lists_cover_exact_actives(soup, kind):
    """The streamed walk's lists (the interval cull over single clusters,
    STREAM_RAY_BLOCK-ray blocks) hold every cluster that the exact per-ray
    cull activates for a ray of the block, and their entry distances do
    not exceed the exact cull's block minimum."""
    _, tscene, rays = soup
    r = np.random.default_rng(21)
    org = torch.from_numpy(rays[0])
    d = torch.from_numpy(rays[1])
    if kind == "axis":
        dn = np.zeros((1024, 3), np.float32)
        dn[np.arange(1024), r.integers(0, 3, 1024)] = r.choice([-1.0, 1.0],
                                                               1024)
        d = torch.from_numpy(dn)
    t_min = torch.from_numpy(np.where(r.random(1024) < 0.1, BIG, 1e-3)
                             .astype(np.float32))
    time = torch.from_numpy(rays[2])
    lists = tfind.streamed_inputs(tscene, org, d, time, t_min)[0].numpy()
    bound, _ = tint._sph_candidates(tscene, org, d, time, t_min)
    exact = tfind.cluster_lists(org, d, t_min, tscene.cluster_min,
                                tscene.cluster_max, t_max=bound,
                                ray_block=tfind.STREAM_RAY_BLOCK).numpy()
    nc = tscene.cluster_min.shape[0]
    assert lists.shape == exact.shape
    for row_b, row_e in zip(lists, exact):
        kb, ke = row_b[0], row_e[0]
        ent_b = dict(zip(row_b[1:1 + kb], row_b[1 + nc:1 + nc + kb]))
        assert set(row_e[1:1 + ke]) <= set(ent_b)
        for c, e in zip(row_e[1:1 + ke], row_e[1 + nc:1 + nc + ke]):
            assert ent_b[c] <= e
        assert (np.diff(row_b[1 + nc:1 + nc + kb]) >= 0).all()
    assert exact[:, 0].sum() > 0


def _occlusion_wave(kind, n=1024, seed=31):
    """(org, dir, time, t_min, bound) over the relief: 'sphere' aims 85%
    of the rays down into the ground sphere, 'dead' marks every ray
    dead."""
    r = np.random.default_rng(seed)
    org = r.normal(0, 2.0, (n, 3)) + np.array([0.0, 2.5, 1.0])
    d = r.normal(size=(n, 3))
    down = r.random(n) < 0.85
    d[down, 1] = -np.abs(d[down, 1]) - 2.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    time = r.uniform(0, 1, n)
    t_min = np.where(r.random(n) < 0.05, BIG, 1e-3)
    bound = np.where(r.random(n) < 0.5, BIG, r.uniform(0.5, 20.0, n))
    bound = np.where(t_min < BIG, bound, -BIG)
    if kind == "dead":
        bound = np.full(n, -BIG)
    return [x.astype(np.float32) for x in (org, d, time, t_min, bound)]


@pytest.mark.parametrize("kind", ["sphere", "dead"])
def test_regrouped_occlusion_matches_jax(relief39, kind):
    """The regrouped any-hit walk (plain version of kernel 2) equals JAX's
    ``find_occluded`` flag for flag, on a wavefront whose rays mostly die
    on the ground sphere and on an all-dead one; resolved rays leave the
    cull (their blocks get empty lists) and the flags go back to each
    ray's own index; the flags are also those that the closest hits
    imply (``checks.occlusion_by_closest_hit``)."""
    from sexy_raytracer_tpu_torch.checks import occlusion_by_closest_hit

    jscene, tscene = relief39
    arrs = _occlusion_wave(kind)
    (jo, jd, jt, jtm, jb), (to, td, tt, ttm, tb) = _both(arrs)
    emis = (np.asarray(jscene.mat_type)[np.asarray(jscene.sph_mat)] == 3)
    occ_j = np.asarray(jfind.find_occluded(
        jscene, jo, jd, jt, jb, t_min=jtm,
        sphere_occluder=jnp.asarray(~emis)))
    inp = tfind.occluded_inputs(tscene, to, td, tt, tb, t_min=ttm,
                                sphere_occluder=torch.from_numpy(~emis))
    lists, rays_c, perm = inp[0], inp[1], inp[2]
    occ_t = tfind.find_any(*inp)[:1024].numpy() > 0
    np.testing.assert_array_equal(occ_t, occ_j)
    np.testing.assert_array_equal(
        occ_t, occlusion_by_closest_hit(tscene, to, td, tt, ttm, tb,
                                        torch.from_numpy(~emis)).numpy())
    np.testing.assert_array_equal(np.sort(perm.numpy()), np.arange(1024))
    live = (rays_c[:, 8] >= 0.0).numpy()
    n_live = int(live.sum())
    assert live[:n_live].all() and not live[n_live:].any()
    assert (np.diff(perm.numpy()[:n_live]) > 0).all()  # wavefront order
    first_dead_block = -(-n_live // tfind.RAY_BLOCK)
    assert (lists[first_dead_block:, 0] == 0).all()
    if kind == "dead":
        assert occ_t.all() and n_live == 0
    else:
        assert 0.05 < n_live / 1024 < 0.5 and (~occ_t).sum() > 10


def test_interval_cull_in_groups_matches_one_pass(relief39, monkeypatch):
    """Past CULL_PAIRS_MAX (block, box) pairs the interval cull runs over
    groups of blocks; the rows are those of one pass."""
    _, tscene = relief39
    (_, _, _), (to, td, ttm) = _both(_rays("random", 1000, seed=17))
    bound = torch.where(ttm < BIG, 6.0, -BIG)
    cmin, cmax = tscene.cluster_min, tscene.cluster_max
    whole = tfind.cluster_lists_block(to, td, ttm, cmin, cmax, t_max=bound)
    monkeypatch.setattr(tfind, "CULL_PAIRS_MAX", 3 * cmin.shape[0])
    grouped = tfind.cluster_lists_block(to, td, ttm, cmin, cmax, t_max=bound)
    assert whole.shape == (8, 25)
    assert torch.equal(grouped, whole)
