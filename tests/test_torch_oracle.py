"""The port's numpy oracle (``oracle/reference.py``): the copy against the
JAX package's original on the same scene and random stream, bit for bit,
and the JAX package's kernel-vs-oracle tests (``tests/test_intersect.py``,
``tests/test_shade.py``, ``tests/test_render.py``) on the port's CPU path
with the port's oracle as the referee."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from sexy_raytracer_tpu.models.scene import SceneBuilder as JBuilder  # noqa: E402
from sexy_raytracer_tpu.oracle import reference as joracle  # noqa: E402
from sexy_raytracer_tpu_torch.models import presets as tpresets  # noqa: E402
from sexy_raytracer_tpu_torch.models.scene import SceneBuilder  # noqa: E402
from sexy_raytracer_tpu_torch.ops.intersect import (  # noqa: E402
    find_hit_bruteforce,
    hit_data,
)
from sexy_raytracer_tpu_torch.ops.shade import shade  # noqa: E402
from sexy_raytracer_tpu_torch.oracle import Oracle  # noqa: E402
from sexy_raytracer_tpu_torch.oracle import reference as oracle  # noqa: E402
from sexy_raytracer_tpu_torch.render.camera import Camera  # noqa: E402
from sexy_raytracer_tpu_torch.render.renderer import render_accumulate  # noqa: E402
from sexy_raytracer_tpu_torch.utils.config import (  # noqa: E402
    CameraConfig,
    RenderConfig,
)


def _t(x):
    return torch.as_tensor(np.asarray(x, np.float32))


def random_scene(B, rng, n_tris=20, n_sph=10, moving=False):
    """tests/test_intersect.py's fuzz scene, for either builder."""
    b = B()
    mat = b.add_pbr_material(base_color=(0.5, 0.5, 0.5, 1.0))
    for _ in range(n_tris):
        v = rng.normal(size=(3, 3)) * 2.0
        uv = rng.random((3, 2))
        b.add_mesh(v, uv, [[0, 1, 2]], mat)
    for _ in range(n_sph):
        c = rng.normal(size=3) * 3.0
        c1 = c + rng.normal(size=3) * 0.5 if moving else None
        b.add_sphere(c, 0.3 + rng.random(), mat, center1=c1)
    return b


def _port(B_fn, *a, **kw):
    return B_fn(SceneBuilder, *a, **kw).build(build_bvh=False, device="cpu")


def random_rays(rng, n):
    return rng.normal(size=(n, 3)) * 5.0, rng.normal(size=(n, 3)), \
        rng.random(n)


def oracle_closest(scene, o, d, time, t_min=0.001):
    """True closest hit over all primitives (no traversal-order quirk)."""
    best_t, best_prim, best_rec = np.inf, -1, None
    T = scene.tri_v0.shape[0]
    for i in range(T):
        rec = oracle.triangle_hit(scene, i, o, d, t_min, np.inf)
        if rec is not None and rec.t < best_t:
            best_t, best_prim, best_rec = rec.t, i, rec
    for s in range(scene.sph_c0.shape[0]):
        rec = oracle.sphere_hit(scene, s, o, d, time, t_min, np.inf)
        if rec is not None and rec.t < best_t:
            best_t, best_prim, best_rec = rec.t, T + s, rec
    return best_prim, best_t, best_rec


def build_material_zoo(B):
    """tests/test_shade.py's scene: one sphere per material kind and
    texture slot."""
    b = B()
    checker = b.add_checker_texture((0.2, 0.3, 0.1), (0.9, 0.9, 0.9))
    b.add_sphere((0, 0, 0), 1.0, b.add_pbr_material(albedo_tex=checker))
    b.add_sphere((3, 0, 0), 1.0, b.add_metal_material((0.7, 0.6, 0.5), 0.3))
    b.add_sphere((6, 0, 0), 1.0, b.add_dielectric_material(1.5))
    b.add_sphere((9, 0, 0), 1.0, b.add_light_material(color=(5.0, 4.0, 3.0)))
    img = (np.arange(16 * 16 * 3).reshape(16, 16, 3) * 17) % 256
    albedo_tex = b.add_image_texture(img.astype(np.uint8))
    normal_img = np.full((8, 8, 3), 128, np.uint8)
    normal_img[..., 2] = 255
    normal_tex = b.add_image_texture(normal_img)
    metal_img = np.zeros((8, 8, 3), np.uint8)
    metal_img[..., 0] = 200
    rough_img = np.zeros((8, 8, 3), np.uint8)
    rough_img[..., 1] = 100
    pbr_full = b.add_pbr_material(
        albedo_tex=albedo_tex, normal_tex=normal_tex,
        metallic_tex=b.add_image_texture(metal_img),
        roughness_tex=b.add_image_texture(rough_img),
        base_color=(0.9, 0.8, 0.7, 1.0))
    b.add_sphere((0, 0, 4), 1.0, pbr_full)
    b.add_sphere((3, 0, 4), 1.0, b.add_pbr_material(
        albedo_tex=b.add_solid_texture((0.4, 0.2, 0.1))))
    b.add_sphere((6, 0, 4), 1.0, b.add_pbr_material(
        base_color=(0.8, 0.8, 0.8, 1.0), metallic=0.3, roughness=0.4))
    emit_checker = b.add_checker_texture((0.02, 0.01, 0.0), (0.0, 0.01, 0.02))
    b.add_sphere((9, 0, 4), 1.0, b.add_light_material(emit_tex=emit_checker))
    emit_img = ((np.arange(8 * 8 * 3).reshape(8, 8, 3) * 31) % 256)
    b.add_sphere((0, 0, 8), 1.0, b.add_light_material(
        emit_tex=b.add_image_texture(emit_img.astype(np.uint8))))
    slot_checker = b.add_checker_texture((0.9, 0.2, 0.4), (0.1, 0.8, 0.6))
    slot_solid = b.add_solid_texture((180.0, 90.0, 30.0))
    b.add_sphere((3, 0, 8), 1.0, b.add_pbr_material(
        base_color=(0.6, 0.6, 0.6, 1.0), metallic_tex=slot_checker,
        roughness_tex=slot_checker, normal_tex=slot_solid))
    b.add_sphere((6, 0, 8), 1.0, b.add_pbr_material(
        base_color=(0.5, 0.5, 0.9, 1.0), metallic_tex=slot_solid,
        roughness_tex=slot_solid, normal_tex=slot_checker))
    return b


def small_scene(B):
    """tests/test_render.py's scene."""
    b = B()
    checker = b.add_checker_texture((0.2, 0.3, 0.1), (0.9, 0.9, 0.9))
    b.add_sphere((0, -1000, 0), 1000.0, b.add_pbr_material(albedo_tex=checker))
    b.add_sphere((-2, 1, 0), 1.0, b.add_light_material(color=(10.0, 9.0, 7.0)))
    b.add_sphere((2, 1, 0), 1.0, b.add_metal_material((0.7, 0.6, 0.5), 0.0))
    b.add_sphere((0, 1, 0), 1.0, b.add_dielectric_material(1.5))
    mat = b.add_pbr_material(base_color=(0.9, 0.3, 0.3, 1.0))
    b.add_mesh([[-1, 0, -2], [1, 0, -2], [0, 2, -2]], None, [[0, 1, 2]], mat)
    return b


# -- the copy against the original -----------------------------------------

def _rec_fields(rec):
    if rec is None:
        return None
    return [np.asarray(getattr(rec, k), np.float64).tobytes()
            for k in oracle.HitRec.__slots__]


@pytest.mark.parametrize("scene_name", ["fuzz", "zoo", "small", "shirley"])
def test_oracle_copy_matches_original(scene_name):
    """Hits, scatters, emission and whole paths: the port's oracle on a
    port scene gives the original's float64 bits on the JAX scene."""
    if scene_name == "fuzz":
        make = lambda B: random_scene(B, np.random.default_rng(3),  # noqa
                                      moving=True)
    elif scene_name == "zoo":
        make = build_material_zoo
    elif scene_name == "small":
        make = small_scene
    if scene_name == "shirley":
        from sexy_raytracer_tpu.models import presets as jpresets

        tscene, _ = tpresets.shirley_parity(height=18, spp=1, device="cpu")
        jscene = jpresets.shirley_parity(height=18, spp=1)[0]
    else:
        tscene = make(SceneBuilder).build(build_bvh=False, device="cpu")
        jscene = make(JBuilder).build(build_bvh=False)
    t_np, j_np = oracle._as_numpy(tscene), joracle._as_numpy(jscene)
    for name in j_np._fields:
        np.testing.assert_array_equal(getattr(t_np, name),
                                      getattr(j_np, name), err_msg=name)

    r = np.random.default_rng(11)
    n = 48
    if scene_name == "shirley":
        org = np.tile([13.0, 2.0, 3.0], (n, 1)) + 0.1 * r.normal(size=(n, 3))
        d = -org / np.linalg.norm(org, axis=1, keepdims=True) \
            + 0.08 * r.normal(size=(n, 3))
    else:
        # aim at the spheres (and, past them, the triangles)
        pick = r.integers(0, t_np.sph_c0.shape[0], n)
        target = t_np.sph_c0[pick] + 0.8 * r.normal(size=(n, 3))
        org = target + 8.0 * r.normal(size=(n, 3))
        d = target - org
    times = r.random(n)
    t_orc = Oracle(tscene, rng=np.random.default_rng(7).random)
    j_orc = joracle.Oracle(jscene, rng=np.random.default_rng(7).random)
    bg = np.array([0.5, 0.7, 1.0])
    hits = 0
    for k in range(n):
        o, dd = org[k].astype(np.float32), d[k].astype(np.float32)
        th, jh = t_orc.hit(o, dd, times[k]), j_orc.hit(o, dd, times[k])
        assert _rec_fields(th) == _rec_fields(jh)
        if th is not None:
            hits += 1
            samples = {"unit_vector": r.normal(size=3),
                       "unit_sphere": r.normal(size=3) * 0.3,
                       "uniform": r.random()}
            got = oracle.scatter(t_np, th.mat_id, dd.astype(np.float64),
                                 times[k], th, None, samples=samples)
            want = joracle.scatter(j_np, jh.mat_id, dd.astype(np.float64),
                                   times[k], jh, None, samples=samples)
            assert [np.asarray(x).tobytes() for x in got if x is not None] \
                == [np.asarray(x).tobytes() for x in want if x is not None]
            assert oracle.emitted(t_np, th.mat_id, th.uv, th.p).tobytes() \
                == joracle.emitted(j_np, jh.mat_id, jh.uv, jh.p).tobytes()
        got = t_orc.ray_color(o, dd, times[k], bg, 4)
        want = j_orc.ray_color(o, dd, times[k], bg, 4)
        assert np.asarray(got).tobytes() == np.asarray(want).tobytes()
    assert hits >= n // 4


# -- tests/test_intersect.py on the port -----------------------------------

@pytest.mark.parametrize("moving", [False, True])
def test_find_hit_matches_oracle(rng_np, moving):
    scene = _port(random_scene, rng_np, moving=moving)
    org, dir, time = random_rays(rng_np, 256)
    prim, t = find_hit_bruteforce(scene, _t(org), _t(dir), _t(time))
    prim, t = prim.numpy(), t.numpy()
    scene_np = oracle._as_numpy(scene)
    mismatches = 0
    for r in range(org.shape[0]):
        o_prim, o_t, _ = oracle_closest(
            scene_np, org[r].astype(np.float32), dir[r].astype(np.float32),
            time[r])
        if o_prim != prim[r]:
            if np.isfinite(o_t) and np.isfinite(t[r]):
                assert abs(o_t - t[r]) / max(abs(o_t), 1e-6) < 1e-2
            mismatches += 1
        elif o_prim >= 0:
            assert abs(o_t - t[r]) / max(abs(o_t), 1e-6) < 1e-2
    assert mismatches <= 3


def test_hit_record_matches_oracle():
    rng_np = np.random.default_rng(42)
    scene = _port(random_scene, rng_np, n_tris=30, n_sph=15)
    org, dir, time = random_rays(rng_np, 256)
    org = org * 0.6
    prim, t = find_hit_bruteforce(scene, _t(org), _t(dir), _t(time))
    rec = hit_data(scene, _t(org), _t(dir), _t(time), prim)
    rec = type(rec)(*(x.numpy() for x in rec))
    prim_np = prim.numpy()
    scene_np = oracle._as_numpy(scene)
    T = scene.num_triangles
    checked = 0
    for r in range(org.shape[0]):
        if prim_np[r] < 0:
            assert not bool(rec.hit[r])
            continue
        o = org[r].astype(np.float32)
        d = dir[r].astype(np.float32)
        if prim_np[r] < T:
            orec = oracle.triangle_hit(scene_np, int(prim_np[r]), o, d,
                                       0.001, np.inf)
        else:
            orec = oracle.sphere_hit(scene_np, int(prim_np[r]) - T, o, d,
                                     time[r], 0.001, np.inf)
        assert orec is not None
        np.testing.assert_allclose(rec.t[r], orec.t, rtol=2e-3)
        np.testing.assert_allclose(rec.p[r], orec.p, rtol=1e-2, atol=2e-3)
        np.testing.assert_allclose(rec.normal[r], orec.normal, rtol=1e-3,
                                   atol=1e-4)
        np.testing.assert_allclose(rec.uv[r], orec.uv, rtol=5e-3, atol=5e-3)
        np.testing.assert_allclose(rec.tangent[r], orec.tangent, rtol=1e-2,
                                   atol=1e-3)
        np.testing.assert_allclose(rec.bitangent[r], orec.bitangent,
                                   rtol=1e-2, atol=1e-3)
        assert bool(rec.front_face[r]) == orec.front_face
        assert int(rec.mat_id[r]) == orec.mat_id
        checked += 1
    assert checked > 50


def test_backface_culling():
    b = SceneBuilder()
    mat = b.add_pbr_material()
    b.add_mesh([[-1, -1, 0], [1, -1, 0], [0, 1, 0]], None, [[0, 1, 2]], mat)
    scene = b.build(build_bvh=False, device="cpu")
    org = _t([[0.0, 0.0, 5.0], [0.0, 0.0, -5.0]])
    dir = _t([[0.0, 0.0, -1.0], [0.0, 0.0, 1.0]])
    prim, t = find_hit_bruteforce(scene, org, dir, torch.zeros(2))
    assert int(prim[0]) == 0
    assert int(prim[1]) == -1
    # the oracle agrees: the front hits, the back is culled
    s = oracle._as_numpy(scene)
    assert oracle.triangle_hit(s, 0, org[0].numpy(), dir[0].numpy(), 0.001,
                               np.inf) is not None
    assert oracle.triangle_hit(s, 0, org[1].numpy(), dir[1].numpy(), 0.001,
                               np.inf) is None


def test_moving_sphere_center():
    b = SceneBuilder()
    mat = b.add_pbr_material()
    b.add_sphere((0, 0, 0), 1.0, mat, center1=(10, 0, 0), time0=0.0,
                 time1=1.0)
    scene = b.build(build_bvh=False, device="cpu")
    org = _t([[5.0, 0.0, 5.0]] * 2)
    dir = _t([[0.0, 0.0, -1.0]] * 2)
    time = _t([0.5, 0.0])
    prim, t = find_hit_bruteforce(scene, org, dir, time)
    assert int(prim[0]) == 0
    assert int(prim[1]) == -1
    s = oracle._as_numpy(scene)
    np.testing.assert_allclose(oracle.sphere_center(s, 0, 0.5), [5, 0, 0])


# -- tests/test_shade.py on the port ---------------------------------------

def test_shade_matches_oracle():
    scene = build_material_zoo(SceneBuilder).build(build_bvh=False,
                                                   device="cpu")
    scene_np = oracle._as_numpy(scene)
    rng_np = np.random.default_rng(5)
    centers = scene_np.sph_c0
    n = 64 * centers.shape[0]
    org = np.repeat(centers, 64, axis=0) + np.array([8.0, 6.0, 10.0])
    org = (org + rng_np.normal(size=(n, 3))).astype(np.float32)
    targets = np.repeat(centers, 64, axis=0) + 0.3 * rng_np.normal(size=(n, 3))
    dir = (targets - org).astype(np.float32)
    time = np.zeros(n, np.float32)
    prim, _ = find_hit_bruteforce(scene, _t(org), _t(dir), _t(time))
    rec = hit_data(scene, _t(org), _t(dir), _t(time), prim)

    unit_vec = rng_np.normal(size=(n, 3))
    unit_vec /= np.linalg.norm(unit_vec, axis=1, keepdims=True)
    ball = rng_np.normal(size=(n, 3))
    ball = ball / np.linalg.norm(ball, axis=1, keepdims=True) * (
        rng_np.random((n, 1)) ** (1 / 3))
    uni = rng_np.random(n)
    rand = {"unit_vector": _t(unit_vec), "unit_ball": _t(ball),
            "uniform": _t(uni)}
    samp = shade(scene, rec, _t(dir), rand)
    samp = type(samp)(*(x.numpy() for x in samp))
    rec = type(rec)(*(x.numpy() for x in rec))

    prim_np = prim.numpy()
    checked = {int(m): 0 for m in scene_np.mat_type}
    for r in range(n):
        if prim_np[r] < 0:
            continue
        orec = oracle.HitRec()
        orec.p = np.asarray(rec.p[r], np.float64)
        orec.normal = np.asarray(rec.normal[r], np.float64)
        orec.tangent = np.asarray(rec.tangent[r], np.float64)
        orec.bitangent = np.asarray(rec.bitangent[r], np.float64)
        orec.uv = np.asarray(rec.uv[r], np.float64)
        orec.t = float(rec.t[r])
        orec.front_face = bool(rec.front_face[r])
        orec.mat_id = int(rec.mat_id[r])
        samples = {"unit_vector": unit_vec[r], "unit_sphere": ball[r],
                   "uniform": uni[r]}
        ok, att, new_o, new_d = oracle.scatter(
            scene_np, orec.mat_id, dir[r].astype(np.float64), time[r], orec,
            None, samples=samples)
        emit = oracle.emitted(scene_np, orec.mat_id, orec.uv, orec.p)
        np.testing.assert_allclose(samp.emitted[r], emit, rtol=1e-4,
                                   atol=1e-5)
        assert bool(samp.scattered[r]) == ok
        if ok:
            np.testing.assert_allclose(samp.attenuation[r], att, rtol=3e-3,
                                       atol=2e-4)
            np.testing.assert_allclose(samp.direction[r], new_d, rtol=3e-3,
                                       atol=2e-4)
        checked[int(scene_np.mat_type[orec.mat_id])] += 1
    assert all(v > 0 for v in checked.values()), checked


# -- tests/test_render.py on the port --------------------------------------

def test_matches_oracle_statistics():
    """The port's CPU render of the small scene against the scalar
    oracle's Monte Carlo mean at matched pixels."""
    scene = small_scene(SceneBuilder).build(build_bvh=False, device="cpu")
    cfg = RenderConfig(
        width=8, height=6, samples_per_pixel=64, max_bounce=4,
        rays_per_chunk=1024, samples_per_batch=16,
        camera=CameraConfig(eye=(0, 2, 6), look_at=(0, 1, 0),
                            vfov_degrees=45.0, aperture=0.0, focus_dist=6.0))
    img = render_accumulate(scene, cfg) / cfg.samples_per_pixel

    orc = Oracle(scene, rng=np.random.default_rng(7).random)
    W, H = cfg.width, cfg.height
    cam_rng = np.random.default_rng(13)
    spp = 48
    cam = Camera.from_config(cfg.camera, cfg.aspect, device="cpu")
    origin = cam.origin.numpy().astype(np.float64)
    lleft = cam.lower_left.numpy().astype(np.float64)
    horizontal = cam.horizontal.numpy().astype(np.float64)
    vertical = cam.vertical.numpy().astype(np.float64)
    diffs = []
    for y in range(H):
        for x in range(W):
            acc = np.zeros(3)
            for _ in range(spp):
                u = (x + cam_rng.random()) / (W - 1)
                v = ((H - y) + cam_rng.random()) / (H - 1)
                d = lleft + u * horizontal + v * vertical - origin
                acc += orc.ray_color(origin, d, cam_rng.random(),
                                     np.asarray(cfg.background),
                                     cfg.max_bounce)
            diffs.append(img[y, x] - acc / spp)
    diffs = np.asarray(diffs)
    assert np.abs(diffs.mean(axis=0)).max() < 0.15, diffs.mean(axis=0)
