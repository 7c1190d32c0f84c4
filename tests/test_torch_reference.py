"""The port's reference (unfused) integrator and its parts against the JAX
package: ``hit_data``, ``shade``, ``trace_rays_reference`` (counterpart of
``trace_rays_jnp``) and ``render_pixels(fused=False)``, on the wavefront of
tests/test_fused.py:22-52, and against the port's fused integrator.

Tolerances, each with its reason:
* hit records for given prim ids are elementwise: atol 2e-5, rtol 1e-5
  (tests/test_fused.py:61-62), with a budget of 0.5% of the hits, all on
  spheres, where a record is ill-conditioned: on the radius-1000 ground
  sphere ``c = |oc|^2 - r^2`` cancels (1e6 - 1e6), so one rounding of the
  sum moves t by ~1e-5 relative; within ~1e-3 of a pole the tangent is
  the cross of two nearly parallel vectors (tests/test_torch_fused.py:
  136-143, ROADMAP.md queue 3);
* ``shade`` with the same injected draws: the same tolerance, except that
  a near-threshold lane (``reflectance > uniform``, shade.py:252; the
  metal ``ok`` test, :239) may take the other branch under the other
  compiler's rounding: at most 0.5% of the rays, and only where the
  deciding quantities lie within 1e-5 of each other;
* radiance against ``trace_rays_jnp``: atol 2e-5, rtol 1e-5 with 0.5% of
  the rays allowed outside (tests/test_torch_render.py: an f32 edge that
  flips a prim id sends a path down another branch); gradients against
  JAX within the gate of bench.py:192 (relative 1e-2 per parameter);
* the port's two integrators against each other: the bounds the JAX
  package holds its two to (tests/test_fused.py): radiance atol 2e-5,
  rtol 1e-5 on every ray, gradients within relative 5e-4.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from sexy_raytracer_tpu.diff.params import (  # noqa: E402
    extract_params as j_extract,
)
from sexy_raytracer_tpu.diff.params import merge_params as j_merge  # noqa: E402
from sexy_raytracer_tpu.models.scene import SceneBuilder as JBuilder  # noqa: E402
from sexy_raytracer_tpu.ops import intersect as jint  # noqa: E402
from sexy_raytracer_tpu.ops import shade as jshade  # noqa: E402
from sexy_raytracer_tpu.render import integrator as jintegrator  # noqa: E402
from sexy_raytracer_tpu.render.camera import Camera as JCamera  # noqa: E402
from sexy_raytracer_tpu.render.renderer import (  # noqa: E402
    render_pixels as j_render_pixels,
)
from sexy_raytracer_tpu.utils import rng as jrng  # noqa: E402
from sexy_raytracer_tpu.utils.config import CameraConfig  # noqa: E402
from sexy_raytracer_tpu_torch.diff.params import (  # noqa: E402
    extract_params,
    merge_params,
)
from sexy_raytracer_tpu_torch.models.scene import scene_from_numpy  # noqa: E402
from sexy_raytracer_tpu_torch.ops import _cuda  # noqa: E402
from sexy_raytracer_tpu_torch.ops import intersect as tint  # noqa: E402
from sexy_raytracer_tpu_torch.ops import shade as tshade  # noqa: E402
from sexy_raytracer_tpu_torch.render import integrator as tintegrator  # noqa: E402
from sexy_raytracer_tpu_torch.render.camera import Camera as TCamera  # noqa: E402
from sexy_raytracer_tpu_torch.render.renderer import render_pixels  # noqa: E402
from sexy_raytracer_tpu_torch.utils.mathx import clip  # noqa: E402

TOL = dict(atol=2e-5, rtol=1e-5)
CAM = CameraConfig(eye=(0, 2, 6), look_at=(0, 1, 0), vfov_degrees=45.0,
                   aperture=0.1, focus_dist=6.0)
BG = (0.5, 0.7, 0.9)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The plain versions here work on small tensors; one intra-op thread
    keeps them from contending with the suite's other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np_scene():
    b = JBuilder()
    checker = b.add_checker_texture((0.2, 0.3, 0.1), (0.9, 0.9, 0.9))
    b.add_sphere((0, -1000, 0), 1000.0, b.add_pbr_material(albedo_tex=checker))
    b.add_sphere((-2, 1, 0), 1.0, b.add_light_material(color=(10, 9, 7)))
    b.add_sphere((2, 1, 0), 1.0, b.add_metal_material((0.7, 0.6, 0.5), 0.0))
    b.add_sphere((0, 1, 2), 1.0, b.add_dielectric_material(1.5))
    tex = b.add_image_texture(
        (np.arange(16 * 16 * 3).reshape(16, 16, 3) * 7 % 256).astype(np.uint8)
    )
    mat = b.add_pbr_material(albedo_tex=tex)
    b.add_mesh([[-1, 0, -2], [1, 0, -2], [0, 2, -2]],
               [[0, 0], [1, 0], [0.5, 1]], [[0, 1, 2]], mat)
    return b.build(build_bvh=False, device=False)


@pytest.fixture(scope="module")
def wavefront():
    """(JAX args, port args) of trace_rays: the scene and 2,048 camera rays
    of tests/test_fused.py:22-52."""
    np_scene = _np_scene()
    cam = JCamera.from_config(CAM, 32 / 24)
    R = 2048
    pid = jnp.arange(R, dtype=jnp.int32) % (32 * 24)
    keys = jrng.ray_keys_2d(jax.random.key(1), pid,
                            jnp.zeros((R,), jnp.int32))
    ucam = jrng.per_ray_uniform_block(keys, 5)
    u = ((pid % 32).astype(jnp.float32) + ucam[..., 0]) / 31
    v = ((24 - pid // 32).astype(jnp.float32) + ucam[..., 1]) / 23
    org, dirs, times = cam.get_rays(u, v, ucam[..., 2:5])
    jax_args = (jax.device_put(np_scene), org, dirs, times, keys,
                jnp.asarray(BG, jnp.float32))
    torch_args = (
        scene_from_numpy(np_scene, "cpu"),
        *(torch.from_numpy(np.array(x)) for x in (org, dirs, times)),
        torch.from_numpy(np.asarray(jax.random.key_data(keys), np.int64)),
        torch.tensor(BG),
    )
    return jax_args, torch_args


def _bounce_rays(wavefront):
    """Camera rays and, to reach back faces, inside of the glass and the
    triangle from every side, 2,048 rays from random points in the scene
    in random directions: (jax org, dirs, times), (torch ...)."""
    (jscene, org, dirs, times, _, _), _ = wavefront
    r = np.random.default_rng(5)
    o2 = r.uniform([-3, 0, -3], [3, 3, 3], (2048, 3))
    d2 = r.normal(size=(2048, 3))
    d2 /= np.linalg.norm(d2, axis=1, keepdims=True)
    o = np.concatenate([np.asarray(org), o2]).astype(np.float32)
    d = np.concatenate([np.asarray(dirs), d2]).astype(np.float32)
    t = np.concatenate([np.asarray(times),
                        r.uniform(0, 1, 2048)]).astype(np.float32)
    return (jnp.asarray(o), jnp.asarray(d), jnp.asarray(t)), \
        tuple(torch.from_numpy(x) for x in (o, d, t))


def test_hit_data_matches_jax(wavefront):
    """Records for the bruteforce winners of camera and scattered rays:
    misses, every sphere, the triangle from both sides."""
    (jscene, *_), (tscene, *_) = wavefront
    jr, tr = _bounce_rays(wavefront)
    prim, _ = jint.find_hit_bruteforce(jscene, *jr)
    T = int(jscene.tri_v0.shape[0])
    p = np.asarray(prim)
    kinds = {"miss": p < 0, "triangle": (p >= 0) & (p < T), "sphere": p >= T}
    assert all(m.sum() >= 20 for m in kinds.values()), \
        {k: int(m.sum()) for k, m in kinds.items()}
    want = jint.hit_data(jscene, *jr, prim)
    got = tint.hit_data(tscene, *tr, torch.from_numpy(p.copy()))
    assert got._fields == want._fields
    hit = p >= 0
    off = np.zeros(p.shape[0], bool)
    for name in got._fields:
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.shape == w.shape and g.dtype == w.dtype, name
        if name in ("front_face", "mat_id", "hit"):
            np.testing.assert_array_equal(g, w, err_msg=name)
            continue
        assert np.isfinite(g[hit]).all(), name
        bad = ~np.isclose(g, w, **TOL)
        off |= hit & (bad.any(axis=1) if bad.ndim > 1 else bad)
    assert off.sum() <= 0.005 * hit.sum() and (p[off] >= T).all(), \
        f"{off.sum()} of {hit.sum()} hits off, prims {np.unique(p[off])}"
    assert np.isinf(got.t.numpy()[~hit]).all()


def test_hit_data_gradient_stops_at_uv(wavefront):
    """The uv of a hit carries no gradient (intersect.py:354,425); the
    point does, to the triangle's vertices and the sphere's center."""
    (jscene, *_), (tscene, *_) = wavefront
    jr, tr = _bounce_rays(wavefront)
    prim, _ = jint.find_hit_bruteforce(jscene, *jr)
    fields = {k: getattr(tscene, k).clone().requires_grad_(True)
              for k in ("tri_v0", "tri_uv0", "sph_c0")}
    rec = tint.hit_data(tscene._replace(**fields), *tr,
                        torch.from_numpy(np.array(prim)))
    assert not rec.uv.requires_grad
    g = torch.autograd.grad(rec.p.sum(), list(fields.values()),
                            allow_unused=True)
    assert g[0].abs().sum() > 0 and g[2].abs().sum() > 0
    assert g[1] is None or not g[1].any()


def test_shade_matches_jax(wavefront):
    """``shade`` on JAX's records with the same injected draws, seeded in
    numpy: every material, both sides of the glass, misses."""
    (jscene, *_), (tscene, *_) = wavefront
    jr, tr = _bounce_rays(wavefront)
    prim, _ = jint.find_hit_bruteforce(jscene, *jr)
    rec = jint.hit_data(jscene, *jr, prim)
    r = np.random.default_rng(11)
    u = r.random((prim.shape[0], 6)).astype(np.float32)
    rand_j = {
        "unit_vector": jrng.unit_vector_from_uniforms(u[:, 0], u[:, 1]),
        "unit_ball": jrng.in_unit_sphere_from_uniforms(u[:, 2], u[:, 3],
                                                       u[:, 4]),
        "uniform": jnp.asarray(u[:, 5]),
    }
    rand_t = {k: torch.from_numpy(np.array(v)) for k, v in rand_j.items()}
    rec_t = tint.HitRecord(*(torch.from_numpy(np.array(x)) for x in rec))
    want = jshade.shade(jscene, rec, jr[1], rand_j)
    got = tshade.shade(tscene, rec_t, tr[1], rand_t)
    assert got._fields == want._fields

    # the lanes whose branch rests on a near tie under either compiler
    mtype = np.asarray(jscene.mat_type)[np.asarray(rec.mat_id)]
    nrm = np.asarray(rec.normal, np.float64)
    d = np.asarray(jr[1], np.float64)
    ud = d / np.linalg.norm(d, axis=1, keepdims=True)
    cos_t = np.minimum(np.sum(nrm * -ud, axis=1), 1.0)
    ior = np.asarray(jscene.mat_ior)[np.asarray(rec.mat_id)]
    ratio = np.where(np.asarray(rec.front_face), 1.0 / ior, ior)
    r0 = ((1.0 - ratio) / (1.0 + ratio)) ** 2
    refl = r0 + (1.0 - r0) * (1.0 - cos_t) ** 5
    sin_t = np.sqrt(np.maximum(1.0 - cos_t ** 2, 0.0))
    near = (np.abs(refl - u[:, 5]) < 1e-5) | (np.abs(ratio * sin_t - 1) < 1e-5)
    met = np.asarray(want.direction, np.float64)
    near |= np.abs(np.sum(met * nrm, axis=1)) < 1e-5
    near &= np.asarray(rec.hit) & (mtype >= 1) & (mtype <= 2)

    off = np.zeros(prim.shape[0], bool)
    for name in got._fields:
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.shape == w.shape and g.dtype == w.dtype, name
        if name == "scattered":
            bad = g != w
        else:
            bad = ~np.isclose(g, w, **TOL).all(axis=1)
        off |= bad
    assert off.mean() <= 0.005 and (~off | near).all(), \
        f"{off.sum()} rays off, {(off & ~near).sum()} of them not near a tie"
    assert np.asarray(want.scattered).any() and (~np.asarray(
        want.scattered)).any()


def _loss(trace, scene_, params, merge, clip_, sqrt, mean, args, tgt):
    rad = trace(merge(scene_, params), *args)
    res = clip_(sqrt(clip_(rad, 1e-8, None)), 0.0, 0.999)
    return mean((res - tgt) ** 2)


@pytest.mark.parametrize("bounces", [1, 3])
def test_trace_rays_reference_matches_jax(wavefront, bounces):
    jax_args, torch_args = wavefront
    want = np.asarray(jintegrator.trace_rays_jnp(*jax_args, bounces,
                                                 method="bruteforce"))
    before = {k.symbol: k.launches for k in _cuda.KERNELS}
    got = tintegrator.trace_rays_reference(*torch_args, bounces,
                                           method="bruteforce").numpy()
    assert {k.symbol: k.launches for k in _cuda.KERNELS} == before
    assert got.shape == want.shape and np.isfinite(got).all()
    close = np.isclose(got, want, **TOL).all(axis=1)
    assert close.mean() >= 0.995, f"{(~close).sum()} rays outside"
    assert got.max() > 0.1


@pytest.mark.parametrize("bounces,vis", [(1, False), (3, False), (3, True)])
def test_reference_matches_fused_integrator(wavefront, bounces, vis):
    """The port's two integrators agree on every ray, as the JAX package's
    do (tests/test_fused.py:55-80); ``trace_rays`` dispatches on
    ``fused``."""
    _, torch_args = wavefront
    ref = tintegrator.trace_rays(*torch_args, bounces, "bruteforce",
                                 fused=False, last_bounce_vis=vis)
    np.testing.assert_array_equal(
        ref.numpy(), tintegrator.trace_rays_reference(
            *torch_args, bounces, "bruteforce").numpy())
    fus = tintegrator.trace_rays(*torch_args, bounces, "bruteforce",
                                 last_bounce_vis=vis)
    np.testing.assert_array_equal(
        fus.numpy(), tintegrator.trace_rays_fused(
            *torch_args, bounces, "bruteforce", vis).numpy())
    np.testing.assert_allclose(ref.numpy(), fus.numpy(), **TOL)


def test_reference_gradients_match_jax_and_fused(wavefront):
    """The loss of tests/test_fused.py:120-139 through each integrator."""
    jax_args, torch_args = wavefront
    jscene, jrest = jax_args[0], jax_args[1:]
    tscene, trest = torch_args[0], torch_args[1:]
    R = jrest[0].shape[0]
    jtgt = jnp.full((R, 3), 0.3)
    ttgt = torch.full((R, 3), 0.3)

    g_jax = jax.grad(lambda p: _loss(
        lambda s, *a: jintegrator.trace_rays_jnp(s, *a, 3,
                                                 method="bruteforce"),
        jscene, p, j_merge, jnp.clip, jnp.sqrt, jnp.mean, jrest, jtgt,
    ))(j_extract(jscene))

    def torch_grads(trace):
        params = {k: v.clone().requires_grad_(True)
                  for k, v in extract_params(tscene).items()}
        loss = _loss(lambda s, *a: trace(s, *a, 3, method="bruteforce"),
                     tscene, params, merge_params, clip, torch.sqrt,
                     torch.mean, trest, ttgt)
        got = torch.autograd.grad(loss, list(params.values()),
                                  allow_unused=True)
        return {k: torch.zeros_like(p) if g is None else g
                for (k, p), g in zip(params.items(), got)}

    g_ref = torch_grads(tintegrator.trace_rays_reference)
    g_fus = torch_grads(tintegrator.trace_rays_fused)
    assert set(g_ref) == set(g_jax)
    for k, want in g_jax.items():
        want = np.asarray(want)
        ref, fus = g_ref[k].numpy(), g_fus[k].numpy()
        assert np.isfinite(ref).all(), k
        scale = max(float(np.abs(want).max()), 1e-12)
        assert float(np.abs(ref - want).max()) <= 1e-2 * scale, k
        scale = max(float(np.abs(ref).max()), 1e-10)
        assert float(np.abs(ref - fus).max()) / scale < 5e-4, k


def test_render_pixels_unfused_matches_jax(wavefront):
    """``render_pixels(fused=False)``: the reference integrator behind the
    camera, keys and overshoot mask, against JAX's with ``fused=False``."""
    (jscene, *_), (tscene, *_) = wavefront
    ids = np.arange(0, 32 * 24, 3, dtype=np.int32)
    kw = dict(width=32, height=24, spb=2, spp_total=3, max_bounce=3,
              method="bruteforce")
    want = np.asarray(j_render_pixels(
        jscene, JCamera.from_config(CAM, 32 / 24), jnp.asarray(ids), 2,
        jax.random.key(7), jnp.asarray(BG, jnp.float32), fused=False, **kw))
    cam = TCamera.from_config(CAM, 32 / 24, device="cpu")
    args = (tscene, cam, torch.from_numpy(ids), 2,
            torch.tensor([0, 7], dtype=torch.int64), torch.tensor(BG))
    got = render_pixels(*args, fused=False, **kw).numpy()
    assert got.shape == want.shape == (ids.size, 3)
    close = np.isclose(got, want, **TOL).all(axis=1)
    assert close.mean() >= 0.995, f"{(~close).sum()} pixels outside"
    fused = render_pixels(*args, **kw).numpy()
    np.testing.assert_allclose(got, fused, **TOL)
