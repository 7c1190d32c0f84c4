"""Gradient correctness of the port's train loss: finite differences, as
tests/test_grad.py:59-283 checks the JAX package, on CPU tensors (each
kernel wrapper runs its plain version), and the differentiable camera
``Camera.from_params`` against ``jax.grad`` of the JAX loss.

Tolerances are test_grad.py's: the render is deterministic for a fixed
key, so a central difference is exact up to float32 truncation of the
loss; 0.08 relative for the material factors, 0.15 for the 0-255 atlas
(it needs a large step to rise above the loss's quantisation), 0.1 for
the camera and the sphere position. Against JAX, the camera gradients are
held to bench.py:192's relative 1e-2. The cull and refit cases of
test_grad.py are mirrored in tests/test_torch_train.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from sexy_raytracer_tpu.diff import inverse as jinv  # noqa: E402
from sexy_raytracer_tpu.diff.params import (  # noqa: E402
    extract_params as j_extract,
)
from sexy_raytracer_tpu.models import SceneBuilder as JBuilder  # noqa: E402
from sexy_raytracer_tpu.render.camera import Camera as JCamera  # noqa: E402
from sexy_raytracer_tpu_torch.diff.inverse import _loss_fn  # noqa: E402
from sexy_raytracer_tpu_torch.diff.params import extract_params  # noqa: E402
from sexy_raytracer_tpu_torch.models.scene import (  # noqa: E402
    SceneBuilder,
    scene_from_numpy,
)
from sexy_raytracer_tpu_torch.render.camera import Camera  # noqa: E402
from sexy_raytracer_tpu_torch.utils import rng  # noqa: E402
from sexy_raytracer_tpu_torch.utils.config import (  # noqa: E402
    CameraConfig,
    RenderConfig,
)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _scene():
    """test_grad.py:16-37: checker ground, light, metal, an image-textured
    PBR sphere and one PBR triangle."""
    b = SceneBuilder()
    checker = b.add_checker_texture((0.2, 0.3, 0.1), (0.9, 0.9, 0.9))
    b.add_sphere((0, -1000, 0), 1000.0, b.add_pbr_material(albedo_tex=checker))
    b.add_sphere((-2, 1, 0), 1.0, b.add_light_material(color=(8.0, 7.0, 6.0)))
    b.add_sphere((1.5, 1, 0), 1.0, b.add_metal_material((0.7, 0.6, 0.5), 0.1))
    img = np.full((8, 8, 3), 180, np.uint8)
    b.add_sphere(
        (0, 1, 1.5), 1.0,
        b.add_pbr_material(albedo_tex=b.add_image_texture(img),
                           base_color=(0.9, 0.8, 0.7, 1.0), metallic=0.3,
                           roughness=0.5),
    )
    mat = b.add_pbr_material(base_color=(0.8, 0.4, 0.3, 1.0), roughness=0.6)
    b.add_mesh([[-2, 0, -2], [2, 0, -2], [0, 3, -2]],
               [[0, 0], [1, 0], [0.5, 1]], [[0, 1, 2]], mat)
    return b.build(build_bvh=False, device="cpu")


def _setup():
    """test_grad.py:40-56: 24x16, spb 4, 3 bounces, the centre rows."""
    scene = _scene()
    cfg = RenderConfig(
        width=24, height=16, samples_per_pixel=4, max_bounce=3,
        camera=CameraConfig(eye=(0, 2, 6), look_at=(0, 1, 0),
                            vfov_degrees=45.0, aperture=0.0, focus_dist=6.0),
    )
    cam = Camera.from_config(cfg.camera, cfg.aspect, device="cpu")
    pix = torch.arange(24 * 6, 24 * 10, dtype=torch.int32)
    tgt = torch.full((pix.shape[0], 3), 0.5)

    def f(params):
        return _loss_fn(params, scene, cam, pix, tgt, 0, rng.key(3),
                        torch.tensor(cfg.background), width=cfg.width,
                        height=cfg.height, spb=4,
                        spp_total=cfg.samples_per_pixel,
                        max_bounce=cfg.max_bounce, method="auto")

    return scene, f


def _grads(f, params):
    params = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    loss = f(params)
    got = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    return loss.detach(), {k: torch.zeros_like(params[k]) if g is None else g
                           for k, g in zip(params, got)}


def _rel(fd, ad):
    return abs(fd - ad) / max(abs(fd), abs(ad), 1e-6)


def test_grads_finite_and_nonzero():
    """test_grad.py:59-73: the seven groups' gradients are finite; the
    atlas, materials, spheres and triangles affect the image."""
    scene, f = _setup()
    names = ("shade_atlas", "mat_base_color", "mat_metallic",
             "mat_roughness", "sph_c0", "sph_c1", "tri_v0")
    loss, grads = _grads(f, extract_params(scene, names))
    assert torch.isfinite(loss)
    assert set(grads) == set(names)
    for name, g in grads.items():
        assert torch.isfinite(g).all(), f"{name} grad has NaN/inf"
    for name in ("shade_atlas", "mat_base_color", "sph_c0", "tri_v0"):
        assert float(grads[name].abs().max()) > 0, f"{name} grad all-zero"


@pytest.mark.parametrize("name", ["mat_base_color", "mat_roughness",
                                  "shade_atlas"])
def test_finite_difference_match(name):
    """test_grad.py:76-102: a directional central difference against
    autograd, direction from default_rng(0) per group."""
    scene, f = _setup()
    params = extract_params(scene, (name,))
    _, grads = _grads(f, params)
    r = np.random.default_rng(0)
    direction = torch.from_numpy(
        r.normal(size=tuple(params[name].shape)).astype(np.float32))
    eps = 1e-3 if name != "shade_atlas" else 4.0
    with torch.no_grad():
        fd = (float(f({name: params[name] + eps * direction}))
              - float(f({name: params[name] - eps * direction}))) / (2 * eps)
    ad = float(torch.sum(grads[name] * direction))
    tol = 0.08 if name != "shade_atlas" else 0.15
    assert _rel(fd, ad) < tol, (name, fd, ad)


def _sphere_setup():
    """test_grad.py:114-132 / 228-252: one solid-PBR sphere, the centre
    2x2 pixels of a 16x16 image, spb 4, 2 bounces (as a JAX and a port
    scene of the same arrays)."""
    b = JBuilder()
    b.add_sphere((0, 0, 0), 1.0,
                 b.add_pbr_material(base_color=(0.7, 0.6, 0.5, 1.0),
                                    metallic=0.2, roughness=0.5))
    np_scene = b.build(build_bvh=False, device=False)
    pix = np.asarray([16 * 7 + 7, 16 * 7 + 8, 16 * 8 + 7, 16 * 8 + 8],
                     np.int32)
    kw = dict(width=16, height=16, spb=4, spp_total=4, max_bounce=2)
    return np_scene, pix, kw


def _camera_loss(scene, pix, kw):
    """The port's loss as a function of (eye, vfov) through
    ``Camera.from_params`` (key 1, background (0.6, 0.7, 0.8))."""
    params = extract_params(scene, ("mat_base_color",))
    tgt = torch.full((4, 3), 0.5)
    pix = torch.from_numpy(pix)

    def loss_of(eye, vfov):
        c = Camera.from_params(eye, torch.zeros(3),
                               torch.tensor([0.0, 1.0, 0.0]), vfov, 1.0,
                               0.0, 4.0)
        return _loss_fn(params, scene, c, pix, tgt, 0, rng.key(1),
                        torch.tensor((0.6, 0.7, 0.8)), method="auto", **kw)

    return loss_of


def test_finite_difference_camera_params():
    """test_grad.py:104-162: autograd through ``Camera.from_params`` on
    the eye and the vfov against central differences (0.1 relative), and
    both against ``jax.grad`` of the JAX loss on the same inputs
    (relative 1e-2)."""
    np_scene, pix, kw = _sphere_setup()
    loss_of = _camera_loss(scene_from_numpy(np_scene, "cpu"), pix, kw)
    eye0 = torch.tensor([0.0, 0.0, 4.0])
    vfov0 = torch.tensor(40.0)
    eye = eye0.clone().requires_grad_(True)
    vfov = vfov0.clone().requires_grad_(True)
    loss = loss_of(eye, vfov)
    g_eye, g_vfov = torch.autograd.grad(loss, [eye, vfov])
    assert torch.isfinite(g_eye).all() and torch.isfinite(g_vfov)
    assert float(g_eye.abs().max()) > 0

    d = torch.tensor([0.3, 0.2, 0.9])  # mostly depth: no visibility flips
    eps = 1e-3
    with torch.no_grad():
        fd = (float(loss_of(eye0 + eps * d, vfov0))
              - float(loss_of(eye0 - eps * d, vfov0))) / (2 * eps)
        fdv = (float(loss_of(eye0, vfov0 + 1e-2))
               - float(loss_of(eye0, vfov0 - 1e-2))) / 2e-2
    assert _rel(fd, float(torch.sum(g_eye * d))) < 0.1, (fd, g_eye)
    assert _rel(fdv, float(g_vfov)) < 0.1, (fdv, float(g_vfov))

    jscene = jax.device_put(np_scene)
    jparams = j_extract(jscene, ("mat_base_color",))

    def jloss(e, v):
        c = JCamera.from_params(e, jnp.zeros(3), jnp.asarray([0.0, 1.0, 0.0]),
                                v, 1.0, 0.0, 4.0)
        return jinv._loss_fn(jparams, jscene, c, jnp.asarray(pix),
                             jnp.full((4, 3), 0.5), jnp.int32(0),
                             jax.random.key(1), jnp.asarray((0.6, 0.7, 0.8)),
                             method="bruteforce", **kw)

    j_loss, (j_eye, j_vfov) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray([0.0, 0.0, 4.0]), jnp.float32(40.0))
    assert abs(float(loss.detach()) - float(j_loss)) \
        <= 1e-3 * abs(float(j_loss))
    j_eye = np.asarray(j_eye)
    assert np.linalg.norm(g_eye.numpy() - j_eye) \
        <= 1e-2 * np.linalg.norm(j_eye), (g_eye, j_eye)
    assert abs(float(g_vfov) - float(j_vfov)) \
        <= 1e-2 * abs(float(j_vfov)), (float(g_vfov), float(j_vfov))


def test_from_params_keeps_tensors_and_reaches_every_argument():
    """A float32 tensor that requires grad is the camera's own field, not
    a copy; gradients reach every tensor argument, and ``create`` and
    ``from_config`` give ``from_params``' camera."""
    args = dict(eye=torch.tensor([0.5, 2.0, 6.0]),
                look_at=torch.tensor([0.0, 1.0, 0.0]),
                up=torch.tensor([0.1, 1.0, 0.0]),
                vfov_degrees=torch.tensor(45.0), aspect=torch.tensor(1.5),
                aperture=torch.tensor(0.2), focus_dist=torch.tensor(6.0),
                time0=torch.tensor(0.1), time1=torch.tensor(0.9))
    args = {k: v.requires_grad_(True) for k, v in args.items()}
    cam = Camera.from_params(**args, device="cpu")
    assert cam.origin is args["eye"]
    assert cam.time0 is args["time0"] and cam.time1 is args["time1"]
    r = np.random.default_rng(2)
    s, t = (torch.from_numpy(r.random(64).astype(np.float32))
            for _ in range(2))
    u = torch.from_numpy(r.random((64, 3)).astype(np.float32))
    org, d, tm = cam.get_rays(s, t, u)
    total = (org * 1.3).sum() + (d * d).sum() + (tm * 0.7).sum()
    grads = torch.autograd.grad(total, list(args.values()))
    for k, g in zip(args, grads):
        assert torch.isfinite(g).all() and float(g.abs().max()) > 0, k

    cfg = CameraConfig(eye=(0.5, 2.0, 6.0), look_at=(0.0, 1.0, 0.0),
                       up=(0.1, 1.0, 0.0), vfov_degrees=45.0, aperture=0.2,
                       focus_dist=6.0, time0=0.1, time1=0.9)
    plain = Camera.from_params(cfg.eye, cfg.look_at, cfg.up,
                               cfg.vfov_degrees, 1.5, cfg.aperture,
                               cfg.focus_dist, cfg.time0, cfg.time1,
                               device="cpu")
    for cam2 in (Camera.from_config(cfg, 1.5, device="cpu"),
                 Camera.create(cfg.eye, cfg.look_at, cfg.up,
                               cfg.vfov_degrees, 1.5, cfg.aperture,
                               cfg.focus_dist, cfg.time0, cfg.time1,
                               device="cpu")):
        for a, b in zip(cam2, plain):
            assert torch.equal(a, b)
    want = JCamera.from_params(cfg.eye, cfg.look_at, cfg.up,
                               cfg.vfov_degrees, 1.5, cfg.aperture,
                               cfg.focus_dist, cfg.time0, cfg.time1)
    for name, a, b in zip(Camera._fields, plain, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6, err_msg=name)


def test_finite_difference_sphere_position_interior():
    """test_grad.py:225-283: sphere-centre gradients through the quadratic
    root on pixels strictly inside the sphere's projection (silhouette
    motion is stop-gradient), both centre endpoints moved together."""
    np_scene, pix, kw = _sphere_setup()
    scene = scene_from_numpy(np_scene, "cpu")
    cam = Camera.from_config(
        CameraConfig(eye=(0, 0, 4), look_at=(0, 0, 0), vfov_degrees=40.0,
                     aperture=0.0, focus_dist=4.0), 1.0, device="cpu")
    pix = torch.from_numpy(pix)
    tgt = torch.full((4, 3), 0.5)

    def f(params):
        return _loss_fn(params, scene, cam, pix, tgt, 0, rng.key(1),
                        torch.tensor((0.6, 0.7, 0.8)), method="auto", **kw)

    params = extract_params(scene, ("sph_c0", "sph_c1"))
    _, grads = _grads(f, params)
    direction = torch.tensor([[0.05, 0.02, 0.1]])  # mostly depth
    eps = 1e-3
    with torch.no_grad():
        fd = (float(f({k: v + eps * direction for k, v in params.items()}))
              - float(f({k: v - eps * direction
                         for k, v in params.items()}))) / (2 * eps)
    ad = float(sum(torch.sum(g * direction) for g in grads.values()))
    assert _rel(fd, ad) < 0.1, (fd, ad)
