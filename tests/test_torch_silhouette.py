"""The port's boundary gradient ``sphere_silhouette_loss`` on
tests/test_silhouette.py's scene (a featureless red sphere against the
sky, 96x54, 8 spp): its gradient against the JAX package's, against
central differences of the rendered loss, and a recovery of a displaced
sphere by the silhouette term alone.

Parity: the in/out rays are traced by both packages' reference
integrators (``fused=False``; JAX ``method="bruteforce"``, the port's
default) with the same keys. At most 1% of the 2 x 256 edge rays may
flip primitives between the two (measured: none), and the gradient must be
within 2e-2 of JAX's in norm with cosine >= 0.999 (measured: 1.5e-7 and
1.0 to 7 digits). The FD and recovery bars are test_silhouette.py's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from sexy_raytracer_tpu.diff import silhouette as jsil  # noqa: E402
from sexy_raytracer_tpu.models.scene import SceneBuilder as JBuilder  # noqa: E402
from sexy_raytracer_tpu.render.camera import Camera as JCamera  # noqa: E402
from sexy_raytracer_tpu.render.renderer import (  # noqa: E402
    render_accumulate as j_render_accumulate,
)
from sexy_raytracer_tpu_torch.diff import silhouette as tsil  # noqa: E402
from sexy_raytracer_tpu_torch.diff.inverse import Adam  # noqa: E402
from sexy_raytracer_tpu_torch.models.scene import scene_from_numpy  # noqa: E402
from sexy_raytracer_tpu_torch.render import integrator  # noqa: E402
from sexy_raytracer_tpu_torch.render.camera import Camera  # noqa: E402
from sexy_raytracer_tpu_torch.render.renderer import (  # noqa: E402
    render_accumulate,
)
from sexy_raytracer_tpu_torch.utils import rng  # noqa: E402
from sexy_raytracer_tpu_torch.utils.config import (  # noqa: E402
    CameraConfig,
    RenderConfig,
)

W, H = 96, 54
SPP = 8
CFG = RenderConfig(
    width=W, height=H, samples_per_pixel=SPP, max_bounce=2,
    camera=CameraConfig(eye=(0.0, 0.0, 5.0), look_at=(0.0, 0.0, 0.0),
                        vfov_degrees=40.0, aperture=0.0, focus_dist=5.0),
)
C_TRUE = np.zeros(3)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def build(center):
    """test_silhouette.py:29-43's scene as numpy arrays."""
    b = JBuilder()
    b.add_sphere(
        tuple(center), 1.0,
        b.add_pbr_material(albedo_tex=b.add_solid_texture((0.9, 0.15, 0.1))),
    )
    return b.build(device=False)


def resolved(acc):
    return np.clip(np.sqrt(np.clip(np.asarray(acc) / SPP, 1e-8, None)),
                   0.0, 0.999)


@pytest.fixture(scope="module")
def target():
    """The port's resolved render of the true scene (the port's
    ``render_accumulate`` on CPU tensors)."""
    return resolved(render_accumulate(scene_from_numpy(build(C_TRUE), "cpu"),
                                      CFG))


def _camera():
    return Camera.from_config(CFG.camera, CFG.aspect, device="cpu")


def _with_center(scene, c):
    """The scene with sphere 0's centre (both endpoints) replaced by ``c``,
    a tensor that may require grad."""
    return scene._replace(sph_c0=torch.cat([c[None], scene.sph_c0[1:]]),
                          sph_c1=torch.cat([c[None], scene.sph_c1[1:]]))


def _sil_grad(scene, c, target, key, n_edge, **kw):
    c = torch.as_tensor(c, dtype=torch.float32).clone().requires_grad_(True)
    loss = tsil.sphere_silhouette_loss(
        _with_center(scene, c), _camera(), torch.from_numpy(target), [0],
        key, width=W, height=H, max_bounce=CFG.max_bounce,
        background=CFG.background, n_edge=n_edge, **kw)
    (g,) = torch.autograd.grad(loss, c)
    return float(loss.detach()), g


def test_silhouette_gradient_matches_jax(target):
    """Key 3, n_edge 256, ``fused=False`` in both packages."""
    c0 = np.array([0.35, -0.25, 0.0])
    np_scene = build(c0)
    value, g_t = _sil_grad(scene_from_numpy(np_scene, "cpu"), c0, target,
                           rng.key(3), 256, fused=False)
    jscene = jax.device_put(np_scene)
    jcam = JCamera.from_config(CFG.camera, CFG.aspect)

    def sil(c):
        sc = jscene._replace(sph_c0=jscene.sph_c0.at[0].set(c),
                             sph_c1=jscene.sph_c1.at[0].set(c))
        return jsil.sphere_silhouette_loss(
            sc, jcam, target, [0], jax.random.key(3), width=W, height=H,
            max_bounce=CFG.max_bounce, background=CFG.background, n_edge=256,
            method="bruteforce", fused=False)

    g_j = np.asarray(jax.grad(sil)(jnp.asarray(c0, jnp.float32)))
    g_t = g_t.numpy()
    assert value == 0.0
    assert np.isfinite(g_t).all() and np.linalg.norm(g_j) > 1e-6
    assert np.linalg.norm(g_t - g_j) <= 2e-2 * np.linalg.norm(g_j), (g_t, g_j)
    cos = float(g_t @ g_j / (np.linalg.norm(g_t) * np.linalg.norm(g_j)))
    assert cos >= 0.999, (cos, g_t, g_j)


def test_edge_rays_match_jax(target, monkeypatch):
    """The parity case's edge geometry equals JAX's, and its 2 n_edge
    in/out rays, recorded as the port traces them, give the same radiance
    under JAX's reference integrator: a ray that flipped primitives would
    differ by far more than 1e-3 (allowed: 1% of the rays; measured: 0)."""
    from sexy_raytracer_tpu.render.integrator import trace_rays as j_trace

    c0 = np.array([0.35, -0.25, 0.0], np.float32)
    n = 256
    kk = rng.fold_in(rng.key(3), 0)
    xi = rng.uniform(kk)
    assert xi.numpy().view(np.int32) == np.asarray(jax.random.uniform(
        jax.random.fold_in(jax.random.key(3), 0))).view(np.int32)
    phis = (2.0 * np.pi) * ((np.arange(n, dtype=np.float32) + xi.numpy())
                            / n)
    got = tsil._edge_geometry(_camera(), torch.from_numpy(c0),
                              torch.tensor(1.0), torch.from_numpy(phis))
    want = jsil._edge_geometry(JCamera.from_config(CFG.camera, CFG.aspect),
                               jnp.asarray(c0), jnp.float32(1.0),
                               jnp.asarray(phis))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-6,
                                   atol=2e-6)

    calls = []

    def recorder(scene, org, dirs, times, keys, *args, **kw):
        rad = integrator.trace_rays(scene, org, dirs, times, keys, *args,
                                    **kw)
        calls.append((org, dirs, times, keys, rad))
        return rad

    monkeypatch.setattr(tsil, "trace_rays", recorder)
    _sil_grad(scene_from_numpy(build(c0), "cpu"), c0, target, rng.key(3), n,
              fused=False)
    (org, dirs, times, keys, rad_t), = calls
    assert dirs.shape == (2 * n, 3)
    rad_j = np.asarray(j_trace(
        jax.device_put(build(c0)), jnp.asarray(org.numpy()),
        jnp.asarray(dirs.numpy()), jnp.asarray(times.numpy()),
        jax.random.wrap_key_data(jnp.asarray(keys.numpy(), jnp.uint32)),
        jnp.asarray(CFG.background), CFG.max_bounce, "bruteforce",
        fused=False))
    flipped = int((np.abs(rad_t.numpy() - rad_j).max(axis=1) > 1e-3).sum())
    assert flipped <= 0.01 * 2 * n, flipped  # measured: 0
    np.testing.assert_allclose(rad_t.numpy(), rad_j, rtol=1e-5, atol=1e-5)


def test_silhouette_gradient_matches_fd(target):
    """test_silhouette.py:60-102: the silhouette gradient in the image
    plane against central differences (h 0.05) of the port's rendered
    resolved MSE; cosine > 0.7, norm ratio in (0.3, 3)."""
    c0 = np.array([0.35, -0.25, 0.0])
    _, g_sil = _sil_grad(scene_from_numpy(build(c0), "cpu"), c0, target,
                         rng.key(3), 256, fused=False)

    def loss_of(center):
        img = resolved(render_accumulate(
            scene_from_numpy(build(center), "cpu"), CFG))
        return float(np.mean((img - target) ** 2))

    h = 0.05
    fd2 = np.zeros(2)
    for a in range(2):  # x and y; the z edge signal is weaker
        e = np.zeros(3)
        e[a] = h
        fd2[a] = (loss_of(c0 + e) - loss_of(c0 - e)) / (2 * h)
    sg2 = g_sil.numpy()[:2]
    assert np.linalg.norm(fd2) > 1e-6, "FD gradient degenerate"
    cos = float(fd2 @ sg2 / (np.linalg.norm(fd2) * np.linalg.norm(sg2)
                             + 1e-12))
    assert cos > 0.7, (cos, fd2, sg2)
    ratio = float(np.linalg.norm(sg2) / np.linalg.norm(fd2))
    assert 0.3 < ratio < 3.0, (ratio, fd2, sg2)


def test_silhouette_recovers_position(target):
    """test_silhouette.py:105-150: the port's ``Adam`` at 3e-2 on the
    silhouette term alone, n_edge 128, key i at step i, 50 steps, pulls
    the sphere from (0.4, -0.3, 0) to within 0.12 of the truth. The port's
    default integrator (the fused one) traces the edge rays."""
    scene = scene_from_numpy(build(np.array([0.4, -0.3, 0.0])), "cpu")
    c = torch.tensor([0.4, -0.3, 0.0])
    opt = Adam({"c": 3e-2})
    state = opt.init({"c": c})
    for i in range(50):
        _, g = _sil_grad(scene, c, target, rng.key(i), 128)
        up, state = opt.update({"c": g}, state)
        c = c + up["c"]
    err = float(torch.linalg.norm(c - torch.from_numpy(C_TRUE).float()))
    assert err < 0.12, f"center error after recovery: {err} (start 0.5)"


def test_silhouette_target_matches_jax(target):
    """The target both packages' parity and FD cases use: the port's
    render equals the JAX package's (tests/test_silhouette.py:46-50)."""
    want = resolved(j_render_accumulate(jax.device_put(build(C_TRUE)), CFG,
                                        method="bruteforce"))
    np.testing.assert_allclose(target, want, rtol=1e-5, atol=1e-5)
