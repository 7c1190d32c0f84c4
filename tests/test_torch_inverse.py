"""The port's ``inverse_render`` against the JAX package's: the fitting
loop (tile draws in a region of interest, split keys or a common key, the
parameter EMA, gradient masks, the loss types). The common-random-numbers
cases, the reparameterisation, the self-recovery and the EMA's bits are in
``tests/test_torch_inverse_crn.py``, a file of its own so that a worker
of ``--dist loadfile`` takes each half.

The parity runs use the scene of tests/test_torch_train.py at 32x24 with 2
bounces (the JAX step compiles in about half the time of 3 bounces, and 2
still runs a full bounce and the last-bounce visibility query), 4 steps of
256 pixels at spb 2, seed 5, JAX on a one-device mesh with
``method="bruteforce"``. Budgets are test_train_steps_match_jax's: the
first loss within relative 1e-3 and later ones within 1e-2; each trained
field of the returned scene within two learning rates of JAX's, at most
1% of its elements beyond 1% of one (plus 1e-6 relative, for the far
ground sphere's float32 spacing). A path that flips at a float32 edge can
turn the sign of a small gradient component, and Adam's early steps move
every element by about one learning rate whatever its gradient's size.
Frozen spheres are bit-equal to JAX's and to their start. The port's EMA
is ``e + (1 - a)(p - e)``, JAX's ``a e + (1 - a) p``: equal up to
rounding, and the port's leaves a frozen value bit-equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from sexy_raytracer_tpu.diff import inverse as jinv  # noqa: E402
from sexy_raytracer_tpu.models import SceneBuilder as JBuilder  # noqa: E402
from sexy_raytracer_tpu.parallel.mesh import make_mesh  # noqa: E402
from sexy_raytracer_tpu.utils.config import CameraConfig, RenderConfig  # noqa: E402
from sexy_raytracer_tpu_torch.diff import inverse as tinv  # noqa: E402
from sexy_raytracer_tpu_torch.diff.params import DEFAULT_TRAINABLE  # noqa: E402
from sexy_raytracer_tpu_torch.models.scene import scene_from_numpy  # noqa: E402
from sexy_raytracer_tpu_torch.utils import rng  # noqa: E402

CFG = RenderConfig(
    width=32, height=24, samples_per_pixel=2, max_bounce=2,
    camera=CameraConfig(eye=(0, 2, 6), look_at=(0, 1, 0), vfov_degrees=45.0,
                        aperture=0.1, focus_dist=6.0),
)
ROI = (4, 20, 0, 32)
LR = 1e-3
F = 8  # the coarse delta's factor (run_inverse_experiment.py stage A)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _scenes(glass=True):
    """(numpy scene, JAX scene, port scene on the CPU) of
    tests/test_torch_train.py (tests/test_fused.py:22-52); without the
    glass sphere, which hides the textured triangle from the camera."""
    b = JBuilder()
    checker = b.add_checker_texture((0.2, 0.3, 0.1), (0.9, 0.9, 0.9))
    b.add_sphere((0, -1000, 0), 1000.0, b.add_pbr_material(albedo_tex=checker))
    b.add_sphere((-2, 1, 0), 1.0, b.add_light_material(color=(10, 9, 7)))
    b.add_sphere((2, 1, 0), 1.0, b.add_metal_material((0.7, 0.6, 0.5), 0.0))
    if glass:
        b.add_sphere((0, 1, 2), 1.0, b.add_dielectric_material(1.5))
    tex = b.add_image_texture(
        (np.arange(16 * 16 * 3).reshape(16, 16, 3) * 7 % 256).astype(np.uint8)
    )
    mat = b.add_pbr_material(albedo_tex=tex)
    b.add_mesh([[-1, 0, -2], [1, 0, -2], [0, 2, -2]],
               [[0, 0], [1, 0], [0.5, 1]], [[0, 1, 2]], mat)
    np_scene = b.build(build_bvh=False, device=False)
    return np_scene, jax.device_put(np_scene), scene_from_numpy(np_scene,
                                                                "cpu")


@pytest.fixture(scope="module")
def scenes():
    return _scenes()


def _masks():
    """Freeze the ground sphere (at 2 bounces the one sphere whose centre
    gets a gradient here)."""
    sph = np.ones((4, 1), np.float32)
    sph[0] = 0.0
    return {"sph_c0": sph, "sph_c1": sph}


def _target(loss_type):
    """A seeded target image: resolved for ``mse``, linear radiance for
    ``tile_linear``."""
    t = np.random.default_rng(11).uniform(0.2, 0.8, (24, 32, 3))
    return (t if loss_type == "mse" else t * t).astype(np.float32)


def _run_both(scenes, target, *, jax_kw=None, torch_kw=None, **kw):
    _, jscene, tscene = scenes
    kw = {**dict(n_steps=4, pixels_per_step=256, spb=2, learning_rate=LR,
                 seed=5, progress=False, roi=ROI), **kw}
    want = jinv.inverse_render(jscene, target, CFG,
                               mesh=make_mesh(devices=jax.devices()[:1]),
                               method="bruteforce", **kw, **(jax_kw or {}))
    got = tinv.inverse_render(tscene, target, CFG, **kw, **(torch_kw or {}))
    return want, got


def _assert_losses_close(got, want):
    assert len(got) == len(want)
    assert np.isfinite(got).all()
    for i, (g, w) in enumerate(zip(got, want)):
        tol = 1e-3 if i == 0 else 1e-2
        assert abs(g - w) <= tol * abs(w), (i, g, w)


def _assert_fields_close(got, want, names, lrs):
    for k in names:
        g = getattr(got, k).numpy()
        w = np.asarray(getattr(want, k))
        assert g.shape == w.shape and np.isfinite(g).all(), k
        diff = np.abs(g - w)
        slack = 1e-6 * np.abs(w)
        assert (diff <= 2 * lrs[k] + slack).all(), (k, diff.max())
        n_out = int((diff > 1e-2 * lrs[k] + slack).sum())
        assert n_out <= 0.01 * diff.size, (k, n_out, diff.size)


@pytest.mark.parametrize("loss_type,param_ema", [
    ("mse", 0.98), ("mse", 0.0), ("tile_linear", 0.98),
    ("tile_linear", 0.0)])
def test_inverse_render_matches_jax(scenes, loss_type, param_ema):
    """Four steps with gradient masks and an ROI, EMA on and off, the
    resolved MSE and the tile-averaged linear Huber."""
    np_scene, _, tscene = scenes
    (jo, jl), (to, tl) = _run_both(
        scenes, _target(loss_type), grad_masks=_masks(), loss_type=loss_type,
        param_ema=param_ema, huber_delta=0.5)
    _assert_losses_close(tl, jl)
    lrs = {k: LR for k in DEFAULT_TRAINABLE}
    lrs["shade_atlas"] = LR * 256.0
    _assert_fields_close(to, jo, DEFAULT_TRAINABLE, lrs)
    for k in ("sph_c0", "sph_c1"):  # the frozen ground sphere
        np.testing.assert_array_equal(getattr(to, k)[0].numpy(),
                                      np.asarray(getattr(jo, k))[0])
        np.testing.assert_array_equal(getattr(to, k)[0].numpy(),
                                      getattr(np_scene, k)[0])
    for k in ("mat_base_color", "mat_albedo_c0"):
        assert not torch.equal(getattr(to, k), getattr(tscene, k)), k


def test_inverse_render_crn_matches_jax(scenes):
    """With ``crn_key`` every step traces with that key (no split)."""
    (jo, jl), (to, tl) = _run_both(
        scenes, _target("mse"), grad_masks=_masks(),
        jax_kw={"crn_key": jax.random.key(7)},
        torch_kw={"crn_key": rng.key(7)})
    _assert_losses_close(tl, jl)
    lrs = {k: LR for k in DEFAULT_TRAINABLE}
    lrs["shade_atlas"] = LR * 256.0
    _assert_fields_close(to, jo, DEFAULT_TRAINABLE, lrs)
