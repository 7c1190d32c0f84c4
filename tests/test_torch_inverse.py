"""The port's ``inverse_render`` against the JAX package's: the fitting
loop (tile draws in a region of interest, split keys or a common key, the
parameter EMA, gradient masks, the loss types, a reparameterisation), and
a common-random-numbers self-recovery of tests/test_inverse.py's scene.

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

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from sexy_raytracer_tpu.diff import inverse as jinv  # noqa: E402
from sexy_raytracer_tpu.models import SceneBuilder as JBuilder  # noqa: E402
from sexy_raytracer_tpu.parallel.mesh import make_mesh  # noqa: E402
from sexy_raytracer_tpu.render.renderer import (  # noqa: E402
    render_accumulate as j_render_accumulate,
)
from sexy_raytracer_tpu.utils.config import CameraConfig, RenderConfig  # noqa: E402
from sexy_raytracer_tpu_torch.diff import inverse as tinv  # noqa: E402
from sexy_raytracer_tpu_torch.diff.params import DEFAULT_TRAINABLE  # noqa: E402
from sexy_raytracer_tpu_torch.models.scene import (  # noqa: E402
    SceneBuilder as TBuilder,
    scene_from_numpy,
)
from sexy_raytracer_tpu_torch.render.renderer import (  # noqa: E402
    render_accumulate,
)
from sexy_raytracer_tpu_torch.utils import rng  # noqa: E402
from sexy_raytracer_tpu_torch.utils.mathx import clip  # noqa: E402

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


def test_crn_loss_is_zero_at_the_true_params(scenes):
    """inverse.py:396-403: against a target traced with the same key and
    spp, the loss at the true parameters is zero in both packages (at most
    1e-8; any gap would come from the order of the sums)."""
    np_scene, jscene, tscene = scenes
    cfg = dataclasses.replace(CFG, samples_per_pixel=2, seed=9)

    def resolved(acc):
        return np.clip(np.sqrt(np.clip(np.asarray(acc) / 2, 1e-8, None)),
                       0.0, 0.999)

    kw = dict(n_steps=1, pixels_per_step=256, spb=2, learning_rate=LR,
              seed=5, progress=False, roi=ROI, grad_masks=_masks())
    _, (jl,) = jinv.inverse_render(
        jscene, resolved(j_render_accumulate(jscene, cfg,
                                             method="bruteforce")),
        cfg, mesh=make_mesh(devices=jax.devices()[:1]), method="bruteforce",
        crn_key=jax.random.key(9), **kw)
    _, (tl,) = tinv.inverse_render(
        tscene, resolved(render_accumulate(tscene, cfg)), cfg,
        crn_key=rng.key(9), **kw)
    print(f"first CRN loss at the true params: port {tl:.3e}, JAX {jl:.3e}")
    assert 0.0 <= tl <= 1e-8 and 0.0 <= jl <= 1e-8, (tl, jl)


def test_init_params_and_param_transform_match_jax():
    """Stage A of tools/run_inverse_experiment.py (:211-212, :266-283): a
    delta at 1/8 of the atlas's resolution, upsampled into the colour
    channels, from zeros, lr 0.5, tile_linear with huber_delta 0.5, two
    steps; the transform is applied to the returned params too. The
    scene has no glass sphere, so the textured triangle is in view."""
    scenes = _scenes(glass=False)
    np_scene = scenes[0]
    L, AH, AW, _ = np_scene.shade_atlas.shape
    base_np = np_scene.shade_atlas
    base_t = torch.from_numpy(base_np)

    def transform_jax(p):
        delta = jnp.repeat(jnp.repeat(p["d8"], F, axis=1), F, axis=2)
        atlas = jnp.concatenate([base_np[..., 0:3] + delta, base_np[..., 3:]],
                                axis=-1)
        return {"shade_atlas": jnp.clip(atlas, 0.0, 255.0)}

    def transform_torch(p):
        delta = p["d8"].repeat_interleave(F, 1).repeat_interleave(F, 2)
        atlas = torch.cat([base_t[..., 0:3] + delta, base_t[..., 3:]], dim=-1)
        return {"shade_atlas": clip(atlas, 0.0, 255.0)}

    d8 = np.zeros((L, AH // F, AW // F, 3), np.float32)
    (jo, jl), (to, tl) = _run_both(
        scenes, _target("tile_linear"), n_steps=2, learning_rate=0.5,
        loss_type="tile_linear", huber_delta=0.5,
        jax_kw={"init_params": {"d8": jnp.asarray(d8)},
                "param_transform": transform_jax},
        torch_kw={"init_params": {"d8": d8},
                  "param_transform": transform_torch})
    _assert_losses_close(tl, jl)
    _assert_fields_close(to, jo, ("shade_atlas",), {"shade_atlas": 2 * 0.5})
    moved = np.abs(to.shade_atlas.numpy() - base_np)
    assert moved[..., 0:3].max() > 0.1 and moved[..., 3:].max() == 0.0
    for k in ("sph_c0", "mat_base_color"):  # not trained under the transform
        np.testing.assert_array_equal(getattr(to, k).numpy(),
                                      getattr(np_scene, k))


def _inverse_scene():
    """tests/test_inverse.py:35-55: checker ground, light, mirror sphere
    and a sphere with a smooth image texture."""
    b = TBuilder()
    checker = b.add_checker_texture((0.2, 0.3, 0.1), (0.9, 0.9, 0.9))
    b.add_sphere((0, -1000, 0), 1000.0, b.add_pbr_material(albedo_tex=checker))
    b.add_sphere((-2.5, 2.5, 2.0), 1.0,
                 b.add_light_material(color=(15.0, 14.0, 12.0)))
    b.add_sphere((1.6, 1, 0), 1.0, b.add_metal_material((0.7, 0.6, 0.5), 0.0))
    yy, xx = np.mgrid[0:16, 0:16]
    img = np.stack([120 + 6 * xx, 90 + 5 * yy, 200 - 5 * xx],
                   axis=-1).astype(np.float32)
    b.add_sphere((-1.2, 1, 0.5), 1.0,
                 b.add_pbr_material(albedo_tex=b.add_image_texture(img),
                                    roughness=0.4))
    return b.build(build_bvh=False, device="cpu")


def test_crn_self_recovery_converges():
    """A common-random-numbers self-recovery of tests/test_inverse.py's
    experiment (perturbed texture pack, displaced textured sphere, the
    other spheres frozen) cut to tier-1 size: spb 8 instead of 32 and 200
    steps instead of 300 (lr 1.2e-2), each step tracing the target's own
    samples. The exact objective, a deterministic re-render against the
    target, must drop at least 10x (test_inverse.py:115's bar)."""
    scene = _inverse_scene()
    spb = 8
    cfg = RenderConfig(
        width=48, height=32, samples_per_pixel=spb, max_bounce=3,
        camera=CameraConfig(eye=(0, 2, 6), look_at=(0, 1, 0),
                            vfov_degrees=45.0, aperture=0.0, focus_dist=6.0),
    )

    def resolved(s):
        acc = render_accumulate(s, cfg)
        return np.clip(np.sqrt(np.clip(acc / spb, 1e-8, None)), 0, 0.999)

    target = resolved(scene)
    true_c0 = scene.sph_c0.numpy()
    shift = np.zeros_like(true_c0)
    shift[3] = (-0.3, 0.2, 0.25)  # the textured sphere
    perturbed = scene._replace(
        shade_atlas=clip(scene.shade_atlas * 0.5 + 60.0, 0.0, 255.0),
        sph_c0=torch.from_numpy(true_c0 + shift),
        sph_c1=torch.from_numpy(true_c0 + shift),
    )
    mask = np.zeros((4, 1), np.float32)
    mask[3] = 1.0
    opt, losses = tinv.inverse_render(
        perturbed, target, cfg, n_steps=200, pixels_per_step=768, spb=spb,
        learning_rate=1.2e-2, seed=5, progress=False,
        trainable=("shade_atlas", "sph_c0", "sph_c1"),
        grad_masks={"sph_c0": mask, "sph_c1": mask},
        crn_key=rng.key(cfg.seed),
    )
    assert np.isfinite(losses).all()
    assert np.mean(losses[-30:]) < np.mean(losses[:5])
    errs = np.linalg.norm(opt.sph_c0.numpy() - true_c0, axis=1)
    assert errs[3] < 0.15, errs
    assert (errs[:3] == 0).all(), errs

    def mse(s):
        return float(((resolved(s) - target) ** 2).mean())

    mse_pert, mse_opt = mse(perturbed), mse(opt)
    print(f"exact objective {mse_pert:.3e} -> {mse_opt:.3e} "
          f"({mse_pert / mse_opt:.1f}x)")
    assert mse_opt < 0.1 * mse_pert, (mse_pert, mse_opt)
    assert mse_opt < 5e-4, mse_opt


def test_ema_leaves_frozen_values_bit_equal(scenes):
    """A frozen parameter (the atlas's channels 3-7 under a channel mask,
    here by training nothing but the base colours) keeps its bits under
    the EMA; JAX's form ``a e + (1 - a) p`` moves some of the same values
    by an ulp, as a reference for why the port's form differs."""
    _, _, tscene = scenes
    atlas = tscene.shade_atlas * 1.37 + 0.11    # values off the integers
    scene = tscene._replace(shade_atlas=atlas)
    opt, losses = tinv.inverse_render(
        scene, _target("mse"), CFG, n_steps=6, pixels_per_step=256, spb=2,
        learning_rate=LR, seed=5, progress=False, roi=ROI,
        trainable=("shade_atlas", "mat_base_color"),
        grad_masks={"shade_atlas": np.zeros((1, 1, 1, 8), np.float32)})
    assert np.isfinite(losses).all()
    assert torch.equal(opt.shade_atlas, atlas)
    assert not torch.equal(opt.mat_base_color, scene.mat_base_color)
    e = atlas.clone()
    for _ in range(5):
        e = 0.98 * e + (1.0 - 0.98) * atlas
    assert not torch.equal(e, atlas)
