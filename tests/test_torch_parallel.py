"""The port's ``parallel/`` on gloo ranks against the single-process port
and the JAX package's ``render_sharded`` and ``make_train_step`` on a mesh
of its 8 virtual CPU devices: the mirror of tests/test_parallel.py:43,56,72
on its scene and config (32x24, 8 spp, 3 bounces, 256 paths a chunk, spb
4, ``method="bruteforce"``) and of tests/test_rng_keys.py:52.

The ranks run in processes started by ``parallel.spawn`` (one torch thread
each; their bodies are in tests/torch_parallel_ranks.py); one spawn of 4
ranks renders and trains on the (4, 1) and (2, 2) meshes.

Tolerances, each with its reason:
* sharded frame against the single-process frame: JAX's own, atol 2e-5,
  rtol 1e-4 (tests/test_parallel.py:53): with more than two sample shards
  the all-reduce adds the partial sums in another order;
* the port's sharded frame against JAX's: the trace parity budget of
  tests/test_torch_render.py:42 (atol 2e-5, rtol 1e-5, 0.5% of pixels
  outside): the packages round differently at f32 edges;
* sharded train steps against JAX's on the same mesh: relative loss 1e-3
  (bench.py:192) and each parameter element relative 1e-2; measured, the
  largest relative difference is 4e-7;
* the (4, 1) mesh against one rank on the same global batch: relative loss
  1e-5, the summation order of the mean over ranks;
* the (1, 1) mesh against no mesh: bit for bit.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

import torch_parallel_ranks as ranks  # noqa: E402
from sexy_raytracer_tpu.diff.inverse import (  # noqa: E402
    TrainState as JTrainState,
    make_train_step as j_make_train_step,
)
from sexy_raytracer_tpu.diff.params import extract_params as j_extract  # noqa: E402
from sexy_raytracer_tpu.models import SceneBuilder as JBuilder  # noqa: E402
from sexy_raytracer_tpu.parallel import mesh as jmesh_mod  # noqa: E402
from sexy_raytracer_tpu.parallel.render import (  # noqa: E402
    render_sharded as j_render_sharded,
)
from sexy_raytracer_tpu.render.camera import Camera as JCamera  # noqa: E402
from sexy_raytracer_tpu.utils import rng as jrng  # noqa: E402
from sexy_raytracer_tpu.utils.config import (  # noqa: E402
    CameraConfig as JCameraConfig,
    RenderConfig as JRenderConfig,
)
from sexy_raytracer_tpu_torch.parallel import spawn  # noqa: E402
from sexy_raytracer_tpu_torch.render.renderer import render  # noqa: E402
from sexy_raytracer_tpu_torch.utils import rng as trng  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def four():
    """The four ranks' results (tests/torch_parallel_ranks.four_ranks)."""
    return spawn(ranks.four_ranks, 4, "gloo", "cpu", timeout=300)


@pytest.fixture(scope="module")
def one():
    return spawn(ranks.one_rank, 1, "gloo", "cpu", timeout=300)[0]


@pytest.fixture(scope="module")
def jax_side():
    """JAX's scene, config and (2, 2) mesh over 4 of the virtual devices."""
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 JAX CPU devices")
    b = JBuilder()
    checker = b.add_checker_texture((0.2, 0.3, 0.1), (0.9, 0.9, 0.9))
    b.add_sphere((0, -1000, 0), 1000.0, b.add_pbr_material(albedo_tex=checker))
    b.add_sphere((-2, 1, 0), 1.0, b.add_light_material(color=(10, 9, 7)))
    b.add_sphere((2, 1, 0), 1.0, b.add_metal_material((0.7, 0.6, 0.5), 0.0))
    mat = b.add_pbr_material(base_color=(0.9, 0.3, 0.3, 1.0))
    b.add_mesh([[-1, 0, -2], [1, 0, -2], [0, 2, -2]], None, [[0, 1, 2]], mat)
    cfg = JRenderConfig(
        width=32, height=24, samples_per_pixel=8, max_bounce=3,
        rays_per_chunk=256, samples_per_batch=4,
        camera=JCameraConfig(eye=(0, 2, 6), look_at=(0, 1, 0),
                             vfov_degrees=45.0, aperture=0.0, focus_dist=6.0))
    mesh = jmesh_mod.make_mesh(n_rays=2, n_samples=2,
                               devices=jax.devices()[:4])
    return b.build(build_bvh=False), cfg, mesh


def _same_on_every_rank(results, key):
    first = results[0][key]
    for r in results[1:]:
        np.testing.assert_array_equal(r[key], first)
    return first


@pytest.mark.parametrize("shape", [(4, 1), (2, 2)])
def test_sharded_matches_single(four, shape):
    """Rays sharded 4 ways, or 2 x 2 with the sample axis: the image of the
    single-process render, the same on every rank."""
    single = render(ranks.scene(), ranks.cfg(), method="bruteforce")
    sharded = _same_on_every_rank(four, shape)
    np.testing.assert_allclose(sharded, single, atol=2e-5, rtol=1e-4)


def test_sharded_non_divisible_spp(four):
    """10 spp on the (2, 2) mesh (8 samples a round): the overshoot samples
    of the second round are masked, so the image is the 10-sample one."""
    single = render(ranks.scene(), ranks.cfg(samples_per_pixel=10),
                    method="bruteforce")
    sharded = _same_on_every_rank(four, "spp10")
    np.testing.assert_allclose(sharded, single, atol=2e-5, rtol=1e-4)


def test_sharded_matches_jax(four, jax_side):
    jscene, jcfg, mesh = jax_side
    want = np.asarray(j_render_sharded(jscene, jcfg, mesh,
                                       method="bruteforce"))
    got = _same_on_every_rank(four, (2, 2))
    close = np.isclose(got, want, atol=2e-5, rtol=1e-5).all(axis=-1)
    assert close.mean() >= 0.995, \
        f"pixels outside the budget: {np.argwhere(~close).tolist()}"


def test_sharded_train_steps_match_jax(four, jax_side):
    """Three steps on the (2, 2) mesh (test_parallel.py:72's batch, spb 2,
    Adam 1e-2, keys 0-2): losses and parameters against JAX's step on its
    (2, 2) mesh; bit-identical across the ranks; every parameter group
    with a gradient moved."""
    jscene, jcfg, mesh = jax_side
    opt = optax.adam(ranks.TRAIN_LR)
    params = j_extract(jscene)
    state = JTrainState(params, opt.init(params), jnp.int32(0))
    step = j_make_train_step(mesh, jcfg, opt, spb=ranks.TRAIN_SPB,
                             method="bruteforce")
    scene_r = jmesh_mod.replicate_scene(jscene, mesh)
    cam = JCamera.from_config(jcfg.camera, jcfg.aspect)
    pix = jmesh_mod.shard_rays(jnp.asarray(ranks.PIX), mesh)
    tgt = jmesh_mod.shard_rays(jnp.asarray(ranks.TGT), mesh)
    want = []
    for i in range(ranks.TRAIN_STEPS):
        state, loss = step(state, scene_r, cam, pix, tgt, jax.random.key(i))
        want.append(float(loss))

    results = [r[(2, 2, "train")] for r in four]
    losses, got = results[0]
    for other_losses, other in results[1:]:
        assert other_losses == losses
        for k in got:
            assert torch.equal(other[k], got[k]), k
    for g, w in zip(losses, want):
        assert abs(g - w) <= 1e-3 * abs(w), (losses, want)
    initial = ranks.scene()
    for k, w in state.params.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(w), rtol=1e-2,
                                   atol=0.0, err_msg=k)
    for k in ("mat_base_color", "mat_albedo_c0", "sph_c0"):
        assert not torch.equal(got[k], getattr(initial, k)), k


def test_ray_shards_match_one_rank(four):
    """The (4, 1) mesh's mean loss against one rank's on the same global
    batch and keys."""
    want, _ = ranks.train_steps(None)
    for r in four:
        losses, _ = r[(4, 1, "train")]
        for g, w in zip(losses, want):
            assert abs(g - w) <= 1e-5 * abs(w), (losses, want)


def test_one_by_one_mesh_is_bit_equal(one):
    """A (1, 1) mesh gives the frame, losses and parameters of no mesh."""
    np.testing.assert_array_equal(one["frame"], one["frame_plain"])
    (losses, got), (want_losses, want) = one["train"], one["train_plain"]
    assert losses == want_losses
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_sharded_overshoot_no_collision():
    """The keys of sample ids past spp (a sharded run's last round) differ
    from the next pixel's, and are JAX's bit for bit."""
    spp = 16
    pid = np.concatenate([np.zeros(spp), np.ones(spp)]).astype(np.int32)
    sid = np.concatenate([spp + np.arange(spp), np.arange(spp)]) \
        .astype(np.int32)
    got = trng.ray_keys_2d(trng.key(1), torch.from_numpy(pid),
                           torch.from_numpy(sid)).numpy()
    assert np.unique(got, axis=0).shape[0] == 2 * spp
    want = np.asarray(jax.vmap(jax.random.key_data)(jrng.ray_keys_2d(
        jax.random.key(1), jnp.asarray(pid), jnp.asarray(sid))))
    np.testing.assert_array_equal(got, want.astype(np.int64))
