"""The port's threefry2x32 must give jax.random's words bit for bit: every
per-sample comparison between the packages rests on it."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from sexy_raytracer_tpu.utils import rng as jrng  # noqa: E402
from sexy_raytracer_tpu_torch.render.integrator import (  # noqa: E402
    bounce_uniforms,
)
from sexy_raytracer_tpu_torch.utils import rng as trng  # noqa: E402


def _jkey_data(keys):
    return np.asarray(jax.random.key_data(keys)).astype(np.int64)


@pytest.fixture(scope="module")
def pid_sid():
    r = np.random.default_rng(7)
    pid = np.concatenate([[0, 1, 1280 * 720 - 1, 1280 * 720],
                          r.integers(0, 1280 * 720 + 1, 60)]).astype(np.int32)
    sid = np.concatenate([[0, 4999, 5000, 3],
                          r.integers(0, 5001, 60)]).astype(np.int32)
    return pid, sid


@pytest.mark.parametrize("seed", [0, 1, 42, 2**31 - 1, -1, -2**31,
                                  2**32 + 3])
def test_key_and_fold_in(seed, pid_sid):
    pid, _ = pid_sid
    jk = jax.random.key(seed)
    tk = trng.key(seed)
    np.testing.assert_array_equal(tk.numpy(), _jkey_data(jk))
    jf = jax.vmap(lambda d: jax.random.fold_in(jk, d))(jnp.asarray(pid))
    tf = trng.fold_in(tk, torch.from_numpy(pid))
    np.testing.assert_array_equal(tf.numpy(), _jkey_data(jf))


def test_ray_keys_2d(pid_sid):
    pid, sid = pid_sid
    jk = jrng.ray_keys_2d(jax.random.key(3), jnp.asarray(pid),
                          jnp.asarray(sid))
    tk = trng.ray_keys_2d(trng.key(3), torch.from_numpy(pid),
                          torch.from_numpy(sid))
    np.testing.assert_array_equal(tk.numpy(), _jkey_data(jk))


@pytest.mark.parametrize("n", [1, 5, 6])
def test_bits_and_uniform_block(n, pid_sid):
    pid, sid = pid_sid
    jk = jrng.ray_keys_2d(jax.random.key(0), jnp.asarray(pid),
                          jnp.asarray(sid))
    tk = trng.ray_keys_2d(trng.key(0), torch.from_numpy(pid),
                          torch.from_numpy(sid))
    jb = jax.vmap(lambda k: jax.random.bits(k, (n,)))(jk)
    np.testing.assert_array_equal(trng.bits(tk, n).numpy(),
                                  np.asarray(jb).astype(np.int64))
    ju = jrng.per_ray_uniform_block(jk, n)
    tu = trng.per_ray_uniform_block(tk, n)
    assert tu.dtype == torch.float32
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))


def _jax_bounce_uniforms(jk, n_bounces):
    """``bits(fold_in(k, 100 + b), (6,))`` as 24-bit U[0,1) floats, by
    ``jax.random``, for every key of ``jk`` and bounce."""
    bits = jax.vmap(lambda k: jnp.stack([
        jax.random.bits(jax.random.fold_in(k, 100 + b), (6,))
        for b in range(n_bounces)]))(jk)
    return np.asarray((bits >> 8).astype(jnp.float32)
                      * jnp.float32(1.0 / (1 << 24)))


def test_bounce_draws_match_integrator_stream(pid_sid):
    """integrator.py:268-275 draws bits(fold_in(k, 100 + b), (6,))."""
    pid, sid = pid_sid
    jk = jrng.ray_keys_2d(jax.random.key(1), jnp.asarray(pid),
                          jnp.asarray(sid))
    tk = trng.ray_keys_2d(trng.key(1), torch.from_numpy(pid),
                          torch.from_numpy(sid))
    np.testing.assert_array_equal(bounce_uniforms(tk, 4).numpy(),
                                  _jax_bounce_uniforms(jk, 4))


def test_shaped_transforms(rng_np):
    u = rng_np.random((3, 256)).astype(np.float32)
    cases = [
        (jrng.unit_vector_from_uniforms, trng.unit_vector_from_uniforms, 2),
        (jrng.in_unit_sphere_from_uniforms,
         trng.in_unit_sphere_from_uniforms, 3),
        (jrng.in_unit_disk_from_uniforms, trng.in_unit_disk_from_uniforms, 2),
    ]
    for jf, tf, k in cases:
        want = np.asarray(jf(*(jnp.asarray(x) for x in u[:k])))
        got = tf(*(torch.from_numpy(x) for x in u[:k])).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("seed", [0, 1, 42, 2**31 - 1, -1, -2**31,
                                  2**32 + 3])
def test_split_matches_jax(seed, n, pid_sid):
    """``rng.split`` gives ``jax.random.split``'s words, on one key and on
    a batch of folded keys."""
    jk = jax.random.key(seed)
    np.testing.assert_array_equal(trng.split(trng.key(seed), n).numpy(),
                                  _jkey_data(jax.random.split(jk, n)))
    pid = jnp.asarray(pid_sid[0])
    jb = jax.vmap(lambda d: jax.random.split(jax.random.fold_in(jk, d), n))(
        pid)
    tb = trng.split(trng.fold_in(trng.key(seed), torch.from_numpy(
        pid_sid[0])), n)
    assert tb.shape == (pid.shape[0], n, 2)
    np.testing.assert_array_equal(tb.numpy(), _jkey_data(jb))


@pytest.mark.parametrize("shape,lo,hi", [((), 0.0, 1.0), ((5,), 0.0, 1.0),
                                         ((5,), -2.0, 3.5),
                                         ((2, 3), 0.1, 0.7)])
def test_uniform_matches_jax(shape, lo, hi):
    """``rng.uniform`` gives ``jax.random.uniform``'s float32 bits (23-bit
    mantissa, not the integrator's 24-bit draw) on 4,096 folded keys."""
    jk = jax.vmap(lambda i: jax.random.fold_in(jax.random.key(3), i))(
        jnp.arange(4096))
    tk = trng.fold_in(trng.key(3), torch.arange(4096))
    want = np.asarray(jax.vmap(lambda k: jax.random.uniform(
        k, shape, minval=lo, maxval=hi))(jk))
    got = trng.uniform(tk, shape, lo, hi)
    assert got.dtype == torch.float32 and got.shape == (4096, *shape)
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))
    one = trng.uniform(trng.fold_in(trng.key(3), 17), shape, lo, hi)
    np.testing.assert_array_equal(one.numpy().view(np.int32),
                                  want[17].view(np.int32))
    assert (got >= lo).all() and (got < hi).all()


@pytest.mark.parametrize("seed", [0, -1, 2**32 + 3])
def test_cpu_tensors_take_the_plain_draws(seed, pid_sid):
    """``ray_keys_and_camera`` and ``bounce_draws`` on CPU tensors run the
    plain int64 versions, with no kernel launch: ``jax.random``'s keys and
    draws, bit for bit."""
    pid, sid = pid_sid
    before = trng.RAY_KEYS.launches, trng.BOUNCE_DRAWS.launches
    keys, ucam = trng.ray_keys_and_camera(trng.key(seed),
                                          torch.from_numpy(pid),
                                          torch.from_numpy(sid))
    u = trng.bounce_draws(keys, 4)
    assert (trng.RAY_KEYS.launches, trng.BOUNCE_DRAWS.launches) == before
    jk = jrng.ray_keys_2d(jax.random.key(seed), jnp.asarray(pid),
                          jnp.asarray(sid))
    np.testing.assert_array_equal(keys.numpy(), _jkey_data(jk))
    np.testing.assert_array_equal(
        ucam.numpy().view(np.int32),
        np.asarray(jrng.per_ray_uniform_block(jk, 5)).view(np.int32))
    np.testing.assert_array_equal(u.numpy().view(np.int32),
                                  _jax_bounce_uniforms(jk, 4).view(np.int32))
