"""The port's dense histogram and the gradients of its row gathers against
the JAX package (whose histogram runs its Pallas kernel in interpret mode
here).

The JAX kernel sums a bin's entries chunk by chunk in full-f32 MXU
products, the port one entry at a time in ascending order, so the sums
round differently: atol 1e-5, rtol 1e-5 for values of order one. The
one-hot backward of small tables is a float32 matrix product on both
sides: the same tolerance.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from sexy_raytracer_tpu.ops import histogram as jhist  # noqa: E402
from sexy_raytracer_tpu.ops import lookup as jlookup  # noqa: E402
from sexy_raytracer_tpu_torch.ops import histogram as thist  # noqa: E402
from sexy_raytracer_tpu_torch.ops import lookup as tlookup  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)


def _entries(seed, R, C, n_bins):
    """Ids with heavy duplicates, negative and out-of-range ids, and a
    fifth of the rows all zero."""
    r = np.random.default_rng(seed)
    idx = r.integers(-40, n_bins + 40, R)
    idx[: R // 3] = r.integers(0, 24, R // 3)
    vals = r.normal(size=(R, C))
    vals[r.random(R) < 0.2] = 0.0
    return idx.astype(np.int32), vals.astype(np.float32)


@pytest.mark.parametrize("C", [3, 8])
@pytest.mark.parametrize("R,n_bins", [(3000, 3001), (6000, 5000),
                                      (1000, 40)])
def test_dense_histogram_plain_matches_jax(C, R, n_bins):
    idx, vals = _entries(R + C, R, C, n_bins)
    want = np.asarray(jhist.dense_histogram(jnp.asarray(idx),
                                            jnp.asarray(vals), n_bins))
    launches = thist.HISTOGRAM.launches
    got = thist.dense_histogram(torch.from_numpy(idx), torch.from_numpy(vals),
                                n_bins)
    assert thist.HISTOGRAM.launches == launches  # CPU: the plain version
    assert got.shape == (n_bins, C) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_dense_histogram_sums_in_entry_order():
    """Each bin is the float32 sum of its entries in ascending entry order,
    which is what the CUDA kernel computes: the two agree bit for bit."""
    idx, vals = _entries(7, 2000, 3, 50)
    got = thist.dense_histogram_plain(torch.from_numpy(idx),
                                      torch.from_numpy(vals), 50).numpy()
    want = np.zeros((50, 3), np.float32)
    for i, v in zip(idx, vals):
        if 0 <= i < 50 and v.any():
            want[i] = want[i] + v
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("n_rows", [5, 1024, 1025, 3042])
def test_table_lookup_gradient_matches_jax(n_rows):
    """Both sides of ONEHOT_MAX_ROWS: the one-hot product at <= 1024 rows,
    the dense histogram above."""
    r = np.random.default_rng(n_rows)
    R, K = 4096, 16
    table = r.normal(size=(n_rows, K)).astype(np.float32)
    idx = r.integers(0, n_rows, R).astype(np.int32)
    idx[:1000] = idx[0]  # a hot row
    g = r.normal(size=(R, K)).astype(np.float32)
    _, vjp = jax.vjp(lambda t: jlookup.table_lookup(t, jnp.asarray(idx)),
                     jnp.asarray(table))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    t = torch.from_numpy(table).requires_grad_(True)
    out = tlookup.table_lookup(t, torch.from_numpy(idx))
    np.testing.assert_array_equal(out.detach().numpy(), table[idx])
    (got,) = torch.autograd.grad(out, t, torch.from_numpy(g))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_atlas_lookup_gradient_matches_jax():
    r = np.random.default_rng(3)
    rows, W, C, R = 64, 32, 8, 4096
    atlas = r.uniform(0, 255, (rows, W, C)).astype(np.float32)
    idx = r.integers(0, rows * W, R).astype(np.int32)
    g = r.normal(size=(R, C)).astype(np.float32)
    g[r.random(R) < 0.3] = 0.0  # dead lanes
    _, vjp = jax.vjp(lambda a: jlookup.atlas_lookup(a, jnp.asarray(idx)),
                     jnp.asarray(atlas))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    a = torch.from_numpy(atlas).requires_grad_(True)
    out = tlookup.atlas_lookup(a, torch.from_numpy(idx))
    np.testing.assert_array_equal(out.detach().numpy(),
                                  atlas.reshape(-1, C)[idx])
    (got,) = torch.autograd.grad(out, a, torch.from_numpy(g))
    assert got.shape == atlas.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)
