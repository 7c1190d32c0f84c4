"""The port's dense histograms (direct and sorted) and the gradients of its
row gathers against the JAX package (whose histograms run their Pallas
kernels in interpret mode here).

The JAX kernel sums a bin's entries chunk by chunk in full-f32 MXU
products, the port one entry at a time within a chunk and then chunk by
chunk (``histogram.plan``), so the sums round differently: atol 1e-5,
rtol 1e-5 for values of order one. The
one-hot backward of small tables is a float32 matrix product on both
sides: the same tolerance. The sorted histogram's bins are differences of
float32 prefix sums: each side is held to float64 ``np.add.at`` within
``2 n 2^-24 max|S|`` per channel (``_prefix_atol``), and the two sides to
twice that.
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


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The plain versions here work on small tensors; one intra-op thread
    keeps them from contending with the suite's other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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


def _plan_order_sums(idx, vals, n_bins):
    """The plan's order in a numpy float32 loop: each chunk's entries in
    ascending entry order, then each slice's chunk partials in ascending
    chunk order, then the slices in ascending order, every sum from +0."""
    R, C = vals.shape
    p = thist.plan(R, n_bins, C)
    zero = np.zeros(C, np.float32)
    slice_sums = [{} for _ in range(p.slices)]
    for k in range(p.n_chunks):
        part = {}
        for r in range(k * thist.CHUNK, min(R, (k + 1) * thist.CHUNK)):
            i = int(idx[r])
            if 0 <= i < n_bins and vals[r].any():
                part[i] = part.get(i, zero) + vals[r]
        acc = slice_sums[k // p.per_slice]
        for i, v in part.items():
            acc[i] = acc.get(i, zero) + v
    out = np.zeros((n_bins, C), np.float32)
    for acc in slice_sums:
        for i, v in acc.items():
            out[i] = out[i] + v
    return p, out


def _skewed(seed, R, C, n_bins, hot=0.9):
    """One bin holds ``hot`` of the entries; 10% of the rows all zero."""
    r = np.random.default_rng(seed)
    idx = r.integers(0, n_bins, R)
    idx[r.random(R) < hot] = n_bins // 3
    vals = r.normal(size=(R, C))
    vals[r.random(R) < 0.1] = 0.0
    return idx.astype(np.int32), vals.astype(np.float32)


# (name, idx, vals, n_bins, slices > 1): one chunk; many windows (so one
# slice) over several chunks; several slices of one and of three chunks;
# one hot bin; no kept entries; C 1, 3, 16 and 30 (the window narrows to
# 1024 and 512 bins); int64 ids
def _order_cases():
    yield ("one chunk", *_entries(7, 1000, 3, 50), 50, False)
    yield ("many windows", *_entries(8, 6000, 1, 600_000), 600_000, False)
    yield ("slices of one chunk", *_entries(9, 5000, 3, 3001), 3001, True)
    yield ("slices of three chunks", *_entries(10, 10000, 1, 135_168),
           135_168, True)
    yield ("skewed", *_skewed(11, 8000, 8, 1024), 1024, True)
    idx, vals = _entries(12, 3000, 3, 500)
    yield ("none kept", idx, np.where(idx[:, None] < 0, vals, 0.0)
           .astype(np.float32), 500, True)
    for C in (1, 3, 16, 30):
        yield (f"C={C}", *_entries(20 + C, 3000, C, 2500), 2500, True)
    idx, vals = _entries(13, 4000, 3, 5000)
    yield ("int64 ids", idx.astype(np.int64), vals, 5000, True)


def test_dense_histogram_sums_in_entry_order():
    """Each bin is the float32 sum in the plan's order (a chunk's entries
    in ascending entry order, then the chunks, then the slices), which is
    what the CUDA kernel computes: the plain version agrees with a numpy
    loop over the plan bit for bit."""
    idx, vals = _entries(7, 2000, 3, 50)
    p, want = _plan_order_sums(idx, vals, 50)
    assert p.n_chunks == 2 and p.slices == 2
    got = thist.dense_histogram_plain(torch.from_numpy(idx),
                                      torch.from_numpy(vals), 50).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("case", list(_order_cases()), ids=lambda c: c[0])
def test_dense_histogram_plan_order_cases(case):
    """The plan's order on the cases above: the plain version agrees with a
    numpy loop over the plan bit for bit, and with float64 np.add.at within
    float32 summation error."""
    name, idx, vals, n_bins, multi_slice = case
    p, want = _plan_order_sums(idx, vals, n_bins)
    assert (p.slices > 1) == multi_slice, p
    got = thist.dense_histogram(torch.from_numpy(idx),
                                torch.from_numpy(vals), n_bins).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    keep = vals.any(axis=1)
    exact = _add_at(idx[keep], vals[keep], n_bins)
    n = np.bincount(idx[keep & (idx >= 0) & (idx < n_bins)].astype(np.int64),
                    minlength=n_bins)[:, None]
    abs_sum = _add_at(idx[keep], np.abs(vals[keep]), n_bins)
    assert (np.abs(got - exact) <= 2 * n * 2.0 ** -24 * abs_sum).all()
    if name == "none kept":
        assert not got.any()


def test_plan():
    """The plan at the main path's shapes: the train step's atlas (one
    window, a slice per chunk), the chief atlas (384 windows, one slice),
    a wide row (narrower windows), and no entries."""
    assert thist.plan(131072, 1024, 8) == thist.Plan(128, 2048, 1, 128, 1)
    assert thist.plan(524288, 786432, 8) == thist.Plan(512, 2048, 384, 1, 512)
    assert thist.plan(4096, 3042, 30) == thist.Plan(4, 512, 6, 4, 1)
    assert thist.plan(0, 100, 3) == thist.Plan(0, 2048, 1, 1, 1)
    p = thist.plan(131072, 1024, 8)
    assert p.slices * 1024 * 8 * 4 <= thist.SCRATCH_BYTES
    with pytest.raises(ValueError):
        thist.plan(10, 10, 20000)


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


# ---------------------------------------------------------------------------
# the sort-based histogram (histogram.py:108,270-346) and its placement
# ---------------------------------------------------------------------------

def _prefix_atol(idx, vals, n_bins):
    """Per channel, ``2 n 2^-24 max_k |S_k|``: a bin of the sorted histogram
    is a difference of two float32 prefix sums S of the id-sorted values,
    so its error scales with the largest prefix sum (n entries)."""
    idx = idx.astype(np.int64)
    key = np.where((idx >= 0) & (idx < n_bins), idx, n_bins)
    order = np.argsort(key, kind="stable")
    S = np.cumsum(vals[order].astype(np.float64), axis=0)
    max_s = np.abs(S).max(axis=0) if len(idx) else np.zeros(vals.shape[1])
    return 2.0 * len(idx) * 2.0 ** -24 * max_s


def _add_at(idx, vals, n_bins):
    out = np.zeros((n_bins, vals.shape[1]), np.float64)
    keep = (idx >= 0) & (idx < n_bins)
    np.add.at(out, idx[keep], vals[keep].astype(np.float64))
    return out


def _sorted_cases():
    """The shapes of tests/test_pallas_find.py:215-217 with a third of the
    ids one hot bin, the all-unique case of :238-247, and ids out of range
    on both sides (with all-zero rows, which this histogram keeps)."""
    r = np.random.default_rng(21)
    for R, N, C in [(5000, 10000, 8), (1000, 786432, 8), (4096, 4096, 3),
                    (100, 2048, 1), (8192, 3042, 16)]:
        idx = r.integers(0, N, size=R).astype(np.int32)
        idx[: R // 3] = idx[0]
        yield f"{R}x{N}x{C}", idx, r.normal(size=(R, C)).astype(np.float32), N
    yield "all-unique", np.arange(2048, dtype=np.int32) * 2, \
        np.ones((2048, 4), np.float32), 4096
    idx, vals = _entries(5, 3000, 3, 2500)
    yield "out-of-range", idx, vals, 2500


@pytest.mark.parametrize("case", list(_sorted_cases()), ids=lambda c: c[0])
def test_dense_histogram_sorted_matches_jax(case):
    """Against JAX's dense_histogram_sorted (its _place_kernel in interpret
    mode) and float64 np.add.at, each within the prefix-sum bound. The
    bound is a worst case: measured, the port is at most 0.4% of it from
    float64 (7.4e-6 absolute at most), JAX 0.7%, the two 0.8% apart."""
    _, idx, vals, n_bins = case
    want = np.asarray(jhist.dense_histogram_sorted(jnp.asarray(idx),
                                                   jnp.asarray(vals), n_bins))
    launches = thist.PLACE.launches
    got = thist.dense_histogram_sorted(torch.from_numpy(idx),
                                       torch.from_numpy(vals), n_bins)
    assert thist.PLACE.launches == launches  # CPU: the plain version
    assert got.shape == (n_bins, vals.shape[1]) and got.dtype == torch.float32
    got = got.numpy()
    atol = _prefix_atol(idx, vals, n_bins)
    exact = _add_at(idx, vals, n_bins)
    assert (np.abs(got - want) <= 2 * atol).all()  # two float32 roundings
    assert (np.abs(got - exact) <= atol).all()
    assert (np.abs(want - exact) <= atol).all()


def test_place_plain_places_segment_sums():
    """``place_plain`` puts each unique id's segment sum in its row, bit
    for bit, and zeros elsewhere; the rows hold the float64 np.add.at sums
    within the prefix-sum bound. Cases: C 1 to 16, a short last window, an
    n_bins that is no multiple of 2048, no entries."""
    r = np.random.default_rng(8)
    for R, n_bins, C in [(3000, 5000, 1), (4000, 2049, 3), (20000, 6144, 16),
                         (0, 300, 2), (500, 1, 5)]:
        idx = r.integers(-3, n_bins + 3, R).astype(np.int32)
        vals = r.normal(size=(R, C)).astype(np.float32)
        tex_u, seg, win_starts = thist.sorted_segments(
            torch.from_numpy(idx), torch.from_numpy(vals), n_bins)
        nw = -(-n_bins // thist.WIN)
        assert win_starts.shape == (nw + 1,) and int(win_starts[0]) == 0
        assert int(win_starts[-1]) == tex_u.shape[0]
        assert (tex_u[1:] > tex_u[:-1]).all()
        bounds = torch.arange(nw + 1) * thist.WIN
        for w in range(nw):  # window w's entries lie in its bins
            t = tex_u[win_starts[w]:win_starts[w + 1]]
            assert ((t >= bounds[w]) & (t < bounds[w + 1])).all()
        out = thist.place_plain(tex_u, seg, win_starts, n_bins)
        assert out.shape == (n_bins, C)
        rows = tex_u.long()
        assert torch.equal(out[rows].view(torch.int32), seg.view(torch.int32))
        mask = torch.ones(n_bins, dtype=torch.bool)
        mask[rows] = False
        assert (out[mask] == 0).all()
        assert (np.abs(out.numpy() - _add_at(idx, vals, n_bins))
                <= _prefix_atol(idx, vals, n_bins)).all()


def test_dense_histogram_sorted_counts_exact():
    """Unit values: every prefix sum is an integer below 2^24, so the
    counts are exact (tests/test_pallas_find.py:228-235)."""
    r = np.random.default_rng(2)
    idx = r.integers(0, 10000, size=5000).astype(np.int32)
    idx[:2000] = idx[0]
    vals = np.ones((5000, 4), np.float32)
    got = thist.dense_histogram_sorted(torch.from_numpy(idx),
                                       torch.from_numpy(vals), 10000)
    np.testing.assert_array_equal(got.numpy(), _add_at(idx, vals, 10000))
