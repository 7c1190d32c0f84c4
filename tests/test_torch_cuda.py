"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked ``cuda``: they skip where no CUDA device is present. Run them
on a GPU machine with ``python -m pytest tests/test_torch_cuda.py -m cuda``.

The kernels are built without FMA contraction and keep the plain
versions' evaluation order, so the find kernels must return the same prim
ids and t bits, the histogram the same sums (in the order of its plan,
``ops/histogram.plan``) and the sorted histogram's placement the same
table; the fused kernels are held
to the fused-math tolerance of tests/test_fused.py (atol 2e-5, rtol 1e-5).
Their VJPs sum the adjoint in another order than autograd: atol 2e-5,
rtol 1e-4, with a budget of ill-conditioned lanes (``checks.vjp_outside``),
on cotangents scaled to unit size so that the VJPs stand well above atol
(``checks.vjp_check_power``). A train step on the card is held to the same
step on the CPU with the gate of bench.py:192.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sexy_raytracer_tpu_torch.diff.inverse import (  # noqa: E402
    _loss_fn,
    sample_tile_ids,
)
from sexy_raytracer_tpu_torch.diff.params import (  # noqa: E402
    DEFAULT_TRAINABLE,
    extract_params,
)
from sexy_raytracer_tpu_torch import checks  # noqa: E402
from sexy_raytracer_tpu_torch.models import presets  # noqa: E402
from sexy_raytracer_tpu_torch.models.scene import MAT_LIGHT  # noqa: E402
from sexy_raytracer_tpu_torch.ops import _cuda  # noqa: E402
from sexy_raytracer_tpu_torch.ops import brute as tbrute  # noqa: E402
from sexy_raytracer_tpu_torch.ops import find as tfind  # noqa: E402
from sexy_raytracer_tpu_torch.ops import fused as tfused  # noqa: E402
from sexy_raytracer_tpu_torch.ops import histogram as thist  # noqa: E402
from sexy_raytracer_tpu_torch.ops import intersect as tint  # noqa: E402
from sexy_raytracer_tpu_torch.ops.intersect import emissive_sphere_hit  # noqa: E402
from sexy_raytracer_tpu_torch.render.camera import Camera  # noqa: E402
from sexy_raytracer_tpu_torch.render.integrator import (  # noqa: E402
    trace_rays_fused,
)
from sexy_raytracer_tpu_torch.tools import histogram_split  # noqa: E402
from sexy_raytracer_tpu_torch.tools import shade_split  # noqa: E402
from sexy_raytracer_tpu_torch.utils import rng  # noqa: E402

TRAIN = DEFAULT_TRAINABLE + ("tri_v0", "tri_v1", "tri_v2")

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _cuda.build()
    return torch.device("cuda")


@pytest.fixture(scope="module")
def scene(dev, tmp_path_factory):
    s, _ = presets.flagship_standin(
        n=39, data_dir=str(tmp_path_factory.mktemp("no-assets")), device=dev)
    return s


def _fuzz(n, dev, seed=42):
    r = np.random.default_rng(seed)
    org = r.normal(0, 3.0, (n, 3)) + np.array([0.0, 2.5, 1.0])
    d = r.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t = r.uniform(0, 1, n)
    t_min = np.where(r.random(n) < 0.1, 3.0e38, 0.001)
    return [torch.tensor(x, dtype=torch.float32, device=dev)
            for x in (org, d, t, t_min)]


def test_find_closest_kernel_matches_plain(scene, dev):
    """Kernel 1 (the cluster walk on 128-ray resident lists) against its
    plain version: the same prim ids and t bits."""
    org, d, t, t_min = _fuzz(8192, dev)
    inp = tfind.resident_inputs(scene, org, d, t, t_min)
    n = scene.num_triangles
    before = tfind.FIND_CLOSEST.launches
    t_k, p_k = tfind.find_closest(*inp)
    torch.cuda.synchronize()
    assert tfind.FIND_CLOSEST.launches == before + 1
    t_p, p_p = tfind.find_streamed_plain(*inp)
    assert torch.equal(p_k, p_p)
    assert torch.equal(t_k.view(torch.int32), t_p.view(torch.int32))
    assert ((p_k >= 0) & (p_k < n)).sum() > 100


def _bounce_calls(scene, dev, n=8192):
    """Kernel 1's arguments at bounces 0, 1 and 2 of a trace of ``n``
    camera rays of the flagship frame, and the hit-record and shade stacks
    of its four bounces."""
    from sexy_raytracer_tpu_torch.render import integrator

    cfg = presets.flagship_standin(n=2, height=72, device="cpu")[1]
    cam = Camera.from_config(cfg.camera, cfg.aspect, device=dev)
    r = np.random.default_rng(23)
    u = torch.tensor(r.uniform(0.2, 0.8, n), dtype=torch.float32, device=dev)
    v = torch.tensor(r.uniform(0.1, 0.9, n), dtype=torch.float32, device=dev)
    o, d, tm = cam.get_rays(u, v, torch.tensor(r.random((n, 3)),
                                               dtype=torch.float32,
                                               device=dev))
    keys = torch.stack([torch.arange(n, device=dev),
                        torch.full((n,), 9, device=dev)], dim=1)
    return histogram_split.capture_calls(
        [tfind, integrator, integrator],
        ["find_closest", "hitrec_fused", "shade_carry_fused"],
        lambda: trace_rays_fused(scene, o, d, tm, keys,
                                 torch.ones(3, device=dev), 4,
                                 last_bounce_vis=True))


def _assert_kernel_1(inp):
    t_k, p_k = tfind.find_closest(*inp)
    t_p, p_p = tfind.find_streamed_plain(*inp)
    torch.cuda.synchronize()
    assert torch.equal(p_k, p_p)
    assert torch.equal(t_k.view(torch.int32), t_p.view(torch.int32))
    return p_k


@pytest.mark.parametrize("bounce", [0, 1, 2])
def test_find_closest_kernel_at_each_bounce(scene, dev, bounce):
    """Kernel 1 on the calls of a 4-bounce trace of camera rays (the
    lists, rays and boxes the integrator gives it): prim ids and t bits
    of the plain walk."""
    calls = _bounce_calls(scene, dev)["find_closest"]
    assert len(calls) == 3
    p_k = _assert_kernel_1(calls[bounce])
    assert (p_k >= 0).sum() > 500


@pytest.mark.parametrize("wave", ["ties", "per-ray t_min", "dead lanes",
                                  "zero components", "inside boxes",
                                  "no cull"])
def test_find_closest_kernel_on_hard_wavefronts(scene, dev, wave):
    """Kernel 1 against its plain version on ``checks.resident_wavefronts``
    (exact ties between clusters, per-ray t_min, dead lanes and a dead
    block, zero direction components, origins inside cluster boxes) and on
    uncut lists (every cluster, entry 0: ``pallas_nocull``)."""
    waves = checks.resident_wavefronts(scene, n=8192)
    arrs = waves["per-ray t_min" if wave == "no cull" else wave]
    org, d, t, t_min = (torch.from_numpy(x).to(dev) for x in arrs)
    inp = tfind.resident_inputs(scene, org, d, t, t_min,
                                cull=wave != "no cull")
    p_k = _assert_kernel_1(inp)
    if wave == "dead lanes":
        assert bool((p_k[256:384] == -1).all())
    assert ((p_k >= 0) & (p_k < scene.num_triangles)).sum() > 100


def test_find_closest_kernel_without_triangles(dev, tmp_path_factory):
    """A scene of spheres only: no list to walk, the spheres' hits."""
    s, _ = presets.flagship_standin(
        n=2, data_dir=str(tmp_path_factory.mktemp("no-assets")), device=dev)
    s = s._replace(**{k: getattr(s, k)[:0] for k in (
        "tri_v0", "tri_v1", "tri_v2", "tri_n", "tri_d", "tri_q", "tri_c")},
        cluster_min=s.cluster_min[:0], cluster_max=s.cluster_max[:0])
    org, d, t, t_min = _fuzz(4096, dev, seed=8)
    inp = tfind.resident_inputs(s, org, d, t, t_min)
    p_k = _assert_kernel_1(inp)
    assert (p_k >= 0).sum() > 100


def _mixed_stacks(scene, dev, R):
    """A shade wavefront of ``R`` rays that mixes every material type and
    texture kind, with 10% dead lanes: the stacks of a trace's bounces,
    tiled to ``R`` columns, with the int rows redrawn."""
    stacks = _bounce_calls(scene, dev, 4096)["shade_carry_fused"]
    sf = torch.cat([a[0] for a in stacks], dim=1)
    reps = -(-R // sf.shape[1])
    sf = sf.repeat(1, reps)[:, :R].contiguous()
    r = np.random.default_rng(R)
    si = np.stack([np.arange(R) % 4] + [r.integers(0, 4, R)
                                        for _ in range(tfused.NSI - 1)])
    sf[12] = torch.tensor(r.random(R) > 0.1, dtype=torch.float32, device=dev)
    return sf, torch.tensor(si, dtype=torch.int32, device=dev)


@pytest.mark.parametrize("R", [1, 127, 128, 385, 388, 4099, 524288])
def test_shade_kernel_matches_plain(scene, dev, R):
    """Kernel 4 (the staged kernel) bit for bit against its plain version,
    at one ray, a part tile, a whole tile, a whole tile and one ray more
    (R not a multiple of 4: no bulk copy), a ragged last tile with R a
    multiple of 4, and the frame chunk."""
    sf, si = _mixed_stacks(scene, dev, R)
    before = tfused.SHADE.launches
    got = tfused.shade_carry_fused(sf, si)
    torch.cuda.synchronize()
    assert tfused.SHADE.launches == before + 1
    want = tfused.shade_carry_math(sf, si)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def _unaligned(x):
    """``shade_split.unaligned``, its base checked: kernels 4 and 6 read it
    from device memory, not with bulk copies."""
    y = shade_split.unaligned(x)
    assert y.data_ptr() % 16 == 4
    return y


def _hit_stacks(scene, dev, R):
    """A hit-record wavefront of ``R`` rays that mixes triangle, sphere and
    miss lanes (the stacks of a trace's four bounces, tiled to ``R``
    columns) with 5% pad lanes (all-zero columns, as JAX pads a
    wavefront)."""
    stacks = _bounce_calls(scene, dev, 4096)["hitrec_fused"]
    hf = torch.cat([a[0] for a in stacks], dim=1)
    hf = hf.repeat(1, -(-R // hf.shape[1]))[:, :R].contiguous()
    pad = torch.tensor(np.random.default_rng(R).random(R) < 0.05,
                       device=dev)
    hf[:, pad] = 0.0
    tri = hf[32] > 0.5
    assert R < 64 or (tri.any() and (~tri).any())
    return hf


@pytest.mark.parametrize("R", [1, 63, 64, 65, 385, 388, 4099, 524288])
def test_hitrec_kernel_matches_plain(scene, dev, R):
    """Kernel 3 (one thread a ray, each computing the branch it keeps)
    bit-equal to its plain version (a NaN where both give one), at one
    ray, part and whole warps and blocks, R not a multiple of 4, and the
    frame chunk's width, in one launch."""
    hf = _hit_stacks(scene, dev, R)
    before = tfused.HITREC.launches
    got = tfused.hitrec_fused(hf)
    torch.cuda.synchronize()
    assert tfused.HITREC.launches == before + 1
    want = tfused.hitrec_math(hf)
    same = (got.view(torch.int32) == want.view(torch.int32)) \
        | (got.isnan() & want.isnan())
    assert bool(same.all()), f"{int((~same).sum())} values differ"


@pytest.mark.parametrize("R", [1, 31, 32, 33, 385, 388, 4099, 524288])
def test_shade_vjp_kernel_matches_plain(scene, dev, R):
    """Kernel 6 (one warp a bulk-copied tile, its sums in shared memory)
    against autograd of its plain version (``checks.vjp_outside`` on a
    unit-size cotangent), at one ray, part and whole tiles, a whole tile
    and one ray more, R not a multiple of 4 (no bulk copy), a ragged last
    tile with R a multiple of 4, and the frame chunk's width; on the rays
    with no hit (the pass-through, no forward) equal to the plain VJP;
    the device-memory path (the same stacks, unaligned) bit-equal to it,
    and one launch each."""
    sf, si = _mixed_stacks(scene, dev, R)
    gen = torch.Generator(device=dev).manual_seed(R)
    g = checks.unit_cotangent(torch.randn((tfused.NSO, R), generator=gen,
                                          device=dev))
    before = tfused.SHADE_BWD.launches
    got = tfused.shade_bwd(sf, si, g)
    torch.cuda.synchronize()
    assert tfused.SHADE_BWD.launches == before + 1
    want = tfused.shade_vjp_plain(sf, si, g)
    checks.vjp_outside(got, want)
    if R >= 4099:
        assert checks.vjp_check_power(got, want) > 0
    no_hit = sf[26] <= 0.5
    assert R < 385 or bool(no_hit.any())
    assert torch.equal(got[:, no_hit], want[:, no_hit])
    off = tfused.shade_bwd(_unaligned(sf), _unaligned(si), _unaligned(g))
    torch.cuda.synchronize()
    assert tfused.SHADE_BWD.launches == before + 2
    assert torch.equal(off.view(torch.int32), got.view(torch.int32))


@pytest.mark.parametrize("shape", range(4))
def test_stack_copy_kernel_matches_plain(scene, dev, shape):
    """The copy floor's kernel against its plain version, at the stack
    shapes of kernels 3, 4, 5 and 6 (``fused.COPY_SHAPES``)."""
    nf, ni, no = tfused.COPY_SHAPES[shape]
    sf, si = _mixed_stacks(scene, dev, 4099)
    f = sf.repeat(2, 1)[:nf].contiguous()
    si = si[:ni].contiguous() if ni else None
    before = tfused.STACK_COPY.launches
    got = tfused.stack_copy(f, si, no)
    torch.cuda.synchronize()
    assert tfused.STACK_COPY.launches == before + 1
    assert torch.equal(got.view(torch.int32),
                       tfused.stack_copy_plain(f, si, no).view(torch.int32))


def test_find_any_kernel_matches_plain(scene, dev):
    """Occlusion as the integrator asks for it: emissive spheres cleared
    from the sphere pack's valid column, bounded by the emissive hit."""
    org, d, t, t_min = _fuzz(8192, dev, seed=7)
    emis = scene.mat_type[scene.sph_mat.long()] == MAT_LIGHT
    assert emis.any() and (~emis).any()
    t_em, _ = emissive_sphere_hit(scene, org, d, t, t_min)
    bound = torch.where(t_min < 1e38,
                        torch.where(torch.isfinite(t_em), t_em, 3.0e38),
                        -3.0e38)
    before = tfind.FIND_ANY.launches
    occ_k = tfind.find_occluded(scene, org, d, t, bound, t_min=t_min,
                                sphere_occluder=~emis)
    torch.cuda.synchronize()
    assert tfind.FIND_ANY.launches == before + 1
    inp = tfind.occluded_inputs(scene, org, d, t, bound, t_min=t_min,
                                sphere_occluder=~emis)
    occ_p = tfind.find_any_plain(*inp)[:8192] > 0
    assert torch.equal(occ_k, occ_p)
    # lit lanes stay lit: some rays reach the light unoccluded
    lit = (t_min < 1e38) & torch.isfinite(t_em)
    assert (lit & ~occ_k).sum() > 0


def test_fused_kernels_match_plain(scene, dev, monkeypatch):
    """Every hit-record and shade launch of a 4-bounce trace, against the
    plain math on the same stacks."""
    from sexy_raytracer_tpu_torch.render import integrator

    pairs = []

    def checked(kernel, plain):
        def run(*stacks):
            out = kernel(*stacks)
            pairs.append((out, plain(*stacks)))
            return out
        return run

    monkeypatch.setattr(integrator, "hitrec_fused",
                        checked(tfused.hitrec_fused, tfused.hitrec_math))
    monkeypatch.setattr(integrator, "shade_carry_fused",
                        checked(tfused.shade_carry_fused,
                                tfused.shade_carry_math))
    org, d, t, _ = _fuzz(4096, dev, seed=5)
    keys = torch.stack([torch.arange(4096, device=dev),
                        torch.full((4096,), 3, device=dev)], dim=1)
    trace_rays_fused(scene, org, d, t, keys, torch.ones(3, device=dev), 4,
                     last_bounce_vis=True)
    assert len(pairs) == 8
    for got, want in pairs:
        torch.testing.assert_close(got, want, atol=2e-5, rtol=1e-5)


def test_trace_on_card_matches_cpu(scene, dev):
    org, d, t, _ = _fuzz(4096, dev, seed=3)
    keys = torch.stack([torch.arange(4096, device=dev),
                        torch.full((4096,), 7, device=dev)], dim=1)
    bg = torch.tensor([0.5, 0.7, 0.9])
    rad_k = trace_rays_fused(scene, org, d, t, keys, bg.to(dev), 4,
                             last_bounce_vis=True).cpu().numpy()
    cpu = scene.to("cpu")
    rad_p = trace_rays_fused(cpu, org.cpu(), d.cpu(), t.cpu(), keys.cpu(),
                             bg, 4, last_bounce_vis=True).numpy()
    close = np.isclose(rad_k, rad_p, atol=2e-5, rtol=1e-5).all(axis=1)
    assert close.mean() >= 0.995


def _grads(scene, cfg, ids, dev, names=TRAIN):
    """Loss and gradients of a 4-bounce, 2-spb mse loss on ``dev``."""
    scene = scene.to(dev)
    params = {k: v.clone().requires_grad_(True)
              for k, v in extract_params(scene, names).items()}
    cam = Camera.from_config(cfg.camera, cfg.aspect, device=dev)
    loss = _loss_fn(params, scene, cam, ids.to(dev),
                    torch.full((ids.shape[0], 3), 0.25, device=dev), 0,
                    rng.key(5, device=dev),
                    torch.tensor(cfg.background, device=dev),
                    width=cfg.width, height=cfg.height, spb=2, spp_total=2,
                    max_bounce=4, method="auto", last_bounce_vis=True)
    grads = torch.autograd.grad(loss, list(params.values()))
    return float(loss.detach()), {k: g.cpu() for k, g in zip(params, grads)}


@pytest.fixture(scope="module")
def small_cfg():
    """The flagship's camera at 128x72."""
    return presets.flagship_standin(n=2, height=72, device="cpu")[1]


def test_vjp_kernels_match_plain(scene, dev, small_cfg, monkeypatch):
    """Every hit-record and shade VJP launch of a train-step backward,
    against autograd of the plain math on the same stacks."""
    calls = {"hitrec": [], "shade": []}

    def record(name, fn):
        def run(*args):
            calls[name].append(tuple(a.clone() for a in args))
            return fn(*args)
        return run

    hitrec_bwd, shade_bwd = tfused.hitrec_bwd, tfused.shade_bwd
    monkeypatch.setattr(tfused, "hitrec_bwd", record("hitrec", hitrec_bwd))
    monkeypatch.setattr(tfused, "shade_bwd", record("shade", shade_bwd))
    ids = torch.from_numpy(sample_tile_ids(np.random.default_rng(1), 128, 72,
                                           2048))
    before = (tfused.HITREC_BWD.launches, tfused.SHADE_BWD.launches)
    _grads(scene, small_cfg, ids, dev)
    torch.cuda.synchronize()
    assert len(calls["hitrec"]) == len(calls["shade"]) == 4
    assert (tfused.HITREC_BWD.launches, tfused.SHADE_BWD.launches) == \
        (before[0] + 4, before[1] + 4)
    # the step's cotangents are small (a mean over pixels, channels and
    # samples); the VJP is linear in them, so at unit size its values
    # stand above atol and the check can fail a wrong kernel. The last
    # bounce's hit record gets a zero cotangent: nothing to check there
    hit_calls = [c for c in calls["hitrec"] if bool(c[1].any())]
    assert len(hit_calls) >= 3
    for hf, g in hit_calls:
        g = checks.unit_cotangent(g)
        got = hitrec_bwd(hf, g)
        want = tfused.hitrec_vjp_plain(hf, g)
        ill = checks.ill_conditioned_lanes(hf, tfused.hitrec_math(hf))
        checks.vjp_outside(got, want, ill)
        assert checks.vjp_check_power(got, want, ill) > 0
    for sf, si, g in calls["shade"]:
        g = checks.unit_cotangent(g)
        got = shade_bwd(sf, si, g)
        want = tfused.shade_vjp_plain(sf, si, g)
        checks.vjp_outside(got, want)
        assert checks.vjp_check_power(got, want) > 0


def test_histogram_kernel_matches_plain(dev):
    """Bit-equal to the plain version, and to itself on a second launch:
    duplicates, negative and out-of-range ids, all-zero rows, C 3 and 8."""
    r = np.random.default_rng(11)
    for R, C, n_bins in ((131072, 8, 1024), (50000, 3, 70001)):
        idx = r.integers(-100, n_bins + 100, R)
        idx[: R // 4] = r.integers(0, 16, R // 4)
        vals = r.normal(size=(R, C))
        vals[r.random(R) < 0.2] = 0.0
        idx = torch.tensor(idx, dtype=torch.int32, device=dev)
        vals = torch.tensor(vals, dtype=torch.float32, device=dev)
        before = thist.HISTOGRAM.launches
        got = thist.dense_histogram(idx, vals, n_bins)
        again = thist.dense_histogram(idx, vals, n_bins)
        torch.cuda.synchronize()
        assert thist.HISTOGRAM.launches == before + 2
        want = thist.dense_histogram_plain(idx, vals, n_bins)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        assert torch.equal(got.view(torch.int32), again.view(torch.int32))


def _histogram_cases(dev):
    """(label, idx, vals, n_bins): one bin holding 90% of the entries at
    the train step's shape (128 slices), int64 ids over several slices of
    several chunks with a row of 30 channels (512-bin windows), the chief
    atlas's size (384 windows, one slice), strided views, and 5,000,000
    bins (64-bit sort keys)."""
    r = np.random.default_rng(12)
    idx = r.integers(-100, 9100, 300000)
    idx[:5000] = 7
    vals = r.normal(size=(300000, 30))
    vals[r.random(300000) < 0.3] = 0.0
    yield ("skewed", *histogram_split.skewed_input(dev))
    yield ("sliced int64 C=30",
           torch.tensor(idx, dtype=torch.int64, device=dev),
           torch.tensor(vals, dtype=torch.float32, device=dev), 9000)
    yield ("wide", *histogram_split.wide_input(dev))
    # views, read through their strides: every other id of an int64
    # tensor, and the values as the transpose of a [C, R] tensor
    idx = torch.tensor(r.integers(-10, 1100, 2 * 131072), dtype=torch.int64,
                       device=dev)[::2]
    vals = torch.tensor(r.normal(size=(8, 131072)), dtype=torch.float32,
                        device=dev).t()
    yield ("strided views", idx, vals, 1024)
    # past 2^22 bins the sort's keys are 64 bits wide
    idx = r.integers(0, 5_000_000, 40000)
    idx[:3000] = 4_999_999
    yield ("5,000,000 bins",
           torch.tensor(idx, dtype=torch.int32, device=dev),
           torch.tensor(r.normal(size=(40000, 2)), dtype=torch.float32,
                        device=dev), 5_000_000)


def test_histogram_kernel_skewed_sliced_and_wide(dev):
    """The three passes bit-equal to the plan-order plain version and to a
    second launch where one bin holds almost every entry, where the chunk
    range is cut into slices of several chunks, at 786,432 and 5,000,000
    bins, and on strided views."""
    plans = []
    for label, idx, vals, n_bins in _histogram_cases(dev):
        plans.append(thist.plan(vals.shape[0], n_bins, vals.shape[1]))
        before = thist.HISTOGRAM.launches
        got = thist.dense_histogram(idx, vals, n_bins)
        again = thist.dense_histogram(idx, vals, n_bins)
        torch.cuda.synchronize()
        assert thist.HISTOGRAM.launches == before + 2, label
        want = thist.dense_histogram_plain(idx, vals, n_bins)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), \
            label
        assert torch.equal(got.view(torch.int32), again.view(torch.int32)), \
            label
    assert [p.slices > 1 for p in plans] == [True, True, False, True,
                                             False]
    assert plans[1].per_slice > 1 and plans[1].win == 512


def test_histogram_wrapper_runs_no_torch_glue(dev):
    """One call of the CUDA wrapper: no torch op but the allocations of
    ``out`` and the scratch (no sort, searchsorted or mask), and at most 3
    device kernels, all of them the library's passes."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for label, idx, vals, n_bins in _histogram_cases(dev):
        thist.dense_histogram(idx, vals, n_bins)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            thist.dense_histogram(idx, vals, n_bins)
            torch.cuda.synchronize()
        events = prof.events()
        ops = {e.name for e in events if e.device_type == DeviceType.CPU
               and e.name.startswith("aten::")}
        assert ops <= {"aten::empty", "aten::empty_strided",
                       "aten::contiguous"}, (label, ops)
        kernels = [e.name for e in events if e.device_type == DeviceType.CUDA]
        assert 1 <= len(kernels) <= 3, (label, kernels)
        assert all(any(f"::{n}" in k for n in (
            "chunk_reduce_kernel", "window_combine_kernel",
            "slice_sum_kernel")) for k in kernels), (label, kernels)


def test_train_gradients_on_card_match_cpu(scene, dev, small_cfg):
    """Loss and gradients with the triangle vertices trained, so that the
    triangle-pack backward takes the histogram: the card's gradients are
    non-zero and within the gate of bench.py:192 of the CPU's."""
    ids = torch.from_numpy(sample_tile_ids(np.random.default_rng(2), 128, 72,
                                           2048))
    before = thist.HISTOGRAM.launches
    loss_k, g_k = _grads(scene, small_cfg, ids, dev)
    torch.cuda.synchronize()
    # 4 atlas backwards and 3 triangle-pack ones (the visibility tail
    # gathers no triangle)
    assert thist.HISTOGRAM.launches == before + 7
    loss_p, g_p = _grads(scene, small_cfg, ids, "cpu")
    assert abs(loss_k - loss_p) <= 1e-3 * abs(loss_p)
    for k in TRAIN:
        scale = float(g_p[k].abs().max())
        assert float(g_k[k].abs().max()) > 0.0 or k == "sph_c1", k
        assert float((g_k[k] - g_p[k]).abs().max()) <= 1e-2 * max(scale,
                                                                  1e-12), k



@pytest.fixture(scope="module")
def big_scene(dev, tmp_path_factory):
    """The stand-in at n = 128: 32,768 triangles, 128 clusters, with its
    BVH."""
    s, _ = presets.flagship_standin(
        n=128, data_dir=str(tmp_path_factory.mktemp("no-assets")), device=dev,
        build_bvh=True)
    return s


def test_find_streamed_kernel_matches_plain(big_scene, dev):
    """Kernel 8 against its plain version on the same cluster lists: the
    same prim ids and t bits; and the referees agree."""
    org, d, t, t_min = _fuzz(8192, dev, seed=3)
    inp = tfind.streamed_inputs(big_scene, org, d, t, t_min)
    before = tfind.FIND_STREAMED.launches
    t_k, p_k = tfind.find_streamed(*inp)
    torch.cuda.synchronize()
    assert tfind.FIND_STREAMED.launches == before + 1
    t_p, p_p = tfind.find_streamed_plain(*inp)
    assert torch.equal(p_k, p_p)
    assert torch.equal(t_k.view(torch.int32), t_p.view(torch.int32))
    assert ((p_k >= 0) & (p_k < big_scene.num_triangles)).sum() > 100
    p_s, _ = tint.find_hit(big_scene, org, d, t, t_min=t_min,
                           method="streamed")
    p_v, _ = tint.find_hit(big_scene, org, d, t, t_min=t_min, method="bvh")
    assert (p_s != p_v).float().mean() < 1e-3


@pytest.mark.parametrize("wave", ["sphere", "dead blocks", "ties"])
def test_walk_kernels_on_hard_wavefronts(big_scene, dev, wave):
    """Kernels 8 and 2 against their plain versions where most lanes die
    on the ground sphere, where whole blocks are dead, and on rays through
    vertices and edges that clusters share (exact ties): t bits and prim
    ids equal, flags equal; the any-hit flags also equal those of the
    closest hit's contract (occluded unless the closest hit lies at or
    beyond the bound), from kernel 8 on its own lists."""
    org, d, t, t_min, bound = checks.hard_wavefronts(big_scene)[wave]
    inp = tfind.streamed_inputs(big_scene, org, d, t, t_min)
    t_k, p_k = tfind.find_streamed(*inp)
    t_p, p_p = tfind.find_streamed_plain(*inp)
    assert torch.equal(p_k, p_p)
    assert torch.equal(t_k.view(torch.int32), t_p.view(torch.int32))
    emis = big_scene.mat_type[big_scene.sph_mat.long()] == MAT_LIGHT
    inp = tfind.occluded_inputs(big_scene, org, d, t, bound, t_min=t_min,
                                sphere_occluder=~emis)
    before = tfind.FIND_ANY.launches
    o_k = tfind.find_any(*inp)
    torch.cuda.synchronize()
    assert tfind.FIND_ANY.launches == before + 1
    assert torch.equal(o_k, tfind.find_any_plain(*inp))
    want = checks.occlusion_by_closest_hit(big_scene, org, d, t, t_min,
                                           bound, ~emis)
    assert torch.equal(o_k[:org.shape[0]] > 0, want)
    live = int((inp[1][:, 8] >= 0).sum())
    if wave == "dead blocks":
        assert bool(o_k[:2048].all()) and bool(o_k[4096:5120].all())
    if wave != "ties":
        assert live < 0.5 * org.shape[0]


@pytest.mark.parametrize("wave", ["sphere", "dead blocks", "ties", "fuzz"])
def test_any_regroup_kernel_matches_plain(big_scene, dev, wave):
    """Kernel 2's regrouping pass against its plain version: the ray
    table, the permutation and the cull's bounds bit for bit, on the hard
    wavefronts and on 5,000 fuzz rays (not whole blocks of either kernel
    of the pass)."""
    if wave == "fuzz":
        org, d, t, t_min = _fuzz(5000, dev, seed=13)
        bound = torch.where(t_min < 1e38, 6.0, -3.0e38)
    else:
        org, d, t, t_min, bound = checks.hard_wavefronts(big_scene)[wave]
    emis = big_scene.mat_type[big_scene.sph_mat.long()] == MAT_LIGHT
    inp = (org, d, t, t_min, bound, tfind._pack_spheres(big_scene, ~emis))
    before = tfind.ANY_REGROUP.launches
    got = tfind.any_regroup(*inp)
    torch.cuda.synchronize()
    assert tfind.ANY_REGROUP.launches == before + 1
    want = tfind.any_regroup_plain(*inp)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))
    live = int((got[0][:, 8] >= 0).sum())
    assert 0 < live < org.shape[0] or wave == "ties"


def test_tri_brute_kernel_matches_plain(scene, dev):
    """Kernel 9 against its plain version: the same ids and t bits."""
    org, d, _, _ = _fuzz(8192, dev, seed=5)
    org4, dir4 = tbrute.ray4(org, d)
    w = tbrute.build_weights(scene)
    before = tbrute.TRI_BRUTE.launches
    t_k, i_k = tbrute.tri_brute(org4, dir4, w, 0.001)
    torch.cuda.synchronize()
    assert tbrute.TRI_BRUTE.launches == before + 1
    t_p, i_p = tbrute.tri_brute_plain(org4, dir4, w, 0.001)
    assert torch.equal(i_k, i_p)
    assert torch.equal(t_k.view(torch.int32), t_p.view(torch.int32))
    assert (i_k >= 0).sum() > 100


def _brute_case(case, scene, big_scene, dev):
    """Kernel 9's (org4, dir4, w) for one card case: the flagship
    stand-in's fuzz rays; camera rays over its relief tile copied into 8
    tiles (every hit ties across tiles and slices: the lowest id wins);
    the same with non-finite w3 words in three triangles (their stages take
    the general products); the fuzz rays with w 0.75 / -0.25 (no ray4
    rays: the general products everywhere); the big scene's hard
    wavefronts ("dead blocks" has the rays of "sphere": kernel 9 takes one
    scalar t_min)."""
    if case in checks.hard_wavefronts(big_scene):
        org, d = checks.hard_wavefronts(big_scene)[case][:2]
        return (*tbrute.ray4(org, d), tbrute.build_weights(big_scene))
    if case in ("fuzz", "general rays"):
        org, d, _, _ = _fuzz(8192, dev, seed=5)
        org4, dir4 = tbrute.ray4(org, d)
        if case == "general rays":
            org4[:, 3], dir4[:, 3] = 0.75, -0.25
        return org4, dir4, tbrute.build_weights(scene)
    r = np.random.default_rng(8)
    tgt = np.stack([r.uniform(-1.6, 1.6, 5000), r.uniform(0.9, 4.1, 5000),
                    np.zeros(5000)], axis=1)
    d = tgt - np.array([0.0, 3.0, 5.0])
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    org4, dir4 = tbrute.ray4(
        torch.full((5000, 3), 0.0, device=dev) + torch.tensor(
            [0.0, 3.0, 5.0], device=dev),
        torch.tensor(d, dtype=torch.float32, device=dev))
    one = tbrute.build_weights(scene)[:, :4 * tbrute.TRI_TILE]
    w = torch.cat([one] * 8, dim=1).contiguous()
    if case == "non-finite w3":
        w[3, 5] = float("inf")
        w[3, 4 * tbrute.TRI_TILE + 700] = -float("inf")
        w[3, 9 * tbrute.TRI_TILE + 9] = float("nan")
    return org4, dir4, w


@pytest.mark.parametrize("t_min", [0.001, 0.5])
@pytest.mark.parametrize("slices", [None, 1, 5])
@pytest.mark.parametrize("case", ["fuzz", "duplicates", "non-finite w3",
                                  "general rays", "sphere", "ties"])
def test_tri_brute_kernel_cases(scene, big_scene, dev, case, slices, t_min):
    """Kernel 9 bit-equal to ``tri_brute_plain`` (t bits and ids), one C
    call a call, its shape recorded in ``LAST_LAUNCH``, with the slice
    count of ``launch_shape`` (None), without a split (1) and with five
    slices forced; on the stand-in's fuzz rays, on copies of one tile,
    where ties must go to the lowest id, on stages with non-finite
    weights, on rays that are not ray4's, and on the big scene's hard
    wavefronts; at two t_min. (Hits: 6 to 7,405 a case.)"""
    org4, dir4, w = _brute_case(case, scene, big_scene, dev)
    before = tbrute.TRI_BRUTE.launches
    t_k, i_k = tbrute.tri_brute(org4, dir4, w, t_min, _slices=slices)
    torch.cuda.synchronize()
    assert tbrute.TRI_BRUTE.launches == before + 1
    n_tiles = w.shape[1] // (4 * tbrute.TRI_TILE)
    ray_blocks, want = tbrute.launch_shape(
        org4.shape[0], n_tiles,
        torch.cuda.get_device_properties(dev).multi_processor_count, slices)
    assert tbrute.LAST_LAUNCH == dict(rays=org4.shape[0], slices=want,
                                      blocks=ray_blocks * want)
    assert slices is None or want == min(n_tiles, slices)
    t_p, i_p = tbrute.tri_brute_plain(org4, dir4, w, t_min)
    assert torch.equal(i_k, i_p)
    assert torch.equal(t_k.view(torch.int32), t_p.view(torch.int32))
    assert int((i_k >= 0).sum()) > 0
    if case == "duplicates":
        assert int(i_k.max()) < tbrute.TRI_TILE


def test_place_kernel_matches_plain(dev):
    """Kernel 10 bit-equal to ``place_plain`` and to itself on the same
    glue outputs: C 1 to 16, a short last window, n_bins no multiple of
    2048, no entries, all-unique ids, negative and out-of-range ids; the
    whole sorted histogram against index_add_ within the prefix-sum bound
    (2 n 2^-24 max|S| per channel)."""
    r = np.random.default_rng(13)
    for R, n_bins, C in ((131072, 524288, 8), (4000, 2049, 3),
                         (20000, 6144, 16), (0, 300, 2), (2048, 4096, 4),
                         (50000, 70001, 1)):
        idx = r.integers(-100, n_bins + 100, R)
        if R == 2048:
            idx = np.arange(R) * 2
        idx = torch.tensor(idx, dtype=torch.int32, device=dev)
        vals = torch.tensor(r.normal(size=(R, C)), dtype=torch.float32,
                            device=dev)
        seg = thist.sorted_segments(idx, vals, n_bins)
        before = thist.PLACE.launches
        got = thist.place(*seg, n_bins)
        again = thist.place(*seg, n_bins)
        torch.cuda.synchronize()
        assert thist.PLACE.launches == before + 2
        want = thist.place_plain(*seg, n_bins)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        assert torch.equal(got.view(torch.int32), again.view(torch.int32))
        whole = thist.dense_histogram_sorted(idx, vals, n_bins)
        keep = (idx >= 0) & (idx < n_bins)
        lib = torch.zeros((n_bins, C), dtype=torch.float64, device=dev) \
            .index_add_(0, idx[keep].long(), vals[keep].double())
        order = torch.sort(torch.where(keep, idx.long(), n_bins),
                           stable=True)[1]
        max_s = vals[order].double().cumsum(0).abs().amax(0) if R else 0.0
        assert bool(((whole.double() - lib).abs()
                     <= 2 * R * 2.0 ** -24 * max_s).all())


# -- the Shirley field: spheres only, glass, fuzz, motion and aperture ----

@pytest.fixture(scope="module")
def shirley_calls(dev):
    """The calls of kernels 1-4 while ``render_pixels`` traces 65,536
    camera rays of ``shirley_parity``'s 720p frame (8,192 pixels spread
    over the frame, spb 8, 4 bounces): an empty triangle pack and up to
    488 spheres, glass, fuzzy metal and moving spheres."""
    from sexy_raytracer_tpu_torch.render import integrator, renderer

    scene, cfg = presets.shirley_parity(seed=42, spp=8, height=720,
                                        device=dev)
    cam = Camera.from_config(cfg.camera, cfg.aspect, device=dev)
    P = cfg.width * cfg.height
    ids = torch.from_numpy(np.linspace(0, P - 1, 8192).astype(np.int32)) \
        .to(dev)
    calls = histogram_split.capture_calls(
        [tfind, tfind, tfind, integrator, integrator],
        ["find_closest", "any_regroup", "find_any", "hitrec_fused",
         "shade_carry_fused"],
        lambda: renderer.render_pixels(
            scene, cam, ids, 0, rng.key(cfg.seed, dev),
            torch.tensor(cfg.background, device=dev), width=cfg.width,
            height=cfg.height, spb=8, spp_total=8, max_bounce=4,
            last_bounce_vis=True))
    return scene, calls


@pytest.mark.parametrize("bounce", [0, 1, 2])
def test_find_closest_kernel_on_the_shirley_field(shirley_calls, bounce):
    """Kernel 1 with no triangles and the field's spheres: no cluster to
    walk, every sphere tested, the plain version's ids and t bits."""
    scene, calls = shirley_calls
    assert len(calls["find_closest"]) == 3
    inp = calls["find_closest"][bounce]
    assert inp[2].shape[0] == 0 and inp[5] == 0   # the empty pack
    assert inp[1].shape[0] == 65536
    before = tfind.FIND_CLOSEST.launches
    p_k = _assert_kernel_1(inp)
    assert tfind.FIND_CLOSEST.launches == before + 1
    assert 400 <= scene.num_spheres <= 488
    assert (p_k >= 0).sum() > 1000
    assert len(torch.unique(p_k[p_k >= 0])) > 50


def test_occlusion_kernels_on_the_shirley_field(shirley_calls):
    """Kernel 2's regrouping pass (every ray against every occluding
    sphere) and kernel 2 on the last bounce: the ray table, permutation
    and cull bounds bit for bit, the same flags."""
    _, calls = shirley_calls
    (reg,), (anyc,) = calls["any_regroup"], calls["find_any"]
    got = tfind.any_regroup(*reg)
    want = tfind.any_regroup_plain(*reg)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))
    o_k = tfind.find_any(*anyc)
    o_p = tfind.find_any_plain(*anyc)
    torch.cuda.synchronize()
    assert torch.equal(o_k, o_p)
    live = int((anyc[1][:, 8] >= 0).sum())
    assert 0 < live


def test_fused_kernels_on_the_shirley_bounce_1(shirley_calls):
    """Kernels 3 and 4 on the field's bounce-1 stacks (glass, fuzz and
    moving-sphere rows among them), bit for bit."""
    scene, calls = shirley_calls
    (hf,) = calls["hitrec_fused"][1]
    got = tfused.hitrec_fused(hf)
    want = tfused.hitrec_math(hf)
    same = (got.view(torch.int32) == want.view(torch.int32)) \
        | (got.isnan() & want.isnan())
    assert bool(same.all()), f"{int((~same).sum())} values differ"
    sf, si = calls["shade_carry_fused"][1]
    got = tfused.shade_carry_fused(sf, si)
    want = tfused.shade_carry_math(sf, si)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    # the wavefront holds glass, fuzzy metal and moving spheres
    hit = sf[26] > 0.5
    assert bool((hit & (si[0] == 2)).any())
    assert bool((hit & (si[0] == 1) & (sf[tfused.SF_GF + 6] > 0)).any())
    sph = hf[33] > 0.5
    assert bool((sph & (hf[22:25] != hf[25:28]).any(dim=0)).any())


def test_backward_kernels_on_the_shirley_field(dev):
    """Kernels 5, 6 and 7 in a train-step backward on the field at 128x72
    (the spheres' centres, radii and materials trained): every launch
    against its plain version on the same inputs, the VJPs as in
    ``test_vjp_kernels_match_plain``, the histogram bit for bit (its rows
    are zero here: the field samples no texture)."""
    scene, cfg = presets.shirley_parity(seed=42, height=72, device="cpu")
    names = tuple(n for n in DEFAULT_TRAINABLE
                  if getattr(scene, n).numel() > 0)
    calls = histogram_split.capture_calls(
        [tfused, tfused, thist], ["hitrec_bwd", "shade_bwd",
                                  "dense_histogram"],
        lambda: _grads(scene, cfg, torch.from_numpy(sample_tile_ids(
            np.random.default_rng(3), cfg.width, cfg.height, 2048)), dev,
            names))
    assert [len(calls[k]) for k in calls] == [4, 4, 4]
    hit_calls = [c for c in calls["hitrec_bwd"] if bool(c[1].any())]
    assert len(hit_calls) >= 3
    for hf, g in hit_calls:
        g = checks.unit_cotangent(g)
        got = tfused.hitrec_bwd(hf, g)
        want = tfused.hitrec_vjp_plain(hf, g)
        ill = checks.ill_conditioned_lanes(hf, tfused.hitrec_math(hf))
        checks.vjp_outside(got, want, ill)
        assert checks.vjp_check_power(got, want, ill) > 0
    for sf, si, g in calls["shade_bwd"]:
        g = checks.unit_cotangent(g)
        got = tfused.shade_bwd(sf, si, g)
        want = tfused.shade_vjp_plain(sf, si, g)
        checks.vjp_outside(got, want)
        assert checks.vjp_check_power(got, want) > 0
    for idx, vals, n_bins in calls["dense_histogram"]:
        got = thist.dense_histogram(idx, vals, n_bins)
        want = thist.dense_histogram_plain(idx, vals, n_bins)
        torch.cuda.synchronize()
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    # the backward saw the field's glass, fuzz and moving spheres
    sf, si, _ = calls["shade_bwd"][-1]
    hit = sf[26] > 0.5
    assert bool((hit & (si[0] == 2)).any())
    assert bool((hit & (si[0] == 1) & (sf[tfused.SF_GF + 6] > 0)).any())


def test_sharded_render_on_one_nccl_rank(dev, tmp_path):
    """``render_sharded`` on a (1, 1) mesh over NCCL: the float image of
    ``render``, bit for bit (the stand-in at 64x32, 8 spp; the same chunk,
    spb, pixel order and rounds with one shard)."""
    import dataclasses

    import torch.distributed as dist

    from sexy_raytracer_tpu_torch.parallel import (
        init_distributed,
        make_mesh,
        render_sharded,
    )
    from sexy_raytracer_tpu_torch.parallel.mesh import free_port
    from sexy_raytracer_tpu_torch.render.renderer import render

    scene, cfg = presets.flagship_standin(n=39, spp=8, height=32,
                                          data_dir=str(tmp_path), device=dev)
    cfg = dataclasses.replace(cfg, width=64)
    init_distributed(f"127.0.0.1:{free_port()}", 1, 0, device=dev)
    try:
        assert dist.get_backend() == "nccl"
        got = render_sharded(scene, cfg, make_mesh(1, 1))
    finally:
        dist.destroy_process_group()
    want = render(scene, cfg)
    assert got.shape == (32, 64, 3) and float(got.std()) > 0.0
    np.testing.assert_array_equal(got, want)
