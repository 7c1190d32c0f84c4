"""The port's fused hit-record and shade math (the plain versions of the
CUDA kernels) against the JAX package's, on seeded stacks that cover every
material type and texture kind. Tolerance atol 2e-5, rtol 1e-5, as
tests/test_fused.py:61-62: the packages share the formulas but not the
compiler, so sums, sin/exp2/pow and division may round differently."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from sexy_raytracer_tpu.ops import fused as jfused  # noqa: E402
from sexy_raytracer_tpu_torch import checks  # noqa: E402
from sexy_raytracer_tpu_torch.ops import fused as tfused  # noqa: E402

R = 4096  # one [K, 32, 128] block of the JAX kernels
TOL = dict(atol=2e-5, rtol=1e-5)


def _unit(r, n):
    v = r.normal(size=(3, n))
    return v / np.linalg.norm(v, axis=0, keepdims=True)


def _hf_stack(seed):
    """Rays that hit both their triangle row and their sphere row, so that
    every output row is well conditioned (a missed sphere's record is an
    arbitrary finite value that rounds differently under each compiler)."""
    r = np.random.default_rng(seed)
    org = r.normal(0, 2.0, (3, R))
    unit = _unit(r, R)
    dr = unit * r.uniform(0.5, 2.0, R)
    # triangle around the point 3 units along the ray, facing it
    n = _unit(r, R)
    n = np.where(np.sum(n * unit, axis=0) > 0, -n, n)
    n = n - 0.8 * unit
    n /= np.linalg.norm(n, axis=0, keepdims=True)
    e1 = np.cross(n.T, _unit(r, R).T).T
    e1 /= np.linalg.norm(e1, axis=0, keepdims=True)
    e2 = np.cross(n.T, e1.T).T
    hit = org + 3.0 * unit
    ang = r.uniform(-0.5, 0.5, (3, R)) + np.array([[0.0], [2.1], [4.2]])
    size = r.uniform(0.3, 1.5, (3, R))
    tri = [hit + size[k] * (np.cos(ang[k]) * e1 + np.sin(ang[k]) * e2)
           for k in range(3)]
    uv = r.uniform(0, 1, (6, R))
    uv[:, :64] = 0.0  # degenerate uv: the f == 0 guard
    # sphere ahead of the ray, its center off the ray by < radius / 2
    rad = r.uniform(0.5, 2.0, (1, R))
    c0 = org + 5.0 * unit + 0.5 * rad * np.cross(unit.T, _unit(r, R).T).T
    moving = r.random(R) < 0.5
    c1 = np.where(moving, c0 + 0.1 * _unit(r, R), c0)
    st = np.stack([np.zeros(R), np.where(r.random(R) < 0.2, 0.0, 1.0)])
    t_min = np.full((1, R), 0.001)
    is_tri = (r.random(R) < 0.5).astype(np.float64)[None]
    F = np.concatenate([org, dr, r.uniform(0, 1, (1, R)),
                        np.concatenate(tri), uv, c0, c1, st, rad, t_min,
                        is_tri, 1.0 - is_tri])
    assert F.shape[0] == tfused.NHF
    return F.astype(np.float32)


def _sf_stack(seed):
    r = np.random.default_rng(seed)
    cols = [
        r.normal(0, 2.0, (3, R)),                      # org
        _unit(r, R) * r.uniform(0.5, 2.0, R),          # dir
        r.uniform(0, 1, (3, R)),                       # thr
        r.uniform(0, 1, (3, R)),                       # rad
        (r.random((1, R)) < 0.8),                      # alive
        r.normal(0, 2.0, (3, R)),                      # p
        _unit(r, R), _unit(r, R), _unit(r, R),         # normal tan bitan
        (r.random((1, R)) < 0.5),                      # front
        (r.random((1, R)) < 0.85),                     # hit
        r.uniform(0, 1, (4, R)),                       # base color
        r.uniform(0, 1, (2, R)),                       # metallic roughness
        r.uniform(0, 0.5, (1, R)),                     # fuzz
        r.uniform(1.2, 1.8, (1, R)),                   # ior
        r.uniform(0, 1, (6, R)),                       # albedo c0 c1
        r.uniform(0, 10, (6, R)),                      # emit rgb c1
        r.uniform(0, 1, (4, R)),                       # metal/rough cc
        r.uniform(0, 255, (6, R)),                     # normal c0 c1
        r.uniform(0, 255, (8, R)),                     # atlas pack
        _unit(r, R),                                   # rand unit vector
        _unit(r, R) * r.uniform(0, 1, R) ** (1 / 3),   # rand unit ball
        r.uniform(0, 1, (1, R)),                       # rand uniform
        r.uniform(0, 1, (3, R)),                       # background
    ]
    F = np.concatenate([np.asarray(c, np.float64) for c in cols])
    assert F.shape[0] == tfused.NSF
    # every material with every texture kind of its slots
    I = np.stack([
        r.integers(0, 4, R),            # mtype: pbr metal dielectric light
        r.integers(0, 4, R),            # albedo kind 0-3
        r.choice([0, 2, 3], R),         # normal kind
        r.choice([0, 2, 3], R),         # metal kind
        r.choice([0, 2, 3], R),         # rough kind
        r.integers(1, 4, R),            # emit kind 1-3
    ])
    return F.astype(np.float32), I.astype(np.int32)


@pytest.mark.parametrize("seed", [0, 1])
def test_hitrec_math_matches(seed):
    F = _hf_stack(seed)
    want = np.asarray(jfused.hitrec_math(jnp.asarray(F)))
    got = tfused.hitrec_math(torch.from_numpy(F)).numpy()
    assert got.shape == (tfused.NHO, R) and got.dtype == np.float32
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_shade_carry_math_matches(seed):
    F, I = _sf_stack(seed)
    assert set(np.unique(I[0])) == {0, 1, 2, 3}
    want = np.asarray(jfused.shade_carry_math(jnp.asarray(F), jnp.asarray(I)))
    got = tfused.shade_carry_math(torch.from_numpy(F),
                                  torch.from_numpy(I)).numpy()
    assert got.shape == (tfused.NSO, R) and got.dtype == np.float32
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)


def test_wrappers_match_jax_kernels():
    """One call through the JAX Pallas kernels (interpret mode) and the
    port's wrappers, which take the plain path for CPU tensors."""
    hf = _hf_stack(2)
    sf, si = _sf_stack(3)
    launches = (tfused.HITREC.launches, tfused.SHADE.launches)
    ho_j = jfused.hitrec_fused(jnp.asarray(hf.reshape(tfused.NHF, -1, 128)))
    ho_t = tfused.hitrec_fused(torch.from_numpy(hf)).numpy()
    ho_j = np.asarray(ho_j).reshape(tfused.NHO, R)
    # a sphere hit within ~1e-3 of a pole takes its tangent from the cross
    # of two nearly parallel vectors (sphere.h:96-106), which amplifies a
    # one-ulp difference past the tolerance: compare those lanes' other rows
    pole = (hf[32] < 0.5) & (1.0 - np.abs(ho_t[4]) < 1e-3)
    frame = np.zeros(tfused.NHO, bool)
    frame[6:12] = True
    keep = ~(frame[:, None] & pole[None, :])
    assert pole.mean() < 0.01
    np.testing.assert_allclose(ho_t[keep], ho_j[keep], **TOL)
    so_j = jfused.shade_carry_fused(
        jnp.asarray(sf.reshape(tfused.NSF, -1, 128)),
        jnp.asarray(si.reshape(tfused.NSI, -1, 128)))
    so_t = tfused.shade_carry_fused(torch.from_numpy(sf),
                                    torch.from_numpy(si))
    np.testing.assert_allclose(so_t.numpy(),
                               np.asarray(so_j).reshape(tfused.NSO, R), **TOL)
    assert (tfused.HITREC.launches, tfused.SHADE.launches) == launches


def test_row_maps_match():
    for name in ("NHF", "NHO", "NSF", "SF_GF", "SF_PACK", "SF_IOR", "NSI",
                 "NSO"):
        assert getattr(tfused, name) == getattr(jfused, name), name


# ---------------------------------------------------------------------------
# VJPs (the plain versions of the backward kernels) against jax.vjp
# ---------------------------------------------------------------------------
# The adjoints sum their terms in another order than JAX's transpose, so
# values agree to atol 2e-5, rtol 1e-4 (checks.VJP_TOL); at most 1% of the
# rays may leave it, and only where the VJP is ill-conditioned in f32
# (checks.ill_conditioned_lanes: a nearly degenerate uv triangle, a sphere
# hit by a pole) — checks.vjp_outside.


def _cotangent(seed, rows):
    """Seeded cotangents, nonzero on every output row."""
    g = np.random.default_rng(seed).normal(size=(rows, R))
    return np.where(np.abs(g) < 0.05, 0.05, g).astype(np.float32)


def _assert_vjp_close(got, want, ill=None):
    checks.vjp_outside(torch.tensor(got), torch.tensor(want),
                       None if ill is None else torch.tensor(ill))


@pytest.mark.parametrize("seed", [0, 1])
def test_hitrec_vjp_matches_jax(seed):
    F = _hf_stack(seed)
    g = _cotangent(10 + seed, tfused.NHO)
    _, vjp = jax.vjp(jfused.hitrec_math, jnp.asarray(F))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    hf = torch.from_numpy(F)
    got = tfused.hitrec_vjp_plain(hf, torch.from_numpy(g)).numpy()
    ill = checks.ill_conditioned_lanes(hf, tfused.hitrec_math(hf)).numpy()
    assert np.isfinite(got).all()
    _assert_vjp_close(got, want, ill)
    # t_min, is_tri and is_sph only take part in comparisons
    assert (got[31:34] == 0).all()


def test_hitrec_vjp_stops_uv_gradient():
    """A cotangent on the triangle uv outputs (rows 12-13) reaches no
    input, as JAX stops their gradient (fused.py:173-174)."""
    F = _hf_stack(4)
    g = np.zeros((tfused.NHO, R), np.float32)
    g[12:14] = 1.0
    _, vjp = jax.vjp(jfused.hitrec_math, jnp.asarray(F))
    assert not np.asarray(vjp(jnp.asarray(g))[0]).any()
    got = tfused.hitrec_vjp_plain(torch.from_numpy(F), torch.from_numpy(g))
    assert not got.any()


@pytest.mark.parametrize("seed", [0, 1])
def test_shade_vjp_matches_jax(seed):
    F, I = _sf_stack(seed)
    g = _cotangent(20 + seed, tfused.NSO)
    _, vjp = jax.vjp(lambda f: jfused.shade_carry_math(f, jnp.asarray(I)),
                     jnp.asarray(F))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    got = tfused.shade_vjp_plain(torch.from_numpy(F), torch.from_numpy(I),
                                 torch.from_numpy(g)).numpy()
    assert np.isfinite(got).all()
    _assert_vjp_close(got, want)
    # alive, front, hit and the random draws (rows 65-71) are stop-gradient
    # (fused.py:277-288)
    assert (got[[12, 25, 26]] == 0).all()
    assert (got[65:72] == 0).all() and (want[65:72] == 0).all()


def _select_vjp(math, f, g, *args):
    """The plain VJPs' first form: ``torch.autograd.grad`` through the math
    applied to the stack itself, so that each row is read as a select."""
    with torch.enable_grad():
        F = f.detach().requires_grad_(True)
        (dF,) = torch.autograd.grad(math(F, *args), F, g)
    return dF


def _random_vjp_call(kernel):
    """A seeded stack of kernel 5 or 6 with a third of its rays without a
    hit: on the hit record, lanes whose gathered rows are all zero (the
    miss and pad lanes' row 0); on the shade, rays with no hit, half of
    them dead (as tests the carry's pass-through below)."""
    r = np.random.default_rng(30)
    no_hit = r.random(R) < 1 / 3
    if kernel == "hitrec":
        F = _hf_stack(7)
        F[7:31, no_hit] = 0.0
        return (torch.from_numpy(F),
                torch.from_numpy(_cotangent(31, tfused.NHO)))
    F, I = _sf_stack(8)
    F[26, no_hit] = 0.0
    F[12, no_hit] = (r.random(int(no_hit.sum())) < 0.5).astype(np.float32)
    return (torch.from_numpy(F), torch.from_numpy(I),
            torch.from_numpy(_cotangent(32, tfused.NSO)))


@pytest.fixture(scope="module")
def train_step_vjp_calls():
    """The (stack, cotangent) of every kernel 5 and 6 call in the backward
    of one train step on tests/test_inverse.py's scene, at the shape of
    ``tests/test_torch_oracle.py::test_inverse_rendering_converges`` (768
    pixels at spb 32, 3 bounces: [NHF | NSF, 24,576] stacks), its last
    bounce full of dead lanes and rays with no hit."""
    from sexy_raytracer_tpu_torch.diff.inverse import (
        _loss_fn,
        sample_tile_ids,
    )
    from sexy_raytracer_tpu_torch.diff.params import extract_params
    from sexy_raytracer_tpu_torch.render.camera import Camera
    from sexy_raytracer_tpu_torch.utils import rng
    from sexy_raytracer_tpu_torch.utils.config import CameraConfig
    from test_torch_inverse_crn import _inverse_scene

    calls = {"hitrec": [], "shade": []}

    def record(name, fn):
        def run(*args):
            calls[name].append(tuple(a.clone() for a in args))
            return fn(*args)
        return run

    scene = _inverse_scene()
    cam = Camera.from_config(
        CameraConfig(eye=(0, 2, 6), look_at=(0, 1, 0), vfov_degrees=45.0,
                     aperture=0.0, focus_dist=6.0), 48 / 32, device="cpu")
    params = {k: v.clone().requires_grad_(True)
              for k, v in extract_params(scene).items()}
    ids = torch.from_numpy(sample_tile_ids(np.random.default_rng(5), 48, 32,
                                           768))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tfused, "hitrec_bwd", record("hitrec", tfused.hitrec_bwd))
        mp.setattr(tfused, "shade_bwd", record("shade", tfused.shade_bwd))
        loss = _loss_fn(params, scene, cam, ids, torch.full((768, 3), 0.5),
                        0, rng.key(5), torch.zeros(3), width=48, height=32,
                        spb=32, spp_total=32, max_bounce=3,
                        method="bruteforce", last_bounce_vis=True)
        torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    assert [c[0].shape for c in calls["shade"]] == \
        [(tfused.NSF, 768 * 32)] * 3
    return calls


@pytest.mark.parametrize("kernel", ["hitrec", "shade"])
@pytest.mark.parametrize("source", ["random", "train_step"])
def test_plain_vjps_read_rows_once_bit_equal(kernel, source,
                                             train_step_vjp_calls):
    """The plain VJPs take the stack's rows once (``unbind``) where their
    first form read each row as a select of the stack: the same math in
    the same order, so the cotangents equal the select form's exactly
    (rtol = atol = 0, NaN where it has NaN). The one difference allowed is
    the sign of zero: a zero cotangent may be -0.0 where the sum of the
    selects' zero-filled stacks made it +0.0, and that changes no sum, no
    histogram and no Adam step downstream. On seeded stacks with rays
    without a hit, and on every call of a train step's backward."""
    math, vjp = {"hitrec": (tfused.hitrec_math, tfused.hitrec_vjp_plain),
                 "shade": (tfused.shade_carry_math,
                           tfused.shade_vjp_plain)}[kernel]
    calls = ([_random_vjp_call(kernel)] if source == "random"
             else train_step_vjp_calls[kernel])
    assert calls
    nonzero = False
    for args in calls:
        if kernel == "hitrec":
            (f, g), extra = args, ()
        else:
            f, si, g = args
            extra = (si,)
        got = vjp(f, *extra, g)
        want = _select_vjp(math, f, g, *extra)
        assert got.shape == want.shape == f.shape
        torch.testing.assert_close(got, want, rtol=0, atol=0,
                                   equal_nan=True)
        nonzero = nonzero or bool(got.any())
    assert nonzero
    if source == "train_step" and kernel == "shade":
        alive = torch.cat([f[12] for f, _, _ in calls])
        hit = torch.cat([f[26] for f, _, _ in calls])
        assert (alive == 0).any() and ((alive > 0.5) & (hit == 0)).any()


def test_fused_wrappers_differentiate_like_jax_kernels():
    """Gradients through the port's autograd Functions (on CPU tensors:
    the plain VJPs) against JAX's custom VJPs, whose backward runs the
    Pallas kernels 5 and 6 in interpret mode."""
    hf, (sf, si) = _hf_stack(5), _sf_stack(6)
    gh, gs = _cotangent(30, tfused.NHO), _cotangent(31, tfused.NSO)
    want_h = jax.grad(lambda h: jnp.sum(jfused.hitrec_fused(h) * jnp.asarray(
        gh.reshape(tfused.NHO, -1, 128))))(
        jnp.asarray(hf.reshape(tfused.NHF, -1, 128)))
    want_s = jax.grad(lambda s: jnp.sum(jfused.shade_carry_fused(
        s, jnp.asarray(si.reshape(tfused.NSI, -1, 128))) * jnp.asarray(
        gs.reshape(tfused.NSO, -1, 128))))(
        jnp.asarray(sf.reshape(tfused.NSF, -1, 128)))
    launches = (tfused.HITREC_BWD.launches, tfused.SHADE_BWD.launches)
    h = torch.from_numpy(hf).requires_grad_(True)
    out = tfused.hitrec_fused(h)
    assert type(out.grad_fn).__name__ == "_HitrecFusedBackward"
    (got_h,) = torch.autograd.grad(out, h, torch.from_numpy(gh))
    s = torch.from_numpy(sf).requires_grad_(True)
    out = tfused.shade_carry_fused(s, torch.from_numpy(si))
    assert type(out.grad_fn).__name__ == "_ShadeFusedBackward"
    (got_s,) = torch.autograd.grad(out, s, torch.from_numpy(gs))
    # the jitted VJP of the interpret-mode kernel and the eager jax.vjp
    # round differently on a few sphere lanes: a lane within VJP_TOL of the
    # eager one counts as agreeing with the reference
    want_h = np.asarray(want_h).reshape(tfused.NHF, R)
    _, vjp = jax.vjp(jfused.hitrec_math, jnp.asarray(hf))
    eager_h = np.asarray(vjp(jnp.asarray(gh))[0])
    ill = checks.ill_conditioned_lanes(
        torch.from_numpy(hf), tfused.hitrec_math(torch.from_numpy(hf))).numpy()
    ill |= np.isclose(got_h.numpy(), eager_h, **checks.VJP_TOL).all(axis=0)
    _assert_vjp_close(got_h.numpy(), want_h, ill)
    _assert_vjp_close(got_s.numpy(),
                      np.asarray(want_s).reshape(tfused.NSF, R))
    # CPU tensors never reach the kernels
    assert (tfused.HITREC_BWD.launches,
            tfused.SHADE_BWD.launches) == launches


@pytest.mark.parametrize("kernel", ["hitrec", "shade"])
def test_fused_wrappers_skip_the_function_without_a_gradient(kernel):
    """Where no gradient is asked for (the frame), ``hitrec_fused`` and
    ``shade_carry_fused`` return a tensor with no autograd node, as the
    JAX forward; with one they go through their autograd Functions, whose
    backward is kernel 5 or 6. The values agree either way."""
    if kernel == "hitrec":
        stacks = (torch.from_numpy(_hf_stack(7)),)
        fn, node = tfused.hitrec_fused, "_HitrecFusedBackward"
    else:
        F, I = _sf_stack(8)
        stacks = (torch.from_numpy(F), torch.from_numpy(I))
        fn, node = tfused.shade_carry_fused, "_ShadeFusedBackward"
    plain = fn(*stacks)
    assert plain.grad_fn is None
    x = stacks[0].clone().requires_grad_(True)
    with torch.no_grad():
        assert fn(x, *stacks[1:]).grad_fn is None
    out = fn(x, *stacks[1:])
    assert type(out.grad_fn).__name__ == node
    assert torch.equal(out.detach(), plain)


def test_shade_vjp_of_a_ray_without_a_hit_passes_the_carry():
    """Kernel 6 skips the forward on a ray with no hit (a miss or a dead
    ray): its VJP is the carry's pass-through (org, dir and thr take their
    cotangents, rad's goes to rad and, on a miss, to thr and the
    background) and zero elsewhere. Held here on the plain VJP, on seeded
    stacks of every material with a third of the rays without a hit, half
    of those dead."""
    F, I = _sf_stack(9)
    r = np.random.default_rng(9)
    no_hit = r.random(R) < 1 / 3
    F[26, no_hit] = 0.0
    F[12, no_hit] = (r.random(int(no_hit.sum())) < 0.5).astype(np.float32)
    g = _cotangent(40, tfused.NSO)
    got = tfused.shade_vjp_plain(torch.from_numpy(F), torch.from_numpy(I),
                                 torch.from_numpy(g)).numpy()[:, no_hit]
    g, F = g[:, no_hit], F[:, no_hit]
    miss = F[12] > 0.5
    want = np.zeros_like(got)
    want[0:6] = g[0:6]
    want[6:9] = g[6:9] + np.where(miss, g[9:12] * F[72:75], 0.0)
    want[9:12] = g[9:12]
    want[72:75] = np.where(miss, g[9:12] * F[6:9], 0.0)
    assert miss.any() and (~miss).any()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("shape", range(len(tfused.COPY_SHAPES)))
def test_stack_copy_plain_sums_rows(shape):
    """The copy floor's plain version at the stack shapes of kernels 3, 4,
    5 and 6: out row k is the f32 rows k, k + n_out, ... and the int rows
    k, k + n_out, ... summed in that order, written out row by row."""
    nf, ni, no = tfused.COPY_SHAPES[shape]
    r = np.random.default_rng(shape)
    f = r.normal(size=(nf, 37)).astype(np.float32)
    si = r.integers(-5, 5, (ni, 37)).astype(np.int32)
    want = np.zeros((no, 37), np.float32)
    for k in range(no):
        for j in range(k, nf, no):
            want[k] = want[k] + f[j]
        for j in range(k, ni, no):
            want[k] = want[k] + si[j].astype(np.float32)
    got = tfused.stack_copy(torch.from_numpy(f),
                            torch.from_numpy(si) if ni else None, no)
    assert got.shape == (no, 37)
    assert np.array_equal(got.numpy(), want)


def test_vjp_check_fails_wrong_kernels_on_train_step_cotangents(
        monkeypatch, tmp_path):
    """The VJP check on the cotangents of a train step's backward (the
    flagship stand-in, 512 pixels at spb 2, 4 bounces), scaled to unit
    size as the card checks scale them: it passes the plain VJP, and it
    rejects a kernel that returns zeros or flips any gradient row's sign.
    The last bounce's hit record gets a zero cotangent (with the
    visibility shortcut its outputs feed no gradient): nothing to check."""
    from sexy_raytracer_tpu_torch.diff.inverse import (
        _loss_fn,
        sample_tile_ids,
    )
    from sexy_raytracer_tpu_torch.diff.params import extract_params
    from sexy_raytracer_tpu_torch.models import presets
    from sexy_raytracer_tpu_torch.render.camera import Camera
    from sexy_raytracer_tpu_torch.render.integrator import (
        scene_no_emissive_tris,
    )
    from sexy_raytracer_tpu_torch.utils import rng

    calls = {"hitrec": [], "shade": []}

    def record(name, fn):
        def run(*args):
            calls[name].append(tuple(a.clone() for a in args))
            return fn(*args)
        return run

    monkeypatch.setattr(tfused, "hitrec_bwd",
                        record("hitrec", tfused.hitrec_bwd))
    monkeypatch.setattr(tfused, "shade_bwd", record("shade", tfused.shade_bwd))
    scene, cfg = presets.flagship_standin(n=2, height=72,
                                          data_dir=str(tmp_path), device="cpu")
    params = {k: v.clone().requires_grad_(True)
              for k, v in extract_params(scene).items()}
    ids = torch.from_numpy(sample_tile_ids(np.random.default_rng(3),
                                           cfg.width, cfg.height, 512))
    loss = _loss_fn(params, scene,
                    Camera.from_config(cfg.camera, cfg.aspect, device="cpu"),
                    ids, torch.full((512, 3), 0.5), 0, rng.key(1),
                    torch.tensor(cfg.background), width=cfg.width,
                    height=cfg.height, spb=2, spp_total=2, max_bounce=4,
                    method="auto",
                    last_bounce_vis=scene_no_emissive_tris(scene))
    torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    assert len(calls["hitrec"]) == len(calls["shade"]) == 4
    hit_calls = [c for c in calls["hitrec"] if bool(c[1].any())]
    assert len(hit_calls) == 3
    for hf, g in hit_calls:
        g = checks.unit_cotangent(g)
        want = tfused.hitrec_vjp_plain(hf, g)
        ill = checks.ill_conditioned_lanes(hf, tfused.hitrec_math(hf))
        assert checks.vjp_outside(want.clone(), want, ill) == 0
        assert checks.vjp_check_power(want, want, ill) > 0
    for sf, si, g in calls["shade"]:
        g = checks.unit_cotangent(g)
        want = tfused.shade_vjp_plain(sf, si, g)
        assert checks.vjp_outside(want.clone(), want) == 0
        assert checks.vjp_check_power(want, want) > 0
