"""Comparison rules that the tests and ``chip_smoke.py`` hold the port's
backward kernels to. The library itself never imports this module.

A VJP is compared with autograd of the plain math at a tolerance
(``VJP_TOL``), so the check says something only where the values stand
well above it. A train step's cotangents are tiny (the loss is a mean over
every pixel, channel and sample), so its VJPs can lie below ``atol`` and a
kernel returning zeros would pass: callers scale the cotangent to unit
size first (``unit_cotangent``, the VJP is linear in it) and show that the
check rejects a wrong kernel on those lanes (``vjp_check_power``).
"""

from __future__ import annotations

import torch

# the VJPs' tolerance against autograd of the plain math: the adjoint sums
# its terms in another order
VJP_TOL = dict(atol=2e-5, rtol=1e-4)
# share of rays that may leave VJP_TOL, all of them ill-conditioned
VJP_BUDGET = 0.01


def unit_cotangent(g):
    """``g`` scaled to a largest magnitude of 1 (unchanged if all zero)."""
    scale = g.abs().amax()
    return g / scale if bool(scale > 0) else g


def ill_conditioned_lanes(hf, ho):
    """Rays whose hit-record VJP is ill-conditioned in float32 -> bool [R].

    ``hf`` is the hit record's input stack, ``ho`` its output. Triangle
    lanes whose uv triangle is nearly degenerate (the sine of the angle
    between its uv edges below 0.1: the tangent frame divides by the uv
    determinant), and sphere lanes within 1e-3 of a pole (the tangent is
    the cross of two nearly parallel vectors, ROADMAP.md queue 3; every hit
    on the flagship's ground sphere is one). There one f32 rounding of an
    input can move the VJP past a fixed tolerance, in the JAX package as
    much as here. Checks allow a budget of such lanes outside the tolerance
    (``vjp_outside``) instead of loosening it everywhere.
    """
    uv = hf[16:22]
    du0 = uv[2:4] - uv[0:2]
    du1 = uv[4:6] - uv[0:2]
    f = du0[0] * du1[1] - du1[0] * du0[1]
    norms = torch.linalg.vector_norm(du0, dim=0) * \
        torch.linalg.vector_norm(du1, dim=0)
    tri = hf[32] > 0.5
    flat_uv = (f != 0.0) & (f.abs() < 0.1 * norms)
    pole = (1.0 - ho[4].abs()) < 1e-3
    return torch.where(tri, flat_uv, pole)


def vjp_outside(got, want, ill=None):
    """Rays where a VJP ``got`` [K, R] leaves ``VJP_TOL`` of ``want``.
    Raises if one of them is not in ``ill`` (bool [R]) or if there are
    more than ``VJP_BUDGET`` of the rays; returns their count."""
    outside = ~torch.isclose(got, want, **VJP_TOL).all(dim=0)
    n = int(outside.sum())
    if ill is None:
        ill = torch.zeros_like(outside)
    if bool((outside & ~ill).any()) or n > VJP_BUDGET * outside.numel():
        raise AssertionError(
            f"VJP: {n} of {outside.numel()} rays outside atol "
            f"{VJP_TOL['atol']} rtol {VJP_TOL['rtol']}, "
            f"{int((outside & ~ill).sum())} of them well-conditioned "
            f"(budget: {VJP_BUDGET:.0%} of the rays, ill-conditioned only)")
    return n


def rejects(got, want, ill=None):
    """Whether ``vjp_outside(got, want, ill)`` fails."""
    try:
        vjp_outside(got, want, ill)
    except AssertionError:
        return True
    return False


def flip_row(x, k):
    """A copy of ``x`` [K, R] with row ``k``'s sign flipped."""
    x = x.clone()
    x[k] = -x[k]
    return x


def vjp_check_power(got, want, ill=None):
    """Shows that ``vjp_outside(got, want, ill)`` would fail a wrong kernel
    on these inputs: one that returns zeros, and one that returns ``got``
    with any single row's sign flipped, for every row that carries
    gradient (above ``atol`` on a well-conditioned ray). Raises if such a
    wrong result would pass or if no row carries gradient; returns the
    number of rows that do."""
    if ill is None:
        ill = torch.zeros(want.shape[1], dtype=torch.bool, device=want.device)
    if not rejects(torch.zeros_like(got), want, ill):
        raise AssertionError("VJP check: a kernel returning zeros would pass")
    rows = [k for k in range(want.shape[0])
            if bool(((want[k].abs() > VJP_TOL["atol"]) & ~ill).any())]
    if not rows:
        raise AssertionError("VJP check: no row carries gradient above atol")
    for k in rows:
        if not rejects(flip_row(got, k), want, ill):
            raise AssertionError(f"VJP check: row {k} with its sign flipped "
                                 "would pass")
    return len(rows)
