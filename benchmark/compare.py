"""The comparisons that decide ``correct``: what the timed path produced
against the plain reference (``reference/``), each reading held to its own
limit in ``limits/<cell>.json``.

Frames: the share of the checked pixels whose radiance differs from the
reference's by more than ``ATOL + RTOL * |reference|`` in any channel (a
path that took another branch), and the relative gap between the two
sums of radiance over all checked pixels (a bias). Fit steps, once for
the steps set-up takes and once, under names that start ``window_``, for
the window's last steps: the largest relative gap of a step's loss, and
the relative gaps of two norms: the first step's gradient as the
optimizer takes it, and the change of the parameters over the steps the
check follows.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# the control: the reference itself in the precision below the scenes'
# float32
CONTROL_DTYPES = {"bf16": torch.bfloat16}
RTOL = 1e-3
ATOL = 1e-3
# a reading that is not a number is reported as this (JSON has no inf)
NOT_FINITE = 1e30


def _finite(x: float) -> float:
    return float(x) if math.isfinite(x) else NOT_FINITE


def frame_readings(got, want) -> dict:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    with np.errstate(invalid="ignore"):
        bad = ~np.isfinite(got).all(axis=1) | (
            np.abs(got - want) > ATOL + RTOL * np.abs(want)).any(axis=1)
    total = want.sum()
    gap = abs(got.sum() - total) / abs(total) if total else NOT_FINITE
    return {"pixel_mismatch_pct": _finite(100.0 * bad.mean()),
            "mean_radiance_gap": _finite(gap)}


def rel_gap(a: float, b: float) -> float:
    return _finite(abs(a - b) / abs(b)) if b else NOT_FINITE


def fit_readings(prog: dict, ref: dict) -> dict:
    """``prog`` and ``ref``: ``losses`` (one a step followed),
    ``grad_norm`` and ``change_norm``."""
    return {
        "loss_gap": max(rel_gap(a, b)
                        for a, b in zip(prog["losses"], ref["losses"])),
        "grad_norm_gap": rel_gap(prog["grad_norm"], ref["grad_norm"]),
        "change_norm_gap": rel_gap(prog["change_norm"], ref["change_norm"]),
    }


def norm(t) -> float:
    return float(torch.linalg.vector_norm(t.detach().double()))
