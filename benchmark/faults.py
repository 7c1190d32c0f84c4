"""Faults planted under the timed path, to show that the check catches
them: the tests drive a whole run with each (``tests/``), and
``calibrate.py`` reads them at the cells' own sizes on the card.

Frames (``loops/frames.py``): ``stale``, a frame that hands back the
first image it made; ``half``, half of each pixel's samples left out and
the mean taken over the rest; ``altered``, the radiance of one chunk of
pixels changed by 1% where the frame is made. Fit steps
(``loops/fit_step.py``): ``unchanged``, a step that returns its state
unchanged; ``half``, half of the batch left out and the mean taken over
the rest; ``late_half``, the same from the fourth step on, so that the
steps set-up takes are sound and only the window's are not.
"""

from __future__ import annotations

import contextlib
import dataclasses

FRAME_FAULTS = ("stale", "half", "altered")
FIT_FAULTS = ("unchanged", "half", "late_half")


def _frame_fault(orig, fault):
    made = []

    def stale(scene, cfg, *a, **kw):
        if not made:
            made.append(orig(scene, cfg, *a, **kw))
        return made[0].copy()

    def half(scene, cfg, *a, **kw):
        spp = max(1, cfg.samples_per_pixel // 2)
        cfg = dataclasses.replace(
            cfg, samples_per_pixel=spp,
            samples_per_batch=max(1, min(cfg.samples_per_batch, spp)))
        return orig(scene, cfg, *a, **kw) * 2.0

    def altered(scene, cfg, *a, **kw):
        img = orig(scene, cfg, *a, **kw)
        chunk = cfg.rays_per_chunk // min(cfg.samples_per_batch,
                                          cfg.samples_per_pixel)
        flat = img.reshape(-1, 3)
        flat[:chunk] *= 1.01
        return img

    return {"stale": stale, "half": half, "altered": altered}[fault]


def _fit_fault(orig_make, fault):
    def make(*a, **kw):
        step = orig_make(*a, **kw)

        def unchanged(state, *args):
            _, loss = step(state, *args)
            return state, loss

        def half(state, scene, camera, ids, target, key):
            n = ids.shape[0] // 2
            return step(state, scene, camera, ids[:n], target[:n], key)

        calls = []

        def late_half(state, *args):
            calls.append(1)
            return (half if len(calls) > 3 else step)(state, *args)

        wrapped = {"unchanged": unchanged, "half": half,
                   "late_half": late_half}[fault]
        for name in ("init", "params_of", "value_and_grad"):
            setattr(wrapped, name, getattr(step, name))
        return wrapped

    return make


@contextlib.contextmanager
def planted(loop, fault: str):
    """``loop`` (a module of ``loops/``) with ``fault`` planted under
    its timed path for the duration."""
    if hasattr(loop, "make_train_step"):
        name, new = "make_train_step", _fit_fault(loop.make_train_step,
                                                  fault)
    else:
        name, new = "render_accumulate", _frame_fault(
            loop.render_accumulate, fault)
    orig = getattr(loop, name)
    setattr(loop, name, new)
    try:
        yield
    finally:
        setattr(loop, name, orig)
