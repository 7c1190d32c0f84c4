"""The plain reference of the fit step: render a pixel batch at ``spb``
samples with the trained texel pack, resolve it, take the mean squared
error against the target (the true scene's render of the same pixels and
samples), its gradient by autograd, and Adam (b1 0.9, b2 0.999, eps 1e-8,
bias correction, NaN gradients zeroed, a cosine decay of the rate).

It works the target out itself from the true pack, and imports nothing of
the program under test.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import render


def learning_rate(lr, count, decay_steps, alpha=0.05):
    """The rate at step ``count`` (0-based), in float32 as the scalar
    factors of the optimizer are rounded."""
    if not decay_steps:
        return lr
    f = np.float32
    t = min(f(count), f(decay_steps))
    cosine = f(0.5) * (f(1.0) + np.cos(f(np.pi) * t / f(decay_steps)))
    return float(f(lr) * (f(1.0 - alpha) * cosine + f(alpha)))


def target_pixels(sc, true_atlas, cam, ids, base_key, *, width, height,
                  target_spp, max_bounce, background, block):
    with torch.no_grad():
        rad = render.render_pixels(
            sc, true_atlas, cam, ids, base_key, width=width, height=height,
            spb=target_spp, max_bounce=max_bounce, background=background,
            block=block)
        return render.resolve(rad, target_spp)


def loss_and_grad(sc, atlas, cam, ids, target, base_key, *, width, height,
                  spb, max_bounce, background, block):
    """(loss, d loss / d atlas) of one batch, traced in blocks of pixels
    whose losses and gradients are summed."""
    atlas = atlas.detach().requires_grad_(True)
    n = ids.shape[0] * 3
    per = max(1, block // spb)
    total = torch.zeros((), dtype=torch.float64, device=ids.device)
    for c0 in range(0, ids.shape[0], per):
        rad = render.render_pixels(
            sc, atlas, cam, ids[c0:c0 + per], base_key, width=width,
            height=height, spb=spb, max_bounce=max_bounce,
            background=background, block=block)
        err = render.resolve(rad, spb) - target[c0:c0 + per]
        part = (err * err).sum() / n
        part.backward()
        total += part.detach().double()
    return float(total), atlas.grad.detach()


def fit(sc, cam, start_atlas, true_atlas, batches, base_key, *, width,
        height, spb, target_spp, max_bounce, background, mask, lr,
        decay_steps, block=131072, b1=0.9, b2=0.999, eps=1e-8, mu=None,
        nu=None, count0=0):
    """Adam steps on the texel pack from ``start_atlas`` and the moments
    ``mu``, ``nu`` (default: nought) after ``count0`` steps, one per pixel
    batch in ``batches`` -> {losses, grad1 (the first step's gradient as
    the optimizer takes it), change (the pack after the last step less
    the start)}."""
    atlas = start_atlas.clone()
    mu = torch.zeros_like(atlas) if mu is None else mu.clone()
    nu = torch.zeros_like(atlas) if nu is None else nu.clone()
    mask = torch.as_tensor(mask, dtype=atlas.dtype, device=atlas.device)
    kw = dict(width=width, height=height, max_bounce=max_bounce,
              background=background, block=block)
    losses, grad1 = [], None
    f = np.float32
    for count, ids in enumerate(batches, start=count0):
        tgt = target_pixels(sc, true_atlas, cam, ids, base_key,
                            target_spp=target_spp, **kw)
        loss, g = loss_and_grad(sc, atlas, cam, ids, tgt, base_key, spb=spb,
                                **kw)
        g = g * mask
        g = torch.where(torch.isnan(g), torch.zeros_like(g), g)
        if grad1 is None:
            grad1 = g.clone()
        c = count + 1
        bc1 = float(f(1.0) - f(b1) ** f(c))
        bc2 = float(f(1.0) - f(b2) ** f(c))
        mu = (1.0 - b1) * g + b1 * mu
        nu = (1.0 - b2) * (g * g) + b2 * nu
        u = (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
        atlas = atlas + u * -learning_rate(lr, count, decay_steps)
        losses.append(loss)
    return dict(losses=losses, grad1=grad1, change=atlas - start_atlas)
