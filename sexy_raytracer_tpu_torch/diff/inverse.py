"""Inverse rendering: the differentiable train step, Adam and the loop
that fits scene parameters to a target image (counterpart of
``sexy_raytracer_tpu/diff/inverse.py``).

The loss renders a random pixel subset at low spp, resolves it like the
forward pipeline and compares it with the target pixels. Gradients flow
through the hit record, shading, the carry and the row gathers (the fused
kernels' VJPs and the histogram of ops/), with hit finding stop-gradient.
``inverse_render`` runs the steps with tile draws inside an optional
region of interest, per-step keys from ``rng.split`` or one common key
(``crn_key``), a Polyak average of the parameters, and an optional
reparameterisation (``init_params`` / ``param_transform``).

Without a mesh the step runs on the device of its tensors, the whole
batch one wavefront with ``spp_total = spb``. With a ("rays", "samples")
mesh (``parallel/mesh.py``; JAX's shard_map, inverse.py:193-300) every
rank traces its ``shard_rays`` slice of the pixels at sample ids from
``sample_shard * spb``, with ``spp_total = spb * n_sample_shards``; the
loss and the gradients are averaged over the whole mesh by all-reduces,
and Adam then runs identically on every rank. ``inverse_render(mesh=)``
draws the same tiles and keys on every rank and hands each its slice.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from sexy_raytracer_tpu_torch.diff.params import (
    DEFAULT_TRAINABLE,
    extract_params,
    merge_params,
)
from sexy_raytracer_tpu_torch.models.scene import tensors_from_numpy
from sexy_raytracer_tpu_torch.parallel.mesh import (
    RAY_AXIS,
    SAMPLE_AXIS,
    axis_size,
    mesh_device,
    replicate_scene,
    shard_rays,
)
from sexy_raytracer_tpu_torch.render.camera import Camera
from sexy_raytracer_tpu_torch.render.integrator import scene_no_emissive_tris
from sexy_raytracer_tpu_torch.render.renderer import render_pixels
from sexy_raytracer_tpu_torch.utils import profiling, rng
from sexy_raytracer_tpu_torch.utils.config import RenderConfig
from sexy_raytracer_tpu_torch.utils.mathx import clip


def _huber(err, delta):
    a = torch.abs(err)
    return torch.mean(torch.where(a <= delta, 0.5 * err * err,
                                  delta * (a - 0.5 * delta)))


def _loss_fn(params, scene, camera, pixel_ids, target_pixels, sample_start,
             base_key, background, *, width, height, spb, spp_total,
             max_bounce, method, loss_type="mse", huber_delta=0.1,
             last_bounce_vis=False, fused=None):
    """Scalar loss of ``spb`` samples per pixel against the target
    (inverse.py:38-130), traced by ``render_pixels`` (``fused=False``: the
    reference integrator). ``loss_type``:

    * ``mse`` — gamma-2 resolve clamped to [0, 0.999] (color.h:30-39), MSE;
    * ``huber`` — the same resolve, Huber with ``huber_delta``;
    * ``linear_mse`` — Huber on linear radiance (unbiased at any spb);
    * ``tile_linear`` — Huber on linear radiance averaged over each
      128-pixel tile of ``sample_tile_ids`` before the residual.
    """
    full = merge_params(scene, params)
    rad = render_pixels(
        full, camera, pixel_ids, sample_start, base_key, background,
        width=width, height=height, spb=spb, spp_total=spp_total,
        max_bounce=max_bounce, method=method, fused=fused,
        last_bounce_vis=last_bounce_vis,
    )
    if loss_type == "tile_linear":
        G = 128  # sample_tile_ids tile size (16 x 8)
        n = rad.shape[0] // G
        r_t = (rad / spb).reshape(n, G, 3).mean(dim=1)
        t_t = target_pixels.reshape(n, G, 3).mean(dim=1)
        return _huber(r_t - t_t, huber_delta)
    if loss_type == "linear_mse":
        return _huber(rad / spb - target_pixels, huber_delta)
    # the clip bounds are uploaded from pageable memory: a wait
    with profiling.wait("resolve"):
        resolved = clip(torch.sqrt(clip(rad / spb, 1e-8, None)), 0.0, 0.999)
    err = resolved - target_pixels
    if loss_type == "huber":
        return _huber(err, huber_delta)
    return torch.mean(err * err)


class TrainState(NamedTuple):
    params: dict
    opt_state: object
    step: int


def sample_tile_ids(rng_np, width, height, n_pixels, tile_w=16, tile_h=8,
                    roi=None):
    """Random screen tiles -> [n_pixels] int32 pixel ids (a numpy copy of
    inverse.py:139-190).

    ``roi``: optional (row0, row1, col0, col1) region the tiles are drawn
    in. Tiles come from the ceil-grid with the last row and column clamped
    inward, so every pixel can be drawn and each tile stays spatially
    coherent for the find kernel's ray blocks.
    """
    tp = tile_w * tile_h
    n_tiles = max(1, n_pixels // tp)
    r0, r1, c0, c1 = roi if roi is not None else (0, height, 0, width)
    ntx = max(1, -(-(c1 - c0) // tile_w))
    nty = max(1, -(-(r1 - r0) // tile_h))
    x0 = np.minimum(
        np.minimum(
            c0 + rng_np.integers(0, ntx, size=n_tiles) * tile_w,
            max(c1 - tile_w, c0),
        ),
        max(width - tile_w, 0),
    )
    y0 = np.minimum(
        np.minimum(
            r0 + rng_np.integers(0, nty, size=n_tiles) * tile_h,
            max(r1 - tile_h, r0),
        ),
        max(height - tile_h, 0),
    )
    yy = np.arange(tile_h)[:, None]
    xx = np.arange(tile_w)[None, :]
    y = np.minimum(y0[:, None, None] + yy[None], height - 1)
    x = np.minimum(x0[:, None, None] + xx[None], width - 1)
    ids = (y * width + x).reshape(-1)
    if ids.size < n_pixels:  # pad by repeating (n_pixels not tile-divisible)
        ids = np.concatenate([ids, ids[: n_pixels - ids.size]])
    return ids[:n_pixels].astype(np.int32)


def make_train_step(config: RenderConfig, optimizer, spb: int = 4,
                    method: str = "auto", grad_masks=None,
                    loss_type: str = "mse", huber_delta: float = 0.1,
                    param_transform=None, last_bounce_vis: bool = False, *,
                    mesh=None):
    """Build a train step on the device of the tensors it is given.

    Returns ``step(state, scene, camera, pixel_ids, target_pixels, key)
    -> (state, loss)``. ``grad_masks``: optional dict param name ->
    broadcastable 0/1 tensor; masked elements get a zero gradient.
    ``param_transform``: optional differentiable map from the optimised
    params to the scene fields merged into the scene. The step has
    ``.init(params)`` (a TrainState of copied params), ``.params_of`` and
    ``.value_and_grad(params, scene, camera, pixel_ids, target_pixels,
    key) -> (loss, grads)``, the masked gradient the update takes.

    ``mesh``: a ("rays", "samples") mesh (``parallel.make_mesh``). Every
    rank then calls the step with its ``shard_rays`` slice of the pixel
    ids and targets, and the same state, scene, camera and key; it traces
    sample ids from ``sample_shard * spb`` with ``spp_total = spb *
    n_sample_shards``, and the loss and gradients are the means over the
    whole mesh, so every rank takes the same update.

    While a profiler records, a step is the span ``step`` with the
    children ``step.forward`` (the loss), ``step.backward``
    (``autograd.grad``) and ``step.adam`` (the update and its addition),
    and its uploads from pageable memory are ``wait`` sites
    (``utils/profiling.py``). No span lies inside an autograd Function:
    their backward runs on autograd's own thread.
    """
    n_sample_shards = 1 if mesh is None else axis_size(mesh, SAMPLE_AXIS)
    kwargs = dict(
        width=config.width, height=config.height, spb=spb,
        # every traced sample counts (inverse.py:228-234): masking sample
        # ids past the config's spp would darken the estimate whenever
        # spb * n_sample_shards exceeds it
        spp_total=spb * n_sample_shards, max_bounce=config.max_bounce,
        method=method, loss_type=loss_type, huber_delta=huber_delta,
        last_bounce_vis=last_bounce_vis,
    )

    def value_and_grad(params, scene, camera, pixel_ids, target_pixels,
                       key):
        params = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        fields = param_transform(params) if param_transform else params
        with profiling.wait("background"):
            background = torch.tensor(config.background,
                                      dtype=torch.float32,
                                      device=pixel_ids.device)
        sample_start = 0 if mesh is None \
            else mesh.get_local_rank(SAMPLE_AXIS) * spb
        with profiling.span("step.forward"):
            loss = _loss_fn(fields, scene, camera, pixel_ids, target_pixels,
                            sample_start, key, background, **kwargs)
        names = list(params)
        with profiling.span("step.backward"):
            got = torch.autograd.grad(loss, [params[k] for k in names],
                                      allow_unused=True)
        # zero-filled before the reduction: every rank reduces the same
        # buffers
        grads = {k: torch.zeros_like(params[k]) if g is None else g
                 for k, g in zip(names, got)}
        loss = loss.detach()
        if mesh is not None:
            loss, grads = _mesh_mean(loss, grads, mesh)
        for k, mask in (grad_masks or {}).items():
            grads[k] = grads[k] * torch.as_tensor(
                mask, dtype=grads[k].dtype, device=grads[k].device)
        return loss, grads

    def step(state, scene, camera, pixel_ids, target_pixels, key):
        with profiling.span("step"):
            loss, grads = value_and_grad(state.params, scene, camera,
                                         pixel_ids, target_pixels, key)
            with profiling.span("step.adam"):
                updates, opt_state = optimizer.update(grads,
                                                      state.opt_state)
                new = {k: state.params[k] + updates[k] for k in grads}
        return TrainState(new, opt_state, state.step + 1), loss

    def init(params):
        params = {k: v.detach().clone() for k, v in params.items()}
        return TrainState(params, optimizer.init(params), 0)

    def params_of(state):
        return dict(state.params)

    step.init = init
    step.params_of = params_of
    step.value_and_grad = value_and_grad
    return step


def _mesh_mean(loss, grads, mesh):
    """The loss and gradients averaged over every rank of the mesh (JAX's
    pmean over "rays", then "samples", inverse.py:261-264): one flat
    buffer, summed over each axis, divided by the number of ranks."""
    names = list(grads)
    flat = torch.cat([grads[k].reshape(-1) for k in names]
                     + [loss.reshape(1)])
    for axis in (RAY_AXIS, SAMPLE_AXIS):
        dist.all_reduce(flat, group=mesh.get_group(axis))
    flat = flat / (axis_size(mesh, RAY_AXIS) * axis_size(mesh, SAMPLE_AXIS))
    out, at = {}, 0
    for k in names:
        n = grads[k].numel()
        out[k] = flat[at:at + n].view_as(grads[k])
        at += n
    return flat[at], out


class AdamState(NamedTuple):
    count: int
    mu: dict
    nu: dict


class Adam:
    """Adam with a learning rate per parameter, as
    ``optax.multi_transform`` of ``chain(zero_nans(), adam(lr))`` groups
    (inverse.py:348-362): b1 0.9, b2 0.999, eps 1e-8, bias correction, NaN
    gradients zeroed before the moments, and an optional cosine decay of
    the rate to ``alpha`` of it over ``decay_steps``. The scalar factors
    are rounded to float32 as optax computes them.
    """

    def __init__(self, lrs: dict, decay_steps=None, alpha=0.05, b1=0.9,
                 b2=0.999, eps=1e-8):
        self.lrs = dict(lrs)
        self.decay_steps = decay_steps
        self.alpha, self.b1, self.b2, self.eps = alpha, b1, b2, eps

    def init(self, params) -> AdamState:
        return AdamState(0, {k: torch.zeros_like(v) for k, v in params.items()},
                         {k: torch.zeros_like(v) for k, v in params.items()})

    def learning_rate(self, name, count) -> float:
        """The rate of ``name`` at step ``count`` (0-based)."""
        lr = self.lrs[name]
        if not self.decay_steps:
            return lr
        f = np.float32
        t = min(f(count), f(self.decay_steps))
        cosine = f(0.5) * (f(1.0) + np.cos(f(np.pi) * t / f(self.decay_steps)))
        return float(f(lr) * (f(1.0 - self.alpha) * cosine + f(self.alpha)))

    def update(self, grads, state: AdamState):
        """-> (updates to add to the params, new state)."""
        f = np.float32
        c = state.count + 1
        bc1 = float(f(1.0) - f(self.b1) ** f(c))
        bc2 = float(f(1.0) - f(self.b2) ** f(c))
        updates, mu, nu = {}, {}, {}
        for k, g in grads.items():
            g = torch.where(torch.isnan(g), torch.zeros_like(g), g)
            mu[k] = (1.0 - self.b1) * g + self.b1 * state.mu[k]
            nu[k] = (1.0 - self.b2) * (g * g) + self.b2 * state.nu[k]
            u = (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + self.eps)
            updates[k] = u * -self.learning_rate(k, state.count)
        return updates, AdamState(c, mu, nu)


def make_optimizer(params, learning_rate, lr_overrides=None,
                   decay_steps=None) -> Adam:
    """Adam with per-group learning rates and cosine decay
    (inverse.py:326-362). The texel packs (``shade_atlas``, ``atlas``,
    0-255 scale) default to ``learning_rate * 256``; every other parameter
    takes ``learning_rate`` unless ``lr_overrides`` names it.
    """
    lr_overrides = dict(lr_overrides) if lr_overrides else {}
    for texel_group in ("shade_atlas", "atlas"):
        if texel_group in params:
            lr_overrides.setdefault(texel_group, learning_rate * 256.0)
    lrs = {k: lr_overrides.get(k, learning_rate) for k in params}
    return Adam(lrs, decay_steps=decay_steps)


def inverse_render(scene, target_image, config: RenderConfig,
                   n_steps: int = 200, pixels_per_step: int = 4096,
                   spb: int = 4, learning_rate: float = 3e-3,
                   lr_overrides=None, trainable=None, method: str = "auto",
                   camera: Camera | None = None, seed: int = 0,
                   log_every: int = 25, progress: bool = True,
                   param_ema: float = 0.98, grad_masks=None, roi=None,
                   loss_type: str = "mse", huber_delta: float = 0.1,
                   init_params=None, param_transform=None, crn_key=None,
                   mesh=None):
    """Optimise scene params against ``target_image`` ([H, W, 3], 0..1;
    linear radiance for ``tile_linear``) on the scene's device
    (inverse.py:365-485) -> ``(optimised scene, [loss per step])``.

    ``trainable`` defaults to ``DEFAULT_TRAINABLE`` less the empty fields.
    Each step draws ``pixels_per_step`` pixels in 128-pixel tiles inside
    ``roi`` (row0, row1, col0, col1) with a numpy generator of ``seed``,
    gathers their target on the device, and traces with the next key of
    ``rng.split`` from ``rng.key(seed)``. ``crn_key``: common random
    numbers: every step traces with this key, so against a target rendered
    with it at the same spp the loss is zero at the true parameters.
    ``param_ema``: the returned params are the Polyak average
    ``param_ema * e + (1 - param_ema) * p`` from the first step's params
    (0 returns the last step's), computed as ``e + (1 - param_ema) *
    (p - e)``: JAX's form moves a frozen value by an ulp where the two
    products round apart, this one leaves it bit-equal.
    ``init_params`` / ``param_transform``: optimise a reparameterisation;
    the transform maps the params to scene fields, and is applied to the
    returned params too.

    Losses stay on the device and are read in one transfer at the end (and
    at each ``log_every`` print when ``progress``).

    ``mesh``: a ("rays", "samples") mesh (``parallel.make_mesh``); every
    rank calls ``inverse_render`` with the same arguments. The scene goes
    to each rank's device, ``pixels_per_step`` is rounded down to a
    multiple of the ray shards (inverse.py:451-454), every rank draws the
    same tiles and keys and traces its ``shard_rays`` slice of them, and
    every rank returns the same scene and losses (rank 0 prints them).
    """
    if mesh is not None:
        scene = replicate_scene(scene, mesh)
        if camera is not None:
            camera = camera.to(mesh_device(mesh))
        if crn_key is not None:
            crn_key = crn_key.to(mesh_device(mesh))
    dev = scene.device
    trainable = tuple(trainable or DEFAULT_TRAINABLE)
    trainable = tuple(n for n in trainable if getattr(scene, n).numel() > 0)
    if camera is None:
        camera = Camera.from_config(config.camera, config.aspect, device=dev)
    if init_params is not None:
        params = tensors_from_numpy(init_params, dev)
    else:
        params = extract_params(scene, trainable)
    optimizer = make_optimizer(params, learning_rate, lr_overrides,
                               decay_steps=n_steps)
    step = make_train_step(
        config, optimizer, spb=spb, method=method, grad_masks=grad_masks,
        loss_type=loss_type, huber_delta=huber_delta,
        param_transform=param_transform,
        last_bounce_vis=scene_no_emissive_tris(scene), mesh=mesh,
    )
    state = step.init(params)

    W, H = config.width, config.height
    target_flat = torch.as_tensor(target_image, dtype=torch.float32,
                                  device=dev).reshape(H * W, 3)
    n_ray_shards = 1 if mesh is None else axis_size(mesh, RAY_AXIS)
    pixels_per_step = max(n_ray_shards,
                          pixels_per_step // n_ray_shards * n_ray_shards)
    progress = progress and (mesh is None or dist.get_rank() == 0)

    key = rng.key(seed, device=dev)
    rng_np = np.random.default_rng(seed)
    losses = []
    ema = None
    for i in range(n_steps):
        ids = sample_tile_ids(rng_np, W, H, pixels_per_step, roi=roi)
        ids_dev = torch.from_numpy(ids).to(dev) if mesh is None \
            else shard_rays(ids, mesh)
        tgt = target_flat[ids_dev]
        if crn_key is not None:
            sub = crn_key
        else:
            key, sub = rng.split(key)
        state, loss = step(state, scene, camera, ids_dev, tgt, sub)
        if param_ema:
            with torch.no_grad():
                ema = dict(state.params) if ema is None else {
                    k: e + (1.0 - param_ema) * (state.params[k] - e)
                    for k, e in ema.items()}
        losses.append(loss)
        if progress and (i % log_every == 0 or i == n_steps - 1):
            print(f"step {i}: loss {float(loss):.6f}", flush=True)
    losses = torch.stack(losses).tolist() if losses else []
    final = ema if param_ema else state.params
    if param_transform is not None:
        with torch.no_grad():
            final = param_transform(final)
    return merge_params(scene, final), losses
