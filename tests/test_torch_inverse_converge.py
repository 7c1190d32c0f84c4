"""The port's mirror of tests/test_inverse.py:57, the stochastic
inverse-rendering convergence test: the same scene, config, perturbation,
masks, steps, learning rate, seed and assertions, on CPU tensors with
``method="bruteforce"``. No common random numbers: every step draws its
own samples, so the per-step loss converges into its Monte-Carlo floor,
and the exact objective (a deterministic re-render against the target)
must drop at least 10x. A file of its own, so that a worker of
``--dist loadfile`` takes it alone.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sexy_raytracer_tpu_torch.diff.inverse import inverse_render  # noqa: E402
from sexy_raytracer_tpu_torch.render.renderer import (  # noqa: E402
    render_accumulate,
)
from sexy_raytracer_tpu_torch.utils.config import (  # noqa: E402
    CameraConfig,
    RenderConfig,
)
from sexy_raytracer_tpu_torch.utils.mathx import clip  # noqa: E402
from test_torch_inverse_crn import _inverse_scene  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def test_inverse_rendering_converges():
    scene = _inverse_scene()
    cfg = RenderConfig(
        width=48, height=32, samples_per_pixel=128, max_bounce=3,
        camera=CameraConfig(eye=(0, 2, 6), look_at=(0, 1, 0),
                            vfov_degrees=45.0, aperture=0.0, focus_dist=6.0),
    )
    # self-rendered target from the TRUE parameters
    target = render_accumulate(scene, cfg, method="bruteforce")
    target = np.clip(np.sqrt(np.clip(
        target / cfg.samples_per_pixel, 1e-8, None)), 0, 0.999)

    # perturb: texture pack strongly recolored, textured sphere displaced
    true_c0 = scene.sph_c0.numpy()
    shift = np.zeros_like(true_c0)
    shift[3] = (-0.3, 0.2, 0.25)    # textured PBR sphere
    perturbed = scene._replace(
        shade_atlas=clip(scene.shade_atlas * 0.5 + 60.0, 0.0, 255.0),
        sph_c0=torch.from_numpy(true_c0 + shift),
        sph_c1=torch.from_numpy(true_c0 + shift),
    )

    # ground, light and mirror spheres frozen (the mirror sphere's
    # position is not identifiable, test_inverse.py's docstring)
    mask = np.zeros((4, 1), np.float32)
    mask[3] = 1.0
    opt, losses = inverse_render(
        perturbed, target,
        dataclasses.replace(cfg, samples_per_pixel=32),
        n_steps=300, pixels_per_step=768, spb=32,
        learning_rate=8e-3, method="bruteforce", seed=5, progress=False,
        trainable=("shade_atlas", "sph_c0", "sph_c1"),
        grad_masks={"sph_c0": mask, "sph_c1": mask},
    )

    # the stochastic training loss decreases (into its MC floor)
    init_loss = np.mean(losses[:5])
    final_loss = np.mean(losses[-30:])
    assert final_loss < init_loss, (init_loss, final_loss)

    # the displaced sphere comes back; frozen spheres never move
    errs = np.linalg.norm(opt.sph_c0.numpy() - true_c0, axis=1)
    assert errs[3] < 0.15, errs
    assert errs[0] == 0 and errs[1] == 0 and errs[2] == 0, errs

    # the exact objective: a deterministic re-render's MSE drops >= 10x
    def mse_vs_target(s):
        img = render_accumulate(s, cfg, method="bruteforce")
        img = np.clip(np.sqrt(np.clip(
            img / cfg.samples_per_pixel, 1e-8, None)), 0, 0.999)
        return float(((img - target) ** 2).mean())

    mse_pert = mse_vs_target(perturbed)
    mse_opt = mse_vs_target(opt)
    print(f"exact objective {mse_pert:.3e} -> {mse_opt:.3e} "
          f"({mse_pert / mse_opt:.1f}x); sphere error {errs[3]:.4f}")
    assert mse_opt < 0.1 * mse_pert, (mse_pert, mse_opt)
    assert mse_opt < 5e-4, mse_opt
