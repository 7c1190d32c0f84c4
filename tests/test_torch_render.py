"""The port's integrator and render driver against the JAX package, and
the port rendering with JAX unavailable.

Radiance is compared per ray at atol 2e-5, rtol 1e-5, allowing 0.5% of
rays outside it: the packages' compilers round differently, and where an
f32 edge flips a prim id the whole path takes another branch (ROADMAP.md
queue 3). The frame check allows 0.5% of uint8 values to differ by > 1.
"""

import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from sexy_raytracer_tpu.models import presets as jpresets  # noqa: E402
from sexy_raytracer_tpu.models.scene import SceneBuilder as JBuilder  # noqa: E402
from sexy_raytracer_tpu.render import integrator as jint  # noqa: E402
from sexy_raytracer_tpu.render.camera import Camera as JCamera  # noqa: E402
from sexy_raytracer_tpu.render.renderer import (  # noqa: E402
    render_image as j_render_image,
)
from sexy_raytracer_tpu.utils import rng as jrng  # noqa: E402
from sexy_raytracer_tpu.utils.config import CameraConfig  # noqa: E402
from sexy_raytracer_tpu_torch.models import presets as tpresets  # noqa: E402
from sexy_raytracer_tpu_torch.models.scene import scene_from_numpy  # noqa: E402
from sexy_raytracer_tpu_torch.render import integrator as tint  # noqa: E402
from sexy_raytracer_tpu_torch.render.renderer import (  # noqa: E402
    render_image as t_render_image,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _assert_radiance_close(got, want, budget=0.005):
    close = np.isclose(got, want, atol=2e-5, rtol=1e-5).all(axis=1)
    assert close.mean() >= 1.0 - budget, (
        f"{(~close).sum()}/{close.size} rays outside tolerance")


@pytest.fixture(scope="module")
def wavefront():
    """The scene and rays of tests/test_fused.py:22-52."""
    b = JBuilder()
    checker = b.add_checker_texture((0.2, 0.3, 0.1), (0.9, 0.9, 0.9))
    b.add_sphere((0, -1000, 0), 1000.0, b.add_pbr_material(albedo_tex=checker))
    b.add_sphere((-2, 1, 0), 1.0, b.add_light_material(color=(10, 9, 7)))
    b.add_sphere((2, 1, 0), 1.0, b.add_metal_material((0.7, 0.6, 0.5), 0.0))
    b.add_sphere((0, 1, 2), 1.0, b.add_dielectric_material(1.5))
    tex = b.add_image_texture(
        (np.arange(16 * 16 * 3).reshape(16, 16, 3) * 7 % 256).astype(np.uint8)
    )
    mat = b.add_pbr_material(albedo_tex=tex)
    b.add_mesh([[-1, 0, -2], [1, 0, -2], [0, 2, -2]],
               [[0, 0], [1, 0], [0.5, 1]], [[0, 1, 2]], mat)
    np_scene = b.build(build_bvh=False, device=False)

    cam = JCamera.from_config(
        CameraConfig(eye=(0, 2, 6), look_at=(0, 1, 0), vfov_degrees=45.0,
                     aperture=0.1, focus_dist=6.0),
        32 / 24,
    )
    R = 2048
    pid = jnp.arange(R, dtype=jnp.int32) % (32 * 24)
    keys = jrng.ray_keys_2d(jax.random.key(1), pid,
                            jnp.zeros((R,), jnp.int32))
    ucam = jrng.per_ray_uniform_block(keys, 5)
    u = ((pid % 32).astype(jnp.float32) + ucam[..., 0]) / 31
    v = ((24 - pid // 32).astype(jnp.float32) + ucam[..., 1]) / 23
    org, dirs, times = cam.get_rays(u, v, ucam[..., 2:5])
    bg = (0.5, 0.7, 0.9)
    jax_args = (jax.device_put(np_scene), org, dirs, times, keys,
                jnp.asarray(bg, jnp.float32))
    torch_args = (
        scene_from_numpy(np_scene, "cpu"),
        *(torch.from_numpy(np.array(x)) for x in (org, dirs, times)),
        torch.from_numpy(np.asarray(jax.random.key_data(keys),
                                    np.int64)),
        torch.tensor(bg),
    )
    return jax_args, torch_args


@pytest.mark.parametrize("bounces,vis", [(1, False), (3, False), (1, True),
                                         (3, True)])
def test_trace_rays_fused_matches_jax(wavefront, bounces, vis):
    jax_args, torch_args = wavefront
    assert tint.scene_no_emissive_tris(torch_args[0])
    want = np.asarray(jint.trace_rays_fused(
        *jax_args, bounces, method="bruteforce", last_bounce_vis=vis))
    got = tint.trace_rays_fused(*torch_args, bounces,
                                last_bounce_vis=vis).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    _assert_radiance_close(got, want)
    assert got.max() > 0.1   # the light and the background were reached


def test_zero_bounces_is_black(wavefront):
    """max_bounce=0 traces nothing, with or without the last-bounce
    shortcut (the JAX fused path fails there, ROADMAP.md queue 3)."""
    _, torch_args = wavefront
    for vis in (False, True):
        got = tint.trace_rays_fused(*torch_args, 0, last_bounce_vis=vis)
        assert got.shape == (2048, 3)
        assert (got == 0).all()


def test_standin_frame_matches_jax(tmp_path):
    """A 32x24, 2-spp frame of the small stand-in scene through both
    packages' render_image (JAX: its CPU integrator, brute-force find)."""
    b = JBuilder()
    tpresets.add_relief_mesh(b, 15)
    jpresets._add_ground_and_lights(b)
    jpresets._add_iron_and_metal(b, str(tmp_path))
    jscene = b.build(build_bvh=False)
    tscene, cfg = tpresets.flagship_standin(n=15, spp=2, height=24,
                                            data_dir=str(tmp_path),
                                            device="cpu")
    cfg = dataclasses.replace(cfg, width=32, height=24)
    want = j_render_image(jscene, cfg)
    got = t_render_image(tscene, cfg)
    assert got.shape == want.shape == (24, 32, 3) and got.dtype == np.uint8
    off = np.abs(got.astype(int) - want.astype(int)) > 1
    assert off.mean() <= 0.005, f"{off.sum()}/{off.size} values differ by > 1"
    assert got.std() > 10


def test_checkpoint_resume_matches_uninterrupted(tmp_path):
    """An interrupted render resumed from its npz checkpoint equals the
    uninterrupted render; the checkpoint has the JAX driver's keys
    (renderer.py:231-241)."""
    from sexy_raytracer_tpu_torch.render.renderer import (
        render_accumulate,
        tile_pixel_order,
    )

    scene, cfg = tpresets.flagship_standin(n=8, spp=3, height=8,
                                           data_dir=str(tmp_path),
                                           device="cpu")
    cfg = dataclasses.replace(cfg, width=16, height=8, rays_per_chunk=64,
                              samples_per_batch=2)
    full = render_accumulate(scene, cfg)
    ckpt = str(tmp_path / "render.npz")
    render_accumulate(scene, cfg, checkpoint=ckpt)
    saved = dict(np.load(ckpt))
    assert set(saved) == {"accum", "units_done", "shape", "spp", "seed",
                          "chunk", "spb", "order_hash"}
    np.testing.assert_array_equal(saved["accum"].reshape(full.shape), full)
    # rewind to half the chunks: their units done, the rest never started
    chunk, per_chunk = int(saved["chunk"]), -(-3 // 2)
    n_chunks = int(saved["units_done"]) // per_chunk
    done = n_chunks // 2
    order = tile_pixel_order(16, 8)
    accum = saved["accum"].copy()
    accum[order[done * chunk:]] = 0.0
    np.savez(ckpt, **{**saved, "accum": accum,
                      "units_done": done * per_chunk})
    resumed = render_accumulate(scene, cfg, checkpoint=ckpt)
    np.testing.assert_array_equal(resumed, full)


def test_port_renders_without_jax(tmp_path):
    script = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None  # any import of jax now fails
        import dataclasses
        from sexy_raytracer_tpu_torch.models import presets
        from sexy_raytracer_tpu_torch.render.renderer import render_image
        scene, cfg = presets.flagship_standin(n=8, spp=1, height=8,
                                              data_dir=sys.argv[1],
                                              device="cpu")
        cfg = dataclasses.replace(cfg, width=16, height=8)
        img = render_image(scene, cfg)
        assert img.shape == (8, 16, 3) and img.std() > 0, img
        assert not any(m == "jax" or m.startswith(("jax.", "jaxlib",
                       "sexy_raytracer_tpu."))
                       for m in sys.modules if sys.modules[m] is not None)
        print("ok")
    """)
    proc = subprocess.run(
        [sys.executable, "-c", script, str(tmp_path)], cwd=REPO,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().endswith("ok")
