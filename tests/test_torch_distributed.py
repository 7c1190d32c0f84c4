"""The port's process groups, ``inverse_render(mesh=)`` and
``graft_entry`` on gloo ranks, against the single-process port and the
root ``__graft_entry__.py`` of the JAX package (``entry`` and
``dryrun_multichip`` on 4 of its 8 virtual CPU devices).

Tolerances, each with its reason:
* the inverse loop on a (2, 1) mesh against no mesh on the same global
  tiles: relative loss 1e-5, the summation order of the mean over ranks;
* the inverse loop on a (2, 1) mesh against JAX's ``inverse_render`` on a
  (2, 1) mesh of its virtual devices: every loss within relative 1e-3
  (bench.py:192; measured, at most 5e-5), and each trained field within
  the budget of tests/test_torch_inverse.py, two learning rates, at most
  1% of its elements beyond 1% of one, plus 1e-6 relative (measured, at
  most 0.041 of one, on the ground sphere's centre at y = -1000, inside
  that float32 slack);
* ``entry``'s radiance against JAX's: the trace parity budget of
  tests/test_torch_render.py:42 (atol 2e-5, rtol 1e-5, 0.5% of pixels);
* the dryrun's loss against JAX's printed one: relative 1e-3
  (bench.py:192).

Neither package finds the Master Chief asset here. ``entry`` then takes
``shirley_spheres`` in both. The dryrun's centre pixels on that field see
glass and sky alone at 2 bounces, so no parameter gets a gradient and
JAX's own dryrun stops at its "moved" assert; the port's dryrun takes the
flagship stand-in instead, and JAX's is given the same scene.
"""

import re
import tempfile
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import torch.distributed as dist  # noqa: E402

import __graft_entry__ as jentry  # noqa: E402
from sexy_raytracer_tpu.diff.inverse import (  # noqa: E402
    inverse_render as j_inverse_render,
)
from sexy_raytracer_tpu.parallel import mesh as jmesh  # noqa: E402
import torch_parallel_ranks as ranks  # noqa: E402
from sexy_raytracer_tpu.models import SceneBuilder as JBuilder  # noqa: E402
from sexy_raytracer_tpu.models import presets as jpresets  # noqa: E402
from sexy_raytracer_tpu.utils.config import CameraConfig as JCameraConfig  # noqa: E402
from sexy_raytracer_tpu.utils.config import RenderConfig as JRenderConfig  # noqa: E402
from sexy_raytracer_tpu_torch import graft_entry  # noqa: E402
from sexy_raytracer_tpu_torch.diff.inverse import inverse_render  # noqa: E402
from sexy_raytracer_tpu_torch.models import presets as tpresets  # noqa: E402
from sexy_raytracer_tpu_torch.parallel import init_distributed, spawn  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def no_assets(monkeypatch, tmp_path):
    """An empty data directory for both packages."""
    monkeypatch.setenv("SRT_DATA_DIR", str(tmp_path))


@pytest.fixture(scope="module")
def two():
    return spawn(ranks.two_ranks_inverse, 2, "gloo", "cpu", timeout=300)


def _rank_runs(two, pixels):
    """Rank 0's (losses, trained fields) at ``pixels`` a step, checked to
    be rank 1's bit for bit."""
    (runs, _), (runs1, _) = two
    losses, fields = runs[pixels]
    losses1, fields1 = runs1[pixels]
    assert losses1 == losses
    for k in fields:
        assert torch.equal(fields1[k], fields[k]), k
    return losses, fields


def test_inverse_render_on_a_mesh_matches_no_mesh(two):
    """Three steps on a (2, 1) mesh: every rank returns the same scene and
    losses, and the losses are those of no mesh on the same tiles."""
    losses, fields = _rank_runs(two, 256)
    opt, want = inverse_render(ranks.scene(), ranks.inverse_target(),
                               ranks.cfg(**ranks.INV_CFG), pixels_per_step=256,
                               **ranks.INV)
    assert len(losses) == len(want) == ranks.INV["n_steps"]
    for g, w in zip(losses, want):
        assert abs(g - w) <= 1e-5 * abs(w), (losses, want)
    assert not torch.equal(fields["mat_base_color"],
                           ranks.scene().mat_base_color)


def _jax_scene_and_config(**kw):
    """The scene of ``ranks.scene()`` and ``ranks.cfg(**kw)`` built by the
    JAX package (tests/test_parallel.py:21-41)."""
    b = JBuilder()
    checker = b.add_checker_texture((0.2, 0.3, 0.1), (0.9, 0.9, 0.9))
    b.add_sphere((0, -1000, 0), 1000.0, b.add_pbr_material(albedo_tex=checker))
    b.add_sphere((-2, 1, 0), 1.0, b.add_light_material(color=(10, 9, 7)))
    b.add_sphere((2, 1, 0), 1.0, b.add_metal_material((0.7, 0.6, 0.5), 0.0))
    mat = b.add_pbr_material(base_color=(0.9, 0.3, 0.3, 1.0))
    b.add_mesh([[-1, 0, -2], [1, 0, -2], [0, 2, -2]], None, [[0, 1, 2]], mat)
    c = ranks.cfg(**kw)
    jcfg = JRenderConfig(
        width=c.width, height=c.height, samples_per_pixel=c.samples_per_pixel,
        max_bounce=c.max_bounce, rays_per_chunk=c.rays_per_chunk,
        samples_per_batch=c.samples_per_batch,
        camera=JCameraConfig(eye=(0, 2, 6), look_at=(0, 1, 0),
                             vfov_degrees=45.0, aperture=0.0, focus_dist=6.0))
    return b.build(build_bvh=False), jcfg


@pytest.mark.parametrize("pixels", ranks.INV_PIXELS)
def test_inverse_render_on_a_mesh_matches_jax(two, pixels):
    """Three steps on a (2, 1) mesh against JAX's ``inverse_render`` on a
    (2, 1) mesh of two virtual devices, with the same arguments: the tile
    ids and keys, their split over the ray shards, the rounding of 255
    pixels a step down to 254, the mean over the mesh and the EMA."""
    if len(jax.devices()) < 2:
        pytest.skip("needs 2 JAX CPU devices")
    losses, fields = _rank_runs(two, pixels)
    jscene, jcfg = _jax_scene_and_config(**ranks.INV_CFG)
    jopt, want = j_inverse_render(
        jscene, ranks.inverse_target(), jcfg, pixels_per_step=pixels,
        mesh=jmesh.make_mesh(2, 1, devices=jax.devices()[:2]), **ranks.INV)
    assert len(losses) == len(want) == ranks.INV["n_steps"]
    assert np.isfinite(losses).all()
    for g, w in zip(losses, want):
        assert abs(g - w) <= 1e-3 * abs(w), (losses, want)
    for k, got in fields.items():
        # inverse_render's default learning rate in both packages, 256
        # times that for the texel packs (0-255 scale)
        lr = 3e-3 * (256.0 if k in ("shade_atlas", "atlas") else 1.0)
        g = got.numpy()
        w = np.asarray(getattr(jopt, k))
        assert g.shape == w.shape and np.isfinite(g).all(), k
        diff = np.abs(g - w)
        slack = 1e-6 * np.abs(w)
        assert (diff <= 2 * lr + slack).all(), (k, diff.max())
        n_out = int((diff > 1e-2 * lr + slack).sum())
        assert n_out <= 0.01 * diff.size, (k, n_out, diff.size)


def test_make_mesh_refuses_a_wrong_size(two):
    """On 2 ranks: 2 x 2, 3 x 1 and 1 x 3 meshes raise."""
    for _, refused in two:
        assert refused == [dict(n_rays=2, n_samples=2), dict(n_rays=3),
                           dict(n_samples=3)]


def test_a_failed_rank_fails_the_spawn():
    """A rank that raises fails ``spawn`` with its own error, not that of
    the rank it stopped in a collective, and that rank is stopped long
    before the group's timeout."""
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError,
                       match=r"rank 1 of 2 raised first(.|\n)*rank 1 fails"):
        spawn(ranks.rank_1_fails, 2, "gloo", "cpu", timeout=120)
    assert time.perf_counter() - t0 < 60


def test_init_distributed_without_configuration_is_a_noop(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    init_distributed()
    init_distributed(device="cpu", backend="gloo")
    assert not dist.is_initialized()
    with pytest.raises(ValueError):
        init_distributed("127.0.0.1:1", device="cpu")
    assert not dist.is_initialized()


def test_entry_matches_jax(no_assets):
    """``entry``'s render_pixels (2,048 pixels, spb 2, key 0) on
    shirley_spheres against JAX's ``entry()`` fn on its own args."""
    fn, args = graft_entry.entry(device="cpu")
    got = fn(*args)
    assert tuple(got.shape) == (2048, 3)
    jfn, jargs = jentry.entry()
    assert int(jargs[0].sph_radius.shape[0]) == int(args[0].sph_radius.shape[0]) > 400
    want = np.asarray(jax.jit(jfn)(*jargs))
    got = got.numpy()
    assert np.isfinite(got).all()
    close = np.isclose(got, want, atol=2e-5, rtol=1e-5).all(axis=1)
    assert close.mean() >= 0.995, \
        f"pixels outside the budget: {np.flatnonzero(~close).tolist()}"


def _jax_standin(tiny=False):
    """The port's flagship stand-in composed with the JAX package's
    ``SceneBuilder`` (presets.flagship_standin's order)."""
    b = JBuilder()
    tpresets.add_relief_mesh(b)
    jpresets._add_ground_and_lights(b)
    with tempfile.TemporaryDirectory() as no_textures:
        jpresets._add_iron_and_metal(b, no_textures)
    return b.build(), JRenderConfig(camera=jpresets._flagship_camera())


def test_dryrun_multichip_takes_cards_by_default(monkeypatch):
    """Without ``device``, the dryrun (and its command line) asks for
    ``n`` cards over NCCL and raises when fewer exist; it never falls back
    to CPU ranks."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="need 2 devices, have 1"):
        graft_entry.dryrun_multichip(2)
    with pytest.raises(RuntimeError, match="need 4 devices, have 1"):
        graft_entry.main(["dryrun", "4"])


def test_dryrun_multichip_matches_jax(no_assets, monkeypatch, capsys):
    """The port's dryrun on 4 CPU ranks (a 2 x 2 mesh, asked for with
    ``device="cpu"``) exits cleanly and prints the loss of JAX's dryrun on
    4 virtual devices."""
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 JAX CPU devices")
    loss = graft_entry.dryrun_multichip(4, device="cpu")
    out = capsys.readouterr().out
    assert f"dryrun_multichip(4): ok, loss={loss:.6f}" in out
    monkeypatch.setattr(jentry, "_flagship_scene", _jax_standin)
    jentry.dryrun_multichip(4)
    want = float(re.search(r"dryrun_multichip\(4\): ok, loss=([0-9.]+)",
                           capsys.readouterr().out).group(1))
    assert np.isfinite(loss)
    assert abs(loss - want) <= 1e-3 * abs(want), (loss, want)
