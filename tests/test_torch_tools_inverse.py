"""``sexy_raytracer_tpu_torch.tools.run_inverse_experiment`` against the
root ``tools/run_inverse_experiment.py`` (loaded from its path, unedited)
and the JAX package: the helpers and phase 1b's transforms bit for bit,
three steps of the CRN stage, stage 0 and stage B against JAX's
``inverse_render`` with the JAX tool's arguments, three silhouette steps
under the port's Adam against ``optax.adam(2e-2)`` on JAX's
``sphere_silhouette_loss``, the loss-curve PNG, and the command line on
the CPU at toy size.

The stages run on tests/test_inverse.py:35-54's 48x32 scene (via
``scene_from_numpy``) with the ROI moved inside it and fewer pixels and
samples a step; JAX on a one-device mesh with ``method="bruteforce"``.
Budgets are tests/test_torch_inverse.py's: the first loss within relative
1e-3, later ones within 1e-2; the fitted atlas within two of the largest
steps Adam can take on it, at most 1% of its values beyond 1% of one.
"""

import dataclasses
import functools
import importlib.util
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
optax = pytest.importorskip("optax")
import jax.numpy as jnp  # noqa: E402

from sexy_raytracer_tpu.diff import inverse as jinv  # noqa: E402
from sexy_raytracer_tpu.diff import silhouette as jsil  # noqa: E402
from sexy_raytracer_tpu.models import SceneBuilder as JBuilder  # noqa: E402
from sexy_raytracer_tpu.parallel.mesh import make_mesh  # noqa: E402
from sexy_raytracer_tpu.render.camera import Camera as JCamera  # noqa: E402
from sexy_raytracer_tpu_torch.models.scene import scene_from_numpy  # noqa: E402
from sexy_raytracer_tpu_torch.render.camera import Camera  # noqa: E402
from sexy_raytracer_tpu_torch.render.renderer import (  # noqa: E402
    render_accumulate,
)
from sexy_raytracer_tpu_torch.tools import run_inverse_experiment as tool  # noqa: E402
from sexy_raytracer_tpu_torch.utils.config import (  # noqa: E402
    CameraConfig,
    RenderConfig,
)
from sexy_raytracer_tpu_torch.utils.png import read_png  # noqa: E402
from test_torch_inverse import _assert_losses_close  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
CFG = RenderConfig(
    width=48, height=32, samples_per_pixel=4, max_bounce=3,
    camera=CameraConfig(eye=(0, 2, 6), look_at=(0, 1, 0), vfov_degrees=45.0,
                        aperture=0.0, focus_dist=6.0),
)
SMALL_ROI = (4, 28, 0, 48)
SPHERE = 3  # the textured sphere


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_run_inverse_experiment",
        REPO / "tools" / "run_inverse_experiment.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jtool():
    return _jax_tool()


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np_scene():
    """tests/test_inverse.py:35-54's scene as numpy arrays."""
    b = JBuilder()
    checker = b.add_checker_texture((0.2, 0.3, 0.1), (0.9, 0.9, 0.9))
    b.add_sphere((0, -1000, 0), 1000.0, b.add_pbr_material(albedo_tex=checker))
    b.add_sphere((-2.5, 2.5, 2.0), 1.0,
                 b.add_light_material(color=(15.0, 14.0, 12.0)))
    b.add_sphere((1.6, 1, 0), 1.0, b.add_metal_material((0.7, 0.6, 0.5), 0.0))
    yy, xx = np.mgrid[0:16, 0:16]
    img = np.stack([120 + 6 * xx, 90 + 5 * yy, 200 - 5 * xx],
                   axis=-1).astype(np.float32)
    b.add_sphere((-1.2, 1, 0.5), 1.0,
                 b.add_pbr_material(albedo_tex=b.add_image_texture(img),
                                    roughness=0.4))
    return b.build(build_bvh=False, device=False)


@pytest.fixture(scope="module")
def scenes():
    np_scene = _np_scene()
    return np_scene, jax.device_put(np_scene), scene_from_numpy(np_scene,
                                                                "cpu")


def _assert_atlas_close(got, want, step):
    """Within two of Adam's largest steps on the atlas (``step``), at most
    1% of the values beyond 1% of one (plus 1e-6 relative)."""
    g, w = got.numpy(), np.asarray(want)
    assert g.shape == w.shape and np.isfinite(g).all()
    diff = np.abs(g - w)
    slack = 1e-6 * np.abs(w)
    assert (diff <= 2 * step + slack).all(), diff.max()
    n_out = int((diff > 1e-2 * step + slack).sum())
    assert n_out <= 0.01 * diff.size, (n_out, diff.size)


def test_helpers_match_jax_tool(jtool):
    """resolved_of, mse (with and without the ROI), to_u8 and chan_mask
    bit for bit, on seeded inputs at the tool's 240p size."""
    assert tool.ROI == jtool.ROI
    r = np.random.default_rng(3)
    lin = r.uniform(0.0, 300.0, (240, 426, 3)).astype(np.float32)
    lin[0, :5] = 0.0
    np.testing.assert_array_equal(tool.resolved_of(lin, 128),
                                  jtool.resolved_of(lin, 128))
    a, b = (r.uniform(0, 1, (240, 426, 3)).astype(np.float32)
            for _ in range(2))
    for roi in (None, True):
        assert tool.mse(a, b, roi=roi) == jtool.mse(a, b, roi=roi)
    x = r.uniform(-50.0, 300.0, (64, 3)).astype(np.float32)
    np.testing.assert_array_equal(tool.to_u8(x), jtool.to_u8(x))
    want = jtool.chan_mask()
    got = tool.chan_mask()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_perturb_atlas_matches_jax_tool(jtool, scenes):
    _, jscene, tscene = scenes
    t_true, t_pert, t_scene = tool.perturb_atlas(tscene)
    j_true, j_pert, j_scene = jtool.perturb_atlas(jscene)
    np.testing.assert_array_equal(t_true, j_true)
    np.testing.assert_array_equal(t_pert, j_pert)
    np.testing.assert_array_equal(t_scene.shade_atlas.numpy(),
                                  np.asarray(j_scene.shade_atlas))
    assert t_scene.shade_atlas.device == tscene.shade_atlas.device


def test_phase1b_transforms_match_jax_tool():
    """The JAX tool's closures (run_inverse_experiment.py:210-272), stated
    here over a seeded base atlas, against the port's module-level
    transforms."""
    F = tool.F
    r = np.random.default_rng(5)
    L, AH, AW = 2, 4 * F, 3 * F
    base = r.uniform(-20.0, 280.0, (L, AH, AW, 8)).astype(np.float32)
    p = {"scale": r.uniform(0.5, 3.5, (L, 3)).astype(np.float32),
         "offset": r.uniform(-300.0, 100.0, (L, 3)).astype(np.float32),
         "d8": r.uniform(-40.0, 40.0, (L, AH // F, AW // F, 3))
         .astype(np.float32),
         "atlas_fr": r.uniform(-20.0, 280.0, (L, AH, AW, 8))
         .astype(np.float32)}
    base_j = jnp.asarray(base)

    def up(d):
        return jnp.repeat(jnp.repeat(d, F, axis=1), F, axis=2)

    def transform_0(p):  # also transform_0b, over stage 0's atlas
        ch = base_j[..., 0:3] * p["scale"][:, None, None, :] \
            + p["offset"][:, None, None, :]
        atlas = jnp.concatenate([ch, base_j[..., 3:]], axis=-1)
        return {"shade_atlas": jnp.clip(atlas, 0.0, 255.0)}

    def transform_a(p):
        delta = up(p["d8"])
        atlas = jnp.concatenate(
            [base_j[..., 0:3] + delta, base_j[..., 3:]], axis=-1)
        return {"shade_atlas": jnp.clip(atlas, 0.0, 255.0)}

    def transform_b(p):
        return {"shade_atlas": jnp.clip(p["atlas_fr"], 0.0, 255.0)}

    pj = {k: jnp.asarray(v) for k, v in p.items()}
    pt = {k: torch.from_numpy(v) for k, v in p.items()}
    bt = torch.from_numpy(base)
    np.testing.assert_array_equal(tool.up(pt["d8"]).numpy(),
                                  np.asarray(up(pj["d8"])))
    for got, want in (
            (tool.transform_0(bt, pt), transform_0(pj)),
            (tool.transform_0b(bt, pt), transform_0(pj)),
            (tool.transform_a(bt, pt), transform_a(pj)),
            (tool.transform_b(pt), transform_b(pj))):
        np.testing.assert_array_equal(got["shade_atlas"].numpy(),
                                      np.asarray(want["shade_atlas"]))


def _targets():
    t = np.random.default_rng(11).uniform(0.2, 0.8, (32, 48, 3))
    return t.astype(np.float32), (t * t).astype(np.float32)


SHORT = dict(n_steps=3, pixels_per_step=256, spb=2)


def _jax_run(jscene, target, **kw):
    return jinv.inverse_render(
        jscene, target, CFG, mesh=make_mesh(devices=jax.devices()[:1]),
        method="bruteforce", progress=False, roi=SMALL_ROI, **SHORT, **kw)


@pytest.mark.parametrize("stage", ["crn", "0", "B"])
def test_stage_matches_jax(jtool, scenes, monkeypatch, stage):
    """Three steps of phase 1's CRN stage, stage 0 (lr_overrides, an
    affine param_transform, tile_linear) and stage B (linear_mse, a
    masked full atlas) against JAX's inverse_render with the arguments of
    the JAX tool (:164-173, :228-240, :289-298)."""
    monkeypatch.setattr(tool, "ROI", SMALL_ROI)
    _, jscene, tscene = scenes
    resolved, linear = _targets()
    _, j_pert, j_perturbed = jtool.perturb_atlas(jscene)
    _, _, t_perturbed = tool.perturb_atlas(tscene)
    L = j_pert.shape[0]
    if stage == "crn":
        got = tool.crn_stage(t_perturbed, resolved, CFG, progress=False,
                             **SHORT)
        want = _jax_run(
            j_perturbed, resolved, learning_rate=1e-2, seed=7,
            trainable=("shade_atlas",),
            grad_masks={"shade_atlas": jtool.chan_mask()}, loss_type="mse",
            crn_key=jax.random.key(CFG.seed))
        step = 1e-2 * 256.0
    elif stage == "0":
        got = tool.stage_0(t_perturbed, linear, CFG, progress=False, **SHORT)
        base = jnp.asarray(j_pert)

        def transform_0(p):
            ch = base[..., 0:3] * p["scale"][:, None, None, :] \
                + p["offset"][:, None, None, :]
            atlas = jnp.concatenate([ch, base[..., 3:]], axis=-1)
            return {"shade_atlas": jnp.clip(atlas, 0.0, 255.0)}

        want = _jax_run(
            j_perturbed, linear, learning_rate=3e-2, seed=12,
            init_params={"scale": jnp.ones((L, 3), jnp.float32),
                         "offset": jnp.zeros((L, 3), jnp.float32)},
            lr_overrides={"offset": 3.0}, param_transform=transform_0,
            loss_type="tile_linear", huber_delta=0.5)
        step = 3e-2 * float(np.abs(j_pert).max()) + 3.0
    else:
        got = tool.stage_b(t_perturbed, torch.from_numpy(j_pert), linear,
                           CFG, progress=False, **SHORT)
        want = _jax_run(
            j_perturbed, linear, learning_rate=0.25, seed=14,
            init_params={"atlas_fr": jnp.asarray(j_pert)},
            param_transform=lambda p: {
                "shade_atlas": jnp.clip(p["atlas_fr"], 0.0, 255.0)},
            grad_masks={"atlas_fr": jtool.chan_mask()},
            loss_type="linear_mse", huber_delta=0.05)
        step = 0.25
    (to, tl), (jo, jl) = got, want
    _assert_losses_close(tl, jl)
    _assert_atlas_close(to.shade_atlas, jo.shade_atlas, step)
    assert not torch.equal(to.shade_atlas, t_perturbed.shade_atlas)


def test_silhouette_steps_match_optax(scenes):
    """Three steps of phase 1c's loop (:325-356): the port's
    ``silhouette_fit`` (its Adam at a constant 2e-2, keys
    ``rng.key(100 + i)``) against ``optax.adam(2e-2)`` on JAX's
    ``sphere_silhouette_loss`` with ``jax.random.key(100 + i)``, on the
    textured sphere displaced as the iron sphere is (n_edge 512). Each
    step's centre within 1e-3 of JAX's (a twentieth of one Adam step),
    and both move towards the truth."""
    np_scene, jscene, tscene = scenes
    target = np.clip(np.sqrt(np.clip(render_accumulate(tscene, CFG) / 4,
                                     1e-8, None)), 0.0, 0.999)
    c_true = np_scene.sph_c0[SPHERE]
    c0 = c_true + np.array([0.10, 0.08, -0.07], np.float32)
    camera = Camera.from_config(CFG.camera, CFG.aspect, device="cpu")
    got = tool.silhouette_fit(tscene, CFG, camera, target, SPHERE, c0,
                              n_steps=3)

    jcam = JCamera.from_config(CFG.camera, CFG.aspect)
    target_j = jnp.asarray(target)

    def loss(c, key):
        sc = jscene._replace(sph_c0=jscene.sph_c0.at[SPHERE].set(c),
                             sph_c1=jscene.sph_c1.at[SPHERE].set(c))
        return jsil.sphere_silhouette_loss(
            sc, jcam, target_j, [SPHERE], key, width=CFG.width,
            height=CFG.height, max_bounce=CFG.max_bounce,
            background=CFG.background, n_edge=512, method="bruteforce")

    opt = optax.adam(2e-2)
    c = jnp.asarray(c0)
    st = opt.init(c)
    want = []
    for i in range(3):
        g = jax.grad(loss)(c, jax.random.key(100 + i))
        up, st = opt.update(g, st, c)
        c = optax.apply_updates(c, up)
        want.append(np.asarray(c))
    for i, (a, b) in enumerate(zip(got, want)):
        assert np.abs(a - b).max() <= 1e-3, (i, a, b)
    err0 = np.linalg.norm(c0 - c_true)
    assert np.linalg.norm(got[-1] - c_true) < err0
    assert np.linalg.norm(want[-1] - c_true) < err0


def test_loss_curve_png_decodes(tmp_path):
    curves = {"a": list(np.geomspace(1e-2, 1e-4, 50)),
              "b": [3e-3, 0.0, 2e-3, float("nan"), 1e-3]}
    path = tmp_path / "loss_curves.png"
    legend = tool.draw_loss_curves(curves, str(path))
    img = read_png(str(path), 3)
    assert img is not None and img.shape == (440, 770, 3)
    assert sorted(legend) == ["a", "b"]
    for colour in legend.values():
        assert (img == np.asarray(colour, np.uint8)).all(-1).sum() > 20


def test_caches_are_named_by_render(monkeypatch, tmp_path):
    """The target and perturbed-render caches are reused only for the
    scene, height, spp and device type that made them."""
    monkeypatch.setattr(tool, "ART", str(tmp_path))
    cfg = dataclasses.replace(CFG, height=240, samples_per_pixel=128)
    path = tool.cache_path("target", "flagship_standin", cfg, "cuda:0")
    assert path == str(
        tmp_path / "target_flagship_standin_240p_128spp_cuda.npz")
    others = {
        tool.cache_path("target", "masterchief", cfg, "cuda"),
        tool.cache_path("target", "flagship_standin",
                        dataclasses.replace(cfg, height=120), "cuda"),
        tool.cache_path("target", "flagship_standin",
                        dataclasses.replace(cfg, samples_per_pixel=4), "cuda"),
        tool.cache_path("target", "flagship_standin", cfg, "cpu"),
        tool.cache_path("render_pert", "flagship_standin", cfg, "cuda")}
    assert len(others) == 5 and path not in others


def test_command_line_on_the_cpu(monkeypatch, tmp_path, capsys):
    """``main(["--phases", "1,1b,1c", "--device", "cpu"])`` at toy size
    (an 18-pixel-high stand-in, 4-spp target, 2 steps a stage): the scene
    named on the first line and in the report, the JAX tool's report keys
    of those phases, the loss curves' PNG and names."""
    monkeypatch.setattr(tool, "ART", str(tmp_path))
    monkeypatch.setattr(tool, "HEIGHT", 18)
    monkeypatch.setattr(tool, "TARGET_SPP", 4)
    monkeypatch.setattr(tool, "ROI", (2, 16, 2, 30))
    short = dict(n_steps=2, pixels_per_step=256, spb=4)
    for name in ("crn_stage", "stage_0", "stage_0b", "stage_a", "stage_b"):
        monkeypatch.setattr(tool, name,
                            functools.partial(getattr(tool, name), **short))
    monkeypatch.setattr(tool, "phase1c_silhouette", functools.partial(
        tool.phase1c_silhouette, n_steps=2, n_edge=32))
    assert tool.main(["--phases", "1,1b,1c", "--device", "cpu"]) == 0
    assert capsys.readouterr().out.splitlines()[0] == \
        "scene: flagship_standin"
    report = json.loads((tmp_path / "report.json").read_text())
    assert report["scene"] == "flagship_standin"
    assert report["device"] == "cpu"
    jax_keys = {
        "optimize_240p_s", "exact_mse_ratio", "pass_mse_improved",
        "optimize_240p_nocrn_s", "pass_nocrn_5x",
        "silhouette_center_err_start", "silhouette_center_err_final",
        "silhouette_err_curve", "silhouette_seconds",
        "pass_silhouette_recovery", "total_s"}
    for prefix in ("crn", "nocrn"):
        jax_keys |= {f"{prefix}_{k}" for k in (
            "loss_first5", "loss_last30", "exact_mse_perturbed",
            "exact_mse_recovered", "exact_mse_ratio")}
    assert jax_keys <= set(report), jax_keys - set(report)
    assert np.isfinite(report["crn_exact_mse_ratio"])
    assert sorted(report["loss_curves"]) == [
        "240p CRN", "240p stochastic (coarse-to-fine)"]
    img = read_png(str(tmp_path / "loss_curves.png"), 3)
    assert img is not None and img.std() > 0
    for name in ("target_flagship_standin_18p_4spp_cpu.npz",
                 "render_pert_flagship_standin_18p_4spp_cpu.npz",
                 "losses_240p.json", "losses_240p_nocrn.json",
                 "atlas_recovered_crn.png", "render_recovered_nocrn.png"):
        assert (tmp_path / name).exists(), name
