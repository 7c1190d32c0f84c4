"""The port's differentiable train step against the JAX package: parameter
merging, Adam, the four losses with their gradients, and three steps of
``make_train_step``, on the scene of tests/test_fused.py:22-52 at 32x24.

Tolerances, each with its reason:
* loss and gradients: the gate the JAX package applies between its own two
  integrators (bench.py:192), relative loss 1e-3 and, per parameter, the
  largest gradient difference within 1e-2 of the largest gradient. The
  packages round differently, and an f32 edge can flip a path (ROADMAP.md
  queue 3); measured here, both stay below 1e-3.
* parameters after Adam steps: within 1% of one step's size (the learning
  rate) of JAX's, and rtol 1e-6 for the far ground sphere. A path that
  flips at an f32 edge can turn the sign of a small gradient component,
  and Adam's early steps move every element by about one learning rate
  whatever its gradient's size: so a budget of 1% of the elements may
  differ by up to two steps, and after the first step the loss by 1e-2.
* merged geometry: float32 rounding of products of the vertices.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from sexy_raytracer_tpu.diff import inverse as jinv  # noqa: E402
from sexy_raytracer_tpu.diff.params import (  # noqa: E402
    extract_params as j_extract,
)
from sexy_raytracer_tpu.diff.params import merge_params as j_merge  # noqa: E402
from sexy_raytracer_tpu.models import SceneBuilder as JBuilder  # noqa: E402
from sexy_raytracer_tpu.models import presets as jpresets  # noqa: E402
from sexy_raytracer_tpu.parallel.mesh import make_mesh  # noqa: E402
from sexy_raytracer_tpu.render.camera import Camera as JCamera  # noqa: E402
from sexy_raytracer_tpu.utils.config import CameraConfig, RenderConfig  # noqa: E402
from sexy_raytracer_tpu_torch.diff import inverse as tinv  # noqa: E402
from sexy_raytracer_tpu_torch.diff.params import (  # noqa: E402
    DEFAULT_TRAINABLE,
    extract_params,
    merge_params,
)
from sexy_raytracer_tpu_torch.models import presets as tpresets  # noqa: E402
from sexy_raytracer_tpu_torch.models.scene import (  # noqa: E402
    SceneBuilder as TBuilder,
    scene_from_numpy,
)
from sexy_raytracer_tpu_torch.ops.find import find_occluded  # noqa: E402
from sexy_raytracer_tpu_torch.ops.intersect import find_hit  # noqa: E402
from sexy_raytracer_tpu_torch.render.camera import Camera as TCamera  # noqa: E402
from sexy_raytracer_tpu_torch.utils import rng as trng  # noqa: E402

CFG = RenderConfig(
    width=32, height=24, samples_per_pixel=2, max_bounce=3,
    camera=CameraConfig(eye=(0, 2, 6), look_at=(0, 1, 0), vfov_degrees=45.0,
                        aperture=0.1, focus_dist=6.0),
)
IDS = np.arange(32 * 24, dtype=np.int32)  # every pixel: six 128-pixel tiles
TARGET = np.full((IDS.size, 3), 0.5, np.float32)


@pytest.fixture(scope="module")
def scenes():
    """(JAX scene, port scene on the CPU) of tests/test_fused.py:22-52."""
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
    return jax.device_put(np_scene), scene_from_numpy(np_scene, "cpu")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The plain versions here work on small tensors; one intra-op thread
    keeps them from contending with the suite's other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cameras():
    return (JCamera.from_config(CFG.camera, CFG.aspect),
            TCamera.from_config(CFG.camera, CFG.aspect, device="cpu"))


def _assert_grads_close(got, want):
    for k, w in want.items():
        w = np.asarray(w)
        g = got[k].numpy()
        assert np.isfinite(g).all(), k
        scale = max(float(np.abs(w).max()), 1e-12)
        assert float(np.abs(g - w).max()) <= 1e-2 * scale, k


def test_sample_tile_ids_matches_jax():
    for args, kw in (((1280, 720, 32768), {}), ((37, 29, 1000), {}),
                     ((640, 360, 4096), {"roi": (100, 300, 50, 400)})):
        want = jinv.sample_tile_ids(np.random.default_rng(4), *args, **kw)
        got = tinv.sample_tile_ids(np.random.default_rng(4), *args, **kw)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == np.int32


def test_merge_params_tri_geometry_matches_jax(tmp_path):
    """Trained vertices re-derive the plane/edge pack and the cluster
    boxes (two clusters of the 450-triangle relief)."""
    b = JBuilder()
    tpresets.add_relief_mesh(b, 15)
    jscene = b.build(build_bvh=False)
    tscene = scene_from_numpy(jax.device_get(jscene), "cpu")
    r = np.random.default_rng(0)
    moved = {k: np.asarray(getattr(jscene, k))
             + r.normal(0, 0.05, getattr(jscene, k).shape).astype(np.float32)
             for k in ("tri_v0", "tri_v1", "tri_v2")}
    moved["sph_c0"] = np.zeros((0, 3), np.float32)
    want = j_merge(jscene, {k: jnp.asarray(v) for k, v in moved.items()})
    got = merge_params(tscene, {k: torch.from_numpy(v)
                                for k, v in moved.items()})
    for k in ("tri_n", "tri_d", "tri_q", "tri_c", "cluster_min",
              "cluster_max"):
        np.testing.assert_allclose(getattr(got, k).numpy(),
                                   np.asarray(getattr(want, k)),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    assert tscene.cluster_min.shape[0] == 2
    assert not (got.cluster_min == tscene.cluster_min).all()


def test_merge_params_refits_the_bvh_like_jax(tmp_path):
    """A JAX scene from ``build()`` with its defaults (BVH included),
    carried across, with ``sph_c0`` and ``tri_v0`` moved: the refit node
    bounds equal JAX's bit for bit. ``DEFAULT_TRAINABLE`` trains
    ``sph_c0``, so every train step on such a scene refits."""
    b = JBuilder()
    tpresets.add_relief_mesh(b, 8)
    jpresets._add_ground_and_lights(b)
    jpresets._add_iron_and_metal(b, str(tmp_path))
    jscene = jax.device_get(b.build())
    assert jscene.bvh_min.shape[0] == 2 * (128 + 4) - 1
    tscene = scene_from_numpy(jscene, "cpu")
    r = np.random.default_rng(3)
    moved = {k: (np.asarray(getattr(jscene, k))
                 + r.normal(0, 0.05, getattr(jscene, k).shape)
                 ).astype(np.float32) for k in ("sph_c0", "tri_v0")}
    want = j_merge(jax.device_put(jscene),
                   {k: jnp.asarray(v) for k, v in moved.items()})
    got = merge_params(tscene, {k: torch.from_numpy(v)
                                for k, v in moved.items()})
    for k in ("bvh_min", "bvh_max"):
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(want, k)),
                                      err_msg=k)
        assert not np.array_equal(getattr(got, k).numpy(),
                                  getattr(jscene, k))
    # a parameter that is no geometry leaves the tree as it was
    same = merge_params(tscene, {"mat_metallic": tscene.mat_metallic})
    assert same.bvh_min is tscene.bvh_min


def test_make_optimizer_matches_optax():
    """50 steps of two groups (the texel pack at lr * 256), cosine decay
    over 30 steps, and NaN gradients, against optax."""
    r = np.random.default_rng(1)
    params = {"shade_atlas": r.uniform(0, 255, (2, 4, 4, 8)),
              "mat_base_color": r.uniform(0, 1, (5, 4))}
    params = {k: v.astype(np.float32) for k, v in params.items()}
    jopt = jinv.make_optimizer(params, 3e-3, decay_steps=30)
    topt = tinv.make_optimizer(params, 3e-3, decay_steps=30)
    assert topt.lrs == {"shade_atlas": 3e-3 * 256, "mat_base_color": 3e-3}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js, ts = jopt.init(jp), topt.init(tp)
    for _ in range(50):
        grads = {k: r.normal(size=v.shape).astype(np.float32)
                 for k, v in params.items()}
        for g in grads.values():
            g[r.random(g.shape) < 0.05] = np.nan
        ju, js = jopt.update({k: jnp.asarray(v) for k, v in grads.items()},
                             js, jp)
        jp = optax.apply_updates(jp, ju)
        tu, ts = topt.update({k: torch.from_numpy(v) for k, v in
                              grads.items()}, ts)
        tp = {k: tp[k] + tu[k] for k in tp}
    for k in params:
        got, want = tp[k].numpy(), np.asarray(jp[k])
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=1e-6,
                                   atol=1e-2 * topt.lrs[k], err_msg=k)
        assert np.abs(got - params[k]).max() > 2 * topt.lrs[k]


@pytest.mark.parametrize("loss_type", ["mse", "huber", "linear_mse",
                                       "tile_linear"])
def test_loss_fn_matches_jax(scenes, loss_type):
    jscene, tscene = scenes
    jcam, tcam = _cameras()
    kw = dict(width=CFG.width, height=CFG.height, spb=2, spp_total=2,
              max_bounce=CFG.max_bounce, loss_type=loss_type,
              last_bounce_vis=True)
    want_loss, want = jax.value_and_grad(
        lambda p: jinv._loss_fn(p, jscene, jcam, jnp.asarray(IDS),
                                jnp.asarray(TARGET), 0, jax.random.key(3),
                                jnp.asarray(CFG.background),
                                method="bruteforce", **kw)
    )(j_extract(jscene))
    params = {k: v.clone().requires_grad_(True)
              for k, v in extract_params(tscene).items()}
    loss = tinv._loss_fn(params, tscene, tcam, torch.from_numpy(IDS),
                         torch.from_numpy(TARGET), 0, trng.key(3),
                         torch.tensor(CFG.background), method="auto", **kw)
    got = dict(zip(params, torch.autograd.grad(loss, list(params.values()),
                                               allow_unused=True)))
    got = {k: torch.zeros_like(params[k]) if g is None else g
           for k, g in got.items()}
    assert abs(float(loss.detach()) - float(want_loss)) <= \
        1e-3 * abs(float(want_loss))
    _assert_grads_close(got, want)
    for k in ("shade_atlas", "mat_base_color", "mat_albedo_c0", "sph_c0"):
        assert float(got[k].abs().max()) > 0.0, k


def test_train_steps_match_jax(scenes):
    """Three steps of make_train_step with make_optimizer (cosine decay)
    and a gradient mask that freezes the ground sphere, against JAX's
    make_train_step on a one-device mesh."""
    jscene, tscene = scenes
    jcam, tcam = _cameras()
    mask = np.ones((4, 1), np.float32)
    mask[0] = 0.0
    masks = {"sph_c0": mask, "sph_c1": mask}
    jp, tp = j_extract(jscene), extract_params(tscene)
    assert tuple(tp) == DEFAULT_TRAINABLE
    jopt = jinv.make_optimizer(jp, 1e-3, decay_steps=3)
    topt = tinv.make_optimizer(tp, 1e-3, decay_steps=3)
    jstep = jinv.make_train_step(make_mesh(devices=jax.devices()[:1]), CFG,
                                 jopt, spb=2, method="bruteforce",
                                 grad_masks=masks, last_bounce_vis=True)
    tstep = tinv.make_train_step(CFG, topt, spb=2, grad_masks=masks,
                                 last_bounce_vis=True)
    js, ts = jstep.init(jp), tstep.init(tp)
    assert ts.params["sph_c0"] is not tscene.sph_c0  # init copies
    for i in range(3):
        js, jl = jstep(js, jscene, jcam, jnp.asarray(IDS),
                       jnp.asarray(TARGET), jax.random.key(10 + i))
        ts, tl = tstep(ts, tscene, tcam, torch.from_numpy(IDS),
                       torch.from_numpy(TARGET), trng.key(10 + i))
        tol = 1e-3 if i == 0 else 1e-2
        assert abs(float(tl) - float(jl)) <= tol * abs(float(jl))
    assert ts.step == 3
    got = tstep.params_of(ts)
    n_out = n_all = 0
    for k in tp:
        diff = np.abs(got[k].numpy() - np.asarray(js.params[k]))
        slack = 1e-6 * np.abs(np.asarray(js.params[k]))
        assert (diff <= 2 * topt.lrs[k] + slack).all(), k
        n_out += int((diff > 1e-2 * topt.lrs[k] + slack).sum())
        n_all += diff.size
    assert n_out <= 0.01 * n_all, (n_out, n_all)
    assert torch.equal(got["sph_c0"][0], tscene.sph_c0[0])  # masked
    assert not torch.equal(got["sph_c0"][1:], tscene.sph_c0[1:])
    assert not torch.equal(got["shade_atlas"], tscene.shade_atlas)


def test_scenes_default_to_the_card(tmp_path):
    """The builder and the presets put the scene on the card unless asked
    for the CPU; without a card that is torch's own error, no fallback."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    b = TBuilder()
    b.add_sphere((0, 0, 0), 1.0, b.add_metal_material((1, 1, 1)))
    with pytest.raises((AssertionError, RuntimeError)):
        b.build(build_bvh=False)
    with pytest.raises((AssertionError, RuntimeError)):
        tpresets.flagship_standin(n=2, height=8, data_dir=str(tmp_path))
    with pytest.raises((AssertionError, RuntimeError)):
        tpresets.shirley_spheres(height=8)
    scene = b.build(build_bvh=False, device="cpu")
    assert scene.device.type == "cpu"


def test_hit_search_records_no_graph(scenes):
    """Hit search is stop-gradient (pallas_find.py:538-541,788-792): on a
    scene whose fields carry gradients it builds no autograd graph."""
    _, tscene = scenes
    scene = tscene._replace(**{k: v.clone().requires_grad_(True) for k, v in
                               extract_params(tscene).items()})
    r = np.random.default_rng(0)
    org = torch.tensor(r.normal(0, 2, (256, 3)) + [0, 2, 6],
                       dtype=torch.float32, requires_grad=True)
    d = torch.nn.functional.normalize(torch.tensor(
        r.normal(size=(256, 3)), dtype=torch.float32), dim=1)
    tm = torch.zeros(256)
    for method in ("auto", "bruteforce"):
        prim, t = find_hit(scene, org, d, tm, method=method)
        assert (prim >= 0).any() and not t.requires_grad
    occ = find_occluded(scene, org, d, tm, torch.full((256,), 3.0e38))
    assert occ.any() and not occ.requires_grad
