"""The Cornell box of *Ray Tracing: The Next Week* on the port, on the CPU:
the preset against the benchmark's scene file, the winding that the find
kernels' back-face culling needs, the fused integrator at the book's depth
of 50 against the benchmark's plain reference, and the ``live_rays.deep``
counter of the bounces past 4."""

import dataclasses

import numpy as np
import pytest
import torch

from benchmark.reference import render as ref
from benchmark.reference import rng as ref_rng
from benchmark.scenes import cornell_box as scene_file
from sexy_raytracer_tpu_torch.models import presets
from sexy_raytracer_tpu_torch.models.scene import MAT_LIGHT, SceneBuilder
from sexy_raytracer_tpu_torch.render import integrator
from sexy_raytracer_tpu_torch.render.renderer import render_accumulate
from sexy_raytracer_tpu_torch.utils import profiling

# the book's boxes: (size, rotate_y degrees, translation)
BOXES = [((165, 330, 165), 15.0, (265, 0, 295)),
         ((165, 165, 165), -18.0, (130, 0, 65))]


def _air(p):
    """Whether the points ``p`` [N, 3] lie in the room's open air: inside
    the walls and in neither box (the box tested in its own frame, the
    book's ``rotate_y`` undone)."""
    air = ((p > 0.0) & (p < 555.0)).all(axis=1)
    for size, degrees, offset in BOXES:
        th = np.deg2rad(degrees)
        c, s = np.cos(th), np.sin(th)
        d = p - np.asarray(offset, np.float64)
        q = np.stack([c * d[:, 0] - s * d[:, 2], d[:, 1],
                      s * d[:, 0] + c * d[:, 2]], axis=1)
        air &= ~((q > 0.0) & (q < np.asarray(size, np.float64))).all(axis=1)
    return air


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def test_preset_is_the_benchmarks_scene():
    """The preset, field for field, is the benchmark's scene file replayed
    on the program's ``SceneBuilder``; the config is the book's view."""
    ours, cfg = presets.cornell_box(spp=3, height=20, device="cpu")
    theirs = scene_file.build({}, 0).replay(SceneBuilder()).build(
        build_bvh=False, device="cpu")
    for field in ours._fields:
        assert torch.equal(getattr(ours, field), getattr(theirs, field)), \
            field
    assert (ours.num_triangles, ours.num_spheres) == (36, 0)
    kinds = ours.mat_type[ours.tri_mat.long()]
    assert (kinds == MAT_LIGHT).sum() == 2
    assert (cfg.width, cfg.height, cfg.samples_per_pixel) == (20, 20, 3)
    assert (cfg.max_bounce, cfg.background) == (50, (0.0, 0.0, 0.0))
    cam = cfg.camera
    assert (cam.eye, cam.look_at, cam.vfov_degrees, cam.aperture) == (
        (278.0, 278.0, -800.0), (278.0, 278.0, 0.0), 40.0, 0.0)
    assert presets.cornell_box is presets.PORT_PRESETS["cornell_box"]
    assert "cornell_box" not in presets.PRESETS


def test_every_front_face_looks_where_rays_come_from():
    """The find kernels cull back faces, so a ray must meet each triangle
    from its front: half a unit in front of every triangle is the room's
    open air, and half a unit behind it a box's inside or the world
    outside the walls. Two exceptions, both as the book has them: behind
    the light, which hangs one unit under the ceiling facing down, is air;
    the boxes' bottoms stand on the floor, face down into it, and no ray
    meets them."""
    scene, _ = presets.cornell_box(device="cpu")
    v = [getattr(scene, f"tri_v{i}").numpy().astype(np.float64)
         for i in range(3)]
    n = np.cross(v[1] - v[0], v[2] - v[0])
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    centroid = (v[0] + v[1] + v[2]) / 3.0
    light = scene.mat_type[scene.tri_mat.long()].numpy() == MAT_LIGHT
    bottom = (np.abs(centroid[:, 1]) < 1e-9) & (n[:, 1] < 0)
    assert bottom.sum() == 4
    assert (_air(centroid + 0.5 * n) == ~bottom).all()
    assert (_air(centroid - 0.5 * n) == light).all()
    assert np.allclose(v[0][light][:, 1], 554.0) and (n[light][:, 1] < 0).all()


def _frame_against_reference(seed):
    """(port, reference) radiance of every pixel of a 24 x 24 frame at
    2 spp and 50 bounces, the wall colours and the light drawn from
    ``seed``: the port's fused integrator on the CPU against the
    benchmark's plain reference."""
    rs = np.random.default_rng(seed)
    params = {k: tuple(float(x) for x in rs.uniform(0.05, 0.95, 3))
              for k in ("red", "white", "green")}
    params["light"] = tuple(float(x) for x in rs.uniform(2.0, 30.0, 3))
    desc = scene_file.build(params, seed)
    scene = desc.replay(SceneBuilder()).build(build_bvh=False, device="cpu")
    _, cfg = presets.cornell_box(spp=2, height=24, device="cpu")
    cfg = dataclasses.replace(cfg, seed=seed % 2**32, samples_per_batch=2,
                              rays_per_chunk=24 * 24 * 2)
    got = render_accumulate(scene, cfg).reshape(-1, 3)
    sc = ref.scene_arrays(desc, "cpu")
    cam = ref.camera(dict(eye=cfg.camera.eye, look_at=cfg.camera.look_at,
                          up=cfg.camera.up, vfov_degrees=40.0, aperture=0.0,
                          focus_dist=10.0, time0=0.0, time1=1.0), 1.0, "cpu")
    want = ref.render_pixels(
        sc, sc["atlas"], cam, torch.arange(24 * 24),
        ref_rng.key(seed % 2**32), width=24, height=24, spb=2,
        max_bounce=50, background=cfg.background).numpy()
    return got, want


def _matches(got, want):
    """The tolerances of benchmark/tests/test_bench_reference.py: the fused
    kernels and the reference order the same float32 arithmetic
    differently, so a path that grazes an edge may take another branch (at
    most 1% of the pixels, each held to 1e-4), and the sums' gap bounds a
    bias to 1e-3 of the whole."""
    close = np.isclose(got, want, rtol=1e-4, atol=1e-4).all(axis=1)
    return (close.mean() >= 0.99
            and abs(got.sum() - want.sum()) <= 1e-3 * abs(want.sum()))


@pytest.mark.parametrize("seed", [3, 2**31 + 11, 90210])
def test_fused_integrator_matches_the_reference_at_depth_50(seed):
    got, want = _frame_against_reference(seed)
    # the room is lit: over 1% of the radiance lies outside the light's
    # own pixels
    rad = want.sum(axis=1)
    assert rad[rad < rad.max() / 4].sum() > 0.01 * rad.sum()
    assert _matches(got, want)


def test_comparison_sees_a_fault_past_the_second_bounce(monkeypatch):
    """The comparison above reads the deep bounces: the port with its
    bounce draws turned over (u -> 1 - u) from the third hit on, so that
    every path agrees with the reference through two bounces and goes
    elsewhere after, fails it."""
    draw = integrator.bounce_uniforms

    def turned(keys, max_bounce):
        u = draw(keys, max_bounce).clone()
        u[:, 2:] = 1.0 - u[:, 2:]
        return u

    monkeypatch.setattr(integrator, "bounce_uniforms", turned)
    assert not _matches(*_frame_against_reference(3))


def _counted_finds(monkeypatch):
    """(live lanes, rays) of each find the integrator makes, in order."""
    seen = []
    for name in ("find_hit", "find_occluded"):
        fn = getattr(integrator, name)

        def counted(*a, _fn=fn, **kw):
            seen.append((int((kw["t_min"] < 1e30).sum()), a[1].shape[0]))
            return _fn(*a, **kw)

        monkeypatch.setattr(integrator, name, counted)
    return seen


@pytest.mark.parametrize("preset,max_bounce", [("cornell_box", 7),
                                               ("flagship_standin", 6)])
def test_deep_counter_counts_the_bounces_past_4(preset, max_bounce,
                                                monkeypatch, tmp_path):
    """``live_rays.deep`` holds exactly the live lanes and the slots of
    the finds at bounce 4 and deeper: on the Cornell box every bounce is a
    closest-hit find; on the stand-in the last is the occlusion pass."""
    kw = dict(n=4) if preset == "flagship_standin" else {}
    scene, cfg = presets.PORT_PRESETS[preset](spp=2, height=8, device="cpu",
                                              **kw)
    cfg = dataclasses.replace(cfg, max_bounce=max_bounce, samples_per_batch=2,
                              rays_per_chunk=64, seed=5)
    seen = _counted_finds(monkeypatch)
    with profiling.trace(tmp_path):
        render_accumulate(scene, cfg)
    tallies = profiling.snapshot()["tallies"]
    deep = [s for i, s in enumerate(seen) if i % max_bounce >= 4]
    assert len(seen) % max_bounce == 0 and deep
    assert tallies["live_rays.deep"] == [sum(n for n, _ in deep),
                                         sum(r for _, r in deep)]
    assert tallies["live_rays"] == [sum(n for n, _ in seen),
                                    sum(r for _, r in seen)]
    assert 0 < tallies["live_rays.deep"][0] < tallies["live_rays.deep"][1]


def test_deep_counter_is_silent_at_depth_4(tmp_path):
    scene, cfg = presets.cornell_box(spp=2, height=8, device="cpu")
    cfg = dataclasses.replace(cfg, max_bounce=4, samples_per_batch=2,
                              rays_per_chunk=64, seed=5)
    with profiling.trace(tmp_path):
        render_accumulate(scene, cfg)
    tallies = profiling.snapshot()["tallies"]
    assert tallies["live_rays"][0] > 0 and "live_rays.deep" not in tallies
