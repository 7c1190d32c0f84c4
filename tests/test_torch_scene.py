"""The port's numpy scene builder must build exactly the JAX package's
scene, field by field, and ``scene_from_numpy`` must carry a JAX scene
across unchanged."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from sexy_raytracer_tpu.models import presets as jpresets  # noqa: E402
from sexy_raytracer_tpu.models.scene import SceneBuilder as JBuilder  # noqa: E402
from sexy_raytracer_tpu_torch.models import presets as tpresets  # noqa: E402
from sexy_raytracer_tpu_torch.models.scene import (  # noqa: E402
    SceneBuilder as TBuilder,
    SceneData,
    scene_from_numpy,
)


def _wavefront_scene(B):
    """The scene of tests/test_fused.py:22-40, for either builder."""
    b = B()
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
    return b


def _standin_builder(B, data_dir, n=15):
    b = B()
    tpresets.add_relief_mesh(b, n)
    (jpresets if B is JBuilder else tpresets)._add_ground_and_lights(b)
    (jpresets if B is JBuilder else tpresets)._add_iron_and_metal(b, data_dir)
    return b


def _assert_same_scene(tscene, jscene):
    """Every field, the BVH's included, bit for bit."""
    assert isinstance(tscene, SceneData)
    jfields = jscene._asdict()
    assert list(jfields) == list(SceneData._fields)
    for name in SceneData._fields:
        want = np.asarray(jfields[name])
        got = getattr(tscene, name)
        assert got.device.type == "cpu"
        got = got.numpy()
        assert got.dtype == want.dtype, name
        assert got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_wavefront_scene_matches():
    jscene = _wavefront_scene(JBuilder).build(build_bvh=False, device=False)
    tscene = _wavefront_scene(TBuilder).build(build_bvh=False, device="cpu")
    _assert_same_scene(tscene, jscene)


def test_standin_mesh_scene_matches(tmp_path):
    jscene = _standin_builder(JBuilder, str(tmp_path)).build(
        build_bvh=False, device=False)
    tscene = _standin_builder(TBuilder, str(tmp_path)).build(
        build_bvh=False, device="cpu")
    _assert_same_scene(tscene, jscene)
    assert tscene.num_triangles == 2 * 15 * 15
    assert tscene.cluster_min.shape[0] == 2   # two clusters of <= 256


def test_standin_faces_the_flagship_eye():
    b = TBuilder()
    tpresets.add_relief_mesh(b)
    scene = b.build(build_bvh=False, device="cpu")
    assert scene.num_triangles == tpresets.CHIEF_TRIANGLES
    centroid = (scene.tri_v0 + scene.tri_v1 + scene.tri_v2) / 3.0
    to_eye = torch.tensor([0.0, 3.0, 5.0]) - centroid
    assert bool(((scene.tri_n * to_eye).sum(dim=1) > 0).all())


def test_shirley_spheres_matches():
    jscene, jcfg = jpresets.shirley_spheres()
    tscene, tcfg = tpresets.shirley_spheres(device="cpu")
    _assert_same_scene(tscene, jscene)
    assert tscene.num_bvh_nodes == 2 * tscene.num_spheres - 1
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)


def test_rustediron_sentinels_match(tmp_path):
    jscene, jcfg = jpresets.rustediron_globe(data_dir=str(tmp_path))
    tscene, tcfg = tpresets.rustediron_globe(data_dir=str(tmp_path),
                                             device="cpu")
    _assert_same_scene(tscene, jscene)
    assert tscene.num_bvh_nodes == 2 * 4 - 1
    # every iron map is the magenta missing-file sentinel (presets.py:37-39)
    magenta = (tscene.tex_color0 == torch.tensor([1.0, 0.0, 1.0])).all(dim=1)
    assert int(magenta.sum()) == 4
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)


def test_scene_from_numpy_round_trip(tmp_path):
    jscene = _standin_builder(JBuilder, str(tmp_path)).build(
        build_bvh=False, device=False)
    tscene = scene_from_numpy(jscene, "cpu")
    _assert_same_scene(tscene, jscene)
    back = scene_from_numpy({k: v.numpy() for k, v in
                             tscene._asdict().items()}, "cpu")
    _assert_same_scene(back, jscene)
    # a device scene carried across through jax.device_get
    dev_scene = _wavefront_scene(JBuilder).build(build_bvh=False)
    _assert_same_scene(scene_from_numpy(jax.device_get(dev_scene), "cpu"),
                       jax.device_get(dev_scene))
    with pytest.raises(KeyError):
        scene_from_numpy({"tri_v0": np.zeros((0, 3), np.float32)}, "cpu")


def test_default_build_carries_the_jax_bvh(tmp_path):
    """``build()`` with its defaults builds the BVH as JAX's does
    (scene.py:729-730): the wavefront scene (numpy builder) and the
    stand-in at n = 16 (516 primitives: the native builder)."""
    from sexy_raytracer_tpu_torch.models import bvh as tbvh

    _assert_same_scene(_wavefront_scene(TBuilder).build(device="cpu"),
                       _wavefront_scene(JBuilder).build(device=False))
    jscene = _standin_builder(JBuilder, str(tmp_path), n=16).build(
        device=False)
    tscene = _standin_builder(TBuilder, str(tmp_path), n=16).build(
        device="cpu")
    assert tbvh.builder_for(tscene.num_triangles + tscene.num_spheres) \
        == "native"
    _assert_same_scene(tscene, jscene)
    # the stand-in preset keeps its own default: no tree unless asked
    bare, _ = tpresets.flagship_standin(n=8, height=8, data_dir=str(tmp_path),
                                        device="cpu")
    tree, _ = tpresets.flagship_standin(n=8, height=8, data_dir=str(tmp_path),
                                        device="cpu", build_bvh=True)
    assert bare.num_bvh_nodes == 0
    assert tree.num_bvh_nodes == 2 * (128 + 4) - 1
