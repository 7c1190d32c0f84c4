"""The port's preset registry against the JAX package's: the LCG's draws,
``shirley_parity``'s field bit for bit, ``PRESETS``'s keys, and the glTF
presets on asset files written here (and raising without them, as the
JAX package's do)."""

import dataclasses
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from sexy_raytracer_tpu.models import presets as jpresets  # noqa: E402
from sexy_raytracer_tpu_torch.models import presets as tpresets  # noqa: E402
from sexy_raytracer_tpu_torch.models.scene import (  # noqa: E402
    MAT_DIELECTRIC,
    MAT_METAL,
    SceneData,
)
from sexy_raytracer_tpu_torch.utils import png as tpng  # noqa: E402
from test_torch_gltf import _Doc, _images, _png_bytes  # noqa: E402

GLTF_PRESETS = ("cube", "square", "scene", "masterchief", "masterchief_glb")


def _assert_same_scene(tscene, jscene):
    jscene = jax.device_get(jscene)
    for name in SceneData._fields:
        want = np.asarray(getattr(jscene, name))
        got = getattr(tscene, name)
        assert got.device.type == "cpu"
        got = got.numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)


def _assert_same_config(tcfg, jcfg):
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)


@pytest.mark.parametrize("seed", [0, 42, 2**63 + 5, -3])
def test_lcg_stream_bits(seed):
    jn, tn = jpresets._lcg_stream(seed), tpresets._lcg_stream(seed)
    got = np.array([tn() for _ in range(4096)])
    want = np.array([jn() for _ in range(4096)])
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert 0.0 <= got.min() and got.max() < 1.0


@pytest.mark.parametrize("seed,height,spp", [(42, 240, 64), (7, 18, 2),
                                             (12345, 720, 8)])
def test_shirley_parity_matches_jax(seed, height, spp):
    tscene, tcfg = tpresets.shirley_parity(seed=seed, spp=spp, height=height,
                                           device="cpu")
    jscene, jcfg = jpresets.shirley_parity(seed=seed, spp=spp, height=height)
    _assert_same_scene(tscene, jscene)
    _assert_same_config(tcfg, jcfg)
    # the field's kinds: glass, fuzzy metal and moving diffuse spheres
    s = tscene.numpy()
    kind = s.mat_type[s.sph_mat]
    assert tscene.num_triangles == 0 and tscene.num_spheres <= 488
    assert (kind == MAT_DIELECTRIC).sum() >= 2
    assert ((kind == MAT_METAL) & (s.mat_fuzz[s.sph_mat] > 0)).any()
    assert (s.sph_c1 != s.sph_c0).any(axis=1).sum() > 100


def test_registry_keys_match_jax():
    assert list(tpresets.PRESETS) == list(jpresets.PRESETS)
    assert "flagship_standin" not in tpresets.PRESETS
    for name, fn in tpresets.PRESETS.items():
        assert fn.__name__ == jpresets.PRESETS[name].__name__


@pytest.mark.parametrize("name", GLTF_PRESETS)
def test_gltf_presets_raise_without_asset(name, tmp_path):
    with pytest.raises(FileNotFoundError) as jerr:
        jpresets.PRESETS[name](data_dir=str(tmp_path))
    with pytest.raises(FileNotFoundError) as terr:
        tpresets.PRESETS[name](data_dir=str(tmp_path), device="cpu")
    assert type(terr.value) is type(jerr.value)
    assert terr.value.filename == jerr.value.filename


@pytest.fixture(scope="module")
def asset_dir(tmp_path_factory):
    """Small stand-ins for the five glTF assets, under their names."""
    d = tmp_path_factory.mktemp("assets")
    doc = _Doc()
    albedo, normal = _images(5)
    base = doc.image(data=_png_bytes(d, albedo, "a.png"))
    nrm = doc.image(data=_png_bytes(d, normal, "n.png"))
    mat = doc.material(base=base, normal=nrm, roughnessFactor=0.4)
    doc.mesh([doc.cube_primitive(material=mat),
              doc.cube_primitive(np.uint32, offset=np.float32([0, 2, 0]))])
    doc.doc["nodes"] = [{"children": [1], "translation": [0.0, 0.5, 0.0]},
                        {"mesh": 0, "scale": [0.5, 0.5, 0.5]}]
    doc.doc["scenes"] = [{"nodes": [0]}]
    for name in ("cube.gltf", "square.gltf", "scene.gltf",
                 "masterchief2-separate-xf.gltf"):
        (d / name).write_bytes(doc.embedded())
    (d / "halo.glb").write_bytes(doc.glb())
    # an iron texture present, the other three missing (the sentinel)
    shutil.copy(d / "a.png", d / "rustediron2_basecolor-2x1.png")
    return str(d)


@pytest.mark.parametrize("name", GLTF_PRESETS + ("rustediron",))
def test_gltf_presets_match_jax(name, asset_dir):
    tscene, tcfg = tpresets.PRESETS[name](data_dir=asset_dir, spp=4,
                                          height=36, device="cpu")
    jscene, jcfg = jpresets.PRESETS[name](data_dir=asset_dir, spp=4,
                                          height=36)
    _assert_same_scene(tscene, jscene)
    _assert_same_config(tcfg, jcfg)
    if name != "rustediron":
        assert tscene.num_triangles == 24


def test_presets_default_to_the_card():
    """Without ``device`` a preset builds on the card; here, with no card,
    torch refuses rather than falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises((AssertionError, RuntimeError)):
        tpresets.shirley_parity(height=18, spp=1)


def test_asset_png_reads_back(asset_dir):
    img = tpng.read_png(f"{asset_dir}/rustediron2_basecolor-2x1.png", 3)
    assert img.shape == (16, 16, 3)
