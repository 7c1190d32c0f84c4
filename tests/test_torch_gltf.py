"""The port's glTF/GLB loader (``models/gltf.py``) against the JAX
package's: the same files, written here into ``tmp_path``, must build the
same scene, field by field (vertices within atol 1e-6, every other field
exact). The mirrors of ``tests/test_gltf.py``'s asset tests skip through
the ``data_dir`` fixture where the reference assets are absent."""

import base64
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from sexy_raytracer_tpu.models import gltf as jgltf  # noqa: E402
from sexy_raytracer_tpu.models.scene import SceneBuilder as JBuilder  # noqa: E402
from sexy_raytracer_tpu_torch.models import gltf as tgltf  # noqa: E402
from sexy_raytracer_tpu_torch.models import presets as tpresets  # noqa: E402
from sexy_raytracer_tpu_torch.models.scene import (  # noqa: E402
    MISSING_TEXTURE_COLOR,
    TEX_IMAGE,
    TEX_SOLID,
    SceneBuilder as TBuilder,
    SceneData,
)
from sexy_raytracer_tpu_torch.tools.gltf_doc import GltfDoc  # noqa: E402
from sexy_raytracer_tpu_torch.utils import png as tpng  # noqa: E402

VERTEX_FIELDS = ("tri_v0", "tri_v1", "tri_v2")

# a unit cube: 8 corners, 12 triangles, uvs from x and y
CUBE_POS = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1)
                     for z in (-1, 1)], np.float32)
CUBE_UV = ((CUBE_POS[:, :2] + 1.0) / 2.0).astype(np.float32)
CUBE_IDX = np.array([
    0, 1, 3, 0, 3, 2, 4, 6, 7, 4, 7, 5, 0, 4, 5, 0, 5, 1,
    2, 3, 7, 2, 7, 6, 0, 2, 6, 0, 6, 4, 1, 5, 7, 1, 7, 3], np.uint32)


def _png_bytes(tmp_path, img, name):
    path = tmp_path / name
    tpng.write_png(str(path), img)
    return path.read_bytes()


def _images(seed):
    """A 16x16 base colour and an 8x4 normal map: two image sizes, so the
    atlas resamples one of them."""
    r = np.random.default_rng(seed)
    return (r.integers(0, 256, (16, 16, 3)).astype(np.uint8),
            r.integers(100, 256, (4, 8, 3)).astype(np.uint8))


class _Doc(GltfDoc):
    """A glTF document under construction, with one binary buffer, and
    the unit cube's primitives."""

    def cube_primitive(self, index_type=np.uint16, interleaved=False,
                       material=None, offset=np.zeros(3, np.float32)):
        pos = CUBE_POS + offset
        if not interleaved:
            return self.primitive(pos, CUBE_UV, CUBE_IDX, material,
                                  index_type)
        # one view, POSITION and TEXCOORD_0 interleaved at a 20-byte
        # stride, the uvs at an accessor byteOffset of 12
        rows = np.concatenate([pos, CUBE_UV], axis=1).astype(np.float32)
        v = self.view(rows.tobytes(), stride=20)
        p = self.accessor(v, 5126, 8, "VEC3")
        t = self.accessor(v, 5126, 8, "VEC2", offset=12)
        ctype = 5123 if index_type == np.uint16 else 5125
        i = self.accessor(self.view(CUBE_IDX.astype(index_type).tobytes()),
                          ctype, CUBE_IDX.size, "SCALAR")
        prim = {"attributes": {"POSITION": p, "TEXCOORD_0": t},
                "indices": i}
        if material is not None:
            prim["material"] = material
        return prim


def _load_both(path, **kw):
    """Load ``path`` with both packages -> (port scene on the CPU, JAX
    numpy scene, the two triangle counts)."""
    jb, tb = JBuilder(), TBuilder()
    nj = jgltf.load_gltf(str(path), jb, **kw)
    nt = tgltf.load_gltf(str(path), tb, **kw)
    return tb.build(device="cpu"), jb.build(device=False), nt, nj


def _assert_same_scene(tscene, jscene):
    jfields = jscene._asdict()
    assert list(jfields) == list(SceneData._fields)
    for name in SceneData._fields:
        want = np.asarray(jfields[name])
        got = getattr(tscene, name)
        assert got.device.type == "cpu"
        got = got.numpy()
        assert got.dtype == want.dtype, name
        assert got.shape == want.shape, name
        if name in VERTEX_FIELDS:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(got, want, err_msg=name)


def _textured_cube_doc(tmp_path, **prim_kw):
    d = _Doc()
    albedo, normal = _images(0)
    base = d.image(uri="data:image/png;base64," + base64.b64encode(
        _png_bytes(tmp_path, albedo, "a.png")).decode())
    nrm = d.image(uri="data:image/png;base64," + base64.b64encode(
        _png_bytes(tmp_path, normal, "n.png")).decode())
    mat = d.material(base=base, normal=nrm,
                     baseColorFactor=[0.8, 0.7, 0.6, 1.0],
                     metallicFactor=0.25, roughnessFactor=0.4)
    d.mesh([d.cube_primitive(material=mat, **prim_kw)])
    d.doc["nodes"] = [{"mesh": 0}]
    d.doc["scenes"] = [{"nodes": [0]}]
    return d


def test_embedded_cube_uint16(tmp_path):
    p = tmp_path / "cube.gltf"
    p.write_bytes(_textured_cube_doc(tmp_path).embedded())
    tscene, jscene, nt, nj = _load_both(p)
    assert nt == nj == 12
    _assert_same_scene(tscene, jscene)
    # both images are in the atlas, the material samples them
    assert int((tscene.tex_type == TEX_IMAGE).sum()) == 2
    assert int(tscene.mat_albedo_tex[0]) >= 0
    assert int(tscene.mat_normal_tex[0]) >= 0


def test_embedded_cube_uint32_interleaved(tmp_path):
    d = _textured_cube_doc(tmp_path, index_type=np.uint32, interleaved=True)
    p = tmp_path / "cube32.gltf"
    p.write_bytes(d.embedded())
    tscene, jscene, nt, nj = _load_both(p)
    assert nt == nj == 12
    _assert_same_scene(tscene, jscene)
    # the strided read found the uvs, not the positions' bytes
    uv = tscene.tri_uv0.numpy()
    assert uv.min() >= 0.0 and uv.max() <= 1.0 and uv.std() > 0.1


def test_glb_with_buffer_view_images(tmp_path):
    d = _Doc()
    albedo, normal = _images(1)
    base = d.image(data=_png_bytes(tmp_path, albedo, "a.png"))
    nrm = d.image(data=_png_bytes(tmp_path, normal, "n.png"))
    mat = d.material(base=base, normal=nrm, mr=base)
    d.mesh([d.cube_primitive(np.uint32, material=mat)])
    d.doc["nodes"] = [{"mesh": 0, "translation": [0.5, 1.0, -2.0]}]
    d.doc["scenes"] = [{"nodes": [0]}]
    p = tmp_path / "cube.glb"
    p.write_bytes(d.glb())
    tscene, jscene, nt, nj = _load_both(p)
    assert nt == nj == 12
    _assert_same_scene(tscene, jscene)
    assert int(tscene.mat_mr_tex[0]) == int(tscene.mat_albedo_tex[0])
    np.testing.assert_allclose(
        tscene.tri_v0.numpy().min(axis=0), [-0.5, 0.0, -3.0], atol=1e-6)


def test_node_hierarchy_matrix_and_trs(tmp_path):
    """A TRS root (rotation, scale, translation) over a matrix child, a
    second mesh under its own node, a primitive with no material (the
    default one, made once), a non-triangle primitive (skipped), and a
    root_transform on top; several meshes, each with its own primitives."""
    d = _Doc()
    m_a = d.mesh([d.cube_primitive(),
                  d.cube_primitive(np.uint32, offset=np.float32([3, 0, 0]))])
    points = d.cube_primitive()
    points["mode"] = 0
    m_b = d.mesh([d.cube_primitive(np.uint32, interleaved=True), points])
    m_c = d.mesh([d.cube_primitive(material=d.material(
        baseColorFactor=[0.2, 0.4, 0.6, 1.0], metallicFactor=1.0))])
    q = np.array([0.1, 0.7, -0.2, 0.5])
    q = (q / np.linalg.norm(q)).tolist()
    child = np.array([[0.5, 0, 0, 0], [0, 1.5, 0, 0], [0, 0, 1, 0],
                      [1, 2, 3, 1]], np.float64)  # column-major: translate
    d.doc["nodes"] = [
        {"children": [1, 2], "translation": [1.0, -2.0, 0.5], "rotation": q,
         "scale": [2.0, 0.5, 1.5]},
        {"mesh": m_a, "matrix": child.ravel().tolist()},
        {"mesh": m_b, "rotation": [0.0, 0.0, 0.38268343, 0.92387953]},
        {"mesh": m_c, "scale": [0.25, 0.25, 0.25]},
    ]
    d.doc["scenes"] = [{"nodes": [0, 3]}]
    p = tmp_path / "tree.gltf"
    p.write_bytes(d.embedded())
    root = tpresets._branch_transform()
    for kw in ({}, {"root_transform": root}, {"apply_transforms": False}):
        tscene, jscene, nt, nj = _load_both(p, **kw)
        assert nt == nj == 48
        _assert_same_scene(tscene, jscene)
    # the transforms moved the geometry: the child's matrix, then the root
    tscene, _, _, _ = _load_both(p)
    assert float(tscene.tri_v0.numpy().max()) > 2.0


def test_missing_and_unreadable_images(tmp_path):
    """An image file that does not exist and embedded bytes that are not
    a PNG both become the magenta sentinel, in both packages."""
    d = _Doc()
    gone = d.image(uri="no_such_albedo.png")
    junk = d.image(data=b"\x89PNG\r\n\x1a\nnot really a png")
    mat = d.material(base=gone, normal=junk)
    d.mesh([d.cube_primitive(material=mat)])
    d.doc["nodes"] = [{"mesh": 0}]
    p = tmp_path / "missing.gltf"
    p.write_bytes(d.embedded())
    tscene, jscene, _, _ = _load_both(p)
    _assert_same_scene(tscene, jscene)
    for tex in (int(tscene.mat_albedo_tex[0]), int(tscene.mat_normal_tex[0])):
        assert int(tscene.tex_type[tex]) == TEX_SOLID
        np.testing.assert_array_equal(tscene.tex_color0[tex].numpy(),
                                      np.float32(MISSING_TEXTURE_COLOR))


def test_relative_uri_buffer_and_image(tmp_path):
    """A buffer and an image referenced by URIs relative to the file."""
    d = _textured_cube_doc(tmp_path)
    sub = tmp_path / "assets"
    sub.mkdir()
    albedo, _ = _images(2)
    (sub / "albedo.png").write_bytes(_png_bytes(tmp_path, albedo, "b.png"))
    (sub / "cube.bin").write_bytes(bytes(d.blob))
    d.doc["images"][0] = {"uri": "albedo.png"}
    doc = dict(d.doc)
    doc["buffers"] = [{"uri": "cube.bin", "byteLength": len(d.blob)}]
    p = sub / "cube.gltf"
    p.write_text(json.dumps(doc))
    tscene, jscene, _, _ = _load_both(p)
    _assert_same_scene(tscene, jscene)
    assert int((tscene.tex_type == TEX_IMAGE).sum()) == 2


def test_decode_png_fallback_matches_pillow(tmp_path):
    """The pure-Python decoder (used where Pillow is absent) reads the
    bytes as Pillow does."""
    albedo, normal = _images(3)
    for img in (albedo, normal):
        data = _png_bytes(tmp_path, img, "x.png")
        np.testing.assert_array_equal(tpng._decode_png_pure(data, 3), img)
        np.testing.assert_array_equal(tpng.decode_png(data, 3), img)


def test_node_transform_applied(tmp_path):
    """tests/test_gltf.py::test_node_transform_applied on the port."""
    positions = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    idx = np.array([0, 1, 2], np.uint16)
    blob = positions.tobytes() + idx.tobytes()
    doc = {
        "asset": {"version": "2.0"},
        "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0, "translation": [5, 0, 0]}],
        "meshes": [{"primitives": [{"attributes": {"POSITION": 0},
                                    "indices": 1}]}],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": 3,
             "type": "VEC3"},
            {"bufferView": 1, "componentType": 5123, "count": 3,
             "type": "SCALAR"},
        ],
        "bufferViews": [
            {"buffer": 0, "byteOffset": 0, "byteLength": 36},
            {"buffer": 0, "byteOffset": 36, "byteLength": 6},
        ],
        "buffers": [{"uri": "data:application/octet-stream;base64,"
                     + base64.b64encode(blob).decode(),
                     "byteLength": len(blob)}],
    }
    p = tmp_path / "t.gltf"
    p.write_text(json.dumps(doc))
    b = TBuilder()
    tgltf.load_gltf(str(p), b)
    scene = b.build(build_bvh=False, device="cpu")
    np.testing.assert_allclose(scene.tri_v0[0].numpy(), [5, 0, 0], atol=1e-6)


# -- mirrors of tests/test_gltf.py's asset tests, on the port -------------

def test_cube_embedded_base64(data_dir):
    b = TBuilder()
    n = tgltf.load_gltf(os.path.join(data_dir, "cube.gltf"), b)
    scene = b.build(build_bvh=False, device="cpu").numpy()
    assert n == 12
    assert scene.num_triangles == 12
    np.testing.assert_allclose(scene.mat_base_color[0][:3], [0.8, 0.8, 0.8],
                               atol=1e-6)
    assert scene.mat_metallic[0] == 0.0
    np.testing.assert_allclose(scene.mat_roughness[0], 0.4, atol=1e-6)
    allv = np.concatenate([scene.tri_v0, scene.tri_v1, scene.tri_v2])
    np.testing.assert_allclose(allv.min(axis=0), [-1, -1, -1], atol=1e-5)
    np.testing.assert_allclose(allv.max(axis=0), [1, 1, 1], atol=1e-5)


def test_masterchief_counts(data_dir):
    b = TBuilder()
    n = tgltf.load_gltf(
        os.path.join(data_dir, "masterchief2-separate-xf.gltf"), b)
    scene = b.build(build_bvh=False, device="cpu").numpy()
    assert n == 3042
    assert scene.num_triangles == 3042
    assert scene.num_materials == 2
    assert (scene.mat_albedo_tex >= 0).all()
    assert (scene.mat_normal_tex >= 0).all()
    assert scene.atlas.shape[1:] == (512, 512, 3)
    assert scene.atlas.max() > 1.0


def test_scene_gltf_uint32_indices(data_dir):
    b = TBuilder()
    n = tgltf.load_gltf(os.path.join(data_dir, "scene.gltf"), b)
    assert n > 0
    scene = b.build(build_bvh=False, device="cpu")
    g = tgltf.GLTFFile.parse(os.path.join(data_dir, "scene.gltf"))
    total = sum(g.doc["accessors"][p["indices"]]["count"] // 3
                for m in g.doc["meshes"] for p in m["primitives"])
    assert scene.num_triangles == total


def test_glb_container(data_dir):
    path = os.path.join(data_dir, "masterchief.glb")
    if not os.path.exists(path):
        pytest.skip("no glb asset")
    assert tgltf.load_gltf(path, TBuilder()) > 0


def _tri_centroids(builder):
    out = []
    for pos, uv, idx, mat in builder._tri_v:
        out.append((pos[idx[:, 0]] + pos[idx[:, 1]] + pos[idx[:, 2]]) / 3.0)
    return np.concatenate(out)


def test_halo_glb_node_transforms_match_flagship(data_dir):
    path = os.path.join(data_dir, "halo.glb")
    if not os.path.exists(path):
        pytest.skip("no halo.glb asset")
    b_glb = TBuilder()
    tgltf.load_gltf(path, b_glb, root_transform=tpresets.CHIEF_GLB_BAKE)
    b_ref = TBuilder()
    tgltf.load_gltf(
        os.path.join(data_dir, "masterchief2-separate-xf.gltf"), b_ref)
    c_glb, c_ref = _tri_centroids(b_glb), _tri_centroids(b_ref)
    assert c_glb.shape == c_ref.shape == (3042, 3)
    np.testing.assert_allclose(c_glb, c_ref, atol=1e-4)
    b_raw = TBuilder()
    tgltf.load_gltf(path, b_raw, apply_transforms=False,
                    root_transform=tpresets.CHIEF_GLB_BAKE)
    assert np.abs(_tri_centroids(b_raw) - c_ref).max() > 0.05


def test_masterchief_glb_preset_renders_like_gltf(data_dir):
    from sexy_raytracer_tpu_torch.render.renderer import render_accumulate

    scene_a, cfg = tpresets.masterchief(data_dir=data_dir, height=60, spp=8,
                                        device="cpu")
    scene_b, _ = tpresets.masterchief_glb(data_dir=data_dir, height=60,
                                          spp=8, device="cpu")
    assert scene_a.num_triangles == scene_b.num_triangles == 3042
    assert scene_a.num_materials == scene_b.num_materials
    ra = render_accumulate(scene_a, cfg, method="bruteforce")
    rb = render_accumulate(scene_b, cfg, method="bruteforce")
    ra = np.sqrt(np.clip(ra / cfg.samples_per_pixel, 0, None))
    rb = np.sqrt(np.clip(rb / cfg.samples_per_pixel, 0, None))
    assert np.abs(ra - rb).mean() < 2e-3
    assert (np.abs(ra - rb) > 0.05).mean() < 0.01


def test_square_and_scene_presets_build(data_dir):
    sq, _ = tpresets.square(data_dir=data_dir, height=60, spp=4,
                            device="cpu")
    assert sq.num_triangles == 2
    assert sq.num_spheres == 4
    sc, _ = tpresets.scene_gltf(data_dir=data_dir, height=60, spp=4,
                                device="cpu")
    assert sc.num_triangles == 5614
    assert sc.num_spheres == 4


def test_accessor_strides(data_dir):
    g = tgltf.GLTFFile.parse(
        os.path.join(data_dir, "masterchief2-separate-xf.gltf"))
    a = g.doc["accessors"][0]
    pos = g.accessor(0)
    assert pos.shape == (a["count"], 3)
    assert np.isfinite(pos).all()
    if "min" in a:
        np.testing.assert_allclose(pos.min(axis=0), a["min"], rtol=1e-5)
        np.testing.assert_allclose(pos.max(axis=0), a["max"], rtol=1e-5)
