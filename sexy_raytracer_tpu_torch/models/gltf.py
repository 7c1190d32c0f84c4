"""Pure-Python glTF 2.0 / GLB loader onto the port's ``SceneBuilder``
(counterpart of ``sexy_raytracer_tpu/models/gltf.py``, host-side numpy).

It behaves as the JAX package's loader does, and departs from the
reference's cgltf path (reference model.h:301-460) in the same ways:

  * honors ``accessor.byteOffset`` and ``bufferView.byteStride`` (the
    reference reads raw pointers at ``bufferView->offset`` only,
    model.h:343,359,448);
  * supports uint16 *and* uint32 indices (the reference hardcodes uint16,
    model.h:448);
  * indexes the *current* primitive's mesh rather than
    ``meshes[primIndex]`` (model.h:345,361,450);
  * applies node transforms (matrix or TRS, with children; the reference
    ignores them);
  * resolves URIs relative to the glTF file, reads embedded base64 data,
    and parses GLB containers.

Material mapping matches the reference glTF path (model.h:369-437):
baseColor/normal/metallicRoughness textures + baseColor/metallic/roughness
factors build a PBR material; the combined metallic-roughness map is
recorded but never sampled (material.h:190-200). Images are decoded by the
port's ``utils/png.py``; a missing or unreadable image becomes the magenta
sentinel (texture.h:131).
"""

from __future__ import annotations

import base64
import json
import os
import struct
from typing import Optional

import numpy as np

from sexy_raytracer_tpu_torch.models.scene import TEX_NONE, SceneBuilder
from sexy_raytracer_tpu_torch.utils.png import decode_png, read_png

_COMPONENT_DTYPES = {
    5120: np.int8,
    5121: np.uint8,
    5122: np.int16,
    5123: np.uint16,
    5125: np.uint32,
    5126: np.float32,
}
_TYPE_COUNTS = {
    "SCALAR": 1,
    "VEC2": 2,
    "VEC3": 3,
    "VEC4": 4,
    "MAT2": 4,
    "MAT3": 9,
    "MAT4": 16,
}


class GLTFFile:
    """Parsed glTF/GLB document with loaded binary buffers."""

    def __init__(self, doc: dict, buffers: list, base_dir: str):
        self.doc = doc
        self.buffers = buffers
        self.base_dir = base_dir

    @staticmethod
    def parse(path: str) -> "GLTFFile":
        base_dir = os.path.dirname(os.path.abspath(path))
        with open(path, "rb") as f:
            raw = f.read()
        if raw[:4] == b"glTF":
            doc, bin_chunk = _parse_glb(raw)
        else:
            doc = json.loads(raw.decode("utf-8"))
            bin_chunk = None
        buffers = []
        for buf in doc.get("buffers", []):
            uri = buf.get("uri")
            if uri is None:
                buffers.append(bin_chunk if bin_chunk is not None else b"")
            elif uri.startswith("data:"):
                b64 = uri.split(",", 1)[1]
                buffers.append(base64.b64decode(b64))
            else:
                with open(os.path.join(base_dir, uri), "rb") as f:
                    buffers.append(f.read())
        return GLTFFile(doc, buffers, base_dir)

    def accessor(self, index: int) -> np.ndarray:
        """Read accessor ``index`` -> ``[count, components]`` numpy array."""
        a = self.doc["accessors"][index]
        count = a["count"]
        ncomp = _TYPE_COUNTS[a["type"]]
        dtype = np.dtype(_COMPONENT_DTYPES[a["componentType"]])
        if "bufferView" not in a:
            return np.zeros((count, ncomp), dtype)
        bv = self.doc["bufferViews"][a["bufferView"]]
        buf = self.buffers[bv.get("buffer", 0)]
        offset = bv.get("byteOffset", 0) + a.get("byteOffset", 0)
        stride = bv.get("byteStride", 0) or dtype.itemsize * ncomp
        elem_size = dtype.itemsize * ncomp
        if stride == elem_size:
            arr = np.frombuffer(buf, dtype, count * ncomp, offset)
            return arr.reshape(count, ncomp)
        out = np.empty((count, ncomp), dtype)
        for i in range(count):
            out[i] = np.frombuffer(buf, dtype, ncomp, offset + i * stride)
        return out

    def image_pixels(self, image_index: int) -> Optional[np.ndarray]:
        """Decode an image to uint8 [H,W,3]; None if missing/unreadable."""
        img = self.doc["images"][image_index]
        uri = img.get("uri")
        if uri is not None:
            if uri.startswith("data:"):
                data = base64.b64decode(uri.split(",", 1)[1])
                return _decode_png_bytes(data)
            return read_png(os.path.join(self.base_dir, uri), channels=3)
        if "bufferView" in img:
            bv = self.doc["bufferViews"][img["bufferView"]]
            buf = self.buffers[bv.get("buffer", 0)]
            off = bv.get("byteOffset", 0)
            data = bytes(buf[off : off + bv["byteLength"]])
            return _decode_png_bytes(data)
        return None


def _decode_png_bytes(data: bytes) -> Optional[np.ndarray]:
    try:
        return decode_png(data, channels=3)
    except Exception:
        return None


def _parse_glb(raw: bytes):
    magic, version, _length = struct.unpack_from("<III", raw, 0)
    assert magic == 0x46546C67, "not a GLB file"
    pos = 12
    doc, bin_chunk = None, None
    while pos + 8 <= len(raw):
        chunk_len, chunk_type = struct.unpack_from("<II", raw, pos)
        body = raw[pos + 8 : pos + 8 + chunk_len]
        if chunk_type == 0x4E4F534A:  # 'JSON'
            doc = json.loads(body.decode("utf-8"))
        elif chunk_type == 0x004E4942:  # 'BIN\0'
            bin_chunk = body
        pos += 8 + chunk_len  # chunk lengths are 4-byte aligned by spec
    if doc is None:
        raise ValueError("GLB missing JSON chunk")
    return doc, bin_chunk


def _node_transforms(doc: dict):
    """World matrix per node, walking scene graphs (fixing model.h's
    ignored-transforms gap)."""
    nodes = doc.get("nodes", [])
    world = [np.eye(4, dtype=np.float64) for _ in nodes]

    def local_matrix(node):
        if "matrix" in node:
            return np.asarray(node["matrix"], np.float64).reshape(4, 4).T
        m = np.eye(4)
        t = node.get("translation", [0, 0, 0])
        q = node.get("rotation", [0, 0, 0, 1])  # x, y, z, w
        s = node.get("scale", [1, 1, 1])
        x, y, z, w = q
        rot = np.array(
            [
                [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
            ]
        )
        m[:3, :3] = rot * np.asarray(s)[None, :]
        m[:3, 3] = t
        return m

    scenes = doc.get("scenes", [])
    roots = []
    for sc in scenes:
        roots.extend(sc.get("nodes", []))
    if not roots:
        roots = list(range(len(nodes)))

    def visit(idx, parent):
        world[idx] = parent @ local_matrix(nodes[idx])
        for ch in nodes[idx].get("children", []):
            visit(ch, world[idx])

    for r in roots:
        visit(r, np.eye(4))
    return world


def load_gltf(
    path: str,
    builder: SceneBuilder,
    apply_transforms: bool = True,
    root_transform: Optional[np.ndarray] = None,
) -> int:
    """Load a glTF/GLB file into ``builder``; returns triangle count added.

    One builder mesh per glTF primitive (reference model.h:324-329).
    """
    g = GLTFFile.parse(path)
    doc = g.doc

    # materials: build once per glTF material index
    image_cache: dict = {}

    def image_tex(tex_index: Optional[int]) -> int:
        if tex_index is None:
            return TEX_NONE
        tex = doc["textures"][tex_index]
        src = tex.get("source")
        if src is None:
            return TEX_NONE
        if src not in image_cache:
            image_cache[src] = builder.add_image_texture(g.image_pixels(src))
        return image_cache[src]

    mat_ids = []
    for gmat in doc.get("materials", []):
        pbr = gmat.get("pbrMetallicRoughness", {})
        base_tex = pbr.get("baseColorTexture", {}).get("index")
        mr_tex = pbr.get("metallicRoughnessTexture", {}).get("index")
        normal_tex = gmat.get("normalTexture", {}).get("index")
        mat_ids.append(
            builder.add_pbr_material(
                albedo_tex=image_tex(base_tex),
                normal_tex=image_tex(normal_tex),
                mr_tex=image_tex(mr_tex),
                base_color=tuple(pbr.get("baseColorFactor", [1.0, 1.0, 1.0, 1.0])),
                # Absent factors default to 0, NOT the glTF-spec 1.0: the
                # reference's vendored cgltf era zero-filled unset factors,
                # and the checked-in goldens confirm it — with roughness=1
                # the chief gains an untinted GGX specular lobe and renders
                # ~8-12/255 brighter/bluer than images/test-1kx240p.png,
                # while roughness=0 matches the golden's red channel to
                # 0.1/255 (see VALIDATION.md §4).
                metallic=float(pbr.get("metallicFactor", 0.0)),
                roughness=float(pbr.get("roughnessFactor", 0.0)),
            )
        )
    default_mat = None

    world = _node_transforms(doc) if apply_transforms else None
    mesh_to_world = {}
    if world is not None:
        for ni, node in enumerate(doc.get("nodes", [])):
            if "mesh" in node:
                # last node wins if a mesh is instanced multiple times;
                # true multi-instancing would duplicate geometry here.
                mesh_to_world[node["mesh"]] = world[ni]

    tri_count = 0
    for mesh_index, gmesh in enumerate(doc.get("meshes", [])):
        xform = mesh_to_world.get(mesh_index) if world is not None else None
        for prim in gmesh.get("primitives", []):
            if prim.get("mode", 4) != 4:  # TRIANGLES only, like model.h:442
                continue
            attrs = prim.get("attributes", {})
            if "POSITION" not in attrs:
                continue
            positions = g.accessor(attrs["POSITION"]).astype(np.float32)
            if xform is not None:
                positions = (
                    positions @ xform[:3, :3].T + xform[:3, 3][None, :]
                ).astype(np.float32)
            if root_transform is not None:
                rt = np.asarray(root_transform, np.float64)
                positions = (
                    positions @ rt[:3, :3].T + rt[:3, 3][None, :]
                ).astype(np.float32)
            texcoords = None
            if "TEXCOORD_0" in attrs:
                texcoords = g.accessor(attrs["TEXCOORD_0"]).astype(np.float32)
            if "indices" in prim:
                idx = g.accessor(prim["indices"]).reshape(-1)
            else:
                idx = np.arange(positions.shape[0], dtype=np.uint32)
            idx = idx[: (idx.shape[0] // 3) * 3].reshape(-1, 3).astype(np.int64)

            if prim.get("material") is not None:
                mat = mat_ids[prim["material"]]
            else:
                if default_mat is None:
                    default_mat = builder.add_pbr_material(
                        base_color=(1.0, 1.0, 1.0, 1.0), metallic=0.0, roughness=0.0
                    )
                mat = default_mat
            builder.add_mesh(positions, texcoords, idx, mat)
            tri_count += idx.shape[0]
    return tri_count
