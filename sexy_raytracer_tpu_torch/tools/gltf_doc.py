"""A glTF 2.0 document under construction, with one binary buffer: writes
the asset-free ``.gltf`` (embedded base64 buffer) and ``.glb`` files that
``models/gltf.py`` loads in the tests and in ``chip_smoke.py`` phase 10b.

    d = GltfDoc()
    tex = d.image(data=png_bytes)
    mat = d.material(base=tex, roughnessFactor=0.4)
    d.mesh([d.primitive(positions, uvs, indices, material=mat)])
    d.doc["nodes"] = [{"mesh": 0}]
    open("scene.glb", "wb").write(d.glb())
"""

from __future__ import annotations

import base64
import json
import struct

import numpy as np

FLOAT, UINT16, UINT32 = 5126, 5123, 5125


class GltfDoc:
    """Accessors, buffer views, images, textures, materials, meshes and
    nodes, in ``doc``; the buffer's bytes in ``blob``."""

    def __init__(self):
        self.blob = bytearray()
        self.doc = {"asset": {"version": "2.0"}, "accessors": [],
                    "bufferViews": [], "buffers": [], "images": [],
                    "textures": [], "materials": [], "meshes": [],
                    "nodes": []}

    def view(self, data: bytes, stride=None):
        """A buffer view over ``data``, 4-byte aligned -> its index."""
        while len(self.blob) % 4:
            self.blob.append(0)
        bv = {"buffer": 0, "byteOffset": len(self.blob),
              "byteLength": len(data)}
        if stride:
            bv["byteStride"] = stride
        self.blob += data
        self.doc["bufferViews"].append(bv)
        return len(self.doc["bufferViews"]) - 1

    def accessor(self, view, ctype, count, typ, offset=0):
        a = {"bufferView": view, "componentType": ctype, "count": count,
             "type": typ}
        if offset:
            a["byteOffset"] = offset
        self.doc["accessors"].append(a)
        return len(self.doc["accessors"]) - 1

    def image(self, uri=None, data=None):
        """An image (a URI, or PNG bytes in the buffer) and a texture of
        it -> the texture's index."""
        img = {"uri": uri} if uri is not None else {
            "bufferView": self.view(data), "mimeType": "image/png"}
        self.doc["images"].append(img)
        self.doc["textures"].append({"source": len(self.doc["images"]) - 1})
        return len(self.doc["textures"]) - 1

    def material(self, base=None, normal=None, mr=None, **factors):
        """A metallic-roughness material; ``factors`` are its
        ``pbrMetallicRoughness`` factors -> its index."""
        pbr = dict(factors)
        if base is not None:
            pbr["baseColorTexture"] = {"index": base}
        if mr is not None:
            pbr["metallicRoughnessTexture"] = {"index": mr}
        m = {"pbrMetallicRoughness": pbr}
        if normal is not None:
            m["normalTexture"] = {"index": normal}
        self.doc["materials"].append(m)
        return len(self.doc["materials"]) - 1

    def mesh(self, prims):
        self.doc["meshes"].append({"primitives": prims})
        return len(self.doc["meshes"]) - 1

    def primitive(self, positions, uvs, indices, material=None,
                  index_type=np.uint32):
        """A triangle primitive: float32 ``positions`` [V, 3] and ``uvs``
        [V, 2], ``indices`` stored as ``index_type``."""
        p = self.accessor(self.view(np.float32(positions).tobytes()), FLOAT,
                          len(positions), "VEC3")
        t = self.accessor(self.view(np.float32(uvs).tobytes()), FLOAT,
                          len(uvs), "VEC2")
        ctype = UINT16 if index_type == np.uint16 else UINT32
        i = self.accessor(
            self.view(np.asarray(indices).astype(index_type).tobytes()),
            ctype, np.asarray(indices).size, "SCALAR")
        prim = {"attributes": {"POSITION": p, "TEXCOORD_0": t},
                "indices": i}
        if material is not None:
            prim["material"] = material
        return prim

    def embedded(self):
        """The ``.gltf`` bytes, the buffer embedded as base64."""
        doc = dict(self.doc)
        doc["buffers"] = [{
            "uri": "data:application/octet-stream;base64,"
                   + base64.b64encode(bytes(self.blob)).decode(),
            "byteLength": len(self.blob)}]
        return json.dumps(doc).encode()

    def glb(self):
        """The ``.glb`` bytes: the JSON chunk, then the buffer's."""
        doc = dict(self.doc)
        doc["buffers"] = [{"byteLength": len(self.blob)}]
        js = json.dumps(doc).encode()
        js += b" " * (-len(js) % 4)
        bin_ = bytes(self.blob) + b"\0" * (-len(self.blob) % 4)
        body = struct.pack("<II", len(js), 0x4E4F534A) + js \
            + struct.pack("<II", len(bin_), 0x004E4942) + bin_
        return struct.pack("<III", 0x46546C67, 2, 12 + len(body)) + body
