"""Host-side PNG I/O (a copy of ``sexy_raytracer_tpu/utils/png.py``).

Replacement for stb_image / stb_image_write (reference texture.h:115,
main.cpp:237). Uses Pillow when available and falls back to a pure-Python
zlib PNG codec, so the port has no hard native-image dependency.
"""

from __future__ import annotations

import io
import struct
import zlib

import numpy as np

try:  # Pillow is present in the standard image; fall back gracefully.
    from PIL import Image

    _HAVE_PIL = True
except ImportError:  # pragma: no cover
    _HAVE_PIL = False


def read_png(path, channels=3):
    """Load an image file as uint8 ``[H, W, channels]``.

    Returns ``None`` if the file cannot be read — callers substitute the
    reference's magenta missing-texture sentinel (reference texture.h:131).
    """
    if _HAVE_PIL:
        try:
            img = Image.open(path)
        except (FileNotFoundError, OSError):
            return None
        mode = {1: "L", 3: "RGB", 4: "RGBA"}[channels]
        arr = np.asarray(img.convert(mode), dtype=np.uint8)
        if channels == 1:
            arr = arr[..., None]
        return arr
    return _read_png_pure(path, channels)


def decode_png(data: bytes, channels=3):
    """Decode an image held in memory (a glTF's embedded or buffer-view
    image) as uint8 ``[H, W, channels]``, like ``read_png``."""
    if _HAVE_PIL:
        return read_png(io.BytesIO(data), channels)
    return _decode_png_pure(data, channels)


def write_png(path, arr):
    """Write uint8 ``[H, W, C]`` (C in {1, 3, 4}) to a PNG file."""
    arr = np.ascontiguousarray(arr, dtype=np.uint8)
    if arr.ndim == 2:
        arr = arr[..., None]
    if _HAVE_PIL:
        mode = {1: "L", 3: "RGB", 4: "RGBA"}[arr.shape[-1]]
        Image.fromarray(arr.squeeze(-1) if mode == "L" else arr, mode).save(path)
        return
    _write_png_pure(path, arr)


# ---------------------------------------------------------------------------
# Pure-Python fallback codec (8-bit, non-interlaced)
# ---------------------------------------------------------------------------

def _write_png_pure(path, arr):
    h, w, c = arr.shape
    color_type = {1: 0, 3: 2, 4: 6}[c]
    raw = b"".join(b"\x00" + arr[i].tobytes() for i in range(h))

    def chunk(tag, data):
        payload = tag + data
        return (
            struct.pack(">I", len(data))
            + payload
            + struct.pack(">I", zlib.crc32(payload) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", ihdr))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


def _paeth(a, b, c):
    p = a.astype(np.int32) + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    out = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    return out.astype(np.uint8)


def _read_png_pure(path, channels):
    try:
        with open(path, "rb") as f:
            data = f.read()
    except (FileNotFoundError, OSError):
        return None
    return _decode_png_pure(data, channels)


def _decode_png_pure(data, channels):
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        return None
    pos, idat, ihdr = 8, b"", None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        tag = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + length]
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat += body
        elif tag == b"IEND":
            break
        pos += 12 + length
    if ihdr is None:
        return None
    w, h, depth, color_type, _, _, interlace = ihdr
    if depth != 8 or interlace != 0:
        return None
    nch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color_type]
    if color_type == 3:
        return None  # palettes unsupported in the fallback
    raw = zlib.decompress(idat)
    stride = w * nch
    img = np.zeros((h, w, nch), dtype=np.uint8)
    prev = np.zeros(stride, dtype=np.uint8)
    off = 0
    for row in range(h):
        filt = raw[off]
        line = np.frombuffer(raw[off + 1 : off + 1 + stride], dtype=np.uint8).copy()
        off += 1 + stride
        if filt == 1:  # Sub
            for i in range(nch, stride):
                line[i] = (line[i] + line[i - nch]) & 0xFF
        elif filt == 2:  # Up
            line = (line.astype(np.int32) + prev) % 256
            line = line.astype(np.uint8)
        elif filt == 3:  # Average
            for i in range(stride):
                left = line[i - nch] if i >= nch else 0
                line[i] = (line[i] + ((int(left) + int(prev[i])) >> 1)) & 0xFF
        elif filt == 4:  # Paeth
            for i in range(stride):
                left = line[i - nch] if i >= nch else np.uint8(0)
                ul = prev[i - nch] if i >= nch else np.uint8(0)
                line[i] = (
                    int(line[i]) + int(_paeth(np.uint8(left), prev[i], np.uint8(ul)))
                ) & 0xFF
        img[row] = line.reshape(w, nch)
        prev = line
    return _convert_channels(img, channels)


def _convert_channels(img, channels):
    nch = img.shape[-1]
    if nch == channels:
        return img
    if channels == 3:
        if nch == 1:
            return np.repeat(img, 3, axis=-1)
        if nch == 2:
            return np.repeat(img[..., :1], 3, axis=-1)
        if nch == 4:
            return img[..., :3]
    if channels == 1:
        if nch >= 3:
            # ITU-R 601 luma, matching stb's behavior for channel reduction
            luma = (
                0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2]
            )
            return luma.astype(np.uint8)[..., None]
        return img[..., :1]
    if channels == 4:
        rgb = _convert_channels(img, 3)
        a = np.full(rgb.shape[:-1] + (1,), 255, dtype=np.uint8)
        return np.concatenate([rgb, a], axis=-1)
    return img
