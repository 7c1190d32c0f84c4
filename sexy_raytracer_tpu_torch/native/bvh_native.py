"""ctypes binding for the native BVH builder (a copy of
``sexy_raytracer_tpu/native/bvh_native.py``), compiled on first use.

``bvh_builder.cpp`` here is a byte-for-byte copy of the JAX package's. It is
compiled with ``g++`` into ``build/sexy_raytracer_tpu_torch/`` at the
repository root (never into the package), under a name keyed by a hash of
the source and flags, so a checkout builds what its own source says. It is
a host builder, not a device kernel: ``models/bvh.py`` uses it from
``NATIVE_MIN_PRIMS`` primitives on and falls back to the numpy builder when
no toolchain exists. Both builders produce bit-identical trees. The flags
leave out ``-march=native`` so that a library built on one host loads on
another; the builder's float operations are the same without it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "bvh_builder.cpp"
_BUILD = Path(__file__).resolve().parents[2] / "build" / "sexy_raytracer_tpu_torch"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib = None
_tried = False


def library_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(_SRC.read_bytes())
    return _BUILD / f"libsrtbvh-{h.hexdigest()[:16]}.so"


def _compile(out: Path) -> bool:
    """Compile into a temporary file and move it into place atomically, so
    that concurrent builders never load half a library."""
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    try:
        subprocess.run(["g++", *GXX_FLAGS, str(_SRC), "-o", tmp],
                       check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        os.unlink(tmp)
        return False
    os.replace(tmp, out)
    return True


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        out = library_path()
        if not out.exists() and not _compile(out):
            return None
        try:
            lib = ctypes.CDLL(str(out))
        except OSError:
            return None
        lib.srt_build_bvh.restype = ctypes.c_int64
        lib.srt_build_bvh.argtypes = [
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def build(pmin: np.ndarray, pmax: np.ndarray):
    from sexy_raytracer_tpu_torch.models.bvh import FlatBVH

    lib = _load()
    if lib is None:
        raise RuntimeError("native BVH builder unavailable")
    pmin = np.ascontiguousarray(pmin, np.float32)
    pmax = np.ascontiguousarray(pmax, np.float32)
    n = pmin.shape[0]
    n_nodes = 2 * n - 1
    node_min = np.empty((n_nodes, 3), np.float32)
    node_max = np.empty((n_nodes, 3), np.float32)
    left = np.empty((n_nodes,), np.int32)
    right = np.empty((n_nodes,), np.int32)

    def ptr(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    written = lib.srt_build_bvh(
        ptr(pmin, ctypes.c_float),
        ptr(pmax, ctypes.c_float),
        n,
        ptr(node_min, ctypes.c_float),
        ptr(node_max, ctypes.c_float),
        ptr(left, ctypes.c_int32),
        ptr(right, ctypes.c_int32),
    )
    if written != n_nodes:
        raise RuntimeError(f"native BVH build failed ({written} != {n_nodes})")
    return FlatBVH(node_min, node_max, left, right)
