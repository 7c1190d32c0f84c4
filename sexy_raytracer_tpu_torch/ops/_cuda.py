"""Build and bind the CUDA kernels of ``csrc/*.cu``.

All kernels live in one shared library with a plain C interface, compiled
with ``nvcc`` for Hopper (``sm_90a``) at first use, one ``nvcc`` per source
file, all started together, then linked, and loaded with ctypes.
The library is keyed by a hash of the sources and flags, and lives under
``build/sexy_raytracer_tpu_torch/`` at the repository root, so a checkout
builds what its own sources say. Nothing here runs at import.

Every C entry point launches its kernels (one, or the dense histogram's
passes) on the stream it is given and returns ``cudaGetLastError()``;
``Kernel.launch`` raises on a nonzero code and counts the launch. The
launch path runs on every call of every kernel, so it does the least it
can: the entry and its argument types are bound once, pointers travel as
plain ints, and the device guard is entered only for a tensor on another
device than the current one. FMA contraction is off (``-fmad=false``)
and divide and sqrt stay IEEE (no fast math), so a kernel rounds exactly
like its plain PyTorch version, which runs one operation at a time.
"""

from __future__ import annotations

import ctypes
import hashlib
import numbers
import os
import subprocess
import tempfile
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD = _PKG.parent / "build" / "sexy_raytracer_tpu_torch"
SOURCES = ("brute.cu", "find.cu", "fused.cu", "histogram.cu", "rng.cu")
HEADERS = ("pipeline.cuh",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xcompiler", "-fPIC",
)

_lib = None
build_info: dict = {}
# every Kernel, in the order their modules were imported
KERNELS: list = []


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME); the "
                           "kernels are compiled with its nvcc")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((_CSRC / name).read_bytes())
    return _BUILD / f"libsrt_kernels-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless this source hash is already built.

    Records the wall time of the compile (0 when cached) and ptxas's
    register and shared-memory report, kept beside the library, in
    ``build_info``.
    """
    out = library_path()
    log_path = out.with_suffix(".log")
    if out.exists():
        log = log_path.read_text() if log_path.exists() else ""
        build_info.update(path=str(out), seconds=0.0, cached=True, log=log)
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out.parent) as obj_dir:
        objs = [os.path.join(obj_dir, s + ".o") for s in SOURCES]
        jobs = [
            ([_nvcc(), *NVCC_FLAGS, "-Xptxas=-v", "-c", "-o", obj,
              str(_CSRC / name)])
            for name, obj in zip(SOURCES, objs)
        ]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for cmd in jobs]
        results = []
        for cmd, p in zip(jobs, procs):
            stdout, stderr = p.communicate()
            results.append((cmd, p.returncode, stdout, stderr))
        link = [_nvcc(), *NVCC_FLAGS, "-shared", "-o", tmp, *objs]
        if all(p.returncode == 0 for p in procs):
            lp = subprocess.run(link, capture_output=True, text=True)
            results.append((link, lp.returncode, lp.stdout, lp.stderr))
    seconds = time.perf_counter() - t0
    for cmd, rc, stdout, stderr in results:
        if rc != 0:
            os.unlink(tmp)
            raise RuntimeError(
                f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{stdout}\n{stderr}")
    log = "".join(stdout + stderr for _, _, stdout, stderr in results)
    log_path.write_text(log)
    os.replace(tmp, out)  # atomic: concurrent builders never see half a file
    build_info.update(path=str(out), seconds=seconds, cached=False, log=log)
    return out


def ptxas_report(log=None) -> dict:
    """ptxas's report of each kernel in a build log (``build_info``'s by
    default) -> {mangled name: {registers, smem, spill}}: registers a
    thread, static shared memory, stack-frame bytes (local arrays and
    spills) and spill-store bytes."""
    import re

    out, name = {}, None
    for line in (build_info.get("log", "") if log is None else log) \
            .splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            out[name] = dict(registers=0, smem=0, stack=0, spill=0)
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame", line)
        if m:
            out[name]["stack"] = int(m.group(1))
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            out[name]["spill"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            out[name]["smem"] = int(m.group(1)) if m else 0
    return out


def library():
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.srt_error_string.argtypes = [ctypes.c_int]
        lib.srt_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def ptr(t) -> int:
    """A tensor's device address for a kernel argument."""
    return t.data_ptr()


# argument kinds of a C entry: a pointer (a ``ptr`` value), an int, a float
_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}
_KINDS = {"p": int, "i": int, "f": float}


def _current_device() -> int:
    return torch.cuda.current_device()


def _raw_stream(index: int) -> int:
    """The current CUDA stream of device ``index``, as a handle."""
    return torch._C._cuda_getCurrentRawStream(index)


class Kernel:
    """One C entry point of the library, with a count of its launches.

    ``signature`` names the entry's arguments before the stream, one letter
    each: ``p`` a device pointer (``ptr``), ``i`` a C int, ``f`` a C float.
    The entry is looked up and its ctypes argument types are set once, at
    the first launch; every launch must pass Python ints and floats of
    these kinds, or raises.

    ``launches`` grows by one each time ``launch`` has started the kernel;
    a run can set it to 0 and read it back to show which kernels it went
    through.
    """

    def __init__(self, symbol: str, signature: str, source: str,
                 replaces: str):
        self.symbol = symbol
        self.signature = signature
        self.source = source
        self.replaces = replaces
        self.launches = 0
        self._kinds = tuple(_KINDS[k] for k in signature)
        self._fn = None
        KERNELS.append(self)

    def _bind(self):
        fn = getattr(library(), self.symbol)
        fn.argtypes = [_CTYPES[k] for k in self.signature] + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        self._fn = fn
        return fn

    def _check(self, args) -> tuple:
        """``args`` as the signature's Python kinds (numpy integers become
        ints); raise on any other kind or count."""
        if len(args) == len(self._kinds):
            out = []
            for a, kind in zip(args, self._kinds):
                if kind is int and isinstance(a, numbers.Integral) \
                        and not isinstance(a, bool):
                    out.append(int(a))
                elif kind is float and isinstance(a, float):
                    out.append(float(a))
                else:
                    break
            else:
                return tuple(out)
        raise TypeError(
            f"{self.symbol}: arguments of kinds "
            f"{[type(a).__name__ for a in args]} do not match the signature "
            f"{self.signature!r} ({len(self._kinds)} arguments)")

    def launch(self, device, *args) -> None:
        """Call the entry with ``args`` plus the current stream of
        ``device`` (a CUDA ``torch.device``); raise if the arguments do not
        match the signature or the launch failed."""
        if tuple(map(type, args)) != self._kinds:
            args = self._check(args)
        fn = self._fn or self._bind()
        current = _current_device()
        index = current if device.index is None else device.index
        if index == current:
            err = fn(*args, _raw_stream(index))
        else:
            with torch.cuda.device(index):
                err = fn(*args, _raw_stream(index))
        if err != 0:
            msg = library().srt_error_string(err).decode()
            raise RuntimeError(f"{self.symbol}: CUDA error {err}: {msg}")
        self.launches += 1

