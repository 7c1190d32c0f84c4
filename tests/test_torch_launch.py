"""The kernels' launch path (``ops/_cuda.Kernel.launch``) on the CPU, with
the compiled library replaced by a stub: the entry is bound and its
argument types are set once, a call whose argument kinds differ from the
declared signature raises before anything is launched, and a CUDA error
code raises without counting a launch. No card is touched."""

import ctypes

import pytest

torch = pytest.importorskip("torch")

from sexy_raytracer_tpu_torch.ops import _cuda  # noqa: E402
from sexy_raytracer_tpu_torch.ops import brute, find, fused  # noqa: E402,F401
from sexy_raytracer_tpu_torch.ops import histogram as thist  # noqa: E402


class _Entry:
    """A stand-in for a ctypes function: counts the assignments of its
    argument types and records its calls."""

    def __init__(self, ret=0):
        object.__setattr__(self, "sets", 0)
        object.__setattr__(self, "calls", [])
        object.__setattr__(self, "ret", ret)

    def __setattr__(self, name, value):
        if name == "argtypes":
            object.__setattr__(self, "sets", self.sets + 1)
        object.__setattr__(self, name, value)

    def __call__(self, *args):
        self.calls.append(args)
        return self.ret


class _Library:
    def __init__(self, **entries):
        self.__dict__.update(entries)

    @staticmethod
    def srt_error_string(err):
        return b"stub error"


@pytest.fixture
def stub(monkeypatch):
    entry, failing = _Entry(), _Entry(ret=98)
    monkeypatch.setattr(_cuda, "library",
                        lambda: _Library(srt_stub=entry, srt_fail=failing))
    monkeypatch.setattr(_cuda, "_current_device", lambda: 0)
    monkeypatch.setattr(_cuda, "_raw_stream", lambda index: 4242)
    kernels = list(_cuda.KERNELS)
    yield entry, failing
    _cuda.KERNELS[:] = kernels


def test_launch_binds_once_and_passes_the_stream(stub):
    entry, _ = stub
    k = _cuda.Kernel("srt_stub", "pif", source="s", replaces="r")
    dev = torch.device("cuda", 0)
    k.launch(dev, 1 << 40, 7, 0.5)
    k.launch(dev, 1 << 41, 8, 1.5)
    assert entry.sets == 1
    assert entry.argtypes == [ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                              ctypes.c_void_p]
    assert entry.restype is ctypes.c_int
    assert entry.calls == [(1 << 40, 7, 0.5, 4242), (1 << 41, 8, 1.5, 4242)]
    assert k.launches == 2


@pytest.mark.parametrize("args", [
    (1 << 40, 7.0, 0.5),   # a float where the signature has an int
    (1 << 40, 7, 1),       # an int where it has a float
    (1 << 40, True, 0.5),  # a bool is no int argument
    (ctypes.c_void_p(8), 7, 0.5),  # pointers travel as plain ints
    (1 << 40, 7),          # too few
    (1 << 40, 7, 0.5, 3),  # too many
])
def test_launch_raises_on_a_changed_argument_kind(stub, args):
    entry, _ = stub
    k = _cuda.Kernel("srt_stub", "pif", source="s", replaces="r")
    dev = torch.device("cuda", 0)
    k.launch(dev, 1 << 40, 7, 0.5)
    with pytest.raises(TypeError, match="srt_stub"):
        k.launch(dev, *args)
    assert k.launches == 1 and len(entry.calls) == 1 and entry.sets == 1


def test_launch_takes_numpy_integers_as_ints(stub):
    np = pytest.importorskip("numpy")
    entry, _ = stub
    k = _cuda.Kernel("srt_stub", "pif", source="s", replaces="r")
    k.launch(torch.device("cuda", 0), np.int64(1 << 40), np.int32(7), 0.5)
    assert entry.calls == [(1 << 40, 7, 0.5, 4242)]
    assert all(type(a) in (int, float) for a in entry.calls[0])


def test_launch_raises_on_a_cuda_error_without_counting(stub):
    k = _cuda.Kernel("srt_fail", "p", source="s", replaces="r")
    with pytest.raises(RuntimeError, match="srt_fail: CUDA error 98"):
        k.launch(torch.device("cuda", 0), 16)
    assert k.launches == 0


def test_every_kernel_declares_its_signature():
    """Each kernel of the library names one kind per argument of its C
    entry, before the stream: the declarations against the sources."""
    import re
    from pathlib import Path

    src = {p.name: p.read_text() for p in
           (Path(_cuda.__file__).parent.parent / "csrc").glob("*.cu")}
    assert len(_cuda.KERNELS) >= 10
    for k in _cuda.KERNELS:
        text = src[Path(k.source).name]
        m = re.search(r"int %s\(([^)]*)\)" % k.symbol, text)
        assert m, k.symbol
        params = [p.strip() for p in m.group(1).split(",")]
        assert params[-1] == "void* stream", k.symbol
        kinds = "".join("p" if "*" in p else "f" if p.startswith("float")
                        else "i" for p in params[:-1])
        assert kinds == k.signature, (k.symbol, kinds, k.signature)


def test_dense_histogram_on_cpu_runs_the_plain_version():
    """A CPU tensor takes the plain version and launches nothing."""
    idx = torch.tensor([0, 1, 1], dtype=torch.int32)
    vals = torch.ones((3, 2))
    launches = thist.HISTOGRAM.launches
    out = thist.dense_histogram(idx, vals, 2)
    assert thist.HISTOGRAM.launches == launches
    assert out.tolist() == [[1.0, 1.0], [2.0, 2.0]]
