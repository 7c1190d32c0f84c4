"""The port's profiling helpers and tools on the CPU: ``Meter`` and
``sync`` as tests/test_profiling.py holds the JAX package's (with the same
JSON keys), ``render_accumulate`` printing the meter's line, ``trace``,
and the tools of ``sexy_raytracer_tpu_torch/tools`` at small sizes: the
histogram A/B, the train-step components, one big-scene point and the
sweep's output file, the per-op tables and the refusal of ``--hlo``."""

import json
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from sexy_raytracer_tpu_torch.models.scene import SceneBuilder  # noqa: E402
from sexy_raytracer_tpu_torch.ops import _cuda  # noqa: E402
from sexy_raytracer_tpu_torch.render.renderer import render_accumulate  # noqa: E402
from sexy_raytracer_tpu_torch.tools import devtime  # noqa: E402
from sexy_raytracer_tpu_torch.tools import prof_dump, prof_step  # noqa: E402
from sexy_raytracer_tpu_torch.tools import profile as tprofile  # noqa: E402
from sexy_raytracer_tpu_torch.utils.config import (  # noqa: E402
    CameraConfig,
    RenderConfig,
)
from sexy_raytracer_tpu_torch.utils.profiling import Meter, sync, trace  # noqa: E402

SMALL = dict(pixels=128, spb=2, n=6, height=16)  # the stand-in at 28x16


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tools here run small tensors; one intra-op thread keeps them
    from contending with the suite's other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _launches():
    return {k.symbol: k.launches for k in _cuda.KERNELS}


def test_meter_accumulates_and_reports():
    m = Meter("t")
    with m.step(paths=100, bounces=4) as s:
        s.value = torch.ones((8,))
    with m.step(paths=50, bounces=4) as s:
        s.value = None  # sync is optional
    r = json.loads(m.report())
    assert r["steps"] == 2
    assert m.paths == 150 and m.rays == 600
    assert r["mrays_per_s"] > 0


def test_meter_report_keys_match_jax():
    jprofiling = pytest.importorskip("sexy_raytracer_tpu.utils.profiling")
    assert json.loads(Meter("t").report()).keys() \
        == json.loads(jprofiling.Meter("t").report()).keys()


def test_sync_forces_pytrees():
    sync(None)
    sync({"a": torch.arange(4), "b": torch.ones(2, 2)})
    sync(((torch.zeros(3),), [1, 2]))
    sync("no tensor")


def test_renderer_prints_meter(capsys):
    b = SceneBuilder()
    b.add_sphere((0, 0, -2), 1.0, b.add_pbr_material())
    scene = b.build(build_bvh=False, device="cpu")
    cfg = RenderConfig(width=8, height=8, samples_per_pixel=2, max_bounce=2,
                       rays_per_chunk=32,
                       camera=CameraConfig(eye=(0, 0, 2), look_at=(0, 0, 0)))
    render_accumulate(scene, cfg, method="bruteforce", progress=True)
    out = capsys.readouterr().out
    assert '"meter": "render_accumulate"' in out
    assert '"mrays_per_s"' in out
    line = json.loads([ln for ln in out.splitlines()
                       if ln.startswith("{")][-1])
    assert line["steps"] == 4  # 64 pixels in chunks of 16


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(tmp_path) as prof:
        (torch.ones(64) * 2).sum()
    data = json.loads(open(prof.trace_path).read())
    assert prof.trace_path.startswith(str(tmp_path))
    assert any("aten::" in e.get("name", "") for e in data["traceEvents"])


def test_profile_histogram_small():
    before = _launches()
    rows = tprofile.cmd_histogram(
        "cpu", cases=(("coherent", 3000, 8192, 8, True),
                      ("uniform", 3000, 5000, 3, False)), reps=1)
    assert _launches() == before  # CPU tensors: the plain versions
    assert [r["case"] for r in rows] == ["coherent", "uniform"]
    assert all(r["direct_ms"] > 0 and r["sorted_ms"] > 0 for r in rows)


def test_profile_step_small():
    rows = tprofile.cmd_step("cpu", reps=1, **SMALL)
    assert list(rows) == ["find_hit", "find + hit_data",
                          "find + hit_data + shade", "fwd trace",
                          "fwd trace, reference", "loss fwd", "loss fwd+bwd"]
    assert all(v > 0 for v in rows.values())


def test_bigscene_one_small():
    row = tprofile.cmd_bigscene_one(3042, None, "cpu", width=48, height=32,
                                    reps=1)
    assert row["tris"] == 3042 and row["method"] == "pallas"
    assert row["rays"] == 48 * 32 and row["device"] == "cpu"
    bvh = tprofile.cmd_bigscene_one(3042, "bvh", "cpu", width=48, height=32,
                                    reps=1)
    assert 0.5 * row["rays"] < row["hits"]
    assert abs(bvh["hits"] - row["hits"]) <= 2  # near ties at most


def test_bigscene_sweep_writes_its_out(tmp_path):
    out = tmp_path / "crossover.json"
    rows = tprofile.cmd_bigscene("cpu", out, runs=((512, None),), width=48,
                                 height=32)
    assert json.loads(out.read_text()) == rows
    assert len(rows) == 1 and rows[0]["tris"] == 512
    assert rows[0]["rays"] == 48 * 32


def test_devtime_reads_cpu_ops():
    x = torch.randn(64, 64)
    table = devtime.op_breakdown(lambda a: (a @ a).relu(), [(x,)], n=2,
                                 top=5)
    assert table["aten::mm"][1] == 2 and table["aten::relu"][1] == 2
    assert devtime.device_time("mm", lambda a: a @ a, [(x,)], n=2) > 0


def test_prof_step_and_dump_small():
    ops = prof_step.main(["5", "--device", "cpu"], reps=1, **SMALL)
    assert any(name.startswith("aten::") for name in ops)
    rows = prof_dump.main(["--device", "cpu"], steps=1, top=10, **SMALL)
    assert len(rows) == 10
    assert all(track.startswith("thread ") for track, _ in rows)


def test_prof_dump_refuses_hlo(capsys):
    with pytest.raises(SystemExit) as e:
        prof_dump.main(["--hlo"])
    assert e.value.code == 2
    assert "no counterpart" in capsys.readouterr().err


def test_profile_runs_as_a_module():
    proc = subprocess.run(
        [sys.executable, "-m", "sexy_raytracer_tpu_torch.tools.profile",
         "--help"], capture_output=True, text=True, timeout=120,
        cwd=tprofile._ROOT)
    assert proc.returncode == 0
    assert "histogram" in proc.stdout and "--device" in proc.stdout
    assert all(c in proc.stdout for c in ("step", "xplane", "bigscene"))


@pytest.mark.parametrize("case", [
    # (registers, threads, shared memory) -> (blocks, warps) an SM
    ((168, 256, 0), (1, 8)),      # kernel 6 before its redesign
    ((64, 256, 0), (4, 32)),      # kernel 3, one thread a ray
    ((40, 256, 0), (6, 48)),      # kernels 3 and 4's copy floor
    ((110, 256, 0), (2, 16)),     # kernel 6's copy floor
    ((96, 96, 62256), (3, 9)),    # kernel 4, 64 x 3 ring: shared memory
    ((128, 32, 12424), (16, 16)),  # kernel 6, one-warp blocks: registers
])
def test_occupancy_known_cases(case):
    """``shade_split.occupancy``: registers in units of 256 a warp, 1 KB of
    shared memory reserved a block, at most 2,048 threads an SM."""
    from sexy_raytracer_tpu_torch.tools import shade_split

    (regs, threads, smem), (blocks, warps) = case
    assert shade_split.occupancy(regs, threads, smem) == (
        blocks, warps, warps / 64)


def test_warp_mix_counts_warps_by_branch():
    """``shade_split.warp_mix`` on a toy stack: two whole warps of one
    branch each, one of both, and a part warp of triangle lanes."""
    from sexy_raytracer_tpu_torch.tools import shade_split

    tri = torch.zeros(32 * 3 + 5)
    tri[:32] = 1.0
    tri[64:70] = 1.0
    tri[96:] = 1.0
    hf = torch.zeros((34, tri.shape[0]))
    hf[32] = tri
    assert shade_split.warp_mix(hf) == {"triangle": 2, "sphere or miss": 1,
                                        "mixed": 1, "warps": 4}
    sf = torch.zeros((75, tri.shape[0]))
    sf[26] = tri
    assert shade_split.hit_mix(sf) == {"no hit": 1, "warps": 4}


def test_ptxas_report_reads_registers_stack_and_spills():
    """``_cuda.ptxas_report`` on ptxas's -v lines for two kernels."""
    log = """ptxas info    : Compiling entry function '_Z1av' for 'sm_90a'
ptxas info    : Function properties for _Z1av
    328 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 168 registers, 384 bytes cmem[0]
ptxas info    : Compiling entry function '_Z1bv' for 'sm_90a'
ptxas info    : Function properties for _Z1bv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, 1024 bytes smem, 384 bytes cmem[0]
"""
    assert _cuda.ptxas_report(log) == {
        "_Z1av": dict(registers=168, smem=0, stack=328, spill=8),
        "_Z1bv": dict(registers=40, smem=1024, stack=0, spill=0)}


def test_sass_mix_counts_instructions_by_class():
    """``shade_split.sass_mix`` on ``cuobjdump -sass`` lines of two
    functions: predicated instructions count by their opcode, and only the
    named function is counted."""
    from sexy_raytracer_tpu_torch.tools import shade_split

    sass = """
        Function : _Z16shade_bwd_kernelv
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/               @P0 FADD R2, R3, R4 ;
        /*0020*/              @!P1 MUFU.RCP R2, R3 ;
        /*0030*/                   LDL.64 R2, [R1] ;
        /*0040*/                   LDS R5, [R6] ;
        /*0050*/                   BRA 0x40;
        Function : _Z13hitrec_kernelv
        /*0000*/                   FADD R2, R3, R4 ;
"""
    assert shade_split.sass_mix(sass, "shade_bwd_kernel") == {
        "_Z16shade_bwd_kernelv": {
            "instructions": 6, "f32": 1, "mufu": 1, "lds": 1, "sts": 0,
            "local": 1, "global": 0, "branch": 1}}
