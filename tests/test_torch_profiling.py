"""The port's profiling helpers and tools on the CPU: ``Meter`` and
``sync`` as tests/test_profiling.py holds the JAX package's (with the same
JSON keys), ``render_accumulate`` printing the meter's line, ``trace``,
the spans, waits and counters of the entry layers (off without a
profiler, nested, counted, and leaving every output bit for bit as it
is), and the tools of ``sexy_raytracer_tpu_torch/tools`` at small sizes:
the histogram A/B, the train-step components, one big-scene point and the
sweep's output file, the per-op tables and the refusal of ``--hlo``. One
test, marked ``cuda``, holds every host synchronisation of a frame and a
train step on the card to a ``wait`` site."""

import dataclasses
import json
import subprocess
import sys
import time
import traceback
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sexy_raytracer_tpu_torch.diff.inverse import (  # noqa: E402
    make_optimizer,
    make_train_step,
)
from sexy_raytracer_tpu_torch.models import presets  # noqa: E402
from sexy_raytracer_tpu_torch.models.scene import SceneBuilder  # noqa: E402
from sexy_raytracer_tpu_torch.ops import _cuda  # noqa: E402
from sexy_raytracer_tpu_torch.render import integrator  # noqa: E402
from sexy_raytracer_tpu_torch.render.camera import Camera  # noqa: E402
from sexy_raytracer_tpu_torch.render.renderer import render_accumulate  # noqa: E402
from sexy_raytracer_tpu_torch.tools import devtime  # noqa: E402
from sexy_raytracer_tpu_torch.tools import prof_dump, prof_step  # noqa: E402
from sexy_raytracer_tpu_torch.tools import profile as tprofile  # noqa: E402
from sexy_raytracer_tpu_torch.utils.config import (  # noqa: E402
    CameraConfig,
    RenderConfig,
)
from sexy_raytracer_tpu_torch.utils import profiling, rng  # noqa: E402
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


# -- spans, waits and counters ------------------------------------------------

# the frame's own waits (camera, key, background, emissive_tris); a chunk's
# (ids, accum, download); a sample batch's (emissive_spheres and one
# shade_rows a bounce)
FRAME_WAITS = {"camera", "key", "background", "emissive_tris"}
CHUNK_WAITS = {"ids", "accum", "download"}


def _frame(dev="cpu", height=8, spp=2, spb=2, max_bounce=3, chunk=128):
    """The stand-in at a toy size: relief, ground, light, two spheres."""
    scene, cfg = presets.flagship_standin(n=6, spp=spp, height=height,
                                          device=dev)
    return scene, dataclasses.replace(cfg, samples_per_batch=spb,
                                      max_bounce=max_bounce,
                                      rays_per_chunk=chunk, seed=5)


def _step(scene, cfg, dev="cpu", pixels=64):
    params = {"shade_atlas": scene.shade_atlas}
    step = make_train_step(
        cfg, make_optimizer(params, 1e-2), spb=2,
        last_bounce_vis=integrator.scene_no_emissive_tris(scene))
    g = torch.Generator().manual_seed(0)
    n_pix = cfg.width * cfg.height
    ids = torch.randperm(n_pix, generator=g)[:pixels].to(torch.int32)
    ids = ids.to(dev)
    target = torch.rand((pixels, 3), generator=g).to(dev)
    cam = Camera.from_config(cfg.camera, cfg.aspect, device=dev)
    key = rng.key(11, device=dev)

    def run(state):
        return step(state, scene, cam, ids, target, key)

    return step.init(params), run


def _names(log):
    """By span name, the rows of a snapshot's span log."""
    by = {}
    for row in log:
        by.setdefault(row[0], []).append(row)
    return by


def test_no_profiler_nothing_logged():
    before = profiling.snapshot()
    called = []
    scene, cfg = _frame()
    render_accumulate(scene, cfg)
    state, run = _step(scene, cfg)
    run(state)
    profiling.tally("x", 1, called.append, 1)
    assert profiling.snapshot() == before and called == []
    # off, every span and wait is one shared no-op
    assert profiling.span("a") is profiling.wait("b") \
        is profiling.span("c", device=True)


def test_spans_nest_on_the_profilers_timeline(tmp_path):
    with trace(tmp_path) as prof:
        with profiling.span("outer"):
            time.sleep(0.01)
            with profiling.span("outer.a"):
                time.sleep(0.02)
                with profiling.wait("site"):
                    time.sleep(0.01)
            with profiling.span("outer.b"):
                time.sleep(0.01)
        with profiling.span("second"):
            pass
    snap = profiling.snapshot()
    log = snap["spans"]
    assert [(r[0], r[1]) for r in log] == [
        ("outer", -1), ("outer.a", 0), ("wait.site", 1), ("outer.b", 0),
        ("second", -1)]
    own = [r[4] for r in log]
    dur = [r[3] - r[2] for r in log]
    assert own[0] == dur[0] - dur[1] - dur[3]
    assert own[1] == dur[1] - dur[2]
    assert own[2] == dur[2] and own[0] >= 0.009e9
    assert all(a[3] <= b[2] for a, b in zip(log[1:3], log[3:]))
    assert snap["waits"] == {"site": 1}
    # on the CPU no span has device time
    assert {r[5] for r in log} == {None}
    names = {e.name for e in prof.events()}
    assert {"outer", "outer.a", "wait.site", "outer.b"} <= names
    assert json.loads(open(prof.spans_path).read()) \
        == json.loads(json.dumps(snap))


def test_each_recording_starts_a_new_log(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    with trace(tmp_path):
        with profiling.span("first"):
            pass
    with trace(tmp_path):  # straight after: a log of its own
        with profiling.span("again"):
            pass
    assert [r[0] for r in profiling.snapshot()["spans"]] == ["again"]
    with profiling.span("between"):  # no profiler: not logged
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.wait("w"):
            pass
    snap = profiling.snapshot()
    assert [r[0] for r in snap["spans"]] == ["wait.w"]
    assert snap["waits"] == {"w": 1}
    with trace(tmp_path):  # straight after another profiler's recording
        pass
    assert profiling.snapshot() == {"spans": [], "waits": {}, "tallies": {}}


@pytest.mark.parametrize("spp,spb,max_bounce,chunk", [
    (2, 2, 3, 128),   # one batch a chunk, as the frame cells run
    (4, 2, 2, 96),    # two batches a chunk, a short last chunk
])
def test_render_waits_by_site(tmp_path, spp, spb, max_bounce, chunk):
    scene, cfg = _frame(spp=spp, spb=spb, max_bounce=max_bounce,
                        chunk=chunk)
    with trace(tmp_path):
        render_accumulate(scene, cfg)
    chunks = -(-cfg.width * cfg.height // (chunk // spb))
    assert cfg.width * cfg.height % (chunk // spb)  # the last is short
    batches = chunks * (spp // spb)
    want = {k: 1 for k in FRAME_WAITS}
    want.update({k: chunks for k in CHUNK_WAITS})
    want.update(emissive_spheres=batches, shade_rows=batches * max_bounce)
    snap = profiling.snapshot()
    assert snap["waits"] == want
    log = snap["spans"]
    by = _names(log)
    assert len(by["render"]) == 1 and len(by["render.chunk"]) == chunks
    assert len(by["render.batch"]) == len(by["trace"]) == batches
    assert {log[r[1]][0] for r in by["render.chunk"]} == {"render"}
    assert {log[r[1]][0] for r in by["trace.find"]} == {"trace.bounce"}
    assert {log[r[1]][0] for r in by["rng"]} == {"render.batch", "trace"}
    assert len(by["trace.bounce"]) == batches * (max_bounce - 1)
    assert len(by["trace.visibility"]) == batches


def test_emissive_tris_waits_only_with_triangles(tmp_path):
    """The read back of the triangles' materials is a wait site where
    there are triangles to read; a scene of spheres alone reads nothing."""
    scene, _ = _frame()
    b = SceneBuilder()
    b.add_sphere((0, 0, -2), 1.0, b.add_pbr_material())
    spheres = b.build(build_bvh=False, device="cpu")
    with trace(tmp_path):
        assert integrator.scene_no_emissive_tris(spheres)
        assert integrator.scene_no_emissive_tris(scene)
    snap = profiling.snapshot()
    assert snap["waits"] == {"emissive_tris": 1}
    assert [r[0] for r in snap["spans"]] == ["wait.emissive_tris"]


def test_train_step_spans(tmp_path):
    scene, cfg = _frame()
    state, run = _step(scene, cfg)
    with trace(tmp_path):
        run(state)
    snap = profiling.snapshot()
    names = [r[0] for r in snap["spans"]]
    parent = {r[0]: r[1] for r in snap["spans"]}
    top = names.index("step")
    for child in ("step.forward", "step.backward", "step.adam",
                  "wait.background"):
        assert parent[child] == top
    assert parent["wait.resolve"] == names.index("step.forward")
    assert snap["waits"] == {"background": 1, "resolve": 1,
                             "emissive_spheres": 1,
                             "shade_rows": cfg.max_bounce}


def test_live_ray_counter_matches_the_finds(tmp_path, monkeypatch):
    """Every find of a wavefront, the last bounce's occlusion pass too,
    counts its live lanes: those it is given a real ``t_min`` for (dead
    lanes get 3e38, so they miss everything)."""
    seen = []
    for name in ("find_hit", "find_occluded"):
        fn = getattr(integrator, name)

        def counted(*a, _fn=fn, **kw):
            seen.append((int((kw["t_min"] < 1e30).sum()), a[1].shape[0]))
            return _fn(*a, **kw)

        monkeypatch.setattr(integrator, name, counted)
    scene, cfg = _frame(max_bounce=4)
    with trace(tmp_path):
        render_accumulate(scene, cfg)
    live, slots = profiling.snapshot()["tallies"]["live_rays"]
    assert live == sum(n for n, _ in seen)
    assert slots == sum(r for _, r in seen)
    assert 0 < live < slots


def test_image_bit_identical_with_tracing(tmp_path):
    scene, cfg = _frame(spp=4, spb=2, max_bounce=3, chunk=96)
    plain = render_accumulate(scene, cfg)
    with trace(tmp_path):
        traced = render_accumulate(scene, cfg)
    assert profiling.snapshot()["tallies"]["live_rays"][0] > 0
    assert np.array_equal(plain, traced)


def test_steps_bit_identical_with_tracing(tmp_path):
    scene, cfg = _frame()
    state, run = _step(scene, cfg)
    s1, loss1 = run(state)
    s2, loss2 = run(s1)
    with trace(tmp_path):
        t1, tloss1 = run(state)
        t2, tloss2 = run(t1)
    assert len(_names(profiling.snapshot()["spans"])["step"]) == 2
    assert torch.equal(loss1, tloss1) and torch.equal(loss2, tloss2)
    for a, b in ((s2.params, t2.params), (s2.opt_state.mu, t2.opt_state.mu),
                 (s2.opt_state.nu, t2.opt_state.nu)):
        assert all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.cuda
def test_every_card_sync_is_a_wait_site(tmp_path):
    """A frame and a train step on the card under
    ``set_sync_debug_mode("warn")``: each synchronisation warns, and at
    each warning a ``wait`` span of the program must be open; and each
    ``wait`` span entered saw a synchronisation."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _cuda.build()
    scene, cfg = _frame("cuda", height=90, spp=4, spb=4, max_bounce=4,
                        chunk=8192)
    state, run = _step(scene, cfg, "cuda", pixels=1024)
    render_accumulate(scene, cfg)
    run(state)
    torch.cuda.synchronize()
    found = []  # (host ns, the program's innermost frame) a warning

    def hook(message, *a, **kw):
        if "called a synchronizing CUDA operation" in str(message):
            where = [f"{f.filename.split('/')[-1]}:{f.lineno}"
                     for f in traceback.extract_stack()[:-1]
                     if "sexy_raytracer_tpu_torch" in f.filename][-1:]
            found.append((time.time_ns(), where))

    with trace(tmp_path), warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            render_accumulate(scene, cfg)
            s1, _ = run(state)
            run(s1)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    assert found, "no synchronisation seen: the debug mode is off"
    waits = [r for r in profiling.snapshot()["spans"]
             if r[0].startswith("wait.")]
    inside = [[r for r in waits if r[2] <= t <= r[3]] for t, _ in found]
    outside = [w for (_, w), rows in zip(found, inside) if not rows]
    assert not outside, outside
    # and every wait site entered synchronised at least once
    waited = {id(r) for rows in inside for r in rows}
    assert not [r[0] for r in waits if id(r) not in waited]


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
