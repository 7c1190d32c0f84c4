"""The two cells added beside the first three, built through the harness
on the CPU at toy size: the Cornell box's frames at its depth of 50
(``cornell-frame-600sq``) and the flagship stand-in's 131,072-path fit
step (``standin-step-131k``); and the reader of the deep bounces' live
lanes on a synthetic log."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from benchmark import faults, harness, spans
from benchmark.tests.toy import run, toy_cell

NEW = ("cornell-frame-600sq", "standin-step-131k")
DEEP = "live_ray_pct_deep.frame"


def test_cells_are_found_by_their_names():
    cornell = toy_cell("cornell-frame-600sq")
    assert cornell.config["max_bounce"] == 50
    assert cornell.config["background"] == [0.0, 0.0, 0.0]
    assert harness.loop_of(cornell).__name__ == "benchmark.loops.frames"
    assert DEEP in {m["name"] for m in cornell.per_layer}
    step = toy_cell("standin-step-131k")
    assert harness.loop_of(step).__name__ == "benchmark.loops.fit_step"
    assert {m["name"] for m in step.end_to_end} == {
        "setup_s", "step_ms", "step_ms_p95", "peak_mem_gib"}
    assert DEEP not in {m["name"] for m in step.per_layer}


@pytest.mark.parametrize("name", NEW)
def test_sound_run_is_correct(name):
    out = run(name)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["checks"]) == set(toy_cell(name).limits)


@pytest.mark.parametrize("name", NEW)
def test_control_is_not_correct(name):
    """The reference in bfloat16, put in the program's place."""
    assert not run(name, control="bf16")["correct"]


@pytest.mark.parametrize("name", NEW)
def test_half_the_samples_is_not_correct(name):
    drv = harness.loop_of(toy_cell(name))
    with faults.planted(drv, "half"):
        out = run(name, seconds=0.3)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("first", [1, 2])
def test_a_fault_past_the_first_bounces_is_not_correct(first, monkeypatch):
    """The program's bounce draws turned over (u -> 1 - u) from bounce
    ``first`` on: its paths agree with the reference through ``first``
    hits and go elsewhere after, which the room's lit walls show."""
    from sexy_raytracer_tpu_torch.render import integrator

    draw = integrator.bounce_uniforms

    def turned(keys, max_bounce):
        u = draw(keys, max_bounce).clone()
        u[:, first:] = 1.0 - u[:, first:]
        return u

    monkeypatch.setattr(integrator, "bounce_uniforms", turned)
    out = run("cornell-frame-600sq")
    assert not out["correct"], out["checks"]


def test_traced_cornell_run_reads_the_deep_bounces():
    out = run("cornell-frame-600sq", trace=1)
    assert out["correct"]
    deep = out["metrics"][DEEP]["value"]
    assert 0.0 < deep < out["metrics"]["live_ray_pct.frame"]["value"]


def test_deep_reader_on_a_synthetic_log(monkeypatch):
    read = None

    def reader_with(log):
        monkeypatch.setattr(spans, "program_log", lambda: log)
        return harness.reader(DEEP)

    ctx = SimpleNamespace(kind="frame", traced_units=3)
    read = reader_with({"spans": [["render", -1, 0, 1, None, None]],
                        "waits": {}, "tallies": {"live_rays": [30, 40],
                                                 "live_rays.deep": [5, 20]}})
    assert read(ctx) == 25.0
    # a program older than the counter, and one with no log at all
    assert reader_with({"spans": [["render", -1, 0, 1, None, None]],
                        "waits": {}, "tallies": {"live_rays": [30, 40]}})(
        ctx) is None
    assert reader_with(None)(ctx) is None
