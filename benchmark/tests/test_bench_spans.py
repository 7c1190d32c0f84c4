"""The readers of the program's spans and counters (``spans.py``) on a
synthetic log, and on a program without one."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from benchmark import harness, spans

MS = 1_000_000  # ns

# two frames: render > (wait.key, render.chunk > (wait.ids, render.batch >
# (rng, trace > (rng, wait.emissive_spheres)), wait.download)); an open
# span and a nested wait count once
LOG = {
    "spans": [
        ["render", -1, 0, 100 * MS, None, None],                      # 0
        ["wait.key", 0, 1 * MS, 3 * MS, None, None],                  # 1
        ["render.chunk", 0, 5 * MS, 90 * MS, None, None],             # 2
        ["wait.ids", 2, 5 * MS, 6 * MS, None, None],                  # 3
        ["render.batch", 2, 6 * MS, 80 * MS, None, None],             # 4
        ["rng", 4, 6 * MS, 8 * MS, None, 4.0],                        # 5
        ["trace", 4, 8 * MS, 80 * MS, None, None],                    # 6
        ["rng", 6, 8 * MS, 9 * MS, None, 6.0],                        # 7
        ["wait.emissive_spheres", 6, 9 * MS, 19 * MS, None, None],    # 8
        ["wait.inner", 8, 10 * MS, 11 * MS, None, None],              # 9
        ["wait.download", 2, 80 * MS, 90 * MS, None, None],           # 10
        ["render", -1, 100 * MS, 200 * MS, None, None],               # 11
        ["rng", 11, 100 * MS, 101 * MS, None, 5.0],                   # 12
        ["rng", 12, 100 * MS, 101 * MS, None, 99.0],                  # 13
        ["wait.key", 11, 150 * MS, None, None, None],                 # 14
    ],
    "waits": {"key": 2, "ids": 1, "emissive_spheres": 1, "inner": 1,
              "download": 1},
    "tallies": {"live_rays": [300, 400]},
}


def ctx(**kw):
    base = dict(kind="frame", traced_units=2, window_s=0.2, busy_s=0.03)
    base.update(kw)
    return SimpleNamespace(**base)


@pytest.fixture
def log(monkeypatch):
    monkeypatch.setattr(spans, "program_log", lambda: LOG)


def test_outermost_counts_each_stretch_once():
    names = [s[0] for s in spans.outermost(LOG["spans"], "wait.")]
    # wait.inner lies in wait.emissive_spheres; the open wait.key is left
    assert names == ["wait.key", "wait.ids", "wait.emissive_spheres",
                     "wait.download"]
    assert [s[5] for s in spans.outermost(LOG["spans"], "rng")] \
        == [4.0, 6.0, 5.0]


@pytest.mark.usefixtures("log")
@pytest.mark.parametrize("name,want", [
    ("host_waits_per_frame", 3.0),
    ("host_waits_per_step", 3.0),
    # (2 + 1 + 10 + 10) ms over 0.2 s
    ("host_wait_pct.frame", 11.5),
    ("host_wait_pct.step", 11.5),
    # (4 + 6 + 5) ms over the 0.2 s window; the nested rng counted once
    ("rng_device_pct.frame", 7.5),
    ("rng_device_pct.step", 7.5),
    ("live_ray_pct.frame", 75.0),
    ("live_ray_pct.step", 75.0),
])
def test_readers_on_a_synthetic_log(name, want):
    assert harness.reader(name)(ctx()) == pytest.approx(want)


@pytest.mark.usefixtures("log")
def test_nothing_to_read_reads_none():
    assert harness.reader("host_waits_per_frame")(ctx(traced_units=0)) \
        is None
    assert harness.reader("host_wait_pct.frame")(ctx(window_s=None)) is None
    assert harness.reader("rng_device_pct.frame")(ctx(window_s=None)) \
        is None


def test_no_device_times_and_no_counter_read_none(monkeypatch):
    bare = {"spans": [["rng", -1, 0, MS, None, None]], "waits": {},
            "tallies": {}}
    monkeypatch.setattr(spans, "program_log", lambda: bare)
    assert harness.reader("rng_device_pct.step")(ctx()) is None
    assert harness.reader("live_ray_pct.step")(ctx()) is None
    assert harness.reader("host_waits_per_step")(ctx()) == 0.0


def test_a_program_without_spans_gives_nothing(monkeypatch):
    """A program older than its spans (no ``snapshot``), or one whose log
    is empty: every reader returns None and none raises."""
    from sexy_raytracer_tpu_torch.utils import profiling
    monkeypatch.delattr(profiling, "snapshot")
    assert spans.program_log() is None
    for name in ("host_waits_per_frame", "host_wait_pct.step",
                 "rng_device_pct.frame", "live_ray_pct.step"):
        assert harness.reader(name)(ctx()) is None
    monkeypatch.setattr(profiling, "snapshot", lambda: {
        "spans": [], "waits": {}, "tallies": {}}, raising=False)
    assert spans.program_log() is None
