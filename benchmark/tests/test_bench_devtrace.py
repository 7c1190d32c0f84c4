"""The reductions from events and counters to metrics, on synthetic
inputs, and the roofline byte counts from shapes."""

from __future__ import annotations

import math
from types import SimpleNamespace

import pytest

from benchmark import devtrace, harness
from benchmark.roofline import find_closest, peaks, shade_bwd


def test_percentile_nearest_rank():
    vals = list(range(1, 101))
    assert devtrace.percentile(vals, 95) == 95
    assert devtrace.percentile(vals, 50) == 50
    assert devtrace.percentile([3.0], 95) == 3.0
    # 20 values: the 19th smallest is the 95th percentile
    assert devtrace.percentile(list(range(20, 0, -1)), 95) == 19


# (name, start us, duration us): two overlapping kernels, a copy, a gap
EVENTS = [
    ("void at::native::vectorized_elementwise_kernel<4>", 0.0, 10.0),
    ("(anonymous namespace)::find_closest_kernel<4, 2, 1>", 5.0, 20.0),
    ("Memcpy DtoH (Device -> Pageable)", 40.0, 10.0),
    ("shade_bwd_kernel", 60.0, 20.0),
]


def test_busy_idle_and_gaps():
    assert devtrace.busy_us(EVENTS) == 25.0 + 10.0 + 20.0
    gaps = devtrace.idle_gaps(EVENTS, 0.0, 100.0)
    assert gaps == [(25.0, 40.0), (50.0, 60.0), (80.0, 100.0)]


def test_aten_share():
    # ATen 10 + copy 10 of 60 device microseconds
    assert devtrace.aten_share(EVENTS) == pytest.approx(20.0 / 60.0)
    assert devtrace.aten_share([]) is None
    assert devtrace.is_aten("ampere_sgemm_128x64_tn")
    assert not devtrace.is_aten("hitrec_kernel")


def test_breakdown_lists():
    top = devtrace.top_ops(EVENTS, n=2)
    assert [n for n, _ in top] == [
        "(anonymous namespace)::find_closest_kernel<4, 2, 1>",
        "shade_bwd_kernel"]
    assert top[0][1] == pytest.approx(20e-6)
    host = [("aten::nonzero", 20.0, 30.0), ("aten::item", 22.0, 5.0),
            ("aten::copy_", 78.0, 30.0)]
    gaps = dict(devtrace.gaps_by_host(EVENTS, host, 0.0, 100.0))
    # the innermost host operation at each gap's start names it
    assert gaps == pytest.approx({"aten::item": 15e-6, "host": 10e-6,
                                  "aten::copy_": 20e-6})


def ctx(kind, **kw):
    base = dict(kind=kind, device_events=EVENTS, busy_s=55e-6,
                window_s=100e-6, window_units=4, launches=780,
                shapes=dict(rays_per_launch=491520.0, triangles=3042,
                            spheres=4))
    base.update(kw)
    return SimpleNamespace(**base)


def test_readers():
    assert harness.reader("device_idle_pct.frame")(ctx("frame")) \
        == pytest.approx(45.0)
    assert harness.reader("device_idle_pct.step")(ctx("step")) \
        == pytest.approx(45.0)
    assert harness.reader("aten_share_pct.step")(ctx("step")) \
        == pytest.approx(100.0 / 3.0)
    assert harness.reader("cuda_launches_per_frame")(ctx("frame")) == 195.0
    assert harness.reader("cuda_launches_per_step")(ctx("step")) == 195.0
    # a pair of a frame's and a step's metric is one reader
    for name in ("device_idle_pct", "aten_share_pct"):
        assert harness.reader(name + ".frame") is \
            harness.reader(name + ".step")
    # busy time over the wall time is not clipped away
    assert harness.reader("device_idle_pct.frame")(
        ctx("frame", busy_s=110e-6)) == pytest.approx(-10.0)
    # nothing to read: nothing returned
    assert harness.reader("aten_share_pct.frame")(
        ctx("frame", device_events=[])) is None
    assert harness.reader("device_idle_pct.frame")(
        ctx("frame", busy_s=None)) is None
    assert harness.reader("cuda_launches_per_step")(
        ctx("step", window_units=0)) is None


def test_busy_over_wall_refuses_the_run():
    """A busy time that passes the traced wall time is a wrong count: the
    run gives no result rather than an idle share of nought."""
    over = [("find_closest_kernel", 0.0, 102.0)]
    tracer = SimpleNamespace(done=True, n_units=1, wall=100e-6,
                             events=lambda: (over, [], 0.0, 100.0))
    win = SimpleNamespace(unit="frame", units=1, shapes={})
    cell = SimpleNamespace(name="c", traffic={})
    with pytest.raises(harness.RunError, match="busy"):
        harness.trace_context(cell, tracer, win, 1, None)
    tracer.events = lambda: ([("find_closest_kernel", 0.0, 100.5)], [], 0.0,
                             100.0)
    assert harness.trace_context(cell, tracer, win, 1, None).busy_s \
        == pytest.approx(100.5e-6)


def test_roofline_readers():
    c = ctx("frame")
    least = peaks.least_seconds(find_closest.bytes_per_launch(
        491520.0, 3042, 4))
    assert harness.reader("find_closest_roofline_pct.frame")(c) \
        == pytest.approx(100.0 * least / 20e-6)
    c = ctx("step", shapes=dict(rays_per_launch=1 << 20, triangles=3042,
                                spheres=4))
    least = peaks.least_seconds(shade_bwd.bytes_per_launch(1 << 20))
    assert harness.reader("shade_bwd_roofline_pct.step")(c) \
        == pytest.approx(100.0 * least / 20e-6)
    assert harness.reader("shade_bwd_roofline_pct.step")(
        ctx("step", device_events=EVENTS[:3])) is None


def test_frame_counts_real_rays_not_the_pad():
    """A 720p 8-spp frame is 14.06 chunks of 524,288 paths, 15 launches a
    bounce: a launch searches 491,520 real rays on average, not 524,288."""
    from benchmark.loops import frames

    tr = harness.find_cell("standin-frame-720p").traffic
    assert frames.rays_per_launch(tr["width"] * tr["height"], tr["spp"],
                                  tr["spb"], tr["rays_per_chunk"]) \
        == 1280 * 720 * 8 / 15 == 491520.0
    # no pad: the launch's width; two batches of a chunk: half the samples
    assert frames.rays_per_launch(64, 4, 4, 128) == 128.0
    assert frames.rays_per_launch(64, 8, 4, 128) == 128.0
    assert frames.rays_per_launch(40, 2, 2, 32) == 80 / 3


def test_roofline_bytes_from_shapes():
    # a ray: origin, direction, time, t_min in; primitive id and t out
    assert find_closest.bytes_per_launch(1, 0, 0) == 40
    assert find_closest.bytes_per_launch(524288, 3042, 4) \
        == 524288 * 40 + 3042 * 36 + 4 * 36
    assert find_closest.bytes_per_launch(0, 0, 486) == 486 * 36
    # 72 float inputs and 6 int kinds, 13 cotangents, 72 gradients a ray
    assert shade_bwd.bytes_per_launch(1) == (72 + 6 + 13 + 72) * 4 + 24
    assert shade_bwd.bytes_per_launch(1 << 20) \
        == (1 << 20) * 652 + 24
    assert peaks.least_seconds(bytes_=3.35e12) == 1.0
    assert peaks.least_seconds(flops=67e12, bytes_=1.0) == 1.0
    assert math.isclose(peaks.least_seconds(bytes_=6.7e12, flops=67e12), 2.0)
