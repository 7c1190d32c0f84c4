"""Whole runs at toy size on the CPU: a sound run is correct, the control
and every fault the cell can have are not, and a run without a card
prints no result."""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark import faults, harness
from benchmark.tests.toy import CELLS, run, toy_cell

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    out = run(name)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    assert set(out["checks"]) == set(toy_cell(name).limits)
    e2e = {m["name"] for m in toy_cell(name).end_to_end}
    assert set(out["metrics"]) <= e2e and "setup_s" in out["metrics"]


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    """The reference in bfloat16, put in the program's place."""
    out = run(name, control="bf16")
    assert not out["correct"], out["checks"]


FAULTS = [(c, f) for c in CELLS for f in (
    faults.FIT_FAULTS if c == "standin-inverse-crn" else faults.FRAME_FAULTS)]


@pytest.mark.parametrize("name,fault", FAULTS)
def test_planted_fault_is_not_correct(name, fault):
    drv = harness.loop_of(toy_cell(name))
    with faults.planted(drv, fault):
        out = run(name, seconds=0.3)
    assert not out["correct"], (fault, out["checks"])


def test_fit_check_follows_the_windows_steps():
    """A fault that starts once set-up's steps are done passes the set-up
    numbers and fails the window's: the window's own steps are checked."""
    name = "standin-inverse-crn"
    drv = harness.loop_of(toy_cell(name))
    with faults.planted(drv, "late_half"):
        out = run(name, seconds=0.3)
    checks = out["checks"]
    assert not out["correct"]
    assert all(v["value"] <= v["limit"] for k, v in checks.items()
               if not k.startswith("window_"))
    assert any(v["value"] > v["limit"] for k, v in checks.items()
               if k.startswith("window_"))


@pytest.mark.parametrize("name", ["standin-frame-720p", "standin-inverse-crn"])
def test_traced_run_reports_per_layer_metrics_only(name):
    out = run(name, trace=1)
    per_layer = {m["name"] for m in toy_cell(name).per_layer}
    assert set(out["metrics"]) <= per_layer
    assert out["correct"]


def _run_cli(cwd, env=None):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "standin-frame-720p", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=cwd, capture_output=True, text=True,
        timeout=300, env=env)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = _run_cli(ROOT)
    assert p.returncode != 0
    assert "{" not in p.stdout
    assert "CUDA" in p.stderr


def test_without_the_program_no_result(tmp_path):
    """A folder with only the manifest and the benchmark's files."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = _run_cli(tmp_path, env)
    assert p.returncode != 0
    assert "{" not in p.stdout


def test_unknown_workload_no_result():
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "nope", "--seed",
         "1", "--seconds", "1"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert p.returncode != 0 and "{" not in p.stdout


@pytest.mark.cuda
def test_control_fails_at_the_cells_size_on_the_card():
    """On the card: the control on three seeds at each cell's own size."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from benchmark import calibrate

    dev = harness.Device(torch, "cuda")
    for name in CELLS:
        cell = harness.find_cell(name)
        drv = harness.loop_of(cell)
        for seed in (11, 12, 13):
            r = calibrate.one(cell, drv, seed, 1.0, dev, controls=("bf16",))
            assert all(v <= cell.limits[k] for k, v in r["program"].items())
            assert any(v > cell.limits[k] for k, v in r["bf16"].items())
