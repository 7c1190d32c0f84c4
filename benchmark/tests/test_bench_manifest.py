"""The manifest against the benchmark's contract, and the harness finding
a cell by the names in it."""

from __future__ import annotations

import json
import re
import shutil
from pathlib import Path

import pytest

from benchmark import harness

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert 1 <= MAN["run_seconds"] <= 51
    assert MAN["command"][:2] == ["python3", "benchmark/run.py"]


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_names_and_units(section):
    names = [e["name"] for e in MAN[section]]
    assert len(names) == len(set(names))
    for e in MAN[section]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for k in e.get("reduced", []):
            assert NAME.match(k)
        for text in (e.get("why"), e.get("layer"), e.get("source")):
            if text is not None:
                assert 1 <= len(text) <= 200 and "\n" not in text \
                    and "\t" not in text


def test_bounds():
    for m in MAN["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in MAN["end_to_end"])


def _reports(cell, section):
    return {m["name"] for m in MAN[section]
            if "workloads" not in m or cell in m["workloads"]}


def test_each_metric_moves_an_end_to_end_metric_its_cells_report():
    e2e = {m["name"] for m in MAN["end_to_end"]}
    for m in MAN["per_layer"]:
        assert m["moves"] in e2e
        cells = m.get("workloads", [w["name"] for w in MAN["workloads"]])
        for cell in cells:
            assert m["moves"] in _reports(cell, "end_to_end"), (m, cell)


def test_each_cell_reports_enough():
    for w in MAN["workloads"]:
        e2e = _reports(w["name"], "end_to_end")
        assert "setup_s" in e2e and len(e2e) >= 2
        assert _reports(w["name"], "per_layer")
        assert w["chips"] in (1, 4)


def test_files_of_every_name_exist():
    bench = ROOT / MAN["paths"][0]
    used = {w["config"] for w in MAN["workloads"]}
    assert used == {c["name"] for c in MAN["configs"]}
    for c in MAN["configs"]:
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["name"] == c["name"]
        assert sorted(conf["reduced"]) == sorted(c["reduced"])
    for w in MAN["workloads"]:
        assert (bench / "traffic" / f"{w['traffic']}.json").exists()
        assert (bench / "limits" / f"{w['name']}.json").exists()
    for m in MAN["per_layer"]:
        assert callable(harness.reader(m["name"]))


def test_a_new_cell_is_found_without_editing_a_file(tmp_path):
    """A cell added by new files and a new manifest entry only."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    traffic = json.loads(
        (ROOT / "benchmark/traffic/frames-720p-8spp.json").read_text())
    traffic.update(width=640, height=360)
    (tmp_path / "benchmark/traffic/frames-360p-8spp.json").write_text(
        json.dumps(traffic))
    (tmp_path / "benchmark/limits/shirley-frame-360p.json").write_text(
        json.dumps({"pixel_mismatch_pct": 1.0}))
    man["workloads"].append({"name": "shirley-frame-360p",
                             "config": "shirley-final",
                             "traffic": "frames-360p-8spp", "chips": 1,
                             "why": "a smaller frame"})
    for m in man["end_to_end"] + man["per_layer"]:
        if "frame_s" in (m["name"], m.get("moves")):
            m["workloads"].append("shirley-frame-360p")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    cell = harness.find_cell("shirley-frame-360p", root=tmp_path)
    assert cell.traffic["width"] == 640
    assert cell.config["name"] == "shirley-final"
    assert cell.limits == {"pixel_mismatch_pct": 1.0}
    assert {m["name"] for m in cell.end_to_end} == {
        "setup_s", "frame_s", "peak_mem_gib"}
    assert "device_idle_pct.frame" in {m["name"] for m in cell.per_layer}
    assert harness.loop_of(cell).__name__ == "benchmark.loops.frames"
