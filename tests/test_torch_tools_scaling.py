"""``sexy_raytracer_tpu_torch.tools.run_scaling_curve`` on gloo CPU ranks
at toy size (256 pixels of an 18-pixel-high stand-in a chunk): one and two
ranks, the two-rank chunk within the trace parity budget of the one-rank
chunk (atol 2e-5, rtol 1e-5, 0.5% of pixels), the artifact's keys, the
counts it cannot run on cards named as not measured, and the command
line. Ranks run one torch thread each."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sexy_raytracer_tpu_torch.tools import run_scaling_curve as tool  # noqa: E402

TOY = dict(pixels=256, height=18)
ROW_KEYS = {"n_devices", "seconds_per_chunk", "mrays_per_s",
            "launches_per_chunk", "speedup_vs_1",
            "efficiency_vs_core_ceiling"}


def test_one_and_two_cpu_ranks():
    art, chunks = tool.curve("cpu", (1, 2), **TOY)
    assert set(art) == {"WARNING", "devices", "host_physical_cores", "note",
                        "rows", "not_measured"}
    assert "NOT multi-chip scaling evidence" in art["WARNING"]
    assert art["devices"] == "cpu" and art["not_measured"] == []
    assert [r["n_devices"] for r in art["rows"]] == [1, 2]
    for r in art["rows"]:
        assert set(r) == ROW_KEYS and r["mrays_per_s"] > 0
        assert not any(r["launches_per_chunk"].values())  # CPU: no kernel
    assert art["rows"][0]["speedup_vs_1"] == 1.0
    one, two = chunks[1], chunks[2]
    assert one.shape == two.shape == (TOY["pixels"], 3)
    assert np.isfinite(one).all() and one.std() > 0
    close = np.isclose(two, one, atol=2e-5, rtol=1e-5).all(axis=-1)
    assert close.mean() >= 0.995, np.argwhere(~close)[:20]


def test_counts_past_the_cards_are_not_measured(monkeypatch):
    """With fewer cards than ranks, nothing is spawned for those counts;
    each is listed with its reason."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    art, chunks = tool.curve("cuda")
    assert art["rows"] == [] and chunks == {}
    assert [r["n_devices"] for r in art["not_measured"]] == [1, 2, 4, 8]
    for r in art["not_measured"]:
        assert f"{r['n_devices']} NCCL ranks need" in r["reason"]
    assert art["devices"] == "cuda" and "not_measured" in art["WARNING"]


def test_command_line_on_the_cpu(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(tool, "OUT_DIR", str(tmp_path))
    monkeypatch.setattr(tool, "COUNTS", (1, 2))
    monkeypatch.setattr(tool, "PIXELS", TOY["pixels"])
    monkeypatch.setattr(tool, "HEIGHT", TOY["height"])
    assert tool.main(["--device", "cpu"]) == 0
    assert capsys.readouterr().out.splitlines()[0] == \
        "scene: flagship_standin"
    art = json.loads((tmp_path / "scaling_cpu.json").read_text())
    assert art["scene"] == "flagship_standin" and art["device"] == "cpu"
    assert [r["n_devices"] for r in art["rows"]] == [1, 2]
    assert not (tmp_path / "scaling.json").exists()
