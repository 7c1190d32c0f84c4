"""``sexy_raytracer_tpu_torch.tools.run_flagship_render`` against the root
``tools/run_flagship_render.py`` (loaded from its path, unedited): the
golden regions and the report's ``region_*`` entries on a synthetic
golden, the checkpoint resume bit for bit, and the command line on the
CPU at toy size."""

import dataclasses
import importlib.util
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sexy_raytracer_tpu_torch.models import presets  # noqa: E402
from sexy_raytracer_tpu_torch.render import renderer  # noqa: E402
from sexy_raytracer_tpu_torch.tools import run_flagship_render as tool  # noqa: E402
from sexy_raytracer_tpu_torch.utils.png import read_png  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def jtool():
    spec = importlib.util.spec_from_file_location(
        "jax_run_flagship_render", REPO / "tools" / "run_flagship_render.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_regions_match_jax_tool(jtool):
    """The same region map; on a synthetic 720p golden and radiance, each
    ``region_<name>`` entry is the linear region mean against the golden's
    squared mean, with the JAX tool's rounding and pass rule."""
    assert tool.REGIONS == jtool.REGIONS
    r = np.random.default_rng(2)
    golden = r.integers(0, 256, (720, 1280, 3), dtype=np.uint8)
    spp = 16
    accum = (golden.astype(np.float32) / 255.0) ** 2 * spp
    accum[:300] *= 1.05          # the sky and the torso drift
    accum[600:] += 0.5 * spp     # and the ground's far off
    report = tool.region_report(accum, spp, golden)
    assert set(report) == {f"region_{k}" for k in jtool.REGIONS} | {
        "regions_pass", "regions_failed"}
    g = golden.astype(np.float64) / 255.0
    lin = np.clip(accum / spp, 0.0, 0.998)
    failed = []
    for name, (rows, cols, tol) in jtool.REGIONS.items():
        ours = lin[rows[0]:rows[1], cols[0]:cols[1]].mean(axis=(0, 1))
        ref = (g[rows[0]:rows[1], cols[0]:cols[1]] ** 2).mean(axis=(0, 1))
        err = float(np.abs(ours - ref).max())
        entry = report[f"region_{name}"]
        assert entry["ours"] == [round(float(x), 4) for x in ours]
        assert entry["golden"] == [round(float(x), 4) for x in ref]
        assert entry["max_err"] == round(err, 4) and entry["tol"] == tol
        assert entry["pass"] == (err <= tol)
        if err > tol:
            failed.append(name)
    assert report["regions_failed"] == failed
    assert report["regions_pass"] == (not failed)
    assert "ground_right" in failed and "metal_sphere" not in failed


def _small_chunks(monkeypatch):
    """The tool's scene with 128-path chunks, so that a toy frame has
    several chunks to interrupt between."""
    real = presets.flagship

    def flagship(**kw):
        scene, cfg, name = real(**kw)
        return scene, dataclasses.replace(cfg, rays_per_chunk=128), name

    monkeypatch.setattr(tool.presets, "flagship", flagship)


def test_checkpoint_resume_is_bit_equal(monkeypatch, tmp_path):
    """A render stopped after its first chunk and resumed from its
    checkpoint equals the uninterrupted render bit for bit."""
    monkeypatch.setattr(tool, "HEIGHT", 9)
    _small_chunks(monkeypatch)
    full, _, name = tool.render(6, device="cpu")
    assert name == "flagship_standin" and full.shape == (9, 16, 3)

    class Stop(Exception):
        pass

    real, calls = renderer.render_pixels, []

    def stop_after_first_chunk(*a, **kw):
        calls.append(1)
        if len(calls) > 2:  # 6 spp in batches of 4: 2 calls a chunk
            raise Stop()
        return real(*a, **kw)

    ckpt = str(tmp_path / "ckpt.npz")
    monkeypatch.setattr(renderer, "render_pixels", stop_after_first_chunk)
    with pytest.raises(Stop):
        tool.render(6, device="cpu", checkpoint=ckpt)
    saved = np.load(ckpt)
    assert int(saved["units_done"]) == 2 and int(saved["spb"]) == 4
    assert 0 < (saved["accum"] != 0).any(axis=-1).sum() < 9 * 16
    monkeypatch.setattr(renderer, "render_pixels", real)
    resumed, _, _ = tool.render(6, device="cpu", checkpoint=ckpt)
    np.testing.assert_array_equal(resumed, full)


def test_command_line_on_the_cpu(monkeypatch, tmp_path, capsys, jtool):
    """``main(["--spp", "2", "--device", "cpu"])`` at 18 pixels high: the
    scene named first, the JAX tool's report keys (no golden here) with
    the scene and device, the full PNG and the half-size one."""
    monkeypatch.setattr(tool, "ART", str(tmp_path))
    monkeypatch.setattr(tool, "HEIGHT", 18)
    monkeypatch.setattr(tool, "GOLDEN", str(tmp_path / "absent.png"))
    assert tool.main(["--spp", "2", "--device", "cpu"]) == 0
    assert capsys.readouterr().out.splitlines()[0] == \
        "scene: flagship_standin"
    report = json.loads((tmp_path / "report.json").read_text())
    assert set(report) == {"spp", "method", "wall_s", "mpaths_per_s",
                           "scene", "device"}
    assert report["spp"] == 2 and report["device"] == "cpu"
    img = read_png(str(tmp_path / "render_18p_2spp.png"), 3)
    half = read_png(str(tmp_path / "render_9p.png"), 3)
    assert img.shape == (18, 32, 3) and half.shape == (9, 16, 3)
    np.testing.assert_array_equal(half, img[::2, ::2])
    assert not list(tmp_path.glob("*.npz"))  # the whole render's checkpoint


def test_command_line_resumes_only_its_own_render(monkeypatch, tmp_path):
    """The command line's checkpoint is named by scene, height and spp:
    an interrupted run's is resumed by the same command, which reports
    the unit it resumed from and no path rate (its wall time covers only
    the rest), and removes it; a run at another spp starts afresh."""
    monkeypatch.setattr(tool, "ART", str(tmp_path))
    monkeypatch.setattr(tool, "HEIGHT", 9)
    monkeypatch.setattr(tool, "GOLDEN", str(tmp_path / "absent.png"))
    _small_chunks(monkeypatch)
    ckpt = tool.checkpoint_path("flagship_standin", 6)
    assert pathlib.Path(ckpt).parent == tmp_path
    assert ckpt != tool.checkpoint_path("flagship_standin", 2)

    class Stop(Exception):
        pass

    real, calls = renderer.render_pixels, []

    def stop_after_first_chunk(*a, **kw):
        calls.append(1)
        if len(calls) > 2:  # 6 spp in batches of 4: 2 calls a chunk
            raise Stop()
        return real(*a, **kw)

    monkeypatch.setattr(renderer, "render_pixels", stop_after_first_chunk)
    with pytest.raises(Stop):
        tool.main(["--spp", "6", "--device", "cpu"])
    monkeypatch.setattr(renderer, "render_pixels", real)
    assert int(np.load(ckpt)["units_done"]) == 2

    assert tool.main(["--spp", "2", "--device", "cpu"]) == 0
    report = json.loads((tmp_path / "report.json").read_text())
    assert "resumed_from_unit" not in report
    assert report["mpaths_per_s"] is not None
    assert pathlib.Path(ckpt).exists()  # another spp's: not touched

    assert tool.main(["--spp", "6", "--device", "cpu"]) == 0
    report = json.loads((tmp_path / "report.json").read_text())
    assert report["resumed_from_unit"] == 2
    assert report["mpaths_per_s"] is None
    assert not list(tmp_path.glob("*.npz"))
    full, _, _ = tool.render(6, device="cpu")
    img = read_png(str(tmp_path / "render_9p_6spp.png"), 3)
    np.testing.assert_array_equal(
        img, tool.colorlib.to_uint8(tool.colorlib.resolve(full, 6)))

