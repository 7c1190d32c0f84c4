"""The port's command line (``python -m sexy_raytracer_tpu_torch``)
against the JAX package's, both on the CPU at a toy size: ``render`` of
``shirley_parity`` at 32x18 and 2 spp, with the default seed and with
``--seed -1``, and ``inverse`` for 3 steps of 64 pixels at 2 bounces. The frames are
held to the trace parity budget of ``tests/test_torch_render.py`` (0.5% of
uint8 values may differ by more than 1), the losses within relative 1e-3.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from sexy_raytracer_tpu import __main__ as jmain  # noqa: E402
from sexy_raytracer_tpu_torch import __main__ as tmain  # noqa: E402
from sexy_raytracer_tpu_torch.utils.png import read_png, write_png  # noqa: E402

TOY = ["--preset", "shirley_parity", "--height", "18", "--spp", "2"]


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _assert_frames_close(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    off = np.abs(got.astype(int) - want.astype(int)) > 1
    assert off.mean() <= 0.005, f"{off.sum()}/{off.size} values differ by > 1"


def _render_both(tmp_path, *extra):
    tag = "_".join(extra).replace("-", "m") or "default"
    jp, tp = tmp_path / f"jax_{tag}.png", tmp_path / f"port_{tag}.png"
    assert jmain.main(["render", *TOY, *extra, "--out", str(jp)]) == 0
    assert tmain.main(["render", *TOY, *extra, "--device", "cpu",
                       "--out", str(tp)]) == 0
    return read_png(str(tp)), read_png(str(jp))


@pytest.mark.parametrize("seed", [None, "-1"])
def test_render_matches_jax(tmp_path, seed, capsys):
    extra = () if seed is None else ("--seed", seed)
    got, want = _render_both(tmp_path, *extra)
    assert got.shape == (18, 32, 3) and got.std() > 5
    _assert_frames_close(got, want)
    err = capsys.readouterr().err
    assert "rendering shirley_parity: 32x18, 2 spp, 4 bounces, 0 tris, " \
           "486 spheres" in err
    assert "Mpaths/s" in err and "Mray-casts/s" in err


def test_negative_seed_keys_the_low_word(tmp_path):
    """``--seed -1`` renders what ``--seed 4294967295`` renders (jax keys a
    seed by its low 32 bits), and not what the default seed renders."""
    a = tmp_path / "m1.png"
    b = tmp_path / "u32.png"
    c = tmp_path / "s0.png"
    for seed, out in (("-1", a), ("4294967295", b), ("0", c)):
        assert tmain.main(["render", *TOY, "--seed", seed, "--device", "cpu",
                           "--out", str(out)]) == 0
    np.testing.assert_array_equal(read_png(str(a)), read_png(str(b)))
    assert not np.array_equal(read_png(str(a)), read_png(str(c)))


def test_inverse_matches_jax(tmp_path, capsys):
    target = np.random.default_rng(3).integers(0, 256, (18, 32, 3))
    tgt = tmp_path / "target.png"
    write_png(str(tgt), target.astype(np.uint8))
    # 2 bounces: JAX's train step compiles in about half the time of 4
    args = ["inverse", *TOY, "--max-bounce", "2", "--target", str(tgt),
            "--steps", "3", "--pixels-per-step", "64", "--spb", "2",
            "--preview-spp", "2"]
    jl, tl = tmp_path / "jax_losses.json", tmp_path / "port_losses.json"
    jo, to = tmp_path / "jax_opt.png", tmp_path / "port_opt.png"
    assert jmain.main([*args, "--losses-out", str(jl), "--out", str(jo)]) == 0
    assert tmain.main([*args, "--device", "cpu", "--losses-out", str(tl),
                       "--out", str(to)]) == 0
    want, got = json.loads(jl.read_text()), json.loads(tl.read_text())
    assert len(got) == len(want) == 3 and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-3)
    assert read_png(str(to)).shape == read_png(str(jo)).shape == (18, 32, 3)
    assert "loss: first" in capsys.readouterr().err


def test_inverse_refuses_a_target_of_another_size(tmp_path, capsys):
    tgt = tmp_path / "small.png"
    write_png(str(tgt), np.zeros((9, 16, 3), np.uint8))
    assert tmain.main(["inverse", *TOY, "--target", str(tgt),
                       "--device", "cpu"]) == 1
    assert "target is 16x9, render is 32x18" in capsys.readouterr().err


def test_cli_surface():
    """No ``bench`` subcommand (an argparse error), an unknown preset
    named with the list, and the card as the default device: without one
    the build fails instead of falling back to the CPU."""
    with pytest.raises(SystemExit) as e:
        tmain.main(["bench"])
    assert e.value.code == 2
    with pytest.raises(SystemExit, match="unknown preset 'nope'; available: "
                                         "cube, masterchief"):
        tmain.main(["render", "--preset", "nope", "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            tmain.main(["render", *TOY])


def test_render_reaches_the_ports_own_presets(tmp_path, capsys):
    """``--preset`` also takes the port's own presets, which the JAX
    package has not: the Cornell box at 12 x 12 and 2 spp, at the book's
    50 bounces on its black background."""
    out = tmp_path / "cornell.png"
    assert tmain.main(["render", "--preset", "cornell_box", "--height", "12",
                       "--spp", "2", "--device", "cpu",
                       "--out", str(out)]) == 0
    img = read_png(str(out))
    assert img.shape == (12, 12, 3) and img.max() > 0
    assert "rendering cornell_box: 12x12, 2 spp, 50 bounces, 36 tris, " \
           "0 spheres" in capsys.readouterr().err


def test_inverse_render_refuses_a_negative_seed():
    """``inverse_render`` draws its tiles with ``np.random.default_rng(seed)``
    in both packages, which refuses a negative seed before any step."""
    from sexy_raytracer_tpu.diff.inverse import inverse_render as j_inverse
    from sexy_raytracer_tpu.models import presets as jpresets
    from sexy_raytracer_tpu_torch.diff.inverse import inverse_render
    from sexy_raytracer_tpu_torch.models import presets as tpresets

    target = np.zeros((18, 32, 3), np.float32)
    tscene, cfg = tpresets.shirley_parity(height=18, spp=1, device="cpu")
    jscene, jcfg = jpresets.shirley_parity(height=18, spp=1)
    with pytest.raises(ValueError) as terr:
        inverse_render(tscene, target, cfg, n_steps=1, seed=-1,
                       progress=False)
    with pytest.raises(ValueError) as jerr:
        j_inverse(jscene, target, jcfg, n_steps=1, seed=-1, progress=False)
    assert str(terr.value) == str(jerr.value)
