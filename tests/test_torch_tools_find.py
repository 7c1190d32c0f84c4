"""``sexy_raytracer_tpu_torch.tools.check_find_referee`` and
``tools.diag_r5`` on the CPU: the tile order against an independent numpy
statement, the float64 referee and the compacted find against the port's
bruteforce find (the same ids except near ties), and each command line
at toy size."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sexy_raytracer_tpu_torch.models import presets  # noqa: E402
from sexy_raytracer_tpu_torch.ops.intersect import (  # noqa: E402
    find_hit_bruteforce,
)
from sexy_raytracer_tpu_torch.render.camera import Camera  # noqa: E402
from sexy_raytracer_tpu_torch.tools import check_find_referee as referee  # noqa: E402
from sexy_raytracer_tpu_torch.tools import diag_r5  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def standin():
    scene, cfg = presets.flagship_standin(n=12, height=72, device="cpu")
    return scene, cfg, Camera.from_config(cfg.camera, cfg.aspect,
                                          device="cpu")


@pytest.mark.parametrize("size", [(128, 72), (100, 37), (32, 16)])
def test_tile_order_ids(size):
    """Every pixel once, ordered by (tile row, tile column, row, column)
    of 32x16 tiles, the last ones clipped to the image."""
    W, H = size
    y, x = np.divmod(np.arange(W * H), W)
    want = np.lexsort((x, y, x // referee.TW, y // referee.TH))
    np.testing.assert_array_equal(referee.tile_order_ids(W, H), want)


def _tie(a, b):
    return referee.near_tie(a.numpy(), b.numpy())


def test_f64_referee_agrees_with_bruteforce(standin, monkeypatch):
    """On random camera rays, wherever the port's bruteforce find hits a
    triangle, the float64 referee names the same triangle, or one whose
    t is a near tie of it."""
    scene, cfg, camera = standin
    monkeypatch.setattr(referee, "R", 2048)
    org, dirs, times = referee.make_rays(camera, cfg.width, cfg.height, 1,
                                         "random")
    p0, t0 = find_hit_bruteforce(scene, org, dirs, times)
    T = scene.num_triangles
    v0, v1, v2 = (getattr(scene, k).numpy().astype(np.float64)
                  for k in ("tri_v0", "tri_v1", "tri_v2"))
    on_tri = np.nonzero((p0 < T).numpy() & (p0 >= 0).numpy())[0]
    assert on_tri.size > 100
    o64, d64 = (a.numpy().astype(np.float64) for a in (org, dirs))
    off = 0
    for i in on_tri:
        ref_i, ref_t = referee.f64_tri_all(v0, v1, v2, o64[i], d64[i])
        if ref_i != int(p0[i]):
            off += 1
            assert referee.near_tie(np.float64(ref_t), float(t0[i])), i
    assert off <= 0.01 * on_tri.size, off


def test_referee_on_the_cpu(standin, monkeypatch):
    """The port's walk (``method="pallas"``'s plain version on CPU
    tensors) against its bruteforce find: no mismatch outside the near-tie
    rule, every mismatch adjudicated."""
    scene, cfg, camera = standin
    monkeypatch.setattr(referee, "R", 8192)
    rays = referee.make_rays(camera, cfg.width, cfg.height, 3, "random")
    res = referee.referee(scene, *rays)
    assert res["rays"] == referee.R
    assert res["outside_tie_rule"] == 0
    assert res["adjudicated"] == min(res["mismatches"], referee.ADJUDICATED)
    assert res["new_correct"] + res["bf_correct"] + res["neither"] \
        == res["adjudicated"]


@pytest.mark.parametrize("mode", referee.MODES)
def test_make_rays_modes(standin, mode, monkeypatch):
    """``R`` finite rays a mode, the same for the same seed and not for
    another."""
    scene, cfg, camera = standin
    monkeypatch.setattr(referee, "R", 1024)
    W, H = cfg.width, cfg.height
    tiled = referee.tile_order_ids(W, H)
    org, dirs, times = referee.make_rays(camera, W, H, 2, mode, tiled)
    assert org.shape == dirs.shape == (1024, 3) and times.shape == (1024,)
    assert all(bool(torch.isfinite(a).all()) for a in (org, dirs, times))
    assert torch.equal(referee.make_rays(camera, W, H, 2, mode, tiled)[1],
                       dirs)
    assert not torch.equal(referee.make_rays(camera, W, H, 5, mode,
                                             tiled)[1], dirs)


def _wavefront(scene, cfg, camera, n=2048):
    """A bounce-2 wavefront of the diag's train batch, with its dead
    lanes (t_min 3e38)."""
    from sexy_raytracer_tpu_torch.diff.inverse import sample_tile_ids
    from sexy_raytracer_tpu_torch.utils import rng

    W, H = cfg.width, cfg.height
    pid = torch.from_numpy(sample_tile_ids(np.random.default_rng(0), W, H,
                                           n))
    keys = rng.ray_keys_2d(rng.key(0), pid, torch.zeros_like(pid))
    u5 = rng.per_ray_uniform_block(keys, 5)
    u = ((pid % W).float() + u5[:, 0]) / (W - 1)
    v = ((H - (pid // W).float()) + u5[:, 1]) / (H - 1)
    org, d, t = camera.get_rays(u, v, u5[:, 2:5])
    alive = torch.ones(n, dtype=torch.bool)
    for b in range(2):
        org, d, a = diag_r5.advance(scene, org.contiguous(), d.contiguous(),
                                    t, keys, b)
        alive &= a
    return org, d, t, torch.where(alive, 0.001, 3.0e38), alive


def test_diag_compaction_matches_bruteforce(standin):
    """The compacted find on a wavefront with dead lanes: dead lanes miss,
    and the live lanes' ids are the bruteforce find's except exact ties
    between clusters (where the walk's t equals the bruteforce t)."""
    from sexy_raytracer_tpu_torch.ops.intersect import find_hit

    scene, cfg, camera = standin
    org, d, t, t_min, alive = _wavefront(scene, cfg, camera)
    assert 0 < int(alive.sum()) < alive.numel()
    p_c = diag_r5.find_compact(scene, org, d, t, t_min)
    p_b, t_b = find_hit_bruteforce(scene, org, d, t, t_min=t_min)
    _, t_w = find_hit(scene, org, d, t, t_min=t_min, method="auto")
    assert (p_c[~alive] == -1).all() and (p_c[alive] >= -1).all()
    dis = p_c != p_b
    assert float(dis.float().mean()) <= 0.01
    assert torch.equal(t_w[dis], t_b[dis])
    assert torch.equal(p_c, diag_r5.find_plain(scene, org, d, t, t_min)) \
        or _tie(t_w, t_b).all()


def test_referee_command_line_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(referee, "R", 1024)
    assert referee.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "scene: flagship_standin"
    res = json.loads(lines[-1])
    assert res["rays"] == 1024 and res["outside_tie_rule"] == 0
    assert sorted(res["ms"]) == sorted(referee.MODES)
    assert res["device"] == "cpu"


def test_diag_command_line_on_the_cpu(monkeypatch, capsys, tmp_path):
    """``main(["--json", "--device", "cpu"])`` at 1,024 rays a population:
    the four measurements' keys, compaction parity 0, the JSON written."""
    monkeypatch.setattr(diag_r5, "R", 1024)
    monkeypatch.setattr(diag_r5, "JSON_OUT", str(tmp_path / "diag.json"))
    assert diag_r5.main(["--json", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "scene: flagship_standin"
    res = json.loads(lines[-1])
    assert res == json.loads((tmp_path / "diag.json").read_text())
    pops = ["primary_top(bench fwd)", "primary_random_tiles(train)",
            "primary_mid_frame"] + [f"bounce{b}_wavefront" for b in (1, 2, 3)]
    for pop in pops:
        assert res[f"find[{pop}]"] > 0
    for b in (1, 2, 3):
        assert res[f"compact_parity[bounce{b}_wavefront]"] == 0
        assert 0 <= res[f"alive_frac_b{b}"] <= 1
    for pop in ("primary_random_tiles(train)", "bounce2_wavefront"):
        assert res[f"cull_mean_active[{pop}]"] >= 0
    assert {f"frame_dispatch[{r}]" for _, r in diag_r5.FRAME_REGIONS} \
        <= set(res)
