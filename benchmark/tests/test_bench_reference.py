"""The frozen plain reference against the program's CPU path on toy
sizes, and the benchmark's scene files against the program's presets."""

from __future__ import annotations

import dataclasses
import importlib

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.loops import common
from benchmark.reference import render as ref
from benchmark.reference import rng as ref_rng
from benchmark.tests.toy import toy_cell

DEV = harness.Device(torch, "cpu")


@pytest.mark.parametrize("name,preset,kw", [
    ("standin-frame-720p", "flagship_standin", dict(n=39)),
    ("shirley-frame-720p", "shirley_parity", dict(seed=42)),
])
def test_scene_files_match_the_programs_presets(name, preset, kw, tmp_path):
    """The benchmark's frozen scenes, through the program's
    ``SceneBuilder``, are the program's presets field for field (triangles
    in its order on both)."""
    from sexy_raytracer_tpu_torch.models import presets

    cell = toy_cell(name)
    _, ours, _ = common.program_scene(cell, 5, DEV, 32, 18, 2)
    extra = dict(data_dir=str(tmp_path), build_bvh=False) \
        if preset == "flagship_standin" else {}
    theirs, cfg = getattr(presets, preset)(device="cpu", **kw, **extra)
    for field in ours._fields:
        if field.startswith("bvh_"):
            continue
        a, b = getattr(ours, field), getattr(theirs, field)
        assert torch.equal(a, b), field
    assert cfg.max_bounce == cell.config["max_bounce"]
    assert list(cfg.camera.eye) == cell.config["camera"]["eye"]


@pytest.mark.parametrize("name", ["standin-frame-720p", "shirley-frame-720p"])
def test_reference_pixels_match_the_program(name):
    """Every path of a small frame, the program's fused integrator on the
    CPU against the reference."""
    from sexy_raytracer_tpu_torch.render.renderer import render_accumulate

    cell = toy_cell(name)
    desc, scene, cfg = common.program_scene(cell, 3, DEV, 40, 24, 4)
    cfg = dataclasses.replace(cfg, seed=123456789, samples_per_batch=4,
                              rays_per_chunk=1024)
    got = render_accumulate(scene, cfg).reshape(-1, 3)
    sc = ref.scene_arrays(desc, "cpu")
    cam = ref.camera(cell.config["camera"], 40 / 24, "cpu")
    want = ref.render_pixels(
        sc, sc["atlas"], cam, torch.arange(40 * 24), ref_rng.key(123456789),
        width=40, height=24, spb=4, max_bounce=4,
        background=cfg.background).numpy()
    close = np.isclose(got, want, rtol=1e-4, atol=1e-4).all(axis=1)
    assert close.mean() >= 0.99, close.mean()
    assert abs(got.sum() - want.sum()) <= 1e-3 * abs(want.sum())


def test_reference_rng_is_the_programs():
    from sexy_raytracer_tpu_torch.utils import rng

    k = rng.key(2**31 + 5)
    pid = torch.arange(1000, dtype=torch.int64)
    sid = pid % 8
    a = rng.per_ray_uniform_block(rng.ray_keys_2d(k, pid, sid), 6)
    b = ref_rng.uniforms(ref_rng.ray_keys(ref_rng.key(2**31 + 5), pid, sid),
                         6)
    assert torch.equal(a, b)


def test_reference_scene_worked_out_again():
    """The reference's own bake: the relief's texel pack and the material
    kinds the program's ``SceneBuilder`` gives."""
    cell = toy_cell("standin-frame-720p")
    desc, scene, _ = common.program_scene(cell, 3, DEV, 32, 18, 2)
    sc = ref.scene_arrays(desc, "cpu")
    assert torch.equal(sc["atlas"], scene.shade_atlas)
    for ours, theirs in [("kind_albedo", "mat_albedo_kind"),
                         ("kind_normal", "mat_normal_kind"),
                         ("kind_metal", "mat_metal_kind"),
                         ("kind_rough", "mat_rough_kind"),
                         ("kind_type", "mat_type")]:
        assert sc[ours].tolist() == getattr(scene, theirs).tolist()
    assert sc["tri_v0"].shape == scene.tri_v0.shape


def test_reference_does_not_import_the_program():
    mods = [importlib.import_module(f"benchmark.reference.{m}")
            for m in ("rng", "render", "fit")]
    for m in mods:
        assert "sexy_raytracer_tpu_torch" not in m.__dict__
