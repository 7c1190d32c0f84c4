"""Frames back to back: one user rendering, a closed loop.

Every frame is ``render_accumulate`` of the whole image at the traffic's
size and samples per pixel, with its own render key: frame ``i`` of a run
seeded ``s`` renders with ``frame_seed(s, i)``, so no two frames trace the
same paths and a frame handed back twice reads wrong. After each frame the
window keeps its radiance at a sample of pixels drawn from the seed; once
the window has closed, the plain reference renders those pixels of the
last frame and of up to ``check_frames - 1`` more drawn from the seed, at
the same keys, and the check compares the two.
"""

from __future__ import annotations

import dataclasses
import time
from types import SimpleNamespace

import numpy as np
import torch

from benchmark import compare, harness
from benchmark.loops import common
from benchmark.reference import render as ref
from benchmark.reference import rng as ref_rng
from sexy_raytracer_tpu_torch.render.renderer import render_accumulate


def frame_seed(seed: int, i: int) -> int:
    return (int(seed) * 2654435761 + 7919 * (i + 1)) % (1 << 32)


def setup(cell, seed, dev, log):
    tr = cell.traffic
    desc, scene, cfg = common.program_scene(cell, seed, dev, tr["width"],
                                            tr["height"], tr["spp"])
    cfg = dataclasses.replace(cfg, samples_per_batch=tr["spb"],
                              rays_per_chunk=tr["rays_per_chunk"])
    rs = np.random.default_rng([int(seed) % (1 << 63), 17])
    n_pix = tr["width"] * tr["height"]
    sample = np.sort(rs.choice(n_pix, size=min(tr["check_pixels"], n_pix),
                               replace=False))
    # warm-up: one whole frame at the window's shape, on a key of its own
    render_accumulate(scene, dataclasses.replace(cfg, seed=frame_seed(seed, -1)))
    return SimpleNamespace(
        desc=desc, scene=scene, cfg=cfg, seed=seed, sample=sample,
        rays_per_launch=rays_per_launch(n_pix, cfg.samples_per_pixel,
                                        cfg.samples_per_batch,
                                        cfg.rays_per_chunk))


def rays_per_launch(n_pix, spp, spb, rays_per_chunk):
    """The real rays a search launch of a frame takes on average: every
    sample batch of every chunk of pixels (``render_accumulate``'s loop)
    takes the same launches, and the pad of a short last chunk is no
    work."""
    spb = min(spb, spp)
    chunk = max(1, min(rays_per_chunk // spb, n_pix))
    batches = -(-n_pix // chunk) * -(-spp // spb)
    return n_pix * spp / batches


def window(st, seconds, tracer, dev):
    from torch.profiler import record_function

    kept, seeds = [], []
    failed = 0
    t0 = time.perf_counter()
    i = 0
    while time.perf_counter() - t0 < seconds or tracer.active:
        fs = frame_seed(st.seed, i)
        with record_function(harness.LABEL + "frame"):
            img = render_accumulate(st.scene,
                                    dataclasses.replace(st.cfg, seed=fs))
        px = img.reshape(-1, 3)[st.sample]
        failed += int(not np.isfinite(px).all())
        kept.append(px)
        seeds.append(fs)
        i += 1
        tracer.tick(i, time.perf_counter() - t0)
    wall = time.perf_counter() - t0
    sc = st.scene
    return SimpleNamespace(
        unit="frame", units=i, wall=wall, failed=failed, kept=kept,
        seeds=seeds, shapes=dict(rays_per_launch=st.rays_per_launch,
                                 triangles=int(sc.tri_v0.shape[0]),
                                 spheres=int(sc.sph_c0.shape[0])))


def end_to_end(win, setup_s, window_peak):
    return {"setup_s": setup_s, "frame_s": win.wall / max(win.units, 1),
            "peak_mem_gib": window_peak / 2**30}


def release(st, win):
    """What the check needs once the program's state is gone."""
    return SimpleNamespace(desc=st.desc, cfg=st.cfg, sample=st.sample,
                           kept=win.kept, seeds=win.seeds)


def frames_to_check(seed, n_frames, count):
    """The last frame and up to ``count - 1`` others drawn from the seed."""
    rs = np.random.default_rng([int(seed) % (1 << 63), 29])
    others = rs.permutation(n_frames - 1)[:count - 1] if n_frames > 1 else []
    return sorted({n_frames - 1, *map(int, others)})


def reference_pixels(prog, cell, frames, dev, dtype):
    """The reference's radiance at the kept pixels of each of ``frames``,
    in ``dtype``."""
    cfg = prog.cfg
    sc = ref.scene_arrays(prog.desc, dev.name, dtype)
    cam = ref.camera(cell.config["camera"], cfg.width / cfg.height, dev.name,
                     dtype)
    ids = torch.from_numpy(prog.sample).to(dev.name)
    out = []
    for i in frames:
        rad = ref.render_pixels(
            sc, sc["atlas"], cam, ids, ref_rng.key(prog.seeds[i], dev.name),
            width=cfg.width, height=cfg.height, spb=cfg.samples_per_pixel,
            max_bounce=cfg.max_bounce, background=cfg.background,
            block=cell.traffic["reference_block"])
        out.append(rad.float().cpu().numpy())
    return np.concatenate(out)


def check(cell, seed, prog, dev, log, control=None):
    """The readings of the check: the program's kept pixels (or, for the
    control, the reference's in a lower precision) against the reference's
    in float32."""
    idx = frames_to_check(seed, len(prog.kept), cell.traffic["check_frames"])
    want = reference_pixels(prog, cell, idx, dev, torch.float32)
    if control:
        got = reference_pixels(prog, cell, idx, dev,
                               compare.CONTROL_DTYPES[control])
    else:
        got = np.concatenate([prog.kept[i] for i in idx])
    log(f"checked frames {idx} of {len(prog.kept)}, "
        f"{len(prog.sample)} pixels each")
    return compare.frame_readings(got, want)
