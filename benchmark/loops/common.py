"""What the loops share: a cell's scene on both sides."""

from __future__ import annotations

import importlib


def scene_desc(cell, seed):
    """The description of the cell's scene (``scenes/<scene>.py``)."""
    mod = importlib.import_module(f"benchmark.scenes.{cell.config['scene']}")
    return mod.build(cell.config["scene_params"], seed)


def program_scene(cell, seed, dev, width, height, spp):
    """(description, the program's scene on ``dev``, its render config):
    the description replayed on the program's ``SceneBuilder``. No BVH: the
    program's find kernels cull clusters and never read one."""
    from sexy_raytracer_tpu_torch.models.scene import SceneBuilder
    from sexy_raytracer_tpu_torch.utils.config import (
        CameraConfig,
        RenderConfig,
    )

    desc = scene_desc(cell, seed)
    scene = desc.replay(SceneBuilder()).build(build_bvh=False,
                                              device=dev.name)
    c = cell.config
    cam = {k: tuple(v) if isinstance(v, list) else v
           for k, v in c["camera"].items()}
    cfg = RenderConfig(width=width, height=height, samples_per_pixel=spp,
                       max_bounce=c["max_bounce"],
                       background=tuple(c["background"]),
                       camera=CameraConfig(**cam))
    return desc, scene, cfg
