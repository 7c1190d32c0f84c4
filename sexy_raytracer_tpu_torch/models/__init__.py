from sexy_raytracer_tpu_torch.models.scene import (  # noqa: F401
    SceneBuilder,
    SceneData,
    scene_from_numpy,
)
