from sexy_raytracer_tpu_torch.parallel.mesh import (  # noqa: F401
    RAY_AXIS,
    SAMPLE_AXIS,
    init_distributed,
    make_mesh,
    replicate_scene,
    shard_rays,
    spawn,
)
from sexy_raytracer_tpu_torch.parallel.render import (  # noqa: F401
    make_sharded_chunk_fn,
    render_sharded,
)
