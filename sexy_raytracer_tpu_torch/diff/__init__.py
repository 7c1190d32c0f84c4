from sexy_raytracer_tpu_torch.diff.params import (  # noqa: F401
    DEFAULT_TRAINABLE,
    extract_params,
    merge_params,
)
from sexy_raytracer_tpu_torch.diff.inverse import (  # noqa: F401
    inverse_render,
    make_optimizer,
    make_train_step,
)
from sexy_raytracer_tpu_torch.diff.silhouette import (  # noqa: F401
    sphere_silhouette_loss,
)
