from sexy_raytracer_tpu_torch.diff.params import (  # noqa: F401
    DEFAULT_TRAINABLE,
    extract_params,
    merge_params,
)
from sexy_raytracer_tpu_torch.diff.inverse import (  # noqa: F401
    make_optimizer,
    make_train_step,
)
