from sexy_raytracer_tpu_torch.oracle.reference import Oracle  # noqa: F401
