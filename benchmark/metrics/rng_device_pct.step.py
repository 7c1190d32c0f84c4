"""The share of the traced steps' wall time in which one of the program's
``rng`` stretches (the ray keys, the camera's and the bounces' uniforms:
``utils/rng``'s threefry) is open on the card, CUDA event to CUDA event,
idle gaps inside included: an upper bound of the RNG's device time."""

from benchmark.spans import rng_device_pct as read  # noqa: F401
