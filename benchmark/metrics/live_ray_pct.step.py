"""Live rays over the ray slots that the traced steps' finds were
launched over (kernels 1-6 run every lane of a wavefront, dead or alive),
counted on the card by the program's ``live_rays`` counter."""

from benchmark.spans import live_ray_pct as read  # noqa: F401
