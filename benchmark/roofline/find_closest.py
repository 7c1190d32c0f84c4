"""The work of one closest-hit search over a wavefront (kernel 1,
``csrc/find.cu`` ``find_closest_kernel``), whatever implements it.

Bytes: each ray's origin (3), direction (3), time (1) and t-range (its
t_min; the far end is open) read once, the scene's triangle vertices (9)
and sphere rows (two centres, two times, the radius: 9) read once, and the
hit (primitive id and t) written once; 4 bytes a number. No operation
count: the tests a search needs are defined by how it culls, so the bound
is the bytes'.
"""

RAY_BYTES = (3 + 3 + 1 + 1) * 4
HIT_BYTES = 4 + 4
TRIANGLE_BYTES = 9 * 4
SPHERE_BYTES = 9 * 4


def bytes_per_launch(rays: float, triangles: int, spheres: int) -> float:
    """``rays``: the real rays the launch searches for (a mean over the
    launches where a chunk is padded), not the launch's padded width."""
    return (rays * (RAY_BYTES + HIT_BYTES) + triangles * TRIANGLE_BYTES
            + spheres * SPHERE_BYTES)
