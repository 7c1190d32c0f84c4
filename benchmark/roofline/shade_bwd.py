"""The work of one shading VJP over a wavefront (kernel 6,
``csrc/fused.cu`` ``shade_bwd_kernel``), whatever implements it.

Bytes: the forward's inputs read once (each ray's origin, direction,
throughput, radiance, alive flag, hit point, normal, tangent, bitangent,
front and hit flags: 27; its material row: 30; its texel: 8; its draws: 7;
its six material kinds as 4-byte integers; the background's 3 numbers
once), the cotangent of the carry read once (origin, direction,
throughput, radiance, alive: 13 a ray) and the gradient of every float
input written once. Stacks an implementation keeps, pads and copies do
not count. No operation count: the bound is the bytes'.
"""

FORWARD_FLOATS = 27 + 30 + 8 + 7
FORWARD_INTS = 6
COTANGENT_FLOATS = 13
BACKGROUND = 3


def bytes_per_launch(rays: int) -> int:
    per_ray = (FORWARD_FLOATS + FORWARD_INTS + COTANGENT_FLOATS
               + FORWARD_FLOATS) * 4
    return rays * per_ray + 2 * BACKGROUND * 4
