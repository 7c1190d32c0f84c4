"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates): HBM3 bandwidth and float32 outside the tensor cores. They assume
the card's full 700 W; a run prints the card's power limit beside them."""

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12


def least_seconds(bytes_=0.0, flops=0.0):
    """The least time the chip could take for this work."""
    return max(bytes_ / HBM_BYTES_PER_S, flops / FP32_FLOPS)
