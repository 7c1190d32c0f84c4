"""PyTorch's own device work (ATen's kernels, matrix products, copies and
fills) over all device time in the traced stretch of steps."""

from benchmark.devtrace import aten_share_pct as read  # noqa: F401
