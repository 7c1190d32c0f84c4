"""The share of the traced stretch of frames with no kernel, copy or fill
on the card."""

from benchmark.devtrace import idle_pct as read  # noqa: F401
