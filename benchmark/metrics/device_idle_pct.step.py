"""The share of the traced stretch of steps with no kernel, copy or fill
on the card."""

from benchmark.devtrace import idle_pct as read  # noqa: F401
