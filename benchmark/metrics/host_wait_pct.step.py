"""The host's time at the program's ``wait`` sites (each synchronising
statement, its own launches and copies included) over the traced
stretch of steps' wall time."""

from benchmark.spans import wait_pct as read  # noqa: F401
