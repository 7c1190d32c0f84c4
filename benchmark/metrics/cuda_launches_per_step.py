"""Launches of the port's own kernels (the sum of ``Kernel.launches``
over ``ops._cuda.KERNELS``) in the window, a step: an exact count."""

from benchmark.devtrace import launches_per_unit as read  # noqa: F401
