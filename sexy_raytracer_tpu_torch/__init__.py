"""sexy-raytracer-tpu on PyTorch + CUDA: the forward render path and the
differentiable train step.

A port of ``sexy_raytracer_tpu`` (JAX, Pallas on a TPU) to PyTorch with
hand-written CUDA kernels for Hopper (``csrc/*.cu``). Module names follow
the JAX package so that each file points at its counterpart; the JAX
package stays the reference the port is tested against.

The package imports torch and numpy only. Importing it builds nothing and
touches no device: the CUDA kernels are compiled on their first launch
(``ops/_cuda.py``).
"""

__version__ = "0.1.0"
