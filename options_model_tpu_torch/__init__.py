"""PyTorch/CUDA port of options_model_tpu.

The JAX package ``options_model_tpu`` is the reference; this package mirrors
its layout (core/, models/, ops/, pricers/, calibration/) and function names
so each counterpart is easy to find. The four path-simulation kernels are
CUDA C++ for Hopper (csrc/), built with nvcc at first use and bound through
ctypes; every kernel has a plain PyTorch version in the same module, which
is what runs for tensors on the CPU.

Slice ported so far: the American put under Heston (full-truncation Euler)
and GBM priced by masked-WLS Longstaff-Schwartz with the European control
variate and common-path Richardson extrapolation
(``pricers.american.price_american``), plus the European terminal-sampler
branch of the same dispatcher. Features outside the slice raise
NotImplementedError naming their JAX counterpart.

This package imports torch and numpy only, never jax.
"""
