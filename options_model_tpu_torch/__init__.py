"""PyTorch/CUDA port of options_model_tpu.

The JAX package ``options_model_tpu`` is the reference; this package mirrors
its layout (core/, models/, ops/, surface/, pricers/, calibration/, apps/) and
function names so each counterpart is easy to find. The path-simulation
kernels, and the store/exp/layout variants of the Heston paths kernel that
the JAX package's experiments ran, are CUDA C++ for Hopper (csrc/), built
with nvcc at first use and bound through ctypes; every kernel has a plain
PyTorch version in the same module, which is what runs for tensors on the
CPU.

Ported so far: the American put under Heston (full-truncation Euler or
QE-M) and GBM priced by Longstaff-Schwartz, with the masked-WLS polynomial
regressor or the shared continuation MLP (the NN-LSM), the European
control variate and common-path Richardson extrapolation
(``pricers.american.price_american``) and the European terminal-sampler
branch of the same dispatcher; local vol over a compiled Chebyshev table
(``surface.cheb``); the single-device strike x maturity surface
(``pricers.surface_american``); the kernel experiments (``scripts``);
and Greeks by automatic differentiation (``pricers.greeks``,
``pricers.blackscholes``): the pathwise Monte-Carlo Greeks pass through
the path kernels, whose backward is a hand-written VJP kernel
(csrc/greeks.cu, ops/autodiff.py); and calibration (``calibration``):
the Heston, Bates and Variance Gamma COS pricers, the float64 calibrator
with its scipy cascade, the synthetic oracle surfaces, and the
calibrate -> price app (``apps.calibrate``); and the IV surface
(``surface``, ``data``): the IV-surface network with its trainer, MC-dropout
and torch checkpoints, the SVI surface and its Dupire local vol, the
synthetic oracles and the gated market feed, the training app
(``apps.train_surface``), and local vol under a bare ``sigma_fn``
(``models.localvol``), whose normals come from the port's own normals
kernel (csrc/philox.cu) on the card; and the Variance Gamma and SABR
families (``models.vg``, ``models.sabr``: their paths on kernels of their
own, csrc/vg.cu and csrc/sabr.cu, every American route, the European
samplers, the VG surface, SABR's closed forms, calibration and ADI oracle,
``pricers.fd_sabr``); and rough Bergomi (``models.rbergomi``: the hybrid
scheme on kernels of its own, csrc/rbergomi.cu, around one float32 Volterra
matrix product; its European control variate, American route, calibrator
``calibration.rbergomi`` and ``apps.calibrate --model rbergomi``), with the
dual bracket ``pricers.dual.price_american_bracket`` for every family the
reference's takes. Features outside these raise NotImplementedError naming
their JAX counterpart.

This package imports torch and numpy only, never jax.
"""
