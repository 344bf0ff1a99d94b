"""The SABR kernels of csrc/sabr.cu and their plain PyTorch versions:
- 23 ``sabr_paths``: the forward (and alpha) path matrices, the counterpart
  of options_model_tpu/models/sabr.py:90 simulate_sabr(return_paths=True,
  return_alpha=...);
- 24 ``sabr_terminal``: F_T (and alpha_T), and for sabr_european_mc's
  control variate the frozen-vol lognormal forward G_T on the same W1, the
  counterpart of simulate_sabr's terminal output and of
  options_model_tpu/models/sabr.py:211-236. Its beta = 1 redesign
  (sabr_terminal_kernel: the SFU Box-Muller, ex2, FMAs) runs on every
  pricing path, with the first design's exact instance at beta < 1; the
  first design (sabr_terminal_first_kernel) stays as the yardstick under
  ``sabr_terminal_first``, reached by no pricer.
The JAX package simulates SABR in XLA code (no Pallas kernel). beta = 1
(log-Euler on log F) and beta < 1 (absorbing Euler on F) are compile-time
instances of each kernel, as the reference branches on float(beta). The
dispatching functions take the plain version for a CPU device and launch
the kernel for a CUDA one, with no fallback between the two;
``launch_sabr_paths`` and ``launch_sabr_terminal`` check the output
tensors (CUDA, float32, contiguous, the launch's shape) and raise on
anything else, a CPU tensor included. A launch passes its constants
(``sabr_row``: SABR_FIELDS of models/sabr.sabr_constants) by value.
"""

from __future__ import annotations

import numpy as np
import torch

from options_model_tpu_torch.models.blocks import round_up
from options_model_tpu_torch.models.sabr import sabr_constants, sabr_from_draws
from options_model_tpu_torch.ops import _build
from options_model_tpu_torch.ops.cuda_heston import PATH_TILE, TERMINAL_TILE
from options_model_tpu_torch.ops.cuda_vg import _check_out
from options_model_tpu_torch.ops.engine import resolve_device
from options_model_tpu_torch.ops.philox import sabr_path_draws

# Kernel launches since the last reset, one integer per kernel.
launches = {"sabr_paths": 0, "sabr_terminal": 0, "sabr_terminal, first design": 0}
# The constants a launch passes (csrc/sabr.cu SabrK), in this order.
SABR_FIELDS = ("s0", "alpha0", "rho", "rho_bar", "dt", "sqrt_dt", "nu_sqrt_dt", "half_nu2_dt",
               "beta", "log_f0", "cv_drift", "cv_diffusion")


def sabr_row(F0, T, params, n_steps: int) -> np.ndarray:
    """The float32 constants of a launch, in SABR_FIELDS order."""
    c = sabr_constants(F0, T, params, n_steps)
    return np.asarray([c[k] for k in SABR_FIELDS], np.float32)


def _n_tiles(seed, first_tile, n_paths, tile, n_steps) -> int:
    n_tiles = round_up(n_paths, tile) // tile
    _build.check_launch(seed, first_tile, n_tiles, n_steps)
    return n_tiles


def sabr_paths_reference(seed: int, F0, T, params, n_paths: int, n_steps: int,
                         antithetic: bool = True, first_tile: int = 0, device=None,
                         return_alpha: bool = False):
    """Plain version of kernel 23: F (n_steps+1, n_pad) [and alpha],
    n_pad = n_paths rounded up to PATH_TILE."""
    n_tiles = _n_tiles(seed, first_tile, n_paths, PATH_TILE, n_steps)
    z1, z2 = sabr_path_draws(seed, first_tile, n_tiles, PATH_TILE, n_steps, antithetic, device)
    return sabr_from_draws(z1, z2, F0, T, params, return_paths=True, return_alpha=return_alpha)


def sabr_terminal_reference(seed: int, F0, T, params, n_paths: int, n_steps: int,
                            antithetic: bool = True, first_tile: int = 0, device=None,
                            return_alpha: bool = False, return_cv: bool = False):
    """Plain version of kernel 24: F_T (n_pad,) [, alpha_T] [, G_T], n_pad =
    n_paths rounded up to TERMINAL_TILE."""
    n_tiles = _n_tiles(seed, first_tile, n_paths, TERMINAL_TILE, n_steps)
    z1, z2 = sabr_path_draws(seed, first_tile, n_tiles, TERMINAL_TILE, n_steps, antithetic,
                             device)
    return sabr_from_draws(z1, z2, F0, T, params, return_alpha=return_alpha,
                           return_cv=return_cv)


def launch_sabr_paths(F: torch.Tensor, alpha, row: np.ndarray, seed: int, first_tile: int,
                      antithetic: bool) -> None:
    """One launch of kernel 23 into F (n_steps+1, n_pad) and alpha (the same
    shape, or None); ``row`` the sabr_row of the launch."""
    if F.dim() != 2:
        raise ValueError(f"kernel 23 writes (n_steps+1, n_pad) paths, got {tuple(F.shape)}")
    _check_out(F, F.shape, torch.float32, "F")
    _check_out(alpha, F.shape, torch.float32, "alpha")
    n_steps, n_pad = F.shape[0] - 1, F.shape[1]
    if n_pad % PATH_TILE or n_steps < 1 or len(row) != len(SABR_FIELDS) or not 0 <= row[8] <= 1:
        raise ValueError(f"kernel 23 takes whole {PATH_TILE}-path tiles, a step and "
                         f"{len(SABR_FIELDS)} constants with beta in [0, 1]")
    n_tiles = n_pad // PATH_TILE
    _build.check_launch(seed, first_tile, n_tiles, n_steps)
    _build.launch("omt_sabr_paths", F.device, F.data_ptr(),
                  None if alpha is None else alpha.data_ptr(), _build.float_args(row), seed,
                  first_tile, n_tiles, n_steps, int(antithetic))
    launches["sabr_paths"] += 1


def launch_sabr_terminal(F_T: torch.Tensor, alpha_T, G_T, row: np.ndarray, seed: int,
                         first_tile: int, n_steps: int, antithetic: bool,
                         first_design: bool = False) -> None:
    """One launch of kernel 24 (its redesign, or with ``first_design`` its
    first design) into F_T (n_pad,), alpha_T and G_T (the same shape, or
    None); ``row`` the sabr_row of the launch."""
    if F_T.dim() != 1:
        raise ValueError(f"kernel 24 writes (n_pad,) values, got {tuple(F_T.shape)}")
    for t, what in ((F_T, "F_T"), (alpha_T, "alpha_T"), (G_T, "G_T")):
        _check_out(t, F_T.shape, torch.float32, what)
    if (F_T.shape[0] % TERMINAL_TILE or n_steps < 1 or len(row) != len(SABR_FIELDS)
            or not 0 <= row[8] <= 1):
        raise ValueError(f"kernel 24 takes whole {TERMINAL_TILE}-path tiles, a step and "
                         f"{len(SABR_FIELDS)} constants with beta in [0, 1]")
    n_tiles = F_T.shape[0] // TERMINAL_TILE
    _build.check_launch(seed, first_tile, n_tiles, n_steps)
    _build.launch("omt_sabr_terminal_first" if first_design else "omt_sabr_terminal",
                  F_T.device, F_T.data_ptr(), None if alpha_T is None else alpha_T.data_ptr(),
                  None if G_T is None else G_T.data_ptr(), _build.float_args(row), seed,
                  first_tile, n_tiles, n_steps, int(antithetic))
    launches["sabr_terminal, first design" if first_design else "sabr_terminal"] += 1


def sabr_paths(seed: int, F0, T, params, n_paths: int, n_steps: int, antithetic: bool = True,
               first_tile: int = 0, device=None, return_alpha: bool = False):
    """SABR forward paths F (n_steps+1, n_pad) [and alpha] from kernel 23
    (csrc/sabr.cu sabr_paths_kernel), or from its plain version for a CPU
    device."""
    device = resolve_device(device)
    if device.type == "cpu":
        return sabr_paths_reference(seed, F0, T, params, n_paths, n_steps, antithetic,
                                    first_tile, device, return_alpha)
    _build.require_cuda(device)
    n_pad = _n_tiles(seed, first_tile, n_paths, PATH_TILE, n_steps) * PATH_TILE
    F = torch.empty((n_steps + 1, n_pad), dtype=torch.float32, device=device)
    alpha = torch.empty_like(F) if return_alpha else None
    launch_sabr_paths(F, alpha, sabr_row(F0, T, params, n_steps), seed, first_tile, antithetic)
    return (F, alpha) if return_alpha else F


def _terminal_launch(first_design, seed, F0, T, params, n_paths, n_steps, antithetic,
                     first_tile, device, return_alpha, return_cv):
    """sabr_terminal's outputs from one launch of a kernel-24 design on a
    CUDA device."""
    _build.require_cuda(device)
    n_pad = _n_tiles(seed, first_tile, n_paths, TERMINAL_TILE, n_steps) * TERMINAL_TILE
    F_T = torch.empty(n_pad, dtype=torch.float32, device=device)
    alpha_T = torch.empty_like(F_T) if return_alpha else None
    G_T = torch.empty_like(F_T) if return_cv else None
    launch_sabr_terminal(F_T, alpha_T, G_T, sabr_row(F0, T, params, n_steps), seed, first_tile,
                         n_steps, antithetic, first_design)
    out = (F_T,) + ((alpha_T,) if return_alpha else ()) + ((G_T,) if return_cv else ())
    return out if len(out) > 1 else out[0]


def sabr_terminal(seed: int, F0, T, params, n_paths: int, n_steps: int, antithetic: bool = True,
                  first_tile: int = 0, device=None, return_alpha: bool = False,
                  return_cv: bool = False):
    """SABR terminal forwards F_T (n_pad,) [, alpha_T] [, G_T] from kernel
    24's redesign (csrc/sabr.cu sabr_terminal_kernel; at beta < 1 the first
    design's instance), or from its plain version for a CPU device."""
    device = resolve_device(device)
    if device.type == "cpu":
        return sabr_terminal_reference(seed, F0, T, params, n_paths, n_steps, antithetic,
                                       first_tile, device, return_alpha, return_cv)
    return _terminal_launch(False, seed, F0, T, params, n_paths, n_steps, antithetic,
                            first_tile, device, return_alpha, return_cv)


def sabr_terminal_first(seed: int, F0, T, params, n_paths: int, n_steps: int,
                        antithetic: bool = True, first_tile: int = 0, device=None,
                        return_alpha: bool = False, return_cv: bool = False):
    """sabr_terminal through kernel 24's first design
    (sabr_terminal_first_kernel), the redesign's yardstick, on a CUDA device
    only."""
    return _terminal_launch(True, seed, F0, T, params, n_paths, n_steps, antithetic,
                            first_tile, resolve_device(device), return_alpha, return_cv)


def sabr_kernel_attrs() -> dict:
    """Registers, spills and occupancy of kernels 23 and 24 as built (the
    antithetic instances: beta = 1 under the kernel's name, beta < 1 beside
    it, and kernel 24's first design at beta = 1)."""
    return {name: _build.kernel_attrs("omt_sabr_attrs", i)
            for i, name in enumerate(("sabr_paths", "sabr_paths beta<1", "sabr_terminal",
                                      "sabr_terminal beta<1", "sabr_terminal, first design"))}
