"""The rough Bergomi kernels of csrc/rbergomi.cu and their plain PyTorch
versions:
- 25 ``rbergomi_dw``: the Brownian increments dW = sqrt(dt) z1 (n_steps,
  n_pad) from the rough Bergomi stream (ops/philox.rbergomi_path_draws);
- 26 ``rbergomi_paths``: the walk on dW and the Volterra sums G = W_mat dW
  (models/rbergomi.volterra, a float32 matrix product between the two
  kernels), redrawing z2 and zp on their own counters: S and v paths (and
  the dual's frozen history sqrt(2H) G), S_T (and v_T), or S_T and the
  control variate's G_T.
They replace XLA code of the JAX package, not a Pallas kernel:
options_model_tpu/models/rbergomi.py:114 simulate_rbergomi and :222
terminal_cv_core. ``rbergomi_simulate`` chains the three for every entry
point of models/rbergomi.py. The wrappers take the plain version for a CPU
tensor or device and launch the kernel for a CUDA one, with no fallback
between the two. Paths come in whole PATH_TILE tiles, path j + 2048 of a
tile the mirror of path j.
"""

from __future__ import annotations

import numpy as np
import torch

from options_model_tpu_torch.models.blocks import round_up
from options_model_tpu_torch.models.rbergomi import (rbergomi_constants, rbergomi_walk,
                                                      volterra)
from options_model_tpu_torch.ops import _build
from options_model_tpu_torch.ops.cuda_heston import PATH_TILE
from options_model_tpu_torch.ops.engine import resolve_device
from options_model_tpu_torch.ops.philox import rbergomi_path_draws

# Kernel launches since the last reset, one integer per kernel.
launches = {"rbergomi_dw": 0, "rbergomi_paths": 0}
# The constants a kernel-26 launch passes (csrc/rbergomi.cu RbK), in order,
# then the compensator's length and table.
RB_FIELDS = ("log_s0", "r", "dt", "sqrt_dt", "sqrt2H", "c1", "c2", "eta", "xi0", "rho", "rbsd",
             "sig_cv", "cv_drift")
MAX_STEPS = 512
MODES = {"paths": 0, "terminal": 1, "cv": 2}


def rb_args(c: dict):
    """Kernel 26's host constants (csrc/rbergomi.cu RbK) from
    models/rbergomi.rbergomi_constants: RB_FIELDS, the compensator's length
    n_steps + 1, then the table zero-padded to MAX_STEPS + 1."""
    comp = np.asarray(c["comp"], np.float32)
    return _build.float_args([float(c[k]) for k in RB_FIELDS] + [float(comp.size)]
                             + comp.tolist() + [0.0] * (MAX_STEPS + 1 - comp.size))


def _n_tiles(seed: int, first_tile: int, n_paths: int, n_steps: int) -> int:
    n_tiles = round_up(n_paths, PATH_TILE) // PATH_TILE
    _build.check_launch(seed, first_tile, n_tiles, n_steps)
    if n_steps > MAX_STEPS:
        raise ValueError(f"the rough Bergomi kernels take at most {MAX_STEPS} steps, got "
                         f"{n_steps}")
    return n_tiles


def rbergomi_dw_reference(seed: int, first_tile: int, n_tiles: int, n_steps: int, sqrt_dt,
                          antithetic: bool = True, device=None) -> torch.Tensor:
    """Plain version of kernel 25: sqrt(dt) z1, (n_steps, n_tiles
    PATH_TILE)."""
    (z1,) = rbergomi_path_draws(seed, first_tile, n_tiles, PATH_TILE, n_steps, antithetic,
                                device, "z1")
    return float(np.float32(sqrt_dt)) * z1


def rbergomi_dw(seed: int, first_tile: int, n_tiles: int, n_steps: int, sqrt_dt,
                antithetic: bool = True, device=None) -> torch.Tensor:
    """The Brownian increments dW (n_steps, n_tiles PATH_TILE) from kernel
    25 (csrc/rbergomi.cu rbergomi_dw_kernel) on a CUDA device, from its
    plain version on the CPU."""
    device = resolve_device(device)
    if device.type == "cpu":
        return rbergomi_dw_reference(seed, first_tile, n_tiles, n_steps, sqrt_dt, antithetic,
                                     device)
    _build.require_cuda(device)
    _build.check_launch(seed, first_tile, n_tiles, n_steps)
    if n_steps > 65535:
        raise ValueError(f"kernel 25's grid takes at most 65535 steps, got {n_steps}")
    dW = torch.empty((n_steps, n_tiles * PATH_TILE), dtype=torch.float32, device=device)
    _build.launch("omt_rbergomi_dw", device, dW.data_ptr(), float(np.float32(sqrt_dt)), seed,
                  first_tile, n_tiles, n_steps, int(antithetic))
    launches["rbergomi_dw"] += 1
    return dW


def rbergomi_paths_reference(dW: torch.Tensor, G: torch.Tensor, c: dict, seed: int,
                             first_tile: int, antithetic: bool = True, mode: str = "paths",
                             return_variance: bool = False, return_dual_state: bool = False):
    """Plain version of kernel 26: models/rbergomi.rbergomi_walk on dW, G
    and the stream's (z2, zp) of the same tiles."""
    n_steps, n_pad = dW.shape
    z2, zp = rbergomi_path_draws(seed, first_tile, n_pad // PATH_TILE, PATH_TILE, n_steps,
                                 antithetic, dW.device, "z2 zp")
    return rbergomi_walk(dW, G, z2, zp, c, mode, return_variance, return_dual_state)


def _check_in(t: torch.Tensor, shape, what: str) -> None:
    if (t.shape != shape or t.dtype != torch.float32 or not t.is_contiguous()
            or t.device.type != "cuda"):
        raise ValueError(f"{what} must be a contiguous float32 CUDA tensor of shape {shape}, got "
                         f"{tuple(t.shape)} {t.dtype} on {t.device}")


def rbergomi_paths(dW: torch.Tensor, G: torch.Tensor, c: dict, seed: int, first_tile: int,
                   antithetic: bool = True, mode: str = "paths", return_variance: bool = False,
                   return_dual_state: bool = False):
    """Kernel 26 (csrc/rbergomi.cu rbergomi_paths_kernel) on CUDA dW and G
    (n_steps, n_pad), or its plain version on CPU ones: rbergomi_walk's
    outputs for ``mode`` ("paths", "terminal", "cv")."""
    if dW.device.type == "cpu":
        return rbergomi_paths_reference(dW, G, c, seed, first_tile, antithetic, mode,
                                        return_variance, return_dual_state)
    _build.require_cuda(dW.device)
    if mode not in MODES:
        raise ValueError(f"mode must be one of {tuple(MODES)}, got {mode!r}")
    n_steps, n_pad = dW.shape
    if n_pad % PATH_TILE or len(c["comp"]) != n_steps + 1:
        raise ValueError(f"kernel 26 takes whole {PATH_TILE}-path tiles and n_steps + 1 "
                         "compensator entries")
    n_tiles = _n_tiles(seed, first_tile, n_pad, n_steps)
    _check_in(dW, (n_steps, n_pad), "dW")
    _check_in(G, (n_steps, n_pad), "G")
    device = dW.device
    if mode == "paths":
        S = torch.empty((n_steps + 1, n_pad), dtype=torch.float32, device=device)
        want_v = return_variance or return_dual_state
        v = torch.empty_like(S) if want_v else None
        hist = torch.empty_like(dW) if return_dual_state else None
        g_t = None
    else:
        S = torch.empty(n_pad, dtype=torch.float32, device=device)
        v = torch.empty_like(S) if mode == "terminal" and return_variance else None
        g_t = torch.empty_like(S) if mode == "cv" else None
        hist = None
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    _build.launch("omt_rbergomi_paths", device, S.data_ptr(), ptr(v), ptr(hist), ptr(g_t),
                  dW.data_ptr(), G.data_ptr(), rb_args(c), seed, first_tile, n_tiles, n_steps,
                  int(antithetic), MODES[mode])
    launches["rbergomi_paths"] += 1
    if mode == "cv":
        return S, g_t
    if mode == "terminal":
        return (S, v) if return_variance else S
    if return_dual_state:
        return S, v, hist
    return (S, v) if return_variance else S


def rbergomi_simulate(seed: int, S0, T, params, n_paths: int, n_steps: int, rate=0.0,
                      mode: str = "paths", antithetic: bool = True, first_tile: int = 0,
                      device=None, return_variance: bool = False,
                      return_dual_state: bool = False):
    """The hybrid scheme on n_paths (rounded up to PATH_TILE) from tile
    ``first_tile`` of the stream: kernel 25, the Volterra product and kernel
    26 on a CUDA device (the card by default), their plain versions on the
    CPU; rbergomi_paths' outputs for ``mode``."""
    device = resolve_device(device)
    n_tiles = _n_tiles(seed, first_tile, n_paths, n_steps)
    c = rbergomi_constants(S0, T, params, n_steps, rate)
    dW = rbergomi_dw(seed, first_tile, n_tiles, n_steps, c["sqrt_dt"], antithetic, device)
    G = volterra(torch.from_numpy(c["W_mat"]), dW)
    return rbergomi_paths(dW, G, c, seed, first_tile, antithetic, mode, return_variance,
                          return_dual_state)


def rbergomi_kernel_attrs() -> dict:
    """Registers, spills and occupancy of kernels 25 and 26 as built (the
    antithetic instances; kernel 26 in each mode)."""
    names = ("rbergomi_dw", "rbergomi_paths", "rbergomi_paths terminal", "rbergomi_paths cv")
    return {name: _build.kernel_attrs("omt_rbergomi_attrs", i) for i, name in enumerate(names)}

