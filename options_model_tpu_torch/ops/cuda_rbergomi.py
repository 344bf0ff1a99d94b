"""The rough Bergomi kernels of csrc/rbergomi.cu and their plain PyTorch
versions.

The design, ``rbergomi_fused`` (rbergomi_fused_kernel): one launch draws
z1, z2 and zp on the rough Bergomi stream (ops/philox.rbergomi_path_draws),
forms dW = sqrt(dt) z1 and the Volterra sums G[k] = sum_{i<k} w_{k-i+1}
dW_i in shared memory and registers, over i in ascending order
(models/rbergomi.volterra_ordered, the contract that makes the kernel and
its plain version agree bit for bit), and walks Y, v and the log-price: S
and v paths (and the dual's frozen history sqrt(2H) G), S_T (and v_T), or
S_T and the control variate's G_T. dW and G never reach device memory; at
R5's 2^20 x 50 with v its bound is the 428 MB of S and v it writes (the
source's header counts it). ``rbergomi_simulate`` launches it for every
entry point of models/rbergomi.py.

The first design, the yardstick no pricer reaches (``rbergomi_simulate_first``,
its own counters): kernel 25 ``rbergomi_dw`` (dW to device memory), the
float32 product G = W_mat dW (models/rbergomi.volterra), kernel 26
``rbergomi_paths`` (the walk on dW and G, redrawing z2 and zp).

They replace XLA code of the JAX package, not a Pallas kernel:
options_model_tpu/models/rbergomi.py:128 simulate_rbergomi (the matmul at
:192) and :234 terminal_cv_core (:265). The wrappers take the plain
version for a CPU tensor or device and launch the kernel for a CUDA one,
with no fallback between the two. Paths come in whole PATH_TILE tiles,
path j + 2048 of a tile the mirror of path j.
"""

from __future__ import annotations

import numpy as np
import torch

from options_model_tpu_torch.models.blocks import round_up
from options_model_tpu_torch.models.rbergomi import (rbergomi_constants, rbergomi_walk,
                                                      volterra, volterra_ordered)
from options_model_tpu_torch.ops import _build
from options_model_tpu_torch.ops.cuda_heston import PATH_TILE
from options_model_tpu_torch.ops.engine import resolve_device
from options_model_tpu_torch.ops.philox import rbergomi_path_draws

# Kernel launches since the last reset, one integer per kernel (the first
# design's two under their own names).
launches = {"rbergomi_fused": 0, "rbergomi_dw, first design": 0,
            "rbergomi_paths, first design": 0}
# The constants a launch of the fused kernel or kernel 26 passes
# (csrc/rbergomi.cu RbK), in order, then the compensator's length and table.
RB_FIELDS = ("log_s0", "r", "dt", "sqrt_dt", "sqrt2H", "c1", "c2", "eta", "xi0", "rho", "rbsd",
             "sig_cv", "cv_drift")
MAX_STEPS = 512
MODES = {"paths": 0, "terminal": 1, "cv": 2}


def rb_args(c: dict):
    """The fused kernel's and kernel 26's host constants (csrc/rbergomi.cu
    RbK) from models/rbergomi.rbergomi_constants: RB_FIELDS, the
    compensator's length n_steps + 1, then the table zero-padded to
    MAX_STEPS + 1."""
    comp = np.asarray(c["comp"], np.float32)
    buf = np.zeros(len(RB_FIELDS) + 2 + MAX_STEPS, np.float32)
    buf[:len(RB_FIELDS)] = [c[k] for k in RB_FIELDS]
    buf[len(RB_FIELDS)] = comp.size
    buf[len(RB_FIELDS) + 1:len(RB_FIELDS) + 1 + comp.size] = comp
    return _build.float_buffer(buf)


def rb_weights(c: dict):
    """The fused kernel's Volterra weights (csrc/rbergomi.cu RbW): W_mat's
    first column, wt[lag] = w_{lag+1}, zero-padded to MAX_STEPS. They go by
    value with the launch, so no copy to the card precedes it."""
    buf = np.zeros(MAX_STEPS, np.float32)
    buf[:len(c["W_mat"])] = c["W_mat"][:, 0]
    return _build.float_buffer(buf)


def _n_tiles(seed: int, first_tile: int, n_paths: int, n_steps: int) -> int:
    n_tiles = round_up(n_paths, PATH_TILE) // PATH_TILE
    _build.check_launch(seed, first_tile, n_tiles, n_steps)
    if n_steps > MAX_STEPS:
        raise ValueError(f"the rough Bergomi kernels take at most {MAX_STEPS} steps, got "
                         f"{n_steps}")
    return n_tiles


def _outputs(mode: str, n_steps: int, n_pad: int, device, return_variance: bool,
             return_dual_state: bool):
    """The kernel's outputs (S, v, hist, g_t) for ``mode``, None where not
    asked for."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {tuple(MODES)}, got {mode!r}")
    if mode == "paths":
        S = torch.empty((n_steps + 1, n_pad), dtype=torch.float32, device=device)
        v = torch.empty_like(S) if return_variance or return_dual_state else None
        hist = (torch.empty((n_steps, n_pad), dtype=torch.float32, device=device)
                if return_dual_state else None)
        return S, v, hist, None
    S = torch.empty(n_pad, dtype=torch.float32, device=device)
    v = torch.empty_like(S) if mode == "terminal" and return_variance else None
    return S, v, None, torch.empty_like(S) if mode == "cv" else None


def _returned(mode, S, v, hist, g_t, return_variance: bool, return_dual_state: bool):
    """rbergomi_walk's return for ``mode`` from the kernel's outputs."""
    if mode == "cv":
        return S, g_t
    if mode == "paths" and return_dual_state:
        return S, v, hist
    return (S, v) if return_variance else S


def _ptr(t):
    return None if t is None else t.data_ptr()


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
    25 (csrc/rbergomi.cu rbergomi_dw_kernel, the first design) on a CUDA
    device, from its plain version on the CPU."""
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
    launches["rbergomi_dw, first design"] += 1
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
    """Kernel 26 (csrc/rbergomi.cu rbergomi_paths_kernel, the first design)
    on CUDA dW and G (n_steps, n_pad), or its plain version on CPU ones:
    rbergomi_walk's outputs for ``mode`` ("paths", "terminal", "cv")."""
    if dW.device.type == "cpu":
        return rbergomi_paths_reference(dW, G, c, seed, first_tile, antithetic, mode,
                                        return_variance, return_dual_state)
    _build.require_cuda(dW.device)
    n_steps, n_pad = dW.shape
    if n_pad % PATH_TILE or len(c["comp"]) != n_steps + 1:
        raise ValueError(f"kernel 26 takes whole {PATH_TILE}-path tiles and n_steps + 1 "
                         "compensator entries")
    n_tiles = _n_tiles(seed, first_tile, n_pad, n_steps)
    _check_in(dW, (n_steps, n_pad), "dW")
    _check_in(G, (n_steps, n_pad), "G")
    S, v, hist, g_t = _outputs(mode, n_steps, n_pad, dW.device, return_variance,
                               return_dual_state)
    _build.launch("omt_rbergomi_paths", dW.device, S.data_ptr(), _ptr(v), _ptr(hist),
                  _ptr(g_t), dW.data_ptr(), G.data_ptr(), rb_args(c), seed, first_tile, n_tiles,
                  n_steps, int(antithetic), MODES[mode])
    launches["rbergomi_paths, first design"] += 1
    return _returned(mode, S, v, hist, g_t, return_variance, return_dual_state)


def rbergomi_fused_reference(seed: int, S0, T, params, n_paths: int, n_steps: int, rate=0.0,
                             mode: str = "paths", antithetic: bool = True, first_tile: int = 0,
                             device=None, return_variance: bool = False,
                             return_dual_state: bool = False):
    """Plain version of the fused kernel: the stream's (z1, z2, zp), dW =
    sqrt(dt) z1, G = volterra_ordered(W_mat, dW), then rbergomi_walk."""
    device = resolve_device(device)
    n_tiles = _n_tiles(seed, first_tile, n_paths, n_steps)
    c = rbergomi_constants(S0, T, params, n_steps, rate)
    z1, z2, zp = rbergomi_path_draws(seed, first_tile, n_tiles, PATH_TILE, n_steps, antithetic,
                                     device)
    dW = float(c["sqrt_dt"]) * z1
    G = volterra_ordered(torch.from_numpy(c["W_mat"]), dW)
    return rbergomi_walk(dW, G, z2, zp, c, mode, return_variance, return_dual_state)


def rbergomi_fused(seed: int, S0, T, params, n_paths: int, n_steps: int, rate=0.0,
                   mode: str = "paths", antithetic: bool = True, first_tile: int = 0,
                   device=None, return_variance: bool = False, return_dual_state: bool = False):
    """The hybrid scheme on n_paths (rounded up to PATH_TILE) from tile
    ``first_tile`` of the stream in one launch of the fused kernel
    (csrc/rbergomi.cu rbergomi_fused_kernel) on a CUDA device, or its plain
    version on the CPU: rbergomi_walk's outputs for ``mode`` ("paths",
    "terminal", "cv")."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {tuple(MODES)}, got {mode!r}")
    device = resolve_device(device)
    if device.type == "cpu":
        return rbergomi_fused_reference(seed, S0, T, params, n_paths, n_steps, rate, mode,
                                        antithetic, first_tile, device, return_variance,
                                        return_dual_state)
    _build.require_cuda(device)
    n_tiles = _n_tiles(seed, first_tile, n_paths, n_steps)
    n_pad = n_tiles * PATH_TILE
    c = rbergomi_constants(S0, T, params, n_steps, rate)
    S, v, hist, g_t = _outputs(mode, n_steps, n_pad, device, return_variance,
                               return_dual_state)
    launch_rbergomi_fused(S, v, hist, g_t, rb_args(c), rb_weights(c), seed, first_tile,
                          n_steps, antithetic, mode)
    return _returned(mode, S, v, hist, g_t, return_variance, return_dual_state)


def launch_rbergomi_fused(S: torch.Tensor, v, hist, g_t, args, weights, seed: int,
                          first_tile: int, n_steps: int, antithetic: bool, mode: str) -> None:
    """One launch of the fused kernel into outputs made beforehand
    (_outputs' shapes for ``mode``; n_pad = S.shape[-1]) with the host
    tables rb_args and rb_weights: rbergomi_fused's launch, and a bare
    launch for a timing."""
    n_tiles = S.shape[-1] // PATH_TILE
    _build.launch("omt_rbergomi_fused", S.device, S.data_ptr(), _ptr(v), _ptr(hist), _ptr(g_t),
                  args, weights, seed, first_tile, n_tiles, n_steps, int(antithetic),
                  MODES[mode])
    launches["rbergomi_fused"] += 1


# Every rough route of the port (models/rbergomi.py) simulates through here.
rbergomi_simulate = rbergomi_fused


def rbergomi_simulate_first(seed: int, S0, T, params, n_paths: int, n_steps: int, rate=0.0,
                            mode: str = "paths", antithetic: bool = True, first_tile: int = 0,
                            device=None, return_variance: bool = False,
                            return_dual_state: bool = False):
    """The first design, the yardstick: kernel 25, the Volterra product
    (models/rbergomi.volterra, cuBLAS's order of summation) and kernel 26 on
    a CUDA device, their plain versions on the CPU. No pricer calls it."""
    device = resolve_device(device)
    n_tiles = _n_tiles(seed, first_tile, n_paths, n_steps)
    c = rbergomi_constants(S0, T, params, n_steps, rate)
    dW = rbergomi_dw(seed, first_tile, n_tiles, n_steps, c["sqrt_dt"], antithetic, device)
    G = volterra(torch.from_numpy(c["W_mat"]), dW)
    return rbergomi_paths(dW, G, c, seed, first_tile, antithetic, mode, return_variance,
                          return_dual_state)


def rbergomi_kernel_attrs(n_steps: int = 50) -> dict:
    """Registers, spills and occupancy of the fused kernel in each mode (its
    dynamic shared memory at ``n_steps``) and of the first design's kernels
    25 and 26, as built (the antithetic instances)."""
    names = ("rbergomi_dw, first design", "rbergomi_paths, first design",
             "rbergomi_paths terminal, first design", "rbergomi_paths cv, first design",
             "rbergomi_fused", "rbergomi_fused terminal", "rbergomi_fused cv")
    return {name: _build.kernel_attrs("omt_rbergomi_attrs", i, n_steps)
            for i, name in enumerate(names)}
