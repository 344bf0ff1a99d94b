"""Heston path kernels: csrc/heston.cu (full-truncation Euler) and
csrc/heston_qe.cu (QE-M), and their plain PyTorch versions.

Counterparts of heston_terminal_pallas, heston_paths_pallas,
heston_terminal_qe_pallas and heston_paths_qe_pallas
(options_model_tpu/ops/pallas_heston.py:263, :319, :512, :543), flat layout
only. The wrappers take the plain version for a CPU device and launch the
kernel for a CUDA device; there is no fallback between the two.
"""

from __future__ import annotations

import torch

from options_model_tpu_torch.models.blocks import round_up
from options_model_tpu_torch.models.heston import (heston_constants,
                                                   heston_euler_from_normals,
                                                   heston_qe_from_normals,
                                                   qe_constants)
from options_model_tpu_torch.ops import _build
from options_model_tpu_torch.ops.engine import resolve_device
from options_model_tpu_torch.ops.philox import path_normals, qe_path_draws

# Paths per tile: the unit of first_tile and of antithetic mirroring (path j
# and j + tile/2 of each tile are mirrors), as on the TPU.
TERMINAL_TILE = 16384
PATH_TILE = 4096

# Kernel launches since the last reset, one integer per kernel.
launches = {"heston_terminal": 0, "heston_paths": 0,
            "heston_terminal_qe": 0, "heston_paths_qe": 0}


def _tiles(n_paths: int, tile: int, seed: int, first_tile: int, n_steps: int) -> int:
    n_tiles = round_up(n_paths, tile) // tile
    _build.check_launch(seed, first_tile, n_tiles, n_steps)
    return n_tiles


def _normals(seed, n_tiles, tile, n_steps, antithetic, first_tile, device):
    z = path_normals(seed, first_tile, n_tiles, tile, 2 * n_steps, antithetic, device)
    return z[0::2], z[1::2]


def heston_terminal_reference(seed: int, S0, r, T, params, n_paths: int,
                              n_steps: int, antithetic: bool = True,
                              first_tile: int = 0, device=None) -> torch.Tensor:
    """Plain version of the terminal kernel: Philox, Box-Muller, Euler.
    S_T of shape (n_pad,), n_pad = n_paths rounded up to TERMINAL_TILE."""
    n_tiles = _tiles(n_paths, TERMINAL_TILE, seed, first_tile, n_steps)
    z1, z2 = _normals(seed, n_tiles, TERMINAL_TILE, n_steps, antithetic,
                      first_tile, device)
    return heston_euler_from_normals(z1, z2, S0, r, T, params, return_paths=False)


def heston_paths_reference(seed: int, S0, r, T, params, n_paths: int,
                           n_steps: int, antithetic: bool = True,
                           return_variance: bool = False, first_tile: int = 0,
                           device=None):
    """Plain version of the paths kernel: S (n_steps+1, n_pad) [and v],
    n_pad = n_paths rounded up to PATH_TILE."""
    n_tiles = _tiles(n_paths, PATH_TILE, seed, first_tile, n_steps)
    z1, z2 = _normals(seed, n_tiles, PATH_TILE, n_steps, antithetic,
                      first_tile, device)
    return heston_euler_from_normals(z1, z2, S0, r, T, params, return_variance)


def _consts(S0, r, T, params, n_steps):
    c = heston_constants(S0, r, T, params, n_steps)
    return _build.float_args([c[k] for k in ("log_s0", "r", "dt", "sqrt_dt", "kappa",
                                             "theta", "xi", "rho", "rho_bar", "v0")])


def heston_terminal(seed: int, S0, r, T, params, n_paths: int, n_steps: int,
                    antithetic: bool = True, first_tile: int = 0,
                    device=None) -> torch.Tensor:
    """Terminal prices S_T (n_pad,) from csrc/heston.cu, or from the plain
    version for a CPU device."""
    device = resolve_device(device)
    if device.type == "cpu":
        return heston_terminal_reference(seed, S0, r, T, params, n_paths, n_steps,
                                         antithetic, first_tile, device)
    _build.require_cuda(device)
    n_tiles = _tiles(n_paths, TERMINAL_TILE, seed, first_tile, n_steps)
    out = torch.empty(n_tiles * TERMINAL_TILE, dtype=torch.float32, device=device)
    _build.launch("omt_heston_terminal", device, out.data_ptr(),
                  _consts(S0, r, T, params, n_steps), seed, first_tile, n_tiles,
                  n_steps, int(antithetic))
    launches["heston_terminal"] += 1
    return out


def heston_paths(seed: int, S0, r, T, params, n_paths: int, n_steps: int,
                 antithetic: bool = True, return_variance: bool = False,
                 first_tile: int = 0, device=None):
    """Path matrix S (n_steps+1, n_pad) [and v] from csrc/heston.cu, or from
    the plain version for a CPU device."""
    device = resolve_device(device)
    if device.type == "cpu":
        return heston_paths_reference(seed, S0, r, T, params, n_paths, n_steps,
                                      antithetic, return_variance, first_tile, device)
    _build.require_cuda(device)
    n_tiles = _tiles(n_paths, PATH_TILE, seed, first_tile, n_steps)
    S = torch.empty((n_steps + 1, n_tiles * PATH_TILE), dtype=torch.float32,
                    device=device)
    V = torch.empty_like(S) if return_variance else None
    _build.launch("omt_heston_paths", device, S.data_ptr(),
                  V.data_ptr() if return_variance else None,
                  _consts(S0, r, T, params, n_steps), seed, first_tile, n_tiles,
                  n_steps, int(antithetic))
    launches["heston_paths"] += 1
    return (S, V) if return_variance else S


def heston_terminal_qe_reference(seed: int, S0, r, T, params, n_paths: int,
                                 n_steps: int, antithetic: bool = True,
                                 first_tile: int = 0, device=None) -> torch.Tensor:
    """Plain version of the QE-M terminal kernel: S_T (n_pad,), n_pad =
    n_paths rounded up to TERMINAL_TILE."""
    n_tiles = _tiles(n_paths, TERMINAL_TILE, seed, first_tile, n_steps)
    draws = qe_path_draws(seed, first_tile, n_tiles, TERMINAL_TILE, n_steps,
                          antithetic, device)
    return heston_qe_from_normals(*draws, S0, r, T, params, return_paths=False)


def heston_paths_qe_reference(seed: int, S0, r, T, params, n_paths: int,
                              n_steps: int, antithetic: bool = True,
                              return_variance: bool = False, first_tile: int = 0,
                              device=None):
    """Plain version of the QE-M paths kernel: S (n_steps+1, n_pad) [and v],
    n_pad = n_paths rounded up to PATH_TILE."""
    n_tiles = _tiles(n_paths, PATH_TILE, seed, first_tile, n_steps)
    draws = qe_path_draws(seed, first_tile, n_tiles, PATH_TILE, n_steps,
                          antithetic, device)
    return heston_qe_from_normals(*draws, S0, r, T, params, return_variance)


def _qe_consts(S0, r, T, params, n_steps):
    c = qe_constants(S0, r, T, params, n_steps)
    return _build.float_args([c[k] for k in ("log_s0", "r_dt", "theta", "v0", "ekt",
                                             "c1", "c2", "K1", "K2", "K3", "K4", "A",
                                             "k0_shift")])


def heston_terminal_qe(seed: int, S0, r, T, params, n_paths: int, n_steps: int,
                       antithetic: bool = True, first_tile: int = 0,
                       device=None) -> torch.Tensor:
    """QE-M terminal prices S_T (n_pad,) from csrc/heston_qe.cu, or from
    the plain version for a CPU device."""
    device = resolve_device(device)
    if device.type == "cpu":
        return heston_terminal_qe_reference(seed, S0, r, T, params, n_paths, n_steps,
                                            antithetic, first_tile, device)
    _build.require_cuda(device)
    n_tiles = _tiles(n_paths, TERMINAL_TILE, seed, first_tile, n_steps)
    out = torch.empty(n_tiles * TERMINAL_TILE, dtype=torch.float32, device=device)
    _build.launch("omt_heston_terminal_qe", device, out.data_ptr(),
                  _qe_consts(S0, r, T, params, n_steps), seed, first_tile, n_tiles,
                  n_steps, int(antithetic))
    launches["heston_terminal_qe"] += 1
    return out


def heston_paths_qe(seed: int, S0, r, T, params, n_paths: int, n_steps: int,
                    antithetic: bool = True, return_variance: bool = False,
                    first_tile: int = 0, device=None):
    """QE-M path matrix S (n_steps+1, n_pad) [and v] from csrc/heston_qe.cu,
    or from the plain version for a CPU device."""
    device = resolve_device(device)
    if device.type == "cpu":
        return heston_paths_qe_reference(seed, S0, r, T, params, n_paths, n_steps,
                                         antithetic, return_variance, first_tile,
                                         device)
    _build.require_cuda(device)
    n_tiles = _tiles(n_paths, PATH_TILE, seed, first_tile, n_steps)
    S = torch.empty((n_steps + 1, n_tiles * PATH_TILE), dtype=torch.float32,
                    device=device)
    V = torch.empty_like(S) if return_variance else None
    _build.launch("omt_heston_paths_qe", device, S.data_ptr(),
                  V.data_ptr() if return_variance else None,
                  _qe_consts(S0, r, T, params, n_steps), seed, first_tile, n_tiles,
                  n_steps, int(antithetic))
    launches["heston_paths_qe"] += 1
    return (S, V) if return_variance else S
