"""GBM log-Euler path kernels and their plain PyTorch versions:
- csrc/terminal.cu: the terminal kernel redesigned for Hopper, the route of
  every pricer;
- csrc/gbm.cu: the paths kernel, the route of every pricer, and the first
  design of the terminal kernel (accurate math, the key schedule at every
  Philox call), kept only as the redesign's yardstick under
  ``gbm_terminal_accurate``; no pricer reaches it.

Counterparts of gbm_terminal_pallas and gbm_paths_pallas
(options_model_tpu/ops/pallas_gbm.py:100, :126), flat layout only. The
wrappers take the plain version for a CPU device and launch the kernel for
a CUDA device; there is no fallback between the two.
"""

from __future__ import annotations

import torch

from options_model_tpu_torch.models.gbm import gbm_constants, gbm_euler_from_normals
from options_model_tpu_torch.ops import _build
from options_model_tpu_torch.ops.cuda_heston import (PATH_TILE, TERMINAL_TILE, _tiles,
                                                    launch_terminal)
from options_model_tpu_torch.ops.engine import resolve_device
from options_model_tpu_torch.ops.philox import path_normals

# Kernel launches since the last reset, one integer per kernel.
launches = {"gbm_terminal": 0, "gbm_paths": 0, "gbm_terminal_accurate": 0}


def gbm_terminal_reference(seed: int, S0, r, sigma, T, n_paths: int, n_steps: int,
                           antithetic: bool = True, first_tile: int = 0,
                           device=None) -> torch.Tensor:
    """Plain version of the terminal kernel: S_T (n_pad,), n_pad = n_paths
    rounded up to TERMINAL_TILE."""
    n_tiles = _tiles(n_paths, TERMINAL_TILE, seed, first_tile, n_steps)
    z = path_normals(seed, first_tile, n_tiles, TERMINAL_TILE, n_steps,
                     antithetic, device)
    return gbm_euler_from_normals(z, S0, r, sigma, T, return_paths=False)


def gbm_paths_reference(seed: int, S0, r, sigma, T, n_paths: int, n_steps: int,
                        antithetic: bool = True, first_tile: int = 0,
                        device=None) -> torch.Tensor:
    """Plain version of the paths kernel: S (n_steps+1, n_pad), n_pad =
    n_paths rounded up to PATH_TILE."""
    n_tiles = _tiles(n_paths, PATH_TILE, seed, first_tile, n_steps)
    z = path_normals(seed, first_tile, n_tiles, PATH_TILE, n_steps, antithetic, device)
    return gbm_euler_from_normals(z, S0, r, sigma, T)


def _consts(S0, r, sigma, T, n_steps):
    c = gbm_constants(S0, r, sigma, T, n_steps)
    return _build.float_args([c[k] for k in ("s0", "drift", "diffusion", "drift_n")])


def _terminal(name, key, seed, S0, r, sigma, T, n_paths, n_steps, antithetic, first_tile,
              device) -> torch.Tensor:
    device = resolve_device(device)
    if device.type == "cpu":
        return gbm_terminal_reference(seed, S0, r, sigma, T, n_paths, n_steps, antithetic,
                                      first_tile, device)
    return launch_terminal(name, (launches, key), _consts(S0, r, sigma, T, n_steps), seed,
                           n_paths, n_steps, antithetic, first_tile, device)


def gbm_terminal(seed: int, S0, r, sigma, T, n_paths: int, n_steps: int,
                 antithetic: bool = True, first_tile: int = 0,
                 device=None) -> torch.Tensor:
    """Terminal prices S_T (n_pad,) from csrc/terminal.cu, or from the plain
    version for a CPU device."""
    return _terminal("omt_terminal_gbm", "gbm_terminal", seed, S0, r, sigma, T, n_paths,
                     n_steps, antithetic, first_tile, device)


def gbm_terminal_accurate(seed: int, S0, r, sigma, T, n_paths: int, n_steps: int,
                          antithetic: bool = True, first_tile: int = 0,
                          device=None) -> torch.Tensor:
    """Terminal prices S_T (n_pad,) from the first design of the terminal
    kernel (csrc/gbm.cu: accurate logf/sinf/cosf/sqrtf/expf, the key
    schedule at every Philox call), or from the plain version for a CPU
    device. No pricer reaches it: it is the redesign's yardstick."""
    return _terminal("omt_gbm_terminal", "gbm_terminal_accurate", seed, S0, r, sigma, T,
                     n_paths, n_steps, antithetic, first_tile, device)


def gbm_paths(seed: int, S0, r, sigma, T, n_paths: int, n_steps: int,
              antithetic: bool = True, first_tile: int = 0,
              device=None) -> torch.Tensor:
    """Path matrix S (n_steps+1, n_pad) from csrc/gbm.cu, or from the plain
    version for a CPU device."""
    device = resolve_device(device)
    if device.type == "cpu":
        return gbm_paths_reference(seed, S0, r, sigma, T, n_paths, n_steps,
                                   antithetic, first_tile, device)
    _build.require_cuda(device)
    n_tiles = _tiles(n_paths, PATH_TILE, seed, first_tile, n_steps)
    S = torch.empty((n_steps + 1, n_tiles * PATH_TILE), dtype=torch.float32,
                    device=device)
    _build.launch("omt_gbm_paths", device, S.data_ptr(),
                  _consts(S0, r, sigma, T, n_steps), seed, first_tile, n_tiles,
                  n_steps, int(antithetic))
    launches["gbm_paths"] += 1
    return S
