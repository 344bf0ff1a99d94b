"""Local-vol path kernels: csrc/localvol.cu and their plain PyTorch versions.

Counterparts of localvol_terminal_pallas and localvol_paths_pallas
(options_model_tpu/ops/pallas_localvol.py:62, :149), flat layout only. The
wrappers take the plain version for a CPU device and launch the kernel for
a CUDA device; there is no fallback between the two.
"""

from __future__ import annotations

import torch

from options_model_tpu_torch.models.localvol import (check_table, localvol_constants,
                                                     localvol_euler_from_normals)
from options_model_tpu_torch.ops import _build
from options_model_tpu_torch.ops.cuda_heston import PATH_TILE, TERMINAL_TILE, _tiles
from options_model_tpu_torch.ops.engine import resolve_device
from options_model_tpu_torch.ops.philox import path_normals
from options_model_tpu_torch.surface.cheb import LocalVolTable

# Kernel launches since the last reset, one integer per kernel.
launches = {"localvol_terminal": 0, "localvol_paths": 0}


def localvol_terminal_reference(seed: int, S0, r, T, table: LocalVolTable,
                                n_paths: int, n_steps: int, antithetic: bool = True,
                                first_tile: int = 0, device=None) -> torch.Tensor:
    """Plain version of the terminal kernel: S_T (n_pad,), n_pad = n_paths
    rounded up to TERMINAL_TILE."""
    n_tiles = _tiles(n_paths, TERMINAL_TILE, seed, first_tile, n_steps)
    z = path_normals(seed, first_tile, n_tiles, TERMINAL_TILE, n_steps, antithetic,
                     device)
    return localvol_euler_from_normals(z, S0, r, T, table, return_paths=False)


def localvol_paths_reference(seed: int, S0, r, T, table: LocalVolTable,
                             n_paths: int, n_steps: int, antithetic: bool = True,
                             first_tile: int = 0, device=None) -> torch.Tensor:
    """Plain version of the paths kernel: S (n_steps+1, n_pad), n_pad =
    n_paths rounded up to PATH_TILE."""
    n_tiles = _tiles(n_paths, PATH_TILE, seed, first_tile, n_steps)
    z = path_normals(seed, first_tile, n_tiles, PATH_TILE, n_steps, antithetic, device)
    return localvol_euler_from_normals(z, S0, r, T, table)


def _launch(name, out, S0, r, T, table, seed, first_tile, n_tiles, n_steps,
            antithetic, device) -> None:
    c = localvol_constants(S0, r, T, table, n_steps)
    consts = _build.float_args([c[k] for k in ("log_s0", "r", "dt", "sqrt_dt", "log_k",
                                               "m_center", "inv_m_half")])
    # rows past n_steps are never read; the copy stays alive until the
    # stream has run the kernel (the caching allocator orders reuse by stream)
    coeffs = table.coeffs[:n_steps].to(device=device, dtype=torch.float32).contiguous()
    _build.launch(name, device, out.data_ptr(), coeffs.data_ptr(), consts, seed,
                  first_tile, n_tiles, n_steps, coeffs.shape[1], int(antithetic))


def localvol_terminal(seed: int, S0, r, T, table: LocalVolTable, n_paths: int,
                      n_steps: int, antithetic: bool = True, first_tile: int = 0,
                      device=None) -> torch.Tensor:
    """Terminal prices S_T (n_pad,) from csrc/localvol.cu, or from the plain
    version for a CPU device."""
    device = resolve_device(device)
    if device.type == "cpu":
        return localvol_terminal_reference(seed, S0, r, T, table, n_paths, n_steps,
                                           antithetic, first_tile, device)
    _build.require_cuda(device)
    check_table(table, n_steps)
    n_tiles = _tiles(n_paths, TERMINAL_TILE, seed, first_tile, n_steps)
    out = torch.empty(n_tiles * TERMINAL_TILE, dtype=torch.float32, device=device)
    _launch("omt_localvol_terminal", out, S0, r, T, table, seed, first_tile, n_tiles,
            n_steps, antithetic, device)
    launches["localvol_terminal"] += 1
    return out


def localvol_paths(seed: int, S0, r, T, table: LocalVolTable, n_paths: int,
                   n_steps: int, antithetic: bool = True, first_tile: int = 0,
                   device=None) -> torch.Tensor:
    """Path matrix S (n_steps+1, n_pad) from csrc/localvol.cu, or from the
    plain version for a CPU device."""
    device = resolve_device(device)
    if device.type == "cpu":
        return localvol_paths_reference(seed, S0, r, T, table, n_paths, n_steps,
                                        antithetic, first_tile, device)
    _build.require_cuda(device)
    check_table(table, n_steps)
    n_tiles = _tiles(n_paths, PATH_TILE, seed, first_tile, n_steps)
    S = torch.empty((n_steps + 1, n_tiles * PATH_TILE), dtype=torch.float32,
                    device=device)
    _launch("omt_localvol_paths", S, S0, r, T, table, seed, first_tile, n_tiles,
            n_steps, antithetic, device)
    launches["localvol_paths"] += 1
    return S
