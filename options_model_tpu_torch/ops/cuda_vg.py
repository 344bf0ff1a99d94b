"""The Variance Gamma kernels of csrc/vg.cu and their plain PyTorch versions:
- 21 ``vg_paths``: VG paths of a batch of maturities in one launch (maturity
  m on tiles first_tile + m n_tiles + ..), the counterpart of
  options_model_tpu/models/vg.py:55 simulate_vg (return_paths=True); its
  redesign (vg_paths_kernel: the gamma clock drawn a chunk of steps at a
  time, its retries dense) on every pricing path, its first design
  (vg_paths_first_kernel) kept as the yardstick under ``vg_paths_first``,
  reached by no pricer;
- 22 ``vg_terminal``: the exact one-step terminal sampler, the counterpart
  of options_model_tpu/models/vg.py:92 vg_terminal_exact.
The JAX package simulates VG in XLA code (no Pallas kernel). The dispatching
functions take the plain version for a CPU device and launch the kernel for
a CUDA one; there is no fallback between the two. ``launch_vg_paths`` and
``launch_vg_terminal`` are the launches themselves: they check the output
tensors (CUDA, float32 or int32, contiguous, the launch's shape) and raise
on anything else, a CPU tensor included.

A launch reads its constants from VG_ROW-float rows on the card, one a
maturity (``vg_rows``: log S0, drift, theta, sigma, nu and the gamma
sampler's d, c, 1/a and boost flag), built on the host and copied through
pinned memory. ``return_draws`` also returns each draw's standard gamma
variate and the attempt that accepted it, from the kernel's debug outputs
or the plain version, so the two can be held against each other: both
designs draw the same gammas and attempts bit for bit.
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import torch

from options_model_tpu_torch.models.blocks import round_up
from options_model_tpu_torch.models.vg import vg_constants, vg_from_draws
from options_model_tpu_torch.ops import _build
from options_model_tpu_torch.ops.cuda_heston import PATH_TILE, TERMINAL_TILE, _maturities
from options_model_tpu_torch.ops.cuda_jumps import device_rows
from options_model_tpu_torch.ops.engine import resolve_device
from options_model_tpu_torch.ops.philox import gamma_constants, vg_path_draws

# Kernel launches since the last reset, one integer per kernel (kernel 21's
# first design apart from its redesign).
launches = {"vg_paths": 0, "vg_paths, first design": 0, "vg_terminal": 0}
# Kernel 21's redesign's launches since the last reset, by (n_mat, n_pad,
# n_steps).
shape_launches = Counter()
# Floats of a constants row (csrc/vg.cu kRow).
VG_ROW = 16


def vg_rows(S0, r, Ts, params, n_steps: int) -> np.ndarray:
    """(n_mat, VG_ROW) float32 constants of a launch, row m maturity Ts[m]'s
    (vg_constants and gamma_constants at its step's shape)."""
    c = vg_constants(S0, r, np.asarray(Ts, np.float32), params, n_steps)
    rows = np.zeros((len(Ts), VG_ROW), np.float32)
    for m in range(len(Ts)):
        g = gamma_constants(c["shape"][m])
        rows[m, :9] = [c["log_s0"], c["drift"][m], c["theta"], c["sigma"], c["nu"], g["d"],
                       g["c"], g["inv_a"], float(g["boost"])]
    return rows


def _n_tiles(seed, first_tile, n_paths, tile, n_mat, n_steps) -> int:
    n_tiles = round_up(n_paths, tile) // tile
    _build.check_launch(seed, first_tile, n_mat * n_tiles, n_steps)
    return n_tiles


def _reference(seed, S0, r, T, params, n_tiles, tile, n_steps, antithetic, first_tile, device,
               return_paths):
    """One maturity's plain walk on its tiles: S [, gamma, attempts]."""
    a = float(vg_constants(S0, r, T, params, n_steps)["shape"])
    z, gam, att = vg_path_draws(seed, first_tile, n_tiles, tile, n_steps, a, antithetic, device,
                                return_attempts=True)
    G = float(np.float32(params.nu)) * gam
    return vg_from_draws(z, G, S0, r, T, params, return_paths), gam, att


def vg_paths_reference(seed: int, S0, r, Ts, params, n_paths: int, n_steps: int,
                       antithetic: bool = True, first_tile: int = 0, device=None,
                       return_draws: bool = False):
    """Plain version of kernel 21: S (n_mat, n_steps+1, n_pad) [and the
    standard gamma draws and their attempts, each (n_mat, n_steps, n_pad)],
    n_pad = n_paths rounded up to PATH_TILE, maturity m on tiles first_tile +
    m n_tiles + .."""
    Ts = _maturities(Ts)
    n_tiles = _n_tiles(seed, first_tile, n_paths, PATH_TILE, len(Ts), n_steps)
    outs = [_reference(seed, S0, r, T, params, n_tiles, PATH_TILE, n_steps, antithetic,
                       first_tile + m * n_tiles, device, True) for m, T in enumerate(Ts)]
    S = torch.stack([o[0] for o in outs])
    if not return_draws:
        return S
    return S, torch.stack([o[1] for o in outs]), torch.stack([o[2] for o in outs])


def vg_terminal_reference(seed: int, S0, r, T, params, n_paths: int, antithetic: bool = True,
                          first_tile: int = 0, device=None, return_draws: bool = False):
    """Plain version of kernel 22: S_T (n_pad,) after one exact step of
    length T [and the gamma draws and their attempts, (n_pad,)], n_pad =
    n_paths rounded up to TERMINAL_TILE."""
    n_tiles = _n_tiles(seed, first_tile, n_paths, TERMINAL_TILE, 1, 1)
    S, gam, att = _reference(seed, S0, r, T, params, n_tiles, TERMINAL_TILE, 1, antithetic,
                             first_tile, device, False)
    return (S, gam[0], att[0]) if return_draws else S


def _check_out(t, shape, dtype, what: str) -> None:
    """A kernel output must be a contiguous CUDA tensor of the launch's shape
    and type."""
    if t is None:
        return
    if (t.device.type != "cuda" or t.dtype != dtype or not t.is_contiguous()
            or tuple(t.shape) != tuple(shape)):
        raise ValueError(f"kernel output {what} must be a contiguous CUDA {dtype} tensor of "
                         f"shape {tuple(shape)}, got {t.device} {t.dtype} {tuple(t.shape)}")


def launch_vg_paths(S: torch.Tensor, gammas, attempts, rows: torch.Tensor, seed: int,
                    first_tile: int, antithetic: bool, first_design: bool = False) -> None:
    """One launch of kernel 21 (its redesign, or with ``first_design`` its
    first design) into S (n_mat, n_steps+1, n_pad), the debug outputs gammas
    (float32) and attempts (int32), each (n_mat, n_steps, n_pad), or None;
    rows the (n_mat, VG_ROW) constants on S's card."""
    if S.dim() != 3:
        raise ValueError(f"kernel 21 writes (n_mat, n_steps+1, n_pad) paths, got {tuple(S.shape)}")
    n_mat, n_steps, n_pad = S.shape[0], S.shape[1] - 1, S.shape[2]
    _check_out(S, S.shape, torch.float32, "S")
    _check_out(gammas, (n_mat, n_steps, n_pad), torch.float32, "gammas")
    _check_out(attempts, (n_mat, n_steps, n_pad), torch.int32, "attempts")
    _check_out(rows, (n_mat, VG_ROW), torch.float32, "rows")
    if n_pad % PATH_TILE or n_steps < 1 or (gammas is None) != (attempts is None):
        raise ValueError(f"kernel 21 takes whole {PATH_TILE}-path tiles, a step, and both "
                         "debug outputs or neither")
    n_tiles = n_pad // PATH_TILE
    _build.check_launch(seed, first_tile, n_mat * n_tiles, n_steps)
    _build.launch("omt_vg_paths_first" if first_design else "omt_vg_paths", S.device,
                  S.data_ptr(), None if gammas is None else gammas.data_ptr(),
                  None if attempts is None else attempts.data_ptr(), rows.data_ptr(), seed,
                  first_tile, n_tiles, n_steps, n_mat, int(antithetic))
    if first_design:
        launches["vg_paths, first design"] += 1
    else:
        launches["vg_paths"] += 1
        shape_launches[n_mat, n_pad, n_steps] += 1


def launch_vg_terminal(S_T: torch.Tensor, gammas, attempts, rows: torch.Tensor, seed: int,
                       first_tile: int, antithetic: bool) -> None:
    """One launch of kernel 22 into S_T (n_pad,), the debug outputs gammas
    and attempts (n_pad,) or None; rows the (1, VG_ROW) constants on the card."""
    if S_T.dim() != 1:
        raise ValueError(f"kernel 22 writes (n_pad,) values, got {tuple(S_T.shape)}")
    _check_out(S_T, S_T.shape, torch.float32, "S_T")
    _check_out(gammas, S_T.shape, torch.float32, "gammas")
    _check_out(attempts, S_T.shape, torch.int32, "attempts")
    _check_out(rows, (1, VG_ROW), torch.float32, "rows")
    if S_T.shape[0] % TERMINAL_TILE or (gammas is None) != (attempts is None):
        raise ValueError(f"kernel 22 takes whole {TERMINAL_TILE}-path tiles and both debug "
                         "outputs or neither")
    n_tiles = S_T.shape[0] // TERMINAL_TILE
    _build.check_launch(seed, first_tile, n_tiles, 1)
    _build.launch("omt_vg_terminal", S_T.device, S_T.data_ptr(),
                  None if gammas is None else gammas.data_ptr(),
                  None if attempts is None else attempts.data_ptr(), rows.data_ptr(), seed,
                  first_tile, n_tiles, int(antithetic))
    launches["vg_terminal"] += 1


def _paths_out(seed, S0, r, Ts, params, n_paths, n_steps, first_tile, device, return_draws):
    """(S, gammas, attempts, rows) of a kernel-21 launch on a CUDA device:
    empty outputs (the debug ones None without ``return_draws``) and the
    constants on the card."""
    _build.require_cuda(device)
    Ts = _maturities(Ts)
    n_tiles = _n_tiles(seed, first_tile, n_paths, PATH_TILE, len(Ts), n_steps)
    n_pad = n_tiles * PATH_TILE
    S = torch.empty((len(Ts), n_steps + 1, n_pad), dtype=torch.float32, device=device)
    draws = ((torch.empty((len(Ts), n_steps, n_pad), dtype=torch.float32, device=device),
              torch.empty((len(Ts), n_steps, n_pad), dtype=torch.int32, device=device))
             if return_draws else (None, None))
    return S, *draws, device_rows(vg_rows(S0, r, Ts, params, n_steps), device)


def vg_paths(seed: int, S0, r, Ts, params, n_paths: int, n_steps: int, antithetic: bool = True,
             first_tile: int = 0, device=None, return_draws: bool = False):
    """VG path matrices of every maturity in ``Ts``, (n_mat, n_steps+1,
    n_pad) [and the gamma draws and attempts], from one launch of kernel
    21's redesign (csrc/vg.cu vg_paths_kernel), or from the plain version
    for a CPU device. Maturity m draws tiles [first_tile + m n_tiles,
    first_tile + (m+1) n_tiles) of the seed's stream, so it equals a
    single-maturity run at that first_tile."""
    device = resolve_device(device)
    if device.type == "cpu":
        return vg_paths_reference(seed, S0, r, Ts, params, n_paths, n_steps, antithetic,
                                  first_tile, device, return_draws)
    S, g, a, rows = _paths_out(seed, S0, r, Ts, params, n_paths, n_steps, first_tile, device,
                               return_draws)
    launch_vg_paths(S, g, a, rows, seed, first_tile, antithetic)
    return (S, g, a) if return_draws else S


def vg_paths_first(seed: int, S0, r, Ts, params, n_paths: int, n_steps: int,
                   antithetic: bool = True, first_tile: int = 0, device=None,
                   return_draws: bool = False):
    """vg_paths through kernel 21's first design (vg_paths_first_kernel), the
    redesign's yardstick, on a CUDA device only."""
    S, g, a, rows = _paths_out(seed, S0, r, Ts, params, n_paths, n_steps, first_tile,
                               resolve_device(device), return_draws)
    launch_vg_paths(S, g, a, rows, seed, first_tile, antithetic, first_design=True)
    return (S, g, a) if return_draws else S


def vg_terminal(seed: int, S0, r, T, params, n_paths: int, antithetic: bool = True,
                first_tile: int = 0, device=None, return_draws: bool = False):
    """Exact VG terminal values S_T (n_pad,) [and the gamma draws and
    attempts] from kernel 22 (csrc/vg.cu vg_terminal_kernel), or from its
    plain version for a CPU device."""
    device = resolve_device(device)
    if device.type == "cpu":
        return vg_terminal_reference(seed, S0, r, T, params, n_paths, antithetic, first_tile,
                                     device, return_draws)
    _build.require_cuda(device)
    n_pad = _n_tiles(seed, first_tile, n_paths, TERMINAL_TILE, 1, 1) * TERMINAL_TILE
    S_T = torch.empty(n_pad, dtype=torch.float32, device=device)
    draws = ((torch.empty(n_pad, dtype=torch.float32, device=device),
              torch.empty(n_pad, dtype=torch.int32, device=device))
             if return_draws else (None, None))
    launch_vg_terminal(S_T, *draws, device_rows(vg_rows(S0, r, [T], params, 1), device), seed,
                       first_tile, antithetic)
    return (S_T, *draws) if return_draws else S_T


def vg_kernel_attrs() -> dict:
    """Registers, spills and occupancy of kernels 21 (both designs) and 22 as
    built (their pricing instances: antithetic, without the debug
    outputs)."""
    return {name: _build.kernel_attrs("omt_vg_attrs", i)
            for i, name in enumerate(("vg_paths", "vg_terminal", "vg_paths, first design"))}
