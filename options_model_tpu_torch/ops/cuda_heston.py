"""Heston path kernels and their plain PyTorch versions:
- csrc/heston_paths.cu: the paths kernels (full-truncation Euler and QE-M)
  over a batch of maturities, the route of every pricer;
- csrc/heston.cu, csrc/heston_qe.cu: the terminal kernels, and the first
  design of the two paths kernels (accurate math, one maturity per launch),
  kept for comparison under ``heston_paths_accurate`` and
  ``heston_paths_qe_accurate``.

Counterparts of heston_terminal_pallas, heston_paths_pallas,
heston_terminal_qe_pallas and heston_paths_qe_pallas
(options_model_tpu/ops/pallas_heston.py:263, :319, :512, :543), flat layout
only. The wrappers take the plain version for a CPU device and launch the
kernel for a CUDA device; there is no fallback between the two.
"""

from __future__ import annotations

import numpy as np
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
SCHEMES = ("euler", "qe")

# Kernel launches since the last reset, one integer per kernel entry.
launches = {"heston_terminal": 0, "heston_paths": 0,
            "heston_terminal_qe": 0, "heston_paths_qe": 0,
            "heston_paths_accurate": 0, "heston_paths_qe_accurate": 0}


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


_EULER_FIELDS = ("log_s0", "r", "dt", "sqrt_dt", "kappa", "theta", "xi", "rho",
                 "rho_bar", "v0")
_QE_FIELDS = ("log_s0", "r_dt", "theta", "v0", "ekt", "c1", "c2", "K1", "K2", "K3", "K4",
              "A", "k0_shift")


def _const_row(scheme, S0, r, T, params, n_steps):
    """One maturity's float32 constants, in the order of HestonConsts
    (Euler) or QeConsts (QE-M)."""
    if scheme == "qe":
        c = qe_constants(S0, r, T, params, n_steps)
        return [c[k] for k in _QE_FIELDS]
    c = heston_constants(S0, r, T, params, n_steps)
    return [c[k] for k in _EULER_FIELDS]


def _consts(S0, r, T, params, n_steps):
    return _build.float_args(_const_row("euler", S0, r, T, params, n_steps))


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


def heston_paths_accurate(seed: int, S0, r, T, params, n_paths: int, n_steps: int,
                          antithetic: bool = True, return_variance: bool = False,
                          first_tile: int = 0, device=None):
    """Path matrix S (n_steps+1, n_pad) [and v] from the first design of the
    Euler paths kernel (csrc/heston.cu: accurate logf/sinf/cosf/expf, one
    maturity per launch), or from the plain version for a CPU device. No
    pricer reaches it: it is the yardstick of the redesign and the pin of the
    kernel-4 experiments (csrc/heston_variants.cu)."""
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
    launches["heston_paths_accurate"] += 1
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
    return _build.float_args(_const_row("qe", S0, r, T, params, n_steps))


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


def heston_paths_qe_accurate(seed: int, S0, r, T, params, n_paths: int, n_steps: int,
                             antithetic: bool = True, return_variance: bool = False,
                             first_tile: int = 0, device=None):
    """QE-M path matrix S (n_steps+1, n_pad) [and v] from the first design of
    the QE-M paths kernel (csrc/heston_qe.cu: every operation an _rn
    intrinsic, one maturity per launch), or from the plain version for a CPU
    device. No pricer reaches it: it is the redesign's yardstick."""
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
    launches["heston_paths_qe_accurate"] += 1
    return (S, V) if return_variance else S


def _maturities(Ts) -> list:
    Ts = np.asarray(Ts, np.float32).reshape(-1).tolist()
    if not Ts:
        raise ValueError("need at least one maturity")
    return Ts


def heston_paths_batched_reference(seed: int, S0, r, Ts, params, n_paths: int,
                                   n_steps: int, antithetic: bool = True,
                                   return_variance: bool = False, first_tile: int = 0,
                                   device=None, scheme: str = "euler"):
    """Plain version of the batched paths kernel: maturity m is the plain
    single-maturity version at first_tile + m n_tiles, stacked into
    (n_mat, n_steps+1, n_pad) [and v]."""
    if scheme not in SCHEMES:
        raise ValueError(f"scheme must be 'euler' or 'qe', got {scheme!r}")
    fn = heston_paths_qe_reference if scheme == "qe" else heston_paths_reference
    n_tiles = round_up(n_paths, PATH_TILE) // PATH_TILE
    outs = [fn(seed, S0, r, T, params, n_paths, n_steps, antithetic, return_variance,
               first_tile + m * n_tiles, device)
            for m, T in enumerate(_maturities(Ts))]
    if return_variance:
        return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])
    return torch.stack(outs)


def batched_consts(scheme: str, S0, r, Ts, params, n_steps: int, device) -> torch.Tensor:
    """The batched kernel's (n_mat, 10) or (n_mat, 13) float32 constants on
    ``device``: row m is maturity m's _const_row, computed for every
    maturity at once (the same float32 operations, elementwise). A CUDA
    copy goes through pinned memory, so the host does not wait for the work
    already queued on the stream."""
    T = np.asarray(Ts, np.float32)
    if scheme == "qe":
        c, fields = qe_constants(S0, r, T, params, n_steps), _QE_FIELDS
    else:
        c, fields = heston_constants(S0, r, T, params, n_steps), _EULER_FIELDS
    rows = np.empty((T.size, len(fields)), np.float32)
    for i, k in enumerate(fields):
        rows[:, i] = c[k]
    out = torch.from_numpy(rows)
    if torch.device(device).type == "cuda":
        out = out.pin_memory()
    return out.to(device, non_blocking=True)


def heston_paths_batched(seed: int, S0, r, Ts, params, n_paths: int, n_steps: int,
                         antithetic: bool = True, return_variance: bool = False,
                         first_tile: int = 0, device=None, scheme: str = "euler"):
    """Path matrices of every maturity in ``Ts``, (n_mat, n_steps+1, n_pad)
    [and v], from one launch of csrc/heston_paths.cu (scheme "euler" or
    "qe"), or from the plain version for a CPU device. Maturity m draws
    tiles [first_tile + m n_tiles, first_tile + (m+1) n_tiles) of the seed's
    stream, so it equals a single-maturity run at that first_tile."""
    if scheme not in SCHEMES:
        raise ValueError(f"scheme must be 'euler' or 'qe', got {scheme!r}")
    device = resolve_device(device)
    if device.type == "cpu":
        return heston_paths_batched_reference(seed, S0, r, Ts, params, n_paths, n_steps,
                                              antithetic, return_variance, first_tile,
                                              device, scheme)
    _build.require_cuda(device)
    Ts = _maturities(Ts)
    n_tiles = round_up(n_paths, PATH_TILE) // PATH_TILE
    _build.check_launch(seed, first_tile, len(Ts) * n_tiles, n_steps)
    consts = batched_consts(scheme, S0, r, Ts, params, n_steps, device)
    S = torch.empty((len(Ts), n_steps + 1, n_tiles * PATH_TILE), dtype=torch.float32,
                    device=device)
    V = torch.empty_like(S) if return_variance else None
    _build.launch("omt_heston_paths_batched", device, S.data_ptr(),
                  V.data_ptr() if return_variance else None, consts.data_ptr(), seed,
                  first_tile, n_tiles, n_steps, len(Ts), int(antithetic),
                  SCHEMES.index(scheme))
    launches["heston_paths_qe" if scheme == "qe" else "heston_paths"] += 1
    return (S, V) if return_variance else S


def heston_paths(seed: int, S0, r, T, params, n_paths: int, n_steps: int,
                 antithetic: bool = True, return_variance: bool = False,
                 first_tile: int = 0, device=None):
    """Path matrix S (n_steps+1, n_pad) [and v] from csrc/heston_paths.cu
    (the batched kernel at one maturity), or from the plain version for a
    CPU device."""
    out = heston_paths_batched(seed, S0, r, [T], params, n_paths, n_steps, antithetic,
                               return_variance, first_tile, device, "euler")
    return (out[0][0], out[1][0]) if return_variance else out[0]


def heston_paths_qe(seed: int, S0, r, T, params, n_paths: int, n_steps: int,
                    antithetic: bool = True, return_variance: bool = False,
                    first_tile: int = 0, device=None):
    """QE-M path matrix S (n_steps+1, n_pad) [and v] from csrc/heston_paths.cu
    (the batched kernel at one maturity), or from the plain version for a CPU
    device."""
    out = heston_paths_batched(seed, S0, r, [T], params, n_paths, n_steps, antithetic,
                               return_variance, first_tile, device, "qe")
    return (out[0][0], out[1][0]) if return_variance else out[0]


def paths_kernel_attrs() -> dict:
    """Registers, spills and occupancy of the four paths kernels as built
    (the pricing instance: antithetic, with v), by name."""
    return {"heston_paths": _build.kernel_attrs("omt_heston_paths_batched_attrs", 0),
            "heston_paths_qe": _build.kernel_attrs("omt_heston_paths_batched_attrs", 1),
            "heston_paths_accurate": _build.kernel_attrs("omt_heston_paths_attrs"),
            "heston_paths_qe_accurate": _build.kernel_attrs("omt_heston_paths_qe_attrs")}
