"""Heston path kernels and their plain PyTorch versions:
- csrc/heston_paths.cu: the paths kernels (full-truncation Euler and QE-M)
  over a batch of maturities, the route of every pricer;
- csrc/terminal.cu: the Euler and QE-M terminal kernels redesigned for
  Hopper, the route of every pricer;
- csrc/heston.cu, csrc/heston_qe.cu: the first design of all four kernels
  (accurate math, the key schedule at every Philox call, one maturity per
  launch), kept only as yardsticks under ``heston_terminal_accurate``,
  ``heston_paths_accurate``, ``heston_terminal_qe_accurate`` and
  ``heston_paths_qe_accurate``; no pricer reaches them.

Counterparts of heston_terminal_pallas, heston_paths_pallas,
heston_terminal_qe_pallas and heston_paths_qe_pallas
(options_model_tpu/ops/pallas_heston.py:263, :319, :512, :543), flat layout
only. The wrappers take the plain version for a CPU device and launch the
kernel for a CUDA device; there is no fallback between the two.

``euler_paths_ad`` is the Euler paths kernel in the autograd graph of
(S0, r, T, kappa, theta, xi, rho, v0), the counterpart of jax.grad through
the reference's XLA simulator (models/heston.py:63); its backward is
``euler_paths_vjp``, the VJP kernel of csrc/greeks.cu (or its plain version
for a CPU cotangent), which redraws the forward's normals, repeats its
steps and carries their tangents (models/heston.py states the rules): the
Hopper redesign ``euler_vjp_kernel``; its first design stays under
``euler_paths_vjp_first`` as the yardstick, and no pricer reaches it.
"""

from __future__ import annotations

import numpy as np
import torch

from options_model_tpu_torch.models.blocks import round_up
from options_model_tpu_torch.core.config import HestonParams
from options_model_tpu_torch.models.heston import (heston_constants,
                                                   heston_euler_from_normals,
                                                   heston_euler_vjp_from_normals,
                                                   heston_qe_from_normals,
                                                   qe_constants)
from options_model_tpu_torch.ops import _build
from options_model_tpu_torch.ops.autodiff import VJP_BLOCK, cotangent, differentiable
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
            "heston_terminal_accurate": 0, "heston_paths_accurate": 0,
            "heston_paths_qe_accurate": 0, "heston_terminal_qe_accurate": 0,
            "euler_paths_vjp": 0, "euler_paths_vjp_first": 0}


def _tiles(n_paths: int, tile: int, seed: int, first_tile: int, n_steps: int) -> int:
    n_tiles = round_up(n_paths, tile) // tile
    _build.check_launch(seed, first_tile, n_tiles, n_steps)
    return n_tiles


def launch_terminal(name: str, counter: tuple, consts, seed: int, n_paths: int,
                    n_steps: int, antithetic: bool, first_tile: int,
                    device: torch.device) -> torch.Tensor:
    """S_T (n_pad,) from the terminal kernel of C entry ``name`` on a CUDA
    ``device`` (raises for any other); ``consts`` the host float array of its
    constants; ``counter`` = (launch dict, key) counts the launch."""
    _build.require_cuda(device)
    n_tiles = _tiles(n_paths, TERMINAL_TILE, seed, first_tile, n_steps)
    out = torch.empty(n_tiles * TERMINAL_TILE, dtype=torch.float32, device=device)
    _build.launch(name, device, out.data_ptr(), consts, seed, first_tile, n_tiles, n_steps,
                  int(antithetic))
    counter[0][counter[1]] += 1
    return out


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


def _terminal(scheme, name, key, seed, S0, r, T, params, n_paths, n_steps, antithetic,
              first_tile, device) -> torch.Tensor:
    """S_T of ``scheme`` ("euler" or "qe"): the plain version on a CPU device,
    else C entry ``name``, counted under ``key``."""
    device = resolve_device(device)
    if device.type == "cpu":
        plain = heston_terminal_qe_reference if scheme == "qe" else heston_terminal_reference
        return plain(seed, S0, r, T, params, n_paths, n_steps, antithetic, first_tile, device)
    consts = _build.float_args(_const_row(scheme, S0, r, T, params, n_steps))
    return launch_terminal(name, (launches, key), consts, seed, n_paths, n_steps, antithetic,
                           first_tile, device)


def heston_terminal(seed: int, S0, r, T, params, n_paths: int, n_steps: int,
                    antithetic: bool = True, first_tile: int = 0,
                    device=None) -> torch.Tensor:
    """Terminal prices S_T (n_pad,) from csrc/terminal.cu, or from the plain
    version for a CPU device."""
    return _terminal("euler", "omt_terminal_euler", "heston_terminal", seed, S0, r, T, params,
                     n_paths, n_steps, antithetic, first_tile, device)


def heston_terminal_accurate(seed: int, S0, r, T, params, n_paths: int, n_steps: int,
                             antithetic: bool = True, first_tile: int = 0,
                             device=None) -> torch.Tensor:
    """Terminal prices S_T (n_pad,) from the first design of the Euler
    terminal kernel (csrc/heston.cu: accurate logf/sinf/cosf/sqrtf/expf, the
    key schedule at every Philox call), or from the plain version for a CPU
    device. No pricer reaches it: it is the redesign's yardstick."""
    return _terminal("euler", "omt_heston_terminal", "heston_terminal_accurate", seed, S0, r,
                     T, params, n_paths, n_steps, antithetic, first_tile, device)


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
    """QE-M terminal prices S_T (n_pad,) from csrc/terminal.cu, or from the
    plain version for a CPU device."""
    return _terminal("qe", "omt_terminal_qe", "heston_terminal_qe", seed, S0, r, T, params,
                     n_paths, n_steps, antithetic, first_tile, device)


def heston_terminal_qe_accurate(seed: int, S0, r, T, params, n_paths: int, n_steps: int,
                                antithetic: bool = True, first_tile: int = 0,
                                device=None) -> torch.Tensor:
    """QE-M terminal prices S_T (n_pad,) from the first design of the QE-M
    terminal kernel (csrc/heston_qe.cu: every operation an _rn intrinsic,
    the key schedule at every Philox call), or from the plain version for a
    CPU device. No pricer reaches it: it is the redesign's yardstick."""
    return _terminal("qe", "omt_heston_terminal_qe", "heston_terminal_qe_accurate", seed, S0,
                     r, T, params, n_paths, n_steps, antithetic, first_tile, device)


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


def terminal_kernel_attrs() -> dict:
    """Registers, spills and occupancy of the redesigned terminal kernels of
    csrc/terminal.cu as built (the antithetic instance), by name: local vol
    at degree 7 and at a run-time degree, QE-M, Euler and GBM."""
    return {name: _build.kernel_attrs("omt_terminal_attrs", i) for i, name in
            enumerate(("localvol_terminal", "localvol_terminal (run-time degree)",
                       "heston_terminal_qe", "heston_terminal", "gbm_terminal"))}


def euler_paths_vjp_reference(gS: torch.Tensor, gv, seed: int, S0, r, T, params,
                              n_paths: int, n_steps: int, antithetic: bool = True,
                              first_tile: int = 0) -> torch.Tensor:
    """Plain version of the Euler VJP kernel: <gS, dS/dp> + <gv, dv/dp> for
    p = (S0, r, T, kappa, theta, xi, rho, v0), float64 (8,), on the normals
    heston_paths_reference draws. ``gv`` None: v takes no cotangent."""
    n_tiles = _tiles(n_paths, PATH_TILE, seed, first_tile, n_steps)
    z1, z2 = _normals(seed, n_tiles, PATH_TILE, n_steps, antithetic, first_tile, gS.device)
    return heston_euler_vjp_from_normals(z1, z2, gS, gv, S0, r, T, params)


def _vjp_extras(T, params, n_steps: int):
    """The first design's tangent constants beside the forward's row: d(dt)/dT
    = 1/n, d(sqrt dt)/dT = sqrt(dt) / (2T) and rho / rho_bar (host float32)."""
    c = heston_constants(1.0, 0.0, T, params, n_steps)
    return _build.float_args([1.0 / n_steps, c["sqrt_dt"] / (2.0 * np.float32(T)),
                              c["rho"] / c["rho_bar"]])


def _vjp_tangent_consts(r, T, params, n_steps: int):
    """The redesign's tangent constants (csrc/greeks.cu EulerT), folded on the
    host in float32: r / n, -1 / (2n), d(sqrt dt)/dT, kappa / n, xi
    d(sqrt dt)/dT, dt, kappa dt, rho / rho_bar, theta, sqrt(dt) / 2 and xi
    sqrt(dt) / 2."""
    c = heston_constants(1.0, r, T, params, n_steps)
    f = np.float32
    inv_n = f(1.0) / f(n_steps)
    ds_dT = c["sqrt_dt"] / (f(2.0) * f(T))
    h_sdt = f(0.5) * c["sqrt_dt"]
    return _build.float_args([c["r"] * inv_n, f(-0.5) * inv_n, ds_dT, c["kappa"] * inv_n,
                              c["xi"] * ds_dT, c["dt"], c["kappa"] * c["dt"],
                              c["rho"] / c["rho_bar"], c["theta"], h_sdt, c["xi"] * h_sdt])


def euler_vjp_blocks(n_tiles: int) -> int:
    """Blocks (rows of sums) of the redesigned Euler VJP kernel: VJP_BLOCK
    paths a block, so PATH_TILE / VJP_BLOCK = 16 a tile with or without
    antithetics, none straddling a tile. Raises for what the kernel refuses
    (no tile, or a grid beyond 2^31 - 1 blocks)."""
    n_blocks = n_tiles * (PATH_TILE // VJP_BLOCK)
    if n_tiles < 1 or n_blocks >= 1 << 31:
        raise ValueError(f"the Euler VJP kernel takes 1 to 2^27 - 1 tiles, got {n_tiles}")
    return n_blocks


def _vjp_inputs(gS: torch.Tensor, gv, seed: int, S0, r, T, params, n_paths: int,
                n_steps: int, first_tile: int) -> tuple:
    """A VJP launch's tiles, its CUDA cotangents as contiguous float32
    (n_steps+1, n_pad) matrices and the forward's constants row."""
    _build.require_cuda(gS.device)
    n_tiles = _tiles(n_paths, PATH_TILE, seed, first_tile, n_steps)
    shape = (n_steps + 1, n_tiles * PATH_TILE)
    gS = cotangent(gS, shape)
    gv = None if gv is None else cotangent(gv, shape)
    return n_tiles, gS, gv, batched_consts("euler", S0, r, [T], params, n_steps, gS.device)


def _vjp_launch(name: str, n_blocks: int, extra, n_tiles: int, gS: torch.Tensor, gv, consts,
                seed: int, n_steps: int, antithetic: bool, first_tile: int) -> torch.Tensor:
    """One launch of C entry omt_``name`` on _vjp_inputs' tensors, ``extra``
    its tangent constants: its (n_blocks, 8) float64 rows of block sums."""
    rows = torch.empty((n_blocks, 8), dtype=torch.float64, device=gS.device)
    _build.launch(f"omt_{name}", gS.device, rows.data_ptr(), gS.data_ptr(),
                  None if gv is None else gv.data_ptr(), consts.data_ptr(), extra, seed,
                  first_tile, n_tiles, n_steps, int(antithetic), n_blocks)
    launches[name] += 1
    return rows


def euler_paths_vjp_rows(gS: torch.Tensor, gv, seed: int, S0, r, T, params, n_paths: int,
                         n_steps: int, antithetic: bool = True,
                         first_tile: int = 0) -> torch.Tensor:
    """One launch of csrc/greeks.cu's euler_vjp_kernel (the redesign) on CUDA
    cotangents gS, gv (n_steps+1, n_pad): its (euler_vjp_blocks, 8) float64
    rows of block sums (g S, g S t, then the six carried tangents), 16 a
    tile. It reads gS and gv only; ``gv`` None is a kernel flag, not a zero
    matrix."""
    n_tiles, gS, gv, consts = _vjp_inputs(gS, gv, seed, S0, r, T, params, n_paths, n_steps,
                                          first_tile)
    return _vjp_launch("euler_paths_vjp", euler_vjp_blocks(n_tiles),
                       _vjp_tangent_consts(r, T, params, n_steps), n_tiles, gS, gv, consts,
                       seed, n_steps, antithetic, first_tile)


def euler_paths_vjp_rows_first(gS: torch.Tensor, gv, seed: int, S0, r, T, params,
                               n_paths: int, n_steps: int, antithetic: bool = True,
                               first_tile: int = 0) -> torch.Tensor:
    """euler_paths_vjp_rows of the first design (euler_paths_vjp_kernel), the
    redesign's yardstick, which no pricer reaches: one row a 256 slots."""
    n_tiles, gS, gv, consts = _vjp_inputs(gS, gv, seed, S0, r, T, params, n_paths, n_steps,
                                          first_tile)
    n_slots = n_tiles * (PATH_TILE // 2 if antithetic else PATH_TILE)
    return _vjp_launch("euler_paths_vjp_first", -(-n_slots // VJP_BLOCK),
                       _vjp_extras(T, params, n_steps), n_tiles, gS, gv, consts, seed,
                       n_steps, antithetic, first_tile)


def _vjp_gradient(sums: torch.Tensor, S0, T, n_steps: int) -> torch.Tensor:
    """The 8 parameters' gradient from a launch's summed rows: dS0 and dr
    follow from the first two sums (dS_t/dS0 = S_t/S0, dls_t/dr = t dt)."""
    dt = float(np.float32(T)) / n_steps
    return torch.cat([(sums[0] / float(np.float32(S0)))[None], (sums[1] * dt)[None],
                      sums[2:]])


def euler_paths_vjp(gS: torch.Tensor, gv, seed: int, S0, r, T, params, n_paths: int,
                    n_steps: int, antithetic: bool = True,
                    first_tile: int = 0) -> torch.Tensor:
    """<gS, dS/dp> + <gv, dv/dp> of heston_paths for p = (S0, r, T, kappa,
    theta, xi, rho, v0), float64 (8,): the redesigned kernel's rows summed in
    a fixed order for CUDA cotangents, the plain version for CPU ones."""
    if gS.device.type == "cpu":
        return euler_paths_vjp_reference(gS, gv, seed, S0, r, T, params, n_paths, n_steps,
                                         antithetic, first_tile)
    sums = euler_paths_vjp_rows(gS, gv, seed, S0, r, T, params, n_paths, n_steps, antithetic,
                                first_tile).sum(0)
    return _vjp_gradient(sums, S0, T, n_steps)


def euler_paths_vjp_first(gS: torch.Tensor, gv, seed: int, S0, r, T, params, n_paths: int,
                          n_steps: int, antithetic: bool = True,
                          first_tile: int = 0) -> torch.Tensor:
    """euler_paths_vjp through the first design, on CUDA cotangents only."""
    sums = euler_paths_vjp_rows_first(gS, gv, seed, S0, r, T, params, n_paths, n_steps,
                                      antithetic, first_tile).sum(0)
    return _vjp_gradient(sums, S0, T, n_steps)


def euler_paths_ad(seed: int, S0, r, T, params, n_paths: int, n_steps: int,
                   antithetic: bool = True, return_variance: bool = False,
                   first_tile: int = 0, device=None):
    """heston_paths (Euler) in the autograd graph of (S0, r, T, kappa, theta,
    xi, rho, v0), any of them a 0-d tensor: the forward is the same launch
    with the same bits, the backward euler_paths_vjp."""
    fields = (params.kappa, params.theta, params.xi, params.rho, params.v0)

    def run(S0_, r_, T_, *p):
        return heston_paths(seed, S0_, r_, T_, HestonParams(*p), n_paths, n_steps,
                            antithetic, return_variance, first_tile, device)

    def vjp(grads, outs, S0_, r_, T_, *p):
        # S always takes a cotangent in the pricers; one that does not
        # (a loss on v alone) gets a zero matrix here.
        gS = torch.zeros_like(outs[0]) if grads[0] is None else grads[0]
        return euler_paths_vjp(gS, grads[1] if return_variance else None, seed, S0_,
                               r_, T_, HestonParams(*p), n_paths, n_steps, antithetic,
                               first_tile)

    return differentiable(run, vjp, S0, r, T, *fields)


def vjp_kernel_attrs() -> dict:
    """Registers, spills and occupancy of the VJP kernels of csrc/greeks.cu
    as built (the antithetic instances; Euler with v; the first designs of
    the Euler and GBM paths VJPs), by name."""
    return {name: _build.kernel_attrs("omt_greeks_attrs", i) for i, name in
            enumerate(("gbm_terminal_vjp", "gbm_paths_vjp", "euler_paths_vjp",
                       "euler_paths_vjp_first", "gbm_paths_vjp_first"))}
