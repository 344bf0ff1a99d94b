"""Variance Gamma (Madan-Carr-Chang 1998) paths on the port's Philox
stream, as options_model_tpu/models/vg.py.

Conditional on the gamma clock's increment G = nu Gamma(dt / nu), a step's
log increment is exact:

    log S_t = log S_{t-1} + (r + omega) dt + theta G + sigma sqrt(G) z,

omega = log(1 - theta nu - sigma^2 nu / 2) / nu, the martingale
compensator. So the terminal law needs one step (``vg_terminal_exact``)
and ``n_steps`` only sets the exercise grid. The normal z is mirrored
within a tile; the gamma clock is drawn for every path (no reflection of a
gamma variate preserves its law), so pairs share their conditional-normal
noise and pair means stay the i.i.d. unit of the stderr.

``vg_from_draws`` is the recursion on given (z, G), the plain version the
kernels of csrc/vg.cu (21 paths, 22 terminal) are held against.
``simulate_vg`` and ``vg_terminal_exact`` draw from their stream
(ops/philox.py: VG_STREAM, Marsaglia-Tsang gamma draws) and dispatch on the
device; ``simulate_vg_maturities`` draws a batch of maturities in one
launch of kernel 21.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from options_model_tpu_torch._unported import not_ported
from options_model_tpu_torch.core.config import MCConfig, VGParams
from options_model_tpu_torch.models.blocks import paths_rounded
from options_model_tpu_torch.ops.autodiff import requires_grad


def vg_constants(S0, r, T, params: VGParams, n_steps: int) -> dict:
    """float32 constants rounded as the reference's simulate_vg: dt = f32(T)
    / n_steps, omega = log1p(-theta nu - sigma^2 nu / 2) / nu, drift = (r +
    omega) dt, and the gamma shape a = dt / nu of a step. Elementwise over
    an array of maturities T."""
    f = np.float32
    sig, th, nu = f(params.sigma), f(params.theta), f(params.nu)
    dt = f(T) / f(n_steps)
    omega = np.log1p(-th * nu - f(0.5) * sig * sig * nu) / nu
    return dict(log_s0=np.log(f(S0)), drift=(f(r) + omega) * dt, theta=th, sigma=sig, nu=nu,
                shape=dt / nu)


def _check_grad(fn: str, *args) -> None:
    if requires_grad(*args):
        raise not_ported(f"gradients of the VG paths ({fn} through csrc/vg.cu)", f"models.vg.{fn}")


def vg_from_draws(z: torch.Tensor, G: torch.Tensor, S0, r, T, params: VGParams,
                  return_paths: bool = True) -> torch.Tensor:
    """The log-space walk on draws z and G = nu Gamma(dt / nu), each
    (n_steps, n_paths): paths S = exp(log S0 + x_t) with row 0 = S0, shape
    (n_steps+1, n_paths), or S_T (n_paths,). x adds each step's increment
    (drift + theta G) + (sigma sqrt(G)) z, in z's dtype."""
    c = {k: float(v) for k, v in vg_constants(S0, r, T, params, z.shape[0]).items()}
    x = torch.zeros(z.shape[1], dtype=z.dtype, device=z.device)
    rows = [torch.exp(c["log_s0"] + x)] if return_paths else None
    for t in range(z.shape[0]):
        x = x + ((c["drift"] + c["theta"] * G[t]) + c["sigma"] * torch.sqrt(G[t]) * z[t])
        if return_paths:
            rows.append(torch.exp(c["log_s0"] + x))
    return torch.stack(rows) if return_paths else torch.exp(c["log_s0"] + x)


def simulate_vg(seed: int, S0, r, T, params: VGParams, cfg: MCConfig,
                return_paths: bool = True, first_tile: int = 0,
                device: Optional[torch.device] = None) -> torch.Tensor:
    """VG paths (n_steps+1, n_pad) from kernel 21 (csrc/vg.cu on a CUDA
    device, its plain version on the CPU), n_pad rounding paths_rounded(cfg)
    up to PATH_TILE; without ``return_paths`` their last row. ``r`` is the
    drift (rate - q)."""
    from options_model_tpu_torch.ops import cuda_vg

    _check_grad("simulate_vg", S0, r, T, params.sigma, params.theta, params.nu)
    S = cuda_vg.vg_paths(seed, S0, r, [T], params, paths_rounded(cfg), cfg.n_steps,
                         cfg.antithetic, first_tile, device)[0]
    return S if return_paths else S[-1]


def simulate_vg_maturities(seed: int, S0, r, Ts, params: VGParams, cfg: MCConfig,
                           first_tile: int = 0, device: Optional[torch.device] = None):
    """VG path matrices of every maturity in ``Ts``, S (n_mat, n_steps+1,
    n_pad), from one launch of kernel 21. Maturity m is simulate_vg at
    first_tile + m n_tiles, n_tiles = n_pad / PATH_TILE."""
    from options_model_tpu_torch.ops import cuda_vg

    _check_grad("simulate_vg", S0, r, *Ts if isinstance(Ts, (list, tuple)) else (Ts,),
                params.sigma, params.theta, params.nu)
    return cuda_vg.vg_paths(seed, S0, r, Ts, params, paths_rounded(cfg), cfg.n_steps,
                            cfg.antithetic, first_tile, device)


def vg_terminal_exact(seed: int, S0, r, T, params: VGParams, cfg: MCConfig,
                      first_tile: int = 0, device: Optional[torch.device] = None) -> torch.Tensor:
    """Exact terminal samples S_T (n_pad,), one gamma and one normal a path
    whatever ``cfg.n_steps``: kernel 22 (csrc/vg.cu) on a CUDA device, its
    plain version on the CPU; n_pad rounds up to TERMINAL_TILE."""
    from options_model_tpu_torch.ops import cuda_vg

    _check_grad("vg_terminal_exact", S0, r, T, params.sigma, params.theta, params.nu)
    return cuda_vg.vg_terminal(seed, S0, r, T, params, paths_rounded(cfg), cfg.antithetic,
                               first_tile, device)
