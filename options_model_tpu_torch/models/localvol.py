"""Local-volatility paths over a compiled Chebyshev table
(options_model_tpu/models/localvol.py and ops/pallas_localvol.py):

    u     = clip(((log K - log S) - m_center) / m_half, -1, 1)
    sigma = max(Clenshaw(coeffs[t], u), 1e-6)
    log S <- log S + (r - sigma^2/2) dt + sigma sqrt(dt) z.

``localvol_euler_from_normals`` follows the TPU kernel's formula (absolute
log S, the moneyness from log K - log S, 1/m_half as a multiplier), not the
XLA simulator's log(K / exp(log S)): the two differ in the last ulps. It is
the plain version the local-vol kernels (the paths kernel of
csrc/localvol.cu, the terminal kernel of csrc/terminal.cu) are held against.
``simulate_local_vol`` draws the GBM stream (one normal per step,
ops/philox.path_normals), so a constant-sigma table reproduces the GBM
kernels' draws.

The surface-network route (a bare ``sigma_fn`` evaluated inside the time
loop) is not ported.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from options_model_tpu_torch._unported import not_ported
from options_model_tpu_torch.core.config import MCConfig
from options_model_tpu_torch.models.blocks import paths_rounded
from options_model_tpu_torch.surface.cheb import LocalVolTable


def check_table(table: LocalVolTable, n_steps: int) -> None:
    """Row t drives step t: a table with fewer than n_steps rows raises."""
    if table.coeffs.shape[0] < n_steps:
        raise ValueError(
            f"localvol table has {table.coeffs.shape[0]} step slices but "
            f"n_steps={n_steps}; recompile with compile_localvol_table(..., "
            f"n_steps={n_steps})")


def localvol_constants(S0, r, T, table: LocalVolTable, n_steps: int) -> dict:
    """float32 constants as the TPU kernel's parameter row
    (pallas_localvol.py:78-81): dt = f32(T) / n_steps, log K in f32,
    1 / m_half rounded once to f32; log S0 and sqrt(dt) in f32."""
    f = np.float32
    dt = f(T) / f(n_steps)
    return dict(log_s0=np.log(f(S0)), r=f(r), dt=dt, sqrt_dt=np.sqrt(dt),
                log_k=np.log(f(table.K)), m_center=f(table.m_center),
                inv_m_half=f(1.0 / table.m_half))


def localvol_euler_from_normals(z: torch.Tensor, S0, r, T, table: LocalVolTable,
                                return_paths: bool = True) -> torch.Tensor:
    """Log-Euler under the table on normals z (n_steps, n_paths). Returns S
    (n_steps+1, n_paths), row 0 = exp(log S0), or S_T (n_paths,)."""
    n_steps = z.shape[0]
    check_table(table, n_steps)
    c = {k: float(v) for k, v in localvol_constants(S0, r, T, table, n_steps).items()}
    coeffs = table.coeffs[:n_steps].cpu().tolist()
    log_s = torch.full((z.shape[1],), c["log_s0"], dtype=torch.float32, device=z.device)
    rows = [log_s]
    for c_t, z_t in zip(coeffs, z):
        u = torch.clamp(((c["log_k"] - log_s) - c["m_center"]) * c["inv_m_half"], -1.0, 1.0)
        b1 = torch.zeros_like(u)
        b2 = torch.zeros_like(u)
        for k in range(len(c_t) - 1, 0, -1):
            b1, b2 = c_t[k] + 2.0 * u * b1 - b2, b1
        sig = torch.clamp_min(c_t[0] + u * b1 - b2, 1e-6)
        log_s = log_s + (c["r"] - 0.5 * sig * sig) * c["dt"] + sig * c["sqrt_dt"] * z_t
        if return_paths:
            rows.append(log_s)
    if not return_paths:
        return torch.exp(log_s)
    return torch.exp(torch.stack(rows))


def simulate_local_vol(seed: int, S0, r, T, cfg: MCConfig, *,
                       table: Optional[LocalVolTable] = None, sigma_fn=None,
                       return_paths: bool = True, first_tile: int = 0,
                       device: Optional[torch.device] = None) -> torch.Tensor:
    """Local-vol paths under a compiled table from the kernels' stream (on a
    CUDA device csrc/localvol.cu for paths, csrc/terminal.cu for terminal
    values; on the CPU their plain versions):
    (n_steps+1, n_pad) or S_T (n_pad,), n_pad rounding paths_rounded(cfg)
    up to the kernel tile."""
    if table is None:
        raise not_ported("local vol without a compiled table (a bare sigma_fn, the "
                         "surface-network route)", "models.localvol.simulate_local_vol")
    from options_model_tpu_torch.ops import cuda_localvol

    fn = cuda_localvol.localvol_paths if return_paths else cuda_localvol.localvol_terminal
    return fn(seed, S0, r, T, table, paths_rounded(cfg), cfg.n_steps, cfg.antithetic,
              first_tile, device)
