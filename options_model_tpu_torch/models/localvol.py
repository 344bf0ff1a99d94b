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

The bare route (options_model_tpu/models/localvol.py:27-62) takes any
``sigma_fn(S, tau)``, the surface network's adapter (surface/model.py) or
SVI's Dupire local vol (surface/svi.py), and runs the reference's step in
PyTorch:

    tau_t = max(T - t dt, 1e-6),  sigma = max(sigma_fn(exp(log S), tau_t), 1e-6)
    log S <- log S + (r - sigma^2/2) dt + sigma sqrt(dt) z

(``localvol_from_sigma_fn_normals``). Its normals are the table route's:
the same tiles of the same seed (PATH_TILE for paths, TERMINAL_TILE for
terminal values), drawn on a CUDA device by the normals kernel
(ops/philox.draw_path_normals, csrc/philox.cu), on the CPU by path_normals.
It simulates BARE_CHUNK_PATHS paths at a time, so the network's
activations stay bounded. A table, when given, takes precedence.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from options_model_tpu_torch.core.config import MCConfig
from options_model_tpu_torch.models.blocks import paths_rounded
from options_model_tpu_torch.surface.cheb import LocalVolTable

# Paths the bare route simulates at once: one float32 activation of a
# width-64 network is then 256 MiB (1 GiB at 2^22 paths).
BARE_CHUNK_PATHS = 1 << 20


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


def localvol_from_sigma_fn_normals(z: torch.Tensor, S0, r, T, sigma_fn,
                                   return_paths: bool = True) -> torch.Tensor:
    """The reference's local-vol step under ``sigma_fn`` on normals z
    (n_steps, n_paths), in float32: S (n_steps+1, n_paths), row 0 =
    exp(log S0), or S_T (n_paths,). tau_t and the constants are float32
    numbers as the reference's are (dt = f32(T) / n_steps)."""
    f = np.float32
    n_steps = z.shape[0]
    T32 = f(T)
    dt = T32 / f(n_steps)
    r_, dt_, sqrt_dt = float(f(r)), float(dt), float(np.sqrt(dt))
    log_s = torch.log(torch.full((z.shape[1],), float(f(S0)), dtype=torch.float32,
                                 device=z.device))
    rows = [log_s]
    for t in range(n_steps):
        tau = torch.tensor(max(T32 - f(t) * dt, f(1e-6)), dtype=torch.float32)
        sig = torch.clamp_min(torch.as_tensor(sigma_fn(torch.exp(log_s), tau)), 1e-6)
        sig = sig.to(device=z.device, dtype=torch.float32)
        log_s = log_s + (r_ - 0.5 * sig**2) * dt_ + sig * sqrt_dt * z[t]
        if return_paths:
            rows.append(log_s)
    if not return_paths:
        return torch.exp(log_s)
    return torch.exp(torch.stack(rows))


def _simulate_bare(seed: int, S0, r, T, cfg: MCConfig, sigma_fn, return_paths: bool,
                   first_tile: int, device) -> torch.Tensor:
    """The bare route over the table route's tiles, BARE_CHUNK_PATHS at a time."""
    from options_model_tpu_torch.ops.cuda_heston import PATH_TILE, TERMINAL_TILE, _tiles
    from options_model_tpu_torch.ops.engine import resolve_device
    from options_model_tpu_torch.ops.philox import draw_path_normals

    device = resolve_device(device)
    tile = PATH_TILE if return_paths else TERMINAL_TILE
    n_tiles = _tiles(paths_rounded(cfg), tile, seed, first_tile, cfg.n_steps)
    chunk = max(1, BARE_CHUNK_PATHS // tile)
    out = []
    for c in range(0, n_tiles, chunk):
        z = draw_path_normals(seed, first_tile + c, min(chunk, n_tiles - c), tile, cfg.n_steps,
                              cfg.antithetic, device)
        out.append(localvol_from_sigma_fn_normals(z, S0, r, T, sigma_fn, return_paths))
        del z  # free this chunk's normals before the next chunk's are drawn
    return torch.cat(out, dim=-1)


def simulate_local_vol(seed: int, S0, r, T, cfg: MCConfig, *,
                       table: Optional[LocalVolTable] = None, sigma_fn=None,
                       return_paths: bool = True, first_tile: int = 0,
                       device: Optional[torch.device] = None) -> torch.Tensor:
    """Local-vol paths (n_steps+1, n_pad) or S_T (n_pad,) from the kernels'
    stream, n_pad rounding paths_rounded(cfg) up to the tile. Under a
    compiled ``table``: kernels 7 and 8 on a CUDA device
    (csrc/localvol_paths.cu for paths, csrc/terminal.cu for terminal
    values), their plain versions on the CPU. Else under a bare
    ``sigma_fn``: the module docstring's bare route. Neither raises."""
    if table is not None:
        from options_model_tpu_torch.ops import cuda_localvol

        fn = cuda_localvol.localvol_paths if return_paths else cuda_localvol.localvol_terminal
        return fn(seed, S0, r, T, table, paths_rounded(cfg), cfg.n_steps, cfg.antithetic,
                  first_tile, device)
    if sigma_fn is None:
        raise ValueError("sigma_fn (or a compiled localvol table) is required for local vol")
    return _simulate_bare(seed, S0, r, T, cfg, sigma_fn, return_paths, first_tile, device)
