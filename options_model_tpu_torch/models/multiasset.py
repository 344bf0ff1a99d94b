"""Correlated multi-asset GBM (options_model_tpu/models/multiasset.py) for
the basket, rainbow and spread pricers.

Per step and asset, with L the lower Cholesky factor of the correlation
of the driving Brownians and z the asset's uncorrelated normal:

    W_a = sum_{b <= a} L[a, b] z_b,    acc_a += drift_a + vol_a W_a,
    S_a = S0_a exp(acc_a),

drift_a = (r - q_a - sigma_a^2 / 2) dt and vol_a = sigma_a sqrt(dt) in
float32, dt = T / n_steps (multiasset.py:68-75). ``basket_chain`` is this
recursion on given normals, summing W over ascending b with each product
rounded and then added, never as ``L @ z``: the plain version the
kernels of csrc/basket.cu (27 paths, 28 terminal) equal bit for bit in W
and the log-states given the same normals.

``simulate_gbm_basket`` draws from the basket stream (ops/philox.
basket_path_draws, counter word 3 = 6) and runs kernel 27 or 28 on a CUDA
device, their plain versions on the CPU; both modes walk PATH_TILE tiles,
so the terminal values are the paths' last row bit for bit. The antithetic
mirror of slot j is path j + tile/2 of its tile, with -z for every asset:
pair means reduce at the tile, where the reference pairs (i, i + n/2)
over the whole vector.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from options_model_tpu_torch.core.config import MCConfig
from options_model_tpu_torch.models.blocks import paths_rounded


def correlation_cholesky(corr) -> torch.Tensor:
    """Lower Cholesky factor of a correlation matrix (float32), validated
    and factored in float64 as the reference does: ValueError for a matrix
    that is not square, not symmetric, without a unit diagonal or not
    positive definite."""
    c = np.asarray(corr, np.float64)
    if c.ndim != 2 or c.shape[0] != c.shape[1]:
        raise ValueError(f"corr must be square, got shape {c.shape}")
    if not np.allclose(c, c.T, atol=1e-8):
        raise ValueError("corr must be symmetric")
    if not np.allclose(np.diag(c), 1.0, atol=1e-8):
        raise ValueError("corr must have unit diagonal")
    try:
        L = np.linalg.cholesky(c)
    except np.linalg.LinAlgError as e:
        raise ValueError("corr must be positive definite") from e
    return torch.from_numpy(L.astype(np.float32))


def _vector(x, n: Optional[int] = None) -> np.ndarray:
    v = np.atleast_1d(np.asarray(x, np.float32)).reshape(-1)
    if n is not None and v.shape[0] == 1 and n > 1:
        v = np.repeat(v, n)
    return v


def basket_constants(S0, r, sigmas, L, T, n_steps: int, div_yields=None) -> dict:
    """float32 constants of the recursion: s0, drift, vol (n,) and L (n, n),
    each rounded as the reference's float32 arithmetic: dt = f32(T) /
    n_steps, drift = (r - q - 0.5 sigma^2) dt, vol = sigma sqrt(dt)."""
    f = np.float32
    s0 = _vector(S0)
    n = s0.shape[0]
    sig = _vector(sigmas)
    if sig.shape[0] != n:
        raise ValueError("S0 and sigmas must have the same length")
    q = np.zeros(n, f) if div_yields is None else _vector(div_yields, n)
    if q.shape[0] != n:
        raise ValueError("div_yields must have one entry per asset")
    L = np.asarray(L.numpy() if isinstance(L, torch.Tensor) else L, f)
    if L.shape != (n, n):
        raise ValueError("corr dimension must match the number of assets")
    dt = f(T) / f(n_steps)
    drift = ((f(r) - q) - f(0.5) * sig * sig) * dt
    vol = sig * np.sqrt(dt)
    return dict(s0=s0, drift=drift.astype(f), vol=vol.astype(f), L=L)


def basket_chain(z: torch.Tensor, c: dict, mode: str = "terminal"):
    """The recursion on normals z (n_steps, n, P) with constants c
    (basket_constants). ``mode``: "terminal" S_T (n, P); "paths" S
    (n_steps+1, n, P), row 0 the spot; "debug" (the log-states acc
    (n_steps+1, n, P) with row 0 zero, W (n_steps, n, P)), what kernel 27's
    debug launch writes. W accumulates column by column, so row a sums its
    products over ascending b."""
    n_steps, n, P = z.shape
    dev = z.device
    L = torch.from_numpy(c["L"]).to(dev)
    drift = torch.from_numpy(c["drift"]).to(dev)[:, None]
    vol = torch.from_numpy(c["vol"]).to(dev)[:, None]
    s0 = torch.from_numpy(c["s0"]).to(dev)[:, None]
    acc = torch.zeros((n, P), dtype=torch.float32, device=dev)
    rows, ws = [acc], []
    for z_t in z:
        W = L[:, :1] * z_t[0]
        for b in range(1, n):
            W[b:] = W[b:] + L[b:, b:b + 1] * z_t[b]
        acc = acc + (drift + vol * W)
        if mode != "terminal":
            rows.append(acc)
        if mode == "debug":
            ws.append(W)
    if mode == "terminal":
        return s0 * torch.exp(acc)
    if mode == "debug":
        return torch.stack(rows), torch.stack(ws)
    return torch.stack([s0 * torch.exp(a) for a in rows])


def gbm_basket_from_normals(z: torch.Tensor, S0, r, sigmas, L, T, *, div_yields=None,
                            return_paths: bool = False) -> torch.Tensor:
    """The recursion on given uncorrelated normals z (n_steps, n_assets,
    P): S_T (n, P), or with ``return_paths`` (n_steps+1, n, P)."""
    c = basket_constants(S0, r, sigmas, L, T, z.shape[0], div_yields)
    return basket_chain(z, c, "paths" if return_paths else "terminal")


def simulate_gbm_basket(seed: int, S0, r, sigmas, corr, T, cfg: MCConfig, *, div_yields=None,
                        return_paths: bool = False, first_tile: int = 0,
                        device=None) -> torch.Tensor:
    """n correlated GBM assets on the basket stream: S_T (n_assets, n_pad),
    or with ``return_paths`` (n_steps+1, n_assets, n_pad), n_pad rounding
    paths_rounded(cfg) up to PATH_TILE. S0, sigmas, div_yields: (n,); corr:
    (n, n), the correlation of the driving Brownians. Kernel 27 (paths) or
    28 (terminal) on a CUDA device, their plain versions on the CPU; the
    same stream in both modes."""
    from options_model_tpu_torch.ops import cuda_basket
    from options_model_tpu_torch.ops.cuda_heston import PATH_TILE

    c = basket_constants(S0, r, sigmas, correlation_cholesky(corr), T, cfg.n_steps,
                         div_yields)
    fn = cuda_basket.basket_paths if return_paths else cuda_basket.basket_terminal
    return fn(seed, c, paths_rounded(cfg), cfg.n_steps, cfg.antithetic, first_tile, PATH_TILE,
              device)


def gbm_basket_terminal_exact(seed: int, S0, r, sigmas, corr, T, n_paths: int, *,
                              div_yields=None, antithetic: bool = True, first_tile: int = 0,
                              device=None) -> torch.Tensor:
    """The one-draw exact terminal law (n_assets, n_pad): kernel 28 at one
    step of length T, n_pad = n_paths rounded up to TERMINAL_TILE. The
    mirror of path j is j + TERMINAL_TILE/2 within its tile, so pair means
    reduce at TERMINAL_TILE."""
    from options_model_tpu_torch.ops import cuda_basket
    from options_model_tpu_torch.ops.cuda_heston import TERMINAL_TILE

    c = basket_constants(S0, r, sigmas, correlation_cholesky(corr), T, 1, div_yields)
    return cuda_basket.basket_terminal(seed, c, n_paths, 1, antithetic, first_tile,
                                       TERMINAL_TILE, device)
