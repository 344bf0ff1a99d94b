"""Merton (1976) jump diffusion (options_model_tpu/models/merton.py): paths
on the port's Philox stream, and the closed-form European series.

Conditional on its count N ~ Poisson(lam dt), a step's compound jump sum is
N mu_j + sigma_j sqrt(N) z_j, so each step is three draws (the diffusion
normal z, the count, the jump-size normal z_j) and

    log S_t = log S_{t-1} + (r - sigma^2/2 - lam kbar) dt + sigma sqrt(dt) z
              + N mu_j + sigma_j sqrt(N) z_j.

``merton_from_draws`` is that recursion on given (z, N, z_j), the plain
version the kernels of csrc/jumps.cu (14 paths, 15 terminal) are held
against. ``simulate_merton`` draws from their stream (ops/philox.py: one
Philox call per pair-step, z and z_j mirrored, the two Poisson uniforms
full width) and dispatches on the device. ``merton_price`` is the jump-count
series, the control variate's closed form and the Merton oracle.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from options_model_tpu_torch._unported import not_ported
from options_model_tpu_torch.core.config import MCConfig, MertonParams
from options_model_tpu_torch.models.blocks import paths_rounded
from options_model_tpu_torch.ops.autodiff import requires_grad


def merton_constants(S0, r, T, params: MertonParams, n_steps: int) -> dict:
    """float32 constants rounded as the reference's simulate_merton:
    dt = f32(T) / n_steps, kbar = exp(mu_j + sigma_j^2/2) - 1, drift =
    (r - sigma^2/2 - lam kbar) dt, diffusion = sigma sqrt(dt); and lam_dt,
    the Poisson mean of a step, in float64 (the Poisson table's input)."""
    f = np.float32
    dt = f(T) / f(n_steps)
    sig, lam = f(params.sigma), f(params.lam)
    mu_j, sig_j = f(params.mu_j), f(params.sigma_j)
    kbar = np.exp(mu_j + f(0.5) * sig_j * sig_j) - f(1.0)
    return dict(log_s0=np.log(f(S0)), drift=(f(r) - f(0.5) * sig * sig - lam * kbar) * dt,
                diffusion=sig * np.sqrt(dt), mu_j=mu_j, sigma_j=sig_j,
                lam_dt=float(params.lam) * float(T) / n_steps)


def jump_sum(n: torch.Tensor, z_j: torch.Tensor, mu_j, sigma_j) -> torch.Tensor:
    """N mu_j + sigma_j sqrt(N) z_j: a step's summed log-jump given its count."""
    return n * mu_j + sigma_j * torch.sqrt(n) * z_j


def merton_from_draws(z: torch.Tensor, n: torch.Tensor, z_j: torch.Tensor, S0, r, T,
                      params: MertonParams, return_paths: bool = True) -> torch.Tensor:
    """The log-space walk on draws z, n (counts, as floats) and z_j, each
    (n_steps, n_paths): paths S = exp(log S0 + x_t) with row 0 = S0, shape
    (n_steps+1, n_paths), or S_T (n_paths,). x adds each step's increment
    drift + diffusion z + jump_sum, in z's dtype."""
    c = {k: float(v) for k, v in merton_constants(S0, r, T, params, z.shape[0]).items()}
    x = torch.zeros(z.shape[1], dtype=z.dtype, device=z.device)
    rows = [torch.exp(c["log_s0"] + x)] if return_paths else None
    for t in range(z.shape[0]):
        x = x + (c["drift"] + c["diffusion"] * z[t]
                 + jump_sum(n[t], z_j[t], c["mu_j"], c["sigma_j"]))
        if return_paths:
            rows.append(torch.exp(c["log_s0"] + x))
    return torch.stack(rows) if return_paths else torch.exp(c["log_s0"] + x)


def simulate_merton(seed: int, S0, r, T, params: MertonParams, cfg: MCConfig,
                    return_paths: bool = True, first_tile: int = 0,
                    device: Optional[torch.device] = None) -> torch.Tensor:
    """Merton paths from the kernels' stream: on a CUDA device kernel 14
    (paths) or 15 (terminal) of csrc/jumps.cu, on the CPU their plain
    versions. (n_steps+1, n_pad) or S_T (n_pad,), n_pad rounding
    paths_rounded(cfg) up to the kernel tile (PATH_TILE for paths,
    TERMINAL_TILE for terminal values). ``r`` is the drift (rate - q); the
    compensator -lam kbar dt keeps the discounted price a martingale."""
    from options_model_tpu_torch.ops import cuda_jumps

    if requires_grad(S0, r, T, params.sigma, params.lam, params.mu_j, params.sigma_j):
        raise not_ported("gradients of the Merton paths (pathwise Greeks through the "
                         "jump kernels)", "models.merton.simulate_merton")
    fn = cuda_jumps.merton_paths if return_paths else cuda_jumps.merton_terminal
    return fn(seed, S0, r, T, params, paths_rounded(cfg), cfg.n_steps, cfg.antithetic,
              first_tile, device)


def merton_price(S0, K, T, r, params: MertonParams, cp=1.0, q=0.0, n_terms: int = 40,
                 dtype=torch.float32, device=None) -> torch.Tensor:
    """Merton's European price by conditioning on the jump count:

        sum_n e^{-lam T} (lam T)^n / n! e^{-rT} Black(F_n, K, sigma_n),

    F_n = S0 e^{(r_n - q) T}, sigma_n^2 = sigma^2 + n sigma_j^2 / T, r_n =
    r - lam kbar + n log(1 + kbar) / T, over n_terms terms (lam T up to
    ~10). Broadcasts over S0, K and T (the terms on a trailing axis); the
    parameters may be 0-d tensors (merton_greeks differentiates them). A
    tensor among S0, K and T sets the device and dtype, otherwise ``dtype``
    on ``device`` (the card by default)."""
    from options_model_tpu_torch.pricers.blackscholes import _tensors, ndtr

    S0, K, T = _tensors((S0, K, T), dtype, device)
    as_t = lambda v: torch.as_tensor(v, dtype=S0.dtype, device=S0.device)  # noqa: E731
    sig2 = as_t(params.sigma) ** 2
    sig_j2 = as_t(params.sigma_j) ** 2
    lam = as_t(params.lam)
    kbar = torch.exp(as_t(params.mu_j) + 0.5 * sig_j2) - 1.0
    log1k = torch.log1p(kbar)
    S0, K, T = (x[..., None] for x in torch.broadcast_tensors(S0, K, T))

    n = torch.arange(n_terms, dtype=S0.dtype, device=S0.device)
    lamT = lam * T
    logw = -lamT + n * torch.log(torch.clamp_min(lamT, 1e-30)) - torch.lgamma(n + 1.0)
    w = torch.where(lamT > 0, torch.exp(logw), (n == 0).to(S0.dtype))

    sig_n = torch.sqrt(sig2 + n * sig_j2 / T)
    r_n = r - lam * kbar + n * log1k / T
    F = S0 * torch.exp((r_n - q) * T)
    sq = sig_n * torch.sqrt(T)
    d1 = (torch.log(F / K) + 0.5 * sig_n**2 * T) / sq
    d2 = d1 - sq
    black = cp * (F * ndtr(cp * d1) - K * ndtr(cp * d2))
    return torch.exp(-r * T[..., 0]) * torch.sum(w * black, dim=-1)
