"""Loss components of the IV-surface fit, as options_model_tpu/surface/loss.py:
per-sample vega weights, which travel with their samples, and the
finite-difference no-arbitrage penalties, as per-sample means.
"""

from __future__ import annotations

from typing import Callable

import torch

from options_model_tpu_torch.pricers.blackscholes import bs_vega
from options_model_tpu_torch.surface.scaler import SurfaceScaler


def vega_weights(K, T, sigma_iv, S0: float, rate: float = 0.05, device=None) -> torch.Tensor:
    """Normalized per-sample vega weights: max(vega / 100, 1e-8), scaled to
    mean 1 (float32, on ``device``, the card by default)."""
    v = bs_vega(S0, K, T, rate, sigma_iv, device=device)
    w = torch.clamp_min(v / 100.0, 1e-8)
    return w / w.mean()


def arbitrage_penalty_fd(apply_fn: Callable, X: torch.Tensor, scaler: SurfaceScaler,
                         lambda_butterfly: float = 1e-3, lambda_calendar: float = 1e-4,
                         eps_m_orig: float = 1e-3,
                         eps_t_orig: float = 1.0 / 365.0) -> torch.Tensor:
    """Finite-difference no-arbitrage penalties on the normalized grid.

    apply_fn(X) -> (n, 1) IVs. Butterfly: convexity in log-moneyness,
    mean(max(-d2w/dm2, 0)); calendar: monotonicity in tau,
    mean(max(-dw/dtau, 0)). The steps are given in original units and
    converted through the scaler."""
    eps_m = eps_m_orig / scaler.m_scale
    eps_t = eps_t_orig / scaler.tau_scale
    e_m = torch.zeros_like(X)
    e_m[:, 0] = eps_m
    e_t = torch.zeros_like(X)
    e_t[:, 1] = eps_t

    w_center = apply_fn(X)[:, 0]
    w_plus = apply_fn(X + e_m)[:, 0]
    w_minus = apply_fn(X - e_m)[:, 0]
    d2w_dm2 = (w_plus - 2.0 * w_center + w_minus) / (eps_m**2)
    # torch.maximum, not clamp_min: at a tie (a flat surface, d2w = 0) it
    # splits the gradient in halves, as jnp.maximum does; clamp_min passes
    # it whole.
    zero = torch.zeros((), dtype=X.dtype, device=X.device)
    butterfly = torch.maximum(-d2w_dm2, zero).mean()
    dw_dtau = (apply_fn(X + e_t)[:, 0] - w_center) / eps_t
    calendar = torch.maximum(-dw_dtau, zero).mean()
    return lambda_butterfly * butterfly + lambda_calendar * calendar
