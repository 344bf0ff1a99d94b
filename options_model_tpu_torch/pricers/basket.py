"""Multi-asset European options, as options_model_tpu/pricers/basket.py:
the arithmetic basket, best-of / worst-of rainbows and the 2-asset spread,
priced on kernel 28's exact terminal law (models/multiasset.
gbm_basket_terminal_exact). The arithmetic basket carries the
geometric-basket control variate: the geometric average of lognormals is
lognormal, so its price is closed form (``geometric_basket_bs_price``,
float64) and the arithmetic payoff regresses on it with the pair-mean
optimal beta.

The terminal kernel mirrors within TERMINAL_TILE, so the pair means of the
stderr and of the CV's beta reduce at that tile; the reference pairs (i, i
+ n/2) over the whole vector (basket.py:100), which the port's layout does
not have.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from options_model_tpu_torch.core.stats import masked_mean_stderr, optimal_cv_beta
from options_model_tpu_torch.models.multiasset import gbm_basket_terminal_exact
from options_model_tpu_torch.ops.cuda_heston import TERMINAL_TILE
from options_model_tpu_torch.ops.engine import checked_device
from options_model_tpu_torch.ops.philox import seed_from_generator
from options_model_tpu_torch.pricers.blackscholes import ndtr

_KINDS = ("basket", "best_of", "worst_of", "spread")


def _ndtr64(x: float) -> float:
    return float(ndtr(torch.tensor(x, dtype=torch.float64)))


def geometric_basket_bs_price(S0s, weights, K, T, r, sigmas, corr, cp=1.0,
                              div_yields=None) -> float:
    """Closed-form price (float64, on the host) of a European option on the
    geometric basket G_T = prod_i S_i^{w_i} under correlated GBM: log G_T
    is Gaussian with mean mu = sum_i w_i (log S0_i + (r - q_i - sigma_i^2 /
    2) T) and variance s2 = w' (sigma_i sigma_j rho_ij) w T, so the price
    is Black's at the forward F = exp(mu + s2 / 2)."""
    S0s = np.atleast_1d(np.asarray(S0s, np.float64))
    w = np.atleast_1d(np.asarray(weights, np.float64))
    sig = np.atleast_1d(np.asarray(sigmas, np.float64))
    q = (np.zeros_like(S0s) if div_yields is None
         else np.atleast_1d(np.asarray(div_yields, np.float64)))
    c = np.asarray(corr, np.float64)
    cov = np.outer(sig, sig) * c
    mu = float(w @ (np.log(S0s) + (r - q - 0.5 * sig**2) * T))
    s2 = float(w @ cov @ w) * T
    s = np.sqrt(max(s2, 1e-16))
    F = np.exp(mu + 0.5 * s2)
    d1 = (np.log(F / K) + 0.5 * s2) / s
    d2 = d1 - s
    disc = np.exp(-r * T)
    return float(cp * disc * (F * _ndtr64(cp * d1) - K * _ndtr64(cp * d2)))


def _basket_payoff(S_T: torch.Tensor, weights, K, cp, kind: str) -> torch.Tensor:
    """(n_paths,) undiscounted payoff from terminal prices (n_assets, P)."""
    if kind == "basket":
        w = torch.as_tensor(np.asarray(weights, np.float32), device=S_T.device).to(S_T.dtype)
        underlying = torch.tensordot(w, S_T, dims=1)
    elif kind == "best_of":
        underlying = S_T.max(dim=0).values
    elif kind == "worst_of":
        underlying = S_T.min(dim=0).values
    elif kind == "spread":
        if S_T.shape[0] != 2:
            raise ValueError("spread requires exactly 2 assets")
        underlying = S_T[0] - S_T[1]
    else:
        raise ValueError(f"kind must be one of {_KINDS}, got {kind!r}")
    return torch.clamp_min(cp * (underlying - K), 0.0)


def price_basket_mc(generator: torch.Generator, S0s, weights, K, T, r, sigmas, corr,
                    cp=1.0, *, kind: str = "basket", n_paths: int = 1 << 18,
                    div_yields=None, antithetic: bool = True, control_variate: bool = True,
                    device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """European multi-asset option price: (price, stderr) 0-d tensors.

    kind: 'basket' (weighted average), 'best_of' / 'worst_of' (rainbow on
    the extreme asset), 'spread' (S1 - S2, 2 assets). One 64-bit seed is
    drawn from ``generator``; n_paths rounds up to TERMINAL_TILE. For
    'basket' with ``control_variate`` and positive weights the geometric
    basket is priced on the same paths and recentred at its closed form
    with the pair-mean optimal beta (E[adj] = 0, so the estimator stays
    unbiased)."""
    if kind not in _KINDS:
        raise ValueError(f"kind must be one of {_KINDS}, got {kind!r}")
    device = checked_device(device)
    S_T = gbm_basket_terminal_exact(seed_from_generator(generator), S0s, r, sigmas, corr, T,
                                    n_paths, div_yields=div_yields, antithetic=antithetic,
                                    device=device)
    disc = float(np.exp(-np.float32(r) * np.float32(T)))
    cash = _basket_payoff(S_T, weights, K, cp, kind) * disc
    pb = TERMINAL_TILE if antithetic else None
    w = np.atleast_1d(np.asarray(weights, np.float64))
    if control_variate and kind == "basket" and np.all(w > 0):
        wj = torch.as_tensor(w.astype(np.float32), device=device)
        geo = torch.exp(torch.tensordot(wj, torch.log(S_T), dims=1))
        geo_cash = torch.clamp_min(cp * (geo - K), 0.0) * disc
        geo_cf = geometric_basket_bs_price(S0s, w, K, T, r, sigmas, corr, cp, div_yields)
        adj = geo_cf - geo_cash  # E[adj] = 0 under the exact terminal law
        cash = cash + optimal_cv_beta(cash, adj, pair_block=pb) * adj
    mean, stderr, _ = masked_mean_stderr(cash, pair_block=pb)
    return mean, stderr
