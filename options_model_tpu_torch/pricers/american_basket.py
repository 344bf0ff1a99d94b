"""Bermudan multi-asset options by Longstaff-Schwartz on correlated GBM
paths (kernel 27), as options_model_tpu/pricers/american_basket.py:
backward induction over the joint state of n assets, every simulation
date an exercise date.

The basis works on the order statistics of the moneyness vector (sorted
descending), each smooth column masked-centred before the powers, plus the
full quadratic and the intrinsic hinge: the reference's columns in its
order, without the basket-value column it removed (a weighted sum of the
assets is collinear with the sorted values and made the Gram singular,
american_basket.py:59-64). Validated by the reference against Andersen and
Broadie's (2004) 2-asset Bermudan max-call.

The Grams run in full float32 (or the paths' float64): this raises if TF32
matmuls are on, as ``lsm_poly_backward`` does. Above FLOAT32_GRAM_ASSETS
assets float32 paths regress in float64: the basis's 1 + 2n + n(n-1)/2 + 1
columns of collinear order statistics leave a float32 Gram without a
usable Cholesky factor at 50 assets (1,327 columns), where no path then
exercises and the price is the European's. The reference solves in float32
at every width; this is the port's departure from it.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from options_model_tpu_torch.core.config import MCConfig
from options_model_tpu_torch.core.stats import masked_mean_stderr
from options_model_tpu_torch.models.multiasset import simulate_gbm_basket
from options_model_tpu_torch.ops.engine import checked_device
from options_model_tpu_torch.ops.philox import seed_from_generator
from options_model_tpu_torch.pricers.american import (_oos_split, _pair_block,
                                                      simulated_config)
from options_model_tpu_torch.pricers.regressors import masked_wls_predict_centered

_KINDS = ("max", "min", "basket")
# The most assets whose float32 paths regress in float32 (154 columns).
FLOAT32_GRAM_ASSETS = 16


def _underlying(S_t: torch.Tensor, kind: str, w: Optional[torch.Tensor]) -> torch.Tensor:
    if kind == "max":
        return S_t.max(dim=0).values
    if kind == "min":
        return S_t.min(dim=0).values
    return torch.tensordot(w, S_t, dims=1)


def _payoff_t(S_t: torch.Tensor, K, cp, kind: str, w) -> torch.Tensor:
    """(P,) intrinsic value from the joint state S_t (n_assets, P)."""
    return torch.clamp_min(cp * (_underlying(S_t, kind, w) - K), 0.0)


def _centered(col: torch.Tensor, itm: torch.Tensor) -> torch.Tensor:
    wsum = torch.clamp_min(itm.sum(), 1.0)
    m = (col * itm).sum() / wsum
    var = ((col - m) ** 2 * itm).sum() / wsum
    return (col - m) * torch.rsqrt(torch.clamp_min(var, 1e-12))


def build_basket_basis(S_t: torch.Tensor, K, itm: torch.Tensor, kind: str, w=None,
                       cp=1.0) -> torch.Tensor:
    """(P, d) design for the continuation value, d = 1 + 2n + n(n-1)/2 + 1:
    the intercept; the masked-centred sorted moneyness u_(1) >= ... >= u_(n);
    their squares and every pairwise product; the uncentred intrinsic hinge
    (payoff / K), oriented by cp."""
    x = torch.sort(S_t / K, dim=0, descending=True).values
    us = [_centered(x[i], itm) for i in range(x.shape[0])]
    n = len(us)
    cols = [torch.ones_like(us[0]), *us, *(u * u for u in us)]
    cols += [us[i] * us[j] for i in range(n) for j in range(i + 1, n)]
    cols.append(torch.clamp_min(cp * (_underlying(S_t, kind, w) / K - 1.0), 0.0))
    return torch.stack(cols, dim=-1)


def _discount_step(r, T, n_steps: int, dtype) -> float:
    """exp(-r dt), dt = T / n_steps, in the paths' precision."""
    if dtype == torch.float64:
        return math.exp(-r * (T / n_steps))
    f = np.float32
    return float(np.exp(-f(r) * (f(T) / f(n_steps))))


def lsm_basket_backward(S_paths: torch.Tensor, K, r, T, cp, *, kind: str = "max",
                        weights=None, out_of_sample: bool = False,
                        pair_block: Optional[int] = None,
                        stat_pair_block: Optional[int] = None,
                        gram_dtype: Optional[torch.dtype] = None):
    """LSM backward induction on joint paths S_paths (n_steps+1, n_assets, P).
    Returns (price, stderr) in the paths' dtype, the stderr over antithetic
    pair means when ``stat_pair_block`` is given. ``out_of_sample`` fits on
    alternating ``pair_block`` blocks and prices on the others.
    ``gram_dtype``: the dtype the backward runs in; by default the paths'
    own, but float64 for float32 paths of more than FLOAT32_GRAM_ASSETS
    assets."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("lsm_basket_backward needs full float32 matmuls: set "
                           "torch.backends.cuda.matmul.allow_tf32 = False")
    if kind not in _KINDS:
        raise ValueError(f"kind must be one of {_KINDS}, got {kind!r}")
    if kind == "basket" and weights is None:
        raise ValueError("kind='basket' requires weights")
    out_dtype = S_paths.dtype
    if gram_dtype is None:
        gram_dtype = (torch.float64 if out_dtype == torch.float32
                      and S_paths.shape[1] > FLOAT32_GRAM_ASSETS else out_dtype)
    S_paths = S_paths.to(gram_dtype)
    n_steps = S_paths.shape[0] - 1
    dtype, device = S_paths.dtype, S_paths.device
    disc = _discount_step(r, T, n_steps, dtype)
    w = (None if weights is None
         else torch.as_tensor(np.atleast_1d(np.asarray(weights, np.float64)),
                              device=device).to(dtype))
    cash = _payoff_t(S_paths[-1], K, cp, kind, w)
    train, eval_mask = _oos_split(cash.shape[0], out_of_sample, pair_block, dtype, device)
    if train is None:
        train = eval_mask
    for t in range(n_steps - 1, 0, -1):
        cash = cash * disc
        S_t = S_paths[t]
        immediate = _payoff_t(S_t, K, cp, kind, w)
        itm = (immediate > 0).to(dtype) * train
        X = build_basket_basis(S_t, K, itm, kind, w, cp)
        continuation = masked_wls_predict_centered(X, cash, itm)
        exercise = (immediate > continuation) & (immediate > 0)
        cash = torch.where(exercise, immediate, cash)
    cash = cash * disc
    price, stderr, _ = masked_mean_stderr(cash, eval_mask, stat_pair_block)
    return price.to(out_dtype), stderr.to(out_dtype)


def price_american_basket(generator: torch.Generator, S0s, K, T, r, sigmas, corr, cp=1.0,
                          mc: Optional[MCConfig] = None, *, kind: str = "max", weights=None,
                          div_yields=None, out_of_sample: bool = False,
                          device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bermudan multi-asset option on the simulation grid: (price, stderr).

    kind: 'max' / 'min' (rainbow on the extreme asset) or 'basket'
    (weighted average, needs ``weights``). ``mc.n_steps`` is the number of
    exercise dates (GBM steps are exact at any length). The paths are
    simulated at simulated_config(mc, "gbm"): n_paths rounded to whole
    _pair_block units, the unit of the pair means and of the
    out-of-sample split, so no antithetic mirror of a training path is
    priced."""
    if kind not in _KINDS:
        raise ValueError(f"kind must be one of {_KINDS}, got {kind!r}")
    if kind == "basket" and weights is None:
        raise ValueError("kind='basket' requires weights")
    device = checked_device(device)
    mc = mc if mc is not None else MCConfig(n_paths=1 << 17, n_steps=9, path_block=4096)
    sim = simulated_config(mc, "gbm")
    pb = _pair_block(mc, "gbm")
    S = simulate_gbm_basket(seed_from_generator(generator), S0s, r, sigmas, corr, T, sim,
                            div_yields=div_yields, return_paths=True, device=device)
    return lsm_basket_backward(S, K, r, T, cp, kind=kind, weights=weights,
                               out_of_sample=out_of_sample, pair_block=pb,
                               stat_pair_block=pb if mc.antithetic else None)
