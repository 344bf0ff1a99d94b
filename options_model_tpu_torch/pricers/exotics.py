"""Asian and lookback options by Monte Carlo, as
options_model_tpu/pricers/exotics.py, on the port's path kernels
(``simulate_paths``: GBM kernel 2, Heston kernel 4, Merton, Bates, VG and
local vol). Discretely monitored on the simulation grid: the average runs
over t_i = i T / n, i = 1..n, never the spot.

The arithmetic fixed-strike Asian under GBM carries the Kemna-Vorst
variate: the geometric-average payoff on the same monitored prices,
centred at its exact closed form (``geometric_asian_bs_price``, float64)
with the pair-mean optimal beta. The paths are simulated at
simulated_config(mc, model), so pair means reduce at _pair_block's unit.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from options_model_tpu_torch.core.config import HestonParams, MCConfig, OptionSpec
from options_model_tpu_torch.core.stats import masked_mean_stderr, optimal_cv_beta
from options_model_tpu_torch.ops.engine import checked_device
from options_model_tpu_torch.pricers.american import (_discount, _pair_block, simulate_paths,
                                                      simulated_config)
from options_model_tpu_torch.pricers.blackscholes import _tensors, ndtr


def geometric_asian_bs_price(S0, K, T, r, sigma, n_dates: int, cp=1.0, div_yield=0.0,
                             device=None) -> torch.Tensor:
    """Closed form of the discretely monitored geometric-average Asian
    under GBM (dates t_i = i T / n, i = 1..n): log G is Gaussian with
    mean log S0 + (r - q - sigma^2 / 2) T (n + 1) / (2n) and variance
    sigma^2 T (n + 1)(2n + 1) / (6 n^2), so the price is Black's on the
    forward F = exp(E + Var / 2). A float64 0-d tensor on ``device`` (the
    card unless the caller asks for the CPU)."""
    S0, K, T, r, sigma, q = _tensors((S0, K, T, r, sigma, div_yield), torch.float64, device)
    n = float(n_dates)
    mu = torch.log(S0) + (r - q - 0.5 * sigma**2) * T * (n + 1.0) / (2.0 * n)
    var = sigma**2 * T * (n + 1.0) * (2.0 * n + 1.0) / (6.0 * n * n)
    sd = torch.sqrt(torch.clamp_min(var, 1e-30))
    F = torch.exp(mu + 0.5 * var)
    d1 = (mu - torch.log(K) + var) / sd
    d2 = d1 - sd
    return torch.exp(-r * T) * cp * (F * ndtr(cp * d1) - K * ndtr(cp * d2))


def _simulate(generator, S0, T, spec: OptionSpec, mc: MCConfig, model: str, device, **params):
    """The pricers' path matrix: simulated_config(mc, model)'s paths and
    the pair block of their stderr (None without antithetics)."""
    device = checked_device(device)
    S = simulate_paths(generator, S0, T, simulated_config(mc, model), model, sigma=spec.sigma,
                       rate=spec.rate, div_yield=spec.div_yield, device=device, **params)
    return S, (_pair_block(mc, model) if mc.antithetic else None)


def _mc_estimate(payoffs: torch.Tensor, rate, T, pair_block=None):
    mean, stderr, _ = masked_mean_stderr(payoffs * _discount(rate, T), pair_block=pair_block)
    return mean, stderr


def price_asian_mc(generator: torch.Generator, S0, T, spec: OptionSpec, mc: MCConfig,
                   model: str = "gbm", *, average: str = "arithmetic",
                   strike_type: str = "fixed", heston: Optional[HestonParams] = None,
                   merton=None, bates=None, vg=None, sigma_fn=None,
                   control_variate: str = "auto",
                   device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Asian option on the average of the monitored prices: (price,
    stderr). average 'arithmetic' | 'geometric'; strike_type 'fixed' (the
    average against K) | 'floating' (S_T against the average).
    control_variate 'auto' | 'on' | 'off': the Kemna-Vorst variate, exact
    only for GBM, arithmetic average, fixed strike; 'on' raises
    elsewhere, 'auto' skips."""
    if average not in ("arithmetic", "geometric"):
        raise ValueError("average must be 'arithmetic' or 'geometric'")
    if strike_type not in ("fixed", "floating"):
        raise ValueError("strike_type must be 'fixed' or 'floating'")
    if control_variate not in ("auto", "on", "off"):
        raise ValueError("control_variate must be 'auto', 'on' or 'off'")
    cv_ok = model == "gbm" and average == "arithmetic" and strike_type == "fixed"
    if control_variate == "on" and not cv_ok:
        raise ValueError("control_variate='on' requires model='gbm', average='arithmetic', "
                         "strike_type='fixed' (the geometric closed form is exact only "
                         "there)")
    S, pb = _simulate(generator, S0, T, spec, mc, model, device, heston=heston, merton=merton,
                      bates=bates, vg=vg, sigma_fn=sigma_fn)
    monitored = S[1:]
    avg = (monitored.mean(dim=0) if average == "arithmetic"
           else torch.exp(torch.log(monitored).mean(dim=0)))
    if strike_type == "fixed":
        payoffs = torch.clamp_min(spec.cp * (avg - spec.strike), 0.0)
    else:
        payoffs = torch.clamp_min(spec.cp * (S[-1] - avg), 0.0)
    if not (cv_ok and control_variate != "off"):
        return _mc_estimate(payoffs, spec.rate, T, pb)
    disc = _discount(spec.rate, T)
    geo = torch.exp(torch.log(monitored).mean(dim=0))
    geo_pay = torch.clamp_min(spec.cp * (geo - spec.strike), 0.0)
    geo_cf = geometric_asian_bs_price(S0, spec.strike, T, spec.rate, spec.sigma, mc.n_steps,
                                      spec.cp, spec.div_yield, device=S.device)
    adj = geo_cf.to(payoffs.dtype) - disc * geo_pay  # E[adj] = 0 exactly
    stat = disc * payoffs
    mean, stderr, _ = masked_mean_stderr(stat + optimal_cv_beta(stat, adj, pair_block=pb) * adj,
                                         pair_block=pb)
    return mean, stderr


def price_lookback_mc(generator: torch.Generator, S0, T, spec: OptionSpec, mc: MCConfig,
                      model: str = "gbm", *, strike_type: str = "floating",
                      heston: Optional[HestonParams] = None, merton=None, bates=None, vg=None,
                      sigma_fn=None, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lookback option on the running extreme of the monitored prices
    (the spot included): floating, the call pays S_T - min S and the put
    max S - S_T; fixed, the call pays (max S - K)^+ and the put (K -
    min S)^+."""
    if strike_type not in ("fixed", "floating"):
        raise ValueError("strike_type must be 'fixed' or 'floating'")
    S, pb = _simulate(generator, S0, T, spec, mc, model, device, heston=heston, merton=merton,
                      bates=bates, vg=vg, sigma_fn=sigma_fn)
    S_min, S_max = S.min(dim=0).values, S.max(dim=0).values
    if strike_type == "floating":
        payoffs = S[-1] - S_min if spec.cp > 0 else S_max - S[-1]
    elif spec.cp > 0:
        payoffs = torch.clamp_min(S_max - spec.strike, 0.0)
    else:
        payoffs = torch.clamp_min(spec.strike - S_min, 0.0)
    return _mc_estimate(payoffs, spec.rate, T, pb)
