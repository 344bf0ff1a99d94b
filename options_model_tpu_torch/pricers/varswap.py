"""Variance and volatility swaps under GBM, Heston, Merton, Bates and VG,
as options_model_tpu/pricers/varswap.py.

Two closed-form fair variance strikes, both annualized:

* ``varswap_strike``: the expected quadratic variation of log S per year
  (GBM sigma^2; Heston theta + (v0 - theta)(1 - e^{-kappa T}) / (kappa T);
  Merton sigma^2 + lam (mu_j^2 + sigma_j^2); Bates the Heston term plus
  Merton's jump term; VG sigma^2 + nu theta^2);
* ``varswap_strike_replication``: the log-contract strike (2/T) E[(r-q)T
  - log(S_T/S0)] (Demeterfi, Derman, Kamal and Zou 1999), equal to the QV
  strike for continuous paths and off by 2 lam E[e^J - 1 - J - J^2/2]
  under jumps; VG's is -2 (omega + theta).

``varswap_mc`` prices the discretely monitored contract, realized variance
(1/T) sum (log S_{i+1}/S_i)^2, on the port's path kernels, and the
volatility-swap strike E[sqrt(RV)] from the same paths; both stderrs over
antithetic pair means at _pair_block's unit (the paths are simulated at
simulated_config(mc, model)).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from options_model_tpu_torch.core.config import (BatesParams, HestonParams, MCConfig,
                                                 MertonParams)
from options_model_tpu_torch.core.stats import masked_mean_stderr
from options_model_tpu_torch.ops.engine import checked_device
from options_model_tpu_torch.pricers.american import (_pair_block, simulate_paths,
                                                      simulated_config)


def heston_integrated_variance(heston: HestonParams, T: float) -> float:
    """(1/T) integral_0^T E[v_t] dt with E[v_t] = theta + (v0-theta)e^{-kt}."""
    T = float(T)
    if T <= 0:
        raise ValueError(f"T must be positive, got {T}")
    kT = heston.kappa * T
    # kappa -> 0 limit: theta + (v0-theta) * (1 - kT/2 + ...) -> v0
    if abs(kT) < 1e-8:
        return float(heston.v0)
    return float(heston.theta
                 + (heston.v0 - heston.theta) * (1.0 - math.exp(-kT)) / kT)


def _jump_qv(lam: float, mu_j: float, sigma_j: float) -> float:
    """Annualized jump contribution to quadratic variation: lam E[J^2]."""
    return lam * (mu_j**2 + sigma_j**2)


def _jump_replication(lam: float, mu_j: float, sigma_j: float) -> float:
    """Annualized jump contribution to the log-contract strike:
    2 lam E[e^J - 1 - J] with J ~ N(mu_j, sigma_j^2)."""
    kbar = math.exp(mu_j + 0.5 * sigma_j**2) - 1.0
    return 2.0 * lam * (kbar - mu_j)


def _family(model, sigma, heston, merton, bates, vg=None):
    if model == "gbm":
        if sigma is None:
            raise ValueError("model='gbm' needs sigma")
        return ("gbm", float(sigma) ** 2, 0.0, 0.0)
    if model == "heston":
        if heston is None:
            raise ValueError("model='heston' needs HestonParams")
        return ("heston", heston, 0.0, 0.0)
    if model == "merton":
        if merton is None:
            raise ValueError("model='merton' needs MertonParams")
        return ("gbm", float(merton.sigma) ** 2,
                _jump_qv(merton.lam, merton.mu_j, merton.sigma_j),
                _jump_replication(merton.lam, merton.mu_j, merton.sigma_j))
    if model == "bates":
        if bates is None:
            raise ValueError("model='bates' needs BatesParams")
        return ("heston", bates.heston,
                _jump_qv(bates.lam, bates.mu_j, bates.sigma_j),
                _jump_replication(bates.lam, bates.mu_j, bates.sigma_j))
    if model == "vg":
        if vg is None:
            raise ValueError("model='vg' needs VGParams")
        qv = float(vg.sigma) ** 2 + float(vg.nu) * float(vg.theta) ** 2
        rep = -2.0 * (vg.omega() + float(vg.theta))
        return ("gbm", qv, 0.0, rep - qv)
    raise ValueError(f"varswap closed forms support gbm/heston/merton/bates/"
                     f"vg, got {model!r}")


def varswap_strike(T: float, model: str = "gbm", *, sigma=None,
                   heston: Optional[HestonParams] = None,
                   merton: Optional[MertonParams] = None,
                   bates: Optional[BatesParams] = None, vg=None) -> float:
    """Closed-form fair variance strike: annualized expected quadratic
    variation of log S over [0, T] (variance units, e.g. 0.04 = 20% vol)."""
    kind, diff, jump_qv, _ = _family(model, sigma, heston, merton, bates,
                                     vg)
    base = heston_integrated_variance(diff, T) if kind == "heston" else diff
    if kind != "heston" and float(T) <= 0:
        raise ValueError(f"T must be positive, got {T}")
    return base + jump_qv


def varswap_strike_replication(T: float, model: str = "gbm", *, sigma=None,
                               heston: Optional[HestonParams] = None,
                               merton: Optional[MertonParams] = None,
                               bates: Optional[BatesParams] = None,
                               vg=None) -> float:
    """Log-contract replication strike (2/T) E[(r-q)T - log(S_T/S0)] — what
    the Demeterfi et al. vanilla strip locks in. Equals ``varswap_strike``
    for continuous families; differs by 2 lam E[e^J - 1 - J - J^2/2] under
    jumps (module docstring)."""
    kind, diff, jump_qv, jump_rep = _family(model, sigma, heston, merton,
                                            bates, vg)
    base = heston_integrated_variance(diff, T) if kind == "heston" else diff
    if kind != "heston" and float(T) <= 0:
        raise ValueError(f"T must be positive, got {T}")
    del jump_qv
    return base + jump_rep


def forward_varswap_strike(T1: float, T2: float, model: str = "gbm", *,
                           sigma=None, heston=None, merton=None,
                           bates=None, vg=None) -> float:
    """Fair strike of the forward-starting variance swap over [T1, T2]:
    total variance is additive, so K = (T2 K(T2) - T1 K(T1)) / (T2 - T1)."""
    if not 0.0 <= T1 < T2:
        raise ValueError(f"need 0 <= T1 < T2, got {T1}, {T2}")
    k2 = varswap_strike(T2, model, sigma=sigma, heston=heston, merton=merton,
                        bates=bates, vg=vg)
    if T1 == 0.0:
        return k2
    k1 = varswap_strike(T1, model, sigma=sigma, heston=heston, merton=merton,
                        bates=bates, vg=vg)
    return (T2 * k2 - T1 * k1) / (T2 - T1)


def varswap_mc(generator: torch.Generator, S0, T, mc: MCConfig, model: str = "gbm", *,
               sigma=None, rate=0.0, div_yield=0.0, heston: Optional[HestonParams] = None,
               merton: Optional[MertonParams] = None, bates: Optional[BatesParams] = None,
               vg=None, sigma_fn=None, localvol_table=None, heston_scheme: str = "euler",
               engine: str = "auto", device=None) -> dict:
    """Discretely monitored realized-variance statistics from one
    simulation: the variance-swap strike estimate (annualized mean
    realized variance), the volatility-swap strike (mean realized vol, so
    vol_strike <= sqrt(var_strike) by Jensen), their pair-mean stderrs and
    the number of paths."""
    device = checked_device(device)
    S = simulate_paths(generator, S0, T, simulated_config(mc, model), model, sigma=sigma,
                       rate=rate, heston=heston, merton=merton, bates=bates, vg=vg,
                       sigma_fn=sigma_fn, localvol_table=localvol_table,
                       heston_scheme=heston_scheme, engine=engine, div_yield=div_yield,
                       device=device)
    return rv_statistics(S, T, _pair_block(mc, model) if mc.antithetic else None)


def rv_statistics(S: torch.Tensor, T, pair_block=None) -> dict:
    """varswap_mc's statistics of a path matrix S (n_steps+1, paths):
    realized variance (1/T) sum (log S_{i+1}/S_i)^2 and its square root,
    each mean with its stderr over pair means at ``pair_block``."""
    logret = torch.diff(torch.log(S), dim=0)             # (n_steps, paths)
    rv = (logret * logret).sum(dim=0) / torch.tensor(T, dtype=S.dtype)
    var_strike, var_se, _ = masked_mean_stderr(rv, pair_block=pair_block)
    vol_strike, vol_se, _ = masked_mean_stderr(torch.sqrt(rv), pair_block=pair_block)
    return {"var_strike": float(var_strike), "var_stderr": float(var_se),
            "vol_strike": float(vol_strike), "vol_stderr": float(vol_se),
            "n_paths": int(rv.shape[0])}


def varswap_pv(var_strike_fair: float, var_strike_traded: float, T: float,
               rate: float, notional_var: float = 1.0) -> float:
    """PV (per unit of VARIANCE notional) of a swap struck at
    ``var_strike_traded``: e^{-rT} (E[RV] - K). Vega notional N_vega
    converts as N_var = N_vega / (2 sqrt(K))."""
    return float(notional_var * math.exp(-rate * T)
                 * (var_strike_fair - var_strike_traded))
