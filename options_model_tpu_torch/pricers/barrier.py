"""Barrier (knock-in / knock-out) options by Monte Carlo, as
options_model_tpu/pricers/barrier.py, on the port's path kernels: discretely
monitored on the simulation grid, or for GBM with a constant sigma the
continuously monitored contract through the Brownian-bridge continuity
correction (each path weighted by its exact conditional survival
probability); ``barrier_price_rr``, Reiner and Rubinstein's closed form,
is its oracle.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from options_model_tpu_torch.core.config import HestonParams, MCConfig, OptionSpec
from options_model_tpu_torch.core.payoff import (barrier_knockin_mask, barrier_knockout_mask,
                                                 vanilla_payoff)
from options_model_tpu_torch.core.stats import masked_mean_stderr
from options_model_tpu_torch.ops.engine import checked_device
from options_model_tpu_torch.pricers.american import _discount
from options_model_tpu_torch.pricers.blackscholes import bs_price, ndtr
from options_model_tpu_torch.pricers.exotics import _simulate

BARRIER_TYPES = ("up-and-out", "down-and-out", "up-and-in", "down-and-in")


def _bridge_survival(S_paths: torch.Tensor, barrier, sigma, T, is_up: bool) -> torch.Tensor:
    """Each path's probability that a continuous GBM bridge through its
    sampled points never touches the barrier: the product over steps of
    1 - exp(-2 lx ly / (sigma^2 dt)), lx and ly the log-distances of the
    step's endpoints to the barrier (0 once an endpoint breaches)."""
    dtype = S_paths.dtype
    n_steps = S_paths.shape[0] - 1
    dt = torch.tensor(T, dtype=dtype) / n_steps
    x, y = S_paths[:-1], S_paths[1:]
    B = torch.tensor(barrier, dtype=dtype, device=S_paths.device)
    lx, ly = (torch.log(B / x), torch.log(B / y)) if is_up else (torch.log(x / B),
                                                                 torch.log(y / B))
    inside = (lx > 0) & (ly > 0)
    sig2dt = (torch.tensor(sigma, dtype=dtype) ** 2 * dt).to(S_paths.device)
    p_cross = torch.exp(-2.0 * torch.clamp_min(lx, 0.0) * torch.clamp_min(ly, 0.0) / sig2dt)
    step_surv = torch.where(inside, 1.0 - p_cross, torch.zeros_like(p_cross))
    return step_surv.prod(dim=0)


def price_barrier_mc(generator: torch.Generator, S0, T, spec: OptionSpec, barrier: float,
                     barrier_type: str, mc: MCConfig, model: str = "gbm", *,
                     heston: Optional[HestonParams] = None, merton=None, bates=None, vg=None,
                     sigma_fn=None, continuity_correction: bool = False, device=None):
    """Barrier option by Monte Carlo: (price, stderr). Discretely monitored
    at the simulation grid, or with ``continuity_correction`` (GBM with a
    constant sigma only) the continuously monitored contract by the
    bridge's survival weights."""
    if barrier_type not in BARRIER_TYPES:
        raise ValueError(f"barrier_type must be one of {BARRIER_TYPES}")
    is_up = barrier_type.startswith("up")
    is_out = barrier_type.endswith("out")
    if continuity_correction and (model != "gbm" or spec.sigma is None):
        raise ValueError("continuity_correction requires GBM with a constant sigma (the "
                         "bridge crossing law is exact only there)")
    S, pb = _simulate(generator, S0, T, spec, mc, model, device, heston=heston, merton=merton,
                      bates=bates, vg=vg, sigma_fn=sigma_fn)
    if continuity_correction:
        surv = _bridge_survival(S, barrier, spec.sigma, T, is_up)
        alive = surv if is_out else 1.0 - surv
    elif is_out:
        alive = barrier_knockout_mask(S, barrier, is_up)
    else:
        alive = barrier_knockin_mask(S, barrier, is_up)
    payoffs = vanilla_payoff(S[-1], spec.strike, spec.cp) * alive * _discount(spec.rate, T)
    price, stderr, _ = masked_mean_stderr(payoffs, pair_block=pb)
    return price, stderr


def barrier_price_rr(S0, K, T, r, sigma, barrier, barrier_type: str, cp: float = 1.0,
                     q: float = 0.0, device=None) -> torch.Tensor:
    """Reiner and Rubinstein's (1991) closed form for a continuously
    monitored barrier under GBM, zero rebate, in float64 on ``device`` (the
    card unless the caller asks for the CPU): the knock-ins from Haug's
    A/B/C/D decomposition, the knock-outs by in-out parity. The spot must
    start on the safe side of the barrier."""
    if barrier_type not in BARRIER_TYPES:
        raise ValueError(f"barrier_type must be one of {BARRIER_TYPES}")
    is_up = barrier_type.startswith("up")
    is_out = barrier_type.endswith("out")
    if (is_up and S0 >= barrier) or (not is_up and S0 <= barrier):
        raise ValueError("spot must start on the safe side of the barrier")
    dev = checked_device(device)
    f = lambda v: torch.tensor(float(v), dtype=torch.float64, device=dev)  # noqa: E731
    phi, eta = float(cp), (-1.0 if is_up else 1.0)
    S0, B, K = f(S0), f(barrier), f(K)
    vsqrt = sigma * math.sqrt(T)
    mu = (r - q - 0.5 * sigma**2) / sigma**2
    df_q, df_r = math.exp(-q * T), math.exp(-r * T)
    x1 = torch.log(S0 / K) / vsqrt + (1.0 + mu) * vsqrt
    x2 = torch.log(S0 / B) / vsqrt + (1.0 + mu) * vsqrt
    y1 = torch.log(B**2 / (S0 * K)) / vsqrt + (1.0 + mu) * vsqrt
    y2 = torch.log(B / S0) / vsqrt + (1.0 + mu) * vsqrt
    pw1 = (B / S0) ** (2.0 * (mu + 1.0))
    pw2 = (B / S0) ** (2.0 * mu)
    A = phi * S0 * df_q * ndtr(phi * x1) - phi * K * df_r * ndtr(phi * (x1 - vsqrt))
    Bv = phi * S0 * df_q * ndtr(phi * x2) - phi * K * df_r * ndtr(phi * (x2 - vsqrt))
    C = (phi * S0 * df_q * pw1 * ndtr(eta * y1)
         - phi * K * df_r * pw2 * ndtr(eta * (y1 - vsqrt)))
    D = (phi * S0 * df_q * pw1 * ndtr(eta * y2)
         - phi * K * df_r * pw2 * ndtr(eta * (y2 - vsqrt)))
    K_above_B = float(K) > barrier
    if cp > 0:
        if is_up:
            ki = A if K_above_B else Bv - C + D      # up-and-in call
        else:
            ki = C if K_above_B else A - Bv + D      # down-and-in call
    elif is_up:
        ki = A - Bv + D if K_above_B else C          # up-and-in put
    else:
        ki = Bv - C + D if K_above_B else A          # down-and-in put
    if is_out:
        vanilla = bs_price(S0, K, f(T), r, f(sigma), cp, q=q)
        return torch.clamp_min(vanilla - ki, 0.0)
    return torch.clamp_min(ki, 0.0)
