"""Black-Scholes closed forms, Greeks and implied vol, as
options_model_tpu/pricers/blackscholes.py.

Conventions follow the reference: Theta per calendar day (/365), Vega and
Rho per 1% move (/100). ``bs_greeks`` takes them through torch.autograd
(Gamma by double backward) and ``bs_greeks_closed_form`` from the textbook
formulas; the two agree to f32 rounding. ``implied_vol`` is bisection plus
a Newton polish, differentiated implicitly (``_ImpliedVol``).

Every function broadcasts its arguments elementwise. A tensor argument sets
the device (and, for the price, the dtype); with none, the computation runs
on ``device``, by default the card (ops.engine.checked_device), never
quietly on the CPU.
"""

from __future__ import annotations

from typing import Dict

import torch

from options_model_tpu_torch.ops.engine import checked_device

_INV_SQRT_2PI = 0.3989422804014327


def ndtr(x: torch.Tensor) -> torch.Tensor:
    """Standard normal CDF as 0.5 * erfc(-x / sqrt(2)): the tail-stable form
    (0.5 * (1 + erf) cancels in the left tail and prices deep-OTM options
    negative)."""
    return 0.5 * torch.special.erfc(-x * 0.7071067811865476)


def _npdf(x: torch.Tensor) -> torch.Tensor:
    return torch.exp(-0.5 * x**2) * _INV_SQRT_2PI


def _tensors(args, dtype, device):
    """``args`` as tensors on the device of the first tensor among them (else
    checked_device(device)), in that tensor's dtype (else ``dtype``)."""
    ref = next((a for a in args if isinstance(a, torch.Tensor)), None)
    if ref is None:
        ref = torch.empty((), dtype=dtype, device=checked_device(device))
    return [torch.as_tensor(a, dtype=ref.dtype, device=ref.device) for a in args]


def _d1_d2(S, K, T, r, sigma, q):
    sqrt_T = torch.sqrt(T)
    d1 = (torch.log(S / K) + (r - q + 0.5 * sigma**2) * T) / (sigma * sqrt_T)
    return d1, d1 - sigma * sqrt_T


def bs_price(S, K, T, r, sigma, cp=1.0, q=0.0, dtype=torch.float32,
             device=None) -> torch.Tensor:
    """European Black-Scholes(-Merton) price; cp=+1 call, -1 put; ``q`` the
    continuous dividend yield. Broadcasts; a tensor among S, K, T and sigma
    sets the device and dtype, otherwise ``dtype`` on ``device`` (the card
    by default)."""
    S, K, T, sigma = _tensors((S, K, T, sigma), dtype, device)
    d1, d2 = _d1_d2(S, K, T, r, sigma, q)
    # cp-symmetric form: call = S e^{-qT} N(d1) - K e^{-rT} N(d2)
    return cp * (S * torch.exp(-q * T) * ndtr(cp * d1)
                 - K * torch.exp(-r * T) * ndtr(cp * d2))


def bs_delta(S, K, T, r, sigma, cp=1.0, q=0.0, dtype=torch.float32,
             device=None) -> torch.Tensor:
    S, K, T, r, sigma, q = _tensors((S, K, T, r, sigma, q), dtype, device)
    d1, _ = _d1_d2(S, K, T, r, sigma, q)
    return cp * torch.exp(-q * T) * ndtr(cp * d1)


def bs_vega(S, K, T, r, sigma, q=0.0, dtype=torch.float32, device=None) -> torch.Tensor:
    """Raw vega (per unit vol, not per 1%): the weighting kernel of the
    IV-surface loss and the calibrator."""
    S, K, T, r, sigma, q = _tensors((S, K, T, r, sigma, q), dtype, device)
    d1, _ = _d1_d2(S, K, T, r, sigma, q)
    return S * torch.exp(-q * T) * _npdf(d1) * torch.sqrt(T)


def bs_greeks(S, K, T, r, sigma, cp=1.0, q=0.0, dtype=torch.float32,
              device=None) -> Dict[str, torch.Tensor]:
    """Greeks through torch.autograd, in the reference's conventions (Theta
    per day, Vega and Rho per 1%). The arguments are broadcast to one shape
    first, so every element gets its own derivatives; Gamma is the second
    backward of Delta."""
    args = torch.broadcast_tensors(*_tensors((S, K, T, r, sigma), dtype, device))
    S, K, T, r, sigma = (a.detach().clone().requires_grad_() for a in args)
    with torch.enable_grad():
        price = bs_price(S, K, T, r, sigma, cp, q)
        delta, dT, dr, dsig = torch.autograd.grad(price.sum(), (S, T, r, sigma),
                                                  create_graph=True)
        (gamma,) = torch.autograd.grad(delta.sum(), S)
    return {"Delta": delta.detach(), "Gamma": gamma, "Vega": dsig.detach() / 100.0,
            "Theta": -dT.detach() / 365.0,   # value decay as calendar time passes
            "Rho": dr.detach() / 100.0}


def bs_greeks_closed_form(S, K, T, r, sigma, cp=1.0, q=0.0, dtype=torch.float32,
                          device=None) -> Dict[str, torch.Tensor]:
    """Textbook closed-form Black-Scholes-Merton Greeks in the reference's
    conventions; the cross-check of bs_greeks."""
    S, K, T, r, sigma, q = _tensors((S, K, T, r, sigma, q), dtype, device)
    d1, d2 = _d1_d2(S, K, T, r, sigma, q)
    sqrt_T = torch.sqrt(T)
    eq = torch.exp(-q * T)
    delta = cp * eq * ndtr(cp * d1)
    gamma = eq * _npdf(d1) / (S * sigma * sqrt_T)
    vega = S * eq * _npdf(d1) * sqrt_T
    theta = (-S * eq * _npdf(d1) * sigma / (2.0 * sqrt_T)
             - cp * r * K * torch.exp(-r * T) * ndtr(cp * d2)
             + cp * q * S * eq * ndtr(cp * d1))
    rho = cp * K * T * torch.exp(-r * T) * ndtr(cp * d2)
    return {"Delta": delta, "Gamma": gamma, "Vega": vega / 100.0,
            "Theta": theta / 365.0, "Rho": rho / 100.0}


def _solve_implied_vol(price, S, K, T, r, cp, q, n_iter: int, lo: float, hi: float):
    """``n_iter`` bisections on [lo, hi], then 8 Newton steps clipped to
    +-0.5 and to [lo, hi]: a fixed iteration count, no data-dependent control
    flow, as the reference."""
    lo_b = torch.full_like(price, lo)
    hi_b = torch.full_like(price, hi)
    for _ in range(n_iter):
        mid = 0.5 * (lo_b + hi_b)
        too_high = bs_price(S, K, T, r, mid, cp, q) > price
        lo_b, hi_b = torch.where(too_high, lo_b, mid), torch.where(too_high, mid, hi_b)
    sig = 0.5 * (lo_b + hi_b)
    for _ in range(8):
        diff = bs_price(S, K, T, r, sig, cp, q) - price
        v = torch.clamp_min(bs_vega(S, K, T, r, sig, q), 1e-10)
        sig = torch.clamp(sig - torch.clamp(diff / v, -0.5, 0.5), lo, hi)
    return sig


class _ImpliedVol(torch.autograd.Function):
    """sigma(price, S, K, T, r, q) on inputs of one shape. The backward is
    the implicit-function rule on bs_price(S, K, T, r, sigma; cp, q) = price:
    dsigma = (dprice - dP|sigma) / vega, and 0 where sigma sits on the
    [lo, hi] clamp (the true derivative there is 0; the raw formula would
    divide a finite price tangent by a vega near 0). It never differentiates
    through the iterations: that carries the solver's truncation into the
    gradient (1-3% off finite differences on a noisy chain in the
    reference's measurement, enough to stall L-BFGS-B line searches)."""

    @staticmethod
    def forward(ctx, price, S, K, T, r, q, cp, n_iter, lo, hi):
        sigma = _solve_implied_vol(price, S, K, T, r, cp, q, n_iter, lo, hi)
        ctx.save_for_backward(S, K, T, r, q, sigma)
        ctx.cp, ctx.lo, ctx.hi = cp, lo, hi
        return sigma

    @staticmethod
    def backward(ctx, grad):
        S, K, T, r, q, sigma = ctx.saved_tensors
        with torch.enable_grad():
            xs = [a.detach().requires_grad_() for a in (S, K, T, r, q)]
            P = bs_price(xs[0], xs[1], xs[2], xs[3], sigma, ctx.cp, xs[4])
            dP = torch.autograd.grad(P.sum(), xs)
        vega = torch.clamp_min(bs_vega(S, K, T, r, sigma, q), 1e-10)
        interior = (sigma > ctx.lo) & (sigma < ctx.hi)
        scale = torch.where(interior, grad / vega, torch.zeros_like(grad))
        return (scale, *(-scale * d for d in dP), None, None, None, None)


def implied_vol(price, S, K, T, r, cp=1.0, q=0.0, n_iter: int = 64,
                lo: float = 1e-4, hi: float = 5.0, dtype=torch.float32,
                device=None) -> torch.Tensor:
    """Implied volatility by bisection plus Newton polish, broadcast over its
    arguments, differentiable in price, S, K, T, r and q through the
    implicit-function rule (_ImpliedVol)."""
    args = _tensors((price, S, K, T, r, q), dtype, device)
    return _ImpliedVol.apply(*torch.broadcast_tensors(*args), cp, n_iter, lo, hi)
