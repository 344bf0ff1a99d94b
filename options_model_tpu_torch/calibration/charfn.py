"""Heston characteristic function and COS European pricing, as
options_model_tpu/calibration/charfn.py (the Heston part).

The characteristic function is the "little Heston trap" form (Albrecher et
al. 2007) with (beta - d) computed without cancellation; pricing is the COS
method of Fang & Oosterlee (2008) with cumulant-based truncation, in torch
complex64 (float32) or complex128 (float64). The Monte-Carlo pricers use it
as the closed-form leg of the Heston control variate.
"""

from __future__ import annotations

import math

import torch

from options_model_tpu_torch.core.config import HestonParams
from options_model_tpu_torch.ops.engine import checked_device

_COMPLEX = {torch.float32: torch.complex64, torch.float64: torch.complex128}


def heston_charfn(u: torch.Tensor, T, r, params: HestonParams,
                  dtype=torch.complex64, q=0.0) -> torch.Tensor:
    """phi(u) = E[exp(i u ln(S_T/S0))] under Heston risk-neutral dynamics.

    u: real or complex frequencies; T broadcasts against u. ``q``: continuous
    dividend yield (log-price drift r - q)."""
    u = u.to(dtype)
    kappa, theta, xi, rho, v0 = (params.kappa, params.theta, params.xi,
                                 params.rho, params.v0)
    iu = 1j * u
    beta = kappa - rho * xi * iu
    d = torch.sqrt(beta**2 + xi**2 * (iu + u**2))
    # (beta - d) from the exact identity (beta-d)(beta+d) = -xi^2 (iu + u^2):
    # the plain difference cancels catastrophically in complex64 for small xi.
    ratio = -(iu + u**2) / (beta + d)        # == (beta - d) / xi^2
    g2 = ratio * xi**2 / (beta + d)          # little-trap branch
    exp_dT = torch.exp(-d * T)
    log_term = torch.log((1.0 - g2 * exp_dT) / (1.0 - g2))
    A = kappa * theta * (ratio * T) - (2.0 * kappa * theta / xi**2) * log_term
    B = ratio * ((1.0 - exp_dT) / (1.0 - g2 * exp_dT))
    return torch.exp(iu * (r - q) * T + A + B * v0)


def _heston_cumulants(T: torch.Tensor, r, params: HestonParams, q=0.0):
    """First two cumulants of ln(S_T/S0) (Fang & Oosterlee 2008, Table 11)."""
    kappa, theta, xi, rho, v0 = (params.kappa, params.theta, params.xi,
                                 params.rho, params.v0)
    ekt = torch.exp(-kappa * T)
    c1 = (r - q) * T + (1.0 - ekt) * (theta - v0) / (2.0 * kappa) - 0.5 * theta * T
    c2 = (1.0 / (8.0 * kappa**3)) * (
        xi * T * kappa * ekt * (v0 - theta) * (8.0 * kappa * rho - 4.0 * xi)
        + kappa * rho * xi * (1.0 - ekt) * (16.0 * theta - 8.0 * v0)
        + 2.0 * theta * kappa * T * (-4.0 * kappa * rho * xi + xi**2 + 4.0 * kappa**2)
        + xi**2 * ((theta - 2.0 * v0) * torch.exp(-2.0 * kappa * T)
                   + theta * (6.0 * ekt - 7.0) + 2.0 * v0)
        + 8.0 * kappa**2 * (v0 - theta) * (1.0 - ekt)
    )
    return c1, torch.clamp_min(c2, 1e-12)


def _cos_coeffs_call(k: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """COS payoff coefficients U_k of a call on x = ln(S_T/K), payoff
    K(e^x - 1)^+ over [0, b] (Fang-Oosterlee eq. 22-23)."""
    c, d = 0.0, b
    omega = k * math.pi / (b - a)
    # chi_k(c, d) = int_c^d e^x cos(omega (x - a)) dx
    chi = (1.0 / (1.0 + omega**2)) * (
        torch.cos(omega * (d - a)) * torch.exp(d)
        - torch.cos(omega * (c - a)) * math.exp(c)
        + omega * torch.sin(omega * (d - a)) * torch.exp(d)
        - omega * torch.sin(omega * (c - a)) * math.exp(c)
    )
    # psi_k(c, d) = int_c^d cos(omega (x - a)) dx
    psi_k = torch.where(k == 0, d - c,
                        (torch.sin(omega * (d - a)) - torch.sin(omega * (c - a)))
                        / torch.where(k == 0, torch.ones_like(omega), omega))
    return (2.0 / (b - a)) * (chi - psi_k)


def _cos_price_core(S0, K, T, r, q, cp, n_terms: int, L: float, dtype,
                    charfn_fn, cumulant_fn, device=None) -> torch.Tensor:
    """Shared COS machinery: truncation range from the first two cumulants,
    call coefficients, put-call parity. ``charfn_fn`` maps (omega (M, N),
    Tf (M, 1), complex dtype) -> phi; ``cumulant_fn`` maps Tf (M,) -> (c1, c2).
    A tensor among S0, K and T sets the device, else checked_device(device)."""
    ref = next((a for a in (S0, K, T) if isinstance(a, torch.Tensor)), None)
    device = ref.device if ref is not None else checked_device(device)
    as_t = lambda x: torch.as_tensor(x, dtype=dtype, device=device)  # noqa: E731
    K, T = torch.broadcast_tensors(as_t(K), as_t(T))
    shape = K.shape
    Kf, Tf = K.reshape(-1), T.reshape(-1)
    S0 = as_t(S0)

    x0 = torch.log(S0 / Kf)                                  # (M,)
    c1, c2 = cumulant_fn(Tf)                                 # (M,)
    a = x0 + c1 - L * torch.sqrt(c2)
    b = x0 + c1 + L * torch.sqrt(c2)

    k = torch.arange(n_terms, dtype=dtype, device=device)    # (N,)
    omega = k[None, :] * math.pi / (b - a)[:, None]          # (M, N)

    phi = charfn_fn(omega, Tf[:, None], _COMPLEX[dtype])
    # F_k = Re[phi(omega_k) exp(i omega_k (x0 - a))]
    ang = omega * (x0 - a)[:, None]
    Fk = torch.real(phi * torch.complex(torch.cos(ang), torch.sin(ang)))
    Uk = _cos_coeffs_call(k[None, :], a[:, None], b[:, None])
    weights = torch.ones(n_terms, dtype=dtype, device=device)
    weights[0] = 0.5

    call = Kf * torch.exp(-r * Tf) * torch.sum(weights[None, :] * Fk * Uk, dim=-1)
    call = torch.clamp_min(call, 0.0)
    cp_f = torch.broadcast_to(as_t(cp), shape).reshape(-1)
    # parity: P = C - S0 e^{-qT} + K e^{-rT}
    put = call - S0 * torch.exp(-q * Tf) + Kf * torch.exp(-r * Tf)
    price = torch.where(cp_f > 0, call, torch.clamp_min(put, 0.0))
    return price.reshape(shape)


def heston_cos_price(S0, K, T, r, params: HestonParams, cp=1.0,
                     n_terms: int = 256, L: float = 12.0, q=0.0,
                     dtype=torch.float32, device=None) -> torch.Tensor:
    """European option price(s) under Heston via the COS method.

    K, T and cp broadcast elementwise; puts come from calls by put-call
    parity. ``dtype``: float32 (the default) carries an ~2e-3 absolute price
    noise floor (each of the n_terms terms is f32-rounded, coherently across
    k); float64 drops it below 1e-7. A tensor among S0, K and T sets the
    device, else ``device``: the card by default, never quietly the CPU."""
    return _cos_price_core(
        S0, K, T, r, q, cp, n_terms, L, dtype,
        lambda om, Tf, cd: heston_charfn(om, Tf, r, params, dtype=cd, q=q),
        lambda Tf: _heston_cumulants(Tf, r, params, q), device)
