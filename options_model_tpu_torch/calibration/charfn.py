"""Characteristic functions and COS European pricing (Heston, Bates,
Variance Gamma), as options_model_tpu/calibration/charfn.py.

The Heston characteristic function is the "little Heston trap" form
(Albrecher et al. 2007) with (beta - d) computed without cancellation;
Bates multiplies it by the compensated lognormal-jump factor; VG is
assembled from a real log-modulus and argument. Pricing is the COS method
of Fang & Oosterlee (2008) with cumulant-based truncation, in torch
complex64 (float32) or complex128 (float64), differentiable in every
parameter by torch.autograd (``torch.real`` transposes to a complex
cotangent of the same precision, so the reference's ``creal`` has no
counterpart). The Monte-Carlo pricers use the Heston price as the
closed-form leg of the control variate; the calibrator prices through all
three.
"""

from __future__ import annotations

import math

import torch

from options_model_tpu_torch.core.config import BatesParams, HestonParams, VGParams
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
    weights[:1].fill_(0.5)   # the scalar goes to the fill kernel as its argument

    call = Kf * torch.exp(-r * Tf) * torch.sum(weights[None, :] * Fk * Uk, dim=-1)
    call = torch.clamp_min(call, 0.0)
    if isinstance(cp, (int, float)) and cp > 0:
        # a Python cp makes no device tensor: a host-to-device copy would
        # synchronise the calibrator's objective mid-chain
        return call.reshape(shape)
    # parity: P = C - S0 e^{-qT} + K e^{-rT}
    put = torch.clamp_min(call - S0 * torch.exp(-q * Tf) + Kf * torch.exp(-r * Tf), 0.0)
    if isinstance(cp, (int, float)):
        return put.reshape(shape)
    cp_f = torch.broadcast_to(as_t(cp), shape).reshape(-1)
    return torch.where(cp_f > 0, call, put).reshape(shape)


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


def vg_cos_price(S0, K, T, r, params: VGParams, cp=1.0, n_terms: int = 256,
                 L: float = 12.0, q=0.0, dtype=torch.float32, device=None) -> torch.Tensor:
    """European price(s) under Variance Gamma via COS.

    phi(u) = e^{iu(r-q+omega)T} (1 - iu theta nu + sigma^2 nu u^2 / 2)^{-T/nu}
    (Madan-Carr-Chang 1998), omega = ln(1 - theta nu - sigma^2 nu/2)/nu, the
    complex power taken from its real log-modulus and argument. The fat
    tails widen the truncation: c2 + sqrt(c4) stands in for c2 (Fang-
    Oosterlee Table 11). Device and dtype as heston_cos_price."""

    def charfn_fn(om, Tf, cd):
        rd = om.dtype
        as_t = lambda v: torch.as_tensor(v, dtype=rd, device=om.device)  # noqa: E731
        sig, th, nu = as_t(params.sigma), as_t(params.theta), as_t(params.nu)
        # log1p throughout: at small nu the factor is (1 + O(nu))^{-T/nu},
        # and a plain log of 1 + tiny loses the tiny in f32, then multiplies
        # the error by T/nu (the BS limit at nu = 1e-5 came out 6.6% off).
        w = torch.log1p(-th * nu - 0.5 * sig**2 * nu) / nu
        a_ = 0.5 * sig**2 * nu * om**2          # Re z = 1 + a_
        b_ = th * nu * om                         # Im z = -b_
        logmod = 0.5 * torch.log1p(2.0 * a_ + a_**2 + b_**2)
        arg = torch.atan2(-b_, 1.0 + a_)
        modulus = torch.exp(-(Tf / nu) * logmod)
        angle = -(Tf / nu) * arg + om * (r - q + w) * Tf
        return modulus * torch.complex(torch.cos(angle), torch.sin(angle))

    def cumulant_fn(Tf):
        as_t = lambda v: torch.as_tensor(v, dtype=Tf.dtype, device=Tf.device)  # noqa: E731
        sig, th, nu = as_t(params.sigma), as_t(params.theta), as_t(params.nu)
        w = torch.log1p(-th * nu - 0.5 * sig**2 * nu) / nu
        c1 = (r - q + w + th) * Tf
        c2 = (sig**2 + nu * th**2) * Tf
        c4 = 3.0 * (sig**4 * nu + 2.0 * th**4 * nu**3 + 4.0 * sig**2 * th**2 * nu**2) * Tf
        return c1, c2 + torch.sqrt(torch.clamp_min(c4, 0.0))

    return _cos_price_core(S0, K, T, r, q, cp, n_terms, L, dtype, charfn_fn, cumulant_fn,
                           device)


def _jump_cf_factor(u: torch.Tensor, T, lam, mu_j, sigma_j) -> torch.Tensor:
    """exp(lam T (phi_J(u) - 1) - i u lam kbar T) for lognormal jumps: the
    compensated compound-Poisson factor of the Bates characteristic function,
    for real frequencies u, in u's dtype and on its device."""
    as_t = lambda v: torch.as_tensor(v, dtype=u.dtype, device=u.device)  # noqa: E731
    lam, mu_j, sigma_j = as_t(lam), as_t(mu_j), as_t(sigma_j)
    kbar = torch.exp(mu_j + 0.5 * sigma_j**2) - 1.0
    lamT = lam * as_t(T)
    env = torch.exp(-0.5 * u**2 * sigma_j**2)        # |phi_J| envelope
    re = lamT * (env * torch.cos(u * mu_j) - 1.0)
    im = lamT * (env * torch.sin(u * mu_j) - u * kbar)
    return torch.exp(re) * torch.complex(torch.cos(im), torch.sin(im))


def bates_cos_price(S0, K, T, r, params: BatesParams, cp=1.0, n_terms: int = 256,
                    L: float = 12.0, q=0.0, dtype=torch.float32, device=None) -> torch.Tensor:
    """European price(s) under Bates (Heston + lognormal jumps) via COS.

    The characteristic function factorizes (the jumps are independent of the
    diffusion), phi_bates = phi_heston * _jump_cf_factor, and the cumulants
    add: c1 += lam T (mu_j - kbar), c2 += lam T (mu_j^2 + sigma_j^2). Device
    and dtype as heston_cos_price."""
    hp = params.heston
    lam, mu_j, sigma_j = params.lam, params.mu_j, params.sigma_j

    def charfn_fn(om, Tf, cd):
        return (heston_charfn(om, Tf, r, hp, dtype=cd, q=q)
                * _jump_cf_factor(om, Tf, lam, mu_j, sigma_j))

    def cumulant_fn(Tf):
        c1, c2 = _heston_cumulants(Tf, r, hp, q)
        as_t = lambda v: torch.as_tensor(v, dtype=Tf.dtype, device=Tf.device)  # noqa: E731
        mj, sj = as_t(mu_j), as_t(sigma_j)
        lamT = as_t(lam) * Tf
        kbar = torch.exp(mj + 0.5 * sj**2) - 1.0
        return c1 + lamT * (mj - kbar), c2 + lamT * (mj**2 + sj**2)

    return _cos_price_core(S0, K, T, r, q, cp, n_terms, L, dtype, charfn_fn, cumulant_fn,
                           device)
