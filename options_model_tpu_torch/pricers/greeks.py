"""Greeks by automatic differentiation, as options_model_tpu/pricers/greeks.py.

Monte-Carlo Greeks (``mc_greeks`` under GBM, American LSM or European;
``mc_greeks_heston``, the American put under Heston with every model
parameter's gradient) are pathwise: one torch.autograd.grad through the
simulation and the pricer. The LSM exercise rule enters through a
comparison, whose gradient holds the decisions fixed: the first-order
correct pathwise estimator (the stopping rule is optimal, so its own
sensitivity is zero to first order). The reference differentiates its XLA
simulators; here the simulation is the path kernels (on the card; their
plain versions on the CPU), and the backward is their VJP kernels
(csrc/greeks.cu, through ops/autodiff). One generator fixes a call: one
kernel seed is drawn and reused by all three passes (the price and both
Gamma bumps), common random numbers as the reference's key gives them.

``cos_greeks_heston``, ``cos_greeks_bates`` and ``cos_greeks_vg``
differentiate the COS prices, ``merton_greeks`` the Merton jump-count
series: exact European Greeks with every model parameter's gradient, Gamma
by a nested grad.

Conventions follow the reference: Theta per calendar day (/365), Vega and
Rho per 1% (/100). TF32 stays off: lsm_poly_backward raises if it is on,
and nothing here turns it on.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from options_model_tpu_torch.calibration.charfn import (bates_cos_price, heston_cos_price,
                                                        vg_cos_price)
from options_model_tpu_torch.core.config import (BatesParams, HestonParams, LSMConfig, MCConfig,
                                                  MertonParams, OptionSpec, VGParams)
from options_model_tpu_torch.core.payoff import vanilla_payoff
from options_model_tpu_torch.models.gbm import simulate_gbm
from options_model_tpu_torch.models.heston import simulate_heston
from options_model_tpu_torch.models.merton import merton_price
from options_model_tpu_torch.ops.engine import checked_device
from options_model_tpu_torch.ops.philox import seed_from_generator
from options_model_tpu_torch.pricers.american import lsm_poly_backward

# simulate(S0, r, sigma, T, return_paths) -> S paths or S_T (GBM);
# simulate(S0, r, T, heston) -> (S, v) paths (Heston). The parameters are
# 0-d tensors in the autograd graph.
GbmSimulator = Callable[..., torch.Tensor]
HestonSimulator = Callable[..., tuple]


def _value_and_grad(f, x: torch.Tensor):
    x = x.detach().requires_grad_()
    with torch.enable_grad():
        price = f(x)
        (g,) = torch.autograd.grad(price, x)
    return price.detach(), g


def _value_grad_gamma(f, x: torch.Tensor):
    """f(x), its gradient, and Gamma: the central difference of the pathwise
    Delta at S0 +- 0.005 S0 on the same draws. Pure pathwise Gamma is zero
    almost everywhere (the paths are linear in S0, each payoff piecewise
    linear); Delta is already an expectation, so its difference quotient is
    smooth and of low variance."""
    price, g = _value_and_grad(f, x)
    h = 0.005 * x[0]

    def delta_at(s):
        xs = x.clone()
        xs[0] = s
        return _value_and_grad(f, xs)[1][0]

    gamma = (delta_at(x[0] + h) - delta_at(x[0] - h)) / (2.0 * h)
    return price, g, gamma


def _gbm_american_price(x, simulate: GbmSimulator, cp, poly_degree: int, q):
    """Price as a function of x = (S0, K, T, r, sigma); drift r - q."""
    S0, K, T, r, sigma = x.unbind()
    spec = OptionSpec(strike=K, rate=r, cp=cp, sigma=sigma)
    price, _ = lsm_poly_backward(simulate(S0, r - q, sigma, T, True), spec, T,
                                 poly_degree=poly_degree)
    return price


def _gbm_european_price(x, simulate: GbmSimulator, cp, q):
    S0, K, T, r, sigma = x.unbind()
    S_T = simulate(S0, r - q, sigma, T, False)
    return vanilla_payoff(S_T, K, cp).mean() * torch.exp(-r * T)


def gbm_greeks(simulate: GbmSimulator, S0, T, spec: OptionSpec, style: str,
               poly_degree: int, device) -> Dict[str, torch.Tensor]:
    """mc_greeks on a given simulator (the kernels' stream in mc_greeks; the
    tests pass the reference's normals)."""
    x = torch.tensor([S0, spec.strike, T, spec.rate, spec.sigma], dtype=torch.float32,
                     device=device)
    q = torch.tensor(spec.div_yield, dtype=torch.float32, device=device)
    if style == "american":
        f = lambda x: _gbm_american_price(x, simulate, spec.cp, poly_degree, q)  # noqa: E731
    else:
        f = lambda x: _gbm_european_price(x, simulate, spec.cp, q)  # noqa: E731
    price, g, gamma = _value_grad_gamma(f, x)
    return {"Price": price, "Delta": g[0], "Gamma": gamma, "Vega": g[4] / 100.0,
            "Theta": -g[2] / 365.0, "Rho": g[3] / 100.0}


def mc_greeks(generator: torch.Generator, S0, T, spec: OptionSpec, mc: MCConfig,
              style: str = "american", lsm: Optional[LSMConfig] = None,
              device=None) -> Dict[str, torch.Tensor]:
    """Pathwise AD Greeks of a GBM-driven option (American LSM or European
    MC): {Price, Delta, Gamma, Vega, Theta, Rho} in the reference's
    conventions, 0-d tensors on ``device`` (the card by default). One kernel
    seed from ``generator`` prices and differentiates, so the Greeks are
    noise-consistent with the price."""
    if style not in ("american", "european"):
        raise ValueError("style must be 'american' or 'european'")
    if spec.sigma is None:
        raise ValueError("mc_greeks requires a constant sigma (GBM dynamics)")
    device = checked_device(device)
    poly_degree = (lsm or LSMConfig()).poly_degree
    seed = seed_from_generator(generator)

    def simulate(S0, r, sigma, T, paths):
        return simulate_gbm(seed, S0, r, sigma, T, mc, return_paths=paths, device=device)

    return gbm_greeks(simulate, S0, T, spec, style, poly_degree, device)


def _heston_american_price(x, simulate: HestonSimulator, cp, poly_degree: int, q):
    """Price as a function of x = (S0, K, T, r, kappa, theta, xi, rho, v0)."""
    S0, K, T, r = x[:4].unbind()
    spec = OptionSpec(strike=K, rate=r, cp=cp, sigma=None)
    S, v = simulate(S0, r - q, T, HestonParams(*x[4:].unbind()))
    price, _ = lsm_poly_backward(S, spec, T, poly_degree=poly_degree, v_paths=v)
    return price


def _heston_dict(price, g, gamma, v0) -> Dict[str, torch.Tensor]:
    return {"Price": price, "Delta": g[0], "Gamma": gamma, "Theta": -g[2] / 365.0,
            "Rho": g[3] / 100.0, "dKappa": g[4], "dTheta": g[5], "dXi": g[6],
            "dRhoCorr": g[7], "dV0": g[8],
            # vol units: dPrice/d(sqrt v0) = dV0 * 2 sqrt(v0), per 1%
            "Vega": g[8] * 2.0 * torch.sqrt(v0) / 100.0}


def heston_greeks(simulate: HestonSimulator, S0, T, spec: OptionSpec, heston: HestonParams,
                  poly_degree: int, device) -> Dict[str, torch.Tensor]:
    """mc_greeks_heston on a given simulator (the kernels' stream in
    mc_greeks_heston; the tests pass the reference's normals)."""
    x = torch.tensor([S0, spec.strike, T, spec.rate, heston.kappa, heston.theta, heston.xi,
                      heston.rho, heston.v0], dtype=torch.float32, device=device)
    q = torch.tensor(spec.div_yield, dtype=torch.float32, device=device)
    price, g, gamma = _value_grad_gamma(
        lambda x: _heston_american_price(x, simulate, spec.cp, poly_degree, q), x)
    return _heston_dict(price, g, gamma, x[8])


def mc_greeks_heston(generator: torch.Generator, S0, T, spec: OptionSpec, mc: MCConfig,
                     heston: HestonParams, lsm: Optional[LSMConfig] = None,
                     device=None) -> Dict[str, torch.Tensor]:
    """Pathwise AD sensitivities of an American option under Heston
    (full-truncation Euler, LSM on the (S, v) basis of degree
    ``lsm.poly_degree`` and variance degree 2): price, spot Greeks and the
    gradient in every model parameter (dKappa, dTheta, dXi, dRhoCorr, dV0),
    the AD replacement for bump-and-reprice parameter hedging. The variance
    clamps contribute valid subgradients."""
    device = checked_device(device)
    poly_degree = (lsm or LSMConfig()).poly_degree
    seed = seed_from_generator(generator)

    def simulate(S0, r, T, hp):
        return simulate_heston(seed, S0, r, T, hp, mc, return_paths=True,
                               return_variance=True, device=device)

    return heston_greeks(simulate, S0, T, spec, heston, poly_degree, device)


def cos_greeks_heston(S0, K, T, r, heston: HestonParams, cp=1.0, q=0.0,
                      dtype=torch.float32, device=None) -> Dict[str, torch.Tensor]:
    """Exact European Heston Greeks: torch.autograd through the COS price
    (calibration/charfn.heston_cos_price) in ``dtype``, on ``device`` (the
    card by default); no Monte Carlo, no bumping. Gamma is a nested grad."""
    device = checked_device(device)
    x = torch.tensor([S0, K, T, r, heston.kappa, heston.theta, heston.xi, heston.rho,
                      heston.v0], dtype=dtype, device=device)

    def f(x):
        return heston_cos_price(x[0], x[1], x[2], x[3], HestonParams(*x[4:].unbind()), cp,
                                q=q, dtype=dtype).sum()

    price, g, gamma = _cos_value_grad_gamma(f, x)
    return _heston_dict(price, g, gamma, x[8])


def _cos_value_grad_gamma(f, x: torch.Tensor):
    """f(x), its gradient, and Gamma as the second derivative in x[0]."""
    price, g = _value_and_grad(f, x)
    s = x[0].detach().requires_grad_()
    with torch.enable_grad():
        (delta,) = torch.autograd.grad(f(torch.cat([s[None], x[1:]])), s, create_graph=True)
        (gamma,) = torch.autograd.grad(delta, s)
    return price, g, gamma


def cos_greeks_bates(S0, K, T, r, bates: BatesParams, cp=1.0, q=0.0, dtype=torch.float32,
                     device=None) -> Dict[str, torch.Tensor]:
    """Exact European Bates Greeks: torch.autograd through the COS price
    (calibration/charfn.bates_cos_price): price, spot Greeks, the diffusion
    parameters' and the jump triple's gradients (dLam, dMuJ, dSigmaJ), where
    pathwise MC has none for lam (the Poisson count does not move with it)."""
    device = checked_device(device)
    hp = bates.heston
    x = torch.tensor([S0, K, T, r, hp.kappa, hp.theta, hp.xi, hp.rho, hp.v0, bates.lam,
                      bates.mu_j, bates.sigma_j], dtype=dtype, device=device)

    def f(x):
        bp = BatesParams(heston=HestonParams(*x[4:9].unbind()), lam=x[9], mu_j=x[10],
                         sigma_j=x[11])
        return bates_cos_price(x[0], x[1], x[2], x[3], bp, cp, q=q, dtype=dtype).sum()

    price, g, gamma = _cos_value_grad_gamma(f, x)
    out = _heston_dict(price, g, gamma, x[8])
    out.update({"dLam": g[9], "dMuJ": g[10], "dSigmaJ": g[11]})
    return out


def cos_greeks_vg(S0, K, T, r, vg: VGParams, cp=1.0, q=0.0, dtype=torch.float32,
                  device=None) -> Dict[str, torch.Tensor]:
    """Exact European Variance Gamma Greeks: torch.autograd through the COS
    price at 1024 terms, with the parameter gradient (dSigma, dThetaVG, dNu).
    Vega is dPrice/dSigma (the subordinated Brownian motion's vol) per 1%."""
    device = checked_device(device)
    x = torch.tensor([S0, K, T, r, vg.sigma, vg.theta, vg.nu], dtype=dtype, device=device)

    def f(x):
        vp = VGParams(sigma=x[4], theta=x[5], nu=x[6])
        return vg_cos_price(x[0], x[1], x[2], x[3], vp, cp, n_terms=1024, q=q,
                            dtype=dtype).sum()

    price, g, gamma = _cos_value_grad_gamma(f, x)
    return {"Price": price, "Delta": g[0], "Gamma": gamma, "Theta": -g[2] / 365.0,
            "Rho": g[3] / 100.0, "Vega": g[4] / 100.0, "dSigma": g[4], "dThetaVG": g[5],
            "dNu": g[6]}


def merton_greeks(S0, K, T, r, merton: MertonParams, cp=1.0, q=0.0, dtype=torch.float32,
                  device=None) -> Dict[str, torch.Tensor]:
    """Exact European Merton Greeks: torch.autograd through the jump-count
    series (models/merton.merton_price) in ``dtype``, on ``device`` (the card
    by default). Vega is dPrice/dSigma (the diffusion vol) per 1%; the jump
    triple gets its own gradients (dLam, dMuJ, dSigmaJ). Gamma is a nested
    grad."""
    device = checked_device(device)
    x = torch.tensor([S0, K, T, r, merton.sigma, merton.lam, merton.mu_j, merton.sigma_j],
                     dtype=dtype, device=device)

    def f(x):
        mp = MertonParams(*x[4:8].unbind())
        return merton_price(x[0], x[1], x[2], x[3], mp, cp=cp, q=q, dtype=dtype)

    price, g, gamma = _cos_value_grad_gamma(f, x)
    return {"Price": price, "Delta": g[0], "Gamma": gamma, "Theta": -g[2] / 365.0,
            "Rho": g[3] / 100.0, "Vega": g[4] / 100.0, "dLam": g[5], "dMuJ": g[6],
            "dSigmaJ": g[7]}
