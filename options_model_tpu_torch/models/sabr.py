"""SABR stochastic volatility (Hagan, Kumar, Lesniewski, Woodward 2002), as
options_model_tpu/models/sabr.py:

    dF = alpha_t F^beta dW1,   d alpha = nu alpha dW2,   corr(dW1, dW2) = rho.

- ``hagan_lognormal_iv`` and ``sabr_bs_price``: the closed-form lognormal
  implied vol (eq. 2.17a with the ATM-safe z/x(z) series) and the Black
  price at it, differentiable through torch.autograd.
- ``sabr_from_draws``: the recursion on given normals (z1, z2), the plain
  version the kernels of csrc/sabr.cu (23 paths, 24 terminal) are held
  against. alpha takes the exact lognormal step alpha exp(nu sqrt(dt) w2 -
  nu^2 dt / 2); F takes log-Euler for beta = 1 and an absorbing Euler step
  for beta < 1 (pinned at 0 once it reaches 0), with F^beta written as
  exp(beta log F), the form the kernel repeats. ``simulate_sabr`` draws
  from their stream (ops/philox.sabr_path_draws) and dispatches on the
  device.
- ``sabr_european_mc``: the European price on the forward F0 = S0 e^{(r -
  q) T} with the frozen-vol lognormal forward on the same W1 as the control
  variate (kernel 24 writes both).
- ``calibrate_sabr``: vega-shaped weighted least squares on Hagan IVs in
  float64 on the device, autograd gradients, scipy L-BFGS-B over the
  reference's four (rho, nu) starts.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from options_model_tpu_torch._unported import not_ported
from options_model_tpu_torch.core.config import MCConfig, SABRParams
from options_model_tpu_torch.models.blocks import paths_rounded
from options_model_tpu_torch.ops.autodiff import requires_grad
from options_model_tpu_torch.ops.engine import checked_device


def _as_tensors(args, dtype, device):
    """``args`` as tensors on the device of the first tensor among them (else
    checked_device(device)), in ``dtype`` if given, else that tensor's dtype
    (float32 without one)."""
    ref = next((a for a in args if isinstance(a, torch.Tensor)), None)
    dev = ref.device if ref is not None else checked_device(device)
    dt = dtype or (ref.dtype if ref is not None else torch.float32)
    return [torch.as_tensor(a, dtype=dt, device=dev) for a in args]


def hagan_lognormal_iv(F, K, T, params: SABRParams, dtype=None, device=None) -> torch.Tensor:
    """Hagan et al. (2002) eq. 2.17a lognormal implied vol, elementwise in
    (F, K, T). The ATM singularity is taken by the z/x(z) -> 1 - rho z/2 +
    (2 - 3 rho^2) z^2/12 series below |z| < 1e-4; the raw ratio uses a z
    clamped away from 0. The parameters may be 0-d tensors (the
    calibrator's gradients). dtype and device as _as_tensors."""
    F, K, T = _as_tensors((F, K, T), dtype, device)
    as_t = lambda v: torch.as_tensor(v, dtype=F.dtype, device=F.device)  # noqa: E731
    alpha, beta, rho, nu = (as_t(params.alpha), as_t(params.beta), as_t(params.rho),
                            as_t(params.nu))
    one_b = 1.0 - beta
    logFK = torch.log(F / K)
    FKb = (F * K) ** (0.5 * one_b)          # (FK)^((1-beta)/2)

    z = (nu / alpha) * FKb * logFK
    z_safe = torch.where(torch.abs(z) < 1e-12, torch.full_like(z, 1e-12), z)
    xz = torch.log((torch.sqrt(1.0 - 2.0 * rho * z_safe + z_safe**2) + z_safe - rho)
                   / (1.0 - rho))
    ratio_raw = z_safe / xz
    ratio_ser = 1.0 - 0.5 * rho * z + (2.0 - 3.0 * rho**2) * z**2 / 12.0
    ratio = torch.where(torch.abs(z) < 1e-4, ratio_ser, ratio_raw)

    denom = FKb * (1.0 + one_b**2 * logFK**2 / 24.0 + one_b**4 * logFK**4 / 1920.0)
    correction = 1.0 + (one_b**2 * alpha**2 / (24.0 * FKb**2)
                        + 0.25 * rho * beta * nu * alpha / FKb
                        + (2.0 - 3.0 * rho**2) * nu**2 / 24.0) * T
    return (alpha / denom) * ratio * correction


def sabr_bs_price(F0, K, T, r, params: SABRParams, cp=1.0, dtype=None,
                  device=None) -> torch.Tensor:
    """e^{-rT} Black(F0, K) at the Hagan vol: the family's closed form
    (O(T)-accurate, exact as nu -> 0), through bs_price on the discounted
    forward S = F0 e^{-rT} with q = 0."""
    from options_model_tpu_torch.pricers.blackscholes import bs_price

    iv = hagan_lognormal_iv(F0, K, T, params, dtype, device)
    F0, K, T, r = _as_tensors((F0, K, T, r), iv.dtype, iv.device)
    return bs_price(F0 * torch.exp(-r * T), K, T, r, iv, cp)


def sabr_constants(F0, T, params: SABRParams, n_steps: int) -> dict:
    """float32 constants rounded as the reference's simulate_sabr: dt =
    f32(T) / n_steps and sqrt(dt); alpha0, rho, rho_bar = sqrt(1 - rho^2);
    the vol step's nu sqrt(dt) and nu^2 dt / 2; the state's start, log F0
    (beta = 1) or F0; the frozen-vol control variate's log-Euler step,
    alpha0^2 dt / 2 and alpha0 sqrt(dt); and beta (a float)."""
    f = np.float32
    dt = f(T) / f(n_steps)
    sqrt_dt = np.sqrt(dt)
    a0, rho, nu = f(params.alpha), f(params.rho), f(params.nu)
    beta = float(params.beta)
    F0 = f(F0)
    return dict(dt=dt, sqrt_dt=sqrt_dt, alpha0=a0, rho=rho,
                rho_bar=np.sqrt(f(1.0) - rho * rho), nu_sqrt_dt=nu * sqrt_dt,
                half_nu2_dt=f(0.5) * (nu * nu) * dt,
                s0=np.log(F0) if beta == 1.0 else F0, log_f0=np.log(F0),
                cv_drift=f(0.5) * (a0 * a0) * dt, cv_diffusion=a0 * sqrt_dt, beta=beta)


def sabr_step(s: torch.Tensor, a: torch.Tensor, w1: torch.Tensor, c: dict) -> torch.Tensor:
    """One forward step of the state s (log F for beta = 1, else F) at vol a
    on the W1 normal w1: log-Euler, or the absorbing Euler step with F^beta =
    exp(beta log F); the kernel repeats each operation in this order."""
    if c["beta"] == 1.0:
        return s - 0.5 * (a * a) * c["dt"] + (a * c["sqrt_dt"]) * w1
    f_plus = torch.clamp_min(s, 0.0)
    f_beta = torch.exp(c["beta"] * torch.log(f_plus))
    f_new = f_plus + ((a * f_beta) * c["sqrt_dt"]) * w1
    return torch.where(s <= 0.0, torch.zeros_like(s), torch.clamp_min(f_new, 0.0))


def sabr_from_draws(z1: torch.Tensor, z2: torch.Tensor, F0, T, params: SABRParams,
                    return_paths: bool = False, return_alpha: bool = False,
                    return_cv: bool = False):
    """The SABR recursion on normals z1, z2, each (n_steps, n_paths), in
    z1's dtype: w1 = z1, w2 = rho z1 + rho_bar z2. Returns F (n_steps+1,
    n_paths) with ``return_paths``, else F_T (n_paths,); with
    ``return_alpha`` also alpha's matrix or terminal values; with
    ``return_cv`` (terminal only) also G_T, the nu = 0 lognormal forward
    exp(log F0 - alpha0^2 T/2 + alpha0 W1_T) on the same W1."""
    c = {k: float(v) for k, v in sabr_constants(F0, T, params, z1.shape[0]).items()}
    if return_cv and return_paths:
        raise ValueError("the control variate's forward is a terminal output")
    n = z1.shape[1]
    full = lambda v: torch.full((n,), v, dtype=z1.dtype, device=z1.device)  # noqa: E731
    s, a, g = full(c["s0"]), full(c["alpha0"]), full(c["log_f0"])
    to_F = (lambda x: torch.exp(x)) if c["beta"] == 1.0 else (lambda x: x)
    F_rows, a_rows = [to_F(s)], [a]
    for t in range(z1.shape[0]):
        w2 = c["rho"] * z1[t] + c["rho_bar"] * z2[t]
        s = sabr_step(s, a, z1[t], c)
        a = a * torch.exp(c["nu_sqrt_dt"] * w2 - c["half_nu2_dt"])
        if return_cv:
            g = (g - c["cv_drift"]) + c["cv_diffusion"] * z1[t]
        if return_paths:
            F_rows.append(to_F(s))
            a_rows.append(a)
    if return_paths:
        out = (torch.stack(F_rows),) + ((torch.stack(a_rows),) if return_alpha else ())
    else:
        out = (to_F(s),) + ((a,) if return_alpha else ()) + ((torch.exp(g),) if return_cv else ())
    return out if len(out) > 1 else out[0]


def _check_grad(fn: str, *args) -> None:
    if requires_grad(*args):
        raise not_ported(f"gradients of the SABR paths ({fn} through csrc/sabr.cu)",
                         f"models.sabr.{fn}")


def simulate_sabr(seed: int, F0, T, params: SABRParams, cfg: MCConfig,
                  return_paths: bool = False, return_alpha: bool = False,
                  first_tile: int = 0, device: Optional[torch.device] = None):
    """SABR forward paths (a martingale: no drift on F) from the kernels'
    stream: kernel 23 (paths, PATH_TILE tiles) or 24 (F_T, TERMINAL_TILE
    tiles) of csrc/sabr.cu on a CUDA device, their plain versions on the CPU.
    Returns F_T (n_pad,) by default, the (n_steps+1, n_pad) matrix with
    ``return_paths``, and with ``return_alpha`` alpha's matrix or terminal
    values as well."""
    from options_model_tpu_torch.ops import cuda_sabr

    _check_grad("simulate_sabr", F0, T, params.alpha, params.beta, params.rho, params.nu)
    if return_paths:
        return cuda_sabr.sabr_paths(seed, F0, T, params, paths_rounded(cfg), cfg.n_steps,
                                    cfg.antithetic, first_tile, device, return_alpha)
    return cuda_sabr.sabr_terminal(seed, F0, T, params, paths_rounded(cfg), cfg.n_steps,
                                   cfg.antithetic, first_tile, device, return_alpha)


def sabr_european_estimate(F_T: torch.Tensor, G_T: Optional[torch.Tensor], F0, K, r, T,
                           alpha0, cp=1.0, pair_block: Optional[int] = None):
    """(price, stderr) of the European on terminal forwards F_T, discounted
    at r: the plain mean, or with G_T (the nu = 0 lognormal forward on the
    same W1) the control variate at the pair-mean optimal beta, its mean
    e^{-rT} Black(F0, K, alpha0) exact (the leg's log-Euler is exact at
    constant vol). The stderr over antithetic pair means of ``pair_block``."""
    from options_model_tpu_torch.core.payoff import vanilla_payoff
    from options_model_tpu_torch.core.stats import masked_mean_stderr, optimal_cv_beta
    from options_model_tpu_torch.pricers.blackscholes import bs_price

    f = np.float32
    disc = float(np.exp(-f(r) * f(T)))
    pay = disc * vanilla_payoff(F_T, K, cp)
    if G_T is None:
        mean, se, _ = masked_mean_stderr(pay, pair_block=pair_block)
        return mean, se
    cv_mean = bs_price(float(f(F0) * f(disc)), K, T, r, float(f(alpha0)), cp, dtype=F_T.dtype,
                       device=F_T.device)
    adj = disc * vanilla_payoff(G_T, K, cp) - cv_mean
    b = optimal_cv_beta(pay, adj, pair_block=pair_block)
    mean, se, _ = masked_mean_stderr(pay + b * adj, pair_block=pair_block)
    return mean, se


def sabr_european_mc(generator: torch.Generator, S0, K, r, T, params: SABRParams,
                     cfg: MCConfig, cp=1.0, q=0.0, control_variate: bool = True,
                     device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """European price under SABR: simulate the forward F0 = S0 e^{(r-q)T}
    (kernel 24, on the card by default) and discount the terminal payoff at
    r; with ``control_variate`` the kernel also writes the nu = 0 forward on
    the same W1 (sabr_european_estimate). Returns (price, stderr), the
    stderr over antithetic pair means of the kernel's TERMINAL_TILE tiles."""
    from options_model_tpu_torch.ops import cuda_sabr
    from options_model_tpu_torch.ops.cuda_heston import TERMINAL_TILE
    from options_model_tpu_torch.ops.philox import seed_from_generator

    _check_grad("sabr_european_mc", S0, K, r, T, q, params.alpha, params.rho, params.nu)
    device = checked_device(device)
    f = np.float32
    F0 = float(f(S0) * np.exp((f(r) - f(q)) * f(T)))
    out = cuda_sabr.sabr_terminal(seed_from_generator(generator), F0, T, params,
                                  paths_rounded(cfg), cfg.n_steps, cfg.antithetic, 0, device,
                                  return_cv=control_variate)
    F_T, G_T = out if control_variate else (out, None)
    return sabr_european_estimate(F_T, G_T, F0, K, r, T, params.alpha, cp,
                                  TERMINAL_TILE if cfg.antithetic else None)


def calibrate_sabr(F0, T, strikes, market_ivs, beta: Optional[float] = None, weights=None,
                   n_starts: int = 4, device=None):
    """Fit SABR to one expiry's smile by weighted least squares on Hagan IVs
    in float64 on ``device`` (the card by default), gradients by autograd,
    scipy L-BFGS-B from the reference's (rho, nu) starts. beta is chosen,
    not fitted (1.0 by default); weights default to ATM-peaked Gaussians in
    log-moneyness. Returns (SABRParams, {"rmse", "iters", "success"})."""
    from scipy.optimize import minimize

    device = checked_device(device)
    K = np.asarray(strikes, np.float64)
    iv = np.asarray(market_ivs, np.float64)
    b = 1.0 if beta is None else float(beta)
    if weights is None:
        k = np.log(K / float(F0))
        weights = np.exp(-0.5 * (k / 0.25) ** 2)
    w = np.asarray(weights, np.float64)
    w = w / w.sum()
    as_t = lambda v: torch.as_tensor(v, dtype=torch.float64, device=device)  # noqa: E731
    w_t, K_t, iv_t = as_t(w), as_t(K), as_t(iv)

    # alpha seeded from the ATM vol: iv_ATM ~ alpha / F^{1-beta}
    i_atm = int(np.argmin(np.abs(K - float(F0))))
    alpha_seed = float(iv[i_atm]) * float(F0) ** (1.0 - b)

    def f_np(x):
        xt = as_t(np.asarray(x, np.float64)).requires_grad_(True)
        # soft bounds via transforms: alpha > 0, rho in (-1, 1), nu >= 0
        p = SABRParams(alpha=torch.exp(xt[0]), beta=b, rho=torch.tanh(xt[1]),
                       nu=torch.exp(xt[2]))
        model_iv = hagan_lognormal_iv(F0, K_t, T, p, dtype=torch.float64)
        v = torch.sqrt(torch.sum(w_t * (model_iv - iv_t) ** 2))
        v.backward()
        return float(v.detach()), xt.grad.cpu().numpy()

    starts = [(alpha_seed, -0.3, 0.5), (alpha_seed, 0.3, 0.5),
              (alpha_seed, -0.6, 1.5), (alpha_seed, 0.0, 0.1)][:n_starts]
    best = None
    for a0, r0, n0 in starts:
        x0 = np.array([np.log(max(a0, 1e-4)), np.arctanh(r0), np.log(max(n0, 1e-4))])
        res = minimize(f_np, x0, jac=True, method="L-BFGS-B",
                       options={"maxiter": 200, "ftol": 1e-14, "gtol": 1e-12})
        if best is None or res.fun < best.fun:
            best = res
    params = SABRParams(alpha=float(np.exp(best.x[0])), beta=b, rho=float(np.tanh(best.x[1])),
                        nu=float(np.exp(best.x[2]))).validate()
    return params, {"rmse": float(best.fun), "iters": int(best.nit),
                    "success": bool(best.success)}
