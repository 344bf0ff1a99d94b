"""Heston stochastic-volatility paths, full-truncation Euler
(options_model_tpu/models/heston.py):

    v+ = max(v, 0)
    v  <- max(v+ + kappa (theta - v+) dt + xi sqrt(v+ dt) W2, 0)
    log S <- log S + (r - v+/2) dt + sqrt(v+ dt) W1
    W1 = z1,  W2 = rho z1 + sqrt(1 - rho^2) z2.

``heston_euler_from_normals`` is that recursion on given normals — the plain
version the CUDA kernels (csrc/heston.cu, csrc/heston_paths.cu) are held
against, and the function the tests feed with the reference simulator's own
normals. ``simulate_heston`` draws from the kernels' Philox stream and
dispatches on the device; ``simulate_heston_maturities`` simulates several
maturities in one paths launch.

``scheme="qe"`` is Andersen's (2008) quadratic-exponential scheme with the
martingale correction (QE-M, models/heston._simulate_heston_qe in the
reference). ``heston_qe_from_normals`` is its recursion on given draws
(z_v, z_s, u), with the formulas and operation order of the TPU kernel's
_qe_body (pallas_heston.py:369-436); csrc/heston_qe.cu is held against it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from options_model_tpu_torch._unported import not_ported
from options_model_tpu_torch.core.config import HestonParams, MCConfig
from options_model_tpu_torch.models.blocks import paths_rounded


def effective_bs_sigma(v, tau, heston: HestonParams) -> torch.Tensor:
    """Effective Black-Scholes vol matching the expected integrated Heston
    variance over the remaining time tau from variance state v:
    E[bar v] = theta + (v - theta)(1 - e^{-kappa tau}) / (kappa tau). The
    NN-LSM's residual baseline under Heston (pricers/american._nn_continuation)."""
    v = torch.as_tensor(v)
    tau = torch.as_tensor(tau, dtype=v.dtype, device=v.device)
    kt = torch.clamp_min(heston.kappa * tau, 1e-6)
    frac = -torch.expm1(-kt) / kt
    return torch.sqrt(torch.clamp_min(heston.theta + (v - heston.theta) * frac, 1e-8))


def heston_constants(S0, r, T, params: HestonParams, n_steps: int) -> dict:
    """The recursion's float32 constants, rounded as the TPU kernel's
    _params_array rounds them (pallas_heston.py:249): dt = f32(T) / n_steps,
    rho_bar = sqrt(1 - rho^2) in f32. Shared by the kernel and its plain
    version so both start from identical bits."""
    f = np.float32
    dt = f(T) / f(n_steps)
    rho = f(params.rho)
    return dict(log_s0=np.log(f(S0)), r=f(r), dt=dt, sqrt_dt=np.sqrt(dt),
                kappa=f(params.kappa), theta=f(params.theta), xi=f(params.xi),
                rho=rho, rho_bar=np.sqrt(f(1.0) - rho * rho), v0=f(params.v0))


def heston_euler_from_normals(z1: torch.Tensor, z2: torch.Tensor, S0, r, T,
                              params: HestonParams,
                              return_variance: bool = False,
                              return_paths: bool = True,
                              log_relative: bool = False):
    """Full-truncation Euler on normals z1, z2 of shape (n_steps, n_paths).

    Carries log S relative to log S0 and writes S = exp(log S0 + rel), the
    TPU kernel's formula (row 0 included). Returns S (n_steps+1, n_paths)
    [and v likewise], or with ``return_paths=False`` S_T (n_paths,) [and v_T].
    ``log_relative`` returns the carried log(S / S0) (row 0 = 0) in place of
    S: the log-only form of the kernel-4 experiments (ops/cuda_heston_variants).
    """
    c = {k: float(v) for k, v in heston_constants(S0, r, T, params, z1.shape[0]).items()}
    n_paths = z1.shape[1]
    log_s = torch.zeros(n_paths, dtype=torch.float32, device=z1.device)
    v = torch.full((n_paths,), c["v0"], dtype=torch.float32, device=z1.device)

    def emit(x):
        return x if log_relative else torch.exp(c["log_s0"] + x)

    s_rows, v_rows = [emit(log_s)], [v]
    for z1_t, z2_t in zip(z1, z2):
        w2 = c["rho"] * z1_t + c["rho_bar"] * z2_t
        v_plus = torch.clamp_min(v, 0.0)
        sq = torch.sqrt(v_plus) * c["sqrt_dt"]
        v = torch.clamp_min(v_plus + c["kappa"] * (c["theta"] - v_plus) * c["dt"]
                            + c["xi"] * sq * w2, 0.0)
        log_s = log_s + (c["r"] - 0.5 * v_plus) * c["dt"] + sq * z1_t
        if return_paths:
            s_rows.append(emit(log_s))
            v_rows.append(v)
    if not return_paths:
        S_T = emit(log_s)
        return (S_T, v) if return_variance else S_T
    S = torch.stack(s_rows)
    return (S, torch.stack(v_rows)) if return_variance else S


def qe_constants(S0, r, T, params: HestonParams, n_steps: int) -> dict:
    """The QE-M recursion's float32 constants, the 16 values of the TPU
    kernel's _qe_params_array (pallas_heston.py:492-507) rounded in f32 as
    JAX rounds them (gamma1 = gamma2 = 1/2), plus the products the kernel
    forms from them: A = K2 + K4/2, K0 shift (K1 + K3/2), r dt, log S0.
    Shared by the kernel and its plain version."""
    f = np.float32
    dt = f(T) / f(n_steps)
    kappa, theta, xi, rho = f(params.kappa), f(params.theta), f(params.xi), f(params.rho)
    ekt = np.exp(-kappa * dt)
    one_m_ekt = f(1.0) - ekt
    c1 = xi * xi * ekt * one_m_ekt / kappa
    c2 = theta * (xi * xi) * (one_m_ekt * one_m_ekt) / (f(2.0) * kappa)
    g = f(0.5)
    K1 = g * dt * (kappa * rho / xi - f(0.5)) - rho / xi
    K2 = g * dt * (kappa * rho / xi - f(0.5)) + rho / xi
    K3 = g * dt * (f(1.0) - rho * rho)
    K4 = K3
    return dict(s0=f(S0), r=f(r), dt=dt, kappa=kappa, theta=theta, xi=xi, rho=rho,
                v0=f(params.v0), ekt=ekt, c1=c1, c2=c2, K1=K1, K2=K2, K3=K3, K4=K4,
                A=K2 + f(0.5) * K4, k0_shift=K1 + f(0.5) * K3, r_dt=f(r) * dt,
                log_s0=np.log(f(S0)))


def qe_step(log_s: torch.Tensor, v: torch.Tensor, z_v: torch.Tensor,
            z_s: torch.Tensor, u: torch.Tensor, c: dict):
    """One QE-M step from (log S, v) on draws (z_v, z_s, u), with the
    constants ``c`` of qe_constants as Python floats. Both branches are
    computed and selected by mask (psi <= 1.5 takes the quadratic one);
    every clamp of _qe_body is kept. Returns (log S, v) after the step."""
    m = c["theta"] + (v - c["theta"]) * c["ekt"]
    s2 = v * c["c1"] + c["c2"]
    psi = s2 / torch.clamp_min(m * m, 1e-20)

    # 2 / x as tensor / tensor: a true division, as in the kernel
    two_over = torch.full_like(psi, 2.0) / torch.clamp_min(psi, 1e-12)
    b2 = torch.clamp_min(two_over - 1.0
                         + torch.sqrt(torch.clamp_min(two_over, 0.0))
                         * torch.sqrt(torch.clamp_min(two_over - 1.0, 0.0)), 0.0)
    a = m / (1.0 + b2)
    bz = torch.sqrt(b2) + z_v
    v_quad = a * (bz * bz)

    p = torch.clamp((psi - 1.0) / (psi + 1.0), 0.0, 1.0 - 1e-7)
    beta = (1.0 - p) / torch.clamp_min(m, 1e-20)
    v_exp = torch.where(u <= p, 0.0,
                        torch.log((1.0 - p) / torch.clamp_min(1.0 - u, 1e-12))
                        / torch.clamp_min(beta, 1e-20))

    quad = psi <= 1.5
    v_new = torch.where(quad, v_quad, v_exp)

    Aa = c["A"] * a
    one_m = torch.clamp_min(1.0 - 2.0 * Aa, 1e-6)
    k0_quad = -Aa * b2 / one_m + 0.5 * torch.log(one_m)
    k0_exp = -torch.log(torch.clamp_min(
        p + beta * (1.0 - p) / torch.clamp_min(beta - c["A"], 1e-12), 1e-12))
    K0_star = torch.where(quad, k0_quad, k0_exp) - c["k0_shift"] * v

    log_s = (log_s + c["r_dt"] + K0_star + c["K1"] * v + c["K2"] * v_new
             + torch.sqrt(torch.clamp_min(c["K3"] * v + c["K4"] * v_new, 0.0)) * z_s)
    return log_s, v_new


def heston_qe_from_normals(z_v: torch.Tensor, z_s: torch.Tensor, u: torch.Tensor,
                           S0, r, T, params: HestonParams,
                           return_variance: bool = False,
                           return_paths: bool = True):
    """QE-M (qe_step) on draws (z_v, z_s, u) of shape (n_steps, n_paths):
    z_v drives the variance, z_s the log-price, u the exponential branch.

    Carries log S relative to log S0 and writes S = exp(log S0 + rel).
    Returns S (n_steps+1, n_paths) [and v], or with ``return_paths=False``
    S_T [and v_T]."""
    c = {k: float(v) for k, v in qe_constants(S0, r, T, params, z_v.shape[0]).items()}
    log_s = torch.zeros(z_v.shape[1], dtype=torch.float32, device=z_v.device)
    v = torch.full_like(log_s, c["v0"])
    s_rows, v_rows = [torch.exp(c["log_s0"] + log_s)], [v]
    for zv_t, zs_t, u_t in zip(z_v, z_s, u):
        log_s, v = qe_step(log_s, v, zv_t, zs_t, u_t, c)
        if return_paths:
            s_rows.append(torch.exp(c["log_s0"] + log_s))
            v_rows.append(v)
    if not return_paths:
        S_T = torch.exp(c["log_s0"] + log_s)
        return (S_T, v) if return_variance else S_T
    S = torch.stack(s_rows)
    return (S, torch.stack(v_rows)) if return_variance else S


def simulate_heston(seed: int, S0, r, T, params: HestonParams, cfg: MCConfig,
                    return_paths: bool = True, return_variance: bool = False,
                    first_tile: int = 0, scheme: str = "euler",
                    device: Optional[torch.device] = None):
    """Heston paths from the kernels' stream (the port's single engine:
    csrc/heston.cu or csrc/heston_qe.cu on a CUDA device, their plain
    versions on the CPU).

    Returns S (n_steps+1, n_pad) [and v] with return_paths, else S_T (n_pad,);
    n_pad rounds paths_rounded(cfg) up to the kernel tile (PATH_TILE for
    paths, TERMINAL_TILE for terminal values)."""
    if scheme not in ("euler", "qe"):
        raise ValueError(f"scheme must be 'euler' or 'qe', got {scheme!r}")
    from options_model_tpu_torch.ops import cuda_heston

    qe = scheme == "qe"
    if return_paths:
        fn = cuda_heston.heston_paths_qe if qe else cuda_heston.heston_paths
        return fn(seed, S0, r, T, params, paths_rounded(cfg), cfg.n_steps,
                  cfg.antithetic, return_variance, first_tile, device)
    if return_variance:
        raise not_ported("terminal variance", "models.heston.simulate_heston")
    fn = cuda_heston.heston_terminal_qe if qe else cuda_heston.heston_terminal
    return fn(seed, S0, r, T, params, paths_rounded(cfg), cfg.n_steps,
              cfg.antithetic, first_tile, device)


def simulate_heston_maturities(seed: int, S0, r, Ts, params: HestonParams, cfg: MCConfig,
                               return_variance: bool = False, first_tile: int = 0,
                               scheme: str = "euler",
                               device: Optional[torch.device] = None):
    """Path matrices of every maturity in ``Ts`` from one launch of the
    batched paths kernel (csrc/heston_paths.cu on a CUDA device, its plain
    version on the CPU): S (n_mat, n_steps+1, n_pad) [and v]. Maturity m is
    simulate_heston at first_tile + m n_tiles, n_tiles = n_pad / PATH_TILE."""
    from options_model_tpu_torch.ops import cuda_heston

    return cuda_heston.heston_paths_batched(seed, S0, r, Ts, params, paths_rounded(cfg),
                                            cfg.n_steps, cfg.antithetic, return_variance,
                                            first_tile, device, scheme)
