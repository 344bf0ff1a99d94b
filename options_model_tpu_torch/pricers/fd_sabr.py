"""SABR finite-difference pricer, the American-under-SABR oracle: the
port's own copy of options_model_tpu/pricers/fd_sabr.py (host-side NumPy
float64, no JAX), the same Douglas ADI as pricers/fd_heston.py, with early
exercise by projection, for the lognormal-backbone SABR family (beta = 1):

    dF = alpha F dW1,   d alpha = nu alpha dW2,   corr(dW1, dW2) = rho

PDE on the T-forward F (a martingale) with discounting at r:

    V_t + 1/2 alpha^2 F^2 V_FF + rho nu alpha^2 F V_Falpha
        + 1/2 nu^2 alpha^2 V_aa - r V = 0

American exercise acts on the spot S_t = F_t e^{-(r-q)(T-t)}, so the
projection payoff is time-dependent: h(F, tau) = max(cp (F e^{-(r-q) tau} -
K), 0), tau the time to expiry.
"""

from __future__ import annotations

import numpy as np

from options_model_tpu_torch.core.config import SABRParams
from options_model_tpu_torch.pricers.fd_heston import _thomas_batched


def sabr_fd_price(S0: float, K: float, T: float, r: float,
                  params: SABRParams, cp: float = -1.0, q: float = 0.0,
                  american: bool = True, n_f: int = 300, n_a: int = 120,
                  n_t: int = 300, f_max_mult: float = 4.0,
                  a_max_sigmas: float = 4.0,
                  alpha_drift: float = 0.0,
                  exercise_dates=None) -> float:
    """Price one option by ADI finite differences. Returns a float.

    ``exercise_dates``: if set (with american=True), the early-exercise
    projection applies only at the n equally spaced dates i*T/n — the
    BERMUDAN contract an n-step LSM discretizes, same contract and
    stride rule as pricers/fd_heston.py (requires n_t % exercise_dates
    == 0; the valuation time t=0 is not an exercise right).

    beta must be 1 (the simulator's log-Euler backbone; CEV backbones would
    need a different F-operator). Grid: F in [0, f_max_mult*max(F0,K)]
    uniform; alpha in [0, alpha0*exp(a_max_sigmas*nu*sqrt(T)) + a pad]
    uniform (the lognormal vol's quantile cover). Bilinear interpolation at
    (F0, alpha0).

    ``alpha_drift``: deterministic per-unit drift c in d alpha = c alpha dt
    + nu alpha dW2 (default 0 = classic driftless SABR). Discretized upwind
    (M-matrix: off-diagonals stay non-negative where diffusion vanishes at
    small alpha). This is what makes the solver double as the H=1/2
    rough-Bergomi oracle: there v is lognormal (dv = eta v dW), so the vol
    alpha = sqrt(v) follows d alpha = alpha (eta/2 dW - eta^2/8 dt) — SABR
    (beta=1, nu=eta/2) with c = -eta^2/8 (models/rbergomi.py).
    """
    if abs(float(params.beta) - 1.0) > 1e-12:
        raise ValueError("sabr_fd_price covers the beta=1 backbone "
                         f"(models/sabr.py simulator), got beta={params.beta}")
    if exercise_dates is not None:
        if not american:
            raise ValueError("exercise_dates requires american=True")
        if n_t % exercise_dates != 0:
            raise ValueError(f"n_t={n_t} must be a multiple of "
                             f"exercise_dates={exercise_dates}")
    stride = n_t // exercise_dates if exercise_dates else 1
    alpha0, rho, nu = float(params.alpha), float(params.rho), float(params.nu)
    drift = r - q
    F0 = S0 * np.exp(drift * T)
    f_max = f_max_mult * max(F0, K)
    a_max = alpha0 * np.exp(a_max_sigmas * nu * np.sqrt(T)) + 0.5 * alpha0

    F = np.linspace(0.0, f_max, n_f + 1)
    a = np.linspace(0.0, a_max, n_a + 1)
    df = F[1] - F[0]
    da = a[1] - a[0]
    dt = T / n_t

    Fg = F[None, :]          # broadcast over alpha rows
    ag = a[:, None]

    def payoff(tau):
        # exercise on the spot S = F e^{-drift * tau}
        return np.maximum(cp * (F * np.exp(-drift * tau) - K), 0.0)

    V = np.tile(payoff(0.0), (n_a + 1, 1))            # (n_a+1, n_f+1)

    thet = 0.5  # Douglas theta

    # F-direction: 1/2 alpha^2 F^2 V_FF - 1/2 r V  (martingale: no F drift)
    alpha_f = 0.5 * ag**2 * Fg**2 / df**2
    a1_sub = alpha_f
    a1_diag = -2.0 * alpha_f - 0.5 * r
    a1_sup = alpha_f.copy()

    # alpha-direction: 1/2 nu^2 alpha^2 V_aa + c alpha V_a - 1/2 r V.
    # Drift by upwind one-sided differences (split b = c*alpha into its
    # positive/negative parts) so the tridiagonal stays an M-matrix even
    # where the alpha^2 diffusion vanishes.
    agT = a[None, :]
    alpha_a = 0.5 * nu**2 * agT**2 / da**2
    b_a = alpha_drift * agT
    a2_sub = np.broadcast_to(alpha_a + np.maximum(-b_a, 0.0) / da,
                             (n_f + 1, n_a + 1)).copy()
    a2_diag = np.broadcast_to(-2.0 * alpha_a - np.abs(b_a) / da - 0.5 * r,
                              (n_f + 1, n_a + 1)).copy()
    a2_sup = np.broadcast_to(alpha_a + np.maximum(b_a, 0.0) / da,
                             (n_f + 1, n_a + 1)).copy()
    # alpha = 0: the vol process is absorbed (nu^2 a^2 -> 0); only the -r/2
    # discount survives in this direction.
    a2_sub[:, 0] = 0.0
    a2_diag[:, 0] = -0.5 * r
    a2_sup[:, 0] = 0.0
    # alpha = a_max: Neumann V_a ~ 0
    a2_sub[:, -1] = 0.0
    a2_diag[:, -1] = -0.5 * r
    a2_sup[:, -1] = 0.0

    def apply_A1(U):
        out = np.zeros_like(U)
        out[:, 1:-1] = (a1_sub[:, 1:-1] * U[:, :-2]
                        + a1_diag[:, 1:-1] * U[:, 1:-1]
                        + a1_sup[:, 1:-1] * U[:, 2:])
        return out

    def apply_A2(U):
        Ut = U.T                                       # (n_f+1, n_a+1)
        out = np.zeros_like(Ut)
        out[:, 1:-1] = (a2_sub[:, 1:-1] * Ut[:, :-2]
                        + a2_diag[:, 1:-1] * Ut[:, 1:-1]
                        + a2_sup[:, 1:-1] * Ut[:, 2:])
        out[:, 0] = a2_diag[:, 0] * Ut[:, 0]
        out[:, -1] = a2_diag[:, -1] * Ut[:, -1]
        return out.T

    def apply_A0(U):
        out = np.zeros_like(U)
        cross = (U[2:, 2:] - U[2:, :-2] - U[:-2, 2:] + U[:-2, :-2]) / (
            4 * df * da)
        out[1:-1, 1:-1] = rho * nu * ag[1:-1]**2 * Fg[:, 1:-1] * cross
        return out

    I_a1_sub = -thet * dt * a1_sub
    I_a1_diag = 1.0 - thet * dt * a1_diag
    I_a1_sup = -thet * dt * a1_sup
    I_a1_sub[:, 0] = 0.0; I_a1_diag[:, 0] = 1.0; I_a1_sup[:, 0] = 0.0
    I_a1_sub[:, -1] = 0.0; I_a1_diag[:, -1] = 1.0; I_a1_sup[:, -1] = 0.0

    I2_sub = -thet * dt * a2_sub
    I2_diag = 1.0 - thet * dt * a2_diag
    I2_sup = -thet * dt * a2_sup

    def f_boundaries(tau):
        """Dirichlet F-boundary values at time-to-expiry tau (spot payoff)."""
        if cp < 0:   # put: F=0 -> S=0 -> exercise now worth K / EU disc K
            lo = K if american else K * np.exp(-r * tau)
            hi = 0.0
        else:        # call at F_max
            s_here = f_max * np.exp(-drift * tau)
            hi = s_here - K * np.exp(-r * tau)
            if american:
                hi = max(hi, s_here - K)
            lo = 0.0
        return lo, hi

    for step in range(1, n_t + 1):
        tau = step * dt
        A1V = apply_A1(V)
        A2V = apply_A2(V)
        Y0 = V + dt * (apply_A0(V) + A1V + A2V)
        rhs1 = Y0 - thet * dt * A1V
        lo, hi = f_boundaries(tau)
        rhs1[:, 0] = lo
        rhs1[:, -1] = hi
        Y1 = _thomas_batched(I_a1_sub, I_a1_diag, I_a1_sup, rhs1)
        rhs2 = (Y1 - thet * dt * A2V).T
        Y2 = _thomas_batched(I2_sub, I2_diag, I2_sup, rhs2).T
        V = Y2
        V[:, 0] = lo
        V[:, -1] = hi
        if american and step % stride == 0 and (
                step < n_t or exercise_dates is None):
            V = np.maximum(V, payoff(tau)[None, :])

    fi = min(max(int(F0 / df), 0), n_f - 1)
    ai = min(max(int(alpha0 / da), 0), n_a - 1)
    wf = (F0 - F[fi]) / df
    wa = (alpha0 - a[ai]) / da
    return float((1 - wa) * ((1 - wf) * V[ai, fi] + wf * V[ai, fi + 1])
                 + wa * ((1 - wf) * V[ai + 1, fi] + wf * V[ai + 1, fi + 1]))
