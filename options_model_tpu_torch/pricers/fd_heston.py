"""Heston finite-difference pricer — the American-under-Heston oracle.

Neither the reference nor round 1 had ANY external check on American prices
under stochastic volatility (CRR only covers constant vol). This module adds
a host-side float64 ADI solver of the Heston PDE

    V_t + (r-q) S V_S + kappa (theta - v) V_v + 1/2 v S^2 V_SS
        + 1/2 xi^2 v V_vv + rho xi v S V_Sv - r V = 0

on a uniform (S, v) grid with the Douglas operator-splitting scheme
(theta = 1/2; the mixed derivative handled explicitly) and early exercise by
projection after each time step. Like the CRR oracle (pricers/binomial.py),
the triangular/tridiagonal recursions are host-shaped work — NumPy f64, not
a TPU program; it exists to pin the Monte-Carlo pricers.

Validated in tests/test_fd_heston.py: the European mode must match the COS
characteristic-function price, the American mode must dominate both the
European price and intrinsic, and the LSM Monte-Carlo pricer must agree
within its own tolerance.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from options_model_tpu_torch.core.config import HestonParams


def _thomas_batched(a, b, c, d):
    """Solve many tridiagonal systems: a (sub), b (diag), c (super), each
    (m, n); d (m, n) right-hand sides. Returns x (m, n). Standard Thomas
    elimination vectorized over the batch axis (each system is sequential in
    n, which is fine for n ~ a few hundred on the host)."""
    m, n = b.shape
    cp = np.empty_like(b)
    dp = np.empty_like(b)
    cp[:, 0] = c[:, 0] / b[:, 0]
    dp[:, 0] = d[:, 0] / b[:, 0]
    for i in range(1, n):
        denom = b[:, i] - a[:, i] * cp[:, i - 1]
        cp[:, i] = c[:, i] / denom
        dp[:, i] = (d[:, i] - a[:, i] * dp[:, i - 1]) / denom
    x = np.empty_like(b)
    x[:, -1] = dp[:, -1]
    for i in range(n - 2, -1, -1):
        x[:, i] = dp[:, i] - cp[:, i] * x[:, i + 1]
    return x


def heston_fd_price(S0: float, K: float, T: float, r: float,
                    params: HestonParams, cp: float = -1.0, q: float = 0.0,
                    american: bool = True, n_s: int = 200, n_v: int = 100,
                    n_t: int = 200, s_max_mult: float = 3.0,
                    v_max: Optional[float] = None,
                    exercise_dates: Optional[int] = None) -> float:
    """Price one option by ADI finite differences. Returns a float.

    cp=+1 call / -1 put; ``american`` toggles the early-exercise projection.
    ``exercise_dates``: if set (with american=True), the projection is
    applied only at the n equally spaced dates i*T/n — the BERMUDAN
    contract an n-step LSM actually discretizes (pricers/american.py).
    Pinning the LSM against this matched-dates mode isolates the
    regression/policy bias from the Bermudan->American Richardson gap and
    from this oracle's own grid error. Requires n_t % exercise_dates == 0
    so every date lands exactly on a time step.
    Grid: S in [0, s_max_mult*max(S0,K)] (uniform), v in [0, v_max] (uniform,
    default covers 4x the long-run/initial variance). Interpolation at
    (S0, v0) is bilinear on the converged grid.
    """
    if exercise_dates is not None:
        if not american:
            raise ValueError("exercise_dates requires american=True")
        if n_t % exercise_dates != 0:
            raise ValueError(f"n_t={n_t} must be a multiple of "
                             f"exercise_dates={exercise_dates}")
    stride = n_t // exercise_dates if exercise_dates else 1
    kappa, theta, xi, rho, v0 = (params.kappa, params.theta, params.xi,
                                 params.rho, params.v0)
    s_max = s_max_mult * max(S0, K)
    if v_max is None:
        v_max = max(4.0 * max(theta, v0), 0.5)

    S = np.linspace(0.0, s_max, n_s + 1)
    v = np.linspace(0.0, v_max, n_v + 1)
    ds = S[1] - S[0]
    dv = v[1] - v[0]
    dt = T / n_t

    Sg = S[None, :]          # broadcast over v rows
    vg = v[:, None]

    payoff = np.maximum(cp * (S - K), 0.0)            # (n_s+1,)
    V = np.tile(payoff, (n_v + 1, 1))                 # (n_v+1, n_s+1)

    # --- directional operators (interior coefficients) ---------------------
    # A1 (S-direction): 1/2 v S^2 V_SS + (r-q) S V_S - 1/2 r V
    # A2 (v-direction): 1/2 xi^2 v V_vv + kappa(theta-v) V_v - 1/2 r V
    # A0 (mixed, explicit): rho xi v S V_Sv
    thet = 0.5  # Douglas theta

    # S-direction tridiagonal coefficients, one system per v level: (n_v+1, n_s+1)
    alpha_s = 0.5 * vg * Sg**2 / ds**2
    beta_s = (r - q) * Sg / (2.0 * ds)
    a1_sub = alpha_s - beta_s
    a1_diag = -2.0 * alpha_s - 0.5 * r
    a1_sup = alpha_s + beta_s

    # v-direction tridiagonal coefficients, one system per S level: (n_s+1, n_v+1)
    vgT = v[None, :]
    alpha_v = 0.5 * xi**2 * vgT / dv**2
    beta_v = kappa * (theta - vgT) / (2.0 * dv)
    a2_sub = alpha_v - beta_v
    a2_diag = -2.0 * alpha_v - 0.5 * r
    a2_sup = alpha_v + beta_v
    # v = 0 boundary: the diffusion vanishes; use the first-order one-sided
    # drift kappa*theta/dv * (V[1] - V[0]) (Feller drift pushes inward).
    a2_sub[:, 0] = 0.0
    a2_diag[:, 0] = -kappa * theta / dv - 0.5 * r
    a2_sup[:, 0] = kappa * theta / dv
    # v = v_max boundary: V_v ~ 0 (Neumann) -> zero v-operator row beyond drift
    a2_sub[:, -1] = 0.0
    a2_diag[:, -1] = -0.5 * r
    a2_sup[:, -1] = 0.0

    def apply_A1(U):
        out = np.zeros_like(U)
        out[:, 1:-1] = (a1_sub[:, 1:-1] * U[:, :-2]
                        + a1_diag[:, 1:-1] * U[:, 1:-1]
                        + a1_sup[:, 1:-1] * U[:, 2:])
        # S boundaries handled by Dirichlet values (set below); rows stay 0.
        return out

    def apply_A2(U):
        Ut = U.T  # (n_s+1, n_v+1)
        out = np.zeros_like(Ut)
        out[:, 1:-1] = (a2_sub[:, 1:-1] * Ut[:, :-2]
                        + a2_diag[:, 1:-1] * Ut[:, 1:-1]
                        + a2_sup[:, 1:-1] * Ut[:, 2:])
        out[:, 0] = a2_diag[:, 0] * Ut[:, 0] + a2_sup[:, 0] * Ut[:, 1]
        out[:, -1] = a2_diag[:, -1] * Ut[:, -1]
        return out.T

    def apply_A0(U):
        out = np.zeros_like(U)
        # central cross difference on the interior
        cross = (U[2:, 2:] - U[2:, :-2] - U[:-2, 2:] + U[:-2, :-2]) / (4 * ds * dv)
        out[1:-1, 1:-1] = rho * xi * vg[1:-1] * Sg[:, 1:-1] * cross
        return out

    # Implicit S-step matrices: (I - thet*dt*A1) per v row
    I_a1_sub = -thet * dt * a1_sub
    I_a1_diag = 1.0 - thet * dt * a1_diag
    I_a1_sup = -thet * dt * a1_sup
    # Dirichlet rows at S boundaries
    I_a1_sub[:, 0] = 0.0; I_a1_diag[:, 0] = 1.0; I_a1_sup[:, 0] = 0.0
    I_a1_sub[:, -1] = 0.0; I_a1_diag[:, -1] = 1.0; I_a1_sup[:, -1] = 0.0

    I_a2_sub = -thet * dt * a2_sub
    I_a2_diag = 1.0 - thet * dt * a2_diag
    I_a2_sup = -thet * dt * a2_sup

    def s_boundaries(tau):
        """Dirichlet S-boundary values at time-to-expiry tau."""
        if cp < 0:  # put
            lo = K if american else K * np.exp(-r * tau)
            hi = 0.0
        else:       # call
            lo = 0.0
            hi = s_max * np.exp(-q * tau) - K * np.exp(-r * tau)
            if american:
                hi = max(hi, s_max - K)
        return lo, hi

    # The v-direction coefficients are S-independent and time-invariant:
    # broadcast the (1, n_v+1) rows across the S batch ONCE (the Thomas
    # solver overwrites its cp/dp scratch, not these).
    bshape = (n_s + 1, n_v + 1)
    I2_sub = np.broadcast_to(I_a2_sub, bshape).copy()
    I2_diag = np.broadcast_to(I_a2_diag, bshape).copy()
    I2_sup = np.broadcast_to(I_a2_sup, bshape).copy()

    for step in range(1, n_t + 1):
        tau = step * dt
        A1V = apply_A1(V)
        A2V = apply_A2(V)
        Y0 = V + dt * (apply_A0(V) + A1V + A2V)
        # S-direction implicit correction
        rhs1 = Y0 - thet * dt * A1V
        lo, hi = s_boundaries(tau)
        rhs1[:, 0] = lo
        rhs1[:, -1] = hi
        Y1 = _thomas_batched(I_a1_sub, I_a1_diag, I_a1_sup, rhs1)
        # v-direction implicit correction
        rhs2 = (Y1 - thet * dt * A2V).T
        Y2 = _thomas_batched(I2_sub, I2_diag, I2_sup, rhs2).T
        V = Y2
        V[:, 0] = lo
        V[:, -1] = hi
        if american and (n_t - step) % stride == 0:
            # continuous mode: every step. Bermudan mode: only when the
            # REMAINING time is a whole number of inter-date intervals,
            # i.e. t = T - tau sits on an exercise date (t=0 excluded:
            # step == n_t is the valuation time, not an exercise right —
            # matching the LSM backward, which stops at the first step).
            if step < n_t or exercise_dates is None:
                V = np.maximum(V, payoff[None, :])

    # bilinear interpolation at (v0, S0)
    si = min(max(int(S0 / ds), 0), n_s - 1)
    vi = min(max(int(v0 / dv), 0), n_v - 1)
    ws = (S0 - S[si]) / ds
    wv = (v0 - v[vi]) / dv
    return float((1 - wv) * ((1 - ws) * V[vi, si] + ws * V[vi, si + 1])
                 + wv * ((1 - ws) * V[vi + 1, si] + ws * V[vi + 1, si + 1]))
