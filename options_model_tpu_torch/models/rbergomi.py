"""Rough Bergomi (rBergomi) on the port's Philox stream, as
options_model_tpu/models/rbergomi.py:

    v_t = xi0 exp(eta Y_t - eta^2/2 Var Y_t),
    Y_t = sqrt(2H) int_0^t (t-s)^{H-1/2} dW_s,
    dS/S = r dt + sqrt(v_t) (rho dW + rho_bar dW_perp).

The Bennedsen-Lunde-Pakkanen hybrid scheme (kappa = 1) on n_steps
left-point intervals:
- the Volterra sum over past increments is one strictly lower-triangular
  product G = W_mat dW (``volterra``: a float32 matrix product with TF32
  off, as the reference runs it at Precision.HIGHEST);
- the singular most-recent interval is its exact Gaussian, c1 dW + c2 z2;
- the compensator is the scheme's discrete Var(Y_{t_k}) in float64, cast
  once (``_hybrid_weights`` ``var``), so E[v_t] = xi0 holds exactly under
  the discretization (the analytic t^{2H} is off it by up to 0.09% at 50
  steps for H = 0.1, a bias of E[v] of eta^2/2 times that gap);
- the spot takes the left-point log-Euler step with the variance at the
  start of each interval.

``rbergomi_from_draws`` runs the scheme on given normals (z1, z2, zp), the
plain version the kernels are held against and the function the tests feed
the JAX package's own draws. ``simulate_rbergomi`` draws the rough
Bergomi stream (ops/philox.rbergomi_path_draws, counter word 3 = 4) and on
the card runs kernel 25 (the Brownian increments dW), the Volterra product, and kernel
26 (the walk: Y, v, the spot, the dual state or the control-variate leg),
ops/cuda_rbergomi.py. ``rbergomi_exact_chol`` is the reference's float64
exact-covariance oracle, copied.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch

from options_model_tpu_torch._unported import not_ported
from options_model_tpu_torch.core.config import MCConfig, RBergomiParams
from options_model_tpu_torch.models.blocks import paths_rounded
from options_model_tpu_torch.ops.autodiff import requires_grad


# ---------------------------------------------------------------------------
# Hybrid-scheme (kappa = 1) ingredients
# ---------------------------------------------------------------------------

@lru_cache(maxsize=64)
def _hybrid_weights(n_steps: int, H: float, dt: float):
    """(W_mat, c1, c2, var) of the BLP kappa = 1 scheme at this grid, float64
    (the reference's, operation for operation).

    gamma = H - 1/2. Y_{t_k} = sqrt(2H) [c1 dW_k + c2 Z2_k + sum_{j>=2} w_j
    dW_{k-j+1}] with b_j = ((j^{g+1} - (j-1)^{g+1})/(g+1))^{1/g}, w_j = (b_j
    dt)^g, c1 = dt^g / (g+1), c2 = dt^{g+1/2} sqrt(1/(2g+1) - 1/(g+1)^2).
    W_mat is strictly lower triangular, W_mat[k-1, i-1] = w_{k-i+1};
    var[k] (k = 0..n_steps) the discrete Var(Y_{t_k}). At H = 1/2 the
    kernel is 1: W_mat is all ones below the diagonal, c1 = 1, c2 = 0 and
    var[k] = t_k."""
    g = H - 0.5
    j = np.arange(2, n_steps + 1, dtype=np.float64)
    if abs(g) < 1e-12:                      # H = 1/2: kernel == 1
        w = np.ones_like(j)
        c1 = np.float64(dt) ** g / (g + 1.0)          # = 1
        c2 = 0.0
    else:
        b = ((j ** (g + 1.0) - (j - 1.0) ** (g + 1.0)) / (g + 1.0)) ** (1.0 / g)
        w = (b * dt) ** g
        c1 = dt ** g / (g + 1.0)
        c2 = dt ** (g + 0.5) * np.sqrt(
            max(1.0 / (2.0 * g + 1.0) - 1.0 / (g + 1.0) ** 2, 0.0))
    W_mat = np.zeros((n_steps, n_steps), np.float64)
    for lag in range(1, n_steps):           # W_mat[k, k-lag] = w_{lag+1}
        idx = np.arange(lag, n_steps)
        W_mat[idx, idx - lag] = w[lag - 1]
    far = np.concatenate([[0.0], np.cumsum(w**2)])        # k = 1..n_steps
    var = 2.0 * H * (dt * (c1**2 + far) + c2**2)
    var = np.concatenate([[0.0], var])                    # k = 0..n_steps
    return W_mat, float(c1), float(c2), var


def rbergomi_constants(S0, T, params: RBergomiParams, n_steps: int, rate=0.0) -> dict:
    """float32 constants as the reference's simulate_rbergomi rounds them:
    the float64 host values cast once (dt, sqrt(dt), sqrt(2H), c1, c2,
    W_mat), the rest taken in float32 (rho_bar = sqrt(1 - rho^2), the
    compensator comp[k] = (0.5 eta^2) var[k], rbsd = rho_bar sqrt(dt), log
    S0). The control-variate leg (the reference's terminal_cv_core): sig_cv
    = sqrt(xi0) and its log step's drift (r - sig_cv^2 / 2) dt."""
    f = np.float32
    dt = float(T) / n_steps
    W_np, c1, c2, var = _hybrid_weights(n_steps, float(params.H), dt)
    eta, rho, xi0, r = f(params.eta), f(params.rho), f(params.xi0), f(rate)
    rho_bar = np.sqrt(f(1.0) - rho * rho)
    sqrt_dt = f(np.sqrt(dt))
    sig_cv = np.sqrt(xi0)
    dt32 = f(dt)
    return dict(W_mat=W_np.astype(np.float32), dt=dt32, sqrt_dt=sqrt_dt,
                sqrt2H=f(np.sqrt(2.0 * params.H)), c1=f(c1), c2=f(c2), eta=eta, rho=rho,
                rho_bar=rho_bar, rbsd=rho_bar * sqrt_dt, xi0=xi0, r=r,
                comp=(f(0.5) * (eta * eta)) * var.astype(np.float32),
                log_s0=np.log(f(S0)), sig_cv=sig_cv,
                cv_drift=(r - f(0.5) * (sig_cv * sig_cv)) * dt32)


def volterra(W_mat: torch.Tensor, dW: torch.Tensor) -> torch.Tensor:
    """G = W_mat @ dW (n_steps, P): G[k] = sum_{i<k} w_{k-i+1} dW_i, the
    F_{t_k}-measurable part of Y_{t_{k+1}}. A float32 matrix product in full
    float32: raises if TF32 is on (TF32 keeps ~3 decimal digits)."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the Volterra product needs full float32 matmuls: set "
                           "torch.backends.cuda.matmul.allow_tf32 = False")
    return torch.matmul(W_mat.to(device=dW.device, dtype=dW.dtype), dW)


def rbergomi_walk(dW: torch.Tensor, G: torch.Tensor, z2: torch.Tensor, zp: torch.Tensor,
                  c: dict, mode: str = "paths", return_variance: bool = False,
                  return_dual_state: bool = False):
    """The scheme's walk on the Brownian increments dW, the Volterra sums G and the
    normals z2, zp (each (n_steps, P)), step by step in kernel 26's order:
    Y_{k+1} = sqrt2H ((G_k + c1 dW_k) + c2 z2_k), v_{k+1} = xi0 exp(eta
    Y_{k+1} - comp[k+1]), and x += (r - v_k/2) dt + sqrt(v_k) (rho dW_k +
    rbsd zp_k) from v_0 = xi0, S = exp(log S0 + x).

    mode "paths": S (n_steps+1, P) [, v (n_steps+1, P)] [, hist = sqrt2H G
    (n_steps, P) with ``return_dual_state``, which implies v]; "terminal":
    S_T [, v_T]; "cv": (S_T, G_T), G_T the frozen-variance (v = xi0)
    lognormal on the same price Brownian."""
    n = dW.shape[0]
    t = lambda v: torch.tensor(float(v), dtype=dW.dtype, device=dW.device)  # noqa: E731
    log_s0, r, dt, rho, rbsd = t(c["log_s0"]), t(c["r"]), t(c["dt"]), t(c["rho"]), t(c["rbsd"])
    sqrt2H, c1, c2, eta, xi0 = t(c["sqrt2H"]), t(c["c1"]), t(c["c2"]), t(c["eta"]), t(c["xi0"])
    comp = torch.as_tensor(c["comp"], device=dW.device).to(dW.dtype)
    cv_drift, sig_cv = t(c["cv_drift"]), t(c["sig_cv"])
    v_prev = torch.full_like(dW[0], float(c["xi0"]))
    x = torch.zeros_like(dW[0])
    xg = torch.zeros_like(dW[0])
    S_rows, v_rows = [torch.exp(log_s0 + x)], [v_prev]
    for k in range(n):
        dB = rho * dW[k] + rbsd * zp[k]
        x = x + ((r - 0.5 * v_prev) * dt + torch.sqrt(v_prev) * dB)
        if mode == "cv":
            xg = xg + (cv_drift + sig_cv * dB)
        Y = sqrt2H * ((G[k] + c1 * dW[k]) + c2 * z2[k])
        v_prev = xi0 * torch.exp(eta * Y - comp[k + 1])
        if mode == "paths":
            S_rows.append(torch.exp(log_s0 + x))
            v_rows.append(v_prev)
    if mode == "cv":
        return torch.exp(log_s0 + x), torch.exp(log_s0 + xg)
    if mode == "terminal":
        S_T = torch.exp(log_s0 + x)
        return (S_T, v_prev) if return_variance else S_T
    S = torch.stack(S_rows)
    if return_dual_state:
        return S, torch.stack(v_rows), sqrt2H * G
    return (S, torch.stack(v_rows)) if return_variance else S


def rbergomi_from_draws(z1: torch.Tensor, z2: torch.Tensor, zp: torch.Tensor, S0, T,
                        params: RBergomiParams, rate=0.0, *, return_paths: bool = False,
                        return_variance: bool = False, return_dual_state: bool = False,
                        return_cv: bool = False):
    """The hybrid scheme on given normals z1 (the Volterra Brownian's), z2 (the singular
    term's orthogonal part) and zp (the price's orthogonal Brownian), each
    (n_steps, n_paths) float32: dW = sqrt(dt) z1, G = volterra(W_mat, dW),
    then rbergomi_walk. Returns S_T, or (S_T, v_T) with ``return_variance``,
    or (S_T, G_T) with ``return_cv``; with ``return_paths`` the matrices S,
    (S, v) or, with ``return_dual_state``, (S, v, hist)."""
    if return_dual_state and not return_paths:
        raise ValueError("return_dual_state requires return_paths=True")
    if return_cv and return_paths:
        raise ValueError("the control variate's leg is a terminal output")
    c = rbergomi_constants(S0, T, params, z1.shape[0], rate)
    dW = float(c["sqrt_dt"]) * z1
    G = volterra(torch.from_numpy(c["W_mat"]), dW)
    mode = "paths" if return_paths else ("cv" if return_cv else "terminal")
    return rbergomi_walk(dW, G, z2, zp, c, mode, return_variance, return_dual_state)


def _check_grad(fn: str, *args) -> None:
    if requires_grad(*args):
        raise not_ported(f"gradients of the rBergomi paths ({fn} through csrc/rbergomi.cu)",
                         f"models.rbergomi.{fn}")


def simulate_rbergomi(seed: int, S0, T, params: RBergomiParams, cfg: MCConfig, rate=0.0, *,
                      return_paths: bool = False, return_variance: bool = False,
                      first_tile: int = 0, return_dual_state: bool = False,
                      device: Optional[torch.device] = None):
    """rBergomi to T on cfg.n_steps left-point intervals from the rough
    Bergomi stream (PATH_TILE tiles; ``first_tile`` the global tile of the
    first, the reference's first_block): kernel 25, the Volterra product and
    kernel 26 on a CUDA device (on the card by default), their plain
    versions on the CPU. Returns S_T (n_pad,) [and v_T], or with
    ``return_paths`` the (n_steps+1, n_pad) matrix [and v's]; with
    ``return_dual_state`` (paths and variance) also hist (n_steps, n_pad) =
    sqrt(2H) G, the frozen Volterra history the rough dual's inner sampler
    needs: Y_{t+1} = hist[t] + sqrt(2H) (c1 dW_{t+1} + c2 Z2_{t+1})."""
    from options_model_tpu_torch.ops import cuda_rbergomi

    if return_dual_state and not (return_paths and return_variance):
        raise ValueError("return_dual_state requires return_paths=True and "
                         "return_variance=True")
    _check_grad("simulate_rbergomi", S0, T, rate, params.H, params.eta, params.rho, params.xi0)
    mode = "paths" if return_paths else "terminal"
    return cuda_rbergomi.rbergomi_simulate(seed, S0, T, params, paths_rounded(cfg), cfg.n_steps,
                                           rate, mode, cfg.antithetic, first_tile, device,
                                           return_variance, return_dual_state)


def terminal_cv_core(seed: int, S0, r, T, params: RBergomiParams, n_steps: int, n_paths: int,
                     antithetic: bool = True, first_tile: int = 0,
                     device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(S_T, G_T) of n_paths (rounded up to PATH_TILE) at n_steps: one
    kernel-26 launch in its control-variate mode (after kernel 25 and the
    Volterra product), or its plain version on the CPU. The calibrator's
    engine (calibration/rbergomi.py), one launch an expiry."""
    from options_model_tpu_torch.ops import cuda_rbergomi

    return cuda_rbergomi.rbergomi_simulate(seed, S0, T, params, n_paths, n_steps, r, "cv",
                                           antithetic, first_tile, device)


def rbergomi_terminal_cv(seed: int, S0, r, T, params: RBergomiParams, cfg: MCConfig,
                         device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(S_T, G_T): terminal rBergomi spots and the conditional-Black control
    variate's, the frozen-variance (v = xi0) lognormal on the identical
    price Brownian, whose European price is Black-Scholes(sqrt(xi0))
    exactly."""
    _check_grad("rbergomi_terminal_cv", S0, r, T, params.H, params.eta, params.rho, params.xi0)
    return terminal_cv_core(seed, S0, r, T, params, cfg.n_steps, paths_rounded(cfg),
                            cfg.antithetic, 0, device)


def rbergomi_european_estimate(S_T: torch.Tensor, G_T: Optional[torch.Tensor], S0, K, r, T,
                               xi0, cp=1.0, pair_block: Optional[int] = None):
    """(price, stderr) of the European on terminal spots S_T, discounted at
    r: the plain mean, or with G_T the conditional-Black control variate
    (its mean Black-Scholes(S0, K, sqrt(xi0))) at the pair-mean optimal
    beta. The stderr over antithetic pair means of ``pair_block``."""
    from options_model_tpu_torch.core.stats import masked_mean_stderr, optimal_cv_beta
    from options_model_tpu_torch.pricers.blackscholes import bs_price

    f = np.float32
    disc = float(np.exp(-f(r) * f(T)))
    pay = disc * torch.clamp_min(cp * (S_T - K), 0.0)
    if G_T is None:
        mean, se, _ = masked_mean_stderr(pay, pair_block=pair_block)
        return mean, se
    cv_pay = disc * torch.clamp_min(cp * (G_T - K), 0.0)
    cv_mean = bs_price(S0, K, T, r, float(np.sqrt(f(xi0))), cp, dtype=S_T.dtype,
                       device=S_T.device)
    adj = cv_pay - cv_mean
    b = optimal_cv_beta(pay, adj, pair_block=pair_block)
    mean, se, _ = masked_mean_stderr(pay + b * adj, pair_block=pair_block)
    return mean, se


def rbergomi_european_mc(generator: torch.Generator, S0, K, r, T, params: RBergomiParams,
                         cfg: MCConfig, cp=1.0, control_variate: bool = True,
                         device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """European price under rBergomi with the conditional-Black control
    variate (rbergomi_european_estimate) on one seed from ``generator``, on
    the card by default. Returns (price, stderr), the stderr over antithetic
    pair means of the stream's PATH_TILE tiles."""
    from options_model_tpu_torch.ops.cuda_heston import PATH_TILE
    from options_model_tpu_torch.ops.engine import checked_device
    from options_model_tpu_torch.ops.philox import seed_from_generator

    device = checked_device(device)
    S_T, G_T = rbergomi_terminal_cv(seed_from_generator(generator), S0, r, T, params, cfg,
                                    device)
    return rbergomi_european_estimate(S_T, G_T if control_variate else None, S0, K, r, T,
                                      params.xi0, cp, PATH_TILE if cfg.antithetic else None)


# ---------------------------------------------------------------------------
# Exact-covariance Cholesky oracle (host, float64), the reference's
# ---------------------------------------------------------------------------

def _yy_cov(ti: float, tj: float, H: float, n_quad: int = 64) -> float:
    """Cov(Y_ti, Y_tj) = 2H int_0^{min} (ti-s)^g (tj-s)^g ds, g = H - 1/2:
    t^{2H} on the diagonal, else Gauss-Legendre after u = (ti - s)^{g+1}."""
    if ti > tj:
        ti, tj = tj, ti
    g = H - 0.5
    if ti <= 0.0:
        return 0.0
    if abs(ti - tj) < 1e-15:
        return ti ** (2.0 * H)
    x, w = np.polynomial.legendre.leggauss(n_quad)
    umax = ti ** (g + 1.0)
    u = 0.5 * umax * (x + 1.0)
    val = np.sum(w * (tj - ti + u ** (1.0 / (g + 1.0))) ** g) * 0.5 * umax
    return 2.0 * H * val / (g + 1.0)


def _yw_cov(ti: float, tj: float, H: float) -> float:
    """Cov(Y_ti, W_tj) = sqrt(2H)/(H+1/2) [ti^{H+1/2} - (ti - min)^{H+1/2}]."""
    m = min(ti, tj)
    if m <= 0.0:
        return 0.0
    e = H + 0.5
    return np.sqrt(2.0 * H) / e * (ti ** e - (ti - m) ** e)


def rbergomi_exact_chol(seed: int, S0, K, r, T, params: RBergomiParams, n_steps: int,
                        n_paths: int, cp=1.0, antithetic: bool = True
                        ) -> Tuple[float, float, np.ndarray]:
    """European price through exact joint sampling of (Y grid, W
    increments): the (2n x 2n) covariance of (Y_{t_1..t_n}, dW_1..dW_n),
    its Cholesky factor, and the hybrid scheme's left-point price
    construction with the analytic compensator t^{2H}, in float64 NumPy on
    the host with numpy's default_rng(seed). Returns (price, stderr,
    terminal spots)."""
    H = float(params.H)
    dt = float(T) / n_steps
    t = (np.arange(1, n_steps + 1, dtype=np.float64)) * dt

    n = n_steps
    C = np.zeros((2 * n, 2 * n))
    for i in range(n):
        for j in range(i, n):
            C[i, j] = C[j, i] = _yy_cov(t[i], t[j], H)
    C[n:, n:] = np.eye(n) * dt
    for i in range(n):
        for j in range(n):
            hi = _yw_cov(t[i], t[j], H)
            lo = _yw_cov(t[i], t[j] - dt, H) if j > 0 else 0.0
            C[i, n + j] = C[n + j, i] = hi - lo
    L = np.linalg.cholesky(C + 1e-14 * np.eye(2 * n) * max(C.max(), 1.0))

    rng = np.random.default_rng(seed)
    m = n_paths // 2 if antithetic else n_paths
    Z = rng.standard_normal((2 * n, m))
    if antithetic:
        Z = np.concatenate([Z, -Z], axis=1)
    X = L @ Z
    Y_grid = X[:n]
    dW = X[n:]
    Zp = rng.standard_normal((n, m))
    if antithetic:
        Zp = np.concatenate([Zp, -Zp], axis=1)

    Y_left = np.vstack([np.zeros((1, dW.shape[1])), Y_grid[:-1]])
    t_left = np.arange(n, dtype=np.float64) * dt
    v = float(params.xi0) * np.exp(
        float(params.eta) * Y_left
        - 0.5 * float(params.eta) ** 2 * t_left[:, None] ** (2.0 * H))
    rho = float(params.rho)
    rho_bar = np.sqrt(1.0 - rho**2)
    dB = rho * dW + rho_bar * np.sqrt(dt) * Zp
    logS = np.log(float(S0)) + np.sum(
        (float(r) - 0.5 * v) * dt + np.sqrt(v) * dB, axis=0)
    S_T = np.exp(logS)
    pay = np.exp(-float(r) * float(T)) * np.maximum(
        float(cp) * (S_T - float(K)), 0.0)
    if antithetic:
        pm = 0.5 * (pay[:m] + pay[m:])
        return (float(pm.mean()),
                float(pm.std(ddof=1) / np.sqrt(m)), S_T)
    return float(pay.mean()), float(pay.std(ddof=1) / np.sqrt(n_paths)), S_T
