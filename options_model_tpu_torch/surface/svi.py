"""SVI parametric implied-volatility surface (Gatheral) and its Dupire local
vol, as options_model_tpu/surface/svi.py:

  * one raw-SVI total-variance smile per expiry,
        w(k) = a + b (rho (k - m) + sqrt((k - m)^2 + s^2)),   k = log(K/F),
    fitted by float64 multi-start weighted least squares, with
    torch.autograd gradients into scipy's L-BFGS-B (fit_svi_slice);
  * Dupire local vol through Gatheral's formula on total variance,

        sigma_loc^2(k, T) =
            dw/dT / [1 - k/w dw/dk
                     + 1/4 (-1/4 - 1/w + k^2/w^2) (dw/dk)^2 + 1/2 d2w/dk2],

    the k-derivatives analytic in the SVI parameters, dw/dT from the linear
    interpolation of total variance across expiries through a T = 0 anchor
    (SVISurface.local_vol_fn). Its ``sigma(S, tau)`` feeds the local-vol
    simulators: compiled into a Chebyshev table for kernels 7 and 8
    (surface/cheb.py), or bare (models/localvol.py).

No-arbitrage diagnostics (Gatheral & Jacquier 2014): butterfly, g(k) >= 0
with g(k) = (1 - k w'/(2w))^2 - w'^2/4 (1/w + 1/4) + w''/2; calendar,
w(k, T2) >= w(k, T1) for T2 > T1 on a k-grid.

The elementwise functions keep the dtype and device of their tensor input
(a numpy or Python input becomes a CPU tensor of its dtype); the surface's
methods work in float32, as the reference's do.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from options_model_tpu_torch.ops.engine import checked_device


@dataclasses.dataclass(frozen=True)
class SVISlice:
    """Raw-SVI parameters of one expiry's total-variance smile."""
    a: float
    b: float      # >= 0
    rho: float    # in (-1, 1)
    m: float
    s: float      # > 0 ("sigma" in the literature; s avoids the vol clash)

    def validate(self) -> "SVISlice":
        if self.b < 0:
            raise ValueError(f"b={self.b} must be non-negative")
        if not -1.0 < self.rho < 1.0:
            raise ValueError(f"rho={self.rho} must be in (-1, 1)")
        if self.s <= 0:
            raise ValueError(f"s={self.s} must be positive")
        if self.a + self.b * self.s * np.sqrt(1.0 - self.rho**2) < 0:
            raise ValueError("negative minimum total variance "
                             "(a + b s sqrt(1-rho^2) < 0)")
        return self


def svi_total_variance(k, sl: SVISlice) -> torch.Tensor:
    """w(k) = a + b (rho (k-m) + sqrt((k-m)^2 + s^2)); elementwise in k."""
    km = torch.as_tensor(k) - sl.m
    return sl.a + sl.b * (sl.rho * km + torch.sqrt(km**2 + sl.s**2))


def _w_and_k_derivs(k, sl: SVISlice):
    """(w, dw/dk, d2w/dk2), analytic."""
    km = torch.as_tensor(k) - sl.m
    root = torch.sqrt(km**2 + sl.s**2)
    w = sl.a + sl.b * (sl.rho * km + root)
    w1 = sl.b * (sl.rho + km / root)
    w2 = sl.b * sl.s**2 / root**3
    return w, w1, w2


def svi_butterfly_g(k, sl: SVISlice) -> torch.Tensor:
    """Gatheral-Jacquier density function g(k); g >= 0 everywhere iff the
    slice is free of butterfly arbitrage."""
    w, w1, w2 = _w_and_k_derivs(k, sl)
    kk = torch.as_tensor(k)
    return (1.0 - kk * w1 / (2.0 * w))**2 - 0.25 * w1**2 * (1.0 / w + 0.25) + 0.5 * w2


def fit_svi_slice(F, T, strikes, ivs, weights=None, n_starts: int = 6,
                  device=None) -> Tuple[SVISlice, dict]:
    """Fit one expiry's raw-SVI slice to (strikes, implied vols).

    Weighted least squares on total variance (w = iv^2 T), float64 on
    ``device`` (the card by default), exact gradients by torch.autograd,
    L-BFGS-B from the reference's six data-driven starts over (m, rho).
    b, s > 0 via exp and |rho| < 1 via tanh, plus a penalty on negative
    minimum variance."""
    from scipy.optimize import minimize

    device = checked_device(device)
    K = np.asarray(strikes, np.float64)
    iv = np.asarray(ivs, np.float64)
    k_np = np.log(K / float(F))
    w_mkt = iv**2 * float(T)
    if weights is None:
        weights = np.exp(-0.5 * (k_np / 0.3) ** 2)   # vega-shaped, ATM peak
    wt = np.asarray(weights, np.float64)
    wt = wt / wt.sum()
    f64 = dict(dtype=torch.float64, device=device)
    k_t, w_t, wt_t = (torch.as_tensor(a, **f64) for a in (k_np, w_mkt, wt))
    # Normalized: raw w is O(1e-2), which leaves L-BFGS-B's line search in
    # its ftol noise.
    w_scale = float(w_mkt.mean())

    def objective(x):
        a, b, rho, m, s = x[0] * w_scale, torch.exp(x[1]), torch.tanh(x[2]), x[3], torch.exp(x[4])
        km = k_t - m
        w_model = a + b * (rho * km + torch.sqrt(km**2 + s**2))
        resid = torch.sqrt(torch.sum(wt_t * ((w_model - w_t) / w_scale) ** 2))
        w_min = a + b * s * torch.sqrt(1.0 - rho**2)
        return resid + 100.0 * torch.clamp_min(-w_min / w_scale, 0.0)

    def f_np(x):
        xt = torch.tensor(np.asarray(x, np.float64), **f64, requires_grad=True)
        v = objective(xt)
        (g,) = torch.autograd.grad(v, xt)
        return float(v.detach()), g.cpu().numpy()

    # Data-driven starts: the raw-SVI wings are asymptotically linear with
    # slopes b (1 +- rho), so the measured wing slopes give (b0, rho0); m0
    # sits at the variance minimum, a0 just under it.
    order = np.argsort(k_np)
    k_s, w_s = k_np[order], w_mkt[order]
    i_min = int(np.argmin(w_s))
    m_seed = float(k_s[i_min])
    w_min_mkt = float(w_s[i_min])
    spread = max(float(k_s[-1] - k_s[0]), 0.2)
    sl_r = max((w_s[-1] - w_min_mkt) / max(k_s[-1] - m_seed, 1e-2), 1e-4)
    sl_l = max((w_s[0] - w_min_mkt) / max(m_seed - k_s[0], 1e-2), 1e-4)
    b_seed = 0.5 * (sl_r + sl_l)
    rho_seed = float(np.clip((sl_r - sl_l) / (sl_r + sl_l), -0.9, 0.9))
    starts = [(0.8 * w_min_mkt, b_seed, rho_seed, m_seed, 0.2 * spread),
              (0.5 * w_min_mkt, b_seed, rho_seed, m_seed, 0.05 * spread),
              (0.8 * w_min_mkt, 2.0 * b_seed, -rho_seed, 0.0, 0.2 * spread),
              (0.0, b_seed, 0.0, 0.0, 0.25 * spread),
              (0.8 * w_min_mkt, b_seed, -0.5, -0.25 * spread, 0.1 * spread),
              (0.8 * w_min_mkt, b_seed, 0.5, 0.25 * spread, 0.1 * spread)]
    best = None
    for a0, b0, r0, m0, s0 in starts[:n_starts]:
        x0 = np.array([a0 / w_scale, np.log(max(b0, 1e-6)), np.arctanh(np.clip(r0, -0.95, 0.95)),
                       m0, np.log(max(s0, 1e-4))])
        res = minimize(f_np, x0, jac=True, method="L-BFGS-B",
                       options={"maxiter": 500, "ftol": 1e-15, "gtol": 1e-13})
        if best is None or res.fun < best.fun:
            best = res
    xb = np.asarray(best.x, np.float64)
    sl = SVISlice(a=float(xb[0]) * w_scale, b=float(np.exp(xb[1])), rho=float(np.tanh(xb[2])),
                  m=float(xb[3]), s=float(np.exp(xb[4]))).validate()
    w_fit = svi_total_variance(torch.as_tensor(k_np), sl).numpy()
    iv_fit = np.sqrt(np.maximum(w_fit, 1e-12) / float(T))
    rmse = float(np.sqrt(np.mean((iv_fit - iv) ** 2)))
    return sl, {"rmse_iv": rmse, "obj": float(best.fun), "success": bool(best.success)}


def _k_grid(k_grid) -> torch.Tensor:
    if k_grid is None:
        return torch.linspace(-1.5, 1.5, 301, dtype=torch.float32)
    return torch.as_tensor(k_grid, dtype=torch.float32)


def _lerp_index(Ts_ext: torch.Tensor, t: torch.Tensor, n: int):
    """(idx, frac, T0, T1) of the linear-in-w bracket [T0, T1] =
    [Ts_ext[idx], Ts_ext[idx+1]] of times t, clamped to the first and last
    brackets."""
    idx = torch.clamp(torch.searchsorted(Ts_ext, t, right=True) - 1, 0, n - 1)
    T0, T1 = Ts_ext[idx], Ts_ext[idx + 1]
    frac = torch.clamp((t - T0) / torch.clamp_min(T1 - T0, 1e-8), 0.0, 1.0)
    return idx, frac, T0, T1


@dataclasses.dataclass(frozen=True)
class SVISurface:
    """Expiry-indexed raw-SVI surface under flat (r, q) carry.

    ``slices`` sorted by expiry; forwards F_i = S0 e^{(r-q) T_i}. Total
    variance interpolates linearly in w at fixed k between expiries, from a
    virtual T = 0 anchor (w = 0) and flat after the last expiry."""
    S0: float
    rate: float
    div_yield: float
    expiries: Tuple[float, ...]
    slices: Tuple[SVISlice, ...]

    def iv(self, K, T) -> torch.Tensor:
        """Black-Scholes implied vol at (K, T), broadcast elementwise, float32
        on the device of the tensor among K and T (the CPU if none is one)."""
        ref = next((a for a in (K, T) if isinstance(a, torch.Tensor)), None)
        dev = ref.device if ref is not None else None
        K, T = (torch.as_tensor(a, dtype=torch.float32, device=dev) for a in (K, T))
        w = self._w_of_kT(self._k(K, T), T)
        return torch.sqrt(torch.clamp_min(w, 1e-10) / torch.clamp_min(T, 1e-8))

    def _k(self, K, T):
        F = self.S0 * torch.exp((self.rate - self.div_yield) * T)
        return torch.log(K / F)

    def _w_all(self, k) -> torch.Tensor:
        """(n_expiries, ...) total variances of every slice at moneyness k."""
        return torch.stack([svi_total_variance(k, sl) for sl in self.slices])

    def _w_of_kT(self, k, T):
        w_all = self._w_all(k)
        T = torch.as_tensor(T, dtype=torch.float32, device=w_all.device)
        if len(self.slices) == 1:
            # one expiry: scaled to the T = 0 anchor before it, flat after
            return w_all[0] * torch.clamp_max(T / np.float32(self.expiries[0]), 1.0)
        Ts = torch.tensor((0.0,) + tuple(self.expiries), dtype=torch.float32,
                          device=w_all.device)
        w_ext = torch.cat([torch.zeros_like(w_all[:1]), w_all])
        k_shape = torch.broadcast_shapes(w_all.shape[1:], T.shape)
        idx, frac, _, _ = _lerp_index(Ts, T.expand(k_shape).contiguous(), len(self.expiries))
        w_ext = w_ext.expand((w_ext.shape[0],) + k_shape)
        lo = torch.gather(w_ext, 0, idx[None])[0]
        hi = torch.gather(w_ext, 0, (idx + 1)[None])[0]
        return lo * (1.0 - frac) + hi * frac

    # -- no-arbitrage diagnostics --------------------------------------------

    def check_butterfly(self, k_grid=None) -> dict:
        """min g(k) per slice; negative means butterfly arbitrage there."""
        k = _k_grid(k_grid)
        mins = [float(torch.min(svi_butterfly_g(k, sl))) for sl in self.slices]
        return {"min_g": mins, "ok": all(m >= -1e-8 for m in mins)}

    def check_calendar(self, k_grid=None) -> dict:
        """min over k of w_{i+1} - w_i per adjacent pair; negative means
        calendar arbitrage (total variance must not fall in T at fixed k)."""
        w_all = self._w_all(_k_grid(k_grid))
        gaps = [float((w_all[i + 1] - w_all[i]).min()) for i in range(len(self.slices) - 1)]
        return {"min_gap": gaps, "ok": all(g >= -1e-8 for g in gaps)}

    # -- simulator adapter -----------------------------------------------------

    def local_vol_fn(self, T_option: float) -> Callable:
        """sigma_loc(S, tau) for the local-vol simulators: Dupire local vol by
        Gatheral's formula (module docstring), float32 on the device of S.
        ``tau`` is the option's time to expiry: calendar time
        t = max(T_option - tau, 1e-6)."""
        n = len(self.slices)
        if n < 2:
            raise ValueError("local_vol_fn needs >= 2 expiries (dw/dT comes "
                             "from the inter-expiry total-variance slope)")

        Ts_ext = torch.tensor((0.0,) + tuple(self.expiries), dtype=torch.float32)

        def fn(S, tau):
            # tau is a scalar; the bracket is found on the host, so a step
            # on the card reads nothing back.
            S = torch.as_tensor(S, dtype=torch.float32)
            t = torch.clamp_min(np.float32(T_option) - torch.as_tensor(tau, dtype=torch.float32)
                                .cpu().reshape(1), 1e-6)
            idx, frac, T0, T1 = _lerp_index(Ts_ext, t, n)
            i, f = int(idx), float(frac)
            t = float(t)
            # the forward in float32, as the reference's
            F_t = self.S0 * np.exp((self.rate - self.div_yield) * np.float32(t))
            k = torch.log(S / float(F_t))
            # The T = 0 anchor: w(k, 0) = 0, and so are its k-derivatives;
            # without it, times before the first expiry would clamp onto the
            # first bracket.
            zero = (torch.zeros_like(k),) * 3
            lo = zero if i == 0 else _w_and_k_derivs(k, self.slices[i - 1])
            hi = _w_and_k_derivs(k, self.slices[i])
            w, w1, w2 = (a * (1.0 - f) + b * f for a, b in zip(lo, hi))
            w = torch.clamp_min(w, 1e-8)
            # dw/dT: the slope of the bracket (clamped positive)
            dwdT = torch.clamp_min((hi[0] - lo[0]) / float(torch.clamp_min(T1 - T0, 1e-8)), 1e-8)
            denom = (1.0 - k * w1 / (2.0 * w) + 0.25 * (-0.25 - 1.0 / w + k**2 / w**2) * w1**2
                     + 0.5 * w2)
            var_loc = dwdT / torch.clamp_min(denom, 1e-4)
            return torch.sqrt(torch.clamp(var_loc, 1e-6, 4.0))

        return fn


@dataclasses.dataclass(frozen=True)
class _PerMaturityLocalVol:
    """Per-maturity adapter factory: Dupire local vol needs calendar time
    t = T - tau, so the closure binds each maturity through
    ``for_maturity(T)`` before it is compiled or simulated."""

    surf: SVISurface

    def for_maturity(self, T: float) -> Callable:
        return self.surf.local_vol_fn(T_option=float(T))

    def __call__(self, S, tau):
        raise TypeError(
            "per-maturity local-vol adapter: bind a maturity first via "
            ".for_maturity(T) (compute_curves does this per bucket)")


@dataclasses.dataclass(frozen=True)
class SVILocalVolEngine:
    """Engine wrapper duck-typed to IVSurfaceModel's two simulator adapters."""

    surf: SVISurface

    def sigma_fn(self, K: float = None, compute_dtype=None):
        # K is unused: Dupire local vol is a property of the surface, not of
        # the contract priced.
        del K, compute_dtype
        return _PerMaturityLocalVol(self.surf)

    def get_sigma_iv(self, K: float, S0: float, tau: float) -> float:
        if K <= 0 or S0 <= 0 or tau <= 0:
            raise ValueError("K, S0, and tau must be positive")
        del S0  # the surface carries its own spot (forward convention)
        return float(self.surf.iv(K, tau))


def fit_svi_from_chain(strikes, expiries, ivs, S0, rate, div_yield: float = 0.0,
                       min_strikes: int = 5, device=None) -> Tuple[SVISurface, List[dict]]:
    """Fit the SVI surface from a flattened option chain (K, T, iv rows, as
    data/market.fetch_option_chain and data/synthetic.synthetic_smile_surface
    return): group rows by expiry, drop non-finite or non-positive rows and
    expiries with fewer than ``min_strikes`` quotes, fit each survivor.
    Needs >= 2 surviving expiries."""
    K = np.asarray(strikes, np.float64)
    T = np.asarray(expiries, np.float64)
    iv = np.asarray(ivs, np.float64)
    ok = np.isfinite(K) & np.isfinite(T) & np.isfinite(iv) & (K > 0) & (T > 0) & (iv > 0)
    K, T, iv = K[ok], T[ok], iv[ok]
    rows_K, rows_iv, Ts = [], [], []
    for t in np.unique(np.round(T, 9)):
        m = np.abs(T - t) < 1e-9
        if int(m.sum()) < min_strikes:
            continue
        Ts.append(float(t))
        rows_K.append(K[m])
        rows_iv.append(iv[m])
    if len(Ts) < 2:
        raise ValueError(f"SVI surface fit needs >= 2 expiries with >= {min_strikes} "
                         f"quotes each; chain has {len(Ts)}")
    return fit_svi_surface(S0, rate, Ts, rows_K, rows_iv, div_yield=div_yield, device=device)


def fit_svi_surface(S0, rate, expiries: Sequence[float], strike_rows: Sequence,
                    iv_rows: Sequence, div_yield: float = 0.0,
                    weights_rows: Optional[Sequence] = None,
                    device=None) -> Tuple[SVISurface, List[dict]]:
    """Fit every expiry's slice and assemble the surface (sorted by T)."""
    order = np.argsort(np.asarray(expiries, np.float64))
    Ts, sls, infos = [], [], []
    for i in order:
        T = float(np.asarray(expiries)[i])
        F = S0 * np.exp((rate - div_yield) * T)
        w_row = None if weights_rows is None else weights_rows[i]
        sl, info = fit_svi_slice(F, T, strike_rows[i], iv_rows[i], weights=w_row, device=device)
        Ts.append(T)
        sls.append(sl)
        infos.append(info)
    surf = SVISurface(S0=float(S0), rate=float(rate), div_yield=float(div_yield),
                      expiries=tuple(Ts), slices=tuple(sls))
    return surf, infos
