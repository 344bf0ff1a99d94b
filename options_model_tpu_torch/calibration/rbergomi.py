"""Rough Bergomi calibration: fit (xi0, eta, H) to an IV surface at a fixed
rho, as options_model_tpu/calibration/rbergomi.py.

No characteristic function exists for H < 1/2, so the stages follow how
rBergomi is fitted in practice (Bayer-Friz-Gatheral 2016, section 5):
1. xi0 from the short-expiry ATM implied variance (the forward variance
   curve is flat at xi0);
2. (H, eta) from the ATM-skew term structure psi(T) ~ C(H) rho eta
   T^{H-1/2}, C(H) = sqrt(2H) / ((H+1/2)(H+3/2)): a log-log fit of the
   per-expiry tangent skews (``_atm_skews``: a weighted quadratic in
   log-moneyness over a T-adaptive ATM window) gives H from the slope and
   eta from the level; rho is supplied (on one surface rho and eta enter
   the skew only through their product);
2.5. an H-profile scan, eta re-implied from the skew level at each H, that
   lands the polish in the right basin;
3. a Nelder-Mead polish on (log xi0, log eta, logit-like H) of the
   vega-weighted IV RMSE plus an ATM-skew term-structure penalty, the model
   IVs priced by the hybrid scheme under common random numbers: one
   fixed-seed terminal-CV simulation an expiry (``_expiry_ivs``: one launch of
   the fused kernel in its CV mode, the conditional-Black control variate
   per strike at the pair-mean optimal beta, then implied_vol), so the MC
   objective is deterministic.

The synthetic round trip (``create_synthetic_rbergomi_surface``) prices
with another seed and twice the paths and steps of the calibrator's
engine, so recovery errors measure the fit, not shared noise. The engine
runs on ``device`` (the card by default); the stages and the optimizer run
on the host in float64 NumPy.
"""

from __future__ import annotations

import logging
from typing import Tuple

import numpy as np
import torch

from options_model_tpu_torch.core.config import RBergomiParams
from options_model_tpu_torch.ops.cuda_heston import PATH_TILE
from options_model_tpu_torch.ops.engine import checked_device
from options_model_tpu_torch.ops.philox import philox4x32

_log = logging.getLogger("options_model_tpu_torch.calibration")


def _expiry_seed(seed: int, i: int) -> int:
    """The 64-bit stream seed of expiry ``i`` under evaluation seed ``seed``
    (the port's fold_in: one Philox block keyed by the seed at counter (i,
    0, 0, 6)), fixed across every candidate of a calibration (CRN)."""
    w0, w1, _, _ = philox4x32(torch.tensor(i), 0, torch.tensor(0), 6,
                              seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF)
    return int(w0) | (int(w1) << 32)


def _pair_rows(x: torch.Tensor) -> torch.Tensor:
    """(rows, P) -> (rows, P/2) antithetic pair means over PATH_TILE tiles."""
    n, p = x.shape
    return x.reshape(n, p // PATH_TILE, 2, PATH_TILE // 2).mean(dim=2).reshape(n, -1)


def _expiry_ivs(seed: int, S0, rate, T, params: RBergomiParams, n_steps: int, n_paths: int,
                Ks, device) -> torch.Tensor:
    """One expiry's per-strike IVs on ``device``: one terminal-CV
    simulation (models/rbergomi.terminal_cv_core) serves every strike; put
    prices with the conditional-Black control variate at each strike's
    pair-mean optimal beta (core/stats.optimal_cv_beta, per row), then
    implied_vol."""
    from options_model_tpu_torch.models.rbergomi import terminal_cv_core
    from options_model_tpu_torch.pricers.blackscholes import bs_price, implied_vol

    S_T, G_T = terminal_cv_core(seed, S0, rate, T, params, n_steps, n_paths, True, 0, device)
    f = np.float32
    disc = float(np.exp(-f(rate) * f(T)))
    K = torch.as_tensor(np.asarray(Ks, np.float32), device=S_T.device)
    pay = disc * torch.clamp_min(K[:, None] - S_T[None, :], 0.0)
    cv_pay = disc * torch.clamp_min(K[:, None] - G_T[None, :], 0.0)
    cv_mean = bs_price(S0, K, T, rate, float(np.sqrt(f(params.xi0))), -1.0, device=S_T.device)
    adj = _pair_rows(cv_pay - cv_mean[:, None])
    pay = _pair_rows(pay)
    ma, mp = adj.mean(dim=1, keepdim=True), pay.mean(dim=1, keepdim=True)
    b = -((pay - mp) * (adj - ma)).mean(dim=1) / torch.clamp_min(
        ((adj - ma) ** 2).mean(dim=1), 1e-12)
    prices = (pay + b[:, None] * adj).mean(dim=1)
    return implied_vol(prices, S0, K, T, rate, cp=-1.0, device=S_T.device)


def _surface_ivs(seed: int, params: RBergomiParams, S0, rate, strikes, expiries, n_paths: int,
                 n_steps_per_year: int, min_steps: int = 32, device=None) -> np.ndarray:
    """(n_expiry, n_strike) model IVs by MC with the conditional-Black CV:
    steps scale with T (n_steps = max(min_steps, round(n_steps_per_year
    T))), expiry i on the stream seed _expiry_seed(seed, i), n_paths
    rounded up to whole PATH_TILE tiles."""
    device = checked_device(device)
    out = np.zeros((len(expiries), len(strikes)))
    for i, T in enumerate(expiries):
        n_steps = max(min_steps, int(round(n_steps_per_year * float(T))))
        ivs = _expiry_ivs(_expiry_seed(seed, i), S0, rate, float(T), params, n_steps, n_paths,
                          strikes, device)
        out[i] = ivs.cpu().numpy()
    return out


def create_synthetic_rbergomi_surface(
        params: RBergomiParams, S0: float = 100.0, rate: float = 0.05, strikes=None,
        expiries=None, noise_std: float = 0.0, seed: int = 0, n_paths: int = 1 << 17,
        n_steps_per_year: int = 128, device=None
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(strikes, expiries, ivs) from known true params, the round-trip
    oracle: a denser grid and twice the paths of the default engine on an
    independent seed (seed + 7919), with optional Gaussian IV noise from
    numpy's default_rng(seed)."""
    if strikes is None:
        strikes = np.array([85.0, 92.5, 100.0, 107.5, 115.0])
    if expiries is None:
        expiries = np.array([0.1, 0.25, 0.5, 1.0])
    ivs = _surface_ivs(seed + 7919, params, S0, rate, strikes, expiries, n_paths,
                       n_steps_per_year, device=device)
    if noise_std > 0:
        rng = np.random.default_rng(seed)
        ivs = ivs + noise_std * rng.standard_normal(ivs.shape)
    return np.asarray(strikes, float), np.asarray(expiries, float), ivs


def _atm_skews(strikes, expiries, ivs, S0) -> np.ndarray:
    """Per-expiry tangent skew d(iv)/dk at k = 0: the linear coefficient of
    a weighted quadratic fit in log-moneyness (the quadratic term absorbs
    the smile's curvature), the weights Gaussian with a scale of 1.5 ATM
    sigmas (floored at 5% moneyness)."""
    strikes = np.asarray(strikes, float)
    k = np.log(strikes / float(S0))
    i_atm = int(np.argmin(np.abs(k)))
    skews = np.zeros(len(expiries))
    for i in range(len(expiries)):
        scale = max(0.05, 1.5 * float(ivs[i, i_atm]) * float(np.sqrt(expiries[i])))
        w = np.exp(-0.5 * (k / scale) ** 2)
        A = np.stack([np.ones_like(k), k, k * k], axis=1)
        Aw = A * w[:, None]
        beta, *_ = np.linalg.lstsq(Aw, ivs[i] * w, rcond=None)
        skews[i] = beta[1]
    return skews


def _skew_prefactor(H: float) -> float:
    """C(H) in psi(T) ~ C(H) rho eta T^{H-1/2} (the BFG short-time limit)."""
    return float(np.sqrt(2.0 * H) / ((H + 0.5) * (H + 1.5)))


def calibrate_rbergomi_to_data(strikes, expiries, ivs, S0, rate, *, rho: float = -0.7,
                               polish: bool = True, seed: int = 0, n_paths: int = 1 << 16,
                               n_steps_per_year: int = 96, max_polish_evals: int = 160,
                               skew_weight: float = 1.0, device=None
                               ) -> Tuple[RBergomiParams, dict]:
    """Fit (xi0, eta, H) at fixed rho (the module docstring's stages), the
    engine on ``device`` (the card by default). Returns (params, summary):
    the stage estimates, the vega-weighted IV RMSE of the seed and the
    polish, the skews, and the final RMSE on an independent seed
    (``error``). ``skew_weight`` scales the ATM-skew penalty (0 disables
    it), in IV units at 5% moneyness."""
    from scipy.optimize import minimize

    from options_model_tpu_torch.pricers.blackscholes import bs_vega

    strikes = np.asarray(strikes, float)
    expiries = np.asarray(expiries, float)
    ivs = np.asarray(ivs, float)
    if ivs.shape != (len(expiries), len(strikes)):
        raise ValueError(f"ivs must be (n_expiry, n_strike) = "
                         f"({len(expiries)}, {len(strikes)}), got {ivs.shape}")
    if abs(rho) >= 1.0 or rho == 0.0:
        raise ValueError("rho must be in (-1, 0) or (0, 1): the skew level "
                         "identifies eta only through the product rho*eta")
    device = checked_device(device)

    # stage 1: xi0 from the short-expiry ATM variance level
    i_atm = int(np.argmin(np.abs(np.log(strikes / S0))))
    order = np.argsort(expiries)
    xi0_seed = float(ivs[order[0], i_atm] ** 2)

    # stage 2: (H, eta) from the ATM-skew term structure
    skews = _atm_skews(strikes, expiries, ivs, S0)
    ok = np.sign(skews) == np.sign(rho)
    if ok.sum() >= 2:
        Ts, ss = expiries[ok], np.abs(skews[ok])
        slope, level = np.polyfit(np.log(Ts), np.log(ss), 1)
        H_seed = float(np.clip(slope + 0.5, 0.03, 0.5))
        eta_seed = float(np.clip(
            np.exp(level) / (_skew_prefactor(H_seed) * abs(rho)), 0.2, 5.0))
    else:
        # skews inconsistent with rho's sign (a flat or noisy surface)
        H_seed, eta_seed = 0.2, 1.0
    summary = {"xi0_seed": xi0_seed, "H_seed": H_seed, "eta_seed": eta_seed,
               "atm_skews": skews.tolist(), "rho": float(rho)}
    params = RBergomiParams(H=H_seed, eta=eta_seed, rho=rho, xi0=xi0_seed).validate()

    # vega weights on the market quotes, float32 as the reference's
    Kg, Tg = np.meshgrid(strikes, expiries)
    vega = bs_vega(S0, Kg, Tg, rate, ivs, device="cpu").numpy().astype(np.float64)
    w = np.maximum(vega / 100.0, 0.01)
    w = w / w.sum()

    def surface_of(p: RBergomiParams, eval_seed: int) -> np.ndarray:
        return _surface_ivs(eval_seed, p, S0, rate, strikes, expiries, n_paths,
                            n_steps_per_year, device=device)

    def rmse_of(model: np.ndarray) -> float:
        return float(np.sqrt(np.sum(w * (model - ivs) ** 2)))

    def objective_of(model: np.ndarray) -> float:
        pen = 0.0
        if skew_weight > 0:
            mskews = _atm_skews(strikes, expiries, model, S0)
            pen = skew_weight * 0.05 * float(np.sqrt(np.mean((mskews - skews) ** 2)))
        return rmse_of(model) + pen

    seed_surface = surface_of(params, seed)
    summary["seed_rmse"] = rmse_of(seed_surface)
    seed_obj = objective_of(seed_surface)
    n_evals = 1

    if polish:
        # stage 2.5: the H profile, eta re-implied from the skew level
        if ok.sum() >= 2:
            logT = np.log(expiries[ok])
            logs = np.log(np.abs(skews[ok]))
            best = (seed_obj, params)
            for H_try in (0.05, 0.08, 0.12, 0.17, 0.25, 0.35):
                level = float(np.mean(logs - (H_try - 0.5) * logT))
                eta_try = float(np.clip(
                    np.exp(level) / (_skew_prefactor(H_try) * abs(rho)), 0.2, 5.0))
                cand = RBergomiParams(H=H_try, eta=eta_try, rho=rho, xi0=xi0_seed).validate()
                o = objective_of(surface_of(cand, seed))
                n_evals += 1
                if o < best[0]:
                    best = (o, cand)
            seed_obj, params = best
            summary["profile_H"] = params.H
            summary["profile_eta"] = params.eta

        # stage 3: CRN Nelder-Mead on (log xi0, log eta, logit-like H)
        def unpack(x):
            return RBergomiParams(H=float(0.02 + 0.48 / (1.0 + np.exp(-x[2]))),
                                  eta=float(np.exp(x[1])), rho=rho, xi0=float(np.exp(x[0])))

        def obj(x):
            return objective_of(surface_of(unpack(x), seed))

        x0 = np.array([np.log(params.xi0), np.log(params.eta),
                       -np.log(0.48 / (params.H - 0.02) - 1.0)])
        res = minimize(obj, x0, method="Nelder-Mead",
                       options={"maxfev": max_polish_evals, "xatol": 1e-3, "fatol": 1e-6})
        cand = unpack(res.x).validate()
        cand_surface = surface_of(cand, seed)
        cand_obj = objective_of(cand_surface)
        n_evals += int(res.nfev) + 1
        # accept the best on the full objective
        if cand_obj <= seed_obj:
            params = cand
            summary["polish_rmse"] = rmse_of(cand_surface)
        else:
            summary["polish_rmse"] = rmse_of(surface_of(params, seed))
            n_evals += 1
            _log.warning("rbergomi polish did not improve (%.2e -> %.2e); keeping the "
                         "stage-2.5 profile winner", seed_obj, cand_obj)
        summary["polish_evals"] = int(res.nfev)
    # the final RMSE on an independent seed (not the CRN objective's own noise)
    summary["error"] = rmse_of(surface_of(params, seed + 104729))
    summary["surface_evals"] = n_evals + 1
    summary["fitted"] = {"H": params.H, "eta": params.eta, "xi0": params.xi0}
    return params, summary
