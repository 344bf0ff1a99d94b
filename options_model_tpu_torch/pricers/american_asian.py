"""American (Bermudan on the monitoring grid) Asian options by LSM on the
joint (S, running average) state, as options_model_tpu/pricers/
american_asian.py, on the port's path kernels.

The exercise value depends on the running average A_t = mean(S_{t_1..t_k}),
so the continuation regression sees the pair (S_t, A_t), plus Heston's
variance when ``v_paths`` is given. The anchor is the float64 Hull-White
lattice (pricers/fd_asian.py). Conventions match price_asian_mc: the
average runs over t_i = i T / n (not the spot), 'fixed' pays cp (A - K)^+
at exercise, 'floating' cp (S_t - A_t)^+. The Grams run in full float32
(or the paths' float64); this raises if TF32 matmuls are on.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from options_model_tpu_torch.core.config import HestonParams, MCConfig, OptionSpec
from options_model_tpu_torch.core.stats import masked_mean_stderr
from options_model_tpu_torch.ops.engine import checked_device
from options_model_tpu_torch.pricers.american import (_apply_cv, _discount, _oos_split,
                                                      _pair_block, simulate_paths,
                                                      simulated_config)
from options_model_tpu_torch.pricers.american_basket import _centered, _discount_step
from options_model_tpu_torch.pricers.exotics import geometric_asian_bs_price
from options_model_tpu_torch.pricers.regressors import masked_wls_predict_centered

_STRIKE_TYPES = ("fixed", "floating")


def running_average(S_paths: torch.Tensor) -> torch.Tensor:
    """(n, P) running arithmetic average A_k = mean(S_1..S_k) over the
    monitored dates of a (n+1, P) path matrix (row 0, the spot, is not
    monitored)."""
    n = S_paths.shape[0] - 1
    counts = torch.arange(1, n + 1, dtype=S_paths.dtype, device=S_paths.device)[:, None]
    return torch.cumsum(S_paths[1:], dim=0) / counts


def _asian_payoff(S_t, A_t, K, cp, strike_type: str):
    if strike_type == "fixed":
        return torch.clamp_min(cp * (A_t - K), 0.0)
    return torch.clamp_min(cp * (S_t - A_t), 0.0)


def build_asian_basis(S_t: torch.Tensor, A_t: torch.Tensor, scale, itm: torch.Tensor, cp,
                      strike_type: str, v_t: Optional[torch.Tensor] = None,
                      first_date: bool = False) -> torch.Tensor:
    """(P, d) design on the joint (S, A) state: the intercept; u_s = S /
    scale and u_a = A / scale masked-centred, with the full cubic in each
    and u_s u_a; the uncentred intrinsic hinge; with ``v_t`` (Heston) also
    [w, w^2, u_s w] for the masked-centred variance w.

    On the first date (``first_date``) A_t is S_t, and the u_a columns would
    repeat u_s's: the Gram is then singular up to its ridge, and its float32
    solve gives NaN or arbitrary coefficients, depending on rounding (the
    reference's basis, american_asian.py:78-100, there never or wrongly
    exercises). The basis then keeps [1, u_s, u_s^2, u_s^3, hinge], whose
    fitted values the full basis spans exactly."""
    u_s = _centered(S_t / scale, itm)
    hinge = _asian_payoff(S_t, A_t, scale, cp, strike_type) / scale
    if first_date:
        cols = [torch.ones_like(u_s), u_s, u_s * u_s, u_s * u_s * u_s, hinge]
    else:
        u_a = _centered(A_t / scale, itm)
        cols = [torch.ones_like(u_s), u_s, u_a, u_s * u_s, u_a * u_a, u_s * u_a,
                u_s * u_s * u_s, u_a * u_a * u_a, hinge]
    if v_t is not None:
        w = _centered(v_t, itm)
        cols += [w, w * w, u_s * w]
    return torch.stack(cols, dim=-1)


def lsm_asian_backward(S_paths: torch.Tensor, spec: OptionSpec, T, *,
                       strike_type: str = "fixed", exercise_from: int = 1,
                       out_of_sample: bool = False, pair_block: Optional[int] = None,
                       stat_pair_block: Optional[int] = None,
                       v_paths: Optional[torch.Tensor] = None, return_cash: bool = False):
    """LSM backward induction on (n_steps+1, P) paths with the running
    average as the second regression state; every monitoring date from
    ``exercise_from`` (1-based) is an exercise date (``exercise_from =
    n_steps`` gives the European Asian on the same paths). Returns (price,
    stderr), or with ``return_cash`` the discounted per-path cash flows and
    the evaluation mask."""
    if strike_type not in _STRIKE_TYPES:
        raise ValueError(f"strike_type must be one of {_STRIKE_TYPES}")
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("lsm_asian_backward needs full float32 matmuls: set "
                           "torch.backends.cuda.matmul.allow_tf32 = False")
    n_steps = S_paths.shape[0] - 1
    dtype, device = S_paths.dtype, S_paths.device
    disc = _discount_step(spec.rate, T, n_steps, dtype)
    K, cp = spec.strike, spec.cp
    # the strike scales the fixed contract, the spot the floating one
    scale = K if strike_type == "fixed" else S_paths[0, 0]
    A = running_average(S_paths)  # A[t - 1] is the average at date t
    cash = _asian_payoff(S_paths[-1], A[-1], K, cp, strike_type)
    train, eval_mask = _oos_split(cash.shape[0], out_of_sample, pair_block, dtype, device)
    if train is None:
        train = eval_mask
    for t in range(n_steps - 1, 0, -1):
        cash = cash * disc
        S_t, A_t = S_paths[t], A[t - 1]
        immediate = _asian_payoff(S_t, A_t, K, cp, strike_type)
        itm = (immediate > 0).to(dtype) * train
        X = build_asian_basis(S_t, A_t, scale, itm, cp, strike_type,
                              None if v_paths is None else v_paths[t], first_date=t == 1)
        continuation = masked_wls_predict_centered(X, cash, itm)
        exercise = (immediate > continuation) & (immediate > 0) & (t >= exercise_from)
        cash = torch.where(exercise, immediate, cash)
    cash = cash * disc
    if return_cash:
        return cash, eval_mask
    price, stderr, _ = masked_mean_stderr(cash, eval_mask, stat_pair_block)
    return price, stderr


def price_american_asian(generator: torch.Generator, S0, T, spec: OptionSpec,
                         mc: Optional[MCConfig] = None, model: str = "gbm", *,
                         strike_type: str = "fixed", heston: Optional[HestonParams] = None,
                         merton=None, bates=None, vg=None, sigma_fn=None,
                         out_of_sample: bool = False, control_variate: str = "auto",
                         cv_beta: str = "opt",
                         device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """American fixed- or floating-strike Asian option: (price, stderr).
    ``mc.n_steps`` is both the monitoring and the exercise grid. Heston
    regresses on (S, A, v), its variance from the same paths kernel.
    control_variate 'auto' | 'on' | 'off': the European geometric Asian on
    the same paths, centred at its closed form and composed at ``cv_beta``
    ('opt' the pair-mean optimal beta, 'one'); exact only under GBM and a
    fixed strike ('on' raises elsewhere, 'auto' skips)."""
    if strike_type not in _STRIKE_TYPES:
        raise ValueError(f"strike_type must be one of {_STRIKE_TYPES}")
    if control_variate not in ("auto", "on", "off"):
        raise ValueError("control_variate must be 'auto', 'on' or 'off'")
    cv_ok = model == "gbm" and strike_type == "fixed"
    if control_variate == "on" and not cv_ok:
        raise ValueError("control_variate='on' requires model='gbm' and strike_type='fixed' "
                         "(the geometric closed form is exact only there)")
    device = checked_device(device)
    mc = mc if mc is not None else MCConfig(n_paths=1 << 17, n_steps=25, path_block=4096)
    want_v = model == "heston"
    out = simulate_paths(generator, S0, T, simulated_config(mc, model), model,
                         sigma=spec.sigma, rate=spec.rate, heston=heston, merton=merton,
                         bates=bates, vg=vg, sigma_fn=sigma_fn,
                         div_yield=spec.div_yield, return_variance=want_v, device=device)
    S, v_paths = out if want_v else (out, None)
    pb_unit = _pair_block(mc, model)
    pb = pb_unit if mc.antithetic else None
    kw = dict(strike_type=strike_type, out_of_sample=out_of_sample, pair_block=pb_unit,
              v_paths=v_paths)
    if not (cv_ok and control_variate != "off"):
        return lsm_asian_backward(S, spec, T, stat_pair_block=pb, **kw)
    cash, eval_mask = lsm_asian_backward(S, spec, T, return_cash=True, **kw)
    geo = torch.exp(torch.log(S[1:]).mean(dim=0))
    geo_pay = torch.clamp_min(spec.cp * (geo - spec.strike), 0.0)
    geo_cf = geometric_asian_bs_price(S0, spec.strike, T, spec.rate, spec.sigma, mc.n_steps,
                                      spec.cp, spec.div_yield, device=device)
    adj = geo_cf.to(cash.dtype) - _discount(spec.rate, T) * geo_pay  # E[adj] = 0 exactly
    stat = _apply_cv(cash, adj, cv_beta, eval_mask, pair_block=pb)
    price, stderr, _ = masked_mean_stderr(stat, eval_mask, pb)
    return price, stderr
