"""American option pricing by Longstaff-Schwartz Monte Carlo, as
options_model_tpu/pricers/american.py: the polynomial regressor and the
shared continuation network (NN-LSM) under GBM, Heston (Euler or QE-M),
Merton, Bates (Heston, Euler or QE-M, times the jump overlay), Variance
Gamma and SABR (the forward simulated, converted to the spot on the
exercise grid, with the (S, alpha) basis); and under local vol, over a
compiled table or a bare ``sigma_fn`` (the IV-surface network's adapter,
SVI's Dupire local vol). Local vol and SABR have no control-variate leg
(SABR's Hagan form is only O(T)-accurate, so the reference prices it
without one).

Paths come from the Philox path kernels (csrc/, or their plain versions on
the CPU) in the flat (n_steps+1, n_paths) layout. The backward induction is
a Python loop over exercise dates; each date is a masked weighted least
squares on the centered basis, all on the device and with no host read-back
until the caller asks for the price. Under the jump families the basis's
clamp at +-6 standardized units keeps the jump outliers from bending a
high-degree fit (build_centered_basis). The NN-LSM trains one continuation
MLP over all (date, path) states (pricers/regressors.fit_continuation_mlp)
and reads the stopping policy off its predictions. The dispatcher
``price_american`` adds the same-path European control variate (COS leg
under Heston, Bates and VG, the jump-count series under Merton, BS under
GBM),
common-path Richardson extrapolation, or the European terminal sampler, as
in the reference.

Randomness: one ``torch.Generator`` fixes a price. The simulation draws the
first 64-bit seed from it; the NN-LSM's fit draws the next one, and each
policy iteration trains on a device generator seeded from (that seed,
iteration).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from options_model_tpu_torch._unported import not_ported
from options_model_tpu_torch.core.config import (BatesParams, HestonParams, LSMConfig,
                                                  MCConfig, MertonParams, OptionSpec,
                                                  SABRParams, VGParams)
from options_model_tpu_torch.core.payoff import vanilla_payoff
from options_model_tpu_torch.core.stats import (cashflow_statistics, masked_mean_stderr,
                                                 optimal_cv_beta)
from options_model_tpu_torch.models.bates import simulate_bates
from options_model_tpu_torch.models.blocks import round_up
from options_model_tpu_torch.models.gbm import simulate_gbm
from options_model_tpu_torch.models.heston import effective_bs_sigma, simulate_heston
from options_model_tpu_torch.models.localvol import simulate_local_vol
from options_model_tpu_torch.models.merton import merton_price, simulate_merton
from options_model_tpu_torch.models.sabr import simulate_sabr
from options_model_tpu_torch.models.vg import simulate_vg
from options_model_tpu_torch.ops.cuda_heston import PATH_TILE
from options_model_tpu_torch.ops.engine import resolve_device, resolve_engine
from options_model_tpu_torch.ops.lsm_basis import regression_features
from options_model_tpu_torch.ops.philox import philox4x32, seed_from_generator
from options_model_tpu_torch.pricers.blackscholes import bs_price
from options_model_tpu_torch.pricers.regressors import (fit_continuation_mlp,
                                                        masked_wls_predict_centered,
                                                        mlp_predict)
from options_model_tpu_torch.utils.profiling import span

# Standardized-covariate clamp for the regression basis (build_centered_basis).
_BASIS_CLAMP = 6.0


MODELS = ("gbm", "heston", "localvol", "merton", "bates", "vg", "sabr")


def _check_slice(model: str, lsm: Optional[LSMConfig] = None, axis_name=None) -> None:
    """Raise for what this port does not carry yet: the models outside
    MODELS (rBergomi) and the path-sharded LSM; the VG and SABR brackets
    raise in pricers/dual.py. Local vol runs under a compiled table or a
    bare ``sigma_fn``, as in the reference; models/localvol.simulate_local_vol
    raises ValueError with neither."""
    if model not in MODELS:
        raise not_ported(f"model={model!r}", "pricers.american.simulate_paths")
    if lsm is not None and lsm.regressor not in ("poly", "nn"):
        raise ValueError(f"regressor must be 'poly' or 'nn', got {lsm.regressor!r}")
    if axis_name is not None:
        raise not_ported("axis_name (path-sharded LSM)",
                         "pricers.american.lsm_poly_backward")


def _discount(rate, tau):
    """exp(-rate tau) in float32 arithmetic, as the reference computes it: a
    Python float for numbers, and a float32 tensor in the autograd graph
    when ``rate`` or ``tau`` is a tensor, so that d/dr and d/dT flow through
    the discount as through the reference's traced value."""
    if isinstance(rate, torch.Tensor) or isinstance(tau, torch.Tensor):
        return torch.exp(-torch.as_tensor(rate, dtype=torch.float32)
                         * torch.as_tensor(tau, dtype=torch.float32))
    return float(np.exp(-np.float32(rate) * np.float32(tau)))


def sabr_spot_paths(F_paths: torch.Tensor, drift, T) -> torch.Tensor:
    """The spot on the exercise grid from SABR's T-forward paths (n_steps+1,
    n_paths): S_t = F_t e^{drift (t - T)} on linspace(0, T, n_steps+1), in
    F's dtype, as the reference converts them
    (options_model_tpu/pricers/american.py:250-258)."""
    dtype, device = F_paths.dtype, F_paths.device
    Tf = float(np.float32(T))
    mu = torch.tensor(float(np.float32(drift)), dtype=dtype, device=device)
    t_grid = torch.linspace(0.0, Tf, F_paths.shape[0], dtype=dtype, device=device)
    return F_paths * torch.exp(mu * (t_grid - Tf))[:, None]


def simulate_seeded(seed: int, first_tile: int, S0, T, cfg: MCConfig, model: str, *,
                    sigma=None, drift=0.0, heston: Optional[HestonParams] = None,
                    merton: Optional[MertonParams] = None,
                    bates: Optional[BatesParams] = None, vg: Optional[VGParams] = None,
                    sabr: Optional[SABRParams] = None, sigma_fn=None,
                    heston_scheme: str = "euler", localvol_table=None,
                    return_variance: bool = False, device=None):
    """The path kernels' dispatch on an explicit (seed, first_tile): tiles
    [first_tile, first_tile + n_tiles) of that seed's stream. ``drift`` is
    the simulated growth rate (rate - q). Bates is the Heston kernel
    (``heston_scheme``) with the jump overlay multiplied in on the same
    seed and tiles. SABR simulates the T-forward from F0 = S0 e^{drift T}
    and returns the spot (sabr_spot_paths); its ``return_variance`` is the
    alpha paths, the (S, alpha) basis's feed."""
    _check_slice(model)
    if return_variance and model not in ("heston", "bates", "sabr"):
        raise ValueError("return_variance is a Heston/Bates/SABR feature")
    if model == "gbm":
        if sigma is None:
            raise ValueError("sigma is required for model='gbm'")
        return simulate_gbm(seed, S0, drift, sigma, T, cfg, first_tile=first_tile,
                            device=device)
    if model == "localvol":
        return simulate_local_vol(seed, S0, drift, T, cfg, table=localvol_table,
                                  sigma_fn=sigma_fn, first_tile=first_tile, device=device)
    if model == "merton":
        if merton is None:
            raise ValueError("merton params required for model='merton'")
        return simulate_merton(seed, S0, drift, T, merton, cfg, first_tile=first_tile,
                               device=device)
    if model == "bates":
        if bates is None:
            raise ValueError("bates params required for model='bates'")
        return simulate_bates(seed, S0, drift, T, bates, cfg, return_variance=return_variance,
                              first_tile=first_tile, scheme=heston_scheme, device=device)
    if model == "vg":
        if vg is None:
            raise ValueError("vg params required for model='vg'")
        return simulate_vg(seed, S0, drift, T, vg, cfg, first_tile=first_tile, device=device)
    if model == "sabr":
        if sabr is None:
            raise ValueError("sabr params required for model='sabr'")
        f = np.float32
        F0 = float(f(S0) * np.exp(f(drift) * f(T)))
        out = simulate_sabr(seed, F0, T, sabr, cfg, return_paths=True,
                            return_alpha=return_variance, first_tile=first_tile, device=device)
        F_paths, a_paths = out if return_variance else (out, None)
        S_paths = sabr_spot_paths(F_paths, drift, T)
        return (S_paths, a_paths) if return_variance else S_paths
    if heston is None:
        raise ValueError("heston params required for model='heston'")
    return simulate_heston(seed, S0, drift, T, heston, cfg, return_paths=True,
                           return_variance=return_variance, first_tile=first_tile,
                           scheme=heston_scheme, device=device)


def simulate_paths(generator: torch.Generator, S0, T, cfg: MCConfig,
                   model: str = "gbm", *, sigma=None, rate=0.0,
                   heston: Optional[HestonParams] = None,
                   merton: Optional[MertonParams] = None,
                   bates: Optional[BatesParams] = None, vg: Optional[VGParams] = None,
                   sabr: Optional[SABRParams] = None, sigma_fn=None,
                   engine: str = "auto", heston_scheme: str = "euler",
                   localvol_table=None, div_yield=0.0, return_variance: bool = False,
                   layout: str = "flat", device=None):
    """Full path matrix (n_steps+1, n_pad) [and, for Heston or Bates with
    ``return_variance``, the variance matrix, for SABR the alpha matrix]
    from the path kernels: GBM, Heston (``heston_scheme`` "euler" or "qe"),
    Merton, Bates (Heston times the jump overlay), VG, SABR (the spot from
    its forward, simulate_seeded) or local vol over a compiled Chebyshev
    ``localvol_table`` (surface/cheb.compile_localvol_table; it takes
    precedence) or under a bare ``sigma_fn(S, tau)``.

    One 64-bit kernel seed is drawn from ``generator``. ``div_yield``: the
    simulated drift is rate - q; discounting stays the pricer's job."""
    if layout != "flat":
        raise not_ported(f"layout={layout!r}", "ops.layout")
    device = resolve_device(device)
    resolve_engine(engine, device)
    return simulate_seeded(seed_from_generator(generator), 0, S0, T, cfg, model,
                           sigma=sigma, drift=rate - div_yield, heston=heston,
                           merton=merton, bates=bates, vg=vg, sabr=sabr, sigma_fn=sigma_fn,
                           heston_scheme=heston_scheme, localvol_table=localvol_table,
                           return_variance=return_variance, device=device)


def _cv_adjustment(S_paths: torch.Tensor, spec: OptionSpec, T,
                   heston: Optional[HestonParams] = None,
                   model: str = "gbm", merton: Optional[MertonParams] = None,
                   bates: Optional[BatesParams] = None,
                   vg: Optional[VGParams] = None) -> torch.Tensor:
    """Per-path beta=1 control-variate adjustment: the European closed form
    minus the discounted terminal payoff of the same path.

    The closed-form leg must match the simulated dynamics: COS under Heston,
    Bates and VG (float32 at its default terms, as the reference calls it:
    a ~2e-3 price floor enters the estimate), the jump-count series under
    Merton, BS under GBM. A BS leg on
    Heston paths has E[BS - EU_heston] != 0 and biases the price by that gap
    (~130% in the reference's measurement)."""
    S_init = S_paths[0, 0]
    pay_T = vanilla_payoff(S_paths[-1], spec.strike, spec.cp) * _discount(spec.rate, T)
    if model == "heston":
        if heston is None:
            raise ValueError("model='heston' control variate needs heston "
                             "params for the COS leg")
        from options_model_tpu_torch.calibration.charfn import heston_cos_price
        eu = heston_cos_price(S_init, spec.strike, T, spec.rate, heston,
                              cp=spec.cp, q=spec.div_yield)
    elif model == "merton":
        if merton is None:
            raise ValueError("model='merton' control variate needs merton "
                             "params for the jump-series leg")
        eu = merton_price(S_init, spec.strike, T, spec.rate, merton, cp=spec.cp,
                          q=spec.div_yield, dtype=S_paths.dtype)
    elif model == "bates":
        if bates is None:
            raise ValueError("model='bates' control variate needs bates "
                             "params for the COS leg")
        from options_model_tpu_torch.calibration.charfn import bates_cos_price
        eu = bates_cos_price(S_init, spec.strike, T, spec.rate, bates, cp=spec.cp,
                             q=spec.div_yield)
    elif model == "vg":
        if vg is None:
            raise ValueError("model='vg' control variate needs vg params for the COS leg")
        from options_model_tpu_torch.calibration.charfn import vg_cos_price
        eu = vg_cos_price(S_init, spec.strike, T, spec.rate, vg, cp=spec.cp, q=spec.div_yield)
    elif model == "gbm":
        eu = bs_price(S_init, spec.strike, T, spec.rate, spec.sigma, spec.cp,
                      q=spec.div_yield)
    else:
        raise not_ported(f"control variate for model={model!r}",
                         "pricers.american._cv_adjustment")
    return eu - pay_T


def _apply_cv(stat: torch.Tensor, adj: torch.Tensor, cv_beta: str,
              mask=None, pair_block=None) -> torch.Tensor:
    """stat + beta * adj; 'opt' estimates the variance-minimizing beta over
    antithetic pair means, 'one' is the fixed beta = 1."""
    if cv_beta == "opt":
        return stat + optimal_cv_beta(stat, adj, mask, pair_block) * adj
    return stat + adj


def _pair_block(mc: MCConfig, model: str) -> int:
    """Antithetic-pair granularity of the simulated paths: the path kernels
    (and their plain versions) mirror within PATH_TILE, the stderr and the
    out-of-sample split within mc.path_block, so the unit is their lcm (a
    block that merely exceeds the tile can still cut a tile mid-mirror)."""
    _check_slice(model)
    return math.lcm(mc.path_block, PATH_TILE)


def simulated_config(mc: MCConfig, model: str) -> MCConfig:
    """``mc`` with n_paths rounded up to whole _pair_block units: the width
    the pricers simulate, so that pair means, the stderr and the out-of-
    sample split tile it. Where path_block divides PATH_TILE or is a
    multiple of it, this is the width the kernels round to anyway (the same
    tiles, the same paths); otherwise it is the same estimator on more
    paths."""
    return dataclasses.replace(mc, n_paths=round_up(mc.n_paths, _pair_block(mc, model)))


def build_centered_basis(S_t: torch.Tensor, K, itm: torch.Tensor,
                         poly_degree: int, v_t: Optional[torch.Tensor] = None,
                         return_stats: bool = False, v_degree: int = 2):
    """[1, u, ..., u^degree, (x-1)^+] with u = S/K centered and scaled
    against the masked (ITM) measure before taking powers, which keeps the
    Gram's condition number O(10) in f32.

    ``v_t`` (Heston): appends [w, w^2, u w] with w the masked-centered
    variance, and with ``v_degree=3`` also [w^3, u^2 w, u w^2]; the
    continuation value is a function of the state (S, v). u and w are
    clamped to +-_BASIS_CLAMP standardized units before the powers.
    ``return_stats`` also returns the affine maps (x_mean, x_rstd[, v_mean,
    v_rstd])."""
    x = S_t / K
    wsum = torch.clamp_min(itm.sum(), 1.0)
    x_mean = (x * itm).sum() / wsum
    x_var = ((x - x_mean) ** 2 * itm).sum() / wsum
    x_rstd = torch.rsqrt(torch.clamp_min(x_var, 1e-12))
    u = torch.clamp((x - x_mean) * x_rstd, -_BASIS_CLAMP, _BASIS_CLAMP)
    cols = [u**d for d in range(poly_degree + 1)]
    cols.append(torch.clamp_min(x - 1.0, 0.0))
    if v_t is not None:
        v_mean = (v_t * itm).sum() / wsum
        v_var = ((v_t - v_mean) ** 2 * itm).sum() / wsum
        v_rstd = torch.rsqrt(torch.clamp_min(v_var, 1e-12))
        w = torch.clamp((v_t - v_mean) * v_rstd, -_BASIS_CLAMP, _BASIS_CLAMP)
        cols += [w, w**2, u * w]
        if v_degree >= 3:
            cols += [w**3, u * u * w, u * w * w]
    X = torch.stack(cols, dim=-1)
    if return_stats:
        if v_t is not None:
            return X, (x_mean, x_rstd, v_mean, v_rstd)
        return X, (x_mean, x_rstd)
    return X


def oos_masks(n_paths: int, pair_block: int, dtype=torch.float32, device=None):
    """(train_mask, eval_mask) of the out-of-sample estimator: alternating
    whole pair blocks, so no antithetic mirror of a training path lands in
    the evaluation set."""
    block_id = torch.arange(n_paths, device=device) // pair_block
    train = (block_id % 2 == 0).to(dtype)
    return train, 1.0 - train


def _oos_split(n_paths: int, out_of_sample: bool, pair_block: Optional[int], dtype, device):
    """(train_mask, eval_mask) of the LSM estimators: without
    ``out_of_sample`` no training mask (None) and every path evaluated."""
    if not out_of_sample:
        return None, torch.ones(n_paths, dtype=dtype, device=device)
    if pair_block is None:
        raise ValueError("out_of_sample=True requires pair_block (the simulator's "
                         "mirror granularity) so the split respects antithetic pairs")
    if n_paths < 2 * pair_block:
        raise ValueError("out_of_sample needs at least two path blocks")
    return oos_masks(n_paths, pair_block, dtype, device)


def lsm_poly_backward(S_paths: torch.Tensor, spec: OptionSpec, T,
                      axis_name=None, poly_degree: int = 3, v_degree: int = 2,
                      out_of_sample: bool = False,
                      pair_block: Optional[int] = None,
                      stat_pair_block: Optional[int] = None,
                      return_cash: bool = False, exercise_stride: int = 1,
                      v_paths: Optional[torch.Tensor] = None):
    """Longstaff-Schwartz backward induction with a masked WLS regression
    per exercise date, on the flat path matrix S (n_steps+1, n_paths) [and
    v likewise]. Returns (price, stderr) [, (cash, eval_mask)].

    ``out_of_sample`` fits on alternating ``pair_block`` blocks and prices
    on the others. ``exercise_stride`` > 1 regresses and exercises only on
    every stride-th date (the coarse Bermudan level of the Richardson
    extrapolation), still discounting every step.

    The Grams must run in full float32: TF32 keeps ~3 digits and breaks the
    regression (the reference saw a 40% price error from bf16 passes), so
    this raises if TF32 matmuls are enabled."""
    if axis_name is not None:
        raise not_ported("axis_name (path-sharded LSM)",
                         "pricers.american.lsm_poly_backward")
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("lsm_poly_backward needs full float32 matmuls: set "
                           "torch.backends.cuda.matmul.allow_tf32 = False")
    n_steps = S_paths.shape[0] - 1
    n_paths = S_paths.shape[1]
    dtype, device = S_paths.dtype, S_paths.device
    dt = (T / n_steps if isinstance(T, torch.Tensor)
          else np.float32(T) / np.float32(n_steps))
    disc = _discount(spec.rate, dt)
    K = spec.strike
    # One view per date: with a path matrix in the autograd graph, the
    # backward stacks the dates' gradients once instead of scattering each
    # into a zero matrix of its own.
    S_rows = S_paths.unbind(0)
    v_rows = None if v_paths is None else v_paths.unbind(0)

    cash = vanilla_payoff(S_rows[-1], K, spec.cp)  # t = n_steps
    train_mask, eval_mask = _oos_split(n_paths, out_of_sample, pair_block, dtype, device)
    if train_mask is None:
        train_mask = eval_mask

    for t in range(n_steps - 1, 0, -1):  # exercise dates, backward
        cash = cash * disc  # roll value back one step to date t
        if t % exercise_stride != 0:
            continue
        S_t = S_rows[t]
        immediate = vanilla_payoff(S_t, K, spec.cp)
        itm = (immediate > 0).to(dtype) * train_mask
        # The regression only feeds the exercise comparison, which carries
        # no gradient (the reference's pathwise Greeks hold the decisions
        # fixed), so it runs outside the graph.
        with torch.no_grad():
            X = build_centered_basis(S_t, K, itm, poly_degree,
                                     v_t=None if v_rows is None else v_rows[t],
                                     v_degree=v_degree)
            continuation = masked_wls_predict_centered(X, cash, itm)
        exercise = (immediate > continuation) & (immediate > 0)
        cash = torch.where(exercise, immediate, cash)
    cash = cash * disc  # the final step t = dt -> 0

    price, stderr, _ = masked_mean_stderr(cash, eval_mask, stat_pair_block)
    if return_cash:
        return price, stderr, (cash, eval_mask)
    return price, stderr


def _fit_generator(seed: int, iteration: int, device) -> torch.Generator:
    """The generator of policy iteration ``iteration`` of the NN fit seeded
    ``seed``, on ``device``: one Philox block keyed by the seed at counter
    (iteration, 0, 0, 0) gives its 64-bit seed (the port's fold_in)."""
    w0, w1, _, _ = philox4x32(torch.tensor(iteration), 0, torch.tensor(0), 0,
                              seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF)
    return torch.Generator(device=device).manual_seed(int(w0) | (int(w1) << 32))


def _policy_targets(immediate: torch.Tensor, cont: torch.Tensor, terminal: torch.Tensor,
                    disc1) -> torch.Tensor:
    """Per-(date, path) continuation targets under the current policy: the
    cashflow, discounted to date t, of not exercising at t and then following
    the stopping rule ``cont`` induces over dates t+1..n (the Longstaff-
    Schwartz target). One backward pass over the dates."""
    exercise = (immediate > cont) & (immediate > 0)
    out = torch.empty_like(immediate)
    value = terminal
    for t in range(immediate.shape[0] - 1, -1, -1):
        out[t] = disc1 * value
        value = torch.where(exercise[t], immediate[t], out[t])
    return out


def _nn_continuation(seed: int, S_paths: torch.Tensor, spec: OptionSpec, T,
                     lsm: LSMConfig, v_paths: Optional[torch.Tensor],
                     train_mask: Optional[torch.Tensor], return_net: bool = False,
                     heston: Optional[HestonParams] = None):
    """The two passes of the NN-LSM: train the shared continuation MLP on
    every (exercise date, path) state, then evaluate it on all of them.
    Returns (immediate, cont, terminal, ts) [, (net, x_mean, x_std, y_mean,
    y_std, has_baseline) with ``return_net``].

    ``train_mask`` (0/1 per path) restricts the training rows (the
    out-of-sample split); every path is evaluated. With a closed-form
    European baseline (GBM: BS at spec.sigma; Heston: BS at
    models.heston.effective_bs_sigma of the variance state) the net fits the
    targets minus the baseline, and the residual, floored at 0, is added
    back: holding to expiry is one admissible policy, so continuation >=
    European. Under Heston ``v`` is the 8th feature. The first fit's targets
    are the discounted terminal cashflows; each of the lsm.nn_policy_iters - 1
    refits trains on the cashflows realised under the current policy
    (_policy_targets), on the generator _fit_generator(seed, iteration)."""
    n_steps = S_paths.shape[0] - 1
    dtype, device = S_paths.dtype, S_paths.device
    T_ = torch.tensor(T, dtype=dtype, device=device)
    r = torch.tensor(spec.rate, dtype=dtype, device=device)
    dt = T_ / n_steps
    K = spec.strike

    ts = torch.arange(1, n_steps, device=device)     # exercise dates
    taus = T_ - ts.to(dtype) * dt
    S_ex = S_paths[1:n_steps]                        # (n_dates, n_paths)
    immediate = vanilla_payoff(S_ex, K, spec.cp)
    itm = (immediate > 0).to(dtype)

    # First-fit targets: the terminal cashflow discounted back to each date.
    terminal = vanilla_payoff(S_paths[-1], K, spec.cp)
    targets = torch.exp(-r * taus)[:, None] * terminal[None, :]

    if v_paths is not None:
        v_ex = v_paths[1:n_steps]
        sig_b = (effective_bs_sigma(v_ex, taus[:, None], heston) if heston is not None
                 else torch.sqrt(torch.clamp_min(v_ex, 1e-8)))
        baseline = bs_price(S_ex, K, taus[:, None], r, sig_b, spec.cp, q=spec.div_yield)
        has_baseline = True
    elif spec.sigma is not None:
        baseline = bs_price(S_ex, K, taus[:, None], r, spec.sigma, spec.cp,
                            q=spec.div_yield)
        has_baseline = True
    else:
        baseline = torch.zeros_like(immediate)
        has_baseline = False

    feats = regression_features(S_ex, K, taus[:, None])
    if v_paths is not None:
        feats = torch.cat([feats, v_paths[1:n_steps, :, None]], dim=-1)
    X = feats.reshape(-1, feats.shape[-1])
    W = itm.reshape(-1)
    if train_mask is not None:
        # Fit on the training paths only (every date of them), so the
        # standardization below describes the training distribution.
        W = W * train_mask.to(dtype).repeat(immediate.shape[0])
    del feats

    wsum = torch.clamp_min(W.sum(), 1.0)
    x_mean = (X * W[:, None]).sum(0) / wsum
    x_var = ((X - x_mean) ** 2 * W[:, None]).sum(0) / wsum
    x_std = torch.sqrt(torch.clamp_min(x_var, 1e-12))
    Xn = (X - x_mean) / x_std
    del X

    def fit_and_eval(generator, tgts):
        """Standardize the (residual) targets over the weighted rows, train,
        and evaluate every (date, path); with a baseline the net's output is
        the early-exercise premium, floored at 0 and added back."""
        Yf = (tgts - baseline).reshape(-1)
        ym = (Yf * W).sum() / wsum
        ys = torch.sqrt(torch.clamp_min(((Yf - ym) ** 2 * W).sum() / wsum, 1e-12))
        with span("fit", device):
            net, _ = fit_continuation_mlp(generator, Xn, (Yf - ym) / ys, W, lsm)
        with span("predict", device):
            out = mlp_predict(net, Xn).reshape(immediate.shape) * ys + ym
        c = baseline + torch.clamp_min(out, 0.0) if has_baseline else out
        return net, ym, ys, c

    net, y_mean, y_std, cont = fit_and_eval(_fit_generator(seed, 0, device), targets)
    disc1 = torch.exp(-r * dt)
    for it in range(1, lsm.nn_policy_iters):
        targets = _policy_targets(immediate, cont, terminal, disc1)
        net, y_mean, y_std, cont = fit_and_eval(_fit_generator(seed, it, device), targets)
    if return_net:
        return immediate, cont, terminal, ts, (net, x_mean, x_std, y_mean, y_std,
                                               has_baseline)
    return immediate, cont, terminal, ts


def _nn_stopped_cash(immediate: torch.Tensor, cont: torch.Tensor, terminal: torch.Tensor,
                     ts: torch.Tensor, spec: OptionSpec, T, n_steps: int,
                     exercise_stride: int = 1) -> torch.Tensor:
    """Per-path discounted cashflow of the earliest-exercise policy read off
    the (dates, paths) continuation grid; ``exercise_stride`` restricts
    exercise to every stride-th date (the coarse Richardson level)."""
    dtype, device = immediate.dtype, immediate.device
    dt = torch.tensor(T, dtype=dtype, device=device) / n_steps
    r = torch.tensor(spec.rate, dtype=dtype, device=device)
    exercise = (immediate > cont) & (immediate > 0)
    if exercise_stride > 1:
        exercise = exercise & (ts % exercise_stride == 0)[:, None]
    any_ex = exercise.any(dim=0)
    first_idx = torch.argmax(exercise.to(torch.int32), dim=0)   # the first True
    t_star = torch.where(any_ex, ts[first_idx].to(dtype),
                         torch.tensor(float(n_steps), dtype=dtype, device=device))
    value = torch.where(any_ex, immediate.gather(0, first_idx[None])[0], terminal)
    return torch.exp(-r * t_star * dt) * value


def lsm_nn_backward(seed: int, S_paths: torch.Tensor, spec: OptionSpec, T,
                    lsm: LSMConfig, stat_pair_block: Optional[int] = None,
                    v_paths: Optional[torch.Tensor] = None, out_of_sample: bool = False,
                    pair_block: Optional[int] = None, return_cash: bool = False,
                    heston: Optional[HestonParams] = None):
    """Two-pass LSM with one shared continuation MLP (_nn_continuation),
    trained from the 64-bit ``seed``. Returns (price, stderr) [, (cash,
    eval_mask)]. ``stat_pair_block`` makes the stderr pair-aware;
    ``v_paths`` (Heston) is the 8th feature; ``out_of_sample`` trains on
    alternating ``pair_block`` blocks and prices on the others."""
    n_steps, n_paths = S_paths.shape[0] - 1, S_paths.shape[1]
    train_mask, eval_mask = _oos_split(n_paths, out_of_sample, pair_block, S_paths.dtype,
                                      S_paths.device)
    immediate, cont, terminal, ts = _nn_continuation(seed, S_paths, spec, T, lsm, v_paths,
                                                     train_mask, heston=heston)
    cash = _nn_stopped_cash(immediate, cont, terminal, ts, spec, T, n_steps)
    price, stderr, _ = masked_mean_stderr(cash, eval_mask, stat_pair_block)
    if return_cash:
        return price, stderr, (cash, eval_mask)
    return price, stderr


def richardson_nn_stat(seed: int, S_paths: torch.Tensor, v_paths: Optional[torch.Tensor],
                       spec: OptionSpec, T, lsm: LSMConfig, *,
                       heston: Optional[HestonParams] = None,
                       bates: Optional[BatesParams] = None, vg: Optional[VGParams] = None,
                       model: str = "gbm", pair_block: Optional[int] = None):
    """(per-path Richardson statistic, eval mask) of the NN-LSM: one net is
    trained; the fine and coarse levels are two stopping policies read off
    the same continuation grid (every date, every 2nd date), stat = 2
    cash_fine - cash_coarse, plus the control variate when it is on and a
    closed-form leg exists. As in the reference, Merton has no leg here."""
    n_steps, n_paths = S_paths.shape[0] - 1, S_paths.shape[1]
    train_mask, eval_mask = _oos_split(n_paths, lsm.out_of_sample, pair_block,
                                      S_paths.dtype, S_paths.device)
    immediate, cont, terminal, ts = _nn_continuation(seed, S_paths, spec, T, lsm, v_paths,
                                                     train_mask,
                                                     heston=_vol_params(heston, bates))
    cash_f = _nn_stopped_cash(immediate, cont, terminal, ts, spec, T, n_steps)
    cash_c = _nn_stopped_cash(immediate, cont, terminal, ts, spec, T, n_steps,
                              exercise_stride=2)
    stat = 2.0 * cash_f - cash_c
    if lsm.use_control_variate and _has_cv_leg(spec, model, heston, bates=bates, vg=vg):
        stat = _apply_cv(stat, _cv_adjustment(S_paths, spec, T, heston=heston, model=model,
                                              bates=bates, vg=vg),
                         lsm.cv_beta, eval_mask, pair_block)
    return stat, eval_mask


def _vol_params(heston, bates=None):
    """The HestonParams governing the variance state: Bates carries them
    nested. The NN-LSM's residual baseline uses their diffusion-only
    effective vol; the floored residual fit absorbs the jumps' part of the
    European, as in the reference."""
    if heston is not None:
        return heston
    return bates.heston if bates is not None else None


def _simulate_for(generator, S0, T, spec, mc, lsm, model, heston, engine,
                  heston_scheme, device, merton=None, bates=None, sigma_fn=None, vg=None,
                  sabr=None):
    """(S_paths, v_paths or None, fit seed or None) for the LSM pricers, at
    the width of simulated_config. The simulation draws its seed from
    ``generator`` first (Bates's overlay takes the same seed); the NN-LSM's
    fit draws the next one. v_paths is the variance (Heston, Bates) or
    alpha (SABR) matrix when ``lsm.variance_basis``."""
    want_v = model in ("heston", "bates", "sabr") and lsm.variance_basis
    with span("simulate", resolve_device(device)):
        out = simulate_paths(generator, S0, T, simulated_config(mc, model), model,
                             sigma=spec.sigma,
                             rate=spec.rate, heston=heston, merton=merton, bates=bates,
                             vg=vg, sabr=sabr, sigma_fn=sigma_fn, engine=engine,
                             heston_scheme=heston_scheme, div_yield=spec.div_yield,
                             return_variance=want_v, device=device)
    S_paths, v_paths = out if want_v else (out, None)
    fit_seed = seed_from_generator(generator) if lsm.regressor == "nn" else None
    return S_paths, v_paths, fit_seed


def _lsm_backward(fit_seed, S_paths, v_paths, spec: OptionSpec, T, lsm: LSMConfig,
                  pair_block: int, stat_pair_block=None, return_cash: bool = False,
                  heston: Optional[HestonParams] = None,
                  bates: Optional[BatesParams] = None):
    """The configured regressor's backward on simulated paths:
    lsm_poly_backward or lsm_nn_backward."""
    if lsm.regressor == "nn":
        return lsm_nn_backward(fit_seed, S_paths, spec, T, lsm,
                               stat_pair_block=stat_pair_block, v_paths=v_paths,
                               out_of_sample=lsm.out_of_sample, pair_block=pair_block,
                               return_cash=return_cash, heston=_vol_params(heston, bates))
    return lsm_poly_backward(S_paths, spec, T, poly_degree=lsm.poly_degree,
                             v_degree=lsm.variance_basis_degree,
                             out_of_sample=lsm.out_of_sample, pair_block=pair_block,
                             stat_pair_block=stat_pair_block, return_cash=return_cash,
                             v_paths=v_paths)


def _has_cv_leg(spec: OptionSpec, model: str, heston, merton=None, bates=None,
                vg=None) -> bool:
    return ((model == "gbm" and spec.sigma is not None)
            or (model == "heston" and heston is not None)
            or (model == "merton" and merton is not None)
            or (model == "bates" and bates is not None)
            or (model == "vg" and vg is not None))


def price_american_lsm(generator: torch.Generator, S0, T, spec: OptionSpec,
                       mc: MCConfig, lsm: LSMConfig, model: str = "gbm", *,
                       heston: Optional[HestonParams] = None,
                       merton: Optional[MertonParams] = None,
                       bates: Optional[BatesParams] = None, vg: Optional[VGParams] = None,
                       sabr: Optional[SABRParams] = None, sigma_fn=None,
                       axis_name=None, engine: str = "auto", heston_scheme: str = "euler",
                       device=None):
    """Simulate + LSM backward induction (either regressor). Returns (price,
    stderr)."""
    _check_slice(model, lsm, axis_name)
    S_paths, v_paths, fit_seed = _simulate_for(generator, S0, T, spec, mc, lsm, model,
                                               heston, engine, heston_scheme, device,
                                               merton, bates, sigma_fn, vg, sabr)
    pb = _pair_block(mc, model)
    return _lsm_backward(fit_seed, S_paths, v_paths, spec, T, lsm, pb,
                         stat_pair_block=pb if mc.antithetic else None, heston=heston,
                         bates=bates)


def price_american_with_control_variate(
        generator: torch.Generator, S0, T, spec: OptionSpec, mc: MCConfig,
        lsm: LSMConfig, model: str = "gbm", *,
        heston: Optional[HestonParams] = None, merton: Optional[MertonParams] = None,
        bates: Optional[BatesParams] = None, vg: Optional[VGParams] = None,
        sabr: Optional[SABRParams] = None, sigma_fn=None, axis_name=None,
        engine: str = "auto", heston_scheme: str = "euler", device=None):
    """American price with the same-path European control variate:
    AM_cv = AM_lsm + beta (EU_closed_form - EU_mc_same_paths), the stderr
    taken over the per-path CV statistic. Both regressors compose: the
    variate acts on the stopped per-path cashflows (around the shared
    network it is the reference's flagship estimator). Without a
    closed-form leg this is price_american_lsm: SABR lands there by design,
    as in the reference (a variate anchored on Hagan's O(T)-accurate mean
    would carry that error into the price)."""
    _check_slice(model, lsm, axis_name)
    if not _has_cv_leg(spec, model, heston, merton, bates, vg):
        return price_american_lsm(generator, S0, T, spec, mc, lsm, model,
                                  heston=heston, merton=merton, bates=bates, vg=vg, sabr=sabr,
                                  sigma_fn=sigma_fn, engine=engine, heston_scheme=heston_scheme,
                                  device=device)
    S_paths, v_paths, fit_seed = _simulate_for(generator, S0, T, spec, mc, lsm, model,
                                               heston, engine, heston_scheme, device,
                                               merton, bates, sigma_fn, vg)
    pb = _pair_block(mc, model)
    _, _, (cash, eval_mask) = _lsm_backward(fit_seed, S_paths, v_paths, spec, T, lsm, pb,
                                            return_cash=True, heston=heston, bates=bates)
    stat_pb = pb if mc.antithetic else None
    cv = _apply_cv(cash, _cv_adjustment(S_paths, spec, T, heston=heston, model=model,
                                        merton=merton, bates=bates, vg=vg),
                   lsm.cv_beta, eval_mask, stat_pb)
    return masked_mean_stderr(cv, eval_mask, stat_pb)[:2]


def price_american_with_stats(generator: torch.Generator, S0, T, spec: OptionSpec,
                              mc: MCConfig, lsm: LSMConfig, model: str = "gbm", *,
                              heston: Optional[HestonParams] = None,
                              merton: Optional[MertonParams] = None,
                              bates: Optional[BatesParams] = None,
                              vg: Optional[VGParams] = None, sigma_fn=None,
                              engine: str = "auto", device=None):
    """(price, stderr, cashflow statistics): the reference's verbose pricing
    report (mean, std, min, max and P(worthless) of the per-path discounted
    cashflows, core/stats.cashflow_statistics, as Python floats). Both
    regressors; no SABR, as in the reference."""
    _check_slice(model, lsm)
    S_paths, v_paths, fit_seed = _simulate_for(generator, S0, T, spec, mc, lsm, model,
                                               heston, engine, "euler", device, merton,
                                               bates, sigma_fn, vg)
    pb = _pair_block(mc, model)
    price, stderr, (cash, eval_mask) = _lsm_backward(
        fit_seed, S_paths, v_paths, spec, T, lsm, pb,
        stat_pair_block=pb if mc.antithetic else None, return_cash=True, heston=heston,
        bates=bates)
    stats = {k: float(v) for k, v in cashflow_statistics(cash, eval_mask).items()}
    return price, stderr, stats


def richardson_cv_stat(S_paths: torch.Tensor, v_paths: Optional[torch.Tensor],
                       spec: OptionSpec, T, lsm: LSMConfig, *,
                       heston: Optional[HestonParams] = None,
                       merton: Optional[MertonParams] = None,
                       bates: Optional[BatesParams] = None, vg: Optional[VGParams] = None,
                       model: str = "gbm", pair_block: Optional[int] = None, axis_name=None):
    """(per-path Richardson statistic, eval mask) on given paths: the fine
    level exercises at every date, the coarse level on every 2nd date of
    the same paths, stat = 2 cash_fine - cash_coarse, plus the control
    variate when it is on and a closed-form leg exists."""
    _check_slice(model, lsm, axis_name)
    kwargs = dict(poly_degree=lsm.poly_degree, v_degree=lsm.variance_basis_degree,
                  out_of_sample=lsm.out_of_sample, pair_block=pair_block,
                  return_cash=True, v_paths=v_paths)
    _, _, (cash_f, mask) = lsm_poly_backward(S_paths, spec, T, **kwargs)
    _, _, (cash_c, _) = lsm_poly_backward(S_paths, spec, T, exercise_stride=2,
                                          **kwargs)
    stat = 2.0 * cash_f - cash_c
    if lsm.use_control_variate and _has_cv_leg(spec, model, heston, merton, bates, vg):
        stat = _apply_cv(stat, _cv_adjustment(S_paths, spec, T, heston=heston,
                                              model=model, merton=merton, bates=bates, vg=vg),
                         lsm.cv_beta, mask, pair_block)
    return stat, mask


def price_american_richardson(generator: torch.Generator, S0, T, spec: OptionSpec,
                              mc: MCConfig, lsm: LSMConfig, model: str = "gbm",
                              *, heston: Optional[HestonParams] = None,
                              merton: Optional[MertonParams] = None,
                              bates: Optional[BatesParams] = None,
                              vg: Optional[VGParams] = None, sabr: Optional[SABRParams] = None,
                              sigma_fn=None, engine: str = "auto", heston_scheme: str = "euler",
                              device=None):
    """Richardson-extrapolated continuous-exercise American price: an n-date
    LSM prices a Bermudan option whose gap to the American is O(1/n); the
    two levels share paths, so 2 P_n - P_{n/2} is nearly noise-free.
    Returns (price, stderr of the extrapolated per-path statistic). The poly
    backward re-regresses the coarse level (richardson_cv_stat); the NN-LSM
    reads both policies off one trained net (richardson_nn_stat)."""
    _check_slice(model, lsm)
    S_paths, v_paths, fit_seed = _simulate_for(generator, S0, T, spec, mc, lsm, model,
                                               heston, engine, heston_scheme, device,
                                               merton, bates, sigma_fn, vg, sabr)
    pb = _pair_block(mc, model)
    kw = dict(heston=heston, bates=bates, vg=vg, model=model, pair_block=pb)
    if lsm.regressor == "nn":
        stat, mask = richardson_nn_stat(fit_seed, S_paths, v_paths, spec, T, lsm, **kw)
    else:
        stat, mask = richardson_cv_stat(S_paths, v_paths, spec, T, lsm, merton=merton, **kw)
    price, stderr, _ = masked_mean_stderr(stat, mask, pb if mc.antithetic else None)
    return price, stderr


def price_american(generator: torch.Generator, S0, T, spec: OptionSpec,
                   mc: MCConfig, lsm: LSMConfig, model: str = "gbm", *,
                   heston: Optional[HestonParams] = None,
                   merton: Optional[MertonParams] = None,
                   bates: Optional[BatesParams] = None, vg: Optional[VGParams] = None,
                   sabr: Optional[SABRParams] = None, sigma_fn=None, axis_name=None,
                   engine: str = "auto", device=None):
    """The public dispatcher: the European terminal sampler when
    ``lsm.european_approximation``, Richardson when ``lsm.richardson``, the
    control variate when it is on and a closed-form leg exists, plain LSM
    otherwise. Returns (price, stderr) as 0-dim tensors on ``device``."""
    _check_slice(model, lsm, axis_name)
    models = dict(heston=heston, merton=merton, bates=bates, vg=vg, sabr=sabr, sigma_fn=sigma_fn)
    if lsm.european_approximation:
        from options_model_tpu_torch.pricers.european import (
            make_terminal_sampler, price_european_mc)
        sampler = make_terminal_sampler(model, S0, spec.rate, T, sigma=spec.sigma,
                                        engine=engine, div_yield=spec.div_yield,
                                        device=device, **models)
        price, stderr, _ = price_european_mc(generator, sampler, spec, T, mc)
        return price, stderr
    if lsm.richardson:
        return price_american_richardson(generator, S0, T, spec, mc, lsm, model,
                                         engine=engine, device=device, **models)
    if lsm.use_control_variate and _has_cv_leg(spec, model, heston, merton, bates, vg):
        return price_american_with_control_variate(
            generator, S0, T, spec, mc, lsm, model, engine=engine, device=device, **models)
    return price_american_lsm(generator, S0, T, spec, mc, lsm, model, engine=engine,
                              device=device, **models)
