"""Martingale-dual (Rogers / Haugh-Kogan) upper bound and the primal-dual
bracket for American options, as options_model_tpu/pricers/dual.py.

The LSM estimators are low-biased (a suboptimal exercise policy, and the
out-of-sample estimator by construction). The duality result of Rogers
(2002) gives the complementary bound: for any adapted martingale M with
M_0 = 0,

    V_0 <= E[ max_t ( D^t h(S_t) - M_t ) ],

so the bracket [low, high] brackets the price from both sides on one
simulation. M is built from the value surrogate W_t = max(h, E_t, clip(C_t))
(``_vhat``: the intrinsic value, the European floor at the remaining
maturity, and the fitted LSM continuation gated to the in-the-money side),
W_n = h. Its one-step conditional expectations E[W_{t+1} | state_t] come
from:
- interior dates: one-step nested sampling, n_inner antithetic draws of the
  simulator's own one-step transition per (date, path) (GBM, Heston's
  full-truncation Euler step, and with Merton's or Bates's compound-jump
  increment; VG's exact gamma-clock step, the pair sharing its clock; SABR's
  beta = 1 step with the exact lognormal alpha; rough Bergomi's hybrid step
  from the path's frozen Volterra history, which makes the one-step law
  exact although (S, v) is not a Markov state), on fresh draws every date:
  kernel 18 (csrc/dual.cu dual_ce_kernel) on the card, ``dual_ce_from_draws``
  on the CPU;
- the terminal step: the one-step Black closed form (the Poisson mixture of
  Black terms under the jumps), exact, with no inner noise; under VG the
  Black expectation given the clock, averaged over n_inner/2 clock draws
  (csrc/dual.cu dual_vg_terminal_warp_kernel on the card).
The NN policy evaluates the shared continuation network at the inner
states, which kernel 19 (dual_inner_states_kernel) writes a chunk of dates
at a time; the network itself is a plain matrix product
(regressors.mlp_predict).

The inner draws are the dual's own Philox stream (ops/philox.py
``dual_inner_draws``), keyed by a seed that ``price_american_bracket``
draws from the caller's generator apart from the simulation's: reusing the
paths' randomness would correlate the inner averages with the increments
they center and break the martingale property. Fresh draws at each date
keep M a martingale, so inner noise only loosens the bound. The stream's
tile is the bracket's pair block (``inner_block``), keyed by the global
tile, so a run at ``first_block`` reproduces those tiles bit for bit.

The path-sharded bracket (``axis_name``) is not ported (``not_ported``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from options_model_tpu_torch._unported import not_ported
from options_model_tpu_torch.core.config import (BatesParams, HestonParams, LSMConfig,
                                                  MCConfig, MertonParams, OptionSpec,
                                                  RBergomiParams, SABRParams, VGParams)
from options_model_tpu_torch.core.payoff import vanilla_payoff
from options_model_tpu_torch.core.stats import masked_mean_stderr
from options_model_tpu_torch.models.heston import effective_bs_sigma
from options_model_tpu_torch.ops.engine import checked_device
from options_model_tpu_torch.ops.lsm_basis import regression_features
from options_model_tpu_torch.ops.philox import gamma_constants, seed_from_generator
from options_model_tpu_torch.pricers.american import (STATE_MODELS, _discount,
                                                      _nn_continuation, _nn_stopped_cash,
                                                      _pair_block, build_centered_basis,
                                                      oos_masks, simulate_paths,
                                                      simulated_config)
from options_model_tpu_torch.pricers.blackscholes import bs_price, ndtr
from options_model_tpu_torch.pricers.regressors import (ContinuationMLP,
                                                        masked_wls_theta_centered,
                                                        mlp_predict, mlp_state_from_flax)

_U_CLAMP = 4.0  # the regression's fitted ITM range in standardized u units
# Terms of the Poisson mixture in the jump families' terminal step: P(N >= 10)
# ~ (lam dt)^10 / 10!, far below the dual's Monte-Carlo noise.
JUMP_TERMS = 10
MODELS = ("gbm", "heston", "merton", "bates", "vg", "sabr", "rbergomi")
# Rows (inner states) of the NN dual's states per chunk of dates: its
# features are 8 floats a row, 512 MB at this size.
NN_CHUNK_ROWS = 1 << 24
# A policy row's floats before its betas (ops/cuda_dual.policy_rows): tau,
# x_mean, x_rstd, v_mean, v_rstd.
ROW_HEAD = 5


class LSMPolicy(NamedTuple):
    """Per-exercise-date regression state, dates 1..n_steps-1 in forward
    order: the continuation value at date t is

        C_t(x) = sum_k betas[t, k] u^k + betas[t, degree+1] (x - 1)^+
                 [+ betas[t, degree+2] w + betas[t, degree+3] w^2
                  + betas[t, degree+4] u w   with a variance state],
        u = (x - x_mean[t]) x_rstd[t],  x = S / K,
        w = (v - v_mean[t]) v_rstd[t]."""

    betas: torch.Tensor   # (n_dates, degree + 2 [+ 3 with variance])
    x_mean: torch.Tensor  # (n_dates,)
    x_rstd: torch.Tensor  # (n_dates,)
    v_mean: Optional[torch.Tensor] = None  # (n_dates,) with a second state only
    v_rstd: Optional[torch.Tensor] = None


def fit_lsm_policy(S_paths: torch.Tensor, spec: OptionSpec, T, *, poly_degree: int = 3,
                   train_mask: Optional[torch.Tensor] = None,
                   v_paths: Optional[torch.Tensor] = None, axis_name=None):
    """LSM backward induction that also returns the per-date regressions:
    pricers.american.lsm_poly_backward's algorithm (masked WLS on the
    centered basis, fitted on ``train_mask`` paths, decisions applied to
    every path), so in float32 its stopped cash is that pricer's bit for
    bit; in float64 the discount is taken in float64, as the reference
    takes it. ``v_paths`` adds the variance columns. Returns (policy, cash),
    cash the per-path stopped cashflow discounted to t = 0."""
    if axis_name is not None:
        raise not_ported("axis_name (path-sharded LSM)", "pricers.dual.fit_lsm_policy")
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("fit_lsm_policy needs full float32 matmuls: set "
                           "torch.backends.cuda.matmul.allow_tf32 = False")
    n_steps = S_paths.shape[0] - 1
    dtype, device = S_paths.dtype, S_paths.device
    if dtype == torch.float32:
        disc = _discount(spec.rate, np.float32(T) / np.float32(n_steps))
    else:
        disc = math.exp(-float(spec.rate) * (float(T) / n_steps))
    K = spec.strike
    if train_mask is None:
        train_mask = torch.ones(S_paths.shape[1], dtype=dtype, device=device)

    cash = vanilla_payoff(S_paths[-1], K, spec.cp)
    fits = []
    for t in range(n_steps - 1, 0, -1):
        cash = cash * disc
        S_t = S_paths[t]
        immediate = vanilla_payoff(S_t, K, spec.cp)
        itm = (immediate > 0).to(dtype) * train_mask
        with torch.no_grad():
            X, stats = build_centered_basis(S_t, K, itm, poly_degree,
                                            v_t=None if v_paths is None else v_paths[t],
                                            return_stats=True)
            theta = masked_wls_theta_centered(X, cash, itm)
            continuation = X @ theta
        exercise = (immediate > continuation) & (immediate > 0)
        cash = torch.where(exercise, immediate, cash)
        fits.append((theta,) + stats)
    cash = cash * disc  # the final step t = dt -> 0
    cols = [torch.stack(c[::-1]) for c in zip(*fits)]
    return LSMPolicy(*cols), cash


def lsm_policy_from_jax(arrays, device=None) -> LSMPolicy:
    """An LSMPolicy from the JAX package's (betas, x_mean, x_rstd[, v_mean,
    v_rstd]) as numpy arrays (its LSMPolicy's fields, None where absent),
    on ``device`` (the card by default), in their own float dtype."""
    device = checked_device(device)
    return LSMPolicy(*[None if a is None else torch.as_tensor(np.array(a), device=device)
                       for a in arrays])


def _one_step_black(x, mu, a, cp):
    """E[(x' - 1)^+ | x] (cp = +1) or E[(1 - x')^+ | x] (cp = -1) for one
    lognormal step x' = x exp(mu + a Z): the Black formula on one step."""
    d2 = (torch.log(x) + mu) / a
    d1 = d2 + a
    fwd = x * torch.exp(mu + 0.5 * a * a)
    if cp > 0:
        return fwd * ndtr(d1) - ndtr(d2)
    return ndtr(-d2) - fwd * ndtr(-d1)


def _one_step_jump_black(x, mu0, a2, cp, lam_dt: float, mu_j: float, sig_j: float,
                         n_terms: int = JUMP_TERMS):
    """E[h(x') | state] for one jump-diffusion step: given N = n, log x' ~
    N(log x + mu0 + n mu_j, a2 + n sig_j^2), so the expectation is the
    Poisson mixture of one-step Black terms, cut at ``n_terms`` (weights from
    lgamma; at lam dt = 0 the weights are (1, 0, ...))."""
    k = torch.arange(n_terms, dtype=x.dtype, device=x.device)
    lam = torch.tensor(lam_dt, dtype=x.dtype, device=x.device)
    logw = -lam + k * torch.log(torch.clamp_min(lam, 1e-30)) - torch.lgamma(k + 1.0)
    w = torch.exp(logw) if lam_dt > 0 else (k == 0).to(x.dtype)
    f = np.float32
    out = 0.0
    for n in range(n_terms):
        out = out + w[n] * _one_step_black(x, mu0 + float(f(n) * f(mu_j)),
                                           torch.sqrt(a2 + float(f(n) * (f(sig_j) * f(sig_j)))),
                                           cp)
    return out


def _tensor(value, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(value, dtype=like.dtype, device=like.device)


def _vhat(x, K, cp, tau, rate, q, sigma, b, m, rho, degree: int, v=None, vm=None, vr=None):
    """Value surrogate W_t(x) = max(h, E_t, clip(C_t(u clamped), 0, cap)) in
    price units (the reference's _vhat): h the intrinsic value; E_t the
    European floor at remaining maturity ``tau`` and vol ``sigma``; C_t the
    fitted continuation (betas ``b``, standardization ``m``, ``rho`` [and
    ``vm``, ``vr`` for the variance state ``v``]) only on the in-the-money
    side, u and w clamped to +-_U_CLAMP, clipped to [0, cap], cap = K for
    puts and K x for calls. Powers of u are taken as running products,
    kernel 18's order."""
    u = torch.clamp((x - m) * rho, -_U_CLAMP, _U_CLAMP)
    c = b[..., 0, None]
    p = u
    for k in range(1, degree + 1):
        if k > 1:
            p = p * u
        c = c + b[..., k, None] * p
    c = c + b[..., degree + 1, None] * torch.clamp_min(x - 1.0, 0.0)
    if v is not None:
        w = torch.clamp((v - vm) * vr, -_U_CLAMP, _U_CLAMP)
        c = (c + b[..., degree + 2, None] * w + b[..., degree + 3, None] * (w * w)
             + b[..., degree + 4, None] * u * w)
    cap = K * x if cp > 0 else K
    itm_side = cp * (x - 1.0) >= 0.0
    c = torch.where(itm_side, torch.minimum(torch.clamp_min(c, 0.0), _tensor(cap, c)), 0.0)
    h = K * torch.clamp_min(cp * (x - 1.0), 0.0)
    e = bs_price(K * x, K, tau, rate, _tensor(sigma, x), cp, q=q)
    return torch.maximum(torch.maximum(h, e), c)


@dataclasses.dataclass(frozen=True)
class InnerLaw:
    """The one-step inner transition and the surrogate's floor of one dual,
    as float32 numbers (Python floats, each exactly a float32), computed in
    float32 as the reference's traced constants are: the kernels and their
    plain versions start from the same bits.

    GBM and Merton: log x' = log x + mu + a z [+ N mu_j + sig_j sqrt(N) z_j],
    mu = (r - q - sigma^2/2) dt - lam kbar dt, floor vol sig_f = sqrt(sigma^2
    + jvar). Heston and Bates: the full-truncation Euler step from (x, v)
    with w2 = rho z1 + rho_bar z2, the floor vol sqrt(sigma_eff(v', tau)^2 +
    jvar) (models.heston.effective_bs_sigma). ``lam_dt`` the Poisson mean a
    step, 0 without jumps. VG: log x' = log x + (mu + theta G) +- sigma
    sqrt(G) z, G = nu Gamma(gamma_shape) (the sampler's gamma_d, gamma_c,
    gamma_inv_a, gamma_boost), mu = (r - q + omega) dt, floor vol sig_f =
    sqrt(sigma^2 + nu theta^2). SABR (beta = 1): x' = x e^{(r - q - a^2/2) dt
    + a sqrt(dt) z1}, a' = a e^{nu sqrt(dt) w2 - nu^2 dt / 2}, floor vol a'.
    Rough Bergomi: dW = sqrt(dt) z1, x' = x e^{(r - q - v/2) dt + sqrt(v)
    (rho dW + rbsd zp)}, Y' = h + sqrt2H (c1 dW + c2 z2), v' = xi0 e^{eta Y'
    - comp}, floor vol sqrt((v' + xi0) / 2)."""

    model: str
    K: float
    cp: float
    rate: float
    q: float
    dt: float
    drift: float
    mu: float = 0.0
    a: float = 0.0
    sig_f: float = 0.0
    kappa: float = 0.0
    theta: float = 0.0
    xi: float = 0.0
    rho: float = 0.0
    rho_bar: float = 0.0
    comp_dt: float = 0.0
    jvar: float = 0.0
    mu_j: float = 0.0
    sig_j: float = 0.0
    nu: float = 0.0
    vg_theta: float = 0.0
    vg_sigma: float = 0.0
    gamma_d: float = 0.0
    gamma_c: float = 0.0
    gamma_inv_a: float = 0.0
    gamma_boost: float = 0.0
    sqrt_dt: float = 0.0
    nu_sqrt_dt: float = 0.0
    half_nu2_dt: float = 0.0
    rbsd: float = 0.0
    sqrt2H: float = 0.0
    c1: float = 0.0
    c2: float = 0.0
    eta: float = 0.0
    xi0: float = 0.0
    lam_dt: float = 0.0
    gamma_shape: float = 1.0

    @property
    def use_v(self) -> bool:
        return self.model in STATE_MODELS

    @property
    def jumps(self) -> bool:
        return self.model in ("merton", "bates")


def inner_law(model: str, spec: OptionSpec, T, n_steps: int, *,
              heston: Optional[HestonParams] = None, merton: Optional[MertonParams] = None,
              bates: Optional[BatesParams] = None, vg: Optional[VGParams] = None,
              sabr: Optional[SABRParams] = None,
              rbergomi: Optional[RBergomiParams] = None) -> InnerLaw:
    """The InnerLaw of ``model``, its float32 arithmetic the reference's
    (dual.py:405-441, 450-457, 497-510, 563-567, 645-650, 687-694): float64
    host values (rough Bergomi's sqrt(2H), c1, c2) cast once, the rest
    float32. Merton's diffusion vol is merton.sigma, not spec.sigma."""
    f = np.float32
    dt = f(T) / f(n_steps)
    rate, q = f(spec.rate), f(spec.div_yield)
    drift = rate - q
    sqrt_dt = np.sqrt(dt)
    base = dict(model=model, K=float(f(spec.strike)), cp=float(spec.cp), rate=float(rate),
                q=float(q), dt=float(dt), drift=float(drift), sqrt_dt=float(sqrt_dt))
    if model == "vg":
        sig, th, nu = f(vg.sigma), f(vg.theta), f(vg.nu)
        om = np.log1p(-th * nu - f(0.5) * (sig * sig) * nu) / nu
        shape = dt / nu
        g = gamma_constants(shape)
        return InnerLaw(**base, mu=float((drift + om) * dt),
                        sig_f=float(np.sqrt(sig * sig + nu * (th * th))), nu=float(nu),
                        vg_theta=float(th), vg_sigma=float(sig), gamma_d=float(g["d"]),
                        gamma_c=float(g["c"]), gamma_inv_a=float(g["inv_a"]),
                        gamma_boost=float(g["boost"]), gamma_shape=float(shape))
    if model == "sabr":
        nu, rho = f(sabr.nu), f(sabr.rho)
        return InnerLaw(**base, rho=float(rho), rho_bar=float(np.sqrt(f(1.0) - rho * rho)),
                        nu_sqrt_dt=float(nu * sqrt_dt),
                        half_nu2_dt=float((f(0.5) * (nu * nu)) * dt))
    if model == "rbergomi":
        from options_model_tpu_torch.models.rbergomi import _hybrid_weights

        _, c1, c2, _ = _hybrid_weights(n_steps, float(rbergomi.H), float(T) / n_steps)
        rho = f(rbergomi.rho)
        rho_bar = np.sqrt(f(1.0) - rho * rho)
        return InnerLaw(**base, rho=float(rho), rho_bar=float(rho_bar),
                        rbsd=float(rho_bar * sqrt_dt),
                        sqrt2H=float(f(np.sqrt(2.0 * float(rbergomi.H)))), c1=float(f(c1)),
                        c2=float(f(c2)), eta=float(f(rbergomi.eta)), xi0=float(f(rbergomi.xi0)))
    jp = merton if model == "merton" else (bates if model == "bates" else None)
    fields = base
    comp_dt = jvar = f(0.0)
    if jp is not None:
        lam, mu_j, sig_j = f(jp.lam), f(jp.mu_j), f(jp.sigma_j)
        kbar = np.exp(mu_j + f(0.5) * sig_j * sig_j) - f(1.0)
        comp_dt = lam * kbar * dt
        jvar = lam * (mu_j * mu_j + sig_j * sig_j)
        fields.update(comp_dt=float(comp_dt), jvar=float(jvar), mu_j=float(mu_j),
                      sig_j=float(sig_j), lam_dt=float(lam * dt))
    if model in ("heston", "bates"):
        hp = bates.heston if model == "bates" else heston
        rho = f(hp.rho)
        fields.update(kappa=float(f(hp.kappa)), theta=float(f(hp.theta)), xi=float(f(hp.xi)),
                      rho=float(rho), rho_bar=float(np.sqrt(f(1.0) - rho * rho)))
    else:
        sig = f(jp.sigma if model == "merton" else spec.sigma)
        fields.update(mu=float((drift - f(0.5) * sig * sig) * dt - comp_dt),
                      a=float(sig * np.sqrt(dt)), sig_f=float(np.sqrt(sig * sig + jvar)))
    return InnerLaw(**fields)


def rbergomi_comp(rbergomi: RBergomiParams, T, n_steps: int) -> np.ndarray:
    """Rough Bergomi's compensator (eta^2 / 2) Var(Y_{t_{t+1}}) of the
    dates' inner states v' (t = 0..n_steps-2), float32 as the reference's
    comp_next (dual.py:509-510)."""
    from options_model_tpu_torch.models.rbergomi import _hybrid_weights

    f = np.float32
    eta = f(rbergomi.eta)
    _, _, _, var = _hybrid_weights(n_steps, float(rbergomi.H), float(T) / n_steps)
    return (f(0.5) * (eta * eta)) * var[1:n_steps].astype(np.float32)


def date_taus(T, n_steps: int) -> np.ndarray:
    """tau_t = T - t dt of the exercise dates t = 1..n_steps-1, float32."""
    f = np.float32
    return f(T) - np.arange(1, n_steps, dtype=np.float32) * (f(T) / f(n_steps))


def _floor_vol(law: InnerLaw, v, tau):
    """The surrogate's European floor vol at the second state ``v``: Heston's
    and Bates's effective vol, SABR's alpha, rough Bergomi's sqrt((v +
    xi0) / 2); the constant sig_f without one."""
    if not law.use_v:
        return law.sig_f
    if law.model == "sabr":
        return v
    if law.model == "rbergomi":
        return torch.sqrt(0.5 * (v + law.xi0))
    hp = HestonParams(kappa=law.kappa, theta=law.theta, xi=law.xi, rho=law.rho, v0=law.theta)
    return torch.sqrt(effective_bs_sigma(v, tau, hp) ** 2 + law.jvar)


def inner_states_from_draws(law: InnerLaw, xp: torch.Tensor, vp: Optional[torch.Tensor],
                            draws: dict, h: Optional[torch.Tensor] = None, comp=None):
    """The inner one-step states of one date from its draws (each (half, P);
    "z" or "z1", "z2" [, "zp"], and "n", "zj" under the jumps, "gamma" under
    VG): (x', v') each (2, half, P), the pair's up member first (v' None
    without a second state). Rough Bergomi also takes the date's frozen
    histories ``h`` (P,) and compensator ``comp``. The reference's
    transitions (dual.py:462-486, 519-544, 585-610, 651-669, 706-724): the
    pair mirrors the normals and shares the count and the clock."""
    if law.model == "vg":
        G = law.nu * draws["gamma"]
        jb, jn = law.vg_theta * G, law.vg_sigma * torch.sqrt(G) * draws["z"]
        return xp * torch.exp(torch.stack([(law.mu + jb) + jn, (law.mu + jb) - jn])), None
    if law.model == "sabr":
        z1 = draws["z1"]
        w2 = law.rho * z1 + law.rho_bar * draws["z2"]
        sv = vp * law.sqrt_dt
        mu = (law.drift - 0.5 * (vp * vp)) * law.dt
        x = xp * torch.exp(torch.stack([mu + sv * z1, mu + sv * -z1]))
        a = vp * torch.exp(torch.stack([law.nu_sqrt_dt * w2 - law.half_nu2_dt,
                                        law.nu_sqrt_dt * -w2 - law.half_nu2_dt]))
        return x, a
    if law.model == "rbergomi":
        sv = torch.sqrt(torch.clamp_min(vp, 0.0))
        mu = (law.drift - 0.5 * vp) * law.dt
        xs, vs = [], []
        for sign in (1.0, -1.0):
            z1, z2, zp = (draws[k] if sign > 0 else -draws[k] for k in ("z1", "z2", "zp"))
            dW = law.sqrt_dt * z1
            xs.append(mu + sv * (law.rho * dW + law.rbsd * zp))
            Y = h + law.sqrt2H * (law.c1 * dW + law.c2 * z2)
            vs.append(law.xi0 * torch.exp(law.eta * Y - comp))
        return xp * torch.exp(torch.stack(xs)), torch.stack(vs)
    if law.jumps:
        n = draws["n"]
        jbase, jnoise = n * law.mu_j, law.sig_j * torch.sqrt(n) * draws["zj"]
    if not law.use_v:
        z = draws["z"]
        up, dn = law.mu + law.a * z, law.mu - law.a * z
        if law.jumps:
            up, dn = up + jbase + jnoise, dn + jbase - jnoise
        return xp * torch.exp(torch.stack([up, dn])), None
    z1 = draws["z1"]
    w2 = law.rho * z1 + law.rho_bar * draws["z2"]
    sv = torch.sqrt(torch.clamp_min(vp, 0.0) * law.dt)
    mu_t = (law.drift - 0.5 * vp) * law.dt - law.comp_dt
    dv = law.kappa * (law.theta - vp) * law.dt
    up, dn = mu_t + sv * z1, mu_t + sv * -z1
    if law.jumps:
        up, dn = up + (jbase + jnoise), dn + (jbase - jnoise)
    x = xp * torch.exp(torch.stack([up, dn]))
    v = torch.clamp_min(torch.stack([vp + dv + law.xi * sv * w2, vp + dv + law.xi * sv * -w2]),
                        0.0)
    return x, v


def date_ce(law: InnerLaw, xp: torch.Tensor, vp: Optional[torch.Tensor], row: torch.Tensor,
            draws: dict, h: Optional[torch.Tensor] = None, comp=None) -> torch.Tensor:
    """E[W_{t+1}(x', v') | x_t, v_t] of one date t (P,), from its draws and
    its policy row (ops/cuda_dual.policy_rows: tau_{t+1}, x_mean, x_rstd,
    v_mean, v_rstd, betas of date t+1): the mean of the n_inner antithetic
    surrogate values (rough Bergomi: ``h``, ``comp`` of date t)."""
    x, v = inner_states_from_draws(law, xp, vp, draws, h, comp)
    tau, b = row[0], row[ROW_HEAD:]
    degree = b.shape[0] - (5 if law.use_v else 2)
    vals = _vhat(x, law.K, law.cp, tau, law.rate, law.q, _floor_vol(law, v, tau), b, row[1],
                 row[2], degree, v=v, vm=row[3], vr=row[4])
    return (vals[0] + vals[1]).mean(0) * 0.5


def dual_ce_from_draws(x: torch.Tensor, v: Optional[torch.Tensor], rows: torch.Tensor,
                       law: InnerLaw, draws_at: Callable[[int], dict],
                       hist: Optional[torch.Tensor] = None,
                       comp: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain inner expectation: ce (n_dates, P), ce[t] = E[W_{t+1} |
    x_t, v_t] for t = 0..n_steps-2 from rows x[t] (x = S / K) [and v[t]],
    the policy rows and the draws ``draws_at(t)`` of each date (the dual's
    Philox stream in kernel 18's plain version; any draws in the tests);
    rough Bergomi also reads hist[t] and comp[t]."""
    return torch.stack([date_ce(law, x[t], None if v is None else v[t], rows[t], draws_at(t),
                                None if hist is None else hist[t],
                                None if comp is None else comp[t])
                        for t in range(rows.shape[0])])


def vg_terminal_from_gamma(law: InnerLaw, x_last: torch.Tensor,
                           gamma: torch.Tensor) -> torch.Tensor:
    """VG's terminal expectation E[h(x_n) | x_{n-1}] (P,): the Black
    expectation given the clock G = nu gamma, averaged over the (half, P)
    standard gamma draws (the reference's Rao-Blackwellisation,
    dual.py:676-686)."""
    G = law.nu * gamma
    return law.K * torch.mean(_one_step_black(x_last[None], law.mu + law.vg_theta * G,
                                              law.vg_sigma * torch.sqrt(torch.clamp_min(G, 1e-20)),
                                              law.cp), dim=0)


def _observed_terms(x: torch.Tensor, v_paths: Optional[torch.Tensor], law: InnerLaw,
                    policy: LSMPolicy, taus: torch.Tensor):
    """(w_vals, e_h) of dual_upper_from_policy on x = S / K (n_steps+1, P)
    [and v]: the surrogate at the observed states of dates 1..n-1 and the
    exact expectation of the terminal payoff from date n-1 (None under VG,
    whose terminal step draws its clock: vg_terminal_from_gamma)."""
    n_steps = x.shape[0] - 1
    use_v = law.use_v
    degree = policy.betas.shape[1] - (5 if use_v else 2)
    K = law.K
    vs = v_paths[1:n_steps] if use_v else None
    w_vals = _vhat(x[1:n_steps], K, law.cp, taus[:, None], law.rate, law.q,
                   _floor_vol(law, vs, taus[:, None]), policy.betas, policy.x_mean[:, None],
                   policy.x_rstd[:, None], degree, v=vs,
                   vm=None if vs is None else policy.v_mean[:, None],
                   vr=None if vs is None else policy.v_rstd[:, None])

    # the terminal step: the one-step conditional law is lognormal given the
    # state (the Poisson mixture of lognormals with the jumps), so W_n = h
    # has a closed-form expectation
    x_last = x[n_steps - 1]
    if law.model == "vg":
        e_h = None
    elif law.model == "sabr":
        a = v_paths[n_steps - 1]
        mu_T = (law.drift - 0.5 * (a * a)) * law.dt
        e_h = K * _one_step_black(x_last, mu_T, torch.clamp_min(a * law.sqrt_dt, 1e-6), law.cp)
    elif law.model == "rbergomi":
        v_nm1 = torch.clamp_min(v_paths[n_steps - 1], 0.0)
        mu_T = (law.drift - 0.5 * v_nm1) * law.dt
        e_h = K * _one_step_black(x_last, mu_T, torch.clamp_min(torch.sqrt(v_nm1 * law.dt), 1e-6),
                                  law.cp)
    elif use_v:
        v_nm1 = torch.clamp_min(v_paths[n_steps - 1], 0.0)
        mu_T = (law.drift - 0.5 * v_nm1) * law.dt - law.comp_dt
        a2_T = torch.clamp_min(v_nm1 * law.dt, 1e-12)
        if law.jumps:
            e_h = K * _one_step_jump_black(x_last, mu_T, a2_T, law.cp, law.lam_dt, law.mu_j,
                                           law.sig_j)
        else:
            e_h = K * _one_step_black(x_last, mu_T, torch.sqrt(a2_T), law.cp)
    elif law.jumps:
        a2 = float(np.float32(law.a) * np.float32(law.a))
        e_h = K * _one_step_jump_black(x_last, _tensor(law.mu, x), _tensor(a2, x),
                                       law.cp, law.lam_dt, law.mu_j, law.sig_j)
    else:
        e_h = K * _one_step_black(x_last, _tensor(law.mu, x), _tensor(law.a, x), law.cp)
    return w_vals, e_h


def _dual_assemble(S_paths: torch.Tensor, spec: OptionSpec, T, w_vals, ce, e_h, eval_mask,
                   stat_pair_block):
    """Martingale increments -> pathwise max -> (upper, stderr): increments
    in discounted units from the observed surrogate values ``w_vals`` (dates
    1..n-1), the inner expectations ``ce`` (dates 0..n-2) and the exact
    terminal expectation ``e_h``."""
    n_steps = S_paths.shape[0] - 1
    dtype, device = S_paths.dtype, S_paths.device
    dt = torch.tensor(T, dtype=dtype, device=device) / n_steps
    steps = torch.arange(1, n_steps + 1, dtype=dtype, device=device)
    disc_pows = torch.exp(-torch.tensor(spec.rate, dtype=dtype, device=device) * dt * steps)
    h_n = vanilla_payoff(S_paths[-1], spec.strike, spec.cp)
    deltas = torch.cat([w_vals - ce, (h_n - e_h)[None]]) * disc_pows[:, None]
    M = torch.cat([torch.zeros_like(deltas[:1]), torch.cumsum(deltas, dim=0)])
    z = vanilla_payoff(S_paths, spec.strike, spec.cp)
    z = z * torch.cat([torch.ones(1, dtype=dtype, device=device), disc_pows])[:, None]
    upper_paths = (z - M).max(dim=0).values
    upper, stderr, _ = masked_mean_stderr(upper_paths, eval_mask, stat_pair_block)
    return upper, stderr


def _inner_tiles(n_paths: int, inner_block: Optional[int]) -> tuple:
    """(tile, n_tiles) of the inner stream: one tile of all paths without
    ``inner_block``."""
    tile = n_paths if inner_block is None else inner_block
    if n_paths % tile:
        raise ValueError(f"paths ({n_paths}) must be a multiple of inner_block ({tile})")
    return tile, n_paths // tile


def _check_draws_device(inner_draws, device) -> None:
    if inner_draws is not None and device.type != "cpu":
        raise ValueError("inner_draws feeds the plain inner expectation on the CPU; on the card "
                         "the dual's inner expectation runs its kernels")


def dual_upper_from_policy(seed: int, S_paths: torch.Tensor, spec: OptionSpec, T,
                           policy: LSMPolicy, *, n_inner: int = 64, model: str = "gbm",
                           heston: Optional[HestonParams] = None,
                           merton: Optional[MertonParams] = None,
                           bates: Optional[BatesParams] = None, vg: Optional[VGParams] = None,
                           sabr: Optional[SABRParams] = None,
                           rbergomi: Optional[RBergomiParams] = None,
                           rb_hist: Optional[torch.Tensor] = None,
                           v_paths: Optional[torch.Tensor] = None,
                           eval_mask: Optional[torch.Tensor] = None,
                           stat_pair_block: Optional[int] = None,
                           inner_block: Optional[int] = None, first_block: int = 0,
                           axis_name=None,
                           inner_draws: Optional[Callable[[int], dict]] = None):
    """Rogers dual upper bound on given paths under a fitted LSM policy.
    Returns (upper, stderr) of E[max_t (D^t h(S_t) - M_t)], the stderr over
    antithetic pair means with ``stat_pair_block``.

    ``seed``: the 64-bit seed of the dual's inner stream, which must be
    independent of the paths' (see the module docstring). ``n_inner``
    antithetic inner draws per (date, path). ``inner_block`` /
    ``first_block``: the stream's tile and the global index of the first
    (one tile of all paths without ``inner_block``). ``model='heston'`` or
    ``'bates'`` needs ``v_paths`` and a policy fitted with them; the inner
    step is the simulator's full-truncation Euler transition, so the dual
    bounds the discretized price. ``model='sabr'`` (beta = 1) takes the
    alpha paths as ``v_paths``; ``model='rbergomi'`` the variance paths and
    ``rb_hist`` from simulate_rbergomi(..., return_dual_state=True), the
    frozen Volterra histories that make the one-step inner law exact under
    rough vol. On a CUDA device the inner expectation is kernel 18
    (ops/cuda_dual.dual_ce, and VG's terminal step dual_vg_terminal); on the
    CPU their plain versions, or ``inner_draws(t)`` (the draws of date t,
    t = n_steps - 1 VG's terminal clock; CPU only) fed to
    ``dual_ce_from_draws``."""
    n_steps = S_paths.shape[0] - 1
    n_dates = n_steps - 1
    if policy.betas.shape[0] != n_dates:
        raise ValueError(f"policy has {policy.betas.shape[0]} dates, paths "
                         f"imply {n_dates}")
    if n_inner < 2 or n_inner % 2:
        raise ValueError("n_inner must be an even count >= 2 (antithetic "
                         "inner pairs)")
    if model not in MODELS:
        raise ValueError(f"model must be 'gbm', 'heston', 'merton', 'bates', "
                         f"'vg', 'sabr' or 'rbergomi', got {model!r}")
    if axis_name is not None:
        raise not_ported("axis_name (path-sharded dual)", "pricers.dual.dual_upper_from_policy")
    use_v = model in STATE_MODELS
    if model == "bates":
        if bates is None:
            raise ValueError("model='bates' needs bates params")
        heston = bates.heston
    if model == "merton" and merton is None:
        raise ValueError("model='merton' needs merton params")
    if model == "vg" and vg is None:
        raise ValueError("model='vg' needs vg params")
    if model == "sabr":
        if sabr is None:
            raise ValueError("model='sabr' needs sabr params")
        if float(sabr.beta) != 1.0:
            raise ValueError("the SABR dual replicates the beta=1 lognormal "
                             "transition; beta<1 uses the absorbing Euler "
                             f"step the one-step law can't match (beta={float(sabr.beta)})")
    if model == "rbergomi":
        if rbergomi is None:
            raise ValueError("model='rbergomi' needs rbergomi params")
        if rb_hist is None:
            raise ValueError("model='rbergomi' needs rb_hist (simulate_rbergomi(..., "
                             "return_dual_state=True)): the frozen Volterra history is what "
                             "makes the one-step inner law exact under rough vol")
    if use_v:
        if v_paths is None or policy.v_mean is None or (
                model in ("heston", "bates") and heston is None):
            raise ValueError(f"model={model!r} needs the variance params, "
                             "v_paths, and a policy fitted with v_paths")
        if spec.sigma is not None:
            raise ValueError("stochastic-vol dual: spec.sigma must be None "
                             "(the variance state drives the vol)")
    if model == "gbm" and spec.sigma is None:
        raise ValueError("the one-step dual increments need spec.sigma (GBM dynamics)")
    device = S_paths.device
    _check_draws_device(inner_draws, device)
    law = inner_law(model, spec, T, n_steps, heston=heston, merton=merton, bates=bates, vg=vg,
                    sabr=sabr, rbergomi=rbergomi)
    x = S_paths / torch.tensor(law.K, dtype=S_paths.dtype, device=device)
    taus = torch.from_numpy(date_taus(T, n_steps)).to(device=device, dtype=S_paths.dtype)
    v_in = v_paths if use_v else None
    w_vals, e_h = _observed_terms(x, v_in, law, policy, taus)
    hist = comp = None
    if model == "rbergomi":
        hist = rb_hist
        comp = torch.from_numpy(rbergomi_comp(rbergomi, T, n_steps)).to(device=device,
                                                                         dtype=S_paths.dtype)

    from options_model_tpu_torch.ops import cuda_dual

    tile, _ = _inner_tiles(x.shape[1], inner_block)
    rows = cuda_dual.policy_rows(policy, taus)
    if inner_draws is not None:
        ce = dual_ce_from_draws(x, v_in, rows, law, inner_draws, hist, comp)
        if model == "vg":
            e_h = vg_terminal_from_gamma(law, x[n_steps - 1], inner_draws(n_dates)["gamma"])
    else:
        ce = cuda_dual.dual_ce(x, v_in, rows, law, seed, first_block, tile, n_inner, hist, comp)
        if model == "vg":
            e_h = cuda_dual.dual_vg_terminal(x[n_steps - 1].contiguous(), law, seed, first_block,
                                             tile, n_inner, n_dates)
    return _dual_assemble(S_paths, spec, T, w_vals, ce, e_h, eval_mask, stat_pair_block)


class NNPolicy(NamedTuple):
    """The shared continuation network as an exercise policy: the trained
    ContinuationMLP plus the feature and target standardization fitted on
    the in-the-money training rows (american._nn_continuation). One net
    serves every date (tau enters through the feature basis)."""

    params: ContinuationMLP
    x_mean: torch.Tensor  # (n_features,)
    x_std: torch.Tensor   # (n_features,)
    y_mean: torch.Tensor  # ()
    y_std: torch.Tensor   # ()
    # True when the net was trained on residual targets over the European
    # baseline: _vhat_nn adds the same baseline back at its states.
    residual: bool = True


def fit_nn_policy(seed: int, S_paths: torch.Tensor, spec: OptionSpec, T, lsm: LSMConfig, *,
                  train_mask: Optional[torch.Tensor] = None,
                  v_paths: Optional[torch.Tensor] = None,
                  heston: Optional[HestonParams] = None):
    """Train the shared continuation net from the 64-bit ``seed`` and return
    (policy, cash): american.lsm_nn_backward's two passes, so ``cash`` is
    that pricer's stopped cash on the same inputs; ``v_paths`` is the 8th
    feature."""
    n_steps = S_paths.shape[0] - 1
    immediate, cont, terminal, ts, net = _nn_continuation(
        seed, S_paths, spec, T, lsm, v_paths, train_mask, return_net=True, heston=heston)
    cash = _nn_stopped_cash(immediate, cont, terminal, ts, spec, T, n_steps)
    return NNPolicy(*net), cash


def nn_policy_from_jax(params, stats, device=None) -> NNPolicy:
    """An NNPolicy from the JAX package's Flax params (numpy arrays,
    regressors.mlp_state_from_flax) and its (x_mean, x_std, y_mean, y_std[,
    residual]), on ``device`` (the card by default). The net's widths are
    read off the params."""
    device = checked_device(device)
    state = mlp_state_from_flax(params)
    n_layers = len(state) // 2
    w0 = state["layers.0.weight"]
    net = ContinuationMLP(w0.shape[1], w0.shape[0], n_layers - 1, device=device)
    net.load_state_dict(state)
    stats = list(stats)
    residual = bool(stats[4]) if len(stats) > 4 else True
    x_mean, x_std, y_mean, y_std = (torch.as_tensor(np.array(s, np.float32), device=device)
                                    for s in stats[:4])
    return NNPolicy(net, x_mean, x_std, y_mean, y_std, residual)


def _vhat_nn(x, K, cp, tau, rate, q, sigma, policy: NNPolicy, lsm=None, v=None):
    """NN value surrogate W_t(x[, v]) = max(h, E_t, clip(net, 0, cap)): the
    polynomial _vhat's construction with the continuation read from the
    shared net on the feature basis it was trained on, gated to the
    in-the-money side and clipped to [0, cap]; with a residual net the
    European baseline (vol ``sigma``) is added back first. ``lsm`` is the
    reference's static net description; the port's net carries it."""
    feats = regression_features(K * x, K, tau)
    if v is not None:
        feats = torch.cat([feats, v[..., None]], dim=-1)
    z = (feats - policy.x_mean) / policy.x_std
    c = mlp_predict(policy.params, z.reshape(-1, z.shape[-1]))
    c = c.reshape(x.shape) * policy.y_std + policy.y_mean
    cap = K * x if cp > 0 else K
    itm_side = cp * (x - 1.0) >= 0.0
    e = bs_price(K * x, K, tau, rate, _tensor(sigma, x), cp, q=q)
    if policy.residual:
        c = e + torch.where(itm_side, torch.clamp_min(c, 0.0), 0.0)
    c = torch.where(itm_side, torch.minimum(torch.clamp_min(c, 0.0), _tensor(cap, c)), 0.0)
    h = K * torch.clamp_min(cp * (x - 1.0), 0.0)
    return torch.maximum(torch.maximum(h, e), c)


def dual_upper_from_nn_policy(seed: int, S_paths: torch.Tensor, spec: OptionSpec, T,
                              policy: NNPolicy, lsm: Optional[LSMConfig] = None, *,
                              n_inner: int = 64, model: str = "gbm",
                              heston: Optional[HestonParams] = None,
                              v_paths: Optional[torch.Tensor] = None,
                              eval_mask: Optional[torch.Tensor] = None,
                              stat_pair_block: Optional[int] = None,
                              inner_block: Optional[int] = None, first_block: int = 0,
                              axis_name=None,
                              inner_draws: Optional[Callable[[int], dict]] = None):
    """Rogers dual upper bound under the shared-net policy:
    dual_upper_from_policy's construction with the continuation read from
    the network at each inner state. The inner states of a chunk of dates
    come from kernel 19 (ops/cuda_dual.dual_inner_states) on the card, its
    plain version on the CPU, or ``inner_draws`` (CPU only); the net runs
    on them as a plain matrix product, NN_CHUNK_ROWS states at a time."""
    n_steps = S_paths.shape[0] - 1
    n_dates = n_steps - 1
    if n_inner < 2 or n_inner % 2:
        raise ValueError("n_inner must be an even count >= 2 (antithetic "
                         "inner pairs)")
    if model not in ("gbm", "heston"):
        raise ValueError(f"model must be 'gbm' or 'heston', got {model!r}")
    if axis_name is not None:
        raise not_ported("axis_name (path-sharded dual)",
                         "pricers.dual.dual_upper_from_nn_policy")
    use_v = model == "heston"
    if use_v:
        if heston is None or v_paths is None:
            raise ValueError("model='heston' needs heston params and "
                             "v_paths")
        if spec.sigma is not None:
            raise ValueError("heston dual: spec.sigma must be None (the "
                             "variance state drives the vol)")
        if int(policy.x_mean.shape[0]) != 8:
            raise ValueError("heston dual needs a policy trained WITH the "
                             "variance feature (8 features, got "
                             f"{int(policy.x_mean.shape[0])})")
    elif spec.sigma is None:
        raise ValueError("the one-step dual increments need spec.sigma (GBM dynamics)")
    device = S_paths.device
    _check_draws_device(inner_draws, device)
    law = inner_law(model, spec, T, n_steps, heston=heston)
    K = law.K
    x = S_paths / torch.tensor(K, dtype=S_paths.dtype, device=device)
    taus = torch.from_numpy(date_taus(T, n_steps)).to(device=device, dtype=S_paths.dtype)
    hp = HestonParams(kappa=law.kappa, theta=law.theta, xi=law.xi, rho=law.rho, v0=law.theta)

    def floor(v, tau):
        return effective_bs_sigma(v, tau, hp) if use_v else float(np.float32(spec.sigma))

    vs = v_paths[1:n_steps] if use_v else None
    w_vals = _vhat_nn(x[1:n_steps], K, law.cp, taus[:, None], law.rate, law.q,
                      floor(vs, taus[:, None]), policy, lsm, v=vs)

    from options_model_tpu_torch.ops import cuda_dual

    tile, _ = _inner_tiles(x.shape[1], inner_block)
    chunk = max(1, NN_CHUNK_ROWS // (n_inner * x.shape[1]))
    v_in = v_paths if use_v else None
    ce = []
    for t0 in range(0, n_dates, chunk):
        dates = range(t0, min(t0 + chunk, n_dates))
        if inner_draws is not None:
            states = [inner_states_from_draws(law, x[t], None if v_in is None else v_in[t],
                                              inner_draws(t)) for t in dates]
            xs = torch.stack([s[0] for s in states])
            vs_in = torch.stack([s[1] for s in states]) if use_v else None
        else:
            xs, vs_in = cuda_dual.dual_inner_states(x, v_in, law, seed, first_block, tile,
                                                    n_inner, t0, len(dates))
        tau = taus[t0:t0 + len(dates)].reshape(-1, 1, 1, 1)
        vals = _vhat_nn(xs, K, law.cp, tau, law.rate, law.q, floor(vs_in, tau), policy, lsm,
                        v=vs_in)
        ce.append((vals[:, 0] + vals[:, 1]).mean(1) * 0.5)
    ce = torch.cat(ce)

    x_last = x[n_steps - 1]
    if use_v:
        v_nm1 = torch.clamp_min(v_paths[n_steps - 1], 0.0)
        mu_T = (law.drift - 0.5 * v_nm1) * law.dt
        a_T = torch.clamp_min(torch.sqrt(v_nm1 * law.dt), 1e-6)
        e_h = K * _one_step_black(x_last, mu_T, a_T, law.cp)
    else:
        e_h = K * _one_step_black(x_last, _tensor(law.mu, x), _tensor(law.a, x), law.cp)
    return _dual_assemble(S_paths, spec, T, w_vals, ce, e_h, eval_mask, stat_pair_block)


class BracketResult(NamedTuple):
    low: torch.Tensor
    low_stderr: torch.Tensor
    high: torch.Tensor
    high_stderr: torch.Tensor


def price_american_bracket(generator: torch.Generator, S0, T, spec: OptionSpec,
                           mc: MCConfig, *, poly_degree: int = 3, engine: str = "auto",
                           n_inner: int = 64, model: str = "gbm",
                           heston: Optional[HestonParams] = None,
                           merton: Optional[MertonParams] = None,
                           bates: Optional[BatesParams] = None, vg: Optional[VGParams] = None,
                           sabr: Optional[SABRParams] = None,
                           rbergomi: Optional[RBergomiParams] = None,
                           lsm: Optional[LSMConfig] = None,
                           out_of_sample: bool = True, device=None) -> BracketResult:
    """Primal-dual bracket [low, high] for an American option on one
    simulation: the policy is fitted on alternating pair blocks
    (american.oos_masks), and the low-biased LSM estimate and the Rogers dual
    upper bound are both evaluated on the other blocks, so the true price
    lies in [low - 2 se, high + 2 se] with high confidence.

    Paths are simulated at simulated_config(mc, model)'s width (whole pair
    blocks). ``generator`` fixes the bracket: the simulation draws the first
    64-bit seed, the dual's inner stream the second, the NN policy's fit
    (``lsm.regressor == 'nn'``, GBM and Heston) the third. Rough Bergomi
    simulates the spot at spec.rate - spec.div_yield with its dual state
    (the frozen Volterra histories). ``lsm`` 'poly' (or None) takes the
    per-date polynomial policy at ``lsm.poly_degree`` (else
    ``poly_degree``). ``out_of_sample=False`` fits and evaluates on every
    path: the dual is then only an approximate bound. Runs on the card
    unless ``device`` asks for the CPU."""
    use_v = model in STATE_MODELS
    use_nn = lsm is not None and getattr(lsm, "regressor", "poly") == "nn"
    if use_nn and model in ("merton", "bates", "vg", "sabr", "rbergomi"):
        raise ValueError("the nn-policy dual supports gbm/heston; use the "
                         "poly policy for the other families")
    if lsm is not None and not use_nn:
        poly_degree = lsm.poly_degree
    if model == "heston" and heston is None:
        raise ValueError("model='heston' needs heston params")
    if model == "bates" and bates is None:
        raise ValueError("model='bates' needs bates params")
    if model == "merton" and merton is None:
        raise ValueError("model='merton' needs merton params")
    if model == "vg" and vg is None:
        raise ValueError("model='vg' needs vg params")
    if model == "sabr" and sabr is None:
        raise ValueError("model='sabr' needs sabr params")
    if model == "rbergomi" and rbergomi is None:
        raise ValueError("model='rbergomi' needs rbergomi params")
    if model == "gbm" and spec.sigma is None:
        raise ValueError("the one-step dual increments need spec.sigma "
                         "(GBM dynamics)")
    device = checked_device(device)
    rb_hist = None
    if model == "rbergomi":
        from options_model_tpu_torch.models.rbergomi import simulate_rbergomi

        S_paths, v_paths, rb_hist = simulate_rbergomi(
            seed_from_generator(generator), S0, T, rbergomi, simulated_config(mc, model),
            rate=spec.rate - spec.div_yield, return_paths=True, return_variance=True,
            return_dual_state=True, device=device)
    else:
        out = simulate_paths(generator, S0, T, simulated_config(mc, model), model,
                             sigma=spec.sigma, rate=spec.rate, heston=heston, merton=merton,
                             bates=bates, vg=vg, sabr=sabr, engine=engine,
                             div_yield=spec.div_yield, return_variance=use_v, device=device)
        S_paths, v_paths = out if use_v else (out, None)
    inner_seed = seed_from_generator(generator)
    pb = _pair_block(mc, model)
    stat_pb = pb if mc.antithetic else None
    n_paths, dtype = S_paths.shape[1], S_paths.dtype
    if out_of_sample:
        if n_paths < 2 * pb:
            raise ValueError("out_of_sample needs at least two path blocks")
        train_mask, eval_mask = oos_masks(n_paths, pb, dtype, device)
    else:
        train_mask = eval_mask = torch.ones(n_paths, dtype=dtype, device=device)

    if use_nn:
        policy, cash = fit_nn_policy(seed_from_generator(generator), S_paths, spec, T, lsm,
                                     train_mask=train_mask if out_of_sample else None,
                                     v_paths=v_paths, heston=heston)
        low, low_se, _ = masked_mean_stderr(cash, eval_mask, stat_pb)
        high, high_se = dual_upper_from_nn_policy(
            inner_seed, S_paths, spec, T, policy, lsm, n_inner=n_inner, model=model,
            heston=heston, v_paths=v_paths, eval_mask=eval_mask, stat_pair_block=stat_pb,
            inner_block=pb)
    else:
        policy, cash = fit_lsm_policy(S_paths, spec, T, poly_degree=poly_degree,
                                      train_mask=train_mask, v_paths=v_paths)
        low, low_se, _ = masked_mean_stderr(cash, eval_mask, stat_pb)
        high, high_se = dual_upper_from_policy(
            inner_seed, S_paths, spec, T, policy, n_inner=n_inner, model=model, heston=heston,
            merton=merton, bates=bates, vg=vg, sabr=sabr, rbergomi=rbergomi, rb_hist=rb_hist,
            v_paths=v_paths, eval_mask=eval_mask, stat_pair_block=stat_pb, inner_block=pb)
    return BracketResult(low=low, low_stderr=low_se, high=high, high_stderr=high_se)
