"""Kernel 18's redesign (csrc/dual.cu dual_ce_kernel) on the host, where no
kernel runs: the algebra of its floor, a float32 mirror of its inner
expectation, and the wrappers of both designs on CPU tensors.

The redesign takes log x' as log xp + e, with e the exponent of the step
that made x' = xp e^e, folds the side s = -cp / sqrt 2 into the floor's
arguments (N(cp d) = erfc(s d) / 2), and, under GBM and Merton, whose
floor vol is a constant, writes s d1 = b (log xp + e) + a0 with a date's
b and a0; under Heston and Bates it takes sigma^2 tau = max(v' frac +
theta (1 - frac), 1e-8) tau + jvar tau directly and gets s d1 and s d2
from one reciprocal square root. In float64 that floor is the surrogate's
Black-Scholes floor (pricers/dual._vhat: bs_price at S = K x' and the
floor vol of pricers/dual._floor_vol) to 1e-12 relative, and the JAX
package's bs_price too; relative to the floor's larger term, since far out
of the money at tau = dt the floor is a difference of two terms ~10^12
times its size in every float64 evaluation of it (bs_price's included). In float32 the mirror below runs the redesign's
operations in its order, each multiply-add as a multiply and an add (the
kernel fuses them, which torch on the CPU does not): its ce stays within
chip_smoke.DUAL_CE_ATOL of the plain version's on the dual's own stream.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import DUAL_CE_ATOL
from options_model_tpu.pricers.blackscholes import bs_price as jax_bs_price
from options_model_tpu_torch.core.config import (BatesParams, HestonParams, MCConfig,
                                                  MertonParams, OptionSpec)
from options_model_tpu_torch.ops import _build, cuda_dual
from options_model_tpu_torch.ops.philox import dual_inner_draws
from options_model_tpu_torch.pricers import american as pa
from options_model_tpu_torch.pricers import dual as pd
from options_model_tpu_torch.pricers.blackscholes import bs_price
from _torch_threads import one_torch_thread  # noqa: F401

S0, K, T, R = 100.0, 100.0, 0.5, 0.05
HESTON = HestonParams(kappa=2.0, theta=0.04, xi=0.3, rho=-0.7, v0=0.04)
MERTON = MertonParams(sigma=0.2, lam=1.0, mu_j=-0.1, sigma_j=0.15)
BATES = BatesParams(heston=HESTON, lam=0.3, mu_j=-0.1, sigma_j=0.15)
PARAMS = dict(heston=HESTON, merton=MERTON, bates=BATES)
MODELS = ("gbm", "heston", "merton", "bates")
# The redesign's floor against bs_price's, both in float64, relative to
# the larger of its two terms; terms that underflow (erfc of ~27 and
# beyond) leave float64's smallest normal number as the absolute slack.
FLOOR_RTOL = 1e-12
TINY = np.finfo(np.float64).tiny
U_CLAMP = 4.0


# One torch intra-op thread for each test: several test workers share the
# machine, and each worker's default pool (a thread a core) oversubscribes the
# cores (as tests/test_torch_dual.py).
# (tests/_torch_threads.py)
pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _spec(model: str, cp: float) -> OptionSpec:
    """A put, or a call on a dividend payer (q enters the floor's c1)."""
    sv = model in ("heston", "bates")
    return OptionSpec(strike=K, rate=R, cp=cp, sigma=None if sv else 0.2,
                      div_yield=0.03 if cp > 0 else 0.0)


def _floor_consts(law: pd.InnerLaw, tau: torch.Tensor) -> dict:
    """csrc/dual.cu floor_consts at remaining maturity ``tau``, in tau's
    dtype, in the kernel's order."""
    def c(value):
        return torch.as_tensor(value, dtype=tau.dtype)

    s = c(-law.cp * 0.70710678118654752)
    half_cp = c(0.5 * law.cp)
    f = dict(s=s, tau=tau, c1=half_cp * c(law.K) * torch.exp(-c(law.q) * tau),
             c2=half_cp * c(law.K) * torch.exp(-c(law.rate) * tau))
    if law.use_v:
        kt = torch.clamp_min(c(law.kappa) * tau, 1e-6)
        f["frac"] = -torch.expm1(-kt) / kt
        f["tf"] = c(law.theta) * (1.0 - f["frac"])
        f["p0"] = c(law.drift) * tau
        f["jtau"] = c(law.jvar) * tau
    else:
        sq = c(law.sig_f) * torch.sqrt(tau)
        f["b"] = s / sq
        f["a0"] = f["b"] * (c(0.5 * law.sig_f) * c(law.sig_f) + c(law.drift)) * tau
        f["g"] = -s * sq
    return f


def _redesign_terms(law: pd.InnerLaw, f: dict, lxp, e, xq, vq):
    """The two terms of the redesign's floor E = c1 x' erfc(g1) - c2
    erfc(g2) at members x' = xp e^e (and v'), log xp = ``lxp``, vhat_fast's
    operations in order."""
    if law.use_v:
        a = f["s"] * (lxp + f["p0"])
        var = torch.clamp_min(vq * f["frac"] + f["tf"], 1e-8)
        w = var * f["tau"] + f["jtau"] if law.jumps else var * f["tau"]
        r = torch.rsqrt(w)
        q = f["s"] * e + a
        g1 = r * ((0.5 * f["s"]) * w + q)
        g2 = r * ((-0.5 * f["s"]) * w + q)
    else:
        a = f["b"] * lxp + f["a0"]
        g1 = f["b"] * e + a
        g2 = g1 + f["g"]
    return (f["c1"] * xq) * torch.special.erfc(g1), f["c2"] * torch.special.erfc(g2)


def _redesign_floor(law: pd.InnerLaw, f: dict, lxp, e, xq, vq):
    t1, t2 = _redesign_terms(law, f, lxp, e, xq, vq)
    return t1 - t2


def _members(model: str, dtype):
    """(xp, e, x', v' or None): previous states across the brackets' range
    and exponents of one step from deep out of the money to deep in it."""
    xp = torch.tensor([0.55, 0.8, 0.97, 1.0, 1.03, 1.25, 1.6], dtype=dtype)[:, None, None]
    e = torch.linspace(-0.35, 0.35, 15, dtype=dtype)[None, :, None]
    xp, e = torch.broadcast_tensors(xp, e)
    vq = None
    if model in ("heston", "bates"):
        vq = torch.tensor([0.0, 1e-9, 0.004, 0.04, 0.15, 0.6], dtype=dtype)
        xp, e, vq = (t.contiguous() for t in torch.broadcast_tensors(xp, e, vq.view(1, 1, 6)))
    return xp, e, xp * torch.exp(e), vq


@pytest.mark.parametrize("cp", [-1.0, 1.0])
@pytest.mark.parametrize("model", MODELS)
def test_redesign_floor_algebra_float64(model, cp):
    """At every date tau of a 50-step bracket (the last is tau = dt), both
    sides and members across the in- and out-of-the-money range, the
    redesign's floor is _vhat's bs_price floor (S = K x', _floor_vol's vol)
    to 1e-12 relative in float64, and the JAX package's bs_price at the
    same vol."""
    law = pd.inner_law(model, _spec(model, cp), T, 50, **PARAMS)
    xp, e, xq, vq = _members(model, torch.float64)
    lxp = torch.log(xp)
    for tau in pd.date_taus(T, 50).astype(np.float64):
        t = torch.tensor(tau, dtype=torch.float64)
        t1, t2 = _redesign_terms(law, _floor_consts(law, t), lxp, e, xq, vq)
        got, scale = (t1 - t2).numpy(), torch.maximum(t1.abs(), t2.abs()).numpy()
        sigma = torch.as_tensor(pd._floor_vol(law, vq, t), dtype=torch.float64)
        want = bs_price(K * xq, K, t, law.rate, sigma, law.cp, q=law.q).numpy()
        with jax.enable_x64(True):
            ref = np.asarray(jax_bs_price(jnp.asarray(K * xq.numpy()), K, tau, law.rate,
                                          jnp.asarray(np.broadcast_to(sigma.numpy(), xq.shape)),
                                          law.cp, q=law.q))
        for other in (want, ref):
            err = np.abs(got - other)
            assert np.all(err <= FLOOR_RTOL * scale + TINY), (tau, np.max(err / (scale + TINY)))
        assert np.all(got >= -FLOOR_RTOL * scale - TINY) and got.max() > 1.0


def _step_exponents(law: pd.InnerLaw, vp, draws: dict):
    """The exponents (2, half, P) of the inner states' x' = xp e^e, up
    member first: inner_states_from_draws' (csrc/dual.cu step_pair's)
    operations up to the exp."""
    if law.jumps:
        n = draws["n"]
        jbase, jnoise = n * law.mu_j, law.sig_j * torch.sqrt(n) * draws["zj"]
    if not law.use_v:
        z = draws["z"]
        up, dn = law.mu + law.a * z, law.mu - law.a * z
        if law.jumps:
            up, dn = up + jbase + jnoise, dn + jbase - jnoise
        return torch.stack([up, dn])
    z1 = draws["z1"]
    sv = torch.sqrt(torch.clamp_min(vp, 0.0) * law.dt)
    mu_t = (law.drift - 0.5 * vp) * law.dt - law.comp_dt
    up, dn = mu_t + sv * z1, mu_t + sv * -z1
    if law.jumps:
        up, dn = up + (jbase + jnoise), dn + (jbase - jnoise)
    return torch.stack([up, dn])


def _mirror_date_ce(law: pd.InnerLaw, xp, vp, row, draws):
    """The redesign's ce of one date in float32: the states as the plain
    version makes them (bit for bit, the kernel's too), then vhat_fast's
    floor, Horner polynomial, branch-free gate and clip, and the sum over
    the pairs in the kernel's order."""
    x, v = pd.inner_states_from_draws(law, xp, vp, draws)
    e = _step_exponents(law, vp, draws)
    assert torch.equal(x, xp * torch.exp(e))  # log x' = log xp + e
    f = _floor_consts(law, row[0])
    b = row[pd.ROW_HEAD:]
    degree = b.shape[0] - (5 if law.use_v else 2)
    floor = _redesign_floor(law, f, torch.log(xp), e, x, v)
    u = torch.clamp(x * row[2] + (-row[1] * row[2]), -U_CLAMP, U_CLAMP)
    c = b[degree] * torch.ones_like(u)
    for i in range(degree - 1, -1, -1):
        c = c * u + b[i]
    xm1 = x - 1.0
    c = b[degree + 1] * torch.clamp_min(xm1, 0.0) + c
    if law.use_v:
        w = torch.clamp(v * row[4] + (-row[3] * row[4]), -U_CLAMP, U_CLAMP)
        c = w * (b[degree + 3] * w + (b[degree + 4] * u + b[degree + 2])) + c
    h = law.K * torch.clamp_min(xm1 if law.cp > 0 else -xm1, 0.0)
    itm = xm1 >= 0.0 if law.cp > 0 else xm1 <= 0.0
    cap = torch.where(itm, law.K * x if law.cp > 0 else torch.full_like(x, law.K), 0.0)
    vals = torch.maximum(floor, torch.minimum(torch.maximum(c, h), cap))
    acc = torch.zeros_like(xp)
    for k in range(vals.shape[1]):
        acc = acc + (vals[0, k] + vals[1, k])
    return acc / vals.shape[1] * 0.5


def _case(model: str, cp: float, degree: int = 3):
    """x = S / K (and v) of the port's own simulation (2048 x 12, pair
    blocks of 512), a policy fitted on them, its rows and the law."""
    spec = _spec(model, cp)
    sv = model in ("heston", "bates")
    mc = MCConfig(n_paths=2048, n_steps=12, path_block=512)
    out = pa.simulate_paths(torch.Generator().manual_seed(1), S0, T, mc, model, sigma=spec.sigma,
                            rate=R, div_yield=spec.div_yield, return_variance=sv, device="cpu",
                            **PARAMS)
    S, v = out if sv else (out, None)
    policy, _ = pd.fit_lsm_policy(S, spec, T, v_paths=v, poly_degree=degree)
    law = pd.inner_law(model, spec, T, mc.n_steps, **PARAMS)
    rows = cuda_dual.policy_rows(policy, torch.from_numpy(pd.date_taus(T, mc.n_steps)))
    return (S / K).contiguous(), v, rows, law


@pytest.mark.parametrize("model,cp,degree", [(m, cp, 3) for m in MODELS for cp in (-1.0, 1.0)]
                         + [("gbm", -1.0, 5), ("bates", 1.0, 2)])
def test_float32_mirror_within_gate(model, cp, degree):
    """The float32 mirror of the redesign's ce is within DUAL_CE_ATOL of
    the plain version's (date_ce) on the dual's Philox stream at n_inner
    64, every date, both sides, at degree 3 (the brackets' default) and at
    degrees 5 and 2."""
    x, v, rows, law = _case(model, cp, degree)
    seed, tile, half = 0xABCDEF, 512, 32
    for t in range(rows.shape[0]):
        draws = dual_inner_draws(seed, 0, x.shape[1] // tile, tile, half, model, t, law.lam_dt)
        vp = None if v is None else v[t]
        want = pd.date_ce(law, x[t], vp, rows[t], draws)
        got = _mirror_date_ce(law, x[t], vp, rows[t], draws)
        assert bool(torch.isfinite(got).all())
        err = float((got - want).abs().max())
        assert err <= DUAL_CE_ATOL, (t, err)


@pytest.mark.parametrize("model", MODELS)
def test_both_designs_on_cpu_are_plain(model):
    """On CPU tensors dual_ce (the redesign) and dual_ce_first (the first
    design) are dual_ce_reference bit for bit and launch nothing: their
    counters stay at 0. A tensor on another device goes to the kernels and
    raises."""
    x, v, rows, law = _case(model, -1.0)
    args = (0xABCDEF, 0, 512, 6)
    before = dict(cuda_dual.launches)
    ref = cuda_dual.dual_ce_reference(x, v, rows, law, *args)
    for fn in (cuda_dual.dual_ce, cuda_dual.dual_ce_first):
        assert torch.equal(fn(x, v, rows, law, *args), ref)
    assert cuda_dual.launches == before
    assert {"dual_ce", "dual_ce_first", "dual_inner_states"} <= set(cuda_dual.launches)
    meta = x.to("meta")
    with pytest.raises(ValueError, match="CUDA device"):
        cuda_dual.dual_ce_first(meta, None if v is None else v.to("meta"), rows, law, *args)


def test_first_design_entry_registered():
    """omt_dual_ce_first takes omt_dual_ce's arguments: every pointer and
    the stream a c_void_p (ctypes would cut a plain int to 32 bits), the
    seed a c_uint64."""
    sig = _build._SIGNATURES["omt_dual_ce_first"]
    assert sig == _build._SIGNATURES["omt_dual_ce"]
    assert sig[:7] == [_build.ctypes.c_void_p] * 7 and sig[-1] is _build.ctypes.c_void_p
    assert sig[7] is _build.ctypes.c_uint64 and len(sig) == 17


def test_upper_terms_split_is_the_dual():
    """dual_upper_from_policy is _observed_terms, kernel 18's ce and
    _dual_assemble: assembled by hand from the plain ce on the same stream
    it gives the same (upper, stderr) bit for bit (chip_smoke.py assembles
    both designs' uppers this way)."""
    x, v, rows, law = _case("heston", -1.0)
    spec = _spec("heston", -1.0)
    S = x * K
    policy, _ = pd.fit_lsm_policy(S, spec, T, v_paths=v)
    rows = cuda_dual.policy_rows(policy, torch.from_numpy(pd.date_taus(T, 12)))
    _, evm = pa.oos_masks(S.shape[1], 512)
    up, se = pd.dual_upper_from_policy(77, S, spec, T, policy, n_inner=8, model="heston",
                                       heston=HESTON, v_paths=v, eval_mask=evm,
                                       stat_pair_block=512, inner_block=512)
    taus = torch.from_numpy(pd.date_taus(T, 12))
    x = S / torch.tensor(law.K, dtype=S.dtype)
    w_vals, e_h = pd._observed_terms(x, v, law, policy, taus)
    ce = cuda_dual.dual_ce_first(x, v, rows, law, 77, 0, 512, 8)
    got = pd._dual_assemble(S, spec, T, w_vals, ce, e_h, evm, 512)
    assert torch.equal(got[0], up) and torch.equal(got[1], se)
    assert math.isfinite(float(up)) and float(se) > 0
