"""The martingale dual's Variance Gamma, SABR and rough Bergomi families
(pricers/dual.py, kernel 18's plain versions in ops/cuda_dual.py, the dual
stream's new draws in ops/philox.py) held against the JAX package on the
CPU.

Tolerances, each with its reason:
- (upper, stderr) of dual_upper_from_policy on the JAX package's paths, its
  fitted policy (lsm_policy_from_jax) and its inner draws (its
  _inner_normals / _inner_gamma under fold_in(inner_key, date), VG's
  terminal clock under fold_in(inner_key, n_dates)) against its own: rtol
  2e-5 (test_torch_dual.py's 2e-6 for GBM-Heston-Merton-Bates, wider here:
  XLA on the CPU contracts the inner steps' multiply-adds, and the rough
  Bergomi and SABR states pass through two exp each, so a state can sit an
  ulp apart and move a surrogate evaluation by its float32 rounding).
- The dual stream's clock draws against scipy.stats.gamma at the brackets'
  shapes (a = dt/nu = 0.0714 at D6, 0.0286 at the full-width bracket, and
  0.01) over 2^17 draws: mean, variance and the CDF at the 0.5, 0.75 and
  0.95 quantiles within 4 standard errors; the share of float32 zeros
  against the law's mass below 2^-150 within 4 standard errors.
- Layout, chunks, the CPU wrappers and the reference's rejections: bit for
  bit, or the reference's exception.
The H = 1/2 bracket against the drift-extended ADI at the JAX test's
configuration (2^15 x 40, n_inner 64) takes ~25 s on the CPU: it is marked
slow, and chip_smoke.py's D8 runs it on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from options_model_tpu.core.config import PUT
from options_model_tpu.core.config import MCConfig as JMCConfig
from options_model_tpu.core.config import OptionSpec as JOptionSpec
from options_model_tpu.core.config import RBergomiParams as JRBergomiParams
from options_model_tpu.core.config import SABRParams as JSABRParams
from options_model_tpu.core.config import VGParams as JVGParams
from options_model_tpu.models import rbergomi as jrb
from options_model_tpu.pricers import american as ja
from options_model_tpu.pricers import dual as jd
from options_model_tpu_torch.core.config import (LSMConfig, MCConfig, OptionSpec,
                                                  RBergomiParams, SABRParams, VGParams)
from options_model_tpu_torch.ops import cuda_dual
from options_model_tpu_torch.ops.philox import (DUAL_GAMMA_STREAM, DUAL_STREAM,
                                                VG_MAX_ATTEMPTS, box_muller, dual_calls,
                                                dual_gamma_draws, dual_inner_draws,
                                                gamma_constants, stream_words,
                                                uniform_from_bits)
from options_model_tpu_torch.pricers import american as pa
from options_model_tpu_torch.pricers import dual as pd
from _torch_threads import one_torch_thread_module  # noqa: F401

S0, K, T, R = 100.0, 100.0, 0.5, 0.05
J_MC = JMCConfig(n_paths=4096, n_steps=10, path_block=1024)
PB = 1024
N_INNER = 8
DUAL_RTOL = 2e-5
SEED = 0x9E3779B97F4A7C15
J_PARAMS = {"vg": JVGParams(sigma=0.18, theta=-0.14, nu=0.35),
            "sabr": JSABRParams(alpha=0.2, beta=1.0, rho=-0.4, nu=0.6),
            "rbergomi": JRBergomiParams(H=0.1, eta=1.5, rho=-0.7, xi0=0.04),
            "rbergomi_half": JRBergomiParams(H=0.5, eta=1.0, rho=-0.5, xi0=0.04)}
PARAMS = {"vg": VGParams, "sabr": SABRParams, "rbergomi": RBergomiParams,
          "rbergomi_half": RBergomiParams}

pytestmark = pytest.mark.usefixtures("one_torch_thread_module")


def _t(a):
    return torch.from_numpy(np.array(a))


def _family(case: str) -> str:
    return "rbergomi" if case.startswith("rbergomi") else case


@pytest.fixture(scope="module")
def jax_paths():
    """Each family's paths from the JAX package (J_MC, T), the spot under the
    risk-neutral drift: (S, v or alpha or None, rb_hist or None)."""
    out = {}
    for case, p in J_PARAMS.items():
        key = jax.random.key(3)
        if case.startswith("rbergomi"):
            out[case] = tuple(np.asarray(a) for a in jrb.simulate_rbergomi(
                key, S0, T, p, J_MC, rate=R, return_paths=True, return_variance=True,
                return_dual_state=True))
        elif case == "sabr":
            S, a = ja.simulate_paths(key, S0, T, J_MC, "sabr", rate=R, sabr=p,
                                     return_variance=True)
            out[case] = (np.asarray(S), np.asarray(a), None)
        else:
            out[case] = (np.asarray(ja.simulate_paths(key, S0, T, J_MC, "vg", rate=R, vg=p)),
                         None, None)
    return out


def _jax_draws(inner_key, model: str, n_paths: int, half: int, alpha, n_dates: int):
    """The JAX package's inner draws of date i, as its dual draws them
    (dual.py:500-544, 640-686), in the port's draws dict; VG's terminal
    clock at i = n_dates."""
    def at(i):
        dkey = jax.random.fold_in(inner_key, i)
        if model == "vg":
            if i == n_dates:
                return {"gamma": _t(jd._inner_gamma(dkey, (half,), n_paths, PB, 0, alpha,
                                                    jnp.float32))}
            return {"z": _t(jd._inner_normals(dkey, (half,), n_paths, PB, 0, jnp.float32)),
                    "gamma": _t(jd._inner_gamma(jax.random.fold_in(dkey, 1), (half,), n_paths,
                                                PB, 0, alpha, jnp.float32))}
        lead = (3, half) if model == "rbergomi" else (2, half)
        z = np.asarray(jd._inner_normals(dkey, lead, n_paths, PB, 0, jnp.float32))
        names = ("z1", "z2", "zp") if model == "rbergomi" else ("z1", "z2")
        return {k: _t(z[j]) for j, k in enumerate(names)}

    return at


@pytest.mark.parametrize("case, cp", [("vg", PUT), ("vg", 1.0), ("sabr", PUT), ("sabr", 1.0),
                                      ("rbergomi", PUT), ("rbergomi_half", PUT)])
def test_dual_upper_matches_jax_on_shared_draws(jax_paths, case, cp):
    model = _family(case)
    S, v, hist = jax_paths[case]
    spec = JOptionSpec(strike=K, rate=R, cp=cp)
    jp = J_PARAMS[case]
    train, evm = ja.oos_masks(S.shape[1], PB)
    pol, _ = jd.fit_lsm_policy(jnp.asarray(S), spec, T, train_mask=train,
                               v_paths=None if v is None else jnp.asarray(v))
    inner_key = jax.random.key(17)
    kw = dict(n_inner=N_INNER, model=model, eval_mask=evm, stat_pair_block=PB, inner_block=PB)
    extra_j = {"rb_hist": jnp.asarray(hist)} if hist is not None else {}
    up, se = jd.dual_upper_from_policy(inner_key, jnp.asarray(S), spec, T, pol,
                                       v_paths=None if v is None else jnp.asarray(v),
                                       **{model: jp}, **extra_j, **kw)
    alpha = None
    if model == "vg":
        alpha = (jnp.asarray(T, jnp.float32) / J_MC.n_steps) / jnp.asarray(jp.nu, jnp.float32)
    n_dates = J_MC.n_steps - 1
    draws = _jax_draws(inner_key, model, S.shape[1], N_INNER // 2, alpha, n_dates)
    kw["eval_mask"] = _t(evm)
    extra = {"rb_hist": _t(hist)} if hist is not None else {}
    got_up, got_se = pd.dual_upper_from_policy(
        0, _t(S), OptionSpec.from_reference(vars(spec)), T,
        pd.lsm_policy_from_jax(pol, device="cpu"), v_paths=None if v is None else _t(v),
        inner_draws=draws, **{model: PARAMS[case].from_reference(vars(jp))}, **extra, **kw)
    np.testing.assert_allclose(float(got_up), float(up), rtol=DUAL_RTOL)
    np.testing.assert_allclose(float(got_se), float(se), rtol=DUAL_RTOL)


@pytest.mark.parametrize("model", ["vg", "sabr", "rbergomi"])
def test_inner_law_constants_are_the_references(model):
    """The law's float32 constants (pricers/dual.inner_law) as the
    reference's traced ones: VG's drift (r - q + omega) dt and floor vol,
    the gamma shape dt / nu; SABR's nu sqrt(dt) and nu^2 dt / 2; rough
    Bergomi's sqrt(2H), c1, c2 and compensator."""
    f = np.float32
    spec = OptionSpec(strike=K, rate=R, cp=PUT, div_yield=0.01)
    p = PARAMS[model].from_reference(vars(J_PARAMS[model]))
    law = pd.inner_law(model, spec, T, 10, **{model: p})
    dt = f(T) / f(10)
    assert law.dt == float(dt) and law.sqrt_dt == float(np.sqrt(dt))
    assert law.use_v == (model != "vg")
    if model == "vg":
        sig, th, nu = f(0.18), f(-0.14), f(0.35)
        om = np.float32(np.log1p(-th * nu - f(0.5) * sig * sig * nu) / nu)
        assert law.mu == pytest.approx(float((f(R) - f(0.01) + om) * dt), rel=1e-6)
        assert law.gamma_shape == float(dt / nu)
        g = gamma_constants(law.gamma_shape)
        assert (law.gamma_d, law.gamma_c, law.gamma_inv_a) == (float(g["d"]), float(g["c"]),
                                                               float(g["inv_a"]))
    elif model == "sabr":
        assert law.nu_sqrt_dt == float(f(0.6) * np.sqrt(dt))
        assert law.half_nu2_dt == float(f(0.5) * (f(0.6) * f(0.6)) * dt)
    else:
        _, c1, c2, var = jrb._hybrid_weights(10, 0.1, T / 10)
        assert (law.c1, law.c2) == (float(f(c1)), float(f(c2)))
        assert law.sqrt2H == float(f(np.sqrt(0.2)))
        comp = pd.rbergomi_comp(p, T, 10)
        assert np.array_equal(comp, (f(0.5) * (f(1.5) * f(1.5))) * var[1:10].astype(f))
    vals = np.ctypeslib.as_array(cuda_dual.law_args(law))
    assert vals[:len(cuda_dual.LAW_FIELDS)].tolist() == [getattr(law, k)
                                                         for k in cuda_dual.LAW_FIELDS]


@pytest.mark.parametrize("a", [1 / 14, 0.01 / 0.35, 0.01])
def test_dual_clock_has_the_gamma_law(a):
    g, att = dual_gamma_draws(SEED + int(a * 1000), 0, 4, 4096, 8, 3, a)
    x = g.double().numpy().ravel()
    n = x.size
    assert g.shape == (8, 4 * 4096) and att.dtype == torch.int32
    assert np.all(np.isfinite(x)) and x.min() >= 0.0 and int(att.max()) < VG_MAX_ATTEMPTS
    assert abs(x.mean() - a) < 4 * np.sqrt(a / n)
    assert abs(x.var() - a) < 4 * np.sqrt((2 * a * a + 6 * a) / n)
    law = stats.gamma(a)
    for p in (0.5, 0.75, 0.95):
        assert abs((x <= law.ppf(p)).mean() - p) < 4 * np.sqrt(p * (1 - p) / n), p
    zeros = law.cdf(2.0 ** -150)
    assert abs((x == 0.0).mean() - zeros) <= 4 * np.sqrt(zeros * (1 - zeros) / n) + 1e-12


def test_dual_clock_counters():
    """A draw is a function of (seed, tile, date, pair, attempt): attempt k
    of pair i at date t is the call (slot, (t half + i) VG_MAX_ATTEMPTS + k,
    tile, DUAL_GAMMA_STREAM); a draw accepted at attempt 0 is d v of that
    call's words; a first_tile chunk draws its tiles of the full run bit
    for bit; the pair's two members share it (the inner states)."""
    half, date, a = 5, 3, 1 / 14
    g, att = dual_gamma_draws(SEED, 0, 2, 64, half, date, a)
    gp, attp = dual_gamma_draws(SEED, 1, 1, 64, half, date, a)
    assert torch.equal(g[:, 64:], gp) and torch.equal(att[:, 64:], attp)
    k = gamma_constants(a)
    words = stream_words(SEED, 0, 2, 64, (date * half + half) * VG_MAX_ATTEMPTS,
                         stream=DUAL_GAMMA_STREAM)
    for i in range(half):
        w = words[(date * half + i) * VG_MAX_ATTEMPTS]
        x = box_muller(uniform_from_bits(w[0]), uniform_from_bits(w[1]))[0]
        v1 = 1.0 + torch.tensor(k["c"]) * x
        dv = torch.tensor(k["d"]) * (v1 * v1 * v1)
        boost = torch.exp(torch.log(dv) + torch.log(uniform_from_bits(w[3]))
                          * torch.tensor(k["inv_a"]))
        first = att[i] == 0
        assert bool(first.any()) and torch.equal(g[i][first], boost[first])
    law = pd.inner_law("vg", OptionSpec(strike=K, rate=R, cp=PUT), T, 10,
                       vg=VGParams(0.18, -0.14, 0.35))
    x = torch.full((11, 128), 1.0)
    xs, Gs, cn = cuda_dual.dual_inner_states_reference(x, None, law, SEED, 0, 64, 2 * half, date,
                                                       1, True)
    gd, ad = dual_gamma_draws(SEED, 0, 2, 64, half, date, law.gamma_shape)
    assert torch.equal(Gs[0, 0], law.nu * gd) and torch.equal(Gs[0, 1], Gs[0, 0])
    assert torch.equal(cn[0], ad)


def test_dual_stream_layout_of_the_new_families():
    """VG's normals are GBM's and SABR's Heston's bit for bit (the same
    calls); rough Bergomi takes one call a pair, (w0, w1) -> (z1, z2), (w2,
    w3) -> (zp, unused); every family counts the jump calls of a date."""
    half, date = 6, 2
    assert dual_calls("vg", half) == (2, 0, 5) and dual_calls("sabr", half) == (3, 0, 6)
    assert dual_calls("rbergomi", half) == (6, 0, 9) and dual_calls("rbergomi", 1) == (1, 0, 2)
    g = dual_inner_draws(SEED, 0, 1, 64, half, "gbm", date)
    v = dual_inner_draws(SEED, 0, 1, 64, half, "vg", date, gamma_shape=0.05)
    assert torch.equal(v["z"], g["z"]) and set(v) == {"z", "gamma", "attempts"}
    h = dual_inner_draws(SEED, 0, 1, 64, half, "heston", date)
    s = dual_inner_draws(SEED, 0, 1, 64, half, "sabr", date)
    assert all(torch.equal(s[k], h[k]) for k in ("z1", "z2")) and set(s) == {"z1", "z2"}
    r = dual_inner_draws(SEED, 0, 1, 64, half, "rbergomi", date)
    calls = dual_calls("rbergomi", half)[2]
    words = stream_words(SEED, 0, 1, 64, (date + 1) * calls, stream=DUAL_STREAM)
    for i in range(half):
        u = [uniform_from_bits(words[date * calls + i, j]) for j in range(4)]
        z1, z2 = box_muller(u[0], u[1])
        assert torch.equal(r["z1"][i], z1) and torch.equal(r["z2"][i], z2)
        assert torch.equal(r["zp"][i], box_muller(u[2], u[3])[0])
    for model in ("vg", "sabr", "rbergomi"):
        full = dual_inner_draws(SEED, 0, 4, 256, 5, model, 3, gamma_shape=0.1)
        part = dual_inner_draws(SEED, 2, 2, 256, 5, model, 3, gamma_shape=0.1)
        assert all(torch.equal(full[k][:, 512:], part[k]) for k in full)


def _port_case(model: str, n_steps: int = 8, cp: float = PUT):
    """A small bracket's inputs on the port's own paths (CPU)."""
    params = {"vg": VGParams(0.18, -0.14, 0.35), "sabr": SABRParams(0.2, 1.0, -0.4, 0.6),
              "rbergomi": RBergomiParams(0.1, 1.5, -0.7, 0.04)}[model]
    spec = OptionSpec(strike=K, rate=R, cp=cp)
    mc = MCConfig(n_paths=8192, n_steps=n_steps)
    gen = torch.Generator().manual_seed(4)
    if model == "rbergomi":
        from options_model_tpu_torch.models.rbergomi import simulate_rbergomi
        S, v, hist = simulate_rbergomi(11, S0, T, params, mc, R, return_paths=True,
                                       return_variance=True, return_dual_state=True,
                                       device="cpu")
    else:
        out = pa.simulate_paths(gen, S0, T, mc, model, rate=R, return_variance=model == "sabr",
                                device="cpu", **{model: params})
        (S, v), hist = (out if model == "sabr" else (out, None)), None
    policy, _ = pd.fit_lsm_policy(S, spec, T, v_paths=v)
    return S, v, hist, spec, policy, params


@pytest.mark.parametrize("model", ["vg", "sabr", "rbergomi"])
def test_cpu_wrappers_are_plain_and_launch_nothing(model):
    S, v, hist, spec, policy, params = _port_case(model)
    law = pd.inner_law(model, spec, T, 8, **{model: params})
    taus = torch.from_numpy(pd.date_taus(T, 8))
    rows = cuda_dual.policy_rows(policy, taus)
    comp = (torch.from_numpy(pd.rbergomi_comp(params, T, 8)) if model == "rbergomi" else None)
    x = S / K
    args = (SEED, 0, 4096, 8, hist, comp)
    before = dict(cuda_dual.launches)
    ce = cuda_dual.dual_ce(x, v, rows, law, *args)
    assert torch.equal(ce, cuda_dual.dual_ce_reference(x, v, rows, law, *args))
    assert ce.shape == (7, 8192) and bool(torch.isfinite(ce).all())
    if model == "vg":
        xl = x[7].contiguous()
        eh = cuda_dual.dual_vg_terminal(xl, law, SEED, 0, 4096, 8, 7)
        assert torch.equal(eh, cuda_dual.dual_vg_terminal_reference(xl, law, SEED, 0, 4096, 8, 7))
        gamma, _ = dual_gamma_draws(SEED, 0, 2, 4096, 4, 7, law.gamma_shape)
        assert torch.equal(eh, pd.vg_terminal_from_gamma(law, xl, gamma))
    assert cuda_dual.launches == before
    with pytest.raises(ValueError, match="first design takes"):
        cuda_dual.dual_ce_first(x, v, rows, law, SEED, 0, 4096, 8)
    meta = x.to("meta")
    with pytest.raises(ValueError, match="CUDA device"):
        cuda_dual.dual_ce(meta, None if v is None else v.to("meta"), rows, law, *args)
    if model == "rbergomi":
        with pytest.raises(ValueError, match="hist and comp"):
            cuda_dual.dual_ce(x, v, rows, law, SEED, 0, 4096, 8)
    up, se = pd.dual_upper_from_policy(SEED, S, spec, T, policy, n_inner=8, model=model,
                                       v_paths=v, rb_hist=hist, inner_block=4096,
                                       **{model: params})
    assert np.isfinite(float(up)) and float(se) > 0


def test_reference_rejections():
    S, v, hist, spec, policy, params = _port_case("rbergomi")
    with pytest.raises(ValueError, match="needs rb_hist"):
        pd.dual_upper_from_policy(0, S, spec, T, policy, model="rbergomi", rbergomi=params,
                                  v_paths=v)
    with pytest.raises(ValueError, match="spec.sigma must be None"):
        pd.dual_upper_from_policy(0, S, OptionSpec(strike=K, rate=R, cp=PUT, sigma=0.2), T,
                                  policy, model="rbergomi", rbergomi=params, v_paths=v,
                                  rb_hist=hist)
    with pytest.raises(ValueError, match="v_paths"):
        pd.dual_upper_from_policy(0, S, spec, T, policy, model="rbergomi", rbergomi=params,
                                  rb_hist=hist)
    S, v, _, spec, policy, params = _port_case("sabr")
    with pytest.raises(ValueError, match="beta=1"):
        pd.dual_upper_from_policy(0, S, spec, T, policy, model="sabr", v_paths=v,
                                  sabr=SABRParams(0.2, 0.7, -0.4, 0.6))
    with pytest.raises(ValueError, match="needs vg params"):
        pd.dual_upper_from_policy(0, S, spec, T, policy, model="vg")


@pytest.mark.parametrize("model", ["vg", "sabr", "rbergomi"])
def test_brackets_run_on_the_cpu(model):
    """price_american_bracket end to end on the CPU at 8192 x 8, n_inner 8:
    ordered (high above low less 3 stderr), finite."""
    params = {"vg": VGParams(0.18, -0.14, 0.35), "sabr": SABRParams(0.2, 1.0, -0.4, 0.6),
              "rbergomi": RBergomiParams(0.1, 1.5, -0.7, 0.04)}[model]
    br = pd.price_american_bracket(torch.Generator().manual_seed(5), S0, T,
                                   OptionSpec(strike=K, rate=R, cp=PUT), MCConfig(8192, 8),
                                   model=model, n_inner=8, device="cpu", **{model: params})
    lo, lse, hi, hse = (float(t) for t in br)
    assert all(np.isfinite((lo, lse, hi, hse))) and hi + 3 * hse > lo
    with pytest.raises(ValueError, match="nn-policy"):
        pd.price_american_bracket(torch.Generator(), S0, T, OptionSpec(strike=K, rate=R, cp=PUT),
                                  MCConfig(8192, 8), model=model, lsm=LSMConfig(regressor="nn"),
                                  device="cpu", **{model: params})


@pytest.mark.slow
def test_h_half_bracket_contains_the_drift_adi():
    """tests/test_dual.py:512-530 on the port: rBergomi at H = 1/2 is
    SABR(beta 1, nu eta/2) with alpha drift -eta^2/8; the drift-extended
    ADI must lie inside the 3-stderr bracket, at most 5% wide. The width
    bar is tight for any one seed: on the CPU the ADI sat inside at seeds
    1-5, 9 and 83, the widths 3.96-4.73% but 5.15% at seed 9. Seed 83 is
    chip_smoke.py's D8, the same bracket on the card (4.13% there)."""
    from options_model_tpu_torch.pricers.fd_sabr import sabr_fd_price

    rb = RBergomiParams(H=0.5, eta=1.0, rho=-0.5, xi0=0.04)
    br = pd.price_american_bracket(torch.Generator().manual_seed(83), S0, T,
                                   OptionSpec(strike=K, rate=R, cp=PUT),
                                   MCConfig(n_paths=1 << 15, n_steps=40, path_block=2048),
                                   model="rbergomi", rbergomi=rb, device="cpu")
    fd = sabr_fd_price(S0, K, T, R, SABRParams(alpha=0.2, beta=1.0, rho=-0.5, nu=0.5), cp=-1.0,
                       alpha_drift=-1.0 / 8)
    lo = float(br.low) - 3 * float(br.low_stderr)
    hi = float(br.high) + 3 * float(br.high_stderr)
    assert lo <= fd <= hi and (hi - lo) / fd < 0.05, (lo, fd, hi)
