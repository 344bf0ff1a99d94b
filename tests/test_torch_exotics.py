"""The path-dependent exotics of the port on the CPU: the barrier masks
(core/payoff.py), the Asian and lookback pricers (pricers/exotics.py), the
barrier pricer and Reiner-Rubinstein (pricers/barrier.py), the American
Asian LSM (pricers/american_asian.py) and its Hull-White lattice
(pricers/fd_asian.py), held against the JAX package and its tests' own
checks (tests/test_exotics.py, tests/test_american_asian.py, the barrier
classes of tests/test_pricers.py) at smaller sizes, on the port's own
stream (the GBM paths kernel's plain version, Heston's for the Heston
legs).

Tolerances, each with its reason:
- The closed form of the geometric Asian and the lattice: 1e-10 relative,
  float64 on both sides (the lattice is the same NumPy code).
- Reiner-Rubinstein: RR_ATOL against the reference, which computes in
  float32 whatever the x64 setting (it casts S0, the barrier and phi to
  float32, barrier.py:133-136): terms of size S0 = 100 round at 100 x
  2^-24 ~ 6e-6 each (measured 3.3e-6); the port stays in float64. Its
  in-out parity and limits in float64: 1e-12.
- The masks, the running average, the bridge's survival and the backward
  on the JAX package's path matrices in float64: 1e-12 (masks exact) and
  1e-9 relative; the backward in float32 ASIAN_F32_RTOL from the second
  date on (exercise_from = 2), since the reference's first-date Gram is
  singular (A_1 = S_1) and its float32 solve gives NaN or arbitrary
  coefficients, where the port regresses on the reduced basis
  (american_asian.build_asian_basis).
- The pricers' own checks: the JAX tests' bars at 2^14-2^16 paths, each
  widened by the stderr of the smaller sample where it says so.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from options_model_tpu.core import payoff as jpay
from options_model_tpu.core.config import HestonParams as JHestonParams
from options_model_tpu.core.config import MCConfig as JMCConfig
from options_model_tpu.core.config import OptionSpec as JOptionSpec
from options_model_tpu.pricers import american_asian as jaa
from options_model_tpu.pricers import barrier as jbar
from options_model_tpu.pricers import exotics as jex
from options_model_tpu.pricers import fd_asian as jfd
from options_model_tpu.pricers.american import simulate_paths as jsimulate_paths
from options_model_tpu_torch import pricers as tpricers
from options_model_tpu_torch.core import payoff as tpay
from options_model_tpu_torch.core.config import HestonParams, MCConfig, OptionSpec
from options_model_tpu_torch.core.stats import masked_mean_stderr
from options_model_tpu_torch.pricers import american_asian as taa
from options_model_tpu_torch.pricers import barrier as tbar
from options_model_tpu_torch.pricers import exotics as tex
from options_model_tpu_torch.pricers import fd_asian as tfd
from options_model_tpu_torch.pricers.american import _pair_block, simulate_paths
from options_model_tpu_torch.pricers.blackscholes import bs_price
from _torch_threads import one_torch_thread_module  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread_module")

S0, K, R, SIG = 100.0, 100.0, 0.05, 0.2
T_EX, T_AA = 0.5, 1.0                      # tests/test_exotics.py:10, test_american_asian.py:28
CALL = OptionSpec(strike=K, rate=R, cp=1.0, sigma=SIG)
PUT = OptionSpec(strike=K, rate=R, cp=-1.0, sigma=SIG)
MC64 = MCConfig(n_paths=1 << 14, n_steps=64)
MC25 = MCConfig(n_paths=1 << 15, n_steps=25)
HP = dict(kappa=2.0, theta=0.04, xi=0.5, rho=-0.7, v0=0.04)   # test_american_asian.py:186
RR_ATOL = 2e-5
ASIAN_F32_RTOL = 1e-4
BARRIER_CASES = [("up-and-out", 120.0, 1.0), ("down-and-out", 85.0, -1.0),
                 ("up-and-in", 115.0, 1.0), ("down-and-in", 90.0, -1.0)]


def _gen(s):
    return torch.Generator().manual_seed(s)


def _f(x):
    return float(x[0]), float(x[1])


def _jax_paths(model="gbm", n_paths=8192, n_steps=12, T=T_AA):
    kw = dict(heston=JHestonParams(**HP), return_variance=True) if model == "heston" else {}
    out = jsimulate_paths(jax.random.key(7), S0, T, JMCConfig(n_paths, n_steps, path_block=4096),
                          model, sigma=SIG, rate=R, **kw)
    if model == "heston":
        return np.asarray(out[0]), np.asarray(out[1])
    return np.asarray(out), None


# ---- closed forms and the lattice --------------------------------------------------------

@pytest.mark.parametrize("cp,q,n", [(1.0, 0.0, 25), (-1.0, 0.0, 25), (-1.0, 0.03, 50),
                                    (1.0, 0.02, 1)])
def test_geometric_asian_closed_form_matches_the_reference(cp, q, n):
    got = float(tex.geometric_asian_bs_price(S0, 95.0, T_AA, R, SIG, n, cp, q, device="cpu"))
    with jax.enable_x64(True):
        want = float(jex.geometric_asian_bs_price(np.float64(S0), 95.0, T_AA, R, SIG, n, cp, q))
    assert abs(got - want) <= 1e-10 * abs(want)


def test_geometric_asian_call_parity_with_forward():
    """tests/test_american_asian.py:43-54, in float64."""
    call = float(tex.geometric_asian_bs_price(S0, K, T_AA, R, SIG, 25, 1.0, device="cpu"))
    put = float(tex.geometric_asian_bs_price(S0, K, T_AA, R, SIG, 25, -1.0, device="cpu"))
    n = 25.0
    mu = math.log(S0) + (R - 0.5 * SIG**2) * T_AA * (n + 1) / (2 * n)
    var = SIG**2 * T_AA * (n + 1) * (2 * n + 1) / (6 * n * n)
    assert abs(call - put - math.exp(-R * T_AA) * (math.exp(mu + 0.5 * var) - K)) < 1e-10


@pytest.mark.parametrize("american", [False, True])
@pytest.mark.parametrize("cp,n,sub,m", [(-1.0, 10, 4, 100), (1.0, 6, 3, 64)])
def test_lattice_is_the_reference_lattice(cp, n, sub, m, american):
    kw = dict(cp=cp, substeps=sub, n_avg=m, american=american, div_yield=0.01)
    got = tfd.asian_binomial_price(S0, K, T_AA, R, SIG, n, **kw)
    want = jfd.asian_binomial_price(S0, K, T_AA, R, SIG, n, **kw)
    assert abs(got - want) <= 1e-10 * abs(want)
    assert tpricers.asian_binomial_price is tfd.asian_binomial_price


def test_lattice_call_no_early_exercise_without_q():
    eu = tfd.asian_binomial_price(S0, K, T_AA, R, SIG, 10, cp=1.0, substeps=4, n_avg=200,
                                  american=False)
    am = tfd.asian_binomial_price(S0, K, T_AA, R, SIG, 10, cp=1.0, substeps=4, n_avg=200,
                                  american=True)
    assert am >= eu - 1e-12 and (am - eu) / eu < 0.25
    with pytest.raises(ValueError, match="probability"):
        tfd.asian_binomial_price(S0, K, T_AA, 5.0, 0.01, 2)


@pytest.mark.parametrize("btype,B,cp", BARRIER_CASES)
@pytest.mark.parametrize("k", [95.0, 110.0])
def test_reiner_rubinstein_matches_the_reference(btype, B, cp, k):
    for c in (cp, -cp):
        got = float(tbar.barrier_price_rr(S0, k, T_EX, R, SIG, B, btype, c, 0.01, device="cpu"))
        with jax.enable_x64(True):
            want = float(jbar.barrier_price_rr(S0, k, T_EX, R, SIG, B, btype, c, 0.01))
        assert abs(got - want) <= RR_ATOL, (btype, c, got, want)


def test_reiner_rubinstein_parity_and_limits():
    """tests/test_pricers.py:231-243, in float64."""
    rr = lambda *a, **k: float(tbar.barrier_price_rr(*a, device="cpu", **k))  # noqa: E731
    bs = float(bs_price(S0, K, T_EX, R, SIG, 1.0, dtype=torch.float64, device="cpu"))
    assert abs(rr(S0, K, T_EX, R, SIG, 120.0, "up-and-out")
               + rr(S0, K, T_EX, R, SIG, 120.0, "up-and-in") - bs) < 1e-12 * bs
    bsp = float(bs_price(S0, K, T_EX, R, SIG, -1.0, dtype=torch.float64, device="cpu"))
    assert abs(rr(S0, K, T_EX, R, SIG, 90.0, "down-and-out", -1.0)
               + rr(S0, K, T_EX, R, SIG, 90.0, "down-and-in", -1.0) - bsp) < 1e-12 * bsp
    np.testing.assert_allclose(rr(S0, K, T_EX, R, SIG, 1e4, "up-and-out"), bs, rtol=1e-4)
    with pytest.raises(ValueError, match="safe side"):
        rr(S0, K, T_EX, R, SIG, 90.0, "up-and-out")
    with pytest.raises(ValueError, match="barrier_type"):
        rr(S0, K, T_EX, R, SIG, 90.0, "sideways")


# ---- building blocks on the JAX package's path matrices ---------------------------------

@pytest.mark.parametrize("is_up,B", [(True, 115.0), (False, 90.0)])
def test_masks_and_bridge_on_identical_paths(is_up, B):
    S, _ = _jax_paths(n_steps=50, T=T_EX)
    S64 = S.astype(np.float64)
    St = torch.from_numpy(S64)
    ko = tpay.barrier_knockout_mask(St, B, is_up).numpy()
    assert np.array_equal(ko, np.asarray(jpay.barrier_knockout_mask(S, B, is_up)))
    assert np.array_equal(tpay.barrier_knockin_mask(St, B, is_up).numpy(), 1.0 - ko)
    got = tbar._bridge_survival(St, B, SIG, T_EX, is_up).numpy()
    with jax.enable_x64(True):
        want = np.asarray(jbar._bridge_survival(jnp.asarray(S64), B, SIG, T_EX, is_up))
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)
    assert np.all(got <= ko + 1e-15) and np.all(got >= 0.0)


def test_running_average_on_identical_paths():
    S, _ = _jax_paths()
    with jax.enable_x64(True):
        want = np.asarray(jaa.running_average(jnp.asarray(S.astype(np.float64))))
    got = taa.running_average(torch.from_numpy(S.astype(np.float64))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-13)


ASIAN_CASES = [("gbm", "fixed", -1.0), ("gbm", "fixed", 1.0), ("gbm", "floating", -1.0),
               ("heston", "fixed", -1.0)]


@pytest.mark.parametrize("oos", [False, True])
@pytest.mark.parametrize("model,strike_type,cp", ASIAN_CASES)
def test_asian_backward_matches_the_reference_in_float64(model, strike_type, cp, oos):
    S, v = _jax_paths(model)
    spec = dict(strike=K, rate=R, cp=cp, sigma=SIG)
    kw = dict(strike_type=strike_type, out_of_sample=oos, pair_block=4096, stat_pair_block=4096)
    got = taa.lsm_asian_backward(torch.from_numpy(S.astype(np.float64)), OptionSpec(**spec),
                                 T_AA, v_paths=None if v is None else
                                 torch.from_numpy(v.astype(np.float64)), **kw)
    with jax.enable_x64(True):
        want = jaa.lsm_asian_backward(jnp.asarray(S.astype(np.float64)), JOptionSpec(**spec),
                                      T_AA, v_paths=None if v is None else
                                      jnp.asarray(v.astype(np.float64)), **kw)
        want = [float(x) for x in want]
    for g, w in zip(got, want):
        assert abs(float(g) - w) <= 1e-9 * abs(w), (got, want)


@pytest.mark.parametrize("model,strike_type,cp", ASIAN_CASES)
def test_asian_backward_matches_the_reference_in_float32(model, strike_type, cp):
    S, v = _jax_paths(model)
    spec = dict(strike=K, rate=R, cp=cp, sigma=SIG)
    kw = dict(strike_type=strike_type, exercise_from=2, stat_pair_block=4096)
    p, se = taa.lsm_asian_backward(torch.from_numpy(S.copy()), OptionSpec(**spec), T_AA,
                                   v_paths=None if v is None else torch.from_numpy(v.copy()),
                                   **kw)
    pj, sej = jaa.lsm_asian_backward(jnp.asarray(S), JOptionSpec(**spec), T_AA,
                                     v_paths=None if v is None else jnp.asarray(v), **kw)
    assert abs(float(p) - float(pj)) <= ASIAN_F32_RTOL * float(pj)
    assert abs(float(se) - float(sej)) <= 1e-3 * float(sej)


def test_first_date_basis_is_reduced_and_solvable():
    """A_1 = S_1: the full basis repeats u_s in u_a; the port's first-date
    basis drops the repeats, and its float32 continuation is finite."""
    S, _ = _jax_paths()
    St = torch.from_numpy(S.copy())
    A = taa.running_average(St)
    assert torch.equal(A[0], St[1])
    itm = (torch.clamp_min(K - St[1], 0.0) > 0).float()
    X = taa.build_asian_basis(St[1], St[1], K, itm, -1.0, "fixed", first_date=True)
    assert X.shape == (St.shape[1], 5)
    assert X.shape[1] + 4 == taa.build_asian_basis(St[2], A[1], K, itm, -1.0, "fixed").shape[1]
    from options_model_tpu_torch.pricers.regressors import masked_wls_predict_centered
    assert bool(torch.isfinite(masked_wls_predict_centered(X, St[-1], itm)).all())


def test_asian_backward_refuses_tf32_and_bad_args():
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="tf32"):
            taa.lsm_asian_backward(torch.ones(3, 8), PUT, 1.0)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    with pytest.raises(ValueError, match="strike_type"):
        taa.lsm_asian_backward(torch.ones(3, 8), PUT, 1.0, strike_type="both")


# ---- the Asian and lookback pricers: the JAX tests' checks -------------------------------

def _asian(seed, spec=PUT, mc=MC25, T=T_AA, **kw):
    kw.setdefault("device", "cpu")
    return _f(tex.price_asian_mc(_gen(seed), S0, T, spec, mc, **kw))


def test_asian_below_vanilla_and_orderings():
    p, _ = _asian(1, CALL, MC64, T_EX)
    assert 0.0 < p < float(bs_price(S0, K, T_EX, R, SIG, 1.0, device="cpu"))
    pa, _ = _asian(1, CALL, MC64, T_EX, control_variate="off")
    pg, _ = _asian(1, CALL, MC64, T_EX, average="geometric")
    assert pg <= pa + 1e-4
    pf, _ = _asian(1, CALL, MC64, T_EX, strike_type="floating")
    assert pf > 0.0


@pytest.mark.parametrize("kw,match", [(dict(average="harmonic"), "average"),
                                      (dict(strike_type="both"), "strike_type"),
                                      (dict(control_variate="maybe"), "control_variate"),
                                      (dict(average="geometric", control_variate="on"),
                                       "control_variate")])
def test_asian_bad_args(kw, match):
    with pytest.raises(ValueError, match=match):
        _asian(1, **kw)


def test_geometric_asian_mc_hits_the_closed_form():
    cf = float(tex.geometric_asian_bs_price(S0, K, T_AA, R, SIG, MC25.n_steps, -1.0,
                                            device="cpu"))
    p, se = _asian(7, average="geometric")
    assert abs(cf - p) < 3.5 * se


def test_kemna_vorst_cuts_stderr_and_agrees():
    p_cv, se_cv = _asian(7)
    p, se = _asian(7, control_variate="off")
    assert se_cv < se / 10.0
    assert abs(p_cv - p) < 4.0 * se


def test_lookbacks_dominate_the_vanilla():
    vanilla = float(bs_price(S0, K, T_EX, R, SIG, 1.0, device="cpu"))
    fl_call, _ = _f(tex.price_lookback_mc(_gen(2), S0, T_EX, CALL, MC64, device="cpu"))
    fl_put, _ = _f(tex.price_lookback_mc(_gen(2), S0, T_EX, PUT, MC64, device="cpu"))
    fixed, _ = _f(tex.price_lookback_mc(_gen(2), S0, T_EX, CALL, MC64, strike_type="fixed",
                                        device="cpu"))
    assert fl_call > vanilla and fl_put > 0.0 and fixed >= vanilla - 0.05
    with pytest.raises(ValueError, match="strike_type"):
        tex.price_lookback_mc(_gen(2), S0, T_EX, CALL, MC64, strike_type="both", device="cpu")


def test_exotics_under_heston_and_merton_run_on_their_kernels():
    from options_model_tpu_torch.core.config import MertonParams
    spec = OptionSpec(strike=K, rate=R, cp=-1.0, sigma=None)
    mc = MCConfig(n_paths=4096, n_steps=16)
    ph, seh = _f(tex.price_asian_mc(_gen(3), S0, T_AA, spec, mc, "heston",
                                    heston=HestonParams(**HP), device="cpu"))
    pm, sem = _f(tex.price_asian_mc(_gen(3), S0, T_AA, spec, mc, "merton",
                                    merton=MertonParams(sigma=0.2, lam=0.5, mu_j=-0.1,
                                                        sigma_j=0.15), device="cpu"))
    assert 1.0 < ph < 10.0 and 1.0 < pm < 10.0 and seh > 0 and sem > 0


# ---- barriers ----------------------------------------------------------------------------

def _barrier(seed, B, btype, spec=CALL, mc=MC64, **kw):
    kw.setdefault("device", "cpu")
    return _f(tbar.price_barrier_mc(_gen(seed), S0, T_EX, spec, B, btype, mc, **kw))


def test_knockout_below_vanilla_and_in_out_parity():
    vanilla = float(bs_price(S0, K, T_EX, R, SIG, 1.0, device="cpu"))
    ko, _ = _barrier(4, 130.0, "up-and-out")
    assert 0.0 < ko < vanilla
    ko, _ = _barrier(4, 120.0, "up-and-out")
    ki, _ = _barrier(4, 120.0, "up-and-in")
    S = simulate_paths(_gen(4), S0, T_EX, MC64, "gbm", sigma=SIG, rate=R, device="cpu")
    eu, _, _ = masked_mean_stderr(torch.clamp_min(S[-1] - K, 0.0) * math.exp(-R * T_EX),
                                  pair_block=_pair_block(MC64, "gbm"))
    np.testing.assert_allclose(ko + ki, float(eu), rtol=1e-5)
    far, _ = _barrier(4, 1e6, "up-and-out", mc=MCConfig(n_paths=1 << 14, n_steps=32))
    assert abs(far - float(bs_price(S0, K, T_EX, R, SIG, 1.0, device="cpu"))) < 0.2


@pytest.mark.parametrize("btype,B,cp", BARRIER_CASES)
def test_continuity_correction_matches_reiner_rubinstein(btype, B, cp):
    """tests/test_pricers.py:204-220 at 2^16 paths (a quarter of its
    2^18): 4 stderr; the discrete estimator farther off."""
    spec = CALL if cp > 0 else PUT
    mc = MCConfig(n_paths=1 << 16, n_steps=50)
    rr = float(tbar.barrier_price_rr(S0, K, T_EX, R, SIG, B, btype, cp=cp, device="cpu"))
    p, se = _barrier(5, B, btype, spec, mc, continuity_correction=True)
    assert abs(p - rr) < 4.0 * max(se, 1e-4), (btype, p, rr, se)
    p_d, _ = _barrier(5, B, btype, spec, mc)
    assert abs(p_d - rr) > abs(p - rr)


def test_barrier_bad_args():
    with pytest.raises(ValueError, match="barrier_type"):
        _barrier(1, 120.0, "sideways")
    with pytest.raises(ValueError, match="continuity_correction"):
        tbar.price_barrier_mc(_gen(1), S0, T_EX, OptionSpec(strike=K, rate=R, cp=1.0),
                              120.0, "up-and-out", MCConfig(n_paths=512, n_steps=4),
                              model="heston", heston=HestonParams(**HP),
                              continuity_correction=True, device="cpu")


# ---- the American Asian ------------------------------------------------------------------

def _am(seed, spec=PUT, mc=MC25, **kw):
    kw.setdefault("device", "cpu")
    return _f(taa.price_american_asian(_gen(seed), S0, T_AA, spec, mc, **kw))


def test_exercise_from_n_equals_european():
    S = simulate_paths(_gen(7), S0, T_AA, MC25, "gbm", sigma=SIG, rate=R, device="cpu")
    pb = _pair_block(MC25, "gbm")
    eu_lsm, _ = taa.lsm_asian_backward(S, PUT, T_AA, exercise_from=MC25.n_steps,
                                       stat_pair_block=pb)
    A = taa.running_average(S)
    eu, _, _ = masked_mean_stderr(torch.clamp_min(K - A[-1], 0.0) * math.exp(-R * T_AA),
                                  pair_block=pb)
    assert abs(float(eu_lsm) - float(eu)) < 1e-4


def test_american_above_european_and_the_composite_anchor():
    """tests/test_american_asian.py:98-119: the premium over the European
    (measured ~0.62 by the reference) and LSM+CV within 1% of the MC
    European plus the lattice's premium."""
    am, _ = _am(7)
    eu, _ = _asian(7)
    assert am > eu + 0.1
    tree_eu = tfd.asian_binomial_price(S0, K, T_AA, R, SIG, 25, cp=-1.0, substeps=6,
                                       n_avg=400, american=False)
    tree_am = tfd.asian_binomial_price(S0, K, T_AA, R, SIG, 25, cp=-1.0, substeps=6,
                                       n_avg=400, american=True)
    anchor = eu + (tree_am - tree_eu)
    assert abs(am - anchor) / anchor < 0.01


def test_floating_put_and_estimator_variants():
    am, _ = _am(7, strike_type="floating")
    eu, _ = _asian(7, strike_type="floating")
    assert am >= eu - 1e-3
    with pytest.raises(ValueError, match="control_variate"):
        _am(7, strike_type="floating", control_variate="on")
    p, se = _am(7, control_variate="off")
    oos, oos_se = _am(7, control_variate="off", out_of_sample=True)
    tol = 4.0 * math.hypot(se, oos_se) + 0.02
    assert abs(p - oos) < tol and oos <= p + 2.0 * tol
    _, se_cv = _am(7, CALL)
    _, se_off = _am(7, CALL, control_variate="off")
    assert se_cv <= se_off * 1.05
    p_one, _ = _am(7, cv_beta="one")
    assert abs(p_one - _am(7)[0]) < 0.05


def test_heston_american_above_european():
    spec = OptionSpec(strike=K, rate=R, cp=-1.0, sigma=SIG)
    mc = MCConfig(n_paths=1 << 14, n_steps=25)
    hp = HestonParams(**HP)
    am, _ = _am(7, spec, mc, model="heston", heston=hp)
    eu, eu_se = _asian(7, spec, mc, model="heston", heston=hp)
    assert am >= eu - 2.0 * eu_se and 0.5 < am < 10.0


def test_entry_points_without_a_device_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py drives the kernels")
    mc = MCConfig(n_paths=4096, n_steps=4)
    calls = [lambda: tex.price_asian_mc(_gen(1), S0, T_EX, PUT, mc),
             lambda: tex.price_lookback_mc(_gen(1), S0, T_EX, PUT, mc),
             lambda: tbar.price_barrier_mc(_gen(1), S0, T_EX, CALL, 120.0, "up-and-out", mc),
             lambda: taa.price_american_asian(_gen(1), S0, T_AA, PUT, mc),
             lambda: tex.geometric_asian_bs_price(S0, K, T_AA, R, SIG, 4),
             lambda: tbar.barrier_price_rr(S0, K, T_EX, R, SIG, 120.0, "up-and-out")]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
