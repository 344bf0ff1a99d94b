"""The port's calibration slice held against the JAX package, on the CPU in
float64 at the JAX package's own small sizes (15 strikes x 4-6 expiries).

Tolerances, each with its reason:
- COS prices (VG, Bates), rtol 1e-6: the JAX side is float64 under
  jax.enable_x64, whose complex128 functions on the CPU are ~1e-7 accurate
  (the same bar as the Heston COS parity).
- _objective_core at the truth, atol 1e-7 (the objective is ~1e-9 there:
  an absolute bar), and at three perturbed x per model, rtol 1e-6, the COS
  bar carried through the IV solve; its gradient, rtol 1e-5 in the 2-norm
  (the implicit IV derivative divides by vega, which loosens the bar by an
  order); _residuals_core, atol 1e-7 (residuals of size 1e-3..1e-2 whose
  IVs agree to 1e-7 relative).
- The synthetic surfaces, atol 1e-7 in IV, with the same noise bit for bit
  (both packages draw it from np.random.default_rng(seed)).
The round trip, the cascade and the app run the port's calibrator on the
CPU (``device="cpu"``); the card runs them in chip_smoke.py phase 3f.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from options_model_tpu_torch.scripts import profile_calibration
from options_model_tpu.calibration import calibrator as jcal
from options_model_tpu.calibration import charfn as jcf
from options_model_tpu.calibration import synthetic as jsyn
from options_model_tpu.core import config as jcfg
from options_model_tpu_torch import calibration as tcal_pkg
from options_model_tpu_torch.apps import calibrate as app
from options_model_tpu_torch.calibration import calibrator as tcal
from options_model_tpu_torch.calibration import charfn as tcf
from options_model_tpu_torch.calibration import synthetic as tsyn
from options_model_tpu_torch.core import config as tcfg
from options_model_tpu_torch.models import merton as tmerton
from _torch_threads import one_torch_thread_module  # noqa: F401

HESTON = dict(kappa=3.0, theta=0.05, xi=0.4, rho=-0.6, v0=0.045)
BATES_HESTON = dict(kappa=2.5, theta=0.05, xi=0.45, rho=-0.6, v0=0.045)
JUMPS = dict(lam=0.4, mu_j=-0.12, sigma_j=0.18)
VG = dict(sigma=0.18, theta=-0.14, nu=0.35)
MODELS = ("heston", "bates", "vg")
N_TERMS = {"heston": 256, "bates": 256, "vg": 2048}
RATE = {"heston": 0.05, "bates": 0.04, "vg": 0.05}


# The objective is ~5,000 small ops on 15-90 elements: torch's intra-op threads
# only add overhead (one evaluation takes 3x as long at 8 threads as at 1).
# (tests/_torch_threads.py)
pytestmark = pytest.mark.usefixtures("one_torch_thread_module")


def _params(model):
    """(JAX params, port params) of the model's truth."""
    if model == "heston":
        return jcfg.HestonParams(**HESTON), tcfg.HestonParams(**HESTON)
    if model == "bates":
        return (jcfg.BatesParams(heston=jcfg.HestonParams(**BATES_HESTON), **JUMPS),
                tcfg.BatesParams(heston=tcfg.HestonParams(**BATES_HESTON), **JUMPS))
    return jcfg.VGParams(**VG), tcfg.VGParams(**VG)


def _synth(model, **kw):
    _, p = _params(model)
    fn = {"heston": tsyn.create_synthetic_heston_surface,
          "bates": tsyn.create_synthetic_bates_surface,
          "vg": tsyn.create_synthetic_vg_surface}[model]
    return fn(p, S0=100.0, rate=RATE[model], dtype=np.float64, device="cpu", **kw)


@pytest.fixture(scope="module", params=MODELS)
def case(request):
    """A model's f64 noisy surface (noise 0.002, seed 3), its truth and
    three numpy-seeded perturbations of it, and the JAX package's objective
    value, gradient and residuals at each of the four points."""
    model = request.param
    K, T, iv = _synth(model, noise_std=0.002, seed=3)
    jp, tp = _params(model)
    truth = np.asarray(tp.to_array(), np.float64)
    rng = np.random.default_rng({"heston": 11, "bates": 12, "vg": 13}[model])
    xs = [truth] + [truth * (1.0 + rng.uniform(-0.1, 0.1, truth.shape)) for _ in range(3)]
    kw = dict(n_terms=N_TERMS[model], model=model)
    with jax.enable_x64(True):
        def obj(x):
            return jcal._objective_core(x, jnp.asarray(K), jnp.asarray(T), jnp.asarray(iv),
                                        100.0, RATE[model], dtype=jnp.float64, **kw)

        vg = jax.jit(jax.value_and_grad(obj))
        want = [tuple(np.asarray(a, np.float64) for a in vg(jnp.asarray(x))) for x in xs]
        resid = [np.asarray(jcal._residuals_core(
            jnp.asarray(x), jnp.asarray(K), jnp.asarray(T), jnp.asarray(iv), 100.0,
            RATE[model], dtype=jnp.float64, **kw), np.float64) for x in xs]
    return dict(model=model, K=K, T=T, iv=iv, xs=xs, want=want, resid=resid, kw=kw)


def _port_value_and_grad(case, x):
    xt = torch.tensor(x, dtype=torch.float64, requires_grad=True)
    v = tcal._objective_core(xt, case["K"], case["T"], case["iv"], 100.0, RATE[case["model"]],
                             **case["kw"])
    (g,) = torch.autograd.grad(v, xt)
    return float(v.detach()), g.numpy()


# ---- COS prices -----------------------------------------------------------

@pytest.mark.parametrize("cp", [1.0, -1.0])
def test_vg_cos_matches_jax(cp):
    jp, tp = _params("vg")
    K, T = np.meshgrid(np.linspace(70, 130, 15), np.array([7, 30, 90, 365, 730]) / 365.0)
    with jax.enable_x64(True):
        want = np.asarray(jcf.vg_cos_price(100.0, jnp.asarray(K), jnp.asarray(T), 0.05, jp,
                                           cp=cp, n_terms=2048, q=0.01, dtype=jnp.float64))
    got = tcf.vg_cos_price(100.0, torch.from_numpy(K), torch.from_numpy(T), 0.05, tp, cp=cp,
                           n_terms=2048, q=0.01, dtype=torch.float64).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("cp", [1.0, -1.0])
def test_bates_cos_matches_jax(cp):
    jp, tp = _params("bates")
    K, T = np.meshgrid(np.linspace(70, 130, 17), np.array([7, 30, 90, 180, 365]) / 365.0)
    with jax.enable_x64(True):
        want = np.asarray(jcf.bates_cos_price(100.0, jnp.asarray(K), jnp.asarray(T), 0.04, jp,
                                              cp=cp, q=0.01, dtype=jnp.float64))
    got = tcf.bates_cos_price(100.0, torch.from_numpy(K), torch.from_numpy(T), 0.04, tp,
                              cp=cp, q=0.01, dtype=torch.float64).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)


def test_cos_prices_stay_float64():
    """Every intermediate of the f64 chain stays float64/complex128: the
    prices come back float64 and their gradient in each parameter too (a
    float32 leak would put back the ~1e-3 objective floor)."""
    x = torch.tensor([2.5, 0.05, 0.45, -0.6, 0.045, 0.4, -0.12, 0.18], dtype=torch.float64,
                     requires_grad=True)
    bp = tcfg.BatesParams(heston=tcfg.HestonParams(*x[:5].unbind()), lam=x[5], mu_j=x[6],
                          sigma_j=x[7])
    p = tcf.bates_cos_price(100.0, torch.tensor([90.0, 110.0], dtype=torch.float64),
                            torch.tensor([0.1, 1.0], dtype=torch.float64), 0.04, bp,
                            dtype=torch.float64)
    (g,) = torch.autograd.grad(p.sum(), x)
    assert p.dtype == g.dtype == torch.float64


@pytest.mark.parametrize("model", MODELS)
def test_real_part_gradient_float64(model):
    """The reference's ``creal`` exists because jnp.real's transpose breaks
    under its explicit-x64 mode; torch.real transposes to a complex128
    cotangent. The float64 gradient of the objective through the COS chain's
    torch.real agrees with a central difference of the objective (h = 1e-6
    relative; the difference's truncation and the f64 chain's noise are
    ~1e-8 of the gradient's norm)."""
    K, T, iv = _synth(model, noise_std=0.002, seed=3)
    _, tp = _params(model)
    x = np.asarray(tp.to_array(), np.float64) * 1.03
    c = dict(model=model, K=K, T=T, iv=iv, kw=dict(n_terms=N_TERMS[model], model=model))
    _, g = _port_value_and_grad(c, x)
    fd = np.empty_like(x)
    for i in range(len(x)):
        h = 1e-6 * abs(x[i])
        xp, xm = x.copy(), x.copy()
        xp[i] += h
        xm[i] -= h
        fd[i] = (_port_value_and_grad(c, xp)[0] - _port_value_and_grad(c, xm)[0]) / (2 * h)
    assert np.linalg.norm(g - fd) <= 1e-5 * np.linalg.norm(fd)


# ---- objective and residuals ---------------------------------------------

def test_objective_at_truth_matches_jax(case):
    got, _ = _port_value_and_grad(case, case["xs"][0])
    assert abs(got - float(case["want"][0][0])) <= 1e-7


@pytest.mark.parametrize("i", [1, 2, 3])
def test_objective_perturbed_matches_jax(case, i):
    got, _ = _port_value_and_grad(case, case["xs"][i])
    want = float(case["want"][i][0])
    assert got == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("i", [1, 2, 3])
def test_objective_gradient_matches_jax(case, i):
    _, got = _port_value_and_grad(case, case["xs"][i])
    want = case["want"][i][1]
    assert np.linalg.norm(got - want) <= 1e-5 * np.linalg.norm(want)


def test_residuals_match_jax(case):
    for x, want in zip(case["xs"], case["resid"]):
        got = tcal._residuals_core(torch.tensor(x, dtype=torch.float64), case["K"], case["T"],
                                   case["iv"], 100.0, RATE[case["model"]], **case["kw"])
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-7)
        # sum r^2 is the squared weighted RMSE the objective reports
        v, _ = _port_value_and_grad(case, x)
        if (got[-1] == 0).item():
            assert float((got**2).sum()) == pytest.approx(v**2, rel=1e-9)


# ---- synthetic surfaces ---------------------------------------------------

@pytest.mark.parametrize("model", MODELS)
def test_synthetic_surface_matches_jax(model):
    jp, _ = _params(model)
    jfn = {"heston": jsyn.create_synthetic_heston_surface,
           "bates": jsyn.create_synthetic_bates_surface,
           "vg": jsyn.create_synthetic_vg_surface}[model]
    K, T, iv = _synth(model, noise_std=0.005, seed=7)
    _, _, clean = _synth(model)
    jK, jT, jiv = jfn(jp, S0=100.0, rate=RATE[model], noise_std=0.005, seed=7,
                      dtype=np.float64)
    _, _, jclean = jfn(jp, S0=100.0, rate=RATE[model], dtype=np.float64)
    np.testing.assert_array_equal(K, jK)
    np.testing.assert_array_equal(T, jT)
    np.testing.assert_allclose(clean, jclean, rtol=0, atol=1e-7)
    np.testing.assert_allclose(iv, jiv, rtol=0, atol=1e-7)
    # the same draws, bit for bit, in both packages
    noise = np.random.default_rng(7).normal(0.0, 0.005, clean.shape)
    np.testing.assert_array_equal(iv, np.clip(clean + noise, 0.011, 1.99))
    np.testing.assert_array_equal(jiv, np.clip(jclean + noise, 0.011, 1.99))


def test_synthetic_float32_default_matches_jax():
    """The float32 oracle (the app's --test surface), atol 1e-3 in IV: the
    f32 COS chain's ~2e-3 absolute price floor (each series term rounded
    coherently across k; the reference's calibrator notes) reaches ~1e-3 in
    IV on the short-dated wings through the IV solve, ~1e-5 at the money."""
    jp, tp = _params("heston")
    _, _, iv = tsyn.create_synthetic_heston_surface(tp, device="cpu")
    _, _, jiv = jsyn.create_synthetic_heston_surface(jp)
    np.testing.assert_allclose(iv, jiv, rtol=0, atol=1e-3)


# ---- surface, regime, bounds, guesses -------------------------------------

def test_market_surface_filters_like_jax():
    rng = np.random.default_rng(5)
    K = rng.uniform(-10.0, 150.0, 200)
    T = rng.uniform(0.0, 1.0, 200)
    iv = rng.uniform(0.0, 2.5, 200)
    got = tcal.MarketSurface(K, T, iv, 100.0)
    want = jcal.MarketSurface(K, T, iv, 100.0)
    for name in ("strikes", "expiries", "ivs"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    assert got.regime == want.regime and len(got) == len(want)
    with pytest.raises(ValueError, match="No valid option data"):
        tcal.MarketSurface(np.ones(3), np.ones(3), np.full(3, 5.0), 100.0)
    with pytest.raises(ValueError, match="equal shapes"):
        tcal.MarketSurface(np.ones(3), np.ones(2), np.ones(3), 100.0)


@pytest.mark.parametrize("level", [0.10, 0.1499, 0.15, 0.22, 0.35, 0.3501, 0.45])
def test_detect_regime_matches_jax(level):
    assert tcal.detect_regime(level) == jcal.detect_regime(level)


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("level", [0.10, 0.22, 0.45])
def test_bounds_and_x0_match_jax(model, level):
    surf = tcal.MarketSurface(np.full(8, 100.0), np.linspace(0.1, 1.0, 8),
                              np.full(8, level), 100.0)
    cal = tcal.HestonCalibrator(model=model, device="cpu")
    jc = jcal.HestonCalibrator(model=model)
    np.testing.assert_array_equal(cal._x0(surf), jc._x0(surf))
    if model == "vg":
        want = jcal._VG_BOUNDS
    else:
        want = list(jcal._REGIME_BOUNDS[surf.regime])
        want += jcal._JUMP_BOUNDS if model == "bates" else []
    assert cal._bounds(surf) == want


def test_bound_tables_match_jax():
    assert tcal._REGIME_BOUNDS == jcal._REGIME_BOUNDS
    assert tcal._JUMP_BOUNDS == jcal._JUMP_BOUNDS
    assert tcal._VG_BOUNDS == jcal._VG_BOUNDS
    np.testing.assert_array_equal(tcal._JUMP_GUESS, jcal._JUMP_GUESS)
    np.testing.assert_array_equal(tcal._vg_guess(0.2), jcal._vg_guess(0.2))


def test_regime_detection_off_uses_normal_bounds():
    surf = tcal.MarketSurface(np.full(8, 100.0), np.linspace(0.1, 1.0, 8), np.full(8, 0.45),
                              100.0)
    cal = tcal.HestonCalibrator(tcfg.CalibrationConfig(regime_detection=False), device="cpu")
    assert cal._bounds(surf) == jcal._REGIME_BOUNDS["normal_vol"]


# ---- configs ---------------------------------------------------------------

def test_heston_from_reference_and_arrays():
    jp = jcfg.HestonParams(**HESTON)
    tp = tcfg.HestonParams.from_reference(vars(jp))
    np.testing.assert_array_equal(tp.to_array(), np.array(list(HESTON.values())))
    assert tp.feller_condition() == jp.feller_condition()
    assert tcfg.HestonParams.from_array(tp.to_array()) == tp
    bad = tcfg.HestonParams(kappa=1.0, theta=0.02, xi=0.5, rho=-0.5, v0=0.02)
    assert bad.feller_condition() is False
    assert str(tp) == str(jp)


@pytest.mark.parametrize("how", ["vars", "asdict"])
def test_bates_from_reference(how):
    jp, tp = _params("bates")
    fields = vars(jp) if how == "vars" else dataclasses.asdict(jp)
    got = tcfg.BatesParams.from_reference(fields)
    assert got == tp
    assert got.to_array().tolist() == [*BATES_HESTON.values(), *JUMPS.values()]
    assert tcfg.BatesParams.from_array(got.to_array()) == got
    assert got.kbar() == pytest.approx(jp.kbar(), rel=1e-15)
    assert got.feller_condition() == jp.feller_condition()
    assert str(got) == str(jp)


def test_vg_from_reference_and_checks():
    jp, tp = _params("vg")
    got = tcfg.VGParams.from_reference(vars(jp))
    assert got == tp and got.omega() == pytest.approx(jp.omega(), rel=1e-15)
    assert tcfg.VGParams.from_array(got.to_array()) == got and str(got) == str(jp)
    for bad in (dict(sigma=-0.1, theta=0.0, nu=0.3), dict(sigma=0.2, theta=0.0, nu=0.0),
                dict(sigma=0.2, theta=3.0, nu=0.5)):
        with pytest.raises(ValueError) as te:
            tcfg.VGParams(**bad).validate()
        with pytest.raises(ValueError) as je:
            jcfg.VGParams(**bad).validate()
        assert str(te.value) == str(je.value)


def test_bates_validate_matches_jax():
    for lam, sj in ((-0.1, 0.1), (0.1, -0.1)):
        with pytest.raises(ValueError) as te:
            tcfg.BatesParams(tcfg.HestonParams(**HESTON), lam, 0.0, sj).validate()
        with pytest.raises(ValueError) as je:
            jcfg.BatesParams(jcfg.HestonParams(**HESTON), lam, 0.0, sj).validate()
        assert str(te.value) == str(je.value)


def test_calibration_config_from_reference():
    j = jcfg.CalibrationConfig(max_iterations=50, optimization_methods=("L-BFGS-B",),
                               seed=7)
    got = tcfg.CalibrationConfig.from_reference(vars(j))
    assert got == tcfg.CalibrationConfig(max_iterations=50, optimization_methods=("L-BFGS-B",),
                                         seed=7)
    assert dataclasses.asdict(tcfg.CalibrationConfig()) == dataclasses.asdict(
        jcfg.CalibrationConfig())
    with pytest.raises(ValueError, match="cos_n"):
        tcfg.CalibrationConfig(cos_n=8).validate()


# ---- the calibrator --------------------------------------------------------

def test_invalid_model_rejected():
    with pytest.raises(ValueError, match="model"):
        tcal.HestonCalibrator(model="svj2", device="cpu")


def test_tf32_raises():
    K, T, iv = _synth("heston")
    cal = tcal.HestonCalibrator(device="cpu")
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="allow_tf32"):
            cal._make_objective(tcal.MarketSurface(K, T, iv, 100.0))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def test_exact_heston_round_trip():
    """f64 data on 7 strikes x 3 expiries, ("L-BFGS-B",): every parameter
    within 1e-4 relative, the summary as the reference's."""
    true = tcfg.HestonParams(**HESTON)
    K, T, iv = tsyn.create_synthetic_heston_surface(
        true, strikes=np.linspace(85, 115, 7), expiries_days=(30, 90, 180), dtype=np.float64,
        device="cpu")
    cfg = tcfg.CalibrationConfig(optimization_methods=("L-BFGS-B",))
    fit, summary = tcal.calibrate_heston_to_data(K, T, iv, 100.0, 0.05, cfg, device="cpu")
    np.testing.assert_allclose(fit.to_array(), true.to_array(), rtol=1e-4)
    assert summary["error"] < 1e-6
    assert set(summary) == {"parameters", "error", "feller_condition", "n_calibrations",
                            "regime"}
    assert summary["regime"] == "normal_vol" and summary["feller_condition"]


def _noisy_small():
    true = tcfg.HestonParams(**HESTON)
    return tsyn.create_synthetic_heston_surface(
        true, strikes=np.linspace(85, 115, 5), expiries_days=(30, 90, 180), noise_std=0.005,
        seed=7, dtype=np.float64, device="cpu")


def test_cascade_wiring_matches_jax():
    """The default three-method cascade at max_iterations=20 in both
    packages on one noisy surface: every method runs (the L-BFGS-B error
    stays above the 1e-4 break), the same best method, and the port's error
    no worse than the JAX package's x (1 + 1e-6)."""
    K, T, iv = _noisy_small()
    cal = tcal.HestonCalibrator(tcfg.CalibrationConfig(max_iterations=20), device="cpu")
    cal.calibrate(tcal.MarketSurface(K, T, iv, 100.0))
    jc = jcal.HestonCalibrator(jcfg.CalibrationConfig(max_iterations=20))
    jc.calibrate(jcal.MarketSurface(K, T, iv, 100.0))
    assert set(cal.method_results) == {"L-BFGS-B", "differential_evolution", "dual_annealing"}
    assert cal.calibration_history[-1]["method"] == jc.calibration_history[-1]["method"]
    assert cal.best_error <= jc.best_error * (1.0 + 1e-6)


def test_stalled_polish_moves_to_the_next_start(monkeypatch):
    """The port polishes the best L-BFGS-B terminal, as the reference; when
    that polish stalls (its first solve used up max_nfev) it polishes the
    next terminal in order of value, until one converges, and keeps the
    best. Stubbed solves: the logic, not the optimizer."""
    K, T, iv = _noisy_small()
    surf = tcal.MarketSurface(K, T, iv, 100.0)
    cal = tcal.HestonCalibrator(tcfg.CalibrationConfig(optimization_methods=("L-BFGS-B",)),
                                device="cpu")
    f, f_and_g, bounds = cal._make_objective(surf)
    ends = iter([(0.009, 1.0), (0.008, 2.0), (0.0095, 4.0), (0.0085, 6.0)])

    class Res:
        def __init__(self, fun, k):
            self.fun, self.success = fun, False
            self.x = np.array([k, 0.05, 0.4, -0.6, 0.045])

    monkeypatch.setattr(tcal, "minimize", lambda *a, **k: Res(*next(ends)))
    polished = []

    def polish(self, surface, x, b, f_):
        polished.append(float(x[0]))
        return x, {2.0: 0.006, 6.0: 0.005, 1.0: 0.0055}[float(x[0])], x[0] != 2.0

    monkeypatch.setattr(tcal.HestonCalibrator, "_least_squares_polish", polish)
    ok, x, fun = cal._lbfgsb(surf, cal._x0(surf), bounds, f, f_and_g)
    assert polished == [2.0, 6.0]          # the best start stalled, the next converged
    assert fun == 0.005 and x[0] == 6.0 and ok


def test_polish_reports_a_stall_without_restarts(monkeypatch):
    """A first solve that stops at max_nfev (scipy status 0) returns
    converged=False and no restart runs; one that meets a tolerance restarts
    as the reference's loop does."""
    K, T, iv = _noisy_small()
    surf = tcal.MarketSurface(K, T, iv, 100.0)
    cal = tcal.HestonCalibrator(device="cpu")
    f, _, bounds = cal._make_objective(surf)
    calls = []

    def fake(fun, x0, **kw):
        calls.append(kw["max_nfev"])
        cost = 1.0 / len(calls)
        return type("R", (), dict(status=status, x=np.asarray(x0), cost=cost))()

    monkeypatch.setattr(tcal, "least_squares", fake)
    x0 = cal._x0(surf)
    for status, want_calls, want_conv in ((0, 1, False), (3, 3, True)):
        calls.clear()
        _, _, converged = cal._least_squares_polish(surf, x0, bounds, f)
        assert converged is want_conv and calls == [400] * want_calls


def test_model_ivs_float32_matches_jax():
    jp, tp = _params("heston")
    K, T, iv = _synth("heston")
    surf = tcal.MarketSurface(K, T, iv, 100.0)
    got = tcal.HestonCalibrator(device="cpu").model_ivs(surf, tp)
    want = jcal.HestonCalibrator().model_ivs(jcal.MarketSurface(K, T, iv, 100.0), jp)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)   # the f32 chain, as above


@pytest.mark.slow
def test_noisy_lbfgsb_fit_matches_jax():
    """bench.py's noisy leg (noise 0.005, seed 7) with ("L-BFGS-B",) in both
    packages. The JAX error is chip_smoke.py's JAX_C2_IV_RMSE, its (theta,
    xi, rho, v0) relative RMSE JAX_C2_PARAM_RMSE."""
    true = tcfg.HestonParams(3.0, 0.05, 0.4, -0.6, 0.045)
    K, T, iv = tsyn.create_synthetic_heston_surface(true, noise_std=0.005, seed=7,
                                                   dtype=np.float64, device="cpu")
    cfg = tcfg.CalibrationConfig(optimization_methods=("L-BFGS-B",))
    fit, s = tcal.calibrate_heston_to_data(K, T, iv, 100.0, 0.05, cfg, device="cpu")
    jfit, js = jcal.calibrate_heston_to_data(
        K, T, iv, 100.0, 0.05, jcfg.CalibrationConfig(optimization_methods=("L-BFGS-B",)))
    assert js["error"] == pytest.approx(chip_smoke.JAX_C2_IV_RMSE, rel=1e-6)
    assert s["error"] <= js["error"] * (1.0 + 1e-6)
    rel = np.array([jfit.theta / 0.05, jfit.xi / 0.4, jfit.rho / -0.6, jfit.v0 / 0.045]) - 1
    assert float(np.sqrt(np.mean(rel**2))) == pytest.approx(chip_smoke.JAX_C2_PARAM_RMSE,
                                                            rel=1e-4)


def _chain_gates(params, error, true):
    """tests/test_livechain_e2e.py's parameter gates on the recorded chain."""
    return (error < 0.01 and abs(params.theta - true["theta"]) < 0.01
            and abs(params.v0 - true["v0"]) < 0.01 and abs(params.rho - true["rho"]) < 0.15
            and abs(params.xi / true["xi"] - 1.0) < 0.35)


@pytest.mark.slow
def test_reference_chain_fit_hangs_on_last_bits():
    """The reference's ("L-BFGS-B",) fit of the recorded chain passes
    tests/test_livechain_e2e.py's gates on the chain as recorded and leaves
    them when every IV moves by ~1e-14 relative (numpy seed 2): which start
    its one polish runs from, and where that polish stops, hang on the
    objective's last bits (ROADMAP §3). The port, which hands a polish that
    used up max_nfev over to the next start, passes on the moved chain."""
    K, T, iv, S0, meta = profile_calibration.read_chain_fixture()
    moved = iv * (1.0 + 1e-14 * np.random.default_rng(2).standard_normal(iv.shape))
    true = meta["true_params"]
    jcfg_ = jcfg.CalibrationConfig(optimization_methods=("L-BFGS-B",))
    p, s = jcal.calibrate_heston_to_data(K, T, iv, S0, meta["rate"], jcfg_)
    assert _chain_gates(p, s["error"], true)
    p, s = jcal.calibrate_heston_to_data(K, T, moved, S0, meta["rate"], jcfg_)
    assert not _chain_gates(p, s["error"], true)
    p, s = tcal.calibrate_heston_to_data(
        K, T, moved, S0, meta["rate"],
        tcfg.CalibrationConfig(optimization_methods=("L-BFGS-B",)), device="cpu")
    assert _chain_gates(p, s["error"], true)


# ---- the app ---------------------------------------------------------------

@pytest.mark.parametrize("model", MODELS)
def test_app_test_mode(model, monkeypatch, tmp_path):
    """run(parse_args([...]), device="cpu") for --test: the synthetic oracle
    of the model, its calibrator, the recovery errors by name and, for
    Heston, --price-surface at 4 x 4 (the CSV's header and rows). Bates's
    least-squares polish (~20 s on the CPU after its 12 starts) is stubbed
    out here; the Heston and VG runs keep theirs, and the card runs Bates's
    whole fit (chip_smoke.py C4)."""
    argv = ["--test", "--model", model, "--methods", "L-BFGS-B", "--max-iterations",
            "1" if model == "bates" else "5"]
    out = tmp_path / "surface.csv"
    if model == "heston":
        argv += ["--price-surface", str(out), "--surface-size", "4", "4"]
    if model == "bates":
        monkeypatch.setattr(tcal.HestonCalibrator, "_least_squares_polish",
                            lambda self, surface, x, bounds, f: (x, np.inf))
    s = app.run(app.parse_args(argv), device="cpu")
    names = {"heston": ["kappa", "theta", "xi", "rho", "v0"],
             "bates": ["kappa", "theta", "xi", "rho", "v0", "lam", "mu_j", "sigma_j"],
             "vg": ["sigma", "theta", "nu"]}[model]
    assert list(s["param_errors"]) == names
    assert np.isfinite(s["error"]) and s["error"] < {"heston": 1e-3, "bates": 5e-2,
                                                     "vg": 1e-3}[model]
    assert type(s["params"]) is type(s["true_params"])
    if model != "heston":
        return
    lines = out.read_text().splitlines()
    assert lines[0] == "K,T,price" and len(lines) == 17 and s["surface_csv"] == str(out)
    rows = np.array([[float(v) for v in ln.split(",")] for ln in lines[1:]])
    np.testing.assert_allclose(rows[:4, 0], np.linspace(70.0, 130.0, 4), rtol=1e-6)
    np.testing.assert_allclose(rows[::4, 1], np.linspace(0.1, 1.0, 4), rtol=1e-6)
    P = rows[:, 2].reshape(4, 4)
    assert np.isfinite(P).all() and (P >= 0).all()
    assert (np.diff(P, axis=1) > -1e-3).all()   # puts rise with the strike


def test_app_parse_args_defaults_match_jax():
    from options_model_tpu.apps import calibrate as japp
    assert vars(app.parse_args([])) == vars(japp.parse_args([]))


# ---- what is not ported yet, and no quiet CPU ------------------------------

def _bates_surface_on_two_devices():
    """The maturity-sharded surface (a mesh of two devices) under Bates."""
    from options_model_tpu_torch.pricers.surface_american import price_american_surface

    class TwoDevices:
        def size(self):
            return 2

    bp = tcfg.BatesParams(heston=tcfg.HestonParams(**BATES_HESTON), **JUMPS)
    price_american_surface(torch.Generator().manual_seed(0), 100.0, [90.0, 100.0], [0.5], 0.05,
                           tcfg.MCConfig(n_paths=4096, n_steps=4), model="bates", bates=bp,
                           mesh=TwoDevices(), device="cpu")


@pytest.mark.parametrize("call", [
    lambda: tcal.calibrate_heston_to_ticker("AAPL"),
    lambda: tcal.HestonCalibrator(device="cpu").plot_diagnostics(None, "x.png"),
    lambda: tcal.HestonCalibrator(device="cpu").calibrate(
        tcal.MarketSurface(np.ones(3) * 100, np.ones(3), np.full(3, 0.2), 100.0), "diag"),
    lambda: app.run(app.parse_args(["--model", "rbergomi"]), device="cpu"),
    lambda: app.run(app.parse_args(["--ticker", "AAPL"]), device="cpu"),
    lambda: app.run(app.parse_args(["--test", "--diagnostics-dir", "d"]), device="cpu"),
    lambda: _bates_surface_on_two_devices(),
    lambda: tmerton.simulate_merton(1, torch.tensor(100.0, requires_grad=True), 0.05, 0.5,
                                    tcfg.MertonParams(0.2, 1.0, -0.1, 0.15),
                                    tcfg.MCConfig(n_paths=4096, n_steps=4), device="cpu"),
], ids=["ticker", "plot_diagnostics", "diagnostics_dir",
        "app_rbergomi", "app_ticker", "app_diagnostics", "bates_surface_mesh",
        "merton_paths_gradient"])
def test_not_ported_names_its_reference(call):
    with pytest.raises(NotImplementedError, match="options_model_tpu\\."):
        call()


def test_app_vg_price_surface_exits_as_jax():
    with pytest.raises(SystemExit, match="price-surface"):
        app.run(app.parse_args(["--test", "--model", "vg", "--price-surface", "x.csv"]),
                device="cpu")


@pytest.mark.parametrize("call", [
    lambda: tcal.HestonCalibrator(),
    lambda: tsyn.create_synthetic_heston_surface(tcfg.HestonParams(**HESTON)),
    lambda: tsyn.create_synthetic_bates_surface(_params("bates")[1]),
    lambda: tsyn.create_synthetic_vg_surface(_params("vg")[1]),
    lambda: tcal.calibrate_vg_to_data(np.ones(3) * 100, np.ones(3), np.full(3, 0.2), 100.0),
    lambda: app.run(app.parse_args(["--test"])),
], ids=["calibrator", "heston_surface", "bates_surface", "vg_surface", "to_data", "app_run"])
def test_entry_points_without_a_device_raise_without_cuda(call):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        call()


# ---- the recorded chain's reader (chip_smoke.py C6) ------------------------

def test_chain_reader_matches_fetch_option_chain(monkeypatch):
    """profile_calibration.read_chain_fixture (chip_smoke.py's C6) against
    the reference's fetch_option_chain on the stubbed feed (tests/test_livechain_e2e.py's
    FakeTicker over the same recording): the same points and spot."""
    import types

    from options_model_tpu.data import market
    from tests.test_livechain_e2e import _fixture_ticker, _load_fixture

    tk = _fixture_ticker(_load_fixture())
    monkeypatch.setattr(market, "yf", types.SimpleNamespace(Ticker=lambda s: tk))
    monkeypatch.setattr(market, "_YF", True)
    jK, jT, jiv, jS0 = market.fetch_option_chain("RECORDED")
    K, T, iv, S0, meta = profile_calibration.read_chain_fixture()
    assert S0 == jS0 and meta["true_params"]["kappa"] == 1.9
    order = np.lexsort((jiv, jK, jT))
    np.testing.assert_array_equal(np.stack([K, T, iv]),
                                  np.stack([jK[order], jT[order], jiv[order]]))
