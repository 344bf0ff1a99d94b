"""The rough Bergomi calibrator in the port (calibration/rbergomi.py, the
app's --model rbergomi) held against the JAX package on the CPU.

Tolerances, each with its reason:
- Stages 1-2 (the xi0 seed, _atm_skews, the H and eta seeds) and
  _skew_prefactor on the same surface: bit for bit (the same float64 NumPy
  code in both packages).
- The JAX file's CPU-cheap tests (tests/test_rbergomi_calibration.py) on
  the port at their own bars: the seeds recovered from the short-time
  asymptote to 1e-6 (xi0), 1e-3 (H) and 2% (eta); the linear smile's
  skews to 1e-12; the quadratic smile's to 0.05.
- The MC engine (_expiry_ivs): its per-strike control variate equals
  core/stats.optimal_cv_beta and masked_mean_stderr strike by strike
  within 1e-5 relative on the IV (the same float32 reductions, batched
  over strikes in another order: 1.5e-6 measured); common random numbers
  bit for bit.
- The round trip at the JAX slow test's budget (synthetic 2^14 paths, 48
  steps a year; the engine 2^13 paths, 32 steps a year, 60 polish
  evaluations) at its bars: xi0 within 25%, H within 0.15, eta within 50%,
  the independent-seed IV RMSE below 0.02. It takes ~40 s on the CPU and is
  marked slow, as the JAX package's is; chip_smoke.py's R4 runs the full
  budget on the card.
- The app's wiring with the engine stubbed (tests/test_apps.py:712-748):
  the knobs passed through, the recovery errors, the reference's exits.
"""

import numpy as np
import pytest
import torch

from options_model_tpu.calibration import rbergomi as jcrb
from options_model_tpu.core.config import RBergomiParams as JRBergomiParams
from options_model_tpu_torch.apps import calibrate as app
from options_model_tpu_torch.calibration import rbergomi as crb
from options_model_tpu_torch.core.config import RBergomiParams
from options_model_tpu_torch.core.stats import masked_mean_stderr, optimal_cv_beta
from options_model_tpu_torch.models.rbergomi import terminal_cv_core
from options_model_tpu_torch.ops.cuda_heston import PATH_TILE
from options_model_tpu_torch.pricers.blackscholes import bs_price
from _torch_threads import one_torch_thread_module  # noqa: F401

S0, RATE = 100.0, 0.05
STRIKES = np.array([85.0, 92.5, 100.0, 107.5, 115.0])
EXPIRIES = np.array([0.1, 0.25, 0.5, 1.0])
CHEAP = dict(polish=False, n_paths=1 << 10, n_steps_per_year=16, device="cpu")

pytestmark = pytest.mark.usefixtures("one_torch_thread_module")


def analytic_surface(params, strikes=STRIKES, expiries=EXPIRIES) -> np.ndarray:
    """IVs from the short-time asymptote the seeding stages invert."""
    k = np.log(strikes / S0)
    psi = (crb._skew_prefactor(params.H) * params.rho * params.eta
           * expiries ** (params.H - 0.5))
    return np.sqrt(params.xi0) + psi[:, None] * k[None, :]


# ---- the JAX file's CPU-cheap tests on the port ------------------------------------

def test_recovers_params_from_asymptotic_surface():
    true = RBergomiParams(H=0.12, eta=1.8, rho=-0.7, xi0=0.05)
    _, summ = crb.calibrate_rbergomi_to_data(STRIKES, EXPIRIES, analytic_surface(true), S0,
                                             RATE, rho=-0.7, skew_weight=0.0, **CHEAP)
    assert summ["xi0_seed"] == pytest.approx(true.xi0, rel=1e-6)
    assert summ["H_seed"] == pytest.approx(true.H, abs=1e-3)
    assert summ["eta_seed"] == pytest.approx(true.eta, rel=2e-2)


def test_h_seed_tracks_skew_decay():
    seeds = []
    for H in (0.08, 0.3):
        iv = analytic_surface(RBergomiParams(H=H, eta=1.5, rho=-0.7, xi0=0.04))
        _, summ = crb.calibrate_rbergomi_to_data(STRIKES, EXPIRIES, iv, S0, RATE, rho=-0.7,
                                                 skew_weight=0.0, **CHEAP)
        seeds.append(summ["H_seed"])
    assert seeds[0] < 0.15 < seeds[1]


def test_flat_surface_falls_back_to_defaults():
    iv = np.full((len(EXPIRIES), len(STRIKES)), 0.2)
    _, summ = crb.calibrate_rbergomi_to_data(STRIKES, EXPIRIES, iv, S0, RATE, rho=-0.7,
                                             **CHEAP)
    assert summ["H_seed"] == pytest.approx(0.2) and summ["eta_seed"] == pytest.approx(1.0)


def test_atm_skews_linear_smile_exact():
    k = np.log(STRIKES / S0)
    ivs = 0.2 + np.outer([0.5, -0.3], k)
    np.testing.assert_allclose(crb._atm_skews(STRIKES, np.array([0.25, 0.5]), ivs, S0),
                               [0.5, -0.3], atol=1e-12)


def test_atm_skews_quadratic_smile_reads_atm_slope():
    k = np.log(STRIKES / S0)
    ivs = (0.2 - 0.4 * k + 0.8 * k * k)[None, :]
    assert crb._atm_skews(STRIKES, np.array([0.5]), ivs, S0)[0] == pytest.approx(-0.4, abs=0.05)


def test_rejects_bad_shape_and_degenerate_rho():
    with pytest.raises(ValueError, match="n_expiry, n_strike"):
        crb.calibrate_rbergomi_to_data(STRIKES, EXPIRIES, np.zeros((2, 2)), S0, RATE,
                                       device="cpu")
    iv = analytic_surface(RBergomiParams(H=0.1, eta=1.5, rho=-0.7, xi0=0.04))
    for rho in (0.0, -1.0, 1.5):
        with pytest.raises(ValueError, match="rho"):
            crb.calibrate_rbergomi_to_data(STRIKES, EXPIRIES, iv, S0, RATE, rho=rho,
                                           device="cpu")


# ---- the deterministic stages against the JAX package ------------------------------

@pytest.mark.parametrize("surface", ["asymptotic", "noisy", "flat_short"])
def test_stages_equal_the_references(surface):
    rng = np.random.default_rng(4)
    iv = analytic_surface(RBergomiParams(H=0.1, eta=1.5, rho=-0.7, xi0=0.04))
    if surface == "noisy":
        iv = iv + 0.004 * rng.standard_normal(iv.shape)
    elif surface == "flat_short":
        iv[0] = 0.2
    kw = dict(polish=False, n_paths=1 << 10, n_steps_per_year=16)
    _, got = crb.calibrate_rbergomi_to_data(STRIKES, EXPIRIES, iv, S0, RATE, rho=-0.7,
                                            device="cpu", **kw)
    _, want = jcrb.calibrate_rbergomi_to_data(STRIKES, EXPIRIES, iv, S0, RATE, rho=-0.7, **kw)
    for key in ("xi0_seed", "H_seed", "eta_seed", "atm_skews", "rho"):
        assert got[key] == want[key], key
    assert np.array_equal(crb._atm_skews(STRIKES, EXPIRIES, iv, S0),
                          jcrb._atm_skews(STRIKES, EXPIRIES, iv, S0))
    for H in (0.03, 0.1, 0.5):
        assert crb._skew_prefactor(H) == jcrb._skew_prefactor(H)


# ---- the MC engine ---------------------------------------------------------------

def test_expiry_ivs_is_the_per_strike_control_variate():
    p = RBergomiParams(H=0.1, eta=1.5, rho=-0.7, xi0=0.04)
    seed, T, Ks = crb._expiry_seed(3, 1), 0.25, STRIKES
    ivs = crb._expiry_ivs(seed, S0, RATE, T, p, 16, 2 * PATH_TILE, Ks, "cpu")
    S_T, G_T = terminal_cv_core(seed, S0, RATE, T, p, 16, 2 * PATH_TILE, device="cpu")
    disc = float(np.exp(-np.float32(RATE) * np.float32(T)))
    from options_model_tpu_torch.pricers.blackscholes import implied_vol
    for i, K in enumerate(Ks):
        pay = disc * torch.clamp_min(K - S_T, 0.0)
        adj = disc * torch.clamp_min(K - G_T, 0.0) - bs_price(
            S0, K, T, RATE, float(np.sqrt(np.float32(0.04))), -1.0, device="cpu")
        b = optimal_cv_beta(pay, adj, pair_block=PATH_TILE)
        m, _, _ = masked_mean_stderr(pay + b * adj, pair_block=PATH_TILE)
        iv = implied_vol(m, S0, K, T, RATE, cp=-1.0, device="cpu")
        np.testing.assert_allclose(float(ivs[i]), float(iv), rtol=1e-5)
    again = crb._surface_ivs(3, p, S0, RATE, Ks, EXPIRIES[:2], 2 * PATH_TILE, 64, device="cpu")
    assert np.array_equal(again, crb._surface_ivs(3, p, S0, RATE, Ks, EXPIRIES[:2],
                                                  2 * PATH_TILE, 64, device="cpu"))
    assert crb._expiry_seed(3, 0) != crb._expiry_seed(3, 1) != crb._expiry_seed(4, 1)


@pytest.mark.slow
def test_mc_round_trip_recovers_parameters():
    """The JAX slow test's round trip at its own budget and bars."""
    true = RBergomiParams(H=0.1, eta=1.5, rho=-0.7, xi0=0.04)
    K, T, iv = crb.create_synthetic_rbergomi_surface(true, S0=S0, rate=RATE, n_paths=1 << 14,
                                                     n_steps_per_year=48, device="cpu")
    params, summ = crb.calibrate_rbergomi_to_data(K, T, iv, S0, RATE, rho=-0.7, seed=3,
                                                  n_paths=1 << 13, n_steps_per_year=32,
                                                  max_polish_evals=60, device="cpu")
    assert params.xi0 == pytest.approx(true.xi0, rel=0.25)
    assert abs(params.H - true.H) < 0.15
    assert params.eta == pytest.approx(true.eta, rel=0.5)
    assert summ["error"] < 0.02 and summ["surface_evals"] >= summ["polish_evals"]


# ---- the app -----------------------------------------------------------------------

def test_app_rbergomi_wiring(monkeypatch):
    calls = {}

    def fake_surface(true, S0=100.0, rate=0.05, noise_std=0.0, seed=42, device=None):
        calls["true"], calls["surface_device"] = true, device
        return np.array([90.0, 100.0, 110.0]), np.array([0.25, 1.0]), np.full((2, 3), 0.2)

    def fake_fit(K, T, iv, S0, rate, *, rho, seed, max_polish_evals, device):
        calls.update(rho=rho, evals=max_polish_evals, seed=seed, device=device)
        p = RBergomiParams(H=0.12, eta=1.4, rho=rho, xi0=0.041)
        return p, {"error": 0.002, "fitted": {"H": p.H, "eta": p.eta, "xi0": p.xi0}}

    monkeypatch.setattr(crb, "create_synthetic_rbergomi_surface", fake_surface)
    monkeypatch.setattr(crb, "calibrate_rbergomi_to_data", fake_fit)
    summary = app.run(app.parse_args(["--test", "--model", "rbergomi", "--rho", "-0.6",
                                      "--polish-evals", "40", "--seed", "5"]), device="cpu")
    assert calls["rho"] == -0.6 and calls["evals"] == 40 and calls["seed"] == 5
    assert calls["true"].rho == -0.6 and str(calls["device"]) == "cpu"
    assert summary["param_errors"]["H"] == pytest.approx(0.02)
    assert summary["params"].eta == 1.4 and summary["true_params"].H == 0.1
    jt = JRBergomiParams(H=0.1, eta=1.5, rho=-0.6, xi0=0.04)
    assert RBergomiParams.from_reference(vars(jt)) == calls["true"]
    with pytest.raises(SystemExit, match="price-surface"):
        app.run(app.parse_args(["--test", "--model", "rbergomi", "--price-surface", "x.csv"]),
                device="cpu")
    with pytest.raises(NotImplementedError, match="options_model_tpu\\."):
        app.run(app.parse_args(["--model", "rbergomi", "--ticker", "AAPL"]), device="cpu")


def test_entry_points_without_a_device_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py R4 drives the calibrator")
    p = RBergomiParams(H=0.1, eta=1.5, rho=-0.7, xi0=0.04)
    with pytest.raises(RuntimeError, match="CUDA"):
        crb.create_synthetic_rbergomi_surface(p, n_paths=PATH_TILE)
    iv = analytic_surface(p)
    with pytest.raises(RuntimeError, match="CUDA"):
        crb.calibrate_rbergomi_to_data(STRIKES, EXPIRIES, iv, S0, RATE, polish=False)
