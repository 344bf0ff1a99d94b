"""Variance and volatility swaps of the port on the CPU
(options_model_tpu_torch/pricers/varswap.py) against the JAX package
(options_model_tpu/pricers/varswap.py) and its tests' checks
(tests/test_varswap.py) at smaller sizes, on the port's own stream; and the
pricers package's exports of this slice.

Tolerances, each with its reason:
- The closed forms: 1e-12 relative (the same float64 Python arithmetic).
- The realized-variance statistics on the JAX package's path matrix in
  float64: 1e-10 relative.
- The Monte-Carlo checks: the JAX tests' bars, whose stderr terms scale
  with the smaller sample (2^14 paths where the reference takes 2^16).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from options_model_tpu.core.config import BatesParams as JBatesParams
from options_model_tpu.core.config import HestonParams as JHestonParams
from options_model_tpu.core.config import MCConfig as JMCConfig
from options_model_tpu.core.config import MertonParams as JMertonParams
from options_model_tpu.core.config import VGParams as JVGParams
from options_model_tpu.core.stats import masked_mean_stderr as jmasked_mean_stderr
from options_model_tpu.pricers import varswap as jv
from options_model_tpu.pricers.american import simulate_paths as jsimulate_paths
from options_model_tpu_torch import pricers as tpricers
from options_model_tpu_torch.core.config import (BatesParams, HestonParams, MCConfig,
                                                  MertonParams, VGParams)
from options_model_tpu_torch.pricers import varswap as tv
from options_model_tpu_torch.pricers.american import _pair_block, simulate_paths
from _torch_threads import one_torch_thread_module  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread_module")

S0, R = 100.0, 0.05                                  # tests/test_varswap.py:18-21
HPD = dict(kappa=2.0, theta=0.04, xi=0.4, rho=-0.6, v0=0.09)
MPD = dict(sigma=0.2, lam=0.5, mu_j=-0.1, sigma_j=0.15)
JD = dict(lam=0.5, mu_j=-0.1, sigma_j=0.15)
VGD = dict(sigma=0.18, theta=-0.14, nu=0.35)
HP, MP, VG = HestonParams(**HPD), MertonParams(**MPD), VGParams(**VGD)
BP = BatesParams(heston=HP, **JD)
FAMILIES = {"gbm": (dict(sigma=0.25), dict(sigma=0.25)),
            "heston": (dict(heston=HP), dict(heston=JHestonParams(**HPD))),
            "merton": (dict(merton=MP), dict(merton=JMertonParams(**MPD))),
            "bates": (dict(bates=BP), dict(bates=JBatesParams(heston=JHestonParams(**HPD),
                                                              **JD))),
            "vg": (dict(vg=VG), dict(vg=JVGParams(**VGD)))}


def _gen(s):
    return torch.Generator().manual_seed(s)


def _close(a, b, rtol=1e-12):
    assert abs(a - b) <= rtol * max(abs(b), 1e-300), (a, b)


@pytest.mark.parametrize("model", list(FAMILIES))
@pytest.mark.parametrize("T", [0.25, 0.7, 2.0])
def test_strikes_match_the_reference(model, T):
    mine, ref = FAMILIES[model]
    _close(tv.varswap_strike(T, model, **mine), jv.varswap_strike(T, model, **ref))
    _close(tv.varswap_strike_replication(T, model, **mine),
           jv.varswap_strike_replication(T, model, **ref))
    _close(tv.forward_varswap_strike(T / 4, T, model, **mine),
           jv.forward_varswap_strike(T / 4, T, model, **ref))
    _close(tv.forward_varswap_strike(0.0, T, model, **mine),
           jv.forward_varswap_strike(0.0, T, model, **ref))
    kind, diff, qv, rep = tv._family(model, mine.get("sigma"), mine.get("heston"),
                                     mine.get("merton"), mine.get("bates"), mine.get("vg"))
    jkind, jdiff, jqv, jrep = jv._family(model, ref.get("sigma"), ref.get("heston"),
                                         ref.get("merton"), ref.get("bates"), ref.get("vg"))
    assert kind == jkind and qv == jqv and rep == jrep
    if kind == "gbm":
        assert diff == jdiff


@pytest.mark.parametrize("T", [1e-9, 0.8, 500.0])
def test_integrated_variance_and_jump_terms(T):
    _close(tv.heston_integrated_variance(HP, T),
           jv.heston_integrated_variance(JHestonParams(**HPD), T))
    _close(tv._jump_qv(**JD), jv._jump_qv(**JD))
    _close(tv._jump_replication(**JD), jv._jump_replication(**JD))
    _close(tv.varswap_pv(0.05, 0.04, T, R, 100.0), jv.varswap_pv(0.05, 0.04, T, R, 100.0))


def test_closed_form_checks():
    """tests/test_varswap.py:24-99."""
    assert tv.varswap_strike(0.7, "gbm", sigma=0.2) == pytest.approx(0.04)
    T = 0.8
    t = np.linspace(0.0, T, 20001)
    quad = np.trapezoid(HP.theta + (HP.v0 - HP.theta) * np.exp(-HP.kappa * t), t) / T
    assert tv.heston_integrated_variance(HP, T) == pytest.approx(quad, rel=1e-8)
    assert tv.heston_integrated_variance(HP, 1e-9) == pytest.approx(HP.v0)
    jump_qv = MP.lam * (MP.mu_j**2 + MP.sigma_j**2)
    assert tv.varswap_strike(0.6, "merton", merton=MP) == pytest.approx(MP.sigma**2 + jump_qv)
    gap = (tv.varswap_strike_replication(0.6, "merton", merton=MP)
           - tv.varswap_strike(0.6, "merton", merton=MP))
    assert gap < 0.0
    kf = tv.forward_varswap_strike(0.25, 1.0, "heston", heston=HP)
    assert 0.25 * tv.varswap_strike(0.25, "heston", heston=HP) + 0.75 * kf == pytest.approx(
        tv.varswap_strike(1.0, "heston", heston=HP))
    assert tv.varswap_pv(0.05, 0.04, 1.0, R, notional_var=100.0) == pytest.approx(
        100.0 * math.exp(-R) * 0.01)


@pytest.mark.parametrize("call,match", [
    (lambda: tv.forward_varswap_strike(1.0, 0.5, "gbm", sigma=0.2), "T1 < T2"),
    (lambda: tv.varswap_strike(0.5, "gbm"), "needs sigma"),
    (lambda: tv.varswap_strike(-0.5, "gbm", sigma=0.2), "positive"),
    (lambda: tv.varswap_strike(0.5, "localvol", sigma=0.2), "support"),
    (lambda: tv.varswap_strike(0.5, "heston"), "HestonParams"),
    (lambda: tv.heston_integrated_variance(HP, 0.0), "positive")])
def test_guards(call, match):
    with pytest.raises(ValueError, match=match):
        call()


def test_rv_statistics_on_identical_paths():
    T = 0.5
    S = np.asarray(jsimulate_paths(jax.random.key(9), S0, T,
                                   JMCConfig(n_paths=8192, n_steps=16, path_block=4096),
                                   "gbm", sigma=0.2, rate=R)).astype(np.float64)
    got = tv.rv_statistics(torch.from_numpy(S), T, 4096)
    with jax.enable_x64(True):
        Sj = jnp.asarray(S)
        logret = jnp.diff(jnp.log(Sj), axis=0)
        rv = jnp.sum(logret * logret, axis=0) / jnp.asarray(T, Sj.dtype)
        want = dict(zip(("var_strike", "var_stderr"),
                        (float(x) for x in jmasked_mean_stderr(rv, pair_block=4096)[:2])))
        want.update(zip(("vol_strike", "vol_stderr"),
                        (float(x) for x in jmasked_mean_stderr(jnp.sqrt(rv),
                                                               pair_block=4096)[:2])))
    for key, w in want.items():
        _close(got[key], w, 1e-10)
    assert got["n_paths"] == 8192


MC = MCConfig(n_paths=1 << 14, n_steps=64)


def test_gbm_mc_matches_closed_form():
    T, sig = 0.7, 0.25
    res = tv.varswap_mc(_gen(1), S0, T, MC, "gbm", sigma=sig, rate=R, device="cpu")
    bias = (R - 0.5 * sig**2) ** 2 * T / MC.n_steps
    assert abs(res["var_strike"] - sig**2 - bias) < 4 * res["var_stderr"]
    assert res["vol_strike"] <= math.sqrt(res["var_strike"]) + 1e-9
    assert res["vol_strike"] == pytest.approx(sig, abs=0.01)
    assert res["n_paths"] == 1 << 14


@pytest.mark.parametrize("scheme", ["euler", "qe"])
def test_heston_mc_matches_integrated_variance(scheme):
    T = 0.5
    res = tv.varswap_mc(_gen(2), S0, T, MCConfig(n_paths=1 << 14, n_steps=128), "heston",
                        heston=HP, rate=R, heston_scheme=scheme, device="cpu")
    assert abs(res["var_strike"] - tv.varswap_strike(T, "heston", heston=HP)) < (
        4 * res["var_stderr"] + 2e-3)


def test_jump_families_mc_see_jump_variance():
    res = tv.varswap_mc(_gen(3), S0, 1.0, MC, "merton", merton=MP, rate=R, device="cpu")
    truth = tv.varswap_strike(1.0, "merton", merton=MP)
    assert abs(res["var_strike"] - truth) < 4 * res["var_stderr"] + 1e-3
    assert res["var_strike"] > MP.sigma**2 + 2 * res["var_stderr"]
    vg = tv.varswap_mc(_gen(4), S0, 0.5, MCConfig(n_paths=1 << 13, n_steps=32), "vg", vg=VG,
                       rate=R, device="cpu")
    assert abs(vg["var_strike"] - tv.varswap_strike(0.5, "vg", vg=VG)) < (
        4 * vg["var_stderr"] + 2e-3)


def test_stderr_is_pair_aware():
    """tests/test_varswap.py:165-183: the reported stderr is the pair-mean
    one over the kernel's mirror tiles, on the same paths."""
    T, mc = 0.5, MCConfig(n_paths=1 << 14, n_steps=16)
    res = tv.varswap_mc(_gen(5), S0, T, mc, "gbm", sigma=0.2, rate=R, device="cpu")
    S = simulate_paths(_gen(5), S0, T, mc, "gbm", sigma=0.2, rate=R, device="cpu").numpy()
    rv = (np.diff(np.log(S.astype(np.float64)), axis=0) ** 2).sum(0) / T
    half = _pair_block(mc, "gbm") // 2
    pair_means = rv.reshape(-1, 2, half).mean(axis=1).reshape(-1)
    se_direct = pair_means.std(ddof=0) / math.sqrt(pair_means.size)
    assert res["var_stderr"] == pytest.approx(se_direct, rel=1e-3)


def test_engine_and_device_rules():
    with pytest.raises(ValueError, match="engine"):
        tv.varswap_mc(_gen(1), S0, 0.5, MC, "gbm", sigma=0.2, engine="cuda", device="cpu")
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py drives the kernels")
    with pytest.raises(RuntimeError, match="CUDA"):
        tv.varswap_mc(_gen(1), S0, 0.5, MC, "gbm", sigma=0.2)


NAMES = ["price_barrier_mc", "price_basket_mc", "geometric_basket_bs_price",
         "price_american_basket", "price_american_asian", "price_asian_mc", "price_lookback_mc",
         "geometric_asian_bs_price", "asian_binomial_price", "forward_varswap_strike",
         "varswap_mc", "varswap_pv", "varswap_strike", "varswap_strike_replication"]


@pytest.mark.parametrize("name", NAMES)
def test_the_slice_is_exported(name):
    import options_model_tpu.pricers as jp

    assert name in tpricers.__all__ and name in jp.__all__
    assert callable(getattr(tpricers, name))
    module = tpricers._EXPORTS[name]
    assert module in tpricers.__doc__


@pytest.mark.parametrize("name", ["simulate_gbm_basket", "gbm_basket_terminal_exact",
                                  "correlation_cholesky"])
def test_the_simulator_is_exported(name):
    from options_model_tpu_torch import models

    assert name in models.__all__ and callable(getattr(models, name))
