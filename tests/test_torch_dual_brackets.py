"""The port's primal-dual bracket (pricers/dual.price_american_bracket) on its
own Philox streams, on the CPU (the plain versions of kernels 2, 4, 14, 16,
18 and 19), at the JAX package's test configurations and bars
(tests/test_dual.py): the bracket contains the CRR, ADI or control-variate
price, its width and its upper bound stay within the reference's
tightness bars, it is deterministic for a seeded generator, more inner
draws do not loosen it, the pair-aware stderr changes only the stderr, and
Bates at lam = 0 is the Heston dual.

The two packages draw different streams, so their brackets agree in law,
not draw for draw; tests/test_torch_dual.py holds the port's dual against
the JAX package's on shared paths, policy and draws. The Heston and NN
brackets are in tests/test_torch_dual_brackets_sv.py (each file runs on
one test worker).
"""

import numpy as np
import pytest
import torch

from options_model_tpu_torch.core.config import (BatesParams, HestonParams, LSMConfig,
                                                  MCConfig, MertonParams, OptionSpec)
from options_model_tpu_torch.models.merton import merton_price
from options_model_tpu_torch.pricers import american as pa
from options_model_tpu_torch.pricers import dual as pd
from options_model_tpu_torch.pricers.binomial import crr_american
from _torch_threads import one_torch_thread  # noqa: F401

S0, K, T, R, SIG = 100.0, 100.0, 0.5, 0.05, 0.2
PUT_SPEC = OptionSpec(strike=K, rate=R, cp=-1.0, sigma=SIG)
H_SPEC = OptionSpec(strike=K, rate=R, cp=-1.0, sigma=None)
MC = MCConfig(n_paths=1 << 16, n_steps=50, path_block=4096)
HP = HestonParams(kappa=2.0, theta=0.04, xi=0.3, rho=-0.7, v0=0.04)
MP = MertonParams(sigma=0.2, lam=0.5, mu_j=-0.1, sigma_j=0.15)
BP = BatesParams(heston=HP, lam=0.3, mu_j=-0.1, sigma_j=0.15)
SMALL = MCConfig(n_paths=1 << 14, n_steps=20, path_block=1024)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _f(br):
    return [float(b) for b in br]


# One torch intra-op thread: several test workers share the machine, and each
# worker's default pool (a thread a core) oversubscribes the cores (ROADMAP
# item B).
# (tests/_torch_threads.py)
pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def oracle():
    return crr_american(S0, K, T, R, SIG, cp=-1.0, n_steps=4096)


def test_gbm_put_bracket_contains_crr(oracle):
    """low - 4 se <= CRR <= high + 4 se, with the reference's 0.15%
    Bermudan-vs-continuous slack on the upper side; the upper within 1% of
    CRR and the bracket under 1.5% wide (tests/test_dual.py:71-87)."""
    low, low_se, high, high_se = _f(pd.price_american_bracket(_gen(0), S0, T, PUT_SPEC, MC,
                                                              device="cpu"))
    assert low - 4 * low_se <= oracle
    assert high + 4 * high_se >= oracle * (1.0 - 0.0015)
    assert high <= oracle * 1.01
    assert 0.0 < high - low < oracle * 0.015


def test_call_with_dividends_contains_crr():
    """The dividend call against its CRR (tests/test_dual.py:94-100)."""
    spec = OptionSpec(strike=K, rate=R, cp=1.0, sigma=SIG, div_yield=0.03)
    oc = crr_american(S0, K, T, R, SIG, cp=1.0, n_steps=4096, q=0.03)
    low, low_se, high, high_se = _f(pd.price_american_bracket(_gen(1), S0, T, spec, MC,
                                                              device="cpu"))
    assert low - 4 * low_se <= oc
    assert high + 4 * high_se >= oc * 0.9985
    assert high <= oc * 1.01


def test_in_sample_diagnostic_mode(oracle):
    """out_of_sample=False is approximate (the policy has seen the paths)
    but sits above the oracle here (tests/test_dual.py:102-108)."""
    low, _, high, _ = _f(pd.price_american_bracket(_gen(2), S0, T, PUT_SPEC, MC,
                                                   out_of_sample=False, device="cpu"))
    assert high >= oracle * (1.0 - 0.0015)
    assert low <= high


def test_bracket_is_deterministic():
    """One seeded generator, one bracket, bit for bit (poly and NN)."""
    a = _f(pd.price_american_bracket(_gen(4), S0, T, PUT_SPEC, SMALL, n_inner=8, device="cpu"))
    b = _f(pd.price_american_bracket(_gen(4), S0, T, PUT_SPEC, SMALL, n_inner=8, device="cpu"))
    assert a == b
    nn = LSMConfig(regressor="nn", nn_epochs=1, nn_hidden=8, nn_layers=1)
    mc = MCConfig(n_paths=8192, n_steps=8, path_block=1024)
    a = _f(pd.price_american_bracket(_gen(5), S0, T, PUT_SPEC, mc, lsm=nn, n_inner=4,
                                     device="cpu"))
    b = _f(pd.price_american_bracket(_gen(5), S0, T, PUT_SPEC, mc, lsm=nn, n_inner=4,
                                     device="cpu"))
    assert a == b


@pytest.fixture(scope="module")
def gbm_small():
    S = pa.simulate_paths(_gen(6), S0, T, SMALL, "gbm", sigma=SIG, rate=R, device="cpu")
    return S, pd.fit_lsm_policy(S, PUT_SPEC, T)[0]


def test_more_inner_draws_no_looser(gbm_small):
    """Inner noise only loosens the bound: 256 inner draws give an upper no
    higher than 4 (tests/test_dual.py:362-375)."""
    S, policy = gbm_small
    few, _ = pd.dual_upper_from_policy(11, S, PUT_SPEC, T, policy, n_inner=4)
    many, _ = pd.dual_upper_from_policy(11, S, PUT_SPEC, T, policy, n_inner=256)
    assert float(many) <= float(few)


def test_stderr_pair_discipline(gbm_small):
    """stat_pair_block changes the stderr only (tests/test_dual.py:347-360)."""
    S, policy = gbm_small
    up_raw, se_raw = pd.dual_upper_from_policy(12, S, PUT_SPEC, T, policy, n_inner=8)
    up_pair, se_pair = pd.dual_upper_from_policy(12, S, PUT_SPEC, T, policy, n_inner=8,
                                                 stat_pair_block=SMALL.path_block)
    np.testing.assert_allclose(float(up_raw), float(up_pair), rtol=1e-6)
    assert float(se_pair) != float(se_raw)


def test_bates_lam_zero_is_heston():
    """At lam = 0 the Bates dual is the Heston dual on the same paths and
    seed: the jump layer adds no count and no compensator, and the stream
    gives Bates Heston's normals (tests/test_dual.py:436-459, rtol 2e-5)."""
    mc = MCConfig(n_paths=1 << 13, n_steps=10, path_block=1024)
    S, v = pa.simulate_paths(_gen(7), S0, T, mc, "heston", rate=R, heston=HP,
                             return_variance=True, device="cpu")
    policy, _ = pd.fit_lsm_policy(S, H_SPEC, T, v_paths=v)
    b0 = BatesParams(heston=HP, lam=0.0, mu_j=0.0, sigma_j=0.1)
    up_h, _ = pd.dual_upper_from_policy(3, S, H_SPEC, T, policy, model="heston", heston=HP,
                                        v_paths=v, n_inner=8, inner_block=1024)
    up_b, _ = pd.dual_upper_from_policy(3, S, H_SPEC, T, policy, model="bates", bates=b0,
                                        v_paths=v, n_inner=8, inner_block=1024)
    np.testing.assert_allclose(float(up_b), float(up_h), rtol=2e-5)


@pytest.mark.parametrize("model", ["merton", "bates"])
def test_jump_bracket_contains_cv_price(model):
    """The Merton and Bates brackets contain the port's control-variate
    American price within 3 stderr, under 5% (Merton) or 6% (Bates) wide;
    the Merton upper clears its European (tests/test_dual.py:391-434)."""
    spec = PUT_SPEC if model == "merton" else H_SPEC
    mc = MCConfig(n_paths=1 << 15, n_steps=25, path_block=2048)
    kw = dict(merton=MP) if model == "merton" else dict(bates=BP)
    low, low_se, high, high_se = _f(pd.price_american_bracket(_gen(8), S0, T, spec, mc,
                                                              model=model, device="cpu", **kw))
    p, _ = pa.price_american(_gen(9), S0, T, spec, mc, LSMConfig(use_control_variate=True),
                             model=model, device="cpu", **kw)
    assert low - 3 * low_se <= float(p) <= high + 3 * high_se
    assert (high - low) / float(p) < (0.05 if model == "merton" else 0.06)
    if model == "merton":
        assert high + 3 * high_se > float(merton_price(S0, K, T, R, MP, cp=-1.0, device="cpu"))
