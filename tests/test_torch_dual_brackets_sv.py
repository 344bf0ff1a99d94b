"""The port's Heston and NN-policy primal-dual brackets
(pricers/dual.price_american_bracket) on its own Philox streams, on the
CPU, at the JAX package's test configurations and bars
(tests/test_dual.py:116-148, 266-302): each contains its oracle (ADI,
CRR), its upper bound and width within the reference's tightness bars.
The GBM and jump brackets are in tests/test_torch_dual_brackets.py.
"""

import pytest
import torch

from options_model_tpu_torch.core.config import HestonParams, LSMConfig, MCConfig, OptionSpec
from options_model_tpu_torch.pricers import dual as pd
from options_model_tpu_torch.pricers.binomial import crr_american
from options_model_tpu_torch.pricers.fd_heston import heston_fd_price
from _torch_threads import one_torch_thread  # noqa: F401

S0, K, T, R, SIG = 100.0, 100.0, 0.5, 0.05, 0.2
HP = HestonParams(kappa=2.0, theta=0.04, xi=0.3, rho=-0.7, v0=0.04)
# The reference's NN bracket configuration (its CPU budget): a small net,
# 2^14 x 50 paths, 16 inner draws.
NN = LSMConfig(regressor="nn", nn_epochs=8, nn_hidden=32, nn_layers=2)
MC_NN = MCConfig(n_paths=1 << 14, n_steps=50, path_block=1024)


# One torch intra-op thread: several test workers share the machine, and each
# worker's default pool (a thread a core) oversubscribes the cores (ROADMAP
# item B).
# (tests/_torch_threads.py)
pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _f(br):
    return [float(b) for b in br]


def test_heston_bracket_contains_adi():
    """The Heston bracket (variance basis, the Euler inner step) contains
    the ADI oracle, with the upper within 1% and the bracket under 2% wide
    (tests/test_dual.py:116-148)."""
    adi = heston_fd_price(S0, K, T, R, HP, cp=-1.0, american=True)
    spec = OptionSpec(strike=K, rate=R, cp=-1.0, sigma=None)
    mc = MCConfig(n_paths=1 << 16, n_steps=50, path_block=4096)
    low, low_se, high, high_se = _f(pd.price_american_bracket(
        torch.Generator().manual_seed(0), S0, T, spec, mc, model="heston", heston=HP,
        device="cpu"))
    assert low - 4 * low_se <= adi
    assert high + 4 * high_se >= adi * (1.0 - 0.0015)
    assert high <= adi * 1.01
    assert 0.0 < high - low < adi * 0.02


def test_nn_bracket_contains_crr():
    """The NN-policy bracket at the reference's CPU configuration: contains
    CRR, upper within 1.5%, width under 3% (tests/test_dual.py:266-302)."""
    oracle = crr_american(S0, K, T, R, SIG, cp=-1.0, n_steps=4096)
    spec = OptionSpec(strike=K, rate=R, cp=-1.0, sigma=SIG)
    low, low_se, high, high_se = _f(pd.price_american_bracket(
        torch.Generator().manual_seed(0), S0, T, spec, MC_NN, lsm=NN, n_inner=16, device="cpu"))
    assert low - 4 * low_se <= oracle
    assert high + 4 * high_se >= oracle * (1.0 - 0.0015)
    assert high <= oracle * 1.015
    assert high - low < oracle * 0.03
