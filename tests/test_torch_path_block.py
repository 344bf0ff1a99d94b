"""A ``path_block`` that does not tile with the kernels' PATH_TILE.

The reference accepts any multiple of 256. The antithetic estimators pair
paths within ``_pair_block`` = lcm(path_block, PATH_TILE), so the pricers
simulate n_paths rounded up to whole pair blocks (``simulated_config``):
at path_block 4608 that is 36,864 paths for 20,000 asked, the same
estimator on more paths. Every American route prices there on the CPU, and
the GBM put agrees with the JAX package's default engine at the same
config within 4 combined stderr. Where path_block divides PATH_TILE or is a
multiple of it, the width is the one the kernels round to anyway, and the
paths are the same bits.
"""

import math

import jax
import numpy as np
import pytest
import torch

from options_model_tpu.core.config import PUT
from options_model_tpu.core.config import LSMConfig as JLSMConfig
from options_model_tpu.core.config import MCConfig as JMCConfig
from options_model_tpu.core.config import OptionSpec as JOptionSpec
from options_model_tpu.pricers.american import price_american as j_price_american
from options_model_tpu_torch.core.config import (HestonParams, LSMConfig, MCConfig,
                                                  OptionSpec)
from options_model_tpu_torch.models.blocks import paths_rounded, round_up
from options_model_tpu_torch.ops.cuda_heston import PATH_TILE
from options_model_tpu_torch.pricers.american import (_simulate_for, price_american,
                                                      price_american_with_stats,
                                                      simulate_paths, simulated_config)
from options_model_tpu_torch.pricers.surface_american import price_american_surface

HESTON = HestonParams(kappa=2.0, theta=0.04, xi=0.3, rho=-0.7, v0=0.04)
J_MC = JMCConfig(n_paths=20_000, n_steps=10, path_block=4608)
MC = MCConfig.from_reference(vars(J_MC))
J_SPEC = JOptionSpec(strike=100.0, rate=0.05, cp=PUT, sigma=0.2)
SPEC = OptionSpec.from_reference(vars(J_SPEC))
# The NN-LSM at its smallest test size (tests/test_torch_nn_lsm.py's net), one
# epoch and one fit: the point is the width, not the policy.
SMALL_NN = dict(regressor="nn", nn_hidden=16, nn_layers=1, nn_epochs=1, nn_batch=512,
                nn_policy_iters=1)
ROUTES = {"lsm": dict(use_control_variate=False), "cv": {},
          "richardson": dict(richardson=True), "nn_cv": SMALL_NN,
          "nn_richardson": dict(SMALL_NN, richardson=True)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module: its prices are many small ops,
    which spinning intra-op threads slow many times over when several test
    workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_simulated_width_is_whole_pair_blocks_at_4608():
    cfg = simulated_config(MC, "gbm")
    assert cfg.n_paths == 36_864 == math.lcm(4608, PATH_TILE)
    assert cfg.n_paths % MC.path_block == 0 and cfg.n_paths % PATH_TILE == 0
    S = simulate_paths(_gen(0), 100.0, 0.5, cfg, "gbm", sigma=0.2, rate=0.05, device="cpu")
    assert S.shape == (11, 36_864)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_price_american_prices_at_path_block_4608(route):
    p, se = price_american(_gen(1), 100.0, 0.5, SPEC, MC, LSMConfig(**ROUTES[route]), "gbm",
                           device="cpu")
    assert math.isfinite(float(p)) and math.isfinite(float(se)) and float(se) > 0
    assert 4.2 < float(p) < 5.1


@pytest.mark.parametrize("regressor", ["poly", "nn"])
def test_price_american_with_stats_at_path_block_4608(regressor):
    lsm = LSMConfig(**(SMALL_NN if regressor == "nn" else {}))
    p, se, stats = price_american_with_stats(_gen(2), 100.0, 0.5, SPEC, MC, lsm, "gbm",
                                             device="cpu")
    assert math.isfinite(float(p)) and float(se) > 0
    assert stats["n"] == 36_864 and math.isfinite(stats["std"])


@pytest.mark.parametrize("model", ["gbm", "heston"])
def test_surface_stderr_at_path_block_4608(model):
    Ks, Ts = np.array([90.0, 100.0, 110.0]), np.array([0.25, 0.5])
    P, SE = price_american_surface(_gen(3), 100.0, Ks, Ts, 0.05, MC, model=model,
                                   sigma=0.2 if model == "gbm" else None,
                                   heston=HESTON if model == "heston" else None,
                                   return_stderr=True, device="cpu")
    assert P.shape == SE.shape == (2, 3)
    assert bool(torch.isfinite(P).all()) and bool((SE > 0).all())
    assert bool((P[:, 1:] >= P[:, :-1] - 1e-3).all())


def test_gbm_put_at_4608_agrees_with_the_reference_default_engine():
    p, se = price_american(_gen(4), 100.0, 0.5, SPEC, MC, LSMConfig(), "gbm", device="cpu")
    p_j, se_j = j_price_american(jax.random.key(4), 100.0, 0.5, J_SPEC, J_MC, JLSMConfig(),
                                 "gbm")
    gap = abs(float(p) - float(p_j))
    assert gap <= 4.0 * float(np.hypot(float(se), float(se_j))), (p, se, p_j, se_j)


@pytest.mark.parametrize("path_block", [256, 2048, 4096, 8192])
@pytest.mark.parametrize("n_paths", [5_000, 20_000])
def test_width_unchanged_where_path_block_tiles(path_block, n_paths):
    """The width the kernels gave before: paths_rounded, then PATH_TILE."""
    mc = MCConfig(n_paths=n_paths, n_steps=10, path_block=path_block)
    for model in ("gbm", "heston"):
        assert (simulated_config(mc, model).n_paths
                == round_up(paths_rounded(mc), PATH_TILE))


@pytest.mark.parametrize("model", ["gbm", "heston"])
def test_default_path_block_draws_the_same_paths(model):
    """At the default path_block (4096) the pricers' paths are simulate_paths'
    at the caller's config, bit for bit."""
    mc = MCConfig(n_paths=20_000, n_steps=10)
    lsm = LSMConfig()
    spec = SPEC if model == "gbm" else OptionSpec(strike=100.0, rate=0.05, cp=PUT, sigma=None)
    S, v, _ = _simulate_for(_gen(5), 100.0, 0.5, spec, mc, lsm, model, HESTON, "auto",
                            "euler", "cpu")
    want = simulate_paths(_gen(5), 100.0, 0.5, mc, model, sigma=spec.sigma, rate=0.05,
                          heston=HESTON, return_variance=model == "heston", device="cpu")
    want_S, want_v = want if model == "heston" else (want, None)
    assert S.shape == (11, 20_480)
    assert torch.equal(S, want_S)
    assert (v is None and want_v is None) or torch.equal(v, want_v)
