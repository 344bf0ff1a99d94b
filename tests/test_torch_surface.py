"""The port's strike x maturity surface (pricers/surface_american.py) held
against the JAX package and the oracles.

- The all-strike backward on identical paths (the JAX XLA simulator's Heston
  paths, numpy to torch), with and without the variance basis, both sides
  in float64: prices within 1e-3 absolute, the decision-flip tolerance of
  the LSM backward parity (tests/test_torch_lsm.py), where sums in another
  order flip marginal exercise decisions, each worth O(1) of one path's
  cash. Why float64: the test's docstring.
- A GBM surface against CRR within 1.5% per cell, as
  tests/test_surface_american.py:34-43 but at 25 dates (a Bermudan gap of
  ~0.3%; the degree-3 basis and MC noise take the rest).
- Maturity i draws its own tiles of one seed's stream, so a shorter surface
  is the first rows of a longer one, bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from options_model_tpu.calibration import heston_cos_price
from options_model_tpu.core.config import HestonParams as JHestonParams
from options_model_tpu.core.config import MCConfig as JMCConfig
from options_model_tpu.pricers import american as jam
from options_model_tpu.pricers import surface_american as jsa
from options_model_tpu_torch.core.config import HestonParams, MCConfig
from options_model_tpu_torch.pricers.binomial import crr_american
from options_model_tpu_torch.pricers.blackscholes import bs_price
from options_model_tpu_torch.pricers.surface_american import (lsm_surface_backward,
                                                              price_american_surface,
                                                              price_european_surface_mc)

J_HESTON = JHestonParams(kappa=2.0, theta=0.04, xi=0.3, rho=-0.7, v0=0.04)
HESTON = HestonParams.from_reference(vars(J_HESTON))
STRIKES = np.linspace(80.0, 120.0, 8).astype(np.float32)
T = 0.5


def _gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.fixture(scope="module")
def heston_paths():
    cfg = JMCConfig(n_paths=1 << 13, n_steps=16, path_block=4096)
    S, v = jam.simulate_paths(jax.random.key(9), 100.0, T, cfg, "heston", rate=0.05,
                              heston=J_HESTON, engine="xla", return_variance=True)
    return np.asarray(S, np.float64), np.asarray(v, np.float64)


@pytest.mark.parametrize("with_v", [False, True])
def test_lsm_surface_backward_matches_on_jax_paths(heston_paths, with_v):
    """Both backward passes in float64 on the same paths: within 1e-3 (the
    decision-flip tolerance), measured 2.6e-7 (the port rounds its discount
    factor to f32, as the reference does in f32). In float32 the shared
    global basis leaves the Grams of the far out-of-the-money strikes with a
    condition number near 1e8, and each f32 run, the reference's included,
    lies up to ~1e-2 from the float64 prices (measured on these shapes), so
    f32 against f32 would test the rounding of the Gram, not the port."""
    S, v = heston_paths
    with jax.enable_x64(True):
        p_j = np.asarray(jsa.lsm_surface_backward(
            jnp.asarray(S), jnp.asarray(STRIKES, jnp.float64), 0.05, T, -1.0,
            v_paths=jnp.asarray(v) if with_v else None))
    assert p_j.dtype == np.float64
    v_t = torch.from_numpy(v) if with_v else None
    cash = lsm_surface_backward(torch.from_numpy(S), STRIKES, 0.05, T, -1.0,
                                return_cash=True, v_paths=v_t)
    assert cash.shape == (8, S.shape[1]) and cash.dtype == torch.float64
    np.testing.assert_allclose(cash.mean(dim=1).numpy(), p_j, rtol=0, atol=1e-3)
    # the float32 run stays within the f32 conditioning noise of the same prices
    p32 = lsm_surface_backward(torch.from_numpy(S).float(), STRIKES, 0.05, T, -1.0,
                               v_paths=None if v_t is None else v_t.float())
    np.testing.assert_allclose(p32.numpy(), p_j, rtol=0, atol=2e-2)


def test_gbm_surface_matches_crr():
    Ks = [95.0, 100.0, 105.0]
    mc = MCConfig(n_paths=65536, n_steps=25, path_block=4096)
    P = price_american_surface(_gen(1), 100.0, Ks, [0.5], 0.05, mc, cp=-1.0, model="gbm",
                               sigma=0.2, device="cpu")
    assert P.shape == (1, 3)
    for i, K in enumerate(Ks):
        oracle = crr_american(100.0, K, 0.5, 0.05, 0.2, cp=-1.0, n_steps=2048)
        assert abs(float(P[0, i]) / oracle - 1.0) < 0.015, (K, float(P[0, i]), oracle)


@pytest.mark.parametrize("scheme", ["euler", "qe"])
def test_surface_rows_do_not_depend_on_later_maturities(scheme):
    mc = MCConfig(n_paths=8192, n_steps=8, path_block=4096)
    kw = dict(heston=HESTON, heston_scheme=scheme, device="cpu")
    four = price_american_surface(_gen(2), 100.0, STRIKES, [0.25, 0.5, 0.75, 1.0], 0.05,
                                  mc, **kw)
    two = price_american_surface(_gen(2), 100.0, STRIKES, [0.25, 0.5], 0.05, mc, **kw)
    assert four.shape == (4, 8) and torch.equal(two, four[:2])
    # the rows are distinct streams: the same maturity twice is not the same row
    twice = price_american_surface(_gen(2), 100.0, STRIKES, [0.5, 0.5], 0.05, mc, **kw)
    assert not torch.equal(twice[0], twice[1])


def test_heston_surface_shape_monotone_and_stderr():
    mc = MCConfig(n_paths=16384, n_steps=16, path_block=4096)
    P, se = price_american_surface(_gen(3), 100.0, STRIKES, [0.25, 0.5, 1.0], 0.05, mc,
                                   heston=HESTON, return_stderr=True, device="cpu")
    assert P.shape == se.shape == (3, 8)
    assert bool(torch.isfinite(P).all()) and bool((se > 0).all())
    assert bool((torch.diff(P, dim=1) > -1e-3).all())   # a put rises with the strike
    P2 = price_american_surface(_gen(3), 100.0, STRIKES, [0.25, 0.5, 1.0], 0.05, mc,
                                heston=HESTON, device="cpu")
    assert torch.equal(P, P2)


def test_european_surface_matches_cos():
    Ks = np.linspace(90.0, 110.0, 5).astype(np.float32)
    Ts = np.array([0.25, 0.5], np.float32)
    mc = MCConfig(n_paths=1 << 16, n_steps=32, path_block=4096)
    P = price_european_surface_mc(_gen(4), 100.0, Ks, Ts, 0.05, mc, cp=1.0,
                                  heston=HESTON, device="cpu")
    cos = np.asarray(heston_cos_price(100.0, jnp.asarray(Ks)[None, :],
                                      jnp.asarray(Ts)[:, None], 0.05, J_HESTON, 1.0))
    assert P.shape == (2, 5)
    np.testing.assert_allclose(P.numpy(), cos, atol=0.25)


def test_european_surface_gbm_matches_bs():
    mc = MCConfig(n_paths=1 << 16, n_steps=16, path_block=4096)
    P = price_european_surface_mc(_gen(5), 100.0, [95.0, 105.0], [0.5], 0.05, mc, cp=1.0,
                                  model="gbm", sigma=0.2, device="cpu")
    bs = bs_price(100.0, torch.tensor([95.0, 105.0]), 0.5, 0.05, 0.2, 1.0)
    np.testing.assert_allclose(P[0].numpy(), bs.numpy(), atol=0.15)


def test_surface_refusals():
    mc = MCConfig(n_paths=4096, n_steps=4)

    class TwoDevices:
        def size(self):
            return 2

    with pytest.raises(NotImplementedError, match="options_model_tpu\\."):
        price_american_surface(_gen(6), 100.0, STRIKES, [0.5], 0.05, mc, heston=HESTON,
                               mesh=TwoDevices(), device="cpu")
    with pytest.raises(NotImplementedError, match="options_model_tpu\\."):
        price_american_surface(_gen(6), 100.0, STRIKES, [0.5], 0.05, mc, model="vg",
                               device="cpu")
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="allow_tf32"):
            lsm_surface_backward(torch.full((3, 8192), 100.0), STRIKES, 0.05, T)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
