"""The port's SVI surface (options_model_tpu_torch/surface/svi.py) held
against the JAX package and tests/test_svi.py's bars on the CPU: the slice
round trip, the elementwise functions and diagnostics on the same slices
(within 1e-5 of the JAX functions, both float32), the chain grouping, the
engine adapter, and the flat surface repriced against Black-Scholes through
the table route at a CPU-small size. One torch thread.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from options_model_tpu.surface import svi as jsvi
from options_model_tpu_torch.core.config import CALL, MCConfig, OptionSpec
from options_model_tpu_torch.data.synthetic import synthetic_smile_surface
from options_model_tpu_torch.pricers.blackscholes import bs_price
from options_model_tpu_torch.pricers.european import make_terminal_sampler, price_european_mc
from options_model_tpu_torch.surface.cheb import compile_localvol_table
from options_model_tpu_torch.surface.svi import (SVILocalVolEngine, SVISlice, SVISurface,
                                                 _w_and_k_derivs, fit_svi_from_chain,
                                                 fit_svi_slice, fit_svi_surface,
                                                 svi_butterfly_g, svi_total_variance)
from _torch_threads import one_torch_thread_module  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread_module")

S0, R = 100.0, 0.05
CPU = "cpu"
# Slices of a Heston-like surface (calendar-clean, butterfly-clean) and the
# Gatheral-Jacquier vintage slice with butterfly arbitrage near k ~ 0.4.
SLICES = [dict(a=0.008, b=0.06, rho=-0.55, m=0.02, s=0.15),
          dict(a=0.016, b=0.07, rho=-0.5, m=0.03, s=0.2),
          dict(a=0.024, b=0.08, rho=-0.45, m=0.04, s=0.25),
          dict(a=0.032, b=0.09, rho=-0.4, m=0.05, s=0.3)]
BAD = dict(a=-0.0410, b=0.1331, rho=0.3060, m=0.3586, s=0.4153)
EXPIRIES = (0.25, 0.5, 0.75, 1.0)


def _surfaces(slices=SLICES, expiries=EXPIRIES):
    kw = dict(S0=S0, rate=R, div_yield=0.0, expiries=tuple(expiries))
    return (SVISurface(slices=tuple(SVISlice(**d) for d in slices), **kw),
            jsvi.SVISurface(slices=tuple(jsvi.SVISlice(**d) for d in slices), **kw))


@pytest.fixture(scope="module")
def flat_surface():
    Ks = np.linspace(70.0, 130.0, 13)
    surf, infos = fit_svi_surface(S0, R, list(EXPIRIES), [Ks] * 4, [np.full_like(Ks, 0.2)] * 4,
                                  device=CPU)
    return surf, infos


def test_slice_fit_round_trip():
    """tests/test_svi.py:24-35: rmse < 1e-6 and every parameter within 1e-4."""
    truth = SVISlice(a=0.01, b=0.1, rho=-0.4, m=0.05, s=0.2)
    T, F = 0.5, 100.0
    Ks = np.linspace(70.0, 130.0, 15)
    ivs = np.sqrt(svi_total_variance(torch.from_numpy(np.log(Ks / F)), truth).numpy() / T)
    sl, info = fit_svi_slice(F, T, Ks, ivs, device=CPU)
    assert info["rmse_iv"] < 1e-6 and info["success"]
    for name in ("a", "b", "rho", "m", "s"):
        assert getattr(sl, name) == pytest.approx(getattr(truth, name), abs=1e-4), name
    with pytest.raises(ValueError):
        SVISlice(a=-0.5, b=0.1, rho=0.0, m=0.0, s=0.1).validate()
    with pytest.raises(ValueError):
        SVISlice(a=0.01, b=-0.1, rho=0.0, m=0.0, s=0.1).validate()


@pytest.mark.parametrize("d", SLICES[:2] + [BAD])
def test_elementwise_functions_match_jax(d):
    k = np.linspace(-1.5, 1.5, 301).astype(np.float32)
    sl, jsl = SVISlice(**d), jsvi.SVISlice(**d)
    kt, kj = torch.from_numpy(k), jnp.asarray(k)
    np.testing.assert_allclose(svi_total_variance(kt, sl).numpy(),
                               np.asarray(jsvi.svi_total_variance(kj, jsl)), atol=1e-5, rtol=0)
    for a, b in zip(_w_and_k_derivs(kt, sl), jsvi._w_and_k_derivs(kj, jsl)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(svi_butterfly_g(kt, sl).numpy(),
                               np.asarray(jsvi.svi_butterfly_g(kj, jsl)), atol=1e-5, rtol=1e-5)


def test_diagnostics_and_iv_match_jax():
    surf, jsurf = _surfaces()
    for mine, theirs in ((surf.check_butterfly(), jsurf.check_butterfly()),
                         (surf.check_calendar(), jsurf.check_calendar())):
        assert mine["ok"] == theirs["ok"] is True
        key = "min_g" if "min_g" in mine else "min_gap"
        np.testing.assert_allclose(mine[key], theirs[key], atol=1e-5)
    bad, jbad = _surfaces([BAD], [0.5])
    assert not bad.check_butterfly()["ok"] and not jbad.check_butterfly()["ok"]
    np.testing.assert_allclose(bad.check_butterfly()["min_g"], jbad.check_butterfly()["min_g"],
                               atol=1e-5)
    flipped, jflipped = _surfaces(SLICES[::-1])
    assert not flipped.check_calendar()["ok"] and not jflipped.check_calendar()["ok"]
    for K, T in ((105.0, 0.1), (80.0, 0.25), (120.0, 0.6), (100.0, 1.0), (90.0, 1.7)):
        assert float(surf.iv(K, T)) == pytest.approx(float(jsurf.iv(K, T)), abs=1e-5), (K, T)
    one, jone = _surfaces(SLICES[:1], [0.5])
    assert float(one.iv(100.0, 0.3)) == pytest.approx(float(jone.iv(100.0, 0.3)), abs=1e-5)
    with pytest.raises(ValueError):
        one.local_vol_fn(T_option=0.5)


@pytest.mark.parametrize("T_option,tau", [(0.75, 0.75), (0.75, 0.6), (0.75, 0.3), (0.9, 0.05),
                                          (1.2, 0.1), (0.75, 0.7499)])
def test_local_vol_fn_matches_jax(T_option, tau):
    """Dupire local vol at calendar times before the first expiry (the T = 0
    anchor), inside brackets, past the last expiry and at t ~ 0."""
    surf, jsurf = _surfaces()
    S = np.linspace(60.0, 150.0, 64).astype(np.float32)
    got = surf.local_vol_fn(T_option)(torch.from_numpy(S), torch.tensor(tau))
    want = jsurf.local_vol_fn(T_option)(jnp.asarray(S), jnp.float32(tau))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_flat_fit_and_local_vol(flat_surface):
    surf, infos = flat_surface
    assert all(i["rmse_iv"] < 1e-5 for i in infos)
    for T in (0.25, 0.4, 0.8, 1.0):
        assert float(surf.iv(105.0, T)) == pytest.approx(0.2, abs=2e-4), T
    sig = surf.local_vol_fn(T_option=0.9)(torch.tensor([80.0, 100.0, 125.0]), torch.tensor(0.4))
    np.testing.assert_allclose(sig.numpy(), 0.2, atol=2e-4)


def test_flat_surface_reprices_black_scholes_through_a_table(flat_surface):
    """tests/test_svi.py:88-101 through the table route (kernel 7's plain
    version on the CPU): SVI fit -> Dupire local vol -> compiled table ->
    European call within 4 stderr of Black-Scholes, at 2^16 x 32."""
    surf, _ = flat_surface
    T = 0.8
    table = compile_localvol_table(surf.local_vol_fn(T_option=T), 100.0, T, 32, S0)
    sampler = make_terminal_sampler("localvol", S0, R, T, localvol_table=table, device=CPU)
    spec = OptionSpec(strike=100.0, rate=R, cp=CALL)
    p, se, _ = price_european_mc(torch.Generator().manual_seed(2), sampler, spec, T,
                                 MCConfig(n_paths=1 << 16, n_steps=32))
    truth = float(bs_price(S0, 100.0, T, R, 0.2, 1.0, device=CPU))
    assert abs(float(p) - truth) < 4 * float(se)


def test_fit_from_flattened_chain():
    """tests/test_svi.py:145-152."""
    K, T, iv, S0_ = synthetic_smile_surface(S0=S0)
    surf, infos = fit_svi_from_chain(K, T, iv, S0_, rate=R, device=CPU)
    assert len(surf.expiries) == 3
    assert all(i["rmse_iv"] < 5e-3 for i in infos)
    assert surf.check_butterfly()["ok"]


def test_chain_drops_thin_expiries_and_nan_rows():
    """tests/test_svi.py:154-164."""
    K = np.concatenate([np.linspace(80, 120, 9)] * 2 + [[100.0, 105.0]])
    T = np.concatenate([np.full(9, 0.25), np.full(9, 0.5), [1.0, 1.0]])
    iv = np.full(20, 0.2)
    iv[3] = np.nan
    with pytest.raises(ValueError):
        fit_svi_from_chain(K, T, iv, S0, rate=R, min_strikes=9, device=CPU)
    surf, _ = fit_svi_from_chain(K, T, iv, S0, rate=R, min_strikes=8, device=CPU)
    assert surf.expiries == (0.25, 0.5)


def test_engine_adapter(flat_surface):
    """tests/test_svi.py:166-176: bind a maturity first (TypeError), then
    the flat local vol."""
    surf, _ = flat_surface
    eng = SVILocalVolEngine(surf)
    assert eng.get_sigma_iv(100.0, S0, 0.5) == pytest.approx(0.2, abs=2e-4)
    with pytest.raises(ValueError):
        eng.get_sigma_iv(100.0, -1.0, 0.5)
    factory = eng.sigma_fn(100.0)
    with pytest.raises(TypeError):
        factory(torch.ones(4), 0.5)
    sig = factory.for_maturity(0.8)(torch.tensor([90.0, 110.0]), torch.tensor(0.3))
    np.testing.assert_allclose(sig.numpy(), 0.2, atol=2e-4)
