"""The port's closed forms and host oracles held against the JAX package.

- bs_price in float32 within 1e-6 relative (the erfc-based CDF in both).
- heston_cos_price in float32 within 2e-3 absolute: the COS series' f32
  noise floor (each of the 256 terms is rounded coherently across k, as
  calibration/charfn.py documents).
- heston_cos_price in float64 within 1e-6 of the JAX package's in its
  explicit-x64 mode. That mode's complex128 sqrt, exp and log on the CPU
  are off by up to ~3e-7 from numpy's (measured), which bounds the
  agreement; the port's characteristic function itself matches a numpy
  complex128 transcription of the same formula within 1e-12.
- The copied CRR and ADI oracles equal the JAX package's to 1e-12.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from options_model_tpu.calibration.calibrator import (_explicit_x64_scope,
                                                      _try_enable_explicit_x64)
from options_model_tpu.calibration.charfn import heston_cos_price as j_heston_cos_price
from options_model_tpu.core.config import HestonParams as JHestonParams
from options_model_tpu.pricers.binomial import crr_price as j_crr_price
from options_model_tpu.pricers.blackscholes import bs_price as j_bs_price
from options_model_tpu.pricers.fd_heston import heston_fd_price as j_heston_fd_price
from options_model_tpu_torch.calibration.charfn import heston_charfn, heston_cos_price
from options_model_tpu_torch.core.config import HestonParams
from options_model_tpu_torch.pricers.binomial import crr_american, crr_price
from options_model_tpu_torch.pricers.blackscholes import bs_price
from options_model_tpu_torch.pricers.fd_heston import heston_fd_price

J_HESTON = JHestonParams(kappa=2.0, theta=0.04, xi=0.3, rho=-0.7, v0=0.04)
HESTON = HestonParams.from_reference(vars(J_HESTON))
RNG = np.random.default_rng(2026)
K_GRID = np.linspace(70.0, 130.0, 13).astype(np.float32)
T_GRID = np.array([0.1, 0.5, 1.0, 2.0], np.float32)


@pytest.mark.parametrize("cp", [1.0, -1.0])
@pytest.mark.parametrize("q", [0.0, 0.02])
def test_bs_price_matches(cp, q):
    S = RNG.uniform(60.0, 140.0, 256).astype(np.float32)
    T = RNG.uniform(0.05, 3.0, 256).astype(np.float32)
    sig = RNG.uniform(0.1, 0.6, 256).astype(np.float32)
    got = bs_price(torch.from_numpy(S), 100.0, torch.from_numpy(T), 0.05,
                   torch.from_numpy(sig), cp, q=q, device="cpu").numpy()
    want = np.asarray(j_bs_price(jnp.asarray(S), 100.0, jnp.asarray(T), 0.05,
                                 jnp.asarray(sig), cp, q=q))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * float(np.abs(want).max()))


@pytest.mark.parametrize("cp", [1.0, -1.0])
def test_heston_cos_float32_matches_within_noise_floor(cp):
    K, T = np.meshgrid(K_GRID, T_GRID)
    got = heston_cos_price(100.0, torch.from_numpy(K), torch.from_numpy(T), 0.05, HESTON,
                           cp=cp, q=0.01, device="cpu").numpy()
    want = np.asarray(j_heston_cos_price(100.0, jnp.asarray(K), jnp.asarray(T), 0.05,
                                         J_HESTON, cp=cp, q=0.01))
    assert got.shape == want.shape == K.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-3)


def test_heston_cos_float64_matches():
    if not _try_enable_explicit_x64():
        pytest.skip("explicit x64 dtypes unavailable in this JAX")
    K, T = np.meshgrid(K_GRID.astype(np.float64), T_GRID.astype(np.float64))
    got = heston_cos_price(100.0, torch.from_numpy(K), torch.from_numpy(T), 0.05, HESTON,
                           cp=-1.0, dtype=torch.float64, device="cpu").numpy()
    with contextlib.ExitStack() as st:
        st.enter_context(_explicit_x64_scope())
        st.enter_context(jax.default_device(jax.devices("cpu")[0]))
        want = np.asarray(j_heston_cos_price(
            jnp.asarray(100.0, jnp.float64), jnp.asarray(K, jnp.float64),
            jnp.asarray(T, jnp.float64), 0.05, J_HESTON, cp=-1.0, dtype=jnp.float64))
    assert want.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def _charfn_numpy(u, T, r, p):
    """The little-trap characteristic function in numpy complex128."""
    iu = 1j * u
    beta = p.kappa - p.rho * p.xi * iu
    d = np.sqrt(beta**2 + p.xi**2 * (iu + u**2))
    ratio = -(iu + u**2) / (beta + d)
    g2 = ratio * p.xi**2 / (beta + d)
    e = np.exp(-d * T)
    A = p.kappa * p.theta * ratio * T - (2 * p.kappa * p.theta / p.xi**2) * np.log(
        (1 - g2 * e) / (1 - g2))
    return np.exp(iu * r * T + A + ratio * (1 - e) / (1 - g2 * e) * p.v0)


def test_heston_charfn_float64_matches_numpy():
    u = np.linspace(0.0, 200.0, 401)
    T = np.array([0.1, 0.5, 2.0])[:, None]
    got = heston_charfn(torch.from_numpy(u), torch.from_numpy(T), 0.05, HESTON,
                        dtype=torch.complex128).numpy()
    np.testing.assert_allclose(got, _charfn_numpy(u.astype(complex), T, 0.05, HESTON),
                               rtol=0, atol=1e-12)


def test_heston_cos_takes_a_tensor_spot_and_keeps_parity():
    """The control variate passes S_paths[0, 0]; put-call parity holds."""
    S0 = torch.tensor(100.0)
    c = heston_cos_price(S0, 105.0, 0.5, 0.05, HESTON, cp=1.0, dtype=torch.float64)
    p = heston_cos_price(S0, 105.0, 0.5, 0.05, HESTON, cp=-1.0, dtype=torch.float64)
    assert c.shape == () and c.device == S0.device
    assert float(c - p) == pytest.approx(100.0 - 105.0 * np.exp(-0.025), abs=1e-9)


@pytest.mark.parametrize("cp, american", [(-1.0, True), (1.0, True), (-1.0, False)])
def test_crr_oracle_equals_reference(cp, american):
    args = (100.0, 95.0, 0.75, 0.04, 0.25, cp, 512)
    got = crr_price(*args, american=american, q=0.01)
    want = j_crr_price(*args, american=american, use_native=False, q=0.01)
    assert got == pytest.approx(want, rel=0, abs=1e-12)
    assert crr_american(100.0, 100.0, 0.5, 0.05, 0.2, cp=-1.0, n_steps=256) == pytest.approx(
        j_crr_price(100.0, 100.0, 0.5, 0.05, 0.2, -1.0, 256, use_native=False), abs=1e-12)


@pytest.mark.parametrize("american, exercise_dates", [(True, None), (False, None),
                                                      (True, 10)])
def test_adi_oracle_equals_reference(american, exercise_dates):
    kw = dict(cp=-1.0, american=american, n_s=40, n_v=20, n_t=40,
              exercise_dates=exercise_dates)
    got = heston_fd_price(100.0, 100.0, 0.5, 0.05, HESTON, **kw)
    want = j_heston_fd_price(100.0, 100.0, 0.5, 0.05, J_HESTON, **kw)
    assert got == pytest.approx(want, rel=0, abs=1e-12)
