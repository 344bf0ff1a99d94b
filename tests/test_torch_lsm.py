"""The port's Longstaff-Schwartz pieces held against the JAX package on
identical inputs: the centered basis, the small SPD solve, the masked WLS,
and the whole backward induction on path matrices from the JAX XLA
simulators (numpy to torch).

Tolerances:
- rtol 1e-5 on the basis, and normwise 1e-5 on the WLS coefficients (f32
  sums in another order); 1e-4 on the solve (the same, amplified by the
  condition number).
- The fitted continuation on in-the-money rows within 1e-3 absolute of the
  JAX fit and of a float64 solve: with degree 5 the ridge-regularised Gram
  has cond ~1e8, so an f32 solve is good to ~1e-4 there (the JAX package's
  own f32 fit is as far from float64). Out-of-the-money rows, where the fit
  extrapolates to u = 6 and decides nothing, are left out.
- Prices 1e-3 relative: a regression that differs in the last ulps flips
  marginal exercise decisions, each worth O(1) of one path's cash (the
  decision-flip tolerance of the reference's round notes). The
  out-of-sample price averages half the paths (2e-3), and the Richardson
  statistic 2 cash_fine - cash_coarse carries the flips of two backward
  passes with weights up to 3 (3e-3, as the JAX package's own mesh tests
  allow for the same effect).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from options_model_tpu.core.config import PUT
from options_model_tpu.core.config import HestonParams as JHestonParams
from options_model_tpu.core.config import LSMConfig as JLSMConfig
from options_model_tpu.core.config import MCConfig as JMCConfig
from options_model_tpu.core.config import OptionSpec as JOptionSpec
from options_model_tpu.core.stats import masked_mean_stderr as j_masked_mean_stderr
from options_model_tpu.pricers import american as jam
from options_model_tpu.pricers import regressors as jreg
from options_model_tpu_torch.core.config import (HestonParams, LSMConfig, MCConfig,
                                                  OptionSpec)
from options_model_tpu_torch.core.stats import masked_mean_stderr
from options_model_tpu_torch.pricers import american as am
from options_model_tpu_torch.pricers import regressors as reg

J_HESTON = JHestonParams(kappa=2.0, theta=0.04, xi=0.3, rho=-0.7, v0=0.04)
HESTON = HestonParams.from_reference(vars(J_HESTON))
J_MC = JMCConfig(n_paths=1 << 14, n_steps=16, path_block=4096)
T = 0.5
PB = 4096


def _t(x):
    return torch.from_numpy(np.array(x))


def _specs(sigma):
    js = JOptionSpec(strike=100.0, rate=0.05, cp=PUT, sigma=sigma)
    return js, OptionSpec.from_reference(vars(js))


@pytest.fixture(scope="module")
def heston_paths():
    S, v = jam.simulate_paths(jax.random.key(7), 100.0, T, J_MC, "heston", rate=0.05,
                              heston=J_HESTON, engine="xla", return_variance=True)
    return np.asarray(S), np.asarray(v)


@pytest.fixture(scope="module")
def gbm_paths():
    return np.asarray(jam.simulate_paths(jax.random.key(8), 100.0, T, J_MC, "gbm",
                                         sigma=0.2, rate=0.05, engine="xla"))


def test_configs_carry_over_from_the_reference():
    jl = JLSMConfig(poly_degree=5, variance_basis_degree=3, richardson=True)
    lsm = LSMConfig.from_reference(vars(jl))
    assert lsm == LSMConfig(poly_degree=5, variance_basis_degree=3, richardson=True)
    mc = MCConfig.from_reference(vars(J_MC))
    assert mc == MCConfig(n_paths=1 << 14, n_steps=16, path_block=4096)
    assert mc.dtype == torch.float32
    assert HESTON == HestonParams(2.0, 0.04, 0.3, -0.7, 0.04)
    assert _specs(0.2)[1] == OptionSpec(strike=100.0, rate=0.05, cp=-1.0, sigma=0.2)


@pytest.mark.parametrize("poly_degree, v_degree", [(3, 2), (5, 3)])
def test_centered_basis_matches(heston_paths, poly_degree, v_degree):
    S, v = heston_paths
    S_t, v_t = S[8], v[8]
    itm = (np.maximum(100.0 - S_t, 0.0) > 0).astype(np.float32)
    X_j, st_j = jam.build_centered_basis(jnp.asarray(S_t), 100.0, jnp.asarray(itm),
                                         poly_degree, lambda x: x, v_t=jnp.asarray(v_t),
                                         return_stats=True, v_degree=v_degree)
    X, st = am.build_centered_basis(_t(S_t), 100.0, _t(itm), poly_degree, v_t=_t(v_t),
                                    return_stats=True, v_degree=v_degree)
    assert X.shape == X_j.shape == (S_t.shape[0], poly_degree + 2 + 3 * (v_degree - 1))
    np.testing.assert_allclose(X.numpy(), np.asarray(X_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose([float(a) for a in st], [float(a) for a in st_j], rtol=1e-5)


def test_solve_spd_small_matches():
    rng = np.random.default_rng(0)
    M = rng.standard_normal((13, 13)).astype(np.float32)
    A = (M @ M.T + 13.0 * np.eye(13)).astype(np.float32)
    b = rng.standard_normal(13).astype(np.float32)
    x = reg.solve_spd_small(_t(A), _t(b)).numpy()
    x_j = np.asarray(jreg.solve_spd_small(jnp.asarray(A), jnp.asarray(b)))
    np.testing.assert_allclose(x, x_j, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(x, np.linalg.solve(A.astype(np.float64), b), rtol=1e-4)
    # batched, as the reference allows
    xb = reg.solve_spd_small(_t(np.stack([A, 2 * A])), _t(np.stack([b, b])))
    np.testing.assert_allclose(xb[1].numpy(), x / 2, rtol=1e-4, atol=1e-6)


def test_masked_wls_matches(heston_paths):
    S, v = heston_paths
    S_t, v_t = S[8], v[8]
    imm = np.maximum(100.0 - S_t, 0.0).astype(np.float32)
    itm = (imm > 0).astype(np.float32)
    y = np.maximum(100.0 - S[-1], 0.0).astype(np.float32) * np.float32(np.exp(-0.025))
    X = am.build_centered_basis(_t(S_t), 100.0, _t(itm), 5, v_t=_t(v_t), v_degree=3)
    theta = reg.masked_wls_theta_centered(X, _t(y), _t(itm))
    theta_j = jreg.masked_wls_theta_centered(jnp.asarray(X.numpy()), jnp.asarray(y),
                                             jnp.asarray(itm))
    fit = reg.masked_wls_predict_centered(X, _t(y), _t(itm)).numpy()
    fit_j = np.asarray(jreg.masked_wls_predict_centered(
        jnp.asarray(X.numpy()), jnp.asarray(y), jnp.asarray(itm)))
    scale = float(np.abs(np.asarray(theta_j)).max())
    np.testing.assert_allclose(theta.numpy(), np.asarray(theta_j), rtol=1e-5,
                               atol=1e-5 * scale)
    Xd, w = X.numpy().astype(np.float64), itm.astype(np.float64)
    G = (Xd * w[:, None]).T @ Xd
    G += 1e-7 * (np.trace(G) / G.shape[0] + 1.0) * np.eye(G.shape[0])
    fit64 = Xd @ np.linalg.solve(G, (Xd * w[:, None]).T @ y.astype(np.float64))
    m = itm > 0
    np.testing.assert_allclose(fit[m], fit_j[m], rtol=0, atol=1e-3)
    np.testing.assert_allclose(fit[m], fit64[m], rtol=0, atol=1e-3)


@pytest.mark.parametrize("poly_degree, v_degree", [(3, 2), (5, 3)])
@pytest.mark.parametrize("out_of_sample", [False, True])
def test_lsm_poly_backward_matches_on_jax_paths(heston_paths, poly_degree, v_degree,
                                                out_of_sample):
    S, v = heston_paths
    js, spec = _specs(None)
    kw = dict(poly_degree=poly_degree, v_degree=v_degree, out_of_sample=out_of_sample,
              pair_block=PB, stat_pair_block=PB)
    p_j, se_j = jam.lsm_poly_backward(jnp.asarray(S), js, T, v_paths=jnp.asarray(v), **kw)
    p, se = am.lsm_poly_backward(_t(S), spec, T, v_paths=_t(v), **kw)
    assert abs(float(p) / float(p_j) - 1.0) < (2e-3 if out_of_sample else 1e-3)
    assert abs(float(se) / float(se_j) - 1.0) < 1e-2


@pytest.mark.parametrize("model", ["heston", "gbm"])
def test_richardson_cv_stat_matches_on_jax_paths(heston_paths, gbm_paths, model):
    """Fine/coarse common-path extrapolation plus the control variate: COS
    leg under Heston (f32 COS, ~2e-3 absolute noise floor), BS under GBM."""
    if model == "heston":
        (S, v), (js, spec) = heston_paths, _specs(None)
    else:
        (S, v), (js, spec) = (gbm_paths, None), _specs(0.2)
    jl = JLSMConfig(poly_degree=5, variance_basis_degree=3, richardson=True)
    stat_j, mask_j = jam.richardson_cv_stat(
        jnp.asarray(S), None if v is None else jnp.asarray(v), js, T, jl,
        heston=J_HESTON, model=model, pair_block=PB)
    stat, mask = am.richardson_cv_stat(_t(S), None if v is None else _t(v), spec, T,
                                       LSMConfig.from_reference(vars(jl)), heston=HESTON,
                                       model=model, pair_block=PB)
    p_j, se_j, _ = j_masked_mean_stderr(stat_j, mask_j, None, PB)
    p, se, _ = masked_mean_stderr(stat, mask, PB)
    assert abs(float(p) / float(p_j) - 1.0) < 3e-3
    assert abs(float(se) / float(se_j) - 1.0) < 1e-2


def test_lsm_refuses_tf32():
    S = torch.full((3, 8192), 100.0)
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="allow_tf32"):
            am.lsm_poly_backward(S, _specs(0.2)[1], T)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
