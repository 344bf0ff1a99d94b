"""The port's local-vol slice (surface/cheb.py, models/localvol.py, the plain
versions of csrc/localvol.cu) held against the JAX package.

- Tables: the Chebyshev fit of the analytic smile of
  tests/test_pallas_localvol.py within 1e-6 (f32 coefficients of a numpy
  fit of f32 smiles), the reference's table carried over bit for bit.
- Zero normals: the JAX Pallas kernels in interpret mode draw zero bits, so
  the port's recursion on zero normals must give their matrix, rtol 1e-6.
- The XLA simulator's own normals through the port's recursion: rtol 2e-5.
  The port follows the kernel (log K - log S, times 1/m_half), the XLA
  simulator evaluates log(K / exp(log S)) / m_half; the two differ in the
  last ulps.
- A constant-sigma table reproduces the GBM kernels' draws: rtol 2e-5
  (the two round the drift and diffusion differently).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from options_model_tpu.core.config import MCConfig as JMCConfig
from options_model_tpu.models.blocks import block_normals
from options_model_tpu.models.localvol import simulate_local_vol as j_simulate_local_vol
from options_model_tpu.ops.pallas_localvol import (localvol_paths_pallas,
                                                   localvol_terminal_pallas)
from options_model_tpu.surface import cheb as jcheb
from options_model_tpu_torch.core.config import (CALL, PUT, LSMConfig, MCConfig,
                                                  OptionSpec)
from options_model_tpu_torch.core.stats import masked_mean_stderr
from options_model_tpu_torch.models.localvol import (localvol_euler_from_normals,
                                                     simulate_local_vol)
from options_model_tpu_torch.ops import cuda_gbm, cuda_localvol
from options_model_tpu_torch.pricers.american import (_pair_block, price_american,
                                                      richardson_cv_stat, simulate_paths)
from options_model_tpu_torch.pricers.binomial import crr_american
from options_model_tpu_torch.pricers.blackscholes import bs_price
from options_model_tpu_torch.pricers.european import (make_terminal_sampler,
                                                      price_european_mc)
from options_model_tpu_torch.surface.cheb import (LocalVolTable, compile_localvol_table,
                                                  eval_table)

S0, R, T = 100.0, 0.05, 0.5
N_STEPS = 16


def _smile_jax(S, tau):
    m = jnp.log(jnp.asarray(S) / 100.0)
    iv = 0.2 + 0.1 * jnp.abs(m) + 0.05 * m**2 + 0.02 * jnp.sqrt(tau)
    return jnp.clip(iv, 0.05, 1.0)


def _smile_torch(S, tau):
    m = torch.log(S / 100.0)
    iv = 0.2 + 0.1 * torch.abs(m) + 0.05 * m * m + 0.02 * torch.sqrt(tau)
    return torch.clamp(iv, 0.05, 1.0)


def _const(S, tau):
    return torch.full_like(S, 0.2)


@pytest.fixture(scope="module")
def tables():
    """(JAX table, the port's copy of it) for (T, N_STEPS)."""
    jt = jcheb.compile_localvol_table(_smile_jax, 100.0, T, N_STEPS, S0)
    return jt, LocalVolTable.from_reference(vars(jt))


@pytest.mark.parametrize("S0_range", [None, (90.0, 110.0)])
def test_compile_table_matches_reference(S0_range):
    jt = jcheb.compile_localvol_table(_smile_jax, 100.0, T, N_STEPS, S0, S0_range=S0_range)
    t = compile_localvol_table(_smile_torch, 100.0, T, N_STEPS, S0, S0_range=S0_range)
    assert t.coeffs.dtype == torch.float32 and t.coeffs.shape == (N_STEPS, 8)
    assert t.degree == 7 and t.K == jt.K
    assert t.m_center == jt.m_center and t.m_half == jt.m_half
    np.testing.assert_allclose(t.coeffs.numpy(), np.asarray(jt.coeffs), rtol=0, atol=1e-6)


def test_table_from_reference_is_bit_equal(tables):
    jt, t = tables
    assert torch.equal(t.coeffs, torch.from_numpy(np.array(jt.coeffs)))
    assert (t.m_center, t.m_half, t.K) == (jt.m_center, jt.m_half, jt.K)


@pytest.mark.parametrize("step", [0, 10, 15])
def test_eval_table_matches_reference(tables, step):
    jt, t = tables
    S = np.linspace(60.0, 160.0, 256).astype(np.float32)
    got = eval_table(t, torch.from_numpy(S), step).numpy()
    np.testing.assert_allclose(got, np.asarray(jcheb.eval_table(jt, jnp.asarray(S), step)),
                               rtol=0, atol=1e-6)


def test_localvol_paths_zero_normals_match_interpret_kernel(tables):
    jt, t = tables
    S_j = localvol_paths_pallas(1, S0, R, T, jt, 4096, N_STEPS, interpret=True)
    S = localvol_euler_from_normals(torch.zeros((N_STEPS, 4096)), S0, R, T, t)
    np.testing.assert_allclose(S.numpy(), np.asarray(S_j), rtol=1e-6)
    assert float(S[0, 0]) == float(S_j[0, 0])


def test_localvol_terminal_zero_normals_match_interpret_kernel(tables):
    jt, t = tables
    ST_j = localvol_terminal_pallas(1, S0, R, T, jt, 16384, N_STEPS, interpret=True)
    ST = localvol_euler_from_normals(torch.zeros((N_STEPS, 16384)), S0, R, T, t,
                                     return_paths=False)
    np.testing.assert_allclose(ST.numpy(), np.asarray(ST_j), rtol=1e-6)


@pytest.mark.parametrize("return_paths", [True, False])
def test_localvol_recursion_matches_xla_simulator_on_its_normals(tables, return_paths):
    jt, t = tables
    cfg = JMCConfig(n_paths=8192, n_steps=N_STEPS, path_block=4096)
    key = jax.random.key(int(np.random.default_rng(6).integers(1 << 31)))
    half = cfg.path_block // 2
    z = np.zeros((N_STEPS, cfg.n_paths), np.float32)
    for b in range(cfg.n_paths // cfg.path_block):
        block_key = jax.random.fold_in(key, b)
        for s in range(N_STEPS):
            (zb,) = block_normals(block_key, s, half, 1, True, jnp.float32)
            z[s, b * cfg.path_block:(b + 1) * cfg.path_block] = np.asarray(zb)
    S_j = j_simulate_local_vol(key, S0, R, T, jcheb.table_sigma_fn(jt, T), cfg,
                               return_paths=return_paths)
    S = localvol_euler_from_normals(torch.from_numpy(z), S0, R, T, t,
                                    return_paths=return_paths)
    assert S.shape == tuple(S_j.shape)
    np.testing.assert_allclose(S.numpy(), np.asarray(S_j), rtol=2e-5)


@pytest.mark.parametrize("kind", ["paths", "terminal"])
def test_constant_sigma_table_reproduces_gbm(kind):
    table = compile_localvol_table(_const, 100.0, T, N_STEPS, S0)
    if kind == "paths":
        lv, gbm, n = (cuda_localvol.localvol_paths_reference,
                      cuda_gbm.gbm_paths_reference, 8192)
    else:
        lv, gbm, n = (cuda_localvol.localvol_terminal_reference,
                      cuda_gbm.gbm_terminal_reference, 16384)
    S_lv = lv(99, S0, R, T, table, n, N_STEPS, first_tile=3)
    S_g = gbm(99, S0, R, 0.2, T, n, N_STEPS, first_tile=3)
    np.testing.assert_allclose(S_lv.numpy(), S_g.numpy(), rtol=2e-5)


def test_table_too_short_raises(tables):
    _, t = tables
    with pytest.raises(ValueError, match="step slices"):
        cuda_localvol.localvol_paths(1, S0, R, T, t, 4096, N_STEPS + 1, device="cpu")
    with pytest.raises(ValueError, match="step slices"):
        cuda_localvol.localvol_terminal(1, S0, R, T, t, 16384, 50, device="cpu")
    # rows beyond n_steps are ignored
    short = localvol_euler_from_normals(torch.zeros((8, 4096)), S0, R, T, t)
    assert short.shape == (9, 4096)


def test_bare_sigma_fn_is_not_ported():
    """The bare sigma_fn route is ported now (the IV-surface slice): a bare
    smile simulates on the table route's stream (a smile quadratic in m,
    which a degree-7 table holds to f32 rounding: the two routes within
    2e-5, the last ulps of log(K / S) against log K - log S), and with
    neither a table nor sigma_fn local vol raises ValueError, as the
    reference does (options_model_tpu/pricers/european.py:190-191)."""
    cfg = MCConfig(n_paths=4096, n_steps=4)
    smooth = lambda S, tau: 0.2 + 0.05 * torch.log(S / 100.0) ** 2  # noqa: E731
    S = simulate_local_vol(1, S0, R, T, cfg, sigma_fn=smooth, device="cpu")
    table = compile_localvol_table(smooth, 100.0, T, 4, S0)
    np.testing.assert_allclose(S.numpy(), simulate_local_vol(1, S0, R, T, cfg, table=table,
                                                             device="cpu").numpy(), rtol=2e-5)
    with pytest.raises(ValueError, match="sigma_fn"):
        simulate_local_vol(1, S0, R, T, cfg, device="cpu")
    with pytest.raises(ValueError, match="sigma_fn"):
        make_terminal_sampler("localvol", S0, R, T, device="cpu")


def test_cpu_wrappers_are_the_plain_versions(tables):
    _, t = tables
    args = (21, S0, R, T, t, 5000, 8, True)
    S = cuda_localvol.localvol_paths(*args, device="cpu")
    assert S.shape == (9, 8192)
    assert torch.equal(S, cuda_localvol.localvol_paths_reference(*args, device="cpu"))
    ST = cuda_localvol.localvol_terminal(*args, device="cpu")
    assert ST.shape == (16384,) and bool(torch.isfinite(ST).all())
    cfg = MCConfig(n_paths=5000, n_steps=8)
    assert torch.equal(simulate_local_vol(21, S0, R, T, cfg, table=t, device="cpu"), S)
    assert sum(cuda_localvol.launches.values()) == 0
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, ValueError)):
            cuda_localvol.localvol_paths(*args, device="cuda")


def test_constant_sigma_european_call_matches_bs():
    table = compile_localvol_table(_const, 100.0, 1.0, N_STEPS, S0)
    sampler = make_terminal_sampler("localvol", S0, R, 1.0, localvol_table=table,
                                    device="cpu")
    spec = OptionSpec(strike=100.0, rate=R, cp=CALL)
    p, se, _ = price_european_mc(torch.Generator().manual_seed(3), sampler, spec, 1.0,
                                 MCConfig(n_paths=1 << 15, n_steps=N_STEPS))
    bs = float(bs_price(S0, 100.0, 1.0, R, 0.2, 1.0, dtype=torch.float64, device="cpu"))
    assert abs(float(p) - bs) <= 4.0 * float(se), (float(p), float(se), bs)


def test_localvol_american_put_matches_crr():
    """The grid pricer's per-task local-vol path: simulate_paths over the
    table, then richardson_cv_stat (no control-variate leg under local vol)."""
    table = compile_localvol_table(_const, 100.0, T, N_STEPS, S0)
    mc = MCConfig(n_paths=1 << 14, n_steps=N_STEPS)
    spec = OptionSpec(strike=100.0, rate=R, cp=PUT)
    lsm = LSMConfig(richardson=True)
    S = simulate_paths(torch.Generator().manual_seed(4), S0, T, mc, "localvol", rate=R,
                       localvol_table=table, device="cpu")
    pb = _pair_block(mc, "localvol")
    stat, mask = richardson_cv_stat(S, None, spec, T, lsm, model="localvol",
                                    pair_block=pb)
    p, se, _ = masked_mean_stderr(stat, mask, pb)
    crr = crr_american(S0, 100.0, T, R, 0.2, cp=-1.0, n_steps=1024)
    assert abs(float(p) - crr) <= 4.0 * float(se), (float(p), float(se), crr)
    # the per-option pricers take no table, as in the reference: a bare
    # sigma_fn prices on the same paths; with neither they raise ValueError
    p2, se2 = price_american(torch.Generator().manual_seed(4), S0, T, spec, mc, lsm,
                             "localvol", sigma_fn=_const, device="cpu")
    assert abs(float(p2) - crr) <= 4.0 * float(se2), (float(p2), float(se2), crr)
    with pytest.raises(ValueError, match="sigma_fn"):
        price_american(torch.Generator().manual_seed(4), S0, T, spec, mc, lsm,
                       "localvol", device="cpu")
