"""Rough Bergomi in the port (models/rbergomi.py, the rough Bergomi stream of
ops/philox.py, the plain versions of kernels 25-26 in ops/cuda_rbergomi.py,
the rBergomi branches of the American and European pricers) held against
the JAX package and the model's exact identities on the CPU.

Tolerances, each with its reason:
- _hybrid_weights, _yy_cov, _yw_cov and rbergomi_exact_chol: bit for bit
  (the same float64 NumPy code, the same numpy default_rng).
- rbergomi_from_draws and the terminal control-variate leg on the JAX
  package's own draws (block_normals under the keys simulate_rbergomi and
  terminal_cv_core fold) against simulate_rbergomi and terminal_cv_core:
  rtol 1e-5 on S, v, S_T, G_T and the dual state (the two libraries order
  the float32 Volterra sums and the log-price sums differently; XLA on the
  CPU contracts multiply-adds).
- rbergomi_european_estimate on those draws against rbergomi_european_mc:
  price rtol 1e-5, stderr rtol 1e-4 (float32 pair-mean sums in two orders).
- The (S, v) LSM on the JAX package's paths against its backward: 1e-3 on
  the price, 1e-2 on the stderr (as tests/test_torch_sabr.py: a float32
  least-squares solve in two libraries).
- The control-variate fallback (the BS leg at spec.sigma) on the same
  paths: rtol 1e-6.
- The model's identities on the port's own stream, at the JAX tests' bars
  and sizes (tests/test_rbergomi.py): E[v_t] = xi0 within 5 stderr at
  every checked date, the spot martingale within 4 stderr.
- The plain versions of kernels 25 and 26 (on G summed in ascending order),
  first_tile chunks and the simulator's routes: bit for bit (the same
  float32 operations).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from options_model_tpu.core.config import PUT
from options_model_tpu.core.config import MCConfig as JMCConfig
from options_model_tpu.core.config import OptionSpec as JOptionSpec
from options_model_tpu.core.config import RBergomiParams as JRBergomiParams
from options_model_tpu.models import rbergomi as jrb
from options_model_tpu.models.blocks import block_normals
from options_model_tpu.pricers import american as jam
from options_model_tpu_torch.core.config import (LSMConfig, MCConfig, OptionSpec,
                                                  RBergomiParams)
from options_model_tpu_torch.models import rbergomi as rb
from options_model_tpu_torch.ops import cuda_rbergomi as cr
from options_model_tpu_torch.ops.cuda_heston import PATH_TILE
from options_model_tpu_torch.ops.philox import rbergomi_path_draws, seed_from_generator
from options_model_tpu_torch.pricers import american as am
from options_model_tpu_torch.pricers.european import make_terminal_sampler, price_european_mc
from _torch_threads import one_torch_thread_module  # noqa: F401

FIELDS = dict(H=0.1, eta=1.5, rho=-0.7, xi0=0.04)      # tests/test_rbergomi.py:30
J_P = JRBergomiParams(**FIELDS)
P = RBergomiParams.from_reference(vars(J_P))
SEED = 0x243F6A8885A308D3

pytestmark = pytest.mark.usefixtures("one_torch_thread_module")


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _jax_draws(key, cfg, first_block=0):
    """(z1, z2, zp), each (n_steps, n_paths): block_normals under the keys
    simulate_rbergomi folds (models/rbergomi.py:182-185, :219-220), in path
    order."""
    half = cfg.path_block // 2
    out = [[], [], []]
    for b in range(cfg.n_paths // cfg.path_block):
        bk = jax.random.fold_in(key, first_block + b)
        z = jax.vmap(lambda t: block_normals(bk, t, half, 3, cfg.antithetic,
                                             jnp.float32))(jnp.arange(cfg.n_steps))
        for o, zi in zip(out, z):
            o.append(zi)
    return tuple(torch.from_numpy(np.array(jnp.concatenate(o, axis=1))) for o in out)


# ---- the hybrid scheme's ingredients ---------------------------------------------

@pytest.mark.parametrize("n_steps, H", [(50, 0.1), (20, 0.3), (16, 0.5), (64, 0.05)])
def test_hybrid_weights_bit_for_bit(n_steps, H):
    dt = 1.0 / n_steps
    W, c1, c2, var = rb._hybrid_weights(n_steps, H, dt)
    Wj, c1j, c2j, varj = jrb._hybrid_weights(n_steps, H, dt)
    assert np.array_equal(W, Wj) and c1 == c1j and c2 == c2j and np.array_equal(var, varj)


def test_h_half_kernel_is_brownian():
    """H = 1/2: c2 = 0, W_mat all ones below the diagonal, var[k] = t_k."""
    W, c1, c2, var = rb._hybrid_weights(16, 0.5, 1.0 / 16)
    np.testing.assert_allclose(var, np.arange(17) / 16.0, atol=1e-12)
    assert c1 == pytest.approx(1.0) and c2 == 0.0
    np.testing.assert_array_equal(W, np.tril(np.ones((16, 16)), -1))
    c = rb.rbergomi_constants(100.0, 1.0, RBergomiParams(0.5, 1.0, -0.5, 0.04), 16)
    assert c["c2"] == 0.0 and c["sqrt2H"] == np.float32(1.0)


def test_compensator_is_the_discrete_variance():
    """comp[k] = (0.5 eta^2) var[k] in float32 from the float64 var, cast
    once; never eta^2 t^(2H)/2: at 50 steps and H = 0.1 the scheme's
    variance sits up to 0.09% off t^(2H), a bias E[v] would carry."""
    c = rb.rbergomi_constants(100.0, 1.0, P, 50)
    _, _, _, var = rb._hybrid_weights(50, 0.1, 1.0 / 50)
    f = np.float32
    assert np.array_equal(c["comp"], (f(0.5) * (f(1.5) * f(1.5))) * var.astype(np.float32))
    t = np.arange(51) / 50
    assert np.abs(var[1:] / t[1:] ** 0.2 - 1).max() > 5e-4


def test_covariances_and_cholesky_oracle_bit_for_bit():
    for ti, tj in ((0.7, 0.7), (0.3, 0.7), (0.3, 0.5), (0.0, 0.4)):
        assert rb._yy_cov(ti, tj, 0.1) == jrb._yy_cov(ti, tj, 0.1)
        assert rb._yw_cov(ti, tj, 0.1) == jrb._yw_cov(ti, tj, 0.1)
    for anti in (True, False):
        a = rb.rbergomi_exact_chol(7, 100.0, 100.0, 0.05, 1.0, P, n_steps=12, n_paths=2048,
                                   cp=-1.0, antithetic=anti)
        b = jrb.rbergomi_exact_chol(7, 100.0, 100.0, 0.05, 1.0, J_P, n_steps=12, n_paths=2048,
                                    cp=-1.0, antithetic=anti)
        assert a[0] == b[0] and a[1] == b[1] and np.array_equal(a[2], b[2])


def test_params_carry_over_and_validate():
    with pytest.raises(ValueError, match="H="):
        RBergomiParams(H=0.7, eta=1.0, rho=-0.5, xi0=0.04).validate()
    with pytest.raises(ValueError, match="rho="):
        RBergomiParams(H=0.1, eta=1.0, rho=-1.5, xi0=0.04).validate()
    with pytest.raises(ValueError, match="xi0="):
        RBergomiParams(H=0.1, eta=1.0, rho=-0.5, xi0=0.0).validate()
    with pytest.raises(ValueError, match="eta="):
        RBergomiParams(H=0.1, eta=-1.0, rho=-0.5, xi0=0.04).validate()
    p = RBergomiParams(H=0.5, eta=1.0, rho=-0.5, xi0=0.04).validate()
    assert RBergomiParams.from_array(p.to_array()) == p
    assert P == RBergomiParams(**FIELDS) and str(P) == str(J_P)


# ---- the scheme on the JAX package's draws ---------------------------------------

CFG = JMCConfig(n_paths=2048, n_steps=20, path_block=1024)


@pytest.mark.parametrize("outputs", ["paths", "variance", "dual_state", "terminal",
                                     "terminal_variance"])
def test_from_draws_matches_simulate_rbergomi_on_its_draws(outputs):
    key = jax.random.key(5)
    paths = outputs in ("paths", "variance", "dual_state")
    want_v = outputs in ("variance", "dual_state", "terminal_variance")
    dual = outputs == "dual_state"
    out_j = jrb.simulate_rbergomi(key, 100.0, 0.5, J_P, CFG, rate=0.03, return_paths=paths,
                                  return_variance=want_v, return_dual_state=dual)
    z1, z2, zp = _jax_draws(key, CFG)
    out = rb.rbergomi_from_draws(z1, z2, zp, 100.0, 0.5, P, 0.03, return_paths=paths,
                                 return_variance=want_v, return_dual_state=dual)
    out_j = out_j if isinstance(out_j, tuple) else (out_j,)
    out = out if isinstance(out, tuple) else (out,)
    assert len(out) == len(out_j)
    for a, b in zip(out, out_j):
        b = np.asarray(b)
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=1e-7)


def test_terminal_cv_core_matches_on_its_draws():
    key = jax.random.key(6)
    cfg = JMCConfig(n_paths=2048, n_steps=16, path_block=1024)
    S_j, G_j = jrb.rbergomi_terminal_cv(key, 100.0, 0.05, 1.0, J_P, cfg)
    z1, z2, zp = _jax_draws(key, cfg)
    S_T, G_T = rb.rbergomi_from_draws(z1, z2, zp, 100.0, 1.0, P, 0.05, return_cv=True)
    np.testing.assert_allclose(S_T.numpy(), np.asarray(S_j), rtol=1e-5)
    np.testing.assert_allclose(G_T.numpy(), np.asarray(G_j), rtol=1e-5)


@pytest.mark.parametrize("cp, K", [(-1.0, 100.0), (1.0, 110.0)])
def test_european_estimate_matches_rbergomi_european_mc_on_its_draws(cp, K):
    key = jax.random.key(8)
    cfg = JMCConfig(n_paths=4096, n_steps=16, path_block=1024)
    z1, z2, zp = _jax_draws(key, cfg)
    S_T, G_T = rb.rbergomi_from_draws(z1, z2, zp, 100.0, 1.0, P, 0.05, return_cv=True)
    for cv in (True, False):
        p_j, se_j = jrb.rbergomi_european_mc(key, 100.0, K, 0.05, 1.0, J_P, cfg, cp=cp,
                                             control_variate=cv)
        p, se = rb.rbergomi_european_estimate(S_T, G_T if cv else None, 100.0, K, 0.05, 1.0,
                                              P.xi0, cp, pair_block=1024)
        np.testing.assert_allclose(float(p), float(p_j), rtol=1e-5)
        np.testing.assert_allclose(float(se), float(se_j), rtol=1e-4)


def test_variance_lsm_on_jax_paths():
    """The (S, v) LSM and the control-variate fallback on the JAX package's
    rBergomi paths against its backward and its _cv_adjustment."""
    cfg = JMCConfig(n_paths=1 << 13, n_steps=16, path_block=4096)
    S_j, v_j = jam.simulate_paths(jax.random.key(9), 100.0, 0.5, cfg, "rbergomi", rate=0.05,
                                  rbergomi=J_P, return_variance=True)
    S, v = torch.from_numpy(np.array(S_j)), torch.from_numpy(np.array(v_j))
    js = JOptionSpec(strike=100.0, rate=0.05, cp=PUT)
    spec = OptionSpec.from_reference(vars(js))
    kw = dict(poly_degree=3, pair_block=4096, stat_pair_block=4096)
    p_j, se_j = jam.lsm_poly_backward(S_j, js, 0.5, v_paths=v_j, **kw)
    p, se = am.lsm_poly_backward(S, spec, 0.5, v_paths=v, **kw)
    assert abs(float(p) / float(p_j) - 1.0) < 1e-3
    assert abs(float(se) / float(se_j) - 1.0) < 1e-2
    js_s = JOptionSpec(strike=100.0, rate=0.05, cp=PUT, sigma=0.2)
    adj_j = jam._cv_adjustment(S_j, js_s, 0.5, model="rbergomi")
    adj = am._cv_adjustment(S, OptionSpec.from_reference(vars(js_s)), 0.5, model="rbergomi")
    np.testing.assert_allclose(adj.numpy(), np.asarray(adj_j), rtol=1e-6, atol=1e-5)


# ---- the port's stream, the plain kernels and the routes --------------------------

def test_plain_kernels_are_the_scheme_on_the_stream():
    """Kernel 25's plain version is sqrt(dt) z1 of the stream, kernel 26's the
    walk on the stream's (z2, zp): simulate_rbergomi on the CPU (the fused
    kernel's plain version) equals rbergomi_from_draws on rbergomi_path_draws
    bit for bit, in every mode, and kernel 26's plain version on G summed in
    ascending order (volterra_ordered) equals both."""
    cfg = MCConfig(n_paths=2 * PATH_TILE, n_steps=12)
    z1, z2, zp = rbergomi_path_draws(SEED, 0, 2, PATH_TILE, 12, True)
    c = rb.rbergomi_constants(100.0, 0.5, P, 12, 0.03)
    dW = cr.rbergomi_dw(SEED, 0, 2, 12, c["sqrt_dt"], device="cpu")
    assert torch.equal(dW, float(c["sqrt_dt"]) * z1)
    assert torch.equal(dW[:, PATH_TILE // 2:PATH_TILE], -dW[:, :PATH_TILE // 2])
    got = rb.simulate_rbergomi(SEED, 100.0, 0.5, P, cfg, 0.03, return_paths=True,
                               return_variance=True, return_dual_state=True, device="cpu")
    want = rb.rbergomi_from_draws(z1, z2, zp, 100.0, 0.5, P, 0.03, return_paths=True,
                                  return_dual_state=True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    S_T, v_T = rb.simulate_rbergomi(SEED, 100.0, 0.5, P, cfg, 0.03, return_variance=True,
                                    device="cpu")
    assert torch.equal(S_T, got[0][-1]) and torch.equal(v_T, got[1][-1])
    cv = rb.terminal_cv_core(SEED, 100.0, 0.03, 0.5, P, 12, 2 * PATH_TILE, device="cpu")
    want = rb.rbergomi_from_draws(z1, z2, zp, 100.0, 0.5, P, 0.03, return_cv=True)
    assert all(torch.equal(a, b) for a, b in zip(cv, want))
    G = rb.volterra_ordered(torch.from_numpy(c["W_mat"]), dW)
    ref = cr.rbergomi_paths_reference(dW, G, c, SEED, 0, True, "cv")
    assert all(torch.equal(a, b) for a, b in zip(ref, cv))


@pytest.mark.parametrize("mode", ["paths", "terminal", "cv"])
def test_first_tile_chunk_reproduces_its_tiles(mode):
    full = cr.rbergomi_simulate(SEED, 100.0, 0.5, P, 4 * PATH_TILE, 8, 0.05, mode, True, 0,
                                "cpu", return_variance=True)
    part = cr.rbergomi_simulate(SEED, 100.0, 0.5, P, 2 * PATH_TILE, 8, 0.05, mode, True, 2,
                                "cpu", return_variance=True)
    for a, b in zip(full, part):
        assert torch.equal(a[..., 2 * PATH_TILE:], b)


def test_variance_normalization_on_the_stream():
    """E[v_t] = xi0 at every checked grid date (z < 5), v_0 = xi0 exactly:
    the discrete compensator (tests/test_rbergomi.py:88-100's sizes)."""
    cfg = MCConfig(n_paths=1 << 15, n_steps=25)
    _, v = rb.simulate_rbergomi(SEED, 100.0, 1.0, P, cfg, 0.05, return_paths=True,
                                return_variance=True, device="cpu")
    v = v.double().numpy()
    for m in (1, 2, 13, 25):
        pm = 0.5 * (v[m].reshape(-1, 2, PATH_TILE // 2)[:, 0]
                    + v[m].reshape(-1, 2, PATH_TILE // 2)[:, 1]).ravel()
        z = (pm.mean() - P.xi0) / (pm.std() / np.sqrt(pm.size))
        assert abs(z) < 5.0, (m, pm.mean(), z)
    assert v[0].std() == 0.0 and v[0, 0] == pytest.approx(P.xi0, rel=1e-6)


def test_spot_martingale_on_the_stream():
    cfg = MCConfig(n_paths=1 << 16, n_steps=50)
    S_T = rb.simulate_rbergomi(SEED + 1, 100.0, 1.0, P, cfg, 0.05, device="cpu")
    m = S_T.double().numpy() * np.exp(-0.05)
    pm = m.reshape(-1, 2, PATH_TILE // 2).mean(axis=1).ravel()
    z = (pm.mean() - 100.0) / (pm.std() / np.sqrt(pm.size))
    assert abs(z) < 4.0, (pm.mean(), z)


def test_american_and_european_routes():
    """The (S, v) American put through price_american (plain, Richardson,
    the European sampler), above the European within 4 combined stderr
    (tests/test_apps.py:637-650's check)."""
    mc = MCConfig(n_paths=1 << 14, n_steps=10)
    spec = OptionSpec(strike=100.0, rate=0.05, cp=PUT)
    p, se = am.price_american(_gen(1), 100.0, 0.5, spec, mc, LSMConfig(), "rbergomi",
                              rbergomi=P, device="cpu")
    pe, see = rb.rbergomi_european_mc(_gen(2), 100.0, 100.0, 0.05, 0.5, P, mc, cp=PUT,
                                      device="cpu")
    assert float(p) >= float(pe) - 4 * (float(se) + float(see))
    pr, ser = am.price_american(_gen(1), 100.0, 0.5, spec, mc, LSMConfig(richardson=True),
                                "rbergomi", rbergomi=P, device="cpu")
    assert np.isfinite(float(pr)) and float(ser) > 0
    sampler = make_terminal_sampler("rbergomi", 100.0, 0.05, 0.5, rbergomi=P, device="cpu")
    assert sampler.pair_block == PATH_TILE
    pe2, se2, n = price_european_mc(_gen(3), sampler, spec, 0.5, mc)
    assert abs(float(pe2) - float(pe)) < 4 * (float(se2) + float(see)) and float(n) == 1 << 14
    p3, _ = am.price_american(_gen(3), 100.0, 0.5, spec, mc,
                              LSMConfig(european_approximation=True), "rbergomi", rbergomi=P,
                              device="cpu")
    assert float(p3) == float(pe2)
    S = am.simulate_paths(_gen(4), 100.0, 0.5, mc, "rbergomi", rate=0.05, rbergomi=P,
                          device="cpu")
    seed = seed_from_generator(_gen(4))
    assert torch.equal(S, rb.simulate_rbergomi(seed, 100.0, 0.5, P, mc, 0.05, return_paths=True,
                                               device="cpu"))
    with pytest.raises(ValueError, match="rbergomi params"):
        am.simulate_paths(_gen(4), 100.0, 0.5, mc, "rbergomi", device="cpu")


def test_wrappers_and_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py drives the kernels")
    cfg = MCConfig(n_paths=PATH_TILE, n_steps=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        rb.simulate_rbergomi(SEED, 100.0, 0.5, P, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        rb.rbergomi_european_mc(_gen(1), 100.0, 100.0, 0.05, 0.5, P, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        cr.rbergomi_dw(SEED, 0, 1, 4, 0.1, device="cuda")
    meta = torch.empty((4, PATH_TILE), device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        cr.rbergomi_paths(meta, meta, rb.rbergomi_constants(100.0, 0.5, P, 4), SEED, 0)
    with pytest.raises(ValueError, match="at most"):
        rb.simulate_rbergomi(SEED, 100.0, 0.5, P, MCConfig(PATH_TILE, cr.MAX_STEPS + 1),
                             device="cpu")
    with pytest.raises(ValueError, match="return_dual_state"):
        rb.simulate_rbergomi(SEED, 100.0, 0.5, P, cfg, return_dual_state=True, device="cpu")


def test_volterra_refuses_tf32():
    c = rb.rbergomi_constants(100.0, 0.5, P, 4)
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="tf32"):
            rb.volterra(torch.from_numpy(c["W_mat"]), torch.zeros(4, 8))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
