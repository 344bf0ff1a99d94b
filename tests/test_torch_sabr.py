"""SABR in the port (models/sabr.py, the SABR stream of ops/philox.py, the
plain versions of kernels 23-24 in ops/cuda_sabr.py, pricers/fd_sabr.py and
the SABR branches of the pricers) held against the JAX package on the CPU.

Tolerances, each with its reason:
- hagan_lognormal_iv and sabr_bs_price: 1e-12 relative in float64 (the same
  expression in two libraries; JAX under jax.enable_x64), 1e-6 in float32,
  the ATM series branch included; their gradients 1e-10 in float64.
- calibrate_sabr's fit against the JAX package's: 1e-6 relative (L-BFGS-B
  from the same starts on gradients that agree to rounding; the JAX
  package returns its fit through float32).
- sabr_fd_price: the same NumPy operations, bit for bit.
- sabr_from_draws on the JAX package's own normals (block_normals under its
  fold_in keys) against simulate_sabr and sabr_european_mc: rtol 1e-5
  (float32; the port writes F^beta as exp(beta log F), the reference
  pow), the absorbed paths (F = 0) the same set.
- The forward-to-spot step on the JAX package's forward paths against its
  spot paths: rtol 1e-6 (float32 linspace and exp).
- The LSM on the JAX package's (S, alpha) paths as tests/test_torch_lsm.py
  (1e-3 relative on the price, 1e-2 on the stderr).
- Prices in law: 4 stderr (+ 0.3% against Hagan, tests/test_sabr.py's bar).
- Chunks: bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from options_model_tpu.core.config import PUT
from options_model_tpu.core.config import MCConfig as JMCConfig
from options_model_tpu.core.config import OptionSpec as JOptionSpec
from options_model_tpu.core.config import SABRParams as JSABRParams
from options_model_tpu.models import sabr as jsabr
from options_model_tpu.models.blocks import block_normals
from options_model_tpu.pricers import american as jam
from options_model_tpu.pricers import fd_sabr as jfd
from options_model_tpu_torch.core.config import LSMConfig, MCConfig, OptionSpec, SABRParams
from options_model_tpu_torch.models import sabr
from options_model_tpu_torch.ops import cuda_sabr
from options_model_tpu_torch.ops.cuda_heston import PATH_TILE, TERMINAL_TILE
from options_model_tpu_torch.ops.philox import seed_from_generator
from options_model_tpu_torch.pricers import american as am
from options_model_tpu_torch.pricers.dual import price_american_bracket
from options_model_tpu_torch.pricers.european import make_terminal_sampler, price_european_mc
from options_model_tpu_torch.pricers.fd_sabr import sabr_fd_price
from _torch_threads import one_torch_thread_module  # noqa: F401

F0, T, R = 100.0, 0.5, 0.03                             # tests/test_sabr.py:16-17
FIELDS = dict(alpha=0.2, beta=1.0, rho=-0.4, nu=0.6)
J_P = JSABRParams(**FIELDS)
P = SABRParams.from_reference(vars(J_P))
ABSORB = dict(alpha=8.0, beta=0.5, rho=0.0, nu=0.2)     # tests/test_sabr.py:78-90
SEED = 0x243F6A8885A308D3

pytestmark = pytest.mark.usefixtures("one_torch_thread_module")


def _gen(seed):
    return torch.Generator().manual_seed(seed)


# ---- the closed forms -------------------------------------------------------------

KS = np.array([70.0, 90.0, 99.999, 99.99999, 100.0, 100.0001, 110.0, 140.0])


@pytest.mark.parametrize("fields", [FIELDS, dict(alpha=0.3, beta=0.7, rho=-0.3, nu=0.5),
                                    dict(alpha=2.0, beta=0.5, rho=0.2, nu=0.4)])
def test_hagan_and_black_price_match_the_reference(fields):
    jp, p = JSABRParams(**fields), SABRParams(**fields)
    with jax.enable_x64(True):
        iv_j = np.asarray(jsabr.hagan_lognormal_iv(F0, jnp.asarray(KS, jnp.float64), T, jp,
                                                   dtype=jnp.float64))
        px_j = np.asarray(jsabr.sabr_bs_price(F0, jnp.asarray(KS, jnp.float64), T, R, jp,
                                              -1.0))
    iv = sabr.hagan_lognormal_iv(F0, torch.tensor(KS), T, p, dtype=torch.float64, device="cpu")
    px = sabr.sabr_bs_price(F0, torch.tensor(KS), T, R, p, -1.0, dtype=torch.float64,
                            device="cpu")
    assert iv.dtype == torch.float64
    np.testing.assert_allclose(iv.numpy(), iv_j, rtol=1e-12)
    np.testing.assert_allclose(px.numpy(), px_j, rtol=1e-12)
    iv32 = sabr.hagan_lognormal_iv(F0, torch.tensor(KS, dtype=torch.float32), T, p)
    iv32_j = np.asarray(jsabr.hagan_lognormal_iv(F0, jnp.asarray(KS, jnp.float32), T, jp,
                                                 dtype=jnp.float32))
    assert iv32.dtype == torch.float32
    np.testing.assert_allclose(iv32.numpy(), iv32_j, rtol=1e-6)
    # the z/x(z) splice is continuous through K = F
    assert float(iv32[2:6].max() - iv32[2:6].min()) < 1e-5


@pytest.mark.parametrize("K", [85.0, 100.0, 120.0])
def test_hagan_gradients_match_jax_grad(K):
    names = ("alpha", "rho", "nu") if K != 100.0 else ("alpha",)

    def j_iv(x):
        return jsabr.hagan_lognormal_iv(F0, K, T, JSABRParams(alpha=x[0], beta=1.0, rho=x[1],
                                                              nu=x[2]), dtype=jnp.float64)

    with jax.enable_x64(True):
        g_j = np.asarray(jax.grad(j_iv)(jnp.asarray([0.2, -0.4, 0.6], jnp.float64)))
    x = torch.tensor([0.2, -0.4, 0.6], dtype=torch.float64, requires_grad=True)
    iv = sabr.hagan_lognormal_iv(F0, K, T, SABRParams(alpha=x[0], beta=1.0, rho=x[1], nu=x[2]),
                                 dtype=torch.float64, device="cpu")
    iv.backward()
    for i, name in enumerate(("alpha", "rho", "nu")):
        if name in names:
            np.testing.assert_allclose(float(x.grad[i]), g_j[i], rtol=1e-10, err_msg=name)
    assert float(x.grad[0]) > 0                     # vega in alpha


@pytest.mark.parametrize("beta, truth", [
    (1.0, dict(alpha=0.22, beta=1.0, rho=-0.5, nu=0.8)),      # tests/test_sabr.py:134-143
    (0.7, dict(alpha=0.3, beta=0.7, rho=-0.3, nu=0.5))])      # tests/test_sabr.py:145-151
def test_calibrate_sabr_matches_the_reference(beta, truth):
    Ks = np.linspace(70.0, 130.0, 13) if beta == 1.0 else np.linspace(80.0, 120.0, 9)
    ivs = np.asarray(jsabr.hagan_lognormal_iv(F0, jnp.asarray(Ks), T, JSABRParams(**truth),
                                              dtype=jnp.float32))
    fit_j, info_j = jsabr.calibrate_sabr(F0, T, Ks, ivs, beta=beta)
    fit, info = sabr.calibrate_sabr(F0, T, Ks, ivs, beta=beta, device="cpu")
    assert fit.beta == beta and info["rmse"] < (1e-4 if beta == 1.0 else 5e-4)
    for name in ("alpha", "rho", "nu"):
        np.testing.assert_allclose(getattr(fit, name), getattr(fit_j, name), rtol=1e-6,
                                   err_msg=name)
    assert fit.alpha == pytest.approx(truth["alpha"], rel=2e-3)


def test_params_carry_over_and_validate():
    assert P == SABRParams(**FIELDS) and str(P) == str(J_P)
    np.testing.assert_allclose(P.to_array(), np.asarray(J_P.to_array()), rtol=1e-7)  # f32 there
    assert SABRParams.from_array(P.to_array()) == P
    for bad in (dict(FIELDS, alpha=-0.1), dict(FIELDS, beta=1.5), dict(FIELDS, rho=-1.0),
                dict(FIELDS, nu=-0.1)):
        with pytest.raises(ValueError):
            SABRParams(**bad).validate()


# ---- the ADI oracle ---------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(), dict(american=False), dict(exercise_dates=10),
                                dict(cp=1.0, alpha_drift=-0.05)])
def test_fd_oracle_is_the_reference_bit_for_bit(kw):
    grid = dict(n_f=60, n_a=24, n_t=60)
    got = sabr_fd_price(100.0, 105.0, T, R, P, **grid, **kw)
    want = jfd.sabr_fd_price(100.0, 105.0, T, R, J_P, **grid, **kw)
    assert got == want
    with pytest.raises(ValueError, match="beta"):
        sabr_fd_price(100.0, 100.0, T, R, SABRParams(0.2, 0.7, 0.0, 0.3))


# ---- the plain recursion on the JAX package's draws --------------------------------

def _jax_normals(key, cfg):
    """(z1, z2), each (n_steps, n_paths): block_normals under the keys
    simulate_sabr folds (models/sabr.py:127), in path order."""
    half = cfg.path_block // 2
    z1, z2 = [], []
    for b in range(cfg.n_paths // cfg.path_block):
        bk = jax.random.fold_in(key, b)
        a, c = jax.vmap(lambda t: jnp.stack(block_normals(bk, t, half, 2, cfg.antithetic,
                                                          jnp.float32)), out_axes=1)(
            jnp.arange(cfg.n_steps))
        z1.append(a)
        z2.append(c)
    return (torch.from_numpy(np.array(jnp.concatenate(z1, axis=1))),
            torch.from_numpy(np.array(jnp.concatenate(z2, axis=1))))


@pytest.mark.parametrize("fields, F_0, T_", [(FIELDS, F0, T), (ABSORB, 5.0, 2.0)])
def test_sabr_from_draws_matches_simulate_sabr_on_its_draws(fields, F_0, T_):
    """beta = 1 and the absorbing beta = 0.5 regime at 8192 x 25, on the JAX
    package's normals. Under beta < 1 a step F + alpha F^beta sqrt(dt) w1
    that lands near 0 cancels, and the next step's F^(beta - 1) amplifies
    that rounding: any two float32 runs of the recursion drift apart there
    (the JAX package's own run reaches 7.8% from the float64 recursion on
    the same draws). So beta < 1 holds the absorbed set equal, every entry
    where both float32 runs lie within 1e-6 of the float64 recursion
    within rtol 1e-5 (all but ~1.3%), and the port's largest error against
    float64 at most twice the JAX package's."""
    cfg = JMCConfig(n_paths=8192, n_steps=25, path_block=4096)
    key = jax.random.key(5)
    F_j, a_j = (np.asarray(x) for x in jsabr.simulate_sabr(key, F_0, T_, JSABRParams(**fields),
                                                           cfg, return_paths=True,
                                                           return_alpha=True))
    z1, z2 = _jax_normals(key, cfg)
    F, a = sabr.sabr_from_draws(z1, z2, F_0, T_, SABRParams(**fields), return_paths=True,
                                return_alpha=True)
    np.testing.assert_allclose(a.numpy(), a_j, rtol=1e-5)
    np.testing.assert_array_equal(F.numpy() == 0.0, F_j == 0.0)
    if fields["beta"] == 1.0:
        np.testing.assert_allclose(F.numpy(), F_j, rtol=1e-5)
    else:
        F64 = sabr.sabr_from_draws(z1.double(), z2.double(), F_0, T_, SABRParams(**fields),
                                   return_paths=True).numpy()
        e, e_j = np.abs(F.numpy() - F64), np.abs(F_j - F64)
        well = (e <= 1e-6 * np.abs(F64)) & (e_j <= 1e-6 * np.abs(F64))
        assert well.mean() > 0.98
        np.testing.assert_allclose(F.numpy()[well], F_j[well], rtol=1e-5)
        assert e.max() <= 2.0 * e_j.max()
        ever = (F == 0.0).any(dim=0)
        assert bool(ever.any())
        hit = (F == 0.0).int().argmax(dim=0)
        for j in torch.nonzero(ever).flatten()[:50].tolist():
            assert bool((F[hit[j]:, j] == 0.0).all())      # absorbed paths stay at 0
    F_T, a_T = sabr.sabr_from_draws(z1, z2, F_0, T_, SABRParams(**fields), return_alpha=True)
    assert torch.equal(F_T, F[-1]) and torch.equal(a_T, a[-1])


@pytest.mark.parametrize("cp, K", [(1.0, 90.0), (-1.0, 110.0)])
def test_european_estimate_matches_sabr_european_mc_on_its_draws(cp, K):
    cfg = JMCConfig(n_paths=8192, n_steps=16, path_block=4096)
    key = jax.random.key(6)
    S0 = F0 * np.exp(-R * T)
    for cv in (True, False):
        p_j, se_j = jsabr.sabr_european_mc(key, S0, K, R, T, J_P, cfg, cp=cp,
                                           control_variate=cv)
        z1, z2 = _jax_normals(key, cfg)
        Fw = float(np.float32(S0) * np.exp(np.float32(R) * np.float32(T)))
        F_T, G_T = sabr.sabr_from_draws(z1, z2, Fw, T, P, return_cv=True)
        p, se = sabr.sabr_european_estimate(F_T, G_T if cv else None, Fw, K, R, T, P.alpha, cp,
                                            pair_block=4096)
        np.testing.assert_allclose(float(p), float(p_j), rtol=1e-5)
        np.testing.assert_allclose(float(se), float(se_j), rtol=1e-4)


def test_spot_conversion_and_alpha_basis_on_jax_paths():
    """The port's forward-to-spot step on the JAX package's forward paths
    against its spot paths (american.py:250-258), and the (S, alpha) LSM
    on them against the JAX package's backward."""
    cfg = JMCConfig(n_paths=1 << 14, n_steps=16, path_block=4096)
    key = jax.random.key(7)
    S_j, a_j = jam.simulate_paths(key, 100.0, T, cfg, "sabr", rate=R, sabr=J_P,
                                  return_variance=True)
    F0w = jnp.asarray(100.0, jnp.float32) * jnp.exp(jnp.asarray(R, jnp.float32)
                                                    * jnp.asarray(T, jnp.float32))
    F_j = jsabr.simulate_sabr(key, F0w, T, J_P, cfg, return_paths=True)
    S = am.sabr_spot_paths(torch.from_numpy(np.array(F_j)), R, T)
    np.testing.assert_allclose(S.numpy(), np.asarray(S_j), rtol=1e-6)
    js = JOptionSpec(strike=100.0, rate=R, cp=PUT)
    spec = OptionSpec.from_reference(vars(js))
    kw = dict(poly_degree=3, pair_block=4096, stat_pair_block=4096)
    p_j, se_j = jam.lsm_poly_backward(S_j, js, T, v_paths=a_j, **kw)
    p, se = am.lsm_poly_backward(torch.from_numpy(np.array(S_j)), spec, T,
                                 v_paths=torch.from_numpy(np.array(a_j)), **kw)
    assert abs(float(p) / float(p_j) - 1.0) < 1e-3
    assert abs(float(se) / float(se_j) - 1.0) < 1e-2


# ---- the pricers ------------------------------------------------------------------

def test_simulate_paths_returns_the_spot_and_alpha():
    mc = MCConfig(n_paths=PATH_TILE, n_steps=10)
    S, a = am.simulate_paths(_gen(3), 100.0, T, mc, "sabr", rate=R, sabr=P,
                             return_variance=True, device="cpu")
    assert S.shape == a.shape == (11, PATH_TILE)
    np.testing.assert_allclose(S[0].numpy(), 100.0, rtol=1e-5)
    assert torch.equal(a[0], torch.full_like(a[0], np.float32(0.2)))
    F = cuda_sabr.sabr_paths(seed_from_generator(_gen(3)),
                             float(np.float32(100.0) * np.exp(np.float32(R) * np.float32(T))),
                             T, P, PATH_TILE, 10, device="cpu")
    # at expiry the spot is the forward
    assert torch.equal(S[-1], F[-1])


def test_sabr_european_prices_in_law():
    """The CV price against Hagan (4 stderr + 0.3%), its stderr at or below
    the plain one, and the European sampler against sabr_european_mc without
    the CV (4 combined stderr), at 2^15 x 16."""
    mc = MCConfig(n_paths=1 << 15, n_steps=16)
    S0 = F0 * np.exp(-R * T)
    p, se = sabr.sabr_european_mc(_gen(1), S0, 100.0, R, T, P, mc, cp=1.0, device="cpu")
    p0, se0 = sabr.sabr_european_mc(_gen(1), S0, 100.0, R, T, P, mc, cp=1.0,
                                    control_variate=False, device="cpu")
    truth = float(sabr.sabr_bs_price(F0, 100.0, T, R, P, 1.0, device="cpu"))
    assert abs(float(p) - truth) < 4 * float(se) + 3e-3 * truth
    assert float(se) <= float(se0)
    spec = OptionSpec(strike=100.0, rate=R, cp=PUT)
    sampler = make_terminal_sampler("sabr", 100.0, R, T, sabr=P, device="cpu")
    ps, ses, _ = price_european_mc(_gen(2), sampler, spec, T, mc)
    pr, ser = sabr.sabr_european_mc(_gen(4), 100.0, 100.0, R, T, P, mc, cp=-1.0,
                                    control_variate=False, device="cpu")
    assert abs(float(ps) - float(pr)) < 4 * (float(ses) + float(ser))


def test_sampler_chunks_reproduce_their_tiles():
    sampler = make_terminal_sampler("sabr", 100.0, R, T, sabr=P, device="cpu")
    whole = sampler(SEED, 0, MCConfig(3 * TERMINAL_TILE, 8))
    parts = [sampler(SEED, 0, MCConfig(TERMINAL_TILE, 8)),
             sampler(SEED, 1, MCConfig(2 * TERMINAL_TILE, 8))]
    assert torch.equal(whole, torch.cat(parts))
    F = cuda_sabr.sabr_paths(SEED, 5.0, 2.0, SABRParams(**ABSORB), 2 * PATH_TILE, 6,
                             device="cpu")
    F1 = cuda_sabr.sabr_paths(SEED, 5.0, 2.0, SABRParams(**ABSORB), PATH_TILE, 6,
                              first_tile=1, device="cpu")
    assert torch.equal(F1, F[:, PATH_TILE:])


def test_american_put_routes():
    """Richardson on the (S, alpha) basis; the CV route falls back to the
    plain price, bit for bit (no closed-form leg, as in the reference);
    price_american_with_stats takes no SABR, as the reference's."""
    spec = OptionSpec(strike=100.0, rate=R, cp=PUT)
    mc = MCConfig(n_paths=1 << 13, n_steps=10)
    p, se = am.price_american(_gen(5), 100.0, T, spec, mc, LSMConfig(richardson=True), "sabr",
                              sabr=P, device="cpu")
    assert 4.0 < float(p) < 6.0 and float(se) > 0
    cv = am.price_american_with_control_variate(_gen(5), 100.0, T, spec, mc, LSMConfig(),
                                                "sabr", sabr=P, device="cpu")
    plain = am.price_american_lsm(_gen(5), 100.0, T, spec, mc, LSMConfig(), "sabr", sabr=P,
                                  device="cpu")
    assert torch.equal(cv[0], plain[0]) and torch.equal(cv[1], plain[1])
    with pytest.raises(ValueError, match="sabr params"):
        am.price_american_with_stats(_gen(5), 100.0, T, spec, mc, LSMConfig(), "sabr",
                                     device="cpu")


# ---- without a card ---------------------------------------------------------------

def test_kernel_launches_refuse_cpu_tensors():
    row = cuda_sabr.sabr_row(F0, T, P, 4)
    before = dict(cuda_sabr.launches)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_sabr.launch_sabr_paths(torch.empty(5, PATH_TILE), None, row, SEED, 0, True)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_sabr.launch_sabr_terminal(torch.empty(TERMINAL_TILE), None, None, row, SEED, 0, 4,
                                       True)
    assert cuda_sabr.launches == before


def test_entry_points_without_a_device_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    mc = MCConfig(n_paths=4096, n_steps=4)
    for call in (lambda: sabr.simulate_sabr(SEED, F0, T, P, mc),
                 lambda: sabr.sabr_european_mc(_gen(1), F0, 100.0, R, T, P, mc),
                 lambda: sabr.calibrate_sabr(F0, T, [90.0, 100.0, 110.0], [0.2, 0.2, 0.2]),
                 lambda: sabr.hagan_lognormal_iv(F0, 100.0, T, P)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_sabr_bracket_is_not_ported():
    with pytest.raises(NotImplementedError, match="pricers.dual.price_american_bracket"):
        price_american_bracket(_gen(1), 100.0, T, OptionSpec(100.0, R, PUT),
                               MCConfig(4096, 10, path_block=1024), model="sabr", sabr=P,
                               device="cpu")
