"""The port's pathwise Greeks held against the JAX package.

- VJPs on identical normals: the JAX XLA simulators' own normals, rebuilt
  from the keys they fold (as tests/test_torch_kernels.py does), drive
  gbm_euler_vjp_from_normals and heston_euler_vjp_from_normals, against
  jax.vjp of the simulator, at 2^13 paths x 16 steps, with positive
  numpy-seeded cotangents. GBM: rtol 1e-4. Heston: dS0 and dr (S alone)
  rtol 1e-6; every component within 5e-4 of the sum of its paths' absolute
  shares. A path that lands a few ulps above v = 0 (x ~ 1e-8) has a vp
  whose float32 rounding (XLA contracts the step's multiply-adds into
  FMAs, the port does not) is a large part of it, and 0.5/sqrt(vp)
  amplifies that: at xi = 0.3 one such path carries a quarter of dXi, and
  the two packages sit 1.1e-4 of that scale apart (the port 1.8e-4 from a
  float64 finite difference, JAX 2.7e-4); at xi = 1.0 2.7e-4. Heston also
  at xi = 1.0, where the Feller condition fails and 13% of the states sit
  at v = 0, which pins the clamp and the _safe_sqrt subgradient (JAX's
  custom_jvp, the port's rule).
- mc_greeks (European, American) and mc_greeks_heston on the same normals
  against the JAX functions' outputs (see the tolerances there).
- mc_greeks on the port's own Philox stream against the closed form, with
  the JAX test's tolerances (tests/test_mc_greeks.py) at its 2^16 x 25,
  and its signs.
- cos_greeks_heston in float64 within 1e-6 of jax.grad through the JAX COS
  price in its explicit-x64 mode (the closed-form test's bound: that mode's
  complex128 functions on the CPU are good to ~3e-7).
- cos_greeks_bates and cos_greeks_vg in float32 against the JAX functions
  (float32 too), with cos_greeks_heston's float32 bar: rel 2e-3 / abs 2e-3,
  the f32 COS series' noise floor.
- lsm_poly_backward with a tensor rate and T: the same price bits as with
  floats, and d/dr on identical paths as jax.grad.
- The VJP wrappers on the CPU are their plain versions; each plain version
  on the Philox stream agrees with a float64 central difference of the
  recursion on the same normals.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from options_model_tpu.calibration.charfn import heston_cos_price as j_heston_cos_price
from options_model_tpu.core.config import PUT, CALL
from options_model_tpu.core.config import BatesParams as JBatesParams
from options_model_tpu.core.config import HestonParams as JHestonParams
from options_model_tpu.core.config import VGParams as JVGParams
from options_model_tpu.core.config import MCConfig as JMCConfig
from options_model_tpu.core.config import OptionSpec as JOptionSpec
from options_model_tpu.models.blocks import block_normals
from options_model_tpu.models.gbm import simulate_gbm as j_simulate_gbm
from options_model_tpu.models.heston import simulate_heston as j_simulate_heston
from options_model_tpu.pricers import american as jam
from options_model_tpu.pricers import greeks as jgreeks
from options_model_tpu_torch.core.config import (BatesParams, HestonParams, LSMConfig,
                                                 MCConfig, OptionSpec, VGParams)
from options_model_tpu_torch.models.gbm import (gbm_chain, gbm_constants,
                                                gbm_euler_from_normals,
                                                gbm_euler_vjp_from_normals, simulate_gbm)
from options_model_tpu_torch.models.heston import (heston_constants, heston_euler_from_normals,
                                                   heston_euler_vjp_from_normals,
                                                   simulate_heston)
from options_model_tpu_torch.ops import cuda_gbm, cuda_heston
from options_model_tpu_torch.ops.autodiff import differentiable
from options_model_tpu_torch.ops.philox import (box_muller, path_normals, seed_from_generator,
                                                stream_words, uniform_from_bits)
from options_model_tpu_torch.pricers import american as am
from options_model_tpu_torch.pricers import greeks
from options_model_tpu_torch.pricers.blackscholes import bs_greeks_closed_form, bs_price
from options_model_tpu_torch.pricers.european import price_european_gbm_exact
from _torch_threads import one_torch_thread  # noqa: F401

S0, K, T, R, SIG = 100.0, 100.0, 0.5, 0.05, 0.2
FIELDS = dict(kappa=2.0, theta=0.04, xi=0.3, rho=-0.7, v0=0.04)
J_CFG = JMCConfig(n_paths=8192, n_steps=16, path_block=4096)


# One torch intra-op thread for a test of three LSM prices: several test
# workers share the machine, and each worker's default pool (a thread a core)
# oversubscribes the cores. The earlier form of
# test_american_put_greeks_signs_and_bump took 614 s in each of six concurrent
# processes at 8 threads, 3.2 s at one (x86-64, 8 cores). Not module-wide: the
# American Gamma of test_mc_greeks_match_jax_on_its_normals moves with the LSM
# matmuls' reduction order, which the thread count sets. The two Heston mc_greeks
# tests take it: their Greeks are bit for bit the same at 1 and 8 threads.
# The tests that need it take tests/_torch_threads.py's one_torch_thread.


def _jax_normals(key, cfg, n_draws):
    """The (n_steps, n_paths) normals simulate_heston / simulate_gbm draw:
    block b uses fold_in(key, b), step t and draw d fold in (t, d)."""
    half = cfg.path_block // 2
    out = np.zeros((n_draws, cfg.n_steps, cfg.n_paths), np.float32)
    for b in range(cfg.n_paths // cfg.path_block):
        block_key = jax.random.fold_in(key, b)
        for t in range(cfg.n_steps):
            zs = block_normals(block_key, t, half, n_draws, cfg.antithetic, jnp.float32)
            for d, z in enumerate(zs):
                out[d, t, b * cfg.path_block:(b + 1) * cfg.path_block] = np.asarray(z)
    return [torch.from_numpy(z) for z in out]


def _cotangent(seed, shape):
    return np.random.default_rng(seed).uniform(0.5, 1.5, shape).astype(np.float32) / shape[-1]


@pytest.mark.parametrize("return_paths", [True, False])
def test_gbm_vjp_matches_jax_vjp_on_its_normals(return_paths):
    key = jax.random.key(11)
    (z,) = _jax_normals(key, J_CFG, 1)
    shape = (J_CFG.n_steps + 1, J_CFG.n_paths) if return_paths else (J_CFG.n_paths,)
    g = _cotangent(1, shape)
    x = jnp.array([S0, R, SIG, T], jnp.float32)
    _, vjp = jax.vjp(lambda x: j_simulate_gbm(key, x[0], x[1], x[2], x[3], J_CFG,
                                              return_paths=return_paths), x)
    (want,) = vjp(jnp.asarray(g))
    got = gbm_euler_vjp_from_normals(z, torch.from_numpy(g), S0, R, SIG, T, return_paths)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4)


def _j_heston(x):
    return JHestonParams(kappa=x[3], theta=x[4], xi=x[5], rho=x[6], v0=x[7])


@pytest.mark.parametrize("xi", [0.3, 1.0])
def test_heston_vjp_matches_jax_vjp_on_its_normals(xi):
    key = jax.random.key(12)
    z1, z2 = _jax_normals(key, J_CFG, 2)
    fields = dict(FIELDS, xi=xi)
    x = jnp.array([S0, R, T, *fields.values()], jnp.float32)
    (S_j, v_j), vjp = jax.vjp(lambda x: j_simulate_heston(key, x[0], x[1], x[2], _j_heston(x),
                                                          J_CFG, return_variance=True), x)
    shape = S_j.shape
    gS, gv = _cotangent(2, shape), _cotangent(3, shape) * 100.0
    (want,) = vjp((jnp.asarray(gS), jnp.asarray(gv)))
    shares = heston_euler_vjp_from_normals(z1, z2, torch.from_numpy(gS), torch.from_numpy(gv),
                                           S0, R, T, HestonParams(**fields), per_path=True)
    got, scale = shares.sum(1).numpy(), shares.abs().sum(1).numpy()
    if xi == 1.0:
        assert float(np.mean(np.asarray(v_j) == 0.0)) > 0.01   # paths pinned at v = 0
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got[:2], np.asarray(want)[:2], rtol=1e-6)
    assert np.all(np.abs(got - np.asarray(want)) <= 5e-4 * scale), (got, np.asarray(want))


def _gbm_simulator(z):
    """simulate_gbm on the given normals: the plain recursion, differentiable
    through its plain VJP, as the kernel is through its VJP kernel."""
    def sim(S0_, r, sigma, T_, paths):
        return differentiable(
            lambda *p: gbm_euler_from_normals(z, *p, return_paths=paths),
            lambda grads, outs, *p: gbm_euler_vjp_from_normals(z, grads[0], *p,
                                                               return_paths=paths),
            S0_, r, sigma, T_)
    return sim


def _heston_simulator(z1, z2):
    """simulate_heston's Euler paths (with v) on the given normals, as
    _gbm_simulator."""
    def sim(S0_, r, T_, p):
        return differentiable(
            lambda *q: heston_euler_from_normals(z1, z2, *q[:3], HestonParams(*q[3:]),
                                                 return_variance=True),
            lambda grads, outs, *q: heston_euler_vjp_from_normals(
                z1, z2, grads[0], grads[1], *q[:3], HestonParams(*q[3:])),
            S0_, r, T_, p.kappa, p.theta, p.xi, p.rho, p.v0)
    return sim


@pytest.mark.parametrize("style", ["european", "american"])
def test_mc_greeks_match_jax_on_its_normals(style):
    """The whole vector on identical normals: price rtol 1e-5, first-order
    Greeks 1e-3, Gamma 5e-3 (measured: 6e-7, 3e-7, 2e-6). The American
    Gamma 3e-2 (measured 1.2e-2): it is a difference of two Deltas over
    2h = 1 at S0 +- 0.5, and the LSM regressions of the two packages, ulps
    apart, flip a marginal exercise decision in a bumped pass, which moves
    one path's pathwise Delta by O(1)/n."""
    key = jax.random.key(13)
    (z,) = _jax_normals(key, J_CFG, 1)
    cp = CALL if style == "european" else PUT
    want = jgreeks.mc_greeks(key, S0, T, JOptionSpec(strike=K, rate=R, cp=cp, sigma=SIG),
                             J_CFG, style=style)
    got = greeks.gbm_greeks(_gbm_simulator(z), S0, T,
                            OptionSpec(strike=K, rate=R, cp=cp, sigma=SIG), style, 3, "cpu")
    tol = dict(european=(1e-5, 1e-3, 5e-3), american=(1e-5, 1e-3, 3e-2))[style]
    for name, w in want.items():
        rtol = tol[0] if name == "Price" else tol[2] if name == "Gamma" else tol[1]
        assert float(got[name]) == pytest.approx(float(w), rel=rtol), name


@pytest.mark.usefixtures("one_torch_thread")
def test_mc_greeks_heston_match_jax_on_its_normals():
    """Tolerances as the American GBM case (measured: price 3e-7, the
    first-order Greeks at most 6e-7, Gamma 1.2e-2)."""
    key = jax.random.key(14)
    z1, z2 = _jax_normals(key, J_CFG, 2)
    hp = JHestonParams(**FIELDS)
    want = jgreeks.mc_greeks_heston(key, S0, T, JOptionSpec(strike=K, rate=R, cp=PUT),
                                    J_CFG, hp)
    got = greeks.heston_greeks(_heston_simulator(z1, z2), S0, T,
                               OptionSpec(strike=K, rate=R, cp=PUT), HestonParams(**FIELDS),
                               3, "cpu")
    for name, w in want.items():
        rtol = 1e-5 if name == "Price" else 3e-2 if name == "Gamma" else 1e-3
        assert float(got[name]) == pytest.approx(float(w), rel=rtol), name


MC = MCConfig(n_paths=2**16, n_steps=25, path_block=4096)


@pytest.fixture(scope="module")
def european_call():
    return greeks.mc_greeks(torch.Generator().manual_seed(42), S0, T,
                            OptionSpec(strike=K, rate=R, cp=CALL, sigma=SIG), MC,
                            style="european", device="cpu")


def test_european_greeks_match_closed_form(european_call):
    """tests/test_mc_greeks.py:17-35, on the port's Philox stream."""
    cf = bs_greeks_closed_form(S0, K, T, R, SIG, CALL, device="cpu")
    for name, tol in (("Delta", 0.01), ("Vega", 0.01), ("Rho", 0.01), ("Theta", 0.003),
                      ("Gamma", 0.005)):
        assert abs(float(european_call[name]) - float(cf[name])) < tol, name
    assert abs(float(european_call["Price"]) - float(bs_price(S0, K, T, R, SIG, device="cpu"))) \
        < 0.05


@pytest.mark.usefixtures("one_torch_thread")
def test_american_put_greeks_signs_and_bump():
    """tests/test_mc_greeks.py:39-56: the AD Delta within 0.02 of the
    common-random-number central difference (h = 0.5), and the signs. The
    bumped runs need only their prices: they take mc_greeks's own route
    (pricers/greeks._gbm_american_price on simulate_gbm at the generator's
    kernel seed and MC) without the autograd graph, and that route at S0
    gives mc_greeks's Price bit for bit."""
    spec = OptionSpec(strike=K, rate=R, cp=PUT, sigma=SIG)
    g = greeks.mc_greeks(torch.Generator().manual_seed(42), S0, T, spec, MC, device="cpu")
    seed = seed_from_generator(torch.Generator().manual_seed(42))

    def simulate(S0_, r, sigma, T_, paths):
        return simulate_gbm(seed, S0_, r, sigma, T_, MC, return_paths=paths, device="cpu")

    def price(s):
        x = torch.tensor([s, K, T, R, SIG], dtype=torch.float32)
        with torch.no_grad():
            return float(greeks._gbm_american_price(x, simulate, PUT, LSMConfig().poly_degree,
                                                    torch.tensor(0.0)))

    assert price(S0) == float(g["Price"])
    fd = (price(S0 + 0.5) - price(S0 - 0.5)) / 1.0
    assert abs(float(g["Delta"]) - fd) < 0.02, (float(g["Delta"]), fd)
    assert -1.0 < float(g["Delta"]) < 0.0
    assert float(g["Vega"]) > 0.0 and float(g["Gamma"]) > 0.0
    assert float(g["Theta"]) < 0.0 and float(g["Rho"]) < 0.0


def test_mc_greeks_requires_sigma_and_a_style():
    with pytest.raises(ValueError):
        greeks.mc_greeks(torch.Generator(), S0, T, OptionSpec(strike=K, rate=R, cp=PUT), MC,
                         device="cpu")
    with pytest.raises(ValueError):
        greeks.mc_greeks(torch.Generator(), S0, T,
                         OptionSpec(strike=K, rate=R, cp=PUT, sigma=SIG), MC, style="asian",
                         device="cpu")


@pytest.mark.usefixtures("one_torch_thread")
def test_mc_greeks_heston_signs():
    """tests/test_mc_greeks.py:101-114 (its xi = 0.5, 2^15 x 32 there; 2^14
    x 16 here)."""
    g = greeks.mc_greeks_heston(torch.Generator().manual_seed(3), S0, T,
                                OptionSpec(strike=K, rate=R, cp=PUT),
                                MCConfig(n_paths=2**14, n_steps=16),
                                HestonParams(**dict(FIELDS, xi=0.5)), device="cpu")
    assert -1.0 < float(g["Delta"]) < 0.0
    assert float(g["dV0"]) > 0.0 and float(g["dTheta"]) > 0.0 and float(g["Theta"]) < 0.0
    assert np.isfinite(float(g["dXi"])) and np.isfinite(float(g["dRhoCorr"]))


def test_cos_greeks_heston_matches_jax_float64():
    args = (S0, K, 1.0, R)
    got = greeks.cos_greeks_heston(*args, HestonParams(**FIELDS), -1.0, dtype=torch.float64,
                                   device="cpu")
    with jax.enable_x64(True):

        def f(*x):
            hp = JHestonParams(kappa=x[4], theta=x[5], xi=x[6], rho=x[7], v0=x[8])
            return j_heston_cos_price(x[0], x[1], x[2], x[3], hp, -1.0,
                                      dtype=jnp.float64).sum()

        x = [jnp.asarray(a, jnp.float64) for a in (*args, *FIELDS.values())]
        price, g = jax.value_and_grad(f, argnums=tuple(range(9)))(*x)
        gamma = jax.grad(jax.grad(lambda s: f(s, *x[1:])))(x[0])
        want = {"Price": price, "Delta": g[0], "Gamma": gamma, "Theta": -g[2] / 365.0,
                "Rho": g[3] / 100.0, "dKappa": g[4], "dTheta": g[5], "dXi": g[6],
                "dRhoCorr": g[7], "dV0": g[8], "Vega": g[8] * 2.0 * jnp.sqrt(x[8]) / 100.0}
        want = {k: float(v) for k, v in want.items()}
    assert set(got) == set(want)
    for name, w in want.items():
        assert float(got[name]) == pytest.approx(w, abs=1e-6), name


def test_cos_greeks_heston_float32_matches_jax():
    """The default float32 path against the reference's own cos_greeks_heston
    (float32 as well): within the COS series' f32 noise floor, 2e-3 on the
    price (test_torch_closed_forms) and the same relative size on the
    first-order Greeks."""
    got = greeks.cos_greeks_heston(S0, K, 1.0, R, HestonParams(**FIELDS), 1.0, device="cpu")
    want = jgreeks.cos_greeks_heston(S0, K, 1.0, R, JHestonParams(**FIELDS), 1.0)
    for name in ("Price", "Delta", "Theta", "Rho", "dV0", "Vega"):
        assert float(got[name]) == pytest.approx(float(want[name]), rel=2e-3, abs=2e-3), name


JUMPS = dict(lam=0.4, mu_j=-0.12, sigma_j=0.18)
VG_FIELDS = dict(sigma=0.18, theta=-0.14, nu=0.35)


@pytest.mark.parametrize("model", ["bates", "vg"])
def test_cos_greeks_jump_families_float32_match_jax(model):
    """cos_greeks_bates (an OTM-ish put, T = 0.5) and cos_greeks_vg (an ATM
    call) against the reference's, every key, with cos_greeks_heston's
    float32 bar."""
    if model == "bates":
        got = greeks.cos_greeks_bates(S0, K, 0.5, 0.04, BatesParams(HestonParams(**FIELDS),
                                                                    **JUMPS), -1.0,
                                      device="cpu")
        want = jgreeks.cos_greeks_bates(S0, K, 0.5, 0.04, JBatesParams(JHestonParams(**FIELDS),
                                                                       **JUMPS), -1.0)
    else:
        got = greeks.cos_greeks_vg(S0, K, 0.5, 0.05, VGParams(**VG_FIELDS), 1.0, device="cpu")
        want = jgreeks.cos_greeks_vg(S0, K, 0.5, 0.05, JVGParams(**VG_FIELDS), 1.0)
    assert set(got) == set(want)
    for name in want:
        assert float(got[name]) == pytest.approx(float(want[name]), rel=2e-3, abs=2e-3), name


@pytest.fixture(scope="module")
def gbm_paths():
    return np.asarray(jam.simulate_paths(jax.random.key(8), S0, T, J_CFG, "gbm", sigma=SIG,
                                         rate=R, engine="xla"))


def test_lsm_tensor_rate_keeps_the_price_bits(gbm_paths):
    S = torch.from_numpy(gbm_paths)
    p_f, se_f = am.lsm_poly_backward(S, OptionSpec(strike=K, rate=R, cp=PUT, sigma=SIG), T)
    rate, T_ = torch.tensor(R, dtype=torch.float32), torch.tensor(T, dtype=torch.float32)
    p_t, se_t = am.lsm_poly_backward(S, OptionSpec(strike=K, rate=rate, cp=PUT, sigma=SIG), T_)
    assert torch.equal(p_f, p_t) and torch.equal(se_f, se_t)


def test_lsm_rate_gradient_matches_jax(gbm_paths):
    """d price / d r through the discount alone (paths held fixed), which
    the float discount used to cut."""
    want = jax.grad(lambda r: jam.lsm_poly_backward(
        jnp.asarray(gbm_paths), JOptionSpec(strike=K, rate=r, cp=PUT, sigma=SIG), T)[0])(
        jnp.float32(R))
    r = torch.tensor(R, dtype=torch.float32, requires_grad=True)
    p, _ = am.lsm_poly_backward(torch.from_numpy(gbm_paths),
                                OptionSpec(strike=K, rate=r, cp=PUT, sigma=SIG), T)
    (got,) = torch.autograd.grad(p, r)
    assert float(got) < 0.0
    assert float(got) == pytest.approx(float(want), rel=1e-3)


def _gbm64(z, p, paths):
    """The log-Euler GBM in float64 on normals z: S0 exp(t drift + diffusion W_t)."""
    S0_, r, sigma, T_ = p
    n = z.shape[0]
    W = torch.cat([torch.zeros_like(z[:1], dtype=torch.float64), torch.cumsum(z.double(), 0)])
    t = torch.arange(n + 1, dtype=torch.float64)[:, None]
    log_s = np.log(S0_) + t * (r - 0.5 * sigma**2) * T_ / n + sigma * np.sqrt(T_ / n) * W
    return torch.exp(log_s if paths else log_s[-1])


def _heston64(z1, z2, p):
    """The full-truncation Euler recursion in float64 on normals z1, z2."""
    S0_, r, T_, kappa, theta, xi, rho, v0 = p
    n = z1.shape[0]
    dt = T_ / n
    ls = torch.full((z1.shape[1],), np.log(S0_), dtype=torch.float64)
    v = torch.full_like(ls, v0)
    S, V = [ls.exp()], [v]
    for z1_t, z2_t in zip(z1.double(), z2.double()):
        vp = v.clamp_min(0.0)
        sq = vp.sqrt() * np.sqrt(dt)
        v = (vp + kappa * (theta - vp) * dt
             + xi * sq * (rho * z1_t + np.sqrt(1 - rho * rho) * z2_t)).clamp_min(0.0)
        ls = ls + (r - 0.5 * vp) * dt + sq * z1_t
        S.append(ls.exp())
        V.append(v)
    return torch.stack(S), torch.stack(V)


def _central(fwd, g, params, idx, h_rel=1e-5):
    """Central difference of <g, fwd(params)> in parameter idx, float64."""
    h = h_rel * abs(params[idx])
    up, dn = list(params), list(params)
    up[idx] += h
    dn[idx] -= h

    def dot(p):
        out = fwd(p)
        outs = out if isinstance(out, tuple) else (out,)
        return sum(float((gi.double() * o).sum()) for gi, o in zip(g, outs))

    return (dot(up) - dot(dn)) / (2 * h)


def _f32(params):
    return [float(np.float32(p)) for p in params]


@pytest.mark.parametrize("kind", ["paths", "terminal"])
def test_gbm_plain_vjps_match_central_differences(kind):
    """Each GBM VJP's plain version on the Philox stream against a float64
    central difference of the recursion on the same normals: rtol 1e-5
    (the VJP reads the float32 paths, ~1e-7 apart)."""
    seed, n, steps = 5, 4096, 8
    params = _f32([S0, R, SIG, T])
    paths = kind == "paths"
    fwd = cuda_gbm.gbm_paths_reference if paths else cuda_gbm.gbm_terminal_reference
    out = fwd(seed, *params, n, steps, device="cpu")
    g = torch.from_numpy(_cotangent(4, tuple(out.shape)))
    z = cuda_gbm.path_normals(seed, 0, 1, cuda_gbm.PATH_TILE if paths
                              else cuda_gbm.TERMINAL_TILE, steps, True)[:, :out.shape[-1]]
    if paths:
        got = cuda_gbm.gbm_paths_vjp(g, seed, *params, n, steps)
    else:
        got = cuda_gbm.gbm_terminal_vjp(g, out, seed, *params, n, steps)
    want = [_central(lambda p: _gbm64(z, p, paths), (g,), params, i) for i in range(4)]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


def test_euler_plain_vjp_matches_central_differences():
    """The Euler VJP's plain version on the Philox stream against a float64
    central difference of the recursion on the same normals, at parameters
    that keep v far from 0 (v0 = theta = 0.09, xi = 0.2: no state comes
    near the clamp, where a difference quotient would straddle a kink):
    rtol 1e-4 (float32 states in the VJP)."""
    seed, n, steps = 6, 4096, 8
    fields = dict(kappa=2.0, theta=0.09, xi=0.2, rho=-0.7, v0=0.09)
    params = _f32([S0, R, T, *fields.values()])
    S, v = cuda_heston.heston_paths_reference(seed, *params[:3], HestonParams(*params[3:]), n,
                                              steps, return_variance=True, device="cpu")
    assert float(v.min()) > 1e-3
    gS = torch.from_numpy(_cotangent(7, tuple(S.shape)))
    gv = torch.from_numpy(_cotangent(8, tuple(v.shape))) * 100.0
    z1, z2 = cuda_heston._normals(seed, 1, cuda_heston.PATH_TILE, steps, True, 0, "cpu")
    got = cuda_heston.euler_paths_vjp(gS, gv, seed, *params[:3], HestonParams(*params[3:]), n,
                                      steps)
    want = [_central(lambda p: _heston64(z1, z2, p), (gS, gv), params, i) for i in range(8)]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4)


def _folded_euler_vjp(z1, z2, gS, gv, S0_, r, T_, params):
    """The redesigned Euler VJP kernel's recursion (csrc/greeks.cu
    euler_tangent_step) on the plain version's float32 states: the tangent
    constants the wrapper folds (cuda_heston._vjp_tangent_consts), dv
    carried without the [v > 0] mask, a and c once a step, the six carried
    tangents in float32; each path's (8,) terms summed in float64, as the
    kernel's row sums are."""
    n = z1.shape[0]
    c = {k: float(v) for k, v in heston_constants(S0_, r, T_, params, n).items()}
    r_n, mh_n, ds_dT, kappa_n, xi_ds_dT, dt, kdt, rho_ratio, theta, h_sdt, h_xi_sdt = \
        list(cuda_heston._vjp_tangent_consts(r, T_, params, n))
    sqrt_dt, xi_sdt = c["sqrt_dt"], float(np.float32(c["xi"]) * np.float32(c["sqrt_dt"]))
    ca, mhdt = float(1.0 - np.float32(c["kappa"]) * np.float32(dt)), -0.5 * dt
    log_s = torch.zeros(z1.shape[1])
    v = torch.full_like(log_s, c["v0"])
    tl, tv = torch.zeros((6, z1.shape[1])), torch.zeros((6, z1.shape[1]))
    tv[5] = 1.0

    def contract(t):
        gs = (gS[t] * torch.exp(c["log_s0"] + log_s)).double()
        return torch.cat([gs[None], (gs * t)[None], gs * tl.double() + gv[t].double() * tv.double()])

    acc = contract(0)
    tv[5] = float(c["v0"] > 0.0)
    for t in range(n):
        z1_t, z2_t = z1[t], z2[t]
        w2 = c["rho"] * z1_t + c["rho_bar"] * z2_t
        vp = torch.clamp_min(v, 0.0)
        sv = torch.sqrt(vp)
        f = torch.where(vp > 1e-12, torch.rsqrt(vp), torch.zeros_like(vp))
        sq = sv * sqrt_dt
        v = torch.clamp_min(vp + c["kappa"] * (c["theta"] - vp) * c["dt"] + c["xi"] * sq * w2,
                            0.0)
        log_s = log_s + (c["r"] - 0.5 * vp) * c["dt"] + sq * z1_t
        th, sw = theta - vp, sv * w2
        direct = torch.stack([th * kappa_n + xi_ds_dT * sw, th * dt, torch.full_like(vp, kdt),
                              sqrt_dt * sw, xi_sdt * sv * (z1_t - rho_ratio * z2_t),
                              torch.zeros_like(vp)])
        a = h_sdt * z1_t * f + mhdt
        cc = h_xi_sdt * w2 * f + ca
        tl = tl + a * tv
        tl[0] += vp * mh_n + ds_dT * sv * z1_t + r_n
        tv = torch.where(v > 0.0, cc * tv + direct, torch.zeros_like(tv))
        acc = acc + contract(t + 1)
    sums = acc.sum(1)
    return torch.cat([sums[:1] / float(np.float32(S0_)), sums[1:2] * float(c["dt"]), sums[2:]])


@pytest.mark.parametrize("xi", [0.3, 1.0])
def test_folded_euler_tangents_match_the_plain_vjp(xi):
    """The redesign's folded tangent rules, emulated in float32, against the
    plain version (float64 tangents on the same float32 states) on the
    Philox stream: every component within 1e-4 of its paths' absolute shares
    (chip_smoke.VJP_RTOL), at xi = 0.3 and at xi = 1.0, where the Feller
    condition fails and paths sit at v = 0, so a tangent that the clamp
    zeroed must stay zero without the [v > 0] mask."""
    seed, n, steps = 13, 4096, 16
    fields = dict(FIELDS, xi=xi)
    params = _f32([S0, R, T, *fields.values()])
    hp = HestonParams(*params[3:])
    S, v = cuda_heston.heston_paths_reference(seed, *params[:3], hp, n, steps,
                                              return_variance=True, device="cpu")
    if xi == 1.0:
        assert float((v == 0.0).double().mean()) > 0.01
    gS = torch.from_numpy(_cotangent(14, tuple(S.shape)))
    gv = torch.from_numpy(_cotangent(15, tuple(v.shape))) * 100.0
    z1, z2 = cuda_heston._normals(seed, 1, cuda_heston.PATH_TILE, steps, True, 0, "cpu")
    shares = heston_euler_vjp_from_normals(z1, z2, gS, gv, *params[:3], hp, per_path=True)
    got = _folded_euler_vjp(z1, z2, gS, gv, *params[:3], hp)
    scale = shares.abs().sum(1)
    assert torch.all((got - shares.sum(1)).abs() <= 1e-4 * scale), (got, shares.sum(1))


def _vjp_layout(n_tiles, antithetic):
    """(block, tile, Philox slot, column) of every thread of the redesigned
    Euler VJP kernel, as euler_vjp_kernel computes them: block b covers tile
    b // 16; with antithetics lane l of warp w holds slot 128 (b % 16) + 16 w
    + l % 16, at column slot (+ 2048 for l >= 16, the mirror); without,
    slot 256 (b % 16) + thread at column slot."""
    blocks = cuda_heston.euler_vjp_blocks(n_tiles)
    b = np.arange(blocks)[:, None]
    th = np.arange(256)[None, :]
    tile, bi, lane = b // 16 + 0 * th, b % 16, th % 32
    if antithetic:
        slot = bi * 128 + (th // 32) * 16 + lane % 16
        col = slot + (lane >= 16) * 2048
    else:
        slot = bi * 256 + th
        col = slot + 0 * b
    return blocks, tile, slot, tile * cuda_heston.PATH_TILE + col


@pytest.mark.parametrize("antithetic", [True, False])
@pytest.mark.parametrize("n_tiles", [1, 2, 7, 256])
def test_euler_vjp_grid_covers_each_path_once_within_its_tile(n_tiles, antithetic):
    """The redesign's launch geometry (cuda_heston.euler_vjp_blocks, the C
    entry's vjp_grid_matches): 16 blocks a tile, each of one tile, every
    path of the matrix once, each thread's Philox slot that of its column
    in the plain version's layout (the mirror of column j at j + 2048), and
    a path and its mirror in lanes l and l + 16 of one warp."""
    blocks, tile, slot, col = _vjp_layout(n_tiles, antithetic)
    assert blocks == 16 * n_tiles
    assert np.array_equal(np.sort(col.ravel()), np.arange(n_tiles * cuda_heston.PATH_TILE))
    assert np.all(col // cuda_heston.PATH_TILE == tile)
    assert np.all(tile == tile[:, :1])
    width = cuda_heston.PATH_TILE // 2 if antithetic else cuda_heston.PATH_TILE
    assert np.all(slot == col % cuda_heston.PATH_TILE % width)
    if antithetic:
        warps = slot.reshape(blocks, 8, 32)
        assert np.array_equal(warps[..., :16], warps[..., 16:])


@pytest.mark.parametrize("n_tiles", [0, -1, 1 << 27])
def test_euler_vjp_blocks_refuse_what_the_kernel_refuses(n_tiles):
    with pytest.raises(ValueError):
        cuda_heston.euler_vjp_blocks(n_tiles)


def _gbm_vjp_layout(n_tiles, antithetic):
    """(block, tile, Philox slot, column) of every thread of the redesigned
    GBM paths VJP kernel (csrc/greeks.cu gbm_vjp_kernel): euler_vjp_kernel's
    layout on cuda_gbm.gbm_vjp_blocks' grid."""
    blocks = cuda_gbm.gbm_vjp_blocks(n_tiles)
    assert blocks == cuda_heston.euler_vjp_blocks(n_tiles)
    return _vjp_layout(n_tiles, antithetic)


@pytest.mark.parametrize("antithetic", [True, False])
@pytest.mark.parametrize("n_tiles", [1, 3, 512])
def test_gbm_vjp_grid_covers_each_path_once_within_its_tile(n_tiles, antithetic):
    """The redesigned GBM paths VJP's launch geometry (gbm_vjp_blocks, the C
    entry's vjp_grid_matches): 16 blocks a tile, as many rows, each block of
    one tile, every path of the matrix once, each thread's Philox slot that
    of its column in kernel 2's layout (the mirror of column j at j + 2048),
    and a path and its mirror in lanes l and l + 16 of one warp."""
    blocks, tile, slot, col = _gbm_vjp_layout(n_tiles, antithetic)
    assert blocks == 16 * n_tiles
    assert np.array_equal(np.sort(col.ravel()), np.arange(n_tiles * cuda_heston.PATH_TILE))
    assert np.all(col // cuda_heston.PATH_TILE == tile)
    assert np.all(tile == tile[:, :1])
    width = cuda_heston.PATH_TILE // 2 if antithetic else cuda_heston.PATH_TILE
    assert np.all(slot == col % cuda_heston.PATH_TILE % width)
    if antithetic:
        warps = slot.reshape(blocks, 8, 32)
        assert np.array_equal(warps[..., :16], warps[..., 16:])
        cols = col.reshape(blocks, 8, 32)
        assert np.array_equal(cols[..., 16:] - cols[..., :16],
                              np.full_like(cols[..., :16], cuda_heston.PATH_TILE // 2))


@pytest.mark.parametrize("n_tiles", [0, -1, 1 << 27])
def test_gbm_vjp_blocks_refuse_what_the_kernel_refuses(n_tiles):
    with pytest.raises(ValueError):
        cuda_gbm.gbm_vjp_blocks(n_tiles)


def _gbm_vjp_pass_normals(seed, n_tiles, n_steps):
    """The normals the redesigned GBM paths VJP's lanes step on, (n_steps,
    n_pad) in column order: pass D of lane l makes Philox block 2D + l // 16
    of its pair's slot and two Box-Mullers of it, nz = (cos, sin) of (x, y)
    and of (z, w); step 8D + k takes nz[k % 4] of lane (l % 16) + 16 (k >=
    4), negated on the mirror lanes (l >= 16)."""
    width = cuda_heston.PATH_TILE // 2
    n_passes = -(-n_steps // 8)
    words = stream_words(seed, 0, n_tiles, width, 2 * n_passes)
    u = uniform_from_bits(words)
    nz = torch.stack([*box_muller(u[:, 0], u[:, 1]), *box_muller(u[:, 2], u[:, 3])], 1)
    z = torch.empty((n_steps, n_tiles * cuda_heston.PATH_TILE))
    _, tile, slot, col = _vjp_layout(n_tiles, True)
    lane = np.arange(256)[None, :] % 32 + 0 * col
    tile, slot, col, lane = (torch.from_numpy(x.ravel()) for x in (tile, slot, col, lane))
    src = tile * width + slot
    sign = torch.where(lane >= 16, -1.0, 1.0)
    for t in range(n_steps):
        D, k = divmod(t, 8)
        z[t, col] = sign * nz[2 * D + (k >= 4), k % 4, src]
    return z


@pytest.mark.parametrize("n_steps", [3, 8, 50])
def test_gbm_vjp_pass_schedule_draws_kernel_2s_normals(n_steps):
    """Mirror of the redesign's draw schedule (one Philox block and two
    Box-Mullers a lane a pass, the pair's lanes swapping normals by
    shuffles): every step's normal is the one kernel 2 draws for that path
    (path_normals), bit for bit, at step counts below, at and past a pass."""
    seed, n_tiles = 21, 2
    got = _gbm_vjp_pass_normals(seed, n_tiles, n_steps)
    want = path_normals(seed, 0, n_tiles, cuda_heston.PATH_TILE, n_steps, True, "cpu")
    assert torch.equal(got, want)


def _gbm_vjp_pass_sums(z, g, params, n_steps):
    """The redesign's float32 sums on normals z (n_steps, n_pad): a and W a
    path (the mirror's with its own negated normals), S / s0 = 2^(a log2 e),
    a pass's sums of g S / s0 and g S k / s0 (k = 0..7) with B += s0_pass
    t0 + s1_pass, t0 = 8D + 1, and the three sums times s0 at the end;
    summed over paths in float64 and taken through gbm_chain."""
    c = {k: float(v) for k, v in gbm_constants(*params, n_steps).items()}
    a = torch.zeros(z.shape[1])
    W = torch.zeros_like(a)
    A, B, C = g[0].clone(), torch.zeros_like(a), torch.zeros_like(a)
    for D in range(-(-n_steps // 8)):
        s0, s1 = torch.zeros_like(a), torch.zeros_like(a)
        for k in range(min(8, n_steps - 8 * D)):
            t = 8 * D + k
            a = (a + c["drift"]) + c["diffusion"] * z[t]
            W = W + z[t]
            gs = g[t + 1] * torch.exp2(a * float(np.float32(1.4426950408889634)))
            s0 = s0 + gs
            s1 = s1 + gs * float(k)
            C = C + gs * W
        A = A + s0
        B = B + (s0 * float(8 * D + 1) + s1)
    sums = torch.stack([A, B, C]).double() * c["s0"]
    return gbm_chain(sums.sum(1), *params, n_steps)


@pytest.mark.parametrize("n_steps", [5, 50])
def test_gbm_vjp_pass_sums_match_the_plain_vjp(n_steps):
    """The redesign's accumulation (the pass sums and B's t0 split, the
    weight 2^(a log2 e) s0, W of the mirror on its negated normals), emulated
    in float32 on the plain version's normals: within 1e-4 of the paths'
    absolute shares of the plain VJP (chip_smoke.VJP_RTOL)."""
    seed, n = 23, 4096
    params = _f32([S0, R, SIG, T])
    z = path_normals(seed, 0, 1, cuda_heston.PATH_TILE, n_steps, True, "cpu")
    g = torch.from_numpy(_cotangent(24, (n_steps + 1, n)))
    g = g + 4.0 * (gbm_euler_from_normals(z, *params) / S0 - 1.0) / n
    got = _gbm_vjp_pass_sums(z, g, params, n_steps)
    shares = gbm_euler_vjp_from_normals(z, g, *params, per_path=True)
    scale = shares.abs().sum(1)
    assert torch.all((got - shares.sum(1)).abs() <= 1e-4 * scale), (got, shares.sum(1))
    assert torch.equal(cuda_gbm.gbm_paths_vjp(g, seed, *params, n, n_steps),
                       gbm_euler_vjp_from_normals(z, g, *params))


def test_gbm_vjp_first_design_takes_a_card_only():
    """Kernel 12's first design, the redesign's yardstick, has no plain
    route: a CPU cotangent raises, and nothing is launched."""
    g = torch.ones((5, 4096))
    with pytest.raises(ValueError, match="CUDA"):
        cuda_gbm.gbm_paths_vjp_first(g, 1, S0, R, SIG, T, 4096, 4)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_gbm.gbm_paths_vjp_rows_first(g, 1, S0, R, SIG, T, 4096, 4)
    assert cuda_gbm.launches["gbm_paths_vjp_first"] == 0


def test_vjp_tangent_consts_are_the_float32_fold():
    """The redesign's host constants (EulerT), in the kernel's order."""
    hp = HestonParams(**FIELDS)
    n = 50
    got = np.asarray(list(cuda_heston._vjp_tangent_consts(R, T, hp, n)), np.float32)
    f = np.float32
    dt = f(T) / f(n)
    ds_dT = np.sqrt(dt) / (f(2) * f(T))
    rho_bar = np.sqrt(f(1) - f(FIELDS["rho"]) * f(FIELDS["rho"]))
    want = np.array([f(R) / f(n), f(-0.5) / f(n), ds_dT, f(FIELDS["kappa"]) / f(n),
                     f(FIELDS["xi"]) * ds_dT, dt, f(FIELDS["kappa"]) * dt,
                     f(FIELDS["rho"]) / rho_bar, f(FIELDS["theta"]), f(0.5) * np.sqrt(dt),
                     f(FIELDS["xi"]) * (f(0.5) * np.sqrt(dt))], np.float32)
    np.testing.assert_array_equal(got, want)


def test_vjp_wrappers_on_the_cpu_are_the_plain_versions():
    seed, n, steps = 9, 4096, 4
    g = torch.from_numpy(_cotangent(10, (steps + 1, n)))
    assert torch.equal(cuda_gbm.gbm_paths_vjp(g, seed, S0, R, SIG, T, n, steps),
                       cuda_gbm.gbm_paths_vjp_reference(g, seed, S0, R, SIG, T, n, steps))
    hp = HestonParams(**FIELDS)
    assert torch.equal(cuda_heston.euler_paths_vjp(g, None, seed, S0, R, T, hp, n, steps),
                       cuda_heston.euler_paths_vjp_reference(g, None, seed, S0, R, T, hp, n,
                                                             steps))
    assert sum(cuda_gbm.launches[k] for k in ("gbm_paths_vjp", "gbm_terminal_vjp")) == 0
    assert cuda_heston.launches["euler_paths_vjp"] == 0


@pytest.mark.parametrize("call", [
    lambda g: cuda_gbm.gbm_paths_vjp(g, 1, S0, R, SIG, T, 4096, 4),
    lambda g: cuda_gbm.gbm_terminal_vjp(g[0], g[0], 1, S0, R, SIG, T, 4096, 4),
    lambda g: cuda_heston.euler_paths_vjp(g, g, 1, S0, R, T, HestonParams(**FIELDS), 4096, 4),
    lambda g: cuda_heston.euler_paths_vjp_first(g, g, 1, S0, R, T, HestonParams(**FIELDS),
                                                4096, 4),
], ids=["gbm_paths_vjp", "gbm_terminal_vjp", "euler_paths_vjp", "euler_paths_vjp_first"])
def test_vjp_wrappers_refuse_a_tensor_off_the_cpu(call):
    """A cotangent that is not on the CPU goes to the kernel or raises: it
    never falls back to the plain version."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py covers the VJP kernels")
    with pytest.raises((RuntimeError, ValueError)):
        call(torch.empty((5, 4096), device="meta"))


def test_autograd_routes_through_the_vjp():
    """simulate_gbm / simulate_heston with a parameter that requires grad
    run the same forward (the same bits) and backpropagate through the
    VJP; QE-M and terminal Heston refuse a gradient."""
    cfg = MCConfig(n_paths=4096, n_steps=4)
    from options_model_tpu_torch.models.gbm import simulate_gbm

    sig = torch.tensor(SIG, requires_grad=True)
    S = simulate_gbm(3, S0, R, sig, T, cfg, device="cpu")
    assert torch.equal(S, simulate_gbm(3, S0, R, SIG, T, cfg, device="cpu"))
    (d,) = torch.autograd.grad(S.sum(), sig)
    g = torch.ones_like(S)
    assert float(d) == pytest.approx(float(cuda_gbm.gbm_paths_vjp(g, 3, S0, R, SIG, T, 4096,
                                                                  4)[2]), rel=1e-6)
    hp = HestonParams(**dict(FIELDS, v0=torch.tensor(0.04, requires_grad=True)))
    with pytest.raises(NotImplementedError):
        simulate_heston(3, S0, R, T, hp, cfg, scheme="qe", device="cpu")
    with pytest.raises(NotImplementedError):
        simulate_heston(3, S0, R, T, hp, cfg, return_paths=False, device="cpu")
    S, v = simulate_heston(3, S0, R, T, hp, cfg, return_variance=True, device="cpu")
    (d,) = torch.autograd.grad(v.sum(), hp.v0)
    assert float(d) > 0.0


def test_exact_gbm_european_matches_black_scholes():
    """price_european_gbm_exact: kernel 1 at one step is the exact law."""
    p, se, n = price_european_gbm_exact(torch.Generator().manual_seed(4), S0,
                                        OptionSpec(strike=K, rate=R, cp=CALL, sigma=SIG), 1.0,
                                        1 << 16, device="cpu")
    bs = float(bs_price(S0, K, 1.0, R, SIG, device="cpu"))
    assert float(n) == 1 << 16 and 0 < float(se) < 0.1
    assert abs(float(p) - bs) < 4 * float(se)
