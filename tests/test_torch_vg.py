"""Variance Gamma in the port (models/vg.py, the VG stream and gamma sampler
of ops/philox.py, the plain versions of kernels 21-22 in ops/cuda_vg.py, the
VG branches of the pricers) held against the JAX package and the laws on
the CPU.

Tolerances, each with its reason:
- The gamma sampler against scipy.stats.gamma at a = 0.01, 0.05, 1 and 2.5
  over 2^16 draws: mean, variance and the CDF at the 0.5, 0.75 and 0.95
  quantiles within 4 standard errors. Below those quantiles float32 holds
  the law's tiny values as subnormals or 0 (at a = 0.01 a third of the
  draws are below 2^-149): the share of zeros is held against the law's
  mass below 2^-150 within 4 standard errors instead.
- vg_from_draws on the JAX package's own draws (its fold_in keys, its
  jax.random.gamma) against simulate_vg and vg_terminal_exact: rtol 1e-5
  (float32 sums and log1p/exp in two libraries).
- The VG control-variate leg on the JAX package's paths: 2e-3 absolute, the
  float32 COS price's noise floor in both packages; the Richardson price
  as tests/test_torch_lsm.py's (3e-3 relative, 1e-2 on the stderr).
- Prices in law against the closed forms: 4 stderr (+ 1% of the price for
  the 10-date LSM against the COS-Bermudan value, the JAX test's bar).
- Layout, chunking and grouping: bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from options_model_tpu.core.config import PUT
from options_model_tpu.core.config import LSMConfig as JLSMConfig
from options_model_tpu.core.config import MCConfig as JMCConfig
from options_model_tpu.core.config import OptionSpec as JOptionSpec
from options_model_tpu.core.config import VGParams as JVGParams
from options_model_tpu.core.stats import masked_mean_stderr as j_masked_mean_stderr
from options_model_tpu.models import vg as jvg
from options_model_tpu.pricers import american as jam
from options_model_tpu_torch.calibration.charfn import vg_cos_price
from options_model_tpu_torch.core.config import LSMConfig, MCConfig, OptionSpec, VGParams
from options_model_tpu_torch.core.stats import masked_mean_stderr
from options_model_tpu_torch.models import vg
from options_model_tpu_torch.ops import cuda_vg
from options_model_tpu_torch.ops.cuda_heston import PATH_TILE, TERMINAL_TILE
from options_model_tpu_torch.ops.philox import (VG_MAX_ATTEMPTS, gamma_constants,
                                                gamma_from_stream, seed_from_generator,
                                                vg_path_draws)
from options_model_tpu_torch.pricers import american as am
from options_model_tpu_torch.pricers import surface_american
from options_model_tpu_torch.pricers.cos_bermudan import cos_bermudan_price
from options_model_tpu_torch.pricers.dual import price_american_bracket
from options_model_tpu_torch.pricers.european import make_terminal_sampler
from options_model_tpu_torch.pricers.surface_american import price_american_surface
from _torch_threads import one_torch_thread_module  # noqa: F401

FIELDS = dict(sigma=0.2, theta=-0.14, nu=0.2)           # tests/test_cos_bermudan.py
J_VG = JVGParams(**FIELDS)
VG = VGParams.from_reference(vars(J_VG))
EURO = VGParams(sigma=0.18, theta=-0.14, nu=0.35)       # tests/test_vg.py
SEED = 0x9E3779B97F4A7C15
PB = 4096

pytestmark = pytest.mark.usefixtures("one_torch_thread_module")


def _gen(seed):
    return torch.Generator().manual_seed(seed)


# ---- the gamma sampler ------------------------------------------------------------

@pytest.mark.parametrize("a", [0.01, 0.05, 1.0, 2.5])
def test_gamma_sampler_has_the_gamma_law(a):
    g, att = gamma_from_stream(SEED + int(a * 100), 0, 4, TERMINAL_TILE, 3, a,
                               return_attempts=True)
    x = g.double().numpy()
    n = x.size
    assert g.dtype == torch.float32 and np.all(np.isfinite(x)) and x.min() >= 0.0
    assert int(att.max()) < VG_MAX_ATTEMPTS
    assert abs(x.mean() - a) < 4 * np.sqrt(a / n)
    # Var of the sample variance: (mu4 - sigma^4) / n, mu4 = 3a^2 + 6a
    assert abs(x.var() - a) < 4 * np.sqrt((2 * a * a + 6 * a) / n)
    law = stats.gamma(a)
    for p in (0.5, 0.75, 0.95):
        assert abs((x <= law.ppf(p)).mean() - p) < 4 * np.sqrt(p * (1 - p) / n), p
    zeros = law.cdf(2.0 ** -150)
    assert abs((x == 0.0).mean() - zeros) <= 4 * np.sqrt(zeros * (1 - zeros) / n) + 1e-12
    if a == 0.01:
        assert (x == 0.0).mean() > 0.3          # the law's mass below float32's range


def test_gamma_constants_are_marsaglia_tsangs():
    for a, boost in ((0.01, True), (0.999, True), (1.0, False), (2.5, False)):
        k = gamma_constants(a)
        s = np.float32(a) + (np.float32(1) if boost else np.float32(0))
        assert k["boost"] == boost and k["d"] == s - np.float32(1 / 3)
        assert k["c"] == np.float32(1) / np.sqrt(np.float32(9) * k["d"])
    with pytest.raises(ValueError, match="positive"):
        gamma_constants(0.0)


def test_pair_layout_mirrors_the_normal_not_the_clock():
    z, g = vg_path_draws(SEED, 3, 2, PATH_TILE, 4, 0.05, antithetic=True)
    zt, gt = z.reshape(4, 2, 2, PATH_TILE // 2), g.reshape(4, 2, 2, PATH_TILE // 2)
    assert torch.equal(zt[:, :, 1], -zt[:, :, 0])
    assert not torch.equal(gt[:, :, 1], gt[:, :, 0])
    z1, g1 = vg_path_draws(SEED, 3, 2, PATH_TILE, 4, 0.05, antithetic=False)
    # without antithetics every path takes its own slot's normal; the clock is
    # the same draw either way
    assert torch.equal(g1, g) and torch.equal(z1[:, :PATH_TILE // 2], z[:, :PATH_TILE // 2])
    assert not torch.equal(z1[:, PATH_TILE // 2:PATH_TILE], z[:, PATH_TILE // 2:PATH_TILE])


@pytest.mark.parametrize("antithetic", [True, False])
def test_first_tile_chunks_reproduce_their_tiles(antithetic):
    S, g, k = cuda_vg.vg_paths(SEED, 100.0, 0.05, [0.5], VG, 3 * PATH_TILE, 5, antithetic,
                               device="cpu", return_draws=True)
    S1, g1, k1 = cuda_vg.vg_paths(SEED, 100.0, 0.05, [0.5], VG, PATH_TILE, 5, antithetic,
                                  first_tile=2, device="cpu", return_draws=True)
    cols = slice(2 * PATH_TILE, 3 * PATH_TILE)
    assert torch.equal(S1[0], S[0][:, cols]) and torch.equal(g1[0], g[0][:, cols])
    assert torch.equal(k1[0], k[0][:, cols])
    sampler = make_terminal_sampler("vg", 100.0, 0.05, 0.5, vg=VG, device="cpu")
    cfg = MCConfig(n_paths=3 * TERMINAL_TILE, n_steps=50, antithetic=antithetic)
    whole = sampler(SEED, 0, cfg)
    parts = [sampler(SEED, 0, MCConfig(TERMINAL_TILE, 50, antithetic)),
             sampler(SEED, 1, MCConfig(2 * TERMINAL_TILE, 50, antithetic))]
    assert torch.equal(whole, torch.cat(parts))


# ---- the plain recursion on the JAX package's draws --------------------------------

def _jax_draws(key, T, n_steps, cfg):
    """(z, G) as models/vg.py:39-52 draws them, in path order."""
    dt = jnp.asarray(T, jnp.float32) / n_steps
    nu = jnp.asarray(J_VG.nu, jnp.float32)
    half = cfg.path_block // 2

    def step(kt):
        kz, kg = (jax.random.fold_in(kt, d) for d in range(2))
        zh = jax.random.normal(kz, (half,), jnp.float32)
        return (jnp.concatenate([zh, -zh]),
                nu * jax.random.gamma(kg, dt / nu, (cfg.path_block,), jnp.float32))

    block = jax.jit(lambda bk: jax.vmap(lambda t: step(jax.random.fold_in(bk, t)))(
        jnp.arange(n_steps)))
    zs, gs = zip(*(block(jax.random.fold_in(key, b))
                   for b in range(cfg.n_paths // cfg.path_block)))
    return (torch.from_numpy(np.array(jnp.concatenate(zs, axis=1))),
            torch.from_numpy(np.array(jnp.concatenate(gs, axis=1))))


def test_vg_from_draws_matches_simulate_vg_on_its_draws():
    cfg = JMCConfig(n_paths=8192, n_steps=10, path_block=4096)
    key = jax.random.key(3)
    want = np.asarray(jvg.simulate_vg(key, 100.0, 0.05, 0.5, J_VG, cfg))
    z, G = _jax_draws(key, 0.5, 10, cfg)
    got = vg.vg_from_draws(z, G, 100.0, 0.05, 0.5, VG)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    S_T = vg.vg_from_draws(z, G, 100.0, 0.05, 0.5, VG, return_paths=False)
    assert torch.equal(S_T, got[-1])


def test_vg_from_draws_matches_vg_terminal_exact_on_its_draws():
    cfg = JMCConfig(n_paths=8192, n_steps=25, path_block=4096)
    key = jax.random.key(4)
    want = np.asarray(jvg.vg_terminal_exact(key, 100.0, 0.04, 1.0, J_VG, cfg))
    # vg_terminal_exact draws (kz, kg) from the block key itself: one step of T
    zs, gs = [], []
    nu = jnp.asarray(J_VG.nu, jnp.float32)
    for b in range(2):
        bk = jax.random.fold_in(key, b)
        kz, kg = (jax.random.fold_in(bk, d) for d in range(2))
        zh = jax.random.normal(kz, (2048,), jnp.float32)
        zs.append(jnp.concatenate([zh, -zh]))
        gs.append(nu * jax.random.gamma(kg, jnp.asarray(1.0, jnp.float32) / nu, (4096,),
                                        jnp.float32))
    z = torch.from_numpy(np.array(jnp.concatenate(zs)))[None]
    G = torch.from_numpy(np.array(jnp.concatenate(gs)))[None]
    got = vg.vg_from_draws(z, G, 100.0, 0.04, 1.0, VG, return_paths=False)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


def test_vg_constants_match_the_reference():
    c = vg.vg_constants(100.0, 0.05, 0.5, VG, 50)
    omega = float(jvg._vg_omega(J_VG, jnp.float32))
    dt = np.float32(0.5) / np.float32(50)
    assert c["shape"] == dt / np.float32(0.2)
    np.testing.assert_allclose(c["drift"], (0.05 + omega) * float(dt), rtol=1e-6)
    np.testing.assert_allclose((float(c["drift"]) / float(dt)) - 0.05, VG.omega(), rtol=1e-5)


# ---- the pricers ------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_vg_paths():
    cfg = JMCConfig(n_paths=1 << 14, n_steps=16, path_block=4096)
    return np.array(jam.simulate_paths(jax.random.key(9), 100.0, 0.5, cfg, "vg", rate=0.05,
                                       vg=J_VG, engine="xla"))


def test_vg_cv_leg_matches_on_jax_paths(jax_vg_paths):
    """The VG control-variate leg (f32 COS at its default terms in both
    packages) and the Richardson statistic with it, on the same paths."""
    S = jax_vg_paths
    js = JOptionSpec(strike=100.0, rate=0.05, cp=PUT)
    spec = OptionSpec.from_reference(vars(js))
    adj_j = jam._cv_adjustment(jnp.asarray(S), js, 0.5, model="vg", vg=J_VG)
    adj = am._cv_adjustment(torch.from_numpy(S), spec, 0.5, model="vg", vg=VG)
    np.testing.assert_allclose(adj.numpy(), np.asarray(adj_j), atol=2e-3)
    jl = JLSMConfig(richardson=True)
    stat_j, mask_j = jam.richardson_cv_stat(jnp.asarray(S), None, js, 0.5, jl, model="vg",
                                            vg=J_VG, pair_block=PB)
    stat, mask = am.richardson_cv_stat(torch.from_numpy(S), None, spec, 0.5,
                                       LSMConfig.from_reference(vars(jl)), model="vg", vg=VG,
                                       pair_block=PB)
    p_j, se_j, _ = j_masked_mean_stderr(stat_j, mask_j, None, PB)
    p, se, _ = masked_mean_stderr(stat, mask, PB)
    assert abs(float(p) / float(p_j) - 1.0) < 3e-3
    assert abs(float(se) / float(se_j) - 1.0) < 1e-2


def test_vg_american_put_against_the_cos_bermudan_oracle():
    """The CV price at 2^14 x 10 against the 10-date COS-Bermudan value,
    tests/test_cos_bermudan.py's bar; Richardson is a distinct estimate."""
    spec = OptionSpec(strike=100.0, rate=0.05, cp=PUT)
    mc = MCConfig(n_paths=1 << 14, n_steps=10)
    p, se = am.price_american(_gen(1), 100.0, 0.5, spec, mc, LSMConfig(), "vg", vg=VG,
                              device="cpu")
    oracle = cos_bermudan_price(100.0, 100.0, 0.5, 0.05, "vg", vg=VG, cp=PUT, n_dates=10)
    assert abs(float(p) - oracle) < max(0.01 * oracle, 4 * float(se))
    p_r, se_r = am.price_american(_gen(1), 100.0, 0.5, spec, mc, LSMConfig(richardson=True),
                                  "vg", vg=VG, device="cpu")
    assert float(se_r) > 0 and float(p_r) != float(p)
    with pytest.raises(ValueError, match="vg params"):
        am.price_american(_gen(1), 100.0, 0.5, spec, mc, LSMConfig(), "vg", device="cpu")


def test_vg_european_sampler_and_martingale():
    """tests/test_vg.py's config at 2^16 paths: the put against float64 COS
    within 4 stderr, E[S_T] e^{-(r-q)T} = S0 within 4 stderr; the path
    simulator's S_T against COS too."""
    from options_model_tpu_torch.pricers.european import price_european_mc

    spec = OptionSpec(strike=100.0, rate=0.05, cp=PUT, div_yield=0.01)
    cos = float(vg_cos_price(100.0, 100.0, 1.0, 0.05, EURO, cp=-1.0, q=0.01,
                             dtype=torch.float64, device="cpu"))
    sampler = make_terminal_sampler("vg", 100.0, 0.05, 1.0, vg=EURO, div_yield=0.01,
                                    device="cpu")
    p, se, _ = price_european_mc(_gen(2), sampler, spec, 1.0, MCConfig(1 << 16, 25))
    assert abs(float(p) - cos) < 4 * float(se)
    S_T = sampler(seed_from_generator(_gen(2)), 0, MCConfig(1 << 16, 1)).double()
    m = S_T.mean() * np.exp(-0.04)
    assert abs(float(m) - 100.0) < 4 * float(S_T.std()) * np.exp(-0.04) / np.sqrt(2 ** 16)
    S = vg.simulate_vg(5, 100.0, 0.04, 1.0, EURO, MCConfig(1 << 14, 8), return_paths=False,
                       device="cpu")
    pay = torch.clamp_min(100.0 - S.double(), 0.0) * np.exp(-0.05)
    pm = pay.reshape(-1, 2, PATH_TILE // 2).mean(dim=1).reshape(-1)
    assert abs(float(pm.mean()) - cos) < 4 * float(pm.std()) / np.sqrt(pm.numel())


def test_vg_surface_equals_the_per_maturity_loop(monkeypatch):
    """3 maturities x 4 strikes: the grouped route (one batched simulation
    per group) against simulate_seeded one maturity at a time, bit for bit,
    and the same bits with a group of one."""
    mc = MCConfig(n_paths=4096, n_steps=6)
    Ks, Ts = np.array([90.0, 95.0, 100.0, 105.0], np.float32), [0.1, 0.3, 0.5]

    def surface():
        return price_american_surface(_gen(6), 100.0, Ks, Ts, 0.05, mc, model="vg", vg=VG,
                                      device="cpu")

    P = surface()
    seed = seed_from_generator(_gen(6))
    rows = []
    for i, T in enumerate(Ts):
        S = am.simulate_seeded(seed, i, 100.0, T, mc, "vg", drift=0.05, vg=VG, device="cpu")
        cash = surface_american.lsm_surface_backward(S, torch.as_tensor(Ks), 0.05, T, -1.0,
                                                     return_cash=True)
        rows.append(cash.mean(dim=1))
    assert P.shape == (3, 4) and torch.equal(P, torch.stack(rows))
    calls = []

    def counted(*args, **kwargs):
        calls.append(len(args[3]))
        return vg.simulate_vg_maturities(*args, **kwargs)

    monkeypatch.setattr(surface_american, "simulate_vg_maturities", counted)
    monkeypatch.setattr(surface_american, "BATCH_ENTRIES", 4096 * (6 + 1))
    assert torch.equal(surface(), P) and calls == [1, 1, 1]
    with pytest.raises(ValueError, match="vg params"):
        price_american_surface(_gen(6), 100.0, Ks, Ts, 0.05, mc, model="vg", device="cpu")


# ---- without a card ---------------------------------------------------------------

def test_kernel_launches_refuse_cpu_tensors():
    rows = torch.from_numpy(cuda_vg.vg_rows(100.0, 0.05, [0.5], VG, 4))
    before = dict(cuda_vg.launches)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_vg.launch_vg_paths(torch.empty(1, 5, PATH_TILE), None, None, rows, SEED, 0, True)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_vg.launch_vg_terminal(torch.empty(TERMINAL_TILE), None, None, rows, SEED, 0, True)
    # kernel 21's first design takes a card only
    with pytest.raises(ValueError, match="CUDA"):
        cuda_vg.launch_vg_paths(torch.empty(1, 5, PATH_TILE), None, None, rows, SEED, 0, True,
                                first_design=True)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_vg.vg_paths_first(SEED, 100.0, 0.05, [0.5], VG, PATH_TILE, 4, device="cpu")
    # and kernel 22's
    with pytest.raises(ValueError, match="CUDA"):
        cuda_vg.launch_vg_terminal(torch.empty(TERMINAL_TILE), None, None, rows[:1], SEED, 0,
                                   True, first_design=True)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_vg.vg_terminal_first(SEED, 100.0, 0.05, 0.5, VG, TERMINAL_TILE, device="cpu")
    assert cuda_vg.launches == before


def test_entry_points_without_a_device_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    mc = MCConfig(n_paths=4096, n_steps=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        vg.simulate_vg(SEED, 100.0, 0.05, 0.5, VG, mc)
    with pytest.raises(RuntimeError, match="CUDA"):
        vg.vg_terminal_exact(SEED, 100.0, 0.05, 0.5, VG, mc)
    with pytest.raises(RuntimeError, match="CUDA"):
        cuda_vg.vg_terminal_first(SEED, 100.0, 0.05, 0.5, VG, TERMINAL_TILE)
    with pytest.raises(RuntimeError, match="CUDA"):
        am.price_american(_gen(1), 100.0, 0.5, OptionSpec(100.0, 0.05, PUT), mc, LSMConfig(),
                          "vg", vg=VG)


def test_vg_bracket_is_not_ported():
    with pytest.raises(NotImplementedError, match="pricers.dual.price_american_bracket"):
        price_american_bracket(_gen(1), 100.0, 0.5, OptionSpec(100.0, 0.05, PUT),
                               MCConfig(4096, 10, path_block=1024), model="vg", vg=VG,
                               device="cpu")
