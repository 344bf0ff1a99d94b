"""The port's QE-M Heston scheme (models/heston.heston_qe_from_normals, the
plain versions of csrc/heston_qe.cu) held against the JAX package.

- Zero bits: the JAX Pallas kernels in interpret mode draw zero bits
  (tests/test_torch_kernels.py), so every path sees z_v = z_s = 0 and u = 0,
  its mirror u = 1 - 0 = 1; the port's recursion on those draws must give
  the same matrix, rtol 1e-6.
- The XLA simulator's own draws: z_v, z_s and u = ndtr(z_u) rebuilt from
  models/blocks.block_normals with the keys _simulate_heston_qe folds, fed to
  the port's recursion. rtol 2e-5 on S, atol 1e-6 on v: f32 rounding
  compounding over 16 steps (the kernels carry log S relative to log S0, the
  XLA simulator absolute log S). A high vol-of-vol case takes the
  exponential branch: each step is held at the same tolerance, the whole
  recursion at a looser one (its test says why).
- A QE European call against the COS closed form, within 4 stderr + 0.05.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from options_model_tpu.calibration import heston_cos_price
from options_model_tpu.core.config import HestonParams as JHestonParams
from options_model_tpu.core.config import MCConfig as JMCConfig
from options_model_tpu.models.blocks import block_normals
from options_model_tpu.models.heston import simulate_heston as j_simulate_heston
from options_model_tpu.ops.pallas_heston import (_qe_params_array, heston_paths_qe_pallas,
                                                 heston_terminal_qe_pallas)
from options_model_tpu_torch.core.config import CALL, HestonParams, MCConfig, OptionSpec
from options_model_tpu_torch.models.heston import (heston_qe_from_normals, qe_constants,
                                                   qe_step, simulate_heston)
from options_model_tpu_torch.ops import cuda_heston
from options_model_tpu_torch.ops.philox import (box_muller, qe_path_draws, stream_words,
                                                uniform_from_bits)
from options_model_tpu_torch.pricers.european import (make_terminal_sampler,
                                                      price_european_mc)

BASE = dict(kappa=2.0, theta=0.04, xi=0.3, rho=-0.7, v0=0.04)
HIGH_XI = dict(kappa=0.5, theta=0.04, xi=1.5, rho=-0.5, v0=0.04)
S0, R, T = 100.0, 0.05, 0.5
N_STEPS = 16


def _params(fields):
    jp = JHestonParams(**fields)
    return jp, HestonParams.from_reference(vars(jp))


def _zero_draws(n_paths, tile):
    """Zero words: z = 0, u = 0 on the first half of each tile, 1 - 0 = 1
    on its mirror half."""
    z = torch.zeros((N_STEPS, n_paths), dtype=torch.float32)
    u = torch.zeros_like(z).reshape(N_STEPS, -1, 2, tile // 2)
    u[:, :, 1] = 1.0
    return z, z, u.reshape(N_STEPS, n_paths)


@pytest.mark.parametrize("fields", [BASE, HIGH_XI], ids=["base", "high_xi"])
def test_qe_constants_match_reference(fields):
    jp, hp = _params(fields)
    par = np.asarray(_qe_params_array(S0, R, T, jp, N_STEPS))[0]
    c = qe_constants(S0, R, T, hp, N_STEPS)
    names = ["s0", "r", "dt", "kappa", "theta", "xi", "rho", None, "v0", "ekt", "c1",
             "c2", "K1", "K2", "K3", "K4"]
    got = np.array([0.0 if k is None else c[k] for k in names], np.float32)
    assert all(isinstance(c[k], np.float32) for k in names if k is not None)
    np.testing.assert_allclose(got, par, rtol=1e-6)


@pytest.mark.parametrize("fields", [BASE, HIGH_XI], ids=["base", "high_xi"])
def test_qe_paths_zero_bits_match_interpret_kernel(fields):
    jp, hp = _params(fields)
    S_j, v_j = heston_paths_qe_pallas(1, S0, R, T, jp, 4096, N_STEPS, interpret=True,
                                      return_variance=True)
    S, v = heston_qe_from_normals(*_zero_draws(4096, 4096), S0, R, T, hp,
                                  return_variance=True)
    np.testing.assert_allclose(S.numpy(), np.asarray(S_j), rtol=1e-6)
    np.testing.assert_allclose(v.numpy(), np.asarray(v_j), rtol=1e-6)
    assert float(S[0, 0]) == float(S_j[0, 0])


@pytest.mark.parametrize("fields", [BASE, HIGH_XI], ids=["base", "high_xi"])
def test_qe_terminal_zero_bits_match_interpret_kernel(fields):
    jp, hp = _params(fields)
    ST_j = heston_terminal_qe_pallas(1, S0, R, T, jp, 16384, N_STEPS, interpret=True)
    ST = heston_qe_from_normals(*_zero_draws(16384, 16384), S0, R, T, hp,
                                return_paths=False)
    np.testing.assert_allclose(ST.numpy(), np.asarray(ST_j), rtol=1e-6)


def _xla_draws(key, cfg):
    """(z_v, z_s, u) as _simulate_heston_qe draws them: block b folds b into
    the key, step t and draw d fold in (t, d), u = ndtr(z_u)."""
    half = cfg.path_block // 2
    out = np.zeros((3, cfg.n_steps, cfg.n_paths), np.float32)
    for b in range(cfg.n_paths // cfg.path_block):
        block_key = jax.random.fold_in(key, b)
        for t in range(cfg.n_steps):
            z_v, z_s, z_u = block_normals(block_key, t, half, 3, cfg.antithetic,
                                          jnp.float32)
            u = jax.scipy.special.ndtr(z_u)
            for d, x in enumerate((z_v, z_s, u)):
                out[d, t, b * cfg.path_block:(b + 1) * cfg.path_block] = np.asarray(x)
    return [torch.from_numpy(x) for x in out]


@pytest.fixture(scope="module")
def xla_runs():
    """The XLA simulator's QE paths (S, v) and its draws, per parameter set."""
    cfg = JMCConfig(n_paths=8192, n_steps=N_STEPS, path_block=4096)
    key = jax.random.key(int(np.random.default_rng(5).integers(1 << 31)))
    draws = _xla_draws(key, cfg)
    out = {}
    for name, fields in (("base", BASE), ("high_xi", HIGH_XI)):
        jp, hp = _params(fields)
        S_j, v_j = j_simulate_heston(key, S0, R, T, jp, cfg, return_paths=True,
                                     return_variance=True, scheme="qe")
        out[name] = (hp, draws, np.asarray(S_j), np.asarray(v_j))
    return out


@pytest.mark.parametrize("return_paths", [True, False])
def test_qe_recursion_matches_xla_simulator_on_its_draws(xla_runs, return_paths):
    hp, draws, S_j, v_j = xla_runs["base"]
    S, v = heston_qe_from_normals(*draws, S0, R, T, hp, return_variance=True,
                                  return_paths=return_paths)
    if not return_paths:
        S_j, v_j = S_j[-1], v_j[-1]
    assert S.shape == S_j.shape and v.shape == v_j.shape
    np.testing.assert_allclose(S.numpy(), S_j, rtol=2e-5)
    np.testing.assert_allclose(v.numpy(), v_j, rtol=0, atol=1e-6)


def test_qe_step_matches_xla_simulator_at_high_vol_of_vol(xla_runs):
    """xi = 1.5, kappa = 0.5 (tests/test_qe.py:52) takes the exponential
    branch on many path-steps. Each step of the port, started from the XLA
    simulator's state (log S, v) at t, lands on its state at t + 1 within
    rtol 2e-5 on S and atol 1e-6 on v."""
    hp, (z_v, z_s, u), S_j, v_j = xla_runs["high_xi"]
    c = {k: float(x) for k, x in qe_constants(S0, R, T, hp, N_STEPS).items()}
    S_j, v_j = torch.from_numpy(S_j.copy()), torch.from_numpy(v_j.copy())
    log_s, v = qe_step(torch.log(S_j[:-1]) - c["log_s0"], v_j[:-1], z_v, z_s, u, c)
    np.testing.assert_allclose(torch.exp(c["log_s0"] + log_s).numpy(), S_j[1:].numpy(),
                               rtol=2e-5)
    np.testing.assert_allclose(v.numpy(), v_j[1:].numpy(), rtol=0, atol=1e-6)
    m = c["theta"] + (v_j[:-1] - c["theta"]) * c["ekt"]
    psi = (v_j[:-1] * c["c1"] + c["c2"]) / torch.clamp_min(m * m, 1e-20)
    assert float((psi > 1.5).float().mean()) > 0.05


@pytest.mark.parametrize("return_paths", [True, False])
def test_qe_recursion_tracks_xla_simulator_at_high_vol_of_vol(xla_runs, return_paths):
    """The whole 16-step recursion at xi = 1.5: rtol 2e-4 on S and atol 2e-4
    on v (measured max 2.5e-5 and 3.0e-5 here, up to 4.7e-5 and 7.8e-5 over
    other seeds). The XLA simulator contracts each multiply-add into an FMA
    (the port rounds the product and the sum apart), and in the exponential
    branch v = log((1 - p) / (1 - u)) / beta, with u just above p, turns
    that last-ulp difference in p into a relative change of ulp / (p - u)
    in v, which the following steps carry into S."""
    hp, draws, S_j, v_j = xla_runs["high_xi"]
    S, v = heston_qe_from_normals(*draws, S0, R, T, hp, return_variance=True,
                                  return_paths=return_paths)
    if not return_paths:
        S_j, v_j = S_j[-1], v_j[-1]
    np.testing.assert_allclose(S.numpy(), S_j, rtol=2e-4)
    np.testing.assert_allclose(v.numpy(), v_j, rtol=0, atol=2e-4)


def test_qe_draw_layout():
    """One Philox call per step: words 0, 1 through Box-Muller, word 2 the
    uniform; the mirror half of each tile is (-z_v, -z_s, 1 - u)."""
    seed, tile, n_tiles, n_steps = 0x1234_5678_9ABC_DEF0, 64, 3, 5
    z_v, z_s, u = qe_path_draws(seed, 2, n_tiles, tile, n_steps, True)
    w = stream_words(seed, 2, n_tiles, tile // 2, n_steps)
    zv_w, zs_w = box_muller(uniform_from_bits(w[:, 0]), uniform_from_bits(w[:, 1]))
    u_w = uniform_from_bits(w[:, 2])
    for got, want, mirror in ((z_v, zv_w, -zv_w), (z_s, zs_w, -zs_w), (u, u_w, 1.0 - u_w)):
        g = got.reshape(n_steps, n_tiles, 2, tile // 2)
        assert torch.equal(g[:, :, 0].reshape(n_steps, -1), want)
        assert torch.equal(g[:, :, 1].reshape(n_steps, -1), mirror)
    plain = qe_path_draws(seed, 2, n_tiles, tile, n_steps, False)
    assert plain[2].shape == (n_steps, n_tiles * tile)
    assert bool(((plain[2] >= 0) & (plain[2] < 1)).all())


@pytest.mark.parametrize("kind", ["paths", "terminal"])
def test_qe_chunk_at_first_tile_equals_slice_of_full_run(kind):
    _, hp = _params(BASE)
    if kind == "paths":
        tile, fn = cuda_heston.PATH_TILE, cuda_heston.heston_paths_qe
        kw = dict(return_variance=True)
    else:
        tile, fn = cuda_heston.TERMINAL_TILE, cuda_heston.heston_terminal_qe
        kw = {}
    full = fn(77, S0, R, T, hp, 2 * tile, 4, device="cpu", **kw)
    part = fn(77, S0, R, T, hp, tile, 4, first_tile=1, device="cpu", **kw)
    for f, p in zip(*(x if isinstance(x, tuple) else (x,) for x in (full, part))):
        assert torch.equal(f[..., tile:], p)


def test_qe_european_call_matches_cos():
    jp, hp = _params(dict(kappa=2.0, theta=0.04, xi=0.6, rho=-0.7, v0=0.04))
    sampler = make_terminal_sampler("heston", S0, R, 1.0, heston=hp, heston_scheme="qe",
                                    device="cpu")
    spec = OptionSpec(strike=100.0, rate=R, cp=CALL)
    p, se, n = price_european_mc(torch.Generator().manual_seed(9), sampler, spec, 1.0,
                                 MCConfig(n_paths=1 << 14, n_steps=8))
    cos = float(heston_cos_price(S0, 100.0, 1.0, R, jp, 1.0))
    assert float(n) == 1 << 14 and 0 < float(se) < 0.2
    assert abs(float(p) - cos) <= 4.0 * float(se) + 0.05, (float(p), float(se), cos)


def test_cpu_wrappers_are_the_plain_versions():
    _, hp = _params(BASE)
    args = (21, S0, R, T, hp, 5000, 8, True)
    S, v = cuda_heston.heston_paths_qe(*args, return_variance=True, device="cpu")
    S_ref, v_ref = cuda_heston.heston_paths_qe_reference(*args, return_variance=True,
                                                         device="cpu")
    assert S.shape == v.shape == (9, 8192)
    assert torch.equal(S, S_ref) and torch.equal(v, v_ref) and bool((v >= 0).all())
    ST = cuda_heston.heston_terminal_qe(*args, device="cpu")
    assert ST.shape == (16384,) and bool(torch.isfinite(ST).all())
    cfg = MCConfig(n_paths=5000, n_steps=8)
    assert torch.equal(simulate_heston(21, S0, R, T, hp, cfg, scheme="qe", device="cpu"),
                       S)
    assert cuda_heston.launches["heston_paths_qe"] == 0
    assert cuda_heston.launches["heston_terminal_qe"] == 0
    with pytest.raises(ValueError, match="scheme"):
        simulate_heston(21, S0, R, T, hp, cfg, scheme="milstein", device="cpu")


def test_qe_wrappers_refuse_a_cuda_device_without_cuda():
    """A CUDA tensor goes to the kernel or raises; it never falls back."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py covers the kernels")
    _, hp = _params(BASE)
    with pytest.raises((RuntimeError, ValueError)):
        cuda_heston.heston_paths_qe(1, S0, R, T, hp, 4096, 4, device="cuda")
    with pytest.raises((RuntimeError, ValueError)):
        cuda_heston.heston_terminal_qe(1, S0, R, T, hp, 16384, 4, device="cuda")
