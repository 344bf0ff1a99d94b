"""The multi-asset GBM slice of the port on the CPU: the basket stream
(ops/philox.basket_path_draws), the plain versions of kernels 27-28
(ops/cuda_basket.py, models/multiasset.basket_chain), the simulator, the
European basket pricer and the Bermudan basket LSM, held against the JAX
package (options_model_tpu/models/multiasset.py, pricers/basket.py,
pricers/american_basket.py) and its tests' own checks
(tests/test_basket.py, tests/test_basket_american.py) at smaller sizes.

Tolerances, each with its reason:
- The stream's words, the chain's W and log-states against a float32
  NumPy loop over ascending b, first_tile chunks, the terminal against the
  paths' last row, the mirror's -W and the Cholesky factor: bit for bit
  (the same float32 operations in the same order).
- The chain on the JAX package's own normals against its simulator: rtol
  1e-5 (XLA's L @ z sums in its own order and contracts into FMAs; the
  log-states differ in the last ulps, S = S0 exp(acc) against exp(log S0
  + acc) in one more).
- The closed form: 1e-10 relative, float64 on both sides.
- The backward on identical path matrices: 1e-9 relative in float64;
  in float32 BASKET_F32_RTOL on the price and 1e-3 on the stderr (the two
  packages' Grams sum in different orders, which moves the continuation in
  its last digits and can flip the exercise of a path at the boundary;
  measured 1.1e-7 and 0).
- The pricers' own checks: the JAX tests' bars, widened where the paths
  are fewer by the stderr at this size (each bar says how).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from options_model_tpu.core.config import MCConfig as JMCConfig
from options_model_tpu.models import multiasset as jm
from options_model_tpu.pricers import american_basket as jab
from options_model_tpu.pricers import basket as jb
from options_model_tpu_torch import models as tmodels
from options_model_tpu_torch import pricers as tpricers
from options_model_tpu_torch.core.config import MCConfig
from options_model_tpu_torch.core.stats import masked_mean_stderr
from options_model_tpu_torch.models import multiasset as tm
from options_model_tpu_torch.ops import cuda_basket as cb
from options_model_tpu_torch.ops.cuda_heston import PATH_TILE, TERMINAL_TILE
from options_model_tpu_torch.ops.philox import (BASKET_STREAM, box_muller, philox4x32,
                                               uniform_from_bits, basket_path_draws)
from options_model_tpu_torch.pricers import american_basket as tab
from options_model_tpu_torch.pricers import basket as tb
from options_model_tpu_torch.pricers.blackscholes import bs_price
from _torch_threads import one_torch_thread_module  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread_module")

T, R = 0.5, 0.05                                      # tests/test_basket.py:17-21
S0S = [100.0, 95.0, 110.0]
SIGS = [0.2, 0.3, 0.25]
CORR = [[1.0, 0.5, 0.3], [0.5, 1.0, 0.4], [0.3, 0.4, 1.0]]
W = [1.0 / 3] * 3
SEED = 0x2545F4914F6CDD1D
AB_TRUE = {90.0: 8.075, 100.0: 13.902, 110.0: 21.345}   # tests/test_basket_american.py:13
BASKET_F32_RTOL = 1e-4


def _gen(s):
    return torch.Generator().manual_seed(s)


def _assets(n, seed=1):
    """n assets with a random valid correlation (for n > 3)."""
    if n <= 3:
        return S0S[:n], SIGS[:n], [row[:n] for row in CORR[:n]]
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n + 2))
    cov = A @ A.T
    d = np.sqrt(np.diag(cov))
    corr = cov / np.outer(d, d)
    np.fill_diagonal(corr, 1.0)
    return (list(80.0 + 40.0 * rng.random(n)), list(0.1 + 0.3 * rng.random(n)),
            corr.tolist())


def _consts(n, n_steps, q=None, T_=T):
    S0, sig, corr = _assets(n)
    return tm.basket_constants(S0, R, sig, tm.correlation_cholesky(corr), T_, n_steps, q)


# ---- the stream --------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 3, 5, 12])
def test_basket_draws_follow_the_counter_mapping(n):
    """Asset a's normal at step t is normal a % 4 of the call t ceil(n/4) +
    a // 4 on counter (slot, draw, global tile, BASKET_STREAM)."""
    tile, first, n_steps = 64, 3, 3
    z = basket_path_draws(SEED, first, 2, tile, n_steps, n, False)
    zm = basket_path_draws(SEED, first, 2, tile, n_steps, n, True)
    calls = (n + 3) // 4
    slot = torch.tensor([5, 64 + 17], dtype=torch.int64)
    j, g = slot % tile, first + slot // tile
    for t in range(n_steps):
        for a in range(n):
            w = philox4x32(j, t * calls + a // 4, g, BASKET_STREAM, SEED & 0xFFFFFFFF,
                           SEED >> 32)
            u = [uniform_from_bits(x) for x in w]
            q = a % 4
            want = box_muller(u[2 * (q // 2)], u[2 * (q // 2) + 1])[q % 2]
            assert torch.equal(z[t, a, slot], want)
    half = zm.reshape(n_steps, n, 2, 2, tile // 2)
    assert torch.equal(half[:, :, :, 1], -half[:, :, :, 0])
    assert torch.equal(half[:, :, :, 0].reshape(n_steps, n, -1),
                       basket_path_draws(SEED, first, 2, tile // 2, n_steps, n, False))


# ---- the chain, kernels 27-28's plain versions -------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 5, 12])
def test_chain_sums_w_over_ascending_b_bit_for_bit(n):
    c = _consts(n, 6, q=[0.02] * n)
    z = basket_path_draws(SEED, 0, 1, 256, 6, n, True)
    acc, Wt = tm.basket_chain(z, c, "debug")
    zn = z.numpy()
    L, f = c["L"], np.float32
    want_acc = np.zeros((n, zn.shape[2]), f)
    for t in range(6):
        for a in range(n):
            w = L[a, 0] * zn[t, 0]
            for b in range(1, a + 1):
                w = w + L[a, b] * zn[t, b]
            assert w.dtype == f and np.array_equal(Wt[t, a].numpy(), w)
            want_acc[a] = want_acc[a] + (c["drift"][a] + c["vol"][a] * w)
        assert np.array_equal(acc[t + 1].numpy(), want_acc)
    assert not acc[0].any()
    mirrored = Wt.reshape(6, n, 2, 128)
    assert torch.equal(mirrored[:, :, 1], -mirrored[:, :, 0])
    S = tm.basket_chain(z, c, "paths")
    assert torch.equal(S, torch.from_numpy(c["s0"])[None, :, None] * torch.exp(acc))


@pytest.mark.parametrize("anti", [True, False])
@pytest.mark.parametrize("n", [1, 2, 3, 5, 12])
def test_terminal_equals_paths_last_row_and_chunks(n, anti):
    c = _consts(n, 9)
    S = cb.basket_paths(SEED, c, 3 * 256, 9, anti, 0, 256, "cpu")
    S_T = cb.basket_terminal(SEED, c, 3 * 256, 9, anti, 0, 256, "cpu")
    assert S.shape == (10, n, 768) and S_T.shape == (n, 768)
    assert torch.equal(S[-1], S_T)
    assert torch.equal(S[0], torch.from_numpy(c["s0"])[:, None].expand(n, 768))
    chunk = cb.basket_paths(SEED, c, 256, 9, anti, 1, 256, "cpu")
    assert torch.equal(chunk, S[:, :, 256:512])
    assert torch.equal(cb.basket_terminal(SEED, c, 512, 9, anti, 1, 256, "cpu"),
                       S_T[:, 256:])
    assert cb.launches == dict.fromkeys(cb.launches, 0)


def test_simulate_modes_share_the_stream():
    S0, sig, corr = _assets(3)
    cfg = MCConfig(n_paths=5000, n_steps=8)
    S = tm.simulate_gbm_basket(SEED, S0, R, sig, corr, T, cfg, return_paths=True,
                               device="cpu")
    S_T = tm.simulate_gbm_basket(SEED, S0, R, sig, corr, T, cfg, device="cpu")
    assert S.shape == (9, 3, 2 * PATH_TILE) and torch.equal(S[-1], S_T)
    E = tm.gbm_basket_terminal_exact(SEED, S0, R, sig, corr, T, 100, device="cpu")
    assert E.shape == (3, TERMINAL_TILE)
    assert torch.equal(tmodels.simulate_gbm_basket(SEED, S0, R, sig, corr, T, cfg,
                                                   device="cpu"), S_T)


# ---- against the JAX package on its own normals ------------------------------------------

def _jax_normals(key, n, n_steps, n_blocks, block, anti):
    """The reference's (block, step) normals (multiasset.py:79-88) in path
    order: (n_steps, n, n_blocks * block)."""
    out = []
    for b in range(n_blocks):
        bk = jax.random.fold_in(key, b)
        rows = []
        for t in range(n_steps):
            k = jax.random.fold_in(bk, t)
            if anti:
                zh = jax.random.normal(k, (n, block // 2), jnp.float32)
                rows.append(np.asarray(jnp.concatenate([zh, -zh], axis=1)))
            else:
                rows.append(np.asarray(jax.random.normal(k, (n, block), jnp.float32)))
        out.append(np.stack(rows))
    return torch.from_numpy(np.concatenate(out, axis=2))


@pytest.mark.parametrize("paths", [True, False])
@pytest.mark.parametrize("anti", [True, False])
@pytest.mark.parametrize("n,q", [(3, None), (3, [0.01, 0.03, 0.0]), (12, 0.02)])
def test_simulator_on_the_reference_normals(n, q, anti, paths):
    S0, sig, corr = _assets(n)
    key = jax.random.key(11)
    cfg = JMCConfig(n_paths=2048, n_steps=8, path_block=1024, antithetic=anti)
    want = np.asarray(jm.simulate_gbm_basket(key, S0, R, sig, corr, T, cfg, div_yields=q,
                                             return_paths=paths))
    z = _jax_normals(key, n, 8, 2, 1024, anti)
    got = tm.gbm_basket_from_normals(z, S0, R, sig, tm.correlation_cholesky(corr), T,
                                     div_yields=q, return_paths=paths).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("anti", [True, False])
def test_terminal_exact_on_the_reference_normals(anti):
    key = jax.random.key(5)
    want = np.asarray(jm.gbm_basket_terminal_exact(key, S0S, R, SIGS, CORR, T, 4096,
                                                   div_yields=[0.02] * 3, antithetic=anti))
    if anti:
        zh = jax.random.normal(key, (3, 2048), jnp.float32)
        z = np.array(jnp.concatenate([zh, -zh], axis=1))
    else:
        z = np.array(jax.random.normal(key, (3, 4096), jnp.float32))
    got = tm.gbm_basket_from_normals(torch.from_numpy(z)[None], S0S, R, SIGS,
                                     tm.correlation_cholesky(CORR), T,
                                     div_yields=[0.02] * 3).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("n", [2, 3, 12])
def test_correlation_cholesky_is_the_reference_factor(n):
    corr = _assets(n)[2]
    assert np.array_equal(tm.correlation_cholesky(corr).numpy(),
                          np.asarray(jm.correlation_cholesky(corr)))
    assert tm.correlation_cholesky(corr).dtype == torch.float32


@pytest.mark.parametrize("corr,match", [([[1.0, 0.5], [0.4, 1.0]], "symmetric"),
                                        ([[1.0, 2.0], [2.0, 1.0]], "positive definite"),
                                        ([[2.0, 0.0], [0.0, 1.0]], "unit diagonal"),
                                        ([1.0, 0.5], "square")])
def test_correlation_cholesky_raises_the_reference_errors(corr, match):
    with pytest.raises(ValueError, match=match):
        tm.correlation_cholesky(corr)
    with pytest.raises(ValueError, match=match):
        jm.correlation_cholesky(corr)


def test_constants_reject_mismatched_shapes():
    with pytest.raises(ValueError, match="same length"):
        tm.basket_constants([100.0, 90.0], R, [0.2], np.eye(2), T, 4)
    with pytest.raises(ValueError, match="corr dimension"):
        tm.basket_constants([100.0, 90.0], R, [0.2, 0.3], np.eye(3), T, 4)


def test_wrappers_route_and_raise():
    c = _consts(2, 4)
    many = tm.basket_constants([100.0] * 129, R, [0.2] * 129, np.eye(129, dtype=np.float32),
                               T, 4)
    with pytest.raises(ValueError, match="1 to 128 assets"):
        cb.basket_paths(SEED, many, 256, 4, device="cpu")
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py drives the kernels")
    for fn in (cb.basket_paths, cb.basket_terminal):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn(SEED, c, 256, 4, device="cuda")
        with pytest.raises(RuntimeError, match="CUDA"):
            fn(SEED, c, 256, 4)
    with pytest.raises(ValueError, match="CUDA device"):
        cb.basket_launch(SEED, c, 256, 4, True, 0, 256, torch.device("cpu"), "paths")
    with pytest.raises(RuntimeError, match="CUDA"):
        tb.price_basket_mc(_gen(1), S0S, W, 100.0, T, R, SIGS, CORR, n_paths=1 << 10)
    with pytest.raises(RuntimeError, match="CUDA"):
        tab.price_american_basket(_gen(1), [100.0, 100.0], 100.0, 1.0, R, [0.2, 0.2],
                                  np.eye(2), mc=MCConfig(1 << 12, 4))
    assert cb.launches == dict.fromkeys(cb.launches, 0)


# ---- the geometric-basket closed form ----------------------------------------------------

@pytest.mark.parametrize("cp,q,K", [(1.0, None, 100.0), (-1.0, None, 95.0),
                                    (1.0, [0.03, 0.01, 0.0], 110.0), (-1.0, [0.02] * 3, 80.0)])
def test_geometric_closed_form_matches_the_reference(cp, q, K):
    got = tb.geometric_basket_bs_price(S0S, W, K, T, R, SIGS, CORR, cp, q)
    want = jb.geometric_basket_bs_price(S0S, W, K, T, R, SIGS, CORR, cp, q)
    assert abs(got - want) <= 1e-10 * abs(want)


def test_geometric_closed_form_limits():
    """tests/test_basket.py:72-84: one asset and n identical perfectly
    correlated assets are the vanilla."""
    bs = float(bs_price(100.0, 100.0, T, R, 0.2, 1.0, dtype=torch.float64, device="cpu"))
    assert abs(tb.geometric_basket_bs_price([100.0], [1.0], 100.0, T, R, [0.2], [[1.0]])
               - bs) < 2e-5
    assert abs(tb.geometric_basket_bs_price([100.0] * 3, W, 100.0, T, R, [0.2] * 3,
                                            np.ones((3, 3))) - bs) < 2e-5


# ---- the European pricer: the JAX tests' checks at 2^14-2^15 paths ----------------------

def _price(seed, *args, **kw):
    kw.setdefault("device", "cpu")
    p, se = tb.price_basket_mc(_gen(seed), *args, **kw)
    return float(p), float(se)


def test_mc_geometric_hits_closed_form():
    S_T = tm.gbm_basket_terminal_exact(SEED, S0S, R, SIGS, CORR, T, 1 << 15, device="cpu")
    geo = torch.exp(torch.tensordot(torch.tensor(W, dtype=torch.float32), torch.log(S_T),
                                    dims=1))
    cash = torch.clamp_min(geo - 100.0, 0.0) * math.exp(-R * T)
    mean, se, _ = masked_mean_stderr(cash, pair_block=TERMINAL_TILE)
    cf = tb.geometric_basket_bs_price(S0S, W, 100.0, T, R, SIGS, CORR)
    assert abs(float(mean) - cf) < 4.0 * float(se) + 1e-3


def test_cv_matches_plain_and_wins():
    p_cv, se_cv = _price(7, S0S, W, 100.0, T, R, SIGS, CORR, n_paths=1 << 15)
    p_pl, se_pl = _price(7, S0S, W, 100.0, T, R, SIGS, CORR, n_paths=1 << 15,
                         control_variate=False)
    assert abs(p_cv - p_pl) < max(4.0 * math.hypot(se_cv, se_pl), 1e-3)
    assert se_cv * 5.0 < se_pl


def test_put_call_parity():
    c, se_c = _price(7, S0S, W, 100.0, T, R, SIGS, CORR, cp=1.0, n_paths=1 << 15)
    p, se_p = _price(7, S0S, W, 100.0, T, R, SIGS, CORR, cp=-1.0, n_paths=1 << 15)
    rhs = math.exp(-R * T) * (float(np.dot(W, np.asarray(S0S) * math.exp(R * T))) - 100.0)
    assert abs((c - p) - rhs) < max(6.0 * math.hypot(se_c, se_p), 2e-3)


def test_rainbow_ordering():
    kw = dict(n_paths=1 << 14)
    best, _ = _price(7, S0S, W, 100.0, T, R, SIGS, CORR, kind="best_of", **kw)
    worst, _ = _price(7, S0S, W, 100.0, T, R, SIGS, CORR, kind="worst_of", **kw)
    bask, _ = _price(7, S0S, W, 100.0, T, R, SIGS, CORR, **kw)
    assert worst <= bask <= best
    vmax = max(float(bs_price(s, 100.0, T, R, sig, 1.0, device="cpu"))
               for s, sig in zip(S0S, SIGS))
    assert best > vmax - 0.05


def test_spread_degenerate_is_zero():
    p, _ = _price(7, [100.0, 100.0], [0.5, 0.5], 5.0, T, R, [0.2, 0.2],
                  [[1.0, 1.0 - 1e-9], [1.0 - 1e-9, 1.0]], kind="spread", n_paths=1 << 14)
    assert p < 1e-2


def test_div_yield_lowers_forward():
    c_q, _ = _price(7, S0S, W, 100.0, T, R, SIGS, CORR, div_yields=[0.03] * 3, n_paths=1 << 14)
    c_0, _ = _price(7, S0S, W, 100.0, T, R, SIGS, CORR, n_paths=1 << 14)
    assert c_q < c_0


@pytest.mark.parametrize("kind,K,n", [("spread", 5.0, 3), ("butterfly", 100.0, 3)])
def test_bad_kinds_raise(kind, K, n):
    with pytest.raises(ValueError, match="spread requires|kind must"):
        _price(1, S0S[:n], W[:n], K, T, R, SIGS[:n], CORR, kind=kind, n_paths=1 << 10)
    with pytest.raises(ValueError):
        jb.price_basket_mc(jax.random.key(7), S0S[:n], W[:n], K, T, R, SIGS[:n], CORR,
                           kind=kind, n_paths=1 << 10)


def test_stderr_pairs_at_the_terminal_tile():
    """The terminal kernel mirrors within TERMINAL_TILE, so the stderr's
    pair means reduce there. On a near-linear payoff (a deep in-the-money
    basket call, whose mirrors nearly cancel) the reported stderr matches
    the spread of independent seeds' prices, and pairing at the whole
    vector (the reference's pb = n_paths, basket.py:100) pairs paths of two
    tiles that are not mirrors and overstates it several times."""
    n = 2 * TERMINAL_TILE
    prices, ses = [], []
    for seed in range(16):
        p, se = _price(100 + seed, S0S, W, 10.0, T, R, SIGS, CORR, n_paths=n,
                       control_variate=False)
        prices.append(p)
        ses.append(se)
    spread = float(np.std(prices, ddof=1))
    assert 0.5 < spread / float(np.mean(ses)) < 2.0
    S_T = tm.gbm_basket_terminal_exact(SEED, S0S, R, SIGS, CORR, T, n, device="cpu")
    cash = tb._basket_payoff(S_T, W, 10.0, 1.0, "basket") * math.exp(-R * T)
    se_tile = float(masked_mean_stderr(cash, pair_block=TERMINAL_TILE)[1])
    se_whole = float(masked_mean_stderr(cash, pair_block=n)[1])
    assert se_whole > 3.0 * se_tile


# ---- the Bermudan basket LSM -------------------------------------------------------------

def _jax_paths(n_paths=8192, n_steps=9, kind_args=None):
    key = jax.random.key(3)
    cfg = JMCConfig(n_paths=n_paths, n_steps=n_steps, path_block=4096)
    return np.asarray(jm.simulate_gbm_basket(key, [100.0, 95.0, 105.0], 0.05, [0.2, 0.25, 0.3],
                                             CORR, 1.0, cfg, div_yields=[0.05] * 3,
                                             return_paths=True))


CASES = [("max", 1.0, None), ("min", -1.0, None), ("basket", -1.0, W)]


@pytest.mark.parametrize("oos", [False, True])
@pytest.mark.parametrize("kind,cp,w", CASES)
def test_backward_matches_the_reference_in_float64(kind, cp, w, oos):
    S = _jax_paths().astype(np.float64)
    kw = dict(kind=kind, weights=w, out_of_sample=oos, pair_block=4096, stat_pair_block=4096)
    got = tab.lsm_basket_backward(torch.from_numpy(S), 100.0, 0.05, 1.0, cp, **kw)
    with jax.enable_x64(True):
        want = jab.lsm_basket_backward(jnp.asarray(S), 100.0, 0.05, 1.0, cp, **kw)
        want = [float(x) for x in want]
    for g, wv in zip(got, want):
        assert abs(float(g) - wv) <= 1e-9 * abs(wv)


@pytest.mark.parametrize("kind,cp,w", CASES)
def test_backward_matches_the_reference_in_float32(kind, cp, w):
    S = _jax_paths()
    kw = dict(kind=kind, weights=w, stat_pair_block=4096)
    p, se = tab.lsm_basket_backward(torch.from_numpy(S.copy()), 100.0, 0.05, 1.0, cp, **kw)
    pj, sej = jab.lsm_basket_backward(jnp.asarray(S), 100.0, 0.05, 1.0, cp, **kw)
    assert abs(float(p) - float(pj)) <= BASKET_F32_RTOL * float(pj)
    assert abs(float(se) - float(sej)) <= 1e-3 * float(sej)


@pytest.mark.parametrize("kind,cp,w", CASES)
def test_basis_matches_the_reference(kind, cp, w):
    S = _jax_paths(4096, 3).astype(np.float64)[1]
    wj = None if w is None else np.asarray(w)
    imm = np.asarray(jab._payoff_t(jnp.asarray(S), 100.0, cp, kind, wj))
    itm = (imm > 0).astype(np.float64)
    with jax.enable_x64(True):
        want = np.asarray(jab.build_basket_basis(jnp.asarray(S), 100.0, jnp.asarray(itm),
                                                 lambda v: v, kind, wj, cp))
    got = tab.build_basket_basis(torch.from_numpy(S), 100.0, torch.from_numpy(itm), kind,
                                 None if w is None else torch.tensor(w, dtype=torch.float64),
                                 cp).numpy()
    assert got.shape == want.shape == (4096, 1 + 3 + 3 + 3 + 1)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_backward_refuses_tf32_and_bad_args():
    S = torch.ones(3, 2, 8)
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="tf32"):
            tab.lsm_basket_backward(S, 100.0, 0.05, 1.0, 1.0)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    with pytest.raises(ValueError, match="requires weights"):
        tab.lsm_basket_backward(S, 100.0, 0.05, 1.0, 1.0, kind="basket")
    with pytest.raises(ValueError, match="requires pair_block"):
        tab.lsm_basket_backward(S, 100.0, 0.05, 1.0, 1.0, out_of_sample=True)


MC9 = MCConfig(n_paths=1 << 15, n_steps=9, path_block=4096)


def _american(seed, S0s, *args, **kw):
    kw.setdefault("device", "cpu")
    p, se = tpricers.price_american_basket(_gen(seed), S0s, *args, **kw)
    return float(p), float(se)


@pytest.mark.parametrize("s0", [90.0, 100.0, 110.0])
def test_andersen_broadie_table(s0):
    """tests/test_basket_american.py:20-28 at half its paths: in-sample LSM
    within 1% of the benchmark, plus 2 stderr for the smaller sample."""
    p, se = _american(3, [s0, s0], 100.0, 3.0, 0.05, [0.2, 0.2], np.eye(2), 1.0, MC9,
                      kind="max", div_yields=[0.10, 0.10])
    ref = AB_TRUE[s0]
    assert abs(p - ref) < 0.01 * ref + 2.0 * se, (p, se, ref)


def test_oos_low_biased_estimator():
    kw = dict(mc=MC9, kind="max", div_yields=[0.10, 0.10])
    p_in, _ = _american(3, [100.0, 100.0], 100.0, 3.0, 0.05, [0.2, 0.2], np.eye(2), 1.0, **kw)
    p_oos, se_oos = _american(3, [100.0, 100.0], 100.0, 3.0, 0.05, [0.2, 0.2], np.eye(2), 1.0,
                              out_of_sample=True, **kw)
    assert p_oos < p_in + 3.0 * se_oos
    assert abs(p_oos - AB_TRUE[100.0]) / AB_TRUE[100.0] < 0.015 + 2.0 * se_oos / 13.902


def test_no_dividend_max_call_is_european():
    corr = [[1.0, 0.3], [0.3, 1.0]]
    p_am, se_am = _american(3, [100.0, 100.0], 100.0, 1.0, 0.05, [0.2, 0.25], corr, 1.0,
                            MCConfig(n_paths=1 << 14, n_steps=12), kind="max")
    p_eu, se_eu = _price(4, [100.0, 100.0], [0.5, 0.5], 100.0, 1.0, 0.05, [0.2, 0.25], corr,
                         kind="best_of", n_paths=1 << 15)
    assert abs(p_am - p_eu) < max(5.0 * math.hypot(se_am, se_eu), 0.003 * p_eu)


def test_basket_put_dominates_european():
    corr, w = [[1.0, 0.5], [0.5, 1.0]], [0.5, 0.5]
    p_am, _ = _american(3, [100.0, 100.0], 105.0, 1.0, 0.08, [0.25, 0.3], corr, -1.0,
                        MCConfig(n_paths=1 << 14, n_steps=16), kind="basket", weights=w)
    p_eu, se_eu = _price(5, [100.0, 100.0], w, 105.0, 1.0, 0.08, [0.25, 0.3], corr, cp=-1.0,
                         n_paths=1 << 15)
    assert p_am > p_eu + 3.0 * se_eu


def test_min_put_dominates_basket_put():
    corr = [[1.0, 0.5], [0.5, 1.0]]
    kw = dict(mc=MCConfig(n_paths=1 << 14, n_steps=8))
    p_min, _ = _american(3, [100.0, 100.0], 100.0, 1.0, 0.05, [0.2, 0.3], corr, -1.0,
                         kind="min", **kw)
    p_b, _ = _american(3, [100.0, 100.0], 100.0, 1.0, 0.05, [0.2, 0.3], corr, -1.0,
                       kind="basket", weights=[0.5, 0.5], **kw)
    assert p_min >= p_b - 1e-3


@pytest.mark.parametrize("kw", [dict(kind="rainbow"), dict(kind="basket")])
def test_american_bad_args(kw):
    with pytest.raises(ValueError):
        _american(3, [100.0, 100.0], 100.0, 1.0, 0.05, [0.2, 0.2], np.eye(2), **kw)
