"""The routes of kernels 27-28 from 9 assets (options_model_tpu_torch/csrc/
basket.cu register instances up to 16 assets, csrc/basket.cuh
basket_wide_kernel from 17 to 128) on the CPU: what can be held here
without the card.

- The wide route's host packing of L in row blocks (cuda_basket.
  pack_row_blocks, wide_constants) round-trips, its thread groups own
  every row block once with balanced products (wide_groups), and the
  routes and their launch counters are chosen by the assets (129 raise).
- A float32 emulation of the wide kernel's correlate, in its order (row
  blocks of WIDE_ROWS, columns in chunks of four read from the packed L,
  a row's first column a product alone, the diagonal's uniform predicate
  and no product past it), equals models/multiasset.basket_chain bit for
  bit in W and the log-states: the kernel's order keeps the bits.
- At 50 assets, the port's chain on the JAX package's own normals against
  its gbm_basket_terminal_exact and simulate_gbm_basket (rtol 1e-5: XLA's
  L @ z sums in its own order and contracts into FMAs, and S0 exp(acc)
  against exp(log S0 + acc) rounds once more).
- At 12 assets, the Bermudan basket LSM backward on the JAX package's
  paths against its own, in float64 (1e-9 relative). The JAX backward's
  small SPD solve (regressors.solve_spd_small, a Cholesky unrolled in
  Python) does not compile in a test's time at the basis's 92 columns on
  the CPU (over 190 s; 50 s a date with jit off), so the test hands it
  jnp.linalg.solve for that one call: its basis, Gram, ridge, exercise
  rule and statistics are the package's own.
- The 12- and 50-asset baskets that chip_smoke.py prices on the card (B3,
  B4) at 2^16 and 2^15 paths: the geometric leg within the JAX tests' 4
  stderr + 1e-3 of geometric_basket_bs_price in both packages.
- The Bermudan backward's regressions: float32 paths of up to 16 assets
  (american_basket.FLOAT32_GRAM_ASSETS) regress in float32, of more in
  float64, bit for bit the backward on the paths cast to float64, its
  price in float32; B4's 50-asset put at 4,096 paths x 2 dates exercises
  (in-sample above its European on its own paths + 3 stderr).

On the card, chip_smoke.py's X0 holds every route to the plain version bit
for bit and B3-B4 price through them.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from options_model_tpu.core.config import MCConfig as JMCConfig
from options_model_tpu.core.stats import masked_mean_stderr as jmasked_mean_stderr
from options_model_tpu.models import multiasset as jm
from options_model_tpu.pricers import american_basket as jab
from options_model_tpu.pricers import basket as jb
from options_model_tpu.pricers import regressors as jreg
from options_model_tpu_torch.core.config import MCConfig
from options_model_tpu_torch.core.stats import masked_mean_stderr
from options_model_tpu_torch.models import multiasset as tm
from options_model_tpu_torch.ops import cuda_basket as cb
from options_model_tpu_torch.ops.cuda_heston import TERMINAL_TILE
from options_model_tpu_torch.ops.philox import basket_path_draws, seed_from_generator
from options_model_tpu_torch.pricers.american import simulated_config
from options_model_tpu_torch.pricers import american_basket as tab
from options_model_tpu_torch.pricers import basket as tb
from _torch_threads import one_torch_thread_module  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread_module")

SEED = 0x5DEECE66D
R, T = 0.05, 0.5
ROWS = cb.WIDE_ROWS


def _assets(n, seed=7):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n + 2))
    cov = A @ A.T
    d = np.sqrt(np.diag(cov))
    corr = cov / np.outer(d, d)
    np.fill_diagonal(corr, 1.0)
    return list(80.0 + 40.0 * rng.random(n)), list(0.1 + 0.3 * rng.random(n)), corr


def _consts(n, n_steps):
    S0, sig, corr = _assets(n)
    return tm.basket_constants(S0, R, sig, tm.correlation_cholesky(corr), T, n_steps,
                               [0.02] * n)


def _equicorrelated(n, rho=0.4):
    return np.full((n, n), rho) + (1.0 - rho) * np.eye(n)


# B3 and B4 (chip_smoke.py): equal weights, S0 = K = 100, pairwise rho 0.4,
# q 2%, r 5%, T 1; sigma_i = 0.15 + 0.01 i (12 assets), 0.15 + 0.003 i (50).
BASKETS = {"B3": (12, 0.01, 1 << 16), "B4": (50, 0.003, 1 << 15)}


def _basket(name):
    n, step, n_paths = BASKETS[name]
    return n, [100.0] * n, [1.0 / n] * n, [0.15 + step * i for i in range(n)], n_paths


# ---- the routes and the host packing -----------------------------------------------------

@pytest.mark.parametrize("n", [17, 33, 50, 128])
def test_row_blocks_round_trip(n):
    L = np.tril(np.random.default_rng(n).standard_normal((n, n))).astype(np.float32)
    packed = cb.pack_row_blocks(L)
    nb = -(-n // ROWS)
    assert packed.dtype == np.float32 and packed.size == ROWS * ROWS * nb * (nb + 1) // 2
    assert np.array_equal(cb.unpack_row_blocks(packed, n), L)
    # block rb, column b: the R coefficients of rows rb R .. rb R + R - 1 contiguous
    at = 0
    for rb in range(nb):
        for b in range((rb + 1) * ROWS):
            for r in range(ROWS):
                a = rb * ROWS + r
                want = L[a, b] if a < n and b <= a else 0.0
                assert packed[at + b * ROWS + r] == want
        at += (rb + 1) * ROWS * ROWS
    with pytest.raises(ValueError, match="packed floats"):
        cb.unpack_row_blocks(packed[:-1], n)


@pytest.mark.parametrize("n", [17, 50, 128])
def test_wide_constants_layout(n):
    c = _consts(n, 3)
    w = cb.wide_constants(c)
    nr = -(-n // ROWS) * ROWS
    rows = w[:4 * nr].reshape(nr, 4)
    assert np.array_equal(rows[:n, 0], c["s0"]) and np.array_equal(rows[:n, 1], c["drift"])
    assert np.array_equal(rows[:n, 2], c["vol"]) and not rows[n:].any() and not rows[:, 3].any()
    assert np.array_equal(cb.unpack_row_blocks(w[4 * nr:], n), c["L"])
    assert w.size % 4 == 0   # whole float4s (csrc/basket.cuh wide_consts4)


def test_routes_by_assets():
    assert [cb.route(n) for n in (1, 8, 9, 16, 17, 128)] == ["1_8", "1_8", "9_16", "9_16",
                                                              "17_128", "17_128"]
    assert cb.REGISTER_ASSETS == 16 and cb.MAX_ASSETS == 128
    assert [cb.terminal_slots(n) for n in (1, 3, 4, 8, 9, 16)] == [4, 4, 2, 2, 1, 1]
    for n in (0, 129):
        with pytest.raises(ValueError, match="1 to 128 assets"):
            cb.route(n)
    assert [cb._counter(m, n) for m, n in (("paths", 5), ("paths", 12), ("paths", 50),
                                           ("terminal", 8), ("terminal", 9),
                                           ("terminal", 128), ("terminal_first", 8),
                                           ("generic_paths", 3), ("generic_terminal", 64))] == [
        "basket_paths", "basket_paths_9_16", "basket_paths_17_128", "basket_terminal",
        "basket_terminal_9_16", "basket_terminal_17_128", "basket_terminal_first",
        "basket_generic_first", "basket_generic_first"]
    assert set(cb._counter(m, n) for m in ("paths", "terminal", "terminal_first",
                                            "generic_paths") for n in (1, 12, 50)) \
        == set(cb.launches)


@pytest.mark.parametrize("n", [17, 24, 33, 50, 64, 100, 128])
def test_wide_groups_own_every_block_once(n):
    groups = cb.wide_groups(n)
    nb = -(-n // ROWS)
    assert len(groups) == (nb + 1) // 2 and len(groups) * 32 <= 512 // 2   # 256-thread blocks fit
    owned = sorted(rb for g in groups for rb in g)
    assert owned == list(range(nb))
    # a block rb takes (rb + 1) R^2 products (its padding rows included): every
    # group of two blocks the same, a lone middle block about half
    work = [sum((rb + 1) * ROWS * ROWS for rb in g) for g in groups]
    pairs = [w for g, w in zip(groups, work) if len(g) == 2]
    assert len(set(pairs)) == 1 and pairs[0] == (nb + 1) * ROWS * ROWS
    assert all(2 * w <= pairs[0] + ROWS * ROWS for g, w in zip(groups, work) if len(g) == 1)


def test_129_assets_raise():
    c = _consts(129, 1)
    for fn in (cb.basket_paths, cb.basket_terminal, cb.basket_generic_first):
        with pytest.raises(ValueError, match="1 to 128 assets"):
            fn(SEED, c, 256, 1, True, 0, 256, "cpu")
    assert cb.launches == dict.fromkeys(cb.launches, 0)


@pytest.mark.parametrize("n", [9, 17])
@pytest.mark.parametrize("paths", [True, False])
def test_generic_first_on_the_cpu_is_the_plain_version(n, paths):
    c = _consts(n, 3)
    want = (cb.basket_paths_reference if paths else cb.basket_terminal_reference)(
        SEED, c, 512, 3, True, 1, 256, "cpu")
    assert torch.equal(cb.basket_generic_first(SEED, c, 512, 3, True, 1, 256, "cpu",
                                               paths=paths), want)
    assert torch.equal((cb.basket_paths if paths else cb.basket_terminal)(
        SEED, c, 512, 3, True, 1, 256, "cpu"), want)
    assert cb.launches == dict.fromkeys(cb.launches, 0)


def test_generic_first_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py drives the generic instance")
    c = _consts(20, 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        cb.basket_generic_first(SEED, c, 256, 1, True, 0, 256, "cuda")
    with pytest.raises(ValueError, match="CUDA device"):
        cb.basket_launch(SEED, c, 256, 1, True, 0, 256, torch.device("cpu"), "generic_paths")
    assert cb.launches == dict.fromkeys(cb.launches, 0)


# ---- the wide kernel's order, emulated in float32 ----------------------------------------

def _wide_step(z, rows, Lp, n, acc, accm, anti):
    """One step of csrc/basket.cuh basket_wide_kernel on z (n, P) float32:
    W of every row, and acc / accm after the step, in the kernel's order."""
    nr = rows.shape[0]
    nb = nr // ROWS
    zpad = np.zeros((-(-n // 4) * 4, z.shape[1]), np.float32)
    zpad[:n] = z
    W_all = np.zeros((nr, z.shape[1]), np.float32)

    def chunk(W, Lb, b0, d0, first):
        # wide_chunk<R, kD0, kFirst>: columns b0 .. b0 + 3, each read as a float4
        for i in range(4):
            c = Lb[(b0 + i) * ROWS:(b0 + i + 1) * ROWS]
            for r in range(ROWS):
                if d0 >= 0 and r < d0 + i:
                    continue            # past the row's diagonal: no product
                p = c[r] * zpad[b0 + i]
                W[r] = p if (first and i == 0) else W[r] + p

    def diagonal(W, Lb, start, first):
        for q in range(ROWS // 4):
            if start + 4 * q >= n:
                break
            chunk(W, Lb, start + 4 * q, 4 * q, first and q == 0)

    at = 0
    for rb in range(nb):
        start = rb * ROWS
        Lb = Lp[at:at + (rb + 1) * ROWS * ROWS]
        at += (rb + 1) * ROWS * ROWS
        W = [None] * ROWS
        if rb == 0:
            diagonal(W, Lb, 0, True)
        else:
            chunk(W, Lb, 0, -1, True)
            for b0 in range(4, start, 4):
                chunk(W, Lb, b0, -1, False)
            diagonal(W, Lb, start, False)
        for r in range(ROWS):
            a = start + r
            if a >= n:
                continue
            W_all[a] = W[r]
            acc[a] = acc[a] + (rows[a, 1] + rows[a, 2] * W[r])
            if anti:
                accm[a] = accm[a] + (rows[a, 1] + rows[a, 2] * -W[r])
    return W_all[:n]


@pytest.mark.parametrize("anti", [True, False])
@pytest.mark.parametrize("n", [17, 33, 50])
def test_row_blocked_order_is_the_chain_bit_for_bit(n, anti):
    c = _consts(n, 3)
    tile = 256
    z = basket_path_draws(SEED, 0, 1, tile, 3, n, anti).numpy()
    acc_r, W_r = tm.basket_chain(torch.from_numpy(z), c, "debug")
    w = cb.wide_constants(c)
    nr = -(-n // ROWS) * ROWS
    rows, Lp = w[:4 * nr].reshape(nr, 4), w[4 * nr:]
    width = tile // 2 if anti else tile
    zs = z[:, :, :width]           # the slots; the mirrors are their negatives
    acc = np.zeros((n, width), np.float32)
    accm = np.zeros((n, width), np.float32)
    for t in range(3):
        W = _wide_step(zs[t], rows, Lp, n, acc, accm, anti)
        assert np.array_equal(W, W_r[t, :, :width].numpy())
        assert np.array_equal(acc, acc_r[t + 1, :, :width].numpy())
        if anti:
            assert np.array_equal(-W, W_r[t, :, width:].numpy())
            assert np.array_equal(accm, acc_r[t + 1, :, width:].numpy())


# ---- against the JAX package at 50 and 12 assets ----------------------------------------

@pytest.mark.parametrize("anti", [True, False])
def test_fifty_assets_on_the_reference_normals(anti):
    n = 50
    S0, sig, corr = _assets(n)
    q = [0.02] * n
    key = jax.random.key(13)
    want = np.asarray(jm.gbm_basket_terminal_exact(key, S0, R, sig, corr, T, 2048,
                                                   div_yields=q, antithetic=anti))
    if anti:
        zh = jax.random.normal(key, (n, 1024), jnp.float32)
        z = np.array(jnp.concatenate([zh, -zh], axis=1))
    else:
        z = np.array(jax.random.normal(key, (n, 2048), jnp.float32))
    L = tm.correlation_cholesky(corr)
    got = tm.gbm_basket_from_normals(torch.from_numpy(z)[None], S0, R, sig, L, T,
                                     div_yields=q).numpy()
    assert got.shape == want.shape == (n, 2048)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    # the path simulator: 4 steps on one block of 1024 (multiasset.py:79-88)
    cfg = JMCConfig(n_paths=1024, n_steps=4, path_block=1024, antithetic=anti)
    want = np.asarray(jm.simulate_gbm_basket(key, S0, R, sig, corr, T, cfg, div_yields=q,
                                             return_paths=True))
    bk = jax.random.fold_in(key, 0)
    rows = []
    for t in range(4):
        k = jax.random.fold_in(bk, t)
        if anti:
            zh = jax.random.normal(k, (n, 512), jnp.float32)
            rows.append(np.asarray(jnp.concatenate([zh, -zh], axis=1)))
        else:
            rows.append(np.asarray(jax.random.normal(k, (n, 1024), jnp.float32)))
    got = tm.gbm_basket_from_normals(torch.from_numpy(np.stack(rows)), S0, R, sig, L, T,
                                     div_yields=q, return_paths=True).numpy()
    assert got.shape == want.shape == (5, n, 1024)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_twelve_asset_backward_matches_the_reference_in_float64(monkeypatch):
    monkeypatch.setattr(jreg, "solve_spd_small", lambda A, b, refine=1: jnp.linalg.solve(A, b))
    n, S0, w, sig, _ = _basket("B3")
    cfg = JMCConfig(n_paths=8192, n_steps=6, path_block=4096)
    S = np.asarray(jm.simulate_gbm_basket(jax.random.key(3), S0, R, sig, _equicorrelated(n),
                                          1.0, cfg, div_yields=[0.02] * n,
                                          return_paths=True)).astype(np.float64)
    kw = dict(kind="basket", weights=w, pair_block=4096, stat_pair_block=4096)
    for oos in (False, True):
        got = tab.lsm_basket_backward(torch.from_numpy(S), 105.0, R, 1.0, -1.0,
                                      out_of_sample=oos, **kw)
        with jax.enable_x64(True):
            want = jab.lsm_basket_backward(jnp.asarray(S), 105.0, R, 1.0, -1.0,
                                           out_of_sample=oos, **kw)
            want = [float(x) for x in want]
        for g, wv in zip(got, want):
            assert abs(float(g) - wv) <= 1e-9 * abs(wv)


@pytest.mark.parametrize("name", sorted(BASKETS))
def test_geometric_leg_hits_the_closed_form_in_both_packages(name):
    n, S0, w, sig, n_paths = _basket(name)
    corr = _equicorrelated(n)
    q = [0.02] * n
    cf = tb.geometric_basket_bs_price(S0, w, 100.0, 1.0, R, sig, corr, div_yields=q)
    assert abs(cf - jb.geometric_basket_bs_price(S0, w, 100.0, 1.0, R, sig, corr,
                                                 div_yields=q)) <= 1e-10 * cf
    disc = math.exp(-R)
    S_T = tm.gbm_basket_terminal_exact(SEED, S0, R, sig, corr, 1.0, n_paths, div_yields=q,
                                       device="cpu")
    geo = torch.exp(torch.tensordot(torch.tensor(w, dtype=torch.float32), torch.log(S_T),
                                    dims=1))
    mean, se, _ = masked_mean_stderr(torch.clamp_min(geo - 100.0, 0.0) * disc,
                                     pair_block=TERMINAL_TILE)
    assert abs(float(mean) - cf) < 4.0 * float(se) + 1e-3
    S_j = jm.gbm_basket_terminal_exact(jax.random.key(5), S0, R, sig, corr, 1.0, n_paths,
                                       div_yields=q)
    geo_j = jnp.exp(jnp.tensordot(jnp.asarray(w, jnp.float32), jnp.log(S_j), axes=1))
    mean_j, se_j, _ = jmasked_mean_stderr(jnp.maximum(geo_j - 100.0, 0.0) * disc,
                                          pair_block=n_paths)
    assert abs(float(mean_j) - cf) < 4.0 * float(se_j) + 1e-3


def _wide_put_paths(n, n_paths, n_steps, seed=SEED):
    """B3/B4's law at n assets (sigma step 0.003 above 16): the float32
    paths price_american_basket simulates on the CPU (seed, MCConfig with
    2,048-path blocks), the weights, sigmas, correlation and config, and
    the European put at K 105 on those paths."""
    sig = [0.15 + (0.01 if n <= 16 else 0.003) * i for i in range(n)]
    corr = _equicorrelated(n)
    mc = MCConfig(n_paths=n_paths, n_steps=n_steps, path_block=2048)
    S = tm.simulate_gbm_basket(seed, [100.0] * n, R, sig, corr, 1.0, simulated_config(mc, "gbm"),
                               div_yields=[0.02] * n, return_paths=True, device="cpu")
    w = [1.0 / n] * n
    basket = torch.tensordot(torch.tensor(w, dtype=torch.float64), S[-1].double(), dims=1)
    european = float(torch.clamp_min(105.0 - basket, 0.0).mean()) * math.exp(-R)
    return S, w, sig, corr, mc, european


@pytest.mark.parametrize("oos", [False, True])
@pytest.mark.parametrize("n", [16, 17])
def test_float32_paths_regress_in_float64_above_16_assets(n, oos):
    S, w, _, _, _, _ = _wide_put_paths(n, 1024, 3)
    assert S.dtype == torch.float32 and tab.FLOAT32_GRAM_ASSETS == 16
    kw = dict(kind="basket", weights=w, out_of_sample=oos, pair_block=512, stat_pair_block=512)
    got = tab.lsm_basket_backward(S, 105.0, R, 1.0, -1.0, **kw)
    wide = n > tab.FLOAT32_GRAM_ASSETS
    want = tab.lsm_basket_backward(S.double() if wide else S, 105.0, R, 1.0, -1.0, **kw)
    forced = tab.lsm_basket_backward(S, 105.0, R, 1.0, -1.0,
                                     gram_dtype=torch.float64 if wide else torch.float32, **kw)
    for g, wv, f in zip(got, want, forced):
        assert g.dtype == torch.float32 and f.dtype == torch.float32
        assert torch.equal(g, wv.to(torch.float32)) and torch.equal(g, f)


def test_fifty_asset_bermudan_exercises():
    n = 50
    seed = seed_from_generator(torch.Generator().manual_seed(3))
    _, w, sig, corr, mc, european = _wide_put_paths(n, 4096, 2, seed)
    price, se = tab.price_american_basket(torch.Generator().manual_seed(3), [100.0] * n, 105.0,
                                          1.0, R, sig, corr, -1.0, mc, kind="basket", weights=w,
                                          div_yields=[0.02] * n, device="cpu")
    assert price.dtype == torch.float32 and float(se) > 0.0
    assert float(price) > european + 3.0 * float(se)
