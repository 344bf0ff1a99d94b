"""The maturity-batched Merton paths route and the redesigned paths kernels'
host-side rules (ops/cuda_jumps.merton_paths_batched, models/merton.
simulate_merton_maturities, the Merton branch of pricers/surface_american)
on the CPU, where every wrapper is its plain version.

- The batched plain version is the single-maturity plain versions stacked,
  maturity m at first_tile + m n_tiles, bit for bit (S and the counts);
  merton_paths is the batched route at one maturity.
- price_american_surface under Merton (one batched simulation per group of
  maturities) equals, bit for bit, the per-maturity loop it replaced
  (simulate_seeded at i n_tiles, then lsm_surface_backward), whatever the
  grouping; and it agrees in law with the JAX package's Merton surface
  within 4 pooled stderr (the two packages draw different streams).
- The constants rows: each maturity's row is its single-launch row, and
  slots 6 and 7 hold the head (F(0), F(1)) of that row's own table, which
  the redesigned paths kernels (csrc/jumps.cu merton_paths_kernel,
  overlay_paths_kernel) compare against; a float32 mirror of their count
  (0 or 1 by one comparison, a scan past F(1), sqrt N = N for N <= 1 and
  IEEE's root past it) is the plain count bit for bit.
- The overlay kernel's skipped Box-Muller: with N = 0 the jump term is +-0,
  and y + (jump + a) is y + a bit for bit, for both signs of z_j and mu_j.
- The first designs of kernels 14 and 16 run on a card only.
The kernels themselves are held against these plain versions on the card
by chip_smoke.py (J0).
"""

import math

import jax
import numpy as np
import pytest
import torch

from options_model_tpu.core.config import MCConfig as JMCConfig
from options_model_tpu.core.config import MertonParams as JMertonParams
from options_model_tpu.pricers import surface_american as jsurface
from options_model_tpu_torch.core.config import MCConfig, MertonParams
from options_model_tpu_torch.models import merton
from options_model_tpu_torch.models.bates import overlay_constants
from options_model_tpu_torch.models.merton import jump_sum, merton_constants
from options_model_tpu_torch.ops import cuda_jumps
from options_model_tpu_torch.ops.cuda_heston import PATH_TILE
from options_model_tpu_torch.ops.philox import (merton_path_draws, poisson_from_uniform,
                                                poisson_table, seed_from_generator)
from options_model_tpu_torch.pricers import surface_american
from options_model_tpu_torch.pricers.american import _pair_block, simulate_seeded
from options_model_tpu_torch.pricers.surface_american import (_pair_stderr,
                                                              lsm_surface_backward,
                                                              price_american_surface)
from _torch_threads import one_torch_thread_module  # noqa: F401

MERTON = dict(sigma=0.2, lam=1.0, mu_j=-0.10, sigma_j=0.15)
MP = MertonParams(**MERTON)
HEAVY = MertonParams(**dict(MERTON, lam=100.0))
TS = np.array([0.1, 0.4, 0.7, 1.0], np.float32)
STRIKES = np.linspace(85.0, 115.0, 5).astype(np.float32)
SEED = 0x9E3779B97F4A7C15


# Small tensors: torch's intra-op threads only add overhead, and several test
# workers share the machine.
# (tests/_torch_threads.py)
pytestmark = pytest.mark.usefixtures("one_torch_thread_module")


# ---- the batched plain version ------------------------------------------------------

@pytest.mark.parametrize("first_tile", [0, 3])
@pytest.mark.parametrize("antithetic", [True, False])
def test_batched_plain_version_stacks_single_maturities(antithetic, first_tile):
    n_paths, n_steps = 5000, 5          # 2 tiles of 4096; an odd step count
    S, n = cuda_jumps.merton_paths_batched(SEED, 100.0, 0.05, TS[:3], MP, n_paths, n_steps,
                                           antithetic, first_tile, "cpu", return_counts=True)
    assert S.shape == (3, n_steps + 1, 2 * PATH_TILE)
    assert n.shape == (3, n_steps, 2 * PATH_TILE)
    assert n.dtype == torch.int32
    for m, T in enumerate(TS[:3].tolist()):
        S1, n1 = cuda_jumps.merton_paths_reference(SEED, 100.0, 0.05, T, MP, n_paths, n_steps,
                                                   antithetic, first_tile + 2 * m, "cpu",
                                                   return_counts=True)
        assert torch.equal(S[m], S1) and torch.equal(n[m], n1)
    assert not torch.equal(S[0, -1], S[1, -1])


def test_merton_paths_is_the_batched_route_at_one_maturity():
    args = (SEED, 100.0, 0.05, 0.5, MP, 4096, 6, False, 2, "cpu")
    S, n = cuda_jumps.merton_paths(*args, return_counts=True)
    S_b, n_b = cuda_jumps.merton_paths_batched(SEED, 100.0, 0.05, [0.5], MP, 4096, 6, False,
                                               2, "cpu", return_counts=True)
    S_r, n_r = cuda_jumps.merton_paths_reference(*args, return_counts=True)
    assert S.shape == (7, 4096)
    assert torch.equal(S, S_b[0]) and torch.equal(n, n_b[0])
    assert torch.equal(S, S_r) and torch.equal(n, n_r)
    assert torch.equal(cuda_jumps.merton_paths(*args), S)


def test_simulate_merton_maturities_is_simulate_merton_on_its_tiles():
    mc = MCConfig(n_paths=8192, n_steps=4)
    S = merton.simulate_merton_maturities(7, 100.0, 0.05, TS, MP, mc, first_tile=1,
                                          device="cpu")
    assert S.shape == (4, 5, 8192)
    for m, T in enumerate(TS.tolist()):
        one = merton.simulate_merton(7, 100.0, 0.05, T, MP, mc, first_tile=1 + 2 * m,
                                     device="cpu")
        assert torch.equal(S[m], one)


def test_simulate_merton_maturities_refuses_a_gradient():
    sigma = torch.tensor(0.2, requires_grad=True)
    with pytest.raises(NotImplementedError, match="maturity-batched Merton"):
        merton.simulate_merton_maturities(1, 100.0, 0.05, TS,
                                          MertonParams(sigma, 1.0, -0.1, 0.15),
                                          MCConfig(n_paths=4096, n_steps=2), device="cpu")


# ---- the Merton surface ---------------------------------------------------------------

def test_merton_surface_equals_the_per_maturity_loop():
    """4 maturities x 5 strikes at 2 tiles, with stderr: the grouped route
    against simulate_seeded + lsm_surface_backward one maturity at a time."""
    mc = MCConfig(n_paths=8192, n_steps=8, path_block=4096)
    P, SE = price_american_surface(torch.Generator().manual_seed(5), 100.0, STRIKES, TS, 0.05,
                                   mc, model="merton", merton=MP, return_stderr=True,
                                   device="cpu")
    seed = seed_from_generator(torch.Generator().manual_seed(5))
    pb = _pair_block(mc, "merton")
    rows, errs = [], []
    for i, T in enumerate(TS.tolist()):
        S = simulate_seeded(seed, 2 * i, 100.0, T, mc, "merton", drift=0.05, merton=MP,
                            device="cpu")
        cash = lsm_surface_backward(S, torch.as_tensor(STRIKES), 0.05, T, -1.0,
                                    return_cash=True)
        rows.append(cash.mean(dim=1))
        errs.append(_pair_stderr(cash, pb))
    assert P.shape == SE.shape == (4, 5)
    assert torch.equal(P, torch.stack(rows)) and torch.equal(SE, torch.stack(errs))


def test_merton_surface_does_not_depend_on_the_grouping(monkeypatch):
    """With one launch per two maturities the surface is the same bits as
    with all four in one launch, and the route simulates twice."""
    mc = MCConfig(n_paths=4096, n_steps=6, path_block=4096)

    def surface():
        return price_american_surface(torch.Generator().manual_seed(8), 100.0, STRIKES, TS,
                                      0.05, mc, model="merton", merton=MP, device="cpu")

    calls = []

    def counted(*args, **kwargs):
        calls.append(len(args[3]))
        return merton.simulate_merton_maturities(*args, **kwargs)

    monkeypatch.setattr(surface_american, "simulate_merton_maturities", counted)
    one_group = surface()
    monkeypatch.setattr(surface_american, "BATCH_ENTRIES", 2 * 4096 * (6 + 1))
    assert torch.equal(surface(), one_group)
    assert calls == [4, 2, 2]


def test_merton_surface_needs_its_parameters():
    with pytest.raises(ValueError, match="merton params"):
        price_american_surface(torch.Generator().manual_seed(1), 100.0, STRIKES, TS, 0.05,
                               MCConfig(n_paths=4096, n_steps=2), model="merton", device="cpu")


def test_merton_surface_matches_jax_in_law():
    """The 4 x 4 Merton surface at 2^13 paths x 16 steps in both packages:
    every cell within 4 pooled stderr (the port's stderr over antithetic
    pair means; the JAX package's taken equal to it, the same estimator at
    the same size), the two streams being independent (tiles of one seed
    against fold_in keys)."""
    Ts = np.array([0.25, 0.5, 0.75, 1.0], np.float32)
    Ks = np.array([90.0, 97.5, 105.0, 112.5], np.float32)
    mc = MCConfig(n_paths=1 << 13, n_steps=16, path_block=4096)
    P, SE = price_american_surface(torch.Generator().manual_seed(3), 100.0, Ks, Ts, 0.05, mc,
                                   model="merton", merton=MP, return_stderr=True,
                                   device="cpu")
    P_j = np.asarray(jsurface.price_american_surface(
        jax.random.key(3), 100.0, Ks, Ts, 0.05,
        JMCConfig(n_paths=1 << 13, n_steps=16, path_block=4096), model="merton",
        merton=JMertonParams(**MERTON)))
    P, SE = P.double().numpy(), SE.double().numpy()
    assert P_j.shape == P.shape == (4, 4) and np.all(np.isfinite(P_j)) and np.all(SE > 0)
    z = (P - P_j) / (math.sqrt(2.0) * SE)
    assert np.all(np.abs(z) < 4.0), z


# ---- the constants rows and the redesigned kernels' count -------------------------

def test_batched_rows_carry_each_maturitys_own_row_and_head():
    """merton_rows: row m is maturity m's single-launch row bit for bit, and
    its slots 6 and 7 (the paths kernels' head) are poisson_head of its own
    table, which differs across the surface's maturities (lam dt from 0.002
    to 0.02 at lam = 1): one row's head for all would miscount."""
    Ts = np.concatenate([np.linspace(0.1, 1.0, 64), [0.004, 2.5]]).astype(np.float32)
    rows = cuda_jumps.merton_rows(100.0, 0.05, Ts, MP, 50)
    assert rows.dtype == np.float32 and rows.shape == (Ts.size, cuda_jumps.ROW)
    H, P = cuda_jumps.HEAD, cuda_jumps.POISSON_HEAD
    for row, T in zip(rows, Ts.tolist()):
        np.testing.assert_array_equal(row, cuda_jumps._merton_row(100.0, 0.05, T, MP, 50))
        table = poisson_table(merton_constants(100.0, 0.05, T, MP, 50)["lam_dt"])
        assert int(row[5]) == table.size
        np.testing.assert_array_equal(row[H:H + table.size], table)
        np.testing.assert_array_equal(row[H - P:H], cuda_jumps.poisson_head(table)[:P])
    assert len({tuple(r[H - P:H]) for r in rows}) == Ts.size


@pytest.mark.parametrize("lam", [0.0, 0.3, 100.0])
def test_overlay_rows_carry_their_head(lam):
    jumps = MertonParams(0.2, lam, -0.1, 0.15)
    for T in (0.1, 0.5, 1.0):
        row = cuda_jumps._overlay_row(T, jumps, 50)
        table = poisson_table(overlay_constants(T, jumps, 50)["lam_dt"])
        np.testing.assert_array_equal(row[6:8], cuda_jumps.poisson_head(table)[:2])
        if lam == 0.0:
            assert table.size == 0 and np.all(row[6:8] == 2.0)


def _row_count(u: torch.Tensor, row: np.ndarray) -> tuple:
    """(N, sqrt N) of uniforms u as csrc/jumps.cu's head_count counts them
    from a constants row: 0 or 1 by u >= F(0) (slot 6); a uniform not below
    F(1) (slot 7) scans the row's table from entry 2; sqrt N is N for N <= 1
    and the IEEE root (torch.sqrt, sqrtf) past it."""
    table = row[cuda_jumps.HEAD:cuda_jumps.HEAD + int(row[5])]
    f0, f1 = float(row[6]), float(row[7])
    n = (u >= f0).to(torch.float32)
    past = u >= f1
    m = torch.full_like(n, 2.0)
    going = past.clone()
    for f in table[2:].tolist():
        going &= u >= f
        m += going.to(torch.float32)
    sn = torch.where(past, torch.sqrt(m), n)
    return torch.where(past, m, n), sn


@pytest.mark.parametrize("lam_dt", [0.0, 1e-5, 0.002, 0.02, 1.0, 30.0])
def test_row_head_count_equals_the_plain_count(lam_dt):
    """The paths kernels' count from a row: the plain version's counts bit
    for bit and torch.sqrt of them, for drawn uniforms (on
    uniform_from_bits' 2^-23 grid), every table entry, its float32
    neighbours, uniforms past the head and both ends of [0, 1); lam dt 0 and
    1e-5 give tables shorter than the head."""
    row = cuda_jumps.const_row(0.0, 0.0, -0.1, 0.15, 0.0, lam_dt)
    table = poisson_table(lam_dt)
    rng = np.random.default_rng(int(lam_dt * 1e6) + 7)
    drawn = (rng.integers(0, 1 << 23, 1 << 16) / (1 << 23)).astype(np.float32)
    edges = np.concatenate([table, np.nextafter(table, np.float32(0.0)),
                            np.nextafter(table, np.float32(1.0))])
    past = np.linspace(table[1] if table.size > 1 else 0.5, 1.0 - 2.0**-23,
                       1000).astype(np.float32)
    u = torch.from_numpy(np.concatenate([drawn, edges, past,
                                         np.float32([0.0, 1.0 - 2.0**-23])]))
    n, sn = _row_count(u, row)
    want = poisson_from_uniform(u, table)
    assert torch.equal(n, want) and torch.equal(sn, torch.sqrt(want))


def test_row_head_count_on_the_merton_stream():
    """The row count on the Merton stream's own uniforms at every maturity of
    the surface equals the plain version's counts."""
    for T in np.linspace(0.1, 1.0, 8).astype(np.float32).tolist():
        _, u, _ = merton_path_draws(SEED, 0, 2, PATH_TILE, 5, True)
        row = cuda_jumps._merton_row(100.0, 0.05, T, HEAVY, 5)
        n, _ = _row_count(u, row)
        table = poisson_table(merton_constants(100.0, 0.05, T, HEAVY, 5)["lam_dt"])
        assert torch.equal(n, poisson_from_uniform(u, table))


@pytest.mark.parametrize("mu_j", [-0.1, 0.1])
@pytest.mark.parametrize("z_sign", [-1.0, 1.0])
def test_skipped_box_muller_leaves_the_overlay_sum_bit_for_bit(mu_j, z_sign):
    """A float32 mirror of the overlay kernel's step at N = 0: its jump term
    fmaf(0, mu_j, sigma_j * 0 * z_j), whose product 0 mu_j is exact, so it is
    0 * mu_j + (sigma_j * 0) * z_j rounded once, is +-0; y + (jump + a) then
    equals y + a, the step the kernel takes where no lane of the warp jumped,
    bit for bit, for every y the walk reaches (+0 at the start, never -0)
    and every a, lam = 0's -0 included. The plain version's jump_sum at N =
    0 is +-0 as well."""
    f = np.float32
    rng = np.random.default_rng(11)
    z_j = f(z_sign) * np.abs(rng.standard_normal(4096)).astype(np.float32)
    z_j[:3] = f(z_sign) * np.float32([0.0, 1e-30, 8.0])
    sigma_j = f(0.15)
    jump = f(0.0) * f(mu_j) + (sigma_j * f(0.0)) * z_j
    assert np.all(jump == 0.0)
    plain = jump_sum(torch.zeros(z_j.size), torch.from_numpy(z_j), float(f(mu_j)),
                     float(sigma_j)).numpy()
    assert np.all(plain == 0.0)
    comp = overlay_constants(0.5, MertonParams(0.2, 0.3, mu_j, 0.15), 50)["a"]
    zero_a = overlay_constants(0.5, MertonParams(0.2, 0.0, mu_j, 0.15), 50)["a"]
    assert zero_a == 0.0
    ys = np.concatenate([[0.0], rng.normal(0.0, 0.3, 4095)]).astype(np.float32)
    for a in (f(comp), f(-comp), f(zero_a), f(0.0), f(-0.0), f(1e-3)):
        for j in (jump, plain.astype(np.float32)):
            got = ys + (j + a)
            want = ys + a
            assert np.array_equal(got.view(np.int32), want.view(np.int32))
            assert not np.any(np.signbit(got) & (got == 0.0))


# ---- the first designs and the card ------------------------------------------------

def test_first_designs_of_kernels_14_and_16_take_a_card_only():
    """The yardsticks have no plain route: a CPU device or tensor raises."""
    with pytest.raises(ValueError, match="CUDA"):
        cuda_jumps.merton_paths_first(SEED, 100.0, 0.05, 0.5, MP, 4096, 4, device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        cuda_jumps.jump_overlay_paths_first(torch.ones((5, PATH_TILE)), SEED, 0.5, MP)


def test_batched_wrapper_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    before = dict(cuda_jumps.launches)
    with pytest.raises(RuntimeError, match="CUDA"):
        cuda_jumps.merton_paths_batched(SEED, 100.0, 0.05, TS, MP, 4096, 4, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        merton.simulate_merton_maturities(SEED, 100.0, 0.05, TS, MP,
                                          MCConfig(n_paths=4096, n_steps=4))
    assert cuda_jumps.launches == before
