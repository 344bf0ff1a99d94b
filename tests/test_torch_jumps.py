"""The jump families of the port (models/merton.py, models/bates.py, the
plain versions of the kernels of csrc/jumps.cu) held against the JAX
package and the closed forms on the CPU.

Tolerances, each with its reason:
- The plain recursions on numpy-seeded (z, N, z_j) against the reference's
  increment formula (models/merton.py:60-61, models/bates.py:64-67) in
  float64 numpy: 1e-6 relative (float32 sums over 16 steps and float32
  constants).
- merton_price against the JAX merton_price: 1e-6 relative in float32
  (lgamma and erfc in two libraries), 1e-10 in float64.
- Poisson counts: a chi-square test of 2^16 draws against the pmf (p >
  1e-4), and the tail the table cuts below 2^-24.
- The simulators against the JAX simulators, in law (the two packages draw
  different streams): the martingale within 5e-3, and the mean and
  variance of log S_T within 4 combined standard errors.
- Europeans against the series and COS: 4 stderr + 2e-3 relative.
- At lam = 0 the Bates paths and plain LSM price equal Heston's bit for bit
  (the overlay multiplies by exactly 1).
"""

import dataclasses
import math
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from options_model_tpu.core.config import BatesParams as JBatesParams
from options_model_tpu.core.config import HestonParams as JHestonParams
from options_model_tpu.core.config import MCConfig as JMCConfig
from options_model_tpu.core.config import MertonParams as JMertonParams
from options_model_tpu.models import bates as jbates
from options_model_tpu.models import merton as jmerton
from options_model_tpu.pricers import greeks as jgreeks
from options_model_tpu_torch.calibration.charfn import bates_cos_price
from options_model_tpu_torch.core.config import (PUT, BatesParams, HestonParams, LSMConfig,
                                                  MCConfig, MertonParams, OptionSpec)
from options_model_tpu_torch.models import bates, merton
from options_model_tpu_torch.ops import cuda_heston, cuda_jumps
from options_model_tpu_torch.ops.philox import (MAX_POISSON_TABLE, jump_draws,
                                                merton_path_draws, poisson_from_uniform,
                                                poisson_table)
from options_model_tpu_torch.pricers import greeks
from options_model_tpu_torch.pricers.american import price_american_lsm, simulate_paths
from options_model_tpu_torch.pricers.european import make_terminal_sampler, price_european_mc
from _torch_threads import one_torch_thread_module  # noqa: F401

MERTON = dict(sigma=0.2, lam=1.0, mu_j=-0.10, sigma_j=0.15)
HESTON = dict(kappa=2.0, theta=0.04, xi=0.3, rho=-0.7, v0=0.04)
JUMPS = dict(lam=0.3, mu_j=-0.1, sigma_j=0.15)
MP = MertonParams(**MERTON)
BP = BatesParams(heston=HestonParams(**HESTON), **JUMPS)
SEED = 0x9E3779B97F4A7C15


# Small tensors and the calibrator's ~5,000 small ops an evaluation (the app
# test): torch's intra-op threads only add overhead, and several test workers
# share the machine.
# (tests/_torch_threads.py)
pytestmark = pytest.mark.usefixtures("one_torch_thread_module")


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _draws(n_steps, n_paths, lam_dt, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n_steps, n_paths)), rng.poisson(lam_dt, (n_steps, n_paths)),
            rng.standard_normal((n_steps, n_paths)))


# ---- the plain recursions against the reference's formulas ---------------------

@pytest.mark.parametrize("return_paths", [True, False])
def test_merton_from_draws_matches_the_reference_increment(return_paths):
    n_steps, T, r = 16, 0.5, 0.05
    z, n, zj = _draws(n_steps, 512, MP.lam * T / n_steps)
    dt = T / n_steps
    kbar = math.exp(MP.mu_j + 0.5 * MP.sigma_j**2) - 1.0
    inc = ((r - 0.5 * MP.sigma**2 - MP.lam * kbar) * dt + MP.sigma * math.sqrt(dt) * z
           + n * MP.mu_j + MP.sigma_j * np.sqrt(n) * zj)
    log_s = math.log(100.0) + np.concatenate([np.zeros((1, 512)), np.cumsum(inc, 0)])
    want = np.exp(log_s) if return_paths else np.exp(log_s[-1])
    f32 = [torch.from_numpy(a.astype(np.float32)) for a in (z, n, zj)]
    got = merton.merton_from_draws(*f32, 100.0, r, T, MP, return_paths)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


@pytest.mark.parametrize("return_paths", [True, False])
def test_overlay_from_draws_matches_the_reference_increment(return_paths):
    n_steps, T = 16, 0.5
    dt = T / n_steps
    kbar = math.exp(JUMPS["mu_j"] + 0.5 * JUMPS["sigma_j"] ** 2) - 1.0
    comp = JUMPS["lam"] * kbar * dt
    jumps = SimpleNamespace(**JUMPS)
    if return_paths:
        _, n, zj = _draws(n_steps, 512, JUMPS["lam"] * dt, seed=1)
        inc = n * jumps.mu_j + jumps.sigma_j * np.sqrt(n) * zj - comp
        want = np.exp(np.concatenate([np.zeros((1, 512)), np.cumsum(inc, 0)]))
    else:
        rng = np.random.default_rng(2)
        n, zj = rng.poisson(JUMPS["lam"] * T, 512), rng.standard_normal(512)
        want = np.exp(n * jumps.mu_j + jumps.sigma_j * np.sqrt(n) * zj - comp * n_steps)
    got = bates.overlay_from_draws(torch.from_numpy(n.astype(np.float32)),
                                   torch.from_numpy(zj.astype(np.float32)), T, jumps,
                                   n_steps, return_paths)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


# ---- merton_price against the JAX series ----------------------------------------

@pytest.mark.parametrize("cp", [1.0, -1.0])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_merton_price_matches_jax(cp, dtype):
    Ks = np.array([80.0, 95.0, 100.0, 110.0, 130.0])
    Ts = np.array([0.1, 0.5, 1.0, 2.0, 3.0])
    dt = getattr(torch, dtype)
    got = merton.merton_price(100.0, torch.tensor(Ks, dtype=dt), torch.tensor(Ts, dtype=dt),
                              0.05, MP, cp=cp, q=0.02)
    jp = JMertonParams(**MERTON)
    with jax.enable_x64(dtype == "float64"):
        want = np.array([float(jmerton.merton_price(100.0, K, T, 0.05, jp, cp=cp, q=0.02,
                                                    dtype=getattr(jnp, dtype)))
                         for K, T in zip(Ks, Ts)])
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6 if dtype == "float32" else 1e-10)


def test_merton_price_broadcasts_and_reduces_to_black_scholes_at_lam_zero():
    from options_model_tpu_torch.pricers.blackscholes import bs_price
    K = torch.linspace(80.0, 120.0, 5, dtype=torch.float64)[:, None]
    T = torch.tensor([0.25, 1.0], dtype=torch.float64)[None, :]
    got = merton.merton_price(100.0, K, T, 0.05, dataclasses.replace(MP, lam=0.0), cp=-1.0)
    assert got.shape == (5, 2) and got.dtype == torch.float64
    want = bs_price(100.0, K, T, 0.05, MP.sigma, -1.0, dtype=torch.float64)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12)


def test_merton_price_and_greeks_need_a_device_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        merton.merton_price(100.0, 100.0, 0.5, 0.05, MP)
    with pytest.raises(RuntimeError, match="CUDA"):
        greeks.merton_greeks(100.0, 100.0, 0.5, 0.05, MP)


def test_merton_greeks_match_jax():
    got = greeks.merton_greeks(100.0, 105.0, 0.5, 0.05, MP, cp=-1.0, q=0.01, device="cpu")
    want = jgreeks.merton_greeks(100.0, 105.0, 0.5, 0.05, JMertonParams(**MERTON), cp=-1.0,
                                 q=0.01)
    assert set(got) == set(want)
    for k in want:
        assert float(got[k]) == pytest.approx(float(want[k]), rel=2e-5, abs=1e-6), k


# ---- Poisson counts by inversion ------------------------------------------------

@pytest.mark.parametrize("lam", [0.01, 0.5, 3.0, 10.0])
def test_poisson_counts_follow_the_pmf(lam):
    u = torch.from_numpy(np.random.default_rng(3).random(1 << 16).astype(np.float32))
    n = poisson_from_uniform(u, poisson_table(lam)).numpy().astype(int)
    k_max = int(n.max())
    observed = np.bincount(n, minlength=k_max + 1).astype(float)
    expected = stats.poisson.pmf(np.arange(k_max + 1), lam) * n.size
    expected[-1] += stats.poisson.sf(k_max, lam) * n.size
    # merge bins until each expects at least 5 draws
    obs, exp, o, e = [], [], 0.0, 0.0
    for oi, ei in zip(observed, expected):
        o, e = o + oi, e + ei
        if e >= 5.0:
            obs.append(o)
            exp.append(e)
            o = e = 0.0
    if e:
        obs[-1] += o
        exp[-1] += e
    chi2 = float(np.sum((np.array(obs) - np.array(exp)) ** 2 / np.array(exp)))
    dof = max(len(obs) - 1, 1)
    assert stats.chi2.sf(chi2, dof) > 1e-4, (lam, chi2, dof)
    assert abs(n.mean() - lam) < 5.0 * math.sqrt(lam / n.size)


@pytest.mark.parametrize("lam", [0.0, 0.01, 0.5, 3.0, 10.0, 60.0])
def test_poisson_table_cuts_the_tail_below_2_pow_minus_24(lam):
    table = poisson_table(lam)
    assert table.dtype == np.float32 and (np.diff(table) >= 0).all()
    assert table.size == 0 or table[-1] < 1.0
    # the counts stop at len(table): the law's mass above it is what is cut
    assert stats.poisson.sf(table.size, lam) < 2.0**-24
    np.testing.assert_array_equal(table, stats.poisson.cdf(np.arange(table.size), lam)
                                  .astype(np.float32))
    top = poisson_from_uniform(torch.tensor([np.nextafter(np.float32(1.0), np.float32(0.0))]),
                               table)
    assert int(top) == table.size


def test_poisson_table_refuses_a_mean_it_cannot_hold():
    with pytest.raises(ValueError, match="table"):
        poisson_table(200.0)
    with pytest.raises(ValueError, match="non-negative"):
        poisson_table(-1.0)
    assert poisson_table(70.0).size <= MAX_POISSON_TABLE and cuda_jumps.ROW == 128


def test_counts_compare_uniforms_against_table_entries_inclusively():
    table = poisson_table(0.5)
    u = torch.from_numpy(np.concatenate([table, np.nextafter(table, np.float32(0.0))]))
    n = poisson_from_uniform(u, table).numpy()
    k = np.arange(table.size)
    np.testing.assert_array_equal(n[:table.size], k + 1)
    np.testing.assert_array_equal(n[table.size:], k)


def _head_count(u: torch.Tensor, table) -> tuple:
    """(N, sqrt N) of uniforms u as csrc/jumps.cu's poisson_head_count counts
    them from the head the wrapper builds (cuda_jumps.poisson_head): 0 or 1
    by u >= F(0); a uniform not below F(1) scans the table from entry
    POISSON_HEAD; sqrt N from the head's square roots, or torch.sqrt past
    them."""
    table = np.asarray(table, np.float32)
    h = cuda_jumps.poisson_head(table)
    cdf = h[:cuda_jumps.POISSON_HEAD].tolist()
    roots = torch.from_numpy(h[cuda_jumps.POISSON_HEAD:])
    n = (u >= cdf[0]).to(torch.int64)
    past = u >= cdf[1]
    m = torch.full_like(n, cuda_jumps.POISSON_HEAD)
    going = past.clone()
    for f in table[cuda_jumps.POISSON_HEAD:].tolist():
        going &= u >= f
        m += going.to(torch.int64)
    n = torch.where(past, m, n)
    sn = torch.where(n < cuda_jumps.SQRT_TABLE, roots[n.clamp_max(cuda_jumps.SQRT_TABLE - 1)],
                     torch.sqrt(n.to(torch.float32)))
    return n.to(u.dtype), sn


@pytest.mark.parametrize("lam_dt", [0.0, 1e-5, 0.005, 0.5, 1.0, 30.0])
def test_head_then_scan_count_equals_the_plain_count(lam_dt):
    """The redesigned terminal kernel's count (_head_count mirrors
    csrc/jumps.cu's): 0 or 1 against F(0) of the head the wrapper
    builds (poisson_head), a scan from entry 2 past F(1), sqrt N from the
    host's table. The plain version's counts bit for bit, and sqrt N
    torch.sqrt's, for drawn uniforms (on uniform_from_bits' 2^-23 grid),
    every table entry exactly, its float32 neighbours either side, uniforms
    past the head and both ends of [0, 1); lam dt 0 and 1e-5 give tables of
    0 and 1 entries, shorter than the head; 30 counts past the sqrt table."""
    table = poisson_table(lam_dt)
    assert (table.size < cuda_jumps.POISSON_HEAD) == (lam_dt < 1e-3)
    rng = np.random.default_rng(int(lam_dt * 1e6) + 1)
    drawn = (rng.integers(0, 1 << 23, 1 << 16) / (1 << 23)).astype(np.float32)
    edges = np.concatenate([table, np.nextafter(table, np.float32(0.0)),
                            np.nextafter(table, np.float32(1.0))])
    start = table[1] if table.size > 1 else 0.5
    past = np.linspace(start, 1.0 - 2.0**-23, 1000).astype(np.float32)
    u = torch.from_numpy(np.concatenate([drawn, edges, past,
                                         np.float32([0.0, 1.0 - 2.0**-23])]))
    n, sn = _head_count(u, table)
    want = poisson_from_uniform(u, table)
    assert torch.equal(n, want)
    assert torch.equal(sn, torch.sqrt(want))
    if table.size > cuda_jumps.POISSON_HEAD:
        assert int((want > cuda_jumps.POISSON_HEAD).sum()) > 0


def test_sqrt_table_and_head_are_the_host_floats_the_kernel_takes():
    """sqrt_table() is torch.sqrt of the counts 0..15 bit for bit (IEEE, as
    sqrtf); poisson_head pads the head past the table's end with 2, above
    every uniform."""
    counts = torch.arange(cuda_jumps.SQRT_TABLE, dtype=torch.float32)
    assert torch.equal(torch.from_numpy(cuda_jumps.sqrt_table()), torch.sqrt(counts))
    for lam_dt, size in ((0.0, 0), (1e-5, 1), (0.005, 2)):
        table = poisson_table(lam_dt)
        head = cuda_jumps.poisson_head(table)
        assert table.size == size and head.dtype == np.float32
        assert head.size == cuda_jumps.POISSON_HEAD + cuda_jumps.SQRT_TABLE
        np.testing.assert_array_equal(head[:size], table[:cuda_jumps.POISSON_HEAD])
        assert np.all(head[size:cuda_jumps.POISSON_HEAD] == 2.0)
        np.testing.assert_array_equal(head[cuda_jumps.POISSON_HEAD:], cuda_jumps.sqrt_table())


def _overlay_vectors(n_values: int, n_blocks: int) -> list:
    """The value indices of each thread of the redesigned terminal overlay
    (csrc/jumps.cu overlay_terminal_kernel): thread t of the grid's
    n_blocks x OVERLAY_BLOCK takes the OVERLAY_VEC-vectors v = t, t +
    threads, .. below n_values / OVERLAY_VEC, values OVERLAY_VEC v .. +
    OVERLAY_VEC - 1."""
    vec, threads = cuda_jumps.OVERLAY_VEC, n_blocks * cuda_jumps.OVERLAY_BLOCK
    return [[vec * v + i for v in range(t, n_values // vec, threads) for i in range(vec)]
            for t in range(threads)]


@pytest.mark.parametrize("n_tiles, n_sm, per_sm", [(1, 132, 16), (3, 132, 16), (256, 132, 16),
                                                   (5, 2, 3), (7, 1, 1)])
def test_overlay_terminal_grid_covers_each_value_once_within_its_tile(n_tiles, n_sm, per_sm):
    """Kernel 17's redesigned launch geometry (overlay_terminal_blocks and
    the grid-stride loop): the grid is whole waves (n_sm x blocks per SM) or
    fewer blocks where the vectors do not fill them; every value of S_T once;
    each thread's vector four consecutive values of one 16,384-value tile,
    so its counters are (j .. j + 3, n_steps, tile, 1) as the plain version
    draws them."""
    n = n_tiles * cuda_heston.TERMINAL_TILE
    blocks = cuda_jumps.overlay_terminal_blocks(n, n_sm, per_sm)
    vectors = n // cuda_jumps.OVERLAY_VEC
    assert blocks == min(n_sm * per_sm, -(-vectors // cuda_jumps.OVERLAY_BLOCK))
    per_thread = _overlay_vectors(n, blocks) if n_tiles < 256 else None
    if per_thread is None:  # 2^22 values: the same arithmetic in numpy
        t = np.arange(blocks * cuda_jumps.OVERLAY_BLOCK)
        v = (t[None, :] + np.arange(-(-vectors // t.size))[:, None] * t.size).ravel()
        v = v[v < vectors]
        values = (cuda_jumps.OVERLAY_VEC * v[:, None] + np.arange(4)[None, :])
    else:
        values = np.array([x for xs in per_thread for x in xs]).reshape(-1, 4)
    assert np.array_equal(np.sort(values.ravel()), np.arange(n))
    tile = values // cuda_heston.TERMINAL_TILE
    assert np.all(tile == tile[:, :1])
    assert np.all(np.diff(values % cuda_heston.TERMINAL_TILE, axis=1) == 1)


@pytest.mark.parametrize("n_values, n_sm, per_sm", [(0, 132, 16), (4096, 132, 16),
                                                    (16384 + 4, 132, 16), (16384, 0, 16),
                                                    (16384, 132, 0)])
def test_overlay_terminal_blocks_refuse_what_the_kernel_refuses(n_values, n_sm, per_sm):
    with pytest.raises(ValueError):
        cuda_jumps.overlay_terminal_blocks(n_values, n_sm, per_sm)


def _overlay_launch_constants(row: np.ndarray) -> dict:
    """Kernel 17's launch constants (csrc/jumps.cu OverlayT) as the C entry
    builds them from the wrapper's constants row and Poisson head: a, mu_j,
    sigma_j, the table's length and the table, and poisson_head of it."""
    n_table = int(row[5])
    table = row[cuda_jumps.HEAD:cuda_jumps.HEAD + n_table]
    return dict(a=row[0], mu_j=row[2], sigma_j=row[3], n_table=n_table, table=table,
                head=cuda_jumps.poisson_head(table))


@pytest.mark.parametrize("lam", [0.3, 0.6, 100.0])
def test_overlay_terminal_launch_constants_count_as_the_plain_version(lam):
    """Kernel 17's launch constants at T = 0.5 (lam T = 0.15, J2's; 0.3; 50,
    J0's heavy case): the row's head slots are F(0), F(1) of its table, the
    constants' head the same two and the square roots; the head-then-scan
    count on them (_head_count, the same rule as overlay_count) equals
    poisson_from_uniform bit for bit on drawn uniforms, every table entry
    and its float32 neighbours, F(0), F(1) and theirs in particular."""
    jumps = SimpleNamespace(lam=lam, mu_j=-0.1, sigma_j=0.15)
    row = cuda_jumps._overlay_row(0.5, jumps, 100, terminal=True)
    c = _overlay_launch_constants(row)
    table = poisson_table(lam * 0.5)
    assert np.array_equal(c["table"], table) and c["n_table"] == table.size
    np.testing.assert_array_equal(row[cuda_jumps.HEAD - 2:cuda_jumps.HEAD],
                                  c["head"][:cuda_jumps.POISSON_HEAD])
    np.testing.assert_array_equal(c["head"][:cuda_jumps.POISSON_HEAD], table[:2])
    rng = np.random.default_rng(int(lam * 10))
    drawn = (rng.integers(0, 1 << 23, 1 << 15) / (1 << 23)).astype(np.float32)
    edges = np.concatenate([table, np.nextafter(table, np.float32(0.0)),
                            np.nextafter(table, np.float32(1.0))])
    u = torch.from_numpy(np.concatenate([drawn, edges]).astype(np.float32))
    n, sn = _head_count(u, c["table"])
    want = poisson_from_uniform(u, table)
    assert torch.equal(n, want) and torch.equal(sn, torch.sqrt(want))
    for f in c["head"][:2]:
        for x in (f, np.nextafter(f, np.float32(0.0))):
            one = torch.tensor([x], dtype=torch.float32)
            assert torch.equal(_head_count(one, c["table"])[0], poisson_from_uniform(one, table))


def test_overlay_terminal_launch_constants_refuse_lam_t_100():
    """At lam T = 100 the float32 CDF table would need more than its 120
    entries (a mean up to 70): the constants row, and so any launch of
    kernel 17 or its plain version, is refused rather than cut."""
    with pytest.raises(ValueError, match="table"):
        cuda_jumps._overlay_row(0.5, SimpleNamespace(lam=200.0, mu_j=-0.1, sigma_j=0.15), 100,
                                terminal=True)


def test_overlay_terminal_first_design_takes_a_card_only():
    """Kernel 17's first design, the redesign's yardstick, has no plain
    route: a CPU S_T raises, and nothing is launched."""
    with pytest.raises(ValueError, match="CUDA"):
        cuda_jumps.jump_overlay_terminal_first(torch.ones(cuda_heston.TERMINAL_TILE), SEED, 0.5,
                                               SimpleNamespace(**JUMPS), 4)
    assert cuda_jumps.launches["jump_overlay_terminal_first"] == 0


def test_merton_terminal_first_design_takes_a_card_only():
    """Kernel 15's first design, the redesign's yardstick, has no plain route:
    a CPU device raises."""
    with pytest.raises(ValueError, match="CUDA"):
        cuda_jumps.merton_terminal_first(SEED, 100.0, 0.05, 0.5, MP, 4096, 4, device="cpu")


# ---- the streams --------------------------------------------------------------------

def test_merton_draws_mirror_the_normals_not_the_uniforms():
    z, u, zj = merton_path_draws(SEED, 3, 2, 8, 5, antithetic=True)
    zt, ut, jt = (a.reshape(5, 2, 8) for a in (z, u, zj))
    assert torch.equal(zt[..., 4:], -zt[..., :4]) and torch.equal(jt[..., 4:], -jt[..., :4])
    assert not torch.equal(ut[..., 4:], ut[..., :4])
    z1, u1, j1 = merton_path_draws(SEED, 3, 2, 8, 5, antithetic=False)
    assert z1.shape == (5, 16) and torch.equal(z1[:, :4], z[:, :4])
    assert torch.equal(u1[:, :4], u[:, :4])


def test_overlay_stream_is_its_own_and_the_terminal_draw_past_the_steps():
    from options_model_tpu_torch.ops.philox import path_normals
    u, zj = jump_draws(SEED, 0, 1, 16, 4)
    u_t, zj_t = jump_draws(SEED, 0, 1, 16, 4, terminal=True)
    assert u.shape == (4, 16) and u_t.shape == (16,)
    assert not any(torch.equal(u_t, row) for row in u)
    z = path_normals(SEED, 0, 1, 16, 4, antithetic=False)
    assert not torch.equal(zj[0], z[0])


# ---- the simulators ---------------------------------------------------------------

def _log_moments(x):
    x = np.log(np.asarray(x, np.float64))
    n = x.size
    m, v = x.mean(), x.var()
    m4 = ((x - m) ** 4).mean()
    return m, math.sqrt(v / n), v, math.sqrt(max(m4 - v * v, 0.0) / n)


@pytest.mark.parametrize("model", ["merton", "bates"])
def test_simulators_match_jax_in_law(model):
    T, r = 0.5, 0.05
    j_mc = JMCConfig(n_paths=1 << 14, n_steps=8, path_block=4096, antithetic=False)
    mc = MCConfig.from_reference(vars(j_mc))
    if model == "merton":
        S_j = jmerton.simulate_merton(jax.random.key(1), 100.0, r, T, JMertonParams(**MERTON),
                                      j_mc, return_paths=False)
        S = merton.simulate_merton(5, 100.0, r, T, MP, mc, return_paths=False, device="cpu")
    else:
        jb = JBatesParams(heston=JHestonParams(**HESTON), **JUMPS)
        S_j = jbates.simulate_bates(jax.random.key(1), 100.0, r, T, jb, j_mc,
                                    return_paths=True)[-1]
        S = bates.simulate_bates(5, 100.0, r, T, BP, mc, device="cpu")[-1]
    assert S.shape == (1 << 14,) and bool(torch.isfinite(S).all())
    mart = float(S.double().mean()) * math.exp(-r * T) / 100.0 - 1.0
    assert abs(mart) < 5e-3
    (m, se_m, v, se_v), (mj, se_mj, vj, se_vj) = _log_moments(S.numpy()), _log_moments(S_j)
    assert abs(m - mj) < 4.0 * math.hypot(se_m, se_mj)
    assert abs(v - vj) < 4.0 * math.hypot(se_v, se_vj)


@pytest.mark.parametrize("model", ["merton", "bates"])
def test_paths_terminal_and_antithetic_layout(model):
    mc = MCConfig(n_paths=8192, n_steps=8)
    sim = merton.simulate_merton if model == "merton" else bates.simulate_bates
    params = MP if model == "merton" else BP
    S = sim(3, 100.0, 0.05, 0.5, params, mc, device="cpu")
    assert S.shape == (9, 8192) and torch.allclose(S[0], torch.tensor(100.0))
    S_T = sim(3, 100.0, 0.05, 0.5, params, mc, return_paths=False, device="cpu")
    assert S_T.shape == (cuda_heston.TERMINAL_TILE,)
    if model == "bates":
        S2, v = bates.simulate_bates(3, 100.0, 0.05, 0.5, BP, mc, return_variance=True,
                                     device="cpu")
        _, v_h = cuda_heston.heston_paths(3, 100.0, 0.05, 0.5, BP.heston, 8192, 8,
                                          return_variance=True, device="cpu")
        assert torch.equal(S2, S) and torch.equal(v, v_h)


@pytest.mark.parametrize("kernel", ["merton_paths", "merton_terminal", "jump_overlay_paths",
                                    "jump_overlay_terminal"])
def test_first_tile_chunks_reproduce_the_full_run(kernel):
    tile = cuda_heston.TERMINAL_TILE if "terminal" in kernel else cuda_heston.PATH_TILE
    steps = 6
    jumps = SimpleNamespace(**dict(JUMPS, lam=20.0))
    if kernel.startswith("merton"):
        fn = getattr(cuda_jumps, kernel)
        full = fn(SEED, 100.0, 0.05, 0.5, MP, 4 * tile, steps, device="cpu")
        part = fn(SEED, 100.0, 0.05, 0.5, MP, 2 * tile, steps, True, 2, "cpu")
    elif kernel == "jump_overlay_paths":
        base = torch.ones((steps + 1, 4 * tile))
        full = cuda_jumps.jump_overlay_paths(base.clone(), SEED, 0.5, jumps)
        part = cuda_jumps.jump_overlay_paths(base[:, 2 * tile:].contiguous(), SEED, 0.5, jumps,
                                             2)
    else:
        full = cuda_jumps.jump_overlay_terminal(torch.ones(4 * tile), SEED, 0.5, jumps, steps)
        part = cuda_jumps.jump_overlay_terminal(torch.ones(2 * tile), SEED, 0.5, jumps, steps,
                                                2)
    assert torch.equal(full[..., 2 * tile:], part)


def test_batched_overlay_equals_single_maturities_on_their_tiles():
    Ts = [0.25, 0.5, 1.0]
    S = torch.ones((3, 5, 2 * cuda_heston.PATH_TILE))
    out, counts = cuda_jumps.jump_overlay_paths(S, SEED, Ts, BP, 7, return_counts=True)
    assert out is S and counts.shape == (3, 4, 2 * cuda_heston.PATH_TILE)
    for m, T in enumerate(Ts):
        one = cuda_jumps.jump_overlay_paths(torch.ones((5, 2 * cuda_heston.PATH_TILE)), SEED,
                                            T, BP, 7 + 2 * m)
        assert torch.equal(one, S[m])


def test_wrappers_without_a_card_raise_and_refuse_what_the_kernels_do_not_take():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        cuda_jumps.merton_paths(SEED, 100.0, 0.05, 0.5, MP, 4096, 4, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        cuda_jumps.merton_terminal(SEED, 100.0, 0.05, 0.5, MP, 4096, 4)
    with pytest.raises(ValueError, match="tiles"):
        cuda_jumps.jump_overlay_paths(torch.ones((5, 1000)), SEED, 0.5, BP)
    with pytest.raises(ValueError, match="maturities"):
        cuda_jumps.jump_overlay_paths(torch.ones((2, 5, 4096)), SEED, [0.5], BP)
    with pytest.raises(ValueError, match="terminal"):
        cuda_jumps.jump_overlay_terminal(torch.ones(4096), SEED, 0.5, BP, 4)


def test_jump_overlay_factor_has_mean_one():
    fac = bates.jump_overlay(SEED, 1.0, 2.0, -0.1, 0.15, MCConfig(n_paths=1 << 14, n_steps=8),
                             device="cpu")
    assert fac.shape == (9, 1 << 14) and torch.equal(fac[0], torch.ones(1 << 14))
    assert torch.allclose(fac.double().mean(1), torch.ones(9, dtype=torch.float64), atol=1e-2)


def test_simulators_refuse_a_gradient():
    s0 = torch.tensor(100.0, requires_grad=True)
    mc = MCConfig(n_paths=4096, n_steps=4)
    with pytest.raises(NotImplementedError, match="options_model_tpu\\."):
        merton.simulate_merton(1, s0, 0.05, 0.5, MP, mc, device="cpu")
    with pytest.raises(NotImplementedError, match="options_model_tpu\\."):
        bates.simulate_bates(1, s0, 0.05, 0.5, BP, mc, device="cpu")


# ---- Europeans and the lam = 0 identity -----------------------------------------

@pytest.mark.parametrize("model,scheme", [("merton", "euler"), ("bates", "euler"),
                                          ("bates", "qe")])
def test_european_matches_the_closed_form(model, scheme):
    T = 0.5
    spec = OptionSpec(strike=100.0, rate=0.05, cp=PUT)
    kw = dict(merton=MP) if model == "merton" else dict(bates=BP)
    sampler = make_terminal_sampler(model, 100.0, 0.05, T, heston_scheme=scheme, device="cpu",
                                    **kw)
    p, se, n = price_european_mc(_gen(3), sampler, spec, T,
                                 MCConfig(n_paths=1 << 16, n_steps=16))
    ref = float(merton.merton_price(100.0, 100.0, T, 0.05, MP, cp=-1.0, dtype=torch.float64,
                                    device="cpu") if model == "merton" else
                bates_cos_price(100.0, 100.0, T, 0.05, BP, cp=-1.0, dtype=torch.float64,
                                device="cpu"))
    assert float(n) == 1 << 16
    assert abs(float(p) - ref) < 4.0 * float(se) + 2e-3 * ref


def test_bates_european_does_not_depend_on_the_chunk_size():
    spec = OptionSpec(strike=100.0, rate=0.05, cp=PUT)
    sampler = make_terminal_sampler("bates", 100.0, 0.05, 0.5, bates=BP, device="cpu")
    mc = MCConfig(n_paths=4 * cuda_heston.TERMINAL_TILE, n_steps=4)
    a = price_european_mc(_gen(4), sampler, spec, 0.5, mc)
    b = price_european_mc(_gen(4), sampler, spec, 0.5, mc,
                          max_paths_per_chunk=cuda_heston.TERMINAL_TILE)
    assert float(a[0]) == pytest.approx(float(b[0]), rel=1e-6)


def test_bates_at_lam_zero_is_heston_bit_for_bit():
    mc = MCConfig(n_paths=8192, n_steps=8)
    bp0 = dataclasses.replace(BP, lam=0.0)
    S_b, v_b = simulate_paths(_gen(5), 100.0, 0.5, mc, "bates", rate=0.05, bates=bp0,
                              return_variance=True, device="cpu")
    S_h, v_h = simulate_paths(_gen(5), 100.0, 0.5, mc, "heston", rate=0.05,
                              heston=BP.heston, return_variance=True, device="cpu")
    assert torch.equal(S_b, S_h) and torch.equal(v_b, v_h)
    spec = OptionSpec(strike=100.0, rate=0.05, cp=PUT)
    lsm = LSMConfig(poly_degree=5, variance_basis_degree=3, use_control_variate=False)
    p_b = price_american_lsm(_gen(6), 100.0, 0.5, spec, mc, lsm, "bates", bates=bp0,
                             device="cpu")
    p_h = price_american_lsm(_gen(6), 100.0, 0.5, spec, mc, lsm, "heston", heston=BP.heston,
                             device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(p_b, p_h))


def test_app_bates_price_surface_at_4x4(monkeypatch, tmp_path):
    """calibrate -> price under Bates: the app's --model bates --test
    --price-surface at 4 x 4 on the CPU (one batched Heston launch's plain
    version, the overlay over it, the LSM backwards), its CSV's header and
    rows. The calibrator's least-squares polish is stubbed out as in
    tests/test_torch_calibration.py's app test; the card runs the whole fit
    (chip_smoke.py J4)."""
    from options_model_tpu_torch.apps import calibrate as app
    from options_model_tpu_torch.calibration import calibrator as tcal

    monkeypatch.setattr(tcal.HestonCalibrator, "_least_squares_polish",
                        lambda self, surface, x, bounds, f: (x, np.inf))
    out = tmp_path / "bates_surface.csv"
    s = app.run(app.parse_args(["--test", "--model", "bates", "--methods", "L-BFGS-B",
                                "--max-iterations", "1", "--price-surface", str(out),
                                "--surface-size", "4", "4"]), device="cpu")
    assert isinstance(s["params"], BatesParams) and s["surface_csv"] == str(out)
    lines = out.read_text().splitlines()
    assert lines[0] == "K,T,price" and len(lines) == 17
    rows = np.array([[float(v) for v in ln.split(",")] for ln in lines[1:]])
    np.testing.assert_allclose(rows[:4, 0], np.linspace(70.0, 130.0, 4), rtol=1e-6)
    P = rows[:, 2].reshape(4, 4)
    assert np.isfinite(P).all() and (P >= 0).all()
    assert (np.diff(P, axis=1) > -1e-3).all()   # puts rise with the strike
