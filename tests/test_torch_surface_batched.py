"""The maturity-batched Heston paths route (ops/cuda_heston.heston_paths_batched,
models/heston.simulate_heston_maturities, pricers/surface_american) on the
CPU, where every wrapper is its plain version.

- The batched plain version is the single-maturity plain versions stacked,
  maturity m at first_tile + m n_tiles, bit for bit.
- price_american_surface under Heston (one batched simulation per group of
  maturities) equals, bit for bit, the per-maturity loop it replaced:
  simulate_seeded at i n_tiles, then lsm_surface_backward.
- Group sizing: 64 maturities per launch at 16,384 paths x 50 steps, 1 from
  2^20 x 50 on, fewer where the steps are more.
- The kernel's per-maturity constants, built for all maturities at once,
  are each maturity's single-launch constants bit for bit.
The kernel itself (csrc/heston_paths.cu) is held against these plain
versions on the card by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from options_model_tpu_torch.core.config import HestonParams, MCConfig
from options_model_tpu_torch.models.heston import simulate_heston_maturities
from options_model_tpu_torch.ops import cuda_heston
from options_model_tpu_torch.ops.philox import seed_from_generator
from options_model_tpu_torch.pricers import surface_american
from options_model_tpu_torch.pricers.american import _pair_block, simulate_seeded
from options_model_tpu_torch.pricers.surface_american import (_pair_stderr,
                                                              lsm_surface_backward,
                                                              maturity_group,
                                                              price_american_surface)

HESTON = HestonParams(kappa=2.0, theta=0.04, xi=0.3, rho=-0.7, v0=0.04)
TS = np.array([0.1, 0.4, 0.7, 1.0], np.float32)
STRIKES = np.linspace(85.0, 115.0, 5).astype(np.float32)
SEED = 0x9E3779B97F4A7C15


def _single(scheme):
    return (cuda_heston.heston_paths_qe_reference if scheme == "qe"
            else cuda_heston.heston_paths_reference)


@pytest.mark.parametrize("first_tile", [0, 3])
@pytest.mark.parametrize("variance", [False, True])
@pytest.mark.parametrize("scheme", ["euler", "qe"])
def test_batched_plain_version_stacks_single_maturities(scheme, variance, first_tile):
    n_paths, n_steps = 5000, 5          # 2 tiles of 4096; an odd step count
    out = cuda_heston.heston_paths_batched(SEED, 100.0, 0.05, TS[:3], HESTON, n_paths,
                                           n_steps, True, variance, first_tile, "cpu",
                                           scheme)
    S, V = out if variance else (out, None)
    assert S.shape == (3, n_steps + 1, 8192)
    for m, T in enumerate(TS[:3]):
        want = _single(scheme)(SEED, 100.0, 0.05, float(T), HESTON, n_paths, n_steps, True,
                               variance, first_tile + 2 * m, "cpu")
        if variance:
            assert torch.equal(S[m], want[0]) and torch.equal(V[m], want[1])
        else:
            assert torch.equal(S[m], want)


@pytest.mark.parametrize("scheme", ["euler", "qe"])
def test_single_maturity_wrappers_are_the_batched_kernel_at_one_maturity(scheme):
    single = cuda_heston.heston_paths_qe if scheme == "qe" else cuda_heston.heston_paths
    args = (SEED, 100.0, 0.05, 0.5, HESTON, 4096, 6, False, True, 2, "cpu")
    S, V = single(*args)
    S_b, V_b = cuda_heston.heston_paths_batched(SEED, 100.0, 0.05, [0.5], HESTON, 4096, 6,
                                                False, True, 2, "cpu", scheme)
    assert torch.equal(S, S_b[0]) and torch.equal(V, V_b[0])
    S_r, V_r = _single(scheme)(*args)
    assert torch.equal(S, S_r) and torch.equal(V, V_r)


@pytest.mark.parametrize("scheme", ["euler", "qe"])
def test_surface_equals_the_per_maturity_loop(scheme):
    """4 maturities x 5 strikes at 2 tiles, with stderr: the grouped route
    against simulate_seeded + lsm_surface_backward one maturity at a time."""
    mc = MCConfig(n_paths=8192, n_steps=8, path_block=4096)
    P, SE = price_american_surface(torch.Generator().manual_seed(5), 100.0, STRIKES, TS,
                                   0.05, mc, heston=HESTON, heston_scheme=scheme,
                                   return_stderr=True, device="cpu")
    seed = seed_from_generator(torch.Generator().manual_seed(5))
    pb = _pair_block(mc, "heston")
    rows, errs = [], []
    for i, T in enumerate(TS.tolist()):
        S, v = simulate_seeded(seed, 2 * i, 100.0, T, mc, "heston", drift=0.05,
                               heston=HESTON, heston_scheme=scheme, return_variance=True,
                               device="cpu")
        cash = lsm_surface_backward(S, torch.as_tensor(STRIKES), 0.05, T, -1.0,
                                    return_cash=True, v_paths=v)
        rows.append(cash.mean(dim=1))
        errs.append(_pair_stderr(cash, pb))
    assert P.shape == SE.shape == (4, 5)
    assert torch.equal(P, torch.stack(rows)) and torch.equal(SE, torch.stack(errs))


def test_surface_does_not_depend_on_the_grouping(monkeypatch):
    """With one launch per two maturities the surface is the same bits as
    with all four in one launch, and the route simulates twice."""
    mc = MCConfig(n_paths=4096, n_steps=6, path_block=4096)

    def surface():
        return price_american_surface(torch.Generator().manual_seed(8), 100.0, STRIKES, TS,
                                      0.05, mc, heston=HESTON, device="cpu")

    one_group = surface()
    calls = []

    def counted(*args, **kwargs):
        calls.append(len(args[3]))
        return simulate_heston_maturities(*args, **kwargs)

    monkeypatch.setattr(surface_american, "BATCH_ENTRIES", 2 * 4096 * (6 + 1))
    monkeypatch.setattr(surface_american, "simulate_heston_maturities", counted)
    assert torch.equal(surface(), one_group)
    assert calls == [2, 2]


@pytest.mark.parametrize("n_pad, n_steps, group", [
    (4096, 50, 256), (16384, 50, 64), (1 << 19, 50, 2), (1 << 20, 50, 1), (1 << 22, 50, 1),
    (16384, 365, 8),     # daily steps over a year: 8 x 16,384 x 366 entries, not 64
])
def test_maturity_group_sizing(n_pad, n_steps, group):
    assert maturity_group(n_pad, n_steps) == group


@pytest.mark.parametrize("scheme", ["euler", "qe"])
def test_batched_consts_equal_single_maturity_rows(scheme):
    Ts = np.concatenate([np.linspace(0.1, 1.0, 64), [0.004, 2.5, 30.0]]).astype(np.float32)
    got = cuda_heston.batched_consts(scheme, 100.0, 0.05, Ts, HESTON, 50, "cpu")
    want = torch.tensor([cuda_heston._const_row(scheme, 100.0, 0.05, T, HESTON, 50)
                         for T in Ts.tolist()], dtype=torch.float32)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_batched_wrapper_is_plain_on_cpu_and_refuses_cuda_without_it():
    args = (SEED, 100.0, 0.05, TS[:2], HESTON, 4096, 4)
    before = dict(cuda_heston.launches)
    got = cuda_heston.heston_paths_batched(*args, device="cpu")
    assert torch.equal(got, cuda_heston.heston_paths_batched_reference(*args, device="cpu"))
    assert cuda_heston.launches == before
    with pytest.raises(ValueError, match="scheme"):
        cuda_heston.heston_paths_batched(*args, device="cpu", scheme="milstein")
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py covers the kernel")
    for scheme in ("euler", "qe"):
        with pytest.raises(RuntimeError, match="CUDA"):
            cuda_heston.heston_paths_batched(*args, device="cuda", scheme=scheme)
    with pytest.raises(RuntimeError, match="CUDA"):
        cuda_heston.heston_paths_batched(*args)      # no device: the card, never the CPU
