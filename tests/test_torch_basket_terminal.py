"""Kernel 28's redesign (options_model_tpu_torch/csrc/basket.cu
basket_terminal_kernel) on the CPU: what can be held here without the card.

- A Python mirror of its geometry: a 2-D grid, x the local tile and y a
  block of kTermBlock items, item i taking the K adjacent slots K i, ...,
  K i + K - 1 of the tile's first half (the whole tile without
  antithetics), K = cuda_basket.terminal_slots(n) where the width takes it
  and 1 elsewhere. Every slot is written once, every column of the output
  once, each asset row's K values as one aligned vector store at the
  path's column and one at the mirror's, and each slot draws on the
  counter (slot, t ceil(n / 4) + c, global tile, BASKET_STREAM): the
  normals philox.basket_path_draws gives that column, bit for bit.
- The wrappers of both designs on CPU tensors: the plain version, bit for
  bit, with no launch counted; on a CUDA device torch cannot see, both
  raise (_build.require_cuda).
- The plain version against the JAX package's gbm_basket_terminal_exact on
  the JAX package's own normals at the asset counts the register instances
  take (rtol 1e-5: XLA's L @ z sums in its own order and contracts into
  FMAs, and S0 exp(acc) against exp(log S0 + acc) rounds once more).

On the card, chip_smoke.py's X0 holds both designs to the plain version
bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from options_model_tpu.models import multiasset as jm
from options_model_tpu_torch.models import multiasset as tm
from options_model_tpu_torch.ops import cuda_basket as cb
from options_model_tpu_torch.ops.cuda_heston import PATH_TILE, TERMINAL_TILE
from options_model_tpu_torch.ops.philox import (BASKET_STREAM, basket_calls, basket_path_draws,
                                               box_muller, philox4x32, uniform_from_bits)
from _torch_threads import one_torch_thread_module  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread_module")

SEED = 0x9E3779B97F4A7C15
R, T = 0.05, 0.5
BLOCK = 256                     # csrc/basket.cu kTermBlock
ODD_TILE = 1030                 # a half of 515: no K divides it


def _assets(n, seed=3):
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


def slots_a_thread(n, tile, anti):
    """launch_terminal's K: terminal_slots(n) where it divides the width."""
    width = tile // 2 if anti else tile
    k = cb.terminal_slots(n)
    return k if width % k == 0 else 1


def mirror(n_tiles, tile, anti, first_tile, k):
    """Every live thread of the redesign's grid (x the local tile, y the
    item block): per thread and lane s, its slot j + s, global tile, the
    path's column and the mirror's (None without antithetics)."""
    width = tile // 2 if anti else tile
    items = width // k
    bx, by, tx = np.meshgrid(np.arange(n_tiles), np.arange(-(-items // BLOCK)),
                             np.arange(BLOCK), indexing="ij")
    item = (by * BLOCK + tx).ravel()
    bx = bx.ravel()
    live = item < items
    bx, item = bx[live], item[live]
    slot = item[:, None] * k + np.arange(k)
    col = bx[:, None] * tile + slot
    return dict(slot=slot, tile=np.broadcast_to(first_tile + bx[:, None], slot.shape),
                col=col, mirror=col + width if anti else None, width=width)


@pytest.mark.parametrize("n", [3, 6])
@pytest.mark.parametrize("n_tiles", [1, 2, 3])
@pytest.mark.parametrize("tile", [PATH_TILE, TERMINAL_TILE])
@pytest.mark.parametrize("anti", [True, False])
def test_mirror_covers_every_slot_and_column_once(anti, tile, n_tiles, n):
    k = slots_a_thread(n, tile, anti)
    assert k == (4 if n == 3 else 2)
    m = mirror(n_tiles, tile, anti, 5, k)
    for lt in range(n_tiles):
        mine = m["tile"][:, 0] == 5 + lt
        assert np.array_equal(np.sort(m["slot"][mine].ravel()), np.arange(m["width"]))
    cols = [m["col"].ravel()] + ([m["mirror"].ravel()] if anti else [])
    assert np.array_equal(np.sort(np.concatenate(cols)), np.arange(n_tiles * tile))
    # one aligned vector store a row: the lanes adjacent, the first on a multiple of K
    for c in [m["col"]] + ([m["mirror"]] if anti else []):
        assert np.all(c[:, 0] % k == 0) and np.all(np.diff(c, axis=1) == 1)
    # the row stride n_pad keeps every asset row's stores aligned
    assert (n_tiles * tile) % k == 0


@pytest.mark.parametrize("anti", [True, False])
@pytest.mark.parametrize("n", [3, 6])
def test_mirror_at_a_tile_no_k_divides(n, anti):
    k = slots_a_thread(n, ODD_TILE, anti)
    assert k == (2 if n == 6 and not anti else 1)
    m = mirror(2, ODD_TILE, anti, 1, k)
    cols = [m["col"].ravel()] + ([m["mirror"].ravel()] if anti else [])
    assert np.array_equal(np.sort(np.concatenate(cols)), np.arange(2 * ODD_TILE))


@pytest.mark.parametrize("n,n_steps", [(3, 1), (5, 2), (8, 2)])
@pytest.mark.parametrize("tile,n_tiles,anti", [(TERMINAL_TILE, 1, True), (PATH_TILE, 3, True),
                                               (PATH_TILE, 2, False), (ODD_TILE, 2, True)])
def test_mirror_draws_the_stream_of_basket_path_draws(tile, n_tiles, anti, n, n_steps):
    """Each slot's counter (slot, t calls + a // 4, global tile, 6) gives
    the normals basket_path_draws puts in its column, and their negatives in
    the mirror's, bit for bit."""
    first_tile = 7
    m = mirror(n_tiles, tile, anti, first_tile, slots_a_thread(n, tile, anti))
    want = basket_path_draws(SEED, first_tile, n_tiles, tile, n_steps, n, anti)
    j = torch.from_numpy(m["slot"].ravel()).to(torch.int64)
    g = torch.from_numpy(m["tile"].ravel().copy()).to(torch.int64)
    col = torch.from_numpy(m["col"].ravel())
    calls = basket_calls(n)
    for t in range(n_steps):
        for c in range(calls):
            w = [uniform_from_bits(x) for x in philox4x32(j, t * calls + c, g, BASKET_STREAM,
                                                          SEED & 0xFFFFFFFF, SEED >> 32)]
            z = [*box_muller(w[0], w[1]), *box_muller(w[2], w[3])]
            for a in range(4 * c, min(4 * c + 4, n)):
                assert torch.equal(want[t, a, col], z[a % 4])
                if anti:
                    assert torch.equal(want[t, a, torch.from_numpy(m["mirror"].ravel())],
                                       -z[a % 4])


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 12])
@pytest.mark.parametrize("anti", [True, False])
@pytest.mark.parametrize("n_steps,tile,first_tile", [(1, TERMINAL_TILE, 0), (3, 256, 2)])
def test_both_designs_on_the_cpu_are_the_plain_version(n_steps, tile, first_tile, anti, n):
    c = _consts(n, n_steps)
    want = cb.basket_terminal_reference(SEED, c, 2 * tile, n_steps, anti, first_tile, tile,
                                        "cpu")
    for fn in (cb.basket_terminal, cb.basket_terminal_first):
        assert torch.equal(fn(SEED, c, 2 * tile, n_steps, anti, first_tile, tile, "cpu"), want)
    assert cb.launches == {"basket_paths": 0, "basket_terminal": 0, "basket_terminal_first": 0}


@pytest.mark.parametrize("fn", [cb.basket_terminal, cb.basket_terminal_first])
def test_both_designs_raise_without_cuda(fn):
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py drives both designs")
    c = _consts(3, 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        fn(SEED, c, 256, 1, True, 0, 256, "cuda")
    with pytest.raises(ValueError, match="CUDA device"):
        cb.basket_launch(SEED, c, 256, 1, True, 0, 256, torch.device("cpu"), "terminal_first")
    assert cb.launches == {"basket_paths": 0, "basket_terminal": 0, "basket_terminal_first": 0}


@pytest.mark.parametrize("anti", [True, False])
@pytest.mark.parametrize("n", [1, 2, 5, 8])
def test_plain_version_on_the_reference_normals(n, anti):
    """The plain version's chain (models/multiasset.basket_chain) on the JAX
    package's normals against its gbm_basket_terminal_exact."""
    S0, sig, corr = _assets(n)
    key = jax.random.key(9)
    want = np.asarray(jm.gbm_basket_terminal_exact(key, S0, R, sig, corr, T, 2048,
                                                   div_yields=[0.02] * n, antithetic=anti))
    if anti:
        zh = jax.random.normal(key, (n, 1024), jnp.float32)
        z = np.array(jnp.concatenate([zh, -zh], axis=1))
    else:
        z = np.array(jax.random.normal(key, (n, 2048), jnp.float32))
    got = tm.basket_chain(torch.from_numpy(z)[None], _consts(n, 1)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5)
