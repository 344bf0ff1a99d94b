"""The port's counter-based stream (options_model_tpu_torch/ops/philox.py).

Philox4x32-10 in plain torch is held against the Random123 known-answer
vectors and a pure-Python big-integer Philox; the stream's contract (uniform
range, normal moments, the antithetic mirror within each tile, and the
first_tile offset) is checked on the plain versions of the kernels, which
share the stream bit for bit with csrc/philox.cuh on the card.
"""

import numpy as np
import pytest
import torch

from options_model_tpu_torch.core.config import HestonParams
from options_model_tpu_torch.ops import cuda_gbm, cuda_heston
from options_model_tpu_torch.ops.philox import (path_normals, philox4x32, stream_normals,
                                                stream_words, uniform_from_bits)

MASK = 0xFFFFFFFF
HESTON = HestonParams(kappa=2.0, theta=0.04, xi=0.3, rho=-0.7, v0=0.04)


def philox_bigint(ctr, key):
    """Philox4x32-10 on Python integers (exact 64-bit products)."""
    c0, c1, c2, c3 = ctr
    k0, k1 = key
    for _ in range(10):
        p0, p1 = 0xD2511F53 * c0, 0xCD9E8D57 * c2
        c0, c1, c2, c3 = ((p1 >> 32) ^ c1 ^ k0, p1 & MASK, (p0 >> 32) ^ c3 ^ k1, p0 & MASK)
        k0, k1 = (k0 + 0x9E3779B9) & MASK, (k1 + 0xBB67AE85) & MASK
    return c0, c1, c2, c3


def philox_torch(ctr, key):
    words = philox4x32(*(torch.tensor([c], dtype=torch.int64) for c in ctr), *key)
    return tuple(int(w[0]) for w in words)


@pytest.mark.parametrize("ctr, key, expected", [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((MASK, MASK, MASK, MASK), (MASK, MASK),
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_random123_known_answers(ctr, key, expected):
    assert philox_torch(ctr, key) == expected
    assert philox_bigint(ctr, key) == expected


def test_matches_bigint_philox_on_random_counters():
    rng = np.random.default_rng(123)
    ctr = rng.integers(0, 1 << 32, size=(4, 256), dtype=np.uint64).astype(np.int64)
    k0, k1 = (int(x) for x in rng.integers(0, 1 << 32, size=2, dtype=np.uint64))
    got = philox4x32(*(torch.from_numpy(c) for c in ctr), k0, k1)
    got = np.stack([w.numpy() for w in got])
    for i in range(ctr.shape[1]):
        want = philox_bigint(tuple(int(c) for c in ctr[:, i]), (k0, k1))
        assert tuple(int(w) for w in got[:, i]) == want


def test_stream_words_are_the_slot_counters():
    """Word q of draw k of slot j in global tile g is Philox((j, k, g, 0), seed)."""
    seed = 0x0123456789ABCDEF
    words = stream_words(seed, first_tile=5, n_tiles=2, width=8, n_draws=3)
    assert words.shape == (3, 4, 16)
    for k, slot in [(0, 0), (2, 7), (1, 8), (2, 15)]:
        want = philox_bigint((slot % 8, k, 5 + slot // 8, 0), (seed & MASK, seed >> 32))
        assert tuple(int(w) for w in words[k, :, slot]) == want


def test_uniforms_lie_in_unit_interval():
    edges = uniform_from_bits(torch.tensor([0, 1 << 9, MASK], dtype=torch.int64))
    assert edges.dtype == torch.float32
    assert edges[0] == 0.0 and edges[1] == 2.0 ** -23 and edges[2] == 1.0 - 2.0 ** -23
    u = uniform_from_bits(stream_words(7, 0, 4, 1024, 4).reshape(-1))
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    assert abs(float(u.mean()) - 0.5) < 4.0 * (1 / 12) ** 0.5 / u.numel() ** 0.5


def test_normals_have_unit_moments():
    z = stream_normals(2026, 0, 8, 2048, 8).reshape(-1).double()
    n = z.numel()
    assert bool(torch.isfinite(z).all())
    assert abs(float(z.mean())) < 4.0 / n ** 0.5
    assert abs(float(z.var()) - 1.0) < 4.0 * (2.0 / n) ** 0.5


@pytest.mark.parametrize("tile", [cuda_heston.PATH_TILE, cuda_heston.TERMINAL_TILE])
def test_mirror_layout_within_each_tile(tile):
    z = path_normals(11, 0, 3, tile, 4, antithetic=True)
    assert z.shape == (4, 3 * tile)
    zt = z.reshape(4, 3, 2, tile // 2)
    assert torch.equal(zt[:, :, 1], -zt[:, :, 0])
    plain = path_normals(11, 0, 3, tile, 4, antithetic=False)
    assert not torch.equal(plain.reshape(4, 3, 2, -1)[:, :, 1], -plain.reshape(4, 3, 2, -1)[:, :, 0])


def test_first_tile_offset_reproduces_the_longer_run():
    n = 3
    full = stream_words(99, 0, 2 * n, 512, 5)
    head = stream_words(99, 0, n, 512, 5)
    tail = stream_words(99, n, n, 512, 5)
    assert torch.equal(full, torch.cat([head, tail], dim=-1))


@pytest.mark.parametrize("kernel", ["heston_paths", "heston_terminal", "gbm_paths",
                                    "gbm_terminal"])
def test_kernel_plain_versions_are_chunkable_by_first_tile(kernel):
    """A run of 2n tiles equals two runs of n tiles at first_tile 0 and n,
    bit for bit (the property a sharded or chunked caller relies on)."""
    tile = cuda_heston.TERMINAL_TILE if kernel.endswith("terminal") else cuda_heston.PATH_TILE
    n_steps = 4

    def run(n_tiles, first_tile):
        if kernel == "heston_paths":
            return torch.cat(cuda_heston.heston_paths(
                5, 100.0, 0.05, 0.5, HESTON, n_tiles * tile, n_steps, True, True,
                first_tile, "cpu"))
        if kernel == "heston_terminal":
            return cuda_heston.heston_terminal(5, 100.0, 0.05, 0.5, HESTON, n_tiles * tile,
                                               n_steps, True, first_tile, "cpu")
        if kernel == "gbm_paths":
            return cuda_gbm.gbm_paths(5, 100.0, 0.05, 0.2, 0.5, n_tiles * tile, n_steps,
                                      True, first_tile, "cpu")
        return cuda_gbm.gbm_terminal(5, 100.0, 0.05, 0.2, 0.5, n_tiles * tile, n_steps,
                                     True, first_tile, "cpu")

    full = run(2, 0)
    assert torch.equal(full, torch.cat([run(1, 0), run(1, 1)], dim=-1))
