"""Counter-based random stream shared by the CUDA kernels and their plain
versions: Philox4x32-10 (Salmon et al., SC'11) in plain torch, bit-equal to
csrc/philox.cuh.

It replaces the TPU kernels' hardware PRNG plumbing (_seed_array, _tile_seed,
_uniform_from_bits and _box_muller, options_model_tpu/ops/pallas_heston.py:
78-114). The TPU's bits cannot be reproduced off the chip, so the stream is
new; what carries over is its contract:

- the draw of a path slot is a pure function of (seed, global tile, draw
  index, slot in the tile): counter = (slot, draw, first_tile + tile, 0),
  key = (seed & 0xFFFFFFFF, seed >> 32). A run at offset ``first_tile``
  therefore reproduces those tiles of a longer run bit for bit;
- uniforms are ((bits >> 9) | 0x3F800000) bit-cast to f32, minus 1, in [0, 1);
- Box-Muller takes log(1 - u1), which stays finite.

One Philox call yields four words, which Box-Muller turns into four normals
(w0, w1) -> (n0, n1) and (w2, w3) -> (n2, n3): normal q of a slot comes from
draw q // 4. A slot is one antithetic pair when the caller mirrors, so a
tile of ``tile`` paths has ``tile // 2`` slots, path j + tile/2 being the
mirror of path j. The GBM, Euler-Heston and local-vol streams use this
layout (``path_normals``).

The QE-M Heston stream (``qe_path_draws``) takes one Philox call per step:
draw t gives (w0, w1) -> Box-Muller -> (z_v, z_s), w2 -> the raw uniform u,
and w3 is unused. The antithetic mirror of (z_v, z_s, u) is
(-z_v, -z_s, 1 - u), as in the TPU kernel (pallas_heston.py:394-400); 1 - u
is exact in f32.

The jump streams (``merton_path_draws``, ``jump_draws``) take one Philox
call per slot and step, as QE-M does:
- Merton (models/merton.py): one call per antithetic *pair* slot and step;
  (w0, w1) -> Box-Muller -> (z, z_j), mirrored within the tile as [z, -z]
  and [z_j, -z_j]; w2 and w3 are the full-width Poisson uniforms of the
  path and of its mirror, never mirrored. Without antithetics one call per
  path: w2 is its uniform, w3 unused.
- The Bates jump overlay (models/bates.py): one call per *path* and step,
  never mirrored: (w0, w1) -> Box-Muller, the first normal is z_j; w2 the
  Poisson uniform. The terminal overlay draws one (count, normal) pair per
  path at draw index n_steps, with the law of the whole maturity: a
  different stream from the path version's, as in the reference.
The overlay takes the Heston kernel's seed and tiles, and only the fourth
counter word changes: counter = (slot, draw, global tile, 1), where every
other stream uses 0. It draws nothing more from the caller's generator.

Poisson counts are drawn by inversion against a table the host builds once
per launch (``poisson_table``): the float64 CDF of Poisson(lam dt), each
entry rounded to float32, up to the first entry that rounds to 1. The count
is the number of entries the uniform is not below
(``poisson_from_uniform``). A kernel and its plain version compare the same
float32 numbers, so their counts are equal bit for bit, with no dependence
on the card's exp. The law is cut where the float32 CDF reaches 1: the
tail it drops has mass below 2^-25 < 2^-24 (a float32 just below 1 is at
most 1 - 2^-24, and the CDF rounds to 1 from 1 - 2^-25 up). The TPU's
``jax.random.poisson`` draws cannot be replayed, so parity with the
reference is in law.

32x32-bit products are formed in int64 from 16-bit halves (int64 cannot hold
a full 64-bit unsigned product) and every word is masked to 32 bits.
"""

from __future__ import annotations

import math

import numpy as np
import torch

PHILOX_M0 = 0xD2511F53
PHILOX_M1 = 0xCD9E8D57
PHILOX_W0 = 0x9E3779B9
PHILOX_W1 = 0xBB67AE85
_MASK32 = 0xFFFFFFFF
_TWO_PI = 6.283185307179586
# Fourth counter word of the jump overlay's stream (every other stream: 0).
OVERLAY_STREAM = 1
# The most entries of a Poisson table (csrc/jumps.cu kMaxTable): a mean up
# to 70.
MAX_POISSON_TABLE = 120


def _mulhilo(m: int, b: torch.Tensor):
    """(hi, lo) 32-bit words of the 64-bit product m * b, b in [0, 2^32)."""
    p_lo = m * (b & 0xFFFF)            # < 2^48
    p_hi = m * (b >> 16)               # < 2^48
    s = ((p_hi & 0xFFFF) << 16) + p_lo  # < 2^49
    return (p_hi >> 16) + (s >> 32), s & _MASK32


def philox4x32(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 on int64 tensors holding uint32 words; c1 and c3 may
    also be Python ints."""
    for _ in range(10):
        hi0, lo0 = _mulhilo(PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + PHILOX_W0) & _MASK32
        k1 = (k1 + PHILOX_W1) & _MASK32
    return c0, c1, c2, c3


def seed_from_generator(generator: torch.Generator) -> int:
    """A 64-bit kernel seed drawn from an explicit generator (the port's
    counterpart of seed_from_key on a JAX key)."""
    w = torch.randint(0, 1 << 32, (2,), generator=generator,
                      device=generator.device, dtype=torch.int64).tolist()
    return w[0] | (w[1] << 32)


def _slot_counters(first_tile: int, n_tiles: int, width: int, device):
    """(slot-in-tile, global tile) counter words of every slot, tile-major."""
    slot = torch.arange(n_tiles * width, device=device, dtype=torch.int64)
    return slot % width, (first_tile + slot // width) & _MASK32


def stream_words(seed: int, first_tile: int, n_tiles: int, width: int,
                 n_draws: int, device=None) -> torch.Tensor:
    """Raw Philox words (n_draws, 4, n_tiles * width) as int64 in [0, 2^32)."""
    j, g = _slot_counters(first_tile, n_tiles, width, device)
    k0, k1 = seed & _MASK32, (seed >> 32) & _MASK32
    return torch.stack([torch.stack(philox4x32(j, k, g, 0, k0, k1))
                        for k in range(n_draws)])


def stream_words_cuda(seed: int, first_tile: int, n_tiles: int, width: int,
                      n_draws: int, device) -> torch.Tensor:
    """The same words as ``stream_words``, drawn on the card by the kernels'
    own Philox (csrc/philox.cu): the bit-for-bit check of csrc/philox.cuh."""
    from options_model_tpu_torch.ops import _build

    device = torch.device(device)
    _build.require_cuda(device)
    out = torch.empty((n_draws, 4, n_tiles * width), dtype=torch.int32, device=device)
    _build.launch("omt_philox_words", device, out.data_ptr(), seed, first_tile,
                  n_tiles, width, n_draws)
    return out.to(torch.int64) & _MASK32


def uniform_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """uint32 words (in int64) -> float32 uniforms in [0, 1)."""
    return ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0


def box_muller(u1: torch.Tensor, u2: torch.Tensor):
    """Two independent N(0, 1) from two uniforms; 1 - u1 in (0, 1]."""
    rad = torch.sqrt(-2.0 * torch.log(1.0 - u1))
    ang = _TWO_PI * u2
    return rad * torch.cos(ang), rad * torch.sin(ang)


def stream_normals(seed: int, first_tile: int, n_tiles: int, width: int,
                   n_normals: int, device=None) -> torch.Tensor:
    """The first ``n_normals`` normals of every slot: (n_normals, n_tiles * width)."""
    j, g = _slot_counters(first_tile, n_tiles, width, device)
    k0, k1 = seed & _MASK32, (seed >> 32) & _MASK32
    out = []
    for k in range((n_normals + 3) // 4):
        w = [uniform_from_bits(x) for x in philox4x32(j, k, g, 0, k0, k1)]
        out += [*box_muller(w[0], w[1]), *box_muller(w[2], w[3])]
    return torch.stack(out[:n_normals])


def mirror_tiles(z: torch.Tensor, n_tiles: int) -> torch.Tensor:
    """(n, n_tiles * half) slot normals -> (n, n_tiles * 2 * half) path
    normals, each tile laid out as [z, -z]."""
    zt = z.reshape(z.shape[0], n_tiles, -1)
    return torch.cat([zt, -zt], dim=2).reshape(z.shape[0], -1)


def path_normals(seed: int, first_tile: int, n_tiles: int, tile: int,
                 n_normals: int, antithetic: bool, device=None) -> torch.Tensor:
    """(n_normals, n_tiles * tile) normals in path order: one slot per
    antithetic pair (mirrored within its tile) or per path."""
    width = tile // 2 if antithetic else tile
    z = stream_normals(seed, first_tile, n_tiles, width, n_normals, device)
    return mirror_tiles(z, n_tiles) if antithetic else z


def qe_path_draws(seed: int, first_tile: int, n_tiles: int, tile: int,
                  n_steps: int, antithetic: bool, device=None):
    """(z_v, z_s, u), each (n_steps, n_tiles * tile) in path order: the
    QE-M layout of the module docstring, one Philox call per step."""
    width = tile // 2 if antithetic else tile
    j, g = _slot_counters(first_tile, n_tiles, width, device)
    k0, k1 = seed & _MASK32, (seed >> 32) & _MASK32
    z_v, z_s, u = [], [], []
    for t in range(n_steps):
        w0, w1, w2, _ = philox4x32(j, t, g, 0, k0, k1)
        a, b = box_muller(uniform_from_bits(w0), uniform_from_bits(w1))
        z_v.append(a)
        z_s.append(b)
        u.append(uniform_from_bits(w2))
    z_v, z_s, u = torch.stack(z_v), torch.stack(z_s), torch.stack(u)
    if not antithetic:
        return z_v, z_s, u
    ut = u.reshape(n_steps, n_tiles, width)
    u = torch.cat([ut, 1.0 - ut], dim=2).reshape(n_steps, -1)
    return mirror_tiles(z_v, n_tiles), mirror_tiles(z_s, n_tiles), u


def poisson_table(lam_dt: float) -> np.ndarray:
    """float32 CDF of Poisson(lam_dt), F(0), F(1), ..., up to (not
    including) the first entry that rounds to 1 in float32; empty at
    lam_dt = 0 (every count is 0). Summed in float64 from p_k = p_{k-1}
    lam_dt / k."""
    lam_dt = float(lam_dt)
    if not lam_dt >= 0.0 or not math.isfinite(lam_dt):
        raise ValueError(f"Poisson mean must be finite and non-negative, got {lam_dt}")
    out = []
    p = math.exp(-lam_dt)
    cdf = p
    k = 0
    while np.float32(cdf) < np.float32(1.0):
        if len(out) == MAX_POISSON_TABLE:
            raise ValueError(f"Poisson mean {lam_dt} needs more than {MAX_POISSON_TABLE} "
                             "table entries")
        out.append(np.float32(cdf))
        k += 1
        p *= lam_dt / k
        cdf += p
    return np.asarray(out, np.float32)


def poisson_from_uniform(u: torch.Tensor, table) -> torch.Tensor:
    """Poisson counts (in u's float dtype) of uniforms u in [0, 1): the
    number of entries of ``table`` (poisson_table) that u is not below."""
    n = torch.zeros_like(u)
    for f in np.asarray(table, np.float32).tolist():
        n += (u >= f).to(u.dtype)
    return n


def merton_path_draws(seed: int, first_tile: int, n_tiles: int, tile: int,
                      n_steps: int, antithetic: bool, device=None):
    """(z, u, z_j), each (n_steps, n_tiles * tile) in path order: the Merton
    layout of the module docstring, one Philox call per slot and step. u is
    the Poisson uniform of each path, never mirrored."""
    width = tile // 2 if antithetic else tile
    j, g = _slot_counters(first_tile, n_tiles, width, device)
    k0, k1 = seed & _MASK32, (seed >> 32) & _MASK32
    z, z_j, u_a, u_b = [], [], [], []
    for t in range(n_steps):
        w0, w1, w2, w3 = philox4x32(j, t, g, 0, k0, k1)
        a, b = box_muller(uniform_from_bits(w0), uniform_from_bits(w1))
        z.append(a)
        z_j.append(b)
        u_a.append(uniform_from_bits(w2))
        if antithetic:
            u_b.append(uniform_from_bits(w3))
    z, z_j, u = torch.stack(z), torch.stack(z_j), torch.stack(u_a)
    if not antithetic:
        return z, u, z_j
    ua = u.reshape(n_steps, n_tiles, width)
    ub = torch.stack(u_b).reshape(n_steps, n_tiles, width)
    u = torch.cat([ua, ub], dim=2).reshape(n_steps, -1)
    return mirror_tiles(z, n_tiles), u, mirror_tiles(z_j, n_tiles)


def jump_draws(seed: int, first_tile: int, n_tiles: int, tile: int, n_steps: int,
               terminal: bool = False, device=None):
    """(u, z_j) of the jump overlay's stream (counter word 3 =
    OVERLAY_STREAM), one Philox call per path and draw, in path order: each
    (n_steps, n_tiles * tile) for the path version (draws 0..n_steps-1), or
    (n_tiles * tile,) for the terminal overlay (draw n_steps)."""
    j, g = _slot_counters(first_tile, n_tiles, tile, device)
    k0, k1 = seed & _MASK32, (seed >> 32) & _MASK32
    u, z_j = [], []
    for t in ([n_steps] if terminal else range(n_steps)):
        w0, w1, w2, _ = philox4x32(j, t, g, OVERLAY_STREAM, k0, k1)
        z_j.append(box_muller(uniform_from_bits(w0), uniform_from_bits(w1))[0])
        u.append(uniform_from_bits(w2))
    if terminal:
        return u[0], z_j[0]
    return torch.stack(u), torch.stack(z_j)
