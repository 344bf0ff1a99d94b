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
layout (``path_normals``). ``draw_path_normals`` makes the same normals on
the card with the port's own kernel (csrc/philox.cu path_normals_kernel,
row 20 of the kernel table), for the local-vol route whose time loop runs
a network (models/localvol.py): its Box-Muller is kernels 7 and 8's
(hopper_fast.cuh box_muller_fast), so it gives their draws bit for bit and
path_normals's within that Box-Muller's ~3e-6.

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
other stream but the dual's uses 0. It draws nothing more from the caller's
generator.

The martingale dual's inner stream (``dual_inner_draws``, pricers/dual.py)
has a seed of its own, drawn from the caller's generator apart from the
simulation's (reusing the paths' randomness would break the martingale
property), and the fourth counter word DUAL_STREAM = 2: counter = (slot in
tile, draw, global tile, 2), one slot per *path* (the inner draws of a
path and of its mirror are independent), the tile the bracket's pair block.
A (date, path) takes n_inner / 2 antithetic inner pairs; draw = date x
calls a date + call. The diffusion calls come first, then the jump calls;
a date's calls count the jump calls of every family, and GBM and Heston
leave theirs undrawn:
- GBM: one call serves four pairs: (w0, w1) -> Box-Muller -> the z of
  pairs 4c, 4c + 1, (w2, w3) -> those of 4c + 2, 4c + 3;
- Heston: one call serves two pairs: (w0, w1) -> (z1, z2) of pair 2c,
  (w2, w3) -> (z1, z2) of pair 2c + 1;
- Merton: GBM's calls, then one jump call per two pairs: (w0, w1) ->
  Box-Muller -> the jump normals z_j of pairs 2c, 2c + 1; w2, w3 -> their
  Poisson uniforms;
- Bates: Heston's calls, then Merton's jump calls.
The pair's members take (z, z_j) and (-z, -z_j) and share the count, as in
the reference (dual.py:593-613, 714-724). With no jump (lam = 0) Merton's
and Bates's diffusion draws are GBM's and Heston's bit for bit.

The Variance Gamma stream (``vg_path_draws``, models/vg.py) has the fourth
counter word VG_STREAM = 3 and VG_DRAWS_A_STEP draws a step: draw t
VG_DRAWS_A_STEP is the step's normal, keyed by the antithetic *pair* slot
(w0, w1) -> Box-Muller -> its first normal z, mirrored within the tile as
[z, -z]; draws t VG_DRAWS_A_STEP + 1 + k are attempt k of the step's gamma
clock, keyed by the *path* slot (a gamma variate has no mirror), attempt
k's (w0, w1) -> Box-Muller -> the Marsaglia-Tsang normal x, w2 -> its
acceptance uniform, w3 -> the boost uniform. So the counter is a function
of (seed, tile, slot, step, attempt) only. The gamma sampler
(``gamma_from_stream``) is Marsaglia and Tsang (2000) at shape s = a for a
>= 1 and s = a + 1 for a < 1, with d = s - 1/3 and c = 1 / sqrt(9 d): it
accepts the first attempt with 1 + c x > 0 and log(u) < x^2/2 + d - d v +
d log(v), v = (1 + c x)^3, and gives d v; below a = 1 the boost gives
exp(log(d v) + log(U) / a), the division a multiplication by the host's
float32 1 / a. At a ~ 0.01 about 4 draws in 10 lie below float32's
smallest normal number: they come out subnormal or 0, never NaN or inf.
Each operation is one IEEE float32 operation in this order, and the kernels
(csrc/vg.cu) repeat it with never-contracted intrinsics, so both make the
same accept decision. After VG_MAX_ATTEMPTS rejections (probability below
1e-19 at every shape) the draw is d.

The dual's inner stream also serves the Variance Gamma, SABR and rough
Bergomi brackets:
- VG: GBM's calls for the pair's normal z, then one standard Gamma(a)
  clock draw a pair, shared by the pair's two members (a = dt / nu). Its
  Marsaglia-Tsang attempts have counters of their own, on the fourth
  counter word DUAL_GAMMA_STREAM = 5: attempt k of pair i at date t is the
  call (slot in tile, (t half + i) VG_MAX_ATTEMPTS + k, global tile, 5),
  decided as ``gamma_from_stream`` decides (the same float32 test in the
  same order), so a draw's value and its attempt count are a function of
  (seed, tile, date, pair, attempt);
- SABR: Heston's calls, (z1, z2) a pair;
- rough Bergomi: one call a pair, (w0, w1) -> (z1, z2) and (w2, w3) ->
  (zp, unused): the Volterra Brownian's, the singular term's and the
  price's normals.

The rough Bergomi stream (``rbergomi_path_draws``, models/rbergomi.py) has
the fourth counter word RBERGOMI_STREAM = 4 and two Philox calls per pair
slot and step: draw 2t, (w0, w1) -> Box-Muller -> its first normal z1 (the
Brownian increment dW = sqrt(dt) z1); draw 2t + 1, (w0, w1) -> (z2, zp)
(the singular interval's orthogonal part and the price's orthogonal
Brownian). All three
are mirrored within the tile. The fused rough Bergomi kernel makes both
calls once a pair (csrc/rbergomi.cu); its first design drew z1 in kernel 25
and z2, zp in kernel 26, each on its own counters.

The SABR stream (``sabr_path_draws``, models/sabr.py) takes the main
stream's counters (word 3 = 0) and one Philox call per pair slot and step:
(w0, w1) -> Box-Muller -> (z1, z2), mirrored within the tile; w2 and w3
are unused. The forward and vol Brownian increments are z1 and rho z1 +
sqrt(1 - rho^2) z2.

The multi-asset GBM stream (``basket_path_draws``, models/multiasset.py)
has the fourth counter word BASKET_STREAM = 6 and ceil(n / 4) Philox calls
per slot and step for n assets: asset a's normal at step t is normal
a mod 4 of the call t ceil(n / 4) + a // 4, (w0, w1) -> Box-Muller ->
normals 0 and 1, (w2, w3) -> normals 2 and 3. So a normal is a function of
(seed, global tile, slot, step, asset). With antithetics slot j of a tile
drives path j and its mirror j + tile/2 with -z for every asset: the whole
correlated vector is mirrored, as in the reference
(options_model_tpu/models/multiasset.py:55-58).

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
# Fourth counter word of the jump overlay's stream and of the martingale
# dual's inner stream (every other stream: 0).
OVERLAY_STREAM = 1
DUAL_STREAM = 2
# The Variance Gamma stream's fourth counter word, its gamma attempts a step
# and its draws a step (the normal, then the attempts).
VG_STREAM = 3
VG_MAX_ATTEMPTS = 15
VG_DRAWS_A_STEP = 1 + VG_MAX_ATTEMPTS
# The rough Bergomi stream's and the dual's gamma attempts' counter words.
RBERGOMI_STREAM = 4
DUAL_GAMMA_STREAM = 5
# The multi-asset GBM stream's counter word.
BASKET_STREAM = 6
# Inner pairs one Philox call of the dual's stream serves: the diffusion
# calls per family, the jump calls of Merton and Bates.
DUAL_PAIRS_A_CALL = {"gbm": 4, "merton": 4, "heston": 2, "bates": 2, "vg": 4, "sabr": 2,
                     "rbergomi": 1}
DUAL_JUMP_PAIRS_A_CALL = 2
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
                 n_draws: int, device=None, stream: int = 0) -> torch.Tensor:
    """Raw Philox words (n_draws, 4, n_tiles * width) as int64 in [0, 2^32),
    counter word 3 = ``stream``."""
    j, g = _slot_counters(first_tile, n_tiles, width, device)
    k0, k1 = seed & _MASK32, (seed >> 32) & _MASK32
    return torch.stack([torch.stack(philox4x32(j, k, g, stream, k0, k1))
                        for k in range(n_draws)])


def stream_words_cuda(seed: int, first_tile: int, n_tiles: int, width: int,
                      n_draws: int, device, stream: int = 0) -> torch.Tensor:
    """The same words as ``stream_words``, drawn on the card by the kernels'
    own Philox (csrc/philox.cu): the bit-for-bit check of csrc/philox.cuh."""
    from options_model_tpu_torch.ops import _build

    device = torch.device(device)
    _build.require_cuda(device)
    out = torch.empty((n_draws, 4, n_tiles * width), dtype=torch.int32, device=device)
    _build.launch("omt_philox_words", device, out.data_ptr(), seed, first_tile,
                  n_tiles, width, n_draws, stream)
    return out.to(torch.int64) & _MASK32


def sincos_check_cuda(device) -> torch.Tensor:
    """(4, 2^23) float32 on the card: sinf, cosf and csrc/philox.cuh's
    sincos_stream_angle (sine, cosine) at every angle float(2 pi) u2 of the
    stream's uniforms u2 = i 2^-23 (csrc/philox.cu), for holding the
    replica against sinf and cosf bit for bit."""
    from options_model_tpu_torch.ops import _build

    device = torch.device(device)
    _build.require_cuda(device)
    out = torch.empty((4, 1 << 23), dtype=torch.float32, device=device)
    _build.launch("omt_sincos_check", device, out.data_ptr())
    return out


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


# Launches of the normals kernel since the last reset.
launches = {"path_normals": 0}


def draw_path_normals(seed: int, first_tile: int, n_tiles: int, tile: int, n_normals: int,
                      antithetic: bool, device=None) -> torch.Tensor:
    """``path_normals`` on ``device`` (the card by default): the plain
    version for a CPU device, csrc/philox.cu's path_normals_kernel for a
    CUDA device (raising without CUDA; no fallback)."""
    from options_model_tpu_torch.ops import _build
    from options_model_tpu_torch.ops.engine import resolve_device

    device = resolve_device(device)
    if device.type == "cpu":
        return path_normals(seed, first_tile, n_tiles, tile, n_normals, antithetic, device)
    _build.require_cuda(device)
    _build.check_launch(seed, first_tile, n_tiles, n_normals)
    if antithetic and tile % 2:
        raise ValueError(f"an antithetic tile must be even, got {tile}")
    if (n_normals + 3) // 4 > 65535:
        raise ValueError(f"{n_normals} normals a path exceed the kernel's grid (4 x 65535)")
    out = torch.empty((n_normals, n_tiles * tile), dtype=torch.float32, device=device)
    _build.launch("omt_path_normals", device, out.data_ptr(), seed, first_tile, n_tiles, tile,
                  n_normals, int(antithetic))
    launches["path_normals"] += 1
    return out


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


def dual_calls(model: str, half: int) -> tuple:
    """(diffusion calls, jump calls, calls a date) of a (date, path) of the
    dual's inner stream for ``half`` antithetic inner pairs under
    ``model``: a date's calls count the jump calls whether or not the
    family draws them."""
    if model not in DUAL_PAIRS_A_CALL:
        raise ValueError(f"the dual's inner stream draws for {', '.join(DUAL_PAIRS_A_CALL)}, "
                         f"got {model!r}")
    if half < 1:
        raise ValueError(f"need at least one inner pair, got {half}")
    diff = -(-half // DUAL_PAIRS_A_CALL[model])
    jump = -(-half // DUAL_JUMP_PAIRS_A_CALL)
    return diff, jump if model in ("merton", "bates") else 0, diff + jump


def dual_inner_draws(seed: int, first_tile: int, n_tiles: int, tile: int, half: int,
                     model: str, date: int, lam_dt: float = 0.0, device=None,
                     gamma_shape: float = 1.0) -> dict:
    """The dual's inner draws of one date (the module docstring's layout),
    each (half, n_tiles * tile) in path order: "z" (GBM, Merton, VG), "z1",
    "z2" (Heston, Bates, SABR) or "z1", "z2", "zp" (rough Bergomi); under
    the jumps "u" (the Poisson uniforms), "n" (their counts against
    poisson_table(lam_dt), float32) and "zj"; under VG "gamma" (standard
    Gamma(gamma_shape) clock draws, dual_gamma_draws) and "attempts"."""
    diff, jump, calls = dual_calls(model, half)
    j, g = _slot_counters(first_tile, n_tiles, tile, device)
    k0, k1 = seed & _MASK32, (seed >> 32) & _MASK32

    def call(c):
        w = philox4x32(j, date * calls + c, g, DUAL_STREAM, k0, k1)
        return [uniform_from_bits(x) for x in w]

    normals = []
    for c in range(diff):
        w = call(c)
        normals += [*box_muller(w[0], w[1]), *box_muller(w[2], w[3])]
    per = DUAL_PAIRS_A_CALL[model]
    if per == 4:
        out = {"z": torch.stack(normals[:half])}
    elif per == 2:
        out = {"z1": torch.stack(normals[0::2][:half]), "z2": torch.stack(normals[1::2][:half])}
    else:
        out = {"z1": torch.stack(normals[0::4]), "z2": torch.stack(normals[1::4]),
               "zp": torch.stack(normals[2::4])}
    if model == "vg":
        out["gamma"], out["attempts"] = dual_gamma_draws(seed, first_tile, n_tiles, tile, half,
                                                         date, gamma_shape, device)
    if jump:
        zj, u = [], []
        for c in range(jump):
            w = call(diff + c)
            zj += box_muller(w[0], w[1])
            u += [w[2], w[3]]
        out["u"] = torch.stack(u[:half])
        out["n"] = poisson_from_uniform(out["u"], poisson_table(lam_dt))
        out["zj"] = torch.stack(zj[:half])
    return out


def gamma_constants(a: float) -> dict:
    """float32 constants of the Marsaglia-Tsang sampler at gamma shape a > 0
    (csrc/vg.cu reads the same floats): d = s - 1/3 and c = 1 / sqrt(9 d) at
    s = a (a >= 1) or a + 1 (a < 1, ``boost``), and inv_a = 1 / a."""
    f = np.float32
    a = f(a)
    if not a > 0 or not np.isfinite(a):
        raise ValueError(f"the gamma shape must be positive and finite, got {a}")
    boost = bool(a < f(1.0))
    s = a + f(1.0) if boost else a
    d = s - f(1.0 / 3.0)
    return dict(d=d, c=f(1.0) / np.sqrt(f(9.0) * d), inv_a=f(1.0) / a, boost=boost)


def _vg_words(seed: int, first_tile: int, n_tiles: int, width: int, draw: int, device):
    j, g = _slot_counters(first_tile, n_tiles, width, device)
    return philox4x32(j, draw, g, VG_STREAM, seed & _MASK32, (seed >> 32) & _MASK32)


def _gamma_attempts(words_at, shape, a: float, device):
    """Marsaglia-Tsang draws of standard Gamma(a), one per element of
    ``shape``, attempt ``att`` on the Philox words ``words_at(att)`` (the
    module docstring's sampler): (values, accepting attempts int32,
    VG_MAX_ATTEMPTS where none did). Every attempt is drawn full width; a
    lane keeps its first acceptance."""
    k = gamma_constants(a)
    t = lambda v: torch.tensor(v, dtype=torch.float32, device=device)  # noqa: E731
    d, c, inv_a = t(k["d"]), t(k["c"]), t(k["inv_a"])
    out = torch.empty(shape, dtype=torch.float32, device=device)
    attempts = torch.full(shape, VG_MAX_ATTEMPTS, dtype=torch.int32, device=device)
    done = torch.zeros(shape, dtype=torch.bool, device=device)
    for att in range(VG_MAX_ATTEMPTS):
        w0, w1, w2, w3 = words_at(att)
        x = box_muller(uniform_from_bits(w0), uniform_from_bits(w1))[0]
        v1 = 1.0 + c * x
        v = v1 * v1 * v1
        rhs = 0.5 * x * x + d - d * v + d * torch.log(v)
        acc = (v1 > 0) & (torch.log(uniform_from_bits(w2)) < rhs) & ~done
        g = d * v
        if k["boost"]:
            g = torch.exp(torch.log(g) + torch.log(uniform_from_bits(w3)) * inv_a)
        out = torch.where(acc, g, out)
        attempts = torch.where(acc, torch.tensor(att, dtype=torch.int32, device=device),
                               attempts)
        done = done | acc
        if bool(done.all()):
            break
    return torch.where(done, out, d), attempts


def gamma_from_stream(seed: int, first_tile: int, n_tiles: int, tile: int, step: int, a: float,
                      device=None, return_attempts: bool = False):
    """Standard Gamma(a) variates (n_tiles * tile,) of one step of the VG
    stream, one a path (the module docstring's sampler), in path order [and
    the attempt each accepted, int32, VG_MAX_ATTEMPTS where none did]."""
    out, attempts = _gamma_attempts(
        lambda att: _vg_words(seed, first_tile, n_tiles, tile,
                              step * VG_DRAWS_A_STEP + 1 + att, device),
        (n_tiles * tile,), a, device)
    return (out, attempts) if return_attempts else out


def dual_gamma_draws(seed: int, first_tile: int, n_tiles: int, tile: int, half: int, date: int,
                     a: float, device=None):
    """The VG dual's standard Gamma(a) clock draws of one date, one per
    inner pair and path: (gamma, attempts), each (half, n_tiles * tile) in
    path order; attempt k of pair i is the call (slot in tile, (date half +
    i) VG_MAX_ATTEMPTS + k, global tile, DUAL_GAMMA_STREAM)."""
    j, g = _slot_counters(first_tile, n_tiles, tile, device)
    k0, k1 = seed & _MASK32, (seed >> 32) & _MASK32
    pairs = torch.arange(half, device=device, dtype=torch.int64)[:, None]
    base = (date * half + pairs) * VG_MAX_ATTEMPTS
    shape = (half, n_tiles * tile)
    return _gamma_attempts(
        lambda att: [w.expand(shape) for w in philox4x32(j, base + att, g, DUAL_GAMMA_STREAM,
                                                          k0, k1)],
        shape, a, device)


def rbergomi_path_draws(seed: int, first_tile: int, n_tiles: int, tile: int, n_steps: int,
                        antithetic: bool = True, device=None, which: str = "z1 z2 zp"):
    """(z1, z2, zp), each (n_steps, n_tiles * tile) in path order: the rough
    Bergomi stream of the module docstring (counter word 3 =
    RBERGOMI_STREAM), mirrored within the tile when ``antithetic``.
    ``which`` names the normals to return, in that order."""
    width = tile // 2 if antithetic else tile
    j, g = _slot_counters(first_tile, n_tiles, width, device)
    k0, k1 = seed & _MASK32, (seed >> 32) & _MASK32
    names = which.split()
    rows = {n: [] for n in names}
    for t in range(n_steps):
        if "z1" in rows:
            w0, w1, _, _ = philox4x32(j, 2 * t, g, RBERGOMI_STREAM, k0, k1)
            rows["z1"].append(box_muller(uniform_from_bits(w0), uniform_from_bits(w1))[0])
        if "z2" in rows or "zp" in rows:
            w0, w1, _, _ = philox4x32(j, 2 * t + 1, g, RBERGOMI_STREAM, k0, k1)
            z2, zp = box_muller(uniform_from_bits(w0), uniform_from_bits(w1))
            for n, z in (("z2", z2), ("zp", zp)):
                if n in rows:
                    rows[n].append(z)
    out = []
    for n in names:
        z = torch.stack(rows[n])
        out.append(mirror_tiles(z, n_tiles) if antithetic else z)
    return tuple(out)


def vg_path_draws(seed: int, first_tile: int, n_tiles: int, tile: int, n_steps: int, a: float,
                  antithetic: bool, device=None, return_attempts: bool = False):
    """(z, gamma[, attempts]), each (n_steps, n_tiles * tile) in path order:
    the VG stream's normals (mirrored within the tile when ``antithetic``)
    and its standard Gamma(a) clock increments, drawn for every path."""
    width = tile // 2 if antithetic else tile
    z, gam, att = [], [], []
    for t in range(n_steps):
        w0, w1, _, _ = _vg_words(seed, first_tile, n_tiles, width, t * VG_DRAWS_A_STEP, device)
        z.append(box_muller(uniform_from_bits(w0), uniform_from_bits(w1))[0])
        g, k = gamma_from_stream(seed, first_tile, n_tiles, tile, t, a, device, True)
        gam.append(g)
        att.append(k)
    z = torch.stack(z)
    if antithetic:
        z = mirror_tiles(z, n_tiles)
    out = (z, torch.stack(gam))
    return out + (torch.stack(att),) if return_attempts else out


def sabr_path_draws(seed: int, first_tile: int, n_tiles: int, tile: int, n_steps: int,
                    antithetic: bool, device=None):
    """(z1, z2), each (n_steps, n_tiles * tile) in path order: the SABR
    layout of the module docstring, one Philox call per slot and step."""
    width = tile // 2 if antithetic else tile
    j, g = _slot_counters(first_tile, n_tiles, width, device)
    k0, k1 = seed & _MASK32, (seed >> 32) & _MASK32
    z1, z2 = [], []
    for t in range(n_steps):
        w0, w1, _, _ = philox4x32(j, t, g, 0, k0, k1)
        a, b = box_muller(uniform_from_bits(w0), uniform_from_bits(w1))
        z1.append(a)
        z2.append(b)
    z1, z2 = torch.stack(z1), torch.stack(z2)
    if antithetic:
        return mirror_tiles(z1, n_tiles), mirror_tiles(z2, n_tiles)
    return z1, z2


def basket_calls(n_assets: int) -> int:
    """Philox calls a slot makes per step for ``n_assets`` normals."""
    return (n_assets + 3) // 4


def basket_path_draws(seed: int, first_tile: int, n_tiles: int, tile: int, n_steps: int,
                      n_assets: int, antithetic: bool, device=None) -> torch.Tensor:
    """(n_steps, n_assets, n_tiles * tile) uncorrelated normals in path
    order: the multi-asset GBM stream of the module docstring (counter word 3
    = BASKET_STREAM), every asset's normal mirrored within the tile when
    ``antithetic``."""
    width = tile // 2 if antithetic else tile
    j, g = _slot_counters(first_tile, n_tiles, width, device)
    k0, k1 = seed & _MASK32, (seed >> 32) & _MASK32
    calls = basket_calls(n_assets)
    rows = []
    for t in range(n_steps):
        z = []
        for c in range(calls):
            w = [uniform_from_bits(x)
                 for x in philox4x32(j, t * calls + c, g, BASKET_STREAM, k0, k1)]
            z += [*box_muller(w[0], w[1]), *box_muller(w[2], w[3])]
        rows.append(torch.stack(z[:n_assets]))
    z = torch.stack(rows)
    if not antithetic:
        return z
    zt = z.reshape(n_steps, n_assets, n_tiles, width)
    return torch.cat([zt, -zt], dim=3).reshape(n_steps, n_assets, n_tiles * tile)
