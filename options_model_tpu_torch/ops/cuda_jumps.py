"""The jump kernels of csrc/jumps.cu and their plain PyTorch versions:
- 14 ``merton_paths`` / ``merton_paths_batched`` and 15 ``merton_terminal``:
  the Merton walk, the counterparts of options_model_tpu/models/merton.py:27
  simulate_merton (return_paths True and False). Both are Hopper redesigns
  (merton_paths_kernel: one launch over a batch of maturities, maturity m on
  tiles first_tile + m n_tiles + ..; merton_terminal_kernel); their first
  designs stay under ``merton_paths_first`` and ``merton_terminal_first`` as
  the yardsticks, and no pricer reaches them;
- 16 ``jump_overlay_paths`` and 17 ``jump_overlay_terminal``: the Bates jump
  overlay multiplied in place into a Heston kernel's S (or S_T), the
  counterparts of options_model_tpu/models/bates.py:40 jump_overlay; both
  are Hopper redesigns (overlay_paths_kernel; overlay_terminal_kernel, four
  values a thread over a grid of whole waves, ``overlay_terminal_blocks``),
  their first designs stay under ``jump_overlay_paths_first`` and
  ``jump_overlay_terminal_first``, reached by no pricer.
The JAX package computes these in XLA code (no Pallas kernel). The wrappers
take the plain version for a CPU tensor or device and launch the kernel for
a CUDA one; there is no fallback between the two. The first designs run on
a CUDA device only.

Every launch reads its constants from 128-float rows on the card (``ROW``:
a, diffusion, mu_j, sigma_j, log S0, the Poisson table's length, the
table's head F(0), F(1) (poisson_head), then the table of
ops/philox.poisson_table), built on the host and copied through pinned
memory, so the host does not wait for the work already queued on the
stream. ``return_counts`` also returns each draw's Poisson count (int32),
from the kernel's debug output or the plain version, so the two can be
held against each other bit for bit.

Streams (ops/philox.py): Merton on counter word 3 = 0, one call per pair
(or path) and step; the overlay on word 3 = 1 with the Heston kernel's seed
and tiles, one call per path and step (terminal: one per path, at draw
n_steps). A run at ``first_tile`` reproduces those tiles of a longer run
bit for bit.
"""

from __future__ import annotations

import functools
from collections import Counter

import numpy as np
import torch

from options_model_tpu_torch.models.bates import overlay_constants, overlay_from_draws
from options_model_tpu_torch.models.blocks import round_up
from options_model_tpu_torch.models.merton import merton_constants, merton_from_draws
from options_model_tpu_torch.ops import _build
from options_model_tpu_torch.ops.cuda_heston import PATH_TILE, TERMINAL_TILE, _maturities, _tiles
from options_model_tpu_torch.ops.engine import resolve_device
from options_model_tpu_torch.ops.philox import (MAX_POISSON_TABLE, jump_draws,
                                                merton_path_draws, poisson_from_uniform,
                                                poisson_table)

# Kernel launches since the last reset, one integer per kernel.
launches = {"merton_paths": 0, "merton_paths_first": 0, "merton_terminal": 0,
            "merton_terminal_first": 0, "jump_overlay_paths": 0, "jump_overlay_paths_first": 0,
            "jump_overlay_terminal": 0, "jump_overlay_terminal_first": 0}
# Kernel 14's launches since the last reset, by (n_mat, n_pad, n_steps).
shape_launches = Counter()
# Floats of a constants row before its table, and in all (csrc/jumps.cu
# kHead, kRow = 128).
HEAD = 8
ROW = HEAD + MAX_POISSON_TABLE
# The Poisson head of the redesigned kernels (csrc/jumps.cu kHeadCdf: the
# CDF entries a thread compares against, F(0) and F(1); the terminal kernel
# takes it by value in its PoissonHead, the paths kernels from slots 6 and 7
# of each row) and the counts whose square root the terminal kernel takes
# from a table.
POISSON_HEAD = 2
SQRT_TABLE = 16
# Kernel 17's redesign: values a thread (one 16-byte vector) and threads a
# block (csrc/jumps.cu kOverlayVec, kBlock).
OVERLAY_VEC = 4
OVERLAY_BLOCK = 128


@functools.lru_cache(maxsize=1024)
def _poisson_slots(lam_dt: float) -> np.ndarray:
    """Slots 5 on of a constants row for Poisson(lam_dt): the table's length,
    its head (poisson_head) and the table, zero-padded; read-only and
    cached, since a batched launch builds one row a maturity."""
    table = poisson_table(lam_dt)
    slots = np.concatenate([[table.size], poisson_head(table)[:POISSON_HEAD], table,
                            np.zeros(MAX_POISSON_TABLE - table.size)]).astype(np.float32)
    slots.flags.writeable = False
    return slots


def const_row(a, diffusion, mu_j, sigma_j, log_s0, lam_dt: float) -> np.ndarray:
    """One launch's (or maturity's) float32 constants row, its Poisson table
    that of Poisson(lam_dt) and its head that table's (poisson_head)."""
    return np.concatenate([np.float32([a, diffusion, mu_j, sigma_j, log_s0]),
                           _poisson_slots(float(lam_dt))])


def sqrt_table() -> np.ndarray:
    """IEEE float32 square roots of the counts 0..SQRT_TABLE-1, the bits of
    sqrtf and torch.sqrt."""
    return np.sqrt(np.arange(SQRT_TABLE, dtype=np.float32))


def poisson_head(table) -> np.ndarray:
    """The redesigned terminal kernel's PoissonHead for a Poisson table
    (poisson_table): its first POISSON_HEAD entries, padded with 2 (above
    every uniform) past the table's end, then sqrt_table(). Its first
    POISSON_HEAD floats are also a constants row's head."""
    table = np.asarray(table, np.float32)
    head = np.full(POISSON_HEAD, 2.0, np.float32)
    head[:min(table.size, POISSON_HEAD)] = table[:POISSON_HEAD]
    return np.concatenate([head, sqrt_table()])


def device_rows(rows, device) -> torch.Tensor:
    """(n, ROW) float32 rows on ``device``, through pinned memory for a CUDA one."""
    out = torch.from_numpy(np.stack(rows))
    if torch.device(device).type == "cuda":
        out = out.pin_memory()
    return out.to(device, non_blocking=True)


def _overlay_row(T, jumps, n_steps: int, terminal: bool = False) -> np.ndarray:
    c = overlay_constants(T, jumps, n_steps, terminal)
    return const_row(c["a"], 0.0, c["mu_j"], c["sigma_j"], 0.0, c["lam_dt"])


def _merton_row(S0, r, T, params, n_steps: int) -> np.ndarray:
    c = merton_constants(S0, r, T, params, n_steps)
    return const_row(c["drift"], c["diffusion"], c["mu_j"], c["sigma_j"], c["log_s0"],
                     c["lam_dt"])


def _merton_reference(tile, seed, S0, r, T, params, n_paths, n_steps, antithetic, first_tile,
                      device, return_counts, return_paths):
    n_tiles = _tiles(n_paths, tile, seed, first_tile, n_steps)
    z, u, z_j = merton_path_draws(seed, first_tile, n_tiles, tile, n_steps, antithetic,
                                  device)
    n = poisson_from_uniform(u, poisson_table(merton_constants(S0, r, T, params,
                                                               n_steps)["lam_dt"]))
    S = merton_from_draws(z, n, z_j, S0, r, T, params, return_paths)
    return (S, n.to(torch.int32)) if return_counts else S


def merton_paths_reference(seed: int, S0, r, T, params, n_paths: int, n_steps: int,
                           antithetic: bool = True, first_tile: int = 0, device=None,
                           return_counts: bool = False):
    """Plain version of kernel 14 at one maturity: S (n_steps+1, n_pad) [and
    the counts (n_steps, n_pad)], n_pad = n_paths rounded up to PATH_TILE."""
    return _merton_reference(PATH_TILE, seed, S0, r, T, params, n_paths, n_steps, antithetic,
                             first_tile, device, return_counts, True)


def merton_paths_batched_reference(seed: int, S0, r, Ts, params, n_paths: int, n_steps: int,
                                   antithetic: bool = True, first_tile: int = 0, device=None,
                                   return_counts: bool = False):
    """Plain version of kernel 14's batched launch: maturity m is
    merton_paths_reference at first_tile + m n_tiles, stacked into (n_mat,
    n_steps+1, n_pad) [and the counts (n_mat, n_steps, n_pad)]."""
    Ts = _maturities(Ts)
    n_tiles = round_up(n_paths, PATH_TILE) // PATH_TILE
    _build.check_launch(seed, first_tile, len(Ts) * n_tiles, n_steps)
    outs = [merton_paths_reference(seed, S0, r, T, params, n_paths, n_steps, antithetic,
                                   first_tile + m * n_tiles, device, return_counts)
            for m, T in enumerate(Ts)]
    if return_counts:
        return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])
    return torch.stack(outs)


def merton_terminal_reference(seed: int, S0, r, T, params, n_paths: int, n_steps: int,
                              antithetic: bool = True, first_tile: int = 0, device=None,
                              return_counts: bool = False):
    """Plain version of kernel 15: S_T (n_pad,) [and the counts (n_steps,
    n_pad)], n_pad = n_paths rounded up to TERMINAL_TILE."""
    return _merton_reference(TERMINAL_TILE, seed, S0, r, T, params, n_paths, n_steps,
                             antithetic, first_tile, device, return_counts, False)


def _merton_launch(name: str, tile: int, head: bool, seed, S0, r, T, params, n_paths,
                   n_steps, antithetic, first_tile, device, return_counts):
    """One launch of C entry omt_``name`` on a CUDA device: S (n_steps+1,
    n_pad) for PATH_TILE tiles, S_T (n_pad,) for TERMINAL_TILE ones [and the
    counts (n_steps, n_pad)]; ``head``: the launch also takes the
    constants row's PoissonHead (poisson_head)."""
    _build.require_cuda(device)
    n_tiles = _tiles(n_paths, tile, seed, first_tile, n_steps)
    n_pad = n_tiles * tile
    out = torch.empty((n_steps + 1, n_pad) if tile == PATH_TILE else (n_pad,),
                      dtype=torch.float32, device=device)
    counts = (torch.empty((n_steps, n_pad), dtype=torch.int32, device=device)
              if return_counts else None)
    row = _merton_row(S0, r, T, params, n_steps)
    consts = device_rows([row], device)
    extra = (_build.float_args(poisson_head(row[HEAD:HEAD + int(row[5])])),) if head else ()
    _build.launch(f"omt_{name}", device, out.data_ptr(),
                  None if counts is None else counts.data_ptr(), consts.data_ptr(), *extra,
                  seed, first_tile, n_tiles, n_steps, int(antithetic))
    launches[name] += 1
    return (out, counts) if return_counts else out


def merton_rows(S0, r, Ts, params, n_steps: int) -> np.ndarray:
    """Kernel 14's (n_mat, ROW) float32 constants, built for every maturity
    at once (merton_constants elementwise): row m is maturity m's
    single-launch row (its own drift, diffusion, Poisson table and head),
    bit for bit."""
    c = merton_constants(S0, r, np.asarray(_maturities(Ts), np.float32), params, n_steps)
    rows = np.empty((c["drift"].size, ROW), np.float32)
    for i, k in enumerate(("drift", "diffusion", "mu_j", "sigma_j", "log_s0")):
        rows[:, i] = c[k]
    for m, lam_dt in enumerate(c["lam_dt"].tolist()):
        rows[m, 5:] = _poisson_slots(lam_dt)
    return rows


def merton_paths_batched(seed: int, S0, r, Ts, params, n_paths: int, n_steps: int,
                         antithetic: bool = True, first_tile: int = 0, device=None,
                         return_counts: bool = False):
    """Merton path matrices of every maturity in ``Ts``, (n_mat, n_steps+1,
    n_pad) [and the counts (n_mat, n_steps, n_pad)], from one launch of
    kernel 14 (csrc/jumps.cu merton_paths_kernel), or from the plain version
    for a CPU device. Maturity m draws tiles [first_tile + m n_tiles,
    first_tile + (m+1) n_tiles) of the seed's stream, so it equals a
    single-maturity run at that first_tile."""
    device = resolve_device(device)
    if device.type == "cpu":
        return merton_paths_batched_reference(seed, S0, r, Ts, params, n_paths, n_steps,
                                              antithetic, first_tile, device, return_counts)
    _build.require_cuda(device)
    Ts = _maturities(Ts)
    n_tiles = round_up(n_paths, PATH_TILE) // PATH_TILE
    _build.check_launch(seed, first_tile, len(Ts) * n_tiles, n_steps)
    n_pad = n_tiles * PATH_TILE
    S = torch.empty((len(Ts), n_steps + 1, n_pad), dtype=torch.float32, device=device)
    counts = (torch.empty((len(Ts), n_steps, n_pad), dtype=torch.int32, device=device)
              if return_counts else None)
    consts = device_rows(merton_rows(S0, r, Ts, params, n_steps), device)
    _build.launch("omt_merton_paths", device, S.data_ptr(),
                  None if counts is None else counts.data_ptr(), consts.data_ptr(), seed,
                  first_tile, n_tiles, n_steps, len(Ts), int(antithetic))
    launches["merton_paths"] += 1
    shape_launches[len(Ts), n_pad, n_steps] += 1
    return (S, counts) if return_counts else S


def merton_paths(seed: int, S0, r, T, params, n_paths: int, n_steps: int,
                 antithetic: bool = True, first_tile: int = 0, device=None,
                 return_counts: bool = False):
    """Merton path matrix S (n_steps+1, n_pad) [and the counts]: the batched
    launch of kernel 14 at one maturity, or the plain version for a CPU
    device."""
    out = merton_paths_batched(seed, S0, r, [T], params, n_paths, n_steps, antithetic,
                               first_tile, device, return_counts)
    return (out[0][0], out[1][0]) if return_counts else out[0]


def merton_paths_first(seed: int, S0, r, T, params, n_paths: int, n_steps: int,
                       antithetic: bool = True, first_tile: int = 0, device=None,
                       return_counts: bool = False):
    """merton_paths through kernel 14's first design (merton_kernel<true, *>,
    one maturity a launch), the redesign's yardstick, on a CUDA device only."""
    return _merton_launch("merton_paths_first", PATH_TILE, False, seed, S0, r, T, params,
                          n_paths, n_steps, antithetic, first_tile, resolve_device(device),
                          return_counts)


def merton_terminal(seed: int, S0, r, T, params, n_paths: int, n_steps: int,
                    antithetic: bool = True, first_tile: int = 0, device=None,
                    return_counts: bool = False):
    """Merton terminal prices S_T (n_pad,) from kernel 15's redesign
    (csrc/jumps.cu merton_terminal_kernel), or from its plain version for a
    CPU device."""
    device = resolve_device(device)
    if device.type == "cpu":
        return merton_terminal_reference(seed, S0, r, T, params, n_paths, n_steps,
                                         antithetic, first_tile, device, return_counts)
    return _merton_launch("merton_terminal", TERMINAL_TILE, True, seed, S0, r, T, params,
                          n_paths, n_steps, antithetic, first_tile, device, return_counts)


def merton_terminal_first(seed: int, S0, r, T, params, n_paths: int, n_steps: int,
                          antithetic: bool = True, first_tile: int = 0, device=None,
                          return_counts: bool = False):
    """merton_terminal through kernel 15's first design (merton_kernel<false,
    *>), the redesign's yardstick, on a CUDA device only."""
    return _merton_launch("merton_terminal_first", TERMINAL_TILE, False, seed, S0, r, T,
                          params, n_paths, n_steps, antithetic, first_tile,
                          resolve_device(device), return_counts)


def _maturity_list(Ts, n_mat: int) -> list:
    Ts = _maturities(Ts)
    if len(Ts) != n_mat:
        raise ValueError(f"{len(Ts)} maturities for {n_mat} path matrices")
    return Ts


def _as_batch(S: torch.Tensor, tile: int) -> torch.Tensor:
    """S as (n_mat, n_steps+1, n_pad), checking that it is the float32,
    contiguous output of a paths kernel (n_pad a whole number of tiles)."""
    S3 = S if S.dim() == 3 else S[None]
    if S3.dim() != 3 or S3.dtype != torch.float32 or not S3.is_contiguous():
        raise ValueError("the overlay multiplies a contiguous float32 (n_steps+1, n_pad) or "
                         f"(n_mat, n_steps+1, n_pad) path matrix, got {tuple(S.shape)} "
                         f"{S.dtype}")
    if S3.shape[2] % tile or S3.shape[1] < 2:
        raise ValueError(f"path matrix width {S3.shape[2]} is not a whole number of "
                         f"{tile}-path tiles, or it has no step")
    return S3


def jump_overlay_paths_reference(S: torch.Tensor, seed: int, Ts, jumps, first_tile: int = 0,
                                 return_counts: bool = False):
    """Plain version of kernel 16, in place on S (n_steps+1, n_pad) or
    (n_mat, n_steps+1, n_pad); maturity m (of ``Ts``) on tiles first_tile +
    m n_tiles + ... Returns S [and the counts (n_mat, n_steps, n_pad) or
    (n_steps, n_pad)]."""
    S3 = _as_batch(S, PATH_TILE)
    n_mat, n_steps, n_pad = S3.shape[0], S3.shape[1] - 1, S3.shape[2]
    n_tiles = n_pad // PATH_TILE
    _build.check_launch(seed, first_tile, n_mat * n_tiles, n_steps)
    counts = []
    for m, T in enumerate(_maturity_list(Ts, n_mat)):
        u, z_j = jump_draws(seed, first_tile + m * n_tiles, n_tiles, PATH_TILE, n_steps,
                            device=S.device)
        n = poisson_from_uniform(u, poisson_table(overlay_constants(T, jumps,
                                                                    n_steps)["lam_dt"]))
        S3[m].mul_(overlay_from_draws(n, z_j, T, jumps, n_steps))
        counts.append(n.to(torch.int32))
    if not return_counts:
        return S
    return S, (torch.stack(counts) if S.dim() == 3 else counts[0])


def _overlay_paths_launch(name: str, S: torch.Tensor, seed: int, Ts, jumps, first_tile: int,
                          return_counts: bool):
    """One launch of C entry omt_``name`` on a CUDA S, in place."""
    _build.require_cuda(S.device)
    S3 = _as_batch(S, PATH_TILE)
    n_mat, n_steps, n_pad = S3.shape[0], S3.shape[1] - 1, S3.shape[2]
    n_tiles = n_pad // PATH_TILE
    _build.check_launch(seed, first_tile, n_mat * n_tiles, n_steps)
    consts = device_rows([_overlay_row(T, jumps, n_steps) for T in _maturity_list(Ts, n_mat)],
                         S.device)
    counts = (torch.empty((n_mat, n_steps, n_pad), dtype=torch.int32, device=S.device)
              if return_counts else None)
    _build.launch(f"omt_{name}", S.device, S3.data_ptr(),
                  None if counts is None else counts.data_ptr(), consts.data_ptr(), seed,
                  first_tile, n_tiles, n_steps, n_mat)
    launches[name] += 1
    if not return_counts:
        return S
    return S, (counts if S.dim() == 3 else counts[0])


def jump_overlay_paths(S: torch.Tensor, seed: int, Ts, jumps, first_tile: int = 0,
                       return_counts: bool = False):
    """Kernel 16 (csrc/jumps.cu overlay_paths_kernel) on a CUDA S, in place:
    S (n_steps+1, n_pad) of one maturity T = ``Ts``, or (n_mat, n_steps+1,
    n_pad) of the maturities ``Ts``, in one launch, maturity m on global
    tiles first_tile + m n_tiles + ..., as the batched Heston kernel drew
    them. The plain version for a CPU S. ``jumps`` carries lam, mu_j and
    sigma_j. Returns S [and the counts]."""
    if S.device.type == "cpu":
        return jump_overlay_paths_reference(S, seed, Ts, jumps, first_tile, return_counts)
    return _overlay_paths_launch("jump_overlay_paths", S, seed, Ts, jumps, first_tile,
                                 return_counts)


def jump_overlay_paths_first(S: torch.Tensor, seed: int, Ts, jumps, first_tile: int = 0,
                             return_counts: bool = False):
    """jump_overlay_paths through kernel 16's first design
    (overlay_paths_first_kernel), the redesign's yardstick, on a CUDA S only."""
    return _overlay_paths_launch("jump_overlay_paths_first", S, seed, Ts, jumps, first_tile,
                                 return_counts)


def _check_terminal(S_T: torch.Tensor) -> None:
    if (S_T.dim() != 1 or S_T.dtype != torch.float32 or not S_T.is_contiguous()
            or S_T.shape[0] % TERMINAL_TILE):
        raise ValueError("the terminal overlay multiplies a contiguous float32 (n_pad,) "
                         f"vector of whole {TERMINAL_TILE}-path tiles, got "
                         f"{tuple(S_T.shape)} {S_T.dtype}")


def jump_overlay_terminal_reference(S_T: torch.Tensor, seed: int, T, jumps, n_steps: int,
                                    first_tile: int = 0, return_counts: bool = False):
    """Plain version of kernel 17, in place on S_T (n_pad,): one (count,
    normal) pair per path at draw n_steps, N ~ Poisson(lam T)."""
    _check_terminal(S_T)
    n_tiles = S_T.shape[0] // TERMINAL_TILE
    _build.check_launch(seed, first_tile, n_tiles, n_steps)
    u, z_j = jump_draws(seed, first_tile, n_tiles, TERMINAL_TILE, n_steps, terminal=True,
                        device=S_T.device)
    n = poisson_from_uniform(u, poisson_table(overlay_constants(T, jumps, n_steps,
                                                                terminal=True)["lam_dt"]))
    S_T.mul_(overlay_from_draws(n, z_j, T, jumps, n_steps, return_paths=False))
    return (S_T, n.to(torch.int32)) if return_counts else S_T


def overlay_terminal_blocks(n_values: int, n_sm: int, blocks_per_sm: int) -> int:
    """Blocks of kernel 17's grid-stride launch over n_values (whole
    TERMINAL_TILE tiles): n_sm x blocks_per_sm, whole waves, or fewer where
    the values' OVERLAY_VEC-vectors, one a thread, do not fill them. Raises
    for what the kernel refuses."""
    if n_values < TERMINAL_TILE or n_values % TERMINAL_TILE or n_sm < 1 or blocks_per_sm < 1:
        raise ValueError(f"kernel 17 takes whole {TERMINAL_TILE}-value tiles on a card with "
                         f"SMs, got {n_values} values, {n_sm} x {blocks_per_sm} blocks")
    vectors = n_values // OVERLAY_VEC
    return min(-(-vectors // OVERLAY_BLOCK), n_sm * blocks_per_sm)


@functools.lru_cache(maxsize=16)
def _card_waves(index: int) -> tuple:
    """(SMs, resident blocks of kernel 17's pricing instance an SM) of CUDA
    device ``index``."""
    n_sm = torch.cuda.get_device_properties(index).multi_processor_count
    with torch.cuda.device(index):
        per_sm = _build.kernel_attrs("omt_jumps_attrs", 3)["blocks_per_sm"]
    return n_sm, per_sm


def _terminal_inputs(S_T: torch.Tensor, seed: int, T, jumps, n_steps: int, first_tile: int,
                     return_counts: bool) -> tuple:
    """A kernel-17 launch's tiles, host constants row (_overlay_row) and
    counts output, S_T checked (a CUDA, contiguous float32 vector of whole
    tiles)."""
    _build.require_cuda(S_T.device)
    _check_terminal(S_T)
    n_tiles = S_T.shape[0] // TERMINAL_TILE
    _build.check_launch(seed, first_tile, n_tiles, n_steps)
    counts = torch.empty_like(S_T, dtype=torch.int32) if return_counts else None
    return n_tiles, _overlay_row(T, jumps, n_steps, terminal=True), counts


def jump_overlay_terminal(S_T: torch.Tensor, seed: int, T, jumps, n_steps: int,
                          first_tile: int = 0, return_counts: bool = False):
    """Kernel 17 (csrc/jumps.cu overlay_terminal_kernel) on a CUDA S_T
    (n_pad,), in place: S_T *= exp(N mu_j + sigma_j sqrt(N) z_j - lam kbar
    T). The plain version for a CPU S_T. Returns S_T [and the counts]."""
    if S_T.device.type == "cpu":
        return jump_overlay_terminal_reference(S_T, seed, T, jumps, n_steps, first_tile,
                                               return_counts)
    n_tiles, row, counts = _terminal_inputs(S_T, seed, T, jumps, n_steps, first_tile,
                                            return_counts)
    if S_T.data_ptr() % 16:
        raise ValueError("kernel 17 loads S_T 16 bytes at a time and needs it 16-byte aligned")
    index = S_T.device.index if S_T.device.index is not None else torch.cuda.current_device()
    # the row and its Poisson head as launch constants: nothing to copy
    _build.launch("omt_jump_overlay_terminal", S_T.device, S_T.data_ptr(),
                  None if counts is None else counts.data_ptr(), _build.float_args(row),
                  _build.float_args(poisson_head(row[HEAD:HEAD + int(row[5])])), seed,
                  first_tile, n_tiles, n_steps,
                  overlay_terminal_blocks(S_T.shape[0], *_card_waves(index)))
    launches["jump_overlay_terminal"] += 1
    return (S_T, counts) if return_counts else S_T


def jump_overlay_terminal_first(S_T: torch.Tensor, seed: int, T, jumps, n_steps: int,
                                first_tile: int = 0, return_counts: bool = False):
    """jump_overlay_terminal through kernel 17's first design
    (overlay_terminal_first_kernel, its row copied to the card), the
    redesign's yardstick, on a CUDA S_T only."""
    n_tiles, row, counts = _terminal_inputs(S_T, seed, T, jumps, n_steps, first_tile,
                                            return_counts)
    consts = device_rows([row], S_T.device)
    _build.launch("omt_jump_overlay_terminal_first", S_T.device, S_T.data_ptr(),
                  None if counts is None else counts.data_ptr(), consts.data_ptr(), seed,
                  first_tile, n_tiles, n_steps)
    launches["jump_overlay_terminal_first"] += 1
    return (S_T, counts) if return_counts else S_T


def jumps_kernel_attrs() -> dict:
    """Registers, spills and occupancy of the four jump kernels and their
    first designs as built, by name: the redesigns' pricing instances
    (antithetic, without the counts output; the first designs take that
    output as a run-time pointer)."""
    return {name: _build.kernel_attrs("omt_jumps_attrs", i) for i, name in
            enumerate(("merton_paths", "merton_terminal", "jump_overlay_paths",
                       "jump_overlay_terminal", "merton_terminal_first", "merton_paths_first",
                       "jump_overlay_paths_first", "jump_overlay_terminal_first"))}
