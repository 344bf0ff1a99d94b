"""The jump kernels of csrc/jumps.cu and their plain PyTorch versions:
- 14 ``merton_paths`` and 15 ``merton_terminal``: the Merton walk, the
  counterparts of options_model_tpu/models/merton.py:26 simulate_merton
  (return_paths True and False); kernel 15 is the Hopper redesign
  (merton_terminal_kernel), its first design stays under
  ``merton_terminal_first`` as the yardstick, and no pricer reaches it;
- 16 ``jump_overlay_paths`` and 17 ``jump_overlay_terminal``: the Bates jump
  overlay multiplied in place into a Heston kernel's S (or S_T), the
  counterparts of options_model_tpu/models/bates.py:37 jump_overlay.
The JAX package computes these in XLA code (no Pallas kernel). The wrappers
take the plain version for a CPU tensor or device and launch the kernel for
a CUDA one; there is no fallback between the two.

Every launch reads its constants from 128-float rows on the card (``ROW``:
a, diffusion, mu_j, sigma_j, log S0, the Poisson table's length, two zeros,
then the table of ops/philox.poisson_table), built on the host and copied
through pinned memory, so the host does not wait for the work already
queued on the stream. ``return_counts`` also returns each draw's Poisson
count (int32), from the kernel's debug output or the plain version, so the
two can be held against each other bit for bit.

Streams (ops/philox.py): Merton on counter word 3 = 0, one call per pair
(or path) and step; the overlay on word 3 = 1 with the Heston kernel's seed
and tiles, one call per path and step (terminal: one per path, at draw
n_steps). A run at ``first_tile`` reproduces those tiles of a longer run
bit for bit.
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import torch

from options_model_tpu_torch.models.bates import overlay_constants, overlay_from_draws
from options_model_tpu_torch.models.blocks import round_up
from options_model_tpu_torch.models.merton import merton_constants, merton_from_draws
from options_model_tpu_torch.ops import _build
from options_model_tpu_torch.ops.cuda_heston import PATH_TILE, TERMINAL_TILE, _tiles
from options_model_tpu_torch.ops.engine import resolve_device
from options_model_tpu_torch.ops.philox import (MAX_POISSON_TABLE, jump_draws,
                                                merton_path_draws, poisson_from_uniform,
                                                poisson_table)

# Kernel launches since the last reset, one integer per kernel.
launches = {"merton_paths": 0, "merton_terminal": 0, "merton_terminal_first": 0,
            "jump_overlay_paths": 0, "jump_overlay_terminal": 0}
# Kernel 14's launches since the last reset, by (n_pad, n_steps).
shape_launches = Counter()
# Floats of a constants row before its table, and in all (csrc/jumps.cu
# kHead, kRow = 128).
HEAD = 8
ROW = HEAD + MAX_POISSON_TABLE
# The redesigned terminal kernel's launch constants (csrc/jumps.cu
# PoissonHead): the CDF entries a thread compares against (F(0), F(1)) and
# the counts whose square root comes from a table.
POISSON_HEAD = 2
SQRT_TABLE = 16


def const_row(a, diffusion, mu_j, sigma_j, log_s0, lam_dt: float) -> np.ndarray:
    """One launch's (or maturity's) float32 constants row, its Poisson table
    that of Poisson(lam_dt)."""
    table = poisson_table(lam_dt)
    row = np.zeros(ROW, np.float32)
    row[:6] = (a, diffusion, mu_j, sigma_j, log_s0, table.size)
    row[HEAD:HEAD + table.size] = table
    return row


def sqrt_table() -> np.ndarray:
    """IEEE float32 square roots of the counts 0..SQRT_TABLE-1, the bits of
    sqrtf and torch.sqrt."""
    return np.sqrt(np.arange(SQRT_TABLE, dtype=np.float32))


def poisson_head(table) -> np.ndarray:
    """The redesigned terminal kernel's PoissonHead for a Poisson table
    (poisson_table): its first POISSON_HEAD entries, padded with 2 (above
    every uniform) past the table's end, then sqrt_table()."""
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
    """Plain version of kernel 14: S (n_steps+1, n_pad) [and the counts
    (n_steps, n_pad)], n_pad = n_paths rounded up to PATH_TILE."""
    return _merton_reference(PATH_TILE, seed, S0, r, T, params, n_paths, n_steps, antithetic,
                             first_tile, device, return_counts, True)


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


def merton_paths(seed: int, S0, r, T, params, n_paths: int, n_steps: int,
                 antithetic: bool = True, first_tile: int = 0, device=None,
                 return_counts: bool = False):
    """Merton path matrix S (n_steps+1, n_pad) from kernel 14 (csrc/jumps.cu),
    or from its plain version for a CPU device."""
    device = resolve_device(device)
    if device.type == "cpu":
        return merton_paths_reference(seed, S0, r, T, params, n_paths, n_steps, antithetic,
                                      first_tile, device, return_counts)
    out = _merton_launch("merton_paths", PATH_TILE, False, seed, S0, r, T, params, n_paths,
                         n_steps, antithetic, first_tile, device, return_counts)
    shape_launches[round_up(n_paths, PATH_TILE), n_steps] += 1
    return out


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
    Ts = np.asarray(Ts, np.float32).reshape(-1).tolist()
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


def jump_overlay_paths(S: torch.Tensor, seed: int, Ts, jumps, first_tile: int = 0,
                       return_counts: bool = False):
    """Kernel 16 (csrc/jumps.cu) on a CUDA S, in place: S (n_steps+1, n_pad)
    of one maturity T = ``Ts``, or (n_mat, n_steps+1, n_pad) of the
    maturities ``Ts``, in one launch, maturity m on global tiles first_tile
    + m n_tiles + ..., as the batched Heston kernel drew them. The plain
    version for a CPU S. ``jumps`` carries lam, mu_j and sigma_j. Returns
    S [and the counts]."""
    if S.device.type == "cpu":
        return jump_overlay_paths_reference(S, seed, Ts, jumps, first_tile, return_counts)
    _build.require_cuda(S.device)
    S3 = _as_batch(S, PATH_TILE)
    n_mat, n_steps, n_pad = S3.shape[0], S3.shape[1] - 1, S3.shape[2]
    n_tiles = n_pad // PATH_TILE
    _build.check_launch(seed, first_tile, n_mat * n_tiles, n_steps)
    consts = device_rows([_overlay_row(T, jumps, n_steps) for T in _maturity_list(Ts, n_mat)],
                         S.device)
    counts = (torch.empty((n_mat, n_steps, n_pad), dtype=torch.int32, device=S.device)
              if return_counts else None)
    _build.launch("omt_jump_overlay_paths", S.device, S3.data_ptr(),
                  None if counts is None else counts.data_ptr(), consts.data_ptr(), seed,
                  first_tile, n_tiles, n_steps, n_mat)
    launches["jump_overlay_paths"] += 1
    if not return_counts:
        return S
    return S, (counts if S.dim() == 3 else counts[0])


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


def jump_overlay_terminal(S_T: torch.Tensor, seed: int, T, jumps, n_steps: int,
                          first_tile: int = 0, return_counts: bool = False):
    """Kernel 17 (csrc/jumps.cu) on a CUDA S_T (n_pad,), in place: S_T *=
    exp(N mu_j + sigma_j sqrt(N) z_j - lam kbar T). The plain version for a
    CPU S_T. Returns S_T [and the counts]."""
    if S_T.device.type == "cpu":
        return jump_overlay_terminal_reference(S_T, seed, T, jumps, n_steps, first_tile,
                                               return_counts)
    _build.require_cuda(S_T.device)
    _check_terminal(S_T)
    n_tiles = S_T.shape[0] // TERMINAL_TILE
    _build.check_launch(seed, first_tile, n_tiles, n_steps)
    consts = device_rows([_overlay_row(T, jumps, n_steps, terminal=True)], S_T.device)
    counts = torch.empty_like(S_T, dtype=torch.int32) if return_counts else None
    _build.launch("omt_jump_overlay_terminal", S_T.device, S_T.data_ptr(),
                  None if counts is None else counts.data_ptr(), consts.data_ptr(), seed,
                  first_tile, n_tiles, n_steps)
    launches["jump_overlay_terminal"] += 1
    return (S_T, counts) if return_counts else S_T


def jumps_kernel_attrs() -> dict:
    """Registers, spills and occupancy of the four jump kernels and kernel
    15's first design as built, by name: Merton's antithetic instances, the
    redesigned terminal kernel's without its counts output (the pricing
    instance; the first design takes that output as a run-time pointer)."""
    return {name: _build.kernel_attrs("omt_jumps_attrs", i) for i, name in
            enumerate(("merton_paths", "merton_terminal", "jump_overlay_paths",
                       "jump_overlay_terminal", "merton_terminal_first"))}
