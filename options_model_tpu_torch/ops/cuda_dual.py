"""The martingale dual's kernels of csrc/dual.cu and their plain PyTorch
versions:
- 18 ``dual_ce``: the inner expectation ce[t, p] = E[W_{t+1}(x', v') |
  x_t, v_t] of the polynomial policy's surrogate, t = 0..n_steps-2, one
  thread a (date, path) (dual_ce_kernel);
- 19 ``dual_inner_states``: the inner one-step states (x', and v' under
  Heston) of a chunk of dates, on which the NN policy's network is then
  evaluated (dual_inner_states_kernel).
Both replace XLA code of the JAX package, not a Pallas kernel:
options_model_tpu/pricers/dual.py:292 dual_upper_from_policy and :847
dual_upper_from_nn_policy compute the inner expectation as a lax.scan over
dates (``date_ce``). Eager torch would hold several (n_inner/2, P) float
tensors a date and draw its Philox words in int64 arithmetic, with some 40
launches a date; a kernel reads x_t once and writes ce_t once per path.

Both draw the dual's inner stream (ops/philox.py: counter word 3 =
DUAL_STREAM, one slot a path, the tile the bracket's pair block,
``dual_inner_draws`` its plain version) and take the transition of
pricers/dual.InnerLaw. The wrappers take the plain version for a CPU tensor
and launch the kernel for a CUDA one; there is no fallback between the two.

Kernel 18 reads x = S / K and v row by row and its policy rows
(``policy_rows``, one a date: tau, x_mean, x_rstd, v_mean, v_rstd, betas);
the law and its Poisson table go by value (``law_args``). Kernel 19 can
also return each inner pair's Poisson count (int32), so a check can hold
the kernels' counts against the plain version's bit for bit.
"""

from __future__ import annotations

from typing import Optional

import torch

from options_model_tpu_torch.ops import _build
from options_model_tpu_torch.ops.philox import (MAX_POISSON_TABLE, dual_calls,
                                                dual_inner_draws, poisson_table)
from options_model_tpu_torch.pricers.dual import (ROW_HEAD, InnerLaw, dual_ce_from_draws,
                                                  inner_states_from_draws)

# Kernel launches since the last reset, one integer per kernel.
launches = {"dual_ce": 0, "dual_inner_states": 0}
# The kernels' family instances (csrc/dual.cu Family).
FAMILIES = {"gbm": 0, "heston": 1, "merton": 2, "bates": 3}
# The law's floats before its Poisson table (csrc/dual.cu DualT), in order.
LAW_FIELDS = ("K", "cp", "rate", "q", "dt", "drift", "mu", "a", "sig_f", "kappa", "theta",
              "xi", "rho", "rho_bar", "comp_dt", "jvar", "mu_j", "sig_j")
# The most floats of a policy row (csrc/dual.cu kMaxRow): degree <= 54.
MAX_ROW = 64
# The most inner pairs (csrc/dual.cu kMaxPairs) and dates of a launch.
MAX_PAIRS = 1024
MAX_DATES = 65535


def policy_rows(policy, taus: torch.Tensor) -> torch.Tensor:
    """The (n_dates, ROW_HEAD + n_betas) float32 policy rows of kernel 18
    and of dual_ce_from_draws, on the policy's device: row t holds date
    t+1's tau, x_mean, x_rstd, v_mean, v_rstd (0 without a variance state)
    and betas."""
    zeros = torch.zeros_like(policy.x_mean)
    head = [taus, policy.x_mean, policy.x_rstd,
            zeros if policy.v_mean is None else policy.v_mean,
            zeros if policy.v_rstd is None else policy.v_rstd]
    return torch.cat([torch.stack(head, dim=1), policy.betas], dim=1).to(
        torch.float32).contiguous()


def law_args(law: InnerLaw):
    """The law as the kernels' host constants (csrc/dual.cu DualT): the
    LAW_FIELDS, the Poisson table's length, then the table of Poisson(lam
    dt) (ops/philox.poisson_table), zero-padded to MAX_POISSON_TABLE."""
    table = poisson_table(law.lam_dt)
    vals = [getattr(law, k) for k in LAW_FIELDS] + [float(table.size)]
    return _build.float_args(vals + table.tolist() + [0.0] * (MAX_POISSON_TABLE - table.size))


def _check(x: torch.Tensor, v: Optional[torch.Tensor], law: InnerLaw, tile: int, n_inner: int,
           first_tile: int, seed: int, n_dates: int) -> int:
    """Raise for what the kernels (and the stream) refuse; returns n_tiles."""
    if law.model not in FAMILIES:
        raise ValueError(f"the dual's kernels take gbm, heston, merton or bates, got "
                         f"{law.model!r}")
    if x.dim() != 2 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous float32 (n_steps+1, P) matrix, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if law.use_v != (v is not None):
        raise ValueError(f"model {law.model!r} {'needs' if law.use_v else 'takes no'} v")
    if v is not None and (v.shape != x.shape or v.dtype != torch.float32
                          or not v.is_contiguous() or v.device != x.device):
        raise ValueError("v must be a contiguous float32 matrix shaped and placed as x")
    if n_inner < 2 or n_inner % 2 or n_inner // 2 > MAX_PAIRS:
        raise ValueError(f"n_inner must be even, in [2, {2 * MAX_PAIRS}], got {n_inner}")
    if tile < 1 or x.shape[1] % tile:
        raise ValueError(f"paths ({x.shape[1]}) must be a multiple of the tile ({tile})")
    if not 1 <= n_dates <= min(MAX_DATES, x.shape[0] - 1):
        raise ValueError(f"{n_dates} dates for {x.shape[0]} rows")
    n_tiles = x.shape[1] // tile
    _build.check_launch(seed, first_tile, n_tiles, 1)
    if n_dates * dual_calls(law.model, n_inner // 2)[2] >= 1 << 32:
        raise ValueError("the dates' draws leave the 32-bit counter word")
    return n_tiles


def dual_ce_reference(x: torch.Tensor, v: Optional[torch.Tensor], rows: torch.Tensor,
                      law: InnerLaw, seed: int, first_tile: int, tile: int,
                      n_inner: int) -> torch.Tensor:
    """Plain version of kernel 18: dual_ce_from_draws on the dual's Philox
    stream (dual_inner_draws, date t's draws at draw index t x calls)."""
    n_tiles = _check(x, v, law, tile, n_inner, first_tile, seed, rows.shape[0])
    return dual_ce_from_draws(x, v, rows, law, lambda t: dual_inner_draws(
        seed, first_tile, n_tiles, tile, n_inner // 2, law.model, t, law.lam_dt, x.device))


def dual_ce(x: torch.Tensor, v: Optional[torch.Tensor], rows: torch.Tensor, law: InnerLaw,
            seed: int, first_tile: int, tile: int, n_inner: int) -> torch.Tensor:
    """ce (n_dates, P) of kernel 18 (csrc/dual.cu dual_ce_kernel) on CUDA x
    (n_steps+1, P) = S / K [and v], or of its plain version for CPU ones.
    ``rows`` (policy_rows) fixes n_dates, ``tile`` and ``first_tile`` the
    stream's tiles."""
    if x.device.type == "cpu":
        return dual_ce_reference(x, v, rows, law, seed, first_tile, tile, n_inner)
    _build.require_cuda(x.device)
    n_dates, width = rows.shape
    _check(x, v, law, tile, n_inner, first_tile, seed, n_dates)
    if (rows.dtype != torch.float32 or not rows.is_contiguous() or rows.device != x.device
            or width > MAX_ROW or width < ROW_HEAD + 3):
        raise ValueError(f"policy rows must be contiguous float32 on x's device, "
                         f"{ROW_HEAD + 3}-{MAX_ROW} wide, got {tuple(rows.shape)}")
    degree = width - ROW_HEAD - (5 if law.use_v else 2)
    ce = torch.empty((n_dates, x.shape[1]), dtype=torch.float32, device=x.device)
    _build.launch("omt_dual_ce", x.device, ce.data_ptr(), x.data_ptr(),
                  None if v is None else v.data_ptr(), rows.data_ptr(), law_args(law), seed,
                  first_tile, tile, x.shape[1], n_dates, width, degree, n_inner // 2,
                  FAMILIES[law.model])
    launches["dual_ce"] += 1
    return ce


def dual_inner_states_reference(x: torch.Tensor, v: Optional[torch.Tensor], law: InnerLaw,
                                seed: int, first_tile: int, tile: int, n_inner: int,
                                date0: int, n_chunk: int, return_counts: bool = False):
    """Plain version of kernel 19: the inner states of dates date0 ..
    date0 + n_chunk - 1, x' (n_chunk, 2, n_inner/2, P) and v' likewise (None
    without a variance state), the pair's up member first [and the counts
    (n_chunk, n_inner/2, P) int32 under the jumps]."""
    n_tiles = _check(x, v, law, tile, n_inner, first_tile, seed, date0 + n_chunk)
    xs, vs, counts = [], [], []
    for t in range(date0, date0 + n_chunk):
        draws = dual_inner_draws(seed, first_tile, n_tiles, tile, n_inner // 2, law.model, t,
                                 law.lam_dt, x.device)
        xt, vt = inner_states_from_draws(law, x[t], None if v is None else v[t], draws)
        xs.append(xt)
        vs.append(vt)
        if return_counts:
            counts.append(draws["n"].to(torch.int32) if law.jumps
                          else torch.zeros_like(xt[0], dtype=torch.int32))
    out = (torch.stack(xs), torch.stack(vs) if law.use_v else None)
    return out + (torch.stack(counts),) if return_counts else out


def dual_inner_states(x: torch.Tensor, v: Optional[torch.Tensor], law: InnerLaw, seed: int,
                      first_tile: int, tile: int, n_inner: int, date0: int, n_chunk: int,
                      return_counts: bool = False):
    """The inner states of a chunk of dates from kernel 19 (csrc/dual.cu
    dual_inner_states_kernel) on CUDA x [and v], or from its plain version
    for CPU ones; the same draws and transitions as kernel 18."""
    if x.device.type == "cpu":
        return dual_inner_states_reference(x, v, law, seed, first_tile, tile, n_inner, date0,
                                           n_chunk, return_counts)
    _build.require_cuda(x.device)
    _check(x, v, law, tile, n_inner, first_tile, seed, date0 + n_chunk)
    if date0 < 0 or n_chunk < 1:
        raise ValueError(f"a chunk of dates from {date0}, {n_chunk} long")
    shape = (n_chunk, 2, n_inner // 2, x.shape[1])
    xs = torch.empty(shape, dtype=torch.float32, device=x.device)
    vs = torch.empty(shape, dtype=torch.float32, device=x.device) if law.use_v else None
    counts = (torch.empty((n_chunk, n_inner // 2, x.shape[1]), dtype=torch.int32,
                          device=x.device) if return_counts else None)
    _build.launch("omt_dual_inner_states", x.device, xs.data_ptr(),
                  None if vs is None else vs.data_ptr(),
                  None if counts is None else counts.data_ptr(), x.data_ptr(),
                  None if v is None else v.data_ptr(), law_args(law), seed, first_tile, tile,
                  x.shape[1], date0, n_chunk, n_inner // 2, FAMILIES[law.model])
    launches["dual_inner_states"] += 1
    return (xs, vs, counts) if return_counts else (xs, vs)


def dual_kernel_attrs() -> dict:
    """Registers, spills and occupancy of kernels 18 and 19 as built, by
    name and family (the pricing instances: kernel 19 without its counts
    output)."""
    return {f"{name} {model}": _build.kernel_attrs("omt_dual_attrs", 4 * k + fam)
            for k, name in enumerate(("dual_ce", "dual_inner_states"))
            for model, fam in FAMILIES.items()}
