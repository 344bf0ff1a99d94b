"""The martingale dual's kernels of csrc/dual.cu and their plain PyTorch
versions:
- 18 ``dual_ce``: the inner expectation ce[t, p] = E[W_{t+1}(x', v') |
  x_t, v_t] of the polynomial policy's surrogate, t = 0..n_steps-2, one
  thread a (date, path) (dual_ce_kernel, the redesign; VG's, SABR's and
  rough Bergomi's redesigns dual_ce_vg_kernel, a warp-dense clock, and
  dual_ce_sabr_kernel and dual_ce_rough_kernel, the mirror once a pair).
  The first designs stay built as their yardsticks, ``dual_ce_first``:
  dual_ce_first_kernel for GBM, Heston, Merton and Bates, dual_ce_kernel's
  instances for VG, SABR and rough Bergomi; no pricer reaches them.
  ``dual_ce_debug`` runs the VG, SABR and rough Bergomi redesigns' debug
  instances for a check;
- 19 ``dual_inner_states``: the inner one-step states (x', and v' under
  Heston) of a chunk of dates, on which the NN policy's network is then
  evaluated (dual_inner_states_kernel); its VG, SABR and rough Bergomi
  instances serve the check of those families' states alone (VG's gives
  each pair's clock G in place of v' and its accepting attempt in place of
  the count);
- ``dual_vg_terminal``: VG's terminal step, the one-step Black expectation
  given the clock over n_inner/2 clock draws a path
  (options_model_tpu/pricers/dual.py:676-686): dual_vg_terminal_warp_kernel,
  one entry a (path, draw) on the warp-dense clock;
  ``dual_vg_terminal_first`` its first design (dual_vg_terminal_kernel, one
  thread a path), the yardstick no pricer reaches;
  ``dual_vg_terminal_debug`` the redesign's debug instance for a check;
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
the law and its Poisson table go by value (``law_args``); rough Bergomi's
frozen histories (n_dates rows, P) and compensators (n_dates,) by pointer.
Its redesign has a compile-time instance for each family and side (put or
call, from the law's cp); the polynomial's degree is a run-time argument.
Its launches count under "dual_ce" for GBM, Heston, Merton and Bates and
under "dual_ce <family>" for VG, SABR and rough Bergomi; the first designs'
under "dual_ce_first" and "dual_ce <family>, first design", the debug
instances' under "dual_ce debug". Every design gives the inner states x'
bit for bit (and v', but for the SABR and rough Bergomi redesigns', within
the relative budgets csrc/dual.cu states); their ce differ from the plain
version's in float32 rounding of the floor and the polynomial only. VG's
terminal step counts under "dual_vg_terminal", its first design under
"dual_vg_terminal, first design" and its debug instance under
"dual_vg_terminal debug"; each clock draw is the plain version's bit for
bit, e_h differs in float32 rounding of the Black step.
Kernel 19 can also return each inner pair's Poisson count (int32), so a
check can hold the kernels' counts against the plain version's bit for
bit.
"""

from __future__ import annotations

from typing import Optional

import torch

from options_model_tpu_torch.ops import _build
from options_model_tpu_torch.ops.philox import (MAX_POISSON_TABLE, dual_calls,
                                                dual_gamma_draws, dual_inner_draws,
                                                poisson_table)
from options_model_tpu_torch.pricers.dual import (ROW_HEAD, InnerLaw, dual_ce_from_draws,
                                                  inner_states_from_draws,
                                                  vg_terminal_from_gamma)

# Kernel launches since the last reset, one integer per kernel (kernel 18's
# VG, SABR and rough Bergomi families apart).
launches = {"dual_ce": 0, "dual_inner_states": 0, "dual_ce_first": 0, "dual_ce vg": 0,
            "dual_ce sabr": 0, "dual_ce rbergomi": 0, "dual_vg_terminal": 0,
            "dual_ce vg, first design": 0, "dual_ce sabr, first design": 0,
            "dual_ce rbergomi, first design": 0, "dual_ce debug": 0,
            "dual_vg_terminal, first design": 0, "dual_vg_terminal debug": 0}
# The kernels' family instances (csrc/dual.cu Family).
FAMILIES = {"gbm": 0, "heston": 1, "merton": 2, "bates": 3, "vg": 4, "sabr": 5, "rbergomi": 6}
# The families of kernel 18's first design dual_ce_first_kernel and of the
# NN policy's states.
FIRST_FAMILIES = ("gbm", "heston", "merton", "bates")
# The families with kernel-18 redesigns of their own (dual_ce_vg_kernel,
# dual_ce_sabr_kernel, dual_ce_rough_kernel; dual_ce_first reaches their
# first design, dual_ce_kernel's instances); they alone have debug instances.
REDESIGNED_FAMILIES = ("vg", "sabr", "rbergomi")
# The law's floats before its Poisson table (csrc/dual.cu DualT), in order.
LAW_FIELDS = ("K", "cp", "rate", "q", "dt", "drift", "mu", "a", "sig_f", "kappa", "theta",
              "xi", "rho", "rho_bar", "comp_dt", "jvar", "mu_j", "sig_j", "nu", "vg_theta",
              "vg_sigma", "gamma_d", "gamma_c", "gamma_inv_a", "gamma_boost", "sqrt_dt",
              "nu_sqrt_dt", "half_nu2_dt", "rbsd", "sqrt2H", "c1", "c2", "eta", "xi0")
# The most floats of a policy row (csrc/dual.cu kMaxRow): degree <= 54.
MAX_ROW = 64
# The most inner pairs (csrc/dual.cu kMaxPairs) and dates of a launch.
MAX_PAIRS = 1024
MAX_DATES = 65535
# A warp clock's entries (csrc/dual.cu kClockEntries).
CLOCK_ENTRIES = 256


def terminal_per_warp(half: int) -> int:
    """The paths a warp of VG's terminal redesign owns at ``half`` clock
    draws a path (csrc/dual.cu terminal_per_warp): as many whole paths as
    its clock's CLOCK_ENTRIES hold, 1 to 32."""
    return min(32, max(1, CLOCK_ENTRIES // half))


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
           first_tile: int, seed: int, n_dates: int, hist: Optional[torch.Tensor] = None,
           comp: Optional[torch.Tensor] = None) -> int:
    """Raise for what the kernels (and the stream) refuse; returns n_tiles."""
    if law.model not in FAMILIES:
        raise ValueError(f"the dual's kernels take {', '.join(FAMILIES)}, got {law.model!r}")
    if (law.model == "rbergomi") != (hist is not None and comp is not None):
        raise ValueError("rough Bergomi, and it alone, takes hist and comp")
    if hist is not None and (hist.dim() != 2 or hist.shape[0] < n_dates
                             or hist.shape[1] != x.shape[1] or hist.dtype != torch.float32
                             or not hist.is_contiguous() or hist.device != x.device
                             or comp.shape != (n_dates,) or comp.dtype != torch.float32
                             or comp.device != x.device):
        raise ValueError("hist must be contiguous float32 (>= n_dates rows, P) and comp "
                         "float32 (n_dates,), both on x's device")
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


def _draws(seed: int, first_tile: int, n_tiles: int, tile: int, n_inner: int, law: InnerLaw,
           date: int, device) -> dict:
    """The dual stream's draws of one date under ``law``."""
    return dual_inner_draws(seed, first_tile, n_tiles, tile, n_inner // 2, law.model, date,
                            law.lam_dt, device, law.gamma_shape)


def dual_ce_reference(x: torch.Tensor, v: Optional[torch.Tensor], rows: torch.Tensor,
                      law: InnerLaw, seed: int, first_tile: int, tile: int, n_inner: int,
                      hist: Optional[torch.Tensor] = None,
                      comp: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of kernel 18: dual_ce_from_draws on the dual's Philox
    stream (dual_inner_draws, date t's draws at draw index t x calls)."""
    n_tiles = _check(x, v, law, tile, n_inner, first_tile, seed, rows.shape[0], hist, comp)
    return dual_ce_from_draws(
        x, v, rows, law,
        lambda t: _draws(seed, first_tile, n_tiles, tile, n_inner, law, t, x.device), hist, comp)


def _launch_ce(entry: str, x: torch.Tensor, v: Optional[torch.Tensor], rows: torch.Tensor,
               law: InnerLaw, seed: int, first_tile: int, tile: int, n_inner: int,
               hist: Optional[torch.Tensor] = None, comp: Optional[torch.Tensor] = None,
               debug: tuple = ()) -> torch.Tensor:
    """Check the arguments and launch C entry ``entry`` of kernel 18 on x's
    device (the debug outputs ``debug`` passed before the inputs); returns
    ce (n_dates, P)."""
    _build.require_cuda(x.device)
    n_dates, width = rows.shape
    _check(x, v, law, tile, n_inner, first_tile, seed, n_dates, hist, comp)
    if (rows.dtype != torch.float32 or not rows.is_contiguous() or rows.device != x.device
            or width > MAX_ROW or width < ROW_HEAD + 3):
        raise ValueError(f"policy rows must be contiguous float32 on x's device, "
                         f"{ROW_HEAD + 3}-{MAX_ROW} wide, got {tuple(rows.shape)}")
    degree = width - ROW_HEAD - (5 if law.use_v else 2)
    ce = torch.empty((n_dates, x.shape[1]), dtype=torch.float32, device=x.device)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    _build.launch(entry, x.device, ce.data_ptr(), *map(ptr, debug), x.data_ptr(), ptr(v),
                  ptr(hist), ptr(comp), rows.data_ptr(), law_args(law), seed, first_tile, tile,
                  x.shape[1], n_dates, width, degree, n_inner // 2, FAMILIES[law.model])
    return ce


def dual_ce(x: torch.Tensor, v: Optional[torch.Tensor], rows: torch.Tensor, law: InnerLaw,
            seed: int, first_tile: int, tile: int, n_inner: int,
            hist: Optional[torch.Tensor] = None,
            comp: Optional[torch.Tensor] = None) -> torch.Tensor:
    """ce (n_dates, P) of kernel 18's redesign (csrc/dual.cu dual_ce_kernel;
    dual_ce_vg_kernel under VG, dual_ce_sabr_kernel under SABR,
    dual_ce_rough_kernel under rough Bergomi) on
    CUDA x (n_steps+1, P) = S / K [and v, SABR's alpha], or of its plain
    version for CPU ones. ``rows`` (policy_rows) fixes n_dates,
    ``tile`` and ``first_tile`` the stream's tiles; rough Bergomi also takes
    ``hist`` and ``comp`` (pricers/dual.rbergomi_comp)."""
    if x.device.type == "cpu":
        return dual_ce_reference(x, v, rows, law, seed, first_tile, tile, n_inner, hist, comp)
    ce = _launch_ce("omt_dual_ce", x, v, rows, law, seed, first_tile, tile, n_inner, hist,
                    comp)
    launches["dual_ce" if law.model in FIRST_FAMILIES else f"dual_ce {law.model}"] += 1
    return ce


def dual_ce_first(x: torch.Tensor, v: Optional[torch.Tensor], rows: torch.Tensor,
                  law: InnerLaw, seed: int, first_tile: int, tile: int, n_inner: int,
                  hist: Optional[torch.Tensor] = None,
                  comp: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel 18's first design on CUDA tensors (csrc/dual.cu
    dual_ce_first_kernel for GBM, Heston, Merton and Bates; dual_ce_kernel,
    its first design for VG, SABR and rough Bergomi), the plain version on
    CPU ones; the redesigns' yardstick, which no pricer calls. The arguments
    are dual_ce's."""
    if x.device.type == "cpu":
        return dual_ce_reference(x, v, rows, law, seed, first_tile, tile, n_inner, hist, comp)
    ce = _launch_ce("omt_dual_ce_first", x, v, rows, law, seed, first_tile, tile, n_inner, hist,
                    comp)
    launches["dual_ce_first" if law.model in FIRST_FAMILIES
             else f"dual_ce {law.model}, first design"] += 1
    return ce


def dual_ce_debug(x: torch.Tensor, v: Optional[torch.Tensor], rows: torch.Tensor,
                  law: InnerLaw, seed: int, first_tile: int, tile: int, n_inner: int,
                  hist: Optional[torch.Tensor] = None, comp: Optional[torch.Tensor] = None):
    """dual_ce's VG, SABR or rough Bergomi redesign through its debug
    instance (CUDA tensors), or the plain version (CPU ones), for a check;
    the arguments are dual_ce's. VG: (ce, G, attempts, passes), each pair's
    clock G = nu gamma and accepting attempt (n_dates, n_inner/2, P), and
    each warp's passes of the exact tests and of the retries (n_dates,
    ceil(P / 32), 2) int32, which only the kernel has (None on the CPU).
    SABR and rough Bergomi: (ce, x', v'), each (n_dates, 2, n_inner/2, P),
    the pair's up member first (v' SABR's alpha')."""
    if law.model not in REDESIGNED_FAMILIES:
        raise ValueError(f"kernel 18's debug instances take {', '.join(REDESIGNED_FAMILIES)}")
    n_dates, half, n = rows.shape[0], n_inner // 2, x.shape[1]
    if x.device.type == "cpu":
        ce = dual_ce_reference(x, v, rows, law, seed, first_tile, tile, n_inner, hist, comp)
        xs, vs, counts = dual_inner_states_reference(x, v, law, seed, first_tile, tile, n_inner,
                                                     0, n_dates, True, hist, comp)
        if law.model == "vg":
            return ce, vs[:, 0], counts, None
        return ce, xs, vs
    _build.require_cuda(x.device)
    vg = law.model == "vg"
    shape = (n_dates, half, n) if vg else (n_dates, 2, half, n)
    d0 = torch.empty(shape, dtype=torch.float32, device=x.device)
    d1 = torch.empty(shape, dtype=torch.int32 if vg else torch.float32, device=x.device)
    d2 = (torch.empty((n_dates, -(-n // 32), 2), dtype=torch.int32, device=x.device) if vg
          else None)
    ce = _launch_ce("omt_dual_ce_debug", x, v, rows, law, seed, first_tile, tile, n_inner, hist,
                    comp, debug=(d0, d1, d2))
    launches["dual_ce debug"] += 1
    return (ce, d0, d1, d2) if vg else (ce, d0, d1)


def dual_inner_states_reference(x: torch.Tensor, v: Optional[torch.Tensor], law: InnerLaw,
                                seed: int, first_tile: int, tile: int, n_inner: int,
                                date0: int, n_chunk: int, return_counts: bool = False,
                                hist: Optional[torch.Tensor] = None,
                                comp: Optional[torch.Tensor] = None):
    """Plain version of kernel 19: the inner states of dates date0 ..
    date0 + n_chunk - 1, x' (n_chunk, 2, n_inner/2, P) and v' likewise (None
    without a second state; VG's clock G = nu gamma in both members' slots),
    the pair's up member first [and the counts (n_chunk, n_inner/2, P)
    int32: the Poisson counts under the jumps, VG's accepting attempts]."""
    n_tiles = _check(x, v, law, tile, n_inner, first_tile, seed, date0 + n_chunk, hist,
                     None if comp is None else comp[:date0 + n_chunk])
    xs, vs, counts = [], [], []
    for t in range(date0, date0 + n_chunk):
        draws = _draws(seed, first_tile, n_tiles, tile, n_inner, law, t, x.device)
        xt, vt = inner_states_from_draws(law, x[t], None if v is None else v[t], draws,
                                         None if hist is None else hist[t],
                                         None if comp is None else comp[t])
        if law.model == "vg":
            vt = (law.nu * draws["gamma"]).expand(2, *draws["gamma"].shape)
        xs.append(xt)
        vs.append(vt)
        if return_counts:
            counts.append(draws["n"].to(torch.int32) if law.jumps
                          else draws["attempts"] if law.model == "vg"
                          else torch.zeros_like(xt[0], dtype=torch.int32))
    out = (torch.stack(xs), torch.stack(vs) if vs[0] is not None else None)
    return out + (torch.stack(counts),) if return_counts else out


def dual_inner_states(x: torch.Tensor, v: Optional[torch.Tensor], law: InnerLaw, seed: int,
                      first_tile: int, tile: int, n_inner: int, date0: int, n_chunk: int,
                      return_counts: bool = False, hist: Optional[torch.Tensor] = None,
                      comp: Optional[torch.Tensor] = None):
    """The inner states of a chunk of dates from kernel 19 (csrc/dual.cu
    dual_inner_states_kernel) on CUDA x [and v, hist, comp], or from its
    plain version for CPU ones; the same draws and transitions as kernel
    18."""
    if x.device.type == "cpu":
        return dual_inner_states_reference(x, v, law, seed, first_tile, tile, n_inner, date0,
                                           n_chunk, return_counts, hist, comp)
    _build.require_cuda(x.device)
    _check(x, v, law, tile, n_inner, first_tile, seed, date0 + n_chunk, hist,
           None if comp is None else comp[:date0 + n_chunk])
    if date0 < 0 or n_chunk < 1:
        raise ValueError(f"a chunk of dates from {date0}, {n_chunk} long")
    shape = (n_chunk, 2, n_inner // 2, x.shape[1])
    xs = torch.empty(shape, dtype=torch.float32, device=x.device)
    second = law.use_v or law.model == "vg"
    vs = torch.empty(shape, dtype=torch.float32, device=x.device) if second else None
    counts = (torch.empty((n_chunk, n_inner // 2, x.shape[1]), dtype=torch.int32,
                          device=x.device) if return_counts else None)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    _build.launch("omt_dual_inner_states", x.device, xs.data_ptr(), ptr(vs), ptr(counts),
                  x.data_ptr(), ptr(v), ptr(hist), ptr(comp), law_args(law), seed, first_tile,
                  tile, x.shape[1], date0, n_chunk, n_inner // 2, FAMILIES[law.model])
    launches["dual_inner_states"] += 1
    return (xs, vs, counts) if return_counts else (xs, vs)


def dual_vg_terminal_reference(x_last: torch.Tensor, law: InnerLaw, seed: int, first_tile: int,
                               tile: int, n_inner: int, date: int) -> torch.Tensor:
    """Plain version of dual_vg_terminal_kernel: pricers/dual.
    vg_terminal_from_gamma on the dual's clock draws of ``date``."""
    if law.model != "vg" or x_last.dim() != 1 or x_last.shape[0] % tile:
        raise ValueError("VG's terminal step takes a VG law and x (P,) of whole tiles")
    gamma, _ = dual_gamma_draws(seed, first_tile, x_last.shape[0] // tile, tile, n_inner // 2,
                                date, law.gamma_shape, x_last.device)
    return vg_terminal_from_gamma(law, x_last, gamma)


def _terminal_args(x_last: torch.Tensor, law: InnerLaw, seed: int, first_tile: int, tile: int,
                   n_inner: int) -> None:
    """Raise for what VG's terminal kernels refuse (CUDA x_last)."""
    _build.require_cuda(x_last.device)
    if (law.model != "vg" or x_last.dim() != 1 or x_last.dtype != torch.float32
            or not x_last.is_contiguous() or x_last.shape[0] % tile):
        raise ValueError("VG's terminal step takes a VG law and contiguous float32 x (P,) of "
                         "whole tiles")
    if n_inner < 2 or n_inner % 2 or n_inner // 2 > MAX_PAIRS:
        raise ValueError(f"n_inner must be even, in [2, {2 * MAX_PAIRS}], got {n_inner}")
    _build.check_launch(seed, first_tile, x_last.shape[0] // tile, 1)


def _launch_terminal(entry: str, counter: str, x_last: torch.Tensor, law: InnerLaw, seed: int,
                     first_tile: int, tile: int, n_inner: int, date: int) -> torch.Tensor:
    """Check the arguments and launch C entry ``entry`` of VG's terminal step;
    returns e_h (P,)."""
    _terminal_args(x_last, law, seed, first_tile, tile, n_inner)
    e_h = torch.empty_like(x_last)
    _build.launch(entry, x_last.device, e_h.data_ptr(), x_last.data_ptr(), law_args(law), seed,
                  first_tile, tile, x_last.shape[0], date, n_inner // 2)
    launches[counter] += 1
    return e_h


def dual_vg_terminal(x_last: torch.Tensor, law: InnerLaw, seed: int, first_tile: int, tile: int,
                     n_inner: int, date: int) -> torch.Tensor:
    """VG's terminal expectation e_h (P,) on x_{n-1} = S_{n-1} / K (P,):
    csrc/dual.cu dual_vg_terminal_warp_kernel on a CUDA tensor, its plain
    version on a CPU one; the clock draws of ``date`` (n_dates) on the dual's
    gamma counters, n_inner/2 a path."""
    if x_last.device.type == "cpu":
        return dual_vg_terminal_reference(x_last, law, seed, first_tile, tile, n_inner, date)
    return _launch_terminal("omt_dual_vg_terminal", "dual_vg_terminal", x_last, law, seed,
                            first_tile, tile, n_inner, date)


def dual_vg_terminal_first(x_last: torch.Tensor, law: InnerLaw, seed: int, first_tile: int,
                           tile: int, n_inner: int, date: int) -> torch.Tensor:
    """VG's terminal step's first design on a CUDA tensor (csrc/dual.cu
    dual_vg_terminal_kernel, one thread a path), the plain version on a CPU
    one; the redesign's yardstick, which no pricer calls. The arguments are
    dual_vg_terminal's."""
    if x_last.device.type == "cpu":
        return dual_vg_terminal_reference(x_last, law, seed, first_tile, tile, n_inner, date)
    return _launch_terminal("omt_dual_vg_terminal_first", "dual_vg_terminal, first design",
                            x_last, law, seed, first_tile, tile, n_inner, date)


def dual_vg_terminal_debug(x_last: torch.Tensor, law: InnerLaw, seed: int, first_tile: int,
                           tile: int, n_inner: int, date: int):
    """dual_vg_terminal's redesign through its debug instance (a CUDA
    tensor), or the plain version (a CPU one), for a check; the arguments
    are dual_vg_terminal's. (e_h, G, attempts, passes): each clock draw's G
    = nu gamma and accepting attempt (n_inner/2, P), and each warp's passes
    of the exact tests and of the retries (ceil(P / terminal_per_warp), 2)
    int32, which only the kernel has (None on the CPU)."""
    half, n = n_inner // 2, x_last.shape[0]
    if x_last.device.type == "cpu":
        e_h = dual_vg_terminal_reference(x_last, law, seed, first_tile, tile, n_inner, date)
        gamma, attempts = dual_gamma_draws(seed, first_tile, n // tile, tile, half, date,
                                           law.gamma_shape, x_last.device)
        return e_h, law.nu * gamma, attempts, None
    _terminal_args(x_last, law, seed, first_tile, tile, n_inner)
    e_h = torch.empty_like(x_last)
    G = torch.empty((half, n), dtype=torch.float32, device=x_last.device)
    att = torch.empty((half, n), dtype=torch.int32, device=x_last.device)
    passes = torch.empty((-(-n // terminal_per_warp(half)), 2), dtype=torch.int32,
                         device=x_last.device)
    _build.launch("omt_dual_vg_terminal_debug", x_last.device, e_h.data_ptr(), G.data_ptr(),
                  att.data_ptr(), passes.data_ptr(), x_last.data_ptr(), law_args(law), seed,
                  first_tile, tile, n, date, half)
    launches["dual_vg_terminal debug"] += 1
    return e_h, G, att, passes


def dual_kernel_attrs() -> dict:
    """Registers, spills and occupancy of kernels 18 and 19 as built, by
    name and family: kernel 18's redesign for a put (``dual_ce``) and for a
    call (``dual_ce_call``), kernel 19 without its counts output, kernel
    18's first design (``dual_ce_first`` for GBM, Heston, Merton, Bates;
    ``dual_ce[_call] <family>, first design`` for VG, SABR and rough
    Bergomi), the VG, SABR and rough Bergomi redesigns' debug instances
    (puts, ``dual_ce <family>, debug``), and VG's terminal step
    (``dual_vg_terminal`` and ``dual_vg_terminal_call``, ``dual_vg_terminal,
    debug``, ``dual_vg_terminal, first design``)."""
    out = {f"{name} {model}": _build.kernel_attrs("omt_dual_attrs", 4 * k + FAMILIES[model])
           for k, name in enumerate(("dual_ce", "dual_inner_states", "dual_ce_first",
                                     "dual_ce_call"))
           for model in FIRST_FAMILIES}
    for k, name in enumerate(("dual_ce", "dual_ce_call", "dual_inner_states")):
        for model in REDESIGNED_FAMILIES:
            out[f"{name} {model}"] = _build.kernel_attrs("omt_dual_attrs",
                                                         16 + 3 * k + FAMILIES[model] - 4)
    for model in REDESIGNED_FAMILIES:
        i = FAMILIES[model] - 4
        for k, name in enumerate(("dual_ce", "dual_ce_call")):
            out[f"{name} {model}, first design"] = _build.kernel_attrs("omt_dual_attrs",
                                                                      26 + 2 * i + k)
        out[f"dual_ce {model}, debug"] = _build.kernel_attrs("omt_dual_attrs", 32 + i)
    for name, which in (("dual_vg_terminal", 25), ("dual_vg_terminal_call", 35),
                        ("dual_vg_terminal, debug", 36), ("dual_vg_terminal, first design", 37)):
        out[name] = _build.kernel_attrs("omt_dual_attrs", which)
    return out
