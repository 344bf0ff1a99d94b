"""Store, exp and layout variants of the Heston Euler paths kernel, and
their plain PyTorch versions:
- csrc/paths_variants.cu: the variants on the redesigned kernel 4's step
  (csrc/heston_paths.cu, ``cuda_heston.heston_paths``), the experiments'
  route (``heston_variant``);
- csrc/heston_variants.cu: the same variants on kernel 4's first design
  (``cuda_heston.heston_paths_accurate``), kept only as the redesign's
  yardstick under ``heston_variant_accurate``.

Counterparts of the TPU experiment kernels of scripts/exp_paths_kernel.py
(``_make_paths_fn``: per-step vs bulk exp, batched stores, row counts) and
scripts/exp_fullpath_layout.py (``_make_strided``, ``_make_contig``,
``_make_storeless``: flat vs blocked output, no stores). A variant is
(exp_mode, layout, unroll) at a run-time ``tile``:

- exp_mode "per_step" stores exp(log S0 + ls) each step (kernel 4's form),
  "bulk" stores ls and exps the whole column after the time loop, "none"
  stores ls = log(S_t / S0) and never exps;
- layout "flat" is (n_steps+1, n_pad), "blocked" (n_tiles, n_steps+1, tile)
  with each tile one contiguous slab (``blocked.permute(1, 0, 2)`` reshaped
  is the flat matrix), "terminal" is S_T (n_pad,) with no path stores;
- unroll holds that many steps in registers before their row stores; it
  changes no value, and n_steps must be a multiple of it.

The TPU knob ``vmem_mb`` (the compiler's scoped-VMEM limit,
exp_fullpath_layout.py:70) has no counterpart on the card. None of this is
on a pricing path: ``simulate_paths`` emits the flat layout only. The plain
versions are the same Philox draws through
models/heston.heston_euler_from_normals, then the variant's layout and exp
form; the wrapper runs them for a CPU device and launches the kernel for a
CUDA device, with no fallback between the two.
"""

from __future__ import annotations

import torch

from options_model_tpu_torch.models.heston import heston_euler_from_normals
from options_model_tpu_torch.ops import _build
from options_model_tpu_torch.ops.cuda_heston import (PATH_TILE, _consts, _tiles,
                                                    batched_consts)
from options_model_tpu_torch.ops.engine import resolve_device
from options_model_tpu_torch.ops.philox import path_normals

EXP_MODES = ("per_step", "bulk", "none")
LAYOUTS = ("flat", "blocked", "terminal")
# The (exp_mode, layout, unroll) combinations csrc/paths_variants.cu and
# csrc/heston_variants.cu build.
VARIANTS = tuple(
    [(e, lay, u) for lay in ("flat", "blocked")
     for e, u in (("per_step", 1), ("bulk", 1), ("bulk", 2), ("bulk", 4), ("bulk", 10),
                  ("none", 1))]
    + [("per_step", "terminal", 1)])



def launch_key(exp_mode: str, layout: str, unroll: int, accurate: bool = False) -> str:
    """The ``launches`` key of a variant of either design."""
    return f"{exp_mode}/{layout}/{unroll}" + (" (first design)" if accurate else "")


# Kernel launches since the last reset, one integer per built variant of
# each design.
launches = {launch_key(e, lay, u, a): 0 for a in (False, True) for e, lay, u in VARIANTS}


def _check(exp_mode: str, layout: str, unroll: int, tile: int, n_steps: int,
           antithetic: bool) -> None:
    if (exp_mode, layout, unroll) not in VARIANTS:
        raise ValueError(f"no variant (exp_mode={exp_mode!r}, layout={layout!r}, "
                         f"unroll={unroll}); the built ones are {VARIANTS}")
    if n_steps % unroll != 0:
        raise ValueError(f"n_steps {n_steps} is not a multiple of unroll {unroll}")
    if tile <= 0 or tile % 128 != 0 or (antithetic and tile % 256 != 0):
        raise ValueError(f"tile must be a positive multiple of 128 lanes (of 256 with "
                         f"antithetic pairs), got {tile}")


def heston_variant_from_normals(z1: torch.Tensor, z2: torch.Tensor, S0, r, T, params,
                                exp_mode: str = "per_step", layout: str = "flat",
                                tile: int = PATH_TILE) -> torch.Tensor:
    """The variant's output on given normals (n_steps, n_pad) in path order.
    The exp mode changes values only for "none" (log S/S0, row 0 = 0)."""
    if exp_mode not in EXP_MODES or layout not in LAYOUTS:
        raise ValueError(f"exp_mode must be one of {EXP_MODES}, layout one of {LAYOUTS}")
    M = heston_euler_from_normals(z1, z2, S0, r, T, params,
                                  return_paths=layout != "terminal",
                                  log_relative=exp_mode == "none")
    if layout == "blocked":
        return M.reshape(M.shape[0], -1, tile).permute(1, 0, 2).contiguous()
    return M


def heston_variant_reference(seed: int, S0, r, T, params, n_paths: int, n_steps: int,
                             exp_mode: str = "per_step", layout: str = "flat",
                             unroll: int = 1, tile: int = PATH_TILE,
                             antithetic: bool = True, first_tile: int = 0,
                             device=None) -> torch.Tensor:
    """Plain version of a variant: kernel 4's Philox draws at ``tile`` paths
    per tile (n_pad = n_paths rounded up to it), in the variant's form."""
    _check(exp_mode, layout, unroll, tile, n_steps, antithetic)
    n_tiles = _tiles(n_paths, tile, seed, first_tile, n_steps)
    z = path_normals(seed, first_tile, n_tiles, tile, 2 * n_steps, antithetic, device)
    return heston_variant_from_normals(z[0::2], z[1::2], S0, r, T, params, exp_mode,
                                       layout, tile)


def _variant(accurate: bool, seed, S0, r, T, params, n_paths, n_steps, exp_mode, layout,
             unroll, tile, antithetic, first_tile, device) -> torch.Tensor:
    """A variant's output from csrc/paths_variants.cu (its constants a
    device row, as kernel 4 reads them) or csrc/heston_variants.cu (the
    first design: host constants), or from the plain version for a CPU
    device."""
    device = resolve_device(device)
    if device.type == "cpu":
        return heston_variant_reference(seed, S0, r, T, params, n_paths, n_steps, exp_mode,
                                        layout, unroll, tile, antithetic, first_tile, device)
    _build.require_cuda(device)
    _check(exp_mode, layout, unroll, tile, n_steps, antithetic)
    n_tiles = _tiles(n_paths, tile, seed, first_tile, n_steps)
    shape = {"flat": (n_steps + 1, n_tiles * tile), "blocked": (n_tiles, n_steps + 1, tile),
             "terminal": (n_tiles * tile,)}[layout]
    out = torch.empty(shape, dtype=torch.float32, device=device)
    if accurate:
        name, consts = "omt_heston_variant", _consts(S0, r, T, params, n_steps)
    else:
        row = batched_consts("euler", S0, r, [T], params, n_steps, device)
        name, consts = "omt_paths_variant", row.data_ptr()
    _build.launch(name, device, out.data_ptr(), consts, seed, first_tile, n_tiles, tile,
                  n_steps, int(antithetic), EXP_MODES.index(exp_mode), LAYOUTS.index(layout),
                  unroll)
    launches[launch_key(exp_mode, layout, unroll, accurate)] += 1
    return out


def heston_variant(seed: int, S0, r, T, params, n_paths: int, n_steps: int,
                   exp_mode: str = "per_step", layout: str = "flat", unroll: int = 1,
                   tile: int = PATH_TILE, antithetic: bool = True, first_tile: int = 0,
                   device=None) -> torch.Tensor:
    """A variant's output from csrc/paths_variants.cu, or from the plain
    version for a CPU device."""
    return _variant(False, seed, S0, r, T, params, n_paths, n_steps, exp_mode, layout, unroll,
                    tile, antithetic, first_tile, device)


def heston_variant_accurate(seed: int, S0, r, T, params, n_paths: int, n_steps: int,
                            exp_mode: str = "per_step", layout: str = "flat",
                            unroll: int = 1, tile: int = PATH_TILE, antithetic: bool = True,
                            first_tile: int = 0, device=None) -> torch.Tensor:
    """A variant's output from the first design (csrc/heston_variants.cu, on
    kernel 4's first-design step), or from the plain version for a CPU
    device. Only the experiments' first-design rows reach it."""
    return _variant(True, seed, S0, r, T, params, n_paths, n_steps, exp_mode, layout, unroll,
                    tile, antithetic, first_tile, device)
