"""Experiment on the card: kernel 4 in its first design (the Heston Euler
paths kernel of csrc/heston.cu, ``cuda_heston.heston_paths_accurate``)
against its store and exp variants (csrc/heston_variants.cu).
The counterpart of scripts/exp_paths_kernel.py, which asked the same of the
TPU kernel: does the per-step ``exp`` or the store pattern hold the paths
kernel below the device's write rate?

The set, at 2^19 paths x 100 steps (the JAX script's own):
  A      kernel 4 itself: expf(log S0 + ls) stored each step, tile 4096
  B      bulk exp: store ls each step, one exp pass over the column after
  E2-E10 B with 2, 4, 10 steps held in registers before their row stores
  E4/16  E4 at tile 2048 (16 rows of 128 on the TPU)
  D      log only: store ls, no exp at all (the exp's upper bound)
Before timing, each tile-4096 variant is pinned against kernel 4 at 2^14 x
20 (the JAX script's pin): B and E equal it bit for bit, D within rtol 1e-6
after exp(log S0 + out). Times are CUDA-event medians of 7 after warm-up.

    python -m options_model_tpu_torch.scripts.exp_paths_kernel

Runs on a CUDA device only and raises without one.
"""

from __future__ import annotations

import torch

from options_model_tpu_torch.core.config import HestonParams
from options_model_tpu_torch.models.heston import heston_constants
from options_model_tpu_torch.ops import cuda_heston, cuda_heston_variants
from options_model_tpu_torch.utils.profiling import card_line, time_per_call

HESTON = HestonParams(kappa=2.0, theta=0.04, xi=0.3, rho=-0.7, v0=0.04)
S0, R, T = 100.0, 0.05, 1.0
N_PATHS, N_STEPS = 1 << 19, 100
PIN_PATHS, PIN_STEPS = 1 << 14, 20
LOG_RTOL = 1e-6  # exp(log S0 + ls) in torch against the kernel's expf
# label, exp_mode, unroll, tile; exp_mode None is kernel 4 itself
VARIANTS = (
    ("A kernel 4, per-step exp", None, 1, 4096),
    ("B bulk exp", "bulk", 1, 4096),
    ("E2 batched stores U=2", "bulk", 2, 4096),
    ("E4 batched stores U=4", "bulk", 4, 4096),
    ("E10 batched stores U=10", "bulk", 10, 4096),
    ("E4/16 batched stores U=4, tile 2048", "bulk", 4, 2048),
    ("D log only", "none", 1, 4096),
)


def _call(seed: int, exp_mode, unroll: int, tile: int, n_paths: int, n_steps: int):
    if exp_mode is None:
        return cuda_heston.heston_paths_accurate(seed, S0, R, T, HESTON, n_paths, n_steps,
                                                 device="cuda")
    return cuda_heston_variants.heston_variant(seed, S0, R, T, HESTON, n_paths, n_steps,
                                               exp_mode, "flat", unroll, tile,
                                               device="cuda")


def pin(exp_mode, unroll: int, seed: int = 7) -> float:
    """Max relative difference from kernel 4 at PIN_PATHS x PIN_STEPS; raises
    where a tile-4096 variant breaks the equality it must keep."""
    a = _call(seed, None, 1, 4096, PIN_PATHS, PIN_STEPS)
    b = _call(seed, exp_mode, unroll, 4096, PIN_PATHS, PIN_STEPS)
    if exp_mode == "none":
        b = torch.exp(float(heston_constants(S0, R, T, HESTON, PIN_STEPS)["log_s0"]) + b)
    err = float(((a - b).abs() / a).max())
    limit = LOG_RTOL if exp_mode == "none" else 0.0
    if not err <= limit:
        raise RuntimeError(f"variant ({exp_mode}, U={unroll}) differs from kernel 4 by "
                           f"{err:.3e} relative (limit {limit})")
    return err


def run(n_paths: int = N_PATHS, n_steps: int = N_STEPS, log=print):
    """Pin and time the set; returns one dict per variant with its label,
    (exp_mode, layout, unroll, tile), ms, path-steps/s and output GB/s."""
    if not torch.cuda.is_available():
        raise RuntimeError("the kernel experiments need a CUDA device")
    log(f"card: {card_line()}; {n_paths} paths x {n_steps} steps, Heston Euler, f32")
    rows = []
    for label, exp_mode, unroll, tile in VARIANTS:
        err = pin(exp_mode, unroll) if tile == 4096 else None
        ms = time_per_call(lambda: _call(1, exp_mode, unroll, tile, n_paths, n_steps))
        out_bytes = (n_steps + 1) * n_paths * 4
        row = dict(label=label, variant=(exp_mode, "flat", unroll, tile), ms=ms,
                   path_steps_per_s=n_paths * n_steps / ms * 1e3,
                   write_gb_s=out_bytes / ms / 1e6, pin_rel_err=err)
        rows.append(row)
        pin_txt = "" if err is None else f"   pin vs kernel 4: max rel {err:.2e}"
        log(f"{label:40s} {ms:8.4f} ms  {row['path_steps_per_s']:.4e} path-steps/s  "
            f"{row['write_gb_s']:7.1f} GB/s out{pin_txt}")
    return rows


def main() -> None:
    run()


if __name__ == "__main__":
    main()
