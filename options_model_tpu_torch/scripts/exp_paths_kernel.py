"""Experiment on the card: kernel 4 as the pricers run it (the redesigned
Heston Euler paths kernel of csrc/heston_paths.cu, ``cuda_heston.heston_paths``)
against its store and exp variants (csrc/paths_variants.cu), with the old
headline on the first design beside them. The counterpart of
scripts/exp_paths_kernel.py, which asked the same of the TPU kernel: does
the per-step ``exp`` or the store pattern hold the paths kernel below the
device's write rate?

The set, at 2^19 paths x 100 steps (the JAX script's own):
  A      kernel 4 itself (without v): S stored each step, tile 4096
  B      bulk exp: store log S - log S0 each step, one exp pass over the
         column after
  E2-E10 B with 2, 4, 10 steps held in registers before their row stores
  E4/16  E4 at tile 2048 (16 rows of 128 on the TPU)
  D      log only: store log S - log S0, no exp at all (the exp's upper bound)
  B0     B on kernel 4's first design (csrc/heston_variants.cu,
         ``heston_variant_accurate``), the headline before the redesign
Before timing, each tile-4096 variant is pinned against its design of
kernel 4 at 2^14 x 20 (the JAX script's pin): B, E and B0 equal it bit for
bit, D within rtol 1e-6 after exp(log S0 + out). Times are CUDA-event
medians of 7 after warm-up.

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
LOG_RTOL = 1e-6  # exp(log S0 + ls) in torch against the kernel's ex2.approx
# label, exp_mode, unroll, tile, first design; exp_mode None is kernel 4 itself
VARIANTS = (
    ("A kernel 4, per-step exp", None, 1, 4096, False),
    ("B bulk exp", "bulk", 1, 4096, False),
    ("E2 batched stores U=2", "bulk", 2, 4096, False),
    ("E4 batched stores U=4", "bulk", 4, 4096, False),
    ("E10 batched stores U=10", "bulk", 10, 4096, False),
    ("E4/16 batched stores U=4, tile 2048", "bulk", 4, 2048, False),
    ("D log only", "none", 1, 4096, False),
    ("B0 bulk exp, first design", "bulk", 1, 4096, True),
)


def _call(seed: int, exp_mode, unroll: int, tile: int, n_paths: int, n_steps: int,
          accurate: bool = False, device="cuda"):
    if exp_mode is None:
        fn = cuda_heston.heston_paths_accurate if accurate else cuda_heston.heston_paths
        return fn(seed, S0, R, T, HESTON, n_paths, n_steps, device=device)
    fn = (cuda_heston_variants.heston_variant_accurate if accurate
          else cuda_heston_variants.heston_variant)
    return fn(seed, S0, R, T, HESTON, n_paths, n_steps, exp_mode, "flat", unroll, tile,
              device=device)


def pin(exp_mode, unroll: int, accurate: bool = False, seed: int = 7,
        device="cuda") -> float:
    """Max relative difference from kernel 4 of the same design at
    PIN_PATHS x PIN_STEPS; raises where a tile-4096 variant breaks the
    equality it must keep."""
    a = _call(seed, None, 1, 4096, PIN_PATHS, PIN_STEPS, accurate, device)
    b = _call(seed, exp_mode, unroll, 4096, PIN_PATHS, PIN_STEPS, accurate, device)
    if exp_mode == "none":
        b = torch.exp(float(heston_constants(S0, R, T, HESTON, PIN_STEPS)["log_s0"]) + b)
    err = float(((a - b).abs() / a).max())
    limit = LOG_RTOL if exp_mode == "none" else 0.0
    if not err <= limit:
        raise RuntimeError(f"variant ({exp_mode}, U={unroll}, first design {accurate}) "
                           f"differs from kernel 4 by {err:.3e} relative (limit {limit})")
    return err


def run(n_paths: int = N_PATHS, n_steps: int = N_STEPS, log=print):
    """Pin and time the set; returns one dict per variant with its label,
    (exp_mode, layout, unroll, tile), whether it is the first design, ms,
    path-steps/s and output GB/s."""
    if not torch.cuda.is_available():
        raise RuntimeError("the kernel experiments need a CUDA device")
    log(f"card: {card_line()}; {n_paths} paths x {n_steps} steps, Heston Euler, f32")
    rows = []
    for label, exp_mode, unroll, tile, accurate in VARIANTS:
        err = pin(exp_mode, unroll, accurate) if tile == 4096 else None
        ms = time_per_call(lambda: _call(1, exp_mode, unroll, tile, n_paths, n_steps,
                                         accurate))
        out_bytes = (n_steps + 1) * n_paths * 4
        row = dict(label=label, variant=(exp_mode, "flat", unroll, tile), accurate=accurate,
                   ms=ms, path_steps_per_s=n_paths * n_steps / ms * 1e3,
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
