"""Experiment on the card: the output layout of the Heston Euler paths
kernel as the pricers run it (kernel 4, csrc/heston_paths.cu). The
counterpart of scripts/exp_fullpath_layout.py, which found the TPU's
flat-layout copy-out strided and slow: here the same set measures whether
layout or tile size moves the write rate of csrc/paths_variants.cu.

The set, at 2^20 paths x 100 steps (the JAX script's docstring):
  A/B  flat (n_steps+1, n_pad), bulk exp, tiles 4096 to 32768 (rows 32 to
       256); A is the TPU kernel's own rows=32
  C    blocked (n_tiles, n_steps+1, tile), bulk exp, the same tiles: as it
       comes out, and followed by ``permute(1, 0, 2).contiguous()`` to the
       flat matrix (the XLA transpose of the JAX script)
  C0   C at tile 4096 on kernel 4's first design (csrc/heston_variants.cu,
       ``heston_variant_accurate``), the headline before the redesign
  D    storeless: the same body, S_T only (kernel 4's compute floor)
Each row prints path-steps/s and the output's write rate against the
card's 3.35 TB/s. Before timing, at 2^14 x 20, C read back as flat equals
kernel 4 (``cuda_heston.heston_paths``) bit for bit and D its last row; C0
read back as flat equals the first design (``heston_paths_accurate``). The
TPU knob vmem_mb has no counterpart. Times are CUDA-event medians of 7
after warm-up.

    python -m options_model_tpu_torch.scripts.exp_fullpath_layout

Runs on a CUDA device only and raises without one.
"""

from __future__ import annotations

import torch

from options_model_tpu_torch.core.config import HestonParams
from options_model_tpu_torch.ops import cuda_heston, cuda_heston_variants
from options_model_tpu_torch.utils.profiling import card_line, time_per_call

HESTON = HestonParams(kappa=2.0, theta=0.04, xi=0.3, rho=-0.7, v0=0.04)
S0, R, T = 100.0, 0.05, 1.0
N_PATHS, N_STEPS = 1 << 20, 100
PIN_PATHS, PIN_STEPS = 1 << 14, 20
PEAK_WRITE_GB_S = 3350.0   # H100 SXM device memory, NVIDIA's data sheet
TILES = (4096, 8192, 16384, 32768)
# label, layout, tile, transpose-to-flat, first design
VARIANTS = tuple(
    [(f"{'A' if t == 4096 else 'B'}  flat, tile {t}", "flat", t, False, False) for t in TILES]
    + [(f"C  blocked, tile {t}{', then to flat' if tr else ''}", "blocked", t, tr, False)
       for t in TILES for tr in (False, True)]
    + [("C0 blocked, tile 4096, first design", "blocked", 4096, False, True),
       ("D  storeless, tile 4096", "terminal", 4096, False, False)])


def _call(seed: int, layout: str, tile: int, transpose: bool, n_paths: int, n_steps: int,
          accurate: bool = False, device="cuda"):
    exp_mode = "per_step" if layout == "terminal" else "bulk"
    fn = (cuda_heston_variants.heston_variant_accurate if accurate
          else cuda_heston_variants.heston_variant)
    out = fn(seed, S0, R, T, HESTON, n_paths, n_steps, exp_mode, layout, 1, tile,
             device=device)
    if transpose:
        out = out.permute(1, 0, 2).contiguous().reshape(n_steps + 1, -1)
    return out


def pin(seed: int = 7, device="cuda") -> None:
    """C read back as flat equals kernel 4 and D its last row, C0 read back
    as flat kernel 4's first design, bit for bit."""
    a = cuda_heston.heston_paths(seed, S0, R, T, HESTON, PIN_PATHS, PIN_STEPS, device=device)
    if not torch.equal(_call(seed, "blocked", 4096, True, PIN_PATHS, PIN_STEPS,
                             device=device), a):
        raise RuntimeError("the blocked layout read back as flat differs from kernel 4")
    if not torch.equal(_call(seed, "terminal", 4096, False, PIN_PATHS, PIN_STEPS,
                             device=device), a[-1]):
        raise RuntimeError("the storeless S_T differs from kernel 4's last row")
    a0 = cuda_heston.heston_paths_accurate(seed, S0, R, T, HESTON, PIN_PATHS, PIN_STEPS,
                                           device=device)
    if not torch.equal(_call(seed, "blocked", 4096, True, PIN_PATHS, PIN_STEPS, True,
                             device), a0):
        raise RuntimeError("the first design's blocked layout read back as flat differs "
                           "from its kernel 4")


def run(n_paths: int = N_PATHS, n_steps: int = N_STEPS, log=print):
    """Pin and time the set; returns one dict per variant with its label,
    (exp_mode, layout, unroll, tile), transpose, whether it is the first
    design, ms, path-steps/s and GB/s."""
    if not torch.cuda.is_available():
        raise RuntimeError("the kernel experiments need a CUDA device")
    log(f"card: {card_line()}; {n_paths} paths x {n_steps} steps, out "
        f"{(n_steps + 1) * n_paths * 4 / 1e9:.3f} GB")
    pin()
    log(f"pin at {PIN_PATHS} x {PIN_STEPS}: blocked read back as flat == kernel 4, "
        "storeless == its last row, the first design's blocked read back as flat == its "
        "kernel 4, bit for bit")
    rows = []
    for label, layout, tile, transpose, accurate in VARIANTS:
        ms = time_per_call(lambda: _call(1, layout, tile, transpose, n_paths, n_steps,
                                         accurate))
        out_bytes = (1 if layout == "terminal" else n_steps + 1) * n_paths * 4
        gb_s = out_bytes / ms / 1e6
        exp_mode = "per_step" if layout == "terminal" else "bulk"
        rows.append(dict(label=label, variant=(exp_mode, layout, 1, tile),
                         transpose=transpose, accurate=accurate, ms=ms,
                         path_steps_per_s=n_paths * n_steps / ms * 1e3, write_gb_s=gb_s))
        log(f"{label:38s} {ms:8.4f} ms  {n_paths * n_steps / ms * 1e3:.4e} path-steps/s  "
            f"{gb_s:7.1f} GB/s write ({gb_s / PEAK_WRITE_GB_S * 100:5.1f}% of "
            f"{PEAK_WRITE_GB_S:.0f})")
    return rows


def main() -> None:
    run()


if __name__ == "__main__":
    main()
