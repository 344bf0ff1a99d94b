"""Launch bounds of the redesigned terminal kernels (csrc/terminal.cu) on
the card.

Each variant is a copy of csrc/ under build/ with terminal.cu's block size
or minimum resident blocks edited, built into a library of its own (the
build's file name hashes the sources). The local-vol (degree 7, the bench
smile), QE-M, Euler and GBM terminal kernels of every variant are then
timed at 2^22 x 100 in one process, the variants in turns (forward, then
backward), and printed beside the registers, spills and occupancy the card
reports.

    python -m options_model_tpu_torch.scripts.sweep_terminal_bounds

Runs on a CUDA device only and raises without one.
"""

from __future__ import annotations

import re
import shutil

import torch

from options_model_tpu_torch.core.config import HestonParams
from options_model_tpu_torch.ops import _build, cuda_gbm, cuda_heston, cuda_localvol
from options_model_tpu_torch.surface.cheb import compile_localvol_table
from options_model_tpu_torch.utils.profiling import card_line, time_per_call

_LV_BOUNDS = r"__launch_bounds__\(kBlock\)\nlocalvol_terminal_kernel"


def _min_blocks(n: int) -> list:
    return [(rf"constexpr int k{kernel}MinBlocks = 1;",
             f"constexpr int k{kernel}MinBlocks = {n};") for kernel in ("Qe", "Euler", "Gbm")] + [
        (_LV_BOUNDS, f"__launch_bounds__(kBlock, {n})\nlocalvol_terminal_kernel")]


# name -> (pattern, replacement) edits of terminal.cu
VARIANTS = {
    "as built (128 threads, no minimum)": [],
    "min 16 blocks": _min_blocks(16),
    "min 8 blocks": _min_blocks(8),
    "block 256": [(r"constexpr int kBlock = 128;", "constexpr int kBlock = 256;")],
    "block 512": [(r"constexpr int kBlock = 128;", "constexpr int kBlock = 512;")],
}
N_PATHS, N_STEPS, N_TIMED = 1 << 22, 100, 7


def _build_variant(i: int, edits: list, csrc) -> object:
    """The library of csrc/ with ``edits`` applied to terminal.cu."""
    d = _build.BUILD_DIR.parent / f"sweep_csrc_{i}"
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(csrc, d)
    src = (d / "terminal.cu").read_text()
    for pat, rep in edits:
        src, n = re.subn(pat, rep, src)
        if n != 1:
            raise RuntimeError(f"terminal.cu: {pat!r} matched {n} times")
    (d / "terminal.cu").write_text(src)
    _build.CSRC, _build._lib = d, None
    return _build.load_library()


def run(log=print) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("the sweep needs a CUDA device")
    log(f"card: {card_line()}")
    csrc, lib0 = _build.CSRC, _build._lib
    libs = {}
    try:
        for i, (name, edits) in enumerate(VARIANTS.items()):
            libs[name] = _build_variant(i, edits, csrc)
            log(f"{name}: {cuda_heston.terminal_kernel_attrs()}")
        hp = HestonParams(kappa=2.0, theta=0.04, xi=0.3, rho=-0.7, v0=0.04)
        table = compile_localvol_table(
            lambda S, tau: 0.2 + 0.1 * torch.abs(torch.log(100.0 / S)) + 0.02 * torch.sqrt(tau),
            100.0, 1.0, N_STEPS, 100.0)
        seed = 0x9E3779B97F4A7C15
        fns = {"localvol_terminal": lambda: cuda_localvol.localvol_terminal(
                   seed, 100.0, 0.05, 1.0, table, N_PATHS, N_STEPS, device="cuda"),
               "heston_terminal_qe": lambda: cuda_heston.heston_terminal_qe(
                   seed, 100.0, 0.05, 1.0, hp, N_PATHS, N_STEPS, device="cuda"),
               "heston_terminal": lambda: cuda_heston.heston_terminal(
                   seed, 100.0, 0.05, 1.0, hp, N_PATHS, N_STEPS, device="cuda"),
               "gbm_terminal": lambda: cuda_gbm.gbm_terminal(
                   seed, 100.0, 0.05, 0.2, 1.0, N_PATHS, N_STEPS, device="cuda")}
        times: dict = {}
        for name in list(VARIANTS) + list(VARIANTS)[::-1]:
            _build._lib = libs[name]
            for kernel, fn in fns.items():
                times.setdefault((kernel, name), []).append(time_per_call(fn, N_TIMED))
    finally:
        _build.CSRC, _build._lib = csrc, lib0
    for (kernel, name), t in times.items():
        log(f"{kernel:20s} {name:36s} " + " ".join(f"{x:.4f}" for x in t)
            + f"  mean {sum(t) / len(t):.4f} ms")
    return times


def main() -> None:
    run()


if __name__ == "__main__":
    main()
