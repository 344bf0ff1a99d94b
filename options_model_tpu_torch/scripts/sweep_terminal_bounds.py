"""Launch bounds of the redesigned terminal kernels (csrc/terminal.cu) and
of the redesigned local-vol paths kernel (kernel 8, csrc/localvol_paths.cu)
on the card.

Each variant is a copy of csrc/ under build/ with one source's block size
or minimum resident blocks edited, built into a library of its own (the
build's file name hashes the sources). The sweep "terminal" times the
local-vol (degree 7, the bench smile), QE-M, Euler and GBM terminal kernels
of every variant of terminal.cu at 2^22 x 100; the sweep "localvol_paths"
times kernel 8 at blocks of 128, 256 and 512 at 2^20 x 50 on the bench
smile (the kernel table's shape) and at 2^21 x 50 on a constant 0.2 table
(the local-vol American put's). Each runs in one process, the variants in
turns (forward, then backward), printed beside the registers, spills and
occupancy the card reports.

    python -m options_model_tpu_torch.scripts.sweep_terminal_bounds

Runs both sweeps, on a CUDA device only, and raises without one.
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


def _block(n: int) -> list:
    return [(r"constexpr int kBlock = 128;", f"constexpr int kBlock = {n};")]


# name -> (pattern, replacement) edits of terminal.cu
VARIANTS = {
    "as built (128 threads, no minimum)": [],
    "min 16 blocks": _min_blocks(16),
    "min 8 blocks": _min_blocks(8),
    "block 256": _block(256),
    "block 512": _block(512),
}
# name -> (pattern, replacement) edits of localvol_paths.cu
PATHS_VARIANTS = {
    "as built (128 threads)": [],
    "block 256": _block(256),
    "block 512": _block(512),
}
N_PATHS, N_STEPS, N_TIMED = 1 << 22, 100, 7


def _smile(S, tau):
    return 0.2 + 0.1 * torch.abs(torch.log(100.0 / S)) + 0.02 * torch.sqrt(tau)


def _build_variant(i: int, source: str, edits: list, csrc) -> object:
    """The library of csrc/ with ``edits`` applied to ``source``."""
    d = _build.BUILD_DIR.parent / f"sweep_csrc_{i}"
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(csrc, d)
    src = (d / source).read_text()
    for pat, rep in edits:
        src, n = re.subn(pat, rep, src)
        if n != 1:
            raise RuntimeError(f"{source}: {pat!r} matched {n} times")
    (d / source).write_text(src)
    _build.CSRC, _build._lib = d, None
    return _build.load_library()


def _terminal_fns() -> dict:
    hp = HestonParams(kappa=2.0, theta=0.04, xi=0.3, rho=-0.7, v0=0.04)
    table = compile_localvol_table(_smile, 100.0, 1.0, N_STEPS, 100.0)
    seed = 0x9E3779B97F4A7C15
    return {"localvol_terminal": lambda: cuda_localvol.localvol_terminal(
                seed, 100.0, 0.05, 1.0, table, N_PATHS, N_STEPS, device="cuda"),
            "heston_terminal_qe": lambda: cuda_heston.heston_terminal_qe(
                seed, 100.0, 0.05, 1.0, hp, N_PATHS, N_STEPS, device="cuda"),
            "heston_terminal": lambda: cuda_heston.heston_terminal(
                seed, 100.0, 0.05, 1.0, hp, N_PATHS, N_STEPS, device="cuda"),
            "gbm_terminal": lambda: cuda_gbm.gbm_terminal(
                seed, 100.0, 0.05, 0.2, 1.0, N_PATHS, N_STEPS, device="cuda")}


def _paths_fns() -> dict:
    smile = compile_localvol_table(_smile, 100.0, 0.5, 50, 100.0)
    flat = compile_localvol_table(lambda S, tau: torch.full_like(S, 0.2), 100.0, 0.5, 50,
                                  100.0)
    seed = 0x9E3779B97F4A7C15
    return {"localvol_paths 2^20 x 50 smile": lambda: cuda_localvol.localvol_paths(
                seed, 100.0, 0.05, 0.5, smile, 1 << 20, 50, device="cuda"),
            "localvol_paths 2^21 x 50 flat": lambda: cuda_localvol.localvol_paths(
                seed, 100.0, 0.05, 0.5, flat, 1 << 21, 50, device="cuda")}


# sweep -> (source edited, its variants, the timed calls, the attrs read)
SWEEPS = {"terminal": ("terminal.cu", VARIANTS, _terminal_fns,
                       lambda: cuda_heston.terminal_kernel_attrs()),
          "localvol_paths": ("localvol_paths.cu", PATHS_VARIANTS, _paths_fns,
                             lambda: cuda_localvol.paths_kernel_attrs())}


def run(sweep: str = "terminal", log=print) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("the sweep needs a CUDA device")
    source, variants, make_fns, attrs = SWEEPS[sweep]
    log(f"card: {card_line()}; sweep {sweep} ({source})")
    csrc, lib0 = _build.CSRC, _build._lib
    libs = {}
    try:
        for i, (name, edits) in enumerate(variants.items()):
            libs[name] = _build_variant(i, source, edits, csrc)
            log(f"{name}: {attrs()}")
        fns = make_fns()
        times: dict = {}
        for name in list(variants) + list(variants)[::-1]:
            _build._lib = libs[name]
            for kernel, fn in fns.items():
                times.setdefault((kernel, name), []).append(time_per_call(fn, N_TIMED))
    finally:
        _build.CSRC, _build._lib = csrc, lib0
    for (kernel, name), t in times.items():
        log(f"{kernel:32s} {name:36s} " + " ".join(f"{x:.4f}" for x in t)
            + f"  mean {sum(t) / len(t):.4f} ms")
    return times


def main() -> None:
    for sweep in SWEEPS:
        run(sweep)


if __name__ == "__main__":
    main()
