"""Kernel 21 (csrc/vg.cu) on the card: why the F3 surface's batch (64
maturities x 16,384 x 50, one launch) timed slower than F2's 2^20 x 50 for
the same path-steps, and what holds the redesign. Both designs, and
ablations of them, are timed at 2^20 x 50 under the gamma shapes of the
batch's end maturities (a = T / 50 / nu = 0.01 at T = 0.1, 0.1 at T = 1)
beside F2's (0.05 at T = 0.5), VG(0.2, -0.14, 0.2) as in chip_smoke.py, and
on the batch, through the wrappers (vg_paths, vg_paths_first: the host
builds the constants rows and copies them in) and as bare launches
(launch_vg_paths on rows and outputs made beforehand); beside them the
host's time for the batch's 64 constants rows.

At a = 0.01 about four clock increments G in ten are 0 or subnormal, and
libdevice's sqrtf sends inputs below ~2^-101 down a slow path. The
ablations are copies of csrc/ under build/ with vg.cu edited (as
sweep_terminal_bounds.py builds its variants), each built into a library
of its own:
- "redesign, sqrtf": the redesign's walk takes sqrtf(G) for sqrt_clock(G);
- "redesign, SFU boost": the redesign's boost on lg2 and ex2.approx (it
  flushes subnormal gammas to 0, so its draws are not the plain version's);
- "first design, sqrt_clock": the first design's increment takes
  sqrt_clock(G) for sqrtf(G) (bit for bit the same S);
- "redesign, chunk 4" and "chunk 16": kChunk steps a chunk (8 as built;
  the shared memory a block, so the blocks an SM, scale with it);
- "redesign, chunk 4, 16 blocks": chunk 4 with __launch_bounds__(kBlock,
  16), registers capped for a full SM.
Each shape also prints the mean attempts a draw and the share of G that is
0 or subnormal, from the redesign's debug outputs, and the script fails
unless the redesign's gammas and attempts equal the first design's bit for
bit there. Times are CUDA-event medians (utils/profiling.time_per_call),
each call timed in turns: the libraries forward, then backward.

    python -m options_model_tpu_torch.scripts.exp_vg_clock

On a CUDA device only.
"""

from __future__ import annotations

import re
import shutil
import statistics
import time

import numpy as np
import torch

from options_model_tpu_torch.core.config import VGParams
from options_model_tpu_torch.ops import _build, cuda_vg
from options_model_tpu_torch.ops.cuda_jumps import device_rows
from options_model_tpu_torch.utils.profiling import card_line, time_per_call

VG = VGParams(sigma=0.2, theta=-0.14, nu=0.2)
SEED = 0x13198A2E03707344
N_PATHS, N_STEPS, N_TIMED = 1 << 20, 50, 7
SHAPES = {0.01: 0.1, 0.05: 0.5, 0.1: 1.0}        # gamma shape a -> T at 50 steps, nu 0.2
BATCH_TS = np.linspace(0.1, 1.0, 64).astype(np.float32).tolist()
FLT_MIN = float(np.finfo(np.float32).tiny)



def _chunk(n: int) -> tuple:
    return r"constexpr int kChunk = 8;", f"constexpr int kChunk = {n};"


# library -> (edits of vg.cu, the designs timed with it)
LIBRARIES = {
    "as built": ([], ("first design", "redesign")),
    "redesign, sqrtf": ([(r"x\[p\] \+= fmaf\(k\.sigma \* sqrt_clock\(G\)",
                          "x[p] += fmaf(k.sigma * sqrtf(G)")], ("redesign",)),
    "redesign, SFU boost": ([(r"\? boosted\(g, tag, k\) : g;",
                              "? fast::ex2_approx(fast::lg2_approx(g) + fast::lg2_approx("
                              "uniform_from_bits(tag)) * k.inv_a) : g;")], ("redesign",)),
    "first design, sqrt_clock": ([(r"__fmul_rn\(k\.sigma, sqrtf\(G\)\)",
                                   "__fmul_rn(k.sigma, sqrt_clock(G))")], ("first design",)),
    "redesign, chunk 4": ([_chunk(4)], ("redesign",)),
    "redesign, chunk 16": ([_chunk(16)], ("redesign",)),
    "redesign, chunk 4, 16 blocks": ([_chunk(4),
                                      (r"__launch_bounds__\(kBlock\)\nvg_paths_kernel\(",
                                       "__launch_bounds__(kBlock, 16)\nvg_paths_kernel(")],
                                     ("redesign",)),
}


def _library(i: int, edits: list, csrc):
    """The kernel library of csrc/ with ``edits`` applied to vg.cu."""
    if not edits:
        _build.CSRC, _build._lib = csrc, None
        return _build.load_library()
    d = _build.BUILD_DIR.parent / f"vg_clock_csrc_{i}"
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(csrc, d)
    src = (d / "vg.cu").read_text()
    for pat, rep in edits:
        src, n = re.subn(pat, rep, src)
        if n != 1:
            raise RuntimeError(f"vg.cu: {pat!r} matched {n} times")
    (d / "vg.cu").write_text(src)
    _build.CSRC, _build._lib = d, None
    return _build.load_library()


def _design(name: str):
    return cuda_vg.vg_paths_first if name == "first design" else cuda_vg.vg_paths


def _clock_stats(log) -> None:
    """Mean attempts, the share of G = nu gamma that is 0 or subnormal, and
    the two designs' draws bit for bit, at each shape."""
    for a, T in SHAPES.items():
        _, g, att = cuda_vg.vg_paths(SEED, 100.0, 0.05, [T], VG, N_PATHS, N_STEPS,
                                     device="cuda", return_draws=True)
        _, g1, att1 = cuda_vg.vg_paths_first(SEED, 100.0, 0.05, [T], VG, N_PATHS, N_STEPS,
                                             device="cuda", return_draws=True)
        if not (torch.equal(att, att1) and torch.equal(g.view(torch.int32),
                                                       g1.view(torch.int32))):
            raise RuntimeError(f"a = {a}: the redesign's gamma draws are not the first "
                               "design's")
        G = float(np.float32(VG.nu)) * g
        log(f"a = {a} (T = {T}): mean attempts {float(att.double().mean()) + 1:.5f} a draw, "
            f"G = 0 {float((G == 0).double().mean()):.4f}, subnormal "
            f"{float(((G > 0) & (G < FLT_MIN)).double().mean()):.4f}; both designs' gammas "
            "and attempts bit for bit")


def _bare(first_design: bool, Ts, n_paths: int):
    """A bare launch of one design on outputs and constants made once."""
    rows = device_rows(cuda_vg.vg_rows(100.0, 0.05, Ts, VG, N_STEPS), "cuda")
    S = torch.empty((len(Ts), N_STEPS + 1, n_paths), dtype=torch.float32, device="cuda")
    return lambda: cuda_vg.launch_vg_paths(S, None, None, rows, SEED, 0, True, first_design)


def _host_rows_ms(n: int = 21) -> float:
    """Median host ms of the batch's constants rows, built and copied in."""
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        device_rows(cuda_vg.vg_rows(100.0, 0.05, BATCH_TS, VG, N_STEPS), "cuda")
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def run(log=print) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("the experiment needs a CUDA device")
    log(f"card: {card_line()}")
    csrc, lib0 = _build.CSRC, _build._lib
    libs, times = {}, {}
    try:
        for i, (name, (edits, _)) in enumerate(LIBRARIES.items()):
            libs[name] = _library(i, edits, csrc)
            log(f"{name}: {cuda_vg.vg_kernel_attrs()}")
        _build._lib = libs["as built"]
        _clock_stats(log)
        log(f"the F3 batch's 64 constants rows on the host: {_host_rows_ms():.4f} ms (median)")
        calls = {}
        for lib, (_, designs) in LIBRARIES.items():
            for design in designs:
                fn = _design(design)
                for a, T in SHAPES.items():
                    calls[lib, design, f"a = {a}"] = (
                        lambda fn=fn, T=T: fn(SEED, 100.0, 0.05, [T], VG, N_PATHS, N_STEPS,
                                              device="cuda"))
                calls[lib, design, "F3 batch"] = (
                    lambda fn=fn: fn(SEED, 100.0, 0.05, BATCH_TS, VG, 16384, N_STEPS,
                                     device="cuda"))
                calls[lib, design, "F3 bare"] = _bare(design == "first design", BATCH_TS, 16384)
                calls[lib, design, "F2 bare"] = _bare(design == "first design", [0.5], N_PATHS)
        order = list(LIBRARIES) + list(LIBRARIES)[::-1]
        for lib in order:
            _build._lib = libs[lib]
            for key, fn in calls.items():
                if key[0] == lib:
                    times.setdefault(key, []).append(time_per_call(fn, N_TIMED))
    finally:
        _build.CSRC, _build._lib = csrc, lib0
    for (lib, design, shape), t in times.items():
        log(f"{design:13s} {lib:29s} {shape:9s} " + " ".join(f"{x:.4f}" for x in t)
            + f"  mean {sum(t) / len(t):.4f} ms")
    return times


def main() -> None:
    run()


if __name__ == "__main__":
    main()
