#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (options_model_tpu_torch) once on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
1. build the CUDA kernels from csrc/ (one nvcc per source, all at once) and
   print the card's name and power limit; count the time loops of kernels
   4 and 6 (both designs) in SASS, and there the integer instructions of a
   Philox call;
2. each of the eight path kernels against its plain PyTorch version on the
   card, at 2 and 64 tiles and at its path's shape: equal Philox bits, S
   (and v) within the stated tolerances, and bit-equal chunks at a
   ``first_tile`` offset; the same for the first design of kernels 4 and 6
   (csrc/heston.cu, csrc/heston_qe.cu), which no pricer reaches any more;
   the maturity-batched paths kernel (csrc/heston_paths.cu) at the 64 x
   16,384 x 50 surface shape: each maturity's slice bit-equal to a
   single-maturity launch, bit-equal ``first_tile`` chunks, within its
   tolerances of the plain version (QE-M's v bit for bit); a constant-sigma
   local-vol table against the GBM kernel; kernel 4's first design
   bit-equal to its output before heston_common.cuh (a recorded digest);
   every store/exp/layout variant of csrc/heston_variants.cu against its
   plain version (rtol 1e-5 on S) and against that first design (bit for
   bit; the log-only form within rtol 1e-6 after exp), with bit-equal
   ``first_tile`` chunks;
3. the paths, each driven with every launch count set to 0 just before it
   and read just after:
   a. the main path through ``price_american``: the pooled Heston American
      put against the extrapolated ADI oracle, the GBM put against CRR, and
      the European branch (Heston against COS, GBM against Black-Scholes);
   b. the QE-M and local-vol path: the pooled QE American put against ADI,
      the QE European put against COS, the local-vol European call (a
      martingale check on the bench smile, and a constant-sigma table
      against Black-Scholes), the local-vol American put against CRR, and
      the 64x64 strike x maturity surface (Euler and QE) with three cells
      against the ADI oracle;
   c. the NN-LSM path through ``price_american``: the GBM put (the JAX
      bench's NN+CV leg) against CRR and the Heston put against ADI, with
      the seconds of simulation, fit and predict;
   d. the two kernel-4 experiments (options_model_tpu_torch/scripts/
      exp_paths_kernel.py and exp_fullpath_layout.py) at their scripts'
      shapes, each variant also held against its plain version there;
4. the launch counts of each path, none of its kernels at 0, the first
   design of kernels 4 and 6 at 0, and one paths launch per 64x64 Heston
   surface;
5. each kernel's time and its plain version's (CUDA events, median of 7
   after warm-up) beside its bound; for kernels 4 and 6 also the first
   design's time, the surface shape (one batched launch against 64 single
   launches of either design), registers and occupancy; the American puts
   and the surface's ADI cells beside the first design's; seconds per
   price and per surface.
The second-to-last line is a JSON object with one entry per TPU kernel (the
variants of kernels 9 and 10 listed under theirs); the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import hashlib
import json
import math
import re
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

# Kernel vs plain version, same Philox bits: the normals differ only in the
# last ulps (FMA contraction), which 50-100 steps compound to ~1e-6 relative.
S_RTOL = 1e-5
V_ATOL = 1e-6
V_RTOL = 1e-5
# Accuracy gates of the main path.
HESTON_ADI_ORACLE = 4.592463   # extrapolated f64 ADI value of the Heston put (host PDE)
HESTON_GATE = 0.0025
GBM_GATE = 0.0015
EURO_HESTON_BIAS = 0.003       # full-truncation Euler at 100 steps, beyond the stderr
QE_GATE = 0.0025               # the pooled QE American put against the ADI oracle
EURO_QE_BIAS = 0.001           # QE-M at 100 steps, beyond the stderr
SURFACE_BIAS = 0.005           # 50-date Bermudan gap and degree-3 basis, beyond the stderr
LV_RTOL = 2e-5                 # constant-sigma table vs GBM: drift and diffusion rounded apart
LOG_RTOL = 1e-6                # torch's exp of the log-only variant against the kernel's expf
GBM_CRR = 4.655534             # CRR(4096) of the GBM put, S0 = K = 100, T = 0.5, r = 0.05, 0.2
NN_GBM_BIAS = 0.0015           # NN+CV put vs CRR: 4 stderr + 0.15% (50-date Bermudan, net error)
NN_HESTON_BIAS = 0.01          # NN+CV Heston put vs ADI: 4 stderr + 1%
JAX_NN_BAR = 0.000327          # BENCH_r05 american_put_nn_rel_err_vs_crr (an accuracy, not a speed)
# sha256 of kernel 4's bytes before heston_common.cuh existed: heston_paths S
# and V (64 tiles x 50 steps, T 0.5) then heston_terminal S_T (16 tiles x
# 100 steps, T 1), seed 0x9E3779B97F4A7C15, recorded by kernel4_digest on an
# H100 (nvcc 12.9) from the sources that still defined the step in heston.cu.
KERNEL4_DIGEST = "99c2e49a1a0fc1af6cd697e95da4771a75a48862b5872a9fb6d488595c458096"
# The redesigned paths kernels (csrc/heston_paths.cu) against the plain
# version on the same Philox bits. Euler trades the last ulps (SFU sincos,
# lg2, sqrt and ex2; FMAs): the normals move by up to ~3e-6 absolute and the
# stored exp by ~4e-7 relative, which 50-100 steps of log S compound to
# ~1e-5 relative at most; v moves by ~1e-8 a step, more only where one
# version truncates v at 0 and the other not (sqrt(dv) then enters a step).
EULER_S_RTOL = 1e-4
EULER_V_ATOL = 1e-5
EULER_V_RTOL = 1e-4
# QE-M keeps its variance chain exact, so v is held bit for bit; the log-S
# chain (lg2.approx's ~3.6e-7 absolute error in k0 a step, FMAs, the stored
# ex2.approx) moves log S by ~1e-6-1e-5 over 50-100 steps.
QE_S_RTOL = 1e-4
# The pooled 4-seed American puts of phase 3 with the first design of
# kernels 4 and 6 (accurate math) on an H100, price and stderr.
EARLIER_EULER_PUT = (4.588986, 0.001954)
EARLIER_QE_PUT = (4.591477, 0.001960)
# The 64x64 surface (bench.py:546-550): maturities x paths x steps.
SURFACE_MATS, SURFACE_PATHS, SURFACE_STEPS = 64, 16384, 50
# The card's peaks (NVIDIA H100 SXM data sheet): f32 outside the tensor
# cores (an FMA counts as two operations), 32-bit integer instructions (64
# per clock per SM x 132 SMs at 1.98 GHz, the clock of the f32 figure) and
# device-memory bandwidth; resident threads per SM.
PEAK_F32_OPS = 67e12
PEAK_INT32_OPS = 64 * 132 * 1.98e9
PEAK_BYTES = 3.35e12
THREADS_PER_SM = 2048
# 32-bit integer instructions, counted as issued. A Philox4x32-10 call is 10
# rounds of two 32x32 -> 64-bit multiplies (one IMAD.WIDE.U32 each) and two
# 3-input XORs (one LOP3 each, the round key an operand of it: the key
# schedule is the same for every thread, so no kernel needs to repeat it,
# and csrc/heston_paths.cu reads it from its parameters), at most 40; a
# word made uniform is one LEA.HI. phase_sass counts a call's instructions
# in the SASS of the built Euler paths kernel, where the loop-invariant part
# of the first rounds is hoisted; without cuobjdump 40 are assumed.
PHILOX_ROUNDS = 10
PHILOX_XORS = 2 * PHILOX_ROUNDS
PHILOX_MULTIPLIERS = (0xD2511F53, 0xCD9E8D57)
# Philox draws per path-step: (calls, words made uniform). One call serves a
# pair for 2 steps (Euler), 1 step (QE-M, three words) or 4 steps (GBM,
# local vol).
DRAWS_HESTON = (1 / 4, 1)
DRAWS_QE = (1 / 2, 3 / 2)
DRAWS_GBM = (1 / 8, 1 / 2)
# f32 operations per path-step, counted from csrc/ (each add, multiply,
# compare and min/max one operation, a transcendental one).
#   Box-Muller: 2 uniform subtractions, 1 - u1, log, * -2, sqrt, 2 pi u2,
#   cos, sin, 2 multiplies = 11 per two normals.
#   heston_step 20; the mirror's negated normals 2 per pair.
OPS_HESTON = 20 + 11 / 2 + 1            # per path-step: one normal pair per pair-step
OPS_GBM = 11 / 4 + 1 / 2                # terminal: a += z per slot, 2 normals per 2 steps
OPS_GBM_PATHS = 11 / 4 + 5 + 1 / 2      # drift, diffusion * z, add, expf, * s0
#   QE-M: qe_step 51 on its quadratic branch (the one these parameters take),
#   a Box-Muller per pair-step, u, 1 - u and the negations.
OPS_QE = 51 + 11 / 2 + 1 / 2 + 1 / 2 + 1
#   Local vol at degree d: 17 + 4 d per step (clip, Clenshaw, update).
OPS_LV = 17 + 4 * 7 + 11 / 4 + 1 / 2
OPS_EXP = 2                             # expf(log_s0 + ls) per stored path-step
N_TIMED = 7
DEVICE = "cuda"


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    log(f"FAIL: {msg}")
    sys.exit(1)


def int_ops(draws, per_call: float) -> float:
    """32-bit integer instructions per path-step of ``draws`` (DRAWS_*) at
    ``per_call`` instructions per Philox call."""
    calls, words = draws
    return calls * per_call + words


def bound(n_paths: int, steps: int, ops_per_path_step: float, int_ops_per_path_step: float,
          out_bytes: float) -> dict:
    """The least time the card could take: the largest of the output's
    bytes over PEAK_BYTES, the counted f32 operations over PEAK_F32_OPS and
    the counted 32-bit integer instructions over PEAK_INT32_OPS. Returns
    bound_ms, bound_by ("bytes" or "operations"), bound_term ("bytes", "f32"
    or "int32") and bound_ms_f32_bytes, the bound without the integer term."""
    terms = {"bytes": out_bytes / PEAK_BYTES * 1e3,
             "f32": n_paths * steps * ops_per_path_step / PEAK_F32_OPS * 1e3,
             "int32": n_paths * steps * int_ops_per_path_step / PEAK_INT32_OPS * 1e3}
    term = max(terms, key=terms.get)
    return dict(bound_ms=terms[term], bound_by="bytes" if term == "bytes" else "operations",
                bound_term=term, bound_ms_f32_bytes=max(terms["bytes"], terms["f32"]))


def log_beside_earlier(tag: str, label: str, p: float, se: float, earlier) -> None:
    """A price beside the first design's on the same seeds: the two differ
    only through f32 rounding on the same Philox draws."""
    p0, se0 = earlier
    log(f"[{tag}] {label}: {p:.6f} +- {se:.6f}; first design of kernels 4 and 6 "
        f"{p0:.6f} +- {se0:.6f}; difference {p - p0:+.6f} ({(p - p0) / se:+.3f} stderr)")


def bench_smile(S, tau):
    """The JAX bench's local-vol smile (bench.py:156-158)."""
    import torch

    return 0.2 + 0.1 * torch.abs(torch.log(100.0 / S)) + 0.02 * torch.sqrt(tau)


def kernel_specs():
    """Per kernel: name, source, replaced Pallas function, the paths that
    run it ("main", "second", "nn"), its path's (tile count, steps), the
    timed (tile count, steps), f32 operations and Philox draws (DRAWS_*)
    per path-step (and the local-vol table it reads), the tolerances against
    its plain version (S rtol, v atol, v rtol), and run(plain, n_tiles,
    first_tile, n_steps, variance, antithetic). Kernels 4 and 6 also carry
    ``earlier``, the same for their first design, and their scheme."""
    from options_model_tpu_torch.core.config import HestonParams
    from options_model_tpu_torch.ops import cuda_gbm, cuda_heston, cuda_localvol
    from options_model_tpu_torch.surface.cheb import compile_localvol_table

    hp = HestonParams(kappa=2.0, theta=0.04, xi=0.3, rho=-0.7, v0=0.04)
    seed = 0x9E3779B97F4A7C15
    dev = DEVICE
    smile_paths = compile_localvol_table(bench_smile, 100.0, 0.5, 50, 100.0)
    smile_terminal = compile_localvol_table(bench_smile, 100.0, 1.0, 100, 100.0)

    def paths_run(kernel, reference):
        def run(plain, n_tiles, first_tile, n_steps, variance, anti=True):
            fn = reference if plain else kernel
            out = fn(seed, 100.0, 0.05, 0.5, hp, n_tiles * cuda_heston.PATH_TILE, n_steps,
                     anti, variance, first_tile, dev)
            return out if variance else (out,)
        return run

    def heston_terminal(plain, n_tiles, first_tile, n_steps, variance, anti=True):
        fn = cuda_heston.heston_terminal_reference if plain else cuda_heston.heston_terminal
        return (fn(seed, 100.0, 0.05, 1.0, hp, n_tiles * cuda_heston.TERMINAL_TILE,
                   n_steps, anti, first_tile, dev),)

    def gbm_paths(plain, n_tiles, first_tile, n_steps, variance, anti=True):
        fn = cuda_gbm.gbm_paths_reference if plain else cuda_gbm.gbm_paths
        return (fn(seed, 100.0, 0.05, 0.2, 0.5, n_tiles * cuda_heston.PATH_TILE, n_steps,
                   anti, first_tile, dev),)

    def gbm_terminal(plain, n_tiles, first_tile, n_steps, variance, anti=True):
        fn = cuda_gbm.gbm_terminal_reference if plain else cuda_gbm.gbm_terminal
        return (fn(seed, 100.0, 0.05, 0.2, 1.0, n_tiles * cuda_heston.TERMINAL_TILE,
                   n_steps, anti, first_tile, dev),)

    def heston_terminal_qe(plain, n_tiles, first_tile, n_steps, variance, anti=True):
        fn = (cuda_heston.heston_terminal_qe_reference if plain
              else cuda_heston.heston_terminal_qe)
        return (fn(seed, 100.0, 0.05, 1.0, hp, n_tiles * cuda_heston.TERMINAL_TILE,
                   n_steps, anti, first_tile, dev),)

    def localvol_paths(plain, n_tiles, first_tile, n_steps, variance, anti=True):
        fn = cuda_localvol.localvol_paths_reference if plain else cuda_localvol.localvol_paths
        return (fn(seed, 100.0, 0.05, 0.5, smile_paths, n_tiles * cuda_heston.PATH_TILE,
                   n_steps, anti, first_tile, dev),)

    def localvol_terminal(plain, n_tiles, first_tile, n_steps, variance, anti=True):
        fn = (cuda_localvol.localvol_terminal_reference if plain
              else cuda_localvol.localvol_terminal)
        return (fn(seed, 100.0, 0.05, 1.0, smile_terminal,
                   n_tiles * cuda_heston.TERMINAL_TILE, n_steps, anti, first_tile, dev),)

    src = "options_model_tpu_torch/csrc/"
    L = cuda_heston.launches
    euler_tol = (EULER_S_RTOL, EULER_V_ATOL, EULER_V_RTOL)
    return [
        dict(name="heston_paths", source=src + "heston_paths.cu", scheme="euler",
             run=paths_run(cuda_heston.heston_paths, cuda_heston.heston_paths_reference),
             replaces="options_model_tpu/ops/pallas_heston.py:319", paths=("main", "nn"),
             tile=cuda_heston.PATH_TILE, main=(256, 50), timed=(256, 50), variance=(False, True),
             ops=OPS_HESTON + OPS_EXP, draws=DRAWS_HESTON, tol=euler_tol,
             counter=(L, "heston_paths"),
             earlier=dict(name="heston_paths_accurate", source=src + "heston.cu",
                          run=paths_run(cuda_heston.heston_paths_accurate,
                                        cuda_heston.heston_paths_reference),
                          counter=(L, "heston_paths_accurate"))),
        dict(name="heston_terminal", run=heston_terminal, source=src + "heston.cu",
             replaces="options_model_tpu/ops/pallas_heston.py:263", paths=("main",),
             tile=cuda_heston.TERMINAL_TILE, main=(256, 100), timed=(256, 100),
             variance=(False,), ops=OPS_HESTON, draws=DRAWS_HESTON,
             counter=(cuda_heston.launches, "heston_terminal")),
        dict(name="gbm_paths", run=gbm_paths, source=src + "gbm.cu",
             replaces="options_model_tpu/ops/pallas_gbm.py:126", paths=("main", "nn"),
             tile=cuda_heston.PATH_TILE, main=(512, 50), timed=(256, 50), variance=(False,),
             ops=OPS_GBM_PATHS, draws=DRAWS_GBM, counter=(cuda_gbm.launches, "gbm_paths")),
        dict(name="gbm_terminal", run=gbm_terminal, source=src + "gbm.cu",
             replaces="options_model_tpu/ops/pallas_gbm.py:100", paths=("main",),
             tile=cuda_heston.TERMINAL_TILE, main=(256, 100), timed=(256, 100),
             variance=(False,), ops=OPS_GBM, draws=DRAWS_GBM,
             counter=(cuda_gbm.launches, "gbm_terminal")),
        dict(name="heston_terminal_qe", run=heston_terminal_qe, source=src + "heston_qe.cu",
             replaces="options_model_tpu/ops/pallas_heston.py:512", paths=("second",),
             tile=cuda_heston.TERMINAL_TILE, main=(256, 100), timed=(256, 100),
             variance=(False,), ops=OPS_QE, draws=DRAWS_QE,
             counter=(cuda_heston.launches, "heston_terminal_qe")),
        dict(name="heston_paths_qe", source=src + "heston_paths.cu", scheme="qe",
             run=paths_run(cuda_heston.heston_paths_qe, cuda_heston.heston_paths_qe_reference),
             replaces="options_model_tpu/ops/pallas_heston.py:543", paths=("second",),
             tile=cuda_heston.PATH_TILE, main=(256, 50), timed=(256, 50),
             variance=(False, True), ops=OPS_QE + OPS_EXP, draws=DRAWS_QE,
             tol=(QE_S_RTOL, 0.0, 0.0), counter=(L, "heston_paths_qe"),
             earlier=dict(name="heston_paths_qe_accurate", source=src + "heston_qe.cu",
                          run=paths_run(cuda_heston.heston_paths_qe_accurate,
                                        cuda_heston.heston_paths_qe_reference),
                          counter=(L, "heston_paths_qe_accurate"))),
        dict(name="localvol_terminal", run=localvol_terminal, source=src + "localvol.cu",
             replaces="options_model_tpu/ops/pallas_localvol.py:62", paths=("second",),
             tile=cuda_heston.TERMINAL_TILE, main=(256, 100), timed=(256, 100),
             variance=(False,), ops=OPS_LV, draws=DRAWS_GBM, table=smile_terminal,
             counter=(cuda_localvol.launches, "localvol_terminal")),
        dict(name="localvol_paths", run=localvol_paths, source=src + "localvol.cu",
             replaces="options_model_tpu/ops/pallas_localvol.py:149", paths=("second",),
             tile=cuda_heston.PATH_TILE, main=(512, 50), timed=(256, 50), variance=(False,),
             ops=OPS_LV + 1, draws=DRAWS_GBM, table=smile_paths,
             counter=(cuda_localvol.launches, "localvol_paths")),
    ]


def phase_build() -> None:
    import torch

    from options_model_tpu_torch.ops import _build

    t0 = time.perf_counter()
    path = _build.build()
    _build.load_library()
    log(f"[1] built {path.name} in {time.perf_counter() - t0:.2f} s")
    from options_model_tpu_torch.utils.profiling import card_line

    log(f"[1] card: {card_line()}")
    log(f"[1] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)} "
        f"x{torch.cuda.device_count()}")


# Mangled-name pieces of the paths kernels' pricing instances (antithetic,
# with v): the redesign (csrc/heston_paths.cu) and the first design.
SASS_KERNELS = {"euler": "18euler_paths_kernelILb1ELb1E", "qe": "15qe_paths_kernelILb1ELb1E",
                "euler, first design": "13heston_kernelILb1E",
                "qe, first design": "16heston_qe_kernelILb1E"}


def sass_loops(text: str) -> dict:
    """The instructions of the largest loop (the span of a backward branch)
    of each SASS_KERNELS kernel in ``cuobjdump -sass`` output."""
    out = {}
    for chunk in text.split("Function : ")[1:]:
        name = chunk.split(None, 1)[0]
        key = next((k for k, piece in SASS_KERNELS.items() if piece in name), None)
        if key is None:
            continue
        labels, branches, pending, code = {}, [], [], []
        for line in chunk.splitlines():
            lab = re.match(r"\s*(\.L_x_\d+):", line)
            if lab:
                pending.append(lab.group(1))
                continue
            m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
            if not m:
                continue
            addr = int(m.group(1), 16)
            code.append((addr, m.group(2)))
            for lab_name in pending:
                labels[lab_name] = addr
            pending = []
            if "BRA" in m.group(2):
                tgt = re.search(r"`\((\.L_x_\d+)\)|\b0x([0-9a-f]+)\b", m.group(2))
                if tgt:
                    branches.append((addr, tgt.group(1) or int(tgt.group(2), 16)))
        spans = [(labels.get(t, t), addr) for addr, t in branches
                 if isinstance(labels.get(t, t), int) and labels.get(t, t) <= addr]
        lo, hi = max(spans, key=lambda s: s[1] - s[0]) if spans else (0, -1)
        out[key] = [ins for addr, ins in code if lo <= addr <= hi]
    return out


def opcode(ins: str) -> str:
    return re.sub(r"^@!?U?P\w+\s+", "", ins.strip()).split()[0]


def phase_sass() -> dict:
    """The time loops of both designs of the paths kernels in SASS
    (cuobjdump -sass of the built library, static instructions) and, from the
    Euler redesign's loop, the integer instructions of one Philox call: the
    multiplies (the instructions whose immediate is a Philox multiplier; one
    IMAD.WIDE.U32 gives hi and lo) and the XORs (LOP3 with LUT 0x96, a ^ b ^
    c), per four words made uniform (LEA.HI into 0x3f800000). The loop-
    invariant part of the first rounds (slot and tile are fixed for a
    thread) is hoisted out of the loop, so it is not counted. Returns
    per_call and how it was found."""
    import shutil
    import subprocess

    from options_model_tpu_torch.ops import _build

    assumed = dict(per_call=2 * PHILOX_ROUNDS + PHILOX_XORS, source="assumed")
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        log(f"[1] SASS: no cuobjdump; not measured; Philox assumed {assumed['per_call']} "
            "integer instructions a call")
        return assumed
    text = subprocess.run([tool, "-sass", str(_build.library_path())], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    loops = sass_loops(text)
    log("[1] SASS time loops (static instructions; the redesigned Euler loop covers two "
        "steps and one Philox call, the first design's one step with a Philox call every "
        "other step): " + ", ".join(f"{k} {len(v)}" for k, v in loops.items()))
    imm = [f"0x{m:x}" for m in PHILOX_MULTIPLIERS] + [f"-0x{(1 << 32) - m:x}"
                                                       for m in PHILOX_MULTIPLIERS]
    loop = loops.get("euler", [])
    muls = [ins for ins in loop if any(re.search(rf"{x}\b", ins) for x in imm)]
    xors = [ins for ins in loop
            if opcode(ins).startswith("LOP3") and re.search(r"\b0x96\b", ins)]
    words = [ins for ins in loop if opcode(ins).startswith("LEA.HI") and "0x3f800000" in ins]
    calls = len(words) / 4
    if not muls or not calls or calls != int(calls):
        log(f"[1] SASS: {len(muls)} multiply instructions, {len(xors)} XORs and "
            f"{len(words)} words made uniform in the Euler loop, no whole number of Philox "
            f"calls; Philox assumed {assumed['per_call']} integer instructions a call")
        return assumed
    per_call = (len(muls) + len(xors)) / calls
    ops = [opcode(ins) for ins in muls]
    kinds = {op: ops.count(op) for op in sorted(set(ops))}
    log(f"[1] SASS: the Euler loop holds {int(calls)} Philox call(s) a pass: {len(muls)} "
        f"multiply instructions ({', '.join(f'{n} {op}' for op, n in kinds.items())}), "
        f"{len(xors)} 3-input XORs (LOP3 0x96) and {len(words)} LEA.HI, one per word made "
        f"uniform; counted {per_call:g} integer instructions a call (Philox's 20 multiplies "
        f"and 20 XORs less the loop-invariant ones)")
    return dict(per_call=per_call, source="sass", multiplies=kinds, xors=len(xors),
                loops={k: len(v) for k, v in loops.items()})


def phase_philox() -> None:
    import torch

    from options_model_tpu_torch.ops.philox import stream_words, stream_words_cuda

    for n_tiles, first_tile in ((2, 0), (64, 0), (2, 7)):
        args = (0x0123456789ABCDEF, first_tile, n_tiles, 2048, 25)
        got = stream_words_cuda(*args, device=DEVICE)
        want = stream_words(*args, device=DEVICE)
        if not torch.equal(got, want):
            fail(f"Philox words differ at {n_tiles} tiles, first_tile {first_tile}")
    log("[2] Philox words: kernel == plain, bit for bit (2 and 64 tiles, offset 7)")


def earlier_specs(specs) -> list:
    """The first design of kernels 4 and 6 as specs of their own, held to
    the tolerances they were built to (S_RTOL, V_ATOL, V_RTOL)."""
    return [dict(k, **k["earlier"], tol=(S_RTOL, V_ATOL, V_RTOL)) for k in specs
            if "earlier" in k]


def phase_kernels(specs) -> dict:
    """Kernel vs plain at 2 and 64 tiles and at the main path's shape (and
    at 2 tiles without antithetic mirroring), within each spec's tolerances,
    and the first_tile chunk property. Returns per name the max |kernel -
    plain| of S, the max relative one, and the max |kernel - plain| of v."""
    import torch

    errs = {}
    for k in specs:
        n_main, steps = k["main"]
        s_rtol, v_atol, v_rtol = k.get("tol", (S_RTOL, V_ATOL, V_RTOL))
        err = dict(s_abs=0.0, s_rel=0.0, v_abs=0.0)
        for variance in k["variance"]:
            for n_tiles, anti in ((2, True), (64, True), (n_main, True), (2, False)):
                got = k["run"](False, n_tiles, 0, steps, variance, anti)
                want = k["run"](True, n_tiles, 0, steps, variance, anti)
                torch.cuda.synchronize()
                for name, g, w in zip("Sv", got, want):
                    if g.shape != w.shape or not bool(torch.isfinite(g).all()):
                        fail(f"{k['name']}: {name} shape {tuple(g.shape)} vs "
                             f"{tuple(w.shape)} or non-finite")
                    rtol, atol = (s_rtol, 0.0) if name == "S" else (v_rtol, v_atol)
                    diff = (g - w).abs()
                    bad = diff > atol + rtol * w.abs()
                    e = float(diff.max())
                    if bool(bad.any()):
                        fail(f"{k['name']} {n_tiles} tiles: {name} differs from the "
                             f"plain version (max abs {e:.3e}, {int(bad.sum())} "
                             f"entries beyond rtol {rtol}, atol {atol})")
                    if name == "S":
                        err["s_abs"] = max(err["s_abs"], e)
                        err["s_rel"] = max(err["s_rel"], float((diff / w.abs()).max()))
                    else:
                        err["v_abs"] = max(err["v_abs"], e)
                del got, want
            # chunk property: tiles [half, n) of a 64-tile run at offset half
            full = k["run"](False, 64, 0, steps, variance)
            part = k["run"](False, 32, 32, steps, variance)
            cols = 32 * k["tile"]
            for f, p in zip(full, part):
                if not torch.equal(f[..., cols:], p):
                    fail(f"{k['name']}: a run at first_tile 32 differs from the "
                         "matching slice of the full run")
            v_txt = ("v bit for bit" if v_atol == v_rtol == 0.0
                     else f"rtol {v_rtol} + atol {v_atol} on v")
            log(f"[2] {k['name']} (variance={variance}): kernel == plain within "
                f"rtol {s_rtol} on S" + (f", {v_txt}" if variance else "")
                + f" at 2, 64, {n_main} tiles x {steps} steps (and 2 tiles without "
                  f"antithetics): max |dS| {err['s_abs']:.3e} (max rel {err['s_rel']:.3e})"
                + (f", max |dv| {err['v_abs']:.3e}" if variance else "")
                + "; first_tile=32 chunk equals the full run's slice bit for bit")
        errs[k["name"]] = err
    return errs


def phase_batched(specs) -> None:
    """The batched paths kernel at the 64 x 16,384 x 50 surface shape, with
    v: each maturity's slice equals a single-maturity launch of the same
    kernel at first_tile m n_tiles, bit for bit; a launch over maturities
    32..63 at first_tile 32 n_tiles equals the full launch's slices; three
    maturities against the plain version within the spec's tolerances; and
    the same at 2 tiles x 3 maturities without antithetics."""
    import numpy as np
    import torch

    from options_model_tpu_torch.core.config import HestonParams
    from options_model_tpu_torch.ops import cuda_heston

    hp = HestonParams(kappa=2.0, theta=0.04, xi=0.3, rho=-0.7, v0=0.04)
    seed = 0x9E3779B97F4A7C15
    Ts = np.linspace(0.1, 1.0, SURFACE_MATS).astype(np.float32)
    n_tiles = SURFACE_PATHS // cuda_heston.PATH_TILE
    for k in specs:
        if "scheme" not in k:
            continue
        scheme = k["scheme"]
        single = cuda_heston.heston_paths_qe if scheme == "qe" else cuda_heston.heston_paths
        plain = (cuda_heston.heston_paths_qe_reference if scheme == "qe"
                 else cuda_heston.heston_paths_reference)
        s_rtol, v_atol, v_rtol = k["tol"]

        def batched(Ts, first_tile=0, n_paths=SURFACE_PATHS, anti=True):
            return cuda_heston.heston_paths_batched(seed, 100.0, 0.05, Ts, hp, n_paths,
                                                    SURFACE_STEPS, anti, True, first_tile,
                                                    DEVICE, scheme)

        S, V = batched(Ts)
        if S.shape != (SURFACE_MATS, SURFACE_STEPS + 1, SURFACE_PATHS):
            fail(f"batched {scheme}: shape {tuple(S.shape)}")
        for m, T in enumerate(Ts.tolist()):
            S1, V1 = single(seed, 100.0, 0.05, T, hp, SURFACE_PATHS, SURFACE_STEPS, True, True,
                            m * n_tiles, DEVICE)
            if not (torch.equal(S[m], S1) and torch.equal(V[m], V1)):
                fail(f"batched {scheme}: maturity {m} differs from its single launch")
        S2, V2 = batched(Ts[32:], 32 * n_tiles)
        if not (torch.equal(S[32:], S2) and torch.equal(V[32:], V2)):
            fail(f"batched {scheme}: the first_tile chunk differs from the full launch")
        worst = [0.0, 0.0]
        for m in (0, 21, 63):
            Sp, Vp = plain(seed, 100.0, 0.05, float(Ts[m]), hp, SURFACE_PATHS, SURFACE_STEPS,
                           True, True, m * n_tiles, DEVICE)
            dS, dV = (S[m] - Sp).abs(), (V[m] - Vp).abs()
            if (bool((dS > s_rtol * Sp.abs()).any())
                    or bool((dV > v_atol + v_rtol * Vp.abs()).any())):
                fail(f"batched {scheme}: maturity {m} outside its tolerances of the plain "
                     f"version (max |dS| {float(dS.max()):.3e}, |dv| {float(dV.max()):.3e})")
            worst = [max(worst[0], float((dS / Sp.abs()).max())), max(worst[1], float(dV.max()))]
        Sn, Vn = batched(Ts[:3], 5, 2 * cuda_heston.PATH_TILE, anti=False)
        for m in range(3):
            S1, V1 = single(seed, 100.0, 0.05, float(Ts[m]), hp, 2 * cuda_heston.PATH_TILE,
                            SURFACE_STEPS, False, True, 5 + 2 * m, DEVICE)
            if not (torch.equal(Sn[m], S1) and torch.equal(Vn[m], V1)):
                fail(f"batched {scheme} without antithetics: maturity {m} differs")
        torch.cuda.synchronize()
        log(f"[2] batched {k['name']} ({SURFACE_MATS} x {SURFACE_PATHS} x {SURFACE_STEPS}, "
            f"with v): every maturity == its single launch bit for bit; first_tile chunk "
            f"(maturities 32..63) bit-equal; vs plain at maturities 0, 21, 63: max rel dS "
            f"{worst[0]:.3e} (rtol {s_rtol}), max |dv| {worst[1]:.3e} "
            f"(atol {v_atol} + rtol {v_rtol}); 3 x 2 tiles without antithetics bit-equal "
            "to single launches")


def phase_constant_sigma() -> None:
    """A constant-sigma table through the local-vol paths kernel against the
    GBM paths kernel at the same seed: the same draws, so S agrees within
    LV_RTOL (the two round the drift and the diffusion differently)."""
    import torch

    from options_model_tpu_torch.ops import cuda_gbm, cuda_localvol
    from options_model_tpu_torch.surface.cheb import compile_localvol_table

    table = compile_localvol_table(lambda S, tau: torch.full_like(S, 0.2), 100.0, 0.5, 50,
                                   100.0)
    for n_tiles, first_tile in ((2, 0), (64, 5)):
        n = n_tiles * 4096
        lv = cuda_localvol.localvol_paths(123, 100.0, 0.05, 0.5, table, n, 50,
                                          first_tile=first_tile, device=DEVICE)
        g = cuda_gbm.gbm_paths(123, 100.0, 0.05, 0.2, 0.5, n, 50, first_tile=first_tile,
                               device=DEVICE)
        err = float(((lv - g).abs() / g.abs()).max())
        if not err <= LV_RTOL:
            fail(f"constant-sigma localvol_paths differs from gbm_paths at {n_tiles} "
                 f"tiles: max rel {err:.3e} > {LV_RTOL}")
        log(f"[2] constant-sigma localvol_paths == gbm_paths at {n_tiles} tiles x 50 steps "
            f"(first_tile {first_tile}): max rel {err:.3e} (rtol {LV_RTOL})")


def kernel4_digest() -> str:
    """sha256 of the output of kernel 4's first design (csrc/heston.cu) at
    the KERNEL4_DIGEST arguments."""
    import torch

    from options_model_tpu_torch.core.config import HestonParams
    from options_model_tpu_torch.ops import cuda_heston

    hp = HestonParams(kappa=2.0, theta=0.04, xi=0.3, rho=-0.7, v0=0.04)
    seed = 0x9E3779B97F4A7C15
    S, V = cuda_heston.heston_paths_accurate(seed, 100.0, 0.05, 0.5, hp, 64 * 4096, 50, True,
                                             True, 0, DEVICE)
    ST = cuda_heston.heston_terminal(seed, 100.0, 0.05, 1.0, hp, 16 * 16384, 100, True, 0,
                                     DEVICE)
    torch.cuda.synchronize()
    h = hashlib.sha256()
    for x in (S, V, ST):
        h.update(x.cpu().numpy().tobytes())
    return h.hexdigest()


def phase_kernel4_digest() -> None:
    got = kernel4_digest()
    if got != KERNEL4_DIGEST:
        fail(f"kernel 4's output changed with heston_common.cuh: digest {got}, recorded "
             f"{KERNEL4_DIGEST}")
    log("[2] kernel 4's first design (heston_paths_accurate with v, heston_terminal) "
        "bit-equal to its output "
        f"before heston_common.cuh: sha256 {got[:16]}...")


def check_variant(hv, exp_mode, layout, unroll, tile, n_tiles, steps, seed=0x9E3779B97F4A7C15,
                  T=1.0) -> float:
    """A variant against its plain version on the same Philox bits: S (after
    exp(log S0 + out) for the log-only form) within rtol S_RTOL. Returns the
    max |kernel - plain| of S."""
    import torch

    from options_model_tpu_torch.core.config import HestonParams
    from options_model_tpu_torch.models.heston import heston_constants

    hp = HestonParams(kappa=2.0, theta=0.04, xi=0.3, rho=-0.7, v0=0.04)
    args = (seed, 100.0, 0.05, T, hp, n_tiles * tile, steps, exp_mode, layout, unroll, tile)
    got = hv.heston_variant(*args, device=DEVICE)
    want = hv.heston_variant_reference(*args, device=DEVICE)
    torch.cuda.synchronize()
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        fail(f"variant {exp_mode}/{layout}/{unroll} tile {tile}: shape {tuple(got.shape)} "
             f"vs {tuple(want.shape)} or non-finite")
    if exp_mode == "none":
        log_s0 = float(heston_constants(100.0, 0.05, T, hp, steps)["log_s0"])
        got, want = torch.exp(log_s0 + got), torch.exp(log_s0 + want)
    err = float((got - want).abs().max())
    if bool(((got - want).abs() > S_RTOL * want.abs()).any()):
        fail(f"variant {exp_mode}/{layout}/{unroll} tile {tile}: differs from its plain "
             f"version (max abs {err:.3e}, rtol {S_RTOL})")
    return err


def phase_variants() -> dict:
    """Every built variant of csrc/heston_variants.cu at tile 4096, 64 tiles
    x 100 steps: against its plain version, against kernel 4's first design
    (bit for bit; the log-only form within LOG_RTOL after exp), and a
    first_tile chunk.
    Returns the max |kernel - plain| of S per variant key."""
    import torch

    from options_model_tpu_torch.core.config import HestonParams
    from options_model_tpu_torch.models.heston import heston_constants
    from options_model_tpu_torch.ops import cuda_heston
    from options_model_tpu_torch.ops import cuda_heston_variants as hv

    hp = HestonParams(kappa=2.0, theta=0.04, xi=0.3, rho=-0.7, v0=0.04)
    seed, steps, tile = 0x9E3779B97F4A7C15, 100, cuda_heston.PATH_TILE
    k4 = cuda_heston.heston_paths_accurate(seed, 100.0, 0.05, 1.0, hp, 64 * tile, steps,
                                           device=DEVICE)
    log_s0 = float(heston_constants(100.0, 0.05, 1.0, hp, steps)["log_s0"])
    errs = {}
    for e, lay, u in hv.VARIANTS:
        key = f"{e}/{lay}/{u}"
        errs[key] = max(check_variant(hv, e, lay, u, tile, n, steps, seed) for n in (2, 64))
        out = hv.heston_variant(seed, 100.0, 0.05, 1.0, hp, 64 * tile, steps, e, lay, u, tile,
                                device=DEVICE)
        flat = out.permute(1, 0, 2).reshape(steps + 1, -1) if lay == "blocked" else out
        ref = k4[-1] if lay == "terminal" else k4
        if e == "none":
            rel = float(((torch.exp(log_s0 + flat) - ref).abs() / ref).max())
            if not rel <= LOG_RTOL:
                fail(f"variant {key}: exp(log S0 + out) differs from kernel 4 by {rel:.3e} "
                     f"relative (rtol {LOG_RTOL})")
            how = f"exp(log S0 + out) == kernel 4 within {rel:.2e} relative"
        elif torch.equal(flat, ref):
            how = "== kernel 4 bit for bit"
        else:
            fail(f"variant {key} differs from kernel 4")
        part = hv.heston_variant(seed, 100.0, 0.05, 1.0, hp, 32 * tile, steps, e, lay, u,
                                 tile, first_tile=32, device=DEVICE)
        tail = (out[:, 32 * tile:] if lay == "flat" else out[32:] if lay == "blocked"
                else out[32 * tile:])
        if not torch.equal(tail, part):
            fail(f"variant {key}: a run at first_tile 32 differs from the full run's slice")
        log(f"[2] variant {key}: kernel == plain within rtol {S_RTOL} at 2 and 64 tiles x "
            f"{steps} steps (max abs {errs[key]:.3e}); {how}; first_tile=32 chunk bit-equal")
    return errs


def phase_experiments(per_call: float) -> list:
    """The two kernel-4 experiments at their scripts' shapes, each driven
    with the variant counts at 0 and read after; every variant of them also
    held against its plain version at that shape, and the plain version
    timed; bounds at ``per_call`` integer instructions a Philox call.
    Returns one dict per experiment: rows, launches."""
    from options_model_tpu_torch.ops import cuda_heston_variants as hv
    from options_model_tpu_torch.scripts import exp_fullpath_layout, exp_paths_kernel
    from options_model_tpu_torch.utils.profiling import time_per_call

    out = []
    for number, mod in ((9, exp_paths_kernel), (10, exp_fullpath_layout)):
        for k in hv.launches:
            hv.launches[k] = 0
        rows = mod.run(mod.N_PATHS, mod.N_STEPS, log=lambda m, n=number: log(f"[3d] {n}: {m}"))
        launches = dict(hv.launches)
        log(f"[4] variant launches during experiment {number}: {launches}")
        for row in rows:
            e, lay, u, tile = row["variant"]
            if e is None:                  # kernel 4 itself, row A of experiment 9
                continue
            key = f"{e}/{lay}/{u}"
            if not launches[key]:
                fail(f"experiment {number}: variant {key} was never launched")
            n_paths, steps = mod.N_PATHS, mod.N_STEPS
            row["launches"] = launches[key]
            row["max_abs_err"] = check_variant(hv, e, lay, u, tile, n_paths // tile, steps)

            def plain(row=row, e=e, lay=lay, u=u, tile=tile):
                out = hv.heston_variant_reference(1, 100.0, 0.05, 1.0, mod.HESTON, n_paths,
                                                  steps, e, lay, u, tile, device=DEVICE)
                return out.permute(1, 0, 2).contiguous() if row.get("transpose") else out

            row["plain_ms"] = time_per_call(plain)
            stored = lay != "terminal"
            ops = OPS_HESTON + (OPS_EXP if stored and e != "none" else 0)
            row.update(bound(n_paths, steps, ops, int_ops(DRAWS_HESTON, per_call),
                             (steps + 1 if stored else 1) * n_paths * 4))
        out.append(dict(number=number, rows=rows, launches=launches))
    return out


def phase_nn() -> dict:
    """The NN-LSM path through price_american (LSMConfig(regressor="nn") at
    its defaults: 128 x 3, 25 epochs, batch 4096, lr 1e-3, dropout 0.1, 3
    policy iterations, optimal CV beta): the GBM put of the JAX bench's NN+CV
    leg against CRR, and the Heston put (BASELINE configs[2]) against ADI.
    Returns seconds per leg and per span."""
    import torch

    from options_model_tpu_torch.core.config import (PUT, HestonParams, LSMConfig,
                                                      MCConfig, OptionSpec)
    from options_model_tpu_torch.pricers.american import price_american
    from options_model_tpu_torch.pricers.binomial import crr_american
    from options_model_tpu_torch.utils.profiling import spans

    hp = HestonParams(kappa=2.0, theta=0.04, xi=0.3, rho=-0.7, v0=0.04)
    mc = MCConfig(n_paths=1 << 18, n_steps=50, path_block=4096)
    lsm = LSMConfig(regressor="nn")
    crr = crr_american(100.0, 100.0, 0.5, 0.05, 0.2, cp=-1.0, n_steps=4096)
    if abs(crr - GBM_CRR) > 1e-6:
        fail(f"CRR(4096) {crr} differs from the recorded {GBM_CRR}")
    secs = {}
    legs = (("nn_gbm", OptionSpec(strike=100.0, rate=0.05, cp=PUT, sigma=0.2), "gbm",
             None, crr, NN_GBM_BIAS, "CRR(4096)"),
            ("nn_heston", OptionSpec(strike=100.0, rate=0.05, cp=PUT, sigma=None), "heston",
             hp, HESTON_ADI_ORACLE, NN_HESTON_BIAS, "ADI"))
    for label, spec, model, heston, oracle, bias, oracle_name in legs:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with spans() as sp:
            p, se = price_american(torch.Generator().manual_seed(2026), 100.0, 0.5, spec, mc,
                                   lsm, model, heston=heston, device=DEVICE)
            p, se = float(p), float(se)
        total = time.perf_counter() - t0
        secs[label] = dict(sp, total=total)
        if not (math.isfinite(p) and math.isfinite(se) and se > 0):
            fail(f"{label}: non-finite price {p} +- {se}")
        rel = p / oracle - 1.0
        gate = 4.0 * se + bias * oracle
        log(f"[3c] {model} NN+CV American put (2^18 x 50, 128 x 3 MLP, 25 epochs, 3 policy "
            f"iterations): {p:.6f} +- {se:.6f}; {oracle_name} {oracle:.6f}; rel "
            f"{rel * 100:+.4f}% ({(p - oracle) / se:+.2f} stderr; gate 4 stderr + "
            f"{bias * 100}% = {gate:.6f})"
            + (f"; the JAX estimator's bar {JAX_NN_BAR * 100:.4f}% (BENCH_r05)"
               if model == "gbm" else ""))
        log(f"[3c] {label} seconds: total {total:.3f}, simulate {sp['simulate']:.3f}, fit "
            f"{sp['fit']:.3f}, predict {sp['predict']:.3f}")
        if not abs(p - oracle) <= gate:
            fail(f"{label} outside its gate")
    return secs


def phase_main_path() -> dict:
    """The main path through price_american. Returns seconds per price."""
    import numpy as np
    import torch

    from options_model_tpu_torch.calibration.charfn import heston_cos_price
    from options_model_tpu_torch.core.config import (CALL, PUT, HestonParams,
                                                      LSMConfig, MCConfig, OptionSpec)
    from options_model_tpu_torch.pricers.american import price_american
    from options_model_tpu_torch.pricers.binomial import crr_american
    from options_model_tpu_torch.pricers.blackscholes import bs_price

    hp = HestonParams(kappa=2.0, theta=0.04, xi=0.3, rho=-0.7, v0=0.04)
    secs = {}

    def priced(label, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p, se = price_american(*args, engine="auto", device=DEVICE, **kwargs)
        p, se = float(p), float(se)
        secs.setdefault(label, []).append(time.perf_counter() - t0)
        if not (math.isfinite(p) and math.isfinite(se) and se > 0):
            fail(f"{label}: non-finite price {p} +- {se}")
        return p, se

    # Heston American put, pooled over 4 seeds.
    spec_h = OptionSpec(strike=100.0, rate=0.05, cp=PUT, sigma=None)
    mc_h = MCConfig(n_paths=1 << 20, n_steps=50, path_block=4096)
    lsm_h = LSMConfig(poly_degree=5, variance_basis_degree=3, richardson=True)
    ps, ses = [], []
    for s in range(4):
        p, se = priced("heston_american", torch.Generator().manual_seed(2026 + s),
                       100.0, 0.5, spec_h, mc_h, lsm_h, "heston", heston=hp)
        log(f"[3] Heston American put, seed {s}: {p:.6f} +- {se:.6f}")
        ps.append(p)
        ses.append(se)
    p_h = float(np.mean(ps))
    se_h = math.sqrt(sum(x * x for x in ses)) / len(ses)
    rel = p_h / HESTON_ADI_ORACLE - 1.0
    log(f"[3] Heston American put pooled over 4 seeds (2^20 x 50, deg 5, v-deg 3, "
        f"Richardson + COS CV): {p_h:.6f} +- {se_h:.6f}; ADI oracle "
        f"{HESTON_ADI_ORACLE}; rel {rel * 100:+.4f}% (gate {HESTON_GATE * 100}%)")
    log_beside_earlier("3", "Heston American put pooled", p_h, se_h, EARLIER_EULER_PUT)
    if abs(rel) > HESTON_GATE:
        fail("Heston American put outside its gate")

    # GBM American put against CRR.
    spec_g = OptionSpec(strike=100.0, rate=0.05, cp=PUT, sigma=0.2)
    mc_g = MCConfig(n_paths=1 << 21, n_steps=50, path_block=4096)
    p_g, se_g = priced("gbm_american", torch.Generator().manual_seed(7), 100.0, 0.5,
                       spec_g, mc_g, LSMConfig(richardson=True), "gbm")
    crr = crr_american(100.0, 100.0, 0.5, 0.05, 0.2, cp=-1.0, n_steps=4096)
    rel = p_g / crr - 1.0
    log(f"[3] GBM American put (2^21 x 50, Richardson + BS CV): {p_g:.6f} +- "
        f"{se_g:.6f}; CRR(4096) {crr:.6f}; rel {rel * 100:+.4f}% "
        f"(gate {GBM_GATE * 100}%)")
    if abs(rel) > GBM_GATE:
        fail("GBM American put outside its gate")

    # European branch: the terminal kernels.
    mc_e = MCConfig(n_paths=1 << 22, n_steps=100, path_block=4096)
    euro = LSMConfig(european_approximation=True)
    spec_ep = OptionSpec(strike=100.0, rate=0.05, cp=PUT, sigma=None)
    p_e, se_e = priced("heston_european", torch.Generator().manual_seed(11), 100.0, 1.0,
                       spec_ep, mc_e, euro, "heston", heston=hp)
    cos = float(heston_cos_price(100.0, 100.0, 1.0, 0.05, hp, cp=-1.0,
                                 dtype=torch.float64))
    gap = p_e - cos
    log(f"[3] Heston European put (2^22 x 100): {p_e:.6f} +- {se_e:.6f}; COS f64 "
        f"{cos:.6f}; gap {gap:+.6f} ({gap / cos * 100:+.4f}%, "
        f"{gap / se_e:+.2f} stderr; gate 4 stderr + {EURO_HESTON_BIAS * 100}%)")
    if abs(gap) > 4.0 * se_e + EURO_HESTON_BIAS * cos:
        fail("Heston European put outside its gate")
    spec_ec = OptionSpec(strike=100.0, rate=0.05, cp=CALL, sigma=0.2)
    p_c, se_c = priced("gbm_european", torch.Generator().manual_seed(13), 100.0, 1.0,
                       spec_ec, mc_e, euro, "gbm")
    bs = float(bs_price(100.0, 100.0, 1.0, 0.05, 0.2, 1.0, dtype=torch.float64))
    gap = p_c - bs
    log(f"[3] GBM European call (2^22 x 100): {p_c:.6f} +- {se_c:.6f}; BS {bs:.6f}; "
        f"gap {gap:+.6f} ({gap / se_c:+.2f} stderr; gate 4 stderr)")
    if abs(gap) > 4.0 * se_c:
        fail("GBM European call outside its gate")
    return {k: statistics.median(v) for k, v in secs.items()}


def phase_second_path() -> dict:
    """The QE-M and local-vol path: Heston QE American and European, local
    vol European and American, the 64x64 surface (Euler and QE), each
    surface one launch of the batched paths kernel. Returns seconds per
    price or per surface, and per scheme the three ADI cells (strike index,
    maturity index, price, stderr, ADI)."""
    import dataclasses

    import numpy as np
    import torch

    from options_model_tpu_torch.calibration.charfn import heston_cos_price
    from options_model_tpu_torch.core.config import (CALL, PUT, HestonParams,
                                                      LSMConfig, MCConfig, OptionSpec)
    from options_model_tpu_torch.core.stats import masked_mean_stderr
    from options_model_tpu_torch.ops import cuda_heston
    from options_model_tpu_torch.ops.cuda_heston import TERMINAL_TILE
    from options_model_tpu_torch.ops.philox import seed_from_generator
    from options_model_tpu_torch.pricers.american import (_pair_block,
                                                          price_american_richardson,
                                                          richardson_cv_stat, simulate_paths)
    from options_model_tpu_torch.pricers.binomial import crr_american
    from options_model_tpu_torch.pricers.blackscholes import bs_price
    from options_model_tpu_torch.pricers.european import (make_terminal_sampler,
                                                          price_european_mc)
    from options_model_tpu_torch.pricers.fd_heston import heston_fd_price
    from options_model_tpu_torch.pricers.surface_american import price_american_surface
    from options_model_tpu_torch.surface.cheb import compile_localvol_table

    hp = HestonParams(kappa=2.0, theta=0.04, xi=0.3, rho=-0.7, v0=0.04)
    secs = {}

    def timed(label, fn, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        out = tuple(x.cpu() if isinstance(x, torch.Tensor) else x for x in out)
        secs.setdefault(label, []).append(time.perf_counter() - t0)
        return out

    def gen(seed):
        return torch.Generator().manual_seed(seed)

    # QE American put, pooled over 4 seeds: the paths kernel with v.
    spec_put = OptionSpec(strike=100.0, rate=0.05, cp=PUT, sigma=None)
    mc_h = MCConfig(n_paths=1 << 20, n_steps=50, path_block=4096)
    lsm_h = LSMConfig(poly_degree=5, variance_basis_degree=3, richardson=True)
    ps, ses = [], []
    for s in range(4):
        p, se = timed("qe_american", price_american_richardson, gen(2026 + s), 100.0, 0.5,
                      spec_put, mc_h, lsm_h, "heston", heston=hp, heston_scheme="qe",
                      device=DEVICE)
        p, se = float(p), float(se)
        if not (math.isfinite(p) and math.isfinite(se) and se > 0):
            fail(f"QE American put: non-finite price {p} +- {se}")
        log(f"[3b] QE American put, seed {s}: {p:.6f} +- {se:.6f}")
        ps.append(p)
        ses.append(se)
    p_q = float(np.mean(ps))
    se_q = math.sqrt(sum(x * x for x in ses)) / len(ses)
    rel = p_q / HESTON_ADI_ORACLE - 1.0
    log(f"[3b] QE American put pooled over 4 seeds (2^20 x 50, deg 5, v-deg 3, Richardson "
        f"+ COS CV): {p_q:.6f} +- {se_q:.6f}; ADI oracle {HESTON_ADI_ORACLE}; rel "
        f"{rel * 100:+.4f}% (gate {QE_GATE * 100}%)")
    log_beside_earlier("3b", "QE American put pooled", p_q, se_q, EARLIER_QE_PUT)
    if abs(rel) > QE_GATE:
        fail("QE American put outside its gate")

    # QE European put: the terminal QE kernel.
    mc_e = MCConfig(n_paths=1 << 22, n_steps=100, path_block=4096)
    sampler = make_terminal_sampler("heston", 100.0, 0.05, 1.0, heston=hp,
                                    heston_scheme="qe", device=DEVICE)
    p, se, _ = timed("qe_european", price_european_mc, gen(17), sampler, spec_put, 1.0,
                     mc_e)
    p, se = float(p), float(se)
    cos = float(heston_cos_price(100.0, 100.0, 1.0, 0.05, hp, cp=-1.0,
                                 dtype=torch.float64))
    gap = p - cos
    log(f"[3b] QE European put (2^22 x 100): {p:.6f} +- {se:.6f}; COS f64 {cos:.6f}; gap "
        f"{gap:+.6f} ({gap / cos * 100:+.4f}%, {gap / se:+.2f} stderr; gate 4 stderr + "
        f"{EURO_QE_BIAS * 100}%)")
    if not abs(gap) <= 4.0 * se + EURO_QE_BIAS * cos:
        fail("QE European put outside its gate")

    # Local-vol European call on the bench smile: the terminal local-vol kernel.
    smile = compile_localvol_table(bench_smile, 100.0, 1.0, 100, 100.0, degree=7)
    spec_call = OptionSpec(strike=100.0, rate=0.05, cp=CALL, sigma=None)
    sampler = make_terminal_sampler("localvol", 100.0, 0.05, 1.0, localvol_table=smile,
                                    device=DEVICE)
    p, se, _ = timed("localvol_european", price_european_mc, gen(19), sampler, spec_call,
                     1.0, mc_e)
    log(f"[3b] local-vol European call on the bench smile (2^22 x 100, degree 7): "
        f"{float(p):.6f} +- {float(se):.6f}")
    seed = seed_from_generator(gen(23))
    n_tiles = (1 << 22) // TERMINAL_TILE
    S_T = sampler(seed, 0, dataclasses.replace(mc_e, n_paths=n_tiles * TERMINAL_TILE))
    disc = math.exp(-0.05)
    m, m_se, _ = masked_mean_stderr(S_T.double() * disc, None, TERMINAL_TILE)
    m, m_se = float(m), float(m_se)
    log(f"[3b] local-vol martingale: mean(S_T) e^-rT = {m:.6f} +- {m_se:.6f}; S0 100; gap "
        f"{m - 100.0:+.6f} ({(m - 100.0) / m_se:+.2f} stderr; gate 4 stderr)")
    if not (math.isfinite(m) and abs(m - 100.0) <= 4.0 * m_se):
        fail("local-vol terminal prices are not a martingale within 4 stderr")
    flat = compile_localvol_table(lambda S, tau: torch.full_like(S, 0.2), 100.0, 1.0, 100,
                                  100.0)
    sampler = make_terminal_sampler("localvol", 100.0, 0.05, 1.0, localvol_table=flat,
                                    device=DEVICE)
    p, se, _ = price_european_mc(gen(29), sampler, spec_call, 1.0, mc_e)
    p, se = float(p), float(se)
    bs = float(bs_price(100.0, 100.0, 1.0, 0.05, 0.2, 1.0, dtype=torch.float64))
    log(f"[3b] local-vol European call, constant 0.2 table (2^22 x 100): {p:.6f} +- "
        f"{se:.6f}; BS {bs:.6f}; gap {(p - bs) / se:+.2f} stderr (gate 4)")
    if not abs(p - bs) <= 4.0 * se:
        fail("constant-sigma local-vol European call outside its gate")

    # Local-vol American put: simulate_paths + richardson_cv_stat, as the JAX
    # grid pricer runs each task (no control-variate leg under local vol).
    flat_h = compile_localvol_table(lambda S, tau: torch.full_like(S, 0.2), 100.0, 0.5, 50,
                                    100.0)
    mc_l = MCConfig(n_paths=1 << 21, n_steps=50, path_block=4096)
    pb = _pair_block(mc_l, "localvol")

    def localvol_american():
        S = simulate_paths(gen(31), 100.0, 0.5, mc_l, "localvol", rate=0.05,
                           localvol_table=flat_h, device=DEVICE)
        stat, mask = richardson_cv_stat(S, None, spec_put, 0.5, LSMConfig(richardson=True),
                                        model="localvol", pair_block=pb)
        return masked_mean_stderr(stat, mask, pb)[:2]

    p, se = timed("localvol_american", localvol_american)
    p, se = float(p), float(se)
    crr = crr_american(100.0, 100.0, 0.5, 0.05, 0.2, cp=-1.0, n_steps=4096)
    log(f"[3b] local-vol American put, constant 0.2 table (2^21 x 50, Richardson, no CV): "
        f"{p:.6f} +- {se:.6f}; CRR(4096) {crr:.6f}; gap {(p - crr) / se:+.2f} stderr "
        f"({(p / crr - 1.0) * 100:+.4f}%; gate 4 stderr)")
    if not abs(p - crr) <= 4.0 * se:
        fail("local-vol American put outside its gate")

    # The 64 x 64 surface (bench.py:546-550), Euler and QE.
    Ks = np.linspace(70.0, 130.0, 64).astype(np.float32)
    Ts = np.linspace(0.1, 1.0, 64).astype(np.float32)
    mc_s = MCConfig(n_paths=16384, n_steps=50, path_block=4096)
    cells = []
    for k, t in ((100.0, 0.5), (85.0, 0.25), (120.0, 1.0)):
        i, j = int(np.argmin(np.abs(Ks - k))), int(np.argmin(np.abs(Ts - t)))
        cells.append((i, j, heston_fd_price(100.0, float(Ks[i]), float(Ts[j]), 0.05, hp,
                                            cp=-1.0)))
    surface_cells = {}

    def one_launch(scheme, fn):
        """fn() must launch the batched paths kernel exactly once."""
        key = "heston_paths_qe" if scheme == "qe" else "heston_paths"
        before = cuda_heston.launches[key]
        out = fn()
        n = cuda_heston.launches[key] - before
        log(f"[4] {scheme} 64x64 surface: {n} launch of {key} ({SURFACE_MATS} maturities)")
        if n != 1:
            fail(f"the {scheme} surface launched {key} {n} times, not once")
        return out

    for scheme in ("euler", "qe"):
        P, SE = one_launch(scheme, lambda: timed(
            f"surface_{scheme}_with_stderr", price_american_surface, gen(37), 100.0, Ks, Ts,
            0.05, mc_s, cp=-1.0, heston=hp, heston_scheme=scheme, return_stderr=True,
            device=DEVICE))
        P, SE = P.numpy(), SE.numpy()
        surface_cells[scheme] = [(i, j, float(P[j, i]), float(SE[j, i]), fd)
                                 for i, j, fd in cells]
        if P.shape != (64, 64) or not np.isfinite(P).all() or not np.isfinite(SE).all():
            fail(f"{scheme} surface: shape {P.shape} or non-finite cells")
        worst = float(np.diff(P, axis=1).min())
        if worst < -1e-3:
            fail(f"{scheme} surface: a put falls with the strike by {-worst:.3e}")
        log(f"[3b] 64x64 {scheme} surface (16384 x 50): finite; min step in K {worst:+.3e} "
            f"(gate -1e-3); price range {P.min():.4f}..{P.max():.4f}")
        for i, j, fd in cells:
            gap = float(P[j, i]) - fd
            gate = 4.0 * float(SE[j, i]) + SURFACE_BIAS * fd
            log(f"[3b]   cell K {Ks[i]:.4f} T {Ts[j]:.4f}: {P[j, i]:.6f} +- {SE[j, i]:.6f}; "
                f"ADI {fd:.6f}; gap {gap:+.6f} ({gap / fd * 100:+.3f}%; gate {gate:.6f})")
            if not abs(gap) <= gate:
                fail(f"{scheme} surface cell (K {Ks[i]}, T {Ts[j]}) outside its gate")
        one_launch(scheme, lambda: timed(f"surface_{scheme}", lambda: (price_american_surface(
            gen(41), 100.0, Ks, Ts, 0.05, mc_s, cp=-1.0, heston=hp, heston_scheme=scheme,
            device=DEVICE),)))
    return {k: statistics.median(v) for k, v in secs.items()}, surface_cells


def phase_earlier_cells(cells: dict) -> None:
    """The surface's three ADI cells with the first design of kernels 4 and
    6: the same seed and tiles through heston_paths_accurate /
    heston_paths_qe_accurate and lsm_surface_backward, beside the cells of
    phase 3b (which launched the redesign). Run outside the paths' counts."""
    import numpy as np
    import torch

    from options_model_tpu_torch.core.config import HestonParams
    from options_model_tpu_torch.ops import cuda_heston
    from options_model_tpu_torch.ops.philox import seed_from_generator
    from options_model_tpu_torch.pricers.surface_american import (_pair_stderr,
                                                                  lsm_surface_backward)

    hp = HestonParams(kappa=2.0, theta=0.04, xi=0.3, rho=-0.7, v0=0.04)
    Ks = np.linspace(70.0, 130.0, 64).astype(np.float32)
    Ts = np.linspace(0.1, 1.0, 64).astype(np.float32)
    seed = seed_from_generator(torch.Generator().manual_seed(37))
    n_tiles = SURFACE_PATHS // cuda_heston.PATH_TILE
    for scheme, rows in cells.items():
        fn = (cuda_heston.heston_paths_qe_accurate if scheme == "qe"
              else cuda_heston.heston_paths_accurate)
        for i, j, p, se, fd in rows:
            S, V = fn(seed, 100.0, 0.05, float(Ts[j]), hp, SURFACE_PATHS, SURFACE_STEPS, True,
                      True, j * n_tiles, DEVICE)
            cash = lsm_surface_backward(S, torch.as_tensor(Ks, device=DEVICE), 0.05,
                                        float(Ts[j]), -1.0, return_cash=True, v_paths=V)
            p0 = float(cash.mean(dim=1)[i])
            se0 = float(_pair_stderr(cash, cuda_heston.PATH_TILE)[i])
            log(f"[5] {scheme} surface cell K {Ks[i]:.4f} T {Ts[j]:.4f}: {p:.6f} +- {se:.6f}; "
                f"first design {p0:.6f} +- {se0:.6f}; difference {p - p0:+.6f} "
                f"({(p - p0) / se:+.3f} stderr); ADI {fd:.6f}")


def phase_timing(specs, per_call: float) -> dict:
    """CUDA-event medians of each kernel and its plain version: 2^22 x 100
    for the terminal kernels, 2^20 x 50 (with v where there is one) for the
    paths kernels; and each one's bound at that shape. Kernels 4 and 6 also:
    their first design at 2^20 x 50, timed in turns with the redesign
    (earlier, new, new, earlier; each the mean of its two medians); the
    64 x 16,384 x 50 surface shape as one batched launch and as 64 single
    launches of either design; registers and occupancy of both designs.
    Bounds at ``per_call`` integer instructions a Philox call."""
    import numpy as np

    from options_model_tpu_torch.core.config import HestonParams
    from options_model_tpu_torch.ops import cuda_heston
    from options_model_tpu_torch.utils.profiling import time_per_call

    hp = HestonParams(kappa=2.0, theta=0.04, xi=0.3, rho=-0.7, v0=0.04)
    seed = 0x9E3779B97F4A7C15
    Ts = np.linspace(0.1, 1.0, SURFACE_MATS).astype(np.float32).tolist()
    n_surface_tiles = SURFACE_PATHS // cuda_heston.PATH_TILE
    attrs = cuda_heston.paths_kernel_attrs()
    out = {}
    for k in specs:
        n_tiles, steps = k["timed"]
        variance = k["variance"][-1]
        n = n_tiles * k["tile"]

        def kernel(run=k["run"]):
            return run(False, n_tiles, 0, steps, variance)

        if "earlier" in k:
            def earlier(run=k["earlier"]["run"]):
                return run(False, n_tiles, 0, steps, variance)

            t = [time_per_call(f, N_TIMED) for f in (earlier, kernel, kernel, earlier)]
            ms, earlier_ms = (t[1] + t[2]) / 2, (t[0] + t[3]) / 2
        else:
            ms = time_per_call(kernel, N_TIMED)
        plain_ms = time_per_call(lambda: k["run"](True, n_tiles, 0, steps, variance), N_TIMED)
        paths = k["tile"] == 4096
        out_bytes = ((steps + 1) * (2 if variance else 1) if paths else 1) * n * 4
        if "table" in k:
            out_bytes += k["table"].coeffs.numel() * 4   # the table, read once
        n_int = int_ops(k["draws"], per_call)
        b = bound(n, steps, k["ops"], n_int, out_bytes)
        rate = n * steps
        log(f"[5] {k['name']} {n} paths x {steps} steps{' with v' if variance else ''}: "
            f"kernel {ms:.4f} ms ({rate / ms * 1e3:.4e} path-steps/s"
            + (f", {out_bytes / ms / 1e9:.3f} TB/s written" if paths else "")
            + f"), plain {plain_ms:.4f} ms; bound {b['bound_ms']:.4f} ms by {b['bound_term']} "
              f"({k['ops']:.2f} f32 operations and {n_int:.2f} int32 instructions per "
              f"path-step, {out_bytes / 1e6:.1f} MB out); {b['bound_ms'] / ms * 100:.1f}% of bound "
              f"({b['bound_ms_f32_bytes'] / ms * 100:.1f}% of the bytes-or-f32 bound "
              f"{b['bound_ms_f32_bytes']:.4f} ms)")
        row = dict(ms=ms, plain_ms=plain_ms, **b)
        if "earlier" in k:
            scheme = k["scheme"]
            single, single0 = (
                (cuda_heston.heston_paths_qe, cuda_heston.heston_paths_qe_accurate)
                if scheme == "qe" else
                (cuda_heston.heston_paths, cuda_heston.heston_paths_accurate))

            def batched():
                return cuda_heston.heston_paths_batched(seed, 100.0, 0.05, Ts, hp,
                                                        SURFACE_PATHS, SURFACE_STEPS, True,
                                                        True, 0, DEVICE, scheme)

            def singles(fn):
                return lambda: [fn(seed, 100.0, 0.05, T, hp, SURFACE_PATHS, SURFACE_STEPS, True,
                                   True, m * n_surface_tiles, DEVICE)
                                for m, T in enumerate(Ts)]

            surface = dict(surface_batched_ms=time_per_call(batched, N_TIMED),
                           surface_single_ms=time_per_call(singles(single), N_TIMED),
                           earlier_surface_single_ms=time_per_call(singles(single0), N_TIMED))
            host = []
            for _ in range(N_TIMED):
                t0 = time.perf_counter()
                cuda_heston.batched_consts(scheme, 100.0, 0.05, Ts, hp, SURFACE_STEPS, DEVICE)
                host.append((time.perf_counter() - t0) * 1e3)
            surface["surface_consts_host_ms"] = statistics.median(host)
            new_a, old_a = attrs[k["name"]], attrs[k["earlier"]["name"]]
            occ = {key: a["blocks_per_sm"] * a["block"] / THREADS_PER_SM
                   for key, a in (("new", new_a), ("old", old_a))}
            row.update(earlier_ms=earlier_ms, **surface, registers=new_a["registers"],
                       spill_bytes=new_a["spill_bytes"], block=new_a["block"],
                       occupancy=occ["new"], earlier_registers=old_a["registers"],
                       earlier_spill_bytes=old_a["spill_bytes"], earlier_occupancy=occ["old"])
            log(f"[5] {k['name']} first design ({k['earlier']['source']}) at {n} x {steps} "
                f"with v: {earlier_ms:.4f} ms, {b['bound_ms'] / earlier_ms * 100:.1f}% of "
                f"bound; redesign {ms:.4f} ms ({t[1]:.4f}, {t[2]:.4f}; first design "
                f"{t[0]:.4f}, {t[3]:.4f})")
            log(f"[5] {k['name']} at the surface shape {SURFACE_MATS} x {SURFACE_PATHS} x "
                f"{SURFACE_STEPS} with v: one batched launch {surface['surface_batched_ms']:.4f} "
                f"ms ({b['bound_ms'] / surface['surface_batched_ms'] * 100:.1f}% of the same "
                f"bound); {SURFACE_MATS} single launches {surface['surface_single_ms']:.4f} ms "
                f"(redesign), {surface['earlier_surface_single_ms']:.4f} ms (first design); "
                f"the batched launch's host time for its constants "
                f"{surface['surface_consts_host_ms']:.4f} ms (within its time)")
            log(f"[5] {k['name']} registers and occupancy: redesign {new_a['registers']} "
                f"registers, {new_a['spill_bytes']} spill bytes, {new_a['blocks_per_sm']} "
                f"blocks of {new_a['block']} per SM ({occ['new'] * 100:.1f}% occupancy); first "
                f"design {old_a['registers']} registers, {old_a['spill_bytes']} spill bytes, "
                f"{old_a['blocks_per_sm']} blocks of {old_a['block']} "
                f"({occ['old'] * 100:.1f}%)")
        out[k["name"]] = row
    return out


def experiment_entry(exp: dict, headline: str, replaces: str, var_errs: dict) -> dict:
    """The kernels-line entry of kernel 9 or 10: the headline variant's
    numbers, the experiment's launches, and every variant under it."""
    src = "options_model_tpu_torch/csrc/heston_variants.cu"
    variants = []
    for row in exp["rows"]:
        if row["variant"][0] is None:
            continue
        e, lay, u, tile = row["variant"]
        variants.append(dict(
            name=row["label"], variant=f"{e}/{lay}/{u}", tile=tile, route="cuda",
            source=src, replaces=replaces, launches=row["launches"],
            max_abs_err=max(row["max_abs_err"], var_errs.get(f"{e}/{lay}/{u}", 0.0)),
            ms=row["ms"], plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], bound_term=row["bound_term"],
            bound_ms_f32_bytes=row["bound_ms_f32_bytes"], library_ms=None))
    head = next(v for v in variants if v["name"] == headline)
    script = "exp_paths_kernel" if exp["number"] == 9 else "exp_fullpath_layout"
    return dict(name=f"heston_variant ({script})",
                route="cuda", source=src, replaces=replaces,
                launches=sum(exp["launches"].values()),
                max_abs_err=max(v["max_abs_err"] for v in variants), ms=head["ms"],
                plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
                bound_by=head["bound_by"], bound_term=head["bound_term"],
                bound_ms_f32_bytes=head["bound_ms_f32_bytes"], library_ms=None,
                headline=headline,
                variants=variants)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device; torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from options_model_tpu_torch.utils.profiling import card_line

    phase_build()
    sass = phase_sass()
    specs = kernel_specs()
    phase_philox()
    errs = phase_kernels(specs + earlier_specs(specs))
    phase_batched(specs)
    phase_constant_sigma()
    phase_kernel4_digest()
    var_errs = phase_variants()

    counters = [k["counter"] for k in specs + earlier_specs(specs)]

    def drive(path, fn):
        """Run one path with every count at 0; fail if a kernel of that path
        was never launched, or if the first design of kernels 4 and 6 was.
        Returns (fn's result, that path's counts)."""
        for d, key in counters:
            d[key] = 0
        out = fn()
        counts = {k["name"]: k["counter"][0][k["counter"][1]] for k in specs}
        log(f"[4] kernel launches during the {path} path: {counts}")
        mine = {k["name"]: counts[k["name"]] for k in specs if path in k["paths"]}
        if not all(mine.values()):
            fail(f"a kernel of the {path} path was never launched: {mine}")
        earlier = {k["name"]: k["counter"][0][k["counter"][1]] for k in earlier_specs(specs)}
        log(f"[4] first-design launches during the {path} path: {earlier}")
        if any(earlier.values()):
            fail(f"the {path} path reached the first design of kernels 4 and 6: {earlier}")
        return out, mine

    secs, launches = drive("main", phase_main_path)
    (secs2, surface_cells), launches2 = drive("second", phase_second_path)
    launches.update(launches2)
    secs_nn, launches_nn = drive("nn", phase_nn)
    experiments = phase_experiments(sass["per_call"])

    phase_earlier_cells(surface_cells)
    times = phase_timing(specs, sass["per_call"])
    log("[5] main path seconds per price: "
        + ", ".join(f"{k} {v:.3f}" for k, v in secs.items()))
    log("[5] QE-M and local-vol path seconds per price or surface: "
        + ", ".join(f"{k} {v:.3f}" for k, v in secs2.items()))
    log("[5] NN-LSM path seconds per price: "
        + "; ".join(f"{k} " + ", ".join(f"{s} {v:.3f}" for s, v in d.items())
                    for k, d in secs_nn.items()))
    log(f"[5] NN-LSM path launches: {launches_nn}")
    log(f"[5] card: {card_line()}")

    entries = [dict(name=k["name"], route="cuda", source=k["source"], replaces=k["replaces"],
                    launches=launches[k["name"]], max_abs_err=errs[k["name"]]["s_abs"],
                    library_ms=None, **times[k["name"]]) for k in specs]
    entries.append(experiment_entry(experiments[0], "B bulk exp",
                                    "scripts/exp_paths_kernel.py:31", var_errs))
    entries.append(experiment_entry(experiments[1], "C  blocked, tile 4096",
                                    "scripts/exp_fullpath_layout.py:36", var_errs))
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
