"""The fused rough Bergomi kernel (csrc/rbergomi.cu rbergomi_fused_kernel)
on the card: where its time goes. The kernel as built, and edits of it, are
timed at R5's shape (2^20 paths x 50 steps, T = 0.5, S and v stored; and
terminal, nothing stored a step) and at R4's CV shapes (2^16 x 32, T = 0.1,
and 2^16 x 96, T = 1), rBergomi(0.1, 1.5, -0.7, 0.04), as bare launches
(cuda_rbergomi.launch_rbergomi_fused on host tables and outputs made
beforehand).

The edits are copies of csrc/ under build/ with rbergomi.cu changed (as
exp_vg_terminal.py builds its), each built into a library of its own:
- "64 threads": blocks of 64 threads (128 as built), each walking one path,
  in chunks of 16 steps; "16-step chunks": eight threads a Volterra row,
  so chunks of 16 steps (32 as built);
- "no Volterra sum": G = 0 (the sum's share of the time); "no Philox": the
  stream's two Philox calls an item replaced by a few integer operations
  on the counter (their share); "no walk": the walk skipped (its share,
  the stores of S and v with it).
The first two must give the plain version's outputs bit for bit (2 tiles
x 50, every mode), or the script fails; the last three do not compute the
scheme. Times are CUDA-event medians (utils/profiling.time_per_call), each
call timed in turns: the libraries forward, then backward.

    python -m options_model_tpu_torch.scripts.exp_rbergomi_fused

On a CUDA device only.
"""

from __future__ import annotations

import re
import shutil

import torch

from options_model_tpu_torch.core.config import RBergomiParams
from options_model_tpu_torch.models.rbergomi import rbergomi_constants
from options_model_tpu_torch.ops import _build, cuda_rbergomi
from options_model_tpu_torch.utils.profiling import card_line, time_per_call

SEED = 0x5DEECE66D
N_TIMED = 7
PARAMS = RBergomiParams(H=0.1, eta=1.5, rho=-0.7, xi0=0.04)
# label -> (paths, steps, T, mode)
SHAPES = {"R5 2^20 x 50, S and v": (1 << 20, 50, 0.5, "paths"),
          "R5 2^20 x 50, terminal": (1 << 20, 50, 0.5, "terminal"),
          "R4 2^16 x 32, CV": (1 << 16, 32, 0.1, "cv"),
          "R4 2^16 x 96, CV": (1 << 16, 96, 1.0, "cv")}
_THREADS = (r"static constexpr int kThreads = 128;", "static constexpr int kThreads = 64;")
_BOUNDS = (r"__launch_bounds__\(Fused<kAnti>::kThreads, 8\)",
           "__launch_bounds__(Fused<kAnti>::kThreads, 16)")
_ROW8 = (r"static constexpr int kRowThreads = 4;", "static constexpr int kRowThreads = 8;")
_CHEAP = ("__device__ __forceinline__ Words counter_hash(Words c, const fast::PhiloxKeys& k) {\n"
          "  return Words{c.x * 2654435761u ^ c.y, (c.y * 40503u + c.z) ^ k.k0[0], c.x ^ c.z, "
          "c.y};\n}\n\n")
# library -> (edits of rbergomi.cu, outputs the plain version's)
LIBRARIES = {
    "as built": ([], True),
    "64 threads": ([_THREADS, _BOUNDS], True),
    "16-step chunks": ([_ROW8], True),
    "no Volterra sum": ([(r"for \(int i = 0; i < kr; \+\+i\) \{",
                          "for (int i = 0; i < 0; ++i) {")], False),
    "no Philox": ([(r"fast::philox_keyed\(\n", "counter_hash(\n"),
                   (r"(template <int kMode, bool kAnti>\n__global__ void __launch_bounds__\(Fused)",
                    _CHEAP.replace("\\", "\\\\") + r"\1")], False),
    "no walk": ([(r"for \(int s = 0; s < \(walker \? nc : 0\); \+\+s\) \{",
                  "for (int s = 0; s < 0; ++s) {")], False),
}


def _library(i: int, edits: list, csrc):
    """The kernel library of csrc/ with ``edits`` applied to rbergomi.cu."""
    if not edits:
        _build.CSRC, _build._lib = csrc, None
        return _build.load_library()
    d = _build.BUILD_DIR.parent / f"rbergomi_csrc_{i}"
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(csrc, d)
    src = (d / "rbergomi.cu").read_text()
    for pat, rep in edits:
        src, n = re.subn(pat, rep, src)
        if n < 1:
            raise RuntimeError(f"rbergomi.cu: {pat!r} matched nothing")
    (d / "rbergomi.cu").write_text(src)
    _build.CSRC, _build._lib = d, None
    return _build.load_library()


def _check(name: str, log) -> None:
    """The library's fused kernel gives its plain version's outputs bit for
    bit in every mode (2 tiles x 50, antithetic)."""
    kw = {"paths": dict(return_variance=True, return_dual_state=True),
          "terminal": dict(return_variance=True), "cv": {}}
    for mode, extra in kw.items():
        args = (SEED, 100.0, 0.5, PARAMS, 2 * cuda_rbergomi.PATH_TILE, 50, 0.05, mode, True, 0,
                "cuda")
        got = cuda_rbergomi.rbergomi_fused(*args, **extra)
        want = cuda_rbergomi.rbergomi_fused_reference(*args, **extra)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise RuntimeError(f"{name}, {mode}: the outputs are not the plain version's")
    log(f"{name}: the plain version's outputs bit for bit in every mode")


def _bare(n_paths: int, n_steps: int, T: float, mode: str):
    """A bare launch on host tables and outputs made once."""
    c = rbergomi_constants(100.0, T, PARAMS, n_steps, 0.05)
    args, weights = cuda_rbergomi.rb_args(c), cuda_rbergomi.rb_weights(c)
    S, v, hist, g_t = cuda_rbergomi._outputs(mode, n_steps, n_paths, "cuda", True, False)
    return lambda: cuda_rbergomi.launch_rbergomi_fused(S, v, hist, g_t, args, weights, SEED, 0,
                                                       n_steps, True, mode)


def run(log=print) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("the experiment needs a CUDA device")
    log(f"card: {card_line()}")
    csrc, lib0 = _build.CSRC, _build._lib
    libs, times = {}, {}
    try:
        for i, (name, (edits, exact)) in enumerate(LIBRARIES.items()):
            libs[name] = _library(i, edits, csrc)
            a = cuda_rbergomi.rbergomi_kernel_attrs(50)["rbergomi_fused"]
            log(f"{name}: {a['registers']} registers, {a['spill_bytes']} spill bytes, "
                f"{a['blocks_per_sm']} blocks of {a['block']} an SM at 50 steps")
            if exact:
                _check(name, log)
        calls = {shape: _bare(*spec) for shape, spec in SHAPES.items()}
        for lib in list(LIBRARIES) + list(LIBRARIES)[::-1]:
            _build._lib = libs[lib]
            for shape, fn in calls.items():
                times.setdefault((lib, shape), []).append(time_per_call(fn, N_TIMED))
    finally:
        _build.CSRC, _build._lib = csrc, lib0
    for (lib, shape), t in times.items():
        log(f"{lib:16s} {shape:24s} " + " ".join(f"{x:.4f}" for x in t)
            + f"  mean {sum(t) / len(t):.4f} ms")
    log(f"card: {card_line()}")
    return times


def main() -> None:
    run()


if __name__ == "__main__":
    main()
