"""Kernel 22 (csrc/vg.cu) on the card: where the redesign's time goes. Both
designs, and edits of the redesign, are timed at F1's shape (2^22 paths,
antithetic, VG(0.18, -0.14, 0.35), T = 1: gamma shape 2.857) and at gamma
shapes 0.01 and 20 (VG(0.2, -0.14, 0.2), T = a nu), as bare launches
(launch_vg_terminal on a constants row and outputs made beforehand).

The edits are copies of csrc/ under build/ with vg.cu changed (as
exp_vg_clock.py and sweep_terminal_bounds.py build theirs), each built
into a library of its own:
- "slots 2", "slots 8": kTermSlots slots a thread (4 as built); "slots 4,
  12 blocks" with __launch_bounds__(kTermBlock, 12); "block 256":
  kTermBlock threads a block (128 as built);
- "no squeeze": the squeeze accepts nothing, so the exact test decides
  every draw (what the squeeze buys; the draws stay the plain version's);
- "walk only": attempt 0 skipped (every draw d, not the plain version's
  draws): the walk's and the set-up's share of the time; "no queue": no
  draw queued for the exact test (the squeeze's rejections kept as they
  are, not the plain version's draws): the queues' share; "walk, no pair
  normal": the walk's Philox call and Box-Muller left out (z = 1/2);
  "walk, SFU sqrt": sqrt_approx(G) for sqrt_clock(G) in the walk.
Every edit but "walk only" must give the first design's gammas and
attempts bit for bit at each shape, or the script fails. Times are
CUDA-event medians (utils/profiling.time_per_call), each call timed in
turns: the libraries forward, then backward. The SASS of both designs'
pricing instances is written to build/vg_terminal_sass.txt.

    python -m options_model_tpu_torch.scripts.exp_vg_terminal

On a CUDA device only.
"""

from __future__ import annotations

import re
import shutil
import subprocess

import torch

from options_model_tpu_torch.core.config import VGParams
from options_model_tpu_torch.ops import _build, cuda_vg
from options_model_tpu_torch.ops.cuda_heston import TERMINAL_TILE
from options_model_tpu_torch.ops.cuda_jumps import device_rows
from options_model_tpu_torch.utils.profiling import card_line, time_per_call

SEED = 0x13198A2E03707344
N_PATHS, N_TIMED = 1 << 22, 7
VG_F1 = VGParams(sigma=0.18, theta=-0.14, nu=0.35)
VG = VGParams(sigma=0.2, theta=-0.14, nu=0.2)
# label -> (params, T)
SHAPES = {"F1 a = 2.857": (VG_F1, 1.0), "a = 0.01": (VG, 0.002), "a = 20": (VG, 4.0)}


def _slots(n: int) -> tuple:
    return r"constexpr int kTermSlots = 4;", f"constexpr int kTermSlots = {n};"


# library -> (edits of vg.cu, draws the plain version's)
LIBRARIES = {
    "as built": ([], True),
    "slots 2": ([_slots(2)], True),
    "slots 8": ([_slots(8)], True),
    "slots 4, 12 blocks": ([(r"__launch_bounds__\(kTermBlock\)\nvg_terminal_kernel\(",
                             "__launch_bounds__(kTermBlock, 12)\nvg_terminal_kernel(")], True),
    "block 256": ([(r"constexpr int kTermBlock = 128;", "constexpr int kTermBlock = 256;")],
                  True),
    "no squeeze": ([(r"return v1 > 0\.0f && u < __fsub_rn", "return false && u < __fsub_rn")],
                   True),
    "walk, SFU sqrt": ([(r"const float x = fmaf\(k\.sigma \* sqrt_clock\(G\)",
                         "const float x = fmaf(k.sigma * fast::sqrt_approx(G)")], False),
    "walk, no pair normal": ([(r"const Words w = philox_keyed\(Words\{j, 0u, tile, kVgStream\}, "
                               r"keys\);\n    float z, z_sin;\n    fast::box_muller_fast\(w\.x, "
                               r"w\.y, z, z_sin\);",
                               "const float z = 0.5f;")], False),
    "no queue": ([(r"const unsigned int lanes = __ballot_sync\(0xFFFFFFFFu, !ok\);\n"
                   r"      if \(!ok\) \{",
                   "const unsigned int lanes = 0u;\n      if (false) {")], False),
    "walk only": ([(r"const bool ok = mt_squeezed\(slot_of\(e\), 0u, 0u, tile, k, one_m, keys, "
                    r"x, g, ubits, bits\);",
                    "x = 0.0f; g = k.d; ubits = 0u; bits = e; const bool ok = true;")],
                  False),
}


def _library(i: int, edits: list, csrc):
    """The kernel library of csrc/ with ``edits`` applied to vg.cu."""
    if not edits:
        _build.CSRC, _build._lib = csrc, None
        return _build.load_library()
    d = _build.BUILD_DIR.parent / f"vg_terminal_csrc_{i}"
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


def _bare(first_design: bool, params, T):
    """A bare launch of one design on a constants row and outputs made once."""
    rows = device_rows(cuda_vg.vg_rows(100.0, 0.04, [T], params, 1), "cuda")
    S_T = torch.empty(N_PATHS, dtype=torch.float32, device="cuda")
    return lambda: cuda_vg.launch_vg_terminal(S_T, None, None, rows, SEED, 0, True,
                                              first_design)


def _check(name: str, log) -> None:
    """The library's redesign draws the first design's gammas and attempts
    bit for bit at every shape (2 tiles)."""
    for shape, (params, T) in SHAPES.items():
        args = (SEED, 100.0, 0.04, T, params, 2 * TERMINAL_TILE)
        _, g, a = cuda_vg.vg_terminal(*args, device="cuda", return_draws=True)
        _, g1, a1 = cuda_vg.vg_terminal_first(*args, device="cuda", return_draws=True)
        if not (torch.equal(a, a1) and torch.equal(g.view(torch.int32), g1.view(torch.int32))):
            raise RuntimeError(f"{name}, {shape}: the redesign's gamma draws are not the first "
                               "design's")
    log(f"{name}: gammas and attempts the first design's bit for bit at every shape")


def _sass(log) -> None:
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(_build.library_path())], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    keep = [c for c in text.split("Function : ")[1:]
            if re.match(r"\S*(18vg_terminal_kernel|24vg_terminal_first_kernel)ILb1ELb0E", c)]
    out = _build.BUILD_DIR.parent / "vg_terminal_sass.txt"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text("".join("Function : " + c for c in keep))
    log(f"SASS of {len(keep)} functions written to {out}")


def run(log=print) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("the experiment needs a CUDA device")
    log(f"card: {card_line()}")
    csrc, lib0 = _build.CSRC, _build._lib
    libs, times = {}, {}
    try:
        for i, (name, (edits, exact)) in enumerate(LIBRARIES.items()):
            libs[name] = _library(i, edits, csrc)
            log(f"{name}: {cuda_vg.vg_kernel_attrs()}")
            if exact:
                _check(name, log)
        _build.CSRC, _build._lib = csrc, libs["as built"]
        _sass(log)
        calls = {}
        for lib in LIBRARIES:
            for design in (("first design", "redesign") if lib == "as built" else ("redesign",)):
                for shape, (params, T) in SHAPES.items():
                    calls[lib, design, shape] = _bare(design == "first design", params, T)
        for lib in list(LIBRARIES) + list(LIBRARIES)[::-1]:
            _build._lib = libs[lib]
            for key, fn in calls.items():
                if key[0] == lib:
                    times.setdefault(key, []).append(time_per_call(fn, N_TIMED))
    finally:
        _build.CSRC, _build._lib = csrc, lib0
    for (lib, design, shape), t in times.items():
        log(f"{design:13s} {lib:24s} {shape:13s} " + " ".join(f"{x:.4f}" for x in t)
            + f"  mean {sum(t) / len(t):.4f} ms")
    log(f"card: {card_line()}")
    return times


def main() -> None:
    run()


if __name__ == "__main__":
    main()
