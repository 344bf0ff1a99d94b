"""Kernel 28 (csrc/basket.cu, the basket terminal kernel) on the card:
where its time goes, at B2's shape (3 assets x 2^22 paths, one exact
step, antithetic, TERMINAL_TILE).

- The launch ramp: the first design (cuda_basket.basket_terminal_first)
  and the redesign (cuda_basket.basket_terminal) at 2^20-2^24 paths, and
  ``out.fill_(1.0)`` on each (3, n) float32 output; a least-squares line
  ms = a + b n of each, its intercept the fixed cost of a launch and its
  slope the cost of a path.
- The write floor: ``fill_`` on the (3, 2^22) output, timed in turns with
  the kernels: what the card takes to write those 50.3 MB (a yardstick of
  the bytes alone, not a call that computes the function). Beside it, the
  first design, the redesign (bare launches on an output made once) and
  ``fill_``, each 20 times back to back between two events, a launch's
  share of them.
- The ablations of the first design, each a compile-time switch of
  scripts/exp_basket_terminal.cu (its own library, built here with nvcc
  into build/exp_basket_terminal/): 32-bit slot geometry, the Philox round
  keys once per launch, 2 and 4 adjacent slots a thread with float2 and
  float4 stores, a grid of whole waves, and their combinations; and the
  best of them without its stores (the values summed, the arithmetic's
  time alone). Each but the last must give the first design's output bit
  for bit (at 2^22 x 1, and at 2 tiles
  of 4,096 x 7 steps with antithetics on and off and first_tile 1), or the
  script fails. Each is printed with its registers, occupancy and static
  SASS instructions a slot (cuobjdump -sass, the whole function / K).

Times are CUDA-event medians (utils/profiling.time_per_call), every row
timed in turns: forward, then backward. Run from the root of a checkout:

    python -m options_model_tpu_torch.scripts.exp_basket_terminal

On a CUDA device only.
"""

from __future__ import annotations

import ctypes
import hashlib
import re
import shutil
import subprocess
from pathlib import Path

import torch

from options_model_tpu_torch.models import multiasset as ma
from options_model_tpu_torch.ops import _build
from options_model_tpu_torch.ops import cuda_basket as cb
from options_model_tpu_torch.ops.cuda_heston import PATH_TILE, TERMINAL_TILE
from options_model_tpu_torch.utils.profiling import card_line, time_per_call

SEED = 11
N_TIMED, BACK_TO_BACK = 7, 20
SIZES = tuple(1 << k for k in range(20, 25))
N_PATHS = 1 << 22
# B2's three assets (tests/test_basket.py:17-21), q = 2%, T = 0.5
S0 = [100.0, 95.0, 110.0]
SIGS = [0.2, 0.3, 0.25]
CORR = [[1.0, 0.5, 0.3], [0.5, 1.0, 0.4], [0.3, 0.4, 1.0]]
SOURCE = Path(__file__).resolve().with_name("exp_basket_terminal.cu")
# variant -> label (scripts/exp_basket_terminal.cu OMT_EXP_VARIANTS:
# kGeom32, kKeys, K, kWaves)
VARIANTS = {0: "copy of the first design", 1: "32-bit geometry", 2: "keys once",
            3: "K 2, float2", 4: "K 4, float4", 5: "whole waves",
            6: "32-bit + keys", 7: "32-bit + keys + K 2", 8: "32-bit + keys + K 4",
            9: "32-bit + keys + waves", 10: "32-bit + keys + K 2 + waves",
            11: "32-bit + keys + K 4 + waves", 12: "32-bit + keys + K 4, no stores"}
# variants that do not compute the function (no stores): not held to its bits
NOT_EXACT = (12,)
# the template arguments of each variant's kernel (its K the third)
_ARGS = {0: (0, 0, 1, 0, 0), 1: (1, 0, 1, 0, 0), 2: (0, 1, 1, 0, 0), 3: (0, 0, 2, 0, 0),
         4: (0, 0, 4, 0, 0), 5: (0, 0, 1, 1, 0), 6: (1, 1, 1, 0, 0), 7: (1, 1, 2, 0, 0),
         8: (1, 1, 4, 0, 0), 9: (1, 1, 1, 1, 0), 10: (1, 1, 2, 1, 0), 11: (1, 1, 4, 1, 0),
         12: (1, 1, 4, 0, 1)}


def _mangled(v: int) -> str:
    g, k, n, w, sink = _ARGS[v]
    return f"exp_kernelILb{g}ELb{k}ELi{n}ELb{w}ELb{sink}EE"


def consts(n_steps: int = 1) -> dict:
    return ma.basket_constants(S0, 0.05, SIGS, ma.correlation_cholesky(CORR), 0.5, n_steps,
                               [0.02] * 3)


def build() -> Path:
    """The experiment's library (nvcc, sm_90a), named by a hash of its
    source, the package's headers and the flags."""
    h = hashlib.sha256(" ".join(_build.NVCC_FLAGS).encode())
    for f in [SOURCE, *sorted(_build.CSRC.glob("*.cuh"))]:
        h.update(f.read_bytes())
    out = _build.BUILD_DIR.parent / "exp_basket_terminal" / f"libexp_{h.hexdigest()[:16]}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, f"-I{_build.CSRC}", "-shared",
                        "-o", str(out), str(SOURCE)], check=True, capture_output=True, text=True)
    return out


def load(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.exp_basket_terminal.argtypes = [I, P, P, ctypes.c_uint64, I, I, I, I, I, P]
    lib.exp_basket_terminal_attrs.argtypes = [I, P]
    return lib


def sass_per_slot(path: Path) -> dict:
    """Static SASS instructions of each variant's kernel (NOPs and the
    closing self-branch left out) over its K, and of the package's first
    design and redesign at 3 assets (a pair each), from cuobjdump -sass."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return {}
    out = {}
    pieces = {VARIANTS[v]: (_mangled(v), _ARGS[v][2]) for v in VARIANTS}
    pieces["first design"] = ("13basket_kernelILi3ELi0EE", 1)
    pieces["redesign"] = ("22basket_terminal_kernelILi3ELi4ELb1EE", cb.terminal_slots(3))
    for lib in (path, _build.library_path()):
        text = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                              check=True, timeout=300).stdout
        for chunk in text.split("Function : ")[1:]:
            name = chunk.split(None, 1)[0]
            for label, (piece, k) in pieces.items():
                if piece in name and label not in out:
                    ins = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(.*?);", chunk)
                    n = sum(1 for i in ins if not i.strip().startswith("NOP")
                            and not re.match(r"BRA `?\(?\.L_x_\d+\)?$", i.strip()))
                    out[label] = n / k
    return out


def run(log=print) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("the experiment needs a CUDA device")
    log(f"card: {card_line()}")
    dev = torch.device("cuda")
    path = build()
    lib = load(path)
    _build.load_library()
    c = consts()

    def variant(v, out, host, n_steps, anti, first_tile, tile):
        n_tiles = out.shape[1] // tile
        with torch.cuda.device(dev):
            err = lib.exp_basket_terminal(v, out.data_ptr(), host, SEED, first_tile, n_tiles,
                                          tile, n_steps, int(anti),
                                          torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"variant {v} failed to launch ({err})")
        return out

    # bits: every variant == the first design == the redesign
    for n_paths, n_steps, anti, first_tile, tile in ((N_PATHS, 1, True, 0, TERMINAL_TILE),
                                                     (2 * PATH_TILE, 7, True, 1, PATH_TILE),
                                                     (2 * PATH_TILE, 7, False, 1, PATH_TILE)):
        cs = consts(n_steps)
        host = _build.float_buffer(cb._packed(cs))
        want = cb.basket_terminal_first(SEED, cs, n_paths, n_steps, anti, first_tile, tile, dev)
        new = cb.basket_terminal(SEED, cs, n_paths, n_steps, anti, first_tile, tile, dev)
        bad = [VARIANTS[v] for v in VARIANTS if v not in NOT_EXACT
               and not torch.equal(variant(v, torch.empty_like(want), host, n_steps, anti,
                                          first_tile, tile), want)]
        if not torch.equal(new, want):
            bad.append("redesign")
        if bad:
            raise RuntimeError(f"{n_paths} x {n_steps}, antithetic {anti}: {bad} differ from "
                               "the first design")
        log(f"3 x {n_paths} x {n_steps}, antithetic {anti}, first_tile {first_tile}: every "
            "variant and the redesign == the first design bit for bit")
    host = _build.float_buffer(cb._packed(c))

    attrs = {}
    for v, label in VARIANTS.items():
        a = (ctypes.c_int * 4)()
        if lib.exp_basket_terminal_attrs(v, a):
            raise RuntimeError(f"variant {v}: attrs failed")
        attrs[label] = dict(registers=a[0], spill_bytes=a[1], occupancy=a[2] * a[3] / 2048)
    for name in ("basket_terminal_first", "basket_terminal"):
        a = cb.basket_kernel_attrs(3)[name]
        attrs[name] = dict(registers=a["registers"], spill_bytes=a["spill_bytes"],
                           occupancy=a["blocks_per_sm"] * a["block"] / 2048)
    sass = sass_per_slot(path)

    # the launch ramp and the fill_ line
    outs = {n: torch.empty((3, n), dtype=torch.float32, device=dev) for n in SIZES}
    calls = {}
    for n in SIZES:
        calls[("first design", n)] = lambda n=n: cb.basket_terminal_first(
            SEED, c, n, 1, True, 0, TERMINAL_TILE, dev)
        calls[("redesign", n)] = lambda n=n: cb.basket_terminal(SEED, c, n, 1, True, 0,
                                                                TERMINAL_TILE, dev)
        calls[("fill_", n)] = lambda n=n: outs[n].fill_(1.0)
    for v, label in VARIANTS.items():
        calls[(label, N_PATHS)] = lambda v=v: variant(v, outs[N_PATHS], host, 1, True, 0,
                                                      TERMINAL_TILE)
    times = {}
    for key in list(calls) + list(calls)[::-1]:
        times.setdefault(key, []).append(time_per_call(calls[key], N_TIMED))
    mean = {k: sum(t) / len(t) for k, t in times.items()}

    def fit(label):
        xs = [float(n) for n in SIZES]
        ys = [mean[(label, n)] for n in SIZES]
        xm, ym = sum(xs) / len(xs), sum(ys) / len(ys)
        b = sum((x - xm) * (y - ym) for x, y in zip(xs, ys)) / sum((x - xm) ** 2 for x in xs)
        return ym - b * xm, b

    res = dict(times={f"{k[0]} @ {k[1]}": t for k, t in times.items()}, attrs=attrs, sass=sass)
    for label in ("first design", "redesign", "fill_"):
        a, b = fit(label)
        res[f"fit {label}"] = dict(intercept_ms=a, ms_per_2_20_paths=b * (1 << 20))
        log(f"ramp {label}: " + ", ".join(f"2^{n.bit_length() - 1} {mean[(label, n)]:.4f}"
                                          for n in SIZES)
            + f" ms; least squares: intercept {a:.4f} ms, slope {b * (1 << 20):.5f} ms per "
            "2^20 paths")
    # 20 bare launches back to back between two events (the package's kernels
    # through _build.launch on an output made once), a launch's share
    out = outs[N_PATHS]

    def bare(mode):
        return lambda: _build.launch("omt_basket", dev, out.data_ptr(), out.data_ptr(), host, 0,
                                     SEED, 0, N_PATHS // TERMINAL_TILE, TERMINAL_TILE, 1, 3, 1,
                                     mode)

    b2b = {}
    for label, fn in (("first design", bare(3)), ("redesign", bare(0)),
                      ("fill_", calls[("fill_", N_PATHS)])):
        b2b[label] = time_per_call(lambda: [fn() for _ in range(BACK_TO_BACK)], N_TIMED) \
            / BACK_TO_BACK
    res["back_to_back"] = b2b
    log(f"back to back, a bare launch of {BACK_TO_BACK}: "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in b2b.items()))
    bound_ms = 3 * N_PATHS * 4 / 3.35e12 * 1e3
    first = mean[("first design", N_PATHS)]
    for label in ["first design", "redesign", "fill_", *VARIANTS.values()]:
        t = mean[(label, N_PATHS)]
        a = attrs.get({"first design": "basket_terminal_first",
                       "redesign": "basket_terminal"}.get(label, label), {})
        log(f"{label:30s} 3 x 2^22 x 1: " + " ".join(f"{x:.4f}" for x in
                                                     times[(label, N_PATHS)])
            + f"  mean {t:.4f} ms, {first / t:.3f}x the first design, {bound_ms / t:.1%} of "
            f"the {bound_ms:.4f} ms bound, {3 * N_PATHS * 4 / t / 1e6:.1f} GB/s written"
            + (f"; {a['registers']} registers, {a['spill_bytes']} local bytes, "
               f"{a['occupancy']:.1%} occupancy" if a else "")
            + (f"; {sass[label]:g} SASS instructions a slot" if label in sass else ""))
    log(f"card: {card_line()}")
    return res


def main() -> None:
    run()


if __name__ == "__main__":
    main()
