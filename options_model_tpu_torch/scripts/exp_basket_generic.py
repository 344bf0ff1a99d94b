"""The generic instance of kernels 27-28 (csrc/basket.cu
basket_generic_kernel, every basket of 9 to 128 assets in its first
design) on the card: how much of its time is its shared-memory state.

The ablations are compile-time switches of scripts/exp_basket_generic.cu
(its own library, built here with nvcc into build/exp_basket_generic/):

- at any n, the first design's code with the Philox round keys once a
  launch, a 2-D grid with no division, 128 or 256 threads a block, and the
  keys with the 2-D grid;
- at a compile-time n of 12, every loop unrolled (the state and constants
  still in shared memory), then from there z in registers, the constants by
  value, acc and the mirror's acc in registers, and all of these with the
  keys, the 2-D grid and 256 threads a block (the combined design), that
  again without stores (the arithmetic alone: every S summed, stored only
  if -1);
- the wide route with one slot a thread (the .cu's slot_wide_kernel: z,
  acc and the mirror's acc in shared memory, the correlate R rows at a
  time) at R = 4, 8 and 16, its draw and chunk loops rolled, and at R = 8
  and 16 unrolled twice (two Philox calls, or two chunks' loads, in
  flight);
- the wide route split across groups of threads (csrc/basket.cuh
  wide_body, basket_wide_kernel's body, in the .cu's exp_wide_kernel: z
  alone in shared memory, each group's two row blocks' log-states in
  registers) at R = 4 and 8, its chunk loop rolled
  or unrolled twice, and at R = 8 under launch bounds of 256 threads and 3
  or 4 blocks an SM (at most 85 or 64 registers).

Each variant but the one without stores must give the first design's
output bit for bit (ops/cuda_basket.basket_generic_first: at 2 tiles of
4,096 x 7 steps, antithetic and not, first_tile 1, and at every timed
shape; and at 2 tiles of 1,030 x 3 steps, whose half no block of slots
divides), or the script fails. Times are CUDA-event medians
(utils/profiling.time_per_call), every row timed in turns (forward, then
backward), at 12 x 2^22 x 1 and 12 x 2^18 x 50, 64 x 2^20 x 1 and 64 x 2^16
x 50, 128 x 2^19 x 1 and 128 x 2^15 x 50 (the same bytes), each beside
its bytes bound, registers, local bytes and warps an SM. Run from the root
of a checkout:

    python -m options_model_tpu_torch.scripts.exp_basket_generic

On a CUDA device only.
"""

from __future__ import annotations

import ctypes
import hashlib
import subprocess
from pathlib import Path

import numpy as np
import torch

from options_model_tpu_torch.models import multiasset as ma
from options_model_tpu_torch.ops import _build
from options_model_tpu_torch.ops import cuda_basket as cb
from options_model_tpu_torch.ops.cuda_heston import PATH_TILE, TERMINAL_TILE
from options_model_tpu_torch.utils.profiling import card_line, time_per_call

SEED = 11
N_TIMED = 7
PEAK_BYTES = 3.35e12
SOURCE = Path(__file__).resolve().with_name("exp_basket_generic.cu")
VARIANTS = {0: "copy of the first design", 1: "keys once", 2: "2-D grid", 3: "block 128",
            4: "block 256", 11: "keys + 2-D grid",
            5: "n 12 unrolled, state in shared memory", 6: "unrolled + z in registers",
            7: "unrolled + constants by value", 8: "unrolled + acc in registers",
            9: "combined: registers, by value, keys, 2-D, block 256",
            10: "combined, no stores",
            12: "wide, one slot a thread, R 4", 13: "wide, one slot a thread, R 8",
            14: "wide, one slot a thread, R 16", 15: "wide, one slot a thread, R 8, unrolled 2",
            16: "wide, one slot a thread, R 16, unrolled 2",
            17: "wide, split across groups, R 4", 18: "wide, split, R 8, rolled",
            19: "wide, split, R 8 (the package's route)",
            20: "wide, split, R 8, 256 x 3 bounds", 21: "wide, split, R 8, 256 x 4 bounds"}
FIXED = (5, 6, 7, 8, 9, 10)        # n = 12 only
NOT_EXACT = (10,)                  # no stores: not the function
WIDE = {12: 4, 13: 8, 14: 16, 15: 8, 16: 16, 17: 4, 18: 8, 19: 8, 20: 8, 21: 8}
SPLIT = 19                         # the package's wide route (csrc/basket.cuh)
# (assets, paths, steps): the 12-asset shapes chip_smoke.py times, and at 64
# and 128 assets the same bytes
SHAPES = [(12, 1 << 22, 1), (12, 1 << 18, 50), (64, 1 << 20, 1), (64, 1 << 16, 50),
          (128, 1 << 19, 1), (128, 1 << 15, 50)]
WARP_ASSETS = (17, 33, 50, 64, 128)
ODD_TILE = 1030                    # a tile whose half no block of slots divides


def assets(n: int):
    """chip_smoke.py's n assets (_basket_assets): a random valid
    correlation from the seed n."""
    rng = np.random.default_rng(n)
    A = rng.standard_normal((n, n + 2))
    cov = A @ A.T
    d = np.sqrt(np.diag(cov))
    corr = cov / np.outer(d, d)
    np.fill_diagonal(corr, 1.0)
    return list(80.0 + 40.0 * rng.random(n)), list(0.1 + 0.3 * rng.random(n)), corr


def consts(n: int, n_steps: int) -> dict:
    S0, sig, corr = assets(n)
    return ma.basket_constants(S0, 0.05, sig, ma.correlation_cholesky(corr), 0.5, n_steps,
                               [0.02] * n)


def build() -> Path:
    """The experiment's library (nvcc, sm_90a), named by a hash of its
    source, the package's headers and the flags."""
    h = hashlib.sha256(" ".join(_build.NVCC_FLAGS).encode())
    for f in [SOURCE, *sorted(_build.CSRC.glob("*.cuh"))]:
        h.update(f.read_bytes())
    out = _build.BUILD_DIR.parent / "exp_basket_generic" / f"libexp_{h.hexdigest()[:16]}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, f"-I{_build.CSRC}", "-shared",
                        "-o", str(out), str(SOURCE)], check=True, capture_output=True, text=True)
    return out


def load(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.exp_basket_generic.argtypes = [I, P, P, P, ctypes.c_uint64, I, I, I, I, I, I, I, P]
    lib.exp_basket_generic_attrs.argtypes = [I, I, I, P]
    return lib


def variants_at(n: int) -> list:
    """The variants that run at n assets: the fixed ones at 12 only, and
    the copy at 128 or 256 threads a block where its state fits."""
    out = []
    for v in VARIANTS:
        if v in FIXED and n != 12:
            continue
        n_consts = 3 * n + n * (n + 1) // 2
        if v in (3, 4) and 4 * (n_consts + 3 * n * (128 if v == 3 else 256)) > 232448:
            continue
        out.append(v)
    return out


def run(log=print) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("the experiment needs a CUDA device")
    log(f"card: {card_line()}")
    dev = torch.device("cuda")
    lib = load(build())
    _build.load_library()

    def prepared(v, c):
        """Variant v's constants: (n, the host buffer, the card's copy)."""
        packed = cb._packed(c)
        dev_c = torch.from_numpy(cb.wide_constants(c, WIDE[v]) if v in WIDE else packed).to(dev)
        return int(c["s0"].shape[0]), _build.float_buffer(packed), dev_c

    def launch(v, out, k, n_steps, anti, first_tile, tile, paths):
        n, host, dev_c = k
        with torch.cuda.device(dev):
            err = lib.exp_basket_generic(v, out.data_ptr(), host, dev_c.data_ptr(), SEED,
                                         first_tile, out.shape[-1] // tile, tile, n_steps, n,
                                         int(anti), int(paths),
                                         torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"variant {v} at {n} assets failed to launch ({err})")
        return out

    def check(n, n_paths, n_steps, anti, first_tile, tile, paths):
        c = consts(n, n_steps)
        want = cb.basket_generic_first(SEED, c, n_paths, n_steps, anti, first_tile, tile, dev,
                                       paths=paths)
        bad = [VARIANTS[v] for v in variants_at(n) if v not in NOT_EXACT
               and not torch.equal(launch(v, torch.empty_like(want), prepared(v, c), n_steps,
                                          anti, first_tile, tile, paths), want)]
        del want
        torch.cuda.empty_cache()
        if bad:
            raise RuntimeError(f"{n} x {n_paths} x {n_steps}, antithetic {anti}, paths {paths}: "
                               f"{bad} differ from the first design")

    for n in (12, 17, 33, 50, 64, 128):
        for anti in (True, False):
            for paths in (True, False):
                check(n, 2 * PATH_TILE, 7, anti, 1, PATH_TILE, paths)
                check(n, 2 * ODD_TILE, 3, anti, 1, ODD_TILE, paths)
        log(f"{n} assets, 2 tiles x 7 steps and 2 of {ODD_TILE} x 3, antithetic and not, "
            "first_tile 1: every exact variant == the first design bit for bit")

    res = dict(times={}, attrs={}, warps={})
    for n in WARP_ASSETS:
        a = (ctypes.c_int * 4)()
        for v in (15, SPLIT):
            for paths in (False, True):
                if lib.exp_basket_generic_attrs(v, n, int(paths), a):
                    raise RuntimeError(f"{VARIANTS[v]}: attrs at {n} failed")
                res["warps"][f"{n} {v} {'paths' if paths else 'terminal'}"] = dict(
                    registers=a[0], spill_bytes=a[1], block=a[3],
                    warps_per_sm=a[2] * a[3] / 32)
        if lib.exp_basket_generic_attrs(0, n, 1, a):
            raise RuntimeError(f"copy attrs at {n} failed")
        for v in (15, SPLIT):
            log(f"{VARIANTS[v]} at {n} assets: " + ", ".join(
                f"{k.split()[2]} {w['block']} threads a block, {w['warps_per_sm']:g} warps an "
                f"SM, {w['registers']} registers, {w['spill_bytes']} local bytes"
                for k, w in res["warps"].items() if k.startswith(f"{n} {v} ")))
        log(f"the first design at {n} assets: {a[2] * a[3] / 32:g} warps an SM")

    for n, n_paths, n_steps in SHAPES:
        paths = n_steps > 1
        tile = PATH_TILE if paths else TERMINAL_TILE
        c = consts(n, n_steps)
        shape = f"{n} x {n_paths} x {n_steps}"
        want = cb.basket_generic_first(SEED, c, n_paths, n_steps, True, 0, tile, dev,
                                       paths=paths)
        out = torch.empty_like(want)
        vs = variants_at(n)
        ks = {v: prepared(v, c) for v in vs}
        bad = [VARIANTS[v] for v in vs if v not in NOT_EXACT
               and not torch.equal(launch(v, out, ks[v], n_steps, True, 0, tile, paths), want)]
        if bad:
            raise RuntimeError(f"{shape}: {bad} differ from the first design")
        del want
        torch.cuda.empty_cache()
        calls = {v: (lambda v=v: launch(v, out, ks[v], n_steps, True, 0, tile, paths))
                 for v in vs}
        times = {}
        for v in vs + vs[::-1]:
            times.setdefault(v, []).append(time_per_call(calls[v], N_TIMED))
        bound = out.numel() * 4 / PEAK_BYTES * 1e3
        first = sum(times[0]) / 2
        for v in vs:
            t = sum(times[v]) / 2
            a = (ctypes.c_int * 4)()
            lib.exp_basket_generic_attrs(v, n, int(paths), a)
            row = dict(ms=t, turns=times[v], bound_ms=bound, registers=a[0], spill_bytes=a[1],
                       warps_per_sm=a[2] * a[3] / 32, block=a[3])
            res["times"][f"{VARIANTS[v]} @ {shape}"] = row
            log(f"{shape:18s} {VARIANTS[v]:52s} " + " ".join(f"{x:.4f}" for x in times[v])
                + f"  mean {t:.4f} ms, {first / t:.3f}x the first design, {bound / t:.1%} of "
                f"the {bound:.4f} ms bytes bound; {a[0]} registers, {a[1]} local bytes, "
                f"{a[3]} threads a block, {a[2] * a[3] / 32:g} warps an SM")
        del out
        torch.cuda.empty_cache()
    log(f"card: {card_line()}")
    return res


def main() -> None:
    run()


if __name__ == "__main__":
    main()
