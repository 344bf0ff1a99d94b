#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (options_model_tpu_torch) once on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
1. build the CUDA kernels from csrc/ (one nvcc per source, all at once) and
   print the card's name and power limit;
2. each of the eight kernels against its plain PyTorch version on the card,
   at 2 and 64 tiles and at its path's shape: equal Philox bits, S (and v)
   within the stated tolerances, and bit-equal chunks at a ``first_tile``
   offset; a constant-sigma local-vol table against the GBM kernel;
3. the two paths, each driven with every launch count set to 0 just before
   it and read just after:
   a. the main path through ``price_american``: the pooled Heston American
      put against the extrapolated ADI oracle, the GBM put against CRR, and
      the European branch (Heston against COS, GBM against Black-Scholes);
   b. the QE-M and local-vol path: the pooled QE American put against ADI,
      the QE European put against COS, the local-vol European call (a
      martingale check on the bench smile, and a constant-sigma table
      against Black-Scholes), the local-vol American put against CRR, and
      the 64x64 strike x maturity surface (Euler and QE) with three cells
      against the ADI oracle;
4. the launch counts of each path, none of its kernels at 0;
5. each kernel's time and its plain version's (CUDA events, median of 7
   after warm-up), seconds per price and per surface.
The second-to-last line is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
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
N_TIMED = 7
DEVICE = "cuda"


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    log(f"FAIL: {msg}")
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, n: int = N_TIMED) -> float:
    """Median milliseconds of fn() over n timed runs after one warm-up."""
    import torch

    fn()
    times = []
    for _ in range(n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bench_smile(S, tau):
    """The JAX bench's local-vol smile (bench.py:156-158)."""
    import torch

    return 0.2 + 0.1 * torch.abs(torch.log(100.0 / S)) + 0.02 * torch.sqrt(tau)


def kernel_specs():
    """Per kernel: name, source, replaced Pallas function, the path that
    runs it ("main" or "second"), its path's (tile count, steps), the timed
    (tile count, steps), and run(plain, n_tiles, first_tile, n_steps,
    variance, antithetic)."""
    from options_model_tpu_torch.core.config import HestonParams
    from options_model_tpu_torch.ops import cuda_gbm, cuda_heston, cuda_localvol
    from options_model_tpu_torch.surface.cheb import compile_localvol_table

    hp = HestonParams(kappa=2.0, theta=0.04, xi=0.3, rho=-0.7, v0=0.04)
    seed = 0x9E3779B97F4A7C15
    dev = DEVICE
    smile_paths = compile_localvol_table(bench_smile, 100.0, 0.5, 50, 100.0)
    smile_terminal = compile_localvol_table(bench_smile, 100.0, 1.0, 100, 100.0)

    def heston_paths(plain, n_tiles, first_tile, n_steps, variance, anti=True):
        fn = cuda_heston.heston_paths_reference if plain else cuda_heston.heston_paths
        out = fn(seed, 100.0, 0.05, 0.5, hp, n_tiles * cuda_heston.PATH_TILE, n_steps,
                 anti, variance, first_tile, dev)
        return out if variance else (out,)

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

    def heston_paths_qe(plain, n_tiles, first_tile, n_steps, variance, anti=True):
        fn = cuda_heston.heston_paths_qe_reference if plain else cuda_heston.heston_paths_qe
        out = fn(seed, 100.0, 0.05, 0.5, hp, n_tiles * cuda_heston.PATH_TILE, n_steps,
                 anti, variance, first_tile, dev)
        return out if variance else (out,)

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
    return [
        dict(name="heston_paths", run=heston_paths, source=src + "heston.cu",
             replaces="options_model_tpu/ops/pallas_heston.py:319", path="main",
             tile=cuda_heston.PATH_TILE, main=(256, 50), timed=(256, 50), variance=(False, True),
             counter=(cuda_heston.launches, "heston_paths")),
        dict(name="heston_terminal", run=heston_terminal, source=src + "heston.cu",
             replaces="options_model_tpu/ops/pallas_heston.py:263", path="main",
             tile=cuda_heston.TERMINAL_TILE, main=(256, 100), timed=(256, 100),
             variance=(False,), counter=(cuda_heston.launches, "heston_terminal")),
        dict(name="gbm_paths", run=gbm_paths, source=src + "gbm.cu",
             replaces="options_model_tpu/ops/pallas_gbm.py:126", path="main",
             tile=cuda_heston.PATH_TILE, main=(512, 50), timed=(256, 50), variance=(False,),
             counter=(cuda_gbm.launches, "gbm_paths")),
        dict(name="gbm_terminal", run=gbm_terminal, source=src + "gbm.cu",
             replaces="options_model_tpu/ops/pallas_gbm.py:100", path="main",
             tile=cuda_heston.TERMINAL_TILE, main=(256, 100), timed=(256, 100),
             variance=(False,), counter=(cuda_gbm.launches, "gbm_terminal")),
        dict(name="heston_terminal_qe", run=heston_terminal_qe, source=src + "heston_qe.cu",
             replaces="options_model_tpu/ops/pallas_heston.py:512", path="second",
             tile=cuda_heston.TERMINAL_TILE, main=(256, 100), timed=(256, 100),
             variance=(False,), counter=(cuda_heston.launches, "heston_terminal_qe")),
        dict(name="heston_paths_qe", run=heston_paths_qe, source=src + "heston_qe.cu",
             replaces="options_model_tpu/ops/pallas_heston.py:543", path="second",
             tile=cuda_heston.PATH_TILE, main=(256, 50), timed=(256, 50),
             variance=(False, True), counter=(cuda_heston.launches, "heston_paths_qe")),
        dict(name="localvol_terminal", run=localvol_terminal, source=src + "localvol.cu",
             replaces="options_model_tpu/ops/pallas_localvol.py:62", path="second",
             tile=cuda_heston.TERMINAL_TILE, main=(256, 100), timed=(256, 100),
             variance=(False,), counter=(cuda_localvol.launches, "localvol_terminal")),
        dict(name="localvol_paths", run=localvol_paths, source=src + "localvol.cu",
             replaces="options_model_tpu/ops/pallas_localvol.py:149", path="second",
             tile=cuda_heston.PATH_TILE, main=(512, 50), timed=(256, 50), variance=(False,),
             counter=(cuda_localvol.launches, "localvol_paths")),
    ]


def phase_build() -> None:
    import torch

    from options_model_tpu_torch.ops import _build

    t0 = time.perf_counter()
    path = _build.build()
    _build.load_library()
    log(f"[1] built {path.name} in {time.perf_counter() - t0:.2f} s")
    log(f"[1] card: {card_line()}")
    log(f"[1] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)} "
        f"x{torch.cuda.device_count()}")


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


def phase_kernels(specs) -> dict:
    """Kernel vs plain at 2 and 64 tiles and at the main path's shape (and
    at 2 tiles without antithetic mirroring), and the first_tile chunk
    property. Returns the max |kernel - plain| of S."""
    import torch

    errs = {}
    for k in specs:
        n_main, steps = k["main"]
        err = 0.0
        for variance in k["variance"]:
            for n_tiles, anti in ((2, True), (64, True), (n_main, True), (2, False)):
                got = k["run"](False, n_tiles, 0, steps, variance, anti)
                want = k["run"](True, n_tiles, 0, steps, variance, anti)
                torch.cuda.synchronize()
                for name, g, w in zip("Sv", got, want):
                    if g.shape != w.shape or not bool(torch.isfinite(g).all()):
                        fail(f"{k['name']}: {name} shape {tuple(g.shape)} vs "
                             f"{tuple(w.shape)} or non-finite")
                    rtol, atol = (S_RTOL, 0.0) if name == "S" else (V_RTOL, V_ATOL)
                    bad = (g - w).abs() > atol + rtol * w.abs()
                    e = float((g - w).abs().max())
                    if bool(bad.any()):
                        fail(f"{k['name']} {n_tiles} tiles: {name} differs from the "
                             f"plain version (max abs {e:.3e}, {int(bad.sum())} "
                             f"entries beyond rtol {rtol}, atol {atol})")
                    if name == "S":
                        err = max(err, e)
                del got, want
            # chunk property: tiles [half, n) of a 64-tile run at offset half
            full = k["run"](False, 64, 0, steps, variance)
            part = k["run"](False, 32, 32, steps, variance)
            cols = 32 * k["tile"]
            for f, p in zip(full, part):
                if not torch.equal(f[..., cols:], p):
                    fail(f"{k['name']}: a run at first_tile 32 differs from the "
                         "matching slice of the full run")
            log(f"[2] {k['name']} (variance={variance}): kernel == plain within "
                f"rtol {S_RTOL} on S"
                + (f", rtol {V_RTOL} + atol {V_ATOL} on v" if variance else "")
                + f" at 2, 64, {n_main} tiles x {steps} steps (and 2 tiles without "
                  "antithetics); first_tile=32 chunk equals the full run's slice bit "
                  "for bit")
        errs[k["name"]] = err
    return errs


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
    vol European and American, the 64x64 surface (Euler and QE). Returns
    seconds per price or per surface."""
    import dataclasses

    import numpy as np
    import torch

    from options_model_tpu_torch.calibration.charfn import heston_cos_price
    from options_model_tpu_torch.core.config import (CALL, PUT, HestonParams,
                                                      LSMConfig, MCConfig, OptionSpec)
    from options_model_tpu_torch.core.stats import masked_mean_stderr
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
    for scheme in ("euler", "qe"):
        P, SE = timed(f"surface_{scheme}_with_stderr", price_american_surface, gen(37),
                      100.0, Ks, Ts, 0.05, mc_s, cp=-1.0, heston=hp, heston_scheme=scheme,
                      return_stderr=True, device=DEVICE)
        P, SE = P.numpy(), SE.numpy()
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
        timed(f"surface_{scheme}", lambda: (price_american_surface(
            gen(41), 100.0, Ks, Ts, 0.05, mc_s, cp=-1.0, heston=hp, heston_scheme=scheme,
            device=DEVICE),))
    return {k: statistics.median(v) for k, v in secs.items()}


def phase_timing(specs) -> dict:
    """CUDA-event medians of each kernel and its plain version: 2^22 x 100
    for the terminal kernels, 2^20 x 50 (with v where there is one) for the
    paths kernels."""
    out = {}
    for k in specs:
        n_tiles, steps = k["timed"]
        variance = k["variance"][-1]
        ms = cuda_ms(lambda: k["run"](False, n_tiles, 0, steps, variance))
        plain_ms = cuda_ms(lambda: k["run"](True, n_tiles, 0, steps, variance))
        rate = n_tiles * k["tile"] * steps
        log(f"[5] {k['name']} {n_tiles * k['tile']} paths x {steps} steps"
            f"{' with v' if variance else ''}: kernel {ms:.4f} ms "
            f"({rate / ms * 1e3:.4e} path-steps/s), plain {plain_ms:.4f} ms "
            f"({rate / plain_ms * 1e3:.4e} path-steps/s)")
        out[k["name"]] = (ms, plain_ms)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device; torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase_build()
    specs = kernel_specs()
    phase_philox()
    errs = phase_kernels(specs)
    phase_constant_sigma()

    def drive(path, fn):
        """Run one path with every count at 0; fail if a kernel of that path
        was never launched. Returns (fn's result, that path's counts)."""
        for k in specs:
            k["counter"][0][k["counter"][1]] = 0
        out = fn()
        counts = {k["name"]: k["counter"][0][k["counter"][1]] for k in specs}
        log(f"[4] kernel launches during the {path} path: {counts}")
        mine = {k["name"]: counts[k["name"]] for k in specs if k["path"] == path}
        if not all(mine.values()):
            fail(f"a kernel of the {path} path was never launched: {mine}")
        return out, mine

    secs, launches = drive("main", phase_main_path)
    secs2, launches2 = drive("second", phase_second_path)
    launches.update(launches2)

    times = phase_timing(specs)
    log("[5] main path seconds per price: "
        + ", ".join(f"{k} {v:.3f}" for k, v in secs.items()))
    log("[5] QE-M and local-vol path seconds per price or surface: "
        + ", ".join(f"{k} {v:.3f}" for k, v in secs2.items()))
    log(f"[5] card: {card_line()}")

    print(json.dumps({"kernels": [
        {"name": k["name"], "route": "cuda", "source": k["source"],
         "replaces": k["replaces"], "launches": launches[k["name"]],
         "max_abs_err": errs[k["name"]], "ms": times[k["name"]][0],
         "plain_ms": times[k["name"]][1]} for k in specs]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
