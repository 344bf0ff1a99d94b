#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (options_model_tpu_torch) once on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
1. build the CUDA kernels from csrc/ (one nvcc per source, all at once) and
   print the card's name and power limit; count the time loops of kernels
   1, 3-8 and 12-16 (both designs) and of kernel 17's redesign in SASS,
   and kernel 18's calls loop (both designs, GBM and Heston) with its
   instructions an evaluation, with their registers and stack, and there
   the integer instructions of a Philox call; fail if kernel 12's or
   kernel 18's redesigned loop holds a local load or store;
2. each of the eight path kernels against its plain PyTorch version on the
   card, at 2 and 64 tiles and at its path's shape: equal Philox bits (and
   the sine and cosine of kernel 12's redesign equal to sinf and cosf at
   every angle of the stream), S
   (and v) within the stated tolerances, and bit-equal chunks at a
   ``first_tile`` offset; the same for the first design of kernels 4 and 6
   (csrc/heston.cu, csrc/heston_qe.cu), which no pricer reaches any more;
   the redesigned terminal kernels 1, 3, 5 and 7 (csrc/terminal.cu) and
   local-vol paths kernel 8 (csrc/localvol_paths.cu) within rtol 1e-4 on
   S, kernels 7 and 8 at degrees 3, 7 and 17 (compile-time instances and
   the run-time one), kernels 1, 3 and 8 also at step counts that end in
   each tail of their draw loop, and their first designs (csrc/gbm.cu,
   csrc/heston.cu, csrc/heston_qe.cu, csrc/localvol.cu) within rtol 1e-5;
   the maturity-batched paths kernel (csrc/heston_paths.cu) at the 64 x
   16,384 x 50 surface shape: each maturity's slice bit-equal to a
   single-maturity launch, bit-equal ``first_tile`` chunks, within its
   tolerances of the plain version (QE-M's v bit for bit); a constant-sigma
   local-vol table against the GBM kernel; kernel 4's first design
   bit-equal to its output before heston_common.cuh, the redesigned
   kernels 4 and 6 to theirs before hopper_fast.cuh, and kernel 7 to its
   output before its step moved to hopper_fast.cuh (recorded digests);
   every store/exp/layout variant of csrc/paths_variants.cu against its
   plain version (rtol 1e-4 on S) and against kernel 4 as the pricers run
   it (bit for bit; the log-only form within rtol 1e-6 after exp), and of
   its first design, csrc/heston_variants.cu, against its plain version
   (rtol 1e-5) and kernel 4's first design (the same equalities), with
   bit-equal ``first_tile`` chunks; the three VJP kernels of
   csrc/greeks.cu (the backward of kernels 1, 2 and 4 on the Greeks path;
   the GBM paths and Euler ones redesigned, kernels 12 and 13, their first
   designs beside them) against their plain versions at 2^14 x 50 and at
   the Greeks path's shapes, with and without antithetics, within 1e-4 of
   the paths' absolute shares, and each gradient component against the
   central difference of its own forward kernel on the same seed; kernel
   12's totals within 1e-6 of its first design's; kernels 12 and 13's rows
   bit-equal on two launches and in a ``first_tile`` chunk; J0, the four
   jump kernels of csrc/jumps.cu (Merton paths and terminal, the Bates
   overlay on paths and terminal values; all four redesigned, kernels
   14-17, their first designs beside them) against their plain versions
   at the jumps path's shapes and at
   lam dt = 1, with and without antithetics: S within rtol 1e-5, every
   Poisson count bit for bit, each redesign's S and counts its first
   design's bit for bit, kernel 14's batched launch over the Merton
   surface's 64 maturities its 64 single-maturity launches bit for bit,
   bit-equal ``first_tile`` chunks; F0, the Variance Gamma and SABR kernels
   21-24 (csrc/vg.cu: VG paths of a batch of maturities and the exact
   terminal step, with Marsaglia-Tsang gamma draws on counter word 3 = 3;
   csrc/sabr.cu: SABR forward and vol paths and terminal forwards with the
   control variate's forward, beta = 1 and beta < 1 instances) against
   their plain versions: the VG stream's words bit for bit, no gamma draw
   accepted at another attempt at 2 tiles (at most ATTEMPT_FLIPS of the
   draws at the legs' shapes), the gamma draws within GAMMA_RTOL at shapes
   0.01, 0.05, 1 and 2.5 and the law of 2^22 draws at each against
   scipy.stats.gamma, S, F and G_T within S_RTOL and alpha within V_RTOL,
   the absorbed SABR paths the same set, the 64-maturity VG batch its 64
   single launches bit for bit, ``first_tile`` chunks bit for bit; kernel
   22's redesign (the squeeze) and its first design with gammas and
   attempts plain's bit for bit at 2 tiles of each shape and at F1's 2^22,
   and the redesign's decision (omt_vg_decide) against torch's exact test
   on the card over an adversarial grid of 2^24 pairs and more;
3. the paths, each driven with every launch count set to 0 just before it
   and read just after (the NN-LSM, calibration, rough and exotics paths,
   c, f, k and l, run in processes of their own, ``chip_smoke.py --path
   nn``, ``--path calibration``, ``--path rough`` and ``--path exotics``,
   started after b and joined after the families path, so their seconds
   overlap d and g-j; each zeroes
   every count before its path and hands its counts back, which the parent
   checks as for any path; their log lines print at the join):
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
   d. the Greeks path (pricers/greeks.py): GBM European call Greeks at
      2^22 x 100 against the closed form (G1), the GBM American put at 2^21
      x 50 (G2) and the Heston American put at 2^20 x 50 (G3) against
      common-random-number bumps (G3's first seed run twice, bit for bit
      the same), exact COS Greeks against central
      differences (G4), bs_greeks and implied_vol on a 64 x 64 grid (G5);
   e. the two kernel-4 experiments (options_model_tpu_torch/scripts/
      exp_paths_kernel.py and exp_fullpath_layout.py) at their scripts'
      shapes, each variant also held against its plain version there;
   f. the calibration path (calibration/calibrator.py, float64 on the
      card): C1 bench.py's exact Heston round trip, C2 its noisy surface
      with L-BFGS-B against the JAX package's fit, C3 the default cascade
      at max_iterations 50, C4 and C5 the Bates and VG round trips, C6 the
      recorded chain (tests/data/chain_fixture.json) calibrated and
      repriced (COS and American puts, kernel 4), C7 apps.calibrate with
      --price-surface (one batched kernel-4 launch for 64 x 64); the ms and
      device kernels of one objective evaluation per model;
   g. the jumps path (models/merton.py, models/bates.py): J1 the Merton
      American put (bench.py's leg, 2^18 x 50, 16 seeds pooled) against the
      COS-Bermudan oracle at degrees 5 and 3, J2 the Merton and Bates
      (Euler, QE-M) European puts at 2^22 x 100 against the series and
      COS, J3 the Bates American put against its COS European and, at
      lam = 0, its paths and plain LSM price against Heston's bit for bit,
      J4 the 64 x 64 Bates and Merton surfaces, apps.calibrate --model
      bates --price-surface, merton_greeks against f64 central differences;
   h. the dual path (pricers/dual.py, kernels 18-19 of csrc/dual.cu, after
      D0 held them against their plain versions: the dual stream's Philox
      words and the Poisson counts bit for bit, ce (kernel 18's redesign
      and its first design) and the inner states within their tolerances,
      bit-equal first_tile chunks of both designs and of kernel 19, each
      family at 2 tiles and at its bracket's shape, and there the upper
      bound assembled from either design's ce within DUAL_UPPER_SE of its
      stderr): D1 bench.py's GBM bracket (2^18
      x 50) against CRR, D2 its Heston bracket (2^17 x 50) against ADI, D3
      J1's Merton put against the COS-Bermudan value, D4 J3's Bates put
      against the port's CV price and, at lam = 0, the Bates dual against
      the Heston dual, D5 the NN-policy GBM bracket (2^16 x 50 x 64) against
      CRR, at the JAX tests' bars, width and upper printed beside
      BENCH_r05's;
   i. the IV-surface path (the [V] lines; surface/, models/localvol.py's
      bare sigma_fn route, after V0 held kernel 20, csrc/philox.cu's
      path_normals_kernel, against path_normals: the words bit for bit, the
      normals within NORMALS_ATOL at 2 tiles and V2's chunks, first_tile
      chunks bit for bit, and the bare route over a table's sigma_fn
      against kernels 7 and 8): V1 apps.train_surface --test and
      SurfaceTrainConfig() on the recorded chain over 20 and 6 seeds, the
      geometric means of their IV RMSE (and the chain's best_val_loss)
      within IVNN_FIT_GATE x the JAX package's over 40, the fit at the
      CLI's defaults within the JAX test's bars; V2 the
      network's sigma_fn(K=100) through a compiled table (kernels 7 and 8)
      and through the bare route (kernel 20) on the same seeds, the
      European call at 2^22 x 100 (martingale, the routes within
      IVNN_ROUTE_RTOL, bf16 within IVNN_BF16_RTOL) and the American put at
      2^21 x 50; V3 save -> restore, the table bit for bit; V4 SVI on
      Heston-COS smiles, its Dupire local vol through a table at 2^22 x 100
      and bare at 2^20 x 48 against the JAX package's prices;
   j. the families path (the [F] lines; models/vg.py, models/sabr.py, the
      JAX tests' configurations and bars): F1 the VG European put at 2^22
      (kernel 22) against float64 COS, the martingale, kernel 21's S_T at
      2^20 x 50 against COS; F2 the VG American put at 2^20 x 50, CV and
      Richardson pooled over F_SEEDS seeds against the COS-Bermudan and
      COS-American values; F3 the 64 x 64 VG surface (one kernel-21 launch)
      with three ATM cells against cos_bermudan_price(n_dates=50); F4 the
      SABR Europeans at 2^22 x 64 (kernel 24: CV against Hagan, nu = 0
      against Black, the CV's stderr, put-call parity, the European
      sampler, the absorbing beta = 0.5 regime through kernel 23); F5 the
      SABR American put at 2^20 x 50, Richardson on the (S, alpha) basis
      (kernel 23) pooled against the ADI value, the S-only basis below it,
      nu = 1e-4 against CRR(4096); F6 calibrate_sabr's round trips in
      float64 on the card beside the JAX package's fits;
   k. the rough path (the [R] and [D6]-[D9] lines; models/rbergomi.py,
      calibration/rbergomi.py and the dual's VG, SABR and rough Bergomi
      families, after R0 held the fused rough Bergomi kernel, the first
      design's kernels 25 and 26 (csrc/rbergomi.cu) and kernel 18's new
      families against their plain versions: the stream's words, dW, the
      dual state, the inner states and VG's clock draws and attempts bit
      for bit, S and v within RB_RTOL (the fused kernel also within RB_RTOL
      of the first design), ce and VG's terminal step within DUAL_CE_ATOL,
      first_tile chunks bit for bit; the VG, SABR and rough Bergomi
      redesigns of kernel 18 and VG's terminal redesign also through their
      debug instances, x' and the clock bit for bit, alpha' and v' within
      their budgets, the uppers within DUAL_UPPER_SE stderr of the first
      designs'; the counts are zeroed after R0): R1
      the hybrid scheme against the exact Cholesky oracle, R2 H = 1/2
      against the drift-extended ADI, R3 the ATM-skew power law, R4
      bench.py's rBergomi calibration leg, R5 the American put at 2^20 x
      50 on the (S, v) basis, D6-D9 the VG, SABR, H = 1/2 and rough
      brackets, and the full-width brackets at D1's scale, at the JAX
      tests' bars;
   l. the exotics path (the [X0], [B] and [E] lines; models/multiasset.py,
      pricers/basket.py, american_basket.py, exotics.py, barrier.py,
      american_asian.py, fd_asian.py, varswap.py), after X0 held kernels
      27-28 (csrc/basket.cu, csrc/basket.cuh) against their plain versions
      at 1, 2, 3 and 5 assets and on the routes from 9 assets at 9, 12, 16,
      17, 33, 50, 64 and 128 (antithetic and not, the latter also on a
      1,030 tile), and at the timed shapes: W and the log-states bit for
      bit, S within BASKET_S_ULPS, the terminal the paths' last row,
      first_tile chunks bit for bit, from 9 assets the generic instance
      (their first design) equal to both, no local memory at 1-16 assets;
      kernel 28's redesign and its first design bit for bit the plain
      version at those assets and 8, antithetic and not, at one step on
      TERMINAL_TILE and seven on PATH_TILE, and on a tile no K divides,
      with their first_tile chunks: B1 the Andersen-Broadie Bermudan
      max-call at 2^20 x 9, B2 the 3-asset basket at 2^22, B3-B4 the 12-
      and 50-asset baskets (the routes from 9 assets), E1 the Asian, E2 the
      barriers, E3 the American Asian, E4 the lookbacks and variance swaps,
      at the JAX tests' bars; the plain versions of 27-28, kernel 28's first
      design and the generic instance counted and held at 0;
4. the launch counts of each path (the families path: kernels 21-24; the
   rough path: the fused rough Bergomi kernel, kernel 18's new families
   and VG's terminal step), none of its kernels at 0, the first design of
   kernels 1, 3-8, 12-18 (kernel 18's VG, SABR and rough Bergomi families
   too), 21, 22, 24, 25-26 and 28, of VG's terminal step, of the generic
   instance of 27-28 and of the variants at 0, and one
   paths launch per 64x64 Heston, Bates or Merton surface; the experiments
   reach the variants' first design only in their first-design rows;
5. each kernel's time and its plain version's (CUDA events, median of 7
   after warm-up) beside its bound; for kernels 1 and 3-8 also the first
   design's time, in turns with the redesign, and registers and
   occupancy; for kernels 4 and 6 the surface shape (one batched launch
   against 64 single launches of either design); kernels 7 and 8 at
   degrees 3 and 17; the American puts, the surface's ADI cells, the
   European legs of kernels 1, 3, 5, 7 and 15 and the local-vol American put
   of kernel 8 beside the first design's on the same seeds (the European
   legs and the local-vol put within EARLIER_EURO_GATE stderr of it);
   seconds per price and per surface, each European leg beside its
   kernel's time; the VJP kernels' times beside their bounds, and the
   seconds of a Greeks call (G1-G3) with the share of its kernels; the
   jump kernels' times beside their bounds and the jumps path's seconds;
   kernels 12-17 in turns with their first designs (kernel 12 also at G2's
   2^21 x 50; the card's clocks and power logged before and after the jump
   kernels' turns), and kernel 14 at
   the jumps path's own shapes (1 x 2^18 x 50 and 64 x 16,384 x 50) with
   its launches x (time - bound) there, beside its first design's; kernel
   18 at each bracket's shape in turns with its first design, with its
   issue and SFU floors from the SASS count, and kernel 19 at D5's chunk,
   beside their bounds and plain versions, and the seconds per bracket
   with the kernels' share; kernel 20 at the bare route's European and
   American chunks beside its bound and plain version, and the IV-surface
   path's seconds; kernels 21-24 at their legs' shapes (21 also at F3's
   64 x 16,384 x 50 batch) beside their bounds (the integer term at the
   run's mean gamma attempts) and plain versions, with registers and
   occupancy, 21, 22 and 24 in turns with their first designs beside each
   design's issue and SFU floors, and the families path's seconds by leg;
   the fused rough Bergomi kernel in turns with its first design (kernel
   25, the Volterra product and kernel 26, each timed alone) at R5's 2^20
   x 50 and at R4's CV shapes (2^16 x 32, 48 and 96), each beside its
   bound and kernel 25 beside its own, and kernel 18's new families and
   VG's terminal step at 49 x 2^17 x 64 (the terminal at 2^17 x 32 draws),
   beside their bounds and plain versions, each in turns with its first
   design and beside both designs' issue and SFU floors, with the
   full-width brackets' seconds and kernel 18's share; kernels 27-28 at
   5 x 2^20 x 50, 3 x 2^22 (one exact step) and B1's 2 x 2^20 x 9 beside
   their bounds and plain versions, kernel 28 at 3 x 2^22 and at B1's
   European 2 x 2^21 in turns with its first design beside fill_ on the
   same output, both routes from 9 assets at 12 and 64 assets (terminal
   12 x 2^22 and 64 x 2^20, paths 12 x 2^18 x 50 and 64 x 2^16 x 50) in
   turns with the generic instance, beside their bounds and the SASS
   issue floor, and the exotics path's seconds per price.
   ``chip_smoke.py --path rough`` (``--path exotics``) run alone drives
   the rough (exotics) path and then times its kernels as phase 5 does.
The second-to-last line is a JSON object with one entry per TPU kernel (the
variants of kernels 9 and 10 listed under theirs), one per VJP kernel, one
per jump kernel, one per dual kernel, one for the normals kernel (20), one
per family kernel (21-24) and one per rough-path kernel (the fused rough
Bergomi kernel, rows 25-26, its first design under earlier_*; kernel 18's
VG, SABR and rough Bergomi families, VG's terminal step) and one per
multi-asset kernel (27-28);
the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import hashlib
import itertools
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
# Epochs of the NN legs' fit, cut from the default 25 to keep the script
# well inside its time limit: the fit's steps are capped at 512 an epoch,
# so its seconds follow the epochs, not the paths (25 epochs took 111-144 s
# a leg on an H100, with the gates met by 20x (GBM) and 5x (Heston)).
NN_EPOCHS = 10
# sha256 of kernel 4's bytes before heston_common.cuh existed: the first
# design's paths S and V (64 tiles x 50 steps, T 0.5), then its terminal S_T
# (16 tiles x 100 steps, T 1; now heston_paths_accurate and
# heston_terminal_accurate), seed 0x9E3779B97F4A7C15, recorded by
# kernel4_digest on an H100 (nvcc 12.9) from the sources that still defined
# the step in heston.cu.
KERNEL4_DIGEST = "99c2e49a1a0fc1af6cd697e95da4771a75a48862b5872a9fb6d488595c458096"
# sha256 of the redesigned kernels 4 and 6 (csrc/heston_paths.cu) before
# their Hopper pieces (keyed Philox, the SFU helpers, the QE-M step and,
# later, the Euler step) moved to hopper_fast.cuh: heston_paths_batched S and
# V, Euler then QE-M, each with and without antithetics, maturities (0.5,
# 1.0) x 16 tiles x 50 steps at first_tile 3, seed 0x9E3779B97F4A7C15,
# recorded by paths_digest on an H100 (nvcc 12.9).
PATHS_DIGEST = "4406f23463bbea653c0e6d92ca817af3cc86328c874feac6e306412196cfef73"
# sha256 of the redesigned local-vol terminal kernel (kernel 7,
# csrc/terminal.cu) before its step (LvK, lv_fold, row_groups, clenshaw,
# lv_step) moved to hopper_fast.cuh: localvol_terminal S_T on the bench smile
# at degrees 3, 7 and 17, each with and without antithetics, 8 tiles x 100
# steps, T 1, first_tile 3, seed 0x9E3779B97F4A7C15, recorded by
# lv_terminal_digest on an H100 (nvcc 12.9).
LV_TERMINAL_DIGEST = "0925abc8c5d4d5d38bb650b9d44647db1371bc2d3c1da58d1306411948f1646d"
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
# The redesigned local-vol kernels (the terminal kernel of csrc/terminal.cu,
# the paths kernel of csrc/localvol_paths.cu) trade the last ulps of the
# whole step (SFU Box-Muller, folded constants, FMAs; the paths kernel's
# stored ex2.approx) and carry log S - log S0, where the plain version adds
# (r - sigma^2/2) dt to the absolute log S (~4.6, ulp 4.8e-7): a rounding
# that, where sigma is constant, goes the same way at every step (-6.9e-6 in
# S_T over 100 steps at sigma = 0.2, against ~1e-8 for the kernels).
LV_S_RTOL = 1e-4
# The redesigned GBM terminal kernel (csrc/terminal.cu): the SFU
# Box-Muller's ~3e-6 absolute error a normal, summed over 100 steps and
# scaled by sigma sqrt(dt), and ex2.approx's ~2 ulps.
GBM_S_RTOL = 1e-4
# Degrees at which kernels 7 and 8 are held against their plain versions:
# two with a compile-time instance (7 the default), one past them (the
# run-time one).
LV_DEGREES = (3, 7, 17)
# Step counts of kernel 8 that end in each tail of its draw loop (four steps
# a draw): 49, 50 (the path's), 51, and 1-3 alone.
LV_PATHS_TAILS = (49, 50, 51, 1, 2, 3)
# A European leg of a redesigned terminal kernel against its first design on
# the same seeds and tiles: the same Philox draws, so the prices differ only
# through f32 rounding, and by at most this many stderr.
EARLIER_EURO_GATE = 0.5
# A price repeated with the same kernel on the same seed: the same paths bit
# for bit, so only the order of the regression's reductions may move it.
SAME_DRAWS_GATE = 0.01
# Rounds of (first, new, new, first) European prices per leg, timed on the
# host clock, so both designs' seconds per price come from one stretch.
EURO_TURNS = 5
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
# Issue and SFU rates at that clock: four warp instructions a clock an SM
# (thread instructions a second), and 16 MUFU results a clock an SM; kernel
# 18's floors from its SASS count (phase_dual_timing), not its bound.
PEAK_ISSUE = 4 * 32 * 132 * 1.98e9
PEAK_MUFU = 16 * 132 * 1.98e9
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
OPS_EXP = 2                             # expf(log_s0 + ls) per stored path-step
N_TIMED = 7
# Calibration (phase 3f). The JAX package's noisy L-BFGS-B fit of bench.py's
# surface (noise 0.005, seed 7), run on the CPU (x86-64, JAX_PLATFORMS=cpu):
# its weighted IV RMSE and the relative RMSE of its (theta, xi, rho, v0);
# tests/test_torch_calibration.py::test_noisy_lbfgsb_fit_matches_jax holds
# both. BENCH_r04's full-cascade noisy IV RMSE is printed beside them.
JAX_C2_IV_RMSE = 0.004150032314746727
JAX_C2_PARAM_RMSE = 0.06939227109145878
BENCH_R04_NOISY_IV_RMSE = 0.00415003
C2_IV_RTOL = 0.005             # C2's IV RMSE within 0.5% of the JAX package's
C2_PARAM_SLACK = 0.01          # C2's parameter RMSE at most JAX's + 0.01
DEVICE = "cuda"


def ops_lv(degree: int) -> float:
    """f32 operations per path-step of local vol at ``degree``: 17 + 4
    degree (clip, Clenshaw, update), the Box-Muller's 11 per two normals at
    one normal a pair-step, and the mirror's negation."""
    return 17 + 4 * degree + 11 / 4 + 1 / 2


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    log(f"FAIL: {msg}")
    sys.exit(1)


# The ops modules whose wrappers count their launches, each in a dict
# ``launches``: what a path run in a process of its own hands back.
COUNTED_MODULES = ("cuda_basket", "cuda_dual", "cuda_gbm", "cuda_heston", "cuda_heston_variants",
                   "cuda_jumps", "cuda_localvol", "cuda_rbergomi", "cuda_sabr", "cuda_vg",
                   "philox")
PATH_DIR = Path(__file__).resolve().parent / "build" / "paths"
PATH_TIMEOUT = 900


def launch_counts() -> dict:
    """Each counted module's ``launches`` dict, by module name."""
    import importlib

    return {m: importlib.import_module(f"options_model_tpu_torch.ops.{m}").launches
            for m in COUNTED_MODULES}


def _jsonable(o):
    return o.tolist() if hasattr(o, "tolist") else float(o)


def path_process(name: str, joined: bool = False) -> int:
    """``chip_smoke.py --path name``: one path (SEPARATE_PATHS) in this
    process, every launch count at 0 before it; writes its result and its
    counts to PATH_DIR/name.json. Exits at once if the process that
    started it ends first. Run alone (not ``joined`` by the whole script),
    the rough path also times its kernels (phase_sass, then
    phase_rough_timing), as phase 5 of the whole script does."""
    import os
    import threading

    import torch

    parent = os.getppid()

    def watch():
        while os.getppid() == parent:
            time.sleep(1.0)
        os._exit(3)

    threading.Thread(target=watch, daemon=True).start()
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from options_model_tpu_torch.ops import _build

    _build.load_library()
    counts = launch_counts()
    for d in counts.values():
        for key in d:
            d[key] = 0
    out = SEPARATE_PATHS[name]()
    PATH_DIR.mkdir(parents=True, exist_ok=True)
    (PATH_DIR / f"{name}.json").write_text(json.dumps(
        {"result": out, "launches": {m: dict(d) for m, d in counts.items()}},
        default=_jsonable))
    if name == "rough" and not joined:
        phase_rough_timing(phase_sass(), out, {k["name"]: k["counter"][0][k["counter"][1]]
                                               for k in rough_specs()})
    if name == "exotics" and not joined:
        phase_exotics_timing(phase_sass(), {k["name"]: k["counter"][0][k["counter"][1]]
                                            for k in exotics_specs()})
    return 0


def start_path(name: str):
    """Start ``chip_smoke.py --path name``, its output to PATH_DIR/name.log;
    the process is killed at exit if it is still running."""
    import atexit
    import subprocess

    PATH_DIR.mkdir(parents=True, exist_ok=True)
    for suffix in (".json", ".log"):
        (PATH_DIR / f"{name}{suffix}").unlink(missing_ok=True)
    with open(PATH_DIR / f"{name}.log", "w") as f:
        proc = subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--path", name,
                                 "--joined"], stdout=f, stderr=subprocess.STDOUT)

    def stop():
        if proc.poll() is None:
            proc.kill()
            proc.wait()

    atexit.register(stop)
    log(f"[3] started the {name} path in process {proc.pid}")
    return name, proc, time.perf_counter()


def join_path(started):
    """Wait for a path started by start_path, print its output, fail if it
    failed; load its launch counts into this process's counters (drive
    has set them to 0) and return its result."""
    name, proc, t0 = started
    t_wait = time.perf_counter()
    try:
        rc = proc.wait(timeout=PATH_TIMEOUT)
    except Exception:
        proc.kill()
        proc.wait()
        rc = None
    now = time.perf_counter()
    print((PATH_DIR / f"{name}.log").read_text(), end="", flush=True)
    log(f"[3] the {name} path's process: exit {rc}, {now - t0:.1f} s from its start, "
        f"{now - t_wait:.1f} s of them waited for here")
    if rc != 0:
        fail(f"the {name} path failed in its process (exit {rc})")
    data = json.loads((PATH_DIR / f"{name}.json").read_text())
    counts = launch_counts()
    for m, d in data["launches"].items():
        counts[m].update(d)
    return data["result"]


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
    first_tile, n_steps, variance, antithetic). Kernels 1 and 3-8 also
    carry ``earlier``, the same for their first design; kernels 4 and 6
    their scheme; kernels 7 and 8 ``checks``, (label, run, table) per degree
    of LV_DEGREES; kernels 1, 3 and 8 ``tails``, step counts that end in
    each tail of their draw loop (an odd count for Euler's two steps a draw,
    each n_steps % 4 for GBM's and local vol's four)."""
    from options_model_tpu_torch.core.config import HestonParams
    from options_model_tpu_torch.ops import cuda_gbm, cuda_heston, cuda_localvol
    from options_model_tpu_torch.surface.cheb import compile_localvol_table

    hp = HestonParams(kappa=2.0, theta=0.04, xi=0.3, rho=-0.7, v0=0.04)
    seed = 0x9E3779B97F4A7C15
    dev = DEVICE
    smile_terminal = compile_localvol_table(bench_smile, 100.0, 1.0, 100, 100.0)
    smiles = {d: compile_localvol_table(bench_smile, 100.0, 1.0, 100, 100.0, degree=d)
              for d in LV_DEGREES}
    # kernel 8's tables: the path's T and enough rows for every tail
    smiles_paths = {d: compile_localvol_table(bench_smile, 100.0, 0.5, max(LV_PATHS_TAILS),
                                              100.0, degree=d) for d in LV_DEGREES}
    smile_paths = smiles_paths[7]

    def paths_run(kernel, reference):
        def run(plain, n_tiles, first_tile, n_steps, variance, anti=True):
            fn = reference if plain else kernel
            out = fn(seed, 100.0, 0.05, 0.5, hp, n_tiles * cuda_heston.PATH_TILE, n_steps,
                     anti, variance, first_tile, dev)
            return out if variance else (out,)
        return run

    def heston_terminal(kernel):
        def run(plain, n_tiles, first_tile, n_steps, variance, anti=True):
            fn = cuda_heston.heston_terminal_reference if plain else kernel
            return (fn(seed, 100.0, 0.05, 1.0, hp, n_tiles * cuda_heston.TERMINAL_TILE,
                       n_steps, anti, first_tile, dev),)
        return run

    def gbm_paths(plain, n_tiles, first_tile, n_steps, variance, anti=True):
        fn = cuda_gbm.gbm_paths_reference if plain else cuda_gbm.gbm_paths
        return (fn(seed, 100.0, 0.05, 0.2, 0.5, n_tiles * cuda_heston.PATH_TILE, n_steps,
                   anti, first_tile, dev),)

    def gbm_terminal(kernel):
        def run(plain, n_tiles, first_tile, n_steps, variance, anti=True):
            fn = cuda_gbm.gbm_terminal_reference if plain else kernel
            return (fn(seed, 100.0, 0.05, 0.2, 1.0, n_tiles * cuda_heston.TERMINAL_TILE,
                       n_steps, anti, first_tile, dev),)
        return run

    def terminal_qe(kernel):
        def run(plain, n_tiles, first_tile, n_steps, variance, anti=True):
            fn = cuda_heston.heston_terminal_qe_reference if plain else kernel
            return (fn(seed, 100.0, 0.05, 1.0, hp, n_tiles * cuda_heston.TERMINAL_TILE,
                       n_steps, anti, first_tile, dev),)
        return run

    def paths_lv(kernel, table):
        def run(plain, n_tiles, first_tile, n_steps, variance, anti=True):
            fn = cuda_localvol.localvol_paths_reference if plain else kernel
            return (fn(seed, 100.0, 0.05, 0.5, table, n_tiles * cuda_heston.PATH_TILE,
                       n_steps, anti, first_tile, dev),)
        return run

    def terminal_lv(kernel, table):
        def run(plain, n_tiles, first_tile, n_steps, variance, anti=True):
            fn = cuda_localvol.localvol_terminal_reference if plain else kernel
            return (fn(seed, 100.0, 0.05, 1.0, table, n_tiles * cuda_heston.TERMINAL_TILE,
                       n_steps, anti, first_tile, dev),)
        return run

    src = "options_model_tpu_torch/csrc/"
    L, LV, G = cuda_heston.launches, cuda_localvol.launches, cuda_gbm.launches
    euler_tol = (EULER_S_RTOL, EULER_V_ATOL, EULER_V_RTOL)
    return [
        dict(name="heston_paths", source=src + "heston_paths.cu", scheme="euler",
             run=paths_run(cuda_heston.heston_paths, cuda_heston.heston_paths_reference),
             replaces="options_model_tpu/ops/pallas_heston.py:319",
             paths=("main", "nn", "greeks", "calibration", "jumps", "dual", "exotics"),
             tile=cuda_heston.PATH_TILE, main=(256, 50), timed=(256, 50), variance=(False, True),
             ops=OPS_HESTON + OPS_EXP, draws=DRAWS_HESTON, tol=euler_tol,
             counter=(L, "heston_paths"),
             earlier=dict(name="heston_paths_accurate", source=src + "heston.cu",
                          run=paths_run(cuda_heston.heston_paths_accurate,
                                        cuda_heston.heston_paths_reference),
                          counter=(L, "heston_paths_accurate"))),
        dict(name="heston_terminal", run=heston_terminal(cuda_heston.heston_terminal),
             source=src + "terminal.cu", replaces="options_model_tpu/ops/pallas_heston.py:263",
             paths=("main", "jumps"), tile=cuda_heston.TERMINAL_TILE, main=(256, 100),
             timed=(256, 100), variance=(False,), ops=OPS_HESTON, draws=DRAWS_HESTON,
             tol=(EULER_S_RTOL, 0.0, 0.0), tails=(99, 1), counter=(L, "heston_terminal"),
             earlier=dict(name="heston_terminal_accurate", source=src + "heston.cu",
                          run=heston_terminal(cuda_heston.heston_terminal_accurate),
                          counter=(L, "heston_terminal_accurate"))),
        dict(name="gbm_paths", run=gbm_paths, source=src + "gbm.cu",
             replaces="options_model_tpu/ops/pallas_gbm.py:126",
             paths=("main", "nn", "greeks", "dual", "exotics"),
             tile=cuda_heston.PATH_TILE, main=(512, 50), timed=(256, 50), variance=(False,),
             ops=OPS_GBM_PATHS, draws=DRAWS_GBM, counter=(G, "gbm_paths")),
        dict(name="gbm_terminal", run=gbm_terminal(cuda_gbm.gbm_terminal),
             source=src + "terminal.cu", replaces="options_model_tpu/ops/pallas_gbm.py:100",
             paths=("main", "greeks"), tile=cuda_heston.TERMINAL_TILE, main=(256, 100),
             timed=(256, 100), variance=(False,), ops=OPS_GBM, draws=DRAWS_GBM,
             tol=(GBM_S_RTOL, 0.0, 0.0), tails=(97, 98, 99, 1, 2, 3),
             counter=(G, "gbm_terminal"),
             earlier=dict(name="gbm_terminal_accurate", source=src + "gbm.cu",
                          run=gbm_terminal(cuda_gbm.gbm_terminal_accurate),
                          counter=(G, "gbm_terminal_accurate"))),
        dict(name="heston_terminal_qe", run=terminal_qe(cuda_heston.heston_terminal_qe),
             source=src + "terminal.cu", replaces="options_model_tpu/ops/pallas_heston.py:512",
             paths=("second", "jumps"), tile=cuda_heston.TERMINAL_TILE, main=(256, 100),
             timed=(256, 100), variance=(False,), ops=OPS_QE, draws=DRAWS_QE,
             tol=(QE_S_RTOL, 0.0, 0.0), counter=(L, "heston_terminal_qe"),
             earlier=dict(name="heston_terminal_qe_accurate", source=src + "heston_qe.cu",
                          run=terminal_qe(cuda_heston.heston_terminal_qe_accurate),
                          counter=(L, "heston_terminal_qe_accurate"))),
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
        dict(name="localvol_terminal", source=src + "terminal.cu",
             run=terminal_lv(cuda_localvol.localvol_terminal, smile_terminal),
             checks=[(f"degree {d}", terminal_lv(cuda_localvol.localvol_terminal, t), t)
                    for d, t in smiles.items()],
             replaces="options_model_tpu/ops/pallas_localvol.py:62",
             paths=("second", "ivnn"),
             tile=cuda_heston.TERMINAL_TILE, main=(256, 100), timed=(256, 100),
             variance=(False,), ops=ops_lv(smile_terminal.degree), draws=DRAWS_GBM,
             table=smile_terminal, tol=(LV_S_RTOL, 0.0, 0.0), counter=(LV, "localvol_terminal"),
             earlier=dict(name="localvol_terminal_accurate", source=src + "localvol.cu",
                          run=terminal_lv(cuda_localvol.localvol_terminal_accurate,
                                          smile_terminal),
                          checks=None, counter=(LV, "localvol_terminal_accurate"))),
        dict(name="localvol_paths", source=src + "localvol_paths.cu",
             run=paths_lv(cuda_localvol.localvol_paths, smile_paths),
             checks=[(f"degree {d}", paths_lv(cuda_localvol.localvol_paths, t), t)
                     for d, t in smiles_paths.items()],
             replaces="options_model_tpu/ops/pallas_localvol.py:149",
             paths=("second", "ivnn"),
             tile=cuda_heston.PATH_TILE, main=(512, 50), timed=(256, 50), variance=(False,),
             ops=ops_lv(smile_paths.degree) + OPS_EXP, draws=DRAWS_GBM, table=smile_paths,
             tol=(LV_S_RTOL, 0.0, 0.0), tails=LV_PATHS_TAILS, counter=(LV, "localvol_paths"),
             earlier=dict(name="localvol_paths_accurate", source=src + "localvol.cu",
                          run=paths_lv(cuda_localvol.localvol_paths_accurate, smile_paths),
                          checks=None, counter=(LV, "localvol_paths_accurate"))),
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


# Mangled-name pieces of the pricing instances of kernels 4 and 6
# (antithetic, with v) and of kernels 1, 3, 5, 7 and 8 (antithetic; local
# vol at degree 7, the redesigns also at degree 3): the redesigns
# (csrc/heston_paths.cu, csrc/terminal.cu, csrc/localvol_paths.cu) and the
# first designs, with the steps of a pair one pass of each time loop covers
# where that is not one.
SASS_KERNELS = {"euler": "18euler_paths_kernelILb1ELb1E", "qe": "15qe_paths_kernelILb1ELb1E",
                "euler, first design": "13heston_kernelILb1E",
                "qe, first design": "16heston_qe_kernelILb1E",
                "localvol terminal": "24localvol_terminal_kernelILi7ELb1E",
                "localvol terminal, first design": "15localvol_kernelILb0E",
                "qe terminal": "18qe_terminal_kernelILb1E",
                "qe terminal, first design": "16heston_qe_kernelILb0E",
                "euler terminal": "21euler_terminal_kernelILb1E",
                "euler terminal, first design": "13heston_kernelILb0E",
                "gbm terminal": "19gbm_terminal_kernelILb1E",
                "gbm terminal, first design": "10gbm_kernelILb0E",
                "localvol paths": "21localvol_paths_kernelILi7ELb1E",
                "localvol paths, first design": "15localvol_kernelILb1E",
                "localvol terminal, degree 3": "24localvol_terminal_kernelILi3ELb1E",
                "localvol paths, degree 3": "21localvol_paths_kernelILi3ELb1E",
                "euler vjp": "16euler_vjp_kernelILb1ELb1E",
                "euler vjp, first design": "22euler_paths_vjp_kernelILb1ELb1E",
                "merton terminal": "22merton_terminal_kernelILb1ELb0E",
                "merton terminal, first design": "13merton_kernelILb0ELb1E",
                "merton paths": "19merton_paths_kernelILb1ELb0E",
                "merton paths, first design": "13merton_kernelILb1ELb1E",
                "overlay paths": "20overlay_paths_kernelILb0E",
                "overlay paths, first design": "26overlay_paths_first_kernel",
                "gbm vjp": "14gbm_vjp_kernelILb1E",
                "gbm vjp, first design": "20gbm_paths_vjp_kernelILb1E",
                "overlay terminal": "23overlay_terminal_kernelILb0E",
                "dual_ce gbm": "14dual_ce_kernelILi0ELb0EE",
                "dual_ce gbm, first design": "20dual_ce_first_kernelILi0EE",
                "dual_ce heston": "14dual_ce_kernelILi1ELb0EE",
                "dual_ce heston, first design": "20dual_ce_first_kernelILi1EE",
                "dual_ce merton": "14dual_ce_kernelILi2ELb0EE",
                "dual_ce bates": "14dual_ce_kernelILi3ELb0EE",
                "dual_ce vg": "17dual_ce_vg_kernelILb0ELb0EE",
                "dual_ce vg, first design": "14dual_ce_kernelILi4ELb0EE",
                "dual_ce rbergomi": "20dual_ce_rough_kernelILb0ELb0EE",
                "dual_ce rbergomi, first design": "14dual_ce_kernelILi6ELb0EE",
                "dual_ce sabr": "19dual_ce_sabr_kernelILb0ELb0EE",
                "dual_ce sabr, first design": "14dual_ce_kernelILi5ELb0EE",
                "dual_vg_terminal": "28dual_vg_terminal_warp_kernelILb0ELb0EE",
                "dual_vg_terminal, first design": "23dual_vg_terminal_kernel",
                "vg paths": "15vg_paths_kernelILb1ELb0EE",
                "vg paths, first design": "21vg_paths_first_kernelILb1ELb0EE",
                "vg terminal": "18vg_terminal_kernelILb1ELb0EE",
                "vg terminal, first design": "24vg_terminal_first_kernelILb1ELb0EE",
                "sabr terminal": "20sabr_terminal_kernelILb1EE",
                "sabr terminal, first design": "26sabr_terminal_first_kernelILb1ELb1EE"}
# Pair-steps a pass of the time loop covers where that is not one. The
# redesigned Euler VJP's thread holds one path through four steps (two
# pair-steps' worth of path-steps); its first design a pair through two. The
# redesigned GBM paths VJP's thread holds one path through sixteen steps
# (two passes of eight); its first design a pair through one.
SASS_STEPS = {"euler": 2, "localvol terminal": 4, "euler terminal": 2, "gbm terminal": 4,
              "localvol paths": 4, "localvol terminal, degree 3": 4,
              "localvol paths, degree 3": 4, "euler vjp": 2, "euler vjp, first design": 2,
              "merton terminal": 2, "merton paths": 2, "gbm vjp": 8}
# Path-steps a pass of the overlay's time loop covers (one path a thread,
# no mirror): the redesign two, the first design one; the redesigned
# terminal overlay's grid-stride loop four values.
SASS_PATH_STEPS = {"overlay paths": 2, "overlay paths, first design": 1, "overlay terminal": 4}
# Surrogate evaluations a pass of kernel 18's calls loop covers (both
# designs' put instances): a GBM, Merton or VG call's four normals serve
# four pairs, a Heston, Bates or SABR call's two pairs, a rough Bergomi
# call one.
# The count is static: each evaluation's Horner loop (the redesign's is not
# unrolled; one pass of it at degree 1, two more at degree 3), the jump
# families' Poisson inversion and VG's first design's four attempt loops
# are counted once (dual_vg_floors adds the attempts a warp repeats). VG's
# redesign has no calls loop: its chunk loop holds the clock's three loops
# and the walk's (SASS_NESTED; dual_vg_floors).
SASS_EVALS = {"dual_ce gbm": 8, "dual_ce gbm, first design": 8, "dual_ce heston": 4,
              "dual_ce heston, first design": 4, "dual_ce merton": 8, "dual_ce bates": 4,
              "dual_ce vg, first design": 8, "dual_ce rbergomi": 2,
              "dual_ce rbergomi, first design": 2, "dual_ce sabr": 4,
              "dual_ce sabr, first design": 4}
# Kernel 21's loops nest (sass_loops reads the largest and the loops
# directly inside it): the redesign's chunk loop holds its first attempts
# (a pass: one step's draw of both paths of a pair), its retries (a pass:
# one attempt of one draw a lane) and its walk (a pass: a pair-step); the
# first design's step loop (a pass: a pair-step) holds each path's attempt
# loop (a pass: one attempt). Kernel 24's loops cover a pair-step, both
# designs. Kernel 18's VG redesign: its chunk loop (8 pairs a lane) holds
# its first attempts (a pass: one pair's attempt 0 a lane), exact tests and
# retries (a pass: one entry a lane) and walk (a pass: one call's four
# pairs); its first design's calls loop (four pairs) its four attempt loops
# (a pass: one attempt of one pair's draw) beside the Horner loops. VG's
# terminal step in the dual: the redesign's chunk loop (8 entries a lane)
# holds its first attempts (a pass: one entry a lane's attempt 0), exact
# tests and retries (a pass: one entry a lane), walk (a pass: one entry a
# lane) and sums (a pass: one value of a path); the first design's draw
# loop (a pass: one draw of a path a lane) its attempt loop.
SASS_NESTED = ("vg paths", "vg paths, first design", "dual_ce vg", "dual_ce vg, first design",
               "dual_vg_terminal", "dual_vg_terminal, first design")
# Kernel 22's designs have no time loop: sass_whole counts each whole
# function (its called slow paths, its padding and its trap left out) and
# the loops not inside another, in address order: the redesign's first
# attempts (a pass: one slot's draws, both mirror paths), exact tests and
# retries (a pass: one entry a lane, a warp's) and walk (a pass: a slot);
# the first design's two attempt loops (a pass: one attempt of one draw).
SASS_WHOLE = ("vg terminal", "vg terminal, first design")
# Loops that must hold no local load or store (LDL, STL): kernel 12's
# redesign, whose sine and cosine leave out the Payne-Hanek path, and
# kernel 18's (phase_dual_kernels also fails if any of its instances has
# local memory at all), and the redesigns of kernels 21 (its chunk loop,
# all three inner loops with it) and 24.
SASS_NO_LOCAL = ("gbm vjp", "dual_ce gbm", "dual_ce heston", "dual_ce merton", "dual_ce bates",
                 "dual_ce vg", "dual_ce rbergomi", "dual_ce sabr", "dual_vg_terminal",
                 "vg paths", "sabr terminal")
# The loops whose instructions phase_sass prints by unit.
SASS_PIPES = ("euler terminal", "gbm terminal", "localvol terminal", "localvol paths",
              "localvol terminal, degree 3", "localvol paths, degree 3", "euler vjp",
              "euler vjp, first design", "merton terminal", "merton terminal, first design",
              "merton paths", "merton paths, first design", "overlay paths",
              "overlay paths, first design", "gbm vjp", "gbm vjp, first design",
              "overlay terminal", "dual_ce gbm", "dual_ce gbm, first design", "dual_ce heston",
              "dual_ce heston, first design", "dual_ce merton", "dual_ce bates",
              "dual_ce vg", "dual_ce vg, first design", "dual_ce rbergomi",
              "dual_ce rbergomi, first design", "dual_ce sabr", "dual_ce sabr, first design",
              "dual_vg_terminal", "dual_vg_terminal, first design", "vg paths",
              "vg paths, first design", "sabr terminal", "sabr terminal, first design")


def per_step(key: str, n: int) -> str:
    """A loop's instructions a pair-step and a path-step (SASS_STEPS), a
    path-step (SASS_PATH_STEPS) or a surrogate evaluation (SASS_EVALS), for
    the log."""
    if key in SASS_EVALS:
        return f" ({n / SASS_EVALS[key]:g} an evaluation)"
    if key in SASS_STEPS:
        return (f" ({n / SASS_STEPS[key]:g} a pair-step, {n / SASS_STEPS[key] / 2:g} a "
                "path-step)")
    if key in SASS_PATH_STEPS:
        return f" ({n / SASS_PATH_STEPS[key]:g} a path-step)"
    return ""


def _sass_code(chunk: str, jumps: str = "BRA") -> tuple:
    """One function of ``cuobjdump -sass`` output: its instructions as
    (address, text), and the targets of its ``jumps`` instructions as
    (address, target address) where the target is read."""
    labels, branches, pending, code = {}, [], [], []
    for line in chunk.splitlines():
        lab = re.match(r"\s*([.$][\w.$]+):", line)
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
        if re.search(rf"\b(?:{jumps})\b", m.group(2)):
            tgt = re.search(r"`\(([.$][\w.$]+)\)|\b0x([0-9a-f]+)\b", m.group(2))
            if tgt:
                branches.append((addr, tgt.group(1) or int(tgt.group(2), 16)))
    targets = [(addr, labels.get(t, t)) for addr, t in branches]
    return code, [(addr, t) for addr, t in targets if isinstance(t, int)]


def sass_loops(text: str) -> tuple:
    """The instructions of the largest loop (the span of a backward branch)
    of each SASS_KERNELS kernel in ``cuobjdump -sass`` output, and for the
    SASS_NESTED kernels the loops directly inside it, in address order."""
    out, inner = {}, {}
    for chunk in text.split("Function : ")[1:]:
        name = chunk.split(None, 1)[0]
        key = next((k for k, piece in SASS_KERNELS.items() if piece in name), None)
        if key is None:
            continue
        code, branches = _sass_code(chunk)
        spans = [(t, addr) for addr, t in branches if t <= addr]
        lo, hi = max(spans, key=lambda s: s[1] - s[0]) if spans else (0, -1)
        out[key] = [ins for addr, ins in code if lo <= addr <= hi]
        if key in SASS_NESTED:
            kids = {sp for sp in spans if lo <= sp[0] and sp[1] <= hi and sp != (lo, hi)}
            kids = sorted(sp for sp in kids if not any(
                o != sp and o[0] <= sp[0] and sp[1] <= o[1] for o in kids))
            inner[key] = [[ins for addr, ins in code if a <= addr <= b] for a, b in kids]
    return out, inner


def sass_whole(text: str) -> dict:
    """Each SASS_WHOLE kernel of ``cuobjdump -sass`` output: its
    instructions (the code its CALLs reach, up to their RET, the NOPs and
    the closing self-branch left out), their MUFU and local loads and
    stores, and the loops not inside another (spans of backward branches
    outside the called code), in address order."""
    out = {}
    for chunk in text.split("Function : ")[1:]:
        name = chunk.split(None, 1)[0]
        key = next((k for k in SASS_WHOLE if SASS_KERNELS[k] in name), None)
        if key is None:
            continue
        code, branches = _sass_code(chunk)
        _, calls = _sass_code(chunk, "CALL")
        rets = [addr for addr, ins in code if opcode(ins).startswith("RET")]
        called = [(t, min((r for r in rets if r >= t), default=t)) for _, t in calls]
        inside = lambda a: any(lo <= a <= hi for lo, hi in called)  # noqa: E731
        body = [(a, ins) for a, ins in code if not inside(a) and opcode(ins) != "NOP"
                and not any(a == b == t for b, t in branches)]
        spans = {(t, a) for a, t in branches if t < a and not inside(a)}
        tops = sorted(sp for sp in spans
                      if not any(o != sp and o[0] <= sp[0] and sp[1] <= o[1] for o in spans))
        ins = [i for _, i in body]
        out[key] = dict(total=len(body), mufu=pipe_mix(ins)["MUFU"],
                        local=sum(opcode(i).startswith(("LDL", "STL")) for i in ins),
                        loops=[[i for a, i in body if lo <= a <= hi] for lo, hi in tops])
    return out


# Kernel 28's two designs at 3 assets, antithetic (B2's instance): the
# mangled-name piece of each and the slots a thread of it.
SASS_BASKET = {"basket terminal": ("22basket_terminal_kernelILi3ELi4ELb1EE", 4),
               "basket terminal, first design": ("13basket_kernelILi3ELi0EE", 1)}


def sass_basket(text: str) -> dict:
    """Static instructions a pair of each SASS_BASKET kernel: its whole
    function (the NOPs and the closing self-branch left out; the slow paths
    of its libdevice calls in, which this stream's arguments never take)
    over its slots a thread. At one step every other instruction runs once
    a thread."""
    out = {}
    for chunk in text.split("Function : ")[1:]:
        name = chunk.split(None, 1)[0]
        for key, (piece, slots) in SASS_BASKET.items():
            if piece in name:
                code, branches = _sass_code(chunk)
                n = sum(1 for a, ins in code if opcode(ins) != "NOP"
                        and not any(a == b == t for b, t in branches))
                out[key] = n / slots
    return out


# The routes of kernels 27-28 from 9 assets, the instances phase 5 times:
# the register instances at 12 assets (antithetic terminal, K = 1) and the
# wide route's (csrc/basket.cuh basket_wide_kernel<kMode, 8>).
SASS_BASKET_ROUTES = {"basket_paths_9_16": "13basket_kernelILi12ELi1EE",
                      "basket_terminal_9_16": "22basket_terminal_kernelILi12ELi1ELb1EE",
                      "basket_paths_17_128": "18basket_wide_kernelILi1ELi8EE",
                      "basket_terminal_17_128": "18basket_wide_kernelILi0ELi8EE"}
WIDE_SASS_ROWS, WIDE_SASS_UNROLL = 8, 2


def sass_basket_routes(text: str) -> dict:
    """The static SASS of each SASS_BASKET_ROUTES kernel, read for its
    instructions a pair-step. The register instances: the paths kernel's
    step loop (fully unrolled: every instruction of it runs once a
    pair-step), the terminal kernel's whole function (one pair a thread).
    The wide route by parts, each a thread's static code: its step loop
    less the loops inside it ("step": the barrier, both row blocks'
    diagonals (the first block's and any other's, of which a group runs
    one), log steps and stores, the chunk loops' remainders), the draw loop
    a Philox call ("draw", the loop inside the step loop that holds MUFU),
    the chunk loops' body a chunk (four columns of eight rows; "chunk", the
    mean of the other loops inside it over WIDE_SASS_UNROLL chunks an
    iteration), and outside every loop the rest ("once"). Empty for a
    kernel whose loops do not read so."""
    out = {}
    for chunk in text.split("Function : ")[1:]:
        name = chunk.split(None, 1)[0]
        key = next((k for k, piece in SASS_BASKET_ROUTES.items() if piece in name), None)
        if key is None or key in out:
            continue
        code, branches = _sass_code(chunk)
        code = [(a, i) for a, i in code if opcode(i) != "NOP"
                and not any(a == b == t for b, t in branches)]
        spans = sorted({(t, a) for a, t in branches if t <= a})
        if not spans:
            continue
        count = lambda lo, hi: sum(1 for a, _ in code if lo <= a <= hi)  # noqa: E731
        body = lambda lo, hi: [i for a, i in code if lo <= a <= hi]  # noqa: E731
        step = max(spans, key=lambda sp: sp[1] - sp[0])
        if key.endswith("9_16"):
            out[key] = dict(per_pair_step=count(*step) if "paths" in key else len(code))
            continue
        inside = [sp for sp in spans if step[0] <= sp[0] and sp[1] <= step[1] and sp != step]
        kids = [sp for sp in inside if not any(o != sp and o[0] <= sp[0] and sp[1] <= o[1]
                                               for o in inside)]
        draws = [sp for sp in kids if pipe_mix(body(*sp))["MUFU"]]
        chunks = [sp for sp in kids if sp not in draws]
        if len(draws) != 1 or not chunks:
            continue
        loops = [sp for sp in spans if not any(o != sp and o[0] <= sp[0] and sp[1] <= o[1]
                                               for o in spans)]
        out[key] = dict(step=count(*step) - sum(count(*sp) for sp in kids),
                        draw=count(*draws[0]),
                        chunk=sum(count(*sp) for sp in chunks) / len(chunks) / WIDE_SASS_UNROLL,
                        chunk_loops=len(chunks),
                        once=len(code) - sum(count(*sp) for sp in loops))
    return out


def basket_issue_floor(parts: dict, n: int, pairs: int, steps: int) -> dict:
    """Instructions a pair-step of a SASS_BASKET_ROUTES kernel at n assets
    (sass_basket_routes' parts) and its issue floor at ``pairs`` pairs x
    ``steps`` steps. The register instances: every instruction of their
    step. The wide route, a lower bound: the draws (ceil(n / 4) passes of
    the draw loop) and the correlate's n (n + 1) / 2 products at the chunk
    loop's instructions a product (a chunk is 32 products with their loads),
    over the G threads of a slot; the log steps, stores, diagonals and the
    row blocks' padding rows are left out."""
    if not parts:
        return {}
    if "per_pair_step" in parts:
        ips = parts["per_pair_step"]
    else:
        ips = -(-n // 4) * parts["draw"] + n * (n + 1) / 2 / 32 * parts["chunk"]
    return dict(instructions_per_pair_step=ips,
                issue_floor_ms=pairs * steps * ips / PEAK_ISSUE * 1e3)


def _vg_terminal_roles(key: str, loops: list) -> dict:
    """Kernel 22's loops by role (SASS_WHOLE), {} unless they read as
    expected: the redesign's four in source order, the first attempts,
    exact tests and retries each with a ballot (VOTE) and no global store,
    the walk with the stores (STG); the first design's two attempt loops
    hold no store."""
    ops = [[opcode(ins) for ins in loop] for loop in loops]
    has = lambda i, pre: any(o.startswith(pre) for o in ops[i])  # noqa: E731
    if key == "vg terminal":
        roles = ("first attempts", "exact tests", "retries", "walk")
        if (len(loops) == 4 and has(3, "STG")
                and all(has(i, "VOTE") and not has(i, "STG") for i in range(3))):
            return {role: i for i, role in enumerate(roles)}
        return {}
    if len(loops) == 2 and not has(0, "STG") and not has(1, "STG"):
        return {"attempts": 0, "attempts, mirror": 1}
    return {}


def _vg_roles(key: str, kids: list) -> dict:
    """Kernel 21's and kernel 18's VG inner loops by role (SASS_NESTED), {}
    unless they read as expected. Kernel 21: the redesign's walk holds the
    global stores (STG), its retries the block barrier (BAR), its first
    attempts the ballot (VOTE); the first design's two attempt loops hold no
    store. Kernel 18's VG redesign: four loops in source order, the first
    attempts, exact tests and retries each with a ballot, the walk without;
    its first design: the four loops that call libdevice's logf (MUFU) are
    the attempt loops, the rest its Horner loops. VG's terminal step in the
    dual: the redesign's five loops in source order, the first attempts,
    exact tests and retries each with a ballot, the walk and the sums
    without; its first design's one attempt loop."""
    ops = [[opcode(ins) for ins in k] for k in kids]
    has = lambda i, pre: any(o.startswith(pre) for o in ops[i])  # noqa: E731
    if key == "dual_vg_terminal":
        roles = ("first attempts", "exact tests", "retries", "walk", "sums")
        if (len(kids) == 5 and all(has(i, "VOTE") for i in range(3))
                and not has(3, "VOTE") and not has(4, "VOTE")):
            return {role: i for i, role in enumerate(roles)}
        return {}
    if key == "dual_vg_terminal, first design":
        return {"attempts": 0} if len(kids) == 1 and has(0, "MUFU") else {}
    if key == "dual_ce vg":
        roles = ("first attempts", "exact tests", "retries", "walk")
        if len(kids) == 4 and all(has(i, "VOTE") for i in range(3)) and not has(3, "VOTE"):
            return {role: i for i, role in enumerate(roles)}
        return {}
    if key == "dual_ce vg, first design":
        tries = [i for i in range(len(kids)) if has(i, "MUFU")]
        return {f"attempts {n}": i for n, i in enumerate(tries)} if len(tries) == 4 else {}
    if key == "vg paths":
        roles = {}
        for i in range(len(kids)):
            role = ("walk" if has(i, "STG") else "retries" if has(i, "BAR")
                    else "first attempts" if has(i, "VOTE") else None)
            if role is None or role in roles:
                return {}
            roles[role] = i
        return roles if len(roles) == 3 else {}
    if len(kids) == 2 and not has(0, "STG") and not has(1, "STG"):
        return {"attempts": 0, "attempts, mirror": 1}
    return {}


def vg_loop_parts(key: str, kids: list) -> dict:
    """Instructions of kernel 21's inner loops by role (_vg_roles)."""
    return {role: len(kids[i]) for role, i in _vg_roles(key, kids).items()}


def vg_loop_mufu(key: str, kids: list) -> dict:
    """MUFU of kernel 21's inner loops by role (_vg_roles)."""
    return {role: pipe_mix(kids[i])["MUFU"] for role, i in _vg_roles(key, kids).items()}


def opcode(ins: str) -> str:
    return re.sub(r"^@!?U?P\w+\s+", "", ins.strip()).split()[0]


# Opcode prefixes by the unit that runs them (the first match counts): the
# SFU, integer multiplies, 3-input logic, other integer work, f32 arithmetic.
PIPES = (("MUFU", ("MUFU",)), ("IMAD", ("IMAD",)), ("LOP3", ("LOP3",)),
         ("other int", ("IADD", "ISETP", "LEA", "SHF", "SEL", "IABS", "IMNMX", "PRMT")),
         ("f32", ("FFMA", "FMUL", "FADD", "FMNMX", "FSEL", "FSETP", "FCHK")))


def pipe_mix(loop: list) -> dict:
    """Instructions of a SASS loop per PIPES class, the rest as "other"."""
    out = dict.fromkeys([name for name, _ in PIPES] + ["other"], 0)
    for ins in loop:
        op = opcode(ins)
        out[next((name for name, pre in PIPES if op.startswith(pre)), "other")] += 1
    return out


def phase_sass() -> dict:
    """The time loops of both designs of the paths and terminal kernels in
    SASS (cuobjdump -sass of the built library, static instructions) and, from the
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
    loops, inner = sass_loops(text)
    log("[1] SASS time loops (static instructions of the largest backward-branch span; "
        "the redesigned Euler loops (paths and terminal) cover two steps of a pair and one "
        "Philox call, the local-vol (terminal and paths) and GBM terminal redesigns four "
        "steps, one Philox call and two Box-Mullers, every other loop one step; the first "
        "designs' Euler, GBM and local vol call Philox every other or every fourth step, "
        "the local-vol ones hold their Clenshaw loop; the redesigned Merton loops (paths "
        "and terminal) cover two pair-steps, the redesigned overlay two path-steps of one "
        "path; a pair-step is both mirror paths' step; kernel 18's loop is one Philox call "
        "of the inner draws, eight surrogate evaluations under GBM and Merton, four under Heston, "
        "Bates and SABR, two under rough Bergomi, eight under VG's first design (its attempt "
        "loops once); kernel 18's VG redesign's largest loop is its chunk loop of 8 pairs a "
        "lane; VG's terminal step's redesign's its chunk loop of 8 entries a lane, its first "
        "design's a draw; "
        "kernel 21's redesign's largest loop is its chunk loop of 8 steps, its "
        "first design's a pair-step, each with its loops inside (below); kernel 24's loops a "
        "pair-step): "
        + ", ".join(f"{k} {len(v)}" + per_step(k, len(v)) for k, v in loops.items()))
    for key in SASS_PIPES:
        if key in loops:
            unit = (f"{SASS_PATH_STEPS[key]} path-steps" if key in SASS_PATH_STEPS
                    else f"{SASS_EVALS[key]} evaluations" if key in SASS_EVALS
                    else {"dual_ce vg": f"{DUAL_VG_CHUNK} pairs a lane, each inner loop once",
                          "dual_vg_terminal": f"{DUAL_VG_CHUNK} entries a lane, each inner "
                                              "loop once",
                          "dual_vg_terminal, first design": "one draw a lane, its attempt "
                                                            "loop once"}.get(
                              key, f"{SASS_STEPS.get(key, 1)} pair-steps"))
            local = sum(opcode(ins).startswith(("LDL", "STL")) for ins in loops[key])
            mix = pipe_mix(loops[key])
            log(f"[1] SASS {key} loop by unit (a pass of {unit}): "
                + ", ".join(f"{k} {n}" for k, n in mix.items())
                + (f"; an evaluation: {len(loops[key]) / SASS_EVALS[key]:g}, "
                   + ", ".join(f"{k} {n / SASS_EVALS[key]:g}" for k, n in mix.items())
                   if key in SASS_EVALS else "")
                + f"; local loads and stores {local}")
            if key in SASS_NO_LOCAL and local:
                fail(f"the {key} loop holds {local} local loads or stores")
    nested = {}
    for key, kids in inner.items():
        parts = vg_loop_parts(key, kids)
        outer = {"vg paths": "chunk", "dual_ce vg": "chunk", "dual_ce vg, first design": "calls",
                 "dual_vg_terminal": "chunk",
                 "dual_vg_terminal, first design": "draws"}.get(key, "step")
        log(f"[1] SASS {key}: loops inside its {outer} loop "
            f"({len(loops[key])} instructions): "
            + ", ".join(f"{len(k)} ({pipe_mix(k)['MUFU']} MUFU)" for k in kids)
            + (f"; read as {', '.join(f'{p} {n}' for p, n in parts.items())}" if parts
               else "; not read as the expected loops: no floors"))
        if parts:
            nested[key] = dict(parts=parts, mufu=vg_loop_mufu(key, kids), outer=len(loops[key]),
                               outer_mufu=pipe_mix(loops[key])["MUFU"])
    whole = {}
    for key, w in sass_whole(text).items():
        roles = _vg_terminal_roles(key, w["loops"])
        parts = {r: len(w["loops"][i]) for r, i in roles.items()}
        log(f"[1] SASS {key} (no time loop): {w['total']} instructions ({w['mufu']} MUFU, "
            f"{w['local']} local loads and stores), loops not inside another "
            + ", ".join(f"{len(k)} ({pipe_mix(k)['MUFU']} MUFU)" for k in w["loops"])
            + (f"; read as {', '.join(f'{r} {n}' for r, n in parts.items())}, the rest "
               f"{w['total'] - sum(parts.values())}" if parts
               else "; not read as the expected loops: no floors"))
        if key == "vg terminal" and w["local"]:
            fail(f"kernel 22's redesign holds {w['local']} local loads or stores")
        if parts:
            whole[key] = dict(parts=parts, mufu={r: pipe_mix(w["loops"][i])["MUFU"]
                                                 for r, i in roles.items()},
                              outer=w["total"], outer_mufu=w["mufu"])
    basket = sass_basket(text)
    log("[1] SASS kernel 28 at 3 assets, antithetic, static instructions a pair (the whole "
        "function over its slots a thread): "
        + (", ".join(f"{k} {v:g}" for k, v in basket.items()) or "not found"))
    routes = sass_basket_routes(text)
    log("[1] SASS kernels 27-28 from 9 assets (sass_basket_routes: the 12-asset register "
        "instances' instructions a pair-step, the wide route's parts): "
        + ("; ".join(f"{k} " + ", ".join(f"{p} {v}" for p, v in d.items())
                     for k, d in routes.items()) or "not read"))
    usage = subprocess.run([tool, "-res-usage", str(_build.library_path())],
                           capture_output=True, text=True, timeout=300).stdout
    regs = {}
    for name, reg, stack in re.findall(r"Function (\S+):\s*REG:(\d+) STACK:(\d+)", usage):
        key = next((k for k, piece in SASS_KERNELS.items() if piece in name), None)
        if key is not None:
            regs[key] = (int(reg), int(stack))
    log("[1] registers and stack bytes a thread (cuobjdump -res-usage): "
        + (", ".join(f"{k} {r} / {st}" for k, (r, st) in regs.items()) or "not read"))
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
                loops={k: len(v) for k, v in loops.items()},
                mufu={k: pipe_mix(v)["MUFU"] for k, v in loops.items()}, nested=nested,
                whole=whole, basket=basket, basket_routes=routes)


def phase_philox() -> None:
    import torch

    from options_model_tpu_torch.ops.philox import (sincos_check_cuda, stream_words,
                                                    stream_words_cuda)

    for n_tiles, first_tile in ((2, 0), (64, 0), (2, 7)):
        args = (0x0123456789ABCDEF, first_tile, n_tiles, 2048, 25)
        got = stream_words_cuda(*args, device=DEVICE)
        want = stream_words(*args, device=DEVICE)
        if not torch.equal(got, want):
            fail(f"Philox words differ at {n_tiles} tiles, first_tile {first_tile}")
    log("[2] Philox words: kernel == plain, bit for bit (2 and 64 tiles, offset 7)")
    out = sincos_check_cuda(DEVICE)
    torch.cuda.synchronize()
    bits = out.view(torch.int32)
    bad = [int((bits[i] != bits[i + 2]).sum()) for i in (0, 1)]
    if any(bad):
        fail(f"sincos_stream_angle differs from sinf at {bad[0]} and from cosf at {bad[1]} of "
             f"the stream's {bits.shape[1]} angles")
    log(f"[2] sincos_stream_angle (csrc/philox.cuh, the Box-Muller of kernel 12's redesign) == "
        f"sinf and cosf bit for bit at all {bits.shape[1]} angles float(2 pi) u2")


def earlier_specs(specs) -> list:
    """The first design of kernels 1 and 3-8 as specs of their own, held to
    the tolerances they were built to (S_RTOL, V_ATOL, V_RTOL)."""
    return [dict(k, **k["earlier"], tol=(S_RTOL, V_ATOL, V_RTOL)) for k in specs
            if "earlier" in k]


def phase_kernels(specs) -> dict:
    """Kernel vs plain at 2 and 64 tiles and at the main path's shape (and
    at 2 tiles without antithetic mirroring), within each spec's tolerances,
    for each of its ``checks`` (kernel 7: one table per degree) and, at 2
    tiles with and without antithetics, each of its ``tails``; and the
    first_tile chunk property. Returns per name the max |kernel - plain| of
    S, the max relative one, and the max |kernel - plain| of v."""
    import torch

    errs = {}
    for k in specs:
        n_main, steps = k["main"]
        s_rtol, v_atol, v_rtol = k.get("tol", (S_RTOL, V_ATOL, V_RTOL))
        err = dict(s_abs=0.0, s_rel=0.0, v_abs=0.0)
        checks = k.get("checks") or [("", k["run"], None)]

        def check(label, run, n_tiles, n_steps, variance, anti):
            got = run(False, n_tiles, 0, n_steps, variance, anti)
            want = run(True, n_tiles, 0, n_steps, variance, anti)
            torch.cuda.synchronize()
            for name, g, w in zip("Sv", got, want):
                if g.shape != w.shape or not bool(torch.isfinite(g).all()):
                    fail(f"{k['name']} {label}: {name} shape {tuple(g.shape)} vs "
                         f"{tuple(w.shape)} or non-finite")
                rtol, atol = (s_rtol, 0.0) if name == "S" else (v_rtol, v_atol)
                diff = (g - w).abs()
                bad = diff > atol + rtol * w.abs()
                e = float(diff.max())
                if bool(bad.any()):
                    fail(f"{k['name']} {label} {n_tiles} tiles x {n_steps} steps: {name} "
                         f"differs from the plain version (max abs {e:.3e}, "
                         f"{int(bad.sum())} entries beyond rtol {rtol}, atol {atol})")
                if name == "S":
                    err["s_abs"] = max(err["s_abs"], e)
                    err["s_rel"] = max(err["s_rel"], float((diff / w.abs()).max()))
                else:
                    err["v_abs"] = max(err["v_abs"], e)

        for variance in k["variance"]:
            for (label, run, _), (n_tiles, anti) in itertools.product(
                    checks, ((2, True), (64, True), (n_main, True), (2, False))):
                check(label, run, n_tiles, steps, variance, anti)
            for n_steps, anti in itertools.product(k.get("tails", ()), (True, False)):
                check("tail", k["run"], 2, n_steps, variance, anti)
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
            labels = ", ".join(label for label, _, _ in checks if label)
            tails = k.get("tails")
            log(f"[2] {k['name']} (variance={variance}{'; ' + labels if labels else ''}): "
                f"kernel == plain within rtol {s_rtol} on S" + (f", {v_txt}" if variance else "")
                + f" at 2, 64, {n_main} tiles x {steps} steps (and 2 tiles without "
                  "antithetics)"
                + (f", at 2 tiles x {', '.join(map(str, tails))} steps with and without "
                   "antithetics" if tails else "")
                + f": max |dS| {err['s_abs']:.3e} (max rel {err['s_rel']:.3e})"
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
    """sha256 of the output of kernel 4's first design (csrc/heston.cu, the
    paths and the terminal kernel) at the KERNEL4_DIGEST arguments."""
    import torch

    from options_model_tpu_torch.core.config import HestonParams
    from options_model_tpu_torch.ops import cuda_heston

    hp = HestonParams(kappa=2.0, theta=0.04, xi=0.3, rho=-0.7, v0=0.04)
    seed = 0x9E3779B97F4A7C15
    S, V = cuda_heston.heston_paths_accurate(seed, 100.0, 0.05, 0.5, hp, 64 * 4096, 50, True,
                                             True, 0, DEVICE)
    ST = cuda_heston.heston_terminal_accurate(seed, 100.0, 0.05, 1.0, hp, 16 * 16384, 100,
                                              True, 0, DEVICE)
    torch.cuda.synchronize()
    h = hashlib.sha256()
    for x in (S, V, ST):
        h.update(x.cpu().numpy().tobytes())
    return h.hexdigest()


def paths_digest() -> str:
    """sha256 of the redesigned paths kernels (csrc/heston_paths.cu) at the
    PATHS_DIGEST arguments."""
    import torch

    from options_model_tpu_torch.core.config import HestonParams
    from options_model_tpu_torch.ops import cuda_heston

    hp = HestonParams(kappa=2.0, theta=0.04, xi=0.3, rho=-0.7, v0=0.04)
    h = hashlib.sha256()
    for scheme in ("euler", "qe"):
        for anti in (True, False):
            S, V = cuda_heston.heston_paths_batched(0x9E3779B97F4A7C15, 100.0, 0.05, [0.5, 1.0],
                                                    hp, 16 * 4096, 50, anti, True, 3, DEVICE,
                                                    scheme)
            torch.cuda.synchronize()
            for x in (S, V):
                h.update(x.cpu().numpy().tobytes())
    return h.hexdigest()


def lv_terminal_digest() -> str:
    """sha256 of the redesigned local-vol terminal kernel (csrc/terminal.cu)
    at the LV_TERMINAL_DIGEST arguments."""
    import torch

    from options_model_tpu_torch.ops import cuda_localvol
    from options_model_tpu_torch.surface.cheb import compile_localvol_table

    h = hashlib.sha256()
    for degree in LV_DEGREES:
        table = compile_localvol_table(bench_smile, 100.0, 1.0, 100, 100.0, degree=degree)
        for anti in (True, False):
            ST = cuda_localvol.localvol_terminal(0x9E3779B97F4A7C15, 100.0, 0.05, 1.0, table,
                                                 8 * 16384, 100, anti, 3, DEVICE)
            torch.cuda.synchronize()
            h.update(ST.cpu().numpy().tobytes())
    return h.hexdigest()


def phase_digests() -> None:
    got = kernel4_digest()
    if got != KERNEL4_DIGEST:
        fail(f"kernel 4's output changed with heston_common.cuh: digest {got}, recorded "
             f"{KERNEL4_DIGEST}")
    log("[2] kernel 4's first design (heston_paths_accurate with v, "
        "heston_terminal_accurate) "
        "bit-equal to its output "
        f"before heston_common.cuh: sha256 {got[:16]}...")
    got = paths_digest()
    if got != PATHS_DIGEST:
        fail(f"the redesigned kernels 4 and 6 changed with hopper_fast.cuh: digest {got}, "
             f"recorded {PATHS_DIGEST}")
    log("[2] the redesigned kernels 4 and 6 (heston_paths_batched, Euler and QE-M with v) "
        f"bit-equal to their output before hopper_fast.cuh: sha256 {got[:16]}...")
    got = lv_terminal_digest()
    if got != LV_TERMINAL_DIGEST:
        fail(f"the redesigned kernel 7 changed with hopper_fast.cuh: digest {got}, recorded "
             f"{LV_TERMINAL_DIGEST}")
    log("[2] the redesigned kernel 7 (localvol_terminal, degrees 3, 7, 17, with and without "
        f"antithetics) bit-equal to its output before hopper_fast.cuh: sha256 {got[:16]}...")


def check_variant(hv, exp_mode, layout, unroll, tile, n_tiles, steps, seed=0x9E3779B97F4A7C15,
                  T=1.0, accurate=False) -> float:
    """A variant of the redesign (or of the first design) against its plain
    version on the same Philox bits: S (after exp(log S0 + out) for the
    log-only form) within rtol EULER_S_RTOL (S_RTOL). Returns the max
    |kernel - plain| of S."""
    import torch

    from options_model_tpu_torch.core.config import HestonParams
    from options_model_tpu_torch.models.heston import heston_constants

    hp = HestonParams(kappa=2.0, theta=0.04, xi=0.3, rho=-0.7, v0=0.04)
    args = (seed, 100.0, 0.05, T, hp, n_tiles * tile, steps, exp_mode, layout, unroll, tile)
    fn = hv.heston_variant_accurate if accurate else hv.heston_variant
    rtol = S_RTOL if accurate else EULER_S_RTOL
    name = f"variant {hv.launch_key(exp_mode, layout, unroll, accurate)} tile {tile}"
    got = fn(*args, device=DEVICE)
    want = hv.heston_variant_reference(*args, device=DEVICE)
    torch.cuda.synchronize()
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        fail(f"{name}: shape {tuple(got.shape)} vs {tuple(want.shape)} or non-finite")
    if exp_mode == "none":
        log_s0 = float(heston_constants(100.0, 0.05, T, hp, steps)["log_s0"])
        got, want = torch.exp(log_s0 + got), torch.exp(log_s0 + want)
    err = float((got - want).abs().max())
    if bool(((got - want).abs() > rtol * want.abs()).any()):
        fail(f"{name}: differs from its plain version (max abs {err:.3e}, rtol {rtol})")
    return err


def phase_variants() -> dict:
    """Every built variant of both designs at tile 4096, 64 tiles x 100
    steps: against its plain version, against its design of kernel 4
    (csrc/paths_variants.cu against heston_paths, csrc/heston_variants.cu
    against heston_paths_accurate; bit for bit, the log-only form within
    LOG_RTOL after exp), and a first_tile chunk. Returns the max |kernel -
    plain| of S per launch key."""
    import torch

    from options_model_tpu_torch.core.config import HestonParams
    from options_model_tpu_torch.models.heston import heston_constants
    from options_model_tpu_torch.ops import cuda_heston
    from options_model_tpu_torch.ops import cuda_heston_variants as hv

    hp = HestonParams(kappa=2.0, theta=0.04, xi=0.3, rho=-0.7, v0=0.04)
    seed, steps, tile = 0x9E3779B97F4A7C15, 100, cuda_heston.PATH_TILE
    log_s0 = float(heston_constants(100.0, 0.05, 1.0, hp, steps)["log_s0"])
    errs = {}
    for accurate in (False, True):
        k4_fn = cuda_heston.heston_paths_accurate if accurate else cuda_heston.heston_paths
        fn = hv.heston_variant_accurate if accurate else hv.heston_variant
        k4_name = "kernel 4's first design" if accurate else "kernel 4 (heston_paths)"
        k4 = k4_fn(seed, 100.0, 0.05, 1.0, hp, 64 * tile, steps, device=DEVICE)
        for e, lay, u in hv.VARIANTS:
            key = hv.launch_key(e, lay, u, accurate)
            errs[key] = max(check_variant(hv, e, lay, u, tile, n, steps, seed,
                                          accurate=accurate) for n in (2, 64))
            out = fn(seed, 100.0, 0.05, 1.0, hp, 64 * tile, steps, e, lay, u, tile,
                     device=DEVICE)
            flat = out.permute(1, 0, 2).reshape(steps + 1, -1) if lay == "blocked" else out
            ref = k4[-1] if lay == "terminal" else k4
            if e == "none":
                rel = float(((torch.exp(log_s0 + flat) - ref).abs() / ref).max())
                if not rel <= LOG_RTOL:
                    fail(f"variant {key}: exp(log S0 + out) differs from {k4_name} by "
                         f"{rel:.3e} relative (rtol {LOG_RTOL})")
                how = f"exp(log S0 + out) == {k4_name} within {rel:.2e} relative"
            elif torch.equal(flat, ref):
                how = f"== {k4_name} bit for bit"
            else:
                bad = int((flat != ref).sum())
                fail(f"variant {key} differs from {k4_name} in {bad} entries (max rel "
                     f"{float(((flat - ref).abs() / ref).max()):.3e})")
            part = fn(seed, 100.0, 0.05, 1.0, hp, 32 * tile, steps, e, lay, u, tile,
                      first_tile=32, device=DEVICE)
            tail = (out[:, 32 * tile:] if lay == "flat" else out[32:] if lay == "blocked"
                    else out[32 * tile:])
            if not torch.equal(tail, part):
                fail(f"variant {key}: a run at first_tile 32 differs from the full run's slice")
            log(f"[2] variant {key}: kernel == plain within rtol "
                f"{S_RTOL if accurate else EULER_S_RTOL} at 2 and 64 tiles x {steps} steps "
                f"(max abs {errs[key]:.3e}); {how}; first_tile=32 chunk bit-equal")
    return errs


def variant_bytes(exp_mode: str, layout: str, n_paths: int, steps: int,
                  transpose: bool = False) -> int:
    """Device-memory bytes a variant row moves: the matrix written once
    (per-step exp, log only), three times over for the bulk exp (x written,
    read back, S written), twice more for a read-back to the flat layout
    (read and write), or S_T alone (terminal only)."""
    if layout == "terminal":
        return n_paths * 4
    passes = (3 if exp_mode == "bulk" else 1) + (2 if transpose else 0)
    return passes * (steps + 1) * n_paths * 4


def phase_experiments(per_call: float) -> list:
    """The two kernel-4 experiments at their scripts' shapes, each driven
    with the variant counts at 0 and read after; the first design of the
    variants launched only by the experiments' first-design rows; every
    variant of them also held against its plain version at that shape, and
    the plain version timed; bounds at ``per_call`` integer instructions a
    Philox call and the bytes the function must move (its output written
    once), and beside them a bound at the bytes each row moves
    (variant_bytes).
    Returns one dict per experiment: rows, launches."""
    from options_model_tpu_torch.ops import cuda_heston_variants as hv
    from options_model_tpu_torch.scripts import exp_fullpath_layout, exp_paths_kernel
    from options_model_tpu_torch.utils.profiling import time_per_call

    out = []
    for number, mod in ((9, exp_paths_kernel), (10, exp_fullpath_layout)):
        for k in hv.launches:
            hv.launches[k] = 0
        rows = mod.run(mod.N_PATHS, mod.N_STEPS, log=lambda m, n=number: log(f"[3d] {n}: {m}"))
        launches = {k: n for k, n in hv.launches.items() if n}
        log(f"[4] variant launches during experiment {number}: {launches}")
        first_rows = {hv.launch_key(*row["variant"][:3], True) for row in rows
                      if row["accurate"]}
        stray = {k: n for k, n in launches.items() if "first design" in k and k not in first_rows}
        if stray:
            fail(f"experiment {number} reached the variants' first design outside its "
                 f"first-design rows: {stray}")
        for row in rows:
            e, lay, u, tile = row["variant"]
            if e is None:                  # kernel 4 itself, row A of experiment 9
                continue
            key = hv.launch_key(e, lay, u, row["accurate"])
            if not launches.get(key):
                fail(f"experiment {number}: variant {key} was never launched")
            n_paths, steps = mod.N_PATHS, mod.N_STEPS
            row["launches"] = launches[key]
            row["max_abs_err"] = check_variant(hv, e, lay, u, tile, n_paths // tile, steps,
                                               accurate=row["accurate"])

            def plain(row=row, e=e, lay=lay, u=u, tile=tile):
                out = hv.heston_variant_reference(1, 100.0, 0.05, 1.0, mod.HESTON, n_paths,
                                                  steps, e, lay, u, tile, device=DEVICE)
                return out.permute(1, 0, 2).contiguous() if row.get("transpose") else out

            row["plain_ms"] = time_per_call(plain)
            stored = lay != "terminal"
            ops = OPS_HESTON + (OPS_EXP if stored and e != "none" else 0)
            moved = variant_bytes(e, lay, n_paths, steps, row.get("transpose", False))
            n_int = int_ops(DRAWS_HESTON, per_call)
            once = (steps + 1 if stored else 1) * n_paths * 4
            row.update(bound(n_paths, steps, ops, n_int, once), bytes_moved=moved,
                       bound_ms_moved=bound(n_paths, steps, ops, n_int, moved)["bound_ms"])
            log(f"[5] experiment {number}, {row['label']}: {row['ms']:.4f} ms; bound "
                f"{row['bound_ms']:.4f} ms by {row['bound_term']} ({once / 1e6:.1f} MB out), "
                f"{row['bound_ms'] / row['ms'] * 100:.1f}% of it; at the bytes the row moves "
                f"({moved / 1e6:.1f} MB) {row['bound_ms_moved']:.4f} ms, "
                f"{row['bound_ms_moved'] / row['ms'] * 100:.1f}%; plain "
                f"{row['plain_ms']:.4f} ms")
        out.append(dict(number=number, rows=rows, launches=launches))
    return out


def phase_nn() -> dict:
    """The NN-LSM path through price_american (LSMConfig(regressor="nn") at
    its defaults but the epochs: 128 x 3, NN_EPOCHS epochs, batch 4096, lr
    1e-3, dropout 0.1, 3 policy iterations, optimal CV beta): the GBM put of the JAX bench's NN+CV
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
    lsm = LSMConfig(regressor="nn", nn_epochs=NN_EPOCHS)
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
        log(f"[3c] {model} NN+CV American put (2^18 x 50, 128 x 3 MLP, {NN_EPOCHS} epochs, 3 "
            f"policy iterations): {p:.6f} +- {se:.6f}; {oracle_name} {oracle:.6f}; rel "
            f"{rel * 100:+.4f}% ({(p - oracle) / se:+.2f} stderr; gate 4 stderr + "
            f"{bias * 100}% = {gate:.6f})"
            + (f"; the JAX estimator's bar {JAX_NN_BAR * 100:.4f}% (BENCH_r05)"
               if model == "gbm" else ""))
        log(f"[3c] {label} seconds: total {total:.3f}, simulate {sp['simulate']:.3f}, fit "
            f"{sp['fit']:.3f}, predict {sp['predict']:.3f}")
        if not abs(p - oracle) <= gate:
            fail(f"{label} outside its gate")
    return secs


def phase_main_path() -> tuple:
    """The main path through price_american. Returns seconds per price, and
    the European legs of kernels 3 and 1 by label (price, stderr)."""
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
                                 dtype=torch.float64, device="cpu"))
    gap = p_e - cos
    log(f"[3] Heston European put (2^22 x 100): {p_e:.6f} +- {se_e:.6f}; COS f64 "
        f"{cos:.6f}; gap {gap:+.6f} ({gap / cos * 100:+.4f}%, "
        f"{gap / se_e:+.2f} stderr; gate 4 stderr + {EURO_HESTON_BIAS * 100}%)")
    if abs(gap) > 4.0 * se_e + EURO_HESTON_BIAS * cos:
        fail("Heston European put outside its gate")
    spec_ec = OptionSpec(strike=100.0, rate=0.05, cp=CALL, sigma=0.2)
    p_c, se_c = priced("gbm_european", torch.Generator().manual_seed(13), 100.0, 1.0,
                       spec_ec, mc_e, euro, "gbm")
    bs = float(bs_price(100.0, 100.0, 1.0, 0.05, 0.2, 1.0, dtype=torch.float64,
                        device="cpu"))
    gap = p_c - bs
    log(f"[3] GBM European call (2^22 x 100): {p_c:.6f} +- {se_c:.6f}; BS {bs:.6f}; "
        f"gap {gap:+.6f} ({gap / se_c:+.2f} stderr; gate 4 stderr)")
    if abs(gap) > 4.0 * se_c:
        fail("GBM European call outside its gate")
    euro = {"heston_european": (p_e, se_e), "gbm_european": (p_c, se_c)}
    return {k: statistics.median(v) for k, v in secs.items()}, euro


def localvol_put():
    """The local-vol American put of phases 3b and 5: a constant 0.2 table
    (T 0.5, 50 rows), MCConfig 2^21 x 50, and price(S), the put's price and
    stderr on a path matrix S by Richardson with no control-variate leg
    (richardson_cv_stat, as the JAX grid pricer runs each task)."""
    import torch

    from options_model_tpu_torch.core.config import PUT, LSMConfig, MCConfig, OptionSpec
    from options_model_tpu_torch.core.stats import masked_mean_stderr
    from options_model_tpu_torch.pricers.american import _pair_block, richardson_cv_stat
    from options_model_tpu_torch.surface.cheb import compile_localvol_table

    table = compile_localvol_table(lambda S, tau: torch.full_like(S, 0.2), 100.0, 0.5, 50,
                                   100.0)
    mc = MCConfig(n_paths=1 << 21, n_steps=50, path_block=4096)
    pb = _pair_block(mc, "localvol")
    spec = OptionSpec(strike=100.0, rate=0.05, cp=PUT, sigma=None)

    def price(S) -> tuple:
        stat, mask = richardson_cv_stat(S, None, spec, 0.5, LSMConfig(richardson=True),
                                        model="localvol", pair_block=pb)
        return tuple(float(x) for x in masked_mean_stderr(stat, mask, pb)[:2])

    return table, mc, price


def phase_second_path() -> dict:
    """The QE-M and local-vol path: Heston QE American and European, local
    vol European and American, the 64x64 surface (Euler and QE), each
    surface one launch of the batched paths kernel. Returns seconds per
    price or per surface, per scheme the three ADI cells (strike index,
    maturity index, price, stderr, ADI), the European legs of kernels 5
    and 7 by label (price, stderr), and the local-vol American put (price,
    stderr)."""
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
    from options_model_tpu_torch.pricers.american import (price_american_richardson,
                                                          simulate_paths)
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
                                 dtype=torch.float64, device="cpu"))
    gap = p - cos
    log(f"[3b] QE European put (2^22 x 100): {p:.6f} +- {se:.6f}; COS f64 {cos:.6f}; gap "
        f"{gap:+.6f} ({gap / cos * 100:+.4f}%, {gap / se:+.2f} stderr; gate 4 stderr + "
        f"{EURO_QE_BIAS * 100}%)")
    if not abs(gap) <= 4.0 * se + EURO_QE_BIAS * cos:
        fail("QE European put outside its gate")
    euro = {"qe_european": (p, se)}

    # Local-vol European call on the bench smile: the terminal local-vol kernel.
    smile = compile_localvol_table(bench_smile, 100.0, 1.0, 100, 100.0, degree=7)
    spec_call = OptionSpec(strike=100.0, rate=0.05, cp=CALL, sigma=None)
    sampler = make_terminal_sampler("localvol", 100.0, 0.05, 1.0, localvol_table=smile,
                                    device=DEVICE)
    p, se, _ = timed("localvol_european", price_european_mc, gen(19), sampler, spec_call,
                     1.0, mc_e)
    log(f"[3b] local-vol European call on the bench smile (2^22 x 100, degree 7): "
        f"{float(p):.6f} +- {float(se):.6f}")
    euro["localvol_european"] = (float(p), float(se))
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
    euro["localvol_martingale"] = (m, m_se)
    flat = compile_localvol_table(lambda S, tau: torch.full_like(S, 0.2), 100.0, 1.0, 100,
                                  100.0)
    sampler = make_terminal_sampler("localvol", 100.0, 0.05, 1.0, localvol_table=flat,
                                    device=DEVICE)
    p, se, _ = price_european_mc(gen(29), sampler, spec_call, 1.0, mc_e)
    p, se = float(p), float(se)
    bs = float(bs_price(100.0, 100.0, 1.0, 0.05, 0.2, 1.0, dtype=torch.float64,
                        device="cpu"))
    log(f"[3b] local-vol European call, constant 0.2 table (2^22 x 100): {p:.6f} +- "
        f"{se:.6f}; BS {bs:.6f}; gap {(p - bs) / se:+.2f} stderr (gate 4)")
    if not abs(p - bs) <= 4.0 * se:
        fail("constant-sigma local-vol European call outside its gate")
    euro["localvol_constant"] = (p, se)

    # Local-vol American put: simulate_paths, then localvol_put's pricing.
    flat_h, mc_l, lv_price = localvol_put()
    p, se = timed("localvol_american", lambda: lv_price(simulate_paths(
        gen(31), 100.0, 0.5, mc_l, "localvol", rate=0.05, localvol_table=flat_h,
        device=DEVICE)))
    crr = crr_american(100.0, 100.0, 0.5, 0.05, 0.2, cp=-1.0, n_steps=4096)
    log(f"[3b] local-vol American put, constant 0.2 table (2^21 x 50, Richardson, no CV): "
        f"{p:.6f} +- {se:.6f}; CRR(4096) {crr:.6f}; gap {(p - crr) / se:+.2f} stderr "
        f"({(p / crr - 1.0) * 100:+.4f}%; gate 4 stderr)")
    if not abs(p - crr) <= 4.0 * se:
        fail("local-vol American put outside its gate")
    lv_put = (p, se)

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
    return {k: statistics.median(v) for k, v in secs.items()}, surface_cells, euro, lv_put


def phase_earlier_localvol_american(lv_put: tuple) -> None:
    """The local-vol American put of phase 3b (2^21 x 50, constant 0.2
    table, seed 31) with either design of kernel 8 on the same seed and
    tiles, in turns (first, new, new, first) x EURO_TURNS: each price
    against CRR within 4 stderr (the redesign's as phase 3b priced it), the
    redesign's here within SAME_DRAWS_GATE stderr of phase 3b's (the same
    draws), and the first design's within EARLIER_EURO_GATE stderr of phase
    3b's. Run outside the paths' counts."""
    import torch

    from options_model_tpu_torch.models.blocks import paths_rounded
    from options_model_tpu_torch.ops import cuda_localvol
    from options_model_tpu_torch.ops.philox import seed_from_generator
    from options_model_tpu_torch.pricers.binomial import crr_american

    flat_h, mc_l, lv_price = localvol_put()
    seed = seed_from_generator(torch.Generator().manual_seed(31))
    fns = {"first": cuda_localvol.localvol_paths_accurate, "new": cuda_localvol.localvol_paths}
    crr = crr_american(100.0, 100.0, 0.5, 0.05, 0.2, cp=-1.0, n_steps=4096)
    prices, t = {}, {"first": [], "new": []}
    for which in ("first", "new", "new", "first") * EURO_TURNS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prices[which] = lv_price(fns[which](seed, 100.0, 0.05, 0.5, flat_h,
                                            paths_rounded(mc_l), mc_l.n_steps,
                                            mc_l.antithetic, 0, DEVICE))
        t[which].append(time.perf_counter() - t0)
    secs = {k: statistics.median(v) for k, v in t.items()}
    (p0, se0), (p1, se1), (p, se) = prices["first"], prices["new"], lv_put
    log(f"[5] localvol_american: {p:.6f} +- {se:.6f} (phase 3b); redesign here {p1:.6f} "
        f"+- {se1:.6f}; first design of kernel 8 {p0:.6f} +- {se0:.6f}; difference "
        f"{p - p0:+.6f} ({(p - p0) / se:+.3f} stderr; gate {EARLIER_EURO_GATE}); against "
        f"CRR(4096) {crr:.6f}: redesign {(p - crr) / se:+.2f}, first design "
        f"{(p0 - crr) / se0:+.2f} stderr (gate 4); seconds per price in turns (first, new, "
        f"new, first) x {EURO_TURNS}, medians: first design {secs['first']:.6f}, redesign "
        f"{secs['new']:.6f}")
    if not abs(p1 - p) <= SAME_DRAWS_GATE * se:
        fail(f"localvol_american: the redesign's price on phase 3b's seed differs from phase "
             f"3b's by more than {SAME_DRAWS_GATE} stderr")
    if not abs(p - p0) <= EARLIER_EURO_GATE * se:
        fail(f"localvol_american: the redesign's price moved by more than {EARLIER_EURO_GATE} "
             "stderr from its first design's on the same draws")
    if not abs(p0 - crr) <= 4.0 * se0:
        fail("localvol_american: the first design's price is outside its CRR gate")


def phase_earlier_europeans(euro: dict) -> None:
    """The European legs of kernels 3, 1, 5, 7 and 15 with their first design:
    the same seeds and tiles through heston_terminal_accurate,
    gbm_terminal_accurate, heston_terminal_qe_accurate,
    localvol_terminal_accurate and merton_terminal_first, beside the prices
    of phases 3a, 3b and J2 (which launched the redesigns); fails if a leg
    moved by more than
    EARLIER_EURO_GATE of its stderr. Also each leg's seconds per price with
    either design, in turns. Run outside the paths' counts."""
    import dataclasses

    import torch

    from options_model_tpu_torch.core.config import (CALL, PUT, HestonParams, MCConfig,
                                                      MertonParams, OptionSpec)
    from options_model_tpu_torch.core.stats import masked_mean_stderr
    from options_model_tpu_torch.ops import cuda_gbm, cuda_heston, cuda_jumps, cuda_localvol
    from options_model_tpu_torch.ops.cuda_heston import TERMINAL_TILE
    from options_model_tpu_torch.ops.philox import seed_from_generator
    from options_model_tpu_torch.pricers.european import price_european_mc
    from options_model_tpu_torch.surface.cheb import compile_localvol_table

    hp = HestonParams(kappa=2.0, theta=0.04, xi=0.3, rho=-0.7, v0=0.04)
    mc_e = MCConfig(n_paths=1 << 22, n_steps=100, path_block=4096)

    def sampler(fn, *model):
        def run(seed, first_tile, c):
            return fn(seed, 100.0, 0.05, *model, c.n_paths, c.n_steps, c.antithetic,
                      first_tile, DEVICE)
        run.pair_block, run.device = TERMINAL_TILE, torch.device(DEVICE)
        return run

    def gen(seed):
        return torch.Generator().manual_seed(seed)

    smile_t = compile_localvol_table(bench_smile, 100.0, 1.0, 100, 100.0, degree=7)
    flat_t = compile_localvol_table(lambda S, tau: torch.full_like(S, 0.2), 100.0, 1.0, 100,
                                    100.0)
    put = OptionSpec(strike=100.0, rate=0.05, cp=PUT, sigma=None)
    call = OptionSpec(strike=100.0, rate=0.05, cp=CALL, sigma=None)
    H, G, LV = cuda_heston, cuda_gbm, cuda_localvol
    # (label, seed, option, first design, redesign, model arguments, T)
    legs = (("heston_european", 11, put, H.heston_terminal_accurate, H.heston_terminal,
             (1.0, hp), 1.0),
            ("gbm_european", 13, call, G.gbm_terminal_accurate, G.gbm_terminal, (0.2, 1.0), 1.0),
            ("qe_european", 17, put, H.heston_terminal_qe_accurate, H.heston_terminal_qe,
             (1.0, hp), 1.0),
            ("localvol_european", 19, call, LV.localvol_terminal_accurate, LV.localvol_terminal,
             (1.0, smile_t), 1.0),
            ("localvol_constant", 29, call, LV.localvol_terminal_accurate, LV.localvol_terminal,
             (1.0, flat_t), 1.0),
            # J2's leg and its first seed
            ("merton_european", 31, put, cuda_jumps.merton_terminal_first,
             cuda_jumps.merton_terminal, (0.5, MertonParams(**MERTON_BENCH)), 0.5))
    first, secs = {}, {}
    for label, seed, spec, old, new, model, T in legs:
        samplers = {"first": sampler(old, *model), "new": sampler(new, *model)}
        t = {"first": [], "new": []}
        for which in ("first", "new", "new", "first") * EURO_TURNS:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p, se, _ = price_european_mc(gen(seed), samplers[which], spec, T, mc_e)
            p, se = float(p), float(se)
            t[which].append(time.perf_counter() - t0)
            if which == "first":
                first[label] = (p, se)
        secs[label] = {k: statistics.median(v) for k, v in t.items()}
    smile = sampler(LV.localvol_terminal_accurate, 1.0, smile_t)
    n_tiles = (1 << 22) // TERMINAL_TILE
    S_T = smile(seed_from_generator(gen(23)), 0,
                dataclasses.replace(mc_e, n_paths=n_tiles * TERMINAL_TILE))
    first["localvol_martingale"] = masked_mean_stderr(S_T.double() * math.exp(-0.05), None,
                                                      TERMINAL_TILE)
    for label, (p, se) in euro.items():
        p0, se0 = float(first[label][0]), float(first[label][1])
        log(f"[5] {label}: {p:.6f} +- {se:.6f}; first design of its terminal kernel "
            f"{p0:.6f} +- {se0:.6f}; difference {p - p0:+.6f} ({(p - p0) / se:+.3f} stderr; "
            f"gate {EARLIER_EURO_GATE})"
            + (f"; seconds per price in turns (first, new, new, first) x {EURO_TURNS}, "
               f"medians: first design {secs[label]['first']:.6f}, redesign "
               f"{secs[label]['new']:.6f}" if label in secs else ""))
        if not abs(p - p0) <= EARLIER_EURO_GATE * se:
            fail(f"{label}: the redesign's price moved by more than {EARLIER_EURO_GATE} stderr "
                 "from its first design's on the same draws")


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


def surface_shape(k: dict, bound_ms: float) -> dict:
    """Kernel 4 or 6 (spec ``k``) at the 64 x 16,384 x 50 surface shape with
    v: one batched launch, 64 single launches of either design, and the
    batched launch's host time for its constants."""
    import numpy as np

    from options_model_tpu_torch.core.config import HestonParams
    from options_model_tpu_torch.ops import cuda_heston
    from options_model_tpu_torch.utils.profiling import time_per_call

    hp = HestonParams(kappa=2.0, theta=0.04, xi=0.3, rho=-0.7, v0=0.04)
    seed = 0x9E3779B97F4A7C15
    Ts = np.linspace(0.1, 1.0, SURFACE_MATS).astype(np.float32).tolist()
    n_surface_tiles = SURFACE_PATHS // cuda_heston.PATH_TILE
    scheme = k["scheme"]
    single, single0 = ((cuda_heston.heston_paths_qe, cuda_heston.heston_paths_qe_accurate)
                       if scheme == "qe" else
                       (cuda_heston.heston_paths, cuda_heston.heston_paths_accurate))

    def batched():
        return cuda_heston.heston_paths_batched(seed, 100.0, 0.05, Ts, hp, SURFACE_PATHS,
                                                SURFACE_STEPS, True, True, 0, DEVICE, scheme)

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
    log(f"[5] {k['name']} at the surface shape {SURFACE_MATS} x {SURFACE_PATHS} x "
        f"{SURFACE_STEPS} with v: one batched launch {surface['surface_batched_ms']:.4f} "
        f"ms ({bound_ms / surface['surface_batched_ms'] * 100:.1f}% of the same "
        f"bound); {SURFACE_MATS} single launches {surface['surface_single_ms']:.4f} ms "
        f"(redesign), {surface['earlier_surface_single_ms']:.4f} ms (first design); "
        f"the batched launch's host time for its constants "
        f"{surface['surface_consts_host_ms']:.4f} ms (within its time)")
    return surface


def phase_timing(specs, per_call: float) -> dict:
    """CUDA-event medians of each kernel and its plain version: 2^22 x 100
    for the terminal kernels, 2^20 x 50 (with v where there is one) for the
    paths kernels; and each one's bound at that shape. Kernels 1 and 3-8
    also: their first design at the same shape, timed in turns with the redesign
    (earlier, new, new, earlier; each the mean of its two medians), and
    registers and occupancy. Kernels 4 and 6 also: the surface shape
    (surface_shape). Kernels 7 and 8 also: their other tables (LV_DEGREES),
    in turns with each other (each the mean of its two medians), each with
    its own bound. Bounds at ``per_call`` integer instructions a
    Philox call."""
    from options_model_tpu_torch.ops import cuda_heston, cuda_localvol
    from options_model_tpu_torch.utils.profiling import time_per_call

    attrs = dict(cuda_heston.paths_kernel_attrs(), **cuda_heston.terminal_kernel_attrs(),
                 **cuda_localvol.paths_kernel_attrs())
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
        matrix_bytes = ((steps + 1) * (2 if variance else 1) if paths else 1) * n * 4
        out_bytes = matrix_bytes
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
            row["earlier_ms"] = earlier_ms
            log(f"[5] {k['name']} first design ({k['earlier']['source']}) at {n} x {steps}"
                f"{' with v' if variance else ''}: {earlier_ms:.4f} ms, "
                f"{b['bound_ms'] / earlier_ms * 100:.1f}% of bound; redesign {ms:.4f} ms "
                f"({t[1]:.4f}, {t[2]:.4f}; first design {t[0]:.4f}, {t[3]:.4f}; "
                f"{ms / earlier_ms:.3f}x)")
            new_a, old_a = attrs[k["name"]], attrs.get(k["earlier"]["name"])
            row.update(registers=new_a["registers"], spill_bytes=new_a["spill_bytes"],
                       block=new_a["block"],
                       occupancy=new_a["blocks_per_sm"] * new_a["block"] / THREADS_PER_SM)
            txt = (f"[5] {k['name']} registers and occupancy: redesign {new_a['registers']} "
                   f"registers, {new_a['spill_bytes']} spill bytes, {new_a['blocks_per_sm']} "
                   f"blocks of {new_a['block']} per SM ({row['occupancy'] * 100:.1f}% "
                   "occupancy)")
            if old_a is not None:
                row.update(earlier_registers=old_a["registers"],
                           earlier_spill_bytes=old_a["spill_bytes"],
                           earlier_occupancy=old_a["blocks_per_sm"] * old_a["block"]
                           / THREADS_PER_SM)
                txt += (f"; first design {old_a['registers']} registers, "
                        f"{old_a['spill_bytes']} spill bytes, {old_a['blocks_per_sm']} blocks "
                        f"of {old_a['block']} ({row['earlier_occupancy'] * 100:.1f}%)")
            log(txt)
        if "scheme" in k:
            row.update(surface_shape(k, b["bound_ms"]))
        others = [c for c in k.get("checks") or [] if c[2].degree != k["table"].degree]
        turns: dict = {}
        for label, run, _ in others + others[::-1]:     # in turns: d3, d17, d17, d3
            turns.setdefault(label, []).append(time_per_call(
                lambda run=run: run(False, n_tiles, 0, steps, variance), N_TIMED))
        for label, _, table in others:
            ms_d = sum(turns[label]) / 2
            ops_d = ops_lv(table.degree) + k["ops"] - ops_lv(k["table"].degree)
            b_d = bound(n, steps, ops_d, n_int, matrix_bytes + table.coeffs.numel() * 4)
            row.setdefault("degrees", {})[table.degree] = dict(ms=ms_d, turns=turns[label],
                                                               **b_d)
            log(f"[5] {k['name']} at {label}: {ms_d:.4f} ms (in turns "
                + ", ".join(f"{x:.4f}" for x in turns[label])
                + f"); bound {b_d['bound_ms']:.4f} ms by {b_d['bound_term']} ({ops_d:.2f} f32 "
                f"operations per path-step); {b_d['bound_ms'] / ms_d * 100:.1f}% of bound")
        out[k["name"]] = row
    return out


def experiment_entry(exp: dict, headline: str, earlier: str, replaces: str,
                     var_errs: dict) -> dict:
    """The kernels-line entry of kernel 9 or 10: the headline variant's
    numbers (bound_ms at its output written once, bound_ms_moved at the
    bytes it moves), beside them its first design's row ``earlier``, the
    experiment's launches, and every variant under it."""
    src = "options_model_tpu_torch/csrc/"
    variants = []
    for row in exp["rows"]:
        if row["variant"][0] is None:
            continue
        e, lay, u, tile = row["variant"]
        key = f"{e}/{lay}/{u}"
        full_key = key + (" (first design)" if row["accurate"] else "")
        variants.append(dict(
            name=row["label"], variant=key, tile=tile, route="cuda",
            source=src + ("heston_variants.cu" if row["accurate"] else "paths_variants.cu"),
            replaces=replaces, launches=row["launches"],
            max_abs_err=max(row["max_abs_err"], var_errs.get(full_key, 0.0)),
            ms=row["ms"], plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], bound_term=row["bound_term"],
            bound_ms_f32_bytes=row["bound_ms_f32_bytes"], bytes_moved=row["bytes_moved"],
            bound_ms_moved=row["bound_ms_moved"], library_ms=None))
    head = next(v for v in variants if v["name"] == headline)
    first = next(v for v in variants if v["name"] == earlier)
    script = "exp_paths_kernel" if exp["number"] == 9 else "exp_fullpath_layout"
    return dict(name=f"heston_variant ({script})",
                route="cuda", source=head["source"], replaces=replaces,
                launches=sum(exp["launches"].values()),
                max_abs_err=max(v["max_abs_err"] for v in variants), ms=head["ms"],
                plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
                bound_by=head["bound_by"], bound_term=head["bound_term"],
                bound_ms_f32_bytes=head["bound_ms_f32_bytes"], bytes_moved=head["bytes_moved"],
                bound_ms_moved=head["bound_ms_moved"], library_ms=None,
                headline=headline, earlier_name=earlier, earlier_source=first["source"],
                earlier_ms=first["ms"], variants=variants)


# The VJP kernels of csrc/greeks.cu, the backward of kernels 1, 2 and 4 on
# the Greeks path.
# Kernel vs plain: |kernel - plain| within VJP_RTOL of the sum over paths of
# each path's absolute share (the plain version's per_path form): the
# kernel sums in float32 by thread and float64 by block, the plain version
# by path in float64, and the kernel's states come from its own SFU
# Box-Muller and ex2 (or, for the terminal VJP, W from S_T), ~1e-6 apart.
VJP_RTOL = 1e-4
VJP_SHAPE = (1 << 14, 50)
# The same comparison at the shapes the Greeks path gives each VJP kernel
# (G1, G2, G3 of phase_greeks): there the terminal VJP runs its grid-stride
# loop (above kTerminalBlocks x 256 = 2^18 paths), which VJP_SHAPE does not
# reach, and every kernel its path's grid and row sums.
VJP_GREEKS_SHAPE = {"gbm_terminal_vjp": (1 << 22, 100), "gbm_paths_vjp": (1 << 21, 50),
                    "euler_paths_vjp": (1 << 20, 50)}
# Step counts at which the redesigned Euler VJP kernel runs each tail of its
# four-step loop (50 ends in a tail of 2).
VJP_TAILS = (49, 51, 52)
# Step counts at which the redesigned GBM paths VJP kernel runs its passes of
# eight steps: fewer than one pass, one pass and no tail, 49 (a tail of 1),
# 55 (7), 56 (none; 50 ends in a tail of 2).
GBM_VJP_TAILS = (3, 8, 49, 55, 56)
# The redesigned GBM paths VJP's totals (A, B, C summed over its rows)
# against its first design's: the same normals and recursion; the weight
# s0 2^(a log2 e) (ex2.approx, ~2 ulps) against s0 expf(a), and float32
# sums in another order, ~1e-7 a path and unbiased but for ex2's own.
VJP_FIRST_RTOL = 1e-6
# Directional check: each component against (<g, F(theta + h)> - <g,
# F(theta - h)>) / 2h of the forward kernel on the same seed, inner
# products in float64, h = 1e-3 |theta| (the step the float32 parameter
# really takes). The tolerance is FD_RTOL |fd| plus the float32 rounding of
# the two forward runs: FD_NOISE roundings of every output as a standard
# deviation (2^-23 relative each, the ulp of S and v), and one rounding of
# all of them at once (2^-23 of sum |g out|): the recursion's additions of
# a small constant (drift, r dt) round alike on every path, and that bias
# moves with theta (measured: 0.3 ulp coherent between sigma +- h at 50
# steps, which a constant cotangent, whose sigma component cancels, turns
# into a 57% error of the quotient).
# Heston is looser: a path can cross the v = 0 clamp between theta +- h,
# and near it 0.5/sqrt(v) makes the secant over 2h differ from the
# tangent, so the shares of the paths whose v comes below V_KINK are
# added to the tolerance (they are printed).
FD_RTOL_GBM = 1e-3
FD_RTOL_HESTON = 2e-3
FD_NOISE = 4.0
V_KINK = 1e-4
# f32 operations per path-step of the VJP kernels, counted from
# csrc/greeks.cu (each add, multiply, compare, select and min/max one
# operation, an FMA two, a transcendental one):
#   euler_paths_vjp, per path: vp, sqrt, v > 0, the _safe_sqrt factor (4)
#   7; euler_step 12; v' > 0, theta - vp, sv w2 3; the direct terms of
#   T, kappa, xi, rho 11; dls_T 6; xi_sdt w2, sqrt_dt z1 2; per carried
#   tangent 11 (6 of them, + 1 for T's dls) 67; the row: ex2 and its FMA,
#   g S, the S and S t sums, 6 tangents x 2 FMAs (ls and v) 31; the
#   Box-Muller's 11 per two normals at one pair a pair-step, w2 and the
#   mirror's negations.
OPS_EULER_VJP = 7 + 12 + 3 + 11 + 6 + 2 + 67 + 31 + 11 / 2 + 1
#   gbm_paths_vjp: the draw as kernel 2 (11 per two normals, one normal a
#   slot-step), the recursion 3, expf and * s0 2, g S 1, the sums 6, W 1/2.
OPS_GBM_VJP = 11 / 4 + 3 + 2 + 1 + 6 + 1 / 2
#   gbm_terminal_vjp, per path: S / s0, log2, - a, / b, g S, two sums.
OPS_GBM_TERMINAL_VJP = 8


def vjp_specs():
    """The VJP kernels as specs: name, the forward kernel's spec name, the
    replaced JAX gradient, launch counter, paths that run them, the timed
    shape, f32 operations and Philox draws per path-step, bytes read per
    path-step."""
    from options_model_tpu_torch.ops import cuda_gbm, cuda_heston

    src = "options_model_tpu_torch/csrc/greeks.cu"
    jax_gbm = ("options_model_tpu/pricers/greeks.py:49 _greeks_impl, through "
               "options_model_tpu/models/gbm.py:35 simulate_gbm")
    return [
        dict(name="gbm_terminal_vjp", forward="gbm_terminal", source=src,
             replaces=jax_gbm + " (return_paths=False)", paths=("greeks",),
             counter=(cuda_gbm.launches, "gbm_terminal_vjp"), timed=(1 << 22, 100),
             ops=OPS_GBM_TERMINAL_VJP, draws=(0, 0), bytes=8),
        dict(name="gbm_paths_vjp", forward="gbm_paths", source=src, replaces=jax_gbm,
             paths=("greeks",), counter=(cuda_gbm.launches, "gbm_paths_vjp"),
             timed=(1 << 20, 50), ops=OPS_GBM_VJP, draws=DRAWS_GBM, bytes=4),
        dict(name="euler_paths_vjp", forward="heston_paths", source=src,
             replaces="options_model_tpu/pricers/greeks.py:83 _heston_greeks_impl, through "
                      "options_model_tpu/models/heston.py:63 simulate_heston",
             paths=("greeks",), counter=(cuda_heston.launches, "euler_paths_vjp"),
             timed=(1 << 20, 50), ops=OPS_EULER_VJP, draws=DRAWS_HESTON, bytes=8),
    ]


VJP_PARAMS = {"gbm_terminal_vjp": ("S0", "r", "sigma", "T"),
              "gbm_paths_vjp": ("S0", "r", "sigma", "T"),
              "euler_paths_vjp": ("S0", "r", "T", "kappa", "theta", "xi", "rho", "v0")}


def vjp_case(name: str, n_paths: int, n_steps: int, anti: bool, with_v: bool = True,
             seed: int = 0x5DEECE66D):
    """One VJP kernel at (n_paths, n_steps): its forward F(params) -> outputs
    on the card, numpy-seeded positive cotangents g, and vjp(g) of the kernel
    and of the plain version, with the plain version's per-path shares."""
    import numpy as np
    import torch

    from options_model_tpu_torch.core.config import HestonParams
    from options_model_tpu_torch.models.gbm import gbm_euler_vjp_from_normals
    from options_model_tpu_torch.models.heston import heston_euler_vjp_from_normals
    from options_model_tpu_torch.ops import cuda_gbm, cuda_heston
    from options_model_tpu_torch.ops.philox import path_normals

    rng = np.random.default_rng(n_paths + n_steps + anti)

    def cot(out, ref, scale=1.0):
        """u + 4 (out / ref - 1), u uniform on [0.5, 1.5], times scale / n: a
        cotangent that weighs the paths by where they went, so that no
        component of the gradient cancels to the float32 rounding of the
        forward (with a constant one the sigma component does: E S_t does
        not move with sigma)."""
        u = torch.from_numpy(rng.uniform(0.5, 1.5, tuple(out.shape)).astype(np.float32))
        return (u.to(DEVICE) + 4.0 * (out / ref - 1.0)) * (scale / out.shape[-1])

    if name == "euler_paths_vjp":
        params = [100.0, 0.05, 0.5, 2.0, 0.04, 0.3, -0.7, 0.04]

        def F(p):
            return cuda_heston.heston_paths(seed, p[0], p[1], p[2], HestonParams(*p[3:]),
                                            n_paths, n_steps, anti, True, 0, DEVICE)

        S, v = F(params)
        g = (cot(S, params[0]), cot(v, params[4], 100.0) if with_v else None)
        kernel = cuda_heston.euler_paths_vjp(*g, seed, *params[:3], HestonParams(*params[3:]),
                                             n_paths, n_steps, anti)
        first = cuda_heston.euler_paths_vjp_first(*g, seed, *params[:3],
                                                  HestonParams(*params[3:]), n_paths, n_steps,
                                                  anti)
        z1, z2 = cuda_heston._normals(seed, S.shape[1] // cuda_heston.PATH_TILE,
                                      cuda_heston.PATH_TILE, n_steps, anti, 0, DEVICE)
        shares = heston_euler_vjp_from_normals(z1, z2, *g, *params[:3],
                                               HestonParams(*params[3:]), per_path=True)
        plain = cuda_heston.euler_paths_vjp_reference(*g, seed, *params[:3],
                                                      HestonParams(*params[3:]), n_paths,
                                                      n_steps, anti)
        g = tuple(x for x in g if x is not None)
        F_out = (lambda p: F(p)) if with_v else (lambda p: F(p)[:1])
        return dict(params=params, F=F_out, g=g, kernel=kernel, plain=plain, shares=shares,
                    near=v.min(0).values < V_KINK, first=first)
    paths = name == "gbm_paths_vjp"
    params = [100.0, 0.05, 0.2, 0.5 if paths else 1.0]
    fwd = cuda_gbm.gbm_paths if paths else cuda_gbm.gbm_terminal

    def F(p):
        return (fwd(seed, *p, n_paths, n_steps, anti, 0, DEVICE),)

    (out,) = F(params)
    g = cot(out, params[0])
    tile = cuda_heston.PATH_TILE if paths else cuda_heston.TERMINAL_TILE
    z = path_normals(seed, 0, out.shape[-1] // tile, tile, n_steps, anti, DEVICE)
    shares = gbm_euler_vjp_from_normals(z, g, *params, return_paths=paths, per_path=True)
    if paths:
        kernel = cuda_gbm.gbm_paths_vjp(g, seed, *params, n_paths, n_steps, anti)
        plain = cuda_gbm.gbm_paths_vjp_reference(g, seed, *params, n_paths, n_steps, anti)
        first = cuda_gbm.gbm_paths_vjp_first(g, seed, *params, n_paths, n_steps, anti)
        totals = [rows(g, seed, *params, n_paths, n_steps, anti).sum(0)
                  for rows in (cuda_gbm.gbm_paths_vjp_rows, cuda_gbm.gbm_paths_vjp_rows_first)]
        return dict(params=params, F=F, g=(g,), kernel=kernel, plain=plain, shares=shares,
                    first=first, totals=totals)
    kernel = cuda_gbm.gbm_terminal_vjp(g, out, seed, *params, n_paths, n_steps, anti)
    plain = cuda_gbm.gbm_terminal_vjp_reference(g, seed, *params, n_paths, n_steps, anti)
    return dict(params=params, F=F, g=(g,), kernel=kernel, plain=plain, shares=shares)


def directional(case: dict, idx: int, rtol: float) -> tuple:
    """(fd, tolerance, kink) of component idx: the central difference of
    <g, F> in float64 over the step the float32 parameter takes; FD_RTOL
    |fd| plus FD_NOISE float32 roundings of every output of both runs plus
    ``kink``, the absolute shares of the paths that come near v = 0."""
    import numpy as np

    p = case["params"]
    up, dn = list(p), list(p)
    up[idx] = float(np.float32(p[idx] * (1 + 1e-3)))
    dn[idx] = float(np.float32(p[idx] * (1 - 1e-3)))

    def dot(q):
        return [float((g.double() * o.double()).sum()) for g, o in zip(case["g"], case["F"](q))]

    du, dd = dot(up), dot(dn)
    h2 = up[idx] - dn[idx]
    fd = (sum(du) - sum(dd)) / h2
    terms = [(g.double() * o.double()) for g, o in zip(case["g"], case["F"](p))]
    rms = math.sqrt(sum(float((t * t).sum()) for t in terms))
    coherent = sum(float(t.abs().sum()) for t in terms)
    noise = (FD_NOISE * math.sqrt(2.0) * rms + coherent) * 2.0**-23 / abs(h2)
    near = case.get("near")
    kink = 0.0 if near is None else float(case["shares"][idx][near].abs().sum())
    return fd, rtol * abs(fd) + noise + kink, kink


def vjp_rows_checks() -> None:
    """The redesigned Euler and GBM paths VJP kernels' rows at 64 tiles x 50
    steps, with and without antithetics (Euler also with and without a
    cotangent on v): a second launch equals the first bit for bit (no float
    atomics), and a launch over tiles 32..63 at first_tile 32 equals rows 32
    x 16.. of the 64-tile launch bit for bit (no block straddles a tile)."""
    import numpy as np
    import torch

    from options_model_tpu_torch.core.config import HestonParams
    from options_model_tpu_torch.ops import cuda_gbm
    from options_model_tpu_torch.ops import cuda_heston as ch

    hp = HestonParams(kappa=2.0, theta=0.04, xi=0.3, rho=-0.7, v0=0.04)
    n, steps, seed = 64 * ch.PATH_TILE, 50, 0x5DEECE66D
    rng = np.random.default_rng(11)
    g = [torch.from_numpy(rng.uniform(0.5, 1.5, (steps + 1, n)).astype(np.float32)).to(DEVICE)
         / n for _ in range(2)]
    half = 32 * ch.PATH_TILE
    cases = [("euler_paths_vjp", anti, with_v, ch.euler_vjp_blocks)
             for anti, with_v in itertools.product((True, False), (True, False))]
    cases += [("gbm_paths_vjp", anti, False, cuda_gbm.gbm_vjp_blocks) for anti in (True, False)]
    for name, anti, with_v, blocks in cases:
        gv = g[1] if with_v else None

        def rows(first_tile=0):
            cols = slice(half, None) if first_tile else slice(None)
            gs = g[0][:, cols].contiguous()
            if name == "gbm_paths_vjp":
                return cuda_gbm.gbm_paths_vjp_rows(gs, seed, 100.0, 0.05, 0.2, 0.5,
                                                   n - first_tile * ch.PATH_TILE, steps, anti,
                                                   first_tile)
            return ch.euler_paths_vjp_rows(gs, None if gv is None else gv[:, cols].contiguous(),
                                           seed, 100.0, 0.05, 0.5, hp, n - first_tile *
                                           ch.PATH_TILE, steps, anti, first_tile)

        full, again, part = rows(), rows(), rows(32)
        torch.cuda.synchronize()
        if full.shape[0] != blocks(64) or not torch.equal(full, again):
            fail(f"{name} (antithetic {anti}, v {with_v}): {full.shape[0]} rows, or a second "
                 "launch differs from the first")
        if not torch.equal(full[32 * blocks(1):], part):
            fail(f"{name} (antithetic {anti}, v {with_v}): a launch at first_tile 32 differs "
                 "from the matching rows of the full launch")
    log("[2v] euler_paths_vjp and gbm_paths_vjp (the redesigns) at 64 tiles x 50 steps, with "
        "and without antithetics (Euler with and without a cotangent on v): two launches bit "
        "for bit the same; a first_tile=32 launch equals the full launch's rows 512.. bit for "
        "bit")


def phase_vjp() -> dict:
    """Each VJP kernel against its plain version on the card at VJP_SHAPE
    and at VJP_GREEKS_SHAPE, with and without antithetics (the Euler kernel
    also without a cotangent on v at VJP_SHAPE: its kV = false instance, and
    at VJP_TAILS steps), within VJP_RTOL of the paths' absolute shares, the
    first designs of the Euler and GBM paths kernels too (and GBM_VJP_TAILS
    steps; its totals within VJP_FIRST_RTOL of its first design's); then, at
    VJP_SHAPE, each component against the directional difference of its own
    forward kernel on the same seed (antithetic); and vjp_rows_checks. Returns per
    kernel the max |kernel - plain|, that over the scale, and the worst
    |vjp - fd| over its tolerance."""
    import torch

    vjp_rows_checks()
    out = {}
    for name, params in VJP_PARAMS.items():
        row = dict(max_abs_err=0.0, max_scaled_err=0.0, fd_worst=0.0)
        variants = [(VJP_SHAPE, True, True), (VJP_SHAPE, False, True)]
        tails = {"euler_paths_vjp": VJP_TAILS, "gbm_paths_vjp": GBM_VJP_TAILS}.get(name, ())
        variants += [((VJP_SHAPE[0], steps), anti, True)
                     for steps, anti in itertools.product(tails, (True, False))]
        if name == "euler_paths_vjp":
            variants.append((VJP_SHAPE, True, False))
        if name in ("euler_paths_vjp", "gbm_paths_vjp"):
            row["first_max_scaled_err"] = 0.0
        if name == "gbm_paths_vjp":
            row["first_total_rel"] = 0.0
        variants += [(VJP_GREEKS_SHAPE[name], anti, True) for anti in (True, False)]
        for (n, steps), anti, with_v in variants:
            c = vjp_case(name, n, steps, anti, with_v)
            torch.cuda.synchronize()
            k, p = c["kernel"].cpu(), c["plain"].cpu()
            scale = c["shares"].abs().sum(1).cpu()
            if not bool(torch.isfinite(k).all()):
                fail(f"{name}: non-finite gradient {k.tolist()}")
            if "first" in c:
                first_err = float(((c["first"].cpu() - p).abs() / scale).max())
                row["first_max_scaled_err"] = max(row["first_max_scaled_err"], first_err)
                if not first_err <= VJP_RTOL:
                    fail(f"{name}'s first design differs from the plain version by {first_err} "
                         "of the paths' absolute shares")
            if "totals" in c:
                new_t, first_t = (t.cpu() for t in c["totals"])
                total_rel = float(((new_t - first_t).abs() / first_t.abs()).max())
                row["first_total_rel"] = max(row["first_total_rel"], total_rel)
                if not total_rel <= VJP_FIRST_RTOL:
                    fail(f"{name}'s totals (A, B, C) {new_t.tolist()} differ from its first "
                         f"design's {first_t.tolist()} by {total_rel:.3e} relative "
                         f"(rtol {VJP_FIRST_RTOL})")
            err = (k - p).abs()
            row["max_abs_err"] = max(row["max_abs_err"], float(err.max()))
            row["max_scaled_err"] = max(row["max_scaled_err"], float((err / scale).max()))
            if (n, steps) == VJP_GREEKS_SHAPE[name]:
                row["greeks_shape_scaled_err"] = max(row.get("greeks_shape_scaled_err", 0.0),
                                                     float((err / scale).max()))
            log(f"[2v] {name} {n} x {steps}, antithetic={anti}"
                + ("" if with_v else ", no cotangent on v") + ": kernel "
                + ", ".join(f"{q} {x:.6e}" for q, x in zip(params, k.tolist()))
                + f"; max |kernel - plain| / sum of |path shares| "
                f"{float((err / scale).max()):.2e} (rtol {VJP_RTOL})"
                + (f"; first design {first_err:.2e}" if "first" in c else "")
                + (f"; totals (A, B, C) vs the first design's {total_rel:.2e} relative (rtol "
                   f"{VJP_FIRST_RTOL})" if "totals" in c else ""))
            if not bool((err <= VJP_RTOL * scale).all()):
                fail(f"{name} differs from its plain version beyond {VJP_RTOL} of the "
                     f"paths' absolute shares: kernel {k.tolist()}, plain {p.tolist()}")
            if (n, steps) != VJP_SHAPE or not anti or not with_v:
                continue
            rtol = FD_RTOL_HESTON if name == "euler_paths_vjp" else FD_RTOL_GBM
            txt = []
            for i, q in enumerate(params):
                fd, tol, kink = directional(c, i, rtol)
                ratio = abs(float(k[i]) - fd) / tol
                row["fd_worst"] = max(row["fd_worst"], ratio)
                txt.append(f"{q} {float(k[i]):.6e} vs {fd:.6e} ({ratio:.2f} of tol"
                           + (f", {kink / tol * 100:.0f}% of it near v = 0)" if "near" in c
                              else ")"))
                if ratio > 1.0:
                    fail(f"{name}: d/d{q} {float(k[i])} against the forward kernel's "
                         f"central difference {fd} beyond {tol}")
            log(f"[2v] {name} against the central differences of its forward kernel "
                f"(h = 1e-3 |theta|, rtol {rtol} + {FD_NOISE} float32 roundings"
                + (f" + the shares of the {int(c['near'].sum())} paths with v below "
                   f"{V_KINK}" if "near" in c else "") + "): " + "; ".join(txt))
        out[name] = row
    return out


# The Greeks path's gates. G1: the JAX test's tolerances at 2^16 paths
# (tests/test_mc_greeks.py:17-35) scaled by sqrt(2^16 / 2^22) = 1/8.
G1_GATES = {"Delta": 0.01 / 8, "Vega": 0.01 / 8, "Rho": 0.01 / 8, "Theta": 0.003 / 8,
            "Gamma": 0.005 / 8}
# G2, G3: the AD Delta within 0.02 of the common-random-number central
# difference of the port's own price at h = 0.5 (tests/test_mc_greeks.py:
# 39-47), not scaled: AD holds the exercise decisions fixed and a bump does
# not, so the gap need not shrink with the path count.
BUMP_GATE, BUMP_H = 0.02, 0.5
# G4: cos_greeks_heston in float64 against float64 central differences of
# the COS price (h = 1e-4 |theta|; 1e-3 S0 for Gamma's second difference,
# rtol 1e-5): truncation ~1e-8 relative (Gamma ~2e-6), cancellation ~1e-12.
COS_RTOL, COS_ATOL = 1e-6, 1e-9
# G5: bs_greeks (float32 autograd) against the closed form on a 64 x 64
# (K, T) grid, rtol 1e-4 with a floor of 1e-5 of the Greek's largest
# magnitude (deep out-of-the-money Deltas near 0); implied_vol (float64)
# round trip within 1e-4 where vega > 1e-3, and its gradient (price, S)
# against the implicit formula (1 / vega, -delta / vega) at rtol 1e-6.
BS_RTOL, IV_ATOL, IV_GRAD_RTOL = 1e-4, 1e-4, 1e-6
GREEKS_SEEDS = 4


def _greeks_text(g: dict, keys) -> str:
    return ", ".join(f"{k} {float(g[k]):+.6f}" for k in keys)


def phase_greeks() -> tuple:
    """The Greeks path (BASELINE configs[1], "MC error + Greeks via AD"):
    G1 GBM European call Greeks at 2^22 x 100 against the closed form; G2
    GBM American put at 2^21 x 50 (degree 3) against common-random-number
    bumps and CRR(4096); G3 Heston American put at 2^20 x 50 with every
    parameter gradient beside its bump; G4 cos_greeks_heston against
    central differences; G5 bs_greeks and implied_vol on a 64 x 64 grid.
    Returns (seconds per Greeks call of G1-G3, the launches of one call of
    each, the numbers for PERF.md)."""
    import numpy as np
    import torch

    from options_model_tpu_torch.calibration.charfn import heston_cos_price
    from options_model_tpu_torch.core.config import (CALL, PUT, HestonParams, LSMConfig,
                                                      MCConfig, OptionSpec)
    from options_model_tpu_torch.models.gbm import simulate_gbm
    from options_model_tpu_torch.models.heston import simulate_heston
    from options_model_tpu_torch.ops import cuda_gbm, cuda_heston
    from options_model_tpu_torch.ops.philox import seed_from_generator
    from options_model_tpu_torch.pricers.american import lsm_poly_backward
    from options_model_tpu_torch.pricers.binomial import crr_american
    from options_model_tpu_torch.pricers.blackscholes import (bs_greeks,
                                                              bs_greeks_closed_form,
                                                              bs_price, bs_vega, bs_delta,
                                                              implied_vol)
    from options_model_tpu_torch.pricers.greeks import (cos_greeks_heston, mc_greeks,
                                                        mc_greeks_heston)

    hp = HestonParams(kappa=2.0, theta=0.04, xi=0.3, rho=-0.7, v0=0.04)
    counted = [(cuda_gbm.launches, k) for k in ("gbm_terminal", "gbm_paths", "gbm_terminal_vjp",
                                                "gbm_paths_vjp")]
    counted += [(cuda_heston.launches, k) for k in ("heston_paths", "euler_paths_vjp")]
    secs, per_call, res = {}, {}, {}

    def timed(label, fn, *args, **kwargs):
        before = {k: d[k] for d, k in counted}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        out = {k: float(v) for k, v in out.items()}
        secs.setdefault(label, []).append(time.perf_counter() - t0)
        per_call[label] = {k: d[k] - before[k] for d, k in counted if d[k] != before[k]}
        for k, v in out.items():
            if not math.isfinite(v):
                fail(f"{label}: {k} is {v}")
        return out

    def pooled(runs, keys):
        return {k: (float(np.mean([r[k] for r in runs])),
                    float(np.std([r[k] for r in runs], ddof=1) / math.sqrt(len(runs))))
                for k in keys}

    # G1: GBM European call, 2^22 x 100, against the closed form.
    spec = OptionSpec(strike=100.0, rate=0.05, cp=CALL, sigma=0.2)
    mc = MCConfig(n_paths=1 << 22, n_steps=100, path_block=4096)
    runs = [timed("G1", mc_greeks, torch.Generator().manual_seed(31 + s), 100.0, 1.0, spec,
                  mc, style="european", device=DEVICE) for s in range(GREEKS_SEEDS)]
    cf = {k: float(v) for k, v in bs_greeks_closed_form(100.0, 100.0, 1.0, 0.05, 0.2, CALL,
                                                        dtype=torch.float64,
                                                        device="cpu").items()}
    pool = pooled(runs, ("Price",) + tuple(G1_GATES))
    txt = []
    for k, gate in G1_GATES.items():
        m, se = pool[k]
        txt.append(f"{k} {m:+.6f} +- {se:.6f} vs {cf[k]:+.6f} (gap {m - cf[k]:+.6f}, "
                   f"gate {gate:.6f})")
        if not abs(m - cf[k]) <= gate:
            fail(f"G1 {k} {m} outside {gate} of the closed form {cf[k]}")
    log(f"[3g] G1 GBM European call Greeks (S0 = K = 100, T = 1, 2^22 x 100, pooled over "
        f"{GREEKS_SEEDS} seeds, +- the seeds' stderr), against bs_greeks_closed_form: "
        + "; ".join(txt) + f"; price {pool['Price'][0]:.6f} +- {pool['Price'][1]:.6f}")
    res["G1"] = dict(pool=pool, closed_form=cf)

    def bump_gap(label, greeks_fn, price_at, seeds):
        gaps, runs = [], []
        for s in seeds:
            gen = torch.Generator().manual_seed(s)
            seed = seed_from_generator(torch.Generator().manual_seed(s))
            g = timed(label, greeks_fn, gen)
            fd = (price_at(seed, 100.0 + BUMP_H) - price_at(seed, 100.0 - BUMP_H)) / (2 * BUMP_H)
            gaps.append(g["Delta"] - fd)
            runs.append(dict(g, fd_delta=fd))
        return runs, float(np.mean(gaps)), float(np.std(gaps, ddof=1) / math.sqrt(len(gaps)))

    # G2: GBM American put, 2^21 x 50, degree 3.
    spec = OptionSpec(strike=100.0, rate=0.05, cp=PUT, sigma=0.2)
    mc = MCConfig(n_paths=1 << 21, n_steps=50, path_block=4096)

    def gbm_price(seed, s0):
        with torch.no_grad():
            S = simulate_gbm(seed, s0, 0.05, 0.2, 0.5, mc, device=DEVICE)
            return float(lsm_poly_backward(S, spec, 0.5, poly_degree=3)[0])

    runs, gap, gap_se = bump_gap(
        "G2", lambda gen: mc_greeks(gen, 100.0, 0.5, spec, mc, style="american",
                                    lsm=LSMConfig(poly_degree=3), device=DEVICE),
        gbm_price, [41 + s for s in range(GREEKS_SEEDS)])
    crr_fd = (crr_american(100.0 + BUMP_H, 100.0, 0.5, 0.05, 0.2, cp=-1.0, n_steps=4096,
                           use_native=True)
              - crr_american(100.0 - BUMP_H, 100.0, 0.5, 0.05, 0.2, cp=-1.0, n_steps=4096,
                             use_native=True)) / (2 * BUMP_H)
    keys = ("Price", "Delta", "Gamma", "Vega", "Theta", "Rho")
    pool = pooled(runs, keys + ("fd_delta",))
    g0 = runs[0]
    log(f"[3g] G2 GBM American put Greeks (S0 = K = 100, T = 0.5, 2^21 x 50, degree 3), "
        f"seed 0: {_greeks_text(g0, keys)}; pooled over {GREEKS_SEEDS} seeds: "
        + ", ".join(f"{k} {pool[k][0]:+.6f} +- {pool[k][1]:.6f}" for k in keys)
        + f"; AD Delta - common-random-number bump Delta (h = {BUMP_H}) {gap:+.6f} +- "
        f"{gap_se:.6f} (gate {BUMP_GATE}); CRR(4096) central-difference Delta {crr_fd:+.6f} "
        f"(no gate)")
    if not abs(gap) <= BUMP_GATE:
        fail(f"G2: AD Delta {gap:+.4f} from its bump")
    for r in runs:
        if not (-1.0 < r["Delta"] < 0.0 and r["Vega"] > 0 and r["Gamma"] > 0
                and r["Theta"] < 0 and r["Rho"] < 0):
            fail(f"G2: a Greek has the wrong sign: {r}")
    res["G2"] = dict(pool=pool, gap=(gap, gap_se), crr_fd_delta=crr_fd)

    # G3: Heston American put, 2^20 x 50, degree 3 (LSMConfig's default), v-degree 2.
    spec = OptionSpec(strike=100.0, rate=0.05, cp=PUT, sigma=None)
    mc = MCConfig(n_paths=1 << 20, n_steps=50, path_block=4096)
    fields = ("kappa", "theta", "xi", "rho", "v0")

    def heston_price(seed, s0=100.0, r=0.05, T=0.5, **p):
        with torch.no_grad():
            S, v = simulate_heston(seed, s0, r, T, HestonParams(**dict(vars(hp), **p)), mc,
                                   return_variance=True, device=DEVICE)
            return float(lsm_poly_backward(S, OptionSpec(strike=100.0, rate=r, cp=PUT), T,
                                           poly_degree=3, v_paths=v)[0])

    runs, gap, gap_se = bump_gap(
        "G3", lambda gen: mc_greeks_heston(gen, 100.0, 0.5, spec, mc, hp, device=DEVICE),
        lambda seed, s0: heston_price(seed, s0), [51 + s for s in range(GREEKS_SEEDS)])
    keys3 = ("Price", "Delta", "Gamma", "Theta", "Rho", "dKappa", "dTheta", "dXi",
             "dRhoCorr", "dV0", "Vega")
    pool = pooled(runs, keys3)
    seed0 = seed_from_generator(torch.Generator().manual_seed(51))
    fds = {}
    for key, arg, base in (("Theta", "T", 0.5), ("Rho", "r", 0.05),
                           *((f"d{f[0].upper()}{f[1:]}" if f != "rho" else "dRhoCorr", f,
                              getattr(hp, f)) for f in fields)):
        h = 1e-2 * abs(base)
        d = (heston_price(seed0, **{arg: base + h}) - heston_price(seed0, **{arg: base - h})) \
            / (2 * h)
        fds[key] = -d / 365.0 if key == "Theta" else d / 100.0 if key == "Rho" else d
    log(f"[3g] G3 Heston American put Greeks (S0 = K = 100, T = 0.5, Heston (2, 0.04, 0.3, "
        f"-0.7, 0.04), 2^20 x 50, degree 3, v-degree 2), seed 0: "
        f"{_greeks_text(runs[0], keys3)}; pooled over {GREEKS_SEEDS} seeds: "
        + ", ".join(f"{k} {pool[k][0]:+.6f} +- {pool[k][1]:.6f}" for k in keys3)
        + f"; AD Delta - bump Delta (h = {BUMP_H}) {gap:+.6f} +- {gap_se:.6f} "
        f"(gate {BUMP_GATE})")
    log("[3g] G3 seed 0, each parameter's AD gradient beside its common-random-number "
        "central difference (h = 1e-2 |theta|; the bump re-decides exercise, AD does not): "
        + "; ".join(f"{k} {runs[0][k]:+.6f} vs {fds[k]:+.6f}" for k in fds))
    if not abs(gap) <= BUMP_GATE:
        fail(f"G3: AD Delta {gap:+.4f} from its bump")
    for r in runs:
        if not (-1.0 < r["Delta"] < 0.0 and r["dV0"] > 0 and r["dTheta"] > 0
                and r["Theta"] < 0):
            fail(f"G3: a Greek has the wrong sign: {r}")
    again = {k: float(v) for k, v in mc_greeks_heston(torch.Generator().manual_seed(51), 100.0,
                                                      0.5, spec, mc, hp,
                                                      device=DEVICE).items()}
    differ = [k for k, v in again.items() if v != runs[0][k]]
    log(f"[3g] G3 seed 0 run again: every Greek bit for bit the same {not differ}")
    if differ:
        fail(f"G3: a second run of the same seed changed {differ}")
    res["G3"] = dict(pool=pool, gap=(gap, gap_se), seed0=runs[0], fd=fds)

    # G4: exact European Heston Greeks through the COS price, float64.
    g = {k: float(v) for k, v in cos_greeks_heston(100.0, 100.0, 1.0, 0.05, hp, cp=PUT,
                                                   dtype=torch.float64,
                                                   device=DEVICE).items()}

    def cos(**p):
        a = dict(S0=100.0, K=100.0, T=1.0, r=0.05)
        a.update({k: v for k, v in p.items() if k in a})
        params = HestonParams(**dict(vars(hp), **{k: v for k, v in p.items() if k in fields}))
        return float(heston_cos_price(a["S0"], a["K"], a["T"], a["r"], params, cp=PUT,
                                      dtype=torch.float64, device=DEVICE))

    def cd(arg, base, h_rel=1e-4):
        h = h_rel * abs(base)
        return (cos(**{arg: base + h}) - cos(**{arg: base - h})) / (2 * h)

    h_g = 1e-3 * 100.0
    want = {"Price": cos(), "Delta": cd("S0", 100.0),
            "Gamma": (cos(S0=100.0 + h_g) - 2 * cos() + cos(S0=100.0 - h_g)) / h_g**2,
            "Theta": -cd("T", 1.0) / 365.0, "Rho": cd("r", 0.05) / 100.0,
            "dKappa": cd("kappa", hp.kappa), "dTheta": cd("theta", hp.theta),
            "dXi": cd("xi", hp.xi), "dRhoCorr": cd("rho", hp.rho), "dV0": cd("v0", hp.v0)}
    worst = 0.0
    for k, w in want.items():
        tol = (1e-5 if k == "Gamma" else COS_RTOL) * abs(w) + COS_ATOL
        worst = max(worst, abs(g[k] - w) / tol)
        if not abs(g[k] - w) <= tol:
            fail(f"G4: cos_greeks_heston {k} {g[k]} vs central difference {w}")
    log("[3g] G4 cos_greeks_heston (European put, K = 100, T = 1, float64 on the card) "
        "against central differences of the float64 COS price: "
        + ", ".join(f"{k} {g[k]:+.9f} ({g[k] - w:+.1e})" for k, w in want.items())
        + f"; worst {worst:.2f} of its tolerance (rtol {COS_RTOL}, Gamma 1e-5, atol "
          f"{COS_ATOL})")
    res["G4"] = dict(greeks=g, worst=worst)

    # G5: bs_greeks and implied_vol on a 64 x 64 (K, T) grid on the card.
    K, T = torch.meshgrid(torch.linspace(70.0, 130.0, 64, device=DEVICE),
                          torch.linspace(0.1, 1.0, 64, device=DEVICE), indexing="ij")
    sig = 0.15 + 0.25 * (K - 70.0) / 60.0 * T      # a smile-free ramp over the grid
    worst = {}
    for cp in (CALL, PUT):
        ad = bs_greeks(100.0, K, T, 0.05, sig, cp, q=0.01)
        cf2 = bs_greeks_closed_form(100.0, K, T, 0.05, sig, cp, q=0.01)
        for k in ad:
            diff = (ad[k] - cf2[k]).abs()
            tol = BS_RTOL * cf2[k].abs() + 1e-5 * float(cf2[k].abs().max())
            worst[k] = max(worst.get(k, 0.0), float((diff / tol).max()))
            if not bool((diff <= tol).all()):
                fail(f"G5: bs_greeks {k} differs from the closed form beyond rtol {BS_RTOL}")
    K64, T64, sig64 = K.double(), T.double(), sig.double()
    prices = bs_price(100.0, K64, T64, 0.05, sig64, CALL)
    p = prices.clone().requires_grad_()
    S = torch.full_like(p, 100.0, requires_grad=True)
    iv = implied_vol(p, S, K64, T64, 0.05, CALL)
    dp, dS = torch.autograd.grad(iv.sum(), (p, S))
    vega = bs_vega(100.0, K64, T64, 0.05, sig64)
    live = vega > 1e-3
    iv_err = float((iv.detach() - sig64).abs()[live].max())
    grad_err = max(float(((dp - 1.0 / vega).abs() / (1.0 / vega))[live].max()),
                   float(((dS + bs_delta(100.0, K64, T64, 0.05, sig64, CALL) / vega).abs()
                          / (bs_delta(100.0, K64, T64, 0.05, sig64, CALL) / vega).abs())[
                              live].max()))
    log(f"[3g] G5 64 x 64 (K, T) grid, K 70-130, T 0.1-1: bs_greeks (float32 autograd, "
        f"Gamma by double backward) against bs_greeks_closed_form, worst over calls and "
        f"puts as a share of rtol {BS_RTOL} (+ 1e-5 of the largest): "
        + ", ".join(f"{k} {v:.3f}" for k, v in worst.items())
        + f"; implied_vol (float64) round trip max |iv - sigma| {iv_err:.2e} over "
        f"{int(live.sum())} cells with vega > 1e-3 (gate {IV_ATOL}); its autograd gradient "
        f"against the implicit formula (1/vega, -delta/vega) max rel {grad_err:.2e} "
        f"(gate {IV_GRAD_RTOL})")
    if not (iv_err <= IV_ATOL and grad_err <= IV_GRAD_RTOL):
        fail("G5: implied_vol round trip or gradient outside its gate")
    res["G5"] = dict(worst=worst, iv_err=iv_err, grad_err=grad_err)
    return {k: statistics.median(v) for k, v in secs.items()}, per_call, res


# C1: bench.py's exact round trip; C4, C5: tests/test_bates.py:223 and
# tests/test_vg.py:162 with their gates; C6: tests/test_livechain_e2e.py's
# gates on the recorded chain.
C1_PARAM_RMSE = 1e-4
C1_IV_RMSE = 1e-6
C4_IV_RMSE = 1e-6
C5_IV_RMSE = 5e-4
C6_IV_RMSE = 0.01
C6_COS_REL = 0.01
C6_AMERICAN_REL = 0.015
# The default cascade's evaluations on C2's surface (CalibrationConfig(),
# the port on the CPU: python -m options_model_tpu_torch.scripts.
# profile_calibration --count-cascade); times C3's ms per evaluation of each
# method, the default cascade's projected seconds on the card.
DEFAULT_CASCADE_NFEV = {"L-BFGS-B": 311, "differential_evolution": 10068,
                        "dual_annealing": 4583}


def phase_calibration() -> dict:
    """The calibration path (BASELINE configs[3], "Heston calibration to
    market IV surface via char-fn least-squares"), float64 on the card:
    C1 bench.py's exact Heston round trip (default config); C2 its noisy
    surface (0.005, seed 7) with ("L-BFGS-B",) against the JAX package's
    fit; C3 the default cascade at max_iterations=50 on C2's surface; C4
    the Bates and C5 the VG f64 round trips of the JAX slow tests; C6 the
    recorded chain (calibrate, then reprice COS Europeans and American puts
    at 2^20 x 50 under the fitted and true parameters); C7 apps.calibrate
    --test --methods L-BFGS-B --price-surface (64 x 64, one batched paths
    launch). Also the ms and device kernels of one objective evaluation of
    each model (scripts/profile_calibration.py). Returns the numbers for
    PERF.md."""
    import numpy as np
    import torch

    from options_model_tpu_torch.apps import calibrate as app
    from options_model_tpu_torch.calibration.calibrator import HestonCalibrator, MarketSurface
    from options_model_tpu_torch.calibration.charfn import heston_cos_price
    from options_model_tpu_torch.calibration.synthetic import create_synthetic_heston_surface
    from options_model_tpu_torch.core.config import (PUT, CalibrationConfig, HestonParams,
                                                      LSMConfig, MCConfig, OptionSpec)
    from options_model_tpu_torch.data.market import read_chain_fixture
    from options_model_tpu_torch.ops import cuda_heston
    from options_model_tpu_torch.pricers.american import price_american
    from options_model_tpu_torch.scripts.profile_calibration import profile_objective, surfaces

    t_phase = time.perf_counter()
    res = {}
    lbfgsb = CalibrationConfig(optimization_methods=("L-BFGS-B",))
    synth = surfaces(DEVICE)

    for model, (surface, _) in synth.items():
        r = profile_objective(surface, model, DEVICE)
        res[f"profile_{model}"] = r
        log(f"[3f] one {model} objective evaluation ({r['points']} points x {r['n_terms']} "
            f"terms, float64): value and gradient {r['ms_value_and_grad']:.3f} ms, value "
            f"{r['ms_value']:.3f} ms (host clock, median of {r['n_timed']}); {r['kernels']} device "
            f"kernels, {r['copies_htod']} host-to-device and {r['copies_dtoh']} "
            f"device-to-host copies, device busy {r['device_busy_share'] * 100:.1f}% "
            f"(torch.profiler, one value-and-gradient evaluation)")

    def fit(label, model, surface, cfg):
        cal = HestonCalibrator(cfg, model=model, device=DEVICE)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params = cal.calibrate(surface)
        secs = time.perf_counter() - t0
        n = cal.n_evaluations
        methods = "; ".join(f"{m} error {v['error']:.9g}, {v['nfev']} evaluations, "
                            f"{v['seconds']:.3f} s" for m, v in cal.method_results.items())
        log(f"[3f] {label}: {params}; weighted IV RMSE {cal.best_error:.9g}; {secs:.3f} s, "
            f"{n} evaluations, {secs / n * 1e3:.3f} ms per evaluation; {methods}")
        if not math.isfinite(cal.best_error):
            fail(f"{label}: the fit's error is {cal.best_error}")
        res[label] = dict(seconds=secs, nfev=n, error=cal.best_error,
                          methods=cal.method_results, params=params.to_array().tolist())
        return cal, params

    # C1: the exact round trip, default config.
    surface, true = synth["heston"]
    _, p1 = fit("C1", "heston", surface, CalibrationConfig())
    rel = p1.to_array() / true.to_array() - 1.0
    rmse = float(np.sqrt(np.mean(rel**2)))
    log(f"[3f] C1 parameter rel RMSE {rmse:.3e} (gate {C1_PARAM_RMSE}), IV RMSE "
        f"{res['C1']['error']:.3e} (gate {C1_IV_RMSE}); BENCH_r04: 0.0 and 0.0 (rounded to "
        f"6 and 8 places)")
    if not (rmse < C1_PARAM_RMSE and res["C1"]["error"] < C1_IV_RMSE):
        fail("C1: the exact Heston round trip outside its gates")

    # C2: the noisy surface, L-BFGS-B (with its least-squares polish).
    K, T, iv = create_synthetic_heston_surface(true, noise_std=0.005, seed=7,
                                               dtype=np.float64, device=DEVICE)
    noisy = MarketSurface(K, T, iv, 100.0, 0.05)
    _, p2 = fit("C2", "heston", noisy, lbfgsb)
    rel2 = p2.to_array() / true.to_array() - 1.0
    rmse4 = float(np.sqrt(np.mean(rel2[1:]**2)))
    err2 = res["C2"]["error"]
    log(f"[3f] C2 IV RMSE {err2:.9g} vs the JAX package's {JAX_C2_IV_RMSE:.9g} (ratio "
        f"{err2 / JAX_C2_IV_RMSE:.9f}, gate within {C2_IV_RTOL:.1%}); BENCH_r04's full "
        f"cascade {BENCH_R04_NOISY_IV_RMSE}; (theta, xi, rho, v0) rel RMSE {rmse4:.6f} vs "
        f"JAX {JAX_C2_PARAM_RMSE:.6f} (gate + {C2_PARAM_SLACK}); kappa rel err "
        f"{abs(rel2[0]):.6f}")
    if not (abs(err2 / JAX_C2_IV_RMSE - 1.0) <= C2_IV_RTOL
            and rmse4 <= JAX_C2_PARAM_RMSE + C2_PARAM_SLACK):
        fail("C2: the noisy fit is off the JAX package's")

    # C3: the default three-method cascade at max_iterations=50.
    cal3, _ = fit("C3", "heston", noisy, CalibrationConfig(max_iterations=50))
    if set(cal3.method_results) != {"L-BFGS-B", "differential_evolution", "dual_annealing"}:
        fail(f"C3: not every method ran: {list(cal3.method_results)}")
    if not res["C3"]["error"] <= err2:
        fail(f"C3: the cascade's best {res['C3']['error']} is above C2's {err2}")
    per_eval = {m: v["seconds"] / v["nfev"] for m, v in cal3.method_results.items()}
    projected = sum(DEFAULT_CASCADE_NFEV[m] * per_eval[m] for m in per_eval)
    log(f"[3f] the default cascade on C2's surface, projected: "
        + ", ".join(f"{m} {DEFAULT_CASCADE_NFEV[m]} evaluations x {per_eval[m] * 1e3:.3f} ms"
                    for m in per_eval) + f" = {projected:.1f} s")
    res["projected_default_cascade_s"] = projected

    # C4: the Bates round trip (tests/test_bates.py:223).
    surface, true_b = synth["bates"]
    _, p4 = fit("C4", "bates", surface, lbfgsb)
    got, want = p4.to_array(), true_b.to_array()
    if not (res["C4"]["error"] < C4_IV_RMSE
            and np.all(np.abs(got - want) <= 1e-3 + 0.01 * np.abs(want))):
        fail(f"C4: the Bates round trip outside its gates: {got} vs {want}")

    # C5: the VG round trip (tests/test_vg.py:162).
    surface, true_v = synth["vg"]
    _, p5 = fit("C5", "vg", surface, lbfgsb)
    if not (res["C5"]["error"] < C5_IV_RMSE
            and abs(p5.sigma / true_v.sigma - 1.0) < 1e-3
            and abs(p5.theta / true_v.theta - 1.0) < 1e-2
            and abs(p5.nu / true_v.nu - 1.0) < 1e-2):
        fail(f"C5: the VG round trip outside its gates: {p5}")

    # C6: the recorded chain, calibrated, then repriced.
    Kc, Tc, ivc, S0, meta = read_chain_fixture()
    r = meta["rate"]
    true_c = HestonParams(**meta["true_params"])
    chain = MarketSurface(Kc, Tc, ivc, S0, r)
    cal6, p6 = fit("C6", "heston", chain, lbfgsb)
    ok = (chain.regime == "normal_vol" and res["C6"]["error"] < C6_IV_RMSE
          and abs(p6.theta - true_c.theta) < 0.01 and abs(p6.v0 - true_c.v0) < 0.01
          and abs(p6.rho - true_c.rho) < 0.15 and abs(p6.xi / true_c.xi - 1.0) < 0.35)
    log(f"[3f] C6 the recorded chain ({len(chain)} quotes, S0 {S0}): fitted {p6} vs true "
        f"{true_c}; regime {chain.regime}")
    if not ok:
        fail("C6: the recorded chain's fit outside tests/test_livechain_e2e.py's gates")
    Ks = torch.tensor([0.9 * S0, S0, 1.1 * S0], dtype=torch.float64, device=DEVICE)
    Ts = torch.full((3,), 0.5, dtype=torch.float64, device=DEVICE)
    cos = [heston_cos_price(S0, Ks, Ts, r, p, cp=1.0, dtype=torch.float64).cpu().numpy()
           for p in (p6, true_c)]
    cos_rel = float(np.abs(cos[0] / cos[1] - 1.0).max())
    spec = OptionSpec(strike=float(S0), rate=r, cp=PUT)
    mc = MCConfig(n_paths=1 << 20, n_steps=50)
    am = [price_american(torch.Generator().manual_seed(7), S0, 0.5, spec, mc, LSMConfig(),
                         "heston", heston=p, device=DEVICE) for p in (p6, true_c)]
    am = [(float(p), float(se)) for p, se in am]
    am_rel = am[0][0] / am[1][0] - 1.0
    log(f"[3f] C6 reprice under the fitted vs the true parameters: COS calls at 0.9, 1, 1.1 "
        f"S0, T 0.5: max rel {cos_rel:.3e} (gate {C6_COS_REL}); American put K = S0, T 0.5, "
        f"2^20 x 50, one generator: {am[0][0]:.6f} +- {am[0][1]:.6f} vs {am[1][0]:.6f} +- "
        f"{am[1][1]:.6f}, rel {am_rel:+.4%} (gate {C6_AMERICAN_REL:.1%})")
    if not (cos_rel < C6_COS_REL and abs(am_rel) < C6_AMERICAN_REL):
        fail("C6: the fitted dynamics do not reprice near the truth")
    res["C6_reprice"] = dict(cos_rel=cos_rel, american=am, american_rel=am_rel)

    # C7: calibrate -> price through the app.
    csv_path = Path(__file__).resolve().parent / "build" / "calibrated_surface.csv"
    csv_path.parent.mkdir(parents=True, exist_ok=True)
    before = cuda_heston.launches["heston_paths"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s7 = app.run(app.parse_args(["--test", "--methods", "L-BFGS-B", "--price-surface",
                                 str(csv_path)]), device=DEVICE)
    secs7 = time.perf_counter() - t0
    n7 = cuda_heston.launches["heston_paths"] - before
    lines = csv_path.read_text().splitlines()
    rows = np.array([[float(v) for v in ln.split(",")] for ln in lines[1:]])
    P = rows[:, 2].reshape(64, 64) if rows.shape == (4096, 3) else None
    worst = float(np.diff(P, axis=1).min()) if P is not None else -math.inf
    log(f"[3f] C7 apps.calibrate --test --methods L-BFGS-B --price-surface: {secs7:.3f} s; "
        f"{s7['params']}, IV RMSE {s7['error']:.6g}; {n7} launch of heston_paths; "
        f"{len(lines) - 1} rows, header {lines[0]!r}; min step in K {worst:+.3e} (gate -1e-3)")
    if not (n7 == 1 and lines[0] == "K,T,price" and P is not None and np.isfinite(P).all()
            and worst >= -1e-3):
        fail("C7: the calibrated 64x64 surface: not one launch, not 4096 finite rows, or "
             "not monotone in K")
    res["C7"] = dict(seconds=secs7, error=s7["error"], launches=n7)
    res["phase_seconds"] = time.perf_counter() - t_phase
    log(f"[3f] the calibration phase: {res['phase_seconds']:.1f} s")
    return res


def first_design_row(name: str, source: str, shape: str, turns: list, bound_ms: float,
                     a: dict) -> dict:
    """The first design's fields of a redesigned kernel's timing row (kernels
    12-17), from times in turns (first, new, new, first) and the first
    design's registers and occupancy ``a``; logged beside the redesign's."""
    ms, first_ms = (turns[1] + turns[2]) / 2, (turns[0] + turns[3]) / 2
    occ = a["blocks_per_sm"] * a["block"] / THREADS_PER_SM
    log(f"[5] {name} at {shape}: {first_ms:.4f} ms, {bound_ms / first_ms * 100:.1f}% of "
        f"bound; redesign {ms:.4f} ms ({turns[1]:.4f}, {turns[2]:.4f}; first design "
        f"{turns[0]:.4f}, {turns[3]:.4f}; {ms / first_ms:.3f}x); first design "
        f"{a['registers']} registers, {a['spill_bytes']} spill bytes, {a['blocks_per_sm']} "
        f"blocks of {a['block']} per SM ({occ * 100:.1f}% occupancy)")
    return dict(earlier_name=name, earlier_source=source, earlier_ms=first_ms, turns=turns,
                earlier_registers=a["registers"], earlier_spill_bytes=a["spill_bytes"],
                earlier_occupancy=occ)


# G2 runs kernel 2 at 2^21 paths, twice the timed 2^20 (its VJP is timed
# at 2^21 itself, gbm_vjp_greeks_shape).
GREEKS_SHAPE = {"G2": {"gbm_paths": 2.0}}


def greeks_kernel_ms(row: dict, label: str, name: str) -> float:
    """A kernel's ms at Greeks call ``label``'s shape: the time taken there
    (G2's ``greeks_shape``) where phase 5 has one, else the timed shape's
    scaled by GREEKS_SHAPE."""
    if label == "G2" and "greeks_shape" in row:
        return row["greeks_shape"]["ms"]
    return row["ms"] * GREEKS_SHAPE.get(label, {}).get(name, 1.0)


def gbm_vjp_greeks_shape(spec: dict, per_call: float, seed: int, attrs: dict) -> dict:
    """Kernel 12 at G2's shape (VJP_GREEKS_SHAPE, 2^21 x 50) in turns with
    its first design (first, new, new, first), beside its bound there."""
    import torch

    from options_model_tpu_torch.ops import cuda_gbm
    from options_model_tpu_torch.utils.profiling import time_per_call

    n, steps = VJP_GREEKS_SHAPE["gbm_paths_vjp"]
    g = torch.full((steps + 1, n), 1.0 / n, device=DEVICE)
    run = lambda: cuda_gbm.gbm_paths_vjp_rows(g, seed, 100.0, 0.05, 0.2, 0.5, n, steps)  # noqa: E731
    first = lambda: cuda_gbm.gbm_paths_vjp_rows_first(g, seed, 100.0, 0.05, 0.2, 0.5, n,  # noqa: E731
                                                      steps)
    turns = [time_per_call(f, N_TIMED) for f in (first, run, run, first)]
    ms = (turns[1] + turns[2]) / 2
    b = bound(n, steps, spec["ops"], int_ops(spec["draws"], per_call),
              spec["bytes"] * n * (steps + 1))
    row = dict(n_paths=n, n_steps=steps, ms=ms, **b)
    row.update(first_design_row("gbm_paths_vjp_first", spec["source"], f"{n} x {steps}", turns,
                                b["bound_ms"], attrs["gbm_paths_vjp_first"]))
    log(f"[5] gbm_paths_vjp {n} paths x {steps} steps (G2's shape): kernel {ms:.4f} ms, bound "
        f"{b['bound_ms']:.4f} ms by {b['bound_term']}, {b['bound_ms'] / ms * 100:.1f}% of bound")
    return row


def phase_vjp_timing(specs, per_call: float) -> dict:
    """CUDA-event medians of each VJP kernel's launch (its rows of block
    sums), of its whole wrapper and of its plain version at its timed shape
    (euler_paths_vjp with v), beside its bound:
    the cotangent's bytes (and S_T's) read once, its counted f32 operations
    and Philox instructions; and registers and occupancy."""
    import torch

    from options_model_tpu_torch.core.config import HestonParams
    from options_model_tpu_torch.ops import cuda_gbm, cuda_heston
    from options_model_tpu_torch.utils.profiling import time_per_call

    attrs = cuda_heston.vjp_kernel_attrs()
    hp = HestonParams(kappa=2.0, theta=0.04, xi=0.3, rho=-0.7, v0=0.04)
    seed = 0x9E3779B97F4A7C15
    out = {}
    for k in specs:
        n, steps = k["timed"]
        g = torch.full((n,) if k["name"] == "gbm_terminal_vjp" else (steps + 1, n),
                       1.0 / n, device=DEVICE)
        if k["name"] == "gbm_terminal_vjp":
            S_T = cuda_gbm.gbm_terminal(seed, 100.0, 0.05, 0.2, 1.0, n, steps, device=DEVICE)
            run = (lambda: cuda_gbm.gbm_terminal_vjp_rows(g, S_T, seed, 100.0, 0.05, 0.2,
                                                          1.0, n, steps))
            whole = (lambda: cuda_gbm.gbm_terminal_vjp(g, S_T, seed, 100.0, 0.05, 0.2, 1.0,
                                                       n, steps))
            plain = (lambda: cuda_gbm.gbm_terminal_vjp_reference(g, seed, 100.0, 0.05, 0.2,
                                                                 1.0, n, steps))
            b = bound(n, 1, k["ops"], 0, k["bytes"] * n)
        elif k["name"] == "gbm_paths_vjp":
            run = lambda: cuda_gbm.gbm_paths_vjp_rows(g, seed, 100.0, 0.05, 0.2, 0.5, n,
                                                      steps)
            first = lambda: cuda_gbm.gbm_paths_vjp_rows_first(g, seed, 100.0, 0.05, 0.2, 0.5,
                                                              n, steps)
            whole = lambda: cuda_gbm.gbm_paths_vjp(g, seed, 100.0, 0.05, 0.2, 0.5, n, steps)
            plain = lambda: cuda_gbm.gbm_paths_vjp_reference(g, seed, 100.0, 0.05, 0.2, 0.5,
                                                             n, steps)
            b = bound(n, steps, k["ops"], int_ops(k["draws"], per_call),
                      k["bytes"] * n * (steps + 1))
        else:
            # gS and gv apart, as the Greeks path passes them: one tensor
            # for both would read each address twice, the second time from
            # cache, and move half the bytes the bound counts.
            gv = g.clone()
            run = lambda: cuda_heston.euler_paths_vjp_rows(g, gv, seed, 100.0, 0.05, 0.5, hp,
                                                           n, steps)
            first = lambda: cuda_heston.euler_paths_vjp_rows_first(g, gv, seed, 100.0, 0.05,
                                                                   0.5, hp, n, steps)
            whole = lambda: cuda_heston.euler_paths_vjp(g, gv, seed, 100.0, 0.05, 0.5, hp, n,
                                                        steps)
            plain = lambda: cuda_heston.euler_paths_vjp_reference(g, gv, seed, 100.0, 0.05,
                                                                  0.5, hp, n, steps)
            b = bound(n, steps, k["ops"], int_ops(k["draws"], per_call),
                      k["bytes"] * n * (steps + 1))
        turns = None
        if k["name"] in ("euler_paths_vjp", "gbm_paths_vjp"):
            # in turns with the first design: first, new, new, first
            turns = [time_per_call(f, N_TIMED) for f in (first, run, run, first)]
            ms = (turns[1] + turns[2]) / 2
        else:
            ms = time_per_call(run, N_TIMED)
        whole_ms = time_per_call(whole, N_TIMED)
        plain_ms = time_per_call(plain, N_TIMED)
        a = attrs[k["name"]]
        terminal = k["name"] == "gbm_terminal_vjp"
        occ = a["blocks_per_sm"] * a["block"] / THREADS_PER_SM
        out[k["name"]] = dict(ms=ms, wrapper_ms=whole_ms, plain_ms=plain_ms,
                              registers=a["registers"],
                              spill_bytes=a["spill_bytes"], block=a["block"], occupancy=occ,
                              **b)
        if turns is not None:
            out[k["name"]].update(first_design_row(
                f"{k['name']}_first", k["source"],
                f"{n} x {steps}" + (" with v" if k["name"] == "euler_paths_vjp" else ""), turns,
                b["bound_ms"], attrs[f"{k['name']}_first"]))
        if k["name"] == "gbm_paths_vjp":
            out[k["name"]]["greeks_shape"] = gbm_vjp_greeks_shape(k, per_call, seed, attrs)
        log(f"[5] {k['name']} {n} paths" + ("" if k["name"] == "gbm_terminal_vjp" else
                                            f" x {steps} steps")
            + f": kernel {ms:.4f} ms (the wrapper with its row sums and chain rule "
              f"{whole_ms:.4f} ms), plain {plain_ms:.4f} ms; bound {b['bound_ms']:.4f} ms by {b['bound_term']} "
              f"({k['ops']:.2f} f32 operations per path-step, "
              f"{k['bytes'] * n * (1 if terminal else steps + 1) / 1e6:.1f} MB read; f32 alone "
              f"{n * (1 if terminal else steps) * k['ops'] / PEAK_F32_OPS * 1e3:.4f} ms); "
              f"{b['bound_ms'] / ms * 100:.1f}% of bound; {a['registers']} registers, "
              f"{a['spill_bytes']} spill bytes, {a['blocks_per_sm']} blocks of {a['block']} "
              f"per SM ({occ * 100:.1f}% occupancy)")
    return out


# ---- the jumps path (csrc/jumps.cu, models/merton.py, models/bates.py) -----
# bench.py:496 (the Merton American leg) and bench.py:470 (the Bates legs).
MERTON_BENCH = dict(sigma=0.2, lam=1.0, mu_j=-0.10, sigma_j=0.15)
BATES_JUMPS = dict(lam=0.3, mu_j=-0.1, sigma_j=0.15)
# lam dt = 1 over 50 steps of T = 0.5: counts up to ~10 a step, so a count
# that differed would move S far beyond its tolerance as well.
HEAVY_LAM = 100.0
JUMP_S_RTOL = 1e-5             # kernels 14-17 vs their plain versions on S
J1_GATE = 0.001                # pooled Merton American put vs the COS-Bermudan oracle
# Seeds J1 pools. At 2^18 x 50 one seed's stderr is ~0.14% of the price in
# both packages (the JAX package's 0.1415%, the port's 0.1414% on the CPU:
# tests/test_torch_slice.py::test_merton_bench_leg_stderr_matches_reference),
# so 4 seeds pool to ~0.071% and J1_GATE would be a 1.4-sigma bar that an
# unbiased estimator misses one time in six; BENCH_r05's 0.036% spread was
# a tight draw of 4 (the same test: the JAX package's own 4 keys spread
# 0.050%). 16 seeds pool to ~0.035%, making the gate a 2.8-sigma bar. The
# first four are printed as the 4-seed reading beside BENCH_r05's.
J1_SEEDS = 16
J1_DEGREE_GATE = 0.04          # every degree (tests/test_merton.py's clamp test)
BENCH_R05_MERTON_REL = 0.000113        # BENCH_r05 merton_american_rel_err_vs_cos_bermudan
BENCH_R05_MERTON_SPREAD_PCT = 0.0362   # BENCH_r05 merton_american_seed_spread_pct
J2_BIAS = 0.001                # Europeans: 4 stderr + 0.1%
J3_PREMIUM_Z = -3.0            # Bates American minus COS European, in pooled stderr
J4_GREEKS_TOL = 1e-6           # merton_greeks vs f64 central differences
J4_APP_MAX_ITERATIONS = 50     # the Bates app's L-BFGS-B iterations a start
# Philox draws per path-step (calls, words made uniform): Merton one call a
# pair-step (four words); the overlay one call a path-step (three words).
DRAWS_MERTON = (1 / 2, 2)
DRAWS_OVERLAY = (1, 3)
# f32 operations per path-step, counted from csrc/jumps.cu: Merton the
# Box-Muller's 11 per pair-step, the count's subtraction and compares (2),
# the jump sum (sqrt, 2 multiplies, an FMA: 5), the drift FMA (2), two adds
# and the mirror's negations (1); the overlay a whole Box-Muller a
# path-step, the count (2), the jump sum (5), two adds, the exponent's
# multiply and ex2, the multiply into S.
OPS_MERTON = 11 / 2 + 12
OPS_OVERLAY = 11 + 12
# The first designs of kernels 14-17, the yardsticks of their redesigns:
# J0 holds them against the plain versions, phase 5 times them in turns
# with the redesigns, and no path may launch them (main's drive).
JUMP_FIRSTS = ("merton_paths_first", "merton_terminal_first", "jump_overlay_paths_first",
               "jump_overlay_terminal_first")


def jump_specs():
    """Kernels 14-17 (csrc/jumps.cu): name, source, the XLA function they
    replace, the paths that run them, their launch counter, and the timed
    shape (paths, steps) with its f32 operations and Philox draws a
    path-step and the bytes the function must move: kernel 16 reads and
    writes rows 1..n_steps of S (row 0's factor is 1, left untouched)."""
    from options_model_tpu_torch.ops import cuda_jumps as cj

    src = "options_model_tpu_torch/csrc/jumps.cu"
    L = cj.launches
    n20, n22 = 1 << 20, 1 << 22
    return [
        dict(name="merton_paths", source=src, replaces="options_model_tpu/models/merton.py:27",
             paths=("jumps", "dual", "exotics"), counter=(L, "merton_paths"), timed=(n20, 50),
             ops=OPS_MERTON + OPS_EXP, draws=DRAWS_MERTON, bytes=51 * n20 * 4),
        dict(name="merton_terminal", source=src,
             replaces="options_model_tpu/models/merton.py:27", paths=("jumps",),
             counter=(L, "merton_terminal"), timed=(n22, 100), ops=OPS_MERTON,
             draws=DRAWS_MERTON, bytes=n22 * 4),
        dict(name="jump_overlay_paths", source=src,
             replaces="options_model_tpu/models/bates.py:40", paths=("jumps", "dual"),
             counter=(L, "jump_overlay_paths"), timed=(n20, 50), ops=OPS_OVERLAY,
             draws=DRAWS_OVERLAY, bytes=2 * 50 * n20 * 4),
        dict(name="jump_overlay_terminal", source=src,
             replaces="options_model_tpu/models/bates.py:40", paths=("jumps",),
             counter=(L, "jump_overlay_terminal"), timed=(n22, 1), ops=OPS_OVERLAY,
             draws=DRAWS_OVERLAY, bytes=2 * n22 * 4),
    ]


def _jump_inputs():
    """(seed, bench Merton, heavy Merton, bench overlay jumps, heavy jumps,
    bench Heston) of J0."""
    from types import SimpleNamespace

    from options_model_tpu_torch.core.config import HestonParams, MertonParams

    hp = HestonParams(kappa=2.0, theta=0.04, xi=0.3, rho=-0.7, v0=0.04)
    return (0x9E3779B97F4A7C15, MertonParams(**MERTON_BENCH),
            MertonParams(**dict(MERTON_BENCH, lam=HEAVY_LAM)), SimpleNamespace(**BATES_JUMPS),
            SimpleNamespace(**dict(BATES_JUMPS, lam=HEAVY_LAM)), hp)


def phase_jump_kernels() -> dict:
    """J0: kernels 14-17 and their first designs against their
    plain versions on the card at the jumps path's shapes (Merton 2^18 x 50
    and 2^20 x 50 paths, the 64 x 16,384 x 50 surface batch, 2^22 x 100
    terminal, with and without antithetics; the overlay on a 2^20 x 50
    Heston matrix, on the 64 x 16,384 x 50 surface batch and on 2^22
    terminal values), and at lam = 100 (lam dt = 1): S within JUMP_S_RTOL,
    every Poisson count equal bit for bit (the kernels' debug output). Each
    redesign's S, without its counts output and with them, and its counts
    equal its first design's bit for bit; the batched Merton launch equals
    its single-maturity launches on their tiles (both designs) bit for bit;
    bit-equal first_tile chunks. Returns per name max |dS| and the max
    relative one."""
    import numpy as np
    import torch

    from options_model_tpu_torch.ops import cuda_heston as ch
    from options_model_tpu_torch.ops import cuda_jumps as cj

    seed, mp, mp_heavy, jb, jb_heavy, hp = _jump_inputs()
    errs = {k["name"]: dict(s_abs=0.0, s_rel=0.0) for k in jump_specs()}
    for name in JUMP_FIRSTS:
        errs[name] = dict(s_abs=0.0, s_rel=0.0)

    def held(name, tag, got, want):
        torch.cuda.synchronize()
        (S, n), (S0, n0) = got, want
        if S.shape != S0.shape or not bool(torch.isfinite(S).all()):
            fail(f"{name} {tag}: shape {tuple(S.shape)} vs {tuple(S0.shape)} or non-finite")
        if not torch.equal(n, n0):
            fail(f"{name} {tag}: {int((n != n0).sum())} Poisson counts differ from the plain "
                 "version's")
        diff = (S - S0).abs()
        rel = float((diff / S0.abs()).max())
        if rel > JUMP_S_RTOL:
            fail(f"{name} {tag}: S differs from the plain version (max rel {rel:.3e}, "
                 f"rtol {JUMP_S_RTOL})")
        e = errs[name]
        e["s_abs"], e["s_rel"] = max(e["s_abs"], float(diff.max())), max(e["s_rel"], rel)
        log(f"[J0] {name} {tag}: kernel == plain within rtol {JUMP_S_RTOL} (max |dS| "
            f"{float(diff.max()):.3e}, max rel {rel:.3e}); {n.numel()} counts bit for bit "
            f"(max {int(n.max())}, mean {float(n.float().mean()):.4f})")

    def same_as_first(name, tag, got, first, bare):
        """The redesign's S without its counts output (the pricing instance)
        and with them, and its counts, against its first design's."""
        torch.cuda.synchronize()
        if not (torch.equal(bare, got[0]) and torch.equal(got[0], first[0])
                and torch.equal(got[1], first[1])):
            fail(f"{name} {tag}: S without the counts output, S with them or the counts differ "
                 "from each other or from the first design's")
        log(f"[J0] {name} {tag}: S without the counts output == with them == the first "
            "design's, and the counts the first design's, bit for bit")

    def chunk(name, full, part, cols):
        if not torch.equal(full[..., cols:], part):
            fail(f"{name}: a run at first_tile 32 differs from the matching slice of the "
                 "full run")
        log(f"[J0] {name}: first_tile=32 chunk equals the full run's slice bit for bit")

    for fn, ref, first_fn, cases in (
            (cj.merton_paths, cj.merton_paths_reference, cj.merton_paths_first,
             ((mp, 1 << 18, 50), (mp, 1 << 20, 50), (mp_heavy, 8 * ch.PATH_TILE, 50))),
            (cj.merton_terminal, cj.merton_terminal_reference, cj.merton_terminal_first,
             ((mp, 1 << 22, 100), (mp_heavy, 2 * ch.TERMINAL_TILE, 100)))):
        for (p, n_paths, steps), anti in itertools.product(cases, (True, False)):
            args = (seed, 100.0, 0.05, 0.5, p, n_paths, steps, anti, 0, DEVICE)
            want = ref(*args, return_counts=True)
            tag = f"lam {p.lam} at {n_paths} x {steps}, antithetic {anti}"
            got = fn(*args, return_counts=True)
            held(fn.__name__, tag, got, want)
            first = first_fn(*args, return_counts=True)
            held(first_fn.__name__, tag, first, want)
            same_as_first(fn.__name__, tag, got, first, fn(*args))
        tile = ch.PATH_TILE if fn is cj.merton_paths else ch.TERMINAL_TILE
        chunk(fn.__name__, fn(seed, 100.0, 0.05, 0.5, mp, 64 * tile, 50, True, 0, DEVICE),
              fn(seed, 100.0, 0.05, 0.5, mp, 32 * tile, 50, True, 32, DEVICE), 32 * tile)

    # Kernel 14 over a batch of maturities: the Merton surface's (J4), and
    # two maturities at lam dt = 1 and 2.
    Ts = np.linspace(0.1, 1.0, SURFACE_MATS).astype(np.float32).tolist()
    for p, n_paths, mats, anti in ((mp, SURFACE_PATHS, Ts, True), (mp, SURFACE_PATHS, Ts, False),
                                   (mp_heavy, 8 * ch.PATH_TILE, [0.5, 1.0], True)):
        args = (seed, 100.0, 0.05, mats, p, n_paths, 50, anti, 0, DEVICE)
        tag = f"lam {p.lam}, {len(mats)} maturities x {n_paths} x 50, antithetic {anti}"
        got = cj.merton_paths_batched(*args, return_counts=True)
        held("merton_paths", tag, got, cj.merton_paths_batched_reference(*args,
                                                                         return_counts=True))
        bare = cj.merton_paths_batched(*args)
        n_tiles = n_paths // ch.PATH_TILE
        one = [(seed, 100.0, 0.05, T, p, n_paths, 50, anti, m * n_tiles, DEVICE)
               for m, T in enumerate(mats)]
        singles = [cj.merton_paths(*a) for a in one]
        firsts = [cj.merton_paths_first(*a, return_counts=True) for a in one]
        torch.cuda.synchronize()
        if not (torch.equal(bare, got[0])
                and all(torch.equal(bare[m], S) for m, S in enumerate(singles))
                and all(torch.equal(bare[m], S) and torch.equal(got[1][m], n)
                        for m, (S, n) in enumerate(firsts))):
            fail(f"merton_paths {tag}: the batched launch differs from its {len(mats)} "
                 "single-maturity launches (redesign or first design) on their tiles")
        log(f"[J0] merton_paths {tag}: one batched launch == {len(mats)} single-maturity "
            "launches on their tiles, of the redesign and of the first design (S and counts), "
            "bit for bit")

    for jumps, n_paths, mats, anti in ((jb, 1 << 20, [0.5], True), (jb, 1 << 20, [0.5], False),
                                       (jb, SURFACE_PATHS, Ts, True),
                                       (jb_heavy, 8 * ch.PATH_TILE, [0.5, 1.0], True)):
        base = ch.heston_paths_batched(seed, 100.0, 0.05, mats, hp, n_paths, 50, anti,
                                       device=DEVICE)
        S = base if len(mats) > 1 else base[0]
        T = mats if len(mats) > 1 else mats[0]
        tag = (f"lam {jumps.lam}, {len(mats)} maturities x {n_paths} x 50, Heston antithetic "
               f"{anti}")
        want = cj.jump_overlay_paths_reference(S.clone(), seed, T, jumps, 0, return_counts=True)
        got = cj.jump_overlay_paths(S.clone(), seed, T, jumps, 0, return_counts=True)
        held("jump_overlay_paths", tag, got, want)
        first = cj.jump_overlay_paths_first(S.clone(), seed, T, jumps, 0, return_counts=True)
        held("jump_overlay_paths_first", tag, first, want)
        same_as_first("jump_overlay_paths", tag, got, first,
                      cj.jump_overlay_paths(S.clone(), seed, T, jumps, 0))
    base = ch.heston_paths(seed, 100.0, 0.05, 0.5, hp, 64 * ch.PATH_TILE, 50, device=DEVICE)
    chunk("jump_overlay_paths", cj.jump_overlay_paths(base.clone(), seed, 0.5, jb),
          cj.jump_overlay_paths(base[:, 32 * ch.PATH_TILE:].contiguous(), seed, 0.5, jb, 32),
          32 * ch.PATH_TILE)
    for jumps, n_paths, anti in ((jb, 1 << 22, True), (jb, 1 << 22, False),
                                 (jb_heavy, 2 * ch.TERMINAL_TILE, True)):
        base = ch.heston_terminal(seed, 100.0, 0.05, 0.5, hp, n_paths, 100, anti, device=DEVICE)
        tag = f"lam {jumps.lam} on {n_paths} Heston terminal values, antithetic {anti}"
        want = cj.jump_overlay_terminal_reference(base.clone(), seed, 0.5, jumps, 100, 0, True)
        got = cj.jump_overlay_terminal(base.clone(), seed, 0.5, jumps, 100, 0, True)
        held("jump_overlay_terminal", tag, got, want)
        first = cj.jump_overlay_terminal_first(base.clone(), seed, 0.5, jumps, 100, 0, True)
        held("jump_overlay_terminal_first", tag, first, want)
        same_as_first("jump_overlay_terminal", tag, got, first,
                      cj.jump_overlay_terminal(base.clone(), seed, 0.5, jumps, 100))
    base = ch.heston_terminal(seed, 100.0, 0.05, 0.5, hp, 64 * ch.TERMINAL_TILE, 100,
                              device=DEVICE)
    chunk("jump_overlay_terminal", cj.jump_overlay_terminal(base.clone(), seed, 0.5, jb, 100),
          cj.jump_overlay_terminal(base[32 * ch.TERMINAL_TILE:].clone(), seed, 0.5, jb, 100, 32),
          32 * ch.TERMINAL_TILE)
    return errs


def phase_jumps() -> tuple:
    """The jumps path (ROADMAP item 4), through the entry points a user
    calls: J1 the Merton American put (bench.py's leg, not cut) pooled over
    J1_SEEDS seeds against the COS-Bermudan oracle at degree 5, and at
    degree 3;
    J2 the Merton and Bates (Euler, QE-M) European puts at 2^22 x 100
    against the series and COS; J3 the Bates American put against its COS
    European, and at lam = 0 its paths and plain LSM price against Heston's
    bit for bit; J4 the 64 x 64 Bates and Merton surfaces, the Bates
    calibrate -> price app, and merton_greeks against float64 central
    differences. Returns (seconds per price or surface, results)."""
    import numpy as np
    import torch

    from options_model_tpu_torch.apps import calibrate as app
    from options_model_tpu_torch.calibration.charfn import bates_cos_price
    from options_model_tpu_torch.core.config import (PUT, BatesParams, HestonParams,
                                                      LSMConfig, MCConfig, MertonParams,
                                                      OptionSpec)
    from options_model_tpu_torch.models.merton import merton_price
    from options_model_tpu_torch.ops import cuda_heston, cuda_jumps
    from options_model_tpu_torch.pricers.american import (price_american, price_american_lsm,
                                                          simulate_paths)
    from options_model_tpu_torch.pricers.cos_bermudan import cos_bermudan_price
    from options_model_tpu_torch.pricers.european import (make_terminal_sampler,
                                                          price_european_mc)
    from options_model_tpu_torch.pricers.greeks import merton_greeks
    from options_model_tpu_torch.pricers.surface_american import price_american_surface

    t_phase = time.perf_counter()
    hp = HestonParams(kappa=2.0, theta=0.04, xi=0.3, rho=-0.7, v0=0.04)
    mp = MertonParams(**MERTON_BENCH)
    bp = BatesParams(heston=hp, **BATES_JUMPS)
    gen = lambda s: torch.Generator().manual_seed(s)  # noqa: E731
    secs, res = {}, {}

    def timed(label, fn, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        secs.setdefault(label, []).append(time.perf_counter() - t0)
        return out

    def priced(label, *args, **kwargs):
        p, se = (float(x) for x in timed(label, price_american, *args, device=DEVICE,
                                         **kwargs))
        if not (math.isfinite(p) and math.isfinite(se) and se > 0):
            fail(f"{label}: non-finite price {p} +- {se}")
        return p, se

    def pooled(label, n, *args, **kwargs):
        ps, ses = zip(*(priced(label, gen(33 + s), *args, **kwargs) for s in range(n)))
        return (float(np.mean(ps)), math.sqrt(sum(x * x for x in ses)) / n,
                float(np.std(ps)), ps, ses)

    # J1: the Merton American put, bench.py's leg (2^18 x 50), J1_SEEDS seeds pooled.
    spec_m = OptionSpec(strike=100.0, rate=0.05, cp=PUT, sigma=0.2)
    mc_m = MCConfig(n_paths=1 << 18, n_steps=50, path_block=4096)
    berm = cos_bermudan_price(100.0, 100.0, 0.5, 0.05, "merton", merton=mp, cp=-1.0,
                              n_dates=50)
    for deg in (5, 3):
        p, se, spread, ps, ses = pooled(f"merton_american_deg{deg}", J1_SEEDS, 100.0, 0.5,
                                        spec_m, mc_m, LSMConfig(poly_degree=deg), "merton",
                                        merton=mp)
        rel = p / berm - 1.0
        p4, se4 = float(np.mean(ps[:4])), math.sqrt(sum(x * x for x in ses[:4])) / 4
        res[f"J1_deg{deg}"] = dict(price=p, stderr=se, rel=rel, spread_pct=spread / berm * 100,
                                   rel_4_seeds=p4 / berm - 1.0, stderr_4_seeds=se4)
        log(f"[J1] Merton American put, degree {deg} + series CV, pooled over {J1_SEEDS} seeds "
            f"(2^18 x 50): {p:.6f} +- {se:.6f} (seeds " + ", ".join(f"{x:.6f}" for x in ps)
            + f"); COS-Bermudan oracle (50 dates) {berm:.6f}; rel {rel * 100:+.4f}% "
            f"({(p - berm) / se:+.2f} pooled stderr), seed spread {spread / berm * 100:.4f}%; "
            f"the first 4 seeds {p4:.6f} +- {se4:.6f}, rel {(p4 / berm - 1.0) * 100:+.4f}% (the "
            f"JAX package, 4 seeds: {BENCH_R05_MERTON_REL:.4%}, spread "
            f"{BENCH_R05_MERTON_SPREAD_PCT}%); gate "
            + (f"{J1_GATE:.2%}" if deg == 5 else f"{J1_DEGREE_GATE:.0%}"))
        if abs(rel) > (J1_GATE if deg == 5 else J1_DEGREE_GATE):
            fail(f"J1: the degree-{deg} Merton American put outside its gate")

    # J2: Europeans at 2^22 x 100 (terminal kernels 15, and 3 or 5 with 17).
    mc_e = MCConfig(n_paths=1 << 22, n_steps=100, path_block=4096)
    spec_p = OptionSpec(strike=100.0, rate=0.05, cp=PUT, sigma=None)
    legs = (("merton_european", "merton", dict(merton=mp), "euler",
             float(merton_price(100.0, 100.0, 0.5, 0.05, mp, cp=-1.0, dtype=torch.float64,
                                device="cpu"))),)
    cos_b = float(bates_cos_price(100.0, 100.0, 0.5, 0.05, bp, cp=-1.0, dtype=torch.float64,
                                  device="cpu"))
    legs += tuple((f"bates_european_{sch}", "bates", dict(bates=bp), sch, cos_b)
                  for sch in ("euler", "qe"))
    for i, (label, model, kw, scheme, ref) in enumerate(legs):
        sampler = make_terminal_sampler(model, 100.0, 0.05, 0.5, heston_scheme=scheme,
                                        device=DEVICE, **kw)
        p, se, _ = timed(label, price_european_mc, gen(31 + i), sampler, spec_p, 0.5, mc_e)
        p, se = float(p), float(se)
        gap = p - ref
        res[f"J2_{label}"] = dict(price=p, stderr=se, ref=ref, z=gap / se)
        log(f"[J2] {label} put (2^22 x 100): {p:.6f} +- {se:.6f}; "
            f"{'series' if model == 'merton' else 'COS'} f64 {ref:.6f}; gap {gap:+.6f} "
            f"({gap / ref * 100:+.4f}%, {gap / se:+.2f} stderr; gate 4 stderr + "
            f"{J2_BIAS:.1%})")
        if abs(gap) > 4.0 * se + J2_BIAS * ref:
            fail(f"J2: the {label} put outside its gate")

    # J3: the Bates American put (2^20 x 50, degree 5 / 3, COS CV, 4 seeds).
    mc_b = MCConfig(n_paths=1 << 20, n_steps=50, path_block=4096)
    lsm_b = LSMConfig(poly_degree=5, variance_basis_degree=3)
    p, se, spread, ps, _ = pooled("bates_american", 4, 100.0, 0.5, spec_p, mc_b, lsm_b, "bates",
                               bates=bp)
    z = (p - cos_b) / se
    res["J3"] = dict(price=p, stderr=se, premium=p - cos_b, premium_z=z)
    log(f"[J3] Bates American put, degree 5 / 3 + COS CV, pooled over 4 seeds (2^20 x 50): "
        f"{p:.6f} +- {se:.6f} (seeds " + ", ".join(f"{x:.6f}" for x in ps) + f"); COS "
        f"European {cos_b:.6f}; premium {p - cos_b:+.6f} ({z:+.2f} pooled stderr; gate >= "
        f"{J3_PREMIUM_Z}; BENCH_r05's bates_american_premium_z 21.57 at 2^17)")
    if z < J3_PREMIUM_Z:
        fail("J3: the Bates American put below its European")
    bp0 = BatesParams(heston=hp, lam=0.0, mu_j=-0.1, sigma_j=0.15)
    S_b, v_b = simulate_paths(gen(5), 100.0, 0.5, mc_b, "bates", rate=0.05, bates=bp0,
                              return_variance=True, device=DEVICE)
    S_h, v_h = simulate_paths(gen(5), 100.0, 0.5, mc_b, "heston", rate=0.05, heston=hp,
                              return_variance=True, device=DEVICE)
    plain = LSMConfig(poly_degree=5, variance_basis_degree=3, use_control_variate=False)
    pb0 = price_american_lsm(gen(6), 100.0, 0.5, spec_p, mc_b, plain, "bates", bates=bp0,
                             device=DEVICE)
    ph0 = price_american_lsm(gen(6), 100.0, 0.5, spec_p, mc_b, plain, "heston", heston=hp,
                             device=DEVICE)
    same = (torch.equal(S_b, S_h), torch.equal(v_b, v_h),
            all(torch.equal(a, b) for a, b in zip(pb0, ph0)))
    log(f"[J3] lam = 0 on one generator: Bates S == Heston S {same[0]}, v {same[1]}, plain "
        f"LSM price {float(pb0[0]):.6f} == {float(ph0[0]):.6f} bit for bit {same[2]}")
    if not all(same):
        fail("J3: at lam = 0 the Bates paths or price differ from Heston's")

    # J4: the 64 x 64 surfaces (16,384 x 50 per maturity), the app, merton_greeks.
    Ks = np.linspace(70.0, 130.0, SURFACE_MATS)
    Ts = np.linspace(0.1, 1.0, SURFACE_MATS)
    mc_s = MCConfig(n_paths=SURFACE_PATHS, n_steps=SURFACE_STEPS)
    for label, kw in (("bates_surface", dict(model="bates", bates=bp)),
                      ("merton_surface", dict(model="merton", merton=mp))):
        before = dict(cuda_heston.launches, **cuda_jumps.launches)
        P = timed(label, price_american_surface, gen(41), 100.0, Ks, Ts, 0.05, mc_s,
                  device=DEVICE, **kw).cpu().numpy()
        n = {k: v - before[k] for k, v in dict(cuda_heston.launches,
                                               **cuda_jumps.launches).items() if v > before[k]}
        worst = float(np.diff(P, axis=1).min())
        log(f"[J4] {label} 64 x 64 (16,384 x 50 per maturity): {secs[label][-1]:.3f} s; "
            f"launches {n}; finite {bool(np.isfinite(P).all())}; min step in K {worst:+.3e} "
            f"(gate -1e-3); middle cell {float(P[len(Ts) // 2, len(Ks) // 2]):.4f}")
        want = ({"heston_paths": 1, "jump_overlay_paths": 1} if label == "bates_surface"
                else {"merton_paths": 1})
        if not (np.isfinite(P).all() and worst >= -1e-3 and n == want):
            fail(f"J4: the {label}: not finite, not monotone in K, or launches {n} != {want}")
    csv_path = Path(__file__).resolve().parent / "build" / "calibrated_bates_surface.csv"
    csv_path.parent.mkdir(parents=True, exist_ok=True)
    before = cuda_jumps.launches["jump_overlay_paths"]
    # --max-iterations caps each L-BFGS-B start (2000 by default): on the
    # app's --test surface the fit ends at the same parameters and IV RMSE
    # in about a third of the time, keeping the script inside its limit.
    s4 = timed("app_bates_surface", app.run,
               app.parse_args(["--model", "bates", "--test", "--methods", "L-BFGS-B",
                               "--max-iterations", str(J4_APP_MAX_ITERATIONS),
                               "--price-surface", str(csv_path)]), device=DEVICE)
    n4 = cuda_jumps.launches["jump_overlay_paths"] - before
    lines = csv_path.read_text().splitlines()
    rows = np.array([[float(v) for v in ln.split(",")] for ln in lines[1:]])
    P = rows[:, 2].reshape(64, 64) if rows.shape == (4096, 3) else None
    worst = float(np.diff(P, axis=1).min()) if P is not None else -math.inf
    log(f"[J4] apps.calibrate --model bates --test --methods L-BFGS-B --max-iterations "
        f"{J4_APP_MAX_ITERATIONS} --price-surface: "
        f"{secs['app_bates_surface'][-1]:.3f} s; {s4['params']}, IV RMSE {s4['error']:.6g}; "
        f"{n4} launch of jump_overlay_paths; {len(lines) - 1} rows, header {lines[0]!r}; min "
        f"step in K {worst:+.3e} (gate -1e-3)")
    if not (n4 == 1 and lines[0] == "K,T,price" and P is not None and np.isfinite(P).all()
            and worst >= -1e-3):
        fail("J4: the calibrated Bates 64x64 surface: not one overlay launch, not 4096 finite "
             "rows, or not monotone in K")
    args = dict(S0=100.0, K=100.0, T=0.5, r=0.05, sigma=0.2, lam=1.0, mu_j=-0.1, sigma_j=0.15)
    g = merton_greeks(100.0, 100.0, 0.5, 0.05, mp, cp=-1.0, dtype=torch.float64,
                      device=DEVICE)

    def f(**kw):
        a = dict(args, **kw)
        return float(merton_price(a["S0"], a["K"], a["T"], a["r"],
                                  MertonParams(a["sigma"], a["lam"], a["mu_j"], a["sigma_j"]),
                                  cp=-1.0, dtype=torch.float64, device=DEVICE))

    def cd(name, h):
        x = args[name]
        return (f(**{name: x + h}) - f(**{name: x - h})) / (2 * h)

    h = 1e-4
    fd = {"Delta": cd("S0", h), "Theta": -cd("T", h) / 365.0, "Rho": cd("r", h) / 100.0,
          "Vega": cd("sigma", h) / 100.0, "dLam": cd("lam", h), "dMuJ": cd("mu_j", h),
          "dSigmaJ": cd("sigma_j", h),
          "Gamma": (f(S0=100.0 + 1e-2) - 2 * f() + f(S0=100.0 - 1e-2)) / 1e-4}
    worst = max(abs(float(g[k]) - v) / max(1.0, abs(v)) for k, v in fd.items())
    res["J4_greeks_worst"] = worst
    log("[J4] merton_greeks (f64 on the card) vs f64 central differences: "
        + ", ".join(f"{k} {float(g[k]):.9f} / {v:.9f}" for k, v in fd.items())
        + f"; worst {worst:.3e} (gate {J4_GREEKS_TOL})")
    if worst > J4_GREEKS_TOL:
        fail("J4: merton_greeks away from the central differences")
    res["phase_seconds"] = time.perf_counter() - t_phase
    log(f"[J] the jumps phase: {res['phase_seconds']:.1f} s (target 150 s)")
    return {k: statistics.median(v) for k, v in secs.items()}, res


def log_clocks(when: str) -> None:
    """The card's SM clock, power draw, power limit and temperature
    (nvidia-smi), logged beside a timing window."""
    import subprocess

    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit,"
                          "temperature.gpu", "--format=csv"], capture_output=True, text=True,
                         timeout=60, check=True)
    log(f"[5] nvidia-smi {when}: " + " | ".join(out.stdout.strip().splitlines()))


def merton_paths_shapes(seed, mp, spec, n_int: float, shapes: dict) -> dict:
    """Kernel 14 at each (n_mat, n_pad, n_steps) at which the jumps path
    launched it, ``shapes`` its launches there (cuda_jumps.shape_launches
    read after that path; J1 runs it at 1 x 2^18 x 50, J4's Merton surface
    at 64 x 16,384 x 50, one launch for the 64 maturities), in turns with
    its first design (first, new, new, first), which takes one launch a
    maturity: its time, bound and launches x (time - bound), the loss the
    redesign queue ranks it by, beside the first design's n_mat launches at
    one maturity (T = 0.5) and their loss."""
    import numpy as np

    from options_model_tpu_torch.ops import cuda_jumps as cj
    from options_model_tpu_torch.utils.profiling import time_per_call

    out = {}
    for (n_mat, n, steps), launches in sorted(shapes.items(), reverse=True):
        Ts = [0.5] if n_mat == 1 else np.linspace(0.1, 1.0, n_mat).astype(np.float32).tolist()
        new = lambda: cj.merton_paths_batched(seed, 100.0, 0.05, Ts, mp, n, steps,  # noqa: E731
                                              device=DEVICE)
        first = lambda: cj.merton_paths_first(seed, 100.0, 0.05, 0.5, mp, n, steps,  # noqa: E731
                                              device=DEVICE)
        turns = [time_per_call(f, N_TIMED) for f in (first, new, new, first)]
        ms, first_one = (turns[1] + turns[2]) / 2, (turns[0] + turns[3]) / 2
        b = bound(n_mat * n, steps, spec["ops"], n_int, n_mat * (steps + 1) * n * 4)
        b1 = bound(n, steps, spec["ops"], n_int, (steps + 1) * n * 4)
        loss = launches * (ms - b["bound_ms"])
        first_loss = launches * n_mat * (first_one - b1["bound_ms"])
        out[f"{n_mat}x{n}x{steps}"] = dict(ms=ms, launches=launches, loss_ms=loss, turns=turns,
                                           earlier_ms=n_mat * first_one,
                                           earlier_launches=launches * n_mat,
                                           earlier_loss_ms=first_loss, **b)
        log(f"[5] merton_paths at {n_mat} x {n} x {steps}: {ms:.4f} ms, bound "
            f"{b['bound_ms']:.4f} ms by {b['bound_term']} ({b['bound_ms'] / ms * 100:.1f}%); "
            f"{launches} launches on the jumps path: loss {launches} x ({ms:.4f} - "
            f"{b['bound_ms']:.4f}) = {loss:.3f} ms; first design {first_one:.4f} ms a "
            f"maturity ({b1['bound_ms'] / first_one * 100:.1f}% of its {b1['bound_ms']:.4f}), "
            f"{launches * n_mat} launches: loss {first_loss:.3f} ms (turns "
            + ", ".join(f"{t:.4f}" for t in turns) + ")")
    return out


def phase_jump_timing(per_call: float, shapes: dict) -> dict:
    """CUDA-event medians of kernels 14-17 and of their plain versions at
    their timed shapes (Merton paths 2^20 x 50, terminal 2^22 x 100; the
    overlay on a 2^20 x 50 Heston matrix and on 2^22 terminal values, in
    place), each beside its bound; registers and occupancy; each in turns
    with its first design; kernel 14 also at the jumps
    path's own shapes, ``shapes`` (merton_paths_shapes). The card's clocks
    and power are logged before and after."""
    from options_model_tpu_torch.ops import cuda_heston as ch
    from options_model_tpu_torch.ops import cuda_jumps as cj
    from options_model_tpu_torch.utils.profiling import time_per_call

    seed, mp, _, jb, _, hp = _jump_inputs()
    S = ch.heston_paths(seed, 100.0, 0.05, 0.5, hp, 1 << 20, 50, device=DEVICE)
    S_T = ch.heston_terminal(seed, 100.0, 0.05, 0.5, hp, 1 << 22, 100, device=DEVICE)
    runs = {
        "merton_paths": lambda plain: (cj.merton_paths_reference if plain else cj.merton_paths)(
            seed, 100.0, 0.05, 0.5, mp, 1 << 20, 50, device=DEVICE),
        "merton_terminal": lambda plain: (cj.merton_terminal_reference if plain
                                          else cj.merton_terminal)(
            seed, 100.0, 0.05, 0.5, mp, 1 << 22, 100, device=DEVICE),
        "jump_overlay_paths": lambda plain: (cj.jump_overlay_paths_reference if plain
                                             else cj.jump_overlay_paths)(S, seed, 0.5, jb),
        "jump_overlay_terminal": lambda plain: (cj.jump_overlay_terminal_reference if plain
                                                else cj.jump_overlay_terminal)(
            S_T, seed, 0.5, jb, 100),
    }
    firsts = {
        "merton_paths": lambda: cj.merton_paths_first(seed, 100.0, 0.05, 0.5, mp, 1 << 20, 50,
                                                      device=DEVICE),
        "merton_terminal": lambda: cj.merton_terminal_first(seed, 100.0, 0.05, 0.5, mp, 1 << 22,
                                                            100, device=DEVICE),
        "jump_overlay_paths": lambda: cj.jump_overlay_paths_first(S, seed, 0.5, jb),
        "jump_overlay_terminal": lambda: cj.jump_overlay_terminal_first(S_T, seed, 0.5, jb, 100),
    }
    attrs = cj.jumps_kernel_attrs()
    out = {}
    log_clocks("before the jump kernels' turns")
    for k in jump_specs():
        name = k["name"]
        n, steps = k["timed"]
        turns = None
        if name in firsts:
            # in turns with the first design: first, new, new, first
            new = lambda: runs[name](False)  # noqa: E731
            turns = [time_per_call(f, N_TIMED) for f in (firsts[name], new, new, firsts[name])]
            ms = (turns[1] + turns[2]) / 2
        else:
            ms = time_per_call(lambda: runs[name](False), N_TIMED)
        plain_ms = time_per_call(lambda: runs[name](True), 3)
        n_int = int_ops(k["draws"], per_call)
        b = bound(n, steps, k["ops"], n_int, k["bytes"])
        a = attrs[name]
        out[name] = dict(ms=ms, plain_ms=plain_ms, registers=a["registers"],
                         spill_bytes=a["spill_bytes"], block=a["block"],
                         occupancy=a["blocks_per_sm"] * a["block"] / THREADS_PER_SM, **b)
        if turns is not None:
            out[name].update(first_design_row(f"{name}_first", k["source"], f"{n} x {steps}",
                                              turns, b["bound_ms"], attrs[f"{name}_first"]))
        if name == "merton_paths":
            out[name]["path_shapes"] = merton_paths_shapes(seed, mp, k, n_int, shapes)
        log(f"[5] {name} {n} paths x {steps} steps: kernel {ms:.4f} ms "
            f"({n * steps / ms * 1e3:.4e} path-steps/s, {k['bytes'] / ms / 1e9:.3f} TB/s "
            f"moved), plain {plain_ms:.4f} ms; bound {b['bound_ms']:.4f} ms by "
            f"{b['bound_term']} ({k['ops']:.2f} f32 operations and {n_int:.2f} int32 "
            f"instructions per path-step, {k['bytes'] / 1e6:.1f} MB moved); "
            f"{b['bound_ms'] / ms * 100:.1f}% of bound; {a['registers']} registers, "
            f"{a['spill_bytes']} spill bytes, {a['blocks_per_sm']} blocks of {a['block']} "
            f"per SM ({out[name]['occupancy'] * 100:.1f}% occupancy)")
    log_clocks("after the jump kernels' turns")
    return out


# The martingale dual (pricers/dual.py; ROADMAP item 1): kernels 18-19 of
# csrc/dual.cu and the brackets D1-D5.
# Kernel 18's ce against its plain version on the same Philox bits: the
# inner states come out bit for bit (the same IEEE operations in the same
# order, libdevice's expf being torch's), so the in-the-money gate decides
# alike, and only the floor's logf, erfcf and divisions round apart: ~3 ulps
# of a value ~5 (1.5e-5 measured at 2^14 x 50 x 64). Held at 1e-6 of K,
# both designs (the redesign's floor and polynomial contract into FMAs and
# take log x' as log xp + e).
DUAL_CE_ATOL = 1e-4
# The upper bound assembled from the redesign's ce against the first
# design's on the same paths, policy and stream: within this many of its
# stderr.
DUAL_UPPER_SE = 0.1
DUAL_STATE_RTOL = 1e-6          # kernel 19's x' and v' (measured bit for bit)
DUAL_LAM0_RTOL = 2e-5           # Bates at lam = 0 against Heston (tests/test_dual.py:459)
DUAL_SLACK = 0.0015             # the 50-date bracket against a continuous-exercise oracle
DUAL_HIGH_BAR = 0.01            # GBM, Heston: high <= 1.01 oracle (1.015 for the NN policy)
DUAL_NN_HIGH_BAR = 0.015
# Width bars (fractions of the oracle): GBM 1.5%, Heston 2%, Merton 5%,
# Bates 6%, the NN policy 3% (tests/test_dual.py).
DUAL_WIDTH = {"D1": 0.015, "D2": 0.02, "D3": 0.05, "D4": 0.06, "D5": 0.03}
# BENCH_r05's brackets (the JAX package on the TPU: estimator bars, not speeds).
BENCH_R05_GBM_WIDTH_PCT, BENCH_R05_GBM_UPPER = 0.4302, 0.001467
BENCH_R05_HESTON_WIDTH_PCT, BENCH_R05_HESTON_UPPER = 0.2452, 0.003107
DUAL_INNER = 64
# f32 operations per surrogate evaluation (an inner pair's member), counted
# from csrc/dual.cu (each add, multiply, compare and min/max one, a
# transcendental one): the surrogate ~50 (u 4, the cubic 8, the (x-1)^+
# term 4, the gate and clip 5, h 2, the Black-Scholes floor 25, the maxima
# 2), the GBM step 4, the sum 1, Box-Muller's 11 per two normals; Heston
# the Euler step ~9.5, the floor's effective vol 8 and the variance terms
# 12 more; the jumps' count, sums and Box-Muller ~6.
OPS_DUAL = {"gbm": 50 + 4 + 1 + 11 / 4, "heston": 50 + 12 + 9.5 + 8 + 1 + 11 / 2}
OPS_DUAL.update(merton=OPS_DUAL["gbm"] + 6.4, bates=OPS_DUAL["heston"] + 6.4)
# Kernel 19 per state: the step, Box-Muller and the store's address.
OPS_DUAL_STATES = {"gbm": 4 + 11 / 4 + 1, "heston": 9.5 + 11 / 2 + 2}
# Philox draws per evaluation (calls, words made uniform): a diffusion call
# serves 8 (GBM) or 4 (Heston) members, a jump call 4.
DRAWS_DUAL = {"gbm": (1 / 8, 1 / 2), "heston": (1 / 4, 1), "merton": (3 / 8, 3 / 2),
              "bates": (1 / 2, 2)}


def dual_specs():
    """Kernels 18-19 (csrc/dual.cu): name, source, the XLA function they
    replace, the paths that run them, their launch counter."""
    from options_model_tpu_torch.ops import cuda_dual as cd

    src = "options_model_tpu_torch/csrc/dual.cu"
    return [
        dict(name="dual_ce", source=src,
             replaces="options_model_tpu/pricers/dual.py:292 (date_ce, :579-620, :706-735)",
             paths=("dual",), counter=(cd.launches, "dual_ce")),
        dict(name="dual_inner_states", source=src,
             replaces="options_model_tpu/pricers/dual.py:847 (date_ce, :910-962)",
             paths=("dual",), counter=(cd.launches, "dual_inner_states")),
    ]


def _dual_params():
    from options_model_tpu_torch.core.config import BatesParams, HestonParams, MertonParams

    hp = HestonParams(kappa=2.0, theta=0.04, xi=0.3, rho=-0.7, v0=0.04)
    return dict(heston=hp, merton=MertonParams(**MERTON_BENCH),
                bates=BatesParams(heston=hp, **BATES_JUMPS))


# The brackets' shapes (paths), D1-D4: bench.py's GBM (2^18) and Heston
# (2^17) legs, J1's Merton and J3's Bates puts at 2^18, all x 50 dates.
DUAL_SHAPES = {"gbm": 1 << 18, "heston": 1 << 17, "merton": 1 << 18, "bates": 1 << 18}


def dual_case(model: str, n_paths: int, seed: int = 5, cp: float = -1.0,
              degree: int = 3) -> dict:
    """A model's bracket inputs: the port's paths (kernels 2, 4, 14, 16) at
    n_paths x 50 as S (and v), the policy fitted on them at ``degree``, x =
    S / K, its policy rows, the law and the dates' taus. A put (cp = -1) as
    the brackets price, or a call (cp = 1) on a dividend payer (q 0.03)."""
    import torch

    from options_model_tpu_torch.core.config import MCConfig, OptionSpec
    from options_model_tpu_torch.ops import cuda_dual
    from options_model_tpu_torch.pricers import american as pa
    from options_model_tpu_torch.pricers import dual as pd

    sv = model in ("heston", "bates")
    spec = OptionSpec(strike=100.0, rate=0.05, cp=cp, sigma=None if sv else 0.2,
                      div_yield=0.03 if cp > 0 else 0.0)
    kw = _dual_params()
    mc = MCConfig(n_paths=n_paths, n_steps=50, path_block=4096)
    out = pa.simulate_paths(torch.Generator(DEVICE).manual_seed(seed), 100.0, 0.5, mc, model,
                            sigma=spec.sigma, rate=0.05, div_yield=spec.div_yield,
                            return_variance=sv, device=DEVICE, **kw)
    S, v = out if sv else (out, None)
    policy, _ = pd.fit_lsm_policy(S, spec, 0.5, v_paths=v, poly_degree=degree)
    taus = torch.from_numpy(pd.date_taus(0.5, 50)).to(DEVICE)
    law = pd.inner_law(model, spec, 0.5, 50, **kw)
    return dict(S=S, v=v, spec=spec, policy=policy, law=law, taus=taus,
                x=S / torch.tensor(law.K, device=DEVICE),
                rows=cuda_dual.policy_rows(policy, taus))


def dual_upper_both(model: str, case: dict, seed: int, tile: int, tag: str = "D0") -> dict:
    """The dual upper bound of a bracket's ``case`` (dual_case or
    rough_dual_case) assembled (pricers/dual._dual_assemble, out of sample,
    pair-block stderr) from kernel 18's redesign and from its first design
    on the same paths, policy and stream (VG's terminal step from
    dual_vg_terminal, the same for both); fails unless the two are within
    DUAL_UPPER_SE of the redesign's stderr."""
    from options_model_tpu_torch.ops import cuda_dual as cd
    from options_model_tpu_torch.pricers import american as pa
    from options_model_tpu_torch.pricers import dual as pd

    S, x, v, law = case["S"], case["x"], case["v"], case["law"]
    hist, comp, n_dates = case.get("hist"), case.get("comp"), case["rows"].shape[0]
    w_vals, e_h = pd._observed_terms(x, v, law, case["policy"], case["taus"])
    if e_h is None:
        e_h = cd.dual_vg_terminal(x[n_dates].contiguous(), law, seed, 0, tile, DUAL_INNER, n_dates)
    _, eval_mask = pa.oos_masks(S.shape[1], tile, S.dtype, DEVICE)
    out = {}
    for name, fn in (("redesign", cd.dual_ce), ("first", cd.dual_ce_first)):
        ce = fn(x, v, case["rows"], law, seed, 0, tile, DUAL_INNER, hist, comp)
        up, se = pd._dual_assemble(S, case["spec"], case.get("T", 0.5), w_vals, ce, e_h,
                                   eval_mask, tile)
        out[name] = (float(up), float(se))
    (up, se), (up1, se1) = out["redesign"], out["first"]
    log(f"[{tag}] {model} at {S.shape[1]} x {S.shape[0] - 1}: the upper from the redesign's ce "
        f"{up:.6f} +- {se:.6f}, from the first design's {up1:.6f} +- {se1:.6f}: |d| "
        f"{abs(up - up1):.3e} = {abs(up - up1) / se:.4f} stderr (gate {DUAL_UPPER_SE})")
    if not (math.isfinite(up) and abs(up - up1) <= DUAL_UPPER_SE * se):
        fail(f"dual {model}: the upper from the redesign's ce differs from the first design's")
    return dict(upper=up, upper_first=up1, stderr=se, d_stderr=abs(up - up1) / se)


# D0's cases of kernel 18 at 2 tiles beside the brackets' (put, degree 3):
# each family's call instance, and the run-time degree at 5 and 2.
DUAL_D0_CASES = ((1.0, 3), (-1.0, 5), (1.0, 2))


def phase_dual_kernels() -> tuple:
    """D0: kernels 18 (its redesign and its first design) and 19 against
    their plain versions on the card, for each family at 2 tiles and at its
    bracket's shape (DUAL_SHAPES x 50, n_inner 64, a put at degree 3), and
    kernel 18 also at 2 tiles for DUAL_D0_CASES (calls, degrees 5 and 2),
    so every instance of the redesign (family x side) runs: the dual
    stream's Philox words bit for bit, kernel 19's Poisson counts bit for
    bit and its states within DUAL_STATE_RTOL, both designs' ce within
    DUAL_CE_ATOL (and the redesign's largest difference from the first
    design printed), bit-equal first_tile chunks of both designs in every
    case and of kernel 19's states, and at the bracket's shape the upper
    bound from either design's ce within DUAL_UPPER_SE stderr. Fails if an
    instance of the redesign has local memory or was not run. Returns the
    largest errors by kernel and the brackets' cases by model."""
    import torch

    from options_model_tpu_torch.ops import cuda_dual as cd
    from options_model_tpu_torch.ops.philox import DUAL_STREAM, stream_words, stream_words_cuda

    seed, tile = 0x5DEECE66D, 4096
    attrs = cd.dual_kernel_attrs()
    local = {k: a["spill_bytes"] for k, a in attrs.items() if k.startswith("dual_ce ")
             or k.startswith("dual_ce_call ")}
    log("[D0] kernel 18's redesign, registers / local bytes a thread: "
        + ", ".join(f"{k} {attrs[k]['registers']} / {n}" for k, n in local.items()))
    if any(local.values()):
        fail(f"an instance of kernel 18's redesign has local memory: {local}")
    errs = {"dual_ce": dict(max_abs_err=0.0, mean_abs_err=0.0, earlier_max_abs_err=0.0,
                            max_abs_diff_first=0.0, upper_d_stderr=0.0),
            "dual_inner_states": dict(max_abs_err=0.0, max_rel_err=0.0)}
    w = stream_words_cuda(seed, 3, 2, tile, 24, DEVICE, stream=DUAL_STREAM)
    if not torch.equal(w.cpu(), stream_words(seed, 3, 2, tile, 24, stream=DUAL_STREAM)):
        fail("the dual stream's Philox words differ from the plain version's")
    log("[D0] the dual stream's Philox words (counter word 3 = 2), 2 tiles x 24 draws: kernel "
        "== plain bit for bit")
    args = (seed, 0, tile, DUAL_INNER)
    cases, ran = {}, set()
    for model, n_paths in DUAL_SHAPES.items():
        runs = ([(2 * tile, -1.0, 3)] + [(2 * tile, cp, deg) for cp, deg in DUAL_D0_CASES]
                + [(n_paths, -1.0, 3)])
        for n, cp, degree in runs:
            c = dual_case(model, n, cp=cp, degree=degree)
            x, v, rows, law = c["x"], c["v"], c["rows"], c["law"]
            what = f"{model} {'call' if law.cp > 0 else 'put'} at degree {degree}, {n} x 50"
            ce = cd.dual_ce(x, v, rows, law, *args)
            ce1 = cd.dual_ce_first(x, v, rows, law, *args)
            ref = cd.dual_ce_reference(x, v, rows, law, *args)
            torch.cuda.synchronize()
            d, d1, dd = (ce - ref).abs(), (ce1 - ref).abs(), (ce - ce1).abs()
            for name, got, dev in (("dual_ce", ce, d), ("dual_ce_first", ce1, d1)):
                if not bool(torch.isfinite(got).all()) or float(dev.max()) > DUAL_CE_ATOL:
                    fail(f"{name} {what}: ce differs from the plain version (max "
                         f"{float(dev.max()):.3e}, atol {DUAL_CE_ATOL})")
            e = errs["dual_ce"]
            e["max_abs_err"] = max(e["max_abs_err"], float(d.max()))
            e["mean_abs_err"] = max(e["mean_abs_err"], float(d.mean()))
            e["earlier_max_abs_err"] = max(e["earlier_max_abs_err"], float(d1.max()))
            e["max_abs_diff_first"] = max(e["max_abs_diff_first"], float(dd.max()))
            ran.add((model, law.cp > 0))
            half = n // 2 // tile * tile
            xh = x[:, half:].contiguous()
            vh = None if v is None else v[:, half:].contiguous()
            part = cd.dual_ce(xh, vh, rows, law, seed, half // tile, tile, DUAL_INNER)
            part1 = cd.dual_ce_first(xh, vh, rows, law, seed, half // tile, tile, DUAL_INNER)
            torch.cuda.synchronize()
            if not (torch.equal(ce[:, half:], part) and torch.equal(ce1[:, half:], part1)):
                fail(f"dual_ce {what}: a first_tile chunk differs from the full run's slice")
            log(f"[D0] {what}, n_inner {DUAL_INNER}: dual_ce == plain within {DUAL_CE_ATOL} "
                f"(max |d| {float(d.max()):.3e}, mean {float(d.mean()):.3e}; first design "
                f"{float(d1.max()):.3e}, mean {float(d1.mean()):.3e}; redesign - first design "
                f"max {float(dd.max()):.3e}, mean {float(dd.mean()):.3e}); first_tile="
                f"{half // tile} chunks of both designs bit for bit")
            if (cp, degree) != (-1.0, 3):
                continue
            xs, vs, cn = cd.dual_inner_states(x, v, law, *args, 0, 4, return_counts=True)
            xr, vr, cr = cd.dual_inner_states_reference(x, v, law, *args, 0, 4,
                                                         return_counts=True)
            ps = cd.dual_inner_states(xh, vh, law, seed, half // tile, tile, DUAL_INNER, 0, 4)
            torch.cuda.synchronize()
            ds = (xs - xr).abs()
            rel = float((ds / xr).max())
            dv = 0.0 if vs is None else float(((vs - vr).abs() / (vr.abs() + 1e-8)).max())
            if rel > DUAL_STATE_RTOL or dv > DUAL_STATE_RTOL or not torch.equal(cn, cr):
                fail(f"dual_inner_states {what}: states (rel {rel:.3e}, v {dv:.3e}) or counts "
                     "differ from the plain version's")
            if not torch.equal(xs[..., half:], ps[0]):
                fail(f"dual_inner_states {what}: a first_tile chunk differs from the full "
                     "run's slice")
            e = errs["dual_inner_states"]
            e["max_abs_err"] = max(e["max_abs_err"], float(ds.max()))
            e["max_rel_err"] = max(e["max_rel_err"], rel, dv)
            log(f"[D0] {what}: dual_inner_states (dates 0-3) within rtol {DUAL_STATE_RTOL} (x' "
                f"{rel:.3e}, v' {dv:.3e}), {cn.numel()} counts bit for bit (max "
                f"{int(cn.max())}), its first_tile={half // tile} chunk bit for bit")
        cases[model] = c
        up = dual_upper_both(model, c, seed, tile)
        errs["dual_ce"]["upper_d_stderr"] = max(errs["dual_ce"]["upper_d_stderr"],
                                                up["d_stderr"])
    missed = {(m, call) for m in DUAL_SHAPES for call in (False, True)} - ran
    if missed:
        fail(f"D0 ran no case of kernel 18's instances {sorted(missed)}")
    return errs, cases


def phase_dual() -> tuple:
    """The dual path (ROADMAP item 1) through price_american_bracket: D1
    bench.py's GBM leg (2^18 x 50, degree 3, n_inner 64) against CRR(4096),
    D2 its Heston leg (2^17 x 50) against ADI, D3 J1's Merton put (2^18 x
    50) against the 50-date COS-Bermudan value, D4 J3's Bates put (2^18 x
    50) against the port's control-variate price and, at lam = 0, the Bates
    dual against the Heston dual, D5 the NN bracket (GBM, 2^16 x 50 x 64,
    the default net at NN_EPOCHS) against CRR. Gates: the JAX tests' bars.
    Returns (seconds per bracket, results)."""
    import torch

    from options_model_tpu_torch.core.config import (PUT, BatesParams, LSMConfig, MCConfig,
                                                      OptionSpec)
    from options_model_tpu_torch.pricers import american as pa
    from options_model_tpu_torch.pricers import dual as pd
    from options_model_tpu_torch.pricers.binomial import crr_american
    from options_model_tpu_torch.pricers.cos_bermudan import cos_bermudan_price

    t_phase = time.perf_counter()
    kw = _dual_params()
    put = OptionSpec(strike=100.0, rate=0.05, cp=PUT, sigma=0.2)
    sv_put = OptionSpec(strike=100.0, rate=0.05, cp=PUT, sigma=None)
    crr = crr_american(100.0, 100.0, 0.5, 0.05, 0.2, cp=-1.0, n_steps=4096)
    berm = cos_bermudan_price(100.0, 100.0, 0.5, 0.05, "merton", merton=kw["merton"], cp=-1.0,
                              n_dates=50)
    secs, res = {}, {}

    def bracket(label, gen_seed, spec, n_paths, **opts):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        br = pd.price_american_bracket(torch.Generator(DEVICE).manual_seed(gen_seed), 100.0,
                                       0.5, spec, MCConfig(n_paths=n_paths, n_steps=50,
                                                           path_block=4096),
                                       n_inner=DUAL_INNER, device=DEVICE, **opts)
        out = [float(b) for b in br]
        secs[label] = time.perf_counter() - t0
        if not all(math.isfinite(b) for b in out) or out[1] <= 0 or out[3] <= 0:
            fail(f"{label}: non-finite bracket {out}")
        return out

    def gated(label, name, out, oracle, oracle_name, slack, high_bar, bench=None):
        """The JAX tests' bars: contains ``oracle`` within 4 stderr (``slack``
        below it on the upper side), the width under DUAL_WIDTH, the upper
        under 1 + ``high_bar`` times the oracle (None: the reference's jump
        tests set no such bar)."""
        low, low_se, high, high_se = out
        width, upper = (high - low) / oracle, high / oracle - 1.0
        res[label] = dict(low=low, low_stderr=low_se, high=high, high_stderr=high_se,
                          oracle=oracle, width_pct=width * 100, upper_rel=upper,
                          seconds=secs[label])
        log(f"[{label}] {name}: [{low:.6f} +- {low_se:.6f}, {high:.6f} +- {high_se:.6f}]; "
            f"{oracle_name} {oracle:.6f}; width {width * 100:.4f}% (bar "
            f"{DUAL_WIDTH[label] * 100}%), upper {upper * 100:+.4f}%"
            + (f" (bar {high_bar * 100}%)" if high_bar is not None else " (no bar)")
            + (f"; BENCH_r05 width {bench[0]}%, upper {bench[1] * 100:+.4f}%" if bench else "")
            + f"; {secs[label]:.3f} s")
        if not (low - 4 * low_se <= oracle and high + 4 * high_se >= oracle * (1.0 - slack)):
            fail(f"{label}: the bracket does not contain {oracle_name} within 4 stderr")
        if width >= DUAL_WIDTH[label] or (high_bar is not None
                                          and high > oracle * (1.0 + high_bar)):
            fail(f"{label}: the bracket is looser than its bars")

    gated("D1", "GBM put bracket (bench.py's leg, 2^18 x 50, degree 3)",
          bracket("D1", 11, put, 1 << 18), crr, "CRR(4096)", DUAL_SLACK, DUAL_HIGH_BAR,
          (BENCH_R05_GBM_WIDTH_PCT, BENCH_R05_GBM_UPPER))
    gated("D2", "Heston put bracket (bench.py's leg, 2^17 x 50)",
          bracket("D2", 12, sv_put, 1 << 17, model="heston", heston=kw["heston"]),
          HESTON_ADI_ORACLE, "ADI", DUAL_SLACK, DUAL_HIGH_BAR,
          (BENCH_R05_HESTON_WIDTH_PCT, BENCH_R05_HESTON_UPPER))
    gated("D3", "Merton put bracket (J1's, 2^18 x 50, degree 3)",
          bracket("D3", 13, put, 1 << 18, model="merton", merton=kw["merton"]), berm,
          "COS-Bermudan (50 dates)", 0.0, None)

    # D4: the Bates bracket against the port's CV price (J3's put), 3 stderr.
    out = bracket("D4", 14, sv_put, 1 << 18, model="bates", bates=kw["bates"])
    p, se = (float(a) for a in pa.price_american(
        torch.Generator(DEVICE).manual_seed(15), 100.0, 0.5, sv_put,
        MCConfig(n_paths=1 << 18, n_steps=50, path_block=4096), LSMConfig(), "bates",
        bates=kw["bates"], device=DEVICE))
    low, low_se, high, high_se = out
    width = (high - low) / p
    res["D4"] = dict(low=low, low_stderr=low_se, high=high, high_stderr=high_se, cv_price=p,
                     cv_stderr=se, width_pct=width * 100, seconds=secs["D4"])
    log(f"[D4] Bates put bracket (J3's, 2^18 x 50): [{low:.6f} +- {low_se:.6f}, {high:.6f} +- "
        f"{high_se:.6f}]; the port's CV price {p:.6f} +- {se:.6f}; width {width * 100:.4f}% "
        f"(bar {DUAL_WIDTH['D4'] * 100}%); {secs['D4']:.3f} s")
    if not (low - 3 * low_se <= p <= high + 3 * high_se and width < DUAL_WIDTH["D4"]):
        fail("D4: the Bates bracket does not contain the CV price within 3 stderr, or is wide")
    # At lam = 0 the Bates dual (kernel 18's Bates instance) is the Heston dual.
    c = dual_case("heston", 1 << 17)
    S, v, policy = c["S"], c["v"], c["policy"]
    b0 = BatesParams(heston=kw["heston"], lam=0.0, mu_j=0.0, sigma_j=0.1)
    common = dict(v_paths=v, n_inner=DUAL_INNER, inner_block=4096)
    up_h, _ = pd.dual_upper_from_policy(21, S, sv_put, 0.5, policy, model="heston",
                                        heston=kw["heston"], **common)
    up_b, _ = pd.dual_upper_from_policy(21, S, sv_put, 0.5, policy, model="bates", bates=b0,
                                        **common)
    rel0 = abs(float(up_b) / float(up_h) - 1.0)
    res["D4"]["lam0_rel"] = rel0
    log(f"[D4] Bates dual at lam = 0 {float(up_b):.6f} against the Heston dual "
        f"{float(up_h):.6f} on the same paths and seed: rel {rel0:.3e} (rtol {DUAL_LAM0_RTOL})")
    if rel0 > DUAL_LAM0_RTOL:
        fail("D4: the Bates dual at lam = 0 differs from the Heston dual")

    gated("D5", f"NN-policy GBM put bracket (2^16 x 50 x {DUAL_INNER}, 128 x 3 net, "
          f"{NN_EPOCHS} epochs)",
          bracket("D5", 16, put, 1 << 16, lsm=LSMConfig(regressor="nn", nn_epochs=NN_EPOCHS)),
          crr, "CRR(4096)", DUAL_SLACK, DUAL_NN_HIGH_BAR)
    res["phase_seconds"] = time.perf_counter() - t_phase
    log(f"[D] the dual phase: {res['phase_seconds']:.1f} s")
    return secs, res


def sass_floors(sass: dict, key: str, evals: int) -> dict:
    """Kernel 18's issue and SFU floors at ``evals`` surrogate evaluations
    from the instructions and MUFU of SASS loop ``key`` a pass (SASS_EVALS
    evaluations): empty where phase_sass counted no loop."""
    n, mufu = sass.get("loops", {}).get(key), sass.get("mufu", {}).get(key)
    if not n:
        return {}
    ipe, mpe = n / SASS_EVALS[key], mufu / SASS_EVALS[key]
    return dict(instructions_per_eval=ipe, mufu_per_eval=mpe,
                issue_floor_ms=evals * ipe / PEAK_ISSUE * 1e3,
                mufu_floor_ms=evals * mpe / PEAK_MUFU * 1e3)


def dual_vg_floors(sass: dict, key: str, evals: int, half: int, passes, warp_tries: float) -> dict:
    """Issue and SFU floors of kernel 18's VG design ``key`` at ``evals``
    surrogate evaluations, ``half`` pairs a (date, path), from its loops
    (phase_sass, SASS_NESTED). The redesign, per warp and date: its first
    attempts a pass a pair, its walk a pass four pairs, the rest of its
    chunk loop once a chunk, its exact tests and retries at the run's
    ``passes`` (their means a warp and date, from the debug instance). The
    first design: its calls loop (SASS_EVALS, each attempt loop once) and
    its attempt loops again for each attempt a warp repeats, ``warp_tries``
    the mean over its pairs of the most attempts a lane's draw took. {}
    where phase_sass read no loops."""
    p = sass.get("nested", {}).get(key)
    if not p:
        return {}
    parts, m = p["parts"], p["mufu"]
    if key == "dual_ce vg":
        chunks = -(-half // DUAL_VG_CHUNK)
        walk = sum(-(-min(DUAL_VG_CHUNK, half - c) // 4) for c in range(0, half, DUAL_VG_CHUNK))
        n = {"first attempts": half, "exact tests": passes[0], "retries": passes[1],
             "walk": walk}
        rest = p["outer"] - sum(parts.values())
        rest_m = p["outer_mufu"] - sum(m.values())
        by_part = {r: parts[r] * n[r] / (2 * half) for r in n}
        by_part["rest"] = rest * chunks / (2 * half)
        ipe = sum(by_part.values())
        mpe = (rest_m * chunks + sum(m[r] * n[r] for r in n)) / (2 * half)
    else:
        tries = [r for r in parts if r.startswith("attempts")]
        body = sum(parts[r] for r in tries) / len(tries)
        body_m = sum(m[r] for r in tries) / len(tries)
        by_part = {"calls loop": p["outer"] / SASS_EVALS[key],
                   "repeated attempts": (warp_tries - 1) * body / 2}
        ipe = sum(by_part.values())
        mpe = p["outer_mufu"] / SASS_EVALS[key] + (warp_tries - 1) * body_m / 2
    return dict(instructions_per_eval=ipe, mufu_per_eval=mpe,
                issue_floor_ms=evals * ipe / PEAK_ISSUE * 1e3,
                mufu_floor_ms=evals * mpe / PEAK_MUFU * 1e3,
                instructions_per_eval_by_part=by_part)


def _terminal_warp_counts(n_live: int, half: int) -> tuple:
    """One warp of VG's terminal redesign with ``n_live`` paths of ``half``
    draws (0 to terminal_per_warp(half); every warp runs the chunks of that
    many): its chunks, its slots of 32 entries (a pass of the first attempts
    and of the walk each) and its sums' passes (a chunk's longest run of one
    path's values)."""
    from options_model_tpu_torch.ops.cuda_dual import CLOCK_ENTRIES, terminal_per_warp

    chunked, chunks, slots, sums = terminal_per_warp(half) * half, 0, 0, 0
    for c0 in range(0, chunked, CLOCK_ENTRIES):
        n = max(min(CLOCK_ENTRIES, n_live * half - c0), 0)
        chunks += 1
        slots += -(-min(CLOCK_ENTRIES, chunked - c0) // 32)
        sums += max((max(0, min((l + 1) * half - c0, n) - max(l * half - c0, 0))
                     for l in range(n_live)), default=0)
    return chunks, slots, sums


def dual_terminal_floors(sass: dict, key: str, n_paths: int, half: int, passes,
                         warp_tries: float) -> dict:
    """Issue and SFU floors of VG's terminal step design ``key`` at
    ``n_paths`` x ``half`` clock draws, per draw, from its loops (phase_sass,
    SASS_NESTED). The redesign, per warp of terminal_per_warp(half) paths:
    its first attempts and walk a pass a slot, its sums a pass a value of a
    chunk's longest run (_terminal_warp_counts; the last block's warps past
    the last path count too), the rest of its chunk loop once a chunk, its
    exact tests and retries at the run's ``passes`` (their means a warp of
    paths, from the debug instance). The first design: its draw loop
    (its attempt loop once) and its attempt loop again for each attempt a
    warp repeats, ``warp_tries`` the mean over draws and warps of the most
    attempts a lane's draw took. {} where phase_sass read no loops."""
    from options_model_tpu_torch.ops.cuda_dual import terminal_per_warp

    p = sass.get("nested", {}).get(key)
    if not p:
        return {}
    parts, m = p["parts"], p["mufu"]
    draws = n_paths * half
    if key == "dual_vg_terminal":
        per_warp = terminal_per_warp(half)
        full, rem = divmod(n_paths, per_warp)
        warps = full + (rem > 0)
        idle = -warps % 4                    # a block's warps past the last path
        counts = [full * c + idle * z for c, z in zip(_terminal_warp_counts(per_warp, half),
                                                       _terminal_warp_counts(0, half))]
        if rem:
            counts = [a + b for a, b in zip(counts, _terminal_warp_counts(rem, half))]
        chunks, slots, sums = counts
        n = {"first attempts": slots, "exact tests": passes[0] * warps,
             "retries": passes[1] * warps, "walk": slots, "sums": sums}
        by_part = {r: 32 * parts[r] * n[r] / draws for r in n}
        by_part["rest"] = 32 * (p["outer"] - sum(parts.values())) * chunks / draws
        ipe = sum(by_part.values())
        mpe = 32 * ((p["outer_mufu"] - sum(m.values())) * chunks
                    + sum(m[r] * n[r] for r in n)) / draws
    else:
        by_part = {"draw loop": p["outer"],
                   "repeated attempts": (warp_tries - 1) * parts["attempts"]}
        ipe = sum(by_part.values())
        mpe = p["outer_mufu"] + (warp_tries - 1) * m["attempts"]
    return dict(instructions_per_draw=ipe, mufu_per_draw=mpe,
                issue_floor_ms=draws * ipe / PEAK_ISSUE * 1e3,
                mufu_floor_ms=draws * mpe / PEAK_MUFU * 1e3,
                instructions_per_draw_by_part=by_part)


def phase_dual_timing(sass: dict, secs: dict, launches: dict, cases: dict) -> dict:
    """CUDA-event medians of kernel 18 at each bracket's shape (49 dates x
    DUAL_SHAPES x 64 inner draws, on D0's ``cases``), its redesign in turns
    with its first design (first, new, new, first), with the issue and SFU
    floors from their SASS (both designs under GBM and Heston, the redesign
    under Merton and Bates), and of kernel 19 at D5's chunk (4
    dates x 2^16 x 64), with their plain versions' (kernel 18's: one run;
    19's: 3) and their bounds; registers and occupancy; seconds per bracket
    with the kernels' share. The JSON row of kernel 18 is its GBM instance
    at D1's shape."""
    import torch

    from options_model_tpu_torch.ops import cuda_dual as cd
    from options_model_tpu_torch.pricers import dual as pd
    from options_model_tpu_torch.utils.profiling import time_per_call

    per_call = sass["per_call"]
    attrs = cd.dual_kernel_attrs()
    seed, tile, n_dates = 0x5DEECE66D, 4096, 49
    out = {"dual_ce": {}, "dual_inner_states": {}}
    for model, n in DUAL_SHAPES.items():
        c = cases[model]
        x, v, rows, law = c["x"], c["v"], c["rows"], c["law"]
        args = (seed, 0, tile, DUAL_INNER)
        run = lambda: cd.dual_ce(x, v, rows, law, *args)  # noqa: E731
        first = lambda: cd.dual_ce_first(x, v, rows, law, *args)  # noqa: E731
        turns = [time_per_call(f, N_TIMED) for f in (first, run, run, first)]
        ms = (turns[1] + turns[2]) / 2
        # the plain version takes seconds a call: one run, after D0's
        plain_ms = time_per_call(lambda: cd.dual_ce_reference(x, v, rows, law, *args), 1, 0)
        b = bound(n_dates * n, DUAL_INNER, OPS_DUAL[model], int_ops(DRAWS_DUAL[model], per_call),
                  n_dates * n * 4 * (3 if v is not None else 2))
        a = attrs[f"dual_ce {model}"]
        row = dict(ms=ms, plain_ms=plain_ms, registers=a["registers"],
                   spill_bytes=a["spill_bytes"], block=a["block"],
                   occupancy=a["blocks_per_sm"] * a["block"] / THREADS_PER_SM, **b)
        out["dual_ce"][model] = row
        evals = n_dates * n * DUAL_INNER
        log(f"[5] dual_ce {model} at {n_dates} x {n} x {DUAL_INNER}: kernel {ms:.4f} ms "
            f"({evals / ms * 1e3:.4e} evaluations/s), plain {plain_ms:.4f} ms; bound "
            f"{b['bound_ms']:.4f} ms by {b['bound_term']} ({OPS_DUAL[model]:.2f} f32 operations "
            f"an evaluation); {b['bound_ms'] / ms * 100:.1f}% of bound; {a['registers']} "
            f"registers, {a['spill_bytes']} spill bytes, {row['occupancy'] * 100:.1f}% occupancy")
        row.update(first_design_row("dual_ce_first", "options_model_tpu_torch/csrc/dual.cu",
                                    f"{n_dates} x {n} x {DUAL_INNER}", turns, b["bound_ms"],
                                    attrs[f"dual_ce_first {model}"]))
        for key, label, t in ((f"dual_ce {model}", "redesign", ms),
                              (f"dual_ce {model}, first design", "first design",
                               row["earlier_ms"])):
            fl = sass_floors(sass, key, evals)
            if not fl:
                continue
            row.update(fl if label == "redesign" else {f"earlier_{k}": x for k, x in fl.items()})
            log(f"[5] dual_ce {model} {label}: {fl['instructions_per_eval']:g} SASS instructions "
                f"an evaluation ({fl['mufu_per_eval']:g} MUFU): issue floor "
                f"{fl['issue_floor_ms']:.4f} ms ({fl['issue_floor_ms'] / t * 100:.1f}% of its "
                f"{t:.4f} ms), SFU floor {fl['mufu_floor_ms']:.4f} ms; bound {b['bound_ms']:.4f}")
        if model in ("gbm", "heston"):
            m = n if model == "heston" else 1 << 16
            if m != n:
                c = dual_case(model, m)
                x, v = c["x"], c["v"]
            chunk = max(1, pd.NN_CHUNK_ROWS // (DUAL_INNER * m))
            ms = time_per_call(lambda: cd.dual_inner_states(x, v, law, *args, 0, chunk), N_TIMED)
            plain_ms = time_per_call(lambda: cd.dual_inner_states_reference(
                x, v, law, *args, 0, chunk), 3)
            states = chunk * m * DUAL_INNER
            b = bound(chunk * m, DUAL_INNER, OPS_DUAL_STATES[model],
                      int_ops(DRAWS_DUAL[model], per_call),
                      states * 4 * (2 if v is not None else 1) + chunk * m * 4)
            a = attrs[f"dual_inner_states {model}"]
            out["dual_inner_states"][model] = dict(
                ms=ms, plain_ms=plain_ms, registers=a["registers"],
                spill_bytes=a["spill_bytes"], block=a["block"],
                occupancy=a["blocks_per_sm"] * a["block"] / THREADS_PER_SM, chunk=chunk, **b)
            log(f"[5] dual_inner_states {model} at {chunk} x {m} x {DUAL_INNER}: kernel "
                f"{ms:.4f} ms ({states * 4 / ms / 1e9:.3f} TB/s of x' written), plain "
                f"{plain_ms:.4f} ms; bound {b['bound_ms']:.4f} ms by {b['bound_term']}; "
                f"{b['bound_ms'] / ms * 100:.1f}% of bound; {a['registers']} registers, "
                f"{out['dual_inner_states'][model]['occupancy'] * 100:.1f}% occupancy")
    share = {"D1": ("gbm", "dual_ce", 1), "D2": ("heston", "dual_ce", 1),
             "D3": ("merton", "dual_ce", 1), "D4": ("bates", "dual_ce", 1),
             "D5": ("gbm", "dual_inner_states", -(-n_dates // out["dual_inner_states"]["gbm"]
                                                   ["chunk"]))}
    for label, (model, name, n_launch) in share.items():
        k_ms = n_launch * out[name][model]["ms"]
        log(f"[5] dual bracket {label}: {secs[label]:.3f} s (host clock to synchronize), "
            f"{name} {n_launch} x {out[name][model]['ms']:.4f} ms = "
            f"{k_ms / 1e3 / secs[label] * 100:.3f}% of it")
    log(f"[5] dual path launches: {launches}")
    return out


# The IV-surface path (phase_ivnn, the [V] lines). V1 fits the network
# through apps.train_surface --test (the synthetic smile, 50 epochs, hidden
# 64, 4 blocks, dropout 0.1) once at the CLI's defaults (seed 42: the model
# of V2 and V3) and at IVNN_TEST_SEEDS, and with SurfaceTrainConfig() on the
# recorded chain at its rate 0.045 at IVNN_CHAIN_SEEDS. One fit moves with
# the last bits of its arithmetic and its random streams: over 40 seeds the
# JAX package's own --test best_val_loss has a log sd of 0.85 (its IQR spans
# 3x), so a single seed's 1.5x would fail the reference itself at ~4 seeds
# in 10. V1 holds geometric means over the seeds instead, to IVNN_FIT_GATE x
# the JAX package's over seeds 0-39 at the same configs (measured on the CPU,
# x86-64, JAX_PLATFORMS=cpu, by scripts/ivnn_jax_bars.py): the --test fits'
# IV RMSE against the synthetic oracle (log sd 0.50), the chain fits' IV
# RMSE against the quotes and best_val_loss (log sd 0.052, 0.28). The
# --test best_val_loss is too wide for a ratio on 20 seeds: its geometric
# mean is printed beside the JAX package's, and the fit at the CLI's
# defaults is held to the JAX test's own bars (IV RMSE < 0.02, best_val_loss
# < 1e-3, tests/test_surface.py:105-114), which a 50-epoch fit misses at
# ~0.5% of seeds (the lognormal tail of the RMSE above).
IVNN_TEST_SEEDS = tuple(range(20))
IVNN_CHAIN_SEEDS = tuple(range(6))
IVNN_TEST_RMSE_BAR = 0.02
IVNN_TEST_VAL_BAR = 1e-3
JAX_IVNN_TEST_RMSE = 0.005403279235222716    # geometric means over seeds 0-39
JAX_IVNN_TEST_VAL = 2.7499163605468768e-05
JAX_IVNN_CHAIN_RMSE = 0.008219045392833106
JAX_IVNN_CHAIN_VAL = 2.866490158280889e-05
IVNN_FIT_GATE = 1.5
# Kernel 20 (csrc/philox.cu path_normals_kernel) against path_normals: the
# same Philox words, the Box-Muller of kernels 7 and 8 (hopper_fast.cuh
# box_muller_fast: SFU lg2, sqrt and sincos), ~3e-6 absolute a normal.
NORMALS_ATOL = 1e-5
# V2: the table route (kernels 7 and 8) against the bare route (kernel 20's
# normals, the network in the time loop) on the same seed: the same normals,
# so the prices differ by the table's approximation of the network. The
# network learns the smile's |log m| kink, which a Chebyshev table of the
# default degree 7 holds to ~5e-3 in sigma (a ~0.5% gap in the ATM call's
# price, printed); degree IVNN_TABLE_DEGREE (kernels 7 and 8's run-time
# degree) holds it to ~5e-4, and the gate is on that table.
IVNN_ROUTE_RTOL = 1e-3
IVNN_TABLE_DEGREE = 17
IVNN_BF16_RTOL = 0.02          # the bare route in bf16 against f32 (tests/test_surface.py:193)
IVNN_T = 0.25                  # the V2 option's expiry, inside the smile's 30-90 days
# V4: SVI's Dupire local vol on Heston-COS smiles (tests/test_svi.py:105-134).
# That test's gate, 4 stderr + 1% of the COS price, holds at its 262,144
# paths but not at V4's: the JAX package itself prices the K = 90 call
# -1.42% +- 0.04% from COS at 2^22 paths (the method: the linear-in-w
# interpolation from the T = 0 anchor), beyond 4 stderr + 1%. So V4 holds
# the port to the JAX package's own prices at the same surface, expiry and
# steps (scripts/ivnn_jax_bars.py: 4 seeds x 2^20 paths pooled, the stderr
# over paths), within 4 combined stderr, plus for the table route its
# approximation of the local vol (SVI_TABLE_RTOL of the price); the gap to
# COS is printed beside the JAX package's.
JAX_SVI_LV = {(100, 90.0): (15.302627983146575, 0.006426419728238094),
              (100, 100.0): (8.510405736917905, 0.0050876568427031185),
              (100, 110.0): (3.8185462980471683, 0.003498322032653549),
              (48, 90.0): (15.301350935461308, 0.006435666868350401),
              (48, 100.0): (8.512997458863651, 0.005097302646882019),
              (48, 110.0): (3.827002234807812, 0.0035077763434592595)}
# The degree-IVNN_TABLE_DEGREE table holds the SVI local vol to ~5e-3 in
# sigma over its range (its steep left wing; the default degree 7 to ~2e-2).
SVI_TABLE_RTOL = 0.005
# f32 operations per path-step of kernel 20: the Box-Muller's 11 per two
# normals at one normal a pair-step, and the mirror's negation.
OPS_NORMALS = 11 / 4 + 1 / 2


def normals_specs():
    """Row 20 (csrc/philox.cu path_normals_kernel): name, source, what it
    replaces (no TPU kernel: the port's own), the paths that run it, its
    launch counter."""
    from options_model_tpu_torch.ops import philox

    return [dict(name="path_normals", source="options_model_tpu_torch/csrc/philox.cu",
                 replaces="none (the port's own: the normals of the bare sigma_fn route, "
                          "options_model_tpu/models/localvol.py:27-62)",
                 paths=("ivnn",), counter=(philox.launches, "path_normals"))]


def phase_normals() -> dict:
    """V0: kernel 20 against path_normals at 2 tiles (each tile, with and
    without antithetics, at step counts ending in each tail of its four
    steps a call) and at V2's chunk shapes (64 x 16,384 x 100, 256 x 4,096 x
    50), its normals within NORMALS_ATOL; the stream's words bit for bit; a
    first_tile chunk bit-equal to those tiles of the whole; and the bare
    route over table_sigma_fn(table) against kernels 7 and 8 (the same
    normals: within LV_S_RTOL). Returns the max |kernel - plain|."""
    import torch

    from options_model_tpu_torch.core.config import MCConfig
    from options_model_tpu_torch.models.localvol import simulate_local_vol
    from options_model_tpu_torch.ops.cuda_heston import PATH_TILE, TERMINAL_TILE
    from options_model_tpu_torch.ops.philox import (draw_path_normals, path_normals,
                                                    stream_words, stream_words_cuda)
    from options_model_tpu_torch.surface.cheb import compile_localvol_table, table_sigma_fn

    seed, worst = 0x243F6A8885A308D3, 0.0
    cases = [(2, tile, n, anti) for tile in (TERMINAL_TILE, PATH_TILE)
             for n in (1, 2, 3, 49, 50, 100) for anti in (True, False)]
    cases += [(64, TERMINAL_TILE, 100, True), (64, TERMINAL_TILE, 100, False),
              (256, PATH_TILE, 50, True), (256, PATH_TILE, 50, False)]
    for n_tiles, tile, n_steps, anti in cases:
        got = draw_path_normals(seed, 5, n_tiles, tile, n_steps, anti, DEVICE)
        want = path_normals(seed, 5, n_tiles, tile, n_steps, anti, DEVICE)
        err = float((got - want).abs().max())
        worst = max(worst, err)
        if got.shape != want.shape or not err <= NORMALS_ATOL:
            fail(f"V0: path_normals kernel vs plain at {n_tiles} x {tile} x {n_steps} "
                 f"(antithetic {anti}): max |diff| {err:.3e} (gate {NORMALS_ATOL})")
        if n_tiles > 2 or n_steps == 100:
            part = draw_path_normals(seed, 5 + 1, n_tiles - 1, tile, n_steps, anti, DEVICE)
            if not torch.equal(part, got[:, tile:]):
                fail(f"V0: a first_tile chunk of path_normals is not the whole's tiles at "
                     f"{n_tiles} x {tile} x {n_steps}")
    words = (seed, 5, 2, TERMINAL_TILE // 2, 25)
    if not torch.equal(stream_words_cuda(*words, device=DEVICE),
                       stream_words(*words, device=DEVICE)):
        fail("V0: the stream's Philox words differ between the card and the plain version")
    log(f"[V0] path_normals kernel (row 20) == path_normals within {worst:.3e} (gate "
        f"{NORMALS_ATOL}) at 2 tiles of {TERMINAL_TILE} and {PATH_TILE} x 1/2/3/49/50/100 "
        f"steps and at 64 x {TERMINAL_TILE} x 100, 256 x {PATH_TILE} x 50, with and without "
        f"antithetics; the words bit for bit; first_tile chunks bit for bit")
    smile = lambda S, tau: 0.2 + 0.05 * torch.log(S / 100.0) ** 2 + 0.02 * torch.sqrt(tau)  # noqa
    for paths, n_steps, T in ((False, 100, 1.0), (True, 50, 0.5)):
        table = compile_localvol_table(smile, 100.0, T, n_steps, 100.0)
        cfg = MCConfig(n_paths=2 * (PATH_TILE if paths else TERMINAL_TILE), n_steps=n_steps)
        a = simulate_local_vol(seed, 100.0, 0.05, T, cfg, table=table, return_paths=paths,
                               device=DEVICE)
        b = simulate_local_vol(seed, 100.0, 0.05, T, cfg, sigma_fn=table_sigma_fn(table, T),
                               return_paths=paths, device=DEVICE)
        rel = float(((b - a).abs() / a.abs()).max())
        if a.shape != b.shape or not rel <= LV_S_RTOL:
            fail(f"V0: the bare route over the table vs kernel {8 if paths else 7}: max rel "
                 f"{rel:.3e} (gate {LV_S_RTOL})")
        log(f"[V0] bare route over table_sigma_fn vs kernel {8 if paths else 7} "
            f"({'paths' if paths else 'terminal'}, 2 tiles x {n_steps}): max rel {rel:.3e} "
            f"(gate {LV_S_RTOL}): the same normals")
    return {"path_normals": {"max_abs_err": worst}}


def phase_ivnn() -> tuple:
    """V1-V4, the IV-surface path on the card: the network trained through
    apps.train_surface --test and on the recorded chain; its sigma_fn through
    a compiled table (kernels 7 and 8) and through the bare route (kernel
    20's normals), European call and American put; save -> restore; SVI on
    Heston smiles through both routes. Returns the seconds by label and the
    prices and fits."""
    import numpy as np
    import torch

    from options_model_tpu_torch.apps import train_surface
    from options_model_tpu_torch.calibration.charfn import heston_cos_price
    from options_model_tpu_torch.core.config import (CALL, PUT, HestonParams, LSMConfig,
                                                      MCConfig, OptionSpec, SurfaceTrainConfig)
    from options_model_tpu_torch.core.payoff import vanilla_payoff
    from options_model_tpu_torch.core.stats import masked_mean_stderr
    from options_model_tpu_torch.data.market import read_chain_fixture
    from options_model_tpu_torch.data.synthetic import synthetic_smile_surface
    from options_model_tpu_torch.models.localvol import simulate_local_vol
    from options_model_tpu_torch.ops.cuda_heston import TERMINAL_TILE
    from options_model_tpu_torch.ops.philox import seed_from_generator
    from options_model_tpu_torch.pricers.american import (_pair_block, price_american,
                                                          richardson_cv_stat, simulated_config,
                                                          simulate_paths)
    from options_model_tpu_torch.pricers.blackscholes import implied_vol
    from options_model_tpu_torch.pricers.european import (make_terminal_sampler,
                                                          price_european_mc)
    from options_model_tpu_torch.surface import IVSurfaceModel, fit_svi_surface
    from options_model_tpu_torch.surface.cheb import compile_localvol_table, eval_table

    secs = {}
    t_phase = time.perf_counter()

    def timed(label, fn, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        secs[label] = time.perf_counter() - t0
        return out

    def gen(seed):
        return torch.Generator().manual_seed(seed)

    # V1: the network trained on the card.
    ckpt = str(Path(__file__).resolve().parent / "build" / "ivnn_checkpoint")
    K, T, iv, S0 = synthetic_smile_surface()
    Kc, Tc, ivc, S0c, meta = read_chain_fixture()

    def rmse_of(m, Kf, Tf, ivf):
        return float(np.sqrt(np.mean((m.predict(Kf, Tf) - ivf) ** 2)))

    model = timed("fit_test", train_surface.run,
                  train_surface.parse_args(["--test", "--save", ckpt]))["model"]
    r42 = rmse_of(model, K, T, iv)
    log(f"[V1] apps.train_surface --test --save at the CLI's defaults (seed 42): "
        f"{secs['fit_test']:.2f} s, {model._result.epochs_run} epochs; IV RMSE vs the oracle "
        f"{r42:.6f}, best_val_loss {model.best_val_loss:.4e}")
    fits = {"test": [], "chain": []}
    for fit, seeds in (("test", IVNN_TEST_SEEDS), ("chain", IVNN_CHAIN_SEEDS)):
        runs, total = [], 0.0
        for s in seeds:
            t0 = time.perf_counter()
            if fit == "test":
                m = train_surface.run(train_surface.parse_args(["--test", "--seed", str(s)]))["model"]
                r = rmse_of(m, K, T, iv)
            else:
                m = IVSurfaceModel.fit(Kc, Tc, ivc, S0c, SurfaceTrainConfig(seed=s),
                                       rate=meta["rate"], device=DEVICE)
                r = rmse_of(m, Kc, Tc, ivc)
            dt = time.perf_counter() - t0
            total += dt
            fits[fit].append((r, m.best_val_loss))
            runs.append(f"{s}: {dt:.2f} s, {m._result.epochs_run}")
        secs[f"fits_{fit}"] = total
        log(f"[V1] {fit} fits (seed: seconds, epochs): " + "; ".join(runs))
    geo = {fit: [float(np.exp(np.mean(np.log([f[i] for f in fits[fit]])))) for i in (0, 1)]
           for fit in fits}
    (rt, vt), (rc, vc) = geo["test"], geo["chain"]
    log(f"[V1] apps.train_surface --test at seeds 0-{IVNN_TEST_SEEDS[-1]}, geometric means: IV "
        f"RMSE vs the oracle {rt:.6f} (JAX {JAX_IVNN_TEST_RMSE:.6f} over seeds 0-39; gate "
        f"{IVNN_FIT_GATE}x), best_val_loss {vt:.4e} (JAX {JAX_IVNN_TEST_VAL:.4e}; not gated); "
        f"the fit at the CLI's defaults: IV RMSE {r42:.6f} (bar {IVNN_TEST_RMSE_BAR}), "
        f"best_val_loss {model.best_val_loss:.4e} (bar {IVNN_TEST_VAL_BAR})")
    log(f"[V1] SurfaceTrainConfig() on the recorded chain ({len(Kc)} quotes, vega weights, "
        f"augmentation) at seeds 0-{IVNN_CHAIN_SEEDS[-1]}, geometric means: IV RMSE vs its quotes "
        f"{rc:.6f} (JAX {JAX_IVNN_CHAIN_RMSE:.6f}), best_val_loss {vc:.4e} (JAX "
        f"{JAX_IVNN_CHAIN_VAL:.4e}); gate {IVNN_FIT_GATE}x JAX")
    if not (rt <= IVNN_FIT_GATE * JAX_IVNN_TEST_RMSE and r42 < IVNN_TEST_RMSE_BAR
            and model.best_val_loss < IVNN_TEST_VAL_BAR):
        fail("V1: the --test fits outside their gates")
    if not (rc <= IVNN_FIT_GATE * JAX_IVNN_CHAIN_RMSE and vc <= IVNN_FIT_GATE * JAX_IVNN_CHAIN_VAL):
        fail("V1: the chain fits outside their gates")

    # V2: sigma_fn(K=100) through both routes on the same seeds.
    r, Tv = 0.05, IVNN_T
    fn = model.sigma_fn(100.0)
    fn16 = model.sigma_fn(100.0, compute_dtype=torch.bfloat16)
    call = OptionSpec(strike=100.0, rate=r, cp=CALL)
    mc_e = MCConfig(n_paths=1 << 22, n_steps=100)
    table = timed("table_compile", compile_localvol_table, fn, 100.0, Tv, 100, S0,
                  degree=IVNN_TABLE_DEGREE)
    table7 = compile_localvol_table(fn, 100.0, Tv, 100, S0)
    S_grid = torch.linspace(60.0, 160.0, 1001)
    for label, tab in (("7", table7), (str(IVNN_TABLE_DEGREE), table)):
        err = max(float((eval_table(tab, S_grid, t).cpu()
                         - fn(S_grid, torch.tensor(Tv - t * Tv / 100)).cpu()).abs().max())
                  for t in (0, 50, 99))
        log(f"[V2] the degree-{label} table against the network's sigma (S 60-160, steps 0, 50, "
            f"99): max |diff| {err:.3e}")
    samplers = {"table": make_terminal_sampler("localvol", S0, r, Tv, localvol_table=table,
                                               device=DEVICE),
                "table_degree_7": make_terminal_sampler("localvol", S0, r, Tv,
                                                        localvol_table=table7, device=DEVICE),
                "bare": make_terminal_sampler("localvol", S0, r, Tv, sigma_fn=fn, device=DEVICE),
                "bare_bf16": make_terminal_sampler("localvol", S0, r, Tv, sigma_fn=fn16,
                                                   device=DEVICE)}
    euro = {}
    for route, sampler in samplers.items():
        p, se, _ = timed(f"european_{route}", price_european_mc, gen(43), sampler, call, Tv, mc_e)
        euro[route] = (float(p), float(se))
        if route in ("bare_bf16", "table_degree_7"):
            continue
        seed = seed_from_generator(gen(47))
        S_T = timed(f"martingale_{route}", sampler, seed, 0, mc_e)
        m, m_se, _ = masked_mean_stderr(S_T.double() * math.exp(-r * Tv), None, TERMINAL_TILE)
        m, m_se = float(m), float(m_se)
        log(f"[V2] {route} route: European call (2^22 x 100, T {Tv}) {euro[route][0]:.6f} +- "
            f"{euro[route][1]:.6f} in {secs[f'european_{route}']:.3f} s; mean(S_T) e^-rT "
            f"{m:.6f} +- {m_se:.6f} ({(m - S0) / m_se:+.2f} stderr from S0; gate 4)")
        if not (math.isfinite(m) and abs(m - S0) <= 4.0 * m_se):
            fail(f"V2: the {route} route's S_T is not a martingale within 4 stderr")
    (pt, _), (pb, _), (p16, _) = euro["table"], euro["bare"], euro["bare_bf16"]
    p7 = euro["table_degree_7"][0]
    log(f"[V2] European call: table (kernel 7, degree {IVNN_TABLE_DEGREE}) {pt:.6f}, bare "
        f"(kernel 20 + network) {pb:.6f}: gap {(pb / pt - 1) * 100:+.5f}% (gate "
        f"{IVNN_ROUTE_RTOL * 100}%); the degree-7 table {p7:.6f}, {(p7 / pb - 1) * 100:+.4f}% from "
        f"the bare route (not gated); bf16 bare {p16:.6f}: {(p16 / pb - 1) * 100:+.4f}% from f32 "
        f"(gate {IVNN_BF16_RTOL * 100}%); table compile {secs['table_compile']:.3f} s")
    if not abs(pb / pt - 1.0) <= IVNN_ROUTE_RTOL:
        fail("V2: the European call's table and bare routes differ beyond the table's error")
    if not abs(p16 / pb - 1.0) <= IVNN_BF16_RTOL:
        fail("V2: the bf16 bare route differs from f32 beyond its gate")
    put = OptionSpec(strike=100.0, rate=r, cp=PUT)
    mc_a = MCConfig(n_paths=1 << 21, n_steps=50, path_block=4096)
    lsm = LSMConfig(richardson=True, use_control_variate=False)
    pb_a = _pair_block(mc_a, "localvol")
    table8 = timed("table_compile_50", compile_localvol_table, fn, 100.0, Tv, 50, S0,
                   degree=IVNN_TABLE_DEGREE)

    def table_put():
        S = simulate_paths(gen(53), S0, Tv, simulated_config(mc_a, "localvol"), "localvol",
                           rate=r, localvol_table=table8, device=DEVICE)
        stat, mask = richardson_cv_stat(S, None, put, Tv, lsm, model="localvol", pair_block=pb_a)
        return masked_mean_stderr(stat, mask, pb_a)[:2]

    am = {"table": [float(x) for x in timed("american_table", table_put)],
          "bare": [float(x) for x in timed("american_bare", price_american, gen(53), S0, Tv, put,
                                           mc_a, lsm, "localvol", sigma_fn=fn, device=DEVICE)]}
    (at, at_se), (ab, ab_se) = am["table"], am["bare"]
    log(f"[V2] American put (2^21 x 50, Richardson, no CV): table (kernel 8) {at:.6f} +- "
        f"{at_se:.6f} in {secs['american_table']:.3f} s; bare (kernel 20 + network, "
        f"price_american) {ab:.6f} +- {ab_se:.6f} in {secs['american_bare']:.3f} s; gap "
        f"{(ab / at - 1) * 100:+.5f}% (gate {IVNN_ROUTE_RTOL * 100}%)")
    if not (math.isfinite(at) and abs(ab / at - 1.0) <= IVNN_ROUTE_RTOL):
        fail("V2: the American put's table and bare routes differ beyond the table's error")

    # V3: save -> restore on the card: the same table bit for bit.
    restored = timed("restore", IVSurfaceModel.restore, ckpt)
    again = compile_localvol_table(restored.sigma_fn(100.0), 100.0, Tv, 100, S0,
                                   degree=IVNN_TABLE_DEGREE)
    if not torch.equal(again.coeffs, table.coeffs):
        fail("V3: the restored model's table differs from the original's")
    log(f"[V3] save -> IVSurfaceModel.restore ({ckpt}): the table's coefficients bit for bit; "
        f"restore {secs['restore']:.3f} s")

    # V4: SVI on Heston-COS smiles (tests/test_svi.py:105-134), float64 on the card.
    hp = HestonParams(kappa=2.0, theta=0.04, xi=0.4, rho=-0.6, v0=0.04)
    Ks = np.linspace(75.0, 130.0, 14)
    exps = [0.25, 0.5, 0.75, 1.0]
    f64 = dict(dtype=torch.float64, device=DEVICE)
    rows = []
    for Te in exps:
        px = heston_cos_price(100.0, torch.tensor(Ks, **f64), Te, r, hp, cp=1.0, **f64)
        rows.append(implied_vol(px, 100.0, torch.tensor(Ks, **f64), Te, r, cp=1.0,
                                **f64).cpu().numpy())
    surf, infos = timed("svi_fit", fit_svi_surface, 100.0, r, exps, [Ks] * 4, rows)
    bfly, cal = surf.check_butterfly(), surf.check_calendar()
    log(f"[V4] fit_svi_surface on Heston-COS smiles (4 x 14, float64 on the card): "
        f"{secs['svi_fit']:.2f} s; rmse_iv {[round(i['rmse_iv'], 7) for i in infos]} (gate 2e-3); "
        f"butterfly {bfly['ok']}, calendar {cal['ok']}")
    if not (all(i["rmse_iv"] < 2e-3 for i in infos) and bfly["ok"] and cal["ok"]):
        fail("V4: the SVI fit outside its gates")
    T4 = 0.75
    lv = surf.local_vol_fn(T_option=T4)
    table4 = timed("svi_table_compile", compile_localvol_table, lv, 100.0, T4, 100, 100.0,
                   degree=IVNN_TABLE_DEGREE)
    sampler4 = make_terminal_sampler("localvol", 100.0, r, T4, localvol_table=table4,
                                     device=DEVICE)
    seed = seed_from_generator(gen(59))
    S_table = timed("svi_table_paths", sampler4, seed, 0, MCConfig(n_paths=1 << 22, n_steps=100))
    S_bare = timed("svi_bare_paths", simulate_local_vol, seed, 100.0, r, T4,
                   MCConfig(n_paths=1 << 20, n_steps=48), sigma_fn=lv, return_paths=False,
                   device=DEVICE)
    for route, S_T, n_steps, slack in (
            (f"table (kernel 7, degree {IVNN_TABLE_DEGREE}), 2^22 x 100", S_table, 100,
             SVI_TABLE_RTOL),
            ("bare (kernel 20), 2^20 x 48", S_bare, 48, 0.0)):
        for Kx in (90.0, 100.0, 110.0):
            pay = vanilla_payoff(S_T.double(), Kx, 1.0) * math.exp(-r * T4)
            p, se, _ = masked_mean_stderr(pay, None, TERMINAL_TILE)
            p, se = float(p), float(se)
            pj, sej = JAX_SVI_LV[(n_steps, Kx)]
            gate = 4.0 * math.hypot(se, sej) + slack * pj
            cos = float(heston_cos_price(100.0, Kx, T4, r, hp, cp=1.0, dtype=torch.float64,
                                         device="cpu"))
            log(f"[V4] SVI local vol {route}: call K {Kx:g} {p:.6f} +- {se:.6f}; the JAX "
                f"package's {pj:.6f} +- {sej:.6f}: gap {p - pj:+.6f} (gate {gate:.6f}); Heston "
                f"COS {cos:.6f}: {(p - cos) / cos * 100:+.4f}% (the JAX package's "
                f"{(pj - cos) / cos * 100:+.4f}%)")
            if not abs(p - pj) <= gate:
                fail(f"V4: the SVI local-vol call at K {Kx} ({route}) outside its gate")
    secs["phase"] = time.perf_counter() - t_phase
    log(f"[V] the IV-surface path took {secs['phase']:.1f} s")
    return secs, dict(euro=euro, american=am, fits=fits)


def phase_normals_timing(per_call: float, launches: dict) -> dict:
    """Phase 5 for row 20: CUDA-event medians of the normals kernel at the
    bare European chunk (64 x 16,384 x 100) and the American chunk (256 x
    4,096 x 50), beside its bound (the normals written, or the Philox and
    Box-Muller work, whichever is larger) and its plain version's time; the
    JSON row is the European chunk."""
    from options_model_tpu_torch.ops.cuda_heston import PATH_TILE, TERMINAL_TILE
    from options_model_tpu_torch.ops.philox import draw_path_normals, path_normals
    from options_model_tpu_torch.utils.profiling import time_per_call

    seed, rows = 0x13198A2E03707344, {}
    for label, tiles, tile, n_steps in (("european chunk", 64, TERMINAL_TILE, 100),
                                        ("american chunk", 256, PATH_TILE, 50)):
        n = tiles * tile
        ms = time_per_call(lambda: draw_path_normals(seed, 0, tiles, tile, n_steps, True, DEVICE),
                           N_TIMED)
        plain_ms = time_per_call(lambda: path_normals(seed, 0, tiles, tile, n_steps, True, DEVICE),
                                 3)
        b = bound(n, n_steps, OPS_NORMALS, int_ops(DRAWS_GBM, per_call), n * n_steps * 4)
        rows[label] = dict(ms=ms, plain_ms=plain_ms, shape=f"{tiles} x {tile} x {n_steps}", **b)
        log(f"[5] path_normals (row 20) at {tiles} x {tile} x {n_steps}: kernel {ms:.4f} ms "
            f"({n * n_steps * 4 / ms / 1e9:.3f} TB/s written), plain {plain_ms:.4f} ms; bound "
            f"{b['bound_ms']:.4f} ms by {b['bound_term']}; {b['bound_ms'] / ms * 100:.1f}% of "
            f"bound")
    log(f"[5] IV-surface path launches: {launches}")
    return rows


# The Variance Gamma and SABR families (phase F, the [F...] lines): kernels
# 21-24 of csrc/vg.cu and csrc/sabr.cu, models/vg.py, models/sabr.py and
# their branches of the pricers. Configurations are the JAX tests':
VG_F1 = dict(sigma=0.18, theta=-0.14, nu=0.35)            # tests/test_vg.py:22
VG_F2 = dict(sigma=0.2, theta=-0.14, nu=0.2)              # tests/test_cos_bermudan.py:21-24
SABR_F4 = dict(alpha=0.2, beta=1.0, rho=-0.4, nu=0.6)     # tests/test_sabr.py:16-17
SABR_ABSORB = dict(alpha=8.0, beta=0.5, rho=0.0, nu=0.2)  # tests/test_sabr.py:78-90
# Host oracles, too slow for this script (the JAX package in float64 on an
# x86-64 CPU: cos_american_price 42.6 s, sabr_fd_price at (450, 180, 450)
# 12.5-12.8 s), taken as constants: F2's put (S0 = K = 100, T = 0.5, r =
# 0.05) by cos_bermudan_price(n_dates=50) and cos_american_price, F5's (r =
# 0.03) by sabr_fd_price(n_f=450, n_a=180, n_t=450), and with
# exercise_dates=50 (printed).
VG_COS_BERMUDAN = 4.665786
VG_COS_AMERICAN = 4.670817
SABR_ADI = 5.077948
SABR_ADI_BERMUDAN = 5.075018
# The JAX package's own estimators at 2^16 x 50 on the CPU against those
# oracles (its VG CV price, seeds 7 and 8; its SABR Richardson price, seed
# 7), printed beside F2's and F5's pooled gaps.
JAX_VG_CV_GAP = (-0.0033, -0.0032)
JAX_SABR_RICH_GAP = -0.0075
# The JAX package's calibrate_sabr fits of F6's two smiles (its float32
# outputs, x86-64 CPU), printed beside the port's.
JAX_F6_FITS = {1.0: (0.2199999988079071, -0.5000001192092896, 0.7999998331069946),
               0.7: (0.30000004172325134, -0.29999998211860657, 0.4999997913837433)}
F_SEEDS = 4
F_GATE = 0.01              # American puts: max(1%, 4 pooled stderr) (tests/test_cos_bermudan.py)
SABR_HAGAN_BIAS = 0.003    # Europeans vs Hagan's O(T) form: 4 stderr + 0.3% (tests/test_sabr.py)
SABR_ADI_GATE = 0.015      # the (S, alpha) Richardson put vs ADI (tests/test_sabr.py:246-257)
SABR_BASIS_GAP = 0.02      # the S-only basis prices lower by more than this
# Kernels 21-24 against their plain versions: the gamma sampler's accept
# test and the SABR states take the same IEEE operations in the same order
# on both sides (csrc/vg.cu, csrc/sabr.cu), so the accepting attempts and
# the absorbed paths are equal; an attempt that did differ would move a
# whole draw. At 2 tiles no attempt may differ, at the legs' shapes at most
# ATTEMPT_FLIPS of the draws (their paths are left out of the S check and
# counted). Gamma draws within GAMMA_RTOL, or FLT_MIN absolute for the
# subnormals (a ~ 0.01).
GAMMA_SHAPES = (0.01, 0.05, 1.0, 2.5)
GAMMA_RTOL = 1e-5
# The redesigns of kernels 21 and 24 (csrc/vg.cu vg_paths_kernel,
# csrc/sabr.cu sabr_terminal_kernel) walk on the fast pipes (the SFU
# Box-Muller, ex2, FMAs), as the redesigns of kernels 1 and 3-8 do, and
# are held to those redesigns' design tolerance: S, F_T, G_T and alpha_T
# within REDESIGN_RTOL of the plain version (the first designs keep
# S_RTOL and V_RTOL). Kernel 21's clock stays exact: its gammas and
# accepting attempts equal the first design's bit for bit.
REDESIGN_RTOL = 1e-4
ATTEMPT_FLIPS = 1e-6
FLT_MIN = 1.1754943508222875e-38
GAMMA_QUANTILES = (0.5, 0.75, 0.95)
# f32 operations a path-step, counted from csrc/vg.cu: a gamma attempt the
# Box-Muller's 11 and the accept test's 14 (1 + c x, its cube, x^2/2 + d -
# d v + d log v, log u, the compare), the boost 5 (two logs, a multiply, an
# add, exp), the pair's normal 11/2, the increment 8, the store's add and
# exp 2; SABR the Box-Muller's 11/2, w2 3, the vol step 5, log-Euler 7, the
# store's exp 1 (the terminal kernel's control variate 3 more, no store).
OPS_VG_ATTEMPT = 11 + 14
OPS_VG_STEP = 11 / 2 + 8 + 2
OPS_VG_BOOST = 5
OPS_SABR = 11 / 2 + 3 + 5 + 7 + 1
OPS_SABR_CV = OPS_SABR + 3 - 1
DRAWS_SABR = (1 / 2, 1)


def vg_draws(attempts: float, boost: bool) -> tuple:
    """Philox (calls, words made uniform) a VG path-step at ``attempts``
    gamma attempts a draw (the run's mean): half a call for the pair's
    normal (two words), and per attempt one call of three words (four with
    the boost)."""
    return (0.5 + attempts, 1 + attempts * (4 if boost else 3))


# The first designs of kernels 21, 22 and 24, by the redesign's name: their
# launch counters' keys (ops/cuda_vg.py, ops/cuda_sabr.py).
FAMILY_FIRSTS = {"vg_paths": "vg_paths, first design",
                 "vg_terminal": "vg_terminal, first design",
                 "sabr_terminal": "sabr_terminal, first design"}
# Kernel 22 at these gamma shapes too (2 tiles, both designs): the squeeze's
# margin m(d) grows with d.
TERMINAL_SHAPES = GAMMA_SHAPES + (20.0,)
# The adversarial grid of kernel 22's decision (vg_decide) at each of these
# shapes, F0: the band |x| <= 0.06 against u = 1 - j 2^-24 (j = 1..16) and
# the squeeze's edge (the floats within 4 ulps of its bound, with and
# without the margin) across |x| <= 2.3445; at least 2^24 pairs in all.
DECIDE_SHAPES = (0.01, 0.2, 1.0, 2.857, 5.0, 20.0)


def family_specs():
    """Kernels 21-24: name, source, the XLA function each replaces, the
    paths that run it and its launch counter."""
    from options_model_tpu_torch.ops import cuda_sabr, cuda_vg

    vg_src, sabr_src = "options_model_tpu_torch/csrc/vg.cu", "options_model_tpu_torch/csrc/sabr.cu"
    return [
        dict(name="vg_paths", source=vg_src, replaces="options_model_tpu/models/vg.py:55",
             paths=("families",), counter=(cuda_vg.launches, "vg_paths")),
        dict(name="vg_terminal", source=vg_src, replaces="options_model_tpu/models/vg.py:92",
             paths=("families",), counter=(cuda_vg.launches, "vg_terminal")),
        dict(name="sabr_paths", source=sabr_src, replaces="options_model_tpu/models/sabr.py:90",
             paths=("families",), counter=(cuda_sabr.launches, "sabr_paths")),
        dict(name="sabr_terminal", source=sabr_src,
             replaces="options_model_tpu/models/sabr.py:90 (terminal) and :211-236",
             paths=("families",), counter=(cuda_sabr.launches, "sabr_terminal")),
    ]


def _family_params():
    from options_model_tpu_torch.core.config import SABRParams, VGParams

    return (VGParams(**VG_F1), VGParams(**VG_F2), SABRParams(**SABR_F4),
            SABRParams(**SABR_ABSORB))


def _rel(got, want) -> float:
    """max |got - want| / |want| (0 for empty tensors)."""
    d = (got.double() - want.double()).abs()
    return float((d / want.double().abs().clamp_min(1e-300)).max()) if d.numel() else 0.0


def _decide_grid(d: float, c: float, device):
    """DECIDE_SHAPES's grid at the sampler's float32 (d, c): (x, u)."""
    import torch

    from options_model_tpu_torch.ops.cuda_vg import SQUEEZE_KAPPA, SQUEEZE_MARGIN

    f = dict(dtype=torch.float32, device=device)
    xb = torch.cat([torch.linspace(-0.06, 0.06, 1 << 17, dtype=torch.float64, device=device),
                    2.0 ** -torch.arange(10, 130, dtype=torch.float64, device=device)]).to(**f)
    ub = 1.0 - torch.arange(1, 17, dtype=torch.float64, device=device).to(**f) * 2.0 ** -24
    xs, us = [xb.repeat(len(ub))], [ub.repeat_interleave(len(xb))]
    xe = torch.linspace(-2.3445, 2.3445, 1 << 16, dtype=torch.float64, device=device).to(**f)
    x2 = xe * xe
    for margin in (0.0, SQUEEZE_MARGIN):
        bound = ((1.0 - margin * (1.0 + torch.tensor(d, **f)))
                 - torch.tensor(float(SQUEEZE_KAPPA), **f) * (x2 * x2))
        for k in range(-4, 5):
            u = bound
            for _ in range(abs(k)):
                u = torch.nextafter(u, torch.full_like(u, 2.0 if k > 0 else -1.0))
            keep = (u >= 0) & (u < 1)
            xs.append(xe[keep])
            us.append(u[keep])
    return torch.cat(xs), torch.cat(us)


def phase_vg_decide(seed: int, vg1) -> float:
    """F0, kernel 22's decision: omt_vg_decide (vg_decide_kernel, the
    redesign's squeeze and exact test) against vg_decide_reference (torch's
    float32 operations in its order, torch's log on the card) on the
    adversarial grid of every DECIDE_SHAPES shape (at least 2^24 pairs in
    all; no pair may differ), and the squeeze without a margin against the
    exact test on it (the pairs where it would accept what the test rejects,
    printed: the grid bites); then on attempt 0 of F1's 2^22 draws (the
    stream's own x and u): the decisions equal, and the share the squeeze
    accepts, returned."""
    import torch

    from options_model_tpu_torch.models.vg import vg_constants
    from options_model_tpu_torch.ops import cuda_vg
    from options_model_tpu_torch.ops.cuda_heston import TERMINAL_TILE
    from options_model_tpu_torch.ops.cuda_vg import (DECIDE_SQUEEZE, SQUEEZE_KAPPA,
                                                     vg_decide_reference)
    from options_model_tpu_torch.ops.philox import (_vg_words, box_muller, gamma_constants,
                                                    uniform_from_bits)

    def both(x, u, d, c):
        dd, cc = torch.full_like(x, d), torch.full_like(x, c)
        got = cuda_vg.vg_decide(x, u, dd, cc)
        want = vg_decide_reference(x, u, d, c)
        return got, want, int((got != want).sum())

    total, bites = 0, {}
    for a in DECIDE_SHAPES:
        k = gamma_constants(a)
        d, c = float(k["d"]), float(k["c"])
        x, u = _decide_grid(d, c, DEVICE)
        got, want, differ = both(x, u, d, c)
        if differ:
            fail(f"F0: omt_vg_decide differs from torch's decision at a = {a} on {differ} of "
                 f"{x.numel()} grid pairs")
        v1 = 1.0 + c * x
        x2 = x * x
        kappa = torch.tensor(float(SQUEEZE_KAPPA), device=DEVICE)
        bare = (v1 > 0) & (u < 1.0 - kappa * (x2 * x2))
        bites[a] = int((bare & (want == 0)).sum())
        total += x.numel()
        log(f"[F0] vg_decide at a = {a} (d {d:.6g}): {x.numel()} adversarial pairs, the kernel's "
            f"decision == torch's on all; the squeeze accepts {int((got == DECIDE_SQUEEZE).sum())}"
            f", all of them accepted by the exact test; without a margin it would accept "
            f"{bites[a]} that the exact test rejects")
    if total < 1 << 24 or not any(bites.values()):
        fail(f"F0: the decision grid holds {total} pairs (< 2^24) or never catches the squeeze "
             "without a margin")
    a1 = float(vg_constants(100.0, 0.04, 1.0, vg1, 1)["shape"])
    k = gamma_constants(a1)
    w0, w1, w2, _ = _vg_words(seed, 0, (1 << 22) // TERMINAL_TILE, TERMINAL_TILE, 1, DEVICE)
    x = box_muller(uniform_from_bits(w0), uniform_from_bits(w1))[0]
    got, _, differ = both(x, uniform_from_bits(w2), float(k["d"]), float(k["c"]))
    if differ:
        fail(f"F0: omt_vg_decide differs from torch's on {differ} of F1's attempt-0 draws")
    share = float((got == DECIDE_SQUEEZE).double().mean())
    log(f"[F0] the squeeze's share of F1's 2^22 attempt-0 draws (a = {a1:.6g}): {share:.6f} "
        f"(predicted 0.917); exact-test share {float((got == 2).double().mean()):.6f}; "
        f"{total} grid pairs in all")
    return share


def phase_family_kernels() -> dict:
    """F0: kernels 21-24 against their plain versions on the card. The VG
    stream's Philox words bit for bit; kernel 22, both designs on one plain
    output, at 2 tiles of each shape of TERMINAL_SHAPES and at F1's 2^22:
    the gammas and attempts of both plain's bit for bit, S_T within
    REDESIGN_RTOL (the redesign) and S_RTOL (the first design); the law of
    2^22 draws of the redesign at each shape of GAMMA_SHAPES against
    scipy.stats.gamma (mean, variance, CDF at GAMMA_QUANTILES, the zeros
    against the mass below 2^-150) within 4 stderr; the redesign's decision
    on the card against torch's (phase_vg_decide). Kernel 21,
    both designs on one plain output a shape, at F2's 2^20 x 50, 2 tiles x
    50, the F3 batch's first and last maturity (16,384 x 50) and 2 tiles x
    50 at each shape of GAMMA_SHAPES: the redesign's gammas and attempts
    equal the first design's bit for bit, its S within REDESIGN_RTOL of
    plain and finite; the first design against plain as kernel 22 (S
    within S_RTOL); the F3 batch (64 x 16,384 x 50) equal to its 64 single
    launches bit for bit, both designs. Kernel 23 at 2 tiles and F5's 2^20
    x 50 with alpha (beta = 0.5 at 2 and 4 tiles x 50); kernel 24 at 2
    tiles and F4's 2^22 x 64 with G_T and alpha, the redesign within
    REDESIGN_RTOL (F_T, alpha_T, G_T) and the first design within S_RTOL
    and V_RTOL of one plain output; at beta = 0.5 both the same launch of
    the first design's instance, the absorbed set plain's. F and G_T of
    kernel 23 within S_RTOL, alpha within V_RTOL, the absorbed paths
    equal; first_tile chunks of all four and the three first designs bit
    for bit. Returns per kernel max |d| and max relative d, and the mean
    gamma attempts at the timed shapes and the squeeze's share at F1."""
    import numpy as np
    import torch
    from scipy import stats

    from options_model_tpu_torch.models.sabr import sabr_from_draws
    from options_model_tpu_torch.ops import cuda_sabr, cuda_vg
    from options_model_tpu_torch.ops.cuda_heston import PATH_TILE, TERMINAL_TILE
    from options_model_tpu_torch.ops.philox import (VG_STREAM, sabr_path_draws, stream_words,
                                                    stream_words_cuda)

    t0 = time.perf_counter()
    seed = 0x452821E638D01377
    vg1, vg2, sp, sp_abs = _family_params()
    errs = {name: dict(s_abs=0.0, s_rel=0.0)
            for name in [k["name"] for k in family_specs()] + list(FAMILY_FIRSTS.values())}
    attempts = {}

    def note(name, got, want):
        errs[name]["s_abs"] = max(errs[name]["s_abs"],
                                  float((got.double() - want.double()).abs().max()))
        errs[name]["s_rel"] = max(errs[name]["s_rel"], _rel(got, want))

    words = (seed, 5, 2, TERMINAL_TILE // 2, 34)
    if not torch.equal(stream_words_cuda(*words, device=DEVICE, stream=VG_STREAM),
                       stream_words(*words, device=DEVICE, stream=VG_STREAM)):
        fail("F0: the VG stream's Philox words differ between the card and the plain version")

    def vg_check(label, name, got, want, limit, s_rtol=S_RTOL):
        """S, gammas and attempts of a kernel against the plain version;
        paths with a differing attempt are counted (at most ``limit``) and
        left out of the S check (within ``s_rtol``)."""
        (S, g, a), (S0, g0, a0) = got, want
        flips = a != a0
        n_flip = int(flips.sum())
        if n_flip > limit:
            fail(f"F0: {label}: {n_flip} gamma draws accepted at another attempt (limit "
                 f"{limit})")
        ok = ~flips
        rel_g = float(((g - g0).abs()[ok] / g0.abs()[ok].clamp_min(FLT_MIN)).max())
        if not rel_g <= GAMMA_RTOL:
            fail(f"F0: {label}: gamma draws max rel {rel_g:.3e} (gate {GAMMA_RTOL})")
        path_ok = ~flips.reshape(-1, flips.shape[-1]).any(dim=0)
        if S.dim() == 1:
            Sg, Sw = S[path_ok], S0[path_ok]
        else:
            Sg, Sw = S[..., path_ok], S0[..., path_ok]
        rel = _rel(Sg, Sw)
        if not (S.shape == S0.shape and rel <= s_rtol and bool(torch.isfinite(S).all())):
            fail(f"F0: {label}: S max rel {rel:.3e} (gate {s_rtol})")
        note(name, Sg, Sw)
        log(f"[F0] {label}: attempts differing {n_flip} of {a.numel()} draws, gamma max rel "
            f"{rel_g:.3e}, S max rel {rel:.3e} (gates {limit}, {GAMMA_RTOL}, {s_rtol}); mean "
            f"attempts {float(a.double().mean()) + 1:.5f} a draw")
        return float(a.double().mean()) + 1

    def vg_both(label, args, limit, first_tile=0):
        """Kernel 21's two designs on one plain output: the first design
        against plain at today's gates, the redesign's draws against the
        first design's bit for bit and its S within REDESIGN_RTOL of plain.
        Returns the mean attempts a draw."""
        kw = dict(first_tile=first_tile, device=DEVICE, return_draws=True)
        want = [x[0] for x in cuda_vg.vg_paths_reference(*args, **kw)]
        first = [x[0] for x in cuda_vg.vg_paths_first(*args, **kw)]
        got = [x[0] for x in cuda_vg.vg_paths(*args, **kw)]
        vg_check(f"{label}, first design", FAMILY_FIRSTS["vg_paths"], first, want, limit)
        differ = int((got[2] != first[2]).sum())
        if differ or not torch.equal(got[1].view(torch.int32), first[1].view(torch.int32)):
            fail(f"F0: {label}: the redesign's gamma draws are not the first design's "
                 f"({differ} attempts differ)")
        log(f"[F0] {label}: the redesign's gammas and attempts == the first design's bit for "
            f"bit (0 of {got[2].numel()} attempts differ)")
        return vg_check(f"{label}, redesign", "vg_paths", got, want, limit, REDESIGN_RTOL)

    def terminal_both(label, args):
        """Kernel 22's two designs on one plain output: the first design's S
        within S_RTOL of plain, the redesign's within REDESIGN_RTOL; the
        gammas and attempts of both plain's bit for bit (no attempt differs,
        so the two designs' too). Returns the mean attempts a draw."""
        kw = dict(device=DEVICE, return_draws=True)
        want = cuda_vg.vg_terminal_reference(*args, **kw)
        first = cuda_vg.vg_terminal_first(*args, **kw)
        got = cuda_vg.vg_terminal(*args, **kw)
        vg_check(f"{label}, first design", FAMILY_FIRSTS["vg_terminal"], first, want, 0)
        for design, out in (("redesign", got), ("first design", first)):
            if not (torch.equal(out[2], want[2])
                    and torch.equal(out[1].view(torch.int32), want[1].view(torch.int32))):
                fail(f"F0: {label}: the {design}'s gamma draws or attempts are not plain's "
                     f"bit for bit ({int((out[2] != want[2]).sum())} attempts differ)")
        log(f"[F0] {label}: both designs' gammas and attempts == plain's bit for bit (0 of "
            f"{want[2].numel()} attempts differ)")
        return vg_check(f"{label}, redesign", "vg_terminal", got, want, 0, REDESIGN_RTOL)

    # kernel 22 at each gamma shape: 2 tiles against plain, 2^22 draws in law
    for a in TERMINAL_SHAPES:
        T = float(np.float32(a) * np.float32(0.2))
        vp = vg2                                    # nu = 0.2: a = T / 0.2
        terminal_both(f"vg_terminal gamma shape {a} (T = {T:.6g}, nu 0.2), 2 tiles",
                      (seed, 100.0, 0.05, T, vp, 2 * TERMINAL_TILE))
        if a not in GAMMA_SHAPES:
            continue
        g = cuda_vg.vg_terminal(seed + 1, 100.0, 0.05, T, vp, 1 << 22, device=DEVICE,
                                return_draws=True)[1].double().cpu().numpy()
        shape = float(np.float32(T) / np.float32(0.2))
        law, n = stats.gamma(shape), g.size
        zs = [(g.mean() - shape) / np.sqrt(shape / n),
              (g.var() - shape) / np.sqrt((2 * shape * shape + 6 * shape) / n)]
        zs += [((g <= law.ppf(p)).mean() - p) / np.sqrt(p * (1 - p) / n) for p in GAMMA_QUANTILES]
        p0 = law.cdf(2.0 ** -150)
        zero_gap = (g == 0.0).mean() - p0
        bad = (not np.all(np.isfinite(g)) or max(abs(z) for z in zs) > 4.0
               or abs(zero_gap) > 4 * np.sqrt(p0 * (1 - p0) / n) + 1e-12)
        log(f"[F0] gamma law at a = {shape:.6g}, 2^22 kernel draws: z of mean, variance, CDF "
            f"at {GAMMA_QUANTILES}: " + ", ".join(f"{z:+.2f}" for z in zs)
            + f" (gate 4); zeros {(g == 0.0).mean():.6f} vs P(G < 2^-150) {p0:.6f}; "
              f"finite {bool(np.all(np.isfinite(g)))}")
        if bad:
            fail(f"F0: kernel 22's gamma draws at a = {shape} leave the gamma law")

    # kernel 21 at the legs' shapes and at each gamma shape, kernel 22 at F1's
    attempts["vg_paths"] = vg_both("vg_paths F2 2^20 x 50 (a = 0.05)",
                                   (seed, 100.0, 0.05, [0.5], vg2, 1 << 20, 50),
                                   int(ATTEMPT_FLIPS * (1 << 20) * 50))
    vg_both("vg_paths F2 2 tiles x 50", (seed, 100.0, 0.05, [0.5], vg2, 2 * PATH_TILE, 50), 0)
    for a in GAMMA_SHAPES:
        T = float(np.float32(a) * np.float32(10.0))     # 50 steps, nu = 0.2: a = T / 10
        vg_both(f"vg_paths gamma shape {a} (T = {T:.6g}, nu 0.2) 2 tiles x 50",
                (seed, 100.0, 0.05, [T], vg2, 2 * PATH_TILE, 50), 0)
    attempts["vg_terminal"] = terminal_both("vg_terminal F1 2^22 (a = 2.857)",
                                            (seed, 100.0, 0.04, 1.0, vg1, 1 << 22))
    attempts["squeeze_share"] = phase_vg_decide(seed, vg1)
    # the F3 batch: 64 maturities in one launch == 64 single launches
    Ts = np.linspace(0.1, 1.0, 64).astype(np.float32).tolist()
    for design, fn in (("redesign", cuda_vg.vg_paths), ("first design", cuda_vg.vg_paths_first)):
        batch = fn(seed, 100.0, 0.05, Ts, vg2, 16384, 50, device=DEVICE)
        for m, T in enumerate(Ts):
            one = fn(seed, 100.0, 0.05, [T], vg2, 16384, 50, first_tile=4 * m, device=DEVICE)[0]
            if not torch.equal(one, batch[m]):
                fail(f"F0: vg_paths' 64-maturity batch ({design}) differs from its single "
                     f"launch at maturity {m}")
    for m in (0, 63):
        vg_both(f"vg_paths F3 maturity {m} (T = {Ts[m]:.4f}) 16,384 x 50",
                (seed, 100.0, 0.05, [Ts[m]], vg2, 16384, 50), int(ATTEMPT_FLIPS * 16384 * 50),
                first_tile=4 * m)
    log("[F0] vg_paths' 64 x 16,384 x 50 batch == its 64 single-maturity launches bit for "
        "bit, both designs")

    # kernels 23 and 24
    def sabr_check(label, name, got, want, params, F_0, T_, gates=(S_RTOL, V_RTOL, S_RTOL)):
        got, want = list(got), list(want)
        F, F_p = got[0], want[0]
        if not torch.equal(F == 0.0, F_p == 0.0):
            fail(f"F0: {label}: the absorbed paths differ")
        if params.beta == 1.0:
            rel = _rel(F, F_p)
            well = 1.0
        else:
            # near 0 the absorbing step cancels and F^(beta - 1) amplifies the
            # rounding of the next: S_RTOL where both float32 runs are within
            # 1e-6 of the float64 recursion on the same draws, and the
            # kernel's largest error against it at most twice the plain one's
            z1, z2 = sabr_path_draws(seed, 0, F.shape[-1] // PATH_TILE, PATH_TILE, 50, True,
                                     DEVICE)
            F64 = sabr_from_draws(z1.double(), z2.double(), F_0, T_, params, return_paths=True)
            e, e_p = (F.double() - F64).abs(), (F_p.double() - F64).abs()
            ok = (e <= 1e-6 * F64.abs()) & (e_p <= 1e-6 * F64.abs())
            well = float(ok.double().mean())
            rel = _rel(F[ok], F_p[ok])
            if not float(e.max()) <= 2.0 * float(e_p.max()) + 1e-30:
                fail(f"F0: {label}: kernel off float64 by {float(e.max()):.3e}, plain "
                     f"{float(e_p.max()):.3e}")
        if not (rel <= gates[0] and bool(torch.isfinite(F).all())):
            fail(f"F0: {label}: F max rel {rel:.3e} (gate {gates[0]})")
        note(name, F, F_p)
        for x, y, what, gate in zip(got[1:], want[1:], ("alpha", "G_T")[:len(got) - 1],
                                    gates[1:]):
            r = _rel(x, y)
            if not (r <= gate and bool(torch.isfinite(x).all())):
                fail(f"F0: {label}: {what} max rel {r:.3e} (gate {gate})")
        log(f"[F0] {label}: F max rel {rel:.3e} (gate {gates[0]}; well-conditioned share "
            f"{well:.4f}), bit-equal share {float((F == F_p).double().mean()):.6f}, absorbed "
            f"{int((F == 0).sum())} entries the same set"
            + "".join(f", {what} max rel {_rel(x, y):.3e}"
                      for x, y, what in zip(got[1:], want[1:], ("alpha", "G_T"))))

    F0_4 = float(np.float32(100.0))
    for n, label in ((2 * PATH_TILE, "2 tiles"), (1 << 20, "F5 2^20")):
        sabr_check(f"sabr_paths beta 1 {label} x 50 with alpha", "sabr_paths",
                   cuda_sabr.sabr_paths(seed, F0_4, 0.5, sp, n, 50, device=DEVICE,
                                        return_alpha=True),
                   cuda_sabr.sabr_paths_reference(seed, F0_4, 0.5, sp, n, 50, device=DEVICE,
                                                  return_alpha=True), sp, F0_4, 0.5)
    for n in (2 * PATH_TILE, 4 * PATH_TILE):
        sabr_check(f"sabr_paths beta 0.5 (absorbing) {n // PATH_TILE} tiles x 50", "sabr_paths",
                   cuda_sabr.sabr_paths(seed, 5.0, 2.0, sp_abs, n, 50, device=DEVICE,
                                        return_alpha=True),
                   cuda_sabr.sabr_paths_reference(seed, 5.0, 2.0, sp_abs, n, 50, device=DEVICE,
                                                  return_alpha=True), sp_abs, 5.0, 2.0)
    for n, steps, label in ((2 * TERMINAL_TILE, 64, "2 tiles"), (1 << 22, 64, "F4 2^22")):
        kw = dict(device=DEVICE, return_alpha=True, return_cv=True)
        want = cuda_sabr.sabr_terminal_reference(seed, F0_4, 0.5, sp, n, steps, **kw)
        sabr_check(f"sabr_terminal beta 1 {label} x {steps} with alpha and G_T, redesign",
                   "sabr_terminal", cuda_sabr.sabr_terminal(seed, F0_4, 0.5, sp, n, steps, **kw),
                   want, sp, F0_4, 0.5, (REDESIGN_RTOL,) * 3)
        sabr_check(f"sabr_terminal beta 1 {label} x {steps} with alpha and G_T, first design",
                   FAMILY_FIRSTS["sabr_terminal"],
                   cuda_sabr.sabr_terminal_first(seed, F0_4, 0.5, sp, n, steps, **kw), want, sp,
                   F0_4, 0.5)
    args = (seed, 5.0, 2.0, sp_abs, 2 * TERMINAL_TILE, 50)
    got = cuda_sabr.sabr_terminal(*args, device=DEVICE)
    first = cuda_sabr.sabr_terminal_first(*args, device=DEVICE)
    want = cuda_sabr.sabr_terminal_reference(*args, device=DEVICE)
    if not (torch.equal(got == 0.0, want == 0.0) and torch.equal(got, first)):
        fail("F0: sabr_terminal beta 0.5: the absorbed paths differ, or the two entries' "
             "launches of the first design's instance do")
    log(f"[F0] sabr_terminal beta 0.5 2 tiles x 50 (both entries: the first design's "
        f"instance, bit for bit): absorbed {int((got == 0).sum())} the same set as plain, "
        f"bit-equal share {float((got == want).double().mean()):.6f}")

    # first_tile chunks, bit for bit
    chunks = [
        ("vg_paths", lambda ft, n: cuda_vg.vg_paths(seed, 100.0, 0.05, [0.5], vg2, n * PATH_TILE,
                                                    20, first_tile=ft, device=DEVICE)[0],
         PATH_TILE),
        ("vg_terminal", lambda ft, n: cuda_vg.vg_terminal(seed, 100.0, 0.04, 1.0, vg1,
                                                          n * TERMINAL_TILE, first_tile=ft,
                                                          device=DEVICE), TERMINAL_TILE),
        ("sabr_paths", lambda ft, n: cuda_sabr.sabr_paths(seed, 5.0, 2.0, sp_abs, n * PATH_TILE,
                                                          20, first_tile=ft, device=DEVICE),
         PATH_TILE),
        ("sabr_terminal", lambda ft, n: torch.stack(cuda_sabr.sabr_terminal(
            seed, F0_4, 0.5, sp, n * TERMINAL_TILE, 16, first_tile=ft, device=DEVICE,
            return_alpha=True, return_cv=True)), TERMINAL_TILE),
        (FAMILY_FIRSTS["vg_paths"], lambda ft, n: cuda_vg.vg_paths_first(
            seed, 100.0, 0.05, [0.5], vg2, n * PATH_TILE, 20, first_tile=ft, device=DEVICE)[0],
         PATH_TILE),
        (FAMILY_FIRSTS["vg_terminal"], lambda ft, n: cuda_vg.vg_terminal_first(
            seed, 100.0, 0.04, 1.0, vg1, n * TERMINAL_TILE, first_tile=ft, device=DEVICE),
         TERMINAL_TILE),
        (FAMILY_FIRSTS["sabr_terminal"], lambda ft, n: torch.stack(cuda_sabr.sabr_terminal_first(
            seed, F0_4, 0.5, sp, n * TERMINAL_TILE, 16, first_tile=ft, device=DEVICE,
            return_alpha=True, return_cv=True)), TERMINAL_TILE)]
    for name, fn, tile in chunks:
        whole, part = fn(3, 3), fn(4, 2)
        if not torch.equal(part, whole[..., tile:]):
            fail(f"F0: a first_tile chunk of {name} is not the whole's tiles")
    log("[F0] first_tile chunks of kernels 21-24 and of 21's, 22's and 24's first designs "
        "bit for bit; the VG stream's words (counter "
        f"word 3 = {VG_STREAM}) bit for bit; F0 {time.perf_counter() - t0:.1f} s")
    return {"errs": errs, "attempts": attempts}


def phase_families() -> tuple:
    """F1-F6, the VG and SABR families through the entry points a user
    calls: F1 the VG Europeans of tests/test_vg.py (the put at 2^22 by
    kernel 22 against float64 COS, the martingale, kernel 21's S_T at 2^20
    x 50 against COS); F2 the VG American put at 2^20 x 50, CV and
    Richardson pooled over F_SEEDS seeds against VG_COS_BERMUDAN and
    VG_COS_AMERICAN; F3 the VG 64 x 64 surface (one kernel-21 launch) with
    three ATM cells against cos_bermudan_price(n_dates=50); F4 the SABR
    Europeans of tests/test_sabr.py at 2^22 x 64 (CV against Hagan, nu = 0
    against Black, the CV's stderr, put-call parity, the European sampler,
    the absorbing beta = 0.5 regime); F5 the SABR American put at 2^20 x
    50, Richardson on the (S, alpha) basis pooled against SABR_ADI, the
    S-only basis below it, the lognormal limit against CRR(4096); F6
    calibrate_sabr's round trips in float64 on the card. Returns (seconds
    per leg, results)."""
    import numpy as np
    import torch

    from options_model_tpu_torch.calibration.charfn import vg_cos_price
    from options_model_tpu_torch.core.config import (CALL, PUT, LSMConfig, MCConfig, OptionSpec,
                                                      SABRParams)
    from options_model_tpu_torch.core.stats import pair_mean_reduce
    from options_model_tpu_torch.models.sabr import (calibrate_sabr, hagan_lognormal_iv,
                                                     sabr_bs_price, sabr_european_mc,
                                                     simulate_sabr)
    from options_model_tpu_torch.models.vg import simulate_vg, vg_terminal_exact
    from options_model_tpu_torch.ops import cuda_vg
    from options_model_tpu_torch.ops.cuda_heston import PATH_TILE, TERMINAL_TILE
    from options_model_tpu_torch.pricers.american import (price_american,
                                                          price_american_with_control_variate)
    from options_model_tpu_torch.pricers.binomial import crr_american
    from options_model_tpu_torch.pricers.cos_bermudan import cos_bermudan_price
    from options_model_tpu_torch.pricers.european import make_terminal_sampler, price_european_mc
    from options_model_tpu_torch.pricers.surface_american import price_american_surface

    t_phase = time.perf_counter()
    vg1, vg2, sp, sp_abs = _family_params()
    gen = lambda s: torch.Generator().manual_seed(s)  # noqa: E731
    secs, res = {}, {}

    def timed(label, fn, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        secs[label] = secs.get(label, 0.0) + time.perf_counter() - t0
        return out

    def check(tag, ok, msg):
        log(f"[{tag}] {msg}")
        if not ok:
            fail(f"{tag}: {msg}")

    def pooled(label, fn, seeds, *args, **kwargs):
        ps, ses = zip(*((float(p), float(se)) for p, se in
                        (timed(label, fn, gen(s), *args, device=DEVICE, **kwargs)
                         for s in seeds)))
        if not all(math.isfinite(p) and se > 0 for p, se in zip(ps, ses)):
            fail(f"{label}: non-finite prices {ps} +- {ses}")
        return statistics.fmean(ps), math.sqrt(sum(se * se for se in ses)) / len(ses), ps

    # F1: VG Europeans (tests/test_vg.py:22's config)
    spec1 = OptionSpec(strike=100.0, rate=0.05, cp=PUT, div_yield=0.01)
    cos1 = float(vg_cos_price(100.0, 100.0, 1.0, 0.05, vg1, cp=-1.0, q=0.01,
                              dtype=torch.float64, device=DEVICE))
    sampler = make_terminal_sampler("vg", 100.0, 0.05, 1.0, vg=vg1, div_yield=0.01,
                                    device=DEVICE)
    p, se, _ = timed("F1", price_european_mc, gen(41), sampler, spec1, 1.0,
                     MCConfig(1 << 22, 100))
    p, se = float(p), float(se)
    check("F1", abs(p - cos1) < 4 * se, f"VG European put at 2^22 (kernel 22, one exact step): "
          f"{p:.6f} +- {se:.6f} vs float64 COS {cos1:.6f} ({(p - cos1) / se:+.2f} stderr, "
          f"gate 4)")
    S_T = timed("F1", vg_terminal_exact, 17, 100.0, 0.04, 1.0, vg1, MCConfig(1 << 22, 1),
                device=DEVICE)
    pm = pair_mean_reduce(S_T.double() * math.exp(-0.04), TERMINAL_TILE)
    m, sm = float(pm.mean()), float(pm.std()) / math.sqrt(pm.numel())
    check("F1", abs(m - 100.0) < 4 * sm, f"martingale E[S_T] e^(-(r-q)T) {m:.6f} +- {sm:.6f} vs "
          f"S0 100 ({(m - 100.0) / sm:+.2f} stderr)")
    S = timed("F1", simulate_vg, 19, 100.0, 0.04, 1.0, vg1, MCConfig(1 << 20, 50),
              return_paths=False, device=DEVICE)
    pm = pair_mean_reduce(torch.clamp_min(100.0 - S.double(), 0.0) * math.exp(-0.05), PATH_TILE)
    m, sm = float(pm.mean()), float(pm.std()) / math.sqrt(pm.numel())
    check("F1", abs(m - cos1) < 4 * sm, f"kernel 21's S_T at 2^20 x 50: put {m:.6f} +- {sm:.6f} "
          f"vs COS {cos1:.6f} ({(m - cos1) / sm:+.2f} stderr)")
    res["F1"] = dict(price=p, stderr=se, cos=cos1)

    # F2: the VG American put (tests/test_cos_bermudan.py:21-24, 125-131, 167-172)
    spec2 = OptionSpec(strike=100.0, rate=0.05, cp=PUT)
    mc2 = MCConfig(1 << 20, 50)
    seeds = range(61, 61 + F_SEEDS)
    for label, fn, lsm, oracle, jax_gap in (
            ("F2 cv", price_american_with_control_variate, LSMConfig(), VG_COS_BERMUDAN,
             "-0.33% (seed 7), -0.32% (seed 8)"),
            ("F2 richardson", price_american, LSMConfig(richardson=True), VG_COS_AMERICAN,
             "not run")):
        pm_, pse, ps = pooled(label, fn, seeds, 100.0, 0.5, spec2, mc2, lsm, "vg", vg=vg2)
        gap = (pm_ - oracle) / oracle
        check("F2", abs(pm_ - oracle) <= max(F_GATE * oracle, 4 * pse),
              f"VG American put, {label[3:]}, 2^20 x 50, {F_SEEDS} seeds pooled: {pm_:.6f} +- "
              f"{pse:.6f} vs {oracle:.6f}: {gap * 100:+.3f}% (gate max(1%, 4 stderr)); seeds "
              + ", ".join(f"{x:.6f}" for x in ps) + f"; the JAX package at 2^16 x 50 on the "
              f"CPU: {jax_gap}")
        res[label] = dict(price=pm_, stderr=pse, gap=gap)
    f32 = float(vg_cos_price(100.0, 100.0, 0.5, 0.05, vg2, cp=-1.0, device=DEVICE))
    f64 = float(vg_cos_price(100.0, 100.0, 0.5, 0.05, vg2, cp=-1.0, dtype=torch.float64,
                             device=DEVICE))
    log(f"[F2] the CV's closed form, vg_cos_price as the reference calls it (float32): {f32:.6f};"
        f" float64 {f64:.6f}; gap {f32 - f64:+.3e}")

    # F3: the VG 64 x 64 surface (BASELINE configs[4]'s grid)
    Ks = np.linspace(70.0, 130.0, 64).astype(np.float32)
    Ts = np.linspace(0.1, 1.0, 64).astype(np.float32)
    cuda_vg.shape_launches.clear()
    P, SE = timed("F3", price_american_surface, gen(71), 100.0, Ks, Ts, 0.05,
                  MCConfig(16384, 50), model="vg", vg=vg2, return_stderr=True, device=DEVICE)
    shapes = dict(cuda_vg.shape_launches)
    check("F3", shapes == {(64, 16384, 50): 1}, f"64 x 64 VG surface {secs['F3']:.3f} s; "
          f"kernel 21 launches by (n_mat, n_pad, n_steps): {shapes}")
    k = int(np.argmin(np.abs(Ks - 100.0)))
    for t in (0, 31, 63):
        oracle = cos_bermudan_price(100.0, float(Ks[k]), float(Ts[t]), 0.05, "vg", vg=vg2,
                                    cp=PUT, n_dates=50)
        c, e = float(P[t, k]), float(SE[t, k])
        check("F3", abs(c - oracle) <= 4 * e + SURFACE_BIAS * oracle,
              f"cell T = {Ts[t]:.4f}, K = {Ks[k]:.4f}: {c:.6f} +- {e:.6f} vs COS-Bermudan "
              f"{oracle:.6f} ({(c - oracle) / oracle * 100:+.3f}%, gate 4 stderr + "
              f"{SURFACE_BIAS * 100:.1f}%)")

    # F4: SABR Europeans (tests/test_sabr.py:94-130, 278-290)
    F0, T, R = 100.0, 0.5, 0.03
    S0f = F0 * math.exp(-R * T)
    mc4 = MCConfig(1 << 22, 64)
    cv = {}
    for K, cp in ((90.0, CALL), (100.0, CALL), (110.0, PUT), (100.0, PUT)):
        p, se = (float(x) for x in timed("F4", sabr_european_mc, gen(81), S0f, K, R, T, sp, mc4,
                                         cp=cp, device=DEVICE))
        truth = float(sabr_bs_price(F0, K, T, R, sp, cp, device=DEVICE))
        cv[K, cp] = (p, se)
        if (K, cp) != (100.0, PUT):
            check("F4", abs(p - truth) < 4 * se + SABR_HAGAN_BIAS * truth,
                  f"sabr_european_mc with the CV, K {K} {'call' if cp > 0 else 'put'}, 2^22 x "
                  f"64: {p:.6f} +- {se:.6f} vs Hagan {truth:.6f} ({(p - truth) / truth * 100:+.3f}"
                  f"%, gate 4 stderr + 0.3%)")
    p0, se0 = (float(x) for x in timed("F4", sabr_european_mc, gen(81), S0f, 100.0, R, T, sp,
                                       mc4, cp=CALL, control_variate=False, device=DEVICE))
    check("F4", cv[100.0, CALL][1] <= se0, f"the CV's stderr {cv[100.0, CALL][1]:.6f} <= the "
          f"plain one {se0:.6f} (K 100 call; plain {p0:.6f})")
    (c, se_c), (put, se_p) = cv[100.0, CALL], cv[100.0, PUT]
    rhs = math.exp(-R * T) * (F0 - 100.0)
    check("F4", abs(c - put - rhs) < 5 * math.hypot(se_c, se_p),
          f"put-call parity: C - P {c - put:.6f} vs e^(-rT)(F0 - K) {rhs:.6f} (gate 5 combined "
          f"stderr {5 * math.hypot(se_c, se_p):.6f})")
    lognormal = SABRParams(alpha=0.2, beta=1.0, rho=0.0, nu=0.0)
    p, se = (float(x) for x in timed("F4", sabr_european_mc, gen(82), S0f, 100.0, R, T, lognormal,
                                     mc4, cp=CALL, control_variate=False, device=DEVICE))
    truth = float(sabr_bs_price(F0, 100.0, T, R, lognormal, CALL, device=DEVICE))
    check("F4", abs(p - truth) < 4 * se, f"nu = 0: {p:.6f} +- {se:.6f} vs Black {truth:.6f} "
          f"({(p - truth) / se:+.2f} stderr)")
    spec4 = OptionSpec(strike=100.0, rate=R, cp=PUT)
    sampler = make_terminal_sampler("sabr", 100.0, R, T, sabr=sp, device=DEVICE)
    ps, ses, _ = timed("F4", price_european_mc, gen(83), sampler, spec4, T, mc4)
    pr, ser = timed("F4", sabr_european_mc, gen(84), 100.0, 100.0, R, T, sp, mc4, cp=PUT,
                    control_variate=False, device=DEVICE)
    ps, ses, pr, ser = (float(x) for x in (ps, ses, pr, ser))
    check("F4", abs(ps - pr) < 4 * (ses + ser), f"the European sampler (kernel 24) {ps:.6f} +- "
          f"{ses:.6f} vs sabr_european_mc without the CV {pr:.6f} +- {ser:.6f}")
    F = timed("F4", simulate_sabr, 23, 5.0, 2.0, sp_abs, MCConfig(16384, 50), return_paths=True,
              device=DEVICE)
    zero = F == 0.0
    first = zero.int().argmax(dim=0)
    after = torch.arange(F.shape[0], device=F.device)[:, None] >= first[None, :]
    stays = bool((zero | ~after | ~zero.any(dim=0)[None, :]).all())
    check("F4", bool(zero.any()) and stays and float(F.min()) >= 0.0,
          f"beta = 0.5 SABR(8, 0.5, 0, 0.2) at 16,384 x 50: {int(zero.any(dim=0).sum())} paths "
          f"absorbed, each at 0 from its first 0 on, min {float(F.min())}")

    # F5: the SABR American put (tests/test_sabr.py:237-266)
    spec5 = OptionSpec(strike=100.0, rate=R, cp=PUT)
    mc5 = MCConfig(1 << 20, 50)
    seeds = range(91, 91 + F_SEEDS)
    p_sv, se_sv, ps = pooled("F5 (S, alpha)", price_american, seeds, 100.0, T, spec5, mc5,
                             LSMConfig(richardson=True), "sabr", sabr=sp)
    gap = (p_sv - SABR_ADI) / SABR_ADI
    check("F5", abs(gap) < SABR_ADI_GATE,
          f"SABR American put, Richardson, (S, alpha) basis, 2^20 x 50, {F_SEEDS} seeds "
          f"pooled: {p_sv:.6f} +- {se_sv:.6f} vs ADI {SABR_ADI} ({gap * 100:+.3f}%, gate 1.5%; "
          f"the 50-date ADI {SABR_ADI_BERMUDAN}); seeds " + ", ".join(f"{x:.6f}" for x in ps)
          + f"; the JAX package at 2^16 x 50 on the CPU {JAX_SABR_RICH_GAP * 100:+.2f}%")
    p_s, se_s, _ = pooled("F5 S only", price_american, seeds, 100.0, T, spec5, mc5,
                          LSMConfig(richardson=True, variance_basis=False), "sabr", sabr=sp)
    check("F5", p_sv > p_s + SABR_BASIS_GAP, f"the S-only basis {p_s:.6f} +- {se_s:.6f} below "
          f"the (S, alpha) one by {p_sv - p_s:.6f} (gate > {SABR_BASIS_GAP})")
    crr = crr_american(100.0, 100.0, T, R, 0.2, cp=-1.0, n_steps=4096)
    p, se = (float(x) for x in timed("F5 lognormal", price_american, gen(95), 100.0, T, spec5,
                                     mc5, LSMConfig(richardson=True), "sabr",
                                     sabr=SABRParams(alpha=0.2, beta=1.0, rho=-0.4, nu=1e-4),
                                     device=DEVICE))
    check("F5", abs(p - crr) / crr < max(F_GATE, 4 * se / crr),
          f"nu = 1e-4: {p:.6f} +- {se:.6f} vs CRR(4096) {crr:.6f} "
          f"({(p - crr) / crr * 100:+.3f}%, gate max(1%, 4 stderr))")
    res["F5"] = dict(price=p_sv, stderr=se_sv, gap=gap, s_only=p_s)

    # F6: calibrate_sabr in float64 on the card (tests/test_sabr.py:134-151)
    for beta, truth, Ks6, rmse_bar in (
            (1.0, SABRParams(alpha=0.22, beta=1.0, rho=-0.5, nu=0.8),
             np.linspace(70.0, 130.0, 13), 1e-4),
            (0.7, SABRParams(alpha=0.3, beta=0.7, rho=-0.3, nu=0.5),
             np.linspace(80.0, 120.0, 9), 5e-4)):
        ivs = hagan_lognormal_iv(F0, torch.tensor(Ks6, dtype=torch.float32, device=DEVICE), T,
                                 truth).cpu().numpy()
        fit, info = timed(f"F6 beta {beta}", calibrate_sabr, F0, T, Ks6, ivs, beta=beta,
                          device=DEVICE)
        ok = fit.beta == beta and info["rmse"] < rmse_bar
        if beta == 1.0:
            ok = ok and (abs(fit.alpha / truth.alpha - 1) < 2e-3
                         and abs(fit.rho / truth.rho - 1) < 2e-2
                         and abs(fit.nu / truth.nu - 1) < 2e-2)
        jax_fit = JAX_F6_FITS[beta]
        check("F6", ok, f"calibrate_sabr beta {beta}: alpha {fit.alpha:.9f}, rho {fit.rho:.9f}, "
              f"nu {fit.nu:.9f} (the JAX package {jax_fit[0]:.9f}, {jax_fit[1]:.9f}, "
              f"{jax_fit[2]:.9f}; truth {truth.alpha}, {truth.rho}, {truth.nu}); rmse "
              f"{info['rmse']:.3e} (gate {rmse_bar}), {info['iters']} iterations, "
              f"{secs[f'F6 beta {beta}']:.2f} s")
    res["phase_seconds"] = time.perf_counter() - t_phase
    log("[F] seconds by leg: " + ", ".join(f"{k} {v:.3f}" for k, v in secs.items())
        + f"; the families phase {res['phase_seconds']:.1f} s (target 90 s)")
    return secs, res


# Steps a chunk of kernel 21's redesign (csrc/vg.cu kChunk); slots a thread
# of kernel 22's (kTermSlots).
VG_CHUNK = 8
VG_TERM_SLOTS = 4


def family_floors(sass: dict, key: str, n_paths: int, n_steps: int, attempts: float,
                  share: float = 0.0) -> dict:
    """Issue and SFU floors of kernel 21's, 22's or 24's design ``key`` (a
    SASS_KERNELS key) at n_paths x n_steps, antithetic: each loop's
    instructions and MUFU (phase_sass) times its passes, kernels 21 and 22
    at ``attempts`` a draw, their retries as if dense (a pass a retry),
    kernel 22's exact tests on the draws its squeeze leaves (1 - ``share``;
    a pass an entry). Kernel 21's and 24's instructions outside the loops
    are not counted; kernel 22's (no time loop) once a thread (the
    redesign's, kTermSlots slots) or a pair (the first design's). {} where
    phase_sass read no loops."""
    pairs, path_steps = n_paths / 2, n_paths * n_steps
    if key.startswith("vg terminal"):
        p = sass.get("whole", {}).get(key)
        if not p:
            return {}
        parts, m = p["parts"], p["mufu"]
        rest, rest_m = p["outer"] - sum(parts.values()), p["outer_mufu"] - sum(m.values())
        if key == "vg terminal":
            passes = {"first attempts": pairs, "exact tests": (1 - share) * n_paths,
                      "retries": (attempts - 1) * n_paths, "walk": pairs}
            rest_passes = pairs / VG_TERM_SLOTS
        else:
            passes = {"attempts": attempts * pairs, "attempts, mirror": attempts * pairs}
            rest_passes = pairs
        ins = rest * rest_passes + sum(parts[k] * n for k, n in passes.items())
        mu = rest_m * rest_passes + sum(m[k] * n for k, n in passes.items())
    elif key.startswith("sabr"):
        n, mufu = sass.get("loops", {}).get(key), sass.get("mufu", {}).get(key)
        if not n:
            return {}
        ins, mu = n * pairs * n_steps, mufu * pairs * n_steps
    else:
        p = sass.get("nested", {}).get(key)
        if not p:
            return {}
        parts, m = p["parts"], p["mufu"]
        rest, rest_m = p["outer"] - sum(parts.values()), p["outer_mufu"] - sum(m.values())
        if key == "vg paths":
            passes = {"first attempts": pairs * n_steps, "walk": pairs * n_steps,
                      "retries": (attempts - 1) * path_steps}
            rest_passes = pairs * -(-n_steps // VG_CHUNK)
        else:
            passes = {"attempts": attempts * path_steps / 2,
                      "attempts, mirror": attempts * path_steps / 2}
            rest_passes = pairs * n_steps
        ins = rest * rest_passes + sum(parts[k] * n for k, n in passes.items())
        mu = rest_m * rest_passes + sum(m[k] * n for k, n in passes.items())
    return dict(instructions_per_path_step=ins / path_steps, mufu_per_path_step=mu / path_steps,
                issue_floor_ms=ins / PEAK_ISSUE * 1e3, mufu_floor_ms=mu / PEAK_MUFU * 1e3)


def phase_family_timing(sass: dict, attempts: dict, launches: dict) -> dict:
    """Phase 5 for rows 21-24: CUDA-event medians of kernels 21-24 and of
    their plain versions at their legs' shapes (21 at F2's 2^20 x 50 and
    at F3's 64 x 16,384 x 50 batch, 22 at F1's 2^22, 23 with alpha at F5's
    2^20 x 50, 24 with G_T at F4's 2^22 x 64) beside their bounds (the
    integer term at the run's mean gamma attempts, ``attempts``, from F0),
    registers and occupancy. The redesigns of 21, 22 and 24 in turns with their
    first designs (first, new, new, first), each design beside its issue
    and SFU floors (family_floors) and launches x (ms - bound) at the
    families path's launches; the F3 batch through the wrapper (the host
    builds 64 constants rows) and as a bare launch."""
    import numpy as np
    import torch

    from options_model_tpu_torch.ops import cuda_sabr, cuda_vg
    from options_model_tpu_torch.ops.cuda_jumps import device_rows
    from options_model_tpu_torch.utils.profiling import time_per_call

    per_call = sass["per_call"]
    seed = 0x13198A2E03707344
    vg1, vg2, sp, _ = _family_params()
    n20, n22 = 1 << 20, 1 << 22
    Ts = np.linspace(0.1, 1.0, 64).astype(np.float32).tolist()
    a2 = vg_draws(attempts["vg_paths"], True)
    a1 = vg_draws(attempts["vg_terminal"], False)
    ops2 = attempts["vg_paths"] * OPS_VG_ATTEMPT + OPS_VG_BOOST + OPS_VG_STEP
    ops1 = attempts["vg_terminal"] * OPS_VG_ATTEMPT + OPS_VG_STEP
    vg_src, sabr_src = "options_model_tpu_torch/csrc/vg.cu", "options_model_tpu_torch/csrc/sabr.cu"
    vg_f1 = (seed, 100.0, 0.04, 1.0, vg1, n22)
    vg_f2 = (seed, 100.0, 0.05, [0.5], vg2, n20, 50)
    sabr_f4 = (seed, 100.0, 0.5, sp, n22, 64)
    # name -> shape, (plain, kernel[, first design]), bound, (SASS key, paths, steps)
    cases = {
        "vg_paths": (f"{n20} x 50",
                     (lambda: cuda_vg.vg_paths_reference(*vg_f2, device=DEVICE),
                      lambda: cuda_vg.vg_paths(*vg_f2, device=DEVICE),
                      lambda: cuda_vg.vg_paths_first(*vg_f2, device=DEVICE)),
                     bound(n20, 50, ops2, int_ops(a2, per_call), 51 * n20 * 4),
                     ("vg paths", n20, 50, vg_src)),
        "vg_terminal": (f"{n22}",
                        (lambda: cuda_vg.vg_terminal_reference(*vg_f1, device=DEVICE),
                         lambda: cuda_vg.vg_terminal(*vg_f1, device=DEVICE),
                         lambda: cuda_vg.vg_terminal_first(*vg_f1, device=DEVICE)),
                        bound(n22, 1, ops1, int_ops(a1, per_call), n22 * 4),
                        ("vg terminal", n22, 1, vg_src)),
        "sabr_paths": (f"{n20} x 50 with alpha",
                       (lambda: cuda_sabr.sabr_paths_reference(seed, 100.0, 0.5, sp, n20, 50,
                                                               device=DEVICE, return_alpha=True),
                        lambda: cuda_sabr.sabr_paths(seed, 100.0, 0.5, sp, n20, 50,
                                                     device=DEVICE, return_alpha=True)),
                       bound(n20, 50, OPS_SABR, int_ops(DRAWS_SABR, per_call), 2 * 51 * n20 * 4),
                       None),
        "sabr_terminal": (f"{n22} x 64 with G_T",
                          (lambda: cuda_sabr.sabr_terminal_reference(*sabr_f4, device=DEVICE,
                                                                     return_cv=True),
                           lambda: cuda_sabr.sabr_terminal(*sabr_f4, device=DEVICE,
                                                           return_cv=True),
                           lambda: cuda_sabr.sabr_terminal_first(*sabr_f4, device=DEVICE,
                                                                 return_cv=True)),
                          bound(n22, 64, OPS_SABR_CV, int_ops(DRAWS_SABR, per_call),
                                2 * n22 * 4),
                          ("sabr terminal", n22, 64, sabr_src)),
    }
    attrs = {**cuda_vg.vg_kernel_attrs(), **cuda_sabr.sabr_kernel_attrs()}
    out = {}
    log_clocks("before the family kernels")

    def floors(row, key, label, t, n, steps):
        draws = "vg_terminal" if key.startswith("vg terminal") else "vg_paths"
        fl = family_floors(sass, key, n, steps, attempts[draws], attempts["squeeze_share"])
        if not fl:
            log(f"[5] {key}: no SASS loops read, no floors")
            return
        row.update(fl if label == "redesign" else {f"earlier_{k}": x for k, x in fl.items()})
        log(f"[5] {key} ({label}) at {n} x {steps}: {fl['instructions_per_path_step']:.1f} SASS "
            f"instructions a path-step ({fl['mufu_per_path_step']:.2f} MUFU): issue floor "
            f"{fl['issue_floor_ms']:.4f} ms ({fl['issue_floor_ms'] / t * 100:.1f}% of its "
            f"{t:.4f} ms), SFU floor {fl['mufu_floor_ms']:.4f} ms")

    for name, (shape, runs, b, sass_case) in cases.items():
        if len(runs) == 3:
            first, run = runs[2], runs[1]
            turns = [time_per_call(f, N_TIMED) for f in (first, run, run, first)]
            ms = (turns[1] + turns[2]) / 2
        else:
            ms = time_per_call(runs[1], N_TIMED)
        plain_ms = time_per_call(runs[0], 3)
        a = attrs[name]
        out[name] = row = dict(ms=ms, plain_ms=plain_ms, shape=shape, registers=a["registers"],
                               spill_bytes=a["spill_bytes"], block=a["block"],
                               occupancy=a["blocks_per_sm"] * a["block"] / THREADS_PER_SM, **b)
        log(f"[5] {name} at {shape}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; bound "
            f"{b['bound_ms']:.4f} ms by {b['bound_term']} (without the integer term "
            f"{b['bound_ms_f32_bytes']:.4f}); {b['bound_ms'] / ms * 100:.1f}% of bound; "
            f"{a['registers']} registers, {a['spill_bytes']} spill bytes, {a['blocks_per_sm']} "
            f"blocks of {a['block']} per SM ({row['occupancy'] * 100:.1f}% occupancy)")
        if sass_case is None:
            continue
        key, n, steps, src = sass_case
        row.update(first_design_row(FAMILY_FIRSTS[name], src, shape, turns, b["bound_ms"],
                                    attrs[FAMILY_FIRSTS[name]]))
        floors(row, key, "redesign", ms, n, steps)
        floors(row, f"{key}, first design", "first design", row["earlier_ms"], n, steps)
        k = launches.get(name, 0)
        log(f"[5] {name}: launches x (ms - bound) on the families path, {k} launches: redesign "
            f"{k * (ms - b['bound_ms']):.4f} ms, first design "
            f"{k * (row['earlier_ms'] - b['bound_ms']):.4f} ms")

    # the F3 batch: through the wrapper (64 constants rows built on the host
    # and copied in) and as a bare launch, both designs in turns
    wrapped = {d: (lambda fn=fn: fn(seed, 100.0, 0.05, Ts, vg2, 16384, 50, device=DEVICE))
               for d, fn in (("new", cuda_vg.vg_paths), ("first", cuda_vg.vg_paths_first))}
    rows = device_rows(cuda_vg.vg_rows(100.0, 0.05, Ts, vg2, 50), DEVICE)
    S = torch.empty((64, 51, 16384), dtype=torch.float32, device=DEVICE)
    bare = {d: (lambda f=f: cuda_vg.launch_vg_paths(S, None, None, rows, seed, 0, True, f))
            for d, f in (("new", False), ("first", True))}
    t = {}
    for label, fns in (("wrapped", wrapped), ("bare", bare)):
        t[label] = [time_per_call(fns[d], N_TIMED) for d in ("first", "new", "new", "first")]
    host = []
    for _ in range(21):
        t0 = time.perf_counter()
        device_rows(cuda_vg.vg_rows(100.0, 0.05, Ts, vg2, 50), DEVICE)
        host.append((time.perf_counter() - t0) * 1e3)
    host_ms = statistics.median(host)
    b = bound(64 * 16384, 50, ops2, int_ops(a2, per_call), 64 * 51 * 16384 * 4)
    mean = lambda x, i, j: (x[i] + x[j]) / 2  # noqa: E731
    out["vg_paths"]["surface_batch"] = dict(
        ms=mean(t["wrapped"], 1, 2), bare_ms=mean(t["bare"], 1, 2),
        earlier_ms=mean(t["wrapped"], 0, 3), earlier_bare_ms=mean(t["bare"], 0, 3),
        host_rows_ms=host_ms, turns=t, shape="64 x 16384 x 50", **b)
    sb = out["vg_paths"]["surface_batch"]
    log(f"[5] vg_paths at the F3 batch 64 x 16,384 x 50 (one launch), in turns (first, new, "
        f"new, first): through the wrapper {sb['ms']:.4f} ms (first design "
        f"{sb['earlier_ms']:.4f}), a bare launch {sb['bare_ms']:.4f} ms (first design "
        f"{sb['earlier_bare_ms']:.4f}); the host's 64 constants rows {host_ms:.4f} ms (median; "
        f"beyond the timer's ~0.26 ms lead they count in a wrapped time); bound "
        f"{b['bound_ms']:.4f} ms by {b['bound_term']} ({b['bound_ms'] / sb['bare_ms'] * 100:.1f}"
        f"% of the bare launch); turns {t}")
    for k in ("sabr_paths beta<1", "sabr_terminal beta<1"):
        a = attrs[k]
        log(f"[5] {k}: {a['registers']} registers, {a['spill_bytes']} spill bytes, "
            f"{a['blocks_per_sm']} blocks of {a['block']} per SM")
    log_clocks("after the family kernels")
    log(f"[5] families path launches: {launches}")
    return out


# The rough path (phase R, the [R] lines; ``chip_smoke.py --path rough``, a
# process of its own): rough Bergomi on the fused kernel (csrc/rbergomi.cu
# rbergomi_fused_kernel; its first design, kernels 25-26 around the
# Volterra matmul, only in R0 and phase 5) and the dual's VG, SABR and
# rough Bergomi families of kernel 18 (csrc/dual.cu). R0 holds the kernels
# against their plain versions; R1-R5 and D6-D9 drive the entry points at
# the JAX tests' configurations and bars (tests/test_rbergomi.py,
# tests/test_rbergomi_calibration.py, tests/test_apps.py:637-650,
# tests/test_vg.py:293-312, tests/test_dual.py:484-548); the full-width
# brackets run each family at D1's scale. The rough kernels are timed in
# phase 5 of the main process, after the join.
RB_ROUGH = dict(H=0.1, eta=1.5, rho=-0.7, xi0=0.04)
RB_D8 = dict(H=0.5, eta=1.0, rho=-0.5, xi0=0.04)    # D8: H = 1/2 against the drift ADI
# The fused kernel and kernel 26 against their plain versions on the card:
# S and v rtol (each does the same _rn operations as its plain version with
# the same libdevice expf and sqrtf, so they are expected bit for bit; the
# tolerance allows for neither). The fused kernel against the first design:
# the same rtol (G summed in ascending order against cuBLAS's order).
RB_RTOL = 1e-5
RB_SHAPE = (1 << 20, 50)                # R5's paths, the rough kernels at the path's shape
# R4's engine at its expiries' step counts (paths, steps, T): 96 steps a
# year, at least 32 (calibration/rbergomi._surface_ivs)
RB_CV_SHAPES = ((1 << 16, 32, 0.1), (1 << 16, 48, 0.5), (1 << 16, 96, 1.0))
RB_FIRST = ("rbergomi_dw, first design", "rbergomi_paths, first design")
# Kernel 18's first designs of the VG, SABR and rough Bergomi families
# (dual_ce_kernel's instances) and VG's terminal step's (one thread a path),
# the yardsticks of their redesigns: R0 and phase 5 alone.
ROUGH_DUAL_FIRSTS = ("dual_ce vg, first design", "dual_ce sabr, first design",
                     "dual_ce rbergomi, first design", "dual_vg_terminal, first design")
ROUGH_DUAL = {"vg": dict(vg=dict(sigma=0.18, theta=-0.14, nu=0.35)),
              "sabr": dict(sabr=dict(alpha=0.2, beta=1.0, rho=-0.4, nu=0.6)),
              "rbergomi": dict(rbergomi=RB_ROUGH)}
ROUGH_DUAL_SHAPE = (1 << 17, 50)        # D1's scale, n_inner 64
# Kernel 18's VG redesign: pairs a lane a chunk (csrc/dual.cu kClockChunk).
DUAL_VG_CHUNK = 8
# Kernel 18's rough Bergomi redesign: its v' = A e^{+-s} against the plain
# version's, relative; the budget csrc/dual.cu states beside
# dual_ce_rough_kernel (u0 (13 + 4 |eta h - comp| + 10 |s|), under 1e-5 on
# the brackets' histories and normals).
RB_VPRIME_RTOL = 1e-5
# Kernel 18's SABR redesign: its alpha' = A e^{+-s} against the plain
# version's, relative; the budget csrc/dual.cu states beside
# dual_ce_sabr_kernel (u0 (17 + 10 B + nu^2 dt / 2), 1.31e-6 at D7's nu and
# dt, under 1e-5 wherever B = nu sqrt(dt) (|rho z1| + |rho_bar z2|) <= 15).
SABR_APRIME_RTOL = 1e-5
# VG's terminal step: the clock draws a path R0 checks beyond DUAL_INNER / 2,
# D6's 16 and a tail of 5 (neither a warp nor a warp's chunk a multiple of it).
TERMINAL_HALVES = (16, 5)
ROUGH_DUAL_T = 0.5
R1_Z = 4.0
R2_SE, R2_MISS = 4.5, 10.0
R3_SLOPE = 0.15
# R4: tests/test_rbergomi_calibration.py:113-116's bars; BENCH_r05's JAX
# readings of the same leg (relative errors, IV RMSE), printed beside.
R4_XI0_REL, R4_H_ABS, R4_ETA_REL, R4_RMSE = 0.25, 0.15, 0.5, 0.02
JAX_R05_RB = dict(H=0.0443, eta=0.0104, xi0=0.0034, iv_rmse=0.001654)
# f32 operations and Philox draws (calls, words made uniform) per
# path-step, counted from csrc/rbergomi.cu: kernel 25 (the first design) a
# Box-Muller (11) per pair-step and a multiply. The fused kernel, per
# pair-step: two Box-Mullers, dW 1, Y 5, dB 3 (OPS_RB_FUSED_PAIR) and the
# Volterra rows' n_steps - 1 products and sums on average; per path-step
# the walk's price step 7 and v 4 (OPS_RB_WALK), a stored S 2 or the CV's
# log step 3 (ops_rb_fused); two Philox calls and four words a pair-step.
OPS_RB_DW = 11 / 2 + 1
OPS_RB_FUSED_PAIR = 2 * 11 + 1 + 5 + 3
OPS_RB_WALK = 7 + 4
DRAWS_RB_DW = (1 / 2, 1)
DRAWS_RB_FUSED = (1, 2)


def ops_rb_fused(n_steps: int, mode: str) -> float:
    """The fused kernel's f32 operations a path-step (antithetic) at
    n_steps in ``mode`` ("paths" with S stored, "terminal", "cv")."""
    extra = {"paths": 2, "terminal": 0, "cv": 3}[mode]
    return (OPS_RB_FUSED_PAIR + n_steps - 1) / 2 + OPS_RB_WALK + extra


def rough_specs():
    """The fused rough Bergomi kernel (csrc/rbergomi.cu), kernel 18's VG,
    SABR and rough Bergomi families and VG's terminal kernel
    (csrc/dual.cu): name, source, the XLA function each replaces, the paths
    that run it, its counter."""
    from options_model_tpu_torch.ops import cuda_dual, cuda_rbergomi

    rb_src, dual_src = ("options_model_tpu_torch/csrc/rbergomi.cu",
                        "options_model_tpu_torch/csrc/dual.cu")
    specs = [
        dict(name="rbergomi_fused", source=rb_src,
             replaces="options_model_tpu/models/rbergomi.py:128 simulate_rbergomi (dW :187, "
                      "the matmul :192, the walk :193-217) and :234 terminal_cv_core (:265)",
             paths=("rough",), counter=(cuda_rbergomi.launches, "rbergomi_fused")),
    ]
    for model, lines in (("vg", ":634-675"), ("sabr", ":442-489"), ("rbergomi", ":490-561")):
        specs.append(dict(name=f"dual_ce {model}", source=dual_src,
                          replaces=f"options_model_tpu/pricers/dual.py:292 (date_ce, {lines})",
                          paths=("rough",), counter=(cuda_dual.launches, f"dual_ce {model}")))
    specs.append(dict(name="dual_vg_terminal", source=dual_src,
                      replaces="options_model_tpu/pricers/dual.py:676-686",
                      paths=("rough",), counter=(cuda_dual.launches, "dual_vg_terminal")))
    return specs


def _rough_params(model: str, params: dict = None):
    """{model: its params}: ROUGH_DUAL's, or ``params``."""
    from options_model_tpu_torch.core.config import RBergomiParams, SABRParams, VGParams

    cls = {"vg": VGParams, "sabr": SABRParams, "rbergomi": RBergomiParams}[model]
    return {model: cls(**(params or ROUGH_DUAL[model][model]))}


def rough_dual_case(model: str, n_paths: int, n_steps: int = 50, T: float = ROUGH_DUAL_T,
                    seed: int = 5, cp: float = -1.0, degree: int = 3,
                    params: dict = None) -> dict:
    """A VG, SABR or rough Bergomi bracket's inputs at n_paths x n_steps:
    the port's paths (kernels 21, 23, or 25-26 with the dual state), the
    policy fitted on them, x = S / K, its rows, the law, rough Bergomi's
    hist and comp. A put, or a call on a dividend payer (q 0.03); the
    model's params ROUGH_DUAL's, or ``params``."""
    import torch

    from options_model_tpu_torch.core.config import MCConfig, OptionSpec
    from options_model_tpu_torch.models.rbergomi import simulate_rbergomi
    from options_model_tpu_torch.ops import cuda_dual
    from options_model_tpu_torch.ops.philox import seed_from_generator
    from options_model_tpu_torch.pricers import american as pa
    from options_model_tpu_torch.pricers import dual as pd

    q = 0.03 if cp > 0 else 0.0
    spec = OptionSpec(strike=100.0, rate=0.05, cp=cp, sigma=None, div_yield=q)
    kw = _rough_params(model, params)
    mc = MCConfig(n_paths=n_paths, n_steps=n_steps, path_block=4096)
    gen = torch.Generator(DEVICE).manual_seed(seed)
    hist = comp = None
    if model == "rbergomi":
        S, v, hist = simulate_rbergomi(seed_from_generator(gen), 100.0, T, kw["rbergomi"], mc,
                                       0.05 - q, return_paths=True, return_variance=True,
                                       return_dual_state=True, device=DEVICE)
        comp = torch.from_numpy(pd.rbergomi_comp(kw["rbergomi"], T, n_steps)).to(DEVICE)
    else:
        out = pa.simulate_paths(gen, 100.0, T, mc, model, rate=0.05, div_yield=q,
                                return_variance=model == "sabr", device=DEVICE, **kw)
        S, v = out if model == "sabr" else (out, None)
    policy, _ = pd.fit_lsm_policy(S, spec, T, v_paths=v, poly_degree=degree)
    taus = torch.from_numpy(pd.date_taus(T, n_steps)).to(DEVICE)
    law = pd.inner_law(model, spec, T, n_steps, **kw)
    return dict(S=S, v=v, hist=hist, comp=comp, spec=spec, policy=policy, law=law, taus=taus,
                x=S / torch.tensor(law.K, device=DEVICE), rows=cuda_dual.policy_rows(policy, taus),
                T=T, n_steps=n_steps)


def phase_rough_kernels() -> dict:
    """R0: the fused rough Bergomi kernel, the first design's kernels 25 and
    26 and kernel 18's VG, SABR and rough Bergomi families against their
    plain versions on the card. The rough Bergomi stream's words bit for
    bit. The fused kernel in each mode (S, v, the dual state hist; S_T,
    v_T; S_T, G_T), antithetic and not, at H = 0.1 and 1/2 (2 tiles x 50),
    R5's 2^20 x 50 and 2 tiles x MAX_STEPS (the dynamic shared memory): S
    and v within RB_RTOL of plain (the largest differences printed, bit for
    bit expected), hist bit for bit, a first_tile = 1 chunk bit for bit,
    and S and v within RB_RTOL of the first design's. The first design
    (2 tiles x 50 at both H and R5's shape): kernel 25's dW bit for bit,
    kernel 26 within RB_RTOL on S and v and hist bit for bit, first_tile
    chunks of both bit for bit. Kernel 18's families at 2 tiles (a put and
    a call each, so every instance runs) and at their brackets' shapes and
    configurations (D6-D9; VG and SABR also at the full-width 2^17 x 50):
    ce within DUAL_CE_ATOL, the inner states (kernel 19's instances), VG's
    clock draws and their attempts bit for bit, a first_tile chunk of ce
    bit for bit; VG's terminal step through terminal_checks; the VG, SABR
    and rough Bergomi redesigns also through rough_redesign_checks, and
    beyond 2 tiles their upper within DUAL_UPPER_SE stderr of their first
    design's (dual_upper_both). Fails if an instance of the rough kernels,
    of kernel 18's VG, SABR and rough Bergomi designs or of VG's terminal
    step has local memory. Returns the largest errors by kernel (the first
    design's under earlier_*)."""
    import torch

    from options_model_tpu_torch.core.config import RBergomiParams
    from options_model_tpu_torch.models.rbergomi import rbergomi_constants, volterra
    from options_model_tpu_torch.ops import cuda_dual as cd
    from options_model_tpu_torch.ops import cuda_rbergomi as cr
    from options_model_tpu_torch.ops.cuda_heston import PATH_TILE
    from options_model_tpu_torch.ops.philox import (RBERGOMI_STREAM, stream_words,
                                                    stream_words_cuda)

    seed, tile = 0x5DEECE66D, 4096
    errs = {k["name"]: dict(max_abs_err=0.0, max_rel_err=0.0) for k in rough_specs()}
    fused = errs["rbergomi_fused"]
    fused.update(earlier_max_abs_err=0.0, earlier_max_rel_err=0.0, vs_first_max_rel_err=0.0)
    attrs = cr.rbergomi_kernel_attrs(50)
    attrs.update({f"{k} at {cr.MAX_STEPS} steps": a
                  for k, a in cr.rbergomi_kernel_attrs(cr.MAX_STEPS).items()
                  if k.startswith("rbergomi_fused")})
    attrs.update({k: a for k, a in cd.dual_kernel_attrs().items()
                  if k.split()[-1] in ROUGH_DUAL or k.startswith("dual_vg_terminal")})
    log("[R0] registers / local bytes a thread / resident blocks of threads an SM (occupancy): "
        + ", ".join(f"{k} {a['registers']} / {a['spill_bytes']} / {a['blocks_per_sm']} of "
                    f"{a['block']} ({a['blocks_per_sm'] * a['block'] / THREADS_PER_SM:.1%})"
                    for k, a in attrs.items()))
    local = {k: a["spill_bytes"] for k, a in attrs.items() if a["spill_bytes"]}
    if local:
        fail(f"R0: a rough kernel has local memory: {local}")
    w = stream_words_cuda(seed, 3, 2, 2048, 8, DEVICE, stream=RBERGOMI_STREAM)
    if not torch.equal(w.cpu(), stream_words(seed, 3, 2, 2048, 8, stream=RBERGOMI_STREAM)):
        fail("R0: the rough Bergomi stream's Philox words differ from the plain version's")
    log("[R0] the rough Bergomi stream's Philox words (counter word 3 = 4), 2 tiles x 8 draws: "
        "kernel == plain bit for bit")

    def rel(a, b):
        return float(((a - b).abs() / b.abs().clamp_min(1e-30)).max())

    names = {"paths": ("S", "v", "hist"), "terminal": ("S_T", "v_T"), "cv": ("S_T", "G_T")}
    modes = {"paths": dict(return_variance=True, return_dual_state=True),
             "terminal": dict(return_variance=True), "cv": {}}

    def held(tag, got, want, mode, what, e, prefix=""):
        """got against want: finite, hist bit for bit, the rest within
        RB_RTOL; the largest differences into e and printed."""
        diffs = {}
        for name, a, b in zip(names[mode], got, want):
            if not bool(torch.isfinite(a).all()):
                fail(f"R0: {tag} {mode} {what}: non-finite {name}")
            if name == "hist":
                if not torch.equal(a, b):
                    fail(f"R0: {tag}'s dual state at {what} differs from plain")
                continue
            diffs[name] = (float((a - b).abs().max()), rel(a, b))
            if diffs[name][1] > RB_RTOL:
                fail(f"R0: {tag} {mode} {what}: {name} rel {diffs[name][1]:.3e} > {RB_RTOL}")
            e[prefix + "max_abs_err"] = max(e[prefix + "max_abs_err"], diffs[name][0])
            e[prefix + "max_rel_err"] = max(e[prefix + "max_rel_err"], diffs[name][1])
        bits = all(torch.equal(a, b) for a, b in zip(got, want))
        log(f"[R0] {tag} {mode} at {what}: "
            + ", ".join(f"{n} max |d| {d[0]:.3e} rel {d[1]:.3e}" for n, d in diffs.items())
            + (" (bit for bit)" if bits else ""))

    cases = ((0.1, 2 * PATH_TILE, 50), (0.5, 2 * PATH_TILE, 50), (0.1,) + RB_SHAPE,
             (0.1, 2 * PATH_TILE, cr.MAX_STEPS))
    for H, n_paths, n_steps in cases:
        p = RBergomiParams(**dict(RB_ROUGH, H=H))
        n_tiles = n_paths // PATH_TILE
        for anti in (True, False):
            what = f"H {H}, {n_paths} x {n_steps}, {'antithetic' if anti else 'plain'}"
            for mode, kw in modes.items():
                args = (seed, 100.0, 1.0, p, n_paths, n_steps, 0.05, mode, anti)
                got = cr.rbergomi_fused(*args, 0, DEVICE, **kw)
                want = cr.rbergomi_fused_reference(*args, 0, DEVICE, **kw)
                torch.cuda.synchronize()
                held("the fused kernel", got, want, mode, what, fused)
                del want
                tail = cr.rbergomi_fused(seed, 100.0, 1.0, p, n_paths - PATH_TILE, n_steps, 0.05,
                                         mode, anti, 1, DEVICE, **kw)
                if not all(torch.equal(a[..., PATH_TILE:], b) for a, b in zip(got, tail)):
                    fail(f"R0: the fused kernel {mode} {what}: a first_tile chunk differs from "
                         "the slice")
                first = cr.rbergomi_simulate_first(*args, 0, DEVICE, **kw)
                for name, a, b in zip(names[mode], got, first):
                    if name != "hist":
                        r = rel(a, b)
                        fused["vs_first_max_rel_err"] = max(fused["vs_first_max_rel_err"], r)
                        if r > RB_RTOL:
                            fail(f"R0: the fused kernel {mode} {what}: {name} rel {r:.3e} from "
                                 f"the first design's > {RB_RTOL}")
                del got, tail, first
            log(f"[R0] the fused kernel at {what}: first_tile=1 chunks bit for bit; S and v "
                f"within {RB_RTOL} of the first design's (largest rel so far "
                f"{fused['vs_first_max_rel_err']:.3e})")
        if n_steps == cr.MAX_STEPS:
            continue
        c = rbergomi_constants(100.0, 1.0, p, n_steps, 0.05)
        what = f"H {H}, {n_paths} x {n_steps}"
        dW = cr.rbergomi_dw(seed, 0, n_tiles, n_steps, c["sqrt_dt"], True, DEVICE)
        ref = cr.rbergomi_dw_reference(seed, 0, n_tiles, n_steps, c["sqrt_dt"], True, DEVICE)
        torch.cuda.synchronize()
        if not torch.equal(dW, ref):
            fail(f"R0: kernel 25's dW at {what} differs from plain")
        part = cr.rbergomi_dw(seed, 1, n_tiles - 1, n_steps, c["sqrt_dt"], True, DEVICE)
        if not torch.equal(part, dW[:, PATH_TILE:]):
            fail("R0: kernel 25's first_tile chunk differs from the full run's slice")
        G = volterra(torch.from_numpy(c["W_mat"]), dW)
        for mode, kw in modes.items():
            got = cr.rbergomi_paths(dW, G, c, seed, 0, True, mode, **kw)
            want = cr.rbergomi_paths_reference(dW, G, c, seed, 0, True, mode, **kw)
            torch.cuda.synchronize()
            held("kernel 26 (first design)", got, want, mode, what, fused, "earlier_")
            tail = cr.rbergomi_paths(dW[:, PATH_TILE:].contiguous(), G[:, PATH_TILE:].contiguous(),
                                     c, seed, 1, True, mode, **kw)
            if not all(torch.equal(a[..., PATH_TILE:], b) for a, b in zip(got, tail)):
                fail(f"R0: kernel 26 {mode} {what}: a first_tile chunk differs from the slice")
        log(f"[R0] kernel 25 (first design) at {what}: dW == plain bit for bit; first_tile=1 "
            "chunks of kernels 25 and 26 bit for bit")
        del dW, G, ref, part

    n_inner = 64
    dual_attrs = {k: a for k, a in cd.dual_kernel_attrs().items()
                  if (k.startswith("dual_ce") and any(f" {m}" in k for m in cd.REDESIGNED_FAMILIES))
                  or k.startswith("dual_vg_terminal")}
    log("[R0] kernel 18's VG, SABR and rough Bergomi instances and VG's terminal step's, "
        "registers / local bytes a thread / occupancy: " + ", ".join(
            f"{k} {a['registers']} / {a['spill_bytes']} / "
            f"{a['blocks_per_sm'] * a['block'] / THREADS_PER_SM:.1%}"
            for k, a in dual_attrs.items()))
    if any(a["spill_bytes"] for a in dual_attrs.values()):
        fail("R0: an instance of kernel 18's VG, SABR or rough Bergomi designs or of VG's "
             "terminal step has local memory")
    # each family at 2 tiles (a put and a call) and at its brackets' shapes
    # and configurations: D6 (VG), D7 (SABR), D8 and D9 (rough Bergomi); VG
    # and SABR also at the full-width bracket's shape
    brackets = {"vg": [(1 << 14, 20, None), ROUGH_DUAL_SHAPE + (None,)],
                "sabr": [(1 << 15, 40, None), ROUGH_DUAL_SHAPE + (None,)],
                "rbergomi": [(1 << 15, 40, RB_D8), (1 << 14, 30, None)]}
    for model in ROUGH_DUAL:
        for n, cp, steps, T, params in ([(2 * tile, -1.0, 20, 0.5, None),
                                         (2 * tile, 1.0, 20, 0.5, None)]
                                        + [(n_b, -1.0, s_b, 0.5, p_b)
                                           for n_b, s_b, p_b in brackets[model]]):
            case = rough_dual_case(model, n, steps, T, cp=cp, params=params)
            x, v, rows, law = case["x"], case["v"], case["rows"], case["law"]
            hist, comp = case["hist"], case["comp"]
            what = (f"{model} {'call' if cp > 0 else 'put'}, {n} x {steps}"
                    + (f" (H {params['H']}, eta {params['eta']})" if params else ""))
            args = (seed, 0, tile, n_inner)
            ce = cd.dual_ce(x, v, rows, law, *args, hist, comp)
            ref = cd.dual_ce_reference(x, v, rows, law, *args, hist, comp)
            torch.cuda.synchronize()
            d = (ce - ref).abs()
            if not bool(torch.isfinite(ce).all()) or float(d.max()) > DUAL_CE_ATOL:
                fail(f"R0: dual_ce {what}: ce differs from plain (max {float(d.max()):.3e})")
            e = errs[f"dual_ce {model}"]
            e["max_abs_err"] = max(e["max_abs_err"], float(d.max()))
            h = n // 2 // tile * tile
            part = cd.dual_ce(x[:, h:].contiguous(), None if v is None else v[:, h:].contiguous(),
                              rows, law, seed, h // tile, tile, n_inner,
                              None if hist is None else hist[:, h:].contiguous(), comp)
            if not torch.equal(part, ce[:, h:]):
                fail(f"R0: dual_ce {what}: a first_tile chunk differs from the full run's slice")
            xs, vs, cn = cd.dual_inner_states(x, v, law, *args, 0, 3, True, hist, comp)
            xr, vr, cr_ = cd.dual_inner_states_reference(x, v, law, *args, 0, 3, True, hist,
                                                          comp)
            torch.cuda.synchronize()
            if not (torch.equal(xs, xr) and torch.equal(vs, vr) and torch.equal(cn, cr_)):
                fail(f"R0: {what}: the inner states (rel x' {rel(xs, xr):.3e}, second state "
                     f"{rel(vs, vr):.3e}) or {'attempts' if model == 'vg' else 'counts'} "
                     "differ from plain")
            extra = ""
            if model == "vg":
                extra = (f"; clock draws and attempts (dates 0-2, {cn.numel()}, mean attempt "
                         f"{float(cn.float().mean()):.4f}, max {int(cn.max())}) bit for bit"
                         + terminal_checks(case, seed, tile, what, errs["dual_vg_terminal"]))
            if model in cd.REDESIGNED_FAMILIES:
                extra += rough_redesign_checks(model, case, args, ref, errs[f"dual_ce {model}"],
                                               what)
                if n != 2 * tile:
                    e["upper_d_stderr"] = max(e.get("upper_d_stderr", 0.0), dual_upper_both(
                        model, case, seed, tile, "R0")["d_stderr"])
            log(f"[R0] {what}, n_inner {n_inner}: dual_ce == plain within {DUAL_CE_ATOL} (max "
                f"|d| {float(d.max()):.3e}, mean {float(d.mean()):.3e}); first_tile="
                f"{h // tile} chunk bit for bit; inner states (dates 0-2) bit for bit{extra}")
    return errs


def terminal_checks(case: dict, seed: int, tile: int, what: str, err: dict) -> str:
    """R0's checks of VG's terminal step on a VG case's last date (the clock
    draws of date n_dates), at DUAL_INNER / 2 draws a path and at each of
    TERMINAL_HALVES: the redesign's e_h and its first design's within
    DUAL_CE_ATOL of plain; the redesign's debug instance's every clock G =
    nu gamma and accepting attempt dual_gamma_draws' bit for bit, its e_h
    within DUAL_CE_ATOL; a first_tile chunk of the redesign's e_h the full
    run's slice bit for bit. Returns the log's part."""
    import torch

    from options_model_tpu_torch.ops import cuda_dual as cd
    from options_model_tpu_torch.ops.philox import dual_gamma_draws

    x, law, n_dates = case["x"], case["law"], case["rows"].shape[0]
    xl = x[n_dates].contiguous()
    n = xl.shape[0]
    h = n // 2 // tile * tile
    parts = []
    for half in (DUAL_INNER // 2,) + TERMINAL_HALVES:
        args = (law, seed, 0, tile, 2 * half, n_dates)
        eh = cd.dual_vg_terminal(xl, *args)
        e1 = cd.dual_vg_terminal_first(xl, *args)
        ed, G, att, passes = cd.dual_vg_terminal_debug(xl, *args)
        ref = cd.dual_vg_terminal_reference(xl, *args)
        gam, att_r = dual_gamma_draws(seed, 0, n // tile, tile, half, n_dates, law.gamma_shape,
                                      xl.device)
        part = cd.dual_vg_terminal(xl[h:].contiguous(), law, seed, h // tile, tile, 2 * half,
                                   n_dates)
        torch.cuda.synchronize()
        d, d1, dd = (float((t - ref).abs().max()) for t in (eh, e1, ed))
        err["max_abs_err"] = max(err["max_abs_err"], d)
        err["earlier_max_abs_err"] = max(err.get("earlier_max_abs_err", 0.0), d1)
        if not (max(d, d1, dd) <= DUAL_CE_ATOL and bool(torch.isfinite(eh).all())):
            fail(f"R0: dual_vg_terminal {what}, {half} draws a path: e_h differs from plain "
                 f"(redesign {d:.3e}, first design {d1:.3e}, debug instance {dd:.3e})")
        if not (torch.equal(G.view(torch.int32), (law.nu * gam).view(torch.int32))
                and torch.equal(att, att_r)):
            fail(f"R0: dual_vg_terminal {what}, {half} draws a path: the redesign's clock G or "
                 "accepting attempts differ from dual_gamma_draws'")
        if not torch.equal(part, eh[h:]):
            fail(f"R0: dual_vg_terminal {what}, {half} draws a path: a first_tile chunk differs "
                 "from the full run's slice")
        pm = passes.float().mean(dim=0)
        parts.append(f"{half} draws: redesign {d:.3e}, first design {d1:.3e}, debug instance "
                     f"{dd:.3e}{' (the redesign bit for bit)' if torch.equal(ed, eh) else ''}; "
                     f"G and attempts (mean {float(att.float().mean()):.4f}, max "
                     f"{int(att.max())}) bit for bit; a warp's passes: exact tests "
                     f"{float(pm[0]):.3f}, retries {float(pm[1]):.3f}")
    return (f"; dual_vg_terminal at date {n_dates} within {DUAL_CE_ATOL} of plain, first_tile="
            f"{h // tile} chunks bit for bit: " + "; ".join(parts))


def rough_redesign_checks(model: str, case: dict, args: tuple, ref, err: dict,
                          what: str) -> str:
    """R0's checks of kernel 18's VG, SABR or rough Bergomi redesign beyond
    its ce (``ref`` the plain ce on ``args``): its first design's ce within
    DUAL_CE_ATOL of plain; its debug instance's ce within DUAL_CE_ATOL, and
    every date's clock G and accepting attempt (VG) or x' (SABR, rough
    Bergomi) the plain version's bit for bit, alpha' within
    SABR_APRIME_RTOL and v' within RB_VPRIME_RTOL. Returns the log's part."""
    import torch

    from options_model_tpu_torch.ops import cuda_dual as cd

    x, v, rows, law = case["x"], case["v"], case["rows"], case["law"]
    hist, comp, n_dates = case["hist"], case["comp"], case["rows"].shape[0]
    ce1 = cd.dual_ce_first(x, v, rows, law, *args, hist, comp)
    out = cd.dual_ce_debug(x, v, rows, law, *args, hist, comp)
    xr, vr, cr_ = cd.dual_inner_states_reference(x, v, law, *args, 0, n_dates, True, hist, comp)
    torch.cuda.synchronize()
    d1, dd = float((ce1 - ref).abs().max()), float((out[0] - ref).abs().max())
    err["earlier_max_abs_err"] = max(err.get("earlier_max_abs_err", 0.0), d1)
    if not (d1 <= DUAL_CE_ATOL and dd <= DUAL_CE_ATOL and bool(torch.isfinite(out[0]).all())):
        fail(f"R0: dual_ce {what}: the first design's ce ({d1:.3e}) or the debug instance's "
             f"({dd:.3e}) differs from plain")
    if model == "vg":
        _, G, att, passes = out
        if not (torch.equal(G.view(torch.int32), vr[:, 0].view(torch.int32))
                and torch.equal(att, cr_)):
            fail(f"R0: {what}: the redesign's clock G or accepting attempts differ from plain")
        pm = passes.float().mean(dim=(0, 1))
        return (f"; the redesign's clock G and attempts (all {n_dates} dates, mean attempt "
                f"{float(att.float().mean()):.4f}) bit for bit, a warp's passes a date: exact "
                f"tests {float(pm[0]):.3f}, retries {float(pm[1]):.3f}; first design within "
                f"{d1:.3e}, debug instance {dd:.3e}")
    _, xs, vs = out
    rel = float(((vs - vr).abs() / vr.abs()).max())
    name, bound_ = ("alpha'", SABR_APRIME_RTOL) if model == "sabr" else ("v'", RB_VPRIME_RTOL)
    err["second_state_max_rel_err"] = max(err.get("second_state_max_rel_err", 0.0), rel)
    if not (torch.equal(xs, xr) and rel <= bound_):
        fail(f"R0: {what}: the redesign's x' differs from plain, or {name} by {rel:.3e} "
             f"relative (bound {bound_})")
    return (f"; the redesign's x' (all {n_dates} dates) bit for bit, {name} within {rel:.3e} "
            f"relative (bound {bound_}); first design within {d1:.3e}, debug instance "
            f"{dd:.3e}")


def phase_rough() -> dict:
    """The rough path (``--path rough``): R0 (phase_rough_kernels), then,
    every launch count at 0, the entry points a user calls. R1 the hybrid
    scheme's ATM put (H 0.1, 2^16 x 50, rbergomi_european_mc) against the
    exact-covariance Cholesky oracle, |z| < R1_Z; R2 the H = 1/2 European
    put (eta 1.2, rho -0.6, 2^17 x 100) within R2_SE stderr of the
    drift-extended ADI (pricers/fd_sabr, alpha_drift = -eta^2/8), the
    driftless ADI more than R2_MISS away; R3 the ATM-skew power law (T in
    0.05-1, 2^16 x 64, common random numbers), slope within R3_SLOPE of H -
    1/2; R4 bench.py's calibration leg at its defaults, at the JAX round
    trip's bars; R5 the American put at 2^20 x 50 on the (S, v) basis, >=
    the European - 4 combined stderr; D6-D9 the VG, SABR, H = 1/2 and rough
    brackets at the JAX tests' configurations and bars; the full-width
    brackets (ROUGH_DUAL_SHAPE, n_inner 64). Fails if a rough kernel was
    never launched after R0, or a first design (ROUGH_DUAL_FIRSTS, kernels
    25-26) was. Returns the errors, seconds and results."""
    import numpy as np
    import torch

    from options_model_tpu_torch.calibration.rbergomi import (calibrate_rbergomi_to_data,
                                                              create_synthetic_rbergomi_surface)
    from options_model_tpu_torch.core.config import (LSMConfig, MCConfig, OptionSpec,
                                                      RBergomiParams, SABRParams)
    from options_model_tpu_torch.models.rbergomi import (rbergomi_european_mc,
                                                         rbergomi_exact_chol)
    from options_model_tpu_torch.pricers.american import price_american, price_american_lsm
    from options_model_tpu_torch.pricers.blackscholes import implied_vol
    from options_model_tpu_torch.pricers.dual import price_american_bracket
    from options_model_tpu_torch.pricers.fd_sabr import sabr_fd_price

    t_phase = time.perf_counter()
    errs = phase_rough_kernels()
    counts = launch_counts()
    for d in counts.values():
        for key in d:
            d[key] = 0
    gen = lambda s: torch.Generator().manual_seed(s)  # noqa: E731
    secs, res = {}, {}
    P = RBergomiParams(**RB_ROUGH)
    put = OptionSpec(strike=100.0, rate=0.05, cp=-1.0, sigma=None)

    def timed(label, fn, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        secs[label] = time.perf_counter() - t0
        return out

    def check(tag, ok, msg):
        log(f"[{tag}] {msg}")
        if not ok:
            fail(f"{tag}: {msg}")

    # R1: hybrid scheme against exact joint sampling, the same 50-step grid
    p, se = (float(t) for t in timed("R1", rbergomi_european_mc, gen(71), 100.0, 100.0, 0.05,
                                     1.0, P, MCConfig(1 << 16, 50), cp=-1.0, device=DEVICE))
    pc, sec, _ = rbergomi_exact_chol(7, 100.0, 100.0, 0.05, 1.0, P, n_steps=50, n_paths=1 << 16,
                                     cp=-1.0)
    z = (p - pc) / math.hypot(se, sec)
    res["R1"] = dict(price=p, stderr=se, chol=pc, chol_stderr=sec, z=z)
    check("R1", abs(z) < R1_Z, f"ATM put, H 0.1, 2^16 x 50: hybrid {p:.6f} +- {se:.6f} "
          f"({secs['R1']:.3f} s), Cholesky {pc:.6f} +- {sec:.6f}: z {z:+.3f} (bar {R1_Z})")

    # R2: H = 1/2 against the drift-extended ADI
    eta, rho = 1.2, -0.6
    p2 = RBergomiParams(H=0.5, eta=eta, rho=rho, xi0=0.04)
    pr, se2 = (float(t) for t in timed("R2", rbergomi_european_mc, gen(72), 100.0, 100.0, 0.05,
                                       1.0, p2, MCConfig(1 << 17, 100), cp=-1.0, device=DEVICE))
    sp = SABRParams(alpha=0.2, beta=1.0, rho=rho, nu=eta / 2)
    grid = dict(cp=-1.0, american=False, n_f=400, n_a=160, n_t=400)
    fd = sabr_fd_price(100.0, 100.0, 1.0, 0.05, sp, alpha_drift=-eta**2 / 8, **grid)
    fd0 = sabr_fd_price(100.0, 100.0, 1.0, 0.05, sp, **grid)
    res["R2"] = dict(price=pr, stderr=se2, adi=fd, adi_driftless=fd0)
    check("R2", abs(pr - fd) < R2_SE * se2 and abs(pr - fd0) > R2_MISS * se2,
          f"H 1/2 European put, 2^17 x 100: {pr:.6f} +- {se2:.6f} ({secs['R2']:.3f} s); "
          f"drift ADI {fd:.6f} ({(pr - fd) / se2:+.2f} stderr, bar {R2_SE}); driftless ADI "
          f"{fd0:.6f} ({(pr - fd0) / se2:+.2f} stderr, must pass {R2_MISS})")

    # R3: the ATM-skew power law, common random numbers across strikes and T
    Ts, dk, skews = [0.05, 0.1, 0.25, 0.5, 1.0], 0.02, []
    t0 = time.perf_counter()
    for T in Ts:
        ivs = []
        for K in (100 * np.exp(-dk), 100 * np.exp(dk)):
            pr3, _ = rbergomi_european_mc(gen(73), 100.0, K, 0.0, T, P, MCConfig(1 << 16, 64),
                                          cp=1.0, device=DEVICE)
            ivs.append(float(implied_vol(pr3, 100.0, K, T, 0.0, cp=1.0, device=DEVICE)))
        skews.append((ivs[1] - ivs[0]) / (2 * dk))
    secs["R3"] = time.perf_counter() - t0
    slope = float(np.polyfit(np.log(Ts), np.log(np.abs(skews)), 1)[0])
    res["R3"] = dict(skews=skews, slope=slope)
    check("R3", all(s < 0 for s in skews) and abs(slope - (P.H - 0.5)) < R3_SLOPE,
          f"ATM skews {[round(s, 4) for s in skews]} at T {Ts}: log-log slope {slope:+.4f} "
          f"against H - 1/2 = {P.H - 0.5:+.2f} (bar {R3_SLOPE}); {secs['R3']:.2f} s")

    # R4: bench.py's calibration leg, not cut
    K4, T4, iv4 = timed("R4 surface", create_synthetic_rbergomi_surface, P, device=DEVICE)
    fit, summ = timed("R4", calibrate_rbergomi_to_data, K4, T4, iv4, 100.0, 0.05, rho=-0.7,
                      device=DEVICE)
    rel4 = dict(H=abs(fit.H / P.H - 1), eta=abs(fit.eta / P.eta - 1),
                xi0=abs(fit.xi0 / P.xi0 - 1), iv_rmse=float(summ["error"]))
    res["R4"] = dict(seconds=secs["R4"], surface_seconds=secs["R4 surface"],
                     evaluations=summ["surface_evals"], polish_evals=summ.get("polish_evals"),
                     fitted=dict(H=fit.H, eta=fit.eta, xi0=fit.xi0), **rel4)
    check("R4", rel4["xi0"] < R4_XI0_REL and abs(fit.H - P.H) < R4_H_ABS
          and rel4["eta"] < R4_ETA_REL and rel4["iv_rmse"] < R4_RMSE,
          f"calibrate_rbergomi_to_data at its defaults: {secs['R4']:.2f} s, "
          f"{summ['surface_evals']} surface evaluations ({summ.get('polish_evals')} in the "
          f"polish), {secs['R4'] / summ['surface_evals'] * 1e3:.1f} ms each; fitted H "
          f"{fit.H:.4f} eta {fit.eta:.4f} xi0 {fit.xi0:.5f}: relative errors H "
          f"{rel4['H'] * 100:.2f}% eta {rel4['eta'] * 100:.2f}% xi0 {rel4['xi0'] * 100:.2f}%, "
          f"IV RMSE {rel4['iv_rmse']:.6f} (BENCH_r05, the JAX package: H 4.43%, eta 1.04%, "
          f"xi0 0.34%, IV RMSE 0.001654); the synthetic surface {secs['R4 surface']:.2f} s")

    # R5: the American put on the (S, v) basis against the European
    mc5 = MCConfig(*RB_SHAPE)
    pa5, sa5 = (float(t) for t in timed("R5", price_american, gen(75), 100.0, 0.5, put, mc5,
                                        LSMConfig(), "rbergomi", rbergomi=P, device=DEVICE))
    pe5, se5 = (float(t) for t in rbergomi_european_mc(gen(76), 100.0, 100.0, 0.05, 0.5, P, mc5,
                                                       cp=-1.0, device=DEVICE))
    res["R5"] = dict(price=pa5, stderr=sa5, european=pe5, european_stderr=se5)
    check("R5", math.isfinite(pa5) and pa5 >= pe5 - 4 * (sa5 + se5),
          f"American put, H 0.1, 2^20 x 50, (S, v) basis: {pa5:.6f} +- {sa5:.6f} "
          f"({secs['R5']:.3f} s a price); European {pe5:.6f} +- {se5:.6f}")

    def bracket(label, model, mc, T=0.5, n_inner=64, seed=81):
        br = timed(label, price_american_bracket, gen(seed), 100.0, T, put, mc, model=model,
                   n_inner=n_inner, device=DEVICE, **_rough_params(model))
        return [float(t) for t in br]

    # D6: VG (tests/test_vg.py:293-312)
    vg_kw = _rough_params("vg")
    mc6 = MCConfig(n_paths=16384, n_steps=20, path_block=2048)
    lo6, lse6, hi6, hse6 = bracket("D6", "vg", mc6, n_inner=32)
    p6, sp6 = (float(t) for t in price_american_lsm(gen(82), 100.0, 0.5, put, mc6, LSMConfig(),
                                                    "vg", device=DEVICE, **vg_kw))
    lo, hi = lo6 - 2 * lse6, hi6 + 2 * hse6
    res["D6"] = dict(low=lo6, low_stderr=lse6, high=hi6, high_stderr=hse6, lsm=p6)
    check("D6", lo < hi and hi6 - lo6 < 0.06 * lo6 and lo - 2 * sp6 < p6 < hi + 2 * sp6,
          f"VG bracket, 16384 x 20, n_inner 32: [{lo6:.6f} +- {lse6:.6f}, {hi6:.6f} +- "
          f"{hse6:.6f}] ({secs['D6']:.3f} s), gap {(hi6 - lo6) / lo6 * 100:.3f}% (bar 6%); "
          f"in-sample LSM {p6:.6f} +- {sp6:.6f} inside")

    def adi_bracket(tag, lo_, lse, hi_, hse, fd, what):
        lo, hi = lo_ - 3 * lse, hi_ + 3 * hse
        res[tag] = dict(low=lo_, low_stderr=lse, high=hi_, high_stderr=hse, adi=fd)
        check(tag, lo <= fd <= hi and (hi - lo) / fd < 0.05,
              f"{what}: [{lo_:.6f} +- {lse:.6f}, {hi_:.6f} +- {hse:.6f}] ({secs[tag]:.3f} s) "
              f"against ADI {fd:.6f}; 3-stderr width {(hi - lo) / fd * 100:.3f}% (bar 5%)")

    # D7: SABR, beta 1 (tests/test_dual.py:484-495)
    mc78 = MCConfig(n_paths=1 << 15, n_steps=40, path_block=2048)
    sabr = _rough_params("sabr")["sabr"]
    br7 = bracket("D7", "sabr", mc78)
    adi_bracket("D7", *br7, sabr_fd_price(100.0, 100.0, 0.5, 0.05, sabr, cp=-1.0),
                "SABR bracket (0.2, 1, -0.4, 0.6), 2^15 x 40")
    # D8: rough Bergomi at H = 1/2 against the drift ADI (:512-530)
    rb8 = RBergomiParams(**RB_D8)
    br8 = [float(t) for t in timed("D8", price_american_bracket, gen(83), 100.0, 0.5, put, mc78,
                                   model="rbergomi", rbergomi=rb8, device=DEVICE)]
    adi_bracket("D8", *br8, sabr_fd_price(100.0, 100.0, 0.5, 0.05,
                                          SABRParams(alpha=0.2, beta=1.0, rho=-0.5, nu=0.5),
                                          cp=-1.0, alpha_drift=-1.0 / 8),
                "rBergomi bracket at H 1/2 (eta 1, rho -0.5), 2^15 x 40")
    # D9: rough, H = 0.1 (:532-548)
    mc9 = MCConfig(n_paths=1 << 14, n_steps=30, path_block=2048)
    lo9, lse9, hi9, hse9 = (float(t) for t in timed(
        "D9", price_american_bracket, gen(84), 100.0, 0.5, put, mc9, model="rbergomi",
        rbergomi=P, device=DEVICE))
    eu9, _ = rbergomi_european_mc(gen(85), 100.0, 100.0, 0.05, 0.5, P, mc9, cp=-1.0,
                                  device=DEVICE)
    eu9 = float(eu9)
    res["D9"] = dict(low=lo9, low_stderr=lse9, high=hi9, high_stderr=hse9, european=eu9)
    check("D9", all(map(math.isfinite, (lo9, hi9))) and lo9 < hi9
          and hi9 + 3 * hse9 > eu9 and (hi9 - lo9) / lo9 < 0.5,
          f"rough bracket (H 0.1), 2^14 x 30: [{lo9:.6f} +- {lse9:.6f}, {hi9:.6f} +- "
          f"{hse9:.6f}] ({secs['D9']:.3f} s), European {eu9:.6f}, width "
          f"{(hi9 - lo9) / lo9 * 100:.2f}% of low (bar 50%)")

    # the full-width brackets at D1's scale
    n_fw, steps_fw = ROUGH_DUAL_SHAPE
    for model in ROUGH_DUAL:
        label = f"FW {model}"
        kw = _rough_params(model)
        lo_, lse, hi_, hse = (float(t) for t in timed(
            label, price_american_bracket, gen(86), 100.0, ROUGH_DUAL_T, put,
            MCConfig(n_fw, steps_fw), model=model, n_inner=64, device=DEVICE, **kw))
        res[label] = dict(low=lo_, low_stderr=lse, high=hi_, high_stderr=hse,
                          width_pct=(hi_ - lo_) / lo_ * 100)
        check(label, all(map(math.isfinite, (lo_, hi_))) and lo_ < hi_ + 3 * hse,
              f"{model} bracket at {n_fw} x {steps_fw}, n_inner 64: [{lo_:.6f} +- {lse:.6f}, "
              f"{hi_:.6f} +- {hse:.6f}], width {(hi_ - lo_) / lo_ * 100:.4f}%, "
              f"{secs[label]:.3f} s a bracket")

    mine = {k["name"]: k["counter"][0][k["counter"][1]] for k in rough_specs()}
    first = {key: counts["cuda_rbergomi"][key] for key in RB_FIRST}
    first.update({key: counts["cuda_dual"][key] for key in ROUGH_DUAL_FIRSTS})
    log(f"[R] kernel launches of the rough path after R0: {mine}; the first design of "
        f"kernels 25-26, of kernel 18's VG, SABR and rough Bergomi families and of VG's "
        f"terminal step: {first}")
    if not all(mine.values()):
        fail(f"a kernel of the rough path was never launched: {mine}")
    if any(first.values()):
        fail(f"the rough path reached the first design of kernels 25-26, of kernel 18's VG, "
             f"SABR or rough Bergomi family or of VG's terminal step: {first}")
    res["phase_seconds"] = time.perf_counter() - t_phase
    log(f"[R] the rough path took {res['phase_seconds']:.1f} s in its process")
    return dict(errs=errs, secs=secs, res=res)


def phase_rough_timing(sass: dict, rough: dict, launches: dict) -> dict:
    """CUDA-event medians (N_TIMED) of the fused rough Bergomi kernel in
    turns with its first design (first, fused, fused, first; the first
    design's time the sum of kernel 25's, the Volterra matmul's and kernel
    26's medians, each timed alone), at R5's 2^20 x 50 (with v, R5's mode)
    and at R4's CV shapes (RB_CV_SHAPES), each beside its bound (bound(),
    ops_rb_fused and DRAWS_RB_FUSED, from this run's shapes) and kernel 25
    beside its own; the plain version (one run) at R5's shape and R4's
    longest expiry; kernel 18's VG, SABR and rough Bergomi families and
    VG's terminal step at ROUGH_DUAL_SHAPE x 64 inner draws, each beside
    its plain version (one run) and its bound (VG's gamma attempts counted
    from its clock draws), the VG, SABR and rough Bergomi redesigns and
    VG's terminal redesign in turns with their first designs (first, new,
    new, first) and beside both designs' issue and SFU floors from their
    SASS (VG's at the clock's passes and attempts of the first 4 dates, the
    terminal's at its date's, through the redesigns' debug instances), and
    the kernel-18 redesigns' uppers on the timed paths from either design
    within DUAL_UPPER_SE stderr (dual_upper_both);
    registers and occupancy; the full-width brackets' seconds with kernel
    18's share. Returns the rows by kernel name."""
    import torch

    from options_model_tpu_torch.core.config import RBergomiParams
    from options_model_tpu_torch.models.rbergomi import rbergomi_constants, volterra
    from options_model_tpu_torch.ops import cuda_dual as cd
    from options_model_tpu_torch.ops import cuda_rbergomi as cr
    from options_model_tpu_torch.ops.cuda_heston import PATH_TILE
    from options_model_tpu_torch.utils.profiling import time_per_call

    seed, tile = 0x5DEECE66D, 4096
    per_call = sass["per_call"]
    attrs = cd.dual_kernel_attrs()
    out = {}

    def row(name, ms, plain_ms, b, key, **extra):
        a = attrs[key]
        out[name] = dict(ms=ms, plain_ms=plain_ms, registers=a["registers"],
                         occupancy=a["blocks_per_sm"] * a["block"] / THREADS_PER_SM, **b,
                         **extra)
        log(f"[5] {name} ({key}): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; bound "
            f"{b['bound_ms']:.4f} ms by {b['bound_term']}, {b['bound_ms'] / ms * 100:.1f}% of "
            f"bound; {a['registers']} registers, {out[name]['occupancy'] * 100:.1f}% occupancy"
            + "".join(f"; {k} {v}" for k, v in extra.items()))

    P = RBergomiParams(**RB_ROUGH)
    n_fused = launches.get("rbergomi_fused", 0)
    shapes = {}
    for (n, steps, T), mode in [(RB_SHAPE + (0.5,), "paths")] + [(c, "cv") for c in RB_CV_SHAPES]:
        n_tiles = n // PATH_TILE
        c = rbergomi_constants(100.0, T, P, steps, 0.05)
        W = torch.from_numpy(c["W_mat"]).to(DEVICE)
        kw = dict(return_variance=True) if mode == "paths" else {}
        args = (seed, 100.0, T, P, n, steps, 0.05, mode, True, 0, DEVICE)
        dW = cr.rbergomi_dw(seed, 0, n_tiles, steps, c["sqrt_dt"], True, DEVICE)
        G = volterra(W, dW)
        parts = (lambda: cr.rbergomi_dw(seed, 0, n_tiles, steps, c["sqrt_dt"], True, DEVICE),
                 lambda: volterra(W, dW),
                 lambda: cr.rbergomi_paths(dW, G, c, seed, 0, True, mode, **kw))
        turns = []
        for which in ("first", "fused", "fused", "first"):
            turns.append(time_per_call(lambda: cr.rbergomi_fused(*args, **kw), N_TIMED)
                         if which == "fused" else [time_per_call(f, N_TIMED) for f in parts])
        ms = (turns[1] + turns[2]) / 2
        k25, mm, k26 = ((a + b) / 2 for a, b in zip(turns[0], turns[3]))
        first_ms = k25 + mm + k26
        out_bytes = 2 * (steps + 1) * n * 4 if mode == "paths" else 2 * n * 4
        b = bound(n, steps, ops_rb_fused(steps, mode), int_ops(DRAWS_RB_FUSED, per_call),
                  out_bytes)
        b25 = bound(n, steps, OPS_RB_DW, int_ops(DRAWS_RB_DW, per_call), n * steps * 4)
        a = cr.rbergomi_kernel_attrs(steps)["rbergomi_fused" if mode == "paths"
                                            else "rbergomi_fused cv"]
        occ = a["blocks_per_sm"] * a["block"] / THREADS_PER_SM
        shape = f"{n} x {steps}"
        row_ = dict(ms=ms, bound_ms=b["bound_ms"], bound_by=b["bound_by"],
                    bound_term=b["bound_term"], shape=shape, mode=mode,
                    earlier_ms=first_ms, earlier_parts=dict(rbergomi_dw=k25, volterra=mm,
                                                            rbergomi_paths=k26),
                    rbergomi_dw_bound_ms=b25["bound_ms"],
                    turns=[sum(turns[0]), turns[1], turns[2], sum(turns[3])],
                    registers=a["registers"], spill_bytes=a["spill_bytes"], occupancy=occ)
        if mode == "paths" or steps == RB_CV_SHAPES[-1][1]:
            row_["plain_ms"] = time_per_call(lambda: cr.rbergomi_fused_reference(*args, **kw),
                                             1, 0)
        shapes[shape] = row_
        log(f"[5] rbergomi_fused {mode} at {shape} (T {T}): fused {ms:.4f} ms ({turns[1]:.4f}, "
            f"{turns[2]:.4f}), {b['bound_ms'] / ms * 100:.1f}% of its {b['bound_ms']:.4f} ms "
            f"bound by {b['bound_term']}; first design {first_ms:.4f} ms ({sum(turns[0]):.4f}, "
            f"{sum(turns[3]):.4f}: kernel 25 {k25:.4f}, the matmul {mm:.4f}, kernel 26 "
            f"{k26:.4f}), {b['bound_ms'] / first_ms * 100:.1f}% of bound; {first_ms / ms:.2f}x; "
            f"kernel 25 alone {b25['bound_ms'] / k25 * 100:.1f}% of its {b25['bound_ms']:.4f} ms "
            f"bound by {b25['bound_term']}; {a['registers']} registers, {a['spill_bytes']} "
            f"spill bytes, {a['blocks_per_sm']} blocks of {a['block']} per SM ({occ:.1%})"
            + (f"; plain {row_['plain_ms']:.4f} ms" if "plain_ms" in row_ else ""))
        del dW, G
    r5 = shapes[f"{RB_SHAPE[0]} x {RB_SHAPE[1]}"]
    out["rbergomi_fused"] = dict(
        r5, earlier_name="rbergomi_dw + volterra + rbergomi_paths (first design)",
        earlier_source="options_model_tpu_torch/csrc/rbergomi.cu rbergomi_dw_kernel, "
                       "rbergomi_paths_kernel; models/rbergomi.volterra",
        cv_shapes={k: v for k, v in shapes.items() if v["mode"] == "cv"})
    cv96 = shapes[f"{RB_CV_SHAPES[-1][0]} x {RB_CV_SHAPES[-1][1]}"]
    log(f"[5] the rough path's {n_fused} fused launches: at R4's longest expiry "
        f"launches x (ms - bound) {n_fused * (cv96['ms'] - cv96['bound_ms']):.2f} ms, the first "
        f"design's {n_fused * (cv96['earlier_ms'] - cv96['bound_ms']):.2f} ms")

    n, steps = ROUGH_DUAL_SHAPE
    n_dates, n_inner = steps - 1, 64
    for model in ROUGH_DUAL:
        case = rough_dual_case(model, n, steps)
        x, v, rows, law = case["x"], case["v"], case["rows"], case["law"]
        hist, comp = case["hist"], case["comp"]
        args = (seed, 0, tile, n_inner, hist, comp)
        run = lambda: cd.dual_ce(x, v, rows, law, *args)  # noqa: E731
        redesigned = model in cd.REDESIGNED_FAMILIES
        if redesigned:
            first = lambda: cd.dual_ce_first(x, v, rows, law, *args)  # noqa: E731
            turns = [time_per_call(f, N_TIMED) for f in (first, run, run, first)]
            ms = (turns[1] + turns[2]) / 2
        else:
            ms = time_per_call(run, N_TIMED)
        plain = time_per_call(lambda: cd.dual_ce_reference(x, v, rows, law, *args), 1, 0)
        per_eval = {"vg": OPS_DUAL["gbm"], "sabr": OPS_DUAL["heston"] - 8 + 6,
                    "rbergomi": OPS_DUAL["heston"] - 8 + 12}[model]
        draws = {"sabr": DRAWS_DUAL["heston"], "rbergomi": (1 / 2, 2)}.get(model)
        extra = {}
        if model == "vg":
            # the clock of the first 4 dates through the redesign's debug instance
            _, _, att, passes = cd.dual_ce_debug(x, None, rows[:4], law, *args)
            tries = float(att.float().mean()) + 1.0
            # the most attempts a warp's 32 lanes took a draw (kMaxAttempts when none accepted)
            warp_tries = float(torch.clamp(att + 1, max=15).view(4, n_inner // 2, n // 32, 32)
                               .amax(-1).float().mean())
            passes = [float(t) for t in passes.float().mean(dim=(0, 1))]
            extra.update(gamma_attempts_per_draw=tries, warp_attempts_per_draw=warp_tries,
                         exact_passes_per_warp_date=passes[0],
                         retry_passes_per_warp_date=passes[1])
            # a member's share of its pair's clock: tries attempts of
            # OPS_VG_ATTEMPT, the boost, one call and three words each
            per_eval += (tries * OPS_VG_ATTEMPT + OPS_VG_BOOST) / 2
            draws = (DRAWS_DUAL["gbm"][0] + tries / 2, DRAWS_DUAL["gbm"][1] + 1.5 * tries + 0.5)
        b = bound(n_dates * n, n_inner, per_eval, int_ops(draws, per_call),
                  n_dates * n * 4 * (3 if v is not None else 2)
                  + (n_dates * n * 4 if hist is not None else 0))
        shape = f"{n_dates} x {n} x {n_inner}"
        row(f"dual_ce {model}", ms, plain, b, f"dual_ce {model}", shape=shape, **extra)
        if redesigned:
            r = out[f"dual_ce {model}"]
            r.update(first_design_row(f"dual_ce {model}, first design",
                                      "options_model_tpu_torch/csrc/dual.cu", shape, turns,
                                      b["bound_ms"], attrs[f"dual_ce {model}, first design"]))
            # the full-width bracket's upper from either design on these paths
            r["upper_d_stderr_full_width"] = dual_upper_both(model, case, seed, tile,
                                                             "5")["d_stderr"]
            evals = n_dates * n * n_inner
            for key, label, t in ((f"dual_ce {model}", "redesign", ms),
                                  (f"dual_ce {model}, first design", "first design",
                                   r["earlier_ms"])):
                fl = (dual_vg_floors(sass, key, evals, n_inner // 2, passes, warp_tries)
                      if model == "vg" else sass_floors(sass, key, evals))
                if not fl:
                    log(f"[5] dual_ce {model} {label}: no SASS loops read, no floors")
                    continue
                r.update(fl if label == "redesign"
                         else {f"earlier_{k}": x_ for k, x_ in fl.items()})
                log(f"[5] dual_ce {model} {label}: {fl['instructions_per_eval']:g} SASS "
                    f"instructions an evaluation ({fl['mufu_per_eval']:g} MUFU)"
                    + (" = " + ", ".join(f"{k} {x_:.2f}"
                                         for k, x_ in fl["instructions_per_eval_by_part"].items())
                       if "instructions_per_eval_by_part" in fl else "")
                    + f": issue floor {fl['issue_floor_ms']:.4f} ms "
                    f"({fl['issue_floor_ms'] / t * 100:.1f}% of its {t:.4f} ms), SFU floor "
                    f"{fl['mufu_floor_ms']:.4f} ms; bound {b['bound_ms']:.4f} ms "
                    f"({b['bound_ms'] / t * 100:.1f}% of it)")
        if model == "vg":
            half = n_inner // 2
            targs = (x[steps - 1].contiguous(), law, seed, 0, tile, n_inner, n_dates)
            new_t = lambda: cd.dual_vg_terminal(*targs)  # noqa: E731
            first_t = lambda: cd.dual_vg_terminal_first(*targs)  # noqa: E731
            turns_t = [time_per_call(f, N_TIMED) for f in (first_t, new_t, new_t, first_t)]
            ms_t = (turns_t[1] + turns_t[2]) / 2
            plain_t = time_per_call(lambda: cd.dual_vg_terminal_reference(*targs), 1, 0)
            tries = extra["gamma_attempts_per_draw"]
            b_t = bound(n, n_inner // 2, tries * OPS_VG_ATTEMPT + OPS_VG_BOOST + 40,
                        int_ops((tries, 3 * tries + 1), per_call), n * 8)
            # the terminal clock through the redesign's debug instance
            _, _, att_t, passes_t = cd.dual_vg_terminal_debug(*targs)
            warp_tries_t = float(torch.clamp(att_t + 1, max=15).view(half, n // 32, 32)
                                 .amax(-1).float().mean())
            pm = [float(t) for t in passes_t.float().mean(dim=0)]
            shape_t = f"{n} x {half}"
            row("dual_vg_terminal", ms_t, plain_t, b_t, "dual_vg_terminal", shape=shape_t,
                gamma_attempts_per_draw=float(att_t.float().mean()) + 1.0,
                first_design_warp_attempts_per_draw=warp_tries_t,
                exact_passes_per_warp=pm[0], retry_passes_per_warp=pm[1])
            r = out["dual_vg_terminal"]
            r.update(first_design_row("dual_vg_terminal, first design",
                                      "options_model_tpu_torch/csrc/dual.cu", shape_t, turns_t,
                                      b_t["bound_ms"], attrs["dual_vg_terminal, first design"]))
            for key, label, t in (("dual_vg_terminal", "redesign", ms_t),
                                  ("dual_vg_terminal, first design", "first design",
                                   r["earlier_ms"])):
                fl = dual_terminal_floors(sass, key, n, half, pm, warp_tries_t)
                if not fl:
                    log(f"[5] dual_vg_terminal {label}: no SASS loops read, no floors")
                    continue
                r.update(fl if label == "redesign"
                         else {f"earlier_{k}": x_ for k, x_ in fl.items()})
                log(f"[5] dual_vg_terminal {label}: {fl['instructions_per_draw']:g} SASS "
                    f"instructions a draw ({fl['mufu_per_draw']:g} MUFU) = "
                    + ", ".join(f"{k} {x_:.2f}"
                                for k, x_ in fl["instructions_per_draw_by_part"].items())
                    + f": issue floor {fl['issue_floor_ms']:.4f} ms "
                    f"({fl['issue_floor_ms'] / t * 100:.1f}% of its {t:.4f} ms), SFU floor "
                    f"{fl['mufu_floor_ms']:.4f} ms; bound {b_t['bound_ms']:.4f} ms "
                    f"({b_t['bound_ms'] / t * 100:.1f}% of it)")
        del case
    for model in ROUGH_DUAL:
        label = f"FW {model}"
        s = rough["secs"][label]
        k_ms = out[f"dual_ce {model}"]["ms"] + (out["dual_vg_terminal"]["ms"]
                                                if model == "vg" else 0.0)
        r = rough["res"][label]
        log(f"[5] the full-width {model} bracket ({n} x {steps}, n_inner 64): {s:.3f} s a "
            f"bracket, width {r['width_pct']:.4f}%, upper {r['high']:.6f}; kernel 18 "
            f"{k_ms:.4f} ms = {k_ms / 1e3 / s * 100:.3f}% of it")
    log(f"[5] rough path launches: {launches}; its seconds: "
        + ", ".join(f"{k} {v:.3f}" for k, v in rough["secs"].items()))
    return out


# ---- the exotics path (``--path exotics``): kernels 27-28 and their pricers -----------------
# Kernels 27-28 (csrc/basket.cu) draw the basket stream (counter word 3 =
# 6), correlate with the Cholesky factor over ascending b with _rn
# intrinsics and walk the log-states; the plain version
# (models/multiasset.basket_chain) does the same float32 operations in the
# same order, so W and the log-states are expected bit for bit and S =
# s0 expf(acc) within BASKET_S_ULPS ulps (torch.exp against the kernel's
# expf). X0 holds them at these asset counts; B1-B2 drive the basket
# pricers and E1-E4 the path-dependent exotics and variance swaps at the
# JAX tests' configurations and bars (tests/test_basket_american.py,
# tests/test_basket.py, tests/test_exotics.py, tests/test_american_asian.py,
# tests/test_pricers.py:194-243, tests/test_varswap.py). The kernels are
# timed in phase 5 of the main process, after the join.
BASKET_ASSETS = (1, 2, 3, 5)
BASKET_S_ULPS = 2
# The routes from 9 assets (csrc/basket.cu's register instances to 16, the
# wide route of csrc/basket.cuh to 128) and their yardstick, the generic
# instance: at these asset counts, antithetic and not, on 2 tiles of 4,096 x
# 7 steps and of BASKET_ODD_TILE x 3 steps, each with a first_tile = 1 chunk.
BASKET_ROUTE_ASSETS = (9, 12, 16, 17, 33, 50, 64, 128)
# Kernel 28's redesign (csrc/basket.cu basket_terminal_kernel) and its first
# design against the plain version, bit for bit: at BASKET_ASSETS, 8 (the
# largest first-design register instance) and BASKET_ROUTE_ASSETS,
# antithetic and not, at one exact step on 2 TERMINAL_TILE tiles and at 7
# steps on 2 PATH_TILE tiles, and at tiles whose half no K divides (one slot
# a thread), each with a first_tile = 1 chunk.
BASKET_TERMINAL_ASSETS = BASKET_ASSETS + (8,) + BASKET_ROUTE_ASSETS
BASKET_ODD_TILE = 1030
# B1's European leg (its best-of at 2 x 2^20 paths, one exact step), where
# phase 5 also times both designs of kernel 28.
BASKET_B1_EUROPEAN = (2, 1 << 21, 1)
# The routes from 9 assets, timed in turns with their first design, the
# generic instance, in phase 5: (assets, paths, steps) of each kernel.
BASKET_ROUTE_SHAPES = {"basket_terminal_9_16": (12, 1 << 22, 1),
                       "basket_paths_9_16": (12, 1 << 18, 50),
                       "basket_terminal_17_128": (64, 1 << 20, 1),
                       "basket_paths_17_128": (64, 1 << 16, 50)}
# (assets, paths, steps): kernel 27 at 5 x 2^20 x 50, kernel 28 at 3 x 2^22
# (one exact step), and B1's Andersen-Broadie shape (2 x 2^20 x 9, kernel 27).
BASKET_SHAPES = {"basket_paths": (5, 1 << 20, 50), "basket_terminal": (3, 1 << 22, 1),
                 "andersen_broadie": (2, 1 << 20, 9)}
# B3 and B4, wide equal-weight baskets (a sector basket of a dozen names, an
# index basket of fifty): S0 = 100, sigma_i = 0.15 + step i, pairwise rho
# 0.4, q 2%, r 5%, T 1, the call at K 100 and the Bermudan put at K 105 (12
# dates); (assets, sigma step, European paths, Bermudan paths). B3 runs the
# 9-16 route of kernels 27-28, B4 the 17-128 route; B4's Bermudan regresses
# in float64 (pricers/american_basket.FLOAT32_GRAM_ASSETS).
BASKET_WIDE_LEGS = {"B3": (12, 0.01, 1 << 22, 1 << 18),
                    "B4": (50, 0.003, 1 << 21, 1 << 17)}
# X0 also holds the routes from 9 assets at the shapes the exotics path and
# phase 5 give them: B3's and B4's (the European's one exact step, the
# Bermudan's 12 dates) and BASKET_ROUTE_SHAPES.
BASKET_ROUTE_HELD = tuple(dict.fromkeys(
    [(n, n_paths, steps) for n, _, n_eu, n_am in BASKET_WIDE_LEGS.values()
     for n_paths, steps in ((n_eu, 1), (n_am, 12))] + list(BASKET_ROUTE_SHAPES.values())))
BASKET_WIDE_RHO = 0.4
AB_TRUE = {90.0: 8.075, 100.0: 13.902, 110.0: 21.345}   # tests/test_basket_american.py:13
AB_GATE, AB_OOS_GATE = 0.01, 0.015
B2_S0 = [100.0, 95.0, 110.0]                             # tests/test_basket.py:17-21
B2_SIGS = [0.2, 0.3, 0.25]
B2_CORR = [[1.0, 0.5, 0.3], [0.5, 1.0, 0.4], [0.3, 0.4, 1.0]]
ASIAN_ANCHOR_GATE = 0.01                                # tests/test_american_asian.py:117
# f32 operations a path-step, from csrc/basket.cu: per asset a Box-Muller
# share (11 per two normals of a pair: 11/4 a path), the log step (3: a
# product and two sums) and the stored S (expf and a product: 2, paths
# mode); per pair n^2 for W (n(n+1)/2 products, n(n-1)/2 sums), n^2/2 a
# path. Philox: ceil(n/4) calls and n words a pair-step.


def ops_basket(n: int, paths: bool) -> float:
    return n * (11 / 4 + 3 + (2 if paths else 0)) + n * n / 2


def draws_basket(n: int) -> tuple:
    return (math.ceil(n / 4) / 2, n / 2)


def exotics_specs():
    """Kernels 27-28 (csrc/basket.cu) on each route by assets: name, source,
    the XLA function each replaces, the paths that run them, their
    counters."""
    from options_model_tpu_torch.ops import cuda_basket

    src = "options_model_tpu_torch/csrc/basket.cu"
    wide = "options_model_tpu_torch/csrc/basket.cuh"
    paths = "options_model_tpu/models/multiasset.py:48 simulate_gbm_basket"
    terminal = "options_model_tpu/models/multiasset.py:107 gbm_basket_terminal_exact"
    return [dict(name=f"basket_{kind}{suffix}", source=source, replaces=replaces,
                 paths=("exotics",), counter=(cuda_basket.launches, f"basket_{kind}{suffix}"))
            for suffix, source in (("", src), ("_9_16", src), ("_17_128", wide))
            for kind, replaces in (("paths", paths), ("terminal", terminal))]


def _basket_assets(n: int):
    """n assets: B2's three, the Andersen-Broadie pair's, or a random valid
    correlation from a seed."""
    import numpy as np

    if n <= 3:
        return B2_S0[:n], B2_SIGS[:n], [row[:n] for row in B2_CORR[:n]]
    rng = np.random.default_rng(n)
    A = rng.standard_normal((n, n + 2))
    cov = A @ A.T
    d = np.sqrt(np.diag(cov))
    corr = cov / np.outer(d, d)
    np.fill_diagonal(corr, 1.0)
    return list(80.0 + 40.0 * rng.random(n)), list(0.1 + 0.3 * rng.random(n)), corr


def _basket_consts(n: int, n_steps: int, T: float = 0.5):
    from options_model_tpu_torch.models import multiasset as ma

    S0, sig, corr = _basket_assets(n)
    return ma.basket_constants(S0, 0.05, sig, ma.correlation_cholesky(corr), T, n_steps,
                               [0.02] * n)


def phase_exotics_kernels() -> dict:
    """X0: kernels 27-28 against their plain versions on the card. At
    BASKET_ASSETS and BASKET_ROUTE_ASSETS (the register instances to 16
    assets, the wide route above), antithetic and not, 2 tiles x 7 steps
    and 2 BASKET_ODD_TILE tiles x 3 steps: W and the log-states bit for bit
    (the debug launch), S within BASKET_S_ULPS ulps (the largest printed),
    the terminal equal to the paths' last row, a first_tile = 1 chunk bit
    for bit, and from 9 assets the generic instance (the first design,
    paths and terminal) equal to both. At the timed shapes (BASKET_SHAPES)
    and at the shapes the path and phase 5 give the routes from 9 assets
    (BASKET_ROUTE_HELD): the same. Registers, local bytes and warps an SM of every instance;
    fails on local memory in an instance of 1-16 assets. Returns the
    largest errors by kernel."""
    import torch

    from options_model_tpu_torch.ops import cuda_basket as cb
    from options_model_tpu_torch.ops.cuda_heston import TERMINAL_TILE

    errs = {k["name"]: dict(s_abs=0.0, s_ulps=0.0) for k in exotics_specs()}
    errs["basket_terminal_first"] = dict(s_abs=0.0, s_ulps=0.0)
    dev = torch.device(DEVICE)

    def ulps(a, b):
        return float(((a - b).abs() / torch.finfo(torch.float32).eps / b.abs()).max())

    def suffix(n):
        r = cb.route(n)
        return "" if r == "1_8" else f"_{r}"

    def one(n, n_paths, n_steps, anti, tile=4096, T=0.5):
        c = _basket_consts(n, n_steps, T)
        acc, W = cb.basket_launch(9, c, n_paths, n_steps, anti, 0, tile, dev, "debug")
        acc_r, W_r = cb.basket_reference(9, c, n_paths, n_steps, anti, 0, tile, dev, "debug")
        bits = torch.equal(acc, acc_r) and torch.equal(W, W_r)
        del acc, W, acc_r, W_r
        S = cb.basket_paths(9, c, n_paths, n_steps, anti, 0, tile, dev)
        S_r = cb.basket_paths_reference(9, c, n_paths, n_steps, anti, 0, tile, dev)
        S_T = cb.basket_terminal(9, c, n_paths, n_steps, anti, 0, tile, dev)
        S_Tr = cb.basket_terminal_reference(9, c, n_paths, n_steps, anti, 0, tile, dev)
        S_T1 = (cb.basket_terminal_first(9, c, n_paths, n_steps, anti, 0, tile, dev)
                if n <= cb.FIRST_REGISTER_ASSETS else None)
        chunk = cb.basket_paths(9, c, tile, n_steps, anti, 1, tile, dev)
        chunk_t = cb.basket_terminal(9, c, tile, n_steps, anti, 1, tile, dev)
        same = (torch.equal(S_T, S[-1]) and (S_T1 is None or torch.equal(S_T1, S_T))
                and torch.equal(chunk, S[:, :, tile:2 * tile])
                and torch.equal(chunk_t, S_T[:, tile:2 * tile])
                and bool(torch.isfinite(S).all()))
        first = ""
        if n > cb.FIRST_REGISTER_ASSETS:
            G = cb.basket_generic_first(9, c, n_paths, n_steps, anti, 0, tile, dev, paths=True)
            GT = cb.basket_generic_first(9, c, n_paths, n_steps, anti, 0, tile, dev)
            same = same and torch.equal(G, S) and torch.equal(GT, S_T)
            first = ", the generic instance's paths and terminal"
            del G, GT
        u, ut = ulps(S, S_r), ulps(S_T, S_Tr)
        p, t = f"basket_paths{suffix(n)}", f"basket_terminal{suffix(n)}"
        errs[p]["s_abs"] = max(errs[p]["s_abs"], float((S - S_r).abs().max()))
        errs[t]["s_abs"] = max(errs[t]["s_abs"], float((S_T - S_Tr).abs().max()))
        if S_T1 is not None:
            errs["basket_terminal_first"]["s_abs"] = max(
                errs["basket_terminal_first"]["s_abs"], float((S_T1 - S_Tr).abs().max()))
        errs[p]["s_ulps"] = max(errs[p]["s_ulps"], u)
        errs[t]["s_ulps"] = max(errs[t]["s_ulps"], ut)
        ok = bits and same and u <= BASKET_S_ULPS and ut <= BASKET_S_ULPS
        log(f"[X0] {n} assets ({cb.route(n)}) x {n_paths} x {n_steps} on {tile}, antithetic "
            f"{anti}: W and log-states bit for bit {bits}; S within {u:.2f} ulps, S_T {ut:.2f} "
            f"(bar {BASKET_S_ULPS}); terminal == the paths' last row"
            + (", 28's first design's" if S_T1 is not None else "")
            + f"{first}, first_tile chunks bit for bit: {same}")
        if not ok:
            fail(f"X0: kernels 27-28 at {n} assets x {n_paths} x {n_steps} on {tile} "
                 f"(antithetic {anti})")
        del S, S_r, S_T, S_Tr, S_T1, chunk, chunk_t
        torch.cuda.empty_cache()

    def designs(n, n_steps, anti, tile):
        """Kernel 28's redesign and first design (the generic instance from 9
        assets) == the plain version bit for bit on 2 tiles, and their
        first_tile = 1 chunks == the second tile."""
        c = _basket_consts(n, n_steps)
        want = cb.basket_terminal_reference(9, c, 2 * tile, n_steps, anti, 0, tile, dev)
        ok = True
        first = (cb.basket_terminal_first if n <= cb.FIRST_REGISTER_ASSETS
                 else cb.basket_generic_first)
        for fn in (cb.basket_terminal, first):
            got = fn(9, c, 2 * tile, n_steps, anti, 0, tile, dev)
            chunk = fn(9, c, tile, n_steps, anti, 1, tile, dev)
            ok = ok and torch.equal(got, want) and torch.equal(chunk, want[:, tile:])
        return ok

    t0 = time.perf_counter()
    cases = [(n, steps, anti, tile) for n in BASKET_TERMINAL_ASSETS for anti in (True, False)
             for steps, tile in ((1, TERMINAL_TILE), (7, 4096))]
    cases += [(n, 3, anti, BASKET_ODD_TILE) for n in (3, 6) for anti in (True, False)]
    bad = [case for case in cases if not designs(*case)]
    log(f"[X0] kernel 28's redesign and first design (from 9 assets the generic instance) == "
        f"the plain version bit for bit, and "
        f"their first_tile chunks, at {len(cases)} cases ((assets, steps, antithetic, tile): "
        f"{BASKET_TERMINAL_ASSETS} assets, 1 step on {TERMINAL_TILE} and 7 on 4096, "
        f"antithetic and not, and 3 and 6 assets on {BASKET_ODD_TILE}); failing: {bad}")
    if bad:
        fail(f"X0: kernel 28's designs differ from the plain version at {bad}")
    for n in BASKET_ASSETS + BASKET_ROUTE_ASSETS:
        for anti in (True, False):
            one(n, 2 * 4096, 7, anti)
            if n in BASKET_ROUTE_ASSETS:
                one(n, 2 * BASKET_ODD_TILE, 3, anti, BASKET_ODD_TILE)
    for n, n_paths, n_steps in BASKET_SHAPES.values():
        T = 3.0 if n_steps == 9 else 0.5
        if n_steps == 1:   # the exact terminal law's tile
            one(n, n_paths, n_steps, True, TERMINAL_TILE, T)
        else:
            one(n, n_paths, n_steps, True, T=T)
    for n, n_paths, n_steps in BASKET_ROUTE_HELD:
        one(n, n_paths, n_steps, True, TERMINAL_TILE if n_steps == 1 else 4096)
    attrs = {}
    for n in (*range(1, cb.REGISTER_ASSETS + 1), 17, 33, 50, 64, cb.MAX_ASSETS):
        attrs[n] = cb.basket_kernel_attrs(n)

    def warps(a):
        return a["blocks_per_sm"] * a["block"] / 32

    log("[X0] registers / local bytes / warps an SM by assets: "
        + "; ".join(f"{n}: paths {a['basket_paths']['registers']}/"
                    f"{a['basket_paths']['spill_bytes']}/{warps(a['basket_paths']):g}, "
                    f"terminal {a['basket_terminal']['registers']}/"
                    f"{a['basket_terminal']['spill_bytes']}/{warps(a['basket_terminal']):g}"
                    + (f" (kernel 28's first design "
                       f"{a['basket_terminal_first']['registers']}/"
                       f"{a['basket_terminal_first']['spill_bytes']}/"
                       f"{warps(a['basket_terminal_first']):g})"
                       if n <= cb.FIRST_REGISTER_ASSETS else
                       f" (the generic instance, paths "
                       f"{a['basket_generic_first_paths']['registers']}/"
                       f"{a['basket_generic_first_paths']['spill_bytes']}/"
                       f"{warps(a['basket_generic_first_paths']):g}, terminal "
                       f"{a['basket_generic_first_terminal']['registers']}/"
                       f"{a['basket_generic_first_terminal']['spill_bytes']}/"
                       f"{warps(a['basket_generic_first_terminal']):g})")
                    for n, a in attrs.items()))
    local = {n: a for n, a in attrs.items() if n <= cb.REGISTER_ASSETS
             and any(a[k]["spill_bytes"] for k in ("basket_paths", "basket_terminal",
                                                   "basket_terminal_first") if k in a)}
    if local:
        fail(f"X0: an instance of 1-{cb.REGISTER_ASSETS} assets has local memory: {local}")
    log(f"[X0] kernels 27-28 held in {time.perf_counter() - t0:.1f} s")
    for k in errs:
        key = "basket_terminal_first" if k == "basket_terminal_first" else (
            "basket_paths" if k.startswith("basket_paths") else "basket_terminal")
        errs[k]["attrs"] = {str(n): dict(a[key], warps_per_sm=warps(a[key]))
                            for n, a in attrs.items() if cb.route(n) == (
                                "1_8" if k in ("basket_paths", "basket_terminal",
                                               "basket_terminal_first")
                                else k.rsplit("_", 2)[-2] + "_" + k.rsplit("_", 2)[-1])}
    return errs


def phase_exotics() -> dict:
    """The exotics path (``--path exotics``): X0 (phase_exotics_kernels),
    then, every launch count at 0 and the plain versions of kernels 27-28
    counted (any call, or a launch of kernel 28's first design or of the
    generic instance, fails the path), the entry points a user calls. B1
    the Andersen-Broadie 2-asset Bermudan max-call at 2^20 paths x 9 dates,
    S0 90/100/110, within AB_GATE of 8.075 / 13.902 / 21.345, the
    out-of-sample estimator within AB_OOS_GATE at 100 and below the
    in-sample price + 3 stderr, the no-dividend max-call equal to its
    European best-of (5 combined stderr or 0.3%) at the test's 2^16 x 12
    (at 2^20 printed beside); B2 the 3-asset basket at
    2^22: the geometric leg within 4 stderr + 1e-3 of its closed form, the
    CV price within 4 combined stderr of the plain one with its stderr cut
    over 5x, put-call parity (6 combined stderr or 2e-3), worst <= basket
    <= best; B3 and B4 (BASKET_WIDE_LEGS), a 12- and a 50-asset equal-weight
    basket, pairwise rho 0.4: the geometric leg within 4 stderr + 1e-3 of
    its closed form, the CV and plain calls within 4 combined stderr with
    the stderr cut over 5x, the Bermudan basket put at K 105 (12 dates)
    above its European + 3 stderr and its out-of-sample estimator below the
    in-sample price + 3 stderr (B4's regressions in float64); E1 bench.py's
    GBM Asian put (S0 = K = 100, T = 0.5, 50 steps)
    at 2^20: the Kemna-Vorst price within 4 stderr of the plain estimate,
    the stderr cut over 10x, the geometric average within 4 stderr of its
    closed form; E2 the four continuity-corrected barriers at 2^20 x 50
    within 4 stderr of Reiner-Rubinstein and closer than the discrete
    estimator, in + out = the vanilla on the same paths; E3 the American
    Asian put at the reference default 2^17 x 25 within 1% of the MC
    European + the lattice's premium, the Heston American Asian above its
    European - 2 stderr; E4 the lookback orderings at 2^17 x 64 and
    varswap_mc for GBM (2^18 x 64), Heston (2^18 x 128) and Merton (2^18 x
    64) at tests/test_varswap.py's bars. Returns the errors, seconds and
    results."""
    import numpy as np
    import torch

    from options_model_tpu_torch.core.config import (HestonParams, MCConfig, MertonParams,
                                                      OptionSpec)
    from options_model_tpu_torch.core.stats import masked_mean_stderr
    from options_model_tpu_torch.models.multiasset import gbm_basket_terminal_exact
    from options_model_tpu_torch.ops import cuda_basket as cb
    from options_model_tpu_torch.ops.cuda_heston import TERMINAL_TILE
    from options_model_tpu_torch.pricers import american as pa
    from options_model_tpu_torch.pricers import (american_asian, barrier, basket, exotics,
                                                 fd_asian, varswap)
    from options_model_tpu_torch.pricers.american_basket import (FLOAT32_GRAM_ASSETS,
                                                                 price_american_basket)
    from options_model_tpu_torch.pricers.blackscholes import bs_price

    t_phase = time.perf_counter()
    errs = phase_exotics_kernels()
    counts = launch_counts()
    for d in counts.values():
        for key in d:
            d[key] = 0
    plain_calls = [0]
    reference = cb.basket_reference

    def counted_reference(*args, **kwargs):
        plain_calls[0] += 1
        return reference(*args, **kwargs)

    cb.basket_reference = counted_reference
    gen = lambda s: torch.Generator().manual_seed(s)  # noqa: E731
    secs, res = {}, {}

    def timed(label, fn, *args, **kwargs):
        """fn's result and its seconds, host clock to synchronize, on a
        second call (the first pays the one-time costs: cuBLAS handles,
        allocator growth; the same seed gives the same result)."""
        fn(*args, **kwargs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        secs[label] = time.perf_counter() - t0
        return out

    def check(tag, ok, msg):
        log(f"[{tag}] {msg}")
        if not ok:
            fail(f"{tag}: {msg}")

    def f2(x):
        return float(x[0]), float(x[1])

    # B1: Andersen-Broadie, 16x the test's paths
    mcb = MCConfig(n_paths=BASKET_SHAPES["andersen_broadie"][1], n_steps=9)
    ab = dict(K=100.0, T=3.0, r=0.05, sigmas=[0.2, 0.2], corr=np.eye(2), cp=1.0)
    for s0 in (90.0, 100.0, 110.0):
        p, se = f2(timed(f"B1 {s0:g}", price_american_basket, gen(3), [s0, s0], ab["K"],
                         ab["T"], ab["r"], ab["sigmas"], ab["corr"], ab["cp"], mcb, kind="max",
                         div_yields=[0.1, 0.1], device=DEVICE))
        rel = (p - AB_TRUE[s0]) / AB_TRUE[s0]
        res[f"B1 {s0:g}"] = dict(price=p, stderr=se, rel=rel)
        check("B1", abs(rel) < AB_GATE,
              f"2-asset Bermudan max-call S0 {s0:g}, 2^20 x 9: {p:.6f} +- {se:.6f} against "
              f"{AB_TRUE[s0]} ({rel * 100:+.3f}%, bar {AB_GATE * 100:g}%; "
              f"{secs[f'B1 {s0:g}']:.3f} s a price)")
    p_in = res["B1 100"]["price"]
    p_oos, se_oos = f2(timed("B1 oos", price_american_basket, gen(3), [100.0, 100.0], ab["K"],
                             ab["T"], ab["r"], ab["sigmas"], ab["corr"], ab["cp"], mcb,
                             kind="max", div_yields=[0.1, 0.1], out_of_sample=True,
                             device=DEVICE))
    rel = (p_oos - AB_TRUE[100.0]) / AB_TRUE[100.0]
    res["B1 oos"] = dict(price=p_oos, stderr=se_oos, rel=rel)
    check("B1", abs(rel) < AB_OOS_GATE and p_oos < p_in + 3 * se_oos,
          f"out-of-sample at S0 100: {p_oos:.6f} +- {se_oos:.6f} ({rel * 100:+.3f}%, bar "
          f"{AB_OOS_GATE * 100:g}%), in-sample {p_in:.6f}")
    corr = [[1.0, 0.3], [0.3, 1.0]]
    nodiv = {}
    for n_am in (1 << 16, 1 << 20):
        p_am, se_am = f2(timed(f"B1 no dividend {n_am}", price_american_basket, gen(3),
                               [100.0, 100.0], 100.0, 1.0, 0.05, [0.2, 0.25], corr, 1.0,
                               MCConfig(n_paths=n_am, n_steps=12), kind="max", device=DEVICE))
        p_eu, se_eu = f2(timed(f"B1 best_of {2 * n_am}", basket.price_basket_mc, gen(4),
                               [100.0, 100.0], [0.5, 0.5], 100.0, 1.0, 0.05, [0.2, 0.25], corr,
                               1.0, kind="best_of", n_paths=2 * n_am, device=DEVICE))
        nodiv[n_am] = dict(american=p_am, stderr=se_am, european=p_eu, eu_stderr=se_eu,
                           gap=(p_am - p_eu) / p_eu)
        log(f"[B1] no-dividend max-call ({n_am} x 12) {p_am:.6f} +- {se_am:.6f} against its "
            f"European best-of ({2 * n_am}) {p_eu:.6f} +- {se_eu:.6f}: "
            f"{(p_am - p_eu) / p_eu * 100:+.3f}%, {(p_am - p_eu) / math.hypot(se_am, se_eu):+.2f}"
            f" combined stderr")
    res["B1 no dividend"] = nodiv
    # the test's own size and bar (tests/test_basket_american.py:44-59); at
    # 2^20 the in-sample policy's low bias (~0.5%, the JAX package's too)
    # passes 5 combined stderr and is printed, not gated
    t = nodiv[1 << 16]
    check("B1", abs(t["american"] - t["european"])
          < max(5 * math.hypot(t["stderr"], t["eu_stderr"]), 0.003 * t["european"]),
          f"no-dividend max-call at the test's 2^16 x 12: within 5 combined stderr or 0.3% of "
          f"its European best-of")

    # B2: the 3-asset basket at 2^22
    w = [1.0 / 3] * 3
    bk = (B2_S0, w, 100.0, 0.5, 0.05, B2_SIGS, B2_CORR)
    S_T = gbm_basket_terminal_exact(5, B2_S0, 0.05, B2_SIGS, B2_CORR, 0.5, 1 << 22,
                                    device=DEVICE)
    wt = torch.tensor(w, dtype=torch.float32, device=DEVICE)
    geo = torch.exp(torch.tensordot(wt, torch.log(S_T), dims=1))
    g_mean, g_se, _ = masked_mean_stderr(torch.clamp_min(geo - 100.0, 0.0) * math.exp(-0.025),
                                         pair_block=TERMINAL_TILE)
    cf = basket.geometric_basket_bs_price(B2_S0, w, 100.0, 0.5, 0.05, B2_SIGS, B2_CORR)
    check("B2", abs(float(g_mean) - cf) < 4 * float(g_se) + 1e-3,
          f"geometric basket call, 2^22: MC {float(g_mean):.6f} +- {float(g_se):.6f}, closed "
          f"form {cf:.6f}")
    del S_T, geo
    p_cv, se_cv = f2(timed("B2 cv", basket.price_basket_mc, gen(7), *bk, n_paths=1 << 22,
                           device=DEVICE))
    p_pl, se_pl = f2(timed("B2 plain", basket.price_basket_mc, gen(7), *bk, n_paths=1 << 22,
                           control_variate=False, device=DEVICE))
    res["B2"] = dict(cv=p_cv, cv_stderr=se_cv, plain=p_pl, plain_stderr=se_pl,
                     geometric=float(g_mean), closed_form=cf)
    check("B2", abs(p_cv - p_pl) < max(4 * math.hypot(se_cv, se_pl), 1e-3)
          and 5 * se_cv < se_pl,
          f"basket call 2^22: CV {p_cv:.6f} +- {se_cv:.6f} ({secs['B2 cv']:.3f} s), plain "
          f"{p_pl:.6f} +- {se_pl:.6f}: stderr cut {se_pl / se_cv:.1f}x (bar 5x)")
    p_put, se_put = f2(basket.price_basket_mc(gen(7), *bk, cp=-1.0, n_paths=1 << 22,
                                              device=DEVICE))
    rhs = math.exp(-0.025) * (float(np.dot(w, np.asarray(B2_S0) * math.exp(0.025))) - 100.0)
    check("B2", abs((p_cv - p_put) - rhs) < max(6 * math.hypot(se_cv, se_put), 2e-3),
          f"put-call parity: C - P {p_cv - p_put:.6f} against {rhs:.6f}")
    best = f2(basket.price_basket_mc(gen(7), *bk, kind="best_of", n_paths=1 << 22,
                                     device=DEVICE))[0]
    worst = f2(basket.price_basket_mc(gen(7), *bk, kind="worst_of", n_paths=1 << 22,
                                      device=DEVICE))[0]
    res["B2"].update(put=p_put, best_of=best, worst_of=worst)
    check("B2", worst <= p_cv <= best, f"worst-of {worst:.6f} <= basket {p_cv:.6f} <= best-of "
          f"{best:.6f}")

    # B3-B4: the 12- and 50-asset baskets, the routes from 9 assets
    for tag, (n, step, n_eu, n_am) in BASKET_WIDE_LEGS.items():
        w = [1.0 / n] * n
        S0, sig, q = [100.0] * n, [0.15 + step * i for i in range(n)], [0.02] * n
        corr = np.full((n, n), BASKET_WIDE_RHO) + (1.0 - BASKET_WIDE_RHO) * np.eye(n)
        bk = (S0, w, 100.0, 1.0, 0.05, sig, corr)
        S_T = gbm_basket_terminal_exact(5, S0, 0.05, sig, corr, 1.0, n_eu, div_yields=q,
                                        device=DEVICE)
        wt = torch.tensor(w, dtype=torch.float32, device=DEVICE)
        geo = torch.exp(torch.tensordot(wt, torch.log(S_T), dims=1))
        g_mean, g_se, _ = masked_mean_stderr(
            torch.clamp_min(geo - 100.0, 0.0) * math.exp(-0.05), pair_block=TERMINAL_TILE)
        cf = basket.geometric_basket_bs_price(S0, w, 100.0, 1.0, 0.05, sig, corr,
                                              div_yields=q)
        check(tag, abs(float(g_mean) - cf) < 4 * float(g_se) + 1e-3,
              f"{n}-asset geometric basket call, {n_eu} paths: MC {float(g_mean):.6f} +- "
              f"{float(g_se):.6f}, closed form {cf:.6f}")
        del S_T, geo
        p_cv, se_cv = f2(timed(f"{tag} cv", basket.price_basket_mc, gen(7), *bk, n_paths=n_eu,
                               div_yields=q, device=DEVICE))
        p_pl, se_pl = f2(timed(f"{tag} plain", basket.price_basket_mc, gen(7), *bk,
                               n_paths=n_eu, div_yields=q, control_variate=False,
                               device=DEVICE))
        check(tag, abs(p_cv - p_pl) < max(4 * math.hypot(se_cv, se_pl), 1e-3)
              and 5 * se_cv < se_pl,
              f"{n}-asset basket call, {n_eu} paths: CV {p_cv:.6f} +- {se_cv:.6f} "
              f"({secs[f'{tag} cv']:.4f} s), plain {p_pl:.6f} +- {se_pl:.6f}: stderr cut "
              f"{se_pl / se_cv:.1f}x (bar 5x)")
        p_eu, se_eu = f2(basket.price_basket_mc(gen(8), S0, w, 105.0, 1.0, 0.05, sig, corr,
                                                cp=-1.0, n_paths=n_eu, div_yields=q,
                                                device=DEVICE))
        mca = MCConfig(n_paths=n_am, n_steps=12)
        p_am, se_am = f2(timed(f"{tag} bermudan", price_american_basket, gen(3), S0, 105.0, 1.0,
                               0.05, sig, corr, -1.0, mca, kind="basket", weights=w,
                               div_yields=q, device=DEVICE))
        p_oos, se_oos = f2(timed(f"{tag} bermudan oos", price_american_basket, gen(3), S0, 105.0,
                                 1.0, 0.05, sig, corr, -1.0, mca, kind="basket", weights=w,
                                 div_yields=q, out_of_sample=True, device=DEVICE))
        res[tag] = dict(assets=n, geometric=float(g_mean), geometric_stderr=float(g_se),
                        closed_form=cf, cv=p_cv, cv_stderr=se_cv, plain=p_pl,
                        plain_stderr=se_pl, european_put=p_eu, european_put_stderr=se_eu,
                        bermudan=p_am, bermudan_stderr=se_am, oos=p_oos, oos_stderr=se_oos)
        check(tag, p_am > p_eu + 3 * se_eu and p_oos < p_am + 3 * se_oos,
              f"{n}-asset Bermudan basket put K 105, {n_am} x 12, regressions in "
              + ("float64" if n > FLOAT32_GRAM_ASSETS else "float32")
              + f": {p_am:.6f} +- {se_am:.6f} "
              f"({secs[f'{tag} bermudan']:.3f} s) above its European {p_eu:.6f} +- "
              f"{se_eu:.6f} + 3 stderr (premium {p_am - p_eu:+.6f}); out-of-sample "
              f"{p_oos:.6f} +- {se_oos:.6f} below the in-sample + 3 stderr")

    # E1: bench.py:326-328's Asian at 2^20 x 50
    put = OptionSpec(strike=100.0, rate=0.05, cp=-1.0, sigma=0.2)
    call = OptionSpec(strike=100.0, rate=0.05, cp=1.0, sigma=0.2)
    mce = MCConfig(n_paths=1 << 20, n_steps=50)
    pk, sek = f2(timed("E1 cv", exotics.price_asian_mc, gen(17), 100.0, 0.5, put, mce,
                       device=DEVICE))
    pp, sep = f2(timed("E1 plain", exotics.price_asian_mc, gen(17), 100.0, 0.5, put, mce,
                       control_variate="off", device=DEVICE))
    pg, seg = f2(exotics.price_asian_mc(gen(17), 100.0, 0.5, put, mce, average="geometric",
                                        device=DEVICE))
    cfg = float(exotics.geometric_asian_bs_price(100.0, 100.0, 0.5, 0.05, 0.2, 50, -1.0,
                                                 device=DEVICE))
    res["E1"] = dict(cv=pk, cv_stderr=sek, plain=pp, plain_stderr=sep, geometric=pg,
                     geometric_stderr=seg, closed_form=cfg)
    check("E1", abs(pk - pp) < 4 * sep and sek < sep / 10 and abs(pg - cfg) < 4 * seg,
          f"Asian put 2^20 x 50: Kemna-Vorst {pk:.6f} +- {sek:.6f} ({secs['E1 cv']:.3f} s), "
          f"plain {pp:.6f} +- {sep:.6f} (cut {sep / sek:.1f}x, bar 10x); geometric {pg:.6f} "
          f"+- {seg:.6f} against its closed form {cfg:.6f}")

    # E2: the barriers at 2^20 x 50
    for btype, B, cp in (("up-and-out", 120.0, 1.0), ("down-and-out", 85.0, -1.0),
                         ("up-and-in", 115.0, 1.0), ("down-and-in", 90.0, -1.0)):
        spec = call if cp > 0 else put
        rr = float(barrier.barrier_price_rr(100.0, 100.0, 0.5, 0.05, 0.2, B, btype, cp,
                                            device=DEVICE))
        p, se = f2(timed(f"E2 {btype}", barrier.price_barrier_mc, gen(18), 100.0, 0.5, spec,
                         B, btype, mce, continuity_correction=True, device=DEVICE))
        pd_, _ = f2(barrier.price_barrier_mc(gen(18), 100.0, 0.5, spec, B, btype, mce,
                                             device=DEVICE))
        res[f"E2 {btype}"] = dict(price=p, stderr=se, rr=rr, discrete=pd_)
        check("E2", abs(p - rr) < 4 * max(se, 1e-4) and abs(pd_ - rr) > abs(p - rr),
              f"{btype} B {B:g}: corrected {p:.6f} +- {se:.6f} ({(p - rr) / se:+.2f} stderr; "
              f"{secs[f'E2 {btype}']:.3f} s), Reiner-Rubinstein {rr:.6f}, discrete {pd_:.6f}")
    ko, _ = f2(barrier.price_barrier_mc(gen(19), 100.0, 0.5, call, 120.0, "up-and-out", mce,
                                        device=DEVICE))
    ki, _ = f2(barrier.price_barrier_mc(gen(19), 100.0, 0.5, call, 120.0, "up-and-in", mce,
                                        device=DEVICE))
    S = pa.simulate_paths(gen(19), 100.0, 0.5, mce, "gbm", sigma=0.2, rate=0.05, device=DEVICE)
    van = float(masked_mean_stderr(torch.clamp_min(S[-1] - 100.0, 0.0) * math.exp(-0.025),
                                   pair_block=pa._pair_block(mce, "gbm"))[0])
    del S
    check("E2", abs(ko + ki - van) < 1e-5 * van,
          f"in + out on the same paths {ko + ki:.6f} = the vanilla {van:.6f}")

    # E3: the American Asian put at the reference default
    mc3 = MCConfig(n_paths=1 << 17, n_steps=25)
    am, sam = f2(timed("E3", american_asian.price_american_asian, gen(7), 100.0, 1.0, put,
                       mc3, device=DEVICE))
    eu, seu = f2(exotics.price_asian_mc(gen(7), 100.0, 1.0, put, mc3, device=DEVICE))
    t0 = time.perf_counter()
    tree = [fd_asian.asian_binomial_price(100.0, 100.0, 1.0, 0.05, 0.2, 25, cp=-1.0,
                                          substeps=6, n_avg=400, american=a)
            for a in (False, True)]
    secs["E3 lattice"] = time.perf_counter() - t0
    anchor = eu + tree[1] - tree[0]
    res["E3"] = dict(american=am, stderr=sam, european=eu, eu_stderr=seu, lattice=tree,
                     anchor=anchor)
    check("E3", abs(am - anchor) / anchor < ASIAN_ANCHOR_GATE and am > eu + 0.1,
          f"American Asian put 2^17 x 25: {am:.6f} +- {sam:.6f} ({secs['E3']:.3f} s), anchor "
          f"{anchor:.6f} (European {eu:.6f} + lattice premium {tree[1] - tree[0]:.6f}): "
          f"{(am - anchor) / anchor * 100:+.3f}% (bar {ASIAN_ANCHOR_GATE * 100:g}%)")
    hp = HestonParams(kappa=2.0, theta=0.04, xi=0.5, rho=-0.7, v0=0.04)
    amh, _ = f2(timed("E3 heston", american_asian.price_american_asian, gen(7), 100.0, 1.0,
                      put, mc3, model="heston", heston=hp, device=DEVICE))
    euh, seh = f2(exotics.price_asian_mc(gen(7), 100.0, 1.0, put, mc3, model="heston",
                                         heston=hp, device=DEVICE))
    res["E3 heston"] = dict(american=amh, european=euh, eu_stderr=seh)
    check("E3", amh >= euh - 2 * seh and 0.5 < amh < 10.0,
          f"Heston American Asian put {amh:.6f} ({secs['E3 heston']:.3f} s) against its "
          f"European {euh:.6f} +- {seh:.6f}")

    # E4: lookbacks and variance swaps, 4x the tests' sizes
    mc4 = MCConfig(n_paths=1 << 17, n_steps=64)
    vanilla = float(bs_price(100.0, 100.0, 0.5, 0.05, 0.2, 1.0, device=DEVICE))
    fl_c, _ = f2(timed("E4 lookback", exotics.price_lookback_mc, gen(2), 100.0, 0.5, call,
                       mc4, device=DEVICE))
    fl_p, _ = f2(exotics.price_lookback_mc(gen(2), 100.0, 0.5, put, mc4, device=DEVICE))
    fx_c, _ = f2(exotics.price_lookback_mc(gen(2), 100.0, 0.5, call, mc4, strike_type="fixed",
                                           device=DEVICE))
    res["E4 lookback"] = dict(floating_call=fl_c, floating_put=fl_p, fixed_call=fx_c,
                              vanilla=vanilla)
    check("E4", fl_c > vanilla and fl_p > 0 and fx_c >= vanilla - 0.05,
          f"lookbacks 2^17 x 64: floating call {fl_c:.6f} > vanilla {vanilla:.6f}, floating "
          f"put {fl_p:.6f} > 0, fixed call {fx_c:.6f} >= vanilla - 0.05")
    mp = MertonParams(sigma=0.2, lam=0.5, mu_j=-0.1, sigma_j=0.15)
    hpv = HestonParams(kappa=2.0, theta=0.04, xi=0.4, rho=-0.6, v0=0.09)
    g = timed("E4 varswap gbm", varswap.varswap_mc, gen(21), 100.0, 0.7,
              MCConfig(n_paths=1 << 18, n_steps=64), "gbm", sigma=0.25, rate=0.05,
              device=DEVICE)
    bias = (0.05 - 0.5 * 0.25**2) ** 2 * 0.7 / 64
    check("E4", abs(g["var_strike"] - 0.0625 - bias) < 4 * g["var_stderr"]
          and g["vol_strike"] <= math.sqrt(g["var_strike"]) + 1e-9
          and abs(g["vol_strike"] - 0.25) < 0.01,
          f"GBM varswap 2^18 x 64: {g['var_strike']:.6f} +- {g['var_stderr']:.6f} against "
          f"0.0625 + {bias:.6f}; vol {g['vol_strike']:.6f} ({secs['E4 varswap gbm']:.3f} s)")
    h = timed("E4 varswap heston", varswap.varswap_mc, gen(22), 100.0, 0.5,
              MCConfig(n_paths=1 << 18, n_steps=128), "heston", heston=hpv, rate=0.05,
              device=DEVICE)
    kh = varswap.varswap_strike(0.5, "heston", heston=hpv)
    check("E4", abs(h["var_strike"] - kh) < 4 * h["var_stderr"] + 2e-3,
          f"Heston varswap 2^18 x 128: {h['var_strike']:.6f} +- {h['var_stderr']:.6f} against "
          f"{kh:.6f} ({secs['E4 varswap heston']:.3f} s)")
    m = timed("E4 varswap merton", varswap.varswap_mc, gen(23), 100.0, 1.0,
              MCConfig(n_paths=1 << 18, n_steps=64), "merton", merton=mp, rate=0.05,
              device=DEVICE)
    km = varswap.varswap_strike(1.0, "merton", merton=mp)
    check("E4", abs(m["var_strike"] - km) < 4 * m["var_stderr"] + 1e-3
          and m["var_strike"] > mp.sigma**2 + 2 * m["var_stderr"],
          f"Merton varswap 2^18 x 64: {m['var_strike']:.6f} +- {m['var_stderr']:.6f} against "
          f"{km:.6f} ({secs['E4 varswap merton']:.3f} s)")
    res["E4 varswap"] = dict(gbm=g, heston=h, merton=m, heston_strike=kh, merton_strike=km)

    cb.basket_reference = reference
    if plain_calls[0]:
        fail(f"the exotics path ran the plain version of kernels 27-28 {plain_calls[0]} times")
    for key in ("basket_terminal_first", "basket_generic_first"):
        if cb.launches[key]:
            fail(f"the exotics path launched {key} (a first design) {cb.launches[key]} times")
    log(f"[E] the plain versions of kernels 27-28, kernel 28's first design and the generic "
        f"instance ran 0 times on the path; kernel launches by route {dict(cb.launches)}")
    log("[E] seconds per price: " + ", ".join(f"{k} {v:.4f}" for k, v in secs.items()))
    phase = time.perf_counter() - t_phase
    log(f"[E] the exotics path took {phase:.1f} s")
    return dict(errs=errs, secs=secs, res=res, phase_seconds=phase)


def phase_exotics_timing(sass: dict, launches: dict) -> dict:
    """CUDA-event medians (N_TIMED) of kernels 27-28 at BASKET_SHAPES (27 at
    5 x 2^20 x 50 and at B1's 2 x 2^20 x 9, 28 at 3 x 2^22 exact), each
    beside its plain version (one run), its bound (bound(), ops_basket and
    draws_basket from this run's shapes, the output written once) and its
    registers and occupancy. Kernel 28 at 3 x 2^22 and at B1's European
    leg (BASKET_B1_EUROPEAN) in turns with its first design (first, new,
    new, first), each design's share of its bound, GB/s written, registers,
    local bytes, occupancy and static SASS instructions a pair (phase_sass,
    3 assets), beside ``fill_`` on an output of the same shape (the write
    floor: the bytes alone, not the function; timed before and after the
    turns). The routes from 9 assets at BASKET_ROUTE_SHAPES (route_row), in
    turns with their first design, the generic instance. Returns the rows
    by kernel name."""
    import torch

    from options_model_tpu_torch.ops import cuda_basket as cb
    from options_model_tpu_torch.ops.cuda_heston import TERMINAL_TILE
    from options_model_tpu_torch.utils.profiling import time_per_call

    per_call = sass["per_call"]
    pairs = sass.get("basket", {})
    out = {}
    dev = torch.device(DEVICE)
    src = "options_model_tpu_torch/csrc/basket.cu"

    def row_of(name, n, n_paths, n_steps, T, tile):
        paths = name == "basket_paths"
        designs = not paths and n <= cb.FIRST_REGISTER_ASSETS
        c = _basket_consts(n, n_steps, T)
        fn = cb.basket_paths if paths else cb.basket_terminal
        ref = cb.basket_paths_reference if paths else cb.basket_terminal_reference
        out_bytes = (n_steps + 1 if paths else 1) * n * n_paths * 4
        b = bound(n_paths, n_steps, ops_basket(n, paths), int_ops(draws_basket(n), per_call),
                  out_bytes)
        shape = f"{n} x {n_paths} x {n_steps}"

        def run():
            return fn(11, c, n_paths, n_steps, True, 0, tile, dev)

        extra = {}
        if designs:
            # kernel 28's two designs in turns, fill_ on the same output
            # before and after them
            def first():
                return cb.basket_terminal_first(11, c, n_paths, n_steps, True, 0, tile, dev)

            buf = torch.empty((n, n_paths), dtype=torch.float32, device=dev)
            fills = [time_per_call(lambda: buf.fill_(1.0), N_TIMED)]
            turns = [time_per_call(f, N_TIMED) for f in (first, run, run, first)]
            fills.append(time_per_call(lambda: buf.fill_(1.0), N_TIMED))
            del buf
            ms = (turns[1] + turns[2]) / 2
            extra = first_design_row("basket_terminal_first", src, shape, turns, b["bound_ms"],
                                     cb.basket_kernel_attrs(n)["basket_terminal_first"])
            extra.update(earlier_written_gb_s=out_bytes / extra["earlier_ms"] / 1e6,
                         fill_ms=sum(fills) / 2)
            if n == 3 and pairs:
                extra.update(sass_per_pair=pairs.get("basket terminal"),
                             earlier_sass_per_pair=pairs.get("basket terminal, first design"))
        else:
            ms = time_per_call(run, N_TIMED)
        plain = time_per_call(lambda: ref(11, c, n_paths, n_steps, True, 0, tile, dev), 1, 0)
        a = cb.basket_kernel_attrs(n)[name]
        occ = a["blocks_per_sm"] * a["block"] / THREADS_PER_SM
        row = dict(ms=ms, plain_ms=plain, bound_ms=b["bound_ms"], bound_by=b["bound_by"],
                   bound_term=b["bound_term"], shape=shape, written_gb_s=out_bytes / ms / 1e6,
                   registers=a["registers"], spill_bytes=a["spill_bytes"], occupancy=occ,
                   **extra)
        log(f"[5] {name} at {shape}: kernel {ms:.4f} ms, plain {plain:.2f} ms; bound "
            f"{b['bound_ms']:.4f} ms by {b['bound_term']}, {b['bound_ms'] / ms * 100:.1f}% of "
            f"bound, {row['written_gb_s']:.1f} GB/s written; {a['registers']} registers, "
            f"{a['spill_bytes']} local bytes, {occ:.1%} occupancy"
            + (f"; first design {row['earlier_ms']:.4f} ms, "
               f"{b['bound_ms'] / row['earlier_ms'] * 100:.1f}% of bound, "
               f"{row['earlier_written_gb_s']:.1f} GB/s written; fill_ on the same output "
               f"{row['fill_ms']:.4f} ms ({fills[0]:.4f}, {fills[1]:.4f}), "
               f"{b['bound_ms'] / row['fill_ms'] * 100:.1f}% of bound" if designs else "")
            + (f"; static SASS instructions a pair {row['sass_per_pair']:g} (first design "
               f"{row['earlier_sass_per_pair']:g})" if row.get("sass_per_pair") else ""))
        return row

    for key, (n, n_paths, n_steps) in BASKET_SHAPES.items():
        name = "basket_terminal" if n_steps == 1 else "basket_paths"
        tile = 4096 if name == "basket_paths" else TERMINAL_TILE
        row = row_of(name, n, n_paths, n_steps, 3.0 if n_steps == 9 else 0.5, tile)
        if key == "andersen_broadie":
            out[name]["andersen_broadie"] = row
        else:
            out[name] = row
    n, n_paths, n_steps = BASKET_B1_EUROPEAN
    out["basket_terminal"]["b1_european"] = row_of("basket_terminal", n, n_paths, n_steps, 1.0,
                                                   TERMINAL_TILE)
    routes = sass.get("basket_routes", {})
    for name, (n, n_paths, n_steps) in BASKET_ROUTE_SHAPES.items():
        out[name] = route_row(name, n, n_paths, n_steps, routes.get(name, {}), per_call)
        torch.cuda.empty_cache()
    log(f"[5] kernels 27-28's launches on the exotics path: {launches}")
    return out


def route_row(name: str, n: int, n_paths: int, n_steps: int, parts: dict,
              per_call: float) -> dict:
    """Phase 5's row of kernel 27 or 28 on a route from 9 assets (``name``
    of exotics_specs) at n x n_paths x n_steps, antithetic: CUDA-event
    medians of launches on buffers made once (cuda_basket.basket_launcher:
    at 64 assets the wrapper's host work, packing and copying the
    constants, can outlast the device spin that hides it) in turns with the
    first design, the generic instance (first, new, new, first), each
    beside the bound (bytes, f32 and int32 terms)
    and its share, the SASS issue floor at this shape (basket_issue_floor;
    the correlate's _rn products and sums issue apart, never as FMAs),
    registers, local bytes, warps an SM; the plain version once."""
    import torch

    from options_model_tpu_torch.ops import cuda_basket as cb
    from options_model_tpu_torch.ops.cuda_heston import TERMINAL_TILE
    from options_model_tpu_torch.utils.profiling import time_per_call

    paths = name.startswith("basket_paths")
    tile = 4096 if paths else TERMINAL_TILE
    dev = torch.device(DEVICE)
    c = _basket_consts(n, n_steps)
    ref = cb.basket_paths_reference if paths else cb.basket_terminal_reference
    out_bytes = (n_steps + 1 if paths else 1) * n * n_paths * 4
    b = bound(n_paths, n_steps, ops_basket(n, paths), int_ops(draws_basket(n), per_call),
              out_bytes)
    shape = f"{n} x {n_paths} x {n_steps}"

    run, _, _ = cb.basket_launcher(11, c, n_paths, n_steps, True, 0, tile, dev,
                                   "paths" if paths else "terminal")
    first, _, _ = cb.basket_launcher(11, c, n_paths, n_steps, True, 0, tile, dev,
                                     "generic_paths" if paths else "generic_terminal")
    turns = [time_per_call(f, N_TIMED) for f in (first, run, run, first)]
    del run, first
    ms = (turns[1] + turns[2]) / 2
    attrs = cb.basket_kernel_attrs(n)
    a = attrs["basket_paths" if paths else "basket_terminal"]
    g = attrs["basket_generic_first_paths" if paths else "basket_generic_first_terminal"]
    extra = first_design_row("basket_generic_first", "options_model_tpu_torch/csrc/basket.cu",
                             shape, turns, b["bound_ms"], g)
    plain = time_per_call(lambda: ref(11, c, n_paths, n_steps, True, 0, tile, dev), 1, 0)
    floor = basket_issue_floor(parts, n, n_paths // 2, n_steps)
    occ = a["blocks_per_sm"] * a["block"] / THREADS_PER_SM
    row = dict(ms=ms, plain_ms=plain, bound_ms=b["bound_ms"], bound_by=b["bound_by"],
               bound_term=b["bound_term"], bound_ms_f32_bytes=b["bound_ms_f32_bytes"],
               shape=shape, assets_route=cb.route(n), written_gb_s=out_bytes / ms / 1e6,
               registers=a["registers"], spill_bytes=a["spill_bytes"], occupancy=occ,
               warps_per_sm=a["blocks_per_sm"] * a["block"] / 32,
               earlier_warps_per_sm=g["blocks_per_sm"] * g["block"] / 32, **floor, **extra)
    log(f"[5] {name} ({cb.route(n)}) at {shape}: kernel {ms:.4f} ms, plain {plain:.2f} ms; "
        f"bound {b['bound_ms']:.4f} ms by {b['bound_term']} (bytes and f32 alone "
        f"{b['bound_ms_f32_bytes']:.4f}), {b['bound_ms'] / ms * 100:.1f}% of bound, "
        f"{row['written_gb_s']:.1f} GB/s written; "
        + (f"SASS {floor['instructions_per_pair_step']:.1f} instructions a pair-step, issue "
           f"floor {floor['issue_floor_ms']:.4f} ms ({floor['issue_floor_ms'] / ms * 100:.1f}% "
           f"of its time); " if floor else "SASS not read, no issue floor; ")
        + f"{a['registers']} registers, {a['spill_bytes']} local bytes, "
        f"{row['warps_per_sm']:g} warps an SM; the generic instance {row['earlier_ms']:.4f} ms "
        f"({b['bound_ms'] / row['earlier_ms'] * 100:.1f}% of bound, "
        f"{row['earlier_warps_per_sm']:g} warps an SM), {row['earlier_ms'] / ms:.2f}x")
    return row


# The paths run in processes of their own (``chip_smoke.py --path name``).
SEPARATE_PATHS = {"nn": phase_nn, "calibration": phase_calibration, "rough": phase_rough,
                  "exotics": phase_exotics}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device; torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from options_model_tpu_torch.utils.profiling import card_line

    t_script = time.perf_counter()
    phase_build()
    sass = phase_sass()
    specs = kernel_specs()
    phase_philox()
    errs = phase_kernels(specs + earlier_specs(specs))
    phase_batched(specs)
    phase_constant_sigma()
    phase_digests()
    var_errs = phase_variants()
    vjp = vjp_specs()
    vjp_errs = phase_vjp()
    jumps = jump_specs()
    jump_errs = phase_jump_kernels()
    duals = dual_specs()
    dual_errs, dual_cases = phase_dual_kernels()
    normals = normals_specs()
    normals_errs = phase_normals()
    families = family_specs()
    family_f0 = phase_family_kernels()
    rough = rough_specs()
    exotics = exotics_specs()

    from options_model_tpu_torch.ops import cuda_heston_variants as hv

    from options_model_tpu_torch.ops import cuda_heston, cuda_jumps

    counted = specs + vjp + jumps + duals + normals + families + rough + exotics
    # kernels 12-18's, 21's, 22's, 24's, 25-26's and 28's first designs: the yardsticks no
    # path may reach
    from options_model_tpu_torch.ops import (cuda_basket, cuda_dual, cuda_gbm, cuda_rbergomi,
                                              cuda_sabr, cuda_vg)

    firsts = {"euler_paths_vjp_first": cuda_heston.launches,
              "gbm_paths_vjp_first": cuda_gbm.launches,
              **{key: cuda_jumps.launches for key in JUMP_FIRSTS},
              "dual_ce_first": cuda_dual.launches,
              **{FAMILY_FIRSTS[k]: cuda_vg.launches for k in ("vg_paths", "vg_terminal")},
              FAMILY_FIRSTS["sabr_terminal"]: cuda_sabr.launches,
              **{key: cuda_rbergomi.launches for key in RB_FIRST},
              **{key: cuda_dual.launches for key in ROUGH_DUAL_FIRSTS},
              "basket_terminal_first": cuda_basket.launches,
              "basket_generic_first": cuda_basket.launches}
    counters = [k["counter"] for k in counted + earlier_specs(specs)]
    counters += [(hv.launches, key) for key in hv.launches]
    counters += [(d, key) for key, d in firsts.items()]

    def drive(path, fn):
        """Run one path with every count at 0; fail if a kernel of that path
        was never launched, or if the first design of kernels 1, 3-8,
        12-18, 21, 22, 24, 25-26 or 28, or of the variants, was. Returns
        (fn's result, that path's counts)."""
        for d, key in counters:
            d[key] = 0
        cuda_jumps.shape_launches.clear()
        t0 = time.perf_counter()
        out = fn()
        counts = {k["name"]: k["counter"][0][k["counter"][1]] for k in counted}
        log(f"[4] kernel launches during the {path} path ({time.perf_counter() - t0:.1f} s "
            f"here, {time.perf_counter() - t_script:.1f} s into the script): {counts}")
        mine = {k["name"]: counts[k["name"]] for k in counted if path in k["paths"]}
        if not all(mine.values()):
            fail(f"a kernel of the {path} path was never launched: {mine}")
        earlier = {k["name"]: k["counter"][0][k["counter"][1]] for k in earlier_specs(specs)}
        earlier["heston_variant_accurate"] = sum(n for key, n in hv.launches.items()
                                                 if "first design" in key)
        earlier.update({key: d[key] for key, d in firsts.items()})
        log(f"[4] first-design launches during the {path} path: {earlier}")
        if any(earlier.values()):
            fail(f"the {path} path reached the first design of kernels 1, 3-8, 12-18, 21, 22, 24, "
                 f"25-26 or 28, or of the variants: {earlier}")
        return out, mine

    (secs, euro), launches = drive("main", phase_main_path)
    (secs2, surface_cells, euro2, lv_put), launches2 = drive("second", phase_second_path)
    euro.update(euro2)
    launches.update(launches2)
    started = {name: start_path(name) for name in SEPARATE_PATHS}
    (secs_g, per_call_g, greeks_res), launches_g = drive("greeks", phase_greeks)
    (secs_j, jump_res), launches_j = drive("jumps", phase_jumps)
    shapes_j = dict(cuda_jumps.shape_launches)
    log(f"[4] merton_paths launches during the jumps path by (n_mat, n_pad, n_steps): "
        f"{shapes_j}")
    if sum(shapes_j.values()) != launches_j["merton_paths"]:
        fail(f"merton_paths' launches by shape {shapes_j} do not add up to its "
             f"{launches_j['merton_paths']} launches on the jumps path")
    (secs_d, dual_res), launches_d = drive("dual", phase_dual)
    (secs_v, ivnn_res), launches_v = drive("ivnn", phase_ivnn)
    (secs_f, family_res), launches_f = drive("families", phase_families)
    secs_nn, launches_nn = drive("nn", lambda: join_path(started["nn"]))
    cal_res, launches_c = drive("calibration", lambda: join_path(started["calibration"]))
    rough_res, launches_r = drive("rough", lambda: join_path(started["rough"]))
    exo_res, launches_x = drive("exotics", lambda: join_path(started["exotics"]))
    experiments = phase_experiments(sass["per_call"])

    phase_earlier_cells(surface_cells)
    j2 = jump_res["J2_merton_european"]
    phase_earlier_europeans(dict(euro, merton_european=(j2["price"], j2["stderr"])))
    phase_earlier_localvol_american(lv_put)
    t_timing = time.perf_counter()
    times = phase_timing(specs, sass["per_call"])
    times.update(phase_vjp_timing(vjp, sass["per_call"]))
    times.update(phase_jump_timing(sass["per_call"], shapes_j))
    dual_times = phase_dual_timing(sass, secs_d, launches_d, dual_cases)
    normals_times = phase_normals_timing(sass["per_call"], launches_v)
    family_times = phase_family_timing(sass, family_f0["attempts"], launches_f)
    rough_times = phase_rough_timing(sass, rough_res, launches_r)
    exo_times = phase_exotics_timing(sass, {k["name"]: launches_x[k["name"]] for k in exotics})
    log(f"[5] the kernel timings (phase 5) took {time.perf_counter() - t_timing:.1f} s")
    log("[5] main path seconds per price: "
        + ", ".join(f"{k} {v:.3f}" for k, v in secs.items()))
    log("[5] QE-M and local-vol path seconds per price or surface: "
        + ", ".join(f"{k} {v:.3f}" for k, v in secs2.items()))
    log("[5] NN-LSM path seconds per price: "
        + "; ".join(f"{k} " + ", ".join(f"{s} {v:.3f}" for s, v in d.items())
                    for k, d in secs_nn.items()))
    log(f"[5] NN-LSM path launches: {launches_nn}")
    # A European price at 2^22 x 100 is two launches of 2^21 paths
    # (price_european_mc's chunks): about the kernel's time at 2^22 x 100.
    legs = (("heston_european", secs, "heston_terminal"), ("gbm_european", secs, "gbm_terminal"),
            ("qe_european", secs2, "heston_terminal_qe"),
            ("localvol_european", secs2, "localvol_terminal"),
            ("merton_european", secs_j, "merton_terminal"))
    log("[5] European legs, seconds per price beside the kernel's ms at 2^22 x 100: "
        + "; ".join(f"{leg} {d[leg]:.6f} s, {name} {times[name]['ms']:.4f} ms"
                    + (f" (first design {times[name]['earlier_ms']:.4f} ms)"
                       if "earlier_ms" in times[name] else "")
                    for leg, d, name in legs))
    for label, calls in per_call_g.items():
        kernel_ms = sum(n * greeks_kernel_ms(times[name], label, name)
                        for name, n in calls.items())
        log(f"[5] Greeks call {label}: {secs_g[label]:.4f} s (median, host clock to "
            f"synchronize); kernel launches {calls}; forward and VJP kernels "
            f"{kernel_ms:.4f} ms, {kernel_ms / 1e3 / secs_g[label] * 100:.2f}% of the call")
    log("[5] calibration path, seconds per calibration (evaluations, ms per evaluation): "
        + "; ".join(f"{c} {cal_res[c]['seconds']:.3f} s ({cal_res[c]['nfev']}, "
                    f"{cal_res[c]['seconds'] / cal_res[c]['nfev'] * 1e3:.3f} ms)"
                    for c in ("C1", "C2", "C3", "C4", "C5", "C6"))
        + f"; C7 {cal_res['C7']['seconds']:.3f} s with its 64x64 surface; the default "
        f"cascade projected {cal_res['projected_default_cascade_s']:.1f} s; the phase "
        f"{cal_res['phase_seconds']:.1f} s; kernel launches {launches_c}")
    log("[5] jumps path, seconds per price or surface: "
        + ", ".join(f"{k} {v:.4f}" for k, v in secs_j.items())
        + f"; the phase {jump_res['phase_seconds']:.1f} s; kernel launches {launches_j}")
    log("[5] dual path, seconds per bracket: "
        + ", ".join(f"{k} {v:.3f}" for k, v in secs_d.items())
        + f"; the phase {dual_res['phase_seconds']:.1f} s; kernel launches {launches_d}")
    log("[5] IV-surface path seconds: " + ", ".join(f"{k} {v:.3f}" for k, v in secs_v.items())
        + f"; kernel launches {launches_v}")
    log("[5] families path seconds: " + ", ".join(f"{k} {v:.3f}" for k, v in secs_f.items())
        + f"; the phase {family_res['phase_seconds']:.1f} s; kernel launches {launches_f}")
    log("[5] exotics path seconds: " + ", ".join(f"{k} {v:.4f}"
                                                 for k, v in exo_res["secs"].items())
        + f"; the phase {exo_res['phase_seconds']:.1f} s; kernel launches {launches_x}")
    log(f"[5] card: {card_line()}")
    log(f"[5] the whole script took {time.perf_counter() - t_script:.1f} s")

    entries = [dict(name=k["name"], route="cuda", source=k["source"], replaces=k["replaces"],
                    launches=launches[k["name"]], max_abs_err=errs[k["name"]]["s_abs"],
                    library_ms=None, **times[k["name"]],
                    **({"greeks_launches": launches_g[k["name"]]} if k["name"] in launches_g
                       else {}),
                **({"jumps_launches": launches_j[k["name"]]} if k["name"] in launches_j
                   else {}),
                    **({"ivnn_launches": launches_v[k["name"]]} if k["name"] in launches_v
                       else {}),
                    **({"calibration_launches": launches_c[k["name"]]}
                       if k["name"] in launches_c else {}),
                    **({"earlier_name": k["earlier"]["name"],
                        "earlier_source": k["earlier"]["source"],
                        "earlier_max_abs_err": errs[k["earlier"]["name"]]["s_abs"]}
                       if "earlier" in k else {}))
               for k in specs]
    entries.append(experiment_entry(experiments[0], "B bulk exp", "B0 bulk exp, first design",
                                    "scripts/exp_paths_kernel.py:31", var_errs))
    entries.append(experiment_entry(experiments[1], "C  blocked, tile 4096",
                                    "C0 blocked, tile 4096, first design",
                                    "scripts/exp_fullpath_layout.py:36", var_errs))
    entries += [dict(name=k["name"], route="cuda", source=k["source"], replaces=k["replaces"],
                     launches=launches_g[k["name"]],
                     max_abs_err=vjp_errs[k["name"]]["max_abs_err"],
                     max_scaled_err=vjp_errs[k["name"]]["max_scaled_err"],
                     fd_worst=vjp_errs[k["name"]]["fd_worst"],
                     greeks_shape_scaled_err=vjp_errs[k["name"]]["greeks_shape_scaled_err"],
                     backward_of=k["forward"],
                     **({"earlier_max_scaled_err": vjp_errs[k["name"]]["first_max_scaled_err"]}
                        if "first_max_scaled_err" in vjp_errs[k["name"]] else {}),
                     **({"earlier_total_rel": vjp_errs[k["name"]]["first_total_rel"]}
                        if "first_total_rel" in vjp_errs[k["name"]] else {}),
                     library_ms=None, **times[k["name"]])
                for k in vjp]
    entries += [dict(name=k["name"], route="cuda", source=k["source"], replaces=k["replaces"],
                     launches=launches_j[k["name"]], max_abs_err=jump_errs[k["name"]]["s_abs"],
                     max_rel_err=jump_errs[k["name"]]["s_rel"], library_ms=None,
                     **({"earlier_max_abs_err": jump_errs[k["name"] + "_first"]["s_abs"]}
                        if k["name"] + "_first" in jump_errs else {}),
                     **times[k["name"]])
                for k in jumps]
    entries += [dict(name=k["name"], route="cuda", source=k["source"], replaces=k["replaces"],
                     launches=launches_d[k["name"]], library_ms=None, **dual_errs[k["name"]],
                     **dual_times[k["name"]]["gbm"],
                     families={m: {key: r[key] for key in ("ms", "plain_ms", "bound_ms",
                                                           "bound_by", "registers", "earlier_ms",
                                                           "instructions_per_eval",
                                                           "earlier_instructions_per_eval")
                                   if key in r}
                               for m, r in dual_times[k["name"]].items()})
                for k in duals]
    entries += [dict(name=k["name"], route="cuda", source=k["source"], replaces=k["replaces"],
                     launches=launches_v[k["name"]], library_ms=None, **normals_errs[k["name"]],
                     **normals_times["european chunk"],
                     american_chunk={key: normals_times["american chunk"][key]
                                     for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                 "shape")})
                for k in normals]
    entries += [dict(name=k["name"], route="cuda", source=k["source"], replaces=k["replaces"],
                     launches=launches_f[k["name"]],
                     max_abs_err=family_f0["errs"][k["name"]]["s_abs"],
                     max_rel_err=family_f0["errs"][k["name"]]["s_rel"], library_ms=None,
                     **({"earlier_max_abs_err":
                         family_f0["errs"][FAMILY_FIRSTS[k["name"]]]["s_abs"]}
                        if k["name"] in FAMILY_FIRSTS else {}),
                     **family_times[k["name"]])
                for k in families]
    entries += [dict(name=k["name"], route="cuda", source=k["source"], replaces=k["replaces"],
                     launches=launches_r[k["name"]], library_ms=None,
                     **rough_res["errs"][k["name"]], **rough_times[k["name"]])
                for k in rough]
    entries += [dict(name=k["name"], route="cuda", source=k["source"], replaces=k["replaces"],
                     launches=launches_x[k["name"]], library_ms=None,
                     max_abs_err=exo_res["errs"][k["name"]]["s_abs"],
                     max_ulps=exo_res["errs"][k["name"]]["s_ulps"],
                     **({"earlier_max_abs_err":
                         exo_res["errs"][k["name"] + "_first"]["s_abs"]}
                        if k["name"] + "_first" in exo_res["errs"] else {}),
                     **exo_times[k["name"]])
                for k in exotics]
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--path"]:
        sys.exit(path_process(sys.argv[2], "--joined" in sys.argv[3:]))
    sys.exit(main())
