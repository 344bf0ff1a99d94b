// The martingale dual's inner expectation for Hopper (sm_90a).
//
// The JAX package computes it in XLA code, not in Pallas:
//   options_model_tpu/pricers/dual.py:292  dual_upper_from_policy: date_ce, a lax.scan
//                                          over dates (:579-620 Heston and Bates,
//                                          :706-735 GBM and Merton): kernel 18
//   options_model_tpu/pricers/dual.py:847  dual_upper_from_nn_policy (:910-962): kernel 19
//   options_model_tpu/pricers/dual.py:442-561, :634-686  the SABR, rough Bergomi and VG
//                                          branches of date_ce: kernel 18's families 4-6,
//                                          and VG's terminal expectation (:676-686):
//                                          dual_vg_terminal_kernel
// Each (date, path) takes n_inner antithetic one-step draws of the
// simulator's transition and evaluates the value surrogate at each; eager
// torch would hold several (n_inner/2, P) tensors a date and draw its Philox
// words in int64 arithmetic, so the port has kernels of its own, with plain
// versions on the same counters (ops/cuda_dual.py; ops/philox.py states the
// stream: counter = (slot in tile, draw, global tile, 2), one slot a path,
// draw = date x calls a date + call, the jump calls counted in every family).
//
// - dual_ce_kernel<F, kCall> (kernel 18): one thread a (date, path),
//   grid (paths, dates). A block loads its date's policy row (tau, x_mean,
//   x_rstd, v_mean, v_rstd, betas) into shared memory and its first thread
//   folds the date's floor constants (FloorT) there once; the thread reads
//   x_t (and v_t) once, walks the inner pairs (Philox in the kernel, the plain
//   version's Box-Muller with 1 - u in the log, the pair mirrored: z and -z,
//   the jump normal too, the Poisson count shared), evaluates the surrogate
//   at both members (_vhat: the intrinsic value, the Black-Scholes floor at
//   the date's remaining maturity, the clamped polynomial gated to the
//   in-the-money side and clipped to [0, cap]), and writes the mean once.
//   The family (GBM, Heston, Merton, Bates, VG, SABR, rough Bergomi) and
//   the side (put or call) are compile-time, fourteen instances; the
//   polynomial's degree is a run-time argument, its betas read from the row
//   in shared memory. VG's pairs share one Marsaglia-Tsang clock draw (the
//   decision code of csrc/gamma.cuh, kernels 21-22's, on the dual's gamma
//   counters: word 3 = 5) and mirror the normal; SABR's walk the state (x,
//   alpha) with the exact lognormal alpha step; rough Bergomi's add each
//   path's frozen Volterra history hist[t] and the date's compensator
//   comp[t] (Y' = hist + sqrt(2H) (c1 dW' + c2 z2'), v' = xi0 exp(eta Y' -
//   comp)) and mirror all three normals. Pricers take this kernel for
//   GBM, Heston, Merton and Bates; for VG, SABR and rough Bergomi it is the
//   first design, kept as the yardstick of their redesigns below
//   (ops/cuda_dual.dual_ce_first); its VG clock loop diverges within a warp
//   wherever a lane's draw is rejected (~5% of attempts at the brackets'
//   shapes, so a warp runs ~1.9 attempts a draw for ~1.05).
// - dual_ce_vg_kernel<kCall, kDebug> (kernel 18's VG redesign): the same
//   thread and walk, with the clock drawn apart from it, warp-dense, on
//   csrc/gamma.cuh's WarpClock (kernel 22's schedule): for a chunk of 8
//   pairs a lane the warp draws attempt 0 of every lane's pairs and decides
//   each by Marsaglia-Tsang's squeeze (its proven margin, no logf), queues
//   the rest by ballot for the exact test a lane an entry, retries the
//   rejections from a ring (attempts 1-14, then d), and only then walks
//   the chunk from the clock in shared memory (the boost, sqrt_clock ==
//   sqrtf without its slow path). Every G and accepting attempt is
//   gamma_draw's, so every x' is too.
// - dual_ce_rough_kernel<kCall, kDebug> (kernel 18's rough Bergomi
//   redesign): the mirror's products once a pair (the down member's are
//   the up member's negated exactly), x' bit for bit; v' = A e^{+-s} with A
//   once a (date, path) and one ex2 and one reciprocal a pair, within the
//   budget stated beside it.
// - dual_ce_sabr_kernel<kCall, kDebug> (kernel 18's SABR redesign): the
//   same mirror, x' bit for bit; alpha' = A e^{+-s} likewise, and the
//   floor's sigma' sqrt(tau) and its reciprocal as (A sqrt tau) e^{+-s}
//   and (1 / (A sqrt tau)) e^{-+s}, so no square, product by tau or rsqrtf
//   a member; the Philox round keys from the launch's constants.
// - dual_vg_terminal_warp_kernel<kCall, kDebug>: VG's terminal step, the
//   Rao-Blackwellised one-step Black expectation over n_inner/2 clock
//   draws a path (the same sampler at date n_dates), one entry a (path,
//   draw) on the shared WarpClock, log x once a path, each path's values
//   summed in draw order. Its first design, dual_vg_terminal_kernel (one
//   thread a path walking its draws through gamma_draw), stays as its
//   yardstick (ops/cuda_dual.dual_vg_terminal_first).
// - dual_ce_first_kernel<F>: kernel 18's first design, kept as the
//   redesign's yardstick (ops/cuda_dual.dual_ce_first); no pricer reaches it.
// - dual_inner_states_kernel<F, kCounts> (kernel 19): the same walk and
//   transitions for a chunk of dates, writing each inner state x' (and v'
//   under Heston) as (chunk, 2, n_inner/2, P), the pair's up member first,
//   for the NN policy's network; with kCounts also each pair's Poisson count
//   (int32), so a check can hold the counts against the plain version's.
//   Its instances of the VG, SABR and rough Bergomi families serve that
//   check alone (the NN policy's dual takes GBM and Heston, as the
//   reference's): VG writes each pair's clock G where v' goes and its
//   accepting attempt where the count goes.
//
// No --use_fast_math anywhere. The walk (Philox, Box-Muller, the Poisson
// inversion and the one-step transition) does every float operation with
// the _rn intrinsics, which nvcc never contracts into an FMA, in the plain
// version's order: the inner states x', v' and the counts equal the plain
// version's bit for bit in all three kernels, so the surrogate's
// in-the-money gate (a jump at x' = 1) decides alike. Everything after the
// states is continuous in them: the first design keeps the _rn order there
// too and differs from the plain version by libdevice's logf, erfcf and
// divisions; the redesign lets nvcc contract it (fmaf) and differs by a few
// float32 ulps more (chip_smoke.py holds both at DUAL_CE_ATOL).
//
// What bounds them on the card: kernel 18 reads 4 (8 with v) bytes and
// writes 4 a (date, path) over n_inner surrogate evaluations, so it is held
// by its instruction issue. The first design paid, per evaluation, a logf
// of S / K, two IEEE divisions (S / K and d1's by sigma sqrt tau), under
// Heston two sqrtf of the floor's vol, two accurate erfcf, and only _rn
// operations, so no multiply-add fused: 243.75 SASS instructions an
// evaluation under GBM, 327 under Heston. The redesign keeps the two
// accurate erfcf (~45 instructions each) and the states' expf, and drops
// the rest: log x' = log xp + e, with e the exponent the step just took
// (log xp once a thread), so no logf and no division remain per
// evaluation; under GBM and Merton sigma sqrt tau is a date's constant, so
// d1 = A + B e with the side's sign and 1 / sqrt 2 folded into A and B;
// under Heston and Bates sigma^2 tau = max(theta + (v' - theta) frac,
// 1e-8) tau + jvar tau is taken directly and one rsqrtf gives both d1 and
// d2; the polynomial is Horner's over the betas in shared memory, the
// gate, clip and maxima a few min/max, the side (cp) a template argument.
// It stays held by its issue rate, the two erfcf about 90 of its 160
// (GBM) to 262 (Bates) SASS instructions an evaluation (PERF.md row 18
// has the counts). Under VG the first design's clock took ~70% of its
// issue (one Philox call, the accurate Box-Muller and two logf an attempt,
// the boost's logf, logf and expf, the warp waiting on its slowest lane);
// the redesign keeps each attempt's Philox and Box-Muller and the boost,
// and leaves the exact test's logf to the draws the squeeze does not
// decide. Under rough Bergomi two expf a pair go (v') and the Philox round
// keys come from the launch's constants, as in VG's; under SABR also the
// two expf of alpha' and the floor's square, product and rsqrtf. VG's
// terminal step's first design ran a warp per 32 paths, each lane's
// attempts in turn (the warp waiting on its slowest lane), with a logf and
// an IEEE division a draw; the redesign draws the clock warp-dense and
// keeps the boost, the step's expf and two erfcf a draw. Kernel 19
// writes 4 (8) bytes a state after ~20 operations and is held by its
// stores.
#include <algorithm>

#include "gamma.cuh"
#include "hopper_fast.cuh"
#include "kernel_attrs.cuh"
#include "philox.cuh"

namespace omt {
namespace dual {

using gamma::GammaK;
using gamma::kAttemptBits;
using gamma::kMaxAttempts;

constexpr int kBlock = 128;
constexpr uint32_t kDualStream = 2u;
// The dual's gamma attempts (ops/philox.DUAL_GAMMA_STREAM; VG_MAX_ATTEMPTS
// is csrc/gamma.cuh kMaxAttempts).
constexpr uint32_t kGammaStream = 5u;
constexpr float kUClamp = 4.0f;
// ops/philox.MAX_POISSON_TABLE, ops/cuda_dual.MAX_ROW and MAX_PAIRS.
constexpr int kMaxTable = 120;
constexpr int kMaxRow = 64;
constexpr int kMaxPairs = 1024;
constexpr int kRowHead = 5;  // tau, x_mean, x_rstd, v_mean, v_rstd

enum Family { kGbm = 0, kHeston = 1, kMerton = 2, kBates = 3, kVg = 4, kSabr = 5, kRBergomi = 6 };

template <int F>
constexpr bool kUseV = F == kHeston || F == kBates || F == kSabr || F == kRBergomi;
template <int F>
constexpr bool kJumps = F == kMerton || F == kBates;
// Families whose states kernel writes a second state: v' (alpha' under
// SABR), or VG's clock G.
template <int F>
constexpr bool kStateV = kUseV<F> || F == kVg;
// Inner pairs a diffusion call serves (ops/philox.DUAL_PAIRS_A_CALL); a jump
// call serves two.
template <int F>
constexpr int kPairsACall = F == kRBergomi ? 1 : (kUseV<F> ? 2 : 4);

// The law (pricers/dual.InnerLaw, ops/cuda_dual.LAW_FIELDS order) and its
// Poisson table, by value.
struct DualT {
  float K, cp, rate, q, dt, drift, mu, a, sig_f, kappa, theta, xi, rho, rho_bar, comp_dt, jvar,
      mu_j, sig_j;
  float nu, vg_theta, vg_sigma, gamma_d, gamma_c, gamma_inv_a, gamma_boost;
  float sqrt_dt, nu_sqrt_dt, half_nu2_dt, rbsd, sqrt2H, c1, c2, eta, xi0;
  float n_table;
  float table[kMaxTable];
};

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// pricers/blackscholes.ndtr: 0.5 erfc(-x / sqrt 2).
__device__ __forceinline__ float ndtr(float x) {
  return mul(0.5f, erfcf(mul(-x, 0.7071067811865476f)));
}

// A date's constants of the Black-Scholes floor and of Heston's effective
// vol: tau, sqrt tau, e^{-q tau}, K e^{-r tau}, (1 - e^{-k tau}) / k tau.
struct DateK {
  float tau, sqrt_tau, dq, kdr, frac;
};

__device__ __forceinline__ DateK date_consts(float tau, const DualT& k) {
  const float kt = fmaxf(mul(k.kappa, tau), 1e-6f);
  return DateK{tau, sqrtf(tau), expf(mul(-k.q, tau)), mul(k.K, expf(mul(-k.rate, tau))),
               dvd(-expm1f(-kt), kt)};
}

// pricers/blackscholes.bs_price(S, K, tau, r, sigma, cp, q).
__device__ __forceinline__ float bs_floor(float S, float sigma, const DateK& d, const DualT& k) {
  const float sq = mul(sigma, d.sqrt_tau);
  const float d1 =
      dvd(add(logf(dvd(S, k.K)), mul(add(k.drift, mul(0.5f, mul(sigma, sigma))), d.tau)), sq);
  const float d2 = sub(d1, sq);
  return mul(k.cp, sub(mul(mul(S, d.dq), ndtr(mul(k.cp, d1))), mul(d.kdr, ndtr(mul(k.cp, d2)))));
}

// The floor's vol at variance v (Heston, Bates): sqrt(sigma_eff(v, tau)^2
// + jvar), models/heston.effective_bs_sigma.
__device__ __forceinline__ float floor_vol(float v, const DateK& d, const DualT& k) {
  const float s = sqrtf(fmaxf(add(k.theta, mul(sub(v, k.theta), d.frac)), 1e-8f));
  return sqrtf(add(mul(s, s), k.jvar));
}

// pricers/dual._vhat at one state: max(h, E, clip(C, 0, cap) on the ITM side).
template <bool kV>
__device__ __forceinline__ float vhat(float x, float v, float sigma, const float* row, int degree,
                                      const DateK& d, const DualT& k) {
  const float* b = row + kRowHead;
  const float u = clampf(mul(sub(x, row[1]), row[2]), -kUClamp, kUClamp);
  float c = b[0];
  float p = u;
  for (int i = 1; i <= degree; ++i) {
    if (i > 1) p = mul(p, u);
    c = add(c, mul(b[i], p));
  }
  c = add(c, mul(b[degree + 1], fmaxf(sub(x, 1.0f), 0.0f)));
  if (kV) {
    const float w = clampf(mul(sub(v, row[3]), row[4]), -kUClamp, kUClamp);
    c = add(add(add(c, mul(b[degree + 2], w)), mul(b[degree + 3], mul(w, w))),
            mul(mul(b[degree + 4], u), w));
  }
  const float cap = k.cp > 0.0f ? mul(k.K, x) : k.K;
  const float m = mul(k.cp, sub(x, 1.0f));
  c = m >= 0.0f ? fminf(fmaxf(c, 0.0f), cap) : 0.0f;
  const float h = mul(k.K, fmaxf(m, 0.0f));
  const float e = bs_floor(mul(k.K, x), sigma, d, k);
  return fmaxf(fmaxf(h, e), c);
}

// A path's one-step constants at its date: Heston's sqrt(max(v, 0) dt),
// (r - q - v/2) dt - lam kbar dt and kappa (theta - v) dt; SABR's alpha
// sqrt(dt) and (r - q - alpha^2/2) dt; rough Bergomi's sqrt(max(v, 0)),
// (r - q - v/2) dt, the path's frozen history h and the date's compensator.
struct PathK {
  float xp, vp, sv, mu_t, dv, h, comp;
};

template <int F>
__device__ __forceinline__ PathK path_consts(float xp, float vp, float h, float comp,
                                             const DualT& k) {
  if (!kUseV<F>) return PathK{xp, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (F == kSabr) {
    return PathK{xp, vp, mul(vp, k.sqrt_dt), mul(sub(k.drift, mul(0.5f, mul(vp, vp))), k.dt),
                 0.0f, 0.0f, 0.0f};
  }
  if (F == kRBergomi) {
    return PathK{xp, vp, sqrtf(fmaxf(vp, 0.0f)), mul(sub(k.drift, mul(0.5f, vp)), k.dt), 0.0f,
                 h, comp};
  }
  return PathK{xp, vp, sqrtf(mul(fmaxf(vp, 0.0f), k.dt)),
               sub(mul(sub(k.drift, mul(0.5f, vp)), k.dt), k.comp_dt),
               mul(mul(k.kappa, sub(k.theta, vp)), k.dt), 0.0f, 0.0f};
}

// The inner pair's states: (x', v') of the up and the down member (VG's
// clock G in both v' slots), and the exponents of x' = xp e^eu and xp e^ed
// (the redesign's log x' - log xp).
struct Pair {
  float xu, xd, vu, vd, eu, ed;
};

// pricers/dual.inner_states_from_draws for one pair: normals z1 (z), z2,
// zp, the standard gamma draw gam (VG), the count n and the jump normal zj.
template <int F>
__device__ __forceinline__ Pair step_pair(const PathK& s, float z1, float z2, float zp, float gam,
                                          float n, float zj, const DualT& k) {
  float jb = 0.0f, jn = 0.0f;
  if (kJumps<F>) {
    jb = mul(n, k.mu_j);
    jn = mul(mul(k.sig_j, sqrtf(n)), zj);
  }
  Pair out;
  if (F == kVg) {
    const float G = mul(k.nu, gam);
    const float tb = mul(k.vg_theta, G), tn = mul(mul(k.vg_sigma, sqrtf(G)), z1);
    out.eu = add(add(k.mu, tb), tn);
    out.ed = sub(add(k.mu, tb), tn);
    out.xu = mul(s.xp, expf(out.eu));
    out.xd = mul(s.xp, expf(out.ed));
    out.vu = out.vd = G;
    return out;
  }
  if (F == kSabr) {
    const float w2 = add(mul(k.rho, z1), mul(k.rho_bar, z2));
    out.eu = add(s.mu_t, mul(s.sv, z1));
    out.ed = add(s.mu_t, mul(s.sv, -z1));
    out.xu = mul(s.xp, expf(out.eu));
    out.xd = mul(s.xp, expf(out.ed));
    out.vu = mul(s.vp, expf(sub(mul(k.nu_sqrt_dt, w2), k.half_nu2_dt)));
    out.vd = mul(s.vp, expf(sub(mul(k.nu_sqrt_dt, -w2), k.half_nu2_dt)));
    return out;
  }
  if (F == kRBergomi) {
    const float du = mul(k.sqrt_dt, z1), dd = mul(k.sqrt_dt, -z1);
    out.eu = add(s.mu_t, mul(s.sv, add(mul(k.rho, du), mul(k.rbsd, zp))));
    out.ed = add(s.mu_t, mul(s.sv, add(mul(k.rho, dd), mul(k.rbsd, -zp))));
    out.xu = mul(s.xp, expf(out.eu));
    out.xd = mul(s.xp, expf(out.ed));
    const float yu = add(s.h, mul(k.sqrt2H, add(mul(k.c1, du), mul(k.c2, z2))));
    const float yd = add(s.h, mul(k.sqrt2H, add(mul(k.c1, dd), mul(k.c2, -z2))));
    out.vu = mul(k.xi0, expf(sub(mul(k.eta, yu), s.comp)));
    out.vd = mul(k.xi0, expf(sub(mul(k.eta, yd), s.comp)));
    return out;
  }
  if (!kUseV<F>) {
    float up = add(k.mu, mul(k.a, z1)), dn = sub(k.mu, mul(k.a, z1));
    if (kJumps<F>) {
      up = add(add(up, jb), jn);
      dn = sub(add(dn, jb), jn);
    }
    out.xu = mul(s.xp, expf(up));
    out.xd = mul(s.xp, expf(dn));
    out.vu = out.vd = 0.0f;
    out.eu = up;
    out.ed = dn;
    return out;
  }
  const float w2 = add(mul(k.rho, z1), mul(k.rho_bar, z2));
  float up = add(s.mu_t, mul(s.sv, z1)), dn = add(s.mu_t, mul(s.sv, -z1));
  if (kJumps<F>) {
    up = add(up, add(jb, jn));
    dn = add(dn, sub(jb, jn));
  }
  out.xu = mul(s.xp, expf(up));
  out.xd = mul(s.xp, expf(dn));
  out.eu = up;
  out.ed = dn;
  const float base = add(s.vp, s.dv), xs = mul(k.xi, s.sv);
  out.vu = fmaxf(add(base, mul(xs, w2)), 0.0f);
  out.vd = fmaxf(add(base, mul(xs, -w2)), 0.0f);
  return out;
}

__device__ __forceinline__ Words draw(uint32_t slot, uint32_t index, uint32_t global_tile,
                                      uint64_t seed) {
  return philox4x32_10(Words{slot, index, global_tile, kDualStream},
                       static_cast<uint32_t>(seed), static_cast<uint32_t>(seed >> 32));
}

// The number of table entries u is not below: the Poisson count by
// inversion, as ops/philox.poisson_from_uniform.
__device__ __forceinline__ float poisson_count(float u, const DualT& k) {
  const int n_table = static_cast<int>(k.n_table);
  int n = 0;
  while (n < n_table && u >= k.table[n]) ++n;
  return static_cast<float>(n);
}

// The jump draws of pairs 2m and 2m + 1: one call, (w0, w1) -> the two jump
// normals, w2, w3 -> their Poisson uniforms.
struct JumpDraws {
  float zj[2], n[2];
};

__device__ __forceinline__ JumpDraws jump_draws(uint32_t slot, uint32_t index,
                                                uint32_t global_tile, uint64_t seed,
                                                const DualT& k) {
  const Words w = draw(slot, index, global_tile, seed);
  JumpDraws j;
  box_muller_stream(w.x, w.y, j.zj[0], j.zj[1]);
  j.n[0] = poisson_count(uniform_from_bits(w.z), k);
  j.n[1] = poisson_count(uniform_from_bits(w.w), k);
  return j;
}

// The standard Gamma(a) clock draw of inner pair ``pair`` at ``date``
// (ops/philox.dual_gamma_draws): attempt a is the call (slot, (date half +
// pair) kMaxAttempts + a, global tile, 5), decided by csrc/gamma.cuh;
// ``attempt`` the accepting attempt, or kMaxAttempts with the value d.
__device__ __forceinline__ float gamma_draw(uint32_t slot, int date, int half, int pair,
                                            uint32_t global_tile, uint64_t seed, const DualT& k,
                                            int& attempt) {
  const GammaK gk{k.gamma_d, k.gamma_c, k.gamma_inv_a, k.gamma_boost != 0.0f};
  const uint32_t base = (static_cast<uint32_t>(date) * static_cast<uint32_t>(half) +
                         static_cast<uint32_t>(pair)) * static_cast<uint32_t>(kMaxAttempts);
#pragma unroll 1
  for (int a = 0; a < kMaxAttempts; ++a) {
    const Words w = philox4x32_10(Words{slot, base + static_cast<uint32_t>(a), global_tile,
                                        kGammaStream},
                                  static_cast<uint32_t>(seed), static_cast<uint32_t>(seed >> 32));
    float g;
    if (gamma::mt_words(w, gk, g)) {
      attempt = a;
      return gk.boost ? gamma::boosted(g, w.w, gk) : g;
    }
  }
  attempt = kMaxAttempts;
  return gk.d;
}

// Walk the inner pairs of one (date, path) in the stream's order, calling
// fn(pair, states, count) for each (ops/philox.dual_inner_draws' layout);
// the count is the pair's Poisson count, or under VG its clock's accepting
// attempt.
template <int F, typename Fn>
__device__ __forceinline__ void walk_pairs(const PathK& s, int date, int half, uint32_t slot,
                                           uint32_t global_tile, uint64_t seed, const DualT& k,
                                           Fn&& fn) {
  constexpr int per = kPairsACall<F>;
  const int diff = (half + per - 1) / per;
  const int calls = diff + (half + 1) / 2;  // the jump calls counted in every family
  const uint32_t base = static_cast<uint32_t>(date) * static_cast<uint32_t>(calls);
#pragma unroll 1
  for (int c = 0; c < diff; ++c) {
    const Words w = draw(slot, base + c, global_tile, seed);
    float n[4];
    box_muller_stream(w.x, w.y, n[0], n[1]);
    box_muller_stream(w.z, w.w, n[2], n[3]);
    if (per == 4) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int pair = 4 * c + 2 * h;
        if (pair >= half) break;
        JumpDraws j{{0.0f, 0.0f}, {0.0f, 0.0f}};
        if (kJumps<F>) j = jump_draws(slot, base + diff + pair / 2, global_tile, seed, k);
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          if (pair + q >= half) break;
          float gam = 0.0f, count = j.n[q];
          if (F == kVg) {
            int att;
            gam = gamma_draw(slot, date, half, pair + q, global_tile, seed, k, att);
            count = static_cast<float>(att);
          }
          fn(pair + q, step_pair<F>(s, n[2 * h + q], 0.0f, 0.0f, gam, j.n[q], j.zj[q], k),
             count);
        }
      }
    } else if (per == 2) {
      const int pair = 2 * c;
      JumpDraws j{{0.0f, 0.0f}, {0.0f, 0.0f}};
      if (kJumps<F>) j = jump_draws(slot, base + diff + c, global_tile, seed, k);
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        if (pair + q >= half) break;
        fn(pair + q,
           step_pair<F>(s, n[2 * q], n[2 * q + 1], 0.0f, 0.0f, j.n[q], j.zj[q], k), j.n[q]);
      }
    } else {
      fn(c, step_pair<F>(s, n[0], n[1], n[2], 0.0f, 0.0f, 0.0f, k), 0.0f);
    }
  }
}

// Kernel 18's redesign. N(cp d) = erfc(s d) / 2 with s = -cp / sqrt 2: the
// side's sign and 1 / sqrt 2 are folded into the floor's arguments.
template <bool kCall>
constexpr float kSide = kCall ? -0.70710678118654752f : 0.70710678118654752f;

// A date's constants of the redesign, folded once a block by its first
// thread. The floor is E = c1 x' erfc(g1) - c2 erfc(g2) with c1 = cp K
// e^{-q tau} / 2 and c2 = cp K e^{-r tau} / 2. GBM and Merton: g1 = s d1 =
// b (log xp + e) + a0 and g2 = g1 + g. Heston and Bates: w = sigma^2 tau =
// max(v' frac + tf, 1e-8) tau + jtau, q = s (log xp + e + p0), g1 = (q + s
// w / 2) / sqrt w, g2 = (q - s w / 2) / sqrt w. u = x' x_rstd + nmr, w_v =
// v' v_rstd + nvr.
struct FloorT {
  float c1, c2, b, a0, g, p0, tf, frac, tau, jtau, nmr, nvr;
};

template <int F, bool kCall>
__device__ FloorT floor_consts(const float* row, const DualT& k) {
  constexpr float sd = kSide<kCall>;
  const float tau = row[0];
  const float half_cp = kCall ? 0.5f : -0.5f;
  FloorT f{};
  f.c1 = half_cp * k.K * expf(-k.q * tau);
  f.c2 = half_cp * k.K * expf(-k.rate * tau);
  f.tau = tau;
  f.nmr = -row[1] * row[2];
  f.nvr = -row[3] * row[4];
  if (kUseV<F>) {
    if (F == kRBergomi) {
      f.tf = 0.5f * k.xi0;  // the floor's variance (v' + xi0) / 2
    } else if (F != kSabr) {
      const float kt = fmaxf(k.kappa * tau, 1e-6f);
      f.frac = -expm1f(-kt) / kt;
      f.tf = k.theta * (1.0f - f.frac);
    }
    f.p0 = k.drift * tau;
    f.jtau = k.jvar * tau;
  } else {
    const float sq = k.sig_f * sqrtf(tau);
    f.b = sd / sq;
    f.a0 = f.b * fmaf(0.5f * k.sig_f, k.sig_f, k.drift) * tau;
    f.g = -sd * sq;
  }
  return f;
}

// Horner's rule over the betas beta[0..degree] in shared memory, one
// multiply-add a pass (not unrolled: at the brackets' degree 3 an unrolled
// loop would run only its remainder, and the SASS holds one pass to count).
__device__ __forceinline__ float poly(const float* beta, int degree, float u) {
  float c = beta[degree];
#pragma unroll 1
  for (int i = degree - 1; i >= 0; --i) c = fmaf(c, u, beta[i]);
  return c;
}

// _vhat at one member x' = xp e^e (and v'): max(E, the clipped continuation
// on the in-the-money side). a is the thread's b log xp + a0 (GBM, Merton)
// or s (log xp + p0) (Heston, Bates). beta is the row's betas in shared
// memory; t = beta + degree + 1 their tail: the (x' - 1)^+ term, then the
// variance terms w, w^2 and u w. max(h, clip(C, 0, cap)) is clip(C, h,
// cap), as 0 <= h <= cap; off the in-the-money side h = 0, and a cap of 0
// there makes the clip 0 without a branch. vhat_from takes the floor's
// arguments g1 = s d1 and g2 = s d2 (the SABR redesign forms its own).
template <int F, bool kCall>
__device__ __forceinline__ float vhat_from(float xq, float g1, float g2, float vq,
                                           const FloorT& f, const float* beta, int degree,
                                           float rho, float vr, const DualT& k) {
  const float floor = fmaf(f.c1 * xq, erfcf(g1), -(f.c2 * erfcf(g2)));
  const float u = clampf(fmaf(xq, rho, f.nmr), -kUClamp, kUClamp);
  const float xm1 = xq - 1.0f;
  const float* t = beta + degree + 1;
  float c = fmaf(t[0], fmaxf(xm1, 0.0f), poly(beta, degree, u));
  if (kUseV<F>) {
    const float w = clampf(fmaf(vq, vr, f.nvr), -kUClamp, kUClamp);
    c = fmaf(w, fmaf(t[2], w, fmaf(t[3], u, t[1])), c);
  }
  const float h = k.K * fmaxf(kCall ? xm1 : -xm1, 0.0f);
  const bool itm = kCall ? xm1 >= 0.0f : xm1 <= 0.0f;
  const float cap = itm ? (kCall ? k.K * xq : k.K) : 0.0f;
  return fmaxf(floor, fminf(fmaxf(c, h), cap));
}

template <int F, bool kCall>
__device__ __forceinline__ float vhat_fast(float xq, float e, float vq, float a,
                                           const FloorT& f, const float* beta, int degree,
                                           float rho, float vr, const DualT& k) {
  constexpr float sd = kSide<kCall>;
  float g1, g2;
  if (kUseV<F>) {
    // the floor's sigma^2: Heston's effective variance, SABR's alpha'^2,
    // rough Bergomi's (v' + xi0) / 2
    const float var = F == kSabr       ? vq * vq
                      : F == kRBergomi ? fmaf(vq, 0.5f, f.tf)
                                       : fmaxf(fmaf(vq, f.frac, f.tf), 1e-8f);
    const float w = kJumps<F> ? fmaf(var, f.tau, f.jtau) : var * f.tau;
    const float r = rsqrtf(w);
    const float q = fmaf(sd, e, a);
    g1 = r * fmaf(0.5f * sd, w, q);
    g2 = r * fmaf(-0.5f * sd, w, q);
  } else {
    g1 = fmaf(f.b, e, a);
    g2 = g1 + f.g;
  }
  return vhat_from<F, kCall>(xq, g1, g2, vq, f, beta, degree, rho, vr, k);
}

// Resident blocks an SM the redesign asks of nvcc: GBM 16 (at most 32
// registers, 100% occupancy), Heston 10 (48, 62.5%), Merton 12 (40, 75%),
// Bates 9 (56, 56.2%), none below the first design's. Left to itself nvcc
// interleaves the clip's arithmetic over both members and takes up to 76
// registers. The first designs of VG, SABR and rough Bergomi (this
// kernel's instances for them) 8 (64, 50%); their redesigns,
// dual_ce_vg_kernel, dual_ce_sabr_kernel and dual_ce_rough_kernel below,
// take their own.
// chip_smoke.py fails if any instance spills under its bound.
template <int F>
constexpr int kMinBlocks = F == kGbm      ? 16
                           : F == kHeston ? 10
                           : F == kMerton ? 12
                           : F == kBates  ? 9
                                          : 8;

template <int F, bool kCall>
__global__ void __launch_bounds__(kBlock, kMinBlocks<F>)
dual_ce_kernel(float* __restrict__ ce, const float* __restrict__ x, const float* __restrict__ v,
               const float* __restrict__ hist, const float* __restrict__ comp,
               const float* __restrict__ rows, const __grid_constant__ DualT k, uint64_t seed,
               int first_tile, int tile, int n_paths, int width, int degree, int half) {
  __shared__ float row[kMaxRow];
  __shared__ FloorT fs;
  const int date = blockIdx.y;
  for (int i = threadIdx.x; i < width; i += blockDim.x) {
    row[i] = rows[static_cast<size_t>(date) * width + i];
  }
  __syncthreads();
  if (threadIdx.x == 0) fs = floor_consts<F, kCall>(row, k);
  __syncthreads();
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n_paths) return;
  const size_t at = static_cast<size_t>(date) * n_paths + p;
  const bool rough = F == kRBergomi;
  const PathK s = path_consts<F>(x[at], kUseV<F> ? v[at] : 0.0f, rough ? hist[at] : 0.0f,
                                 rough ? comp[date] : 0.0f, k);
  const FloorT f = fs;
  const float* beta = row + kRowHead;
  const float rho = row[2], vr = row[4];
  const float lxp = logf(s.xp);
  const float a = kUseV<F> ? kSide<kCall> * (lxp + f.p0) : fmaf(f.b, lxp, f.a0);
  float acc = 0.0f;
  walk_pairs<F>(s, date, half, static_cast<uint32_t>(p % tile),
                static_cast<uint32_t>(first_tile + p / tile), seed, k,
                [&](int, const Pair& st, float) {
                  acc += vhat_fast<F, kCall>(st.xu, st.eu, st.vu, a, f, beta, degree, rho, vr, k) +
                         vhat_fast<F, kCall>(st.xd, st.ed, st.vd, a, f, beta, degree, rho, vr, k);
                });
  ce[at] = acc / static_cast<float>(half) * 0.5f;
}

// The redesigns of the VG and rough Bergomi families draw their Philox
// calls with the round keys computed once a launch (csrc/hopper_fast.cuh,
// the same words).
__device__ __forceinline__ Words keyed(uint32_t slot, uint32_t index, uint32_t global_tile,
                                       uint32_t stream, const fast::PhiloxKeys& keys) {
  return fast::philox_keyed(Words{slot, index, global_tile, stream}, keys);
}

// Kernel 18's VG redesign: a warp draws its lanes' clock kClockChunk pairs a
// lane at a time (two diffusion calls' worth), entry e = i 32 + lane being
// pair c0 + i of the lane's (date, path); csrc/gamma.cuh WarpClock, 5 KB a
// warp.
constexpr int kClockChunk = 8;
constexpr int kClockEntries = 32 * kClockChunk;
// Resident blocks an SM: 10 (at most 48 registers, 62.5%), which 20.5 KB of
// shared memory a block also allows.
constexpr int kMinBlocksVg = 10;

// One (date, path) a thread, the grid and outputs of dual_ce_kernel. For
// each chunk of pairs the warp draws attempt 0 of every lane's pairs,
// dense, decided by the squeeze; the exact test of the rest, a lane an
// entry; the retries from the warp's ring (attempts 1-14, then d); then each
// lane walks its chunk's pairs from the clock in shared memory: the boost,
// G = nu gamma, sqrt_clock, the plain version's _rn step and expf, and
// vhat_fast at both members. With kDebug, each pair's G and accepting
// attempt (n_dates, half, P) and each warp's passes of the exact tests and
// of the retries (n_dates, ceil(P / 32), 2).
template <bool kCall, bool kDebug>
__global__ void __launch_bounds__(kBlock, kMinBlocksVg)
dual_ce_vg_kernel(float* __restrict__ ce, float* __restrict__ gs, int* __restrict__ atts,
                  int* __restrict__ passes, const float* __restrict__ x,
                  const float* __restrict__ rows, const __grid_constant__ DualT k,
                  const __grid_constant__ fast::PhiloxKeys keys, int first_tile, int tile,
                  int n_paths, int width, int degree, int half) {
  __shared__ float row[kMaxRow];
  __shared__ FloorT fs;
  __shared__ gamma::WarpClock<kClockEntries> clocks[kBlock / 32];
  const int date = blockIdx.y;
  for (int i = threadIdx.x; i < width; i += blockDim.x) {
    row[i] = rows[static_cast<size_t>(date) * width + i];
  }
  __syncthreads();
  if (threadIdx.x == 0) fs = floor_consts<kVg, kCall>(row, k);
  __syncthreads();
  // no early return: a lane past the last path draws nothing, but takes
  // part in its warp's ballots
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = p < n_paths;
  const int lane = static_cast<int>(threadIdx.x & 31u);
  const int p0 = p - lane;
  gamma::WarpClock<kClockEntries>& sh = clocks[threadIdx.x >> 5];
  const uint32_t slot = static_cast<uint32_t>(p % tile);
  const uint32_t global_tile = static_cast<uint32_t>(first_tile + p / tile);
  const size_t at = static_cast<size_t>(date) * n_paths + p;
  const float xp = live ? x[at] : 1.0f;
  const FloorT f = fs;
  const float* beta = row + kRowHead;
  const float rho = row[2], vr = row[4];
  const float a = fmaf(f.b, logf(xp), f.a0);
  const GammaK gk{k.gamma_d, k.gamma_c, k.gamma_inv_a, k.gamma_boost != 0.0f};
  const float one_m = gamma::squeeze_one(gk.d);
  // the normals' calls of the date (walk_pairs' layout) and its clock pairs
  const uint32_t normals = static_cast<uint32_t>(date) *
                           static_cast<uint32_t>((half + 3) / 4 + (half + 1) / 2);
  const uint32_t pairs = static_cast<uint32_t>(date) * static_cast<uint32_t>(half);
  float acc = 0.0f;
  unsigned int n_exact = 0u, n_retry = 0u;
#pragma unroll 1
  for (int c0 = 0; c0 < half; c0 += kClockChunk) {
    const int cs = min(kClockChunk, half - c0);
    // attempt att of entry e (the counter of dual_gamma_draws)
    auto words = [&](int e, uint32_t att) {
      const int q = p0 + (e & 31);
      return keyed(static_cast<uint32_t>(q % tile),
                   (pairs + static_cast<uint32_t>(c0 + (e >> 5))) * kMaxAttempts + att,
                   static_cast<uint32_t>(first_tile + q / tile), kGammaStream, keys);
    };
    unsigned int pushed = 0u;  // the same in every lane
#pragma unroll 1
    for (int i = 0; i < cs; ++i) {
      gamma::clock_first(sh, i * 32 + lane,
                         keyed(slot, (pairs + static_cast<uint32_t>(c0 + i)) * kMaxAttempts,
                               global_tile, kGammaStream, keys),
                         live, gk, one_m, pushed);
    }
    __syncwarp();
    const unsigned int tail = gamma::clock_exact(sh, pushed, gk, n_exact);
    __syncwarp();
    gamma::clock_retries(sh, tail, gk, one_m, words, n_retry);
    if (live) {
#pragma unroll 1
      for (int j = 0; j < cs; j += 4) {
        const Words w = keyed(slot, normals + static_cast<uint32_t>((c0 + j) / 4), global_tile,
                              kDualStream, keys);
        float n[4];
        box_muller_stream(w.x, w.y, n[0], n[1]);
        box_muller_stream(w.z, w.w, n[2], n[3]);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (j + q >= cs) break;
          const int e = (j + q) * 32 + lane;
          const uint32_t tag = sh.tag[e];
          const float G = mul(k.nu, gamma::clock_gamma(sh.g[e], tag, gk));
          const float tb = mul(k.vg_theta, G);
          const float tn = mul(mul(k.vg_sigma, gamma::sqrt_clock(G)), n[q]);
          const float eu = add(add(k.mu, tb), tn), ed = sub(add(k.mu, tb), tn);
          acc += vhat_fast<kVg, kCall>(mul(xp, expf(eu)), eu, 0.0f, a, f, beta, degree, rho, vr,
                                       k) +
                 vhat_fast<kVg, kCall>(mul(xp, expf(ed)), ed, 0.0f, a, f, beta, degree, rho, vr,
                                       k);
          if (kDebug) {
            const size_t i = (static_cast<size_t>(date) * half + c0 + j + q) * n_paths + p;
            gs[i] = G;
            atts[i] = static_cast<int>(tag & kAttemptBits);
          }
        }
      }
    }
    __syncwarp();  // the next chunk writes the entries this walk read
  }
  if (kDebug && lane == 0 && p0 < n_paths) {
    int* out = passes + (static_cast<size_t>(date) * ((n_paths + 31) / 32) + p0 / 32) * 2;
    out[0] = static_cast<int>(n_exact);
    out[1] = static_cast<int>(n_retry);
  }
  if (live) ce[at] = acc / static_cast<float>(half) * 0.5f;
}

__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Kernel 18's rough Bergomi redesign: resident blocks an SM, 10 (at most 48
// registers, 62.5%).
constexpr int kMinBlocksRough = 10;

// One (date, path) a thread, the grid and outputs of dual_ce_kernel. The
// pair mirrors z1, z2 and zp, so the down member's products are the up
// member's negated exactly (_rn rounds both signs alike): the step forms p
// = sv (rho du + rbsd zp) once, x'_up = xp e^{mu + p} and x'_down = xp
// e^{mu - p} with the plain version's _rn operations and expf, bit for bit
// (the in-the-money gate decides on x'). v' = xi0 e^{eta Y' - comp}, Y' = h
// +- sqrt(2H) (c1 du + c2 z2), is A e^{+-s}: A = xi0 e^{eta h - comp} once a
// (date, path) (expf), s = eta sqrt(2H) (c1 sqrt(dt) z1 + c2 z2) with the
// constants folded and log2 e taken in, e^s by ex2.approx and e^-s by
// rcp.approx. v' enters only the floor's variance (v' + xi0) / 2 and the
// polynomial's w terms, both continuous. Its budget, u0 = 2^-24: A within
// u0 (3 + |eta h - comp|) of its value, e^s within u0 (7 |s| + 4) (five
// roundings of the folded constants and two of the multiply-add; ex2's 2
// ulp), e^-s 2 u0 more (rcp's ulp), the products u0; the plain version's
// own v' within u0 (3 + 3 (|eta h| + |comp| + |s|)) of the exact value. So
// the two v' differ by at most delta = u0 (13 + 4 |eta h - comp| + 10 |s|)
// relative, under 1e-5 wherever |eta h - comp| <= 10 and |s| <= 6 (the
// brackets' histories and normals). A member's floor moves by vega sigma
// delta / 2 at most (sigma^2 = (v' + xi0) / 2, vega < K sqrt(tau / 2 pi)),
// the clamped w terms by |beta| v_rstd v' delta; ce, the mean over the
// pairs, shares only A's part of delta across them. chip_smoke.py holds v'
// at 1e-5 through the debug instance and ce at DUAL_CE_ATOL = 1e-4, as it
// holds the floor. With kDebug, each pair's x' and v' (n_dates, 2, half,
// P), up member first.
template <bool kCall, bool kDebug>
__global__ void __launch_bounds__(kBlock, kMinBlocksRough)
dual_ce_rough_kernel(float* __restrict__ ce, float* __restrict__ xs, float* __restrict__ vs,
                     const float* __restrict__ x, const float* __restrict__ v,
                     const float* __restrict__ hist, const float* __restrict__ comp,
                     const float* __restrict__ rows, const __grid_constant__ DualT k,
                     const __grid_constant__ fast::PhiloxKeys keys, int first_tile, int tile,
                     int n_paths, int width, int degree, int half) {
  __shared__ float row[kMaxRow];
  __shared__ FloorT fs;
  const int date = blockIdx.y;
  for (int i = threadIdx.x; i < width; i += blockDim.x) {
    row[i] = rows[static_cast<size_t>(date) * width + i];
  }
  __syncthreads();
  if (threadIdx.x == 0) fs = floor_consts<kRBergomi, kCall>(row, k);
  __syncthreads();
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n_paths) return;
  const size_t at = static_cast<size_t>(date) * n_paths + p;
  const float xp = x[at], vp = v[at];
  const float sv = sqrtf(fmaxf(vp, 0.0f));
  const float mu = mul(sub(k.drift, mul(0.5f, vp)), k.dt);
  const float A = k.xi0 * expf(fmaf(k.eta, hist[at], -comp[date]));
  const float ks = fast::kLog2e * k.eta * k.sqrt2H;
  const float k1 = ks * k.c1 * k.sqrt_dt, k2 = ks * k.c2;
  const FloorT f = fs;
  const float* beta = row + kRowHead;
  const float rho = row[2], vr = row[4];
  const float a = kSide<kCall> * (logf(xp) + f.p0);
  const uint32_t slot = static_cast<uint32_t>(p % tile);
  const uint32_t global_tile = static_cast<uint32_t>(first_tile + p / tile);
  const uint32_t base = static_cast<uint32_t>(date) * static_cast<uint32_t>(half + (half + 1) / 2);
  float acc = 0.0f;
#pragma unroll 1
  for (int c = 0; c < half; ++c) {
    const Words w = keyed(slot, base + static_cast<uint32_t>(c), global_tile, kDualStream, keys);
    float z1, z2, zp, unused;
    box_muller_stream(w.x, w.y, z1, z2);
    box_muller_stream(w.z, w.w, zp, unused);
    const float pr = mul(sv, add(mul(k.rho, mul(k.sqrt_dt, z1)), mul(k.rbsd, zp)));
    const float eu = add(mu, pr), ed = sub(mu, pr);
    const float xu = mul(xp, expf(eu)), xd = mul(xp, expf(ed));
    const float es = fast::ex2_approx(fmaf(k1, z1, k2 * z2));
    const float vu = A * es, vd = A * rcp_approx(es);
    acc += vhat_fast<kRBergomi, kCall>(xu, eu, vu, a, f, beta, degree, rho, vr, k) +
           vhat_fast<kRBergomi, kCall>(xd, ed, vd, a, f, beta, degree, rho, vr, k);
    if (kDebug) {
      const size_t plane = static_cast<size_t>(half) * n_paths;
      const size_t i = static_cast<size_t>(date) * 2 * plane + static_cast<size_t>(c) * n_paths + p;
      xs[i] = xu;
      xs[i + plane] = xd;
      vs[i] = vu;
      vs[i + plane] = vd;
    }
  }
  ce[at] = acc / static_cast<float>(half) * 0.5f;
}

// Kernel 18's SABR redesign: resident blocks an SM, 10 (at most 48
// registers, 62.5%).
constexpr int kMinBlocksSabr = 10;

// One (date, path) a thread, the grid and outputs of dual_ce_kernel; a
// Philox call (the round keys once a launch) serves two pairs, as in
// walk_pairs. The pair mirrors z1 and z2: the step forms p = sv z1 once,
// x'_up = xp e^{mu + p} and x'_down = xp e^{mu - p} with the plain
// version's _rn operations and expf, bit for bit (add(mu, mul(sv, -z1)) is
// sub(mu, mul(sv, z1)): negation is exact and _rn rounds both signs
// alike). alpha' = vp e^{+-nu sqrt(dt) w2 - nu^2 dt / 2} is A e^{+-s}: A =
// vp e^{-nu^2 dt / 2} once a (date, path) (expf), s = nu sqrt(dt) (rho z1 +
// rho_bar z2) with log2 e folded into the two constants, e^s by ex2.approx
// and e^-s by rcp.approx. Under SABR the floor's vol is alpha', so its
// sigma' sqrt(tau) is m = (A sqrt tau) e^{+-s} and 1 / m = (1 / (A sqrt
// tau)) e^{-+s}, both once a (date, path) then a multiply: g1 = q / m +
// s_d m / 2, g2 = q / m - s_d m / 2 (vhat_fast's without the square, the
// product by tau and the rsqrtf). alpha' enters only that floor and the
// polynomial's clamped w terms, both continuous. Its budget, u0 = 2^-24, B
// = nu sqrt(dt) (|rho z1| + |rho_bar z2|) >= |s|, h = nu^2 dt / 2: A within
// 5 u0 of its value (expf's 2 ulp, one product); the exponent s log2 e
// within u0 (4 B + |s|) <= 5 u0 B (three roundings of each folded
// constant, the product and the multiply-add), e^s within u0 (5 B + 4)
// (ex2's 2 ulp), e^-s 2 u0 more (rcp's ulp), the product u0; the plain
// version's alpha' within u0 (5 B + h + 5) of the exact value (its w2's
// three roundings and the product's, the subtraction's, expf's, the
// product's). So the two alpha' differ by at most delta = u0 (17 + 10 B +
// h) relative: 1.31e-6 at D7's nu = 0.6, dt = 0.0125 and |z| <= 5.65 (the
// stream's Box-Muller radius at 1 - u >= 2^-23; B <= 0.50), under 1e-5
// wherever B <= 15. A
// member's floor moves by vega alpha' delta at most, the clamped w terms by
// |beta| v_rstd alpha' delta. chip_smoke.py holds alpha' at
// SABR_APRIME_RTOL = 1e-5 through the debug instance and ce at DUAL_CE_ATOL
// = 1e-4, as it holds the floor. With kDebug, each pair's x' and alpha'
// (n_dates, 2, half, P), up member first.
template <bool kCall, bool kDebug>
__global__ void __launch_bounds__(kBlock, kMinBlocksSabr)
dual_ce_sabr_kernel(float* __restrict__ ce, float* __restrict__ xs, float* __restrict__ vs,
                    const float* __restrict__ x, const float* __restrict__ v,
                    const float* __restrict__ rows, const __grid_constant__ DualT k,
                    const __grid_constant__ fast::PhiloxKeys keys, int first_tile, int tile,
                    int n_paths, int width, int degree, int half) {
  __shared__ float row[kMaxRow];
  __shared__ FloorT fs;
  const int date = blockIdx.y;
  for (int i = threadIdx.x; i < width; i += blockDim.x) {
    row[i] = rows[static_cast<size_t>(date) * width + i];
  }
  __syncthreads();
  if (threadIdx.x == 0) fs = floor_consts<kSabr, kCall>(row, k);
  __syncthreads();
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n_paths) return;
  const size_t at = static_cast<size_t>(date) * n_paths + p;
  const float xp = x[at], vp = v[at];
  const float sv = mul(vp, k.sqrt_dt);
  const float mu = mul(sub(k.drift, mul(0.5f, mul(vp, vp))), k.dt);
  const FloorT f = fs;
  const float A = vp * expf(-k.half_nu2_dt);
  const float m0 = A * sqrtf(f.tau), r0 = 1.0f / m0;
  const float ks = fast::kLog2e * k.nu_sqrt_dt;
  const float k1 = ks * k.rho, k2 = ks * k.rho_bar;
  const float* beta = row + kRowHead;
  const float rho = row[2], vr = row[4];
  constexpr float sd = kSide<kCall>;
  const float a = sd * (logf(xp) + f.p0);
  const uint32_t slot = static_cast<uint32_t>(p % tile);
  const uint32_t global_tile = static_cast<uint32_t>(first_tile + p / tile);
  const int calls = (half + 1) / 2;
  const uint32_t base = static_cast<uint32_t>(date) * static_cast<uint32_t>(2 * calls);
  // a member's surrogate at x' = xp e^e, alpha', its m and 1 / m
  auto member = [&](float xq, float e, float aq, float m, float r) {
    const float q = fmaf(sd, e, a);
    return vhat_from<kSabr, kCall>(xq, fmaf(q, r, 0.5f * sd * m), fmaf(q, r, -0.5f * sd * m),
                                   aq, f, beta, degree, rho, vr, k);
  };
  float acc = 0.0f;
#pragma unroll 1
  for (int c = 0; c < calls; ++c) {
    const Words w = keyed(slot, base + static_cast<uint32_t>(c), global_tile, kDualStream, keys);
    float n[4];
    box_muller_stream(w.x, w.y, n[0], n[1]);
    box_muller_stream(w.z, w.w, n[2], n[3]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int pair = 2 * c + h;
      if (pair >= half) break;
      const float z1 = n[2 * h], z2 = n[2 * h + 1];
      const float pr = mul(sv, z1);
      const float eu = add(mu, pr), ed = sub(mu, pr);
      const float xu = mul(xp, expf(eu)), xd = mul(xp, expf(ed));
      const float es = fast::ex2_approx(fmaf(k1, z1, k2 * z2)), ei = rcp_approx(es);
      const float au = A * es, ad = A * ei;
      acc += member(xu, eu, au, m0 * es, r0 * ei) + member(xd, ed, ad, m0 * ei, r0 * es);
      if (kDebug) {
        const size_t plane = static_cast<size_t>(half) * n_paths;
        const size_t i =
            static_cast<size_t>(date) * 2 * plane + static_cast<size_t>(pair) * n_paths + p;
        xs[i] = xu;
        xs[i + plane] = xd;
        vs[i] = au;
        vs[i + plane] = ad;
      }
    }
  }
  ce[at] = acc / static_cast<float>(half) * 0.5f;
}

// Kernel 18's first design: the surrogate in the plain version's _rn order.
template <int F>
__global__ void __launch_bounds__(kBlock)
dual_ce_first_kernel(float* __restrict__ ce, const float* __restrict__ x,
                     const float* __restrict__ v, const float* __restrict__ rows,
                     const __grid_constant__ DualT k, uint64_t seed, int first_tile, int tile,
                     int n_paths, int width, int degree, int half) {
  __shared__ float row[kMaxRow];
  const int date = blockIdx.y;
  for (int i = threadIdx.x; i < width; i += blockDim.x) {
    row[i] = rows[static_cast<size_t>(date) * width + i];
  }
  __syncthreads();
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n_paths) return;
  const size_t at = static_cast<size_t>(date) * n_paths + p;
  const PathK s = path_consts<F>(x[at], kUseV<F> ? v[at] : 0.0f, 0.0f, 0.0f, k);
  const DateK d = date_consts(row[0], k);
  const float sig_f = k.sig_f;
  float acc = 0.0f;
  walk_pairs<F>(s, date, half, static_cast<uint32_t>(p % tile),
                static_cast<uint32_t>(first_tile + p / tile), seed, k,
                [&](int, const Pair& st, float) {
                  const float su = kUseV<F> ? floor_vol(st.vu, d, k) : sig_f;
                  const float sd = kUseV<F> ? floor_vol(st.vd, d, k) : sig_f;
                  acc = add(acc, add(vhat<kUseV<F>>(st.xu, st.vu, su, row, degree, d, k),
                                     vhat<kUseV<F>>(st.xd, st.vd, sd, row, degree, d, k)));
                });
  ce[at] = mul(dvd(acc, static_cast<float>(half)), 0.5f);
}

template <int F, bool kCounts>
__global__ void __launch_bounds__(kBlock)
dual_inner_states_kernel(float* __restrict__ xs, float* __restrict__ vs, int* __restrict__ counts,
                         const float* __restrict__ x, const float* __restrict__ v,
                         const float* __restrict__ hist, const float* __restrict__ comp,
                         const __grid_constant__ DualT k, uint64_t seed, int first_tile, int tile,
                         int n_paths, int date0, int half) {
  const int local = blockIdx.y;
  const int date = date0 + local;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n_paths) return;
  const size_t at = static_cast<size_t>(date) * n_paths + p;
  const bool rough = F == kRBergomi;
  const PathK s = path_consts<F>(x[at], kUseV<F> ? v[at] : 0.0f, rough ? hist[at] : 0.0f,
                                 rough ? comp[date] : 0.0f, k);
  const size_t plane = static_cast<size_t>(half) * n_paths;
  float* xo = xs + static_cast<size_t>(local) * 2 * plane + p;
  float* vo = kStateV<F> ? vs + static_cast<size_t>(local) * 2 * plane + p : nullptr;
  int* co = kCounts ? counts + static_cast<size_t>(local) * plane + p : nullptr;
  walk_pairs<F>(s, date, half, static_cast<uint32_t>(p % tile),
                static_cast<uint32_t>(first_tile + p / tile), seed, k,
                [&](int pair, const Pair& st, float n) {
                  const size_t i = static_cast<size_t>(pair) * n_paths;
                  xo[i] = st.xu;
                  xo[plane + i] = st.xd;
                  if (kStateV<F>) {
                    vo[i] = st.vu;
                    vo[plane + i] = st.vd;
                  }
                  if (kCounts) co[i] = static_cast<int>(n);
                });
}

// One-step Black E[h(x') | x] for x' = x exp(mu + a Z) (pricers/dual.
// _one_step_black), cp the side.
__device__ __forceinline__ float one_step_black(float x, float mu, float a, float cp) {
  const float d2 = dvd(add(logf(x), mu), a);
  const float d1 = add(d2, a);
  const float fwd = mul(x, expf(add(mu, mul(mul(0.5f, a), a))));
  if (cp > 0.0f) return sub(mul(fwd, ndtr(d1)), ndtr(d2));
  return sub(ndtr(-d2), mul(fwd, ndtr(-d1)));
}

// VG's terminal step: e_h = K mean_i Black(x_{n-1}, mu + theta G_i, sigma
// sqrt(max(G_i, 1e-20))) over the path's half clock draws G_i = nu gamma_i
// at date ``date`` (n_dates), one thread a path.
__global__ void __launch_bounds__(kBlock)
dual_vg_terminal_kernel(float* __restrict__ e_h, const float* __restrict__ x_last,
                        const __grid_constant__ DualT k, uint64_t seed, int first_tile, int tile,
                        int n_paths, int date, int half) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n_paths) return;
  const uint32_t slot = static_cast<uint32_t>(p % tile);
  const uint32_t global_tile = static_cast<uint32_t>(first_tile + p / tile);
  const float x = x_last[p];
  float acc = 0.0f;
#pragma unroll 1
  for (int i = 0; i < half; ++i) {
    int att;
    const float G = mul(k.nu, gamma_draw(slot, date, half, i, global_tile, seed, k, att));
    acc = add(acc, one_step_black(x, add(k.mu, mul(k.vg_theta, G)),
                                  mul(k.vg_sigma, sqrtf(fmaxf(G, 1e-20f))), k.cp));
  }
  e_h[p] = mul(k.K, dvd(acc, static_cast<float>(half)));
}

// The Black value of VG's terminal step at one clock G, up to its factor cp
// / 2: fwd erfc(g1) - erfc(g2), g = s d with s = -cp / sqrt 2 (kSide), d2 =
// (log x + mu) / a, d1 = d2 + a, fwd = x e^{mu + a^2 / 2}; mu = mu0 + theta
// G and a = sigma sqrt(max(G, 1e-20)) in the plain version's _rn
// operations, log x the path's, 1 / a by rcp.approx.
template <bool kCall>
__device__ __forceinline__ float terminal_black(float x, float lx, float G, const DualT& k) {
  constexpr float sd = kSide<kCall>;
  const float mu = add(k.mu, mul(k.vg_theta, G));
  const float a = mul(k.vg_sigma, sqrtf(fmaxf(G, 1e-20f)));
  const float g2 = (lx + mu) * (sd * rcp_approx(a));
  const float fwd = x * expf(fmaf(0.5f * a, a, mu));
  return fmaf(fwd, erfcf(fmaf(sd, a, g2)), -erfcf(g2));
}

// VG's terminal redesign: resident blocks an SM, 10 (at most 48 registers,
// 62.5%), which its 20 KB of warp clocks a block also allows.
constexpr int kMinBlocksTerminal = 10;

// The paths a warp of the terminal redesign owns at ``half`` draws a path:
// as many whole paths as a chunk of kClockEntries holds, 1 to 32.
inline int terminal_per_warp(int half) {
  return std::min(32, std::max(1, kClockEntries / half));
}

// One entry a (path, clock draw) on csrc/gamma.cuh's WarpClock. A warp owns
// per_warp whole paths, lane l the path p0 + l (its x, log x once, its
// counters, its sum), and their entries q = l half + j (path p0 + l, draw
// j) in chunks of kClockEntries, entry e = i 32 + lane of a chunk being q
// = c0 + e. For each chunk the warp draws attempt 0 of every entry, dense,
// decided by the squeeze; the exact test of the rest, a lane an entry; the
// retries from the ring (attempts 1-14, then d); then the walk: each
// entry's clock (the boost), G = nu gamma, its Black value into the clock's
// g; then each path's lane adds its values in draw order. A path's sum runs
// over j = 0..half-1 in order wherever the path lies, so a first_tile chunk
// is the full launch's slice bit for bit. No lane returns early: every
// warp runs the chunks of per_warp paths (a trip count the compiler sees as
// the same in every lane, so the ballots and shuffles need no divergence
// fallback), and lanes past the warp's last entry join every ballot without
// drawing. e_h = K cp / 2 sum / half. With
// kDebug, each draw's G and accepting attempt (half, P) and each warp's
// passes of the exact tests and of the retries (ceil(P / per_warp), 2).
template <bool kCall, bool kDebug>
__global__ void __launch_bounds__(kBlock, kMinBlocksTerminal)
dual_vg_terminal_warp_kernel(float* __restrict__ e_h, float* __restrict__ gs,
                             int* __restrict__ atts, int* __restrict__ passes,
                             const float* __restrict__ x_last, const __grid_constant__ DualT k,
                             const __grid_constant__ fast::PhiloxKeys keys, int first_tile,
                             int tile, int n_paths, int date, int half, int per_warp) {
  __shared__ gamma::WarpClock<kClockEntries> clocks[kBlock / 32];
  const int lane = static_cast<int>(threadIdx.x & 31u);
  const int warp = static_cast<int>((blockIdx.x * blockDim.x + threadIdx.x) >> 5);
  const int p0 = warp * per_warp;
  const int n_live = max(min(per_warp, n_paths - p0), 0);
  gamma::WarpClock<kClockEntries>& sh = clocks[threadIdx.x >> 5];
  const bool owner = lane < n_live;
  const int p = p0 + lane;
  const float xp = owner ? x_last[p] : 1.0f;
  const float lx = logf(xp);
  const uint32_t slot = owner ? static_cast<uint32_t>(p % tile) : 0u;
  const uint32_t gtile = owner ? static_cast<uint32_t>(first_tile + p / tile) : 0u;
  const GammaK gk{k.gamma_d, k.gamma_c, k.gamma_inv_a, k.gamma_boost != 0.0f};
  const float one_m = gamma::squeeze_one(gk.d);
  const int n_entries = n_live * half, n_chunked = per_warp * half;
  // the lane of entry q's path: q < 1024, so (q + 1/2) / half rounds well
  // clear of an integer
  const float inv_half = 1.0f / static_cast<float>(half);
  auto lane_of = [&](int q) {
    return min(static_cast<int>((static_cast<float>(q) + 0.5f) * inv_half), 31);
  };
  // the clock's pairs of the date (dual_gamma_draws' counter)
  const uint32_t draws = static_cast<uint32_t>(date) * static_cast<uint32_t>(half);
  float acc = 0.0f;
  unsigned int n_exact = 0u, n_retry = 0u;
#pragma unroll 1
  for (int c0 = 0; c0 < n_chunked; c0 += kClockEntries) {
    const int cs = (min(kClockEntries, n_chunked - c0) + 31) / 32;
    const int len = max(min(kClockEntries, n_entries - c0), 0);
    // attempt att of entry e, from any lane
    auto words = [&](int e, uint32_t att) {
      const int q = c0 + e, l = lane_of(q), pp = p0 + l;
      return keyed(static_cast<uint32_t>(pp % tile),
                   (draws + static_cast<uint32_t>(q - l * half)) * kMaxAttempts + att,
                   static_cast<uint32_t>(first_tile + pp / tile), kGammaStream, keys);
    };
    unsigned int pushed = 0u;  // the same in every lane
#pragma unroll 1
    for (int i = 0; i < cs; ++i) {
      const int q = c0 + i * 32 + lane, l = lane_of(q);
      const uint32_t s = __shfl_sync(0xFFFFFFFFu, slot, l);
      const uint32_t g = __shfl_sync(0xFFFFFFFFu, gtile, l);
      gamma::clock_first(sh, i * 32 + lane,
                         keyed(s, (draws + static_cast<uint32_t>(q - l * half)) * kMaxAttempts,
                               g, kGammaStream, keys),
                         q < n_entries, gk, one_m, pushed);
    }
    __syncwarp();
    const unsigned int tail = gamma::clock_exact(sh, pushed, gk, n_exact);
    __syncwarp();
    gamma::clock_retries(sh, tail, gk, one_m, words, n_retry);
#pragma unroll 1
    for (int i = 0; i < cs; ++i) {
      const int e = i * 32 + lane, q = c0 + e, l = lane_of(q);
      const float xq = __shfl_sync(0xFFFFFFFFu, xp, l);
      const float lq = __shfl_sync(0xFFFFFFFFu, lx, l);
      if (q < n_entries) {
        const uint32_t tag = sh.tag[e];
        const float G = mul(k.nu, gamma::clock_gamma(sh.g[e], tag, gk));
        sh.g[e] = terminal_black<kCall>(xq, lq, G, k);
        if (kDebug) {
          const size_t o = static_cast<size_t>(q - l * half) * n_paths + p0 + l;
          gs[o] = G;
          atts[o] = static_cast<int>(tag & kAttemptBits);
        }
      }
    }
    __syncwarp();
    const int lo = max(lane * half - c0, 0);
    const int hi = owner ? min((lane + 1) * half - c0, len) : 0;
#pragma unroll 1
    for (int e = lo; e < hi; ++e) acc += sh.g[e];
    __syncwarp();  // the next chunk writes the entries this sum read
  }
  if (kDebug && lane == 0 && n_live > 0) {
    passes[2 * warp] = static_cast<int>(n_exact);
    passes[2 * warp + 1] = static_cast<int>(n_retry);
  }
  if (owner) e_h[p] = (0.5f * k.cp * k.K) * acc / static_cast<float>(half);
}

inline DualT law_from(const void* host) {
  DualT k;
  const float* f = static_cast<const float*>(host);
  float* dst = reinterpret_cast<float*>(&k);
  for (size_t i = 0; i < sizeof(DualT) / sizeof(float); ++i) dst[i] = f[i];
  return k;
}

inline bool args_fit(int n_paths, int tile, int n_dates, int half, int first_tile) {
  return n_paths >= 1 && tile >= 1 && n_paths % tile == 0 && n_dates >= 1 && n_dates <= 65535 &&
         half >= 1 && half <= kMaxPairs && first_tile >= 0;
}

// Which of kernel 18's designs a launch takes: the redesign, the first
// design (dual_ce_first_kernel for GBM, Heston, Merton and Bates;
// dual_ce_kernel's instances for VG, SABR and rough Bergomi), or the VG,
// SABR and rough Bergomi redesigns' debug instances; the same for VG's
// terminal step.
enum Design { kDesignNew = 0, kDesignFirst = 1, kDesignDebug = 2 };

// Kernel 18 under ``design`` for the law's side; d0-d2 the debug outputs.
template <int F>
int launch_ce(Design design, void* ce, void* d0, void* d1, void* d2, const void* x, const void* v,
              const void* hist, const void* comp, const void* rows, const DualT& k, uint64_t seed,
              int first_tile, int tile, int n_paths, int n_dates, int width, int degree, int half,
              cudaStream_t stream) {
  const bool call = k.cp > 0.0f;
  const dim3 grid((n_paths + kBlock - 1) / kBlock, n_dates);
  const auto* xp = static_cast<const float*>(x);
  const auto* vp = static_cast<const float*>(v);
  const auto* hp = static_cast<const float*>(hist);
  const auto* cp = static_cast<const float*>(comp);
  const auto* rp = static_cast<const float*>(rows);
  auto* out = static_cast<float*>(ce);
  if constexpr (F <= kBates) {
    if (design == kDesignDebug) return static_cast<int>(cudaErrorInvalidValue);
    if (design == kDesignFirst) {
      dual_ce_first_kernel<F><<<grid, kBlock, 0, stream>>>(out, xp, vp, rp, k, seed, first_tile,
                                                           tile, n_paths, width, degree, half);
      return static_cast<int>(cudaGetLastError());
    }
  } else if (design != kDesignFirst) {
    const fast::PhiloxKeys keys = fast::philox_keys(seed);
    const bool debug = design == kDesignDebug;
    if constexpr (F == kVg) {
      auto kernel = call ? (debug ? dual_ce_vg_kernel<true, true> : dual_ce_vg_kernel<true, false>)
                         : (debug ? dual_ce_vg_kernel<false, true>
                                  : dual_ce_vg_kernel<false, false>);
      kernel<<<grid, kBlock, 0, stream>>>(out, static_cast<float*>(d0), static_cast<int*>(d1),
                                          static_cast<int*>(d2), xp, rp, k, keys, first_tile,
                                          tile, n_paths, width, degree, half);
    } else if constexpr (F == kSabr) {
      auto kernel = call ? (debug ? dual_ce_sabr_kernel<true, true>
                                  : dual_ce_sabr_kernel<true, false>)
                         : (debug ? dual_ce_sabr_kernel<false, true>
                                  : dual_ce_sabr_kernel<false, false>);
      kernel<<<grid, kBlock, 0, stream>>>(out, static_cast<float*>(d0), static_cast<float*>(d1),
                                          xp, vp, rp, k, keys, first_tile, tile, n_paths, width,
                                          degree, half);
    } else {
      auto kernel = call ? (debug ? dual_ce_rough_kernel<true, true>
                                  : dual_ce_rough_kernel<true, false>)
                         : (debug ? dual_ce_rough_kernel<false, true>
                                  : dual_ce_rough_kernel<false, false>);
      kernel<<<grid, kBlock, 0, stream>>>(out, static_cast<float*>(d0), static_cast<float*>(d1),
                                          xp, vp, hp, cp, rp, k, keys, first_tile, tile, n_paths,
                                          width, degree, half);
    }
    return static_cast<int>(cudaGetLastError());
  }
  auto kernel = call ? dual_ce_kernel<F, true> : dual_ce_kernel<F, false>;
  kernel<<<grid, kBlock, 0, stream>>>(out, xp, vp, hp, cp, rp, k, seed, first_tile, tile, n_paths,
                                      width, degree, half);
  return static_cast<int>(cudaGetLastError());
}

inline int ce_entry(Design design, void* ce, void* d0, void* d1, void* d2, const void* x,
                    const void* v, const void* hist, const void* comp, const void* rows,
                    const void* law, uint64_t seed, int first_tile, int tile, int n_paths,
                    int n_dates, int width, int degree, int half, int family, void* stream) {
  if (!args_fit(n_paths, tile, n_dates, half, first_tile) || width > kMaxRow || degree < 1 ||
      width < kRowHead + degree + 2 || (family == kRBergomi && (hist == nullptr || comp == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const DualT k = law_from(law);
  const auto s = static_cast<cudaStream_t>(stream);
#define OMT_CE(F)                                                                              \
  case F:                                                                                      \
    return launch_ce<F>(design, ce, d0, d1, d2, x, v, hist, comp, rows, k, seed, first_tile,   \
                        tile, n_paths, n_dates, width, degree, half, s);
  switch (family) {
    OMT_CE(kGbm)
    OMT_CE(kHeston)
    OMT_CE(kMerton)
    OMT_CE(kBates)
    OMT_CE(kVg)
    OMT_CE(kSabr)
    OMT_CE(kRBergomi)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef OMT_CE
}

template <int F>
int launch_states(void* xs, void* vs, void* counts, const void* x, const void* v,
                  const void* hist, const void* comp, const DualT& k, uint64_t seed,
                  int first_tile, int tile, int n_paths, int date0, int n_chunk, int half,
                  cudaStream_t stream) {
  const dim3 grid((n_paths + kBlock - 1) / kBlock, n_chunk);
  auto kernel = counts ? dual_inner_states_kernel<F, true> : dual_inner_states_kernel<F, false>;
  kernel<<<grid, kBlock, 0, stream>>>(static_cast<float*>(xs), static_cast<float*>(vs),
                                      static_cast<int*>(counts), static_cast<const float*>(x),
                                      static_cast<const float*>(v),
                                      static_cast<const float*>(hist),
                                      static_cast<const float*>(comp), k, seed, first_tile, tile,
                                      n_paths, date0, half);
  return static_cast<int>(cudaGetLastError());
}

// VG's terminal step under ``design``; the debug outputs G, its attempts
// and the warps' passes.
inline int launch_terminal(Design design, void* e_h, void* gs, void* atts, void* passes,
                           const void* x_last, const void* law, uint64_t seed, int first_tile,
                           int tile, int n_paths, int date, int half, cudaStream_t stream) {
  if (!args_fit(n_paths, tile, 1, half, first_tile) || date < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const DualT k = law_from(law);
  auto* out = static_cast<float*>(e_h);
  const auto* xp = static_cast<const float*>(x_last);
  if (design == kDesignFirst) {
    dual_vg_terminal_kernel<<<(n_paths + kBlock - 1) / kBlock, kBlock, 0, stream>>>(
        out, xp, k, seed, first_tile, tile, n_paths, date, half);
    return static_cast<int>(cudaGetLastError());
  }
  const int per_warp = terminal_per_warp(half);
  const int warps = (n_paths + per_warp - 1) / per_warp;
  const int blocks = (warps + kBlock / 32 - 1) / (kBlock / 32);
  const bool call = k.cp > 0.0f, debug = design == kDesignDebug;
  auto kernel = call ? (debug ? dual_vg_terminal_warp_kernel<true, true>
                              : dual_vg_terminal_warp_kernel<true, false>)
                     : (debug ? dual_vg_terminal_warp_kernel<false, true>
                              : dual_vg_terminal_warp_kernel<false, false>);
  kernel<<<blocks, kBlock, 0, stream>>>(out, static_cast<float*>(gs), static_cast<int*>(atts),
                                        static_cast<int*>(passes), xp, k,
                                        fast::philox_keys(seed), first_tile, tile, n_paths,
                                        date, half, per_warp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dual
}  // namespace omt

extern "C" {

// Kernel 18. ce: device (n_dates, n_paths) float32; x, v: device (>= n_dates
// rows, n_paths) float32 (v null for GBM, Merton and VG; alpha under SABR);
// hist: device (>= n_dates rows, n_paths), comp: device (n_dates,) float32,
// rough Bergomi's frozen histories and compensators (null otherwise); rows:
// device (n_dates, width) float32 policy rows; law: host pointer to the
// DualT floats (ops/cuda_dual.law_args); family: 0 GBM, 1 Heston, 2 Merton,
// 3 Bates, 4 VG, 5 SABR, 6 rough Bergomi.
int omt_dual_ce(void* ce, const void* x, const void* v, const void* hist, const void* comp,
                const void* rows, const void* law, uint64_t seed, int first_tile, int tile,
                int n_paths, int n_dates, int width, int degree, int half, int family,
                void* stream) {
  using namespace omt::dual;
  return ce_entry(kDesignNew, ce, nullptr, nullptr, nullptr, x, v, hist, comp, rows, law, seed,
                  first_tile, tile, n_paths, n_dates, width, degree, half, family, stream);
}

// Kernel 18's first design, the same arguments (families 0-6: VG's, SABR's
// and rough Bergomi's is dual_ce_kernel).
int omt_dual_ce_first(void* ce, const void* x, const void* v, const void* hist, const void* comp,
                      const void* rows, const void* law, uint64_t seed, int first_tile, int tile,
                      int n_paths, int n_dates, int width, int degree, int half, int family,
                      void* stream) {
  using namespace omt::dual;
  return ce_entry(kDesignFirst, ce, nullptr, nullptr, nullptr, x, v, hist, comp, rows, law, seed,
                  first_tile, tile, n_paths, n_dates, width, degree, half, family, stream);
}

// Kernel 18's VG (family 4), SABR (5) or rough Bergomi (6) redesign through
// its debug instance: VG's d0 device (n_dates, half, n_paths) float32 the
// pairs' G, d1 the same shape int32 their accepting attempts, d2 (n_dates,
// ceil(n_paths / 32), 2) int32 each warp's passes of the exact tests and of
// the retries; SABR's and rough Bergomi's d0 and d1 device (n_dates, 2,
// half, n_paths) float32 x' and alpha' (v'), d2 null. The rest as
// omt_dual_ce.
int omt_dual_ce_debug(void* ce, void* d0, void* d1, void* d2, const void* x, const void* v,
                      const void* hist, const void* comp, const void* rows, const void* law,
                      uint64_t seed, int first_tile, int tile, int n_paths, int n_dates,
                      int width, int degree, int half, int family, void* stream) {
  using namespace omt::dual;
  if (family < kVg || family > kRBergomi || d0 == nullptr || d1 == nullptr ||
      (family == kVg && d2 == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return ce_entry(kDesignDebug, ce, d0, d1, d2, x, v, hist, comp, rows, law, seed, first_tile,
                  tile, n_paths, n_dates, width, degree, half, family, stream);
}

// Kernel 19. xs (and vs under Heston, Bates, SABR, rough Bergomi; VG's
// clock): device (n_chunk, 2, half, n_paths) float32; counts: device
// (n_chunk, half, n_paths) int32 or null; dates date0 .. date0 + n_chunk - 1
// of x (and v, hist); the rest as omt_dual_ce.
int omt_dual_inner_states(void* xs, void* vs, void* counts, const void* x, const void* v,
                          const void* hist, const void* comp, const void* law, uint64_t seed,
                          int first_tile, int tile, int n_paths, int date0, int n_chunk,
                          int half, int family, void* stream) {
  using namespace omt::dual;
  if (!args_fit(n_paths, tile, n_chunk, half, first_tile) || date0 < 0 ||
      (family == kRBergomi && (hist == nullptr || comp == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const DualT k = law_from(law);
  const auto s = static_cast<cudaStream_t>(stream);
#define OMT_STATES(F)                                                                          \
  case F:                                                                                      \
    return launch_states<F>(xs, vs, counts, x, v, hist, comp, k, seed, first_tile, tile,       \
                            n_paths, date0, n_chunk, half, s);
  switch (family) {
    OMT_STATES(kGbm)
    OMT_STATES(kHeston)
    OMT_STATES(kMerton)
    OMT_STATES(kBates)
    OMT_STATES(kVg)
    OMT_STATES(kSabr)
    OMT_STATES(kRBergomi)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef OMT_STATES
}

// VG's terminal expectation (dual_vg_terminal_warp_kernel). e_h: device
// (n_paths,) float32; x_last: device (n_paths,) float32, x at date n_steps -
// 1; date: the clock draws' date (n_dates); the rest as omt_dual_ce.
int omt_dual_vg_terminal(void* e_h, const void* x_last, const void* law, uint64_t seed,
                         int first_tile, int tile, int n_paths, int date, int half,
                         void* stream) {
  using namespace omt::dual;
  return launch_terminal(kDesignNew, e_h, nullptr, nullptr, nullptr, x_last, law, seed,
                         first_tile, tile, n_paths, date, half,
                         static_cast<cudaStream_t>(stream));
}

// Its first design (dual_vg_terminal_kernel, one thread a path), the same
// arguments.
int omt_dual_vg_terminal_first(void* e_h, const void* x_last, const void* law, uint64_t seed,
                               int first_tile, int tile, int n_paths, int date, int half,
                               void* stream) {
  using namespace omt::dual;
  return launch_terminal(kDesignFirst, e_h, nullptr, nullptr, nullptr, x_last, law, seed,
                         first_tile, tile, n_paths, date, half,
                         static_cast<cudaStream_t>(stream));
}

// The redesign through its debug instance: gs device (half, n_paths) float32
// each draw's G = nu gamma, atts the same shape int32 its accepting
// attempt, passes device (ceil(n_paths / per_warp), 2) int32 each warp's
// passes of the exact tests and of the retries (per_warp = min(32, max(1,
// 256 / half)), ops/cuda_dual.terminal_per_warp). The rest as
// omt_dual_vg_terminal.
int omt_dual_vg_terminal_debug(void* e_h, void* gs, void* atts, void* passes, const void* x_last,
                               const void* law, uint64_t seed, int first_tile, int tile,
                               int n_paths, int date, int half, void* stream) {
  using namespace omt::dual;
  if (gs == nullptr || atts == nullptr || passes == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_terminal(kDesignDebug, e_h, gs, atts, passes, x_last, law, seed, first_tile,
                         tile, n_paths, date, half, static_cast<cudaStream_t>(stream));
}

// Registers, spills and occupancy (omt::kernel_attrs): which = 4 kernel +
// family for families 0-3, kernel 0 dual_ce_kernel's put instance, 1
// dual_inner_states_kernel without counts, 2 dual_ce_first_kernel, 3
// dual_ce_kernel's call instance; 16 + 3 kernel + (family - 4) for the
// VG, SABR and rough Bergomi families, kernel 0 the redesign's put
// instance, 1 its call instance, 2 the states kernel; 26 + 2 (family - 4)
// + call for their first designs (dual_ce_kernel), 32 + (family - 4) for
// their redesigns' debug instances (puts); VG's terminal step: 25 the
// redesign's put instance, 35 its call instance, 36 its debug instance
// (put), 37 the first design.
int omt_dual_attrs(int which, int* out) {
  using namespace omt::dual;
  using omt::kernel_attrs;
  switch (which) {
    case 0: return kernel_attrs(dual_ce_kernel<kGbm, false>, kBlock, out);
    case 1: return kernel_attrs(dual_ce_kernel<kHeston, false>, kBlock, out);
    case 2: return kernel_attrs(dual_ce_kernel<kMerton, false>, kBlock, out);
    case 3: return kernel_attrs(dual_ce_kernel<kBates, false>, kBlock, out);
    case 4: return kernel_attrs(dual_inner_states_kernel<kGbm, false>, kBlock, out);
    case 5: return kernel_attrs(dual_inner_states_kernel<kHeston, false>, kBlock, out);
    case 6: return kernel_attrs(dual_inner_states_kernel<kMerton, false>, kBlock, out);
    case 7: return kernel_attrs(dual_inner_states_kernel<kBates, false>, kBlock, out);
    case 8: return kernel_attrs(dual_ce_first_kernel<kGbm>, kBlock, out);
    case 9: return kernel_attrs(dual_ce_first_kernel<kHeston>, kBlock, out);
    case 10: return kernel_attrs(dual_ce_first_kernel<kMerton>, kBlock, out);
    case 11: return kernel_attrs(dual_ce_first_kernel<kBates>, kBlock, out);
    case 12: return kernel_attrs(dual_ce_kernel<kGbm, true>, kBlock, out);
    case 13: return kernel_attrs(dual_ce_kernel<kHeston, true>, kBlock, out);
    case 14: return kernel_attrs(dual_ce_kernel<kMerton, true>, kBlock, out);
    case 15: return kernel_attrs(dual_ce_kernel<kBates, true>, kBlock, out);
    case 16: return kernel_attrs(dual_ce_vg_kernel<false, false>, kBlock, out);
    case 17: return kernel_attrs(dual_ce_sabr_kernel<false, false>, kBlock, out);
    case 18: return kernel_attrs(dual_ce_rough_kernel<false, false>, kBlock, out);
    case 19: return kernel_attrs(dual_ce_vg_kernel<true, false>, kBlock, out);
    case 20: return kernel_attrs(dual_ce_sabr_kernel<true, false>, kBlock, out);
    case 21: return kernel_attrs(dual_ce_rough_kernel<true, false>, kBlock, out);
    case 22: return kernel_attrs(dual_inner_states_kernel<kVg, false>, kBlock, out);
    case 23: return kernel_attrs(dual_inner_states_kernel<kSabr, false>, kBlock, out);
    case 24: return kernel_attrs(dual_inner_states_kernel<kRBergomi, false>, kBlock, out);
    case 25: return kernel_attrs(dual_vg_terminal_warp_kernel<false, false>, kBlock, out);
    case 26: return kernel_attrs(dual_ce_kernel<kVg, false>, kBlock, out);
    case 27: return kernel_attrs(dual_ce_kernel<kVg, true>, kBlock, out);
    case 28: return kernel_attrs(dual_ce_kernel<kSabr, false>, kBlock, out);
    case 29: return kernel_attrs(dual_ce_kernel<kSabr, true>, kBlock, out);
    case 30: return kernel_attrs(dual_ce_kernel<kRBergomi, false>, kBlock, out);
    case 31: return kernel_attrs(dual_ce_kernel<kRBergomi, true>, kBlock, out);
    case 32: return kernel_attrs(dual_ce_vg_kernel<false, true>, kBlock, out);
    case 33: return kernel_attrs(dual_ce_sabr_kernel<false, true>, kBlock, out);
    case 34: return kernel_attrs(dual_ce_rough_kernel<false, true>, kBlock, out);
    case 35: return kernel_attrs(dual_vg_terminal_warp_kernel<true, false>, kBlock, out);
    case 36: return kernel_attrs(dual_vg_terminal_warp_kernel<false, true>, kBlock, out);
    case 37: return kernel_attrs(dual_vg_terminal_kernel, kBlock, out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
