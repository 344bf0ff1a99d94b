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
//   comp)) and mirror all three normals. The VG family's clock loop
//   diverges within a warp where draws are rejected (~5% of attempts at
//   the brackets' shapes); this design leaves it so.
// - dual_vg_terminal_kernel: VG's terminal step, the Rao-Blackwellised
//   one-step Black expectation over n_inner/2 clock draws a path (the
//   same sampler at date n_dates), one thread a path.
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
// has the counts). Kernel 19
// writes 4 (8) bytes a state after ~20 operations and is held by its
// stores.
#include "gamma.cuh"
#include "kernel_attrs.cuh"
#include "philox.cuh"

namespace omt {
namespace dual {

using gamma::GammaK;

constexpr int kBlock = 128;
constexpr uint32_t kDualStream = 2u;
// The dual's gamma attempts (ops/philox.DUAL_GAMMA_STREAM, VG_MAX_ATTEMPTS).
constexpr uint32_t kGammaStream = 5u;
constexpr int kMaxAttempts = 15;
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
// there makes the clip 0 without a branch.
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

// Resident blocks an SM the redesign asks of nvcc: GBM 16 (at most 32
// registers, 100% occupancy), Heston 10 (48, 62.5%), Merton 12 (40, 75%),
// Bates 9 (56, 56.2%), none below the first design's. Left to itself nvcc
// interleaves the clip's arithmetic over both members and takes up to 76
// registers. VG, SABR and rough Bergomi 8 (64, 50%): their first cut.
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

// Kernel 18: the redesign's instance for the law's side, or the first
// design (GBM, Heston, Merton and Bates only).
template <int F>
int launch_ce(bool first, void* ce, const void* x, const void* v, const void* hist,
              const void* comp, const void* rows, const DualT& k, uint64_t seed, int first_tile,
              int tile, int n_paths, int n_dates, int width, int degree, int half,
              cudaStream_t stream) {
  const bool call = k.cp > 0.0f;
  const dim3 grid((n_paths + kBlock - 1) / kBlock, n_dates);
  const auto* xp = static_cast<const float*>(x);
  const auto* vp = static_cast<const float*>(v);
  const auto* rp = static_cast<const float*>(rows);
  auto* out = static_cast<float*>(ce);
  if constexpr (F <= kBates) {
    if (first) {
      dual_ce_first_kernel<F><<<grid, kBlock, 0, stream>>>(out, xp, vp, rp, k, seed, first_tile,
                                                           tile, n_paths, width, degree, half);
      return static_cast<int>(cudaGetLastError());
    }
  } else if (first) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = call ? dual_ce_kernel<F, true> : dual_ce_kernel<F, false>;
  kernel<<<grid, kBlock, 0, stream>>>(out, xp, vp, static_cast<const float*>(hist),
                                      static_cast<const float*>(comp), rp, k, seed, first_tile,
                                      tile, n_paths, width, degree, half);
  return static_cast<int>(cudaGetLastError());
}

inline int ce_entry(bool first, void* ce, const void* x, const void* v, const void* hist,
                    const void* comp, const void* rows, const void* law, uint64_t seed,
                    int first_tile, int tile, int n_paths, int n_dates, int width, int degree,
                    int half, int family, void* stream) {
  if (!args_fit(n_paths, tile, n_dates, half, first_tile) || width > kMaxRow || degree < 1 ||
      width < kRowHead + degree + 2 || (family == kRBergomi && (hist == nullptr || comp == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const DualT k = law_from(law);
  const auto s = static_cast<cudaStream_t>(stream);
#define OMT_CE(F)                                                                              \
  case F:                                                                                      \
    return launch_ce<F>(first, ce, x, v, hist, comp, rows, k, seed, first_tile, tile, n_paths, \
                        n_dates, width, degree, half, s);
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
  return omt::dual::ce_entry(false, ce, x, v, hist, comp, rows, law, seed, first_tile, tile,
                             n_paths, n_dates, width, degree, half, family, stream);
}

// Kernel 18's first design, the same arguments (families 0-3).
int omt_dual_ce_first(void* ce, const void* x, const void* v, const void* hist, const void* comp,
                      const void* rows, const void* law, uint64_t seed, int first_tile, int tile,
                      int n_paths, int n_dates, int width, int degree, int half, int family,
                      void* stream) {
  return omt::dual::ce_entry(true, ce, x, v, hist, comp, rows, law, seed, first_tile, tile,
                             n_paths, n_dates, width, degree, half, family, stream);
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

// VG's terminal expectation. e_h: device (n_paths,) float32; x_last: device
// (n_paths,) float32, x at date n_steps - 1; date: the clock draws' date
// (n_dates); the rest as omt_dual_ce.
int omt_dual_vg_terminal(void* e_h, const void* x_last, const void* law, uint64_t seed,
                         int first_tile, int tile, int n_paths, int date, int half,
                         void* stream) {
  using namespace omt::dual;
  if (!args_fit(n_paths, tile, 1, half, first_tile) || date < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const DualT k = law_from(law);
  dual_vg_terminal_kernel<<<(n_paths + kBlock - 1) / kBlock, kBlock, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(e_h), static_cast<const float*>(x_last), k, seed, first_tile, tile,
      n_paths, date, half);
  return static_cast<int>(cudaGetLastError());
}

// Registers, spills and occupancy (omt::kernel_attrs): which = 4 kernel +
// family for families 0-3, kernel 0 dual_ce_kernel's put instance, 1
// dual_inner_states_kernel without counts, 2 dual_ce_first_kernel, 3
// dual_ce_kernel's call instance; 16 + 3 kernel + (family - 4) for the
// VG, SABR and rough Bergomi families, kernel 0 the put instance, 1 the
// call instance, 2 the states kernel; 25 dual_vg_terminal_kernel.
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
    case 16: return kernel_attrs(dual_ce_kernel<kVg, false>, kBlock, out);
    case 17: return kernel_attrs(dual_ce_kernel<kSabr, false>, kBlock, out);
    case 18: return kernel_attrs(dual_ce_kernel<kRBergomi, false>, kBlock, out);
    case 19: return kernel_attrs(dual_ce_kernel<kVg, true>, kBlock, out);
    case 20: return kernel_attrs(dual_ce_kernel<kSabr, true>, kBlock, out);
    case 21: return kernel_attrs(dual_ce_kernel<kRBergomi, true>, kBlock, out);
    case 22: return kernel_attrs(dual_inner_states_kernel<kVg, false>, kBlock, out);
    case 23: return kernel_attrs(dual_inner_states_kernel<kSabr, false>, kBlock, out);
    case 24: return kernel_attrs(dual_inner_states_kernel<kRBergomi, false>, kBlock, out);
    case 25: return kernel_attrs(dual_vg_terminal_kernel, kBlock, out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
