// The martingale dual's inner expectation for Hopper (sm_90a).
//
// The JAX package computes it in XLA code, not in Pallas:
//   options_model_tpu/pricers/dual.py:292  dual_upper_from_policy: date_ce, a lax.scan
//                                          over dates (:579-620 Heston and Bates,
//                                          :706-735 GBM and Merton): kernel 18
//   options_model_tpu/pricers/dual.py:847  dual_upper_from_nn_policy (:910-962): kernel 19
// Each (date, path) takes n_inner antithetic one-step draws of the
// simulator's transition and evaluates the value surrogate at each; eager
// torch would hold several (n_inner/2, P) tensors a date and draw its Philox
// words in int64 arithmetic, so the port has kernels of its own, with plain
// versions on the same counters (ops/cuda_dual.py; ops/philox.py states the
// stream: counter = (slot in tile, draw, global tile, 2), one slot a path,
// draw = date x calls a date + call, the jump calls counted in every family).
//
// - dual_ce_kernel<F> (kernel 18): one thread a (date, path), grid (paths,
//   dates). A block loads its date's policy row (tau, x_mean, x_rstd,
//   v_mean, v_rstd, betas) into shared memory once; the thread reads x_t
//   (and v_t) once, walks the inner pairs (Philox in the kernel, the plain
//   version's Box-Muller with 1 - u in the log, the pair mirrored: z and -z,
//   the jump normal too, the Poisson count shared), evaluates the surrogate
//   at both members (_vhat: the intrinsic value, the Black-Scholes floor at
//   the date's remaining maturity, the clamped polynomial gated to the
//   in-the-money side and clipped to [0, cap]), and writes the mean once.
//   The polynomial degree is a run-time argument; the family (GBM, Heston,
//   Merton, Bates) is a compile-time instance.
// - dual_inner_states_kernel<F, kCounts> (kernel 19): the same walk and
//   transitions for a chunk of dates, writing each inner state x' (and v'
//   under Heston) as (chunk, 2, n_inner/2, P), the pair's up member first,
//   for the NN policy's network; with kCounts also each pair's Poisson count
//   (int32), so a check can hold the counts against the plain version's.
//
// Every float operation is IEEE (no --use_fast_math, the _rn intrinsics
// where nvcc could contract into an FMA) in the plain version's order, so
// the kernels differ from it only where libdevice's expf, logf, erfcf and
// sqrtf differ from torch's; a member landing within those ulps of x' = 1
// can flip the in-the-money gate (chip_smoke.py states the tolerance).
//
// What bounds them on the card: kernel 18 reads 4 (8 with v) bytes and
// writes 4 a (date, path) over n_inner surrogate evaluations, each a log,
// two erfc, an exp and ~40 more float operations, so it is held by its
// float work (chip_smoke.bound counts it); kernel 19 writes 4 (8) bytes a
// state after ~20 operations and is held by its stores. Nothing is tuned
// beyond the row in shared memory.
#include "kernel_attrs.cuh"
#include "philox.cuh"

namespace omt {
namespace dual {

constexpr int kBlock = 128;
constexpr uint32_t kDualStream = 2u;
constexpr float kUClamp = 4.0f;
// ops/philox.MAX_POISSON_TABLE, ops/cuda_dual.MAX_ROW and MAX_PAIRS.
constexpr int kMaxTable = 120;
constexpr int kMaxRow = 64;
constexpr int kMaxPairs = 1024;
constexpr int kRowHead = 5;  // tau, x_mean, x_rstd, v_mean, v_rstd

enum Family { kGbm = 0, kHeston = 1, kMerton = 2, kBates = 3 };

template <int F>
constexpr bool kUseV = F == kHeston || F == kBates;
template <int F>
constexpr bool kJumps = F == kMerton || F == kBates;
// Inner pairs a diffusion call serves (ops/philox.DUAL_PAIRS_A_CALL); a jump
// call serves two.
template <int F>
constexpr int kPairsACall = kUseV<F> ? 2 : 4;

// The law (pricers/dual.InnerLaw, ops/cuda_dual.LAW_FIELDS order) and its
// Poisson table, by value.
struct DualT {
  float K, cp, rate, q, dt, drift, mu, a, sig_f, kappa, theta, xi, rho, rho_bar, comp_dt, jvar,
      mu_j, sig_j;
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
// (r - q - v/2) dt - lam kbar dt and kappa (theta - v) dt.
struct PathK {
  float xp, vp, sv, mu_t, dv;
};

template <int F>
__device__ __forceinline__ PathK path_consts(float xp, float vp, const DualT& k) {
  if (!kUseV<F>) return PathK{xp, 0.0f, 0.0f, 0.0f, 0.0f};
  return PathK{xp, vp, sqrtf(mul(fmaxf(vp, 0.0f), k.dt)),
               sub(mul(sub(k.drift, mul(0.5f, vp)), k.dt), k.comp_dt),
               mul(mul(k.kappa, sub(k.theta, vp)), k.dt)};
}

// The inner pair's states: (x', v') of the up and the down member.
struct Pair {
  float xu, xd, vu, vd;
};

// pricers/dual.inner_states_from_draws for one pair: normals z1 (z), z2,
// the count n and the jump normal zj.
template <int F>
__device__ __forceinline__ Pair step_pair(const PathK& s, float z1, float z2, float n, float zj,
                                          const DualT& k) {
  float jb = 0.0f, jn = 0.0f;
  if (kJumps<F>) {
    jb = mul(n, k.mu_j);
    jn = mul(mul(k.sig_j, sqrtf(n)), zj);
  }
  Pair out;
  if (!kUseV<F>) {
    float up = add(k.mu, mul(k.a, z1)), dn = sub(k.mu, mul(k.a, z1));
    if (kJumps<F>) {
      up = add(add(up, jb), jn);
      dn = sub(add(dn, jb), jn);
    }
    out.xu = mul(s.xp, expf(up));
    out.xd = mul(s.xp, expf(dn));
    out.vu = out.vd = 0.0f;
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

// Walk the inner pairs of one (date, path) in the stream's order, calling
// fn(pair, states, count) for each (ops/philox.dual_inner_draws' layout).
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
          fn(pair + q, step_pair<F>(s, n[2 * h + q], 0.0f, j.n[q], j.zj[q], k), j.n[q]);
        }
      }
    } else {
      const int pair = 2 * c;
      JumpDraws j{{0.0f, 0.0f}, {0.0f, 0.0f}};
      if (kJumps<F>) j = jump_draws(slot, base + diff + c, global_tile, seed, k);
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        if (pair + q >= half) break;
        fn(pair + q, step_pair<F>(s, n[2 * q], n[2 * q + 1], j.n[q], j.zj[q], k), j.n[q]);
      }
    }
  }
}

template <int F>
__global__ void __launch_bounds__(kBlock)
dual_ce_kernel(float* __restrict__ ce, const float* __restrict__ x, const float* __restrict__ v,
               const float* __restrict__ rows, const __grid_constant__ DualT k, uint64_t seed,
               int first_tile, int tile, int n_paths, int width, int degree, int half) {
  __shared__ float row[kMaxRow];
  const int date = blockIdx.y;
  for (int i = threadIdx.x; i < width; i += blockDim.x) {
    row[i] = rows[static_cast<size_t>(date) * width + i];
  }
  __syncthreads();
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n_paths) return;
  const size_t at = static_cast<size_t>(date) * n_paths + p;
  const PathK s = path_consts<F>(x[at], kUseV<F> ? v[at] : 0.0f, k);
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
                         const __grid_constant__ DualT k, uint64_t seed, int first_tile, int tile,
                         int n_paths, int date0, int half) {
  const int local = blockIdx.y;
  const int date = date0 + local;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n_paths) return;
  const size_t at = static_cast<size_t>(date) * n_paths + p;
  const PathK s = path_consts<F>(x[at], kUseV<F> ? v[at] : 0.0f, k);
  const size_t plane = static_cast<size_t>(half) * n_paths;
  float* xo = xs + static_cast<size_t>(local) * 2 * plane + p;
  float* vo = kUseV<F> ? vs + static_cast<size_t>(local) * 2 * plane + p : nullptr;
  int* co = kCounts ? counts + static_cast<size_t>(local) * plane + p : nullptr;
  walk_pairs<F>(s, date, half, static_cast<uint32_t>(p % tile),
                static_cast<uint32_t>(first_tile + p / tile), seed, k,
                [&](int pair, const Pair& st, float n) {
                  const size_t i = static_cast<size_t>(pair) * n_paths;
                  xo[i] = st.xu;
                  xo[plane + i] = st.xd;
                  if (kUseV<F>) {
                    vo[i] = st.vu;
                    vo[plane + i] = st.vd;
                  }
                  if (kCounts) co[i] = static_cast<int>(n);
                });
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

template <int F>
int launch_ce(void* ce, const void* x, const void* v, const void* rows, const DualT& k,
              uint64_t seed, int first_tile, int tile, int n_paths, int n_dates, int width,
              int degree, int half, cudaStream_t stream) {
  const dim3 grid((n_paths + kBlock - 1) / kBlock, n_dates);
  dual_ce_kernel<F><<<grid, kBlock, 0, stream>>>(
      static_cast<float*>(ce), static_cast<const float*>(x), static_cast<const float*>(v),
      static_cast<const float*>(rows), k, seed, first_tile, tile, n_paths, width, degree, half);
  return static_cast<int>(cudaGetLastError());
}

template <int F>
int launch_states(void* xs, void* vs, void* counts, const void* x, const void* v, const DualT& k,
                  uint64_t seed, int first_tile, int tile, int n_paths, int date0, int n_chunk,
                  int half, cudaStream_t stream) {
  const dim3 grid((n_paths + kBlock - 1) / kBlock, n_chunk);
  auto kernel = counts ? dual_inner_states_kernel<F, true> : dual_inner_states_kernel<F, false>;
  kernel<<<grid, kBlock, 0, stream>>>(static_cast<float*>(xs), static_cast<float*>(vs),
                                      static_cast<int*>(counts), static_cast<const float*>(x),
                                      static_cast<const float*>(v), k, seed, first_tile, tile,
                                      n_paths, date0, half);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dual
}  // namespace omt

extern "C" {

// Kernel 18. ce: device (n_dates, n_paths) float32; x, v: device (>= n_dates
// rows, n_paths) float32 (v null for GBM and Merton); rows: device
// (n_dates, width) float32 policy rows; law: host pointer to the DualT
// floats (ops/cuda_dual.law_args); family: 0 GBM, 1 Heston, 2 Merton, 3 Bates.
int omt_dual_ce(void* ce, const void* x, const void* v, const void* rows, const void* law,
                uint64_t seed, int first_tile, int tile, int n_paths, int n_dates, int width,
                int degree, int half, int family, void* stream) {
  using namespace omt::dual;
  if (!args_fit(n_paths, tile, n_dates, half, first_tile) || width > kMaxRow ||
      degree < 1 || width < kRowHead + degree + 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const DualT k = law_from(law);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (family) {
    case kGbm:
      return launch_ce<kGbm>(ce, x, v, rows, k, seed, first_tile, tile, n_paths, n_dates, width,
                             degree, half, s);
    case kHeston:
      return launch_ce<kHeston>(ce, x, v, rows, k, seed, first_tile, tile, n_paths, n_dates,
                                width, degree, half, s);
    case kMerton:
      return launch_ce<kMerton>(ce, x, v, rows, k, seed, first_tile, tile, n_paths, n_dates,
                                width, degree, half, s);
    case kBates:
      return launch_ce<kBates>(ce, x, v, rows, k, seed, first_tile, tile, n_paths, n_dates,
                               width, degree, half, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Kernel 19. xs (and vs under Heston and Bates): device (n_chunk, 2, half,
// n_paths) float32; counts: device (n_chunk, half, n_paths) int32 or null;
// dates date0 .. date0 + n_chunk - 1 of x (and v); the rest as omt_dual_ce.
int omt_dual_inner_states(void* xs, void* vs, void* counts, const void* x, const void* v,
                          const void* law, uint64_t seed, int first_tile, int tile, int n_paths,
                          int date0, int n_chunk, int half, int family, void* stream) {
  using namespace omt::dual;
  if (!args_fit(n_paths, tile, n_chunk, half, first_tile) || date0 < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const DualT k = law_from(law);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (family) {
    case kGbm:
      return launch_states<kGbm>(xs, vs, counts, x, v, k, seed, first_tile, tile, n_paths, date0,
                                 n_chunk, half, s);
    case kHeston:
      return launch_states<kHeston>(xs, vs, counts, x, v, k, seed, first_tile, tile, n_paths,
                                    date0, n_chunk, half, s);
    case kMerton:
      return launch_states<kMerton>(xs, vs, counts, x, v, k, seed, first_tile, tile, n_paths,
                                    date0, n_chunk, half, s);
    case kBates:
      return launch_states<kBates>(xs, vs, counts, x, v, k, seed, first_tile, tile, n_paths,
                                   date0, n_chunk, half, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Registers, spills and occupancy (omt::kernel_attrs): which = 4 kernel +
// family, kernel 0 dual_ce_kernel, 1 dual_inner_states_kernel without counts.
int omt_dual_attrs(int which, int* out) {
  using namespace omt::dual;
  using omt::kernel_attrs;
  switch (which) {
    case 0: return kernel_attrs(dual_ce_kernel<kGbm>, kBlock, out);
    case 1: return kernel_attrs(dual_ce_kernel<kHeston>, kBlock, out);
    case 2: return kernel_attrs(dual_ce_kernel<kMerton>, kBlock, out);
    case 3: return kernel_attrs(dual_ce_kernel<kBates>, kBlock, out);
    case 4: return kernel_attrs(dual_inner_states_kernel<kGbm, false>, kBlock, out);
    case 5: return kernel_attrs(dual_inner_states_kernel<kHeston, false>, kBlock, out);
    case 6: return kernel_attrs(dual_inner_states_kernel<kMerton, false>, kBlock, out);
    case 7: return kernel_attrs(dual_inner_states_kernel<kBates, false>, kBlock, out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
