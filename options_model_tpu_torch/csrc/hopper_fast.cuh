// The pieces of the Hopper redesigns (heston_paths.cu, terminal.cu,
// localvol_paths.cu, paths_variants.cu) that make a path-step cheaper than
// the first designs' without changing the stream: Philox with its round keys
// computed once per launch, the SFU's approximate lg2, ex2 and sqrt, an SFU
// Box-Muller, the streamed row store of S, the full-truncation Euler step on
// the SFU and FMAs, the local-vol step over a padded Chebyshev row and its
// draw schedule, the never-contracted _rn arithmetic of QE-M's variance chain, and the QE-M step
// whose variance chain stays exact while its log-S chain goes to the fast
// pipes.
//
// Nothing here is compiled with --use_fast_math: the fast forms are named
// where they are used, and every other operation keeps IEEE rounding.
#pragma once

#include <cstdint>
#include <type_traits>

#include "philox.cuh"

namespace omt {
namespace fast {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// The round keys (seed lo + i W0, seed hi + i W1) of rounds i = 0..9.
struct PhiloxKeys {
  uint32_t k0[10], k1[10];
};

inline PhiloxKeys philox_keys(uint64_t seed) {
  PhiloxKeys k;
  uint32_t a = static_cast<uint32_t>(seed), b = static_cast<uint32_t>(seed >> 32);
  for (int i = 0; i < 10; ++i) {
    k.k0[i] = a;
    k.k1[i] = b;
    a += kPhiloxW0;
    b += kPhiloxW1;
  }
  return k;
}

// philox4x32_10 of philox.cuh with the key schedule read from ``k``.
__device__ __forceinline__ Words philox_keyed(Words c, const PhiloxKeys& k) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const uint32_t hi0 = __umulhi(kPhiloxM0, c.x), lo0 = kPhiloxM0 * c.x;
    const uint32_t hi1 = __umulhi(kPhiloxM1, c.z), lo1 = kPhiloxM1 * c.z;
    c = Words{hi1 ^ c.y ^ k.k0[i], lo1, hi0 ^ c.w ^ k.k1[i], lo0};
  }
  return c;
}

__device__ __forceinline__ float lg2_approx(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float sqrt_approx(float x) {
  float y;
  asm("sqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// box_muller of philox.cuh on the SFU: (z1, z2) = rad (cos, sin)(2 pi u2),
// rad = sqrt(-2 log(1 - u1)). Absolute error in z: ~3.6e-7 rad from the
// angle, below 3e-6 from the radius.
__device__ __forceinline__ void box_muller_fast(uint32_t b1, uint32_t b2, float& z1,
                                                float& z2) {
  const float u1 = uniform_from_bits(b1);
  const float u2 = uniform_from_bits(b2);
  const float series = u1 * fmaf(u1, fmaf(u1, 0.333333343f, 0.5f), 1.0f);
  const float nlog = u1 < 0.0078125f ? series : -kLn2 * lg2_approx(1.0f - u1);
  const float rad = sqrt_approx(fmaxf(2.0f * nlog, 0.0f));
  float s, c;
  __sincosf(6.28318548f * (u2 - 0.5f), &s, &c);  // u2 - 1/2 is exact
  z1 = -rad * c;
  z2 = -rad * s;
}

// One entry of a stored row: S = 2^(log2 S0 + x log2 e), x = log S - log S0,
// with the streaming hint (st.global.cs): nothing reads the matrix back in
// the kernel that writes it.
__device__ __forceinline__ void store_s(float* p, float x, float log2_s0) {
  __stcs(p, ex2_approx(fmaf(x, kLog2e, log2_s0)));
}

// The full-truncation Euler step's constants, folded from the 10 floats of
// HestonConsts (log_s0, r, dt, sqrt_dt, kappa, theta, xi, rho, rho_bar, v0).
struct EulerK {
  float log2_s0, rdt, mhdt, ca, cb, xi_sdt, sqrt_dt, rho, rho_bar, v0;
};

__host__ __device__ __forceinline__ EulerK euler_fold(const float* c) {
  const float dt = c[2], sqrt_dt = c[3], kd = c[4] * dt;
  return EulerK{c[0] * kLog2e, c[1] * dt, -0.5f * dt, 1.0f - kd, kd * c[5], c[6] * sqrt_dt,
                sqrt_dt, c[7], c[8], c[9]};
}

// euler_fold of a row in device memory.
__device__ __forceinline__ EulerK euler_consts(const float* __restrict__ row) {
  float c[10];
#pragma unroll
  for (int i = 0; i < 10; ++i) c[i] = __ldg(row + i);
  return euler_fold(c);
}

// v <- max(v+ (1 - kappa dt) + kappa theta dt + xi sqrt(dt v+) w2, 0) and
// log S <- log S + r dt - v+ dt / 2 + sqrt(dt v+) z1 (heston_common.cuh's
// heston_step), ls = log S - log S0. kWhole adds the step's whole increment
// to ls at once; otherwise (ls + r dt) is rounded first, the paths kernel's
// form, which PATHS_DIGEST pins. A constant added on its own rounds the same
// way wherever ls stays in one binade; a random increment rounds both ways.
template <bool kWhole = false>
__device__ __forceinline__ void euler_step(float& ls, float& v, float z1, float w2,
                                           const EulerK& k) {
  const float vp = fmaxf(v, 0.0f);
  const float sv = sqrt_approx(vp);
  v = fmaxf(fmaf(k.xi_sdt * sv, w2, fmaf(vp, k.ca, k.cb)), 0.0f);
  if constexpr (kWhole) {
    ls += fmaf(k.sqrt_dt * sv, z1, fmaf(vp, k.mhdt, k.rdt));
  } else {
    ls = fmaf(k.sqrt_dt * sv, z1, fmaf(vp, k.mhdt, ls + k.rdt));
  }
}

// Degrees with a compile-time instance; wider tables take the run-time one.
constexpr int kMaxStaticDegree = 12;
constexpr int kRuntimeDegree = -1;

// f(std::integral_constant<int, D>{}) for the local-vol instance of
// ``degree``: D == degree when degree <= kMaxStaticDegree, else
// kRuntimeDegree. Host code: f launches the instance.
template <int D = 0, typename F>
int with_degree(int degree, F&& f) {
  if constexpr (D <= kMaxStaticDegree) {
    if (degree != D) return with_degree<D + 1>(degree, f);
    return f(std::integral_constant<int, D>{});
  } else {
    return f(std::integral_constant<int, kRuntimeDegree>{});
  }
}

// Local-vol constants, folded on the host from LvConsts (log_s0, r, dt,
// sqrt_dt, log_k, m_center, inv_m_half; ops/cuda_localvol._consts).
struct LvK {
  float log_s0, u0, neg_inv_m_half, rdt, mhdt, sqrt_dt;
};

inline LvK lv_fold(const float* c) {
  return LvK{c[0], ((c[4] - c[0]) - c[5]) * c[6], -c[6], c[1] * c[2], -0.5f * c[2], c[3]};
}

// Row groups of 4 floats in a padded table row of degree d.
__host__ __device__ constexpr int row_groups(int degree) { return degree / 4 + 1; }

// One Clenshaw step b_k = c_k + 2u b_{k+1} - b_{k+2}; (b1, b2) <- (b_k, b1).
__device__ __forceinline__ void clenshaw(float& b1, float& b2, float two_u, float c) {
  const float b0 = fmaf(two_u, b1, c - b2);
  b2 = b1;
  b1 = b0;
}

// One step of the kP (1 or 2) mirror paths' x = log S - log S0, the row
// read once for both; sz = sqrt(dt) z of the first path, -sz for its mirror.
template <int D, int kP>
__device__ __forceinline__ void lv_step(float (&ls)[2], float sz, const float4* __restrict__ row,
                                        int groups, const LvK& k) {
  float u[kP], two_u[kP], b1[kP], b2[kP];
#pragma unroll
  for (int p = 0; p < kP; ++p) {
    u[p] = fminf(fmaxf(fmaf(k.neg_inv_m_half, ls[p], k.u0), -1.0f), 1.0f);
    two_u[p] = u[p] + u[p];
    b1[p] = 0.0f;
    b2[p] = 0.0f;
  }
  float c0 = 0.0f;
  if constexpr (D != kRuntimeDegree) {
    constexpr int kG = row_groups(D);
    float c[4 * kG];
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      const float4 q = __ldg(row + g);
      c[4 * g] = q.x;
      c[4 * g + 1] = q.y;
      c[4 * g + 2] = q.z;
      c[4 * g + 3] = q.w;
    }
#pragma unroll
    for (int i = D; i >= 1; --i) {
#pragma unroll
      for (int p = 0; p < kP; ++p) clenshaw(b1[p], b2[p], two_u[p], c[i]);
    }
    c0 = c[0];
  } else {
    // the zero columns above the degree keep b1 = b2 = 0 exactly
    for (int g = groups - 1; g >= 0; --g) {
      const float4 q = __ldg(row + g);
#pragma unroll
      for (int p = 0; p < kP; ++p) {
        clenshaw(b1[p], b2[p], two_u[p], q.w);
        clenshaw(b1[p], b2[p], two_u[p], q.z);
        clenshaw(b1[p], b2[p], two_u[p], q.y);
        if (g > 0) clenshaw(b1[p], b2[p], two_u[p], q.x);
      }
      c0 = q.x;
    }
  }
#pragma unroll
  for (int p = 0; p < kP; ++p) {
    const float sig = fmaxf(fmaf(u[p], b1[p], c0 - b2[p]), 1e-6f);
    ls[p] += fmaf(sig, fmaf(sig, k.mhdt, p ? -sz : sz), k.rdt);
  }
}

// The draw schedule of the local-vol kernels (terminal.cu, localvol_paths.cu):
// n_steps lv_steps of slot (j, global_tile) over the padded table from
// ``row``, one Philox call and two SFU Box-Mullers serving four steps (4d..4d+3
// take (x, y) cos, (x, y) sin, (z, w) cos, (z, w) sin of draw d), with no
// per-step branch, and a tail for n_steps % 4. after_step() runs after each
// step: the paths kernel stores its row there, the terminal kernel nothing.
template <int D, int kP, typename F>
__device__ __forceinline__ void lv_walk(float (&ls)[2], const float4* __restrict__ row,
                                        int groups, const LvK& k, const PhiloxKeys& keys,
                                        uint32_t j, uint32_t global_tile, int n_steps,
                                        F&& after_step) {
  auto step = [&](float z) {
    lv_step<D, kP>(ls, k.sqrt_dt * z, row, groups, k);
    row += groups;
    after_step();
  };
  const int n_draws = n_steps >> 2;
#pragma unroll 1
  for (int d = 0; d < n_draws; ++d) {
    const Words w = philox_keyed(Words{j, static_cast<uint32_t>(d), global_tile, 0u}, keys);
    float z0, z1, z2, z3;
    box_muller_fast(w.x, w.y, z0, z1);
    box_muller_fast(w.z, w.w, z2, z3);
    step(z0);
    step(z1);
    step(z2);
    step(z3);
  }
  if (const int rem = n_steps & 3) {
    const Words w =
        philox_keyed(Words{j, static_cast<uint32_t>(n_draws), global_tile, 0u}, keys);
    float z0, z1;
    box_muller_fast(w.x, w.y, z0, z1);
    step(z0);
    if (rem > 1) step(z1);
    if (rem > 2) {
      box_muller_fast(w.z, w.w, z0, z1);
      step(z0);
    }
  }
}

// The variance chain's arithmetic, as in heston_qe.cu: never contracted.
__device__ __forceinline__ float fadd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float fsub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float fmul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float fdiv(float a, float b) { return __fdiv_rn(a, b); }

// The QE-M constants of a QeConsts row (log_s0, r_dt, theta, v0, ekt, c1,
// c2, K1, K2, K3, K4, A, k0_shift), with K1 - k0_shift folded for the log-S
// chain.
struct QeK {
  float log2_s0, r_dt, theta, v0, ekt, c1, c2, K1s, K2, K3, K4, A;
};

__host__ __device__ __forceinline__ QeK qe_fold(const float* c) {
  return QeK{c[0] * kLog2e, c[1], c[2], c[3], c[4], c[5], c[6], c[7] - c[12],
             c[8], c[9], c[10], c[11]};
}

// qe_fold of a row in device memory.
__device__ __forceinline__ QeK qe_consts(const float* __restrict__ row) {
  float c[13];
#pragma unroll
  for (int i = 0; i < 13; ++i) c[i] = __ldg(row + i);
  return qe_fold(c);
}

// qe_step of heston_qe.cu with its log-S chain on the fast pipes.
__device__ __forceinline__ void qe_step(float& log_s, float& v, float z_v, float z_s,
                                        float u, const QeK& p) {
  const float m = fadd(p.theta, fmul(fsub(v, p.theta), p.ekt));
  const float s2 = fadd(fmul(v, p.c1), p.c2);
  const float psi = fdiv(s2, fmaxf(fmul(m, m), 1e-20f));
  float v_new, k0;
  if (psi <= 1.5f) {
    const float two_over = fdiv(2.0f, fmaxf(psi, 1e-12f));
    const float b2 = fmaxf(fadd(fsub(two_over, 1.0f),
                                fmul(sqrtf(fmaxf(two_over, 0.0f)),
                                     sqrtf(fmaxf(fsub(two_over, 1.0f), 0.0f)))),
                           0.0f);
    const float a = fdiv(m, fadd(1.0f, b2));
    const float bz = fadd(sqrtf(b2), z_v);
    v_new = fmul(a, fmul(bz, bz));
    // log-S chain: k0 = -A a b^2 / (1 - 2 A a) + log(1 - 2 A a) / 2
    const float Aa = p.A * a;
    const float one_m = fmaxf(fmaf(-2.0f, Aa, 1.0f), 1e-6f);
    k0 = fmaf(0.5f * kLn2, lg2_approx(one_m), __fdividef(-Aa * b2, one_m));
  } else {
    const float q = fminf(fmaxf(fdiv(fsub(psi, 1.0f), fadd(psi, 1.0f)), 0.0f), 1.0f - 1e-7f);
    const float one_q = fsub(1.0f, q);
    const float beta = fdiv(one_q, fmaxf(m, 1e-20f));
    v_new = (u <= q) ? 0.0f
                     : fdiv(logf(fdiv(one_q, fmaxf(fsub(1.0f, u), 1e-12f))),
                            fmaxf(beta, 1e-20f));
    // log-S chain: k0 = -log(q + beta (1 - q) / (beta - A))
    k0 = -kLn2 * lg2_approx(
                     fmaxf(q + __fdividef(beta * one_q, fmaxf(beta - p.A, 1e-12f)), 1e-12f));
  }
  // log S + r dt + K0* + K1 v + K2 v_new + sqrt(K3 v + K4 v_new) z_s,
  // K0* = k0 - (K1 + K3/2) v folded into K1s
  const float drift = fmaf(p.K1s, v, fmaf(p.K2, v_new, (log_s + p.r_dt) + k0));
  log_s = fmaf(sqrt_approx(fmaxf(fmaf(p.K3, v, p.K4 * v_new), 0.0f)), z_s, drift);
  v = v_new;
}

}  // namespace fast
}  // namespace omt
