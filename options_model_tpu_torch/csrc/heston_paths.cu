// Heston path kernels redesigned for Hopper (sm_90a): full-truncation Euler
// and QE-M, one launch over a batch of maturities.
//
// Replaces the Pallas TPU kernels
//   options_model_tpu/ops/pallas_heston.py  heston_paths_pallas    (_paths_kernel,
//                                                                   _paths_v_kernel)
//   options_model_tpu/ops/pallas_heston.py  heston_paths_qe_pallas (_qe_paths_kernel,
//                                                                   _qe_paths_v_kernel)
// and computes what they compute: per maturity the flat (n_steps+1, n_pad)
// S matrix, and v when asked, from the Philox stream of ops/philox.py
// (counter = (slot, draw, global tile, 0), the same words and the same draw
// per step as csrc/heston.cu and csrc/heston_qe.cu, which keep the first
// design of both kernels under omt_heston_paths and omt_heston_paths_qe).
// One thread owns one antithetic pair (or one path when antithetic is off)
// and carries (log S, v) of both mirror paths in registers.
//
// The grid covers n_mat maturities x n_tiles tiles x tile/2 slots. Maturity
// m reads row m of a (n_mat, 10) (Euler, HestonConsts) or (n_mat, 13) (QE,
// QeConsts) device array once, into registers; draws global tile
// first_tile + m n_tiles + local tile; and writes its own matrix at offset
// m (n_steps+1) n_pad of a (n_mat, n_steps+1, n_pad) output. A block never
// spans two maturities (a maturity's slots are a multiple of the block), so
// the row is read at a block-uniform address. The 64 maturities of a
// 16,384-path surface are one launch of 2^19 threads, where one maturity
// per launch gave 8,192 threads, 32 blocks for 132 SMs.
//
// What bounds it on the card, and what the design does about it:
// - Writes: 4 bytes per path-step, 8 with v (428 MB at 2^20 x 50, 0.128 ms
//   at 3.35 TB/s). Each step's row is one coalesced store per warp, with the
//   streaming hint (st.global.cs): nothing reads the matrix back here.
// - Instruction throughput. The first design ran a full Philox call with its key
//   schedule, an accurate Box-Muller (logf, sqrtf, sinf, cosf) and accurate
//   expf/sqrtf per step, and was held by arithmetic, not by its stores (its
//   storeless floor was ~75% of its time). Here:
//   * Philox's ten round keys are computed once per launch on the host and
//     read from the kernel's parameters (one 3-input XOR per word a round);
//   * Euler: the whole step may trade the last ulps, since full truncation
//     is continuous and no branch reads a rounding. The angle goes to the
//     SFU (__sincosf on 2 pi (u2 - 1/2) in [-pi, pi), signs flipped), the
//     radius uses lg2.approx above u1 = 2^-7 and the series
//     u + u^2/2 + u^3/3 below it (where lg2.approx's absolute error would
//     be large against log(1 - u1)), sqrt and the stored exp are the SFU's
//     sqrt.approx and ex2.approx, every multiply-add an FMA;
//   * QE-M: the variance chain (m, s2, psi, the branch, q, u <= q, v_new,
//     2/psi, b^2, a, the quadratic branch's sqrtf, the exponential branch's
//     logf) and the Box-Muller of z_v and z_s are those of heston_qe.cu
//     operation for operation, every add, multiply and divide an _rn
//     intrinsic, so V equals the plain version bit for bit and no path
//     changes branch. The log-S chain (k0 in both branches, K0*, the K1-K4
//     terms, sqrt(K3 v + K4 v_new) and the stored exp) feeds no branch and
//     no later v: FMAs, __fdividef, lg2.approx, sqrt.approx and ex2.approx.
// On an H100 at 2^20 x 50 with v (chip_smoke.py, PERF.md) the Euler kernel
// writes at ~2.8 TB/s, ~83% of its byte bound, and its time loop is ~84
// SASS instructions a step; QE-M stays held by the exact variance chain it
// must keep (IEEE divides and square roots, the accurate Box-Muller, the
// divergent branch), at ~1/3 of its bound.
// The tolerances against the plain version are chip_smoke.py's (S rtol
// 1e-4; Euler v atol 1e-5 + rtol 1e-4; QE v exact). Built without
// --use_fast_math: the fast forms are named here, nowhere else.
#include <cstdint>

#include "heston_common.cuh"
#include "kernel_attrs.cuh"

namespace omt {
namespace paths {

// Threads per block and the minimum resident blocks per SM handed to
// __launch_bounds__, chosen from the registers and occupancy the card
// reports (cudaFuncGetAttributes, chip_smoke.py phase 5) and from timing
// other values on an H100: blocks of 128-512 threads and occupancies from
// 50% to 100% moved the time by no more than its spread from run to run, so
// the kernels are held by their stores and dependent chains, not by latency
// hiding. Euler asks for 6 blocks (40 registers, no spill, 75%); QE-M keeps
// ptxas's 48 registers (62.5%): at 6 or 8 blocks it spills, and at 8 it was
// the slowest.
constexpr int kBlock = 256;
constexpr int kEulerMinBlocks = 6;
constexpr int kQeMinBlocks = 1;
constexpr int kTile = kPathTile;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
static_assert((kTile / 2) % kBlock == 0, "a block must not span two maturities");

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

// The Euler step's constants, folded from row m of HestonConsts.
struct EulerK {
  float log2_s0, rdt, mhdt, ca, cb, xi_sdt, sqrt_dt, rho, rho_bar, v0;
};

__device__ __forceinline__ EulerK euler_consts(const float* __restrict__ row) {
  // row: log_s0, r, dt, sqrt_dt, kappa, theta, xi, rho, rho_bar, v0
  const float dt = __ldg(row + 2), sqrt_dt = __ldg(row + 3), kd = __ldg(row + 4) * dt;
  return EulerK{__ldg(row) * kLog2e, __ldg(row + 1) * dt, -0.5f * dt, 1.0f - kd,
                kd * __ldg(row + 5), __ldg(row + 6) * sqrt_dt, sqrt_dt, __ldg(row + 7),
                __ldg(row + 8), __ldg(row + 9)};
}

// v <- max(v+ (1 - kappa dt) + kappa theta dt + xi sqrt(dt v+) w2, 0),
// log S <- log S + r dt - v+ dt / 2 + sqrt(dt v+) z1: heston_step.
__device__ __forceinline__ void euler_step(float& ls, float& v, float z1, float w2,
                                           const EulerK& k) {
  const float vp = fmaxf(v, 0.0f);
  const float sv = sqrt_approx(vp);
  v = fmaxf(fmaf(k.xi_sdt * sv, w2, fmaf(vp, k.ca, k.cb)), 0.0f);
  ls = fmaf(k.sqrt_dt * sv, z1, fmaf(vp, k.mhdt, ls + k.rdt));
}

// Row of both mirror paths: S = 2^(log2 S0 + log S / ln 2), and v.
template <bool kAnti, bool kV>
__device__ __forceinline__ void store_row(float* s, float* vv, float ls_a, float v_a,
                                          float ls_b, float v_b, float log2_s0) {
  __stcs(s, ex2_approx(fmaf(ls_a, kLog2e, log2_s0)));
  if (kAnti) __stcs(s + kTile / 2, ex2_approx(fmaf(ls_b, kLog2e, log2_s0)));
  if (kV) {
    __stcs(vv, v_a);
    if (kAnti) __stcs(vv + kTile / 2, v_b);
  }
}

// Where a slot's maturity, tile and columns lie; false past the grid.
struct Slot {
  int m;
  uint32_t j, global_tile;
  size_t offset, n_pad;
};

template <bool kAnti>
__device__ __forceinline__ bool locate(Slot& s, int first_tile, int n_tiles, int n_steps,
                                       int n_mat) {
  constexpr int kWidth = kAnti ? kTile / 2 : kTile;
  const long long per_mat = static_cast<long long>(n_tiles) * kWidth;
  const long long slot = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (slot >= per_mat * n_mat) return false;
  s.m = static_cast<int>(slot / per_mat);
  const long long rem = slot - s.m * per_mat;
  const int local_tile = static_cast<int>(rem / kWidth);
  s.j = static_cast<uint32_t>(rem % kWidth);
  s.global_tile = static_cast<uint32_t>(first_tile + s.m * n_tiles + local_tile);
  s.n_pad = static_cast<size_t>(n_tiles) * kTile;
  s.offset = static_cast<size_t>(s.m) * (n_steps + 1) * s.n_pad +
             static_cast<size_t>(local_tile) * kTile + s.j;
  return true;
}

template <bool kAnti, bool kV>
__global__ void __launch_bounds__(kBlock, kEulerMinBlocks)
euler_paths_kernel(float* __restrict__ S, float* __restrict__ V,
                   const float* __restrict__ consts, const __grid_constant__ PhiloxKeys keys,
                   int first_tile, int n_tiles, int n_steps, int n_mat) {
  Slot at;
  if (!locate<kAnti>(at, first_tile, n_tiles, n_steps, n_mat)) return;
  const EulerK k = euler_consts(consts + 10 * at.m);
  float* s = S + at.offset;
  float* vv = kV ? V + at.offset : nullptr;
  float ls_a = 0.0f, v_a = k.v0, ls_b = 0.0f, v_b = k.v0;
  store_row<kAnti, kV>(s, vv, ls_a, v_a, ls_b, v_b, k.log2_s0);

  // Normals 2d and 2d+1 of a slot are word pairs (x, y) and (z, w) of draw d.
  auto step = [&](uint32_t b1, uint32_t b2) {
    float z1, z2;
    box_muller_fast(b1, b2, z1, z2);
    const float w2 = fmaf(k.rho, z1, k.rho_bar * z2);
    euler_step(ls_a, v_a, z1, w2, k);
    if (kAnti) euler_step(ls_b, v_b, -z1, -w2, k);
    s += at.n_pad;
    if (kV) vv += at.n_pad;
    store_row<kAnti, kV>(s, vv, ls_a, v_a, ls_b, v_b, k.log2_s0);
  };
  const int n_draws = n_steps >> 1;
  for (int d = 0; d < n_draws; ++d) {
    const Words w = philox_keyed(Words{at.j, static_cast<uint32_t>(d), at.global_tile, 0u},
                                 keys);
    step(w.x, w.y);
    step(w.z, w.w);
  }
  if (n_steps & 1) {
    const Words w = philox_keyed(
        Words{at.j, static_cast<uint32_t>(n_draws), at.global_tile, 0u}, keys);
    step(w.x, w.y);
  }
}

// The variance chain's arithmetic, as in heston_qe.cu: never contracted.
__device__ __forceinline__ float fadd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float fsub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float fmul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float fdiv(float a, float b) { return __fdiv_rn(a, b); }

// The QE-M constants of row m of QeConsts (log_s0, r_dt, theta, v0, ekt, c1,
// c2, K1, K2, K3, K4, A, k0_shift), with K1 - k0_shift folded for the log-S
// chain.
struct QeK {
  float log2_s0, r_dt, theta, v0, ekt, c1, c2, K1s, K2, K3, K4, A;
};

__device__ __forceinline__ QeK qe_consts(const float* __restrict__ row) {
  return QeK{__ldg(row) * kLog2e, __ldg(row + 1), __ldg(row + 2), __ldg(row + 3),
             __ldg(row + 4), __ldg(row + 5), __ldg(row + 6), __ldg(row + 7) - __ldg(row + 12),
             __ldg(row + 8), __ldg(row + 9), __ldg(row + 10), __ldg(row + 11)};
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

template <bool kAnti, bool kV>
__global__ void __launch_bounds__(kBlock, kQeMinBlocks)
qe_paths_kernel(float* __restrict__ S, float* __restrict__ V, const float* __restrict__ consts,
                const __grid_constant__ PhiloxKeys keys, int first_tile, int n_tiles,
                int n_steps, int n_mat) {
  Slot at;
  if (!locate<kAnti>(at, first_tile, n_tiles, n_steps, n_mat)) return;
  const QeK p = qe_consts(consts + 13 * at.m);
  float* s = S + at.offset;
  float* vv = kV ? V + at.offset : nullptr;
  float ls_a = 0.0f, v_a = p.v0, ls_b = 0.0f, v_b = p.v0;
  store_row<kAnti, kV>(s, vv, ls_a, v_a, ls_b, v_b, p.log2_s0);
  for (int t = 0; t < n_steps; ++t) {
    const Words w = philox_keyed(Words{at.j, static_cast<uint32_t>(t), at.global_tile, 0u},
                                 keys);
    float z_v, z_s;
    box_muller(w.x, w.y, z_v, z_s);
    const float u = uniform_from_bits(w.z);
    qe_step(ls_a, v_a, z_v, z_s, u, p);
    if (kAnti) qe_step(ls_b, v_b, -z_v, -z_s, fsub(1.0f, u), p);
    s += at.n_pad;
    if (kV) vv += at.n_pad;
    store_row<kAnti, kV>(s, vv, ls_a, v_a, ls_b, v_b, p.log2_s0);
  }
}

template <bool kAnti, bool kV>
int launch(int scheme, float* S, float* V, const float* consts, const PhiloxKeys& keys,
           int first_tile, int n_tiles, int n_steps, int n_mat, cudaStream_t stream) {
  const long long n_slots =
      static_cast<long long>(n_mat) * n_tiles * (kAnti ? kTile / 2 : kTile);
  const unsigned int grid = static_cast<unsigned int>((n_slots + kBlock - 1) / kBlock);
  if (scheme == 0) {
    euler_paths_kernel<kAnti, kV><<<grid, kBlock, 0, stream>>>(S, V, consts, keys, first_tile,
                                                                n_tiles, n_steps, n_mat);
  } else {
    qe_paths_kernel<kAnti, kV><<<grid, kBlock, 0, stream>>>(S, V, consts, keys, first_tile,
                                                             n_tiles, n_steps, n_mat);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace paths
}  // namespace omt

extern "C" {

// S, V: device (n_mat, n_steps+1, n_tiles*4096) float32, V may be null.
// consts: device (n_mat, 10) float32 HestonConsts rows (scheme 0, Euler) or
// (n_mat, 13) QeConsts rows (scheme 1, QE-M).
int omt_heston_paths_batched(void* S, void* V, const void* consts, uint64_t seed,
                             int first_tile, int n_tiles, int n_steps, int n_mat,
                             int antithetic, int scheme, void* stream) {
  using namespace omt::paths;
  if ((scheme != 0 && scheme != 1) || n_mat < 1 || n_tiles < 1 || n_steps < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const PhiloxKeys keys = philox_keys(seed);
  float* s = static_cast<float*>(S);
  float* v = static_cast<float*>(V);
  const float* c = static_cast<const float*>(consts);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (antithetic) {
    return v ? launch<true, true>(scheme, s, v, c, keys, first_tile, n_tiles, n_steps, n_mat, st)
             : launch<true, false>(scheme, s, v, c, keys, first_tile, n_tiles, n_steps, n_mat,
                                   st);
  }
  return v ? launch<false, true>(scheme, s, v, c, keys, first_tile, n_tiles, n_steps, n_mat, st)
           : launch<false, false>(scheme, s, v, c, keys, first_tile, n_tiles, n_steps, n_mat,
                                  st);
}

// out[4]: registers, spill bytes, blocks per SM, block threads of the
// antithetic kernel with v (the pricing paths' instance) of ``scheme``.
int omt_heston_paths_batched_attrs(int scheme, int* out) {
  using namespace omt::paths;
  return scheme == 0 ? omt::kernel_attrs(euler_paths_kernel<true, true>, kBlock, out)
                     : omt::kernel_attrs(qe_paths_kernel<true, true>, kBlock, out);
}

}  // extern "C"
