// SABR kernels for Hopper (sm_90a): forward (and vol) paths (kernel 23) and
// terminal forwards (kernel 24, a beta = 1 redesign beside its first
// design), with the frozen-vol control variate's forward on request.
//
// The JAX package simulates SABR in XLA code, not in Pallas:
//   options_model_tpu/models/sabr.py:90       simulate_sabr (return_paths True:
//                                             sabr_paths_kernel, False: sabr_terminal_kernel)
//   options_model_tpu/models/sabr.py:211-236  sabr_european_mc's scan that carries the
//                                             nu = 0 forward beside F (sabr_terminal_kernel's G_T)
// The port's stream is Philox on the main stream's counters (word 3 = 0),
// one call per antithetic pair and step: (w0, w1) -> Box-Muller -> (z1,
// z2), the mirror taking (-z1, -z2) (ops/philox.sabr_path_draws); the
// plain versions are ops/cuda_sabr.py's, on models/sabr.sabr_from_draws.
//
// One thread owns one pair (or one path). w1 = z1, w2 = rho z1 + rho_bar z2;
// alpha takes its exact lognormal step alpha exp(nu sqrt(dt) w2 - nu^2
// dt/2); the state takes log-Euler on log F (kLog, beta = 1) or the
// absorbing Euler step on F (beta < 1: 0 once it is <= 0, else max(F +
// alpha F^beta sqrt(dt) w1, 0), F^beta = exp(beta log F)). beta = 1 and
// beta < 1 are compile-time instances, as the reference branches on
// float(beta).
//
// Whether a path is absorbed must not depend on the device, so kernel 23
// and kernel 24's first design (sabr_terminal_first_kernel) take
// philox.cuh's accurate Box-Muller (sine and cosine bit-equal to
// sinf/cosf), libdevice's logf and expf, and __f*_rn intrinsics in the
// plain version's order (nvcc never contracts them): on the card the
// states follow the plain version's operations one for one. The beta < 1
// instance of kernel 24 stays that code.
//
// What bounds them: kernel 23 writes 4 bytes a path-step (8 with alpha:
// 0.1277 ms at 2^20 x 50 and 3.35 TB/s); kernel 24 writes 4 bytes a path
// (8 with G_T) and is held by its per-step work: half a Philox call (~20
// integer instructions) a path-step and, in the first design, a sincos,
// two logf and two expf, ~105 issue slots a path-step. Its beta = 1
// instance decides nothing (log-Euler absorbs no path), so the redesign
// (sabr_terminal_kernel) takes the fast pipes there: the SFU Box-Muller,
// ex2 for the vol step and the final exps, FMAs in the log-Euler walk,
// kept in log2 units, and the control variate's log-Euler walk as
// log F0 - n alpha0^2 dt / 2 + alpha0 sqrt(dt) sum z1, the sum of the same
// z1 that drive F. Its round keys are computed once and its stream's pair
// layout is the first design's.
#include "hopper_fast.cuh"
#include "kernel_attrs.cuh"

namespace omt {
namespace sabr {

using fast::PhiloxKeys;
using fast::philox_keyed;

constexpr int kPathTile = 4096;
constexpr int kTerminalTile = 16384;
constexpr int kBlock = 128;

// ops/cuda_sabr.SABR_FIELDS, in order.
struct SabrK {
  float s0, alpha0, rho, rho_bar, dt, sqrt_dt, nu_sqrt_dt, half_nu2_dt, beta, log_f0, cv_drift,
      cv_diffusion;
};

// models/sabr.sabr_step, operation for operation.
template <bool kLog>
__device__ __forceinline__ float sabr_step(float s, float a, float w1, const SabrK& k) {
  if (kLog) {
    const float drift = __fmul_rn(__fmul_rn(0.5f, __fmul_rn(a, a)), k.dt);
    return __fadd_rn(__fsub_rn(s, drift), __fmul_rn(__fmul_rn(a, k.sqrt_dt), w1));
  }
  if (s <= 0.0f) return 0.0f;
  const float f_beta = expf(__fmul_rn(k.beta, logf(s)));
  return fmaxf(__fadd_rn(s, __fmul_rn(__fmul_rn(__fmul_rn(a, f_beta), k.sqrt_dt), w1)), 0.0f);
}

__device__ __forceinline__ float alpha_step(float a, float z1, float z2, const SabrK& k) {
  const float w2 = __fadd_rn(__fmul_rn(k.rho, z1), __fmul_rn(k.rho_bar, z2));
  return __fmul_rn(a, expf(__fsub_rn(__fmul_rn(k.nu_sqrt_dt, w2), k.half_nu2_dt)));
}

template <bool kLog>
__device__ __forceinline__ float to_forward(float s) {
  return kLog ? expf(s) : s;
}

// Kernel 23. F, alpha: (n_steps+1, n_pad); alpha may be null.
template <bool kLog, bool kAnti>
__global__ void __launch_bounds__(kBlock)
sabr_paths_kernel(float* __restrict__ F, float* __restrict__ alpha, const SabrK k,
                  const __grid_constant__ PhiloxKeys keys, int first_tile, int n_tiles,
                  int n_steps) {
  constexpr int kWidth = kAnti ? kPathTile / 2 : kPathTile;
  const long long slot = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (slot >= static_cast<long long>(n_tiles) * kWidth) return;
  const int local_tile = static_cast<int>(slot / kWidth);
  const uint32_t j = static_cast<uint32_t>(slot % kWidth);
  const uint32_t tile = static_cast<uint32_t>(first_tile + local_tile);
  const size_t n_pad = static_cast<size_t>(n_tiles) * kPathTile;
  const size_t col = static_cast<size_t>(local_tile) * kPathTile + j;

  float sa = k.s0, sb = k.s0, aa = k.alpha0, ab = k.alpha0;
  F[col] = to_forward<kLog>(sa);
  if (kAnti) F[col + kWidth] = to_forward<kLog>(sb);
  if (alpha != nullptr) {
    alpha[col] = aa;
    if (kAnti) alpha[col + kWidth] = ab;
  }
#pragma unroll 1
  for (int t = 0; t < n_steps; ++t) {
    const Words w = philox_keyed(Words{j, static_cast<uint32_t>(t), tile, 0u}, keys);
    float z1, z2;
    box_muller_stream(w.x, w.y, z1, z2);
    const size_t row = static_cast<size_t>(t + 1) * n_pad + col;
    sa = sabr_step<kLog>(sa, aa, z1, k);
    aa = alpha_step(aa, z1, z2, k);
    F[row] = to_forward<kLog>(sa);
    if (alpha != nullptr) alpha[row] = aa;
    if (kAnti) {
      sb = sabr_step<kLog>(sb, ab, -z1, k);
      ab = alpha_step(ab, -z1, -z2, k);
      F[row + kWidth] = to_forward<kLog>(sb);
      if (alpha != nullptr) alpha[row + kWidth] = ab;
    }
  }
}

// Kernel 24's first design. F_T, alpha_T, G_T: (n_pad,); alpha_T and G_T
// may be null. G_T is exp(g_T), g the nu = 0 lognormal forward's log-Euler
// walk from log F0 on the same w1.
template <bool kLog, bool kAnti>
__global__ void __launch_bounds__(kBlock)
sabr_terminal_first_kernel(float* __restrict__ F_T, float* __restrict__ alpha_T,
                     float* __restrict__ G_T, const SabrK k,
                     const __grid_constant__ PhiloxKeys keys, int first_tile, int n_tiles,
                     int n_steps) {
  constexpr int kWidth = kAnti ? kTerminalTile / 2 : kTerminalTile;
  const long long slot = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (slot >= static_cast<long long>(n_tiles) * kWidth) return;
  const int local_tile = static_cast<int>(slot / kWidth);
  const uint32_t j = static_cast<uint32_t>(slot % kWidth);
  const uint32_t tile = static_cast<uint32_t>(first_tile + local_tile);
  const size_t col = static_cast<size_t>(local_tile) * kTerminalTile + j;
  const bool cv = G_T != nullptr;

  float sa = k.s0, sb = k.s0, aa = k.alpha0, ab = k.alpha0, ga = k.log_f0, gb = k.log_f0;
#pragma unroll 1
  for (int t = 0; t < n_steps; ++t) {
    const Words w = philox_keyed(Words{j, static_cast<uint32_t>(t), tile, 0u}, keys);
    float z1, z2;
    box_muller_stream(w.x, w.y, z1, z2);
    sa = sabr_step<kLog>(sa, aa, z1, k);
    aa = alpha_step(aa, z1, z2, k);
    if (cv) ga = __fadd_rn(__fsub_rn(ga, k.cv_drift), __fmul_rn(k.cv_diffusion, z1));
    if (kAnti) {
      sb = sabr_step<kLog>(sb, ab, -z1, k);
      ab = alpha_step(ab, -z1, -z2, k);
      if (cv) gb = __fadd_rn(__fsub_rn(gb, k.cv_drift), __fmul_rn(k.cv_diffusion, -z1));
    }
  }
  F_T[col] = to_forward<kLog>(sa);
  if (alpha_T != nullptr) alpha_T[col] = aa;
  if (cv) G_T[col] = expf(ga);
  if (kAnti) {
    F_T[col + kWidth] = to_forward<kLog>(sb);
    if (alpha_T != nullptr) alpha_T[col + kWidth] = ab;
    if (cv) G_T[col + kWidth] = expf(gb);
  }
}

// Kernel 24's beta = 1 redesign: SabrK folded on the host into log2 units
// (y = log2 F) for ex2: y0 = log2 F0, the step y += alpha^2 kb + alpha ka
// z1, the vol factor 2^(kc w2 + kd), and the control variate's
// log2 G_T = g0 + cv z1-sum.
struct SabrLogK {
  float y0, kb, ka, kc, kd, rho, rho_bar, alpha0, g0, cv;
};

// Kernel 24's beta = 1 redesign, the first design's grid, outputs and
// stream (header).
template <bool kAnti>
__global__ void __launch_bounds__(kBlock)
sabr_terminal_kernel(float* __restrict__ F_T, float* __restrict__ alpha_T,
                     float* __restrict__ G_T, const SabrLogK k,
                     const __grid_constant__ PhiloxKeys keys, int first_tile, int n_tiles,
                     int n_steps) {
  constexpr int kWidth = kAnti ? kTerminalTile / 2 : kTerminalTile;
  const long long slot = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (slot >= static_cast<long long>(n_tiles) * kWidth) return;
  const int local_tile = static_cast<int>(slot / kWidth);
  const uint32_t j = static_cast<uint32_t>(slot % kWidth);
  const uint32_t tile = static_cast<uint32_t>(first_tile + local_tile);
  const size_t col = static_cast<size_t>(local_tile) * kTerminalTile + j;

  float ya = k.y0, yb = k.y0, aa = k.alpha0, ab = k.alpha0, zsum = 0.0f;
#pragma unroll 1
  for (int t = 0; t < n_steps; ++t) {
    const Words w = philox_keyed(Words{j, static_cast<uint32_t>(t), tile, 0u}, keys);
    float z1, z2;
    fast::box_muller_fast(w.x, w.y, z1, z2);
    const float e = k.kc * fmaf(k.rho, z1, k.rho_bar * z2);
    ya = fmaf(aa * k.ka, z1, fmaf(aa * aa, k.kb, ya));
    aa *= fast::ex2_approx(e + k.kd);
    if (kAnti) {
      yb = fmaf(ab * k.ka, -z1, fmaf(ab * ab, k.kb, yb));
      ab *= fast::ex2_approx(k.kd - e);
    }
    zsum += z1;
  }
  F_T[col] = fast::ex2_approx(ya);
  if (alpha_T != nullptr) alpha_T[col] = aa;
  if (G_T != nullptr) G_T[col] = fast::ex2_approx(fmaf(k.cv, zsum, k.g0));
  if (kAnti) {
    F_T[col + kWidth] = fast::ex2_approx(yb);
    if (alpha_T != nullptr) alpha_T[col + kWidth] = ab;
    if (G_T != nullptr) G_T[col + kWidth] = fast::ex2_approx(fmaf(-k.cv, zsum, k.g0));
  }
}

inline SabrLogK log_fold(const SabrK& k, int n_steps) {
  const double l2e = 1.4426950408889634;
  return SabrLogK{static_cast<float>(k.s0 * l2e),
                  static_cast<float>(-0.5 * k.dt * l2e),
                  static_cast<float>(k.sqrt_dt * l2e),
                  static_cast<float>(k.nu_sqrt_dt * l2e),
                  static_cast<float>(-k.half_nu2_dt * l2e),
                  k.rho,
                  k.rho_bar,
                  k.alpha0,
                  static_cast<float>((k.log_f0 - static_cast<double>(n_steps) * k.cv_drift) * l2e),
                  static_cast<float>(k.cv_diffusion * l2e)};
}

inline unsigned int blocks_for(long long n_threads) {
  return static_cast<unsigned int>((n_threads + kBlock - 1) / kBlock);
}

// One launch of a kernel-24 design on its constants ``k``.
template <typename Kernel, typename Consts>
int launch_terminal(Kernel kernel, const Consts& k, void* F_T, void* alpha_T, void* G_T,
                    uint64_t seed, int first_tile, int n_tiles, int n_steps, int antithetic,
                    void* stream) {
  const long long n_slots =
      static_cast<long long>(n_tiles) * (antithetic ? kTerminalTile / 2 : kTerminalTile);
  kernel<<<blocks_for(n_slots), kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(F_T), static_cast<float*>(alpha_T), static_cast<float*>(G_T), k,
      omt::fast::philox_keys(seed), first_tile, n_tiles, n_steps);
  return static_cast<int>(cudaGetLastError());
}

inline bool consts_from(const void* host, SabrK& k) {
  const float* c = static_cast<const float*>(host);
  k = SabrK{c[0], c[1], c[2], c[3], c[4], c[5], c[6], c[7], c[8], c[9], c[10], c[11]};
  return k.beta >= 0.0f && k.beta <= 1.0f;
}

}  // namespace sabr
}  // namespace omt

extern "C" {

// F and alpha: device (n_steps+1, n_tiles*4096) float32, alpha may be null;
// consts: host pointer to the 12 floats of SabrK.
int omt_sabr_paths(void* F, void* alpha, const void* consts, uint64_t seed, int first_tile,
                   int n_tiles, int n_steps, int antithetic, void* stream) {
  using namespace omt::sabr;
  SabrK k;
  if (n_tiles < 1 || n_steps < 1 || !consts_from(consts, k)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool lg = k.beta == 1.0f;
  auto kernel = antithetic ? (lg ? sabr_paths_kernel<true, true> : sabr_paths_kernel<false, true>)
                           : (lg ? sabr_paths_kernel<true, false> : sabr_paths_kernel<false, false>);
  const long long n_slots =
      static_cast<long long>(n_tiles) * (antithetic ? kPathTile / 2 : kPathTile);
  kernel<<<blocks_for(n_slots), kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(F), static_cast<float*>(alpha), k, omt::fast::philox_keys(seed),
      first_tile, n_tiles, n_steps);
  return static_cast<int>(cudaGetLastError());
}

// F_T, alpha_T, G_T: device (n_tiles*16384,) float32, the last two may be
// null; consts: host pointer to the 12 floats of SabrK. Kernel 24's
// redesign at beta = 1; at beta < 1 its first design's exact instance.
int omt_sabr_terminal(void* F_T, void* alpha_T, void* G_T, const void* consts, uint64_t seed,
                      int first_tile, int n_tiles, int n_steps, int antithetic, void* stream) {
  using namespace omt::sabr;
  SabrK k;
  if (n_tiles < 1 || n_steps < 1 || !consts_from(consts, k)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (k.beta != 1.0f) {
    return launch_terminal(antithetic ? sabr_terminal_first_kernel<false, true>
                                      : sabr_terminal_first_kernel<false, false>,
                           k, F_T, alpha_T, G_T, seed, first_tile, n_tiles, n_steps, antithetic,
                           stream);
  }
  return launch_terminal(antithetic ? sabr_terminal_kernel<true> : sabr_terminal_kernel<false>,
                         log_fold(k, n_steps), F_T, alpha_T, G_T, seed, first_tile, n_tiles,
                         n_steps, antithetic, stream);
}

// omt_sabr_terminal through kernel 24's first design at every beta.
int omt_sabr_terminal_first(void* F_T, void* alpha_T, void* G_T, const void* consts,
                            uint64_t seed, int first_tile, int n_tiles, int n_steps,
                            int antithetic, void* stream) {
  using namespace omt::sabr;
  SabrK k;
  if (n_tiles < 1 || n_steps < 1 || !consts_from(consts, k)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool lg = k.beta == 1.0f;
  auto kernel = antithetic ? (lg ? sabr_terminal_first_kernel<true, true>
                                 : sabr_terminal_first_kernel<false, true>)
                           : (lg ? sabr_terminal_first_kernel<true, false>
                                 : sabr_terminal_first_kernel<false, false>);
  return launch_terminal(kernel, k, F_T, alpha_T, G_T, seed, first_tile, n_tiles, n_steps,
                         antithetic, stream);
}

// out[4]: registers, spill bytes, blocks per SM, block threads of ``which``:
// 0 kernel 23 beta = 1, 1 kernel 23 beta < 1, 2 kernel 24's redesign (beta =
// 1), 3 kernel 24 beta < 1 (the first design's instance, both entries'), 4
// kernel 24's first design at beta = 1 (antithetic instances).
int omt_sabr_attrs(int which, int* out) {
  using namespace omt::sabr;
  switch (which) {
    case 0: return omt::kernel_attrs(sabr_paths_kernel<true, true>, kBlock, out);
    case 1: return omt::kernel_attrs(sabr_paths_kernel<false, true>, kBlock, out);
    case 2: return omt::kernel_attrs(sabr_terminal_kernel<true>, kBlock, out);
    case 3: return omt::kernel_attrs(sabr_terminal_first_kernel<false, true>, kBlock, out);
    case 4: return omt::kernel_attrs(sabr_terminal_first_kernel<true, true>, kBlock, out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
