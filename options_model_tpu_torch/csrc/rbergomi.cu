// Rough Bergomi kernels for Hopper (sm_90a): the hybrid scheme's Brownian
// increments (kernel 25) and its walk (kernel 26).
//
// The JAX package simulates rBergomi in XLA code, not in Pallas:
//   options_model_tpu/models/rbergomi.py:114  simulate_rbergomi (sim_block, :169-217)
//   options_model_tpu/models/rbergomi.py:222  terminal_cv_core (:251-276)
// with jax.random normals for the three draws of a step. The port's stream
// is Philox on counter word 3 = 4 (ops/philox.py states it: draw 2t gives
// the Volterra Brownian's z1, draw 2t + 1 gives (z2, zp), all mirrored within the
// tile), so each piece is a kernel here with a plain PyTorch version on the
// same counters (ops/cuda_rbergomi.py).
//
// - rbergomi_dw_kernel (kernel 25): dW[t, p] = sqrt(dt) z1, one thread a
//   (pair slot, step), writing the path and its mirror.
// - Between the two, G = W_mat dW: the strictly lower-triangular Volterra
//   sum, one float32 matrix product outside any kernel of this file
//   (models/rbergomi.volterra, torch.matmul with TF32 off), as the
//   reference leaves it to XLA.
// - rbergomi_paths_kernel<kMode, kAnti> (kernel 26): one thread a path,
//   walking the steps. It reads dW and G a step, redraws (z2, zp) on their
//   own counters, forms Y = sqrt(2H) ((G + c1 dW) + c2 z2), v = xi0 exp(eta
//   Y - comp) with comp the scheme's discrete variance, and the left-point
//   log-Euler step x += (r - v/2) dt + sqrt(v) (rho dW + rho_bar sqrt(dt)
//   zp). kMode 0 writes S and v (n_steps+1, P) and the dual state hist =
//   sqrt(2H) G (n_steps, P), each output optional; 1 writes S_T and v_T;
//   2 writes S_T and the control variate's G_T, the frozen-variance
//   lognormal on the same price Brownian.
//
// Every float operation is an _rn intrinsic in the plain version's order,
// with libdevice's expf and IEEE sqrtf, and no --use_fast_math: the outputs
// equal the plain version's on the card (chip_smoke.py R0 holds them to
// RB_RTOL and prints the largest difference).
//
// What bounds them: kernel 25 writes 4 bytes a path-step after one Philox
// call a pair-step; kernel 26 reads 8 bytes a path-step (dW, G) and writes
// 4 (S_T modes) to 12 (S, v, hist) after one Philox call and two
// transcendentals (expf, sqrtf) a path-step and expf once more a stored S:
// both are held by their bytes at the path's shapes. This first design
// stores dW and re-reads it with G (~0.8 GB at 2^20 x 50); fusing the
// Volterra sum into the walk (~n^2/2 multiply-adds a path) is held for a
// later redesign (ROADMAP).
#include "kernel_attrs.cuh"
#include "philox.cuh"

namespace omt {
namespace rb {

constexpr int kPathTile = 4096;
constexpr int kBlock = 128;
constexpr uint32_t kRbStream = 4u;
// ops/cuda_rbergomi.MAX_STEPS: the compensator's table goes by value.
constexpr int kMaxSteps = 512;

// The launch's constants (ops/cuda_rbergomi.RB_FIELDS order), then the
// compensator comp[k] = (eta^2 / 2) Var(Y_{t_k}), k = 0..n_steps.
struct RbK {
  float log_s0, r, dt, sqrt_dt, sqrt2H, c1, c2, eta, xi0, rho, rbsd, sig_cv, cv_drift;
  float n_comp;
  float comp[kMaxSteps + 1];
};

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }

__device__ __forceinline__ Words draw(uint32_t slot, uint32_t index, uint32_t global_tile,
                                      uint64_t seed) {
  return philox4x32_10(Words{slot, index, global_tile, kRbStream},
                       static_cast<uint32_t>(seed), static_cast<uint32_t>(seed >> 32));
}

template <bool kAnti>
__global__ void __launch_bounds__(kBlock)
rbergomi_dw_kernel(float* __restrict__ dW, float sqrt_dt, uint64_t seed, int first_tile,
                   int n_tiles) {
  constexpr int kWidth = kAnti ? kPathTile / 2 : kPathTile;
  const long long slot = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (slot >= static_cast<long long>(n_tiles) * kWidth) return;
  const int t = static_cast<int>(blockIdx.y);
  const int local_tile = static_cast<int>(slot / kWidth);
  const uint32_t j = static_cast<uint32_t>(slot % kWidth);
  const Words w = draw(j, 2u * static_cast<uint32_t>(t),
                       static_cast<uint32_t>(first_tile + local_tile), seed);
  float z1, unused;
  box_muller_stream(w.x, w.y, z1, unused);
  const float d = mul(sqrt_dt, z1);
  const size_t n_pad = static_cast<size_t>(n_tiles) * kPathTile;
  const size_t at = static_cast<size_t>(t) * n_pad + static_cast<size_t>(local_tile) * kPathTile + j;
  dW[at] = d;
  if (kAnti) dW[at + kWidth] = -d;
}

template <int kMode, bool kAnti>
__global__ void __launch_bounds__(kBlock)
rbergomi_paths_kernel(float* __restrict__ S, float* __restrict__ v, float* __restrict__ hist,
                      float* __restrict__ g_t, const float* __restrict__ dW,
                      const float* __restrict__ G, const __grid_constant__ RbK k, uint64_t seed,
                      int first_tile, int n_tiles, int n_steps) {
  constexpr int kWidth = kAnti ? kPathTile / 2 : kPathTile;
  const size_t n_pad = static_cast<size_t>(n_tiles) * kPathTile;
  const size_t p = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= n_pad) return;
  const int col = static_cast<int>(p % kPathTile);
  const uint32_t j = static_cast<uint32_t>(col % kWidth);
  const bool mirror = kAnti && col >= kWidth;
  const uint32_t tile = static_cast<uint32_t>(first_tile + static_cast<int>(p / kPathTile));
  float x = 0.0f, xg = 0.0f, vp = k.xi0;
  if (kMode == 0) {
    S[p] = expf(add(k.log_s0, 0.0f));
    if (v) v[p] = vp;
  }
#pragma unroll 1
  for (int t = 0; t < n_steps; ++t) {
    const Words w = draw(j, 2u * static_cast<uint32_t>(t) + 1u, tile, seed);
    float z2, zp;
    box_muller_stream(w.x, w.y, z2, zp);
    if (mirror) {
      z2 = -z2;
      zp = -zp;
    }
    const size_t at = static_cast<size_t>(t) * n_pad + p;
    const float d = dW[at], g = G[at];
    const float dB = add(mul(k.rho, d), mul(k.rbsd, zp));
    x = add(x, add(mul(sub(k.r, mul(0.5f, vp)), k.dt), mul(sqrtf(vp), dB)));
    if (kMode == 2) xg = add(xg, add(k.cv_drift, mul(k.sig_cv, dB)));
    const float Y = mul(k.sqrt2H, add(add(g, mul(k.c1, d)), mul(k.c2, z2)));
    vp = mul(k.xi0, expf(sub(mul(k.eta, Y), k.comp[t + 1])));
    if (kMode == 0) {
      S[at + n_pad] = expf(add(k.log_s0, x));
      if (v) v[at + n_pad] = vp;
      if (hist) hist[at] = mul(k.sqrt2H, g);
    }
  }
  if (kMode != 0) {
    S[p] = expf(add(k.log_s0, x));
    if (kMode == 1 && v) v[p] = vp;
    if (kMode == 2) g_t[p] = expf(add(k.log_s0, xg));
  }
}

inline bool args_fit(int first_tile, int n_tiles, int n_steps) {
  return first_tile >= 0 && n_tiles >= 1 && n_steps >= 1 && n_steps <= kMaxSteps;
}

template <int kMode>
int launch_paths(bool anti, float* S, float* v, float* hist, float* g_t, const float* dW,
                 const float* G, const RbK& k, uint64_t seed, int first_tile, int n_tiles,
                 int n_steps, cudaStream_t stream) {
  const long long n = static_cast<long long>(n_tiles) * kPathTile;
  const dim3 grid(static_cast<unsigned int>((n + kBlock - 1) / kBlock));
  auto kernel = anti ? rbergomi_paths_kernel<kMode, true> : rbergomi_paths_kernel<kMode, false>;
  kernel<<<grid, kBlock, 0, stream>>>(S, v, hist, g_t, dW, G, k, seed, first_tile, n_tiles,
                                      n_steps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace rb
}  // namespace omt

extern "C" {

// Kernel 25. dW: device (n_steps, n_tiles 4096) float32.
int omt_rbergomi_dw(void* dW, float sqrt_dt, uint64_t seed, int first_tile, int n_tiles,
                    int n_steps, int antithetic, void* stream) {
  using namespace omt::rb;
  if (!args_fit(first_tile, n_tiles, n_steps) || n_steps > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int width = antithetic ? kPathTile / 2 : kPathTile;
  const long long slots = static_cast<long long>(n_tiles) * width;
  const dim3 grid(static_cast<unsigned int>((slots + kBlock - 1) / kBlock), n_steps);
  auto kernel = antithetic ? rbergomi_dw_kernel<true> : rbergomi_dw_kernel<false>;
  kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(static_cast<float*>(dW),
                                                                  sqrt_dt, seed, first_tile,
                                                                  n_tiles);
  return static_cast<int>(cudaGetLastError());
}

// Kernel 26. dW, G: device (n_steps, n_pad) float32, n_pad = n_tiles 4096;
// consts: host pointer to the RbK floats (ops/cuda_rbergomi.rb_args); mode 0
// paths (S, v: (n_steps+1, n_pad), hist: (n_steps, n_pad); v and hist may
// be null), 1 terminal (S, v: (n_pad,), v may be null), 2 control variate
// (S, g_t: (n_pad,)).
int omt_rbergomi_paths(void* S, void* v, void* hist, void* g_t, const void* dW, const void* G,
                       const void* consts, uint64_t seed, int first_tile, int n_tiles,
                       int n_steps, int antithetic, int mode, void* stream) {
  using namespace omt::rb;
  if (!args_fit(first_tile, n_tiles, n_steps) || S == nullptr ||
      (mode == 2 && g_t == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  RbK k;
  const float* f = static_cast<const float*>(consts);
  float* dst = reinterpret_cast<float*>(&k);
  for (size_t i = 0; i < sizeof(RbK) / sizeof(float); ++i) dst[i] = f[i];
  if (static_cast<int>(k.n_comp) != n_steps + 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  auto* So = static_cast<float*>(S);
  auto* vo = static_cast<float*>(v);
  auto* ho = static_cast<float*>(hist);
  auto* go = static_cast<float*>(g_t);
  const auto* d = static_cast<const float*>(dW);
  const auto* g = static_cast<const float*>(G);
  const bool anti = antithetic != 0;
  switch (mode) {
    case 0: return launch_paths<0>(anti, So, vo, ho, go, d, g, k, seed, first_tile, n_tiles,
                                   n_steps, s);
    case 1: return launch_paths<1>(anti, So, vo, ho, go, d, g, k, seed, first_tile, n_tiles,
                                   n_steps, s);
    case 2: return launch_paths<2>(anti, So, vo, ho, go, d, g, k, seed, first_tile, n_tiles,
                                   n_steps, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Registers, spills and occupancy (omt::kernel_attrs) of the antithetic
// instances: 0 kernel 25, 1-3 kernel 26 in modes 0-2.
int omt_rbergomi_attrs(int which, int* out) {
  using namespace omt::rb;
  using omt::kernel_attrs;
  switch (which) {
    case 0: return kernel_attrs(rbergomi_dw_kernel<true>, kBlock, out);
    case 1: return kernel_attrs(rbergomi_paths_kernel<0, true>, kBlock, out);
    case 2: return kernel_attrs(rbergomi_paths_kernel<1, true>, kBlock, out);
    case 3: return kernel_attrs(rbergomi_paths_kernel<2, true>, kBlock, out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
