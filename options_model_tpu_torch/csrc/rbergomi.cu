// Rough Bergomi on Hopper (sm_90a): the hybrid scheme's simulator as one
// fused kernel (the design every pricer launches), and its first design,
// kernels 25 and 26 around a float32 matrix product (the yardstick).
//
// The JAX package simulates rBergomi in XLA code, not in Pallas:
//   options_model_tpu/models/rbergomi.py:128  simulate_rbergomi (the jnp.matmul, :192)
//   options_model_tpu/models/rbergomi.py:234  terminal_cv_core (:265)
// with jax.random normals for the three draws of a step. The port's stream
// is Philox on counter word 3 = 4 (ops/philox.py states it: draw 2t gives
// the Volterra Brownian's z1, draw 2t + 1 gives (z2, zp), all mirrored
// within the tile), and each kernel has a plain PyTorch version on the
// same counters (ops/cuda_rbergomi.py).
//
// rbergomi_fused_kernel<kMode, kAnti>, the design. A block of 128 threads
// owns 32 antithetic pairs (64 paths without antithetics) and takes the
// steps in chunks of 32:
// 1. draw: the block's threads draw the chunk's (step, pair) items, two
//    Philox calls an item (z1 from draw 2t, (z2, zp) from draw 2t + 1; the
//    round keys by value, hopper_fast.cuh), once a pair: under round to
//    nearest the mirror's draws, dW, G and Y are exactly the negated
//    values, so only its v, x and stores are its own. dW = sqrt(dt) z1
//    goes to the shared history [step][pair] (all of it: G needs every past
//    increment), z2 and zp to the chunk's rows;
// 2. Volterra: four threads a row k of the chunk, 8 pairs each, sum G[k] =
//    sum_{i<k} w_{k-i+1} dW_i over i in ASCENDING order, each product
//    __fmul_rn then __fadd_rn (no FMA; models/rbergomi.volterra_ordered is
//    the same sum), two float4s of dW from shared memory a weight. The row
//    then forms Y = sqrt(2H) ((G + c1 dW) + c2 z2), both members' v_{k+1} =
//    xi0 exp(eta (+-Y) - comp) and dB = rho dW + rho_bar sqrt(dt) zp in
//    place of z2 and zp, and stores the dual state hist = sqrt(2H) G;
// 3. walk: the first 64 threads walk a path each from shared memory, x +=
//    (r - v/2) dt + sqrt(v) dB: only x carries from step to step, and each
//    store of a warp is 128 coalesced bytes.
// dW and G never reach device memory. kMode 0 writes S and v (n_steps+1,
// P) and hist (n_steps, P), v and hist optional; 1 writes S_T and v_T; 2
// writes S_T and the control variate's G_T, the frozen-variance lognormal
// on the same price Brownian. Shared memory: (n_steps rounded up to 4 +
// 32 n_steps + 32 x 96) floats a block (64 n_steps + 32 x 128 without
// antithetics), 18.9 KB at n_steps = 50 and 80 KB at MAX_STEPS = 512
// (dynamic, the limit raised above 48 KB).
//
// What bounds it (chip_smoke.bound's rule, at the H100 SXM's published
// rates at 700 W): at R5's 2^20 x 50 with v it writes S and v, 428 MB,
// 0.128 ms at 3.35 TB/s; its Philox (two calls a pair-step, 36
// instructions and a word each) is 0.119 ms of int32 issue and its f32 work
// (two Box-Mullers, n_steps - 1 Volterra operations a pair-step, the walk)
// 0.041 ms: bytes bound it. In the CV mode at R4's 2^16 x 96 it writes 0.5
// MB and the Philox bound, 0.014 ms, holds it. What holds it back is
// neither but its instruction issue: the ablations of
// scripts/exp_rbergomi_fused.py (PERF.md section 6) give Philox about a
// quarter of its time, the Volterra sum and the walk about a fifth each,
// and leave the rest to the two exact Box-Mullers a pair-step (libdevice
// logf, IEEE sqrtf, the stream's sincos), which the stream's bits require.
//
// The first design, kept as the yardstick (no pricer launches it):
// - rbergomi_dw_kernel (kernel 25): dW[t, p] = sqrt(dt) z1, one thread a
//   (pair slot, step), writing the path and its mirror;
// - G = W_mat dW between the two, one float32 torch.matmul
//   (models/rbergomi.volterra, TF32 off);
// - rbergomi_paths_kernel<kMode, kAnti> (kernel 26): one thread a path,
//   reading dW and G and redrawing (z2, zp) a step.
// It moves dW and G through device memory (~1.5 GB at 2^20 x 50).
//
// Every float operation is an _rn intrinsic in the plain version's order,
// with libdevice's expf and IEEE sqrtf, and no --use_fast_math: the fused
// kernel's outputs equal those of its plain version (ops/philox
// rbergomi_path_draws, models/rbergomi.volterra_ordered, rbergomi_walk) on
// the card (chip_smoke.py R0 checks them to RB_RTOL and prints the largest
// difference).
#include "hopper_fast.cuh"
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

// The fused kernel's Volterra weights: wt[lag] = w_{lag+1} (models/rbergomi
// W_mat[lag, 0]; wt[0] unread), by value beside RbK. The two take the
// launch's parameters past 4 KB (CUDA 12.1, NVIDIA's R530 release or later).
struct RbW {
  float wt[kMaxSteps];
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

// The fused kernel's geometry: kThreads threads own kUnits pairs (or
// paths), the first kPaths of them walk one path each; a chunk is kChunk
// steps, one Volterra row a kRowThreads threads, each summing kVecs float4s
// of units.
template <bool kAnti>
struct Fused {
  static constexpr int kThreads = 128;
  static constexpr int kUnits = kAnti ? 32 : 64;
  static constexpr int kPaths = (kAnti ? 2 : 1) * kUnits;
  static constexpr int kRowThreads = 4;
  static constexpr int kChunk = kThreads / kRowThreads;
  static constexpr int kVecs = kUnits / (4 * kRowThreads);
  static_assert(kThreads % kPaths == 0, "the first kPaths threads walk");
  static_assert(kVecs * 4 * kRowThreads == kUnits, "a row's units split evenly");

  static size_t smem_bytes(int n_steps) {
    return sizeof(float) * (static_cast<size_t>((n_steps + 3) & ~3) +
                            static_cast<size_t>(n_steps) * kUnits + kChunk * (kPaths + kUnits));
  }
};

__device__ __forceinline__ void fold(float4& acc, float w, const float4& d) {
  acc.x = add(acc.x, mul(w, d.x));
  acc.y = add(acc.y, mul(w, d.y));
  acc.z = add(acc.z, mul(w, d.z));
  acc.w = add(acc.w, mul(w, d.w));
}

__device__ __forceinline__ float y_of(const RbK& k, float g, float d, float z2) {
  return mul(k.sqrt2H, add(add(g, mul(k.c1, d)), mul(k.c2, z2)));
}

__device__ __forceinline__ float db_of(const RbK& k, float d, float zp) {
  return add(mul(k.rho, d), mul(k.rbsd, zp));
}

// v = xi0 exp(eta Y - comp): the variance after the step whose Y this is.
__device__ __forceinline__ float v_of(const RbK& k, float y, float comp) {
  return mul(k.xi0, expf(sub(mul(k.eta, y), comp)));
}

__device__ __forceinline__ float4 v_of(const RbK& k, const float4& y, float comp) {
  return make_float4(v_of(k, y.x, comp), v_of(k, y.y, comp), v_of(k, y.z, comp),
                     v_of(k, y.w, comp));
}

__device__ __forceinline__ float4 neg(const float4& a) {
  return make_float4(-a.x, -a.y, -a.z, -a.w);
}

template <int kMode, bool kAnti>
__global__ void __launch_bounds__(Fused<kAnti>::kThreads, 8)
rbergomi_fused_kernel(float* __restrict__ S, float* __restrict__ v, float* __restrict__ hist,
                      float* __restrict__ g_t, const __grid_constant__ RbK k,
                      const __grid_constant__ RbW w, const __grid_constant__ fast::PhiloxKeys keys,
                      int first_tile, int n_tiles, int n_steps) {
  using F = Fused<kAnti>;
  constexpr int U = F::kUnits, T = F::kThreads, C = F::kChunk, V = F::kPaths;
  constexpr int kWidth = kAnti ? kPathTile / 2 : kPathTile;
  extern __shared__ float4 smem4[];
  float* s_w = reinterpret_cast<float*>(smem4);       // w_{lag+1} at lag, [n_steps]
  float* s_dw = s_w + ((n_steps + 3) & ~3);           // dW history [n_steps][U]
  float* s_v = s_dw + n_steps * U;                    // the chunk's z2, then v_{t+1} [C][V]
  float* s_b = s_v + C * V;                           // the chunk's zp, then dB [C][U]

  const int tid = static_cast<int>(threadIdx.x);
  const size_t n_pad = static_cast<size_t>(n_tiles) * kPathTile;
  const long long unit0 = static_cast<long long>(blockIdx.x) * U;
  const int local_tile = static_cast<int>(unit0 / kWidth);
  const uint32_t j0 = static_cast<uint32_t>(unit0 % kWidth);
  const uint32_t tile = static_cast<uint32_t>(first_tile + local_tile);
  const size_t col0 = static_cast<size_t>(local_tile) * kPathTile + j0;

  for (int i = tid; i < n_steps; i += T) s_w[i] = w.wt[i];

  // The walked path of thread tid < V: unit tid % U, the mirror (path j +
  // 2048) for tid >= U.
  const bool walker = tid < V;
  const bool mirror = kAnti && tid >= U;
  const size_t p = col0 + tid % U + (mirror ? kWidth : 0);
  float x = 0.0f, xg = 0.0f, vp = k.xi0;
  if (kMode == 0 && walker) {
    S[p] = expf(add(k.log_s0, 0.0f));
    if (v) v[p] = vp;
  }

  // The Volterra row of this thread in a chunk, and its float4s of units
  // q, q + kRowThreads, ...
  const int row = tid / F::kRowThreads, q = tid % F::kRowThreads;
#pragma unroll 1
  for (int t0 = 0; t0 < n_steps; t0 += C) {
    const int nc = min(C, n_steps - t0);
    // 1. draws of the chunk, (step, unit) items
#pragma unroll 2
    for (int item = tid; item < nc * U; item += T) {
      const int u = item % U, s = item / U, t = t0 + s;
      const Words a = fast::philox_keyed(
          Words{j0 + u, 2u * static_cast<uint32_t>(t), tile, kRbStream}, keys);
      float z1, unused;
      box_muller_stream(a.x, a.y, z1, unused);
      s_dw[t * U + u] = mul(k.sqrt_dt, z1);
      const Words b = fast::philox_keyed(
          Words{j0 + u, 2u * static_cast<uint32_t>(t) + 1u, tile, kRbStream}, keys);
      float z2, zp;
      box_muller_stream(b.x, b.y, z2, zp);
      s_v[s * V + u] = z2;
      s_b[s * U + u] = zp;
    }
    __syncthreads();
    // 2. row kr's Volterra sum over ascending i, then its Y, v and dB
    if (row < nc) {
      const int kr = t0 + row;
      float4 acc[F::kVecs];
#pragma unroll
      for (int e = 0; e < F::kVecs; ++e) acc[e] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      const float4* d4 = reinterpret_cast<const float4*>(s_dw) + q;
#pragma unroll 4
      for (int i = 0; i < kr; ++i) {
        const float w = s_w[kr - i];
#pragma unroll
        for (int e = 0; e < F::kVecs; ++e) fold(acc[e], w, d4[i * (U / 4) + e * F::kRowThreads]);
      }
      const float c = k.comp[kr + 1];
#pragma unroll
      for (int e = 0; e < F::kVecs; ++e) {
        const int at4 = q + e * F::kRowThreads;
        const float4 d = d4[kr * (U / 4) + e * F::kRowThreads], g = acc[e];
        float4* v4 = reinterpret_cast<float4*>(s_v + row * V) + at4;
        float4* b4 = reinterpret_cast<float4*>(s_b + row * U) + at4;
        const float4 z2 = *v4, zp = *b4;
        const float4 y = make_float4(y_of(k, g.x, d.x, z2.x), y_of(k, g.y, d.y, z2.y),
                                     y_of(k, g.z, d.z, z2.z), y_of(k, g.w, d.w, z2.w));
        *v4 = v_of(k, y, c);
        if (kAnti) v4[U / 4] = v_of(k, neg(y), c);
        *b4 = make_float4(db_of(k, d.x, zp.x), db_of(k, d.y, zp.y), db_of(k, d.z, zp.z),
                          db_of(k, d.w, zp.w));
        if (kMode == 0 && hist) {
          const float4 h = make_float4(mul(k.sqrt2H, g.x), mul(k.sqrt2H, g.y),
                                       mul(k.sqrt2H, g.z), mul(k.sqrt2H, g.w));
          float4* hp =
              reinterpret_cast<float4*>(hist + static_cast<size_t>(kr) * n_pad + col0) + at4;
          *hp = h;
          if (kAnti) hp[kWidth / 4] = neg(h);
        }
      }
    }
    __syncthreads();
    // 3. the walk of the chunk: only x (and xg) carry from step to step
#pragma unroll 4
    for (int s = 0; s < (walker ? nc : 0); ++s) {
      const int t = t0 + s;
      float dB = s_b[s * U + tid % U];
      if (mirror) dB = -dB;
      x = add(x, add(mul(sub(k.r, mul(0.5f, vp)), k.dt), mul(sqrtf(vp), dB)));
      if (kMode == 2) xg = add(xg, add(k.cv_drift, mul(k.sig_cv, dB)));
      vp = s_v[s * V + tid];
      if (kMode == 0) {
        const size_t at = static_cast<size_t>(t + 1) * n_pad + p;
        S[at] = expf(add(k.log_s0, x));
        if (v) v[at] = vp;
      }
    }
    __syncthreads();
  }
  if (kMode != 0 && walker) {
    S[p] = expf(add(k.log_s0, x));
    if (kMode == 1 && v) v[p] = vp;
    if (kMode == 2) g_t[p] = expf(add(k.log_s0, xg));
  }
}

// The instance's dynamic shared memory at n_steps, its limit raised past
// 48 KB where it needs more.
template <int kMode, bool kAnti>
cudaError_t fused_smem(int n_steps, size_t& smem) {
  smem = Fused<kAnti>::smem_bytes(n_steps);
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(rbergomi_fused_kernel<kMode, kAnti>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
}

template <int kMode, bool kAnti>
int launch_fused(float* S, float* v, float* hist, float* g_t, const RbK& k, const RbW& w,
                 uint64_t seed, int first_tile, int n_tiles, int n_steps, cudaStream_t stream) {
  using F = Fused<kAnti>;
  size_t smem;
  const cudaError_t err = fused_smem<kMode, kAnti>(n_steps, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long units = static_cast<long long>(n_tiles) * (kAnti ? kPathTile / 2 : kPathTile);
  const dim3 grid(static_cast<unsigned int>(units / F::kUnits));
  rbergomi_fused_kernel<kMode, kAnti><<<grid, F::kThreads, smem, stream>>>(
      S, v, hist, g_t, k, w, fast::philox_keys(seed), first_tile, n_tiles, n_steps);
  return static_cast<int>(cudaGetLastError());
}

template <int kMode>
int launch_fused_mode(bool anti, float* S, float* v, float* hist, float* g_t, const RbK& k,
                      const RbW& w, uint64_t seed, int first_tile, int n_tiles, int n_steps,
                      cudaStream_t stream) {
  return anti ? launch_fused<kMode, true>(S, v, hist, g_t, k, w, seed, first_tile, n_tiles,
                                          n_steps, stream)
              : launch_fused<kMode, false>(S, v, hist, g_t, k, w, seed, first_tile, n_tiles,
                                           n_steps, stream);
}

template <int kMode>
int fused_attrs(int n_steps, int* out) {
  size_t smem;
  const cudaError_t err = fused_smem<kMode, true>(n_steps, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  return kernel_attrs(rbergomi_fused_kernel<kMode, true>, Fused<true>::kThreads, out, smem);
}

inline bool read_consts(const void* consts, int n_steps, RbK& k) {
  const float* f = static_cast<const float*>(consts);
  float* dst = reinterpret_cast<float*>(&k);
  for (size_t i = 0; i < sizeof(RbK) / sizeof(float); ++i) dst[i] = f[i];
  return static_cast<int>(k.n_comp) == n_steps + 1;
}

}  // namespace rb
}  // namespace omt

extern "C" {

// The fused kernel. consts: host pointer to the RbK floats; weights: host
// pointer to the RbW floats (ops/cuda_rbergomi.rb_args, rb_weights); mode 0
// paths (S, v: (n_steps+1, n_pad), hist: (n_steps, n_pad); v and hist may be
// null), 1 terminal (S, v: (n_pad,), v may be null), 2 control variate (S,
// g_t: (n_pad,)); n_pad = n_tiles 4096.
int omt_rbergomi_fused(void* S, void* v, void* hist, void* g_t, const void* consts,
                       const void* weights, uint64_t seed, int first_tile, int n_tiles,
                       int n_steps, int antithetic, int mode, void* stream) {
  using namespace omt::rb;
  RbK k;
  if (!args_fit(first_tile, n_tiles, n_steps) || S == nullptr || weights == nullptr ||
      (mode == 2 && g_t == nullptr) || !read_consts(consts, n_steps, k)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  RbW w;
  const float* wf = static_cast<const float*>(weights);
  for (int i = 0; i < kMaxSteps; ++i) w.wt[i] = wf[i];
  const auto s = static_cast<cudaStream_t>(stream);
  auto* So = static_cast<float*>(S);
  auto* vo = static_cast<float*>(v);
  auto* ho = static_cast<float*>(hist);
  auto* go = static_cast<float*>(g_t);
  const bool anti = antithetic != 0;
  switch (mode) {
    case 0: return launch_fused_mode<0>(anti, So, vo, ho, go, k, w, seed, first_tile, n_tiles,
                                        n_steps, s);
    case 1: return launch_fused_mode<1>(anti, So, vo, ho, go, k, w, seed, first_tile, n_tiles,
                                        n_steps, s);
    case 2: return launch_fused_mode<2>(anti, So, vo, ho, go, k, w, seed, first_tile, n_tiles,
                                        n_steps, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Kernel 25 (first design). dW: device (n_steps, n_tiles 4096) float32.
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

// Kernel 26 (first design). dW, G: device (n_steps, n_pad) float32, n_pad = n_tiles 4096;
// consts: host pointer to the RbK floats (ops/cuda_rbergomi.rb_args); mode 0
// paths (S, v: (n_steps+1, n_pad), hist: (n_steps, n_pad); v and hist may
// be null), 1 terminal (S, v: (n_pad,), v may be null), 2 control variate
// (S, g_t: (n_pad,)).
int omt_rbergomi_paths(void* S, void* v, void* hist, void* g_t, const void* dW, const void* G,
                       const void* consts, uint64_t seed, int first_tile, int n_tiles,
                       int n_steps, int antithetic, int mode, void* stream) {
  using namespace omt::rb;
  RbK k;
  if (!args_fit(first_tile, n_tiles, n_steps) || S == nullptr ||
      (mode == 2 && g_t == nullptr) || !read_consts(consts, n_steps, k)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
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
// instances: 0 kernel 25, 1-3 kernel 26 in modes 0-2, 4-6 the fused kernel
// in modes 0-2 with its dynamic shared memory at n_steps.
int omt_rbergomi_attrs(int which, int n_steps, int* out) {
  using namespace omt::rb;
  using omt::kernel_attrs;
  if (which >= 4 && (n_steps < 1 || n_steps > kMaxSteps)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (which) {
    case 0: return kernel_attrs(rbergomi_dw_kernel<true>, kBlock, out);
    case 1: return kernel_attrs(rbergomi_paths_kernel<0, true>, kBlock, out);
    case 2: return kernel_attrs(rbergomi_paths_kernel<1, true>, kBlock, out);
    case 3: return kernel_attrs(rbergomi_paths_kernel<2, true>, kBlock, out);
    case 4: return fused_attrs<0>(n_steps, out);
    case 5: return fused_attrs<1>(n_steps, out);
    case 6: return fused_attrs<2>(n_steps, out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
