// Ablations of kernel 28's first design (csrc/basket.cu basket_kernel<3,
// kTerminal>) for scripts/exp_basket_terminal.py: the same function, 3
// assets, each change a compile-time switch of this file alone, built
// into a library of its own (nvcc, sm_90a) beside the package's.
//
//   kGeom32  the slot's geometry in 32 bits: an item's tile and column by a
//            shift and a mask (items a tile a power of two), its output
//            offsets in 32 bits; else the first design's long long
//            division and size_t offsets;
//   kKeys    the ten Philox round keys once per launch (a __grid_constant__
//            fast::PhiloxKeys, philox_keyed); else philox4x32_10, which
//            rebuilds them at every call;
//   K        adjacent slots a thread, each asset row written as one float2
//            (K = 2) or float4 (K = 4) at the path's column and one at the
//            mirror's; slot j keeps its counter (j, t, global tile, 6);
//   kWaves   a grid of whole waves (the resident blocks of every SM), each
//            thread taking items at a stride of the grid; else one item a
//            thread, as many blocks as items need;
//   kSink    no stores: every value of an item is summed and the sum
//            stored only if it is -1, which a price never is (the
//            arithmetic's time without the bytes; not the function).
//
// Every variant but kSink gives the first design's bits: the same box_muller_stream,
// W over ascending b with _rn, log_step and s0 expf(acc).
#include "hopper_fast.cuh"
#include "kernel_attrs.cuh"

namespace {

using omt::Words;

constexpr int N = 3;
constexpr int kBlock = 256;
constexpr uint32_t kStream = 6u;

struct Consts {
  float c[3 * N + N * (N + 1) / 2];
};

template <int K>
struct Vec;
template <>
struct Vec<1> {
  using T = float;
  static __device__ __forceinline__ T make(const float* v) { return v[0]; }
};
template <>
struct Vec<2> {
  using T = float2;
  static __device__ __forceinline__ T make(const float* v) { return make_float2(v[0], v[1]); }
};
template <>
struct Vec<4> {
  using T = float4;
  static __device__ __forceinline__ T make(const float* v) {
    return make_float4(v[0], v[1], v[2], v[3]);
  }
};

__device__ __forceinline__ float log_step(float acc, float drift, float vol, float W) {
  return __fadd_rn(acc, __fadd_rn(drift, __fmul_rn(vol, W)));
}

template <bool kGeom32, bool kKeys, int K, bool kWaves, bool kSink>
__global__ void __launch_bounds__(kBlock)
exp_kernel(float* __restrict__ out, const Consts p,
           const __grid_constant__ omt::fast::PhiloxKeys keys, uint64_t seed, int first_tile,
           int n_tiles, int tile, int n_steps, bool antithetic, int log2_items) {
  const float* c = p.c;
  const float* s0 = c;
  const float* drift = c + N;
  const float* vol = c + 2 * N;
  const float* L = c + 3 * N;
  const int width = antithetic ? tile / 2 : tile;
  const int items = width / K;
  // the item index: 32 bits with kGeom32, else the first design's long long
  using I = std::conditional_t<kGeom32, uint32_t, long long>;
  const I n_items = static_cast<I>(n_tiles) * static_cast<I>(items);
  const I first = static_cast<I>(blockIdx.x) * static_cast<I>(blockDim.x) + threadIdx.x;
  const I stride = kWaves ? static_cast<I>(gridDim.x) * static_cast<I>(blockDim.x) : n_items;
  for (I item = first; item < n_items; item += stride) {
    // this item's slot j, global tile and output offsets (path, mirror) of asset 0
    uint32_t j, gt;
    size_t col, row;
    if (kGeom32) {
      const uint32_t lt = static_cast<uint32_t>(item) >> log2_items;
      j = (static_cast<uint32_t>(item) & ((1u << log2_items) - 1u)) * K;
      gt = static_cast<uint32_t>(first_tile) + lt;
    } else {
      const int lt = static_cast<int>(item / items);
      j = static_cast<uint32_t>(item % items) * K;
      gt = static_cast<uint32_t>(first_tile + lt);
      col = static_cast<size_t>(lt) * tile + j;
      row = static_cast<size_t>(n_tiles) * tile;
    }
    auto at = [&](int a, bool mirror) -> float* {
      if (kGeom32) {
        const uint32_t lt = gt - static_cast<uint32_t>(first_tile);
        return out + (static_cast<uint32_t>(a) * static_cast<uint32_t>(n_tiles) *
                          static_cast<uint32_t>(tile) +
                      lt * static_cast<uint32_t>(tile) + j +
                      (mirror ? static_cast<uint32_t>(width) : 0u));
      }
      return out + (a * row + col + (mirror ? static_cast<size_t>(width) : 0));
    };
    float acc[N][K], accm[N][K];
#pragma unroll
    for (int a = 0; a < N; ++a)
#pragma unroll
      for (int s = 0; s < K; ++s) acc[a][s] = accm[a][s] = 0.0f;
    for (int t = 0; t < n_steps; ++t) {
      Words w[K];
#pragma unroll
      for (int s = 0; s < K; ++s) {
        const Words ctr{j + s, static_cast<uint32_t>(t), gt, kStream};
        w[s] = kKeys ? omt::fast::philox_keyed(ctr, keys)
                     : omt::philox4x32_10(ctr, static_cast<uint32_t>(seed),
                                          static_cast<uint32_t>(seed >> 32));
      }
#pragma unroll
      for (int s = 0; s < K; ++s) {
        float z[4];
        omt::box_muller_stream(w[s].x, w[s].y, z[0], z[1]);
        omt::box_muller_stream(w[s].z, w[s].w, z[2], z[3]);
#pragma unroll
        for (int a = 0; a < N; ++a) {
          float W = __fmul_rn(L[a * (a + 1) / 2], z[0]);
#pragma unroll
          for (int b = 1; b <= a; ++b) W = __fadd_rn(W, __fmul_rn(L[a * (a + 1) / 2 + b], z[b]));
          acc[a][s] = log_step(acc[a][s], drift[a], vol[a], W);
          if (antithetic) accm[a][s] = log_step(accm[a][s], drift[a], vol[a], -W);
        }
      }
    }
    float sink = 0.0f;
#pragma unroll
    for (int a = 0; a < N; ++a) {
      float v[K];
#pragma unroll
      for (int s = 0; s < K; ++s) v[s] = __fmul_rn(s0[a], expf(acc[a][s]));
      using V = typename Vec<K>::T;
      if (kSink) {
#pragma unroll
        for (int s = 0; s < K; ++s) sink += v[s];
      } else {
        *reinterpret_cast<V*>(at(a, false)) = Vec<K>::make(v);
      }
      if (antithetic) {
#pragma unroll
        for (int s = 0; s < K; ++s) v[s] = __fmul_rn(s0[a], expf(accm[a][s]));
        if (kSink) {
#pragma unroll
          for (int s = 0; s < K; ++s) sink += v[s];
        } else {
          *reinterpret_cast<V*>(at(a, true)) = Vec<K>::make(v);
        }
      }
    }
    if (kSink && sink == -1.0f) *at(0, false) = sink;
  }
}

// The variants by number: (kGeom32, kKeys, K, kWaves, kSink).
#define OMT_EXP_VARIANTS(X)                                                        \
  X(0, false, false, 1, false, false) X(1, true, false, 1, false, false)          \
  X(2, false, true, 1, false, false) X(3, false, false, 2, false, false)          \
  X(4, false, false, 4, false, false) X(5, false, false, 1, true, false)          \
  X(6, true, true, 1, false, false) X(7, true, true, 2, false, false)             \
  X(8, true, true, 4, false, false) X(9, true, true, 1, true, false)               \
  X(10, true, true, 2, true, false) X(11, true, true, 4, true, false)             \
  X(12, true, true, 4, false, true)

template <bool kGeom32, bool kKeys, int K, bool kWaves, bool kSink>
int run(float* out, const float* host_consts, uint64_t seed, int first_tile, int n_tiles,
        int tile, int n_steps, bool anti, cudaStream_t st) {
  const int width = anti ? tile / 2 : tile;
  const int items = width / K;
  if (width % K != 0 || (items & (items - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int log2_items = 0;
  while ((1 << log2_items) < items) ++log2_items;
  Consts p;
  for (int i = 0; i < 3 * N + N * (N + 1) / 2; ++i) p.c[i] = host_consts[i];
  const omt::fast::PhiloxKeys keys = omt::fast::philox_keys(seed);
  const long long n_items = static_cast<long long>(n_tiles) * items;
  long long grid = (n_items + kBlock - 1) / kBlock;
  if (kWaves) {
    int device = 0, sms = 0, resident = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident,
                                                  exp_kernel<kGeom32, kKeys, K, kWaves, kSink>,
                                                  kBlock, 0);
    grid = grid < static_cast<long long>(sms) * resident ? grid
                                                         : static_cast<long long>(sms) * resident;
  }
  exp_kernel<kGeom32, kKeys, K, kWaves, kSink><<<static_cast<unsigned>(grid), kBlock, 0, st>>>(
      out, p, keys, seed, first_tile, n_tiles, tile, n_steps, anti, log2_items);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// One launch of variant ``variant`` (OMT_EXP_VARIANTS) at 3 assets: out
// (3, n_tiles * tile) float32 on the card; host_consts as omt_basket's.
int exp_basket_terminal(int variant, void* out, const void* host_consts, uint64_t seed,
                        int first_tile, int n_tiles, int tile, int n_steps, int antithetic,
                        void* stream) {
  float* o = static_cast<float*>(out);
  const float* h = static_cast<const float*>(host_consts);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (variant) {
#define OMT_EXP_RUN(V, G, KEYS, K, WAVES, SINK) \
  case V:                                       \
    return run<G, KEYS, K, WAVES, SINK>(o, h, seed, first_tile, n_tiles, tile, n_steps, \
                                  antithetic != 0, st);
    OMT_EXP_VARIANTS(OMT_EXP_RUN)
#undef OMT_EXP_RUN
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Registers, local bytes, resident blocks per SM and block threads of a variant.
int exp_basket_terminal_attrs(int variant, int* out) {
  switch (variant) {
#define OMT_EXP_ATTR(V, G, KEYS, K, WAVES, SINK) \
  case V:                                        \
    return omt::kernel_attrs(exp_kernel<G, KEYS, K, WAVES, SINK>, kBlock, out);
    OMT_EXP_VARIANTS(OMT_EXP_ATTR)
#undef OMT_EXP_ATTR
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
