// Ablations of the generic instance of kernels 27-28 (csrc/basket.cu
// basket_generic_kernel: the constants and z, acc and the mirror's acc in
// shared memory, runtime loops over every row and column, 64-thread blocks,
// the first design of every basket of 9 to 128 assets) for
// scripts/exp_basket_generic.py, each change a compile-time switch of this
// file alone, built into a library of its own (nvcc, sm_90a), and beside
// them the wide route: with one slot a thread (slot_wide_kernel, below) at
// R = 4, 8 and 16 rows a block, its draw and chunk loops rolled and (R 8,
// 16) unrolled twice, and split across groups (csrc/basket.cuh wide_body,
// basket_wide_kernel's body, in exp_wide_kernel) at R = 4 and 8, its chunk
// loop rolled or unrolled twice, and at R = 8 under launch bounds of 256
// threads and 3 or 4 blocks an SM (at most 85 or 64 registers).
//
// copy_kernel<kKeys, kGrid2D, B, kMode>, any n: the first design's code,
//   kKeys    the ten Philox round keys once a launch (__grid_constant__
//            fast::PhiloxKeys, philox_keyed), else rebuilt at every call;
//   kGrid2D  a 2-D grid (x the local tile, y a block of slots), the slot
//            found with no division, else the long long slot / width;
//   B        threads a block (the first design's 64, or 128, 256).
// fixed_kernel<kConstsVal, kZReg, kAccReg, kKeys, kGrid2D, B, kSink, kMode>,
//   n = 12 at compile time, every loop over rows and columns unrolled (so
//   the W rows of a step run as independent chains),
//   kConstsVal  the constants by value (kernel parameters), else copied to
//               shared memory;
//   kZReg       z in registers, else in shared memory (entry i at i B + tid);
//   kAccReg     acc and the mirror's acc in registers, else in shared memory;
//   kSink       no stores: every S summed and stored only if the sum is -1,
//               which a price never is (the arithmetic alone; not the
//               function).
// Every variant but kSink gives the first design's bits: the same
// box_muller_stream, W over ascending b with _rn, log_step and s0 expf(acc).
#include "basket.cuh"

namespace {

using omt::Words;
using omt::basket::kPaths;
using omt::basket::kStream;
using omt::basket::kTerminal;
using omt::basket::log_step;
using omt::basket::n_consts;

constexpr int N12 = 12;

struct Params {
  float c[n_consts(N12)];
};

struct ExpGrid {
  uint32_t first_tile, tile, width;
  int n_tiles, n;
  bool anti;
  size_t n_pad;
};

// The thread's slot, its global tile and its path's column; false past the
// last slot.
template <bool kGrid2D>
__device__ __forceinline__ bool exp_slot(const ExpGrid& g, uint32_t& j, uint32_t& gt,
                                         size_t& col) {
  if (kGrid2D) {
    j = blockIdx.y * blockDim.x + threadIdx.x;
    if (j >= g.width) return false;
    gt = g.first_tile + blockIdx.x;
    col = static_cast<size_t>(blockIdx.x) * g.tile + j;
    return true;
  }
  const int width = static_cast<int>(g.width);
  const long long slot = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (slot >= static_cast<long long>(g.n_tiles) * width) return false;
  const int local_tile = static_cast<int>(slot / width);
  j = static_cast<uint32_t>(slot % width);
  gt = g.first_tile + static_cast<uint32_t>(local_tile);
  col = static_cast<size_t>(local_tile) * g.tile + j;
  return true;
}

template <bool kKeys>
__device__ __forceinline__ Words exp_draw(uint32_t j, uint32_t draw, uint32_t gt, uint64_t seed,
                                          const omt::fast::PhiloxKeys& keys) {
  const Words ctr{j, draw, gt, kStream};
  return kKeys ? omt::fast::philox_keyed(ctr, keys)
               : omt::philox4x32_10(ctr, static_cast<uint32_t>(seed),
                                    static_cast<uint32_t>(seed >> 32));
}

// The first design at any n, with the runtime switches.
template <bool kKeys, bool kGrid2D, int B, int kMode>
__global__ void __launch_bounds__(B)
copy_kernel(float* __restrict__ out, const float* __restrict__ consts, uint64_t seed,
            const __grid_constant__ omt::fast::PhiloxKeys keys, const ExpGrid g, int n_steps) {
  extern __shared__ float smem[];
  const int n = g.n;
  float* c = smem;
  for (int i = threadIdx.x; i < n_consts(n); i += blockDim.x) c[i] = consts[i];
  __syncthreads();
  uint32_t j, gt;
  size_t col;
  if (!exp_slot<kGrid2D>(g, j, gt, col)) return;
  const float* s0 = c;
  const float* drift = c + n;
  const float* vol = c + 2 * n;
  const float* L = c + 3 * n;
  float* z = smem + n_consts(n) + threadIdx.x;
  float* acc = z + n * B;
  float* accm = acc + n * B;
  const int calls = (n + 3) / 4;
  for (int a = 0; a < n; ++a) {
    acc[a * B] = 0.0f;
    accm[a * B] = 0.0f;
    if (kMode == kPaths) {
      out[a * g.n_pad + col] = s0[a];
      if (g.anti) out[a * g.n_pad + col + g.width] = s0[a];
    }
  }
  for (int t = 0; t < n_steps; ++t) {
    for (int k = 0; k < calls; ++k) {
      const Words w = exp_draw<kKeys>(j, static_cast<uint32_t>(t * calls + k), gt, seed, keys);
      float z0, z1;
      omt::box_muller_stream(w.x, w.y, z0, z1);
      z[(4 * k) * B] = z0;
      if (4 * k + 1 < n) z[(4 * k + 1) * B] = z1;
      if (4 * k + 2 < n) {
        omt::box_muller_stream(w.z, w.w, z0, z1);
        z[(4 * k + 2) * B] = z0;
        if (4 * k + 3 < n) z[(4 * k + 3) * B] = z1;
      }
    }
    for (int a = 0; a < n; ++a) {
      const float* row = L + a * (a + 1) / 2;
      float W = __fmul_rn(row[0], z[0]);
      for (int b = 1; b <= a; ++b) W = __fadd_rn(W, __fmul_rn(row[b], z[b * B]));
      const float x = log_step(acc[a * B], drift[a], vol[a], W);
      acc[a * B] = x;
      const float xm = g.anti ? log_step(accm[a * B], drift[a], vol[a], -W) : 0.0f;
      accm[a * B] = xm;
      if (kMode == kPaths) {
        const size_t r = (static_cast<size_t>(t + 1) * n + a) * g.n_pad + col;
        out[r] = __fmul_rn(s0[a], expf(x));
        if (g.anti) out[r + g.width] = __fmul_rn(s0[a], expf(xm));
      }
    }
  }
  if (kMode == kTerminal) {
    for (int a = 0; a < n; ++a) {
      out[a * g.n_pad + col] = __fmul_rn(s0[a], expf(acc[a * B]));
      if (g.anti) out[a * g.n_pad + col + g.width] = __fmul_rn(s0[a], expf(accm[a * B]));
    }
  }
}

// The first design at n = 12, every loop unrolled, with the compile-time
// switches.
template <bool kConstsVal, bool kZReg, bool kAccReg, bool kKeys, bool kGrid2D, int B, bool kSink,
          int kMode>
__global__ void __launch_bounds__(B)
fixed_kernel(float* __restrict__ out, const float* __restrict__ consts, const Params p,
             uint64_t seed, const __grid_constant__ omt::fast::PhiloxKeys keys, const ExpGrid g,
             int n_steps) {
  constexpr int n = N12;
  constexpr int kCalls = (n + 3) / 4;
  extern __shared__ float smem[];
  const float* c = p.c;
  float* state = smem;
  if (!kConstsVal) {
    for (int i = threadIdx.x; i < n_consts(n); i += blockDim.x) smem[i] = consts[i];
    __syncthreads();
    c = smem;
    state = smem + n_consts(n);
  }
  uint32_t j, gt;
  size_t col;
  if (!exp_slot<kGrid2D>(g, j, gt, col)) return;
  const float* s0 = c;
  const float* drift = c + n;
  const float* vol = c + 2 * n;
  const float* L = c + 3 * n;
  // the shared-memory state: z (unless in registers), then acc and accm
  float* zs = state + threadIdx.x;
  float* as = zs + (kZReg ? 0 : 4 * kCalls * B);
  float* ams = as + n * B;
  float zr[4 * kCalls], ar[n], amr[n];
  auto zat = [&](int i) -> float& { return kZReg ? zr[i] : zs[i * B]; };
  auto aat = [&](int i) -> float& { return kAccReg ? ar[i] : as[i * B]; };
  auto amat = [&](int i) -> float& { return kAccReg ? amr[i] : ams[i * B]; };
  float sink = 0.0f;
#pragma unroll
  for (int a = 0; a < n; ++a) {
    aat(a) = 0.0f;
    amat(a) = 0.0f;
    if (kMode == kPaths && !kSink) {
      out[a * g.n_pad + col] = s0[a];
      if (g.anti) out[a * g.n_pad + col + g.width] = s0[a];
    }
  }
  for (int t = 0; t < n_steps; ++t) {
#pragma unroll
    for (int k = 0; k < kCalls; ++k) {
      const Words w = exp_draw<kKeys>(j, static_cast<uint32_t>(t * kCalls + k), gt, seed, keys);
      float z0, z1;
      omt::box_muller_stream(w.x, w.y, z0, z1);
      zat(4 * k) = z0;
      zat(4 * k + 1) = z1;
      omt::box_muller_stream(w.z, w.w, z0, z1);
      zat(4 * k + 2) = z0;
      zat(4 * k + 3) = z1;
    }
#pragma unroll
    for (int a = 0; a < n; ++a) {
      float W = __fmul_rn(L[a * (a + 1) / 2], zat(0));
#pragma unroll
      for (int b = 1; b <= a; ++b) W = __fadd_rn(W, __fmul_rn(L[a * (a + 1) / 2 + b], zat(b)));
      const float x = log_step(aat(a), drift[a], vol[a], W);
      aat(a) = x;
      const float xm = g.anti ? log_step(amat(a), drift[a], vol[a], -W) : 0.0f;
      amat(a) = xm;
      if (kMode == kPaths) {
        const float v = __fmul_rn(s0[a], expf(x));
        const float vm = g.anti ? __fmul_rn(s0[a], expf(xm)) : 0.0f;
        if (kSink) {
          sink += v + vm;
        } else {
          const size_t r = (static_cast<size_t>(t + 1) * n + a) * g.n_pad + col;
          out[r] = v;
          if (g.anti) out[r + g.width] = vm;
        }
      }
    }
  }
  if (kMode == kTerminal) {
#pragma unroll
    for (int a = 0; a < n; ++a) {
      const float v = __fmul_rn(s0[a], expf(aat(a)));
      const float vm = g.anti ? __fmul_rn(s0[a], expf(amat(a))) : 0.0f;
      if (kSink) {
        sink += v + vm;
      } else {
        out[a * g.n_pad + col] = v;
        if (g.anti) out[a * g.n_pad + col + g.width] = vm;
      }
    }
  }
  if (kSink && sink == -1.0f) out[col] = sink;
}

// ---- the wide route with one slot a thread ---------------------------------
// The wide route's design before the split across groups: one slot a
// thread, its z, acc and the mirror's acc (12 n bytes, whole calls and
// whole row blocks) in one shared-memory record, the same correlate order
// (basket.cuh wide_chunk, wide_diagonal) and launch shape.
constexpr int kSlotMaxBlock = 512;
using omt::basket::kDebug;
using omt::basket::kMaxAssets;
using omt::basket::kMaxSmem;
using omt::basket::round_up;
using omt::basket::wide_chunk;
using omt::basket::wide_consts4;
using omt::basket::wide_diagonal;
using omt::fast::PhiloxKeys;
using omt::box_muller_stream;
namespace fast = omt::fast;

// A thread's record in floats: z (whole calls), acc, accm (whole blocks),
// an odd number of float4.
constexpr int slot_stride(int n, int R) {
  return (round_up(n, 4) + 2 * round_up(n, R)) % 8 == 0 ? round_up(n, 4) + 2 * round_up(n, R) + 4
                                                        : round_up(n, 4) + 2 * round_up(n, R);
}

inline size_t slot_smem(int n, int R, int block) {
  return 16u * static_cast<size_t>(wide_consts4(n, R)) +
         4u * static_cast<size_t>(block) * static_cast<size_t>(slot_stride(n, R));
}

struct SlotGrid {
  uint32_t first_tile, tile, width;
  int n, n4, nr, stride, consts4;
  bool anti;
  size_t n_pad;
};

// The log steps of the block's rows from W, and their stores at step t
// (S in kPaths; acc and W in kDebug). Rows past n (the last block's
// padding) step on zero constants and are never stored or read.
template <int kMode, int R>
__device__ __forceinline__ void slot_rows(const float (&W)[R], int start, const float4* rows,
                                          float* acc, float* accm, float* __restrict__ out,
                                          float* __restrict__ aux, const SlotGrid& g,
                                          size_t col, int t) {
#pragma unroll
  for (int q = 0; q < R / 4; ++q) {
    const int a0 = start + 4 * q;
    const float4 x4 = *reinterpret_cast<const float4*>(acc + a0);
    const float4 m4 = *reinterpret_cast<const float4*>(accm + a0);
    float x[4] = {x4.x, x4.y, x4.z, x4.w}, xm[4] = {m4.x, m4.y, m4.z, m4.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 rc = rows[a0 + i];
      const float w = W[4 * q + i];
      x[i] = log_step(x[i], rc.y, rc.z, w);
      if (g.anti) xm[i] = log_step(xm[i], rc.y, rc.z, -w);
      if (kMode != kTerminal && a0 + i < g.n) {
        const size_t row = (static_cast<size_t>(t + 1) * g.n + a0 + i) * g.n_pad + col;
        if (kMode == kPaths) {
          out[row] = __fmul_rn(rc.x, expf(x[i]));
          if (g.anti) out[row + g.width] = __fmul_rn(rc.x, expf(xm[i]));
        } else {
          const size_t wrow = (static_cast<size_t>(t) * g.n + a0 + i) * g.n_pad + col;
          out[row] = x[i];
          aux[wrow] = w;
          if (g.anti) {
            out[row + g.width] = xm[i];
            aux[wrow + g.width] = -w;
          }
        }
      }
    }
    *reinterpret_cast<float4*>(acc + a0) = make_float4(x[0], x[1], x[2], x[3]);
    if (g.anti) *reinterpret_cast<float4*>(accm + a0) = make_float4(xm[0], xm[1], xm[2], xm[3]);
  }
}

// The one-slot-a-thread wide kernel (kTerminal, kPaths, kDebug).
// kUnroll: the draw loop's and the chunk loop's unrolling (2: two Philox
// calls, or two chunks' loads, in flight at once).
template <int kMode, int R, int kUnroll>
__global__ void __launch_bounds__(kSlotMaxBlock)
slot_wide_kernel(float* __restrict__ out, float* __restrict__ aux,
                 const float4* __restrict__ consts,
                 const __grid_constant__ fast::PhiloxKeys keys, const SlotGrid g,
                 int n_steps) {
  extern __shared__ float4 slot_shared[];
  for (int i = threadIdx.x; i < g.consts4; i += blockDim.x) slot_shared[i] = consts[i];
  __syncthreads();
  const uint32_t j = blockIdx.y * blockDim.x + threadIdx.x;
  if (j >= g.width) return;
  const float4* rows = slot_shared;
  const float4* L = slot_shared + g.nr;
  float* z = reinterpret_cast<float*>(slot_shared + g.consts4) + threadIdx.x * g.stride;
  float* acc = z + g.n4;
  float* accm = acc + g.nr;
  const uint32_t gt = g.first_tile + blockIdx.x;
  const size_t col = static_cast<size_t>(blockIdx.x) * g.tile + j;
  const int n = g.n, nb = g.nr / R, calls = g.n4 / 4;
  for (int i = 0; i < g.nr; i += 4) {
    *reinterpret_cast<float4*>(acc + i) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    *reinterpret_cast<float4*>(accm + i) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  if (kMode != kTerminal) {
    for (int a = 0; a < n; ++a) {
      const size_t row = static_cast<size_t>(a) * g.n_pad + col;
      const float v = kMode == kPaths ? rows[a].x : 0.0f;
      out[row] = v;
      if (g.anti) out[row + g.width] = v;
    }
  }
#pragma unroll 1
  for (int t = 0; t < n_steps; ++t) {
#pragma unroll(kUnroll)
    for (int k = 0; k < calls; ++k) {
      const omt::Words w = fast::philox_keyed(
          omt::Words{j, static_cast<uint32_t>(t * calls + k), gt, kStream}, keys);
      float4 v;
      box_muller_stream(w.x, w.y, v.x, v.y);
      if (4 * k + 2 < n) {
        box_muller_stream(w.z, w.w, v.z, v.w);
      } else {
        v.z = 0.0f;
        v.w = 0.0f;
      }
      *reinterpret_cast<float4*>(z + 4 * k) = v;
    }
    {
      float W[R];
      wide_diagonal<R, 0, true>(W, L, z, 0, n);
      slot_rows<kMode, R>(W, 0, rows, acc, accm, out, aux, g, col, t);
    }
#pragma unroll 1
    for (int rb = 1; rb < nb; ++rb) {
      const int start = rb * R;
      const float4* Lb = L + (R / 4) * (R * rb * (rb + 1) / 2);
      float W[R];
      wide_chunk<R, -1, true>(W, Lb, z, 0);
#pragma unroll(kUnroll)
      for (int b0 = 4; b0 < start; b0 += 4) wide_chunk<R, -1, false>(W, Lb, z, b0);
      wide_diagonal<R, 0, false>(W, Lb, z, start, n);
      slot_rows<kMode, R>(W, start, rows, acc, accm, out, aux, g, col, t);
    }
  }
  if (kMode == kTerminal) {
    for (int a = 0; a < n; ++a) {
      const size_t row = static_cast<size_t>(a) * g.n_pad + col;
      out[row] = __fmul_rn(rows[a].x, expf(acc[a]));
      if (g.anti) out[row + g.width] = __fmul_rn(rows[a].x, expf(accm[a]));
    }
  }
}

// Lets a wide instance take up to kMaxSmem of dynamic shared memory (once).
template <int kMode, int R, int kUnroll>
int slot_prepare() {
  static int err = static_cast<int>(cudaFuncSetAttribute(
      slot_wide_kernel<kMode, R, kUnroll>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxSmem));
  return err;
}

// The block size of a wide launch at n assets: of 64-512 threads, the one
// with the most resident threads an SM (the fewer threads a block on a
// tie); 0 where none fits. Chosen once a (mode, R, n), on the first
// launch's device.
template <int kMode, int R, int kUnroll>
int slot_block(int n) {
  static int chosen[kMaxAssets + 1] = {};
  if (n < 1 || n > kMaxAssets) return 0;
  if (chosen[n] > 0) return chosen[n];
  if (slot_prepare<kMode, R, kUnroll>() != 0) return 0;
  constexpr int kBlocks[] = {64, 96, 128, 160, 192, 256, 320, 384, 448, 512};
  int best = 0, best_threads = 0;
  for (int block : kBlocks) {
    const size_t smem = slot_smem(n, R, block);
    if (smem > static_cast<size_t>(kMaxSmem)) continue;
    int blocks = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &blocks, slot_wide_kernel<kMode, R, kUnroll>, block, smem) != cudaSuccess)
      continue;
    if (blocks * block > best_threads) {
      best_threads = blocks * block;
      best = block;
    }
  }
  chosen[n] = best;
  return best;
}

// One wide launch: consts on the card in wide_consts4(n, R) float4s
// (ops/cuda_basket.wide_constants); block 0 takes slot_block(n).
template <int kMode, int R, int kUnroll>
int launch_slot(float* out, float* aux, const float* consts, uint64_t seed, int first_tile,
                int n_tiles, int tile, int n_steps, int n, bool anti, int block,
                cudaStream_t st) {
  if (n < 1 || n > kMaxAssets || consts == nullptr ||
      reinterpret_cast<uintptr_t>(consts) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int err = slot_prepare<kMode, R, kUnroll>();
  if (err != 0) return err;
  if (block <= 0) block = slot_block<kMode, R, kUnroll>(n);
  if (block <= 0 || block > kSlotMaxBlock || slot_smem(n, R, block) > static_cast<size_t>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  SlotGrid g;
  g.first_tile = static_cast<uint32_t>(first_tile);
  g.tile = static_cast<uint32_t>(tile);
  g.width = anti ? g.tile / 2 : g.tile;
  g.n = n;
  g.n4 = round_up(n, 4);
  g.nr = round_up(n, R);
  g.stride = slot_stride(n, R);
  g.consts4 = wide_consts4(n, R);
  g.anti = anti;
  g.n_pad = static_cast<size_t>(n_tiles) * tile;
  const dim3 grid(static_cast<unsigned>(n_tiles), (g.width + block - 1) / block);
  if (grid.y > 65535u) return static_cast<int>(cudaErrorInvalidValue);
  slot_wide_kernel<kMode, R, kUnroll><<<grid, block, slot_smem(n, R, block), st>>>(
      out, aux, reinterpret_cast<const float4*>(consts), fast::philox_keys(seed), g, n_steps);
  return static_cast<int>(cudaGetLastError());
}

// Registers, local bytes, resident blocks an SM and block threads of a wide
// launch at n assets (kernel_attrs.cuh).
template <int kMode, int R, int kUnroll>
int slot_attrs(int n, int* out) {
  const int block = slot_block<kMode, R, kUnroll>(n);
  if (block <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  return omt::kernel_attrs(slot_wide_kernel<kMode, R, kUnroll>, block, out,
                           slot_smem(n, R, block));
}

// ---- the wide route split across groups --------------------------------------
// basket.cuh's wide_body under other unrolling and launch bounds than the
// package's basket_wide_kernel (kWideUnroll, kWideThreads): kCap 0, 512
// threads a block (128 registers); else 256 threads and at least kCap
// blocks an SM.
__host__ __device__ constexpr int cap_threads(int cap) { return cap == 0 ? 512 : 256; }
__host__ __device__ constexpr int cap_blocks(int cap) { return cap == 0 ? 1 : cap; }

template <int kMode, int R, int kUnroll, int kCap>
__global__ void __launch_bounds__(cap_threads(kCap), cap_blocks(kCap))
exp_wide_kernel(float* __restrict__ out, float* __restrict__ aux,
                const float4* __restrict__ consts, const __grid_constant__ fast::PhiloxKeys keys,
                const omt::basket::WideGrid g, int n_steps) {
  omt::basket::wide_body<kMode, R, kUnroll>(out, aux, consts, keys, g, n_steps);
}

// Slots a block of exp_wide_kernel at n assets (basket.cuh
// wide_best_slots), chosen once a (mode, R, unroll, cap, n).
template <int kMode, int R, int kUnroll, int kCap>
int exp_wide_slots(int n) {
  static const int err =
      omt::basket::wide_allow_smem(exp_wide_kernel<kMode, R, kUnroll, kCap>);
  static int chosen[kMaxAssets + 1] = {};
  if (err != 0 || n < 1 || n > kMaxAssets) return 0;
  if (chosen[n] == 0)
    chosen[n] = omt::basket::wide_best_slots<R>(exp_wide_kernel<kMode, R, kUnroll, kCap>,
                                                cap_threads(kCap), n);
  return chosen[n];
}

template <int kMode, int R, int kUnroll, int kCap>
int launch_exp_wide(float* out, const float* consts, uint64_t seed, const ExpGrid& g,
                    int n_steps, cudaStream_t st) {
  return omt::basket::wide_launch_with<R>(
      exp_wide_kernel<kMode, R, kUnroll, kCap>, cap_threads(kCap),
      exp_wide_slots<kMode, R, kUnroll, kCap>(g.n), out, out, consts, seed,
      static_cast<int>(g.first_tile), g.n_tiles, static_cast<int>(g.tile), n_steps, g.n, g.anti,
      st);
}

template <int kMode, int R, int kUnroll, int kCap>
int exp_wide_attrs(int n, int* out) {
  const int slots = exp_wide_slots<kMode, R, kUnroll, kCap>(n);
  if (slots <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  return omt::kernel_attrs(exp_wide_kernel<kMode, R, kUnroll, kCap>,
                           slots * omt::basket::wide_groups(n, R), out,
                           omt::basket::wide_smem(n, R, slots));
}

// The variants by number (scripts/exp_basket_generic.py VARIANTS): copy
// kernels (kKeys, kGrid2D, B) and fixed kernels (kConstsVal, kZReg,
// kAccReg, kKeys, kGrid2D, B, kSink); 12-21 the wide route (R, unroll).
#define OMT_EXP_COPY(X)                                                                    \
  X(0, false, false, 64) X(1, true, false, 64) X(2, false, true, 64) X(3, false, false, 128) \
  X(4, false, false, 256) X(11, true, true, 64)
#define OMT_EXP_FIXED(X)                                              \
  X(5, false, false, false, false, false, 64, false)                  \
  X(6, false, true, false, false, false, 64, false)                   \
  X(7, true, false, false, false, false, 64, false)                   \
  X(8, false, false, true, false, false, 64, false)                   \
  X(9, true, true, true, true, true, 256, false)                      \
  X(10, true, true, true, true, true, 256, true)
// the wide route with one slot a thread (R rows a block, the draw and
// chunk loops unrolled U times), and split across groups (basket.cuh)
#define OMT_EXP_SLOT(X) X(12, 4, 1) X(13, 8, 1) X(14, 16, 1) X(15, 8, 2) X(16, 16, 2)
// (R, unroll, kCap: 0 512 threads a block, else 256 and kCap blocks an SM)
#define OMT_EXP_WIDE(X) X(17, 4, 2, 0) X(18, 8, 1, 0) X(19, 8, 2, 0) X(20, 8, 2, 3) X(21, 8, 2, 4)

template <int B, typename Kernel>
int prepare(Kernel kernel, size_t smem) {
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)));
}

ExpGrid grid_of(int first_tile, int n_tiles, int tile, int n, bool anti) {
  ExpGrid g;
  g.first_tile = static_cast<uint32_t>(first_tile);
  g.tile = static_cast<uint32_t>(tile);
  g.width = anti ? g.tile / 2 : g.tile;
  g.n_tiles = n_tiles;
  g.n = n;
  g.anti = anti;
  g.n_pad = static_cast<size_t>(n_tiles) * tile;
  return g;
}

dim3 grid_dims(const ExpGrid& g, bool grid2d, int block) {
  if (grid2d) return dim3(static_cast<unsigned>(g.n_tiles), (g.width + block - 1) / block);
  const long long slots = static_cast<long long>(g.n_tiles) * g.width;
  return dim3(static_cast<unsigned>((slots + block - 1) / block));
}

template <bool kKeys, bool kGrid2D, int B, int kMode>
int run_copy(float* out, const float* consts, uint64_t seed, const ExpGrid& g, int n_steps,
             cudaStream_t st) {
  const size_t smem = sizeof(float) * (n_consts(g.n) + 3u * g.n * B);
  const int err = prepare<B>(copy_kernel<kKeys, kGrid2D, B, kMode>, smem);
  if (err != 0) return err;
  copy_kernel<kKeys, kGrid2D, B, kMode><<<grid_dims(g, kGrid2D, B), B, smem, st>>>(
      out, consts, seed, omt::fast::philox_keys(seed), g, n_steps);
  return static_cast<int>(cudaGetLastError());
}

template <bool kConstsVal, bool kZReg, bool kAccReg, int B>
constexpr size_t fixed_smem() {
  return sizeof(float) * ((kConstsVal ? 0 : n_consts(N12)) + (kZReg ? 0 : 12 * B) +
                          (kAccReg ? 0 : 2 * N12 * B));
}

template <bool kConstsVal, bool kZReg, bool kAccReg, bool kKeys, bool kGrid2D, int B, bool kSink,
          int kMode>
int run_fixed(float* out, const float* host_consts, const float* consts, uint64_t seed,
              const ExpGrid& g, int n_steps, cudaStream_t st) {
  if (g.n != N12) return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  for (int i = 0; i < n_consts(N12); ++i) p.c[i] = host_consts[i];
  constexpr size_t smem = fixed_smem<kConstsVal, kZReg, kAccReg, B>();
  auto kernel = fixed_kernel<kConstsVal, kZReg, kAccReg, kKeys, kGrid2D, B, kSink, kMode>;
  const int err = prepare<B>(kernel, smem);
  if (err != 0) return err;
  kernel<<<grid_dims(g, kGrid2D, B), B, smem, st>>>(out, consts, p, seed,
                                                     omt::fast::philox_keys(seed), g, n_steps);
  return static_cast<int>(cudaGetLastError());
}

template <int kMode>
int run(int variant, float* out, const float* h, const float* c, uint64_t seed,
        const ExpGrid& g, int n_steps, cudaStream_t st) {
  switch (variant) {
#define OMT_RUN_COPY(V, KEYS, G2, B) \
  case V:                           \
    return run_copy<KEYS, G2, B, kMode>(out, c, seed, g, n_steps, st);
    OMT_EXP_COPY(OMT_RUN_COPY)
#undef OMT_RUN_COPY
#define OMT_RUN_FIXED(V, CV, ZR, AR, KEYS, G2, B, SINK) \
  case V:                                              \
    return run_fixed<CV, ZR, AR, KEYS, G2, B, SINK, kMode>(out, h, c, seed, g, n_steps, st);
    OMT_EXP_FIXED(OMT_RUN_FIXED)
#undef OMT_RUN_FIXED
#define OMT_RUN_SLOT(V, R, U)                                                               \
  case V:                                                                                   \
    return launch_slot<kMode, R, U>(out, out, c, seed, static_cast<int>(g.first_tile),      \
                                    g.n_tiles, static_cast<int>(g.tile), n_steps, g.n,      \
                                    g.anti, 0, st);
    OMT_EXP_SLOT(OMT_RUN_SLOT)
#undef OMT_RUN_SLOT
#define OMT_RUN_WIDE(V, R, U, CAP) \
  case V:                          \
    return launch_exp_wide<kMode, R, U, CAP>(out, c, seed, g, n_steps, st);
    OMT_EXP_WIDE(OMT_RUN_WIDE)
#undef OMT_RUN_WIDE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int kMode>
int attrs(int variant, int n, int* out) {
  switch (variant) {
#define OMT_ATTR_COPY(V, KEYS, G2, B)                                                    \
  case V: {                                                                              \
    const size_t smem = sizeof(float) * (n_consts(n) + 3u * n * B);                      \
    const int err = prepare<B>(copy_kernel<KEYS, G2, B, kMode>, smem);                   \
    if (err != 0) return err;                                                            \
    return omt::kernel_attrs(copy_kernel<KEYS, G2, B, kMode>, B, out, smem);             \
  }
    OMT_EXP_COPY(OMT_ATTR_COPY)
#undef OMT_ATTR_COPY
#define OMT_ATTR_FIXED(V, CV, ZR, AR, KEYS, G2, B, SINK)                                  \
  case V: {                                                                              \
    constexpr size_t smem = fixed_smem<CV, ZR, AR, B>();                                 \
    auto kernel = fixed_kernel<CV, ZR, AR, KEYS, G2, B, SINK, kMode>;                    \
    const int err = prepare<B>(kernel, smem);                                            \
    if (err != 0) return err;                                                            \
    return omt::kernel_attrs(kernel, B, out, smem);                                      \
  }
    OMT_EXP_FIXED(OMT_ATTR_FIXED)
#undef OMT_ATTR_FIXED
#define OMT_ATTR_SLOT(V, R, U) \
  case V:                      \
    return slot_attrs<kMode, R, U>(n, out);
    OMT_EXP_SLOT(OMT_ATTR_SLOT)
#undef OMT_ATTR_SLOT
#define OMT_ATTR_WIDE(V, R, U, CAP) \
  case V:                           \
    return exp_wide_attrs<kMode, R, U, CAP>(n, out);
    OMT_EXP_WIDE(OMT_ATTR_WIDE)
#undef OMT_ATTR_WIDE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// One launch of ``variant`` at n assets: out on the card, (n_steps + 1, n,
// n_tiles tile) float32 with ``paths``, else (n, n_tiles tile); host_consts
// as omt_basket's; consts on the card: the packed constants (variants
// 0-11) or the wide route's at R rows (ops/cuda_basket.wide_constants;
// 12-21).
int exp_basket_generic(int variant, void* out, const void* host_consts, const void* consts,
                       uint64_t seed, int first_tile, int n_tiles, int tile, int n_steps, int n,
                       int antithetic, int paths, void* stream) {
  if (n < 1 || n > omt::basket::kMaxAssets) return static_cast<int>(cudaErrorInvalidValue);
  const ExpGrid g = grid_of(first_tile, n_tiles, tile, n, antithetic != 0);
  float* o = static_cast<float*>(out);
  const float* h = static_cast<const float*>(host_consts);
  const float* c = static_cast<const float*>(consts);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return paths ? run<kPaths>(variant, o, h, c, seed, g, n_steps, st)
               : run<kTerminal>(variant, o, h, c, seed, g, n_steps, st);
}

// Registers, local bytes, resident blocks per SM and block threads of a
// variant at n assets.
int exp_basket_generic_attrs(int variant, int n, int paths, int* out) {
  return paths ? attrs<kPaths>(variant, n, out) : attrs<kTerminal>(variant, n, out);
}

}  // extern "C"
