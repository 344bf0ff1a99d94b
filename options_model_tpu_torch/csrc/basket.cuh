// What csrc/basket.cu's kernels share with scripts/exp_basket_generic.cu:
// the basket stream's constants, the launch modes, the log step, and the
// route of kernels 27-28 from kRegisterAssets + 1 to kMaxAssets assets,
// basket_wide_kernel<kMode, R>.
//
// The wide route splits a slot (an antithetic pair, or one path) across G
// threads, one a group: the rows of W come in blocks of R, and group g owns
// blocks g and nb - 1 - g (nb = ceil(n / R) blocks, G = ceil(nb / 2)
// groups), so every group takes about the same products, and keeps the log
// states of its 2 R rows (acc and the mirror's acc) in registers. A block
// of threads is S slots by G groups (threadIdx.x the slot, so a warp holds
// 32 slots of one group: its loads of L and of the constants are broadcasts
// and its stores coalesce). The slot's z, 4 n bytes, is the only state in
// shared memory, twice (the step's parity), so that one barrier a step
// orders the draws before the products: a step's draws are spread over the
// groups (group g makes calls g, g + G, ...), and a buffer is written again
// two steps on, after the next step's barrier, which no thread passes
// before every thread has read it. A record's stride is an odd number of
// float4, so a warp's 16-byte loads of 32 slots' z hit every bank once a
// quarter-warp. The correlate walks a block's columns four at a time: the R
// partial sums W_r stay in registers, and each z_b loaded (as a float4 of
// four columns) feeds R products, so the R chains run side by side. L is
// packed on the host in row-block-major order (ops/cuda_basket.
// pack_row_blocks): for block rb and column b < (rb + 1) R, the R
// coefficients L[rb R + r, b] contiguous, loaded as R / 4 float4
// broadcasts. Every row still sums over ascending b with __fmul_rn then
// __fadd_rn, its first column a product alone, so W is the plain version's
// bit for bit; a row takes no product past its diagonal, by a predicate
// fixed at compile time (the row and column within the block), never by a
// zero coefficient, so no 0 z is ever added.
//
// The launch has kernel 28's redesigned shape: the ten Philox round keys
// once a launch (fast::PhiloxKeys as a __grid_constant__), a 2-D grid (x the
// local tile, y a block of slots in it) that finds a slot with no
// division, and the constants ((s0, drift, vol, 0) a row and the packed L)
// copied to shared memory once a block. S is chosen by n at the first
// launch (wide_slots): the one with the most resident threads an SM at
// the kernel's registers and shared memory.
#pragma once

#include "hopper_fast.cuh"
#include "kernel_attrs.cuh"

namespace omt {
namespace basket {

constexpr uint32_t kStream = 6u;
constexpr int kMaxAssets = 128;
// Up to kRegisterAssets the state lives in registers (compile-time
// instances, the constants by value); above it the wide route.
constexpr int kRegisterAssets = 16;
// What a launch writes: S_T (kernel 28), S paths (kernel 27), the
// log-states and W (debug), S_T by kernel 28's first design, and S_T or S
// paths by the first design of the route from 9 assets (the generic
// instance, basket.cu's basket_generic_kernel), the yardsticks.
enum Mode {
  kTerminal = 0,
  kPaths = 1,
  kDebug = 2,
  kTerminalFirst = 3,
  kGenericTerminal = 4,
  kGenericPaths = 5
};

__host__ __device__ constexpr int n_consts(int n) { return 3 * n + n * (n + 1) / 2; }

__device__ __forceinline__ float log_step(float acc, float drift, float vol, float W) {
  return __fadd_rn(acc, __fadd_rn(drift, __fmul_rn(vol, W)));
}

// ---- the wide route ------------------------------------------------------
// Rows of a block (ops/cuda_basket.WIDE_ROWS); row blocks a group.
constexpr int kWideRows = 8;
constexpr int kWideBlocks = 2;
// The chunk loop's unrolling: two chunks' loads in flight.
constexpr int kWideUnroll = 2;
// Threads a block at most (the launch bounds: 128 registers a thread).
constexpr int kWideThreads = 512;
constexpr int kMaxSmem = 232448;  // 227 KB, a block's dynamic shared memory at most

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Floats of L packed in row blocks of R: block rb holds (rb + 1) R columns of R.
__host__ __device__ constexpr int wide_l_floats(int n, int R) {
  return R * R * (round_up(n, R) / R) * (round_up(n, R) / R + 1) / 2;
}

// float4s of the constants: (s0, drift, vol, 0) of each padded row, then L.
__host__ __device__ constexpr int wide_consts4(int n, int R) {
  return round_up(n, R) + wide_l_floats(n, R) / 4;
}

// Groups of a wide launch: each owns two row blocks (the middle one alone
// at an odd count).
__host__ __device__ constexpr int wide_groups(int n, int R) {
  return (round_up(n, R) / R + 1) / 2;
}

// A slot's z record in floats: whole Philox calls, an odd number of float4.
__host__ __device__ constexpr int wide_zstride(int n) {
  return round_up(n, 4) % 8 == 0 ? round_up(n, 4) + 4 : round_up(n, 4);
}

inline size_t wide_smem(int n, int R, int slots) {
  return 16u * static_cast<size_t>(wide_consts4(n, R)) +
         8u * static_cast<size_t>(slots) * static_cast<size_t>(wide_zstride(n));
}

struct WideGrid {
  uint32_t first_tile, tile, width;
  int n, nb, calls, zstride, consts4;
  bool anti;
  size_t n_pad;
};

// Columns b0 .. b0 + 3 of a row block's correlate: W_r (+)= L[r, b] z_b,
// each product rounded and then added (a row's first column a product
// alone, kFirst). kD0 >= 0: a chunk of the block's diagonal, whose first
// column lies kD0 past the block's first row; there row r takes column
// b0 + i only where r >= kD0 + i (fixed at compile time).
template <int R, int kD0, bool kFirst>
__device__ __forceinline__ void wide_chunk(float (&W)[R], const float4* __restrict__ Lb,
                                           const float* __restrict__ z, int b0) {
  const float4 zv = *reinterpret_cast<const float4*>(z + b0);
  const float zb[4] = {zv.x, zv.y, zv.z, zv.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float c[R];
#pragma unroll
    for (int q = 0; q < R / 4; ++q) {
      const float4 v = Lb[(b0 + i) * (R / 4) + q];
      c[4 * q] = v.x;
      c[4 * q + 1] = v.y;
      c[4 * q + 2] = v.z;
      c[4 * q + 3] = v.w;
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (kD0 >= 0 && r < kD0 + i) continue;
      const float p = __fmul_rn(c[r], zb[i]);
      W[r] = (kFirst && i == 0) ? p : __fadd_rn(W[r], p);
    }
  }
}

// The diagonal of the block whose first row is ``start``: its chunks Q, Q + 1,
// ... up to the last one holding a column below n.
template <int R, int Q, bool kFirst>
__device__ __forceinline__ void wide_diagonal(float (&W)[R], const float4* __restrict__ Lb,
                                              const float* __restrict__ z, int start, int n) {
  if constexpr (Q < R / 4) {
    const int b0 = start + 4 * Q;
    if (b0 < n) {
      wide_chunk<R, 4 * Q, kFirst && Q == 0>(W, Lb, z, b0);
      wide_diagonal<R, Q + 1, false>(W, Lb, z, start, n);
    }
  }
}

// W of row block rb (rows rb R .. rb R + R - 1) from the slot's z: the
// columns below the block in chunks of four, then its diagonal.
template <int R, int kUnroll>
__device__ __forceinline__ void wide_block_w(float (&W)[R], const float4* __restrict__ L,
                                             const float* __restrict__ z, int rb, int n) {
  const int start = rb * R;
  const float4* Lb = L + (R / 4) * (R * rb * (rb + 1) / 2);
  if (rb == 0) {
    wide_diagonal<R, 0, true>(W, Lb, z, 0, n);
    return;
  }
  wide_chunk<R, -1, true>(W, Lb, z, 0);
#pragma unroll(kUnroll)
  for (int b0 = 4; b0 < start; b0 += 4) wide_chunk<R, -1, false>(W, Lb, z, b0);
  wide_diagonal<R, 0, false>(W, Lb, z, start, n);
}

// The log steps of block rb's rows from W, and their stores at step t
// (S in kPaths; acc and W in kDebug). Rows past n (the last block's
// padding) step on zero constants and are never stored.
template <int kMode, int R>
__device__ __forceinline__ void wide_step(const float (&W)[R], float (&x)[R], float (&xm)[R],
                                          int rb, const float4* __restrict__ rows,
                                          float* __restrict__ out, float* __restrict__ aux,
                                          const WideGrid& g, size_t col, bool active, int t) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int a = rb * R + r;
    const float4 rc = rows[a];
    x[r] = log_step(x[r], rc.y, rc.z, W[r]);
    if (g.anti) xm[r] = log_step(xm[r], rc.y, rc.z, -W[r]);
    if (kMode != kTerminal && active && a < g.n) {
      const size_t row = (static_cast<size_t>(t + 1) * g.n + a) * g.n_pad + col;
      if (kMode == kPaths) {
        out[row] = __fmul_rn(rc.x, expf(x[r]));
        if (g.anti) out[row + g.width] = __fmul_rn(rc.x, expf(xm[r]));
      } else {
        const size_t wrow = (static_cast<size_t>(t) * g.n + a) * g.n_pad + col;
        out[row] = x[r];
        aux[wrow] = W[r];
        if (g.anti) {
          out[row + g.width] = xm[r];
          aux[wrow + g.width] = -W[r];
        }
      }
    }
  }
}

// The body of kernels 27-28 from kRegisterAssets + 1 assets (kTerminal,
// kPaths, kDebug): a block of blockDim.x slots by blockDim.y =
// wide_groups(n, R) groups. kUnroll: the chunk loop's unrolling.
template <int kMode, int R, int kUnroll>
__device__ __forceinline__ void wide_body(float* __restrict__ out, float* __restrict__ aux,
                                          const float4* __restrict__ consts,
                                          const fast::PhiloxKeys& keys, const WideGrid& g,
                                          int n_steps) {
  extern __shared__ float4 wide_shared[];
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int i = tid; i < g.consts4; i += blockDim.x * blockDim.y) wide_shared[i] = consts[i];
  const int slots = blockDim.x, G = blockDim.y, grp = threadIdx.y;
  const uint32_t j = blockIdx.y * slots + threadIdx.x;
  const bool active = j < g.width;
  const float4* rows = wide_shared;
  const float4* L = wide_shared + R * g.nb;
  float* z0 = reinterpret_cast<float*>(wide_shared + g.consts4) + threadIdx.x * g.zstride;
  const int zbuf = slots * g.zstride;
  const uint32_t gt = g.first_tile + blockIdx.x;
  const size_t col = static_cast<size_t>(blockIdx.x) * g.tile + j;
  const int n = g.n;
  // the group's row blocks: grp and, where it is another, nb - 1 - grp
  int rb[kWideBlocks];
  rb[0] = grp;
  rb[1] = g.nb - 1 - grp;
  const bool second = rb[1] > rb[0];
  float x[kWideBlocks][R], xm[kWideBlocks][R];
#pragma unroll
  for (int k = 0; k < kWideBlocks; ++k) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      x[k][r] = 0.0f;
      xm[k][r] = 0.0f;
    }
  }
  __syncthreads();
  if (kMode != kTerminal && active) {
#pragma unroll
    for (int k = 0; k < kWideBlocks; ++k) {
      if (k == 1 && !second) break;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int a = rb[k] * R + r;
        if (a >= n) break;
        const size_t row = static_cast<size_t>(a) * g.n_pad + col;
        const float v = kMode == kPaths ? rows[a].x : 0.0f;
        out[row] = v;
        if (g.anti) out[row + g.width] = v;
      }
    }
  }
#pragma unroll 1
  for (int t = 0; t < n_steps; ++t) {
    float* z = z0 + (t & 1) * zbuf;
#pragma unroll 1
    for (int k = grp; k < g.calls; k += G) {
      const Words w = fast::philox_keyed(
          Words{j, static_cast<uint32_t>(t * g.calls + k), gt, kStream}, keys);
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
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kWideBlocks; ++k) {
      if (k == 1 && !second) break;
      float W[R];
      wide_block_w<R, kUnroll>(W, L, z, rb[k], n);
      wide_step<kMode, R>(W, x[k], xm[k], rb[k], rows, out, aux, g, col, active, t);
    }
  }
  if (kMode == kTerminal && active) {
#pragma unroll
    for (int k = 0; k < kWideBlocks; ++k) {
      if (k == 1 && !second) break;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int a = rb[k] * R + r;
        if (a >= n) break;
        const size_t row = static_cast<size_t>(a) * g.n_pad + col;
        const float s0 = rows[a].x;
        out[row] = __fmul_rn(s0, expf(x[k][r]));
        if (g.anti) out[row + g.width] = __fmul_rn(s0, expf(xm[k][r]));
      }
    }
  }
}

// Kernels 27-28 from kRegisterAssets + 1 assets.
template <int kMode, int R>
__global__ void __launch_bounds__(kWideThreads, 1)
basket_wide_kernel(float* __restrict__ out, float* __restrict__ aux,
                   const float4* __restrict__ consts,
                   const __grid_constant__ fast::PhiloxKeys keys, const WideGrid g,
                   int n_steps) {
  wide_body<kMode, R, kWideUnroll>(out, aux, consts, keys, g, n_steps);
}

// Lets ``kernel`` (a wide_body kernel) take up to kMaxSmem of dynamic
// shared memory.
template <typename Kernel>
int wide_allow_smem(Kernel kernel) {
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem));
}

// Slots a block of a launch of ``kernel`` (R rows a block, at most
// max_threads threads a block) at n assets: of 32-512, the count with the
// most resident threads an SM (the fewer slots on a tie); 0 where none
// fits.
template <int R, typename Kernel>
int wide_best_slots(Kernel kernel, int max_threads, int n) {
  const int groups = wide_groups(n, R);
  int best = 0, best_threads = 0;
  for (int slots = 32; slots <= 512; slots *= 2) {
    const size_t smem = wide_smem(n, R, slots);
    if (slots * groups > max_threads || smem > static_cast<size_t>(kMaxSmem)) continue;
    int blocks = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, slots * groups, smem) !=
        cudaSuccess)
      continue;
    if (blocks * slots * groups > best_threads) {
      best_threads = blocks * slots * groups;
      best = slots;
    }
  }
  return best;
}

// One launch of ``kernel`` at ``slots`` slots a block: consts on the card
// in wide_consts4(n, R) float4s (ops/cuda_basket.wide_constants).
template <int R, typename Kernel>
int wide_launch_with(Kernel kernel, int max_threads, int slots, float* out, float* aux,
                     const float* consts, uint64_t seed, int first_tile, int n_tiles, int tile,
                     int n_steps, int n, bool anti, cudaStream_t st) {
  if (n < 1 || n > kMaxAssets || consts == nullptr ||
      reinterpret_cast<uintptr_t>(consts) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int groups = wide_groups(n, R);
  if (slots <= 0 || slots * groups > max_threads ||
      wide_smem(n, R, slots) > static_cast<size_t>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  WideGrid g;
  g.first_tile = static_cast<uint32_t>(first_tile);
  g.tile = static_cast<uint32_t>(tile);
  g.width = anti ? g.tile / 2 : g.tile;
  g.n = n;
  g.nb = round_up(n, R) / R;
  g.calls = round_up(n, 4) / 4;
  g.zstride = wide_zstride(n);
  g.consts4 = wide_consts4(n, R);
  g.anti = anti;
  g.n_pad = static_cast<size_t>(n_tiles) * tile;
  const dim3 grid(static_cast<unsigned>(n_tiles), (g.width + slots - 1) / slots);
  if (grid.y > 65535u) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<grid, dim3(slots, groups), wide_smem(n, R, slots), st>>>(
      out, aux, reinterpret_cast<const float4*>(consts), fast::philox_keys(seed), g, n_steps);
  return static_cast<int>(cudaGetLastError());
}

// The slots a block of basket_wide_kernel<kMode, R> at n assets
// (wide_best_slots), chosen once a (mode, R, n) on the first launch's
// device; 0 where none fits.
template <int kMode, int R>
int wide_slots(int n) {
  static const int err = wide_allow_smem(basket_wide_kernel<kMode, R>);
  static int chosen[kMaxAssets + 1] = {};
  if (err != 0 || n < 1 || n > kMaxAssets) return 0;
  if (chosen[n] == 0) chosen[n] = wide_best_slots<R>(basket_wide_kernel<kMode, R>, kWideThreads, n);
  return chosen[n];
}

// One launch of basket_wide_kernel<kMode, R> at wide_slots(n) slots a block.
template <int kMode, int R>
int launch_wide(float* out, float* aux, const float* consts, uint64_t seed, int first_tile,
                int n_tiles, int tile, int n_steps, int n, bool anti, cudaStream_t st) {
  return wide_launch_with<R>(basket_wide_kernel<kMode, R>, kWideThreads, wide_slots<kMode, R>(n),
                             out, aux, consts, seed, first_tile, n_tiles, tile, n_steps, n, anti,
                             st);
}

// Registers, local bytes, resident blocks an SM and block threads of a wide
// launch at n assets (kernel_attrs.cuh).
template <int kMode, int R>
int wide_attrs(int n, int* out) {
  const int slots = wide_slots<kMode, R>(n);
  if (slots <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  return kernel_attrs(basket_wide_kernel<kMode, R>, slots * wide_groups(n, R), out,
                      wide_smem(n, R, slots));
}

}  // namespace basket
}  // namespace omt
