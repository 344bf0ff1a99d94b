// Jump kernels for Hopper (sm_90a): the Merton jump diffusion's paths and
// terminal values, and the Bates jump overlay applied in place to a Heston
// kernel's output.
//
// The JAX package computes these in XLA code, not in Pallas:
//   options_model_tpu/models/merton.py:27  simulate_merton (return_paths True: kernel 14,
//                                          False: kernel 15)
//   options_model_tpu/models/bates.py:40   jump_overlay (return_paths True: kernel 16,
//                                          False: kernel 17), times the Heston S
// XLA fuses each into one pass over its draws; eager torch would not, and
// the port's random stream is Philox keyed by (seed, global tile, draw), so
// each is a kernel here with a plain PyTorch version on the same counters
// (ops/cuda_jumps.py; ops/philox.py states the stream contract).
//
// - merton_kernel<kPaths>: the first design of kernels 14 (paths) and 15
//   (terminal), kept as the yardstick of their redesigns,
//   merton_paths_kernel and merton_terminal_kernel (below), which the
//   pricers reach. One thread owns one antithetic pair (or one path) and
//   carries x = log S - log S0 of both mirror paths in registers. One
//   Philox call per pair-step (counter = (slot, step, global tile, 0)):
//   (w0, w1) -> Box-Muller -> (z, z_j), mirrored; w2, w3 -> the Poisson
//   uniforms of the path and of its mirror. x += drift + sigma sqrt(dt) z +
//   N mu_j + sigma_j sqrt(N) z_j. The paths instance stores every row as
//   2^(log2 S0 + x log2 e) (store_s), the terminal instance S_T only.
// - overlay_paths_first_kernel: the first design of kernel 16, the
//   yardstick of its redesign overlay_paths_kernel (below). One thread per
//   path column of a (n_mat, n_steps+1, n_pad) Heston S, maturity m on
//   global tiles first_tile + m n_tiles + .., as the batched Heston kernel
//   draws them. One Philox call per path-step (counter word 3 = 1, never
//   mirrored): z_j and the Poisson uniform. y += N mu_j + sigma_j sqrt(N)
//   z_j - lam kbar dt; S[t+1] *= exp(y), read and written once each.
// - overlay_terminal_first_kernel: S_T *= exp(N mu_j + sigma_j sqrt(N) z_j
//   - lam kbar T), N ~ Poisson(lam T), one call per path at draw n_steps:
//   the first design of kernel 17, the yardstick of its redesign
//   overlay_terminal_kernel (below).
//
// Poisson counts are drawn by inversion: the count is the number of entries
// of the host's float32 CDF table (ops/philox.poisson_table) the uniform is
// not below, the same float32 comparisons as the plain version, so the
// counts are equal bit for bit. The table sits in the constants row the
// wrapper copies to the card (kRow floats per maturity: a, diffusion, mu_j,
// sigma_j, log S0, table length, the head F(0), F(1) (2 past the table's
// end), the table); the scan stops at the first entry above u (one or two
// entries at the bench's lam dt).
//
// What bounds them on the card: kernel 14 writes 4 bytes per path-step
// (0.063 ms at 2^20 x 50 and 3.35 TB/s), kernel 16 reads and writes 4 each;
// kernels 15 and 17 store one float per path and are held by the Philox
// integer work (chip_smoke.bound). The first designs: Philox's round keys
// once per launch, the SFU Box-Muller, the count's scan through L1, and
// nothing else tuned. An optional int32 ``counts`` output (null on the
// pricing path) writes each draw's count, so a check can hold them against
// the plain version's bit for bit.
#include "hopper_fast.cuh"
#include "kernel_attrs.cuh"

namespace omt {
namespace jumps {

using namespace fast;

constexpr int kPathTile = 4096;
constexpr int kTerminalTile = 16384;
constexpr int kBlock = 128;
// A constants row: 8 floats (slots 6 and 7 the table's head F(0), F(1)),
// then at most kMaxTable Poisson CDF entries (ops/philox.MAX_POISSON_TABLE,
// ops/cuda_jumps.ROW).
constexpr int kRow = 128;
constexpr int kHead = 8;
constexpr int kMaxTable = kRow - kHead;
constexpr uint32_t kOverlayStream = 1u;

struct JumpK {
  float a;          // per-step constant: Merton's drift, the overlay's -lam kbar dt
  float diffusion;  // sigma sqrt(dt) (Merton; 0 for the overlay)
  float mu_j, sigma_j;
  float log2_s0;    // Merton only
  int n_table;
  const float* table;
};

__device__ __forceinline__ JumpK jump_consts(const float* __restrict__ row) {
  return JumpK{__ldg(row), __ldg(row + 1), __ldg(row + 2), __ldg(row + 3),
               __ldg(row + 4) * kLog2e, static_cast<int>(__ldg(row + 5)), row + kHead};
}

// The number of table entries u is not below: a Poisson count by inversion.
__device__ __forceinline__ float poisson_count(float u, const JumpK& k) {
  int n = 0;
  while (n < k.n_table && u >= __ldg(k.table + n)) ++n;
  return static_cast<float>(n);
}

// N mu_j + sigma_j sqrt(N) z_j: a step's summed log-jump given its count.
__device__ __forceinline__ float jump_sum(float n, float z_j, const JumpK& k) {
  return fmaf(n, k.mu_j, k.sigma_j * sqrtf(n) * z_j);
}

template <bool kPaths, bool kAnti>
__global__ void __launch_bounds__(kBlock)
merton_kernel(float* __restrict__ S, int* __restrict__ counts, const float* __restrict__ consts,
              const __grid_constant__ PhiloxKeys keys, int first_tile, int n_tiles,
              int n_steps) {
  constexpr int kTile = kPaths ? kPathTile : kTerminalTile;
  constexpr int kWidth = kAnti ? kTile / 2 : kTile;
  const long long slot = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (slot >= static_cast<long long>(n_tiles) * kWidth) return;
  const int local_tile = static_cast<int>(slot / kWidth);
  const uint32_t j = static_cast<uint32_t>(slot % kWidth);
  const uint32_t global_tile = static_cast<uint32_t>(first_tile + local_tile);
  const size_t n_pad = static_cast<size_t>(n_tiles) * kTile;
  const size_t col = static_cast<size_t>(local_tile) * kTile + j;
  const JumpK k = jump_consts(consts);

  float xa = 0.0f, xb = 0.0f;
  if (kPaths) {
    store_s(S + col, 0.0f, k.log2_s0);
    if (kAnti) store_s(S + col + kWidth, 0.0f, k.log2_s0);
  }
#pragma unroll 1
  for (int t = 0; t < n_steps; ++t) {
    const Words w =
        philox_keyed(Words{j, static_cast<uint32_t>(t), global_tile, 0u}, keys);
    float z, z_j;
    box_muller_fast(w.x, w.y, z, z_j);
    const float na = poisson_count(uniform_from_bits(w.z), k);
    xa += fmaf(k.diffusion, z, k.a) + jump_sum(na, z_j, k);
    const size_t row = static_cast<size_t>(t + 1) * n_pad + col;
    if (kPaths) store_s(S + row, xa, k.log2_s0);
    if (counts != nullptr) counts[row - n_pad] = static_cast<int>(na);
    if (kAnti) {
      const float nb = poisson_count(uniform_from_bits(w.w), k);
      xb += fmaf(k.diffusion, -z, k.a) + jump_sum(nb, -z_j, k);
      if (kPaths) store_s(S + row + kWidth, xb, k.log2_s0);
      if (counts != nullptr) counts[row - n_pad + kWidth] = static_cast<int>(nb);
    }
  }
  if (!kPaths) {
    S[col] = ex2_approx(fmaf(xa, kLog2e, k.log2_s0));
    if (kAnti) S[col + kWidth] = ex2_approx(fmaf(xb, kLog2e, k.log2_s0));
  }
}

__global__ void __launch_bounds__(kBlock)
overlay_paths_first_kernel(float* __restrict__ S, int* __restrict__ counts,
                           const float* __restrict__ consts,
                           const __grid_constant__ PhiloxKeys keys, int first_tile, int n_tiles,
                           int n_steps, int n_mat) {
  const long long n_pad = static_cast<long long>(n_tiles) * kPathTile;
  const long long id = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (id >= n_pad * n_mat) return;
  const int m = static_cast<int>(id / n_pad);
  const long long col = id % n_pad;
  const uint32_t j = static_cast<uint32_t>(col % kPathTile);
  const uint32_t global_tile =
      static_cast<uint32_t>(first_tile + m * n_tiles + static_cast<int>(col / kPathTile));
  const JumpK k = jump_consts(consts + static_cast<size_t>(m) * kRow);
  float* s = S + static_cast<size_t>(m) * (n_steps + 1) * n_pad + col;
  int* c = counts != nullptr ? counts + static_cast<size_t>(m) * n_steps * n_pad + col
                             : nullptr;

  float y = 0.0f;
#pragma unroll 1
  for (int t = 0; t < n_steps; ++t) {
    const Words w = philox_keyed(
        Words{j, static_cast<uint32_t>(t), global_tile, kOverlayStream}, keys);
    float z_j, unused;
    box_muller_fast(w.x, w.y, z_j, unused);
    const float n = poisson_count(uniform_from_bits(w.z), k);
    y += jump_sum(n, z_j, k) + k.a;
    float* p = s + static_cast<size_t>(t + 1) * n_pad;
    __stcs(p, __ldcs(p) * ex2_approx(y * kLog2e));
    if (c != nullptr) c[static_cast<size_t>(t) * n_pad] = static_cast<int>(n);
  }
}

__global__ void __launch_bounds__(kBlock)
overlay_terminal_first_kernel(float* __restrict__ S, int* __restrict__ counts,
                              const float* __restrict__ consts,
                              const __grid_constant__ PhiloxKeys keys, int first_tile,
                              int n_tiles, int n_steps) {
  const long long id = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (id >= static_cast<long long>(n_tiles) * kTerminalTile) return;
  const uint32_t j = static_cast<uint32_t>(id % kTerminalTile);
  const uint32_t global_tile = static_cast<uint32_t>(first_tile + id / kTerminalTile);
  const JumpK k = jump_consts(consts);
  const Words w = philox_keyed(
      Words{j, static_cast<uint32_t>(n_steps), global_tile, kOverlayStream}, keys);
  float z_j, unused;
  box_muller_fast(w.x, w.y, z_j, unused);
  const float n = poisson_count(uniform_from_bits(w.z), k);
  S[id] = S[id] * ex2_approx((jump_sum(n, z_j, k) + k.a) * kLog2e);
  if (counts != nullptr) counts[id] = static_cast<int>(n);
}

inline unsigned int blocks_for(long long n_threads) {
  return static_cast<unsigned int>((n_threads + kBlock - 1) / kBlock);
}

// ---- merton_terminal_kernel: the redesign of merton_kernel<false, *> ------
//
// The first design issued ~170 instructions a pair-step where Philox needs
// 36 (its SASS, chip_smoke.phase_sass): each Poisson count a dependent
// __ldg scan, each sqrtf(N) IEEE's, whose N = 0 takes its slow-path call,
// and the counts output's address work on every step, null or not. The
// redesign keeps the stream, the counts and the constants row, and:
// - counts 0 and 1 by one comparison with F(0), a launch constant in the
//   parameter space (PoissonHead); a uniform not below F(1), rare at the
//   bench's lam dt (~1e-5), scans the row's table from entry 2. Every
//   comparison is the plain version's float32 u >= F(n), so the counts are
//   bit for bit the same;
// - sqrt(N) from the host's table of IEEE square roots (0..15; sqrtf past
//   it): the same bits as sqrtf, without its special-case branch;
// - the counts output a template flag, so the pricing instance has none of
//   its work;
// - two steps an iteration, two Philox calls in flight.

// CDF entries a thread compares against (F(0), F(1)) and counts whose
// square root comes from the table (ops/cuda_jumps.POISSON_HEAD, SQRT_TABLE).
constexpr int kHeadCdf = 2;
constexpr int kSqrtTable = 16;

// A launch's head of the Poisson table (entries past the table's end 2, above
// every uniform) and the square roots of 0..kSqrtTable-1
// (ops/cuda_jumps.poisson_head).
struct PoissonHead {
  float cdf[kHeadCdf];
  float sqrt_n[kSqrtTable];
};

// (N, sqrt N) of the uniform u: N the number of table entries u is not below.
__device__ __forceinline__ void poisson_head_count(float u, const PoissonHead& h,
                                                   const JumpK& k, float& n, float& sn) {
  const bool one = u >= h.cdf[0];
  n = one ? 1.0f : 0.0f;
  sn = one ? h.sqrt_n[1] : h.sqrt_n[0];
  if (u >= h.cdf[1]) {
    int m = kHeadCdf;
    while (m < k.n_table && u >= __ldg(k.table + m)) ++m;
    n = static_cast<float>(m);
    sn = m < kSqrtTable ? h.sqrt_n[m] : sqrtf(n);
  }
}

template <bool kAnti, bool kCounts>
__global__ void __launch_bounds__(kBlock)
merton_terminal_kernel(float* __restrict__ S, int* __restrict__ counts,
                       const float* __restrict__ consts, const __grid_constant__ PhiloxKeys keys,
                       const __grid_constant__ PoissonHead head, int first_tile, int n_tiles,
                       int n_steps) {
  constexpr int kWidth = kAnti ? kTerminalTile / 2 : kTerminalTile;
  const long long slot = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (slot >= static_cast<long long>(n_tiles) * kWidth) return;
  const int local_tile = static_cast<int>(slot / kWidth);
  const uint32_t j = static_cast<uint32_t>(slot % kWidth);
  const uint32_t global_tile = static_cast<uint32_t>(first_tile + local_tile);
  const size_t n_pad = static_cast<size_t>(n_tiles) * kTerminalTile;
  const size_t col = static_cast<size_t>(local_tile) * kTerminalTile + j;
  const JumpK k = jump_consts(consts);

  float xa = 0.0f, xb = 0.0f;
  auto step = [&](int t) {
    const Words w =
        philox_keyed(Words{j, static_cast<uint32_t>(t), global_tile, 0u}, keys);
    float z, z_j, n, sn;
    box_muller_fast(w.x, w.y, z, z_j);
    poisson_head_count(uniform_from_bits(w.z), head, k, n, sn);
    xa += fmaf(k.diffusion, z, k.a) + fmaf(n, k.mu_j, k.sigma_j * sn * z_j);
    if constexpr (kCounts) counts[static_cast<size_t>(t) * n_pad + col] = static_cast<int>(n);
    if constexpr (kAnti) {
      poisson_head_count(uniform_from_bits(w.w), head, k, n, sn);
      xb += fmaf(k.diffusion, -z, k.a) + fmaf(n, k.mu_j, k.sigma_j * sn * -z_j);
      if constexpr (kCounts) {
        counts[static_cast<size_t>(t) * n_pad + col + kWidth] = static_cast<int>(n);
      }
    }
  };
  int t = 0;
#pragma unroll 1
  for (; t + 2 <= n_steps; t += 2) {
    step(t);
    step(t + 1);
  }
  if (t < n_steps) step(t);
  S[col] = ex2_approx(fmaf(xa, kLog2e, k.log2_s0));
  if (kAnti) S[col + kWidth] = ex2_approx(fmaf(xb, kLog2e, k.log2_s0));
}

// ---- merton_paths_kernel and overlay_paths_kernel: the redesigns of ----
// ---- merton_kernel<true, *> (kernel 14) and overlay_paths_first_kernel (16)
//
// The first designs carry what the SASS of kernel 15's showed: each count a
// dependent __ldg scan, each sqrtf(N) IEEE's, whose N = 0 takes its
// slow-path call, and the counts output's address work on every step. The
// Merton surface also launched kernel 14 once a maturity: 64 launches of 64
// blocks at 16,384 x 50, 68 of the 132 SMs idle and each thread walking 50
// dependent steps. The redesigns keep the streams, the counts, the
// constants rows and every float operation of the first designs, so S is
// theirs bit for bit, and:
// - one launch covers a batch of maturities: blockIdx.y is the maturity m,
//   which draws global tiles first_tile + m n_tiles + .. (as the batched
//   Heston kernel) and reads its own constants row and Poisson head;
// - counts 0 and 1 by one comparison with the row's F(0), read once a
//   thread; a uniform not below F(1), rare at the path's lam dt, scans the
//   table from entry 2. sqrt(N) is N itself for N <= 1 (IEEE's roots of 0
//   and 1) and sqrtf past it, where N >= 2 never takes the special case;
// - the counts output a template flag, so the pricing instance has none of
//   its work;
// - two steps an iteration, two Philox calls in flight.
// The overlay also:
// - draws the jump's normal only where a lane of the warp drew N > 0
//   (__any_sync; the grid is whole warps of whole tiles, so every lane
//   votes). With N = 0 the jump term fmaf(0, mu_j, sigma_j 0 z_j) is +-0,
//   and y + (+-0 + a) is y + a bit for bit (y is never -0), whatever z_j:
//   at lam = 0.3 and dt = 0.01 a warp skips the Box-Muller on ~91% of its
//   steps;
// - loads both rows of an iteration (__ldcs) before its two Philox calls,
//   so the row traffic overlaps the integer work: at 2^20 x 50 the byte
//   floor (0.125 ms) and the Philox floor (0.122 ms) are about equal.

// (N, sqrt N) of the uniform u against a maturity's head f0 = F(0), f1 =
// F(1) and its table: u >= F(n) in float32, as the plain version compares.
__device__ __forceinline__ void head_count(float u, float f0, float f1, const JumpK& k,
                                           float& n, float& sn) {
  n = u >= f0 ? 1.0f : 0.0f;
  sn = n;
  if (u >= f1) {
    int m = kHeadCdf;
    while (m < k.n_table && u >= __ldg(k.table + m)) ++m;
    n = static_cast<float>(m);
    sn = sqrtf(n);
  }
}

template <bool kAnti, bool kCounts>
__global__ void __launch_bounds__(kBlock)
merton_paths_kernel(float* __restrict__ S, int* __restrict__ counts,
                    const float* __restrict__ consts, const __grid_constant__ PhiloxKeys keys,
                    int first_tile, int n_tiles, int n_steps) {
  constexpr int kWidth = kAnti ? kPathTile / 2 : kPathTile;
  const int m = blockIdx.y;
  const long long slot = static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x;
  const int local_tile = static_cast<int>(slot / kWidth);
  const uint32_t j = static_cast<uint32_t>(slot % kWidth);
  const uint32_t global_tile = static_cast<uint32_t>(first_tile + m * n_tiles + local_tile);
  const size_t n_pad = static_cast<size_t>(n_tiles) * kPathTile;
  const size_t col = static_cast<size_t>(local_tile) * kPathTile + j;
  const float* row = consts + static_cast<size_t>(m) * kRow;
  const JumpK k = jump_consts(row);
  const float f0 = __ldg(row + kHead - kHeadCdf), f1 = __ldg(row + kHead - kHeadCdf + 1);
  float* p = S + static_cast<size_t>(m) * (n_steps + 1) * n_pad + col;
  int* c = nullptr;
  if constexpr (kCounts) c = counts + static_cast<size_t>(m) * n_steps * n_pad + col;

  float xa = 0.0f, xb = 0.0f;
  store_s(p, 0.0f, k.log2_s0);
  if constexpr (kAnti) store_s(p + kWidth, 0.0f, k.log2_s0);
  auto step = [&](const Words& w) {
    float z, z_j, n, sn;
    box_muller_fast(w.x, w.y, z, z_j);
    head_count(uniform_from_bits(w.z), f0, f1, k, n, sn);
    xa += fmaf(k.diffusion, z, k.a) + fmaf(n, k.mu_j, k.sigma_j * sn * z_j);
    p += n_pad;
    store_s(p, xa, k.log2_s0);
    if constexpr (kCounts) *c = static_cast<int>(n);
    if constexpr (kAnti) {
      head_count(uniform_from_bits(w.w), f0, f1, k, n, sn);
      xb += fmaf(k.diffusion, -z, k.a) + fmaf(n, k.mu_j, k.sigma_j * sn * -z_j);
      store_s(p + kWidth, xb, k.log2_s0);
      if constexpr (kCounts) c[kWidth] = static_cast<int>(n);
    }
    if constexpr (kCounts) c += n_pad;
  };
  auto draw = [&](int t) {
    return philox_keyed(Words{j, static_cast<uint32_t>(t), global_tile, 0u}, keys);
  };
  int t = 0;
#pragma unroll 1
  for (; t + 2 <= n_steps; t += 2) {
    const Words w0 = draw(t), w1 = draw(t + 1);
    step(w0);
    step(w1);
  }
  if (t < n_steps) step(draw(t));
}

template <bool kCounts>
__global__ void __launch_bounds__(kBlock)
overlay_paths_kernel(float* __restrict__ S, int* __restrict__ counts,
                     const float* __restrict__ consts, const __grid_constant__ PhiloxKeys keys,
                     int first_tile, int n_tiles, int n_steps) {
  static_assert(kPathTile % kBlock == 0 && kBlock % 32 == 0, "whole warps of whole tiles");
  const int m = blockIdx.y;
  const long long col = static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x;
  const uint32_t j = static_cast<uint32_t>(col % kPathTile);
  const uint32_t global_tile =
      static_cast<uint32_t>(first_tile + m * n_tiles + static_cast<int>(col / kPathTile));
  const size_t n_pad = static_cast<size_t>(n_tiles) * kPathTile;
  const float* row = consts + static_cast<size_t>(m) * kRow;
  const JumpK k = jump_consts(row);
  const float f0 = __ldg(row + kHead - kHeadCdf), f1 = __ldg(row + kHead - kHeadCdf + 1);
  float* p = S + static_cast<size_t>(m) * (n_steps + 1) * n_pad + col;
  int* c = nullptr;
  if constexpr (kCounts) c = counts + static_cast<size_t>(m) * n_steps * n_pad + col;

  float y = 0.0f;
  // One path-step on the row q, whose entry s is already loaded.
  auto step = [&](const Words& w, float* q, float s) {
    float n, sn;
    head_count(uniform_from_bits(w.z), f0, f1, k, n, sn);
    float jump = 0.0f;
    if (__any_sync(0xffffffffu, n > 0.0f)) {
      float z_j, unused;
      box_muller_fast(w.x, w.y, z_j, unused);
      jump = fmaf(n, k.mu_j, k.sigma_j * sn * z_j);
    }
    y += jump + k.a;
    __stcs(q, s * ex2_approx(y * kLog2e));
    if constexpr (kCounts) {
      *c = static_cast<int>(n);
      c += n_pad;
    }
  };
  auto draw = [&](int t) {
    return philox_keyed(Words{j, static_cast<uint32_t>(t), global_tile, kOverlayStream}, keys);
  };
  int t = 0;
#pragma unroll 1
  for (; t + 2 <= n_steps; t += 2) {
    float* q0 = p + n_pad;
    float* q1 = q0 + n_pad;
    const float s0 = __ldcs(q0), s1 = __ldcs(q1);
    const Words w0 = draw(t), w1 = draw(t + 1);
    step(w0, q0, s0);
    step(w1, q1, s1);
    p = q1;
  }
  if (t < n_steps) {
    float* q = p + n_pad;
    step(draw(t), q, __ldcs(q));
  }
}

// ---- overlay_terminal_kernel: the redesign of overlay_terminal_first_kernel
//
// The first design runs a thread a value: 32,768 blocks of 128 at 2^22
// values, ~15.5 waves of threads that each load one float, make one Philox
// call and store, living about one memory latency; its count the dependent
// __ldg scan, IEEE's sqrtf(N) (N = 0, ~86% of values at lam T = 0.15, takes
// its slow-path call), the counts output a run-time pointer. The redesign
// keeps the stream, the counts and every float operation in its order (S_T
// and the counts the first design's bit for bit), and:
// - four consecutive values a thread, one tile's (16,384 is a multiple of
//   4): one 16-byte streaming load and store, four independent Philox calls
//   interleaved;
// - a grid-stride loop over a grid of whole waves (the SMs times the blocks
//   resident on one, ops/cuda_jumps.overlay_terminal_blocks);
// - the constants row, its table and its Poisson head as launch constants
//   (OverlayT), so the wrapper copies nothing to the card before the launch;
// - the count and sqrt N as kernel 15's redesign takes them (F(0), F(1)
//   and the square roots of 0..15 from the head, a scan from entry 2 only
//   past F(1));
// - the counts output a template flag.
constexpr int kOverlayVec = 4;

// Kernel 17's launch constants: its constants row's a, mu_j, sigma_j, the
// table's length and the table, and the table's PoissonHead.
struct OverlayT {
  float a, mu_j, sigma_j;
  int n_table;
  PoissonHead head;
  float table[kMaxTable];
};

// poisson_head_count against the launch's own table.
__device__ __forceinline__ void overlay_count(float u, const OverlayT& c, float& n, float& sn) {
  const bool one = u >= c.head.cdf[0];
  n = one ? 1.0f : 0.0f;
  sn = one ? c.head.sqrt_n[1] : c.head.sqrt_n[0];
  if (u >= c.head.cdf[1]) {
    int m = kHeadCdf;
    while (m < c.n_table && u >= c.table[m]) ++m;
    n = static_cast<float>(m);
    sn = m < kSqrtTable ? c.head.sqrt_n[m] : sqrtf(n);
  }
}

template <bool kCounts>
__global__ void __launch_bounds__(kBlock)
overlay_terminal_kernel(float* __restrict__ S, int* __restrict__ counts,
                        const __grid_constant__ OverlayT c, const __grid_constant__ PhiloxKeys keys,
                        int first_tile, int n_steps, long long n_vec) {
  static_assert(kOverlayVec == 4 && kTerminalTile % kOverlayVec == 0, "a float4 of one tile");
  float4* s4 = reinterpret_cast<float4*>(S);
  const long long stride = static_cast<long long>(gridDim.x) * kBlock;
#pragma unroll 1
  for (long long v = static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x; v < n_vec;
       v += stride) {
    const long long id = kOverlayVec * v;
    const uint32_t j = static_cast<uint32_t>(id % kTerminalTile);
    const uint32_t global_tile = static_cast<uint32_t>(first_tile + id / kTerminalTile);
    float4 s = __ldcs(s4 + v);
    Words w[kOverlayVec];
#pragma unroll
    for (int i = 0; i < kOverlayVec; ++i) {
      w[i] = philox_keyed(
          Words{j + i, static_cast<uint32_t>(n_steps), global_tile, kOverlayStream}, keys);
    }
    float f[kOverlayVec];
    int n_out[kOverlayVec];
#pragma unroll
    for (int i = 0; i < kOverlayVec; ++i) {
      float z_j, unused, n, sn;
      box_muller_fast(w[i].x, w[i].y, z_j, unused);
      overlay_count(uniform_from_bits(w[i].z), c, n, sn);
      f[i] = ex2_approx((fmaf(n, c.mu_j, c.sigma_j * sn * z_j) + c.a) * kLog2e);
      n_out[i] = static_cast<int>(n);
    }
    s.x = s.x * f[0];
    s.y = s.y * f[1];
    s.z = s.z * f[2];
    s.w = s.w * f[3];
    __stcs(s4 + v, s);
    if constexpr (kCounts) {
      reinterpret_cast<int4*>(counts)[v] = make_int4(n_out[0], n_out[1], n_out[2], n_out[3]);
    }
  }
}

// A PoissonHead from the host floats of ops/cuda_jumps.poisson_head.
inline PoissonHead head_from(const void* head) {
  PoissonHead h;
  const float* src = static_cast<const float*>(head);
  for (int i = 0; i < kHeadCdf; ++i) h.cdf[i] = src[i];
  for (int i = 0; i < kSqrtTable; ++i) h.sqrt_n[i] = src[kHeadCdf + i];
  return h;
}

// Blocks of one maturity's part of a paths grid (whole blocks: a tile's
// slots are a multiple of kBlock), and whether a batch of n_mat maturities
// fits the grid's y dimension.
inline unsigned int tile_blocks(int n_tiles, int slots_per_tile) {
  return static_cast<unsigned int>(static_cast<long long>(n_tiles) * slots_per_tile / kBlock);
}
inline bool batch_fits(int n_mat) { return n_mat >= 1 && n_mat <= 65535; }

template <bool kPaths>
int launch_merton(void* S, void* counts, const void* consts, uint64_t seed, int first_tile,
                  int n_tiles, int n_steps, int antithetic, void* stream) {
  if (n_tiles < 1 || n_steps < 1) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int kTile = kPaths ? kPathTile : kTerminalTile;
  const long long n_slots = static_cast<long long>(n_tiles) * (antithetic ? kTile / 2 : kTile);
  auto kernel = antithetic ? merton_kernel<kPaths, true> : merton_kernel<kPaths, false>;
  kernel<<<blocks_for(n_slots), kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(S), static_cast<int*>(counts), static_cast<const float*>(consts),
      philox_keys(seed), first_tile, n_tiles, n_steps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace jumps
}  // namespace omt

extern "C" {

// Every ``consts`` is a device array of 128-float rows (one per maturity for
// the overlay's paths, else one); ``counts`` a device int32 array shaped as
// the draws, or null.

// The redesign of kernel 14. S: device (n_mat, n_steps+1, n_tiles*4096)
// float32, maturity m on global tiles first_tile + m n_tiles + ..; counts
// (n_mat, n_steps, n_tiles*4096) or null; consts n_mat rows.
int omt_merton_paths(void* S, void* counts, const void* consts, uint64_t seed, int first_tile,
                     int n_tiles, int n_steps, int n_mat, int antithetic, void* stream) {
  using namespace omt::jumps;
  if (n_tiles < 1 || n_steps < 1 || !batch_fits(n_mat)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(tile_blocks(n_tiles, antithetic ? kPathTile / 2 : kPathTile), n_mat);
  auto kernel = antithetic
                    ? (counts ? merton_paths_kernel<true, true> : merton_paths_kernel<true, false>)
                    : (counts ? merton_paths_kernel<false, true>
                              : merton_paths_kernel<false, false>);
  kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(S), static_cast<int*>(counts), static_cast<const float*>(consts),
      omt::fast::philox_keys(seed), first_tile, n_tiles, n_steps);
  return static_cast<int>(cudaGetLastError());
}

// The first design of kernel 14, the redesign's yardstick: one maturity.
// S: device (n_steps+1, n_tiles*4096) float32; counts (n_steps, n_tiles*4096).
int omt_merton_paths_first(void* S, void* counts, const void* consts, uint64_t seed,
                           int first_tile, int n_tiles, int n_steps, int antithetic,
                           void* stream) {
  return omt::jumps::launch_merton<true>(S, counts, consts, seed, first_tile, n_tiles,
                                         n_steps, antithetic, stream);
}

// The redesign. out: device (n_tiles*16384,) float32; counts (n_steps,
// n_tiles*16384); head: host pointer to the kHeadCdf + kSqrtTable floats of
// PoissonHead.
int omt_merton_terminal(void* out, void* counts, const void* consts, const void* head,
                        uint64_t seed, int first_tile, int n_tiles, int n_steps, int antithetic,
                        void* stream) {
  using namespace omt::jumps;
  if (n_tiles < 1 || n_steps < 1) return static_cast<int>(cudaErrorInvalidValue);
  const PoissonHead h = head_from(head);
  const long long n_slots =
      static_cast<long long>(n_tiles) * (antithetic ? kTerminalTile / 2 : kTerminalTile);
  auto kernel = antithetic
                    ? (counts ? merton_terminal_kernel<true, true> : merton_terminal_kernel<true, false>)
                    : (counts ? merton_terminal_kernel<false, true>
                              : merton_terminal_kernel<false, false>);
  kernel<<<blocks_for(n_slots), kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), static_cast<int*>(counts), static_cast<const float*>(consts),
      omt::fast::philox_keys(seed), h, first_tile, n_tiles, n_steps);
  return static_cast<int>(cudaGetLastError());
}

// The first design, the redesign's yardstick: the same arguments without
// the head.
int omt_merton_terminal_first(void* out, void* counts, const void* consts, uint64_t seed,
                              int first_tile, int n_tiles, int n_steps, int antithetic,
                              void* stream) {
  return omt::jumps::launch_merton<false>(out, counts, consts, seed, first_tile, n_tiles,
                                          n_steps, antithetic, stream);
}

// The redesign of kernel 16. S: device (n_mat, n_steps+1, n_tiles*4096)
// float32, multiplied in place; counts (n_mat, n_steps, n_tiles*4096) or null.
int omt_jump_overlay_paths(void* S, void* counts, const void* consts, uint64_t seed,
                           int first_tile, int n_tiles, int n_steps, int n_mat, void* stream) {
  using namespace omt::jumps;
  if (n_tiles < 1 || n_steps < 1 || !batch_fits(n_mat)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(tile_blocks(n_tiles, kPathTile), n_mat);
  auto kernel = counts ? overlay_paths_kernel<true> : overlay_paths_kernel<false>;
  kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(S), static_cast<int*>(counts), static_cast<const float*>(consts),
      omt::fast::philox_keys(seed), first_tile, n_tiles, n_steps);
  return static_cast<int>(cudaGetLastError());
}

// The first design of kernel 16, the redesign's yardstick: the same arguments.
int omt_jump_overlay_paths_first(void* S, void* counts, const void* consts, uint64_t seed,
                                 int first_tile, int n_tiles, int n_steps, int n_mat,
                                 void* stream) {
  using namespace omt::jumps;
  if (n_tiles < 1 || n_steps < 1 || n_mat < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long n = static_cast<long long>(n_tiles) * kPathTile * n_mat;
  overlay_paths_first_kernel<<<blocks_for(n), kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(S), static_cast<int*>(counts), static_cast<const float*>(consts),
      omt::fast::philox_keys(seed), first_tile, n_tiles, n_steps, n_mat);
  return static_cast<int>(cudaGetLastError());
}

// The redesign of kernel 17. S: device (n_tiles*16384,) float32, 16-byte
// aligned, multiplied in place; counts the same shape or null; row: host
// pointer to the launch's kRow-float constants row; head: host pointer to
// the kHeadCdf + kSqrtTable floats of PoissonHead; n_blocks: at least 1 and
// at most the blocks that give every thread a vector.
int omt_jump_overlay_terminal(void* S, void* counts, const void* row, const void* head,
                              uint64_t seed, int first_tile, int n_tiles, int n_steps,
                              int n_blocks, void* stream) {
  using namespace omt::jumps;
  const long long n_vec = static_cast<long long>(n_tiles) * kTerminalTile / kOverlayVec;
  const float* r = static_cast<const float*>(row);
  const int n_table = static_cast<int>(r[5]);
  if (n_tiles < 1 || n_steps < 1 || n_blocks < 1 ||
      static_cast<long long>(n_blocks) > blocks_for(n_vec) || n_table < 0 ||
      n_table > kMaxTable) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  OverlayT c{r[0], r[2], r[3], n_table, head_from(head), {}};
  for (int i = 0; i < n_table; ++i) c.table[i] = r[kHead + i];
  auto kernel = counts ? overlay_terminal_kernel<true> : overlay_terminal_kernel<false>;
  kernel<<<n_blocks, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(S), static_cast<int*>(counts), c, omt::fast::philox_keys(seed),
      first_tile, n_steps, n_vec);
  return static_cast<int>(cudaGetLastError());
}

// The first design, the redesign's yardstick. S: device (n_tiles*16384,)
// float32, multiplied in place; counts the same shape or null.
int omt_jump_overlay_terminal_first(void* S, void* counts, const void* consts, uint64_t seed,
                                    int first_tile, int n_tiles, int n_steps, void* stream) {
  using namespace omt::jumps;
  if (n_tiles < 1 || n_steps < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long n = static_cast<long long>(n_tiles) * kTerminalTile;
  overlay_terminal_first_kernel<<<blocks_for(n), kBlock, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(S), static_cast<int*>(counts), static_cast<const float*>(consts),
      omt::fast::philox_keys(seed), first_tile, n_tiles, n_steps);
  return static_cast<int>(cudaGetLastError());
}

// out[4]: registers, spill bytes, blocks per SM, block threads of ``which``:
// 0 Merton paths, 1 Merton terminal, 2 overlay paths, 3 overlay terminal
// (the redesigns' pricing instances: antithetic, without counts), 4 Merton
// terminal's first design, 5 Merton paths' first design, 6 overlay paths'
// first design, 7 overlay terminal's first design.
int omt_jumps_attrs(int which, int* out) {
  using namespace omt::jumps;
  switch (which) {
    case 0: return omt::kernel_attrs(merton_paths_kernel<true, false>, kBlock, out);
    case 1: return omt::kernel_attrs(merton_terminal_kernel<true, false>, kBlock, out);
    case 2: return omt::kernel_attrs(overlay_paths_kernel<false>, kBlock, out);
    case 3: return omt::kernel_attrs(overlay_terminal_kernel<false>, kBlock, out);
    case 4: return omt::kernel_attrs(merton_kernel<false, true>, kBlock, out);
    case 5: return omt::kernel_attrs(merton_kernel<true, true>, kBlock, out);
    case 6: return omt::kernel_attrs(overlay_paths_first_kernel, kBlock, out);
    case 7: return omt::kernel_attrs(overlay_terminal_first_kernel, kBlock, out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
