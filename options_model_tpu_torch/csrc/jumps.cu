// Jump kernels for Hopper (sm_90a): the Merton jump diffusion's paths and
// terminal values, and the Bates jump overlay applied in place to a Heston
// kernel's output.
//
// The JAX package computes these in XLA code, not in Pallas:
//   options_model_tpu/models/merton.py:26  simulate_merton (return_paths True: kernel 14,
//                                          False: kernel 15)
//   options_model_tpu/models/bates.py:37   jump_overlay (return_paths True: kernel 16,
//                                          False: kernel 17), times the Heston S
// XLA fuses each into one pass over its draws; eager torch would not, and
// the port's random stream is Philox keyed by (seed, global tile, draw), so
// each is a kernel here with a plain PyTorch version on the same counters
// (ops/cuda_jumps.py; ops/philox.py states the stream contract).
//
// - merton_kernel<kPaths>: one thread owns one antithetic pair (or one path)
//   and carries x = log S - log S0 of both mirror paths in registers. One
//   Philox call per pair-step (counter = (slot, step, global tile, 0)):
//   (w0, w1) -> Box-Muller -> (z, z_j), mirrored; w2, w3 -> the Poisson
//   uniforms of the path and of its mirror. x += drift + sigma sqrt(dt) z +
//   N mu_j + sigma_j sqrt(N) z_j. The paths instance stores every row as
//   2^(log2 S0 + x log2 e) (store_s), the terminal instance S_T only.
// - overlay_paths_kernel: one thread per path column of a (n_mat, n_steps+1,
//   n_pad) Heston S, maturity m on global tiles first_tile + m n_tiles + ..,
//   as the batched Heston kernel draws them. One Philox call per path-step
//   (counter word 3 = 1, never mirrored): z_j and the Poisson uniform.
//   y += N mu_j + sigma_j sqrt(N) z_j - lam kbar dt; S[t+1] *= exp(y), read
//   and written once each.
// - overlay_terminal_kernel: S_T *= exp(N mu_j + sigma_j sqrt(N) z_j -
//   lam kbar T), N ~ Poisson(lam T), one call per path at draw n_steps.
//
// Poisson counts are drawn by inversion: the count is the number of entries
// of the host's float32 CDF table (ops/philox.poisson_table) the uniform is
// not below, the same float32 comparisons as the plain version, so the
// counts are equal bit for bit. The table sits in the constants row the
// wrapper copies to the card (kRow floats per maturity: a, diffusion, mu_j,
// sigma_j, log S0, table length, two zeros, the table); the scan stops at
// the first entry above u (one or two entries at the bench's lam dt).
//
// What bounds them on the card: kernel 14 writes 4 bytes per path-step
// (0.063 ms at 2^20 x 50 and 3.35 TB/s), kernel 16 reads and writes 4 each;
// kernels 15 and 17 store one float per path and are held by the Philox
// integer work (chip_smoke.bound). A first design: Philox's round keys once
// per launch, the SFU Box-Muller, the count's scan through L1, and nothing
// else tuned. An optional int32 ``counts`` output (null on the pricing
// path) writes each draw's count, so a check can hold them against the
// plain version's bit for bit.
#include "hopper_fast.cuh"
#include "kernel_attrs.cuh"

namespace omt {
namespace jumps {

using namespace fast;

constexpr int kPathTile = 4096;
constexpr int kTerminalTile = 16384;
constexpr int kBlock = 128;
// A constants row: 8 floats, then at most kMaxTable Poisson CDF entries
// (ops/philox.MAX_POISSON_TABLE, ops/cuda_jumps.ROW).
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
overlay_paths_kernel(float* __restrict__ S, int* __restrict__ counts,
                     const float* __restrict__ consts, const __grid_constant__ PhiloxKeys keys,
                     int first_tile, int n_tiles, int n_steps, int n_mat) {
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
overlay_terminal_kernel(float* __restrict__ S, int* __restrict__ counts,
                        const float* __restrict__ consts,
                        const __grid_constant__ PhiloxKeys keys, int first_tile, int n_tiles,
                        int n_steps) {
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

// S: device (n_steps+1, n_tiles*4096) float32; counts (n_steps, n_tiles*4096).
int omt_merton_paths(void* S, void* counts, const void* consts, uint64_t seed, int first_tile,
                     int n_tiles, int n_steps, int antithetic, void* stream) {
  return omt::jumps::launch_merton<true>(S, counts, consts, seed, first_tile, n_tiles,
                                         n_steps, antithetic, stream);
}

// out: device (n_tiles*16384,) float32; counts (n_steps, n_tiles*16384).
int omt_merton_terminal(void* out, void* counts, const void* consts, uint64_t seed,
                        int first_tile, int n_tiles, int n_steps, int antithetic,
                        void* stream) {
  return omt::jumps::launch_merton<false>(out, counts, consts, seed, first_tile, n_tiles,
                                          n_steps, antithetic, stream);
}

// S: device (n_mat, n_steps+1, n_tiles*4096) float32, multiplied in place;
// counts (n_mat, n_steps, n_tiles*4096).
int omt_jump_overlay_paths(void* S, void* counts, const void* consts, uint64_t seed,
                           int first_tile, int n_tiles, int n_steps, int n_mat, void* stream) {
  using namespace omt::jumps;
  if (n_tiles < 1 || n_steps < 1 || n_mat < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long n = static_cast<long long>(n_tiles) * kPathTile * n_mat;
  overlay_paths_kernel<<<blocks_for(n), kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(S), static_cast<int*>(counts), static_cast<const float*>(consts),
      omt::fast::philox_keys(seed), first_tile, n_tiles, n_steps, n_mat);
  return static_cast<int>(cudaGetLastError());
}

// S: device (n_tiles*16384,) float32, multiplied in place; counts the same shape.
int omt_jump_overlay_terminal(void* S, void* counts, const void* consts, uint64_t seed,
                              int first_tile, int n_tiles, int n_steps, void* stream) {
  using namespace omt::jumps;
  if (n_tiles < 1 || n_steps < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long n = static_cast<long long>(n_tiles) * kTerminalTile;
  overlay_terminal_kernel<<<blocks_for(n), kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(S), static_cast<int*>(counts), static_cast<const float*>(consts),
      omt::fast::philox_keys(seed), first_tile, n_tiles, n_steps);
  return static_cast<int>(cudaGetLastError());
}

// out[4]: registers, spill bytes, blocks per SM, block threads of ``which``:
// 0 Merton paths, 1 Merton terminal (antithetic instances), 2 overlay paths,
// 3 overlay terminal.
int omt_jumps_attrs(int which, int* out) {
  using namespace omt::jumps;
  switch (which) {
    case 0: return omt::kernel_attrs(merton_kernel<true, true>, kBlock, out);
    case 1: return omt::kernel_attrs(merton_kernel<false, true>, kBlock, out);
    case 2: return omt::kernel_attrs(overlay_paths_kernel, kBlock, out);
    case 3: return omt::kernel_attrs(overlay_terminal_kernel, kBlock, out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
