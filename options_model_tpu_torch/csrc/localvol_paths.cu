// Local-vol paths kernel redesigned for Hopper (sm_90a): the S matrix under
// a Chebyshev local-vol table.
//
// Replaces the Pallas TPU kernel
//   options_model_tpu/ops/pallas_localvol.py  localvol_paths_pallas
//                                             (_localvol_paths_kernel)
// and computes what it computes: the flat (n_steps+1, n_tiles * 4096) S
// matrix in float32, from the Philox stream of ops/philox.py with the tiles,
// mirrors and first_tile of the first design, csrc/localvol.cu
// (omt_localvol_paths), which stays built as the yardstick. One thread owns
// one antithetic pair (or one path when antithetic is off) and carries both
// mirror paths in registers.
//
// Per step t, as the terminal kernel of csrc/terminal.cu (hopper_fast.cuh's
// lv_step and its draw schedule lv_walk, shared with it):
//   u = clip(((log K - log S) - m_center) / m_half, -1, 1),
//   sigma = max(Clenshaw(row t, u), 1e-6),
//   log S <- log S + (r - sigma^2 / 2) dt + sigma sqrt(dt) z,
// and each step stores its row.
//
// What bounds it on the card: its writes, 4 bytes a path-step (214 MB at
// 2^20 x 50, 0.064 ms at 3.35 TB/s), and the rate at which the schedulers
// issue the step (kernel 7's loop, ~35 instructions a path-step, plus the
// store). The first design ran Clenshaw to a run-time degree with a scalar
// __ldg a coefficient and path, an accurate Box-Muller with the key schedule
// rebuilt at every Philox call, a branch on t % 4 at every step, and an
// accurate expf a stored entry, adding to the absolute log S. Here:
//   * the degree is a template parameter (0..kMaxStaticDegree); one
//     run-time-degree instance serves any wider table;
//   * a step reads its padded row (ops/cuda_localvol.padded_coeffs) once,
//     as float4 loads at a warp-uniform address, for both mirror paths;
//   * one Philox call (round keys once per launch, a __grid_constant__
//     PhiloxKeys) and two SFU Box-Mullers serve four steps, steps 4d..4d+3
//     taking (x, y) cos, (x, y) sin, (z, w) cos, (z, w) sin of draw d, with
//     no per-step branch; a tail takes n_steps % 4;
//   * x = log S - log S0 starts at 0 and each step adds its whole increment
//     (a constant added on its own to the absolute log S rounds the same way
//     at every step; tests/test_torch_terminal.py emulates both forms);
//   * a row is stored as store_s does for kernel 4: 2^(log2 S0 + x log2 e)
//     through ex2.approx, with the streaming hint.
// No branch reads a rounding (the clip and the floor on sigma are
// continuous), so the whole step trades the last ulps: S within rtol 1e-4
// of the plain version (chip_smoke.py, LV_S_RTOL).
//
// Built without --use_fast_math: the fast forms are named here and in
// hopper_fast.cuh, nowhere else.
#include <cstdint>
#include <cstring>

#include "hopper_fast.cuh"
#include "kernel_attrs.cuh"

namespace omt {
namespace lvpaths {

using namespace fast;

constexpr int kTile = 4096;
// Threads per block (43 registers, 62.5% occupancy at 128), timed against
// 256 and 512 on an H100 in two calls (scripts/sweep_terminal_bounds.py
// localvol_paths, PERF.md): 128 led in both at the local-vol American
// put's 2^21 x 50 (by 0.8-2.7%), 256 at 2^20 x 50 on the bench smile.
constexpr int kBlock = 128;

template <int D, bool kAnti>
__global__ void __launch_bounds__(kBlock)
localvol_paths_kernel(float* __restrict__ S, const float4* __restrict__ table,
                      const __grid_constant__ LvK k, const __grid_constant__ PhiloxKeys keys,
                      float log2_s0, int first_tile, int n_tiles, int n_steps, int n_groups) {
  constexpr int kP = kAnti ? 2 : 1;
  constexpr int kWidth = kAnti ? kTile / 2 : kTile;
  const long long slot = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (slot >= static_cast<long long>(n_tiles) * kWidth) return;
  const int local_tile = static_cast<int>(slot / kWidth);
  const uint32_t j = static_cast<uint32_t>(slot % kWidth);
  const uint32_t global_tile = static_cast<uint32_t>(first_tile + local_tile);
  const size_t n_pad = static_cast<size_t>(n_tiles) * kTile;
  const int groups = D != kRuntimeDegree ? row_groups(D) : n_groups;

  float* s = S + static_cast<size_t>(local_tile) * kTile + j;
  float ls[2] = {0.0f, 0.0f};
  auto store = [&]() {
    store_s(s, ls[0], log2_s0);
    if (kAnti) store_s(s + kWidth, ls[1], log2_s0);
  };
  store();
  lv_walk<D, kP>(ls, table, groups, k, keys, j, global_tile, n_steps, [&] {
    s += n_pad;
    store();
  });
}

}  // namespace lvpaths
}  // namespace omt

extern "C" {

// S: device (n_steps+1, n_tiles*4096) float32. table: device (>= n_steps,
// 4 (degree/4 + 1)) float32, row-major, 16-byte aligned, the columns past
// ``degree`` zero (ops/cuda_localvol.padded_coeffs). consts: host pointer
// to the 7 floats of LvConsts.
int omt_paths_localvol(void* S, const void* table, const void* consts, uint64_t seed,
                       int first_tile, int n_tiles, int n_steps, int degree, int antithetic,
                       void* stream) {
  using namespace omt::lvpaths;
  if (degree < 0 || n_tiles < 1 || n_steps < 1 ||
      reinterpret_cast<uintptr_t>(table) % sizeof(float4) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  float c[7];
  std::memcpy(c, consts, sizeof(c));
  float* out = static_cast<float*>(S);
  const float4* rows = static_cast<const float4*>(table);
  const LvK k = lv_fold(c);
  const PhiloxKeys keys = philox_keys(seed);
  const float log2_s0 = c[0] * kLog2e;
  const long long n_slots = static_cast<long long>(n_tiles) * (antithetic ? kTile / 2 : kTile);
  const unsigned int grid = static_cast<unsigned int>((n_slots + kBlock - 1) / kBlock);
  const int groups = row_groups(degree);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_degree(degree, [&](auto d) {
    constexpr int kD = decltype(d)::value;
    if (antithetic) {
      localvol_paths_kernel<kD, true><<<grid, kBlock, 0, st>>>(
          out, rows, k, keys, log2_s0, first_tile, n_tiles, n_steps, groups);
    } else {
      localvol_paths_kernel<kD, false><<<grid, kBlock, 0, st>>>(
          out, rows, k, keys, log2_s0, first_tile, n_tiles, n_steps, groups);
    }
    return static_cast<int>(cudaGetLastError());
  });
}

// out[4]: registers, spill bytes, blocks per SM, block threads of the
// antithetic instance at degree 7 (which 0) or at a run-time degree (1).
int omt_paths_localvol_attrs(int which, int* out) {
  using namespace omt::lvpaths;
  switch (which) {
    case 0: return omt::kernel_attrs(localvol_paths_kernel<7, true>, kBlock, out);
    case 1: return omt::kernel_attrs(localvol_paths_kernel<kRuntimeDegree, true>, kBlock, out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
