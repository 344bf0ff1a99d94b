// Terminal-price kernels redesigned for Hopper (sm_90a): local vol over a
// Chebyshev table, Heston QE-M, Heston full-truncation Euler and GBM.
//
// Replaces the Pallas TPU kernels
//   options_model_tpu/ops/pallas_localvol.py  localvol_terminal_pallas
//                                             (_localvol_terminal_kernel)
//   options_model_tpu/ops/pallas_heston.py    heston_terminal_qe_pallas
//                                             (_qe_terminal_kernel)
//   options_model_tpu/ops/pallas_heston.py    heston_terminal_pallas
//                                             (_terminal_kernel)
//   options_model_tpu/ops/pallas_gbm.py       gbm_terminal_pallas
//                                             (_gbm_terminal_kernel)
// and computes what they compute: S_T of shape (n_tiles * 16384,) in
// float32, from the Philox stream of ops/philox.py with the tiles, mirrors
// and first_tile of the first designs, csrc/localvol.cu (omt_localvol_
// terminal), csrc/heston_qe.cu (omt_heston_terminal_qe), csrc/heston.cu
// (omt_heston_terminal) and csrc/gbm.cu (omt_gbm_terminal), which stay built
// as the yardstick. One thread owns one antithetic pair (or one path when
// antithetic is off) and carries both mirror paths in registers; nothing
// but S_T touches device memory, 4 bytes a path.
//
// What bounds them on the card: the rate at which its schedulers dispatch
// instructions (one a clock each). A terminal kernel writes
// 16 MB at 2^22 paths, so its time is the arithmetic of 2^22 x 100
// path-steps. The first designs rebuilt Philox's key schedule at every
// call, ran an accurate Box-Muller (logf, sqrtf, sinf, cosf) and branched on
// the step's place in its draw at every step; every redesign here takes the
// ten round keys once per launch (computed on the host, passed as a
// __grid_constant__ PhiloxKeys), draws with no per-step branch and folds its
// constants on the host.
//
// Local vol (per step t):
//   u = clip(((log K - log S) - m_center) / m_half, -1, 1),
//   sigma = max(Clenshaw(row t, u), 1e-6),
//   log S <- log S + (r - sigma^2 / 2) dt + sigma sqrt(dt) z.
// The first design ran Clenshaw to a run-time degree with a scalar __ldg a
// coefficient and path, an accurate Box-Muller (logf, sqrtf, sinf, cosf)
// with the key schedule rebuilt at every Philox call, and branched on t % 4
// every step. Here:
//   * the degree is a template parameter (0..kMaxStaticDegree, 7 the
//     default of compile_localvol_table), Clenshaw fully unrolled as
//     b <- fmaf(2u, b1, c_k - b2); one run-time-degree instance of the same
//     kernel serves any wider table;
//   * the wrapper pads every row with zeros to 4 (degree / 4 + 1) floats
//     (ops/cuda_localvol.padded_coeffs), and a step reads its row once, as
//     float4 loads at a warp-uniform address (2 LDG.128 at degree 7; the
//     3.2 KB table stays in L1), for both mirror paths; the zero columns
//     leave Clenshaw's result bit for bit as it was;
//   * one Philox call (keys once per launch) and two SFU Box-Mullers serve
//     four steps: steps 4d..4d+3 take (x, y) cos, (x, y) sin, (z, w) cos,
//     (z, w) sin of draw d, the mapping of localvol.cu, with no per-step
//     branch; a tail takes n_steps % 4 (hopper_fast.cuh's lv_walk, which
//     the paths kernel of localvol_paths.cu shares);
//   * log S is carried as x = log S - log S0, and each step adds its whole
//     increment fmaf(sigma, fmaf(sigma, -dt/2, sqrt(dt) z), r dt) at once,
//     sqrt(dt) z shared by the mirrors; u = fmaf(-1/m_half, x, u0) with
//     u0 = ((log K - log S0) - m_center) / m_half folded on the host. A
//     constant added on its own to the absolute log S (~4.6, ulp 4.8e-7)
//     rounds the same way at every step: log S + r dt did (+0.42 ulp a step
//     at r dt = 5e-4, +2.0e-5 in S_T over 100 steps), and the plain
//     version's log S + (r - sigma^2/2) dt does where sigma is constant
//     (-6.9e-6 at sigma = 0.2); x and a random increment round both ways.
// No branch reads a rounding (the clip and the floor on sigma are
// continuous), so the whole step trades the last ulps: S_T within rtol 1e-4
// of the plain version (chip_smoke.py).
//
// Euler (kernel 4's step, hopper_fast.cuh's euler_step, without its
// stores): one Philox call serves two steps, step 2d taking words (x, y)
// and step 2d+1 words (z, w) of draw d (heston_common.cuh's step_normals),
// an odd n_steps a tail of one step; box_muller_fast gives the normals;
// sqrt.approx and FMAs the step. x = log S - log S0 starts at 0 and each
// step adds its whole increment sqrt(dt v+) z1 + (r dt - v+ dt / 2) at
// once; S_T = 2^(log2 S0 + x log2 e) through ex2.approx.
//
// GBM: one Philox call and two SFU Box-Mullers serve four steps, steps
// 4d..4d+3 taking (x, y) cos, (x, y) sin, (z, w) cos and (z, w) sin of draw
// d (gbm.cu's mapping), a tail n_steps % 4; the normals are summed in step
// order, the plain version's, and S_T = s0 2^(a + b sum) through ex2.approx
// with a = drift n_steps log2 e and b = diffusion log2 e, the mirror's at
// -sum.
//
// Full truncation is continuous, so in Euler as in local vol and GBM no
// branch reads a rounding and the whole step trades the last ulps: S_T
// within rtol 1e-4 of the plain version (chip_smoke.py).
//
// QE-M: the design of csrc/heston_paths.cu's QE-M kernel (hopper_fast.cuh's
// qe_step): the variance chain (m, s2, psi, the psi <= 1.5 branch, q,
// u <= q, v_new, 2/psi, b^2, a, the branches' sqrtf and logf) and the
// accurate Box-Muller, which feeds v_new through z_v, are the first
// design's operation for operation, every add, multiply and divide an _rn
// intrinsic, so no path changes branch; the log-S chain feeds no branch and
// goes to FMAs, __fdividef, lg2.approx and sqrt.approx; the Philox keys come
// once per launch, one call a pair-step. S_T within rtol 1e-4 (QE_S_RTOL):
// a path whose branch flipped would leave that far behind.
//
// Built without --use_fast_math: the fast forms are named here and in
// hopper_fast.cuh, nowhere else.
#include <cstdint>
#include <cstring>

#include "hopper_fast.cuh"
#include "kernel_attrs.cuh"

namespace omt {
namespace terminal {

using namespace fast;

constexpr int kTile = 16384;
// Threads per block, and the minimum resident blocks per SM of the QE-M,
// Euler and GBM kernels' __launch_bounds__ (1: ptxas's own register count;
// local vol names none). Chosen from the registers and occupancy the card
// reports and from timing other values on an H100 in two calls
// (scripts/sweep_terminal_bounds.py, PERF.md): blocks of 128 threads led
// for all four kernels in both (by 0.5-4%); blocks of 512, and minimums of
// 2048 resident threads an SM (a 32-register cap: QE-M and the run-time
// local vol spill 16 bytes) or 1024 (local vol takes 63 registers), led in
// neither.
constexpr int kBlock = 128;
constexpr int kQeMinBlocks = 1;
constexpr int kEulerMinBlocks = 1;
constexpr int kGbmMinBlocks = 1;

// A thread's slot: its column of S_T (its mirror's is col + kTile / 2 when
// antithetic), slot j and global tile of the stream; false past the grid.
struct Slot {
  uint32_t j, global_tile;
  size_t col;
};

template <bool kAnti>
__device__ __forceinline__ bool locate(Slot& s, int first_tile, int n_tiles) {
  constexpr int kWidth = kAnti ? kTile / 2 : kTile;
  const long long slot = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (slot >= static_cast<long long>(n_tiles) * kWidth) return false;
  const int local_tile = static_cast<int>(slot / kWidth);
  s.j = static_cast<uint32_t>(slot % kWidth);
  s.global_tile = static_cast<uint32_t>(first_tile + local_tile);
  s.col = static_cast<size_t>(local_tile) * kTile + s.j;
  return true;
}

template <int D, bool kAnti>
__global__ void __launch_bounds__(kBlock)
localvol_terminal_kernel(float* __restrict__ out, const float4* __restrict__ table,
                         const __grid_constant__ LvK k, const __grid_constant__ PhiloxKeys keys,
                         int first_tile, int n_tiles, int n_steps, int n_groups) {
  constexpr int kP = kAnti ? 2 : 1;
  Slot at;
  if (!locate<kAnti>(at, first_tile, n_tiles)) return;
  const int groups = D != kRuntimeDegree ? row_groups(D) : n_groups;

  float ls[2] = {0.0f, 0.0f};
  lv_walk<D, kP>(ls, table, groups, k, keys, at.j, at.global_tile, n_steps, [] {});
  out[at.col] = expf(k.log_s0 + ls[0]);
  if (kAnti) out[at.col + kTile / 2] = expf(k.log_s0 + ls[1]);
}

template <bool kAnti>
__global__ void __launch_bounds__(kBlock, kQeMinBlocks)
qe_terminal_kernel(float* __restrict__ out, const __grid_constant__ QeK p,
                   const __grid_constant__ PhiloxKeys keys, int first_tile, int n_tiles,
                   int n_steps) {
  Slot at;
  if (!locate<kAnti>(at, first_tile, n_tiles)) return;
  float ls_a = 0.0f, v_a = p.v0, ls_b = 0.0f, v_b = p.v0;
#pragma unroll 1
  for (int t = 0; t < n_steps; ++t) {
    const Words w =
        philox_keyed(Words{at.j, static_cast<uint32_t>(t), at.global_tile, 0u}, keys);
    float z_v, z_s;
    box_muller(w.x, w.y, z_v, z_s);
    const float u = uniform_from_bits(w.z);
    qe_step(ls_a, v_a, z_v, z_s, u, p);
    if (kAnti) qe_step(ls_b, v_b, -z_v, -z_s, fsub(1.0f, u), p);
  }
  out[at.col] = ex2_approx(fmaf(ls_a, kLog2e, p.log2_s0));
  if (kAnti) out[at.col + kTile / 2] = ex2_approx(fmaf(ls_b, kLog2e, p.log2_s0));
}

template <bool kAnti>
__global__ void __launch_bounds__(kBlock, kEulerMinBlocks)
euler_terminal_kernel(float* __restrict__ out, const __grid_constant__ EulerK k,
                      const __grid_constant__ PhiloxKeys keys, int first_tile, int n_tiles,
                      int n_steps) {
  Slot at;
  if (!locate<kAnti>(at, first_tile, n_tiles)) return;
  float x_a = 0.0f, v_a = k.v0, x_b = 0.0f, v_b = k.v0;
  auto step = [&](uint32_t b1, uint32_t b2) {
    float z1, z2;
    box_muller_fast(b1, b2, z1, z2);
    const float w2 = fmaf(k.rho, z1, k.rho_bar * z2);
    euler_step<true>(x_a, v_a, z1, w2, k);
    if (kAnti) euler_step<true>(x_b, v_b, -z1, -w2, k);
  };
  const int n_draws = n_steps >> 1;
#pragma unroll 1
  for (int d = 0; d < n_draws; ++d) {
    const Words w =
        philox_keyed(Words{at.j, static_cast<uint32_t>(d), at.global_tile, 0u}, keys);
    step(w.x, w.y);
    step(w.z, w.w);
  }
  if (n_steps & 1) {
    const Words w =
        philox_keyed(Words{at.j, static_cast<uint32_t>(n_draws), at.global_tile, 0u}, keys);
    step(w.x, w.y);
  }
  out[at.col] = ex2_approx(fmaf(x_a, kLog2e, k.log2_s0));
  if (kAnti) out[at.col + kTile / 2] = ex2_approx(fmaf(x_b, kLog2e, k.log2_s0));
}

// GBM constants, folded on the host from GbmConsts (s0, drift, diffusion,
// drift_n; ops/cuda_gbm._consts): S_T = s0 2^(a + b sum z).
struct GbmK {
  float s0, a, b;
};

inline GbmK gbm_fold(const float* c) { return GbmK{c[0], c[3] * kLog2e, c[2] * kLog2e}; }

template <bool kAnti>
__global__ void __launch_bounds__(kBlock, kGbmMinBlocks)
gbm_terminal_kernel(float* __restrict__ out, const __grid_constant__ GbmK k,
                    const __grid_constant__ PhiloxKeys keys, int first_tile, int n_tiles,
                    int n_steps) {
  Slot at;
  if (!locate<kAnti>(at, first_tile, n_tiles)) return;
  float sum = 0.0f;
  const int n_draws = n_steps >> 2;
#pragma unroll 1
  for (int d = 0; d < n_draws; ++d) {
    const Words w =
        philox_keyed(Words{at.j, static_cast<uint32_t>(d), at.global_tile, 0u}, keys);
    float z0, z1, z2, z3;
    box_muller_fast(w.x, w.y, z0, z1);
    box_muller_fast(w.z, w.w, z2, z3);
    sum = (((sum + z0) + z1) + z2) + z3;
  }
  if (const int rem = n_steps & 3) {
    const Words w =
        philox_keyed(Words{at.j, static_cast<uint32_t>(n_draws), at.global_tile, 0u}, keys);
    float z0, z1;
    box_muller_fast(w.x, w.y, z0, z1);
    sum += z0;
    if (rem > 1) sum += z1;
    if (rem > 2) {
      box_muller_fast(w.z, w.w, z0, z1);
      sum += z0;
    }
  }
  out[at.col] = k.s0 * ex2_approx(fmaf(k.b, sum, k.a));
  if (kAnti) out[at.col + kTile / 2] = k.s0 * ex2_approx(fmaf(-k.b, sum, k.a));
}

inline unsigned int grid_of(int n_tiles, bool antithetic) {
  const long long n_slots = static_cast<long long>(n_tiles) * (antithetic ? kTile / 2 : kTile);
  return static_cast<unsigned int>((n_slots + kBlock - 1) / kBlock);
}

// A launch of the antithetic or the plain instance of a terminal kernel
// whose constants are a P.
template <typename P>
using TerminalKernel = void (*)(float*, P, PhiloxKeys, int, int, int);

template <typename P>
int launch_terminal(TerminalKernel<P> anti, TerminalKernel<P> plain, void* out, const P& p,
                    uint64_t seed, int first_tile, int n_tiles, int n_steps, int antithetic,
                    void* stream) {
  if (n_tiles < 1 || n_steps < 1) return static_cast<int>(cudaErrorInvalidValue);
  (antithetic ? anti : plain)<<<grid_of(n_tiles, antithetic != 0), kBlock, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), p, philox_keys(seed), first_tile, n_tiles, n_steps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace terminal
}  // namespace omt

extern "C" {

// out: device (n_tiles*16384,) float32 terminal prices. table: device
// (>= n_steps, 4 (degree/4 + 1)) float32, row-major, 16-byte aligned, the
// columns past ``degree`` zero (ops/cuda_localvol.padded_coeffs). consts:
// host pointer to the 7 floats of LvConsts.
int omt_terminal_localvol(void* out, const void* table, const void* consts, uint64_t seed,
                          int first_tile, int n_tiles, int n_steps, int degree, int antithetic,
                          void* stream) {
  using namespace omt::terminal;
  if (degree < 0 || n_tiles < 1 || n_steps < 1 ||
      reinterpret_cast<uintptr_t>(table) % sizeof(float4) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  float* S = static_cast<float*>(out);
  const float4* rows = static_cast<const float4*>(table);
  const LvK k = lv_fold(static_cast<const float*>(consts));
  const PhiloxKeys keys = philox_keys(seed);
  const unsigned int grid = grid_of(n_tiles, antithetic != 0);
  const int groups = row_groups(degree);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_degree(degree, [&](auto d) {
    constexpr int kD = decltype(d)::value;
    if (antithetic) {
      localvol_terminal_kernel<kD, true><<<grid, kBlock, 0, st>>>(
          S, rows, k, keys, first_tile, n_tiles, n_steps, groups);
    } else {
      localvol_terminal_kernel<kD, false><<<grid, kBlock, 0, st>>>(
          S, rows, k, keys, first_tile, n_tiles, n_steps, groups);
    }
    return static_cast<int>(cudaGetLastError());
  });
}

// out: device (n_tiles*16384,) float32 terminal prices. consts: host
// pointer to the 13 floats of QeConsts.
int omt_terminal_qe(void* out, const void* consts, uint64_t seed, int first_tile, int n_tiles,
                    int n_steps, int antithetic, void* stream) {
  using namespace omt::terminal;
  float c[13];
  std::memcpy(c, consts, sizeof(c));
  return launch_terminal<QeK>(qe_terminal_kernel<true>, qe_terminal_kernel<false>, out,
                              qe_fold(c), seed, first_tile, n_tiles, n_steps, antithetic,
                              stream);
}

// out: device (n_tiles*16384,) float32 terminal prices. consts: host
// pointer to the 10 floats of HestonConsts.
int omt_terminal_euler(void* out, const void* consts, uint64_t seed, int first_tile,
                       int n_tiles, int n_steps, int antithetic, void* stream) {
  using namespace omt::terminal;
  float c[10];
  std::memcpy(c, consts, sizeof(c));
  return launch_terminal<EulerK>(euler_terminal_kernel<true>, euler_terminal_kernel<false>,
                                 out, euler_fold(c), seed, first_tile, n_tiles, n_steps,
                                 antithetic, stream);
}

// out: device (n_tiles*16384,) float32 terminal prices. consts: host
// pointer to the 4 floats of GbmConsts.
int omt_terminal_gbm(void* out, const void* consts, uint64_t seed, int first_tile, int n_tiles,
                     int n_steps, int antithetic, void* stream) {
  using namespace omt::terminal;
  float c[4];
  std::memcpy(c, consts, sizeof(c));
  return launch_terminal<GbmK>(gbm_terminal_kernel<true>, gbm_terminal_kernel<false>, out,
                               gbm_fold(c), seed, first_tile, n_tiles, n_steps, antithetic,
                               stream);
}

// out[4]: registers, spill bytes, blocks per SM, block threads of the
// antithetic instance of ``which``: 0 local vol at degree 7, 1 local vol at
// a run-time degree, 2 QE-M, 3 Euler, 4 GBM.
int omt_terminal_attrs(int which, int* out) {
  using namespace omt::terminal;
  switch (which) {
    case 0: return omt::kernel_attrs(localvol_terminal_kernel<7, true>, kBlock, out);
    case 1: return omt::kernel_attrs(localvol_terminal_kernel<kRuntimeDegree, true>, kBlock, out);
    case 2: return omt::kernel_attrs(qe_terminal_kernel<true>, kBlock, out);
    case 3: return omt::kernel_attrs(euler_terminal_kernel<true>, kBlock, out);
    case 4: return omt::kernel_attrs(gbm_terminal_kernel<true>, kBlock, out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
