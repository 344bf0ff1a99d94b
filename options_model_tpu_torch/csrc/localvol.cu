// Local-volatility path kernels over a Chebyshev table, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels
//   options_model_tpu/ops/pallas_localvol.py  localvol_terminal_pallas
//                                             (_localvol_terminal_kernel)
//   options_model_tpu/ops/pallas_localvol.py  localvol_paths_pallas
//                                             (_localvol_paths_kernel)
// Per step t, from the carried absolute log S:
//   u     = clip(((log K - log S) - m_center) * (1/m_half), -1, 1)
//   sigma = max(c0 + u b1 - b2, 1e-6), Clenshaw from k = degree down to 1
//           over row t of the table (b1 <- c_k + 2 u b1 - b2),
//   log S <- log S + (r - sigma^2/2) dt + sigma sqrt(dt) z,
// in the order of models/localvol.localvol_euler_from_normals. The normals
// are the GBM stream of csrc/gbm.cu (normal t from Philox draw t/4), so a
// constant-sigma table reproduces the GBM kernels' draws.
//
// One thread owns one antithetic pair (or one path) as in csrc/gbm.cu. Every
// thread reads the same table row at step t: the row is read through the
// read-only cache (__ldg), where a uniform address is one broadcast per warp,
// so any degree and any row count work without staging. The table is
// (n_rows >= n_steps, degree+1) float32, row-major; rows past n_steps are
// never read.
//
// What bounds it on the card:
// - localvol_paths: device-memory writes, 4 bytes per path-step, one
//   coalesced row store per step of the flat (n_steps+1, n_pad) layout.
// - localvol_terminal: arithmetic. Per path-step `degree` Clenshaw steps
//   (two FMAs each) and the log-Euler update; per pair-step half a
//   Box-Muller (logf, sqrtf, sinf, cosf) and a quarter of a Philox call.
// A simple first version, built without --use_fast_math.
#include "philox.cuh"

namespace omt {

constexpr int kLvPathTile = 4096;
constexpr int kLvTerminalTile = 16384;

// Same order as ops/cuda_localvol._consts.
struct LvConsts {
  float log_s0, r, dt, sqrt_dt, log_k, m_center, inv_m_half;
};

__device__ __forceinline__ float lv_step(float log_s, float z, const float* __restrict__ c,
                                         int n_coeffs, const LvConsts& p) {
  const float u = fminf(fmaxf(((p.log_k - log_s) - p.m_center) * p.inv_m_half, -1.0f), 1.0f);
  float b1 = 0.0f, b2 = 0.0f;
  for (int k = n_coeffs - 1; k >= 1; --k) {
    const float b0 = __ldg(c + k) + 2.0f * u * b1 - b2;
    b2 = b1;
    b1 = b0;
  }
  const float sig = fmaxf(__ldg(c) + u * b1 - b2, 1e-6f);
  return log_s + (p.r - 0.5f * sig * sig) * p.dt + sig * p.sqrt_dt * z;
}

// kPaths: write the (n_steps+1, n_pad) S matrix; otherwise S_T into S[0:n_pad].
template <bool kPaths>
__global__ void __launch_bounds__(kBlockThreads)
localvol_kernel(float* __restrict__ S, const float* __restrict__ coeffs, LvConsts p,
                uint64_t seed, int first_tile, int n_tiles, int tile, int n_steps,
                int n_coeffs, bool antithetic) {
  const int width = antithetic ? tile / 2 : tile;
  const long long slot = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (slot >= static_cast<long long>(n_tiles) * width) return;
  const int local_tile = static_cast<int>(slot / width);
  const uint32_t j = static_cast<uint32_t>(slot % width);
  const uint32_t global_tile = static_cast<uint32_t>(first_tile + local_tile);
  const size_t n_pad = static_cast<size_t>(n_tiles) * tile;
  const size_t col_a = static_cast<size_t>(local_tile) * tile + j;
  const size_t col_b = col_a + width;  // the mirror path, when antithetic

  float ls_a = p.log_s0, ls_b = p.log_s0;
  if (kPaths) {
    S[col_a] = expf(ls_a);
    if (antithetic) S[col_b] = expf(ls_b);
  }
  Words w{};
  float zc = 0.0f, zs = 0.0f;
  for (int t = 0; t < n_steps; ++t) {
    // normal t of this slot: draw t/4, word pair (t%4)/2, cosine on even t
    if ((t & 3) == 0) w = slot_draw(j, static_cast<uint32_t>(t >> 2), global_tile, seed);
    if ((t & 1) == 0) {
      if ((t & 2) == 0) box_muller(w.x, w.y, zc, zs);
      else box_muller(w.z, w.w, zc, zs);
    }
    const float z = (t & 1) ? zs : zc;
    const float* row = coeffs + static_cast<size_t>(t) * n_coeffs;
    ls_a = lv_step(ls_a, z, row, n_coeffs, p);
    if (antithetic) ls_b = lv_step(ls_b, -z, row, n_coeffs, p);
    if (kPaths) {
      const size_t out = static_cast<size_t>(t + 1) * n_pad;
      S[out + col_a] = expf(ls_a);
      if (antithetic) S[out + col_b] = expf(ls_b);
    }
  }
  if (!kPaths) {
    S[col_a] = expf(ls_a);
    if (antithetic) S[col_b] = expf(ls_b);
  }
}

template <bool kPaths>
int launch_localvol(float* S, const float* coeffs, const float* consts, uint64_t seed,
                    int first_tile, int n_tiles, int tile, int n_steps, int n_coeffs,
                    int antithetic, void* stream) {
  const LvConsts p{consts[0], consts[1], consts[2], consts[3], consts[4], consts[5],
                   consts[6]};
  const long long n_slots = static_cast<long long>(n_tiles) * (antithetic ? tile / 2 : tile);
  localvol_kernel<kPaths><<<grid_for(n_slots), kBlockThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      S, coeffs, p, seed, first_tile, n_tiles, tile, n_steps, n_coeffs, antithetic != 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace omt

extern "C" {

// S: device (n_steps+1, n_tiles*4096) float32; coeffs: device (>= n_steps, n_coeffs)
// float32, row-major; consts: host pointer to the 7 floats of LvConsts.
int omt_localvol_paths(void* S, const void* coeffs, const void* consts, uint64_t seed,
                       int first_tile, int n_tiles, int n_steps, int n_coeffs, int antithetic,
                       void* stream) {
  return omt::launch_localvol<true>(static_cast<float*>(S), static_cast<const float*>(coeffs),
                                    static_cast<const float*>(consts), seed, first_tile,
                                    n_tiles, omt::kLvPathTile, n_steps, n_coeffs, antithetic,
                                    stream);
}

// out: device (n_tiles*16384,) float32 terminal prices.
int omt_localvol_terminal(void* out, const void* coeffs, const void* consts, uint64_t seed,
                          int first_tile, int n_tiles, int n_steps, int n_coeffs,
                          int antithetic, void* stream) {
  return omt::launch_localvol<false>(static_cast<float*>(out),
                                     static_cast<const float*>(coeffs),
                                     static_cast<const float*>(consts), seed, first_tile,
                                     n_tiles, omt::kLvTerminalTile, n_steps, n_coeffs,
                                     antithetic, stream);
}

}  // extern "C"
