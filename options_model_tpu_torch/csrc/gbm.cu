// GBM log-Euler path kernels for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels
//   options_model_tpu/ops/pallas_gbm.py  gbm_terminal_pallas (_gbm_terminal_kernel)
//   options_model_tpu/ops/pallas_gbm.py  gbm_paths_pallas    (_gbm_paths_kernel)
// One thread owns one antithetic pair (or one path when antithetic is off)
// and keeps its state in registers for the whole time loop; tiles of
// kPathTile / kTerminalTile paths are logical stream and pairing units only.
// One normal per path-step, both Box-Muller outputs used: normal t of a slot
// is word pair (t % 4) / 2 of Philox draw t / 4, cosine branch on even t.
//
// - gbm_paths: log S <- log S + drift + diffusion z each step, written as
//   S0 * exp(log S) (the reference's formula; row 0 is S0). Bound by
//   device-memory writes, 4 bytes per path-step; each step's row is one
//   coalesced store of the flat (n_steps+1, n_pad) layout.
// - gbm_terminal: sums z over the steps and writes
//   S0 * exp(drift * n_steps + diffusion * sum); the mirror path's sum is
//   exactly -sum. Bound by arithmetic: per pair-step half a Box-Muller (log,
//   sqrt, sin, cos) and a quarter of a Philox call; one store per path.
// Simple first versions; built without --use_fast_math.
#include "philox.cuh"

namespace omt {

constexpr int kGbmPathTile = 4096;
constexpr int kGbmTerminalTile = 16384;

// Same order as models/gbm.gbm_constants.
struct GbmConsts {
  float s0, drift, diffusion, drift_n;  // drift_n = drift * n_steps in f32
};

template <bool kPaths>
__global__ void __launch_bounds__(kBlockThreads)
gbm_kernel(float* __restrict__ S, GbmConsts p, uint64_t seed, int first_tile, int n_tiles,
           int tile, int n_steps, bool antithetic) {
  const int width = antithetic ? tile / 2 : tile;
  const long long slot = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (slot >= static_cast<long long>(n_tiles) * width) return;
  const int local_tile = static_cast<int>(slot / width);
  const uint32_t j = static_cast<uint32_t>(slot % width);
  const uint32_t global_tile = static_cast<uint32_t>(first_tile + local_tile);
  const size_t n_pad = static_cast<size_t>(n_tiles) * tile;
  const size_t col_a = static_cast<size_t>(local_tile) * tile + j;
  const size_t col_b = col_a + width;

  // kPaths: log S of both mirror paths; terminal: a holds the sum of z.
  float a = 0.0f, b = 0.0f;
  if (kPaths) {
    S[col_a] = p.s0 * expf(a);
    if (antithetic) S[col_b] = p.s0 * expf(b);
  }
  Words w{};
  float zc = 0.0f, zs = 0.0f;
  for (int t = 0; t < n_steps; ++t) {
    if ((t & 3) == 0) w = slot_draw(j, static_cast<uint32_t>(t >> 2), global_tile, seed);
    if ((t & 1) == 0) {
      if ((t & 2) == 0) box_muller(w.x, w.y, zc, zs);
      else box_muller(w.z, w.w, zc, zs);
    }
    const float z = (t & 1) ? zs : zc;
    if (kPaths) {
      a = a + p.drift + p.diffusion * z;
      b = b + p.drift + p.diffusion * (-z);
      const size_t row = static_cast<size_t>(t + 1) * n_pad;
      S[row + col_a] = p.s0 * expf(a);
      if (antithetic) S[row + col_b] = p.s0 * expf(b);
    } else {
      a = a + z;
    }
  }
  if (!kPaths) {
    S[col_a] = p.s0 * expf(p.drift_n + p.diffusion * a);
    if (antithetic) S[col_b] = p.s0 * expf(p.drift_n + p.diffusion * (-a));
  }
}

template <bool kPaths>
int launch_gbm(float* S, const float* consts, uint64_t seed, int first_tile, int n_tiles,
               int tile, int n_steps, int antithetic, void* stream) {
  const GbmConsts p{consts[0], consts[1], consts[2], consts[3]};
  const long long n_slots = static_cast<long long>(n_tiles) * (antithetic ? tile / 2 : tile);
  gbm_kernel<kPaths><<<grid_for(n_slots), kBlockThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      S, p, seed, first_tile, n_tiles, tile, n_steps, antithetic != 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace omt

extern "C" {

// S: device (n_steps+1, n_tiles*4096) float32; consts: host pointer to 4 floats.
int omt_gbm_paths(void* S, const void* consts, uint64_t seed, int first_tile, int n_tiles,
                  int n_steps, int antithetic, void* stream) {
  return omt::launch_gbm<true>(static_cast<float*>(S), static_cast<const float*>(consts),
                               seed, first_tile, n_tiles, omt::kGbmPathTile, n_steps,
                               antithetic, stream);
}

// out: device (n_tiles*16384,) float32 terminal prices.
int omt_gbm_terminal(void* out, const void* consts, uint64_t seed, int first_tile,
                     int n_tiles, int n_steps, int antithetic, void* stream) {
  return omt::launch_gbm<false>(static_cast<float*>(out), static_cast<const float*>(consts),
                                seed, first_tile, n_tiles, omt::kGbmTerminalTile, n_steps,
                                antithetic, stream);
}

}  // extern "C"
