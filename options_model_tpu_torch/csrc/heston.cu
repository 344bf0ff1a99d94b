// Heston full-truncation Euler path kernels for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels
//   options_model_tpu/ops/pallas_heston.py  heston_terminal_pallas (_terminal_kernel)
//   options_model_tpu/ops/pallas_heston.py  heston_paths_pallas    (_paths_kernel,
//                                                                   _paths_v_kernel)
// and computes what they compute, not how: one thread owns one antithetic
// pair (or one path when antithetic is off) and carries (log S, v) of both
// mirror paths in registers through the whole time loop. Tiles of
// kPathTile / kTerminalTile paths are logical stream and pairing units only
// (path j and j + tile/2 of a tile are mirrors); the CUDA block is 256
// threads over consecutive slots.
//
// Per step: w2 = rho z1 + rho_bar z2, v+ = max(v, 0),
//   v <- max(v+ + kappa (theta - v+) dt + xi sqrt(v+) sqrt(dt) w2, 0),
//   log S <- log S + (r - v+/2) dt + sqrt(v+) sqrt(dt) z1,
// the recursion of models/heston.heston_euler_from_normals. S is written as
// exp(log S0 + rel), the reference's formula, row 0 included.
//
// What bounds it on the card:
// - heston_paths: device-memory writes, 4 bytes per path-step (8 with v).
//   Each step's row is one coalesced store: neighbouring threads hold
//   neighbouring paths of the flat (n_steps+1, n_pad) layout.
// - heston_terminal: arithmetic. Per pair-step one Box-Muller (log, sqrt,
//   sin, cos), half a Philox call, and two Euler steps; one store per path.
// Both are a simple first version; wider stores and fewer transcendentals
// are later work. Built without --use_fast_math. The per-step arithmetic
// (HestonConsts, heston_step, step_normals) is in heston_common.cuh, which
// the store/exp/layout variants of heston_variants.cu share.
#include <cstring>

#include "heston_common.cuh"
#include "kernel_attrs.cuh"

namespace omt {

// kPaths: write the (n_steps+1, n_pad) S matrix (and V when non-null);
// otherwise write S_T only, into S[0:n_pad].
template <bool kPaths>
__global__ void __launch_bounds__(kBlockThreads)
heston_kernel(float* __restrict__ S, float* __restrict__ V, HestonConsts p, uint64_t seed,
              int first_tile, int n_tiles, int tile, int n_steps, bool antithetic) {
  const int width = antithetic ? tile / 2 : tile;
  const long long slot = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (slot >= static_cast<long long>(n_tiles) * width) return;
  const int local_tile = static_cast<int>(slot / width);
  const uint32_t j = static_cast<uint32_t>(slot % width);
  const uint32_t global_tile = static_cast<uint32_t>(first_tile + local_tile);
  const size_t n_pad = static_cast<size_t>(n_tiles) * tile;
  const size_t col_a = static_cast<size_t>(local_tile) * tile + j;
  const size_t col_b = col_a + width;  // the mirror path, when antithetic

  float ls_a = 0.0f, v_a = p.v0, ls_b = 0.0f, v_b = p.v0;
  if (kPaths) {
    S[col_a] = expf(p.log_s0 + ls_a);
    if (antithetic) S[col_b] = expf(p.log_s0 + ls_b);
    if (V != nullptr) {
      V[col_a] = v_a;
      if (antithetic) V[col_b] = v_b;
    }
  }
  Words w{};
  for (int t = 0; t < n_steps; ++t) {
    float z1, z2;
    step_normals(t, j, global_tile, seed, w, z1, z2);
    heston_step(ls_a, v_a, z1, z2, p);
    if (antithetic) heston_step(ls_b, v_b, -z1, -z2, p);
    if (kPaths) {
      const size_t row = static_cast<size_t>(t + 1) * n_pad;
      S[row + col_a] = expf(p.log_s0 + ls_a);
      if (antithetic) S[row + col_b] = expf(p.log_s0 + ls_b);
      if (V != nullptr) {
        V[row + col_a] = v_a;
        if (antithetic) V[row + col_b] = v_b;
      }
    }
  }
  if (!kPaths) {
    S[col_a] = expf(p.log_s0 + ls_a);
    if (antithetic) S[col_b] = expf(p.log_s0 + ls_b);
  }
}

template <bool kPaths>
int launch_heston(float* S, float* V, const float* consts, uint64_t seed, int first_tile,
                  int n_tiles, int tile, int n_steps, int antithetic, void* stream) {
  HestonConsts p;
  std::memcpy(&p, consts, sizeof(p));
  const long long n_slots = static_cast<long long>(n_tiles) * (antithetic ? tile / 2 : tile);
  heston_kernel<kPaths><<<grid_for(n_slots), kBlockThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      S, V, p, seed, first_tile, n_tiles, tile, n_steps, antithetic != 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace omt

extern "C" {

// S, V: device (n_steps+1, n_tiles*4096) float32, V may be null.
// consts: host pointer to the 10 floats of HestonConsts.
int omt_heston_paths(void* S, void* V, const void* consts, uint64_t seed, int first_tile,
                     int n_tiles, int n_steps, int antithetic, void* stream) {
  return omt::launch_heston<true>(static_cast<float*>(S), static_cast<float*>(V),
                                  static_cast<const float*>(consts), seed, first_tile,
                                  n_tiles, omt::kPathTile, n_steps, antithetic, stream);
}

// out: device (n_tiles*16384,) float32 terminal prices.
int omt_heston_terminal(void* out, const void* consts, uint64_t seed, int first_tile,
                        int n_tiles, int n_steps, int antithetic, void* stream) {
  return omt::launch_heston<false>(static_cast<float*>(out), nullptr,
                                   static_cast<const float*>(consts), seed, first_tile,
                                   n_tiles, omt::kTerminalTile, n_steps, antithetic, stream);
}

// out[4]: registers, spill bytes, blocks per SM, block threads of the paths kernel.
int omt_heston_paths_attrs(int* out) {
  return omt::kernel_attrs(omt::heston_kernel<true>, omt::kBlockThreads, out);
}

}  // extern "C"
