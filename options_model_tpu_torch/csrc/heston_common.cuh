// Kernel 4's per-step arithmetic, shared by heston.cu (the paths and
// terminal kernels) and heston_variants.cu (its store, exp and layout
// variants), so every variant runs the same instructions per step and gives
// the same bits.
#pragma once

#include "philox.cuh"

namespace omt {

constexpr int kPathTile = 4096;
constexpr int kTerminalTile = 16384;

// Same order as models/heston.heston_constants.
struct HestonConsts {
  float log_s0, r, dt, sqrt_dt, kappa, theta, xi, rho, rho_bar, v0;
};

__device__ __forceinline__ void heston_step(float& log_s, float& v, float z1, float z2,
                                            const HestonConsts& p) {
  const float w2 = p.rho * z1 + p.rho_bar * z2;
  const float v_plus = fmaxf(v, 0.0f);
  const float sq = sqrtf(v_plus) * p.sqrt_dt;
  v = fmaxf(v_plus + p.kappa * (p.theta - v_plus) * p.dt + p.xi * sq * w2, 0.0f);
  log_s = log_s + (p.r - 0.5f * v_plus) * p.dt + sq * z1;
}

// Normals 2t and 2t+1 of a slot: Philox draw t/2, word pair t%2. ``w``
// carries the draw from the even step to the odd one.
__device__ __forceinline__ void step_normals(int t, uint32_t j, uint32_t global_tile,
                                             uint64_t seed, Words& w, float& z1, float& z2) {
  if ((t & 1) == 0) {
    w = slot_draw(j, static_cast<uint32_t>(t >> 1), global_tile, seed);
    box_muller(w.x, w.y, z1, z2);
  } else {
    box_muller(w.z, w.w, z1, z2);
  }
}

}  // namespace omt
