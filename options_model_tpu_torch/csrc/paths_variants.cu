// Store, exp and layout variants of the redesigned Heston Euler paths kernel
// (kernel 4, csrc/heston_paths.cu), for Hopper (sm_90a).
//
// Replaces the Pallas TPU experiment kernels
//   scripts/exp_paths_kernel.py     _make_paths_fn (its inner kernel): per-step
//                                   vs bulk exp, batched stores, row counts
//   scripts/exp_fullpath_layout.py  _make_strided, _make_contig, _make_storeless:
//                                   flat vs blocked output, no stores at all
// and computes what they compute: kernel 4's matrix in another exp form or
// layout. The first design of these variants (csrc/heston_variants.cu, on
// the first design of kernel 4) stays built as the yardstick. One kernel,
// templated on
//   kExp:    kExpPerStep stores S = 2^(log2 S0 + x log2 e) at each step
//            (kernel 4's store_s); kExpBulk stores x = log S - log S0 at each
//            step and, after the time loop, the same thread rewrites its own
//            columns with the same expression; kExpNone stores x (row 0 = 0)
//            and never exps;
//   kLayout: kFlat (n_steps+1, n_pad); kBlocked (n_tiles, n_steps+1, tile),
//            each tile one contiguous slab; kTerminalOnly (n_pad,), S_T and
//            no path stores (the storeless bound);
//   kU:      steps held in registers before their kU row stores;
//   kAnti:   antithetic pairs (one thread a pair) or single paths.
// The tile is a run-time argument (rows x 128 lanes on the TPU: rows 16, 32,
// 64, ..., 256 are tiles 2048, 4096, 8192, ..., 32768).
//
// The step is the one the pricers run (heston_paths.cu, hopper_fast.cuh):
// Philox with its round keys once per launch, one call serving two steps
// ((x, y) then (z, w), an odd n_steps a tail of one), box_muller_fast,
// w2 = fmaf(rho, z1, rho_bar z2), euler_step<false> (the form PATHS_DIGEST
// pins), and the constants folded on the card from the same (1, 10) row
// (ops/cuda_heston.batched_consts, hopper_fast.cuh's euler_consts). So at
// tile 4096 the per-step and bulk flat variants at every unroll, the blocked
// layout read back as flat and the storeless S_T equal kernel 4's output
// (cuda_heston.heston_paths) bit for bit, and the log-only form does after
// 2^(log2 S0 + x log2 e) (chip_smoke.py).
//
// What bounds it on the card: as kernel 4, its writes, 4 bytes a path-step
// (three passes over the matrix for the bulk exp: x written, read back, S
// written) and the issue rate of its step; the storeless variant writes
// 4 bytes a path and is kernel 4's compute floor. Every store carries the
// streaming hint (st.global.cs). The TPU-only knob vmem_mb of _make_contig
// (the compiler's scoped-VMEM limit) has no counterpart here.
//
// Built without --use_fast_math: the fast forms are named in
// hopper_fast.cuh, nowhere else.
#include <cstdint>

#include "hopper_fast.cuh"

namespace omt {
namespace pvariants {

using namespace fast;

enum ExpMode { kExpPerStep = 0, kExpBulk = 1, kExpNone = 2 };
enum Layout { kFlat = 0, kBlocked = 1, kTerminalOnly = 2 };
constexpr int kBlock = 256;

template <int kExp, int kLayout, int kU, bool kAnti>
__global__ void __launch_bounds__(kBlock)
paths_variant_kernel(float* __restrict__ S, const float* __restrict__ consts,
                     const __grid_constant__ PhiloxKeys keys, int first_tile, int n_tiles,
                     int tile, int n_steps) {
  static_assert(kU == 1 || kU % 2 == 0, "a register batch holds whole draws");
  const int width = kAnti ? tile / 2 : tile;
  const long long slot = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (slot >= static_cast<long long>(n_tiles) * width) return;
  const int local_tile = static_cast<int>(slot / width);
  const uint32_t j = static_cast<uint32_t>(slot % width);
  const uint32_t global_tile = static_cast<uint32_t>(first_tile + local_tile);
  const size_t n_pad = static_cast<size_t>(n_tiles) * tile;
  // Row stride, and this thread's column at row 0; its mirror's is + width.
  const size_t stride = kLayout == kBlocked ? static_cast<size_t>(tile) : n_pad;
  float* const col = S + j +
                     (kLayout == kBlocked ? static_cast<size_t>(local_tile) * (n_steps + 1) * tile
                                          : static_cast<size_t>(local_tile) * tile);
  const EulerK k = euler_consts(consts);
  float ls_a = 0.0f, v_a = k.v0, ls_b = 0.0f, v_b = k.v0;

  // A row entry: S per step, x otherwise.
  auto put = [&](float* p, float x) {
    if constexpr (kExp == kExpPerStep) {
      store_s(p, x, k.log2_s0);
    } else {
      __stcs(p, x);
    }
  };
  float* s = col;
  auto put_row = [&](float xa, float xb) {
    put(s, xa);
    if (kAnti) put(s + width, xb);
  };
  if constexpr (kLayout != kTerminalOnly) put_row(ls_a, ls_b);

  auto step = [&](uint32_t b1, uint32_t b2) {
    float z1, z2;
    box_muller_fast(b1, b2, z1, z2);
    const float w2 = fmaf(k.rho, z1, k.rho_bar * z2);
    euler_step(ls_a, v_a, z1, w2, k);
    if (kAnti) euler_step(ls_b, v_b, -z1, -w2, k);
  };
  auto draw = [&](int d) {
    return philox_keyed(Words{j, static_cast<uint32_t>(d), global_tile, 0u}, keys);
  };
  if constexpr (kU == 1) {
    auto step_row = [&](uint32_t b1, uint32_t b2) {
      step(b1, b2);
      if constexpr (kLayout != kTerminalOnly) {
        s += stride;
        put_row(ls_a, ls_b);
      }
    };
    const int n_draws = n_steps >> 1;
    for (int d = 0; d < n_draws; ++d) {
      const Words w = draw(d);
      step_row(w.x, w.y);
      step_row(w.z, w.w);
    }
    if (n_steps & 1) {
      const Words w = draw(n_draws);
      step_row(w.x, w.y);
    }
  } else {
    // n_steps is a multiple of kU (the C entry checks): kU / 2 draws a batch
    for (int t0 = 0; t0 < n_steps; t0 += kU) {
      float xa[kU], xb[kU];
#pragma unroll
      for (int q = 0; q < kU / 2; ++q) {
        const Words w = draw(t0 / 2 + q);
        step(w.x, w.y);
        xa[2 * q] = ls_a;
        xb[2 * q] = ls_b;
        step(w.z, w.w);
        xa[2 * q + 1] = ls_a;
        xb[2 * q + 1] = ls_b;
      }
      if constexpr (kLayout != kTerminalOnly) {
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          s += stride;
          put_row(xa[u], xb[u]);
        }
      }
    }
  }
  if constexpr (kLayout == kTerminalOnly) {
    float* out = S + static_cast<size_t>(local_tile) * tile + j;
    if constexpr (kExp == kExpNone) {
      __stcs(out, ls_a);
      if (kAnti) __stcs(out + width, ls_b);
    } else {
      store_s(out, ls_a, k.log2_s0);
      if (kAnti) store_s(out + width, ls_b, k.log2_s0);
    }
  } else if constexpr (kExp == kExpBulk) {
    // The thread reads back only what it wrote itself, so no barrier is needed.
    float* p = col;
    for (int t = 0; t <= n_steps; ++t, p += stride) {
      store_s(p, *p, k.log2_s0);
      if (kAnti) store_s(p + width, p[width], k.log2_s0);
    }
  }
}

template <int kExp, int kLayout, int kU>
int launch(float* S, const float* consts, const PhiloxKeys& keys, int first_tile, int n_tiles,
           int tile, int n_steps, bool antithetic, cudaStream_t stream) {
  const long long n_slots = static_cast<long long>(n_tiles) * (antithetic ? tile / 2 : tile);
  const unsigned int grid = static_cast<unsigned int>((n_slots + kBlock - 1) / kBlock);
  if (antithetic) {
    paths_variant_kernel<kExp, kLayout, kU, true><<<grid, kBlock, 0, stream>>>(
        S, consts, keys, first_tile, n_tiles, tile, n_steps);
  } else {
    paths_variant_kernel<kExp, kLayout, kU, false><<<grid, kBlock, 0, stream>>>(
        S, consts, keys, first_tile, n_tiles, tile, n_steps);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace pvariants
}  // namespace omt

extern "C" {

// S: device float32, (n_steps+1, n_tiles*tile) for layout 0 (flat),
// (n_tiles, n_steps+1, tile) for layout 1 (blocked), (n_tiles*tile,) for
// layout 2 (terminal only). consts: device pointer to one HestonConsts row
// of 10 floats (ops/cuda_heston.batched_consts). exp_mode: 0 per step, 1
// bulk, 2 none. The built set of (exp_mode, layout, unroll) is
// ops/cuda_heston_variants.VARIANTS; any other combination, an odd tile with
// antithetic pairs, or n_steps not a multiple of unroll returns
// cudaErrorInvalidValue without launching.
int omt_paths_variant(void* S, const void* consts, uint64_t seed, int first_tile, int n_tiles,
                      int tile, int n_steps, int antithetic, int exp_mode, int layout,
                      int unroll, void* stream) {
  using namespace omt::pvariants;
  if (tile <= 0 || (antithetic && tile % 2 != 0) || unroll <= 0 || n_steps % unroll != 0 ||
      n_tiles < 1 || n_steps < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  float* out = static_cast<float*>(S);
  const float* c = static_cast<const float*>(consts);
  const PhiloxKeys keys = philox_keys(seed);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define OMT_VARIANT(E, L, U)                                                              \
  if (exp_mode == E && layout == L && unroll == U)                                        \
    return launch<E, L, U>(out, c, keys, first_tile, n_tiles, tile, n_steps, antithetic != 0, \
                           st);
#define OMT_PATH_VARIANTS(L)     \
  OMT_VARIANT(kExpPerStep, L, 1) \
  OMT_VARIANT(kExpBulk, L, 1)    \
  OMT_VARIANT(kExpBulk, L, 2)    \
  OMT_VARIANT(kExpBulk, L, 4)    \
  OMT_VARIANT(kExpBulk, L, 10)   \
  OMT_VARIANT(kExpNone, L, 1)
  OMT_PATH_VARIANTS(kFlat)
  OMT_PATH_VARIANTS(kBlocked)
  OMT_VARIANT(kExpPerStep, kTerminalOnly, 1)
#undef OMT_PATH_VARIANTS
#undef OMT_VARIANT
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
