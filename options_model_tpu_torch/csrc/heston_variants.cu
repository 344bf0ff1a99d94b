// Store, exp and layout variants of the Heston Euler paths kernel (kernel 4,
// heston.cu), for Hopper (sm_90a).
//
// Replaces the Pallas TPU experiment kernels
//   scripts/exp_paths_kernel.py     _make_paths_fn (its inner kernel): per-step
//                                   vs bulk exp, batched stores, row counts
//   scripts/exp_fullpath_layout.py  _make_strided, _make_contig, _make_storeless:
//                                   flat vs blocked output, no stores at all
// and computes what they compute: kernel 4's matrix in another exp form or
// layout. One kernel, templated on
//   kExp:    kExpPerStep stores expf(log_s0 + ls) at each step (kernel 4);
//            kExpBulk stores ls at each step and, after the time loop, the
//            same thread rewrites its own columns as expf(log_s0 + ls);
//            kExpNone stores ls = log(S_t / S0) (row 0 = 0) and never exps;
//   kLayout: kFlat (n_steps+1, n_pad); kBlocked (n_tiles, n_steps+1, tile),
//            each tile one contiguous slab; kTerminalOnly (n_pad,), S_T and
//            no path stores (the storeless bound);
//   kU:      steps held in registers before their kU row stores.
// The tile is a run-time argument (rows x 128 lanes on the TPU: rows 16, 32,
// 64, ..., 256 are tiles 2048, 4096, 8192, ..., 32768). The stream stays keyed
// by (seed, global tile, draw), one thread per antithetic pair, and the step
// is heston_common.cuh's, so the per-step, bulk and batched variants, the
// blocked layout read back as flat, and the storeless S_T equal kernel 4's
// output bit for bit at tile 4096.
//
// What bounds it on the card: as kernel 4, device-memory writes, 4 bytes per
// path-step (twice that, plus a read, for the bulk exp); the storeless
// variant is bounded by arithmetic and is kernel 4's compute floor. This is a
// simple kernel that is right; 16-byte stores and TMA are later work. The
// TPU-only knob vmem_mb of _make_contig (the compiler's scoped-VMEM limit) has
// no counterpart here.
#include <cstring>

#include "heston_common.cuh"

namespace omt {

enum ExpMode { kExpPerStep = 0, kExpBulk = 1, kExpNone = 2 };
enum Layout { kFlat = 0, kBlocked = 1, kTerminalOnly = 2 };

template <int kExp, int kLayout, int kU>
__global__ void __launch_bounds__(kBlockThreads)
heston_variant_kernel(float* __restrict__ S, HestonConsts p, uint64_t seed, int first_tile,
                      int n_tiles, int tile, int n_steps, bool antithetic) {
  const int width = antithetic ? tile / 2 : tile;
  const long long slot = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (slot >= static_cast<long long>(n_tiles) * width) return;
  const int local_tile = static_cast<int>(slot / width);
  const uint32_t j = static_cast<uint32_t>(slot % width);
  const uint32_t global_tile = static_cast<uint32_t>(first_tile + local_tile);
  const size_t n_pad = static_cast<size_t>(n_tiles) * tile;
  // Offset of step t of column c (0 <= c < tile) of this thread's tile.
  auto at = [&](int t, int c) -> size_t {
    if (kLayout == kBlocked) {
      return (static_cast<size_t>(local_tile) * (n_steps + 1) + t) * tile + c;
    }
    return static_cast<size_t>(t) * n_pad + static_cast<size_t>(local_tile) * tile + c;
  };
  const int ca = static_cast<int>(j);
  const int cb = ca + width;  // the mirror path, when antithetic

  float ls_a = 0.0f, v_a = p.v0, ls_b = 0.0f, v_b = p.v0;
  if (kLayout != kTerminalOnly) {
    S[at(0, ca)] = kExp == kExpPerStep ? expf(p.log_s0 + ls_a) : ls_a;
    if (antithetic) S[at(0, cb)] = kExp == kExpPerStep ? expf(p.log_s0 + ls_b) : ls_b;
  }
  Words w{};
  for (int t0 = 0; t0 < n_steps; t0 += kU) {
    float out_a[kU], out_b[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      float z1, z2;
      step_normals(t0 + u, j, global_tile, seed, w, z1, z2);
      heston_step(ls_a, v_a, z1, z2, p);
      if (antithetic) heston_step(ls_b, v_b, -z1, -z2, p);
      out_a[u] = kExp == kExpPerStep ? expf(p.log_s0 + ls_a) : ls_a;
      out_b[u] = kExp == kExpPerStep ? expf(p.log_s0 + ls_b) : ls_b;
    }
    if (kLayout != kTerminalOnly) {
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        S[at(t0 + u + 1, ca)] = out_a[u];
        if (antithetic) S[at(t0 + u + 1, cb)] = out_b[u];
      }
    }
  }
  if (kLayout == kTerminalOnly) {
    const size_t col = static_cast<size_t>(local_tile) * tile;
    S[col + ca] = kExp == kExpNone ? ls_a : expf(p.log_s0 + ls_a);
    if (antithetic) S[col + cb] = kExp == kExpNone ? ls_b : expf(p.log_s0 + ls_b);
  } else if (kExp == kExpBulk) {
    // The thread reads back only what it wrote itself, so no barrier is needed.
    for (int t = 0; t <= n_steps; ++t) {
      S[at(t, ca)] = expf(p.log_s0 + S[at(t, ca)]);
      if (antithetic) S[at(t, cb)] = expf(p.log_s0 + S[at(t, cb)]);
    }
  }
}

template <int kExp, int kLayout, int kU>
int launch_variant(float* S, const HestonConsts& p, uint64_t seed, int first_tile, int n_tiles,
                   int tile, int n_steps, int antithetic, cudaStream_t stream) {
  const long long n_slots = static_cast<long long>(n_tiles) * (antithetic ? tile / 2 : tile);
  heston_variant_kernel<kExp, kLayout, kU><<<grid_for(n_slots), kBlockThreads, 0, stream>>>(
      S, p, seed, first_tile, n_tiles, tile, n_steps, antithetic != 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace omt

extern "C" {

// S: device float32, (n_steps+1, n_tiles*tile) for layout 0 (flat),
// (n_tiles, n_steps+1, tile) for layout 1 (blocked), (n_tiles*tile,) for
// layout 2 (terminal only). consts: host pointer to the 10 floats of
// HestonConsts. exp_mode: 0 per step, 1 bulk, 2 none. The built set of
// (exp_mode, layout, unroll) is ops/cuda_heston_variants.VARIANTS; any other
// combination, an odd tile with antithetic pairs, or n_steps not a multiple
// of unroll returns cudaErrorInvalidValue without launching.
int omt_heston_variant(void* S, const void* consts, uint64_t seed, int first_tile, int n_tiles,
                       int tile, int n_steps, int antithetic, int exp_mode, int layout,
                       int unroll, void* stream) {
  using namespace omt;
  HestonConsts p;
  std::memcpy(&p, consts, sizeof(p));
  float* out = static_cast<float*>(S);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tile <= 0 || (antithetic && tile % 2 != 0) || unroll <= 0 || n_steps % unroll != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#define OMT_VARIANT(E, L, U)                                                          \
  if (exp_mode == E && layout == L && unroll == U)                                    \
    return launch_variant<E, L, U>(out, p, seed, first_tile, n_tiles, tile, n_steps, \
                                   antithetic, st);
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
