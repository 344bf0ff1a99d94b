// Heston QE-M path kernels for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels
//   options_model_tpu/ops/pallas_heston.py  heston_terminal_qe_pallas (_qe_terminal_kernel)
//   options_model_tpu/ops/pallas_heston.py  heston_paths_qe_pallas    (_qe_paths_kernel,
//                                                                      _qe_paths_v_kernel)
// both built on _qe_body: Andersen's quadratic-exponential scheme with the
// martingale-corrected K0*. As in csrc/heston.cu, one thread owns one
// antithetic pair (or one path when antithetic is off) and carries
// (log S, v) of both mirror paths in registers through the whole time loop;
// tiles are stream and pairing units only, the CUDA block is 256 threads.
//
// Per step t the slot takes Philox draw t: (w0, w1) -> Box-Muller ->
// (z_v, z_s), w2 -> the raw uniform u; the mirror path uses
// (-z_v, -z_s, 1 - u) (ops/philox.qe_path_draws). Each path evaluates only
// the branch it takes: quadratic when psi <= 1.5, exponential otherwise.
//
// Rounding: every add, multiply and divide is an explicit _rn intrinsic,
// which the compiler never contracts into an FMA, in the operation order of
// models/heston.heston_qe_from_normals. The branch mask psi <= 1.5 and the
// test u <= p therefore see the same f32 values as the plain version; a
// contracted m or s2 would flip the branch of a path whose psi sits within an
// ulp of 1.5, and that path would leave its plain twin for good.
//
// What bounds it on the card:
// - heston_paths_qe: device-memory writes, 4 bytes per path-step (8 with v),
//   one coalesced row store per step of the flat (n_steps+1, n_pad) layout.
// - heston_terminal_qe: arithmetic. Per path-step 2-3 logf (one in the
//   Box-Muller, one or two in the branch), 3-4 sqrtf, and per pair-step one
//   Philox call and the Box-Muller's sinf/cosf; one store per path.
// A simple first version, built without --use_fast_math.
#include <cstring>

#include "kernel_attrs.cuh"
#include "philox.cuh"

namespace omt {

constexpr int kQePathTile = 4096;
constexpr int kQeTerminalTile = 16384;

// Same order as ops/cuda_heston._qe_consts.
struct QeConsts {
  float log_s0, r_dt, theta, v0, ekt, c1, c2, K1, K2, K3, K4, A, k0_shift;
};

__device__ __forceinline__ float fadd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float fsub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float fmul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float fdiv(float a, float b) { return __fdiv_rn(a, b); }

__device__ __forceinline__ void qe_step(float& log_s, float& v, float z_v, float z_s, float u,
                                        const QeConsts& p) {
  const float m = fadd(p.theta, fmul(fsub(v, p.theta), p.ekt));
  const float s2 = fadd(fmul(v, p.c1), p.c2);
  const float psi = fdiv(s2, fmaxf(fmul(m, m), 1e-20f));
  float v_new, k0;
  if (psi <= 1.5f) {
    const float two_over = fdiv(2.0f, fmaxf(psi, 1e-12f));
    const float b2 = fmaxf(fadd(fsub(two_over, 1.0f),
                                fmul(sqrtf(fmaxf(two_over, 0.0f)),
                                     sqrtf(fmaxf(fsub(two_over, 1.0f), 0.0f)))),
                           0.0f);
    const float a = fdiv(m, fadd(1.0f, b2));
    const float bz = fadd(sqrtf(b2), z_v);
    v_new = fmul(a, fmul(bz, bz));
    const float Aa = fmul(p.A, a);
    const float one_m = fmaxf(fsub(1.0f, fmul(2.0f, Aa)), 1e-6f);
    k0 = fadd(fdiv(fmul(-Aa, b2), one_m), fmul(0.5f, logf(one_m)));
  } else {
    const float q = fminf(fmaxf(fdiv(fsub(psi, 1.0f), fadd(psi, 1.0f)), 0.0f), 1.0f - 1e-7f);
    const float beta = fdiv(fsub(1.0f, q), fmaxf(m, 1e-20f));
    v_new = (u <= q) ? 0.0f
                     : fdiv(logf(fdiv(fsub(1.0f, q), fmaxf(fsub(1.0f, u), 1e-12f))),
                            fmaxf(beta, 1e-20f));
    k0 = -logf(fmaxf(fadd(q, fdiv(fmul(beta, fsub(1.0f, q)), fmaxf(fsub(beta, p.A), 1e-12f))),
                     1e-12f));
  }
  const float k0_star = fsub(k0, fmul(p.k0_shift, v));
  float ls = fadd(fadd(fadd(fadd(log_s, p.r_dt), k0_star), fmul(p.K1, v)), fmul(p.K2, v_new));
  ls = fadd(ls, fmul(sqrtf(fmaxf(fadd(fmul(p.K3, v), fmul(p.K4, v_new)), 0.0f)), z_s));
  log_s = ls;
  v = v_new;
}

// kPaths: write the (n_steps+1, n_pad) S matrix (and V when non-null);
// otherwise write S_T only, into S[0:n_pad].
template <bool kPaths>
__global__ void __launch_bounds__(kBlockThreads)
heston_qe_kernel(float* __restrict__ S, float* __restrict__ V, QeConsts p, uint64_t seed,
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
    S[col_a] = expf(fadd(p.log_s0, ls_a));
    if (antithetic) S[col_b] = expf(fadd(p.log_s0, ls_b));
    if (V != nullptr) {
      V[col_a] = v_a;
      if (antithetic) V[col_b] = v_b;
    }
  }
  for (int t = 0; t < n_steps; ++t) {
    const Words w = slot_draw(j, static_cast<uint32_t>(t), global_tile, seed);
    float z_v, z_s;
    box_muller(w.x, w.y, z_v, z_s);
    const float u = uniform_from_bits(w.z);
    qe_step(ls_a, v_a, z_v, z_s, u, p);
    if (antithetic) qe_step(ls_b, v_b, -z_v, -z_s, fsub(1.0f, u), p);
    if (kPaths) {
      const size_t row = static_cast<size_t>(t + 1) * n_pad;
      S[row + col_a] = expf(fadd(p.log_s0, ls_a));
      if (antithetic) S[row + col_b] = expf(fadd(p.log_s0, ls_b));
      if (V != nullptr) {
        V[row + col_a] = v_a;
        if (antithetic) V[row + col_b] = v_b;
      }
    }
  }
  if (!kPaths) {
    S[col_a] = expf(fadd(p.log_s0, ls_a));
    if (antithetic) S[col_b] = expf(fadd(p.log_s0, ls_b));
  }
}

template <bool kPaths>
int launch_heston_qe(float* S, float* V, const float* consts, uint64_t seed, int first_tile,
                     int n_tiles, int tile, int n_steps, int antithetic, void* stream) {
  QeConsts p;
  std::memcpy(&p, consts, sizeof(p));
  const long long n_slots = static_cast<long long>(n_tiles) * (antithetic ? tile / 2 : tile);
  heston_qe_kernel<kPaths><<<grid_for(n_slots), kBlockThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      S, V, p, seed, first_tile, n_tiles, tile, n_steps, antithetic != 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace omt

extern "C" {

// S, V: device (n_steps+1, n_tiles*4096) float32, V may be null.
// consts: host pointer to the 13 floats of QeConsts.
int omt_heston_paths_qe(void* S, void* V, const void* consts, uint64_t seed, int first_tile,
                        int n_tiles, int n_steps, int antithetic, void* stream) {
  return omt::launch_heston_qe<true>(static_cast<float*>(S), static_cast<float*>(V),
                                     static_cast<const float*>(consts), seed, first_tile,
                                     n_tiles, omt::kQePathTile, n_steps, antithetic, stream);
}

// out: device (n_tiles*16384,) float32 terminal prices.
int omt_heston_terminal_qe(void* out, const void* consts, uint64_t seed, int first_tile,
                           int n_tiles, int n_steps, int antithetic, void* stream) {
  return omt::launch_heston_qe<false>(static_cast<float*>(out), nullptr,
                                      static_cast<const float*>(consts), seed, first_tile,
                                      n_tiles, omt::kQeTerminalTile, n_steps, antithetic,
                                      stream);
}

// out[4]: registers, spill bytes, blocks per SM, block threads of the paths kernel.
int omt_heston_paths_qe_attrs(int* out) {
  return omt::kernel_attrs(omt::heston_qe_kernel<true>, omt::kBlockThreads, out);
}

}  // extern "C"
