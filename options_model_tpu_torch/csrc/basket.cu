// Correlated multi-asset GBM for Hopper (sm_90a): kernel 27 writes the
// paths, kernel 28 only the terminal values. The port's own kernels: the
// reference simulates in XLA (options_model_tpu/models/multiasset.py:48
// simulate_gbm_basket, :107 gbm_basket_terminal_exact).
//
// One thread owns one slot: an antithetic pair (or one path when antithetic
// is off) and all n assets of it. Per step it makes ceil(n / 4) Philox calls
// on counter (slot, t ceil(n / 4) + a / 4, global tile, 6), asset a's normal
// being Box-Muller output a % 4 of its call (ops/philox.basket_path_draws),
// (box_muller_stream: libdevice's sinf/cosf bits without their Payne-Hanek
// path and its local array, philox.cuh), then correlates them with the
// lower Cholesky factor L:
//   W_a = sum_{b <= a} L[a, b] z_b, over ascending b, each product rounded
//   and then added; acc_a += drift_a + vol_a W_a,
// all with _rn intrinsics, which nvcc never contracts into an FMA. The plain
// version (models/multiasset.gbm_basket_from_normals) sums in the same
// order, so W and the log-states equal it bit for bit given the same
// normals. The mirror path takes -W, which is exact. S = s0 exp(acc).
// The terminal kernel walks the same steps and stores only the last, so on
// the same stream it equals the paths kernel's last row bit for bit.
//
// Layout: paths (n_steps+1, n, n_pad) float32, row 0 the spot; terminal
// (n, n_pad). Each store is coalesced along paths. A debug mode writes the
// log-states acc in the paths layout (row 0 zero) and W (n_steps, n, n_pad)
// instead of S, so that both can be held against the plain version bit for
// bit. The constants (float32) are s0[n], drift[n], vol[n] and L's rows
// packed (row a holds a + 1 entries from a (a + 1) / 2).
//
// Instances: n = 1..8 take the constants by value (kernel parameters, read
// from the constant bank as instruction operands, so they hold no
// registers: held in shared memory, nvcc kept all 42 of n = 7 in registers
// and spilled) and keep z and both log-states in registers (loops fully
// unrolled); the generic instance copies the constants from the card to
// shared memory and keeps its state there too, strided by the block so
// that a thread's entries sit in one bank column, up to kMaxAssets.
#include "kernel_attrs.cuh"
#include "philox.cuh"

namespace omt {
namespace basket {

constexpr uint32_t kStream = 6u;
constexpr int kBlock = 256;
constexpr int kGenericBlock = 64;
constexpr int kMaxAssets = 128;
// What a launch writes: S_T (kernel 28), S paths (kernel 27), or the
// log-states and W (debug).
enum Mode { kTerminal = 0, kPaths = 1, kDebug = 2 };

__host__ __device__ constexpr int n_consts(int n) { return 3 * n + n * (n + 1) / 2; }

// The constants of an instance of N assets, by value.
template <int N>
struct Consts {
  float c[n_consts(N)];
};

inline size_t generic_smem(int n) {
  return sizeof(float) * (static_cast<size_t>(n_consts(n)) + 3u * n * kGenericBlock);
}

__device__ __forceinline__ Words basket_draw(uint32_t slot, uint32_t draw, uint32_t tile,
                                             uint64_t seed) {
  return philox4x32_10(Words{slot, draw, tile, kStream}, static_cast<uint32_t>(seed),
                       static_cast<uint32_t>(seed >> 32));
}

// The slot's geometry: its columns in the output (path and mirror), its
// counter words; false for a thread past the last slot.
struct Slot {
  uint32_t j, global_tile;
  size_t col_a, col_b, n_pad;
};

__device__ __forceinline__ bool slot_of(int first_tile, int n_tiles, int tile, bool antithetic,
                                        Slot& s) {
  const int width = antithetic ? tile / 2 : tile;
  const long long slot = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (slot >= static_cast<long long>(n_tiles) * width) return false;
  const int local_tile = static_cast<int>(slot / width);
  s.j = static_cast<uint32_t>(slot % width);
  s.global_tile = static_cast<uint32_t>(first_tile + local_tile);
  s.n_pad = static_cast<size_t>(n_tiles) * tile;
  s.col_a = static_cast<size_t>(local_tile) * tile + s.j;
  s.col_b = s.col_a + width;
  return true;
}

// The four normals of call c of step t into z[4c .. 4c + 3] (those below n),
// z read and written through zat(i).
template <typename Z>
__device__ __forceinline__ void draw_call(const Slot& s, uint64_t seed, uint32_t draw, int base,
                                          int n, Z zat) {
  const Words w = basket_draw(s.j, draw, s.global_tile, seed);
  float z0, z1;
  box_muller_stream(w.x, w.y, z0, z1);
  zat(base) = z0;
  if (base + 1 < n) zat(base + 1) = z1;
  if (base + 2 < n) {
    box_muller_stream(w.z, w.w, z0, z1);
    zat(base + 2) = z0;
    if (base + 3 < n) zat(base + 3) = z1;
  }
}

// Asset a's correlated increment W_a over ascending b, _rn throughout.
template <typename Z>
__device__ __forceinline__ float correlate(const float* L, int a, Z zat) {
  const float* row = L + a * (a + 1) / 2;
  float W = __fmul_rn(row[0], zat(0));
  for (int b = 1; b <= a; ++b) W = __fadd_rn(W, __fmul_rn(row[b], zat(b)));
  return W;
}

__device__ __forceinline__ float log_step(float acc, float drift, float vol, float W) {
  return __fadd_rn(acc, __fadd_rn(drift, __fmul_rn(vol, W)));
}

__device__ __forceinline__ void load_consts(float* c, const float* __restrict__ consts, int n) {
  for (int i = threadIdx.x; i < n_consts(n); i += blockDim.x) c[i] = consts[i];
  __syncthreads();
}

// The stores of one step t (t = -1: row 0) of asset a: S, or in the debug
// mode acc into out and W into aux.
template <int kMode>
__device__ __forceinline__ void store(float* __restrict__ out, float* __restrict__ aux,
                                      const Slot& s, bool antithetic, int n, int t, int a,
                                      float s0, float x, float xm, float W) {
  if (kMode == kTerminal) {
    out[a * s.n_pad + s.col_a] = __fmul_rn(s0, expf(x));
    if (antithetic) out[a * s.n_pad + s.col_b] = __fmul_rn(s0, expf(xm));
    return;
  }
  const size_t row = (static_cast<size_t>(t + 1) * n + a) * s.n_pad;
  if (kMode == kPaths) {
    out[row + s.col_a] = t < 0 ? s0 : __fmul_rn(s0, expf(x));
    if (antithetic) out[row + s.col_b] = t < 0 ? s0 : __fmul_rn(s0, expf(xm));
    return;
  }
  out[row + s.col_a] = x;
  if (antithetic) out[row + s.col_b] = xm;
  if (t >= 0) {
    const size_t wrow = (static_cast<size_t>(t) * n + a) * s.n_pad;
    aux[wrow + s.col_a] = W;
    if (antithetic) aux[wrow + s.col_b] = -W;
  }
}

// n = N assets in registers, the constants by value.
template <int N, int kMode>
__global__ void __launch_bounds__(kBlock)
basket_kernel(float* __restrict__ out, float* __restrict__ aux, const Consts<N> p,
              uint64_t seed, int first_tile, int n_tiles, int tile, int n_steps,
              bool antithetic) {
  const float* c = p.c;
  Slot s;
  if (!slot_of(first_tile, n_tiles, tile, antithetic, s)) return;
  const float* s0 = c;
  const float* drift = c + N;
  const float* vol = c + 2 * N;
  const float* L = c + 3 * N;
  constexpr int kCalls = (N + 3) / 4;
  // z padded to whole calls: every index is a constant after unrolling, and
  // the padding is written and never read.
  float z[4 * kCalls], acc[N], accm[N];
#pragma unroll
  for (int a = 0; a < N; ++a) {
    acc[a] = 0.0f;
    accm[a] = 0.0f;
    if (kMode != kTerminal) store<kMode>(out, aux, s, antithetic, N, -1, a, s0[a], 0.0f, 0.0f,
                                         0.0f);
  }
  for (int t = 0; t < n_steps; ++t) {
#pragma unroll
    for (int k = 0; k < kCalls; ++k) {
      const Words w = basket_draw(s.j, static_cast<uint32_t>(t * kCalls + k), s.global_tile,
                                  seed);
      box_muller_stream(w.x, w.y, z[4 * k], z[4 * k + 1]);
      if (4 * k + 2 < N) box_muller_stream(w.z, w.w, z[4 * k + 2], z[4 * k + 3]);
    }
#pragma unroll
    for (int a = 0; a < N; ++a) {
      float W = __fmul_rn(L[a * (a + 1) / 2], z[0]);
#pragma unroll
      for (int b = 1; b <= a; ++b) W = __fadd_rn(W, __fmul_rn(L[a * (a + 1) / 2 + b], z[b]));
      acc[a] = log_step(acc[a], drift[a], vol[a], W);
      if (antithetic) accm[a] = log_step(accm[a], drift[a], vol[a], -W);
      if (kMode != kTerminal) store<kMode>(out, aux, s, antithetic, N, t, a, s0[a], acc[a],
                                           accm[a], W);
    }
  }
  if (kMode == kTerminal) {
#pragma unroll
    for (int a = 0; a < N; ++a)
      store<kMode>(out, aux, s, antithetic, N, n_steps - 1, a, s0[a], acc[a], accm[a], 0.0f);
  }
}

// Any n up to kMaxAssets: the constants, then z, acc and the mirror's acc
// of every thread in dynamic shared memory (entry i of a thread at i B + tid).
template <int kMode>
__global__ void __launch_bounds__(kGenericBlock)
basket_generic_kernel(float* __restrict__ out, float* __restrict__ aux,
                      const float* __restrict__ consts, uint64_t seed, int first_tile,
                      int n_tiles, int tile, int n_steps, int n, bool antithetic) {
  extern __shared__ float smem[];
  float* c = smem;
  load_consts(c, consts, n);
  Slot s;
  if (!slot_of(first_tile, n_tiles, tile, antithetic, s)) return;
  const float* s0 = c;
  const float* drift = c + n;
  const float* vol = c + 2 * n;
  const float* L = c + 3 * n;
  const int B = blockDim.x;
  float* z = smem + n_consts(n) + threadIdx.x;
  float* acc = z + n * B;
  float* accm = acc + n * B;
  auto zat = [&](int i) -> float& { return z[i * B]; };
  const int calls = (n + 3) / 4;
  for (int a = 0; a < n; ++a) {
    acc[a * B] = 0.0f;
    accm[a * B] = 0.0f;
    if (kMode != kTerminal) store<kMode>(out, aux, s, antithetic, n, -1, a, s0[a], 0.0f, 0.0f,
                                         0.0f);
  }
  for (int t = 0; t < n_steps; ++t) {
    for (int k = 0; k < calls; ++k)
      draw_call(s, seed, static_cast<uint32_t>(t * calls + k), 4 * k, n, zat);
    for (int a = 0; a < n; ++a) {
      const float W = correlate(L, a, zat);
      const float x = log_step(acc[a * B], drift[a], vol[a], W);
      acc[a * B] = x;
      const float xm = antithetic ? log_step(accm[a * B], drift[a], vol[a], -W) : 0.0f;
      accm[a * B] = xm;
      if (kMode != kTerminal) store<kMode>(out, aux, s, antithetic, n, t, a, s0[a], x, xm, W);
    }
  }
  if (kMode == kTerminal) {
    for (int a = 0; a < n; ++a)
      store<kMode>(out, aux, s, antithetic, n, n_steps - 1, a, s0[a], acc[a * B], accm[a * B],
                   0.0f);
  }
}

template <int N, int kMode>
int launch_fixed(float* out, float* aux, const float* host_consts, uint64_t seed,
                 int first_tile, int n_tiles, int tile, int n_steps, bool antithetic,
                 long long n_slots, cudaStream_t st) {
  Consts<N> p;
  for (int i = 0; i < n_consts(N); ++i) p.c[i] = host_consts[i];
  const unsigned grid = static_cast<unsigned>((n_slots + kBlock - 1) / kBlock);
  basket_kernel<N, kMode><<<grid, kBlock, 0, st>>>(out, aux, p, seed, first_tile, n_tiles,
                                                    tile, n_steps, antithetic);
  return static_cast<int>(cudaGetLastError());
}

template <int kMode>
int prepare_generic(int n, size_t& smem) {
  if (n < 1 || n > kMaxAssets) return static_cast<int>(cudaErrorInvalidValue);
  smem = generic_smem(n);
  return static_cast<int>(cudaFuncSetAttribute(basket_generic_kernel<kMode>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem)));
}

#define OMT_BASKET_CASES(ACTION) \
  ACTION(1) ACTION(2) ACTION(3) ACTION(4) ACTION(5) ACTION(6) ACTION(7) ACTION(8)

template <int kMode>
int launch(float* out, float* aux, const float* host_consts, const float* consts,
           uint64_t seed, int first_tile, int n_tiles, int tile, int n_steps, int n,
           int antithetic, void* stream) {
  const bool anti = antithetic != 0;
  const long long n_slots = static_cast<long long>(n_tiles) * (anti ? tile / 2 : tile);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (n) {
#define OMT_BASKET_LAUNCH(K) \
  case K: \
    return launch_fixed<K, kMode>(out, aux, host_consts, seed, first_tile, n_tiles, tile, \
                                  n_steps, anti, n_slots, st);
    OMT_BASKET_CASES(OMT_BASKET_LAUNCH)
#undef OMT_BASKET_LAUNCH
    default:
      break;
  }
  size_t smem = 0;
  const int err = prepare_generic<kMode>(n, smem);
  if (err != 0) return err;
  const unsigned grid = static_cast<unsigned>((n_slots + kGenericBlock - 1) / kGenericBlock);
  basket_generic_kernel<kMode><<<grid, kGenericBlock, smem, st>>>(
      out, aux, consts, seed, first_tile, n_tiles, tile, n_steps, n, anti);
  return static_cast<int>(cudaGetLastError());
}

template <int kMode>
int attrs(int n, int* out) {
  switch (n) {
#define OMT_BASKET_ATTR(K) \
  case K: \
    return kernel_attrs(basket_kernel<K, kMode>, kBlock, out);
    OMT_BASKET_CASES(OMT_BASKET_ATTR)
#undef OMT_BASKET_ATTR
    default:
      break;
  }
  size_t smem = 0;
  const int err = prepare_generic<kMode>(n, smem);
  if (err != 0) return err;
  return kernel_attrs(basket_generic_kernel<kMode>, kGenericBlock, out, smem);
}

}  // namespace basket
}  // namespace omt

extern "C" {

// out: device float32, (n_steps+1, n_assets, n_tiles*tile) for mode 1 (S
// paths, kernel 27) and 2 (the log-states, debug), (n_assets, n_tiles*tile)
// for mode 0 (S_T, kernel 28); aux: W (n_steps, n_assets, n_tiles*tile) in
// mode 2, else unused; host_consts: host float32, s0, drift, vol and L's
// packed rows (3 n + n (n + 1) / 2), read by value up to 8 assets; consts:
// the same on the card, read by the generic instance (9 assets or more;
// may be null below).
int omt_basket(void* out, void* aux, const void* host_consts, const void* consts,
               uint64_t seed, int first_tile, int n_tiles, int tile, int n_steps, int n_assets,
               int antithetic, int mode, void* stream) {
  using namespace omt::basket;
  float* o = static_cast<float*>(out);
  float* x = static_cast<float*>(aux);
  const float* h = static_cast<const float*>(host_consts);
  const float* c = static_cast<const float*>(consts);
  switch (mode) {
    case kTerminal:
      return launch<kTerminal>(o, x, h, c, seed, first_tile, n_tiles, tile, n_steps, n_assets,
                               antithetic, stream);
    case kPaths:
      return launch<kPaths>(o, x, h, c, seed, first_tile, n_tiles, tile, n_steps, n_assets,
                            antithetic, stream);
    case kDebug:
      return launch<kDebug>(o, x, h, c, seed, first_tile, n_tiles, tile, n_steps, n_assets,
                            antithetic, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The instance a launch at n_assets and mode 0 or 1 runs: registers per
// thread, local bytes, resident blocks per SM, block threads
// (csrc/kernel_attrs.cuh).
int omt_basket_attrs(int n_assets, int mode, int* out) {
  using namespace omt::basket;
  return mode == kPaths ? attrs<kPaths>(n_assets, out) : attrs<kTerminal>(n_assets, out);
}

}  // extern "C"
