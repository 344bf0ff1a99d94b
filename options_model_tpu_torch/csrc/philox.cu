// Raw Philox words of the kernels' stream, for holding csrc/philox.cuh
// against ops/philox.stream_words bit for bit; sinf and cosf beside
// sincos_stream_angle at every angle of the stream; the normals of the
// local-vol stream for the bare sigma_fn route (path_normals_kernel); the
// error-string lookup the Python wrappers use to report a failed launch.
#include "hopper_fast.cuh"
#include "philox.cuh"

namespace omt {

__global__ void __launch_bounds__(kBlockThreads)
philox_words_kernel(uint32_t* __restrict__ out, uint64_t seed, int first_tile, int n_tiles,
                    int width, int n_draws, uint32_t word3) {
  const long long n_slots = static_cast<long long>(n_tiles) * width;
  const long long slot = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (slot >= n_slots) return;
  const uint32_t j = static_cast<uint32_t>(slot % width);
  const uint32_t global_tile = static_cast<uint32_t>(first_tile + slot / width);
  for (int k = 0; k < n_draws; ++k) {
    const Words w = philox4x32_10(Words{j, static_cast<uint32_t>(k), global_tile, word3},
                                  static_cast<uint32_t>(seed), static_cast<uint32_t>(seed >> 32));
    uint32_t* row = out + static_cast<size_t>(4 * k) * n_slots + slot;
    row[0] = w.x;
    row[n_slots] = w.y;
    row[2 * n_slots] = w.z;
    row[3 * n_slots] = w.w;
  }
}

// Every angle float(2 pi) u2 of the stream's uniforms u2 = i 2^-23.
constexpr int kAngles = 1 << 23;

// out: (4, kAngles) rows sinf, cosf and sincos_stream_angle's sine and cosine.
__global__ void __launch_bounds__(kBlockThreads) sincos_check_kernel(float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= kAngles) return;
  const float x = static_cast<float>(6.283185307179586) *
                  uniform_from_bits(static_cast<uint32_t>(i) << 9);
  float s, c;
  sincos_stream_angle(x, s, c);
  out[i] = sinf(x);
  out[kAngles + i] = cosf(x);
  out[2 * kAngles + i] = s;
  out[3 * kAngles + i] = c;
}

// The normals of the GBM / local-vol stream in path order, as
// ops/philox.path_normals lays them out: (n_steps, n_tiles * tile), normal t
// of slot j of global tile g from Philox call (j, t / 4, g, 0), the path
// j + tile / 2 of each tile the negated mirror when antithetic. It replaces
// no TPU kernel: it is the port's own, for the bare sigma_fn route of
// models/localvol.py, whose time loop evaluates a network between steps and
// so cannot run inside one kernel. Its draws are the ones kernels 7 and 8
// (terminal.cu, localvol_paths.cu) make inside their loops: the keyed
// Philox and box_muller_fast of hopper_fast.cuh, the same four steps a call
// (lv_walk), so the bare route and the table route walk the same normals
// bit for bit.
//
// Bound: the bytes written, 4 a normal, nothing read. A Philox call's ~40
// integer instructions serve 8 normals (32 bytes) of a pair, or 4 without
// antithetics: at the card's rates a quarter (a half) of their store time.
// Design: one thread a (slot, call) on a grid of (slots, calls); a warp
// writes 32 consecutive floats of each of its 4 rows (8 with the mirror)
// with the streaming store hint, since nothing here reads them back.
__global__ void __launch_bounds__(kBlockThreads)
path_normals_kernel(float* __restrict__ out, const __grid_constant__ fast::PhiloxKeys keys,
                    int first_tile, int n_tiles, int width, int n_steps, int antithetic) {
  const long long n_slots = static_cast<long long>(n_tiles) * width;
  const long long slot = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (slot >= n_slots) return;
  const int d = blockIdx.y;
  const uint32_t j = static_cast<uint32_t>(slot % width);
  const long long tile = slot / width;
  const Words w = fast::philox_keyed(
      Words{j, static_cast<uint32_t>(d), static_cast<uint32_t>(first_tile + tile), 0u}, keys);
  float z[4];
  fast::box_muller_fast(w.x, w.y, z[0], z[1]);
  fast::box_muller_fast(w.z, w.w, z[2], z[3]);
  const long long n_paths = antithetic ? 2 * n_slots : n_slots;
  const long long col = antithetic ? tile * 2 * width + j : slot;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int t = 4 * d + q;
    if (t >= n_steps) break;
    float* row = out + static_cast<size_t>(t) * n_paths + col;
    __stcs(row, z[q]);
    if (antithetic) __stcs(row + width, -z[q]);
  }
}

}  // namespace omt

extern "C" {

// out: device (n_steps, n_tiles * tile) float32 (path_normals_kernel); width
// = tile / 2 when antithetic, else tile.
int omt_path_normals(void* out, uint64_t seed, int first_tile, int n_tiles, int tile,
                     int n_steps, int antithetic, void* stream) {
  const int width = antithetic ? tile / 2 : tile;
  const long long n_slots = static_cast<long long>(n_tiles) * width;
  const dim3 grid(omt::grid_for(n_slots), static_cast<unsigned int>((n_steps + 3) / 4));
  omt::path_normals_kernel<<<grid, omt::kBlockThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), omt::fast::philox_keys(seed), first_tile, n_tiles, width,
      n_steps, antithetic);
  return static_cast<int>(cudaGetLastError());
}

// out: device (4, 2^23) float32 (sincos_check_kernel).
int omt_sincos_check(void* out, void* stream) {
  omt::sincos_check_kernel<<<omt::grid_for(omt::kAngles), omt::kBlockThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// out: device (n_draws, 4, n_tiles*width) 32-bit words; counter word 3 = word3
// (0 for the path streams, 1 the jump overlay's, 2 the dual's).
int omt_philox_words(void* out, uint64_t seed, int first_tile, int n_tiles, int width,
                     int n_draws, int word3, void* stream) {
  const long long n_slots = static_cast<long long>(n_tiles) * width;
  omt::philox_words_kernel<<<omt::grid_for(n_slots), omt::kBlockThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(out), seed, first_tile, n_tiles, width, n_draws,
      static_cast<uint32_t>(word3));
  return static_cast<int>(cudaGetLastError());
}

const char* omt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
