// Raw Philox words of the kernels' stream, for holding csrc/philox.cuh
// against ops/philox.stream_words bit for bit; sinf and cosf beside
// sincos_stream_angle at every angle of the stream; the error-string lookup
// the Python wrappers use to report a failed launch.
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

}  // namespace omt

extern "C" {

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
