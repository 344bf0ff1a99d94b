// Registers, spills and occupancy of a built kernel, read on the card with
// cudaFuncGetAttributes and cudaOccupancyMaxActiveBlocksPerMultiprocessor,
// so a timing can be printed beside the numbers that explain it.
#pragma once

#include <cuda_runtime.h>

namespace omt {

// out: registers per thread, local (spill) bytes per thread, resident
// blocks per SM at block_threads, block_threads.
template <typename Kernel>
int kernel_attrs(Kernel kernel, int block_threads, int* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, block_threads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = blocks;
  out[3] = block_threads;
  return 0;
}

}  // namespace omt
