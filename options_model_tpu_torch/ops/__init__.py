"""Engine selection, the Philox stream, the kernel build and the CUDA kernel wrappers."""
