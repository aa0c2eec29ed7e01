// Shared by the port's CUDA sources.  Each source builds into its own
// shared library with a plain C interface (ops/_build.py), and each C
// entry point returns cudaGetLastError() after its launch, so the
// Python wrapper raises on a launch the card refused.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define TC_API extern "C" __attribute__((visibility("default")))

// Text of a CUDA error code returned by an entry point.
TC_API const char* tc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

static inline unsigned tc_blocks(long long items, int threads) {
  return static_cast<unsigned>((items + threads - 1) / threads);
}
