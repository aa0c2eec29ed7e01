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

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// 16-byte copies from device to shared memory that bypass L1, in
// groups: issue, commit the group, wait until at most N groups pend.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
