// One exact resample pass of the -Z zoom for Hopper (sm_90a).
//
// Replaces zoom_pass_pallas (_zoom_mm_kernel) in
// tcforge_tpu/ops/kernels.py, and with it the XLA s8-matmul form that
// is the TPU's default (tcforge_tpu/ops/zoom.py:215-243).  Both exist
// to run the resample on the TPU's matrix unit exactly, by splitting
// the 16.16 weights into byte or digit planes.  On this card the
// product is not tensor-core shaped: each output sample has a band of
// 8-9 contributors (Lanczos3 at 1920->1280 and 1080->720), so the
// dense (new, old) matrix is mostly zeros.  This kernel sums over the
// band only, in int32, which is the reference's own loop (zoom.c
// zoom_process) and exact: 255 * sum|w| < 2^31 is checked on the host
// (ops/zoom.py band_table).
//
//     out = u8(clamp((sum_k px[first + k] * w[k] + 0x8000) >> 16, 0, 255))
//
// What bounds it on this card: device memory bandwidth and load issue.
// Per output it does ~9 multiply-adds on ~9 loaded bytes that mostly
// hit L1/L2, far below the card's integer rate.
//
// Design: one thread per output element; the band table (first index,
// tap count, weights padded to the widest row) comes from global
// memory and stays in cache.  The horizontal pass reads along W from
// one source row per output row; the vertical pass reads its taps with
// stride W and neighbouring threads (neighbouring x) read neighbouring
// bytes, so its loads coalesce.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint8_t finish(int acc) {
  return static_cast<uint8_t>(min(max((acc + 0x8000) >> 16, 0), 255));
}

// src (rows, width) -> dst (rows, newsize): resample along each row.
__global__ void __launch_bounds__(kThreads)
zoom_rows_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst,
                 const int32_t* __restrict__ first, const int32_t* __restrict__ taps,
                 const int32_t* __restrict__ weights, int maxtaps,
                 long long rows, int width, int newsize) {
  const long long o = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (o >= rows * newsize) return;
  const long long row = o / newsize;
  const int i = static_cast<int>(o - row * newsize);
  const uint8_t* s = src + row * width + first[i];
  const int32_t* w = weights + static_cast<long long>(i) * maxtaps;
  const int n = taps[i];
  int acc = 0;
  for (int k = 0; k < n; ++k) acc += static_cast<int>(s[k]) * w[k];
  dst[o] = finish(acc);
}

// src (batch, height, width) -> dst (batch, newsize, width): resample
// along each column.
__global__ void __launch_bounds__(kThreads)
zoom_cols_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst,
                 const int32_t* __restrict__ first, const int32_t* __restrict__ taps,
                 const int32_t* __restrict__ weights, int maxtaps,
                 long long batch, int height, int width, int newsize) {
  const long long o = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long per_image = static_cast<long long>(newsize) * width;
  if (o >= batch * per_image) return;
  const long long b = o / per_image;
  const int r = static_cast<int>(o - b * per_image);
  const int i = r / width;
  const int x = r - i * width;
  const uint8_t* s = src + (b * height + first[i]) * width + x;
  const int32_t* w = weights + static_cast<long long>(i) * maxtaps;
  const int n = taps[i];
  int acc = 0;
  for (int k = 0; k < n; ++k) acc += static_cast<int>(s[static_cast<long long>(k) * width]) * w[k];
  dst[o] = finish(acc);
}

}  // namespace

// src is (batch, height, width) uint8.  along_rows != 0: dst is
// (batch, height, newsize), bands over width; else dst is
// (batch, newsize, width), bands over height.
TC_API int tc_zoom_pass(const uint8_t* src, uint8_t* dst, const int32_t* first,
                        const int32_t* taps, const int32_t* weights, int maxtaps,
                        long long batch, int height, int width, int newsize,
                        int along_rows, cudaStream_t stream) {
  if (along_rows) {
    const long long rows = batch * height;
    zoom_rows_kernel<<<tc_blocks(rows * newsize, kThreads), kThreads, 0, stream>>>(
        src, dst, first, taps, weights, maxtaps, rows, width, newsize);
  } else {
    const long long total = batch * newsize * static_cast<long long>(width);
    zoom_cols_kernel<<<tc_blocks(total, kThreads), kThreads, 0, stream>>>(
        src, dst, first, taps, weights, maxtaps, batch, height, width, newsize);
  }
  return static_cast<int>(cudaGetLastError());
}
