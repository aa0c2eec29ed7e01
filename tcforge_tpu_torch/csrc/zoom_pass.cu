// One exact resample pass of the -Z zoom for Hopper (sm_90a).
//
// Replaces zoom_pass_pallas (tcforge_tpu/ops/kernels.py:859,
// _zoom_mm_kernel), and with it the XLA s8-matmul form that is the
// TPU's default (tcforge_tpu/ops/zoom.py:215-243).  Both exist to run
// the resample on the TPU's matrix unit exactly, by splitting the 16.16
// weights into byte or digit planes.  On this card the product is not
// tensor-core shaped: each output sample has a band of 8-9 contributors
// (Lanczos3 at 1920->1280 and 1080->720), so the dense (new, old)
// matrix is mostly zeros.  This kernel sums over the band only, in
// int32, which is the reference's own loop (zoom.c zoom_process) and
// exact: 255 * sum|w| < 2^31 is checked on the host (ops/zoom.py
// band_table).
//
//     out = u8(clamp((sum_k px[first + k] * w[k] + 0x8000) >> 16, 0, 255))
//
// What bounds it: bytes.  The main path's six passes per 16-frame batch
// move 138 MB (0.041 ms at 3.35 TB/s) and do about 0.5 G int32
// multiply-adds (0.03 ms).  The first design (one thread per output, a
// separate 1-byte and 4-byte load per tap, a data-dependent tap loop,
// 64-bit index division) was load-issue-bound at 0.424 ms per batch on
// an NVIDIA H100 80GB HBM3 at 700.00 W, about a tenth of its bound.
// This design takes 0.147 ms per batch on the same card and limit, timed
// the same way (chip_smoke.py phase 3), 28 % of the bound: 0.054 ms for
// the luma rows pass (bound 0.017) and 0.032 ms for the luma columns
// pass (bound 0.011).
// The rows pass issues one shared byte load per multiply-add, but
// loading words and extracting the bytes ran no faster, so those loads
// are not what holds it.  A dense fp32 torch.matmul against the
// contrib matrix takes 3.36 ms for the same six passes.
//
// Design.  The tap loop runs to a fixed bound K (2, 4, 6, 9, 12 or 16:
// the smallest that holds the band's widest row) over weights padded
// with zeros, so it unrolls; a band wider than 16 taps (sinc8 at large
// ratios) runs the same kernels with K = 0, a loop over each row's own
// tap count with weights and pixels read from the cache.  Index math is
// 32-bit from blockIdx; only plane offsets are 64-bit.
//
// Rows pass (along W): a block owns 32 rows and a strip of 128 outputs
// (row blocks on grid.x, so any batch of rows launches).
// Each warp stages its 8 rows' source span (the strip's lowest first
// index, from ops/zoom.py strip_spans, to its highest first + K) into
// shared memory with 16-byte copies, zero past the row's end.  Lane l
// computes outputs l, l+32, l+64 and l+96 of the strip: it keeps their
// 4 x K weights and first indices in registers for all 8 rows, and its
// taps are byte loads from shared memory at an immediate offset.  Lanes
// on neighbouring outputs read neighbouring bytes, so a warp's tap load
// falls in a dozen words (no bank conflict) and each byte store of a
// warp fills one 32-byte sector.
//
// Columns pass (along H): a block owns 32 output rows and 128 columns;
// each thread owns 4 adjacent columns with one int32 accumulator each.
// Per tap it makes one 4-byte load of the source row, coalesced across
// the warp (a 128-byte line), with the output row's weight broadcast
// from shared memory, and stores the 4 results as one word.  A warp
// walks 8 consecutive output rows, which share most of their source
// rows, so those loads hit L1.
//
// Widths that are not a multiple of 16 (rows pass) or 4 (columns pass),
// or unaligned planes, take the same kernels with element-wise staging,
// loads and stores.  An IMMA/DP4A form with the weights split into
// bytes is a later option; it is not built.
#include "common.cuh"

namespace {

constexpr int kStrip = 128;       // rows pass: outputs per block
constexpr int kBlockRows = 32;    // rows pass: source rows per block
constexpr int kWarps = 4;
constexpr int kSpanMax = 512;     // rows pass: staged bytes per row
constexpr int kColsPer = 4;       // columns pass: columns per thread
constexpr int kOutRows = 32;      // columns pass: output rows per block

__device__ __forceinline__ uint8_t finish(int acc) {
  return static_cast<uint8_t>(min(max((acc + 0x8000) >> 16, 0), 255));
}

__host__ __device__ __forceinline__ bool aligned(const void* p, int bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// src (rows, width) -> dst (rows, newsize): resample along each row.
// Strip s holds outputs [128 s, 128 s + 128) whose taps lie in
// [lo[s], lo[s] + span); K > 0 stages that span (plus K - 1 bytes of
// padded taps), K == 0 reads the source rows from the cache.
template <int K>
__global__ void __launch_bounds__(32 * kWarps)
zoom_rows_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst,
                 const int32_t* __restrict__ first, const int32_t* __restrict__ taps,
                 const int32_t* __restrict__ weights, int maxtaps,
                 const int32_t* __restrict__ lo_g, int span, int rows, int width,
                 int newsize, bool vec) {
  constexpr int kRowsPerWarp = kBlockRows / kWarps;
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int row0 = blockIdx.x * kBlockRows;
  const int j0 = blockIdx.y * kStrip;

  if constexpr (K == 0) {
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int row = row0 + warp + kWarps * r;
      if (row >= rows) break;
      const uint8_t* s = src + static_cast<long long>(row) * width;
      for (int m = 0; m < kStrip / 32; ++m) {
        const int j = j0 + lane + 32 * m;
        if (j >= newsize) break;
        const uint8_t* p = s + first[j];
        const int32_t* w = weights + static_cast<long long>(j) * maxtaps;
        const int n = taps[j];
        int acc = 0;
        for (int k = 0; k < n; ++k) acc += static_cast<int>(p[k]) * w[k];
        dst[static_cast<long long>(row) * newsize + j] = finish(acc);
      }
    }
  } else {
    __shared__ __align__(16) uint8_t stage[kBlockRows][kSpanMax];
    const int lo = lo_g[blockIdx.y];
    const int base = vec ? (lo & ~15) : lo;
    const int need = lo - base + span + K - 1;

    // each warp stages the 8 rows it computes
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int lr = warp + kWarps * r;
      const int row = row0 + lr;
      if (row >= rows) break;
      const uint8_t* s = src + static_cast<long long>(row) * width;
      if (vec) {
        for (int c = lane; c * 16 < need; c += 32) {
          const int g = base + 16 * c;
          *reinterpret_cast<uint4*>(&stage[lr][16 * c]) =
              g < width ? *reinterpret_cast<const uint4*>(s + g) : make_uint4(0, 0, 0, 0);
        }
      } else {
        for (int b = lane; b < need; b += 32) {
          const int g = base + b;
          stage[lr][b] = g < width ? s[g] : 0;
        }
      }
    }

    int w[kStrip / 32][K];
    int off[kStrip / 32];
#pragma unroll
    for (int m = 0; m < kStrip / 32; ++m) {
      const int j = j0 + lane + 32 * m;
      off[m] = (j < newsize ? first[j] : lo) - base;
#pragma unroll
      for (int k = 0; k < K; ++k)
        w[m][k] = j < newsize && k < maxtaps ? weights[static_cast<long long>(j) * maxtaps + k] : 0;
    }
    __syncwarp();

    // a strip inside the plane stores unconditionally, so the four
    // outputs' taps interleave instead of each waiting in its own branch
    const bool full = j0 + kStrip <= newsize;
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int lr = warp + kWarps * r;
      const int row = row0 + lr;
      if (row >= rows) break;
      int acc[kStrip / 32];
#pragma unroll
      for (int m = 0; m < kStrip / 32; ++m) {
        const uint8_t* p = &stage[lr][off[m]];
        acc[m] = 0;
#pragma unroll
        for (int k = 0; k < K; ++k) acc[m] += static_cast<int>(p[k]) * w[m][k];
      }
      uint8_t* d = dst + static_cast<long long>(row) * newsize + j0 + lane;
      if (full) {
#pragma unroll
        for (int m = 0; m < kStrip / 32; ++m) d[32 * m] = finish(acc[m]);
      } else {
#pragma unroll
        for (int m = 0; m < kStrip / 32; ++m)
          if (j0 + lane + 32 * m < newsize) d[32 * m] = finish(acc[m]);
      }
    }
  }
}

__device__ __forceinline__ uint32_t load4(const uint8_t* __restrict__ p, int valid, bool vec) {
  if (vec) return *reinterpret_cast<const uint32_t*>(p);
  uint32_t v = 0;
#pragma unroll
  for (int c = 0; c < kColsPer; ++c)
    if (c < valid) v |= static_cast<uint32_t>(p[c]) << (8 * c);
  return v;
}

__device__ __forceinline__ void mac4(int (&acc)[kColsPer], uint32_t px, int w) {
#pragma unroll
  for (int c = 0; c < kColsPer; ++c)
    acc[c] += static_cast<int>(__byte_perm(px, 0, 0x4440 + c)) * w;
}

// src (batch, height, width) -> dst (batch, newsize, width): resample
// along each column.  Grid (column blocks, output-row blocks, batch).
template <int K>
__global__ void __launch_bounds__(32 * kWarps)
zoom_cols_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst,
                 const int32_t* __restrict__ first, const int32_t* __restrict__ taps,
                 const int32_t* __restrict__ weights, int maxtaps, int height,
                 int width, int newsize, bool vec) {
  constexpr int kRowsPerWarp = kOutRows / kWarps;
  __shared__ int wsm[kOutRows][K > 0 ? K : 1];
  __shared__ int fsm[kOutRows];
  const int tid = threadIdx.y * 32 + threadIdx.x;
  const int i0 = blockIdx.y * kOutRows;
  if constexpr (K > 0) {
    for (int e = tid; e < kOutRows * K; e += 32 * kWarps) {
      const int r = e / K, k = e % K, i = i0 + r;
      wsm[r][k] = i < newsize && k < maxtaps ? weights[static_cast<long long>(i) * maxtaps + k] : 0;
    }
  }
  if (tid < kOutRows) fsm[tid] = i0 + tid < newsize ? first[i0 + tid] : 0;
  __syncthreads();

  const int x0 = (blockIdx.x * 32 + threadIdx.x) * kColsPer;
  if (x0 >= width) return;
  const int valid = width - x0;
  const uint8_t* col = src + static_cast<long long>(blockIdx.z) * height * width + x0;
  uint8_t* out = dst + static_cast<long long>(blockIdx.z) * newsize * width + x0;
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int r = threadIdx.y * kRowsPerWarp + rr;
    const int i = i0 + r;
    if (i >= newsize) break;
    const int f = fsm[r];
    int acc[kColsPer] = {};
    // offsets inside one image are 32-bit (height * width < 2^31)
    if constexpr (K > 0) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        // padded taps weigh 0; the clamp only keeps their row inside
        const int y = min(f + k, height - 1);
        mac4(acc, load4(col + y * width, valid, vec), wsm[r][k]);
      }
    } else {
      const int32_t* w = weights + static_cast<long long>(i) * maxtaps;
      const int n = taps[i];
      for (int k = 0; k < n; ++k) mac4(acc, load4(col + (f + k) * width, valid, vec), w[k]);
    }
    uint8_t* o = out + i * width;
    if (vec) {
      uint32_t packed = 0;
#pragma unroll
      for (int c = 0; c < kColsPer; ++c) packed |= static_cast<uint32_t>(finish(acc[c])) << (8 * c);
      *reinterpret_cast<uint32_t*>(o) = packed;
    } else {
#pragma unroll
      for (int c = 0; c < kColsPer; ++c)
        if (c < valid) o[c] = finish(acc[c]);
    }
  }
}

struct Args {
  const uint8_t* src;
  uint8_t* dst;
  const int32_t* first;
  const int32_t* taps;
  const int32_t* weights;
  int maxtaps;
  const int32_t* lo;
  int span;
  int batch, height, width, newsize;
  cudaStream_t stream;
};

template <int K>
int launch_rows(const Args& a) {
  const int rows = a.batch * a.height;
  const bool vec = aligned(a.src, 16) && a.width % 16 == 0;
  // row blocks on x, which has no 65535 limit; strips on y
  const dim3 grid(tc_blocks(rows, kBlockRows), tc_blocks(a.newsize, kStrip));
  zoom_rows_kernel<K><<<grid, dim3(32, kWarps), 0, a.stream>>>(
      a.src, a.dst, a.first, a.taps, a.weights, a.maxtaps, a.lo, a.span, rows, a.width,
      a.newsize, vec);
  return static_cast<int>(cudaGetLastError());
}

template <int K>
int launch_cols(const Args& a) {
  const bool vec = aligned(a.src, 4) && aligned(a.dst, 4) && a.width % 4 == 0;
  const dim3 grid(tc_blocks(tc_blocks(a.width, kColsPer), 32), tc_blocks(a.newsize, kOutRows),
                  a.batch);
  zoom_cols_kernel<K><<<grid, dim3(32, kWarps), 0, a.stream>>>(
      a.src, a.dst, a.first, a.taps, a.weights, a.maxtaps, a.height, a.width, a.newsize, vec);
  return static_cast<int>(cudaGetLastError());
}

template <int K>
int launch(const Args& a, bool along_rows) {
  return along_rows ? launch_rows<K>(a) : launch_cols<K>(a);
}

}  // namespace

// src is (batch, height, width) uint8.  along_rows != 0: dst is
// (batch, height, newsize), bands over width; else dst is
// (batch, newsize, width), bands over height.  lo holds, per strip of
// `strip` outputs, the lowest first index, and span the widest
// max(first + taps) - lo over the strips (ops/zoom.py strip_spans);
// strip must be this kernel's.
TC_API int tc_zoom_pass(const uint8_t* src, uint8_t* dst, const int32_t* first,
                        const int32_t* taps, const int32_t* weights, int maxtaps,
                        const int32_t* lo, int span, int strip, long long batch,
                        long long height, long long width, long long newsize,
                        int along_rows, cudaStream_t stream) {
  if (strip != kStrip || batch > 65535 || (newsize + kStrip - 1) / kStrip > 65535 ||
      (newsize + kOutRows - 1) / kOutRows > 65535 || batch * height > INT32_MAX ||
      batch * newsize > INT32_MAX || height * width > INT32_MAX || newsize * width > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{src, dst, first, taps, weights, maxtaps, lo, span,
               static_cast<int>(batch), static_cast<int>(height), static_cast<int>(width),
               static_cast<int>(newsize), stream};
  const bool rows = along_rows != 0;
  // a staged rows pass needs the span, the padded taps and the
  // alignment slack inside kSpanMax
  const bool staged = !rows || span + 2 * 16 + 16 <= kSpanMax;
  if (staged && maxtaps <= 2) return launch<2>(a, rows);
  if (staged && maxtaps <= 4) return launch<4>(a, rows);
  if (staged && maxtaps <= 6) return launch<6>(a, rows);
  if (staged && maxtaps <= 9) return launch<9>(a, rows);
  if (staged && maxtaps <= 12) return launch<12>(a, rows);
  if (staged && maxtaps <= 16) return launch<16>(a, rows);
  return launch<0>(a, rows);
}
