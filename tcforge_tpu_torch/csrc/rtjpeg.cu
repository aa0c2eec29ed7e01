// RTjpeg (the NuppelVideo intra codec) block transforms for Hopper
// (sm_90a): the pixels of the port's nuv import module and nuvrtj encoder
// (io/rtjcodec.py); the byte coder is the host's (csrc/rtjpeg_host.cpp).
//
// Not TPU kernels: the JAX package's RTjpeg is numpy (tcforge_tpu/io/
// rtjpeg.py, a port of the reference's RTjpegN.c portable branch).  The
// blocks of a frame are in stream order: per 16x16 macroblock (raster
// order) Y00 Y01 Y10 Y11, U, V; a frame is 4:2:0 of a multiple of 16.
//
// tc_rtjpeg_fdct_quant: one block a group of 8 threads (32 a CTA of 256).
//   Thread r runs pass 1 of RTjpeg_dctY (rtjpeg.fdct_blocks) on row r of
//   the block's samples at 2^8 scale into shared memory, then pass 2 on
//   column r with DESCALE10 / DESCALE20 (each wrapped to int16 as the
//   reference's int16 stores do), then RTjpeg_quant: (c * q + 32767) >> 16
//   with the luma or chroma quantizer (AAN scales folded in), wrapped to
//   int16; the block leaves in natural order through shared memory, a row
//   a thread.  Bound: bytes.
// tc_rtjpeg_idct: the same grouping.  Thread c runs pass 1 of RTjpeg_idct
//   (rtjpeg.idct_blocks: MULTIPLY (v * c + 128) >> 8) on coefficient
//   column c, then pass 2 on row c with DESCALE (x + 4) >> 3 wrapped to
//   int16 and the range limit 16..235, and stores the row (8 bytes) into
//   its plane.  64-bit integers throughout, as numpy's int64.  Bound:
//   bytes (int32 coefficients in, a byte a sample out).

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerCta = kThreads / 8;

constexpr long long FIX_0_382683433 = 98;
constexpr long long FIX_0_541196100 = 139;
constexpr long long FIX_0_707106781 = 181;
constexpr long long FIX_1_306562965 = 334;
constexpr long long FIX_1_082392200 = 277;
constexpr long long FIX_1_414213562 = 362;
constexpr long long FIX_1_847759065 = 473;
constexpr long long FIX_2_613125930 = 669;

struct Geometry {
  int width, height;  // the Y plane; U and V are half each way
  int mbw, nb;        // macroblocks across; blocks a frame
};

// a block's plane (0 Y, 1 U, 2 V) and its top-left sample's offset in
// frame f of that plane
__device__ __forceinline__ int block_at(const Geometry& g, long long gb, long long* off) {
  const long long f = gb / g.nb;
  const int k = static_cast<int>(gb - f * g.nb);
  const int mb = k / 6, b = k - 6 * mb;
  const int mby = mb / g.mbw, mbx = mb - mby * g.mbw;
  if (b < 4) {
    const long long size = static_cast<long long>(g.width) * g.height;
    *off = f * size + static_cast<long long>(mby * 16 + (b >> 1) * 8) * g.width + mbx * 16 +
           (b & 1) * 8;
    return 0;
  }
  const int cw = g.width / 2;
  const long long size = static_cast<long long>(cw) * (g.height / 2);
  *off = f * size + static_cast<long long>(mby * 8) * cw + mbx * 8;
  return b - 3;
}

__device__ __forceinline__ long long as16(long long x) {
  return static_cast<long long>(static_cast<int16_t>(static_cast<uint16_t>(x & 0xFFFF)));
}

struct FdctArgs {
  const uint8_t* planes[3];
  const long long* qt;  // (2, 64): luma, chroma
  int16_t* out;         // (nblocks, 64) natural order
  long long nblocks;
  Geometry g;
};

__global__ void __launch_bounds__(kThreads) rtjpeg_fdct_kernel(FdctArgs a) {
  __shared__ long long ws[kBlocksPerCta][8][9];
  __shared__ __align__(16) int16_t res[kBlocksPerCta][8][8];
  const int lb = threadIdx.x >> 3, r = threadIdx.x & 7;
  const long long gb = static_cast<long long>(blockIdx.x) * kBlocksPerCta + lb;
  const bool live = gb < a.nblocks;
  int plane = 0;
  if (live) {
    long long off;
    plane = block_at(a.g, gb, &off);
    const int w = plane == 0 ? a.g.width : a.g.width / 2;
    const uint8_t* p = a.planes[plane] + off + static_cast<long long>(r) * w;
    long long b[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) b[i] = p[i];
    const long long t0 = b[0] + b[7], t7 = b[0] - b[7];
    const long long t1 = b[1] + b[6], t6 = b[1] - b[6];
    const long long t2 = b[2] + b[5], t5 = b[2] - b[5];
    const long long t3 = b[3] + b[4], t4 = b[3] - b[4];
    long long t10 = t0 + t3, t13 = t0 - t3, t11 = t1 + t2, t12 = t1 - t2;
    ws[lb][r][0] = (t10 + t11) * 256;
    ws[lb][r][4] = (t10 - t11) * 256;
    const long long z1 = (t12 + t13) * FIX_0_707106781;
    ws[lb][r][2] = t13 * 256 + z1;
    ws[lb][r][6] = t13 * 256 - z1;
    t10 = t4 + t5;
    t11 = t5 + t6;
    t12 = t6 + t7;
    const long long z5 = (t10 - t12) * FIX_0_382683433;
    const long long z2 = t10 * FIX_0_541196100 + z5;
    const long long z4 = t12 * FIX_1_306562965 + z5;
    const long long z3 = t11 * FIX_0_707106781;
    const long long z11 = t7 * 256 + z3, z13 = t7 * 256 - z3;
    ws[lb][r][5] = z13 + z2;
    ws[lb][r][3] = z13 - z2;
    ws[lb][r][1] = z11 + z4;
    ws[lb][r][7] = z11 - z4;
  }
  __syncthreads();
  if (live) {
    const int c = r;
    long long w[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) w[i] = ws[lb][i][c];
    const long long t0 = w[0] + w[7], t7 = w[0] - w[7];
    const long long t1 = w[1] + w[6], t6 = w[1] - w[6];
    const long long t2 = w[2] + w[5], t5 = w[2] - w[5];
    const long long t3 = w[3] + w[4], t4 = w[3] - w[4];
    long long t10 = t0 + t3, t13 = t0 - t3, t11 = t1 + t2, t12 = t1 - t2;
    long long o[8];
    o[0] = as16((t10 + t11 + 128) >> 8);
    o[4] = as16((t10 - t11 + 128) >> 8);
    const long long z1 = (t12 + t13) * FIX_0_707106781;
    o[2] = as16((t13 * 256 + z1 + 32768) >> 16);
    o[6] = as16((t13 * 256 - z1 + 32768) >> 16);
    t10 = t4 + t5;
    t11 = t5 + t6;
    t12 = t6 + t7;
    const long long z5 = (t10 - t12) * FIX_0_382683433;
    const long long z2 = t10 * FIX_0_541196100 + z5;
    const long long z4 = t12 * FIX_1_306562965 + z5;
    const long long z3 = t11 * FIX_0_707106781;
    const long long z11 = t7 * 256 + z3, z13 = t7 * 256 - z3;
    o[5] = as16((z13 + z2 + 32768) >> 16);
    o[3] = as16((z13 - z2 + 32768) >> 16);
    o[1] = as16((z11 + z4 + 32768) >> 16);
    o[7] = as16((z11 - z4 + 32768) >> 16);
    const long long* q = a.qt + (plane == 0 ? 0 : 64);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      res[lb][i][c] = static_cast<int16_t>(as16((o[i] * q[8 * i + c] + 32767) >> 16));
  }
  __syncthreads();
  if (!live) return;
  const int4* src = reinterpret_cast<const int4*>(res[lb][r]);
  *reinterpret_cast<int4*>(a.out + gb * 64 + 8 * r) = *src;
}

struct IdctArgs {
  const int32_t* coef;  // (nblocks, 64) natural order
  uint8_t* planes[3];
  long long nblocks;
  Geometry g;
};

__device__ __forceinline__ long long mul(long long v, long long c) { return (v * c + 128) >> 8; }

// one pass of RTjpeg_idct on x[0..7] -> y[0..7]
__device__ __forceinline__ void idct_pass(const long long* x, long long* y) {
  const long long t10 = x[0] + x[4], t11 = x[0] - x[4];
  const long long t13 = x[2] + x[6];
  const long long t12 = mul(x[2] - x[6], FIX_1_414213562) - t13;
  const long long e0 = t10 + t13, e3 = t10 - t13, e1 = t11 + t12, e2 = t11 - t12;
  const long long z13 = x[5] + x[3], z10 = x[5] - x[3];
  const long long z11 = x[1] + x[7], z12 = x[1] - x[7];
  const long long o7 = z11 + z13;
  const long long s11 = mul(z11 - z13, FIX_1_414213562);
  const long long z5 = mul(z10 + z12, FIX_1_847759065);
  const long long s10 = mul(z12, FIX_1_082392200) - z5;
  const long long s12 = mul(z10, -FIX_2_613125930) + z5;
  const long long o6 = s12 - o7;
  const long long o5 = s11 - o6;
  const long long o4 = s10 + o5;
  y[0] = e0 + o7;
  y[7] = e0 - o7;
  y[1] = e1 + o6;
  y[6] = e1 - o6;
  y[2] = e2 + o5;
  y[5] = e2 - o5;
  y[4] = e3 + o4;
  y[3] = e3 - o4;
}

__global__ void __launch_bounds__(kThreads) rtjpeg_idct_kernel(IdctArgs a) {
  __shared__ long long ws[kBlocksPerCta][8][9];
  const int lb = threadIdx.x >> 3, r = threadIdx.x & 7;
  const long long gb = static_cast<long long>(blockIdx.x) * kBlocksPerCta + lb;
  const bool live = gb < a.nblocks;
  if (live) {
    const int32_t* c = a.coef + gb * 64;
    long long x[8], y[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] = c[8 * i + r];
    idct_pass(x, y);
#pragma unroll
    for (int i = 0; i < 8; ++i) ws[lb][i][r] = y[i];
  }
  __syncthreads();
  if (!live) return;
  long long x[8], y[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) x[i] = ws[lb][r][i];
  idct_pass(x, y);
  uint32_t lo = 0, hi = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    long long v = as16((y[i] + 4) >> 3);
    v = v < 16 ? 16 : (v > 235 ? 235 : v);
    if (i < 4)
      lo |= static_cast<uint32_t>(v) << (8 * i);
    else
      hi |= static_cast<uint32_t>(v) << (8 * (i - 4));
  }
  long long off;
  const int plane = block_at(a.g, gb, &off);
  const int w = plane == 0 ? a.g.width : a.g.width / 2;
  *reinterpret_cast<uint2*>(a.planes[plane] + off + static_cast<long long>(r) * w) =
      make_uint2(lo, hi);
}

Geometry geometry(long long width, long long height) {
  Geometry g;
  g.width = static_cast<int>(width);
  g.height = static_cast<int>(height);
  g.mbw = g.width / 16;
  g.nb = g.mbw * (g.height / 16) * 6;
  return g;
}

}  // namespace

// meta: the Y, U and V planes, qt, out, frames, width, height.
TC_API int tc_rtjpeg_fdct_quant(const long long* meta, cudaStream_t stream) {
  FdctArgs a;
  for (int p = 0; p < 3; ++p) a.planes[p] = reinterpret_cast<const uint8_t*>(meta[p]);
  a.qt = reinterpret_cast<const long long*>(meta[3]);
  a.out = reinterpret_cast<int16_t*>(meta[4]);
  a.g = geometry(meta[6], meta[7]);
  a.nblocks = meta[5] * a.g.nb;
  rtjpeg_fdct_kernel<<<tc_blocks(a.nblocks, kBlocksPerCta), kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// meta: coef, the Y, U and V planes, frames, width, height.
TC_API int tc_rtjpeg_idct(const long long* meta, cudaStream_t stream) {
  IdctArgs a;
  a.coef = reinterpret_cast<const int32_t*>(meta[0]);
  for (int p = 0; p < 3; ++p) a.planes[p] = reinterpret_cast<uint8_t*>(meta[1 + p]);
  a.g = geometry(meta[5], meta[6]);
  a.nblocks = meta[4] * a.g.nb;
  rtjpeg_idct_kernel<<<tc_blocks(a.nblocks, kBlocksPerCta), kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}
