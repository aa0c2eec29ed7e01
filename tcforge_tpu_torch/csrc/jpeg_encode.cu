// Baseline JPEG encode for Hopper (sm_90a): the colour conversion and
// downsampling, and the forward DCT and quantization, of a batch of RGB24
// frames of one size (4:2:0, as PIL writes it).
//
// Not TPU kernels: the JAX package encodes JPEG through PIL (its movjpeg
// encoder, modules/importers/mov_import.py, calls Image.save with
// libjpeg-turbo underneath), and these kernels give PIL's coefficients;
// the Huffman coding is the host's (csrc/jpeg_huffenc.cpp).  The plain
// versions are io/jpegenc.py ycc_down_ref and fdct_quant_ref.
//
// jpeg_ycc_down: one thread a chroma sample of the padded chroma planes
// (8 x 8 a 16 x 16 MCU), over every frame of the batch.  The thread
// reads the four pixels under it and writes their four Y samples (two
// 2-byte stores) and one Cb and one Cr: jccolor.c rgb_ycc_convert
// (SCALEBITS 16, FIX() constants, ONE_HALF on Y and ONE_HALF - 1 with
// the 128 offset on Cb and Cr), then jcsample.c h2v2_downsample on Cb
// and Cr ((sum of 4 + bias) >> 2, the bias 1 on even and 2 on odd
// chroma columns).  Padding: columns past the image take its last one
// (expand_right_edge), Y rows under it its last row, chroma rows under
// the image its last chroma row (jcprepct.c expand_bottom_edge, before
// and after downsampling), so a chroma sample under the image is
// computed from the pixels of the last one.
//
// jpeg_fdct_quant: one block a group of 8 threads (32 blocks a CTA of
// 256), the blocks of a frame in the coder's order (MCU after MCU: Y
// blocks (0,0) (0,1) (1,0) (1,1), Cb, Cr).  Thread t runs pass 1 of
// jfdctint.c jpeg_fdct_islow (CONST_BITS 13, PASS1_BITS 2) on row t of
// the block's samples less 128 into shared memory, then pass 2 on column
// t, and quantizes each output as jcdctmgr.c quantize with libjpeg-turbo's
// 16-bit compute_reciprocal divisors: sign(x) * (((|x| + corr) * recip)
// >> shift).  The quantized block goes through shared memory into zigzag
// order, 16 bytes a thread.  A Y block past the image's right edge takes
// the DC of the block to its left and a Y block under the image the DC
// of the block at the right of its MCU's row above (jccoefct.c
// compress_data's dummies), with zero AC: the group computes the DCT of
// that source block and keeps only the DC.
//
// A 640x480 frame: 0.92 MB of RGB in and 0.46 MB of planes out of the
// first, 0.46 MB in and 0.92 MB of coefficients (7,200 blocks of 64
// int16) out of the second: both bound by their bytes, a few
// microseconds a 16-frame batch each, the second's int32 operations
// (about 1,000 a block) close behind.  One launch of each covers a
// batch, whatever its frames.

#include "common.cuh"

namespace {

constexpr int kYccThreads = 256;
constexpr int kDctThreads = 256;
constexpr int kBlocksPerCta = kDctThreads / 8;
constexpr int kWsStride = 9;  // words a workspace row
constexpr int kMcuBlocks = 6;

// the zigzag position of each natural index (the inverse of jutils.c
// jpeg_natural_order)
__constant__ uint8_t kZigzag[64] = {
    0,  1,  5,  6,  14, 15, 27, 28, 2,  4,  7,  13, 16, 26, 29, 42,
    3,  8,  12, 17, 25, 30, 41, 43, 9,  11, 18, 24, 31, 40, 44, 53,
    10, 19, 23, 32, 39, 45, 52, 54, 20, 22, 33, 38, 46, 51, 55, 60,
    21, 34, 37, 47, 50, 56, 59, 61, 35, 36, 48, 49, 57, 58, 62, 63};

struct YccArgs {
  const uint8_t* rgb;  // (frames, height, width, 3)
  uint8_t* out;        // (frames, plane_bytes)
  long long samples;   // frames * chroma samples a frame
  int width, height, cw, ch;  // the image; the padded chroma plane
};

__device__ __forceinline__ int luma(const uint8_t* p) {
  return (19595 * p[0] + 38470 * p[1] + 7471 * p[2] + 32768) >> 16;
}

__global__ void __launch_bounds__(kYccThreads) ycc_kernel(YccArgs a) {
  const long long i = static_cast<long long>(blockIdx.x) * kYccThreads + threadIdx.x;
  if (i >= a.samples) return;
  const long long per = static_cast<long long>(a.cw) * a.ch;
  const long long f = i / per;
  const int s = static_cast<int>(i - f * per);
  const int cy = s / a.cw, cx = s - cy * a.cw;
  const uint8_t* img = a.rgb + f * a.height * a.width * 3;
  const int x0 = min(2 * cx, a.width - 1), x1 = min(2 * cx + 1, a.width - 1);
  // the pixels of the chroma sample: those of the last chroma row under
  // the image
  const int k = min(cy, (a.height + 1) / 2 - 1);
  const int cr0 = 2 * k, cr1 = min(2 * k + 1, a.height - 1);
  const uint8_t* p[4] = {img + (cr0 * a.width + x0) * 3, img + (cr0 * a.width + x1) * 3,
                         img + (cr1 * a.width + x0) * 3, img + (cr1 * a.width + x1) * 3};
  int cb = 0, cr = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int r = p[j][0], g = p[j][1], b = p[j][2];
    cb += (-11059 * r - 21709 * g + 32768 * b + (128 << 16) + 32767) >> 16;
    cr += (32768 * r - 27439 * g - 5329 * b + (128 << 16) + 32767) >> 16;
  }
  const int bias = 1 + (cx & 1);
  // Y: the same pixels unless the sample lies under the image, where
  // both rows are the image's last
  const int y0 = min(2 * cy, a.height - 1), y1 = min(2 * cy + 1, a.height - 1);
  const uint8_t* q0 = img + y0 * a.width * 3;
  const uint8_t* q1 = img + y1 * a.width * 3;
  const int yw = 2 * a.cw;
  uint8_t* frame = a.out + f * (static_cast<long long>(yw) * 2 * a.ch + 2 * per);
  const uint16_t top = static_cast<uint16_t>(luma(q0 + x0 * 3) | (luma(q0 + x1 * 3) << 8));
  const uint16_t bottom = static_cast<uint16_t>(luma(q1 + x0 * 3) | (luma(q1 + x1 * 3) << 8));
  *reinterpret_cast<uint16_t*>(frame + (2 * cy) * yw + 2 * cx) = top;
  *reinterpret_cast<uint16_t*>(frame + (2 * cy + 1) * yw + 2 * cx) = bottom;
  uint8_t* chroma = frame + static_cast<long long>(yw) * 2 * a.ch;
  chroma[s] = static_cast<uint8_t>((cb + bias) >> 2);
  chroma[per + s] = static_cast<uint8_t>((cr + bias) >> 2);
}

struct DctArgs {
  const uint8_t* planes;  // (frames, plane_bytes)
  const int* div;         // (2, 3, 64): reciprocal, correction, shift
  int16_t* out;           // (frames, blocks, 64)
  long long nblocks;      // frames * blocks a frame
  int mcux, mcuy, yw, yh;  // the MCU grid; the Y blocks the image has
};

__device__ __forceinline__ int descale(int x, int n) { return (x + (1 << (n - 1))) >> n; }

// one pass of jpeg_fdct_islow over d[0..7]
template <bool kPass1>
__device__ __forceinline__ void fdct8(const int d[8], int o[8]) {
  constexpr int kShift = kPass1 ? 11 : 15;
  const int tmp0 = d[0] + d[7], tmp7 = d[0] - d[7];
  const int tmp1 = d[1] + d[6], tmp6 = d[1] - d[6];
  const int tmp2 = d[2] + d[5], tmp5 = d[2] - d[5];
  const int tmp3 = d[3] + d[4], tmp4 = d[3] - d[4];
  const int tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
  const int tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  if (kPass1) {
    o[0] = (tmp10 + tmp11) * 4;
    o[4] = (tmp10 - tmp11) * 4;
  } else {
    o[0] = descale(tmp10 + tmp11, 2);
    o[4] = descale(tmp10 - tmp11, 2);
  }
  int z1 = (tmp12 + tmp13) * 4433;
  o[2] = descale(z1 + tmp13 * 6270, kShift);
  o[6] = descale(z1 - tmp12 * 15137, kShift);
  z1 = tmp4 + tmp7;
  int z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
  const int z5 = (z3 + z4) * 9633;
  z1 *= -7373;
  z2 *= -20995;
  z3 = z3 * -16069 + z5;
  z4 = z4 * -3196 + z5;
  o[7] = descale(tmp4 * 2446 + z1 + z3, kShift);
  o[5] = descale(tmp5 * 16819 + z2 + z4, kShift);
  o[3] = descale(tmp6 * 25172 + z2 + z3, kShift);
  o[1] = descale(tmp7 * 12299 + z1 + z4, kShift);
}

__global__ void __launch_bounds__(kDctThreads) fdct_kernel(DctArgs a) {
  __shared__ int ws[kBlocksPerCta * 8 * kWsStride];
  __shared__ __align__(16) int16_t qs[kBlocksPerCta * 64];
  const int group = threadIdx.x >> 3, t = threadIdx.x & 7;
  const long long b = static_cast<long long>(blockIdx.x) * kBlocksPerCta + group;
  if (b >= a.nblocks) return;  // the whole group of 8 leaves together
  const unsigned lanes = 0xFFu << (threadIdx.x & 24);
  const int per_frame = a.mcux * a.mcuy * kMcuBlocks;
  const long long f = b / per_frame;
  const int r = static_cast<int>(b - f * per_frame);
  const int mcu = r / kMcuBlocks, k = r - mcu * kMcuBlocks;
  const int my = mcu / a.mcux, mx = mcu - my * a.mcux;
  const int ystride = 16 * a.mcux, cstride = 8 * a.mcux;
  const long long ysize = 256LL * a.mcux * a.mcuy;
  const uint8_t* frame = a.planes + f * (ysize + 128LL * a.mcux * a.mcuy);
  const uint8_t* src;
  int stride, table = 0;
  bool dummy = false;
  if (k < 4) {
    int by = 2 * my + (k >> 1), bx = 2 * mx + (k & 1);
    dummy = by >= a.yh || bx >= a.yw;
    if (by >= a.yh) {  // a row under the image
      by = a.yh - 1;
      bx = 2 * mx + 1;
    }
    bx = min(bx, a.yw - 1);
    src = frame + static_cast<long long>(by) * 8 * ystride + bx * 8;
    stride = ystride;
  } else {
    src = frame + ysize + (k - 4) * 64LL * a.mcux * a.mcuy + (my * 8) * cstride + mx * 8;
    stride = cstride;
    table = 1;
  }
  int d[8], o[8];
  // pass 1: row t
  const uint2 row = *reinterpret_cast<const uint2*>(src + t * stride);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    d[j] = static_cast<int>((row.x >> (8 * j)) & 0xFF) - 128;
    d[j + 4] = static_cast<int>((row.y >> (8 * j)) & 0xFF) - 128;
  }
  fdct8<true>(d, o);
  int* w = ws + group * 8 * kWsStride;
#pragma unroll
  for (int j = 0; j < 8; ++j) w[t * kWsStride + j] = o[j];
  __syncwarp(lanes);
  // pass 2: column t, then quantize coefficient (j, t)
#pragma unroll
  for (int j = 0; j < 8; ++j) d[j] = w[j * kWsStride + t];
  fdct8<false>(d, o);
  const int* div = a.div + table * 3 * 64;
  int16_t* q = qs + group * 64;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int n = j * 8 + t;
    const int x = o[j];
    const unsigned ax = static_cast<unsigned>(x < 0 ? -x : x);
    int v = static_cast<int>((static_cast<unsigned long long>(ax + div[64 + n]) *
                              static_cast<unsigned>(div[n])) >> div[128 + n]);
    if (x < 0) v = -v;
    if (dummy && n != 0) v = 0;
    q[kZigzag[n]] = static_cast<int16_t>(v);
  }
  __syncwarp(lanes);
  *reinterpret_cast<uint4*>(a.out + b * 64 + t * 8) = *reinterpret_cast<const uint4*>(q + t * 8);
}

}  // namespace

// meta: rgb, out, frames, width, height, the padded chroma plane's width
// and height.
TC_API int tc_jpeg_ycc_down(const long long* meta, cudaStream_t stream) {
  YccArgs a;
  a.rgb = reinterpret_cast<const uint8_t*>(meta[0]);
  a.out = reinterpret_cast<uint8_t*>(meta[1]);
  const long long frames = meta[2];
  a.width = static_cast<int>(meta[3]);
  a.height = static_cast<int>(meta[4]);
  a.cw = static_cast<int>(meta[5]);
  a.ch = static_cast<int>(meta[6]);
  a.samples = frames * a.cw * a.ch;
  ycc_kernel<<<tc_blocks(a.samples, kYccThreads), kYccThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// meta: planes, divisors, out, frames, the MCUs across and down, the Y
// blocks across and down that the image has.
TC_API int tc_jpeg_fdct_quant(const long long* meta, cudaStream_t stream) {
  DctArgs a;
  a.planes = reinterpret_cast<const uint8_t*>(meta[0]);
  a.div = reinterpret_cast<const int*>(meta[1]);
  a.out = reinterpret_cast<int16_t*>(meta[2]);
  const long long frames = meta[3];
  a.mcux = static_cast<int>(meta[4]);
  a.mcuy = static_cast<int>(meta[5]);
  a.yw = static_cast<int>(meta[6]);
  a.yh = static_cast<int>(meta[7]);
  a.nblocks = frames * a.mcux * a.mcuy * kMcuBlocks;
  fdct_kernel<<<tc_blocks(a.nblocks, kBlocksPerCta), kDctThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}
