// Baseline JPEG pixels for Hopper (sm_90a): the IDCT and the colour
// stage of a batch of Motion-JPEG or photo-JPEG frames of one geometry.
//
// Not TPU kernels: the JAX package decodes JPEG through PIL
// (modules/importers/avi_import.py and io/mov.py call Image.open, with
// libjpeg-turbo underneath), and these kernels give PIL's bytes.  The
// Huffman decode is the host's (csrc/jpeg_entropy.cpp), which writes
// each block's quantized coefficients in natural order into its
// component's padded plane, frame after frame; one launch of each
// kernel covers every frame of a batch.
//
// jpeg_idct: one block of 64 coefficients a group of 8 threads (32
// blocks a CTA of 256).  Thread t dequantizes column t (the block's
// frame's table of its component, 16-bit values) and runs pass 1 of
// libjpeg's jpeg_idct_islow (jidctint.c: CONST_BITS 13, PASS1_BITS 2,
// descaled by 11) into shared memory, then row t: pass 2, descaled by
// 18, through jdmaster.c's post-IDCT range-limit table at x & 1023
// (x + 128 clamped for x in [-512, 512), wrapping beyond: out-of-range
// coefficients wrap, as in libjpeg, where a clamp would not), written as
// one 8-byte store.  The arithmetic is int32 and wraps (unsigned
// products and sums), as libjpeg-turbo's SIMD pass 2 and the plain
// version (io/jpeg.py idct_ref) do.  The workspace rows are 9 words
// apart, so that the 32 rows of a warp fall in 32 banks in both passes.
//
// jpeg_color: one output pixel a thread over every frame of the batch.
// Each component's sample at the pixel, upsampled as libjpeg-turbo's
// jdsample.c does (fancy h2v1: (3 near + far + 1 or 2) >> 2; fancy h1v2
// the same down the column; fancy h2v2: column sums 3 near + far, then
// (3 s + s' + 8 or 7) >> 4; replication for the other integer ratios
// and for h2v1 and h2v2 where the component is 2 samples wide or less),
// the neighbours clamped to the component's real size (its first and
// last real row repeat above and below the image, jdmainct.c's context
// rows), read from the IDCT's block layout; then jdcolor.c
// ycc_rgb_convert (SCALEBITS 16, FIX() rounding, clamped), RGB as it is,
// gray to all three; three bytes out.  The output is cropped to the
// image: (frames, height, width, 3).
//
// A 640x480 4:2:0 frame is 7,200 blocks: 0.92 MB of coefficients in and
// 0.46 MB of samples out of the IDCT, 0.46 MB in and 0.92 MB of pixels
// out of the colour stage.  Both are bound by their int32 operations
// (about 1,200 a block, 36 a 4:2:0 pixel), the bytes close behind, a few
// microseconds a 16-frame batch each.  The IDCT's groups of 8 threads
// keep its passes in registers and one shared tile; the colour stage,
// one thread a pixel, reads each component's samples through the block
// layout and writes single bytes, the simpler form of the two (PERF.md).
// One launch of each covers a batch, whatever its frames.

#include "common.cuh"

namespace {

constexpr int kIdctThreads = 256;
constexpr int kBlocksPerCta = kIdctThreads / 8;
constexpr int kWsStride = 9;  // words a workspace row
constexpr int kMaxComps = 3;
constexpr int kColorThreads = 256;

// colour spaces (io/jpeg.py; 0 is YCbCr) and upsampling forms
constexpr int kRgb = 1, kGray = 2;
constexpr int kUpFull = 0, kUpH2v1 = 1, kUpH1v2 = 2, kUpH2v2 = 3;
// ycc_rgb_convert's FIX() products of Cb - 128 and Cr - 128, rounded:
// the offsets' products and the half in one constant each
constexpr int kRoundR = 32768 - 91881 * 128;
constexpr int kRoundG = 32768 + (22554 + 46802) * 128;
constexpr int kRoundB = 32768 - 116130 * 128;

struct IdctArgs {
  const int16_t* coef;
  const int16_t* qt;  // (frames, 4, 64)
  uint8_t* out;
  long long nblocks;
  int per_frame;
  int off1, off2;  // the second and third components' first block
};

__device__ __forceinline__ int mul(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) * static_cast<unsigned>(b));
}
__device__ __forceinline__ int add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}
__device__ __forceinline__ int sub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}

// one pass of jpeg_idct_islow over d[0..7], each output descaled by kShift
template <int kShift>
__device__ __forceinline__ void idct8(const int d[8], int o[8]) {
  int z1 = mul(add(d[2], d[6]), 4433);
  const int tmp2 = add(z1, mul(d[6], -15137));
  const int tmp3 = add(z1, mul(d[2], 6270));
  // the descale's rounding, added once to the even half: every output
  // sums tmp0 or tmp1 (jidctint.c adds its fudge factor to one input)
  constexpr int kHalf = 1 << (kShift - 1);
  const int tmp0 = add(mul(add(d[0], d[4]), 8192), kHalf);
  const int tmp1 = add(mul(sub(d[0], d[4]), 8192), kHalf);
  const int tmp10 = add(tmp0, tmp3), tmp13 = sub(tmp0, tmp3);
  const int tmp11 = add(tmp1, tmp2), tmp12 = sub(tmp1, tmp2);
  int t0 = d[7], t1 = d[5], t2 = d[3], t3 = d[1];
  z1 = add(t0, t3);
  int z2 = add(t1, t2), z3 = add(t0, t2), z4 = add(t1, t3);
  const int z5 = mul(add(z3, z4), 9633);
  t0 = mul(t0, 2446);
  t1 = mul(t1, 16819);
  t2 = mul(t2, 25172);
  t3 = mul(t3, 12299);
  z1 = mul(z1, -7373);
  z2 = mul(z2, -20995);
  z3 = add(mul(z3, -16069), z5);
  z4 = add(mul(z4, -3196), z5);
  t0 = add(t0, add(z1, z3));
  t1 = add(t1, add(z2, z4));
  t2 = add(t2, add(z2, z3));
  t3 = add(t3, add(z1, z4));
  o[0] = add(tmp10, t3) >> kShift;
  o[7] = sub(tmp10, t3) >> kShift;
  o[1] = add(tmp11, t2) >> kShift;
  o[6] = sub(tmp11, t2) >> kShift;
  o[2] = add(tmp12, t1) >> kShift;
  o[5] = sub(tmp12, t1) >> kShift;
  o[3] = add(tmp13, t0) >> kShift;
  o[4] = sub(tmp13, t0) >> kShift;
}

__device__ __forceinline__ unsigned range_limit(int x) {
  const int m = x & 1023;
  return m < 512 ? min(m + 128, 255) : max(m - 896, 0);
}

__global__ void __launch_bounds__(kIdctThreads) idct_kernel(IdctArgs a) {
  __shared__ int ws[kBlocksPerCta * 8 * kWsStride];
  const int group = threadIdx.x >> 3, t = threadIdx.x & 7;
  const long long b = static_cast<long long>(blockIdx.x) * kBlocksPerCta + group;
  if (b >= a.nblocks) return;  // the whole group of 8 leaves together
  const unsigned lanes = 0xFFu << (threadIdx.x & 24);
  const long long f = b / a.per_frame;
  const int r = static_cast<int>(b - f * a.per_frame);
  const int comp = (r >= a.off1) + (r >= a.off2);
  const int16_t* q = a.qt + (f * 4 + comp) * 64;
  const int16_t* in = a.coef + b * 64;
  int d[8], o[8];
  // pass 1: column t
#pragma unroll
  for (int k = 0; k < 8; ++k)
    d[k] = mul(in[k * 8 + t], static_cast<int>(static_cast<uint16_t>(q[k * 8 + t])));
  idct8<11>(d, o);
  int* w = ws + group * 8 * kWsStride;
#pragma unroll
  for (int k = 0; k < 8; ++k) w[k * kWsStride + t] = o[k];
  __syncwarp(lanes);
  // pass 2: row t
#pragma unroll
  for (int k = 0; k < 8; ++k) d[k] = w[t * kWsStride + k];
  idct8<18>(d, o);
  uint2 packed;
  packed.x = range_limit(o[0]) | (range_limit(o[1]) << 8) |
             (range_limit(o[2]) << 16) | (range_limit(o[3]) << 24);
  packed.y = range_limit(o[4]) | (range_limit(o[5]) << 8) |
             (range_limit(o[6]) << 16) | (range_limit(o[7]) << 24);
  *reinterpret_cast<uint2*>(a.out + b * 64 + t * 8) = packed;
}

struct Comp {
  int off, bw, dw, dh, hf, vf, up;
};

struct ColorArgs {
  const uint8_t* samples;
  uint8_t* out;
  long long pixels;  // frames * height * width
  int width, height, per_frame, color, ncomp;
  Comp comp[kMaxComps];
};

// sample (row, col) of a component's padded plane in the block layout
__device__ __forceinline__ int at(const uint8_t* frame, const Comp& c,
                                  int row, int col) {
  const int blk = c.off + (row >> 3) * c.bw + (col >> 3);
  return frame[blk * 64 + (row & 7) * 8 + (col & 7)];
}

__device__ __forceinline__ int upsample(const uint8_t* frame, const Comp& c,
                                        int y, int x) {
  if (c.up == kUpFull) return at(frame, c, y, x);
  if (c.up == kUpH2v1) {
    const int col = x >> 1, odd = x & 1;
    const int near = min(max(col + 2 * odd - 1, 0), c.dw - 1);
    return (3 * at(frame, c, y, col) + at(frame, c, y, near) + 1 + odd) >> 2;
  }
  if (c.up == kUpH1v2) {
    const int row = y >> 1, odd = y & 1;
    const int near = min(max(row + 2 * odd - 1, 0), c.dh - 1);
    return (3 * at(frame, c, row, x) + at(frame, c, near, x) + 1 + odd) >> 2;
  }
  if (c.up == kUpH2v2) {
    const int row = y >> 1, yodd = y & 1;
    const int rn = min(max(row + 2 * yodd - 1, 0), c.dh - 1);
    const int col = x >> 1, xodd = x & 1;
    const int cn = min(max(col + 2 * xodd - 1, 0), c.dw - 1);
    const int s = 3 * at(frame, c, row, col) + at(frame, c, rn, col);
    const int s2 = 3 * at(frame, c, row, cn) + at(frame, c, rn, cn);
    return (3 * s + s2 + 8 - xodd) >> 4;
  }
  return at(frame, c, y / c.vf, x / c.hf);
}

__device__ __forceinline__ unsigned clamp255(int v) {
  return static_cast<unsigned>(min(max(v, 0), 255));
}

__global__ void __launch_bounds__(kColorThreads) color_kernel(ColorArgs a) {
  const long long i = static_cast<long long>(blockIdx.x) * kColorThreads + threadIdx.x;
  if (i >= a.pixels) return;
  const long long plane = static_cast<long long>(a.width) * a.height;
  const long long f = i / plane;
  const int p = static_cast<int>(i - f * plane);
  const int y = p / a.width, x = p - y * a.width;
  const uint8_t* frame = a.samples + f * a.per_frame * 64;
  unsigned r, g, b;
  const int c0 = upsample(frame, a.comp[0], y, x);
  if (a.color == kGray) {
    r = g = b = static_cast<unsigned>(c0);
  } else {
    const int c1 = upsample(frame, a.comp[1], y, x);
    const int c2 = upsample(frame, a.comp[2], y, x);
    if (a.color == kRgb) {
      r = c0;
      g = c1;
      b = c2;
    } else {
      // the -128 offsets folded into the rounding constants
      r = clamp255(c0 + ((91881 * c2 + kRoundR) >> 16));
      g = clamp255(c0 + ((-22554 * c1 - 46802 * c2 + kRoundG) >> 16));
      b = clamp255(c0 + ((116130 * c1 + kRoundB) >> 16));
    }
  }
  uint8_t* o = a.out + i * 3;
  o[0] = static_cast<uint8_t>(r);
  o[1] = static_cast<uint8_t>(g);
  o[2] = static_cast<uint8_t>(b);
}

}  // namespace

// meta: coef, qt, out, the blocks, the blocks a frame, the second and
// third components' first block (the blocks a frame where absent).
TC_API int tc_jpeg_idct(const long long* meta, cudaStream_t stream) {
  IdctArgs a;
  a.coef = reinterpret_cast<const int16_t*>(meta[0]);
  a.qt = reinterpret_cast<const int16_t*>(meta[1]);
  a.out = reinterpret_cast<uint8_t*>(meta[2]);
  a.nblocks = meta[3];
  a.per_frame = static_cast<int>(meta[4]);
  a.off1 = static_cast<int>(meta[5]);
  a.off2 = static_cast<int>(meta[6]);
  idct_kernel<<<tc_blocks(a.nblocks, kBlocksPerCta), kIdctThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// meta: samples, out, frames, width, height, the blocks a frame, the
// colour space, the components, then for each of three components its
// first block, blocks a row, real width and height, upsampling factors
// and form.
TC_API int tc_jpeg_color(const long long* meta, cudaStream_t stream) {
  ColorArgs a;
  a.samples = reinterpret_cast<const uint8_t*>(meta[0]);
  a.out = reinterpret_cast<uint8_t*>(meta[1]);
  const long long frames = meta[2];
  a.width = static_cast<int>(meta[3]);
  a.height = static_cast<int>(meta[4]);
  a.per_frame = static_cast<int>(meta[5]);
  a.color = static_cast<int>(meta[6]);
  a.ncomp = static_cast<int>(meta[7]);
  for (int k = 0; k < kMaxComps; ++k) {
    const long long* c = meta + 8 + 7 * k;
    a.comp[k] = Comp{static_cast<int>(c[0]), static_cast<int>(c[1]),
                     static_cast<int>(c[2]), static_cast<int>(c[3]),
                     static_cast<int>(c[4]), static_cast<int>(c[5]),
                     static_cast<int>(c[6])};
  }
  a.pixels = frames * a.width * a.height;
  color_kernel<<<tc_blocks(a.pixels, kColorThreads), kColorThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}
