// MPEG-4 part 2 (DivX/Xvid) VOP reconstruction for Hopper (sm_90a).
//
// Not a TPU kernel: the JAX package's device form is XLA ops
// (tcforge_tpu/io/mpeg4jax.py _recon_vop_math, xvid_idct_jax), and its
// CLI decodes through the numpy decoder (io/mpeg4dec.py), which this
// kernel follows.  One launch reconstructs one VOP from its records
// (io/mpeg4recon.py stage_plan: per macroblock 408 int16 values, the
// six blocks' dequantized coefficients, each luma block's forward and
// backward half-pel vectors, the forward and backward chroma vectors,
// use_f and use_b).
//
// One CTA per macroblock, one thread per output pixel (256 luma, 64 Cb,
// 64 Cr):
//   - the XVID integer IDCT (mpeg4dec.py _xvid_idct) in shared memory:
//     the row pass with the _ROW_TABS coefficients and _ROW_RND
//     rounding, >> 11 and the 16-bit wrap ((x + 0x8000) & 0xFFFF) -
//     0x8000; then the column pass with the TAN and SQRT2 terms, >> 6
//     and the wrap.  Every product and sum is 64-bit, as numpy's int64:
//     SQRT2 * (d +- c) passes 2^31 on large coefficients (where the JAX
//     device form's int32 wraps), and signed overflow is undefined in
//     C++.  One thread computes one output of each pass;
//   - the half-pel prediction of its 8x8 block (Mpeg4Decoder._mc_block):
//     two taps (a + b + 1 - rnd) >> 1, four taps (a + b + c + d + 2 -
//     rnd) >> 2, each sample's row and column clamped on its own to the
//     coded plane (what the numpy decoder's edge-padded planes give at
//     any vector length); forward with the VOP's rounding, backward
//     with 0; (f + b + 1) >> 1 where the macroblock uses both, 0 where
//     it uses neither (an intra macroblock);
//   - the clipped sum pred + residual, uint8.
// The I-VOP entry (tc_mpeg4_idct_intra) is the same kernel without the
// prediction: the IDCT clipped.

#include "common.cuh"

namespace {

constexpr int kRec = 408;
constexpr int kFmv = 384, kBmv = 392, kFcmv = 400, kBcmv = 402;
constexpr int kUseF = 404, kUseB = 405;
constexpr int kThreads = 384;

__constant__ int kRowTabs[8][7] = {
    {22725, 21407, 19266, 16384, 12873, 8867, 4520},
    {31521, 29692, 26722, 22725, 17855, 12299, 6270},
    {29692, 27969, 25172, 21407, 16819, 11585, 5906},
    {26722, 25172, 22654, 19266, 15137, 10426, 5315},
    {22725, 21407, 19266, 16384, 12873, 8867, 4520},
    {26722, 25172, 22654, 19266, 15137, 10426, 5315},
    {29692, 27969, 25172, 21407, 16819, 11585, 5906},
    {31521, 29692, 26722, 22725, 17855, 12299, 6270}};
__constant__ int kRowRnd[8] = {65536, 3597, 2260, 1203, 0, 120, 512, 512};
constexpr long long kTan1 = 13036, kTan2 = 27146, kTan3 = 43790;
constexpr long long kSqrt2 = 23170;

struct VopArgs {
  const int16_t* vop;          // (mbh * mbw, kRec)
  uint8_t* out[3];             // y (16*mbh, 16*mbw), u, v (8*mbh, 8*mbw)
  const uint8_t* fwd[3];       // anchors on the coded grid, or null
  const uint8_t* bwd[3];
  int mbw, mbh, rounding;
};

__device__ __forceinline__ long long wrap16(long long x) {
  return ((x + 0x8000) & 0xFFFF) - 0x8000;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Half-pel sample at (y, x) of an h x w plane with vector (mx, my).
__device__ __forceinline__ int mc_sample(const uint8_t* p, int h, int w,
                                         int y, int x, int mx, int my,
                                         int rnd) {
  const int x0 = x + (mx >> 1), y0 = y + (my >> 1);
  const int hx = mx & 1, hy = my & 1;
  const int xa = clampi(x0, 0, w - 1), xb = clampi(x0 + 1, 0, w - 1);
  const int ya = clampi(y0, 0, h - 1), yb = clampi(y0 + 1, 0, h - 1);
  const int p00 = __ldg(p + ya * w + xa);
  if (!hx && !hy) return p00;
  if (hx && !hy) return (p00 + __ldg(p + ya * w + xb) + 1 - rnd) >> 1;
  if (hy && !hx) return (p00 + __ldg(p + yb * w + xa) + 1 - rnd) >> 1;
  return (p00 + __ldg(p + ya * w + xb) + __ldg(p + yb * w + xa) +
          __ldg(p + yb * w + xb) + 2 - rnd) >> 2;
}

template <bool kIntra>
__global__ void __launch_bounds__(kThreads)
    vop_kernel(VopArgs a) {
  __shared__ long long coef[kThreads];
  __shared__ long long rows[kThreads];
  __shared__ int res[kThreads];
  const int mb = blockIdx.x;
  const int t = threadIdx.x;
  const int16_t* rec = a.vop + static_cast<long long>(mb) * kRec;
  coef[t] = rec[t];
  __syncthreads();

  // row pass: output column c of row r of block blk
  const int blk = t >> 6, r = (t >> 3) & 7, c = t & 7;
  {
    const long long* x = coef + blk * 64 + r * 8;
    const int* tab = kRowTabs[r];
    const long long c1 = tab[0], c2 = tab[1], c3 = tab[2], c4 = tab[3];
    const long long c5 = tab[4], c6 = tab[5], c7 = tab[6];
    const long long rnd = kRowRnd[r];
    const long long a0 = c4 * x[0] + c2 * x[2] + c4 * x[4] + c6 * x[6] + rnd;
    const long long a1 = c4 * x[0] + c6 * x[2] - c4 * x[4] - c2 * x[6] + rnd;
    const long long a2 = c4 * x[0] - c6 * x[2] - c4 * x[4] + c2 * x[6] + rnd;
    const long long a3 = c4 * x[0] - c2 * x[2] + c4 * x[4] - c6 * x[6] + rnd;
    const long long b0 = c1 * x[1] + c3 * x[3] + c5 * x[5] + c7 * x[7];
    const long long b1 = c3 * x[1] - c7 * x[3] - c1 * x[5] - c5 * x[7];
    const long long b2 = c5 * x[1] - c1 * x[3] + c7 * x[5] + c3 * x[7];
    const long long b3 = c7 * x[1] - c5 * x[3] + c3 * x[5] - c1 * x[7];
    long long v;
    switch (c) {
      case 0: v = a0 + b0; break;
      case 1: v = a1 + b1; break;
      case 2: v = a2 + b2; break;
      case 3: v = a3 + b3; break;
      case 4: v = a3 - b3; break;
      case 5: v = a2 - b2; break;
      case 6: v = a1 - b1; break;
      default: v = a0 - b0; break;
    }
    rows[t] = wrap16(v >> 11);
  }
  __syncthreads();

  // column pass: output row r (here the row index) of column c
  {
    const long long* x = rows + blk * 64 + c;
    const long long x0 = x[0], x1 = x[8], x2 = x[16], x3 = x[24];
    const long long x4 = x[32], x5 = x[40], x6 = x[48], x7 = x[56];
    const long long t17a = ((kTan1 * x7) >> 16) + x1;
    const long long t17b = ((kTan1 * x1) >> 16) - x7;
    const long long t35a = ((kTan3 * x5) >> 16) + x3;
    const long long t35b = ((kTan3 * x3) >> 16) - x5;
    const long long b0 = t17a + t35a;
    const long long d = t17a - t35a;
    const long long cc = t17b + t35b;
    const long long e0 = 2 * ((kSqrt2 * (d + cc)) >> 16);
    const long long e1 = 2 * ((kSqrt2 * (d - cc)) >> 16);
    const long long t26a = ((kTan2 * x6) >> 16) + x2;
    const long long t26b = ((kTan2 * x2) >> 16) - x6;
    const long long s04 = x0 + x4, d04 = x0 - x4;
    const long long a0 = s04 + t26a, a1 = s04 - t26a;
    const long long a2 = d04 + t26b, a3 = d04 - t26b;
    long long v;
    switch (r) {
      case 0: v = a0 + b0; break;
      case 1: v = a2 + e0; break;
      case 2: v = a3 + e1; break;
      case 3: v = a1 - t35b + t17b; break;
      case 4: v = a1 + t35b - t17b; break;
      case 5: v = a3 - e1; break;
      case 6: v = a2 - e0; break;
      default: v = a0 - b0; break;
    }
    res[t] = static_cast<int>(wrap16(v >> 6));
  }
  __syncthreads();

  // one pixel of the macroblock: luma 0..255, Cb 256..319, Cr 320..383
  const int mbx = mb % a.mbw, mby = mb / a.mbw;
  int plane, y, x, h, w, residual, fmx, fmy, bmx, bmy;
  if (t < 256) {
    const int ly = t >> 4, lx = t & 15;
    const int k = (ly >> 3) * 2 + (lx >> 3);
    plane = 0;
    y = mby * 16 + ly;
    x = mbx * 16 + lx;
    h = a.mbh * 16;
    w = a.mbw * 16;
    residual = res[k * 64 + (ly & 7) * 8 + (lx & 7)];
    fmx = rec[kFmv + 2 * k];
    fmy = rec[kFmv + 2 * k + 1];
    bmx = rec[kBmv + 2 * k];
    bmy = rec[kBmv + 2 * k + 1];
  } else {
    const int i = (t - 256) & 63;
    plane = t < 320 ? 1 : 2;
    y = mby * 8 + (i >> 3);
    x = mbx * 8 + (i & 7);
    h = a.mbh * 8;
    w = a.mbw * 8;
    residual = res[(3 + plane) * 64 + i];
    fmx = rec[kFcmv];
    fmy = rec[kFcmv + 1];
    bmx = rec[kBcmv];
    bmy = rec[kBcmv + 1];
  }
  int pred = 0;
  if (!kIntra) {
    const bool uf = rec[kUseF] != 0, ub = rec[kUseB] != 0;
    const int f = uf && a.fwd[plane] != nullptr
        ? mc_sample(a.fwd[plane], h, w, y, x, fmx, fmy, a.rounding) : 0;
    const int b = ub && a.bwd[plane] != nullptr
        ? mc_sample(a.bwd[plane], h, w, y, x, bmx, bmy, 0) : 0;
    pred = uf && ub ? (f + b + 1) >> 1 : (uf ? f : (ub ? b : 0));
  }
  a.out[plane][y * w + x] = static_cast<uint8_t>(clampi(pred + residual, 0, 255));
}

VopArgs read_args(const long long* meta) {
  VopArgs a;
  a.vop = reinterpret_cast<const int16_t*>(meta[0]);
  for (int i = 0; i < 3; ++i) {
    a.out[i] = reinterpret_cast<uint8_t*>(meta[1 + i]);
    a.fwd[i] = reinterpret_cast<const uint8_t*>(meta[7 + i]);
    a.bwd[i] = reinterpret_cast<const uint8_t*>(meta[10 + i]);
  }
  a.mbw = static_cast<int>(meta[4]);
  a.mbh = static_cast<int>(meta[5]);
  a.rounding = static_cast<int>(meta[6]);
  return a;
}

}  // namespace

// meta: vop, out y, u, v, mbw, mbh, rounding, fwd y, u, v, bwd y, u, v
// (a missing anchor's pointers 0: its prediction is 0).
TC_API int tc_mpeg4_recon(const long long* meta, cudaStream_t stream) {
  const VopArgs a = read_args(meta);
  vop_kernel<false><<<a.mbw * a.mbh, kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The same meta; rounding and the anchors are ignored.
TC_API int tc_mpeg4_idct_intra(const long long* meta, cudaStream_t stream) {
  const VopArgs a = read_args(meta);
  vop_kernel<true><<<a.mbw * a.mbh, kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}
