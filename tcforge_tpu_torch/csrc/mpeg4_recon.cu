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
//   - the XVID integer IDCT (mpeg4_common.cuh idct_row, idct_col) in
//     shared memory, in 64 bits where the JAX device form's int32
//     wraps; one thread computes one output of each pass;
//   - the half-pel prediction of its 8x8 block (mpeg4_common.cuh
//     mc_sample, each sample's row and column clamped on its own to the
//     coded plane): forward with the VOP's rounding, backward with 0;
//     (f + b + 1) >> 1 where the macroblock uses both, 0 where it uses
//     neither (an intra macroblock);
//   - the clipped sum pred + residual, uint8.
// The I-VOP entry (tc_mpeg4_idct_intra) is the same kernel without the
// prediction: the IDCT clipped.

#include "common.cuh"
#include "mpeg4_common.cuh"

namespace {

constexpr int kRec = 408;
constexpr int kFmv = 384, kBmv = 392, kFcmv = 400, kBcmv = 402;
constexpr int kUseF = 404, kUseB = 405;
constexpr int kThreads = 384;

using mpeg4::clampi;
using mpeg4::idct_col;
using mpeg4::idct_row;
using mpeg4::mc_sample;

struct VopArgs {
  const int16_t* vop;          // (mbh * mbw, kRec)
  uint8_t* out[3];             // y (16*mbh, 16*mbw), u, v (8*mbh, 8*mbw)
  const uint8_t* fwd[3];       // anchors on the coded grid, or null
  const uint8_t* bwd[3];
  int mbw, mbh, rounding;
};

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
  rows[t] = idct_row(coef + blk * 64 + r * 8, r, c);
  __syncthreads();

  // column pass: output row r (here the row index) of column c
  res[t] = idct_col(rows + blk * 64 + c, r);
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
