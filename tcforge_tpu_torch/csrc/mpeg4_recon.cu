// MPEG-4 part 2 (DivX/Xvid) VOP reconstruction for Hopper (sm_90a).
//
// Not a TPU kernel: the JAX package's device form is XLA ops
// (tcforge_tpu/io/mpeg4jax.py _recon_vop_math, xvid_idct_jax), and its
// CLI decodes through the numpy decoder (io/mpeg4dec.py), which these
// kernels follow.  One launch reconstructs one VOP from its records
// (io/mpeg4recon.py stage_plan: per macroblock 432 int16 values, the
// six blocks' dequantized coefficients, each luma block's forward and
// backward vectors, the forward and backward chroma vectors, use_f,
// use_b, dct_type, the prediction form and a field macroblock's
// reference fields, field vectors and their chroma vectors; every
// vector worked out on the host, io/mpeg4plan.py).
//
// One CTA per macroblock, one thread per output pixel (256 luma, 64 Cb,
// 64 Cr):
//   - the XVID integer IDCT (mpeg4_common.cuh idct_row, idct_col) in
//     shared memory, in 64 bits where the JAX device form's int32
//     wraps; one thread computes one output of each pass;
//   - the prediction, forward with the VOP's rounding, backward with 0;
//     (f + b + 1) >> 1 where the macroblock uses both, 0 where it uses
//     neither (an intra macroblock).  By the macroblock's form:
//       half-pel frame MC (mpeg4_common.cuh mc_sample, each sample's row
//       and column clamped on its own to the coded plane) per 8x8 block;
//       quarter-sample luma (mpeg4_recon_qpel, mpeg4_recon_field;
//       Mpeg4Decoder._mc_block_qpel): per filter block (one 16x16 for
//       1MV, four 8x8 for 4MV and direct mode) its (s+1)x(s+1) window
//       staged in shared memory with each coordinate clamped, the 8-tap
//       [-1 3 -6 20 20 -6 3 -1] filter over all s+1 rows with the taps
//       mirrored at the block's edges, clipped, the quarter averages,
//       then the vertical stage on those; the chroma half-pel;
//       field MC (mpeg4_recon_field; _field_pred_mb): row r of the
//       macroblock from field r & 1's vector in its reference field,
//       rows clamped in frame space (mc_sample_field);
//   - the clipped sum pred + residual, uint8, the luma residual taken by
//     dct_type: quadrants, or field lines (_luma_store: blocks 0 and 1
//     the even rows, 2 and 3 the odd).
// mpeg4_recon predicts every macroblock half-pel whatever its form;
// mpeg4_recon_qpel adds the quarter-sample forms; mpeg4_recon_field the
// field form too (a quarter-sample VOL may be interlaced).  The I-VOP
// entry (tc_mpeg4_idct_intra) is the same kernel without the
// prediction: the IDCT clipped, stored by dct_type.

#include "common.cuh"
#include "mpeg4_common.cuh"

namespace {

constexpr int kRec = 432;
constexpr int kFmv = 384, kBmv = 392, kFcmv = 400, kBcmv = 402;
constexpr int kUseF = 404, kUseB = 405, kDct = 406, kForm = 407;
constexpr int kFsel = 408, kFldMv = 412, kFldCmv = 420;
constexpr int kFormQpel16 = 1, kFormQpel8 = 2, kFormField = 3;
constexpr int kThreads = 384;
// the quarter-sample stage buffers: four 9x9 windows (one 17x17), four
// 9x8 horizontal stages (one 17x16)
constexpr int kWin = 4 * 9 * 9, kCol = 4 * 9 * 8;

using mpeg4::clampi;
using mpeg4::idct_col;
using mpeg4::idct_row;
using mpeg4::mc_sample;
using mpeg4::mc_sample_field;

struct VopArgs {
  const int16_t* vop;          // (mbh * mbw, kRec)
  uint8_t* out[3];             // y (16*mbh, 16*mbw), u, v (8*mbh, 8*mbw)
  const uint8_t* fwd[3];       // anchors on the coded grid, or null
  const uint8_t* bwd[3];
  int mbw, mbh, rounding;
};

// Tap index i of a window s+1 long, mirrored at its edges
// (mpeg4dec.py _qpel_idx).
__device__ __forceinline__ int qpel_mirror(int i, int s) {
  return i < 0 ? -i - 1 : (i > s ? 2 * s + 1 - i : i);
}

// The half-sample filter at output x of a window s+1 long whose
// samples lie `stride` apart: clip((v + 16 - rnd) >> 5, 0, 255).
__device__ __forceinline__ int qpel_tap(const int* p, int stride, int x,
                                        int s, int rnd) {
  const int v = -p[qpel_mirror(x - 3, s) * stride] +
                3 * p[qpel_mirror(x - 2, s) * stride] -
                6 * p[qpel_mirror(x - 1, s) * stride] +
                20 * p[x * stride] + 20 * p[(x + 1) * stride] -
                6 * p[qpel_mirror(x + 2, s) * stride] +
                3 * p[qpel_mirror(x + 3, s) * stride] -
                p[qpel_mirror(x + 4, s) * stride];
  return clampi((v + 16 - rnd) >> 5, 0, 255);
}

// The quarter-sample luma prediction of macroblock (mbx, mby) from the
// h x w plane `ref` into out[16 * 16] (shared), by the whole CTA: one
// 16x16 filter block with block 0's vector (s8 false) or four 8x8 ones
// with their own (mv: the four blocks' (x, y)).
__device__ void qpel_luma(const uint8_t* ref, int h, int w, int mbx,
                          int mby, const int16_t* mv, bool s8, int rnd,
                          int* win, int* col, int* out) {
  const int t = threadIdx.x;
  const int s = s8 ? 8 : 16, nb = s8 ? 4 : 1, n1 = s + 1;
  for (int i = t; i < nb * n1 * n1; i += kThreads) {
    const int bk = i / (n1 * n1), r = i % (n1 * n1) / n1, c = i % n1;
    const int oy = mby * 16 + (bk >> 1) * 8, ox = mbx * 16 + (bk & 1) * 8;
    const int yy = clampi(oy + (mv[2 * bk + 1] >> 2) + r, 0, h - 1);
    const int xx = clampi(ox + (mv[2 * bk] >> 2) + c, 0, w - 1);
    win[i] = __ldg(ref + yy * w + xx);
  }
  __syncthreads();
  // the horizontal stage over all s+1 rows
  for (int i = t; i < nb * n1 * s; i += kThreads) {
    const int bk = i / (n1 * s), r = i % (n1 * s) / s, x = i % s;
    const int hx = mv[2 * bk] & 3;
    const int* row = win + bk * n1 * n1 + r * n1;
    int v = row[x];
    if (hx) {
      const int hh = qpel_tap(row, 1, x, s, rnd);
      v = hx == 2 ? hh : (row[x + (hx == 3)] + hh + 1 - rnd) >> 1;
    }
    col[i] = v;
  }
  __syncthreads();
  // the vertical stage on the clipped intermediates
  for (int i = t; i < nb * s * s; i += kThreads) {
    const int bk = i / (s * s), y = i % (s * s) / s, x = i % s;
    const int hy = mv[2 * bk + 1] & 3;
    const int* c = col + bk * n1 * s + x;
    int v = c[y * s];
    if (hy) {
      const int hv = qpel_tap(c, s, y, s, rnd);
      v = hy == 2 ? hv : (c[(y + (hy == 3)) * s] + hv + 1 - rnd) >> 1;
    }
    out[((bk >> 1) * 8 + y) * 16 + (bk & 1) * 8 + x] = v;
  }
  __syncthreads();
}

template <bool kIntra, bool kQpel, bool kField>
__global__ void __launch_bounds__(kThreads)
    vop_kernel(VopArgs a) {
  __shared__ long long coef[kThreads];
  __shared__ long long rows[kThreads];
  __shared__ int res[kThreads];
  __shared__ int win[kQpel ? kWin : 1];
  __shared__ int col[kQpel ? kCol : 1];
  __shared__ int qpred[kQpel ? 2 * 256 : 1];
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

  const int mbx = mb % a.mbw, mby = mb / a.mbw;
  // uses a direction; has its anchor (a prediction from none is 0)
  const bool uf = !kIntra && rec[kUseF] != 0, ub = !kIntra && rec[kUseB] != 0;
  const bool hf = uf && a.fwd[0] != nullptr, hb = ub && a.bwd[0] != nullptr;
  const int form = rec[kForm];
  const bool qpel = kQpel && (form == kFormQpel16 || form == kFormQpel8);
  const bool field = kField && form == kFormField;
  if (qpel) {  // the same for every thread of the CTA
    if (hf)
      qpel_luma(a.fwd[0], a.mbh * 16, a.mbw * 16, mbx, mby, rec + kFmv,
                form == kFormQpel8, a.rounding, win, col, qpred);
    if (hb)
      qpel_luma(a.bwd[0], a.mbh * 16, a.mbw * 16, mbx, mby, rec + kBmv,
                form == kFormQpel8, 0, win, col, qpred + 256);
  }

  // one pixel of the macroblock: luma 0..255, Cb 256..319, Cr 320..383
  int plane, y, x, h, w, residual, fmx, fmy, bmx, bmy, vec;
  if (t < 256) {
    const int ly = t >> 4, lx = t & 15;
    const int k = (ly >> 3) * 2 + (lx >> 3);
    plane = 0;
    y = mby * 16 + ly;
    x = mbx * 16 + lx;
    h = a.mbh * 16;
    w = a.mbw * 16;
    residual = rec[kDct]
        ? res[((ly & 1) * 2 + (lx >> 3)) * 64 + (ly >> 1) * 8 + (lx & 7)]
        : res[k * 64 + (ly & 7) * 8 + (lx & 7)];
    fmx = rec[kFmv + 2 * k];
    fmy = rec[kFmv + 2 * k + 1];
    bmx = rec[kBmv + 2 * k];
    bmy = rec[kBmv + 2 * k + 1];
    vec = kFldMv;
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
    vec = kFldCmv;
  }
  int pred = 0;
  if (!kIntra) {
    int f = 0, b = 0;
    if (qpel && plane == 0) {
      if (hf) f = qpred[t];
      if (hb) b = qpred[256 + t];
    } else if (field) {
      // field (y & 1)'s vector and reference field, at field row y >> 1
      const int i = y & 1;
      if (hf)
        f = mc_sample_field(a.fwd[plane], h, w, y >> 1, x, rec[vec + 2 * i],
                            rec[vec + 2 * i + 1], rec[kFsel + i],
                            a.rounding);
      if (hb)
        b = mc_sample_field(a.bwd[plane], h, w, y >> 1, x,
                            rec[vec + 4 + 2 * i], rec[vec + 5 + 2 * i],
                            rec[kFsel + 2 + i], 0);
    } else {
      if (hf) f = mc_sample(a.fwd[plane], h, w, y, x, fmx, fmy, a.rounding);
      if (hb) b = mc_sample(a.bwd[plane], h, w, y, x, bmx, bmy, 0);
    }
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

template <bool kIntra, bool kQpel, bool kField>
int launch(const long long* meta, cudaStream_t stream) {
  const VopArgs a = read_args(meta);
  vop_kernel<kIntra, kQpel, kField>
      <<<a.mbw * a.mbh, kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// meta: vop, out y, u, v, mbw, mbh, rounding, fwd y, u, v, bwd y, u, v
// (a missing anchor's pointers 0: its prediction is 0).
TC_API int tc_mpeg4_recon(const long long* meta, cudaStream_t stream) {
  return launch<false, false, false>(meta, stream);
}

TC_API int tc_mpeg4_recon_qpel(const long long* meta, cudaStream_t stream) {
  return launch<false, true, false>(meta, stream);
}

TC_API int tc_mpeg4_recon_field(const long long* meta,
                                cudaStream_t stream) {
  return launch<false, true, true>(meta, stream);
}

// The same meta; rounding and the anchors are ignored.
TC_API int tc_mpeg4_idct_intra(const long long* meta, cudaStream_t stream) {
  return launch<true, false, false>(meta, stream);
}
