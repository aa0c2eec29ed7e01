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
// vector worked out on the host, io/mpeg4plan.py).  An S-VOP (GMC) takes
// two launches: mpeg4_gmc_warp warps the forward anchor's three planes
// by the VOP's warp record, then the VOP's reconstruction, whose
// FORM_GMC macroblocks take those planes at their own place.
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
//       GMC (every instance): the forward prediction is the warped
//       planes' sample at the pixel (the wrapper passes them exactly
//       for an S-VOP; a GMC macroblock in a launch without them traps);
//   - the clipped sum pred + residual, uint8, the luma residual taken by
//     dct_type: quadrants, or field lines (_luma_store: blocks 0 and 1
//     the even rows, 2 and 3 the odd).
// mpeg4_recon predicts every macroblock half-pel whatever its form but
// GMC; mpeg4_recon_qpel adds the quarter-sample forms; mpeg4_recon_field
// the field form too (a quarter-sample VOL may be interlaced).  The I-VOP
// entry (tc_mpeg4_idct_intra) is the same kernel without the
// prediction: the IDCT clipped, stored by dct_type.
//
// The GMC warp (tc_mpeg4_gmc_warp; Mpeg4Decoder._gmc_warp_planes and
// _gmc_bilin) is a kernel of its own, one thread per output sample of
// the three planes laid end to end (luma, Cb, Cr), so that a warp's
// writes are coalesced: the sample's coordinate at 1/S precision from
// the translation (chroma: d * S/4, or (d >> 1) | (d & 1) at S == 2) or
// the affine record (luma (o + dxx i + dxy j) >> sh, chroma
// (oc + 4 (dxx i + dxy j)) >> (sh + 2)) in 64 bits, where a 1920x1088
// plane's terms pass 2^31; its integer part a floor (arithmetic shift),
// its fraction the low bits; the four samples around it, each
// coordinate clamped on its own to the coded plane (what the numpy
// warp's 128-sample edge padding and clips give), blended in 32 bits
// with S*S/2 - rounding and shifted by 2 log2(S), then clipped.

#include "common.cuh"
#include "mpeg4_common.cuh"

namespace {

constexpr int kRec = 432;
constexpr int kFmv = 384, kBmv = 392, kFcmv = 400, kBcmv = 402;
constexpr int kUseF = 404, kUseB = 405, kDct = 406, kForm = 407;
constexpr int kFsel = 408, kFldMv = 412, kFldCmv = 420;
constexpr int kFormQpel16 = 1, kFormQpel8 = 2, kFormField = 3;
constexpr int kFormGmc = 4;
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
  const uint8_t* gmc[3];       // an S-VOP's warped planes, or null
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

// The pointer of ``plane`` among three of an argument array, each read
// at a constant index: indexing the kernel's parameter by a run-time
// value copies the whole argument struct to each thread's stack.
template <typename T>
__device__ __forceinline__ T pick(T p0, T p1, T p2, int plane) {
  return plane == 0 ? p0 : (plane == 1 ? p1 : p2);
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
  const bool gmc = form == kFormGmc;
  if (gmc && a.gmc[0] == nullptr) __trap();  // records without their warp
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
    const uint8_t* fref = pick(a.fwd[0], a.fwd[1], a.fwd[2], plane);
    const uint8_t* bref = pick(a.bwd[0], a.bwd[1], a.bwd[2], plane);
    int f = 0, b = 0;
    if (qpel && plane == 0) {
      if (hf) f = qpred[t];
      if (hb) b = qpred[256 + t];
    } else if (gmc) {
      // the warped forward anchor at this pixel; backward as half-pel
      if (hf)
        f = __ldg(pick(a.gmc[0], a.gmc[1], a.gmc[2], plane) + y * w + x);
      if (hb) b = mc_sample(bref, h, w, y, x, bmx, bmy, 0);
    } else if (field) {
      // field (y & 1)'s vector and reference field, at field row y >> 1
      const int i = y & 1;
      if (hf)
        f = mc_sample_field(fref, h, w, y >> 1, x, rec[vec + 2 * i],
                            rec[vec + 2 * i + 1], rec[kFsel + i],
                            a.rounding);
      if (hb)
        b = mc_sample_field(bref, h, w, y >> 1, x,
                            rec[vec + 4 + 2 * i], rec[vec + 5 + 2 * i],
                            rec[kFsel + 2 + i], 0);
    } else {
      if (hf) f = mc_sample(fref, h, w, y, x, fmx, fmy, a.rounding);
      if (hb) b = mc_sample(bref, h, w, y, x, bmx, bmy, 0);
    }
    pred = uf && ub ? (f + b + 1) >> 1 : (uf ? f : (ub ? b : 0));
  }
  pick(a.out[0], a.out[1], a.out[2], plane)[y * w + x] =
      static_cast<uint8_t>(clampi(pred + residual, 0, 255));
}

VopArgs read_args(const long long* meta) {
  VopArgs a;
  a.vop = reinterpret_cast<const int16_t*>(meta[0]);
  for (int i = 0; i < 3; ++i) {
    a.out[i] = reinterpret_cast<uint8_t*>(meta[1 + i]);
    a.fwd[i] = reinterpret_cast<const uint8_t*>(meta[7 + i]);
    a.bwd[i] = reinterpret_cast<const uint8_t*>(meta[10 + i]);
    a.gmc[i] = reinterpret_cast<const uint8_t*>(meta[13 + i]);
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

struct WarpArgs {
  const uint8_t* ref[3];       // the forward anchor on the coded grid
  uint8_t* out[3];
  int h, w;                    // the luma plane's
  int s, n, rnd, sh;           // S, points, rounding, the affine shift
  long long tx, ty;            // one point's translation
  long long dxx, dxy, dyx, dyy, ox, oy, ocx, ocy;
};

__device__ __forceinline__ int clampll(long long v, int hi) {
  return v < 0 ? 0 : (v > hi ? hi : static_cast<int>(v));
}

__global__ void __launch_bounds__(256) gmc_warp_kernel(WarpArgs a) {
  const long long luma = static_cast<long long>(a.h) * a.w;
  long long k = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (k >= luma + luma / 2) return;
  int plane = 0, h = a.h, w = a.w;
  if (k >= luma) {
    k -= luma;
    plane = 1 + static_cast<int>(k / (luma / 4));
    k %= luma / 4;
    h >>= 1;
    w >>= 1;
  }
  const long long j = k / w, i = k % w;
  const int s = a.s;
  long long vx, vy;
  if (a.n == 1) {
    long long ox, oy;
    if (plane == 0) {
      ox = a.tx * (s / 2);
      oy = a.ty * (s / 2);
    } else if (s == 2) {
      ox = (a.tx >> 1) | (a.tx & 1);
      oy = (a.ty >> 1) | (a.ty & 1);
    } else {
      ox = a.tx * (s / 4);
      oy = a.ty * (s / 4);
    }
    vx = i * s + ox;
    vy = j * s + oy;
  } else if (plane == 0) {
    vx = (a.ox + a.dxx * i + a.dxy * j) >> a.sh;
    vy = (a.oy + a.dyx * i + a.dyy * j) >> a.sh;
  } else {
    vx = (a.ocx + 4 * (a.dxx * i + a.dxy * j)) >> (a.sh + 2);
    vy = (a.ocy + 4 * (a.dyx * i + a.dyy * j)) >> (a.sh + 2);
  }
  const int lg = 31 - __clz(s);
  const long long x0 = vx >> lg, y0 = vy >> lg;
  const int fx = static_cast<int>(vx & (s - 1));
  const int fy = static_cast<int>(vy & (s - 1));
  const int xa = clampll(x0, w - 1), xb = clampll(x0 + 1, w - 1);
  const int ya = clampll(y0, h - 1), yb = clampll(y0 + 1, h - 1);
  const uint8_t* p = pick(a.ref[0], a.ref[1], a.ref[2], plane);
  const int v = ((s - fx) * (s - fy) * __ldg(p + ya * w + xa) +
                 fx * (s - fy) * __ldg(p + ya * w + xb) +
                 (s - fx) * fy * __ldg(p + yb * w + xa) +
                 fx * fy * __ldg(p + yb * w + xb) + s * s / 2 - a.rnd) >>
                (2 * lg);
  pick(a.out[0], a.out[1], a.out[2], plane)[k] =
      static_cast<uint8_t>(clampi(v, 0, 255));
}

}  // namespace

// meta: vop, out y, u, v, mbw, mbh, rounding, fwd y, u, v, bwd y, u, v,
// gmc y, u, v (a missing anchor's pointers 0: its prediction is 0; the
// warped planes 0 but for an S-VOP).
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

// meta: ref y, u, v, out y, u, v, the luma's h and w, then the warp
// record (io/mpeg4plan.py warp_record): S, points, rounding, tx, ty,
// dxx, dxy, dyx, dyy, sh, ox, oy, ocx, ocy.
TC_API int tc_mpeg4_gmc_warp(const long long* meta, cudaStream_t stream) {
  WarpArgs a;
  for (int i = 0; i < 3; ++i) {
    a.ref[i] = reinterpret_cast<const uint8_t*>(meta[i]);
    a.out[i] = reinterpret_cast<uint8_t*>(meta[3 + i]);
  }
  a.h = static_cast<int>(meta[6]);
  a.w = static_cast<int>(meta[7]);
  const long long* v = meta + 8;
  a.s = static_cast<int>(v[0]);
  a.n = static_cast<int>(v[1]);
  a.rnd = static_cast<int>(v[2]);
  a.tx = v[3];
  a.ty = v[4];
  a.dxx = v[5];
  a.dxy = v[6];
  a.dyx = v[7];
  a.dyy = v[8];
  a.sh = static_cast<int>(v[9]);
  a.ox = v[10];
  a.oy = v[11];
  a.ocx = v[12];
  a.ocy = v[13];
  const long long samples = static_cast<long long>(a.h) * a.w * 3 / 2;
  gmc_warp_kernel<<<tc_blocks(samples, 256), 256, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}
