// MPEG-4 part 2 Simple Profile encoder's decisions and block coding for
// Hopper (sm_90a).
//
// Not TPU kernels: the JAX package's encoder (tcforge_tpu/io/mpeg4enc.py
// Mpeg4NativeEncoder) is numpy loops over macroblocks with no device
// form; these kernels replace them and give its levels, vectors and
// reconstruction bit for bit.  Records: io/mpeg4encdev.py (one int16
// record of kRec values a macroblock).
//
// tc_mpeg4_enc_me, a P-VOP's decisions (_encode_pvop), one launch a VOP.
//   The median vector predictor makes macroblock (x, y) wait for (x-1, y),
//   (x, y-1) and (x+1, y-1), so the VOP runs as a wavefront: one CTA a
//   macroblock row (a ticket gives rows in launch order, so a waiting
//   CTA's row above is resident), row y starting macroblock x once row
//   y-1 has published x+1 (a counter in global memory after a fence).
//   Before that wait, a macroblock's 8x8 integer SADs at every offset in
//   +-15 (four blocks, 3844 SADs from a 49x49 window of the reference in
//   shared memory, edge-clamped) and its mean-removed SAD are computed
//   by all threads; after it, thread 0 runs the three-step search over
//   the table (the predictor's seed before (0, 0), candidates (-s,0),
//   (s,0), (0,-s), (0,s) repeated while one improves, strict <), the
//   threads the nine half-pel SADs (dx outer, dy inner), thread 0 the
//   intra test (dev < sad - 500), the 4MV +-2 search per block from the
//   table (dy outer) and the threads its half-pel SADs (dy outer), and
//   the 4MV test (sad4 + 300 < sad and a vector differs).  Where a 4MV
//   macroblock's 1MV vector is (0, 0) the JAX encoder's not_coded test
//   reads its levels (mpeg4enc.py:732): the threads code its six blocks
//   as the block coder does, and all-zero levels set the grid to (0, 0).
//   Bound: operations (byte SADs); the wavefront's mbw + 2 mbh - 2
//   dependent steps make it latency-bound.
//
// tc_mpeg4_enc_bme, a B-VOP's decisions (_encode_bvop), one launch a VOP.
//   The forward and backward predictors reset at each row and change
//   only with the chosen mode, so rows are independent: one CTA a row,
//   its macroblocks in turn.  A macroblock whose co-located one was
//   skipped takes the direct mode with no bits; another one gets both
//   references' 16x16 integer SADs within +-14 (two tables), the direct
//   prediction's SAD (the co-located vectors scaled by trb / trd toward
//   0), both searches from the row's predictors with their half-pel
//   refines, the interpolated SAD, and the first minimum of (dsad - 16,
//   direct), (isad + 64, interpolated), (bsad + 32, backward), (fsad +
//   32, forward) by cost then type.
//
// tc_mpeg4_enc_blocks, every macroblock of a VOP at once: one CTA a
//   macroblock, one thread a coefficient of its six blocks.  The
//   prediction from the records' vectors (mpeg4_common.cuh mc_sample,
//   rounding 0), the float64 forward DCT as numpy's OpenBLAS computes
//   _DCTM @ b @ _DCTM.T (two chains of __fma_rn over k from 0), the
//   H.263 quantizer (an intra DC floor(F00 / scale + 0.5), its AC
//   trunc(F / 2q); inter sign(F) * max(trunc((|F| - q/2) / 2q), 0);
//   IEEE division, no fast math), clipped to +-2047, the dequantizer,
//   the XVID integer IDCT (mpeg4_common.cuh) and the clipped
//   reconstruction; new records: the decisions with the levels, cbp and
//   skip flag.
//   Bound: bytes.

#include "common.cuh"
#include "mpeg4_common.cuh"

namespace {

using mpeg4::clampi;
using mpeg4::idct_col;
using mpeg4::idct_row;
using mpeg4::mc_sample;

// io/mpeg4encdev.py's record
constexpr int kRec = 416;
constexpr int kMode = 384, kCbp = 385, kSkip = 386, kMx = 387, kMy = 388;
constexpr int kBmx = 389, kBmy = 390, kFmv4 = 391, kBmv4 = 399;
constexpr int kFcmv = 407, kBcmv = 409;
constexpr int kInter = 0, kInter4 = 1, kIntra = 2, kDirect = 3;
constexpr int kInterp = 4, kBackward = 5, kForward = 6, kCoskip = 7;
constexpr int kVopI = 0, kVopP = 1, kVopB = 2;

constexpr int kThreads = 384;
constexpr int kWin = 49;          // reference window: offsets -16..+32
constexpr int kR8 = 15;           // the 8x8 table's reach
constexpr int kN8 = 2 * kR8 + 1;
constexpr int kR16 = 14;          // the 16x16 tables' reach (B)
constexpr int kN16 = 2 * kR16 + 1;

__constant__ int kRoundTab[16] = {0, 0, 0, 1, 1, 1, 1, 1,
                                  1, 1, 1, 1, 1, 1, 2, 2};
__constant__ int kYDcScale[32] = {0, 8, 8, 8, 8, 10, 12, 14, 16, 17, 18,
                                  19, 20, 21, 22, 23, 24, 25, 26, 27, 28,
                                  29, 30, 31, 32, 34, 36, 38, 40, 42, 44,
                                  46};
__constant__ int kCDcScale[32] = {0, 8, 8, 8, 8, 9, 9, 10, 10, 11, 11, 12,
                                  12, 13, 13, 14, 14, 15, 15, 16, 16, 17,
                                  17, 18, 18, 19, 20, 21, 22, 23, 24, 25};

__device__ __forceinline__ int round_chroma(int x) {
  return kRoundTab[x & 0xF] + ((x >> 3) & ~1);
}

__device__ __forceinline__ int single_chroma(int m) {
  return (m >> 1) | (m & 1);
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// Half-pel sample (rounding 0) from a window whose origin is 16 samples
// up and left of the macroblock: (py, px) within the macroblock.
__device__ __forceinline__ int win_sample(const uint8_t* win, int py, int px,
                                          int mx, int my) {
  const int wy = py + (my >> 1) + 16, wx = px + (mx >> 1) + 16;
  const uint8_t* p = win + wy * kWin + wx;
  const int hx = mx & 1, hy = my & 1;
  if (!hx && !hy) return p[0];
  if (hx && !hy) return (p[0] + p[1] + 1) >> 1;
  if (hy && !hx) return (p[0] + p[kWin] + 1) >> 1;
  return (p[0] + p[1] + p[kWin] + p[kWin + 1] + 2) >> 2;
}

__device__ void load_window(uint8_t* win, const uint8_t* plane, int h, int w,
                            int y0, int x0) {
  for (int i = threadIdx.x; i < kWin * kWin; i += blockDim.x) {
    const int gy = clampi(y0 - 16 + i / kWin, 0, h - 1);
    const int gx = clampi(x0 - 16 + i % kWin, 0, w - 1);
    win[i] = __ldg(plane + gy * w + gx);
  }
}

// The six blocks' coefficient of thread t (block t >> 6, raster t & 63)
// after the float64 forward DCT of X: the two FMA chains through T.
__device__ double fdct(const double* X, double* T, const double* basis) {
  const int t = threadIdx.x;
  const int blk = t >> 6, r = (t >> 3) & 7, c = t & 7;
  double acc = 0.0;
  for (int k = 0; k < 8; ++k)
    acc = __fma_rn(basis[r * 8 + k], X[blk * 64 + k * 8 + c], acc);
  T[t] = acc;
  __syncthreads();
  double f = 0.0;
  for (int k = 0; k < 8; ++k)
    f = __fma_rn(T[blk * 64 + r * 8 + k], basis[c * 8 + k], f);
  return f;
}

__device__ __forceinline__ long long quant_inter(double f, int q) {
  const double mag = trunc(__ddiv_rn(__dsub_rn(fabs(f), q * 0.5), 2.0 * q));
  const double m = mag > 0.0 ? mag : 0.0;
  long long lv = f > 0.0 ? static_cast<long long>(m)
                         : (f < 0.0 ? -static_cast<long long>(m) : 0);
  return lv < -2047 ? -2047 : (lv > 2047 ? 2047 : lv);
}

__device__ __forceinline__ long long quant_intra(double f, int q, int scale,
                                                 bool dc) {
  if (dc) return static_cast<long long>(
      floor(__dadd_rn(__ddiv_rn(f, static_cast<double>(scale)), 0.5)));
  const long long lv = static_cast<long long>(trunc(__ddiv_rn(f, 2.0 * q)));
  return lv < -2047 ? -2047 : (lv > 2047 ? 2047 : lv);
}

// The pixel of thread t in block-major order: plane, and (y, x) in it.
__device__ __forceinline__ void block_pixel(int t, int mbx, int mby, int& plane,
                                            int& y, int& x) {
  const int blk = t >> 6, r = (t >> 3) & 7, c = t & 7;
  if (blk < 4) {
    plane = 0;
    y = mby * 16 + (blk >> 1) * 8 + r;
    x = mbx * 16 + (blk & 1) * 8 + c;
  } else {
    plane = blk - 3;
    y = mby * 8 + r;
    x = mbx * 8 + c;
  }
}

// --------------------------------------------------------------------- //
// The block coder

struct BlockArgs {
  const int16_t* rec;          // the decisions (null for an I-VOP)
  int16_t* out;
  const uint8_t* cur[3];
  const uint8_t* fwd[3];
  const uint8_t* bwd[3];
  uint8_t* recon[3];
  int mbw, mbh, q, vop_type;
  double basis[64];
};

__global__ void __launch_bounds__(kThreads)
    mpeg4_blocks_kernel(BlockArgs a) {
  __shared__ double X[kThreads];
  __shared__ double T[kThreads];
  __shared__ long long coef[kThreads];
  __shared__ long long rows[kThreads];
  __shared__ int nz[6];
  const int mb = blockIdx.x;
  const int t = threadIdx.x;
  const int mbx = mb % a.mbw, mby = mb / a.mbw;
  const int16_t* rec = a.rec + static_cast<long long>(mb) * kRec;
  int16_t* out = a.out + static_cast<long long>(mb) * kRec;
  const int mode = a.vop_type == kVopI ? kIntra : rec[kMode];
  const bool intra = mode == kIntra;
  const int blk = t >> 6, r = (t >> 3) & 7, c = t & 7;
  int plane, y, x;
  block_pixel(t, mbx, mby, plane, y, x);
  const int h = plane ? a.mbh * 8 : a.mbh * 16;
  const int w = plane ? a.mbw * 8 : a.mbw * 16;
  const bool uf = mode == kInter || mode == kInter4 || mode == kForward ||
                  mode == kDirect || mode == kInterp || mode == kCoskip;
  const bool ub = mode == kBackward || mode == kDirect || mode == kInterp ||
                  mode == kCoskip;
  int pred = 0;
  if (!intra) {
    const int fo = plane ? kFcmv : kFmv4 + 2 * blk;
    const int bo = plane ? kBcmv : kBmv4 + 2 * blk;
    const int f = uf ? mc_sample(a.fwd[plane], h, w, y, x, rec[fo],
                                 rec[fo + 1], 0) : 0;
    const int b = ub ? mc_sample(a.bwd[plane], h, w, y, x, rec[bo],
                                 rec[bo + 1], 0) : 0;
    pred = uf && ub ? (f + b + 1) >> 1 : (uf ? f : b);
  }
  const int src = __ldg(a.cur[plane] + y * w + x);
  X[t] = static_cast<double>(intra ? src : src - pred);
  if (t < 6) nz[t] = 0;
  __syncthreads();
  const double f = fdct(X, T, a.basis);
  const int scale = plane ? kCDcScale[a.q] : kYDcScale[a.q];
  const bool dc = intra && t % 64 == 0;
  long long lv = 0;
  if (mode != kCoskip)
    lv = intra ? quant_intra(f, a.q, scale, dc) : quant_inter(f, a.q);
  if (lv != 0 && !dc) atomicOr(&nz[blk], 1);
  const int add = (a.q & 1) == 0 ? a.q - 1 : a.q;
  long long deq = 0;
  if (dc)
    deq = lv * scale;
  else if (lv != 0)
    deq = (lv > 0 ? 1 : -1) * (2 * (lv > 0 ? lv : -lv) * a.q + add);
  coef[t] = deq < -2048 ? -2048 : (deq > 2047 ? 2047 : deq);
  __syncthreads();
  rows[t] = idct_row(coef + blk * 64 + r * 8, r, c);
  __syncthreads();
  const int res = idct_col(rows + blk * 64 + c, r);
  if (a.recon[plane] != nullptr) {
    const int v = intra ? clampi(res, 0, 255)
                        : (nz[blk] ? clampi(res + pred, 0, 255) : pred);
    a.recon[plane][y * w + x] = static_cast<uint8_t>(v);
  }
  out[t] = static_cast<int16_t>(lv);
  if (t < kRec - kThreads) {
    const int f = kThreads + t;
    int cbp = 0;
    for (int n = 0; n < 6; ++n) cbp |= nz[n] << (5 - n);
    int v;
    if (f == kCbp) {
      v = cbp;
    } else if (f == kSkip) {
      if (a.vop_type == kVopB)
        v = mode == kDirect && cbp == 0;
      else
        v = (mode == kInter || mode == kInter4) && cbp == 0 &&
            rec[kMx] == 0 && rec[kMy] == 0;
    } else if (a.vop_type == kVopI) {
      v = f == kMode ? kIntra : 0;
    } else {
      v = rec[f];
    }
    out[f] = static_cast<int16_t>(v);
  }
}

// --------------------------------------------------------------------- //
// P-VOP decisions

struct MeArgs {
  int16_t* rec;
  const uint8_t* cur[3];
  const uint8_t* ref[3];
  int mbw, mbh, q, four_mv, search;
  int* grid;                  // (2 mbh, 2 mbw, 2) median predictor grid
  int* sync;                  // per row: macroblocks done; [mbh]: ticket
  double basis[64];
};

__device__ __forceinline__ int median3(int a, int b, int c) {
  return min(max(a, b), max(min(a, b), c));
}

// Mpeg4Decoder._pred_mv of block 0 of macroblock (mbx, mby).
__device__ void pred_mv0(const int* grid, int mbw, int mbx, int mby, int& px,
                         int& py) {
  const int bx = 2 * mbx, by = 2 * mby, w2 = 2 * mbw;
  const bool ha = bx - 1 >= 0, hb = by - 1 >= 0, hc = by - 1 >= 0 &&
                                                      bx + 2 < w2;
  int a[2] = {0, 0}, b[2] = {0, 0}, c[2] = {0, 0};
  if (ha) {
    a[0] = __ldcg(grid + (by * w2 + bx - 1) * 2);
    a[1] = __ldcg(grid + (by * w2 + bx - 1) * 2 + 1);
  }
  if (hb) {
    b[0] = __ldcg(grid + ((by - 1) * w2 + bx) * 2);
    b[1] = __ldcg(grid + ((by - 1) * w2 + bx) * 2 + 1);
  }
  if (hc) {
    c[0] = __ldcg(grid + ((by - 1) * w2 + bx + 2) * 2);
    c[1] = __ldcg(grid + ((by - 1) * w2 + bx + 2) * 2 + 1);
  }
  if (!ha && !hb && !hc) {
    px = py = 0;
  } else if (!hb && !hc) {
    px = a[0];
    py = a[1];
  } else {
    px = median3(a[0], b[0], c[0]);
    py = median3(a[1], b[1], c[1]);
  }
}

// The three-step search of _search_mv from both seeds over an integer SAD
// function; the winner's integer vector.
template <typename Sad>
__device__ void three_step(Sad sad, int pmx, int pmy, int lim, int& obx,
                           int& oby) {
  int sx[2] = {pmx >> 1, 0}, sy[2] = {pmy >> 1, 0};
  const int nseeds = (sx[0] == 0 && sy[0] == 0) ? 1 : 2;
  int best = 0, bbx = 0, bby = 0;
  for (int s = 0; s < nseeds; ++s) {
    int bx = max(-lim, min(lim, sx[s])), by = max(-lim, min(lim, sy[s]));
    int bs = sad(bx, by);
    for (int step = 4; step; step >>= 1) {
      bool improved = true;
      while (improved) {
        improved = false;
        const int dxs[4] = {-step, step, 0, 0}, dys[4] = {0, 0, -step, step};
        for (int j = 0; j < 4; ++j) {
          const int nx = bx + dxs[j], ny = by + dys[j];
          if (abs(nx) > lim || abs(ny) > lim) continue;
          const int v = sad(nx, ny);
          if (v < bs) {
            bs = v;
            bx = nx;
            by = ny;
            improved = true;
          }
        }
      }
    }
    if (s == 0 || bs < best) {
      best = bs;
      bbx = bx;
      bby = by;
    }
  }
  obx = bbx;
  oby = bby;
}

__global__ void __launch_bounds__(kThreads)
    mpeg4_me_kernel(MeArgs a) {
  __shared__ uint8_t win[kWin * kWin];
  __shared__ uint8_t cur[256];
  __shared__ uint16_t t8[4 * kN8 * kN8];
  __shared__ double X[kThreads];
  __shared__ double T[kThreads];
  __shared__ int red[2 + 9 + 36];
  __shared__ int st[24];    // row, bx, by, mx, my, sad, intra, use4, ...
  __shared__ int mv4[8];
  __shared__ int anynz;
  const int t = threadIdx.x;
  const int H = a.mbh * 16, W = a.mbw * 16;
  if (t == 0) st[0] = atomicAdd(a.sync + a.mbh, 1);
  __syncthreads();
  const int mby = st[0];
  const int lim = a.search;
  const int w2 = 2 * a.mbw;
  for (int mbx = 0; mbx < a.mbw; ++mbx) {
    const int x0 = mbx * 16, y0 = mby * 16;
    load_window(win, a.ref[0], H, W, y0, x0);
    if (t < 256) cur[t] = __ldg(a.cur[0] + (y0 + (t >> 4)) * W + x0 + (t & 15));
    if (t < 2 + 9 + 36) red[t] = 0;
    __syncthreads();
    for (int e = t; e < 4 * kN8 * kN8; e += kThreads) {
      const int k = e / (kN8 * kN8), o = e % (kN8 * kN8);
      const int dy = o / kN8 - kR8, dx = o % kN8 - kR8;
      const int by0 = 8 * (k >> 1), bx0 = 8 * (k & 1);
      int s = 0;
      for (int py = 0; py < 8; ++py) {
        const uint8_t* cr = cur + (by0 + py) * 16 + bx0;
        const uint8_t* wr = win + (by0 + py + dy + 16) * kWin + bx0 + dx + 16;
        for (int px = 0; px < 8; ++px) s += abs(cr[px] - wr[px]);
      }
      t8[e] = static_cast<uint16_t>(s);
    }
    if (t < 256) {
      const int v = warp_sum(cur[t]);
      if ((t & 31) == 0) atomicAdd(&red[0], v);
    }
    __syncthreads();
    if (t < 256) {
      const int v = warp_sum(abs(cur[t] - (red[0] >> 8)));
      if ((t & 31) == 0) atomicAdd(&red[1], v);
    }
    // wait for the row above to have published macroblock x + 1
    if (t == 0 && mby > 0) {
      const int need = min(mbx + 2, a.mbw);
      const volatile int* done = a.sync + mby - 1;
      while (*done < need) __nanosleep(32);
      __threadfence();
    }
    __syncthreads();
    if (t == 0) {
      int pmx, pmy;
      pred_mv0(a.grid, a.mbw, mbx, mby, pmx, pmy);
      auto sad16 = [&](int ix, int iy) {
        const int o = (iy + kR8) * kN8 + ix + kR8;
        return t8[o] + t8[kN8 * kN8 + o] + t8[2 * kN8 * kN8 + o] +
               t8[3 * kN8 * kN8 + o];
      };
      three_step(sad16, pmx, pmy, lim, st[1], st[2]);
    }
    __syncthreads();
    const int bx = st[1], by = st[2];
    if (t < 256) {
      const int py = t >> 4, px = t & 15, cv = cur[t];
      for (int j = 0; j < 9; ++j) {
        const int mx = 2 * bx + j / 3 - 1, my = 2 * by + j % 3 - 1;
        int v = 0;
        if (mx >= -32 && mx <= 31 && my >= -32 && my <= 31)
          v = abs(cv - win_sample(win, py, px, mx, my));
        v = warp_sum(v);
        if ((t & 31) == 0) atomicAdd(&red[2 + j], v);
      }
    }
    __syncthreads();
    if (t == 0) {
      int best = -1;
      for (int j = 0; j < 9; ++j) {
        const int mx = 2 * bx + j / 3 - 1, my = 2 * by + j % 3 - 1;
        if (mx < -32 || mx > 31 || my < -32 || my > 31) continue;
        if (best < 0 || red[2 + j] < red[2 + best]) best = j;
      }
      st[3] = 2 * bx + best / 3 - 1;
      st[4] = 2 * by + best % 3 - 1;
      st[5] = red[2 + best];
      st[6] = red[1] < st[5] - 500;
      st[7] = 0;
      // the 4MV +-2 integer search of each block from the table
      if (!st[6] && a.four_mv) {
        const int ix0 = st[3] >> 1, iy0 = st[4] >> 1;
        for (int k = 0; k < 4; ++k) {
          int bs = -1, bnx = 0, bny = 0;
          for (int ddy = -2; ddy <= 2; ++ddy) {
            for (int ddx = -2; ddx <= 2; ++ddx) {
              const int nx = ix0 + ddx, ny = iy0 + ddy;
              if (abs(nx) > 15 || abs(ny) > 15) continue;
              const int v = t8[k * kN8 * kN8 + (ny + kR8) * kN8 + nx + kR8];
              if (bs < 0 || v < bs) {
                bs = v;
                bnx = nx;
                bny = ny;
              }
            }
          }
          st[8 + 2 * k] = bnx;
          st[9 + 2 * k] = bny;
        }
      }
    }
    __syncthreads();
    const bool intra = st[6];
    const int mx = st[3], my = st[4];
    bool use4 = false;
    if (!intra && a.four_mv) {
      if (t < 256) {
        const int k = t >> 6, p = t & 63;
        const int py = (k >> 1) * 8 + (p >> 3), px = (k & 1) * 8 + (p & 7);
        const int cv = cur[py * 16 + px];
        const int ix = st[8 + 2 * k], iy = st[9 + 2 * k];
        for (int j = 0; j < 9; ++j) {
          const int nmx = 2 * ix + j % 3 - 1, nmy = 2 * iy + j / 3 - 1;
          int v = 0;
          if (nmx >= -32 && nmx <= 31 && nmy >= -32 && nmy <= 31)
            v = abs(cv - win_sample(win, py, px, nmx, nmy));
          v = warp_sum(v);
          if ((t & 31) == 0) atomicAdd(&red[11 + k * 9 + j], v);
        }
      }
      __syncthreads();
      if (t == 0) {
        int sad4 = 0;
        bool differs = false;
        for (int k = 0; k < 4; ++k) {
          const int ix = st[8 + 2 * k], iy = st[9 + 2 * k];
          int best = -1;
          for (int j = 0; j < 9; ++j) {
            const int nmx = 2 * ix + j % 3 - 1, nmy = 2 * iy + j / 3 - 1;
            if (nmx < -32 || nmx > 31 || nmy < -32 || nmy > 31) continue;
            if (best < 0 || red[11 + k * 9 + j] < red[11 + k * 9 + best])
              best = j;
          }
          mv4[2 * k] = 2 * ix + best % 3 - 1;
          mv4[2 * k + 1] = 2 * iy + best / 3 - 1;
          sad4 += red[11 + k * 9 + best];
          differs |= mv4[2 * k] != mx || mv4[2 * k + 1] != my;
        }
        st[7] = sad4 + 300 < st[5] && differs;
        anynz = 0;
      }
      __syncthreads();
      use4 = st[7];
    }
    int cmx = single_chroma(mx), cmy = single_chroma(my);
    if (use4) {
      cmx = round_chroma(mv4[0] + mv4[2] + mv4[4] + mv4[6]);
      cmy = round_chroma(mv4[1] + mv4[3] + mv4[5] + mv4[7]);
    }
    bool zero_grid = intra;
    if (use4 && mx == 0 && my == 0) {
      // the not_coded test of the JAX encoder reads this 4MV
      // macroblock's levels
      int plane, y, x;
      block_pixel(t, mbx, mby, plane, y, x);
      const int blk = t >> 6;
      const int h = plane ? a.mbh * 8 : H, w = plane ? a.mbw * 8 : W;
      const int vx = plane ? cmx : mv4[2 * blk];
      const int vy = plane ? cmy : mv4[2 * blk + 1];
      const int p = mc_sample(a.ref[plane], h, w, y, x, vx, vy, 0);
      X[t] = static_cast<double>(__ldg(a.cur[plane] + y * w + x) - p);
      __syncthreads();
      const double f = fdct(X, T, a.basis);
      if (quant_inter(f, a.q) != 0) atomicOr(&anynz, 1);
      __syncthreads();
      zero_grid = anynz == 0;
    }
    // the record: decisions, levels 0
    int16_t* rec = a.rec + static_cast<long long>(mby * a.mbw + mbx) * kRec;
    rec[t] = 0;
    if (t < kRec - kThreads) {
      const int f = kThreads + t;
      int v = 0;
      if (f == kMode) v = intra ? kIntra : (use4 ? kInter4 : kInter);
      else if (!intra && f == kMx) v = mx;
      else if (!intra && f == kMy) v = my;
      else if (!intra && f >= kFmv4 && f < kFmv4 + 8)
        v = use4 ? mv4[f - kFmv4] : ((f - kFmv4) & 1 ? my : mx);
      else if (!intra && f == kFcmv) v = cmx;
      else if (!intra && f == kFcmv + 1) v = cmy;
      rec[f] = static_cast<int16_t>(v);
    }
    if (t < 4) {
      const int gx = 2 * mbx + (t & 1), gy = 2 * mby + (t >> 1);
      int gvx = 0, gvy = 0;
      if (!zero_grid) {
        gvx = use4 ? mv4[2 * t] : mx;
        gvy = use4 ? mv4[2 * t + 1] : my;
      }
      a.grid[(gy * w2 + gx) * 2] = gvx;
      a.grid[(gy * w2 + gx) * 2 + 1] = gvy;
    }
    __syncthreads();
    if (t == 0) {
      __threadfence();
      atomicExch(a.sync + mby, mbx + 1);
    }
  }
}

// --------------------------------------------------------------------- //
// B-VOP decisions

struct BmeArgs {
  int16_t* rec;
  const uint8_t* cur[3];
  const uint8_t* fwd[3];
  const uint8_t* bwd[3];
  const int16_t* co;
  int mbw, mbh, trb, trd, search;
};

__global__ void __launch_bounds__(kThreads)
    mpeg4_bme_kernel(BmeArgs a) {
  __shared__ uint8_t win[2][kWin * kWin];
  __shared__ uint8_t cur[256];
  __shared__ int t16[2][kN16 * kN16];
  __shared__ int red[2 + 18];
  __shared__ int dv[16];     // direct vectors: forward 4 (x, y), backward 4
  __shared__ int st[16];     // fbx, fby, bbx, bby, fmx, fmy, bmx, bmy, pf, pb
  __shared__ int coskip;
  const int t = threadIdx.x;
  const int mby = blockIdx.x;
  const int H = a.mbh * 16, W = a.mbw * 16;
  const int lim = a.search;
  if (t < 4) st[8 + t] = 0;     // pf, pb
  for (int mbx = 0; mbx < a.mbw; ++mbx) {
    const int i = mby * a.mbw + mbx;
    const int16_t* co = a.co + static_cast<long long>(i) * kRec;
    const int x0 = mbx * 16, y0 = mby * 16;
    if (t < 8) {
      const int cm = co[kSkip] ? 0 : co[kFmv4 + t];
      dv[t] = a.trb * cm / a.trd;
      dv[8 + t] = (a.trb - a.trd) * cm / a.trd;
    }
    if (t == 0) coskip = co[kSkip] != 0;
    if (t < 20) red[t] = 0;
    __syncthreads();
    int16_t* rec = a.rec + static_cast<long long>(i) * kRec;
    rec[t] = 0;
    if (coskip) {
      if (t < kRec - kThreads) {
        const int f = kThreads + t;
        int v = 0;
        if (f == kMode) v = kCoskip;
        else if (f >= kFmv4 && f < kFmv4 + 8) v = dv[f - kFmv4];
        else if (f >= kBmv4 && f < kBmv4 + 8) v = dv[8 + f - kBmv4];
        else if (f == kFcmv) v = round_chroma(dv[0] + dv[2] + dv[4] + dv[6]);
        else if (f == kFcmv + 1)
          v = round_chroma(dv[1] + dv[3] + dv[5] + dv[7]);
        else if (f == kBcmv)
          v = round_chroma(dv[8] + dv[10] + dv[12] + dv[14]);
        else if (f == kBcmv + 1)
          v = round_chroma(dv[9] + dv[11] + dv[13] + dv[15]);
        rec[f] = static_cast<int16_t>(v);
      }
      __syncthreads();
      continue;
    }
    load_window(win[0], a.fwd[0], H, W, y0, x0);
    load_window(win[1], a.bwd[0], H, W, y0, x0);
    if (t < 256) cur[t] = __ldg(a.cur[0] + (y0 + (t >> 4)) * W + x0 + (t & 15));
    __syncthreads();
    for (int e = t; e < 2 * kN16 * kN16; e += kThreads) {
      const int ref = e / (kN16 * kN16), o = e % (kN16 * kN16);
      const int dy = o / kN16 - kR16, dx = o % kN16 - kR16;
      const uint8_t* wb = win[ref] + (dy + 16) * kWin + dx + 16;
      int s = 0;
      for (int py = 0; py < 16; ++py) {
        const uint8_t* cr = cur + py * 16;
        const uint8_t* wr = wb + py * kWin;
        for (int px = 0; px < 16; ++px) s += abs(cr[px] - wr[px]);
      }
      t16[ref][o] = s;
    }
    if (t < 256) {
      const int py = t >> 4, px = t & 15, k = (py >> 3) * 2 + (px >> 3);
      const int f = mc_sample(a.fwd[0], H, W, y0 + py, x0 + px, dv[2 * k],
                              dv[2 * k + 1], 0);
      const int b = mc_sample(a.bwd[0], H, W, y0 + py, x0 + px,
                              dv[8 + 2 * k], dv[9 + 2 * k], 0);
      const int v = warp_sum(abs(cur[t] - ((f + b + 1) >> 1)));
      if ((t & 31) == 0) atomicAdd(&red[0], v);
    }
    __syncthreads();
    if (t < 2) {
      // thread 0 the forward search, thread 1 the backward
      const int* tab = t16[t];
      auto sad16 = [&](int ix, int iy) {
        return tab[(iy + kR16) * kN16 + ix + kR16];
      };
      three_step(sad16, st[8 + 2 * t], st[9 + 2 * t], lim, st[2 * t],
                 st[2 * t + 1]);
    }
    __syncthreads();
    if (t < 256) {
      const int py = t >> 4, px = t & 15, cv = cur[t];
      for (int j = 0; j < 18; ++j) {
        const int ref = j / 9, jj = j % 9;
        const int mx = 2 * st[2 * ref] + jj / 3 - 1;
        const int my = 2 * st[2 * ref + 1] + jj % 3 - 1;
        int v = 0;
        if (mx >= -32 && mx <= 31 && my >= -32 && my <= 31)
          v = abs(cv - win_sample(win[ref], py, px, mx, my));
        v = warp_sum(v);
        if ((t & 31) == 0) atomicAdd(&red[2 + j], v);
      }
    }
    __syncthreads();
    if (t < 2) {
      int best = -1;
      for (int jj = 0; jj < 9; ++jj) {
        const int mx = 2 * st[2 * t] + jj / 3 - 1;
        const int my = 2 * st[2 * t + 1] + jj % 3 - 1;
        if (mx < -32 || mx > 31 || my < -32 || my > 31) continue;
        if (best < 0 || red[2 + 9 * t + jj] < red[2 + 9 * t + best])
          best = jj;
      }
      st[4 + 2 * t] = 2 * st[2 * t] + best / 3 - 1;
      st[5 + 2 * t] = 2 * st[2 * t + 1] + best % 3 - 1;
      st[12 + t] = red[2 + 9 * t + best];
    }
    __syncthreads();
    const int fmx = st[4], fmy = st[5], bmx = st[6], bmy = st[7];
    if (t < 256) {
      const int py = t >> 4, px = t & 15;
      const int fp = win_sample(win[0], py, px, fmx, fmy);
      const int bp = win_sample(win[1], py, px, bmx, bmy);
      const int v = warp_sum(abs(cur[t] - ((fp + bp + 1) >> 1)));
      if ((t & 31) == 0) atomicAdd(&red[1], v);
    }
    __syncthreads();
    // the cheapest of (direct, interpolated, backward, forward), ties to
    // the lower type
    const int costs[4] = {red[0] - 16, red[1] + 64, st[13] + 32, st[12] + 32};
    int type = 0;
    for (int j = 1; j < 4; ++j)
      if (costs[j] < costs[type]) type = j;
    if (t < kRec - kThreads) {
      const int f = kThreads + t;
      const bool uf = type == 1 || type == 3, ub = type == 1 || type == 2;
      int v = 0;
      if (f == kMode) v = kDirect + type;
      else if (f == kMx) v = fmx;
      else if (f == kMy) v = fmy;
      else if (f == kBmx) v = bmx;
      else if (f == kBmy) v = bmy;
      else if (type == 0) {
        if (f >= kFmv4 && f < kFmv4 + 8) v = dv[f - kFmv4];
        else if (f >= kBmv4 && f < kBmv4 + 8) v = dv[8 + f - kBmv4];
        else if (f == kFcmv) v = round_chroma(dv[0] + dv[2] + dv[4] + dv[6]);
        else if (f == kFcmv + 1)
          v = round_chroma(dv[1] + dv[3] + dv[5] + dv[7]);
        else if (f == kBcmv)
          v = round_chroma(dv[8] + dv[10] + dv[12] + dv[14]);
        else if (f == kBcmv + 1)
          v = round_chroma(dv[9] + dv[11] + dv[13] + dv[15]);
      } else {
        if (uf && f >= kFmv4 && f < kFmv4 + 8) v = (f - kFmv4) & 1 ? fmy : fmx;
        else if (ub && f >= kBmv4 && f < kBmv4 + 8)
          v = (f - kBmv4) & 1 ? bmy : bmx;
        else if (uf && f == kFcmv) v = single_chroma(fmx);
        else if (uf && f == kFcmv + 1) v = single_chroma(fmy);
        else if (ub && f == kBcmv) v = single_chroma(bmx);
        else if (ub && f == kBcmv + 1) v = single_chroma(bmy);
      }
      rec[f] = static_cast<int16_t>(v);
    }
    __syncthreads();
    if (t == 0) {
      if (type == 1 || type == 3) {
        st[8] = fmx;
        st[9] = fmy;
      }
      if (type == 1 || type == 2) {
        st[10] = bmx;
        st[11] = bmy;
      }
    }
    __syncthreads();
  }
}

}  // namespace

// meta: the decisions' records (0 for an I-VOP), the new records, cur
// y u v, fwd y u v (0 for an I-VOP), bwd y u v (0 unless a B-VOP), the
// reconstruction's y u v (0: none), mbw, mbh, q, vop_type; basis: the 64
// doubles of the forward DCT's _DCTM.
TC_API int tc_mpeg4_enc_blocks(const long long* m, const double* basis,
                               cudaStream_t stream) {
  BlockArgs a;
  a.rec = reinterpret_cast<const int16_t*>(m[0]);
  a.out = reinterpret_cast<int16_t*>(m[1]);
  for (int i = 0; i < 3; ++i) {
    a.cur[i] = reinterpret_cast<const uint8_t*>(m[2 + i]);
    a.fwd[i] = reinterpret_cast<const uint8_t*>(m[5 + i]);
    a.bwd[i] = reinterpret_cast<const uint8_t*>(m[8 + i]);
    a.recon[i] = reinterpret_cast<uint8_t*>(m[11 + i]);
  }
  a.mbw = static_cast<int>(m[14]);
  a.mbh = static_cast<int>(m[15]);
  a.q = static_cast<int>(m[16]);
  a.vop_type = static_cast<int>(m[17]);
  for (int i = 0; i < 64; ++i) a.basis[i] = basis[i];
  mpeg4_blocks_kernel<<<a.mbw * a.mbh, kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// meta: rec, cur y u v, ref y u v, mbw, mbh, q, four_mv, search, grid,
// sync (mbh + 1 ints, zeroed); basis as above.
TC_API int tc_mpeg4_enc_me(const long long* m, const double* basis,
                           cudaStream_t stream) {
  MeArgs a;
  a.rec = reinterpret_cast<int16_t*>(m[0]);
  for (int i = 0; i < 3; ++i) {
    a.cur[i] = reinterpret_cast<const uint8_t*>(m[1 + i]);
    a.ref[i] = reinterpret_cast<const uint8_t*>(m[4 + i]);
  }
  a.mbw = static_cast<int>(m[7]);
  a.mbh = static_cast<int>(m[8]);
  a.q = static_cast<int>(m[9]);
  a.four_mv = static_cast<int>(m[10]);
  a.search = static_cast<int>(m[11]);
  a.grid = reinterpret_cast<int*>(m[12]);
  a.sync = reinterpret_cast<int*>(m[13]);
  for (int i = 0; i < 64; ++i) a.basis[i] = basis[i];
  mpeg4_me_kernel<<<a.mbh, kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// meta: rec, cur y u v, fwd y u v, bwd y u v, co (the newer anchor's
// records), mbw, mbh, trb, trd, search.
TC_API int tc_mpeg4_enc_bme(const long long* m, cudaStream_t stream) {
  BmeArgs a;
  a.rec = reinterpret_cast<int16_t*>(m[0]);
  for (int i = 0; i < 3; ++i) {
    a.cur[i] = reinterpret_cast<const uint8_t*>(m[1 + i]);
    a.fwd[i] = reinterpret_cast<const uint8_t*>(m[4 + i]);
    a.bwd[i] = reinterpret_cast<const uint8_t*>(m[7 + i]);
  }
  a.co = reinterpret_cast<const int16_t*>(m[10]);
  a.mbw = static_cast<int>(m[11]);
  a.mbh = static_cast<int>(m[12]);
  a.trb = static_cast<int>(m[13]);
  a.trd = static_cast<int>(m[14]);
  a.search = static_cast<int>(m[15]);
  mpeg4_bme_kernel<<<a.mbh, kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}
