// Theora both ways for Hopper (sm_90a): the pixels of the port's ogg
// importer's Theora decode and of its theora encoder (io/theoracodec.py);
// the token coder is the host's (csrc/theora_host.cpp).
//
// Not TPU kernels: the JAX package's Theora is numpy (tcforge_tpu/io/
// theora.py and theoraenc.py).  A frame's blocks are numbered plane after
// plane, raster order in each plane; the planes are the coded frame's
// (bottom-up rows, whole macroblocks); 4:2:0, 4:2:2 or 4:4:4 (fmt 0, 2, 3).
//
// tc_theora_recon (_reconstruct): 8 threads a block, 32 blocks a CTA.  The
//   threads scatter the block's zigzag coefficients, each times its
//   quantizer entry (the DC at the first qi), into shared memory; thread r
//   runs the spec's 1-D IDCT on row r, thread c on column c, then adds its
//   column's prediction (128, or the half-pel prediction from last or
//   golden: whole part toward zero, signed half step, coordinates clamped
//   to the plane as the 32-sample edge padding reads them), clips and
//   stores.  numpy computes the IDCT in int32 with the cosine products
//   wrapping, so every sum and product here is taken in uint32 and only
//   the shifts in int32.  An uncoded block copies last.  Bound: bytes.
// tc_theora_loop_filter (_loop_filter): the filter runs in raster block
//   order in place; two blocks touch a common pixel only when they are
//   neighbours, and the anti-diagonal bx + 2 * by = t orders every pair of
//   neighbours as raster order does, so the blocks of one anti-diagonal
//   run at once, 8 threads a block (one line of an edge each), with a CTA
//   barrier between a block's four edges and between anti-diagonals: one
//   CTA a plane.  Bound: bytes.
// tc_theora_fdct_quant (_fdct_blocks, _quantize_blocks): one thread a
//   coefficient, the float64 sum in numpy's einsum order (n outer, m
//   inner, (B[k][n] * R[n][m]) * B[l][m] added in turn from 0) with every
//   product and sum rounded on its own (__dmul_rn, __dadd_rn: no fused
//   multiply-add), then the division, the rounding (half to even, or the
//   inter dead zone) and the clip, stored in zigzag order.  Bound:
//   operations (float64).
// tc_theora_me (_choose_modes, _search_mv): a CTA a macroblock computes its
//   SAD at all 63 x 63 half-pel vectors from a clamped 48 x 48 window of
//   the reference in shared memory, its four 8x8 SSEs against the
//   reference and its SAD from its mean; then one CTA walks the
//   macroblocks in coded order (the LAST/LAST2 chain and the search's
//   start make the walk serial): its first warp's thread 0 decides a
//   macroblock from its table row in shared memory while the other warps
//   copy the next row.  The float64 costs are rounded as Python rounds
//   them.  Bound: operations (the SADs).

#include <cstring>

#include "common.cuh"

namespace {

__constant__ int kZigzag[64] = {0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18,
                                11, 4,  5,  12, 19, 26, 33, 40, 48, 41, 34, 27, 20,
                                13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43,
                                36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45,
                                38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};
__constant__ int kFrameClass[8] = {1, 0, 1, 1, 1, 2, 2, 1};
// the encoder's motion vector code lengths, -31..31 (theoraenc._MV_CODES)
__constant__ int kMvBits[63] = {8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8,
                                7, 7, 7, 7, 7, 7, 7, 7, 6, 6, 6, 6, 4, 4, 3, 3,
                                3, 4, 4, 6, 6, 6, 6, 7, 7, 7, 7, 7, 7, 7, 7, 8,
                                8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8};

constexpr int kModeNoMv = 0, kModeIntra = 1, kModeMv = 2, kModeLast = 3, kModeLast2 = 4,
              kModeFourMv = 7;
constexpr int kMbCols = 9;
constexpr int kMeCols = 7;
constexpr int kSpan = 63;
constexpr int kTable = kSpan * kSpan;

struct Planes {
  int fmt, fw, fh;
  int h[3], w[3], bw[3], bh[3];
  long long off[3];  // the first block id of each plane
  long long total;
};

Planes planes_of(int fmt, int fw, int fh) {
  Planes g;
  g.fmt = fmt;
  g.fw = fw;
  g.fh = fh;
  for (int p = 0; p < 3; ++p) {
    g.w[p] = (p == 0 || fmt == 3) ? fw : fw / 2;
    g.h[p] = (p == 0 || fmt != 0) ? fh : fh / 2;
    g.bw[p] = g.w[p] / 8;
    g.bh[p] = g.h[p] / 8;
  }
  g.off[0] = 0;
  g.off[1] = static_cast<long long>(g.bw[0]) * g.bh[0];
  g.off[2] = g.off[1] + static_cast<long long>(g.bw[1]) * g.bh[1];
  g.total = g.off[2] + static_cast<long long>(g.bw[2]) * g.bh[2];
  return g;
}

__device__ __forceinline__ int32_t add32(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}
__device__ __forceinline__ int32_t sub32(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) - static_cast<uint32_t>(b));
}
__device__ __forceinline__ int32_t mul32(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) * static_cast<uint32_t>(b));
}
// (c * v) >> 16 with the product wrapped to int32
__device__ __forceinline__ int32_t cmul(int32_t c, int32_t v) { return mul32(c, v) >> 16; }

// the spec's 1-D IDCT (theora._idct_1d) in int32 with wrapping sums
__device__ void idct1d(int32_t* x) {
  const int32_t a = add32(cmul(64277, x[1]), cmul(12785, x[7]));
  const int32_t b = sub32(cmul(12785, x[1]), cmul(64277, x[7]));
  const int32_t c = add32(cmul(54491, x[3]), cmul(36410, x[5]));
  const int32_t d = sub32(cmul(54491, x[5]), cmul(36410, x[3]));
  const int32_t ad = cmul(46341, sub32(a, c));
  const int32_t bd = cmul(46341, sub32(b, d));
  const int32_t cd = add32(a, c);
  const int32_t dd = add32(b, d);
  const int32_t e = cmul(46341, add32(x[0], x[4]));
  const int32_t f = cmul(46341, sub32(x[0], x[4]));
  const int32_t g = add32(cmul(60547, x[2]), cmul(25080, x[6]));
  const int32_t h = sub32(cmul(25080, x[2]), cmul(60547, x[6]));
  const int32_t ed = sub32(e, g), gd = add32(e, g);
  const int32_t add = add32(f, ad), bdd = sub32(bd, h);
  const int32_t fd = sub32(f, ad), hd = add32(bd, h);
  x[0] = add32(gd, cd);
  x[7] = sub32(gd, cd);
  x[1] = add32(add, hd);
  x[2] = sub32(add, hd);
  x[3] = add32(ed, dd);
  x[4] = sub32(ed, dd);
  x[5] = add32(fd, bdd);
  x[6] = sub32(fd, bdd);
}

__device__ __forceinline__ int rshift_round(int a, int b) {
  const int half = 1 << (b - 1);
  return a > 0 ? (a + half) >> b : -((-a + half) >> b);
}

__device__ __forceinline__ int halve(int v) { return (v >> 1) | (v & 1); }

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return v < lo ? lo : (v > hi ? hi : v); }

struct ReconArgs {
  const int32_t* coefs;  // (total, 64) zigzag
  const uint8_t* coded;
  const uint8_t* qiidx;
  const int32_t* mbrec;  // (mbs, 9)
  const int32_t* qmats;  // (2, 3, 3, 64) raster
  const uint8_t* last[3];
  const uint8_t* golden[3];
  uint8_t* out[3];
  Planes g;
};

constexpr int kReconThreads = 256;
constexpr int kReconBlocks = kReconThreads / 8;

__global__ void __launch_bounds__(kReconThreads) theora_recon_kernel(ReconArgs a) {
  __shared__ int32_t ws[kReconBlocks][8][9];
  const int lb = threadIdx.x >> 3, t = threadIdx.x & 7;
  const long long gb = static_cast<long long>(blockIdx.x) * kReconBlocks + lb;
  const Planes& g = a.g;
  const bool live = gb < g.total;
  const bool intra = a.last[0] == nullptr;
  int p = 0, bx = 0, by = 0, mode = kModeIntra, mx = 0, my = 0;
  bool coded = false;
  if (live) {
    p = gb >= g.off[2] ? 2 : (gb >= g.off[1] ? 1 : 0);
    const long long k = gb - g.off[p];
    by = static_cast<int>(k / g.bw[p]);
    bx = static_cast<int>(k - static_cast<long long>(by) * g.bw[p]);
    coded = a.coded[gb] != 0;
    if (!intra) {
      const int mbw = g.fw / 16;
      int mb, sub = 0;
      if (p == 0 || g.fmt == 3) {
        mb = (by >> 1) * mbw + (bx >> 1);
        sub = (by & 1) * 2 + (bx & 1);
      } else if (g.fmt == 2) {
        mb = (by >> 1) * mbw + bx;
        sub = by & 1;
      } else {
        mb = by * mbw + bx;
      }
      const int32_t* r = a.mbrec + static_cast<long long>(mb) * kMbCols;
      mode = r[0] < 0 ? kModeNoMv : r[0];
      mx = r[1];
      my = r[2];
      if (mode == kModeFourMv) {
        if (p == 0 || g.fmt == 3) {
          mx = r[1 + 2 * sub];
          my = r[2 + 2 * sub];
        } else if (g.fmt == 0) {
          mx = rshift_round(r[1] + r[3] + r[5] + r[7], 2);
          my = rshift_round(r[2] + r[4] + r[6] + r[8], 2);
        } else {
          mx = rshift_round(r[1 + 4 * sub] + r[3 + 4 * sub], 1);
          my = rshift_round(r[2 + 4 * sub] + r[4 + 4 * sub], 1);
        }
      }
      if (p > 0) {
        if (g.fmt != 3) mx = halve(mx);
        if (g.fmt == 0) my = halve(my);
      }
    }
  }
  const bool work = live && (intra || coded);
  // dequantize: thread t scatters zigzag indices t, t + 8, ...
  if (work) {
    const int qti = mode == kModeIntra ? 0 : 1;
    const int qi = a.qiidx[gb] > 2 ? 2 : a.qiidx[gb];
    const int32_t* qm = a.qmats + ((qti * 3 + p) * 3 + qi) * 64;
    const int32_t* cz = a.coefs + gb * 64;
    for (int zi = t; zi < 64; zi += 8) {
      const int ri = kZigzag[zi];
      const int32_t q = zi == 0 ? a.qmats[((qti * 3 + p) * 3) * 64] : qm[ri];
      ws[lb][ri >> 3][ri & 7] = mul32(cz[zi], q);
    }
  }
  __syncthreads();
  if (work) {
    int32_t row[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) row[i] = ws[lb][t][i];
    idct1d(row);
#pragma unroll
    for (int i = 0; i < 8; ++i) ws[lb][t][i] = row[i];
  }
  __syncthreads();
  if (!live) return;
  const int w = g.w[p], h = g.h[p];
  uint8_t* dst = a.out[p];
  const int x = bx * 8 + t;
  if (!work) {  // an uncoded block keeps last
    for (int i = 0; i < 8; ++i) {
      const long long at = static_cast<long long>(by * 8 + i) * w + x;
      dst[at] = a.last[p][at];
    }
    return;
  }
  int32_t col[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) col[i] = ws[lb][i][t];
  idct1d(col);
  const int fc = intra ? 0 : kFrameClass[mode];
  const uint8_t* ref = fc == 2 ? a.golden[p] : a.last[p];
  const int wx = (mx + (mx < 0 ? 1 : 0)) >> 1, wy = (my + (my < 0 ? 1 : 0)) >> 1;
  const int rx = mx - 2 * wx, ry = my - 2 * wy;
  for (int i = 0; i < 8; ++i) {
    const int32_t res = add32(col[i], 8) >> 4;
    int32_t v;
    if (fc == 0) {
      v = add32(res, 128);
    } else {
      const int gy = by * 8 + i + wy, gx = x + wx;
      int pred = ref[static_cast<long long>(clampi(gy, 0, h - 1)) * w + clampi(gx, 0, w - 1)];
      if (rx || ry) {
        const int p2 = ref[static_cast<long long>(clampi(gy + ry, 0, h - 1)) * w +
                           clampi(gx + rx, 0, w - 1)];
        pred = (pred + p2) >> 1;
      }
      v = add32(pred, res);
    }
    dst[static_cast<long long>(by * 8 + i) * w + x] = static_cast<uint8_t>(clampi(v, 0, 255));
  }
}

struct FilterArgs {
  uint8_t* planes[3];
  const uint8_t* coded;
  int lim;
  Planes g;
};

constexpr int kFilterThreads = 512;
constexpr int kFilterSlots = kFilterThreads / 8;

__device__ __forceinline__ int bound(int f, int lim) {
  const int a = f < 0 ? -f : f;
  const int r = a < lim ? a : (a < 2 * lim ? 2 * lim - a : 0);
  return f < 0 ? -r : r;
}

// one line of an edge: the four samples across it at q0 - 2s .. q0 + s
__device__ __forceinline__ void filter_line(uint8_t* q, long long s, int lim) {
  const int a = q[-2 * s], b = q[-s], c = q[0], d = q[s];
  const int f = (a - d) + 3 * (c - b);
  const int r = bound((f + 4) >> 3, lim);
  q[-s] = static_cast<uint8_t>(clampi(b + r, 0, 255));
  q[0] = static_cast<uint8_t>(clampi(c - r, 0, 255));
}

__global__ void __launch_bounds__(kFilterThreads) theora_loop_filter_kernel(FilterArgs a) {
  const int p = blockIdx.x;
  const Planes& g = a.g;
  const int bw = g.bw[p], bh = g.bh[p], w = g.w[p];
  uint8_t* pl = a.planes[p];
  const uint8_t* cd = a.coded + g.off[p];
  const int slot = threadIdx.x >> 3, line = threadIdx.x & 7;
  const int steps = bw + 2 * (bh - 1);
  for (int t = 0; t < steps; ++t) {
    // the anti-diagonal's blocks: by from lo to hi, bx = t - 2 * by
    const int lo = t - bw + 1 > 0 ? (t - bw + 2) / 2 : 0;
    const int hi = t / 2 < bh - 1 ? t / 2 : bh - 1;
    for (int first = lo; first <= hi; first += kFilterSlots) {
      const int by = first + slot, bx = t - 2 * by;
      const bool on = by <= hi && cd[static_cast<long long>(by) * bw + bx];
      const long long bid = static_cast<long long>(by) * bw + bx;
      const int x0 = bx * 8, y0 = by * 8;
      if (on && bx > 0) filter_line(pl + static_cast<long long>(y0 + line) * w + x0, 1, a.lim);
      __syncthreads();
      if (on && by > 0) filter_line(pl + static_cast<long long>(y0) * w + x0 + line, w, a.lim);
      __syncthreads();
      if (on && bx < bw - 1 && !cd[bid + 1])
        filter_line(pl + static_cast<long long>(y0 + line) * w + x0 + 8, 1, a.lim);
      __syncthreads();
      if (on && by < bh - 1 && !cd[bid + bw])
        filter_line(pl + static_cast<long long>(y0 + 8) * w + x0 + line, w, a.lim);
      __syncthreads();
    }
  }
}

struct FdctArgs {
  const int16_t* resid;  // (n, 64) raster
  const uint8_t* group;  // qti * 3 + plane
  const int32_t* qmat;   // (2, 3, 64) raster
  const double* basis;   // (8, 8)
  int32_t* out;          // (n, 64) zigzag
  long long n;
};

constexpr int kFdctThreads = 256;
constexpr int kFdctBlocks = kFdctThreads / 64;

__global__ void __launch_bounds__(kFdctThreads) theora_fdct_kernel(FdctArgs a) {
  __shared__ double r[kFdctBlocks][64];
  __shared__ double bs[64];
  const int lb = threadIdx.x >> 6, zi = threadIdx.x & 63;
  const long long blk = static_cast<long long>(blockIdx.x) * kFdctBlocks + lb;
  if (threadIdx.x < 64) bs[threadIdx.x] = a.basis[threadIdx.x];
  if (blk < a.n) r[lb][zi] = static_cast<double>(a.resid[blk * 64 + zi]);
  __syncthreads();
  if (blk >= a.n) return;
  const int ri = kZigzag[zi], k = ri >> 3, l = ri & 7;
  double s = 0.0;
  for (int n = 0; n < 8; ++n) {
    const double bkn = bs[k * 8 + n];
    for (int m = 0; m < 8; ++m)
      s = __dadd_rn(s, __dmul_rn(__dmul_rn(bkn, r[lb][n * 8 + m]), bs[l * 8 + m]));
  }
  const int grp = a.group[blk];
  const double x = __dmul_rn(16.0, s);
  const double tq = __ddiv_rn(x, static_cast<double>(a.qmat[grp * 64 + ri]));
  double q;
  if (grp >= 3) {
    const double fl = floor(__dadd_rn(fabs(tq), 0.3));
    q = tq > 0.0 ? fl : (tq < 0.0 ? -fl : 0.0);
  } else {
    q = rint(tq);
  }
  q = q > 580.0 ? 580.0 : (q < -580.0 ? -580.0 : q);
  a.out[blk * 64 + zi] = static_cast<int32_t>(q);
}

struct MeArgs {
  const uint8_t* src;  // (h, w) coded luma
  const uint8_t* ref;  // (h, w) the reconstruction
  const int32_t* order;
  int32_t* table;  // (mbs, 63 * 63)
  int32_t* stats;  // (mbs, 5): four 8x8 SSEs, the SAD from the mean
  int32_t* out;    // (mbs, 7)
  int h, w, mbw, nmb;
  double lam, sse_floor;
};

constexpr int kSadThreads = 256;
constexpr int kWin = 48;

__global__ void __launch_bounds__(kSadThreads) theora_sad_kernel(MeArgs a) {
  __shared__ uint8_t win[kWin][kWin];
  __shared__ int16_t cur[16][16];
  __shared__ int red[5][kSadThreads / 32];
  __shared__ int mean;
  const int mb = blockIdx.x;
  const int mby = mb / a.mbw, mbx = mb - mby * a.mbw;
  const int y0 = mby * 16, x0 = mbx * 16;
  for (int i = threadIdx.x; i < kWin * kWin; i += kSadThreads) {
    const int wr = i / kWin, wc = i - wr * kWin;
    const int yy = clampi(y0 - 16 + wr, 0, a.h - 1), xx = clampi(x0 - 16 + wc, 0, a.w - 1);
    win[wr][wc] = a.ref[static_cast<long long>(yy) * a.w + xx];
  }
  {
    const int r = threadIdx.x >> 4, c = threadIdx.x & 15;
    cur[r][c] = a.src[static_cast<long long>(y0 + r) * a.w + x0 + c];
  }
  __syncthreads();
  // the statistics: pixel threadIdx.x of the macroblock
  {
    const int r = threadIdx.x >> 4, c = threadIdx.x & 15;
    const int s = cur[r][c];
    const int d = s - win[16 + r][16 + c];
    const int quad = (r >> 3) * 2 + (c >> 3);
    int v[5];
    for (int q = 0; q < 4; ++q) v[q] = q == quad ? d * d : 0;
    v[4] = s;
    for (int q = 0; q < 5; ++q) {
      int x = v[q];
      for (int o = 16; o; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
      if ((threadIdx.x & 31) == 0) red[q][threadIdx.x >> 5] = x;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      int sum = 0;
      for (int i = 0; i < kSadThreads / 32; ++i) sum += red[4][i];
      mean = sum / 256;
      for (int q = 0; q < 4; ++q) {
        int e = 0;
        for (int i = 0; i < kSadThreads / 32; ++i) e += red[q][i];
        a.stats[static_cast<long long>(mb) * 5 + q] = e;
      }
    }
    __syncthreads();
    int x = abs(s - mean);
    for (int o = 16; o; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    if ((threadIdx.x & 31) == 0) red[0][threadIdx.x >> 5] = x;
    __syncthreads();
    if (threadIdx.x == 0) {
      int e = 0;
      for (int i = 0; i < kSadThreads / 32; ++i) e += red[0][i];
      a.stats[static_cast<long long>(mb) * 5 + 4] = e;
    }
  }
  int32_t* row = a.table + static_cast<long long>(mb) * kTable;
  for (int i = threadIdx.x; i < kTable; i += kSadThreads) {
    const int my = i / kSpan - 31, mx = i % kSpan - 31;
    const int wx = (mx + (mx < 0 ? 1 : 0)) >> 1, wy = (my + (my < 0 ? 1 : 0)) >> 1;
    const int rx = mx - 2 * wx, ry = my - 2 * wy;
    int sad = 0;
    if (rx || ry) {
      for (int r = 0; r < 16; ++r) {
        const uint8_t* p1 = &win[16 + r + wy][16 + wx];
        const uint8_t* p2 = &win[16 + r + wy + ry][16 + wx + rx];
        for (int c = 0; c < 16; ++c) sad += abs(cur[r][c] - ((p1[c] + p2[c]) >> 1));
      }
    } else {
      for (int r = 0; r < 16; ++r) {
        const uint8_t* p1 = &win[16 + r + wy][16 + wx];
        for (int c = 0; c < 16; ++c) sad += abs(cur[r][c] - p1[c]);
      }
    }
    row[i] = sad;
  }
}

__device__ __forceinline__ int tab(const int32_t* t, int mx, int my) {
  return t[(my + 31) * kSpan + mx + 31];
}

__device__ __forceinline__ double cost(int sad, double lam, int k) {
  return __dadd_rn(static_cast<double>(sad), __dmul_rn(lam, static_cast<double>(k)));
}

constexpr int kWalkThreads = 256;

__global__ void __launch_bounds__(kWalkThreads) theora_walk_kernel(MeArgs a) {
  __shared__ int32_t buf[2][kTable];
  const int first = a.order[0];
  for (int i = threadIdx.x; i < kTable; i += kWalkThreads)
    buf[0][i] = a.table[static_cast<long long>(first) * kTable + i];
  __syncthreads();
  int lx = 0, ly = 0, l2x = 0, l2y = 0;  // the chain (thread 0)
  for (int k = 0; k < a.nmb; ++k) {
    const int cb = k & 1;
    if (threadIdx.x >= 32) {  // the other warps copy the next row
      if (k + 1 < a.nmb) {
        const long long nxt = static_cast<long long>(a.order[k + 1]) * kTable;
        for (int i = threadIdx.x - 32; i < kTable; i += kWalkThreads - 32)
          buf[cb ^ 1][i] = a.table[nxt + i];
      }
    } else if (threadIdx.x == 0) {
      const int mb = a.order[k];
      const int32_t* t = buf[cb];
      const int32_t* st = a.stats + static_cast<long long>(mb) * 5;
      int32_t* o = a.out + static_cast<long long>(mb) * kMeCols;
      bool any = false;
      for (int q = 0; q < 4; ++q) {
        const bool c = static_cast<double>(st[q]) > a.sse_floor;
        o[3 + q] = c;
        any = any || c;
      }
      if (!any) {
        o[0] = -1;
        o[1] = o[2] = 0;
      } else {
        double best = cost(tab(t, 0, 0), a.lam, 2);
        int mode = kModeNoMv, bx = 0, by = 0;
        if (lx || ly) {
          const double c = cost(tab(t, lx, ly), a.lam, 2);
          if (c < best) best = c, mode = kModeLast, bx = lx, by = ly;
        }
        if ((l2x || l2y) && (l2x != lx || l2y != ly)) {
          const double c = cost(tab(t, l2x, l2y), a.lam, 3);
          if (c < best) best = c, mode = kModeLast2, bx = l2x, by = l2y;
        }
        // _search_mv from the best of (0, 0) and the chain's vector
        int wx = 0, wy = 0, bsad = tab(t, 0, 0);
        const int sx = lx >> 1, sy = ly >> 1;
        if ((sx || sy) && abs(sx) <= 15 && abs(sy) <= 15) {
          const int s = tab(t, 2 * sx, 2 * sy);
          if (s < bsad) wx = sx, wy = sy, bsad = s;
        }
        for (int step = 8; step; step >>= 1) {
          bool improved = true;
          while (improved) {
            improved = false;
            for (int dy = -step; dy <= step; dy += step)
              for (int dx = -step; dx <= step; dx += step) {
                if (!dx && !dy) continue;
                const int nx = wx + dx, ny = wy + dy;
                if (abs(nx) > 15 || abs(ny) > 15) continue;
                const int s = tab(t, 2 * nx, 2 * ny);
                if (s < bsad) wx = nx, wy = ny, bsad = s, improved = true;
              }
          }
        }
        int mvx = 2 * wx, mvy = 2 * wy;
        for (int dy = -1; dy <= 1; ++dy)
          for (int dx = -1; dx <= 1; ++dx) {
            if (!dx && !dy) continue;
            const int nx = mvx + dx, ny = mvy + dy;
            if (abs(nx) > 31 || abs(ny) > 31) continue;
            const int s = tab(t, nx, ny);
            if (s < bsad) mvx = nx, mvy = ny, bsad = s;
          }
        if (mvx || mvy) {
          const double c = cost(bsad, a.lam, 4 + kMvBits[mvx + 31] + kMvBits[mvy + 31]);
          if (c < best) best = c, mode = kModeMv, bx = mvx, by = mvy;
        }
        {
          const double c = cost(st[4], a.lam, 6);
          if (c < best) best = c, mode = kModeIntra, bx = 0, by = 0;
        }
        o[0] = mode;
        o[1] = bx;
        o[2] = by;
        if (mode == kModeMv) {
          l2x = lx, l2y = ly;
          lx = bx, ly = by;
        } else if (mode == kModeLast2) {
          const int tx = lx, ty = ly;
          lx = l2x, ly = l2y;
          l2x = tx, l2y = ty;
        }
      }
    }
    __syncthreads();
  }
}

}  // namespace

// meta: coefs, coded, qiidx, mbrec, qmats, last Y U V, golden Y U V (all 0
// for an intra frame), out Y U V, fmt, frame width, frame height.
TC_API int tc_theora_recon(const long long* meta, cudaStream_t stream) {
  ReconArgs a;
  a.coefs = reinterpret_cast<const int32_t*>(meta[0]);
  a.coded = reinterpret_cast<const uint8_t*>(meta[1]);
  a.qiidx = reinterpret_cast<const uint8_t*>(meta[2]);
  a.mbrec = reinterpret_cast<const int32_t*>(meta[3]);
  a.qmats = reinterpret_cast<const int32_t*>(meta[4]);
  for (int p = 0; p < 3; ++p) {
    a.last[p] = reinterpret_cast<const uint8_t*>(meta[5 + p]);
    a.golden[p] = reinterpret_cast<const uint8_t*>(meta[8 + p]);
    a.out[p] = reinterpret_cast<uint8_t*>(meta[11 + p]);
  }
  a.g = planes_of(static_cast<int>(meta[14]), static_cast<int>(meta[15]),
                  static_cast<int>(meta[16]));
  theora_recon_kernel<<<tc_blocks(a.g.total, kReconBlocks), kReconThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// meta: the Y, U and V planes (filtered in place), coded, lim, fmt, frame
// width, frame height.
TC_API int tc_theora_loop_filter(const long long* meta, cudaStream_t stream) {
  FilterArgs a;
  for (int p = 0; p < 3; ++p) a.planes[p] = reinterpret_cast<uint8_t*>(meta[p]);
  a.coded = reinterpret_cast<const uint8_t*>(meta[3]);
  a.lim = static_cast<int>(meta[4]);
  a.g = planes_of(static_cast<int>(meta[5]), static_cast<int>(meta[6]),
                  static_cast<int>(meta[7]));
  theora_loop_filter_kernel<<<3, kFilterThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// meta: resid, group, qmat, basis, out, n.
TC_API int tc_theora_fdct_quant(const long long* meta, cudaStream_t stream) {
  FdctArgs a;
  a.resid = reinterpret_cast<const int16_t*>(meta[0]);
  a.group = reinterpret_cast<const uint8_t*>(meta[1]);
  a.qmat = reinterpret_cast<const int32_t*>(meta[2]);
  a.basis = reinterpret_cast<const double*>(meta[3]);
  a.out = reinterpret_cast<int32_t*>(meta[4]);
  a.n = meta[5];
  theora_fdct_kernel<<<tc_blocks(a.n, kFdctBlocks), kFdctThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// meta: src, ref, order, table, stats, out, height, width, and the bits of
// the float64 lam and sse_floor.
TC_API int tc_theora_me(const long long* meta, cudaStream_t stream) {
  MeArgs a;
  a.src = reinterpret_cast<const uint8_t*>(meta[0]);
  a.ref = reinterpret_cast<const uint8_t*>(meta[1]);
  a.order = reinterpret_cast<const int32_t*>(meta[2]);
  a.table = reinterpret_cast<int32_t*>(meta[3]);
  a.stats = reinterpret_cast<int32_t*>(meta[4]);
  a.out = reinterpret_cast<int32_t*>(meta[5]);
  a.h = static_cast<int>(meta[6]);
  a.w = static_cast<int>(meta[7]);
  a.mbw = a.w / 16;
  a.nmb = a.mbw * (a.h / 16);
  std::memcpy(&a.lam, &meta[8], sizeof(double));
  std::memcpy(&a.sse_floor, &meta[9], sizeof(double));
  theora_sad_kernel<<<a.nmb, kSadThreads, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  theora_walk_kernel<<<1, kWalkThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}
