// The MPEG-2 encoder's device math for Hopper (sm_90a): motion search,
// prediction and block coding.
//
// Not TPU kernels: the JAX package runs this math as XLA ops on a device
// (tcforge_tpu/io/mpeg2enc.py motion_search, halfpel_refine,
// _p_inter_math, _b_code_math) and, on the CPU, through its native
// library (native/tcforge_host.cpp), whose results these kernels give
// bit for bit.  A picture is a handful of launches; the host codes its
// levels between pictures, so the encoder's serial chain is held by the
// host's wait for each picture, not by these kernels' time.
//
// tc_mpeg2_me (tc_me16_refine :994 over me16_int :770): one block of 256
// threads per 16x16 macroblock and reference.  The candidates of each
// stage are spread over groups of 8 threads (two rows of 16 each for a
// 16x16 SAD, one row of 8 for the decimated 8x8); a candidate's key is
// (sad << 32 | index), so the block's minimum key is the first strict
// minimum in the candidate order (dy-major, then dx), as the native
// loops take it.  Stages: for r <= 4 the exhaustive +-r search
// (me_exhaustive :645); else the exhaustive +-(r+1)/2 search of the
// macroblock's 8x8 block of the 2x2-decimated planes ((a+b+c+d+2)>>2,
// me_dec2 :752; the reference window decimated into shared memory),
// candidates leaving the decimated plane at 1 << 30, then the +-2 refine
// at full resolution around twice that vector, each vector clamped to
// +-r, candidates leaving the plane at 1 << 30; then the 3x3 half-pel
// refine (sad_halfpel_mb :907) with the decoder's rounding.  Bound by
// the latency of each stage's dependent sums and reductions: the whole
// search of a 720x480 picture is some 20 M byte differences.
//
// tc_mpeg2_enc_pred (mc_pred_mb :1446, tc_b_mc_sel_pred2 :1593): one
// thread per predicted sample, the three planes in one launch; the
// half-pel average of the 1, 2 or 4 neighbours, each coordinate
// clamped into the plane on its own; chroma vectors are the luma vectors
// halved toward 0 over 8x8 tiles, or at 4:2:2 (chroma planes of the
// luma's height, tcforge_tpu/io/mpeg2enc.py:530-542) the horizontal
// component alone over 8-wide, 16-tall tiles; in a B picture the
// macroblock's mode picks the forward, the backward or their average
// (f + b + 1) >> 1.
// tc_mpeg2_enc_bmode (tc_bisad :1638 of two predictions): one block per
// macroblock, the bi-average SAD, then the first minimum of (fsad, bsad,
// bisad - 256).  Bound by bytes.
//
// tc_mpeg2_enc_blocks (enc_intra_block :1202, tc_enc_inter_plane :1326,
// tc_enc_intra_sel :1311, tc_enc_inter_levels :1406): 64 threads per 8x8
// block, four blocks a 256-thread block, all three planes in one launch.
// The float64 separable DCT in the order of the native library's AVX-512
// form (fdct8x8 / idct8x8_d :1052-1098): each sum an explicit chain of
// __fma_rn over k = 0..7 from 0, which no compiler contraction can
// change; rint for nearbyint; a true division (__ddiv_rn) for the intra
// quantiser coef * 32 / (2 W 2qs).  The quantiser, the dequantiser
// (truncating division; MPEG-1 oddification or the 13818-2 mismatch
// control on the block's sum), the clipped reconstruction (an inter
// block whose levels are all zero reconstructs to its prediction), and
// the levels in scan order at lv_index's macroblock-interleaved slots.
// A P picture's intra macroblocks (a mask) are coded intra in the same
// launch, as tc_enc_intra_sel recodes them.  Pictures may be 4:2:2
// (chroma planes of the luma's height), intra or inter: eight blocks a
// macroblock, each chroma plane's two stacked blocks at slots
// 4 + 2 * row + plane (Cb4 Cr5 Cb6 Cr7, tcforge_tpu/io/mpeg2enc.py:653-667
// lv_index -3, 14, 15), and a P picture's intra macroblock covers both
// of a chroma plane's blocks.  Bound by float64 operations (2 x 1024
// fused multiply-adds a block).
//
// Every entry point reads its arguments from an array of 64-bit values
// on the host (pointers, strides, sizes) and returns cudaGetLastError()
// after its launch.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 8;              // threads per candidate
constexpr int kGroups = kThreads / kGroup;
constexpr int kInvalid = 1 << 30;
constexpr int kMaxRange = 64;          // ops/kernels.py ME_MAX_RANGE
constexpr int kMaxCoarse = (kMaxRange + 1) / 2;
constexpr int kWin = 8 + 2 * kMaxCoarse;   // decimated window side
constexpr unsigned long long kNoKey = ~0ull;

__device__ __forceinline__ int absi(int v) { return v < 0 ? -v : v; }
__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ unsigned long long key_of(int sad, int index) {
  return (static_cast<unsigned long long>(static_cast<unsigned>(sad)) << 32)
         | static_cast<unsigned>(index);
}

// The sum of v over the 8 lanes of a candidate's group.
__device__ __forceinline__ int group_sum(int v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v;
}

// The smallest key over the block; every thread gets it.
__device__ unsigned long long block_min(unsigned long long v,
                                        unsigned long long* red) {
  for (int o = 16; o; o >>= 1) {
    const unsigned long long u = __shfl_xor_sync(0xffffffffu, v, o);
    v = u < v ? u : v;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kThreads / 32 ? red[lane] : kNoKey;
    for (int o = 16; o; o >>= 1) {
      const unsigned long long u = __shfl_xor_sync(0xffffffffu, v, o);
      v = u < v ? u : v;
    }
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  return red[0];
}

// ---------------------------------------------------------------------
// Motion search

struct MeArgs {
  const uint8_t* cur;
  long long cur_stride;
  const uint8_t* ref[2];
  long long ref_stride[2];
  int h, w, r;
  int* mv;     // (nref, mbh, mbw, 2) half-pel (y, x)
  int* sad;    // (nref, mbh, mbw)
};

// Rows lane*2 and lane*2+1 of a 16x16 SAD at full resolution.
__device__ __forceinline__ int sad16_rows(const uint8_t* ref, long long rs,
                                          int y, int x, int lane,
                                          const uint8_t (*cur)[16]) {
  int s = 0;
  for (int rr = 0; rr < 2; ++rr) {
    const int row = lane * 2 + rr;
    const uint8_t* p = ref + (y + row) * rs + x;
    for (int c = 0; c < 16; ++c) s += absi(int(p[c]) - int(cur[row][c]));
  }
  return s;
}

// The same at a half-pel vector (vy, vx) relative to (y0, x0).
__device__ __forceinline__ int sad16_half_rows(const uint8_t* ref,
                                               long long rs, int y0, int x0,
                                               int vy, int vx, int lane,
                                               const uint8_t (*cur)[16]) {
  const int iy = vy >> 1, ix = vx >> 1, hy = vy & 1, hx = vx & 1;
  int s = 0;
  for (int rr = 0; rr < 2; ++rr) {
    const int row = lane * 2 + rr;
    const uint8_t* a = ref + (y0 + row + iy) * rs + x0 + ix;
    const uint8_t* b = hy ? a + rs : a;
    for (int c = 0; c < 16; ++c) {
      int p;
      if (hy && hx)
        p = (int(a[c]) + int(a[c + 1]) + int(b[c]) + int(b[c + 1]) + 2) >> 2;
      else if (hx)
        p = (int(a[c]) + int(a[c + 1]) + 1) >> 1;
      else if (hy)
        p = (int(a[c]) + int(b[c]) + 1) >> 1;
      else
        p = a[c];
      s += absi(p - int(cur[row][c]));
    }
  }
  return s;
}

__global__ void __launch_bounds__(kThreads) me_kernel(MeArgs a) {
  __shared__ uint8_t cur[16][16];
  __shared__ uint8_t dcur[8][8];
  __shared__ uint8_t dwin[kWin * kWin];
  __shared__ unsigned long long red[kThreads / 32];
  const int bx = blockIdx.x, by = blockIdx.y, k = blockIdx.z;
  const int mbw = gridDim.x, mbh = gridDim.y;
  const int h = a.h, w = a.w, r = a.r;
  const int y0 = by * 16, x0 = bx * 16;
  const uint8_t* ref = a.ref[k];
  const long long rs = a.ref_stride[k];
  const int t = threadIdx.x, g = t / kGroup, lane = t % kGroup;
  cur[t >> 4][t & 15] = a.cur[(y0 + (t >> 4)) * a.cur_stride + x0 + (t & 15)];
  __syncthreads();

  int ivy, ivx;
  if (r <= 4) {
    // exhaustive +-r at full resolution
    const int n = 2 * r + 1;
    unsigned long long best = kNoKey;
    // every lane runs every round (the group sums shuffle whole warps)
    for (int c0 = 0; c0 < n * n; c0 += kGroups) {
      const int c = c0 + g, dy = c / n - r, dx = c % n - r;
      const bool ok = c < n * n && y0 + dy >= 0 && y0 + 16 + dy <= h
                      && x0 + dx >= 0 && x0 + 16 + dx <= w;
      const int s = group_sum(
          ok ? sad16_rows(ref, rs, y0 + dy, x0 + dx, lane, cur) : 0);
      const unsigned long long kk = c < n * n ? key_of(ok ? s : kInvalid, c)
                                              : kNoKey;
      best = kk < best ? kk : best;
    }
    const int c = static_cast<int>(block_min(best, red) & 0xffffffffu);
    ivy = c / n - r;
    ivx = c % n - r;
  } else {
    // the 2x2-decimated planes: this macroblock's 8x8 block and the
    // reference window of +-R around it (only its in-plane samples are
    // read by a valid candidate)
    const int R = (r + 1) / 2, n = 2 * R + 1, side = 8 + 2 * R;
    const int h2 = h / 2, w2 = w / 2, by8 = by * 8, bx8 = bx * 8;
    if (t < 64) {
      const int i = t >> 3, j = t & 7;
      dcur[i][j] = static_cast<uint8_t>(
          (int(cur[2 * i][2 * j]) + int(cur[2 * i][2 * j + 1])
           + int(cur[2 * i + 1][2 * j]) + int(cur[2 * i + 1][2 * j + 1]) + 2)
          >> 2);
    }
    for (int e = t; e < side * side; e += kThreads) {
      const int wy = by8 - R + e / side, wx = bx8 - R + e % side;
      uint8_t v = 0;
      if (wy >= 0 && wy < h2 && wx >= 0 && wx < w2) {
        const uint8_t* p = ref + (2 * wy) * rs + 2 * wx;
        v = static_cast<uint8_t>(
            (int(p[0]) + int(p[1]) + int(p[rs]) + int(p[rs + 1]) + 2) >> 2);
      }
      dwin[e] = v;
    }
    __syncthreads();
    unsigned long long best = kNoKey;
    for (int c0 = 0; c0 < n * n; c0 += kGroups) {
      const int c = c0 + g, dy = c / n - R, dx = c % n - R;
      const bool ok = c < n * n && by8 + dy >= 0 && by8 + 8 + dy <= h2
                      && bx8 + dx >= 0 && bx8 + 8 + dx <= w2;
      int s = 0;
      if (ok) {
        const uint8_t* p = dwin + (R + dy + lane) * side + R + dx;
        for (int j = 0; j < 8; ++j) s += absi(int(p[j]) - int(dcur[lane][j]));
      }
      s = group_sum(s);
      const unsigned long long kk = c < n * n ? key_of(ok ? s : kInvalid, c)
                                              : kNoKey;
      best = kk < best ? kk : best;
    }
    const int cc = static_cast<int>(block_min(best, red) & 0xffffffffu);
    const int basey = 2 * (cc / n - R), basex = 2 * (cc % n - R);
    // +-2 at full resolution, each vector clamped to +-r
    {
      const int vy = clampi(basey + g / 5 - 2, -r, r);
      const int vx = clampi(basex + g % 5 - 2, -r, r);
      const bool ok = g < 25 && y0 + vy >= 0 && y0 + 16 + vy <= h
                      && x0 + vx >= 0 && x0 + 16 + vx <= w;
      const int s = group_sum(
          ok ? sad16_rows(ref, rs, y0 + vy, x0 + vx, lane, cur) : 0);
      best = g < 25 ? key_of(ok ? s : kInvalid, g) : kNoKey;
    }
    const int c = static_cast<int>(block_min(best, red) & 0xffffffffu);
    ivy = clampi(basey + c / 5 - 2, -r, r);
    ivx = clampi(basex + c % 5 - 2, -r, r);
  }

  // the 3x3 half-pel refine around twice the integer vector
  unsigned long long best;
  {
    const int vy = 2 * ivy + g / 3 - 1, vx = 2 * ivx + g % 3 - 1;
    const bool ok = g < 9 && y0 + (vy >> 1) >= 0
                    && y0 + 16 + (vy >> 1) + (vy & 1) <= h
                    && x0 + (vx >> 1) >= 0
                    && x0 + 16 + (vx >> 1) + (vx & 1) <= w;
    const int s = group_sum(
        ok ? sad16_half_rows(ref, rs, y0, x0, vy, vx, lane, cur) : 0);
    best = g < 9 ? key_of(ok ? s : kInvalid, g) : kNoKey;
  }
  const unsigned long long kk = block_min(best, red);
  if (t == 0) {
    const int c = static_cast<int>(kk & 0xffffffffu);
    const long long i = (static_cast<long long>(k) * mbh + by) * mbw + bx;
    a.mv[i * 2 + 0] = 2 * ivy + c / 3 - 1;
    a.mv[i * 2 + 1] = 2 * ivx + c % 3 - 1;
    a.sad[i] = static_cast<int>(kk >> 32);
  }
}

// ---------------------------------------------------------------------
// Prediction

// The half-pel prediction of sample (y, x) of an (h, w) plane at vector
// (vy, vx), each coordinate clamped on its own.
__device__ __forceinline__ int half_pel(const uint8_t* p, long long s, int h,
                                        int w, int y, int x, int vy, int vx) {
  const int yy = y + (vy >> 1), xx = x + (vx >> 1);
  const int hy = vy & 1, hx = vx & 1;
  const int ya = clampi(yy, 0, h - 1), yb = clampi(yy + 1, 0, h - 1);
  const int xa = clampi(xx, 0, w - 1), xb = clampi(xx + 1, 0, w - 1);
  const int pa = p[ya * s + xa];
  if (hy && hx)
    return (pa + int(p[ya * s + xb]) + int(p[yb * s + xa])
            + int(p[yb * s + xb]) + 2) >> 2;
  if (hx) return (pa + int(p[ya * s + xb]) + 1) >> 1;
  if (hy) return (pa + int(p[yb * s + xa]) + 1) >> 1;
  return pa;
}

struct PredPlane {
  const uint8_t* f;
  long long fs;
  const uint8_t* b;
  long long bs;
  uint8_t* out;
  int h, w;
};

struct PredArgs {
  PredPlane pl[3];
  int nplanes, mbw;
  int c422;            // chroma planes of the luma's height
  const int* fmv;      // (mbh, mbw, 2) luma half-pel vectors
  const int* bmv;
  const int* mode;     // (mbh, mbw) or null: forward only
  long long start[4];  // first sample of each plane in the launch
};

// plane k's vector (vy, vx) from a luma one: chroma halves both
// components toward 0 (C division by the constant 2) at 4:2:0, the
// horizontal one alone at 4:2:2
__device__ __forceinline__ void chroma_vec(int k, int c422, int& vy,
                                           int& vx) {
  if (k == 0) return;
  vx /= 2;
  if (!c422) vy /= 2;
}

__global__ void __launch_bounds__(kThreads) pred_kernel(PredArgs a) {
  const long long e = static_cast<long long>(blockIdx.x) * kThreads
                      + threadIdx.x;
  if (e >= a.start[a.nplanes]) return;
  int k = 0;
  while (e >= a.start[k + 1]) ++k;
  const PredPlane& P = a.pl[k];
  const long long off = e - a.start[k];
  const int y = static_cast<int>(off / P.w), x = static_cast<int>(off % P.w);
  // the macroblock: 16x16 luma tiles, 8x8 chroma (8 wide, 16 tall at
  // 4:2:2); y and x are not negative, so shifts divide
  const int ty = k == 0 || a.c422 ? 4 : 3, tx = k == 0 ? 4 : 3;
  const int i = (y >> ty) * a.mbw + (x >> tx);
  int fy = a.fmv[i * 2], fx = a.fmv[i * 2 + 1];
  chroma_vec(k, a.c422, fy, fx);
  const int m = a.mode ? a.mode[i] : 0;
  int p;
  if (m == 1) {
    int by_ = a.bmv[i * 2], bx_ = a.bmv[i * 2 + 1];
    chroma_vec(k, a.c422, by_, bx_);
    p = half_pel(P.b, P.bs, P.h, P.w, y, x, by_, bx_);
  } else {
    p = half_pel(P.f, P.fs, P.h, P.w, y, x, fy, fx);
    if (m == 2) {
      int by_ = a.bmv[i * 2], bx_ = a.bmv[i * 2 + 1];
      chroma_vec(k, a.c422, by_, bx_);
      p = (p + half_pel(P.b, P.bs, P.h, P.w, y, x, by_, bx_) + 1) >> 1;
    }
  }
  P.out[off] = static_cast<uint8_t>(p);
}

struct BmodeArgs {
  const uint8_t* cur;
  long long cs;
  const uint8_t* f;
  long long fs;
  const uint8_t* b;
  long long bs;
  int h, w;
  const int* fmv;
  const int* fsad;
  const int* bmv;
  const int* bsad;
  int* mode;
};

__global__ void __launch_bounds__(kThreads) bmode_kernel(BmodeArgs a) {
  __shared__ int red[kThreads / 32];
  const int i = blockIdx.y * gridDim.x + blockIdx.x;
  const int y = blockIdx.y * 16 + (threadIdx.x >> 4);
  const int x = blockIdx.x * 16 + (threadIdx.x & 15);
  const int fp = half_pel(a.f, a.fs, a.h, a.w, y, x, a.fmv[i * 2],
                          a.fmv[i * 2 + 1]);
  const int bp = half_pel(a.b, a.bs, a.h, a.w, y, x, a.bmv[i * 2],
                          a.bmv[i * 2 + 1]);
  int d = absi(((fp + bp + 1) >> 1) - int(a.cur[y * a.cs + x]));
  for (int o = 16; o; o >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = d;
  __syncthreads();
  if (threadIdx.x == 0) {
    int bisad = 0;
    for (int k = 0; k < kThreads / 32; ++k) bisad += red[k];
    int m = 0, best = a.fsad[i];
    if (a.bsad[i] < best) { m = 1; best = a.bsad[i]; }
    if (bisad - 256 < best) m = 2;
    a.mode[i] = m;
  }
}

// ---------------------------------------------------------------------
// Block coding

constexpr int kSub = kThreads / 64;    // 8x8 blocks a thread block

struct BlockPlane {
  const uint8_t* cur;
  long long cs;
  const uint8_t* pred;
  long long ps;
  uint8_t* rec;
  int h, w;
};

struct BlockArgs {
  BlockPlane pl[3];
  int mode, qs, m1, mbw;
  int nb;                     // blocks a macroblock: 6 (4:2:0) or 8 (4:2:2)
  short* levels;              // (nmb * nb, 64) in scan order
  const bool* intra_mb;       // (mbh, mbw) or null
  long long start[4];         // first block of each plane
  double basis[64];           // B[k][n]
  int scan[64];
  int weight[64];             // the intra matrix, natural order
};

constexpr int kIntra = 0, kInter = 1, kLevels = 2;

template <int MODE>
__global__ void __launch_bounds__(kThreads) blocks_kernel(BlockArgs a) {
  __shared__ double X[kSub][64];
  __shared__ double T[kSub][64];
  __shared__ int L[kSub][64];
  __shared__ int any[kSub], sum[kSub];
  const int sub = threadIdx.x >> 6, tid = threadIdx.x & 63;
  const int i = tid >> 3, j = tid & 7;
  const long long gb = static_cast<long long>(blockIdx.x) * kSub + sub;
  const bool live = gb < a.start[3];
  int k = 0;
  if (live) while (gb >= a.start[k + 1]) ++k;
  const BlockPlane& P = a.pl[k];
  const int bw = P.w / 8;
  const long long bi = live ? gb - a.start[k] : 0;
  const int by = static_cast<int>(bi / bw), bx = static_cast<int>(bi % bw);
  const int y = by * 8 + i, x = bx * 8 + j;
  bool intra = MODE == kIntra;
  if (MODE == kInter && a.intra_mb != nullptr && live) {
    const int mi = k == 0     ? (by >> 1) * a.mbw + (bx >> 1)
                   : a.nb == 8 ? (by >> 1) * a.mbw + bx
                               : by * a.mbw + bx;
    intra = a.intra_mb[mi];
  }
  int pred = 0;
  if (live) {
    const int c = P.cur[y * P.cs + x];
    if (MODE != kIntra) pred = P.pred[y * P.ps + x];
    X[sub][tid] = intra ? static_cast<double>(c)
                        : static_cast<double>(c) - static_cast<double>(pred);
  } else {
    X[sub][tid] = 0.0;
  }
  if (tid == 0) { any[sub] = 0; sum[sub] = 0; }
  __syncthreads();

  // forward DCT: t[i][j] = sum_k x[i][k] B[j][k], then c[i][j] = sum_k
  // B[i][k] t[k][j], each a chain of fused multiply-adds from 0
  double acc = 0.0;
  for (int kk = 0; kk < 8; ++kk)
    acc = __fma_rn(X[sub][i * 8 + kk], a.basis[j * 8 + kk], acc);
  T[sub][tid] = acc;
  __syncthreads();
  double coef = 0.0;
  for (int kk = 0; kk < 8; ++kk)
    coef = __fma_rn(a.basis[i * 8 + kk], T[sub][kk * 8 + j], coef);

  // quantiser
  const int qs = a.qs, lim = a.m1 ? 255 : 2047;
  int lv;
  if (intra) {
    if (tid == 0) {
      lv = static_cast<int>(fmin(fmax(rint(__ddiv_rn(coef, 8.0)), 0.0),
                                 255.0));
    } else {
      const double den = __dmul_rn(__dmul_rn(2.0, double(a.weight[tid])),
                                   __dmul_rn(2.0, double(qs)));
      const double q = rint(__ddiv_rn(__dmul_rn(coef, 32.0), den));
      lv = static_cast<int>(fmin(fmax(q, -double(lim)), double(lim)));
    }
  } else {
    const int cr = static_cast<int>(rint(coef));
    int q = absi(cr) / (2 * qs);
    q = q > lim ? lim : q;
    lv = cr < 0 ? -q : q;
  }
  L[sub][tid] = lv;
  if (lv != 0) atomicOr(&any[sub], 1);
  __syncthreads();
  if (live) {
    long long slot;
    if (k == 0)
      slot = ((static_cast<long long>(by >> 1) * (bw >> 1) + (bx >> 1))
              * a.nb + (by & 1) * 2 + (bx & 1));
    else if (a.nb == 8)
      slot = (static_cast<long long>(by >> 1) * bw + bx) * 8 + 4
             + (by & 1) * 2 + k - 1;
    else
      slot = (static_cast<long long>(by) * bw + bx) * 6 + 3 + k;
    a.levels[slot * 64 + tid] = static_cast<short>(L[sub][a.scan[tid]]);
  }
  if (MODE == kLevels) return;

  // dequantiser and mismatch control
  int d;
  if (intra) {
    const long long prod = static_cast<long long>(lv) * 2 * a.weight[tid]
                           * (2 * qs);
    d = static_cast<int>(prod / 32);           // C division: toward 0
    if (a.m1 && d != 0 && (d % 2) == 0) d -= d > 0 ? 1 : -1;
    if (tid == 0) d = L[sub][0] * 8;
  } else if (lv == 0) {
    d = 0;
  } else {
    const long long mag = (2 * static_cast<long long>(absi(lv)) + 1) * 16
                          * (2 * qs);
    d = static_cast<int>((lv < 0 ? -1 : 1) * (mag / 32));
    if (a.m1 && d != 0 && (d % 2) == 0) d -= d > 0 ? 1 : -1;
  }
  d = d < -2048 ? -2048 : (d > 2047 ? 2047 : d);
  atomicAdd(&sum[sub], d);
  __syncthreads();
  if (!a.m1 && tid == 63 && (sum[sub] % 2) == 0) d ^= 1;
  const bool coded = intra || any[sub] != 0;

  // inverse DCT: t[i][j] = sum_k d[i][k] B[k][j], then o[i][j] = sum_k
  // B[k][i] t[k][j]
  X[sub][tid] = static_cast<double>(d);
  __syncthreads();
  acc = 0.0;
  for (int kk = 0; kk < 8; ++kk)
    acc = __fma_rn(X[sub][i * 8 + kk], a.basis[kk * 8 + j], acc);
  T[sub][tid] = acc;
  __syncthreads();
  double o = 0.0;
  for (int kk = 0; kk < 8; ++kk)
    o = __fma_rn(a.basis[kk * 8 + i], T[sub][kk * 8 + j], o);
  if (!live) return;
  int out;
  if (!coded) {
    out = pred;
  } else {
    double v = rint(o);
    if (!intra) v = v + static_cast<double>(pred);
    out = static_cast<int>(fmin(fmax(v, 0.0), 255.0));
  }
  P.rec[y * P.w + x] = static_cast<uint8_t>(out);
}

}  // namespace

// meta: cur, cur stride, h, w, r, nref, mv, sad, ref0, stride0, ref1,
// stride1
TC_API int tc_mpeg2_me(const long long* m, cudaStream_t stream) {
  MeArgs a;
  a.cur = reinterpret_cast<const uint8_t*>(m[0]);
  a.cur_stride = m[1];
  a.h = static_cast<int>(m[2]);
  a.w = static_cast<int>(m[3]);
  a.r = static_cast<int>(m[4]);
  const int nref = static_cast<int>(m[5]);
  a.mv = reinterpret_cast<int*>(m[6]);
  a.sad = reinterpret_cast<int*>(m[7]);
  for (int i = 0; i < 2; ++i) {
    a.ref[i] = reinterpret_cast<const uint8_t*>(m[8 + 2 * i]);
    a.ref_stride[i] = m[9 + 2 * i];
  }
  if (a.r < 1 || a.r > kMaxRange || nref < 1 || nref > 2) return 1;
  dim3 grid(a.w / 16, a.h / 16, nref);
  me_kernel<<<grid, kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// meta: nplanes, mbw, fmv, bmv, mode, then per plane f, f stride, b,
// b stride, out, h, w
TC_API int tc_mpeg2_enc_pred(const long long* m, cudaStream_t stream) {
  PredArgs a;
  a.nplanes = static_cast<int>(m[0]);
  a.mbw = static_cast<int>(m[1]);
  a.fmv = reinterpret_cast<const int*>(m[2]);
  a.bmv = reinterpret_cast<const int*>(m[3]);
  a.mode = reinterpret_cast<const int*>(m[4]);
  a.start[0] = 0;
  for (int k = 0; k < 3; ++k) {
    const long long* q = m + 5 + 7 * k;
    a.pl[k].f = reinterpret_cast<const uint8_t*>(q[0]);
    a.pl[k].fs = q[1];
    a.pl[k].b = reinterpret_cast<const uint8_t*>(q[2]);
    a.pl[k].bs = q[3];
    a.pl[k].out = reinterpret_cast<uint8_t*>(q[4]);
    a.pl[k].h = static_cast<int>(q[5]);
    a.pl[k].w = static_cast<int>(q[6]);
    a.start[k + 1] = a.start[k]
                     + (k < a.nplanes ? q[5] * q[6] : 0);
  }
  a.c422 = a.nplanes == 3 && a.pl[1].h == a.pl[0].h;
  pred_kernel<<<tc_blocks(a.start[3], kThreads), kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// meta: cur, stride, f, stride, b, stride, h, w, fmv, fsad, bmv, bsad,
// mode
TC_API int tc_mpeg2_enc_bmode(const long long* m, cudaStream_t stream) {
  BmodeArgs a;
  a.cur = reinterpret_cast<const uint8_t*>(m[0]);
  a.cs = m[1];
  a.f = reinterpret_cast<const uint8_t*>(m[2]);
  a.fs = m[3];
  a.b = reinterpret_cast<const uint8_t*>(m[4]);
  a.bs = m[5];
  a.h = static_cast<int>(m[6]);
  a.w = static_cast<int>(m[7]);
  a.fmv = reinterpret_cast<const int*>(m[8]);
  a.fsad = reinterpret_cast<const int*>(m[9]);
  a.bmv = reinterpret_cast<const int*>(m[10]);
  a.bsad = reinterpret_cast<const int*>(m[11]);
  a.mode = reinterpret_cast<int*>(m[12]);
  bmode_kernel<<<dim3(a.w / 16, a.h / 16), kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// meta: mode, qs, m1, mbw, levels, intra_mb, then per plane cur, stride,
// pred, stride, rec, h, w; basis: 64 doubles; ints: the scan, then the
// intra matrix
TC_API int tc_mpeg2_enc_blocks(const long long* m, const double* basis,
                               const int* ints, cudaStream_t stream) {
  BlockArgs a;
  a.mode = static_cast<int>(m[0]);
  a.qs = static_cast<int>(m[1]);
  a.m1 = static_cast<int>(m[2]);
  a.mbw = static_cast<int>(m[3]);
  a.levels = reinterpret_cast<short*>(m[4]);
  a.intra_mb = reinterpret_cast<const bool*>(m[5]);
  a.start[0] = 0;
  for (int k = 0; k < 3; ++k) {
    const long long* q = m + 6 + 7 * k;
    a.pl[k].cur = reinterpret_cast<const uint8_t*>(q[0]);
    a.pl[k].cs = q[1];
    a.pl[k].pred = reinterpret_cast<const uint8_t*>(q[2]);
    a.pl[k].ps = q[3];
    a.pl[k].rec = reinterpret_cast<uint8_t*>(q[4]);
    a.pl[k].h = static_cast<int>(q[5]);
    a.pl[k].w = static_cast<int>(q[6]);
    a.start[k + 1] = a.start[k] + (q[5] / 8) * (q[6] / 8);
  }
  a.nb = a.pl[1].h == a.pl[0].h ? 8 : 6;
  for (int i = 0; i < 64; ++i) {
    a.basis[i] = basis[i];
    a.scan[i] = ints[i];
    a.weight[i] = ints[64 + i];
  }
  if (a.qs < 1 || a.qs > 31) return 1;
  const unsigned grid = tc_blocks(a.start[3], kSub);
  if (a.mode == kIntra)
    blocks_kernel<kIntra><<<grid, kThreads, 0, stream>>>(a);
  else if (a.mode == kInter)
    blocks_kernel<kInter><<<grid, kThreads, 0, stream>>>(a);
  else
    blocks_kernel<kLevels><<<grid, kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}
