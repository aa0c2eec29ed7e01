// DV25 (SMPTE 314M) block transforms for Hopper (sm_90a): the pixels of the
// port's DV decoder and encoder (io/dvcodec.py); the bits are the host's
// (csrc/dv_host.cpp).
//
// Not TPU kernels: the JAX package's DV codec is numpy (tcforge_tpu/io/
// dvdec.py, io/dvenc.py).  Both kernels index the blocks of a batch in
// bitstream order (frame, DIF sequence, segment, macroblock, block: 9,720
// blocks a PAL frame, 8,100 an NTSC one) and find each block's samples
// through the placement table (io/dvcodec.py placement: plane, row,
// column, split), so the PAL shuffle, the NTSC 4:1:1 superblocks and the
// split right-edge chroma blocks (a 4x16 region, its left four columns the
// top half) cost one table read a block.
//
// tc_dv_idct: one block a group of 8 threads (32 a CTA of 256).  Thread r
//   reads coefficient row r (and its pair row for a 2-4-8 block, whose
//   rows are first butterflied into int16 sums and differences that wrap)
//   and runs dvdec._idct_rows on it in 64-bit integers (a row whose AC is
//   zero takes dc << 3, which rounds otherwise than the W4 path); then
//   column r: the 8-point column of idct88, or the two 4-point field
//   columns of idct248; clipped to 0..255; then row r of the block's
//   samples goes to its plane as two 4-byte stores (an NTSC chroma row is
//   180 bytes: 4-byte aligned, not 8).  Bound: bytes (the int16
//   coefficients in, a byte a sample out).
// tc_dv_fdct_cost: one block a group of 16 threads (8 a CTA of 128).  The
//   block's samples go to shared memory, thread 0 picks its mode
//   (DVEncoder._pick_modes), each thread computes 4 of the 64 float64
//   coefficients as numpy's OpenBLAS gemv sums F @ x on the machine that
//   pinned the goldens (four lanes of __fma_rn over i % 4, then (l0 + l2)
//   + (l1 + l3)) with F from io/dvcodec.py basis (transposed so a warp
//   reads rows), and thread 0 the DC (rint((X0 - 1024) / 4), clamped).
//   Without qnos, thread q quantizes the block at qno q (_quantize: for
//   each class from 0, rint(X[zz] * 16384 / factor) with IEEE division,
//   the first class whose AC levels fit 255, else class 3 clipped) and
//   counts its AC bits (_ac_cost through the cost table of io/dvcodec.py
//   cost_table): the table the host's rate fit reads.  With qnos, thread 0
//   quantizes at its macroblock's qno and writes the zigzag levels and the
//   class.  Bound: operations (float64: 4,096 FMAs a block, and the
//   divisions).

#include "common.cuh"

namespace {

constexpr int kIdctThreads = 256;
constexpr int kIdctBlocksPerCta = kIdctThreads / 8;
constexpr int kCostThreads = 128;
constexpr int kCostBlocksPerCta = kCostThreads / 16;
constexpr int kQnos = 16;

// io/dvdec.py's integer IDCT constants
constexpr long long kW1 = 22725, kW2 = 21407, kW3 = 19266, kW4 = 16383;
constexpr long long kW5 = 12873, kW6 = 8867, kW7 = 4520;
constexpr int kRowShift = 11, kColShift = 20;
constexpr long long kC1 = 2676, kC2 = 1108;  // _C1, _C2 (_CN_SHIFT 12)
constexpr int kCShift = 17;                  // _C_SHIFT
constexpr long long kColBias = 32;           // (1 << 19) // W4
__constant__ int kQuantOffset[4] = {6, 3, 0, 1};

struct Geometry {
  int nb;              // blocks a frame
  int yw, yh, cw, ch;  // the planes
};

// a block's plane (0 Y, 1 Cb, 2 Cr) and where its sample (r, c) lies in
// frame f of that plane
__device__ __forceinline__ long long sample_at(const int* pl, const Geometry& g, long long f,
                                               int r, int c) {
  const int p = pl[0], py = pl[1], px = pl[2], split = pl[3];
  const int w = p == 0 ? g.yw : g.cw;
  const long long size = p == 0 ? static_cast<long long>(g.yw) * g.yh
                                : static_cast<long long>(g.cw) * g.ch;
  const int row = split ? py + r + (c >= 4 ? 8 : 0) : py + r;
  const int col = split ? px + (c & 3) : px + c;
  return f * size + static_cast<long long>(row) * w + col;
}

// dvdec._idct_rows on one row
__device__ __forceinline__ void idct_row(const long long* r, long long* out) {
  bool dconly = true;
#pragma unroll
  for (int i = 1; i < 8; ++i) dconly = dconly && r[i] == 0;
  if (dconly) {
#pragma unroll
    for (int i = 0; i < 8; ++i) out[i] = r[0] * 8;
    return;
  }
  const long long base = kW4 * r[0] + (1LL << (kRowShift - 1));
  const long long a0 = base + kW2 * r[2] + kW4 * r[4] + kW6 * r[6];
  const long long a1 = base + kW6 * r[2] - kW4 * r[4] - kW2 * r[6];
  const long long a2 = base - kW6 * r[2] - kW4 * r[4] + kW2 * r[6];
  const long long a3 = base - kW2 * r[2] + kW4 * r[4] - kW6 * r[6];
  const long long b0 = kW1 * r[1] + kW3 * r[3] + kW5 * r[5] + kW7 * r[7];
  const long long b1 = kW3 * r[1] - kW7 * r[3] - kW1 * r[5] - kW5 * r[7];
  const long long b2 = kW5 * r[1] - kW1 * r[3] + kW7 * r[5] + kW3 * r[7];
  const long long b3 = kW7 * r[1] - kW5 * r[3] + kW3 * r[5] - kW1 * r[7];
  out[0] = (a0 + b0) >> kRowShift;
  out[1] = (a1 + b1) >> kRowShift;
  out[2] = (a2 + b2) >> kRowShift;
  out[3] = (a3 + b3) >> kRowShift;
  out[4] = (a3 - b3) >> kRowShift;
  out[5] = (a2 - b2) >> kRowShift;
  out[6] = (a1 - b1) >> kRowShift;
  out[7] = (a0 - b0) >> kRowShift;
}

__device__ __forceinline__ long long wrap16(long long x) {
  return static_cast<long long>(static_cast<int16_t>(static_cast<uint16_t>(x & 0xFFFF)));
}

__device__ __forceinline__ uint8_t clip8(long long x) {
  return static_cast<uint8_t>(x < 0 ? 0 : (x > 255 ? 255 : x));
}

struct IdctArgs {
  const int16_t* coef;  // (nblocks, 64)
  const uint8_t* mode;  // (nblocks,)
  const int* place;     // (nb, 4)
  uint8_t* out[3];      // Y (frames, yh, yw), Cb and Cr (frames, ch, cw)
  long long nblocks;
  Geometry g;
};

__global__ void __launch_bounds__(kIdctThreads) dv_idct_kernel(IdctArgs a) {
  __shared__ long long ws[kIdctBlocksPerCta][8][9];
  __shared__ __align__(16) uint8_t pix[kIdctBlocksPerCta][8][8];
  const int lb = threadIdx.x >> 3, r = threadIdx.x & 7;
  const long long gb = static_cast<long long>(blockIdx.x) * kIdctBlocksPerCta + lb;
  const bool live = gb < a.nblocks;
  int m = 0;
  if (live) {
    m = a.mode[gb];
    const int16_t* c = a.coef + gb * 64;
    long long row[8], res[8];
    if (m == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i) row[i] = c[8 * r + i];
    } else {
      const int e = r & ~1;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const long long s = c[8 * e + i], d = c[8 * (e + 1) + i];
        row[i] = wrap16((r & 1) ? s - d : s + d);
      }
    }
    idct_row(row, res);
#pragma unroll
    for (int i = 0; i < 8; ++i) ws[lb][r][i] = res[i];
  }
  __syncthreads();
  if (live) {
    const int col = r;
    long long t[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) t[i] = ws[lb][i][col];
    long long o[8];
    if (m == 0) {
      const long long base = kW4 * (t[0] + kColBias);
      const long long a0 = base + kW2 * t[2] + kW4 * t[4] + kW6 * t[6];
      const long long a1 = base + kW6 * t[2] - kW4 * t[4] - kW2 * t[6];
      const long long a2 = base - kW6 * t[2] - kW4 * t[4] + kW2 * t[6];
      const long long a3 = base - kW2 * t[2] + kW4 * t[4] - kW6 * t[6];
      const long long b0 = kW1 * t[1] + kW3 * t[3] + kW5 * t[5] + kW7 * t[7];
      const long long b1 = kW3 * t[1] - kW7 * t[3] - kW1 * t[5] - kW5 * t[7];
      const long long b2 = kW5 * t[1] - kW1 * t[3] + kW7 * t[5] + kW3 * t[7];
      const long long b3 = kW7 * t[1] - kW5 * t[3] + kW3 * t[5] - kW1 * t[7];
      o[0] = (a0 + b0) >> kColShift;
      o[1] = (a1 + b1) >> kColShift;
      o[2] = (a2 + b2) >> kColShift;
      o[3] = (a3 + b3) >> kColShift;
      o[4] = (a3 - b3) >> kColShift;
      o[5] = (a2 - b2) >> kColShift;
      o[6] = (a1 - b1) >> kColShift;
      o[7] = (a0 - b0) >> kColShift;
    } else {
      // dvdec._idct4col on the sum rows (even lines) and the difference
      // rows (odd lines)
#pragma unroll
      for (int f = 0; f < 2; ++f) {
        const long long a0 = t[f], a1 = t[f + 2], a2 = t[f + 4], a3 = t[f + 6];
        const long long half = 1LL << (kCShift - 1);
        const long long c0 = (a0 + a2) * 2048 + half;
        const long long c2 = (a0 - a2) * 2048 + half;
        const long long c1 = a1 * kC1 + a3 * kC2;
        const long long c3 = a1 * kC2 - a3 * kC1;
        o[f] = (c0 + c1) >> kCShift;
        o[f + 2] = (c2 + c3) >> kCShift;
        o[f + 4] = (c2 - c3) >> kCShift;
        o[f + 6] = (c0 - c1) >> kCShift;
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) pix[lb][i][col] = clip8(o[i]);
  }
  __syncthreads();
  if (!live) return;
  const long long f = gb / a.g.nb;
  const int* pl = a.place + 4 * (gb - f * a.g.nb);
  uint8_t* plane = a.out[pl[0]];
  const uint32_t* src = reinterpret_cast<const uint32_t*>(pix[lb][r]);
  *reinterpret_cast<uint32_t*>(plane + sample_at(pl, a.g, f, r, 0)) = src[0];
  *reinterpret_cast<uint32_t*>(plane + sample_at(pl, a.g, f, r, 4)) = src[1];
}

struct CostArgs {
  const uint8_t* planes[3];  // Y (frames, yh, yw), Cb and Cr (frames, ch, cw)
  const int* place;        // (nb, 4)
  const double* basis_t;   // (2, 64, 64): F[m] transposed
  const double* factors;   // (2, 2, 22, 64) as float64
  const int* zigzag;       // (2, 64)
  const uint8_t* cost;     // (64, 256): AC bits of a level after a run
  const uint8_t* qno;      // (nblocks / 6,) or null
  int16_t* table;          // (nblocks, 16, 2) or the levels (nblocks, 64)
  int16_t* dc;             // (nblocks,)
  uint8_t* mode;           // (nblocks,): the mode, or with qnos the class
  long long nblocks;
  Geometry g;
};

// _quantize of one block at qno: the class, levels in lv (zigzag)
__device__ int quantize(const double* X, int m, int qno, const CostArgs& a, int* lv) {
  const int* zz = a.zigzag + 64 * m;
  lv[0] = 0;
  for (int cls = 0; cls < 4; ++cls) {
    const int q = qno + kQuantOffset[cls];
    const double* f = a.factors + (((cls == 3 ? 1 : 0) * 2 + m) * 22 + q) * 64;
    int top = 0;
    for (int p = 1; p < 64; ++p) {
      const double v = rint(__ddiv_rn(__dmul_rn(X[zz[p]], 16384.0), __ldg(f + p)));
      const int l = static_cast<int>(v);
      lv[p] = l;
      top = max(top, abs(l));
    }
    if (top <= 255) return cls;
  }
  for (int p = 1; p < 64; ++p) lv[p] = min(255, max(-255, lv[p]));
  return 3;
}

__device__ int ac_cost(const int* lv, const uint8_t* cost) {
  int bits = 4;  // EOB
  int run = 0;
  for (int p = 1; p < 64; ++p) {
    const int v = lv[p];
    if (v == 0) {
      ++run;
      continue;
    }
    bits += __ldg(cost + run * 256 + abs(v));
    run = 0;
  }
  return bits;
}

__global__ void __launch_bounds__(kCostThreads) dv_cost_kernel(CostArgs a) {
  __shared__ double x[kCostBlocksPerCta][64];
  __shared__ double X[kCostBlocksPerCta][64];
  __shared__ int mode_s[kCostBlocksPerCta];
  const int lb = threadIdx.x >> 4, s = threadIdx.x & 15;
  const long long gb = static_cast<long long>(blockIdx.x) * kCostBlocksPerCta + lb;
  const bool live = gb < a.nblocks;
  long long f = 0;
  if (live) {
    f = gb / a.g.nb;
    const int* pl = a.place + 4 * (gb - f * a.g.nb);
    const uint8_t* plane = a.planes[pl[0]];
    const int r = s >> 1, c0 = (s & 1) * 4;
#pragma unroll
    for (int c = c0; c < c0 + 4; ++c) x[lb][8 * r + c] = plane[sample_at(pl, a.g, f, r, c)];
  }
  __syncthreads();
  if (live && s == 0) {
    long long inter = 0, fields = 0;
    for (int r = 0; r < 7; ++r)
      for (int c = 0; c < 8; ++c)
        inter += llabs(static_cast<long long>(x[lb][8 * (r + 1) + c] - x[lb][8 * r + c]));
    for (int r = 0; r < 6; ++r)
      for (int c = 0; c < 8; ++c)
        fields += llabs(static_cast<long long>(x[lb][8 * (r + 2) + c] - x[lb][8 * r + c]));
    fields = (fields + 1) / 2;
    mode_s[lb] = inter > 2 * fields ? 1 : 0;
  }
  __syncthreads();
  if (live) {
    const double* F = a.basis_t + 4096 * mode_s[lb];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int j = s + 16 * k;
      double acc[4] = {0.0, 0.0, 0.0, 0.0};
#pragma unroll 16
      for (int i = 0; i < 64; ++i) acc[i & 3] = __fma_rn(__ldg(F + 64 * i + j), x[lb][i], acc[i & 3]);
      X[lb][j] = __dadd_rn(__dadd_rn(acc[0], acc[2]), __dadd_rn(acc[1], acc[3]));
    }
  }
  __syncthreads();
  if (live && s == 0) {
    double d = rint(__ddiv_rn(__dsub_rn(X[lb][0], 1024.0), 4.0));
    d = fmin(255.0, fmax(-256.0, d));
    if (a.dc != nullptr) a.dc[gb] = static_cast<int16_t>(d);
    X[lb][0] = 0.0;
  }
  __syncthreads();
  if (!live) return;
  const int m = mode_s[lb];
  int lv[64];
  if (a.qno == nullptr) {
    if (s == 0) a.mode[gb] = static_cast<uint8_t>(m);
    const int cls = quantize(X[lb], m, s, a, lv);
    int16_t* t = a.table + (gb * kQnos + s) * 2;
    t[0] = static_cast<int16_t>(cls);
    t[1] = static_cast<int16_t>(ac_cost(lv, a.cost));
  } else if (s == 0) {
    const int cls = quantize(X[lb], m, a.qno[gb / 6], a, lv);
    a.mode[gb] = static_cast<uint8_t>(cls);
    int16_t* out = a.table + gb * 64;
    for (int p = 0; p < 64; ++p) out[p] = static_cast<int16_t>(lv[p]);
  }
}

Geometry geometry(const long long* meta) {
  Geometry g;
  g.nb = static_cast<int>(meta[0]);
  g.yw = static_cast<int>(meta[1]);
  g.yh = static_cast<int>(meta[2]);
  g.cw = static_cast<int>(meta[3]);
  g.ch = static_cast<int>(meta[4]);
  return g;
}

}  // namespace

// meta: coef, mode, place, the Y, Cb and Cr planes, frames, then the
// blocks a frame and the Y and chroma planes' width and height.
TC_API int tc_dv_idct(const long long* meta, cudaStream_t stream) {
  IdctArgs a;
  a.coef = reinterpret_cast<const int16_t*>(meta[0]);
  a.mode = reinterpret_cast<const uint8_t*>(meta[1]);
  a.place = reinterpret_cast<const int*>(meta[2]);
  for (int p = 0; p < 3; ++p) a.out[p] = reinterpret_cast<uint8_t*>(meta[3 + p]);
  const long long frames = meta[6];
  a.g = geometry(meta + 7);
  a.nblocks = frames * a.g.nb;
  dv_idct_kernel<<<tc_blocks(a.nblocks, kIdctBlocksPerCta), kIdctThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// meta: the Y, Cb and Cr planes, place, basis_t, factors, zigzag, cost,
// qno (0 for the table), table or levels, dc (0 with qnos), mode or class,
// frames, then the geometry as tc_dv_idct's.
TC_API int tc_dv_fdct_cost(const long long* meta, cudaStream_t stream) {
  CostArgs a;
  for (int p = 0; p < 3; ++p) a.planes[p] = reinterpret_cast<const uint8_t*>(meta[p]);
  a.place = reinterpret_cast<const int*>(meta[3]);
  a.basis_t = reinterpret_cast<const double*>(meta[4]);
  a.factors = reinterpret_cast<const double*>(meta[5]);
  a.zigzag = reinterpret_cast<const int*>(meta[6]);
  a.cost = reinterpret_cast<const uint8_t*>(meta[7]);
  a.qno = reinterpret_cast<const uint8_t*>(meta[8]);
  a.table = reinterpret_cast<int16_t*>(meta[9]);
  a.dc = reinterpret_cast<int16_t*>(meta[10]);
  a.mode = reinterpret_cast<uint8_t*>(meta[11]);
  const long long frames = meta[12];
  a.g = geometry(meta + 13);
  a.nblocks = frames * a.g.nb;
  dv_cost_kernel<<<tc_blocks(a.nblocks, kCostBlocksPerCta), kCostThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}
