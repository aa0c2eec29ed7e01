// MPEG-1/2 picture reconstruction for Hopper (sm_90a), 4:2:0 and 4:2:2.
//
// Not TPU kernels: the JAX package leaves this to XLA
// (tcforge_tpu/io/mpeg2codec.py).  Done in plain torch it would be some
// forty small launches a picture, in strict decode order; here each
// picture is one launch.
//
// tc_mpeg2_recon (mpeg2codec.py:1527-1603 _recon_picture_math with the
// gather MC, and :2137-2216 _recon_field_core): one thread per pixel of
// the coded grid, all three planes in one launch.  Per pixel:
//   - the float32 IDCT of its 8x8 block: acc = fmaf(c[k], K[k][n], acc)
//     for k = 0..63 in order from 0, K = kron(B, B) computed in float64
//     and rounded once to float32 (np.kron(b, b).astype(np.float32)),
//     then rounded half to even.  Inside jit XLA's float32 dot at
//     HIGHEST precision gives exactly these sums.  A zero coefficient is
//     skipped: fmaf(0, K, acc) is acc.  Every operation of the chain is
//     an explicit __fmaf_rn, which nvcc's --fmad never rewrites;
//   - in a frame picture, the field-DCT row deinterleave of a luma
//     macroblock (coded row r/2 for even r, 8 + r/2 for odd r), and at
//     4:2:2 of a chroma macroblock too;
//   - the prediction: frame or field half-pel gathers from the forward
//     and/or backward reference, (p + 1) >> 1 when both, or dual prime,
//     each sample coordinate clipped on its own (field prediction clips
//     the field line); chroma vectors are sign(mv) * (|mv| / 2), at
//     4:2:2 the horizontal component alone (13818-2 7.6.3.7), dual
//     prime's derived on the luma vector, then halved;
//   - intra: the IDCT alone; else prediction + IDCT; clipped to uint8.
//   A field picture predicts from reference fields of any height (the
//   anchor frame's lines of one parity, or the frame's first field),
//   each clipped to its own size.  A chroma macroblock is 8x8 at 4:2:0
//   (mpeg2codec.py:1564) and 8 wide by 16 tall at 4:2:2, whose
//   chroma planes have the luma's rows (in a field picture the field's:
//   :2164 mby = 16 if chroma == 2).
//
// tc_mpeg2_idct_intra (the JAX package's CPU IDCT of intra runs,
// native/tcforge_host.cpp:496-524 tc_idct_block_avx512): the float64
// separable IDCT, row pass t[i][j] = fma(c[i][k], B[k][j], t) and
// column pass o[i][j] = fma(B[k][i], t[k][j], o) for k = 0..7 from 0,
// rint (half to even), clipped.  One thread per column of a block: it
// computes that column of t for all eight rows, then the eight pixels
// of that column.  A 4:2:2 intra frame picture (reconstruct_intra_422,
// mpeg2codec.py:947-981) passes its field-DCT flags: the rows of those
// 16-row macroblocks (16 pixels wide for luma, 8 for chroma) are stored
// deinterleaved, coded row r to 2r for r < 8 and 2(r - 8) + 1 after.
//
// The basis B arrives from the host as 64 doubles in the launch's
// parameters (the same table as the JAX package's, pinned by a test).

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRefs = 12;      // [direction][field][plane]

struct RefPlane {
  const uint8_t* p;
  int h, w;
  long long stride;            // bytes between rows
};

struct ReconArgs {
  const int* coef[3];          // (bh, bw, 64) int32 per plane
  uint8_t* out[3];             // (bh*8, bw*8) uint8 per plane
  const int* mbinfo;           // (mb_rows * mb_w, 12) int32
  RefPlane ref[kRefs];
  int mb_w, mb_rows;
  int has_fwd, has_bwd, tff;
  int field, parity;           // a field picture, and its parity
  int chroma;                  // 1: 4:2:0, 2: 4:2:2
  double basis[64];
};

enum {
  kIntra = 1, kFwd = 2, kBwd = 4, kFieldMv = 16, kFieldDct = 32,
  kDual = 64, kMv16x8 = 128
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ int chroma_mv(int v) {
  const int a = v < 0 ? -v : v;
  return v < 0 ? -(a / 2) : a / 2;
}

__device__ __forceinline__ int div2(int v) { return (v + (v > 0)) >> 1; }

// a luma vector's chroma form: both components halved at 4:2:0, the
// horizontal one alone at 4:2:2
__device__ __forceinline__ void chroma_vec(int chroma, int& vx, int& vy) {
  vx = chroma_mv(vx);
  if (chroma == 1) vy = chroma_mv(vy);
}

// the half-pel combination of the four samples
__device__ __forceinline__ int halfpel(int a, int b, int c, int d, int hx,
                                       int hy) {
  if (hx && hy) return (a + b + c + d + 2) >> 2;
  if (hx) return (a + b + 1) >> 1;
  if (hy) return (a + c + 1) >> 1;
  return a;
}

__device__ __forceinline__ int sample(const RefPlane& r, int y, int x) {
  return r.p[y * r.stride + x];
}

// frame half-pel prediction at (y, x) with vector (vx, vy), every
// coordinate clipped on its own
__device__ int frame_pred(const RefPlane& r, int y, int x, int vx, int vy) {
  const int iy = y + (vy >> 1), ix = x + (vx >> 1);
  const int y0 = clampi(iy, 0, r.h - 1), y1 = clampi(iy + 1, 0, r.h - 1);
  const int x0 = clampi(ix, 0, r.w - 1), x1 = clampi(ix + 1, 0, r.w - 1);
  return halfpel(sample(r, y0, x0), sample(r, y0, x1), sample(r, y1, x0),
                 sample(r, y1, x1), vx & 1, vy & 1);
}

// prediction from field `sel` of a frame: the field line is clipped
__device__ int field_pred(const RefPlane& r, int y, int x, int vx, int vy,
                          int sel) {
  const int fl_max = r.h / 2 - 1;
  const int ifl = (y >> 1) + (vy >> 1), ix = x + (vx >> 1);
  const int y0 = sel + 2 * clampi(ifl, 0, fl_max);
  const int y1 = sel + 2 * clampi(ifl + 1, 0, fl_max);
  const int x0 = clampi(ix, 0, r.w - 1), x1 = clampi(ix + 1, 0, r.w - 1);
  return halfpel(sample(r, y0, x0), sample(r, y0, x1), sample(r, y1, x0),
                 sample(r, y1, x1), vx & 1, vy & 1);
}

__global__ void __launch_bounds__(kThreads)
recon_kernel(const ReconArgs a, long long luma_px, long long chroma_px) {
  __shared__ float kmat[64 * 64];
  for (int i = threadIdx.x; i < 64 * 64; i += blockDim.x) {
    const int m = i >> 6, n = i & 63;     // K[m][n], m = (i, j), n = (u, v)
    kmat[i] = __double2float_rn(
        __dmul_rn(a.basis[(m >> 3) * 8 + (n >> 3)],
                  a.basis[(m & 7) * 8 + (n & 7)]));
  }
  __syncthreads();

  long long t = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (t >= luma_px + 2 * chroma_px) return;
  int pi = 0;
  if (t >= luma_px) {
    t -= luma_px;
    pi = 1;
    if (t >= chroma_px) {
      t -= chroma_px;
      pi = 2;
    }
  }
  const int mbx = pi ? 8 : 16, mby = pi ? 8 * a.chroma : 16;
  const int w = a.mb_w * mbx;
  const int y = static_cast<int>(t / w), x = static_cast<int>(t % w);
  const int* info = a.mbinfo + ((y / mby) * a.mb_w + x / mbx) * 12;
  const int flags = info[0];

  // the IDCT value of this pixel (a frame picture's field-DCT macroblock
  // reads its coded rows deinterleaved: luma, and 4:2:2 chroma)
  int sy = y;
  if (mby == 16 && !a.field && (flags & kFieldDct)) {
    const int r = y & 15;
    sy = (y & ~15) + ((r & 1) ? 8 + (r >> 1) : (r >> 1));
  }
  const int bw = a.mb_w * mbx / 8;
  const int* c = a.coef[pi] + (static_cast<long long>(sy >> 3) * bw +
                               (x >> 3)) * 64;
  const int n = (sy & 7) * 8 + (x & 7);
  float acc = 0.0f;
#pragma unroll 8
  for (int k = 0; k < 64; ++k) {
    const int ck = c[k];
    if (ck != 0) acc = __fmaf_rn(static_cast<float>(ck), kmat[k * 64 + n], acc);
  }
  const int sp = static_cast<int>(rintf(acc));

  int recon = sp;
  if (!(flags & kIntra)) {
    int pred = 0, nref = 0;
    const bool dual = (flags & kDual) != 0;
    const int fieldsel = info[9];
    for (int dir = 0; dir < 2; ++dir) {
      const bool present = dir == 0 ? a.has_fwd : a.has_bwd;
      bool has = (flags & (dir == 0 ? kFwd : kBwd)) != 0;
      if (dir == 0 && !a.field) has = has && !dual;
      if (!present || !has) continue;
      const int* mv = info + 1 + 4 * dir;  // mv1 = mv[0..1], mv2 = mv[2..3]
      const int shift = 2 * dir;
      int p;
      if (a.field) {
        const bool lower = (flags & kMv16x8) && (y % mby) >= mby / 2;
        int vx = lower ? mv[2] : mv[0], vy = lower ? mv[3] : mv[1];
        if (pi) chroma_vec(a.chroma, vx, vy);
        const int sel = (fieldsel >> (shift + (lower ? 1 : 0))) & 1;
        p = frame_pred(a.ref[dir * 6 + sel * 3 + pi], y, x, vx, vy);
      } else {
        const bool odd = (flags & kFieldMv) && (y & 1);
        int vx = odd ? mv[2] : mv[0], vy = odd ? mv[3] : mv[1];
        if (pi) chroma_vec(a.chroma, vx, vy);
        const RefPlane& r = a.ref[dir * 6 + pi];
        if (flags & kFieldMv) {
          const int fs = (fieldsel >> shift) & 3;
          const int sel = (y & 1) ? (fs >> 1) & 1 : fs & 1;
          p = field_pred(r, y, x, vx, vy, sel);
        } else {
          p = frame_pred(r, y, x, vx, vy);
        }
      }
      pred += p;
      ++nref;
    }
    if (nref == 2) pred = (pred + 1) >> 1;
    if (dual && a.has_fwd) {
      const int mx = info[1], my = info[2], dx = info[3], dy = info[4];
      if (a.field) {
        // the opposite-parity field, one field period away
        int vx = div2(mx) + dx, vy = div2(my) + dy + (a.parity ? 1 : -1);
        if (pi) chroma_vec(a.chroma, vx, vy);
        const int opp = frame_pred(a.ref[(1 - a.parity) * 3 + pi], y, x, vx,
                                   vy);
        pred = (pred + opp + 1) >> 1;
      } else {
        // the top field's vector scales by m = 1 (3 when the bottom
        // field is first), the bottom field's by the other
        const int parity = y & 1;
        const int m = (parity == 0) == (a.tff != 0) ? 1 : 3;
        int ox = div2(mx * m) + dx;
        int oy = div2(my * m) + dy + (parity == 0 ? -1 : 1);
        int sx = mx, sy2 = my;
        if (pi) {
          chroma_vec(a.chroma, ox, oy);
          chroma_vec(a.chroma, sx, sy2);
        }
        const RefPlane& r = a.ref[pi];
        const int same = field_pred(r, y, x, sx, sy2, parity);
        const int other = field_pred(r, y, x, ox, oy, 1 - parity);
        pred = (same + other + 1) >> 1;
      }
    }
    recon = pred + sp;
  }
  a.out[pi][t] = static_cast<uint8_t>(clampi(recon, 0, 255));
}

struct IdctBasis {
  double b[64];
};

__global__ void __launch_bounds__(kThreads)
idct_intra_kernel(const int* __restrict__ coef, uint8_t* __restrict__ out,
                  long long columns, int bh, int bw,
                  const bool* __restrict__ field_dct, int mb_w,
                  const IdctBasis basis) {
  const long long t = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (t >= columns) return;
  const int j = static_cast<int>(t & 7);
  const long long blk = t >> 3;                 // (n, by, bx) flattened
  const int bx = static_cast<int>(blk % bw);
  const long long nb = blk / bw;
  const int by = static_cast<int>(nb % bh);
  const long long n = nb / bh;
  const int* c = coef + blk * 64;
  const double* B = basis.b;
  double col[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    double acc = 0.0;
#pragma unroll
    for (int k = 0; k < 8; ++k)
      acc = __fma_rn(static_cast<double>(c[i * 8 + k]), B[k * 8 + j], acc);
    col[i] = acc;
  }
  const long long row_stride = static_cast<long long>(bw) * 8;
  // a field-DCT macroblock's block row (by & 1) holds one field: its row
  // i lands on 2i + (by & 1) of the macroblock's 16
  int row0 = by * 8, step = 1;
  if (field_dct != nullptr &&
      field_dct[(n * (bh / 2) + (by >> 1)) * mb_w + bx * mb_w / bw]) {
    row0 = (by & ~1) * 8 + (by & 1);
    step = 2;
  }
  uint8_t* o = out + (n * bh * 8 + static_cast<long long>(row0)) *
                         row_stride + bx * 8 + j;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    double acc = 0.0;
#pragma unroll
    for (int k = 0; k < 8; ++k) acc = __fma_rn(B[k * 8 + i], col[k], acc);
    const double v = fmin(fmax(rint(acc), 0.0), 255.0);
    o[i * step * row_stride] = static_cast<uint8_t>(v);
  }
}

}  // namespace

// meta (int64): [0..2] coefficient pointers, [3..5] output pointers,
// [6] mbinfo pointer, [7] mb_w, [8] macroblock rows, [9] has_fwd,
// [10] has_bwd, [11] top_field_first, [12] field picture, [13] its
// parity, then 12 reference planes of (pointer, h, w, row stride):
// [direction][field (frame pictures: 0)][plane], then [62] chroma (1:
// 4:2:0, 2: 4:2:2).  basis: 64 doubles.
TC_API int tc_mpeg2_recon(const long long* meta, const double* basis,
                          cudaStream_t stream) {
  ReconArgs a;
  for (int i = 0; i < 3; ++i) {
    a.coef[i] = reinterpret_cast<const int*>(meta[i]);
    a.out[i] = reinterpret_cast<uint8_t*>(meta[3 + i]);
  }
  a.mbinfo = reinterpret_cast<const int*>(meta[6]);
  a.mb_w = static_cast<int>(meta[7]);
  a.mb_rows = static_cast<int>(meta[8]);
  a.has_fwd = static_cast<int>(meta[9]);
  a.has_bwd = static_cast<int>(meta[10]);
  a.tff = static_cast<int>(meta[11]);
  a.field = static_cast<int>(meta[12]);
  a.parity = static_cast<int>(meta[13]);
  for (int r = 0; r < kRefs; ++r) {
    const long long* m = meta + 14 + 4 * r;
    a.ref[r].p = reinterpret_cast<const uint8_t*>(m[0]);
    a.ref[r].h = static_cast<int>(m[1]);
    a.ref[r].w = static_cast<int>(m[2]);
    a.ref[r].stride = m[3];
  }
  a.chroma = static_cast<int>(meta[14 + 4 * kRefs]);
  if (a.chroma != 1 && a.chroma != 2) return 1;
  for (int i = 0; i < 64; ++i) a.basis[i] = basis[i];
  const long long luma = static_cast<long long>(a.mb_rows) * a.mb_w * 256;
  const long long chroma = luma / 4 * a.chroma;
  recon_kernel<<<tc_blocks(luma + 2 * chroma, kThreads), kThreads, 0,
                 stream>>>(a, luma, chroma);
  return static_cast<int>(cudaGetLastError());
}

// field_dct: null, or bool (n, bh / 2, mb_w) field-DCT flags of 16-row
// macroblocks bw * 8 / mb_w pixels wide
TC_API int tc_mpeg2_idct_intra(const int* coef, uint8_t* out, long long n,
                               int bh, int bw, const bool* field_dct,
                               int mb_w, const double* basis,
                               cudaStream_t stream) {
  if (field_dct != nullptr && (bh % 2 || mb_w < 1 || bw % mb_w)) return 1;
  IdctBasis b;
  for (int i = 0; i < 64; ++i) b.b[i] = basis[i];
  const long long columns = n * bh * bw * 8;
  idct_intra_kernel<<<tc_blocks(columns, kThreads), kThreads, 0, stream>>>(
      coef, out, columns, bh, bw, field_dct, mb_w, b);
  return static_cast<int>(cudaGetLastError());
}
