// Device functions shared by the MPEG-4 part 2 decoder
// (mpeg4_recon.cu) and encoder (mpeg4_encode.cu), so that the encoder's
// reconstruction is the decoder's by construction.
//
//   - the XVID integer IDCT (mpeg4dec.py _xvid_idct): the row pass with
//     the _ROW_TABS coefficients and _ROW_RND rounding, >> 11 and the
//     16-bit wrap ((x + 0x8000) & 0xFFFF) - 0x8000; then the column pass
//     with the TAN and SQRT2 terms, >> 6 and the wrap.  Every product and
//     sum is 64-bit, as numpy's int64: SQRT2 * (d +- c) passes 2^31 on
//     large coefficients, and signed overflow is undefined in C++.  Each
//     call computes one output of a pass;
//   - the half-pel prediction sample (Mpeg4Decoder._mc_block): two taps
//     (a + b + 1 - rnd) >> 1, four taps (a + b + c + d + 2 - rnd) >> 2,
//     the sample's row and column clamped on their own to the plane
//     (what the numpy coder's edge-padded planes give at any vector);
//     and its field form (_mc_rect over _field_pad), whose rows clamp in
//     frame space.
#pragma once

#include <cstdint>

namespace mpeg4 {

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

__device__ __forceinline__ long long wrap16(long long x) {
  return ((x + 0x8000) & 0xFFFF) - 0x8000;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Output column c of row r: x is the row's eight coefficients.
__device__ __forceinline__ long long idct_row(const long long* x, int r,
                                              int c) {
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
  return wrap16(v >> 11);
}

// Output row r of a column: x is the column's first row-pass output, the
// others at a stride of 8.
__device__ __forceinline__ int idct_col(const long long* x, int r) {
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
  return static_cast<int>(wrap16(v >> 6));
}

// The half-pel taps of rows ya, yb and columns xa, xb of a plane of
// width w: hx, hy the half-sample flags.
__device__ __forceinline__ int mc_taps(const uint8_t* p, int w, int ya,
                                       int yb, int xa, int xb, int hx,
                                       int hy, int rnd) {
  const int p00 = __ldg(p + ya * w + xa);
  if (!hx && !hy) return p00;
  if (hx && !hy) return (p00 + __ldg(p + ya * w + xb) + 1 - rnd) >> 1;
  if (hy && !hx) return (p00 + __ldg(p + yb * w + xa) + 1 - rnd) >> 1;
  return (p00 + __ldg(p + ya * w + xb) + __ldg(p + yb * w + xa) +
          __ldg(p + yb * w + xb) + 2 - rnd) >> 2;
}

// Half-pel sample at (y, x) of an h x w plane with vector (mx, my).
__device__ __forceinline__ int mc_sample(const uint8_t* p, int h, int w,
                                         int y, int x, int mx, int my,
                                         int rnd) {
  const int x0 = x + (mx >> 1), y0 = y + (my >> 1);
  return mc_taps(p, w, clampi(y0, 0, h - 1), clampi(y0 + 1, 0, h - 1),
                 clampi(x0, 0, w - 1), clampi(x0 + 1, 0, w - 1), mx & 1,
                 my & 1, rnd);
}

// Half-pel sample at field row fy, column x of field sel (0 top, 1
// bottom) of an h x w frame plane: field row j is frame row 2j + sel,
// clamped in frame space (mpeg4dec.py _field_pad: a field read past
// the frame's edge takes the frame's first or last row).
__device__ __forceinline__ int mc_sample_field(const uint8_t* p, int h,
                                               int w, int fy, int x,
                                               int mx, int my, int sel,
                                               int rnd) {
  const int x0 = x + (mx >> 1), y0 = fy + (my >> 1);
  return mc_taps(p, w, clampi(2 * y0 + sel, 0, h - 1),
                 clampi(2 * y0 + 2 + sel, 0, h - 1), clampi(x0, 0, w - 1),
                 clampi(x0 + 1, 0, w - 1), mx & 1, my & 1, rnd);
}

}  // namespace mpeg4
