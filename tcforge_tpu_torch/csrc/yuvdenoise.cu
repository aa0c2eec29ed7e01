// yuvdenoise's chroma correction for Hopper (sm_90a).
//
// Replaces, in tcforge_tpu/modules/filters/yuvdenoise.py, correct_chroma
// (:183-218): not a Pallas kernel but a lax.scan over the rows of a
// chroma plane, which XLA runs as one loop on the TPU and which plain
// torch could only run on the card as a dozen launches a row (240 rows a
// plane at 720x480, two planes a frame, every frame of a batch in turn).
//
// correct_frame2 (denoise.c:414-478), per pixel of the int32 planes ref
// (the contrast-corrected input) and tmp (the motion-compensated
// average):
//     q  = |ref - tmp|,  f1 = clamp(255*(q - T) // max(1, T), 0, 255),
//     f2 = 255 - f1
//     out = tmp                                            if q <= T
//         = (tmp*f2 + ref*f1) // 255                       if not interior
//         = ((ref + ref_below + ref_above)*f1 // 3
//            + (tmp + tmp_below + out_above)*f2 // 3) // 255   if interior
// where "interior" is the flat index test W2 < c < W2*H2 - W2 of the C
// (so row 0, the last row and row 1 column 0 are exempt) and out_above
// is the row above AFTER its correction: each row depends on the one
// before, column by column.  Every division has non-negative operands
// except 255*(q - T) // max(1, T), whose floor the clamp hides: a
// negative numerator gives f1 = 0 under floor and truncation alike.
//
// Design: one thread per column of one plane, the rows in a loop, the
// corrected value of the row above in a register.  Adjacent threads read
// adjacent columns, so every row's loads coalesce; ref_above is the
// previous turn's ref, and the next row's ref and tmp are loaded one
// turn ahead, so the loop's serial chain is only the multiply, the two
// divisions and the select that use out_above.  U and V (P planes) go in
// one launch.  The work is tiny (12 bytes a pixel, 2.07 MB for the two
// chroma planes of a 720x480 frame, 0.6 us at 3.35 TB/s); what bounds it
// is the chain of H2 dependent rows, a few tens of cycles each.

#include "common.cuh"

namespace {

__device__ __forceinline__ int floordiv(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

__global__ void chroma_kernel(const int* __restrict__ ref,
                              const int* __restrict__ tmp,
                              int* __restrict__ out, int threshold, int planes,
                              int h2, int w2) {
  const long long col = blockIdx.x * static_cast<long long>(blockDim.x) +
                        threadIdx.x;
  if (col >= static_cast<long long>(planes) * w2) return;
  const int plane = static_cast<int>(col / w2);
  const int x = static_cast<int>(col % w2);
  const long long base = static_cast<long long>(plane) * h2 * w2 + x;
  const int div = threshold > 1 ? threshold : 1;
  const int* r = ref + base;
  const int* t = tmp + base;
  int* o = out + base;

  int above = 0;                   // ref of the row above
  int cur_r = r[0], cur_t = t[0];
  int prev = 0;                    // out of the row above
  for (int y = 0; y < h2; ++y) {
    const bool has_below = y + 1 < h2;
    const int nxt_r = has_below ? r[static_cast<long long>(y + 1) * w2] : 0;
    const int nxt_t = has_below ? t[static_cast<long long>(y + 1) * w2] : 0;
    const int q = abs(cur_r - cur_t);
    int res = cur_t;
    if (q > threshold) {
      const int f1 = min(max(floordiv(255 * (q - threshold), div), 0), 255);
      const int f2 = 255 - f1;
      const long long flat = static_cast<long long>(y) * w2 + x;
      const bool interior = flat > w2 &&
                            flat < static_cast<long long>(w2) * h2 - w2;
      res = interior ? ((cur_r + nxt_r + above) * f1 / 3 +
                        (cur_t + nxt_t + prev) * f2 / 3) / 255
                     : (cur_t * f2 + cur_r * f1) / 255;
    }
    o[static_cast<long long>(y) * w2] = res;
    prev = res;
    above = cur_r;
    cur_r = nxt_r;
    cur_t = nxt_t;
  }
}

}  // namespace

TC_API int tc_yuvdenoise_chroma(const int* ref, const int* tmp, int* out,
                                int threshold, int planes, int h2, int w2,
                                cudaStream_t stream) {
  constexpr int kThreads = 128;
  const long long cols = static_cast<long long>(planes) * w2;
  chroma_kernel<<<tc_blocks(cols, kThreads), kThreads, 0, stream>>>(
      ref, tmp, out, threshold, planes, h2, w2);
  return static_cast<int>(cudaGetLastError());
}
