// unsharp mask / gaussian blur for Hopper (sm_90a).
//
// Replaces unsharp_plane_pallas (_unsharp_kernel) in
// tcforge_tpu/ops/kernels.py.  The filter (filter_unsharp.c, the
// Waltz-Miller running-sum FSM) blurs with 2*sy vertical and 2*sx
// horizontal cascaded [1,1] stages over the edge-replicated plane, in
// uint32 arithmetic that wraps, then sharpens:
//     blur = (acc + halfscale) >> scalebits      (0 once scalebits >= 32)
//     out  = clip(src + (((src - blur) * amount16.16) >> 16), 0, 255)
// with the product in int32 and an arithmetic shift.  In the ring
// Z/2^32 the 2s cascaded stages are exactly a convolution with the
// binomial coefficients C(2s, k) mod 2^32 over edge-clamped indices,
// so that is what these kernels compute, wraparound included (a 17x15
// matrix wraps: 255 * 2^30 > 2^32).
//
// What bounds it on this card: an integer stencil with no tensor-core
// work.  One read and one write of the plane is 2 bytes a pixel; the
// arithmetic is about 20 integer instructions a pixel in the form below
// (7x5), most of them on the 64-lane ALU pipe and a quarter on the
// multiply-add pipe, so the instruction rate, not device memory, is
// the limit.
//
// Two kernels:
//
// * unsharp_strip_kernel<SX, SY>, for matrices up to 7x7 (steps 0..3,
//   one instance per pair).  No shared memory and no barrier: a warp
//   walks down kStripRows rows of a strip of columns, each lane owning
//   four adjacent pixels (one 32-bit word, loaded and stored whole
//   where the plane's rows are word-aligned and the word lies inside
//   the plane; clamped bytes otherwise, which only the lanes at the
//   plane's edges take).  The word is split into two registers of two
//   16-bit lanes each, ((p0, p2), (p1, p3)), and the last 2*SY + 1 rows
//   of them live in registers: the column sums (at most 255 * 64) are
//   two packed multiply-adds chains per row, taps unrolled, binomials
//   as immediates.  The row pass needs SX <= 3 neighbours on each side:
//   the two packed sums of the lane to the left and to the right come
//   by warp shuffle, so lanes 0 and 31 only feed their neighbours
//   (30 of 32 lanes write).  The row loop is fully unrolled, so the
//   window is register renaming, and the rows' loads are independent
//   of each other and in flight together.  A strip reads its 2*SY halo
//   rows again (through L2; they cost a load and the column sums, a
//   sixth of a full row's instructions), and nothing else twice.
//
// * unsharp_general_kernel, for every other size (steps up to 31 on an
//   axis): a 64x16 output tile with its halo staged as clamped bytes in
//   dynamic shared memory sized for the call's matrix, column sums into
//   a uint32 tile, then row sums.  Threads are laid out 64x4 over the
//   tile, so no index is divided, and the coefficients (built on the
//   host by Pascal's rule in uint32) are read from shared memory.
#include "common.cuh"

namespace {

// ------------------------------------------------------------------ //
// matrices up to 7x7: a warp per strip, everything in registers

constexpr int kStripMaxSteps = 3;
constexpr int kStripRows = 8;     // output rows a warp walks down
constexpr int kStripWarps = 8;    // warps per block, each on its own strip

// acc + sum_j C(2S, j) * v[j], the symmetric pairs added first; v holds
// plain values or two 16-bit lanes whose sums stay below 2^16.
template <int S>
__device__ __forceinline__ uint32_t binomial_sum(const uint32_t* v, uint32_t acc) {
  static_assert(S >= 0 && S <= kStripMaxSteps, "one form per step count");
  if constexpr (S == 0) {
    return acc + v[0];
  } else if constexpr (S == 1) {
    return acc + 2 * v[1] + (v[0] + v[2]);
  } else if constexpr (S == 2) {
    return acc + 6 * v[2] + 4 * (v[1] + v[3]) + (v[0] + v[4]);
  } else {
    return acc + 20 * v[3] + 15 * (v[2] + v[4]) + 6 * (v[1] + v[5]) + (v[0] + v[6]);
  }
}

// One warp's strip: kStripRows output rows from y0 down, this lane's four
// columns from c on (c < 0 or c >= w in the lanes beyond the plane's
// edges, which hold the clamped columns).  kWords: rows are whole
// aligned 32-bit words, so every lane loads and stores one.
template <int SX, int SY, bool kWords>
__device__ __forceinline__ void strip_rows(const uint8_t* __restrict__ src,
                                           uint8_t* __restrict__ dst, int h, int w, int y0,
                                           int c, bool writes, int amount_fx) {
  constexpr int kScale = 2 * (SX + SY);
  constexpr uint32_t kHalf = 1u << (kScale - 1);
  constexpr unsigned kAll = 0xffffffffu;

  // the word's split into (p0, p2) and (p1, p3); a lane left of the plane
  // repeats the first word's byte 0, one right of it the last word's byte 3
  unsigned sel_a = 0x4240, sel_b = 0x4341;
  int cx[4];
  if constexpr (kWords) {
    if (c < 0) sel_a = sel_b = 0x4040;
    if (c >= w) sel_a = sel_b = 0x4343;
    cx[0] = min(max(c, 0), w - 4);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) cx[i] = min(max(c + i, 0), w - 1);
  }
  const uint8_t* col = src + cx[0];

  // the last 2*SY + 1 rows, as (p0, p2) and (p1, p3) in 16-bit lanes
  uint32_t wa[2 * SY + 1] = {}, wb[2 * SY + 1] = {};
#pragma unroll
  for (int i = 0; i < kStripRows + 2 * SY; ++i) {
    const unsigned gy = static_cast<unsigned>(min(max(y0 - SY + i, 0), h - 1));
    const uint8_t* row = col + static_cast<size_t>(gy) * static_cast<unsigned>(w);
    uint32_t word;
    if constexpr (kWords) {
      word = *reinterpret_cast<const uint32_t*>(row);
    } else {
      word = row[0] | (row[cx[1] - cx[0]] << 8) | (row[cx[2] - cx[0]] << 16) |
             (static_cast<uint32_t>(row[cx[3] - cx[0]]) << 24);
    }
#pragma unroll
    for (int j = 0; j < 2 * SY; ++j) {
      wa[j] = wa[j + 1];
      wb[j] = wb[j + 1];
    }
    wa[2 * SY] = __byte_perm(word, 0, sel_a);
    wb[2 * SY] = __byte_perm(word, 0, sel_b);
    if (i < 2 * SY) continue;
    const int y = y0 + i - 2 * SY;

    // column sums of this lane's four columns, then of its neighbours'
    const uint32_t va = binomial_sum<SY>(wa, 0);
    const uint32_t vb = binomial_sum<SY>(wb, 0);
    uint32_t la = 0, lb = 0, ra = 0, rb = 0;
    if constexpr (SX >= 1) {
      lb = __shfl_up_sync(kAll, vb, 1);
      ra = __shfl_down_sync(kAll, va, 1);
    }
    if constexpr (SX >= 2) {
      la = __shfl_up_sync(kAll, va, 1);
      rb = __shfl_down_sync(kAll, vb, 1);
    }
    // columns c - 4 .. c + 7
    const uint32_t v[12] = {la & 0xffff, lb & 0xffff, la >> 16, lb >> 16,
                            va & 0xffff, vb & 0xffff, va >> 16, vb >> 16,
                            ra & 0xffff, rb & 0xffff, ra >> 16, rb >> 16};
    const uint32_t ca = wa[SY], cb = wb[SY];
    const int s[4] = {static_cast<int>(ca & 0xffff), static_cast<int>(cb & 0xffff),
                      static_cast<int>(ca >> 16), static_cast<int>(cb >> 16)};
    uint32_t res[4];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int blur = static_cast<int>(binomial_sum<SX>(&v[4 + p - SX], kHalf) >> kScale);
      // int32 product that wraps like the reference's, without signed overflow
      const int prod = static_cast<int>(static_cast<uint32_t>(s[p] - blur) *
                                        static_cast<uint32_t>(amount_fx));
      // clip(s + (prod >> 16), 0, 255) in one DPX instruction
      res[p] = static_cast<uint32_t>(__viaddmin_s32_relu(s[p], prod >> 16, 255));
    }
    if (writes && y < h) {
      uint8_t* orow = dst + static_cast<size_t>(static_cast<unsigned>(y)) *
                                static_cast<unsigned>(w);
      if constexpr (kWords) {
        *reinterpret_cast<uint32_t*>(orow + c) =
            __byte_perm(__byte_perm(res[0], res[1], 0x0040),
                        __byte_perm(res[2], res[3], 0x0040), 0x5410);
      } else {
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          if (c + p < w) orow[c + p] = static_cast<uint8_t>(res[p]);
        }
      }
    }
  }
}

// grid: (strips of columns, groups of kStripWarps bands of rows, frames)
template <int SX, int SY>
__global__ void __launch_bounds__(kStripWarps * 32)
unsharp_strip_kernel(const uint8_t* __restrict__ img, uint8_t* __restrict__ out, int h,
                     int w, int amount_fx) {
  constexpr int kHalo = SX > 0 ? 1 : 0;       // lanes that only feed a neighbour
  const int y0 = (blockIdx.y * kStripWarps + (threadIdx.x >> 5)) * kStripRows;
  if (y0 >= h) return;                        // the whole warp leaves
  const int lane = threadIdx.x & 31;
  const size_t plane = static_cast<size_t>(h) * w;
  const uint8_t* src = img + blockIdx.z * plane;
  uint8_t* dst = out + blockIdx.z * plane;
  const int c = (blockIdx.x * (32 - 2 * kHalo) + lane - kHalo) * 4;
  const bool writes = lane >= kHalo && lane < 32 - kHalo && c >= 0 && c < w;
  const bool words =
      (w & 3) == 0 &&
      ((reinterpret_cast<uintptr_t>(img) | reinterpret_cast<uintptr_t>(out)) & 3) == 0;
  if (words) {
    strip_rows<SX, SY, true>(src, dst, h, w, y0, c, writes, amount_fx);
  } else {
    strip_rows<SX, SY, false>(src, dst, h, w, y0, c, writes, amount_fx);
  }
}

using StripLaunch = cudaError_t (*)(const uint8_t*, uint8_t*, int, int, int, int,
                                    cudaStream_t);

template <int SX, int SY>
cudaError_t launch_strip(const uint8_t* img, uint8_t* out, int n, int h, int w,
                         int amount_fx, cudaStream_t stream) {
  if constexpr (SX + SY == 0) {
    return cudaErrorInvalidValue;             // no blur: scalebits would be 0
  } else {
    const int lanes = SX > 0 ? 30 : 32;
    const dim3 grid(tc_blocks(w, lanes * 4), tc_blocks(h, kStripRows * kStripWarps), n);
    unsharp_strip_kernel<SX, SY><<<grid, kStripWarps * 32, 0, stream>>>(img, out, h, w,
                                                                         amount_fx);
    return cudaGetLastError();
  }
}

#define TC_STRIP_ROW(sx) \
  { launch_strip<sx, 0>, launch_strip<sx, 1>, launch_strip<sx, 2>, launch_strip<sx, 3> }
const StripLaunch kStripLaunch[kStripMaxSteps + 1][kStripMaxSteps + 1] = {
    TC_STRIP_ROW(0), TC_STRIP_ROW(1), TC_STRIP_ROW(2), TC_STRIP_ROW(3)};
#undef TC_STRIP_ROW

// ------------------------------------------------------------------ //
// every other size: a tile in shared memory

constexpr int kTileW = 64;
constexpr int kTileH = 16;
constexpr int kTileThreadsY = 4;
constexpr int kMaxSteps = 31;                 // MAX_MATRIX_SIZE 63
constexpr int kMaxTaps = 2 * kMaxSteps + 1;

struct Coefs {
  uint32_t x[kMaxTaps];
  uint32_t y[kMaxTaps];
};

__global__ void __launch_bounds__(kTileW * kTileThreadsY)
unsharp_general_kernel(const uint8_t* __restrict__ img, uint8_t* __restrict__ out, int h,
                       int w, int sx, int sy, int scalebits, int amount_fx, Coefs c) {
  // coefficients, the column sums of the tile's rows, then the staged bytes
  extern __shared__ uint32_t smem[];
  const int tw = kTileW + 2 * sx;             // staged extent of this call
  const int th = kTileH + 2 * sy;
  uint32_t* coef_x = smem;
  uint32_t* coef_y = coef_x + 2 * sx + 1;
  uint32_t* vsum = coef_y + 2 * sy + 1;
  uint8_t* tile = reinterpret_cast<uint8_t*>(vsum + kTileH * tw);

  const size_t plane = static_cast<size_t>(h) * w;
  const uint8_t* src = img + blockIdx.z * plane;
  uint8_t* dst = out + blockIdx.z * plane;
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * kTileH;
  const int tx = threadIdx.x, ty = threadIdx.y;

  if (tx == 0 && ty == 0) {
    for (int k = 0; k <= 2 * sx; ++k) coef_x[k] = c.x[k];
    for (int k = 0; k <= 2 * sy; ++k) coef_y[k] = c.y[k];
  }
  for (int r = ty; r < th; r += kTileThreadsY) {
    const uint8_t* row = src + static_cast<size_t>(min(max(y0 + r - sy, 0), h - 1)) * w;
    for (int col = tx; col < tw; col += kTileW) {
      tile[r * tw + col] = row[min(max(x0 + col - sx, 0), w - 1)];
    }
  }
  __syncthreads();

  // along columns: vsum[r][col] = sum_j C(2sy, j) * tile[r + j][col]
  for (int r = ty; r < kTileH; r += kTileThreadsY) {
    for (int col = tx; col < tw; col += kTileW) {
      uint32_t acc = 0;
      for (int j = 0; j <= 2 * sy; ++j) acc += coef_y[j] * tile[(r + j) * tw + col];
      vsum[r * tw + col] = acc;
    }
  }
  __syncthreads();

  const uint32_t half = 1u << (scalebits - 1);   // scalebits in [2, 32]
  const int gx = x0 + tx;
  for (int r = ty; r < kTileH; r += kTileThreadsY) {
    const int gy = y0 + r;
    if (gy >= h || gx >= w) continue;
    uint32_t acc = 0;
    for (int k = 0; k <= 2 * sx; ++k) acc += coef_x[k] * vsum[r * tw + tx + k];
    const int blur = scalebits >= 32 ? 0 : static_cast<int>((acc + half) >> scalebits);
    const int s = tile[(r + sy) * tw + tx + sx];
    // int32 product that wraps like the reference's, without signed overflow
    const int prod = static_cast<int>(static_cast<uint32_t>(s - blur) *
                                      static_cast<uint32_t>(amount_fx));
    const int res = s + (prod >> 16);
    dst[static_cast<size_t>(gy) * w + gx] = static_cast<uint8_t>(min(max(res, 0), 255));
  }
}

// C(2s, k) mod 2^32 for k in [0, 2s], by Pascal's rule in uint32.
void binomial_row(int steps, uint32_t* row) {
  row[0] = 1;
  for (int n = 1; n <= 2 * steps; ++n) {
    row[n] = 1;
    for (int k = n - 1; k >= 1; --k) row[k] += row[k - 1];
  }
}

}  // namespace

// img/out: contiguous (n, h, w) uint8.  The caller checks the steps and
// scalebits (ops/kernels.py _unsharp_fixed); out-of-range ones are
// refused here too.  ``general`` != 0 sends a small matrix to the tiled
// kernel as well, so that both can be held against each other.
TC_API int tc_unsharp(const uint8_t* img, uint8_t* out, int n, int h, int w,
                      int sx, int sy, int scalebits, int amount_fx, int general,
                      cudaStream_t stream) {
  if (sx < 0 || sy < 0 || sx > kMaxSteps || sy > kMaxSteps || scalebits < 2 ||
      scalebits > 32 || n < 1 || h < 1 || w < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (!general && sx <= kStripMaxSteps && sy <= kStripMaxSteps) {
    if (scalebits != 2 * (sx + sy)) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(kStripLaunch[sx][sy](img, out, n, h, w, amount_fx, stream));
  }
  Coefs c{};
  binomial_row(sx, c.x);
  binomial_row(sy, c.y);
  const int tw = kTileW + 2 * sx, th = kTileH + 2 * sy;
  const size_t shared = sizeof(uint32_t) * (2 * sx + 2 * sy + 2 + kTileH * tw) +
                        static_cast<size_t>(th) * tw;
  const dim3 grid(tc_blocks(w, kTileW), tc_blocks(h, kTileH), n);
  unsharp_general_kernel<<<grid, dim3(kTileW, kTileThreadsY), shared, stream>>>(
      img, out, h, w, sx, sy, scalebits, amount_fx, c);
  return static_cast<int>(cudaGetLastError());
}
