// TomsMoComp deinterlace for Hopper (sm_90a).
//
// Replaces tomsmocomp_plane_pallas2 (_tmc_kernel2 -> _tmc_body) and
// tomsmocomp_plane_pallas (_tmc_kernel), the same function, in
// tcforge_tpu/ops/kernels.py.  Per pixel of a missing line (not of the
// kept parity, not row 0 or H-1), in the jnp reference's order
// (tcforge_tpu/modules/filters/tomsmocomp.py:124-179):
//   1. the bob pair (above, below), then the no-motion pair
//      (prev, next), taken on w0 <= best_w; then best_w =
//      min(best_w + 1, 255), the bias toward no motion;
//   2. each motion offset (dy, dx) of the search effort, in order:
//      prev at (+2dy, +dx) against next at (-2dy, -dx), valid only
//      where 2|dy| <= row < H - 2|dy| and |dx| <= col < W - |dx|, and
//      taken on <=, so on a tie the later candidate wins;
//   3. the winner clamped to [min(above, below) - 4, max + 4] in [0, 255].
// A pair's value is (a + b + 1) >> 1 (pavgb) and its weight |a - b|.
// Kept lines copy curr.
//
// What bounds it on this card: bytes.  Each frame of the window is read
// once and each output written once: 0.032 ms for a 16-frame 1080i
// YUV420 batch at 3.35 TB/s.  The tournament is byte arithmetic, four
// pixels to a 32-bit word, at most 18 candidates.
//
// Design.  A block owns a 32-row x 128-column tile of one output frame:
// four warps, each over four row pairs (one kept row, one missing row),
// and a 32-bit word of four pixels per lane.  Motion offsets move prev
// and next by an even number of rows (2|dy| <= 2), so a missing row
// reads prev and next only on rows of its own parity, and its bob pair
// and the kept rows are curr's rows of the other parity: the block
// stages 18 rows of each frame (every other row, one row pair of halo
// above and below) with 16 bytes of halo left and right, as 16-byte
// cp.async copies, and reads every candidate from shared memory.  A dx
// shift is a funnel shift of two neighbouring words.  The tournament
// carries the winning pair and averages it once at the end; per
// candidate and word it is about 12 instructions: the weight is the
// native VABSDIFF4, the <= mask a 32-bit carry trick and a PRMT that
// spreads each byte's top bit (the __vcmpleu4 / __vminu4 intrinsics
// compile to a compare and select per byte here), the selects one LOP3
// each.  Candidates that may fall off the plane (rows within 2 of the
// top or bottom, columns within 4 of either side) take a copy of the
// tournament that masks each one per byte.  Widths that are not a
// multiple of 16, or unaligned frames, take the same kernel with byte
// staging and byte stores; rows 0 and H-1 of the missing parity copy
// curr from device memory.
//
// The frames come as three sources, each a frame index offset into two
// pointers: the window form (TomsMoComp's carried two frames, then the
// batch) resolves output j's prev, curr and next as window frames j,
// j + 1 and j + 2 without the window ever being built; the plane form
// passes three (n, H, W) tensors.
//
// Measured (chip_smoke.py phase 3 with --parent, NVIDIA H100 80GB HBM3,
// 700.00 W), per cfg4 batch (luma and two chroma planes, effort 5):
// 0.098 ms, against 0.396 for the previous design (one thread and 16
// one-byte loads per pixel, 64-bit index division) timed in turns in
// the same run.  An int32 form of the same tile (one int per pixel)
// took 0.178, so it was dropped.  Probes that ran slower (no number
// kept): the byte-SIMD intrinsics for the compare and min/max, 16-row
// tiles of one row pair per warp, and persistent blocks with the next
// tile's copies in flight (the loop's registers cut the blocks per SM).
// The time stays about three times the byte bound (0.032): per
// candidate the instruction count, and each block's wait for its tile's
// copies.
#include "common.cuh"

namespace {

constexpr int kTileCols = 128;                   // a word per lane
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kPairs = 4 * kWarps;               // row pairs: four per warp
constexpr int kTileRows = 2 * kPairs;
constexpr int kHalo = 16;                        // |dx| <= 4, 16-byte copies
constexpr int kRowBytes = kTileCols + 2 * kHalo;
constexpr int kChunks = kRowBytes / 16;
constexpr int kSlots = kPairs + 2;               // staged rows per frame
constexpr int kFrameBytes = kSlots * kRowBytes;
constexpr int kMaxMov = 4;                       // Max_Mov (SearchLoopTop.inc)

// The motion offsets (dy, dx) in the tournament's order; an effort runs
// the first tmc_offsets(effort) of them (tomsmocomp.py:43-61).
__device__ constexpr int off_dy(int k) {
  switch (k) {
    case 2: case 6: case 8: case 12: case 14: return 1;
    case 3: case 7: case 9: case 13: case 15: return -1;
    default: return 0;
  }
}
__device__ constexpr int off_dx(int k) {
  switch (k) {
    case 0: case 6: case 9: return 1;
    case 1: case 7: case 8: return -1;
    case 4: case 12: case 15: return 2;
    case 5: case 13: case 14: return -2;
    case 10: return 3;
    case 11: return -3;
    case 16: return 4;
    case 17: return -4;
    default: return 0;
  }
}
int tmc_offsets(int effort) {
  return effort >= 15 ? 18 : effort >= 13 ? 16 : effort >= 11 ? 12 : effort >= 9 ? 10
         : effort >= 5 ? 6 : effort >= 3 ? 4 : effort >= 1 ? 2 : 0;
}

// Four pixels in one word, one byte each.  le and avg are written out
// in 32-bit logic (the byte-SIMD intrinsics for them compile to a
// compare and select per byte on this card); the weight is the native
// VABSDIFF4 (__vabsdiffu4).
constexpr uint32_t kHi = 0x80808080u;

// 0xFF in each byte where a <= b: t holds 0x80 + (b & 0x7F) - (a & 0x7F)
// per byte (no borrow between bytes), so its bit 7 says the low seven
// bits compare <=; the high bits decide where they differ.  PRMT's sign
// mode spreads each byte's bit 7 over the byte.
__device__ __forceinline__ uint32_t le4(uint32_t a, uint32_t b) {
  const uint32_t t = (b | kHi) - (a & ~kHi);
  const uint32_t c = (b & ~a) | (~(a ^ b) & t);
  uint32_t m;
  asm("prmt.b32 %0, %1, 0, 0xBA98;" : "=r"(m) : "r"(c));
  return m;
}
// (a + b + 1) >> 1 per byte (pavgb): a | b never borrows from the halved
// difference
__device__ __forceinline__ uint32_t avg4(uint32_t a, uint32_t b) {
  return (a | b) - (((a ^ b) >> 1) & 0x7F7F7F7Fu);
}
// a where m's byte is 0xFF, else b
__device__ __forceinline__ uint32_t sel4(uint32_t m, uint32_t a, uint32_t b) {
  return (a & m) | (b & ~m);
}

// A frame source: output j reads frame j + off of the sequence whose
// first `split` frames are at lo and the rest at hi.
struct Src {
  const uint8_t* lo;
  const uint8_t* hi;
  int split, off;
  __device__ __forceinline__ const uint8_t* frame(int j, long long plane) const {
    const int k = j + off;
    return k < split ? lo + k * plane : hi + (k - split) * plane;
  }
};

// The three words around word xw of a staged row: bytes [4xw - 4,
// 4xw + 8).
struct Words {
  uint32_t w[3];
  __device__ __forceinline__ void load(const uint8_t* row, int xw) {
    const uint32_t* r = reinterpret_cast<const uint32_t*>(row) + xw;
    w[0] = r[-1];
    w[1] = r[0];
    w[2] = r[1];
  }
  // the four bytes starting dx bytes right of the middle word
  __device__ __forceinline__ uint32_t at(int dx) const {
    if (dx == 0) return w[1];
    if (dx == 4) return w[2];
    if (dx > 0) return __funnelshift_r(w[1], w[2], 8 * dx);
    return __funnelshift_r(w[0], w[1], 8 * (4 + dx));
  }
};

// 0xFF in each byte whose column lies in [adx, width - adx).
__device__ __forceinline__ uint32_t col_mask(int col, int width, int adx) {
  uint32_t m = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (col + i >= adx && col + i < width - adx) m |= 0xFFu << (8 * i);
  return m;
}

// The missing row `row` at columns [col, col + 4), from the staged
// slots of prev / next (slot s is the row, s -+ 1 the rows 2 above and
// below) and curr's bob pair.  The tournament carries the winning pair
// and averages it once at the end.  kEdge: some candidate may be off
// the plane (a row within 2 of the top or bottom, a column within 4 of
// either side), so each one is masked.
template <int kOffs, bool kEdge>
__device__ __forceinline__ uint32_t tournament(const uint8_t* sp, const uint8_t* sn, int s,
                                               uint32_t above, uint32_t below, int xw, int row,
                                               int col, int h, int width) {
  Words p[3], n[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    p[d].load(sp + (s + d - 1) * kRowBytes, xw);
    n[d].load(sn + (s + d - 1) * kRowBytes, xw);
  }
  uint32_t best_a = above, best_b = below;
  uint32_t best_w = __vabsdiffu4(above, below);
  {
    const uint32_t a = p[1].at(0), b = n[1].at(0);
    const uint32_t wt = __vabsdiffu4(a, b);
    const uint32_t take = le4(wt, best_w);
    best_a = sel4(take, a, best_a);
    best_b = sel4(take, b, best_b);
    best_w = sel4(take, wt, best_w);
  }
  best_w = __vaddus4(best_w, 0x01010101u);
#pragma unroll
  for (int k = 0; k < kOffs; ++k) {
    const int dy = off_dy(k), dx = off_dx(k);
    const uint32_t a = p[1 + dy].at(dx), b = n[1 - dy].at(-dx);
    const uint32_t wt = __vabsdiffu4(a, b);
    uint32_t take = le4(wt, best_w);
    if (kEdge) {
      const int ady = 2 * (dy < 0 ? -dy : dy), adx = dx < 0 ? -dx : dx;
      const bool row_ok = row >= ady && row < h - ady;
      take &= row_ok ? col_mask(col, width, adx) : 0u;
    }
    best_a = sel4(take, a, best_a);
    best_b = sel4(take, b, best_b);
    best_w = sel4(take, wt, best_w);
  }
  const uint32_t best_v = avg4(best_a, best_b);
  const uint32_t order = le4(above, below);
  const uint32_t lo = __vsubus4(sel4(order, above, below), kMaxMov * 0x01010101u);
  const uint32_t hi = __vaddus4(sel4(order, below, above), kMaxMov * 0x01010101u);
  const uint32_t v = sel4(le4(best_v, hi), best_v, hi);
  return sel4(le4(lo, v), v, lo);
}

// Stage rows first, first + 2, ... (kSlots of them) of each of the
// frames prev, curr and next (curr from its own first row), columns
// [c0 - kHalo, c0 + kTileCols + kHalo), into tiles; rows and columns
// off the plane are left as they are (no candidate that reads them is
// taken, no output that reads them is stored).  vec: 16-byte cp.async
// copies (issued, not waited for), else byte loads.
__device__ __forceinline__ void stage(uint8_t (*tiles)[kFrameBytes], const uint8_t* fp,
                                      const uint8_t* fc, const uint8_t* fn, int miss0, int kept0,
                                      int c0, int h, int width, bool vec) {
  if (vec) {
    for (int e = threadIdx.x; e < 3 * kSlots * kChunks; e += kThreads) {
      const int f = e / (kSlots * kChunks), r = e % (kSlots * kChunks);
      const int slot = r / kChunks, q = r % kChunks;
      const int row = (f == 1 ? kept0 : miss0) + 2 * slot, col = c0 - kHalo + 16 * q;
      if (row >= 0 && row < h && col >= 0 && col < width)
        cp_async16(tiles[f] + slot * kRowBytes + 16 * q,
                   (f == 0 ? fp : f == 1 ? fc : fn) + static_cast<long long>(row) * width + col);
    }
  } else {
    for (int e = threadIdx.x; e < 3 * kFrameBytes; e += kThreads) {
      const int f = e / kFrameBytes, r = e % kFrameBytes;
      const int slot = r / kRowBytes, x = r % kRowBytes;
      const int row = (f == 1 ? kept0 : miss0) + 2 * slot, col = c0 - kHalo + x;
      if (row >= 0 && row < h && col >= 0 && col < width)
        tiles[f][r] = (f == 0 ? fp : f == 1 ? fc : fn)[static_cast<long long>(row) * width + col];
    }
  }
}

__device__ __forceinline__ void store_word(uint8_t* out, uint32_t v, int width, int col,
                                           bool vec) {
  if (vec) {
    *reinterpret_cast<uint32_t*>(out) = v;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (col + i < width) out[i] = static_cast<uint8_t>(v >> (8 * i));
  }
}

// One staged tile, rows [r0, r0 + kTileRows) and columns [c0, c0 +
// kTileCols) of output frame j: warp w takes the row pairs w, w +
// kWarps, ..., a lane the word at column c0 + 4 * lane.
template <int kOffs>
__device__ __forceinline__ void compute_tile(uint8_t (*tiles)[kFrameBytes], int j, int r0,
                                             int c0, const uint8_t* fc,
                                             uint8_t* __restrict__ out, long long plane, int h,
                                             int width, int parity, bool vec) {
  const int lane = threadIdx.x % 32;
  const int col = c0 + 4 * lane, xw = kHalo / 4 + lane;
  if (col >= width) return;
  const bool inner_col = col >= kMaxMov && col + 4 + kMaxMov <= width;
  uint8_t* dst = out + j * plane + col;
  const uint32_t* cw = reinterpret_cast<const uint32_t*>(tiles[1]) + xw;
#pragma unroll 1
  for (int pair = threadIdx.x / 32; pair < kPairs; pair += kWarps) {
    // slot pair + 1: this pair's kept row in curr's tile, its missing
    // row in prev's and next's; the bob pair sits at pair + 1 - parity
    // and the slot after it
    const int s = pair + 1;
    const int kept = r0 + 2 * pair + parity, miss = kept + 1 - 2 * parity;
    if (kept < h)
      store_word(dst + static_cast<long long>(kept) * width, cw[s * kRowBytes / 4], width, col,
                 vec);
    if (miss >= h) continue;
    uint32_t v;
    if (miss == 0 || miss == h - 1) {   // kept whatever the parity
      const uint8_t* src = fc + static_cast<long long>(miss) * width + col;
      if (vec) {
        v = *reinterpret_cast<const uint32_t*>(src);
      } else {
        v = 0;
        for (int i = 0; i < 4 && col + i < width; ++i)
          v |= static_cast<uint32_t>(src[i]) << (8 * i);
      }
    } else {
      const uint32_t above = cw[(s - parity) * kRowBytes / 4];
      const uint32_t below = cw[(s + 1 - parity) * kRowBytes / 4];
      if (inner_col && miss >= 2 && miss < h - 2)
        v = tournament<kOffs, false>(tiles[0], tiles[2], s, above, below, xw, miss, col, h, width);
      else
        v = tournament<kOffs, true>(tiles[0], tiles[2], s, above, below, xw, miss, col, h, width);
    }
    store_word(dst + static_cast<long long>(miss) * width, v, width, col, vec);
  }
}

// Grid (column tiles, row tiles, frames), a tile per block.  vec:
// width a multiple of 16 and every frame 16-byte aligned.
template <int kOffs>
__global__ void __launch_bounds__(kThreads)
tomsmocomp_kernel(Src prev, Src curr, Src next, uint8_t* __restrict__ out, int h, int width,
                  int parity, bool vec) {
  __shared__ __align__(16) uint8_t tiles[3][kFrameBytes];
  const int j = blockIdx.z, r0 = blockIdx.y * kTileRows, c0 = blockIdx.x * kTileCols;
  const long long plane = static_cast<long long>(h) * width;
  const uint8_t* fc = curr.frame(j, plane);
  // prev / next: the missing parity's rows from two above the tile's
  // first one; curr: the kept parity's, likewise
  stage(tiles, prev.frame(j, plane), fc, next.frame(j, plane), r0 + 1 - parity - 2,
        r0 + parity - 2, c0, h, width, vec);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  compute_tile<kOffs>(tiles, j, r0, c0, fc, out, plane, h, width, parity, vec);
}

int launch(const Src& prev, const Src& curr, const Src& next, uint8_t* out, int n, int h,
           int width, int parity, int effort, bool vec, cudaStream_t stream) {
  const dim3 grid(tc_blocks(width, kTileCols), tc_blocks(h, kTileRows), n);
  switch (tmc_offsets(effort)) {
#define TC_TMC(K)                                                                        \
  case K:                                                                                \
    tomsmocomp_kernel<K><<<grid, kThreads, 0, stream>>>(prev, curr, next, out, h, width, parity, \
                                                        vec);                            \
    break;
    TC_TMC(0) TC_TMC(2) TC_TMC(4) TC_TMC(6) TC_TMC(10) TC_TMC(12) TC_TMC(16) TC_TMC(18)
#undef TC_TMC
  }
  return static_cast<int>(cudaGetLastError());
}

int run(const Src& prev, const Src& curr, const Src& next, uint8_t* out, int n, int h,
        int width, int parity, int effort, cudaStream_t stream) {
  if (n > 65535 || tc_blocks(h, kTileRows) > 65535 || effort < 0 || effort > 15 ||
      (parity != 0 && parity != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = width % 16 == 0 && aligned16(out) && aligned16(prev.lo) &&
                   aligned16(prev.hi) && aligned16(curr.lo) && aligned16(curr.hi) &&
                   aligned16(next.lo) && aligned16(next.hi);
  return launch(prev, curr, next, out, n, h, width, parity, effort, vec, stream);
}

}  // namespace

// curr/prev/nxt/out: contiguous (n, h, w) uint8.
TC_API int tc_tomsmocomp(const uint8_t* curr, const uint8_t* prev, const uint8_t* nxt,
                         uint8_t* out, int n, int h, int w, int parity, int effort,
                         cudaStream_t stream) {
  return run(Src{prev, prev, 0, 0}, Src{curr, curr, 0, 0}, Src{nxt, nxt, 0, 0}, out, n, h, w,
             parity, effort, stream);
}

// The window form: state (2, h, w) carried frames, batch and out (n, h,
// w); output j reads window frames j, j + 1 and j + 2 of state ++ batch.
TC_API int tc_tomsmocomp_window(const uint8_t* state, const uint8_t* batch, uint8_t* out, int n,
                                int h, int w, int parity, int effort, cudaStream_t stream) {
  return run(Src{state, batch, 2, 0}, Src{state, batch, 2, 1}, Src{state, batch, 2, 2}, out, n,
             h, w, parity, effort, stream);
}
