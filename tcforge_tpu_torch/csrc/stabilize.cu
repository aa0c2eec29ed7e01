// stabilize's field search and transform's warp for Hopper (sm_90a).
//
// Neither replaces a Pallas kernel: in tcforge_tpu/modules/filters/
// stabilize.py the field search (field_search, :209-272) is a lax.scan
// over the candidate shifts, each step a gather of every field's patch
// and a sum, and the warp (warp_plane, :632-681) is some forty XLA ops
// over every plane.  In plain torch on the card the search would be
// thousands of launches and tens of GB of traffic a frame.
//
// tc_stabilize_field_search: one block per (frame, field).  The
// current frame's S x S patch goes to shared memory once, packed four
// bytes to a word (zero past S).  Where the previous frame's search
// window fits in shared memory too (the default fields: 115 KB at
// 1080p), field_search_window_kernel stages it there and gives each
// thread one candidate at a time; otherwise (shakiness 10 at 1080p is
// S = 270 with a +-275 window, 672 KB) field_search_kernel reads the
// previous frame through L1/L2 (frame n-1 of the batch, or the carried
// frame for n = 0), each warp takes every eighth candidate, lanes
// sweep a row's words, __vsadu4 sums four byte differences at a time,
// and a shuffle reduction gives the candidate's SAD.  Candidates follow
// the JAX order (coarse grid dx outer, dy inner; then the fine grid
// around the coarse best, the centre skipped), and the block keeps the
// smallest SAD and, among equal ones, the smallest candidate index: the
// JAX loop's strict '<'.  Every index into a frame maps as a jnp gather
// does (a negative index wraps once, then clamps): where the window is
// staged, and in the direct kernel for a candidate whose window reaches
// past the frame.  What bounds it: the byte SADs, 1.7e9 a 1080p frame
// at the default options.
//
// tc_transform_warp: one thread per output pixel, a template on the
// interpolation.  The per-frame parameters (zcos, zsin, the source
// offsets, the rounded shift and the pure-translation flag) come from
// the host's table (stabilize.warp_params).  The float32 arithmetic is
// written with __fmul_rn/__fadd_rn/__fmaf_rn so that nvcc contracts
// nothing: the fused multiply-adds are where the jitted JAX filter has
// them, and every other product and sum rounds on its own, as in the
// plain version (stabilize.py).  A plane is read once per tap, through
// L1; the bound is its bytes.

#include "common.cuh"

namespace {

constexpr int kSearchThreads = 256;
constexpr int kSearchWarps = kSearchThreads / 32;

__device__ __forceinline__ int jidx(int i, int n) {
  i = i < 0 ? i + n : i;
  return min(max(i, 0), n - 1);
}

__device__ __forceinline__ unsigned pack4(unsigned b0, unsigned b1,
                                          unsigned b2, unsigned b3) {
  return b0 | (b1 << 8) | (b2 << 16) | (b3 << 24);
}

// SAD of the shared patch against prev shifted by (dx, dy); every lane
// returns the warp's total.
__device__ unsigned candidate_sad(const unsigned* __restrict__ patch,
                                  const uint8_t* __restrict__ prev, int h,
                                  int w, int x0, int y0, int size, int words,
                                  int dx, int dy, int lane) {
  const int sx = x0 + dx, sy = y0 + dy;
  const bool inside = sx >= 0 && sy >= 0 && sx + size <= w && sy + size <= h;
  unsigned sum = 0;
  for (int r = 0; r < size; ++r) {
    const int row = inside ? sy + r : jidx(sy + r, h);
    const uint8_t* src = prev + static_cast<long long>(row) * w;
    const unsigned* pr = patch + r * words;
    for (int u = lane; u < words; u += 32) {
      const int c = 4 * u;
      unsigned b[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (c + k >= size) {
          b[k] = 0;
        } else {
          const int col = inside ? sx + c + k : jidx(sx + c + k, w);
          b[k] = __ldg(src + col);
        }
      }
      sum += __vsadu4(pack4(b[0], b[1], b[2], b[3]), pr[u]);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  return sum;
}

// (sad, index) pairs: the smaller SAD, then the smaller index
__device__ __forceinline__ bool better(unsigned sad, int idx,
                                       unsigned best_sad, int best_idx) {
  return sad < best_sad || (sad == best_sad && idx < best_idx);
}

__global__ void field_search_kernel(const uint8_t* __restrict__ prev0,
                                    const uint8_t* __restrict__ frames,
                                    const int* __restrict__ centers,
                                    int* __restrict__ out, int nfields,
                                    int h, int w, int size, int maxshift,
                                    int stepsize) {
  extern __shared__ unsigned patch[];
  __shared__ unsigned warp_sad[kSearchWarps];
  __shared__ int warp_idx[kSearchWarps];
  __shared__ int coarse_best[3];

  const int field = blockIdx.x;
  const int n = blockIdx.y;
  const long long plane = static_cast<long long>(h) * w;
  const uint8_t* cur = frames + n * plane;
  const uint8_t* prev = n == 0 ? prev0 : frames + (n - 1) * plane;
  const int x0 = centers[2 * field] - size / 2;
  const int y0 = centers[2 * field + 1] - size / 2;
  const int words = (size + 3) / 4;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  for (int i = threadIdx.x; i < size * words; i += blockDim.x) {
    const int r = i / words, c = 4 * (i % words);
    const uint8_t* src = cur + static_cast<long long>(jidx(y0 + r, h)) * w;
    unsigned b[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      b[k] = c + k < size ? src[jidx(x0 + c + k, w)] : 0u;
    patch[i] = pack4(b[0], b[1], b[2], b[3]);
  }
  __syncthreads();

  // stage 1: the coarse grid, dx outer, dy inner
  const int side = 2 * maxshift / stepsize + 1;
  unsigned best_sad = 0xffffffffu;
  int best_idx = 0x7fffffff;
  for (int c = warp; c < side * side; c += kSearchWarps) {
    const int dx = -maxshift + (c / side) * stepsize;
    const int dy = -maxshift + (c % side) * stepsize;
    const unsigned sad = candidate_sad(patch, prev, h, w, x0, y0, size, words,
                                       dx, dy, lane);
    if (better(sad, c, best_sad, best_idx)) {
      best_sad = sad;
      best_idx = c;
    }
  }
  if (lane == 0) {
    warp_sad[warp] = best_sad;
    warp_idx[warp] = best_idx;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned s = warp_sad[0];
    int idx = warp_idx[0];
    for (int k = 1; k < kSearchWarps; ++k)
      if (better(warp_sad[k], warp_idx[k], s, idx)) {
        s = warp_sad[k];
        idx = warp_idx[k];
      }
    coarse_best[0] = -maxshift + (idx / side) * stepsize;
    coarse_best[1] = -maxshift + (idx % side) * stepsize;
    coarse_best[2] = static_cast<int>(s);
  }
  __syncthreads();
  int bx = coarse_best[0], by = coarse_best[1];

  // stage 2: +-(stepsize-1) around the coarse best, the centre skipped;
  // the coarse best wins every tie
  if (stepsize > 1) {
    const int r = stepsize - 1, fside = 2 * r + 1, centre = r * fside + r;
    best_sad = 0xffffffffu;
    best_idx = 0x7fffffff;
    for (int f = warp; f < fside * fside - 1; f += kSearchWarps) {
      const int g = f + (f >= centre);
      const unsigned sad = candidate_sad(
          patch, prev, h, w, x0, y0, size, words, bx - r + g / fside,
          by - r + g % fside, lane);
      if (better(sad, f, best_sad, best_idx)) {
        best_sad = sad;
        best_idx = f;
      }
    }
    __syncthreads();
    if (lane == 0) {
      warp_sad[warp] = best_sad;
      warp_idx[warp] = best_idx;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      unsigned s = warp_sad[0];
      int idx = warp_idx[0];
      for (int k = 1; k < kSearchWarps; ++k)
        if (better(warp_sad[k], warp_idx[k], s, idx)) {
          s = warp_sad[k];
          idx = warp_idx[k];
        }
      if (s < static_cast<unsigned>(coarse_best[2])) {
        const int g = idx + (idx >= centre);
        bx += -r + g / fside;
        by += -r + g % fside;
      }
    }
  }
  if (threadIdx.x == 0) {
    // at or beyond the window's edge: discarded
    int* o = out + (static_cast<long long>(n) * nfields + field) * 2;
    o[0] = abs(bx) >= maxshift ? 0 : bx;
    o[1] = abs(by) >= maxshift ? 0 : by;
  }
}

// The same search with the previous frame's whole search window staged
// in shared memory, where it fits: (S + 2*(maxshift + stepsize - 1))^2
// bytes, 115 KB at the default 1080p fields.  A thread takes four
// coarse candidates of one column at a time (blocked_best), reading the
// window a 32-bit word at a time from shared memory, each patch word
// once for the four, and __vsadu4 sums four byte differences.  Each
// thread keeps its smallest (SAD, candidate index), and a shuffle and
// shared-memory reduction takes the block's.
constexpr int kWindowThreads = 384;
constexpr int kWindowWarps = kWindowThreads / 32;

// the block's smallest (sad, idx), in every thread
__device__ __forceinline__ void reduce_best(unsigned& sad, int& idx,
                                            unsigned* red_sad, int* red_idx) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned s2 = __shfl_xor_sync(0xffffffffu, sad, off);
    const int i2 = __shfl_xor_sync(0xffffffffu, idx, off);
    if (better(s2, i2, sad, idx)) {
      sad = s2;
      idx = i2;
    }
  }
  __syncthreads();
  if (lane == 0) {
    red_sad[warp] = sad;
    red_idx[warp] = idx;
  }
  __syncthreads();
  sad = red_sad[0];
  idx = red_idx[0];
  for (int k = 1; k < kWindowWarps; ++k)
    if (better(red_sad[k], red_idx[k], sad, idx)) {
      sad = red_sad[k];
      idx = red_idx[k];
    }
}

// The smallest (SAD, index) of a thread's share of an nx x ny grid of
// candidates at window offsets (ox0 + ix*step, oy0 + iy*step), index
// ix*ny + iy (the JAX order: dx outer, dy inner) less one past
// ``centre`` (the fine grid skips its centre; -1: none).  A work item
// is K candidates of one column (consecutive iy), which share the patch
// words; lanes take consecutive ix, whose rows lie in other banks.  The
// window words of a candidate's row are aligned to the patch by a
// funnel shift (its byte offset in a word is the same on every row).
template <int K>
__device__ void blocked_best(const unsigned* __restrict__ patch,
                             const uint8_t* __restrict__ win, int pitch,
                             int size, int words, unsigned lastmask, int nx,
                             int ny, int step, int ox0, int oy0, int centre,
                             unsigned& best_sad, int& best_idx) {
  const int groups = (ny + K - 1) / K;
  for (int t = threadIdx.x; t < nx * groups; t += blockDim.x) {
    const int g = t / nx, ix = t % nx;
    const int ox = ox0 + ix * step;
    const int sh = (ox & 3) * 8;
    const unsigned* rows[K];
    int idx[K];
    unsigned sum[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int iy = min(g * K + k, ny - 1);
      const int lin = ix * ny + iy;
      idx[k] = (g * K + k >= ny || lin == centre)
                   ? -1
                   : lin - (centre >= 0 && lin > centre);
      rows[k] = reinterpret_cast<const unsigned*>(
          win + (oy0 + iy * step) * pitch + (ox & ~3));
      sum[k] = 0;
    }
    for (int r = 0; r < size; ++r) {
      const unsigned* pr = patch + r * words;
      unsigned lo[K];
#pragma unroll
      for (int k = 0; k < K; ++k) lo[k] = rows[k][0];
      for (int u = 0; u + 1 < words; ++u) {
        const unsigned p = pr[u];
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const unsigned hi = rows[k][u + 1];
          sum[k] = __vsadu4(__funnelshift_r(lo[k], hi, sh), p) + sum[k];
          lo[k] = hi;
        }
      }
      const unsigned p = pr[words - 1];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        sum[k] += __vsadu4(__funnelshift_r(lo[k], rows[k][words], sh) &
                               lastmask, p);
        rows[k] += pitch / 4;
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (idx[k] >= 0 && better(sum[k], idx[k], best_sad, best_idx)) {
        best_sad = sum[k];
        best_idx = idx[k];
      }
  }
}

__global__ void __launch_bounds__(kWindowThreads)
    field_search_window_kernel(const uint8_t* __restrict__ prev0,
                               const uint8_t* __restrict__ frames,
                               const int* __restrict__ centers,
                               int* __restrict__ out, int nfields, int h,
                               int w, int size, int maxshift, int stepsize,
                               int pitch) {
  extern __shared__ unsigned smem_words[];
  __shared__ unsigned red_sad[kWindowWarps];
  __shared__ int red_idx[kWindowWarps];

  const int field = blockIdx.x;
  const int n = blockIdx.y;
  const long long plane = static_cast<long long>(h) * w;
  const uint8_t* cur = frames + n * plane;
  const uint8_t* prev = n == 0 ? prev0 : frames + (n - 1) * plane;
  const int x0 = centers[2 * field] - size / 2;
  const int y0 = centers[2 * field + 1] - size / 2;
  const int words = (size + 3) / 4;
  const int r = stepsize - 1;
  const int reach = maxshift + r;
  const int side_px = size + 2 * reach;
  unsigned* patch = smem_words;
  uint8_t* win = reinterpret_cast<uint8_t*>(smem_words + size * words);
  const unsigned lastmask =
      size % 4 ? (1u << (8 * (size % 4))) - 1u : 0xffffffffu;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  for (int i = threadIdx.x; i < size * words; i += blockDim.x) {
    const int rr = i / words, c = 4 * (i % words);
    const uint8_t* src = cur + static_cast<long long>(jidx(y0 + rr, h)) * w;
    unsigned b[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      b[k] = c + k < size ? src[jidx(x0 + c + k, w)] : 0u;
    patch[i] = pack4(b[0], b[1], b[2], b[3]);
  }
  // the window: rows y0 - reach ..., columns x0 - reach ..., zero past
  // its side; a row's reads coalesce
  for (int rr = warp; rr < side_px; rr += kWindowWarps) {
    const uint8_t* src =
        prev + static_cast<long long>(jidx(y0 - reach + rr, h)) * w;
    uint8_t* dst = win + rr * pitch;
    for (int c = lane; c < pitch; c += 32)
      dst[c] = c < side_px ? src[jidx(x0 - reach + c, w)] : 0;
  }
  __syncthreads();

  // stage 1: the coarse grid, four candidates a thread
  const int side = 2 * maxshift / stepsize + 1;
  unsigned best_sad = 0xffffffffu;
  int best_idx = 0x7fffffff;
  blocked_best<4>(patch, win, pitch, size, words, lastmask, side, side,
                  stepsize, reach - maxshift, reach - maxshift, -1, best_sad,
                  best_idx);
  reduce_best(best_sad, best_idx, red_sad, red_idx);
  int bx = -maxshift + (best_idx / side) * stepsize;
  int by = -maxshift + (best_idx % side) * stepsize;

  // stage 2: +-(stepsize-1) around the coarse best, the centre skipped,
  // one candidate a thread; the coarse best wins every tie
  if (stepsize > 1) {
    const int fside = 2 * r + 1, centre = r * fside + r;
    const unsigned coarse_sad = best_sad;
    unsigned fsad = 0xffffffffu;
    int fidx = 0x7fffffff;
    blocked_best<1>(patch, win, pitch, size, words, lastmask, fside, fside,
                    1, bx - r + reach, by - r + reach, centre, fsad, fidx);
    reduce_best(fsad, fidx, red_sad, red_idx);
    if (fsad < coarse_sad) {
      const int g = fidx + (fidx >= centre);
      bx += -r + g / fside;
      by += -r + g % fside;
    }
  }
  if (threadIdx.x == 0) {
    int* o = out + (static_cast<long long>(n) * nfields + field) * 2;
    o[0] = abs(bx) >= maxshift ? 0 : bx;
    o[1] = abs(by) >= maxshift ? 0 : by;
  }
}

// ---------------------------------------------------------------------------
// the warp

__device__ __forceinline__ int myfloor(float x) {
  return static_cast<int>(x < 0.f ? truncf(__fsub_rn(x, 1.f)) : truncf(x));
}

__device__ __forceinline__ int myround(float x) {
  return static_cast<int>(x > 0.f ? truncf(__fadd_rn(x, 0.5f))
                                  : truncf(__fsub_rn(x, 0.5f)));
}

struct Plane {
  const uint8_t* p;
  int h, w;
  float deflt;  // the value outside the source (crop) or the pixel's own
  __device__ __forceinline__ float at(int x, int y) const {
    return static_cast<float>(p[static_cast<long long>(y) * w + x]);
  }
  // the PIXEL macro: bounds-checked
  __device__ __forceinline__ float pixel(int x, int y) const {
    return (x >= 0 && y >= 0 && x < w && y < h) ? at(x, y) : deflt;
  }
  __device__ __forceinline__ float clamped(int x, int y) const {
    return at(min(max(x, 0), w - 1), min(max(y, 0), h - 1));
  }
};

__device__ float bilin_border(const Plane& pl, float x, float y) {
  const int xf = myfloor(x), xc = xf + 1, yf = myfloor(y), yc = yf + 1;
  const float v1 = pl.pixel(xc, yc), v2 = pl.pixel(xc, yf);
  const float v3 = pl.pixel(xf, yc), v4 = pl.pixel(xf, yf);
  const float wx1 = __fsub_rn(x, static_cast<float>(xf));
  const float wx0 = __fsub_rn(static_cast<float>(xc), x);
  const float wy1 = __fsub_rn(y, static_cast<float>(yf));
  const float wy0 = __fsub_rn(static_cast<float>(yc), y);
  const float a = __fmaf_rn(v1, wx1, __fmul_rn(v3, wx0));
  const float b = __fmaf_rn(v2, wx1, __fmul_rn(v4, wx0));
  return __fmaf_rn(a, wy1, __fmul_rn(b, wy0));
}

// the Catmull-Rom tap, truncated as the C's short
__device__ __forceinline__ float bicub_tap(float t, float a0, float a1,
                                           float a2, float a3) {
  // integer-valued operands: these sums and products are exact
  const float u3 = -a0 + 3.f * a1 - 3.f * a2 + a3;
  const float u2 = 2.f * a0 - 5.f * a1 + 4.f * a2 - a3;
  const float u1 = -a0 + a2;
  const float m = __fmaf_rn(t, __fmaf_rn(t, u3, u2), u1);
  return truncf(__fmul_rn(__fadd_rn(2.f * a1, __fmul_rn(t, m)), 0.5f));
}

template <int kInterp>
__device__ float interpolate(const Plane& pl, float x, float y) {
  if (kInterp == 0) {
    return pl.pixel(myround(x), myround(y));
  } else if (kInterp == 1) {
    const int xf = myfloor(x), xc = xf + 1, yn = myround(y);
    const float v1 = pl.pixel(xc, yn), v2 = pl.pixel(xf, yn);
    return __fmaf_rn(v1, __fsub_rn(x, static_cast<float>(xf)),
                     __fmul_rn(v2, __fsub_rn(static_cast<float>(xc), x)));
  } else if (kInterp == 2) {
    return bilin_border(pl, x, y);
  } else if (kInterp == 3) {
    if (!(x >= 0.f && x <= static_cast<float>(pl.w - 1) && y >= 0.f &&
          y <= static_cast<float>(pl.h - 1)))
      return bilin_border(pl, x, y);
    const int xf = myfloor(x), xc = xf + 1, yf = myfloor(y), yc = yf + 1;
    const float v1 = pl.pixel(xc, yc), v2 = pl.pixel(xc, yf);
    const float v3 = pl.pixel(xf, yc), v4 = pl.pixel(xf, yf);
    const float wx1 = __fsub_rn(x, static_cast<float>(xf));
    const float wx0 = __fsub_rn(static_cast<float>(xc), x);
    const float wy1 = __fsub_rn(y, static_cast<float>(yf));
    const float wy0 = __fsub_rn(static_cast<float>(yc), y);
    const float f1 = __fsub_rn(1.f, __fsqrt_rn(fabsf(__fmul_rn(wx0, wy0))));
    const float f2 = __fsub_rn(1.f, __fsqrt_rn(fabsf(__fmul_rn(wx0, wy1))));
    const float f3 = __fsub_rn(1.f, __fsqrt_rn(fabsf(__fmul_rn(wx1, wy0))));
    const float f4 = __fsub_rn(1.f, __fsqrt_rn(fabsf(__fmul_rn(wx1, wy1))));
    const float num = __fmaf_rn(
        v4, f4, __fmaf_rn(v3, f3, __fmaf_rn(v1, f1, __fmul_rn(v2, f2))));
    const float den = __fadd_rn(__fadd_rn(__fadd_rn(f1, f2), f3), f4);
    return __fdiv_rn(num, den);
  } else {
    if (!(x >= 1.f && x <= static_cast<float>(pl.w - 2) && y >= 1.f &&
          y <= static_cast<float>(pl.h - 2)))
      return bilin_border(pl, x, y);
    const int xf = myfloor(x), yf = myfloor(y);
    const float tx = __fsub_rn(x, static_cast<float>(xf));
    float rows[4];
#pragma unroll
    for (int dy = -1; dy <= 2; ++dy)
      rows[dy + 1] = bicub_tap(tx, pl.clamped(xf - 1, yf + dy),
                               pl.clamped(xf, yf + dy),
                               pl.clamped(xf + 1, yf + dy),
                               pl.clamped(xf + 2, yf + dy));
    const float s = bicub_tap(__fsub_rn(y, static_cast<float>(yf)), rows[0],
                              rows[1], rows[2], rows[3]);
    // the C maps the final short through (unsigned char): mod 256
    const int q = static_cast<int>(s) % 256;
    return static_cast<float>(q < 0 ? q + 256 : q);
  }
}

template <int kInterp>
__global__ void warp_kernel(const uint8_t* __restrict__ src,
                            const float* __restrict__ fparams,
                            const int* __restrict__ iparams,
                            uint8_t* __restrict__ dst, int n, int h, int w,
                            int crop, int default_val) {
  const long long plane = static_cast<long long>(h) * w;
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (i >= plane * n) return;
  const int f = static_cast<int>(i / plane);
  const int rem = static_cast<int>(i % plane);
  const int y = rem / w, x = rem % w;
  const uint8_t* p = src + f * plane;
  const uint8_t own = p[rem];
  const int* ip = iparams + 3 * f;
  uint8_t res;
  if (ip[2]) {
    // pure translation: the rounded integer copy
    const int sx = x - ip[0], sy = y - ip[1];
    const bool valid = sx >= 0 && sx < w && sy >= 0 && sy < h;
    res = valid ? p[static_cast<long long>(sy) * w + sx]
                : (crop == 1 ? static_cast<uint8_t>(default_val) : own);
  } else {
    const float* fp = fparams + 4 * f;
    const float zcos = fp[0], zsin = fp[1];
    const float xd = __fsub_rn(static_cast<float>(x), 0.5f * w);
    const float yd = __fsub_rn(static_cast<float>(y), 0.5f * h);
    const float xs = __fadd_rn(__fmaf_rn(zcos, xd, __fmul_rn(zsin, yd)),
                               fp[2]);
    const float ys = __fadd_rn(__fmaf_rn(-zsin, xd, __fmul_rn(zcos, yd)),
                               fp[3]);
    const Plane pl{p, h, w,
                   crop == 1 ? static_cast<float>(default_val)
                             : static_cast<float>(own)};
    res = static_cast<uint8_t>(
        static_cast<int>(truncf(interpolate<kInterp>(pl, xs, ys))));
  }
  dst[i] = res;
}

}  // namespace

TC_API int tc_stabilize_field_search(const uint8_t* prev, const uint8_t* frames,
                                     const int* centers, int* out, int n,
                                     int nfields, int h, int w, int size,
                                     int maxshift, int stepsize,
                                     cudaStream_t stream) {
  const int words = (size + 3) / 4;
  const size_t patch_bytes =
      static_cast<size_t>(size) * words * sizeof(unsigned);
  // the window's side, and a row pitch that leaves room for the last
  // word's funnel shift, an odd number of words: the lanes of a warp
  // read rows stepsize apart, which then meet in fewer banks
  const long long side_px = size + 2LL * (maxshift + stepsize - 1);
  const long long pitch = ((side_px + 8 + 3) / 4 | 1) * 4;
  const long long window_bytes = patch_bytes + side_px * pitch;
  if (window_bytes <= 200 * 1024) {
    const int smem = static_cast<int>(window_bytes);
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          field_search_window_kernel,
          cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    field_search_window_kernel<<<dim3(nfields, n), kWindowThreads, smem,
                                 stream>>>(prev, frames, centers, out,
                                           nfields, h, w, size, maxshift,
                                           stepsize, static_cast<int>(pitch));
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem = patch_bytes;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        field_search_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  field_search_kernel<<<dim3(nfields, n), kSearchThreads, smem, stream>>>(
      prev, frames, centers, out, nfields, h, w, size, maxshift, stepsize);
  return static_cast<int>(cudaGetLastError());
}

TC_API int tc_transform_warp(const uint8_t* src, const float* fparams,
                             const int* iparams, uint8_t* dst, int n, int h,
                             int w, int interp, int crop, int default_val,
                             cudaStream_t stream) {
  constexpr int kThreads = 256;
  const unsigned blocks =
      tc_blocks(static_cast<long long>(n) * h * w, kThreads);
  switch (interp) {
    case 0:
      warp_kernel<0><<<blocks, kThreads, 0, stream>>>(
          src, fparams, iparams, dst, n, h, w, crop, default_val);
      break;
    case 1:
      warp_kernel<1><<<blocks, kThreads, 0, stream>>>(
          src, fparams, iparams, dst, n, h, w, crop, default_val);
      break;
    case 2:
      warp_kernel<2><<<blocks, kThreads, 0, stream>>>(
          src, fparams, iparams, dst, n, h, w, crop, default_val);
      break;
    case 3:
      warp_kernel<3><<<blocks, kThreads, 0, stream>>>(
          src, fparams, iparams, dst, n, h, w, crop, default_val);
      break;
    default:
      warp_kernel<4><<<blocks, kThreads, 0, stream>>>(
          src, fparams, iparams, dst, n, h, w, crop, default_val);
      break;
  }
  return static_cast<int>(cudaGetLastError());
}
