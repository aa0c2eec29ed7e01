// hqdn3d and denoise3d scans for Hopper (sm_90a).
//
// Replaces, in tcforge_tpu/ops/kernels.py:
//   - spatial_scan (:221, _spatial_kernel, mode "hq", step _lpm_compute):
//     hqdn3d_spatial_scan below, the H and V passes;
//   - temporal_scan (:277, _temporal_kernel): hqdn3d_temporal_scan below;
//   - spatial_scan (:221, mode "d3", step _d3_lowpass): d3_spatial_scan
//     below, the H and V passes;
//   - temporal3d_scan (:337, _temporal3d_kernel): d3_temporal_scan below.
//
// hqdn3d's step is LowPassMul (filter_hqdn3d.c:49-54)
//     lpm(prev, curr) = curr + C[(prev - curr + 0x10007FF) >> 12]
// with C the exact 8192-entry int32 PrecalcCoefs table, in the 16.16
// domain; denoise3d's is LowPass (filter_denoise3d.c:101)
//     lowpass(prev, curr) = curr + C[prev - curr + 256]
// with C its 512-entry table, in the uint8 domain.  The TPU kernels
// evaluate C as a closed-form pow plus probed +-1 corrections because
// table lookups are slow there; here the table (32 KB or 2 KB) sits in
// shared memory, loaded once per block, and the lookup is one shared
// load, so the result is exact by construction.  The two filters differ
// only in the step, the domain a uint8 sample is loaded into and what
// the temporal pass carries, so one template on a step type serves both.
// The index into C is clamped to the table: for uint8-derived input it
// lies in [16, 8176] (hqdn3d.py:50-51) or [1, 511], so the clamp only
// keeps shared memory safe.
//
// What bounds the spatial scans: bytes, 1 B in and 4 B out per sample
// on the H pass, 4 + 4 on the V pass (0.086 ms per 16-frame 720p
// YUV420 batch at 3.35 TB/s).  But the step is nonlinear, so each line
// is one serial chain (no parallel prefix), and a line of the luma H
// pass is 1280 steps long with only 11,520 lines (5,760 for chroma) to
// spread over the card.  The design keeps device memory off the chain;
// what is left is the chain's own latency, which sets the floor.
//
// Measured (chip_smoke.py phase 3, NVIDIA H100 80GB HBM3, 700.00 W),
// per 16-frame batch: hq 0.302 ms (0.319 before each block's table
// load started at its own chunk, below) and d3 0.210 ms, against the
// design before this one, 0.937-0.946 and 0.840-0.841 timed the same way
// (one thread per line, each load consumed in the step that issued it,
// an uncoalesced H pass: 288 / 235 ns a step).  The luma H pass takes
// 0.086 / 0.056 ms, 67 / 44 ns a step (hq 76 before the staggered table
// load); at batch 1 (one warp per SM) 64 / 41 ns, so the time is each
// warp's own latency, not the bytes: a 1280-step line takes 82 / 52 us
// however few lines share the card, against a byte bound of 22 us for
// the luma H pass.  The V passes take 0.058 / 0.056 ms, near half the
// device-memory rate.
//
// Design, H pass (lines along W, scan_rows_kernel): one warp per block
// owns 32 rows, one lane per row.  The warp stages 32-row x 128-sample
// tiles into shared memory with 16-byte cp.async copies (a warp copies
// 128-byte row segments, so they coalesce) into a two-stage ring: the
// next tile is in flight while the lanes scan the current one.  Each
// lane reads its row 16 bytes at a time; the 16-byte chunks of row r
// sit at chunk index c ^ (r & 7), so the 8 lanes of a shared-memory
// phase hit 8 distinct bank groups.  Results go to a shared int32 tile
// (same swizzle) and from there to device memory as 16-byte stores, a
// row of the tile per warp instruction.  Rows whose byte length is not
// a multiple of 16, or unaligned pointers, take the same kernel with
// element-wise staging and stores (off the paths; exact all the same).
// One-warp blocks put the most blocks on the SMs that the line count
// allows (360 luma, 180 chroma per batch).
//
// Design, V pass (lines along H, scan_cols_kernel): one thread per
// column of a 64-column block, so the device-memory traffic of a warp
// coalesces.  The block stages 32-row x 64-column tiles with 16-byte
// cp.async copies into a four-stage ring, three tiles ahead of the one
// being scanned, so the chain reads its samples from shared memory;
// results go straight to device memory, a coalesced row per warp
// store.  (Keeping the next 32 rows in registers instead ran slower
// than the previous design.)  320 luma and 160 chroma blocks per batch.
//
// The table: shared memory, loaded once per block (32 KB for hqdn3d),
// each block starting at its own 16-byte chunk, so that the blocks that
// load at one time do not queue on the same L2 lines (the hq spatial
// scan's batch from 0.318 to 0.302 ms; d3's 2 KB table gains nothing).
// The chain: Chain carries the last table value, so only the shared
// load, the clamped add (a DPX add-min-relu, __viaddmin_s32_relu) and
// the index's shift and address are serial.
//
// Design, temporal pass (temporal_scan_kernel): what bounds it is bytes,
// the int32 V-pass output read once (16 frames) and a byte per sample
// written, 0.036 ms per 720p YUV420 batch.  The previous design ran one
// thread per pixel in 128-thread blocks, and each of ~10,800 blocks per
// batch loaded the whole table for 16 steps of 128 pixels.  Now as many
// blocks as fit on the card at once (512 threads for hq, 256 for d3)
// load the table once and stride over the plane; a thread takes four
// neighbouring pixels (four independent chains), loads sixteen frames
// of them ahead as 16-byte vectors and stores a 4-byte word per frame;
// a scalar tail takes plane % 4 and unaligned pointers.  The hq step
// carries FrameAnt << 8, which is one mask of dst + 0x1000007F, clamps
// its index with the DPX add-min-relu, and packs the four output bytes
// (byte 2 of dst + 0x10007FFF) with PRMT.  Measured (chip_smoke.py phase 3 with
// --parent, V-pass outputs and carries as the path feeds them, NVIDIA
// H100 80GB HBM3, 700.00 W), per 720p batch: hq 0.055 ms and d3 0.049,
// against the previous design's 0.108 and 0.048 timed in turns in the
// same run; d3's small table gave the old design little to lose.
//
// Why the V pass is not fused with the temporal scan: a fused kernel
// would run one thread per column over 16 frames x 720 rows, i.e. 1280
// luma lines each 11,520 steps long: at the 64 ns a step of a line
// that has an SM to itself (above), 0.74 ms, too few chains for 132 SMs
// and twelve times the V pass's time; the int32 round trip it saves
// costs less than that.
#include "common.cuh"

namespace {

constexpr int kTemporalPix = 4;        // temporal scans: pixels per thread
constexpr int kTileCols = 128;    // H pass: samples per row per tile
constexpr int kStages = 2;        // H pass: tiles in flight per warp
constexpr int kColThreads = 64;   // V pass: columns per block
constexpr int kVRows = 32;        // V pass: rows per tile
constexpr int kVStages = 4;       // V pass: tiles in flight per block

// hqdn3d (filter_hqdn3d.c): 16.16 samples; the temporal pass carries
// the 16-bit FrameAnt and emits the rounded byte
// (tcforge_tpu/modules/filters/hqdn3d.py:118-126).
struct HqStep {
  static constexpr int kLutSize = 8192;
  static __device__ __forceinline__ int load(uint8_t v) { return static_cast<int>(v) << 16; }
  static __device__ __forceinline__ int load(int32_t v) { return v; }
  static __device__ __forceinline__ int step(int prev, int curr, const int* lut) {
    int d = (prev - curr + 0x10007FF) >> 12;
    d = min(max(d, 0), kLutSize - 1);
    return curr + lut[d];
  }
  // the index as Chain computes it: clamp(prev - curr + kOffset, 0,
  // 2^25 - 1) >> 12 equals the clamp of the shifted value, since >> 12
  // is monotone and maps [0, 2^25) onto [0, 8192)
  static constexpr unsigned kOffset = 0x10007FF;
  static __device__ __forceinline__ int index(int t, int off) {
    return __viaddmin_s32_relu(t, off, (kLutSize << 12) - 1) >> 12;
  }
  // The temporal pass carries FrameAnt << 8, which is the next step's
  // prev: ((dst + 0x1000007F) >> 8 & 0xFFFF) << 8 is one mask.  It
  // returns a word whose byte kEmitByte is the output byte
  // ((dst + 0x10007FFF) >> 16) & 0xFF.
  static constexpr int kEmitByte = 2;
  // temporal pass: threads per block and frames loaded ahead, each
  // step's fastest in probes on the card
  static constexpr int kTemporalThreads = 512, kTemporalBatch = 16;
  static __device__ __forceinline__ int carry_in(int ant) { return ant << 8; }
  static __device__ __forceinline__ int carry_out(int c) { return c >> 8; }
  static __device__ __forceinline__ uint32_t temporal(int& c, int v, const int* lut) {
    const int dst = v + lut[index(c - v, kOffset)];
    c = (dst + 0x1000007F) & 0xFFFF00;
    return static_cast<uint32_t>(dst + 0x10007FFF);
  }
};

// denoise3d (filter_denoise3d.c:123-185): uint8-domain samples; the
// temporal pass carries its own previous output frame
// (tcforge_tpu/modules/filters/denoise3d.py:77-82).
struct D3Step {
  static constexpr int kLutSize = 512;
  static __device__ __forceinline__ int load(uint8_t v) { return static_cast<int>(v); }
  static __device__ __forceinline__ int load(int32_t v) { return v; }
  static __device__ __forceinline__ int step(int prev, int curr, const int* lut) {
    const int d = min(max(prev - curr + 256, 0), kLutSize - 1);
    return curr + lut[d];
  }
  static constexpr unsigned kOffset = 256;
  static __device__ __forceinline__ int index(int t, int off) {
    return __viaddmin_s32_relu(t, off, kLutSize - 1);
  }
  // The temporal pass carries the previous output; byte 0 of it is the
  // output byte.
  static constexpr int kEmitByte = 0;
  static constexpr int kTemporalThreads = 256, kTemporalBatch = 16;
  static __device__ __forceinline__ int carry_in(int prev) { return prev; }
  static __device__ __forceinline__ int carry_out(int c) { return c; }
  static __device__ __forceinline__ uint32_t temporal(int& c, int v, const int* lut) {
    c = v + lut[index(c - v, kOffset)];
    return static_cast<uint32_t>(c);
  }
};

// A spatial scan line, step by step.  out = c + t, with c the last
// sample and t its table value, so the next index argument
// out - curr + kOffset = t + (c + kOffset - curr) has only t on the
// serial chain: per step the chain is one shared load (t), one DPX
// add-min-relu (the clamped argument) and the index's address math.
// Sums wrap as the plain version's int32 sums do.
template <typename Step>
struct Chain {
  int c = 0, t = 0;
  __device__ __forceinline__ int start(int curr) {
    c = curr;
    t = 0;
    return curr;
  }
  __device__ __forceinline__ int next(int curr, const int* lut) {
    const int off = static_cast<int>(static_cast<unsigned>(c) + Step::kOffset -
                                     static_cast<unsigned>(curr));
    t = lut[Step::index(t, off)];
    c = curr;
    return static_cast<int>(static_cast<unsigned>(c) + static_cast<unsigned>(t));
  }
};

// The table into shared memory.  Every block reads the same bytes, so
// each starts at its own 16-byte chunk (97 chunks on per block, modulo
// the table): blocks that load at one time then spread over L2 instead
// of queueing on the same lines.
template <int N>
__device__ __forceinline__ void load_lut(int* lut, const int32_t* __restrict__ g) {
  if (aligned16(g)) {
    const unsigned rotate = (blockIdx.x + gridDim.x * blockIdx.y) * 97u;
    for (int i = threadIdx.x; i < N / 4; i += blockDim.x) {
      const int k = static_cast<int>((i + rotate) % (N / 4));
      reinterpret_cast<int4*>(lut)[k] = reinterpret_cast<const int4*>(g)[k];
    }
  } else {
    for (int i = threadIdx.x; i < N; i += blockDim.x) lut[i] = g[i];
  }
  __syncthreads();
}

// The H pass's shared layout for input type T: a tile row is kRowBytes
// (kChunks 16-byte chunks of kPer samples); chunk c of row r is stored
// at c ^ (r & 7).  The int32 result tile has kTileCols / 4 chunks a row.
template <typename T>
struct RowTile {
  static constexpr int kPer = 16 / sizeof(T);
  static constexpr int kChunks = kTileCols / kPer;
  static constexpr int kRowBytes = kTileCols * sizeof(T);
  static constexpr int kInBytes = 32 * kRowBytes;
  static constexpr int kOutBytes = 32 * kTileCols * 4;
};

template <typename T>
__device__ __forceinline__ int swz_byte(int r, int b) {
  return r * RowTile<T>::kRowBytes + ((((b >> 4) ^ (r & 7))) << 4) + (b & 15);
}

// Stage columns [c0, c0 + kTileCols) of rows [row0, row0 + 32) of x.
// vec: 16-byte cp.async copies (rows 16-byte aligned, width * sizeof(T)
// a multiple of 16); else element-wise loads and shared stores.
template <typename T>
__device__ __forceinline__ void stage_tile(unsigned char* tile, const T* __restrict__ x,
                                           int row0, int rows, int width, int c0, bool vec) {
  using L = RowTile<T>;
  const int lane = threadIdx.x;
  if (vec) {
    for (int e = lane; e < 32 * L::kChunks; e += 32) {
      const int r = e / L::kChunks, c = e % L::kChunks;
      const int col = c0 + c * L::kPer;
      if (row0 + r < rows && col < width)
        cp_async16(tile + swz_byte<T>(r, c * 16),
                   x + static_cast<long long>(row0 + r) * width + col);
    }
  } else {
    for (int e = lane; e < 32 * kTileCols; e += 32) {
      const int r = e / kTileCols, col = e % kTileCols;
      if (row0 + r < rows && c0 + col < width)
        *reinterpret_cast<T*>(tile + swz_byte<T>(r, col * static_cast<int>(sizeof(T)))) =
            x[static_cast<long long>(row0 + r) * width + c0 + col];
    }
  }
}

// Scan the kPer samples of one 16-byte chunk into res; kFirst: the
// chunk starts the line, whose first sample passes through.
template <typename Step, typename T, bool kFirst>
__device__ __forceinline__ void scan_chunk(const uint4 chunk, Chain<Step>& line, int* res,
                                           const int* lut) {
  constexpr int kPer = RowTile<T>::kPer;
  union { uint4 u; T t[kPer]; } v;
  v.u = chunk;
#pragma unroll
  for (int s = 0; s < kPer; ++s) {
    const int curr = Step::load(v.t[s]);
    res[s] = (kFirst && s == 0) ? line.start(curr) : line.next(curr, lut);
  }
}

// H pass: out[r, 0] = x[r, 0]; out[r, s] = step(out[r, s-1], x[r, s])
// over rows r < rows of width samples.  One warp per block.
template <typename Step, typename T>
__global__ void __launch_bounds__(32)
scan_rows_kernel(const T* __restrict__ x, int32_t* __restrict__ out,
                 const int32_t* __restrict__ lut_g, int rows, int width, bool vec) {
  using L = RowTile<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  int* lut = reinterpret_cast<int*>(smem);
  unsigned char* ring = smem + Step::kLutSize * 4;
  int* res_tile = reinterpret_cast<int*>(ring + kStages * L::kInBytes);
  load_lut<Step::kLutSize>(lut, lut_g);

  const int lane = threadIdx.x;
  const int row0 = blockIdx.x * 32;
  const int tiles = (width + kTileCols - 1) / kTileCols;
  Chain<Step> line;
  if (vec) {
    stage_tile<T>(ring, x, row0, rows, width, 0, true);
    cp_async_commit();
  }
  for (int t = 0; t < tiles; ++t) {
    const int c0 = t * kTileCols;
    unsigned char* tile = ring + (t % kStages) * L::kInBytes;
    if (vec) {
      if (t + 1 < tiles)
        stage_tile<T>(ring + ((t + 1) % kStages) * L::kInBytes, x, row0, rows, width,
                      c0 + kTileCols, true);
      cp_async_commit();
      cp_async_wait<kStages - 1>();
    } else {
      stage_tile<T>(tile, x, row0, rows, width, c0, false);
    }
    __syncwarp();

    // Each lane scans its own row.  Samples past the row's end (last
    // tile only) and rows past `rows` are scanned too, on whatever the
    // tile holds: the clamped index keeps that safe, nothing of it is
    // stored, and it keeps the warp converged.
    const int n = min(kTileCols, width - c0);
#pragma unroll 1
    for (int q = 0; q < L::kChunks; ++q) {
      if (q * L::kPer >= n) break;
      const uint4 chunk = *reinterpret_cast<const uint4*>(
          tile + lane * L::kRowBytes + ((q ^ (lane & 7)) << 4));
      int res[L::kPer];
      if (t == 0 && q == 0) {
        scan_chunk<Step, T, true>(chunk, line, res, lut);
      } else {
        scan_chunk<Step, T, false>(chunk, line, res, lut);
      }
#pragma unroll
      for (int g = 0; g < L::kPer / 4; ++g) {
        const int oc = q * (L::kPer / 4) + g;
        *reinterpret_cast<int4*>(res_tile + lane * kTileCols + ((oc ^ (lane & 7)) << 2)) =
            make_int4(res[4 * g], res[4 * g + 1], res[4 * g + 2], res[4 * g + 3]);
      }
    }
    __syncwarp();

    if (vec) {   // a tile row per instruction: lane j stores columns 4j..4j+3
      const int col = c0 + 4 * lane;
#pragma unroll 4
      for (int r = 0; r < 32; ++r) {
        if (row0 + r < rows && col < width)
          *reinterpret_cast<int4*>(out + static_cast<long long>(row0 + r) * width + col) =
              *reinterpret_cast<const int4*>(res_tile + r * kTileCols +
                                             ((lane ^ (r & 7)) << 2));
      }
    } else {
      for (int e = lane; e < 32 * kTileCols; e += 32) {
        const int r = e / kTileCols, col = e % kTileCols;
        if (row0 + r < rows && c0 + col < width)
          out[static_cast<long long>(row0 + r) * width + c0 + col] =
              res_tile[r * kTileCols + (((col >> 2) ^ (r & 7)) << 2) + (col & 3)];
      }
    }
    __syncwarp();
  }
}

// The V pass's shared layout for input type T: a stage holds kVRows
// rows of the block's kColThreads columns.
template <typename T>
struct ColTile {
  static constexpr int kPer = 16 / sizeof(T);
  static constexpr int kRowBytes = kColThreads * sizeof(T);
  static constexpr int kChunks = kRowBytes / 16;
  static constexpr int kBytes = kVRows * kRowBytes;
};

// Stage rows [r0, r0 + kVRows) of columns [c0, c0 + kColThreads) of one
// image; vec: 16-byte cp.async copies, else element-wise.
template <typename T>
__device__ __forceinline__ void stage_rows(unsigned char* tile, const T* __restrict__ x,
                                           int r0, int c0, int height, int width, bool vec) {
  using L = ColTile<T>;
  if (vec) {
    for (int e = threadIdx.x; e < kVRows * L::kChunks; e += kColThreads) {
      const int r = e / L::kChunks, c = e % L::kChunks;
      const int col = c0 + c * L::kPer;
      if (r0 + r < height && col < width)
        cp_async16(tile + r * L::kRowBytes + c * 16,
                   x + static_cast<long long>(r0 + r) * width + col);
    }
  } else {
    const int col = c0 + threadIdx.x;
    if (col < width)
      for (int r = 0; r < kVRows && r0 + r < height; ++r)
        reinterpret_cast<T*>(tile + r * L::kRowBytes)[threadIdx.x] =
            x[static_cast<long long>(r0 + r) * width + col];
  }
}

// V pass over (batch, height, width): lines are the columns of each
// image, one thread per column.  Grid (column blocks, batch).
template <typename Step, typename T>
__global__ void __launch_bounds__(kColThreads)
scan_cols_kernel(const T* __restrict__ x, int32_t* __restrict__ out,
                 const int32_t* __restrict__ lut_g, int height, int width, bool vec) {
  using L = ColTile<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  int* lut = reinterpret_cast<int*>(smem);
  unsigned char* ring = smem + Step::kLutSize * 4;
  load_lut<Step::kLutSize>(lut, lut_g);

  const int c0 = blockIdx.x * kColThreads;
  const int col = c0 + threadIdx.x;
  const long long plane = static_cast<long long>(blockIdx.y) * height * width;
  const T* src = x + plane;
  int32_t* dst = out + plane + col;
  const int tiles = (height + kVRows - 1) / kVRows;
  if (vec) {
    for (int t = 0; t < kVStages - 1; ++t) {
      if (t < tiles) stage_rows<T>(ring + t * L::kBytes, src, t * kVRows, c0, height, width, true);
      cp_async_commit();
    }
  }
  Chain<Step> line;
  for (int t = 0; t < tiles; ++t) {
    const unsigned char* tile = ring + (t % kVStages) * L::kBytes;
    if (vec) {
      const int ahead = t + kVStages - 1;
      if (ahead < tiles)
        stage_rows<T>(ring + (ahead % kVStages) * L::kBytes, src, ahead * kVRows, c0, height,
                      width, true);
      cp_async_commit();
      cp_async_wait<kVStages - 1>();
    } else {
      stage_rows<T>(ring + (t % kVStages) * L::kBytes, src, t * kVRows, c0, height, width,
                    false);
    }
    __syncthreads();
    if (col < width) {
      const int n = min(kVRows, height - t * kVRows);
      int r = 0;
      if (t == 0) {   // the column's first sample passes through
        dst[0] = line.start(Step::load(reinterpret_cast<const T*>(tile)[threadIdx.x]));
        r = 1;
      }
#pragma unroll 8
      for (; r < n; ++r)
        dst[static_cast<long long>(t * kVRows + r) * width] = line.next(
            Step::load(reinterpret_cast<const T*>(tile + r * L::kRowBytes)[threadIdx.x]), lut);
    }
    __syncthreads();
  }
}

// kPix neighbouring pixels of the temporal pass, loaded and stored
// as one vector.
template <int kPix>
struct alignas(4 * kPix) Pixels {
  int v[kPix];
};

// One frame of kPix pixels (kTemporalPix or 1): each carry steps on its
// sample of x, and the output bytes go to out[g] as one kPix-byte store.
template <typename Step, int kPix>
__device__ __forceinline__ void temporal_frame(uint8_t* out, long long g, Pixels<kPix>& carry,
                                               const Pixels<kPix>& x, const int* lut) {
  uint32_t e[kPix];
#pragma unroll
  for (int q = 0; q < kPix; ++q) e[q] = Step::temporal(carry.v[q], x.v[q], lut);
  constexpr unsigned k = Step::kEmitByte, pair = k | (4 + k) << 4;
  if constexpr (kPix == 1) {
    out[g] = static_cast<uint8_t>(e[0] >> (8 * k));
  } else {
    static_assert(kPix == 4, "four pixels a word");
    reinterpret_cast<uint32_t*>(out)[g] =
        __byte_perm(__byte_perm(e[0], e[1], pair), __byte_perm(e[2], e[3], pair), 0x5410);
  }
}

// Per pixel p, over the frames f: out[f, p] = the step of the carry on
// v[f, p].  Persistent blocks, each loading the table once, stride over
// the plane: a thread takes kPix pixels at a time (`groups` of them,
// vector loads of v and the carry, a kPix-byte store per frame, the
// loads of kBatch frames issued before their steps), then single pixels
// for the rest (plane % kPix, or every pixel when `groups` is 0).
template <typename Step>
__global__ void __launch_bounds__(Step::kTemporalThreads)
temporal_scan_kernel(const int32_t* __restrict__ v, const int32_t* __restrict__ carry_in,
                     uint8_t* __restrict__ out, int32_t* __restrict__ carry_out,
                     const int32_t* __restrict__ lut_g, int frames, long long plane,
                     long long groups) {
  constexpr int kPix = kTemporalPix, kBatch = Step::kTemporalBatch;
  using P = Pixels<kPix>;
  __shared__ __align__(16) int lut[Step::kLutSize];
  load_lut<Step::kLutSize>(lut, lut_g);
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long g = first; g < groups; g += stride) {
    P carry = reinterpret_cast<const P*>(carry_in)[g];
#pragma unroll
    for (int q = 0; q < kPix; ++q) carry.v[q] = Step::carry_in(carry.v[q]);
    int f = 0;
    for (; f + kBatch <= frames; f += kBatch) {
      P x[kBatch];
#pragma unroll
      for (int i = 0; i < kBatch; ++i)
        x[i] = reinterpret_cast<const P*>(v + (f + i) * plane)[g];
#pragma unroll
      for (int i = 0; i < kBatch; ++i)
        temporal_frame<Step, kPix>(out + (f + i) * plane, g, carry, x[i], lut);
    }
    for (; f < frames; ++f)
      temporal_frame<Step, kPix>(out + f * plane, g, carry,
                                 reinterpret_cast<const P*>(v + f * plane)[g], lut);
#pragma unroll
    for (int q = 0; q < kPix; ++q) carry.v[q] = Step::carry_out(carry.v[q]);
    reinterpret_cast<P*>(carry_out)[g] = carry;
  }
  for (long long p = kPix * groups + first; p < plane; p += stride) {
    Pixels<1> carry{{Step::carry_in(carry_in[p])}};
    for (int f = 0; f < frames; ++f)
      temporal_frame<Step, 1>(out + f * plane, p, carry, Pixels<1>{{v[f * plane + p]}}, lut);
    carry_out[p] = Step::carry_out(carry.v[0]);
  }
}

template <typename Step, typename T>
int launch_rows(const T* x, int32_t* out, const int32_t* lut, int rows, int width,
                cudaStream_t stream) {
  using L = RowTile<T>;
  constexpr int kSmem = Step::kLutSize * 4 + kStages * L::kInBytes + L::kOutBytes;
  static const cudaError_t attr = cudaFuncSetAttribute(
      scan_rows_kernel<Step, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const bool vec = aligned16(x) && aligned16(out) &&
                   (static_cast<long long>(width) * sizeof(T)) % 16 == 0;
  scan_rows_kernel<Step, T><<<tc_blocks(rows, 32), 32, kSmem, stream>>>(
      x, out, lut, rows, width, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename Step, typename T>
int launch_cols(const T* x, int32_t* out, const int32_t* lut, int batch, int height,
                int width, cudaStream_t stream) {
  constexpr int kSmem = Step::kLutSize * 4 + kVStages * ColTile<T>::kBytes;
  static const cudaError_t attr = cudaFuncSetAttribute(
      scan_cols_kernel<Step, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const bool vec = aligned16(x) && (static_cast<long long>(width) * sizeof(T)) % 16 == 0;
  const dim3 grid(tc_blocks(width, kColThreads), batch);
  scan_cols_kernel<Step, T><<<grid, kColThreads, kSmem, stream>>>(x, out, lut, height, width,
                                                                   vec);
  return static_cast<int>(cudaGetLastError());
}

// x is uint8 (x_is_u8 != 0, moved to the step's domain on load) or
// int32, (batch, height, width) contiguous; along_w: the H pass, else V.
template <typename Step>
int launch_spatial(const void* x, int x_is_u8, int32_t* out, const int32_t* lut,
                   long long batch, long long height, long long width, int along_w,
                   cudaStream_t stream) {
  if (batch * height > INT32_MAX || width > INT32_MAX || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (along_w) {
    const int rows = static_cast<int>(batch * height);
    return x_is_u8 ? launch_rows<Step>(static_cast<const uint8_t*>(x), out, lut, rows,
                                       static_cast<int>(width), stream)
                   : launch_rows<Step>(static_cast<const int32_t*>(x), out, lut, rows,
                                       static_cast<int>(width), stream);
  }
  const int b = static_cast<int>(batch), h = static_cast<int>(height),
            w = static_cast<int>(width);
  return x_is_u8 ? launch_cols<Step>(static_cast<const uint8_t*>(x), out, lut, b, h, w, stream)
                 : launch_cols<Step>(static_cast<const int32_t*>(x), out, lut, b, h, w, stream);
}

// As many blocks as fit on the card at once (no more than the work
// needs), so that each loads the table once.
template <typename Step>
int launch_temporal(const int32_t* v, const int32_t* carry_in, uint8_t* out,
                    int32_t* carry_out, const int32_t* lut, int frames,
                    long long plane, cudaStream_t stream) {
  static int resident = 0;
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, temporal_scan_kernel<Step>,
                                                          Step::kTemporalThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    resident = sms * per_sm;
  }
  constexpr int kPix = kTemporalPix;
  const auto aligned = [](const void* p, int bytes) {
    return reinterpret_cast<uintptr_t>(p) % bytes == 0;
  };
  const bool vec = plane % kPix == 0 && aligned(v, 4 * kPix) && aligned(carry_in, 4 * kPix) &&
                   aligned(carry_out, 4 * kPix) && aligned(out, kPix);
  const long long groups = vec ? plane / kPix : 0;
  const long long items = groups + (plane - kPix * groups);
  const unsigned need = tc_blocks(items, Step::kTemporalThreads);
  const unsigned blocks = need < static_cast<unsigned>(resident) ? need : resident;
  temporal_scan_kernel<Step><<<blocks, Step::kTemporalThreads, 0, stream>>>(
      v, carry_in, out, carry_out, lut, frames, plane, groups);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

TC_API int tc_hqdn3d_spatial_scan(const void* x, int x_is_u8, int32_t* out,
                                  const int32_t* lut, long long batch, long long height,
                                  long long width, int along_w, cudaStream_t stream) {
  return launch_spatial<HqStep>(x, x_is_u8, out, lut, batch, height, width, along_w, stream);
}

TC_API int tc_hqdn3d_temporal_scan(const int32_t* v, const int32_t* ant_in,
                                   uint8_t* out, int32_t* ant_out,
                                   const int32_t* lut, int frames,
                                   long long plane, cudaStream_t stream) {
  return launch_temporal<HqStep>(v, ant_in, out, ant_out, lut, frames, plane, stream);
}

TC_API int tc_d3_spatial_scan(const void* x, int x_is_u8, int32_t* out,
                              const int32_t* lut, long long batch, long long height,
                              long long width, int along_w, cudaStream_t stream) {
  return launch_spatial<D3Step>(x, x_is_u8, out, lut, batch, height, width, along_w, stream);
}

TC_API int tc_d3_temporal_scan(const int32_t* v, const int32_t* prev_in,
                               uint8_t* out, int32_t* prev_out,
                               const int32_t* lut, int frames,
                               long long plane, cudaStream_t stream) {
  return launch_temporal<D3Step>(v, prev_in, out, prev_out, lut, frames, plane, stream);
}
