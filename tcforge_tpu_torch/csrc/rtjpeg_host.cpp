// RTjpeg's byte coder on the host (io/rtjcodec.py): the pinned RTjpeg_b2s
// and RTjpeg_s2b of io/rtjpeg.py (the NuppelVideo codec's portable
// branch), frames side by side on host threads.  The block transforms are
// the card's (csrc/rtjpeg.cu).
//
// b2s: a quantized block (natural order) read in zigzag order: the DC
//   clamped to 0..254, the values up to the zigzag threshold b8 clamped to
//   int8, then each nonzero value clamped to -64..63 and each run of zeros
//   as one byte 63 + its length.
// s2b: the inverse, each value times its dequantizer (the stream's table
//   with the AAN scales folded in): the DC unsigned, the rest int8.
// The blocks of a frame: per 16x16 macroblock four Y blocks (b8 and table
// of luma) and U and V (of chroma).

#include <algorithm>
#include <cstdint>
#include <thread>
#include <vector>

namespace {

template <typename F>
void on_threads(long long n, F&& work) {
  long long threads = std::thread::hardware_concurrency();
  threads = std::max(1LL, std::min(threads, n));
  auto run = [&](long long worker) {
    for (long long k = worker; k < n; k += threads) work(k);
  };
  std::vector<std::thread> pool;
  for (long long w = 1; w < threads; ++w) pool.emplace_back(run, w);
  run(0);
  for (auto& th : pool) th.join();
}

long long b2s(const int16_t* block, int b8, const int32_t* zz, uint8_t* out) {
  long long n = 0;
  const int dc = block[zz[0]];
  out[n++] = static_cast<uint8_t>(dc > 254 ? 254 : (dc < 0 ? 0 : dc));
  for (int ci = 1; ci <= b8; ++ci) {
    int v = block[zz[ci]];
    v = v > 127 ? 127 : (v < -128 ? -128 : v);
    out[n++] = static_cast<uint8_t>(v & 0xFF);
  }
  int ci = b8 + 1;
  while (ci < 64) {
    const int v = block[zz[ci]];
    if (v > 0) {
      out[n++] = static_cast<uint8_t>(std::min(v, 63));
      ++ci;
    } else if (v < 0) {
      out[n++] = static_cast<uint8_t>(std::max(v, -64) & 0xFF);
      ++ci;
    } else {
      int run = 0;
      while (ci < 64 && block[zz[ci]] == 0) {
        ++ci;
        ++run;
      }
      out[n++] = static_cast<uint8_t>(63 + run);
    }
  }
  return n;
}

// one block from strm[pos:len]: the position after it, or -1 where the
// stream ends inside the block
long long s2b(const uint8_t* strm, long long pos, long long len, int b8, const long long* qt,
              const int32_t* zz, int32_t* data) {
  for (int i = 0; i < 64; ++i) data[i] = 0;
  if (pos >= len) return -1;
  data[zz[0]] = static_cast<int32_t>(strm[pos] * qt[zz[0]]);
  long long ci = pos + 1;
  int co = 1;
  while (co <= b8) {
    if (ci >= len) return -1;
    const int v = static_cast<int8_t>(strm[ci]);
    const int i = zz[co];
    data[i] = static_cast<int32_t>(v * qt[i]);
    ++ci;
    ++co;
  }
  while (co < 64) {
    if (ci >= len) return -1;
    const int v = static_cast<int8_t>(strm[ci]);
    if (v > 63) {
      co += v - 63;
    } else {
      const int i = zz[co];
      data[i] = static_cast<int32_t>(v * qt[i]);
      ++co;
    }
    ++ci;
  }
  return ci;
}

}  // namespace

// q: int16 (frames * blocks, 64) natural order; zz: the zigzag order;
// out: frames regions of cap bytes; lengths: each frame's bytes.
extern "C" int tc_rtjpeg_b2s(const int16_t* q, long long frames, long long blocks, int lb8,
                             int cb8, const int32_t* zz, uint8_t* out, long long cap,
                             long long* lengths) {
  on_threads(frames, [&](long long f) {
    uint8_t* o = out + f * cap;
    long long n = 0;
    for (long long k = 0; k < blocks; ++k)
      n += b2s(q + (f * blocks + k) * 64, k % 6 < 4 ? lb8 : cb8, zz, o + n);
    lengths[f] = n;
  });
  return 0;
}

// frames: n pointers to payloads of lens[k] bytes; qt: int64 (2, 64)
// dequantizers (luma, chroma); coef: int32 (n * blocks, 64); status: 1
// for a payload that ends inside a block.
extern "C" int tc_rtjpeg_s2b(const uint8_t* const* frames, const long long* lens, long long n,
                             long long blocks, int lb8, int cb8, const long long* qt,
                             const int32_t* zz, int32_t* coef, int* status) {
  on_threads(n, [&](long long f) {
    long long pos = 0;
    status[f] = 0;
    for (long long k = 0; k < blocks; ++k) {
      const bool luma = k % 6 < 4;
      pos = s2b(frames[f], pos, lens[f], luma ? lb8 : cb8, luma ? qt : qt + 64, zz,
                coef + (f * blocks + k) * 64);
      if (pos < 0) {
        status[f] = 1;
        return;
      }
    }
  });
  return 0;
}
