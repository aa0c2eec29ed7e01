// Baseline JPEG Huffman encoder on the host: the scan of each frame of a
// batch from its quantized coefficients (io/jpegenc.py), as libjpeg-turbo's
// jchuff.c encode_one_block writes it with PIL's settings (no restart
// markers, fixed tables).
//
// The coefficients come from the card (ops/kernels.py jpeg_fdct_quant):
// int16, 64 a block in zigzag order, the blocks of a frame MCU after MCU,
// each 4:2:0 MCU's four Y blocks, Cb and Cr, dummies included.  Per block: the DC difference from the last block of the same
// component (0 at the start of a frame) as its size category's code and
// the difference's low bits (ones' complement when negative); then each
// nonzero AC coefficient as (run << 4 | size), ZRL (0xF0) for each run of
// 16 zeros before it, and EOB (0x00) unless the block ends on a nonzero
// coefficient.  Every 0xFF byte of the scan is followed by 0x00, and the
// last byte is padded with 1-bits (jchuff.c flush_bits).
//
// A frame's scan is one serial bit stream, so frames are coded side by
// side on host threads, each into its own region of the output.

#include <algorithm>
#include <cstdint>
#include <thread>
#include <vector>

namespace {

// the blocks of a 4:2:0 MCU: their component and table set (0
// luminance, 1 chrominance)
constexpr int kMcuBlocks = 6;
constexpr int kComp[kMcuBlocks] = {0, 0, 0, 0, 1, 2};
constexpr int kTable[kMcuBlocks] = {0, 0, 0, 0, 1, 1};

// the most bytes a block can take (io/jpegenc.py BLOCK_BYTES_MAX): a
// 16-bit DC code and 11 bits, 63 AC codes of 16 bits and 10, every byte
// stuffed
constexpr long long kBlockMax = 2 * ((16 + 11 + 63 * 26 + 7) / 8);

struct Writer {
  uint8_t* out;
  long long pos = 0;
  uint64_t acc = 0;  // pending bits, the oldest highest
  int nbits = 0;

  inline void byte(uint8_t b) {
    out[pos++] = b;
    if (b == 0xFF) out[pos++] = 0;
  }
  inline void put(uint32_t code, int size) {
    acc = (acc << size) | (code & ((1u << size) - 1u));
    nbits += size;
    while (nbits >= 8) {
      nbits -= 8;
      byte(static_cast<uint8_t>(acc >> nbits));
    }
    acc &= (1ull << nbits) - 1ull;
  }
  inline void flush() {
    if (nbits) byte(static_cast<uint8_t>((acc << (8 - nbits)) | (0xFFu >> nbits)));
    nbits = 0;
    acc = 0;
  }
};

inline int nbits_of(int v) {
  unsigned a = static_cast<unsigned>(v < 0 ? -v : v);
  return a ? 32 - __builtin_clz(a) : 0;
}

void encode_frame(const int16_t* coef, int blocks, const uint32_t* codes,
                  const uint8_t* sizes, uint8_t* out, long long* length) {
  Writer w{out};
  int last_dc[3] = {0, 0, 0};
  for (int b = 0; b < blocks; ++b) {
    const int k = b % kMcuBlocks;
    const int t = kTable[k];
    const uint32_t* dc_code = codes + (2 * t) * 256;
    const uint8_t* dc_size = sizes + (2 * t) * 256;
    const uint32_t* ac_code = codes + (2 * t + 1) * 256;
    const uint8_t* ac_size = sizes + (2 * t + 1) * 256;
    const int16_t* c = coef + static_cast<long long>(b) * 64;
    int diff = c[0] - last_dc[kComp[k]];
    last_dc[kComp[k]] = c[0];
    int n = nbits_of(diff);
    w.put(dc_code[n], dc_size[n]);
    if (n) w.put(static_cast<uint32_t>(diff < 0 ? diff - 1 : diff), n);
    int run = 0;
    for (int i = 1; i < 64; ++i) {
      const int v = c[i];
      if (v == 0) {
        ++run;
        continue;
      }
      while (run > 15) {
        w.put(ac_code[0xF0], ac_size[0xF0]);
        run -= 16;
      }
      n = nbits_of(v);
      const int sym = (run << 4) | n;
      w.put(ac_code[sym], ac_size[sym]);
      w.put(static_cast<uint32_t>(v < 0 ? v - 1 : v), n);
      run = 0;
    }
    if (run > 0) w.put(ac_code[0], ac_size[0]);
  }
  w.flush();
  *length = w.pos;
}

}  // namespace

// coef: int16 (frames, blocks, 64); codes/sizes: uint32/uint8 (4, 256),
// DC 0, AC 0, DC 1, AC 1; out: frames regions of cap bytes; lengths: the
// bytes of each frame's scan.
extern "C" int tc_jpeg_huff_encode(const int16_t* coef, long long frames, int blocks,
                                   const uint32_t* codes, const uint8_t* sizes, uint8_t* out,
                                   long long cap, long long* lengths) {
  if (blocks % kMcuBlocks) return -1;
  if (cap < blocks * kBlockMax + 16) return -2;
  long long threads = std::thread::hardware_concurrency();
  threads = std::max(1LL, std::min(threads, frames));
  auto run = [&](long long worker) {
    for (long long f = worker; f < frames; f += threads)
      encode_frame(coef + f * blocks * 64, blocks, codes, sizes, out + f * cap, lengths + f);
  };
  std::vector<std::thread> pool;
  for (long long t = 1; t < threads; ++t) pool.emplace_back(run, t);
  run(0);
  for (auto& th : pool) th.join();
  return 0;
}
