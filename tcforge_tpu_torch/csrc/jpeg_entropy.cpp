// The Huffman decode of one scan of a baseline (8-bit, Huffman,
// sequential) JPEG, on the host.
//
// The port's own code: the JAX package decodes JPEG through PIL (its AVI
// and MOV importers call Image.open), and the machine with the card has
// no PIL.  io/jpeg.py reads the markers and calls tc_jpeg_scan once for
// each SOS; this file decodes the entropy-coded segment that follows it
// as libjpeg's jdhuff.c does (jpeg_make_d_derived_tbl, decode_mcu_slow,
// process_restart) and writes each block's coefficients, still
// quantized, in natural order, 64 int16 to a block, into the padded
// plane of its component: block (by, bx) of a component at
// out[(off + by * bw + bx) * 64].  Dequantization, the IDCT, the
// upsampling and the colour conversion are the card's
// (csrc/jpeg_decode.cu).
//
// The bit reader is jdhuff.c's: 0xFF 0x00 is a data byte 0xFF, runs of
// 0xFF are fill, any other marker ends the data, and past it the reader
// supplies zero bits.  At each restart interval the DC predictors reset
// and the reader moves past the RSTn marker.  A coefficient is stored as
// a 16-bit JCOEF, as libjpeg stores it; the DC predictor is an int.
//
// Built with g++ by ops/_build.build_host at first use and loaded with
// ctypes, which releases the interpreter lock for the call, so the
// reader thread decodes while the main thread runs the card.

#include <cstdint>
#include <cstring>
#include <initializer_list>

#define TC_API extern "C" __attribute__((visibility("default")))

namespace {

// jutils.c jpeg_natural_order, with the 16 extra entries that keep a
// corrupt run inside the block
const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

constexpr int kLookBits = 9;

// error codes (negative returns of tc_jpeg_scan)
constexpr long long kBadTable = -1;    // a Huffman table the scan needs
constexpr long long kBadCode = -2;     // a code no table holds
constexpr long long kBadRestart = -3;  // a restart marker missing
constexpr long long kBadSpec = -4;     // the scan's layout

struct Huff {
  int maxcode[18];
  int valoffset[18];
  uint8_t huffval[256];
  uint16_t look[1 << kLookBits];  // (length << 8) | symbol, 0: longer
  bool ok;
};

// jdhuff.c jpeg_make_d_derived_tbl: bits[1..16] the count of codes of
// each length, vals their symbols in order
bool build(const uint8_t* bits, const uint8_t* vals, bool dc, Huff& h) {
  uint8_t size[257];
  unsigned code[257];
  int p = 0;
  for (int l = 1; l <= 16; ++l) {
    for (int i = 0; i < bits[l]; ++i) {
      if (p >= 256) return false;
      size[p++] = static_cast<uint8_t>(l);
    }
  }
  size[p] = 0;
  const int nsym = p;
  if (nsym == 0) return false;
  unsigned c = 0;
  int si = size[0];
  p = 0;
  while (size[p]) {
    while (size[p] == si) code[p++] = c++;
    if (c >= (1u << si)) return false;  // codes overrun their length
    c <<= 1;
    ++si;
  }
  p = 0;
  for (int l = 1; l <= 16; ++l) {
    if (bits[l]) {
      h.valoffset[l] = p - static_cast<int>(code[p]);
      p += bits[l];
      h.maxcode[l] = static_cast<int>(code[p - 1]);
    } else {
      h.maxcode[l] = -1;
    }
  }
  h.valoffset[17] = 0;
  h.maxcode[17] = 0xFFFFF;
  std::memcpy(h.huffval, vals, 256);
  std::memset(h.look, 0, sizeof(h.look));
  p = 0;
  for (int l = 1; l <= kLookBits; ++l) {
    for (int i = 0; i < bits[l]; ++i, ++p) {
      const unsigned first = code[p] << (kLookBits - l);
      for (unsigned k = 0; k < (1u << (kLookBits - l)); ++k)
        h.look[first + k] = static_cast<uint16_t>((l << 8) | vals[p]);
    }
  }
  if (dc) {
    for (int i = 0; i < nsym; ++i)
      if (vals[i] > 15) return false;
  }
  h.ok = true;
  return true;
}

struct Bits {
  const uint8_t* data;
  long long size;
  long long pos;     // the next byte to read; at a marker, its 0xFF
  uint64_t buf = 0;
  int left = 0;      // bits in buf
  bool marker = false;

  // at least 57 bits in buf; zeros past a marker (jdhuff.c
  // jpeg_fill_bit_buffer)
  void fill() {
    while (left <= 56) {
      unsigned c = 0;
      if (!marker) {
        if (pos >= size) {
          marker = true;
        } else {
          c = data[pos];
          if (c == 0xFF) {
            long long q = pos + 1;
            while (q < size && data[q] == 0xFF) ++q;
            if (q < size && data[q] == 0x00) {
              pos = q + 1;
            } else {
              pos = q - 1;      // the marker's 0xFF
              marker = true;
              c = 0;
            }
          } else {
            ++pos;
          }
        }
      }
      buf = (buf << 8) | c;
      left += 8;
    }
  }

  unsigned peek(int n) {
    if (left < n) fill();
    return static_cast<unsigned>(buf >> (left - n)) & ((1u << n) - 1);
  }

  unsigned get(int n) {
    const unsigned v = peek(n);
    left -= n;
    return v;
  }

  // one symbol of table h, or -1 for a code no table holds
  int decode(const Huff& h) {
    if (left < 16) fill();
    const unsigned look = h.look[peek(kLookBits)];
    if (look) {
      left -= look >> 8;
      return look & 0xFF;
    }
    for (int l = kLookBits + 1; l <= 16; ++l) {
      const int code = static_cast<int>(peek(l));
      if (code <= h.maxcode[l]) {
        left -= l;
        return h.huffval[(code + h.valoffset[l]) & 0xFF];
      }
    }
    return -1;
  }

  // jdhuff.c process_restart's read of RSTn: the bits left are dropped,
  // the reader moves past the marker
  bool restart(int n) {
    left = 0;
    buf = 0;
    long long q = pos;
    if (!marker) {
      while (q < size && !(data[q] == 0xFF && q + 1 < size &&
                           data[q + 1] != 0x00 && data[q + 1] != 0xFF))
        ++q;
    }
    if (q + 1 >= size || data[q + 1] != 0xD0 + (n & 7)) return false;
    pos = q + 2;
    marker = false;
    return true;
  }

  // the position of the marker that ends the scan's data
  long long end() const {
    long long q = pos;
    if (marker) return q;
    while (q < size && !(data[q] == 0xFF && q + 1 < size &&
                         data[q + 1] != 0x00 && data[q + 1] != 0xFF))
      ++q;
    return q;
  }
};

inline int extend(unsigned v, int s) {
  // jdhuff.h HUFF_EXTEND
  return (v < (1u << (s - 1))) ? static_cast<int>(v) - (1 << s) + 1
                               : static_cast<int>(v);
}

// jdhuff.c decode_mcu_slow for one block
bool decode_block(Bits& b, const Huff& dc, const Huff& ac, int& pred,
                  int16_t* block) {
  std::memset(block, 0, 64 * sizeof(int16_t));
  int s = b.decode(dc);
  if (s < 0) return false;
  if (s) s = extend(b.get(s), s);
  pred += s;
  block[0] = static_cast<int16_t>(pred);
  for (int k = 1; k < 64; ++k) {
    int rs = b.decode(ac);
    if (rs < 0) return false;
    const int r = rs >> 4;
    s = rs & 15;
    if (s) {
      k += r;
      block[kNatural[k]] = static_cast<int16_t>(extend(b.get(s), s));
    } else {
      if (r != 15) break;
      k += 15;
    }
  }
  return true;
}

}  // namespace

// Decode the scan whose entropy-coded data starts at data[pos].
//
// spec (int32): the scan's component count n (1 to 4), its MCUs per row
// and MCU rows, the restart interval in MCUs (0: none), then for each
// of the n components in scan order: h, v (blocks of the component in
// one MCU; 1 and 1 in a scan of one component), bw (blocks a row of its
// padded plane), off (its plane's first block in out), its DC and AC
// table numbers, and the blocks a row and rows of blocks it really has
// (a scan of one component decodes those alone; in an interleaved scan
// the MCUs cover them, the padded blocks too).
// tables: eight tables of 273 bytes, DC 0-3 then AC 0-3: at [1..16] the
// count of codes of each length (all 0: no table), at [17..] the symbols.
//
// Returns the position of the marker after the scan's data, or a
// negative error code.
TC_API long long tc_jpeg_scan(const uint8_t* data, long long size,
                              long long pos, const int* spec,
                              const uint8_t* tables, int16_t* out) {
  const int n = spec[0];
  const int mcux = spec[1], mcuy = spec[2], interval = spec[3];
  if (n < 1 || n > 4 || mcux <= 0 || mcuy <= 0 || interval < 0)
    return kBadSpec;
  Huff huff[8];
  for (int t = 0; t < 8; ++t) huff[t].ok = false;
  const int* comp[4];
  for (int k = 0; k < n; ++k) {
    comp[k] = spec + 4 + 8 * k;
    const int dc = comp[k][4], ac = comp[k][5];
    if (dc < 0 || dc > 3 || ac < 0 || ac > 3) return kBadSpec;
    for (const int t : {dc, 4 + ac}) {
      if (huff[t].ok) continue;
      const uint8_t* tab = tables + 273 * t;
      if (!build(tab, tab + 17, t < 4, huff[t])) return kBadTable;
    }
  }
  Bits b{data, size, pos};
  int pred[4] = {0, 0, 0, 0};
  const long long mcus = static_cast<long long>(mcux) * mcuy;
  int rst = 0;
  for (long long m = 0; m < mcus; ++m) {
    if (interval && m && m % interval == 0) {
      if (!b.restart(rst++)) return kBadRestart;
      for (int& p : pred) p = 0;
    }
    const int mx = static_cast<int>(m % mcux);
    const int my = static_cast<int>(m / mcux);
    for (int k = 0; k < n; ++k) {
      const int* c = comp[k];
      const Huff& dc = huff[c[4]];
      const Huff& ac = huff[4 + c[5]];
      for (int yy = 0; yy < c[1]; ++yy) {
        for (int xx = 0; xx < c[0]; ++xx) {
          const long long by = static_cast<long long>(my) * c[1] + yy;
          const long long bx = static_cast<long long>(mx) * c[0] + xx;
          int16_t* block = out + (c[3] + by * c[2] + bx) * 64;
          if (!decode_block(b, dc, ac, pred[k], block)) return kBadCode;
        }
      }
    }
  }
  return b.end();
}
