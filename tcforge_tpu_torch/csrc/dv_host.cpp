// DV25 (SMPTE 314M) on the host: the bit-serial halves of the port's DV
// decoder and encoder (io/dvcodec.py), frames side by side on host threads.
//
// tc_dv_parse: each frame's video DIF blocks, the 77-byte compressed
//   macroblocks, through the run-level VLC with the three-pass bit spill of
//   the pinned Python (io/dvdec.py DVDecoder._parse_mb and _drain, and
//   decode's segment pass): a block reads its own area; the unfinished
//   blocks of a macroblock then drain, in order, the bits its blocks left;
//   the unfinished blocks of a segment of five macroblocks the bits those
//   left; a partial codeword carries across the pools.  Out: each block's
//   64 dequantized coefficients (raster order) and its DCT mode, the
//   blocks in bitstream order; the pixels are the card's (csrc/dv.cu).
// tc_dv_rate_fit: each segment's qnos from the card's table of each block's
//   AC bits at every qno (io/dvenc.py _segment_strings: from 15 down, the
//   segment's most expensive macroblock that can still step, until the
//   segment fits 5 x 536 bits).
// tc_dv_pack: each frame from its blocks' levels at those qnos: the
//   coefficient drop at the qno floor (the most expensive macroblock's most
//   expensive block loses its last nonzero level until the segment fits;
//   its cost falls by that level's codeword alone, which the Python
//   recounts whole), the codeword strings (DC, mode, class, _ac_bits),
//   _pack_segment's pass-1/2/3 placement and the DIF frame around them.
//
// The parse's bit strings are arrays of one bit a byte; the packer's are
// 64-bit words; neither touches the allocator, so frames scale across
// threads.  The tables come from the pinned Python (io/dvcodec.py), so
// the two cannot drift apart.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr int kPalBlocks = 12 * 27 * 30;
constexpr int kNtscBlocks = 10 * 27 * 30;
constexpr int kPalBytes = 144000;
constexpr int kNtscBytes = 120000;
constexpr int kQnos = 16;
constexpr int kBudget = 5 * 536;

// the bits of a frame's tables (io/dvcodec.py _blob, _vlc_blob)
struct ParseTables {
  const int32_t* lut;      // (65536, 3): length, step, level
  const int32_t* factors;  // (2, 2, 22, 64)
  const int32_t* scans;    // (2, 64)
  int block_bits[6];
  int quant_offset[4];
};

struct Source {
  const uint8_t* bits;  // one bit a byte
  int n;
  int pos = 0;
  int avail() const { return n - pos; }
  uint32_t take(int k) {
    uint32_t v = 0;
    for (int i = 0; i < k; ++i) v = (v << 1) | bits[pos + i];
    pos += k;
    return v;
  }
};

struct Block {
  int16_t* coefs;
  const int32_t* scan;
  const int32_t* factor;
  int pos = 0;
  uint32_t pb = 0;  // partial codeword bits
  int pn = 0;
  bool done = false;
};

void drain(Block& blk, Source& bs, const int32_t* lut) {
  while (!blk.done) {
    if (blk.pn + bs.avail() <= 0) return;
    int k = 16 - blk.pn;
    if (k > bs.avail()) k = bs.avail();
    const uint32_t w = (blk.pb << k) | (k ? bs.take(k) : 0u);
    const int wl = blk.pn + k;
    const int32_t* e = lut + 3 * ((w << (16 - wl)) & 0xFFFF);
    const int ln = e[0], step = e[1], level = e[2];
    if (ln == 0 || ln > wl) {
      blk.pb = w;
      blk.pn = wl;
      return;
    }
    bs.pos -= k - (ln - blk.pn);
    blk.pb = 0;
    blk.pn = 0;
    const int pos = blk.pos + step;
    if (pos > 63) {
      blk.done = true;
      return;
    }
    blk.pos = pos;
    if (level) {
      const long long v = (static_cast<long long>(level) * blk.factor[pos] + 0x2000) >> 14;
      blk.coefs[blk.scan[pos]] = static_cast<int16_t>(v);
    }
  }
}

// the bits s has not read, appended at out[*n]
void append_rest(uint8_t* out, int* n, const Source& s) {
  const int k = s.n - s.pos;
  std::memcpy(out + *n, s.bits + s.pos, k);
  *n += k;
}

// one frame: 0, or 1 short, 2 incomplete sequence, 3 the other system.
// Its bit strings live in fixed arrays (a macroblock's pool holds at most
// its 616 bits, a segment's at most five of those): frames parse side by
// side on host threads without touching the allocator.
int parse_frame(const uint8_t* data, long long len, bool want_pal, int16_t* coef, uint8_t* mode,
                const ParseTables& t) {
  if (len < kNtscBytes) return 1;
  const bool pal = data[3] & 0x80;
  if (pal != want_pal) return 3;
  const long long size = std::min<long long>(len, pal ? kPalBytes : kNtscBytes);
  const int nseq = pal ? 12 : 10;
  const uint8_t* vid[12][135];
  int count[12] = {0};
  for (long long off = 0; off < size; off += 80) {
    if (data[off] >> 5 == 4) {
      const int seq = data[off + 1] >> 4;
      if (seq < nseq) {
        if (count[seq] < 135) vid[seq][count[seq]] = data + off + 3;
        ++count[seq];
      }
    }
  }
  for (int s = 0; s < nseq; ++s)
    if (count[s] != 135) return 2;
  uint8_t bits[616];
  uint8_t mb_pool[5][616];
  int pool_n[5];
  uint8_t seg[5 * 616];
  Source mb_left[5];
  Block blocks[30];
  long long b0 = 0;
  for (int seq = 0; seq < nseq; ++seq) {
    for (int v_i = 0; v_i < 27; ++v_i) {
      for (int m = 0; m < 5; ++m) {
        const uint8_t* payload = vid[seq][5 * v_i + m];
        for (int i = 0; i < 616; ++i) bits[i] = (payload[i >> 3] >> (7 - (i & 7))) & 1;
        const int qno = payload[0] & 0x0F;
        pool_n[m] = 0;
        int bitpos = 8;
        for (int bi = 0; bi < 6; ++bi) {
          const int nbits = t.block_bits[bi];
          Source bs{bits + bitpos, nbits};
          int dc = static_cast<int>(bs.take(9));
          if (dc >= 256) dc -= 512;
          const int md = static_cast<int>(bs.take(1));
          const int cls = static_cast<int>(bs.take(2));
          const int q = qno + t.quant_offset[cls];
          Block& blk = blocks[6 * m + bi];
          blk = Block{};
          blk.coefs = coef + (b0 + 6 * m + bi) * 64;
          blk.scan = t.scans + 64 * md;
          blk.factor = t.factors + (((cls == 3 ? 1 : 0) * 2 + md) * 22 + q) * 64;
          mode[b0 + 6 * m + bi] = static_cast<uint8_t>(md);
          blk.coefs[0] = static_cast<int16_t>(dc * 4 + 1024);
          drain(blk, bs, t.lut);
          append_rest(mb_pool[m], &pool_n[m], bs);
          bitpos += nbits;
        }
        // pass 2: the macroblock's unfinished blocks drain its pool
        Source ps{mb_pool[m], pool_n[m]};
        for (int bi = 0; bi < 6; ++bi)
          if (!blocks[6 * m + bi].done) drain(blocks[6 * m + bi], ps, t.lut);
        mb_left[m] = ps;
      }
      // pass 3: the segment's unfinished blocks drain what is left
      int seg_n = 0;
      for (int m = 0; m < 5; ++m) append_rest(seg, &seg_n, mb_left[m]);
      Source ss{seg, seg_n};
      for (int i = 0; i < 30; ++i)
        if (!blocks[i].done) drain(blocks[i], ss, t.lut);
      b0 += 30;
    }
  }
  return 0;
}

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

// ---------------------------------------------------------------------- //
// encode

struct Vlc {
  const uint32_t* direct_code;  // (64, 256)
  const uint32_t* direct_len;   // (64, 256), 0 where there is no code
  const uint32_t* runonly_code;  // (64,)
  const uint32_t* runonly_len;
  const uint32_t* levelonly_code;  // (256,)
  const uint32_t* levelonly_len;
  uint32_t eob_code, eob_len;
  int block_bits[6];

  explicit Vlc(const uint32_t* blob) {
    direct_code = blob;
    direct_len = blob + 64 * 256;
    runonly_code = blob + 2 * 64 * 256;
    runonly_len = runonly_code + 64;
    levelonly_code = runonly_len + 64;
    levelonly_len = levelonly_code + 256;
    eob_code = levelonly_len[256];
    eob_len = levelonly_len[257];
    for (int i = 0; i < 6; ++i) block_bits[i] = static_cast<int>(levelonly_len[258 + i]);
  }
};

// A bit string of the packer, MSB first in 64-bit words.  A segment that
// fits its budget holds at most 5 x 616 bits in all (the rate fit and the
// drop see to it), so every string of a segment fits kBitsCap; a longer
// one marks the string bad and the segment fails.
constexpr int kBitsCap = 4096;

struct Bits {
  uint64_t w[kBitsCap / 64];
  int n = 0;
  bool bad = false;

  void put(uint32_t v, int k) {  // k <= 32
    if (k == 0) return;
    if (n + k > kBitsCap) {
      bad = true;
      return;
    }
    const uint64_t x = static_cast<uint64_t>(v) & ((1ull << k) - 1);
    const int i = n >> 6, off = n & 63, room = 64 - off;
    if (off == 0) w[i] = 0;
    if (k <= room) {
      w[i] |= x << (room - k);
    } else {
      w[i] |= x >> (k - room);
      w[i + 1] = x << (64 - (k - room));
    }
    n += k;
  }
  uint32_t get(int pos, int k) const {  // k <= 32, pos + k <= n
    const int i = pos >> 6, off = pos & 63;
    uint64_t hi = w[i] << off;
    if (off + k > 64) hi |= w[i + 1] >> (64 - off);
    return k ? static_cast<uint32_t>(hi >> (64 - k)) : 0u;
  }
  void append(const Bits& src, int pos, int len) {
    while (len > 0) {
      const int c = len < 32 ? len : 32;
      put(src.get(pos, c), c);
      pos += c;
      len -= c;
    }
  }
  void ones(int k) {
    while (k > 0) {
      const int c = k < 32 ? k : 32;
      put(0xFFFFFFFFu, c);
      k -= c;
    }
  }
};

// the bits of a nonzero level v after run zeros (the sign bit included)
int codeword_bits(int run, int v, const Vlc& t) {
  const int a = v < 0 ? -v : v;
  const uint32_t dl = t.direct_len[run * 256 + a];
  if (dl) return static_cast<int>(dl);
  return static_cast<int>((run ? t.runonly_len[run - 1] : 0) + t.levelonly_len[a]);
}

int ac_cost(const int* lv, const Vlc& t) {
  int cost = static_cast<int>(t.eob_len);
  int run = 0;
  for (int pos = 1; pos < 64; ++pos) {
    const int v = lv[pos];
    if (v == 0) {
      ++run;
      continue;
    }
    const int a = v < 0 ? -v : v;
    const uint32_t dl = t.direct_len[run * 256 + a];
    if (dl) {
      cost += dl;
    } else {
      if (run) cost += t.runonly_len[run - 1];
      cost += t.levelonly_len[a];
    }
    run = 0;
  }
  return cost;
}

void ac_bits(const int* lv, const Vlc& t, Bits& b) {
  int run = 0;
  for (int pos = 1; pos < 64; ++pos) {
    const int v = lv[pos];
    if (v == 0) {
      ++run;
      continue;
    }
    const int a = v < 0 ? -v : v;
    const uint32_t sign = v < 0 ? 1u : 0u;
    const uint32_t dl = t.direct_len[run * 256 + a];
    if (dl) {
      b.put(t.direct_code[run * 256 + a] | sign, dl);
    } else {
      if (run) b.put(t.runonly_code[run - 1], t.runonly_len[run - 1]);
      b.put(t.levelonly_code[a] | sign, t.levelonly_len[a]);
    }
    run = 0;
  }
  b.put(t.eob_code, t.eob_len);
}

// _pack_segment: five macroblocks' block strings -> five 77-byte payloads;
// false where the segment's overflow exceeds its free room
bool pack_segment(const int* qno, const Bits (&strs)[5][6], const Vlc& t, uint8_t* out) {
  Bits area[5][6];
  int free_bits[5][6];
  Bits mb_over[5];
  for (int m = 0; m < 5; ++m) {
    for (int bi = 0; bi < 6; ++bi) {
      const Bits& s = strs[m][bi];
      if (s.bad) return false;
      const int cap = t.block_bits[bi];
      if (s.n <= cap) {
        area[m][bi].append(s, 0, s.n);
        free_bits[m][bi] = cap - s.n;
      } else {
        area[m][bi].append(s, 0, cap);
        mb_over[m].append(s, cap, s.n - cap);
        free_bits[m][bi] = 0;
      }
    }
  }
  // pass 2: each macroblock's overflow into its own free tails
  Bits seg_over;
  for (int m = 0; m < 5; ++m) {
    const Bits& ov = mb_over[m];
    const int on = ov.n;
    int pos = 0;
    for (int bi = 0; bi < 6; ++bi) {
      const int f = free_bits[m][bi];
      if (f <= 0 || pos >= on) continue;
      const int take = std::min(f, on - pos);
      area[m][bi].append(ov, pos, take);
      free_bits[m][bi] -= take;
      pos += take;
    }
    if (pos < on) seg_over.append(ov, pos, on - pos);
  }
  // pass 3: the segment's overflow into the free tails in order
  const int on = seg_over.n;
  int pos = 0;
  for (int m = 0; m < 5; ++m) {
    for (int bi = 0; bi < 6; ++bi) {
      const int f = free_bits[m][bi];
      if (f <= 0 || pos >= on) continue;
      const int take = std::min(f, on - pos);
      area[m][bi].append(seg_over, pos, take);
      free_bits[m][bi] -= take;
      pos += take;
    }
  }
  if (pos != on || seg_over.bad) return false;
  for (int m = 0; m < 5; ++m) {
    Bits bs;
    bs.put(0, 4);
    bs.put(static_cast<uint32_t>(qno[m]), 4);
    for (int bi = 0; bi < 6; ++bi) {
      bs.append(area[m][bi], 0, area[m][bi].n);
      bs.ones(t.block_bits[bi] - area[m][bi].n);
    }
    uint8_t* p = out + 77 * m;
    for (int i = 0; i < 77; ++i) p[i] = static_cast<uint8_t>(bs.get(8 * i, 8));
  }
  return true;
}

// _segment_strings' end and _pack_segment for one segment (30 blocks)
bool code_segment(const int16_t* levels, const uint8_t* cls, const int16_t* dc,
                  const uint8_t* mode, const uint8_t* qno8, const Vlc& t, uint8_t* out) {
  int lv[30][64];
  int cost[30];
  int totals[5] = {0, 0, 0, 0, 0};
  for (int i = 0; i < 30; ++i) {
    for (int j = 0; j < 64; ++j) {
      lv[i][j] = levels[64 * i + j];
      if (j && (lv[i][j] > 255 || lv[i][j] < -255)) return false;
    }
    cost[i] = ac_cost(lv[i], t);
    totals[i / 6] += cost[i];
  }
  auto sum = [&]() { return totals[0] + totals[1] + totals[2] + totals[3] + totals[4]; };
  while (sum() > kBudget) {
    int m = 0;
    for (int k = 1; k < 5; ++k)
      if (totals[k] > totals[m]) m = k;
    int worst = 0;
    for (int i = 1; i < 6; ++i)
      if (cost[6 * m + i] > cost[6 * m + worst]) worst = i;
    // drop the block's last nonzero level: its codeword's bits go, the
    // earlier levels' runs and codewords stay, so the block's new cost is
    // its old one less that codeword (equal to ac_cost of the new levels)
    int* l = lv[6 * m + worst];
    int j = 63;
    while (j > 0 && !l[j]) --j;
    if (j == 0) continue;  // no AC level: the cost cannot fall (unreachable)
    int prev = j - 1;
    while (prev > 0 && !l[prev]) --prev;
    const int ncost = cost[6 * m + worst] - codeword_bits(j - prev - 1, l[j], t);
    l[j] = 0;
    totals[m] += ncost - cost[6 * m + worst];
    cost[6 * m + worst] = ncost;
  }
  Bits strs[5][6];
  int qno[5];
  for (int m = 0; m < 5; ++m) {
    qno[m] = qno8[m];
    for (int bi = 0; bi < 6; ++bi) {
      const int i = 6 * m + bi;
      Bits& b = strs[m][bi];
      b.put(static_cast<uint32_t>(dc[i]) & 0x1FF, 9);
      b.put(mode[i], 1);
      b.put(cls[i], 2);
      ac_bits(lv[i], t, b);
    }
  }
  return pack_segment(qno, strs, t, out);
}

int pack_frame(const int16_t* levels, const uint8_t* cls, const int16_t* dc, const uint8_t* mode,
               const uint8_t* qno, bool pal, const uint8_t* templates, const Vlc& t,
               uint8_t* out) {
  const int nseq = pal ? 12 : 10;
  const uint8_t* hdr = templates;
  const uint8_t* sub = templates + 77;
  const uint8_t* vaux = templates + 2 * 77;
  const uint8_t* audio = templates + 3 * 77;
  uint8_t* p = out;
  auto block = [&](uint8_t id0, int seq, int num, const uint8_t* payload) {
    p[0] = id0;
    p[1] = static_cast<uint8_t>((seq << 4) | 0x07);
    p[2] = static_cast<uint8_t>(num);
    std::memcpy(p + 3, payload, 77);
    p += 80;
  };
  std::vector<uint8_t> seg(27 * 5 * 77);
  for (int seq = 0; seq < nseq; ++seq) {
    block(0x1F, seq, 0, hdr);
    for (int k = 0; k < 2; ++k) block(0x3F, seq, k, sub);
    for (int k = 0; k < 3; ++k) block(0x56, seq, k, vaux);
    for (int v_i = 0; v_i < 27; ++v_i) {
      const long long s = seq * 27 + v_i;
      if (!code_segment(levels + 30 * s * 64, cls + 30 * s, dc + 30 * s, mode + 30 * s,
                        qno + 5 * s, t, seg.data() + 5 * 77 * v_i))
        return 1;
    }
    int audio_n = 0, video_n = 0;
    for (int n = 0; n < 144; ++n) {
      if (n % 16 == 0) {
        block(0x76, seq, audio_n++, audio);
      } else {
        block(0x96, seq, video_n, seg.data() + 77 * video_n);
        ++video_n;
      }
    }
  }
  return 0;
}

}  // namespace

// frames: n pointers to DIF frames of lens[k] bytes; coef: int16 (n * blocks,
// 64), zeroed; mode: uint8 (n * blocks); status: each frame's 0, 1 (short),
// 2 (incomplete video sequence) or 3 (not of the system want_pal says);
// tables: io/dvcodec.py _parse_tables.
extern "C" int tc_dv_parse(const uint8_t* const* frames, const long long* lens, long long n,
                           int want_pal, int16_t* coef, uint8_t* mode, int* status,
                           const int32_t* lut, const int32_t* factors, const int32_t* misc) {
  ParseTables t;
  t.lut = lut;
  t.factors = factors;
  t.scans = misc;
  for (int i = 0; i < 6; ++i) t.block_bits[i] = misc[128 + i];
  for (int i = 0; i < 4; ++i) t.quant_offset[i] = misc[134 + i];
  const long long blocks = want_pal ? kPalBlocks : kNtscBlocks;
  on_threads(n, [&](long long k) {
    status[k] = parse_frame(frames[k], lens[k], want_pal != 0, coef + k * blocks * 64,
                            mode + k * blocks, t);
  });
  return 0;
}

// table: int16 (segments * 30, 16, 2), each block's class and AC bits at
// every qno; qno: uint8 (segments * 5).
extern "C" int tc_dv_rate_fit(const int16_t* table, long long segments, uint8_t* qno) {
  for (long long s = 0; s < segments; ++s) {
    int mb[5][kQnos];
    for (int m = 0; m < 5; ++m)
      for (int q = 0; q < kQnos; ++q) {
        int c = 0;
        for (int i = 0; i < 6; ++i) c += table[((s * 30 + 6 * m + i) * kQnos + q) * 2 + 1];
        mb[m][q] = c;
      }
    int qnos[5] = {15, 15, 15, 15, 15};
    int totals[5];
    for (int m = 0; m < 5; ++m) totals[m] = mb[m][15];
    auto sum = [&]() { return totals[0] + totals[1] + totals[2] + totals[3] + totals[4]; };
    auto top = [&]() { return *std::max_element(qnos, qnos + 5); };
    while (sum() > kBudget && top() > 0) {
      int m = 0;
      int best = qnos[0] > 0 ? totals[0] : -1;
      for (int k = 1; k < 5; ++k) {
        const int key = qnos[k] > 0 ? totals[k] : -1;
        if (key > best) {
          best = key;
          m = k;
        }
      }
      if (qnos[m] == 0) break;
      --qnos[m];
      totals[m] = mb[m][qnos[m]];
    }
    for (int m = 0; m < 5; ++m) qno[s * 5 + m] = static_cast<uint8_t>(qnos[m]);
  }
  return 0;
}

// levels: int16 (frames * blocks, 64) zigzag; cls, mode: uint8 (frames *
// blocks); dc: int16; qno: uint8 (frames * blocks / 6); templates: the
// header, subcode, VAUX and audio payloads (4 x 77 bytes); vlc:
// io/dvcodec.py _vlc_blob; out: frames * 144000 or 120000 bytes; status:
// each frame's 0, or 1 where a segment does not fit (a level past 255 or an
// overflow past the segment's room).
extern "C" int tc_dv_pack(const int16_t* levels, const uint8_t* cls, const int16_t* dc,
                          const uint8_t* mode, const uint8_t* qno, long long frames, int pal,
                          const uint8_t* templates, const uint32_t* vlc, uint8_t* out,
                          int* status) {
  const Vlc t(vlc);
  const long long blocks = pal ? kPalBlocks : kNtscBlocks;
  const long long bytes = pal ? kPalBytes : kNtscBytes;
  on_threads(frames, [&](long long f) {
    status[f] = pack_frame(levels + f * blocks * 64, cls + f * blocks, dc + f * blocks,
                           mode + f * blocks, qno + f * blocks / 6, pal != 0, templates, t,
                           out + f * bytes);
  });
  return 0;
}
