// Theora's token coder on the host (io/theoracodec.py), both ways: the
// decoder's DCT token decode and DC prediction, the encoder's DC residuals
// and token writer.  The pixels are the card's (csrc/theora.cu).
//
// Decode (tc_th_tokens) follows the JAX package's Python token path
// (tcforge_tpu/io/theora.py _decode_tokens): the coded blocks wait for
// coefficient ci in per-ci buckets, sorted into coded order at each ci; an
// EOB run closes the next blocks; reads past the packet's end are zero
// bits.  The 80 Huffman tables come from the setup header's leaves
// (tc_th_huff_new): each must be a complete prefix code of at most 32
// leaves (the token alphabet) no deeper than 32 bits, or the handle is
// refused; a table is a tree of at most 63 nodes with an 8-bit first
// lookup, so no table indexes past what it holds.
// DC prediction (tc_th_predict_dc): _predict_dc, per plane in raster
// order, the four neighbours of the same frame class, the last DC of the
// class where none is coded, the outlier correction; sums in 64 bits, the
// coefficient wrapped to int32.
// Encode: tc_th_dc_residuals is the encoder's _dc_residuals (prediction
// from the final clamped DCs), tc_th_write_tokens its _token_events and
// _write_tokens (the decoder's bucket walk simulated, EOB runs of at most
// 4095 joined in place) appended to the packet's header bits.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kTables = 80;
constexpr int kMaxLeaves = 32;
constexpr int kMaxDepth = 32;
constexpr int kMaxNodes = 2 * kMaxLeaves - 1;
constexpr int kLutBits = 8;

// a node: child[b] >= 0 an internal node's index, < 0 a leaf -(token + 1)
struct Table {
  int16_t child[kMaxNodes][2];
  int nodes;
  int root_leaf;  // -(token + 1) where the root is a leaf (a 0-bit code)
  // the first kLutBits bits: a leaf's token and length, or the node
  // reached after kLutBits bits
  int16_t lut_next[1 << kLutBits];
  uint8_t lut_len[1 << kLutBits];
};

struct Huff {
  Table t[kTables];
};

class BitReader {
 public:
  BitReader(const uint8_t* data, long long nbytes, long long pos)
      : data_(data), nbits_(8 * nbytes), pos_(pos) {}
  long long pos() const { return pos_; }
  void skip(int n) { pos_ += n; }
  int bit_at(long long p) const {
    if (p < 0 || p >= nbits_) return 0;
    return (data_[p >> 3] >> (7 - (p & 7))) & 1;
  }
  // the next n (<= 32) bits without consuming them, zeros past the end
  uint32_t peek(int n) const {
    uint32_t v = 0;
    for (int i = 0; i < n; ++i) v = (v << 1) | bit_at(pos_ + i);
    return v;
  }
  uint32_t read(int n) {
    uint32_t v = peek(n);
    pos_ += n;
    return v;
  }
  int read1() { return bit_at(pos_++); }

 private:
  const uint8_t* data_;
  long long nbits_;
  long long pos_;
};

bool build_table(Table* t, const uint32_t* codes, const uint8_t* lens,
                 const uint8_t* toks, int count) {
  if (count < 1 || count > kMaxLeaves) return false;
  t->nodes = 1;
  t->root_leaf = 0;
  t->child[0][0] = t->child[0][1] = 0;  // 0: an empty slot (node 0 is the root)
  if (count == 1 && lens[0] == 0) {
    if (toks[0] >= 32) return false;
    t->root_leaf = -(toks[0] + 1);
    return true;
  }
  for (int i = 0; i < count; ++i) {
    const int len = lens[i];
    if (len < 1 || len > kMaxDepth || toks[i] >= 32) return false;
    if (len < 32 && (codes[i] >> len) != 0) return false;
    int node = 0;
    for (int d = len - 1; d >= 0; --d) {
      const int b = (codes[i] >> d) & 1;
      int16_t& slot = t->child[node][b];
      if (d == 0) {
        if (slot != 0) return false;  // a leaf on a taken slot
        slot = static_cast<int16_t>(-(toks[i] + 1));
      } else {
        if (slot < 0) return false;  // a code through a leaf
        if (slot == 0) {
          if (t->nodes >= kMaxNodes) return false;
          slot = static_cast<int16_t>(t->nodes);
          t->child[t->nodes][0] = t->child[t->nodes][1] = 0;
          ++t->nodes;
        }
        node = slot;
      }
    }
  }
  for (int n = 0; n < t->nodes; ++n)
    if (t->child[n][0] == 0 || t->child[n][1] == 0) return false;  // incomplete
  for (int v = 0; v < (1 << kLutBits); ++v) {
    int node = 0, len = 0;
    int16_t next = 0;
    while (len < kLutBits) {
      next = t->child[node][(v >> (kLutBits - 1 - len)) & 1];
      ++len;
      if (next < 0) break;
      node = next;
    }
    t->lut_next[v] = next < 0 ? next : static_cast<int16_t>(node);
    t->lut_len[v] = static_cast<uint8_t>(len);
  }
  return true;
}

int read_token(const Table& t, BitReader& b) {
  if (t.root_leaf) return -t.root_leaf - 1;
  const uint32_t v = b.peek(kLutBits);
  b.skip(t.lut_len[v]);
  int16_t next = t.lut_next[v];
  while (next >= 0) next = t.child[next][b.read1()];
  return -next - 1;
}

const int kCoefGroup[64] = {0, 1, 1, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2, 2, 3,
                            3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 4, 4, 4, 4,
                            4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4,
                            4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4};

// the DC predictor weights [UL, U, UR, L] by neighbour mask (theora.PRED_W)
const int kPredW[16][4] = {{0, 0, 0, 0},     {0, 0, 0, 128},    {0, 0, 128, 0},
                           {0, 0, 53, 75},   {0, 128, 0, 0},    {0, 64, 0, 64},
                           {0, 128, 0, 0},   {0, 0, 53, 75},    {128, 0, 0, 0},
                           {0, 0, 0, 128},   {64, 0, 64, 0},    {0, 0, 53, 75},
                           {0, 128, 0, 0},   {-104, 116, 0, 116}, {24, 80, 24, 0},
                           {-104, 116, 0, 116}};

int32_t wrap32(long long v) { return static_cast<int32_t>(static_cast<uint32_t>(v)); }

// the prediction of a block's DC from its coded neighbours of the same
// class (``vals`` the neighbours' DCs as read through ``dc``)
template <typename DC>
long long predict(const uint8_t* coded, const uint8_t* bclass, long long bid, int bx, int by,
                  int bw, long long last_dc, DC dc) {
  const int fc = bclass[bid];
  int idx = 0;
  long long vals[4] = {0, 0, 0, 0};  // UL, U, UR, L
  auto same = [&](long long nb) { return coded[nb] && bclass[nb] == fc; };
  if (bx > 0 && same(bid - 1)) {
    idx |= 1;
    vals[3] = dc(bid - 1);
  }
  if (by > 0) {
    const long long nb = bid - bw;
    if (same(nb)) {
      idx |= 4;
      vals[1] = dc(nb);
    }
    if (bx > 0 && same(nb - 1)) {
      idx |= 8;
      vals[0] = dc(nb - 1);
    }
    if (bx < bw - 1 && same(nb + 1)) {
      idx |= 2;
      vals[2] = dc(nb + 1);
    }
  }
  if (idx == 0) return last_dc;
  const int* w = kPredW[idx];
  const long long s = w[0] * vals[0] + w[1] * vals[1] + w[2] * vals[2] + w[3] * vals[3];
  long long pred = s / 128;  // truncates toward zero, as the C division
  if ((idx & 4) && (idx & 8) && (idx & 1)) {
    if (std::llabs(pred - vals[1]) > 128)
      pred = vals[1];
    else if (std::llabs(pred - vals[3]) > 128)
      pred = vals[3];
    else if (std::llabs(pred - vals[0]) > 128)
      pred = vals[0];
  }
  return pred;
}

class BitWriter {
 public:
  BitWriter(uint8_t* out, long long cap) : out_(out), cap_(cap) {}
  void start(const uint8_t* prefix, long long n, uint64_t acc, int nacc) {
    if (n > cap_) {
      bad_ = true;
      return;
    }
    std::memcpy(out_, prefix, n);
    len_ = n;
    acc_ = acc & ((1ULL << nacc) - 1);
    n_ = nacc;
  }
  void write(uint32_t val, int nbits) {
    if (nbits == 0) return;
    acc_ = (acc_ << nbits) | (val & ((nbits == 32 ? 0ULL : (1ULL << nbits)) - 1));
    n_ += nbits;
    while (n_ >= 8) {
      n_ -= 8;
      put(static_cast<uint8_t>((acc_ >> n_) & 0xFF));
    }
    acc_ &= (1ULL << n_) - 1;
  }
  long long finish() {
    if (n_) put(static_cast<uint8_t>((acc_ << (8 - n_)) & 0xFF));
    return bad_ ? -1 : len_;
  }

 private:
  void put(uint8_t b) {
    if (len_ >= cap_) {
      bad_ = true;
      return;
    }
    out_[len_++] = b;
  }
  uint8_t* out_;
  long long cap_;
  long long len_ = 0;
  uint64_t acc_ = 0;
  int n_ = 0;
  bool bad_ = false;
};

// one event of the token stream: raw bits, a token with its extra fields,
// or an EOB run whose count grows while it is open
struct Event {
  int kind;  // 0 raw bits, 1 token, 2 EOB run
  int group, token, count;
  int nx;
  uint32_t xv[3];
  uint8_t xn[3];
  uint32_t raw;
  int rawn;
};

Event token_event(int group, int tok) {
  Event e{};
  e.kind = 1;
  e.group = group;
  e.token = tok;
  return e;
}

void extra(Event& e, uint32_t v, int n) {
  e.xv[e.nx] = v;
  e.xn[e.nx] = static_cast<uint8_t>(n);
  ++e.nx;
}

// a nonzero coefficient's value token and extra fields (_value_token)
bool value_token(int v, int group, Event* e) {
  const int a = v < 0 ? -v : v;
  const int sign = v < 0 ? 1 : 0;
  if (a == 1) {
    *e = token_event(group, sign ? 10 : 9);
    return true;
  }
  if (a == 2) {
    *e = token_event(group, sign ? 12 : 11);
    return true;
  }
  if (a <= 6) {
    *e = token_event(group, 10 + a);
    extra(*e, sign, 1);
    return true;
  }
  static const int kTok[6] = {17, 18, 19, 20, 21, 22};
  static const int kBase[6] = {7, 9, 13, 21, 37, 69};
  static const int kEx[6] = {1, 2, 3, 4, 5, 9};
  for (int i = 0; i < 6; ++i) {
    if (a < kBase[i] + (1 << kEx[i])) {
      *e = token_event(group, kTok[i]);
      extra(*e, sign, 1);
      extra(*e, a - kBase[i], kEx[i]);
      return true;
    }
  }
  return false;  // beyond the token alphabet
}

}  // namespace

extern "C" {

void* tc_th_huff_new(const uint32_t* codes, const uint8_t* lens, const uint8_t* toks,
                     const int32_t* counts) {
  Huff* h = new Huff;
  long long at = 0;
  for (int t = 0; t < kTables; ++t) {
    if (!build_table(&h->t[t], codes + at, lens + at, toks + at, counts[t])) {
      delete h;
      return nullptr;
    }
    at += counts[t];
  }
  return h;
}

void tc_th_huff_free(void* h) { delete static_cast<Huff*>(h); }

// the DCT tokens of a packet from bit ``pos``: the coded blocks ``blocks``
// (ids in coded order) with ``islv`` 1 for chroma; coefficients in zigzag
// order into ``out`` (zeroed, 64 a block id).  Returns the bit position
// after the tokens.
long long tc_th_tokens(const void* handle, const uint8_t* data, long long nbytes, long long pos,
                       const int32_t* blocks, const uint8_t* islv, int nb, int32_t* out) {
  const Huff* h = static_cast<const Huff*>(handle);
  BitReader b(data, nbytes, pos);
  std::vector<std::vector<int>> buckets(64);
  buckets[0].resize(nb);
  for (int i = 0; i < nb; ++i) buckets[0][i] = i;
  long long eob_run = 0;
  int hti_dc[2];
  hti_dc[0] = static_cast<int>(b.read(4));
  hti_dc[1] = static_cast<int>(b.read(4));
  int hti_ac[2] = {0, 0};
  const Table* luts[2] = {&h->t[hti_dc[0]], &h->t[hti_dc[1]]};
  for (int ci = 0; ci < 64; ++ci) {
    if (ci == 1) {
      hti_ac[0] = static_cast<int>(b.read(4));
      hti_ac[1] = static_cast<int>(b.read(4));
    }
    if (ci == 1 || ci == 6 || ci == 15 || ci == 28) {
      const int g = kCoefGroup[ci];
      luts[0] = &h->t[16 * g + hti_ac[0]];
      luts[1] = &h->t[16 * g + hti_ac[1]];
    }
    std::vector<int>& cand = buckets[ci];
    if (cand.empty()) continue;
    std::sort(cand.begin(), cand.end());
    size_t k = 0;
    if (eob_run > 0) {
      k = eob_run < static_cast<long long>(cand.size()) ? static_cast<size_t>(eob_run)
                                                        : cand.size();
      eob_run -= static_cast<long long>(k);
    }
    for (size_t n_i = k; n_i < cand.size(); ++n_i) {
      const int idx = cand[n_i];
      if (eob_run > 0) {
        --eob_run;
        continue;
      }
      const int tok = read_token(*luts[islv[idx] ? 1 : 0], b);
      const long long base = static_cast<long long>(blocks[idx]) * 64;
      if (tok >= 9) {
        if (tok <= 22) {
          int val;
          if (tok <= 12) {
            static const int kV[4] = {1, -1, 2, -2};
            val = kV[tok - 9];
          } else if (tok <= 16) {
            const int mag = tok - 10;
            val = b.read1() ? -mag : mag;
          } else {
            static const int kEx[6] = {1, 2, 3, 4, 5, 9};
            static const int kBase[6] = {7, 9, 13, 21, 37, 69};
            const int sign = b.read1();
            const int mag = kBase[tok - 17] + static_cast<int>(b.read(kEx[tok - 17]));
            val = sign ? -mag : mag;
          }
          out[base + ci] = val;
          if (ci < 63) buckets[ci + 1].push_back(idx);
          continue;
        }
        int run, val;
        if (tok <= 27) {
          run = tok - 22;
          val = b.read1() ? -1 : 1;
        } else if (tok == 28) {
          const int sign = b.read1();
          run = 6 + static_cast<int>(b.read(2));
          val = sign ? -1 : 1;
        } else if (tok == 29) {
          const int sign = b.read1();
          run = 10 + static_cast<int>(b.read(3));
          val = sign ? -1 : 1;
        } else if (tok == 30) {
          const int sign = b.read1();
          const int mag = 2 + b.read1();
          run = 1;
          val = sign ? -mag : mag;
        } else {
          const int sign = b.read1();
          const int mag = 2 + b.read1();
          run = 2 + b.read1();
          val = sign ? -mag : mag;
        }
        const int npos = ci + run;
        if (npos <= 63) out[base + npos] = val;
        if (npos < 63) buckets[npos + 1].push_back(idx);
        continue;
      }
      if (tok <= 6) {
        if (tok <= 2) {
          eob_run = tok;
        } else if (tok == 3) {
          eob_run = 3 + b.read(2);
        } else if (tok == 4) {
          eob_run = 7 + b.read(3);
        } else if (tok == 5) {
          eob_run = 15 + b.read(4);
        } else {
          const long long vv = b.read(12);
          eob_run = vv ? vv - 1 : (1LL << 30);
        }
        continue;
      }
      const int run = static_cast<int>(tok == 7 ? b.read(3) : b.read(6)) + 1;
      const int npos = ci + run;
      if (npos < 64) buckets[npos].push_back(idx);
    }
  }
  return b.pos();
}

// _predict_dc in place on int32 ``coefs`` (64 a block id)
void tc_th_predict_dc(int32_t* coefs, const uint8_t* coded, const uint8_t* bclass,
                      const int32_t* plane_off, const int32_t* bws, const int32_t* bhs) {
  for (int p = 0; p < 3; ++p) {
    const long long off = plane_off[p];
    const int bw = bws[p], bh = bhs[p];
    long long last_dc[3] = {0, 0, 0};
    auto dc = [&](long long nb) { return static_cast<long long>(coefs[nb * 64]); };
    for (int by = 0; by < bh; ++by) {
      for (int bx = 0; bx < bw; ++bx) {
        const long long bid = off + static_cast<long long>(by) * bw + bx;
        if (!coded[bid]) continue;
        const int fc = bclass[bid];
        const long long pred = predict(coded, bclass, bid, bx, by, bw, last_dc[fc], dc);
        coefs[bid * 64] = wrap32(coefs[bid * 64] + pred);
        last_dc[fc] = coefs[bid * 64];
      }
    }
  }
}

// the encoder's _dc_residuals: ``resid`` (zeroed) gets each coded block's
// clamped residual against the prediction from the final DCs, ``final``
// (a copy of ``dcq``) the DC the decoder reconstructs
void tc_th_dc_residuals(const int64_t* dcq, const uint8_t* coded, const uint8_t* bclass,
                        const int32_t* plane_off, const int32_t* bws, const int32_t* bhs,
                        int64_t* resid, int64_t* final_dc) {
  for (int p = 0; p < 3; ++p) {
    const long long off = plane_off[p];
    const int bw = bws[p], bh = bhs[p];
    long long last_dc[3] = {0, 0, 0};
    auto dc = [&](long long nb) { return static_cast<long long>(final_dc[nb]); };
    for (int by = 0; by < bh; ++by) {
      for (int bx = 0; bx < bw; ++bx) {
        const long long bid = off + static_cast<long long>(by) * bw + bx;
        if (!coded[bid]) continue;
        const int fc = bclass[bid];
        const long long pred = predict(coded, bclass, bid, bx, by, bw, last_dc[fc], dc);
        long long r = dcq[bid] - pred;
        r = std::max(-580LL, std::min(580LL, r));
        resid[bid] = r;
        final_dc[bid] = pred + r;
        last_dc[fc] = pred + r;
      }
    }
  }
}

// the token stream of the coded blocks' int32 zigzag rows ``cz`` (nb x 64,
// coded order, DC residuals in place) with the group codes (5 x 32 codes
// and lengths), appended to the packet's first bits (``prefix``, then
// ``nacc`` bits in ``acc``) into ``out``; the packet's length, or -1 where
// ``cap`` bytes do not hold it or a value lies beyond the alphabet
long long tc_th_write_tokens(const int32_t* cz, const uint8_t* islv, int nb,
                             const uint32_t* codes, const uint8_t* lens, const uint8_t* prefix,
                             long long prefix_bytes, uint64_t acc, int nacc, uint8_t* out,
                             long long cap) {
  std::vector<std::vector<int>> nz(nb);
  for (int i = 0; i < nb; ++i)
    for (int c = 0; c < 64; ++c)
      if (cz[static_cast<long long>(i) * 64 + c]) nz[i].push_back(c);
  std::vector<size_t> ptr(nb, 0);
  std::vector<Event> ev;
  ev.reserve(static_cast<size_t>(nb) * 4 + 8);
  auto raw = [&](uint32_t v, int n) {
    Event e{};
    e.kind = 0;
    e.raw = v;
    e.rawn = n;
    ev.push_back(e);
  };
  raw(0, 4);
  raw(0, 4);
  long long eob = -1;  // the open EOB run's event, or -1
  std::vector<std::vector<int>> buckets(64);
  buckets[0].resize(nb);
  for (int i = 0; i < nb; ++i) buckets[0][i] = i;
  bool ok = true;
  for (int ci = 0; ci < 64 && ok; ++ci) {
    if (ci == 1) {
      raw(0, 4);
      raw(0, 4);
    }
    std::vector<int>& cand = buckets[ci];
    if (cand.empty()) continue;
    std::sort(cand.begin(), cand.end());
    const int group = kCoefGroup[ci];
    for (int idx : cand) {
      const std::vector<int>& pos = nz[idx];
      const size_t pi = ptr[idx];
      if (pi >= pos.size()) {
        if (eob >= 0 && ev[eob].count < 4095) {
          ++ev[eob].count;
        } else {
          Event e{};
          e.kind = 2;
          e.group = group;
          e.count = 1;
          ev.push_back(e);
          eob = static_cast<long long>(ev.size()) - 1;
        }
        continue;
      }
      const int npos = pos[pi];
      const int val = cz[static_cast<long long>(idx) * 64 + npos];
      eob = -1;
      if (npos == ci) {
        Event e;
        if (!value_token(val, group, &e)) {
          ok = false;
          break;
        }
        ev.push_back(e);
        ptr[idx] = pi + 1;
        if (ci < 63) buckets[ci + 1].push_back(idx);
        continue;
      }
      const int run = npos - ci;
      const int a = val < 0 ? -val : val;
      const int sign = val < 0 ? 1 : 0;
      if (a == 1 && run <= 17) {
        Event e;
        if (run <= 5) {
          e = token_event(group, 22 + run);
          extra(e, sign, 1);
        } else if (run <= 9) {
          e = token_event(group, 28);
          extra(e, sign, 1);
          extra(e, run - 6, 2);
        } else {
          e = token_event(group, 29);
          extra(e, sign, 1);
          extra(e, run - 10, 3);
        }
        ev.push_back(e);
        ptr[idx] = pi + 1;
        if (npos < 63) buckets[npos + 1].push_back(idx);
      } else if (a >= 2 && a <= 3 && run <= 3) {
        Event e;
        if (run == 1) {
          e = token_event(group, 30);
          extra(e, sign, 1);
          extra(e, a - 2, 1);
        } else {
          e = token_event(group, 31);
          extra(e, sign, 1);
          extra(e, a - 2, 1);
          extra(e, run - 2, 1);
        }
        ev.push_back(e);
        ptr[idx] = pi + 1;
        if (npos < 63) buckets[npos + 1].push_back(idx);
      } else {
        Event e = run <= 8 ? token_event(group, 7) : token_event(group, 8);
        extra(e, run - 1, run <= 8 ? 3 : 6);
        ev.push_back(e);
        buckets[npos].push_back(idx);
      }
    }
  }
  if (!ok) return -1;
  BitWriter bw(out, cap);
  bw.start(prefix, prefix_bytes, acc, nacc);
  for (const Event& e : ev) {
    if (e.kind == 0) {
      bw.write(e.raw, e.rawn);
      continue;
    }
    int tok = e.token;
    Event x = e;
    if (e.kind == 2) {  // _eob_fields
      x.nx = 0;
      const int c = e.count;
      if (c <= 3) {
        tok = c - 1;
      } else if (c <= 7) {
        tok = 3;
        extra(x, c - 4, 2);
      } else if (c <= 15) {
        tok = 4;
        extra(x, c - 8, 3);
      } else if (c <= 31) {
        tok = 5;
        extra(x, c - 16, 4);
      } else {
        tok = 6;
        extra(x, c, 12);
      }
    }
    bw.write(codes[e.group * 32 + tok], lens[e.group * 32 + tok]);
    for (int i = 0; i < x.nx; ++i) bw.write(x.xv[i], x.xn[i]);
  }
  return bw.finish();
}

}  // extern "C"
