// Copied from native/mpeg2intra.cpp; the port builds its own MPEG-2 parse library from this copy.
// MPEG-2 intra-picture elementary-stream decoder (host bitstream stage).
//
// This is the serial half of the tcforge_tpu MPEG-2 decode path: it
// parses sequence/picture headers and slices, VLC-decodes intra
// macroblocks with the complete ISO/IEC 13818-2 Tables B-1/B-12/B-13/
// B-14/B-15, dequantizes (linear + nonlinear quantiser scales, custom
// intra matrices, saturation, mismatch control) and emits natural-order
// 8x8 coefficient blocks.  The inverse DCT then runs *batched on the
// accelerator* (einsum over every block of a frame at once) — the
// bitstream walk is the only part that is inherently sequential, so it
// is the only part that lives here.
//
// Replaces the reference's external libmpeg2 usage (import/decode_mpeg2.c,
// import/tcrequant.c bitstream stage).  The VLC tables are ISO 13818-2
// constants (run/level windows as in tcrequant.c:838-916 / getvlc.h,
// stored run = spec run + 1, 65 = escape, 129 = end-of-block).
//
// Intra-only scope for this round: P/B pictures, field pictures, field
// DCT and concealment vectors return TC_M2D_EUNSUP.

#include <cstdint>
#include <cstring>
#include <string>

#include "mpeg2tables.h"

namespace {

using namespace m2tab;

// --------------------------------------------------------------------------

struct Bits {
    const uint8_t* d;
    int64_t nbits;
    int64_t pos = 0;
    bool overrun = false;

    Bits(const uint8_t* data, int64_t size)
        : d(data), nbits(size * 8) {}

    // 32 bits at the cursor, zero-padded past the end (the standard
    // lookahead window for the VLC dispatch)
    inline uint32_t show32() const {
        int64_t byte = pos >> 3;
        int off = int(pos & 7);
        int64_t nb = nbits >> 3;
        uint64_t v = 0;
        for (int i = 0; i < 5; i++)
            v = (v << 8) | (byte + i < nb ? d[byte + i] : 0);
        return uint32_t(v >> (8 - off));
    }
    inline uint32_t show(int k) const { return show32() >> (32 - k); }
    inline void skip(int k) {
        pos += k;
        if (pos > nbits) { overrun = true; pos = nbits; }
    }
    inline uint32_t get(int k) {
        uint32_t v = show(k);
        skip(k);
        return v;
    }
    inline void align() { pos = (pos + 7) & ~int64_t(7); }
    inline bool eof() const { return pos >= nbits; }

    // advance past the next 00 00 01 xx start code; -1 at end
    int next_start_code() {
        align();
        int64_t i = pos >> 3;
        int64_t n = nbits >> 3;
        while (i + 3 < n) {
            if (d[i] == 0 && d[i + 1] == 0 && d[i + 2] == 1) {
                pos = (i + 4) * 8;
                return d[i + 3];
            }
            i++;
        }
        pos = nbits;
        return -1;
    }
};

struct M2Dec {
    const uint8_t* data;
    int64_t size;
    Bits bits;
    std::string err;

    int width = 0, height = 0;
    double fps = 25.0;
    bool have_seq = false;
    int intra_matrix[64];   // natural order

    // picture coding extension state (MPEG-1 defaults when absent).
    // mpeg1 stays set until a sequence_extension appears (ISO 11172-2
    // streams have none): it selects the MPEG-1 escape-level coding,
    // dequant oddification, and full_pel vector scaling.
    int mpeg1 = 1;
    int full_pel[2] = {0, 0};
    int intra_dc_precision = 0;
    int q_scale_type = 0;
    int intra_vlc_format = 0;
    int alternate_scan = 0;
    int frame_pred_frame_dct = 1;
    int concealment_mv = 0;
    int picture_structure = 3;
    int top_field_first = 0;
    int chroma_format = 1;          // 1 = 4:2:0, 2 = 4:2:2
    int non_intra_matrix[64];
    int f_code[2][2] = {{15, 15}, {15, 15}};
    int pic_type = 0;
    int temporal_ref = 0;

    // streaming (windowed) mode: parse failures at the buffer end
    // rewind and report EAGAIN until tc_m2d_set_eos
    int streaming = 0;
    int eos_in = 0;

    M2Dec(const uint8_t* d, int64_t n) : data(d), size(n), bits(d, n) {
        memcpy(intra_matrix, kDefaultIntraMatrix, sizeof(intra_matrix));
        for (int i = 0; i < 64; i++) non_intra_matrix[i] = 16;
    }

    int quantiser_scale(int code) const {
        return q_scale_type ? kQScaleNonlinear[code & 31] : (code & 31) * 2;
    }
};

#define TC_M2D_OK 1
#define TC_M2D_EOS 0
#define TC_M2D_ETRUNC (-1)
#define TC_M2D_EUNSUP (-2)
#define TC_M2D_EPARSE (-3)
#define TC_M2D_EAGAIN (-4)

bool parse_sequence_header(M2Dec* dec) {
    Bits& b = dec->bits;
    dec->width = int(b.get(12));
    dec->height = int(b.get(12));
    b.skip(4);                          // aspect ratio information
    int frc = int(b.get(4));
    if (kFrameRates[frc] > 0) dec->fps = kFrameRates[frc];
    b.skip(18 + 1 + 10 + 1);            // bitrate, marker, vbv, constrained
    if (b.get(1)) {                     // load_intra_quantiser_matrix
        for (int i = 0; i < 64; i++)
            dec->intra_matrix[kScanZigzag[i]] = int(b.get(8));
    }
    if (b.get(1)) {                     // load_non_intra_quantiser_matrix
        for (int i = 0; i < 64; i++)
            dec->non_intra_matrix[kScanZigzag[i]] = int(b.get(8));
    }
    if (b.overrun) { dec->err = "truncated sequence header"; return false; }
    dec->have_seq = true;
    return true;
}

// sequence extension (ext id 1): profile/level, progressive,
// chroma_format, size extensions (13818-2 6.2.2.3)
void parse_sequence_extension(M2Dec* dec) {
    Bits& b = dec->bits;
    dec->mpeg1 = 0;                     // ISO 13818-2 stream
    b.skip(8 + 1);                      // profile/level, progressive
    int cf = int(b.get(2));
    if (cf == 1 || cf == 2) dec->chroma_format = cf;
    // 4:4:4 (3) is unsupported; keep the current value and let the
    // slice decode fail cleanly if such a stream appears
    b.skip(2 + 2 + 12 + 1 + 8 + 1 + 2 + 5);
}

void parse_picture_coding_extension(M2Dec* dec) {
    Bits& b = dec->bits;
    dec->f_code[0][0] = int(b.get(4)) - 1;
    dec->f_code[0][1] = int(b.get(4)) - 1;
    dec->f_code[1][0] = int(b.get(4)) - 1;
    dec->f_code[1][1] = int(b.get(4)) - 1;
    dec->intra_dc_precision = int(b.get(2));
    dec->picture_structure = int(b.get(2));
    dec->top_field_first = int(b.get(1));
    dec->frame_pred_frame_dct = int(b.get(1));
    dec->concealment_mv = int(b.get(1));
    dec->q_scale_type = int(b.get(1));
    dec->intra_vlc_format = int(b.get(1));
    dec->alternate_scan = int(b.get(1));
    // repeat_first_field, chroma_420_type, progressive_frame, composite
    b.skip(4);
}

// DC size VLC (Tables B-12/B-13) + differential bits -> dc_dct_differential
inline int read_dc_diff(Bits& b, bool chroma, bool* ok) {
    int size, len;
    uint32_t bb = b.show32();
    if (!chroma) {
        if (bb < 0xf8000000u) {
            const DcVlc& t = kDcLuma5[bb >> 27];
            size = t.size; len = t.len;
        } else {
            const DcVlc& t = kDcLong[(bb >> 23) - 0x1e0];
            size = t.size; len = t.len;
        }
    } else {
        if (bb < 0xf8000000u) {
            const DcVlc& t = kDcChroma5[bb >> 27];
            size = t.size; len = t.len;
        } else {
            // kDcLong stores luma code lengths; the chroma codes of the
            // same size are one bit longer (Table B-13 vs B-12)
            const DcVlc& t = kDcLong[(bb >> 22) - 0x3e0];
            size = t.size; len = t.len + 1;
        }
    }
    b.skip(len);
    if (size == 0) return 0;
    int v = int(b.get(size));
    if (b.overrun) { *ok = false; return 0; }
    if (!(v >> (size - 1))) v = v + 1 - (1 << size);
    return v;
}

// One intra block: VLC decode + dequant + mismatch control into out[64]
// (natural order).  Returns false on parse error/overrun.
bool read_intra_block(M2Dec* dec, bool chroma, int* dc_pred, int qscale,
                      int32_t* out) {
    Bits& b = dec->bits;
    const int* scan = dec->alternate_scan ? kScanAlt : kScanZigzag;
    memset(out, 0, 64 * sizeof(int32_t));

    bool ok = true;
    int diff = read_dc_diff(b, chroma, &ok);
    if (!ok) { dec->err = "truncated block"; return false; }
    *dc_pred += diff;
    int sum = 0;
    {
        int f = *dc_pred * (8 >> dec->intra_dc_precision);
        if (f > 2047) f = 2047;
        if (f < -2048) f = -2048;
        out[0] = f;
        sum = f;
    }

    int idx = 0;
    const bool b15 = dec->intra_vlc_format != 0;
    for (;;) {
        uint32_t bb = b.show32();
        const Vlc* t;
        int pre_skip = 0;
        if (b15) {
            if (bb >= 0x04000000u) t = &kB15Top8[(bb >> 24) - 4];
            else if (bb >= 0x02000000u) t = &kB15Top10[(bb >> 22) - 8];
            else if (bb >= 0x00800000u) t = &kTop13[(bb >> 19) - 16];
            else if (bb >= 0x00200000u) t = &kTop15[(bb >> 17) - 16];
            else { t = &kTop16[bb >> 16]; pre_skip = 16; }
        } else {
            if (bb >= 0x28000000u) t = &kB14Top5[(bb >> 27) - 5];
            else if (bb >= 0x04000000u) t = &kB14Top8[(bb >> 24) - 4];
            else if (bb >= 0x02000000u) t = &kB14Top10[(bb >> 22) - 8];
            else if (bb >= 0x00800000u) t = &kTop13[(bb >> 19) - 16];
            else if (bb >= 0x00200000u) t = &kTop15[(bb >> 17) - 16];
            else { t = &kTop16[bb >> 16]; pre_skip = 16; }
        }
        int level;
        if (t->run == RUN_EOB) {
            b.skip(pre_skip + t->len);
            break;
        }
        if (t->run == RUN_ESC) {
            b.skip(6);
            idx += int(b.get(6)) + 1;
            int lv;
            if (dec->mpeg1) {
                // 11172-2 escape: 8-bit level with double escape for
                // |level| in 128..255
                lv = int(b.get(8));
                if (lv == 0) lv = int(b.get(8));
                else if (lv == 128) lv = int(b.get(8)) - 256;
                else if (lv > 128) lv -= 256;
            } else {
                lv = int(b.get(12));
                if (lv >= 2048) lv -= 4096;
            }
            level = lv;
        } else {
            b.skip(pre_skip + t->len);
            idx += t->run;              // stored run = spec run + 1
            level = b.get(1) ? -int(t->lvl) : int(t->lvl);
        }
        if (idx > 63 || b.overrun) {
            dec->err = "AC coefficient run overflow";
            return false;
        }
        int natural = scan[idx];
        // intra dequant: F = (2*QF*W*qs)/32, truncation toward zero
        long long f = 2LL * level * dec->intra_matrix[natural] * qscale;
        f /= 32;                        // C division truncates toward zero
        // MPEG-1 mismatch control: force nonzero coefficients odd
        // (11172-2 2.4.4.2; MPEG-2 replaced this with the sum-LSB
        // toggle applied later)
        if (dec->mpeg1 && f != 0 && (f & 1) == 0)
            f += (f > 0) ? -1 : 1;
        if (f > 2047) f = 2047;
        if (f < -2048) f = -2048;
        out[natural] = int32_t(f);
        sum += int(f);
    }
    // mismatch control (ISO 13818-2 7.4.4): toggle LSB of F[7][7] if the
    // coefficient sum is even — MPEG-2 only (MPEG-1 already forced
    // each coefficient odd above)
    if (!dec->mpeg1 && (sum & 1) == 0) out[63] ^= 1;
    return !b.overrun;
}

// Decode one intra picture (cursor just past the 0x00 picture start
// code) into per-plane coefficient block grids.
int decode_picture(M2Dec* dec, int32_t* ycoef, int32_t* ucoef,
                   int32_t* vcoef) {
    Bits& b = dec->bits;
    b.skip(10);                         // temporal reference
    int ptype = int(b.get(3));
    if (ptype != 1) {
        dec->err = "picture type " + std::to_string(ptype) +
                   " (P/B decode is intra-only scope)";
        return TC_M2D_EUNSUP;
    }
    b.skip(16);                         // vbv_delay
    while (b.get(1)) b.skip(8);         // extra_information_picture
    if (b.overrun) { dec->err = "truncated picture header"; return TC_M2D_ETRUNC; }

    // ISO 13818-2 6.3.3: the coded grid rounds UP; a 1080-line stream
    // codes 68 MB rows (callers crop the reconstruction to display size)
    const int mb_w = (dec->width + 15) / 16, mb_h = (dec->height + 15) / 16;
    const int bw = mb_w * 2;            // luma block-grid width

    for (;;) {
        int code = b.next_start_code();
        if (code < 0) break;
        if (code == 0xB5) {
            int eid = int(b.show(4));
            if (eid == 8) { b.skip(4); parse_picture_coding_extension(dec); }
            else if (eid == 1) { b.skip(4); parse_sequence_extension(dec); }
            continue;
        }
        if (code < 0x01 || code > 0xAF) {
            b.pos -= 32;                // next picture/sequence/end
            break;
        }
        if (dec->picture_structure != 3) {
            dec->err = "field pictures not supported (intra frame scope)";
            return TC_M2D_EUNSUP;
        }
        if (dec->concealment_mv) {
            dec->err = "concealment motion vectors not supported";
            return TC_M2D_EUNSUP;
        }
        int row = code - 1;
        if (row >= mb_h) { dec->err = "slice row out of range"; return TC_M2D_EPARSE; }
        int qscale = dec->quantiser_scale(int(b.get(5)));
        while (b.get(1)) b.skip(8);     // extra_information_slice

        int pred_y = 128 << dec->intra_dc_precision;
        int pred_u = pred_y, pred_v = pred_y;
        int col = 0;
        while (col < mb_w && !b.overrun) {
            // macroblock_address_increment (Table B-1)
            int inc = 0;
            for (;;) {
                uint32_t bb = b.show32();
                if (bb >= 0x10000000u) {
                    const MbaVlc& t = kMba5[(bb >> 27) - 2];
                    b.skip(t.len); inc += t.inc; break;
                } else if (bb >= 0x03000000u) {
                    const MbaVlc& t = kMba11[(bb >> 21) - 24];
                    b.skip(t.len); inc += t.inc; break;
                } else if (b.show(11) == 8) {
                    b.skip(11); inc += 33;       // macroblock_escape
                } else if (dec->mpeg1 && b.show(11) == 15) {
                    b.skip(11);                  // macroblock_stuffing
                } else {
                    dec->err = "bad macroblock address increment";
                    return TC_M2D_EPARSE;
                }
            }
            if (inc != 0) {
                dec->err = "skipped macroblocks in intra picture";
                return TC_M2D_EPARSE;
            }
            // macroblock modes for I pictures: 1 = intra,
            // 01 = intra + new quantiser code
            if (b.get(1) == 0) {
                if (b.get(1) != 1) {
                    dec->err = "bad intra macroblock type";
                    return TC_M2D_EPARSE;
                }
                qscale = dec->quantiser_scale(int(b.get(5)));
            }
            if (dec->frame_pred_frame_dct == 0) {
                if (b.get(1)) {          // dct_type: field DCT
                    dec->err = "field DCT not supported";
                    return TC_M2D_EUNSUP;
                }
            }
            static const int kOff[4][2] = {{0, 0}, {0, 1}, {1, 0}, {1, 1}};
            for (int blk = 0; blk < 4; blk++) {
                int gy = row * 2 + kOff[blk][0];
                int gx = col * 2 + kOff[blk][1];
                if (!read_intra_block(dec, false, &pred_y, qscale,
                                      ycoef + (int64_t(gy) * bw + gx) * 64))
                    return b.overrun ? TC_M2D_ETRUNC : TC_M2D_EPARSE;
            }
            // chroma: 4:2:0 = one Cb + one Cr block; 4:2:2 = stacked
            // pairs (Cb Cr Cb Cr) on a doubled chroma block grid
            const int csub = dec->chroma_format == 2 ? 2 : 1;
            for (int cs = 0; cs < csub; cs++) {
                int64_t coff = (int64_t(row * csub + cs) * mb_w + col)
                               * 64;
                if (!read_intra_block(dec, true, &pred_u, qscale,
                                      ucoef + coff))
                    return b.overrun ? TC_M2D_ETRUNC : TC_M2D_EPARSE;
                if (!read_intra_block(dec, true, &pred_v, qscale,
                                      vcoef + coff))
                    return b.overrun ? TC_M2D_ETRUNC : TC_M2D_EPARSE;
            }
            col++;
        }
        if (b.overrun) { dec->err = "truncated slice"; return TC_M2D_ETRUNC; }
    }
    return TC_M2D_OK;
}


// --------------------------------------------------------------------------
// Full I/P/B decode (frame pictures): the bitstream stage emits, per
// macroblock, dequantized coefficient blocks plus reconstructed motion
// vectors and mode flags; motion compensation and the IDCT run batched
// on the accelerator (tcforge_tpu.io.mpeg2codec.reconstruct_picture).

constexpr int MBF_INTRA = 1;
constexpr int MBF_FWD = 2;
constexpr int MBF_BWD = 4;
constexpr int MBF_SKIPPED = 8;
constexpr int MBF_FIELD_MV = 16;
constexpr int MBF_FIELD_DCT = 32;
constexpr int MBF_DUAL = 64;   // dual-prime: mi[1:3]=mv, mi[3:5]=dmvector
constexpr int MBF_MV16X8 = 128;  // field picture 16x8: mv1 upper, mv2 lower

constexpr int MB_STRIDE = 12;   // int32 slots per macroblock in mbinfo
// layout: [flags, fmv1x, fmv1y, fmv2x, fmv2y, bmv1x, bmv1y, bmv2x,
//          bmv2y, fieldsel, qscale, 0]

struct MbOut {
    int32_t* info;                // (mb_count, MB_STRIDE)
    int32_t* ycoef;               // (mb_h*2, mb_w*2, 64)
    int32_t* ucoef;               // (mb_h, mb_w, 64)
    int32_t* vcoef;               // (mb_h, mb_w, 64)
};

// Non-intra block: B-14 with the first-coefficient variant, non-intra
// dequant F = ((2*QF + sign(QF)) * W * qs) / 32, saturation, mismatch.
bool read_non_intra_block(M2Dec* dec, int qscale, int32_t* out) {
    Bits& b = dec->bits;
    const int* scan = dec->alternate_scan ? kScanAlt : kScanZigzag;
    memset(out, 0, 64 * sizeof(int32_t));
    int idx = -1;
    int sum = 0;
    bool first = true;
    for (;;) {
        uint32_t bb = b.show32();
        const Vlc* t;
        int pre = 0;
        if (bb >= 0x28000000u) {
            t = first ? &kB14Top5DC[(bb >> 27) - 5]
                      : &kB14Top5[(bb >> 27) - 5];
        } else if (bb >= 0x04000000u) {
            t = &kB14Top8[(bb >> 24) - 4];
        } else if (bb >= 0x02000000u) {
            t = &kB14Top10[(bb >> 22) - 8];
        } else if (bb >= 0x00800000u) {
            t = &kTop13[(bb >> 19) - 16];
        } else if (bb >= 0x00200000u) {
            t = &kTop15[(bb >> 17) - 16];
        } else {
            t = &kTop16[bb >> 16];
            pre = 16;
        }
        first = false;
        int level;
        if (t->run == RUN_EOB) {
            b.skip(pre + t->len);
            break;
        }
        if (t->run == RUN_ESC) {
            b.skip(6);
            idx += int(b.get(6)) + 1;
            int lv;
            if (dec->mpeg1) {
                lv = int(b.get(8));
                if (lv == 0) lv = int(b.get(8));
                else if (lv == 128) lv = int(b.get(8)) - 256;
                else if (lv > 128) lv -= 256;
            } else {
                lv = int(b.get(12));
                if (lv >= 2048) lv -= 4096;
            }
            level = lv;
        } else {
            b.skip(pre + t->len);
            idx += t->run;
            level = b.get(1) ? -int(t->lvl) : int(t->lvl);
        }
        if (idx > 63 || b.overrun) {
            dec->err = "AC run overflow (non-intra)";
            return false;
        }
        int natural = scan[idx];
        long long k = level > 0 ? 1 : (level < 0 ? -1 : 0);
        long long f = (2LL * level + k)
            * dec->non_intra_matrix[natural] * qscale / 32;
        if (dec->mpeg1 && f != 0 && (f & 1) == 0)
            f += (f > 0) ? -1 : 1;
        if (f > 2047) f = 2047;
        if (f < -2048) f = -2048;
        out[natural] = int32_t(f);
        sum += int(f);
    }
    if (!dec->mpeg1 && (sum & 1) == 0)
        out[63] ^= 1;                   // mismatch control (MPEG-2)
    return !b.overrun;
}

// dmvector (Table B-11): '0' -> 0, '10' -> +1, '11' -> -1
inline int read_dmvector(Bits& b) {
    if (b.get(1) == 0) return 0;
    return b.get(1) ? -1 : 1;
}

// motion_code VLC (Table B-10) + residual -> delta in half-pel units
int motion_delta(M2Dec* dec, int fc, bool* ok) {
    Bits& b = dec->bits;
    if (b.show(1)) {                     // code 0
        b.skip(1);
        return 0;
    }
    uint32_t bb = b.show32();
    const MvVlc* t;
    if (bb >= 0x0c000000u) t = &kMv4[bb >> 28];
    else t = &kMv10[bb >> 22];
    if (t->len == 0) { *ok = false; return 0; }
    b.skip(t->len);
    int delta = (int(t->delta) << fc) + 1;
    int sign = b.get(1) ? -1 : 1;
    if (fc) delta += int(b.get(fc));
    if (b.overrun) { *ok = false; return 0; }
    return sign * delta;
}

// prediction + delta with range wraparound (13818-2 7.6.3.1)
inline int mv_add(int pred, int delta, int fc) {
    int f = 1 << fc;
    int v = pred + delta;
    int range = 32 * f;
    if (v >= 16 * f) v -= range;
    else if (v < -16 * f) v += range;
    return v;
}

struct MvState {
    int pmv[2][2][2];                   // [r][s][t] like the spec
    void reset() { memset(pmv, 0, sizeof(pmv)); }
};

int decode_picture_full(M2Dec* dec, MbOut out, int* out_type) {
    Bits& b = dec->bits;
    dec->temporal_ref = int(b.get(10));
    int ptype = int(b.get(3));
    if (ptype == 4 && !dec->mpeg1) {
        dec->err = "D-pictures are MPEG-1 only (11172-2 2.4.3.4)";
        return TC_M2D_EPARSE;
    }
    if (ptype < 1 || ptype > 4) {
        dec->err = "bad picture type";
        return TC_M2D_EPARSE;
    }
    // MPEG-1 D-pictures (11172-2 2.4.3.6): intra, DC-only blocks,
    // 1-bit macroblock_type, end_of_macroblock marker.  NOTE: the
    // reference stack (libmpeg2) cannot decode these at all.
    const bool dpict = ptype == 4;
    *out_type = ptype;
    dec->pic_type = ptype;
    b.skip(16);                          // vbv_delay
    dec->full_pel[0] = dec->full_pel[1] = 0;
    if (ptype == 2 || ptype == 3) {      // MPEG-1 fwd f_code fields
        dec->full_pel[0] = int(b.get(1));  // full_pel (0 in MPEG-2)
        int fc = int(b.get(3));
        if (fc > 0 && fc < 8) dec->f_code[0][0] = dec->f_code[0][1]
            = fc - 1;
    }
    if (ptype == 3) {
        dec->full_pel[1] = int(b.get(1));
        int fc = int(b.get(3));
        if (fc > 0 && fc < 8) dec->f_code[1][0] = dec->f_code[1][1]
            = fc - 1;
    }
    while (b.get(1)) b.skip(8);
    if (b.overrun) { dec->err = "truncated picture header"; return TC_M2D_ETRUNC; }

    const int mb_w = (dec->width + 15) / 16, mb_h = (dec->height + 15) / 16;
    const int bw = mb_w * 2;
    memset(out.info, 0, size_t(mb_w) * mb_h * MB_STRIDE * 4);
    memset(out.ycoef, 0, size_t(bw) * mb_h * 2 * 64 * 4);
    memset(out.ucoef, 0,
           size_t(mb_w) * mb_h * dec->chroma_format * 64 * 4);
    memset(out.vcoef, 0,
           size_t(mb_w) * mb_h * dec->chroma_format * 64 * 4);

    // field pictures code a half-height macroblock grid into the top
    // rows of the same buffers (meta[2] tells callers which field)
    bool field_pic = false;
    int mb_rows = mb_h;

    for (;;) {
        int code = b.next_start_code();
        if (code < 0) break;
        if (code == 0xB5) {
            int eid = int(b.show(4));
            if (eid == 8) { b.skip(4); parse_picture_coding_extension(dec); }
            else if (eid == 1) { b.skip(4); parse_sequence_extension(dec); }
            continue;
        }
        if (code < 0x01 || code > 0xAF) {
            b.pos -= 32;
            break;
        }
        field_pic = dec->picture_structure != 3;
        mb_rows = field_pic ? (dec->height / 2 + 15) / 16 : mb_h;
        const int cur_parity = dec->picture_structure == 2 ? 1 : 0;
        int row = code - 1;
        if (row >= mb_rows) { dec->err = "slice row out of range"; return TC_M2D_EPARSE; }
        int qscale = dec->quantiser_scale(int(b.get(5)));
        while (b.get(1)) b.skip(8);

        int pred_y = 128 << dec->intra_dc_precision;
        int pred_u = pred_y, pred_v = pred_y;
        MvState mv;
        mv.reset();
        int last_flags = 0;
        int last_mv[8] = {0};
        int last_fieldsel = 0;

        int col = -1;
        bool first_mb = true;
        while (!b.overrun) {
            // macroblock address increment
            int inc = 0;
            bool end_slice = false;
            for (;;) {
                uint32_t bb = b.show32();
                if (bb >= 0x10000000u) {
                    const MbaVlc& t = kMba5[(bb >> 27) - 2];
                    b.skip(t.len); inc += t.inc; break;
                } else if (bb >= 0x03000000u) {
                    const MbaVlc& t = kMba11[(bb >> 21) - 24];
                    b.skip(t.len); inc += t.inc; break;
                } else if (b.show(11) == 8) {
                    b.skip(11); inc += 33;
                } else if (dec->mpeg1 && b.show(11) == 15) {
                    b.skip(11);                  // MPEG-1 mb stuffing
                } else {
                    end_slice = true;
                    break;
                }
            }
            if (end_slice) break;
            int step = first_mb ? inc + 1 : inc + 1;
            // mark skipped macroblocks (never the first of a slice)
            for (int k = 1; k < step; k++) {
                col++;
                if (col >= mb_w) break;
                int32_t* mi = out.info
                    + (size_t(row) * mb_w + col) * MB_STRIDE;
                if (ptype == 2) {
                    // P skipped: zero forward vector, PMV reset;
                    // field pictures predict the same-parity field
                    mi[0] = MBF_FWD | MBF_SKIPPED;
                    if (field_pic)
                        mi[9] = cur_parity | (cur_parity << 1);
                    mv.reset();
                } else if (ptype == 3) {
                    // B skipped: repeat previous vectors and direction
                    mi[0] = (last_flags & (MBF_FWD | MBF_BWD))
                        | MBF_SKIPPED;
                    for (int q = 0; q < 8; q++) mi[1 + q] = last_mv[q];
                    mi[9] = last_fieldsel;
                } else {
                    dec->err = "skipped macroblock in I picture";
                    return TC_M2D_EPARSE;
                }
            }
            first_mb = false;
            col++;
            if (col >= mb_w) break;
            int32_t* mi = out.info
                + (size_t(row) * mb_w + col) * MB_STRIDE;

            // macroblock modes (MB_I / MB_P / MB_B tables)
            int modes, mtype = 0;
            if (dpict) {
                // Table B.2d: the only code is '1' = macroblock_intra
                if (b.get(1) != 1) {
                    dec->err = "bad D-picture macroblock type";
                    return TC_M2D_EPARSE;
                }
                modes = 1;
            } else if (ptype == 1) {
                const MbVlc& t = kMbI[b.show(1)];
                b.skip(t.len);
                modes = t.modes;
            } else if (ptype == 2) {
                const MbVlc& t = kMbP[b.show(5)];
                if (t.len == 0) { dec->err = "bad P mb type"; return TC_M2D_EPARSE; }
                b.skip(t.len);
                modes = t.modes;
            } else {
                const MbVlc& t = kMbB[b.show(6)];
                if (t.len == 0) { dec->err = "bad B mb type"; return TC_M2D_EPARSE; }
                b.skip(t.len);
                modes = t.modes;
            }
            bool intra = modes & 1;
            bool pattern = modes & 2;
            bool has_bwd = modes & 4;
            bool has_fwd = modes & 8;
            bool quant = modes & 16;

            // motion type: frame pictures read frame_motion_type only
            // with frame_pred_frame_dct=0; field pictures ALWAYS read
            // field_motion_type for MC macroblocks (1=field 16x16,
            // 2=16x8, 3=dual prime)
            bool any_mc = !intra && (has_fwd || has_bwd);
            if (field_pic) {
                if (any_mc) mtype = int(b.get(2));
            } else if (!dec->frame_pred_frame_dct && any_mc) {
                mtype = int(b.get(2));
            } else if (has_fwd || has_bwd) {
                mtype = 2;              // MC_FRAME implied
            }
            bool field_mv = !field_pic && any_mc && mtype == 1;
            bool fld_single = field_pic && any_mc && mtype == 1;
            bool fld_16x8 = field_pic && any_mc && mtype == 2;
            bool dual = has_fwd && !has_bwd && mtype == 3 && any_mc;
            if (any_mc && mtype == 3 && !dual) {
                dec->err = "dual-prime motion outside P prediction";
                return TC_M2D_EPARSE;
            }
            int dct_type = 0;
            if (!field_pic && !dec->frame_pred_frame_dct
                && (intra || pattern))
                dct_type = int(b.get(1));

            if (quant)
                qscale = dec->quantiser_scale(int(b.get(5)));

            // motion vectors
            bool ok = true;
            int fieldsel = 0;
            // halve: field vectors inside FRAME pictures predict from
            // PMV/2 and store back *2 (7.6.3.1); prop: a single vector
            // updates both PMV rows (frame MV, or field-picture 16x16)
            auto read_mv_pair = [&](int r, int sdir, int* outx,
                                    int* outy, bool halve, bool prop) {
                int fcx = dec->f_code[sdir][0];
                int fcy = dec->f_code[sdir][1];
                int dx = motion_delta(dec, fcx, &ok);
                int dy = motion_delta(dec, fcy, &ok);
                int px = mv.pmv[r][sdir][0];
                int py = mv.pmv[r][sdir][1];
                int vx = mv_add(px, dx, fcx);
                int vy;
                if (halve) {
                    vy = mv_add(py / 2, dy, fcy);
                    mv.pmv[r][sdir][1] = vy * 2;
                } else {
                    vy = mv_add(py, dy, fcy);
                    mv.pmv[r][sdir][1] = vy;
                }
                mv.pmv[r][sdir][0] = vx;
                if (prop) {
                    mv.pmv[1][sdir][0] = vx;
                    mv.pmv[1][sdir][1] = mv.pmv[r][sdir][1];
                    mv.pmv[0][sdir][0] = vx;
                    mv.pmv[0][sdir][1] = mv.pmv[r][sdir][1];
                }
                *outx = vx;
                *outy = vy;
            };

            if (intra) {
                if (dec->concealment_mv) {
                    int tx, ty;
                    read_mv_pair(0, 0, &tx, &ty, false, true);
                    b.skip(1);          // marker
                }
            } else {
                if (dual) {
                    // ONE vector (field-format vertical) + dmvector
                    // per component (13818-2 7.6.3.6, Table B-11).
                    // Frame pictures store PMV in frame units (halve /
                    // re-double); field-picture PMVs are already
                    // field-format.
                    int fcx = dec->f_code[0][0];
                    int fcy = dec->f_code[0][1];
                    int dx = motion_delta(dec, fcx, &ok);
                    int dmx = read_dmvector(b);
                    int dy = motion_delta(dec, fcy, &ok);
                    int dmy = read_dmvector(b);
                    int vx = mv_add(mv.pmv[0][0][0], dx, fcx);
                    int vy;
                    if (field_pic) {
                        vy = mv_add(mv.pmv[0][0][1], dy, fcy);
                        mv.pmv[0][0][1] = vy;
                        mv.pmv[1][0][1] = vy;
                        // same-parity prediction rides the normal
                        // field-select path
                        fieldsel |= cur_parity | (cur_parity << 1);
                    } else {
                        vy = mv_add(mv.pmv[0][0][1] / 2, dy, fcy);
                        mv.pmv[0][0][1] = vy * 2;
                        mv.pmv[1][0][1] = vy * 2;
                    }
                    mv.pmv[0][0][0] = vx;
                    mv.pmv[1][0][0] = vx;
                    mi[1] = vx;            // field half-pel units
                    mi[2] = vy;
                    mi[3] = dmx;           // differential vector
                    mi[4] = dmy;
                } else if (has_fwd) {
                    if (field_mv) {
                        fieldsel |= int(b.get(1));          // sel 1
                        read_mv_pair(0, 0, &mi[1], &mi[2], true, false);
                        fieldsel |= int(b.get(1)) << 1;     // sel 2
                        read_mv_pair(1, 0, &mi[3], &mi[4], true, false);
                    } else if (fld_single) {
                        // field picture 16x16: select + one vector
                        fieldsel |= int(b.get(1));
                        read_mv_pair(0, 0, &mi[1], &mi[2], false, true);
                        mi[3] = mi[1]; mi[4] = mi[2];
                        fieldsel |= (fieldsel & 1) << 1;
                    } else if (fld_16x8) {
                        // field picture 16x8: upper then lower half
                        fieldsel |= int(b.get(1));
                        read_mv_pair(0, 0, &mi[1], &mi[2], false, false);
                        fieldsel |= int(b.get(1)) << 1;
                        read_mv_pair(1, 0, &mi[3], &mi[4], false, false);
                    } else {
                        read_mv_pair(0, 0, &mi[1], &mi[2], false, true);
                        mi[3] = mi[1]; mi[4] = mi[2];
                    }
                }
                if (has_bwd) {
                    if (field_mv) {
                        fieldsel |= int(b.get(1)) << 2;
                        read_mv_pair(0, 1, &mi[5], &mi[6], true, false);
                        fieldsel |= int(b.get(1)) << 3;
                        read_mv_pair(1, 1, &mi[7], &mi[8], true, false);
                    } else if (fld_single) {
                        fieldsel |= int(b.get(1)) << 2;
                        read_mv_pair(0, 1, &mi[5], &mi[6], false, true);
                        mi[7] = mi[5]; mi[8] = mi[6];
                        fieldsel |= ((fieldsel >> 2) & 1) << 3;
                    } else if (fld_16x8) {
                        fieldsel |= int(b.get(1)) << 2;
                        read_mv_pair(0, 1, &mi[5], &mi[6], false, false);
                        fieldsel |= int(b.get(1)) << 3;
                        read_mv_pair(1, 1, &mi[7], &mi[8], false, false);
                    } else {
                        read_mv_pair(0, 1, &mi[5], &mi[6], false, true);
                        mi[7] = mi[5]; mi[8] = mi[6];
                    }
                }
                // MPEG-1 full_pel: coded values are whole pixels;
                // MC runs in half-pel units (PMV stays in coded units)
                if (dec->mpeg1) {
                    if (has_fwd && dec->full_pel[0]) {
                        mi[1] *= 2; mi[2] *= 2; mi[3] *= 2; mi[4] *= 2;
                    }
                    if (has_bwd && dec->full_pel[1]) {
                        mi[5] *= 2; mi[6] *= 2; mi[7] *= 2; mi[8] *= 2;
                    }
                }
                // P no-MC coded MB: zero forward vector, PMV reset
                if (ptype == 2 && !has_fwd && !dual) {
                    has_fwd = true;
                    mi[1] = mi[2] = mi[3] = mi[4] = 0;
                    if (field_pic)
                        fieldsel |= cur_parity | (cur_parity << 1);
                    mv.reset();
                }
            }
            if (!ok) { dec->err = "bad motion vector"; return TC_M2D_EPARSE; }

            // coded block pattern; 4:2:2 appends a 2-bit extension
            // for the second chroma block pair (6.3.17.4)
            const int nblk = dec->chroma_format == 2 ? 8 : 6;
            int cbp = 0;
            if (intra) {
                cbp = (1 << nblk) - 1;
            } else if (pattern) {
                uint32_t bb = b.show32();
                if (bb >= 0x20000000u) {
                    const CbpVlc& t = kCbp7[(bb >> 25) - 16];
                    b.skip(t.len);
                    cbp = t.cbp;
                } else {
                    const CbpVlc& t = kCbp9[bb >> 23];
                    if (t.len == 0) { dec->err = "bad CBP"; return TC_M2D_EPARSE; }
                    b.skip(t.len);
                    cbp = t.cbp;
                }
                if (nblk == 8)
                    cbp = (cbp << 2) | int(b.get(2));
            }

            // blocks; 4:2:2 chroma MBs are 8x16 = two stacked blocks
            // per component (Cb4 Cr5 Cb6 Cr7, figure 6-10), stored on
            // a (mb_h*2, mb_w) chroma block grid
            static const int kOff[4][2] = {{0, 0}, {0, 1}, {1, 0},
                                           {1, 1}};
            for (int blk = 0; blk < nblk && !b.overrun; blk++) {
                if (!(cbp & (1 << (nblk - 1 - blk))))
                    continue;
                int32_t* dst;
                if (blk < 4) {
                    int gy = row * 2 + kOff[blk][0];
                    int gx = col * 2 + kOff[blk][1];
                    dst = out.ycoef + (size_t(gy) * bw + gx) * 64;
                } else {
                    int32_t* plane = (blk & 1) == 0 ? out.ucoef
                                                    : out.vcoef;
                    int crow = nblk == 8 ? row * 2 + ((blk - 4) >> 1)
                                         : row;
                    dst = plane + (size_t(crow) * mb_w + col) * 64;
                }
                bool bok;
                if (dpict) {
                    // DC coefficient only, no AC scan and no EOB
                    memset(dst, 0, 64 * sizeof(int32_t));
                    int* pred = blk < 4 ? &pred_y
                        : ((blk & 1) == 0 ? &pred_u : &pred_v);
                    bool ok2 = true;
                    int diff = read_dc_diff(b, blk >= 4, &ok2);
                    bok = ok2 && !b.overrun;
                    if (bok) {
                        *pred += diff;
                        int f = *pred * 8;      // dc precision 8 bits
                        if (f > 2047) f = 2047;
                        if (f < -2048) f = -2048;
                        dst[0] = f;
                    }
                } else if (intra) {
                    int* pred = blk < 4 ? &pred_y
                        : ((blk & 1) == 0 ? &pred_u : &pred_v);
                    bok = read_intra_block(dec, blk >= 4, pred, qscale,
                                           dst);
                } else {
                    bok = read_non_intra_block(dec, qscale, dst);
                }
                if (!bok)
                    return b.overrun ? TC_M2D_ETRUNC : TC_M2D_EPARSE;
            }
            if (dpict && b.get(1) != 1) {
                dec->err = "missing end_of_macroblock in D-picture";
                return b.overrun ? TC_M2D_ETRUNC : TC_M2D_EPARSE;
            }

            // predictor resets (13818-2 7.6.3.4)
            if (intra) {
                if (!dec->concealment_mv) mv.reset();
            } else {
                pred_y = 128 << dec->intra_dc_precision;
                pred_u = pred_v = pred_y;
                if (ptype == 3 && !has_fwd && !has_bwd) mv.reset();
            }
            if (!intra) {
                // DC predictors reset after any non-intra MB
            } else {
                // (already maintained across intra MBs)
            }

            int flags = (intra ? MBF_INTRA : 0)
                | (!intra && (has_fwd || dual) ? MBF_FWD : 0)
                | (has_bwd ? MBF_BWD : 0)
                | (field_mv ? MBF_FIELD_MV : 0)
                | (dct_type ? MBF_FIELD_DCT : 0)
                | (dual ? MBF_DUAL : 0)
                | (fld_16x8 ? MBF_MV16X8 : 0);
            mi[0] = flags;
            mi[9] = fieldsel;
            mi[10] = qscale;
            last_flags = flags;
            last_fieldsel = fieldsel;
            for (int q = 0; q < 8; q++) last_mv[q] = mi[1 + q];
        }
        if (b.overrun) { dec->err = "truncated slice"; return TC_M2D_ETRUNC; }
    }
    return TC_M2D_OK;
}

}  // namespace

extern "C" {

void* tc_m2d_open(const uint8_t* data, int64_t size) {
    M2Dec* dec = new M2Dec(data, size);
    // pre-scan the first sequence header so callers can size buffers
    Bits probe(data, size);
    for (;;) {
        int code = probe.next_start_code();
        if (code < 0) break;
        if (code == 0xB3) {
            Bits saved = dec->bits;
            dec->bits = probe;
            parse_sequence_header(dec);
            // the sequence extension (chroma_format) follows directly
            if (dec->bits.next_start_code() == 0xB5
                && dec->bits.show(4) == 1) {
                dec->bits.skip(4);
                parse_sequence_extension(dec);
            }
            dec->bits = saved;
            break;
        }
    }
    return dec;
}

int tc_m2d_width(void* h) { return static_cast<M2Dec*>(h)->width; }
int tc_m2d_chroma(void* h) { return static_cast<M2Dec*>(h)->chroma_format; }
int tc_m2d_height(void* h) { return static_cast<M2Dec*>(h)->height; }
double tc_m2d_fps(void* h) { return static_cast<M2Dec*>(h)->fps; }

const char* tc_m2d_errmsg(void* h) {
    return static_cast<M2Dec*>(h)->err.c_str();
}

// Decode the next intra picture.  ycoef: (mb_h*2, mb_w*2, 64) int32;
// ucoef/vcoef: (mb_h, mb_w, 64).  Returns 1 picture, 0 EOS, <0 error.
int tc_m2d_next(void* h, int32_t* ycoef, int32_t* ucoef, int32_t* vcoef) {
    M2Dec* dec = static_cast<M2Dec*>(h);
    for (;;) {
        int code = dec->bits.next_start_code();
        if (code < 0) return TC_M2D_EOS;
        if (code == 0xB3) {
            int w = dec->width, hgt = dec->height;
            if (!parse_sequence_header(dec)) return TC_M2D_ETRUNC;
            if (dec->have_seq && w && (w != dec->width || hgt != dec->height)) {
                dec->err = "mid-stream geometry change";
                return TC_M2D_EUNSUP;
            }
        } else if (code == 0xB5) {
            // sequence extension carries chroma_format (id 1)
            if (dec->bits.show(4) == 1) {
                dec->bits.skip(4);
                parse_sequence_extension(dec);
            }
        } else if (code == 0x00) {
            if (!dec->have_seq) {
                dec->err = "picture before sequence header";
                return TC_M2D_EPARSE;
            }
            return decode_picture(dec, ycoef, ucoef, vcoef);
        }
        // 0xB2 user data, other 0xB5 extensions, 0xB7 sequence end
        // (another sequence may follow when concatenated), 0xB8: skip
    }
}


// Full I/P/B decode (frame pictures).  mbinfo: (mb_h*mb_w, 12) int32;
// meta: [pic_type, temporal_reference, picture_structure,
// top_field_first] (4 x int32).  Returns like tc_m2d_next.
static int m2d_next2_inner(M2Dec* dec, int32_t* ycoef, int32_t* ucoef,
                           int32_t* vcoef, int32_t* mbinfo,
                           int32_t* meta) {
    for (;;) {
        int code = dec->bits.next_start_code();
        if (code < 0) return TC_M2D_EOS;
        if (code == 0xB3) {
            int w = dec->width, hgt = dec->height;
            if (!parse_sequence_header(dec)) return TC_M2D_ETRUNC;
            if (dec->have_seq && w && (w != dec->width || hgt != dec->height)) {
                dec->err = "mid-stream geometry change";
                return TC_M2D_EUNSUP;
            }
        } else if (code == 0xB5) {
            if (dec->bits.show(4) == 1) {
                dec->bits.skip(4);
                parse_sequence_extension(dec);
            }
        } else if (code == 0x00) {
            if (!dec->have_seq) {
                dec->err = "picture before sequence header";
                return TC_M2D_EPARSE;
            }
            MbOut out{mbinfo, ycoef, ucoef, vcoef};
            int ptype = 0;
            int rc = decode_picture_full(dec, out, &ptype);
            if (rc == TC_M2D_OK) {
                meta[0] = ptype;
                meta[1] = dec->temporal_ref;
                meta[2] = dec->picture_structure;
                meta[3] = dec->top_field_first;
            }
            return rc;
        }
        // 0xB7 sequence end: concatenated streams continue after it
    }
}

int tc_m2d_next2(void* h, int32_t* ycoef, int32_t* ucoef, int32_t* vcoef,
                 int32_t* mbinfo, int32_t* meta) {
    M2Dec* dec = static_cast<M2Dec*>(h);
    int64_t entry = dec->bits.pos;
    int rc = m2d_next2_inner(dec, ycoef, ucoef, vcoef, mbinfo, meta);
    if (dec->streaming && !dec->eos_in) {
        // windowed mode: a parse that ran off the buffer end (or a VLC
        // decision made on the zero-padded lookahead, pos within 40
        // bits of the end) is an underflow, not an error — rewind to
        // the picture start and ask for more data
        bool near_end = dec->bits.pos + 40 > dec->bits.nbits;
        if (rc == TC_M2D_ETRUNC || rc == TC_M2D_EOS
            || (rc == TC_M2D_EPARSE && near_end)) {
            dec->bits.pos = entry;
            dec->bits.overrun = false;
            dec->err.clear();
            return TC_M2D_EAGAIN;
        }
    }
    return rc;
}

// ---- streaming (windowed) input ------------------------------------- //

void tc_m2d_set_stream(void* h, int on) {
    static_cast<M2Dec*>(h)->streaming = on;
}

void tc_m2d_set_eos(void* h) { static_cast<M2Dec*>(h)->eos_in = 1; }

// byte offset of the parse cursor (byte-aligned at every picture
// boundary); callers keep [tell(), size) and append new data
int64_t tc_m2d_tell(void* h) {
    return static_cast<M2Dec*>(h)->bits.pos >> 3;
}

// replace the input buffer (tail + appended data); the cursor rebases
// to the buffer start.  The caller owns the memory.
void tc_m2d_feed(void* h, const uint8_t* data, int64_t size) {
    M2Dec* dec = static_cast<M2Dec*>(h);
    dec->data = data;
    dec->size = size;
    dec->bits = Bits(data, size);
    if (!dec->have_seq) {
        // re-run the open()-time prescan so width/height appear as
        // soon as the first sequence header is in the window
        Bits probe(data, size);
        for (;;) {
            int code = probe.next_start_code();
            if (code < 0) break;
            if (code == 0xB3) {
                Bits saved = dec->bits;
                dec->bits = probe;
                parse_sequence_header(dec);
                if (dec->bits.next_start_code() == 0xB5
                    && dec->bits.show(4) == 1) {
                    dec->bits.skip(4);
                    parse_sequence_extension(dec);
                }
                dec->bits = saved;
                break;
            }
        }
    }
}

void tc_m2d_close(void* h) { delete static_cast<M2Dec*>(h); }

}  // extern "C"
