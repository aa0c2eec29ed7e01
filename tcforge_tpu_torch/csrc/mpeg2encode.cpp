// Copied from native/mpeg2encode.cpp; the port builds its own MPEG-2 syntax writer from this copy.
// MPEG-2 picture-level entropy coder (ISO/IEC 13818-2 syntax writer).
//
// Role analogue: the bitstream half of an export-side video encoder
// (the reference shipped encode via external libs; tcforge's TPU
// design splits encoding into device math — motion estimation, DCT,
// quantization, reconstruction in JAX — and this serial VLC stage).
//
// Scope: frame pictures, frame prediction + frame DCT, 4:2:0, linear
// q_scale, intra_vlc_format=0 (Table B-14), no concealment vectors.
// Tables come from mpeg2tables.h (ISO constants, same generation as
// the decoder's).
//
// Per-MB input layout (8 int32 each, raster order):
//   [0] modes: MB_INTRA=1 | MB_PATTERN=2 | MB_BACKWARD=4 | MB_FORWARD=8
//       0 = skipped (P: zero MV; B: repeat previous prediction)
//   [1] fmvx  [2] fmvy  — forward MV, half-pel units
//   [3] bmvx  [4] bmvy  — backward MV, half-pel units
//   [5] cbp (6 bits, Y0 Y1 Y2 Y3 Cb Cr from bit5 down — Table B-9 order)
//   [6] qscale_code override (0 = picture default)
//   [7] reserved
// levels: per MB 6 blocks x 64 int16, zigzag order; for intra blocks
// element 0 is the absolute DC level (intra_dc_precision 8).

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

#include "mpeg2tables.h"

using namespace m2tab;

namespace {

constexpr int MB_INTRA = 1;
constexpr int MB_PATTERN = 2;
constexpr int MB_BACKWARD = 4;
constexpr int MB_FORWARD = 8;

// picture-extension flag bits for tc_m2e_picture (6.3.10 fields the
// device math doesn't touch: display/pulldown metadata + structure)
constexpr int M2E_TOP_FIELD_FIRST = 1;     // top_field_first = 1
constexpr int M2E_REPEAT_FIRST_FIELD = 2;  // repeat_first_field = 1
constexpr int M2E_NOT_PROGRESSIVE = 4;     // progressive_frame = 0
constexpr int M2E_ALT_SCAN = 8;            // alternate_scan = 1
// bits 4-5: picture_structure code (0 = frame, 1 = top field,
// 2 = bottom field); field pictures use field_motion_type = 01
// (16x16 field prediction) with a vertical field select bit per MV
constexpr int M2E_PS_SHIFT = 4;
constexpr int M2E_MPEG1 = 64;              // ISO 11172-2 syntax
constexpr int M2E_CHROMA422 = 128;         // 4:2:2 (8 blocks per MB)

struct BitWriter {
    std::vector<uint8_t> out;
    uint32_t buf = 0;
    int cnt = 0;

    void put(uint32_t bits, int len) {
        while (len > 0) {
            int take = len > 24 ? 24 : len;
            uint32_t chunk = (bits >> (len - take)) & ((1u << take) - 1);
            for (int i = take - 1; i >= 0; i--) {
                buf = (buf << 1) | ((chunk >> i) & 1);
                if (++cnt == 8) {
                    out.push_back(uint8_t(buf & 0xFF));
                    buf = 0;
                    cnt = 0;
                }
            }
            len -= take;
        }
    }
    void align_zero() {
        if (cnt) put(0, 8 - cnt);
    }
    void start_code(int code) {
        align_zero();
        out.push_back(0);
        out.push_back(0);
        out.push_back(1);
        out.push_back(uint8_t(code));
    }
};

// ---- inverse VLC tables built from the decode windows ---------------- //

struct Code { uint16_t code; int8_t len; };

// macroblock_address_increment, Table B-1 (inc 1..33)
Code g_mba[34];
bool g_mba_init = false;

void init_mba() {
    if (g_mba_init) return;
    std::memset(g_mba, 0, sizeof(g_mba));
    // kMba5: window5 in [2,31] -> {inc, len}
    for (int w = 2; w < 32; w++) {
        const MbaVlc& t = kMba5[w - 2];
        int inc = t.inc + 1;   // table stores increment-1
        if (inc >= 1 && inc <= 33 && !g_mba[inc].len)
            g_mba[inc] = { uint16_t(w >> (5 - t.len)), int8_t(t.len) };
    }
    // kMba11: window11 in [24,127] -> {inc, len}
    for (int w = 24; w < 128; w++) {
        const MbaVlc& t = kMba11[w - 24];
        if (!t.len) continue;
        int inc = t.inc + 1;   // table stores increment-1
        if (inc >= 1 && inc <= 33 && !g_mba[inc].len)
            g_mba[inc] = { uint16_t(w >> (11 - t.len)), int8_t(t.len) };
    }
    g_mba_init = true;
}

// motion_code magnitude prefixes, Table B-10 (sign bit separate)
const Code kMvCode[17] = {
    {0x1, 1},                                 // 0
    {0x1, 2}, {0x1, 3}, {0x1, 4},             // 1..3 ('01','001','0001')
    {0x3, 6},                                 // 4 '000011'
    {0x5, 7}, {0x4, 7}, {0x3, 7},             // 5..7
    {0x0B, 9}, {0x0A, 9}, {0x09, 9},          // 8..10
    {0x11, 10}, {0x10, 10}, {0x0F, 10},       // 11..13
    {0x0E, 10}, {0x0D, 10}, {0x0C, 10}};      // 14..16

// intra DC size codes, Tables B-12 / B-13
const Code kDcLumaSize[12] = {
    {0x4, 3}, {0x0, 2}, {0x1, 2}, {0x5, 3}, {0x6, 3}, {0x0E, 4},
    {0x1E, 5}, {0x3E, 6}, {0x7E, 7}, {0xFE, 8}, {0x1FE, 9}, {0x1FF, 9}};
const Code kDcChromaSize[12] = {
    {0x0, 2}, {0x1, 2}, {0x2, 2}, {0x6, 3}, {0x0E, 4}, {0x1E, 5},
    {0x3E, 6}, {0x7E, 7}, {0xFE, 8}, {0x1FE, 9}, {0x3FE, 10},
    {0x3FF, 10}};

struct Encoder {
    BitWriter w;
    int width, height, mb_w, mb_h;
    int pic_type;
    int fcode[2];                  // forward, backward (r_size + 1)
    int qscale_code;
    int flags = 0;                 // M2E_FLAG_* picture-extension bits
    int pstruct = 3;               // picture_structure
    int cur_parity = 0;            // field pictures: 0 top, 1 bottom
    int dc_pred[3];
    int pmv[2][2];                 // [fwd/bwd][x/y]
    bool error = false;

    bool field_pic() const { return pstruct != 3; }
    bool mpeg1() const { return (flags & M2E_MPEG1) != 0; }
    int nblk() const { return (flags & M2E_CHROMA422) ? 8 : 6; }

    void reset_dc() {
        dc_pred[0] = dc_pred[1] = dc_pred[2] = 128;
    }
    void reset_pmv() {
        pmv[0][0] = pmv[0][1] = pmv[1][0] = pmv[1][1] = 0;
    }

    // ---- elementary writers ---------------------------------------- //

    void put_mba(int inc) {
        while (inc > 33) {
            w.put(0x08, 11);       // macroblock_escape
            inc -= 33;
        }
        if (inc < 1 || !g_mba[inc].len) { error = true; return; }
        w.put(g_mba[inc].code, g_mba[inc].len);
    }

    void put_mb_type(int modes) {
        const PutVlc& t = kPutMbType[(pic_type - 1) * 32 + (modes & 0x1F)];
        if (!t.len) { error = true; return; }
        w.put(t.code, t.len);
    }

    void put_mv_delta(int val, int pred, int which) {
        // 13818-2 7.6.3.1: code (val - pred) with wraparound
        int r = fcode[which] - 1;
        int f = 1 << r;
        int range = 16 * f;
        int delta = val - pred;
        if (delta < -range) delta += 2 * range;
        else if (delta >= range) delta -= 2 * range;
        if (delta == 0) {
            w.put(kMvCode[0].code, kMvCode[0].len);
            return;
        }
        int a = delta < 0 ? -delta : delta;
        int mc = ((a - 1) >> r) + 1;
        int res = (a - 1) & (f - 1);
        if (mc > 16) { error = true; return; }
        w.put(kMvCode[mc].code, kMvCode[mc].len);
        w.put(delta < 0 ? 1 : 0, 1);
        if (r) w.put(uint32_t(res), r);
    }

    void put_motion(int mvx, int mvy, int which) {
        put_mv_delta(mvx, pmv[which][0], which);
        pmv[which][0] = wrap(mvx, which);
        put_mv_delta(mvy, pmv[which][1], which);
        pmv[which][1] = wrap(mvy, which);
    }

    static int clampv(int v, int lo, int hi) {
        return v < lo ? lo : (v > hi ? hi : v);
    }
    int wrap(int v, int which) {
        int range = 16 << (fcode[which] - 1);
        return clampv(v, -range, range - 1);
    }

    void put_dc(int level, int comp) {
        int diff = level - dc_pred[comp];
        dc_pred[comp] = level;
        int a = diff < 0 ? -diff : diff;
        int size = 0;
        while (a) { size++; a >>= 1; }
        const Code& c = comp == 0 ? kDcLumaSize[size]
                                  : kDcChromaSize[size];
        w.put(c.code, c.len);
        if (size) {
            if (diff > 0) w.put(uint32_t(diff), size);
            else w.put(uint32_t(diff + (1 << size) - 1), size);
        }
    }

    void put_ac(int run, int slevel) {
        int level = slevel < 0 ? -slevel : slevel;
        const PutVlc* t = nullptr;
        if (run < 2 && level < 41)
            t = &kPutB14R01[run * 40 + level - 1];
        else if (run >= 2 && run < 32 && level < 6)
            t = &kPutB14R2[(run - 2) * 5 + level - 1];
        if (t && t->len) {
            w.put(t->code, t->len);
            w.put(slevel < 0 ? 1 : 0, 1);
        } else {
            w.put(1, 6);
            w.put(uint32_t(run), 6);
            if (mpeg1()) {
                // 11172-2 escape levels: 8 bits, double escape for
                // |level| in 128..255 (caller clamps to 255)
                if (slevel >= 128) {
                    w.put(0, 8);
                    w.put(uint32_t(slevel), 8);
                } else if (slevel <= -128) {
                    w.put(128, 8);
                    w.put(uint32_t(slevel + 256), 8);
                } else {
                    w.put(uint32_t(slevel) & 0xFF, 8);
                }
            } else {
                w.put(uint32_t(slevel) & 0xFFF, 12);
            }
        }
    }

    void put_intra_block(const int16_t* zz, int comp) {
        put_dc(zz[0], comp);
        int prev = 0;
        for (int i = 1; i < 64; i++) {
            if (!zz[i]) continue;
            put_ac(i - prev - 1, zz[i]);
            prev = i;
        }
        w.put(2, 2);               // EOB
    }

    void put_non_intra_block(const int16_t* zz) {
        int first = -1;
        for (int i = 0; i < 64; i++)
            if (zz[i]) { first = i; break; }
        if (first < 0) { error = true; return; }   // cbp bit lied
        // first coefficient: the B-14 "first" form for (0, +-1)
        if (first == 0 && (zz[0] == 1 || zz[0] == -1))
            w.put(2 | (zz[0] < 0 ? 1 : 0), 2);
        else
            put_ac(first, zz[first]);
        int prev = first;
        for (int i = first + 1; i < 64; i++) {
            if (!zz[i]) continue;
            put_ac(i - prev - 1, zz[i]);
            prev = i;
        }
        w.put(2, 2);               // EOB
    }

    // ---- picture --------------------------------------------------- //

    void picture_header_fixed(int temporal_ref) {
        w.start_code(0x00);
        w.put(uint32_t(temporal_ref & 0x3FF), 10);
        w.put(uint32_t(pic_type), 3);
        w.put(0xFFFF, 16);
        // MPEG-1 uses the in-header f_codes (full_pel = 0); MPEG-2
        // parks them at '111' and carries real f_codes in the pce
        int hf = mpeg1() ? fcode[0] : 7;
        int hb = mpeg1() ? fcode[1] : 7;
        if (pic_type == 2 || pic_type == 3) { w.put(0, 1); w.put(uint32_t(hf), 3); }
        if (pic_type == 3) { w.put(0, 1); w.put(uint32_t(hb), 3); }
        w.put(0, 1);
        if (mpeg1()) return;       // no picture_coding_extension
        w.start_code(0xB5);
        w.put(0x8, 4);
        int ff = pic_type >= 2 ? fcode[0] : 15;
        int fb = pic_type == 3 ? fcode[1] : 15;
        w.put(uint32_t(ff), 4);    // forward horizontal
        w.put(uint32_t(ff), 4);    // forward vertical
        w.put(uint32_t(fb), 4);    // backward horizontal
        w.put(uint32_t(fb), 4);    // backward vertical
        int progressive = (flags & M2E_NOT_PROGRESSIVE) || field_pic()
                          ? 0 : 1;
        w.put(0, 2);               // intra_dc_precision = 8
        w.put(uint32_t(pstruct), 2);
        // TFF/fpfd apply to frame pictures only (shall be 0 in fields)
        w.put(!field_pic() && (flags & M2E_TOP_FIELD_FIRST) ? 1 : 0, 1);
        w.put(field_pic() ? 0 : 1, 1);     // frame_pred_frame_dct
        w.put(0, 1);               // concealment
        w.put(0, 1);               // q_scale_type linear
        w.put(0, 1);               // intra_vlc_format (B-14)
        w.put((flags & M2E_ALT_SCAN) ? 1 : 0, 1);
        w.put(!field_pic() && (flags & M2E_REPEAT_FIRST_FIELD) ? 1 : 0,
              1);
        w.put(uint32_t(progressive), 1);   // chroma_420_type
        w.put(uint32_t(progressive), 1);   // progressive_frame
        w.put(0, 1);               // composite_display
    }

    void encode(int temporal_ref, const int32_t* mbinfo,
                const int16_t* levels) {
        picture_header_fixed(temporal_ref);
        for (int row = 0; row < mb_h && !error; row++) {
            int sc = row + 1;
            if (sc > 0xAF) sc = 0xAF;
            w.start_code(sc);
            w.put(uint32_t(qscale_code), 5);
            w.put(0, 1);           // extra_slice_info
            reset_dc();
            reset_pmv();
            int pending_skip = 0;
            for (int col = 0; col < mb_w && !error; col++) {
                int mb = row * mb_w + col;
                const int32_t* mi = mbinfo + mb * 8;
                int modes = int(mi[0]);
                bool last = col == mb_w - 1;
                if (pic_type == 4) {
                    // MPEG-1 D-picture MB (11172-2 2.4.3.6): every MB
                    // coded, 1-bit type, DC-only blocks, end marker
                    // (MPEG-1 is 4:2:0-only, stride stays 6 blocks)
                    put_mba(1);
                    w.put(1, 1);            // macroblock_type (B.2d)
                    const int16_t* zz = levels + mb * 6 * 64;
                    for (int b = 0; b < 6; b++)
                        put_dc(zz[b * 64],
                               b < 4 ? 0 : (b == 4 ? 1 : 2));
                    w.put(1, 1);            // end_of_macroblock
                    continue;
                }
                if (modes == 0 && col != 0 && !last) {
                    // skipped (P: zero MV + PMV/dc reset; B: repeat)
                    pending_skip++;
                    reset_dc();
                    if (pic_type == 2) reset_pmv();
                    continue;
                }
                if (modes == 0) {
                    // first/last MB of a slice cannot skip: code as
                    // zero-coefficient prediction
                    if (pic_type == 2)
                        modes = MB_FORWARD;        // MC, not coded
                    else if (pic_type == 3)
                        modes = MB_FORWARD;        // fwd, not coded
                    else { error = true; break; }
                    mi = nullptr;                  // zero MV, no cbp
                }
                put_mba(pending_skip + 1);
                pending_skip = 0;
                int cbp = mi ? int(mi[5])
                    & ((1 << nblk()) - 1) : 0;
                if ((modes & MB_PATTERN) && cbp == 0)
                    modes &= ~MB_PATTERN;          // no cbp=0 MBs
                put_mb_type(modes);
                // field pictures: field_motion_type = 01 (16x16 field
                // prediction) for every MC macroblock, then a vertical
                // field select bit before each vector (6.3.17.2)
                int fieldsel = mi ? int(mi[7]) : (cur_parity * 5);
                bool any_mc = !(modes & MB_INTRA)
                              && (modes & (MB_FORWARD | MB_BACKWARD));
                if (field_pic() && any_mc)
                    w.put(1, 2);
                if (modes & MB_INTRA) {
                    reset_pmv();
                    const int nb = nblk();
                    const int16_t* zz = levels + mb * nb * 64;
                    for (int b = 0; b < nb; b++) {
                        // 4:2:2 figure 6-10: Cb4 Cr5 Cb6 Cr7
                        int comp = b < 4 ? 0
                            : ((b & 1) == 0 ? 1 : 2);
                        put_intra_block(zz + b * 64, comp);
                    }
                    continue;
                }
                if (modes & MB_FORWARD) {
                    if (field_pic()) w.put(fieldsel & 1, 1);
                    put_motion(mi ? int(mi[1]) : 0,
                               mi ? int(mi[2]) : 0, 0);
                } else if (pic_type == 2) {
                    reset_pmv();                   // No-MC P macroblock
                }
                if (modes & MB_BACKWARD) {
                    if (field_pic()) w.put((fieldsel >> 2) & 1, 1);
                    put_motion(mi ? int(mi[3]) : 0,
                               mi ? int(mi[4]) : 0, 1);
                }
                reset_dc();
                if (modes & MB_PATTERN) {
                    const int nb = nblk();
                    // 4:2:2 (6.3.17.4): 6-bit cbp VLC over blocks
                    // 0-5 plus a 2-bit extension for blocks 6-7
                    int base = nb == 8 ? (cbp >> 2) : cbp;
                    const PutVlc& c = kPutCbp[base & 63];
                    if (!c.len) { error = true; break; }
                    w.put(c.code, c.len);
                    if (nb == 8)
                        w.put(uint32_t(cbp & 3), 2);
                    const int16_t* zz = levels + mb * nb * 64;
                    for (int b = 0; b < nb; b++)
                        if (cbp & (1 << (nb - 1 - b)))
                            put_non_intra_block(zz + b * 64);
                }
            }
        }
        w.align_zero();
    }
};

}  // namespace

extern "C" {

int tc_m2e_picture(int width, int height, int pic_type,
                   int temporal_ref, int qscale_code,
                   int fcode_f, int fcode_b, int flags,
                   const int32_t* mbinfo, const int16_t* levels,
                   uint8_t** out, int* outlen) {
    if (width <= 0 || height <= 0 || (width & 15) || (height & 15))
        return -1;
    if (pic_type < 1 || pic_type > 4)
        return -1;
    if (pic_type == 4 && !(flags & M2E_MPEG1))
        return -1;                 // D-pictures are MPEG-1 syntax
    if ((flags & M2E_CHROMA422) && (flags & M2E_MPEG1))
        return -1;                 // 11172-2 is 4:2:0-only
    init_mba();
    Encoder e;
    e.width = width;
    e.height = height;
    e.mb_w = width / 16;
    e.mb_h = height / 16;
    e.pic_type = pic_type;
    e.fcode[0] = fcode_f;
    e.fcode[1] = fcode_b;
    e.qscale_code = qscale_code;
    e.flags = flags;
    int ps = (flags >> M2E_PS_SHIFT) & 3;
    e.pstruct = ps == 0 ? 3 : ps;
    e.cur_parity = e.pstruct == 2 ? 1 : 0;
    e.encode(temporal_ref, mbinfo, levels);
    if (e.error)
        return -2;
    *outlen = int(e.w.out.size());
    *out = static_cast<uint8_t*>(std::malloc(e.w.out.size()));
    if (!*out)
        return -3;
    std::memcpy(*out, e.w.out.data(), e.w.out.size());
    return 0;
}

void tc_m2e_buf_free(uint8_t* p) { std::free(p); }

}  // extern "C"
