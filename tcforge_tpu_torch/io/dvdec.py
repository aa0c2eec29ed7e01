# Copied from tcforge_tpu/io/dvdec.py lines 41-479 and 575-634; the DV decoder's tables, VLC, integer IDCTs, bit reader and macroblock parse, and the AAUX extraction, without the module docstring and decode, whose pixels the port computes on the device (io/dvcodec.py).
from __future__ import annotations

from typing import List, Tuple

import numpy as np

__all__ = ["DVDecoder", "dv_frame_size", "idct88", "idct248"]


# ------------------------------------------------------------------ #
# Spec tables (see module docstring).  (code, length, run, level);
# levels get a trailing sign bit.  The regular 14/15-bit tails are
# generated programmatically below.
# ------------------------------------------------------------------ #

_VLC_HEAD = (
    (0, 2, 0, 1), (2, 3, 0, 2), (7, 4, 1, 1), (8, 4, 0, 3),
    (9, 4, 0, 4), (20, 5, 2, 1), (21, 5, 1, 2), (22, 5, 0, 5),
    (23, 5, 0, 6), (48, 6, 3, 1), (49, 6, 4, 1), (50, 6, 0, 7),
    (51, 6, 0, 8), (104, 7, 5, 1), (105, 7, 6, 1), (106, 7, 2, 2),
    (107, 7, 1, 3), (108, 7, 1, 4), (109, 7, 0, 9), (110, 7, 0, 10),
    (111, 7, 0, 11), (224, 8, 7, 1), (225, 8, 8, 1), (226, 8, 9, 1),
    (227, 8, 10, 1), (228, 8, 3, 2), (229, 8, 4, 2), (230, 8, 2, 3),
    (231, 8, 1, 5), (232, 8, 1, 6), (233, 8, 1, 7), (234, 8, 0, 12),
    (235, 8, 0, 13), (236, 8, 0, 14), (237, 8, 0, 15), (238, 8, 0, 16),
    (239, 8, 0, 17), (480, 9, 11, 1), (481, 9, 12, 1), (482, 9, 13, 1),
    (483, 9, 14, 1), (484, 9, 5, 2), (485, 9, 6, 2), (486, 9, 3, 3),
    (487, 9, 4, 3), (488, 9, 2, 4), (489, 9, 2, 5), (490, 9, 1, 8),
    (491, 9, 0, 18), (492, 9, 0, 19), (493, 9, 0, 20), (494, 9, 0, 21),
    (495, 9, 0, 22), (992, 10, 5, 3), (993, 10, 3, 4), (994, 10, 3, 5),
    (995, 10, 2, 6), (996, 10, 1, 9), (997, 10, 1, 10), (998, 10, 1, 11),
    (1998, 11, 0, 0), (1999, 11, 1, 0), (2000, 11, 6, 3), (2001, 11, 4, 4),
    (2002, 11, 3, 6), (2003, 11, 1, 12), (2004, 11, 1, 13), (2005, 11, 1, 14),
    (4012, 12, 2, 0), (4013, 12, 3, 0), (4014, 12, 4, 0), (4015, 12, 5, 0),
    (4016, 12, 7, 2), (4017, 12, 8, 2), (4018, 12, 9, 2), (4019, 12, 10, 2),
    (4020, 12, 7, 3), (4021, 12, 8, 3), (4022, 12, 4, 5), (4023, 12, 3, 7),
    (4024, 12, 2, 7), (4025, 12, 2, 8), (4026, 12, 2, 9), (4027, 12, 2, 10),
    (4028, 12, 2, 11), (4029, 12, 1, 15), (4030, 12, 1, 16), (4031, 12, 1, 17),
)

_EOB = (6, 4, 127, 0)                    # pos += 128 ends the block

_QUANT_OFFSET = (6, 3, 0, 1)
_QUANT_SHIFTS = (
    (3, 3, 4, 4), (3, 3, 4, 4), (2, 3, 3, 4), (2, 3, 3, 4),
    (2, 2, 3, 3), (2, 2, 3, 3), (1, 2, 2, 3), (1, 2, 2, 3),
    (1, 1, 2, 2), (1, 1, 2, 2), (0, 1, 1, 2), (0, 1, 1, 2),
    (0, 0, 1, 1), (0, 0, 1, 1), (0, 0, 0, 1), (0, 0, 0, 0),
    (0, 0, 0, 0), (0, 0, 0, 0), (0, 0, 0, 0), (0, 0, 0, 0),
    (0, 0, 0, 0), (0, 0, 0, 0))
_QUANT_AREAS = (6, 21, 43, 64)

_IWEIGHT_88 = (
    32768, 16705, 16705, 17734, 17032, 17734, 18205, 18081, 18081,
    18205, 18725, 18562, 19195, 18562, 18725, 19266, 19091, 19705,
    19705, 19091, 19266, 21407, 19643, 20267, 20228, 20267, 19643,
    21407, 22725, 21826, 20853, 20806, 20806, 20853, 21826, 22725,
    23170, 23170, 21407, 21400, 21407, 23170, 23170, 24598, 23786,
    22018, 22018, 23786, 24598, 25251, 24465, 22654, 24465, 25251,
    25972, 25172, 25172, 25972, 26722, 27969, 26722, 29692, 29692,
    31521)
_IWEIGHT_248 = (
    32768, 16384, 16705, 16705, 17734, 17734, 17734, 17734, 18081,
    18081, 18725, 18725, 21407, 21407, 19091, 19091, 19195, 19195,
    18205, 18205, 18725, 18725, 19705, 19705, 20267, 20267, 21826,
    21826, 23170, 23170, 20806, 20806, 20267, 20267, 19266, 19266,
    21407, 21407, 20853, 20853, 21400, 21400, 23786, 23786, 24465,
    24465, 22018, 22018, 23170, 23170, 22725, 22725, 24598, 24598,
    24465, 24465, 25172, 25172, 27969, 27969, 25972, 25972, 29692,
    29692)

_ZIGZAG_88 = (
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21,
    28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30,
    37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61,
    54, 47, 55, 62, 63)
_ZIGZAG_248 = (
    0, 8, 1, 9, 16, 24, 2, 10, 17, 25, 32, 40, 48, 56, 33, 41,
    18, 26, 3, 11, 4, 12, 19, 27, 34, 42, 49, 57, 50, 58, 35, 43,
    20, 28, 5, 13, 6, 14, 21, 29, 36, 44, 51, 59, 52, 60, 37, 45,
    22, 30, 7, 15, 23, 31, 38, 46, 53, 61, 54, 62, 39, 47, 55, 63)

# PAL 4:2:0 superblock shuffle (derived empirically; see docstring)
_SB_COL = (2, 1, 3, 0, 4)
_SB_ROW_OFF = (2, 6, 8, 0, 4)

_BLOCK_BITS = (112, 112, 112, 112, 80, 80)   # Y0..Y3, Cr, Cb


def _ntsc_mb_position(seq, segi, b):
    """NTSC 4:1:1 macroblock shuffle (derived empirically, r5, same
    self-describing-content method as PAL): superblock column/row
    tables are PAL's (_SB_COL / _SB_ROW_OFF mod 10), but superblocks
    are 4.5 32x8 macroblocks wide, so each interior column boundary
    is a SHARED half-column (even sb columns own its top 3 MBs,
    visited last; odd sb columns own the bottom 3, visited first)
    and the frame's right edge closes with three 16x16 2x2-block
    MBs.  Returns (bx, by, kind) in 8x8-block units; kind 'h4' =
    four horizontal Y blocks, 'q' = 2x2."""
    col = _SB_COL[b]
    row = 6 * ((seq + _SB_ROW_OFF[b]) % 10)
    v = segi
    if col % 2 == 0 and col != 4:
        if v < 24:
            j, r = divmod(v, 6)
            return (18 * col + 4 * j,
                    row + (r if j % 2 == 0 else 5 - r), 'h4')
        return 18 * col + 16, row + (v - 24), 'h4'
    if col % 2 == 1:
        if v < 3:
            return 18 * col - 2, row + 3 + v, 'h4'
        j, r = divmod(v - 3, 6)
        return (18 * col + 2 + 4 * j,
                row + (5 - r if j % 2 == 0 else r), 'h4')
    # col == 4 (rightmost): 4 snake columns then the 2-wide edge
    if v < 24:
        j, r = divmod(v, 6)
        return 72 + 4 * j, row + (r if j % 2 == 0 else 5 - r), 'h4'
    return 88, row + 2 * (v - 24), 'q'


def _ntsc_mb_blocks(seq, segi, b):
    """Block placement entries for one NTSC MB: list of
    (plane, py, px, split) per block in bitstream order Y0..Y3, Cr,
    Cb.  ``split`` marks the right-edge packed chroma block whose
    left 4 columns are the TOP 4x8 half and right 4 columns the
    BOTTOM half of a 4-wide 16-tall chroma region (verified against
    libavcodec)."""
    bx, by, kind = _ntsc_mb_position(seq, segi, b)
    out = []
    if kind == 'h4':
        for k in range(4):
            out.append((0, 8 * by, 8 * (bx + k), False))
        cx = 2 * bx
        out.append((2, 8 * by, cx, False))       # Cr
        out.append((1, 8 * by, cx, False))       # Cb
    else:
        for k in range(4):
            out.append((0, 8 * (by + (k >> 1)), 8 * (bx + (k & 1)),
                        False))
        out.append((2, 8 * by, 176, True))
        out.append((1, 8 * by, 176, True))
    return out


def dv_frame_size(data: bytes) -> int:
    """DIF frame size from the header DIF block's DSF flag (PAL
    144000 / NTSC 120000)."""
    if len(data) < 4:
        raise ValueError("dv: short frame")
    return 144000 if data[3] & 0x80 else 120000


# ------------------------------------------------------------------ #
# VLC LUT: 16-bit window -> (length, step, level)
# ------------------------------------------------------------------ #

def _build_vlc():
    lut = [(0, 0, 0)] * (1 << 16)

    def fill(code, ln, run, level):
        lo = code << (16 - ln)
        # step = run + 1: the position advance per codeword (EOB's
        # 127 steps past 63 and ends the block)
        for k in range(lo, lo + (1 << (16 - ln))):
            lut[k] = (ln, run + 1, level)

    entries = list(_VLC_HEAD) + [_EOB]
    # regular tails: 13-bit run-only codes (runs 0..63) and 15-bit
    # level-only codes (levels 0..255)
    for run in range(64):
        entries.append((8064 + run, 13, run, 0))
    for lvl in range(256):
        entries.append((32512 + lvl, 15, 0, lvl))
    for code, ln, run, level in entries:
        if level:
            fill(code << 1, ln + 1, run, level)
            fill((code << 1) | 1, ln + 1, run, -level)
        else:
            fill(code, ln, run, 0)
    return lut


_LUT = _build_vlc()


# ------------------------------------------------------------------ #
# Exact integer IDCTs
# ------------------------------------------------------------------ #

_W1, _W2, _W3, _W4 = 22725, 21407, 19266, 16383
_W5, _W6, _W7 = 12873, 8867, 4520
_ROW_SHIFT, _COL_SHIFT = 11, 20


def _idct_rows(blocks: np.ndarray) -> np.ndarray:
    """Row pass over (n, 8, 8) int64; rows whose AC is all zero take
    the exact dc<<3 shortcut (it differs from the W4 path in
    rounding)."""
    r = [blocks[:, :, i] for i in range(8)]
    half = np.int64(1) << (_ROW_SHIFT - 1)
    base = _W4 * r[0] + half
    a0 = base + _W2 * r[2] + _W4 * r[4] + _W6 * r[6]
    a1 = base + _W6 * r[2] - _W4 * r[4] - _W2 * r[6]
    a2 = base - _W6 * r[2] - _W4 * r[4] + _W2 * r[6]
    a3 = base - _W2 * r[2] + _W4 * r[4] - _W6 * r[6]
    b0 = _W1 * r[1] + _W3 * r[3] + _W5 * r[5] + _W7 * r[7]
    b1 = _W3 * r[1] - _W7 * r[3] - _W1 * r[5] - _W5 * r[7]
    b2 = _W5 * r[1] - _W1 * r[3] + _W7 * r[5] + _W3 * r[7]
    b3 = _W7 * r[1] - _W5 * r[3] + _W3 * r[5] - _W1 * r[7]
    out = np.empty_like(blocks)
    out[:, :, 0] = (a0 + b0) >> _ROW_SHIFT
    out[:, :, 7] = (a0 - b0) >> _ROW_SHIFT
    out[:, :, 1] = (a1 + b1) >> _ROW_SHIFT
    out[:, :, 6] = (a1 - b1) >> _ROW_SHIFT
    out[:, :, 2] = (a2 + b2) >> _ROW_SHIFT
    out[:, :, 5] = (a2 - b2) >> _ROW_SHIFT
    out[:, :, 3] = (a3 + b3) >> _ROW_SHIFT
    out[:, :, 4] = (a3 - b3) >> _ROW_SHIFT
    dconly = (blocks[:, :, 1:] == 0).all(axis=2)
    dc8 = blocks[:, :, 0] << 3
    out[dconly] = np.repeat(dc8[dconly][:, None], 8, axis=1)
    return out


def idct88(blocks: np.ndarray) -> np.ndarray:
    """(n, 8, 8) int coefficients -> (n, 8, 8) uint8 samples."""
    t = _idct_rows(blocks.astype(np.int64))
    c = [t[:, i, :] for i in range(8)]
    base = _W4 * (c[0] + ((np.int64(1) << (_COL_SHIFT - 1)) // _W4))
    a0 = base + _W2 * c[2] + _W4 * c[4] + _W6 * c[6]
    a1 = base + _W6 * c[2] - _W4 * c[4] - _W2 * c[6]
    a2 = base - _W6 * c[2] - _W4 * c[4] + _W2 * c[6]
    a3 = base - _W2 * c[2] + _W4 * c[4] - _W6 * c[6]
    b0 = _W1 * c[1] + _W3 * c[3] + _W5 * c[5] + _W7 * c[7]
    b1 = _W3 * c[1] - _W7 * c[3] - _W1 * c[5] - _W5 * c[7]
    b2 = _W5 * c[1] - _W1 * c[3] + _W7 * c[5] + _W3 * c[7]
    b3 = _W7 * c[1] - _W5 * c[3] + _W3 * c[5] - _W1 * c[7]
    out = np.empty_like(t)
    out[:, 0, :] = (a0 + b0) >> _COL_SHIFT
    out[:, 7, :] = (a0 - b0) >> _COL_SHIFT
    out[:, 1, :] = (a1 + b1) >> _COL_SHIFT
    out[:, 6, :] = (a1 - b1) >> _COL_SHIFT
    out[:, 2, :] = (a2 + b2) >> _COL_SHIFT
    out[:, 5, :] = (a2 - b2) >> _COL_SHIFT
    out[:, 3, :] = (a3 + b3) >> _COL_SHIFT
    out[:, 4, :] = (a3 - b3) >> _COL_SHIFT
    return np.clip(out, 0, 255).astype(np.uint8)


# 2-4-8: row pass, then a 4-point column IDCT per field
_CN_SHIFT = 12
_C1 = int(0.6532814824 * (1 << _CN_SHIFT) + 0.5)
_C2 = int(0.2705980501 * (1 << _CN_SHIFT) + 0.5)
_C_SHIFT = 4 + 1 + 12


def _idct4col(cols: np.ndarray) -> np.ndarray:
    a0, a1, a2, a3 = cols[:, 0], cols[:, 1], cols[:, 2], cols[:, 3]
    half = np.int64(1) << (_C_SHIFT - 1)
    c0 = ((a0 + a2) << (_CN_SHIFT - 1)) + half
    c2 = ((a0 - a2) << (_CN_SHIFT - 1)) + half
    c1 = a1 * _C1 + a3 * _C2
    c3 = a1 * _C2 - a3 * _C1
    out = np.empty_like(cols)
    out[:, 0] = (c0 + c1) >> _C_SHIFT
    out[:, 1] = (c2 + c3) >> _C_SHIFT
    out[:, 2] = (c2 - c3) >> _C_SHIFT
    out[:, 3] = (c0 - c1) >> _C_SHIFT
    return out


def idct248(blocks: np.ndarray) -> np.ndarray:
    """2x4x8 field transform: adjacent coefficient-row pairs are
    sum/difference butterflied FIRST (int16, unshifted — the '2' of
    2-4-8; recovered from the public binary), then the row pass; the
    sum rows (0/2/4/6) drive the even output lines through 4-point
    column IDCTs, the difference rows the odd lines."""
    b = blocks.astype(np.int64)
    bf = np.empty_like(b)
    s = b[:, 0::2, :] + b[:, 1::2, :]
    d = b[:, 0::2, :] - b[:, 1::2, :]
    # int16 wraparound semantics of the reference implementation
    bf[:, 0::2, :] = ((s + 0x8000) & 0xFFFF) - 0x8000
    bf[:, 1::2, :] = ((d + 0x8000) & 0xFFFF) - 0x8000
    t = _idct_rows(bf)
    out = np.empty_like(t)
    out[:, 0::2, :] = _idct4col(t[:, 0::2, :])
    out[:, 1::2, :] = _idct4col(t[:, 1::2, :])
    return np.clip(out, 0, 255).astype(np.uint8)


# ------------------------------------------------------------------ #
# Bit source: one bigint bitstring with a cursor
# ------------------------------------------------------------------ #

class _Bits:
    __slots__ = ("val", "n", "pos")

    def __init__(self, val: int, n: int):
        self.val = val
        self.n = n
        self.pos = 0

    @property
    def avail(self) -> int:
        return self.n - self.pos

    def take(self, k: int) -> int:
        v = (self.val >> (self.n - self.pos - k)) & ((1 << k) - 1)
        self.pos += k
        return v

    def leftover(self) -> Tuple[int, int]:
        """Remaining bits as (value, count)."""
        k = self.n - self.pos
        return (self.val & ((1 << k) - 1), k) if k else (0, 0)


def _concat(frags: List[Tuple[int, int]]) -> _Bits:
    v = 0
    n = 0
    for fv, fn in frags:
        v = (v << fn) | fv
        n += fn
    return _Bits(v, n)


class _Block:
    __slots__ = ("coefs", "scan", "factor", "pos", "pb", "pn",
                 "done", "mode")

    def __init__(self, scan, factor, mode):
        self.coefs = [0] * 64
        self.scan = scan
        self.factor = factor
        self.pos = 0
        self.pb = 0                      # partial codeword bits
        self.pn = 0
        self.done = False
        self.mode = mode


# ------------------------------------------------------------------ #
# The decoder
# ------------------------------------------------------------------ #

class DVDecoder:
    """DV25 frame decoder (PAL 4:2:0 and NTSC 4:1:1):
    decode(data) -> (y, u, v) — NTSC chroma planes are (480, 180)."""

    def __init__(self):
        # factor[class==3][mode][quant][scan position]
        f = np.zeros((2, 2, 22, 64), np.int64)
        area = np.zeros(64, np.int64)
        bounds = (0,) + _QUANT_AREAS
        for a in range(4):
            area[bounds[a]:bounds[a + 1]] = a
        for s in range(22):
            sh = np.array(_QUANT_SHIFTS[s], np.int64)[area]
            for m, iw in enumerate((_IWEIGHT_88, _IWEIGHT_248)):
                w = np.array(iw, np.int64)
                f[0, m, s] = w << (sh + 1)
                f[1, m, s] = w << (sh + 2)
        self._factors = [[[r.tolist() for r in m] for m in c]
                         for c in f]
        self._scan = (list(_ZIGZAG_88), list(_ZIGZAG_248))

    # ------------------------------------------------------------- #

    def _drain(self, blk: _Block, bs: _Bits) -> None:
        """Decode AC codewords for blk from bs until EOB or the
        source runs dry (partial codeword saved on the block)."""
        lut = _LUT
        factor = blk.factor
        scan = blk.scan
        coefs = blk.coefs
        while not blk.done:
            have = blk.pn + bs.avail
            if have <= 0:
                return
            k = 16 - blk.pn
            if k > bs.avail:
                k = bs.avail
            w = (blk.pb << k) | (bs.take(k) if k else 0)
            wl = blk.pn + k
            ln, step, level = lut[w << (16 - wl)]
            if ln == 0 or ln > wl:
                blk.pb = w                # incomplete codeword
                blk.pn = wl
                return
            bs.pos -= k - (ln - blk.pn)   # push back the lookahead
            blk.pb = 0
            blk.pn = 0
            pos = blk.pos + step
            if pos > 63:
                blk.done = True
                return
            blk.pos = pos
            if level:
                v = (level * factor[pos] + 0x2000) >> 14
                coefs[scan[pos]] = v

    def _parse_mb(self, payload: bytes) -> List[_Block]:
        """One 77-byte compressed macroblock -> 6 blocks (pass 1 +
        MB-local pass 2); leftover fragments are attached for the
        segment pass."""
        qno = payload[0] & 0x0F
        big = int.from_bytes(payload, "big")
        total = len(payload) * 8
        blocks: List[_Block] = []
        frags: List[Tuple[int, int]] = []
        bitpos = 8
        for bi, nbits in enumerate(_BLOCK_BITS):
            seg = (big >> (total - bitpos - nbits)) \
                & ((1 << nbits) - 1)
            bs = _Bits(seg, nbits)
            dc = bs.take(9)
            if dc >= 256:
                dc -= 512
            mode = bs.take(1)
            cls = bs.take(2)
            q = qno + _QUANT_OFFSET[cls]
            blk = _Block(self._scan[mode],
                         self._factors[1 if cls == 3 else 0][mode][q],
                         mode)
            blk.coefs[0] = dc * 4 + 1024
            self._drain(blk, bs)
            blocks.append(blk)
            frags.append(bs.leftover())
            bitpos += nbits
        # pass 2: unfinished blocks drain the MB pool in order
        pool = _concat(frags)
        for blk in blocks:
            if not blk.done:
                self._drain(blk, pool)
        return blocks, pool.leftover()

# ------------------------------------------------------------------ #
# DV audio (AAUX): PAL 48 kHz 16-bit stereo
# ------------------------------------------------------------------ #
#
# The audio shuffle was derived EMPIRICALLY (PCM whose sample values
# encode their own indices, written through the standard DV muxer):
# sample n of a channel lives at
#   seq  = (2*(r%3) + r//3) % 6      (+6 for channel 2)
#   dbn  = 3*(r%3) + r//18
#   slot = n // 54                   (byte pair 5+2*slot of the block)
# with r = n % 54; 1920 samples per channel per PAL frame.

def _audio_positions():
    """(seq, dbn, byteoff) arrays for the 1920 samples of channel 0
    (channel 1 adds 6 to seq)."""
    n = np.arange(1920)
    r = n % 54
    seq = (2 * (r % 3) + r // 3) % 6
    dbn = 3 * (r % 3) + r // 18
    off = 5 + 2 * (n // 54)
    return seq, dbn, off


_AUD_SEQ, _AUD_DBN, _AUD_OFF = _audio_positions()


def extract_audio(data: bytes) -> Tuple[np.ndarray, int]:
    """DV25 PAL frame -> ((1920, 2) int16 samples, rate).  Only the
    48 kHz 16-bit locked-audio mode is implemented (the AS pack is
    checked); other modes raise NotImplementedError."""
    if len(data) < 144000 or not (data[3] & 0x80):
        raise ValueError("dv audio: need a PAL DIF frame")
    # audio DIF payloads per (seq, dbn)
    blocks = {}
    as_pack = None
    for off in range(0, 144000, 80):
        if data[off] >> 5 == 3:
            seq = data[off + 1] >> 4
            dbn = data[off + 2]
            blocks[(seq, dbn)] = data[off + 3:off + 80]
            if as_pack is None and data[off + 3] == 0x50:
                as_pack = data[off + 3:off + 8]
    if len(blocks) != 108:
        raise ValueError("dv audio: incomplete audio sections")
    if as_pack is None or as_pack[1] == 0xFF:
        raise ValueError("dv audio: no AAUX source pack (no audio)")
    smp = (as_pack[4] >> 3) & 0x7
    qu = as_pack[4] & 0x7
    if smp != 0 or qu != 0:
        raise NotImplementedError(
            "dv audio: only 48 kHz 16-bit is implemented natively "
            f"(stream has smp={smp} qu={qu}); use the FFmpeg bridge")
    out = np.zeros((1920, 2), np.int16)
    for ch in range(2):
        for n in range(1920):
            pl = blocks[(int(_AUD_SEQ[n]) + 6 * ch, int(_AUD_DBN[n]))]
            o = int(_AUD_OFF[n])
            out[n, ch] = int.from_bytes(pl[o:o + 2], "big",
                                        signed=True)
    return out, 48000
