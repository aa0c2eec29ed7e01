# Copied from tcforge_tpu/io/theora.py lines 27-578 and 584-586 and 642-649 and 680-856; the Theora header parse (identification, setup, quantizer matrices), the block geometry and the host parse of a data packet up to its tokens (coded-block flags, macroblock modes, motion vectors, block qi) with the crop, without the module docstring and the decoder's packet loop, token decode, DC prediction, reconstruction and loop filter, which the port splits between the host's compiled coder and the device (io/theoracodec.py, csrc/theora_host.cpp, csrc/theora.cu).
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

__all__ = ["TheoraInfo", "parse_ident", "TheoraDecoder"]


# ------------------------------------------------------------------ #
# MSB-first bit reader
# ------------------------------------------------------------------ #

class Bits:
    """MSB-first bit reader; reads past the end return zero bits
    (spec 5.2: the packet is treated as padded with zeros).

    The packet is pre-split into big-endian 32-bit words held as
    python ints so any <= 32-bit read is two word fetches and a
    shift — the token loop reads hundreds of thousands of fields
    per frame."""

    __slots__ = ("words", "pos", "nbits", "raw8")

    def __init__(self, data: bytes):
        pad = data + b"\x00" * 8
        self.words = np.frombuffer(
            pad[:len(pad) // 4 * 4], ">u4").tolist()
        self.pos = 0                       # bit position
        self.nbits = 8 * len(data)
        # raw byte view for the native token decoder
        self.raw8 = np.frombuffer(data, np.uint8)

    def read(self, n: int) -> int:
        p = self.pos
        self.pos = p + n
        if p >= self.nbits:
            return 0                   # zero-fill past the end
        i = p >> 5
        w = (self.words[i] << 32) | self.words[i + 1]
        return (w >> (64 - (p & 31) - n)) & ((1 << n) - 1)

    def read1(self) -> int:
        p = self.pos
        self.pos = p + 1
        if p >= self.nbits:
            return 0
        return (self.words[p >> 5] >> (31 - (p & 31))) & 1

    @property
    def eof(self) -> bool:
        return self.pos >= self.nbits


def _ilog(v: int) -> int:
    return v.bit_length()


# ------------------------------------------------------------------ #
# Fixed spec tables (recovered from the public binaries; see module
# docstring).  All are constants of the published Theora I spec.
# ------------------------------------------------------------------ #

# Block traversal within a 4x4-block superblock, (x, y) offsets.
HILBERT = ((0, 0), (1, 0), (1, 1), (0, 1), (0, 2), (0, 3), (1, 3),
           (1, 2), (2, 2), (2, 3), (3, 3), (3, 2), (3, 1), (2, 1),
           (2, 0), (3, 0))

# Macroblock traversal within a superblock's 2x2 quad, (x, y).
MB_QUAD = ((0, 0), (0, 1), (1, 1), (1, 0))

# DC predictor weights [UL, U, UR, L], index = L | UR<<1 | U<<2 | UL<<3
PRED_W = ((0, 0, 0, 0), (0, 0, 0, 128), (0, 0, 128, 0),
          (0, 0, 53, 75), (0, 128, 0, 0), (0, 64, 0, 64),
          (0, 128, 0, 0), (0, 0, 53, 75), (128, 0, 0, 0),
          (0, 0, 0, 128), (64, 0, 64, 0), (0, 0, 53, 75),
          (0, 128, 0, 0), (-104, 116, 0, 116), (24, 80, 24, 0),
          (-104, 116, 0, 116))

# Reference-frame class per coding mode (0 intra, 1 prev, 2 golden).
MODE_NO_MV, MODE_INTRA, MODE_MV, MODE_LAST, MODE_LAST2, \
    MODE_GOLDEN, MODE_GOLDEN_MV, MODE_FOURMV = range(8)
FRAME_CLASS = (1, 0, 1, 1, 1, 2, 2, 1)

# Mode alphabets for coding schemes 1..6 (scheme 0 = custom, 7 = CLC).
MODE_ALPHABETS = (
    (MODE_LAST, MODE_LAST2, MODE_MV, MODE_NO_MV, MODE_INTRA,
     MODE_GOLDEN, MODE_GOLDEN_MV, MODE_FOURMV),
    (MODE_LAST, MODE_LAST2, MODE_NO_MV, MODE_MV, MODE_INTRA,
     MODE_GOLDEN, MODE_GOLDEN_MV, MODE_FOURMV),
    (MODE_LAST, MODE_MV, MODE_LAST2, MODE_NO_MV, MODE_INTRA,
     MODE_GOLDEN, MODE_GOLDEN_MV, MODE_FOURMV),
    (MODE_LAST, MODE_MV, MODE_NO_MV, MODE_LAST2, MODE_INTRA,
     MODE_GOLDEN, MODE_GOLDEN_MV, MODE_FOURMV),
    (MODE_NO_MV, MODE_LAST, MODE_LAST2, MODE_MV, MODE_INTRA,
     MODE_GOLDEN, MODE_GOLDEN_MV, MODE_FOURMV),
    (MODE_NO_MV, MODE_GOLDEN, MODE_LAST, MODE_LAST2, MODE_MV,
     MODE_INTRA, MODE_GOLDEN_MV, MODE_FOURMV),
)

# Long-run (superblock flag) code: canonical code from the length
# array {1,3,3,4,4,6,6,6,6,8*8,10*16,6}; symbol 33 is the escape
# (12 extra bits, runs 34..4129, and a maximum-length run does not
# toggle the flag).
_SB_RUN_LENS = (1, 3, 3, 4, 4, 6, 6, 6, 6) + (8,) * 8 + (10,) * 16 + (6,)
LONG_RUN_MAX = 4129

# Short-run (block flag) code lengths, runs 1..30.
_FRAG_RUN_LENS = (2, 2, 3, 3, 4, 4, 6, 6, 6, 6, 7, 7, 7, 7) + (9,) * 16
SHORT_RUN_MAX = 30

# Mode VLC: unary, lengths {1,2,3,4,5,6,7,7} over alphabet ranks.
_MODE_LENS = (1, 2, 3, 4, 5, 6, 7, 7)

# Motion-vector VLC (sym, len) pairs in canonical code order; the
# symbol is the MV value + 31.
_MV_SYMS_LENS = (
    (31, 3), (32, 3), (30, 3), (33, 4), (29, 4), (34, 4), (28, 4),
    (35, 6), (27, 6), (36, 6), (26, 6), (37, 6), (25, 6), (38, 6),
    (24, 6), (39, 7), (23, 7), (40, 7), (22, 7), (41, 7), (21, 7),
    (42, 7), (20, 7), (43, 7), (19, 7), (44, 7), (18, 7), (45, 7),
    (17, 7), (46, 7), (16, 7), (47, 8), (15, 8), (48, 8), (14, 8),
    (49, 8), (13, 8), (50, 8), (12, 8), (51, 8), (11, 8), (52, 8),
    (10, 8), (53, 8), (9, 8), (54, 8), (8, 8), (55, 8), (7, 8),
    (56, 8), (6, 8), (57, 8), (5, 8), (58, 8), (4, 8), (59, 8),
    (3, 8), (60, 8), (2, 8), (61, 8), (1, 8), (62, 8), (0, 8))

ZIGZAG = (0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
          12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21,
          28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30,
          37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61,
          54, 47, 55, 62, 63)

# iDCT cosine constants (16-bit approximations, spec 7.9.3.5).
xC1S7, xC2S6, xC3S5, xC4S4 = 64277, 60547, 54491, 46341
xC5S3, xC6S2, xC7S1 = 36410, 25080, 12785

# Coefficient index -> AC Huffman table group (group 0 is DC).
_COEF_GROUP = [0] + [1] * 5 + [2] * 9 + [3] * 13 + [4] * 36

# Debug switch: interpret setup base matrices as zigzag-ordered
# instead of raster (resolved against the oracle; see tests).
_QMAT_ZIGZAG = False


def _canonical_lut(syms_lens):
    """(symbol, length) pairs in canonical code order -> LUT lists
    (sym, len) indexed by the next `maxlen` bits (python lists: the
    decode loop indexes them millions of times)."""
    maxlen = max(ln for _, ln in syms_lens)
    lut_sym = [0] * (1 << maxlen)
    lut_len = [0] * (1 << maxlen)
    code32 = 0                       # left-aligned accumulator, so a
    for sym, ln in syms_lens:        # shorter code may follow longer
        code = code32 >> (32 - ln)   # ones (the long-run escape does)
        lo = code << (maxlen - ln)
        for k in range(lo, lo + (1 << (maxlen - ln))):
            lut_sym[k] = sym
            lut_len[k] = ln
        code32 += 1 << (32 - ln)
    return lut_sym, lut_len, maxlen


_SB_LUT = _canonical_lut(tuple((i, l) for i, l in
                                enumerate(_SB_RUN_LENS)))
_FRAG_LUT = _canonical_lut(tuple((i, l) for i, l in
                                 enumerate(_FRAG_RUN_LENS)))
_MODE_LUT = _canonical_lut(tuple((i, l) for i, l in
                                 enumerate(_MODE_LENS)))
_MV_LUT = _canonical_lut(_MV_SYMS_LENS)


def _read_lut(bits: Bits, lut) -> int:
    lut_sym, lut_len, maxlen = lut
    p = bits.pos
    v = bits.read(maxlen)                 # peek
    bits.pos = p + lut_len[v]             # consume the real length
    return lut_sym[v]


def _read_long_run(bits: Bits) -> int:
    sym = _read_lut(bits, _SB_LUT)
    if sym == 33:
        return 34 + bits.read(12)
    return sym + 1


def _read_short_run(bits: Bits) -> int:
    return _read_lut(bits, _FRAG_LUT) + 1


def _read_mv_vlc(bits: Bits) -> int:
    return _read_lut(bits, _MV_LUT) - 31


# ------------------------------------------------------------------ #
# Headers
# ------------------------------------------------------------------ #

@dataclass
class TheoraInfo:
    version: Tuple[int, int, int]
    fmbw: int                     # frame width in macroblocks
    fmbh: int
    pic_w: int
    pic_h: int
    pic_x: int
    pic_y: int
    fps_num: int
    fps_den: int
    par_num: int
    par_den: int
    colorspace: int
    pixel_format: int             # 0 = 4:2:0, 2 = 4:2:2, 3 = 4:4:4
    nombr: int = 0
    quality: int = 0
    kfgshift: int = 6

    @property
    def frame_w(self) -> int:
        return self.fmbw * 16

    @property
    def frame_h(self) -> int:
        return self.fmbh * 16


def parse_ident(pkt: bytes) -> TheoraInfo:
    """Identification header (spec 6.2)."""
    if len(pkt) < 42 or pkt[0] != 0x80 or pkt[1:7] != b"theora":
        raise ValueError("not a theora identification header")
    b = Bits(pkt[7:])
    vmaj, vmin, vrev = b.read(8), b.read(8), b.read(8)
    if vmaj != 3 or vmin != 2:
        raise ValueError(f"unsupported theora version {vmaj}.{vmin}")
    fmbw = b.read(16)
    fmbh = b.read(16)
    pic_w = b.read(24)
    pic_h = b.read(24)
    pic_x = b.read(8)
    pic_y = b.read(8)
    frn = b.read(32)
    frd = b.read(32)
    parn = b.read(24)
    pard = b.read(24)
    cs = b.read(8)
    nombr = b.read(24)
    qual = b.read(6)
    kfgshift = b.read(5)
    pf = b.read(2)
    if fmbw == 0 or fmbh == 0 or pic_w > fmbw * 16 or pic_h > fmbh * 16:
        raise ValueError("theora: bad frame geometry")
    if fmbw * 16 > 4096 or fmbh * 16 > 4096:
        # not a spec limit — a defensive cap so a crafted header
        # cannot demand minutes of block-map construction before any
        # data arrives (4096px is far beyond any real theora stream)
        raise ValueError("theora: frame dimensions beyond the "
                         "4096-px defensive cap")
    return TheoraInfo((vmaj, vmin, vrev), fmbw, fmbh, pic_w, pic_h,
                      pic_x, pic_y, frn, frd, parn, pard, cs, pf,
                      nombr, qual, kfgshift)


@dataclass
class _Setup:
    lflims: np.ndarray            # (64,)
    acscale: np.ndarray           # (64,)
    dcscale: np.ndarray           # (64,)
    base_mats: np.ndarray         # (nbms, 64)
    qr_counts: list               # [qti][pli] -> nranges
    qr_sizes: list                # [qti][pli] -> list
    qr_bmis: list                 # [qti][pli] -> list
    huff: list                    # 80 entries of (lut_sym, lut_len, maxlen) or tree
    huff_leaves: list             # 80 lists of (code, len, token)


def _read_huff_tree(b: Bits, leaves: list, code: int, ln: int) -> None:
    if ln > 32:
        raise ValueError("theora: huffman tree too deep")
    if b.read1():
        leaves.append((code, ln, b.read(5)))
    else:
        _read_huff_tree(b, leaves, code << 1, ln + 1)
        _read_huff_tree(b, leaves, (code << 1) | 1, ln + 1)


def parse_setup(pkt: bytes) -> _Setup:
    """Setup header (spec 6.4): loop-filter limits, quantizer scales
    and base matrices, quant ranges, 80 Huffman tables."""
    if len(pkt) < 7 or pkt[0] != 0x82 or pkt[1:7] != b"theora":
        raise ValueError("not a theora setup header")
    b = Bits(pkt[7:])
    nbits = b.read(3)
    lflims = np.array([b.read(nbits) for _ in range(64)], np.int32)
    nbits = b.read(4) + 1
    acscale = np.array([b.read(nbits) for _ in range(64)], np.int64)
    nbits = b.read(4) + 1
    dcscale = np.array([b.read(nbits) for _ in range(64)], np.int64)
    nbms = b.read(9) + 1
    if nbms > 384:
        raise ValueError("theora: too many base matrices")
    base = np.array([[b.read(8) for _ in range(64)]
                     for _ in range(nbms)], np.int64)
    qr_counts = [[0] * 3, [0] * 3]
    qr_sizes = [[None] * 3, [None] * 3]
    qr_bmis = [[None] * 3, [None] * 3]
    for qti in range(2):
        for pli in range(3):
            newqr = 1 if (qti, pli) == (0, 0) else b.read1()
            if not newqr:
                rpqr = b.read1() if qti > 0 else 0
                if rpqr:
                    qtj, plj = qti - 1, pli
                else:
                    qtj = (3 * qti + pli - 1) // 3
                    plj = (pli + 2) % 3
                qr_counts[qti][pli] = qr_counts[qtj][plj]
                qr_sizes[qti][pli] = qr_sizes[qtj][plj]
                qr_bmis[qti][pli] = qr_bmis[qtj][plj]
                continue
            sizes = []
            bmis = [b.read(_ilog(nbms - 1))]
            qi = 0
            while qi < 63:
                sz = b.read(_ilog(62 - qi)) + 1
                sizes.append(sz)
                qi += sz
                bmis.append(b.read(_ilog(nbms - 1)))
            if qi != 63:
                raise ValueError("theora: quant ranges overrun")
            qr_counts[qti][pli] = len(sizes)
            qr_sizes[qti][pli] = sizes
            qr_bmis[qti][pli] = bmis
    huff = []
    all_leaves = []
    for _ in range(80):
        leaves: list = []
        _read_huff_tree(b, leaves, 0, 0)
        all_leaves.append(leaves)
        if len(leaves) == 1 and leaves[0][1] == 0:
            # degenerate single-leaf tree: zero-length code
            huff.append(([leaves[0][2]], [0], 0))
            continue
        maxlen = max(ln for _, ln, _ in leaves)
        if maxlen > 16:
            # a maximally skewed 32-leaf tree can reach depth 31; a
            # flat LUT would need 2^31 entries.  Real tables are
            # shallow — beyond 16 bits fall back to a (code,len)
            # dict walked bit by bit (correct, just slower, and only
            # ever reached by hostile streams).
            huff.append(({(c, ln): tok for c, ln, tok in leaves},
                         None, maxlen))
            continue
        lut_sym = [0] * (1 << maxlen)
        lut_len = [0] * (1 << maxlen)
        for code, ln, tok in leaves:
            lo = code << (maxlen - ln)
            for k in range(lo, lo + (1 << (maxlen - ln))):
                lut_sym[k] = tok
                lut_len[k] = ln
        huff.append((lut_sym, lut_len, maxlen))
    return _Setup(lflims, acscale, dcscale, base, qr_counts,
                  qr_sizes, qr_bmis, huff, all_leaves)


# ------------------------------------------------------------------ #
# Dequant matrices
# ------------------------------------------------------------------ #

def _build_qmat(setup: _Setup, qti: int, pli: int, qi: int
                ) -> np.ndarray:
    """(64,) int32 quantizer matrix in ZIGZAG-index order is NOT used;
    matrices are in natural (raster) coefficient order like the base
    matrices (spec 6.4.3)."""
    sizes = setup.qr_sizes[qti][pli]
    bmis = setup.qr_bmis[qti][pli]
    qlo = 0
    for ri, sz in enumerate(sizes):
        qhi = qlo + sz
        if qi <= qhi:
            break
        qlo = qhi
    else:
        ri = len(sizes) - 1
        qlo = 63 - sizes[-1]
        qhi = 63
    bm_lo = setup.base_mats[bmis[ri]]
    bm_hi = setup.base_mats[bmis[ri + 1]]
    d = qhi - qlo
    bm = (2 * (qhi - qi) * bm_lo + 2 * (qi - qlo) * bm_hi + d) // (2 * d)
    qmat = np.empty(64, np.int64)
    for ci in range(64):
        qscale = setup.dcscale[qi] if ci == 0 else setup.acscale[qi]
        qmin = 8 << ((1 if qti else 0) + (1 if ci == 0 else 0))
        v = (qscale * bm[ci] // 100) * 4
        qmat[ci] = max(qmin, min(int(v), 4096))
    return qmat.astype(np.int32)


# ------------------------------------------------------------------ #
# Integer iDCT (spec 7.9.3)
# ------------------------------------------------------------------ #

def _idct_1d(x: np.ndarray) -> np.ndarray:
    """One 1D pass over the last axis of an int32 array of 8-vectors.
    Each cosine product is truncated to (a*b)>>16 individually."""
    def M(c, v):
        return (c * v) >> 16
    x0, x1, x2, x3 = x[..., 0], x[..., 1], x[..., 2], x[..., 3]
    x4, x5, x6, x7 = x[..., 4], x[..., 5], x[..., 6], x[..., 7]
    A = M(xC1S7, x1) + M(xC7S1, x7)
    B = M(xC7S1, x1) - M(xC1S7, x7)
    C = M(xC3S5, x3) + M(xC5S3, x5)
    D = M(xC3S5, x5) - M(xC5S3, x3)
    Ad = M(xC4S4, A - C)
    Bd = M(xC4S4, B - D)
    Cd = A + C
    Dd = B + D
    E = M(xC4S4, x0 + x4)
    F = M(xC4S4, x0 - x4)
    G = M(xC2S6, x2) + M(xC6S2, x6)
    H = M(xC6S2, x2) - M(xC2S6, x6)
    Ed = E - G
    Gd = E + G
    Add = F + Ad
    Bdd = Bd - H
    Fd = F - Ad
    Hd = Bd + H
    out = np.empty_like(x)
    out[..., 0] = Gd + Cd
    out[..., 7] = Gd - Cd
    out[..., 1] = Add + Hd
    out[..., 2] = Add - Hd
    out[..., 3] = Ed + Dd
    out[..., 4] = Ed - Dd
    out[..., 5] = Fd + Bdd
    out[..., 6] = Fd - Bdd
    return out


def idct8x8(blocks: np.ndarray) -> np.ndarray:
    """(n, 8, 8) int32 dequantized coefficients -> (n, 8, 8) residuals.
    Row pass, column pass, then (v + 8) >> 4."""
    t = _idct_1d(blocks)                       # rows
    t = _idct_1d(t.transpose(0, 2, 1)).transpose(0, 2, 1)  # columns
    return (t + 8) >> 4


# ------------------------------------------------------------------ #
# Frame geometry
# ------------------------------------------------------------------ #

class _Geometry:
    """Block/superblock/macroblock layout for one pixel format."""

    def __init__(self, info: TheoraInfo):
        fmt = info.pixel_format
        if fmt not in (0, 2, 3):
            raise NotImplementedError(
                "theora: reserved pixel format "
                f"{fmt}")
        self.fmt = fmt
        fw, fh = info.frame_w, info.frame_h
        if fmt == 0:
            self.plane_w = (fw, fw // 2, fw // 2)
            self.plane_h = (fh, fh // 2, fh // 2)
        elif fmt == 2:                 # 4:2:2: full vertical chroma
            self.plane_w = (fw, fw // 2, fw // 2)
            self.plane_h = (fh, fh, fh)
        else:                          # 4:4:4
            self.plane_w = (fw, fw, fw)
            self.plane_h = (fh, fh, fh)
        self.bw = tuple(w // 8 for w in self.plane_w)
        self.bh = tuple(h // 8 for h in self.plane_h)
        self.nblocks = tuple(self.bw[p] * self.bh[p] for p in range(3))
        self.plane_off = (0, self.nblocks[0],
                          self.nblocks[0] + self.nblocks[1])
        self.total_blocks = sum(self.nblocks)
        self.sbw = tuple((w + 3) // 4 for w in self.bw)
        self.sbh = tuple((h + 3) // 4 for h in self.bh)
        self.nsbs = tuple(self.sbw[p] * self.sbh[p] for p in range(3))
        self.total_sbs = sum(self.nsbs)

        # superblock -> list of global block ids in coded order
        self.sb_blocks: List[List[int]] = []
        # global coded order list of block ids
        coded_order = []
        # block id -> (plane, by, bx)
        self.block_pos = np.zeros((self.total_blocks, 3), np.int32)
        for p in range(3):
            for by in range(self.bh[p]):
                for bx in range(self.bw[p]):
                    bid = self.plane_off[p] + by * self.bw[p] + bx
                    self.block_pos[bid] = (p, by, bx)
            for sby in range(self.sbh[p]):
                for sbx in range(self.sbw[p]):
                    blocks = []
                    for hx, hy in HILBERT:
                        bx = 4 * sbx + hx
                        by = 4 * sby + hy
                        if bx < self.bw[p] and by < self.bh[p]:
                            blocks.append(self.plane_off[p]
                                          + by * self.bw[p] + bx)
                    self.sb_blocks.append(blocks)
                    coded_order.extend(blocks)
        self.coded_order = np.array(coded_order, np.int32)
        # position of each block id in coded order
        self.coded_rank = np.zeros(self.total_blocks, np.int32)
        self.coded_rank[self.coded_order] = np.arange(
            self.total_blocks, dtype=np.int32)

        # macroblocks in coded order: luma superblock raster, 2x2 quad
        # pattern, skipping out-of-bounds MBs
        self.mbw, self.mbh = info.fmbw, info.fmbh
        self.mb_order: List[Tuple[int, int]] = []
        for sby in range((self.mbh + 1) // 2):
            for sbx in range((self.mbw + 1) // 2):
                for qx, qy in MB_QUAD:
                    mbx = 2 * sbx + qx
                    mby = 2 * sby + qy
                    if mbx < self.mbw and mby < self.mbh:
                        self.mb_order.append((mbx, mby))
        # MB -> 4 luma block ids (raster within MB) + 2 chroma ids
        self.mb_luma = {}
        self.mb_chroma = {}
        for mbx, mby in self.mb_order:
            luma = []
            for j in range(2):
                for i in range(2):
                    bx, by = 2 * mbx + i, 2 * mby + j
                    luma.append(by * self.bw[0] + bx)
            self.mb_luma[(mbx, mby)] = luma
            if fmt == 0:
                ch = (self.plane_off[1] + mby * self.bw[1] + mbx,
                      self.plane_off[2] + mby * self.bw[2] + mbx)
            elif fmt == 2:
                # two vertically stacked chroma blocks per plane;
                # index order: plane 1 top/bottom, plane 2 ditto
                ch = tuple(
                    self.plane_off[p] + (2 * mby + j)
                    * self.bw[p] + mbx
                    for p in (1, 2) for j in (0, 1))
            else:
                # 4:4:4: the same 2x2 block quad as luma, per plane
                ch = tuple(
                    self.plane_off[p] + (2 * mby + j)
                    * self.bw[p] + (2 * mbx + i)
                    for p in (1, 2) for j in (0, 1)
                    for i in (0, 1))
            self.mb_chroma[(mbx, mby)] = ch

class TheoraDecoder:
    """Stateful frame decoder: feed data packets in stream order."""

    def _qmat(self, qti: int, pli: int, qi: int) -> np.ndarray:
        key = (qti, pli, qi)
        m = self._qmat_cache.get(key)
        if m is None:
            m = _build_qmat(self.setup, qti, pli, qi)
            self._qmat_cache[key] = m
        return m

    def _crop(self):
        # the frame is coded bottom-up (VP3 heritage): flip to display
        # orientation, then cut the picture region.  PICY counts from
        # the BOTTOM of the frame, so the display-space top offset is
        # frame_h - pic_y - pic_h (chroma: >>1), verified against the
        # oracle on non-multiple-of-16 geometry.
        info = self.info
        top = info.frame_h - info.pic_y - info.pic_h
        out = []
        for p, plane in enumerate(self.last):
            if p == 0:
                px, pw, ph, ty = (info.pic_x, info.pic_w,
                                  info.pic_h, top)
            elif self.geo.fmt == 0:
                px, pw = info.pic_x // 2, (info.pic_w + 1) // 2
                ph, ty = (info.pic_h + 1) // 2, top >> 1
            elif self.geo.fmt == 2:
                px, pw = info.pic_x // 2, (info.pic_w + 1) // 2
                ph, ty = info.pic_h, top
            else:
                px, pw, ph, ty = (info.pic_x, info.pic_w,
                                  info.pic_h, top)
            disp = plane[::-1]
            out.append(disp[ty:ty + ph, px:px + pw].copy())
        return tuple(out)

    # ------------------------------------------------------------- #
    # Coded-block flags (spec 7.3)
    # ------------------------------------------------------------- #

    def _read_block_flags(self, b: Bits) -> np.ndarray:
        geo = self.geo
        coded = np.zeros(geo.total_blocks, bool)
        nsb = geo.total_sbs
        # pass 1: partially-coded superblock flags, long runs
        partial = np.zeros(nsb, bool)
        flag = b.read1()
        i = 0
        while i < nsb:
            run = _read_long_run(b)
            partial[i:i + run] = flag
            i += run
            if i < nsb:
                flag = b.read1() if run == LONG_RUN_MAX else flag ^ 1
        # pass 2: fully-coded flags for the non-partial superblocks
        full = np.zeros(nsb, bool)
        rest = np.nonzero(~partial)[0]
        if len(rest):
            flag = b.read1()
            i = 0
            while i < len(rest):
                run = _read_long_run(b)
                full[rest[i:i + run]] = flag
                i += run
                if i < len(rest):
                    flag = b.read1() if run == LONG_RUN_MAX else flag ^ 1
        for sb in np.nonzero(full)[0]:
            coded[geo.sb_blocks[sb]] = True
        # pass 3: block flags within partial superblocks, short runs
        # (state carries across superblocks; a maximum-length run is
        # followed by an explicit flag bit instead of a toggle)
        psbs = np.nonzero(partial)[0]
        if len(psbs):
            flag = b.read1()
            run = _read_short_run(b)
            last_max = run == SHORT_RUN_MAX
            for sb in psbs:
                for bid in geo.sb_blocks[sb]:
                    if run == 0:
                        flag = b.read1() if last_max else flag ^ 1
                        run = _read_short_run(b)
                        last_max = run == SHORT_RUN_MAX
                    coded[bid] = flag
                    run -= 1
        return coded

    # ------------------------------------------------------------- #
    # Modes + motion vectors (spec 7.4 / 7.5)
    # ------------------------------------------------------------- #

    def _read_modes(self, b: Bits, coded: np.ndarray):
        geo = self.geo
        scheme = b.read(3)
        if scheme == 0:
            alphabet = [0] * 8
            for mode in range(8):
                alphabet[b.read(3)] = mode
        elif scheme < 7:
            alphabet = MODE_ALPHABETS[scheme - 1]
        mb_modes = {}
        for mb in geo.mb_order:
            luma = geo.mb_luma[mb]
            if not any(coded[bid] for bid in luma):
                mb_modes[mb] = -1             # uncoded MB
                continue
            if scheme == 7:
                mb_modes[mb] = b.read(3)
            else:
                mb_modes[mb] = alphabet[_read_lut(b, _MODE_LUT)]
        return mb_modes

    def _read_mv(self, b: Bits, vlc: bool) -> Tuple[int, int]:
        if vlc:
            return _read_mv_vlc(b), _read_mv_vlc(b)
        x = b.read(5)
        if b.read1():
            x = -x
        y = b.read(5)
        if b.read1():
            y = -y
        return x, y

    def _read_motion(self, b: Bits, coded, mb_modes):
        geo = self.geo
        vlc = b.read1() == 0
        last = (0, 0)
        last2 = (0, 0)
        mb_mvs = {}
        for mb in geo.mb_order:
            mode = mb_modes[mb]
            if mode < 0:
                continue
            if mode == MODE_MV:
                mv = self._read_mv(b, vlc)
                last2 = last
                last = mv
                mb_mvs[mb] = mv
            elif mode == MODE_GOLDEN_MV:
                mb_mvs[mb] = self._read_mv(b, vlc)
            elif mode == MODE_FOURMV:
                mvs = []
                for bid in geo.mb_luma[mb]:
                    if coded[bid]:
                        mvs.append(self._read_mv(b, vlc))
                    else:
                        mvs.append((0, 0))
                mb_mvs[mb] = mvs
                # the "last MV" after FOURMV is the last CODED block's
                last2 = last
                for k in (3, 2, 1, 0):
                    if coded[geo.mb_luma[mb][k]]:
                        last = mvs[k]
                        break
            elif mode == MODE_LAST:
                mb_mvs[mb] = last
            elif mode == MODE_LAST2:
                mb_mvs[mb] = last2
                last, last2 = last2, last
            else:
                mb_mvs[mb] = (0, 0)           # NO_MV / INTRA / GOLDEN
        return mb_mvs

    # ------------------------------------------------------------- #
    # Block qi (spec 7.6)
    # ------------------------------------------------------------- #

    def _read_block_qis(self, b: Bits, coded, nqis: int) -> np.ndarray:
        geo = self.geo
        qi_idx = np.zeros(geo.total_blocks, np.int32)
        if nqis == 1:
            return qi_idx
        coded_list = [bid for bid in geo.coded_order if coded[bid]]
        for pass_i in range(nqis - 1):
            blocks = [bid for bid in coded_list if qi_idx[bid] == pass_i]
            if not blocks:
                break
            flag = b.read1()
            i = 0
            while i < len(blocks):
                run = _read_long_run(b)
                if flag:
                    for bid in blocks[i:i + run]:
                        qi_idx[bid] += 1
                i += run
                if i < len(blocks):
                    flag = b.read1() if run == LONG_RUN_MAX else flag ^ 1
        return qi_idx
