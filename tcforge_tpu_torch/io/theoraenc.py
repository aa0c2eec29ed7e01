# Copied from tcforge_tpu/io/theoraenc.py lines 29-281 and 287-289 and 315-410 and 950-1034; the Theora encoder's bit writer, tables, Huffman trees, run writers, headers, plane preparation and flag, mode and motion writers, without the module docstring, the constructor and the encoder's quantizer, DC prediction, token coder, motion search and frame loop, which the port splits between the device and the host's compiled coder (io/theoracodec.py, csrc/theora.cu, csrc/theora_host.cpp).
from __future__ import annotations

import heapq
from typing import Dict, List, Optional, Tuple

import numpy as np

from tcforge_tpu_torch.io import theora as th

__all__ = ["TheoraNativeEncoder"]


# ------------------------------------------------------------------ #
# MSB-first bit writer (mirror of theora.Bits)
# ------------------------------------------------------------------ #

class BitWriter:
    __slots__ = ("buf", "acc", "n")

    def __init__(self):
        self.buf = bytearray()
        self.acc = 0
        self.n = 0

    def write(self, val: int, nbits: int) -> None:
        if nbits == 0:
            return
        self.acc = (self.acc << nbits) | (val & ((1 << nbits) - 1))
        self.n += nbits
        while self.n >= 8:
            self.n -= 8
            self.buf.append((self.acc >> self.n) & 0xFF)
        self.acc &= (1 << self.n) - 1

    def getvalue(self) -> bytes:
        if self.n:
            return bytes(self.buf) + bytes(
                [(self.acc << (8 - self.n)) & 0xFF])
        return bytes(self.buf)


# ------------------------------------------------------------------ #
# Encoder-owned quantizer tables (written into the setup header)
# ------------------------------------------------------------------ #

# Quality scale curves: qi=63 is near-lossless, qi=0 is coarse.
_AC_SCALE = np.maximum(
    1, np.round(560.0 * 0.935 ** np.arange(64))).astype(np.int64)
_DC_SCALE = _AC_SCALE.copy()

# Loop-filter limits: stronger at coarse quantizers, off near
# lossless (the in-tree decoder applies whatever we write, and the
# recon loop runs through it, so any curve is self-consistent).
_LFLIMS = np.clip((63 - np.arange(64)) // 3, 0, 21).astype(np.int64)

# Base matrices (8-bit, raster order): a standard luminance-weighted
# intra matrix, a flatter chroma intra matrix, and a near-flat inter
# matrix (inter residuals are not DC-heavy).
_BM_INTRA_Y = np.array([
    16, 11, 10, 16, 24, 40, 51, 61,
    12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56,
    14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77,
    24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101,
    72, 92, 95, 98, 112, 100, 103, 99], np.int64)
_BM_INTRA_C = np.array([
    17, 18, 24, 47, 99, 99, 99, 99,
    18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99,
    47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99], np.int64)
_BM_INTER = np.full(64, 20, np.int64)
_BM_INTER[0] = 16

# Static token frequency priors per Huffman group (0 = DC, 1..4 = AC
# bands).  These only shape code lengths; any complete tree is valid.
_TOK_FREQ = {
    0: (40, 12, 6, 6, 4, 3, 2, 10, 4, 120, 120, 50, 50, 22, 22, 10,
        10, 9, 7, 5, 3, 2, 1, 20, 10, 6, 4, 3, 3, 2, 5, 3),
    1: (90, 30, 15, 12, 8, 5, 3, 30, 8, 110, 110, 45, 45, 20, 20, 9,
        9, 8, 6, 4, 2, 1, 1, 40, 20, 12, 8, 5, 5, 3, 8, 5),
    2: (140, 40, 20, 16, 10, 6, 4, 30, 8, 90, 90, 35, 35, 15, 15, 7,
        7, 6, 4, 3, 2, 1, 1, 40, 20, 12, 8, 5, 5, 3, 8, 5),
    3: (180, 50, 25, 20, 12, 8, 5, 25, 8, 70, 70, 28, 28, 12, 12, 5,
        5, 4, 3, 2, 1, 1, 1, 35, 18, 10, 7, 4, 4, 3, 6, 4),
    4: (240, 70, 35, 28, 16, 10, 12, 20, 8, 55, 55, 20, 20, 9, 9, 4,
        4, 3, 2, 2, 1, 1, 1, 30, 15, 8, 6, 4, 3, 2, 5, 3),
}


def _huff_code(freqs) -> Dict[int, Tuple[int, int]]:
    """Huffman code over 32 tokens -> {token: (code, len)}; the tree
    shape is emitted into the setup header, so any complete prefix
    code works — this one just biases toward the common tokens."""
    heap = [(f, i, ("leaf", i)) for i, f in enumerate(freqs)]
    heapq.heapify(heap)
    uid = 32
    while len(heap) > 1:
        f1, _, t1 = heapq.heappop(heap)
        f2, _, t2 = heapq.heappop(heap)
        heapq.heappush(heap, (f1 + f2, uid, ("node", t1, t2)))
        uid += 1
    codes: Dict[int, Tuple[int, int]] = {}

    def walk(t, code, ln):
        if t[0] == "leaf":
            codes[t[1]] = (code, ln)
        else:
            walk(t[1], code << 1, ln + 1)
            walk(t[2], (code << 1) | 1, ln + 1)
    walk(heap[0][2], 0, 0)
    assert max(ln for _, ln in codes.values()) <= 16
    return codes


_GROUP_CODES = {g: _huff_code(f) for g, f in _TOK_FREQ.items()}


def _emit_tree(bw: BitWriter, codes: Dict[int, Tuple[int, int]]):
    """Write one Huffman table in the setup-header tree grammar
    (0 = split, 1 + 5-bit token = leaf), mirroring _read_huff_tree."""
    by_code = {(c, ln): tok for tok, (c, ln) in codes.items()}

    def emit(code, ln):
        tok = by_code.get((code, ln))
        if tok is not None:
            bw.write(1, 1)
            bw.write(tok, 5)
        else:
            bw.write(0, 1)
            emit(code << 1, ln + 1)
            emit((code << 1) | 1, ln + 1)
    emit(0, 0)


# Canonical run-length codes (encode side of the decoder's LUTs).
def _canonical_codes(lens) -> List[Tuple[int, int]]:
    out = []
    code32 = 0
    for ln in lens:
        out.append((code32 >> (32 - ln), ln))
        code32 += 1 << (32 - ln)
    return out


_SB_RUN_CODES = _canonical_codes(th._SB_RUN_LENS)
_FRAG_RUN_CODES = _canonical_codes(th._FRAG_RUN_LENS)
_MODE_CODES = _canonical_codes(th._MODE_LENS)

# MV VLC encode table: value (-31..31) -> (code, len), from the
# decoder's canonical (sym, len) order.
_MV_CODES: Dict[int, Tuple[int, int]] = {}
_code32 = 0
for _sym, _ln in th._MV_SYMS_LENS:
    _MV_CODES[_sym - 31] = (_code32 >> (32 - _ln), _ln)
    _code32 += 1 << (32 - _ln)
del _code32, _sym, _ln

# Forward DCT basis: X = 16 * (B r B^T) inverts the spec iDCT's
# y = (C^T X C + 8) >> 4 up to integer truncation (C has the 1/sqrt2
# DC weight folded in; see io/theora.py idct8x8).
_B = np.zeros((8, 8))
for _k in range(8):
    _c = (1.0 / np.sqrt(2.0)) if _k == 0 else 1.0
    for _n in range(8):
        _B[_k, _n] = 0.25 * _c * np.cos((2 * _n + 1) * _k * np.pi / 16)


def _fdct_blocks(resid: np.ndarray) -> np.ndarray:
    """(n, 8, 8) float residuals -> (n, 8, 8) float DCT coefs."""
    return 16.0 * np.einsum("kn,bnm,lm->bkl", _B, resid, _B)


# ------------------------------------------------------------------ #
# Run-length writers (mirrors of the decoder's three flag passes)
# ------------------------------------------------------------------ #

def _runs(vals: np.ndarray) -> List[Tuple[bool, int]]:
    out = []
    i = 0
    n = len(vals)
    while i < n:
        j = i
        while j < n and vals[j] == vals[i]:
            j += 1
        out.append((bool(vals[i]), j - i))
        i = j
    return out


def _write_sb_run(bw: BitWriter, run: int) -> None:
    if run <= 33:
        c, ln = _SB_RUN_CODES[run - 1]
        bw.write(c, ln)
    else:
        c, ln = _SB_RUN_CODES[33]
        bw.write(c, ln)
        bw.write(run - 34, 12)


def _write_long_runs(bw: BitWriter, vals: np.ndarray) -> None:
    """Superblock-flag pass: first flag bit, then runs; implicit
    toggle between runs except after a maximum-length run, which is
    followed by an explicit flag bit (while blocks remain)."""
    runs = _runs(vals)
    if not runs:
        return
    bw.write(1 if runs[0][0] else 0, 1)
    total = len(vals)
    done = 0
    for ri, (flag, ln) in enumerate(runs):
        while ln:
            piece = min(ln, th.LONG_RUN_MAX)
            # a non-max piece is followed by an implicit toggle: it
            # must END the run (piece == remaining)
            if ln > th.LONG_RUN_MAX:
                piece = th.LONG_RUN_MAX
            _write_sb_run(bw, piece)
            ln -= piece
            done += piece
            if done < total and piece == th.LONG_RUN_MAX:
                # explicit flag bit: same value if the run continues,
                # else the next run's value
                nxt = flag if ln else runs[ri + 1][0]
                bw.write(1 if nxt else 0, 1)


def _write_short_runs(bw: BitWriter, vals: np.ndarray) -> None:
    """Block-flag pass within partial superblocks (short runs,
    explicit flag bit after a maximum-length run)."""
    runs = _runs(vals)
    if not runs:
        return
    bw.write(1 if runs[0][0] else 0, 1)
    pieces: List[Tuple[bool, int]] = []
    for flag, ln in runs:
        while ln:
            piece = min(ln, th.SHORT_RUN_MAX)
            if ln > th.SHORT_RUN_MAX:
                piece = th.SHORT_RUN_MAX
            pieces.append((flag, piece))
            ln -= piece
    for pi, (flag, piece) in enumerate(pieces):
        if pi > 0 and pieces[pi - 1][1] == th.SHORT_RUN_MAX:
            bw.write(1 if flag else 0, 1)
        c, ln2 = _FRAG_RUN_CODES[piece - 1]
        bw.write(c, ln2)

class TheoraNativeEncoder:
    """Stateful frame encoder.  encode() returns (packet, is_key)."""

    # ---------------------------------------------------------- #
    # Headers (spec 6.2 / 6.3 / 6.4)
    # ---------------------------------------------------------- #

    def _ident_header(self) -> bytes:
        bw = BitWriter()
        fh = self.fmbh * 16
        bw.write(3, 8)
        bw.write(2, 8)
        bw.write(1, 8)
        bw.write(self.fmbw, 16)
        bw.write(self.fmbh, 16)
        bw.write(self.w, 24)
        bw.write(self.h, 24)
        bw.write(0, 8)                        # pic_x
        # PICY counts from the BOTTOM of the coded frame; choosing
        # frame_h - pic_h puts the picture at display-top (see the
        # decoder's _crop)
        bw.write(fh - self.h, 8)
        bw.write(self.fps[0], 32)
        bw.write(self.fps[1], 32)
        bw.write(self.par[0], 24)
        bw.write(self.par[1], 24)
        bw.write(0, 8)                        # colorspace unspecified
        bw.write(0, 24)                       # nominal bitrate
        bw.write(self.qi, 6)                  # quality hint
        bw.write(self.kfgshift, 5)
        bw.write(0, 2)                        # pixel format 4:2:0
        bw.write(0, 3)                        # reserved
        return b"\x80theora" + bw.getvalue()

    def _comment_header(self) -> bytes:
        vendor = b"tcforge_tpu theora"
        out = b"\x81theora"
        out += len(vendor).to_bytes(4, "little") + vendor
        out += (0).to_bytes(4, "little")      # no user comments
        return out

    def _setup_header(self) -> bytes:
        bw = BitWriter()
        bw.write(5, 3)                        # lflim bits
        for v in _LFLIMS:
            bw.write(int(v), 5)
        bw.write(9, 4)                        # acscale bits - 1
        for v in _AC_SCALE:
            bw.write(int(v), 10)
        bw.write(9, 4)                        # dcscale bits - 1
        for v in _DC_SCALE:
            bw.write(int(v), 10)
        bw.write(2, 9)                        # nbms - 1 = 2
        for bm in (_BM_INTRA_Y, _BM_INTRA_C, _BM_INTER):
            for v in bm:
                bw.write(int(v), 8)
        # quant ranges: one full-range interval per (qti, pli) with
        # both interpolation ends on the same base matrix.
        # (0,0): newqr implied.  ilog(nbms-1)=ilog(2)=2 bmi bits.
        def one_range(bmi):
            bw.write(bmi, 2)
            bw.write(62, th._ilog(62))        # size-1 -> covers 0..63
            bw.write(bmi, 2)
        one_range(0)                          # intra luma
        bw.write(1, 1)                        # (0,1): newqr
        one_range(1)                          # intra chroma
        bw.write(0, 1)                        # (0,2): copy (0,1)
        bw.write(1, 1)                        # (1,0): newqr
        one_range(2)                          # inter (all planes)
        bw.write(0, 1)                        # (1,1): newqr=0
        bw.write(0, 1)                        #        rpqr=0 -> (1,0)
        bw.write(0, 1)                        # (1,2): newqr=0
        bw.write(0, 1)                        #        rpqr=0 -> (1,1)
        # 80 Huffman tables: 5 groups x 16 table slots; every slot in
        # a group carries the same tree (the frame header always
        # selects slot 0 — duplicates keep the table count spec-true)
        for g in range(5):
            for _ in range(16):
                _emit_tree(bw, _GROUP_CODES[g])
        return b"\x82theora" + bw.getvalue()

    # ---------------------------------------------------------- #
    # Plane preparation
    # ---------------------------------------------------------- #

    def _coded_planes(self, y: np.ndarray, u: np.ndarray,
                      v: np.ndarray) -> List[np.ndarray]:
        """Display planes -> full coded-frame planes (edge padding,
        vertical flip: frames are coded bottom-up)."""
        fw, fh = self.fmbw * 16, self.fmbh * 16
        dims = ((fh, fw), (fh // 2, fw // 2), (fh // 2, fw // 2))
        out = []
        for pl, (ph, pw) in zip((y, u, v), dims):
            pl = np.asarray(pl, np.uint8)
            pad = np.pad(pl, ((0, ph - pl.shape[0]),
                              (0, pw - pl.shape[1])), mode="edge")
            out.append(pad[::-1].astype(np.int32))
        return out

    def _write_modes(self, bw: BitWriter, mb_modes: dict,
                     coded: np.ndarray) -> None:
        """Pick the cheapest mode-coding scheme (one of the six
        fixed alphabets, a custom alphabet, or 3-bit CLC) and write
        the per-MB modes for MBs with coded luma."""
        geo = self.geo
        used = [mb_modes[mb] for mb in geo.mb_order
                if mb_modes[mb] >= 0
                and any(coded[bid] for bid in geo.mb_luma[mb])]
        counts = [0] * 8
        for m in used:
            counts[m] += 1
        # custom alphabet: modes by descending frequency
        order = sorted(range(8), key=lambda m: (-counts[m], m))
        custom_rank = [0] * 8
        for r, m in enumerate(order):
            custom_rank[m] = r
        best_scheme, best_cost, best_rank = 0, 24 + sum(
            th._MODE_LENS[custom_rank[m]] for m in used), custom_rank
        for s in range(1, 7):
            alpha = th.MODE_ALPHABETS[s - 1]
            rank = [0] * 8
            for r, m in enumerate(alpha):
                rank[m] = r
            cost = sum(th._MODE_LENS[rank[m]] for m in used)
            if cost < best_cost:
                best_scheme, best_cost, best_rank = s, cost, rank
        if 3 * len(used) < best_cost:
            best_scheme = 7
        bw.write(best_scheme, 3)
        if best_scheme == 0:
            for m in range(8):
                bw.write(best_rank[m], 3)
        for m in used:
            if best_scheme == 7:
                bw.write(m, 3)
            else:
                c, ln = _MODE_CODES[best_rank[m]]
                bw.write(c, ln)

    def _write_motion(self, bw: BitWriter, mb_modes: dict,
                      mb_mvs: dict, coded: np.ndarray) -> None:
        """MV coding-mode bit + the vectors for MODE_MV MBs (LAST /
        LAST2 / NO_MV read nothing)."""
        geo = self.geo
        mvs = [mb_mvs[mb] for mb in geo.mb_order
               if mb_modes[mb] == th.MODE_MV
               and any(coded[bid] for bid in geo.mb_luma[mb])]
        vlc_cost = sum(_MV_CODES[x][1] + _MV_CODES[y][1]
                       for x, y in mvs)
        use_vlc = vlc_cost <= 12 * len(mvs)
        bw.write(0 if use_vlc else 1, 1)       # 0 selects the VLC
        for x, y in mvs:
            for v in (x, y):
                if use_vlc:
                    c, ln = _MV_CODES[v]
                    bw.write(c, ln)
                else:
                    bw.write(abs(v), 5)
                    bw.write(1 if v < 0 else 0, 1)

    def _write_block_flags(self, bw: BitWriter,
                           coded: np.ndarray) -> None:
        """Mirror of the decoder's three-pass flag grammar."""
        geo = self.geo
        nsb = geo.total_sbs
        partial = np.zeros(nsb, bool)
        full = np.zeros(nsb, bool)
        for sb in range(nsb):
            flags = coded[geo.sb_blocks[sb]]
            if flags.all():
                full[sb] = True
            elif flags.any():
                partial[sb] = True
        _write_long_runs(bw, partial)
        rest = np.nonzero(~partial)[0]
        if len(rest):
            _write_long_runs(bw, full[rest])
        psbs = np.nonzero(partial)[0]
        if len(psbs):
            seq = []
            for sb in psbs:
                seq.extend(bool(coded[bid]) for bid in
                           geo.sb_blocks[sb])
            _write_short_runs(bw, np.array(seq, bool))
