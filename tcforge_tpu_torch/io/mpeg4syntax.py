# Copied from tcforge_tpu/io/mpeg4enc.py lines 1-205 and 211-216 and 278-347 and 390-406 and 783-786 and 838-844; the syntax writer of the MPEG-4 encoder (bit writer, VLC tables, block/MV/DC coding, the FDCT basis, the stream and VOP headers), only the package name in its imports differs.
"""Native MPEG-4 part 2 Simple Profile video ENCODER — the
bridge-free counterpart of io/mpeg4dec.py, closing the last
both-directions gap in the codec tree (the reference encoded
DivX/Xvid via divx4linux/libxvidcore only:
/root/reference/encode/encode_xvid.c, export/export_divx5.c).

Decoder-mirror design (the io/theoraenc.py recipe): the in-loop
reconstruction IS the in-tree decoder's block path — the same H.263
dequantizer (`Mpeg4Decoder._dequant`), the same XVID integer IDCT,
the same half-pel MC and median MV prediction — so encoder state can
never drift from any conforming decoder.  Every VLC table is the
encode-direction inversion of the decoder's (io/_mp4tables.py,
recovered from the public libavcodec archive).

Toolset (always spec-valid, kept deliberately plain):
- I-VOPs: intra MCBPC/CBPY, gradient DC prediction with the intra DC
  VLCs (intra_dc_vlc_thr=0), zigzag RL coding with the type-3
  absolute escape for off-table pairs, H.263 quantizer;
- P-VOPs: not_coded skip, INTER 1MV with median-predicted fcode=1
  vectors (three-step + half-pel ME), INTRA fallback per MB,
  rounding type 0;
- B-VOPs (bframes>0): direct (TRB/TRD-scaled co-located vectors,
  delta 0), forward, backward and interpolated modes at
  fcode_f=fcode_b=1 with per-row MV predictors; modb=1 uncoded-direct
  skip; MBs whose co-located P MB was not_coded emit ZERO bits (the
  decoder synthesizes them — mirroring mpeg4dec._decode_bvop);
  one-group reordering via push()/flush() (coded order: anchor first,
  then the B frames displayed before it);
- one VOS/VO/VOL header block, verid 1, rectangular, 4:2:0.

Validation (tests/test_mpeg4enc.py): every stream decodes through
libavcodec AND the in-tree decoder with identical output, and the
output matches the encoder's own reconstruction bit-exactly.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from tcforge_tpu_torch.io import _mp4tables as T
from tcforge_tpu_torch.io.mpeg4dec import (_ZIG, Mpeg4Decoder, _last_split,
                                     _log2up, idct_add_sel, idct_put)

__all__ = ["Mpeg4NativeEncoder"]


# ------------------------------------------------------------------ #
# Bit writer
# ------------------------------------------------------------------ #

class BitWriter:
    def __init__(self):
        self.buf = bytearray()
        self.acc = 0
        self.nb = 0

    def put(self, val: int, bits: int) -> None:
        acc, nb, buf = self.acc, self.nb, self.buf
        for i in range(bits - 1, -1, -1):
            acc = (acc << 1) | ((val >> i) & 1)
            nb += 1
            if nb == 8:
                buf.append(acc)
                acc = 0
                nb = 0
        self.acc, self.nb = acc, nb

    def stuff(self) -> None:
        """'0' then '1's to the next byte boundary (a full 01111111
        byte when already aligned)."""
        n = 8 - self.nb if self.nb else 8
        self.put((1 << (n - 1)) - 1, n)

    def align_zero(self) -> None:
        if self.nb:
            self.put(0, 8 - self.nb)

    def getvalue(self) -> bytes:
        assert self.nb == 0
        return bytes(self.buf)


# ------------------------------------------------------------------ #
# Encode-direction VLC tables (inversions of the decoder's)
# ------------------------------------------------------------------ #

_MV_CODES = [(T.MVTAB[2 * i], T.MVTAB[2 * i + 1]) for i in range(33)]
_CBPY_CODES = [(T.CBPY[2 * i], T.CBPY[2 * i + 1]) for i in range(16)]
_DC_LUM = [(T.DCTAB_LUM[2 * i], T.DCTAB_LUM[2 * i + 1])
           for i in range(13)]
_DC_CHROM = [(T.DCTAB_CHROM[2 * i], T.DCTAB_CHROM[2 * i + 1])
             for i in range(13)]
# intra MCBPC: (mb_type 3|4, cbpc) -> entry 0-3 / 4-7
_MCBPC_I = {}
for _c in range(4):
    _MCBPC_I[(3, _c)] = (T.INTRA_MCBPC_CODE[_c], T.INTRA_MCBPC_BITS[_c])
    _MCBPC_I[(4, _c)] = (T.INTRA_MCBPC_CODE[4 + _c],
                         T.INTRA_MCBPC_BITS[4 + _c])
# inter MCBPC groups: index = (group << 2) | cbpc
_MCBPC_P_GROUP = {0: 0, 1: 2, 2: 4, 3: 1, 4: 3, 5: 6}
_MCBPC_P = {}
for _t, _g in _MCBPC_P_GROUP.items():
    for _c in range(4):
        _i = (_g << 2) | _c
        _MCBPC_P[(_t, _c)] = (T.INTER_MCBPC_CODE[_i],
                              T.INTER_MCBPC_BITS[_i])


def _rl_codes(vlc, runs, levels):
    """{(last, run, level): (code, bits)} + the escape code."""
    n = len(runs)
    n0 = _last_split(list(runs))
    d = {}
    for i in range(n):
        d[(i >= n0, runs[i], levels[i])] = (vlc[2 * i], vlc[2 * i + 1])
    esc = (vlc[2 * n], vlc[2 * n + 1])
    return d, esc


_RL_INTRA, _ESC_INTRA = _rl_codes(T.MP4_INTRA_VLC, T.MP4_INTRA_RUN,
                                  T.MP4_INTRA_LEVEL)
_RL_INTER, _ESC_INTER = _rl_codes(T.INTER_VLC, T.INTER_RUN,
                                  T.INTER_LEVEL)


def _write_mv(w: BitWriter, delta: int) -> None:
    """One MV component difference at fcode=1 (|delta| <= 32)."""
    sym = abs(delta)
    code, bits = _MV_CODES[sym]
    w.put(code, bits)
    if sym:
        w.put(1 if delta < 0 else 0, 1)


def _write_dc(w: BitWriter, dcd: int, comp: int) -> None:
    size = abs(dcd).bit_length()
    code, bits = (_DC_LUM if comp == 0 else _DC_CHROM)[size]
    w.put(code, bits)
    if size == 0:
        return
    mask = (1 << size) - 1
    v = dcd if dcd > 0 else (abs(dcd) ^ mask)
    w.put(v, size)
    if size > 8:
        w.put(1, 1)                      # marker


def _write_block(w: BitWriter, lv: np.ndarray, intra: bool,
                 first_pos: int) -> None:
    """Raster (8,8) levels -> RL codes in zigzag order; table hits
    with sign bit, type-3 absolute escape otherwise."""
    table, esc = (_RL_INTRA, _ESC_INTRA) if intra \
        else (_RL_INTER, _ESC_INTER)
    zz = lv.reshape(64)[_ZIG][first_pos:]
    nz = np.nonzero(zz)[0]
    assert len(nz), "coded block with no coefficients"
    run = 0
    prev = -1
    for j, p in enumerate(nz):
        run = int(p) - prev - 1
        prev = int(p)
        val = int(zz[p])
        last = j == len(nz) - 1
        hit = table.get((last, run, abs(val)))
        if hit is not None:
            w.put(hit[0], hit[1])
            w.put(1 if val < 0 else 0, 1)
        else:
            w.put(esc[0], esc[1])
            w.put(3, 2)                  # escape type 3
            w.put(1 if last else 0, 1)
            w.put(run, 6)
            w.put(1, 1)                  # marker
            w.put(val & 0xFFF, 12)
            w.put(1, 1)                  # marker


# ------------------------------------------------------------------ #
# Forward DCT + H.263 quantizer
# ------------------------------------------------------------------ #

_DCTM = np.zeros((8, 8))
for _u in range(8):
    for _x in range(8):
        _c = np.sqrt(0.5) if _u == 0 else 1.0
        _DCTM[_u, _x] = 0.5 * _c * np.cos((2 * _x + 1) * _u
                                          * np.pi / 16.0)


def _fdct(block: np.ndarray) -> np.ndarray:
    return _DCTM @ block.astype(np.float64) @ _DCTM.T


def _quant_intra_ac(f: np.ndarray, q: int) -> np.ndarray:
    lv = np.trunc(f / (2.0 * q)).astype(np.int64)
    return np.clip(lv, -2047, 2047)


def _quant_inter(f: np.ndarray, q: int) -> np.ndarray:
    mag = np.trunc((np.abs(f) - q * 0.5) / (2.0 * q))
    lv = (np.sign(f) * np.maximum(mag, 0)).astype(np.int64)
    return np.clip(lv, -2047, 2047)

class Mpeg4NativeEncoder:
    """One coded chunk per frame; stream headers prepended to the
    first.  gop = I-frame interval; qscale = constant quantizer."""

    FCODE = 1                            # MV range +-16 px

    def _headers(self) -> bytes:
        w = BitWriter()
        w.put(0x000001B0, 32)            # VOS
        w.put(0x03, 8)                   # SP@L3
        w.put(0x000001B5, 32)            # visual object
        w.put(0, 1)                      # is_visual_object_identifier
        w.put(1, 4)                      # type: video
        w.put(0, 1)                      # video signal type
        w.stuff()
        w.put(0x00000100, 32)            # video object 0
        w.put(0x00000120, 32)            # VOL 0
        w.put(0, 1)                      # random accessible
        w.put(1, 8)                      # object type: simple
        w.put(0, 1)                      # is_object_layer_identifier
        w.put(1, 4)                      # aspect 1:1
        w.put(1, 1)                      # vol control parameters
        w.put(1, 2)                      # chroma 4:2:0
        w.put(0 if self.bframes else 1, 1)   # low delay
        w.put(0, 1)                      # no vbv parameters
        w.put(0, 2)                      # shape: rectangular
        w.put(1, 1)                      # marker
        w.put(self.time_inc_res, 16)
        w.put(1, 1)                      # marker
        w.put(0, 1)                      # fixed vop rate: no
        w.put(1, 1)                      # marker
        w.put(self.width, 13)
        w.put(1, 1)                      # marker
        w.put(self.height, 13)
        w.put(1, 1)                      # marker
        w.put(0, 1)                      # interlaced: no
        w.put(1, 1)                      # obmc disable
        w.put(0, 1)                      # sprite: none (verid 1)
        w.put(0, 1)                      # not 8 bit: no
        w.put(0, 1)                      # quant type: H.263
        w.put(1, 1)                      # complexity estim. DISABLE
        w.put(1, 1)                      # resync marker disable
        w.put(0, 1)                      # data partitioned: no
        w.put(0, 1)                      # scalability: no
        w.stuff()
        return w.getvalue()

    def _vop_header(self, w: BitWriter, vop_type: int,
                    disp: int) -> None:
        secs, t = divmod(disp, self.time_inc_res)
        w.put(0x000001B6, 32)
        w.put(vop_type, 2)
        if vop_type == 2:
            incr = secs - self._prev_tb
        else:
            incr = secs - self._tb
        assert incr >= 0
        for _ in range(incr):
            w.put(1, 1)                  # modulo time base
        w.put(0, 1)
        if vop_type != 2:
            self._prev_tb = self._tb
            self._tb = secs
        w.put(1, 1)                      # marker
        w.put(t, self.time_inc_bits)
        w.put(1, 1)                      # marker
        w.put(1, 1)                      # vop coded
        if vop_type == 1:
            w.put(0, 1)                  # rounding type 0
        w.put(0, 3)                      # intra_dc_vlc_thr: always DC
        w.put(self.qscale, 5)
        if vop_type in (1, 2):
            w.put(self.FCODE, 3)         # fcode forward
        if vop_type == 2:
            w.put(self.FCODE, 3)         # fcode backward

    def _write_intra_mb(self, w, cbp, entries, in_pvop: bool) -> None:
        cbpc = cbp & 3
        cbpy = (cbp >> 2) & 0xF
        if in_pvop:
            w.put(0, 1)                  # not_coded = 0
            code, bits = _MCBPC_P[(3, cbpc)]
        else:
            code, bits = _MCBPC_I[(3, cbpc)]
        w.put(code, bits)
        w.put(0, 1)                      # ac_pred_flag
        code, bits = _CBPY_CODES[cbpy]
        w.put(code, bits)
        for n, (dcd, lv) in enumerate(entries):
            _write_dc(w, dcd, 0 if n < 4 else 1)
            if (cbp >> (5 - n)) & 1:
                _write_block(w, lv, True, 1)

    # unary mb_type codes (mpeg4dec._MBTYPE_B_LUT direction):
    # direct "1", interpolate "01", backward "001", forward "0001"
    _MBTYPE_B = {0: (1, 1), 1: (1, 2), 2: (1, 3), 3: (1, 4)}

    @staticmethod
    def _wrap_mv(d: int) -> int:
        if d < -32:
            d += 64
        elif d > 31:
            d -= 64
        return d
