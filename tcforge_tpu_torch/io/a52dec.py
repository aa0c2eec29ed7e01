# Copied from tcforge_tpu/io/a52dec.py; only the package name in its imports differs.
"""Native AC-3 (ATSC A/52) audio decoder.

The DVD audio codec: syncframe/BSI parse, 6 audio blocks per frame
(block switch, dither flags, channel coupling, stereo rematrixing,
exponent strategies with D15/D25/D45 grouped decode, the parametric
bit allocation, quantized/grouped mantissas, dynamic range gain),
the 256/512-point TDAC inverse transforms with KBD windowing and
overlap-add.

The reference decoded AC-3 by linking liba52 (import/decode_a52.c);
the bridge path here uses libavcodec.  This is a from-scratch spec
implementation so VOB/DVD audio decodes with no external library.
The fixed spec tables (bit-allocation constants, hearing threshold,
log-add table, band structure, frame sizes) are numeric constants of
the published A/52 spec, recovered from the public libavcodec binary
in this container; validation is SNR-based against the bundled
libavcodec decoder (tests/test_a52.py) — like MPEG audio, A/52
conformance is tolerance-based (real-valued transforms), and
dithered (bap 0) coefficients are decoder-private noise BY DESIGN
(the spec explicitly leaves the dither generator to the
implementation), so those bins are excluded from precise comparison
and crafted dither-free frames carry the exact checks.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

__all__ = ["A52Decoder", "parse_syncinfo", "decode_stream"]


# ------------------------------------------------------------------ #
# Fixed spec tables (see module docstring)
# ------------------------------------------------------------------ #

FAST_GAIN = (128, 256, 384, 512, 640, 768, 896, 1024)
FLOOR_TAB = (752, 688, 624, 560, 496, 368, 240, -2048)  # int16!
DB_PER_BIT = (0, 1792, 2304, 2816)
SLOW_GAIN = (1344, 1240, 1144, 1040)
FAST_DECAY = (63, 83, 103, 123)
SLOW_DECAY = (15, 17, 19, 21)
BAP_TAB = (
    0, 1, 1, 1, 1, 1, 2, 2, 3, 3, 3, 4, 4, 5, 5, 6, 6, 6, 6, 7, 7,
    7, 7, 8, 8, 8, 8, 9, 9, 9, 9, 10, 10, 10, 10, 11, 11, 11, 11,
    12, 12, 12, 12, 13, 13, 13, 13, 14, 14, 14, 14, 14, 14, 14, 14,
    15, 15, 15, 15, 15, 15, 15, 15, 15)
HTH = (
    1232, 1264, 1408, 1232, 1264, 1408, 1088, 1120, 1200, 1024,
    1040, 1104, 992, 992, 1056, 960, 976, 1008, 944, 960, 992, 944,
    944, 976, 928, 944, 960, 928, 928, 944, 928, 928, 944, 928, 928,
    944, 928, 928, 928, 912, 928, 928, 912, 912, 928, 912, 912, 928,
    896, 912, 928, 896, 896, 928, 880, 896, 928, 880, 896, 928, 864,
    880, 912, 864, 880, 912, 848, 864, 912, 848, 864, 912, 832, 848,
    896, 832, 848, 896, 816, 832, 896, 800, 832, 880, 784, 800, 864,
    768, 784, 848, 752, 768, 832, 752, 752, 816, 752, 752, 800, 752,
    752, 784, 768, 752, 768, 784, 768, 752, 832, 800, 752, 912, 848,
    752, 992, 912, 768, 1056, 992, 784, 1120, 1056, 816, 1168, 1104,
    848, 1184, 1184, 960, 1120, 1168, 1040, 1088, 1120, 1136, 1088,
    1088, 1184, 1312, 1152, 1120, 2048, 1584, 1088, 2112, 2112,
    1104, 2112, 2112, 1248)
LOG_ADD = (
    64, 63, 62, 61, 60, 59, 58, 57, 56, 55, 54, 53, 52, 52, 51, 50,
    49, 48, 47, 47, 46, 45, 44, 44, 43, 42, 41, 41, 40, 39, 38, 38,
    37, 36, 36, 35, 35, 34, 33, 33, 32, 32, 31, 30, 30, 29, 29, 28,
    28, 27, 27, 26, 26, 25, 25, 24, 24, 23, 23, 22, 22, 21, 21, 21,
    20, 20, 19, 19, 19, 18, 18, 18, 17, 17, 17, 16, 16, 16, 15, 15,
    15, 14, 14, 14, 13, 13, 13, 13, 12, 12, 12, 12, 11, 11, 11, 11,
    10, 10, 10, 10, 10, 9, 9, 9, 9, 9, 8, 8, 8, 8, 8, 8, 7, 7, 7, 7,
    7, 7, 6, 6, 6, 6, 6, 6, 6, 6, 5, 5, 5, 5, 5, 5, 5, 5, 4, 4, 4,
    4, 4, 4, 4, 4, 4, 4, 4, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3,
    3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0)
MASK_TAB = tuple(
    list(range(28)) + [28] * 3 + [29] * 3 + [30] * 3 + [31] * 3
    + [32] * 3 + [33] * 3 + [34] * 3 + [35] * 6 + [36] * 6
    + [37] * 6 + [38] * 6 + [39] * 6 + [40] * 6 + [41] * 12
    + [42] * 12 + [43] * 12 + [44] * 12 + [45] * 24 + [46] * 24
    + [47] * 24 + [48] * 24 + [49] * 24)
BAND_START = (
    0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17,
    18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 31, 34, 37, 40, 43,
    46, 49, 55, 61, 67, 73, 79, 85, 97, 109, 121, 133, 157, 181,
    205, 229, 253)
# frame sizes in 16-bit words, [frmsizecod][fscod] row-major
FRAME_SIZES = (
    64, 69, 96, 64, 70, 96, 80, 87, 120, 80, 88, 120, 96, 104, 144,
    96, 105, 144, 112, 121, 168, 112, 122, 168, 128, 139, 192, 128,
    140, 192, 160, 174, 240, 160, 175, 240, 192, 208, 288, 192, 209,
    288, 224, 243, 336, 224, 244, 336, 256, 278, 384, 256, 279, 384,
    320, 348, 480, 320, 349, 480, 384, 417, 576, 384, 418, 576, 448,
    487, 672, 448, 488, 672, 512, 557, 768, 512, 558, 768, 640, 696,
    960, 640, 697, 960, 768, 835, 1152, 768, 836, 1152, 896, 975,
    1344, 896, 976, 1344, 1024, 1114, 1536, 1024, 1115, 1536, 1152,
    1253, 1728, 1152, 1254, 1728, 1280, 1393, 1920, 1280, 1394,
    1920)
SAMPLE_RATES = (48000, 44100, 32000)
ACMOD_CH = (2, 1, 2, 3, 3, 4, 4, 5)      # full-bandwidth channels
QNTZ_BITS = (0, 0, 0, 3, 0, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16)


class Bits:
    __slots__ = ("words", "pos", "nbits")

    def __init__(self, data: bytes):
        pad = data + b"\x00" * 8
        self.words = np.frombuffer(
            pad[:len(pad) // 4 * 4], ">u4").tolist()
        self.pos = 0
        self.nbits = 8 * len(data)

    def read(self, n: int) -> int:
        p = self.pos
        self.pos = p + n
        if p >= self.nbits:
            return 0
        i = p >> 5
        w = (self.words[i] << 32) | self.words[i + 1]
        return (w >> (64 - (p & 31) - n)) & ((1 << n) - 1)

    def sread(self, n: int) -> int:
        v = self.read(n)
        return v - (1 << n) if v & (1 << (n - 1)) else v


def parse_syncinfo(buf: bytes) -> Optional[Tuple[int, int, int]]:
    """(frame_bytes, sample_rate, frmsizecod) or None."""
    if len(buf) < 5 or buf[0] != 0x0B or buf[1] != 0x77:
        return None
    fscod = buf[4] >> 6
    frmsizecod = buf[4] & 0x3F
    if fscod == 3 or frmsizecod > 37:
        return None
    words = FRAME_SIZES[frmsizecod * 3 + fscod]
    return 2 * words, SAMPLE_RATES[fscod], frmsizecod


# ------------------------------------------------------------------ #
# Windows and inverse transforms
# ------------------------------------------------------------------ #

def _kbd_window(n: int = 256, alpha: float = 5.0) -> np.ndarray:
    k = np.arange(n + 1)
    kais = np.i0(np.pi * alpha * np.sqrt(
        np.clip(1.0 - (2.0 * k / n - 1.0) ** 2, 0.0, 1.0)))
    csum = np.cumsum(kais)
    return np.sqrt(csum[:n] / csum[n])


_WIN512 = None                            # (512,) built lazily


def _win512() -> np.ndarray:
    global _WIN512
    if _WIN512 is None:
        w = _kbd_window()
        _WIN512 = np.concatenate((w, w[::-1]))
    return _WIN512


def _imdct_mat(nc: int) -> np.ndarray:
    """A/52 TDAC inverse: nc coefficients -> 2*nc samples,
    y[n] = -2 * sum_k X[k] cos(pi/(4 nc) (2n+1+nc)(2k+1)).
    Sign, phase offset and scale were resolved against the oracle
    (a variant sweep reached 78 dB only for this form)."""
    n2 = 2 * nc
    n_ = np.arange(n2)[:, None]
    k = np.arange(nc)[None, :]
    return -2.0 * np.cos(
        np.pi / (4 * nc) * (2 * n_ + 1 + nc) * (2 * k + 1))


_IM512 = _imdct_mat(256)
_IM256 = _imdct_mat(128)


# ------------------------------------------------------------------ #
# Exponent decode (7.1.3)
# ------------------------------------------------------------------ #

def _decode_exps(b: Bits, expstr: int, ngrps: int, absexp: int,
                 first_bin_is_abs: bool) -> List[int]:
    """Returns the exponent list starting at the strategy's first
    bin.  expstr: 1=D15, 2=D25, 3=D45 (group sizes 1/2/4)."""
    gs = (0, 1, 2, 4)[expstr]
    exps = [absexp] if first_bin_is_abs else []
    pre = absexp
    for _ in range(ngrps):
        g = b.read(7)
        for d in (g // 25, (g % 25) // 5, g % 5):
            pre += d - 2
            exps.extend([pre] * gs)
    return exps


# ------------------------------------------------------------------ #
# Bit allocation (7.2.2 / 7.3, in the extracted tables' scaling)
# ------------------------------------------------------------------ #

def _logadd(a: int, c: int) -> int:
    d = a - c
    addr = min(abs(d) >> 1, 255)
    return (a if d >= 0 else c) + LOG_ADD[addr]


def _lowcomp(a: int, b0: int, b1: int, binno: int) -> int:
    if binno < 7:
        if b0 + 256 == b1:
            return 384
        if b0 > b1:
            return max(0, a - 64)
        return a
    if binno < 20:
        if b0 + 256 == b1:
            return 320
        if b0 > b1:
            return max(0, a - 64)
        return a
    return max(0, a - 128)


def _bit_alloc(exps: List[int], start: int, end: int, fscod: int,
               snroffset: int, fgain: int, prm,
               cpl_leak: Optional[Tuple[int, int]] = None
               ) -> List[int]:
    """exps: absolute exponents for bins start..end (list index 0 is
    bin `start`).  Returns bap per bin (same indexing)."""
    n = end - start
    psd = [3072 - (e << 7) for e in exps]
    # band integration
    bndstrt = MASK_TAB[start]
    bndend = MASK_TAB[end - 1] + 1
    bndpsd = [0] * 50
    j = 0
    for band in range(bndstrt, bndend):
        lo = max(BAND_START[band], start)
        hi = min(BAND_START[band + 1] if band + 1 < len(BAND_START)
                 else 253, end)
        v = psd[lo - start]
        for k in range(lo + 1, hi):
            v = _logadd(v, psd[k - start])
        bndpsd[band] = v

    excite = [0] * 50
    if bndstrt == 0:                     # full-bandwidth channel
        lowcomp = 0
        lowcomp = _lowcomp(lowcomp, bndpsd[0], bndpsd[1], 0)
        excite[0] = bndpsd[0] - fgain - lowcomp
        lowcomp = _lowcomp(lowcomp, bndpsd[1], bndpsd[2], 1)
        excite[1] = bndpsd[1] - fgain - lowcomp
        begin = 7
        fastleak = slowleak = 0
        for bin_ in range(2, 7):
            if not (bndend == 7 and bin_ == 6):
                lowcomp = _lowcomp(lowcomp, bndpsd[bin_],
                                   bndpsd[bin_ + 1], bin_)
            fastleak = bndpsd[bin_] - fgain
            slowleak = bndpsd[bin_] - prm.sgain
            excite[bin_] = fastleak - lowcomp
            if not (bndend == 7 and bin_ == 6):
                if bndpsd[bin_] <= bndpsd[bin_ + 1]:
                    begin = bin_ + 1
                    break
        for bin_ in range(begin, min(bndend, 22)):
            if not (bndend == 7 and bin_ == 6):
                lowcomp = _lowcomp(lowcomp, bndpsd[bin_],
                                   bndpsd[bin_ + 1], bin_)
            fastleak -= prm.fdcy
            fastleak = max(fastleak, bndpsd[bin_] - fgain)
            slowleak -= prm.sdcy
            slowleak = max(slowleak, bndpsd[bin_] - prm.sgain)
            excite[bin_] = max(fastleak - lowcomp, slowleak)
        begin = 22
    else:                                # coupling channel
        begin = bndstrt
        fastleak, slowleak = cpl_leak

    for bin_ in range(begin, bndend):
        fastleak -= prm.fdcy
        fastleak = max(fastleak, bndpsd[bin_] - fgain)
        slowleak -= prm.sdcy
        slowleak = max(slowleak, bndpsd[bin_] - prm.sgain)
        excite[bin_] = max(fastleak, slowleak)

    mask = [0] * 50
    for bin_ in range(bndstrt, bndend):
        if bndpsd[bin_] < prm.dbknee:
            excite[bin_] += (prm.dbknee - bndpsd[bin_]) >> 2
        mask[bin_] = max(excite[bin_], HTH[bin_ * 3 + fscod])

    bap = [0] * n
    i = start
    for band in range(bndstrt, bndend):
        m = mask[band]
        m -= snroffset
        m -= prm.floor
        if m < 0:
            m = 0
        m &= 0x1FE0
        m += prm.floor
        hi = min(BAND_START[band + 1] if band + 1 < len(BAND_START)
                 else 253, end)
        while i < hi:
            addr = min(max((psd[i - start] - m) >> 5, 0), 63)
            bap[i - start] = BAP_TAB[addr]
            i += 1
    return bap


# ------------------------------------------------------------------ #
# Mantissas (7.3.3)
# ------------------------------------------------------------------ #

class _GroupState:
    __slots__ = ("b1", "b1v", "b2", "b2v", "b4", "b4v")

    def __init__(self):
        self.b1 = self.b2 = self.b4 = 0
        self.b1v = self.b2v = self.b4v = (0.0, 0.0, 0.0)


def _read_mantissas(b: Bits, bap: List[int], exps: List[int],
                    grp: _GroupState, dither: bool,
                    dec: "A52Decoder" = None) -> np.ndarray:
    out = np.zeros(len(bap))
    dvals = None
    if dither and dec is not None and dec.dither:
        n0 = sum(1 for bp in bap if bp == 0)
        dvals = dec._dither_vals(n0) if n0 else None
    di = 0
    for i, bp in enumerate(bap):
        if bp == 0:
            # dither is decoder-private noise (spec 7.3.4): ours is a
            # 16-bit LFSR at the recommended -4.75 dB level; disabled
            # for oracle comparisons
            if dvals is not None:
                m = dvals[di]
                di += 1
            else:
                m = 0.0
        elif bp == 1:
            if grp.b1 == 0:
                c = b.read(5)
                grp.b1v = ((2 * (c // 9) - 2) / 3.0,
                           (2 * ((c % 9) // 3) - 2) / 3.0,
                           (2 * (c % 3) - 2) / 3.0)
                grp.b1 = 3
            m = grp.b1v[3 - grp.b1]
            grp.b1 -= 1
        elif bp == 2:
            if grp.b2 == 0:
                c = b.read(7)
                grp.b2v = ((2 * (c // 25) - 4) / 5.0,
                           (2 * ((c % 25) // 5) - 4) / 5.0,
                           (2 * (c % 5) - 4) / 5.0)
                grp.b2 = 3
            m = grp.b2v[3 - grp.b2]
            grp.b2 -= 1
        elif bp == 3:
            m = (2 * b.read(3) - 6) / 7.0
        elif bp == 4:
            if grp.b4 == 0:
                c = b.read(7)
                grp.b4v = ((2 * (c // 11) - 10) / 11.0,
                           (2 * (c % 11) - 10) / 11.0, 0.0)
                grp.b4 = 2
            m = grp.b4v[2 - grp.b4]
            grp.b4 -= 1
        elif bp == 5:
            m = (2 * b.read(4) - 14) / 15.0
        else:
            nb = QNTZ_BITS[bp]
            m = b.sread(nb) / float(1 << (nb - 1))
        out[i] = m * 2.0 ** (-exps[i])
    return out


# ------------------------------------------------------------------ #
# The decoder
# ------------------------------------------------------------------ #

class _Frame:
    """Per-frame state that persists across the 6 audio blocks."""

    def __init__(self, nfch, lfeon, acmod, fscod):
        self.nfch = nfch
        self.lfeon = lfeon
        self.acmod = acmod
        self.fscod = fscod
        self.cplinu = 0
        self.chincpl = [0] * nfch
        self.phsflginu = 0
        self.phsflg: List[int] = []
        self.cplbndstrc: List[int] = []
        self.cplstrtmant = 0
        self.cplendmant = 0
        self.cplcos = {}
        self.rematflg: List[int] = []
        self.exps = [None] * nfch
        self.cplexps = None
        self.lfeexps = None
        self.endmant = [0] * nfch
        self.bap = [None] * nfch
        self.cplbap = None
        self.lfebap = None
        # bit allocation parameters (defaults never used: block 0
        # must transmit baie per the spec)
        self.sdcy = SLOW_DECAY[0]
        self.fdcy = FAST_DECAY[0]
        self.sgain = SLOW_GAIN[0]
        self.dbknee = DB_PER_BIT[0]
        self.floor = FLOOR_TAB[0]
        self.snroff = [0] * nfch
        self.fgain = [FAST_GAIN[0]] * nfch
        self.cplsnr = 0
        self.cplfgain = FAST_GAIN[0]
        self.lfesnr = 0
        self.lfefgain = FAST_GAIN[0]
        self.cplfleak = 0
        self.cplsleak = 0
        self.dynrng_gain = None


class A52Decoder:
    """Stateful frame decoder (the overlap-add delay carries across
    frames).  ``dither=False`` zeroes bap-0 mantissas instead of
    injecting noise — dither is implementation-defined by the spec
    (7.3.4), so oracle comparisons run with it off."""

    def __init__(self, dither: bool = True):
        self._delay: Optional[np.ndarray] = None
        self.sample_rate = 0
        self.channels = 0
        self.dither = dither
        self._lfsr = 1                    # x^16+x^15+x^13+x^4 LFSR

    def _dither_vals(self, n: int) -> np.ndarray:
        out = np.empty(n)
        st = self._lfsr
        for i in range(n):
            bit = ((st >> 15) ^ (st >> 14) ^ (st >> 12) ^ (st >> 3)) & 1
            st = ((st << 1) | bit) & 0xFFFF
            out[i] = st - 32768
        self._lfsr = st
        return out * (0.707106781 / 32768.0)

    def decode_frame(self, frame: bytes) -> Optional[np.ndarray]:
        si = parse_syncinfo(frame)
        if si is None:
            return None
        _, rate, _ = si
        fscod = frame[4] >> 6
        b = Bits(frame)
        b.pos = 40
        bsid = b.read(5)
        if bsid > 8:
            raise NotImplementedError(
                f"a52: bsid {bsid} beyond AC-3 (E-AC-3 not wired)")
        b.read(3)                        # bsmod
        acmod = b.read(3)
        if acmod == 0:
            raise NotImplementedError("a52: 1+1 dual mono not wired")
        if (acmod & 1) and acmod != 1:
            b.read(2)                    # cmixlev
        if acmod & 4:
            b.read(2)                    # surmixlev
        if acmod == 2:
            b.read(2)                    # dsurmod
        lfeon = b.read(1)
        b.read(5)                        # dialnorm
        if b.read(1):
            b.read(8)                    # compr
        if b.read(1):
            b.read(8)                    # langcod
        if b.read(1):
            b.read(7)                    # mixlevel + roomtyp
        b.read(1)                        # copyrightb
        b.read(1)                        # origbs
        if b.read(1):
            b.read(14)                   # timecod1
        if b.read(1):
            b.read(14)                   # timecod2
        if b.read(1):                    # addbsie
            n = b.read(6)
            for _ in range(n + 1):
                b.read(8)
        nfch = ACMOD_CH[acmod]
        nch = nfch + lfeon
        self.sample_rate = rate
        self.channels = nch
        if self._delay is None or self._delay.shape[0] != nch:
            self._delay = np.zeros((nch, 256))
        fr = _Frame(nfch, lfeon, acmod, fscod)
        out = np.zeros((1536, nch))
        for blk in range(6):
            pcm = self._block(b, fr)
            out[256 * blk:256 * blk + 256] = pcm.T
        return _to_i16(out)

    # -------------------------------------------------------------- #

    def _block(self, b: Bits, fr: _Frame) -> np.ndarray:
        nfch, lfeon, acmod = fr.nfch, fr.lfeon, fr.acmod
        nch = nfch + lfeon
        blksw = [b.read(1) for _ in range(nfch)]
        dithflag = [b.read(1) for _ in range(nfch)]
        if b.read(1):                     # dynrnge
            v = b.read(8)
            e = v >> 5
            if e >= 4:
                e -= 8
            fr.dynrng_gain = (2.0 ** e) * ((v & 0x1F) | 0x20) / 64.0

        if b.read(1):                     # cplstre
            fr.cplinu = b.read(1)
            if fr.cplinu:
                fr.chincpl = [b.read(1) for _ in range(nfch)]
                if acmod == 2:
                    fr.phsflginu = b.read(1)
                cplbegf = b.read(4)
                cplendf = b.read(4)
                fr.cplstrtmant = 37 + 12 * cplbegf
                fr.cplendmant = 37 + 12 * (cplendf + 3)
                ncplsubnd = 3 + cplendf - cplbegf
                fr.cplbndstrc = [0] + [b.read(1)
                                       for _ in range(ncplsubnd - 1)]
        if fr.cplinu:
            cplcoe = [0] * nfch
            ncplbnd = len(fr.cplbndstrc) - sum(fr.cplbndstrc)
            for ch in range(nfch):
                if not fr.chincpl[ch]:
                    continue
                cplcoe[ch] = b.read(1)
                if cplcoe[ch]:
                    mstr = b.read(2)
                    cos_ = []
                    for _bnd in range(ncplbnd):
                        cexp = b.read(4)
                        cmant = b.read(4)
                        if cexp == 15:
                            cm = cmant / 16.0
                        else:
                            cm = (cmant + 16) / 32.0
                        # the *8: cplco is transmitted scaled down by
                        # 8 to widen its range (A/52 7.4.3); probed
                        # exactly vs the oracle (crafted single-
                        # mantissa frames: ratio 0.125 without it)
                        cos_.append(cm * 2.0 ** (3 - cexp - 3 * mstr))
                    fr.cplcos[ch] = cos_
            if acmod == 2 and fr.phsflginu and (cplcoe[0]
                                                or cplcoe[1]):
                fr.phsflg = [b.read(1) for _ in range(ncplbnd)]

        if acmod == 2 and b.read(1):      # rematstr
            if fr.cplinu:
                if fr.cplstrtmant == 37:
                    nbnd = 2
                elif fr.cplstrtmant > 61:
                    nbnd = 4
                else:
                    nbnd = 3
            else:
                nbnd = 4
            fr.rematflg = [b.read(1) for _ in range(nbnd)]

        cplexpstr = b.read(2) if fr.cplinu else 0
        chexpstr = [b.read(2) for _ in range(nfch)]
        lfeexpstr = b.read(1) if lfeon else 0
        for ch in range(nfch):
            if fr.cplinu and fr.chincpl[ch]:
                fr.endmant[ch] = fr.cplstrtmant
            elif chexpstr[ch] != 0:
                fr.endmant[ch] = (b.read(6) + 12) * 3 + 37

        if fr.cplinu and cplexpstr != 0:
            gs = (0, 1, 2, 4)[cplexpstr]
            ncplgrps = (fr.cplendmant - fr.cplstrtmant) // (3 * gs)
            absexp = b.read(4) << 1       # cplabsexp
            fr.cplexps = _decode_exps(b, cplexpstr, ncplgrps,
                                      absexp, False)
        for ch in range(nfch):
            if chexpstr[ch] != 0:
                gs = (0, 1, 2, 4)[chexpstr[ch]]
                nm = fr.endmant[ch]
                ngrps = (nm + 3 * gs - 4) // (3 * gs)
                absexp = b.read(4)
                fr.exps[ch] = _decode_exps(b, chexpstr[ch], ngrps,
                                           absexp, True)[:nm]
                b.read(2)                 # gainrng
        if lfeon and lfeexpstr != 0:
            absexp = b.read(4)
            fr.lfeexps = _decode_exps(b, 1, 2, absexp, True)[:7]

        if b.read(1):                     # baie
            fr.sdcy = SLOW_DECAY[b.read(2)]
            fr.fdcy = FAST_DECAY[b.read(2)]
            fr.sgain = SLOW_GAIN[b.read(2)]
            fr.dbknee = DB_PER_BIT[b.read(2)]
            fr.floor = FLOOR_TAB[b.read(3)]
        if b.read(1):                     # snroffste
            csnr = b.read(6)
            if fr.cplinu:
                fr.cplsnr = (((csnr - 15) << 4) + b.read(4)) << 2
                fr.cplfgain = FAST_GAIN[b.read(3)]
            for ch in range(nfch):
                fr.snroff[ch] = (((csnr - 15) << 4) + b.read(4)) << 2
                fr.fgain[ch] = FAST_GAIN[b.read(3)]
            if lfeon:
                fr.lfesnr = (((csnr - 15) << 4) + b.read(4)) << 2
                fr.lfefgain = FAST_GAIN[b.read(3)]
        if fr.cplinu and b.read(1):       # cplleake
            fr.cplfleak = (b.read(3) << 8) + 768
            fr.cplsleak = (b.read(3) << 8) + 768

        if b.read(1):                     # deltbaie
            raise NotImplementedError(
                "a52: delta bit allocation not implemented "
                "(rare; no encoder in this container emits it)")

        if b.read(1):                     # skiple
            n = b.read(9)
            for _ in range(n):
                b.read(8)

        if fr.cplinu:
            fr.cplbap = _bit_alloc(
                fr.cplexps, fr.cplstrtmant, fr.cplendmant,
                fr.fscod, fr.cplsnr, fr.cplfgain, fr,
                cpl_leak=(fr.cplfleak, fr.cplsleak))
        for ch in range(nfch):
            fr.bap[ch] = _bit_alloc(fr.exps[ch], 0, fr.endmant[ch],
                                    fr.fscod, fr.snroff[ch],
                                    fr.fgain[ch], fr)
        if lfeon:
            fr.lfebap = _bit_alloc(fr.lfeexps, 0, 7, fr.fscod,
                                   fr.lfesnr, fr.lfefgain, fr)

        grp = _GroupState()
        coeffs = np.zeros((nch, 256))
        cplcoeff = None
        for ch in range(nfch):
            nm = fr.endmant[ch]
            coeffs[ch, :nm] = _read_mantissas(
                b, fr.bap[ch], fr.exps[ch], grp, dithflag[ch],
                dec=self)
            if fr.cplinu and fr.chincpl[ch] and cplcoeff is None:
                cm = _read_mantissas(b, fr.cplbap, fr.cplexps, grp,
                                     False)
                cplcoeff = np.zeros(256)
                cplcoeff[fr.cplstrtmant:fr.cplendmant] = cm
        if lfeon:
            coeffs[nfch, :7] = _read_mantissas(
                b, fr.lfebap, fr.lfeexps, grp, False)

        if fr.cplinu and cplcoeff is not None:
            bnd_bins = _cpl_band_bins(fr)
            # coupled bap-0 bins take PER-CHANNEL dither at the
            # coupling channel's envelope (7.3.4: the substitution
            # happens in each coupled channel's reconstruction, so
            # each channel gets independent noise)
            strt = fr.cplstrtmant
            bap0 = np.asarray(fr.cplbap) == 0
            n0 = int(bap0.sum())
            cplexp_sc = 2.0 ** -np.asarray(fr.cplexps, float)
            for ch in range(nfch):
                if not fr.chincpl[ch] or ch not in fr.cplcos:
                    continue
                chcpl = cplcoeff
                if self.dither and dithflag[ch] and n0:
                    chcpl = cplcoeff.copy()
                    dv = self._dither_vals(n0) * cplexp_sc[bap0]
                    chcpl[strt:fr.cplendmant][bap0] = dv
                cos_ = fr.cplcos[ch]
                for bi, (lo, hi) in enumerate(bnd_bins):
                    seg = chcpl[lo:hi] * cos_[bi]
                    if (acmod == 2 and ch == 1 and fr.phsflginu
                            and fr.phsflg and fr.phsflg[bi]):
                        seg = -seg
                    coeffs[ch, lo:hi] = seg

        if acmod == 2 and fr.rematflg:
            end = fr.cplstrtmant if fr.cplinu else 253
            bnds = ((13, 25), (25, 37), (37, 61), (61, 253))
            for bi, flag in enumerate(fr.rematflg):
                if not flag:
                    continue
                lo, hi = bnds[bi]
                hi = min(hi, end, max(fr.endmant))
                if lo >= hi:
                    continue
                a = coeffs[0, lo:hi].copy()
                b2 = coeffs[1, lo:hi].copy()
                coeffs[0, lo:hi] = a + b2
                coeffs[1, lo:hi] = a - b2

        if fr.dynrng_gain is not None:
            coeffs *= fr.dynrng_gain

        win = _win512()
        pcm = np.zeros((nch, 256))
        for ch in range(nch):
            if ch < nfch and blksw[ch]:
                x = _imdct_short(coeffs[ch])
            else:
                x = _IM512 @ coeffs[ch]
            wx = x * win
            pcm[ch] = wx[:256] + self._delay[ch]
            self._delay[ch] = wx[256:]
        return pcm


def _imdct_short(coefs: np.ndarray) -> np.ndarray:
    """Block-switched transform: two 128-coefficient transforms on
    the even/odd coefficients (A/52 7.9.4.2); each yields 256
    samples, occupying the first/second half of the 512 window.
    NOTE: the bundled libavcodec ENCODER never emits blksw, so this
    path is spec-derived but not oracle-validated."""
    x1 = _IM256 @ coefs[0::2]
    x2 = _IM256 @ coefs[1::2]
    return np.concatenate((x1, x2))


def _cpl_band_bins(fr: "_Frame") -> List[Tuple[int, int]]:
    """Coupling band -> (lo, hi) mantissa bins, honoring the band
    structure merges."""
    bins = []
    sub_lo = fr.cplstrtmant
    for i, merge in enumerate(fr.cplbndstrc):
        if i == 0 or not merge:
            bins.append([sub_lo, sub_lo + 12])
        else:
            bins[-1][1] += 12
        sub_lo += 12
    return [(lo, hi) for lo, hi in bins]


def _to_i16(x: np.ndarray) -> np.ndarray:
    return np.clip(np.rint(x * 32768.0), -32768, 32767).astype(np.int16)


def decode_stream(data: bytes, dither: bool = True
                  ) -> Tuple[np.ndarray, int, int]:
    """Whole AC-3 elementary stream -> (pcm (S, C) int16, rate,
    channels); resyncs on garbage."""
    dec = A52Decoder(dither=dither)
    chunks = []
    pos = 0
    n = len(data)
    while pos + 8 <= n:
        si = parse_syncinfo(data[pos:pos + 8])
        if si is None:
            pos += 1
            continue
        nbytes = si[0]
        if pos + nbytes > n:
            break
        pcm = dec.decode_frame(data[pos:pos + nbytes])
        if pcm is not None:
            chunks.append(pcm)
        pos += nbytes
    if not chunks:
        raise ValueError("a52: no decodable frames")
    return np.concatenate(chunks), dec.sample_rate, dec.channels


class StreamDecoder:
    """AvAudioDecoder-shaped streaming wrapper (feed/flush/read/rate/
    channels/close) so importers can fall back to the native AC-3
    decoder when the FFmpeg bridge is absent."""

    def __init__(self, dither: bool = True):
        self._dec = A52Decoder(dither=dither)
        self._buf = b""
        self._out: List[np.ndarray] = []
        self.rate = 0
        self.channels = 0

    def feed(self, data: bytes) -> None:
        self._buf += data
        self._drain()

    def flush(self) -> None:
        self._drain()

    def _drain(self) -> None:
        buf = self._buf
        pos = 0
        n = len(buf)
        while pos + 8 <= n:
            si = parse_syncinfo(buf[pos:pos + 8])
            if si is None:
                pos += 1
                continue
            if pos + si[0] > n:
                break                  # wait for the rest
            pcm = self._dec.decode_frame(buf[pos:pos + si[0]])
            if pcm is not None:
                self._out.append(pcm)
                self.rate = self._dec.sample_rate
                self.channels = self._dec.channels
            pos += si[0]
        self._buf = buf[pos:]

    def read(self, max_samples: int = 1 << 18):
        if not self._out:
            return None
        out = np.concatenate(self._out)
        self._out = []
        return out

    def close(self) -> None:
        self._buf = b""
        self._out = []
