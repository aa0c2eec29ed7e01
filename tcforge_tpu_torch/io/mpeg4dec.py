# Copied from tcforge_tpu/io/mpeg4dec.py lines 1-55 and 57-2791; without its unused io/dvdec.py import, and only the package name in its imports differs.
"""Native MPEG-4 part 2 (Simple / Advanced Simple profile) video
decoder — the DivX/Xvid bitstreams that were transcode's flagship
use case.

The reference decodes these through external libraries
(/root/reference/import/import_ffmpeg.c, import_divx.c hand frames
to libavcodec/divx4linux) — there is no in-tree decoder to port.
This is a from-scratch implementation of the rectangular-VOP layer:

- VOS/VO/VOL/GOP/VOP header parse (time bases, quant type, fcodes);
- I-VOP: intra MCBPC, AC prediction flag, CBPY, DQUANT, DC
  prediction by horizontal/vertical gradient with dc_scale rounding,
  the intra DC VLC threshold, first row/column AC prediction with
  the alternate scans, both dequantizers (H.263-style second kind
  and MPEG-style first kind with matrices);
- P-VOP: not_coded skip, inter MCBPC, 1MV/4MV with median
  prediction and f_code range wrapping, half-pel MC with the VOP
  rounding type, edge-padded unrestricted vectors, chroma vectors by
  the /2 (1MV) and sum/8 (4MV) rounding tables;
- B-VOP: direct mode (per-block TRB/TRD scaling of the co-located
  future-P vectors, C truncating division, skip-with-no-bits when
  the co-located MB was skipped), forward/backward/interpolated
  modes with per-row MV predictors, DBQUANT, and the one-frame
  display reorder (decode_frames can yield two frames for Xvid
  packed-bitstream chunks; flush() emits the held-back tail);
- quarter-pel mode (the ASP flagship tool): 8-tap mirrored-block
  interpolation with the horizontal-first stage order and the
  per-block truncated-halve chroma sums — every one of the 16
  phases, both rounding types, and the chroma derivations were
  measured empirically with crafted constant-MV/no-residual probe
  streams through libavcodec (naive whole-frame filtering diverges
  at every block boundary; trunc-of-sum chroma diverges when block
  parities differ);
- the exact integer IDCT shared with io/dvdec.py (the standard
  "simple" transform the reference decoder family computes).

Entropy/quantizer tables live in io/_mp4tables.py, recovered from
the public libavcodec archive (the method documented in io/dvdec.py);
every decode path is validated BIT-EXACT against the bundled
libavcodec decoder (tests/test_mpeg4dec.py).

Honest gates (raise, never guess): OBMC, RVLC texture, STATIC
sprites, non-4:2:0 shapes.  Data partitioning decodes natively
(partition A/B + DC/MOTION markers, r5).  Short video headers (H.263
baseline flavor), interlaced streams, and GMC S-VOPs (1/2/3
warping points, bit-exact at accuracy 3) decode natively (r4/r5).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from tcforge_tpu_torch.io import _mp4tables as T

__all__ = ["Mpeg4Decoder"]


# ------------------------------------------------------------------ #
# Bit reader (MSB-first over the whole VOP payload)
# ------------------------------------------------------------------ #

class Bits:
    __slots__ = ("data", "pos", "n")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.n = 8 * len(data)

    def read(self, k: int) -> int:
        v = 0
        d = self.data
        p = self.pos
        for _ in range(k):
            v = (v << 1) | ((d[p >> 3] >> (7 - (p & 7))) & 1)
            p += 1
        self.pos = p
        return v

    def read1(self) -> int:
        p = self.pos
        self.pos = p + 1
        return (self.data[p >> 3] >> (7 - (p & 7))) & 1

    def peek(self, k: int) -> int:
        p = self.pos
        v = self.read(k)
        self.pos = p
        return v

    @property
    def left(self) -> int:
        return self.n - self.pos


def _peek12(b: Bits) -> int:
    if b.left >= 12:
        return b.peek(12)
    if b.left <= 0:
        raise ValueError("mpeg4: bitstream exhausted")
    return b.peek(b.left) << (12 - b.left)


def _vlc_lut(pairs, syms, maxbits):
    """(code,bits) interleaved pairs -> flat LUT of (sym, bits)."""
    lut = [(-1, 0)] * (1 << maxbits)
    for i, sym in enumerate(syms):
        code, bits = pairs[2 * i], pairs[2 * i + 1]
        if bits == 0:
            continue
        lo = code << (maxbits - bits)
        for k in range(lo, lo + (1 << (maxbits - bits))):
            lut[k] = (sym, bits)
    return lut


def _read_lut(b: Bits, lut, maxbits):
    v = b.peek(maxbits) if b.left >= maxbits else \
        (b.peek(b.left) << (maxbits - b.left) if b.left > 0 else 0)
    sym, bits = lut[v]
    if sym == -1 or bits > b.left:
        raise ValueError("mpeg4: invalid VLC")
    b.pos += bits
    return sym


# MCBPC intra: 9 entries -> (mb_type, cbpc): types 3, 4 (+q)
_MCBPC_I_SYMS = [(3, 0), (3, 1), (3, 2), (3, 3),
                 (4, 0), (4, 1), (4, 2), (4, 3), (-1, -1)]
_MCBPC_I_PAIRS = []
for _i in range(9):
    _MCBPC_I_PAIRS += [T.INTRA_MCBPC_CODE[_i], T.INTRA_MCBPC_BITS[_i]]
_MCBPC_I_LUT = _vlc_lut(_MCBPC_I_PAIRS, _MCBPC_I_SYMS, 9)

# MCBPC inter: 28 entries laid out by BITMASK, not type-major:
# index & 3 = cbpc, & 4 = intra, & 8 = +Q, & 16 = 4MV (so 0-3 INTER,
# 4-7 INTRA, 8-11 INTER+Q, 12-15 INTRA+Q, 16-19 INTER4V, 20
# stuffing, 24-27 INTER4V+Q)
_MCBPC_P_TYPE = {0: 0, 1: 3, 2: 1, 3: 4, 4: 2, 6: 5}
_MCBPC_P_SYMS = []
for _i in range(28):
    _g = _i >> 2
    if _g in _MCBPC_P_TYPE and _i not in (20, 21, 22, 23):
        _MCBPC_P_SYMS.append((_MCBPC_P_TYPE[_g], _i & 3))
    else:
        _MCBPC_P_SYMS.append((-2, 0))      # stuffing / reserved
_MCBPC_P_PAIRS = []
for _i in range(28):
    _MCBPC_P_PAIRS += [T.INTER_MCBPC_CODE[_i], T.INTER_MCBPC_BITS[_i]]
_MCBPC_P_LUT = _vlc_lut(_MCBPC_P_PAIRS, _MCBPC_P_SYMS, 13)

_CBPY_LUT = _vlc_lut(T.CBPY, list(range(16)), 6)
# B-VOP mb_type: unary "1"=direct, "01"=interpolate, "001"=backward,
# "0001"=forward
_MBTYPE_B_LUT = _vlc_lut([1, 1, 1, 2, 1, 3, 1, 4],
                         [0, 1, 2, 3], 4)
_MV_LUT = _vlc_lut(T.MVTAB, list(range(33)), 13)

_DCTAB_LUM_LUT = _vlc_lut(T.DCTAB_LUM, list(range(13)), 11)
_DCTAB_CHROM_LUT = _vlc_lut(T.DCTAB_CHROM, list(range(13)), 12)


def _rl_lut(pairs, runs, levels, maxbits=12):
    """H.263-family RL VLC: 102 (run, level) leaves + the escape
    (last table entry).  Returns LUT of (run, level, bits, last)
    where entries 0..57 are last=0 and 58..101 last=1 (the table
    layout ffmpeg's rl->n + last split uses)."""
    lut = [None] * (1 << maxbits)
    n = len(runs)
    for i in range(n + 1):
        code, bits = pairs[2 * i], pairs[2 * i + 1]
        if bits == 0 or bits > maxbits:
            continue
        if i < n:
            sym = (runs[i], levels[i], i)
        else:
            sym = ("esc", 0, n)
        lo = code << (maxbits - bits)
        for k in range(lo, lo + (1 << (maxbits - bits))):
            lut[k] = (sym[0], sym[1], bits, sym[2])
    return lut


_RL_INTRA_LUT = _rl_lut(T.MP4_INTRA_VLC, T.MP4_INTRA_RUN,
                        T.MP4_INTRA_LEVEL)
_RL_INTER_LUT = _rl_lut(T.INTER_VLC, T.INTER_RUN, T.INTER_LEVEL)

# last=1 starts at index 58 in the intra table and 58 in inter
# (ffmpeg rl: last entries are the tail of the 102) — recover the
# boundary from the level arrays: the level resets to 1 at the
# last=1 block's start.
def _last_split(runs):
    """The last=1 entries are the table's tail: they begin where the
    run value resets to 0 after having climbed through the last=0
    section."""
    for i in range(len(runs) - 1, 0, -1):
        if runs[i] == 0 and runs[i - 1] > 0:
            return i
    raise AssertionError


_INTRA_LAST0_N = _last_split(list(T.MP4_INTRA_RUN))
_INTER_LAST0_N = _last_split(list(T.INTER_RUN))

_ZIG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21,
    28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37,
    44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47,
    55, 62, 63], np.int32)
# alternate scans (ISO 14496-2 figure 7-2 / MPEG-2 heritage)
_ALT_V = np.array([
    0, 8, 16, 24, 1, 9, 2, 10, 17, 25, 32, 40, 48, 56, 57, 49,
    41, 33, 26, 18, 3, 11, 4, 12, 19, 27, 34, 42, 50, 58, 35, 43,
    51, 59, 20, 28, 5, 13, 6, 14, 21, 29, 36, 44, 52, 60, 37, 45,
    53, 61, 22, 30, 7, 15, 23, 31, 38, 46, 54, 62, 39, 47, 55,
    63], np.int32)
_ALT_H = np.array([
    0, 1, 2, 3, 8, 9, 16, 17, 10, 11, 4, 5, 6, 7, 15, 14,
    13, 12, 19, 18, 24, 25, 32, 33, 26, 27, 20, 21, 22, 23, 28, 29,
    30, 31, 34, 35, 40, 41, 48, 49, 42, 43, 36, 37, 38, 39, 44, 45,
    46, 47, 50, 51, 56, 57, 58, 59, 52, 53, 54, 55, 60, 61, 62,
    63], np.int32)


# ------------------------------------------------------------------ #
# The XVID integer IDCT — the transform the reference decoder family
# applies to MPEG-4 part 2 by default (selected over the "simple"
# transform for DivX/Xvid compatibility; algorithm recovered from
# the public binary: per-row c1..c7 butterflies with row-specific
# scale tables and rounders, >>11 with int16 truncation, then a
# tangent/sqrt2 column pass >>6).  The three column speed variants
# in the original are mathematically identical to the full path.
# ------------------------------------------------------------------ #

_TAB04 = (22725, 21407, 19266, 16384, 12873, 8867, 4520)
_TAB17 = (31521, 29692, 26722, 22725, 17855, 12299, 6270)
_TAB26 = (29692, 27969, 25172, 21407, 16819, 11585, 5906)
_TAB35 = (26722, 25172, 22654, 19266, 15137, 10426, 5315)
_ROW_TABS = (_TAB04, _TAB17, _TAB26, _TAB35, _TAB04, _TAB35,
             _TAB26, _TAB17)
_ROW_RND = (65536, 3597, 2260, 1203, 0, 120, 512, 512)
_TAN1, _TAN2, _TAN3, _SQRT2 = 13036, 27146, 43790, 23170


def _i16(x: np.ndarray) -> np.ndarray:
    return ((x + 0x8000) & 0xFFFF) - 0x8000


def _xvid_idct(blocks: np.ndarray) -> np.ndarray:
    """(n, 8, 8) int coefficients -> (n, 8, 8) int16 samples."""
    b = blocks.astype(np.int64)
    rows = np.empty_like(b)
    for r in range(8):
        c1, c2, c3, c4, c5, c6, c7 = _ROW_TABS[r]
        rnd = _ROW_RND[r]
        x = [b[:, r, i] for i in range(8)]
        a0 = c4 * x[0] + c2 * x[2] + c4 * x[4] + c6 * x[6] + rnd
        a1 = c4 * x[0] + c6 * x[2] - c4 * x[4] - c2 * x[6] + rnd
        a2 = c4 * x[0] - c6 * x[2] - c4 * x[4] + c2 * x[6] + rnd
        a3 = c4 * x[0] - c2 * x[2] + c4 * x[4] - c6 * x[6] + rnd
        b0 = c1 * x[1] + c3 * x[3] + c5 * x[5] + c7 * x[7]
        b1 = c3 * x[1] - c7 * x[3] - c1 * x[5] - c5 * x[7]
        b2 = c5 * x[1] - c1 * x[3] + c7 * x[5] + c3 * x[7]
        b3 = c7 * x[1] - c5 * x[3] + c3 * x[5] - c1 * x[7]
        rows[:, r, 0] = _i16((a0 + b0) >> 11)
        rows[:, r, 7] = _i16((a0 - b0) >> 11)
        rows[:, r, 1] = _i16((a1 + b1) >> 11)
        rows[:, r, 6] = _i16((a1 - b1) >> 11)
        rows[:, r, 2] = _i16((a2 + b2) >> 11)
        rows[:, r, 5] = _i16((a2 - b2) >> 11)
        rows[:, r, 3] = _i16((a3 + b3) >> 11)
        rows[:, r, 4] = _i16((a3 - b3) >> 11)
    x = [rows[:, i, :] for i in range(8)]
    t17a = ((_TAN1 * x[7]) >> 16) + x[1]
    t17b = ((_TAN1 * x[1]) >> 16) - x[7]
    t35a = ((_TAN3 * x[5]) >> 16) + x[3]
    t35b = ((_TAN3 * x[3]) >> 16) - x[5]
    b0 = t17a + t35a
    d = t17a - t35a
    c = t17b + t35b
    e0 = 2 * ((_SQRT2 * (d + c)) >> 16)
    e1 = 2 * ((_SQRT2 * (d - c)) >> 16)
    t26a = ((_TAN2 * x[6]) >> 16) + x[2]
    t26b = ((_TAN2 * x[2]) >> 16) - x[6]
    s04 = x[0] + x[4]
    d04 = x[0] - x[4]
    a0 = s04 + t26a
    a1 = s04 - t26a
    a2 = d04 + t26b
    a3 = d04 - t26b
    out = np.empty_like(rows)
    out[:, 0, :] = _i16((a0 + b0) >> 6)
    out[:, 7, :] = _i16((a0 - b0) >> 6)
    out[:, 3, :] = _i16((a1 - t35b + t17b) >> 6)
    out[:, 4, :] = _i16((a1 + t35b - t17b) >> 6)
    out[:, 1, :] = _i16((a2 + e0) >> 6)
    out[:, 6, :] = _i16((a2 - e0) >> 6)
    out[:, 2, :] = _i16((a3 + e1) >> 6)
    out[:, 5, :] = _i16((a3 - e1) >> 6)
    return out


def idct_put(blocks: np.ndarray) -> np.ndarray:
    return np.clip(_xvid_idct(blocks), 0, 255).astype(np.uint8)


def idct_add(blocks: np.ndarray, pred: np.ndarray) -> np.ndarray:
    return np.clip(_xvid_idct(blocks) + pred, 0, 255).astype(np.uint8)


def idct_add_sel(blocks, pred, coded) -> np.ndarray:
    """idct+add for coded blocks; uncoded blocks pass the prediction
    through UNCLIPPED-identical (the MC output is already in range)."""
    out = np.empty((len(coded), 8, 8), np.uint8)
    idx = [i for i, c in enumerate(coded) if c]
    if idx:
        out[idx] = np.clip(_xvid_idct(blocks[idx])
                           + pred[idx], 0, 255).astype(np.uint8)
    rest = [i for i, c in enumerate(coded) if not c]
    for i in rest:
        out[i] = np.clip(pred[i], 0, 255).astype(np.uint8)
    return out


# ------------------------------------------------------------------ #
# Headers
# ------------------------------------------------------------------ #

class _VOL:
    low_delay = 1
    width = 0
    height = 0
    time_inc_res = 1
    time_inc_bits = 1
    quant_type = 0
    intra_mat = None
    inter_mat = None
    resync_marker_disable = 1
    quarter_sample = 0
    verid = 1
    quant_precision = 5
    interlaced = 0
    data_partitioned = 0
    sprite_enable = 0
    sprite_points = 0
    sprite_accuracy = 0


_QPEL_TAPS = np.array([-1, 3, -6, 20, 20, -6, 3, -1], np.int32)
_QPEL_IDX_CACHE: dict = {}


def _qpel_idx(s: int) -> np.ndarray:
    """(s, 8) tap sample indices into a (s+1)-wide block, mirrored
    at the block edges (i<0 -> -i-1, i>s -> 2s+1-i)."""
    tab = _QPEL_IDX_CACHE.get(s)
    if tab is None:
        tab = np.empty((s, 8), np.int32)
        for x in range(s):
            for t in range(8):
                i = x - 3 + t
                if i < 0:
                    i = -i - 1
                elif i > s:
                    i = 2 * s + 1 - i
                tab[x, t] = i
        _QPEL_IDX_CACHE[s] = tab
    return tab


def _log2up(v: int) -> int:
    n = 0
    while (1 << n) < v:
        n += 1
    return max(1, n)


class Mpeg4Decoder:
    """Stateful frame decoder: feed whole coded frames (one or more
    start-code chunks) in stream order; returns (y, u, v) or None
    for headers-only / skipped input."""

    def __init__(self):
        self.vol: Optional[_VOL] = None
        self.last: Optional[list] = None       # newest non-B recon
        self._older: Optional[list] = None     # previous non-B recon
        self._pending: Optional[tuple] = None  # delayed display frame
        self._mbw = 0
        self._mbh = 0
        # temporal state for B direct mode
        self._time_base = 0
        self._last_time_base = 0
        self._time = 0
        self._pp_time = 0
        self._last_non_b_time = 0
        # co-located data from the newest non-B VOP
        self._co_mvs: Optional[list] = None    # per block grid
        self._co_skip: Optional[list] = None   # per MB
        self._vp_count = 0               # video packets consumed
        self._alt_scan = 0               # per-VOP alternate scan
        self._top_field_first = 1
        self._co_field: Optional[list] = None  # per MB: field-MC?
        self._co_fmvs: Optional[list] = None   # per MB: 2 field MVs
        self._co_fsels: Optional[list] = None  # per MB: 2 selects
        # optional debug trace: set to a list to record per-MB
        # (mbx, mby, mode, mvs, cbp) tuples during B-VOP decode
        self._mb_trace: Optional[list] = None
        # plan mode: parse-only decode that records per-VOP recon
        # plans (dequantized blocks + MVs + mode masks) for the
        # batched device path in io/mpeg4jax.py instead of running
        # the per-MB numpy reconstruction.
        self.plan_mode = False
        self.plans: list = []
        self._plan: Optional[dict] = None

    # ------------------------------------------------------------ #
    # Plan recording (device recon staging)
    # ------------------------------------------------------------ #

    def _plan_new(self, kind: str, rounding: int = 0) -> dict:
        """Fresh per-VOP recon plan.  Layout: raster MB index ->
        dequantized coefficient blocks (idct(0) == 0, so uncoded
        blocks need no mask), per-8x8-block forward/backward luma
        MVs + derived chroma MVs in half-pel units, and mode masks
        (intra / use_f / use_b; skip == inter with zero MVs)."""
        nmb = self._mbw * self._mbh
        plan = dict(
            kind=kind, rounding=rounding,
            mbw=self._mbw, mbh=self._mbh,
            blocks=np.zeros((nmb, 6, 8, 8), np.int16),
            intra=np.zeros(nmb, np.uint8),
            use_f=np.zeros(nmb, np.uint8),
            use_b=np.zeros(nmb, np.uint8),
            mvs4=np.zeros((nmb, 4, 2), np.int16),
            cmv=np.zeros((nmb, 2), np.int16),
            bmvs4=np.zeros((nmb, 4, 2), np.int16),
            bcmv=np.zeros((nmb, 2), np.int16))
        self._plan = plan
        return plan

    def parse_plans(self, data: bytes) -> list:
        """Parse one container chunk in plan mode, returning the
        decode-order recon plans it yields (no pixel work; see
        io/mpeg4jax.py for the batched device reconstruction).
        Raises NotImplementedError for VOL features the device path
        does not cover (interlace, quarter-sample) — callers fall
        back to the numpy decode path wholesale."""
        self.plan_mode = True
        start = len(self.plans)
        if len(data) >= 3 and data[0] == 0 and data[1] == 0 \
                and (data[2] & 0xFC) == 0x80:
            raise NotImplementedError(
                "mpeg4 plan mode: short-header (H.263) streams "
                "decode on the numpy path")
        for code, payload in _iter_startcodes(data):
            if 0x20 <= code <= 0x2F:
                self._parse_vol(Bits(payload))
                if self.vol.interlaced or self.vol.quarter_sample \
                        or getattr(self.vol, "sprite_enable", 0):
                    raise NotImplementedError(
                        "mpeg4 plan mode: interlaced/quarter-sample/"
                        "GMC VOLs decode on the numpy path")
            elif code == 0xB6:
                self._decode_vop(Bits(payload))
        out, self.plans = self.plans[start:], self.plans[:start]
        return out

    # ------------------------------------------------------------ #

    def _parse_vol(self, b: Bits) -> None:
        vol = _VOL()
        b.read1()                        # random accessible
        b.read(8)                        # video object type
        if b.read1():                    # is_object_layer_identifier
            vol.verid = b.read(4)
            b.read(3)
        aspect = b.read(4)
        if aspect == 0xF:
            b.read(16)
        if b.read1():                    # vol control parameters
            b.read(2)                    # chroma format
            vol.low_delay = b.read1()
            if b.read1():                # vbv parameters
                b.read(15); b.read1()
                b.read(15); b.read1()
                b.read(15); b.read1()
                b.read(3); b.read(11); b.read1()
                b.read(15); b.read1()
        shape = b.read(2)
        if shape != 0:
            raise NotImplementedError("mpeg4: only rectangular VOPs")
        b.read1()                        # marker
        vol.time_inc_res = b.read(16)
        vol.time_inc_bits = _log2up(vol.time_inc_res)
        b.read1()
        if b.read1():                    # fixed vop rate
            b.read(vol.time_inc_bits)
        b.read1()
        vol.width = b.read(13)
        b.read1()
        vol.height = b.read(13)
        b.read1()
        vol.interlaced = b.read1()
        b.read1()                        # obmc disable
        sprite = b.read(1 if vol.verid == 1 else 2)
        vol.sprite_enable = sprite
        if sprite == 1:
            raise NotImplementedError("mpeg4: static sprite VOLs")
        if sprite == 2:                  # GMC
            vol.sprite_points = b.read(6)
            if vol.sprite_points > 3:
                raise ValueError("mpeg4: GMC warping points > 3")
            vol.sprite_accuracy = b.read(2)
            if b.read1():
                raise NotImplementedError(
                    "mpeg4: sprite brightness change")
        if b.read1():                    # not 8 bit
            raise NotImplementedError("mpeg4: >8-bit video")
        vol.quant_type = b.read1()
        if vol.quant_type:
            vol.intra_mat = list(T.DEFAULT_INTRA_MAT)
            vol.inter_mat = list(T.DEFAULT_NONINTRA_MAT)
            for which in range(2):
                if b.read1():            # load custom matrix
                    mat = [0] * 64
                    last = 0
                    for i in range(64):
                        v = b.read(8)
                        if v == 0:
                            break
                        last = v
                        mat[int(_ZIG[i])] = v
                    for j in range(i, 64):
                        mat[int(_ZIG[j])] = last
                    if which == 0:
                        vol.intra_mat = mat
                    else:
                        vol.inter_mat = mat
        if vol.verid != 1:
            vol.quarter_sample = b.read1()
        if not b.read1():                # complexity estimation
            raise NotImplementedError(
                "mpeg4: complexity estimation headers")
        vol.resync_marker_disable = b.read1()
        vol.data_partitioned = b.read1()
        if vol.data_partitioned:
            if b.read1():                # reversible VLC
                raise NotImplementedError("mpeg4: RVLC texture")
        if vol.verid != 1:
            if b.read1():
                raise NotImplementedError("mpeg4: newpred")
            if b.read1():
                raise NotImplementedError(
                    "mpeg4: reduced resolution")
        if b.read1():
            raise NotImplementedError("mpeg4: scalable VOLs")
        self.vol = vol
        self._mbw = (vol.width + 15) // 16
        self._mbh = (vol.height + 15) // 16

    # ------------------------------------------------------------ #

    def decode_frames(self, data: bytes) -> list:
        """Decode one container chunk, returning ALL display frames
        it yields (0, 1, or — for Xvid packed-bitstream chunks
        holding a P+B VOP pair — 2)."""
        out = []
        if len(data) >= 3 and data[0] == 0 and data[1] == 0 \
                and (data[2] & 0xFC) == 0x80:
            # short video header picture (no MPEG-4 start codes)
            return [self.decode_short(data)]
        for code, payload in _iter_startcodes(data):
            if 0x20 <= code <= 0x2F:
                self._parse_vol(Bits(payload))
            elif code == 0xB6:
                got = self._decode_vop(Bits(payload))
                if got is not None:
                    out.append(got)
            elif code == 0xB3 or code == 0xB2 or code == 0xB0 \
                    or code == 0xB5 or code == 0xB1 \
                    or 0x00 <= code <= 0x1F:
                continue
        return out

    def decode(self, data: bytes
               ) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """Decode one coded frame (all start-code chunks); returns
        the last display frame the chunk yields (use decode_frames
        for packed-bitstream chunks that can yield two)."""
        out = self.decode_frames(data)
        return out[-1] if out else None

    def flush(self
              ) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """End of stream: emit the reorder-delayed final non-B frame
        (B-VOP streams hold one frame back)."""
        out, self._pending = self._pending, None
        return out

    # ------------------------------------------------------------ #

    def _decode_vop(self, b: Bits):
        if self.vol is None:
            raise ValueError("mpeg4: VOP before VOL")
        vol = self.vol
        vop_type = b.read(2)
        time_incr = 0
        while b.read1():                 # modulo time base
            time_incr += 1
        b.read1()
        time_inc = b.read(vol.time_inc_bits)
        b.read1()
        # temporal bookkeeping (direct-mode TRB/TRD ratios)
        res = max(1, vol.time_inc_res)
        if vop_type != 2:
            self._last_time_base = self._time_base
            self._time_base += time_incr
            self._time = self._time_base * res + time_inc
            if self._time < self._last_non_b_time:
                self._time += res
                self._time_base += 1
            self._pp_time = self._time - self._last_non_b_time
            self._last_non_b_time = self._time
        else:
            self._time = (self._last_time_base + time_incr) * res \
                + time_inc
            self._pb_time = self._pp_time \
                - (self._last_non_b_time - self._time)
        if not b.read1():                # vop_coded == 0
            if vop_type != 2:
                if self.plan_mode:
                    # repeat-anchor == an all-skip P plan (inter,
                    # zero MVs, no residual -> the device MC copies
                    # the reference verbatim)
                    plan = self._plan_new('P')
                    plan['use_f'][:] = 1
                    self.plans.append(plan)
                    self._plan = None
                return self._shift_refs(None)
            return None
        rounding = 0
        if vop_type == 1 or (vop_type == 3 and
                             getattr(vol, "sprite_enable", 0) == 2):
            rounding = b.read1()
        if vop_type == 3 and getattr(vol, "sprite_enable", 0) != 2:
            raise NotImplementedError("mpeg4: static sprite VOPs")
        intra_dc_thr = b.read(3)
        if vol.interlaced:
            self._top_field_first = b.read1()
            self._alt_scan = b.read1()
        else:
            self._alt_scan = 0
        svop_traj = None
        if vop_type == 3:
            svop_traj = [(self._read_traj_dmv(b),
                          self._read_traj_dmv(b))
                         for _ in range(vol.sprite_points)]
        qscale = b.read(vol.quant_precision)
        if qscale == 0:
            raise ValueError("mpeg4: qscale 0")
        fcode = fcode_b = 1
        if vop_type in (1, 2, 3):
            fcode = b.read(3)
            if fcode == 0:
                raise ValueError("mpeg4: fcode 0")
        if vop_type == 2:
            fcode_b = b.read(3)
            if fcode_b == 0:
                raise ValueError("mpeg4: fcode_b 0")
        if self.plan_mode:
            if vol.interlaced or vol.quarter_sample \
                    or getattr(vol, "sprite_enable", 0):
                raise NotImplementedError(
                    "mpeg4 plan mode: interlaced/quarter-sample/"
                    "GMC VOLs decode on the numpy path")
            self._plan_new(('I', 'P', 'B')[vop_type],
                           rounding if vop_type == 1 else 0)
        if vol.data_partitioned and vop_type in (0, 1):
            if vop_type == 1 and self.last is None:
                raise ValueError("mpeg4: P-VOP before I-VOP")
            prev_ref = self.last
            self._decode_dp_vop(b, vop_type, qscale, intra_dc_thr,
                                fcode, rounding)
            self._older = prev_ref
            if self._plan is not None:
                self.plans.append(self._plan)
                self._plan = None
            return self._shift_refs(self.last)
        if vop_type == 0:
            prev_ref = self.last
            self._decode_ivop(b, qscale, intra_dc_thr)
            self._older = prev_ref
            if self._plan is not None:
                self.plans.append(self._plan)
                self._plan = None
            return self._shift_refs(self.last)
        elif vop_type in (1, 3):
            if self.last is None:
                raise ValueError("mpeg4: P-VOP before I-VOP")
            prev_ref = self.last
            self._decode_pvop(b, qscale, intra_dc_thr, fcode,
                              rounding, svop_traj=svop_traj)
            self._older = prev_ref
            if self._plan is not None:
                self.plans.append(self._plan)
                self._plan = None
            return self._shift_refs(self.last)
        else:
            if self._older is None or self.last is None:
                raise ValueError("mpeg4: B-VOP without two references")
            out = self._decode_bvop(b, qscale, fcode, fcode_b)
            if self._plan is not None:
                self.plans.append(self._plan)
                self._plan = None
                return None
            return out

    def _shift_refs(self, new):
        """Non-B frame decoded: display the previously pending
        non-B (one-frame reorder delay, matching the reference
        decoder), queue this one."""
        if self.plan_mode:
            return None                  # plans carry the frames
        if new is None:                    # vop_coded == 0: repeat
            new = self.last
        prev_pending = self._pending
        self._pending = self._crop_planes(new)
        if not self.vol.low_delay:
            return prev_pending          # one-frame reorder delay
        out = self._pending
        self._pending = None
        return out

    def _resync(self, b: Bits, nzeros: int, mb_index: int):
        """Video packet boundary (14496-2 6.2.5.2): a byte-aligned
        resync marker — '0'+ones zero-bit stuffing to alignment,
        then `nzeros` zeros and a one — followed by the
        video_packet_header (macroblock_number, quant_scale, HEC).
        Returns the packet's quant_scale, or None when the next bits
        are ordinary MB data.  nzeros: I=16, P=fcode+15,
        B=max(fcode_f, fcode_b, 2)+15 (the libavcodec prefix rule).
        """
        p = b.pos
        align = 8 - (p & 7) if (p & 7) else 8
        if b.left < align + nzeros + 1:
            return None
        if b.peek(align) != (1 << (align - 1)) - 1:
            return None
        b.pos = p + align
        if b.peek(nzeros + 1) != 1:
            b.pos = p
            return None
        b.pos += nzeros + 1
        vol = self.vol
        mb_num = self._mbw * self._mbh
        mb_bits = max(1, (mb_num - 1).bit_length())
        got = b.read(mb_bits)
        if got != mb_index:
            raise ValueError(
                f"mpeg4: video packet resumes at MB {got}, "
                f"expected {mb_index} (lost packet?)")
        q = b.read(vol.quant_precision)
        if q == 0:
            raise ValueError("mpeg4: video packet qscale 0")
        if b.read1():                    # header extension code
            while b.read1():             # modulo time base
                pass
            b.read1()                    # marker
            b.read(vol.time_inc_bits)
            b.read1()                    # marker
            vt = b.read(2)
            b.read(3)                    # intra_dc_vlc_thr (repeat)
            if vt != 0:
                b.read(3)                # fcode forward (repeat)
            if vt == 2:
                b.read(3)                # fcode backward (repeat)
        self._vp_count += 1
        return q

    def _fresh_pred_grids(self):
        """DC/AC/q prediction grids in their reset state — used at
        VOP start and re-created at every video packet boundary
        (prediction never crosses a packet)."""
        mbw, mbh = self._mbw, self._mbh
        dcs = [np.full((2 * mbh + 1, 2 * mbw + 2), 1024, np.int64)
               for _ in range(3)]
        acs_row = [np.zeros((2 * mbh + 1, 2 * mbw + 2, 8), np.int64)
                   for _ in range(3)]
        acs_col = [np.zeros((2 * mbh + 1, 2 * mbw + 2, 8), np.int64)
                   for _ in range(3)]
        qgrid = [np.zeros((2 * mbh + 1, 2 * mbw + 2), np.int64)
                 for _ in range(3)]
        return dcs, acs_row, acs_col, qgrid

    def _crop(self):
        return self._crop_planes(self.last)

    def _crop_planes(self, planes):
        vol = self.vol
        y, u, v = planes
        return (y[:vol.height, :vol.width],
                u[:(vol.height + 1) // 2, :(vol.width + 1) // 2],
                v[:(vol.height + 1) // 2, :(vol.width + 1) // 2])

    # ------------------------------------------------------------ #
    # Block layer
    # ------------------------------------------------------------ #

    def _dequant(self, lv: np.ndarray, qscale: int, intra: bool,
                 dc: int) -> np.ndarray:
        """Zigzag-placed levels (raster (8,8) int) -> coefficients."""
        vol = self.vol
        out = np.zeros((8, 8), np.int64)
        if vol.quant_type == 0:
            # H.263-style (second quantization method)
            add = qscale - 1 if (qscale & 1) == 0 else qscale
            nz = lv != 0
            mag = 2 * np.abs(lv) * qscale + add
            out[nz] = (np.sign(lv[nz]) * mag[nz])
        else:
            mat = np.array(vol.intra_mat if intra else vol.inter_mat,
                           np.int64).reshape(8, 8)
            if intra:
                # sign-symmetric truncation (C >> on the magnitude)
                mag = (np.abs(lv) * mat * 2 * qscale) >> 4
                out = np.sign(lv) * mag
            else:
                nz = lv != 0
                mag = ((2 * np.abs(lv) + 1) * mat * qscale) >> 4
                out[nz] = np.sign(lv[nz]) * mag[nz]
                # the reference implements this quantizer with its
                # MPEG-2 routine, which applies mismatch control on
                # inter blocks (sum parity toggles coef 63's LSB)
                if (int(out.sum()) & 1) == 0:
                    out[7, 7] ^= 1
        if intra:
            out[0, 0] = dc
        np.clip(out, -2048, 2047, out=out)
        return out

    def _read_dc(self, b: Bits, comp: int) -> int:
        if comp == 0:
            size = _read_lut(b, _DCTAB_LUM_LUT, 11)
        else:
            size = _read_lut(b, _DCTAB_CHROM_LUT, 12)
        if size == 0:
            return 0
        v = b.read(size)
        if (v >> (size - 1)) == 0:       # negative: complement
            v = -((v ^ ((1 << size) - 1)))
        if size > 8:
            b.read1()                    # marker
        return v

    def _read_block(self, b: Bits, intra: bool, scan: np.ndarray,
                    first_pos: int = 0) -> np.ndarray:
        """Coefficients into raster (8,8) levels.  first_pos = 1 for
        intra blocks whose DC was coded separately (the first AC
        codeword's position is run + 1); 0 otherwise (inter, or
        intra with the DC folded into the AC coding)."""
        lv = np.zeros(64, np.int64)
        lut = _RL_INTRA_LUT if intra else _RL_INTER_LUT
        n0 = _INTRA_LAST0_N if intra else _INTER_LAST0_N
        pos = first_pos
        while True:
            got = lut[_peek12(b)]
            if got is None:
                raise ValueError("mpeg4: invalid RL code")
            run, level, bits, idx = got
            if bits > b.left:
                raise ValueError("mpeg4: RL code past end")
            b.pos += bits
            if run == "esc":
                # three escape kinds
                if b.read1() == 0:
                    # type 1 escape... wait: first bit 0 -> type 1?
                    mode = 0
                else:
                    mode = 1 + b.read1()
                if mode == 0:
                    # ESC level: vlc with level offset
                    got2 = lut[_peek12(b)]
                    if got2 is None or got2[0] == "esc":
                        raise ValueError("mpeg4: bad L1 escape")
                    run2, level2, bits2, idx2 = got2
                    b.pos += bits2
                    last2 = idx2 >= n0
                    lmax = _rl_max_level(intra, last2, run2)
                    sign = b.read1()
                    val = level2 + lmax
                    if sign:
                        val = -val
                    pos += run2
                    if pos > 63:
                        raise ValueError("mpeg4: run past block end")
                    lv[scan[pos]] = val
                    pos += 1
                    if last2:
                        break
                elif mode == 1:
                    # ESC run: vlc with run offset
                    got2 = lut[_peek12(b)]
                    if got2 is None or got2[0] == "esc":
                        raise ValueError("mpeg4: bad L2 escape")
                    run2, level2, bits2, idx2 = got2
                    b.pos += bits2
                    last2 = idx2 >= n0
                    rmax = _rl_max_run(intra, last2, abs(level2))
                    sign = b.read1()
                    val = -level2 if sign else level2
                    pos += run2 + rmax + 1
                    if pos > 63:
                        raise ValueError("mpeg4: run past block end")
                    lv[scan[pos]] = val
                    pos += 1
                    if last2:
                        break
                else:
                    # ESC absolute: last(1) run(6) marker level(12) marker
                    last2 = b.read1()
                    run2 = b.read(6)
                    b.read1()
                    val = b.read(12)
                    if val >= 2048:
                        val -= 4096
                    b.read1()
                    if val == 0:
                        raise ValueError("mpeg4: zero escape level")
                    pos += run2
                    if pos > 63:
                        raise ValueError("mpeg4: run past block end")
                    lv[scan[pos]] = val
                    pos += 1
                    if last2:
                        break
            else:
                last = idx >= n0
                sign = b.read1()
                pos += run
                if pos > 63:
                    raise ValueError("mpeg4: run past block end")
                lv[scan[pos]] = -level if sign else level
                pos += 1
                if last:
                    break
        return lv.reshape(8, 8)

    # ------------------------------------------------------------ #
    # Data partitioning (6.2.9): within each video packet the MB
    # data splits into partition A (I: mcbpc/dquant/DC; P:
    # not_coded/mcbpc/MVs), a marker (DC_MARKER 19 bits for I,
    # MOTION_MARKER 17 bits for P), partition B (ac_pred/cbpy [+
    # dquant and DC for P-intra]), then the texture blocks.
    # Layout verified by bit-accounting against lavc
    # data_partitioning=1 streams.  RVLC texture stays gated.
    # ------------------------------------------------------------ #

    _DC_MARKER = (0x6B001, 19)
    _MOTION_MARKER = (0x1F001, 17)

    def _dp_packet_mbs(self, b: Bits, mb_index: int,
                       nzeros: int) -> int:
        """How many MBs this packet spans: scan ahead is not needed —
        partition A self-terminates at the marker, so we just track
        indices; returns the resync-updated quantizer or None."""
        return self._resync(b, nzeros, mb_index)

    def _decode_dp_vop(self, b: Bits, vop_type: int, qscale: int,
                       dc_thr: int, fcode: int, rounding: int):
        """Data-partitioned I/P VOP decode."""
        vol = self.vol
        mbw, mbh = self._mbw, self._mbh
        W, H = mbw * 16, mbh * 16
        nmb = mbw * mbh
        y = np.zeros((H, W), np.uint8)
        u = np.zeros((H // 2, W // 2), np.uint8)
        v = np.zeros((H // 2, W // 2), np.uint8)
        prev = self.last
        pad = 16 + (32 << (fcode - 1)) // 2
        refs = None if (vop_type == 0 or self._plan is not None) \
            else [np.pad(pl, pad, mode="edge") for pl in prev]
        dcs, acs_row, acs_col, qgrid = self._fresh_pred_grids()
        mvgrid = [[(0, 0)] * (2 * mbw) for _ in range(2 * mbh)]
        skipmap = [[False] * mbw for _ in range(mbh)]
        nzeros = 16 if vop_type == 0 else fcode + 15
        mb = 0
        dec = Mpeg4Decoder
        while mb < nmb:
            if mb > 0:
                nq = self._resync(b, nzeros, mb)
                if nq is None:
                    raise ValueError(
                        "mpeg4 DP: expected resync marker at MB "
                        f"{mb}")
                qscale = nq
                dcs, acs_row, acs_col, qgrid = \
                    self._fresh_pred_grids()
            pkt_start = mb
            # ---- partition A --------------------------------- #
            rows = []           # per MB: dict of part-A fields
            while True:
                if vop_type == 0:
                    pk = b.peek(19)
                    if pk == self._DC_MARKER[0]:
                        break
                    mb_type, cbpc = _read_lut(b, _MCBPC_I_LUT, 9)
                    while mb_type == -1:
                        mb_type, cbpc = _read_lut(b, _MCBPC_I_LUT,
                                                  9)
                    if mb_type == 4:
                        qscale = _dquant(b, qscale)
                    use_dc = self._dp_use_dc(qscale, dc_thr)
                    dcds = [self._read_dc(b, 0 if n < 4 else 1)
                            if use_dc else None for n in range(6)]
                    rows.append(dict(intra=True, cbpc=cbpc,
                                     q=qscale, dcds=dcds,
                                     use_dc=use_dc))
                else:
                    if b.peek(17) == self._MOTION_MARKER[0]:
                        break
                    if b.read1():            # not_coded skip
                        rows.append(dict(skip=True))
                        mbx = (pkt_start + len(rows) - 1) % mbw
                        continue
                    mb_type, cbpc = _read_lut(b, _MCBPC_P_LUT, 13)
                    while mb_type == -2:
                        mb_type, cbpc = _read_lut(b, _MCBPC_P_LUT,
                                                  13)
                    intra = mb_type in (3, 4)
                    row = dict(skip=False, mb_type=mb_type,
                               cbpc=cbpc, intra=intra)
                    if not intra:
                        idx = pkt_start + len(rows)
                        mbx_, mby_ = idx % mbw, idx // mbw
                        bx, by = 2 * mbx_, 2 * mby_
                        if mb_type == 2 or mb_type == 5:
                            mvs = []
                            for k in range(4):
                                px_, py_ = self._pred_mv(
                                    mvgrid, bx + (k & 1),
                                    by + (k >> 1), k, pkt_start)
                                mx = self._decode_mv_component(
                                    b, fcode, px_)
                                my = self._decode_mv_component(
                                    b, fcode, py_)
                                mvs.append((mx, my))
                                mvgrid[by + (k >> 1)][bx +
                                                      (k & 1)] = \
                                    (mx, my)
                        else:
                            px_, py_ = self._pred_mv(mvgrid, bx,
                                                     by, 0,
                                                     pkt_start)
                            mx = self._decode_mv_component(
                                b, fcode, px_)
                            my = self._decode_mv_component(
                                b, fcode, py_)
                            mvs = [(mx, my)] * 4
                            for k in range(4):
                                mvgrid[by + (k >> 1)][bx +
                                                      (k & 1)] = \
                                    (mx, my)
                        row["mvs"] = mvs
                    else:
                        idx = pkt_start + len(rows)
                        mbx_, mby_ = idx % mbw, idx // mbw
                        bx, by = 2 * mbx_, 2 * mby_
                        for k in range(4):
                            mvgrid[by + (k >> 1)][bx + (k & 1)] = \
                                (0, 0)
                    rows.append(row)
                if pkt_start + len(rows) >= nmb:
                    break
            # marker
            mk, mbits = (self._DC_MARKER if vop_type == 0
                         else self._MOTION_MARKER)
            if b.read(mbits) != mk:
                raise ValueError("mpeg4 DP: bad partition marker")
            # ---- partition B --------------------------------- #
            for i, row in enumerate(rows):
                if row.get("skip"):
                    continue
                if vop_type == 0 or row["intra"]:
                    row["ac_pred"] = b.read1()
                    cbpy = _read_lut(b, _CBPY_LUT, 6)
                    row["cbpy"] = cbpy
                    if vop_type != 0:
                        if row["mb_type"] == 4:
                            qscale = _dquant(b, qscale)
                        row["q"] = qscale
                        use_dc = self._dp_use_dc(qscale, dc_thr)
                        row["use_dc"] = use_dc
                        row["dcds"] = [
                            self._read_dc(b, 0 if n < 4 else 1)
                            if use_dc else None for n in range(6)]
                else:
                    cbpy = _read_lut(b, _CBPY_LUT, 6) ^ 0xF
                    row["cbpy"] = cbpy
                    if row["mb_type"] in (1, 5):
                        qscale = _dquant(b, qscale)
                    row["q"] = qscale
            # ---- texture ------------------------------------- #
            for i, row in enumerate(rows):
                idx = pkt_start + i
                mbx_, mby_ = idx % mbw, idx // mbw
                x0, y0 = 16 * mbx_, 16 * mby_
                if row.get("skip"):
                    if self._plan is not None:
                        # inter copy: zero MVs, no residual
                        self._plan['use_f'][idx] = 1
                    else:
                        for p_i, (pl, sh) in enumerate(
                                ((y, 0), (u, 1), (v, 1))):
                            s = 16 >> sh
                            px, py = x0 >> sh, y0 >> sh
                            pl[py:py + s, px:px + s] = \
                                prev[p_i][py:py + s, px:px + s]
                    skipmap[mby_][mbx_] = True
                    continue
                if vop_type == 0 or row["intra"]:
                    self._dp_intra_texture(b, row, mbx_, mby_, y, u,
                                           v, dc_thr, dcs, acs_row,
                                           acs_col, qgrid)
                    continue
                # inter texture
                q = row["q"] if "q" in row else qscale
                mvs = row["mvs"]
                pred_y = np.empty((16, 16), np.int32)
                if self._plan is not None:
                    # device MC: only derive the chroma vector
                    if row["mb_type"] in (2, 5):
                        cmx = dec._round_chroma(
                            sum(m[0] for m in mvs))
                        cmy = dec._round_chroma(
                            sum(m[1] for m in mvs))
                    else:
                        cmx = (mvs[0][0] >> 1) | (mvs[0][0] & 1)
                        cmy = (mvs[0][1] >> 1) | (mvs[0][1] & 1)
                elif row["mb_type"] in (2, 5):
                    for k in range(4):
                        mx, my = mvs[k]
                        sx, sy = x0 + 8 * (k & 1), y0 + 8 * (k >> 1)
                        pred_y[8 * (k >> 1):8 * (k >> 1) + 8,
                               8 * (k & 1):8 * (k & 1) + 8] = \
                            dec._mc_block(refs[0], pad, sx, sy, 8,
                                          mx, my, rounding)
                    sx_ = sum(m[0] for m in mvs)
                    sy_ = sum(m[1] for m in mvs)
                    cmx = dec._round_chroma(sx_)
                    cmy = dec._round_chroma(sy_)
                else:
                    pred_y[:] = dec._mc_block(refs[0], pad, x0, y0,
                                              16, mvs[0][0],
                                              mvs[0][1], rounding)
                    cmx = (mvs[0][0] >> 1) | (mvs[0][0] & 1)
                    cmy = (mvs[0][1] >> 1) | (mvs[0][1] & 1)
                if self._plan is None:
                    pred_u = dec._mc_block(refs[1], pad, x0 >> 1,
                                           y0 >> 1, 8, cmx, cmy,
                                           rounding)
                    pred_v = dec._mc_block(refs[2], pad, x0 >> 1,
                                           y0 >> 1, 8, cmx, cmy,
                                           rounding)
                cbp = (row["cbpy"] << 2) | row["cbpc"]
                blocks = np.zeros((6, 8, 8), np.int64)
                for n in range(6):
                    if (cbp >> (5 - n)) & 1:
                        lv = self._read_block(b, False, _ZIG, 0)
                        blocks[n] = self._dequant(lv, q, False, 0)
                if self._plan is not None:
                    pl = self._plan
                    pl['blocks'][idx] = blocks
                    pl['use_f'][idx] = 1
                    pl['mvs4'][idx] = mvs
                    pl['cmv'][idx] = (cmx, cmy)
                    continue
                pred6 = np.empty((6, 8, 8), np.int32)
                for k in range(4):
                    pred6[k] = pred_y[8 * (k >> 1):
                                      8 * (k >> 1) + 8,
                                      8 * (k & 1):8 * (k & 1) + 8]
                pred6[4] = pred_u
                pred6[5] = pred_v
                out = idct_add_sel(
                    blocks, pred6,
                    [(cbp >> (5 - n)) & 1 for n in range(6)])
                self._luma_store(y, x0, y0, out[:4], 0)
                u[(y0 >> 1):(y0 >> 1) + 8,
                  (x0 >> 1):(x0 >> 1) + 8] = out[4]
                v[(y0 >> 1):(y0 >> 1) + 8,
                  (x0 >> 1):(x0 >> 1) + 8] = out[5]
            mb = pkt_start + len(rows)
        self.last = [y, u, v]
        self._co_mvs = mvgrid
        self._co_skip = skipmap
        self._co_field = [[False] * mbw for _ in range(mbh)]
        self._co_fmvs = [[None] * mbw for _ in range(mbh)]
        self._co_fsels = [[None] * mbw for _ in range(mbh)]

    @staticmethod
    def _dp_use_dc(qscale: int, dc_thr: int) -> bool:
        if dc_thr == 0:
            return True
        if dc_thr == 7:
            return False
        return qscale < T.DC_THRESHOLD[dc_thr]

    def _dp_intra_texture(self, b, row, mbx, mby, y, u, v, dc_thr,
                          dcs, acs_row, acs_col, qgrid) -> None:
        """Intra MB reconstruction from part A DCs + part B flags +
        the texture ACs; the DC/AC gradient prediction runs here in
        raster order exactly like the non-DP path."""
        q = row["q"]
        use_dc = row["use_dc"]
        cbpy = row["cbpy"]
        cbp = (cbpy << 2) | row["cbpc"]
        ac_pred = row["ac_pred"]
        blocks = np.zeros((6, 8, 8), np.int64)
        for n in range(6):
            if n < 4:
                gx = 1 + 2 * mbx + (n & 1)
                gy = 1 + 2 * mby + (n >> 1)
                plane = 0
            else:
                gx = 1 + mbx
                gy = 1 + mby
                plane = n - 3
            g = dcs[plane]
            a = g[gy, gx - 1]
            c = g[gy - 1, gx]
            dgt = g[gy - 1, gx - 1]
            if abs(a - dgt) < abs(dgt - c):
                pred, pdir = c, 1
            else:
                pred, pdir = a, 0
            scale = (T.Y_DC_SCALE if plane == 0
                     else T.C_DC_SCALE)[q]
            pred_q = (pred + (scale >> 1)) // scale
            coded = (cbp >> (5 - n)) & 1
            scan = _ZIG
            if ac_pred:
                scan = _ALT_H if pdir == 1 else _ALT_V
            lv = np.zeros((8, 8), np.int64)
            if coded:
                lv = self._read_block(b, True, scan,
                                      1 if use_dc else 0)
            dcd = row["dcds"][n] if use_dc else int(lv[0, 0])
            dc_q = dcd + pred_q
            dc_val = dc_q * scale
            g[gy, gx] = dc_val
            row_p = acs_row[plane]
            col_p = acs_col[plane]
            qg = qgrid[plane]
            if ac_pred:
                if pdir == 1:
                    nq = int(qg[gy - 1, gx])
                    pv = row_p[gy - 1, gx][1:]
                else:
                    nq = int(qg[gy, gx - 1])
                    pv = col_p[gy, gx - 1][1:]
                if nq and nq != q:
                    num = pv * nq
                    num = np.where(num > 0, num + (q >> 1),
                                   num - (q >> 1))
                    pv = np.sign(num) * (np.abs(num) // q)
                if pdir == 1:
                    lv[0, 1:] += pv
                else:
                    lv[1:, 0] += pv
            coefs = self._dequant(lv, q, True, dc_val)
            row_p[gy, gx] = lv[0]
            col_p[gy, gx] = lv[:, 0]
            qg[gy, gx] = q
            blocks[n] = coefs
        if self._plan is not None:
            idx = mby * self._mbw + mbx
            self._plan['blocks'][idx] = blocks
            self._plan['intra'][idx] = 1
            return
        out = idct_put(blocks)
        x0, y0 = mbx * 16, mby * 16
        self._luma_store(y, x0, y0, out[:4], 0)
        u[mby * 8:mby * 8 + 8, mbx * 8:mbx * 8 + 8] = out[4]
        v[mby * 8:mby * 8 + 8, mbx * 8:mbx * 8 + 8] = out[5]

    # ------------------------------------------------------------ #
    # GMC sprites (S-VOPs, 7.8): every constant below was either
    # recovered from the public libavcodec binary (objdump of
    # mpeg4videodec.o/mpegvideodsp.o — trajectory VLC lens table,
    # virtual-ref weighting, offset/delta/shift construction) or
    # probed with crafted warp streams against the lavc oracle
    # (marker placement, point-accumulation rule: points 1 and 2
    # are each differential from point 0; bilinear rounding
    # S^2/2 - rounding_type).  Bit-exact at sprite_warping_accuracy
    # 3 (what DivX/XviD emit); tested to tolerance elsewhere.
    # ------------------------------------------------------------ #

    _TRAJ_LENS = (2, 3, 3, 3, 3, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12)

    def _read_traj_dmv(self, b: Bits) -> int:
        code = 0
        ln = 0
        for idx, L in enumerate(self._TRAJ_LENS):
            while ln < L:
                code = (code << 1) | b.read1()
                ln += 1
            want = 0 if idx == 0 else (1 + idx if idx <= 5
                                       else (1 << L) - 2)
            if code == want:
                if idx == 0:
                    v = 0
                else:
                    v = b.read(idx)
                    if (v >> (idx - 1)) == 0:
                        v -= (1 << idx) - 1
                if b.read1() != 1:
                    raise ValueError("mpeg4: trajectory marker")
                return v
        raise ValueError("mpeg4: bad trajectory VLC")

    @staticmethod
    def _gmc_rdiv(a: int, b: int) -> int:
        if a >= 0:
            return (a + b // 2) // b
        return -((-a + b // 2) // b)

    def _gmc_setup(self, traj) -> dict:
        vol = self.vol
        n = vol.sprite_points
        acc = vol.sprite_accuracy
        w, h = vol.width, vol.height
        S = 2 << acc
        rho = 3 - acc
        r = 16 // S
        alpha = 1
        while (1 << alpha) < w:
            alpha += 1
        beta = 1
        while (1 << beta) < h:
            beta += 1
        w2, h2 = 1 << alpha, 1 << beta
        rdiv = self._gmc_rdiv
        d0 = traj[0] if n >= 1 else (0, 0)
        d1 = traj[1] if n >= 2 else (0, 0)
        d2 = traj[2] if n >= 3 else (0, 0)
        cum = [(d0[0], d0[1]),
               (d0[0] + d1[0], d0[1] + d1[1]),
               (d0[0] + d2[0], d0[1] + d2[1])]
        F0x = (S // 2) * cum[0][0]
        F0y = (S // 2) * cum[0][1]
        F1x = S * w + (S // 2) * cum[1][0]
        F1y = (S // 2) * cum[1][1]
        F2x = (S // 2) * cum[2][0]
        F2y = S * h + (S // 2) * cum[2][1]
        vr1x = 16 * w2 + rdiv((w - w2) * (r * F0x)
                              + w2 * (r * F1x - 16 * w), w)
        vr1y = rdiv((w - w2) * (r * F0y) + w2 * (r * F1y), w)
        vr2x = rdiv((h - h2) * (r * F0x) + h2 * (r * F2x), h)
        vr2y = 16 * h2 + rdiv((h - h2) * (r * F0y)
                              + h2 * (r * F2y - 16 * h), h)
        P = dict(S=S, n=n, acc=acc)
        if n == 1:
            P["trans"] = cum[0]
            return P
        if n == 2:
            sh = alpha + rho
            dxx = -r * F0x + vr1x
            dyx = r * F0y - vr1y
            D = ((dxx, dyx), (-dyx, dxx))
            k = 1 << alpha
        else:
            min_ab = min(alpha, beta)
            w3, h3 = w2 >> min_ab, h2 >> min_ab
            sh = alpha + beta + rho - min_ab
            D = (((vr1x - r * F0x) * h3, (vr2x - r * F0x) * w3),
                 ((vr1y - r * F0y) * h3, (vr2y - r * F0y) * w3))
            k = 1 << (alpha + beta - min_ab)
        P.update(
            D=D, sh=sh,
            ox=F0x * (1 << sh) + (1 << (sh - 1)),
            oy=F0y * (1 << sh) + (1 << (sh - 1)),
            ocx=(D[0][0] + D[0][1] + 2 * r * k * F0x - 16 * k
                 + (1 << (sh + 1))),
            ocy=(D[1][0] + D[1][1] + 2 * r * k * F0y - 16 * k
                 + (1 << (sh + 1))))
        return P

    @staticmethod
    def _gmc_bilin(ref, vx, vy, S, rnd):
        h, w = ref.shape
        pad = 128
        Pd = np.pad(ref.astype(np.int64), pad, mode="edge")
        ix = np.clip(vx // S, -pad, w + pad - 2)
        iy = np.clip(vy // S, -pad, h + pad - 2)
        fx = np.clip(vx - ix * S, 0, S - 1)
        fy = np.clip(vy - iy * S, 0, S - 1)
        a = Pd[pad + iy, pad + ix]
        bq = Pd[pad + iy, pad + ix + 1]
        c = Pd[pad + iy + 1, pad + ix]
        dd = Pd[pad + iy + 1, pad + ix + 1]
        R = S * S // 2 - rnd
        sh2 = 2 * int(S).bit_length() - 2
        out = ((S - fx) * (S - fy) * a + fx * (S - fy) * bq
               + (S - fx) * fy * c + fx * fy * dd + R) >> sh2
        return np.clip(out, 0, 255).astype(np.uint8)

    def _gmc_warp_planes(self, planes, P, rnd):
        """Whole-frame GMC warp of (y, u, v)."""
        S = P["S"]
        out = []
        for p_i, pl in enumerate(planes):
            h, w = pl.shape
            i = np.arange(w, dtype=np.int64)[None, :]
            j = np.arange(h, dtype=np.int64)[:, None]
            chroma = p_i > 0
            if P["n"] == 1:
                dx, dy = P["trans"]
                if chroma:
                    if S == 2:
                        vx = i * S + ((dx >> 1) | (dx & 1))
                        vy = j * S + ((dy >> 1) | (dy & 1))
                    else:
                        vx = i * S + dx * (S // 4)
                        vy = j * S + dy * (S // 4)
                else:
                    vx = i * S + dx * (S // 2)
                    vy = j * S + dy * (S // 2)
            else:
                (dxx, dxy), (dyx, dyy) = P["D"]
                sh = P["sh"]
                if not chroma:
                    vx = (P["ox"] + dxx * i + dxy * j) >> sh
                    vy = (P["oy"] + dyx * i + dyy * j) >> sh
                else:
                    vx = (P["ocx"] + 4 * (dxx * i + dxy * j)) \
                        >> (sh + 2)
                    vy = (P["ocy"] + 4 * (dyx * i + dyy * j)) \
                        >> (sh + 2)
            out.append(self._gmc_bilin(pl, vx, vy, S, rnd))
        return out

    @staticmethod
    def _gmc_rshift(a: int, b: int) -> int:
        half = (1 << b) >> 1
        if a > 0:
            return (a + half) >> b
        return (a + half - 1) >> b

    def _gmc_amv(self, P, mbx, mby, fcode) -> tuple:
        """The average motion vector of a GMC macroblock (half-pel)
        — feeds the MV predictor grid exactly like lavc's get_amv."""
        acc = P["acc"]
        lim = 1 << (fcode + 4)
        out = []
        if P["n"] == 1:
            # normalized translation offset = trans << acc
            for nn in range(2):
                v = self._gmc_rshift(P["trans"][nn] << acc, acc) \
                    if acc else P["trans"][nn]
                out.append(max(-lim, min(lim - 1, v)))
            return tuple(out)
        sh = P["sh"]
        scale = 16 - sh
        off16 = (P["ox"] << scale, P["oy"] << scale)
        D16 = [[P["D"][r_][c_] << scale for c_ in range(2)]
               for r_ in range(2)]
        xg = np.arange(16, dtype=np.int64)
        for nn in range(2):
            dx = D16[nn][0]
            dy = D16[nn][1]
            if nn:
                dy -= 1 << (16 + acc + 1)
            else:
                dx -= 1 << (16 + acc + 1)
            mb_v = off16[nn] + dx * mbx * 16 + dy * mby * 16
            # per-pixel floor at S precision BEFORE averaging
            # (get_amv's `sum += v >> shift`)
            v = mb_v + dy * xg[:, None] + dx * xg[None, :]
            total = int((v >> 16).sum())
            v = self._gmc_rshift(total, acc + 8)
            out.append(max(-lim, min(lim - 1, v)))
        return tuple(out)

    # ------------------------------------------------------------ #
    # Short video header (H.263 baseline flavor, 6.2.5.2 /
    # Annex of 14496-2; common in 3GP).  Reference parity:
    # import_ffmpeg.c decoded these via libavcodec's h263 path.
    # ------------------------------------------------------------ #

    _SH_FORMATS = {1: (128, 96), 2: (176, 144), 3: (352, 288),
                   4: (704, 576), 5: (1408, 1152)}

    def _read_block_sh(self, b: Bits, first_pos: int) -> np.ndarray:
        """H.263 TCOEF: the MPEG-4 inter RL table with the SINGLE
        H.263 escape (LAST 1, RUN 6, LEVEL signed 8-bit)."""
        lv = np.zeros(64, np.int64)
        pos = first_pos
        while True:
            got = _RL_INTER_LUT[_peek12(b)]
            if got is None:
                raise ValueError("h263: invalid RL code")
            run, level, bits, idx = got
            if bits > b.left:
                raise ValueError("h263: RL code past end")
            b.pos += bits
            if run == "esc":
                last = b.read1()
                run2 = b.read(6)
                val = b.read(8)
                if val in (0, 128):
                    raise ValueError("h263: forbidden escape level")
                if val >= 128:
                    val -= 256
                pos += run2
                if pos > 63:
                    raise ValueError("h263: run past block end")
                lv[_ZIG[pos]] = val
                pos += 1
                if last:
                    break
            else:
                last = idx >= _INTER_LAST0_N
                sign = b.read1()
                pos += run
                if pos > 63:
                    raise ValueError("h263: run past block end")
                lv[_ZIG[pos]] = -level if sign else level
                pos += 1
                if last:
                    break
        return lv.reshape(8, 8)

    def _dequant_h263(self, lv: np.ndarray, q: int,
                      dc: int) -> np.ndarray:
        """H.263 reconstruction: |rec| = q*(2|lv|+1) - (q even);
        INTRADC (when dc != 0 path) = dc*8, no quantizer."""
        add = q - 1 if (q & 1) == 0 else q
        out = np.zeros((8, 8), np.int64)
        nz = lv != 0
        mag = 2 * np.abs(lv) * q + add
        out[nz] = np.sign(lv[nz]) * mag[nz]
        if dc:
            out[0, 0] = dc * 8
        np.clip(out, -2048, 2047, out=out)
        return out

    def _sh_gob_header(self, b: Bits, q: int) -> int:
        """Optional byte-aligned GOB resync at an MB-row start:
        GBSC (16 zeros + 1) + gob_number(5) + gob_frame_id(2) +
        quant(5).  Returns the (possibly updated) quantizer."""
        p = b.pos
        align = (8 - (p & 7)) & 7
        if b.left < align + 22:
            return q
        # GSTUF: zero bits to alignment
        if align and b.peek(align) != 0:
            return q
        save = b.pos
        b.pos = p + align
        if b.peek(17) != 1:
            b.pos = save
            return q
        b.pos += 17
        b.read(5)                    # gob_number
        b.read(2)                    # gob_frame_id
        nq = b.read(5)
        if nq == 0:
            raise ValueError("h263: GOB quant 0")
        return nq

    def decode_short(self, data: bytes):
        """Decode one short-video-header picture; returns (y, u, v)
        display planes (no reorder delay — H.263 baseline has no B
        pictures)."""
        b = Bits(data)
        if b.read(22) != 0x20:
            raise ValueError("h263: bad short_video_start_marker")
        b.read(8)                    # temporal_reference
        if b.read1() != 1:
            raise ValueError("h263: marker bit")
        if b.read1() != 0:
            raise ValueError("h263: zero bit")
        b.read(3)                    # split_screen/doc_camera/freeze
        fmt = b.read(3)
        if fmt not in self._SH_FORMATS:
            raise NotImplementedError(
                f"h263: source format {fmt} (extended PTYPE) is not "
                "supported")
        w, h = self._SH_FORMATS[fmt]
        ptype = b.read1()            # 0 = I, 1 = P
        b.read(4)                    # four_reserved_zero_bits
        q = b.read(5)
        if q == 0:
            raise ValueError("h263: quant 0")
        b.read1()                    # zero bit
        while b.read1():             # PEI
            b.read(8)
        if self.vol is None or self.vol.width != w \
                or not getattr(self.vol, "short_header", False):
            vol = _VOL()
            vol.width, vol.height = w, h
            vol.time_inc_res = 30000
            vol.time_inc_bits = _log2up(30000)
            vol.short_header = True
            self.vol = vol
            self._mbw, self._mbh = w // 16, h // 16
        mbw, mbh = self._mbw, self._mbh
        y = np.zeros((h, w), np.uint8)
        u = np.zeros((h // 2, w // 2), np.uint8)
        v = np.zeros((h // 2, w // 2), np.uint8)
        prev = self.last
        if ptype and prev is None:
            raise ValueError("h263: P picture before I picture")
        pad = 16 + 16
        refs = None if not ptype else \
            [np.pad(pl, pad, mode="edge") for pl in prev]
        mvgrid = [[(0, 0)] * (2 * mbw) for _ in range(2 * mbh)]
        for mby in range(mbh):
            if mby:
                q = self._sh_gob_header(b, q)
            for mbx in range(mbw):
                x0, y0 = 16 * mbx, 16 * mby
                bx, by = 2 * mbx, 2 * mby
                if ptype:
                    if b.read1():            # COD: skip MB
                        for p_i, (pl, sh) in enumerate(
                                ((y, 0), (u, 1), (v, 1))):
                            s = 16 >> sh
                            px, py = x0 >> sh, y0 >> sh
                            pl[py:py + s, px:px + s] = \
                                prev[p_i][py:py + s, px:px + s]
                        continue
                    mb_type, cbpc = _read_lut(b, _MCBPC_P_LUT, 13)
                    while mb_type == -2:     # stuffing
                        mb_type, cbpc = _read_lut(b, _MCBPC_P_LUT,
                                                  13)
                else:
                    mb_type, cbpc = _read_lut(b, _MCBPC_I_LUT, 9)
                    while mb_type == -1:
                        mb_type, cbpc = _read_lut(b, _MCBPC_I_LUT,
                                                  9)
                intra = mb_type in (3, 4)
                cbpy = _read_lut(b, _CBPY_LUT, 6)
                if not intra:
                    cbpy ^= 0xF
                if mb_type in (1, 4):
                    q = _dquant(b, q)
                cbp = (cbpy << 2) | cbpc
                if intra:
                    blocks = np.zeros((6, 8, 8), np.int64)
                    for n in range(6):
                        dcd = b.read(8)
                        if dcd in (0, 128):
                            raise ValueError("h263: bad INTRADC")
                        if dcd == 255:
                            dcd = 128
                        lv = np.zeros((8, 8), np.int64)
                        if (cbp >> (5 - n)) & 1:
                            lv = self._read_block_sh(b, 1)
                        blocks[n] = self._dequant_h263(lv, q, dcd)
                    out = idct_put(blocks)
                    self._luma_store(y, x0, y0, out[:4], 0)
                    u[mby * 8:mby * 8 + 8,
                      mbx * 8:mbx * 8 + 8] = out[4]
                    v[mby * 8:mby * 8 + 8,
                      mbx * 8:mbx * 8 + 8] = out[5]
                    for k in range(4):
                        mvgrid[by + (k >> 1)][bx + (k & 1)] = (0, 0)
                    continue
                # inter MB: one MV, H.263 predictors == MPEG-4 1MV
                px_, py_ = self._pred_mv(mvgrid, bx, by, 0)
                mx = self._decode_mv_component(b, 1, px_)
                my = self._decode_mv_component(b, 1, py_)
                for k in range(4):
                    mvgrid[by + (k >> 1)][bx + (k & 1)] = (mx, my)
                pred_y = self._mc_block(refs[0], pad, x0, y0, 16,
                                        mx, my, 0)
                cmx = (mx >> 1) | (mx & 1)
                cmy = (my >> 1) | (my & 1)
                pred_u = self._mc_block(refs[1], pad, x0 >> 1,
                                        y0 >> 1, 8, cmx, cmy, 0)
                pred_v = self._mc_block(refs[2], pad, x0 >> 1,
                                        y0 >> 1, 8, cmx, cmy, 0)
                blocks = np.zeros((6, 8, 8), np.int64)
                for n in range(6):
                    if (cbp >> (5 - n)) & 1:
                        lv = self._read_block_sh(b, 0)
                        blocks[n] = self._dequant_h263(lv, q, 0)
                pred6 = np.empty((6, 8, 8), np.int32)
                for k in range(4):
                    pred6[k] = pred_y[8 * (k >> 1):8 * (k >> 1) + 8,
                                      8 * (k & 1):8 * (k & 1) + 8]
                pred6[4] = pred_u
                pred6[5] = pred_v
                out = idct_add_sel(
                    blocks, pred6,
                    [(cbp >> (5 - n)) & 1 for n in range(6)])
                self._luma_store(y, x0, y0, out[:4], 0)
                u[(y0 >> 1):(y0 >> 1) + 8,
                  (x0 >> 1):(x0 >> 1) + 8] = out[4]
                v[(y0 >> 1):(y0 >> 1) + 8,
                  (x0 >> 1):(x0 >> 1) + 8] = out[5]
        self.last = [y, u, v]
        return self._crop_planes([y, u, v])

    # ------------------------------------------------------------ #
    # I-VOP
    # ------------------------------------------------------------ #

    def _decode_ivop(self, b: Bits, qscale: int, dc_thr: int) -> None:
        vol = self.vol
        mbw, mbh = self._mbw, self._mbh
        W, H = mbw * 16, mbh * 16
        y = np.zeros((H, W), np.uint8)
        u = np.zeros((H // 2, W // 2), np.uint8)
        v = np.zeros((H // 2, W // 2), np.uint8)
        # DC/AC prediction stores: per block position grids
        dcs, acs_row, acs_col, qgrid = self._fresh_pred_grids()

        for mby in range(mbh):
            for mbx in range(mbw):
                nq = self._resync(b, 16, mby * mbw + mbx)
                if nq is not None:
                    qscale = nq
                    dcs, acs_row, acs_col, qgrid = \
                        self._fresh_pred_grids()
                mb_type, cbpc = _read_lut(b, _MCBPC_I_LUT, 9)
                while mb_type == -1:      # stuffing row
                    mb_type, cbpc = _read_lut(b, _MCBPC_I_LUT, 9)
                ac_pred = b.read1()
                cbpy = _read_lut(b, _CBPY_LUT, 6)
                if mb_type == 4:
                    qscale = _dquant(b, qscale)
                dct_type = b.read1() if vol.interlaced else 0
                cbp = (cbpy << 2) | cbpc
                self._intra_mb(b, y, u, v, mbx, mby, qscale, cbp,
                               ac_pred, dc_thr, dcs, acs_row,
                               acs_col, qgrid, intra_vop=True,
                               dct_type=dct_type)
        self.last = [y, u, v]
        self._co_mvs = [[(0, 0)] * (2 * mbw) for _ in range(2 * mbh)]
        self._co_skip = [[False] * mbw for _ in range(mbh)]
        self._co_field = [[False] * mbw for _ in range(mbh)]
        self._co_fmvs = [[None] * mbw for _ in range(mbh)]
        self._co_fsels = [[None] * mbw for _ in range(mbh)]

    def _intra_mb(self, b, y, u, v, mbx, mby, qscale, cbp, ac_pred,
                  dc_thr, dcs, acs_row, acs_col, qgrid,
                  intra_vop, dct_type=0) -> None:
        vol = self.vol
        use_dc_vlc = qscale < T.DC_THRESHOLD[dc_thr] \
            if dc_thr != 0 else True
        if dc_thr == 7:
            use_dc_vlc = False
        blocks = np.zeros((6, 8, 8), np.int64)
        for n in range(6):
            comp = 0 if n < 4 else 1
            # block position in the prediction grid
            if n < 4:
                gx = 1 + 2 * mbx + (n & 1)
                gy = 1 + 2 * mby + (n >> 1)
                plane = 0
            else:
                gx = 1 + mbx
                gy = 1 + mby
                plane = n - 3            # 1 = Cb, 2 = Cr
            g = dcs[plane]
            # DC prediction by gradient
            a = g[gy, gx - 1]            # left
            c = g[gy - 1, gx]            # top
            dgt = g[gy - 1, gx - 1]      # top-left
            if abs(a - dgt) < abs(dgt - c):
                pred, pdir = c, 1        # predict from top
            else:
                pred, pdir = a, 0        # from left
            scale = (T.Y_DC_SCALE if plane == 0
                     else T.C_DC_SCALE)[qscale]
            pred_q = (pred + (scale >> 1)) // scale
            coded = (cbp >> (5 - n)) & 1
            if use_dc_vlc:
                dcd = self._read_dc(b, comp)
            else:
                dcd = 0
            if self._alt_scan:
                # alternate_vertical_scan_flag overrides the
                # ac_pred-adaptive scan for every block
                scan = _ALT_V
            else:
                scan = _ZIG
                if ac_pred:
                    scan = _ALT_H if pdir == 1 else _ALT_V
            lv = np.zeros((8, 8), np.int64)
            if coded:
                lv = self._read_block(b, True, scan,
                                      1 if use_dc_vlc else 0)
            if not use_dc_vlc:
                dcd = int(lv[0, 0])
            dc_q = dcd + pred_q
            dc_val = dc_q * scale
            g[gy, gx] = dc_val
            # AC prediction (rescaled when the neighbour's qscale
            # differs: pred = ROUNDED_DIV(ac * nq, q))
            row_p = acs_row[plane]
            col_p = acs_col[plane]
            qg = qgrid[plane]
            if ac_pred:
                if pdir == 1:            # from top: first row
                    nq = int(qg[gy - 1, gx])
                    pv = row_p[gy - 1, gx][1:]
                else:                    # from left: first column
                    nq = int(qg[gy, gx - 1])
                    pv = col_p[gy, gx - 1][1:]
                if nq and nq != qscale:
                    num = pv * nq
                    num = np.where(num > 0, num + (qscale >> 1),
                                   num - (qscale >> 1))
                    # C division truncates toward zero
                    pv = np.sign(num) * (np.abs(num) // qscale)
                if pdir == 1:
                    lv[0, 1:] += pv
                else:
                    lv[1:, 0] += pv
            coefs = self._dequant(lv, qscale, True, dc_val)
            row_p[gy, gx] = lv[0]
            col_p[gy, gx] = lv[:, 0]
            qg[gy, gx] = qscale
            blocks[n] = coefs
        if self._plan is not None:
            idx = mby * self._mbw + mbx
            self._plan['blocks'][idx] = blocks
            self._plan['intra'][idx] = 1
            return
        out = idct_put(blocks)
        x0, y0 = mbx * 16, mby * 16
        self._luma_store(y, x0, y0, out[:4], dct_type)
        u[mby * 8:mby * 8 + 8, mbx * 8:mbx * 8 + 8] = out[4]
        v[mby * 8:mby * 8 + 8, mbx * 8:mbx * 8 + 8] = out[5]

    @staticmethod
    def _luma_store(y, x0, y0, out4, dct_type) -> None:
        """Place 4 decoded luma blocks: quadrants (frame DCT) or
        field-interleaved rows (dct_type=1: blocks 0/1 = top-field
        lines, 2/3 = bottom-field lines)."""
        if not dct_type:
            for k in range(4):
                y[y0 + 8 * (k >> 1):y0 + 8 * (k >> 1) + 8,
                  x0 + 8 * (k & 1):x0 + 8 * (k & 1) + 8] = out4[k]
            return
        for k in range(4):
            y[y0 + (k >> 1):y0 + 16:2,
              x0 + 8 * (k & 1):x0 + 8 * (k & 1) + 8] = out4[k]

    @staticmethod
    def _luma_split(pred_y, dct_type) -> list:
        """16x16 luma prediction -> 4 blocks in the order the
        residual blocks apply (inverse of _luma_store)."""
        if not dct_type:
            return [pred_y[8 * (k >> 1):8 * (k >> 1) + 8,
                           8 * (k & 1):8 * (k & 1) + 8]
                    for k in range(4)]
        return [pred_y[(k >> 1)::2, 8 * (k & 1):8 * (k & 1) + 8]
                for k in range(4)]

    # ------------------------------------------------------------ #
    # P-VOP (filled in below)
    # ------------------------------------------------------------ #

    # ------------------------------------------------------------ #
    # Motion
    # ------------------------------------------------------------ #

    @staticmethod
    def _decode_mv_component(b: Bits, fcode: int, pred: int) -> int:
        sym = _read_lut(b, _MV_LUT, 13)
        if sym == 0:
            val = 0
        else:
            sign = b.read1()
            shift = fcode - 1
            val = sym
            if shift:
                val = ((val - 1) << shift) | b.read(shift)
                val += 1
            if sign:
                val = -val
        val += pred
        # modulo wrap into [-32<<shift, (32<<shift)-1]
        shift = fcode - 1
        low = -(32 << shift)
        high = (32 << shift) - 1
        if val < low:
            val += 64 << shift
        elif val > high:
            val -= 64 << shift
        return val

    @staticmethod
    def _median3(a, c, b_):
        return min(max(a, c), max(min(a, c), b_))

    def _pred_mv(self, mvgrid, bx, by, blk, pkt_start=0):
        """Median MV prediction (14496-2 7.6.5): candidate blocks per
        position with border substitution rules.  Candidates in MBs
        before `pkt_start` (a previous video packet) are unavailable,
        as if outside the VOP."""
        mbw2 = 2 * self._mbw
        mbw = self._mbw
        def get(x, y):
            if x < 0 or y < 0 or x >= mbw2:
                return None
            if (y >> 1) * mbw + (x >> 1) < pkt_start:
                return None
            return mvgrid[y][x]
        if blk == 0:
            A = get(bx - 1, by)
            B = get(bx, by - 1)
            C = get(bx + 2, by - 1)
        elif blk == 1:
            A = get(bx - 1, by)
            B = get(bx, by - 1)
            C = get(bx + 1, by - 1)
        elif blk == 2:
            # C = block 1 of the SAME MB (7.6.5: MV2's third
            # candidate is MV1, not the un-decoded right neighbour)
            A = get(bx - 1, by)
            B = get(bx, by - 1)
            C = get(bx + 1, by - 1)
        else:
            A = get(bx - 1, by)
            B = get(bx, by - 1)
            C = get(bx - 1, by - 1)
        # border rules: all out -> 0; top row -> pred = A; left ->
        # A = 0; right C out -> C = 0
        if A is None and B is None and C is None:
            return 0, 0
        if B is None and C is None:
            return A
        if A is None:
            A = (0, 0)
        if B is None:
            B = (0, 0)
        if C is None:
            C = (0, 0)
        return (self._median3(A[0], B[0], C[0]),
                self._median3(A[1], B[1], C[1]))

    @staticmethod
    def _round_chroma(x: int) -> int:
        return T.CHROMA_ROUNDTAB[x & 0xF] + ((x >> 3) & ~1)

    @staticmethod
    def _mc_block(ref_pad: np.ndarray, pad: int, x0: int, y0: int,
                  sz: int, mvx: int, mvy: int, rnd: int) -> np.ndarray:
        """Half-pel MC: (a+b+1-rnd)>>1 two-tap, (a+b+c+d+2-rnd)>>2
        four-tap."""
        wx, wy = mvx >> 1, mvy >> 1
        hx, hy = mvx & 1, mvy & 1
        gy, gx = y0 + wy + pad, x0 + wx + pad
        p00 = ref_pad[gy:gy + sz, gx:gx + sz].astype(np.int32)
        if not hx and not hy:
            return p00
        if hx and not hy:
            p01 = ref_pad[gy:gy + sz, gx + 1:gx + 1 + sz]
            return (p00 + p01 + 1 - rnd) >> 1
        if hy and not hx:
            p10 = ref_pad[gy + 1:gy + 1 + sz, gx:gx + sz]
            return (p00 + p10 + 1 - rnd) >> 1
        p01 = ref_pad[gy:gy + sz, gx + 1:gx + 1 + sz]
        p10 = ref_pad[gy + 1:gy + 1 + sz, gx:gx + sz]
        p11 = ref_pad[gy + 1:gy + 1 + sz, gx + 1:gx + 1 + sz]
        return (p00 + p01.astype(np.int32) + p10 + p11 + 2 - rnd) >> 2

    @staticmethod
    def _mc_rect(ref_pad: np.ndarray, pad: int, x0: int, y0: int,
                 w: int, h: int, mvx: int, mvy: int,
                 rnd: int) -> np.ndarray:
        """Rectangular half-pel MC (field prediction blocks are
        16x8 luma / 8x4 chroma in field coordinates)."""
        wx, wy = mvx >> 1, mvy >> 1
        hx, hy = mvx & 1, mvy & 1
        gy, gx = y0 + wy + pad, x0 + wx + pad
        p00 = ref_pad[gy:gy + h, gx:gx + w].astype(np.int32)
        if not hx and not hy:
            return p00
        if hx and not hy:
            p01 = ref_pad[gy:gy + h, gx + 1:gx + 1 + w]
            return (p00 + p01 + 1 - rnd) >> 1
        if hy and not hx:
            p10 = ref_pad[gy + 1:gy + 1 + h, gx:gx + w]
            return (p00 + p10 + 1 - rnd) >> 1
        p01 = ref_pad[gy:gy + h, gx + 1:gx + 1 + w]
        p10 = ref_pad[gy + 1:gy + 1 + h, gx:gx + w]
        p11 = ref_pad[gy + 1:gy + 1 + h, gx + 1:gx + 1 + w]
        return (p00 + p01.astype(np.int32) + p10 + p11 + 2 - rnd) >> 2

    @staticmethod
    def _cdiv2(v: int) -> int:
        """C-style truncating division by two (field MV predictor
        halving and field chroma MV derivation use trunc, NOT the
        |1 rounding map — mpeg_motion_field disassembly)."""
        return v // 2 if v >= 0 else -((-v) // 2)

    def _field_pred_mb(self, frefs_f, pad, x0, y0, fmvs, fsels,
                       rnd) -> tuple:
        """Field-predicted 16x16 MB (7.6.2): per field i a 16x8 luma
        block from reference field fsels[i] at field-unit half-pel
        fmvs[i], plus 8x4 chroma per field with (m>>1)|(m&1)
        round-to-half chroma vectors (probed empirically — C
        truncation diverges on odd components).  frefs_f =
        [[top,bot] luma, [top,bot] cb, [top,bot] cr] frame-space
        padded field views."""
        pred_y = np.empty((16, 16), np.int32)
        pred_u = np.empty((8, 8), np.int32)
        pred_v = np.empty((8, 8), np.int32)
        for i in range(2):
            mx, my = fmvs[i]
            fs = fsels[i]
            pred_y[i::2] = self._mc_rect(frefs_f[0][fs], pad,
                                         x0, y0 >> 1, 16, 8,
                                         mx, my, rnd)
            cmx = (mx >> 1) | (mx & 1)
            cmy = (my >> 1) | (my & 1)
            pred_u[i::2] = self._mc_rect(frefs_f[1][fs], pad,
                                         x0 >> 1, y0 >> 2, 8, 4,
                                         cmx, cmy, rnd)
            pred_v[i::2] = self._mc_rect(frefs_f[2][fs], pad,
                                         x0 >> 1, y0 >> 2, 8, 4,
                                         cmx, cmy, rnd)
        return pred_y, pred_u, pred_v

    @staticmethod
    def _field_pad(planes, pad) -> list:
        """[y,u,v] frame planes -> [[top,bot], ...] padded field
        views.  Padding replicates in FRAME space (the runtime
        reference draw_edges the frame, then strides into it), so a
        field read past the bottom picks up the frame's LAST row — a
        bottom-field line — for BOTH fields, not the field's own
        last line (verified empirically: field-space padding
        diverges on every bottom-row field MB)."""
        out = []
        for pl in planes:
            fp = np.pad(pl, ((2 * pad, 2 * pad), (pad, pad)),
                        mode="edge")
            out.append([fp[k::2] for k in range(2)])
        return out

    # -------------------------------------------------------------- #
    # Quarter-pel MC (7.6.7 quarter sample mode).  The composition
    # below was DERIVED EMPIRICALLY against libavcodec with crafted
    # constant-MV/no-residual P-VOPs (one probe stream per phase —
    # the single-coefficient-probe method from io/dvdec.py): the
    # 8-tap [-1,3,-6,20,20,-6,3,-1]/32 filter runs per block over a
    # (s+1)-sample window with MIRRORED extension at the block edges
    # (i<0 -> -i-1, i>s -> 2s+1-i), horizontal stage FIRST over all
    # s+1 rows, then the vertical stage (filter + bilinear quarter
    # averaging) on those clipped intermediates.  All 16 phases and
    # both rounding types verified exact; naive whole-frame filtering
    # diverges at every block boundary.
    # -------------------------------------------------------------- #

    @staticmethod
    def _qpel_lowpass(block: np.ndarray, s: int, rnd: int
                      ) -> np.ndarray:
        """(rows, s+1) mirrored block -> (rows, s) at x+1/2."""
        idx = _qpel_idx(s)
        v = block[:, idx] @ _QPEL_TAPS
        return np.clip((v + 16 - rnd) >> 5, 0, 255)

    @classmethod
    def _mc_block_qpel(cls, ref_pad: np.ndarray, pad: int, x0: int,
                       y0: int, s: int, mvx: int, mvy: int,
                       rnd: int) -> np.ndarray:
        wx, wy = mvx >> 2, mvy >> 2
        hx, hy = mvx & 3, mvy & 3
        gy, gx = y0 + wy + pad, x0 + wx + pad
        blk = ref_pad[gy:gy + s + 1, gx:gx + s + 1].astype(np.int32)
        if hx == 0:
            col = blk[:, :s] if hy else blk[:s, :s]
        else:
            hh = cls._qpel_lowpass(blk, s, rnd)
            if hx == 2:
                col = hh
            elif hx == 1:
                col = (blk[:, :s] + hh + 1 - rnd) >> 1
            else:
                col = (blk[:, 1:s + 1] + hh + 1 - rnd) >> 1
            if not hy:
                col = col[:s]
        if hy == 0:
            return col
        hv = cls._qpel_lowpass(np.ascontiguousarray(col.T), s, rnd).T
        if hy == 2:
            return hv
        if hy == 1:
            return (col[:s] + hv + 1 - rnd) >> 1
        return (col[1:s + 1] + hv + 1 - rnd) >> 1

    @staticmethod
    def _qpel_chroma_1mv(m: int) -> int:
        """qpel luma MV -> chroma half-pel: C-truncating /2 then the
        H.263 rounding (probed exact over [-8, 12])."""
        t = -((-m) // 2) if m < 0 else m // 2
        return (t >> 1) | (t & 1)

    @staticmethod
    def _trunc2(m: int) -> int:
        return -((-m) // 2) if m < 0 else m // 2

    def _decode_pvop(self, b, qscale, dc_thr, fcode, rounding,
                     svop_traj=None):
        vol = self.vol
        mbw, mbh = self._mbw, self._mbh
        W, H = mbw * 16, mbh * 16
        prev = self.last
        pad = 16 + (32 << (fcode - 1)) // 2
        refs = None if self._plan is not None else \
            [np.pad(pl, pad, mode="edge") for pl in prev]
        gmc_P = gw = None
        if svop_traj is not None:
            gmc_P = self._gmc_setup(svop_traj)
            gw = self._gmc_warp_planes(prev, gmc_P, rounding)
        y = np.zeros((H, W), np.uint8)
        u = np.zeros((H // 2, W // 2), np.uint8)
        v = np.zeros((H // 2, W // 2), np.uint8)
        dcs = [np.full((2 * mbh + 1, 2 * mbw + 2), 1024, np.int64)
               for _ in range(3)]
        acs_row = [np.zeros((2 * mbh + 1, 2 * mbw + 2, 8), np.int64)
                   for _ in range(3)]
        acs_col = [np.zeros((2 * mbh + 1, 2 * mbw + 2, 8), np.int64)
                   for _ in range(3)]
        qgrid = [np.zeros((2 * mbh + 1, 2 * mbw + 2), np.int64)
                 for _ in range(3)]
        # per-block MV grid for prediction (None = not yet decoded)
        mvgrid = [[(0, 0)] * (2 * mbw) for _ in range(2 * mbh)]
        skipmap = [[False] * mbw for _ in range(mbh)]
        fieldmap = [[False] * mbw for _ in range(mbh)]
        fmvtab = [[None] * mbw for _ in range(mbh)]
        fseltab = [[None] * mbw for _ in range(mbh)]
        refs_f = None                    # lazy padded field planes
        pkt_start = 0                    # first MB of current packet

        for mby in range(mbh):
            for mbx in range(mbw):
                x0, y0 = 16 * mbx, 16 * mby
                bx, by = 2 * mbx, 2 * mby
                nq = self._resync(b, fcode + 15, mby * mbw + mbx)
                if nq is not None:
                    qscale = nq
                    pkt_start = mby * mbw + mbx
                    dcs, acs_row, acs_col, qgrid = \
                        self._fresh_pred_grids()
                if b.read1():                   # not_coded: skip MB
                    if gw is not None:
                        # S-VOP skip = GMC prediction, no residual
                        for p, (pl, sh) in enumerate(((y, 0),
                                                      (u, 1),
                                                      (v, 1))):
                            s = 16 >> sh
                            px, py = x0 >> sh, y0 >> sh
                            pl[py:py + s, px:px + s] = \
                                gw[p][py:py + s, px:px + s]
                        amv = self._gmc_amv(gmc_P, mbx, mby, fcode)
                        for k in range(4):
                            mvgrid[by + (k >> 1)][bx + (k & 1)] = \
                                amv
                        continue
                    if self._plan is not None:
                        # inter copy: zero MVs, no residual
                        self._plan['use_f'][mby * mbw + mbx] = 1
                    else:
                        for p, (pl, sh) in enumerate(((y, 0),
                                                      (u, 1),
                                                      (v, 1))):
                            s = 16 >> sh
                            px, py = x0 >> sh, y0 >> sh
                            pl[py:py + s, px:px + s] = \
                                prev[p][py:py + s, px:px + s]
                    skipmap[mby][mbx] = True
                    continue
                mb_type, cbpc = _read_lut(b, _MCBPC_P_LUT, 13)
                while mb_type == -2:            # stuffing
                    mb_type, cbpc = _read_lut(b, _MCBPC_P_LUT, 13)
                intra = mb_type in (3, 4)
                mcsel = False
                if gw is not None and not intra \
                        and mb_type in (0, 1):
                    mcsel = b.read1() == 1
                ac_pred = 0
                if intra:
                    ac_pred = b.read1()
                cbpy = _read_lut(b, _CBPY_LUT, 6)
                if not intra:
                    cbpy ^= 0xF
                if mb_type in (1, 4, 5):
                    qscale = _dquant(b, qscale)
                if mb_type == 5:
                    mb_type = 2                # 4MV with dquant
                cbp = (cbpy << 2) | cbpc
                # interlaced_information() (6.2.7.3): dct_type for
                # intra-or-coded MBs, then the field prediction
                # flag + field selects for 16x16 inter MBs
                dct_type = 0
                field_mc = False
                fsels = None
                if vol.interlaced:
                    if intra or cbp:
                        dct_type = b.read1()
                    if not intra and mb_type != 2 and not mcsel \
                            and b.read1():
                        field_mc = True
                        fsels = (b.read1(), b.read1())
                if intra:
                    self._intra_mb(b, y, u, v, mbx, mby, qscale, cbp,
                                   ac_pred, dc_thr, dcs, acs_row,
                                   acs_col, qgrid, intra_vop=False,
                                   dct_type=dct_type)
                    continue
                # motion vectors
                if mcsel:
                    amv = self._gmc_amv(gmc_P, mbx, mby, fcode)
                    mvs = [amv] * 4
                    for k in range(4):
                        mvgrid[by + (k >> 1)][bx + (k & 1)] = amv
                elif field_mc:
                    if vol.quarter_sample:
                        raise NotImplementedError(
                            "mpeg4: quarter-sample field prediction")
                    px_, py_ = self._pred_mv(mvgrid, bx, by, 0,
                                             pkt_start)
                    hpy = self._cdiv2(py_)
                    fmvs = []
                    for i in range(2):
                        fmx = self._decode_mv_component(b, fcode,
                                                        px_)
                        fmy = self._decode_mv_component(b, fcode,
                                                        hpy)
                        fmvs.append((fmx, fmy))
                    # neighbour-prediction value: |1-rounded average
                    # of the field mx, SUM of the field-unit my
                    # (== frame-unit average; ff_h263_update_motion_val)
                    sx_ = fmvs[0][0] + fmvs[1][0]
                    avg = ((sx_ >> 1) | (sx_ & 1),
                           fmvs[0][1] + fmvs[1][1])
                    mvs = [avg] * 4
                    for k in range(4):
                        mvgrid[by + (k >> 1)][bx + (k & 1)] = avg
                    fieldmap[mby][mbx] = True
                    fmvtab[mby][mbx] = list(fmvs)
                    fseltab[mby][mbx] = fsels
                elif mb_type == 2:              # 4MV
                    mvs = []
                    for k in range(4):
                        px_, py_ = self._pred_mv(
                            mvgrid, bx + (k & 1), by + (k >> 1), k,
                            pkt_start)
                        mx = self._decode_mv_component(b, fcode, px_)
                        my = self._decode_mv_component(b, fcode, py_)
                        mvs.append((mx, my))
                        mvgrid[by + (k >> 1)][bx + (k & 1)] = (mx, my)
                else:                           # 1MV
                    px_, py_ = self._pred_mv(mvgrid, bx, by, 0,
                                             pkt_start)
                    mx = self._decode_mv_component(b, fcode, px_)
                    my = self._decode_mv_component(b, fcode, py_)
                    mvs = [(mx, my)] * 4
                    for k in range(4):
                        mvgrid[by + (k >> 1)][bx + (k & 1)] = (mx, my)
                # luma MC
                qpel = vol.quarter_sample
                mc_l = self._mc_block_qpel if qpel else self._mc_block
                pred_y = np.empty((16, 16), np.int32)
                if self._plan is not None:
                    pass                        # device MC
                elif mcsel:
                    pred_y[:] = gw[0][y0:y0 + 16, x0:x0 + 16]
                elif field_mc:
                    if refs_f is None:
                        refs_f = self._field_pad(prev, pad)
                    pred_y, pred_u, pred_v = self._field_pred_mb(
                        refs_f, pad, x0, y0, fmvs, fsels, rounding)
                elif mb_type == 2:
                    for k in range(4):
                        mx, my = mvs[k]
                        sx, sy = x0 + 8 * (k & 1), y0 + 8 * (k >> 1)
                        pred_y[8 * (k >> 1):8 * (k >> 1) + 8,
                               8 * (k & 1):8 * (k & 1) + 8] = \
                            mc_l(refs[0], pad, sx, sy, 8,
                                 mx, my, rounding)
                else:
                    pred_y[:] = mc_l(refs[0], pad, x0, y0,
                                     16, mvs[0][0],
                                     mvs[0][1], rounding)
                # chroma MV derivation (field MC derives its own)
                if field_mc:
                    cmx = cmy = 0
                elif mb_type == 2:
                    if qpel:
                        # per-block C-truncated /2 BEFORE summing
                        # (probed exact; trunc-of-sum diverges when
                        # the blocks' parities differ)
                        sx = sum(self._trunc2(m[0]) for m in mvs)
                        sy = sum(self._trunc2(m[1]) for m in mvs)
                    else:
                        sx = sum(m[0] for m in mvs)
                        sy = sum(m[1] for m in mvs)
                    cmx = self._round_chroma(sx)
                    cmy = self._round_chroma(sy)
                elif qpel:
                    cmx = self._qpel_chroma_1mv(mvs[0][0])
                    cmy = self._qpel_chroma_1mv(mvs[0][1])
                else:
                    cmx = (mvs[0][0] >> 1) | (mvs[0][0] & 1)
                    cmy = (mvs[0][1] >> 1) | (mvs[0][1] & 1)
                if mcsel and self._plan is None:
                    pred_u = gw[1][(y0 >> 1):(y0 >> 1) + 8,
                                   (x0 >> 1):(x0 >> 1) + 8] \
                        .astype(np.int32)
                    pred_v = gw[2][(y0 >> 1):(y0 >> 1) + 8,
                                   (x0 >> 1):(x0 >> 1) + 8] \
                        .astype(np.int32)
                elif not field_mc and self._plan is None:
                    pred_u = self._mc_block(refs[1], pad, x0 >> 1,
                                            y0 >> 1, 8, cmx, cmy,
                                            rounding)
                    pred_v = self._mc_block(refs[2], pad, x0 >> 1,
                                            y0 >> 1, 8, cmx, cmy,
                                            rounding)
                # residual blocks
                iscan = _ALT_V if self._alt_scan else _ZIG
                blocks = np.zeros((6, 8, 8), np.int64)
                for n in range(6):
                    if (cbp >> (5 - n)) & 1:
                        lv = self._read_block(b, False, iscan, 0)
                        blocks[n] = self._dequant(lv, qscale, False,
                                                  0)
                if self._plan is not None:
                    idx = mby * mbw + mbx
                    pl = self._plan
                    pl['blocks'][idx] = blocks
                    pl['use_f'][idx] = 1
                    pl['mvs4'][idx] = mvs
                    pl['cmv'][idx] = (cmx, cmy)
                    continue
                pred6 = np.empty((6, 8, 8), np.int32)
                for k, blk in enumerate(self._luma_split(pred_y,
                                                         dct_type)):
                    pred6[k] = blk
                pred6[4] = pred_u
                pred6[5] = pred_v
                out = idct_add_sel(blocks, pred6,
                                   [(cbp >> (5 - n)) & 1
                                    for n in range(6)])
                self._luma_store(y, x0, y0, out[:4], dct_type)
                u[(y0 >> 1):(y0 >> 1) + 8,
                  (x0 >> 1):(x0 >> 1) + 8] = out[4]
                v[(y0 >> 1):(y0 >> 1) + 8,
                  (x0 >> 1):(x0 >> 1) + 8] = out[5]
        self.last = [y, u, v]
        self._co_mvs = mvgrid
        self._co_skip = skipmap
        self._co_field = fieldmap
        self._co_fmvs = fmvtab
        self._co_fsels = fseltab

    # ------------------------------------------------------------ #
    # B-VOP
    # ------------------------------------------------------------ #

    def _decode_bvop(self, b, qscale, fcode_f, fcode_b):
        vol = self.vol
        mbw, mbh = self._mbw, self._mbh
        W, H = mbw * 16, mbh * 16
        fwd_ref, bwd_ref = self._older, self.last
        pad = 16 + (32 << (max(fcode_f, fcode_b) - 1)) // 2
        if self._plan is not None:
            frefs = brefs = None
        else:
            frefs = [np.pad(pl, pad, mode="edge") for pl in fwd_ref]
            brefs = [np.pad(pl, pad, mode="edge") for pl in bwd_ref]
        y = np.zeros((H, W), np.uint8)
        u = np.zeros((H // 2, W // 2), np.uint8)
        v = np.zeros((H // 2, W // 2), np.uint8)
        trb, trd = self._pb_time, self._pp_time
        if trd <= 0:
            trd = 1
        co_mvs = self._co_mvs or \
            [[(0, 0)] * (2 * mbw) for _ in range(2 * mbh)]
        co_skip = self._co_skip or [[False] * mbw
                                    for _ in range(mbh)]
        self._bf_refs = [None, None]     # lazy padded field planes
        self._bf_srcs = (fwd_ref, bwd_ref, pad)

        qpel = vol.quarter_sample
        mc_l = self._mc_block_qpel if qpel else self._mc_block
        if qpel:
            chroma_mv = self._qpel_chroma_1mv
        else:
            def chroma_mv(m):
                return (m >> 1) | (m & 1)

        def avg_bidir(a, bb):
            return (a + bb + 1) >> 1

        for mby in range(mbh):
            # B-VOP MV predictors reset per MB row: last_mv[dir][fld]
            lm = [[[0, 0], [0, 0]], [[0, 0], [0, 0]]]
            for mbx in range(mbw):
                x0, y0 = 16 * mbx, 16 * mby
                nq = self._resync(b, max(fcode_f, fcode_b, 2) + 15,
                                  mby * mbw + mbx)
                if nq is not None:
                    qscale = nq
                    lm = [[[0, 0], [0, 0]], [[0, 0], [0, 0]]]
                if co_skip[mby][mbx]:
                    # co-located P MB skipped: this MB has NO bits
                    # (direct, zero motion, not coded)
                    self._b_direct(b, frefs, brefs, pad, x0, y0,
                                   (0, 0), co_mvs, mbx, mby, trb,
                                   trd, 0, qscale, y, u, v,
                                   read_blocks=False)
                    continue
                if b.read1():              # modb == '1': direct,
                    self._b_direct(b, frefs, brefs, pad, x0, y0,
                                   None, co_mvs, mbx, mby, trb, trd,
                                   0, qscale, y, u, v,
                                   read_blocks=False)
                    continue
                modb2 = b.read1()
                mb_type = _read_lut(b, _MBTYPE_B_LUT, 4)
                cbp = 0 if modb2 else b.read(6)
                if mb_type != 0 and cbp:
                    # DBQUANT: "0"=0, "10"=-2, "11"=+2
                    if b.read1():
                        qscale = max(1, min(31, qscale
                                            + (2 if b.read1()
                                               else -2)))
                # interlaced_information(): dct_type for coded MBs
                # (direct included), field flag + per-direction
                # selects for non-direct MBs
                dct_type = 0
                field_pr = False
                fsf = fsb = None
                if vol.interlaced:
                    if cbp:
                        dct_type = b.read1()
                    if mb_type != 0 and b.read1():
                        field_pr = True
                        if mb_type in (1, 3):
                            fsf = (b.read1(), b.read1())
                        if mb_type in (1, 2):
                            fsb = (b.read1(), b.read1())
                if mb_type == 0:           # direct (with delta MV)
                    dmx = self._decode_mv_component(b, 1, 0)
                    dmy = self._decode_mv_component(b, 1, 0)
                    self._b_direct(b, frefs, brefs, pad, x0, y0,
                                   (dmx, dmy), co_mvs, mbx, mby,
                                   trb, trd, cbp, qscale, y, u, v,
                                   read_blocks=True,
                                   dct_type=dct_type)
                    continue
                fmvs_f = fmvs_b = None
                if mb_type in (1, 3):      # interpolate / forward
                    if field_pr:
                        fmvs_f = []
                        for i in range(2):
                            mx = self._decode_mv_component(
                                b, fcode_f, lm[0][i][0])
                            my = self._decode_mv_component(
                                b, fcode_f, self._cdiv2(lm[0][i][1]))
                            lm[0][i] = [mx, 2 * my]
                            fmvs_f.append((mx, my))
                    else:
                        fx = self._decode_mv_component(b, fcode_f,
                                                       lm[0][0][0])
                        fy = self._decode_mv_component(b, fcode_f,
                                                       lm[0][0][1])
                        lm[0][0] = [fx, fy]
                        lm[0][1] = [fx, fy]
                if mb_type in (1, 2):      # interpolate / backward
                    if field_pr:
                        fmvs_b = []
                        for i in range(2):
                            mx = self._decode_mv_component(
                                b, fcode_b, lm[1][i][0])
                            my = self._decode_mv_component(
                                b, fcode_b, self._cdiv2(lm[1][i][1]))
                            lm[1][i] = [mx, 2 * my]
                            fmvs_b.append((mx, my))
                    else:
                        bx_ = self._decode_mv_component(b, fcode_b,
                                                        lm[1][0][0])
                        by_ = self._decode_mv_component(b, fcode_b,
                                                        lm[1][0][1])
                        lm[1][0] = [bx_, by_]
                        lm[1][1] = [bx_, by_]
                if self._mb_trace is not None:
                    self._mb_trace.append(
                        (mbx, mby, mb_type,
                         fmvs_f or tuple(lm[0][0]),
                         fmvs_b or tuple(lm[1][0]), cbp))
                if self._plan is not None:
                    idx = mby * mbw + mbx
                    pl = self._plan
                    if mb_type in (1, 3):
                        pf = lm[0][0]
                        pl['use_f'][idx] = 1
                        pl['mvs4'][idx] = [pf] * 4
                        pl['cmv'][idx] = (chroma_mv(pf[0]),
                                          chroma_mv(pf[1]))
                    if mb_type in (1, 2):
                        pb_ = lm[1][0]
                        pl['use_b'][idx] = 1
                        pl['bmvs4'][idx] = [pb_] * 4
                        pl['bcmv'][idx] = (chroma_mv(pb_[0]),
                                           chroma_mv(pb_[1]))
                    self._b_residual(b, cbp, qscale, None, None,
                                     None, x0, y0, y, u, v,
                                     dct_type=dct_type)
                    continue
                pred_y = None
                pred_u = pred_v = None
                if mb_type in (1, 3):
                    if field_pr:
                        fpy, fpu, fpv = self._field_pred_mb(
                            self._bf_pad(0), pad, x0, y0,
                            fmvs_f, fsf, 0)
                    else:
                        pf = lm[0][0]
                        fpy = mc_l(frefs[0], pad, x0, y0, 16,
                                   pf[0], pf[1], 0)
                        cmx, cmy = chroma_mv(pf[0]), chroma_mv(pf[1])
                        fpu = self._mc_block(frefs[1], pad, x0 >> 1,
                                             y0 >> 1, 8, cmx, cmy, 0)
                        fpv = self._mc_block(frefs[2], pad, x0 >> 1,
                                             y0 >> 1, 8, cmx, cmy, 0)
                    pred_y, pred_u, pred_v = fpy, fpu, fpv
                if mb_type in (1, 2):
                    if field_pr:
                        bpy, bpu, bpv = self._field_pred_mb(
                            self._bf_pad(1), pad, x0, y0,
                            fmvs_b, fsb, 0)
                    else:
                        pb_ = lm[1][0]
                        bpy = mc_l(brefs[0], pad, x0, y0, 16,
                                   pb_[0], pb_[1], 0)
                        cmx, cmy = chroma_mv(pb_[0]), chroma_mv(pb_[1])
                        bpu = self._mc_block(brefs[1], pad, x0 >> 1,
                                             y0 >> 1, 8, cmx, cmy, 0)
                        bpv = self._mc_block(brefs[2], pad, x0 >> 1,
                                             y0 >> 1, 8, cmx, cmy, 0)
                    if pred_y is None:
                        pred_y, pred_u, pred_v = bpy, bpu, bpv
                    else:
                        pred_y = avg_bidir(pred_y, bpy)
                        pred_u = avg_bidir(pred_u, bpu)
                        pred_v = avg_bidir(pred_v, bpv)
                self._b_residual(b, cbp, qscale, pred_y, pred_u,
                                 pred_v, x0, y0, y, u, v,
                                 dct_type=dct_type)
        return self._crop_planes([y, u, v])

    def _bf_pad(self, which: int) -> list:
        """Lazy frame-space-padded field views of the B references
        (0 = forward/older, 1 = backward/newer)."""
        if self._bf_refs[which] is None:
            fwd_ref, bwd_ref, pad = self._bf_srcs
            src = fwd_ref if which == 0 else bwd_ref
            self._bf_refs[which] = self._field_pad(src, pad)
        return self._bf_refs[which]

    def _b_direct(self, b, frefs, brefs, pad, x0, y0, delta, co_mvs,
                  mbx, mby, trb, trd, cbp, qscale, y, u, v,
                  read_blocks, dct_type=0):
        """Direct-mode MB: per-block MVs scaled from the co-located
        backward-reference MBs by the TRB/TRD time ratio (C
        truncating division)."""
        if delta is None:
            delta = (0, 0)
        if self.vol.interlaced and self._co_field \
                and self._co_field[mby][mbx]:
            return self._b_direct_field(b, pad, x0, y0, delta, mbx,
                                        mby, trb, trd, cbp, qscale,
                                        y, u, v, read_blocks,
                                        dct_type)
        def tdiv(a, d):
            q = abs(a) // d
            return -q if a < 0 else q
        fmv = []
        bmv = []
        for k in range(4):
            cm = co_mvs[2 * mby + (k >> 1)][2 * mbx + (k & 1)]
            fx = tdiv(trb * cm[0], trd) + delta[0]
            fy = tdiv(trb * cm[1], trd) + delta[1]
            # backward vector gates on each delta COMPONENT, not
            # the pair (a (d,0) delta scales y but differences x)
            bx = (fx - cm[0]) if delta[0] \
                else tdiv((trb - trd) * cm[0], trd)
            by = (fy - cm[1]) if delta[1] \
                else tdiv((trb - trd) * cm[1], trd)
            fmv.append((fx, fy))
            bmv.append((bx, by))
        qpel = self.vol.quarter_sample
        mc_l = self._mc_block_qpel if qpel else self._mc_block
        if self._mb_trace is not None:
            self._mb_trace.append(
                (x0 // 16, y0 // 16, "direct", fmv, bmv,
                 cbp if read_blocks else 0))
        if self._plan is not None:
            idx = mby * self._mbw + mbx
            pl = self._plan
            pl['use_f'][idx] = 1
            pl['use_b'][idx] = 1
            pl['mvs4'][idx] = fmv
            pl['bmvs4'][idx] = bmv
            sfx = sum(m[0] for m in fmv)
            sfy = sum(m[1] for m in fmv)
            sbx = sum(m[0] for m in bmv)
            sby = sum(m[1] for m in bmv)
            pl['cmv'][idx] = (self._round_chroma(sfx),
                              self._round_chroma(sfy))
            pl['bcmv'][idx] = (self._round_chroma(sbx),
                               self._round_chroma(sby))
            self._b_residual(b, cbp if read_blocks else 0, qscale,
                             None, None, None, x0, y0, y, u, v,
                             dct_type)
            return
        pred_y = np.empty((16, 16), np.int32)
        for k in range(4):
            sx, sy = x0 + 8 * (k & 1), y0 + 8 * (k >> 1)
            fp = mc_l(frefs[0], pad, sx, sy, 8,
                      fmv[k][0], fmv[k][1], 0)
            bp = mc_l(brefs[0], pad, sx, sy, 8,
                      bmv[k][0], bmv[k][1], 0)
            pred_y[8 * (k >> 1):8 * (k >> 1) + 8,
                   8 * (k & 1):8 * (k & 1) + 8] = (fp + bp + 1) >> 1
        if qpel:
            # per-block C-truncated /2 before summing (probed exact)
            sfx = sum(self._trunc2(m[0]) for m in fmv)
            sfy = sum(self._trunc2(m[1]) for m in fmv)
            sbx = sum(self._trunc2(m[0]) for m in bmv)
            sby = sum(self._trunc2(m[1]) for m in bmv)
        else:
            sfx = sum(m[0] for m in fmv)
            sfy = sum(m[1] for m in fmv)
            sbx = sum(m[0] for m in bmv)
            sby = sum(m[1] for m in bmv)
        fcx, fcy = self._round_chroma(sfx), self._round_chroma(sfy)
        bcx, bcy = self._round_chroma(sbx), self._round_chroma(sby)
        fpu = self._mc_block(frefs[1], pad, x0 >> 1, y0 >> 1, 8,
                             fcx, fcy, 0)
        bpu = self._mc_block(brefs[1], pad, x0 >> 1, y0 >> 1, 8,
                             bcx, bcy, 0)
        fpv = self._mc_block(frefs[2], pad, x0 >> 1, y0 >> 1, 8,
                             fcx, fcy, 0)
        bpv = self._mc_block(brefs[2], pad, x0 >> 1, y0 >> 1, 8,
                             bcx, bcy, 0)
        pred_u = (fpu + bpu + 1) >> 1
        pred_v = (fpv + bpv + 1) >> 1
        self._b_residual(b, cbp if read_blocks else 0, qscale,
                         pred_y, pred_u, pred_v, x0, y0, y, u, v,
                         dct_type)

    def _b_direct_field(self, b, pad, x0, y0, delta, mbx, mby, trb,
                        trd, cbp, qscale, y, u, v, read_blocks,
                        dct_type):
        """Direct mode over a FIELD-predicted co-located MB: per
        destination field i, scale that field's co-located vector by
        the per-field temporal distances IN FIELD UNITS — the frame
        distances doubled, then corrected by one field period for
        the field pairing: tff ? 2t - sel + i : 2t + sel - i (the
        co-located field select vs the destination parity); forward
        field select = the co-located select, backward select = own
        parity (ff_mpeg4_set_direct_mv's interlaced branch,
        oracle-verified by TestFieldDirectProbe — the plain TRB/TRD
        ratio only matches the field whose correction is zero)."""
        def tdiv(a, d):
            q = abs(a) // d
            return -q if a < 0 else q
        co = self._co_fmvs[mby][mbx]
        cosel = self._co_fsels[mby][mbx]
        tff = self._top_field_first
        fmvs, bmvs, fsf, fsb = [], [], [], []
        for i in range(2):
            cmx, cmy = co[i]
            if tff:
                tpp = 2 * trd - cosel[i] + i
                tpb = 2 * trb - cosel[i] + i
            else:
                tpp = 2 * trd + cosel[i] - i
                tpb = 2 * trb + cosel[i] - i
            fx = tdiv(tpb * cmx, tpp) + delta[0]
            fy = tdiv(tpb * cmy, tpp) + delta[1]
            bx = (fx - cmx) if delta[0] \
                else tdiv((tpb - tpp) * cmx, tpp)
            by = (fy - cmy) if delta[1] \
                else tdiv((tpb - tpp) * cmy, tpp)
            fmvs.append((fx, fy))
            bmvs.append((bx, by))
            fsf.append(cosel[i])
            fsb.append(i)
        if self._mb_trace is not None:
            self._mb_trace.append(
                (mbx, mby, "direct-field", fmvs, bmvs,
                 cbp if read_blocks else 0))
        fp = self._field_pred_mb(self._bf_pad(0), pad, x0, y0,
                                 fmvs, fsf, 0)
        bp = self._field_pred_mb(self._bf_pad(1), pad, x0, y0,
                                 bmvs, fsb, 0)
        pred_y = (fp[0] + bp[0] + 1) >> 1
        pred_u = (fp[1] + bp[1] + 1) >> 1
        pred_v = (fp[2] + bp[2] + 1) >> 1
        self._b_residual(b, cbp if read_blocks else 0, qscale,
                         pred_y, pred_u, pred_v, x0, y0, y, u, v,
                         dct_type)

    def _b_residual(self, b, cbp, qscale, pred_y, pred_u, pred_v,
                    x0, y0, y, u, v, dct_type=0):
        iscan = _ALT_V if self._alt_scan else _ZIG
        blocks = np.zeros((6, 8, 8), np.int64)
        coded = [(cbp >> (5 - n)) & 1 for n in range(6)]
        for n in range(6):
            if coded[n]:
                lv = self._read_block(b, False, iscan, 0)
                blocks[n] = self._dequant(lv, qscale, False, 0)
        if self._plan is not None:
            idx = (y0 // 16) * self._mbw + (x0 // 16)
            self._plan['blocks'][idx] = blocks
            return
        pred6 = np.empty((6, 8, 8), np.int32)
        for k, blk in enumerate(self._luma_split(pred_y, dct_type)):
            pred6[k] = blk
        pred6[4] = pred_u
        pred6[5] = pred_v
        out = idct_add_sel(blocks, pred6, coded)
        self._luma_store(y, x0, y0, out[:4], dct_type)
        u[(y0 >> 1):(y0 >> 1) + 8, (x0 >> 1):(x0 >> 1) + 8] = out[4]
        v[(y0 >> 1):(y0 >> 1) + 8, (x0 >> 1):(x0 >> 1) + 8] = out[5]


def _dquant(b: Bits, qscale: int) -> int:
    d = b.read(2)
    qscale += (-1, -2, 1, 2)[d]
    return max(1, min(31, qscale))


def _rl_max_level(intra, last, run):
    tab = _MAXLEV_I if intra else _MAXLEV_P
    t = tab[1 if last else 0]
    return t[run] if run < len(t) else 0


def _rl_max_run(intra, last, level):
    tab = _MAXRUN_I if intra else _MAXRUN_P
    t = tab[1 if last else 0]
    return t[level] if level < len(t) else 0


def _build_maxes(runs, levels, n0):
    maxlev = [{}, {}]
    maxrun = [{}, {}]
    for i in range(len(runs)):
        last = 1 if i >= n0 else 0
        r, l = runs[i], levels[i]
        maxlev[last][r] = max(maxlev[last].get(r, 0), l)
        maxrun[last][l] = max(maxrun[last].get(l, 0), r)
    def flat(d):
        n = max(d) + 1 if d else 0
        return [d.get(i, 0) for i in range(n)]
    return ([flat(maxlev[0]), flat(maxlev[1])],
            [flat(maxrun[0]), flat(maxrun[1])])


_MAXLEV_I, _MAXRUN_I = _build_maxes(T.MP4_INTRA_RUN,
                                    T.MP4_INTRA_LEVEL, _INTRA_LAST0_N)
_MAXLEV_P, _MAXRUN_P = _build_maxes(T.INTER_RUN, T.INTER_LEVEL,
                                    _INTER_LAST0_N)


def _iter_startcodes(data: bytes):
    """Yield (code, payload) for each 0x000001xx chunk."""
    i = data.find(b"\x00\x00\x01")
    while i >= 0 and i + 3 < len(data):
        code = data[i + 3]
        j = data.find(b"\x00\x00\x01", i + 4)
        payload = data[i + 4:j if j >= 0 else len(data)]
        yield code, payload
        i = j
