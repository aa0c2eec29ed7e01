# Copied from tcforge_tpu/io/mp3dec.py; only the package name in its imports differs.
"""Native MPEG-1 audio Layer III decoder (ISO 11172-3).

Completes the in-tree MPEG audio family next to io/mp2dec.py: the
reference decoded MP3 only by piping through external decoders
(import/import_mp3.c -> mpg123/lame; the bridge path here uses
libavcodec).  From-scratch spec implementation: side info + bit
reservoir, scalefactor decode with scfsi sharing, the 32+2 Huffman
tables, requantization, short-block reorder, M/S and intensity
stereo, alias reduction, 36/12-point IMDCT with the four window
types, frequency inversion, and the common polyphase synthesis
filterbank (shared with mp2dec).

Constant tables (the Huffman code tables of ISO Table B.7, the
scalefactor band widths of Table B.8, the pretab/slen tables) are
numeric constants of the published spec, recovered verbatim from the
public libavcodec binary in this container (canonical lens+symbols
form; every table verifies as a complete prefix code — Kraft sum
exactly 1).  Correctness is validated two ways against the bundled
libavcodec decoder (tests/test_mp3dec.py): output SNR across
rates/modes/bitrates, and EXACT per-granule bit accounting — after
each granule the reader must land on the side info's part2_3_length
boundary, which any table or grammar error breaks immediately.

MPEG-2 LSF and MPEG-2.5 Layer III (24/22.05/16 kHz and
12/11.025/8 kHz) decode too: one granule per frame, 8-bit
main_data_begin, 9-bit scalefac_compress expanded over the LSF
sfb-count tables, and the LSF region-boundary rule for window-
switched granules (54 coefficients, or 108/72 on the 8 kHz row) —
all six rates verify to 1 LSB against libavcodec.  LSF intensity
stereo is gated (no encoder in the wild emits it).
"""

from __future__ import annotations

import base64
import zlib
from typing import List, Optional, Tuple

import numpy as np

from .mp2dec import parse_mpa_header

__all__ = ["Mp3Decoder", "decode_stream"]


# ------------------------------------------------------------------ #
# Spec tables (see module docstring for provenance)
# ------------------------------------------------------------------ #

_TAB_META = [
    ("sizes", "<i8", (15,), 120), ("lens", "|u1", (1378,), 1378),
    ("symbols", "|u1", (1378,), 1378), ("quad_bits", "|u1", (2, 16), 32),
    ("quad_codes", "|u1", (2, 16), 32), ("band_long", "|u1", (9, 22), 198),
    ("band_short", "|u1", (9, 13), 117), ("pretab", "|u1", (2, 22), 44),
    ("huff_data", "|u1", (32, 2), 64), ("slen", "|u1", (2, 16), 32),
    ("is_table", "<f4", (2, 16), 128)]

_TAB_B64 = (
    "eNqNVwdYFFcQ3tt2e23vOBD0REQkiKioIFgjqKBRiULg7FGwYYkFG1GjoolGjb333qPYe8"
    "OWWGONsXex995iZt7b3TuIbb7dfW/fzsyb/595u295hoohV2vL1QZ+pI3+SMvoPt1yHKsT"
    "RUEQOI5TOizLSpJe1IOIIPiA9OCZwPM8x3KcEcQAIklwYgO6kkQavSiIIg82JpPRQLRQCa"
    "8SUUEBZzwPbljFg6Q4UKcUBDxxLhATESMVdEq8GtE5GtMbiU5CfbkcYRwuSwwGu6hLYyEW"
    "ZGJJDQRvRBFh8IQUliI1uELVWvCi17smJFecFY0xfDjBgaen3cOmiYeH1WqzWTWBvs0my9"
    "iVXQI3Flm24KkdcJrNZgsRaNSuMkBG6Bh2TWZFkDu8mumQ0qEHYcVFL1zJgXf0RKGUGbGj"
    "cK2KwrhbjimZlA3KP8/plJC0sD8oFovJpIZLA87d+5+oj4wqAg2FK+E0cKObGJSLNmhwQ+"
    "HWKnjUknLvu+pAUqtHLV5cNST/dLUIHBCgUayVsUQnMSrFgNlWTrhi6skEFlc5WEifFIFF"
    "vcdysOSQnLVhcjFLiNUKQq0J1612GHNw6Ra4UR3RVqBCHeXS4MYPfRvgC0TJv7rolWWmdx"
    "PQNn1CeCXNOTKr5fdzkkuR4jC4v0QoBq0EPikKWlfqc1YCeaHo1UJQXgGIn+c9dDYmgLUX"
    "8tc6Ng8dE144rLQnVyrAXoglD8K5wmGlPEuT5zoPG+OMTUqMiPnquzwJQpn4auGBVb2qRP"
    "OFwzjP0i4bZ1Is0RHyJJSpFk90+OjCYZ6lwS/rby9EdGIjEpME4gh0+MCq4dFeVVQdJaj0"
    "1B71u7eu0a1eq7JdqzuTWhTp0lLfuXlshJgY45MWGURtvVOShXgw5yGQXHGAPZrXdxIHsU"
    "kRieghzadzZItkEl7zINE7JUHFocVYyM7mmL9VvbJdnUW6VG/pk6YH29ikGFEIap7inRyR"
    "6IrfKxzCj+aQK5yfAQf/vn137/2Di/cPX9j+5q9zy2/dPf/60LY7M1/d3np25MuDmTNG9O"
    "v74syyLQeed7rZbPrpZzeWbq77dH/2k6jhp0o+7jjNuq/p733+qbP3ZOWNU5cUfPRw0/Vr"
    "wzpcvRIq+12+9P3fP/357W8bTkxZ/MMfXx/vXeJYgfVN9kzutWvhxNpHLUeGLorb3X5dpe"
    "I7G68d4rtjkjlrTbsFPSuuHtyo2Py28378dVx6j1X5V5pWTKhVYW7D8SFzHLONbWYNqjm2"
    "fIOBqUXH1O9e7mfCedd8ow2jvvkFYAcPyFu2iE+ak4IPah7RX8rwThGTE7UcA/9u/Kn8v3"
    "/w78X77w6/vXAP8N89v/z1tjuHzqnwZ9zq92LZmS2dMq0Hno8A/M/63li6f/Pp4XWfRj05"
    "lQ0EPCz4aBpQsOk6kHBt2N7KHU5enboxdMkVv8uygv/EBor/WAlLgd7rjzY5socin2yutK"
    "vXwgVZpp3FG6/1HTJpR+017Sr2XD1xcLFGq+bnX7mi7YRaQIMGflabQTXHlR+bbmgwsGhq"
    "jzGj8wFqygIA799NyiDlA6Xj40xTKfAWkyNSEuk6iC9TDfBX8eIx/+71B/AB/fY3y1/PfP"
    "VyZL8XnZ6/b/as7tMnD6OAjQu3bp++f+/OtkPnzmYeXHam79L9+/o03fq4pLXgoxlbDoy4"
    "Of3G5uGnOmZPAwJU/FM3Lrl8YsPi3uuPXFUpmAL4m+yxDF00OW5dr0qNh/hmTep5JdTveI"
    "ljRytOHFxgd/tdC4vvXLvDDAwsWN1ofjGSeIp/boWGIePbzB6UPq5m/dQ5DuOs8mOBgDE9"
    "DPlGAwGIP3hAjW55+2dIUP6tEL9T75Om4sf04xpPyCN8NP8q/tfLVfwIP+pJycePCj603r"
    "9wD2jAksiEioB6gGpA3KehEN7vB/DyJUt2RyiBTddhHQADdUJpDWAJ5FwAUP+Y/z1IA+T/"
    "CMk/lj9Jfpap4gqjA9fAxFmGUauVKmg7YV4ttQhmtxmUjiVACyDfaCX/kP4a3fpj/n30nb"
    "uWxTeAM82FP4LkX4hPIPn/AH4dbLV42HbChgs3n+St6y462MrBdo7XcyKjZzkdfGHhowKf"
    "bhiE7S9DtURRkoxmm1de34CQsMi4GeqoiKN2b9+A4NDIyCxNl6j6BYWWi0lq7RCJwJiM9v"
    "5BoWUqxVSIdBu1eztwNLp6XOBndT87Sr/cZCS4VLnouEYsCokLVe3efuVokMTOUZU+AQNH"
    "QIhZiV62O/xD7JpJXv/iZteNX7D94zfwtSNzB8KcDuZzogNhWdxHk38OluGg5RmBgVQwEv"
    "zmGBkTY4YxCyPrZFbmZF4WZUk2yhYrbxWsolVvlawGq8lqIb8rxB3643lGx3J40oNFx8yw"
    "Vg0qZ6ZurgzdqKJxAVHTs2tGMUxGFPNFkkH00Q7t0Q/6Y75Q/gPk46Py"
)


def _load_tables():
    raw = zlib.decompress(base64.b64decode("".join(_TAB_B64.split())))
    out = {}
    pos = 0
    for name, dt, shape, nb in _TAB_META:
        out[name] = np.frombuffer(
            raw[pos:pos + nb], np.dtype(dt)).reshape(shape)
        pos += nb
    return out


_T = _load_tables()

# Long/short scalefactor-band START indices from the extracted band
# widths; rows 0-2 = MPEG-1 (44100/48000/32000), 3-5 = MPEG-2 LSF
# (22050/24000/16000), 6-8 = MPEG-2.5 (11025/12000/8000).
_BAND_INDEX_LONG = [np.concatenate(([0], np.cumsum(_T["band_long"][i])))
                    .astype(int) for i in range(9)]
_BAND_INDEX_SHORT = [np.concatenate(([0], np.cumsum(_T["band_short"][i])))
                     .astype(int) for i in range(9)]
_PRETAB = _T["pretab"][1].astype(int)
_SLEN = _T["slen"].astype(int)
_IS_TABLE = _T["is_table"].astype(np.float64)
_HUFF_DATA = _T["huff_data"].astype(int)


class _HuffLUT:
    """Flat 2^maxlen lookup: value = (run_x<<4|run_y, length)."""

    def __init__(self, lens, symbols):
        self.maxlen = int(lens.max())
        lut_sym = np.zeros(1 << self.maxlen, np.uint8)
        lut_len = np.zeros(1 << self.maxlen, np.uint8)
        code = 0
        for l, sym in zip(lens.tolist(), symbols.tolist()):
            c = code >> (32 - self.maxlen)          # left-aligned slot
            n = 1 << (self.maxlen - l)
            lut_sym[c:c + n] = sym
            lut_len[c:c + n] = l
            code += 1 << (32 - l)
        assert code == 1 << 32
        self.sym = lut_sym
        self.len = lut_len


_BIG_TABLES: List[Optional[_HuffLUT]] = [None]
_pos = 0
for _n in _T["sizes"].tolist():
    _BIG_TABLES.append(_HuffLUT(_T["lens"][_pos:_pos + _n],
                                _T["symbols"][_pos:_pos + _n]))
    _pos += _n

# count1 table A as a peek LUT (max 6 bits); table B is fixed 4-bit
def _build_quad_a():
    bits = _T["quad_bits"][0].astype(int)
    codes = _T["quad_codes"][0].astype(int)
    maxlen = int(bits.max())
    sym = np.zeros(1 << maxlen, np.uint8)
    ln = np.zeros(1 << maxlen, np.uint8)
    for v in range(16):
        c = codes[v] << (maxlen - bits[v])
        n = 1 << (maxlen - bits[v])
        sym[c:c + n] = v
        ln[c:c + n] = bits[v]
    return sym, ln, maxlen


_QA_SYM, _QA_LEN, _QA_MAX = _build_quad_a()

# alias-reduction butterflies (ISO 2.4.3.4.10.1)
_CI = np.array([-0.6, -0.535, -0.33, -0.185, -0.095, -0.041,
                -0.0142, -0.0037])
_CS = 1.0 / np.sqrt(1.0 + _CI * _CI)
_CA = _CI * _CS

# IMDCT matrices: x[i] = sum_k X[k] cos(pi/(2N) (2i+1+N/2)(2k+1))
_IM36 = np.cos(np.pi / 72.0
               * (2 * np.arange(36)[:, None] + 1 + 18)
               * (2 * np.arange(18)[None, :] + 1))
_IM12 = np.cos(np.pi / 24.0
               * (2 * np.arange(12)[:, None] + 1 + 6)
               * (2 * np.arange(6)[None, :] + 1))

_WIN_NORMAL = np.sin(np.pi / 36.0 * (np.arange(36) + 0.5))
_WIN_SHORT1 = np.sin(np.pi / 12.0 * (np.arange(12) + 0.5))
_WIN_START = _WIN_NORMAL.copy()
_WIN_START[18:24] = 1.0
_WIN_START[24:30] = np.sin(np.pi / 12.0 * (np.arange(24, 30) - 18 + 0.5))
_WIN_START[30:] = 0.0
_WIN_STOP = _WIN_NORMAL.copy()
_WIN_STOP[:6] = 0.0
_WIN_STOP[6:12] = np.sin(np.pi / 12.0 * (np.arange(6, 12) - 6 + 0.5))
_WIN_STOP[12:18] = 1.0
_WINDOWS = {0: _WIN_NORMAL, 1: _WIN_START, 3: _WIN_STOP}

# |ix|^{4/3} for the Huffman value range (+15 linbits headroom is
# computed on demand)
_POW43 = np.arange(8207, dtype=np.float64) ** (4.0 / 3.0)

# frequency-inversion mask: odd subband, odd time sample
_FREQINV = np.ones((32, 18))
_FREQINV[1::2, 1::2] = -1.0


class _MdBits:
    """MSB-first reader over the assembled main-data buffer with an
    absolute bit cursor (part2_3 boundaries are absolute).  Word-pair
    reads like mp2dec._Bits; past-the-end reads return zeros."""

    __slots__ = ("words", "pos", "nbits")

    def __init__(self, data: bytes):
        pad = data + b"\x00" * 8
        self.words = np.frombuffer(
            pad[:len(pad) // 4 * 4], ">u4").tolist()
        self.pos = 0
        self.nbits = 8 * len(data)

    def read(self, n: int) -> int:
        n = int(n)                  # numpy scalars poison the shifts
        if n == 0:
            return 0
        p = self.pos
        self.pos = p + n
        i = p >> 5
        if i + 1 >= len(self.words):
            return 0
        w = (self.words[i] << 32) | self.words[i + 1]
        return (w >> (64 - (p & 31) - n)) & ((1 << n) - 1)

    def peek(self, n: int) -> int:
        n = int(n)
        p = self.pos
        i = p >> 5
        if i + 1 >= len(self.words):
            return 0
        w = (self.words[i] << 32) | self.words[i + 1]
        return (w >> (64 - (p & 31) - n)) & ((1 << n) - 1)


class _Granule:
    __slots__ = ("part2_3_length", "big_values", "global_gain",
                 "scalefac_compress", "wsf", "block_type", "mixed",
                 "table_select", "subblock_gain", "region0",
                 "region1", "preflag", "scalefac_scale",
                 "count1table", "scalefac_l", "scalefac_s")


def _read_side_info(frame: bytes, hdr, nch: int):
    from .mp2dec import _Bits
    b = _Bits(frame)
    b.pos = 32 + (0 if hdr.protection else 16)
    if hdr.version != 1:
        return _read_side_info_lsf(b, nch)
    main_data_begin = b.read(9)
    b.read(5 if nch == 1 else 3)
    scfsi = [[b.read(1) for _ in range(4)] for _ in range(nch)]
    grans = []
    for _gr in range(2):
        row = []
        for _ch in range(nch):
            g = _Granule()
            g.part2_3_length = b.read(12)
            g.big_values = b.read(9)
            g.global_gain = b.read(8)
            g.scalefac_compress = b.read(4)
            g.wsf = b.read(1)
            if g.wsf:
                g.block_type = b.read(2)
                g.mixed = b.read(1)
                g.table_select = [b.read(5), b.read(5), 0]
                g.subblock_gain = [b.read(3) for _ in range(3)]
                g.region0, g.region1 = 7, 13    # implied (2.4.2.7)
            else:
                g.block_type = 0
                g.mixed = 0
                g.table_select = [b.read(5), b.read(5), b.read(5)]
                g.subblock_gain = [0, 0, 0]
                g.region0 = b.read(4)
                g.region1 = b.read(3)
            g.preflag = b.read(1)
            g.scalefac_scale = b.read(1)
            g.count1table = b.read(1)
            row.append(g)
        grans.append(row)
    return main_data_begin, scfsi, grans


# ------------------------------------------------------------------ #
# MPEG-2 LSF / MPEG-2.5 Layer III (13818-3 2.4.1.7): one granule per
# frame, 8-bit main_data_begin, no scfsi, 9-bit scalefac_compress
# expanded into 4 slen groups over the LSF sfb-count table.
# ------------------------------------------------------------------ #

# [tindex][window 0=long 1=short 2=mixed][group] scalefactor counts
_LSF_NSF = (((6, 5, 5, 5), (9, 9, 9, 9), (6, 9, 9, 9)),
            ((6, 5, 7, 3), (9, 9, 12, 6), (6, 9, 12, 6)),
            ((11, 10, 0, 0), (18, 18, 0, 0), (15, 18, 0, 0)))


def _read_side_info_lsf(b, nch: int):
    main_data_begin = b.read(8)
    b.read(1 if nch == 1 else 2)
    row = []
    for _ch in range(nch):
        g = _Granule()
        g.part2_3_length = b.read(12)
        g.big_values = b.read(9)
        g.global_gain = b.read(8)
        g.scalefac_compress = b.read(9)    # 9 bits in LSF
        g.wsf = b.read(1)
        if g.wsf:
            g.block_type = b.read(2)
            g.mixed = b.read(1)
            g.table_select = [b.read(5), b.read(5), 0]
            g.subblock_gain = [b.read(3) for _ in range(3)]
            g.region0, g.region1 = 7, 13
        else:
            g.block_type = 0
            g.mixed = 0
            g.table_select = [b.read(5), b.read(5), b.read(5)]
            g.subblock_gain = [0, 0, 0]
            g.region0 = b.read(4)
            g.region1 = b.read(3)
        g.preflag = 0
        g.scalefac_scale = b.read(1)
        g.count1table = b.read(1)
        row.append(g)
    scfsi = [[0] * 4 for _ in range(nch)]
    return main_data_begin, scfsi, [row]   # ONE granule


def _read_scalefactors_lsf(b: _MdBits, g: _Granule,
                           intensity_ch: bool) -> None:
    """LSF scalefactor decode.  Intensity-coded right channels use a
    different expansion (2.4.3.4.9.3 LSF variant) — gated: no MPEG-1
    -era encoder in the wild emits LSF intensity."""
    if intensity_ch:
        raise NotImplementedError(
            "mp3dec: LSF intensity stereo not implemented")
    sf = g.scalefac_compress
    slen = [0, 0, 0, 0]
    if sf < 400:
        slen[3] = sf & 3
        slen[2] = (sf >> 2) & 3
        slen[1] = (sf >> 4) % 5
        slen[0] = (sf >> 4) // 5
        tindex = 0
    elif sf < 500:
        sf -= 400
        slen[3] = 0
        slen[2] = sf & 3
        slen[1] = (sf >> 2) % 5
        slen[0] = (sf >> 2) // 5
        tindex = 1
    else:
        sf -= 500
        slen[1] = sf % 3
        slen[0] = sf // 3
        tindex = 2
        g.preflag = 1
    wtype = (1 if not g.mixed else 2) if (g.wsf and g.block_type == 2) \
        else 0
    counts = _LSF_NSF[tindex][wtype]
    vals = []
    for grp in range(4):
        for _ in range(counts[grp]):
            vals.append(b.read(slen[grp]))
    g.scalefac_l = np.zeros(22, int)
    g.scalefac_s = np.zeros((13, 3), int)
    if wtype == 0:                          # long: sfb 0..20
        g.scalefac_l[:len(vals)] = vals[:22]
    elif wtype == 1:                        # short: sfb-major, window
        arr = np.zeros(39, int)
        arr[:len(vals)] = vals
        g.scalefac_s[:12] = arr[:36].reshape(12, 3)
    else:                                   # mixed: 6 long + sfb 3..11
        g.scalefac_l[:6] = vals[:6]
        rest = np.zeros(27, int)
        rest[:len(vals) - 6] = vals[6:6 + 27]
        g.scalefac_s[3:12] = rest.reshape(9, 3)


def _read_scalefactors(b: _MdBits, g: _Granule, scfsi, prev,
                       gr: int) -> None:
    slen1 = _SLEN[0][g.scalefac_compress]
    slen2 = _SLEN[1][g.scalefac_compress]
    if g.wsf and g.block_type == 2:
        g.scalefac_l = np.zeros(22, int)
        s = np.zeros((13, 3), int)
        if g.mixed:
            gl = g.scalefac_l
            for sfb in range(8):
                gl[sfb] = b.read(slen1)
            for sfb in range(3, 6):
                for w in range(3):
                    s[sfb][w] = b.read(slen1)
        else:
            for sfb in range(6):
                for w in range(3):
                    s[sfb][w] = b.read(slen1)
        for sfb in range(6, 12):
            for w in range(3):
                s[sfb][w] = b.read(slen2)
        g.scalefac_s = s
        return
    sf = np.zeros(22, int)
    groups = ((0, 6, slen1), (6, 11, slen1),
              (11, 16, slen2), (16, 21, slen2))
    for band, (lo, hi, sl) in enumerate(groups):
        if gr == 1 and scfsi[band] and prev is not None:
            sf[lo:hi] = prev.scalefac_l[lo:hi]
        else:
            for sfb in range(lo, hi):
                sf[sfb] = b.read(sl)
    g.scalefac_l = sf
    g.scalefac_s = np.zeros((13, 3), int)


def _decode_huffman(b: _MdBits, g: _Granule, sfreq: int,
                    end_bit: int) -> np.ndarray:
    ix = np.zeros(576, np.float64)
    # region boundaries in coefficient indices (dist10 rule).  For
    # window-switched granules that are NOT short blocks, LSF rates
    # use 54 (108 at the MPEG-2.5 8 kHz row) instead of MPEG-1's 36.
    if g.wsf:
        if g.block_type == 2:
            r1 = 72 if sfreq == 8 else 36
        elif sfreq <= 2:
            r1 = 36
        else:
            r1 = 108 if sfreq == 8 else 54
        r2 = 576
    else:
        bi = _BAND_INDEX_LONG[sfreq]
        r1 = int(bi[min(g.region0 + 1, 22)])
        r2 = int(bi[min(g.region0 + 1 + g.region1 + 1, 22)])
    bigv = min(2 * g.big_values, 576)
    r1 = min(r1, bigv)
    r2 = min(r2, bigv)
    bounds = ((0, r1, g.table_select[0]),
              (r1, r2, g.table_select[1]),
              (r2, bigv, g.table_select[2]))
    for lo, hi, tsel in bounds:
        vidx, linbits = _HUFF_DATA[tsel]
        if vidx == 0:
            continue
        tab = _BIG_TABLES[vidx]
        sym_l, len_l, ml = tab.sym, tab.len, tab.maxlen
        i = lo
        while i < hi:
            pk = b.peek(ml)
            sym = int(sym_l[pk])
            b.pos += int(len_l[pk])
            x = sym >> 4
            y = sym & 15
            if x:
                if x == 15 and linbits:
                    x += b.read(int(linbits))
                v = _POW43[x] if x < 8207 else float(x) ** (4.0 / 3.0)
                ix[i] = -v if b.read(1) else v
            i += 1
            if y:
                if y == 15 and linbits:
                    y += b.read(int(linbits))
                v = _POW43[y] if y < 8207 else float(y) ** (4.0 / 3.0)
                ix[i] = -v if b.read(1) else v
            i += 1
    # count1 region
    i = bigv
    while i <= 572 and b.pos < end_bit:
        start = b.pos
        if g.count1table:
            code = 15 - b.read(4)
        else:
            pk = b.peek(_QA_MAX)
            code = int(_QA_SYM[pk])
            b.pos += int(_QA_LEN[pk])
        vals = [0.0, 0.0, 0.0, 0.0]
        for j, bit in enumerate((8, 4, 2, 1)):
            if code & bit:
                vals[j] = -1.0 if b.read(1) else 1.0
        if b.pos > end_bit:
            b.pos = start                   # last quad overran: drop
            break
        ix[i:i + 4] = vals
        i += 4
    b.pos = end_bit                          # skip stuffing bits
    return ix


def _requantize(ix: np.ndarray, g: _Granule, sfreq: int) -> np.ndarray:
    xr = ix.copy()
    mult = 1.0 if g.scalefac_scale else 0.5
    if g.wsf and g.block_type == 2:
        bis = _BAND_INDEX_SHORT[sfreq]
        if g.mixed:
            bil = _BAND_INDEX_LONG[sfreq]
            for sfb in range(8):
                lo, hi = int(bil[sfb]), int(bil[sfb + 1])
                if lo >= 36:
                    break
                hi = min(hi, 36)
                e = (g.global_gain - 210) / 4.0 \
                    - mult * (g.scalefac_l[sfb]
                              + g.preflag * _PRETAB[sfb])
                xr[lo:hi] *= 2.0 ** e
            first_short = 3
        else:
            first_short = 0
        for sfb in range(first_short, 13):
            w0 = int(bis[sfb]) * 3
            wid = int(bis[sfb + 1] - bis[sfb])
            if g.mixed and sfb == 3:
                w0 = 36
            for w in range(3):
                lo = w0 + w * wid
                e = (g.global_gain - 210
                     - 8 * g.subblock_gain[w]) / 4.0 \
                    - mult * g.scalefac_s[sfb][w]
                xr[lo:lo + wid] *= 2.0 ** e
        return xr
    bil = _BAND_INDEX_LONG[sfreq]
    for sfb in range(22):
        lo, hi = int(bil[sfb]), int(bil[sfb + 1])
        e = (g.global_gain - 210) / 4.0 \
            - mult * (g.scalefac_l[sfb] + g.preflag * _PRETAB[sfb])
        xr[lo:hi] *= 2.0 ** e
    return xr


def _reorder_short(xr: np.ndarray, g: _Granule,
                   sfreq: int) -> np.ndarray:
    if not (g.wsf and g.block_type == 2):
        return xr
    out = xr.copy()
    bis = _BAND_INDEX_SHORT[sfreq]
    first = 3 if g.mixed else 0
    for sfb in range(first, 13):
        wid = int(bis[sfb + 1] - bis[sfb])
        base = int(bis[sfb]) * 3
        if g.mixed and sfb == 3:
            base = 36
        blk = xr[base:base + 3 * wid].reshape(3, wid)
        out[base:base + 3 * wid] = blk.T.reshape(-1)
    return out


def _find_last_nonzero_sfb_ext(xr_r, g_r, sfreq):
    """Intensity bound: first sfb index at/above the right channel's
    last nonzero coefficient (long-block form)."""
    nz = np.nonzero(xr_r)[0]
    last = int(nz[-1]) + 1 if len(nz) else 0
    bil = _BAND_INDEX_LONG[sfreq]
    for sfb in range(22):
        if int(bil[sfb]) >= last:
            return sfb
    return 22


def _stereo(xr, grans, sfreq, mode_ext):
    """Joint stereo.  Intensity bands use the ORIGINAL left channel
    as carrier (the right channel is zero there, so M/S must not
    touch them); is_pos == 7 bands fall back to M/S when it is on.
    Intensity is spec-derived (2.4.3.4.9.3) — MPEG-1 encoders in the
    wild (lame, ffmpeg) never emit it, so only the M/S path has
    oracle coverage."""
    g_r = grans[1]
    ms = bool(mode_ext & 2)
    intensity = bool(mode_ext & 1)
    L, R = xr[0], xr[1]
    s2 = 1.0 / np.sqrt(2.0)
    if not intensity:
        if ms:
            return [(L + R) * s2, (L - R) * s2]
        return [L, R]
    is_band = np.zeros(576, bool)            # where intensity applied
    Lo, Ro = L.copy(), R.copy()
    bil = _BAND_INDEX_LONG[sfreq]
    if g_r.wsf and g_r.block_type == 2:
        bis = _BAND_INDEX_SHORT[sfreq]
        nz = np.nonzero(R)[0]
        last = int(nz[-1]) + 1 if len(nz) else 0
        for sfb in range(13):
            wid = int(bis[sfb + 1] - bis[sfb])
            base = int(bis[sfb]) * 3
            if base < last:
                continue
            for w in range(3):
                pos = int(g_r.scalefac_s[sfb][w])
                if pos == 7:
                    continue
                sl = slice(base + w, base + 3 * wid, 3)
                v = Lo[sl]
                L[sl] = v * _IS_TABLE[0][pos]
                R[sl] = v * _IS_TABLE[1][pos]
                is_band[sl] = True
    else:
        bound = _find_last_nonzero_sfb_ext(R, g_r, sfreq)
        for sfb in range(bound, 21):
            pos = int(g_r.scalefac_l[sfb])
            if pos == 7:
                continue
            lo, hi = int(bil[sfb]), int(bil[sfb + 1])
            v = Lo[lo:hi]
            L[lo:hi] = v * _IS_TABLE[0][pos]
            R[lo:hi] = v * _IS_TABLE[1][pos]
            is_band[lo:hi] = True
    if ms:
        rest = ~is_band
        L[rest] = (Lo[rest] + Ro[rest]) * s2
        R[rest] = (Lo[rest] - Ro[rest]) * s2
    return [L, R]


def _antialias(xr: np.ndarray, g: _Granule) -> np.ndarray:
    if g.wsf and g.block_type == 2 and not g.mixed:
        return xr
    n_sb = 2 if (g.wsf and g.block_type == 2) else 32   # mixed: 1 bound
    x = xr.reshape(32, 18)
    for sb in range(1, n_sb):
        a = x[sb - 1, 17:9:-1].copy()      # xr[18sb-1-i], i=0..7
        bvals = x[sb, 0:8].copy()
        x[sb - 1, 17:9:-1] = a * _CS - bvals * _CA
        x[sb, 0:8] = bvals * _CS + a * _CA
    return x.reshape(-1)


def _imdct_granule(xr: np.ndarray, g: _Granule,
                   overlap: np.ndarray) -> np.ndarray:
    """(576,) spectrum -> (32, 18) time samples; overlap (32, 18)
    updated in place."""
    x = xr.reshape(32, 18)
    out = np.empty((32, 18))
    short_all = g.wsf and g.block_type == 2 and not g.mixed
    n_long = 0 if short_all else (2 if (g.wsf and g.block_type == 2)
                                  else 32)
    if n_long:
        # non-wsf granules are always block_type 0; mixed blocks'
        # long subbands use the normal window
        win = _WINDOWS[0] if (not g.wsf or g.block_type == 2) \
            else _WINDOWS[g.block_type]
        y = (_IM36 @ x[:n_long].T).T * win[None, :]
        out[:n_long] = y[:, :18] + overlap[:n_long]
        overlap[:n_long] = y[:, 18:]
    first_short = 0 if short_all else (2 if g.wsf and g.block_type == 2
                                       else 32)
    for sb in range(first_short, 32):
        Xs = x[sb].reshape(6, 3)            # X[k] interleaved by window
        y = np.zeros(36)
        for w in range(3):
            z = (_IM12 @ Xs[:, w]) * _WIN_SHORT1
            y[6 + 6 * w:18 + 6 * w] += z
        out[sb] = y[:18] + overlap[sb]
        overlap[sb] = y[18:]
    return out * _FREQINV


class Mp3Decoder:
    """Stateful Layer III decoder: bit reservoir, per-channel IMDCT
    overlap and synthesis history carry across frames."""

    def __init__(self):
        self._resv = b""
        self._overlap: List[np.ndarray] = []
        self._synth = None                   # lazy Mp2Decoder for _v
        self.granule_bit_check: Optional[bool] = None

    def decode_frame(self, frame: bytes) -> Optional[np.ndarray]:
        from .mp2dec import Mp2Decoder, _to_i16
        hdr = parse_mpa_header(frame[:4])
        if hdr is None or hdr.layer != 3:
            return None
        nch = 1 if hdr.mode == 3 else 2
        sfreq = _MPA_SFI[hdr.sample_rate]
        if hdr.version == 1:
            side_len = 17 if nch == 1 else 32
        else:                              # LSF: one granule
            side_len = 9 if nch == 1 else 17
        skip = 4 + (0 if hdr.protection else 2)
        if len(frame) < skip + side_len:
            return None
        mdb, scfsi, grans = _read_side_info(frame, hdr, nch)
        main = frame[skip + side_len:hdr.frame_bytes]
        if mdb > len(self._resv):
            self._push_resv(main)
            return None                      # reservoir not primed yet
        md = (self._resv[len(self._resv) - mdb:] if mdb else b"") + main
        self._push_resv(main)
        if self._synth is None:
            self._synth = Mp2Decoder()
        while len(self._synth._v) < nch:
            self._synth._v.append(np.zeros(1024, np.float64))
        while len(self._overlap) < nch:
            self._overlap.append(np.zeros((32, 18)))
        b = _MdBits(md)
        ngr = len(grans)                     # 2 (MPEG-1) or 1 (LSF)
        out = np.zeros((576 * ngr, nch), np.float64)
        ok = True
        for gr in range(ngr):
            xr = []
            for ch in range(nch):
                g = grans[gr][ch]
                start = b.pos
                end = start + g.part2_3_length
                if end > b.nbits:
                    return None              # truncated stream tail
                if hdr.version != 1:
                    _read_scalefactors_lsf(
                        b, g, hdr.mode == 1 and bool(hdr.mode_ext & 1)
                        and ch == 1)
                else:
                    _read_scalefactors(b, g, scfsi[ch],
                                       grans[0][ch] if gr else None,
                                       gr)
                ix = _decode_huffman(b, g, sfreq, end)
                ok = ok and (b.pos == end)
                xr.append(_requantize(ix, g, sfreq))
                xr[ch] = _reorder_short(xr[ch], g, sfreq)
            if nch == 2 and hdr.mode == 1:
                xr = _stereo(xr, grans[gr], sfreq, hdr.mode_ext)
            for ch in range(nch):
                g = grans[gr][ch]
                xa = _antialias(xr[ch], g)
                sb = _imdct_granule(xa, g, self._overlap[ch])
                for i in range(18):
                    out[576 * gr + 32 * i:576 * gr + 32 * i + 32, ch] \
                        = self._synth._synth(ch, sb[:, i])
        self.granule_bit_check = ok
        return _to_i16(out)

    def _push_resv(self, main: bytes) -> None:
        self._resv = (self._resv + main)[-511:]


_MPA_SFI = {44100: 0, 48000: 1, 32000: 2,        # MPEG-1
            22050: 3, 24000: 4, 16000: 5,        # MPEG-2 LSF
            11025: 6, 12000: 7, 8000: 8}         # MPEG-2.5


def decode_stream(data: bytes) -> Tuple[np.ndarray, int, int]:
    """Whole MP3 elementary stream -> (pcm (S, C) int16, rate,
    channels); resyncs on garbage between frames."""
    dec = Mp3Decoder()
    chunks = []
    rate = 0
    nch = 1
    pos = 0
    n = len(data)
    while pos + 4 <= n:
        hdr = parse_mpa_header(data[pos:pos + 4])
        if hdr is None or hdr.layer != 3 or hdr.frame_bytes <= 4:
            pos += 1
            continue
        pcm = dec.decode_frame(data[pos:pos + hdr.frame_bytes])
        if pcm is not None:
            chunks.append(pcm)
            rate = hdr.sample_rate
            nch = pcm.shape[1]
        pos += hdr.frame_bytes
    if not chunks:
        raise ValueError("mp3dec: no decodable Layer III frames")
    return np.concatenate(chunks), rate, nch
