# Copied from tcforge_tpu/io/aacdec.py; only the package name in its imports differs.
"""Native MPEG-2/4 AAC-LC decoder.

The last bridge-only audio codec in this tree: the reference imported
AAC only through external faad-era code, and this framework through
libavcodec (AvFileAudio).  This is a from-scratch Low Complexity
profile decoder — ADTS and raw-packet (AudioSpecificConfig) framing,
SCE/CPE/LFE elements, section/scalefactor/spectral decode over the
eleven spectral Huffman codebooks, pulse data, M/S and intensity
stereo, TNS all-pole filtering, PNS noise substitution, and the
2048/256 IMDCT filterbank with sine/KBD window-shape switching.

Fixed spec tables (the Huffman codebooks of ISO 14496-3 Table 4.A,
the scalefactor-band offsets per sampling rate, TNS band limits) are
numeric constants of the published spec, recovered from the public
libavcodec binary in this container (each codebook verifies as a
complete prefix code, and the swb tables carry the spec's band
counts per rate).  Correctness is validated against the bundled
libavcodec decoder across rates/modes/window sequences
(tests/test_aacdec.py).

PNS noise (codebook 13) is decoder-private by definition (the spec
fixes only the band energy, not the RNG); this decoder reproduces
libavcodec's LCG (state*1664525+1013904223, seed 0x1f2e3d4c, band
energy normalization) drawn in its exact decode order, so even
PNS-heavy frames compare to ~1 LSB against the bundled oracle.
Gated with clear errors: CCE (coupling), SSR/LTP-only tools,
960-sample frames.
"""

from __future__ import annotations

import base64
import zlib
from typing import List, Optional, Tuple

import numpy as np

__all__ = ["AacDecoder", "decode_adts_stream", "parse_adts_header",
           "parse_asc"]

SAMPLE_RATES = (96000, 88200, 64000, 48000, 44100, 32000, 24000,
                22050, 16000, 12000, 11025, 8000)

_TAB_META = [
    ("cb_sizes", "<i8", (11,), 88), ("cb_bits", "|u1", (1241,), 1241),
    ("cb_codes", "<u2", (1241,), 2482), ("sf_bits", "|u1", (121,), 121),
    ("sf_codes", "<u4", (121,), 484),
    ("swb_long_flat", "<u2", (553,), 1106),
    ("swb_long_len", "<i8", (12,), 96),
    ("swb_short_flat", "<u2", (180,), 360),
    ("swb_short_len", "<i8", (12,), 96),
    ("tns_max_1024", "|u1", (12,), 12), ("tns_max_128", "|u1", (12,), 12)]

_TAB_B64 = (
    "eNrdV2eQHFe1PmfOzJyentm96wDIYGjZz2BZCFk2wgEMI3h+Vf7BD6jigQADAgw4yLZsbF"
    "JRtf7BDwqMc45ylnPOSbZlWVYOK2m1eVcbZmdnZiennd3l656ZtS3sKmJR0FNf39v33j73"
    "nO+EvvN1ql9f/yvbZQe09x/QHsH1NhwK22rX7xrQkNcPaah+90bce4ADc/25We+t0Nxbdn"
    "PcCloh/IIaDABWSC13RN8ZwT0gQLA+0py1rPoavzvu7uWNs9/yB6xQyPYHQ8FgCJ2Q3RIK"
    "hcN2xB+0g2rbdiSgYXQwiCkrFLHDEcs2obBpaW2z7NaQ3RqJmHCkzQ4bdCAt4Id+4YDXsf"
    "CiFbYsO2yHMeXHiGXj7verq49lq7pbWlgDM+0I7t6Iq4B3D7dE3Hs4ghaiQtgdE5a6vXAI"
    "W0D7sG2pnyHxnZFwc83cWy0RdN0WA+5le0vUXQRe3As0gB6/H/S8T6e5pv6WuhY15LAEva"
    "0E6ywICdYbGOI1dv0OJ3qtq5rbeOq4hkWgsSfAL25HYUG9DQYCnijFvq6e6Lgi7ZB7d2V5"
    "95CN/a1QXVRLS0MJ29sh+K5+xOXDW+auC73Tj7S4CrldT0A41BhGvyXcFNvSfPCeWltaPZ"
    "94i1pbWyN1OV7fRBp9PBjTMtfHU9CzJ1Q3u2mlp3rQ37DV1Qp2N2bw4Bo/9+Ax4Bnv0um5"
    "wWPA5daymv25B7vBtucmb1O70a2ba3tdtx/2nNHwRyTiOaSpqBtwgaaujbc93zTc4I00nf"
    "TOQD1K3megqYJVV3NuwdxA89mGq+vLG89hq2FM8zlshd/1HPYGbC+Hm3a5A3OXNxCqx9/c"
    "szvwngVhpPi7HyORUFPTpsKBsmZ4WgtyJqWlpAkuaEYupLxcRAfRL2iCV1JRajrIGU3zD6"
    "nIWY3zlGb5LEryL+kjdD6N8hk0wj+jD9GP6GCUykPpJ/RhOpfG+cc0zOfQIXQB7edVlOMZ"
    "HeOcTvIKSnFah7iqOTmbYnwxtdHPKc/nUUmKOsAVzcpPqcCzWuK85vh8muYJ+h+KU4ljVO"
    "UsfYZW0XwK0qfpPFpA41Thn1KZxuhjlIGcc/BughbSSlpENh1NP6OPUoGOIoscCkFDpY9T"
    "mJbQJB1OZ9AnKELHUI6OpTTV+ALKcp6OoFEq0ZlU5hQdCXuOIx99ipL0STqbpvhCmoH9i6"
    "lIs3wuOCFInYTEwyBhgkc5KzZ9jiZ5KZ0IFpIMqyXFSak6Cc7CurKWpWwsOgncnkAXU0Ym"
    "JCF5Mw+M5/VkuogmJcd5LmqM41JzspThKVOQnNZMChzNtKfhp+n2KacanZ3NwHO1aJxTMh"
    "UtmqqptWe1YGZm8/DnVHvJVEy1XeGRIs0DA5PQK0dlPQy+S8JnTEPQehVkpDhDVU3RMGXh"
    "hUmZ1gB8mYVtfhqhPMUQFUHwMEYCDs+h/XQWfDoBpopyHnjJc0LSXJECJWhK44iMklTg4V"
    "kzjmgoy0rwWYCW4FdLiLIZk5QM7JhB9NV01imZvMYwnlIwZKadaZPRmMQ4TQn3La2avJnE"
    "2zFom6A0mMnphE5wHN61wH0KliU1LVnEUhga2oi7HI3rpKZ4EraHEB0T8EdCizoBfpN0IS"
    "InA7+UtGjSOi5JMBCHFWWtmJpTMwUTh/5ZKeiUmXFmdBr6TsAvcU5zDfwUZQS7r8Q+yB7k"
    "QQlSJ+l4RNwCRMtx2A3xiuhdDP38iNZjwBp0Qfx8BjwSeDwWulYRH+chkhW+CCBiz4W9Fc"
    "TdEkTsQkTcZ2FtlssyDI3Phu1nIT7gKZnVihQRXWUe5wJPgUPC+ydiNosodK3yI7I/B+0S"
    "4CaFNSfQUtgcx9vjnOOC/BzSJqB5BvYkpCo5REQM+k1KRioypUlYE0fE5qQMT9Y0JQlYj7"
    "gCQ9NmxhRdtqUoVZ1GZM6aVuzfBr3Pd/XjGXHjxI+asAh6X4z8NLA6iJhaDBsuREYeixpz"
    "CGw8HhwmqApNPw1mjgMDq2BDBbufCevPQY6nqEI1KfNF4CsJjYvIummehsZ55GmJp7jGs1"
    "K3f4z6eKvskw26RTeYXjPsJJw6E67tSRriHbJLBqRTt5ndxuXkAsR2ggZ5m/RKt2zXt0yH"
    "GTaj0GKcenk/75Qe2awbtU87Tdx0O/2I+h7k+W7pk03aqz26xQyZMTPobJcBHuY98qbu0G"
    "7daQZ0n5kw+51xZ52O8F5Zr9u0SzeZLrPfjJtRJ+eUnF3aKYPSoft0l+kzvc4+Z8iJOxmn"
    "6OzUDumSt3SvDulW0206nZSTjuadbHRQ++Vt3aMbzXYzYkbNhDPp5KL5aCE6YLbqbl1vdp"
    "hBM+DEnLSTiZajxWitPWb69W2z1/SYHqffSToFpxKdik63z7SPOZvNHtNv+pwuZ8TJoqqU"
    "orXodHS2/UhE7scRyz+gXbSNt8teSUoa+TNtEGyI1xCq8DdoBe2mHurgLeBjTA/3vBxBXV"
    "1A36UttI+2cg/vQ0x9EnlpUwvi+lv0Q9pMvbSZ+3iXjMn3UHEdVPij6duoyJ3UTzt5iHsl"
    "JTvo/5E336Tl+LpspQFUqy7ukP0yoW/z9+k7dDr9mDZSF73FG3mAuyUmCYXHaBNtp73UTe"
    "t5N3fyRvAY1wy+Yx20jfZQHw3Sdt6DSNiNCE7pFLJ/C2/gTbyD93I/ImFAJmUUlbpqJqSX"
    "d/E+7kYcbEYkxCWpOdSoisnqVmTlJumUPTIkIxLTvBZQ26ZMVRPSD68Oy6ikxa1BZeSLmy"
    "MEbg6jL9IttJ7u4yvkdawbhbwpk8BeM+YyCYBXC1lyIn2FrqJH6Uq+h5/m22St3ClbZI8+"
    "gsqtYH4enYy/LZfRXfQc3cgP8Wv8uFwnr8hGuZVOQWX/MOriF+hUupLuoVfoOn6En+c75E"
    "q5BzZfQzfRCfj+fJ6+TJfSzfQYvUG38YP8Et8ul8v9sk2uplfpSxSl/6X/o9voPnqeruE7"
    "+QV+g++V++RF6ZDbaTVfTn+iK+gGupeeoXV0Oz/Kr/KN8qo8JW/Dq2voGX6Q7qYH6Al6nd"
    "6kG/hufo4vlbtlnaxHrsXkYXpUruKX6SW6jK/nm/gufpz/JDfIs8jQHcjFXn2K+uR+vplv"
    "4Tv4AX6Yn+Q/yhPynGwFuwOyU0f0WdqvL/Iavpcf4yf4Wb5ZbpIX5Gn4ZK8OI8vj+gLFdL"
    "W8zE/xH2QdXyUPyGPyEmK5A5nbjWxJ62v4Ym2Qu+RauVUekkfkTfh0CL4b1jEd0HH49Aqc"
    "fK6WV3gtXyPXy8PyhrwmO6ULWduPr1Beq3otl/VluUUelDXypDwv2xGlIzKEqpFE5Ln182"
    "qeNj3yjLyFONqECtUlu3RQU4iOAnLKjY5b+XV+mu6g6+h6upZupNV0Jz2EP6OP05P0Iq2l"
    "yxn1FNch770OPuTggw5qO6gNlzGt3tXintfrh2Hv0IdTbcAv7B7V5w7h9fNy/bTfZtrMgW"
    "IPuGKosKPAGDACFGaVMkASKAIpYBJIAzVgGpgFZoASUAamgAowjPeraPejnZxlvMOQR5DB"
    "lEWbA/JABii2E5WASpSoAJSAHFAEsu6zg3GgguQqAUWggvqUR1tGW8GHoQQUgDIOayWgiv"
    "JVBorAr4HPAycBH3X/63ufrfplAxHgY8DJwBeAXwG/AUpAxZUBeRUgD/lFdw93L3d/oAiU"
    "gIKrC5CHnkWg7AK654G0ayvsK6ItoB0CJ/vATRfQDfQAvUAf0AnsBHYBHcBuYA+QBfqBMS"
    "AGjANxYAIYBQaAQWDI49zlX+FDpb1AAsgDuVn1LLdgcRsK0Dwcj+ejWC/AB3wJPpMnodyc"
    "Rl9DKV6BD/av6HdI/VsQni9RBz7Jh/IyvgTpQb5lvkt8a30ky+QSFC2Xyn+XzDPwCf8tCp"
    "wrcS0+K2mK8BJeDplreDsOTvN9p/lW+W6A5JivTU6SFfJ7lIbOD5S/5H31XY3yuc6TbvFR"
    "0HgF5K+G1gPQez40XwHdV2OPAeg/HxasgA2r/2v2WIsy/MH+WIpP0an0VRwSToc3VuJw+l"
    "v6PV2DvVwfb8axIU1+PpyX8td4JV+KEt6Bo9wC33LfpX+Vv/958i3Inge572WnHkFNic+B"
    "nw78QcpD5jxeBI6W8ypIXYOjQ4IP9Z3iOxPRtNnn/w+WG4HUoyDzFEj8xl9kpctogmrIo/"
    "ng9DQ+nS+CvLsRJT3gdb7vVN9KSNzgq/mWyirkEvkXNipps13SaI8/oF16wHyzXfQB7THU"
    "vN4dGXU+liEaLvmHZw4HD4vA7algdgV4/efNzmvML8WuX8W+K/+O+brWrpeW/0vmj2pkV3"
    "O+pcH2ga35gLbtb2wd58gFCz+7ePHChQuPxuGktXn9GWBdW3M="
)


def _load_tables():
    raw = zlib.decompress(base64.b64decode("".join(_TAB_B64)))
    out = {}
    pos = 0
    for name, dt, shape, nb in _TAB_META:
        out[name] = np.frombuffer(
            raw[pos:pos + nb], np.dtype(dt)).reshape(shape)
        pos += nb
    return out


class _HuffLUT:
    """Flat 2^maxlen peek LUT from explicit (codes, lens)."""

    def __init__(self, codes, lens):
        self.maxlen = int(lens.max())
        lut_sym = np.zeros(1 << self.maxlen, np.int32)
        lut_len = np.zeros(1 << self.maxlen, np.uint8)
        for sym, (c, l) in enumerate(zip(codes.tolist(), lens.tolist())):
            base = c << (self.maxlen - l)
            n = 1 << (self.maxlen - l)
            lut_sym[base:base + n] = sym
            lut_len[base:base + n] = l
        self.sym = lut_sym
        self.len = lut_len


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
        if p + n > self.nbits:
            raise EOFError("aac: truncated element")
        self.pos = p + n
        i = p >> 5
        w = (self.words[i] << 32) | self.words[i + 1]
        return (w >> (64 - (p & 31) - n)) & ((1 << n) - 1)

    def peek(self, n: int) -> int:
        p = self.pos
        i = p >> 5
        w = (self.words[i] << 32) | self.words[i + 1]
        return (w >> (64 - (p & 31) - n)) & ((1 << n) - 1)

    def huff(self, lut: _HuffLUT) -> int:
        pk = self.peek(lut.maxlen)
        ln = int(lut.len[pk])
        if ln == 0 or self.pos + ln > self.nbits:
            raise ValueError("aac: bad huffman code")
        self.pos += ln
        return int(lut.sym[pk])


# ------------------------------------------------------------------ #
# Tables
# ------------------------------------------------------------------ #

_T = None
_CB: List[Optional[_HuffLUT]] = []
_SF_LUT: Optional[_HuffLUT] = None
_SWB_LONG: List[np.ndarray] = []
_SWB_SHORT: List[np.ndarray] = []
_TNS_MAX_LONG = _TNS_MAX_SHORT = None
# per-codebook tuple decode: (dim, lav, signed)
_CB_META = ((4, 1, True), (4, 1, True), (4, 2, False), (4, 2, False),
            (2, 4, True), (2, 4, True), (2, 7, False), (2, 7, False),
            (2, 12, False), (2, 12, False), (2, 16, False))


def _init_tables():
    global _T, _CB, _SF_LUT, _SWB_LONG, _SWB_SHORT
    global _TNS_MAX_LONG, _TNS_MAX_SHORT
    if _T is not None:
        return
    _T = _load_tables()
    _CB = [None]
    pos = 0
    for n in _T["cb_sizes"].tolist():
        _CB.append(_HuffLUT(_T["cb_codes"][pos:pos + n],
                            _T["cb_bits"][pos:pos + n]))
        pos += n
    _SF_LUT = _HuffLUT(_T["sf_codes"], _T["sf_bits"])
    pos = 0
    for n in _T["swb_long_len"].tolist():
        _SWB_LONG.append(_T["swb_long_flat"][pos:pos + n].astype(int))
        pos += n
    pos = 0
    for n in _T["swb_short_len"].tolist():
        _SWB_SHORT.append(_T["swb_short_flat"][pos:pos + n].astype(int))
        pos += n
    _TNS_MAX_LONG = _T["tns_max_1024"].astype(int)
    _TNS_MAX_SHORT = _T["tns_max_128"].astype(int)


# symbol index -> value tuples, precomputed per codebook
_CB_TUPLES: List[Optional[np.ndarray]] = []


def _init_tuples():
    global _CB_TUPLES
    if _CB_TUPLES:
        return
    _CB_TUPLES = [None]
    for dim, lav, signed in _CB_META:
        span = 2 * lav + 1 if signed else lav + 1
        n = span ** dim
        idx = np.arange(n)
        cols = []
        for d in range(dim):
            v = (idx // span ** (dim - 1 - d)) % span
            if signed:
                v = v - lav
            cols.append(v)
        _CB_TUPLES.append(np.stack(cols, axis=1).astype(np.int64))


# ------------------------------------------------------------------ #
# Framing
# ------------------------------------------------------------------ #

def parse_adts_header(buf: bytes) -> Optional[dict]:
    if len(buf) < 7:
        return None
    if buf[0] != 0xFF or (buf[1] & 0xF6) != 0xF0:
        return None
    protection_absent = buf[1] & 1
    profile = buf[2] >> 6
    sfi = (buf[2] >> 2) & 0xF
    if sfi >= 12:
        return None
    chan = ((buf[2] & 1) << 2) | (buf[3] >> 6)
    frame_len = ((buf[3] & 3) << 11) | (buf[4] << 3) | (buf[5] >> 5)
    nblocks = (buf[6] & 3) + 1
    if frame_len < 7:
        return None
    return {"profile": profile, "sfi": sfi, "channels": chan,
            "frame_length": frame_len, "crc_absent": protection_absent,
            "raw_blocks": nblocks,
            "header_bytes": 7 if protection_absent else 9}


def parse_asc(extradata: bytes) -> Tuple[int, int, int]:
    """AudioSpecificConfig -> (object_type, sfi, channel_config)."""
    if len(extradata) < 2:
        raise ValueError("aac: AudioSpecificConfig too short")
    b = Bits(extradata)
    otype = b.read(5)
    if otype == 31:
        otype = 32 + b.read(6)
    sfi = b.read(4)
    if sfi == 15:
        b.read(24)
    chan = b.read(4)
    return otype, sfi, chan


# ------------------------------------------------------------------ #
# Windows / IMDCT
# ------------------------------------------------------------------ #

def _kbd(n: int, alpha: float) -> np.ndarray:
    k = np.arange(n + 1)
    kais = np.i0(np.pi * alpha * np.sqrt(
        np.clip(1.0 - (2.0 * k / n - 1.0) ** 2, 0.0, 1.0)))
    csum = np.cumsum(kais)
    return np.sqrt(csum[:n] / csum[n])


_WIN = None


def _windows():
    global _WIN
    if _WIN is None:
        sin_l = np.sin(np.pi / 2048 * (np.arange(1024) + 0.5))
        sin_s = np.sin(np.pi / 256 * (np.arange(128) + 0.5))
        _WIN = {(0, 1024): sin_l, (1, 1024): _kbd(1024, 4.0),
                (0, 128): sin_s, (1, 128): _kbd(128, 6.0)}
    return _WIN


_IMDCT = {}


def _imdct_mat(nc: int) -> np.ndarray:
    """AAC IMDCT (14496-3 4.6.11.1): N = 2*nc outputs,
    x[n] = 2/N * sum_k X[k] cos(2pi/N (n + (N/2+1)/2)(k + 1/2))."""
    if nc not in _IMDCT:
        n2 = 2 * nc
        n0 = (nc + 1) / 2.0
        n_ = np.arange(n2)[:, None]
        k = np.arange(nc)[None, :]
        _IMDCT[nc] = (2.0 / n2) * np.cos(
            2.0 * np.pi / n2 * (n_ + n0) * (k + 0.5))
    return _IMDCT[nc]


# ------------------------------------------------------------------ #
# Element state
# ------------------------------------------------------------------ #

class _Ics:
    __slots__ = ("window_sequence", "window_shape", "max_sfb",
                 "num_windows", "groups", "swb", "nswb", "global_gain",
                 "cbs", "sfs", "tns", "pulse", "coefs")


_ONLY_LONG, _LONG_START, _EIGHT_SHORT, _LONG_STOP = 0, 1, 2, 3


class AacDecoder:
    """Stateful AAC-LC decoder: overlap buffers and window shapes
    carry across frames.  decode_raw() takes one raw AAC access unit
    (no ADTS) plus the stream's sampling-frequency index and channel
    configuration (1 = mono, 2 = stereo)."""

    def __init__(self):
        _init_tables()
        _init_tuples()
        self._overlap = {}                # ch -> (1024,)
        self._prev_shape = {}             # ch -> 0/1
        self._lfsr = 0x1F2E3D4C
        self.sample_rate = 0
        self.channels = 0

    # ------------------------------------------------------------- #

    def _noise(self, n: int) -> np.ndarray:
        """PNS noise: the spec leaves the RNG decoder-private; this
        uses libavcodec's LCG (state*1664525+1013904223, signed int32
        values, seed 0x1f2e3d4c) so outputs are comparable with the
        bundled oracle."""
        out = np.empty(n)
        st = self._lfsr
        for i in range(n):
            st = (st * 1664525 + 1013904223) & 0xFFFFFFFF
            out[i] = st - (1 << 32) if st & 0x80000000 else st
        self._lfsr = st
        return out

    def _ics_info(self, b: Bits, sfi: int, ics: _Ics) -> None:
        b.read(1)                          # ics_reserved
        ics.window_sequence = b.read(2)
        ics.window_shape = b.read(1)
        if ics.window_sequence == _EIGHT_SHORT:
            ics.max_sfb = b.read(4)
            grouping = b.read(7)
            groups = [1]
            for i in range(7):
                if grouping & (1 << (6 - i)):
                    groups[-1] += 1
                else:
                    groups.append(1)
            ics.groups = groups
            ics.num_windows = 8
            ics.swb = _SWB_SHORT[sfi]
        else:
            ics.max_sfb = b.read(6)
            if b.read(1):                  # predictor_data_present
                raise NotImplementedError(
                    "aac: MAIN-profile prediction not implemented "
                    "(LC decoder)")
            ics.groups = [1]
            ics.num_windows = 1
            ics.swb = _SWB_LONG[sfi]
        ics.nswb = len(ics.swb) - 1
        if ics.max_sfb > ics.nswb:
            raise ValueError("aac: max_sfb beyond swb table")

    def _section_data(self, b: Bits, ics: _Ics) -> None:
        bits = 3 if ics.window_sequence == _EIGHT_SHORT else 5
        esc = (1 << bits) - 1
        ics.cbs = []
        for _g in ics.groups:
            row = []
            k = 0
            while k < ics.max_sfb:
                cb = b.read(4)
                ln = 0
                while True:
                    inc = b.read(bits)
                    ln += inc
                    if inc != esc:
                        break
                if k + ln > ics.max_sfb:
                    raise ValueError("aac: section overruns max_sfb")
                row.extend([cb] * ln)
                k += ln
            ics.cbs.append(row)

    def _scale_factors(self, b: Bits, ics: _Ics) -> None:
        ics.sfs = []
        sf = ics.global_gain
        is_pos = 0
        noise = ics.global_gain - 90
        noise_first = True
        for g in range(len(ics.groups)):
            row = []
            for sfb in range(ics.max_sfb):
                cb = ics.cbs[g][sfb]
                if cb == 0:
                    row.append(0)
                elif cb in (14, 15):       # intensity position
                    is_pos += b.huff(_SF_LUT) - 60
                    row.append(is_pos)
                elif cb == 13:             # PNS energy
                    if noise_first:
                        noise += b.read(9) - 256
                        noise_first = False
                    else:
                        noise += b.huff(_SF_LUT) - 60
                    row.append(noise)
                else:
                    sf += b.huff(_SF_LUT) - 60
                    if not 0 <= sf <= 255:
                        raise ValueError("aac: scalefactor range")
                    row.append(sf)
            ics.sfs.append(row)

    def _pulse_data(self, b: Bits) -> list:
        n = b.read(2) + 1
        start_sfb = b.read(6)
        pulses = []
        for _ in range(n):
            pulses.append((b.read(5), b.read(4)))
        return [start_sfb, pulses]

    def _tns_data(self, b: Bits, ics: _Ics) -> list:
        short = ics.window_sequence == _EIGHT_SHORT
        out = []
        for _w in range(ics.num_windows):
            n_filt = b.read(1 if short else 2)
            filts = []
            coef_res = b.read(1) if n_filt else 0
            for _f in range(n_filt):
                length = b.read(4 if short else 6)
                order = b.read(3 if short else 5)
                if order:
                    direction = b.read(1)
                    compress = b.read(1)
                    nb = coef_res + 3 - compress
                    coefs = [b.read(nb) for _ in range(order)]
                    filts.append((length, order, direction, compress,
                                  coef_res, coefs))
                else:
                    filts.append((length, 0, 0, 0, coef_res, []))
            out.append(filts)
        return out

    def _spectral_data(self, b: Bits, ics: _Ics) -> np.ndarray:
        """Returns quantized values laid out per (group, sfb, win-
        interleaved) — the bitstream order — then deinterleaved."""
        short = ics.window_sequence == _EIGHT_SHORT
        coefs = np.zeros((8, 128) if short else (1, 1024))
        swb = ics.swb
        win0 = 0
        for g, gwin in enumerate(ics.groups):
            gbuf = np.zeros(128 * gwin) if short else coefs[0]
            for sfb in range(ics.max_sfb):
                cb = ics.cbs[g][sfb]
                if cb == 0 or cb >= 12:
                    continue
                dim, lav, signed = _CB_META[cb - 1]
                lut = _CB[cb]
                tup = _CB_TUPLES[cb]
                lo = int(swb[sfb]) * (gwin if short else 1)
                hi = int(swb[sfb + 1]) * (gwin if short else 1)
                i = lo
                while i < hi:
                    sym = b.huff(lut)
                    vals = tup[sym].copy()
                    if not signed:
                        for j in range(dim):
                            if vals[j] and b.read(1):
                                vals[j] = -vals[j]
                    if cb == 11:
                        for j in range(dim):
                            if abs(vals[j]) == 16:
                                nn = 4
                                while b.read(1):
                                    nn += 1
                                mag = (1 << nn) | b.read(nn)
                                vals[j] = -mag if vals[j] < 0 else mag
                    gbuf[i:i + dim] = vals
                    i += dim
            if short:
                # deinterleave: within the group, sfb-major data is
                # (width x gwin) interleaved across the group windows
                for sfb in range(ics.nswb):
                    w0 = int(swb[sfb])
                    w1 = int(swb[sfb + 1])
                    width = w1 - w0
                    seg = gbuf[w0 * gwin:w1 * gwin]
                    if not len(seg):
                        continue
                    seg = seg.reshape(gwin, width)
                    for wi in range(gwin):
                        coefs[win0 + wi, w0:w1] = seg[wi]
                win0 += gwin
        return coefs

    # ------------------------------------------------------------- #

    def _dequant(self, ics: _Ics, q: np.ndarray) -> np.ndarray:
        out = np.zeros_like(q, dtype=np.float64)
        short = ics.window_sequence == _EIGHT_SHORT
        swb = ics.swb
        win0 = 0
        for g, gwin in enumerate(ics.groups):
            for sfb in range(ics.max_sfb):
                cb = ics.cbs[g][sfb]
                if cb in (0, 13, 14, 15):
                    continue
                gain = 2.0 ** (0.25 * (ics.sfs[g][sfb] - 100))
                lo, hi = int(swb[sfb]), int(swb[sfb + 1])
                for wi in range(gwin if short else 1):
                    w = win0 + wi
                    v = q[w, lo:hi]
                    out[w, lo:hi] = np.sign(v) * np.abs(v) ** (4.0 / 3.0) \
                        * gain
            win0 += gwin
        return out

    def _apply_pns(self, ics: _Ics, x: np.ndarray) -> None:
        short = ics.window_sequence == _EIGHT_SHORT
        swb = ics.swb
        win0 = 0
        for g, gwin in enumerate(ics.groups):
            for sfb in range(ics.max_sfb):
                if ics.cbs[g][sfb] != 13:
                    continue
                lo, hi = int(swb[sfb]), int(swb[sfb + 1])
                gain = 2.0 ** (0.25 * ics.sfs[g][sfb])
                for wi in range(gwin if short else 1):
                    nz = self._noise(hi - lo)
                    # band ENERGY (not per-sample rms) equals gain^2
                    nz *= gain / max(np.sqrt((nz * nz).sum()), 1e-9)
                    x[win0 + wi, lo:hi] = nz
            win0 += gwin

    def _apply_tns(self, ics: _Ics, x: np.ndarray, sfi: int) -> None:
        if not ics.tns:
            return
        short = ics.window_sequence == _EIGHT_SHORT
        tns_max = int((_TNS_MAX_SHORT if short else _TNS_MAX_LONG)[sfi])
        # the filter-region stack runs over ALL swbs; the band limit
        # clamps only the offset lookup (4.6.9.3 / libavcodec)
        max_band = min(ics.max_sfb, tns_max)
        swb = ics.swb
        max_order = 7 if short else 12
        for w, filts in enumerate(ics.tns):
            bottom = ics.nswb
            for (length, order, direction, compress, coef_res,
                 coefs) in filts:
                top = bottom
                bottom = max(top - length, 0)
                order = min(order, max_order)
                if order == 0:
                    continue
                # inverse-quantize reflection coefficients (4.6.9.3)
                nb = coef_res + 3 - compress
                iqfac = ((1 << (coef_res + 2)) - 0.5) / (np.pi / 2.0)
                iqfac_m = ((1 << (coef_res + 2)) + 0.5) / (np.pi / 2.0)
                refl = []
                for c in coefs[:order]:
                    if c >= (1 << (nb - 1)):
                        c -= (1 << nb)
                    refl.append(np.sin(c / (iqfac if c >= 0
                                             else iqfac_m)))
                # reflection -> LPC
                a = np.zeros(order + 1)
                a[0] = 1.0
                for m in range(1, order + 1):
                    b_ = a.copy()
                    for i in range(1, m):
                        b_[i] = a[i] + refl[m - 1] * a[m - i]
                    b_[m] = refl[m - 1]
                    a = b_
                lo = int(swb[min(bottom, max_band)])
                hi = int(swb[min(top, max_band)])
                if hi <= lo:
                    continue
                seg = x[w, lo:hi]
                n = len(seg)
                if direction:
                    idx = range(n - 1, -1, -1)
                    step = -1
                else:
                    idx = range(n)
                    step = 1
                for i in idx:
                    acc = seg[i]
                    for j in range(1, order + 1):
                        k = i - step * j
                        if 0 <= k < n:
                            acc -= a[j] * seg[k]
                    seg[i] = acc

    def _filterbank(self, ch, ics: _Ics, x: np.ndarray) -> np.ndarray:
        W = _windows()
        # at stream start the "previous" shape is 0 (sine) by
        # convention (libavcodec initializes use_kbd_window to 0)
        prev = self._prev_shape.get(ch, 0)
        cur = ics.window_shape
        overlap = self._overlap.get(ch)
        if overlap is None:
            overlap = np.zeros(1024)
        wl_long = W[(prev, 1024)]
        wr_long = W[(cur, 1024)][::-1]
        wl_short_prev = W[(prev, 128)]
        wl_short = W[(cur, 128)]
        wr_short = W[(cur, 128)][::-1]
        seq = ics.window_sequence
        if seq == _EIGHT_SHORT:
            buf = np.zeros(2048)
            im = _imdct_mat(128)
            for w in range(8):
                t = im @ x[w]
                left = wl_short_prev if w == 0 else wl_short
                t[:128] *= left
                t[128:] *= wr_short
                pos = 448 + 128 * w
                buf[pos:pos + 256] += t
        else:
            t = _imdct_mat(1024) @ x[0]
            buf = np.empty(2048)
            buf[:] = t
            if seq == _ONLY_LONG:
                buf[:1024] *= wl_long
                buf[1024:] *= wr_long
            elif seq == _LONG_START:
                buf[:1024] *= wl_long
                buf[1024:1472] *= 1.0
                buf[1472:1600] *= wr_short
                buf[1600:] = 0.0
            else:                          # LONG_STOP
                buf[:448] = 0.0
                buf[448:576] *= wl_short_prev
                buf[576:1024] *= 1.0
                buf[1024:] *= wr_long
        out = buf[:1024] + overlap
        self._overlap[ch] = buf[1024:].copy()
        self._prev_shape[ch] = cur
        return out

    # ------------------------------------------------------------- #

    def _ics_stream(self, b: Bits, sfi: int, ics: _Ics,
                    common_window: bool) -> np.ndarray:
        ics.global_gain = b.read(8)
        if not common_window:
            self._ics_info(b, sfi, ics)
        self._section_data(b, ics)
        self._scale_factors(b, ics)
        ics.pulse = None
        if b.read(1):                      # pulse_data_present
            if ics.window_sequence == _EIGHT_SHORT:
                raise ValueError("aac: pulse data in short window")
            ics.pulse = self._pulse_data(b)
        ics.tns = None
        if b.read(1):                      # tns_data_present
            ics.tns = self._tns_data(b, ics)
        if b.read(1):                      # gain_control_data_present
            raise NotImplementedError("aac: SSR gain control")
        q = self._spectral_data(b, ics)
        if ics.pulse is not None:
            start_sfb, pulses = ics.pulse
            base = int(ics.swb[min(start_sfb, ics.nswb)])
            k = base
            for off, amp in pulses:
                k += off
                if k < q.shape[1]:
                    q[0, k] += amp if q[0, k] >= 0 else -amp
        x = self._dequant(ics, q)
        # PNS draws happen here, in per-channel decode order, so the
        # shared LCG stays in step with libavcodec's
        self._apply_pns(ics, x)
        ics.coefs = x
        return x

    def decode_raw(self, packet: bytes, sfi: int,
                   chan_config: int) -> np.ndarray:
        """One raw access unit -> (1024, channels) float at 16-bit
        PCM scale (the spec's dequantization lands there for int16
        sources; divide by 32768 for [-1,1))."""
        if not 0 <= sfi < 12:
            raise ValueError("aac: bad sampling frequency index")
        self.sample_rate = SAMPLE_RATES[sfi]
        b = Bits(packet)
        outs = {}
        order = []
        while b.pos + 3 <= b.nbits:
            ele = b.read(3)
            if ele == 7:                   # END
                break
            if ele in (0, 3):              # SCE / LFE
                tag = ("s" if ele == 0 else "l", b.read(4))
                ics = _Ics()
                x = self._ics_stream(b, sfi, ics, False)
                self._apply_tns(ics, x, sfi)
                outs[tag] = self._filterbank(tag, ics, x)
                order.append(tag)
            elif ele == 1:                 # CPE
                tagbase = b.read(4)
                common = b.read(1)
                ics1, ics2 = _Ics(), _Ics()
                ms_mask = 0
                ms_used = None
                if common:
                    self._ics_info(b, sfi, ics1)
                    for attr in ("window_sequence", "window_shape",
                                 "max_sfb", "num_windows", "groups",
                                 "swb", "nswb"):
                        setattr(ics2, attr, getattr(ics1, attr))
                    ms_mask = b.read(2)
                    if ms_mask == 1:
                        ms_used = [[b.read(1)
                                    for _ in range(ics1.max_sfb)]
                                   for _g in ics1.groups]
                    elif ms_mask == 3:
                        raise ValueError("aac: reserved ms_mask")
                t1 = ("c0", tagbase)
                t2 = ("c1", tagbase)
                x1 = self._ics_stream(b, sfi, ics1, bool(common))
                x2 = self._ics_stream(b, sfi, ics2, bool(common))
                if common:
                    self._stereo(ics1, ics2, x1, x2, ms_mask, ms_used)
                self._apply_tns(ics1, x1, sfi)
                self._apply_tns(ics2, x2, sfi)
                outs[t1] = self._filterbank(t1, ics1, x1)
                outs[t2] = self._filterbank(t2, ics2, x2)
                order.extend([t1, t2])
            elif ele == 4:                 # DSE
                b.read(4)
                align = b.read(1)
                cnt = b.read(8)
                if cnt == 255:
                    cnt += b.read(8)
                if align:
                    b.pos = (b.pos + 7) // 8 * 8
                b.pos += 8 * cnt
            elif ele == 6:                 # FIL
                cnt = b.read(4)
                if cnt == 15:
                    cnt += b.read(8) - 1
                b.pos += 8 * cnt
            elif ele == 5:                 # PCE
                self._skip_pce(b)
            else:                          # CCE
                raise NotImplementedError(
                    "aac: coupling channel element not implemented")
            if len(order) >= max(chan_config, 1) and chan_config:
                break
        if not order:
            raise ValueError("aac: no audio elements in access unit")
        chans = [outs[t] for t in order]
        self.channels = len(chans)
        return np.stack(chans, axis=1)

    def _stereo(self, ics1, ics2, x1, x2, ms_mask, ms_used) -> None:
        swb = ics1.swb
        short = ics1.window_sequence == _EIGHT_SHORT
        win0 = 0
        for g, gwin in enumerate(ics1.groups):
            for sfb in range(min(ics1.max_sfb, ics2.max_sfb)):
                cb2 = ics2.cbs[g][sfb]
                lo, hi = int(swb[sfb]), int(swb[sfb + 1])
                wins = range(win0, win0 + (gwin if short else 1))
                ms = (ms_mask == 2 or
                      (ms_mask == 1 and ms_used[g][sfb]))
                if cb2 in (14, 15):        # intensity stereo
                    sign = 1.0 if cb2 == 15 else -1.0
                    if ms:
                        sign = -sign
                    scale = sign * 2.0 ** (-0.25 * ics2.sfs[g][sfb])
                    for w in wins:
                        x2[w, lo:hi] = x1[w, lo:hi] * scale
                elif ms and cb2 != 13 and ics1.cbs[g][sfb] != 13:
                    for w in wins:
                        mid = x1[w, lo:hi].copy()
                        side = x2[w, lo:hi].copy()
                        x1[w, lo:hi] = mid + side
                        x2[w, lo:hi] = mid - side
            win0 += gwin

    def _skip_pce(self, b: Bits) -> None:
        b.read(4)                          # tag
        b.read(2)                          # object type
        b.read(4)                          # sfi
        nfront = b.read(4)
        nside = b.read(4)
        nback = b.read(4)
        nlfe = b.read(2)
        nassoc = b.read(3)
        ncc = b.read(4)
        if b.read(1):
            b.read(4)                      # mono mixdown
        if b.read(1):
            b.read(4)                      # stereo mixdown
        if b.read(1):
            b.read(3)                      # matrix mixdown
        for _ in range(nfront + nside + nback):
            b.read(5)
        for _ in range(nlfe + nassoc):
            b.read(4)
        for _ in range(ncc):
            b.read(5)
        b.pos = (b.pos + 7) // 8 * 8
        n = b.read(8)
        b.pos += 8 * n


def decode_adts_stream(data: bytes) -> Tuple[np.ndarray, int, int]:
    """Whole ADTS stream -> (pcm (S, C) int16, rate, channels);
    resyncs on garbage between frames."""
    dec = AacDecoder()
    chunks = []
    rate = 0
    pos = 0
    n = len(data)
    while pos + 7 <= n:
        h = parse_adts_header(data[pos:pos + 9])
        if h is None or pos + h["frame_length"] > n:
            pos += 1
            continue
        if h["profile"] != 1:              # 1 = LC in ADTS coding
            raise NotImplementedError(
                f"aac: ADTS profile {h['profile']} (only LC)")
        payload = data[pos + h["header_bytes"]:pos + h["frame_length"]]
        try:
            pcm = dec.decode_raw(payload, h["sfi"], h["channels"])
        except (ValueError, EOFError):
            pos += 1
            continue
        chunks.append(pcm)
        rate = dec.sample_rate
        pos += h["frame_length"]
    if not chunks:
        raise ValueError("aac: no decodable ADTS frames")
    pcm = np.concatenate(chunks)
    out = np.clip(np.rint(pcm), -32768, 32767).astype(np.int16)
    return out, rate, chunks[0].shape[1]
