# Copied from tcforge_tpu/io/mp2dec.py; only the package name in its imports differs.
"""Native MPEG-1 audio Layer I/II decoder (ISO 11172-3).

The reference imports MPEG audio through external decoders
(import/import_mp3.c pipes through mpg123; the bridge path here uses
libavcodec).  This is a from-scratch spec implementation of Layers I
and II — the audio codecs of VCD/SVCD/DVD program streams this
framework transcodes — so MPEG audio decodes with no external
library at all.

Fixed spec tables (Layer II bit-allocation tables B.2a-d, the
quantization class steps/bits, and the 512-tap synthesis window
D of Table B.3, stored as its integer numerators x 65536) are
numeric constants of the published spec, recovered from the public
libavcodec binary in this container; correctness is validated
against the bundled libavcodec decoder to >= 70 dB SNR across
rates/modes (tests/test_mp2.py) — Layer I/II conformance is
tolerance-based by definition (the spec's synthesis is real-valued),
so unlike the lossless/integer codecs in this tree the oracle match
is an SNR bound, not bit-exactness.

Layer III lives in io/mp3dec.py; StreamDecoder below dispatches all
three layers so importers get one fallback entry point.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

__all__ = ["Mp2Decoder", "MpaHeader", "parse_mpa_header",
           "decode_stream"]


# ------------------------------------------------------------------ #
# MPEG audio frame header (all layers; io/mp3.py's parser is Layer
# III-specific and drops the fields Layer I/II need)
# ------------------------------------------------------------------ #

_L1_KBPS = (0, 32, 64, 96, 128, 160, 192, 224, 256, 288, 320, 352,
            384, 416, 448)
_L2_KBPS = (0, 32, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224, 256,
            320, 384)
_L3_KBPS = (0, 32, 40, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224,
            256, 320)
_MPA_RATES = (44100, 48000, 32000)
# MPEG-2 LSF (ISO 13818-3): half rates, dedicated bitrate tables
_L1_KBPS_V2 = (0, 32, 48, 56, 64, 80, 96, 112, 128, 144, 160, 176,
               192, 224, 256)
_L23_KBPS_V2 = (0, 8, 16, 24, 32, 40, 48, 56, 64, 80, 96, 112, 128,
                144, 160)
_MPA_RATES_V2 = (22050, 24000, 16000)
_MPA_RATES_V25 = (11025, 12000, 8000)


@dataclass
class MpaHeader:
    layer: int            # 1, 2, 3
    version: int          # 1 = MPEG-1 (LSF variants report 2/25)
    protection: int       # 1 = no CRC present
    bitrate_kbps: int
    sample_rate: int
    padding: int
    mode: int             # 0 stereo, 1 joint, 2 dual, 3 mono
    mode_ext: int
    frame_bytes: int


def parse_mpa_header(hbuf: bytes) -> Optional[MpaHeader]:
    if len(hbuf) < 4:
        return None
    h = int.from_bytes(hbuf[:4], "big")
    if (h >> 21) & 0x7FF != 0x7FF:
        return None
    version_bits = (h >> 19) & 3
    layer_bits = (h >> 17) & 3
    if version_bits == 1 or layer_bits == 0:
        return None
    version = {3: 1, 2: 2, 0: 25}[version_bits]
    layer = 4 - layer_bits
    protection = (h >> 16) & 1
    bri = (h >> 12) & 0xF
    sfi = (h >> 10) & 3
    if bri in (0, 15) or sfi == 3:
        return None
    if version == 1:
        kbps = (_L1_KBPS, _L2_KBPS, _L3_KBPS)[layer - 1][bri]
        rate = _MPA_RATES[sfi]
    else:                                 # MPEG-2 LSF / MPEG-2.5
        kbps = (_L1_KBPS_V2 if layer == 1 else _L23_KBPS_V2)[bri]
        rate = (_MPA_RATES_V2 if version == 2
                else _MPA_RATES_V25)[sfi]
    padding = (h >> 9) & 1
    mode = (h >> 6) & 3
    mode_ext = (h >> 4) & 3
    if layer == 1:
        nbytes = (12000 * kbps // rate + padding) * 4
    elif layer == 3 and version != 1:
        nbytes = 72000 * kbps // rate + padding   # 576-sample frames
    else:
        nbytes = 144000 * kbps // rate + padding
    return MpaHeader(layer, version, protection, kbps, rate, padding,
                     mode, mode_ext, nbytes)


# ------------------------------------------------------------------ #
# Quantization classes (Layer II).  steps: number of quantization
# levels; bits < 0: |bits| for a grouped triplet, else bits per
# sample.
# ------------------------------------------------------------------ #

QUANT_STEPS = (3, 5, 7, 9, 15, 31, 63, 127, 255, 511, 1023, 2047,
               4095, 8191, 16383, 32767, 65535)
QUANT_BITS = (-5, -7, 3, -10, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14,
              15, 16)

# Bit-allocation tables (spec Tables B.2a-d).  Per subband:
# (nbal, (class indices)).  Tables a and b share rows (a = first 27
# subbands, b = all 30); c and d share rows (c = 8, d = 12).
_ROW_A0 = (4, (0, 2, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16))
_ROW_A1 = (4, (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 16))
_ROW_A2 = (3, (0, 1, 2, 3, 4, 5, 16))
_ROW_A3 = (2, (0, 1, 16))
_TABLE_AB = (_ROW_A0,) * 3 + (_ROW_A1,) * 8 + (_ROW_A2,) * 12 \
    + (_ROW_A3,) * 7
_ROW_C0 = (4, (0, 1, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15))
_ROW_C1 = (3, (0, 1, 3, 4, 5, 6, 7))
_TABLE_CD = (_ROW_C0,) * 2 + (_ROW_C1,) * 10
# MPEG-2 LSF Layer II table (13818-3 Table B.1): one table for all
# LSF rates/bitrates, 30 subbands.  NOTE the nbal-3/2 rows SKIP
# class 2 (the 7-step quantizer): (0,1,3,...) — recovered from the
# bundled libavcodec .rodata (alloc_table at offset 1334368) and
# oracle-verified to 1 LSB; the "obvious" dense 0..7 indexing
# decodes garbage at any bitrate that reaches those subbands.
_ROW_L0 = (4, tuple(range(15)))
_ROW_L1 = (3, (0, 1, 3, 4, 5, 6, 7))
_ROW_L2 = (2, (0, 1, 3))
_TABLE_LSF = (_ROW_L0,) * 4 + (_ROW_L1,) * 7 + (_ROW_L2,) * 19

# scalefactors: sf[i] = 2^(1 - i/3), 63 entries (index 63 illegal)
SCALEFACTORS = tuple(2.0 ** (1.0 - i / 3.0) for i in range(64))


def _alloc_table(sample_rate: int, bitrate_kbps: int, nch: int,
                 version: int = 1) -> Tuple[tuple, int]:
    """Layer II table selection (spec 2.4.2.3 / Table B.2; LSF uses
    the single 13818-3 Table B.1)."""
    if version != 1:
        return _TABLE_LSF, 30
    per_ch = bitrate_kbps // nch
    if per_ch <= 48:
        if sample_rate == 32000:
            return _TABLE_CD, 12          # Table B.2d
        return _TABLE_CD, 8               # Table B.2c
    if per_ch <= 80 or sample_rate == 48000:
        return _TABLE_AB, 27              # Table B.2a
    return _TABLE_AB, 30                  # Table B.2b


# ------------------------------------------------------------------ #
# Synthesis window D (Table B.3): 512 coefficients, all integer
# multiples of 1/65536.  The first 257 numerators; D[512-i] mirrors
# with a sign flip except at multiples of 64 (recovered from the
# public binary; identical to the printed spec table).
# ------------------------------------------------------------------ #

_D_HALF = (
    0, -1, -1, -1, -1, -1, -1, -2, -2, -2, -2, -3, -3, -4, -4, -5,
    -5, -6, -7, -7, -8, -9, -10, -11, -13, -14, -16, -17, -19, -21,
    -24, -26, -29, -31, -35, -38, -41, -45, -49, -53, -58, -63, -68,
    -73, -79, -85, -91, -97, -104, -111, -117, -125, -132, -139,
    -147, -154, -161, -169, -176, -183, -190, -196, -202, -208, 213,
    218, 222, 225, 227, 228, 228, 227, 224, 221, 215, 208, 200, 189,
    177, 163, 146, 127, 106, 83, 57, 29, -2, -36, -72, -111, -153,
    -197, -244, -294, -347, -401, -459, -519, -581, -645, -711,
    -779, -848, -919, -991, -1064, -1137, -1210, -1283, -1356,
    -1428, -1498, -1567, -1634, -1698, -1759, -1817, -1870, -1919,
    -1962, -2001, -2032, -2057, -2075, -2085, -2087, -2080, -2063,
    2037, 2000, 1952, 1893, 1822, 1739, 1644, 1535, 1414, 1280,
    1131, 970, 794, 605, 402, 185, -45, -288, -545, -814, -1095,
    -1388, -1692, -2006, -2330, -2663, -3004, -3351, -3705, -4063,
    -4425, -4788, -5153, -5517, -5879, -6237, -6589, -6935, -7271,
    -7597, -7910, -8209, -8491, -8755, -8998, -9219, -9416, -9585,
    -9727, -9838, -9916, -9959, -9966, -9935, -9863, -9750, -9592,
    -9389, -9139, -8840, -8492, -8092, -7640, -7134, 6574, 5959,
    5288, 4561, 3776, 2935, 2037, 1082, 70, -998, -2122, -3300,
    -4533, -5818, -7154, -8540, -9975, -11455, -12980, -14548,
    -16155, -17799, -19478, -21189, -22929, -24694, -26482, -28289,
    -30112, -31947, -33791, -35640, -37489, -39336, -41176, -43006,
    -44821, -46617, -48390, -50137, -51853, -53534, -55178, -56778,
    -58333, -59838, -61289, -62684, -64019, -65290, -66494, -67629,
    -68692, -69679, -70590, -71420, -72169, -72835, -73415, -73908,
    -74313, -74630, -74856, -74992, 75038)


def _build_window() -> np.ndarray:
    d = np.zeros(512, np.float64)
    half = np.array(_D_HALF, np.float64)
    d[:257] = half
    for i in range(1, 256):
        v = half[i]
        if i & 63:
            v = -v
        d[512 - i] = v
    return d / 65536.0


_D = _build_window()

# matrixing: N[i][k] = cos((16 + i)(2k + 1) pi / 64)
_N = np.cos((16 + np.arange(64))[:, None]
            * (2 * np.arange(32) + 1)[None, :] * np.pi / 64)


class _Bits:
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


class Mp2Decoder:
    """Stateful Layer I/II decoder: per-channel synthesis history
    carries across frames; feed whole frames (header + payload)."""

    def __init__(self):
        self._v: List[np.ndarray] = []     # per-channel V fifo (1024)

    def _synth(self, ch: int, s: np.ndarray) -> np.ndarray:
        """One 32-subband sample vector -> 32 PCM samples (float)."""
        v = self._v[ch]
        v = np.concatenate((_N @ s, v[:-64]))
        self._v[ch] = v
        # U from the V fifo, windowed by D, folded by 32
        u = np.empty(512, np.float64)
        for j in range(8):
            u[64 * j:64 * j + 32] = v[128 * j:128 * j + 32]
            u[64 * j + 32:64 * j + 64] = v[128 * j + 96:128 * j + 128]
        w = u * _D
        return w.reshape(16, 32).sum(axis=0)

    def decode_frame(self, frame: bytes) -> Optional[np.ndarray]:
        """One frame -> (nsamples, nch) int16 (1152 for Layer II,
        384 for Layer I)."""
        hdr = parse_mpa_header(frame[:4])
        if hdr is None:
            return None
        if hdr.layer == 3:
            raise NotImplementedError(
                "mp2dec: Layer III not implemented (bridge decodes it)")
        if hdr.version not in (1, 2):
            raise NotImplementedError(
                "mp2dec: MPEG-2.5 is Layer III only")
        nch = 1 if hdr.mode == 3 else 2
        while len(self._v) < nch:
            self._v.append(np.zeros(1024, np.float64))
        b = _Bits(frame)
        b.pos = 32
        if not hdr.protection:             # protection_bit == 0
            b.pos += 16                    # CRC
        if hdr.layer == 1:
            return self._layer1(b, hdr, nch)
        return self._layer2(b, hdr, nch)

    # -------------------------------------------------------------- #

    def _layer1(self, b: _Bits, hdr, nch: int) -> np.ndarray:
        bound = 32
        if hdr.mode == 1:                  # joint stereo
            bound = (hdr.mode_ext + 1) * 4
        alloc = [[0] * 32 for _ in range(nch)]
        for sb in range(bound):
            for ch in range(nch):
                alloc[ch][sb] = b.read(4)
        for sb in range(bound, 32):
            alloc[0][sb] = alloc[1][sb] = b.read(4)
        sf = [[0.0] * 32 for _ in range(nch)]
        for sb in range(32):
            for ch in range(nch):
                if alloc[ch][sb]:
                    sf[ch][sb] = SCALEFACTORS[b.read(6)]
        out = np.zeros((384, nch), np.float64)
        sam = np.zeros((nch, 32), np.float64)
        for t in range(12):
            sam[:] = 0.0
            for sb in range(32):
                shared = sb >= bound
                for ch in range(1 if shared else nch):
                    a = alloc[ch][sb]
                    if not a:
                        continue
                    nb = a + 1
                    steps = (1 << nb) - 1
                    raw = b.read(nb)
                    frac = (2 * raw + 1 - steps) / steps
                    sam[ch][sb] = frac
                    if shared:
                        sam[1][sb] = frac
                for ch in range(nch):
                    if alloc[ch][sb]:
                        sam[ch][sb] *= sf[ch][sb]
            for ch in range(nch):
                out[32 * t:32 * t + 32, ch] = self._synth(ch, sam[ch])
        return _to_i16(out)

    # -------------------------------------------------------------- #

    def _layer2(self, b: _Bits, hdr, nch: int) -> np.ndarray:
        table, sblimit = _alloc_table(hdr.sample_rate,
                                      hdr.bitrate_kbps, nch,
                                      hdr.version)
        bound = sblimit
        if hdr.mode == 1:
            bound = min((hdr.mode_ext + 1) * 4, sblimit)
        alloc = [[0] * sblimit for _ in range(nch)]
        for sb in range(bound):
            nbal = table[sb][0]
            for ch in range(nch):
                alloc[ch][sb] = b.read(nbal)
        for sb in range(bound, sblimit):
            a = b.read(table[sb][0])
            alloc[0][sb] = a
            if nch == 2:
                alloc[1][sb] = a
        scfsi = [[0] * sblimit for _ in range(nch)]
        for sb in range(sblimit):
            for ch in range(nch):
                if alloc[ch][sb]:
                    scfsi[ch][sb] = b.read(2)
        sf = [[(1.0, 1.0, 1.0)] * sblimit for _ in range(nch)]
        for sb in range(sblimit):
            for ch in range(nch):
                if not alloc[ch][sb]:
                    continue
                si = scfsi[ch][sb]
                if si == 0:
                    f = (b.read(6), b.read(6), b.read(6))
                elif si == 1:
                    a_, c_ = b.read(6), b.read(6)
                    f = (a_, a_, c_)
                elif si == 2:
                    a_ = b.read(6)
                    f = (a_, a_, a_)
                else:
                    a_, c_ = b.read(6), b.read(6)
                    f = (a_, c_, c_)
                sf[ch][sb] = tuple(SCALEFACTORS[x] for x in f)
        out = np.zeros((1152, nch), np.float64)
        sam = np.zeros((nch, 3, 32), np.float64)
        for gr in range(12):
            sam[:] = 0.0
            for sb in range(sblimit):
                shared = sb >= bound
                for ch in range(1 if shared else nch):
                    a = alloc[ch][sb]
                    if not a:
                        continue
                    cls = table[sb][1][a - 1]
                    steps = QUANT_STEPS[cls]
                    bits = QUANT_BITS[cls]
                    if bits < 0:           # grouped triplet
                        c = b.read(-bits)
                        tri = (c % steps, (c // steps) % steps,
                               c // (steps * steps))
                    else:
                        tri = (b.read(bits), b.read(bits),
                               b.read(bits))
                    for part in range(3):
                        frac = (2 * tri[part] + 1 - steps) / steps
                        sam[ch][part][sb] = frac
                        if shared and nch == 2:
                            sam[1][part][sb] = frac
                # scalefactors are per channel even above bound
                scale_part = gr >> 2
                for ch in range(nch):
                    if alloc[ch][sb]:
                        s_ = sf[ch][sb][scale_part]
                        for part in range(3):
                            sam[ch][part][sb] *= s_
            for part in range(3):
                t = 3 * gr + part
                for ch in range(nch):
                    out[32 * t:32 * t + 32, ch] = \
                        self._synth(ch, sam[ch][part])
        return _to_i16(out)


def _to_i16(x: np.ndarray) -> np.ndarray:
    return np.clip(np.rint(x * 32768.0), -32768, 32767).astype(np.int16)


def decode_stream(data: bytes) -> Tuple[np.ndarray, int, int]:
    """Whole elementary stream -> (pcm (S, C) int16, rate, channels);
    resyncs on garbage between frames."""
    dec = Mp2Decoder()
    chunks = []
    rate = 0
    nch = 1
    pos = 0
    n = len(data)
    while pos + 4 <= n:
        hdr = parse_mpa_header(data[pos:pos + 4])
        if hdr is None or hdr.version not in (1, 2) \
                or hdr.layer == 3 or hdr.frame_bytes <= 4:
            pos += 1
            continue
        pcm = dec.decode_frame(data[pos:pos + hdr.frame_bytes])
        if pcm is not None:
            chunks.append(pcm)
            rate = hdr.sample_rate
            nch = pcm.shape[1]
        pos += hdr.frame_bytes
    if not chunks:
        raise ValueError("mp2dec: no decodable Layer I/II frames")
    return np.concatenate(chunks), rate, nch


class StreamDecoder:
    """AvAudioDecoder-shaped streaming wrapper (feed/flush/read/rate/
    channels/close) so importers can fall back to the native MPEG
    audio decoders when the FFmpeg bridge is absent.  Layer I/II
    frames decode here; Layer III frames route to io/mp3dec.py."""

    def __init__(self):
        self._dec = Mp2Decoder()
        self._dec3 = None                  # lazy Mp3Decoder
        self._buf = b""
        self._out: List[np.ndarray] = []
        self.rate = 0
        self.channels = 0

    def feed(self, data: bytes) -> None:
        self._buf += data
        self._drain(final=False)

    def flush(self) -> None:
        self._drain(final=True)

    def _drain(self, final: bool) -> None:
        buf = self._buf
        pos = 0
        n = len(buf)
        while pos + 4 <= n:
            hdr = parse_mpa_header(buf[pos:pos + 4])
            if hdr is None or hdr.frame_bytes <= 4 \
                    or (hdr.version not in (1, 2)
                        and hdr.layer != 3):
                pos += 1
                continue
            if pos + hdr.frame_bytes > n:
                if not final:
                    break              # wait for the rest
                pos = n
                break
            if hdr.layer == 3:
                if self._dec3 is None:
                    from .mp3dec import Mp3Decoder
                    self._dec3 = Mp3Decoder()
                pcm = self._dec3.decode_frame(
                    buf[pos:pos + hdr.frame_bytes])
            else:
                pcm = self._dec.decode_frame(
                    buf[pos:pos + hdr.frame_bytes])
            if pcm is not None:
                self._out.append(pcm)
                self.rate = hdr.sample_rate
                self.channels = pcm.shape[1]
            pos += hdr.frame_bytes
        self._buf = buf[pos:]

    def read(self, max_samples: int = 1 << 18) -> Optional[np.ndarray]:
        if not self._out:
            return None
        out = np.concatenate(self._out)
        self._out = []
        return out

    def close(self) -> None:
        self._buf = b""
        self._out = []
