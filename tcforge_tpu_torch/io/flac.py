# Copied from tcforge_tpu/io/flac.py; its BitWriter comes from io/mpeg2host.py (the jax-free copy of io/mpeg2codec.py's head), and only the package name in its imports differs.
"""Native FLAC codec (decoder + encoder).

The reference has no FLAC support at all (this framework added the
'flac' encoder module and .flac sessions beyond the reference set via
the FFmpeg bridge); this module removes the bridge dependency with a
from-scratch spec implementation:

- decoder: STREAMINFO + frame parse (all block-size/rate/size codes,
  UTF-8 coded numbers, CRC-8 header + CRC-16 frame verification),
  subframes CONSTANT/VERBATIM/FIXED(0-4)/LPC(1-32) with wasted bits,
  4- and 5-bit rice partitions with raw escapes, and all four stereo
  decorrelation modes (independent, left/side, right/side, mid/side);
- encoder: fixed blocking, per-subframe best-of fixed predictors
  0-4 + CONSTANT collapse, single rice partition with exact-cost
  parameter search, independent channels.

FLAC is lossless, so unlike the MPEG-audio/AC-3 codecs in this tree
every oracle test is BIT-EXACT: native encode -> libavcodec decode,
libavcodec encode -> native decode, and the pure round trip
(tests/test_flac.py)."""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from .mpeg2host import BitWriter

__all__ = ["FlacDecoder", "FlacEncoder", "NativeFlacEncoder",
           "decode_stream", "parse_streaminfo"]


# ------------------------------------------------------------------ #
# CRCs: CRC-8 poly 0x07 (frame header), CRC-16 poly 0x8005 (frame)
# ------------------------------------------------------------------ #

_CRC8 = []
for _b in range(256):
    _c = _b
    for _ in range(8):
        _c = ((_c << 1) ^ 0x07) & 0xFF if _c & 0x80 else (_c << 1) & 0xFF
    _CRC8.append(_c)

_CRC16 = []
for _b in range(256):
    _c = _b << 8
    for _ in range(8):
        _c = ((_c << 1) ^ 0x8005) & 0xFFFF if _c & 0x8000 \
            else (_c << 1) & 0xFFFF
    _CRC16.append(_c)


def _crc8(data: bytes) -> int:
    c = 0
    for byt in data:
        c = _CRC8[c ^ byt]
    return c


def _crc16(data: bytes) -> int:
    c = 0
    for byt in data:
        c = ((c << 8) & 0xFFFF) ^ _CRC16[((c >> 8) ^ byt) & 0xFF]
    return c


_BLOCKSIZES = {1: 192, 2: 576, 3: 1152, 4: 2304, 5: 4608, 8: 256,
               9: 512, 10: 1024, 11: 2048, 12: 4096, 13: 8192,
               14: 16384, 15: 32768}
_RATES = {1: 88200, 2: 176400, 3: 192000, 4: 8000, 5: 16000,
          6: 22050, 7: 24000, 8: 32000, 9: 44100, 10: 48000,
          11: 96000}
_SIZES = {1: 8, 2: 12, 4: 16, 5: 20, 6: 24, 7: 32}

_FIXED_COEFS = ((), (1,), (2, -1), (3, -3, 1), (4, -6, 4, -1))


class _Bits:
    """MSB-first reader over 32-bit words with unary support."""

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
            raise EOFError("flac: truncated stream")
        self.pos = p + n
        i = p >> 5
        w = (self.words[i] << 32) | self.words[i + 1]
        return (w >> (64 - (p & 31) - n)) & ((1 << n) - 1)

    def sread(self, n: int) -> int:
        v = self.read(n)
        return v - (1 << n) if v & (1 << (n - 1)) else v

    def read_unary(self) -> int:
        q = 0
        while True:
            p = self.pos
            if p >= self.nbits:
                raise EOFError("flac: truncated unary")
            i = p >> 5
            w = ((self.words[i] << 32) | self.words[i + 1])
            avail = min(64 - (p & 31), self.nbits - p)
            chunk = (w >> (64 - (p & 31) - avail)) & ((1 << avail) - 1)
            if chunk == 0:
                q += avail
                self.pos = p + avail
                continue
            lead = avail - chunk.bit_length()
            self.pos = p + lead + 1
            return q + lead


def parse_streaminfo(block: bytes) -> dict:
    b = _Bits(block)
    return {"min_block": b.read(16), "max_block": b.read(16),
            "min_frame": b.read(24), "max_frame": b.read(24),
            "rate": b.read(20), "channels": b.read(3) + 1,
            "bps": b.read(5) + 1,
            "total": (b.read(18) << 18) | b.read(18),
            "md5": block[18:34]}


def _read_utf8(b: _Bits) -> int:
    v = b.read(8)
    if v < 0x80:
        return v
    nbytes = 0
    mask = 0x40
    while v & mask:
        nbytes += 1
        mask >>= 1
    out = v & (mask - 1)
    for _ in range(nbytes):
        c = b.read(8)
        if c & 0xC0 != 0x80:
            raise ValueError("flac: bad UTF-8 coded number")
        out = (out << 6) | (c & 0x3F)
    return out


def _write_utf8(w: BitWriter, v: int) -> None:
    if v < 0x80:
        w.put(v, 8)
        return
    for nbytes in range(1, 7):             # continuation byte count
        if v < (1 << (5 * nbytes + (6 - nbytes))):
            break
    tail = []
    for _ in range(nbytes):
        tail.append(0x80 | (v & 0x3F))
        v >>= 6
    lead = ((0xFF << (7 - nbytes)) & 0xFF) | v
    w.put(lead, 8)
    for c in reversed(tail):
        w.put(c, 8)


def _read_residual(b: _Bits, blocksize: int, order: int
                   ) -> np.ndarray:
    method = b.read(2)
    if method > 1:
        raise ValueError("flac: reserved residual method")
    pbits = 4 if method == 0 else 5
    escape = (1 << pbits) - 1
    porder = b.read(4)
    nparts = 1 << porder
    if blocksize % nparts or (blocksize >> porder) <= order:
        raise ValueError("flac: bad partition order")
    out = np.empty(blocksize - order, np.int64)
    idx = 0
    for part in range(nparts):
        n = (blocksize >> porder) - (order if part == 0 else 0)
        param = b.read(pbits)
        if param == escape:
            raw = b.read(5)
            for i in range(n):
                out[idx] = b.sread(raw) if raw else 0
                idx += 1
        else:
            for i in range(n):
                q = b.read_unary()
                u = (q << param) | (b.read(param) if param else 0)
                out[idx] = (u >> 1) ^ -(u & 1)
                idx += 1
    return out


def _read_subframe(b: _Bits, blocksize: int, bps: int) -> np.ndarray:
    if b.read(1):
        raise ValueError("flac: subframe padding bit set")
    stype = b.read(6)
    wasted = 0
    if b.read(1):
        wasted = 1 + b.read_unary()
        bps -= wasted
    if stype == 0:                         # CONSTANT
        v = b.sread(bps)
        out = np.full(blocksize, v, np.int64)
    elif stype == 1:                       # VERBATIM
        out = np.array([b.sread(bps) for _ in range(blocksize)],
                       np.int64)
    elif 8 <= stype <= 12:                 # FIXED
        order = stype - 8
        warm = [b.sread(bps) for _ in range(order)]
        res = _read_residual(b, blocksize, order)
        out = np.empty(blocksize, np.int64)
        out[:order] = warm
        coefs = _FIXED_COEFS[order]
        for i in range(order, blocksize):
            acc = res[i - order]
            for j, c in enumerate(coefs):
                acc += c * out[i - 1 - j]
            out[i] = acc
    elif stype >= 32:                      # LPC
        order = (stype & 31) + 1
        warm = [b.sread(bps) for _ in range(order)]
        prec = b.read(4) + 1
        if prec == 16:
            raise ValueError("flac: invalid qlp precision")
        shift = b.sread(5)
        coefs = [b.sread(prec) for _ in range(order)]
        res = _read_residual(b, blocksize, order)
        out = np.empty(blocksize, np.int64)
        out[:order] = warm
        for i in range(order, blocksize):
            acc = 0
            for j in range(order):
                acc += coefs[j] * out[i - 1 - j]
            out[i] = res[i - order] + (acc >> shift)
    else:
        raise ValueError(f"flac: reserved subframe type {stype}")
    if wasted:
        out <<= wasted
    return out


class FlacDecoder:
    """Whole-stream FLAC decoder.  decode() -> (samples (S, C) int32
    at the stream's bps, rate, channels, bps)."""

    def __init__(self, data: bytes):
        if data[:4] != b"fLaC":
            raise ValueError("flac: no fLaC marker")
        pos = 4
        self.info = None
        while pos < len(data):
            hdr = data[pos]
            last, btype = hdr >> 7, hdr & 0x7F
            ln = int.from_bytes(data[pos + 1:pos + 4], "big")
            if btype == 0:
                self.info = parse_streaminfo(data[pos + 4:pos + 4 + ln])
            pos += 4 + ln
            if last:
                break
        if self.info is None:
            raise ValueError("flac: missing STREAMINFO")
        self._data = data
        self._frames_at = pos

    def decode(self) -> Tuple[np.ndarray, int, int, int]:
        info = self.info
        data = self._data
        pos = self._frames_at
        chunks: List[np.ndarray] = []
        n = len(data)
        while pos + 5 < n:
            if not (data[pos] == 0xFF and (data[pos + 1] & 0xFC)
                    == 0xF8):
                pos += 1
                continue
            frame, nbytes = self._frame(data, pos)
            if frame is None:
                pos += 1
                continue
            chunks.append(frame)
            pos += nbytes
        if not chunks:
            raise ValueError("flac: no decodable frames")
        pcm = np.concatenate(chunks)
        if info["total"]:
            pcm = pcm[:info["total"]]
        return pcm, info["rate"], info["channels"], info["bps"]

    def _frame(self, data: bytes, pos: int
               ) -> Tuple[Optional[np.ndarray], int]:
        info = self.info
        b = _Bits(data[pos:])
        try:
            sync = b.read(14)
            if sync != 0x3FFE or b.read(1):
                return None, 0
            b.read(1)                      # blocking strategy
            bscode = b.read(4)
            ratecode = b.read(4)
            chmode = b.read(4)
            sizecode = b.read(3)
            if b.read(1):
                return None, 0
            _read_utf8(b)                  # frame/sample number
            if bscode == 0:
                return None, 0
            if bscode == 6:
                blocksize = b.read(8) + 1
            elif bscode == 7:
                blocksize = b.read(16) + 1
            else:
                blocksize = _BLOCKSIZES[bscode]
            if ratecode == 12:
                b.read(8)
            elif ratecode in (13, 14):
                b.read(16)
            elif ratecode == 15:
                return None, 0
            hbytes = (b.pos + 7) // 8
            stored = b.read(8)             # header CRC-8
            if _crc8(data[pos:pos + hbytes]) != stored:
                return None, 0
            bps = info["bps"] if sizecode == 0 else _SIZES[sizecode]
            if chmode <= 7:
                nch = chmode + 1
                subs = [_read_subframe(b, blocksize, bps)
                        for _ in range(nch)]
                out = np.stack(subs, axis=1)
            elif chmode in (8, 9, 10):
                nch = 2
                if chmode == 8:            # left/side
                    left = _read_subframe(b, blocksize, bps)
                    side = _read_subframe(b, blocksize, bps + 1)
                    out = np.stack((left, left - side), axis=1)
                elif chmode == 9:          # right/side
                    side = _read_subframe(b, blocksize, bps + 1)
                    right = _read_subframe(b, blocksize, bps)
                    out = np.stack((right + side, right), axis=1)
                else:                      # mid/side
                    mid = _read_subframe(b, blocksize, bps)
                    side = _read_subframe(b, blocksize, bps + 1)
                    m2 = (mid.astype(np.int64) << 1) | (side & 1)
                    out = np.stack(((m2 + side) >> 1, (m2 - side) >> 1),
                                   axis=1)
            else:
                return None, 0
            if nch != info["channels"]:
                return None, 0
            b.pos = (b.pos + 7) // 8 * 8   # align
            fbytes = b.pos // 8 + 2
            if _crc16(data[pos:pos + fbytes]) != 0:
                return None, 0
            return out, fbytes
        except (EOFError, ValueError, KeyError):
            return None, 0


def decode_stream(data: bytes) -> Tuple[np.ndarray, int, int, int]:
    return FlacDecoder(data).decode()


# ------------------------------------------------------------------ #
# Encoder
# ------------------------------------------------------------------ #

def _zigzag(r: np.ndarray) -> np.ndarray:
    return np.where(r >= 0, r << 1, (-r << 1) - 1).astype(np.uint64)


def _rice_cost(u: np.ndarray, k: int) -> int:
    return int((u >> np.uint64(k)).sum()) + len(u) * (k + 1)


def _best_rice(u: np.ndarray) -> Tuple[int, int]:
    """(param, bits) exact-cost search over k=0..14."""
    best_k, best_c = 0, _rice_cost(u, 0)
    for k in range(1, 15):
        c = _rice_cost(u, k)
        if c < best_c:
            best_k, best_c = k, c
    return best_k, best_c


class FlacEncoder:
    """Fixed-blocking FLAC encoder: best-of fixed predictors with a
    single exact-cost rice partition per subframe."""

    def __init__(self, rate: int, channels: int, bps: int = 16,
                 block: int = 4096):
        self.rate = rate
        self.channels = channels
        self.bps = bps
        self.block = block
        self.frame_no = 0

    def streaminfo(self) -> bytes:
        w = BitWriter()
        w.put(self.block, 16)
        w.put(self.block, 16)
        w.put(0, 24)
        w.put(0, 24)
        w.put(self.rate, 20)
        w.put(self.channels - 1, 3)
        w.put(self.bps - 1, 5)
        w.put(0, 36)                       # total samples: unknown
        return w.bytes() + b"\x00" * 16    # md5: unknown

    def header(self) -> bytes:
        """fLaC marker + last-metadata STREAMINFO block."""
        si = self.streaminfo()
        return b"fLaC" + bytes([0x80]) + len(si).to_bytes(3, "big") + si

    def _subframe(self, w: BitWriter, x: np.ndarray) -> None:
        bps, n = self.bps, len(x)
        if np.all(x == x[0]):              # CONSTANT
            w.put(0, 1)
            w.put(0, 6)
            w.put(0, 1)
            w.put(int(x[0]) & ((1 << bps) - 1), bps)
            return
        # fixed predictor search (orders 0..4)
        best_o, best_res, best_cost = 0, x.astype(np.int64), None
        res = x.astype(np.int64)
        for order in range(5):
            if order:
                res = np.diff(res)
            if order > n - 1:
                break
            u = _zigzag(res)
            k, c = _best_rice(u)
            cost = c + order * bps
            if best_cost is None or cost < best_cost:
                best_o, best_cost = order, cost
                best_res, best_k = res.copy(), k
        w.put(0, 1)
        w.put(8 + best_o, 6)               # FIXED order
        w.put(0, 1)                        # no wasted bits
        mask = (1 << bps) - 1
        for i in range(best_o):
            w.put(int(x[i]) & mask, bps)
        # residual: method 0 (4-bit rice), partition order 0
        w.put(0, 2)
        w.put(0, 4)
        u = _zigzag(best_res)
        k = best_k
        w.put(k, 4)
        kmask = (1 << k) - 1
        for v in u.tolist():
            q = v >> k
            while q >= 32:
                w.put(0, 32)
                q -= 32
            w.put(1, q + 1)
            if k:
                w.put(v & kmask, k)

    def encode_frame(self, pcm: np.ndarray) -> bytes:
        """pcm: (n <= block, channels) int; one FLAC frame out."""
        n, nch = pcm.shape
        assert nch == self.channels and 0 < n <= self.block
        w = BitWriter()
        w.put(0x3FFE, 14)
        w.put(0, 1)
        w.put(0, 1)                        # fixed blocking
        if n == self.block and self.block in (
                192, 576, 1152, 2304, 4608, 256, 512, 1024, 2048,
                4096, 8192, 16384, 32768):
            inv = {v: k for k, v in _BLOCKSIZES.items()}
            bscode, bstail = inv[n], None
        else:
            bscode, bstail = 7, n - 1
        w.put(bscode, 4)
        inv_r = {v: k for k, v in _RATES.items()}
        rcode = inv_r.get(self.rate, 0)
        w.put(rcode, 4)
        w.put(nch - 1, 4)                  # independent channels
        inv_s = {v: k for k, v in _SIZES.items()}
        w.put(inv_s.get(self.bps, 0), 3)
        w.put(0, 1)
        _write_utf8(w, self.frame_no)
        self.frame_no += 1
        if bstail is not None:
            w.put(bstail, 16)
        hdr = w.bytes()
        w2 = BitWriter()
        for byt in hdr:
            w2.put(byt, 8)
        w2.put(_crc8(hdr), 8)
        x = pcm.astype(np.int64)
        for ch in range(nch):
            self._subframe(w2, x[:, ch])
        body = w2.bytes()                  # align() pads with zeros
        return body + _crc16(body).to_bytes(2, "big")


class NativeFlacEncoder:
    """AvAudioEncoder-shaped wrapper: the first read_packets() output
    is preceded by nothing — the fLaC header travels via .extradata
    exactly like the bridge encoder (STREAMINFO payload)."""

    def __init__(self, rate: int, channels: int, _bps_ignored: int = 0):
        self._enc = FlacEncoder(rate, channels)
        self._pend = np.zeros((0, channels), np.int16)
        self._out: List[bytes] = []
        self.frame_size = self._enc.block
        self.extradata = self._enc.streaminfo()

    def set_framed(self, framed: bool = True) -> None:
        pass

    def feed(self, pcm: np.ndarray) -> None:
        pcm = np.asarray(pcm, np.int16).reshape(-1,
                                                self._enc.channels)
        self._pend = np.concatenate((self._pend, pcm))
        blk = self._enc.block
        while self._pend.shape[0] >= blk:
            self._out.append(self._enc.encode_frame(self._pend[:blk]))
            self._pend = self._pend[blk:]

    def flush(self) -> None:
        if self._pend.shape[0]:
            self._out.append(self._enc.encode_frame(self._pend))
            self._pend = self._pend[:0]

    def read_packets(self) -> List[bytes]:
        out = self._out
        self._out = []
        return out

    def close(self) -> None:
        self._out = []
