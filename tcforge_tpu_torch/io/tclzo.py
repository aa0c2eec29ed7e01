# Copied from tcforge_tpu/io/tclzo.py; only the package name in its imports differs.
"""transcode LZO2 frame codec (libtcext/tc_lzo.h + import_lzo.c /
encode_lzo.c roles).

Frame layout (tc_lzo_header_t, 16 bytes little-endian on disk):
magic (TC_CODEC_LZO2), size, flags, method, level, pad — then LZO1X
data, or raw bytes when TC_LZO_NOT_COMPRESSIBLE is set.
Decompression runs through libavutil's av_lzo1x_decode (the FFmpeg
bridge).  Compression is an in-tree greedy LZO1X encoder emitting the
empirically-verified op subset (first/extended literal runs, M3
matches with 16-bit distances and extended lengths, state-folded
trailing literals) — every op sequence used here is round-trip
validated against av_lzo1x_decode in tests/test_lzo.py; frames that
do not shrink fall back to the spec's NOT_COMPRESSIBLE store mode
exactly like encode_lzo.c.
"""

from __future__ import annotations

import struct
from typing import Tuple

TC_CODEC_LZO2 = 0xFFFE0013
TC_LZO_NOT_COMPRESSIBLE = 8
HDR_SIZE = 16


def pack_frame(payload: bytes, flags: int = TC_LZO_NOT_COMPRESSIBLE,
               fmt_flag: int = 16) -> bytes:
    """LZO2 frame from raw plane bytes (store mode)."""
    hdr = struct.pack("<IIIBBH", TC_CODEC_LZO2, len(payload),
                      flags | fmt_flag, 1, 1, 0)
    return hdr + payload


def unpack_frame(frame: bytes, max_out: int) -> Tuple[bytes, int]:
    """-> (raw bytes, flags).  Decompresses via the FFmpeg bridge
    when the frame is LZO1X-compressed."""
    if len(frame) < HDR_SIZE:
        raise ValueError("lzo: short frame")
    magic, size, flags, _m, _l, _p = struct.unpack("<IIIBBH",
                                                   frame[:HDR_SIZE])
    if magic != TC_CODEC_LZO2:
        raise ValueError(f"lzo: bad frame magic 0x{magic:08x}")
    body = frame[HDR_SIZE:]
    if flags & TC_LZO_NOT_COMPRESSIBLE:
        return body, flags
    from tcforge_tpu_torch.native import av
    return av.lzo1x_decode(body, max_out), flags


# ------------------------------------------------------------------ #
# greedy LZO1X compressor (M3-op subset)

_M3_MAX_DIST = 16384
_MATCH_CAP = 33 + 255          # single-M3 maximum length


def _emit_first_literals(out: bytearray, lits: memoryview) -> None:
    n = len(lits)
    if n == 0:
        return
    if n <= 238:
        out.append(17 + n)
    else:
        k = n - 18
        out.append(0)
        while k > 255:
            out.append(0)
            k -= 255
        out.append(k)
    out += lits


def _emit_mid_literals(out: bytearray, lits: memoryview) -> int:
    """Literals between matches; returns the 0-3 count folded into
    the PREVIOUS match's state bits (caller patches them)."""
    n = len(lits)
    if n <= 3:
        out += lits
        return n
    if n <= 18:
        out.append(n - 3)
    else:
        k = n - 18
        out.append(0)
        while k > 255:
            out.append(0)
            k -= 255
        out.append(k)
    out += lits
    return 0


def _emit_m3(out: bytearray, length: int, dist: int,
             state: int) -> int:
    """M3 match; returns index of the v-LE16 for state patching."""
    if length <= 33:
        out.append(0x20 | (length - 2))
    else:
        out.append(0x20)
        k = length - 33
        while k > 255:
            out.append(0)
            k -= 255
        out.append(k)
    v = ((dist - 1) << 2) | state
    pos = len(out)
    out.append(v & 0xFF)
    out.append(v >> 8)
    return pos


def lzo1x_compress(data: bytes) -> bytes:
    """Greedy LZO1X-compatible stream (M3 matches only)."""
    out = bytearray()
    n = len(data)
    table: dict = {}
    i = 0
    lit_start = 0
    first = True
    pending_v = -1                 # position of last match's v bytes
    while i + 3 <= n:
        key = data[i:i + 3]
        cand = table.get(key, -1)
        table[key] = i
        dist = i - cand
        if cand >= 0 and 0 < dist <= _M3_MAX_DIST:
            length = 3
            cap = min(n - i, _MATCH_CAP)
            while length < cap and                     data[cand + length] == data[i + length]:
                length += 1
            lits = memoryview(data)[lit_start:i]
            if first:
                _emit_first_literals(out, lits)
                first = False
                state = 0
            else:
                state = _emit_mid_literals(out, lits)
                if state and pending_v >= 0:
                    v = out[pending_v] | (out[pending_v + 1] << 8)
                    # state literals live AFTER the match bytes;
                    # move them: they were appended by
                    # _emit_mid_literals already in place — patch v
                    v |= state
                    out[pending_v] = v & 0xFF
                    out[pending_v + 1] = v >> 8
            pending_v = _emit_m3(out, length, dist, 0)
            # seed the hash sparsely inside the match
            for j in range(i + 1, min(i + length, n - 3), 7):
                table[data[j:j + 3]] = j
            i += length
            lit_start = i
        else:
            i += 1
    tail = memoryview(data)[lit_start:n]
    if first:
        _emit_first_literals(out, tail)
    else:
        state = _emit_mid_literals(out, tail)
        if state and pending_v >= 0:
            v = out[pending_v] | (out[pending_v + 1] << 8)
            v |= state
            out[pending_v] = v & 0xFF
            out[pending_v + 1] = v >> 8
    out += bytes([0x11, 0, 0])     # end marker
    return bytes(out)


def compress_frame(payload: bytes, fmt_flag: int = 16) -> bytes:
    """LZO2 frame: compress, store-mode fallback when not smaller."""
    comp = lzo1x_compress(payload)
    if len(comp) < len(payload):
        hdr = struct.pack("<IIIBBH", TC_CODEC_LZO2, len(comp),
                          fmt_flag, 1, 1, 0)
        return hdr + comp
    return pack_frame(payload, fmt_flag=fmt_flag)
