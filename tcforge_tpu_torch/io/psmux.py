# Copied from tcforge_tpu/io/psmux.py; only the package name in its imports differs.
"""MPEG-2 program stream WRITER (the missing native 'mplex' role).

The reference reached .mpg/.vob output through libavformat
(multiplex/multiplex_lavf.c); this is the in-tree equivalent for the
streams this framework encodes natively: one MPEG video elementary
stream (0xE0) plus optional DVD-style LPCM audio (private stream 1,
sub-stream 0xA0) — the exact layout tcforge_tpu's own importer,
tcprobe, and tcdemux read back (io/mpeg.py), and the LPCM form real
DVD players use.

Layout per ISO 13818-1: pack header (SCR in 27 MHz, program mux
rate), one system header at the start, then PES packets.  Video PES
carry PTS when the payload starts an access unit (picture start code
at offset 0); LPCM packets carry the 7-byte private header
(sub_stream_id, frame count, first access unit pointer, flags,
dynamic range) ahead of big-endian samples.
"""

from __future__ import annotations

import struct
from typing import Optional

import numpy as np

PACK_RATE = 10080          # program_mux_rate in 50 B/s units (DVD-ish)
PES_CHUNK = 2018           # payload bytes per video PES packet
LPCM_SAMPLES = 480         # samples per LPCM packet (DVD: 1/100 s)

_LPCM_RATE_CODE = {48000: 0, 96000: 1, 44100: 2, 32000: 3}


def _pts_bits(pts: int, prefix: int) -> bytes:
    """5-byte PTS/DTS field ('0010'/'0011' prefix form)."""
    return bytes([
        (prefix << 4) | (((pts >> 30) & 7) << 1) | 1,
        (pts >> 22) & 0xFF,
        (((pts >> 15) & 0x7F) << 1) | 1,
        (pts >> 7) & 0xFF,
        ((pts & 0x7F) << 1) | 1,
    ])


def pack_header(scr: int) -> bytes:
    """MPEG-2 pack header: SCR base (90 kHz) with ext 0."""
    base = scr & ((1 << 33) - 1)
    b = bytearray(b"\x00\x00\x01\xba")
    v = (0b01 << 46) | (((base >> 30) & 7) << 43) | (1 << 42) \
        | (((base >> 15) & 0x7FFF) << 27) | (1 << 26) \
        | ((base & 0x7FFF) << 11) | (1 << 10) | (0 << 1) | 1
    b += v.to_bytes(6, "big")
    b += (((PACK_RATE << 2) | 0b11)).to_bytes(3, "big")  # rate+markers
    b += bytes([0xF8])                     # reserved + stuffing len 0
    return bytes(b)


def system_header(have_audio: bool) -> bytes:
    streams = bytearray()
    streams += bytes([0xE0, 0xC0 | 0x20, 0x2E])   # video: 46 KB bound
    if have_audio:
        streams += bytes([0xBD, 0xC0, 0x3A])      # private 1: 58 B
    body = bytes([0x80 | (PACK_RATE >> 15), (PACK_RATE >> 7) & 0xFF,
                  ((PACK_RATE & 0x7F) << 1) | 1,
                  (1 << 2) | (0 << 1) | 1,        # audio bound 1, CSPS
                  0x20 | 1,                       # video bound 1
                  0xFF]) + bytes(streams)
    return b"\x00\x00\x01\xbb" + struct.pack(">H", len(body)) + body


def pes_packet(sid: int, payload: bytes,
               pts: Optional[int] = None) -> bytes:
    """MPEG-2 PES packet ('10' flags form)."""
    if pts is not None:
        hdr = bytes([0x80, 0x80, 5]) + _pts_bits(pts, 0b0010)
    else:
        hdr = bytes([0x80, 0x00, 0])
    body = hdr + payload
    return (b"\x00\x00\x01" + bytes([sid])
            + struct.pack(">H", len(body)) + body)


def lpcm_packet(samples: np.ndarray, rate: int, frame_no: int,
                pts: Optional[int] = None) -> bytes:
    """Private-stream-1 LPCM packet: 16-bit big-endian samples."""
    channels = samples.shape[1]
    info = (0 << 6) | (_LPCM_RATE_CODE.get(rate, 0) << 4) \
        | ((channels - 1) & 7)
    priv = bytes([0xA0, 1, 0, 7, frame_no & 0x1F, info, 0x80]) \
        + samples.astype(">i2").tobytes()
    return pes_packet(0xBD, priv, pts)


class PsWriter:
    """Interleaved program-stream writer.

    write_video(payload) takes encoder output — any number of coded
    pictures plus sequence/GOP headers; each picture start inside the
    payload gets its own PES with a display-timeline PTS derived from
    the coded temporal_reference (GOP headers reset the base like the
    encoder emits them).  write_audio_pcm takes int16 (S, C) samples.
    Packets are interleaved in arrival order; DELAY keeps every PTS
    comfortably ahead of the SCR even though the engine writes whole
    video batches before their audio."""

    DELAY = 90000                         # 1 s decode/interleave lead

    def __init__(self, f, fps: float = 25.0, audio_rate: int = 0,
                 chunk: int = PES_CHUNK):
        self._f = f
        self.fps = fps or 25.0
        self.audio_rate = audio_rate
        self.chunk = chunk
        self._video_pictures = 0          # coded pictures (SCR clock)
        self._max_disp = -1               # highest display index seen
        self._tref_base = 0               # display index of tref 0
        self._audio_samples = 0
        self._audio_frame_no = 0
        self._packs = 0
        self._wrote_sys = False
        self._abuf: Optional[np.ndarray] = None

    def _scr(self) -> int:
        # SCR tracks coded-picture arrival time
        return max(0, int(self._video_pictures * 90000 / self.fps))

    def _emit_pack(self, pes: bytes) -> int:
        out = pack_header(self._scr())
        if not self._wrote_sys:
            out += system_header(bool(self.audio_rate))
            self._wrote_sys = True
        out += pes
        self._f.write(out)
        self._packs += 1
        return len(out)

    def _picture_pts(self, payload: bytes, off: int) -> int:
        """Display PTS from the temporal_reference at a picture start
        (10 bits after the start code)."""
        if off + 6 <= len(payload):
            tref = (payload[off + 4] << 2) | (payload[off + 5] >> 6)
        else:
            tref = 0
        disp = self._tref_base + tref
        if disp > self._max_disp:
            self._max_disp = disp
        return int((disp + 1) * 90000 / self.fps) + self.DELAY

    def write_video(self, payload: bytes) -> int:
        total = 0
        # split at picture starts so each access unit begins a PES
        # with its own PTS; GOP headers reset the tref base to the
        # next display index (open-GOP rule: trailing Bs of the
        # previous GOP transmit inside the new one)
        cuts = [0]
        i = 0
        while True:
            i = payload.find(b"\x00\x00\x01", i)
            if i < 0:
                break
            code = payload[i + 3] if i + 3 < len(payload) else -1
            if code == 0x00 and i > 0:
                cuts.append(i)
            i += 3
        cuts.append(len(payload))
        for k in range(len(cuts) - 1):
            seg = payload[cuts[k]:cuts[k + 1]]
            if not seg:
                continue
            g = seg.find(b"\x00\x00\x01\xb8")
            p = seg.find(b"\x00\x00\x01\x00")
            # segments are cut at picture starts, so a GOP header at
            # the TAIL of this segment opens the NEXT picture's GOP —
            # reset the tref base after this picture's PTS, not before
            if g >= 0 and (p < 0 or g < p):
                self._tref_base = self._max_disp + 1
            pts = self._picture_pts(seg, p) if p >= 0 else None
            if p >= 0:
                self._video_pictures += 1
            if g >= 0 and p >= 0 and g > p:
                self._tref_base = self._max_disp + 1
            first = True
            for off in range(0, len(seg), self.chunk):
                chunk = seg[off:off + self.chunk]
                total += self._emit_pack(
                    pes_packet(0xE0, chunk, pts if first else None))
                first = False
        return total

    def write_audio_es(self, payload: bytes, sid: int = 0xC0,
                       sub: Optional[int] = None) -> int:
        """Compressed audio byte stream (MP2 -> PES 0xC0+n; AC-3 ->
        private stream 1 sub 0x80+n with the 3-byte private header).
        PTS estimated from the byte position is omitted (players use
        the self-framing stream); SCR interleaving applies."""
        if not payload:
            return 0
        total = 0
        for off in range(0, len(payload), self.chunk):
            part = payload[off:off + self.chunk]
            if sub is not None:
                part = bytes([sub, 1, 0, 0]) + part
                total += self._emit_pack(pes_packet(0xBD, part))
            else:
                total += self._emit_pack(pes_packet(sid, part))
        return total

    def write_audio_pcm(self, samples: np.ndarray) -> int:
        if self._abuf is not None:
            samples = np.concatenate([self._abuf, samples])
            self._abuf = None
        total = 0
        pos = 0
        while samples.shape[0] - pos >= LPCM_SAMPLES:
            chunk = samples[pos:pos + LPCM_SAMPLES]
            pos += LPCM_SAMPLES
            pts = int(self._audio_samples * 90000
                      / max(1, self.audio_rate)) + self.DELAY
            self._audio_samples += chunk.shape[0]
            self._audio_frame_no += 1
            total += self._emit_pack(
                lpcm_packet(chunk, self.audio_rate,
                            self._audio_frame_no, pts))
        if pos < samples.shape[0]:
            self._abuf = samples[pos:].copy()
        return total

    def close(self) -> None:
        if self._abuf is not None and len(self._abuf):
            self._emit_pack(lpcm_packet(
                self._abuf, self.audio_rate, self._audio_frame_no + 1))
            self._abuf = None
        self._f.write(b"\x00\x00\x01\xb9")
