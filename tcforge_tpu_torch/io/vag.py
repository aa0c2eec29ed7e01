# Copied from tcforge_tpu/io/vag.py; only the package name in its imports differs.
"""PlayStation VAG ADPCM audio (import_vag.c analogue).

The format: 16-byte blocks, each carrying a predictor/shift byte, a
flags byte, and 28 4-bit nibbles.  Reconstruction is a 2-tap IIR over
the decoded samples with one of five fixed predictor coefficient
pairs (the SPU ADPCM filter table, import_vag.c:325-331):

    s[n] = clamp( (p0*s[n-1] - p1*s[n-2] + (nib << shift << 2)) >> 6 )

Two container flavors (reference semantics, import_vag.c:400-520):

* ``VAGp`` — 48-byte big-endian header (sample rate at offset 0x10),
  mono, data from offset 0x30.
* ``SShd``/``SSbd`` — little-endian header chunk: bits (1 = raw PCM16
  payload, otherwise VAG), rate, channels, stereo interleave block
  size; payload follows the ``SSbd`` chunk header, channel-interleaved
  in ``block``-sized chunks.

Decode state (the two previous samples per channel) persists across
blocks, so the decoder below is an explicit little state machine; the
per-block nibble unpack is vectorized and only the 2-tap recurrence
runs sample-serial.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np

# SPU ADPCM predictor pairs (values are *64ths*).  The reference
# declares predict[16][2] with 7 initialized rows (import_vag.c:325:
# rows 5/6 are {0,0} and {0,60}); uninitialized rows read as zeros in
# C, so indices 7-15 decode with {0,0} — reproduced exactly here.
PREDICT = np.zeros((16, 2), np.int64)
PREDICT[:7] = [[0, 0], [60, 0], [115, 52], [98, 55], [122, 60],
               [0, 0], [0, 60]]

BLOCK = 16                 # bytes per ADPCM block
SAMPLES_PER_BLOCK = 28

# block flag values (second byte)
FLAG_END = 7               # end-of-stream marker block


@dataclass
class VagState:
    prev: np.ndarray = field(
        default_factory=lambda: np.zeros(2, np.int64))  # s[n-1], s[n-2]
    nclip: int = 0


def decode_blocks(data: bytes, state: VagState) -> np.ndarray:
    """Decode a run of complete 16-byte VAG blocks for ONE channel.

    Returns int16 samples; carries predictor state in ``state``."""
    nblk = len(data) // BLOCK
    if nblk == 0:
        return np.zeros(0, np.int16)
    raw = np.frombuffer(data[:nblk * BLOCK], np.uint8).reshape(nblk,
                                                              BLOCK)
    # header byte: predictor index high nibble, shift low nibble
    pred = (raw[:, 0] >> 4).astype(np.int64)
    scale = 16 - (raw[:, 0] & 0x0F).astype(np.int64)
    # end-marker blocks decode as silence contribution but terminate
    # the stream at the container layer; nibbles low-first per byte
    nib = np.empty((nblk, SAMPLES_PER_BLOCK), np.int64)
    payload = raw[:, 2:16].astype(np.int64)
    nib[:, 0::2] = payload & 0x0F
    nib[:, 1::2] = payload >> 4
    nib = np.where(nib >= 8, nib - 16, nib)
    nib = (nib << scale[:, None]) << 2

    out = np.empty(nblk * SAMPLES_PER_BLOCK, np.int16)
    p0 = int(state.prev[0])
    p1 = int(state.prev[1])
    nclip = 0
    for b in range(nblk):
        c0 = int(PREDICT[pred[b], 0])
        c1 = int(PREDICT[pred[b], 1])
        row = nib[b]
        base = b * SAMPLES_PER_BLOCK
        for i in range(SAMPLES_PER_BLOCK):
            v = (p0 * c0 - p1 * c1 + int(row[i])) >> 6
            if v > 0x7FFF:
                v = 0x7FFF
                nclip += 1
            elif v < -0x8000:
                v = -0x8000
                nclip += 1
            out[base + i] = v
            p1 = p0
            p0 = v
    state.prev[0] = p0
    state.prev[1] = p1
    state.nclip += nclip
    return out


@dataclass
class VagInfo:
    rate: int
    channels: int
    is_pcm: bool               # SShd bits==1: raw 16-bit PCM payload
    block: int                 # stereo interleave chunk (bytes)
    data_offset: int
    data_size: Optional[int]


def parse_header(head: bytes) -> Optional[VagInfo]:
    """Sniff + parse a VAGp or SShd header from the file head."""
    if head[:4] == b"VAGp" and len(head) >= 0x30:
        rate = struct.unpack(">I", head[0x10:0x14])[0]
        size = struct.unpack(">I", head[0x0C:0x10])[0] or None
        return VagInfo(rate=rate or 44100, channels=1, is_pcm=False,
                       block=BLOCK, data_offset=0x30, data_size=size)
    if head[:4] == b"SShd" and len(head) >= 40:
        (bits, rate, chans, block) = struct.unpack(
            "<IIII", head[8:24])
        hdr_size = struct.unpack("<I", head[4:8])[0]
        off = 8 + hdr_size
        size = None
        if head[off:off + 4] == b"SSbd":
            size = struct.unpack("<I", head[off + 4:off + 8])[0]
            off += 8
        return VagInfo(rate=rate or 44100,
                       channels=max(1, min(2, chans)),
                       is_pcm=(bits == 1),
                       block=block or 0x1000,
                       data_offset=off, data_size=size)
    return None


class VagReader:
    """File-level reader: header parse + interleave + stateful decode."""

    def __init__(self, path: str):
        with open(path, "rb") as f:
            head = f.read(64)
            info = parse_header(head)
            if info is None:
                raise ValueError(f"{path}: not a VAGp/SShd file")
            f.seek(0, 2)
            end = f.tell()
            f.seek(info.data_offset)
            avail = end - info.data_offset
            if info.data_size is not None:
                avail = min(avail, info.data_size)
            self._data = f.read(avail)
        self.info = info
        self._states = [VagState() for _ in range(info.channels)]
        self._pos = 0

    def read(self, samples: int) -> Optional[np.ndarray]:
        """Next chunk as (n, channels) int16; None at EOF."""
        info = self.info
        if self._pos >= len(self._data):
            return None
        if info.is_pcm:
            want = samples * info.channels * 2
            chunk = self._data[self._pos:self._pos + want]
            self._pos += len(chunk)
            a = np.frombuffer(chunk, "<i2")
            n = (a.shape[0] // info.channels) * info.channels
            return a[:n].reshape(-1, info.channels)
        if info.channels == 1:
            nblk = max(1, samples // SAMPLES_PER_BLOCK)
            chunk = self._data[self._pos:self._pos + nblk * BLOCK]
            usable = (len(chunk) // BLOCK) * BLOCK
            if not usable:
                self._pos = len(self._data)
                return None
            self._pos += usable
            pcm = decode_blocks(chunk[:usable], self._states[0])
            return pcm[:, None]
        # stereo: block-interleaved L/R chunks
        blk = info.block
        outs = []
        need = samples
        while need > 0 and self._pos < len(self._data):
            left = self._data[self._pos:self._pos + blk]
            right = self._data[self._pos + blk:self._pos + 2 * blk]
            self._pos += len(left) + len(right)
            ln = (len(left) // BLOCK) * BLOCK
            rn = (len(right) // BLOCK) * BLOCK
            lp = decode_blocks(left[:ln], self._states[0])
            rp = decode_blocks(right[:rn], self._states[1])
            n = min(len(lp), len(rp))
            if n == 0:
                break
            outs.append(np.stack([lp[:n], rp[:n]], axis=1))
            need -= n
        if not outs:
            self._pos = len(self._data)
            return None
        return np.concatenate(outs, axis=0)


class VagStreamDecoder:
    """Incremental decoder for VAG audio arriving in chunks (MPEG
    private-stream-1 sub-stream 0xFF, import_vag.c mpeg_mode).

    Feed raw bytes as they arrive; an SShd header at the very start is
    parsed for rate/channels/interleave (otherwise mono 44.1 kHz raw
    blocks are assumed, the reference's fallback).  Stereo input is
    buffered to whole L/R interleave pairs so predictor state stays
    per-channel."""

    def __init__(self):
        self._buf = bytearray()
        self._hdr_checked = False
        self.info: Optional[VagInfo] = None
        self._states = [VagState(), VagState()]

    def feed(self, data: bytes) -> Optional[np.ndarray]:
        """Returns decoded (n, channels) int16 (possibly empty)."""
        self._buf += data
        if not self._hdr_checked:
            if len(self._buf) < 48:
                return None
            info = parse_header(bytes(self._buf[:64]))
            if info is not None:
                # in-stream header: data follows within this buffer
                del self._buf[:info.data_offset]
            else:
                info = VagInfo(rate=44100, channels=1, is_pcm=False,
                               block=BLOCK, data_offset=0,
                               data_size=None)
            self.info = info
            self._hdr_checked = True
        info = self.info
        if info.is_pcm:
            n = len(self._buf) // (2 * info.channels) * (
                2 * info.channels)
            if not n:
                return None
            a = np.frombuffer(bytes(self._buf[:n]), "<i2")
            del self._buf[:n]
            return a.reshape(-1, info.channels)
        if info.channels == 1:
            n = (len(self._buf) // BLOCK) * BLOCK
            if not n:
                return None
            pcm = decode_blocks(bytes(self._buf[:n]), self._states[0])
            del self._buf[:n]
            return pcm[:, None]
        pair = 2 * info.block
        outs = []
        while len(self._buf) >= pair:
            lp = decode_blocks(bytes(self._buf[:info.block]),
                               self._states[0])
            rp = decode_blocks(bytes(self._buf[info.block:pair]),
                               self._states[1])
            del self._buf[:pair]
            outs.append(np.stack([lp, rp], axis=1))
        return np.concatenate(outs, axis=0) if outs else None

    def flush(self) -> Optional[np.ndarray]:
        """Decode any whole blocks left in a trailing partial pair."""
        if not self.info or self.info.channels != 2 or not self._buf:
            return None
        left = bytes(self._buf[:self.info.block])
        right = bytes(self._buf[self.info.block:])
        self._buf.clear()
        ln = (len(left) // BLOCK) * BLOCK
        rn = (len(right) // BLOCK) * BLOCK
        lp = decode_blocks(left[:ln], self._states[0])
        rp = decode_blocks(right[:rn], self._states[1])
        if len(lp) and not len(rp):
            # right chunk truncated away: pad silence to keep shape
            return np.stack([lp, np.zeros_like(lp)], axis=1)
        n = min(len(lp), len(rp))
        if not n:
            return None
        return np.stack([lp[:n], rp[:n]], axis=1)
