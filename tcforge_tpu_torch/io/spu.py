# Copied from tcforge_tpu/io/spu.py; only the package name in its imports differs.
"""DVD subpicture (SPU) codec: RLE bitmap decode/encode + control
sequences.

The payload format handled by the reference's ``filter/extsub``
subsystem (subproc.c): a subpicture unit is a 2-bit-per-pixel RLE
bitmap in two interleaved fields plus a control sequence table carrying
display timing, screen coordinates, a 4-entry palette/alpha selection,
and the per-field RLE offsets.  The encoder exists for the test
fixtures (the reference relies on DVD mastering tools for that side).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

CMD_FORCE = 0x00
CMD_START = 0x01
CMD_STOP = 0x02
CMD_PALETTE = 0x03
CMD_ALPHA = 0x04
CMD_COORDS = 0x05
CMD_RLE_OFFSETS = 0x06
CMD_CHG_COLCON = 0x07
CMD_END = 0xFF


@dataclass
class Spu:
    """One decoded subpicture unit."""

    bitmap: np.ndarray                 # (h, w) uint8 color indices 0..3
    x: int = 0
    y: int = 0
    palette: Tuple[int, ...] = (0, 1, 2, 3)   # CLUT indices per color
    alpha: Tuple[int, ...] = (0, 15, 15, 15)  # 0 transparent .. 15
    start_ticks: int = 0               # delay of display start (1024ths)
    stop_ticks: Optional[int] = None   # delay of display stop
    forced: bool = False
    pts: Optional[int] = None          # 90 kHz presentation time


class _NibbleReader:
    def __init__(self, data: bytes, pos: int):
        self.data = data
        self.pos = pos                 # nibble position
    def get(self) -> int:
        byte = self.data[self.pos >> 1]
        v = (byte >> 4) if not (self.pos & 1) else (byte & 0xF)
        self.pos += 1
        return v
    def align(self) -> None:
        self.pos = (self.pos + 1) & ~1


def _decode_rle_field(data: bytes, offset: int, width: int,
                      rows: np.ndarray) -> None:
    """Decode one interleaved field's RLE lines into the given bitmap
    rows (the standard DVD nibble-run code)."""
    r = _NibbleReader(data, offset * 2)
    for row in rows:
        x = 0
        while x < width:
            v = r.get()
            if v < 0x4:
                v = (v << 4) | r.get()
                if v < 0x10:
                    v = (v << 4) | r.get()
                    if v < 0x40:
                        v = (v << 4) | r.get()
            run = v >> 2
            color = v & 3
            if run == 0:               # to end of line
                run = width - x
            run = min(run, width - x)
            row[x:x + run] = color
            x += run
        r.align()


def decode_spu(packet: bytes, pts: Optional[int] = None) -> Spu:
    """Parse one subpicture unit."""
    if len(packet) < 4:
        raise ValueError("short SPU packet")
    total, ctrl = struct.unpack(">HH", packet[:4])
    if total > len(packet) or ctrl >= total:
        raise ValueError("corrupt SPU packet header")

    x1 = x2 = y1 = y2 = 0
    top_off = bot_off = None
    palette = (0, 1, 2, 3)
    alpha = (0, 15, 15, 15)
    start_ticks = 0
    stop_ticks = None
    forced = False

    pos = ctrl
    seen = set()
    while pos not in seen:
        seen.add(pos)
        date, next_off = struct.unpack(">HH", packet[pos:pos + 4])
        p = pos + 4
        while p < total:
            cmd = packet[p]
            p += 1
            if cmd == CMD_END:
                break
            if cmd == CMD_FORCE:
                forced = True
            elif cmd == CMD_START:
                start_ticks = date
            elif cmd == CMD_STOP:
                stop_ticks = date
            elif cmd == CMD_PALETTE:
                b0, b1 = packet[p], packet[p + 1]
                palette = (b1 & 0xF, b1 >> 4, b0 & 0xF, b0 >> 4)
                p += 2
            elif cmd == CMD_ALPHA:
                b0, b1 = packet[p], packet[p + 1]
                alpha = (b1 & 0xF, b1 >> 4, b0 & 0xF, b0 >> 4)
                p += 2
            elif cmd == CMD_COORDS:
                b = packet[p:p + 6]
                x1 = (b[0] << 4) | (b[1] >> 4)
                x2 = ((b[1] & 0xF) << 8) | b[2]
                y1 = (b[3] << 4) | (b[4] >> 4)
                y2 = ((b[4] & 0xF) << 8) | b[5]
                p += 6
            elif cmd == CMD_RLE_OFFSETS:
                top_off, bot_off = struct.unpack(">HH", packet[p:p + 4])
                p += 4
            elif cmd == CMD_CHG_COLCON:
                size = struct.unpack(">H", packet[p:p + 2])[0]
                p += size
            else:
                raise ValueError(f"unknown SPU command 0x{cmd:02x}")
        if next_off == pos:
            break
        pos = next_off

    w = x2 - x1 + 1
    h = y2 - y1 + 1
    if w <= 0 or h <= 0 or top_off is None:
        raise ValueError("SPU without geometry or pixel data")
    bitmap = np.zeros((h, w), np.uint8)
    _decode_rle_field(packet, top_off, w, bitmap[0::2])
    _decode_rle_field(packet, bot_off, w, bitmap[1::2])
    return Spu(bitmap=bitmap, x=x1, y=y1, palette=palette, alpha=alpha,
               start_ticks=start_ticks, stop_ticks=stop_ticks,
               forced=forced, pts=pts)


# --------------------------------------------------------------------- #
# Encoder (test fixtures / authoring)


def _encode_rle_field(rows: np.ndarray) -> bytes:
    nibbles: List[int] = []
    for row in rows:
        x = 0
        w = len(row)
        while x < w:
            c = int(row[x])
            run = 1
            while x + run < w and row[x + run] == c and run < 255:
                run += 1
            if x + run >= w:
                # end-of-line code
                nibbles += [0, 0, 0, c]
                x = w
                continue
            v = (run << 2) | c
            if run <= 3:
                nibbles.append(v)
            elif run <= 15:
                nibbles += [v >> 4, v & 0xF]
            elif run <= 63:
                nibbles += [v >> 8, (v >> 4) & 0xF, v & 0xF]
            else:
                nibbles += [v >> 12, (v >> 8) & 0xF, (v >> 4) & 0xF,
                            v & 0xF]
            x += run
        if len(nibbles) & 1:
            nibbles.append(0)
    out = bytearray()
    for i in range(0, len(nibbles), 2):
        out.append((nibbles[i] << 4) | nibbles[i + 1])
    return bytes(out)


def encode_spu(bitmap: np.ndarray, x: int, y: int,
               palette: Tuple[int, ...] = (0, 1, 2, 3),
               alpha: Tuple[int, ...] = (0, 15, 15, 15),
               duration_ticks: int = 100) -> bytes:
    """Build one subpicture unit around a (h, w) 2-bit bitmap."""
    h, w = bitmap.shape
    top = _encode_rle_field(bitmap[0::2])
    bot = _encode_rle_field(bitmap[1::2])
    data_start = 4
    top_off = data_start
    bot_off = top_off + len(top)
    ctrl_off = bot_off + len(bot)

    cmds0 = bytearray()
    cmds0 += bytes([CMD_PALETTE,
                    (palette[3] << 4) | palette[2],
                    (palette[1] << 4) | palette[0]])
    cmds0 += bytes([CMD_ALPHA,
                    (alpha[3] << 4) | alpha[2],
                    (alpha[1] << 4) | alpha[0]])
    x2, y2 = x + w - 1, y + h - 1
    cmds0 += bytes([CMD_COORDS, x >> 4, ((x & 0xF) << 4) | (x2 >> 8),
                    x2 & 0xFF, y >> 4, ((y & 0xF) << 4) | (y2 >> 8),
                    y2 & 0xFF])
    cmds0 += bytes([CMD_RLE_OFFSETS]) + struct.pack(">HH", top_off,
                                                    bot_off)
    cmds0 += bytes([CMD_START, CMD_END])

    seq0_len = 4 + len(cmds0)
    seq1_off = ctrl_off + seq0_len
    seq0 = struct.pack(">HH", 0, seq1_off) + bytes(cmds0)
    seq1 = struct.pack(">HH", duration_ticks, seq1_off) \
        + bytes([CMD_STOP, CMD_END])

    total = ctrl_off + len(seq0) + len(seq1)
    return (struct.pack(">HH", total, ctrl_off) + top + bot
            + seq0 + seq1)


def iter_spu_packets(data: bytes):
    """Split concatenated subpicture units (raw .spu streams)."""
    pos = 0
    while pos + 4 <= len(data):
        total = struct.unpack(">H", data[pos:pos + 2])[0]
        if total < 4 or pos + total > len(data):
            break
        yield data[pos:pos + total]
        pos += total


def collect_vob_spus(path: str, track: int = 0) -> List[Spu]:
    """Demux private-stream-1 subpicture packets (substream 0x20+track)
    from a program stream, reassembling split units and keeping PTS."""
    from tcforge_tpu_torch.io.mpeg import iter_pes_packets
    spus: List[Spu] = []
    pending = b""
    pend_pts = None
    want = 0x20 + track
    for sid, payload, pts in iter_pes_packets(path, with_pts=True):
        if sid != 0xBD or not payload:
            continue
        sub_id = payload[0]
        if sub_id != want:
            continue
        chunk = payload[1:]
        if not pending:
            pending = chunk
            pend_pts = pts
        else:
            pending += chunk
        if len(pending) >= 2:
            total = struct.unpack(">H", pending[:2])[0]
            if len(pending) >= total:
                spus.append(decode_spu(pending[:total], pend_pts))
                pending = b""
    return spus
