# Copied from tcforge_tpu/io/cdxa.py; only the package name in its imports differs.
"""RIFF/CDXA (VideoCD .DAT) unwrapping.

A VCD track rip is a RIFF file whose `data` chunk holds raw mode-2
CD-ROM XA sectors (2352 bytes: 12 sync + 4 header + 8 subheader +
user data + EDC/ECC).  The MPEG program stream lives in the user-data
area (form 2: 2324 bytes; form 1: 2048 — selected per sector by
subheader submode bit 5).  The reference dumped the data chunk raw
(avilib/avidump.c AVI_dump mode 2) and relied on downstream tools;
here the sectors unwrap to a clean PS so the normal mpeg importer and
tcextract paths just work.
"""

from __future__ import annotations

import struct
from typing import Iterator

SECTOR = 2352
SYNC = b"\x00" + b"\xff" * 10 + b"\x00"
FORM2 = 0x20                    # subheader submode bit 5


def iter_data_chunks(path: str) -> Iterator[bytes]:
    """RIFF walk yielding the CDXA `data` chunk payload(s)."""
    with open(path, "rb") as f:
        head = f.read(12)
        if head[:4] != b"RIFF" or head[8:12] != b"CDXA":
            raise ValueError("not a RIFF/CDXA file")
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                return
            fourcc, size = hdr[:4], struct.unpack("<I", hdr[4:])[0]
            if fourcc == b"data":
                remaining = size
                while remaining > 0:
                    blk = f.read(min(remaining, 1 << 20))
                    if not blk:
                        return
                    remaining -= len(blk)
                    yield blk
            else:
                f.seek(size + (size & 1), 1)


def unwrap_sectors(data: bytes) -> bytes:
    """Raw XA sectors -> concatenated user data (the program
    stream).  Sectors without the sync pattern pass through verbatim
    (already-unwrapped 2324/2048 payloads appear in the wild)."""
    out = bytearray()
    n = len(data)
    pos = 0
    while pos + SECTOR <= n:
        sec = data[pos:pos + SECTOR]
        if sec[:12] != SYNC:
            # not sector-framed: hand the rest through untouched
            out += data[pos:]
            return bytes(out)
        submode = sec[18]               # subheader byte 2
        if submode & FORM2:
            out += sec[24:24 + 2324]
        else:
            out += sec[24:24 + 2048]
        pos += SECTOR
    out += data[pos:] if pos == 0 else b""
    return bytes(out)


def cdxa_to_ps(path: str) -> bytes:
    """Whole-file convenience: RIFF/CDXA -> MPEG PS bytes."""
    return unwrap_sectors(b"".join(iter_data_chunks(path)))


def wrap_ps(ps: bytes) -> bytes:
    """PS bytes -> RIFF/CDXA with form-2 sectors (test fixtures;
    2324-byte user areas, zero EDC)."""
    sectors = bytearray()
    minute = 0
    for off in range(0, len(ps), 2324):
        user = ps[off:off + 2324].ljust(2324, b"\x00")
        header = bytes([minute & 0xFF, 0, 0, 2])     # fake MSF, mode 2
        sub = bytes([0, 0, FORM2, 0]) * 2
        sectors += SYNC + header + sub + user + b"\x00" * 4
        minute += 1
    body = b"data" + struct.pack("<I", len(sectors)) + bytes(sectors)
    return (b"RIFF" + struct.pack("<I", 4 + len(body)) + b"CDXA"
            + body)
