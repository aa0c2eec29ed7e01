# Copied from tcforge_tpu/io/pvn.py; only the package name in its imports differs.
"""PVN (PVB/PVG/PVP) portable video format reader/writer
(import/import_pvn.c, import/probe_pvn.c analogues).

Header: magic ``PV4|PV5|PV6`` + ``a|b|f|d`` (unsigned/signed int,
float, double), then whitespace-separated width, height, nframes,
maxval, framerate; ``#`` starts a comment.  Integer maxval is the bit
width (8/16/24/32); float maxval is the range with sign semantics
(``+v`` → [0,v], ``-v`` → [v,0] descending, bare → [-v,v]); bitmaps
(PV4) use maxval 1.  Samples are big-endian, one frame after another,
rows padded to whole bytes for bitmaps (import_pvn.c:145-290).

Conversion to 8-bit mirrors import_pvn.c:440-545: wider ints keep the
top byte, signed flips the sign bit, floats scale by (val-base)/range.
"""

from __future__ import annotations

import io
from dataclasses import dataclass
from typing import BinaryIO, Iterator, Optional, Tuple, Union

import numpy as np


@dataclass
class PvnHeader:
    imagetype: int                 # 4=bitmap, 5=grey, 6=rgb
    dtype: str                     # 'a' unsigned, 'b' signed, 'f', 'd'
    bits: int                      # sample bits (1 for bitmap)
    width: int
    height: int
    nframes: int                   # 0 = unknown / streaming
    framerate: float
    base: float = 0.0              # float types only
    range: float = 0.0

    @property
    def channels(self) -> int:
        return 3 if self.imagetype == 6 else 1

    @property
    def linesize(self) -> int:
        return (self.bits * self.width * self.channels + 7) // 8

    @property
    def framesize(self) -> int:
        return self.linesize * self.height


def _read_field(f: BinaryIO) -> Tuple[str, int]:
    """One whitespace-delimited header field, skipping # comments;
    returns (field, terminator) — terminator 0 on EOF."""
    out = []
    incomment = False
    while True:
        b = f.read(1)
        if not b:
            return "".join(out), 0
        ch = b[0]
        if ch == 0:
            raise ValueError("pvn: null byte in header")
        if ch == ord("#"):
            incomment = True
        elif ch == ord("\n"):
            if out:
                return "".join(out), ch
            incomment = False
        elif chr(ch) in " \t\r":
            if out:
                return "".join(out), ch
        elif not incomment:
            out.append(chr(ch))


def read_header(f: BinaryIO) -> PvnHeader:
    magic, _ = _read_field(f)
    if (len(magic) != 4 or magic[:2] != "PV" or magic[2] not in "456"
            or magic[3] not in "abfd"):
        raise ValueError(f"pvn: bad magic {magic!r}")
    imagetype = int(magic[2])
    dtype = magic[3]
    w, _ = _read_field(f)
    h, _ = _read_field(f)
    n, _ = _read_field(f)
    maxval, _ = _read_field(f)
    rate, term = _read_field(f)
    width, height, nframes = int(w), int(h), int(n)
    if width <= 0 or height <= 0 or nframes < 0:
        raise ValueError("pvn: bad geometry")
    base = rng = 0.0
    if imagetype == 4:
        if int(float(maxval)) != 1:
            raise ValueError("pvn: bitmap maxval must be 1")
        bits = 1
    elif dtype in "fd":
        mv = float(maxval)
        if mv == 0:
            raise ValueError("pvn: zero float maxval")
        if maxval.startswith("+"):
            base, rng = 0.0, mv
        elif maxval.startswith("-"):
            base, rng = mv, -mv       # mv is negative: [v, 0]
        else:
            base, rng = -mv, mv * 2
        bits = 32 if dtype == "f" else 64
    else:
        mvd = float(maxval)
        bits = int(mvd)
        if float(bits) != mvd or bits not in (8, 16, 24, 32):
            raise ValueError(f"pvn: bad integer maxval {maxval}")
    framerate = float(rate)
    if framerate < 0:
        raise ValueError("pvn: negative frame rate")
    if framerate == 0:
        framerate = 15.0
    # skip to end of the header line
    while term != ord("\n"):
        b = f.read(1)
        if not b:
            raise ValueError("pvn: EOF in header")
        term = b[0]
    return PvnHeader(imagetype=imagetype, dtype=dtype, bits=bits,
                     width=width, height=height, nframes=nframes,
                     framerate=framerate, base=base, range=rng)


def decode_frame(hdr: PvnHeader, raw: bytes) -> np.ndarray:
    """One frame of raw big-endian samples → uint8 (H,W) grey or
    (H,W,3) RGB (import_pvn.c:440-545 semantics)."""
    h, w, ch = hdr.height, hdr.width, hdr.channels
    if hdr.imagetype == 4:                       # bitmap, row-padded
        rows = np.frombuffer(raw, np.uint8).reshape(h, hdr.linesize)
        bits = np.unpackbits(rows, axis=1)[:, :w]
        img = np.where(bits == 1, 255, 0).astype(np.uint8)
        return img
    if hdr.dtype in "ab":
        nbytes = hdr.bits // 8
        a = np.frombuffer(raw, np.uint8).reshape(h, w * ch, nbytes)
        val = a[:, :, 0]                         # big-endian top byte
        if hdr.dtype == "b":
            val = val ^ 0x80
        out = val
    else:
        dt = ">f4" if hdr.dtype == "f" else ">f8"
        a = np.frombuffer(raw, dt).reshape(h, w * ch).astype(np.float64)
        out = np.floor((a - hdr.base) / hdr.range * 255 + 0.5)
        out = np.clip(out, 0, 255).astype(np.uint8)
    out = np.ascontiguousarray(out.astype(np.uint8))
    if ch == 3:
        return out.reshape(h, w, 3)
    return out.reshape(h, w)


def iter_frames(f: BinaryIO, hdr: PvnHeader) -> Iterator[np.ndarray]:
    while True:
        raw = f.read(hdr.framesize)
        if len(raw) < hdr.framesize:
            return
        yield decode_frame(hdr, raw)


def write_header(f: BinaryIO, hdr: PvnHeader) -> None:
    if hdr.imagetype == 4:
        maxval = "1"
    elif hdr.dtype in "fd":
        maxval = repr(hdr.range + hdr.base)
    else:
        maxval = str(hdr.bits)
    f.write(f"PV{hdr.imagetype}{hdr.dtype} {hdr.width} {hdr.height} "
            f"{hdr.nframes} {maxval} {hdr.framerate:g}\n"
            .encode("ascii"))


def write_frame(f: BinaryIO, hdr: PvnHeader, img: np.ndarray) -> None:
    """uint8 grey/RGB frame → PV5a/PV6a samples (8-bit only)."""
    if hdr.bits != 8 or hdr.dtype != "a":
        raise ValueError("pvn writer: only 8-bit unsigned output")
    f.write(np.ascontiguousarray(img, np.uint8).tobytes())


def probe(data: bytes) -> Optional[PvnHeader]:
    try:
        return read_header(io.BytesIO(data))
    except ValueError:
        return None
