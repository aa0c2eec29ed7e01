# Copied from tcforge_tpu/io/nuv.py; only the package name in its imports differs.
"""NuppelVideo (.nuv) container reader/writer.

Rebuild of the structures in ``import/nuv/nuppelvideo.h`` and the
walk in ``import/nuv/import_nuv.c``: a 72-byte file header
("NuppelVideo", geometry, fps, keyframedist) followed by 12-byte frame
headers — 'D' compressor data (RTjpeg quant tables), 'V' video ('0'
raw YUV420, '1' RTjpeg, 'N' black, 'L' repeat last; lzo variants are
reported unsupported), 'A' audio ('0' raw PCM), 'S' sync points, 'T'
text.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Iterator, Optional, Tuple

import numpy as np

MAGIC = b"NuppelVideo\0"
FILE_HDR = struct.Struct("<12s5s3xiiiic7xddiiii")   # 72 bytes
FRAME_HDR = struct.Struct("<ccccii")                # 12 bytes


@dataclass
class NuvHeader:
    width: int = 0
    height: int = 0
    fps: float = 25.0
    aspect: float = 1.0
    pimode: str = "P"
    keyframedist: int = 15
    videoblocks: int = -1
    audioblocks: int = -1


def write_file_header(f, hdr: NuvHeader) -> None:
    f.write(FILE_HDR.pack(
        MAGIC, b"0.05\0", hdr.width, hdr.height, 0, 0,
        hdr.pimode.encode()[:1], hdr.aspect, hdr.fps,
        hdr.videoblocks, hdr.audioblocks, 0, hdr.keyframedist))


def read_file_header(f) -> NuvHeader:
    raw = f.read(FILE_HDR.size)
    if len(raw) < FILE_HDR.size:
        raise ValueError("short NUV file header")
    (finfo, _ver, w, h, _dw, _dh, pimode, aspect, fps,
     vblocks, ablocks, _t, kfd) = FILE_HDR.unpack(raw)
    if not finfo.startswith(b"NuppelVideo"):
        raise ValueError("not a NuppelVideo file")
    return NuvHeader(width=w, height=h, fps=fps, aspect=aspect,
                     pimode=pimode.decode("ascii", "replace"),
                     keyframedist=kfd, videoblocks=vblocks,
                     audioblocks=ablocks)


def write_frame(f, frametype: str, comptype: str, payload: bytes,
                timecode: int = 0, keyframe: int = 0) -> None:
    f.write(FRAME_HDR.pack(frametype.encode()[:1],
                           comptype.encode()[:1],
                           bytes([keyframe]), b"\0", timecode,
                           len(payload)))
    f.write(payload)


def iter_frames(f) -> Iterator[Tuple[str, str, int, bytes]]:
    """Yield (frametype, comptype, timecode, payload)."""
    while True:
        raw = f.read(FRAME_HDR.size)
        if len(raw) < FRAME_HDR.size:
            return
        ft, ct, _kf, _filt, tc, plen = FRAME_HDR.unpack(raw)
        ftype = ft.decode("ascii", "replace")
        if ftype == "R":
            # seekpoint: the header itself is the 'RTjjjjjjjj' marker
            continue
        payload = f.read(plen) if plen > 0 else b""
        if len(payload) < max(0, plen):
            return
        yield ftype, ct.decode("ascii", "replace"), tc, payload
