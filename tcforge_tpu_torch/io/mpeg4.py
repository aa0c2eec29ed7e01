# Copied from tcforge_tpu/io/mpeg4.py; only the package name in its imports differs.
"""MPEG-4 part 2 (DivX/XviD) elementary-stream helpers.

Keyframe predicates matching ``filter/divxkey/filter_divxkey.c``:

- DivX 4/5 (MPEG-4 ES): a frame is a keyframe when its VOP start code
  (00 00 01 B6) is followed by vop_coding_type == 0 (I-VOP) — the top
  two bits of the byte after the start code
  (``filter_divxkey.c:quicktime_divx4_is_key``);
- DivX ;-) 3.11 (MSMPEG4v3): bit 0x40000000 of the first big-endian
  dword clear means intra (``quicktime_divx3_is_key``).
"""

from __future__ import annotations

import numpy as np

VOP_START_CODE = b"\x00\x00\x01\xb6"


def divx4_is_key(payload: bytes) -> bool:
    """True when the first VOP in the payload is an I-VOP."""
    i = payload.find(VOP_START_CODE)
    if i < 0 or i + 4 >= len(payload):
        return False
    return (payload[i + 4] & 0xC0) == 0


def divx3_is_key(payload: bytes) -> bool:
    """MSMPEG4v3: intra when bit 30 of the leading dword is clear."""
    if len(payload) < 4:
        return False
    dw = int.from_bytes(payload[:4], "big")
    return (dw & 0x40000000) == 0


def iter_vops(data: bytes):
    """Yield (offset, coding_type) for every VOP start code.

    coding_type: 0=I, 1=P, 2=B, 3=S (sprite).
    """
    pos = 0
    while True:
        i = data.find(VOP_START_CODE, pos)
        if i < 0 or i + 4 >= len(data):
            return
        yield i, (data[i + 4] & 0xC0) >> 6
        pos = i + 4


def scan_keyframes(data: bytes) -> np.ndarray:
    """Bool array over the stream's VOPs: True where intra (I-VOP)."""
    types = [t for _, t in iter_vops(data)]
    return np.array([t == 0 for t in types], dtype=bool)
