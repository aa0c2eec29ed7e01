# Copied from tcforge_tpu/io/ac3.py; only the package name in its imports differs.
"""AC-3 (ATSC A/52) syncframe header parsing — the import/ac3scan.c
role: locate syncwords, read fscod/frmsizecod, derive frame size,
bitrate and channel mode so tcscan/tcprobe can report AC-3 streams
without decoding them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional, Tuple

SYNCWORD = 0x0B77

_RATES = (48000, 44100, 32000)
# kbit/s by frmsizecod >> 1 (A/52 table 5.18)
_BITRATES = (32, 40, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224,
             256, 320, 384, 448, 512, 576, 640)
# acmod -> channel count (A/52 table 5.8; LFE adds one more)
_ACMOD_CHANS = (2, 1, 2, 3, 3, 4, 4, 5)


@dataclass
class Ac3Frame:
    size: int             # bytes
    rate: int             # Hz
    bitrate: int          # kbit/s
    channels: int
    acmod: int

    @property
    def duration_ms(self) -> float:
        return 1536_000.0 / self.rate      # 1536 samples per frame


def parse_frame_header(buf: bytes, off: int = 0) -> Optional[Ac3Frame]:
    """Parse one syncframe header at ``off``; None if not a valid
    syncframe start."""
    if len(buf) < off + 7:
        return None
    if buf[off] != 0x0B or buf[off + 1] != 0x77:
        return None
    fscod = buf[off + 4] >> 6
    frmsizecod = buf[off + 4] & 0x3F
    if fscod == 3 or frmsizecod >= 38:
        return None
    kbps = _BITRATES[frmsizecod >> 1]
    if fscod == 0:                         # 48 kHz
        words = 2 * kbps
    elif fscod == 2:                       # 32 kHz
        words = 3 * kbps
    else:                                  # 44.1 kHz (+pad bit)
        words = (320 * kbps) // 147 + (frmsizecod & 1)
    # bsid/bsmod then acmod (top 3 bits of byte 6)
    acmod = buf[off + 6] >> 5
    chans = _ACMOD_CHANS[acmod]
    # LFE bit position depends on acmod's skipped fields; report the
    # full-bandwidth channel count (scan-level fidelity)
    return Ac3Frame(size=words * 2, rate=_RATES[fscod], bitrate=kbps,
                    channels=chans, acmod=acmod)


def iter_frames(data: bytes) -> Iterator[Tuple[int, Ac3Frame]]:
    """Walk a byte stream yielding (offset, frame); resyncs on noise
    like ac3scan.c does."""
    off = 0
    n = len(data)
    while off + 7 <= n:
        fr = parse_frame_header(data, off)
        if fr is None:
            off += 1
            continue
        yield off, fr
        off += fr.size
