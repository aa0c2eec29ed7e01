# Copied from tcforge_tpu/io/mp3.py; only the package name in its imports differs.
"""MP3 frame-header parsing (tools/aud_scan.c tc_get_mp3_header
analogue) — enough for frame-accurate stream walking/cutting without a
decoder.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional, Tuple

# tabsel_123[lsf][layer-1][bitrate_index] (kbit/s); layer 3 row used
_BITRATES = (
    ((0, 32, 64, 96, 128, 160, 192, 224, 256, 288, 320, 352, 384, 416,
      448, 0),
     (0, 32, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224, 256, 320,
      384, 0),
     (0, 32, 40, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224, 256,
      320, 0)),
    ((0, 32, 48, 56, 64, 80, 96, 112, 128, 144, 160, 176, 192, 224,
      256, 0),
     (0, 8, 16, 24, 32, 40, 48, 56, 64, 80, 96, 112, 128, 144, 160, 0),
     (0, 8, 16, 24, 32, 40, 48, 56, 64, 80, 96, 112, 128, 144, 160,
      0)))

_FREQS = (44100, 48000, 32000, 22050, 24000, 16000, 11025, 12000, 8000)


@dataclass
class Mp3Frame:
    size: int
    channels: int
    rate: int
    bitrate: int          # kbit/s

    @property
    def duration_ms(self) -> float:
        return (self.size * 8) / self.bitrate


def parse_header(hbuf: bytes) -> Optional[Mp3Frame]:
    """Parse a 4-byte MPEG audio (layer III) frame header; None when it
    isn't one."""
    if len(hbuf) < 4:
        return None
    h = (hbuf[0] << 24) | (hbuf[1] << 16) | (hbuf[2] << 8) | hbuf[3]
    if (h & 0xFFE00000) != 0xFFE00000 or (h & 0x0000FC00) == 0x0000FC00:
        return None
    if (4 - ((h >> 17) & 3)) != 3:       # layer III only
        return None
    if h & (1 << 20):
        lsf = 0 if (h & (1 << 19)) else 1
        mpeg25 = 0
    else:
        lsf = 1
        mpeg25 = 1
    if mpeg25:
        sf = 6 + ((h >> 10) & 0x3)
    else:
        sf = ((h >> 10) & 0x3) + lsf * 3
    if sf > 8:
        return None
    bitrate_index = (h >> 12) & 0xF
    padding = (h >> 9) & 0x1
    stereo = 1 if ((h >> 6) & 0x3) == 3 else 2
    if not bitrate_index:
        return None
    kbps = _BITRATES[lsf][2][bitrate_index]
    framesize = kbps * 144000
    if not framesize:
        return None
    framesize //= _FREQS[sf] << lsf
    framesize += padding
    return Mp3Frame(size=framesize, channels=stereo, rate=_FREQS[sf],
                    bitrate=kbps)


def iter_frames(data: bytes) -> Iterator[Tuple[int, Mp3Frame]]:
    """Walk an MP3 stream yielding (offset, frame); resyncs on noise."""
    pos = 0
    n = len(data)
    while pos + 4 <= n:
        fr = parse_header(data[pos:pos + 4])
        if fr is None:
            pos += 1
            continue
        if pos + fr.size > n:
            return
        yield pos, fr
        pos += fr.size
