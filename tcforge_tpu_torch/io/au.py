# Copied from tcforge_tpu/io/au.py; only the package name in its imports differs.
"""Sun/NeXT .au (SND) audio files.

The reference's sunau name is a BSD capture device module; this adds
the FILE format the same magic identifies (big-endian header: magic
".snd", data offset, data size, encoding, rate, channels — the
classic SPARC audio container).  Supported encodings: 8-bit mu-law
(1), 8-bit linear (2), 16-bit linear big-endian (3) — all decoded to
the engine's canonical s16le.
"""

from __future__ import annotations

import struct
from typing import BinaryIO, Optional, Union

import numpy as np

AU_MAGIC = b".snd"

ENC_MULAW = 1
ENC_LINEAR8 = 2
ENC_LINEAR16 = 3


def _mulaw_table() -> np.ndarray:
    """ITU G.711 mu-law byte -> s16 (the CCITT reference expansion)."""
    u = np.arange(256, dtype=np.int32) ^ 0xFF    # stored complemented
    sign = u >> 7
    exponent = (u >> 4) & 7
    mantissa = u & 0xF
    magnitude = ((mantissa << 3) + 0x84 << exponent) - 0x84
    return np.where(sign, -magnitude, magnitude).astype(np.int16)


_MULAW = None


class AuReader:
    def __init__(self, path_or_file: Union[str, BinaryIO]):
        if isinstance(path_or_file, str):
            self._f: BinaryIO = open(path_or_file, "rb")
            self._own = True
        else:
            self._f = path_or_file
            self._own = False
        hdr = self._f.read(24)
        if len(hdr) < 24 or hdr[:4] != AU_MAGIC:
            raise ValueError("not a Sun AU file")
        (self.data_offset, self.data_size, self.encoding,
         self.rate, self.channels) = struct.unpack(">IIIII", hdr[4:24])
        if self.encoding not in (ENC_MULAW, ENC_LINEAR8, ENC_LINEAR16):
            raise NotImplementedError(
                f"AU encoding {self.encoding} not supported (mu-law, "
                "8/16-bit linear decode)")
        if self.channels < 1 or self.rate < 1:
            raise ValueError("AU: invalid rate/channel header")
        self._f.seek(self.data_offset)
        bps = 2 if self.encoding == ENC_LINEAR16 else 1
        self._frame_bytes = bps * self.channels
        if self.data_size != 0xFFFFFFFF:       # unknown-length marker
            self.total_samples = self.data_size // self._frame_bytes
        else:
            self.total_samples = None

    def read_samples(self, n: int) -> Optional[np.ndarray]:
        """(n', channels) int16, or None at EOF."""
        raw = self._f.read(n * self._frame_bytes)
        if not raw:
            return None
        usable = len(raw) // self._frame_bytes * self._frame_bytes
        raw = raw[:usable]
        if self.encoding == ENC_LINEAR16:
            pcm = np.frombuffer(raw, ">i2").astype("<i2")
        elif self.encoding == ENC_LINEAR8:
            # 8-bit linear is SIGNED in AU (unlike WAV's unsigned)
            pcm = (np.frombuffer(raw, np.int8).astype(np.int16)
                   << 8)
        else:
            global _MULAW
            if _MULAW is None:
                _MULAW = _mulaw_table()
            pcm = _MULAW[np.frombuffer(raw, np.uint8)]
        return pcm.reshape(-1, self.channels)

    def close(self) -> None:
        if self._own:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_au(path: str, pcm: np.ndarray, rate: int) -> None:
    """Write 16-bit linear big-endian AU (test fixtures / tcdecode)."""
    pcm = np.asarray(pcm, np.int16)
    if pcm.ndim == 1:
        pcm = pcm[:, None]
    with open(path, "wb") as f:
        f.write(AU_MAGIC)
        f.write(struct.pack(">IIIII", 24, pcm.size * 2, ENC_LINEAR16,
                            rate, pcm.shape[1]))
        f.write(pcm.astype(">i2").tobytes())
