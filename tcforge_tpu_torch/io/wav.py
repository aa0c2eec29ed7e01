# Copied from tcforge_tpu/io/wav.py; only the package name in its imports differs.
"""WAV (RIFF/WAVE) reader/writer.

Rebuild of ``avilib/wavlib.[ch]``: PCM WAV files with header fixup on
close (the reference patches data sizes when the stream length is known
only at the end, ``wavlib.h:86-207``).
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass
from typing import BinaryIO, Optional, Union

import numpy as np


class WavError(ValueError):
    pass


@dataclass
class WavInfo:
    rate: int = 48000
    channels: int = 2
    bits: int = 16

    @property
    def block_align(self) -> int:
        return self.channels * self.bits // 8

    @property
    def byte_rate(self) -> int:
        return self.rate * self.block_align


class WavReader:
    def __init__(self, path_or_file: Union[str, BinaryIO]):
        if isinstance(path_or_file, (str, os.PathLike)):
            self._f: BinaryIO = open(path_or_file, "rb")
            self._own = True
        else:
            self._f = path_or_file
            self._own = False
        self.info, self._data_size = self._parse_header()
        self._read = 0

    def _parse_header(self):
        f = self._f
        riff = f.read(12)
        if len(riff) < 12 or riff[:4] != b"RIFF" or riff[8:12] != b"WAVE":
            raise WavError("not a RIFF/WAVE file")
        info = WavInfo()
        data_size = None
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            cid, size = hdr[:4], struct.unpack("<I", hdr[4:])[0]
            if cid == b"fmt ":
                fmt = f.read(size)
                (audio_fmt, channels, rate, _br, _ba,
                 bits) = struct.unpack("<HHIIHH", fmt[:16])
                if audio_fmt not in (1, 0xFFFE):  # PCM / extensible
                    raise WavError(f"unsupported WAV format tag {audio_fmt}")
                info = WavInfo(rate=rate, channels=channels, bits=bits)
            elif cid == b"data":
                data_size = size
                break
            else:
                f.seek(size + (size & 1), 1)
        if data_size is None:
            raise WavError("no data chunk")
        return info, data_size

    @property
    def total_samples(self) -> int:
        return self._data_size // self.info.block_align

    def read_samples(self, n: int) -> Optional[np.ndarray]:
        """Read up to n samples as (S, C) int16 (or uint8 for 8-bit);
        None at EOF."""
        ba = self.info.block_align
        remaining = (self._data_size - self._read) // ba
        n = min(n, remaining)
        if n <= 0:
            return None
        raw = self._f.read(n * ba)
        self._read += len(raw)
        got = len(raw) // ba
        dtype = np.int16 if self.info.bits == 16 else np.uint8
        a = np.frombuffer(raw[:got * ba], dtype=dtype)
        return a.reshape(got, self.info.channels)

    def close(self) -> None:
        if self._own:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class WavWriter:
    def __init__(self, path_or_file: Union[str, BinaryIO],
                 info: WavInfo = WavInfo()):
        if isinstance(path_or_file, (str, os.PathLike)):
            self._f: BinaryIO = open(path_or_file, "w+b")
            self._own = True
        else:
            self._f = path_or_file
            self._own = False
        self.info = info
        self._data_bytes = 0
        self._write_header(0)

    def _write_header(self, data_size: int) -> None:
        i = self.info
        hdr = struct.pack(
            "<4sI4s4sIHHIIHH4sI",
            b"RIFF", 36 + data_size, b"WAVE",
            b"fmt ", 16, 1, i.channels, i.rate, i.byte_rate,
            i.block_align, i.bits,
            b"data", data_size)
        self._f.write(hdr)

    def write_samples(self, pcm: np.ndarray) -> None:
        """Write (S, C) samples (int16 or uint8 matching `bits`)."""
        a = np.asarray(pcm)
        if a.ndim == 1:
            a = a[:, None]
        if a.shape[1] != self.info.channels:
            raise WavError(
                f"expected {self.info.channels} channels, got {a.shape[1]}")
        want = np.int16 if self.info.bits == 16 else np.uint8
        raw = a.astype(want, copy=False).tobytes()
        self._f.write(raw)
        self._data_bytes += len(raw)

    def close(self) -> None:
        # header fixup (wavlib close semantics)
        if self._f.seekable():
            self._f.seek(0)
            self._write_header(self._data_bytes)
        if self._own:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
