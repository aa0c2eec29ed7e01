# Copied from tcforge_tpu/io/y4m.py; only the package name in its imports differs.
"""YUV4MPEG2 stream reader/writer.

Rebuild of the reference's Y4M handling (``import/import_yuv4mpeg.c``,
``multiplex/multiplex_y4m.c``, ``encode/encode_yuv4mpeg.c``): the stream
is an ASCII signature line ``YUV4MPEG2 W<w> H<h> F<n>:<d> I<i> A<n>:<d>
[C<chroma>]`` followed by ``FRAME\\n`` + raw planar frames.
"""

from __future__ import annotations

import io as _io
import os
from dataclasses import dataclass
from fractions import Fraction
from typing import BinaryIO, Iterator, Optional, Tuple, Union

import numpy as np

from tcforge_tpu_torch.core.formats import ImageFormat

_CHROMA_TO_FMT = {
    b"420": ImageFormat.YUV420P,
    b"420jpeg": ImageFormat.YUV420P,
    b"420mpeg2": ImageFormat.YUV420P,
    b"420paldv": ImageFormat.YUV420P,
    b"411": ImageFormat.YUV411P,
    b"422": ImageFormat.YUV422P,
    b"444": ImageFormat.YUV444P,
    b"mono": ImageFormat.Y8,
}
_FMT_TO_CHROMA = {
    ImageFormat.YUV420P: b"420",
    ImageFormat.YUV411P: b"411",
    ImageFormat.YUV422P: b"422",
    ImageFormat.YUV444P: b"444",
    ImageFormat.Y8: b"mono",
}

MAGIC = b"YUV4MPEG2"


class Y4MError(ValueError):
    pass


@dataclass
class Y4MHeader:
    width: int
    height: int
    fps_num: int = 25
    fps_den: int = 1
    interlacing: str = "p"        # p / t / b / m / ?
    aspect_num: int = 0
    aspect_den: int = 0
    format: ImageFormat = ImageFormat.YUV420P

    @property
    def fps(self) -> float:
        return self.fps_num / self.fps_den if self.fps_den else 0.0

    def frame_planes_shapes(self) -> Tuple[Tuple[int, int], ...]:
        if self.format == ImageFormat.Y8:
            return ((self.height, self.width),)
        uh, uw = self.format.uv_plane_shape(self.width, self.height)
        return ((self.height, self.width), (uh, uw), (uh, uw))

    @property
    def frame_bytes(self) -> int:
        return sum(h * w for h, w in self.frame_planes_shapes())

    def to_line(self) -> bytes:
        parts = [MAGIC, b"W%d" % self.width, b"H%d" % self.height,
                 b"F%d:%d" % (self.fps_num, self.fps_den),
                 b"I" + self.interlacing.encode()]
        if self.aspect_num and self.aspect_den:
            parts.append(b"A%d:%d" % (self.aspect_num, self.aspect_den))
        parts.append(b"C" + _FMT_TO_CHROMA[self.format])
        return b" ".join(parts) + b"\n"

    @staticmethod
    def parse(line: bytes) -> "Y4MHeader":
        fields = line.strip().split(b" ")
        if not fields or fields[0] != MAGIC:
            raise Y4MError(f"not a YUV4MPEG2 stream: {line[:32]!r}")
        h = Y4MHeader(width=0, height=0)
        for tok in fields[1:]:
            if not tok:
                continue
            tag, val = tok[:1], tok[1:]
            if tag == b"W":
                h.width = int(val)
            elif tag == b"H":
                h.height = int(val)
            elif tag == b"F":
                n, d = val.split(b":")
                h.fps_num, h.fps_den = int(n), int(d)
            elif tag == b"I":
                h.interlacing = val.decode() or "?"
            elif tag == b"A":
                n, d = val.split(b":")
                h.aspect_num, h.aspect_den = int(n), int(d)
            elif tag == b"C":
                fmt = _CHROMA_TO_FMT.get(val)
                if fmt is None:
                    raise Y4MError(f"unsupported chroma mode {val!r}")
                h.format = fmt
            elif tag == b"X":
                pass  # extension tokens ignored
        if h.width <= 0 or h.height <= 0:
            raise Y4MError("missing W/H in YUV4MPEG2 header")
        return h


class Y4MReader:
    """Streaming reader yielding per-frame numpy plane tuples."""

    def __init__(self, path_or_file: Union[str, BinaryIO]):
        if isinstance(path_or_file, (str, os.PathLike)):
            self._f: BinaryIO = open(path_or_file, "rb")
            self._own = True
        else:
            self._f = path_or_file
            self._own = False
        line = self._f.readline(256)
        self.header = Y4MHeader.parse(line)

    def __enter__(self) -> "Y4MReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        if self._own:
            self._f.close()

    def read_frame(self) -> Optional[Tuple[np.ndarray, ...]]:
        """Read one frame; None at EOF."""
        line = self._f.readline(256)
        if not line:
            return None
        if not line.startswith(b"FRAME"):
            raise Y4MError(f"bad FRAME marker: {line[:32]!r}")
        raw = self._f.read(self.header.frame_bytes)
        if len(raw) < self.header.frame_bytes:
            raise Y4MError("truncated frame")
        planes = []
        off = 0
        for (h, w) in self.header.frame_planes_shapes():
            n = h * w
            planes.append(
                np.frombuffer(raw, np.uint8, n, off).reshape(h, w))
            off += n
        return tuple(planes)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, ...]]:
        while True:
            fr = self.read_frame()
            if fr is None:
                return
            yield fr

    def read_batch(self, n: int) -> Optional[Tuple[np.ndarray, ...]]:
        """Read up to n frames, stacked as (N, H, W) plane arrays.
        Returns None at EOF, else a tuple of stacked planes (the last
        batch may be short)."""
        frames = []
        for _ in range(n):
            fr = self.read_frame()
            if fr is None:
                break
            frames.append(fr)
        if not frames:
            return None
        nplanes = len(frames[0])
        return tuple(np.stack([f[i] for f in frames]) for i in range(nplanes))


class Y4MWriter:
    def __init__(self, path_or_file: Union[str, BinaryIO],
                 header: Y4MHeader):
        if isinstance(path_or_file, (str, os.PathLike)):
            self._f: BinaryIO = open(path_or_file, "wb")
            self._own = True
        else:
            self._f = path_or_file
            self._own = False
        self.header = header
        self._f.write(header.to_line())
        self.frames_written = 0

    def __enter__(self) -> "Y4MWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def write_frame(self, *planes: np.ndarray) -> None:
        shapes = self.header.frame_planes_shapes()
        if len(planes) != len(shapes):
            raise Y4MError(f"expected {len(shapes)} planes, got {len(planes)}")
        self._f.write(b"FRAME\n")
        for p, (h, w) in zip(planes, shapes):
            a = np.asarray(p, dtype=np.uint8)
            if a.shape != (h, w):
                raise Y4MError(f"plane shape {a.shape} != {(h, w)}")
            self._f.write(a.tobytes())
        self.frames_written += 1

    def write_batch(self, *stacked_planes: np.ndarray) -> None:
        """Write a batch of frames given stacked (N, H, W) planes."""
        n = stacked_planes[0].shape[0]
        for i in range(n):
            self.write_frame(*(p[i] for p in stacked_planes))

    def close(self) -> None:
        if self._own:
            self._f.close()
