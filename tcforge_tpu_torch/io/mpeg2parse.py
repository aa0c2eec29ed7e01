"""The MPEG-2 host parse: headers, slices, VLC and dequantisation.

A ctypes binding of the port's parse library, built with ``g++`` from
``csrc/mpeg2intra.cpp`` (a pinned copy of the JAX package's
``native/mpeg2intra.cpp``) at first use (``ops/_build.py``).  The parse
writes each picture's natural-order coefficient blocks and its
macroblock records into arrays the caller owns, so a reader can parse
straight into pinned host memory; ctypes releases the interpreter lock
for the call.

``Mpeg2Bitstream`` takes a whole elementary stream, or, with
``streaming=True``, windows of one: ``feed`` more when
``next_picture_full`` returns ``NEED_DATA`` and ``set_eos`` at the end of
the input.  Only the unparsed tail of the window is kept.  A picture
whose parse reaches the window's end before the start code that ends it
is parsed again with the next window, so the pictures do not depend on
where the windows end.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Sequence

import numpy as np

from tcforge_tpu_torch.ops import _build

# next_picture_full in streaming mode: the window holds no whole
# picture yet; feed() more bytes (or set_eos()) and call again
NEED_DATA = object()

# return codes of tc_m2d_next2 (csrc/mpeg2intra.cpp)
_OK, _EOS, _ETRUNC, _EUNSUP, _EAGAIN = 1, 0, -1, -2, -4

_P = ctypes.c_void_p
_I32P = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_U8P = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_LL = ctypes.c_longlong


@lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The parse library, built and loaded at first use; raises if the
    build fails."""
    lib = _build.load_host("mpeg2intra")
    for fn, res, args in (
            ("tc_m2d_open", _P, [_U8P, _LL]),
            ("tc_m2d_width", ctypes.c_int, [_P]),
            ("tc_m2d_height", ctypes.c_int, [_P]),
            ("tc_m2d_fps", ctypes.c_double, [_P]),
            ("tc_m2d_chroma", ctypes.c_int, [_P]),
            ("tc_m2d_next2", ctypes.c_int,
             [_P, _I32P, _I32P, _I32P, _I32P, _I32P]),
            ("tc_m2d_errmsg", ctypes.c_char_p, [_P]),
            ("tc_m2d_close", None, [_P]),
            ("tc_m2d_set_stream", None, [_P, ctypes.c_int]),
            ("tc_m2d_set_eos", None, [_P]),
            ("tc_m2d_tell", _LL, [_P]),
            ("tc_m2d_feed", None, [_P, _U8P, _LL])):
        f = getattr(lib, fn)
        f.restype, f.argtypes = res, args
    return lib


def coef_shapes(width: int, height: int, chroma: int = 1):
    """The shapes of one picture's parse output at a coded size: luma
    and chroma coefficient grids (blocks, 64) and the macroblock
    records (macroblocks, 12).  The coded grid rounds up to whole
    macroblocks (13818-2 6.3.3)."""
    mbh, mbw = (height + 15) // 16, (width + 15) // 16
    return ((mbh * 2, mbw * 2, 64), (mbh * chroma, mbw, 64),
            (mbh * chroma, mbw, 64), (mbh * mbw, 12))


class Mpeg2Bitstream:
    """One MPEG-1/2 video elementary stream through the host parse."""

    def __init__(self, data: bytes, streaming: bool = False):
        self._lib = library()
        self._buf = np.frombuffer(bytes(data), np.uint8)  # kept alive
        self._h = self._lib.tc_m2d_open(self._buf, len(self._buf))
        self.streaming = streaming
        self._eos_in = False
        if streaming:
            self._lib.tc_m2d_set_stream(self._h, 1)
        self.last_picture_structure = 3
        self.last_tff = 1
        self._geometry()

    def _geometry(self) -> None:
        lib, h = self._lib, self._h
        self.width = lib.tc_m2d_width(h)
        self.height = lib.tc_m2d_height(h)
        self.fps = lib.tc_m2d_fps(h)
        # 1 = 4:2:0, 2 = 4:2:2 (the sequence extension's chroma_format)
        self.chroma = lib.tc_m2d_chroma(h)

    def feed(self, more: bytes) -> None:
        """Append input: the parsed head of the window is dropped and
        the parse cursor rebases onto the tail and ``more``."""
        pos = int(self._lib.tc_m2d_tell(self._h))
        self._buf = np.frombuffer(self._buf[pos:].tobytes() + more,
                                  np.uint8)
        self._lib.tc_m2d_feed(self._h, self._buf, len(self._buf))
        if not self.width:
            self._geometry()

    def set_eos(self) -> None:
        self._eos_in = True
        self._lib.tc_m2d_set_eos(self._h)

    def next_picture_full(self, out: Sequence[np.ndarray]):
        """Parse the next picture into ``out`` = (ycoef, ucoef, vcoef,
        mbinfo), C-contiguous int32 arrays of ``coef_shapes``: its
        (picture_coding_type, temporal_reference), None at the end of
        the stream, or ``NEED_DATA`` in streaming mode.  A cut or broken
        picture raises ``EOFError`` or ``ValueError``, a stream the
        parse does not take ``NotImplementedError``."""
        if not self.width or not self.height:
            return (NEED_DATA if self.streaming and not self._eos_in
                    else None)
        ycoef, ucoef, vcoef, mbinfo = out
        meta = np.zeros(4, np.int32)
        entry = int(self._lib.tc_m2d_tell(self._h))
        rc = self._lib.tc_m2d_next2(self._h, ycoef.reshape(-1),
                                    ucoef.reshape(-1), vcoef.reshape(-1),
                                    mbinfo.reshape(-1), meta)
        if (rc == _OK and self.streaming and not self._eos_in
                and int(self._lib.tc_m2d_tell(self._h)) + 4
                > len(self._buf)):
            # the picture ran to the window's end, not to the start code
            # that ends it: the parse takes the end of the data for the
            # end of the picture, so a window that ends between two of its
            # macroblocks would cut it; parse it again with the next
            # window (the JAX importer keeps the cut picture)
            self._buf = np.frombuffer(self._buf[entry:].tobytes(), np.uint8)
            self._lib.tc_m2d_feed(self._h, self._buf, len(self._buf))
            return NEED_DATA
        if rc == _OK:
            self._geometry()
            self.last_picture_structure = int(meta[2])
            self.last_tff = int(meta[3])
            return int(meta[0]), int(meta[1])
        if rc == _EOS:
            return None
        if rc == _EAGAIN:
            return NEED_DATA
        msg = (self._lib.tc_m2d_errmsg(self._h) or b"").decode() \
            or "bitstream ended mid-picture"
        if rc == _ETRUNC:
            raise EOFError(f"truncated MPEG-2 stream: {msg}")
        if rc == _EUNSUP:
            raise NotImplementedError(msg)
        raise ValueError(f"MPEG-2 parse error: {msg}")

    def close(self) -> None:
        if self._h:
            self._lib.tc_m2d_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

