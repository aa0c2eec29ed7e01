# Copied from tcforge_tpu/io/rawio.py; only the package name in its imports differs.
"""Raw frame packing/unpacking between container bytes and planar arrays.

The boundary layer where packed on-disk layouts (I420 buffers, YUY2/UYVY
interleaves, RGB byte orders) become the framework's planar numpy arrays.
Rebuild of the byte-shuffling halves of ``aclib/img_yuv_packed.c`` /
``img_rgb_packed.c`` plus the raw import/export modules
(``import/import_raw.c``, ``multiplex/multiplex_raw.c``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from tcforge_tpu_torch.core.formats import ImageFormat

F = ImageFormat


def unpack_frame(raw: bytes, fmt: ImageFormat, width: int,
                 height: int) -> Tuple[np.ndarray, ...]:
    """Packed frame bytes -> planes.

    Planar YUV -> (y, u, v); packed YUV -> planar 4:2:2 planes;
    RGB -> single (H, W, C) array in canonical R,G,B[,A] order;
    Y8/GRAY8 -> single (H, W).
    """
    buf = np.frombuffer(raw, np.uint8)
    if fmt.is_planar:
        uh, uw = fmt.uv_plane_shape(width, height)
        ys = width * height
        cs = uh * uw
        y = buf[:ys].reshape(height, width)
        u = buf[ys:ys + cs].reshape(uh, uw)
        v = buf[ys + cs:ys + 2 * cs].reshape(uh, uw)
        if fmt == F.YV12:
            u, v = v, u
        return y, u, v
    if fmt.is_packed_yuv:
        a = buf.reshape(height, width, 2)
        if fmt == F.YUY2:       # Y0 U Y1 V
            y = a[..., 0]
            u = a[:, 0::2, 1]
            v = a[:, 1::2, 1]
        elif fmt == F.UYVY:     # U Y0 V Y1
            y = a[..., 1]
            u = a[:, 0::2, 0]
            v = a[:, 1::2, 0]
        else:                   # YVYU: Y0 V Y1 U
            y = a[..., 0]
            v = a[:, 0::2, 1]
            u = a[:, 1::2, 1]
        return np.ascontiguousarray(y), np.ascontiguousarray(u), \
            np.ascontiguousarray(v)
    if fmt in (F.Y8, F.GRAY8):
        return (buf.reshape(height, width),)
    # RGB byte orders -> canonical channel order
    c = fmt.channels
    a = buf.reshape(height, width, c)
    order = {
        F.RGB24: (0, 1, 2), F.BGR24: (2, 1, 0),
        F.RGBA32: (0, 1, 2, 3), F.ABGR32: (3, 2, 1, 0),
        F.ARGB32: (1, 2, 3, 0), F.BGRA32: (2, 1, 0, 3),
    }[fmt]
    return (np.ascontiguousarray(a[..., list(order)]),)


def pack_frame(planes: Tuple[np.ndarray, ...], fmt: ImageFormat) -> bytes:
    """Planes -> packed frame bytes (inverse of unpack_frame)."""
    if fmt.is_planar:
        y, u, v = planes
        if fmt == F.YV12:
            u, v = v, u
        return y.tobytes() + u.tobytes() + v.tobytes()
    if fmt.is_packed_yuv:
        y, u, v = planes
        h, w = y.shape
        out = np.empty((h, w, 2), np.uint8)
        if fmt == F.YUY2:
            out[..., 0] = y
            out[:, 0::2, 1] = u
            out[:, 1::2, 1] = v
        elif fmt == F.UYVY:
            out[..., 1] = y
            out[:, 0::2, 0] = u
            out[:, 1::2, 0] = v
        else:  # YVYU
            out[..., 0] = y
            out[:, 0::2, 1] = v
            out[:, 1::2, 1] = u
        return out.tobytes()
    if fmt in (F.Y8, F.GRAY8):
        return planes[0].tobytes()
    rgb = planes[0]
    inv = {
        F.RGB24: (0, 1, 2), F.BGR24: (2, 1, 0),
        F.RGBA32: (0, 1, 2, 3), F.ABGR32: (3, 2, 1, 0),
        F.ARGB32: (3, 0, 1, 2), F.BGRA32: (2, 1, 0, 3),
    }[fmt]
    if rgb.shape[-1] == 3 and len(inv) == 4:
        rgb = np.concatenate([rgb, np.zeros_like(rgb[..., :1])], axis=-1)
    return np.ascontiguousarray(rgb[..., list(inv)]).tobytes()


class RawVideoReader:
    """Fixed-size raw frame stream (import_raw analogue)."""

    def __init__(self, path: str, fmt: ImageFormat, width: int, height: int):
        self._f = open(path, "rb")
        self.fmt, self.width, self.height = fmt, width, height
        self.frame_size = fmt.frame_bytes(width, height)

    def read_frame(self) -> Optional[Tuple[np.ndarray, ...]]:
        raw = self._f.read(self.frame_size)
        if len(raw) < self.frame_size:
            return None
        return unpack_frame(raw, self.fmt, self.width, self.height)

    def close(self):
        self._f.close()


class RawVideoWriter:
    def __init__(self, path: str, fmt: ImageFormat):
        self._f = open(path, "wb")
        self.fmt = fmt

    def write_frame(self, planes: Tuple[np.ndarray, ...]) -> None:
        self._f.write(pack_frame(planes, self.fmt))

    def close(self):
        self._f.close()
