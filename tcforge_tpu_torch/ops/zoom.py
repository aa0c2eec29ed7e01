"""Filtered arbitrary-size resampling (tcv_zoom / -Z) on a band table.

The port of ``tcforge_tpu/ops/zoom.py``.  The filter functions and
``contrib_matrix`` (the dense ``(new, old)`` int32 matrix of 16.16
weights, an exact port of gen_contrib, zoom.c:330-380) are copied as
numpy.  On the card the matrix is not MXU-shaped work: each output
index has a short band of contributors (8-9 taps for Lanczos3 at
1920->1280), so ``band_table`` turns the matrix into per-row (first
source index, tap count, padded weights) and the ``zoom_pass`` kernel
sums ``px * w`` over the band in int32, the reference's own loop.  The
result equals the JAX golden pass ``_apply_pass_exact`` bit for bit.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from tcforge_tpu_torch.ops import kernels


# ----------------------------------------------------------------------- #
# Filter functions (zoom.c:150-320) — evaluated on the host.

def _sinc(x: float) -> float:
    return math.sin(x * math.pi) / (x * math.pi) if x != 0 else 1.0


def _hermite(t: float) -> float:
    t = abs(t)
    return (2.0 * t - 3.0) * t * t + 1.0 if t < 1.0 else 0.0


def _box(t: float) -> float:
    return 1.0 if -0.5 < t <= 0.5 else 0.0


def _triangle(t: float) -> float:
    t = abs(t)
    return 1.0 - t if t < 1.0 else 0.0


def _bell(t: float) -> float:
    t = abs(t)
    if t < 0.5:
        return 0.75 - t * t
    if t < 1.5:
        t = t - 1.5
        return 0.5 * t * t
    return 0.0


def _b_spline(t: float) -> float:
    t = abs(t)
    if t < 1:
        tt = t * t
        return (0.5 * tt * t) - tt + (2.0 / 3.0)
    if t < 2:
        t = 2 - t
        return (1.0 / 6.0) * t * t * t
    return 0.0


def _lanczos3(t: float) -> float:
    t = abs(t)
    return _sinc(t) * _sinc(t / 3.0) if t < 3.0 else 0.0


def _mitchell(t: float) -> float:
    B = C = 1.0 / 3.0
    tt = t * t
    t = abs(t)
    if t < 1.0:
        val = (((12.0 - 9.0 * B - 6.0 * C) * (t * tt))
               + ((-18.0 + 12.0 * B + 6.0 * C) * tt)
               + (6.0 - 2 * B))
        return val / 6.0
    if t < 2.0:
        val = (((-1.0 * B - 6.0 * C) * (t * tt))
               + ((6.0 * B + 30.0 * C) * tt)
               + ((-12.0 * B - 48.0 * C) * t)
               + (8.0 * B + 24 * C))
        return val / 6.0
    return 0.0


def _cubic_keys4(t: float) -> float:
    t = abs(t)
    if t < 1.0:
        return (3.0 + (t * t * (-7.0 + (t * 4.0)))) / 3.0
    if t < 2.0:
        return (30.0 + (t * (-59.0 + (t * (36.0 + (t * -7.0)))))) / 12.0
    if t < 3.0:
        return (-18.0 + (t * (21.0 + (t * (-8.0 + t))))) / 12.0
    return 0.0


def _sinc8(t: float) -> float:
    t = abs(t)
    if t == 0.0:
        return 1.0
    if t < 8.0:
        w = math.sin(math.pi * t / 8.0) / (math.pi * t / 8.0)
        return w * math.sin(t * math.pi) / (t * math.pi)
    return 0.0


def _gaussian(t: float) -> float:
    """GraphicsMagick GaussianFilter: exp(-2 t^2) * sqrt(2/pi)
    (support 1.25) — used by filter_compare.c's pattern resize."""
    return math.exp(-2.0 * t * t) * math.sqrt(2.0 / math.pi)


FILTERS: Dict[str, Tuple[Callable[[float], float], float]] = {
    "box": (_box, 0.5),
    "gaussian": (_gaussian, 1.25),
    "triangle": (_triangle, 1.0),
    "hermite": (_hermite, 1.0),
    "bell": (_bell, 1.5),
    "b_spline": (_b_spline, 2.0),
    "mitchell": (_mitchell, 2.0),
    "lanczos3": (_lanczos3, 3.0),
    "cubic_keys4": (_cubic_keys4, 3.0),
    "sinc8": (_sinc8, 8.0),
    "default": (_lanczos3, 3.0),
}


@lru_cache(maxsize=64)
def contrib_matrix(oldsize: int, newsize: int,
                   filter_name: str = "lanczos3") -> np.ndarray:
    """Dense (newsize, oldsize) int32 matrix of 16.16 fixed-point weights.

    Exact port of gen_contrib (zoom.c:330-380): center = i/scale, window
    [ceil(center - fwidth*fscale), floor(center + fwidth*fscale)],
    weight = filter((center - j)/fscale)/fscale with boundary reflection
    (j<0 -> -j; j>=old -> 2*old-j-1), then DOUBLE_TO_FIXED truncation.
    """
    try:
        filt, fwidth = FILTERS[filter_name.lower()]
    except KeyError:
        raise ValueError(f"unknown zoom filter {filter_name!r}") from None
    scale = newsize / oldsize
    fscale = 1.0 / scale if scale < 1.0 else 1.0
    new_fwidth = fwidth * fscale
    w = np.zeros((newsize, oldsize), dtype=np.int64)
    for i in range(newsize):
        center = i / scale
        left = math.ceil(center - new_fwidth)
        right = math.floor(center + new_fwidth)
        for j in range(left, right + 1):
            weight = filt((center - j) / fscale) / fscale
            if j < 0:
                n = -j
            elif j >= oldsize:
                n = (oldsize - j) + oldsize - 1
            else:
                n = j
            # DOUBLE_TO_FIXED truncates toward zero (C int cast)
            w[i, n] += int(weight * 65536)
    return w.astype(np.int32)


@lru_cache(maxsize=64)
def band_table(oldsize: int, newsize: int, filter_name: str = "lanczos3"
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The contributor band of every output index of ``contrib_matrix``.

    Returns ``(first, taps, weights)``: int32 (new,) first source index,
    int32 (new,) tap count, and int32 (new, maxtaps) weights padded with
    zeros past each row's count.  Zeros inside a row's span are kept,
    so the sums are unchanged; reflected edge contributions are already
    summed into the dense matrix.  Raises if a sum could overflow int32.
    """
    w = contrib_matrix(oldsize, newsize, filter_name)
    nz = w != 0
    has = nz.any(axis=1)
    first = np.where(has, nz.argmax(axis=1), 0)
    last = np.where(has, oldsize - 1 - nz[:, ::-1].argmax(axis=1), -1)
    taps = last - first + 1
    weights = np.zeros((newsize, max(1, int(taps.max()))), np.int32)
    for i in range(newsize):
        weights[i, :taps[i]] = w[i, first[i]:last[i] + 1]
    bound = 255 * np.abs(weights.astype(np.int64)).sum(axis=1).max()
    if bound + 0x8000 >= 1 << 31:
        raise ValueError(f"zoom {oldsize}->{newsize} ({filter_name}): "
                         "int32 accumulator could overflow")
    first, taps = first.astype(np.int32), taps.astype(np.int32)
    for a in (first, taps, weights):
        a.flags.writeable = False       # shared by every caller
    return first, taps, weights


@lru_cache(maxsize=64)
def _device_band(oldsize: int, newsize: int, filter_name: str,
                 device: str) -> kernels.Band:
    """``band_table`` as tensors on ``device``, made once per device."""
    tables = band_table(oldsize, newsize, filter_name)
    return kernels.Band(*(torch.from_numpy(np.array(a)).to(device)
                          for a in tables), oldsize=oldsize)


def zoom_plane(img: torch.Tensor, new_w: int, new_h: int,
               filter_name: str = "lanczos3", *,
               interlaced: bool = False) -> torch.Tensor:
    """Resize (..., H, W) uint8 planes to (..., new_h, new_w).

    tcv_zoom semantics (libtcvideo/tcvideo.c:543-650): the horizontal
    pass first into a uint8 intermediate, then the vertical pass.
    ``interlaced`` zooms each field on its own (new_h must be even),
    mirroring the negative-height mode.
    """
    h, w = img.shape[-2], img.shape[-1]
    if interlaced:
        if h % 2 or new_h % 2:
            raise ValueError("interlaced zoom requires even heights")
        out = torch.empty(img.shape[:-2] + (new_h, new_w),
                          dtype=torch.uint8, device=img.device)
        out[..., 0::2, :] = zoom_plane(img[..., 0::2, :], new_w,
                                       new_h // 2, filter_name)
        out[..., 1::2, :] = zoom_plane(img[..., 1::2, :], new_w,
                                       new_h // 2, filter_name)
        return out
    lead, dev = img.shape[:-2], str(img.device)
    out = img.reshape((-1, h, w)).contiguous()
    if new_w != w:
        out = kernels.zoom_pass(
            out, _device_band(w, new_w, filter_name, dev), axis=-1)
    if new_h != h:
        out = kernels.zoom_pass(
            out, _device_band(h, new_h, filter_name, dev), axis=-2)
    return out.reshape(lead + (new_h, new_w))
