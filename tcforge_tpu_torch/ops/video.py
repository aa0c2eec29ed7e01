"""Frame-geometry and pixel ops of the libtcvideo layer
(``tcforge_tpu/ops/video.py``): clip, the deinterlacers, the fast block
resize, reduce, the flips, gamma, antialias and the RGB grayscale.

Plain torch on (..., H, W) uint8 planes; an RGB batch goes through the
plane ops channel-first, (N, C, H, W), or through the ``*_rgb`` forms.
These are elementwise, gathers or strided picks and need no hand kernel
(the JAX package runs none here).  The integer arithmetic, and the edge
rows at odd and even sizes, match the JAX functions exactly; the float
tables (resize weights, gamma, antialias) are built on the host in
numpy by the same code, so both sides round alike.  Every result is
contiguous.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from tcforge_tpu_torch.ops.aclib import average, rescale_arrays

# Antialiasing "same color" threshold (tcvideo.c:37).
AA_DIFFERENT = 25


# ----------------------------------------------------------------------- #
# Clip / pad

def clip(img: torch.Tensor, top: int, left: int, bottom: int, right: int,
         black: int = 0) -> torch.Tensor:
    """Clip (positive) or pad with ``black`` (negative) on each edge of
    (..., H, W): tcv_clip (libtcvideo/tcvideo.c:184-254)."""
    h, w = img.shape[-2], img.shape[-1]
    if top + bottom >= h or left + right >= w:
        raise ValueError(
            f"clip ({top},{left},{bottom},{right}) invalid for {w}x{h}")
    y0, y1 = max(top, 0), h - max(bottom, 0)
    x0, x1 = max(left, 0), w - max(right, 0)
    out = img[..., y0:y1, x0:x1]
    pt, pb = max(-top, 0), max(-bottom, 0)
    pl, pr = max(-left, 0), max(-right, 0)
    if pt or pb or pl or pr:
        out = torch.nn.functional.pad(out, (pl, pr, pt, pb), value=black)
    return out.contiguous()


def clip_rgb(img: torch.Tensor, top: int, left: int, bottom: int,
             right: int, black: int = 0) -> torch.Tensor:
    """clip() for channel-last RGB batches (..., H, W, C)."""
    out = clip(torch.movedim(img, -1, 0), top, left, bottom, right, black)
    return torch.movedim(out, 0, -1).contiguous()


# ----------------------------------------------------------------------- #
# Deinterlacing (tcv_deinterlace, tcvideo.c:290-390)


def deint_drop_field(img: torch.Tensor,
                     drop_top: bool = False) -> torch.Tensor:
    """Keep every other line -> half height (deint_drop_field,
    tcvideo.c:333-345)."""
    start = 1 if drop_top else 0
    h = img.shape[-2]
    return img[..., start:start + 2 * (h // 2):2, :].contiguous()


def deint_interpolate(img: torch.Tensor) -> torch.Tensor:
    """Even lines kept; odd lines = rounded average of their neighbors;
    a final odd line copies the one above (deint_interpolate,
    tcvideo.c:347-364)."""
    h = img.shape[-2]
    out = img.clone()
    if h >= 3:                        # odd lines 1, 3, .. < h-1
        out[..., 1:h - 1:2, :] = average(img[..., 0:h - 2:2, :],
                                         img[..., 2:h:2, :])
    if h % 2 == 0 and h >= 2:         # last line is odd: copy previous
        out[..., h - 1, :] = img[..., h - 2, :]
    return out


def deint_linear_blend(img: torch.Tensor) -> torch.Tensor:
    """Full linear blend (deint_linear_blend, tcvideo.c:367-390):
    interpolate odd lines from even neighbors, interpolate even lines
    from odd neighbors (in a copy, reading original odd lines), then
    average the two results."""
    h = img.shape[-2]
    a = deint_interpolate(img)
    b = img.clone()
    b[..., 0, :] = img[..., 1, :]
    if h >= 4:                        # even lines 2, 4, .. < h-1
        b[..., 2:h - 1:2, :] = average(img[..., 1:h - 2:2, :],
                                       img[..., 3:h:2, :])
    if h % 2 == 1 and h >= 3:         # last line is even: copy previous
        b[..., h - 1, :] = b[..., h - 2, :]
    return average(b, a)


# ----------------------------------------------------------------------- #
# Fast block resize (tcv_resize, -X/-B options)

@lru_cache(maxsize=64)
def _resize_table(oldsize: int, newsize: int) -> Tuple[np.ndarray,
                                                       np.ndarray,
                                                       np.ndarray]:
    """init_one_resize_table (tcvideo.c, sin^2 window 2-tap weights):
    (source, weight1, weight2), one entry per output pixel of a block.
    ``oldsize``/``newsize`` are in eighth-of-block units as in the
    reference (width*8/scale_w); the table has newsize/8 entries."""
    n = newsize // 8
    source = np.zeros(n, dtype=np.int64)
    w1 = np.zeros(n, dtype=np.int64)
    w2 = np.zeros(n, dtype=np.int64)
    width_ratio = oldsize / newsize
    for i in range(n):
        oldpos = i * oldsize / newsize
        source[i] = int(oldpos)
        if oldpos + width_ratio < source[i] + 1:
            w1[i], w2[i] = 65536, 0
        else:
            temp = ((source[i] + 1) - oldpos) / width_ratio * math.pi / 2
            w1[i] = int(math.sin(temp) * math.sin(temp) * 65536 + 0.5)
            w2[i] = 65536 - w1[i]
    return source, w1, w2


def _resize_axis(img: torch.Tensor, dim: int, delta: int,
                 scale: int) -> torch.Tensor:
    """One axis of resize_fast: ``scale`` blocks, each resampled through
    the block's table, the second tap clamped at the plane's end."""
    size = img.shape[dim]
    src_idx, w1, w2 = _resize_table(size * 8 // scale,
                                    (size + delta * scale) * 8 // scale)
    first = (np.arange(scale)[:, None] * (size // scale)
             + src_idx[None, :]).reshape(-1)
    second = np.minimum(first + 1, size - 1)

    def index(a):
        return torch.as_tensor(a, dtype=torch.int64, device=img.device)

    def weights(a):
        t = torch.as_tensor(np.tile(a, scale), dtype=torch.int32,
                            device=img.device)
        return t[:, None] if dim == -2 else t

    return rescale_arrays(img.index_select(dim, index(first)),
                          img.index_select(dim, index(second)),
                          weights(w1), weights(w2))


def resize_fast(img: torch.Tensor, resize_w: int, resize_h: int,
                scale_w: int = 8, scale_h: int = 8) -> torch.Tensor:
    """tcv_resize (tcvideo.c:427-515): block-based 2-tap resize.

    ``resize_w``/``resize_h`` are deltas in units of ``scale_w``/
    ``scale_h`` pixels (positive enlarges, negative shrinks), the -X / -B
    semantics; height first, then width, as in the C code."""
    out = img
    if resize_h:
        out = _resize_axis(out, -2, resize_h, scale_h)
    if resize_w:
        out = _resize_axis(out, -1, resize_w, scale_w)
    return out.contiguous()


# ----------------------------------------------------------------------- #
# Reduce / flips / gamma / grayscale

def reduce(img: torch.Tensor, reduce_w: int, reduce_h: int) -> torch.Tensor:
    """tcv_reduce (tcvideo.c:682-719): drop intervening pixels."""
    if reduce_w < 1 or reduce_h < 1:
        raise ValueError("reduce factors must be >= 1")
    h, w = img.shape[-2], img.shape[-1]
    return img[..., 0:(h // reduce_h) * reduce_h:reduce_h,
               0:(w // reduce_w) * reduce_w:reduce_w].contiguous()


def flip_v(img: torch.Tensor) -> torch.Tensor:
    """tcv_flip_v (tcvideo.c:739-766)."""
    return torch.flip(img, (-2,))


def flip_h(img: torch.Tensor) -> torch.Tensor:
    """tcv_flip_h (tcvideo.c:786-818)."""
    return torch.flip(img, (-1,))


def flip_h_rgb(img: torch.Tensor) -> torch.Tensor:
    return torch.flip(img, (-2,))


def flip_v_rgb(img: torch.Tensor) -> torch.Tensor:
    return torch.flip(img, (-3,))


@lru_cache(maxsize=16)
def _gamma_table(gamma: float) -> np.ndarray:
    """init_gamma_table (tcvideo.c): (i/255)^gamma * 255, C-truncated."""
    i = np.arange(256, dtype=np.float64)
    return (np.power(i / 255.0, gamma) * 255).astype(np.uint8)


@lru_cache(maxsize=16)
def _gamma_lut(gamma: float, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_gamma_table(gamma)).to(device)


def gamma_correct(img: torch.Tensor, gamma: float) -> torch.Tensor:
    """tcv_gamma_correct (tcvideo.c:840-860): 256-entry LUT."""
    if gamma <= 0:
        raise ValueError("gamma must be positive")
    return _gamma_lut(float(gamma), img.device)[img.long()]


# ----------------------------------------------------------------------- #
# Antialiasing (tcv_antialias, tcvideo.c:885-980)

@lru_cache(maxsize=16)
def _aa_tables(weight: float, bias: float) -> Tuple[np.ndarray, ...]:
    """init_aa_table (tcvideo.c): 256-entry 16.16 LUTs for the center
    (c), horizontal/vertical (x, y) and diagonal (d) taps."""
    i = np.arange(256, dtype=np.float64)
    c = (i * weight * 65536).astype(np.uint32)
    x = (i * bias * (1 - weight) / 4 * 65536).astype(np.uint32)
    y = (i * (1 - bias) * (1 - weight) / 4 * 65536).astype(np.uint32)
    d = ((x + y + 1) // 2).astype(np.uint32)
    return tuple(t.astype(np.int32) for t in (c, x, y, d))


@lru_cache(maxsize=16)
def _aa_luts(weight: float, bias: float,
             device: torch.device) -> Tuple[torch.Tensor, ...]:
    return tuple(torch.from_numpy(t).to(device)
                 for t in _aa_tables(weight, bias))


def antialias(img: torch.Tensor, weight: float = 1.0 / 3.0,
              bias: float = 0.5) -> torch.Tensor:
    """tcv_antialias for single-channel planes (Bpp=1 path).

    Edge-directed 3x3 smoothing: a pixel is rewritten only where one of
    four diagonal-edge predicates holds (tcvideo.c:948-953); the new
    value is a 9-tap weighted sum through the c/x/y/d LUTs.  Frame
    borders are copied unchanged."""
    if not (0 <= weight <= 1 and 0 <= bias <= 1):
        raise ValueError("antialias weight/bias must be in [0,1]")
    lc, lx, ly, ld = _aa_luts(float(weight), float(bias), img.device)
    src = img.long()
    h, w = src.shape[-2], src.shape[-1]
    out = img.clone()
    if h < 3 or w < 3:
        return out

    def sh(dy: int, dx: int) -> torch.Tensor:
        """Neighbor view for the interior region."""
        return src[..., 1 + dy:h - 1 + dy, 1 + dx:w - 1 + dx]

    C = sh(0, 0)
    U, D, L, R = sh(-1, 0), sh(1, 0), sh(0, -1), sh(0, 1)
    UL, UR, DL, DR = sh(-1, -1), sh(-1, 1), sh(1, -1), sh(1, 1)

    def same(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
        return (p2 - p1).abs() < AA_DIFFERENT

    lu, ld_, lr = same(L, U), same(L, D), same(L, R)
    ru, rd = same(R, U), same(R, D)
    cond = ((lu & ~ld_ & ~lr) | (ld_ & ~lu & ~lr)
            | (ru & ~rd & ~lr) | (rd & ~ru & ~lr))

    tmp = (ld[UL] + ly[U] + ld[UR]
           + lx[L] + lc[C] + lx[R]
           + ld[DL] + ly[D] + ld[DR] + 32768)
    out[..., 1:-1, 1:-1] = torch.where(cond, tmp >> 16, C.to(torch.int32)) \
        .to(img.dtype)
    return out


def decolor_rgb(rgb: torch.Tensor) -> torch.Tensor:
    """-K for RGB frames: replace each pixel with its luma (the engine's
    grayscale path through tcv_convert RGB->GRAY8->RGB)."""
    from tcforge_tpu_torch.ops.colorspace import rgb_to_gray_pixels
    out = rgb.clone()
    out[..., :3] = rgb_to_gray_pixels(rgb[..., :3])[..., None]
    return out
