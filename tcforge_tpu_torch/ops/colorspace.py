"""Colorspace / pixel-format conversion (``tcforge_tpu/ops/colorspace.py``).

The imgconvert registry over batched tensors, in plain torch: every op is
elementwise or a strided pick, and the JAX package runs no hand kernel
here either.  The integer arithmetic is the JAX functions' own, in
int32 with arithmetic shifts and floor division:

- YUV->RGB: cY=76309, crV=104597, cgU=-25675, cgV=-53279, cbU=132201,
  ``(... + 32768) >> 16``, clamped (``img_yuv_rgb.c:25-98``);
- RGB->YUV: the 16829/33039/6416 (Y), -9714/-19070/28784 (U),
  28784/-24103/-4681 (V) studio-swing matrix with the per-format chroma
  siting (420P: U from the top-left and V from the bottom-right pixel of
  each 2x2 block, ``img_yuv_rgb.c:160-172``);
- planar subsampling changes: nearest duplication upward, ``(a+b+1)/2``
  and ``(sum+2)/4`` rounded averages downward;
- Y8<->GRAY8: ``(i-16)*255/219`` and ``16 + i*219/255``.

Layout: planar YUV as separate (N, H, W) planes; RGB as (N, H, W, C) in
R,G,B[,A] order; packed YUV (YUY2/UYVY/YVYU) as YUV422P planes.  Every
plane that leaves ``convert`` is contiguous.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from tcforge_tpu_torch.core.formats import ImageFormat
from tcforge_tpu_torch.core.frame import FrameBatch

F = ImageFormat

# Reference YUV->RGB coefficients (img_yuv_rgb.c:25-29).
CY = 76309
CRV = 104597
CGU = -25675
CGV = -53279
CBU = 132201

# RGB->YUV studio-swing matrix (img_yuv_rgb.c:142-152).
RGB2Y_COEF = (16829, 33039, 6416)
RGB2U_COEF = (-9714, -19070, 28784)
RGB2V_COEF = (28784, -24103, -4681)

# RGB->GRAY8 full-swing luma (img_rgb_packed.c:179-190).
RGB2GRAY_COEF = (19595, 38470, 7471)

_PLANAR = (F.YUV420P, F.YUV411P, F.YUV422P, F.YUV444P)


# ----------------------------------------------------------------------- #
# Plane-level helpers (all int32 in, int32 out)

def _i32(a: torch.Tensor) -> torch.Tensor:
    return a.to(torch.int32)


def _u8(a: torch.Tensor) -> torch.Tensor:
    return a.to(torch.uint8).contiguous()


def _floordiv(a: torch.Tensor, d: int) -> torch.Tensor:
    return torch.div(a, d, rounding_mode="floor")


def _up_h(c: torch.Tensor, f: int) -> torch.Tensor:
    """Duplicate chroma horizontally (nearest)."""
    return torch.repeat_interleave(c, f, dim=-1)


def _up_v(c: torch.Tensor, f: int) -> torch.Tensor:
    return torch.repeat_interleave(c, f, dim=-2)


def _avg_h2(c: torch.Tensor) -> torch.Tensor:
    """Horizontal pairwise rounded average: (a+b+1)/2."""
    a = _i32(c)
    return (a[..., 0::2] + a[..., 1::2] + 1) >> 1


def _avg_v2(c: torch.Tensor) -> torch.Tensor:
    a = _i32(c)
    return (a[..., 0::2, :] + a[..., 1::2, :] + 1) >> 1


def _avg_h4(c: torch.Tensor) -> torch.Tensor:
    """Horizontal 4-tap rounded average: (sum+2)/4 (yuv444p_yuv411p)."""
    a = _i32(c)
    return (a[..., 0::4] + a[..., 1::4] + a[..., 2::4] + a[..., 3::4] + 2) >> 2


def y_to_gray(y: torch.Tensor) -> torch.Tensor:
    """Y2GRAY LUT formula (img_yuv_rgb.c:228-235): studio->full swing."""
    i = _i32(y)
    g = _floordiv((i - 16) * 255, 219)
    g = torch.where(i >= 235, torch.full_like(g, 255), g)
    return _u8(torch.where(i <= 16, torch.zeros_like(g), g))


def gray_to_y(g: torch.Tensor) -> torch.Tensor:
    """GRAY2Y: 16 + i*219/255 (img_yuv_rgb.c:236)."""
    return _u8(16 + _floordiv(_i32(g) * 219, 255))


# ----------------------------------------------------------------------- #
# YUV <-> RGB core math

def yuv_to_rgb_pixels(y: torch.Tensor, u: torch.Tensor,
                      v: torch.Tensor) -> torch.Tensor:
    """Full-resolution Y/U/V planes -> (..., 3) RGB, the YUV2RGB macro's
    integer math (img_yuv_rgb.c:76-86):
    ``r = (cY*(y-16) + crV*(v-128) + 32768) >> 16``, clamped."""
    yy = CY * (_i32(y) - 16) + 32768
    uu = _i32(u) - 128
    vv = _i32(v) - 128
    out = torch.empty(y.shape + (3,), dtype=torch.uint8, device=y.device)
    out[..., 0] = ((yy + CRV * vv) >> 16).clamp_(0, 255)
    out[..., 1] = ((yy + CGU * uu + CGV * vv) >> 16).clamp_(0, 255)
    out[..., 2] = ((yy + CBU * uu) >> 16).clamp_(0, 255)
    return out


def _rgb_dot(rgb: torch.Tensor, coef: Tuple[int, int, int]) -> torch.Tensor:
    r = _i32(rgb[..., 0])
    g = _i32(rgb[..., 1])
    b = _i32(rgb[..., 2])
    return (coef[0] * r + coef[1] * g + coef[2] * b + 32768) >> 16


def rgb_to_yuv_pixels(rgb: torch.Tensor) -> Tuple[torch.Tensor,
                                                  torch.Tensor,
                                                  torch.Tensor]:
    """Full-resolution RGB -> int32 Y, U, V planes (RGB2Y/U/V macros,
    img_yuv_rgb.c:142-152).  The studio-swing results lie in [0, 255]."""
    return (_rgb_dot(rgb, RGB2Y_COEF) + 16, _rgb_dot(rgb, RGB2U_COEF) + 128,
            _rgb_dot(rgb, RGB2V_COEF) + 128)


def rgb_to_gray_pixels(rgb: torch.Tensor) -> torch.Tensor:
    """RGB -> full-swing gray (img_rgb_packed.c:179-190)."""
    return _u8(_rgb_dot(rgb, RGB2GRAY_COEF))


def _upsample_chroma(c: torch.Tensor, fmt: ImageFormat) -> torch.Tensor:
    """Expand a subsampled chroma plane to full resolution by nearest
    duplication (img_yuv_rgb.c:100-103)."""
    sx, sy = fmt.subsampling
    if sy > 1:
        c = _up_v(c, sy)
    if sx > 1:
        c = _up_h(c, sx)
    return c


def _chroma_sites(fmt: ImageFormat):
    """((rows, columns) of U, (rows, columns) of V) as slices: where the
    reference picks each chroma sample (img_yuv_rgb.c:160-172):
      420P: U from (even y, even x), V from (odd y, odd x)
      411P: U from x%4==0, V from x%4==2 (every row)
      422P: U from even x, V from odd x (every row)
      444P: every pixel
    """
    every = slice(None)
    if fmt == F.YUV420P:
        return (slice(0, None, 2), slice(0, None, 2)), \
            (slice(1, None, 2), slice(1, None, 2))
    if fmt == F.YUV411P:
        return (every, slice(0, None, 4)), (every, slice(2, None, 4))
    if fmt in (F.YUV422P, F.YUY2, F.UYVY, F.YVYU):
        return (every, slice(0, None, 2)), (every, slice(1, None, 2))
    if fmt == F.YUV444P:
        return (every, every), (every, every)
    raise ValueError(f"no chroma siting for {fmt}")


# ----------------------------------------------------------------------- #
# FrameBatch-level conversions

def _like(fb: FrameBatch, fmt: ImageFormat, *, y=None, u=None, v=None,
          rgb=None) -> FrameBatch:
    """A batch of ``fmt`` with exactly these planes and ``fb``'s metadata."""
    return dataclasses.replace(fb, format=fmt, y=y, u=u, v=v, rgb=rgb)


def _norm_input(fb: FrameBatch) -> FrameBatch:
    """Normalize equivalent representations: YV12 -> YUV420P (swap U/V),
    packed YUV -> YUV422P planes."""
    if fb.format == F.YV12:
        return fb.with_planes(u=fb.v, v=fb.u, format=F.YUV420P)
    if fb.format.is_packed_yuv:
        return fb.with_planes(format=F.YUV422P)
    return fb


def _norm_output(fb: FrameBatch, dst: ImageFormat) -> FrameBatch:
    if dst == F.YV12:
        return fb.with_planes(u=fb.v, v=fb.u, format=F.YV12)
    if dst.is_packed_yuv:
        return fb.with_planes(format=dst)
    return fb


def _planar_to_planar(fb: FrameBatch, dst: ImageFormat) -> FrameBatch:
    """All 12 conversions among 420P/411P/422P/444P
    (img_yuv_planar.c:66-270): nearest duplication up, rounded average
    down, dimension by dimension."""
    ssx, ssy = fb.format.subsampling
    dsx, dsy = dst.subsampling

    def resample(c: torch.Tensor) -> torch.Tensor:
        # Vertical then horizontal: duplication and averaging act on
        # disjoint axes, so the order matches the C routines'.
        if dsy < ssy:      # vertical upsample (e.g. 420 -> 422/444)
            c = _up_v(c, ssy // dsy)
        elif dsy > ssy:    # vertical downsample (e.g. 422 -> 420)
            for _ in range(int.bit_length(dsy // ssy) - 1):
                c = _avg_v2(c)
        if dsx < ssx:      # horizontal upsample (e.g. 411 -> 422)
            c = _up_h(c, ssx // dsx)
        elif dsx > ssx:    # horizontal downsample
            f = dsx // ssx
            if f == 4:
                c = _avg_h4(c)
            else:
                for _ in range(int.bit_length(f) - 1):
                    c = _avg_h2(c)
        return _u8(c)

    return fb.with_planes(u=resample(fb.u), v=resample(fb.v), format=dst)


def _gray_to_rgb(gray: torch.Tensor, dst: ImageFormat) -> torch.Tensor:
    """Gray on R, G and B; a fourth channel is zero."""
    rgb = torch.zeros(gray.shape + (dst.channels,), dtype=torch.uint8,
                      device=gray.device)
    rgb[..., :3] = gray[..., None]
    return rgb


def _with_alpha(rgb: torch.Tensor) -> torch.Tensor:
    return torch.cat([rgb, torch.zeros_like(rgb[..., :1])], dim=-1)


def _yuv_to_rgb(fb: FrameBatch, dst: ImageFormat) -> FrameBatch:
    if fb.format == F.Y8:
        return fb.with_planes(rgb=_gray_to_rgb(y_to_gray(fb.y), dst),
                              format=dst)
    u = _upsample_chroma(fb.u, fb.format)
    v = _upsample_chroma(fb.v, fb.format)
    rgb = yuv_to_rgb_pixels(fb.y, u, v)
    if dst.channels == 4:
        rgb = _with_alpha(rgb)
    return fb.with_planes(rgb=rgb, format=dst)


def _rgb_to_yuv(fb: FrameBatch, dst: ImageFormat) -> FrameBatch:
    rgb = fb.rgb[..., :3]
    y = _u8(_rgb_dot(rgb, RGB2Y_COEF) + 16)
    if dst == F.Y8:
        return _like(fb, dst, y=y)
    # chroma only where the format keeps a sample: the pick is made
    # before the products and not after.  Sizes at which U and V come
    # out unlike (an odd width or height under 4:2:0, ...) are refused.
    (uy, ux), (vy, vx) = _chroma_sites(dst)
    us = _rgb_dot(rgb[..., uy, ux, :], RGB2U_COEF) + 128
    vs = _rgb_dot(rgb[..., vy, vx, :], RGB2V_COEF) + 128
    if us.shape != vs.shape:
        raise ValueError(
            f"{dst}: a {fb.width}x{fb.height} frame gives U "
            f"{tuple(us.shape[-2:])} and V {tuple(vs.shape[-2:])}")
    return _like(fb, dst, y=y, u=_u8(us), v=_u8(vs))


def _neutral_chroma(fb: FrameBatch, y: torch.Tensor,
                    dst: ImageFormat) -> FrameBatch:
    """``y`` with 128-filled chroma planes of ``dst``'s shape."""
    n, h, w = y.shape
    uh, uw = dst.uv_plane_shape(w, h)
    c = torch.full((n, uh, uw), 128, dtype=torch.uint8, device=y.device)
    return _like(fb, dst, y=y, u=c, v=c.clone())


def _gray_to_yuv(fb: FrameBatch, dst: ImageFormat) -> FrameBatch:
    """GRAY8 -> planar YUV: GRAY2Y for luma, 128 chroma fill
    (img_yuv_rgb.c gray8_yuv*)."""
    y = gray_to_y(fb.rgb[..., 0] if fb.rgb is not None else fb.y)
    if dst == F.Y8:
        return _like(fb, dst, y=y)
    return _neutral_chroma(fb, y, dst)


def convert(fb: FrameBatch, dst: ImageFormat) -> FrameBatch:
    """ac_imgconvert / tcv_convert analogue: convert a batch to ``dst``.

    Pairs with no direct path go through the same primitives as the
    JAX ``convert``; a pair it cannot serve raises ``ValueError``."""
    src_fb = _norm_input(fb)
    src = src_fb.format
    dst_norm = F.YUV422P if dst.is_packed_yuv else (
        F.YUV420P if dst == F.YV12 else dst)

    if src == dst_norm:
        return _norm_output(src_fb, dst)

    out: Optional[FrameBatch] = None
    if src in _PLANAR and dst_norm in _PLANAR:
        out = _planar_to_planar(src_fb, dst_norm)
    elif src in _PLANAR and dst_norm == F.Y8:
        out = _like(fb, F.Y8, y=src_fb.y)
    elif src == F.Y8 and dst_norm in _PLANAR:
        out = _neutral_chroma(fb, src_fb.y, dst_norm)
    elif (src in _PLANAR or src == F.Y8) and dst_norm == F.GRAY8:
        out = _like(fb, F.GRAY8, y=y_to_gray(src_fb.y))
    elif (src in _PLANAR or src == F.Y8) and dst_norm.is_rgb:
        out = _yuv_to_rgb(src_fb, dst_norm)
    elif src == F.GRAY8:
        if dst_norm.is_rgb:
            out = src_fb.with_planes(rgb=_gray_to_rgb(src_fb.y, dst_norm),
                                     format=dst_norm)
        else:
            out = _gray_to_yuv(src_fb, dst_norm)
    elif src.is_rgb and src != F.GRAY8:
        if dst_norm == F.GRAY8:
            out = _like(fb, F.GRAY8,
                        y=rgb_to_gray_pixels(src_fb.rgb[..., :3]))
        elif dst_norm.is_rgb:
            # canonical channel order internally; 24<->32 bit adds/drops A
            rgb = src_fb.rgb
            if dst_norm.channels == 4 and rgb.shape[-1] == 3:
                rgb = _with_alpha(rgb)
            elif dst_norm.channels == 3 and rgb.shape[-1] == 4:
                rgb = rgb[..., :3].contiguous()
            out = src_fb.with_planes(rgb=rgb, format=dst_norm)
        else:
            out = _rgb_to_yuv(src_fb, dst_norm)
    if out is None:
        raise ValueError(f"no conversion path {fb.format} -> {dst}")
    return _norm_output(out, dst)
