"""Deinterlacers of the libtcvideo layer (``tcforge_tpu/ops/video.py``).

Plain torch on (..., H, W) uint8 planes: these are elementwise and need
no hand kernel.  The integer arithmetic and the edge rows at odd and
even heights match the JAX functions exactly.
"""

from __future__ import annotations

import torch

from tcforge_tpu_torch.ops.aclib import average


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
