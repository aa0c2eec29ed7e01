"""xsharpen — 3x3 rank-order sharpening.

The port of ``tcforge_tpu/modules/filters/xsharpen.py``
(``filter_xsharpen.c``, VirtualDub's xsharpen): for each interior pixel
find the brightest and dimmest pixel of its 3x3 window; if the pixel is
closer to one extreme and the gap to it is under ``threshold``, blend
it toward that extreme, ``(strength*extreme + (255-strength)*src) /
255``.  Borders pass through.  YUV works on the luma plane; RGB ranks by
the luma proxy ``(55r + 182g + 19b) >> 8`` and blends whole pixels,
taking the first extreme of the window on ties, as ``jnp.argmin`` and
``torch.argmin`` both do.  Defaults strength 200, threshold 255.
"""

from __future__ import annotations

from typing import Any, List, Tuple

import torch

from tcforge_tpu_torch.core.frame import FrameBatch
from tcforge_tpu_torch.core.optstr import ModuleDesc, ParamSpec
from tcforge_tpu_torch.modules.registry import (FilterSlot, ModuleInfo,
                                                ModuleKind, VideoFilter,
                                                register)


def _window(x: torch.Tensor, h: int, w: int, rgb: bool) -> List[torch.Tensor]:
    """The nine 3x3-window views over the interior of (..., H, W[, C]),
    row by row."""
    if rgb:
        return [x[..., 1 + dy:h - 1 + dy, 1 + dx:w - 1 + dx, :]
                for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
    return [x[..., 1 + dy:h - 1 + dy, 1 + dx:w - 1 + dx]
            for dy in (-1, 0, 1) for dx in (-1, 0, 1)]


def _decide(c, lo, hi, threshold: int):
    mindiff = c - lo
    maxdiff = hi - c
    to_max = (mindiff > maxdiff) & (maxdiff < threshold)
    to_min = (mindiff <= maxdiff) & (mindiff < threshold)
    return to_max, to_min


def xsharpen_luma(y: torch.Tensor, strength: int,
                  threshold: int) -> torch.Tensor:
    """YUV path: rank-order mapping on the (..., H, W) luma plane."""
    src = y.to(torch.int32)
    h, w = src.shape[-2], src.shape[-1]
    if h < 3 or w < 3:
        return y
    stack = torch.stack(_window(src, h, w, False))
    lo, hi = stack.amin(0), stack.amax(0)
    c = stack[4]
    to_max, to_min = _decide(c, lo, hi, threshold)
    target = torch.where(to_max, hi, torch.where(to_min, lo, c))
    mapped = torch.div(strength * target + (255 - strength) * c, 255,
                       rounding_mode="floor")
    out = y.clone()
    out[..., 1:h - 1, 1:w - 1] = torch.where(to_max | to_min, mapped,
                                             c).to(y.dtype)
    return out


def xsharpen_rgb(rgb: torch.Tensor, strength: int,
                 threshold: int) -> torch.Tensor:
    """RGB path: rank by the luma proxy, blend whole pixels toward the
    extreme pixel of the window (the first one on ties)."""
    src = rgb.to(torch.int32)
    h, w = src.shape[-3], src.shape[-2]
    if h < 3 or w < 3:
        return rgb
    luma = (55 * src[..., 0] + 182 * src[..., 1] + 19 * src[..., 2]) >> 8
    lstack = torch.stack(_window(luma, h, w, False))     # (9, ..., h-2, w-2)
    pstack = torch.stack(_window(src, h, w, True))       # (..., 3) too
    imin = lstack.argmin(0)
    imax = lstack.argmax(0)
    lo = lstack.gather(0, imin[None])[0]
    hi = lstack.gather(0, imax[None])[0]
    pick = lambda i: pstack.gather(
        0, i[None, ..., None].expand((1,) + pstack.shape[1:]))[0]
    pmin, pmax = pick(imin), pick(imax)
    c = lstack[4]
    csrc = pstack[4]
    to_max, to_min = _decide(c, lo, hi, threshold)
    target = torch.where(to_max[..., None], pmax,
                         torch.where(to_min[..., None], pmin, csrc))
    mapped = torch.div(strength * target + (255 - strength) * csrc, 255,
                       rounding_mode="floor")
    out = rgb.clone()
    out[..., 1:h - 1, 1:w - 1, :] = torch.where(
        (to_max | to_min)[..., None], mapped, csrc).to(rgb.dtype)
    return out


@register
class XsharpenFilter(VideoFilter):
    info = ModuleInfo(name="xsharpen", kind=ModuleKind.FILTER)
    desc = ModuleDesc(
        name="xsharpen", comment="VirtualDub's XSharpen filter",
        capabilities="VRY",
        params=[ParamSpec("strength", "mapping strength", "d", 200, 0, 255),
                ParamSpec("threshold", "mapping threshold", "d", 255, 0,
                          255)])
    slots = FilterSlot.POST_M

    def apply(self, fb: FrameBatch, state: Any) -> Tuple[FrameBatch, Any]:
        s = self.options["strength"]
        t = self.options["threshold"]
        if s == 0:
            return fb, state
        if fb.rgb is not None:
            return fb.with_planes(rgb=xsharpen_rgb(fb.rgb, s, t)), state
        return fb.with_planes(y=xsharpen_luma(fb.y, s, t)), state
