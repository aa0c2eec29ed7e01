"""msharpen — edge-masked spatial sharpening (anime-oriented).

The port of ``tcforge_tpu/modules/filters/msharpen.py``
(``filter_msharpen.c``, Donald Graft's MSharpen), on RGB:

1. 3x3 separable box blur (truncating integer /3 per pass), borders
   copied from the source;
2. an edge mask from the diagonal and, with ``highq``, the vertical and
   horizontal blur differences against ``threshold``; the anti-diagonal
   tests channels 0 and 1 and never 2 (the reference's doubled
   ``g2-g3`` test);
3. on masked interior pixels ``v = max(0, 4*src - 3*blur)``, rescaled to
   255 jointly when a channel overflows, then blended ``(strength*v +
   (255-strength)*src) >> 8``.

YUV input converts to RGB24 and back through ``ops/colorspace.py``.
``mask=1`` gives the detail mask on all three channels; the JAX function
gives it on one, which its colour conversion then refuses.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch
import torch.nn.functional as F

from tcforge_tpu_torch.core.formats import ImageFormat
from tcforge_tpu_torch.core.frame import FrameBatch
from tcforge_tpu_torch.core.optstr import ModuleDesc, ParamSpec
from tcforge_tpu_torch.modules.registry import (FilterSlot, ModuleInfo,
                                                ModuleKind, VideoFilter,
                                                register)
from tcforge_tpu_torch.ops import colorspace


def msharpen_rgb(rgb: torch.Tensor, strength: int, threshold: int,
                 mask_only: bool = False,
                 highq: bool = True) -> torch.Tensor:
    """Apply msharpen to (..., H, W, 3) uint8 RGB."""
    src = rgb.to(torch.int32)
    h, w = rgb.shape[-3], rgb.shape[-2]

    # separable 3x3 box blur, truncating /3 each pass (all values >= 0)
    work = (src[..., 0:h - 2, :, :] + src[..., 1:h - 1, :, :]
            + src[..., 2:h, :, :]) // 3                   # rows 1..h-2
    workf = F.pad(work, (0, 0, 0, 0, 1, 1))
    blur = (workf[..., :, 0:w - 2, :] + workf[..., :, 1:w - 1, :]
            + workf[..., :, 2:w, :]) // 3                 # cols 1..w-2
    blur = F.pad(blur, (0, 0, 1, 1))
    border = torch.zeros((h, w), dtype=torch.bool, device=rgb.device)
    border[0, :] = True
    border[h - 1, :] = True
    border[:, 0] = True
    border[:, w - 1] = True
    blur = torch.where(border[..., None], src, blur)

    # edge detection
    bl = blur
    d_main = (bl[..., 0:h - 1, 0:w - 1, :]
              - bl[..., 1:h, 1:w, :]).abs() >= threshold
    d_anti = (bl[..., 0:h - 1, 1:w, :]
              - bl[..., 1:h, 0:w - 1, :]).abs() >= threshold
    edge = d_main.any(-1) | d_anti[..., 0] | d_anti[..., 1]
    if highq:
        d_v = ((bl[..., 0:h - 1, :, :] - bl[..., 1:h, :, :]).abs()
               >= threshold).any(-1)
        d_h = ((bl[..., :, 0:w - 1, :] - bl[..., :, 1:w, :]).abs()
               >= threshold).any(-1)
        edge = edge | d_v[..., :, 0:w - 1] | d_h[..., 0:h - 1, :]
    mask = F.pad(edge, (0, 1, 0, 1))
    mask[..., h - 1, :] = False
    mask[..., :, w - 1] = False

    if mask_only:
        return torch.where(mask[..., None], 255, 0).to(torch.uint8).expand(
            rgb.shape).contiguous()

    # sharpen
    v = (4 * src - 3 * blur).clamp_(min=0)
    vmax = v.amax(-1, keepdim=True)
    v = torch.where(vmax > 255, v * 255 // vmax.clamp(min=1), v)
    sharp = (strength * v + (255 - strength) * src) >> 8
    out = torch.where((mask & ~border)[..., None], sharp, src)
    return out.clamp_(0, 255).to(torch.uint8)


@register
class MsharpenFilter(VideoFilter):
    info = ModuleInfo(name="msharpen", kind=ModuleKind.FILTER)
    desc = ModuleDesc(
        name="msharpen", comment="neural-anime sharpening (MSharpen)",
        version="1.0", capabilities="VRY",
        params=[ParamSpec("strength", "sharpening strength", "d", 100, 0,
                          255),
                ParamSpec("threshold", "edge detail threshold", "d", 10,
                          0, 255),
                ParamSpec("mask", "show detail mask", "d", 0, 0, 1),
                ParamSpec("highq", "high quality detection", "d", 1, 0, 1)])
    slots = FilterSlot.POST_M

    def apply(self, fb: FrameBatch, state: Any) -> Tuple[FrameBatch, Any]:
        was_yuv = fb.rgb is None
        work = colorspace.convert(fb, ImageFormat.RGB24) if was_yuv else fb
        out = work.with_planes(rgb=msharpen_rgb(
            work.rgb, self.options["strength"], self.options["threshold"],
            bool(self.options["mask"]), bool(self.options["highq"])))
        if was_yuv:
            out = colorspace.convert(out, fb.format)
        return out, state
