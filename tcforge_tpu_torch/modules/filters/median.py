"""yuvmedian — thresholded pseudo-median (2dclean-style) denoiser.

The port of ``tcforge_tpu/modules/filters/median.py``
(``filter_yuvmedian.c``): every interior pixel becomes the floor mean of
the window values whose difference from the centre lies strictly inside
``threshold``; when too few qualify (``count <= ((2r+1)^2 + 2)/3``) the
fixed 3x3 kernel ``(sum of 8 neighbours + 8*centre + 8) >> 4`` takes its
place.  Borders of ``radius`` pixels pass through; luma and chroma have
their own radius and threshold, and ``interlace=1`` filters each field
on its own.  The window walk is a Python loop over the (2r+1)^2 offsets
of rolled planes (wrap-around never reaches an interior pixel).  By
default the filter sits in the PRE slot (``pre=1``), before the
internal transforms.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from tcforge_tpu_torch.core.formats import ImageFormat
from tcforge_tpu_torch.core.frame import FrameBatch
from tcforge_tpu_torch.core.optstr import ModuleDesc, ParamSpec
from tcforge_tpu_torch.modules.registry import (FilterSlot, ModuleInfo,
                                                ModuleKind, VideoFilter,
                                                register)


def median_plane(plane: torch.Tensor, radius: int,
                 threshold: int) -> torch.Tensor:
    """filter_yuvmedian.c:filter_buffer on a (..., H, W) uint8 plane."""
    p = plane.to(torch.int32)
    r = int(radius)
    rc = 2 * r + 1
    min_count = (rc * rc + 2) // 3

    def sh(dy, dx):
        return torch.roll(p, (-dy, -dx), dims=(-2, -1))

    total = torch.zeros_like(p)
    count = torch.zeros_like(p)
    for i in range(rc * rc):
        q = sh(i // rc - r, i % rc - r)
        diff = p - q
        ok = (diff < threshold) & (diff > -threshold)
        total += torch.where(ok, q, 0)
        count += ok.to(torch.int32)
    mean = total // count.clamp(min=1)
    fallback = (sh(-1, -1) + sh(-1, 0) + sh(-1, 1) + sh(0, -1)
                + (p << 3) + 8 + sh(0, 1)
                + sh(1, -1) + sh(1, 0) + sh(1, 1)) >> 4
    out = torch.where(count <= min_count, fallback, mean)
    h, w = plane.shape[-2], plane.shape[-1]
    yy = torch.arange(h, device=plane.device)[:, None]
    xx = torch.arange(w, device=plane.device)[None, :]
    interior = (yy >= r) & (yy < h - r) & (xx >= r) & (xx < w - r)
    return torch.where(interior, out, p).to(torch.uint8)


def _median_fields(plane: torch.Tensor, radius: int,
                   threshold: int) -> torch.Tensor:
    out = torch.empty_like(plane)
    out[..., 0::2, :] = median_plane(plane[..., 0::2, :], radius, threshold)
    out[..., 1::2, :] = median_plane(plane[..., 1::2, :], radius, threshold)
    return out


@register
class YuvMedianFilter(VideoFilter):
    """filter_yuvmedian.c: thresholded window average, per plane."""

    info = ModuleInfo(name="yuvmedian", kind=ModuleKind.FILTER)
    desc = ModuleDesc(
        name="yuvmedian", comment="mjpegs YUV median filter",
        capabilities="VYOE",
        params=[
            ParamSpec("radius_luma", "Radius for median (luma)", "d",
                      2, 1, 24),
            ParamSpec("radius_chroma", "Radius for median (chroma)", "d",
                      2, 1, 24),
            ParamSpec("threshold_luma", "Trigger threshold (luma)", "d",
                      2, 1, 32),
            ParamSpec("threshold_chroma", "Trigger threshold (chroma)",
                      "d", 2, 1, 32),
            ParamSpec("interlace", "Treat input as interlaced", "d",
                      0, 0, 1),
            ParamSpec("pre", "Run as a PRE filter", "d", 1, 0, 1)])
    slots = FilterSlot.PRE_M

    def __init__(self, job, options: str = ""):
        super().__init__(job, options)
        if not self.options["pre"]:
            self.slots = FilterSlot.POST_M

    def init_state(self, width: int, height: int, fmt: ImageFormat,
                   device: torch.device) -> Any:
        if fmt == ImageFormat.RGB24:
            raise ValueError(
                "yuvmedian: filter is not capable for RGB-Mode !")
        if self.options["interlace"] and height % 2:
            raise ValueError(
                "yuvmedian: input images have odd number of lines - "
                "can't treats as interlaced!")
        return None

    def apply(self, fb: FrameBatch, state: Any) -> Tuple[FrameBatch, Any]:
        o = self.options
        run = _median_fields if o["interlace"] else median_plane
        y = run(fb.y, o["radius_luma"], o["threshold_luma"])
        u = v = None
        if fb.u is not None:
            u = run(fb.u, o["radius_chroma"], o["threshold_chroma"])
            v = run(fb.v, o["radius_chroma"], o["threshold_chroma"])
        return fb.with_planes(y=y, u=u, v=v), state
