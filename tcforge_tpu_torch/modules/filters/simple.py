"""Simple filters: invert, levels, deinterlace, mask, testframe,
compare, null.

The port of ``tcforge_tpu/modules/filters/simple.py`` (analogues of
``filter_invert.c``, ``filter_levels.c``, ``filter_mask.c``,
``filter_testframe.c``, ``filter_compare.c``, ``filter_null.c``), in
plain torch.  ``compare`` reads its pattern through the port's copy of
``io/image.py`` and resizes it with the port's zoom.
"""

from __future__ import annotations

from typing import Any, Tuple

import numpy as np
import torch

from tcforge_tpu_torch.core.formats import ImageFormat
from tcforge_tpu_torch.core.frame import FrameBatch
from tcforge_tpu_torch.core.optstr import ModuleDesc, ParamSpec
from tcforge_tpu_torch.modules.registry import (FilterSlot, ModuleInfo,
                                                ModuleKind, VideoFilter,
                                                register)
from tcforge_tpu_torch.ops import colorspace, video, zoom


@register
class InvertFilter(VideoFilter):
    """filter_invert.c: 255 - value on every plane."""

    info = ModuleInfo(name="invert", kind=ModuleKind.FILTER)
    desc = ModuleDesc(name="invert", comment="invert the image",
                      params=[ParamSpec("range", "apply to frames start-end",
                                        "s", "")])
    slots = FilterSlot.PRE_M

    def apply(self, fb: FrameBatch, state: Any) -> Tuple[FrameBatch, Any]:
        if fb.rgb is not None:
            return fb.with_planes(rgb=255 - fb.rgb), state
        return fb.with_planes(
            y=255 - fb.y, u=(255 - fb.u) if fb.u is not None else None,
            v=(255 - fb.v) if fb.v is not None else None), state


@register
class LevelsFilter(VideoFilter):
    """filter_levels.c: map luma [in_lo, in_hi] with a gamma onto
    [out_lo, out_hi] through a 256-entry table (float64 on the host)."""

    info = ModuleInfo(name="levels", kind=ModuleKind.FILTER)
    desc = ModuleDesc(
        name="levels", comment="luma levels correction",
        params=[ParamSpec("input", "input range lo-hi", "s", "0-255"),
                ParamSpec("gamma", "gamma", "f", 1.0, 0.01, 10.0),
                ParamSpec("output", "output range lo-hi", "s", "0-255"),
                ParamSpec("pre", "run as pre-processing filter", "d",
                          0, 0, 1)])
    slots = FilterSlot.POST_M

    def __init__(self, job, options: str = ""):
        super().__init__(job, options)
        if self.options["pre"]:
            self.slots = FilterSlot.PRE_M
        in_lo, in_hi = self._parse_range(self.options["input"], 0, 255)
        out_lo, out_hi = self._parse_range(self.options["output"], 0, 255)
        i = np.arange(256, dtype=np.float64)
        t = np.clip((i - in_lo) / max(1e-9, in_hi - in_lo), 0.0, 1.0)
        lut = out_lo + np.power(t, 1.0 / self.options["gamma"]) * (
            out_hi - out_lo)
        self._lut = torch.from_numpy(
            np.clip(lut + 0.5, 0, 255).astype(np.uint8))

    @staticmethod
    def _parse_range(s: str, lo: int, hi: int):
        if "-" in s:
            a, b = s.split("-", 1)
            return int(a), int(b)
        return lo, hi

    def apply(self, fb: FrameBatch, state: Any) -> Tuple[FrameBatch, Any]:
        lut = self._lut.to(fb.device)
        return fb.with_planes(y=lut[fb.y.long()]), state


@register
class DeinterlaceFilter(VideoFilter):
    """``-J deinterlace``: the shape-keeping tcv_deinterlace modes
    (interpolate, linear blend) of ``-I 1`` and ``-I 5`` as a filter; on
    YUV the luma only, on RGB every channel."""

    info = ModuleInfo(name="deinterlace", kind=ModuleKind.FILTER)
    desc = ModuleDesc(
        name="deinterlace", comment="deinterlace (interpolate or "
        "linear blend, tcv_deinterlace modes)",
        params=[ParamSpec("mode", "interpolate|linear_blend", "s",
                          "interpolate")])
    slots = FilterSlot.PRE_M

    def __init__(self, job, options: str = ""):
        super().__init__(job, options)
        mode = str(self.options["mode"])
        if mode not in ("interpolate", "linear_blend"):
            raise ValueError(
                f"deinterlace: unknown mode {mode!r} (use "
                "interpolate|linear_blend; field dropping is -I 3/4)")
        self._fn = (video.deint_interpolate if mode == "interpolate"
                    else video.deint_linear_blend)

    def apply(self, fb: FrameBatch, state: Any) -> Tuple[FrameBatch, Any]:
        if fb.rgb is not None:
            out = self._fn(torch.movedim(fb.rgb, -1, 1))
            return fb.with_planes(
                rgb=torch.movedim(out, 1, -1).contiguous()), state
        return fb.with_planes(y=self._fn(fb.y)), state


@register
class MaskFilter(VideoFilter):
    """filter_mask.c: black out everything outside a rectangle."""

    info = ModuleInfo(name="mask", kind=ModuleKind.FILTER)
    desc = ModuleDesc(
        name="mask", comment="rectangular mask",
        params=[ParamSpec("lefttop", "left-top corner", "dxd", (0, 0)),
                ParamSpec("rightbot", "right-bottom corner", "dxd",
                          (0, 0))])
    slots = FilterSlot.POST_M

    def apply(self, fb: FrameBatch, state: Any) -> Tuple[FrameBatch, Any]:
        l, t = self.options["lefttop"]
        r, b = self.options["rightbot"]
        h, w = fb.height, fb.width
        if (r, b) == (0, 0):
            r, b = w, h

        def inside(sh, sw, fy, fx):
            yy = torch.arange(sh, device=fb.device).view(-1, 1) * fy
            xx = torch.arange(sw, device=fb.device).view(1, -1) * fx
            return (yy >= t) & (yy < b) & (xx >= l) & (xx < r)

        y = torch.where(inside(h, w, 1, 1), fb.y,
                        torch.tensor(16, dtype=torch.uint8, device=fb.device))
        if fb.u is None:
            return fb.with_planes(y=y), state
        sh, sw = fb.u.shape[-2:]
        cin = inside(sh, sw, h // sh, w // sw)
        neutral = torch.tensor(128, dtype=torch.uint8, device=fb.device)
        return fb.with_planes(y=y, u=torch.where(cin, fb.u, neutral),
                              v=torch.where(cin, fb.v, neutral)), state


@register
class TestFrameFilter(VideoFilter):
    """filter_testframe.c: replace content with a test pattern."""

    info = ModuleInfo(name="testframe", kind=ModuleKind.FILTER)
    desc = ModuleDesc(
        name="testframe", comment="generate test pattern frames",
        params=[ParamSpec("mode", "0=ramp 1=checker 2=grid", "d", 0, 0, 2)])
    slots = FilterSlot.PRE_M

    def apply(self, fb: FrameBatch, state: Any) -> Tuple[FrameBatch, Any]:
        mode = self.options["mode"]
        h, w = fb.height, fb.width
        yy = torch.arange(h, device=fb.device).view(-1, 1)
        xx = torch.arange(w, device=fb.device).view(1, -1)
        if mode == 0:
            pat = ((xx * 255) // max(1, w - 1)).expand(h, w)
        elif mode == 1:
            pat = ((yy // 8 + xx // 8) % 2) * 219 + 16
        else:
            pat = torch.where((yy % 16 == 0) | (xx % 16 == 0), 235, 16)
        y = pat.to(torch.uint8).expand(fb.y.shape).contiguous()
        return fb.with_planes(
            y=y, u=torch.full_like(fb.u, 128) if fb.u is not None else None,
            v=torch.full_like(fb.v, 128) if fb.v is not None else None), state


@register
class CompareFilter(VideoFilter):
    """filter_compare.c: find a pattern image in the video.

    The pattern is Gaussian-resized to the frame size (``zoom_plane``,
    the zoom kernel on the card; compare_setup_pattern:180-195) and its
    fully opaque pixels (alpha 255) form the mask.  Per frame, the mean
    absolute difference of each RGB channel over the mask, a float32 sum
    over the float32 pixel count, is held against ``delta`` (default
    45.0), and ``collect`` appends '1' (a match) or 'n' to the results
    file after a ``#fps:`` header (compare_filter_video:406-440);
    ``finalize`` closes it.  ``flip`` mirrors the pattern, ``rgbswap``
    swaps R and B.  YUV sessions compare luma only.

    The jitted JAX filter divides by the count, a constant of the trace,
    which XLA compiles to a product with its float32 reciprocal; the
    port computes that.  The sums are of integers, exact in float32 up
    to 2^24 (a 128x72 frame and more), and exact in int64 here.
    """

    info = ModuleInfo(name="compare", kind=ModuleKind.FILTER)
    desc = ModuleDesc(
        name="compare", comment="compare with other image to find "
        "a pattern",
        params=[ParamSpec("pattern", "pattern image file path", "s",
                          "compare.png"),
                ParamSpec("results", "results file path", "s",
                          "compare.log"),
                ParamSpec("delta", "delta error allowed", "f", 45.0,
                          0.0, 100.0),
                ParamSpec("rgbswap", "swap R/B in the pattern", "d",
                          0, 0, 1),
                ParamSpec("flip", "mirror the pattern", "d", 0, 0, 1)])
    slots = FilterSlot.POST_S

    def __init__(self, job, options: str = ""):
        super().__init__(job, options)
        self._pattern = None
        self._results = None

    def _setup(self, width: int, height: int, device: torch.device):
        from tcforge_tpu_torch.io.image import read_image
        img = read_image(self.options["pattern"], keep_alpha=True)
        if self.options["flip"]:
            img = np.flip(img, axis=0)
        if self.options["rgbswap"]:
            img = img[..., [2, 1, 0, 3]]
        planes = torch.from_numpy(
            np.ascontiguousarray(np.moveaxis(img, -1, 0))).to(device)
        rs = zoom.zoom_plane(planes, width, height, "gaussian")
        mask = rs[3] == 255                 # GM opacity == 0
        count = int(mask.sum())
        if not count:
            mask = torch.ones_like(mask)
            count = height * width
        self._pattern = (rs[:3].to(torch.int32), mask,
                         float(np.float32(1) / np.float32(count)))

    def init_state(self, width: int, height: int, fmt: ImageFormat,
                   device: torch.device) -> Any:
        self._setup(width, height, device)
        return {"match": torch.full((1,), -1, dtype=torch.int32,
                                    device=device)}

    def apply(self, fb: FrameBatch, state: Any) -> Tuple[FrameBatch, Any]:
        pat, mask, inv = self._pattern
        delta = float(np.float32(self.options["delta"]))

        def mean_diff(plane, ref):
            d = (plane.to(torch.int32) - ref).abs()
            total = torch.where(mask[None], d, 0).sum(dim=(1, 2))
            return total.to(torch.float32) * inv

        if fb.rgb is not None:
            ok = None
            for c in range(3):
                good = mean_diff(fb.rgb[..., c], pat[c]) < delta
                ok = good if ok is None else ok & good
        else:
            py, _, _ = colorspace.rgb_to_yuv_pixels(torch.movedim(pat, 0, -1))
            ok = mean_diff(fb.y, py) < delta
        return fb, {"match": ok.to(torch.int32)}

    def collect(self, state: Any) -> None:
        if self._results is None:
            self._results = open(self.options["results"], "w")
            self._results.write(f"#fps:{self.job.fps:f}\n")
        for v in state["match"].cpu().numpy():
            if v >= 0:
                self._results.write("1" if v else "n")
        self._results.flush()

    def finalize(self, state: Any) -> None:
        if self._results is not None:
            self._results.close()
            self._results = None


@register
class NullFilter(VideoFilter):
    """filter_null.c: do nothing (chain and bench scaffolding)."""

    info = ModuleInfo(name="null", kind=ModuleKind.FILTER)
    desc = ModuleDesc(name="null", comment="no-op filter")
    slots = FilterSlot.POST_M

    def apply(self, fb: FrameBatch, state: Any) -> Tuple[FrameBatch, Any]:
        return fb, state
