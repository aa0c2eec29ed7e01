"""smartdeinter — motion-adaptive deinterlacing, in plain torch.

The port of ``tcforge_tpu/modules/filters/smartdeinter.py`` (Donald
Graft's ``filter_smartdeinter.c``): a per-pixel motion map against the
previous frame (luma proxy ``(76r + 150g + 30b) >> 8`` or, under
``colordiff``, each channel; frame, field or both modes), the
scene-change override, the optional 5x5 erode and dilate of the map
(``highq``), then the odd lines of moving areas replaced by linear
``(above + below) / 2`` or cubic ``(5(p + n) - (pp + nn)) >> 3``
interpolation, or every line field-blended ``p/2 + above/4 + below/4``
(``Blend``).  The work is done in RGB through the exact colour
conversions, as the JAX filter does.

The JAX filter scans the frames one by one (``lax.scan``), but a frame
refers only to the previous *input* frame: its luma (or RGB) after the
phase shift, and its kept field (``saved``).  So the whole batch is
computed at once, against the batch shifted by one with the carry in
front.  ``torch.roll`` keeps ``jnp.roll``'s wrap-around; the border and
interior masks hide the wrapped rows.

The carry is ``(prev, saved, first)``: ``prev`` int32 (H, W) luma or
(H, W, 3) RGB, ``saved`` the (H/2, W, 3) int32 kept field, and
``first`` a Python bool, true only before the stream's first frame.
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
from tcforge_tpu_torch.ops import colorspace

FRAME_ONLY, FIELD_ONLY, FRAME_AND_FIELD = 0, 1, 2


def _luma(rgb: torch.Tensor) -> torch.Tensor:
    """(76r + 150g + 30b) >> 8 (filter_smartdeinter.c:573)."""
    return (76 * rgb[..., 0] + 150 * rgb[..., 1] + 30 * rgb[..., 2]) >> 8


def _window5(m: torch.Tensor, combine) -> torch.Tensor:
    """``combine`` over the 5x5 window of every element of (..., H, W),
    zero beyond the edges; separable, so exact for sums and for ORs."""
    h, w = m.shape[-2:]
    p = torch.nn.functional.pad(m, (2, 2, 2, 2))
    rows = p[..., 0:h, :]
    for d in range(1, 5):
        rows = combine(rows, p[..., d:d + h, :])
    out = rows[..., 0:w]
    for d in range(1, 5):
        out = combine(out, rows[..., d:d + w])
    return out


def box5_sum(m: torch.Tensor) -> torch.Tensor:
    """The 5x5 box sum over (..., H, W) int32, zero-padded (the erode
    window of smartdeinter and smartbob)."""
    return _window5(m, torch.add)


def dilate5(m: torch.Tensor) -> torch.Tensor:
    """The 5x5 OR of a (..., H, W) bool map, zero-padded."""
    return _window5(m, torch.bitwise_or)


def shifted_by_one(first: torch.Tensor, seq: torch.Tensor) -> torch.Tensor:
    """``first`` followed by ``seq`` without its last element: what each
    frame of a batch sees as its predecessor (smartdeinter, doublefps,
    smartbob)."""
    return torch.cat([first[None], seq[:-1]])


def _phase_shift(src, saved, first, field_shift, inswap, outswap):
    """Advanced processing (filter_smartdeinter.c:365-515) on a (N, H, W,
    C) batch: the optional field swap and the one-field phase shift with
    a carried field.  Returns the shifted batch and the new ``saved``."""
    even, odd = src[:, 0::2], src[:, 1::2]
    if not field_shift:
        if inswap != outswap:               # a single swap: swap fields
            even, odd = odd, even
        new_saved = saved                   # two swaps or none: no-op
    else:
        case = (1 if inswap else 0) | (2 if outswap else 0)
        # (the field kept for the next frame, the field in place, the
        # first frame's stand-in for the carried one)
        keep, stay = {0: (odd, even), 1: (even, odd), 2: (odd, even),
                      3: (even, odd)}[case]
        carried = shifted_by_one(saved, keep)
        if first:
            carried = torch.cat([stay[:1], carried[1:]])
        if case in (0, 1):
            even, odd = carried, stay
        else:
            even, odd = stay, carried
        new_saved = keep[-1]
    n, h2, w, c = even.shape
    out = torch.stack([even, odd], dim=2).reshape(n, 2 * h2, w, c)
    return out, new_saved


def smartdeinter_rgb(rgb: torch.Tensor, state, threshold: int,
                     scenethreshold: int, diffmode: int, highq: bool,
                     blend: bool, cubic: bool, motion_only: bool,
                     colordiff: bool = False, field_shift: bool = False,
                     inswap: bool = False, outswap: bool = False,
                     no_motion: bool = False):
    """(N, H, W, C) uint8 + carry -> (output, new carry), the JAX
    function's arithmetic over the whole batch at once."""
    prev, saved, first = state
    src = rgb.to(torch.int32)
    n, h, w = src.shape[:3]
    advanced = field_shift or inswap or outswap
    if advanced:
        src, saved = _phase_shift(src, saved, first, field_shift, inswap,
                                  outswap)
    luma = _luma(src) if src.shape[-1] == 3 else src[..., 0]
    ref = src if colordiff else luma
    new_state = (ref[-1], saved, False)
    if no_motion and advanced:
        return src.to(torch.uint8), new_state
    prev_all = shifted_by_one(prev, ref)

    def over(x):
        """A per-pixel test: under colordiff, true where any channel's is."""
        return x.any(dim=-1) if colordiff else x

    fr = over((ref - prev_all).abs() > threshold)
    if diffmode == FRAME_AND_FIELD:
        odd_rows = (torch.arange(h, device=src.device) & 1).bool()
        odd_rows = odd_rows.view(h, 1, 1) if colordiff else odd_rows.view(h, 1)
        field_ref = torch.where(odd_rows, torch.roll(ref, 1, dims=1),
                                torch.roll(prev_all, -1, dims=1))
        moving = fr & over((ref - field_ref).abs() > threshold)
    elif diffmode == FIELD_ONLY:
        moving = over((torch.roll(ref, 1, dims=1) - ref)
                      * (torch.roll(ref, -1, dims=1) - ref)
                      > threshold * threshold)
    else:
        moving = fr
    moving[:, 0] = False                    # the borders get a free ride
    moving[:, h - 1] = False

    count = moving.sum(dim=(1, 2), dtype=torch.int32)
    scenechange = ((100 * count) // (h * w) >= scenethreshold).view(n, 1, 1)
    if highq:
        eroded = moving & (box5_sum(moving.to(torch.int32)) > 9)
        moving = torch.where(scenechange, moving, dilate5(eroded))
    any_m = (moving | torch.roll(moving, 1, dims=1)
             | torch.roll(moving, -1, dims=1) | scenechange)

    rows = torch.arange(h, device=src.device)
    interior = ((rows > 0) & (rows < h - 1)).view(h, 1, 1)
    srcm = torch.roll(src, 1, dims=1)       # the line above
    srcp = torch.roll(src, -1, dims=1)      # the line below
    if blend:
        moving_val = src // 2 + srcm // 4 + srcp // 4
    else:
        moving_val = srcm // 2 + srcp // 2
        if cubic:
            cub = ((5 * (srcm + srcp) - (torch.roll(src, 3, dims=1)
                                         + torch.roll(src, -3, dims=1)))
                   >> 3).clamp_(0, 255)
            cubic_ok = ((rows > 2) & (rows < h - 3)).view(h, 1, 1)
            moving_val = torch.where(cubic_ok, cub, moving_val)
        odd = (rows & 1).bool().view(h, 1, 1)
        moving_val = torch.where(odd, moving_val, src)
    still = torch.full_like(src, 0x7F) if motion_only else src
    out = torch.where((any_m[..., None] & interior), moving_val,
                      torch.where(interior, still, src))
    return out.to(torch.uint8), new_state


@register
class SmartDeinterFilter(VideoFilter):
    info = ModuleInfo(name="smartdeinter", kind=ModuleKind.FILTER)
    desc = ModuleDesc(
        name="smartdeinter", comment="motion-adaptive deinterlacing",
        version="2.7", capabilities="VRY",
        params=[
            ParamSpec("threshold", "motion threshold", "d", 15, 0, 255),
            ParamSpec("scenethreshold", "scene change threshold %", "d",
                      100, 0, 255),
            ParamSpec("diffmode", "0=frame 1=field 2=both", "d", 0, 0, 2),
            ParamSpec("highq", "motion map denoising", "d", 1, 0, 1),
            ParamSpec("Blend", "blend instead of interpolate", "d", 0, 0,
                      1),
            ParamSpec("cubic", "cubic interpolation", "d", 0, 0, 1),
            ParamSpec("motionOnly", "show motion areas only", "d", 0, 0,
                      1),
            ParamSpec("colordiff", "compare color channels instead of "
                      "luma", "d", 1, 0, 1),
            ParamSpec("fieldShift", "phase shift by one field", "d", 0,
                      0, 1),
            ParamSpec("inswap", "field swap before phase shift", "d",
                      0, 0, 1),
            ParamSpec("outswap", "field swap after phase shift", "d",
                      0, 0, 1),
            ParamSpec("noMotion", "disable motion processing", "d", 0,
                      0, 1)])
    slots = FilterSlot.PRE_M

    def init_state(self, width: int, height: int, fmt: ImageFormat,
                   device: torch.device) -> Any:
        shape = ((height, width, 3) if self.options["colordiff"]
                 else (height, width))
        return (torch.zeros(shape, dtype=torch.int32, device=device),
                torch.zeros((height // 2, width, 3), dtype=torch.int32,
                            device=device),
                True)

    def apply(self, fb: FrameBatch, state: Any) -> Tuple[FrameBatch, Any]:
        o = self.options
        was_yuv = fb.rgb is None
        work = colorspace.convert(fb, ImageFormat.RGB24) if was_yuv else fb
        out_rgb, new_state = smartdeinter_rgb(
            work.rgb[..., :3], state, o["threshold"], o["scenethreshold"],
            o["diffmode"], bool(o["highq"]), bool(o["Blend"]),
            bool(o["cubic"]), bool(o["motionOnly"]),
            colordiff=bool(o["colordiff"]),
            field_shift=bool(o["fieldShift"]), inswap=bool(o["inswap"]),
            outswap=bool(o["outswap"]), no_motion=bool(o["noMotion"]))
        out = work.with_planes(rgb=out_rgb)
        if was_yuv:
            out = colorspace.convert(out, fb.format)
        return out, new_state
