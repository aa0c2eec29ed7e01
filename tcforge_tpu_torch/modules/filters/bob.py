"""doublefps + smartbob — the field-rate (bob) pipeline, in plain torch.

The port of ``tcforge_tpu/modules/filters/bob.py`` (``filter_doublefps.c``
and ``filter_smartbob.c``):

- doublefps splits each interlaced frame into its two fields, as
  half-height frames at twice the rate: a reshape of (N, H, W) into
  (2N, H/2, W), each frame id twice, the second of each pair marked
  ``ATTR_WAS_CLONED``.  It sets the job's export rate to twice the
  input's, which the Y4M header shows.  ``fullheight`` instead emits
  full frames [curr's first field woven with prev's second, curr], with
  the previous frame's luma carried.
- smartbob rebuilds full-height frames from field frames: the field's
  lines pass through; a missing line is interpolated (cubic, linear at
  the edges) where the motion test against the previous field fires,
  ``(luma - p)(luma_below - p) >= threshold^2`` with luma = (55r + 182g
  + 19b) >> 8, and woven from the previous field where it does not.

smartbob's previous field is the previous *input* field, so the batch
is computed at once against itself shifted by one, with the carried
field in front (the JAX filter scans frame by frame).

The classic chain is ``-J doublefps,smartbob`` (29.97i -> 59.94p).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Tuple

import torch

from tcforge_tpu_torch.core.formats import ImageFormat
from tcforge_tpu_torch.core.frame import ATTR_WAS_CLONED, FrameBatch
from tcforge_tpu_torch.core.optstr import ModuleDesc, ParamSpec
from tcforge_tpu_torch.modules.filters.smartdeinter import (box5_sum, dilate5,
                                                           shifted_by_one)
from tcforge_tpu_torch.modules.registry import (FilterSlot, ModuleInfo,
                                                ModuleKind, VideoFilter,
                                                register)
from tcforge_tpu_torch.ops import colorspace

_log = logging.getLogger("tcforge_tpu_torch")


def paired_attrs(fb: FrameBatch) -> torch.Tensor:
    """Each frame's attrs twice, the second copy ``ATTR_WAS_CLONED``."""
    attrs = (fb.attrs if fb.attrs is not None else torch.zeros(
        (fb.batch,), dtype=torch.int32, device=fb.device))
    attrs = torch.repeat_interleave(attrs, 2)
    attrs[1::2] |= ATTR_WAS_CLONED
    return attrs


def _repeat_ids(fb: FrameBatch, times: int):
    return (torch.repeat_interleave(fb.frame_ids, times)
            if fb.frame_ids is not None else None)


@register
class DoubleFpsFilter(VideoFilter):
    info = ModuleInfo(name="doublefps", kind=ModuleKind.FILTER)
    desc = ModuleDesc(
        name="doublefps", comment="double fps by field splitting",
        capabilities="VYE",
        params=[ParamSpec("topfirst", "top field first (-1: 480-line "
                          "video 0, else 1)", "d", -1, -1, 1),
                ParamSpec("shiftEven", "obsolete alias of topfirst",
                          "d", -1, -1, 1),
                ParamSpec("fullheight", "keep full height: frames = "
                          "fields 0+1, 1+2, ...", "d", 0, 0, 1)])
    slots = FilterSlot.PRE_S

    def __init__(self, job, options: str = ""):
        super().__init__(job, options)
        if job.ex_fps <= 0:
            job.ex_fps = job.fps * 2     # the output runs at field rate

    def _topfirst(self, height: int) -> bool:
        """doublefps_configure:138-150: topfirst, else shiftEven
        (obsolete, warns), else top first unless 480 lines high."""
        if self.options["topfirst"] >= 0:
            return bool(self.options["topfirst"])
        if self.options["shiftEven"] >= 0:
            _log.warning('doublefps: The "shiftEven" option name is '
                         'obsolete; please use "topfirst" instead.')
            return bool(self.options["shiftEven"])
        return height != 480

    def init_state(self, width: int, height: int, fmt: ImageFormat,
                   device: torch.device) -> Any:
        if not self.options["fullheight"]:
            return None
        return {"prev_y": torch.zeros((height, width), dtype=torch.int32,
                                      device=device),
                "first": True}

    def output_size(self, width: int, height: int) -> Tuple[int, int]:
        if self.options["fullheight"]:
            return width, height
        return width, height // 2

    def _apply_fullheight(self, fb: FrameBatch, state):
        """filter_doublefps.c case 2/3: frame pairs [merge(curr's first
        field, prev's second field), curr]; only Y is woven, the chroma
        rides the current frame (lines 368-379)."""
        y = fb.y.to(torch.int32)
        prev = shifted_by_one(state["prev_y"], y)
        top, bottom = (y, prev) if self._topfirst(fb.height) else (prev, y)
        merged = y.clone()
        merged[:, 0::2] = top[:, 0::2]
        merged[:, 1::2] = bottom[:, 1::2]
        if state["first"]:
            merged[0] = y[0]
        pair_y = torch.stack([merged, y], 1).reshape(
            (2 * fb.batch,) + tuple(y.shape[1:]))
        out = fb.with_planes(y=pair_y.to(fb.y.dtype),
                             u=torch.repeat_interleave(fb.u, 2, dim=0),
                             v=torch.repeat_interleave(fb.v, 2, dim=0))
        out = dataclasses.replace(out, attrs=paired_attrs(fb),
                                  frame_ids=_repeat_ids(fb, 2),
                                  fps=fb.fps * 2)
        return out, dict(state, prev_y=y[-1], first=False)

    def apply(self, fb: FrameBatch, state: Any) -> Tuple[FrameBatch, Any]:
        if self.options["fullheight"]:
            if fb.y is None:
                raise ValueError("doublefps fullheight: YUV only")
            return self._apply_fullheight(fb, state)
        top_first = self._topfirst(fb.height)
        n = fb.batch

        def split(plane):
            # (N, H, W, ...) -> (2N, H/2, W, ...): each frame's first
            # field, then its second
            first = plane[:, 0::2] if top_first else plane[:, 1::2]
            second = plane[:, 1::2] if top_first else plane[:, 0::2]
            both = torch.stack([first, second], dim=1)
            return both.reshape((2 * n,) + tuple(both.shape[2:]))

        planes = ({"rgb": split(fb.rgb)} if fb.rgb is not None else
                  {"y": split(fb.y), "u": split(fb.u), "v": split(fb.v)})
        return FrameBatch(format=fb.format, attrs=paired_attrs(fb),
                          frame_ids=_repeat_ids(fb, 2), fps=fb.fps * 2,
                          **planes), state


def _bob_luma(p: torch.Tensor) -> torch.Tensor:
    return (55 * p[..., 0] + 182 * p[..., 1] + 19 * p[..., 2]) >> 8


def smartbob_fields(rgb_fields: torch.Tensor, was_cloned: torch.Tensor,
                    prev_field: torch.Tensor, threshold: int,
                    shift_even: bool, denoise: bool
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(M, h, W, 3) uint8 field frames -> (M, 2h, W, 3) full frames and
    the new carry.  ``was_cloned``: each frame's WAS_CLONED flag (its
    field parity); ``prev_field``: the (h, W, 3) int32 field before the
    batch (the reference's prevFrame buffer)."""
    src = rgb_fields.to(torch.int32)
    m, h, w = src.shape[:3]
    prev = shifted_by_one(prev_field, src)
    # the frames whose field lands on the odd lines
    shift_up = (was_cloned.to(torch.int32)
                == (0 if shift_even else 1)).view(m, 1, 1)

    prev_l = _bob_luma(prev)
    prev_cmp = torch.where(shift_up, torch.roll(prev_l, -1, dims=1), prev_l)
    cur_l = _bob_luma(src)
    if threshold == 0:
        moving = torch.ones((m, h, w), dtype=torch.bool, device=src.device)
    else:
        moving = ((cur_l - prev_cmp)
                  * (torch.roll(cur_l, -1, dims=1) - prev_cmp)
                  >= threshold * threshold)
        moving[:, h - 1] = False
        if denoise:
            moving = dilate5(moving & (box5_sum(moving.to(torch.int32)) > 9))

    nxt = torch.roll(src, -1, dims=1)
    lin = (src + nxt) >> 1
    cub = ((5 * (src + nxt) - (torch.roll(src, 1, dims=1)
                               + torch.roll(src, -2, dims=1))) >> 3
           ).clamp_(0, 255)
    rows = torch.arange(h, device=src.device)
    use_lin = ((rows == 0) | (rows == h - 2)).view(h, 1, 1)
    interp = torch.where(use_lin, lin, cub)
    shift_up = shift_up[..., None]
    prev_shift = torch.where(shift_up, torch.roll(prev, -1, dims=1), prev)
    synth = torch.where(moving[..., None], interp, prev_shift)

    # interleave: the field's lines and the synthesized ones, the field
    # on the odd lines where shift_up
    woven = torch.where(shift_up[..., None], torch.stack([synth, src], 2),
                        torch.stack([src, synth], 2))
    out = woven.reshape(m, 2 * h, w, 3)
    return out.to(torch.uint8), src[-1]


@register
class SmartBobFilter(VideoFilter):
    info = ModuleInfo(name="smartbob", kind=ModuleKind.FILTER)
    desc = ModuleDesc(
        name="smartbob", comment="motion-adaptive bob doubler",
        version="1.1", capabilities="VRY",
        params=[ParamSpec("threshold", "motion threshold", "d", 12, 0, 255),
                ParamSpec("denoise", "motion map denoising", "d", 0, 0, 1),
                ParamSpec("shiftEven", "shift even field frames", "d", 0,
                          0, 1),
                ParamSpec("motionOnly", "show motion areas", "d", 0, 0, 1)])
    slots = FilterSlot.POST_S

    def init_state(self, width: int, height: int, fmt: ImageFormat,
                   device: torch.device) -> Any:
        # height here is the field height (after doublefps)
        return torch.zeros((height, width, 3), dtype=torch.int32,
                           device=device)

    def output_size(self, width: int, height: int) -> Tuple[int, int]:
        return width, height * 2

    def apply(self, fb: FrameBatch, state: Any) -> Tuple[FrameBatch, Any]:
        was_yuv = fb.rgb is None
        work = colorspace.convert(fb, ImageFormat.RGB24) if was_yuv else fb
        cloned = ((fb.attrs & ATTR_WAS_CLONED) != 0 if fb.attrs is not None
                  else torch.zeros((fb.batch,), dtype=torch.bool,
                                   device=fb.device))
        out_rgb, new_state = smartbob_fields(
            work.rgb[..., :3], cloned, state, self.options["threshold"],
            bool(self.options["shiftEven"]), bool(self.options["denoise"]))
        out = FrameBatch(format=ImageFormat.RGB24, rgb=out_rgb,
                         attrs=fb.attrs, frame_ids=fb.frame_ids, fps=fb.fps)
        if was_yuv:
            out = colorspace.convert(out, fb.format)
        return out, new_state
