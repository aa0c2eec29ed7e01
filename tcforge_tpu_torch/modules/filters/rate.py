"""Frame-rate filters fps, skip and slowmo, in plain torch.

The port of ``tcforge_tpu/modules/filters/rate.py``:

- fps (``filter_fps.c``): converts the rate by dropping (in > out) or
  cloning (in < out) frames on a Bresenham-style schedule, evaluated
  per frame id: a dropped frame is marked SKIPPED, a cloned one is
  emitted as ``dup`` copies with the extra ones SKIPPED.  The schedule
  is the JAX filter's float32 recurrence on ``frame_ids + 1``, computed
  in float32 tensors.
- skip (``filter_skip.c``): marks frame-id ranges SKIPPED.
- slowmo (``filter_slowmo.c``): emits every frame ``factor`` times.

The engine selects the frames to write by the output batch's ids and
attrs, so a rate change is a change of attrs and batch length here.
"""

from __future__ import annotations

import math
from typing import Any, Tuple

import numpy as np
import torch

from tcforge_tpu_torch.core.frame import (ATTR_SKIPPED, ATTR_WAS_CLONED,
                                          FrameBatch)
from tcforge_tpu_torch.core.framecode import parse_ranges
from tcforge_tpu_torch.core.optstr import ModuleDesc, ParamSpec
from tcforge_tpu_torch.modules.registry import (FilterSlot, ModuleInfo,
                                                ModuleKind, VideoFilter,
                                                register)


def _attrs(fb: FrameBatch) -> torch.Tensor:
    return (fb.attrs if fb.attrs is not None else torch.zeros(
        (fb.batch,), dtype=torch.int32, device=fb.device))


def dup_batch(fb: FrameBatch, dup: int, keep_counts: torch.Tensor,
              fps: float) -> FrameBatch:
    """Every frame ``dup`` times; copy j of frame i survives when j <
    ``keep_counts[i]`` (the others SKIPPED); copies after the first
    carry WAS_CLONED."""
    def rep(t):
        return None if t is None else torch.repeat_interleave(t, dup, dim=0)

    j = torch.arange(dup, device=fb.device).repeat(fb.batch)
    attrs = rep(_attrs(fb))
    attrs = torch.where(j < rep(keep_counts), attrs, attrs | ATTR_SKIPPED)
    attrs = torch.where(j > 0, attrs | ATTR_WAS_CLONED, attrs)
    return FrameBatch(format=fb.format, y=rep(fb.y), u=rep(fb.u),
                      v=rep(fb.v), rgb=rep(fb.rgb), attrs=attrs,
                      frame_ids=rep(fb.frame_ids), fps=fps)


def _f32(x: float) -> float:
    """``x`` rounded to float32 (the JAX filters' weakly typed Python
    constants meet float32 arrays in float32)."""
    return float(np.float32(x))


@register
class FpsFilter(VideoFilter):
    info = ModuleInfo(name="fps", kind=ModuleKind.FILTER)
    desc = ModuleDesc(
        name="fps", comment="convert frame rate by cloning/skipping",
        capabilities="VRYEO",
        params=[ParamSpec("infps", "input fps (0 = probe)", "f", 0.0, 0.0,
                          1000.0),
                ParamSpec("outfps", "output fps (0 = export fps)", "f",
                          0.0, 0.0, 1000.0),
                ParamSpec("pre", "run pre (default: auto)", "d", -1, -1,
                          1)])
    slots = FilterSlot.PRE_S

    def __init__(self, job, options: str = ""):
        # the legacy "25:29.97" positional syntax
        if options and "=" not in options and ":" in options:
            a, b = options.split(":")[:2]
            options = f"infps={a}:outfps={b}"
        super().__init__(job, options)
        self.infps = self.options["infps"] or job.fps
        self.outfps = self.options["outfps"] or job.out_fps
        if job.ex_fps <= 0 and self.outfps != self.infps:
            job.ex_fps = self.outfps
        # pre for decreasing rates, post for increasing (filter_fps.c)
        pre = self.options["pre"]
        if pre == -1:
            pre = 1 if self.infps > self.outfps else 0
        self.slots = FilterSlot.PRE_S if pre else FilterSlot.POST_S
        r = self.outfps / self.infps if self.infps else 1.0
        self._ratio = r
        self._dup = max(1, math.ceil(r)) if r > 1 else 1

    def apply(self, fb: FrameBatch, state: Any) -> Tuple[FrameBatch, Any]:
        r = self._ratio
        if r == 1.0:
            return fb, state
        r32 = _f32(r)
        k = fb.frame_ids.to(torch.float32) + 1     # 1-based framesin
        if r < 1.0:
            # drop: kept iff ceil(k*r) > ceil((k-1)*r)
            kept = torch.ceil(k * r32) > torch.ceil((k - 1) * r32)
            attrs = _attrs(fb)
            return fb.with_attrs(torch.where(kept, attrs,
                                             attrs | ATTR_SKIPPED)), state

        # clone: copies(k) = fo(k) - fo(k-1), fo(k) = strict_floor(k*r)+1
        def fo(kk):
            return torch.where(kk <= 0, 0.0, torch.ceil(kk * r32))

        copies = (fo(k) - fo(k - 1)).to(torch.int32)
        return dup_batch(fb, self._dup, copies, self.outfps), state


@register
class SkipFilter(VideoFilter):
    """filter_skip.c: drop framecode ranges (``start-end[/step]``, times
    ``[[H:]M:]S[.F]`` allowed, space- or comma-separated)."""

    info = ModuleInfo(name="skip", kind=ModuleKind.FILTER)
    desc = ModuleDesc(
        name="skip", comment="skip frame ranges",
        params=[ParamSpec("start-end/step [...]", "Skip frames", "s", ""),
                ParamSpec("ranges", "ranges a-b[/s],c-d (frame ids)",
                          "s", "")])
    slots = FilterSlot.PRE_S

    def __init__(self, job, options: str = ""):
        # the legacy whole-optstring form: skip=10-20,50-60
        if options and "=" not in options:
            options = f"ranges={options}"
        super().__init__(job, options)
        txt = (self.options["ranges"]
               or self.options["start-end/step [...]"] or "")
        fps = getattr(job, "fps", 25.0) or 25.0
        sep = "," if "," in txt else " "
        self._ranges = (parse_ranges(txt, fps, sep).ranges if txt.strip()
                        else [])

    def apply(self, fb: FrameBatch, state: Any) -> Tuple[FrameBatch, Any]:
        if not self._ranges:
            return fb, state
        ids = fb.frame_ids
        skip = torch.zeros((fb.batch,), dtype=torch.bool, device=fb.device)
        for r in self._ranges:
            skip |= ((ids >= r.stf) & (ids < r.etf)
                     & ((ids - r.stf) % r.stepf == 0))
        attrs = _attrs(fb)
        return fb.with_attrs(torch.where(skip, attrs | ATTR_SKIPPED,
                                         attrs)), state


@register
class SlowMoFilter(VideoFilter):
    """filter_slowmo.c: slow motion by emitting each frame N times."""

    info = ModuleInfo(name="slowmo", kind=ModuleKind.FILTER)
    desc = ModuleDesc(
        name="slowmo", comment="slow motion by frame cloning",
        params=[ParamSpec("factor", "clone factor", "d", 2, 1, 10)])
    slots = FilterSlot.PRE_S

    def apply(self, fb: FrameBatch, state: Any) -> Tuple[FrameBatch, Any]:
        f = self.options["factor"]
        if f <= 1:
            return fb, state
        counts = torch.full((fb.batch,), f, dtype=torch.int32,
                            device=fb.device)
        return dup_batch(fb, f, counts, fb.fps), state
