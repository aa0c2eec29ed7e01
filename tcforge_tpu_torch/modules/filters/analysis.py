"""Analysis and correction filters: whitebalance, detectclipping,
facemask, fields, divxkey.

The port of ``tcforge_tpu/modules/filters/analysis.py`` (analogues of
``filter_whitebalance.c``, ``filter_detectclipping.c``,
``filter_facemask.c``, ``filter_fields.c`` and ``filter_divxkey.c``).
Per-pixel work is batched torch; the converging detector and the field
shifter carry their state across batches.

Float32 means follow the jitted JAX filters: XLA compiles a mean over n
values to ``sum * (1/n)`` with the float32 reciprocal.
"""

from __future__ import annotations

import logging
from typing import Any, Tuple

import numpy as np
import torch

from tcforge_tpu_torch.core.formats import ImageFormat
from tcforge_tpu_torch.core.frame import ATTR_KEYFRAME, FrameBatch
from tcforge_tpu_torch.core.optstr import ModuleDesc, ParamSpec
from tcforge_tpu_torch.modules.registry import (FilterSlot, ModuleInfo,
                                                ModuleKind, VideoFilter,
                                                register)
from tcforge_tpu_torch.ops import colorspace

_log = logging.getLogger("tcforge_tpu_torch")


def _mean(x: torch.Tensor, dims) -> torch.Tensor:
    """float32 mean over ``dims`` as the jitted JAX mean computes it:
    the float32 sum times the float32 reciprocal of the count."""
    count = int(np.prod([x.shape[d] for d in dims]))
    inv = float(np.float32(1) / np.float32(count))
    return x.to(torch.float32).sum(dim=dims) * inv


def _frame_ids(fb: FrameBatch) -> torch.Tensor:
    return (fb.frame_ids if fb.frame_ids is not None
            else torch.arange(fb.batch, dtype=torch.int32, device=fb.device))


@register
class WhitebalanceFilter(VideoFilter):
    """filter_whitebalance.c: blue-to-yellow white balance shift.

    Power-curve tables on red and blue (filter_whitebalance.c:120-124):
    with factor = 1 + |level|/100 (inverted for negative levels),
    red' = (r/255)^(1/factor)*255 and blue' = (b/255)^factor*255.  YUV
    input converts to RGB and back; frames the ``limit`` toggles turn
    off (+N on, -N off) keep their input bytes.
    """

    info = ModuleInfo(name="whitebalance", kind=ModuleKind.FILTER)
    desc = ModuleDesc(
        name="whitebalance",
        comment="white balance correction (blue<->yellow shift)",
        params=[ParamSpec("level", "blue-to-yellow shift level", "d", 40,
                          -1000, 1000),
                ParamSpec("limit", "frame ranges: +N on, -N off", "s",
                          "")])
    slots = FilterSlot.PRE_M

    def __init__(self, job, options: str = ""):
        super().__init__(job, options)
        level = int(self.options["level"])
        factor = 1.0 + abs(level) / 100.0
        if level < 0:
            factor = 1.0 / factor
        i = np.arange(256, dtype=np.float64) / 255.0
        self._red_lut = torch.from_numpy(
            (np.power(i, 1.0 / factor) * 255).astype(np.uint8))
        self._blue_lut = torch.from_numpy(
            (np.power(i, factor) * 255).astype(np.uint8))
        # "+12-34+56": alternating on/off switch frames, ON at the start
        switches = []
        s = self.options["limit"]
        pos = 0
        while pos < len(s):
            ch = s[pos]
            if ch in "+-":
                num = ""
                pos += 1
                while pos < len(s) and s[pos].isdigit():
                    num += s[pos]
                    pos += 1
                if num:
                    switches.append((int(num), 1 if ch == "+" else 0))
            else:
                pos += 1
        self._switch_ids = torch.tensor([-1] + [f for f, _ in switches],
                                        dtype=torch.int32)
        self._switch_states = torch.tensor([1] + [st for _, st in switches],
                                           dtype=torch.int32)

    def _active(self, ids: torch.Tensor) -> torch.Tensor:
        dev = ids.device
        idx = torch.searchsorted(self._switch_ids.to(dev), ids,
                                 right=True) - 1
        return self._switch_states.to(dev)[idx] != 0

    def apply(self, fb: FrameBatch, state: Any) -> Tuple[FrameBatch, Any]:
        rgb_in = fb.rgb is not None
        work = fb if rgb_in else colorspace.convert(fb, ImageFormat.RGB24)
        rgb = work.rgb
        dev = rgb.device
        out = torch.stack([self._red_lut.to(dev)[rgb[..., 0].long()],
                           rgb[..., 1],
                           self._blue_lut.to(dev)[rgb[..., 2].long()]],
                          dim=-1)
        active = self._active(_frame_ids(fb))
        if rgb_in:
            return fb.with_planes(rgb=torch.where(
                active[:, None, None, None], out, rgb)), state
        # select in the input's own format, so that OFF frames keep their
        # bytes (the reference returns before any conversion)
        back = colorspace.convert(work.with_planes(rgb=out), fb.format)
        a3 = active[:, None, None]
        return fb.with_planes(
            y=torch.where(a3, back.y, fb.y),
            u=torch.where(a3, back.u, fb.u) if fb.u is not None else None,
            v=torch.where(a3, back.v, fb.v) if fb.v is not None else None
        ), state


@register
class DetectClippingFilter(VideoFilter):
    """filter_detectclipping.c: converge on the black-border bounding
    box and suggest -j/-Y clip values.

    A line whose mean exceeds ``limit`` is content
    (filter_detectclipping.c:85-105); x1/y1 track the smallest
    first-content column/row, x2/y2 the largest last-content ones, over
    the frames in ``range`` from frame 3 on.  The carry is the four
    bounds as 0-d int32 tensors; ``collect`` reads them once a batch, and
    ``finalize`` logs the suggestion (rounded to even) and writes it to
    ``log``.
    """

    info = ModuleInfo(name="detectclipping", kind=ModuleKind.FILTER)
    desc = ModuleDesc(
        name="detectclipping", comment="detect black image borders",
        params=[ParamSpec("limit", "line-mean threshold for black", "d",
                          24, 0, 255),
                ParamSpec("post", "run as POST filter (-Y not -j)", "b",
                          0),
                ParamSpec("range", "apply filter to [start-end]/step "
                          "frames", "d-d/d", (0, 1 << 30, 1)),
                ParamSpec("log", "file for per-frame values", "s", "")])
    slots = FilterSlot.PRE_M

    def __init__(self, job, options: str = ""):
        super().__init__(job, options)
        self.limit = int(self.options["limit"])
        if self.options["post"]:
            self.slots = FilterSlot.POST_M
        self._final = None

    def init_state(self, width: int, height: int, fmt: ImageFormat,
                   device: torch.device) -> Any:
        self._size = (width, height)

        def i32(v):
            return torch.tensor(v, dtype=torch.int32, device=device)
        return {"x1": i32(width), "y1": i32(height), "x2": i32(0),
                "y2": i32(0)}

    def apply(self, fb: FrameBatch, state: Any) -> Tuple[FrameBatch, Any]:
        if fb.rgb is not None:
            img = _mean(fb.rgb.to(torch.int32), (-1,))
        else:
            img = fb.y.to(torch.int32)
        n, h, w = img.shape
        row_mean = _mean(img, (2,))          # (N, H)
        col_mean = _mean(img, (1,))          # (N, W)
        ids = _frame_ids(fb)
        start, end, step = self.options["range"]
        valid = ((ids >= 3) & (ids >= start) & (ids <= end)
                 & ((ids - start) % step == 0))
        hh = torch.arange(h, dtype=torch.int32, device=fb.device)
        ww = torch.arange(w, dtype=torch.int32, device=fb.device)
        big = 1 << 30

        def first(bright, idx):
            return torch.where(bright, idx[None, :], big).amin(dim=1)

        def last(bright, idx):
            return torch.where(bright, idx[None, :], -1).amax(dim=1)
        rb = row_mean > self.limit
        cb = col_mean > self.limit
        y1 = torch.where(valid, first(rb, hh), big).amin()
        y2 = torch.where(valid, last(rb, hh), -1).amax()
        x1 = torch.where(valid, first(cb, ww), big).amin()
        x2 = torch.where(valid, last(cb, ww), -1).amax()
        return fb, {"x1": torch.minimum(state["x1"], x1),
                    "y1": torch.minimum(state["y1"], y1),
                    "x2": torch.maximum(state["x2"], x2),
                    "y2": torch.maximum(state["y2"], y2)}

    def suggestion(self, state) -> Tuple[int, int, int, int]:
        """(t, l, b, r) clip values, rounded to even like the C."""
        w, h = self._size
        x1 = min(int(state["x1"]), w)
        y1 = min(int(state["y1"]), h)
        x2 = max(int(state["x2"]), 0)
        y2 = max(int(state["y2"]), 0)
        t = (y1 + 1) & ~1
        lft = (x1 + 1) & ~1
        b = h - ((y2 + 1) & ~1)
        r = w - ((x2 + 1) & ~1)
        return t, lft, b, r

    def collect(self, state: Any) -> None:
        self._final = {k: int(v) for k, v in state.items()}

    def finalize(self, state: Any) -> None:
        t, lft, b, r = self.suggestion(state)
        flag = "-Y" if self.options["post"] else "-j"
        _log.info("[detectclipping] valid area: X: %d..%d Y: %d..%d -> "
                  "%s %d,%d,%d,%d", int(state["x1"]), int(state["x2"]),
                  int(state["y1"]), int(state["y2"]), flag, t, lft, b, r)
        path = self.options["log"]
        if path:
            with open(path, "w") as f:
                f.write(f"{t} {lft} {b} {r}\n")


@register
class FacemaskFilter(VideoFilter):
    """filter_facemask.c: pixelate a rectangular zone.

    The zone at (xpos, ypos) of (xdim, ydim) is tiled into xresolution x
    yresolution cells, each replaced by its float32 mean, rounded half
    to even (the clean cell mean of the JAX filter, not the C's
    off-by-one window).
    """

    info = ModuleInfo(name="facemask", kind=ModuleKind.FILTER)
    desc = ModuleDesc(
        name="facemask", comment="pixelate (mask) a face zone",
        params=[ParamSpec("xpos", "left edge of the mask", "d", 0),
                ParamSpec("ypos", "top edge of the mask", "d", 0),
                ParamSpec("xresolution", "cell width", "d", 8),
                ParamSpec("yresolution", "cell height", "d", 8),
                ParamSpec("xdim", "mask width (multiple of xres)", "d",
                          0),
                ParamSpec("ydim", "mask height (multiple of yres)", "d",
                          0)])
    slots = FilterSlot.PRE_M

    def __init__(self, job, options: str = ""):
        super().__init__(job, options)
        o = self.options
        self.x, self.y = int(o["xpos"]), int(o["ypos"])
        self.cw, self.ch = int(o["xresolution"]), int(o["yresolution"])
        self.w, self.h = int(o["xdim"]), int(o["ydim"])
        if self.w % self.cw or self.h % self.ch:
            raise ValueError("facemask: dimensions must be multiples of "
                             "the cell resolution")

    @staticmethod
    def _pixelate(plane: torch.Tensor, x, y, w, h, cw, ch) -> torch.Tensor:
        if w <= 0 or h <= 0:
            return plane
        n = plane.shape[0]
        cells = plane[:, y:y + h, x:x + w].reshape(n, h // ch, ch,
                                                   w // cw, cw)
        means = _mean(cells, (2, 4))[:, :, None, :, None]
        filled = torch.round(means.expand(cells.shape)).reshape(n, h, w)
        out = plane.clone()
        out[:, y:y + h, x:x + w] = filled.to(plane.dtype)
        return out

    def apply(self, fb: FrameBatch, state: Any) -> Tuple[FrameBatch, Any]:
        x, y, w, h = self.x, self.y, self.w, self.h
        cw, ch = self.cw, self.ch
        if fb.rgb is not None:
            out = torch.stack([self._pixelate(fb.rgb[..., c], x, y, w, h,
                                              cw, ch)
                               for c in range(fb.rgb.shape[-1])], dim=-1)
            return fb.with_planes(rgb=out), state
        planes = {"y": self._pixelate(fb.y, x, y, w, h, cw, ch)}
        if fb.u is not None:
            sx, sy = fb.format.subsampling
            # chroma cells shrink with the subsampling
            ccw, cch = max(1, cw // sx), max(1, ch // sy)
            cx, cy = x // sx, y // sy
            cwd, chd = w // sx // ccw * ccw, h // sy // cch * cch
            planes["u"] = self._pixelate(fb.u, cx, cy, cwd, chd, ccw, cch)
            planes["v"] = self._pixelate(fb.v, cx, cy, cwd, chd, ccw, cch)
        return fb.with_planes(**planes), state


@register
class FieldsFilter(VideoFilter):
    """filter_fields.c: shift or reorder interlaced fields.

    - flip: exchange the top and bottom fields of each frame;
    - shift: move the video by one field, out_top(i) = bottom(i-1),
      out_bottom(i) = top(i) (filter_fields.c:337-341);
    - shift+flip: delay the bottom field one frame (:343-347);
    - flip_first (with flip and shift): delay the top field (:349).

    YUV shifts luma only (the C copies the first w*h bytes); RGB whole
    pixels.  The carry is the field saved from the previous frame,
    zero before frame 0.
    """

    info = ModuleInfo(name="fields", kind=ModuleKind.FILTER)
    desc = ModuleDesc(
        name="fields", comment="field shift / reorder",
        params=[ParamSpec("flip", "swap top and bottom fields", "b", 0),
                ParamSpec("shift", "shift video by one field", "b", 0),
                ParamSpec("flip_first", "flip before shifting", "b", 0)])
    slots = FilterSlot.PRE_M

    OP_FLIP = 1
    OP_SHIFT = 2
    OP_REVERSE = 4

    def __init__(self, job, options: str = ""):
        super().__init__(job, options)
        ops = 0
        if self.options["flip"]:
            ops |= self.OP_FLIP
        if self.options["shift"]:
            ops |= self.OP_SHIFT
        if self.options["flip_first"]:
            ops |= self.OP_REVERSE
        if ops & self.OP_REVERSE and \
                (ops & ~self.OP_REVERSE) != (self.OP_FLIP | self.OP_SHIFT):
            ops &= ~self.OP_REVERSE
        if not ops:
            raise ValueError("fields: no operations specified "
                             "(flip / shift / flip_first)")
        self.ops = ops

    def init_state(self, width: int, height: int, fmt: ImageFormat,
                   device: torch.device) -> Any:
        if fmt.is_rgb:
            chans = 4 if fmt.name.startswith(("RGBA", "ARGB", "BGRA")) \
                else 3
            shape: Tuple[int, ...] = (height // 2, width, chans)
        else:
            shape = (height // 2, width)
        return torch.zeros(shape, dtype=torch.uint8, device=device)

    def _run(self, img: torch.Tensor, carry: torch.Tensor):
        """img: (N, H, W[, C]); carry: (H//2, W[, C])."""
        top, bottom = img[:, 0::2], img[:, 1::2]
        op = self.ops
        if op == self.OP_FLIP:
            new_top, new_bottom, new_carry = bottom, top, carry
        elif op == self.OP_SHIFT:
            new_top = torch.cat([carry[None], bottom[:-1]])
            new_bottom, new_carry = top, bottom[-1]
        elif op == (self.OP_SHIFT | self.OP_FLIP):
            new_top = top
            new_bottom = torch.cat([carry[None], bottom[:-1]])
            new_carry = bottom[-1]
        else:  # FLIPSHIFT: delay the top field one frame
            new_top = torch.cat([carry[None], top[:-1]])
            new_bottom, new_carry = bottom, top[-1]
        out = torch.empty_like(img)
        out[:, 0::2] = new_top
        out[:, 1::2] = new_bottom
        return out, new_carry.contiguous()

    def apply(self, fb: FrameBatch, state: Any) -> Tuple[FrameBatch, Any]:
        if fb.rgb is not None:
            out, state = self._run(fb.rgb, state)
            return fb.with_planes(rgb=out), state
        out, state = self._run(fb.y, state)
        return fb.with_planes(y=out), state


@register
class DivxKeyFilter(VideoFilter):
    """filter_divxkey.c: mark MPEG-4/DivX keyframes.

    The whole file (``es=``, else the job's input) is scanned for VOP
    start codes at construction (``io/mpeg4.scan_keyframes``); each
    frame whose id is an intra VOP's index gets ``ATTR_KEYFRAME``, ids
    past the scan none (the JAX filter's sentinel).
    """

    info = ModuleInfo(name="divxkey", kind=ModuleKind.FILTER)
    desc = ModuleDesc(
        name="divxkey", comment="mark MPEG-4 (DivX) keyframes",
        params=[ParamSpec("es", "MPEG-4 ES file to scan", "s", "")])
    slots = FilterSlot.PRE_S

    def __init__(self, job, options: str = ""):
        super().__init__(job, options)
        path = self.options["es"] or getattr(job, "video_in_file", None)
        from tcforge_tpu_torch.io.mpeg4 import scan_keyframes
        try:
            with open(path, "rb") as f:
                data = f.read()
        except (OSError, TypeError) as e:
            raise ValueError(f"divxkey: cannot read ES ({e})")
        keys = scan_keyframes(data)
        self.n_frames = keys.shape[0]
        self._is_key = torch.from_numpy(np.concatenate([keys, [False]]))

    def apply(self, fb: FrameBatch, state: Any) -> Tuple[FrameBatch, Any]:
        idx = _frame_ids(fb).to(torch.int64).clamp(0, self.n_frames)
        key = self._is_key.to(fb.device)[idx]
        attrs = (fb.attrs if fb.attrs is not None
                 else torch.zeros(fb.batch, dtype=torch.int32,
                                  device=fb.device))
        attrs = torch.where(key, attrs | ATTR_KEYFRAME, attrs)
        return fb.with_attrs(attrs), state
