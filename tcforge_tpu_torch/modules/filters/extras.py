"""smartyuv and barrel, in plain torch.

The port of ``tcforge_tpu/modules/filters/extras.py``:

- smartyuv (``filter_smartyuv.c``): the YUV-native smart deinterlacer,
  smartdeinter's core run on each plane with ``colordiff``: luma with
  ``threshold``, U and V at their own size with ``chromathres`` when
  ``doChroma``.  YUV420P only, like the reference.
- barrel (``filter_barrel.c``): lens distortion by radial remap, the
  configure-time map in float64 on the host and a 9-tap fixed-point
  gather (``>> 15``) per plane.
- aclip (``filter_aclip.c``): an audio filter that marks quiet audio
  frames SKIPPED, with its range hysteresis, and the first loud frame
  after a skipped run KEYFRAME, on the audio batch's attrs.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import numpy as np
import torch

from tcforge_tpu_torch.core.formats import ImageFormat
from tcforge_tpu_torch.core.frame import (ATTR_KEYFRAME, ATTR_SKIPPED,
                                          AudioBatch, FrameBatch)
from tcforge_tpu_torch.core.optstr import ModuleDesc, ParamSpec
from tcforge_tpu_torch.modules.filters.smartdeinter import smartdeinter_rgb
from tcforge_tpu_torch.modules.registry import (AudioFilter, FilterSlot,
                                                ModuleInfo, ModuleKind,
                                                VideoFilter, register)
from tcforge_tpu_torch.ops.fp32 import recip32, sqrt32, tree_sum


@register
class SmartYuvFilter(VideoFilter):
    """filter_smartyuv.c: the motion-adaptive deinterlacer per plane
    (defaults 14/7/31 with highq, cubic, Blend and doChroma on,
    filter_smartyuv.c:71-73, 1235-1245)."""

    info = ModuleInfo(name="smartyuv", kind=ModuleKind.FILTER)
    desc = ModuleDesc(
        name="smartyuv", comment="motion-adaptive deinterlace (YUV)",
        capabilities="VY",
        params=[
            ParamSpec("motionOnly", "show motion areas only", "d", 0,
                      0, 1),
            ParamSpec("diffmode", "0=frame 1=field 2=both", "d", 0,
                      0, 2),
            ParamSpec("threshold", "motion threshold (luma)", "d", 14,
                      0, 255),
            ParamSpec("chromathres", "motion threshold (chroma)", "d",
                      7, 0, 255),
            ParamSpec("scenethres", "scene change threshold %", "d",
                      31, 0, 255),
            ParamSpec("highq", "motion map denoising", "d", 1, 0, 1),
            ParamSpec("cubic", "cubic interpolation", "d", 1, 0, 1),
            ParamSpec("Blend", "blend instead of interpolate", "d", 1,
                      0, 1),
            ParamSpec("doChroma", "enable chroma processing", "d", 1,
                      0, 1),
            ParamSpec("verbose", "verbose mode", "d", 0, 0, 1)])
    slots = FilterSlot.PRE_M

    def init_state(self, width: int, height: int, fmt: ImageFormat,
                   device: torch.device) -> Any:
        if fmt != ImageFormat.YUV420P:
            raise ValueError("smartyuv: this filter is only capable of "
                             "YUV mode")

        def plane_state(h, w):
            return (torch.zeros((h, w, 1), dtype=torch.int32, device=device),
                    torch.zeros((h // 2, w, 1), dtype=torch.int32,
                                device=device),
                    True)

        st = {"y": plane_state(height, width)}
        if self.options["doChroma"]:
            st["u"] = plane_state(height // 2, width // 2)
            st["v"] = plane_state(height // 2, width // 2)
        return st

    def apply(self, fb: FrameBatch, state: Any) -> Tuple[FrameBatch, Any]:
        o = self.options
        new_state = dict(state)

        def run(plane, key, thresh):
            out, new_state[key] = smartdeinter_rgb(
                plane[..., None], state[key], thresh, o["scenethres"],
                o["diffmode"], bool(o["highq"]), bool(o["Blend"]),
                bool(o["cubic"]), bool(o["motionOnly"]), colordiff=True)
            return out[..., 0]

        y = run(fb.y, "y", o["threshold"])
        if o["doChroma"]:
            u = run(fb.u, "u", o["chromathres"])
            v = run(fb.v, "v", o["chromathres"])
            return fb.with_planes(y=y, u=u, v=v), new_state
        return fb.with_planes(y=y), new_state


def barrel_map(width: int, height: int, cx: float, cy: float,
               order2: float, order4: float):
    """gen_distortion_map (filter_barrel.c:230-300) in float64 numpy:
    (srcy, srcx, weights[9]) with the weights scaled to 0x8000 and the
    center tap absorbing the rounding error, as the C does."""
    r_scale_sq = 4.0 / (width * width + height * height)
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float64)
    dx = (xx + 0.5) - cx
    dy = (yy + 0.5) - cy
    r_sq = (dx * dx + dy * dy) * r_scale_sq
    mult = 1 + order2 * r_sq + order4 * r_sq * r_sq
    srcx = cx + mult * dx
    srcy = cy + mult * dy
    mx = np.floor(srcx)
    my = np.floor(srcy)
    raw = np.empty((9, height, width))
    for t, (wy, wx) in enumerate((a, b) for a in (-1, 0, 1)
                                 for b in (-1, 0, 1)):
        ddy = (my + wy + 0.5) - srcy
        ddx = (mx + wx + 0.5) - srcx
        dist = np.sqrt(ddx * ddx + ddy * ddy)
        # the reference's "simple cubic" hack (line 276)
        raw[t] = np.where(dist >= 1, 0.0,
                          (3.0 + dist * dist * (-7.0 + dist * 4.0)) / 3.0)
    total = raw.sum(axis=0)
    w = np.floor(raw / total * 0x8000 + 0.5).astype(np.int64)
    w[4] += 0x8000 - w.sum(axis=0)          # the center tweak (line 292)
    return (my.astype(np.int32), mx.astype(np.int32), w.astype(np.int32))


def barrel_plane(src: torch.Tensor, m, defval: int) -> torch.Tensor:
    """filter_plane: the 9-tap weighted gather over (N, h, w) uint8,
    ``>> 15``; taps outside the plane read ``defval``."""
    my, mx, w = m
    h, wd = src.shape[-2:]
    src32 = src.to(torch.int32)
    acc = torch.zeros(src.shape, dtype=torch.int32, device=src.device)
    t = 0
    for wy in (-1, 0, 1):
        for wx in (-1, 0, 1):
            sy, sx = my + wy, mx + wx
            ok = (sy >= 0) & (sy < h) & (sx >= 0) & (sx < wd)
            px = src32[:, sy.clamp(0, h - 1), sx.clamp(0, wd - 1)]
            acc += torch.where(ok, px, defval) * w[t]
            t += 1
    return (acc >> 15).to(src.dtype)


@register
class BarrelFilter(VideoFilter):
    """filter_barrel.c: apply or remove barrel (lens) distortion; U and V
    take a half-size map centered at cx/2, cy/2 (barrel_configure:
    218-224), and ``range=start-end/step`` gates frames by id (lines
    378-381)."""

    info = ModuleInfo(name="barrel", kind=ModuleKind.FILTER)
    desc = ModuleDesc(
        name="barrel", comment="apply or remove barrel distortion",
        capabilities="VY",
        params=[ParamSpec("order2", "strength of order-2 distortion",
                          "f", 0.0),
                ParamSpec("order4", "strength of order-4 distortion",
                          "f", 0.0),
                ParamSpec("center", "center of distortion x/y",
                          "d/d", None),
                ParamSpec("range", "apply only to given frames",
                          "d-d/d", (0, 1 << 30, 1))])
    slots = FilterSlot.POST_M

    def init_state(self, width: int, height: int, fmt: ImageFormat,
                   device: torch.device) -> Any:
        o2, o4 = self.options["order2"], self.options["order4"]
        c = self.options["center"]
        cx, cy = c if c else (width // 2, height // 2)

        def on_device(m):
            return tuple(torch.from_numpy(a).to(device) for a in m)

        self._map_y = on_device(barrel_map(width, height, cx, cy, o2, o4))
        self._map_uv = on_device(barrel_map(width // 2, height // 2,
                                            cx / 2.0, cy / 2.0, o2, o4))
        return None

    def apply(self, fb: FrameBatch, state: Any) -> Tuple[FrameBatch, Any]:
        if fb.y is None:
            raise ValueError("barrel: YUV420P only (like the reference)")
        start, end, step = self.options["range"]
        ids = (fb.frame_ids if fb.frame_ids is not None
               else torch.arange(fb.batch, dtype=torch.int32,
                                 device=fb.device))
        act = ((ids >= start) & (ids <= end) & ((ids - start) % step == 0)
               & ((fb.attrs & ATTR_SKIPPED) == 0)).view(-1, 1, 1)
        y = torch.where(act, barrel_plane(fb.y, self._map_y, 16), fb.y)
        u = torch.where(act, barrel_plane(fb.u, self._map_uv, 128), fb.u)
        v = torch.where(act, barrel_plane(fb.v, self._map_uv, 128), fb.v)
        return fb.with_planes(y=y, u=u, v=v), state


@register
class AclipFilter(AudioFilter):
    """filter_aclip.c: skip audio frames whose RMS metric
    sqrt(sum s^2)/nsamples*1000 stays under ``level``, with a
    ``range``-frame hysteresis before skipping resumes, and mark the
    first loud frame after a skipped run as a keyframe
    (filter_aclip.c:125-158).

    The JAX filter's per-frame scan is solved for the whole batch: in a
    run of quiet frames the counter climbs from its start (the carried
    counter for the batch's first run, 0 after a loud frame) and frame j
    of the run is skipped once start + j reaches ``range``; a loud frame
    is a keyframe when the frame before it was skipped.  The metric is
    the jitted step's (the sum in XLA's order, times the folded
    1000/nsamples) or op-by-op JAX's (divided, then multiplied)."""

    info = ModuleInfo(name="aclip", kind=ModuleKind.FILTER, media="audio")
    desc = ModuleDesc(
        name="aclip", comment="skip quiet audio, keyframe loud edges",
        params=[ParamSpec("level", "audio must be under this level to "
                          "be skipped", "d", 10, 0, 255),
                ParamSpec("range", "frames over level before skipping "
                          "resumes", "d", 25, 0, 255)])
    slots = FilterSlot.PRE_S
    media = "audio"

    def init_state(self, rate: int, channels: int,
                   device: torch.device) -> Any:
        # range_ctr starts at `range` (filter_aclip.c:94): the very
        # first quiet frame is skipped at once
        return {"range_ctr": torch.full((), self.options["range"],
                                        dtype=torch.int32, device=device),
                "skip_mode": torch.zeros((), dtype=torch.int32,
                                         device=device)}

    def apply(self, ab: AudioBatch, state: Any) -> Tuple[AudioBatch, Any]:
        n, s, c = ab.pcm.shape
        if n == 0:
            return ab, state
        level, rng = self.options["level"], self.options["range"]
        dev = ab.pcm.device
        x = ab.pcm.to(torch.float32)
        nsamp = s * c
        root = sqrt32(tree_sum(x * x, 2))
        if self.jitted:
            metric = root * np.float32(np.float32(recip32(nsamp)) * 1000)
        else:
            metric = (root / torch.full((), nsamp, dtype=torch.float32,
                                        device=dev)) * 1000.0
        quiet = metric < level
        k = torch.arange(n, dtype=torch.int32, device=dev)
        last_loud = torch.cummax(torch.where(quiet, -1, k), 0).values
        start = torch.where(last_loud >= 0, 0, state["range_ctr"])
        pos = start + (k - last_loud - 1)       # the counter before frame k
        skip = quiet & (pos >= rng)
        before = torch.cat([state["skip_mode"].view(1) == 1, skip[:-1]])
        key = ~quiet & before
        attrs = (ab.attrs if ab.attrs is not None
                 else torch.zeros((n,), dtype=torch.int32, device=dev))
        attrs = torch.where(skip, attrs | ATTR_SKIPPED, attrs)
        attrs = torch.where(key, attrs | ATTR_KEYFRAME, attrs)
        ctr = torch.where(quiet[-1], torch.clamp_max(pos[-1] + 1, rng), 0)
        return (dataclasses.replace(ab, attrs=attrs),
                {"range_ctr": ctr.to(torch.int32),
                 "skip_mode": skip[-1].to(torch.int32)})
