"""yuvdenoise — motion-compensated temporal denoiser.

The port of ``tcforge_tpu/modules/filters/yuvdenoise.py`` (mjpegtools'
denoiser, ``filter/yuvdenoise/``), per frame in the reference's order:
the chroma pre-increment (only the low clamp survives, then & 0xff),
``contrast_plane`` (always, so it clamps to studio range at 100 too),
an optional ``-I 1``-style deinterlace, the 8x8 block search against the
running average gated by ``low_contrast_blocks`` and the border, the
scene-change count (bad zero-vector SADs), the delayed average
``tmp = (avg_mc*delay + ref) // (delay+1)``, ``correct_luma`` and the
chroma correction, ``pass2_plane`` against the second average,
``sharpen_plane`` and the black border.  Output = avg2, and avg = tmp.
Mode 2 runs pass II only; mode 1 runs the same step on each field when
``(h//4) % 8 == 0``.  Defaults: radius 8 (clamped up to 8), threshold 5,
pp_threshold 4, delay 3, sharpen 125, increments 2, do_reset 2,
scene_thres 50 %, block_thres 1024; ``postprocess`` is parsed and, as in
the reference, unused.

Each frame's average feeds the next, so the frames of a batch run in
turn.  Inside a frame everything is batched:

- the block search computes the SADs of all (2r+1)^2 candidate vectors
  of every block in one pass (a (2r+1, 2r+1, H, W) view of the padded
  average) and takes the first minimum in the JAX order: the zero vector
  first, then dy outer and dx inner, a strict ``<``, invalid vectors
  (leaving the plane) excluded;
- U and V go through the chroma correction together, on the card in one
  launch of ``ops/kernels.py`` ``yuvdenoise_chroma`` per field, whose
  plain version is the row loop;
- ``init`` is a host bool (the stream's first frame seeds the averages)
  and the scene-reset counter a 0-d tensor on the device, so the step
  reads nothing back.

Integer division: ``_trunc_div`` truncates toward zero (C's ``/`` on
signed values); every other division floors, as ``//`` does in the JAX
filter.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from tcforge_tpu_torch.core.formats import ImageFormat
from tcforge_tpu_torch.core.frame import FrameBatch
from tcforge_tpu_torch.core.optstr import ModuleDesc, ParamSpec
from tcforge_tpu_torch.modules.registry import (FilterSlot, ModuleInfo,
                                                ModuleKind, VideoFilter,
                                                register)
from tcforge_tpu_torch.ops import kernels, video

Y_LO, Y_HI = 16, 235
C_LO, C_HI = 16, 240


def _block_view(p: torch.Tensor, b: int = 8) -> torch.Tensor:
    """(..., H, W) -> (..., H//b, W//b, b, b)."""
    *lead, h, w = p.shape
    return p.reshape(*lead, h // b, b, w // b, b).transpose(-3, -2)


def _unblock(blocks: torch.Tensor) -> torch.Tensor:
    *lead, bh, bw, b, _ = blocks.shape
    return blocks.transpose(-3, -2).reshape(*lead, bh * b, bw * b)


def _trunc_div(v: torch.Tensor, d: int) -> torch.Tensor:
    """C integer division (truncation toward zero) for signed values."""
    return torch.div(v, d, rounding_mode="trunc")


def contrast_plane(p: torch.Tensor, contrast: int, lo: int,
                   hi: int) -> torch.Tensor:
    """contrast_frame (denoise.c:68-125): (v-128)*c/100+128, clamped to
    the studio range; int32 out."""
    v = p.to(torch.int32) - 128
    return (_trunc_div(v * contrast, 100) + 128).clamp_(lo, hi)


def sharpen_plane(p: torch.Tensor, sharpen: int) -> torch.Tensor:
    """sharpen_frame (denoise.c:560-583) on an int32 (H, W) plane of
    uint8 values: m = the edge-clamped 2x2 forward average,
    out = clamp(m + (p-m)*s/100)."""
    r = torch.cat([p, p[-1:]], dim=0)
    r = torch.cat([r, r[:, -1:]], dim=1)
    m = (r[:-1, :-1] + r[:-1, 1:] + r[1:, :-1] + r[1:, 1:]) // 4
    d = _trunc_div((p - m) * sharpen, 100)
    return (m + d).clamp_(Y_LO, Y_HI)


def low_contrast_blocks(ref_y, avg_y, ref_c, avg_c,
                        threshold: int) -> torch.Tensor:
    """low_contrast_block (denoise.c:128-199) per 8x8 block: count Y
    pixels with |d| > 2T/3, Cb 4x4 (plane 0 of the (2, H2, W2) chroma)
    with |d| > 2T/3, Cr 4x4 with |d| > T/2; low iff count <= 8."""
    def count(ref, avg, b, limit):
        return (_block_view((avg - ref).abs(), b) > limit).to(
            torch.int32).sum(dim=(-2, -1))
    n = count(ref_y, avg_y, 8, 2 * threshold // 3)
    n = n + count(ref_c[0], avg_c[0], 4, 2 * threshold // 3)
    n = n + count(ref_c[1], avg_c[1], 4, threshold // 2)
    return n <= 8


def mc_search(ref: torch.Tensor, avg: torch.Tensor, radius: int,
              searched: torch.Tensor):
    """Exhaustive full-pel search of the int32 average ``avg`` around
    each 8x8 block of the int32 ``ref`` (H, W): (best SAD, dy, dx) per
    block, the first minimum in the order zero vector, then dy outer and
    dx inner, among the vectors that keep the block inside the plane.
    Blocks outside ``searched`` keep the zero vector and its SAD."""
    h, w = ref.shape
    bh, bw = h // 8, w // 8
    span = 2 * radius + 1
    pad = torch.cat([avg[:1].expand(radius, w), avg,
                     avg[-1:].expand(radius, w)], dim=0)
    pad = torch.cat([pad[:, :1].expand(-1, radius), pad,
                     pad[:, -1:].expand(-1, radius)], dim=1)
    # (span dy, span dx, H, W): the average moved by every vector
    # (int16: every difference of two uint8 values fits)
    moved = pad.to(torch.int16).unfold(0, h, 1).unfold(1, w, 1)
    diff = (moved - ref.to(torch.int16)).abs()
    sad = _block_view(diff).sum(dim=(-2, -1), dtype=torch.int32)
    sad = sad.reshape(span * span, bh, bw)
    zero = radius * span + radius                  # (dy, dx) = (0, 0)
    zero_sad = sad[zero]
    off = torch.arange(-radius, radius + 1, device=ref.device)
    by0 = torch.arange(bh, device=ref.device) * 8
    bx0 = torch.arange(bw, device=ref.device) * 8
    # vector validity (denoise.c:631-645), (span, bh) and (span, bw)
    ok_y = (by0[None] + off[:, None] >= 0) & (by0[None] + off[:, None]
                                              + 8 <= h)
    ok_x = (bx0[None] + off[:, None] >= 0) & (bx0[None] + off[:, None]
                                              + 8 <= w)
    valid = (ok_y[:, None, :, None] & ok_x[None, :, None, :]).reshape(
        span * span, bh, bw)
    big = torch.iinfo(torch.int32).max
    sad = torch.where(valid, sad, big)
    best_sad = sad.amin(dim=0)
    order = torch.arange(span * span, device=ref.device)[:, None, None]
    first = torch.where(sad == best_sad, order, span * span).amin(dim=0)
    best = torch.where(best_sad < zero_sad, first, zero)
    best = torch.where(searched, best, zero)
    best_dy = (best // span - radius).to(torch.int32)
    best_dx = (best % span - radius).to(torch.int32)
    return torch.where(searched, best_sad, zero_sad), best_dy, best_dx


def _gather_blocks(plane: torch.Tensor, vy: torch.Tensor, vx: torch.Tensor,
                   b: int) -> torch.Tensor:
    """Move each bxb block of the (..., H, W) planes by its (vy, vx)
    vector (a clamped gather: the vectors stay inside already)."""
    h, w = plane.shape[-2:]
    bh, bw = vy.shape
    dev = plane.device
    by = torch.arange(bh, device=dev)[:, None, None, None] * b
    bx = torch.arange(bw, device=dev)[None, :, None, None] * b
    yy = (by + torch.arange(b, device=dev)[None, None, :, None]
          + vy[:, :, None, None]).clamp_(0, h - 1)
    xx = (bx + torch.arange(b, device=dev)[None, None, None, :]
          + vx[:, :, None, None]).clamp_(0, w - 1)
    return _unblock(plane[..., yy, xx])


def correct_luma(ref: torch.Tensor, tmp: torch.Tensor,
                 threshold: int) -> torch.Tensor:
    """correct_frame2, Y part (denoise.c:385-412)."""
    q = (ref - tmp).abs()
    f1 = (255 * (q - threshold) // max(1, threshold)).clamp_(0, 255)
    blended = (tmp * (255 - f1) + ref * f1) // 255
    return torch.where(q > threshold, blended, tmp)


def pass2_plane(tmp: torch.Tensor, avg2: torch.Tensor, pp: int,
                luma: bool) -> torch.Tensor:
    """denoise_frame_pass2 (denoise.c:486-553)."""
    pp = max(1, pp)
    a = (avg2 * 2 + tmp) // 3
    d = (a - tmp).abs()
    f1 = ((255 * d) // pp if luma else (255 * (d - pp)) // pp).clamp_(0, 255)
    return (tmp * f1 + a * (255 - f1)) // 255


@register
class YuvDenoiseFilter(VideoFilter):
    """filter_yuvdenoise.c: the mjpegtools denoiser (module docstring)."""

    info = ModuleInfo(name="yuvdenoise", kind=ModuleKind.FILTER)
    desc = ModuleDesc(
        name="yuvdenoise", comment="motion-compensated denoiser "
        "(mjpegtools)", capabilities="VY",
        params=[ParamSpec("threshold", "denoiser threshold", "d", 5, 0,
                          255),
                ParamSpec("pp_threshold", "pass II threshold", "d", 4,
                          0, 255),
                ParamSpec("delay", "average delay (strength)", "d", 3, 1,
                          255),
                ParamSpec("radius", "block search radius", "d", 8, 0,
                          24),
                ParamSpec("postprocess", "internal postprocessing "
                          "(parsed, unused — as in the reference)",
                          "d", 1, 0, 1),
                ParamSpec("luma_contrast", "luma contrast %", "d",
                          100, 0, 255),
                ParamSpec("chroma_contrast", "chroma contrast %", "d",
                          100, 0, 255),
                ParamSpec("sharpen", "sharpness %", "d", 125, 0, 255),
                ParamSpec("increment_cb", "Cb constant add", "d", 2,
                          -128, 127),
                ParamSpec("increment_cr", "Cr constant add", "d", 2,
                          -128, 127),
                ParamSpec("deinterlace", "deinterlace first", "b", 0),
                ParamSpec("mode", "0 progressive|1 interlaced|2 pass "
                          "II only", "d", 0, 0, 2),
                ParamSpec("scene_thres", "% bad blocks for scene "
                          "change", "d", 50, 0, 100),
                ParamSpec("block_thres", "SAD above this is a bad "
                          "block", "d", 1024, 0, 1 << 30),
                ParamSpec("do_reset", "reset for n frames after scene "
                          "change", "d", 2, 0, 1 << 30),
                ParamSpec("border", "active area XxY-WxH", "s", ""),
                ParamSpec("pre", "run as pre filter", "d", 0, 0, 1)])
    slots = FilterSlot.PRE_M

    def __init__(self, job, options: str = ""):
        super().__init__(job, options)
        # the reference's default is post (filter_yuvdenoise.c:145)
        self.slots = (FilterSlot.PRE_M if self.options["pre"]
                      else FilterSlot.POST_M)
        if self.options["radius"] < 8:
            self.options["radius"] = 8     # filter_yuvdenoise.c:219
        if self.options["delay"] < 1:
            self.options["delay"] = 1

    def init_state(self, width: int, height: int, fmt: ImageFormat,
                   device: torch.device) -> Any:
        """The averages (int32 planes), the scene-reset counter (a 0-d
        int32 tensor) and ``init``, a host bool."""
        if fmt != ImageFormat.YUV420P:
            raise ValueError(
                "yuvdenoise: filter is not capable for RGB-Mode !")
        if width % 16 or height % 16:
            raise ValueError("yuvdenoise needs multiple-of-16 geometry")

        def z(h, w):
            return torch.zeros((h, w), dtype=torch.int32, device=device)
        return {"init": False,
                "reset": torch.zeros((), dtype=torch.int32, device=device),
                "y": z(height, width), "u": z(height // 2, width // 2),
                "v": z(height // 2, width // 2), "y2": z(height, width),
                "u2": z(height // 2, width // 2),
                "v2": z(height // 2, width // 2)}

    def _parse_border(self) -> Optional[Tuple[int, int, int, int]]:
        s = str(self.options["border"]).strip()
        if not s:
            return None
        parts = [int(t) for t in s.replace("x", ",").replace("-", ",")
                 .replace("+", ",").split(",") if t != ""]
        if len(parts) != 4:
            raise ValueError("yuvdenoise: border wants XxY-WxH")
        x, y, bw, bh = parts
        if bw == 0:       # filter_yuvdenoise.c:245 full-frame fixup
            return None
        return x, y, bw, bh

    def _denoise_one(self, ry, rc, ay, ac, border):
        """Mode 0's core on int32 ref/avg planes (luma (H, W), chroma
        (2, H/2, W/2)) -> (tmp luma, tmp chroma, bad-block count)."""
        o = self.options
        thr, delay = int(o["threshold"]), int(o["delay"])
        searched = ~low_contrast_blocks(ry, ay, rc, ac, thr)
        if border is not None:
            bx, by, bw_, bh_ = border
            hh, ww = ry.shape
            colx = torch.arange(ww // 8, device=ry.device) * 8
            rowy = torch.arange(hh // 8, device=ry.device) * 8
            searched = searched & (
                (colx[None, :] > bx) & (colx[None, :] < bx + bw_)
                & (rowy[:, None] > by) & (rowy[:, None] < by + bh_))
        sad, vy, vx = mc_search(ry, ay, int(o["radius"]), searched)
        bad = (searched & (sad > int(o["block_thres"]))).sum(
            dtype=torch.int32)
        mc_y = _gather_blocks(ay, vy, vx, 8)
        mc_c = _gather_blocks(ac, _trunc_div(vy, 2), _trunc_div(vx, 2), 4)
        ty = correct_luma(ry, (mc_y * delay + ry) // (delay + 1), thr)
        tc = kernels.yuvdenoise_chroma(
            rc, (mc_c * delay + rc) // (delay + 1), thr)
        return ty, tc, bad

    def _frame(self, st, ry, rc, raw_y, raw_c, border):
        """One frame: contrast-corrected int32 ``ry``/``rc`` and the raw
        (pre-incremented) planes -> (new carry, output y, output c)."""
        o = self.options
        mode = int(o["mode"])
        h, w = ry.shape
        avg_c = torch.stack([st["u"], st["v"]])
        avg2_c = torch.stack([st["u2"], st["v2"]])
        if not st["init"]:
            ay, ac = raw_y, raw_c
            a2y, a2c = raw_y, raw_c
        else:
            seeded = st["reset"] > 0
            ay = torch.where(seeded, raw_y, st["y"])
            ac = torch.where(seeded, raw_c, avg_c)
            a2y = torch.where(seeded, raw_y, st["y2"])
            a2c = torch.where(seeded, raw_c, avg2_c)
        reset = (st["reset"] - 1).clamp_(min=0)

        if mode == 2:
            ty, tc = ry, rc
            bad = None
            new_y, new_c = ay, ac            # avg untouched in mode 2
        elif mode == 1 and (h // 4) % 8 == 0:
            ty, tc = torch.empty_like(ry), torch.empty_like(rc)
            bad = 0
            for f in (0, 1):
                fy, fc, b_ = self._denoise_one(
                    ry[f::2].contiguous(), rc[:, f::2].contiguous(),
                    ay[f::2], ac[:, f::2], border)
                ty[f::2], tc[:, f::2] = fy, fc
                bad = bad + b_
            new_y, new_c = ty, tc
        else:
            ty, tc, bad = self._denoise_one(ry, rc, ay, ac, border)
            new_y, new_c = ty, tc

        pp = int(o["pp_threshold"])
        oy = pass2_plane(ty, a2y, pp, True)
        oc = pass2_plane(tc, a2c, pp, False)
        if int(o["sharpen"]):
            oy = sharpen_plane(oy.to(torch.uint8).to(torch.int32),
                               int(o["sharpen"]))
        if border is not None:
            bx, by, bw_, bh_ = border
            yy = torch.arange(h, device=ry.device)[:, None]
            xx = torch.arange(w, device=ry.device)[None, :]
            inside = ((xx >= bx) & (xx < bx + bw_)
                      & (yy >= by) & (yy < by + bh_))
            oy = torch.where(inside, oy, 16)
            oc = torch.where(inside[::2, ::2], oc, 128)

        do_reset = int(o["do_reset"])
        if bad is not None and do_reset > 0:
            scene_limit = w * h * int(o["scene_thres"]) // (64 * 100)
            reset = torch.where(bad > scene_limit, do_reset, reset)
        new = {"init": True, "reset": reset, "y": new_y, "u": new_c[0],
               "v": new_c[1], "y2": oy, "u2": oc[0], "v2": oc[1]}
        return new, oy, oc

    def apply(self, fb: FrameBatch, state: Any) -> Tuple[FrameBatch, Any]:
        o = self.options
        border = self._parse_border()

        def pre_inc(c, inc):
            # the reference's pre-fixup: its high clamp is a dead store,
            # so the result is max(v + inc, C_LO) & 0xff
            if not inc:
                return c
            return ((c.to(torch.int32) + inc).clamp_(min=C_LO)
                    & 0xFF).to(torch.uint8)

        raw_u = pre_inc(fb.u, int(o["increment_cb"]))
        raw_v = pre_inc(fb.v, int(o["increment_cr"]))
        y = video.deint_interpolate(fb.y) if int(o["deinterlace"]) else fb.y
        ry = contrast_plane(y, int(o["luma_contrast"]), Y_LO, Y_HI)
        cc = int(o["chroma_contrast"])
        rc = torch.stack([contrast_plane(raw_u, cc, C_LO, C_HI),
                          contrast_plane(raw_v, cc, C_LO, C_HI)], dim=1)
        raw_yi = fb.y.to(torch.int32)
        raw_ci = torch.stack([raw_u, raw_v], dim=1).to(torch.int32)
        outs_y, outs_c = [], []
        st = state
        for i in range(fb.batch):
            st, oy, oc = self._frame(st, ry[i], rc[i], raw_yi[i],
                                     raw_ci[i], border)
            outs_y.append(oy)
            outs_c.append(oc)
        out_y = torch.stack(outs_y).to(torch.uint8)
        out_c = torch.stack(outs_c).to(torch.uint8)
        return fb.with_planes(y=out_y, u=out_c[:, 0].contiguous(),
                              v=out_c[:, 1].contiguous()), st
