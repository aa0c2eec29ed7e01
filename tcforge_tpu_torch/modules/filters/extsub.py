"""extsub — DVD subtitle (subpicture) overlay: the port of
``tcforge_tpu/modules/filters/extsub.py`` (``filter/extsub/``).

Every subpicture unit decodes at init (the pinned ``io/spu.py``, or
``io/vobsub.py`` for a ``.idx``/``.sub`` pair; a program stream's
private stream 1, or a raw concatenation of units) into a list of
layers: the frames it shows on (from its PTS, its control dates and
``timeshift``), its place (``vertshift`` down, kept on the frame) and
its luma and weight.  The luma comes from the CLUT (``palette``, the
``.idx`` palette, or a gray ramp), or from the reference renderer's
class fill (any of ``color1``, ``color2``, ``ca``, ``cb``; with the
``antialias`` smoothing of ``-C``).  ``apply`` blends the layers into
the luma plane one after the other in float32, ``region*(1-w) +
luma*w`` for the frames a layer shows on (w is its alpha there, 0
elsewhere), then rounds and clips once, as the JAX filter does.  A
layer whose frames miss the batch's would blend with w = 0 and leave
every value as it is, so only the layers that meet the batch's frame
ids (``FrameBatch.id_range``, known on the host) run, in file order: a
film's thousand-odd units cost a batch the few that show in it.
"""

from __future__ import annotations

import logging
from typing import Any, Tuple

import numpy as np
import torch

from tcforge_tpu_torch.core.formats import ImageFormat
from tcforge_tpu_torch.core.frame import FrameBatch
from tcforge_tpu_torch.core.optstr import ModuleDesc, ParamSpec
from tcforge_tpu_torch.modules.registry import (FilterSlot, ModuleInfo,
                                                ModuleKind, VideoFilter,
                                                register)

_log = logging.getLogger("tcforge_tpu_torch")

# default 16-entry CLUT: grayscale luma ramp (no IFO available)
_DEF_CLUT_Y = [16, 235, 128, 64, 176, 96, 208, 48,
               144, 80, 192, 112, 224, 32, 160, 100]


@register
class ExtsubFilter(VideoFilter):
    info = ModuleInfo(name="extsub", kind=ModuleKind.FILTER)
    desc = ModuleDesc(
        name="extsub", comment="DVD subtitle overlay", version="0.3.5",
        capabilities="VY",
        params=[ParamSpec("subtitle_file", "VOB/PS or raw SPU stream",
                          "s", ""),
                ParamSpec("track", "subtitle substream 0-31", "d", 0,
                          0, 31),
                ParamSpec("vertshift", "shift down, % of height", "d",
                          0, 0, 100),
                ParamSpec("forceshow", "also show non-forced units",
                          "d", 1, 0, 1),
                ParamSpec("forced", "render only forced subtitles",
                          "d", 0, 0, 1),
                ParamSpec("timeshift", "display start correction ms",
                          "d", 0, -(1 << 30), 1 << 30),
                ParamSpec("antialias", "anti-alias rendered bitmap",
                          "d", 1, 0, 1),
                ParamSpec("pre", "run as a pre filter", "d", 1, 0, 1),
                ParamSpec("color1", "luma for class ca", "d", 0, 0,
                          255),
                ParamSpec("color2", "luma for class cb", "d", 255, 0,
                          255),
                ParamSpec("ca", "subtitle color class a", "d", 2, 0, 3),
                ParamSpec("cb", "subtitle color class b", "d", 3, 0, 3),
                ParamSpec("palette", "16 comma-separated CLUT lumas",
                          "s", "")])
    slots = FilterSlot.PRE_M

    def __init__(self, job, options: str = ""):
        super().__init__(job, options)
        if not self.options["pre"]:
            self.slots = FilterSlot.POST_M
        # any class option selects the reference's class-fill renderer
        # (anti_alias_subtitle, filter_extsub.c:203-241)
        self._ref_render = any(
            k in (options or "")
            for k in ("color1=", "color2=", "ca=", "cb="))
        path = self.options["subtitle_file"]
        if not path:
            raise ValueError("extsub: subtitle_file= is required")
        from tcforge_tpu_torch.io import spu
        idx_palette = None
        if path.lower().endswith(".idx"):
            from tcforge_tpu_torch.io import vobsub
            self.spus, vinfo = vobsub.read_vobsub(
                path, self.options["track"])
            if vinfo.palette:
                idx_palette = vobsub.palette_luma(vinfo.palette)
        else:
            with open(path, "rb") as f:
                head = f.read(4)
            if head[:3] == b"\x00\x00\x01":  # program stream / PES
                self.spus = spu.collect_vob_spus(
                    path, self.options["track"])
            else:                            # raw concatenated units
                with open(path, "rb") as f:
                    data = f.read()
                self.spus = [spu.decode_spu(p)
                             for p in spu.iter_spu_packets(data)]
        if not self.options["forceshow"] or self.options["forced"]:
            self.spus = [s for s in self.spus if s.forced]
        clut = self.options["palette"]
        self.clut_y = ([int(v) for v in clut.split(",")]
                       if clut else idx_palette
                       if idx_palette else list(_DEF_CLUT_Y))
        if len(self.clut_y) != 16:
            raise ValueError("extsub: palette needs 16 luma values")
        _log.info("[extsub] loaded %d subpicture units", len(self.spus))

    def init_state(self, width: int, height: int, fmt: ImageFormat,
                   device: torch.device) -> Any:
        if fmt != ImageFormat.YUV420P:
            raise ValueError("extsub needs YUV420P (-V)")
        fps = self.job.fps or 25.0
        shift = height * self.options["vertshift"] // 100
        tshift = self.options["timeshift"] / 1000.0
        layers, windows = [], []
        clut = np.asarray(self.clut_y, np.float32)
        for s in self.spus:
            # PTS -> frame window; control dates are 1024-tick units
            base = (s.pts or 0) / 90000.0 + tshift
            t0 = base + s.start_ticks * 1024 / 90000.0
            t1 = base + (s.stop_ticks * 1024 / 90000.0
                         if s.stop_ticks is not None else 5.0)
            f0 = int(round(t0 * fps))
            f1 = max(f0 + 1, int(round(t1 * fps)))
            pal = np.asarray(s.palette, np.int32)
            alpha = np.asarray(s.alpha, np.float32) / 15.0
            if self._ref_render:
                ysrc = self._class_fill(s.bitmap)
            else:
                ysrc = clut[pal][s.bitmap]
            asrc = alpha[s.bitmap]
            x = min(s.x, max(0, width - s.bitmap.shape[1]))
            y = min(s.y + shift, max(0, height - s.bitmap.shape[0]))
            windows.append((f0, f1))
            layers.append((f0, f1, x, y,
                           torch.from_numpy(ysrc.astype(np.float32)).to(
                               device),
                           torch.from_numpy(asrc.astype(np.float32)).to(
                               device)))
        self._layers = layers
        self._windows = np.asarray(windows, np.int64).reshape(-1, 2)
        return None

    def meeting(self, lo: int, hi: int) -> np.ndarray:
        """The indices, in file order, of the layers that show on some
        frame id in ``[lo, hi)``."""
        f0, f1 = self._windows[:, 0], self._windows[:, 1]
        return np.nonzero((f0 < hi) & (f1 > lo))[0]

    def _class_fill(self, bitmap: np.ndarray) -> np.ndarray:
        """anti_alias_subtitle (filter_extsub.c:203-241): class ca ->
        color1, class cb -> color2, every other pixel the background of
        the colored class seen last in the row-major walk (255 after cb,
        black after ca), then the optional tcv_antialias smoothing;
        black=16 (the YUV path, line 273)."""
        black = 16
        color1 = max(self.options["color1"], black + 1)
        color2 = max(self.options["color2"], black + 1)
        ca, cb = self.options["ca"], self.options["cb"]
        flat = bitmap.reshape(-1)
        marker = np.where(flat == ca, 0, np.where(flat == cb, 1, -1))
        pos = np.where(marker >= 0, np.arange(flat.size), -1)
        last = np.maximum.accumulate(pos)
        back = np.where(last >= 0, np.where(marker[np.maximum(last, 0)]
                                            == 1, 255, black), black)
        luma = np.where(flat == ca, color1,
                        np.where(flat == cb, color2, back))
        out = luma.reshape(bitmap.shape).astype(np.float32)
        if self.options["antialias"]:
            from tcforge_tpu_torch.ops.video import antialias
            out = antialias(torch.from_numpy(out.astype(np.uint8))).numpy(
            ).astype(np.float32)
        return out

    def apply(self, fb: FrameBatch, state: Any) -> Tuple[FrameBatch, Any]:
        if fb.frame_ids is None:
            ids = torch.arange(fb.batch, dtype=torch.int32,
                               device=fb.y.device)
            span = (0, fb.batch)
        else:
            ids, span = fb.frame_ids, fb.id_range
        which = (range(len(self._layers)) if span is None
                 else self.meeting(*span))
        if not len(which):
            return fb, state
        y = fb.y.to(torch.float32)
        for k in which:
            f0, f1, x, xy, ysrc, asrc = self._layers[k]
            mh, mw = ysrc.shape
            on = ((ids >= f0) & (ids < f1)).to(torch.float32)
            w = asrc[None] * on[:, None, None]
            region = y[:, xy:xy + mh, x:x + mw]
            y[:, xy:xy + mh, x:x + mw] = region * (1 - w) + ysrc[None] * w
        return fb.with_planes(y=y.round().clamp(0, 255).to(torch.uint8)), \
            state
