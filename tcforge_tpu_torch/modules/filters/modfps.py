"""modfps — buffered frame-rate conversion with content-aware clone and
skip placement.

The port of ``tcforge_tpu/modules/filters/modfps.py``
(``filter_modfps.c``).  Buffered mode keeps a ring of ``examine`` + 1
frames with a motion score per slot (the subsampled SAD between ring
neighbours) and places each skip the rate demands on the lowest-scoring
buffered frame (the near-duplicate) and each clone on the highest
(filter_modfps.c:580-740).  mode=0 is the unbuffered schedule of the
fps filter.

The frame emitted at a step is always the input from ``examine`` steps
earlier, so the frames never enter the state machine: the delay line is
the carried frames concatenated with the batch.  As decimate does in
``cadence.py``, the port computes the SADs of the batch on the card,
reads them back once, runs the ring's state machine on the host (its
``outframes`` in float32, as the JAX scan keeps it), and emits the
delayed frames with their copies marked on the card.

clonetype merges each clone with the next emitted frame
(``fancy_clone``, :330-370): 1/2 field interleave (the clone keeps its
own chroma), 3 average, 4 temporal average with rate-grid weights, 5
phosphor (the cube root of the mean cube of the luma); 3 to 5 are gated
by the scene-change test (``yuv_detect_scenechange:129-173``) with the
reference's 8-bit ``ABS`` macro.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Any, List, Tuple

import numpy as np
import torch

from tcforge_tpu_torch.core.formats import ImageFormat
from tcforge_tpu_torch.core.frame import FrameBatch
from tcforge_tpu_torch.core.optstr import ModuleDesc, ParamSpec
from tcforge_tpu_torch.core.ratiocodes import frc_code_to_value
from tcforge_tpu_torch.modules.filters.rate import FpsFilter, dup_batch
from tcforge_tpu_torch.modules.registry import (FilterSlot, ModuleInfo,
                                                ModuleKind, VideoFilter,
                                                register)

_F32 = np.float32


def _reciprocal(a: float) -> np.float32:
    """What ``x / a`` multiplies by in the JAX engine's jitted step: XLA
    turns a division by a constant into a multiplication by its float32
    reciprocal."""
    return _F32(1) / _F32(a)


@lru_cache(maxsize=None)
def _phosphor_lut() -> np.ndarray:
    """clonetype 5's luma for every (clone, next) byte pair:
    ``round(((c^3 + n^3) >> 1) ** f32(1/3))`` in float32, each float32
    power correctly rounded from float64, then rounded half to even."""
    c = np.arange(256, dtype=np.int64)
    cub = (c[:, None] ** 3 + c[None, :] ** 3) >> 1
    x = cub.astype(np.float32).astype(np.float64)
    p = np.power(x, np.float64(_F32(1.0 / 3.0))).astype(np.float32)
    return np.round(p).astype(np.uint8)


@register
class ModFpsFilter(VideoFilter):
    info = ModuleInfo(name="modfps", kind=ModuleKind.FILTER)
    desc = ModuleDesc(
        name="modfps", comment="buffered fps converter", version="0.10",
        capabilities="VYRE",
        params=[ParamSpec("mode", "0=unbuffered 1=buffered", "d", 1, 0, 1),
                ParamSpec("infps", "original fps (0=probe)", "f", 0.0,
                          0.0, 200.0),
                ParamSpec("infrc", "original frc (overrides infps)",
                          "d", 0, 0, 16),
                ParamSpec("examine", "frames to buffer", "d", 5, 2, 25),
                ParamSpec("buffer", "frames to buffer (reference "
                          "option name; wins over examine)", "d", 0, 0, 25),
                ParamSpec("subsample", "pixel subsampling step", "d", 32,
                          1, 256),
                ParamSpec("clonetype", "0=copy 1/2=interpolate fields "
                          "3=average 4=temporal 5=phosphor", "d", 0, 0, 16),
                ParamSpec("verbose", "run in verbose mode", "d", 0, 0, 1)])
    slots = FilterSlot.POST_S

    def __init__(self, job, options: str = ""):
        super().__init__(job, options)
        self.infps = self.options["infps"] or job.fps
        if self.options["infrc"]:
            v = frc_code_to_value(self.options["infrc"])
            if v:
                self.infps = v
        self.outfps = job.out_fps if job.ex_fps > 0 else job.fps
        if self.outfps > self.infps * 2.0:
            raise ValueError("modfps: output fps cannot exceed twice "
                             "the input fps")
        self.num_sample = self.options["buffer"] or self.options["examine"]
        self.sub = self.options["subsample"]
        self.clonetype = self.options["clonetype"]
        self._plain = (FpsFilter(job, f"infps={self.infps}:"
                                      f"outfps={self.outfps}")
                       if self.options["mode"] == 0 else None)

    def init_state(self, width: int, height: int, fmt: ImageFormat,
                   device: torch.device) -> Any:
        if self._plain is not None:
            return None
        if fmt != ImageFormat.YUV420P:
            raise ValueError("modfps buffered mode needs YUV420P")
        nb, ns = self.num_sample + 1, self.num_sample

        def frames(h, w):
            return torch.zeros((ns, h, w), dtype=torch.uint8, device=device)
        npix = (height * width + self.sub - 1) // self.sub
        return {"y": frames(height, width),
                "u": frames(height // 2, width // 2),
                "v": frames(height // 2, width // 2),
                "mlast": torch.zeros((npix,), dtype=torch.int32,
                                     device=device),
                "ok": [1] * nb, "score": [0] * nb, "frame_in": 0,
                "frame_out": 0, "framesin": 0, "outframes": _F32(0)}

    def _schedule(self, state, sads: List[int]):
        """The ring's state machine over the batch's SADs, on the host
        (the JAX filter's ``lax.scan`` step): per arrival the copies of
        the delayed frame to emit and ``outframes`` after it; the new
        small state."""
        nb, ns = self.num_sample + 1, self.num_sample
        up = self.infps < self.outfps
        inv_in, inv_out = _reciprocal(self.infps), _reciprocal(self.outfps)
        ok, score = list(state["ok"]), list(state["score"])
        fi, fo = state["frame_in"], state["frame_out"]
        framesin, outframes = state["framesin"], state["outframes"]
        copies, outfr = [], []
        for sad in sads:
            ok[fi] = 1
            score[(fi + ns) % nb] = sad       # the previous slot's score
            framesin += 1
            warming = framesin < nb
            tpos = _F32(framesin - 1 - ns)
            order = [(fi + 1 + j) % nb for j in range(nb - 1)]
            if up:
                need = tpos * inv_in > outframes * inv_out
                pick = [score[o] if ok[o] == 1 else -1 for o in order]
                mod = order[pick.index(max(pick))]
                if not warming:
                    outframes = outframes + _F32(2.0 if need else 1.0)
            else:
                need = tpos * inv_in < outframes * inv_out
                pick = [score[o] if ok[o] == 1 else 1 << 30 for o in order]
                mod = order[pick.index(min(pick))]
                if not (warming or need):
                    outframes = outframes + _F32(1.0)
            if need and not warming:
                ok[mod] = 0
            if warming:
                copies.append(0)
            else:
                copies.append(1 if ok[fo] == 1 else (2 if up else 0))
                fo = (fo + 1) % nb
            outfr.append(outframes)
            fi = (fi + 1) % nb
        return copies, outfr, {"ok": ok, "score": score, "frame_in": fi,
                               "frame_out": fo, "framesin": framesin,
                               "outframes": outframes}

    def apply(self, fb: FrameBatch, state: Any) -> Tuple[FrameBatch, Any]:
        if self._plain is not None:
            return self._plain.apply(fb, state)
        ns = self.num_sample
        up = self.infps < self.outfps
        n = fb.batch

        # the delay line: the frame emitted at arrival t is input t - ns
        win = {k: torch.cat([state[k], getattr(fb, k)]) for k in "yuv"}

        # subsampled SADs between consecutive arrivals, read back once
        mv = fb.y.reshape(n, -1)[:, ::self.sub].to(torch.int32)
        mall = torch.cat([state["mlast"][None], mv])
        sads = (mall[1:] - mall[:-1]).abs().sum(dim=1).tolist()
        copies, outfr, small = self._schedule(state, sads)
        new_state = dict(small, mlast=mv[-1],
                         **{k: win[k][n:] for k in "yuv"})

        # the delayed frames with the arrivals' ids and attrs: each
        # emitted once, twice where a clone goes (up) or not at all
        # where a skip goes (down)
        out = dup_batch(
            fb.with_planes(**{k: win[k][:n] for k in "yuv"}),
            2 if up else 1,
            torch.tensor(copies, dtype=torch.int32, device=fb.device),
            self.outfps)
        if up and self.clonetype:
            # fancy_clone merges the emitted frame with the NEXT one
            # (inputs t - ns and t - ns + 1)
            tin = state["framesin"] + 1 + np.arange(n) - ns
            tout = np.asarray(outfr, dtype=np.float32).astype(np.int32) + 1
            merged = self._fancy([win[k][:n] for k in "yuv"],
                                 [win[k][1:n + 1] for k in "yuv"], tin, tout)
            for plane, m in zip(out.planes, merged):
                plane[1::2] = m
        return out, new_state

    # ---- fancy_clone (filter_modfps.c:330-370) ---- #

    @staticmethod
    def _scenechange(src: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
        """yuv_detect_scenechange (filter_modfps.c:129-173) per frame,
        src = next, prev = clone, int32: thresh 14, scenethresh 31, with
        the 8-bit ABS macro (wrong for |d| > 127, kept bit-exact)."""
        h, w = src.shape[1], src.shape[2]

        def abs8(a):
            return (a ^ (a >> 7)) - (a >> 7)

        rows = torch.arange(1, h - 1, device=src.device)
        s = src[:, 1:h - 1]
        odd = (rows & 1).bool().view(1, -1, 1)
        p0 = torch.where(odd, s - src[:, 0:h - 2], s - prev[:, 2:h])
        p1 = s - prev[:, 1:h - 1]
        cnt = ((abs8(p0) > 14) & (abs8(p1) > 14)).sum(dim=(1, 2),
                                                      dtype=torch.int32)
        return (100 * cnt) // (h * w) >= 31

    def _fancy(self, clone, nxt, tin: np.ndarray, tout: np.ndarray):
        """The merged (y, u, v) for every clone row; the caller puts them
        on the duplicate rows."""
        ct = self.clonetype
        (cy, cu, cv), (ny, nu, nv) = clone, nxt
        if ct in (1, 2):
            a, b = (cy, ny) if ct == 1 else (ny, cy)
            m = a.clone()
            m[:, 1::2] = b[:, 1::2]
            # the reference's in-place chroma walk reads the clone's own
            return m, cu, cv
        if ct not in (3, 4, 5):
            return cy, cu, cv   # the reference logs and keeps the copy

        def avg(p, q):
            return ((p.to(torch.int32) + q.to(torch.int32)) >> 1).to(p.dtype)

        scene = self._scenechange(ny.to(torch.int32), cy.to(torch.int32))
        g = scene.view(-1, 1, 1)
        if ct == 3:
            return tuple(torch.where(g, c, avg(c, q))
                         for c, q in zip(clone, nxt))
        if ct == 4:
            # the grid position as the jitted step computes it: XLA
            # folds the division by outfps and the product by infps into
            # one float32 factor
            grid = tout.astype(_F32) * (_reciprocal(self.outfps)
                                        * _F32(self.infps))
            tin32 = tin.astype(_F32)
            w1 = _F32(1.0) - (grid - tin32)
            w2 = _F32(1.0) - (tin32 + _F32(1.0) - grid)
            dev = cy.device
            use_next = torch.from_numpy(w1 < 0).to(dev).view(-1, 1, 1)
            plain = (torch.from_numpy((w2 < 0) | (w1 > 1) | (w2 > 1))
                     .to(dev).view(-1, 1, 1)) | g
            w1t = torch.from_numpy(w1).to(dev).view(-1, 1, 1)
            w2t = torch.from_numpy(w2).to(dev).view(-1, 1, 1)

            def mix(c, q):
                # c * w1 + q * w2 as XLA compiles it: one fused
                # multiply-add, fma(c, w1, round(q * w2)); the product
                # and the sum are exact in float64, so one rounding to
                # float32 gives the fused result; then the C's uchar
                # truncation
                blend = (c.to(torch.float64) * w1t.to(torch.float64)
                         + (q.to(torch.float32) * w2t).to(torch.float64)
                         ).to(torch.float32).to(c.dtype)
                return torch.where(use_next, q, torch.where(plain, c, blend))

            return tuple(mix(c, q) for c, q in zip(clone, nxt))
        lut = torch.from_numpy(_phosphor_lut()).to(cy.device)
        luma = lut[cy.long(), ny.long()]
        return (torch.where(g, cy, luma), torch.where(g, cu, avg(cu, nu)),
                torch.where(g, cv, avg(cv, nv)))
