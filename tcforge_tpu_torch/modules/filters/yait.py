"""yait — Yet Another Inverse Telecine (two passes, external analyzer).

The port of ``tcforge_tpu/modules/filters/yait.py`` (``filter_yait.c``):

- ``yait=log[=file]`` (pass 1): per frame, the even-row and odd-row sums
  of absolute differences against the previous input frame, luma plus
  the U and V planes stacked as one block of rows (yait_cmp_yuv), for
  the ``tcyait`` analyzer; frame 0 compares with itself.  The only
  reference is the previous *input* frame, so a batch is one
  computation with the carried frame in front; ``collect`` reads the
  batch's deltas back once and ``finalize`` writes the log.
- ``yait=ops[=file]`` (pass 2): the per-frame operations of an ops file,
  indexed by frame id on the device: save the even or odd rows into a
  one-frame buffer ('s'), copy them back out ('c'), drop the frame
  ('d', ATTR_SKIPPED), deinterlace ('5' linear blend, '1'-'4'
  interpolate).  The buffer is a sequential carry, so the frames of a
  batch run in turn.

Import runs at NTSC video rate and export at NTSC film rate; the job's
rates are set as the JAX filter sets them.
"""

from __future__ import annotations

import logging
from typing import Any, List, Tuple

import numpy as np
import torch

from tcforge_tpu_torch.core.formats import ImageFormat
from tcforge_tpu_torch.core.frame import ATTR_SKIPPED, FrameBatch
from tcforge_tpu_torch.core.optstr import ModuleDesc, ParamSpec
from tcforge_tpu_torch.modules.registry import (FilterSlot, ModuleInfo,
                                                ModuleKind, VideoFilter,
                                                register)
from tcforge_tpu_torch.ops import video as vops

_log = logging.getLogger("tcforge_tpu_torch")

Y_LOG_FN = "yait.log"
Y_OPS_FN = "yait.ops"

NTSC_VIDEO = 30000 / 1001
NTSC_FILM = 24000 / 1001

_OP_KEYS = ("save", "copy", "drop", "even", "deint")


def parse_ops_file(path: str) -> List[Tuple[int, str]]:
    """Read and validate a .ops file (yait_ops_chk/yait_ops_get,
    filter_yait.c:560-646)."""
    ops = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            head, _, body = line.partition(":")
            fn = int(head)
            s = body.strip()
            for c in s:
                if c not in "oescd12345":
                    raise ValueError(f"invalid yait ops code {c!r} at "
                                     f"frame {fn}")
            ops.append((fn, s))
    if not ops:
        raise ValueError("empty yait ops file")
    start = ops[0][0]
    for k, (fn, _) in enumerate(ops):
        if fn != start + k:
            raise ValueError(f"invalid yait ops frame number {fn}")
    return ops


def ops_to_arrays(ops: List[Tuple[int, str]]) -> dict:
    """Per-frame op arrays: save/copy/drop flags, even-pattern flag,
    deinterlace mode (0 = none)."""
    n = len(ops)
    out = {k: np.zeros(n, np.int32) for k in _OP_KEYS}
    for i, (_, s) in enumerate(ops):
        for key, code in (("even", "e"), ("save", "s"), ("copy", "c"),
                          ("drop", "d")):
            if code in s:
                out[key][i] = 1
        for c in s:
            if c in "12345":
                out["deint"][i] = int(c)
    return out


def _row_mask(rows: int, even: torch.Tensor) -> torch.Tensor:
    """(rows, 1) bool: the rows of the parity an op names (even when
    ``even`` is 1, odd otherwise)."""
    parity = torch.arange(rows, device=even.device)[:, None] % 2
    return torch.where(even == 1, parity == 0, parity == 1)


@register
class YaitFilter(VideoFilter):
    info = ModuleInfo(name="yait", kind=ModuleKind.FILTER)
    desc = ModuleDesc(
        name="yait", comment="yet another inverse telecine",
        version="0.1.1", capabilities="VRYE",
        params=[ParamSpec("log", "write row-delta log file", "s", ""),
                ParamSpec("ops", "apply frame operations file", "s", "")])
    slots = FilterSlot.PRE_S

    def __init__(self, job, options: str = ""):
        super().__init__(job, options)
        raw = options or ""
        # a bare `log` / `ops` (no value) selects the default file name
        keys = {p.split("=")[0] for p in raw.split(":") if p}
        has_log, has_ops = "log" in keys, "ops" in keys
        if has_log == has_ops:
            raise ValueError("yait: exactly one of log/ops must be given")
        self.log_fn = (self.options["log"] or Y_LOG_FN) if has_log else None
        self.ops_fn = (self.options["ops"] or Y_OPS_FN) if has_ops else None
        self._deltas: List[Tuple[int, int, int]] = []
        self._n = 0
        if self.ops_fn:
            self._ops = ops_to_arrays(parse_ops_file(self.ops_fn))
            # import locked at 30 fps, export at 24 (filter_yait.c:311-330)
            job.ex_fps = NTSC_FILM
        else:
            self._ops = None
            job.ex_fps = NTSC_VIDEO
        job.fps = job.fps or NTSC_VIDEO

    def init_state(self, width: int, height: int, fmt: ImageFormat,
                   device: torch.device) -> Any:
        """The previous frame (log) or the row buffer (ops) as uint8
        planes, and ``init``, a host bool."""
        if fmt != ImageFormat.YUV420P:
            raise ValueError("yait needs YUV420P input (-V)")

        def z(h, w):
            return torch.zeros((h, w), dtype=torch.uint8, device=device)
        st = {"init": False, "y": z(height, width),
              "u": z(height // 2, width // 2),
              "v": z(height // 2, width // 2)}
        if self.log_fn:
            st["ed"] = torch.zeros((1,), dtype=torch.int32, device=device)
            st["od"] = torch.zeros((1,), dtype=torch.int32, device=device)
            st["ids"] = torch.full((1,), -1, dtype=torch.int32,
                                   device=device)
        return st

    # ---- pass 1: row deltas ------------------------------------------

    def _apply_log(self, fb: FrameBatch, state: Any):
        planes = (fb.y, fb.u, fb.v)
        # each frame's previous input frame: the carried one, or frame 0
        # itself at the start of the stream
        first = [state[k] if state["init"] else p[0]
                 for k, p in zip("yuv", planes)]
        prev = [torch.cat([f[None], p[:-1]]) for f, p in zip(first, planes)]
        dy = (fb.y.to(torch.int32) - prev[0].to(torch.int32)).abs()
        uv = torch.cat([fb.u, fb.v], dim=1).to(torch.int32)
        puv = torch.cat([prev[1], prev[2]], dim=1).to(torch.int32)
        duv = (uv - puv).abs()

        def rows(d, start):
            return d[:, start::2].sum(dim=(1, 2), dtype=torch.int32)
        new = {"init": True, "y": fb.y[-1], "u": fb.u[-1], "v": fb.v[-1],
               "ed": rows(dy, 0) + rows(duv, 0),
               "od": rows(dy, 1) + rows(duv, 1),
               "ids": (fb.frame_ids if fb.frame_ids is not None
                       else torch.zeros((fb.batch,), dtype=torch.int32,
                                        device=fb.device))}
        return fb, new

    # ---- pass 2: frame ops -------------------------------------------

    def _apply_ops(self, fb: FrameBatch, state: Any):
        dev = fb.device
        n_ops = len(self._ops["save"])
        ids = (fb.frame_ids if fb.frame_ids is not None
               else torch.arange(fb.batch, dtype=torch.int32, device=dev))
        idx = ids.clamp(0, n_ops - 1).long()
        in_range = ids < n_ops
        op = {k: torch.where(in_range,
                             torch.from_numpy(self._ops[k]).to(dev)[idx], 0)
              for k in _OP_KEYS}
        by, bu, bv = state["y"], state["u"], state["v"]
        hc = fb.u.shape[1]
        outs = ([], [], [])
        for i in range(fb.batch):
            y = fb.y[i]
            uv = torch.cat([fb.u[i], fb.v[i]])
            buv = torch.cat([bu, bv])
            ev = op["even"][i]
            my = _row_mask(y.shape[0], ev)
            muv = _row_mask(uv.shape[0], ev)
            save, copy, dm = op["save"][i] == 1, op["copy"][i] == 1, \
                op["deint"][i]
            # 's': the buffer's rows of that parity take the frame's;
            # 'c': the frame's rows take the buffer's
            new_by = torch.where(save & my, y, by)
            new_buv = torch.where(save & muv, uv, buv)
            oy = torch.where(copy & my, by, y)
            ouv = torch.where(copy & muv, buv, uv)
            oy = torch.where(dm == 0, oy, torch.where(
                dm == 5, vops.deint_linear_blend(oy[None])[0],
                vops.deint_interpolate(oy[None])[0]))
            by, bu, bv = new_by, new_buv[:hc], new_buv[hc:]
            for acc, p in zip(outs, (oy, ouv[:hc], ouv[hc:])):
                acc.append(p)
        attrs = (fb.attrs if fb.attrs is not None
                 else torch.zeros((fb.batch,), dtype=torch.int32, device=dev))
        attrs = torch.where(op["drop"] == 1, attrs | ATTR_SKIPPED, attrs)
        ys, us, vs = (torch.stack(acc) for acc in outs)
        out = FrameBatch(format=fb.format, y=ys, u=us, v=vs, attrs=attrs,
                         frame_ids=fb.frame_ids, fps=NTSC_FILM)
        return out, {"init": True, "y": by, "u": bu, "v": bv}

    def apply(self, fb: FrameBatch, state: Any) -> Tuple[FrameBatch, Any]:
        if self.log_fn:
            return self._apply_log(fb, state)
        return self._apply_ops(fb, state)

    # ---- host side ----------------------------------------------------

    def collect(self, state: Any) -> None:
        if self.log_fn is None:
            return
        eds, ods, ids = (state[k].cpu().numpy() for k in ("ed", "od", "ids"))
        for e, o, fid in zip(eds, ods, ids):
            if fid < 0:
                continue                   # padding
            self._deltas.append((self._n, int(e), int(o)))
            self._n += 1

    def finalize(self, state: Any) -> None:
        if self.log_fn is None:
            return
        with open(self.log_fn, "w") as f:
            for fn, e, o in self._deltas:
                f.write(f"{fn}: e: {e}, o: {o}\n")
        _log.info("[yait] wrote %d row-delta records to %s",
                  len(self._deltas), self.log_fn)
