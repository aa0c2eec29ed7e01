"""dnr — dynamic noise reduction (temporal pixel locking).

The port of ``tcforge_tpu/modules/filters/dnr.py`` (``filter_dnr.c``):
each pixel is compared with a reference frame through the biased
difference ``max(|int(L[a] - L[b])|, |int(H[a] - H[b])|)`` of the curves
``L = 256(x/256)^0.9`` and ``H = 256(x/256)^(1/0.9)``
(filter_dnr.c:470-505).  Below the lock thresholds the pixel takes the
reference (a lock, with a relock through the average after 30 frames);
below the blend thresholds it takes the average; else it passes and the
reference follows it.  When more than ``sc`` percent of the pixels pass,
the frame is a scene change: it goes out as it came in and the lock
history resets.  Chroma decides at the odd sample of each 2x2 block.

The curves are float32 tables, as the JAX filter's float64 numpy curves
become under ``jnp.asarray`` with x64 off.  The carry is the reference
frame and the per-pixel lock history on the device, and ``init``, a
Python bool: the stream's first frame only seeds the reference, which
the host knows without reading the card.  The scene test stays on the
device (a ``torch.where`` on a 0-d tensor).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Any, Tuple

import numpy as np
import torch

from tcforge_tpu_torch.core.formats import ImageFormat
from tcforge_tpu_torch.core.frame import FrameBatch
from tcforge_tpu_torch.core.optstr import ModuleDesc, ParamSpec
from tcforge_tpu_torch.modules.registry import (FilterSlot, ModuleInfo,
                                                ModuleKind, VideoFilter,
                                                register)


def _bias_curve() -> Tuple[np.ndarray, np.ndarray]:
    x = np.arange(256, dtype=np.float64) / 256.0
    low = 256.0 * np.power(x, 0.9)
    high = 256.0 * np.power(x, 1.0 / 0.9)
    return low.astype(np.float32), high.astype(np.float32)


_LOW, _HIGH = _bias_curve()


@lru_cache(maxsize=None)
def _curves(device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    return (torch.from_numpy(_LOW).to(device),
            torch.from_numpy(_HIGH).to(device))


def diff_metric(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """lookup[a][b] (filter_dnr.c:470-505) from the float32 curves, each
    difference cast to int before abs and max."""
    low, high = _curves(a.device)
    a, b = a.long(), b.long()
    d1 = (low[a] - low[b]).abs().to(torch.int32)
    d2 = (high[a] - high[b]).abs().to(torch.int32)
    return torch.maximum(d1, d2)


def _up2(p: torch.Tensor) -> torch.Tensor:
    return p.repeat_interleave(2, -2).repeat_interleave(2, -1)


@register
class DnrFilter(VideoFilter):
    info = ModuleInfo(name="dnr", kind=ModuleKind.FILTER)
    desc = ModuleDesc(
        name="dnr", comment="dynamic noise reduction", version="0.2",
        capabilities="VRYE",
        params=[ParamSpec("lt", "luma lock threshold", "d", 10, 1, 128),
                ParamSpec("ll", "luma blend threshold", "d", 4, 1, 128),
                ParamSpec("ct", "chroma lock threshold", "d", 16, 1, 128),
                ParamSpec("cl", "chroma blend threshold", "d", 8, 1, 128),
                ParamSpec("sc", "scene change percent", "d", 30, 1, 90)])
    slots = FilterSlot.POST_M

    def init_state(self, width: int, height: int, fmt: ImageFormat,
                   device: torch.device) -> Any:
        if fmt != ImageFormat.YUV420P:
            raise ValueError("dnr (TPU build) supports YUV420P")

        def z(h, w):
            return torch.zeros((h, w), dtype=torch.int32, device=device)
        return {"init": False, "y": z(height, width),
                "u": z(height // 2, width // 2),
                "v": z(height // 2, width // 2), "hist": z(height, width)}

    def _step(self, st, y, u, v, tot_scene: int):
        """One frame after the first: (new carry, output planes)."""
        o = self.options
        lock_l, thresh_l = o["ll"], o["lt"]
        lock_c, thresh_c = o["cl"], o["ct"]
        ry2, gu2, bv2 = st["y"], st["u"], st["v"]
        t_y = diff_metric(y, ry2)
        t_uf = _up2(diff_metric(u, gu2))
        t_vf = _up2(diff_metric(v, bv2))
        locked = (t_y < lock_l) & (t_uf < lock_c) & (t_vf < lock_c)
        blend = (~locked & (t_y < thresh_l) & (t_uf < thresh_c)
                 & (t_vf < thresh_c))
        passthru = ~locked & ~blend
        hist = st["hist"]
        relock = locked & (hist > 30)
        new_hist = torch.where(locked & ~relock, hist + 1, 0)

        def select(cur, ref):
            avg = (cur + ref) // 2
            return torch.where(relock, avg, torch.where(
                locked, ref, torch.where(blend, avg, cur)))

        out_y = select(y, ry2)
        out_u = select(_up2(u), _up2(gu2))[1::2, 1::2]
        out_v = select(_up2(v), _up2(bv2))[1::2, 1::2]
        upd = new_hist == 0
        ref_y = torch.where(upd, out_y, ry2)
        ref_u = torch.where(upd[1::2, 1::2], out_u, gu2)
        ref_v = torch.where(upd[1::2, 1::2], out_v, bv2)
        scene = passthru.sum() > tot_scene
        out_y = torch.where(scene, y, out_y)
        out_u = torch.where(scene, u, out_u)
        out_v = torch.where(scene, v, out_v)
        new = {"init": True, "y": torch.where(scene, y, ref_y),
               "u": torch.where(scene, u, ref_u),
               "v": torch.where(scene, v, ref_v),
               "hist": torch.where(scene, 0, new_hist)}
        return new, (out_y, out_u, out_v)

    def apply(self, fb: FrameBatch, state: Any) -> Tuple[FrameBatch, Any]:
        tot_scene = fb.height * fb.width * self.options["sc"] // 100
        planes = [p.to(torch.int32) for p in (fb.y, fb.u, fb.v)]
        outs = ([], [], [])
        st = state
        for i in range(fb.batch):
            y, u, v = (p[i] for p in planes)
            if not st["init"]:
                st = {"init": True, "y": y, "u": u, "v": v,
                      "hist": torch.zeros_like(st["hist"])}
                frame = (y, u, v)
            else:
                st, frame = self._step(st, y, u, v, tot_scene)
            for acc, p in zip(outs, frame):
                acc.append(p)
        y, u, v = (torch.stack(acc).to(torch.uint8) for acc in outs)
        return fb.with_planes(y=y, u=u, v=v), st
