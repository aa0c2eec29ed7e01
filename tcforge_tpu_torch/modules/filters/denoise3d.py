"""denoise3d — 3D denoiser (8-bit precision variant), on the card.

The port of ``tcforge_tpu/modules/filters/denoise3d.py``
(``filter_denoise3d.c``): the horizontal, vertical and temporal
low-pass cascade of hqdn3d in plain uint8-domain arithmetic with a
512-entry coefficient table, ``LowPass(prev, curr) = curr + C[prev -
curr + 256]``.  The temporal pass is an IIR on the *output* frame: its
carry across batches is the previous output frame of each plane,
zero at the start, so the first frame is filtered against black
(filter_denoise3d.c:377).  Per plane, three launches: ``ops/kernels.py``
``d3_spatial_scan`` along W, then along H, then ``d3_temporal_scan``.

Defaults: luma/chroma spatial 4/3, luma/chroma temporal 6/4.  YUV420P,
YUV422P and RGB24, whose three channels all go through the luma tables
(each a contiguous copy of its channel, with its own (H, W) slice of
the (H, W, 3) int32 carry).  ``nonative`` is accepted and
ignored: it turns off the JAX package's CPU fast path, which the port
does not have.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import numpy as np
import torch

from tcforge_tpu_torch.core.formats import ImageFormat
from tcforge_tpu_torch.core.frame import FrameBatch
from tcforge_tpu_torch.core.optstr import ModuleDesc, ParamSpec
from tcforge_tpu_torch.modules.registry import (FilterSlot, ModuleInfo,
                                                ModuleKind, VideoFilter,
                                                register)
from tcforge_tpu_torch.ops import kernels


def precalc_coefs(dist25: float) -> np.ndarray:
    """PrecalcCoefs port (filter_denoise3d.c:187-199): 512-entry int
    table over i in [-256, 255]."""
    gamma = math.log(0.25) / math.log(1.0 - dist25 / 255.0)
    i = np.arange(-256, 256, dtype=np.float64)
    simil = np.maximum(0.0, 1.0 - np.abs(i) / 255.0)
    c = np.power(simil, gamma) * i
    return np.where(c < 0, c - 0.5, c + 0.5).astype(np.int32)


def denoise_plane(frames: torch.Tensor, prev: torch.Tensor,
                  spatial: torch.Tensor, temporal: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, H, W) uint8 batch + int32 (H, W) previous-output carry ->
    (filtered uint8 batch, new carry); ``spatial`` and ``temporal`` are
    the int32 tables on the planes' device."""
    h = kernels.d3_spatial_scan(frames, spatial, axis=-1)
    v = kernels.d3_spatial_scan(h, spatial, axis=-2)
    return kernels.d3_temporal_scan(v, prev, temporal)


@register
class Denoise3dFilter(VideoFilter):
    info = ModuleInfo(name="denoise3d", kind=ModuleKind.FILTER)
    desc = ModuleDesc(
        name="denoise3d", comment="3D Denoiser (variable lowpass filter)",
        version="1.0.6", capabilities="VRYMOE",
        params=[
            ParamSpec("luma", "spatial luma strength", "f", 4.0, 0.0, 100.0),
            ParamSpec("chroma", "spatial chroma strength", "f", 3.0, 0.0,
                      100.0),
            ParamSpec("luma_strength", "temporal luma strength", "f", 6.0,
                      0.0, 100.0),
            ParamSpec("chroma_strength", "temporal chroma strength", "f",
                      4.0, 0.0, 100.0),
            ParamSpec("pre", "run as a pre filter", "d", 0, 0, 1),
            ParamSpec("nonative", "disable the C++ CPU fast path", "d",
                      0, 0, 1)])
    slots = FilterSlot.POST_M

    def __init__(self, job, options: str = ""):
        super().__init__(job, options)
        self._np_luts = tuple(precalc_coefs(self.options[k]) for k in (
            "luma", "luma_strength", "chroma", "chroma_strength"))
        self._luts: Dict[torch.device, Tuple[torch.Tensor, ...]] = {}
        if self.options["pre"]:
            self.slots = FilterSlot.PRE_M

    def luts(self, device: torch.device) -> Tuple[torch.Tensor, ...]:
        """(luma spatial, luma temporal, chroma spatial, chroma
        temporal) coefficient tables on ``device``, copied once."""
        if device not in self._luts:
            self._luts[device] = tuple(torch.from_numpy(t).to(device)
                                       for t in self._np_luts)
        return self._luts[device]

    def init_state(self, width: int, height: int, fmt: ImageFormat,
                   device: torch.device) -> Any:
        if fmt not in (ImageFormat.YUV420P, ImageFormat.YUV422P,
                       ImageFormat.RGB24):
            raise ValueError("denoise3d supports YUV420P/YUV422P/RGB24")
        if fmt == ImageFormat.RGB24:
            return {"rgb": torch.zeros((height, width, 3),
                                       dtype=torch.int32, device=device)}
        uh, uw = fmt.uv_plane_shape(width, height)

        def zeros(h, w):
            return torch.zeros((h, w), dtype=torch.int32, device=device)
        return {"y": zeros(height, width), "u": zeros(uh, uw),
                "v": zeros(uh, uw)}

    def apply(self, fb: FrameBatch, state: Any) -> Tuple[FrameBatch, Any]:
        ls, lt, cs, ct = self.luts(fb.device)
        if fb.rgb is not None:
            chans, carries = zip(*(
                denoise_plane(fb.rgb[..., c].contiguous(),
                              state["rgb"][..., c].contiguous(), ls, lt)
                for c in range(3)))
            return (fb.with_planes(rgb=torch.stack(chans, dim=-1)),
                    {"rgb": torch.stack(carries, dim=-1)})
        y, prev_y = denoise_plane(fb.y, state["y"], ls, lt)
        u, prev_u = denoise_plane(fb.u, state["u"], cs, ct)
        v, prev_v = denoise_plane(fb.v, state["v"], cs, ct)
        return (fb.with_planes(y=y, u=u, v=v),
                {"y": prev_y, "u": prev_u, "v": prev_v})
