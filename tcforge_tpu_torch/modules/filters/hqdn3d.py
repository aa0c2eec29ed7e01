"""hqdn3d — high-quality 3D (spatio-temporal) denoiser, on the card.

The port of ``tcforge_tpu/modules/filters/hqdn3d.py`` (Daniel Moreno's
``filter_hqdn3d.c``).  Per plane, three cascaded nonlinear IIR
low-passes, each one kernel launch:

    H[y, 0] = F<<16;  H[y, x] = lpm(H[y, x-1], F[y, x]<<16, spatial)
    V[0, x] = H[0, x]; V[y, x] = lpm(V[y-1, x], H[y, x], spatial)
    D[n]    = lpm(FrameAnt<<8, V[n], temporal); FrameAnt' = round8(D)

with ``lpm(prev, curr, C) = curr + C[(prev - curr + 0x10007FF) >> 12]``
and C the exact 8192-entry PrecalcCoefs table.  FrameAnt, the 16-bit
temporal accumulator of each plane, is the filter's carry across
batches.  The JAX package's closed-form ``pow`` curve and its ``±1``
table corrections exist only for the TPU and are not ported.
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

PARAM1_DEFAULT = 4.0     # luma spatial
PARAM2_DEFAULT = 3.0     # chroma spatial
PARAM3_DEFAULT = 6.0     # luma temporal


def precalc_coefs(dist25: float) -> np.ndarray:
    """PrecalcCoefs port (filter_hqdn3d.c:120-133), float64 like C."""
    gamma = math.log(0.25) / math.log(1.0 - dist25 / 255.0 - 0.00001)
    i = np.arange(-256 * 16, 256 * 16, dtype=np.float64)
    # |i| > 4080 entries are unreachable (LowPassMul index range is
    # [16, 8176] for valid uint8 inputs); clamp simil to avoid NaN pow.
    simil = np.maximum(0.0, 1.0 - np.abs(i) / (16 * 255.0))
    c = np.power(simil, gamma) * 65536.0 * i / 16.0
    out = np.where(c < 0, c - 0.5, c + 0.5)
    return out.astype(np.int32)


def denoise_plane(frames: torch.Tensor, frame_ant: torch.Tensor,
                  spatial: torch.Tensor, temporal: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The hqdn3d cascade over a (N, H, W) uint8 plane batch with the
    int32 (H, W) FrameAnt of the previous batch; returns the denoised
    uint8 batch and the new FrameAnt.  ``spatial`` and ``temporal`` are
    the int32 coefficient tables on the planes' device."""
    h = kernels.spatial_scan(frames, spatial, axis=-1)
    v = kernels.spatial_scan(h, spatial, axis=-2)
    return kernels.temporal_scan(v, frame_ant, temporal)


@register
class Hqdn3dFilter(VideoFilter):
    info = ModuleInfo(name="hqdn3d", kind=ModuleKind.FILTER)
    desc = ModuleDesc(
        name="hqdn3d", comment="High Quality 3D Denoiser",
        version="1.0.2",
        capabilities="VYMOE",
        params=[
            ParamSpec("luma", "spatial luma strength", "f", 0.0, 0.0, 100.0),
            ParamSpec("chroma", "spatial chroma strength", "f", 0.0, 0.0,
                      100.0),
            ParamSpec("luma_strength", "temporal luma strength", "f", 0.0,
                      0.0, 100.0),
            ParamSpec("chroma_strength", "temporal chroma strength", "f",
                      0.0, 0.0, 100.0),
            ParamSpec("pre", "run as a pre filter", "d", 0, 0, 1),
            # accepted for option-string parity with the JAX filter;
            # the port always runs the exact table
            ParamSpec("exact", "bit-exact LUT coefficients (slower)", "d",
                      0, 0, 1),
            ParamSpec("nonative", "disable the C++ CPU fast path", "d",
                      0, 0, 1)])
    slots = FilterSlot.POST_M

    def __init__(self, job, options: str = ""):
        super().__init__(job, options)
        # default/override cascade exactly as filter_hqdn3d.c:218-260
        lum_spac, lum_tmp = PARAM1_DEFAULT, PARAM3_DEFAULT
        chrom_spac = PARAM2_DEFAULT
        chrom_tmp = lum_tmp * chrom_spac / lum_spac
        p1 = self.options["luma"]
        p2 = self.options["chroma"]
        p3 = self.options["luma_strength"]
        p4 = self.options["chroma_strength"]
        if p1:
            lum_spac = p1
            lum_tmp = PARAM3_DEFAULT * p1 / PARAM1_DEFAULT
            chrom_spac = PARAM2_DEFAULT * p1 / PARAM1_DEFAULT
            chrom_tmp = lum_tmp * chrom_spac / lum_spac
        if p2:
            chrom_spac = p2
            chrom_tmp = lum_tmp * chrom_spac / lum_spac
        if p3:
            lum_tmp = p3
            chrom_tmp = lum_tmp * chrom_spac / lum_spac
        if p4:
            chrom_tmp = p4
        self.strengths = (lum_spac, lum_tmp, chrom_spac, chrom_tmp)
        self._np_luts = tuple(precalc_coefs(s) for s in self.strengths)
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
        if fmt != ImageFormat.YUV420P:
            raise ValueError("hqdn3d only supports YUV420P "
                             "(filter_hqdn3d.c:200)")
        # FrameAnt is seeded from the first frame on the first batch
        def zeros(h, w):
            return torch.zeros((h, w), dtype=torch.int32, device=device)
        return {"init": torch.zeros((), dtype=torch.bool, device=device),
                "y": zeros(height, width),
                "u": zeros(height // 2, width // 2),
                "v": zeros(height // 2, width // 2)}

    def apply(self, fb: FrameBatch, state: Any) -> Tuple[FrameBatch, Any]:
        ls, lt, cs, ct = self.luts(fb.device)

        def run(planes, ant, spatial, temporal):
            # reference seeds FrameAnt = first_frame << 8
            # (filter_hqdn3d.c:70-77) when no history exists yet
            ant = torch.where(state["init"], ant,
                              planes[0].to(torch.int32) << 8)
            return denoise_plane(planes, ant, spatial, temporal)

        y, ant_y = run(fb.y, state["y"], ls, lt)
        u, ant_u = run(fb.u, state["u"], cs, ct)
        v, ant_v = run(fb.v, state["v"], cs, ct)
        new_state = {"init": torch.ones((), dtype=torch.bool,
                                        device=fb.device),
                     "y": ant_y, "u": ant_u, "v": ant_v}
        return fb.with_planes(y=y, u=u, v=v), new_state
