"""smooth — single-frame chroma-guided luma smoothing.

The port of ``tcforge_tpu/modules/filters/smooth.py``
(``filter_smooth.c``): a horizontal then a vertical pass; each luma
pixel folds in its neighbours at distance 1..range one by one,
``nval = nval*(1-ratio) + neighbor*ratio`` with ``ratio =
strength/distance``, wherever the chroma difference (|dCr| + |dCb|) stays
under ``cdiff`` and the luma difference under ``ldiff``; the result
rounds as ``floor(nval + 0.5)``.  Defaults: strength 0.25, cdiff 6,
ldiff 8, range 4.  Chroma is indexed at 4:2:0 sites as the JAX filter
indexes it (not the reference's out-of-plane read).

The fold is float32.  The JAX engine runs the filter under ``jax.jit``,
where XLA's CPU code generator contracts the fold into one fused
multiply-add over the neighbour's product,
``fma(neighbor, ratio, nval*(1-ratio))`` (found against the jitted
filter element by element; the contraction it picks depends on the
compiled program: a single pass compiled alone fuses nval's product in
its vertical pass).  The port computes that form: the product and the
sum are exact in float64 for these operands, so one rounding of the
float64 sum to float32 is the fused result.
"""

from __future__ import annotations

from typing import Any, Tuple

import numpy as np
import torch

from tcforge_tpu_torch.core.frame import FrameBatch
from tcforge_tpu_torch.core.optstr import ModuleDesc, ParamSpec
from tcforge_tpu_torch.modules.registry import (FilterSlot, ModuleInfo,
                                                ModuleKind, VideoFilter,
                                                register)


def _fold(nval: torch.Tensor, neighbor: torch.Tensor,
          ratio: float) -> torch.Tensor:
    """float32 ``fma(neighbor, f32(ratio), nval * f32(1-ratio))``."""
    keep = float(np.float32(1 - ratio))
    take = float(np.float32(ratio))
    return (neighbor.double() * take + (nval * keep).double()).float()


def _smooth_pass(y: torch.Tensor, cr_full: torch.Tensor,
                 cb_full: torch.Tensor, dim: int, strength: float,
                 cdiff: int, ldiff: int, rng: int) -> torch.Tensor:
    """One directional pass over (N, H, W) uint8 luma along ``dim``;
    ``cr_full``/``cb_full`` are float32 chroma at luma resolution."""
    orig = y.to(torch.float32)
    nval = orig
    size = y.shape[dim]
    shape = [1] * y.dim()
    shape[dim] = size
    idx = torch.arange(size, device=y.device).view(shape)
    for off in [o for o in range(-rng, rng + 1) if o != 0]:
        neighbor = torch.roll(orig, -off, dims=dim)
        n_cr = torch.roll(cr_full, -off, dims=dim)
        n_cb = torch.roll(cb_full, -off, dims=dim)
        valid = (idx + off >= 0) & (idx + off < size)
        cd = ((cr_full - n_cr).abs() + (cb_full - n_cb).abs()) < cdiff
        ld = (neighbor - orig).abs() < ldiff
        nval = torch.where(valid & cd & ld,
                           _fold(nval, neighbor, strength / abs(off)), nval)
    return torch.floor(nval + 0.5).to(torch.uint8)


@register
class SmoothFilter(VideoFilter):
    info = ModuleInfo(name="smooth", kind=ModuleKind.FILTER)
    desc = ModuleDesc(
        name="smooth", comment="single-frame denoise/smooth",
        version="0.2.3", capabilities="VY",
        params=[ParamSpec("strength", "blending factor", "f", 0.25, 0.0,
                          0.9),
                ParamSpec("cdiff", "max UV difference", "d", 6, 0, 255),
                ParamSpec("ldiff", "max Y difference", "d", 8, 0, 255),
                ParamSpec("range", "search range", "d", 4, 1, 16)])
    slots = FilterSlot.POST_M

    def apply(self, fb: FrameBatch, state: Any) -> Tuple[FrameBatch, Any]:
        if fb.rgb is not None:
            raise ValueError("smooth is YUV-only (filter_smooth.c:190)")
        s = min(0.9, self.options["strength"])
        cd, ld, rng = (self.options["cdiff"], self.options["ldiff"],
                       self.options["range"])
        sx, sy = fb.format.subsampling
        cb = fb.u.to(torch.float32).repeat_interleave(sy, -2) \
            .repeat_interleave(sx, -1)
        cr = fb.v.to(torch.float32).repeat_interleave(sy, -2) \
            .repeat_interleave(sx, -1)
        y = _smooth_pass(fb.y, cr, cb, 2, s, cd, ld, rng)
        y = _smooth_pass(y, cr, cb, 1, s, cd, ld, rng)
        return fb.with_planes(y=y), state
