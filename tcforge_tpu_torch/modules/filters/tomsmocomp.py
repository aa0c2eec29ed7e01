"""tomsmocomp — Tom Barry's motion-compensating deinterlacer, on the card.

The port of ``tcforge_tpu/modules/filters/tomsmocomp.py`` (DScaler's
TomsMoComp).  Per missing line pixel, the best of the bob pair, the
no-motion pair (biased by +1) and the SearchEffort's motion pairs
(previous frame at +d against next frame at -d) wins by the smallest
abs-diff, and is clamped to the bob pair's [min - 4, max + 4] envelope.
Each plane is one launch of ``ops/kernels.py`` ``tomsmocomp_window``.

The filter carries a two-frame window per plane: output j is built
from inputs (j-2, j-1, j), so the first two frames of a stream have no
real window and are marked ``ATTR_SKIPPED``, which the engine drops at
write.  The kernel reads the window from the carried frames and the
batch where they lie (``tomsmocomp_window``); the carry is a copy of
the last two window frames.  ``usevertfilter`` softens the result with
a [1,2,1]/4 vertical pass in plain torch.

``usestrangebob=1`` runs the plain torch version
(``tomsmocomp_plane_ref``) on the card too: the kernel computes only
the default bob, as the JAX package's Pallas kernel does, and the JAX
package also runs its jnp form there.  Its launch counter stays at 0.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from tcforge_tpu_torch.core.formats import ImageFormat
from tcforge_tpu_torch.core.frame import ATTR_SKIPPED, FrameBatch
from tcforge_tpu_torch.core.optstr import ModuleDesc, ParamSpec
from tcforge_tpu_torch.modules.registry import (FilterSlot, ModuleInfo,
                                                ModuleKind, VideoFilter,
                                                register)
from tcforge_tpu_torch.ops import kernels

# the JAX filter's name for the effort table (tomsmocomp.py:43-61); the
# kernel wrapper and the plain version read the same table
_offsets_for_effort = kernels.tmc_offsets


def window_carry(state: torch.Tensor, batch: torch.Tensor) -> torch.Tensor:
    """The last two frames of the window ``state ++ batch``, copied: a
    view could alias an input buffer that the engine reuses."""
    n = batch.shape[0]
    return batch[-2:].clone() if n >= 2 else torch.cat([state[n:], batch])


@register
class TomsMoCompFilter(VideoFilter):
    info = ModuleInfo(name="tomsmocomp", kind=ModuleKind.FILTER)
    desc = ModuleDesc(
        name="tomsmocomp", comment="motion-compensated deinterlace "
        "(TomsMoComp)", version="0.2",
        capabilities="VY",
        params=[ParamSpec("topfirst", "top field first", "d", 1, 0, 1),
                ParamSpec("searcheffort", "motion search effort", "d", 5,
                          0, 15),
                ParamSpec("usestrangebob", "diagonal-aware bob "
                          "(StrangeBob.inc)", "d", 0, 0, 1),
                ParamSpec("usevertfilter", "soften vertically", "d", 0,
                          0, 1),
                ParamSpec("cpuflags", "accepted for compatibility "
                          "(XLA backend replaces CPU detect)", "s", "")])
    slots = FilterSlot.PRE_S

    def init_state(self, width: int, height: int, fmt: ImageFormat,
                   device: torch.device) -> Any:
        if fmt != ImageFormat.YUV420P:
            raise ValueError("tomsmocomp supports YUV420P")

        def zeros(h, w):
            return torch.zeros((2, h, w), dtype=torch.uint8, device=device)
        return {"y": zeros(height, width),
                "u": zeros(height // 2, width // 2),
                "v": zeros(height // 2, width // 2)}

    def apply(self, fb: FrameBatch, state: Any) -> Tuple[FrameBatch, Any]:
        effort = self.options["searcheffort"]
        parity = 0 if self.options["topfirst"] else 1
        vert = bool(self.options["usevertfilter"])
        strange = bool(self.options["usestrangebob"])

        def run_plane(key, batch, luma):
            if strange:
                window = torch.cat([state[key], batch])
                out = kernels.tomsmocomp_plane_ref(
                    window[1:-1], window[:-2], window[2:], parity, effort,
                    True, luma)
            else:
                out = kernels.tomsmocomp_window(state[key], batch, parity,
                                                effort)
            if vert:
                out = out.to(torch.int32)
                up = torch.roll(out, 1, dims=-2)
                dn = torch.roll(out, -1, dims=-2)
                out = ((up + 2 * out + dn + 2) >> 2).clamp_(0, 255) \
                    .to(torch.uint8)
            return out, window_carry(state[key], batch)

        (out_y, new_y), (out_u, new_u), (out_v, new_v) = (
            run_plane("y", fb.y, True), run_plane("u", fb.u, False),
            run_plane("v", fb.v, False))

        # output j is built from inputs (j-2, j-1, j): the first two
        # stream outputs lack a real window and are skipped
        attrs = fb.attrs if fb.attrs is not None else torch.zeros(
            (fb.batch,), dtype=torch.int32, device=fb.device)
        attrs = torch.where(fb.frame_ids < 2, attrs | ATTR_SKIPPED, attrs)
        new_state = {"y": new_y, "u": new_u, "v": new_v}
        out = fb.with_planes(y=out_y, u=out_u, v=out_v).with_attrs(attrs)
        return out, new_state
