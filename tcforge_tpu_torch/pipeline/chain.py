"""Filter-chain execution: job transforms + filters, one batch at a time.

The port of ``tcforge_tpu/pipeline/chain.py`` for the transforms this
slice carries: ``-I`` deinterlace modes 1, 3, 4 and 5 and the ``-Z``
zoom.  Every other internal transform raises ``NotImplementedError``
naming its flag.  ``VideoChain`` keeps the JAX program order (PRE
slots, internal transforms, POST slots) and threads the running
geometry through ``initial_states`` as the JAX chain does, so hqdn3d
(a POST_M filter) runs after the zoom, at the output size.  PyTorch
runs eagerly, so there is no jit segmentation and no host stage.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

import tcforge_tpu_torch.modules  # noqa: F401  (registers the filters)
from tcforge_tpu_torch.core.formats import ImageFormat
from tcforge_tpu_torch.core.frame import FrameBatch
from tcforge_tpu_torch.core.job import Job
from tcforge_tpu_torch.modules.registry import (FilterSlot, ModuleKind,
                                                VideoFilter, new_module)
from tcforge_tpu_torch.ops import video, zoom

_SLOT_ORDER = (FilterSlot.PRE_S, FilterSlot.PRE_M, FilterSlot.POST_M,
               FilterSlot.POST_S)


def _plane_divs(fmt: ImageFormat) -> Tuple[Tuple[int, int], ...]:
    """(width_div, height_div) per plane (set_vtd, video_trans.c:72-110)."""
    sx, sy = fmt.subsampling
    return ((1, 1), (sx, sy), (sx, sy))


def unsupported_flags(job: Job) -> List[str]:
    """The job's active internal transforms that the port lacks so far."""
    checks = (
        ("--pre_clip", bool(job.pre_im_clip)),
        ("-j", bool(job.im_clip)),
        ("-I %d" % job.deinterlace, job.deinterlace not in (0, 1, 3, 4, 5)),
        ("-X/-B", job.resize_up != job.resize_down),
        ("-Y", bool(job.ex_clip)),
        ("-r", job.reduce_w > 1 or job.reduce_h > 1),
        ("--post_clip", bool(job.post_ex_clip)),
        ("-z", job.flip_v),
        ("-l", job.flip_h),
        ("-k", job.rgbswap),
        ("-K", job.decolor),
        ("-G", job.gamma > 0 and job.gamma != 1.0),
        ("-C", job.antialias > 0),
    )
    return [flag for flag, active in checks if active]


def _check_supported(job: Job, fmt: ImageFormat) -> None:
    flags = unsupported_flags(job)
    if flags:
        raise NotImplementedError(
            "not yet ported to tcforge_tpu_torch: " + ", ".join(flags))
    if not fmt.is_planar or fmt != job.im_colorspace:
        raise NotImplementedError(
            f"tcforge_tpu_torch runs planar YUV input in its own "
            f"colorspace only (-V), got {fmt} for {job.im_colorspace}")


def apply_video_trans(job: Job, fb: FrameBatch) -> FrameBatch:
    """process_vid_frame port (video_trans.c:192-460), batched, for the
    transforms of this slice."""
    _check_supported(job, fb.format)
    divs = _plane_divs(fb.format)

    # -I deinterlace
    mode = job.deinterlace
    if mode == 1:          # interpolate Y only (video_trans.c:230-250)
        fb = fb.with_planes(y=video.deint_interpolate(fb.y))
    elif mode in (3, 4):   # drop bottom field (+zoom back for 3)
        planes = [video.deint_drop_field(p) for p in fb.planes]
        if mode == 3:
            w, h = fb.width, fb.height
            planes = [zoom.zoom_plane(p, w // dx, h // dy, job.zoom_filter)
                      for p, (dx, dy) in zip(planes, divs)]
        fb = fb.with_planes(y=planes[0], u=planes[1], v=planes[2])
    elif mode == 5:        # linear blend, Y only
        fb = fb.with_planes(y=video.deint_linear_blend(fb.y))

    # -Z zoom (video_trans.c:300-325)
    if job.zoom_width and job.zoom_height:
        zw, zh = job.zoom_width, job.zoom_height
        y = zoom.zoom_plane(fb.y, zw, zh, job.zoom_filter,
                            interlaced=job.zoom_interlaced)
        # chroma never interlaced (video_trans.c:305-315)
        dx, dy = divs[1]
        u = zoom.zoom_plane(fb.u, zw // dx, zh // dy, job.zoom_filter)
        v = zoom.zoom_plane(fb.v, zw // dx, zh // dy, job.zoom_filter)
        fb = fb.with_planes(y=y, u=u, v=v)
    return fb


class VideoChain:
    """Instantiates the -J filters and runs the per-batch step.

    Filter carry states are explicit inputs and outputs, so temporal
    filters stay exact across batch boundaries."""

    def __init__(self, job: Job, in_format: ImageFormat,
                 width: int, height: int):
        _check_supported(job, in_format)
        self.job = job
        self.in_format = in_format
        self.width, self.height = width, height
        self.filters: List[VideoFilter] = []
        for spec in job.filters:
            mod = new_module(ModuleKind.FILTER, spec.name, job, spec.options)
            if spec.enabled:
                self.filters.append(mod)
        self._by_slot: Dict[FilterSlot, List[int]] = {
            s: [i for i, f in enumerate(self.filters) if f.slots & s]
            for s in _SLOT_ORDER}

    def initial_states(self, device: torch.device) -> List[Any]:
        """Thread the running geometry through the chain in execution
        order (pre slots -> internal transforms -> post slots), so each
        filter's carry matches the frame size it will see."""
        states: List[Any] = [None] * len(self.filters)
        w, h = self.width, self.height
        for slot in (FilterSlot.PRE_S, FilterSlot.PRE_M):
            for i in self._by_slot[slot]:
                states[i] = self.filters[i].init_state(
                    w, h, self.job.im_colorspace, device)
                w, h = self.filters[i].output_size(w, h)
        w, h = self.job.transform_size(w, h, inner=True)
        for slot in (FilterSlot.POST_M, FilterSlot.POST_S):
            for i in self._by_slot[slot]:
                if states[i] is None:
                    states[i] = self.filters[i].init_state(
                        w, h, self.job.im_colorspace, device)
                w, h = self.filters[i].output_size(w, h)
        return states

    def program(self) -> List[Tuple[str, int]]:
        """The chain as a linear op list in execution order: PRE slots,
        internal transforms (index -1), POST slots (chain.py:323-335)."""
        prog: List[Tuple[str, int]] = []
        for slot in (FilterSlot.PRE_S, FilterSlot.PRE_M):
            prog += [("filter", i) for i in self._by_slot[slot]]
        prog.append(("trans", -1))
        for slot in (FilterSlot.POST_M, FilterSlot.POST_S):
            prog += [("filter", i) for i in self._by_slot[slot]]
        return prog

    def __call__(self, fb: FrameBatch,
                 states: List[Any]) -> Tuple[FrameBatch, List[Any]]:
        states = list(states)
        for kind, i in self.program():
            if kind == "filter":
                fb, states[i] = self.filters[i].apply(fb, states[i])
            else:
                fb = apply_video_trans(self.job, fb)
        return fb, states
