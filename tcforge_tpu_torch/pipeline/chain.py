"""Filter-chain execution: job transforms + filters, one batch at a time.

The port of ``tcforge_tpu/pipeline/chain.py``: the filter slots around
the internal transform chain of ``video_trans.c`` (the "jIXBZYrzlkKGC"
order: -j clip, -I deinterlace, -X/-B fast resize, -Z zoom, -Y clip,
-r reduce, -z flip, -l mirror, -k rgbswap, -K grayscale, -G gamma,
-C antialias), on planar YUV and on RGB batches.  ``-I 2`` does
nothing here, as in the JAX chain (its motion-adaptive deinterlacer is
the ``smartdeinter`` filter, which ``-J`` names).  ``VideoChain`` keeps
the JAX program order
(entry conversion to ``job.im_colorspace`` and --pre_clip, PRE slots,
internal transforms, POST slots, --post_clip) and threads the running
geometry through ``initial_states`` as the JAX chain does, so hqdn3d
(a POST_M filter) runs after the zoom, at the output size.  PyTorch
runs eagerly, so there is no jit segmentation and no host stage.

``AudioChain`` is the JAX ``AudioChain`` (chain.py:420-559): ``-s``
volume and ``-d`` channels, ``-E``'s exact streaming resampler (the JAX
package's host stage, numpy) and the ``-J`` audio filters in their
order, on the job's device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

import tcforge_tpu_torch.modules  # noqa: F401  (registers the filters)
from tcforge_tpu_torch.core.formats import ImageFormat
from tcforge_tpu_torch.core.frame import (AudioBatch, FrameBatch,
                                          host_to_device)
from tcforge_tpu_torch.core.job import Job
from tcforge_tpu_torch.modules.registry import (AudioFilter, FilterSlot,
                                                ModuleKind, VideoFilter,
                                                new_module)
from tcforge_tpu_torch.ops import audio as audio_ops
from tcforge_tpu_torch.ops import colorspace, video, zoom

_SLOT_ORDER = (FilterSlot.PRE_S, FilterSlot.PRE_M, FilterSlot.POST_M,
               FilterSlot.POST_S)


def _plane_divs(fmt: ImageFormat) -> Tuple[Tuple[int, int], ...]:
    """(width_div, height_div) per plane (set_vtd, video_trans.c:72-110)."""
    if fmt.is_planar:
        sx, sy = fmt.subsampling
        return ((1, 1), (sx, sy), (sx, sy))
    return ((1, 1),)


def _black(fmt: ImageFormat) -> Tuple[int, ...]:
    """black_pixel per plane: 0 for Y/RGB, 128 for chroma
    (video_trans.c:86,93)."""
    if fmt.is_planar:
        return (0, 128, 128)
    return (0,)


def _with_yuv(fb: FrameBatch, planes: Sequence[torch.Tensor]) -> FrameBatch:
    """``fb`` with its one to three planes replaced, luma first."""
    return fb.with_planes(y=planes[0],
                          u=planes[1] if len(planes) > 1 else None,
                          v=planes[2] if len(planes) > 2 else None)


def _on_planes(fb: FrameBatch, op: Callable[..., torch.Tensor],
               args: Sequence[Tuple] = ((),)) -> FrameBatch:
    """Run a plane op over the batch: on an RGB batch channel-first,
    (N, C, H, W), with ``args[0]``; else on every plane with its own
    ``args`` entry (the last one again where the planes outnumber them)."""
    if fb.rgb is not None:
        out = op(torch.movedim(fb.rgb, -1, 1), *args[0])
        return fb.with_planes(rgb=torch.movedim(out, 1, -1).contiguous())
    return _with_yuv(fb, [op(p, *args[min(i, len(args) - 1)])
                          for i, p in enumerate(fb.planes)])


def apply_clip(fb: FrameBatch, clip: Tuple[int, int, int, int]) -> FrameBatch:
    """One clip stage (tcv_clip semantics; negative values grow with
    black/neutral border) on a batch in either representation."""
    t, l, b, r = clip
    if fb.rgb is not None:
        return fb.with_planes(rgb=video.clip_rgb(fb.rgb, t, l, b, r, 0))
    return _on_planes(fb, video.clip, [
        (t // dy, l // dx, b // dy, r // dx, blk)
        for (dx, dy), blk in zip(_plane_divs(fb.format), _black(fb.format))])


def apply_video_trans(job: Job, fb: FrameBatch) -> FrameBatch:
    """process_vid_frame port (video_trans.c:192-460), batched."""
    divs = _plane_divs(fb.format)
    is_rgb = fb.rgb is not None

    # -j import clip
    if job.im_clip:
        fb = apply_clip(fb, job.im_clip)

    # -I deinterlace
    mode = job.deinterlace
    if mode in (1, 5):     # interpolate / linear blend, Y only
        deint = (video.deint_interpolate if mode == 1
                 else video.deint_linear_blend)
        if is_rgb:
            fb = _on_planes(fb, deint)
        else:
            fb = fb.with_planes(y=deint(fb.y))
    elif mode in (3, 4):   # drop bottom field (+zoom back for 3)
        w, h = fb.width, fb.height
        fb = _on_planes(fb, video.deint_drop_field)
        if mode == 3:
            fb = _on_planes(fb, zoom.zoom_plane, [
                (w // dx, h // dy, job.zoom_filter) for dx, dy in divs])
    # mode 2 is the smartdeinter filter's, which -J names: nothing here

    # -X / -B fast resize (video_trans.c:280-300)
    rw = job.resize_up[0] - job.resize_down[0]
    rh = job.resize_up[1] - job.resize_down[1]
    if rw or rh:
        fb = _on_planes(fb, video.resize_fast, [
            (rw, rh, 8 // dx, 8 // dy) for dx, dy in divs])

    # -Z zoom (video_trans.c:300-325)
    if job.zoom_width and job.zoom_height:
        zw, zh = job.zoom_width, job.zoom_height
        if is_rgb:
            fb = _on_planes(fb, lambda p: zoom.zoom_plane(
                p, zw, zh, job.zoom_filter, interlaced=job.zoom_interlaced))
        else:
            planes = list(fb.planes)
            planes[0] = zoom.zoom_plane(planes[0], zw, zh, job.zoom_filter,
                                        interlaced=job.zoom_interlaced)
            for i in range(1, len(planes)):
                dx, dy = divs[i]
                # chroma never interlaced (video_trans.c:305-315)
                planes[i] = zoom.zoom_plane(planes[i], zw // dx, zh // dy,
                                            job.zoom_filter)
            fb = _with_yuv(fb, planes)

    # -Y export clip
    if job.ex_clip:
        fb = apply_clip(fb, job.ex_clip)

    # -r reduce
    if job.reduce_w > 1 or job.reduce_h > 1:
        fb = _on_planes(fb, video.reduce, [(job.reduce_w, job.reduce_h)])

    # -z / -l flips
    if job.flip_v:
        fb = (fb.with_planes(rgb=video.flip_v_rgb(fb.rgb)) if is_rgb
              else _on_planes(fb, video.flip_v))
    if job.flip_h:
        fb = (fb.with_planes(rgb=video.flip_h_rgb(fb.rgb)) if is_rgb
              else _on_planes(fb, video.flip_h))

    # -k rgbswap
    if job.rgbswap and is_rgb:
        fb = fb.with_planes(rgb=torch.flip(fb.rgb, (-1,)))

    # -K decolor
    if job.decolor:
        if is_rgb:
            fb = fb.with_planes(rgb=video.decolor_rgb(fb.rgb))
        elif fb.u is not None:
            fb = fb.with_planes(u=torch.full_like(fb.u, 128),
                                v=torch.full_like(fb.v, 128))

    # -G gamma
    if job.gamma > 0 and job.gamma != 1.0:
        if is_rgb:
            fb = fb.with_planes(rgb=video.gamma_correct(fb.rgb, job.gamma))
        else:
            fb = fb.with_planes(y=video.gamma_correct(fb.y, job.gamma))

    # -C antialias
    if job.antialias > 0:
        aa = (job.antialias_weight, job.antialias_bias)
        if is_rgb:
            fb = _on_planes(fb, video.antialias, [aa])
        else:
            fb = fb.with_planes(y=video.antialias(fb.y, *aa))
    return fb


class VideoChain:
    """Instantiates the -J filters and runs the per-batch step.

    Filter carry states are explicit inputs and outputs, so temporal
    filters stay exact across batch boundaries."""

    def __init__(self, job: Job, in_format: ImageFormat,
                 width: int, height: int):
        self.job = job
        self.in_format = in_format
        self.width, self.height = width, height
        self.filters: List[VideoFilter] = []
        for spec in job.filters:
            # one -J list names video and audio filters: every module is
            # built, and the video chain keeps the video filters
            mod = new_module(ModuleKind.FILTER, spec.name, job, spec.options)
            if isinstance(mod, VideoFilter) and spec.enabled:
                self.filters.append(mod)
        self._by_slot: Dict[FilterSlot, List[int]] = {
            s: [i for i, f in enumerate(self.filters) if f.slots & s]
            for s in _SLOT_ORDER}

    def is_identity(self) -> bool:
        """True when the whole per-batch step is a no-op: no -J filters
        and none of the internal video transforms
        (video_trans.c "jIXBZYrzlkKGC") is active for this job.  The
        engine then keeps the planes in host memory and sends nothing to
        the device (the JAX chain's ``is_identity``)."""
        job = self.job
        return (not self.filters
                and self.in_format == job.im_colorspace
                and not job.im_clip and not job.ex_clip
                and not job.pre_im_clip and not job.post_ex_clip
                and job.deinterlace <= 0
                and job.resize_up == job.resize_down
                and not (job.zoom_width and job.zoom_height)
                and job.reduce_w <= 1 and job.reduce_h <= 1
                and not job.flip_v and not job.flip_h
                and not job.rgbswap and not job.decolor
                and (job.gamma <= 0 or job.gamma == 1.0)
                and job.antialias <= 0)

    def initial_states(self, device: torch.device) -> List[Any]:
        """Thread the running geometry through the chain in execution
        order (pre slots -> internal transforms -> post slots), so each
        filter's carry matches the frame size it will see."""
        states: List[Any] = [None] * len(self.filters)
        w, h = self.width, self.height
        if self.job.pre_im_clip:       # runs before the PRE slots
            t, l, b, r = self.job.pre_im_clip
            w, h = w - l - r, h - t - b
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
        """The chain as a linear op list in execution order: entry
        conversion and --pre_clip, PRE slots, internal transforms, POST
        slots, --post_clip (chain.py:323-335); the fixed ops carry
        index -1."""
        prog: List[Tuple[str, int]] = [("pre", -1)]
        for slot in (FilterSlot.PRE_S, FilterSlot.PRE_M):
            prog += [("filter", i) for i in self._by_slot[slot]]
        prog.append(("trans", -1))
        for slot in (FilterSlot.POST_M, FilterSlot.POST_S):
            prog += [("filter", i) for i in self._by_slot[slot]]
        prog.append(("post", -1))
        return prog

    def _run_op(self, fb: FrameBatch, kind: str) -> FrameBatch:
        if kind == "pre":
            # entry colorspace conversion (-V: internal colorspace)
            if fb.format != self.job.im_colorspace:
                fb = colorspace.convert(fb, self.job.im_colorspace)
            # --pre_clip runs in the import stage, before any filter
            # (preprocess_vid_frame, video_trans.c:483)
            if self.job.pre_im_clip:
                fb = apply_clip(fb, self.job.pre_im_clip)
        elif kind == "trans":
            fb = apply_video_trans(self.job, fb)
        elif kind == "post":
            # --post_clip runs at export, after everything
            # (postprocess_vid_frame, video_trans.c:548)
            if self.job.post_ex_clip:
                fb = apply_clip(fb, self.job.post_ex_clip)
        return fb

    def __call__(self, fb: FrameBatch,
                 states: List[Any]) -> Tuple[FrameBatch, List[Any]]:
        states = list(states)
        for kind, i in self.program():
            if kind == "filter":
                fb, states[i] = self.filters[i].apply(fb, states[i])
            else:
                fb = self._run_op(fb, kind)
        return fb, states


class AudioChain:
    """The audio step (audio_trans.c and the audio filters).

    Three branches, as in the JAX chain's ``__call__``:

    - nothing to do (no audio filter, no ``-s``, ``-d`` equal to the
      input's channels, no ``-E``): the batch comes back as it went in,
      in host memory;
    - no ``-E`` (or ``-E`` at the input's rate): the filters on the
      job's device in the form of the JAX engine's jitted step
      (``jitted`` on every filter);
    - ``-E`` at another rate: the exact streaming resampler on the host
      (the JAX engine reads its ``_pre`` output back for it), then the
      filters on the device on fixed ``(k, 2048, ch)`` chunks through a
      fifo, op by op (``jitted`` off), as the JAX engine runs them;
      ``flush`` drains the resampler's hold-back and the fifo at the end
      of the stream.

    In both the volume and channel step (``pre``) runs first, on the
    job's device.  ``__call__`` takes a batch in host memory and returns
    the output batch, the states and the clipped-sample count (a device
    scalar); it is ``prepare`` (the host stage, which the engine runs in
    a thread of its own) and ``run`` (the device stage, the engine's
    main thread).  With ``-E`` after ``-s`` or ``-d``, ``prepare`` runs
    the pre step on the device on a stream of its own and reads it back
    for the resampler, as the JAX chain reads its jitted pre step back;
    that wait is the host stage's, not the main thread's.  ``run`` waits
    for nothing."""

    # fixed chunk size of the streaming-resample path (the JAX chain's
    # RS_CHUNK); the sub-chunk remainder carries in a fifo
    RS_CHUNK = 2048

    def __init__(self, job: Job, device: torch.device):
        self.job = job
        self.device = torch.device(device)
        self.filters: List[AudioFilter] = []
        for spec in job.filters:
            try:
                mod = new_module(ModuleKind.FILTER, spec.name, job,
                                 spec.options)
            except KeyError:
                continue
            if isinstance(mod, AudioFilter) and spec.enabled:
                self.filters.append(mod)
        self._resampler: Optional[audio_ops.StreamingResampler] = None
        self._rs_fifo: Optional[np.ndarray] = None
        self._pre_stream: Optional[torch.cuda.Stream] = None

    def initial_states(self) -> List[Any]:
        return [f.init_state(self.job.a_rate, self.job.a_chan, self.device)
                for f in self.filters]

    def resamples(self, rate: int) -> bool:
        """True when ``-E`` changes the rate: the streaming branch."""
        return bool(self.job.mp3frequency and self.job.mp3frequency != rate)

    def is_identity(self, ab: AudioBatch) -> bool:
        job = self.job
        return (not self.resamples(ab.rate) and not self.filters
                and not (job.volume != 1.0 and job.volume > 0)
                and job.dm_chan == ab.channels)

    def pre(self, ab: AudioBatch) -> Tuple[AudioBatch, Any]:
        """Volume and channel conversion only (everything before the
        resampler), on the batch's device."""
        nclip: Any = 0
        if self.job.volume != 1.0 and self.job.volume > 0:
            pcm, nclip = audio_ops.amplify(ab.pcm, self.job.volume)
            ab = ab.with_pcm(pcm)
        if self.job.dm_chan != ab.channels:
            if ab.channels == 1 and self.job.dm_chan == 2:
                ab = AudioBatch(pcm=audio_ops.mono_to_stereo(ab.pcm),
                                rate=ab.rate, channels=2, attrs=ab.attrs,
                                frame_ids=ab.frame_ids)
            elif ab.channels == 2 and self.job.dm_chan == 1:
                ab = AudioBatch(pcm=audio_ops.stereo_to_mono(ab.pcm),
                                rate=ab.rate, channels=1, attrs=ab.attrs,
                                frame_ids=ab.frame_ids)
        return ab, nclip

    # audio filters that pass the samples on as they came
    _READ_ONLY = ("astat", "detectsilence")

    def _amplified(self, ab: AudioBatch) -> bool:
        """True when the jitted step's ``-s`` amplify feeds ``ab``'s
        samples straight to the filters (no ``-d`` conversion between:
        XLA then fuses the two otherwise)."""
        return (self.job.volume != 1.0 and self.job.volume > 0
                and self.job.dm_chan == ab.channels)

    def _filters(self, ab: AudioBatch, states: List[Any], jitted: bool,
                 amplified: bool = False) -> Tuple[AudioBatch, List[Any]]:
        """The filters in turn; ``after_amplify`` tells a filter that
        ``-s``'s amplify ran in the same jitted step on the samples it
        gets (``amplified``, and no filter before it changed them)."""
        states = list(states)
        amplified = jitted and amplified
        for i, f in enumerate(self.filters):
            f.jitted = jitted
            f.after_amplify = amplified
            ab, states[i] = f.apply(ab, states[i])
            amplified = amplified and f.info.name in self._READ_ONLY
        return ab, states

    def step(self, ab: AudioBatch, states: List[Any]
             ) -> Tuple[AudioBatch, List[Any], Any]:
        """The JAX chain's jitted step (``_trace_step``) on ``ab``'s
        device: pre, ``-E`` as one whole-batch ``resample_poly`` (edge
        replicated at the batch's ends), then the filters.  The engine
        does not call it (its ``-E`` takes the streaming branch); it is
        the form of the JAX step that callers embedding the audio step
        in a larger one hold no stream state for, kept so that the two
        packages offer the same step."""
        amplified = self._amplified(ab) and not self.resamples(ab.rate)
        ab, nclip = self.pre(ab)
        if self.resamples(ab.rate):
            n, spf, ch = ab.pcm.shape
            out = audio_ops.resample_poly(ab.pcm.reshape(1, n * spf, ch),
                                          ab.rate, self.job.mp3frequency)
            spf_out = out.shape[1] // n
            ab = AudioBatch(pcm=out[0, :spf_out * n].reshape(n, spf_out, ch),
                            rate=self.job.mp3frequency,
                            channels=ab.channels, attrs=ab.attrs,
                            frame_ids=ab.frame_ids)
        ab, states = self._filters(ab, states, jitted=True,
                                   amplified=amplified)
        return ab, states, nclip

    def _upload(self, pcm: np.ndarray, rate: int) -> AudioBatch:
        """Host samples as a batch on the device."""
        return AudioBatch(pcm=host_to_device(pcm, self.device), rate=rate,
                          channels=pcm.shape[-1])

    def _changes_samples(self, ab: AudioBatch) -> bool:
        """True when ``pre`` does something to ``ab``."""
        return ((self.job.volume != 1.0 and self.job.volume > 0)
                or self.job.dm_chan != ab.channels)

    def _pre_on_host(self, ab: AudioBatch) -> Tuple[np.ndarray, int]:
        """``pre`` on the device for the host resampler: the samples and
        the clipped-sample count back in host memory.  On a card it runs
        on a stream of its own, so the read-back waits for that stream
        alone."""
        if not self._changes_samples(ab):
            return ab.pcm.numpy(), 0
        if self.device.type != "cuda":
            out, nclip = self.pre(self._upload(ab.pcm.numpy(), ab.rate))
            return out.pcm.numpy(), int(nclip)
        if self._pre_stream is None:
            self._pre_stream = torch.cuda.Stream(self.device)
        with torch.cuda.stream(self._pre_stream):
            out, nclip = self.pre(self._upload(ab.pcm.numpy(), ab.rate))
            return out.pcm.cpu().numpy(), int(nclip)

    def _chunks(self, out: np.ndarray, ch: int) -> np.ndarray:
        """The fifo's whole chunks, (k, RS_CHUNK, ch); the remainder stays
        in the fifo."""
        fifo = self._rs_fifo
        fifo = out if fifo is None or not len(fifo) \
            else np.concatenate([fifo, out])
        k = len(fifo) // self.RS_CHUNK
        self._rs_fifo = fifo[k * self.RS_CHUNK:]
        return fifo[:k * self.RS_CHUNK].reshape(k, self.RS_CHUNK, ch)

    def prepare(self, ab: AudioBatch) -> "Prepared":
        """The host stage of ``__call__`` on a batch in host memory: with
        ``-E`` the pre step, the streaming resampler and the fifo's whole
        chunks; without, nothing (the samples go to ``run``).  It touches
        no filter state and waits for no work of ``run``'s, so the engine
        runs it in a thread of its own; ``run`` takes what it returns, in
        the same order."""
        if self.is_identity(ab):
            return Prepared(ab, None, 0, True)
        if not self.resamples(ab.rate):
            return Prepared(None, (ab.pcm.numpy(), ab.rate), 0, True)
        pcm, nclip = self._pre_on_host(ab)
        ch = pcm.shape[-1]
        if self._resampler is None:
            self._resampler = audio_ops.StreamingResampler(
                ab.rate, self.job.mp3frequency, ch)
            self._rs_fifo = None
        out = self._resampler.process(pcm.reshape(-1, ch))
        return Prepared(None, (self._chunks(out, ch), self.job.mp3frequency),
                        nclip, False)

    def run(self, prepared: "Prepared", states: List[Any]
            ) -> Tuple[AudioBatch, List[Any], Any]:
        """The device stage: the prepared samples to the device, the pre
        step where ``prepare`` left it, then the filters in the form of
        their branch.  Returns the batch, the states and the clipped
        samples (a device scalar where the pre step ran here)."""
        if prepared.identity is not None:
            return prepared.identity, states, 0
        ab = self._upload(*prepared.samples)
        nclip: Any = prepared.nclip
        amplified = prepared.jitted and self._amplified(ab)
        if prepared.jitted:
            ab, nclip = self.pre(ab)
        ab, states = self._filters(ab, states, jitted=prepared.jitted,
                                   amplified=amplified)
        return ab, states, nclip

    def __call__(self, ab: AudioBatch, states: List[Any]
                 ) -> Tuple[AudioBatch, List[Any], Any]:
        return self.run(self.prepare(ab), states)

    def flush(self, states: List[Any]
              ) -> Tuple[Optional[AudioBatch], List[Any]]:
        """Drain the resampler's hold-back and the chunk fifo at the end
        of the stream: (batch, states), or (None, states)."""
        if self._resampler is None:
            return None, states
        ch = self._resampler.channels
        tail = self._resampler.flush()
        parts = [p for p in (self._rs_fifo, tail)
                 if p is not None and len(p)]
        if not parts:
            return None, states
        pcm = np.concatenate(parts) if len(parts) > 1 else parts[0]
        self._rs_fifo = np.zeros((0, ch), pcm.dtype)
        return self._filters(self._upload(pcm[None], self.job.mp3frequency),
                             states, jitted=False)


@dataclasses.dataclass(frozen=True)
class Prepared:
    """What ``AudioChain.prepare`` hands ``run``: the batch itself when
    the chain does nothing (``identity``), else the host samples and
    their rate, the clipped-sample count of a pre step already run, and
    the filters' form (``jitted``: no ``-E``, the pre step still to
    run)."""

    identity: Optional[AudioBatch]
    samples: Optional[Tuple[np.ndarray, int]]
    nclip: int
    jitted: bool
