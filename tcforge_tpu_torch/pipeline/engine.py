"""A minimal engine: Y4M reader -> VideoChain on a device -> Y4M writer.

The port's counterpart of ``tcforge_tpu/pipeline/engine.py`` for this
slice.  It reads ``job.batch_size`` frames at a time (the last batch may
be shorter, as in the JAX engine without a mesh), moves them to the
chosen device as a ``FrameBatch`` in the file's format, runs the chain
(which converts to ``job.im_colorspace``, the ``-V`` colorspace, on
entry) with its carried filter states, and writes each result back to
host memory and the output file in order.  Y4M holds YUV only: an RGB
job is converted to YUV420P where it is written, as the JAX Y4M
multiplexor does, here on the device and for the whole batch.  As in
the JAX engine (engine.py:803-832), frames that a filter marked
``ATTR_SKIPPED`` (TomsMoComp's and ivtc's warm-up, decimate's
duplicates) or ``ATTR_BROKEN`` are not written, and count as skipped
or dropped.  The stages run one after another; overlapping host I/O
with the device is later work.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from fractions import Fraction
from typing import Callable, Optional, Tuple

import torch

from tcforge_tpu_torch.core import ratiocodes
from tcforge_tpu_torch.core.formats import ImageFormat
from tcforge_tpu_torch.core.job import Job
from tcforge_tpu_torch.core.frame import (ATTR_BROKEN, ATTR_SKIPPED,
                                          FrameBatch)
from tcforge_tpu_torch.io.y4m import Y4MHeader, Y4MReader, Y4MWriter
from tcforge_tpu_torch.ops import colorspace
from tcforge_tpu_torch.pipeline.chain import VideoChain


_JOB_FORMATS = (ImageFormat.YUV420P, ImageFormat.YUV422P,
                    ImageFormat.YUV444P, ImageFormat.YUV411P,
                    ImageFormat.RGB24)


@dataclass
class Counters:
    frames: int = 0           # read and run through the chain
    written: int = 0
    skipped: int = 0          # marked ATTR_SKIPPED by a filter
    dropped: int = 0          # marked ATTR_BROKEN
    batches: int = 0
    seconds: float = 0.0

    def summary(self) -> str:
        fps = self.frames / self.seconds if self.seconds > 0 else 0.0
        return (f"encoded {self.written} frames ({self.skipped} skipped, "
                f"{self.dropped} dropped) of {self.frames} in "
                f"{self.batches} batches, {self.seconds:.3f} s "
                f"({fps:.1f} frames/s)")


def fps_to_ratio(fps: float) -> Tuple[int, int]:
    """Best rational fps for the container header, frc table first (as
    the JAX y4m multiplexor writes it)."""
    code = ratiocodes.frc_code_from_value(fps)
    if code is not None:
        return ratiocodes.frc_code_to_ratio(code)
    frac = Fraction(fps).limit_denominator(65535)
    return frac.numerator, frac.denominator


class Pipeline:
    """Runs ``job`` (``video_in_file`` -> ``video_out_file``, both Y4M)
    on ``device``."""

    def __init__(self, job: Job, device: torch.device):
        if not job.video_in_file or not job.video_out_file:
            raise ValueError("the torch engine needs -i and -o (Y4M files)")
        self.job = job
        self.device = torch.device(device)
        self.counters = Counters()
        with Y4MReader(job.video_in_file) as reader:
            hdr = reader.header
        job.im_v_width, job.im_v_height = hdr.width, hdr.height
        job.fps = hdr.fps
        job.validate()
        self.in_format = hdr.format
        # what the file takes: the job's colorspace where that is
        # planar YUV, and YUV420P for RGB24 (the JAX Y4M multiplexor,
        # muxers/basic.py:38-46, which writes no valid file for the
        # other formats either)
        csp = job.im_colorspace
        if csp not in _JOB_FORMATS:
            raise NotImplementedError(
                f"-V {csp.value}: the Y4M writer takes "
                + ", ".join(f.value for f in _JOB_FORMATS))
        self.out_format = (ImageFormat.YUV420P if csp == ImageFormat.RGB24
                           else csp)
        self.chain = VideoChain(job, hdr.format, hdr.width, hdr.height)

    def run(self, progress: Optional[Callable[[Counters], None]] = None
            ) -> Counters:
        job = self.job
        num, den = fps_to_ratio(job.out_fps)
        states = self.chain.initial_states(self.device)
        t0 = time.perf_counter()

        def open_writer(w: int, h: int) -> Y4MWriter:
            return stack.enter_context(Y4MWriter(
                job.video_out_file,
                Y4MHeader(width=w, height=h, fps_num=num, fps_den=den,
                          format=self.out_format)))

        with contextlib.ExitStack() as stack:
            reader = stack.enter_context(Y4MReader(job.video_in_file))
            # opened on the first batch, with the geometry that came
            # out of the chain (-I 4 halves the height, which
            # export_size does not know), as the JAX engine does
            writer: Optional[Y4MWriter] = None
            while True:
                want = job.batch_size
                if job.max_frames is not None:
                    want = min(want, job.max_frames - self.counters.frames)
                planes = reader.read_batch(want) if want > 0 else None
                if planes is None:
                    break
                fb = FrameBatch.from_numpy(
                    *planes, device=self.device, fmt=self.in_format,
                    fps=job.fps, first_id=self.counters.frames)
                out, states = self.chain(fb, states)
                for filt, state in zip(self.chain.filters, states):
                    filt.collect(state)
                if out.rgb is not None:
                    out = colorspace.convert(out, self.out_format)
                if writer is None:
                    writer = open_writer(out.width, out.height)
                planes = self._kept_planes(out)
                if planes[0].shape[0]:
                    writer.write_batch(*planes)
                self.counters.written += planes[0].shape[0]
                self.counters.frames += fb.batch
                self.counters.batches += 1
                self.counters.seconds = time.perf_counter() - t0
                if progress is not None:
                    progress(self.counters)
            if writer is None:             # no frame read: the header alone
                open_writer(*job.export_size())
        return self.counters

    def _kept_planes(self, out: FrameBatch):
        """The output batch's host planes without the frames marked
        SKIPPED or BROKEN; each of those lands in one counter."""
        planes = out.to_numpy()
        if out.attrs is None:
            return planes
        attrs = out.attrs.cpu().numpy()
        dropped = (attrs & ATTR_BROKEN) != 0
        skipped = ((attrs & ATTR_SKIPPED) != 0) & ~dropped
        self.counters.dropped += int(dropped.sum())
        self.counters.skipped += int(skipped.sum())
        keep = ~(dropped | skipped)
        return planes if keep.all() else tuple(p[keep] for p in planes)
