"""A minimal engine: Y4M reader -> VideoChain on a device -> Y4M writer.

The port's counterpart of ``tcforge_tpu/pipeline/engine.py`` for this
slice.  It reads ``job.batch_size`` frames at a time (the last batch may
be shorter, as in the JAX engine without a mesh), moves them to the
chosen device as a ``FrameBatch``, runs the chain with its carried
filter states, and writes each result back to host memory and the
output file in order.  The stages run one after another; overlapping
host I/O with the device is later work.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from fractions import Fraction
from typing import Callable, Optional, Tuple

import torch

from tcforge_tpu_torch.core import ratiocodes
from tcforge_tpu_torch.core.job import Job
from tcforge_tpu_torch.core.frame import FrameBatch
from tcforge_tpu_torch.io.y4m import Y4MHeader, Y4MReader, Y4MWriter
from tcforge_tpu_torch.pipeline.chain import VideoChain


@dataclass
class Counters:
    frames: int = 0
    batches: int = 0
    seconds: float = 0.0

    def summary(self) -> str:
        fps = self.frames / self.seconds if self.seconds > 0 else 0.0
        return (f"encoded {self.frames} frames in {self.batches} batches, "
                f"{self.seconds:.3f} s ({fps:.1f} frames/s)")


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
        job.im_colorspace = hdr.format
        job.validate()
        self.chain = VideoChain(job, hdr.format, hdr.width, hdr.height)

    def run(self, progress: Optional[Callable[[Counters], None]] = None
            ) -> Counters:
        job = self.job
        w, h = job.export_size()
        num, den = fps_to_ratio(job.out_fps)
        states = self.chain.initial_states(self.device)
        t0 = time.perf_counter()
        with Y4MReader(job.video_in_file) as reader, Y4MWriter(
                job.video_out_file,
                Y4MHeader(width=w, height=h, fps_num=num, fps_den=den,
                          format=job.im_colorspace)) as writer:
            while True:
                want = job.batch_size
                if job.max_frames is not None:
                    want = min(want, job.max_frames - self.counters.frames)
                planes = reader.read_batch(want) if want > 0 else None
                if planes is None:
                    break
                fb = FrameBatch.from_numpy(
                    *planes, device=self.device, fmt=job.im_colorspace,
                    fps=job.fps, first_id=self.counters.frames)
                out, states = self.chain(fb, states)
                writer.write_batch(*out.to_numpy())
                self.counters.frames += fb.batch
                self.counters.batches += 1
                self.counters.seconds = time.perf_counter() - t0
                if progress is not None:
                    progress(self.counters)
        return self.counters
