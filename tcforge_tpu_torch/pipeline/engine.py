"""The streaming engine: Y4M reader thread -> VideoChain on a device ->
Y4M writer thread.

The port of ``tcforge_tpu/pipeline/engine.py`` for a Y4M-to-Y4M
session:

- a reader thread reads ``job.batch_size`` frames at a time straight
  into host buffers (one ``preadv`` a batch) and fills a queue of at
  most ``job.prefetch_depth`` batches.  ``-L`` decodes and drops (the Y4M
  reader cannot seek), ``--max_frames`` and the end of the ``-c``
  ranges bound the frames read, and the frame ids number the read
  frames from 0 after the ``-L`` skip;
- the main thread runs the chain (which converts to ``job.im_colorspace``
  on entry) with the carried filter states, hands each filter its state
  (``collect``) and converts an RGB session to YUV420P for the Y4M
  writer, as the JAX Y4M multiplexor does;
- a writer thread selects the frames to write by the output batch's
  ``frame_ids`` (``-c``, ``--frame_interval``: a rate-changing filter
  emits another count than it read) and attrs (ATTR_SKIPPED and
  ATTR_BROKEN frames are not written), writes them in order (one
  ``writev`` a batch) and owns the written, skipped and dropped
  counters: each frame lands in exactly one;
- ``finalize`` runs on every filter once, after the last ``collect``,
  also when the run fails.

A chain that does nothing (``VideoChain.is_identity``) is skipped and
the planes never leave host memory.  On a CUDA device the batches cross
through pinned host buffers: a ring of ``prefetch_depth + 1`` that the
reader fills, each copied to the card on a copy stream
(``non_blocking``) that the chain's stream waits on, and a ring of
output buffers that a second stream copies back into, whose event the
writer thread waits on before it reads them.  The batch loop has no
``synchronize``; a filter that reads back inside its step (decimate,
32drop, modfps) waits for that batch's chain alone.  On the CPU the same
threads run without streams, on fresh host buffers per batch.

Every wait is bounded: a thread that waits on a queue wakes every
``_POLL_S`` to check that the thread it waits on is alive, and the
reader and writer stop when the main thread does.
"""

from __future__ import annotations

import os
import queue
import sys
import threading
import time
from dataclasses import dataclass
from fractions import Fraction
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tcforge_tpu_torch.core import ratiocodes
from tcforge_tpu_torch.core.formats import ImageFormat
from tcforge_tpu_torch.core.frame import (ATTR_BROKEN, ATTR_SKIPPED,
                                          FrameBatch)
from tcforge_tpu_torch.core.job import Job
from tcforge_tpu_torch.io.y4m import Y4MError, Y4MHeader
from tcforge_tpu_torch.ops import colorspace
from tcforge_tpu_torch.pipeline.chain import VideoChain

_JOB_FORMATS = (ImageFormat.YUV420P, ImageFormat.YUV422P,
                ImageFormat.YUV444P, ImageFormat.YUV411P,
                ImageFormat.RGB24)
_EOS = object()
_POLL_S = 0.1          # how often a waiting thread checks on the others
_JOIN_S = 60.0         # how long the end of a run waits for a thread


@dataclass
class Counters:
    frames: int = 0           # read and run through the chain
    written: int = 0
    skipped: int = 0          # out of -c / --frame_interval, or SKIPPED
    dropped: int = 0          # marked ATTR_BROKEN
    batches: int = 0
    seconds: float = 0.0

    def summary(self) -> str:
        fps = self.frames / self.seconds if self.seconds > 0 else 0.0
        return (f"encoded {self.written} frames ({self.skipped} skipped, "
                f"{self.dropped} dropped) of {self.frames} in "
                f"{self.batches} batches, {self.seconds:.3f} s "
                f"({fps:.1f} frames/s)")


class ProgressMeter:
    """The fps and ETA line on a terminal's stderr (counter.c:140-310),
    at most once every ``interval`` seconds."""

    def __init__(self, total: Optional[int], enabled: bool = True,
                 interval: float = 0.5):
        self.total = total
        self.enabled = enabled and os.isatty(2)
        self.interval = interval
        self._t0 = time.monotonic()
        self._last = 0.0

    def update(self, done: int) -> None:
        now = time.monotonic()
        if not self.enabled or now - self._last < self.interval:
            return
        self._last = now
        fps = done / max(1e-6, now - self._t0)
        if self.total:
            eta = (self.total - done) / max(1e-6, fps)
            msg = (f"\rencoding frame {done}/{self.total}, "
                   f"{fps:7.1f} fps, ETA {eta:6.1f}s   ")
        else:
            msg = f"\rencoding frame {done}, {fps:7.1f} fps   "
        sys.stderr.write(msg)

    def finish(self) -> None:
        if self.enabled:
            sys.stderr.write("\n")


def fps_to_ratio(fps: float) -> Tuple[int, int]:
    """Best rational fps for the container header, frc table first (as
    the JAX y4m multiplexor writes it)."""
    code = ratiocodes.frc_code_from_value(fps)
    if code is not None:
        return ratiocodes.frc_code_to_ratio(code)
    frac = Fraction(fps).limit_denominator(65535)
    return frac.numerator, frac.denominator


def probe(job: Job) -> Y4MHeader:
    """The input's Y4M header; sets the job's input size and rate from
    it, as the JAX CLI's probe does."""
    with open(job.video_in_file, "rb") as f:
        hdr = Y4MHeader.parse(f.readline(256))
    job.im_v_width, job.im_v_height = hdr.width, hdr.height
    job.fps = hdr.fps
    return hdr


def _put(q: "queue.Queue", item: Any, stop: threading.Event) -> bool:
    """Put ``item`` unless ``stop`` is set first; False if it was."""
    while not stop.is_set():
        try:
            q.put(item, timeout=_POLL_S)
            return True
        except queue.Full:
            continue
    return False


def _get(q: "queue.Queue", alive: Callable[[], bool], what: str) -> Any:
    """The next item of ``q``; raises if the thread that fills it has
    ended without putting one."""
    while True:
        try:
            return q.get(timeout=_POLL_S)
        except queue.Empty:
            if not alive():
                try:
                    return q.get_nowait()
                except queue.Empty:
                    raise RuntimeError(f"the {what} thread ended without "
                                       "finishing its stream") from None


_FRAME = b"FRAME\n"
_IOV_MAX = 1024        # buffers per readv/writev call (Linux's IOV_MAX)


def _frame_buffers(planes: Sequence[np.ndarray], frames, marker):
    """The buffers of ``frames`` in file order: each frame's marker,
    then its planes."""
    bufs = []
    for i, m in zip(frames, marker):
        bufs.append(m)
        bufs.extend(memoryview(p[i]).cast("B") for p in planes)
    return bufs


class _FrameReader:
    """Y4M frames read straight into (N, h, w) host planes: one
    ``preadv`` a batch where every frame line is a bare ``FRAME``, frame
    by frame where one carries parameters."""

    def __init__(self, path: str):
        self._f = open(path, "rb")
        try:
            self.header = Y4MHeader.parse(self._f.readline(256))
        except BaseException:
            self._f.close()
            raise
        self._pos = self._f.tell()
        self.shapes = self.header.frame_planes_shapes()
        self._frame_bytes = len(_FRAME) + self.header.frame_bytes

    def close(self) -> None:
        self._f.close()

    def read_into(self, planes: Sequence[np.ndarray], n: int) -> int:
        """Up to ``n`` frames into ``planes[k][:n]``; the count read (0
        at the end of the file).  A cut frame raises ``Y4MError``."""
        done = 0
        while done < n:
            take = min(n - done, _IOV_MAX // (1 + len(planes)))
            markers = [bytearray(len(_FRAME)) for _ in range(take)]
            got = os.preadv(self._f.fileno(), _frame_buffers(
                planes, range(done, done + take), markers), self._pos)
            whole = got // self._frame_bytes
            bare = next((k for k in range(whole) if markers[k] != _FRAME),
                        whole)
            done += bare
            self._pos += bare * self._frame_bytes
            if bare < take:
                # a marker with parameters, a cut frame or the end of
                # the file: the next frame alone, parsed
                if not self._read_one(planes, done):
                    return done
                done += 1
        return n

    def _read_one(self, planes: Sequence[np.ndarray], i: int) -> bool:
        """Frame ``i`` at the file position, its marker parsed; False at
        the end of the file."""
        self._f.seek(self._pos)
        line = self._f.readline(256)
        if not line:
            return False
        if not line.startswith(b"FRAME"):
            raise Y4MError(f"bad FRAME marker: {line[:32]!r}")
        for p in planes:
            dst = memoryview(p[i]).cast("B")
            if self._f.readinto(dst) < len(dst):
                raise Y4MError("truncated frame")
        self._pos = self._f.tell()
        return True


class _FrameWriter:
    """A Y4M file written from host planes: one ``writev`` a batch,
    straight from the planes."""

    def __init__(self, path: str, header: Y4MHeader):
        self._f = open(path, "wb", buffering=0)
        self._write([header.to_line()])

    def close(self) -> None:
        self._f.close()

    def write(self, planes: Sequence[np.ndarray], frames) -> None:
        frames = list(frames)
        per_call = _IOV_MAX // (1 + len(planes))
        for k in range(0, len(frames), per_call):
            chunk = frames[k:k + per_call]
            self._write(_frame_buffers(planes, chunk, [_FRAME] * len(chunk)))

    def _write(self, bufs) -> None:
        """All of ``bufs``, however many calls the system takes."""
        bufs = [memoryview(b) for b in bufs]
        while bufs:
            n = os.writev(self._f.fileno(), bufs)
            while bufs and n >= len(bufs[0]):
                n -= len(bufs[0])
                bufs.pop(0)
            if n:
                bufs[0] = bufs[0][n:]


class _InputSlot:
    """One batch's host planes, plane after plane in one buffer.  On a
    CUDA device the buffer is pinned and reused; ``event`` marks the end
    of its last copy to the card, which a refill waits for."""

    def __init__(self, shapes, batch: int, pinned: bool):
        sizes = [batch * h * w for h, w in shapes]
        if pinned:
            self.flat = torch.empty(sum(sizes), dtype=torch.uint8,
                                    pin_memory=True)
            buf = self.flat.numpy()
        else:
            self.flat = None
            buf = np.empty(sum(sizes), dtype=np.uint8)
        offs = np.cumsum([0] + sizes)
        self.planes = [buf[a:b].reshape(batch, h, w)
                       for a, b, (h, w) in zip(offs, offs[1:], shapes)]
        self.event: Optional[torch.cuda.Event] = None


class _OutputSlot:
    """Pinned host buffers that one output batch is copied back into;
    they grow to the largest batch seen."""

    def __init__(self):
        self.bufs: List[torch.Tensor] = []

    def views(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        if len(self.bufs) != len(tensors) or any(
                b.shape[0] < t.shape[0] or b.shape[1:] != t.shape[1:]
                or b.dtype != t.dtype for b, t in zip(self.bufs, tensors)):
            self.bufs = [torch.empty(t.shape, dtype=t.dtype,
                                     pin_memory=True) for t in tensors]
        return [b[:t.shape[0]] for b, t in zip(self.bufs, tensors)]


class Pipeline:
    """Runs ``job`` (``video_in_file`` -> ``video_out_file``, both Y4M)
    on ``device``."""

    def __init__(self, job: Job, device: torch.device):
        if not job.video_in_file or not job.video_out_file:
            raise ValueError("the torch engine needs -i and -o (Y4M files)")
        self.job = job
        self.device = torch.device(device)
        self.counters = Counters()
        hdr = probe(job)
        job.validate()
        self.in_format = hdr.format
        self._shapes = hdr.frame_planes_shapes()
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

    # -- selection (export.c:254-291) --

    def _select_mask_ids(self, ids: np.ndarray) -> np.ndarray:
        """Range (-c) and --frame_interval selection over frame ids."""
        job = self.job
        mask = np.ones(ids.shape[0], dtype=bool)
        if job.ranges is not None and len(job.ranges):
            mask &= job.ranges.mask_ids(ids)
        if job.frame_interval > 1:
            mask &= (ids % job.frame_interval) == 0
        return mask

    def _kept(self, ids: np.ndarray, attrs: np.ndarray) -> np.ndarray:
        """The frames to write; each other frame is counted once, as
        dropped (BROKEN) or skipped (everything else)."""
        mask = self._select_mask_ids(ids)
        dropped = (attrs & ATTR_BROKEN) != 0
        mask &= ((attrs & ATTR_SKIPPED) == 0) & ~dropped
        self.counters.dropped += int(dropped.sum())
        self.counters.skipped += int((~mask & ~dropped).sum())
        return mask

    # -- the run --

    def run(self, progress: bool = False) -> Counters:
        job = self.job
        cuda = self.device.type == "cuda"
        identity = self.chain.is_identity()
        staged = cuda and not identity       # pinned buffers and streams
        max_frames = job.max_frames
        if job.ranges is not None and len(job.ranges):
            mf = job.ranges.max_frame
            max_frames = min(max_frames, mf) if max_frames else mf
        meter = ProgressMeter(max_frames, enabled=progress,
                              interval=job.progress_rate)
        depth = max(1, job.prefetch_depth)
        num, den = fps_to_ratio(job.out_fps)
        t0 = time.perf_counter()

        shapes = self._shapes
        stop = threading.Event()          # the main thread is done
        rq: "queue.Queue" = queue.Queue(maxsize=depth)
        wq: "queue.Queue" = queue.Queue(maxsize=2 * depth)
        free_in: Optional["queue.Queue"] = None
        free_out: Optional["queue.Queue"] = None
        if staged:
            free_in, free_out = queue.Queue(), queue.Queue()
            for _ in range(depth + 1):
                free_in.put(_InputSlot(shapes, job.batch_size, True))
                free_out.put(_OutputSlot())
            h2d, d2h = torch.cuda.Stream(self.device), \
                torch.cuda.Stream(self.device)
        writer_err: List[BaseException] = []
        out_file: List[_FrameWriter] = []

        def read_loop() -> None:
            try:
                left = job.vob_offset             # -L: decode and drop
                if left:
                    scratch = _InputSlot(shapes, 1, False)
                    while left > 0 and reader.read_into(scratch.planes, 1):
                        left -= 1
                read = 0
                while not stop.is_set():
                    n = job.batch_size
                    if max_frames is not None:
                        n = min(n, max_frames - read)
                        if n <= 0:
                            break
                    if free_in is None:
                        slot = _InputSlot(shapes, n, False)
                    else:
                        slot = _get(free_in, lambda: not stop.is_set(),
                                    "main")
                        if slot.event is not None:
                            slot.event.synchronize()
                    got = reader.read_into(slot.planes, n)
                    if not got or not _put(rq, (read, got, slot), stop):
                        break
                    read += got
                    if got < n:                 # the end of the file
                        break
            except Exception as e:      # handed to the main thread
                _put(rq, e, stop)
                return
            _put(rq, _EOS, stop)

        def write_loop() -> None:
            try:
                while True:
                    try:
                        item = wq.get(timeout=_POLL_S)
                    except queue.Empty:
                        if stop.is_set():
                            return
                        continue
                    if item is _EOS:
                        return
                    (w, h), planes, ids, attrs, event, slot = item
                    if event is not None:
                        event.synchronize()
                    keep = np.flatnonzero(self._kept(ids, attrs))
                    if not out_file:
                        out_file.append(_FrameWriter(
                            job.video_out_file, Y4MHeader(
                                width=w, height=h, fps_num=num,
                                fps_den=den, format=self.out_format)))
                    out_file[0].write(planes, keep)
                    self.counters.written += len(keep)
                    if slot is not None:
                        free_out.put(slot)
            except BaseException as e:
                writer_err.append(e)

        def to_writer(item) -> None:
            # never block on a dead writer: surface its error instead
            while True:
                if writer_err:
                    raise writer_err[0]
                if not wthread.is_alive():
                    raise RuntimeError("the writer thread ended early")
                try:
                    wq.put(item, timeout=_POLL_S)
                    return
                except queue.Full:
                    continue

        def writer_alive() -> bool:
            if writer_err:
                raise writer_err[0]
            return wthread.is_alive()

        def to_device(first_id: int, got: int, slot: _InputSlot
                      ) -> FrameBatch:
            if staged:
                with torch.cuda.stream(h2d):
                    flat = torch.empty(slot.flat.shape, dtype=torch.uint8,
                                       device=self.device)
                    flat.copy_(slot.flat, non_blocking=True)
                    slot.event = torch.cuda.Event(blocking=True)
                    slot.event.record(h2d)
                free_in.put(slot)
                compute = torch.cuda.current_stream(self.device)
                compute.wait_event(slot.event)
                flat.record_stream(compute)
                planes, off = [], 0
                for h, w in shapes:
                    size = job.batch_size * h * w
                    planes.append(flat[off:off + size].view(
                        job.batch_size, h, w)[:got])
                    off += size
                dev = self.device
            else:
                planes = [torch.from_numpy(p[:got]) for p in slot.planes]
                dev = torch.device("cpu") if identity else self.device
                planes = [p.to(dev) for p in planes]
            return FrameBatch(
                format=self.in_format, y=planes[0],
                u=planes[1] if len(planes) > 1 else None,
                v=planes[2] if len(planes) > 2 else None,
                attrs=torch.zeros((got,), dtype=torch.int32, device=dev),
                frame_ids=torch.arange(first_id, first_id + got,
                                       dtype=torch.int32, device=dev),
                fps=job.fps)

        def to_host(out: FrameBatch, first_id: int):
            """The writer's item for an output batch: its planes, ids
            and attrs in host memory, or on their way there."""
            ids = (out.frame_ids if out.frame_ids is not None
                   else torch.arange(first_id, first_id + out.batch,
                                     dtype=torch.int32, device=out.device))
            attrs = (out.attrs if out.attrs is not None
                     else torch.zeros((out.batch,), dtype=torch.int32,
                                      device=out.device))
            tensors = [*out.planes, ids, attrs]
            geometry = (out.width, out.height)
            if out.device.type != "cuda":
                host = [np.ascontiguousarray(t.numpy()) for t in tensors]
                return geometry, host[:-2], host[-2], host[-1], None, None
            slot = _get(free_out, writer_alive, "writer")
            dst = slot.views(tensors)
            d2h.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(d2h):
                for d, t in zip(dst, tensors):
                    d.copy_(t, non_blocking=True)
                    t.record_stream(d2h)
                event = torch.cuda.Event(blocking=True)
                event.record(d2h)
            host = [d.numpy() for d in dst]
            return geometry, host[:-2], host[-2], host[-1], event, slot

        rthread = threading.Thread(target=read_loop, daemon=True,
                                   name="tcforge-reader")
        wthread = threading.Thread(target=write_loop, daemon=True,
                                   name="tcforge-writer")
        states = self.chain.initial_states(self.device)
        reader = _FrameReader(job.video_in_file)
        try:
            rthread.start()
            wthread.start()
            while True:
                item = _get(rq, rthread.is_alive, "reader")
                if item is _EOS:
                    break
                if isinstance(item, Exception):
                    raise item
                first_id, got, slot = item
                fb = to_device(first_id, got, slot)
                if identity:
                    out = fb               # a no-op step: no device work
                else:
                    out, states = self.chain(fb, states)
                for filt, state in zip(self.chain.filters, states):
                    filt.collect(state)
                if out.rgb is not None:
                    out = colorspace.convert(out, self.out_format)
                to_writer(to_host(out, first_id))
                self.counters.frames += got
                self.counters.batches += 1
                meter.update(self.counters.frames)
        finally:
            # the writer drains what it was given; the reader stops
            while wthread.is_alive() and not writer_err:
                try:
                    wq.put(_EOS, timeout=_POLL_S)
                    break
                except queue.Full:
                    continue
            wthread.join(timeout=_JOIN_S)
            stop.set()
            rthread.join(timeout=_JOIN_S)
            reader.close()
            meter.finish()
            for filt, state in zip(self.chain.filters, states):
                filt.finalize(state)
            for f in out_file:
                f.close()
        if writer_err:
            raise writer_err[0]
        if wthread.is_alive() or rthread.is_alive():
            raise RuntimeError("the engine's threads did not end")
        if not out_file:                # no batch was read: the header
            _FrameWriter(job.video_out_file, Y4MHeader(
                *job.export_size(), fps_num=num, fps_den=den,
                format=self.out_format)).close()
        self.counters.seconds = time.perf_counter() - t0
        return self.counters
