"""The streaming engine: Y4M or MPEG reader thread -> VideoChain on a
device -> Y4M writer thread (or an encoder and a multiplexor), with an
audio track beside it.

The port of ``tcforge_tpu/pipeline/engine.py``: a video session from a
Y4M file or an import module (MPEG-1/2, AVI, MOV, Ogg, the synthetic
source) with an audio track beside it (``-p`` from any file the port
imports audio from, or the source's own), and an audio-only session from
an audio file:

- a reader thread reads ``job.batch_size`` frames at a time straight
  into host buffers (one ``preadv`` a batch) and fills a queue of at
  most ``job.prefetch_depth`` batches.  ``-L`` decodes and drops (the Y4M
  reader cannot seek), ``--max_frames`` and the end of the ``-c``
  ranges bound the frames read.  With an audio track it reads
  ``round(rate/fps)`` samples a frame read, runs the A/V synchronizer
  (``pipeline/synchronizer.py``: the ``-D`` and ``--av_fine_ms`` shifts,
  and the adjust method's clones and drops of frames) on the samples
  and the planes, and the frame ids number the frames after it; then
  the audio chain's host stage in a thread of its own
  (``AudioChain.prepare``: with ``-E``, the volume and channel step on
  the device and back, and the streaming resampler);
- the main thread runs the chain (which converts to ``job.im_colorspace``
  on entry) with the carried filter states, hands each filter its state
  (``collect``) and converts an RGB session to YUV420P for the Y4M
  writer, as the JAX Y4M multiplexor does; then the batch's samples,
  cut into one audio frame per video frame, go through the rest of the
  audio chain (``AudioChain.run``: without ``-E`` the volume and
  channel step, then the filters; ``collect`` too) on the same device;
- a writer thread selects the frames to write by the output batch's
  ``frame_ids`` (``-c``, ``--frame_interval``: a rate-changing filter
  emits another count than it read) and attrs (ATTR_SKIPPED and
  ATTR_BROKEN frames are not written), writes them in order (one
  ``writev`` a batch) and owns the written, skipped and dropped
  counters: each frame lands in exactly one.  It writes the audio
  payloads (the raw encoder's int16 frames) to the WAV multiplexor,
  which opens once a batch has written a frame (or at the end of the
  stream); audio made before that is held (``_MuxOut``);
- at the end of the stream ``AudioChain.flush`` drains ``-E``'s
  resampler, and ``finalize`` runs on every filter once, video and
  audio, after the last ``collect``, also when the run fails.

An MPEG import splits its decode between the threads
(``modules/importers/mpeg_import.py``; ``multi`` for a directory and
``dvd`` for a ``VIDEO_TS`` title play MPEG importers one file after the
other): the reader thread runs the host parse into pinned coefficient
buffers and plans the batch (the reconstruction order, the references,
the display order); the main thread uploads the buffer on the copy
stream and runs the reconstruction kernels, which write the chain's
input batch on the device.  Its ``-L`` cuts the stream at a sequence
header and decodes and drops the rest (``multi``: decodes and drops),
before the threads start.

The source's own audio track (an MPEG stream's, an AVI's, a MOV's, an
Ogg file's, the synthetic one) is the session's audio where no ``-p`` is
given and the importer knows its rate at ``open``, as the JAX engine
takes its importer as its audio source (a program stream's track shows
within the windowed reader's first packs, or the JAX reader drops it).
The importer demuxes it only where the session takes it: with ``-m``, or
into a multiplexor that takes audio; a video-only one drops it with the
JAX engine's warning.  The reader thread reads a batch's samples after
its plan and runs the synchronizer on them and on the plan's frame
handles (a clone repeats a handle, a drop leaves one out).

An audio-only session (an audio file as ``-i``, or an import module
with no video and an audio source, as ``-x null`` with ``-p``) reads
nominal frames of ``round(rate/fps)`` samples (``-L`` and
``--max_frames`` count them), a batch's worth at a time, and each chunk
goes through the audio chain as one audio frame and ``-y``'s audio
encoder into ``-y``'s multiplexor (the JAX ``ValueError`` where that is
video-only and no ``-m`` is given), as in the JAX engine; the ``-J``
video filters get their initial states and their ``finalize`` and see
no frame.

The export stage beyond the Y4M writer (``-y venc[,aenc[,mux]]``, the
JAX engine's): the frames to write (-c, --frame_interval, the skipped
and broken ones out) go to the video encoder on the main thread, after
the batch's chain, as the JAX engine selects before it encodes; the
MPEG-2 and MPEG-4 encoders take them on the device and wait for it once a
picture, for its records (``io/mpeg2enc.py``, ``io/mpeg4enc.py``).  Its payloads, and the audio encoder's, go to the
writer thread's multiplexor, which opens at the first batch that gives
payloads (or at the end of the stream) and holds the audio given before;
at the end of the stream the encoder's tail (its delayed pictures and
its end code) is written before the audio chain's.  The audio encoder
(``-y``'s second module) runs on the writer thread.  ``-m`` names a
multiplexor of its own by its extension (``wav`` where the extension
names none, as the JAX engine's aux muxer), which opens with the main
one and takes every audio payload; without it the audio goes into the
main multiplexor where it takes audio (``mpg``'s LPCM or MPEG audio,
``raw``'s ``.aud``, ``avi``'s, ``mov``'s or ``ogg``'s track).  The
default route, the raw encoders to a ``.y4m``, keeps the writer
thread's own Y4M writer.  The
synthetic source ``framegen`` hands the reader host planes (and its
pink noise as the source's own track), as a Y4M file does.

A chain that does nothing (``VideoChain.is_identity``) is skipped and
the planes never leave host memory, unless the encoder takes them on the
device; so are the samples of an audio chain that does nothing.  On a
CUDA device the batches cross through pinned host buffers: a ring of
``prefetch_depth + 1`` that the
reader fills, each copied to the card on a copy stream
(``non_blocking``) that the chain's stream waits on, and a ring of
output buffers that a second stream copies back into, whose event the
writer thread waits on before it reads them; the audio goes to the card
through pinned memory and comes back on the second stream too.  The
batch loop has no ``synchronize``; a filter that reads back inside its
step (decimate, 32drop, modfps) waits for that batch's chain alone, and
detectsilence reads its flags back in ``collect``.  On the CPU the same
threads run without streams, on fresh host buffers per batch.

Every wait is bounded: a thread that waits on a queue wakes every
``_POLL_S`` to check that the thread it waits on is alive, and the
reader and writer stop when the main thread does.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import queue
import sys
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tcforge_tpu_torch.core.codecs import Codec, ContainerFormat
from tcforge_tpu_torch.core.formats import ImageFormat
from tcforge_tpu_torch.core.frame import (ATTR_BROKEN, ATTR_SKIPPED,
                                          AudioBatch, FrameBatch)
from tcforge_tpu_torch.core.job import Job
from tcforge_tpu_torch.io.wav import WavReader
from tcforge_tpu_torch.io.y4m import Y4MError, Y4MHeader
from tcforge_tpu_torch.modules.muxers.basic import fps_to_ratio
from tcforge_tpu_torch.modules.registry import (Encoder, Importer,
                                                ModuleKind, Muxer,
                                                find_mux_module_for_path,
                                                jax_mux_module_for_path,
                                                lookup, new_module)
from tcforge_tpu_torch.ops import colorspace
from tcforge_tpu_torch.pipeline.chain import AudioChain, VideoChain
from tcforge_tpu_torch.pipeline.synchronizer import new_synchronizer

_log = logging.getLogger("tcforge_tpu_torch")

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
    dropped: int = 0          # marked ATTR_BROKEN, or dropped by the sync
    cloned: int = 0           # cloned by the adjust synchronizer
    batches: int = 0
    seconds: float = 0.0
    audio_frames: int = 0     # audio payloads written
    audio_clipped: int = 0    # samples clipped by -s

    def summary(self) -> str:
        fps = self.frames / self.seconds if self.seconds > 0 else 0.0
        audio = (f", {self.audio_frames} audio frames"
                 if self.audio_frames else "")
        return (f"encoded {self.written} frames ({self.skipped} skipped, "
                f"{self.dropped} dropped, {self.cloned} cloned) of "
                f"{self.frames} in {self.batches} batches{audio}, "
                f"{self.seconds:.3f} s ({fps:.1f} frames/s)")


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


def is_wav(path: str) -> bool:
    """True when ``path`` starts as a RIFF/WAVE file."""
    with open(path, "rb") as f:
        head = f.read(12)
    return head[:4] == b"RIFF" and head[8:12] == b"WAVE"


_Y4M_MODULES = ("y4m", "yuv4mpeg")
# the JAX package's import module for each container that its magic
# sniff names (``registry.find_import_module``): the ones the port lacks
# are refused by that name
JAX_IMPORT_MODULES = {
    ContainerFormat.AVI: "avi", ContainerFormat.WAV: "wav",
    ContainerFormat.YUV4MPEG: "y4m", ContainerFormat.RAW: "raw",
    ContainerFormat.MPEG_PS: "mpeg", ContainerFormat.MPEG_ES: "mpeg",
    ContainerFormat.MPEG_TS: "mpeg", ContainerFormat.MOV: "mov",
    ContainerFormat.OGG: "ogg", ContainerFormat.MP3_FILE: "mp3",
    ContainerFormat.AC3_FILE: "ac3", ContainerFormat.FLAC_FILE: "flac",
    ContainerFormat.AAC_FILE: "aac", ContainerFormat.DV_FILE: "dv",
    ContainerFormat.PVN: "pvn", ContainerFormat.IMAGES: "im",
    ContainerFormat.XML: "xml", ContainerFormat.NUV: "nuv",
    ContainerFormat.VAG: "vag", ContainerFormat.TEST: "framegen",
    ContainerFormat.CDXA: "mpeg", ContainerFormat.MP2_FILE: "mp3",
    ContainerFormat.SGI_IMAGE: "im", ContainerFormat.SUNAU: "au"}


# the audio file import modules: an audio-only -i, or -p
_AUDIO_MODULES = ("wav", "mp3", "ac3", "flac", "aac", "au", "vag")
# the containers whose audio track serves as -p beside their video
_AV_MODULES = ("mpeg", "avi", "mov", "ogg", "dv", "nuv")


def video_module(job: Job) -> str:
    """The import module of ``job``'s ``-i``: from ``-x`` or, with ``-x
    auto``, ``multi`` for a directory and otherwise by the file's magic:
    ``wav``, ``mp3``, ``ac3``, ``flac``, ``aac``, ``au`` or ``vag`` (an
    audio-only session), ``mpeg`` (a program, transport or elementary
    stream, or a VideoCD track), ``avi``, ``mov``, ``ogg``, ``dv``,
    ``nuv`` or ``y4m``
    (also where the magic is unknown, as the JAX engine falls back to
    it).  A container the JAX package imports with a module the port
    lacks is refused, naming the module."""
    name = job.im_v_module or "auto"
    if name in _Y4M_MODULES:
        return "y4m"
    if name != "auto":
        try:
            return lookup(ModuleKind.DEMULTIPLEXOR, name).info.name
        except KeyError as e:
            raise NotImplementedError(
                f"-x {name}: {e.args[0]}, besides y4m") from None
    vin = job.video_in_file
    if os.path.isdir(vin):
        return "multi"
    if is_wav(vin):
        return "wav"
    from tcforge_tpu_torch.io.probe import sniff_magic
    fmt = sniff_magic(vin)
    module = JAX_IMPORT_MODULES.get(fmt, "y4m")
    if module in ("y4m", *_AV_MODULES, *_AUDIO_MODULES):
        return module
    raise NotImplementedError(
        f"{vin}: {fmt.value} input (the {module} import module) is not "
        "ported to the torch port yet")


def audio_module(path: str) -> str:
    """The import module of ``-p``'s file, by its magic as the JAX engine
    picks it (``wav`` where the magic names no module): an audio file's,
    or a program or transport stream's, a VideoCD track's, an AVI's, a
    MOV's, an Ogg, DV or NuppelVideo file's, whose track then serves; one
    the port lacks
    is refused, naming the module."""
    from tcforge_tpu_torch.io.probe import sniff_magic
    fmt = sniff_magic(path)             # probe_file's magic
    module = JAX_IMPORT_MODULES.get(fmt) or "wav"
    if module in _AUDIO_MODULES or module in _AV_MODULES:
        return module
    raise NotImplementedError(
        f"-p {path}: {fmt.value} audio (the {module} import module) is not "
        "ported to the torch port yet; it imports WAV, MP3, AC-3, FLAC, "
        "AAC, AU and VAG files and the tracks of MPEG, AVI, MOV, Ogg, DV "
        "and NuppelVideo files")


# the import modules that decode on the device through the MPEG
# importer's plan/execute protocol
_MPEG_MODULES = ("mpeg", "multi", "dvd")
# import modules that hand over host planes (``read_video_batch``): the
# synthetic source, cfg6's input
_HOST_MODULES = ("framegen",)


def probe(job: Job) -> Optional[Y4MHeader]:
    """The input's Y4M header; sets the job's input size and rate from
    it, as the JAX CLI's probe does.  A WAV input (an audio-only
    session) sets the audio rate, channels and bits, and gives None; an
    MPEG input sets the size and rate of its first sequence header and
    its first audio track's rate and channels (the JAX CLI's
    ``probe_file``) and gives None.  A directory or a title (``multi``,
    ``dvd``) probes its first file, as the JAX CLI does, where a probe
    that fails sets nothing, and several files leave ``--max_frames``
    unset.  An AVI or a MOV sets the size, rate, chunk count
    (``--max_frames``), a packed YUV layout (the job's colorspace) and
    its first track's rate and channels from its headers, as the JAX
    CLI's probe does; so does a compressed audio file (an audio-only
    session), where a probe that fails sets nothing; so do an Ogg file
    (its raw video's size and rate too), an AU or VAG file and the input
    of ``-x null``."""
    kind = video_module(job)
    if kind in _HOST_MODULES:
        return None                 # the module sets them at open
    if kind == "wav" and is_wav(job.video_in_file):
        with WavReader(job.video_in_file) as r:
            job.a_rate, job.a_chan = r.info.rate, r.info.channels
            job.a_bits = r.info.bits
        return None
    if kind != "y4m":
        from tcforge_tpu_torch.io.probe import probe_file, probe_to_job
        from tcforge_tpu_torch.modules.importers.multi import expand_sources
        max_frames = job.max_frames
        try:
            srcs = expand_sources(job.video_in_file)
            probe_to_job(probe_file(srcs[0]), job)
            if len(srcs) > 1 and not max_frames:
                job.max_frames = None   # the first file's length
        except Exception as e:          # as the JAX CLI's probe
            if kind in ("mpeg", "avi", "mov"):
                raise
            _log.warning("[probe] probe failed (%s); relying on the "
                         "import module", e)
        return None
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


class _ImporterReader:
    """An import module's frames (``read_video_batch``) copied into the
    reader's host planes, as ``_FrameReader`` reads a Y4M's."""

    def __init__(self, importer: Importer):
        self.importer = importer

    def close(self) -> None:
        self.importer.close()

    def read_into(self, planes: Sequence[np.ndarray], n: int) -> int:
        got = self.importer.read_video_batch(n)
        if got is None:
            return 0
        if "rgb" in got:
            count = got["rgb"].shape[0]
            planes[0][:count] = got["rgb"].reshape(planes[0][:count].shape)
            return count
        count = got["y"].shape[0]
        for dst, key in zip(planes, "yuv"):
            dst[:count] = got[key]
        return count


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

    def __init__(self, shapes, batch: int, pinned: bool,
                 ring: bool = True):
        self.batch = batch            # frames it holds
        self.ring = ring              # False: made for one batch alone
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


def _select_frames(fb: FrameBatch, keep: np.ndarray) -> FrameBatch:
    """The frames ``keep`` of a batch, on its device."""
    idx = torch.as_tensor(keep, dtype=torch.long, device=fb.device)

    def pick(t):
        return None if t is None else t.index_select(0, idx)
    return dataclasses.replace(
        fb, y=pick(fb.y), u=pick(fb.u), v=pick(fb.v), rgb=pick(fb.rgb),
        attrs=pick(fb.attrs), frame_ids=pick(fb.frame_ids))


def _refuse_lacking_mux(flag: str, path: str) -> Optional[str]:
    """The port's multiplexor for ``path`` by its extension; None where
    the JAX package has none either.  One the JAX package would pick and
    the port lacks is refused by its name."""
    mux = find_mux_module_for_path(path)
    if mux is None:
        jax_name = jax_mux_module_for_path(path)
        if jax_name is not None:
            raise NotImplementedError(
                f"{flag} {path}: the {jax_name} multiplexor is not ported "
                "to the torch port yet")
    return mux


def _export_modules(job: Job, audio_only: bool = False
                    ) -> Optional[Tuple[str, str, str]]:
    """The export stage of ``-y venc[,aenc[,mux]]`` (the JAX engine's):
    None for the default route of a video session to a Y4M file (the raw
    encoders into the y4m multiplexor, chosen or found by the output's
    extension, or by no extension the port knows), which the engine
    writes with its own Y4M writer; else the video encoder, audio encoder
    and multiplexor, ``auto`` resolved by the output's extension (``null``
    where it names none, as in the JAX engine).  A multiplexor the JAX
    package would pick and the port lacks is refused by its name."""
    venc, aenc = job.ex_v_module or "raw", job.ex_a_module or "raw"
    mux = job.ex_m_module or "auto"
    if mux == "auto":
        mux = _refuse_lacking_mux("-o", job.video_out_file or "")
    if (not audio_only and venc == "raw" and aenc == "raw"
            and mux in (None, "y4m")):
        return None
    return venc, aenc, mux or "null"


def _aux_module(job: Job) -> Optional[str]:
    """``-m``'s multiplexor (the JAX engine's aux muxer): by its
    extension, ``wav`` where the extension names none (an ``.mp3`` too);
    None without ``-m``."""
    if not job.audio_out_file:
        return None
    return _refuse_lacking_mux("-m", job.audio_out_file) or "wav"


def _muxes_audio(job: Job) -> bool:
    """True when ``job``'s export route has a multiplexor that takes
    audio."""
    route = _export_modules(job)
    return route is not None and lookup(
        ModuleKind.MULTIPLEXOR, route[2]).info.media != "video"


def _probe_finds_audio(job: Job) -> bool:
    """True when the probe of ``-i`` (its first file) finds an audio
    track."""
    from tcforge_tpu_torch.io.probe import probe_file
    from tcforge_tpu_torch.modules.importers.multi import expand_sources
    try:
        return bool(probe_file(expand_sources(job.video_in_file)[0]).tracks)
    except Exception:                   # as the CLI's probe: no track
        return False


class _MuxOut:
    """The session's multiplexors, owned by the writer thread: the export
    stage's (None where the engine writes its own Y4M file) and ``-m``'s
    beside it (``aux``), which takes every audio payload when it is
    there, as in the JAX engine.  Both open at ``open_now`` (the first
    batch that gives payloads or writes a frame, the first chunk of an
    audio-only session, or the end of the stream), and the audio given
    before that is held."""

    def __init__(self, job: Job, muxer: Optional[Muxer],
                 aux: Optional[Muxer]):
        self.job = job
        self.muxer = muxer
        self.aux = aux
        self.is_open = False
        self._held: List[bytes] = []

    def open_now(self) -> None:
        if self.is_open:
            return
        if self.muxer is not None:
            self.muxer.open(self.job.video_out_file or "")
        if self.aux is not None:
            self.aux.open(self.job.audio_out_file)
        self.is_open = True
        held, self._held = self._held, []
        self.audio(held)

    def video(self, payloads: Sequence[bytes]) -> None:
        if payloads:
            self.open_now()
        for payload in payloads:
            self.muxer.write_video(payload)

    def audio(self, payloads: Sequence[bytes]) -> None:
        if not self.is_open:
            self._held.extend(payloads)
            return
        target = self.aux or self.muxer
        for payload in payloads:
            target.write_audio(payload)

    def close(self) -> None:
        if self.is_open:
            if self.muxer is not None:
                self.muxer.close()
            if self.aux is not None:
                self.aux.close()


class Pipeline:
    """Runs ``job`` on ``device``: ``video_in_file`` (Y4M, MPEG, AVI,
    MOV, Ogg, the synthetic source) -> ``video_out_file`` (Y4M, or what
    the ``-y`` encoders and multiplexor write), with ``audio_in_file``
    (any file the port imports audio from) -> the multiplexor or
    ``audio_out_file`` beside them, or an audio-only session from an
    audio file (or ``-x null`` with ``-p``) through ``-y``'s audio
    encoder and multiplexor."""

    def __init__(self, job: Job, device: torch.device):
        if not job.video_in_file or not job.video_out_file:
            raise ValueError("the torch engine needs -i and -o (Y4M files)")
        self.job = job
        self.device = torch.device(device)
        self.counters = Counters()
        kind = video_module(job)
        hdr = probe(job)
        job.validate()
        audio_in = job.audio_in_file
        a_kind = audio_module(audio_in) if audio_in else None
        # what the export stage takes, refused by name before anything
        # opens; an audio-only session's default route is -y's modules
        route = _export_modules(job)
        aux_name = _aux_module(job)
        self.video_importer: Optional[Importer] = None
        self.host_importer: Optional[Importer] = None
        self.audio_importer: Optional[Importer] = None
        self._opened: List[Importer] = []
        try:
            self._setup(job, kind, hdr, audio_in, a_kind, route, aux_name)
        except BaseException:
            for imp in self._opened:
                imp.close()
            raise

    def _setup(self, job: Job, kind: str, hdr, audio_in, a_kind, route,
               aux_name) -> None:
        imp: Optional[Importer] = None
        if kind != "y4m":
            imp = new_module(ModuleKind.DEMULTIPLEXOR, kind, job,
                             job.im_v_string)
            # the source's own track is demuxed where the session takes
            # it: no -p, and -m or a multiplexor that takes audio (its
            # video decodes the same without)
            imp.demux_audio = not audio_in and bool(
                job.audio_out_file or _muxes_audio(job))
            imp.open(job.video_in_file)
            self._opened.append(imp)
            if not job.im_v_width:
                job.im_v_width, job.im_v_height = imp.width, imp.height
            if imp.fps and not job.hard_fps:
                job.fps = imp.fps
            if imp.audio_rate:
                job.a_rate = imp.audio_rate
                job.a_chan = imp.audio_channels or job.a_chan
        if audio_in:
            aimp = new_module(ModuleKind.DEMULTIPLEXOR, a_kind, job,
                              job.im_a_string)
            aimp.video_wanted = False       # its track alone serves
            aimp.open(audio_in)
            self._opened.append(aimp)
            self.audio_importer = aimp
            if aimp.audio_rate:
                job.a_rate = aimp.audio_rate
                job.a_chan = aimp.audio_channels or job.a_chan
        elif imp is not None and imp.audio_rate:
            # the source's own track (the JAX engine's importer as the
            # audio source): the JAX readers know its rate at open (a
            # program stream's within its first packs), or it has none
            self.audio_importer = imp
        if not job.dm_chan:
            job.dm_chan = job.a_chan or 2
        # no video stream and an audio source: an audio-only session
        self.audio_only = (imp is not None and not imp.width
                           and self.audio_importer is not None)
        if imp is not None and not self.audio_only:
            # the MPEG importers and an MPEG-4 AVI decode on the device
            # (plan/execute); the others give host planes
            if kind in _MPEG_MODULES or getattr(imp, "planned", False):
                self.video_importer = imp
            else:
                self.host_importer = imp
        if self.audio_only:
            route = _export_modules(job, audio_only=True)

        self.sync = new_synchronizer(job)
        self.a_encoder: Encoder = new_module(ModuleKind.ENCODER, "raw", job)
        # the export stage beyond the Y4M writer: the encoder on the main
        # thread, the multiplexors on the writer's
        self.encoder: Optional[Encoder] = None
        self.muxer: Optional[Muxer] = None
        if route is not None:
            venc, aenc, mux = route
            # -F and -y's module options reach the encoder when they look
            # like options (k=v); a bare fourcc is the muxer's
            v_opts = job.ex_v_fcc if "=" in (job.ex_v_fcc or "") else ""
            v_opts = job.ex_v_string or v_opts
            self.encoder = new_module(ModuleKind.ENCODER, venc, job, v_opts)
            self.a_encoder = new_module(ModuleKind.ENCODER, aenc, job,
                                        job.ex_a_string)
            self.muxer = new_module(ModuleKind.MULTIPLEXOR, mux, job,
                                    job.ex_m_string)
        self.aux: Optional[Muxer] = (
            new_module(ModuleKind.MULTIPLEXOR, aux_name, job)
            if aux_name else None)
        mux_name = route[2] if route is not None else "y4m"
        video_only = (route is None
                      or self.muxer.info.media == "video")
        if not job.audio_out_file and video_only:
            if self.audio_only:
                raise ValueError(
                    f"input {job.video_in_file!r} has no video stream and "
                    f"muxer {mux_name!r} is video-only — pick an "
                    "audio-capable output (wav/ogg/avi) or use -m")
            if self.audio_importer is not None or (
                    imp is not None and not audio_in
                    and not imp.demux_audio and _probe_finds_audio(job)):
                # the track is dropped, as in the JAX engine (the port's
                # importers then do not demux it at all)
                _log.warning("[engine] muxer %s is video-only and no -m "
                             "given: audio disabled", mux_name)
                self.audio_importer = None
        self.achain = (AudioChain(job, self.device)
                       if self.audio_importer is not None else None)
        if self.audio_only:
            # the video filters of -J are built (their names checked)
            # and get no frame
            self.in_format = self.out_format = job.im_colorspace
            self._shapes = []
            self.chain = VideoChain(job, job.im_colorspace, 0, 0)
            return
        source = self.video_importer or self.host_importer
        if source is not None:
            w = source.width or job.im_v_width
            h = source.height or job.im_v_height
            self.in_format = fmt = source.format
            if fmt.is_rgb:
                # an RGB source stays RGB where the multiplexor takes it
                # (the JAX engine's _setup_modules); one plane of pixels
                self._shapes = [(h, w * 3)]
                if job.im_colorspace == ImageFormat.YUV420P and \
                        route is not None and {Codec.RGB24, Codec.ANY} & set(
                            lookup(ModuleKind.MULTIPLEXOR,
                                   route[2]).info.codecs_in):
                    job.im_colorspace = ImageFormat.RGB24
            else:
                self._shapes = [(h, w), fmt.uv_plane_shape(w, h),
                                fmt.uv_plane_shape(w, h)]
        else:
            w, h = hdr.width, hdr.height
            self.in_format = hdr.format
            self._shapes = hdr.frame_planes_shapes()
        # what the file takes: the job's colorspace where that is
        # planar YUV, and YUV420P for RGB24 (the JAX Y4M multiplexor,
        # muxers/basic.py:38-46, which writes no valid file for the
        # other formats either); an encoder takes the chain's frames
        csp = job.im_colorspace
        if csp not in _JOB_FORMATS and route is None:
            raise NotImplementedError(
                f"-V {csp.value}: the Y4M writer takes "
                + ", ".join(f.value for f in _JOB_FORMATS))
        self.out_format = (ImageFormat.YUV420P if csp == ImageFormat.RGB24
                           else csp)
        self.chain = VideoChain(job, self.in_format, w, h)

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

    def _samples_per_frame(self) -> int:
        rate = self.audio_importer.audio_rate or self.job.a_rate
        return int(round(rate / (self.job.fps or 25.0)))

    # -- the run --

    def run(self, progress: bool = False) -> Counters:
        job = self.job
        cuda = self.device.type == "cuda"
        mpeg_in = self.video_importer
        # an encoder that codes on the device gets its batches there, also
        # from a chain that does nothing
        on_device = bool(getattr(self.encoder, "on_device", False))
        identity = self.audio_only or (self.chain.is_identity()
                                       and not on_device)
        # pinned buffers and streams; an MPEG import decodes on the device
        staged = cuda and not identity and mpeg_in is None
        staged_out = cuda and (staged or mpeg_in is not None)
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
        h2d = d2h = None
        if cuda:
            d2h = torch.cuda.Stream(self.device)
            h2d = torch.cuda.Stream(self.device)
        if staged:
            free_in = queue.Queue()
            for _ in range(depth + 1):
                free_in.put(_InputSlot(shapes, job.batch_size, True))
        if staged_out:
            free_out = queue.Queue()
            for _ in range(depth + 1):
                free_out.put(_OutputSlot())
        writer_err: List[BaseException] = []
        out_file: List[_FrameWriter] = []
        # -m's multiplexor opens with the main one, with or without a
        # track to write
        mux_out = _MuxOut(job, self.muxer, self.aux)
        spf = self._samples_per_frame() if self.achain is not None else 0
        mux_sized = False

        def audio_host_stage(pcm: np.ndarray, frames: Optional[int]):
            """A batch's samples through the audio chain's host stage
            (``AudioChain.prepare``): cut into ``frames`` audio frames (the
            rest dropped, as in the JAX engine), or as one frame of an
            audio-only session (``frames`` None)."""
            if frames is None:
                pcm = pcm[None]
            else:
                spf_b = pcm.shape[0] // max(1, frames)
                pcm = pcm[:spf_b * frames].reshape(frames, spf_b,
                                                   pcm.shape[-1])
            if not pcm.flags.writeable:
                pcm = pcm.copy()
            return self.achain.prepare(AudioBatch(
                pcm=torch.from_numpy(np.ascontiguousarray(pcm)),
                rate=self.audio_importer.audio_rate or job.a_rate,
                channels=pcm.shape[-1]))

        def synced(first_id: int, got: int, slot: _InputSlot, pcm):
            """The synchronizer on a batch's samples and planes: the
            batch to queue, with the frame count after sync and, where a
            frame was cloned or dropped, a slot of its own."""
            pcm = self.sync.process_audio(pcm, spf)
            audio_frames = pcm.shape[0] // spf if pcm is not None else 0
            planes = {k: p[:got] for k, p in zip("yuv", slot.planes)}
            out = self.sync.process_video(planes, audio_frames)
            if out is not planes:
                n = next(iter(out.values())).shape[0]
                own = _InputSlot(shapes, max(1, n), staged, ring=False)
                for dst, src in zip(own.planes, out.values()):
                    dst[:n] = src
                if free_in is not None:
                    free_in.put(slot)
                got, slot = n, own
            return (first_id, got, slot, pcm)

        def synced_plan(first_id: int, plan, pcm):
            """The synchronizer on a plan's samples and frames: it picks
            the frames by their handles (a clone repeats one, a drop
            leaves one out), and a clone still to come keeps its frame on
            the device."""
            pcm = self.sync.process_audio(pcm, spf)
            audio_frames = pcm.shape[0] // spf if pcm is not None else 0
            handles = {"h": np.asarray(plan.frames, dtype=np.int64)}
            out = self.sync.process_video(handles, audio_frames)
            plan.frames = [int(h) for h in out["h"]]
            saved = getattr(self.sync, "_saved", None)
            if getattr(self.sync, "_op", 0) == 1 and saved is not None:
                plan.live = sorted(set(plan.live) | {int(saved["h"])})
            return (first_id, len(plan.frames), plan, pcm)

        # with an audio track the reader's items go through a thread of
        # their own that runs the audio's host stage (numpy, mostly
        # outside the interpreter lock) while the reader reads on
        aq: Optional["queue.Queue"] = (queue.Queue(maxsize=depth)
                                       if self.achain is not None else None)

        def read_loop() -> None:
            out = aq if aq is not None else rq
            try:
                if self.audio_only:
                    read_audio_only()
                elif mpeg_in is not None:
                    read_mpeg()
                else:
                    read_av()
            except Exception as e:      # handed to the main thread
                _put(out, e, stop)
                return
            _put(out, _EOS, stop)

        def prepare_loop() -> None:
            """The audio's host stage on each item, in order."""
            while True:
                try:
                    item = _get(aq, rthread.is_alive, "reader")
                    if item is not _EOS and not isinstance(item, Exception):
                        first_id, got, slot, pcm = item
                        audio = (None if pcm is None or (slot is not None
                                                         and not got)
                                 else audio_host_stage(
                                     pcm, None if slot is None else got))
                        item = (first_id, got, slot, audio)
                except Exception as e:  # handed to the main thread
                    item = e
                if not _put(rq, item, stop) or item is _EOS \
                        or isinstance(item, Exception):
                    return

        def read_audio_only() -> None:
            # nominal frames of fps-worth samples keep the counters, -L
            # and --max_frames meaningful without video
            if job.vob_offset:
                self.audio_importer.read_audio_batch(spf * job.vob_offset)
            read = 0
            while not stop.is_set():
                n = job.batch_size
                if max_frames is not None:
                    n = min(n, max_frames - read)
                    if n <= 0:
                        break
                pcm = self.audio_importer.read_audio_batch(spf * n)
                if pcm is None or not len(pcm):
                    break
                frames = max(1, pcm.shape[0] // spf)
                if not _put(aq, (read, frames, None, pcm), stop):
                    break
                read += frames

        def read_mpeg() -> None:
            """The host half of the MPEG decode: a plan a batch, with the
            batch's samples and the synchronizer where there is a
            track."""
            read = 0             # source frames planned (--max_frames)
            emitted = 0          # frames after the synchronizer (ids)
            out = aq if aq is not None else rq
            while not stop.is_set():
                n = job.batch_size
                if max_frames is not None:
                    n = min(n, max_frames - read)
                    if n <= 0:
                        break
                plan = mpeg_in.plan_batch(n, alive=lambda: not stop.is_set())
                if plan is None:
                    break
                got = len(plan.frames)
                item = (emitted, got, plan, None)
                if spf and got:
                    pcm = self.audio_importer.read_audio_batch(spf * got)
                    item = synced_plan(emitted, plan, pcm)
                if not _put(out, item, stop):
                    mpeg_in.release(plan)
                    break
                emitted += item[1]
                read += got

        def read_av() -> None:
            left = job.vob_offset             # -L: decode and drop
            if left:
                scratch = _InputSlot(shapes, 1, False)
                while left > 0 and reader.read_into(scratch.planes, 1):
                    left -= 1
                if spf:
                    self.audio_importer.read_audio_batch(
                        spf * job.vob_offset)
            read = 0             # source frames read (--max_frames)
            emitted = 0          # frames after the synchronizer (ids)
            while not stop.is_set():
                n = job.batch_size
                if max_frames is not None:
                    n = min(n, max_frames - read)
                    if n <= 0:
                        break
                if free_in is None:
                    slot = _InputSlot(shapes, n, False)
                else:
                    slot = _get(free_in, lambda: not stop.is_set(), "main")
                    if slot.event is not None:
                        slot.event.synchronize()
                got = reader.read_into(slot.planes, n)
                if not got:
                    break
                item = (emitted, got, slot, None)
                if spf:
                    pcm = self.audio_importer.read_audio_batch(spf * got)
                    item = synced(emitted, got, slot, pcm)
                if not _put(aq if aq is not None else rq, item, stop):
                    break
                emitted += item[1]
                read += got
                if got < n:                 # the end of the file
                    break

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
                    if item[0] == "a":
                        write_audio(*item[1:])
                        continue
                    if item[0] == "f":          # the audio encoder's tail
                        write_payloads(self.a_encoder.flush())
                        continue
                    if item[0] == "e":          # encoded frames
                        mux_out.video(item[1])
                        continue
                    if item[0] == "t":          # the encoder's tail
                        mux_out.open_now()
                        mux_out.video(item[1])
                        continue
                    (w, h), planes, ids, attrs, event, slot = item[1:]
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
                    if len(keep):
                        mux_out.open_now()
                    if slot is not None:
                        free_out.put(slot)
            except BaseException as e:
                writer_err.append(e)

        def write_audio(pcm, event) -> None:
            if event is not None:
                event.synchronize()
            if self.audio_only:
                mux_out.open_now()
            write_payloads(self.a_encoder.encode_audio(AudioBatch(pcm=pcm)))

        def write_payloads(payloads) -> None:
            if not payloads:
                return
            mux_out.audio(payloads)
            self.counters.audio_frames += len(payloads)

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

        def decoded(first_id: int, got: int, plan) -> Optional[FrameBatch]:
            """The device half of the MPEG decode: the plan's frames as
            the chain's input batch, on the device."""
            planes = mpeg_in.execute(plan, h2d)
            if planes is None:
                return None
            dev = self.device
            return FrameBatch(
                format=self.in_format, y=planes.get("y"), u=planes.get("u"),
                v=planes.get("v"), rgb=planes.get("rgb"),
                attrs=torch.zeros((got,), dtype=torch.int32, device=dev),
                frame_ids=torch.arange(first_id, first_id + got,
                                       dtype=torch.int32, device=dev),
                fps=job.fps, id_range=(first_id, first_id + got))

        def to_device(first_id: int, got: int, slot: _InputSlot
                      ) -> FrameBatch:
            if staged:
                with torch.cuda.stream(h2d):
                    flat = torch.empty(slot.flat.shape, dtype=torch.uint8,
                                       device=self.device)
                    flat.copy_(slot.flat, non_blocking=True)
                    slot.event = torch.cuda.Event(blocking=True)
                    slot.event.record(h2d)
                if slot.ring:
                    free_in.put(slot)
                compute = torch.cuda.current_stream(self.device)
                compute.wait_event(slot.event)
                flat.record_stream(compute)
                planes, off = [], 0
                for h, w in shapes:
                    size = slot.batch * h * w
                    planes.append(flat[off:off + size].view(
                        slot.batch, h, w)[:got])
                    off += size
                dev = self.device
            else:
                planes = [torch.from_numpy(p[:got]) for p in slot.planes]
                dev = torch.device("cpu") if identity else self.device
                planes = [p.to(dev) for p in planes]
            if self.in_format.is_rgb:         # (N, H, W*3) -> pixels
                rgb = planes[0].view(got, planes[0].shape[1], -1, 3)
                return FrameBatch(
                    format=self.in_format, rgb=rgb,
                    attrs=torch.zeros((got,), dtype=torch.int32, device=dev),
                    frame_ids=torch.arange(first_id, first_id + got,
                                           dtype=torch.int32, device=dev),
                    fps=job.fps, id_range=(first_id, first_id + got))
            return FrameBatch(
                format=self.in_format, y=planes[0],
                u=planes[1] if len(planes) > 1 else None,
                v=planes[2] if len(planes) > 2 else None,
                attrs=torch.zeros((got,), dtype=torch.int32, device=dev),
                frame_ids=torch.arange(first_id, first_id + got,
                                       dtype=torch.int32, device=dev),
                fps=job.fps, id_range=(first_id, first_id + got))

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
                return ("v", geometry, host[:-2], host[-2], host[-1], None,
                        None)
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
            return ("v", geometry, host[:-2], host[-2], host[-1], event,
                    slot)

        def audio_to_host(ab: AudioBatch):
            """The writer's item for an audio batch: its samples in host
            memory, or on their way there on the copy-back stream."""
            pcm = ab.pcm
            if pcm.device.type != "cuda":
                return ("a", pcm, None)
            host = torch.empty(pcm.shape, dtype=pcm.dtype, pin_memory=True)
            d2h.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(d2h):
                host.copy_(pcm, non_blocking=True)
                pcm.record_stream(d2h)
                event = torch.cuda.Event(blocking=True)
                event.record(d2h)
            return ("a", host, event)

        def encode(out: FrameBatch, first_id: int) -> None:
            """The export stage of an output batch: the frames to write
            (-c, --frame_interval, the skipped and broken ones out) go to
            the encoder, before it, as in the JAX engine; its payloads to
            the writer thread's multiplexor."""
            ids = (out.frame_ids.cpu().numpy() if out.frame_ids is not None
                   else np.arange(first_id, first_id + out.batch))
            attrs = (out.attrs.cpu().numpy() if out.attrs is not None
                     else np.zeros(out.batch, np.int32))
            nonlocal mux_sized
            keep = np.flatnonzero(self._kept(ids, attrs))
            if not mux_sized:
                # the multiplexor opens at the size of the output batches,
                # as the JAX engine sets it until the first payloads
                job.ex_v_width, job.ex_v_height = out.width, out.height
            if len(keep) < out.batch:
                out = _select_frames(out, keep)
            payloads = self.encoder.encode_video(out) if len(keep) else []
            self.counters.written += len(keep)
            to_writer(("e", payloads))
            mux_sized = mux_sized or bool(payloads)

        def run_audio(prepared) -> None:
            """A batch's prepared samples through the audio chain's
            device stage and on to the writer."""
            nonlocal astates, aclipped
            out, astates, nclip = self.achain.run(prepared, astates)
            for filt, state in zip(self.achain.filters, astates):
                filt.collect(state)
            aclipped = aclipped + nclip     # a device scalar: no wait
            to_writer(audio_to_host(out))

        def seek_mpeg(skip: int) -> None:
            """-L on an MPEG input (the JAX engine's reader): the
            importer's seek (the cut at a sequence header, its own track
            moved too), or where it has none (``multi``) decode and drop;
            then a separate track (-p) drops as many frames' samples."""
            seeked = mpeg_in.seek(skip)
            left = skip
            while not seeked and left > 0:
                got = mpeg_in.read_video_batch(min(left, job.batch_size))
                if got is None:
                    break
                left -= next(iter(got.values())).shape[0]
            if spf and not (seeked and self.audio_importer is mpeg_in):
                self.audio_importer.read_audio_batch(spf * skip)

        rthread = threading.Thread(target=read_loop, daemon=True,
                                   name="tcforge-reader")
        pthread = (threading.Thread(target=prepare_loop, daemon=True,
                                    name="tcforge-audio")
                   if aq is not None else None)
        # the thread that fills rq, and its name in an error
        feeder, feeder_name = ((pthread, "audio") if pthread is not None
                               else (rthread, "reader"))
        wthread = threading.Thread(target=write_loop, daemon=True,
                                   name="tcforge-writer")
        # an audio-only session's -J video filters get their states and
        # their finalize too, as in the JAX engine (they see no frame)
        states = self.chain.initial_states(self.device)
        astates = (self.achain.initial_states()
                   if self.achain is not None else [])
        aclipped: Any = 0
        reader = (None if self.audio_only or mpeg_in is not None
                  else _ImporterReader(self.host_importer)
                  if self.host_importer is not None
                  else _FrameReader(job.video_in_file))
        completed = False
        try:
            if mpeg_in is not None:
                mpeg_in.start(self.device, depth + 1)
                if job.vob_offset:
                    seek_mpeg(job.vob_offset)
            rthread.start()
            if pthread is not None:
                pthread.start()
            wthread.start()
            while True:
                item = _get(rq, feeder.is_alive, feeder_name)
                if item is _EOS:
                    if self.encoder is not None and job.encoder_flush:
                        # the encoder's delayed pictures and its end code
                        to_writer(("t", self.encoder.flush()))
                        self.counters.written += \
                            self.encoder.last_flush_frames
                    if self.achain is not None:
                        tail, astates = self.achain.flush(astates)
                        if tail is not None:
                            to_writer(audio_to_host(tail))
                    if job.encoder_flush:
                        # the audio encoder's last frames (its writer
                        # thread flushes it after the samples before)
                        to_writer(("f",))
                    completed = True
                    break
                if isinstance(item, Exception):
                    raise item
                first_id, got, slot, audio = item
                if mpeg_in is not None:
                    fb = decoded(first_id, got, slot)
                    if fb is None:
                        if audio is not None:
                            run_audio(audio)
                        continue
                elif slot is None:             # an audio-only chunk
                    self.counters.frames += got
                    run_audio(audio)
                    self.counters.batches += 1
                    meter.update(self.counters.frames)
                    continue
                else:
                    fb = to_device(first_id, got, slot)
                if identity:
                    out = fb               # a no-op step: no device work
                else:
                    out, states = self.chain(fb, states)
                for filt, state in zip(self.chain.filters, states):
                    filt.collect(state)
                if self.encoder is not None:
                    encode(out, first_id)
                else:
                    if out.rgb is not None:
                        out = colorspace.convert(out, self.out_format)
                    to_writer(to_host(out, first_id))
                if audio is not None:
                    run_audio(audio)
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
            for thread in (rthread, pthread):
                if thread is not None:
                    thread.join(timeout=_JOIN_S)
            if reader is not None:
                reader.close()
            meter.finish()
            for filt, state in zip(self.chain.filters, states):
                filt.finalize(state)
            if self.achain is not None:
                for filt, state in zip(self.achain.filters, astates):
                    filt.finalize(state)
            for imp in self._opened:
                if imp is not self.host_importer:
                    imp.close()
            for f in out_file:
                f.close()
            if completed and not writer_err:
                mux_out.open_now()          # the end of the stream
            mux_out.close()
        if writer_err:
            raise writer_err[0]
        if wthread.is_alive() or feeder.is_alive() or rthread.is_alive():
            raise RuntimeError("the engine's threads did not end")
        if not out_file and not self.audio_only and self.muxer is None:
            # no batch was read: the header alone
            _FrameWriter(job.video_out_file, Y4MHeader(
                *job.export_size(), fps_num=num, fps_den=den,
                format=self.out_format)).close()
        self.counters.audio_clipped += int(aclipped)
        self.counters.cloned += self.sync.video_cloned
        self.counters.dropped += self.sync.video_dropped
        if self.sync.video_cloned or self.sync.video_dropped:
            _log.info("[engine] %s", self.sync.summary())
        self.counters.seconds = time.perf_counter() - t0
        return self.counters
