"""The AVI import module (``import_avi``): the port of
``tcforge_tpu/modules/importers/avi_import.py``.

The container is the pinned ``io/avi.AviReader`` (idx1, the OpenDML
super index, a ``movi`` scan).  The video track takes one of two
routes, by its fourcc:

- raw fourccs (I420/IYUV/YV12/YUY2/UYVY/YVYU/RGB/DIB) and transcode's
  ``LZO2`` frames: ``read_video_batch`` gives host planes
  (``io/rawio.unpack_frame``, ``io/tclzo.unpack_frame``), which the
  engine copies to the device as it copies a Y4M's; a zero-size
  drop-frame chunk is skipped;
- MPEG-4 part 2 (XVID/DIVX/DX50/MP4V/FMP4/M4S2/MP4S): the MPEG
  importer's plan/execute protocol, so that the engine runs the two
  halves on two threads.  ``plan_batch`` (the reader thread) parses
  each chunk on the host (``io/mpeg4plan.Mpeg4PlanDecoder.parse_plans``,
  the pinned ``io/mpeg4dec.py`` with the port's plan stores, which take
  interlaced, quarter-sample and GMC VOLs and short-header (H.263)
  pictures) straight into the records of a ring of host buffers
  (pinned on a card; ``io/mpeg4recon.stage_plan``) and decides the
  display order by handles: a B-VOP displays at once, an anchor
  displays the anchor before it, the last anchor at the end of the
  stream, a short-header picture at once.  ``execute`` (the main
  thread) uploads the batch's records in one copy and reconstructs each
  VOP in decode order, one launch each (``mpeg4_idct_intra``, or by the
  VOL ``mpeg4_recon``, ``mpeg4_recon_qpel`` or ``mpeg4_recon_field``; an
  S-VOP's warp record goes with it, and the wrapper warps the reference
  with ``mpeg4_gmc_warp`` first),
  the anchors kept on the device.  A short-header stream under an
  MPEG-4 fourcc takes this route, as the JAX importer's numpy decoder
  takes it (``decode_frames``).  A zero-size chunk pays the debt of a
  packed P+B chunk (Xvid's placeholder) or, once a VOP was seen, is a
  dropped frame: an all-skip P plan, which repeats the last anchor (the
  JAX importer's ``_read_mp4_jax``, ``:240-268``).  The frames equal the
  JAX CLI's numpy decode (``decode_frames`` and ``flush``).
- Motion-JPEG (MJPG/JPEG/AVDJ/DMB1): the same protocol through
  ``io/jpeg.JpegStream``: the reader thread runs each chunk's Huffman
  decode on the host into a pinned buffer, the main thread uploads a
  batch in one copy and runs ``jpeg_idct`` and ``jpeg_color`` once
  each; RGB24 frames, PIL's bytes (the JAX importer's ``Image.open``),
  a zero-size chunk skipped, a chunk's first image taken.

The audio track (``-a`` or the ``track`` option) is the session's
audio, as the JAX importer reads it: PCM as it is; MP2 and MP3 (tags
0x50, 0x55) and AC-3 (0x2000) decoded by the in-tree decoders in a
worker process (``io/adec_worker.py``: the ``mp2`` kind, whose
``StreamDecoder`` hands Layer III to ``mp3dec``, and ``ac3``), the
chunks fed in file order and the decoder flushed at the track's end;
``audio_channels`` follows the decoder.  The JAX importer decodes
these through its FFmpeg bridge where it has one: its in-tree decoders,
which the port runs, are its route without the bridge.  ``seek``
(``-L``) moves the chunk index and drops the matching samples, as the
JAX importer's does.

Not ported yet, each raising ``NotImplementedError`` that names it: the
other compressed fourccs (``H263`` among them, which the JAX package
hands to FFmpeg).  What the JAX package's numpy decoder itself refuses
raises as there, in its words: static sprites, sprite brightness
change, more than three warping points (a ``ValueError``), an extended
PTYPE, quarter-sample field prediction; and what the port's JPEG decode
does not take, by name (``io/jpeg.py``: progressive, lossless,
hierarchical and arithmetic-coded JPEG, 12-bit samples, CMYK).
"""

from __future__ import annotations

import queue
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from tcforge_tpu_torch.core.codecs import Codec, ContainerFormat
from tcforge_tpu_torch.core.formats import ImageFormat
from tcforge_tpu_torch.core.optstr import ModuleDesc, ParamSpec
from tcforge_tpu_torch.io import tclzo
from tcforge_tpu_torch.io.adec_worker import Decoder
from tcforge_tpu_torch.io.avi import AviReader
from tcforge_tpu_torch.io.jpeg import JpegStream
from tcforge_tpu_torch.io.mpeg4recon import (REC, Anchors, crop,
                                             reconstruct, route, stage_plan)
from tcforge_tpu_torch.io.rawio import unpack_frame
from tcforge_tpu_torch.modules.importers import start_on_the_card
from tcforge_tpu_torch.modules.registry import (Importer, ModuleInfo,
                                                ModuleKind, register)

_FOURCC_FMT = {
    "I420": ImageFormat.YUV420P, "IYUV": ImageFormat.YUV420P,
    "YV12": ImageFormat.YV12, "YUY2": ImageFormat.YUY2,
    "UYVY": ImageFormat.UYVY, "YVYU": ImageFormat.YVYU,
    "RGB": ImageFormat.RGB24, "DIB": ImageFormat.BGR24, "": ImageFormat.BGR24,
}
MPEG4_FOURCCS = ("XVID", "DIVX", "DX50", "MP4V", "FMP4", "M4S2", "MP4S")
JPEG_FOURCCS = ("MJPG", "JPEG", "AVDJ", "DMB1")
# the worker's decoder kind of each compressed audio tag
AUDIO_KINDS = {0x50: "mp2", 0x55: "mp2", 0x2000: "ac3"}
# decode requests a compressed track keeps in flight
_AUDIO_AHEAD = 8


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"avi: {what} is not ported to the torch "
                               "port yet")


class _Buffer:
    """A host buffer of parsed VOPs, one slot of int16 macroblock records
    after the other; pinned on a card, where ``event`` marks the end of
    its last upload, which a refill waits for."""

    def __init__(self, nmb: int, slots: int, pinned: bool):
        self.nmb = nmb
        self.per_slot = nmb * REC
        self.pinned = pinned
        self.event = None
        self._alloc(slots)

    def _alloc(self, slots: int) -> None:
        n = slots * self.per_slot
        self.flat = (torch.empty(n, dtype=torch.int16, pin_memory=True)
                     if self.pinned else torch.empty(n, dtype=torch.int16))
        self.slots = slots

    def grow(self, used: int) -> None:
        """Room for one more slot than ``used``, the used ones kept."""
        if used < self.slots:
            return
        old = self.flat[:used * self.per_slot].clone()
        self._alloc(2 * self.slots)
        self.flat[:old.numel()].copy_(old)

    def slot(self, k: int) -> np.ndarray:
        off = k * self.per_slot
        return self.flat.numpy()[off:off + self.per_slot].reshape(
            self.nmb, REC)


@dataclass
class Plan:
    """One batch of the MPEG-4 decode, decided on the host
    (``plan_batch``) and run on the device (``execute``): ops are
    ``(kind, slot, rounding, fwd handle, bwd handle, handle, wrapper,
    warp)`` in decode order (``wrapper`` the P or B VOP's
    reconstruction, ``io/mpeg4recon.py`` ``route``; ``warp`` an S-VOP's
    warp record, else None), frames the handles of the batch's frames in
    display order, live the handles kept afterwards."""

    buffer: Optional[_Buffer]
    used: int
    ops: List[tuple] = field(default_factory=list)
    frames: List[int] = field(default_factory=list)   # handles, display
    live: List[int] = field(default_factory=list)     # kept afterwards

    @property
    def upload_elements(self) -> int:
        """The int16 values ``execute`` uploads: the used slots' records
        (none once the buffer is given back)."""
        return 0 if self.buffer is None else self.used * self.buffer.per_slot


@register
class AviImporter(Importer):
    info = ModuleInfo(name="avi", kind=ModuleKind.DEMULTIPLEXOR,
                      media="both",
                      codecs_out=(Codec.YUV420P, Codec.RGB24, Codec.PCM),
                      formats_in=(ContainerFormat.AVI,))
    desc = ModuleDesc(name="avi", comment="AVI container reader (avilib)",
                      params=[ParamSpec("track", "audio track", "d", 0)])
    # False before ``open``: the session takes no audio from this file
    demux_audio = True

    def open(self, path: Optional[str]) -> None:
        self._r = AviReader(path)
        v = self._r.video
        self.width, self.height = v.width, v.height
        self.fps = v.fps
        fcc = v.fourcc.strip().upper()
        self._lzo = fcc == "LZO2"
        self._mp4 = None
        self._jpeg: Optional[JpegStream] = None
        self._device: Optional[torch.device] = None
        if fcc in JPEG_FOURCCS:
            self._jpeg = JpegStream()
            self.format = ImageFormat.RGB24
        elif self._lzo:
            self.format = ImageFormat.YUV420P
        elif fcc in MPEG4_FOURCCS:
            from tcforge_tpu_torch.io.mpeg4plan import Mpeg4PlanDecoder
            self._mp4 = Mpeg4PlanDecoder()
            self.format = ImageFormat.YUV420P
            self._frames: Dict[int, tuple] = {}
            self._reset_decoder()
        elif fcc not in _FOURCC_FMT:
            raise _not_ported(f"compressed video with fourcc {fcc!r} (the "
                              "JAX package decodes it through FFmpeg)")
        else:
            self.format = _FOURCC_FMT[fcc]
        self.total_frames = self._r.video_frames
        self._pos = 0
        track = self.options.get("track", 0) or self.job.a_track
        self._audio_iter = None
        self._audio_kind: Optional[str] = None
        self._audio_dec: Optional[Decoder] = None
        self._audio_fed = False
        self._audio_buf = np.zeros((0, 2), np.int16)
        if track < len(self._r.audio):
            a = self._r.audio[track]
            self.audio_rate = a.rate
            self.audio_channels = a.channels
            self._audio_iter = self._r.read_audio_chunks(track)
            self._audio_kind = AUDIO_KINDS.get(getattr(a, "format_tag", 1))
            self._audio_dtype = np.int16 if a.bits == 16 else np.uint8
            self._audio_buf = np.zeros((0, a.channels), self._audio_dtype)

    @property
    def planned(self) -> bool:
        """True when the video decodes through ``plan_batch`` and
        ``execute`` on the device (MPEG-4, Motion-JPEG), False for host
        planes."""
        return self._mp4 is not None or self._jpeg is not None

    # -- raw and LZO2 video: host planes ------------------------------- #

    def _read_host_batch(self, n: int) -> Optional[Dict[str, np.ndarray]]:
        frames = []
        while len(frames) < n and self._pos < self.total_frames:
            raw, _key = self._r.read_video_frame(self._pos)
            self._pos += 1
            if not raw:
                continue   # drop-frame chunk (avilib zero-size chunks)
            if self._lzo:
                raw2, _fl = tclzo.unpack_frame(
                    raw, self.width * self.height * 3 // 2 + 64)
                frames.append(unpack_frame(raw2, self.format, self.width,
                                           self.height))
                continue
            frames.append(unpack_frame(raw, self.format, self.width,
                                       self.height))
        if not frames:
            return None
        if len(frames[0]) == 1:
            return {"rgb": np.stack([f[0] for f in frames])}
        return {"y": np.stack([f[0] for f in frames]),
                "u": np.stack([f[1] for f in frames]),
                "v": np.stack([f[2] for f in frames])}

    # -- MPEG-4: the host half ----------------------------------------- #

    def _reset_decoder(self) -> None:
        self._anchors = Anchors()
        self._spill: List[int] = []
        self._next_handle = 0
        self._debt = 0          # placeholders owed by packed chunks
        self._seen_plan = False
        self._eos = False

    def start(self, device: torch.device, buffers: int = 1) -> None:
        """Decode onto ``device`` with a ring of ``buffers`` host buffers
        (pinned on a card): ``plan_batch`` takes one, ``execute`` gives
        it back once its upload is queued."""
        self._device = torch.device(device)
        if self._jpeg is not None:
            self._jpeg.start(self._device, buffers)
            return
        nmb = ((self.width + 15) // 16) * ((self.height + 15) // 16)
        pinned = self._device.type == "cuda"
        self.buffer_pool: "queue.Queue[_Buffer]" = queue.Queue()
        for _ in range(buffers):
            self.buffer_pool.put(_Buffer(nmb, 16, pinned))

    def _take_buffer(self, alive) -> Optional[_Buffer]:
        while True:
            try:
                buf = self.buffer_pool.get(timeout=0.1)
                break
            except queue.Empty:
                if alive is not None and not alive():
                    return None
        if buf.event is not None:
            buf.event.synchronize()
            buf.event = None
        return buf

    def _handle(self) -> int:
        self._next_handle += 1
        return self._next_handle

    def plan_batch(self, n: int, alive=None) -> Optional[Plan]:
        """Parse chunks until ``n`` frames are decided for display (or
        the file ends): the batch's ``Plan``, or None when nothing is
        left.  ``alive``: while waiting for a free buffer, a check that
        the consumer still runs."""
        if self._device is None:
            raise RuntimeError("AviImporter.start() was not called")
        if self._jpeg is not None:
            return self._jpeg.plan(self._next_chunk, n, alive)
        frames: List[int] = []
        while self._spill and len(frames) < n:
            frames.append(self._spill.pop(0))
        if self._eos or len(frames) >= n:
            return self._finish(Plan(None, 0), frames, n)
        buf = self._take_buffer(alive)
        if buf is None:
            return None
        plan = Plan(buf, 0)

        def add(p: dict) -> None:
            buf.grow(plan.used)
            k = plan.used
            stage_plan(p, buf.slot(k))
            plan.used += 1
            h = self._handle()
            fh, bh, shown = self._anchors.add(p["kind"], h,
                                              bool(p.get("short")))
            plan.ops.append((p["kind"], k, int(p["rounding"]), fh, bh, h,
                             route(p), p.get("warp")))
            if shown is not None:
                frames.append(shown)

        while len(frames) < n:
            if self._pos >= self.total_frames:
                # the end of the file: the newest anchor is pending
                last = self._anchors.flush()
                if last is not None:
                    frames.append(last)
                self._eos = True
                break
            raw, _key = self._r.read_video_frame(self._pos)
            self._pos += 1
            if not raw:
                if self._debt > 0:
                    self._debt -= 1      # a packed chunk's placeholder
                elif self._seen_plan:
                    # a dropped frame: an all-skip P plan repeats the
                    # last anchor
                    p = self._mp4._plan_new("P")
                    p["use_f"][:] = 1
                    self._mp4._plan = None
                    add(p)
                continue
            plans = self._mp4.parse_plans(bytes(raw))
            if plans:
                self._seen_plan = True
                self._debt += len(plans) - 1
            for p in plans:
                add(p)
        return self._finish(plan, frames, n)

    def _finish(self, plan: Plan, frames: List[int], n: int
                ) -> Optional[Plan]:
        if len(frames) > n:                # a packed chunk can overshoot
            self._spill.extend(frames[n:])
            frames = frames[:n]
        plan.frames = frames
        live = {self._anchors.fwd, self._anchors.bwd, self._anchors.pending,
                *self._spill}
        plan.live = sorted(h for h in live if h is not None)
        if not frames and not plan.ops:
            self._release(plan.buffer)
            return None
        return plan

    def _release(self, buf: Optional[_Buffer]) -> None:
        if buf is not None:
            self.buffer_pool.put(buf)

    def release(self, plan) -> None:
        """Give back a plan's buffer without running it."""
        if self._jpeg is not None:
            self._jpeg.release(plan)
            return
        self._release(plan.buffer)
        plan.buffer = None

    def _next_chunk(self) -> Optional[bytes]:
        """The next Motion-JPEG chunk that is not empty, None at the end
        (a zero-size chunk gives no frame, as in the JAX importer)."""
        while self._pos < self.total_frames:
            raw, _key = self._r.read_video_frame(self._pos)
            self._pos += 1
            if raw:
                return bytes(raw)
        return None

    # -- MPEG-4: the device half --------------------------------------- #

    def execute(self, plan, copy_stream=None
                ) -> Optional[Dict[str, torch.Tensor]]:
        """Run ``plan`` on the device: its batch of planes, uint8
        (N, H, W) on the device and cropped to the VOL's size, or None
        when it displays nothing (Motion-JPEG: ``rgb``, (N, H, W, 3)).
        On a card the upload goes on ``copy_stream`` (when given), which
        the current stream waits for."""
        if self._jpeg is not None:
            return self._jpeg.execute(plan, copy_stream)
        dev = self._device
        buf, n = plan.buffer, plan.upload_elements
        if n:
            if dev.type == "cuda":
                compute = torch.cuda.current_stream(dev)
                stream = copy_stream or compute
                if copy_stream is not None:
                    copy_stream.wait_stream(compute)
                with torch.cuda.stream(stream):
                    flat = torch.empty(n, dtype=torch.int16, device=dev)
                    flat.copy_(buf.flat[:n], non_blocking=True)
                    buf.event = torch.cuda.Event()
                    buf.event.record(stream)
                if copy_stream is not None:
                    compute.wait_event(buf.event)
                    flat.record_stream(compute)
            else:
                flat = buf.flat[:n].clone()
            per, nmb = buf.per_slot, buf.nmb
        if buf is not None:
            self._release(buf)
            plan.buffer = None
        frames = self._frames
        mbw = (self.width + 15) // 16
        for kind, k, rounding, fh, bh, h, wrapper, warp in plan.ops:
            vop = flat[k * per:(k + 1) * per].view(nmb, REC)
            frames[h] = reconstruct(
                vop, kind, rounding, mbw, frames.get(fh), frames.get(bh),
                wrapper, warp)
        out = None
        if plan.frames:
            vol = self._mp4.vol
            shown = [crop(frames[h], vol.width, vol.height)
                     for h in plan.frames]
            out = {key: torch.stack([f[i] for f in shown])
                   for i, key in enumerate("yuv")}
        keep = set(plan.live)
        for h in list(frames):
            if h not in keep:
                del frames[h]
        return out

    # -- the importer's interface -------------------------------------- #

    def read_video_batch(self, n: int):
        """Up to ``n`` frames: host numpy planes for raw and LZO2 video;
        for MPEG-4 and Motion-JPEG, planned and run in the calling
        thread, on the device (on the card unless ``start`` chose another
        device).  None at the end of the file."""
        if not self.planned:
            return self._read_host_batch(n)
        start_on_the_card(self)
        while True:
            plan = self.plan_batch(n)
            if plan is None:
                return None
            out = self.execute(plan)
            if out is not None:
                return out

    def _decoded(self, n_samples: int) -> None:
        """Decode the compressed track until ``n_samples`` samples are
        buffered or it ended: the chunks go to the worker in file order,
        a few requests ahead, then a flush; the results come back in the
        same order (the JAX importer's feed, read and flush)."""
        dec = self._audio_dec
        if dec is None:
            dec = self._audio_dec = Decoder(self._audio_kind)
        while self._audio_buf.shape[0] < n_samples:
            while dec.pending < _AUDIO_AHEAD and not self._audio_fed:
                chunk = next(self._audio_iter, None)
                if chunk is None:
                    dec.submit("flush")
                    self._audio_fed = True
                else:
                    dec.submit("feed", bytes(chunk))
            if not dec.pending:
                return
            got, _rate = dec.result()
            if got is not None and len(got):
                self.audio_channels = got.shape[1]
                self._audio_buf = (got if not len(self._audio_buf) else
                                   np.concatenate([self._audio_buf, got]))

    def read_audio_batch(self, n_samples: int) -> Optional[np.ndarray]:
        if self._audio_iter is None:
            return None
        if self._audio_kind is not None:
            self._decoded(n_samples)
        else:
            while self._audio_buf.shape[0] < n_samples:
                chunk = next(self._audio_iter, None)
                if chunk is None:
                    break
                a = np.frombuffer(chunk, self._audio_dtype).reshape(
                    -1, max(1, self.audio_channels))
                self._audio_buf = np.concatenate([self._audio_buf, a])
        if self._audio_buf.shape[0] == 0:
            return None
        out = self._audio_buf[:n_samples]
        self._audio_buf = self._audio_buf[n_samples:]
        return out

    def seek(self, frame: int) -> bool:
        """-L fast seek: jump the video index, discard matching audio."""
        self._pos = min(frame, self.total_frames)
        if self._audio_iter is not None and self.fps:
            self.read_audio_batch(
                int(round(frame * self.audio_rate / self.fps)))
        return True

    def close(self) -> None:
        self._r.close()
        if self._audio_dec is not None:
            self._audio_dec.close()
            self._audio_dec = None
        if self._mp4 is not None:
            self._frames = {}
