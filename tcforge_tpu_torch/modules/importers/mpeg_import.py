"""The MPEG PS/ES video import module (``import_mpeg2``/``import_vob``):
the port of ``tcforge_tpu/modules/importers/mpeg_import.py`` for 4:2:0
MPEG-1 and MPEG-2 video.

The decode is split in two halves, so that the engine can run them on
two threads:

- ``plan_batch(n)`` (the host half, the engine's reader thread): it
  demuxes the program stream's video PES packets (or reads the
  elementary stream) in windows, runs the host parse
  (``io/mpeg2parse.py``) picture by picture straight into one of a ring
  of host buffers (pinned on a card), and decides everything that
  depends only on the picture types: which pictures reconstruct one by
  one and which as a batched intra run, which reference each predicts
  from, the display order, the first anchor that displays nothing, the
  end-of-stream flush and the frames beyond a request that spill into
  the next batch.  Frames are named by handles; the result is a
  ``Plan``: the buffer, the operations in decode order and the handles
  of the batch's frames in display order.
- ``execute(plan)`` (the device half, the engine's main thread): one
  upload of the plan's coefficients, the reconstruction kernels
  (``io/mpeg2codec.py``) in decode order with the reference frames kept
  on the device by handle, and the batch's planes stacked, cropped to
  the display size, on the device: the chain's input never visits the
  host.

The routing is the JAX importer's on the CPU (``_read_batch_native``
with ``_gop_scan`` false), which decides which IDCT each picture takes:
runs of intra pictures (and MPEG-1 D-pictures) without field-DCT
macroblocks go to the float64 batch, other frame pictures one by one to
the float32 reconstruction, field pictures through ``decode_field_step``
and pair into frames.  A picture the parse refuses ends the stream with
a warning.

The windowed reader is the default; ``-L`` (``vob_offset``) opens the
whole elementary stream instead, and ``seek`` cuts it at the last
sequence header before the frame and decodes and drops the rest.  Not
ported yet, each raising ``NotImplementedError``: a program stream's
audio tracks, the 4:2:2 profile, TS and CDXA input and PSU navigation
(``-S``, ``--psu_mode``).
"""

from __future__ import annotations

import logging
import queue
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from tcforge_tpu_torch.core.codecs import Codec, ContainerFormat
from tcforge_tpu_torch.core.formats import ImageFormat
from tcforge_tpu_torch.core.optstr import ModuleDesc, ParamSpec
from tcforge_tpu_torch.io import mpeg
from tcforge_tpu_torch.io.mpeg2host import MBF_FIELD_DCT
from tcforge_tpu_torch.io.mpeg2parse import (NEED_DATA, Mpeg2Bitstream,
                                             coef_shapes)
from tcforge_tpu_torch.io.probe import sniff_magic
from tcforge_tpu_torch.modules.registry import (Importer, ModuleInfo,
                                                ModuleKind, register)

_log = logging.getLogger("tcforge_tpu_torch")


def _sniff_422(path: str) -> bool:
    """True when the first window carries a 4:2:2 sequence extension
    (chroma_format 2)."""
    with open(path, "rb") as f:
        head = f.read(1 << 16)
    i = 0
    while True:
        i = head.find(b"\x00\x00\x01\xb5", i)
        if i < 0 or i + 6 > len(head):
            return False
        if (head[i + 4] >> 4) == 1:        # sequence extension
            return ((head[i + 5] >> 1) & 3) == 2
        i += 4


class _Buffer:
    """A host buffer of parsed pictures, one slot after the other: each
    slot the luma and chroma coefficient grids and the macroblock
    records, int32.  Pinned on a card, where ``event`` marks the end of
    its last upload, which a refill waits for."""

    def __init__(self, shapes, slots: int, pinned: bool):
        self.shapes = shapes
        self.sizes = [int(np.prod(s)) for s in shapes]
        self.per_slot = sum(self.sizes)
        self.pinned = pinned
        self.event = None
        self._alloc(slots)

    def _alloc(self, slots: int) -> None:
        n = slots * self.per_slot
        self.flat = (torch.empty(n, dtype=torch.int32, pin_memory=True)
                     if self.pinned else torch.empty(n, dtype=torch.int32))
        self.slots = slots

    def ensure(self, slots: int) -> None:
        """Room for ``slots`` slots; grows (dropping the contents) when
        there is less."""
        if slots > self.slots:
            self._alloc(max(slots, 2 * self.slots))

    def slot(self, k: int) -> List[np.ndarray]:
        """The host arrays of slot ``k`` (the parse writes into them)."""
        flat = self.flat.numpy()
        off = k * self.per_slot
        out = []
        for size, shape in zip(self.sizes, self.shapes):
            out.append(flat[off:off + size].reshape(shape))
            off += size
        return out


@dataclass
class Plan:
    """One batch of the decode, decided on the host (``plan_batch``) and
    run on the device (``execute``)."""

    buffer: Optional[_Buffer]
    used: int                            # slots parsed into the buffer
    ops: List[tuple] = field(default_factory=list)
    frames: List[int] = field(default_factory=list)   # handles, display
    live: List[int] = field(default_factory=list)     # kept afterwards


@register
class MpegImporter(Importer):
    info = ModuleInfo(name="mpeg", kind=ModuleKind.DEMULTIPLEXOR,
                      media="video",
                      codecs_out=(Codec.MPEG2,),
                      formats_in=(ContainerFormat.MPEG_PS,
                                  ContainerFormat.MPEG_ES))
    desc = ModuleDesc(name="mpeg",
                      comment="MPEG PS/ES demultiplexor (scan_pes)",
                      params=[ParamSpec("track", "video PES id offset",
                                        "d", 0),
                              ParamSpec("stream", "windowed (bounded-"
                                        "memory) reader", "b", 1),
                              ParamSpec("window", "demux window KB",
                                        "d", 256)])

    def open(self, path: Optional[str]) -> None:
        job = self.job
        magic = sniff_magic(path)
        if magic == ContainerFormat.MPEG_TS:
            raise NotImplementedError(
                f"{path}: MPEG transport stream input (io/ts.py) is not "
                "ported to the torch port yet")
        if magic == ContainerFormat.CDXA:
            raise NotImplementedError(
                f"{path}: VideoCD (CDXA) input (io/cdxa.py) is not "
                "ported to the torch port yet")
        if magic not in (ContainerFormat.MPEG_PS, ContainerFormat.MPEG_ES):
            raise ValueError(f"{path}: not an MPEG program or elementary "
                             f"stream ({magic.value})")
        unit = getattr(job, "psu_unit", -1)
        if (unit is not None and unit >= 0) or getattr(job, "seek_unit", 0):
            raise NotImplementedError(
                "PSU navigation (-S, --psu_mode) is not ported to the "
                "torch port yet")
        if _sniff_422(path):
            raise NotImplementedError(
                f"{path}: the MPEG-2 4:2:2 profile is not ported to the "
                "torch port yet")
        seq = mpeg.find_sequence_header(path)
        if seq:
            self.width, self.height, _aspect, self.fps = seq
        self._streaming = bool(self.options.get("stream", 1)
                               and not getattr(job, "vob_offset", 0))
        if self._streaming:
            self._win_bytes = max(4, self.options.get("window", 256)) << 10
            self._src = (self._ps_video_chunks(path)
                         if magic == ContainerFormat.MPEG_PS
                         else self._file_chunks(path))
            self._bs = Mpeg2Bitstream(next(self._src, b""), streaming=True)
            # pump until the sequence header is in the window
            while not self._bs.width and self._pump_stream():
                pass
        else:
            self._es = self._whole_es(path, magic)
            self._bs = Mpeg2Bitstream(self._es)
        if self._bs.width:
            self.width, self.height = self._bs.width, self._bs.height
            self.fps = self._bs.fps
        if self._bs.chroma == 2:
            raise NotImplementedError(
                f"{path}: the MPEG-2 4:2:2 profile is not ported to the "
                "torch port yet")
        self.format = ImageFormat.YUV420P
        self._reset_decoder()
        self._device: Optional[torch.device] = None
        self._frames: Dict[int, Tuple[torch.Tensor, ...]] = {}
        self._uploaded = 0

    # -- input -------------------------------------------------------- #

    @staticmethod
    def _whole_es(path: str, magic) -> bytes:
        if magic == ContainerFormat.MPEG_PS:
            return b"".join(payload for sid, payload
                            in mpeg.iter_pes_packets(path)
                            if 0xE0 <= sid <= 0xEF)
        with open(path, "rb") as f:
            return f.read()

    def _file_chunks(self, path: str) -> Iterator[bytes]:
        with open(path, "rb") as f:
            while True:
                b = f.read(self._win_bytes)
                if not b:
                    return
                yield b

    def _ps_video_chunks(self, path: str) -> Iterator[bytes]:
        """The program stream's video PES payloads in windows of at
        least ``_win_bytes``."""
        buf = bytearray()
        for sid, payload in mpeg.iter_pes_packets(
                path, chunk=max(self._win_bytes, 1 << 16)):
            if 0xE0 <= sid <= 0xEF:
                buf += payload
                if len(buf) >= self._win_bytes:
                    yield bytes(buf)
                    buf.clear()
        if buf:
            yield bytes(buf)

    def _pump_stream(self) -> bool:
        """Feed the next window to the parse; False at the end of the
        source (the parse then treats a cut picture as broken)."""
        more = next(self._src, None)
        if more is None:
            self._bs.set_eos()
            return False
        self._bs.feed(more)
        return True

    # -- the host half ------------------------------------------------- #

    def _reset_decoder(self) -> None:
        self._ref_fwd: Optional[int] = None   # older anchor (displays next)
        self._ref_bwd: Optional[int] = None   # newest anchor
        self._pend_field = None               # (parity, handle, ptype)
        self._spill: List[int] = []
        self._next_handle = 0
        self._eos = False

    def _handle(self) -> int:
        self._next_handle += 1
        return self._next_handle

    def start(self, device: torch.device, buffers: int = 1) -> None:
        """Decode onto ``device`` with a ring of ``buffers`` host buffers
        (pinned on a card): ``plan_batch`` takes one, ``execute`` gives
        it back once its upload is queued."""
        self._device = torch.device(device)
        shapes = coef_shapes(self.width, self.height)
        pinned = self._device.type == "cuda"
        self._free_q: "queue.Queue[_Buffer]" = queue.Queue()
        for _ in range(buffers):
            self._free_q.put(_Buffer(shapes, 16, pinned))

    def _start_on_the_card(self) -> None:
        """``start`` on the card where the caller chose no device; raises
        when there is none, as the CLI's ``--device cuda`` does."""
        if self._device is not None:
            return
        if not torch.cuda.is_available():
            raise RuntimeError("MpegImporter: no CUDA device is available "
                               "(call start(torch.device('cpu')) to decode "
                               "with the plain versions)")
        self.start(torch.device("cuda"))

    def _take_buffer(self, alive) -> Optional[_Buffer]:
        """A free host buffer, once its last upload is done; None when
        ``alive()`` turns false while it waits."""
        while True:
            try:
                buf = self._free_q.get(timeout=0.1)
                break
            except queue.Empty:
                if alive is not None and not alive():
                    return None
        if buf.event is not None:
            buf.event.synchronize()
            buf.event = None
        return buf

    def plan_batch(self, n: int, alive=None) -> Optional[Plan]:
        """Parse until ``n`` frames are decided for display (or the
        stream ends): the batch's ``Plan``, or None when nothing is left
        (``_read_batch_native`` on the host).  ``alive``: while waiting
        for a free buffer, a check that the consumer still runs."""
        if self._device is None:
            raise RuntimeError("MpegImporter.start() was not called")
        frames: List[int] = []
        while self._spill and len(frames) < n:
            frames.append(self._spill.pop(0))
        if self._eos or len(frames) >= n:
            return self._finish(Plan(None, 0), frames, n)
        buf = self._take_buffer(alive)
        if buf is None:
            return None
        plan = Plan(buf, 0)
        mb_h = (self.height + 15) // 16
        run: List[Tuple[int, int]] = []       # (slot, handle) intra run
        held = 0           # intra pictures parsed since the last flush
                           # for room (the JAX importer's n slots)

        def emit(h: int) -> None:
            frames.append(h)

        def advance_ref(h: int) -> None:
            if self._ref_bwd is not None:
                emit(self._ref_bwd)
            self._ref_fwd = self._ref_bwd
            self._ref_bwd = h

        def flush_intra() -> None:
            if run:
                plan.ops.append(("intra", [s for s, _ in run],
                                 [h for _, h in run]))
                for _, h in run:
                    advance_ref(h)
                run.clear()

        while len(frames) < n and not self._eos:
            if held >= n:                 # the JAX importer's buffer is full
                flush_intra()
                held = 0
            k = plan.used
            if k >= buf.slots:
                self._grow(plan)
            slot = buf.slot(k)
            try:
                pic = self._bs.next_picture_full(slot)
            except (EOFError, ValueError, NotImplementedError) as e:
                _log.warning("[mpeg] broken picture dropped: %s", e)
                pic = None
            if pic is NEED_DATA:
                self._pump_stream()
                continue
            if pic is None:
                flush_intra()
                # the end of the stream: the newest anchor is pending
                if self._ref_bwd is not None:
                    emit(self._ref_bwd)
                    self._ref_bwd = None
                self._eos = True
                break
            plan.used += 1
            ptype = pic[0]
            ps = self._bs.last_picture_structure
            if ps in (1, 2):              # a field picture: pair them
                flush_intra()
                mb_rows = (self.height // 2 + 15) // 16
                h = self._handle()
                pend = self._pend_field
                plan.ops.append(("field", k, ptype, ps, mb_rows,
                                 None if pend is None else pend[:2],
                                 self._ref_fwd, self._ref_bwd, h))
                parity = 0 if ps == 1 else 1
                if pend is None:
                    self._pend_field = (parity, h, ptype)
                    continue
                fh = self._handle()
                plan.ops.append(("weave", pend[:2], h, parity, mb_h, fh))
                anchor = pend[2] in (1, 2) or ptype in (1, 2)
                self._pend_field = None
                if anchor:
                    advance_ref(fh)
                else:
                    emit(fh)
                continue
            if ptype in (1, 4) and not (slot[3][:, 0] & MBF_FIELD_DCT).any():
                # an intra run (MPEG-1 D-pictures too) goes to the
                # batched float64 IDCT; field-DCT intra pictures need the
                # row deinterleave of the per-picture reconstruction
                run.append((k, self._handle()))
                held += 1
                continue
            flush_intra()
            h = self._handle()
            tff = bool(self._bs.last_tff)
            if ptype in (1, 2, 4):        # an anchor (or an all-D picture)
                plan.ops.append(("recon", k, self._ref_bwd
                                 if ptype == 2 else None, None, tff, h))
                advance_ref(h)
            else:                         # B: displays at once
                fwd = (self._ref_fwd if self._ref_fwd is not None
                       else self._ref_bwd)
                plan.ops.append(("recon", k, fwd, self._ref_bwd, tff, h))
                emit(h)
        flush_intra()
        return self._finish(plan, frames, n)

    def _grow(self, plan: Plan) -> None:
        """More slots for this plan: a larger buffer, the parsed slots
        copied over."""
        buf = plan.buffer
        old = buf.flat[:plan.used * buf.per_slot].clone()
        buf.ensure(plan.used + 1)
        buf.flat[:old.numel()].copy_(old)

    def _finish(self, plan: Plan, frames: List[int], n: int
                ) -> Optional[Plan]:
        if len(frames) > n:                # display lag can overshoot
            self._spill.extend(frames[n:])
            frames = frames[:n]
        plan.frames = frames
        live = {self._ref_fwd, self._ref_bwd, *self._spill}
        if self._pend_field is not None:
            live.add(self._pend_field[1])
        plan.live = sorted(h for h in live if h is not None)
        if not frames and not plan.ops:
            self._release(plan.buffer)
            return None
        return plan

    def _release(self, buf: Optional[_Buffer]) -> None:
        if buf is not None:
            self._free_q.put(buf)

    def release(self, plan: Plan) -> None:
        """Give back a plan's buffer without running it (a run that
        ends early)."""
        self._release(plan.buffer)
        plan.buffer = None

    # -- the device half ----------------------------------------------- #

    def execute(self, plan: Plan, copy_stream=None
                ) -> Optional[Dict[str, torch.Tensor]]:
        """Run ``plan`` on the device: its batch of planes, uint8
        (N, H, W) on the device and cropped to the display size, or None
        when it displays nothing.  On a card the upload goes on
        ``copy_stream`` (when given), which the current stream waits
        for."""
        from tcforge_tpu_torch.io import mpeg2codec
        dev = self._device
        buf = plan.buffer
        if buf is not None and plan.used:
            n = plan.used * buf.per_slot
            if dev.type == "cuda":
                compute = torch.cuda.current_stream(dev)
                stream = copy_stream or compute
                if copy_stream is not None:
                    copy_stream.wait_stream(compute)
                with torch.cuda.stream(stream):
                    flat = torch.empty(n, dtype=torch.int32, device=dev)
                    flat.copy_(buf.flat[:n], non_blocking=True)
                    buf.event = torch.cuda.Event()
                    buf.event.record(stream)
                if copy_stream is not None:
                    compute.wait_event(buf.event)
                    flat.record_stream(compute)
            else:
                flat = buf.flat[:n].clone()
            self._uploaded += n * 4
        if buf is not None:
            self._release(buf)
            plan.buffer = None

        def slot(k: int):
            off = k * buf.per_slot
            out = []
            for size, shape in zip(buf.sizes, buf.shapes):
                out.append(flat[off:off + size].view(shape))
                off += size
            return out

        frames = self._frames
        for op in plan.ops:
            kind = op[0]
            if kind == "intra":
                _, slots, handles = op
                coefs = [torch.stack([slot(k)[i] for k in slots])
                         for i in range(3)]
                ys, us, vs = mpeg2codec.reconstruct_intra_batch(*coefs)
                for i, h in enumerate(handles):
                    frames[h] = (ys[i], us[i], vs[i])
            elif kind == "recon":
                _, k, fh, bh, tff, h = op
                yc, uc, vc, mbinfo = slot(k)
                frames[h] = mpeg2codec.reconstruct_picture(
                    yc, uc, vc, mbinfo,
                    fwd=None if fh is None else frames[fh],
                    bwd=None if bh is None else frames[bh],
                    top_field_first=tff)
            elif kind == "field":
                _, k, ptype, ps, mb_rows, pend, fh, bh, h = op
                yc, uc, vc, mbinfo = slot(k)
                pending = (None if pend is None
                           else (pend[0], frames[pend[1]], None))
                planes, _parity = mpeg2codec.decode_field_step(
                    ptype, ps, yc, uc, vc, mbinfo, mb_rows, pending,
                    None if fh is None else frames[fh],
                    None if bh is None else frames[bh])
                frames[h] = planes
            else:                         # "weave"
                _, pend, h, parity, mb_h, fh = op
                frames[fh] = mpeg2codec.weave_to_frame(
                    (pend[0], frames[pend[1]], None), frames[h], parity,
                    mb_h)
        out = None
        if plan.frames:
            hh, ww = self.height, self.width
            sizes = ((hh, ww), (hh // 2, ww // 2), (hh // 2, ww // 2))
            out = {key: torch.stack([frames[h][i][:s[0], :s[1]]
                                     for h in plan.frames])
                   for i, (key, s) in enumerate(zip("yuv", sizes))}
        keep = set(plan.live)
        for h in list(frames):
            if h not in keep:
                del frames[h]
        return out

    # -- the decoder state (interop.py) -------------------------------- #

    def references(self):
        """The two anchors' planes (older, newer), on the device, or
        None each."""
        return tuple(None if h is None else self._frames[h]
                     for h in (self._ref_fwd, self._ref_bwd))

    def set_references(self, ref_fwd, ref_bwd) -> None:
        """Replace the two anchors by (y, u, v) coded-grid planes (or
        None), moved to the device the importer decodes onto."""
        self._start_on_the_card()
        handles = []
        for ref in (ref_fwd, ref_bwd):
            if ref is None:
                handles.append(None)
                continue
            h = self._handle()
            self._frames[h] = tuple(p.to(self._device) for p in ref)
            handles.append(h)
        self._ref_fwd, self._ref_bwd = handles

    # -- the importer's interface -------------------------------------- #

    def read_video_batch(self, n: int) -> Optional[Dict[str, torch.Tensor]]:
        """Plan and run one batch in the calling thread: up to ``n``
        frames' planes on the device, or None at the end of the stream
        (decoding on the card unless ``start`` chose another device)."""
        self._start_on_the_card()
        while True:
            plan = self.plan_batch(n)
            if plan is None:
                return None
            out = self.execute(plan)
            if out is not None:
                return out

    def seek(self, frame: int) -> bool:
        """-L: cut the elementary stream at the last sequence header
        whose coded-picture count is at most ``frame``, then decode and
        drop the rest (the JAX importer's buffered ``seek``)."""
        if self._streaming:
            left = frame
            while left > 0:
                got = self.read_video_batch(min(left, 16))
                if got is None:
                    return False
                left -= got["y"].shape[0]
            return True
        es = self._es
        units = mpeg.es_unit_ranges(es)
        if not units:
            return False
        best_off, best_count = 0, 0
        count = 0
        for a, b in units:
            if count > frame:
                break
            best_off, best_count = a, count
            count += es.count(b"\x00\x00\x01\x00", a, b)
        if best_off:
            self._es = es[best_off:]
            self._bs.close()
            self._bs = Mpeg2Bitstream(self._es)
            self._ref_fwd = self._ref_bwd = self._pend_field = None
        left = frame - best_count
        while left > 0:
            got = self.read_video_batch(min(left, 16))
            if got is None:
                break
            left -= got["y"].shape[0]
        return True

    def close(self) -> None:
        if getattr(self, "_bs", None) is not None:
            self._bs.close()
            self._bs = None
        self._frames = {}

