"""The MPEG PS/ES import module (``import_mpeg2``/``import_vob``): the
port of ``tcforge_tpu/modules/importers/mpeg_import.py`` for MPEG-1 and
MPEG-2 video, 4:2:0 and 4:2:2, and a program stream's audio track.

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

A 4:2:2 stream (the 422P profile, any size) follows the JAX importer's
``_read_batch_422`` on the CPU: every intra frame picture alone through
the float64 IDCT with its field-DCT deinterleave
(``reconstruct_intra_422``), other frame pictures through the float32
reconstruction and field pictures through ``decode_field_step``, all
with ``chroma=2``, and the same display order, end-of-stream flush and
field pairing.  Under ``-V yuv422p`` the frames stay 4:2:2 (format
YUV422P); otherwise each frame's chroma is decimated into the 4:2:0
chain on the device (``chroma_422_to_420``).  The JAX importer reads a
4:2:2 file whole; this one keeps its windowed reader, with the same
frames in the same order.

The windowed reader is the default; ``-L`` (``vob_offset``) opens the
whole elementary stream instead, and ``seek`` cuts it at the last
sequence header before the frame and decodes and drops the rest.

A program stream's audio track demuxes beside the video, as the JAX
importer's does (``_Track``): the first kind found wins (DVD LPCM,
MPEG audio on PES 0xC0 + ``-a``, AC-3 on private-stream-1 sub-stream
0x80 + ``-a``, PlayStation VAG), the windowed reader's discovery
budget of two pumps decides whether the engine sees a track, and
``read_audio_batch`` serves the fifo in demux order (the whole track,
decoded at open, under ``-L``).  The AC-3 and MPEG audio decoders are
pinned copies of the JAX package's in-tree ones, run in a worker
process (``io/adec_worker.py``) while the reader thread parses on; LPCM
and VAG decode inline.

A transport stream's video is the PID of ``--ts_pid``, or the one its
PAT and PMT name (``io/ts.py``), demuxed in 256 KB pieces into the same
windowed parse; its audio is the PMT's first MPEG audio, AC-3 or AAC
stream (``_TsTrack``).  A VideoCD track (RIFF/CDXA) is unwrapped to a
program stream in a temporary file, removed at ``close`` or when
``open`` fails, and plays as one.  PSU navigation (``psu_unit``,
``psu_unit_end``, ``seek_unit``: ``--psu_mode``, ``--no_split``, ``-S``)
cuts the whole elementary stream at its sequence headers; each unit's
audio starts at the track's first sample, as in the JAX importer.
"""

from __future__ import annotations

import logging
import os
import queue
import tempfile
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from tcforge_tpu_torch.core.codecs import Codec, ContainerFormat
from tcforge_tpu_torch.core.formats import ImageFormat
from tcforge_tpu_torch.core.optstr import ModuleDesc, ParamSpec
from tcforge_tpu_torch.io import mpeg
from tcforge_tpu_torch.io import ts as tsio
from tcforge_tpu_torch.io.adec_worker import SampleFifo, StreamSamples
from tcforge_tpu_torch.io.cdxa import cdxa_to_ps
from tcforge_tpu_torch.io.mpeg2host import MBF_FIELD_DCT
from tcforge_tpu_torch.io.mpeg2parse import (NEED_DATA, Mpeg2Bitstream,
                                             coef_shapes)
from tcforge_tpu_torch.io.probe import sniff_magic
from tcforge_tpu_torch.modules.importers import start_on_the_card
from tcforge_tpu_torch.modules.registry import (Importer, ModuleInfo,
                                                ModuleKind, register)

_log = logging.getLogger("tcforge_tpu_torch")


class _Track(SampleFifo):
    """A program stream's audio track as the demux finds it: the JAX
    importer's choice of track and decoder (the first kind found wins,
    ``-a`` picks the sub-stream) and its fifo of samples, with the
    decode in a worker process (``io/adec_worker.py``).

    The fifo holds entries in demux order: samples ready at once (LPCM,
    and VAG, decoded inline) and tickets for the decoder's results.
    Where the JAX importer looks at what its decoder gave back (whether
    a track was seen, how many samples wait, the rate), ``_resolve``
    takes the decoder's results in order first, as far as the question
    needs, so every answer is the one the JAX importer gives at the same
    point of the demux.  A ``quiet`` entry is one the JAX importer
    appends at the end of the source without marking the track seen or
    taking its rate (the decoders' flush, VAG's tail)."""

    def __init__(self, a_track: int):
        super().__init__()                # the resolved samples
        self.a_track = a_track
        self.kind: Optional[str] = None
        self.dec = None                   # io.adec_worker.Decoder
        self.vag = None                   # io.vag.VagStreamDecoder
        self.entries: deque = deque()     # ("pcm", pcm, rate, quiet)
        #                                   or ("dec", quiet)
        self.seen = False
        self.rate = 0
        self.channels = 0

    # -- the demux (the JAX importer's _ps_video_chunks) --------------- #

    def _decoder(self, kind: str):
        if self.dec is None:
            from tcforge_tpu_torch.io.adec_worker import Decoder
            self.dec = Decoder(kind)
        return self.dec

    def _feed(self, kind: str, payload: bytes) -> None:
        self._decoder(kind).submit("feed", payload)
        self.entries.append(("dec", False))

    def demux(self, sid: int, payload: bytes) -> None:
        """One non-video PES packet of the windowed reader."""
        if sid == 0xC0 + self.a_track and self.kind in (None, "mp2"):
            self.kind = "mp2"
            self._feed("mp2", payload)
        elif sid == mpeg.PES_PRIVATE1:
            got = (mpeg.parse_lpcm_payload(payload, self.a_track)
                   if self.vag is None else None)
            if got is not None:
                self.kind = "lpcm"
                self.entries.append(("pcm", got[0], got[1], False))
                return
            if self.kind in (None, "ac3"):
                raw3 = mpeg.parse_ac3_payload(payload, self.a_track)
                if raw3 is not None:
                    self.kind = "ac3"
                    self._feed("ac3", raw3)
                    return
            raw = (mpeg.parse_vag_payload(payload)
                   if self.kind not in ("lpcm", "mp2", "ac3") else None)
            if raw is not None:
                if self.vag is None:
                    from tcforge_tpu_torch.io.vag import VagStreamDecoder
                    self.vag = VagStreamDecoder()
                pcm = self.vag.feed(raw)
                if pcm is not None and len(pcm):
                    self.entries.append(("pcm", pcm, self.vag.info.rate,
                                         False))

    def finish(self) -> None:
        """The end of the source: VAG's tail and the decoder's flush."""
        if self.vag is not None:
            tail = self.vag.flush()
            if tail is not None and len(tail):
                self.entries.append(("pcm", tail, 0, True))
        if self.dec is not None:
            self.dec.submit("flush")
            self.entries.append(("dec", True))

    def demux_whole(self, sid: int, payload: bytes) -> None:
        """One non-video PES packet of the whole-file reader (the JAX
        importer's ``open`` under ``-L``: its kinds are chosen a little
        differently)."""
        kind = self.kind
        if sid == 0xC0 + self.a_track and kind in (None, "mp2"):
            self.kind = "mp2"
            self._feed("mp2", payload)
        elif sid == mpeg.PES_PRIVATE1:
            got = (mpeg.parse_lpcm_payload(payload, self.a_track)
                   if kind in (None, "lpcm") else None)
            if got is not None:
                self.kind = "lpcm"
                self.entries.append(("pcm", got[0], got[1], False))
                return
            if kind in (None, "ac3"):
                raw = mpeg.parse_ac3_payload(payload, self.a_track)
                if raw is not None:
                    self.kind = "ac3"
                    self._feed("ac3", raw)
                    return
            raw = (mpeg.parse_vag_payload(payload)
                   if kind in (None, "vag") else None)
            if raw is not None:
                self.kind = "vag"
                if self.vag is None:
                    from tcforge_tpu_torch.io.vag import VagStreamDecoder
                    self.vag = VagStreamDecoder()
                pcm = self.vag.feed(raw)
                if pcm is not None and len(pcm):
                    self.entries.append(("pcm", pcm, 0, True))

    def finish_whole(self) -> Tuple[Optional[np.ndarray], int]:
        """The whole file's samples and rate, as the JAX importer's
        ``open`` leaves them under ``-L``."""
        rate = None
        if self.vag is not None:
            tail = self.vag.flush()
            if tail is not None and len(tail):
                self.entries.append(("pcm", tail, 0, True))
            if self.vag.info is not None:
                rate = self.vag.info.rate
        if self.dec is not None:
            self.dec.submit("flush")
            self.entries.append(("dec", True))
        self.settle()
        if self.dec is not None or rate is None:
            rate = self.rate            # the decoder's, or the LPCM's
        if not self.fifo:
            return None, rate
        return np.concatenate(self.fifo), rate

    # -- the decoder's results, in demux order ------------------------- #

    def _resolve(self) -> bool:
        """Take the oldest entry into the fifo; False when none waits."""
        if not self.entries:
            return False
        entry = self.entries.popleft()
        if entry[0] == "pcm":
            _, pcm, rate, quiet = entry
        else:
            quiet = entry[1]
            pcm, rate = self.dec.result()
            if pcm is None:
                return True
        self.put(pcm)
        if not quiet:
            self.seen = True
            self.rate = rate
            self.channels = pcm.shape[1]
        return True

    def settle(self) -> None:
        """Every entry resolved (the JAX importer's state after the same
        demux)."""
        while self._resolve():
            pass

    def seen_now(self) -> bool:
        while not self.seen and self._resolve():
            pass
        return self.seen

    def enough(self, n: int) -> bool:
        while self.have < n and self._resolve():
            pass
        return self.have >= n

    def close(self) -> None:
        if self.dec is not None:
            self.dec.close()
            self.dec = None
        self.entries.clear()


# a transport stream's audio stream types and the decoder kind of each
# (the JAX importer's _ts_audio: MPEG audio, AC-3, ADTS AAC)
_TS_AUDIO = {0x03: "mp3", 0x04: "mp3", 0x81: "ac3", 0x0F: "aac"}
# the audio elementary stream goes to the decoder in pieces of this many
# bytes
_TS_AUDIO_CHUNK = 1 << 14


class _TsTrack:
    """A transport stream's audio track, as the JAX importer's
    ``_ts_audio`` chooses and decodes it: the PMT's first audio stream by
    PID (``-a`` does not apply), its elementary stream decoded by the
    in-tree decoder of its kind in a worker process
    (``io/adec_worker.py``) a few pieces ahead of what the session reads.
    The samples are those of the whole elementary stream decoded at once,
    whatever the pieces.  ``open`` takes the results up to the first
    samples, which give the rate and channels, and gives None, with a
    warning, where the JAX importer has no track: no audio stream in the
    PMT, or a decoder that fails, or a stream that ends, before the
    first samples are taken.  A decoder that fails later ends the track
    there, with a warning: the session keeps every sample decoded before
    the failure, where the JAX importer, which decodes the whole track at
    open, drops the track.  A worker process that ends raises."""

    def __init__(self, samples: StreamSamples, path: str):
        self.samples = samples
        self.path = path
        self.ended = False
        self.rate, self.channels = samples.rate, samples.channels

    @classmethod
    def open(cls, path: str) -> Optional["_TsTrack"]:
        streams = tsio.scan_programs(path)
        apid = next((p for p, st in sorted(streams.items())
                     if st in _TS_AUDIO), None)
        if apid is None:
            _log.warning("[mpeg] %s: no MPEG audio, AC-3 or AAC stream in "
                         "the PMT: the session has no audio track", path)
            return None
        samples = StreamSamples(_TS_AUDIO[streams[apid]], tsio.iter_video_es(
            path, pid=apid, chunk=_TS_AUDIO_CHUNK))
        try:
            error = samples.fill(1, errors=True)
        except BaseException:
            samples.close()
            raise
        if error is not None or not samples.have:
            samples.close()
            why = (f"it fails to decode within its first samples ({error})"
                   if samples.have else "no decodable frame "
                   f"({error or 'the stream ended'})")
            _log.warning("[mpeg] %s: audio PID 0x%x: %s: the session has "
                         "no audio track", path, apid, why)
            return None
        return cls(samples, path)

    def enough(self, n: int) -> bool:
        if not self.ended:
            error = self.samples.fill(n, errors=True)
            if error is not None:
                self.ended = True
                self.samples.close()
                _log.warning("[mpeg] %s: the audio failed to decode part-"
                             "way (%s): the track ends there", self.path,
                             error)
        return self.samples.have >= n

    def take(self, n: int) -> Optional[np.ndarray]:
        return self.samples.take(n)

    def close(self) -> None:
        self.samples.close()


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
    owner: Optional["MpegImporter"] = None   # its importer, under multi


@register
class MpegImporter(Importer):
    info = ModuleInfo(name="mpeg", kind=ModuleKind.DEMULTIPLEXOR,
                      media="both",
                      codecs_out=(Codec.MPEG2, Codec.AC3, Codec.PCM),
                      formats_in=(ContainerFormat.MPEG_PS,
                                  ContainerFormat.MPEG_ES,
                                  ContainerFormat.MPEG_TS))
    desc = ModuleDesc(name="mpeg",
                      comment="MPEG PS/ES demultiplexor (scan_pes)",
                      params=[ParamSpec("track", "video PES id offset",
                                        "d", 0),
                              ParamSpec("stream", "windowed (bounded-"
                                        "memory) reader", "b", 1),
                              ParamSpec("window", "demux window KB",
                                        "d", 256)])
    # False before ``open``: the session takes no audio from this stream,
    # which then demuxes its video alone (the same frames)
    demux_audio = True

    def open(self, path: Optional[str]) -> None:
        self._cdxa_tmp: Optional[str] = None
        self._track = None
        self._bs = None
        try:
            self._open(path)
        except BaseException:
            self.close_host()
            self._remove_cdxa_tmp()
            raise

    def _open(self, path: str) -> None:
        job = self.job
        magic = sniff_magic(path)
        if magic == ContainerFormat.CDXA:
            # a VideoCD track: the sectors' user data to a program stream
            # in a temporary file, which then plays as any other
            fd, tmp = tempfile.mkstemp(suffix=".mpg")
            self._cdxa_tmp = tmp
            with os.fdopen(fd, "wb") as f:
                f.write(cdxa_to_ps(path))
            path, magic = tmp, ContainerFormat.MPEG_PS
        if magic not in (ContainerFormat.MPEG_PS, ContainerFormat.MPEG_ES,
                         ContainerFormat.MPEG_TS):
            raise ValueError(f"{path}: not an MPEG program, transport or "
                             f"elementary stream ({magic.value})")
        seq = mpeg.find_sequence_header(path)
        if seq:
            self.width, self.height, _aspect, self.fps = seq
        # PSU navigation and -L slice the whole elementary stream by its
        # byte ranges: they take the whole-stream reader
        unit = getattr(job, "psu_unit", -1)
        self._streaming = bool(self.options.get("stream", 1)
                               and (unit is None or unit < 0)
                               and not getattr(job, "seek_unit", 0)
                               and not getattr(job, "vob_offset", 0))
        ts = magic == ContainerFormat.MPEG_TS
        self._track = (_Track(getattr(job, "a_track", 0))
                       if self.demux_audio and not ts else None)
        self._ts_track: Optional[_TsTrack] = None
        if self.demux_audio and ts:
            self._ts_track = _TsTrack.open(path)
            if self._ts_track is not None:
                self.audio_rate = self._ts_track.rate
                self.audio_channels = self._ts_track.channels
        self._apcm: Optional[np.ndarray] = None
        self._apos = 0
        if self._streaming:
            self._win_bytes = max(4, self.options.get("window", 256)) << 10
            self._audio_done = False
            # the discovery budget: a program stream's audio shows up
            # within its first packs; an elementary stream has none
            self._audio_probe = 2 if magic == ContainerFormat.MPEG_PS else 0
            if magic == ContainerFormat.MPEG_PS:
                self._src = self._ps_video_chunks(path)
            elif ts:
                self._src = tsio.iter_video_es(
                    path, pid=getattr(job, "ts_pid1", 0) or None)
            else:
                self._src = self._file_chunks(path)
            self._bs = Mpeg2Bitstream(next(self._src, b""), streaming=True)
            # pump until the sequence header is in the window
            while not self._bs.width and self._pump_stream():
                pass
            # the track as the JAX importer knows it after the same pumps
            if self._track is not None:
                self._track.settle()
                if self._track.seen:
                    self.audio_rate = self._track.rate
                    self.audio_channels = self._track.channels
        else:
            self._es = self._units(self._whole_es(path, magic))
            self._bs = Mpeg2Bitstream(self._es)
        if self._bs.width:
            self.width, self.height = self._bs.width, self._bs.height
            self.fps = self._bs.fps
        # 1: 4:2:0, 2: 4:2:2; -V yuv422p sessions keep 4:2:2 sources at
        # full vertical chroma (no decimation and upsampling round trip)
        self.chroma = 2 if self._bs.chroma == 2 else 1
        self.format = (ImageFormat.YUV422P
                       if self.chroma == 2
                       and job.im_colorspace == ImageFormat.YUV422P
                       else ImageFormat.YUV420P)
        self._reset_decoder()
        self._device: Optional[torch.device] = None
        self._frames: Dict[int, Tuple[torch.Tensor, ...]] = {}
        self._uploaded = 0

    # -- input -------------------------------------------------------- #

    def _whole_es(self, path: str, magic) -> bytes:
        """The whole video elementary stream; a program stream's audio
        track decoded whole beside it (``_apcm``)."""
        if magic == ContainerFormat.MPEG_TS:
            return b"".join(tsio.iter_video_es(
                path, pid=getattr(self.job, "ts_pid1", 0) or None))
        if magic != ContainerFormat.MPEG_PS:
            with open(path, "rb") as f:
                return f.read()
        es = bytearray()
        track = self._track
        for sid, payload in mpeg.iter_pes_packets(path):
            if 0xE0 <= sid <= 0xEF:
                es += payload
            elif track is not None:
                track.demux_whole(sid, payload)
        if track is None:
            return bytes(es)
        self._apcm, rate = track.finish_whole()
        track.close()
        if rate is not None:
            self.audio_rate = rate
        if self._apcm is not None:
            self.audio_channels = self._apcm.shape[1]
        return bytes(es)

    def _units(self, es: bytes) -> bytes:
        """The stream as PSU navigation cuts it (the JAX importer's
        ``open``): ``psu_unit`` keeps one program stream unit (a run of
        the stream between two sequence headers), or with ``psu_unit_end``
        (``--no_split``) the units up to it; ``seek_unit`` (``-S``) starts
        at a unit and runs to the end."""
        job = self.job
        unit = getattr(job, "psu_unit", -1)
        if unit is not None and unit >= 0:
            ranges = mpeg.es_unit_ranges(es)
            if unit >= len(ranges):
                raise ValueError(f"mpeg: PSU {unit} out of range "
                                 f"({len(ranges)} units)")
            a, b = ranges[unit]
            end_unit = getattr(job, "psu_unit_end", -1) or -1
            if end_unit > unit:
                b = ranges[min(end_unit, len(ranges)) - 1][1]
            return es[a:b]
        su = getattr(job, "seek_unit", 0)
        if su > 0:
            ranges = mpeg.es_unit_ranges(es)
            if su >= len(ranges):
                raise ValueError(f"mpeg: -S unit {su} out of range "
                                 f"({len(ranges)} units)")
            return es[ranges[su][0]:]
        return es

    def _file_chunks(self, path: str) -> Iterator[bytes]:
        with open(path, "rb") as f:
            while True:
                b = f.read(self._win_bytes)
                if not b:
                    return
                yield b

    def _ps_video_chunks(self, path: str) -> Iterator[bytes]:
        """The program stream's video PES payloads in windows of at
        least ``_win_bytes``; the audio packets go to the track as the
        demux meets them, and the track finishes before the last
        window."""
        buf = bytearray()
        for sid, payload in mpeg.iter_pes_packets(
                path, chunk=max(self._win_bytes, 1 << 16)):
            if 0xE0 <= sid <= 0xEF:
                buf += payload
                if len(buf) >= self._win_bytes:
                    yield bytes(buf)
                    buf.clear()
            elif self._track is not None:
                self._track.demux(sid, payload)
        if self._track is not None:
            self._track.finish()
        if buf:
            yield bytes(buf)

    def _pump_stream(self) -> bool:
        """Feed the next window to the parse; False at the end of the
        source (the parse then treats a cut picture as broken)."""
        more = next(self._src, None)
        if more is None:
            self._bs.set_eos()
            self._audio_done = True
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

    def start(self, device: torch.device, buffers: int = 1,
              pool: Optional["queue.Queue[_Buffer]"] = None) -> None:
        """Decode onto ``device`` with a ring of ``buffers`` host buffers
        (pinned on a card): ``plan_batch`` takes one, ``execute`` gives
        it back once its upload is queued.  ``pool``: the ring of an
        importer of the same size that this one shares
        (``buffer_pool``)."""
        self._device = torch.device(device)
        self._shapes = coef_shapes(self.width, self.height, self.chroma)
        if pool is not None:
            self.buffer_pool = pool
            return
        pinned = self._device.type == "cuda"
        self.buffer_pool: "queue.Queue[_Buffer]" = queue.Queue()
        for _ in range(buffers):
            self.buffer_pool.put(_Buffer(self._shapes, 16, pinned))

    def _take_buffer(self, alive) -> Optional[_Buffer]:
        """A free host buffer, once its last upload is done; None when
        ``alive()`` turns false while it waits."""
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
        if buf.shapes != self._shapes:
            self.buffer_pool.put(buf)
            raise ValueError("a shared buffer ring holds another coded "
                             "size or chroma format than this stream's")
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
            if self.chroma == 2 and ptype == 1:
                # a 4:2:2 intra frame picture: alone, through the float64
                # IDCT with its field-DCT deinterleave
                h = self._handle()
                plan.ops.append(("intra422", k, h))
                advance_ref(h)
                continue
            if (self.chroma == 1 and ptype in (1, 4)
                    and not (slot[3][:, 0] & MBF_FIELD_DCT).any()):
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
            self.buffer_pool.put(buf)

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
        chroma = self.chroma
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
                    top_field_first=tff, chroma=chroma)
            elif kind == "intra422":
                _, k, h = op
                frames[h] = mpeg2codec.reconstruct_intra_422(*slot(k))
            elif kind == "field":
                _, k, ptype, ps, mb_rows, pend, fh, bh, h = op
                yc, uc, vc, mbinfo = slot(k)
                pending = (None if pend is None
                           else (pend[0], frames[pend[1]], None))
                planes, _parity = mpeg2codec.decode_field_step(
                    ptype, ps, yc, uc, vc, mbinfo, mb_rows, pending,
                    None if fh is None else frames[fh],
                    None if bh is None else frames[bh], chroma)
                frames[h] = planes
            else:                         # "weave"
                _, pend, h, parity, mb_h, fh = op
                frames[fh] = mpeg2codec.weave_to_frame(
                    (pend[0], frames[pend[1]], None), frames[h], parity,
                    mb_h, chroma)
        out = None
        if plan.frames:
            hh, ww = self.height, self.width
            ch = hh if chroma == 2 else hh // 2
            sizes = ((hh, ww), (ch, ww // 2), (ch, ww // 2))
            out = {key: torch.stack([frames[h][i][:s[0], :s[1]]
                                     for h in plan.frames])
                   for i, (key, s) in enumerate(zip("yuv", sizes))}
            if chroma == 2 and self.format != ImageFormat.YUV422P:
                # into the 4:2:0 chain: row pairs averaged
                for key in "uv":
                    out[key] = mpeg2codec.chroma_422_to_420(out[key])
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
        start_on_the_card(self)
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
        start_on_the_card(self)
        while True:
            plan = self.plan_batch(n)
            if plan is None:
                return None
            out = self.execute(plan)
            if out is not None:
                return out

    def read_audio_batch(self, n_samples: int) -> Optional[np.ndarray]:
        """The track's next ``n_samples`` samples, (S, C) int16, fewer
        at its end, or None (no track, or none seen yet: the JAX
        importer's discovery budget of two pumps, after which a track
        shows only as the video's pumps meet it)."""
        if self._ts_track is not None:
            self._ts_track.enough(n_samples)
            return self._ts_track.take(n_samples)
        if not self._streaming:
            if self._apcm is None:
                return None
            chunk = self._apcm[self._apos:self._apos + n_samples]
            if chunk.shape[0] == 0:
                return None
            self._apos += chunk.shape[0]
            return chunk
        track = self._track
        if track is None:
            return None
        while (not track.seen_now() and not self._audio_done
               and self._audio_probe > 0):
            self._audio_probe -= 1
            if not self._pump_stream():
                break
        if not track.seen_now():
            return None
        while not track.enough(n_samples) and not self._audio_done:
            if not self._pump_stream():
                break
        track.enough(n_samples)
        return track.take(n_samples)

    def seek(self, frame: int) -> bool:
        """-L: cut the elementary stream at the last sequence header
        whose coded-picture count is at most ``frame``, then decode and
        drop the rest (the JAX importer's buffered ``seek``); the audio
        track moves to the same time."""
        if self._streaming:
            left = frame
            while left > 0:
                got = self.read_video_batch(min(left, 16))
                if got is None:
                    return False
                left -= got["y"].shape[0]
            drop = int(round(frame * self.audio_rate / self.fps)) \
                if self.fps else 0
            while drop > 0:
                a = self.read_audio_batch(min(drop, 48000))
                if a is None:
                    break
                drop -= a.shape[0]
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
        if self._apcm is not None and self.fps:
            self._apos = min(self._apcm.shape[0],
                             int(round(frame * self.audio_rate / self.fps)))
        elif self._ts_track is not None and self.fps:
            # the same cut as the whole track's, or its end
            drop = int(round(frame * self.audio_rate / self.fps))
            self._ts_track.enough(drop)
            self._ts_track.take(drop)
        left = frame - best_count
        while left > 0:
            got = self.read_video_batch(min(left, 16))
            if got is None:
                break
            left -= got["y"].shape[0]
        return True

    def close_host(self) -> None:
        """Close the parse and the audio track; the decoded frames on the
        device stay for the plans not run yet."""
        if getattr(self, "_bs", None) is not None:
            self._bs.close()
            self._bs = None
        for name in ("_track", "_ts_track"):
            track = getattr(self, name, None)
            if track is not None:
                track.close()
                setattr(self, name, None)

    def _remove_cdxa_tmp(self) -> None:
        if getattr(self, "_cdxa_tmp", None):
            try:
                os.unlink(self._cdxa_tmp)
            except OSError:
                pass
            self._cdxa_tmp = None

    def close(self) -> None:
        self.close_host()
        self._remove_cdxa_tmp()
        self._frames = {}

