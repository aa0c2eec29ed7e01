"""The ``ogg`` importer (``tcforge_tpu/modules/importers/ogg_import.py``,
import_ogg.c's role): the container through the pinned ``io/ogg.py``.

It reads what the ``ogg`` multiplexor writes: OGM raw video (I420 or
YV12) as host planes, OGM PCM audio, and Vorbis audio, decoded whole at
``open`` by the pinned float64 decoder (``io/vorbis.py``) and rounded to
int16 as the JAX module rounds it.  Other OGM raw fourccs raise the JAX
module's ``NotImplementedError``; an Ogg with no stream it reads raises
its message too.  A DivX or Xvid OGM video stream is not decoded, as in
the JAX module: such a file plays as its audio alone.

Theora video decodes as the JAX module's in-tree route does
(``io/theora.py``, taken without its FFmpeg bridge or with
``TCFORGE_NATIVE_THEORA=1``), through the plan/execute protocol: the
reader thread parses each data packet and decodes its tokens on the host
(``io/theoracodec.py``), the main thread reconstructs the frames in turn
on the device (``theora_recon`` and ``theora_loop_filter``), crops each
to the picture and then, as the JAX module does, to the stream's width
and height with 4:2:0 chroma (``u[:h // 2, :w // 2]``, also for a 4:2:2
or 4:4:4 stream, which keeps the top-left part of its chroma).  A
zero-length packet repeats the frame shown before it, also one that went
out in the batch before; a stray header packet shows nothing.  Where the
file serves as ``-p`` (``video_wanted`` False) its video is not decoded.

``demux_audio`` False (set before ``open``) skips the audio of a file
with video, as the MPEG and AVI importers skip theirs: the session takes
no audio from it, and the Vorbis decode costs seconds a second of audio.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from tcforge_tpu_torch.core.codecs import Codec, ContainerFormat
from tcforge_tpu_torch.core.optstr import ModuleDesc
from tcforge_tpu_torch.io.ogg import (identify_streams, iter_pages,
                                      ogm_parse_data_packet,
                                      pages_to_packets)
from tcforge_tpu_torch.modules.importers import start_on_the_card
from tcforge_tpu_torch.modules.importers.dv_import import pick_frames
from tcforge_tpu_torch.modules.registry import (Importer, ModuleInfo,
                                                ModuleKind, register)

_RAW_FOURCC = {"I420", "YV12", "UYVY", "YUY2", "RGB ", "DIB "}


@dataclass
class TheoraPlan:
    """A batch of the Theora decode: each decoded packet's records and
    handle, the handles shown (a repeat shows its frame's again) and the
    one kept for a repeat in a later batch."""

    records: list
    decoded: List[int]
    frames: List[int] = field(default_factory=list)
    live: List[int] = field(default_factory=list)


@register
class OggImporter(Importer):
    info = ModuleInfo(name="ogg", kind=ModuleKind.DEMULTIPLEXOR,
                      media="both",
                      codecs_out=(Codec.YUV420P, Codec.PCM),
                      formats_in=(ContainerFormat.OGG,))
    desc = ModuleDesc(name="ogg", comment="OGG/OGM container (raw OGM "
                      "video + PCM/Vorbis decode; theora native or "
                      "via the FFmpeg bridge)")
    demux_audio = True
    video_wanted = True     # False: the file is -p's, its audio alone

    def open(self, path: Optional[str]) -> None:
        with open(path, "rb") as f:
            streams = identify_streams(f)
        video = next((s for s in streams if s.kind == "video"), None)
        audio = next((s for s in streams if s.kind == "audio"), None)
        v_ok = video is not None and video.codec in _RAW_FOURCC
        v_theora = video is not None and video.codec == "theora"
        a_ok = audio is not None and audio.codec in ("0001", "pcm",
                                                     "PCM ")
        a_vorbis = audio is not None and audio.codec == "vorbis"
        if not v_ok and not a_ok and not a_vorbis and not v_theora:
            found = ", ".join(f"{s.codec} ({s.kind})"
                              for s in streams) or "none"
            raise NotImplementedError(
                f"ogg: found streams: {found} — no theora/divx "
                "decoder in this build; use tcdemux to extract "
                "streams, or transcode the decoded output of an "
                "external decoder")
        self._vpayloads: List[bytes] = []
        self._theora = None
        self._apcm = b""
        if v_theora and self.video_wanted:
            self._open_theora(path, video)
        if v_ok:
            if video.codec not in ("I420", "YV12"):
                raise NotImplementedError(
                    f"ogg: OGM raw fourcc {video.codec!r} not wired yet "
                    "(I420/YV12 supported)")
            self.width, self.height = video.width, video.height
            self.fps = video.fps or 25.0
            self._fourcc = video.codec
            with open(path, "rb") as f:
                for _, pkt in pages_to_packets(iter_pages(f),
                                               serial=video.serial):
                    if pkt and not (pkt[0] & 0x01):
                        payload, _, _ = ogm_parse_data_packet(pkt)
                        self._vpayloads.append(payload)
        # the audio of a file with video only where the session takes it
        take_audio = self.demux_audio or not self.width
        if a_ok and take_audio:
            self.audio_rate = audio.samplerate
            self.audio_channels = audio.channels or 2
            with open(path, "rb") as f:
                chunks = []
                for _, pkt in pages_to_packets(iter_pages(f),
                                               serial=audio.serial):
                    if pkt and not (pkt[0] & 0x01):
                        payload, _, _ = ogm_parse_data_packet(pkt)
                        chunks.append(payload)
                self._apcm = b"".join(chunks)
        elif a_vorbis and take_audio:
            from tcforge_tpu_torch.io.vorbis import VorbisDecoder
            dec = VorbisDecoder()
            self.audio_rate = audio.samplerate
            self.audio_channels = audio.channels or 2
            pcm_chunks = []
            with open(path, "rb") as f:
                for _, pkt in pages_to_packets(iter_pages(f),
                                               serial=audio.serial):
                    if not pkt:
                        continue
                    if pkt[0] & 0x01:          # a header packet (1/3/5)
                        dec.header_packet(pkt)
                        continue
                    out = dec.audio_packet(pkt)
                    if out is not None and len(out):
                        pcm_chunks.append(np.clip(
                            np.rint(out * 32768.0),
                            -32768, 32767).astype("<i2"))
            if pcm_chunks:
                self._apcm = np.concatenate(pcm_chunks).tobytes()
            self.audio_channels = dec.channels or self.audio_channels
        self._vpos = 0
        self._apos = 0
        self.total_frames = len(self._vpayloads) or None

    def _open_theora(self, path: str, video) -> None:
        from tcforge_tpu_torch.io.theoracodec import TheoraDeviceDecoder
        hdrs: List[bytes] = []
        with open(path, "rb") as f:
            for _, pkt in pages_to_packets(iter_pages(f),
                                           serial=video.serial):
                if len(hdrs) < 3:
                    hdrs.append(pkt)
                else:
                    # zero-length packets repeat the frame before them
                    self._vpayloads.append(pkt)
        self._theora = True
        self.planned = True
        self._device: Optional[torch.device] = None
        # the headers parsed (and their Huffman tables checked) at open
        self._dec = TheoraDeviceDecoder(hdrs, "cpu")
        self._handles = 0
        self._shown: Optional[int] = None
        self._kept: Dict[int, Dict[str, torch.Tensor]] = {}
        self.width, self.height = video.width, video.height
        self.fps = video.fps or 25.0

    def start(self, device: torch.device, buffers: int = 1) -> None:
        """Decode Theora onto ``device``."""
        self._device = torch.device(device)
        self._dec.device = self._device

    def plan_batch(self, n: int, alive=None) -> Optional[TheoraPlan]:
        """The next ``n`` packets parsed on the host; None when none is
        left or none of them shows a frame (the JAX module's batch of no
        frame ends the stream)."""
        if self._device is None:
            raise RuntimeError("OggImporter.start() was not called")
        if self._vpos >= len(self._vpayloads):
            return None
        take = self._vpayloads[self._vpos:self._vpos + n]
        self._vpos += len(take)
        plan = TheoraPlan([], [])
        for pkt in take:
            if not pkt:
                if self._shown is not None:
                    plan.frames.append(self._shown)
                continue
            rec = self._dec.parse(pkt)
            if rec is None:
                continue
            self._handles += 1
            plan.records.append(rec)
            plan.decoded.append(self._handles)
            plan.frames.append(self._handles)
            self._shown = self._handles
        if not plan.frames:
            return None
        plan.live = [self._shown]
        return plan

    def execute(self, plan: TheoraPlan, copy_stream=None
                ) -> Optional[Dict[str, torch.Tensor]]:
        """The device half: the frames reconstructed in turn, cropped."""
        w, h = self.width, self.height
        got = []
        for rec in plan.records:
            self._dec.reconstruct(rec)
            y, u, v = self._dec.crop()
            got.append((y[:h, :w], u[:h // 2, :w // 2], v[:h // 2, :w // 2]))
        made = {k: torch.stack([g[i] for g in got]) for i, k in
                enumerate("yuv")} if got else {}
        return pick_frames(plan.decoded, plan.frames, plan.live, made,
                           self._kept)

    def release(self, plan) -> None:
        pass

    def seek(self, frame: int) -> bool:
        return False

    def read_video_batch(self, n: int) -> Optional[Dict[str, np.ndarray]]:
        if self._theora:
            start_on_the_card(self)
            plan = self.plan_batch(n)
            return None if plan is None else self.execute(plan)
        if self._vpos >= len(self._vpayloads):
            return None
        take = self._vpayloads[self._vpos:self._vpos + n]
        self._vpos += len(take)
        w, h = self.width, self.height
        ys, us, vs = [], [], []
        for raw in take:
            buf = np.frombuffer(raw, np.uint8)
            y = buf[:w * h].reshape(h, w)
            c1 = buf[w * h:w * h + w * h // 4].reshape(h // 2, w // 2)
            c2 = buf[w * h + w * h // 4:w * h + w * h // 2] \
                .reshape(h // 2, w // 2)
            u, v = (c1, c2) if self._fourcc == "I420" else (c2, c1)
            ys.append(y)
            us.append(u)
            vs.append(v)
        return {"y": np.stack(ys), "u": np.stack(us), "v": np.stack(vs)}

    def read_audio_batch(self, samples: int) -> Optional[np.ndarray]:
        ch = self.audio_channels
        nbytes = samples * ch * 2
        chunk = self._apcm[self._apos:self._apos + nbytes]
        if not chunk:
            return None
        self._apos += len(chunk)
        a = np.frombuffer(chunk, np.int16)
        usable = (a.shape[0] // ch) * ch
        return a[:usable].reshape(-1, ch)

    def close(self) -> None:
        pass
