"""The ``ogg`` importer (``tcforge_tpu/modules/importers/ogg_import.py``,
import_ogg.c's role): the container through the pinned ``io/ogg.py``.

It reads what the ``ogg`` multiplexor writes: OGM raw video (I420 or
YV12) as host planes, OGM PCM audio, and Vorbis audio, decoded whole at
``open`` by the pinned float64 decoder (``io/vorbis.py``) and rounded to
int16 as the JAX module rounds it.  Other OGM raw fourccs raise the JAX
module's ``NotImplementedError``; an Ogg with no stream it reads raises
its message too.  A DivX or Xvid OGM video stream is not decoded, as in
the JAX module: such a file plays as its audio alone.  Theora video (the
JAX module's ``io/theora.py``) is refused by name, except where the file
serves as ``-p`` (``video_wanted`` False), which takes its audio alone.

``demux_audio`` False (set before ``open``) skips the audio of a file
with video, as the MPEG and AVI importers skip theirs: the session takes
no audio from it, and the Vorbis decode costs seconds a second of audio.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from tcforge_tpu_torch.core.codecs import Codec, ContainerFormat
from tcforge_tpu_torch.core.optstr import ModuleDesc
from tcforge_tpu_torch.io.ogg import (identify_streams, iter_pages,
                                      ogm_parse_data_packet,
                                      pages_to_packets)
from tcforge_tpu_torch.modules.registry import (Importer, ModuleInfo,
                                                ModuleKind, register)

_RAW_FOURCC = {"I420", "YV12", "UYVY", "YUY2", "RGB ", "DIB "}


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
        if v_theora and self.video_wanted:
            raise NotImplementedError(
                "ogg: Theora video (the JAX package's io/theora.py "
                "decoder) is not ported to the torch port yet")
        self._vpayloads: List[bytes] = []
        self._apcm = b""
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

    def read_video_batch(self, n: int) -> Optional[Dict[str, np.ndarray]]:
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
