"""The ``ogg`` multiplexor (``tcforge_tpu/modules/muxers/ogg_mux.py``,
multiplex_ogg.c's role): the OggDS ("OGM") layout through the pinned
``io/ogg.py`` (pages, lacing, CRC).

One logical stream a medium: the video stream carries OGM raw payloads
behind an ``ogm_video_header`` (its fourcc is the ``fourcc`` option
alone) and a comment header; the audio stream is the native Vorbis
logical stream where the ``vorbis`` encoder left its header packets in
``job.extradata``, else OGM PCM.  Every BOS page comes first.  A Vorbis
packet is held back one write, so that the last page can carry the true
sample count (``vorbis_total_samples``, set by the encoder's flush) as
its granule.  The audio stream exists only where the session's audio
comes here (no ``-m``), as in the JAX module.

Where the ``theora`` encoder left its three header packets in
``job.extradata["theora_headers"]``, the video stream is a native Theora
logical stream instead: the identification packet on the BOS page, the
comment and setup packets after every BOS page, then one packet a page
with the granule ``(key frame number << kfgshift) | frames since it``
(frame numbers from 1, Theora I A.1), the key frame told by the packet's
first byte and ``kfgshift`` read from the identification packet.

``stream=`` (the JAX module's shout tee) sends every page over the
network; the port refuses it by name.
"""

from __future__ import annotations

import struct

from tcforge_tpu_torch.core.codecs import Codec, ContainerFormat
from tcforge_tpu_torch.core.optstr import ModuleDesc, ParamSpec
from tcforge_tpu_torch.io.ogg import (OggPageWriter, ogm_audio_header,
                                      ogm_comment_header, ogm_data_packet,
                                      ogm_video_header)
from tcforge_tpu_torch.modules.encoders.vorbis_enc import \
    unpack_header_packets
from tcforge_tpu_torch.modules.registry import (ModuleInfo, ModuleKind,
                                                Muxer, register)


@register
class OggMuxer(Muxer):
    info = ModuleInfo(name="ogg", kind=ModuleKind.MULTIPLEXOR,
                      media="both", codecs_in=(Codec.ANY,),
                      formats_out=(ContainerFormat.OGG,))
    desc = ModuleDesc(
        name="ogg", comment="OGG/OGM multiplexor (OggDS raw payloads)",
        params=[ParamSpec("fourcc", "video stream fourcc", "s", "I420"),
                ParamSpec("stream", "enable shout streaming using given "
                          "label as identifier (shout.cfg section)",
                          "s", "")])

    V_SERIAL = 0x0001CAFE
    A_SERIAL = 0x0002CAFE

    def open(self, path: str) -> None:
        if self.options.get("stream", ""):
            raise NotImplementedError(
                "ogg: stream= (shout streaming to an icecast server) "
                "sends pages over the network; it is not ported to the "
                "torch port")
        self._f = open(path, "wb")
        job = self.job
        self._vw = None
        self._aw = None
        self._frames = 0
        self._samples = 0
        w = job.ex_v_width or job.im_v_width
        h = job.ex_v_height or job.im_v_height
        # the native Theora logical stream where the theora encoder left
        # its header packets
        self._theora = None
        self._kfgshift = 6
        self._vkey_base = 0            # frame number of the last key
        if "theora_headers" in job.extradata:
            pkts = unpack_header_packets(job.extradata["theora_headers"])
            self._theora = pkts if len(pkts) == 3 else None
        if self._theora:
            ident = self._theora[0]
            # KFGSHIFT: 5 bits of the QUAL/KFGSHIFT/PF word at bytes 40-41
            # of the identification packet (Theora I 6.2)
            if len(ident) >= 42:
                word = (ident[40] << 8) | ident[41]
                self._kfgshift = (word >> 5) & 0x1F
        if w and h:
            self._vw = OggPageWriter(self._f, self.V_SERIAL)
        # audio where the session carries a track
        rate = job.mp3frequency or job.a_rate
        # the native Vorbis logical stream where the vorbis encoder left
        # its three header packets
        self._vorbis = b""
        if "vorbis_headers" in job.extradata:
            self._vorbis = unpack_header_packets(
                job.extradata["vorbis_headers"])
            (self._hop,) = struct.unpack("<I", job.extradata["vorbis_hop"])
        if ((getattr(job, "dm_chan", 0) and rate) or self._vorbis) \
                and job.audio_out_file is None:
            self._aw = OggPageWriter(self._f, self.A_SERIAL)
        # every BOS page first, then each stream's other header pages
        if self._vw:
            if self._theora:
                self._vw.write_packet(self._theora[0], 0, flush=True)
            else:
                hdr = ogm_video_header(self.options["fourcc"], w, h,
                                       job.fps or 25.0)
                self._vw.write_packet(hdr, 0, flush=True)
        if self._aw:
            if self._vorbis:
                self._aw.write_packet(self._vorbis[0], 0, flush=True)
                self._held = None      # the packet held back
            else:
                self._block = job.dm_chan * (job.dm_bits // 8)
                hdr = ogm_audio_header(rate, job.dm_chan, job.dm_bits,
                                       self._block)
                self._aw.write_packet(hdr, 0, flush=True)
        if self._vw and self._theora:
            self._vw.write_packet(self._theora[1], 0, flush=False)
            self._vw.write_packet(self._theora[2], 0, flush=True)
        elif self._vw:
            # an OGM stream carries two header packets (BOS and comment)
            self._vw.write_packet(ogm_comment_header(), 0, flush=True)
        if self._aw and self._vorbis:
            self._aw.write_packet(self._vorbis[1], 0, flush=False)
            self._aw.write_packet(self._vorbis[2], 0, flush=True)
        elif self._aw:
            self._aw.write_packet(ogm_comment_header(), 0, flush=True)

    def write_video(self, payload: bytes, keyframe: bool = True) -> int:
        if self._theora:
            # an inter frame has bit 0x40 of its first byte set (Theora I
            # 7.1); a zero-length packet repeats the frame before it
            i = self._frames
            if payload and not (payload[0] & 0x40):
                self._vkey_base = i + 1
            self._frames += 1
            granule = (self._vkey_base << self._kfgshift) \
                | (i + 1 - self._vkey_base)
            self._vw.write_packet(payload, granule, flush=True)
            return len(payload)
        self._frames += 1
        pkt = ogm_data_packet(payload, 1, keyframe)
        self._vw.write_packet(pkt, self._frames, flush=True)
        return len(payload)

    def write_audio(self, payload: bytes, track: int = 0) -> int:
        if self._aw is None:
            return 0
        if self._vorbis:
            # one Vorbis packet a payload; the granule is the samples
            # decodable through the page's last packet ((k-1)*hop for
            # packet k); the newest packet waits for the next write
            if self._held is not None:
                self._aw.write_packet(self._held,
                                      self._clamped(self._samples),
                                      flush=True)
                self._samples += self._hop
            self._held = payload
            return len(payload)
        samples = len(payload) // max(1, self._block)
        self._samples += samples
        pkt = ogm_data_packet(payload, samples, True)
        self._aw.write_packet(pkt, self._samples, flush=True)
        return len(payload)

    def _clamped(self, granule: int) -> int:
        """At most the true sample count, once the encoder's flush has
        reported it."""
        total = self.job.extradata.get("vorbis_total_samples")
        if total is not None:
            (true_len,) = struct.unpack("<Q", total)
            granule = min(granule, true_len)
        return granule

    def close(self) -> None:
        if self._vw:
            self._vw.close()
        if self._aw:
            if self._vorbis and self._held is not None:
                self._aw.write_packet(self._held,
                                      self._clamped(self._samples),
                                      flush=True)
                self._held = None
            self._aw.close()
        self._f.close()
