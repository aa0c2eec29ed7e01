"""The compressed-audio encoders ``lame``, ``mp2enc`` (alias ``toolame``),
``ac3enc``, ``faac`` and ``flac`` (``tcforge_tpu/modules/encoders/
av_audio_enc.py``).

The JAX modules encode through the FFmpeg bridge where it is built, and
through the in-tree spec encoders where it is not (or where
``TCFORGE_NATIVE_MP3ENC``, ``_MP2ENC``, ``_AC3ENC``, ``_AACENC`` or
``_FLAC`` is 1).  The port carries no FFmpeg, so it always takes the
in-tree encoders, as pinned copies: ``io/mp3enc.py``
(``NativeMp3Encoder``), ``io/mpaenc.py`` (``NativeAudioEncoder``),
``io/a52enc.py`` (``NativeAc3Encoder``), ``io/aacenc.py``
(``NativeAacEncoder``, ADTS AAC-LC) and ``io/flac.py``
(``NativeFlacEncoder``).  The bridge's libmp3lame, twolame, AC-3, AAC
and FLAC bytes are not the port's.

PCM batches in, framed output: one payload a coded frame (1152 or 576
samples of MP3, 1152 of MP2, 1536 of AC-3, 1024 of AAC, a FLAC frame),
which keeps the multiplexors' timelines exact.  The rate is ``-E``'s (``mp3frequency``) or the input's,
the channels ``dm_chan``, the bitrate the ``bitrate`` option, else
``-b`` (``mp3bitrate``) where set, else the module's default;
``job.extradata`` gets ``audio_byte_rate`` (the AVI multiplexor's
stream header) and ``audio_frame_size``, as the JAX module sets them.
The engine runs the encoder on its writer thread.  ``vorbis`` is
``vorbis_enc.py``.
"""

from __future__ import annotations

import struct
from typing import List

import numpy as np

from tcforge_tpu_torch.core.codecs import Codec
from tcforge_tpu_torch.core.frame import AudioBatch
from tcforge_tpu_torch.core.optstr import ModuleDesc, ParamSpec
from tcforge_tpu_torch.io.a52enc import NativeAc3Encoder
from tcforge_tpu_torch.io.aacenc import NativeAacEncoder
from tcforge_tpu_torch.io.flac import NativeFlacEncoder
from tcforge_tpu_torch.io.mp3enc import NativeMp3Encoder
from tcforge_tpu_torch.io.mpaenc import NativeAudioEncoder
from tcforge_tpu_torch.modules.registry import (Encoder, ModuleInfo,
                                                ModuleKind, register)


class _InTreeAudioEncoder(Encoder):
    default_kbps = 192
    codec: type  # the in-tree encoder, called with (rate, channels, bps)

    def __init__(self, job, options: str = ""):
        super().__init__(job, options)
        rate = job.mp3frequency or job.a_rate
        ch = job.dm_chan or job.a_chan or 2
        kbps = int(self.options.get("bitrate", 0) or 0) \
            or (job.mp3bitrate if getattr(job, "mp3bitrate", 0)
                else self.default_kbps)
        self._enc = self.codec(rate, ch, kbps * 1000)
        self._enc.set_framed(True)
        job.extradata["audio_byte_rate"] = struct.pack("<I",
                                                       kbps * 1000 // 8)
        if self._enc.extradata:
            job.extradata["audio_extradata"] = self._enc.extradata
        if self._enc.frame_size:
            job.extradata["audio_frame_size"] = struct.pack(
                "<I", self._enc.frame_size)

    def encode_video(self, fb) -> List[bytes]:
        raise NotImplementedError(
            f"{self.info.name} is an audio-only encoder")

    def encode_audio(self, ab: AudioBatch) -> List[bytes]:
        pcm = np.asarray(ab.pcm)
        self._enc.feed(pcm.reshape(-1, pcm.shape[-1]))
        return self._enc.read_packets()

    def flush(self) -> List[bytes]:
        self._enc.flush()
        out = self._enc.read_packets()
        self.last_flush_frames = 0
        return out


@register
class LameEncoder(_InTreeAudioEncoder):
    info = ModuleInfo(name="lame", kind=ModuleKind.ENCODER,
                      media="audio", codecs_in=(Codec.PCM,),
                      codecs_out=(Codec.MP3,))
    desc = ModuleDesc(
        name="lame", comment="MP3 audio encoder (the in-tree "
        "io/mp3enc.py spec encoder; the encode_lame.c role)",
        params=[ParamSpec("bitrate", "bitrate kbps", "d", 0, 0, 320)])
    default_kbps = 128
    codec = NativeMp3Encoder


@register
class Mp2Encoder(_InTreeAudioEncoder):
    info = ModuleInfo(name="mp2enc", kind=ModuleKind.ENCODER,
                      media="audio", codecs_in=(Codec.PCM,),
                      codecs_out=(Codec.MP2,))
    desc = ModuleDesc(
        name="mp2enc", comment="MPEG-1 layer II audio encoder (the "
        "in-tree io/mpaenc.py spec encoder; VCD/SVCD audio, the "
        "toolame/mp2enc role)",
        params=[ParamSpec("bitrate", "bitrate kbps", "d", 0, 0, 384)])
    default_kbps = 224
    codec = NativeAudioEncoder


@register
class Ac3Encoder(_InTreeAudioEncoder):
    info = ModuleInfo(name="ac3enc", kind=ModuleKind.ENCODER,
                      media="audio", codecs_in=(Codec.PCM,),
                      codecs_out=(Codec.AC3,))
    desc = ModuleDesc(
        name="ac3enc", comment="AC-3 audio encoder (the in-tree "
        "io/a52enc.py spec encoder; DVD audio, pairs with the mpg "
        "muxer's private sub-stream)",
        params=[ParamSpec("bitrate", "bitrate kbps", "d", 0, 0, 640)])
    codec = NativeAc3Encoder


@register
class FaacEncoder(_InTreeAudioEncoder):
    info = ModuleInfo(name="faac", kind=ModuleKind.ENCODER,
                      media="audio", codecs_in=(Codec.PCM,),
                      codecs_out=(Codec.AAC,))
    desc = ModuleDesc(
        name="faac", comment="AAC audio encoder (the in-tree "
        "io/aacenc.py LC encoder; the encode_faac.c role)",
        params=[ParamSpec("bitrate", "bitrate kbps", "d", 0, 0, 320)])
    default_kbps = 128
    codec = NativeAacEncoder


@register
class FlacEncoder(_InTreeAudioEncoder):
    info = ModuleInfo(name="flac", kind=ModuleKind.ENCODER,
                      media="audio", codecs_in=(Codec.PCM,),
                      codecs_out=(Codec.FLAC,))
    desc = ModuleDesc(
        name="flac", comment="FLAC lossless audio encoder (the in-tree "
        "io/flac.py spec encoder)",
        params=[ParamSpec("bitrate", "ignored (lossless)", "d", 0, 0, 0)])
    default_kbps = 0
    codec = NativeFlacEncoder
