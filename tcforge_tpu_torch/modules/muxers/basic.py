"""The WAV multiplexor (``tcforge_tpu/modules/muxers/basic.py``
``WavMuxer``): audio payloads into a RIFF/WAVE file whose header is
fixed up on close.  The rate is ``-E``'s (``mp3frequency``) or the
input's (``a_rate``), the channels ``dm_chan``, the bits ``dm_bits``."""

from __future__ import annotations

import numpy as np

from tcforge_tpu_torch.core.codecs import Codec, ContainerFormat
from tcforge_tpu_torch.core.optstr import ModuleDesc
from tcforge_tpu_torch.io.wav import WavInfo, WavWriter
from tcforge_tpu_torch.modules.registry import (ModuleInfo, ModuleKind,
                                                Muxer, register)


@register
class WavMuxer(Muxer):
    info = ModuleInfo(name="wav", kind=ModuleKind.MULTIPLEXOR, media="audio",
                      codecs_in=(Codec.PCM,),
                      formats_out=(ContainerFormat.WAV,))
    desc = ModuleDesc(name="wav", comment="RIFF/WAVE PCM writer")

    def open(self, path: str) -> None:
        self._w = WavWriter(path, WavInfo(
            rate=(self.job.mp3frequency or self.job.a_rate),
            channels=self.job.dm_chan, bits=self.job.dm_bits))

    def write_video(self, payload: bytes, keyframe: bool = True) -> int:
        raise NotImplementedError("wav mux is audio-only")

    def write_audio(self, payload: bytes, track: int = 0) -> int:
        a = np.frombuffer(payload, np.int16).reshape(
            -1, max(1, self.job.dm_chan))
        self._w.write_samples(a)
        return len(payload)

    def close(self) -> None:
        self._w.close()
