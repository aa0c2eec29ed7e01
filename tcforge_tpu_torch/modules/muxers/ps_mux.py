"""The MPEG program stream multiplexor (``tcforge_tpu/modules/muxers/
ps_mux.py``, the multiplex_lavf.c mpeg role): .mpg/.vob program streams
from the MPEG-1/2 video encoder's payloads through ``io/psmux.py`` (a
pinned copy), with the audio encoder's: ``mp2enc``, ``toolame`` and
``lame`` frames as MPEG audio PES 0xC0 (VCD/SVCD), ``ac3enc``'s as
private stream 1, sub-stream 0x80 (DVD), and PCM as DVD LPCM (private
stream 1, at a DVD rate only)."""

from __future__ import annotations

import numpy as np

from tcforge_tpu_torch.core.codecs import Codec, ContainerFormat
from tcforge_tpu_torch.core.optstr import ModuleDesc, ParamSpec
from tcforge_tpu_torch.io.psmux import PsWriter
from tcforge_tpu_torch.modules.registry import (ModuleInfo, ModuleKind,
                                                Muxer, register)

_LPCM_RATES = (48000, 96000, 44100, 32000)


@register
class MpegPsMuxer(Muxer):
    info = ModuleInfo(name="mpg", kind=ModuleKind.MULTIPLEXOR,
                      media="both",
                      codecs_in=(Codec.MPEG2, Codec.MPEG1, Codec.PCM),
                      formats_out=(ContainerFormat.MPEG_PS,))
    desc = ModuleDesc(
        name="mpg", comment="MPEG program stream writer (PS/VOB; "
        "video ES + DVD LPCM audio)",
        params=[ParamSpec("chunk", "video PES payload bytes", "d",
                          2018, 128, 65000)])

    def open(self, path: str) -> None:
        job = self.job
        rate = job.mp3frequency or job.a_rate
        self._audio = bool(getattr(job, "dm_chan", 0) and rate)
        # the compressed encoders' self-framing byte streams: (stream
        # id, sub-stream id)
        self._aes = {"mp2enc": (0xC0, None), "toolame": (0xC0, None),
                     "lame": (0xC0, None),
                     "ac3enc": (0xBD, 0x80)}.get(job.ex_a_module)
        if self._audio and self._aes is None and rate not in _LPCM_RATES:
            raise ValueError(
                f"mpg: LPCM audio needs a DVD rate {_LPCM_RATES}, "
                f"got {rate} — resample with -E or drop audio")
        self._f = open(path, "wb")
        self._w = PsWriter(self._f, fps=(job.out_fps or job.fps or 25.0),
                           audio_rate=rate if self._audio else 0,
                           chunk=int(self.options["chunk"]))
        self._chan = job.dm_chan or 2

    def write_video(self, payload: bytes, keyframe: bool = True) -> int:
        if not payload:
            return 0
        return self._w.write_video(payload)

    def write_audio(self, payload: bytes, track: int = 0) -> int:
        if not self._audio or not payload:
            return 0
        if self._aes is not None:
            sid, sub = self._aes
            return self._w.write_audio_es(payload, sid, sub)
        samples = np.frombuffer(payload, "<i2")
        n = (samples.shape[0] // self._chan) * self._chan
        return self._w.write_audio_pcm(samples[:n].reshape(-1, self._chan))

    def close(self) -> None:
        self._w.close()
        self._f.close()
