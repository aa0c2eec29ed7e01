"""The QuickTime ``mov`` multiplexor (``tcforge_tpu/modules/importers/
mov_import.py`` ``MovMuxer``) over the pinned ``io/mov.MovWriter``.

The video fourcc is ``jpeg`` behind the ``movjpeg`` encoder, ``raw `` for
an RGB24 session and ``yv12`` otherwise: the raw encoder's packed I420
frames are reordered to Y, V, U.  PCM audio rides along as a ``sowt``
track at the job's rate and channels.
"""

from __future__ import annotations

import numpy as np

from tcforge_tpu_torch.core.codecs import Codec, ContainerFormat
from tcforge_tpu_torch.core.formats import ImageFormat
from tcforge_tpu_torch.core.optstr import ModuleDesc
from tcforge_tpu_torch.io import mov
from tcforge_tpu_torch.modules.registry import (ModuleInfo, ModuleKind,
                                                Muxer, register)


@register
class MovMuxer(Muxer):
    info = ModuleInfo(name="mov", kind=ModuleKind.MULTIPLEXOR,
                      media="both", codecs_in=(Codec.ANY,),
                      formats_out=(ContainerFormat.MOV,))
    desc = ModuleDesc(name="mov", comment="QuickTime/MOV writer")

    def open(self, path: str) -> None:
        job = self.job
        w = job.ex_v_width or job.im_v_width
        h = job.ex_v_height or job.im_v_height
        if job.ex_v_module == "movjpeg":
            fourcc = "jpeg"
        elif job.im_colorspace == ImageFormat.RGB24:
            fourcc = "raw "
        else:
            fourcc = "yv12"
        self._fourcc = fourcc
        self._w = mov.MovWriter(
            path, w, h, job.out_fps or job.fps or 25.0, fourcc=fourcc,
            audio_rate=job.a_rate, audio_channels=job.a_chan)

    def write_video(self, payload: bytes, keyframe: bool = True) -> int:
        if self._fourcc == "yv12":
            w, h = self._w.width, self._w.height
            ysz, csz = w * h, (w * h) // 4
            payload = (payload[:ysz] + payload[ysz + csz:ysz + 2 * csz]
                       + payload[ysz:ysz + csz])
        self._w.write_video_sample(payload)
        return len(payload)

    def write_audio(self, payload: bytes, track: int = 0) -> int:
        pcm = np.frombuffer(payload, "<i2")
        self._w.write_audio(pcm.reshape(-1, max(1, self.job.a_chan)))
        return len(payload)

    def close(self) -> None:
        self._w.close()
