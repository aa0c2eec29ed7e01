"""The YUV4MPEG2 stream encoder (``tcforge_tpu/modules/encoders/
image_enc.py`` ``Yuv4mpegEncoder``, the encode_yuv4mpeg.c analogue):
frames encode as YUV4MPEG2 stream chunks, the stream header riding the
first payload, so ``-y yuv4mpeg,raw,raw`` writes a valid .y4m through the
plain byte multiplexor.  The ``im`` still-image encoder of that file is
not ported (its JPEG form needs PIL).
"""

from __future__ import annotations

from fractions import Fraction
from typing import List

from tcforge_tpu_torch.core.codecs import Codec
from tcforge_tpu_torch.core.formats import ImageFormat
from tcforge_tpu_torch.core.frame import FrameBatch
from tcforge_tpu_torch.core.optstr import ModuleDesc
from tcforge_tpu_torch.modules.encoders.basic import _host
from tcforge_tpu_torch.modules.registry import (Encoder, ModuleInfo,
                                                ModuleKind, register)


@register
class Yuv4mpegEncoder(Encoder):
    info = ModuleInfo(name="yuv4mpeg", kind=ModuleKind.ENCODER,
                      media="video", codecs_in=(Codec.YUV420P,),
                      codecs_out=(Codec.RAW,))
    desc = ModuleDesc(name="yuv4mpeg",
                      comment="YUV4MPEG2 stream chunks "
                      "(encode_yuv4mpeg analogue; mux with 'raw')")

    def __init__(self, job, options: str = ""):
        super().__init__(job, options)
        self._wrote_header = False

    def encode_video(self, fb: FrameBatch) -> List[bytes]:
        if fb.format != ImageFormat.YUV420P:
            raise ValueError("yuv4mpeg encoder needs YUV420P input")
        y, u, v = (_host(p) for p in (fb.y, fb.u, fb.v))
        out: List[bytes] = []
        for i in range(y.shape[0]):
            chunk = b""
            if not self._wrote_header:
                fr = Fraction(self.job.out_fps).limit_denominator(1001)
                chunk += (b"YUV4MPEG2 W%d H%d F%d:%d Ip A1:1 C420jpeg\n"
                          % (fb.width, fb.height, fr.numerator,
                             fr.denominator))
                self._wrote_header = True
            chunk += (b"FRAME\n" + y[i].tobytes() + u[i].tobytes()
                      + v[i].tobytes())
            out.append(chunk)
        return out
