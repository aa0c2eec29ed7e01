"""The LZO video encoder (``tcforge_tpu/modules/encoders/lzo_enc.py``,
the encode_lzo.c analogue): each frame's raw I420 planes packed into
transcode's LZO2 frame by the pinned in-tree LZO1X compressor
(``io/tclzo.compress_frame``; store mode for a frame that does not
shrink), for the ``avi`` multiplexor with ``-F LZO2``.  A batch on a
device comes to host memory first; a batch of another format converts
to YUV420P on its device before that, as the JAX encoder converts it.
"""

from __future__ import annotations

from typing import List

from tcforge_tpu_torch.core.codecs import Codec
from tcforge_tpu_torch.core.formats import ImageFormat
from tcforge_tpu_torch.core.frame import FrameBatch
from tcforge_tpu_torch.core.optstr import ModuleDesc
from tcforge_tpu_torch.io import tclzo
from tcforge_tpu_torch.io.rawio import pack_frame
from tcforge_tpu_torch.modules.encoders.basic import _host
from tcforge_tpu_torch.modules.registry import (Encoder, ModuleInfo,
                                                ModuleKind, register)


@register
class LzoEncoder(Encoder):
    info = ModuleInfo(name="lzo", kind=ModuleKind.ENCODER,
                      media="video", codecs_in=(Codec.YUV420P,),
                      codecs_out=(Codec.RAW,))
    desc = ModuleDesc(name="lzo", comment="LZO2-packed raw frames "
                      "(lossless; pair with the avi muxer, -F LZO2)")

    def encode_video(self, fb: FrameBatch) -> List[bytes]:
        if fb.format != ImageFormat.YUV420P:
            from tcforge_tpu_torch.ops.colorspace import convert
            fb = convert(fb, ImageFormat.YUV420P)
        y, u, v = (_host(p) for p in (fb.y, fb.u, fb.v))
        return [tclzo.compress_frame(pack_frame((y[i], u[i], v[i]),
                                                ImageFormat.YUV420P))
                for i in range(fb.batch)]
