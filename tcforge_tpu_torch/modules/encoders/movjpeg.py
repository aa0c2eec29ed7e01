"""The ``movjpeg`` photo-JPEG encoder (``tcforge_tpu/modules/importers/
mov_import.py`` ``MovJpegEncoder``), for the ``mov`` and ``avi``
multiplexors (``-y movjpeg,lame,avi -F MJPG``, ``-y movjpeg,raw,mov``).

The JAX module converts a batch to RGB24 (``ops.colorspace.convert``) and
saves each frame through PIL at ``quality`` (10 to 100, default 90).  The
port converts the same way, with its own ``ops/colorspace.convert``, on
the batch's device, and then encodes as PIL does (``io/jpegenc.py``): one
launch of ``jpeg_ycc_down`` and of ``jpeg_fdct_quant`` a batch, one
download of the coefficients, the host Huffman coder; one JPEG a frame.
"""

from __future__ import annotations

from typing import List

from tcforge_tpu_torch.core.codecs import Codec
from tcforge_tpu_torch.core.formats import ImageFormat
from tcforge_tpu_torch.core.frame import FrameBatch
from tcforge_tpu_torch.core.optstr import ModuleDesc, ParamSpec
from tcforge_tpu_torch.io import jpegenc
from tcforge_tpu_torch.modules.registry import (Encoder, ModuleInfo,
                                                ModuleKind, register)
from tcforge_tpu_torch.ops.colorspace import convert


@register
class MovJpegEncoder(Encoder):
    info = ModuleInfo(name="movjpeg", kind=ModuleKind.ENCODER,
                      media="video",
                      codecs_in=(Codec.RGB24, Codec.YUV420P),
                      codecs_out=(Codec.JPEG,))
    desc = ModuleDesc(
        name="movjpeg", comment="photo-JPEG encoder",
        params=[ParamSpec("quality", "JPEG quality", "d", 90, 10, 100)])
    # takes batches on the device (the engine keeps them there)
    on_device = True

    def encode_video(self, fb: FrameBatch) -> List[bytes]:
        if fb.format != ImageFormat.RGB24:
            fb = convert(fb, ImageFormat.RGB24)
        return jpegenc.encode_rgb(fb.rgb, self.options["quality"])
