"""The raw, null and copy encoders (``tcforge_tpu/modules/encoders/
basic.py``).

``raw`` packs each frame of a batch into its on-disk bytes for its
format (the planes of a planar frame one after the other, packed YUV
interleaved, RGB: the packed pixels), and for audio one little-endian
int16 payload per audio frame.  ``null``
discards everything (encode_null.c); ``copy`` passes frames through as
``raw`` packs them, and audio in its native byte order (encode_copy.c).
A batch on a device comes to host memory first.
"""

from __future__ import annotations

from typing import List

import numpy as np

from tcforge_tpu_torch.core.codecs import Codec
from tcforge_tpu_torch.core.frame import AudioBatch, FrameBatch
from tcforge_tpu_torch.core.optstr import ModuleDesc
from tcforge_tpu_torch.io.rawio import pack_frame
from tcforge_tpu_torch.modules.registry import (Encoder, ModuleInfo,
                                                ModuleKind, register)


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if hasattr(a, "numpy") else np.asarray(a)


def frame_payloads(fb: FrameBatch) -> List[bytes]:
    """Each frame of a batch as its on-disk bytes for the batch's format
    (``io/rawio.pack_frame``: planar YUV plane after plane, packed YUV
    interleaved, YV12's chroma swapped, RGB in its byte order)."""
    planes = [_host(p) for p in fb.planes]
    return [pack_frame(tuple(p[i] for p in planes), fb.format)
            for i in range(fb.batch)]


@register
class RawEncoder(Encoder):
    info = ModuleInfo(name="raw", kind=ModuleKind.ENCODER, media="both",
                      codecs_in=(Codec.ANY,), codecs_out=(Codec.RAW,))
    desc = ModuleDesc(name="raw", comment="raw frame/PCM passthrough packer")

    def encode_video(self, fb: FrameBatch) -> List[bytes]:
        return frame_payloads(fb)

    def encode_audio(self, ab: AudioBatch) -> List[bytes]:
        pcm = _host(ab.pcm)
        return [pcm[i].astype("<i2", copy=False).tobytes()
                for i in range(pcm.shape[0])]


@register
class NullEncoder(Encoder):
    info = ModuleInfo(name="null", kind=ModuleKind.ENCODER, media="both",
                      codecs_in=(Codec.ANY,), codecs_out=())
    desc = ModuleDesc(name="null", comment="discard frames (encode_null)")

    def encode_video(self, fb: FrameBatch) -> List[bytes]:
        return [b""] * fb.batch

    def encode_audio(self, ab: AudioBatch) -> List[bytes]:
        return [b""] * ab.batch


@register
class CopyEncoder(Encoder):
    info = ModuleInfo(name="copy", kind=ModuleKind.ENCODER, media="both",
                      codecs_in=(Codec.ANY,), codecs_out=(Codec.ANY,))
    desc = ModuleDesc(name="copy", comment="pass-through (encode_copy)")

    def encode_video(self, fb: FrameBatch) -> List[bytes]:
        return frame_payloads(fb)

    def encode_audio(self, ab: AudioBatch) -> List[bytes]:
        pcm = _host(ab.pcm)
        return [pcm[i].tobytes() for i in range(pcm.shape[0])]
