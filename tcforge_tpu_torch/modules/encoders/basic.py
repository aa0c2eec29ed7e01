"""The raw and null encoders (``tcforge_tpu/modules/encoders/basic.py``).

``raw`` packs each frame of a batch into its on-disk bytes: the planes
of a planar frame one after the other (RGB: the packed pixels), and for
audio one little-endian int16 payload per audio frame.  ``null``
discards everything (encode_null.c).  Both take batches whose tensors
are in host memory (the engine copies them back first).
"""

from __future__ import annotations

from typing import List

import numpy as np

from tcforge_tpu_torch.core.codecs import Codec
from tcforge_tpu_torch.core.frame import AudioBatch, FrameBatch
from tcforge_tpu_torch.core.optstr import ModuleDesc
from tcforge_tpu_torch.modules.registry import (Encoder, ModuleInfo,
                                                ModuleKind, register)


def _host(a) -> np.ndarray:
    return a.numpy() if hasattr(a, "numpy") else np.asarray(a)


@register
class RawEncoder(Encoder):
    info = ModuleInfo(name="raw", kind=ModuleKind.ENCODER, media="both",
                      codecs_in=(Codec.ANY,), codecs_out=(Codec.RAW,))
    desc = ModuleDesc(name="raw", comment="raw frame/PCM passthrough packer")

    def encode_video(self, fb: FrameBatch) -> List[bytes]:
        planes = [_host(p) for p in fb.planes]
        return [b"".join(p[i].tobytes() for p in planes)
                for i in range(fb.batch)]

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
