"""The Theora video encoder module ``theora``
(``tcforge_tpu/modules/encoders/bridge_video.py`` ``TheoraEncoder``).

The JAX module encodes through libtheora in its FFmpeg bridge where one
is built and through the in-tree encoder otherwise (or with
``TCFORGE_NATIVE_THEORAENC=1``).  The port has the in-tree route alone,
``io/theoracodec.py`` ``TheoraDeviceEncoder``: each frame's decisions,
residuals, quantization and reconstruction on the batch's device, the
bits written on the host.  The options are the JAX module's: ``qi``
(0..63, 45 by default), ``keyint`` (the largest distance between key
frames, 64 by default) and ``bitrate``, which the in-tree encoder does
not read; other keys are kept in ``extra_opts`` and unused.  A batch
that is not YUV420P is converted first.  The first batch leaves the
three header packets in ``job.extradata["theora_headers"]`` for the
``ogg`` multiplexor's Theora logical stream.
"""

from __future__ import annotations

from typing import List, Tuple

from tcforge_tpu_torch.core.codecs import Codec
from tcforge_tpu_torch.core.formats import ImageFormat
from tcforge_tpu_torch.core.frame import FrameBatch
from tcforge_tpu_torch.core.optstr import ModuleDesc, ParamSpec
from tcforge_tpu_torch.modules.encoders.encoder_cfg import \
    split_extra_options
from tcforge_tpu_torch.modules.encoders.vorbis_enc import \
    pack_header_packets
from tcforge_tpu_torch.modules.registry import (Encoder, ModuleInfo,
                                                ModuleKind, register)


@register
class TheoraEncoder(Encoder):
    """Theora (encode_theora.c's role)."""
    info = ModuleInfo(name="theora", kind=ModuleKind.ENCODER,
                      media="video", codecs_in=(Codec.YUV420P,),
                      codecs_out=(Codec.THEORA,))
    desc = ModuleDesc(
        name="theora", comment="Theora encoder (libtheora via the "
        "FFmpeg bridge, or the in-tree encoder)",
        params=[ParamSpec("bitrate", "bitrate kbps", "d", 0, 0, 100000),
                ParamSpec("keyint", "max GOP size", "d", 64, 1, 1000),
                ParamSpec("qi", "native-encoder quality 0..63",
                          "d", 45, 0, 63)])
    on_device = True

    def __init__(self, job, options: str = ""):
        known, self.extra_opts = split_extra_options(self.desc, options)
        super().__init__(job, known)
        self._enc = None

    def _fps_rational(self) -> Tuple[int, int]:
        fps = float(self.job.out_fps or self.job.fps or 25.0)
        for num, den in ((24000, 1001), (30000, 1001), (60000, 1001)):
            if abs(fps - num / den) < 1e-3:
                return num, den
        if abs(fps - round(fps)) < 1e-6:
            return int(round(fps)), 1
        return int(round(fps * 1000)), 1000

    def encode_video(self, fb: FrameBatch) -> List[bytes]:
        if fb.format != ImageFormat.YUV420P:
            from tcforge_tpu_torch.ops.colorspace import convert
            fb = convert(fb, ImageFormat.YUV420P)
        if self._enc is None:
            from tcforge_tpu_torch.io.theoracodec import TheoraDeviceEncoder
            self._enc = TheoraDeviceEncoder(
                fb.width, fb.height, fps=self._fps_rational(),
                qi=int(self.options.get("qi", 45)),
                gop=int(self.options.get("keyint", 0) or 64),
                device=fb.y.device)
            self.job.extradata["theora_headers"] = \
                pack_header_packets(self._enc.headers)
        return [self._enc.encode(fb.y[i], fb.u[i], fb.v[i])[0]
                for i in range(fb.batch)]
