"""The MPEG-4 part 2 video encoder module ``xvid``
(``tcforge_tpu/modules/encoders/bridge_video.py`` ``XvidEncoder``).

The JAX module encodes through its FFmpeg bridge where one is built
and through the in-tree Simple Profile encoder otherwise (or with
``TCFORGE_NATIVE_MPEG4ENC=1``).  The port has the in-tree route alone,
``io/mpeg4enc.py``: each VOP's decisions and block coding on the
batch's device, the bits written on the host.  The options are the JAX
module's (``bitrate``, ``keyint``, ``quant``, ``bframes``, ``four_mv``);
other keys are kept in ``extra_opts`` and unused, as in the JAX native
branch.  An explicit ``quant=`` means constant quality: only an
explicit ``bitrate=``, or ``-w`` without ``quant``, turns rate control
on (the job's bitrate, 1800 unless ``-w`` sets it).  Write through the
``avi`` multiplexor (fourcc ``XVID``) or ``raw`` for an elementary
stream.
"""

from __future__ import annotations

from typing import List

from tcforge_tpu_torch.core.codecs import Codec
from tcforge_tpu_torch.core.formats import ImageFormat
from tcforge_tpu_torch.core.frame import FrameBatch
from tcforge_tpu_torch.core.optstr import ModuleDesc, ParamSpec, \
    parse_optstr
from tcforge_tpu_torch.modules.encoders.encoder_cfg import \
    split_extra_options
from tcforge_tpu_torch.modules.registry import (Encoder, ModuleInfo,
                                                ModuleKind, register)


@register
class XvidEncoder(Encoder):
    """MPEG-4 Simple Profile (encode_xvid.c's role)."""
    info = ModuleInfo(name="xvid", kind=ModuleKind.ENCODER,
                      media="video", codecs_in=(Codec.YUV420P,),
                      codecs_out=(Codec.XVID,))
    desc = ModuleDesc(
        name="xvid", comment="MPEG-4 encoder (libxvidcore via the "
        "FFmpeg bridge, or the in-tree SP encoder)",
        params=[ParamSpec("bitrate", "bitrate kbps", "d", 0, 0, 100000),
                ParamSpec("keyint", "max GOP size", "d", 250, 1, 1000),
                ParamSpec("quant", "native-encoder quantizer 1..31",
                          "d", 5, 1, 31),
                ParamSpec("bframes", "native-encoder consecutive "
                          "B-VOPs 0..7", "d", 0, 0, 7),
                ParamSpec("four_mv", "native-encoder per-block "
                          "motion vectors", "d", 0, 0, 1)])
    # takes batches on the device (the engine keeps them there)
    on_device = True

    def __init__(self, job, options: str = ""):
        known, self.extra_opts = split_extra_options(self.desc, options)
        super().__init__(job, known)
        # the parsed options fill defaults in; only the raw string says
        # what was given
        self._given = set(parse_optstr(options))
        self._enc = None

    def encode_video(self, fb: FrameBatch) -> List[bytes]:
        if fb.format != ImageFormat.YUV420P:
            from tcforge_tpu_torch.ops.colorspace import convert
            fb = convert(fb, ImageFormat.YUV420P)
        if self._enc is None:
            from tcforge_tpu_torch.io.mpeg4enc import Mpeg4Encoder
            self._enc = Mpeg4Encoder(
                fb.width, fb.height,
                fps=float(self.job.out_fps or self.job.fps or 25.0),
                qscale=int(self.options.get("quant", 5)),
                gop=int(self.options.get("keyint", 0) or 250),
                bframes=int(self.options.get("bframes", 0)),
                four_mv=bool(int(self.options.get("four_mv", 0))),
                bitrate_kbps=int(self.options.get("bitrate", 0))
                or (0 if "quant" in self._given
                    else int(self.job.bitrate or 0)))
        out = []
        for i in range(fb.batch):
            out.extend(c for c, _ in self._enc.push(fb.y[i], fb.u[i],
                                                     fb.v[i]))
        return out

    def flush(self) -> List[bytes]:
        if self._enc is not None:
            tail = [c for c, _ in self._enc.flush()]
            self.last_flush_frames = len(tail)
            return tail
        return []
