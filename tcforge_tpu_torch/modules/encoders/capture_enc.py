"""The capture codecs' encoders: ``dv`` (``tcforge_tpu/modules/encoders/
bridge_video.py`` ``DvVideoEncoder``, its in-tree route: the JAX
module's route without its FFmpeg bridge, or with
``TCFORGE_NATIVE_DVENC=1``) and ``nuvrtj`` (``tcforge_tpu/modules/
importers/nuv_import.py`` ``NuvRtjEncoder``).

Both take batches on the device.  ``dv`` converts to YUV420P where the
session is not, turns an NTSC batch's chroma into 4:1:1 as the JAX
module's ``_chroma_420_to_411`` does (horizontal pairs averaged, rows
repeated), and encodes with ``io/dvcodec.py`` ``encode_planes``: two
launches of ``dv_fdct_cost`` a batch around the host's rate fit, then
the host's packing; a size that is neither 720x576 nor 720x480 raises
the JAX encoder's message.  Its ``bitrate`` is accepted and ignored (DV
is constant rate).  ``nuvrtj`` runs one ``rtjpeg_fdct_quant`` launch a
batch and codes each frame's blocks on the host (``io/rtjcodec.py``),
at ``quality`` (16 to 255); its first batch puts the RTjpeg tables in
``job.extradata["rtjpeg_tables"]`` for the ``nuv`` multiplexor.
"""

from __future__ import annotations

from typing import List

import torch

from tcforge_tpu_torch.core.codecs import Codec
from tcforge_tpu_torch.core.formats import ImageFormat
from tcforge_tpu_torch.core.frame import FrameBatch
from tcforge_tpu_torch.core.optstr import ModuleDesc, ParamSpec
from tcforge_tpu_torch.io import dvcodec, rtjcodec
from tcforge_tpu_torch.modules.encoders.encoder_cfg import \
    split_extra_options
from tcforge_tpu_torch.modules.registry import (Encoder, ModuleInfo,
                                                ModuleKind, register)
from tcforge_tpu_torch.ops import kernels
from tcforge_tpu_torch.ops.colorspace import convert

DV_GEOMETRY_ERROR = ("dvenc: geometry must be PAL 720x576 + 360x288 chroma "
                     "or NTSC 720x480 + 180x480 4:1:1 chroma")


def chroma_420_to_411(c: torch.Tensor) -> torch.Tensor:
    """(frames, h/2, w/2) 4:2:0 chroma to (frames, h, w/4) 4:1:1."""
    pairs = (c[:, :, 0::2].to(torch.int32) + c[:, :, 1::2] + 1) >> 1
    return pairs.to(torch.uint8).repeat_interleave(2, dim=1)


@register
class DvVideoEncoder(Encoder):
    info = ModuleInfo(name="dv", kind=ModuleKind.ENCODER,
                      media="video", codecs_in=(Codec.YUV420P,),
                      codecs_out=(Codec.DV,))
    desc = ModuleDesc(
        name="dv", comment="DV video encoder (libavcodec dvvideo via "
        "the FFmpeg bridge, or the in-tree DV25 encoder)",
        params=[ParamSpec("bitrate", "ignored (DV is CBR)", "d", 0, 0,
                          100000)])
    on_device = True

    def __init__(self, job, options: str = ""):
        known, self.extra_opts = split_extra_options(self.desc, options)
        super().__init__(job, known)

    def encode_video(self, fb: FrameBatch) -> List[bytes]:
        if fb.format != ImageFormat.YUV420P:
            fb = convert(fb, ImageFormat.YUV420P)
        y, u, v = fb.y, fb.u, fb.v
        if fb.height == 480:
            u, v = chroma_420_to_411(u), chroma_420_to_411(v)
        if (tuple(y.shape[1:]), tuple(u.shape[1:]), tuple(v.shape[1:])) \
                not in (((576, 720), (288, 360), (288, 360)),
                        ((480, 720), (480, 180), (480, 180))):
            raise ValueError(DV_GEOMETRY_ERROR)
        return dvcodec.encode_planes(y, u, v)


@register
class NuvRtjEncoder(Encoder):
    """RTjpeg video encoder (the NuppelVideo recorder's codec)."""

    info = ModuleInfo(name="nuvrtj", kind=ModuleKind.ENCODER,
                      media="video", codecs_in=(Codec.YUV420P,),
                      codecs_out=(Codec.NUV,))
    desc = ModuleDesc(
        name="nuvrtj", comment="RTjpeg encoder (NuppelVideo)",
        params=[ParamSpec("quality", "RTjpeg quality", "d", 255, 16,
                          255)])
    on_device = True

    def __init__(self, job, options: str = ""):
        super().__init__(job, options)
        self._state = None
        self._qt = None

    def encode_video(self, fb: FrameBatch) -> List[bytes]:
        if fb.format != ImageFormat.YUV420P:
            raise ValueError("nuvrtj needs YUV420P input")
        if self._state is None:
            rtjcodec.check_geometry(fb.width, fb.height)
            self._state = rtjcodec.compress_tables(self.options["quality"])
            self.job.extradata["rtjpeg_tables"] = self._state[3]
        qt, lb8, cb8, _ = self._state
        if self._qt is None or self._qt.device != fb.y.device:
            self._qt = torch.from_numpy(qt).to(fb.y.device)
        q = kernels.rtjpeg_fdct_quant(fb.y.contiguous(), fb.u.contiguous(),
                                      fb.v.contiguous(), self._qt)
        nb = rtjcodec.frame_blocks(fb.width, fb.height)
        return rtjcodec.compress_frames(q.cpu().numpy(), nb, lb8, cb8)

    def tables(self) -> bytes:
        return self._state[3] if self._state else b""

