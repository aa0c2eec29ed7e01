"""The MPEG-2 video encoder module (``tcforge_tpu/modules/encoders/
mpeg2.py``).

With ``gop_n`` above 1 (or ``mpeg1``) the full I/P/B encoder
(``io/mpeg2enc.py``): motion search, prediction and block coding on the
batch's device through the three encoder kernels, the syntax writer on
the host.  With ``gop_n=1`` one I picture a frame through the pinned
intra writer (``io/mpeg2host.py``), its DCT and quantiser in the block
coder on the batch's device (``Mpeg2IntraEncoder``).  The port always
builds its own syntax writer, so unlike the JAX module it has no
refusal for a missing native library.  ``-w`` (``rc_requested``) sets the
bitrate and rate control, ``--encode_fields`` field pictures and their
order, ``-R`` the pass log, ``--quantizers`` the quantiser's bounds,
``--video_max_bitrate`` and ``--pulldown`` the sequence's fields.  Write
through the raw multiplexor for a ``.m2v``, or ``mpg`` for a program
stream.
"""

from __future__ import annotations

from typing import List

from tcforge_tpu_torch.core.codecs import Codec
from tcforge_tpu_torch.core.formats import ImageFormat
from tcforge_tpu_torch.core.frame import FrameBatch
from tcforge_tpu_torch.core.optstr import ModuleDesc, ParamSpec
from tcforge_tpu_torch.modules.registry import (Encoder, ModuleInfo,
                                                ModuleKind, register)


@register
class Mpeg2VideoEncoder(Encoder):
    info = ModuleInfo(name="mpeg2", kind=ModuleKind.ENCODER, media="video",
                      codecs_in=(Codec.YUV420P, Codec.YUV422P),
                      codecs_out=(Codec.MPEG2VIDEO,))
    desc = ModuleDesc(
        name="mpeg2", comment="MPEG-2 video encoder (I/P/B + device "
        "motion estimation; intra-only with gop_n=1)",
        params=[ParamSpec("qscale", "quantizer scale", "d", 8, 1, 31),
                ParamSpec("bitrate", "nominal bitrate kbps", "d", 8000,
                          100, 100000),
                ParamSpec("gop_n", "GOP length (1 = intra only)", "d",
                          1, 1, 60),
                ParamSpec("gop_m", "anchor distance (3 = 2 B frames)",
                          "d", 1, 1, 4),
                ParamSpec("range", "motion search range (int pel)",
                          "d", 8, 1, 64),
                ParamSpec("rc", "single-pass rate control toward "
                          "bitrate (-w)", "b", 0),
                ParamSpec("fields", "field-coded pictures (two field "
                          "pictures per frame, I/P/B)", "b", 0),
                ParamSpec("mpeg1", "emit ISO 11172-2 (MPEG-1) syntax "
                          "(VCD); auto with -N mpeg1video", "b", 0),
                ParamSpec("dpict", "MPEG-1 D-pictures (DC-only "
                          "fast-scan sequence; implies mpeg1)", "b", 0),
                ParamSpec("alt_scan", "alternate coefficient scan "
                          "(interlaced content)", "b", 0)])
    # takes batches on the device (the engine keeps them there)
    on_device = True

    def __init__(self, job, options: str = ""):
        super().__init__(job, options)
        self._enc = None
        self._full = None
        # -w: only an explicit -w (rc_requested) overrides the module's
        # bitrate default, and turns rate control on
        if "bitrate=" not in options and getattr(job, "rc_requested",
                                                 False):
            self.options["bitrate"] = job.bitrate
            if "rc=" not in options:
                self.options["rc"] = 1
        # --encode_fields t/b: field pictures, and their order
        ef = getattr(job, "encode_fields", 0)
        if ef in (1, 2) and "fields=" not in options:
            self.options["fields"] = 1
        self._top_field_first = ef != 2
        if ("mpeg1" not in options
                and getattr(job, "ex_v_codec", None) == Codec.MPEG1):
            self.options["mpeg1"] = 1
        if self.options.get("dpict"):
            self.options["mpeg1"] = 1

    def _wants_full(self) -> bool:
        return self.options["gop_n"] > 1 or bool(self.options["mpeg1"])

    def _open(self, fb: FrameBatch, chroma: int, fields: bool) -> None:
        job = self.job
        if self._wants_full():
            from tcforge_tpu_torch.io.mpeg2enc import Mpeg2FullEncoder
            n = self.options["gop_n"]
            m = self.options["gop_m"]
            if n % m:
                n = (n // m) * m or m
            self._full = Mpeg2FullEncoder(
                fb.width, fb.height, job.out_fps,
                qscale=self.options["qscale"], gop_n=n, gop_m=m,
                search_range=self.options["range"],
                bitrate_kbps=self.options["bitrate"],
                rate_control=bool(self.options["rc"]),
                pass_mode=job.divxmultipass, pass_log=job.divxlogfile,
                qmin=getattr(job, "min_quantizer", 1) or 1,
                qmax=getattr(job, "max_quantizer", 31) or 31,
                max_bitrate_kbps=getattr(job, "video_max_bitrate", 0),
                pulldown=getattr(job, "pulldown", False), fields=fields,
                top_field_first=self._top_field_first,
                alt_scan=bool(self.options["alt_scan"]),
                mpeg1=bool(self.options["mpeg1"]),
                dpict=bool(self.options.get("dpict", 0)), chroma=chroma)
            return
        if chroma == 422 and fields:
            raise ValueError("mpeg2: 4:2:2 field coding needs the full "
                             "encoder — set gop_n>1")
        from tcforge_tpu_torch.io.mpeg2enc import Mpeg2IntraEncoder
        self._enc = Mpeg2IntraEncoder(
            fb.width, fb.height, job.out_fps,
            qscale=self.options["qscale"],
            bitrate_kbps=self.options["bitrate"],
            max_bitrate_kbps=getattr(job, "video_max_bitrate", 0),
            pulldown=getattr(job, "pulldown", False),
            top_field_first=self._top_field_first, interlaced=fields,
            chroma=chroma)

    def encode_video(self, fb: FrameBatch) -> List[bytes]:
        if fb.format not in (ImageFormat.YUV420P, ImageFormat.YUV422P):
            raise ValueError("mpeg2 encoder needs YUV420P or "
                             "YUV422P input")
        chroma = 422 if fb.format == ImageFormat.YUV422P else 420
        fields = bool(self.options["fields"])
        if self._full is None and self._enc is None:
            self._open(fb, chroma, fields)
        if self._full is not None:
            return [self._full.push_frame(fb.y[i], fb.u[i], fb.v[i])
                    for i in range(fb.batch)]
        y, u, v = fb.y, fb.u, fb.v
        out = []
        for i in range(fb.batch):
            first = self._enc._temporal_ref == 0
            if fields:
                out.append(self._enc.encode_frame_fields(
                    y[i], u[i], v[i], with_seq=first))
            else:
                out.append(self._enc.encode_frame(y[i], u[i], v[i],
                                                  with_seq=first))
        return out

    def flush(self) -> List[bytes]:
        # encode_video gave one payload a frame pushed (empty while B
        # frames wait), so the tail adds no frame to the count
        if self._full is not None:
            self.last_flush_frames = 0
            return [self._full.flush()]
        if self._enc is not None:
            self.last_flush_frames = 0
            return [self._enc.sequence_end()]
        return []
