"""The WAV, Y4M, AVI, raw and null multiplexors (``tcforge_tpu/modules/
muxers/basic.py``; multiplex_{wav,y4m,avi,raw,null}.c analogues).

``wav``: audio payloads into a RIFF/WAVE file whose header is fixed up on
close; the rate is ``-E``'s (``mp3frequency``) or the input's
(``a_rate``), the channels ``dm_chan``, the bits ``dm_bits``.  ``y4m``:
packed planar frames behind ``FRAME`` lines (an RGB session's frames
converted to YUV420P).  ``avi``: the pinned ``io/avi.AviWriter``
(AVI 1.0 with OpenDML segments); the video fourcc is the ``fourcc``
option, else ``-F`` when it is a fourcc, else the encoder's (``mpeg2``
gives ``mpg2``, ``movjpeg`` ``MJPG``), else the colorspace's (``I420``);
an audio track when the job has audio and no ``-m``, tagged by its
encoder (``lame`` 0x55, ``mp2enc`` 0x50, with the byte rate the encoder
set) or PCM (1, with no byte rate; ``ac3enc``'s AC-3 too, as the JAX
module tags it); ``--avi_comments``' ``TAG text`` lines as LIST INFO.  ``raw``: the payloads as they come, audio to a
sibling ``<name>.aud`` (the main file in an audio-only session).
``null``: counts and discards.  The engine writes the default
``raw,raw,auto`` route to a ``.y4m`` with its own Y4M writer; ``y4m``
serves the other encoders.
"""

from __future__ import annotations

import struct

import numpy as np

from tcforge_tpu_torch.core.codecs import Codec, ContainerFormat
from tcforge_tpu_torch.core.formats import ImageFormat
from tcforge_tpu_torch.core.optstr import ModuleDesc, ParamSpec
from tcforge_tpu_torch.io.wav import WavInfo, WavWriter
from tcforge_tpu_torch.modules.registry import (ModuleInfo, ModuleKind,
                                                Muxer, register)


def fps_to_ratio(fps: float):
    """Best rational fps for the container header, frc table first."""
    from fractions import Fraction

    from tcforge_tpu_torch.core import ratiocodes
    code = ratiocodes.frc_code_from_value(fps)
    if code is not None:
        return ratiocodes.frc_code_to_ratio(code)
    frac = Fraction(fps).limit_denominator(65535)
    return frac.numerator, frac.denominator


@register
class WavMuxer(Muxer):
    info = ModuleInfo(name="wav", kind=ModuleKind.MULTIPLEXOR, media="audio",
                      codecs_in=(Codec.PCM,),
                      formats_out=(ContainerFormat.WAV,))
    desc = ModuleDesc(name="wav", comment="RIFF/WAVE PCM writer")

    def open(self, path: str) -> None:
        self._w = WavWriter(path, WavInfo(
            rate=(self.job.mp3frequency or self.job.a_rate),
            channels=self.job.dm_chan, bits=self.job.dm_bits))

    def write_video(self, payload: bytes, keyframe: bool = True) -> int:
        raise NotImplementedError("wav mux is audio-only")

    def write_audio(self, payload: bytes, track: int = 0) -> int:
        a = np.frombuffer(payload, np.int16).reshape(
            -1, max(1, self.job.dm_chan))
        self._w.write_samples(a)
        return len(payload)

    def close(self) -> None:
        self._w.close()


@register
class Y4MMuxer(Muxer):
    info = ModuleInfo(name="y4m", kind=ModuleKind.MULTIPLEXOR, media="video",
                      codecs_in=(Codec.YUV420P, Codec.YUV422P, Codec.RAW),
                      formats_out=(ContainerFormat.YUV4MPEG,))
    desc = ModuleDesc(name="y4m", comment="YUV4MPEG2 stream writer")
    # behind the encoders that give frames (copy, an RGB job's planes);
    # the default raw route to a .y4m keeps the engine's own writer,
    # which writes straight from the batch's pinned planes

    def open(self, path: str) -> None:
        from tcforge_tpu_torch.io.y4m import Y4MHeader, Y4MWriter
        w, h = ((self.job.ex_v_width, self.job.ex_v_height)
                if self.job.ex_v_width else self.job.export_size())
        num, den = fps_to_ratio(self.job.out_fps)
        fmt = self.job.im_colorspace
        self._rgb_in = fmt.is_rgb
        self._size = (w, h)
        if not fmt.is_planar or fmt.is_rgb:
            fmt = ImageFormat.YUV420P
        self._w = Y4MWriter(path, Y4MHeader(
            width=w, height=h, fps_num=num, fps_den=den, format=fmt))

    def write_video(self, payload: bytes, keyframe: bool = True) -> int:
        if self._rgb_in:
            from tcforge_tpu_torch.core.frame import FrameBatch
            from tcforge_tpu_torch.ops import colorspace
            w, h = self._size
            rgb = np.frombuffer(payload, np.uint8).reshape(h, w, 3)
            fb = FrameBatch.from_numpy(rgb=rgb[None].copy(),
                                       fmt=self.job.im_colorspace)
            out = colorspace.convert(fb, ImageFormat.YUV420P)
            payload = b"".join(p[0].cpu().numpy().tobytes()
                               for p in (out.y, out.u, out.v))
        self._w._f.write(b"FRAME\n")
        self._w._f.write(payload)
        self._w.frames_written += 1
        return len(payload)

    def close(self) -> None:
        self._w.close()


@register
class AviMuxer(Muxer):
    info = ModuleInfo(name="avi", kind=ModuleKind.MULTIPLEXOR, media="both",
                      codecs_in=(Codec.ANY,),
                      formats_out=(ContainerFormat.AVI,))
    desc = ModuleDesc(name="avi", comment="AVI container writer (avilib)",
                      params=[ParamSpec("fourcc", "video fourcc", "s", "")])

    _FMT_FOURCC = {
        ImageFormat.YUV420P: "I420", ImageFormat.YV12: "YV12",
        ImageFormat.YUY2: "YUY2", ImageFormat.UYVY: "UYVY",
        ImageFormat.RGB24: "RGB ", ImageFormat.BGR24: "DIB ",
    }
    # compressed video encoders imply their fourcc (players route the
    # stream by strf biCompression, like the wFormatTag below)
    _ENC_FOURCC = {"x264": "H264", "xvid": "XVID", "mpeg2": "mpg2",
                   "dv": "dvsd", "movjpeg": "MJPG", "theora": "theo"}
    # the audio encoders' wFormatTag (MPEG layer 3 0x55, layer 1/2 0x50)
    _ENC_FORMAT_TAG = {"lame": 0x55, "mp2enc": 0x50, "toolame": 0x50}

    def open(self, path: str) -> None:
        from tcforge_tpu_torch.io.avi import (AviAudioStream, AviVideoStream,
                                              AviWriter)
        job = self.job
        w, h = ((job.ex_v_width, job.ex_v_height)
                if job.ex_v_width else job.export_size())
        # -F doubles as fourcc (short, no '=') or encoder option string
        job_fcc = job.ex_v_fcc or ""
        if "=" in job_fcc or len(job_fcc) > 4:
            job_fcc = ""
        fourcc = (self.options.get("fourcc") or job_fcc
                  or self._ENC_FOURCC.get(job.ex_v_module or "", "")
                  or self._FMT_FOURCC.get(job.im_colorspace, "I420"))
        video = AviVideoStream(fourcc=fourcc.strip(), width=w, height=h,
                               fps=job.out_fps)
        tracks = []
        if job.audio_out_file is None and job.a_rate:
            # compressed audio encoders stamp their wFormatTag, and the
            # byte rate their module set; every other encoder's track is
            # tagged PCM (1), ac3enc's too, as in the JAX module
            tag = self._ENC_FORMAT_TAG.get(job.ex_a_module, 1)
            byte_rate = 0
            if tag != 1:
                blob = job.extradata.get("audio_byte_rate")
                byte_rate = struct.unpack("<I", blob)[0] if blob else 16000
            tracks.append(AviAudioStream(
                format_tag=tag, byte_rate=byte_rate,
                rate=(job.mp3frequency or job.a_rate),
                channels=job.dm_chan, bits=job.dm_bits))
        comments = None
        cf = getattr(job, "avi_comments_file", None)
        if cf:
            # one "TAG text" per line (avimerge -c)
            comments = {}
            with open(cf) as f:
                for line in f:
                    line = line.strip()
                    if line and not line.startswith("#"):
                        tag, _, text = line.partition(" ")
                        comments[tag[:4]] = text.strip()
        self._w = AviWriter(path, video, tracks, comments=comments)

    def write_video(self, payload: bytes, keyframe: bool = True) -> int:
        self._w.write_video_frame(payload, keyframe)
        return len(payload)

    def write_audio(self, payload: bytes, track: int = 0) -> int:
        self._w.write_audio(payload, track)
        return len(payload)

    def close(self) -> None:
        self._w.close()


@register
class RawMuxer(Muxer):
    info = ModuleInfo(name="raw", kind=ModuleKind.MULTIPLEXOR, media="both",
                      codecs_in=(Codec.ANY,),
                      formats_out=(ContainerFormat.RAW,))
    desc = ModuleDesc(name="raw", comment="headerless stream writer")

    def open(self, path: str) -> None:
        self._path = path
        self._f = open(path, "wb")
        self._fa = None
        job = self.job
        self._audio_to_main = not (job.ex_v_width or job.im_v_width)

    def write_video(self, payload: bytes, keyframe: bool = True) -> int:
        self._f.write(payload)
        return len(payload)

    def write_audio(self, payload: bytes, track: int = 0) -> int:
        # audio goes to a sibling <name>.aud stream (multiplex_raw.c);
        # an audio-only session writes the main file
        if self._audio_to_main:
            self._f.write(payload)
            return len(payload)
        if self._fa is None:
            self._fa = open(self._path + ".aud", "wb")
        self._fa.write(payload)
        return len(payload)

    def close(self) -> None:
        self._f.close()
        if self._fa is not None:
            self._fa.close()


@register
class NullMuxer(Muxer):
    info = ModuleInfo(name="null", kind=ModuleKind.MULTIPLEXOR, media="both",
                      codecs_in=(Codec.ANY,), formats_out=())
    desc = ModuleDesc(name="null", comment="discard output (multiplex_null)")

    def open(self, path: str) -> None:
        self.bytes_written = 0

    def write_video(self, payload: bytes, keyframe: bool = True) -> int:
        self.bytes_written += len(payload)
        return len(payload)

    def write_audio(self, payload: bytes, track: int = 0) -> int:
        self.bytes_written += len(payload)
        return len(payload)
