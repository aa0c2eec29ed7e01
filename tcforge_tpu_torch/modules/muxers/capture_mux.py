"""The capture containers' multiplexors: ``dv`` (``tcforge_tpu/modules/
muxers/basic.py`` ``DvMuxer``) and ``nuv`` (``tcforge_tpu/modules/
importers/nuv_import.py`` ``NuvMuxer``).

``dv`` writes the DV encoder's PAL frames as a raw DIF stream with the
session's PCM injected into each frame's AAUX sections
(``io/dvcodec.py`` ``inject_audio``, 1,920 stereo samples a frame, the
last frames padded with silence); it takes only 48 kHz 16-bit audio and
only 144,000-byte frames, with the JAX module's messages.  ``nuv`` writes
the NuppelVideo file header (the export size and rate), a ``'D'`` frame
with the encoder's RTjpeg tables before the first video frame, then
``'V'``/``'1'`` and ``'A'``/``'0'`` frames with millisecond timecodes.
"""

from __future__ import annotations

import numpy as np

from tcforge_tpu_torch.core.codecs import Codec, ContainerFormat
from tcforge_tpu_torch.core.optstr import ModuleDesc
from tcforge_tpu_torch.io import dvcodec, nuv
from tcforge_tpu_torch.modules.registry import (ModuleInfo, ModuleKind,
                                                Muxer, register)


@register
class DvMuxer(Muxer):
    info = ModuleInfo(name="dv", kind=ModuleKind.MULTIPLEXOR,
                      media="both", codecs_in=(Codec.DV, Codec.PCM),
                      formats_out=(ContainerFormat.DV_FILE,))
    desc = ModuleDesc(name="dv", comment="DV/DIF writer with native "
                      "AAUX audio injection (48k/16-bit stereo)")

    def open(self, path: str) -> None:
        job = self.job
        self._f = open(path, "wb")
        self._frames = []          # pending video frames
        self._pcm = np.zeros((0, 2), np.int16)
        self._has_audio = bool(job.dm_chan)
        if self._has_audio:
            rate = job.mp3frequency or job.a_rate
            if rate != 48000 or (job.dm_bits or 16) != 16:
                raise ValueError(
                    "dv mux: AAUX injection needs 48000 Hz 16-bit "
                    f"audio (got {rate} Hz / {job.dm_bits} bit); "
                    "resample with -E 48000,16,2")

    def _pump(self) -> None:
        while self._frames and (not self._has_audio
                                or len(self._pcm) >= 1920):
            fr = self._frames.pop(0)
            if self._has_audio:
                fr = dvcodec.inject_audio(fr, self._pcm[:1920])
                self._pcm = self._pcm[1920:]
            self._f.write(fr)

    def write_video(self, payload: bytes, keyframe: bool = True) -> int:
        if len(payload) != 144000:
            raise ValueError("dv mux: payload is not a PAL DV frame "
                             f"({len(payload)} bytes); use -y dv "
                             "and -Z 720x576")
        self._frames.append(payload)
        self._pump()
        return len(payload)

    def write_audio(self, payload: bytes, track: int = 0) -> int:
        if not self._has_audio:
            return 0
        ch = self.job.dm_chan
        pcm = np.frombuffer(payload, np.int16).reshape(-1, ch)
        if ch == 1:
            pcm = np.repeat(pcm, 2, axis=1)
        self._pcm = np.concatenate([self._pcm, pcm[:, :2]])
        self._pump()
        return len(payload)

    def close(self) -> None:
        # flush: pad trailing audio with silence
        while self._frames:
            fr = self._frames.pop(0)
            if self._has_audio:
                fr = dvcodec.inject_audio(fr, self._pcm[:1920])
                self._pcm = self._pcm[1920:] if len(self._pcm) > 1920 \
                    else np.zeros((0, 2), np.int16)
            self._f.write(fr)
        self._f.close()


@register
class NuvMuxer(Muxer):
    info = ModuleInfo(name="nuv", kind=ModuleKind.MULTIPLEXOR,
                      media="both", codecs_in=(Codec.ANY,),
                      formats_out=(ContainerFormat.NUV,))
    desc = ModuleDesc(name="nuv", comment="NuppelVideo writer")

    def open(self, path: str) -> None:
        self._f = open(path, "w+b")
        hdr = nuv.NuvHeader(width=self.job.ex_v_width or
                            self.job.im_v_width,
                            height=self.job.ex_v_height or
                            self.job.im_v_height,
                            fps=self.job.out_fps or self.job.fps or 25.0)
        nuv.write_file_header(self._f, hdr)
        self._wrote_tables = False
        self._frames = 0
        self._fps = hdr.fps

    def write_video(self, payload: bytes, keyframe: bool = True) -> int:
        if not self._wrote_tables:
            tables = self.job.extradata.get("rtjpeg_tables", b"")
            if tables:
                nuv.write_frame(self._f, "D", "R", tables)
            self._wrote_tables = True
        tc = int(self._frames * 1000 / max(1e-6, self._fps))
        nuv.write_frame(self._f, "V", "1", payload, timecode=tc)
        self._frames += 1
        return len(payload)

    def write_audio(self, payload: bytes, track: int = 0) -> int:
        tc = int(self._frames * 1000 / max(1e-6, self._fps))
        nuv.write_frame(self._f, "A", "0", payload, timecode=tc)
        return len(payload)

    def close(self) -> None:
        self._f.close()
