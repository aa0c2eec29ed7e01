"""The QuickTime/MOV import module (``mov``): the port of
``tcforge_tpu/modules/importers/mov_import.py`` ``MovImporter``.

The container is the pinned ``io/mov.MovReader`` (the atom walk, the
sample tables).  The video track takes one of two routes, by its
fourcc:

- photo-JPEG (``jpeg``, ``mjpa``): the plan/execute protocol of the AVI
  importer's Motion-JPEG route (``io/jpeg.JpegStream``): the reader
  thread runs each sample's Huffman decode on the host, the main thread
  one upload and the ``jpeg_idct`` and ``jpeg_color`` kernels a batch;
  RGB24 frames, PIL's bytes (the JAX reader's ``Image.open``), an
  ``mjpa`` sample's first field image;
- the uncompressed fourccs (``raw ``, ``yv12``, ``y420``, ``2vuy``,
  ``yuv2``): host planes from the pinned ``decode_video_sample``.

The fourccs that the JAX package hands to FFmpeg (``avc1``, ``mp4v``
and the rest) raise ``NotImplementedError`` naming the fourcc.  A
classic PCM track (``twos``, ``sowt``, ``raw ``, ``lpcm``) is the
session's audio, read as the JAX importer reads it.  There is no index
seek: ``-L`` decodes and drops, as the JAX engine does for this module.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from tcforge_tpu_torch.core.codecs import Codec, ContainerFormat
from tcforge_tpu_torch.core.formats import ImageFormat
from tcforge_tpu_torch.core.optstr import ModuleDesc
from tcforge_tpu_torch.io import mov
from tcforge_tpu_torch.io.jpeg import JpegStream
from tcforge_tpu_torch.modules.importers import start_on_the_card
from tcforge_tpu_torch.modules.registry import (Importer, ModuleInfo,
                                                ModuleKind, register)

JPEG_FOURCCS = ("jpeg", "mjpa")


@register
class MovImporter(Importer):
    info = ModuleInfo(name="mov", kind=ModuleKind.DEMULTIPLEXOR,
                      media="both",
                      codecs_out=(Codec.RGB24, Codec.YUV420P, Codec.PCM),
                      formats_in=(ContainerFormat.MOV,))
    desc = ModuleDesc(name="mov", comment="QuickTime/MOV reader "
                      "(raw/yv12/2vuy/jpeg video, PCM audio)")

    def open(self, path: Optional[str]) -> None:
        self._r = mov.MovReader(path)
        v = self._r.video
        a = self._r.audio
        self._jpeg: Optional[JpegStream] = None
        self._device: Optional[torch.device] = None
        if v is not None:
            self.width, self.height = v.width, v.height
            self.fps = v.fps or self.job.fps or 25.0
            self._vlocs = v.sample_locations()
            self.total_frames = len(self._vlocs)
            fcc = v.fourcc.lower()
            if fcc in ("yv12", "y420", "2vuy", "yuv2"):
                self.format = ImageFormat.YUV420P
            elif fcc in mov.VIDEO_FOURCCS:
                self.format = ImageFormat.RGB24
                if fcc in JPEG_FOURCCS:
                    self._jpeg = JpegStream()
            else:
                raise NotImplementedError(
                    f"mov: video fourcc {v.fourcc!r} is not ported to the "
                    "torch port yet (the JAX package decodes it through "
                    "FFmpeg)")
            self._v = v
        else:
            self._vlocs = []
            self._v = None
        self._vpos = 0
        if a is not None:
            self.audio_rate = a.samplerate
            self.audio_channels = a.channels or 2
            self._alocs = a.sample_locations()
            self._a = a
        else:
            self._alocs = []
            self._a = None
        self._apos = 0
        self._abuf = np.zeros((0, self.audio_channels or 2), np.int16)

    @property
    def planned(self) -> bool:
        """True when the video decodes through ``plan_batch`` and
        ``execute`` on the device (photo-JPEG), False for host planes."""
        return self._jpeg is not None

    # -- photo-JPEG: the plan/execute protocol ------------------------- #

    def start(self, device: torch.device, buffers: int = 1) -> None:
        """Decode onto ``device`` with a ring of ``buffers`` host buffers
        (pinned on a card)."""
        self._device = torch.device(device)
        self._jpeg.start(self._device, buffers)

    def _next_sample(self) -> Optional[bytes]:
        if self._vpos >= len(self._vlocs):
            return None
        data = self._r.read_sample(self._vlocs[self._vpos])
        self._vpos += 1
        return data

    def plan_batch(self, n: int, alive=None):
        """The host half of the next ``n`` frames (``JpegStream.plan``),
        None at the end of the track."""
        if self._device is None:
            raise RuntimeError("MovImporter.start() was not called")
        return self._jpeg.plan(self._next_sample, n, alive)

    def execute(self, plan, copy_stream=None
                ) -> Optional[Dict[str, torch.Tensor]]:
        """The device half: ``{"rgb": (N, H, W, 3)}`` on the device."""
        return self._jpeg.execute(plan, copy_stream)

    def release(self, plan) -> None:
        self._jpeg.release(plan)

    def seek(self, frame: int) -> bool:
        """No index seek (the JAX importer has none): the engine decodes
        and drops."""
        return False

    # -- the importer's interface -------------------------------------- #

    def read_video_batch(self, n: int):
        """Up to ``n`` frames: host planes for the uncompressed fourccs;
        photo-JPEG planned and run in the calling thread, on the card
        unless ``start`` chose another device.  None at the end."""
        if self._v is None:
            return None
        if self._jpeg is not None:
            start_on_the_card(self)
            plan = self.plan_batch(n)
            return None if plan is None else self.execute(plan)
        planes: Dict[str, List[np.ndarray]] = {}
        while self._vpos < len(self._vlocs) and \
                len(next(iter(planes.values()), [])) < n:
            data = self._r.read_sample(self._vlocs[self._vpos])
            self._vpos += 1
            dec = mov.decode_video_sample(self._v.fourcc, data,
                                          self.width, self.height)
            for k, arr in dec.items():
                planes.setdefault(k, []).append(arr)
        if not planes:
            return None
        return {k: np.stack(v) for k, v in planes.items()}

    def read_audio_batch(self, n_samples: int) -> Optional[np.ndarray]:
        if self._a is None:
            return None
        chunks = [self._abuf]
        have = len(self._abuf)
        while have < n_samples and self._apos < len(self._alocs):
            data = self._r.read_sample(self._alocs[self._apos])
            self._apos += 1
            pcm = mov.decode_audio_bytes(self._a.fourcc, data,
                                         self._a.channels,
                                         self._a.bits)
            chunks.append(pcm)
            have += len(pcm)
        pcm = np.concatenate(chunks) if len(chunks) > 1 else chunks[0]
        if len(pcm) == 0:
            return None
        out, self._abuf = pcm[:n_samples], pcm[n_samples:]
        return out

    def close(self) -> None:
        self._r.close()
