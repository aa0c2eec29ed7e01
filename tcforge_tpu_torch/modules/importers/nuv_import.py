"""The NuppelVideo import module (``nuv``): the port of
``tcforge_tpu/modules/importers/nuv_import.py`` ``NuvImporter``.

The container is the pinned ``io/nuv.py``.  Video frames: RTjpeg
(``'1'``), raw YUV420 (``'0'``), black (``'N'``) and repeat-last
(``'L'``); the LZO-wrapped ``'2'`` and ``'3'`` raise as in the JAX
importer, and an unknown type is skipped with a warning.  ``'D'`` frames
carry the RTjpeg tables, ``'A'`` frames raw PCM, which the session reads
as the video walk meets it (44.1 kHz stereo, as the JAX importer
states).  The video decodes through the plan/execute protocol: the
reader thread walks the frames and decodes each RTjpeg payload's bytes
on the host (``io/rtjcodec.py`` ``decompress_frames``, C++ on host
threads), the main thread uploads the coefficients and runs one
``rtjpeg_idct`` launch for each run of frames of one table set (one a
batch in practice); raw frames are uploaded, black ones made on the
device.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from tcforge_tpu_torch.core.codecs import Codec, ContainerFormat
from tcforge_tpu_torch.core.formats import ImageFormat
from tcforge_tpu_torch.core.optstr import ModuleDesc
from tcforge_tpu_torch.io import nuv, rtjcodec
from tcforge_tpu_torch.modules.importers import start_on_the_card
from tcforge_tpu_torch.modules.importers.dv_import import pick_frames
from tcforge_tpu_torch.modules.registry import (Importer, ModuleInfo,
                                                ModuleKind, register)


@dataclass
class Plan:
    """A batch of the NUV decode: ``runs`` of RTjpeg frames decoded on
    the host (their int32 coefficients and handles), the raw frames'
    host planes and the black frames by handle, the handles it decodes
    in order, ``frames`` those it shows and ``live`` those to keep."""

    runs: List[Tuple[np.ndarray, List[int]]]
    raw: Dict[int, Tuple[np.ndarray, np.ndarray, np.ndarray]]
    black: List[int]
    decoded: List[int]
    frames: List[int] = field(default_factory=list)
    live: List[int] = field(default_factory=list)


@register
class NuvImporter(Importer):
    info = ModuleInfo(name="nuv", kind=ModuleKind.DEMULTIPLEXOR,
                      media="both", codecs_out=(Codec.YUV420P, Codec.PCM),
                      formats_in=(ContainerFormat.NUV,))
    desc = ModuleDesc(name="nuv",
                      comment="NuppelVideo import (RTjpeg/raw)")
    planned = True

    def open(self, path: Optional[str]) -> None:
        self._f = open(path, "rb")
        hdr = nuv.read_file_header(self._f)
        self.width, self.height = hdr.width, hdr.height
        self.fps = hdr.fps or 25.0
        self.format = ImageFormat.YUV420P
        self.audio_rate = 44100
        self.audio_channels = 2
        if hdr.videoblocks > 0:
            self.total_frames = hdr.videoblocks
        self._frames = nuv.iter_frames(self._f)
        self._tables = None       # the current 'D' frame's decoder state
        self._last: Optional[int] = None
        self._handles = 0
        self._kept: Dict[int, Dict[str, torch.Tensor]] = {}
        self._device: Optional[torch.device] = None
        self._audio = bytearray()
        self._saw_audio = False

    def start(self, device: torch.device, buffers: int = 1) -> None:
        """Decode onto ``device``."""
        self._device = torch.device(device)

    def plan_batch(self, n: int, alive=None) -> Optional[Plan]:
        """Walk the frames until ``n`` video frames (as the JAX importer's
        ``read_video_batch``), decoding the RTjpeg ones on the host; None
        when no video frame is left."""
        if self._device is None:
            raise RuntimeError("NuvImporter.start() was not called")
        runs: List[Tuple[object, List[bytes], List[int]]] = []
        raw: Dict[int, Tuple[np.ndarray, ...]] = {}
        black: List[int] = []
        decoded: List[int] = []
        shown: List[int] = []
        w, h = self.width, self.height

        def new_handle() -> int:
            self._handles += 1
            decoded.append(self._handles)
            return self._handles
        for ftype, ctype, _tc, payload in self._frames:
            if ftype == "D":
                if ctype == "R":
                    self._tables = rtjcodec.decompress_tables(payload)
                continue
            if ftype == "A":
                if ctype == "0":
                    self._audio += payload
                    self._saw_audio = True
                continue
            if ftype != "V":
                continue
            if ctype == "0":               # raw YUV420
                ysz = w * h
                csz = ysz // 4
                planes = (
                    np.frombuffer(payload, np.uint8, ysz).reshape(h, w),
                    np.frombuffer(payload, np.uint8, csz, ysz).reshape(
                        h // 2, w // 2),
                    np.frombuffer(payload, np.uint8, csz, ysz + csz)
                    .reshape(h // 2, w // 2))
                self._last = new_handle()
                raw[self._last] = planes
            elif ctype == "1":             # RTjpeg
                if self._tables is None:
                    raise ValueError("nuv: RTjpeg frame before the "
                                     "compressor data ('D') frame")
                if not runs or runs[-1][0] is not self._tables:
                    runs.append((self._tables, [], []))
                self._last = new_handle()
                runs[-1][1].append(payload)
                runs[-1][2].append(self._last)
            elif ctype == "N":             # black frame
                self._last = new_handle()
                black.append(self._last)
            elif ctype == "L":             # repeat last
                if self._last is None:
                    self._last = new_handle()
                    black.append(self._last)
            elif ctype in ("2", "3"):
                raise NotImplementedError(
                    "nuv: lzo-compressed frames are not supported "
                    "(no lzo in this build)")
            else:
                sys.stderr.write(f"[nuv] unknown video comptype {ctype!r}\n")
                continue
            shown.append(self._last)
            if len(shown) >= n:
                break
        if not shown:
            return None
        done = []
        for (qt, lb8, cb8), payloads, handles in runs:
            rtjcodec.check_geometry(w, h)
            nb = rtjcodec.frame_blocks(w, h)
            coef = np.empty((len(payloads) * nb, 64), np.int32)
            rtjcodec.decompress_frames(payloads, nb, qt, lb8, cb8, coef)
            done.append((coef, handles))
        # the last frame shown stays for a repeat in a later batch
        return Plan(done, raw, black, decoded, shown, [self._last])

    def execute(self, plan: Plan, copy_stream=None
                ) -> Optional[Dict[str, torch.Tensor]]:
        """The device half: ``{"y", "u", "v"}`` on the device, one
        ``rtjpeg_idct`` launch a run of RTjpeg frames."""
        from tcforge_tpu_torch.ops import kernels
        dev = self._device
        w, h = self.width, self.height
        got: Dict[int, Tuple[torch.Tensor, ...]] = {}
        for coef, handles in plan.runs:
            y, u, v = kernels.rtjpeg_idct(torch.from_numpy(coef).to(dev), w,
                                          h)
            for i, hd in enumerate(handles):
                got[hd] = (y[i], u[i], v[i])
        for hd, planes in plan.raw.items():
            got[hd] = tuple(torch.from_numpy(p.copy()).to(dev)
                            for p in planes)
        for hd in plan.black:
            got[hd] = (torch.full((h, w), 16, dtype=torch.uint8, device=dev),
                       torch.full((h // 2, w // 2), 128, dtype=torch.uint8,
                                  device=dev),
                       torch.full((h // 2, w // 2), 128, dtype=torch.uint8,
                                  device=dev))
        if len(plan.runs) == 1 and not plan.raw and not plan.black:
            made = {"y": y, "u": u, "v": v}     # the kernel's, as made
        elif plan.decoded:
            made = {k: torch.stack([got[hd][i] for hd in plan.decoded])
                    for i, k in enumerate("yuv")}
        else:                              # repeats of kept frames only
            made = {}
        return pick_frames(plan.decoded, plan.frames, plan.live, made,
                           self._kept)

    def release(self, plan: Plan) -> None:
        pass

    def seek(self, frame: int) -> bool:
        return False

    def read_video_batch(self, n: int):
        start_on_the_card(self)
        plan = self.plan_batch(n)
        return None if plan is None else self.execute(plan)

    def read_audio_batch(self, n_samples: int) -> Optional[np.ndarray]:
        if not self._saw_audio:
            return None
        want = n_samples * 2 * 2           # 16-bit stereo
        chunk = bytes(self._audio[:want])
        del self._audio[:len(chunk)]
        if not chunk:
            return None
        pcm = np.frombuffer(chunk, "<i2")
        return pcm.reshape(-1, 2)

    def close(self) -> None:
        self._f.close()
