"""The DV import module (``dv``): the port of the in-tree route of
``tcforge_tpu/modules/importers/device_import.py`` ``DvImporter`` (the
JAX package's route without its FFmpeg bridge, or with
``TCFORGE_NATIVE_DV=1``).

The DIF container is the pinned ``io/dv.py`` (``parse_frame_info``,
``iter_frames``).  The video decodes through the plan/execute protocol
of the port's device importers: the reader thread parses each batch's
frames on the host (``io/dvcodec.py`` ``parse_frames``, C++ on host
threads), the main thread uploads the records and runs one ``dv_idct``
launch a batch; PAL is 720x576 4:2:0, NTSC 720x480 4:1:1 turned into
4:2:0 by the JAX importer's ``to420``.  A PAL stream with 48 kHz 16-bit
AAUX audio is the session's audio, read on a second walk of the frames
(``io/dvcodec.py`` ``extract_audio``); NTSC and other audio modes are
video only, as in the JAX importer.  There is no index seek: ``-L``
decodes and drops.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from tcforge_tpu_torch.core.codecs import Codec, ContainerFormat
from tcforge_tpu_torch.core.formats import ImageFormat
from tcforge_tpu_torch.core.optstr import ModuleDesc
from tcforge_tpu_torch.io import dv as dvio
from tcforge_tpu_torch.io import dvcodec
from tcforge_tpu_torch.modules.importers import start_on_the_card
from tcforge_tpu_torch.modules.registry import (Importer, ModuleInfo,
                                                ModuleKind, register)


@dataclass
class Plan:
    """A batch of the DV decode: its frames' parse records (host arrays),
    the handles it decodes, ``frames`` the handles it shows (the
    synchronizer may repeat or drop some) and ``live`` the handles to
    keep on the device afterwards."""

    coef: np.ndarray
    mode: np.ndarray
    decoded: List[int]
    frames: List[int] = field(default_factory=list)
    live: List[int] = field(default_factory=list)


def pick_frames(decoded: List[int], frames: List[int], live: List[int],
                made: Dict[str, torch.Tensor], kept: Dict) -> Optional[Dict]:
    """The ``y``, ``u`` and ``v`` planes of the handles ``frames`` from a
    batch just decoded (``made``, the handles ``decoded`` in order) and
    the frames ``kept`` from earlier batches; ``kept`` then holds the
    handles ``live``."""
    at = {h: i for i, h in enumerate(decoded)}

    def plane(h: int, k: str) -> torch.Tensor:
        return made[k][at[h]] if h in at else kept[h][k]
    if not frames:
        out = None
    elif frames == decoded:
        out = made
    else:
        out = {k: torch.stack([plane(h, k) for h in frames]) for k in "yuv"}
    new = {h: {k: plane(h, k) for k in "yuv"} for h in live}
    kept.clear()
    kept.update(new)
    return out


@register
class DvImporter(Importer):
    info = ModuleInfo(name="dv", kind=ModuleKind.DEMULTIPLEXOR,
                      media="both",
                      codecs_out=(Codec.YUV420P, Codec.PCM),
                      formats_in=(ContainerFormat.DV_FILE,))
    desc = ModuleDesc(name="dv", comment="DV/DIF reader (native "
                      "DV25 PAL decoder; bridge for NTSC + audio)")
    # the video decodes through plan_batch/execute on the device
    planned = True

    def open(self, path: Optional[str]) -> None:
        with open(path, "rb") as f:
            head = f.read(dvio.PAL_FRAME)
        d = dvio.parse_frame_info(head)
        if not ((d.is_pal and d.sampling == "4:2:0")
                or (not d.is_pal and d.sampling == "4:1:1")):
            sysname = "625/50 PAL" if d.is_pal else "525/60 NTSC"
            raise NotImplementedError(
                f"dv: {sysname} {d.width}x{d.height} {d.sampling} "
                "stream recognized — the in-tree decoder covers DV25 "
                "PAL 4:2:0 and NTSC 4:1:1; this geometry needs the "
                "FFmpeg bridge (make -C native)")
        self._pal = d.is_pal
        self._f = open(path, "rb")
        self._frames = dvio.iter_frames(self._f)
        self.width, self.height = d.width, d.height
        self.fps = 25.0 if d.is_pal else 29.97
        self.format = ImageFormat.YUV420P
        self._device: Optional[torch.device] = None
        self._handles = 0
        self._kept: Dict[int, Dict[str, torch.Tensor]] = {}
        self._aud_frames = None
        if d.is_pal:
            # AAUX 48k/16-bit on a second frame walk, so audio and video
            # batches advance independently; other modes are video only
            try:
                _, rate = dvcodec.extract_audio(head)
                self._aud_f = open(path, "rb")
                self._aud_frames = dvio.iter_frames(self._aud_f)
                self.audio_rate = rate
                self.audio_channels = 2
            except (ValueError, NotImplementedError):
                pass

    def start(self, device: torch.device, buffers: int = 1) -> None:
        """Decode onto ``device``."""
        self._device = torch.device(device)

    def plan_batch(self, n: int, alive=None) -> Optional[Plan]:
        """The host half of the next ``n`` frames: their parse records,
        None at the end of the stream."""
        if self._device is None:
            raise RuntimeError("DvImporter.start() was not called")
        frames: List[bytes] = []
        while len(frames) < n:
            fr = next(self._frames, None)
            if fr is None:
                break
            frames.append(fr)
        if not frames:
            return None
        nb = dvcodec.frame_blocks(self._pal)
        coef = np.zeros((len(frames) * nb, 64), np.int16)
        mode = np.zeros(len(frames) * nb, np.uint8)
        dvcodec.parse_frames(frames, self._pal, coef, mode)
        handles = list(range(self._handles, self._handles + len(frames)))
        self._handles += len(frames)
        return Plan(coef, mode, handles, list(handles))

    def execute(self, plan: Plan, copy_stream=None
                ) -> Optional[Dict[str, torch.Tensor]]:
        """The device half: ``{"y", "u", "v"}`` 4:2:0 planes on the
        device, one launch of ``dv_idct``."""
        dev = self._device
        coef = torch.from_numpy(plan.coef).to(dev)
        mode = torch.from_numpy(plan.mode).to(dev)
        y, u, v = dvcodec.decode_records(coef, mode, self._pal)
        return pick_frames(plan.decoded, plan.frames, plan.live,
                           {"y": y, "u": u, "v": v}, self._kept)

    def release(self, plan: Plan) -> None:
        pass

    def seek(self, frame: int) -> bool:
        """No index seek (the JAX importer has none): the engine decodes
        and drops."""
        return False

    def read_video_batch(self, n: int):
        """Up to ``n`` frames, planned and run in the calling thread, on
        the card unless ``start`` chose another device; None at the
        end."""
        start_on_the_card(self)
        plan = self.plan_batch(n)
        return None if plan is None else self.execute(plan)

    def read_audio_batch(self, samples: int):
        if self._aud_frames is None:
            return None
        chunks = []
        have = 0
        while have < samples:
            frame = next(self._aud_frames, None)
            if frame is None:
                break
            pcm, _ = dvcodec.extract_audio(frame)
            chunks.append(pcm)
            have += len(pcm)
        if not chunks:
            return None
        return np.concatenate(chunks)

    def close(self) -> None:
        if self._aud_frames is not None:
            self._aud_f.close()
        self._f.close()
