"""Multi-source and directory import: the port of
``tcforge_tpu/modules/importers/multi.py`` over the MPEG importer's
plan/execute protocol.

Several program, transport or elementary streams or VideoCD tracks play
as one: each file opens with a fresh MPEG importer when the one before
has no frame left, its size and colorspace checked against the first's.  A directory expands to its
files, sorted.  As in the JAX package, nothing carries over between two
files' decoders: a GOP cut at a file boundary decodes as far as each
file alone holds it.  The old file's audio that the session has not read
yet (up to 30 s) is drained before the old importer closes, so the track
stays contiguous.

The engine's threads see one importer: ``plan_batch`` (the reader
thread) returns the current file's plan, tagged with the importer that
made it, and ``execute`` (the main thread) runs a plan on that importer,
which keeps its reference frames on the device until its last plan has
run: each importer counts its plans not run yet, and one that the
reader thread has left closes when that count reaches 0, on whichever
thread brings it there.  The importers share one ring of host
buffers.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from tcforge_tpu_torch.core.codecs import Codec, ContainerFormat
from tcforge_tpu_torch.core.optstr import ModuleDesc
from tcforge_tpu_torch.io.probe import sniff_magic
from tcforge_tpu_torch.modules.registry import (Importer, ModuleInfo,
                                                ModuleKind, new_module,
                                                register)

_log = logging.getLogger("tcforge_tpu_torch")


def expand_sources(spec: Union[str, Sequence[str]]) -> List[str]:
    """-i argument(s) -> ordered file list (directories expand)."""
    paths = [spec] if isinstance(spec, str) else list(spec)
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            names = sorted(os.listdir(p))
            out.extend(os.path.join(p, n) for n in names
                       if os.path.isfile(os.path.join(p, n)))
        else:
            out.append(p)
    return out


@register
class MultiSourceImporter(Importer):
    info = ModuleInfo(name="multi", kind=ModuleKind.DEMULTIPLEXOR,
                      media="both", codecs_out=(Codec.ANY,),
                      formats_in=())
    desc = ModuleDesc(name="multi",
                      comment="multi-source / directory-mode importer")
    demux_audio = True          # the MPEG importers' (set before open)

    def __init__(self, job, options: str = ""):
        super().__init__(job, options)
        self._cur = None
        self._idx = 0
        self.paths: List[str] = []
        self._device: Optional[torch.device] = None
        self._buffers = 1
        self._pool = None
        # plans made and not yet run or released, by importer id; an
        # importer left for the next file waits in _retired until 0
        self._lock = threading.Lock()
        self._outstanding: Dict[int, int] = {}
        self._retired: Dict[int, object] = {}

    def open(self, path) -> None:
        self.paths = expand_sources(path)
        if not self.paths:
            raise FileNotFoundError(f"multi: no input files in {path!r}")
        self._idx = 0
        self._audio_tail: List[np.ndarray] = []
        self._open_one(0)
        self.width = self._cur.width
        self.height = self._cur.height
        self.fps = self._cur.fps
        self.format = self._cur.format
        self.audio_rate = self._cur.audio_rate
        self.audio_channels = self._cur.audio_channels

    def _open_one(self, i: int) -> None:
        path = self.paths[i]
        try:
            fmt = sniff_magic(path)
        except OSError:
            fmt = ContainerFormat.UNKNOWN
        if fmt not in (ContainerFormat.MPEG_PS, ContainerFormat.MPEG_ES,
                       ContainerFormat.MPEG_TS, ContainerFormat.CDXA):
            raise NotImplementedError(
                f"multi: {path} is {fmt.value}; the torch port plays MPEG "
                "program, transport and elementary streams and VideoCD "
                "tracks one after the other only")
        imp = new_module(ModuleKind.DEMULTIPLEXOR, "mpeg", self.job)
        imp.demux_audio = self.demux_audio
        imp.open(path)
        if i > 0:
            if (imp.width, imp.height) != (self.width, self.height):
                raise ValueError(
                    f"multi: {path} geometry {imp.width}x{imp.height} "
                    f"differs from {self.width}x{self.height}")
            if imp.format != self.format:
                raise ValueError(
                    f"multi: {path} colorspace {imp.format} differs "
                    f"from {self.format}")
            if imp.fps and self.fps and abs(imp.fps - self.fps) > 0.01:
                _log.warning("[multi] %s: fps %.3f != %.3f (continuing)",
                             path, imp.fps, self.fps)
        old = self._cur
        if old is not None:
            # the old source's unread audio (up to 30 s), so that the
            # track stays contiguous across the file boundary
            if old.audio_rate:
                have = sum(t.shape[0] for t in self._audio_tail)
                cap = old.audio_rate * 30
                while have < cap:
                    got = old.read_audio_batch(1 << 16)
                    if got is None or got.shape[0] == 0:
                        break
                    self._audio_tail.append(np.asarray(got))
                    have += got.shape[0]
            self._retire(old)
        self._cur = imp
        if self._device is not None:
            self._start_current()
        _log.info("[multi] source %d/%d: %s", i + 1, len(self.paths), path)

    def _retire(self, imp) -> None:
        """The host half closes now; the device frames go once the
        importer's last plan has run."""
        imp.close_host()
        with self._lock:
            if self._outstanding.get(id(imp), 0):
                self._retired[id(imp)] = imp
                return
            self._outstanding.pop(id(imp), None)
        imp.close()

    def _done(self, imp) -> None:
        """One of ``imp``'s plans ran or was released."""
        with self._lock:
            left = self._outstanding[id(imp)] - 1
            self._outstanding[id(imp)] = left
            if left or id(imp) not in self._retired:
                return
            del self._retired[id(imp)]
            del self._outstanding[id(imp)]
        imp.close()

    # -- the MPEG protocol --------------------------------------------- #

    def _start_current(self) -> None:
        self._cur.start(self._device, self._buffers, pool=self._pool)
        self._pool = self._cur.buffer_pool

    def start(self, device: torch.device, buffers: int = 1,
              pool=None) -> None:
        self._device = torch.device(device)
        self._buffers = buffers
        self._pool = pool
        self._start_current()

    def plan_batch(self, n: int, alive=None):
        while True:
            plan = self._cur.plan_batch(n, alive)
            if plan is not None:
                plan.owner = self._cur
                with self._lock:
                    key = id(self._cur)
                    self._outstanding[key] = (
                        self._outstanding.get(key, 0) + 1)
                return plan
            if alive is not None and not alive():
                return None
            if self._idx + 1 >= len(self.paths):
                return None
            self._idx += 1
            self._open_one(self._idx)

    def execute(self, plan, copy_stream=None):
        try:
            return plan.owner.execute(plan, copy_stream)
        finally:
            self._done(plan.owner)

    def release(self, plan) -> None:
        plan.owner.release(plan)
        self._done(plan.owner)

    def read_video_batch(self, n: int):
        """Plan and run one batch in the calling thread (on the card
        unless ``start`` chose another device)."""
        if self._device is None:
            if not torch.cuda.is_available():
                raise RuntimeError("MultiSourceImporter: no CUDA device is "
                                   "available (call start(torch.device("
                                   "'cpu')) to decode with the plain "
                                   "versions)")
            self.start(torch.device("cuda"))
        while True:
            plan = self.plan_batch(n)
            if plan is None:
                return None
            out = self.execute(plan)
            if out is not None:
                return out

    def seek(self, frame: int) -> bool:
        """False: the engine decodes and drops ``frame`` frames, as the
        JAX engine does for ``multi``, which has no seek of its own."""
        return False

    def read_audio_batch(self, n_samples: int) -> Optional[np.ndarray]:
        """The drained previous-file tail first, then the current source,
        topping up short reads so the track stays contiguous."""
        pieces: List[np.ndarray] = []
        need = n_samples
        while need > 0:
            if self._audio_tail:
                t = self._audio_tail[0]
                take = min(need, t.shape[0])
                pieces.append(t[:take])
                if take < t.shape[0]:
                    self._audio_tail[0] = t[take:]
                else:
                    self._audio_tail.pop(0)
                need -= take
                continue
            got = self._cur.read_audio_batch(need)
            if got is None or got.shape[0] == 0:
                break              # the video side advances the files
            pieces.append(np.asarray(got))
            need -= got.shape[0]
        if not pieces:
            return None
        return (np.concatenate(pieces) if len(pieces) > 1
                else pieces[0])

    def close(self) -> None:
        with self._lock:
            retired = list(self._retired.values())
            self._retired = {}
            self._outstanding = {}
        for imp in retired:
            imp.close()
        if self._cur is not None:
            self._cur.close()
