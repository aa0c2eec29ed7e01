"""The ``dvd`` import module: a title of a decrypted ``VIDEO_TS``
directory (``-x dvd -T title[,c1[-c2]]``), the port of ``DvdImporter``
in ``tcforge_tpu/modules/importers/device_import.py``.

The title's VOB files, from the IFO title table (``io/ifo.py``), play
through the multi-source importer (``multi.py``), one fresh MPEG importer
a file.  A chapter range is cut out by the cells' sectors into a spool
file (``tempfile``, removed on ``close``), which plays alone.  Reading a
disc or an encrypted one (CSS) raises the JAX package's gate message.
"""

from __future__ import annotations

import logging
import os
import tempfile
from typing import Optional

from tcforge_tpu_torch.core.codecs import Codec, ContainerFormat
from tcforge_tpu_torch.core.optstr import ModuleDesc
from tcforge_tpu_torch.io import ifo
from tcforge_tpu_torch.modules.importers.multi import MultiSourceImporter
from tcforge_tpu_torch.modules.registry import (Importer, ModuleInfo,
                                                ModuleKind, register)

_log = logging.getLogger("tcforge_tpu_torch")


@register
class DvdImporter(Importer):
    info = ModuleInfo(name="dvd", kind=ModuleKind.DEMULTIPLEXOR,
                      media="both",
                      codecs_out=(Codec.YUV420P, Codec.PCM),
                      formats_in=(ContainerFormat.MPEG_PS,))
    desc = ModuleDesc(name="dvd", comment="DVD title reader "
                      "(decrypted VIDEO_TS rips: native IFO title "
                      "navigation; CSS devices gated)")
    gate_message = ("no CSS descrambling in this build; decrypt the "
                    "disc to a VIDEO_TS directory first (-i rip_dir "
                    "-T title works natively)")
    demux_audio = True          # the MPEG importers' (set before open)

    def _gate(self, detail: str) -> None:
        raise NotImplementedError(
            f"{self.info.name}: {detail} — {self.gate_message}")

    def open(self, path: Optional[str]) -> None:
        self._inner: Optional[MultiSourceImporter] = None
        self._spool: Optional[str] = None
        ts_dir = ifo.find_video_ts(path) if path else None
        if ts_dir is None:
            if path and os.path.isfile(path):
                self._gate(f"{path} looks like a file — if it is a "
                           "decrypted VOB, use -x mpeg")
            self._gate(f"cannot open DVD device {path!r}")
        job = self.job
        title = getattr(job, "dvd_title", 0) or 1
        vobs = ifo.title_vobs(ts_dir, title)
        t = next(tt for tt in ifo.list_titles(ts_dir) if tt.title == title)
        _log.info("[dvd] title %d: VTS %02d, %d chapter(s), %d VOB file(s)",
                  title, t.vts, t.chapters, len(vobs))
        ch1 = max(0, getattr(job, "dvd_chapter1", -1))
        ch2 = max(ch1, getattr(job, "dvd_chapter2", -1))
        if ch1:
            # the cells' sectors of the chapter range into a spool file
            # (tccat -T t,c's role)
            spans = []
            for c in range(ch1, ch2 + 1):
                spans.extend(ifo.chapter_sectors(ts_dir, title, c))
            fd, self._spool = tempfile.mkstemp(suffix=".vob")
            with os.fdopen(fd, "wb") as f:
                n = ifo.extract_sectors(ts_dir, title, spans, f)
            _log.info("[dvd] chapters %d-%d: %d cell(s), %d bytes", ch1, ch2,
                      len(spans), n)
            vobs = [self._spool]
        self._inner = MultiSourceImporter(job)
        self._inner.demux_audio = self.demux_audio
        self._inner.open(vobs)
        for key in ("width", "height", "fps", "format", "audio_rate",
                    "audio_channels", "total_frames"):
            setattr(self, key, getattr(self._inner, key))

    # the multi importer's protocol, passed through

    def start(self, device, buffers: int = 1, pool=None) -> None:
        self._inner.start(device, buffers, pool)

    def plan_batch(self, n: int, alive=None):
        return self._inner.plan_batch(n, alive)

    def execute(self, plan, copy_stream=None):
        return self._inner.execute(plan, copy_stream)

    def release(self, plan) -> None:
        self._inner.release(plan)

    def seek(self, frame: int) -> bool:
        return self._inner.seek(frame)

    def read_video_batch(self, n: int):
        return self._inner.read_video_batch(n)

    def read_audio_batch(self, n_samples: int):
        return self._inner.read_audio_batch(n_samples)

    def close(self) -> None:
        if getattr(self, "_inner", None) is not None:
            self._inner.close()
        if getattr(self, "_spool", None):
            try:
                os.unlink(self._spool)
            except OSError:
                pass
