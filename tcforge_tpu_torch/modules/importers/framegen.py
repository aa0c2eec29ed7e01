# Copied from tcforge_tpu/modules/importers/framegen.py; only the package name in its imports differs.
"""Synthetic test source: color-wave video + pink-noise audio.

Rebuild of ``import/framegen/import_framegen.c:64-310``: the video
pattern is the reference's exact "color wave" (Y = x + y + 3*index,
U = 128 + y + 2*index, V = 64 + x + 5*index, uint8 wraparound,
import_framegen.c:189-222); audio is Voss-McCartney pink noise like
``pink.c`` (same algorithm; the PRNG differs, so samples are
statistically — not bit — identical).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from tcforge_tpu_torch.core.codecs import Codec, ContainerFormat
from tcforge_tpu_torch.core.formats import ImageFormat
from tcforge_tpu_torch.core.optstr import ModuleDesc, ParamSpec
from tcforge_tpu_torch.modules.registry import (Importer, ModuleInfo, ModuleKind,
                                          register)


class PinkNoise:
    """Voss-McCartney pink noise generator (pink.c analogue)."""

    def __init__(self, rows: int = 16, seed: int = 0):
        self._rng = np.random.default_rng(seed)
        self._rows = np.zeros(rows, np.float64)
        self._nrows = rows
        self._counter = 0
        self._running_sum = 0.0

    def samples(self, n: int) -> np.ndarray:
        """Vectorized Voss-McCartney step, bit-identical to the
        per-sample loop (the uniform draws are consumed in the same
        order, so a given seed yields the same stream)."""
        if n <= 0:
            return np.empty(0, np.float64)
        mask = (1 << self._nrows) - 1
        counters = (self._counter + 1 + np.arange(n, dtype=np.int64)) \
            & mask
        upd = counters != 0
        steps = upd.astype(np.int64) + 1       # draws per sample
        offsets = np.concatenate(([0], np.cumsum(steps)[:-1]))
        draws = self._rng.uniform(-1, 1, int(steps.sum()))
        white = draws[offsets + upd]
        uvals = draws[offsets[upd]]            # update draws, in order
        cu = counters[upd]
        # ctz via frexp (libm log2 per element is ~10x slower)
        rowsv = np.frexp((cu & -cu).astype(np.float64))[1] - 1
        delta = np.zeros(n, np.float64)
        usel = np.nonzero(upd)[0]
        for r in range(self._nrows):
            sel = rowsv == r
            if not sel.any():
                continue
            v = uvals[sel]
            prev = np.concatenate(([self._rows[r]], v[:-1]))
            delta[usel[sel]] = v - prev
            self._rows[r] = v[-1]
        # cumsum seeded with the carried running sum so the float
        # additions associate exactly like the serial loop
        rs = np.cumsum(np.concatenate(([self._running_sum],
                                       delta)))[1:]
        out = (rs + white) / (self._nrows + 1)
        self._running_sum = rs[-1]
        self._counter = int(counters[-1])
        return out


@register
class FrameGenImporter(Importer):
    info = ModuleInfo(name="framegen", kind=ModuleKind.DEMULTIPLEXOR,
                      media="both",
                      codecs_out=(Codec.YUV420P, Codec.PCM),
                      formats_in=(ContainerFormat.TEST,))
    desc = ModuleDesc(
        name="framegen", comment="synthetic colorwave + pink noise source",
        params=[ParamSpec("frames", "number of frames to generate", "d", 250),
                ParamSpec("seed", "noise seed", "d", 0)])

    def open(self, path: Optional[str]) -> None:
        self.width = self.job.im_v_width or 640
        self.height = self.job.im_v_height or 480
        self.fps = self.job.fps
        self.format = ImageFormat.YUV420P
        self.total_frames = int(self.options.get("frames", 250))
        self.audio_rate = self.job.a_rate
        self.audio_channels = self.job.a_chan
        self._index = 0
        self._pink = PinkNoise(seed=int(self.options.get("seed", 0)))
        # precompute coordinate ramps
        self._xy = (np.arange(self.width, dtype=np.int32)[None, :]
                    + np.arange(self.height, dtype=np.int32)[:, None])
        self._yramp = np.arange(self.height // 2, dtype=np.int32)[:, None]
        self._xramp = np.arange(self.width // 2, dtype=np.int32)[None, :]

    def read_video_batch(self, n: int) -> Optional[Dict[str, np.ndarray]]:
        n = min(n, self.total_frames - self._index)
        if n <= 0:
            return None
        idx = np.arange(self._index, self._index + n,
                        dtype=np.int32)[:, None, None]
        y = (self._xy[None] + idx * 3).astype(np.uint8)
        u = (128 + self._yramp[None] + idx * 2
             + np.zeros_like(self._xramp)[None]).astype(np.uint8)
        v = (64 + self._xramp[None] + idx * 5
             + np.zeros_like(self._yramp)[None]).astype(np.uint8)
        self._index += n
        return {"y": y, "u": u, "v": v}

    def read_audio_batch(self, n_samples: int) -> Optional[np.ndarray]:
        if self._index > self.total_frames:
            return None
        raw = self._pink.samples(n_samples * self.audio_channels)
        # import_framegen.c:137: sample * 0x03fffffff >> 16
        s = (raw * 0x03FFFFFFF).astype(np.int64) >> 16
        s = np.clip(s, -32768, 32767).astype(np.int16)
        return s.reshape(n_samples, self.audio_channels)

    def close(self) -> None:
        pass
