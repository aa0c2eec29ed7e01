"""The WAV import module (``tcforge_tpu/modules/importers/wav_import.py``):
RIFF/WAVE PCM samples through the port's copy of ``io/wav.py``."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from tcforge_tpu_torch.core.codecs import Codec, ContainerFormat
from tcforge_tpu_torch.core.optstr import ModuleDesc
from tcforge_tpu_torch.io.wav import WavReader
from tcforge_tpu_torch.modules.registry import (Importer, ModuleInfo,
                                                ModuleKind, register)


@register
class WavImporter(Importer):
    info = ModuleInfo(name="wav", kind=ModuleKind.DEMULTIPLEXOR,
                      media="audio",
                      codecs_out=(Codec.PCM,),
                      formats_in=(ContainerFormat.WAV,))
    desc = ModuleDesc(name="wav", comment="RIFF/WAVE PCM reader")

    def open(self, path: Optional[str]) -> None:
        self._r = WavReader(path)
        self.audio_rate = self._r.info.rate
        self.audio_channels = self._r.info.channels

    def read_video_batch(self, n: int) -> Optional[Dict[str, np.ndarray]]:
        return None

    def read_audio_batch(self, n_samples: int) -> Optional[np.ndarray]:
        return self._r.read_samples(n_samples)

    def close(self) -> None:
        self._r.close()
