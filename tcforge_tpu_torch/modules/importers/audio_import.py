"""The audio import modules ``mp3``, ``ac3``, ``flac`` and ``aac`` (the
port of ``tcforge_tpu/modules/importers/audio_import.py``), and ``au``,
``vag`` and ``null``.

Each serves as the ``-p`` audio beside any video, or as an audio-only
``-i``.  The JAX modules decode through the FFmpeg bridge where it is
built; the port runs the JAX package's in-tree decoders, pinned copies:

- ``mp3`` (MPEG audio, Layers I to III) and ``ac3`` read the file in
  64 KB pieces and decode them in a worker process
  (``io/adec_worker.py``) a few pieces ahead of what the session takes,
  the JAX ``_BridgeAudioImporter``'s feed, read and flush; the rate and
  channels come from the first decoded frame;
- ``flac`` (``io/flac.py``) and ``aac`` (ADTS, ``io/aacdec.py``) decode
  the whole file at ``open``, the JAX modules' route without the bridge
  (``TCFORGE_NATIVE_FLAC``, ``TCFORGE_NATIVE_AAC``); FLAC samples of
  other depths than 16 bits are shifted to 16, as there.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from tcforge_tpu_torch.core.codecs import Codec, ContainerFormat
from tcforge_tpu_torch.core.optstr import ModuleDesc, ParamSpec
from tcforge_tpu_torch.modules.registry import (Importer, ModuleInfo,
                                                ModuleKind, register)

_CHUNK = 1 << 16


class _StreamAudioImporter(Importer):
    """A file of MPEG audio or AC-3 frames decoded piece by piece."""

    codec_name = ""

    def open(self, path: Optional[str]) -> None:
        from tcforge_tpu_torch.io.adec_worker import StreamSamples
        self._f = open(path, "rb")
        self._s = StreamSamples(self.codec_name,
                                iter(lambda: self._f.read(_CHUNK), b""))
        try:
            self._s.fill(1)              # the first frame: the rate
        except BaseException:
            self.close()
            raise
        self.audio_rate = self._s.rate
        self.audio_channels = self._s.channels

    def read_video_batch(self, n: int) -> Optional[Dict[str, np.ndarray]]:
        return None

    def read_audio_batch(self, samples: int) -> Optional[np.ndarray]:
        self._s.fill(samples)
        return self._s.take(samples)

    def close(self) -> None:
        if getattr(self, "_s", None) is not None:
            self._s.close()
            self._s = None
        if getattr(self, "_f", None) is not None:
            self._f.close()
            self._f = None


@register
class Mp3Importer(_StreamAudioImporter):
    info = ModuleInfo(name="mp3", kind=ModuleKind.DEMULTIPLEXOR,
                      media="audio", codecs_out=(Codec.PCM,),
                      formats_in=(ContainerFormat.MP3_FILE,))
    desc = ModuleDesc(name="mp3", comment="MPEG audio (layers I-III) "
                      "decode via the FFmpeg bridge")
    codec_name = "mp3"


@register
class Ac3Importer(_StreamAudioImporter):
    info = ModuleInfo(name="ac3", kind=ModuleKind.DEMULTIPLEXOR,
                      media="audio", codecs_out=(Codec.PCM,),
                      formats_in=(ContainerFormat.AC3_FILE,))
    desc = ModuleDesc(name="ac3", comment="AC-3/A52 audio decode via "
                      "the FFmpeg bridge")
    codec_name = "ac3"


class _WholeAudioImporter(Importer):
    """A file decoded whole at ``open``, served in order."""

    def _decode(self, data: bytes):
        """(pcm (S, C) int16, rate, channels) of the file's bytes."""
        raise NotImplementedError

    def open(self, path: Optional[str]) -> None:
        with open(path, "rb") as f:
            self._pcm, self.audio_rate, self.audio_channels = \
                self._decode(f.read())
        self._pos = 0

    def read_video_batch(self, n: int) -> Optional[Dict[str, np.ndarray]]:
        return None

    def read_audio_batch(self, samples: int) -> Optional[np.ndarray]:
        out = self._pcm[self._pos:self._pos + samples]
        self._pos += len(out)
        return out if len(out) else None

    def close(self) -> None:
        self._pcm = None


@register
class FlacImporter(_WholeAudioImporter):
    info = ModuleInfo(name="flac", kind=ModuleKind.DEMULTIPLEXOR,
                      media="audio", codecs_out=(Codec.PCM,),
                      formats_in=(ContainerFormat.FLAC_FILE,))
    desc = ModuleDesc(name="flac", comment="FLAC audio decode "
                      "(bridge or the native io/flac.py decoder)")

    def _decode(self, data: bytes):
        from tcforge_tpu_torch.io.flac import decode_stream
        pcm, rate, ch, bps = decode_stream(data)
        if bps > 16:
            pcm = pcm >> (bps - 16)
        elif bps < 16:
            pcm = pcm << (16 - bps)
        return pcm.astype(np.int16), rate, ch


@register
class AacImporter(_WholeAudioImporter):
    info = ModuleInfo(name="aac", kind=ModuleKind.DEMULTIPLEXOR,
                      media="audio", codecs_out=(Codec.PCM,),
                      formats_in=(ContainerFormat.AAC_FILE,))
    desc = ModuleDesc(name="aac", comment="AAC-LC audio decode "
                      "(bridge or the native io/aacdec.py decoder)")

    def _decode(self, data: bytes):
        from tcforge_tpu_torch.io.aacdec import decode_adts_stream
        return decode_adts_stream(data)


@register
class AuImporter(Importer):
    """A Sun/NeXT ``.au`` file (``tcforge_tpu/modules/importers/
    au_import.py``): μ-law, A-law, 8-bit and 16-bit big-endian linear
    samples to int16 through the pinned ``io/au.py``."""

    info = ModuleInfo(name="au", kind=ModuleKind.DEMULTIPLEXOR,
                      media="audio", codecs_out=(Codec.PCM,),
                      formats_in=(ContainerFormat.SUNAU,))
    desc = ModuleDesc(name="au", comment="Sun/NeXT .au audio reader "
                      "(mu-law + linear)")

    def open(self, path: Optional[str]) -> None:
        from tcforge_tpu_torch.io.au import AuReader
        self._r = AuReader(path)
        self.audio_rate = self._r.rate
        self.audio_channels = self._r.channels

    def read_video_batch(self, n: int) -> Optional[Dict[str, np.ndarray]]:
        return None

    def read_audio_batch(self, n_samples: int) -> Optional[np.ndarray]:
        return self._r.read_samples(n_samples)

    def close(self) -> None:
        self._r.close()


@register
class VagImporter(Importer):
    """PlayStation VAG ADPCM (``tcforge_tpu/modules/importers/
    vag_import.py``): VAGp mono and SShd/SSbd stereo-blocked files, and
    SShd raw PCM, through the pinned ``io/vag.py``."""

    info = ModuleInfo(name="vag", kind=ModuleKind.DEMULTIPLEXOR,
                      media="audio", codecs_out=(Codec.PCM,),
                      formats_in=(ContainerFormat.VAG,))
    desc = ModuleDesc(
        name="vag", comment="PlayStation VAG ADPCM audio",
        params=[ParamSpec("blocksize", "stereo interleave override",
                          "d", 0, 0, 0x1000)])

    def open(self, path: Optional[str]) -> None:
        from tcforge_tpu_torch.io.vag import VagReader
        self._r = VagReader(path)
        override = int(self.options.get("blocksize", 0) or 0)
        if override:
            self._r.info.block = override
        self.audio_rate = self._r.info.rate
        self.audio_channels = self._r.info.channels

    def read_video_batch(self, n: int) -> Optional[Dict[str, np.ndarray]]:
        return None

    def read_audio_batch(self, samples: int) -> Optional[np.ndarray]:
        return self._r.read(samples)


@register
class NullAudioImporter(Importer):
    """import_null.c (``tcforge_tpu/modules/importers/device_import.py``):
    a source of nothing.  Its session takes its shape from the job: ``-g``
    for the video, ``-e`` for the audio."""

    info = ModuleInfo(name="null", kind=ModuleKind.DEMULTIPLEXOR,
                      media="both", codecs_out=())
    desc = ModuleDesc(name="null", comment="null source (no frames)")

    def open(self, path: Optional[str]) -> None:
        pass

    def read_video_batch(self, n: int) -> Optional[Dict[str, np.ndarray]]:
        return None

    def read_audio_batch(self, samples: int) -> Optional[np.ndarray]:
        return None
