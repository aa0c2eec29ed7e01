"""Module kinds, the module base classes and the registry.

The port's counterpart of ``tcforge_tpu/modules/registry.py``, cut to
what its engine uses: ``ModuleKind`` and ``FilterSlot`` keep the JAX
values; ``VideoFilter`` and ``AudioFilter`` the same methods with
tensors in place of jax arrays; ``Importer``, ``Encoder`` and ``Muxer``
the JAX method names (``open``/``read_video_batch``/``read_audio_batch``/
``close``, ``encode_video``/``encode_audio``/``flush``, ``open``/
``write_video``/``write_audio``/``close``), on host numpy arrays.
``new_module(kind, name, ...)`` returns the torch class, and
``find_mux_module_for_path`` maps a file name to the port's
multiplexor, as the JAX lookup does.  A
``-J`` list names video and audio filters alike; the video chain keeps
the ``VideoFilter`` instances, the audio chain the ``AudioFilter`` ones.
"""

from __future__ import annotations

import abc
import enum
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple, Type

import numpy as np
import torch

from tcforge_tpu_torch.core.codecs import Codec, ContainerFormat
from tcforge_tpu_torch.core.formats import ImageFormat
from tcforge_tpu_torch.core.frame import AudioBatch, FrameBatch
from tcforge_tpu_torch.core.job import Job
from tcforge_tpu_torch.core.optstr import ModuleDesc


class ModuleKind(enum.Enum):
    """The five NMS module kinds (tcmodule-data.h:121-168)."""

    DEMULTIPLEXOR = "demultiplexor"
    DECODER = "decoder"
    FILTER = "filter"
    ENCODER = "encoder"
    MULTIPLEXOR = "multiplexor"


class FilterSlot(enum.IntFlag):
    """Filter placement slots (docs/tech/filter-API.txt; frame.h tags)."""

    PRE_S = 1      # single-threaded, right after import
    PRE_M = 2      # in the (conceptual) filter workers, before transforms
    POST_M = 4     # after internal transforms
    POST_S = 8     # single-threaded, right before encode


@dataclass(frozen=True)
class ModuleInfo:
    """Capability record (TCModuleInfo analogue)."""

    name: str
    kind: ModuleKind
    media: str = "video"                       # video | audio | both
    codecs_in: Tuple[Codec, ...] = (Codec.ANY,)
    codecs_out: Tuple[Codec, ...] = (Codec.ANY,)
    formats_in: Tuple[ContainerFormat, ...] = ()
    formats_out: Tuple[ContainerFormat, ...] = ()


class Module(abc.ABC):
    """A module instance: its job and its parsed options."""

    info: ModuleInfo
    desc: ModuleDesc

    def __init__(self, job: Job, options: str = ""):
        self.job = job
        self.options: Dict[str, Any] = (
            self.desc.parse_options(options) if self.desc.params else {})


class VideoFilter(Module):
    """Batched video filter: FrameBatch in, FrameBatch out, with an
    explicit carry state for temporal filters."""

    slots: FilterSlot = FilterSlot.POST_M
    media: str = "video"

    def init_state(self, width: int, height: int, fmt: ImageFormat,
                   device: torch.device) -> Any:
        """Return the initial carry on ``device`` (None for stateless)."""
        return None

    def output_size(self, width: int, height: int) -> Tuple[int, int]:
        """Geometry after this filter."""
        return width, height

    @abc.abstractmethod
    def apply(self, fb: FrameBatch, state: Any) -> Tuple[FrameBatch, Any]:
        ...

    def collect(self, state: Any) -> None:
        """Host-side look at the state a batch left, which the engine
        calls after every batch (32detect's verbose lines)."""

    def finalize(self, state: Any) -> None:
        """Host-side end-of-stream hook (the reference's filter CLOSE
        tag): the engine calls it once, after the last ``collect``, also
        when the run fails."""


class AudioFilter(Module):
    """Batched audio filter: AudioBatch in, AudioBatch out.  ``jitted``
    says which form of the JAX filter the port computes (the audio chain
    sets it per call): True as the jitted audio step runs it, False as
    op-by-op JAX runs it on the ``-E`` resampler's chunks."""

    slots: FilterSlot = FilterSlot.POST_M
    media: str = "audio"
    jitted: bool = True
    # the audio chain sets it per call: True where -s's amplify ran in the
    # same jitted step on the samples this filter gets
    after_amplify: bool = False

    def init_state(self, rate: int, channels: int,
                   device: torch.device) -> Any:
        """Return the initial carry on ``device`` (None for stateless)."""
        return None

    @abc.abstractmethod
    def apply(self, ab: AudioBatch, state: Any) -> Tuple[AudioBatch, Any]:
        ...

    def collect(self, state: Any) -> None:
        """Host-side per-batch hook (the same contract as VideoFilter's)."""

    def finalize(self, state: Any) -> None:
        """Host-side end-of-stream hook (filter CLOSE tag)."""


class Importer(Module):
    """Demultiplexor and decoder in one: host frames and samples."""

    @abc.abstractmethod
    def open(self, path: Optional[str]) -> None: ...

    @abc.abstractmethod
    def read_video_batch(self, n: int) -> Optional[Dict[str, np.ndarray]]:
        """Stacked planes ('y', 'u', 'v' or 'rgb'), (N, H, W), or None at
        the end of the stream."""

    def read_audio_batch(self, n_samples: int) -> Optional[np.ndarray]:
        """(S, C) int16 samples, or None."""
        return None

    def close(self) -> None:
        pass

    # geometry and rate, known after open()
    width: int = 0
    height: int = 0
    fps: float = 0.0
    format: ImageFormat = ImageFormat.YUV420P
    total_frames: Optional[int] = None
    audio_rate: int = 0
    audio_channels: int = 0


class Encoder(Module):
    """Frame batch -> per-frame payload bytes (encode_video analogue),
    from batches whose tensors are in host memory."""

    @abc.abstractmethod
    def encode_video(self, fb: FrameBatch) -> List[bytes]: ...

    def encode_audio(self, ab: AudioBatch) -> List[bytes]:
        raise NotImplementedError

    # set by flush(): how many real frames the tail payloads contain
    last_flush_frames: int = 0

    def flush(self) -> List[bytes]:
        return []


class Muxer(Module):
    """Container writer (write_video/write_audio analogue)."""

    @abc.abstractmethod
    def open(self, path: str) -> None: ...

    @abc.abstractmethod
    def write_video(self, payload: bytes, keyframe: bool = True) -> int: ...

    def write_audio(self, payload: bytes, track: int = 0) -> int:
        raise NotImplementedError

    def close(self) -> None:
        pass


_REGISTRIES: Dict[ModuleKind, Dict[str, Type[Module]]] = {
    k: {} for k in ModuleKind}


def register(cls: Type[Module]) -> Type[Module]:
    """Class decorator: the TC_MODULE_ENTRY_POINT analogue."""
    info = getattr(cls, "info", None)
    if info is None:
        raise TypeError(f"{cls.__name__} lacks a ModuleInfo 'info'")
    table = _REGISTRIES[info.kind]
    if info.name in table:
        raise ValueError(f"duplicate module {info.kind}:{info.name}")
    table[info.name] = cls
    return cls


# reference module names that map onto one implementation (the JAX
# registry's aliases, cut to the modules the port has): import_mpeg2.c,
# import_mpg.c and import_vob.c all walk the same PS/ES demux; toolame
# is the MP2 encoder
_ALIASES = {ModuleKind.DEMULTIPLEXOR: {"mpeg2": "mpeg", "mpg": "mpeg",
                                       "vob": "mpeg"},
            ModuleKind.ENCODER: {"toolame": "mp2enc"}}


def lookup(kind: ModuleKind, name: str) -> Type[Module]:
    name = _ALIASES.get(kind, {}).get(name, name)
    try:
        return _REGISTRIES[kind][name]
    except KeyError:
        known = sorted(_REGISTRIES[kind])
        raise KeyError(
            f"no {kind.value} module {name!r} in the torch port "
            f"(known: {known})") from None


def new_module(kind: ModuleKind, name: str, job: Job,
               options: str = "") -> Module:
    """tc_new_module analogue."""
    return lookup(kind, name)(job, options)


# file-name extension -> multiplexor (the JAX package's _FORMAT_MAP)
MUX_BY_EXT: Dict[str, str] = {
    ".nuv": "nuv", ".pvn": "pvn", ".mov": "mov", ".qt": "mov",
    ".ppm": "im", ".pgm": "im", ".y4m": "y4m", ".avi": "avi",
    ".wav": "wav", ".raw": "raw", ".yuv": "raw", ".ogg": "ogg",
    ".ogm": "ogg", ".m2v": "raw", ".m1v": "raw", ".mpg": "mpg",
    ".mpeg": "mpg", ".vob": "mpg", ".mp4": "lavf", ".webm": "lavf",
    ".flac": "lavf", ".mkv": "lavf", ".ts": "lavf", ".es": "raw"}


def jax_mux_module_for_path(path: str) -> Optional[str]:
    """The JAX package's multiplexor for a file name, by its extension,
    whether or not the port has it."""
    import os
    return MUX_BY_EXT.get(os.path.splitext(path)[1].lower())


def find_mux_module_for_path(path: str) -> Optional[str]:
    """The port's multiplexor for a file name, by its extension."""
    name = jax_mux_module_for_path(path)
    return name if name in _REGISTRIES[ModuleKind.MULTIPLEXOR] else None


# -N's export format names -> encoders, in order of preference (the JAX
# package's _FORMAT_MAP "encoder" rows, tcforge_tpu/modules/registry.py:
# 346-364)
ENCODER_BY_FORMAT: Dict[str, Tuple[str, ...]] = {
    "yuv420p": ("raw",), "rgb24": ("raw",), "pcm": ("raw",),
    "mpeg2video": ("mpeg2",), "mpeg1": ("mpeg2",), "mpeg2": ("mpeg2",),
    "mpeg1video": ("mpeg2",), "mjpeg": ("movjpeg",), "rtjpeg": ("nuvrtj",),
    "mpeg4video": ("xvid", "lavc"), "h264": ("x264", "lavc"),
    "theora": ("theora",), "dvvideo": ("dv",), "mp3": ("lame",),
    "mp2": ("mp2enc",), "ac3": ("ac3enc",), "vorbis": ("vorbis",),
    "aac": ("faac",)}


def encoder_for_format(fmt: str) -> Optional[str]:
    """-N: the first encoder for an export format name that the port has
    (``module_name_for_format("encoder", fmt)``); None for a name the JAX
    package does not know either.  A format whose encoders the port
    lacks raises ``NotImplementedError`` naming the JAX module."""
    names = ENCODER_BY_FORMAT.get(fmt.lower())
    if names is None:
        return None
    for name in names:
        if name in _REGISTRIES[ModuleKind.ENCODER]:
            return name
    raise NotImplementedError(
        f"-N {fmt}: the {names[0]} encoder module is not ported to the "
        "torch port yet")
