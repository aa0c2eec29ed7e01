"""Module kinds, the video filter base class and the filter registry.

The port's counterpart of ``tcforge_tpu/modules/registry.py``, cut to
what its chains use: ``ModuleKind`` and ``FilterSlot`` keep the JAX
values, ``VideoFilter`` the same methods with tensors in place of jax
arrays, and ``new_module(FILTER, name, ...)`` returns the torch class.
"""

from __future__ import annotations

import abc
import enum
from dataclasses import dataclass
from typing import Any, Dict, Tuple, Type

import torch

from tcforge_tpu_torch.core.formats import ImageFormat
from tcforge_tpu_torch.core.frame import FrameBatch
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


class VideoFilter(abc.ABC):
    """Batched video filter: FrameBatch in, FrameBatch out, with an
    explicit carry state for temporal filters."""

    info: ModuleInfo
    desc: ModuleDesc
    slots: FilterSlot = FilterSlot.POST_M

    def __init__(self, job: Job, options: str = ""):
        self.job = job
        self.options: Dict[str, Any] = (
            self.desc.parse_options(options) if self.desc.params else {})

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


_REGISTRIES: Dict[ModuleKind, Dict[str, Type[VideoFilter]]] = {
    k: {} for k in ModuleKind}


def register(cls: Type[VideoFilter]) -> Type[VideoFilter]:
    """Class decorator: the TC_MODULE_ENTRY_POINT analogue."""
    info = getattr(cls, "info", None)
    if info is None:
        raise TypeError(f"{cls.__name__} lacks a ModuleInfo 'info'")
    table = _REGISTRIES[info.kind]
    if info.name in table:
        raise ValueError(f"duplicate module {info.kind}:{info.name}")
    table[info.name] = cls
    return cls


def lookup(kind: ModuleKind, name: str) -> Type[VideoFilter]:
    try:
        return _REGISTRIES[kind][name]
    except KeyError:
        known = sorted(_REGISTRIES[kind])
        raise KeyError(
            f"no {kind.value} module {name!r} in the torch port "
            f"(known: {known})") from None


def new_module(kind: ModuleKind, name: str, job: Job,
               options: str = "") -> VideoFilter:
    """tc_new_module analogue."""
    return lookup(kind, name)(job, options)
