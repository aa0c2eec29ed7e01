"""Batched frame containers of the port (``tcforge_tpu/core/frame.py``).

A ``FrameBatch`` holds N frames as planar tensors ``(N, H, W)`` per
plane on one device, with the same fields as the JAX ``FrameBatch``.
It is a frozen dataclass; ``with_planes`` and ``with_attrs`` return a
new batch.  The ``ATTR_*`` flags keep the JAX values.  An
``AudioBatch`` holds N audio frames as one ``(N, S, C)`` tensor.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from tcforge_tpu_torch.core.formats import ImageFormat

# Frame attribute flags — values mirror tccore/frame.h:72-83.
ATTR_KEYFRAME = 1
ATTR_INTERLACED = 2
ATTR_BROKEN = 4
ATTR_SKIPPED = 8
ATTR_CLONED = 16
ATTR_WAS_CLONED = 32
ATTR_OUT_OF_RANGE = 64
ATTR_DELAYED = 128
ATTR_END_OF_STREAM = 256


@dataclasses.dataclass(frozen=True)
class FrameBatch:
    """A batch of N video frames as planar tensors on one device.

    Planar YUV: ``y`` is (N, H, W) uint8; ``u``/``v`` are the subsampled
    (N, H//sy, W//sx) chroma planes; Y8/GRAY8 set only ``y``.  RGB
    formats: ``rgb`` is (N, H, W, C) uint8 in R,G,B[,A] order and the
    planes are None.  ``attrs`` (the frame attribute bitmask) and
    ``frame_ids`` are (N,) int32.  ``id_range``: host-side bounds
    ``(lo, hi)`` that every frame id lies in, ``lo <= id < hi``, where
    the batch's maker knows them (None: unknown; a filter that repeats
    or drops frames keeps them valid).  ``timestamps`` keeps the JAX
    record's shape and is unused by the port's chains so far.
    """

    format: ImageFormat
    y: Optional[torch.Tensor] = None
    u: Optional[torch.Tensor] = None
    v: Optional[torch.Tensor] = None
    rgb: Optional[torch.Tensor] = None
    attrs: Optional[torch.Tensor] = None
    frame_ids: Optional[torch.Tensor] = None
    timestamps: Optional[torch.Tensor] = None
    interlaced: bool = False
    fps: float = 0.0
    id_range: Optional[Tuple[int, int]] = None

    @property
    def batch(self) -> int:
        return self._ref.shape[0]

    @property
    def height(self) -> int:
        return self._ref.shape[1]

    @property
    def width(self) -> int:
        return self._ref.shape[2]

    @property
    def device(self) -> torch.device:
        return self._ref.device

    @property
    def _ref(self) -> torch.Tensor:
        return self.y if self.y is not None else self.rgb

    @property
    def planes(self) -> Tuple[torch.Tensor, ...]:
        """Non-None image planes, luma first (rgb counts as one plane)."""
        if self.rgb is not None:
            return (self.rgb,)
        return tuple(p for p in (self.y, self.u, self.v) if p is not None)

    def with_planes(self, *, y=None, u=None, v=None, rgb=None,
                    format: Optional[ImageFormat] = None) -> "FrameBatch":
        """Return a copy with replaced image planes (metadata kept);
        ``rgb`` replaces the planes altogether, and the reverse."""
        fmt = format if format is not None else self.format
        if rgb is not None:
            return dataclasses.replace(self, format=fmt, rgb=rgb,
                                       y=None, u=None, v=None)
        return dataclasses.replace(
            self, format=fmt, rgb=None,
            y=y if y is not None else self.y,
            u=u if u is not None else self.u,
            v=v if v is not None else self.v)

    def with_attrs(self, attrs: torch.Tensor) -> "FrameBatch":
        return dataclasses.replace(self, attrs=attrs)

    @staticmethod
    def from_numpy(y: Optional[np.ndarray] = None,
                   u: Optional[np.ndarray] = None,
                   v: Optional[np.ndarray] = None, *,
                   rgb: Optional[np.ndarray] = None,
                   device: torch.device,
                   fmt: ImageFormat = ImageFormat.YUV420P,
                   fps: float = 0.0, first_id: int = 0) -> "FrameBatch":
        """Build a batch on ``device`` from host uint8 planes (a batch
        dimension is added to 2-D planes and to a 3-D ``rgb``)."""

        def prep(a, ndim):
            if a is None:
                return None
            a = np.ascontiguousarray(a, dtype=np.uint8)
            if a.ndim == ndim:
                a = a[None]
            return torch.from_numpy(a).to(device)

        y, u, v, rgb = prep(y, 2), prep(u, 2), prep(v, 2), prep(rgb, 3)
        n = (y if y is not None else rgb).shape[0]
        return FrameBatch(
            format=fmt, y=y, u=u, v=v, rgb=rgb,
            attrs=torch.zeros((n,), dtype=torch.int32, device=device),
            frame_ids=torch.arange(first_id, first_id + n,
                                   dtype=torch.int32, device=device),
            fps=fps, id_range=(first_id, first_id + n))

    def to_numpy(self) -> Tuple[np.ndarray, ...]:
        """The image planes as host uint8 arrays, luma first."""
        return tuple(p.cpu().numpy() for p in self.planes)


def host_to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array as a tensor on ``device``; to a card through pinned
    memory and a copy the host does not wait for."""
    if not a.flags.writeable:
        a = a.copy()
    t = torch.from_numpy(np.ascontiguousarray(a))
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


@dataclasses.dataclass(frozen=True)
class AudioBatch:
    """A batch of N audio frames (one frame = the samples covering one
    video frame period, as in the reference's TCFrameAudio).

    ``pcm`` is (N, S, C) int16 (or float32 mid-chain): S samples per
    frame, C channels; ``attrs`` and ``frame_ids`` are (N,) int32.
    """

    pcm: torch.Tensor
    rate: int = 48000
    channels: int = 2
    bits: int = 16
    attrs: Optional[torch.Tensor] = None
    frame_ids: Optional[torch.Tensor] = None

    @property
    def batch(self) -> int:
        return self.pcm.shape[0]

    @property
    def samples_per_frame(self) -> int:
        return self.pcm.shape[1]

    @property
    def device(self) -> torch.device:
        return self.pcm.device

    def with_pcm(self, pcm: torch.Tensor) -> "AudioBatch":
        return dataclasses.replace(self, pcm=pcm)

    @staticmethod
    def from_numpy(pcm: np.ndarray, *, device: torch.device,
                   rate: int = 48000, first_id: Optional[int] = None
                   ) -> "AudioBatch":
        """A batch on ``device`` from host (N, S, C) samples (a batch
        dimension is added to (S, C) samples); ``first_id`` numbers the
        frames when given."""
        pcm = np.ascontiguousarray(pcm)
        if pcm.ndim == 2:
            pcm = pcm[None]
        t = torch.from_numpy(pcm).to(device)
        ids = (None if first_id is None else torch.arange(
            first_id, first_id + pcm.shape[0], dtype=torch.int32,
            device=device))
        return AudioBatch(pcm=t, rate=rate, channels=pcm.shape[-1],
                          frame_ids=ids)

    def to_numpy(self) -> np.ndarray:
        """The samples as a host (N, S, C) array."""
        return self.pcm.cpu().numpy()

    def has_attr(self, flag: int) -> torch.Tensor:
        """(N,) bool mask of frames carrying the given attribute flag."""
        if self.attrs is None:
            return torch.zeros((self.batch,), dtype=torch.bool,
                               device=self.pcm.device)
        return (self.attrs & flag) != 0
