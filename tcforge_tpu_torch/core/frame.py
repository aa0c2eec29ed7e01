"""Batched frame container of the port (``tcforge_tpu/core/frame.py``).

A ``FrameBatch`` holds N frames as planar tensors ``(N, H, W)`` per
plane on one device, with the same fields as the JAX ``FrameBatch``.
It is a frozen dataclass; ``with_planes`` returns a new batch.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from tcforge_tpu_torch.core.formats import ImageFormat


@dataclasses.dataclass(frozen=True)
class FrameBatch:
    """A batch of N video frames as planar tensors on one device.

    Planar YUV: ``y`` is (N, H, W) uint8; ``u``/``v`` are the subsampled
    (N, H//sy, W//sx) chroma planes.  ``attrs`` (the frame attribute
    bitmask) and ``frame_ids`` are (N,) int32.  ``rgb`` and
    ``timestamps`` keep the JAX record's shape and are unused by the
    port's chains so far.
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

    def with_planes(self, *, y=None, u=None, v=None,
                    format: Optional[ImageFormat] = None) -> "FrameBatch":
        """Return a copy with replaced image planes (metadata kept)."""
        return dataclasses.replace(
            self, format=format if format is not None else self.format,
            y=y if y is not None else self.y,
            u=u if u is not None else self.u,
            v=v if v is not None else self.v)

    @staticmethod
    def from_numpy(y: np.ndarray, u: Optional[np.ndarray] = None,
                   v: Optional[np.ndarray] = None, *,
                   device: torch.device,
                   fmt: ImageFormat = ImageFormat.YUV420P,
                   fps: float = 0.0, first_id: int = 0) -> "FrameBatch":
        """Build a batch on ``device`` from host uint8 planes (a batch
        dimension is added to 2-D planes)."""

        def prep(a):
            if a is None:
                return None
            a = np.ascontiguousarray(a, dtype=np.uint8)
            if a.ndim == 2:
                a = a[None]
            return torch.from_numpy(a).to(device)

        y, u, v = prep(y), prep(u), prep(v)
        n = y.shape[0]
        return FrameBatch(
            format=fmt, y=y, u=u, v=v,
            attrs=torch.zeros((n,), dtype=torch.int32, device=device),
            frame_ids=torch.arange(first_id, first_id + n,
                                   dtype=torch.int32, device=device),
            fps=fps)

    def to_numpy(self) -> Tuple[np.ndarray, ...]:
        """The image planes as host uint8 arrays, luma first."""
        return tuple(p.cpu().numpy() for p in self.planes)
