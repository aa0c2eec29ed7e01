# Copied from tcforge_tpu/core/framecode.py; only the package name in its imports differs.
"""Frame/time range lists — the ``-c`` option's data model.

Re-implementation of ``libtc/framecode.[ch]`` semantics:

- a range string is ``range[,range...]`` with each range
  ``start-end[/step]``;
- a time is ``[[H:]M:]S[.F]`` — a bare number is *seconds*, ``.F`` adds a
  frame offset within that second (``framecode.c:408-450``);
- the start frame index is ``floor(total_seconds * fps) + F``
  (``normalize_fc_time``, ``framecode.c:266-280``);
- ranges are half-open ``[start, end)`` in frame indices and a frame is
  "contained" when additionally ``(frame - start) % step == 0``
  (``fc_time_contains``, reference ``framecode.c``).
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass, field
from typing import Iterator, List, Optional, Tuple

import numpy as np


@dataclass
class FrameRange:
    """One parsed range (struct fc_time analogue, framecode.h:20-58)."""

    fps: float
    stf: int            # start frame index
    etf: int            # end frame index (exclusive)
    stepf: int = 1
    vob_offset: int = 0

    def contains(self, frame: int) -> bool:
        return (self.stf <= frame < self.etf
                and (frame - self.stf) % self.stepf == 0)

    def __len__(self) -> int:
        if self.etf <= self.stf:
            return 0
        return (self.etf - self.stf + self.stepf - 1) // self.stepf

    def frames(self) -> Iterator[int]:
        return iter(range(self.stf, self.etf, self.stepf))


@dataclass
class FrameRangeList:
    """Ordered list of ranges; the ``-c`` value."""

    ranges: List[FrameRange] = field(default_factory=list)

    def contains(self, frame: int) -> bool:
        return any(r.contains(frame) for r in self.ranges)

    def mask(self, first: int, count: int) -> np.ndarray:
        """Boolean mask of length `count` for frames [first, first+count).

        This is the batched replacement for per-frame fc_time_contains
        calls in the export loop (libtcexport/export.c:254-291).
        """
        return self.mask_ids(np.arange(first, first + count))

    def mask_ids(self, ids: np.ndarray) -> np.ndarray:
        """``mask`` over explicit (possibly non-contiguous) frame ids
        — the ONE home of the range/step membership expression."""
        m = np.zeros(ids.shape[0], dtype=bool)
        for r in self.ranges:
            m |= ((ids >= r.stf) & (ids < r.etf)
                  & ((ids - r.stf) % r.stepf == 0))
        return m

    @property
    def max_frame(self) -> Optional[int]:
        if not self.ranges:
            return None
        return max(r.etf for r in self.ranges)

    @property
    def min_frame(self) -> Optional[int]:
        if not self.ranges:
            return None
        return min(r.stf for r in self.ranges)

    def __len__(self) -> int:
        return len(self.ranges)

    def __iter__(self) -> Iterator[FrameRange]:
        return iter(self.ranges)


_TIME_RE = re.compile(
    r"^(?:(\d+):)?(?:(\d+):)?(\d+)(?:\.(\d+))?$")


def parse_time(text: str, fps: float) -> int:
    """Parse one ``[[H:]M:]S[.F]`` time into a frame index.

    Mirrors parse_one_time + normalize_fc_time (framecode.c:266-280,408-450):
    with one colon the fields are M:S, with two they are H:M:S.
    """
    m = _TIME_RE.match(text.strip())
    if not m:
        raise ValueError(f"bad framecode time: {text!r}")
    a, b, c, f = m.groups()
    if a is not None and b is not None:
        hour, minute, sec = int(a), int(b), int(c)
    elif a is not None:
        hour, minute, sec = 0, int(a), int(c)
    else:
        hour, minute, sec = 0, 0, int(c)
    frame = int(f) if f else 0
    return int(math.floor(((hour * 60 + minute) * 60 + sec) * fps)) + frame


def parse_ranges(text: str, fps: float,
                 separator: str = ",") -> FrameRangeList:
    """new_fc_time_from_string analogue (framecode.c:156-230)."""
    if fps <= 0:
        raise ValueError("fps must be positive")
    out = FrameRangeList()
    for chunk in text.split(separator):
        chunk = chunk.strip()
        if not chunk:
            continue
        step = 1
        if "/" in chunk:
            chunk, step_s = chunk.rsplit("/", 1)
            step = int(step_s)
            if step < 1:
                raise ValueError(f"bad step in range: {step}")
        if "-" not in chunk:
            raise ValueError(f"range missing '-': {chunk!r}")
        start_s, end_s = chunk.split("-", 1)
        stf = parse_time(start_s, fps)
        etf = parse_time(end_s, fps)
        if etf < stf:
            raise ValueError(f"range end before start: {chunk!r}")
        out.ranges.append(FrameRange(fps=fps, stf=stf, etf=etf, stepf=step))
    return out


def from_frames(start: int, end: int, fps: float = 25.0,
                step: int = 1) -> FrameRangeList:
    """set_fc_time analogue: build a list from raw frame indices."""
    return FrameRangeList([FrameRange(fps=fps, stf=start, etf=end,
                                      stepf=step)])


def split_chunks(total_frames: int, nchunks: int) -> List[Tuple[int, int]]:
    """Cluster-mode chunk arithmetic (``-W chunk,nchunks``; src/split.c:146).

    Returns [(start, end), ...] half-open frame ranges, one per chunk,
    covering [0, total_frames) with sizes differing by at most 1.
    """
    if nchunks <= 0:
        raise ValueError("nchunks must be positive")
    base = total_frames // nchunks
    extra = total_frames % nchunks
    out = []
    pos = 0
    for i in range(nchunks):
        size = base + (1 if i < extra else 0)
        out.append((pos, pos + size))
        pos += size
    return out
