"""Byte-wise blend primitives (``tcforge_tpu/ops/aclib.py``)."""

from __future__ import annotations

import torch


def average(src1: torch.Tensor, src2: torch.Tensor) -> torch.Tensor:
    """Rounded byte-wise average ``(a + b + 1) >> 1`` (aclib/average.c:33-39).

    Inputs are uint8; int16 holds the sum exactly.  The output has the
    dtype of ``src1``."""
    a = src1.to(torch.int16)
    b = src2.to(torch.int16)
    return ((a + b + 1) >> 1).to(src1.dtype)
