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


def rescale_arrays(src1: torch.Tensor, src2: torch.Tensor,
                   weight1: torch.Tensor,
                   weight2: torch.Tensor) -> torch.Tensor:
    """16.16 weighted blend ``(a*w1 + b*w2 + 32768) >> 16`` with
    per-element (broadcastable) int32 weights, for the fast block resize;
    ``weight1 >= 0x10000`` selects ``src1`` verbatim (rescale_pixel,
    libtcvideo/tcvideo.c:525-540)."""
    a = src1.to(torch.int32)
    b = src2.to(torch.int32)
    blended = (a * weight1 + b * weight2 + 32768) >> 16
    return torch.where(weight1 >= 0x10000, a, blended).to(src1.dtype)
