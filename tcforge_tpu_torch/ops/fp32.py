"""float32 arithmetic in the forms that XLA's CPU code computes.

The JAX filters run under ``jax.jit``.  XLA compiles ``x / c`` for a
constant ``c`` into ``x * (1 / c)`` (``recip32``), and its CPU code
generator contracts a product and a sum into one fused multiply-add
where the compiled program lets it (``fma32``).  The port's plain
versions compute those forms where the JAX package's output depends on
them.
"""

from __future__ import annotations

import numpy as np
import torch


def recip32(d: float) -> float:
    """The float32 reciprocal of ``d``, as a Python float."""
    return float(np.float32(1) / np.float32(d))


def fma32(a, b, c) -> torch.Tensor:
    """float32 ``a*b + c`` with one rounding, as a fused multiply-add
    gives it.  The product of two float32 values is exact in float64 and
    the float64 sum's error is found exactly (TwoSum); a sum that lies
    on a float32 rounding midpoint is moved off it toward the exact value
    before the one rounding to float32."""
    a, b, c = (torch.as_tensor(t, dtype=torch.float32).double()
               for t in (a, b, c))
    p = a * b
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    mid = (s.view(torch.int64) & 0x1FFFFFFF) == 0x10000000
    nudge = mid & (err != 0)
    if bool(nudge.any()):
        s = torch.where(nudge, torch.nextafter(s, s + err), s)
    return s.float()
