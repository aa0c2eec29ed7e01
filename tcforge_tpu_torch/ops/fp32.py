"""float32 arithmetic in the forms that XLA's CPU code computes.

The JAX filters run under ``jax.jit``.  XLA compiles ``x / c`` for a
constant ``c`` into ``x * (1 / c)`` (``recip32``), and its CPU code
generator contracts a product and a sum into one fused multiply-add
where the compiled program lets it (``fma32``).  The port's plain
versions compute those forms where the JAX package's output depends on
them.
"""

from __future__ import annotations

import math

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
    # no read-back of ``nudge``: a step on the card never waits for it;
    # the step toward the exact value is one float64 ulp (``s + err``
    # would round back to ``s``)
    toward = torch.where(err > 0, math.inf, -math.inf)
    s = torch.where(nudge, torch.nextafter(s, toward), s)
    return s.float()


def sqrt32(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root, as XLA's CPU code
    computes it (torch's CPU ``sqrt`` of float32 is not always correctly
    rounded; through float64 it is, on any device)."""
    return torch.sqrt(x.double()).float()


def ordered_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis, one element after the other."""
    total = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    for i in range(x.shape[-1]):
        total = total + x[..., i]
    return total


def tree_sum(x: torch.Tensor, ndims: int, window: int = 32) -> torch.Tensor:
    """The float32 sum over the last ``ndims`` axes in the order of XLA's
    CPU reduction (its tree reduction rewriter, then its loops): while a
    reduced axis is longer than ``window``, every such axis is padded to
    a multiple of ``window`` (half the padding in front) and cut into
    windows, the shorter reduced axes taken whole, and each window is
    summed in row-major order; the window sums are reduced again the
    same way, and the last level, no axis longer than ``window``, is
    summed in row-major order.  A window of more than one row of more
    than one element, on a level that needed no padding, is summed as
    the vectorized loop sums it (``_lane_sum``).  Every step is an
    elementwise add: the same bits on any device."""
    nlead = x.dim() - ndims
    lead, dims = x.shape[:nlead], x.shape[nlead:]
    if all(d <= window for d in dims):
        return ordered_sum(x.reshape(*lead, -1))
    pads, split = [], []
    for d in dims:
        p = -d % window if d > window else 0
        pads.append((p // 2, p - p // 2))
        w = window if d > window else d
        split += [(d + p) // w, w]
    x = torch.nn.functional.pad(x, [v for pair in reversed(pads)
                                     for v in pair])
    x = x.reshape(*lead, *split)
    perm = (list(range(nlead))
            + [nlead + 2 * k for k in range(ndims)]
            + [nlead + 2 * k + 1 for k in range(ndims)])
    rows, inner = split[1], math.prod(split[3::2])
    x = x.permute(perm).reshape(*lead, *split[0::2], rows, inner)
    if not any(p for pair in pads for p in pair) and rows > 1 and inner > 1:
        sums = _lane_sum(x)
    else:
        sums = ordered_sum(x.flatten(-2))
    return tree_sum(sums, ndims, window)


_LANES = 8      # float32 lanes of XLA's vectorized window loop


def _lane_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last two axes (rows, elements) as XLA's CPU code sums
    an unpadded window of several rows: row r goes to lane r % 8, each
    lane adds its rows' elements in order, then the lanes are halved in
    turn (lane i + lane i+4, ...)."""
    rows, inner = x.shape[-2:]
    x = x.reshape(*x.shape[:-2], rows // _LANES, _LANES, inner)
    acc = torch.zeros(x.shape[:-3] + (_LANES,), dtype=x.dtype,
                      device=x.device)
    for q in range(x.shape[-3]):
        for t in range(inner):
            acc = acc + x[..., q, :, t]
    while acc.shape[-1] > 1:
        half = acc.shape[-1] // 2
        acc = acc[..., :half] + acc[..., half:]
    return acc[..., 0]
