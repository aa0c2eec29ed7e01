"""unsharp in the torch port (plain version on the CPU) against the JAX
filter: ``unsharp_plane`` (the u32 shift-add cascade), the Pallas kernel
in interpret mode, the sizes where the JAX function raises, and the
option cascade.  Tolerance 0: integer math."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tcforge_tpu.core.frame import FrameBatch as JFrameBatch
from tcforge_tpu.core.job import Job as JJob
from tcforge_tpu.modules.filters import unsharp as jun
from tcforge_tpu.ops.kernels import unsharp_plane_pallas
from tcforge_tpu_torch.core.formats import ImageFormat
from tcforge_tpu_torch.core.frame import FrameBatch
from tcforge_tpu_torch.core.job import Job
from tcforge_tpu_torch.modules.filters import unsharp as tun
from tcforge_tpu_torch.ops import kernels

CPU = torch.device("cpu")

# tests/test_filters2.py:842-846, plus 17x15 (the u32 sums wrap) and
# 17x17 (scalebits 32: the blur shifts out to 0)
CASES = [(72, 130, 7, 5, 0.8), (64, 128, 3, 3, -1.5),
         (100, 257, 15, 1, 0.3), (37, 64, 1, 15, 2.0),
         (128, 200, 13, 17, 0.5), (40, 70, 17, 15, -1.5),
         (33, 41, 17, 17, 0.8)]


def _img(h, w, seed, n=3):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (n, h, w), dtype=np.uint8)


def _port(img, mx, my, am):
    return kernels.unsharp_plane(torch.from_numpy(img), mx // 2, my // 2,
                                 am).numpy()


@pytest.mark.parametrize("h,w,mx,my,am", CASES)
def test_plain_matches_jax_unsharp_plane(h, w, mx, my, am):
    img = _img(h, w, h + w)
    want = np.asarray(jun.unsharp_plane(jnp.asarray(img), mx, my, am))
    np.testing.assert_array_equal(_port(img, mx, my, am), want)


@pytest.mark.parametrize("h,w,mx,my,am",
                         [c for c in CASES if c[3] // 2 <= 8])
def test_plain_matches_pallas_interpret(h, w, mx, my, am):
    img = _img(h, w, 7 * h + w)
    want = np.asarray(unsharp_plane_pallas(jnp.asarray(img), mx // 2,
                                           my // 2, am, interpret=True))
    np.testing.assert_array_equal(_port(img, mx, my, am), want)


@pytest.mark.parametrize("sx,sy", [(sx, sy) for sx in range(4)
                                   for sy in range(4) if sx + sy])
def test_register_kernel_sizes_match_jax(sx, sy):
    """The fifteen matrices up to 7x7 (the card's register kernel has one
    instance for each); ``tiled`` picks the card's other kernel and
    changes nothing in the result."""
    mx, my = 2 * sx + 1, 2 * sy + 1
    img = _img(19, 44, 10 * sx + sy, n=2)
    am = 0.8 if (sx + sy) % 2 else -1.5
    want = np.asarray(jun.unsharp_plane(jnp.asarray(img), mx, my, am))
    np.testing.assert_array_equal(_port(img, mx, my, am), want)
    tiled = kernels.unsharp_plane(torch.from_numpy(img), sx, sy, am,
                                  tiled=True)
    np.testing.assert_array_equal(tiled.numpy(), want)


def test_wrap_case_really_wraps():
    """At 17x15 the un-normalised sum of a white plane exceeds 2^32."""
    assert 255 * (1 << (2 * (8 + 7))) > 1 << 32
    img = np.full((1, 20, 30), 255, np.uint8)
    want = np.asarray(jun.unsharp_plane(jnp.asarray(img), 17, 15, -1.0))
    np.testing.assert_array_equal(_port(img, 17, 15, -1.0), want)
    assert (want != 255).any()


@pytest.mark.parametrize("mx,my", [(19, 17), (17, 19), (31, 31), (63, 3),
                                   (63, 63)])
def test_raises_where_jax_raises(mx, my):
    """scalebits = 2 * (sx + sy) >= 34: halfscale leaves uint32."""
    img = _img(9, 11, 0)
    with pytest.raises(OverflowError):
        jun.unsharp_plane(jnp.asarray(img), mx, my, 0.5)
    with pytest.raises(OverflowError):
        _port(img, mx, my, 0.5)


@pytest.mark.parametrize("mx,my", [(17, 17), (19, 15), (33, 1), (3, 31)])
def test_runs_at_the_edge(mx, my):
    """sx + sy == 16 is the largest sum the JAX function runs."""
    img = _img(21, 35, mx * my)
    want = np.asarray(jun.unsharp_plane(jnp.asarray(img), mx, my, -0.7))
    np.testing.assert_array_equal(_port(img, mx, my, -0.7), want)


def test_one_by_one_raises_like_jax():
    img = _img(5, 6, 1)
    with pytest.raises(ValueError):
        jun.unsharp_plane(jnp.asarray(img), 1, 1, 0.5)
    with pytest.raises(ValueError):
        _port(img, 1, 1, 0.5)


def test_zero_amount_returns_the_plane_without_a_launch():
    img = torch.from_numpy(_img(8, 8, 2))
    kernels.reset_launches()
    assert tun.unsharp_plane(img, 7, 5, 0.0) is img
    assert kernels.launches["unsharp"] == 0


@pytest.mark.parametrize("options", [
    "", "luma=0.8:luma_matrix=7x5", "amount=1.2:matrix=9x3",
    "amount=0.5", "matrix=5x5", "luma=-1:luma_matrix=2x100",
    "chroma=0.4:chroma_matrix=11x13", "amount=-2:matrix=64x1",
    "luma=0.3:chroma=-0.6", "pre=1", "luma=2:luma_matrix=17x15:pre=1"])
def test_option_cascade(options):
    port = tun.UnsharpFilter(Job(), options)
    ref = jun.UnsharpFilter(JJob(), options)
    assert port.luma == ref.luma
    assert port.chroma == ref.chroma
    assert port.slots == ref.slots


@pytest.mark.parametrize("options", ["luma=0.8:luma_matrix=7x5",
                                     "amount=-0.9:matrix=5x9",
                                     "luma=0.5:chroma=1.1"])
def test_filter_apply_matches_jax(options):
    rng = np.random.default_rng(len(options))
    y = rng.integers(0, 256, (2, 18, 26), dtype=np.uint8)
    u = rng.integers(0, 256, (2, 9, 13), dtype=np.uint8)
    v = rng.integers(0, 256, (2, 9, 13), dtype=np.uint8)
    pout, pstate = tun.UnsharpFilter(Job(), options).apply(
        FrameBatch.from_numpy(y, u, v, device=CPU), None)
    jout, _ = jun.UnsharpFilter(JJob(), options).apply(
        JFrameBatch.from_numpy(y, u, v), None)
    assert pstate is None
    for got, want in zip(pout.to_numpy(), jout.planes):
        np.testing.assert_array_equal(got, np.asarray(want))


def test_filter_rejects_non_420():
    fb = FrameBatch.from_numpy(np.zeros((1, 4, 4), np.uint8),
                               np.zeros((1, 4, 2), np.uint8),
                               np.zeros((1, 4, 2), np.uint8), device=CPU,
                               fmt=ImageFormat.YUV422P)
    with pytest.raises(ValueError, match="YUV420P"):
        tun.UnsharpFilter(Job(), "luma=1").apply(fb, None)


def test_wrapper_checks():
    x = torch.zeros((2, 4, 5), dtype=torch.uint8)
    with pytest.raises(ValueError, match="dtype"):
        kernels.unsharp_plane(x.int(), 1, 1, 0.5)
    with pytest.raises(ValueError, match="3-D"):
        kernels.unsharp_plane(x[0], 1, 1, 0.5)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.unsharp_plane(x.transpose(1, 2), 1, 1, 0.5)
    with pytest.raises(ValueError, match="steps"):
        kernels.unsharp_plane(x, -1, 2, 0.5)
