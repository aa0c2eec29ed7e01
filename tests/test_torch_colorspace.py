"""``ops/colorspace.py`` of the torch port against the JAX module on the
CPU: ``convert`` over every (src, dst) pair of the formats both hold,
the pixel formulas over their whole input range, the metadata that a
conversion keeps, and the sizes the port refuses.  Tolerance 0: integer
math."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tcforge_tpu.core.formats import ImageFormat as JImageFormat
from tcforge_tpu.core.frame import FrameBatch as JFrameBatch
from tcforge_tpu.ops import colorspace as jcs
from tcforge_tpu_torch.core.formats import ImageFormat
from tcforge_tpu_torch.core.frame import FrameBatch
from tcforge_tpu_torch.ops import colorspace as tcs

CPU = torch.device("cpu")
N, H, W = 2, 8, 16

FORMATS = ["yuv420p", "yv12", "yuv411p", "yuv422p", "yuv444p", "yuy2",
           "uyvy", "yvyu", "y8", "rgb24", "bgr24", "rgba32", "argb32",
           "gray8"]


def _planes(fmt: ImageFormat, seed: int, n=N, h=H, w=W):
    """Seeded numpy planes in ``fmt``'s representation: (y, u, v, rgb)."""
    rng = np.random.default_rng(seed)

    def u8(*shape):
        return rng.integers(0, 256, shape, dtype=np.uint8)

    if fmt.is_rgb and fmt != ImageFormat.GRAY8:
        return None, None, None, u8(n, h, w, fmt.channels)
    if fmt in (ImageFormat.Y8, ImageFormat.GRAY8):
        return u8(n, h, w), None, None, None
    uh, uw = fmt.uv_plane_shape(w, h)
    return u8(n, h, w), u8(n, uh, uw), u8(n, uh, uw), None


def _batches(name: str, seed: int, **size):
    fmt = ImageFormat(name)
    y, u, v, rgb = _planes(fmt, seed, **size)
    port = FrameBatch.from_numpy(y, u, v, rgb=rgb, device=CPU, fmt=fmt,
                                 fps=29.97, first_id=5)
    ref = JFrameBatch.from_numpy(y, u, v, rgb=rgb, fmt=JImageFormat(name),
                                 fps=29.97, first_id=5)
    return port, ref


def _assert_same(port: FrameBatch, ref: JFrameBatch):
    assert port.format.value == ref.format.value
    for key in ("y", "u", "v", "rgb"):
        got, want = getattr(port, key), getattr(ref, key)
        assert (got is None) == (want is None), key
        if got is not None:
            assert got.dtype == torch.uint8 and got.is_contiguous(), key
            np.testing.assert_array_equal(got.numpy(), np.asarray(want), key)


@pytest.mark.parametrize("dst", FORMATS)
@pytest.mark.parametrize("src", FORMATS)
def test_convert_matches_jax(src, dst):
    port, ref = _batches(src, len(src) * 31 + len(dst))
    try:
        want = jcs.convert(ref, JImageFormat(dst))
    except ValueError:
        with pytest.raises(ValueError):
            tcs.convert(port, ImageFormat(dst))
        return
    _assert_same(tcs.convert(port, ImageFormat(dst)), want)


@pytest.mark.parametrize("dst", ["yuv420p", "yuv422p", "rgb24", "y8"])
def test_convert_keeps_the_metadata(dst):
    port, _ = _batches("yuv444p", 3)
    out = tcs.convert(port, ImageFormat(dst))
    assert out.fps == 29.97
    assert out.frame_ids.tolist() == [5, 6] and out.attrs.tolist() == [0, 0]


def test_cfg1_round_trip_matches_jax():
    """420P -> RGB24 -> 420P, the conversion pair of cfg1."""
    port, ref = _batches("yuv420p", 11, n=3, h=24, w=32)
    want = jcs.convert(jcs.convert(ref, JImageFormat.RGB24),
                       JImageFormat.YUV420P)
    got = tcs.convert(tcs.convert(port, ImageFormat.RGB24),
                      ImageFormat.YUV420P)
    _assert_same(got, want)


def test_yuv_to_rgb_formula_over_its_range():
    """Every Y with a grid of U and V: the clamps on both sides."""
    y, u, v = np.meshgrid(np.arange(256), np.arange(0, 256, 5),
                          np.arange(0, 256, 5), indexing="ij")
    y, u, v = (a.astype(np.uint8) for a in (y, u, v))
    want = np.asarray(jcs.yuv_to_rgb_pixels(*map(jnp.asarray, (y, u, v))))
    got = tcs.yuv_to_rgb_pixels(*map(torch.from_numpy, (y, u, v)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.min() == 0 and want.max() == 255


def test_rgb_to_yuv_and_gray_formulas_over_a_grid():
    axis = np.arange(0, 256, 3)
    rgb = np.stack(np.meshgrid(axis, axis, axis, indexing="ij"),
                   axis=-1).astype(np.uint8)
    want = jcs.rgb_to_yuv_pixels(jnp.asarray(rgb))
    got = tcs.rgb_to_yuv_pixels(torch.from_numpy(rgb))
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(
        tcs.rgb_to_gray_pixels(torch.from_numpy(rgb)).numpy(),
        np.asarray(jcs.rgb_to_gray_pixels(jnp.asarray(rgb))))


def test_gray_swing_formulas_over_all_bytes():
    """``// 219`` and ``// 255`` floor, also below 16 where the numerator
    is negative before the clamp."""
    b = np.arange(256, dtype=np.uint8)
    np.testing.assert_array_equal(tcs.y_to_gray(torch.from_numpy(b)).numpy(),
                                  np.asarray(jcs.y_to_gray(jnp.asarray(b))))
    np.testing.assert_array_equal(tcs.gray_to_y(torch.from_numpy(b)).numpy(),
                                  np.asarray(jcs.gray_to_y(jnp.asarray(b))))


@pytest.mark.parametrize("dst,h,w", [("yuv420p", 7, 16), ("yuv420p", 8, 15),
                                     ("yuv422p", 8, 15), ("yuv411p", 8, 18)])
def test_rgb_to_yuv_refuses_sizes_whose_chroma_planes_differ(dst, h, w):
    """U and V are picked at different sites (420P: even/even and
    odd/odd), so an odd size would give planes of unlike shape."""
    port, _ = _batches("rgb24", 1, h=h, w=w)
    with pytest.raises(ValueError, match="gives U"):
        tcs.convert(port, ImageFormat(dst))


def test_unknown_pair_raises():
    port, _ = _batches("yuv420p", 1)
    with pytest.raises(ValueError):
        tcs.convert(port, ImageFormat.UNKNOWN)
