"""``ops/video.py`` of the torch port against the JAX module on the CPU:
clip, the fast block resize, reduce, the flips, gamma, antialias and the
RGB grayscale, each on an even and an odd plane and in the RGB form the
chain gives it (channel-first for the plane ops), with the host tables
compared entry by entry.  Tolerance 0: integer math."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tcforge_tpu.ops import aclib as jaclib
from tcforge_tpu.ops import video as jv
from tcforge_tpu_torch.ops import aclib as taclib
from tcforge_tpu_torch.ops import video as tv

# (N, H, W) even, (N, H, W) odd, (N, C, H, W): an RGB batch channel-first
SHAPES = {"even": (2, 16, 24), "odd": (2, 17, 23), "rgb": (2, 3, 16, 24)}


def _img(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _same(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert got.dtype == torch.uint8 and got.is_contiguous()
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.fixture(params=sorted(SHAPES))
def img(request):
    return _img(SHAPES[request.param], len(request.param))


@pytest.mark.parametrize("clip", [(2, 4, 6, 2), (-2, -4, -6, -8),
                                  (3, -1, -5, 7), (0, 0, 0, 0)])
@pytest.mark.parametrize("black", [0, 128])
def test_clip(img, clip, black):
    _same(tv.clip(torch.from_numpy(img), *clip, black),
          jv.clip(jnp.asarray(img), *clip, black))


def test_clip_rgb_channel_last():
    rgb = _img((2, 12, 14, 3), 3)
    _same(tv.clip_rgb(torch.from_numpy(rgb), 1, -2, -3, 4, 0),
          jv.clip_rgb(jnp.asarray(rgb), 1, -2, -3, 4, 0))


def test_clip_refuses_what_jax_refuses():
    x = _img((1, 8, 8), 0)
    for fn, arr in ((jv.clip, jnp.asarray(x)), (tv.clip, torch.from_numpy(x))):
        with pytest.raises(ValueError):
            fn(arr, 4, 0, 4, 0)


@pytest.mark.parametrize("rw,rh,sw,sh", [
    (1, 0, 8, 8), (0, -1, 8, 8), (-1, 1, 8, 8), (2, 2, 8, 8), (-2, -1, 8, 8),
    (1, -1, 4, 4), (-1, 1, 4, 8), (3, 0, 2, 8)])
@pytest.mark.parametrize("kind", ["even", "rgb"])
def test_resize_fast(kind, rw, rh, sw, sh):
    x = _img(SHAPES[kind], 50 + rw * 7 + rh)
    _same(tv.resize_fast(torch.from_numpy(x), rw, rh, sw, sh),
          jv.resize_fast(jnp.asarray(x), rw, rh, sw, sh))


@pytest.mark.parametrize("old,new", [(128, 136), (128, 120), (64, 96),
                                     (96, 64), (192, 64)])
def test_resize_table_is_the_jax_table(old, new):
    for got, want in zip(tv._resize_table(old, new),
                         jv._resize_table(old, new)):
        np.testing.assert_array_equal(got, want)


def test_rescale_arrays():
    a, b = _img((4, 9), 1), _img((4, 9), 2)
    w1 = np.array([0, 1, 32768, 40000, 65535, 65536, 65536, 12, 65000],
                  dtype=np.int32)
    w2 = (65536 - w1).astype(np.int32)
    _same(taclib.rescale_arrays(torch.from_numpy(a), torch.from_numpy(b),
                                torch.from_numpy(w1), torch.from_numpy(w2)),
          jaclib.rescale_arrays(jnp.asarray(a), jnp.asarray(b),
                                jnp.asarray(w1), jnp.asarray(w2)))


@pytest.mark.parametrize("rw,rh", [(1, 1), (2, 1), (1, 3), (4, 5)])
def test_reduce(img, rw, rh):
    _same(tv.reduce(torch.from_numpy(img), rw, rh),
          jv.reduce(jnp.asarray(img), rw, rh))


@pytest.mark.parametrize("name", ["flip_v", "flip_h"])
def test_flips(img, name):
    _same(getattr(tv, name)(torch.from_numpy(img)),
          getattr(jv, name)(jnp.asarray(img)))


@pytest.mark.parametrize("name", ["flip_v_rgb", "flip_h_rgb"])
@pytest.mark.parametrize("channels", [3, 4])
def test_flips_rgb_channel_last(name, channels):
    rgb = _img((2, 7, 10, channels), channels)
    _same(getattr(tv, name)(torch.from_numpy(rgb)),
          getattr(jv, name)(jnp.asarray(rgb)))


@pytest.mark.parametrize("gamma", [0.45, 0.8, 1.7, 2.2])
def test_gamma(img, gamma):
    np.testing.assert_array_equal(tv._gamma_table(gamma),
                                  jv._gamma_table(gamma))
    _same(tv.gamma_correct(torch.from_numpy(img), gamma),
          jv.gamma_correct(jnp.asarray(img), gamma))


def test_gamma_refuses_non_positive():
    with pytest.raises(ValueError):
        tv.gamma_correct(torch.zeros((1, 2, 2), dtype=torch.uint8), 0.0)


def _edges(shape, seed):
    """Flat regions with diagonal edges and some noise: what the
    antialias predicates look for."""
    rng = np.random.default_rng(seed)
    yy, xx = np.indices(shape[-2:])
    base = np.where((xx + yy) % 9 < 4, 40, 200) + np.where(xx > yy, 30, 0)
    out = base[None] + rng.integers(-12, 13, shape)
    return np.clip(out, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("weight,bias", [(1 / 3, 0.5), (0.5, 0.2), (0, 1),
                                         (1, 0)])
def test_antialias(weight, bias):
    for kind, shape in SHAPES.items():
        for x in (_edges(shape, 5), _img(shape, 6)):
            got = tv.antialias(torch.from_numpy(x), weight, bias)
            _same(got, jv.antialias(jnp.asarray(x), weight, bias))
    assert (tv.antialias(torch.from_numpy(_edges((1, 16, 24), 5)), weight,
                         bias).numpy() != _edges((1, 16, 24), 5)).any() \
        or weight == 1


@pytest.mark.parametrize("shape", [(1, 2, 9), (1, 9, 2), (1, 1, 1),
                                   (1, 3, 3)])
def test_antialias_small_planes(shape):
    x = _img(shape, 9)
    _same(tv.antialias(torch.from_numpy(x)), jv.antialias(jnp.asarray(x)))


def test_antialias_tables_are_the_jax_tables():
    for got, want in zip(tv._aa_tables(1 / 3, 0.5), jv._aa_luts(1 / 3, 0.5)):
        np.testing.assert_array_equal(got, np.asarray(want))


def test_antialias_refuses_bad_weights():
    with pytest.raises(ValueError):
        tv.antialias(torch.zeros((1, 4, 4), dtype=torch.uint8), 1.5, 0.5)


@pytest.mark.parametrize("channels", [3, 4])
def test_decolor_rgb(channels):
    rgb = _img((2, 6, 8, channels), channels)
    _same(tv.decolor_rgb(torch.from_numpy(rgb)),
          jv.decolor_rgb(jnp.asarray(rgb)))
