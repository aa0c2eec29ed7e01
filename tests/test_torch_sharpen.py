"""The port's sharpening and smoothing filters against the JAX filters on
the CPU: smooth, xsharpen and msharpen.

The content is ``chip_smoke.write_motion_y4m``'s with grain (YUV420P,
and as RGB24 through the JAX colour conversion), at 64x48 and odd or
short shapes where the filter takes them.  Each case runs a batch of 1
then one of 5 (these filters carry nothing), every output compared at
tolerance 0.  smooth folds its neighbours in float32 and is held against
the jitted JAX filter, whose multiply-add XLA fuses; xsharpen is tested
on windows with ties (quantized content, and RGB pixels of equal luma
proxy but other colours), where the first extreme of the window wins.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tcforge_tpu.core.formats import ImageFormat as JImageFormat
from tcforge_tpu.core.frame import FrameBatch as JFrameBatch
from tcforge_tpu.modules.filters import msharpen as jmsharpen
from tcforge_tpu.modules.filters import smooth as jsmooth
from tcforge_tpu.modules.filters import xsharpen as jxsharpen
from tcforge_tpu_torch.core.job import Job
from tcforge_tpu_torch.io.y4m import Y4MReader
from tcforge_tpu_torch.modules.filters import msharpen, smooth, xsharpen
from test_torch_deint import jax_filter, run_pair

FRAMES = 6
SPLIT = (1, 5)


def _rgb(planes):
    from tcforge_tpu.ops import colorspace as jcs
    fb = JFrameBatch.from_numpy(*planes)
    return (np.asarray(jcs.convert(fb, JImageFormat.RGB24).rgb),)


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    """{name: planes}: the grain clip at 64x48, 38x26 and 16x4, odd
    36x25 luma-only shapes, quantized (tie-rich) content, and each as
    RGB24 frames where the shape is even."""
    tmp = tmp_path_factory.mktemp("sharpen")
    out = {}
    for w, h in ((64, 48), (38, 26), (16, 4), (37, 25), (16, 2), (9, 3)):
        path = tmp / f"g{w}x{h}.y4m"
        chip_smoke.write_motion_y4m(path, w, h, FRAMES, seed=w * h, grain=2)
        with Y4MReader(str(path)) as r:
            out[(w, h)] = r.read_batch(FRAMES)
    rng = np.random.default_rng(9)
    levels = np.array([16, 128, 235], np.uint8)
    out["ties"] = tuple(levels[rng.integers(0, 3, (FRAMES, h, w))]
                        for h, w in ((48, 64), (24, 32), (24, 32)))
    for key in ((64, 48), (38, 26), (16, 4), "ties"):
        out[("rgb", key)] = _rgb(out[key])
    # pixels of equal luma proxy (55r + 182g + 19b) >> 8 but other colours
    out[("rgb", "dark")] = (rng.integers(0, 8, (FRAMES, 24, 32, 3))
                            .astype(np.uint8),)
    return out


def _run(clips, key, port_cls, ref_cls, options):
    rgb = isinstance(key, tuple) and key[0] == "rgb"
    planes = clips[key]
    w, h = planes[0].shape[2], planes[0].shape[1]
    run_pair(port_cls(Job(), options), jax_filter(ref_cls, options),
             planes, SPLIT, w, h, rgb=rgb)


SMOOTH = [
    ((64, 48), ""), ((64, 48), "strength=0.9"), ((64, 48), "strength=0.37"),
    ((64, 48), "cdiff=255:ldiff=255:range=8"),
    ((64, 48), "cdiff=0"), ((64, 48), "range=1:strength=0.5"),
    ((38, 26), "ldiff=30:range=16"), ((16, 4), "strength=0.7:cdiff=20"),
    ("ties", "ldiff=200:cdiff=200"),
]


@pytest.mark.parametrize("key,options", SMOOTH)
def test_smooth_matches_jax(clips, key, options):
    _run(clips, key, smooth.SmoothFilter, jsmooth.SmoothFilter, options)


@pytest.mark.parametrize("n", (1, 5))
@pytest.mark.parametrize("options", ("strength=0.9:cdiff=255:ldiff=255",
                                     "strength=0.62:cdiff=255:ldiff=40"))
@pytest.mark.parametrize("seed", (0, 1))
def test_smooth_fold_on_noise_is_the_jitted_fold(options, n, seed):
    """Noise with most neighbours taken, where the two contractions of
    the fold give other bytes: the port against the jitted filter."""
    rng = np.random.default_rng(seed)
    planes = tuple(rng.integers(0, 256, (n, h, w)).astype(np.uint8)
                   for h, w in ((48, 64), (24, 32), (24, 32)))
    run_pair(smooth.SmoothFilter(Job(), options),
             jax_filter(jsmooth.SmoothFilter, options), planes, (n,), 64, 48)


XSHARPEN = [
    ((64, 48), ""), ((64, 48), "strength=255:threshold=0"),
    ((64, 48), "strength=128:threshold=30"), ((64, 48), "strength=0"),
    ((37, 25), "threshold=60"), ((16, 2), ""), ((9, 3), "strength=90"),
    ("ties", ""), ("ties", "threshold=120"),
    (("rgb", (64, 48)), ""), (("rgb", (38, 26)), "strength=255:threshold=40"),
    (("rgb", "ties"), ""), (("rgb", "dark"), ""),
    (("rgb", "dark"), "strength=100:threshold=3"),
]


@pytest.mark.parametrize("key,options", XSHARPEN)
def test_xsharpen_matches_jax(clips, key, options):
    _run(clips, key, xsharpen.XsharpenFilter, jxsharpen.XsharpenFilter,
         options)


def test_xsharpen_rgb_takes_the_first_extreme_on_ties():
    """One window of nine pixels whose luma proxies are all 0: the
    darkest and brightest are the first pixel (0, 0), and its colour
    goes to the centre."""
    rgb = np.zeros((1, 3, 3, 3), np.uint8)
    rgb[0, :, :, 0] = np.arange(9).reshape(3, 3) % 5     # luma 0 all
    got = xsharpen.xsharpen_rgb(torch.from_numpy(rgb), 255, 255).numpy()
    want = np.asarray(jxsharpen.xsharpen_rgb(jnp.asarray(rgb), 255, 255))
    np.testing.assert_array_equal(got, want)
    assert got[0, 1, 1, 0] == rgb[0, 0, 0, 0] == 0


MSHARPEN = [
    ((64, 48), ""), ((64, 48), "highq=0"),
    ((64, 48), "strength=255:threshold=0"), ((64, 48), "threshold=40"),
    ((38, 26), "strength=30:threshold=5"), ((16, 4), ""),
    (("rgb", (64, 48)), ""), (("rgb", (38, 26)), "highq=0:threshold=25"),
    (("rgb", (16, 4)), "strength=200"), (("rgb", "dark"), "threshold=1"),
]


@pytest.mark.parametrize("key,options", MSHARPEN)
def test_msharpen_matches_jax(clips, key, options):
    _run(clips, key, msharpen.MsharpenFilter, jmsharpen.MsharpenFilter,
         options)


@pytest.mark.parametrize("highq", (False, True))
def test_msharpen_mask_matches_jax(clips, highq):
    """The detail mask on RGB (the anti-diagonal's doubled channel test
    and the zeroed last row and column included)."""
    rgb = clips[("rgb", (38, 26))][0][:2]
    got = msharpen.msharpen_rgb(torch.from_numpy(rgb), 100, 12, True, highq)
    want = jmsharpen.msharpen_rgb(jnp.asarray(rgb), 100, 12, True, highq)
    want = np.broadcast_to(np.asarray(want), rgb.shape)
    np.testing.assert_array_equal(got.numpy(), want)


def test_msharpen_anti_diagonal_ignores_channel_2():
    """A step in channel 2 alone along the anti-diagonal is no edge
    (the reference tests g2-g3 twice); the same step in channel 0 is."""
    for chan, edge in ((2, False), (0, True)):
        rgb = np.full((1, 8, 8, 3), 0, np.uint8)
        for y in range(8):
            for x in range(8):
                if x - y >= 1:           # a step along the main diagonal
                    rgb[0, y, x, chan] = 250
        got = msharpen.msharpen_rgb(torch.from_numpy(rgb), 100, 50, True,
                                    False).numpy()
        want = np.broadcast_to(np.asarray(jmsharpen.msharpen_rgb(
            jnp.asarray(rgb), 100, 50, True, False)), rgb.shape)
        np.testing.assert_array_equal(got, want)
        assert bool(got[0, 2:6, 2:6, 0].any()) == edge     # off the border
