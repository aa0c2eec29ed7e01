"""The port's zoom (band-table pass) and deinterlacers against the JAX
package: ``contrib_matrix``, the golden ``_apply_pass_exact``, the
Pallas ``zoom_pass_pallas`` in interpret mode, interlaced zoom and the
``-I`` modes at odd and even heights.  Tolerance 0."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tcforge_tpu.core.frame import FrameBatch as JFrameBatch
from tcforge_tpu.core.job import Job as JJob
from tcforge_tpu.ops import video as jvideo
from tcforge_tpu.ops import zoom as jzoom
from tcforge_tpu.pipeline.chain import apply_video_trans as japply
from tcforge_tpu_torch.core.frame import FrameBatch
from tcforge_tpu_torch.core.job import Job
from tcforge_tpu_torch.ops import kernels, video, zoom
from tcforge_tpu_torch.pipeline.chain import apply_video_trans

FILTERS = ["lanczos3", "mitchell", "box"]
SIZES = [(333, 150), (40, 97), (1920, 1280), (1080, 720)]


def rand_u8(*shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, shape,
                                                dtype=np.uint8)


@pytest.mark.parametrize("filt,old,new", [
    (f, o, n) for f in FILTERS + ["bell", "sinc8", "gaussian"]
    for o, n in SIZES] + [(f, o, n) for f in FILTERS
                          for o, n in ((7, 7), (5, 64))])
def test_contrib_matrix_and_band_table(filt, old, new):
    want = jzoom.contrib_matrix(old, new, filt)
    np.testing.assert_array_equal(zoom.contrib_matrix(old, new, filt), want)
    first, taps, weights = zoom.band_table(old, new, filt)
    dense = np.zeros_like(want)
    for i in range(new):
        dense[i, first[i]:first[i] + taps[i]] = weights[i, :taps[i]]
        assert not weights[i, taps[i]:].any()
    np.testing.assert_array_equal(dense, want)


def test_band_widths_at_main_path_sizes():
    """Lanczos3 at the main path's 1.5x downscale: 8-9 taps inside the
    plane, 5-7 in the five rows at the reflected edges."""
    for old, new in ((1920, 1280), (1080, 720), (960, 640), (540, 360)):
        _, taps, _ = zoom.band_table(old, new, "lanczos3")
        assert taps.max() == 9 and taps.min() == 5
        assert (taps >= 8).sum() == new - 5


@pytest.mark.parametrize("filt", FILTERS)
@pytest.mark.parametrize("axis", [-1, -2])
@pytest.mark.parametrize("old,new", [(61, 23), (23, 61), (40, 40)])
def test_plain_pass_matches_apply_pass_exact(filt, axis, old, new):
    shape = (2, 13, old) if axis == -1 else (2, old, 13)
    img = rand_u8(*shape, seed=old * new)
    band = zoom._device_band(old, new, filt, "cpu")
    got = kernels.zoom_pass(torch.from_numpy(img), band, axis).numpy()
    want = np.asarray(jzoom._apply_pass_exact(
        jnp.asarray(img), jzoom.contrib_matrix(old, new, filt), axis))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("filt", ["lanczos3", "mitchell"])
@pytest.mark.parametrize("axis", [-1, -2])
def test_plain_pass_matches_pallas_interpret(filt, axis):
    """zoom_pass_pallas fed as tests/test_ops.py feeds it (bf16 byte
    planes); the vertical pass goes through the transposed layout, as
    ops/zoom.py drives it."""
    from tcforge_tpu.ops.kernels import zoom_pass_pallas
    old, new = (333, 150) if axis == -1 else (90, 131)
    shape = (2, 40, old) if axis == -1 else (2, old, 37)
    img = rand_u8(*shape, seed=4)
    wf = jzoom.contrib_matrix(old, new, filt)
    planes = [jnp.asarray(p.T.astype(np.float32), jnp.bfloat16)
              for p in (wf >> 16, (wf >> 8) & 255, wf & 255)]
    src = jnp.asarray(img if axis == -1 else np.swapaxes(img, -1, -2))
    flat = zoom_pass_pallas(src.reshape(-1, old), *planes, interpret=True)
    want = np.asarray(flat).reshape(src.shape[:-1] + (new,))
    if axis == -2:
        want = np.swapaxes(want, -1, -2)
    band = zoom._device_band(old, new, filt, "cpu")
    got = kernels.zoom_pass(torch.from_numpy(img), band, axis).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("interlaced", [False, True])
@pytest.mark.parametrize("new_w,new_h", [(44, 26), (97, 60)])
def test_zoom_plane(interlaced, new_w, new_h):
    """Both passes; interlaced: each field on its own."""
    img = rand_u8(3, 34, 70, seed=new_w)
    got = zoom.zoom_plane(torch.from_numpy(img), new_w, new_h,
                          interlaced=interlaced).numpy()
    want = np.asarray(jzoom.zoom_plane(jnp.asarray(img), new_w, new_h,
                                       interlaced=interlaced, exact=True))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("height", [2, 3, 4, 5, 8, 11])
@pytest.mark.parametrize("name", ["deint_interpolate", "deint_linear_blend",
                                  "deint_drop_field"])
def test_deinterlacers(name, height):
    img = rand_u8(2, height, 9, seed=height)
    got = getattr(video, name)(torch.from_numpy(img)).numpy()
    want = np.asarray(getattr(jvideo, name)(jnp.asarray(img)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", [1, 3, 4, 5])
@pytest.mark.parametrize("height,zoom_interlaced",
                         [(20, False), (22, False), (20, True)])
def test_apply_video_trans(mode, height, zoom_interlaced):
    """-I modes 1/3/4/5 followed by a -Z zoom, through the chain's
    transform stage, at even and odd half heights."""
    y = rand_u8(2, height, 32, seed=mode)
    u = rand_u8(2, height // 2, 16, seed=mode + 1)
    v = rand_u8(2, height // 2, 16, seed=mode + 2)
    kw = dict(deinterlace=mode, zoom_width=24, zoom_height=16,
              zoom_interlaced=zoom_interlaced)
    fb = FrameBatch.from_numpy(y, u, v, device=torch.device("cpu"))
    got = apply_video_trans(Job(**kw), fb)
    want = japply(JJob(**kw), JFrameBatch.from_numpy(y, u, v))
    for g, w in zip(got.to_numpy(), want.planes):
        np.testing.assert_array_equal(g, np.asarray(w))


def test_interlaced_zoom_needs_even_heights():
    img = torch.zeros((1, 11, 16), dtype=torch.uint8)
    with pytest.raises(ValueError, match="even heights"):
        zoom.zoom_plane(img, 8, 6, interlaced=True)
    with pytest.raises(ValueError, match="even heights"):
        jzoom.zoom_plane(jnp.asarray(img.numpy()), 8, 6, interlaced=True)
