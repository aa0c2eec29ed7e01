"""hqdn3d in the torch port (plain versions on the CPU) against the JAX
filter: the LUT scans, the Pallas kernels in interpret mode, the carry
across batches and the option cascade.  Tolerance 0: integer math."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tcforge_tpu.core.frame import FrameBatch as JFrameBatch
from tcforge_tpu.core.job import Job as JJob
from tcforge_tpu.modules.filters import hqdn3d as jhq
from tcforge_tpu_torch.core.frame import FrameBatch
from tcforge_tpu_torch.core.formats import ImageFormat
from tcforge_tpu_torch.core.job import Job
from tcforge_tpu_torch.modules.filters import hqdn3d as thq
from tcforge_tpu_torch.ops import kernels

CPU = torch.device("cpu")


def rand_u8(rng, *shape):
    return rng.integers(0, 256, shape, dtype=np.uint8)


def port_denoise(frames, ant, s, t):
    out, new_ant = thq.denoise_plane(
        torch.from_numpy(frames), torch.from_numpy(np.asarray(ant)),
        torch.from_numpy(thq.precalc_coefs(s)),
        torch.from_numpy(thq.precalc_coefs(t)))
    return out.numpy(), new_ant.numpy()


def jax_denoise(frames, ant, s, t):
    out, new_ant = jhq.denoise_plane(
        jnp.asarray(frames), jnp.asarray(ant),
        jnp.asarray(jhq.precalc_coefs(s)), jnp.asarray(jhq.precalc_coefs(t)))
    return np.asarray(out), np.asarray(new_ant)


@pytest.mark.parametrize("dist25", [0.5, 3.0, 4.0, 4.5, 6.0, 13.7, 100.0])
def test_precalc_coefs(dist25):
    np.testing.assert_array_equal(thq.precalc_coefs(dist25),
                                  jhq.precalc_coefs(dist25))


@pytest.mark.parametrize("shape", [(3, 17, 23), (2, 8, 9), (1, 5, 31)])
@pytest.mark.parametrize("s,t", [(4.0, 6.0), (3.0, 4.5)])
def test_plain_scans_match_jax_lut(shape, s, t):
    rng = np.random.default_rng(sum(shape))
    frames = rand_u8(rng, *shape)
    ant = frames[0].astype(np.int32) << 8
    got, got_ant = port_denoise(frames, ant, s, t)
    want, want_ant = jax_denoise(frames, ant, s, t)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_ant, want_ant)


@pytest.mark.parametrize("shape", [(3, 16, 24), (2, 9, 13)])
def test_plain_scans_match_pallas_interpret(shape):
    """The TPU kernels (closed-form curve + probed corrections) run in
    interpret mode, as tests/test_filters.py runs them."""
    from tcforge_tpu.ops.kernels import denoise_plane_pallas, lut_correction
    rng = np.random.default_rng(3)
    b1, b2 = rand_u8(rng, *shape), rand_u8(rng, *shape)
    ant0 = b1[0].astype(np.int32) << 8
    cs, ct = lut_correction(4.0), lut_correction(6.0)
    want1, wa = denoise_plane_pallas(jnp.asarray(b1), jnp.asarray(ant0),
                                     4.0, 6.0, cs, ct)
    want2, wa2 = denoise_plane_pallas(jnp.asarray(b2), wa, 4.0, 6.0, cs, ct)
    got1, ga = port_denoise(b1, ant0, 4.0, 6.0)
    got2, ga2 = port_denoise(b2, ga, 4.0, 6.0)
    for got, want in ((got1, want1), (ga, wa), (got2, want2), (ga2, wa2)):
        np.testing.assert_array_equal(got, np.asarray(want))


# H or W in {1, 2, 31, 33, 127, 129}: the spatial kernel's ragged tiles
RAGGED_SHAPES = [(2, 1, 33), (2, 33, 1), (1, 2, 129), (2, 129, 2),
                 (3, 31, 127), (1, 127, 31)]


@pytest.mark.parametrize("shape", RAGGED_SHAPES)
@pytest.mark.parametrize("axis", [-1, -2])
@pytest.mark.parametrize("dtype", [np.uint8, np.int32])
def test_plain_spatial_pass_matches_pallas_interpret_at_ragged_shapes(
        shape, axis, dtype):
    """One spatial pass against the TPU kernel ``spatial_scan`` (closed
    form + probed corrections) in interpret mode, as
    tests/test_filters.py runs it; int32 input in the 16.16 domain, as
    the V pass gets it."""
    from tcforge_tpu.ops.kernels import _gamma_of, lut_correction, spatial_scan
    rng = np.random.default_rng(sum(shape) - axis)
    u8 = rand_u8(rng, *shape)
    f = u8.astype(np.int32) << 16
    if dtype == np.int32:
        f = f + rng.integers(0, 1 << 16, shape, dtype=np.int32)
    x = u8 if dtype == np.uint8 else f
    lines = np.moveaxis(f, axis, 0)
    want = np.asarray(spatial_scan(
        jnp.asarray(lines.reshape(lines.shape[0], -1)), _gamma_of(4.0), True,
        corr=lut_correction(4.0)))
    want = np.moveaxis(want.reshape(lines.shape), 0, axis)
    got = kernels.spatial_scan(torch.from_numpy(x),
                               torch.from_numpy(thq.precalc_coefs(4.0)), axis)
    np.testing.assert_array_equal(got.numpy(), want)


def test_two_batches_carry():
    rng = np.random.default_rng(9)
    b1, b2 = rand_u8(rng, 4, 12, 20), rand_u8(rng, 3, 12, 20)
    ant0 = b1[0].astype(np.int32) << 8
    g1, ga = port_denoise(b1, ant0, 4.0, 6.0)
    g2, ga2 = port_denoise(b2, ga, 4.0, 6.0)
    w1, wa = jax_denoise(b1, ant0, 4.0, 6.0)
    w2, wa2 = jax_denoise(b2, wa, 4.0, 6.0)
    np.testing.assert_array_equal(np.concatenate([g1, g2]),
                                  np.concatenate([w1, w2]))
    np.testing.assert_array_equal(ga2, wa2)
    # and one batch of 7 gives the same frames as 4 + 3
    g_all, ga_all = port_denoise(np.concatenate([b1, b2]), ant0, 4.0, 6.0)
    np.testing.assert_array_equal(g_all, np.concatenate([g1, g2]))
    np.testing.assert_array_equal(ga_all, ga2)


@pytest.mark.parametrize("options", [
    "", "luma=4.0", "luma=2", "chroma=5", "luma=6:chroma=1",
    "luma_strength=3", "chroma_strength=7",
    "luma=2.5:chroma=4:luma_strength=8:chroma_strength=1.5", "pre=1"])
def test_option_cascade(options):
    port = thq.Hqdn3dFilter(Job(), options)
    ref = jhq.Hqdn3dFilter(JJob(), options)
    assert port.strengths == ref.strengths
    assert port.slots == ref.slots


def test_filter_apply_matches_jax_over_two_batches():
    """The whole filter (three planes, FrameAnt seeded on the first batch
    only) against the JAX filter's apply."""
    rng = np.random.default_rng(21)
    port = thq.Hqdn3dFilter(Job(), "luma=4.0")
    ref = jhq.Hqdn3dFilter(JJob(), "luma=4.0")
    pstate = port.init_state(20, 12, ImageFormat.YUV420P, CPU)
    from tcforge_tpu.core.formats import ImageFormat as JImageFormat
    jstate = ref.init_state(20, 12, JImageFormat.YUV420P)
    for n in (3, 2):
        y, u, v = (rand_u8(rng, n, 12, 20), rand_u8(rng, n, 6, 10),
                   rand_u8(rng, n, 6, 10))
        pout, pstate = port.apply(
            FrameBatch.from_numpy(y, u, v, device=CPU), pstate)
        jout, jstate = ref.apply(JFrameBatch.from_numpy(y, u, v), jstate)
        for got, want in zip(pout.to_numpy(), jout.planes):
            np.testing.assert_array_equal(got, np.asarray(want))
        assert pstate["init"] is bool(jstate["init"])
        for key in ("y", "u", "v"):
            np.testing.assert_array_equal(pstate[key].numpy(),
                                          np.asarray(jstate[key]))


def test_first_batch_seeds_at_the_frames_size():
    """A first state made at another size than the frames' (an AVI
    header's, a Motion-JPEG chunk's first field image) is seeded from
    the frames, as the JAX filter's host path does, and carried on."""
    rng = np.random.default_rng(22)
    port = thq.Hqdn3dFilter(Job(), "luma=4.0")
    ref = jhq.Hqdn3dFilter(JJob(), "luma=4.0")
    pstate = port.init_state(20, 12, ImageFormat.YUV420P, CPU)
    from tcforge_tpu.core.formats import ImageFormat as JImageFormat
    jstate = ref.init_state(20, 12, JImageFormat.YUV420P)
    for n in (2, 3):
        y, u, v = (rand_u8(rng, n, 6, 20), rand_u8(rng, n, 3, 10),
                   rand_u8(rng, n, 3, 10))
        pout, pstate = port.apply(
            FrameBatch.from_numpy(y, u, v, device=CPU), pstate)
        jout, jstate = ref.apply_host(JFrameBatch.from_numpy(y, u, v),
                                      jstate)
        for got, want in zip(pout.to_numpy(), jout.planes):
            np.testing.assert_array_equal(got, np.asarray(want))
        for key in ("y", "u", "v"):
            np.testing.assert_array_equal(pstate[key].numpy(),
                                          np.asarray(jstate[key]))


def test_size_change_after_the_first_batch_raises():
    """Frames of another size than the carried FrameAnt raise after the
    first batch, as the JAX filter's apply does: the history is not
    silently dropped."""
    rng = np.random.default_rng(23)
    port = thq.Hqdn3dFilter(Job(), "luma=4.0")
    ref = jhq.Hqdn3dFilter(JJob(), "luma=4.0")
    pstate = port.init_state(20, 12, ImageFormat.YUV420P, CPU)
    from tcforge_tpu.core.formats import ImageFormat as JImageFormat
    jstate = ref.init_state(20, 12, JImageFormat.YUV420P)
    first = (rand_u8(rng, 2, 12, 20), rand_u8(rng, 2, 6, 10),
             rand_u8(rng, 2, 6, 10))
    _, pstate = port.apply(FrameBatch.from_numpy(*first, device=CPU),
                           pstate)
    _, jstate = ref.apply(JFrameBatch.from_numpy(*first), jstate)
    other = (rand_u8(rng, 2, 6, 20), rand_u8(rng, 2, 3, 10),
             rand_u8(rng, 2, 3, 10))
    with pytest.raises(ValueError):
        ref.apply(JFrameBatch.from_numpy(*other), jstate)
    with pytest.raises(ValueError, match="ant shape"):
        port.apply(FrameBatch.from_numpy(*other, device=CPU), pstate)


def test_rejects_non_420():
    with pytest.raises(ValueError, match="YUV420P"):
        thq.Hqdn3dFilter(Job()).init_state(8, 8, ImageFormat.YUV422P, CPU)


# the temporal kernel's vector groups of four and its scalar tail:
# planes with plane % 4 != 0, a single pixel, and 1 frame
TEMPORAL_PLANES = [(1, 1), (3, 5), (7, 13), (31, 33), (2, 2)]


def jax_temporal(v, ant, lut):
    """The JAX filter's temporal step (hqdn3d.py:118-126, ``_lpm`` with
    the exact LUT) over the frames of v."""
    out = []
    ant = jnp.asarray(ant)
    for frame in jnp.asarray(v):
        dst = jhq._lpm(ant << 8, frame, jnp.asarray(lut))
        ant = ((dst + 0x1000007F) >> 8) & 0xFFFF
        out.append(((dst + 0x10007FFF) >> 16) & 0xFF)
    return np.asarray(jnp.stack(out)).astype(np.uint8), np.asarray(ant)


@pytest.mark.parametrize("plane", TEMPORAL_PLANES)
@pytest.mark.parametrize("frames", [1, 5])
def test_temporal_pass_matches_jax_lut_at_ragged_planes(plane, frames):
    """The temporal pass alone over two batches, the FrameAnt carried:
    V-pass-like input (16.16 samples with fraction bits) and a 16-bit
    FrameAnt."""
    rng = np.random.default_rng(frames * 100 + sum(plane))
    lut = thq.precalc_coefs(6.0)
    ant = rng.integers(0, 1 << 16, plane, dtype=np.int32)
    want_ant = ant
    for _ in range(2):
        v = ((rand_u8(rng, frames, *plane).astype(np.int32) << 16)
             + rng.integers(0, 1 << 16, (frames, *plane), dtype=np.int32))
        got, ant_t = kernels.temporal_scan(torch.from_numpy(v),
                                           torch.from_numpy(ant),
                                           torch.from_numpy(lut))
        want, want_ant = jax_temporal(v, want_ant, lut)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(ant_t.numpy(), want_ant)
        ant = ant_t.numpy()
