"""denoise3d in the torch port (plain versions on the CPU) against the
JAX filter: the coefficient table, the LUT scans, the Pallas kernels in
interpret mode (with the probed corrections, as tests/test_filters.py
runs them), the carry across batches and from a JAX carry.
Tolerance 0: integer math."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tcforge_tpu.core.formats import ImageFormat as JImageFormat
from tcforge_tpu.core.frame import FrameBatch as JFrameBatch
from tcforge_tpu.core.job import Job as JJob
from tcforge_tpu.modules.filters import denoise3d as jd3
from tcforge_tpu_torch.core.formats import ImageFormat
from tcforge_tpu_torch.core.frame import FrameBatch
from tcforge_tpu_torch.core.job import Job
from tcforge_tpu_torch.interop import states_from_numpy, states_to_numpy
from tcforge_tpu_torch.modules.filters import denoise3d as td3
from tcforge_tpu_torch.ops import kernels

CPU = torch.device("cpu")


def rand_u8(rng, *shape):
    return rng.integers(0, 256, shape, dtype=np.uint8)


def port_denoise(frames, prev, s, t):
    out, new_prev = td3.denoise_plane(
        torch.from_numpy(frames), torch.from_numpy(np.asarray(prev)),
        torch.from_numpy(td3.precalc_coefs(s)),
        torch.from_numpy(td3.precalc_coefs(t)))
    return out.numpy(), new_prev.numpy()


def jax_denoise(frames, prev, s, t):
    cs = jnp.asarray(jd3.precalc_coefs(s))
    out, new_prev = jd3.denoise_plane(jnp.asarray(frames), jnp.asarray(prev),
                                      cs, cs,
                                      jnp.asarray(jd3.precalc_coefs(t)))
    return np.asarray(out), np.asarray(new_prev)


@pytest.mark.parametrize("dist25", [0.5, 3.0, 4.0, 6.0, 13.7, 50.0, 100.0])
def test_precalc_coefs(dist25):
    np.testing.assert_array_equal(td3.precalc_coefs(dist25),
                                  jd3.precalc_coefs(dist25))


@pytest.mark.parametrize("shape", [(3, 17, 23), (2, 8, 9), (1, 5, 31),
                                   (4, 12, 1)])
@pytest.mark.parametrize("s,t", [(4.0, 6.0), (3.0, 4.0), (10.0, 2.5)])
def test_plain_scans_match_jax_lut(shape, s, t):
    rng = np.random.default_rng(sum(shape) + int(s))
    frames = rand_u8(rng, *shape)
    prev = np.zeros(shape[1:], np.int32)
    got, got_prev = port_denoise(frames, prev, s, t)
    want, want_prev = jax_denoise(frames, prev, s, t)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_prev, want_prev)


@pytest.mark.parametrize("shape", [(3, 16, 24), (2, 9, 13)])
@pytest.mark.parametrize("s,t", [(4.0, 6.0), (3.0, 4.0)])
def test_plain_scans_match_pallas_interpret(shape, s, t):
    from tcforge_tpu.ops.kernels import denoise3d_plane_pallas, lut_correction
    rng = np.random.default_rng(3)
    b1, b2 = rand_u8(rng, *shape), rand_u8(rng, *shape)
    prev0 = np.zeros(shape[1:], np.int32)
    cs, ct = lut_correction(s, mode="d3"), lut_correction(t, mode="d3")
    want1, wp = denoise3d_plane_pallas(jnp.asarray(b1), jnp.asarray(prev0),
                                       s, t, cs, ct)
    want2, wp2 = denoise3d_plane_pallas(jnp.asarray(b2), wp, s, t, cs, ct)
    got1, gp = port_denoise(b1, prev0, s, t)
    got2, gp2 = port_denoise(b2, gp, s, t)
    for got, want in ((got1, want1), (gp, wp), (got2, want2), (gp2, wp2)):
        np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("axis", (-1, -2))
@pytest.mark.parametrize("dtype", (np.uint8, np.int32))
def test_spatial_scan_is_the_lowpass_recurrence(axis, dtype):
    """One pass against the recurrence written out pixel by pixel."""
    rng = np.random.default_rng(abs(axis))
    x = rand_u8(rng, 2, 7, 9).astype(dtype)
    lut = td3.precalc_coefs(4.0)
    got = kernels.d3_spatial_scan(torch.from_numpy(x), torch.from_numpy(lut),
                                  axis).numpy()
    want = np.moveaxis(x.astype(np.int64), axis, 0).copy()
    for s in range(1, want.shape[0]):
        want[s] = want[s] + lut[want[s - 1] - want[s] + 256]
    np.testing.assert_array_equal(got, np.moveaxis(want, 0, axis))


# H or W in {1, 2, 31, 33, 127, 129}: the spatial kernel's ragged tiles
RAGGED_SHAPES = [(2, 1, 33), (2, 33, 1), (1, 2, 129), (2, 129, 2),
                 (3, 31, 127), (1, 127, 31)]


@pytest.mark.parametrize("shape", RAGGED_SHAPES)
@pytest.mark.parametrize("axis", [-1, -2])
@pytest.mark.parametrize("dtype", [np.uint8, np.int32])
def test_plain_spatial_pass_matches_pallas_interpret_at_ragged_shapes(
        shape, axis, dtype):
    """One spatial pass against the TPU kernel ``spatial_scan`` mode
    "d3" (closed form + probed corrections) in interpret mode, as
    tests/test_filters.py runs it."""
    import math
    from tcforge_tpu.ops.kernels import lut_correction, spatial_scan
    rng = np.random.default_rng(sum(shape) - axis)
    x = rand_u8(rng, *shape).astype(dtype)
    lines = np.moveaxis(x.astype(np.int32), axis, 0)
    gamma = math.log(0.25) / math.log(1.0 - 4.0 / 255.0)
    want = np.asarray(spatial_scan(
        jnp.asarray(lines.reshape(lines.shape[0], -1)), gamma, True,
        mode="d3", corr=lut_correction(4.0, mode="d3")))
    want = np.moveaxis(want.reshape(lines.shape), 0, axis)
    got = kernels.d3_spatial_scan(torch.from_numpy(x),
                                  torch.from_numpy(td3.precalc_coefs(4.0)),
                                  axis)
    np.testing.assert_array_equal(got.numpy(), want)


def test_two_batches_carry():
    rng = np.random.default_rng(9)
    b1, b2 = rand_u8(rng, 4, 12, 20), rand_u8(rng, 3, 12, 20)
    prev0 = np.zeros((12, 20), np.int32)
    g1, gp = port_denoise(b1, prev0, 4.0, 6.0)
    g2, gp2 = port_denoise(b2, gp, 4.0, 6.0)
    w1, wp = jax_denoise(b1, prev0, 4.0, 6.0)
    w2, wp2 = jax_denoise(b2, wp, 4.0, 6.0)
    np.testing.assert_array_equal(np.concatenate([g1, g2]),
                                  np.concatenate([w1, w2]))
    np.testing.assert_array_equal(gp2, wp2)
    # the carry is the last output frame
    np.testing.assert_array_equal(gp2, g2[-1].astype(np.int32))
    g_all, gp_all = port_denoise(np.concatenate([b1, b2]), prev0, 4.0, 6.0)
    np.testing.assert_array_equal(g_all, np.concatenate([g1, g2]))
    np.testing.assert_array_equal(gp_all, gp2)


@pytest.mark.parametrize("fmt,jfmt,uv", [
    (ImageFormat.YUV420P, JImageFormat.YUV420P, (6, 10)),
    (ImageFormat.YUV422P, JImageFormat.YUV422P, (12, 10))])
@pytest.mark.parametrize("options", ["", "luma=2:chroma=5",
                                     "luma_strength=9:chroma_strength=1.5",
                                     "nonative=1", "pre=1"])
def test_filter_matches_jax_from_a_jax_carry(fmt, jfmt, uv, options):
    """Batch 1 through both filters; batch 2 through the port from the
    JAX carry handed over as numpy, and through JAX."""
    rng = np.random.default_rng(len(options) + uv[0])
    port = td3.Denoise3dFilter(Job(), options)
    ref = jd3.Denoise3dFilter(JJob(), options)
    assert port.slots == ref.slots
    pstate = port.init_state(20, 12, fmt, CPU)
    jstate = ref.init_state(20, 12, jfmt)
    for key in ("y", "u", "v"):
        assert tuple(pstate[key].shape) == jstate[key].shape
    batches = [(rand_u8(rng, n, 12, 20), rand_u8(rng, n, *uv),
                rand_u8(rng, n, *uv)) for n in (3, 2)]
    pout, pstate = port.apply(
        FrameBatch.from_numpy(*batches[0], device=CPU, fmt=fmt), pstate)
    jout, jstate = ref.apply(JFrameBatch.from_numpy(*batches[0], fmt=jfmt),
                             jstate)
    for got, want in zip(pout.to_numpy(), jout.planes):
        np.testing.assert_array_equal(got, np.asarray(want))
    for key, val in states_to_numpy(pstate).items():
        np.testing.assert_array_equal(val, np.asarray(jstate[key]))
    pstate = states_from_numpy({k: np.asarray(v) for k, v in jstate.items()},
                               CPU)
    pout, pstate = port.apply(
        FrameBatch.from_numpy(*batches[1], device=CPU, fmt=fmt), pstate)
    jout, jstate = ref.apply(JFrameBatch.from_numpy(*batches[1], fmt=jfmt),
                             jstate)
    for got, want in zip(pout.to_numpy(), jout.planes):
        np.testing.assert_array_equal(got, np.asarray(want))
    for key, val in states_to_numpy(pstate).items():
        np.testing.assert_array_equal(val, np.asarray(jstate[key]))


def test_rgb_not_ported():
    """RGB24 is ported now (the name is kept): the carry is JAX's (H, W,
    3) int32 zeros, and one batch equals the JAX filter's, every
    channel through the luma tables (more cases in
    test_torch_analysis.py)."""
    port, ref = td3.Denoise3dFilter(Job()), jd3.Denoise3dFilter(JJob())
    state = port.init_state(8, 8, ImageFormat.RGB24, CPU)
    jstate = ref.init_state(8, 8, JImageFormat.RGB24)
    np.testing.assert_array_equal(state["rgb"].numpy(),
                                  np.asarray(jstate["rgb"]))
    rgb = rand_u8(np.random.default_rng(4), 2, 8, 8, 3)
    out, state = port.apply(FrameBatch.from_numpy(
        rgb=rgb, device=CPU, fmt=ImageFormat.RGB24), state)
    jout, jstate = ref.apply(JFrameBatch.from_numpy(
        rgb=rgb, fmt=JImageFormat.RGB24), jstate)
    np.testing.assert_array_equal(out.rgb.numpy(), np.asarray(jout.rgb))
    np.testing.assert_array_equal(state["rgb"].numpy(),
                                  np.asarray(jstate["rgb"]))


def test_wrapper_checks():
    lut = torch.zeros(kernels.D3_LUT_SIZE, dtype=torch.int32)
    x = torch.zeros((2, 4, 5), dtype=torch.int32)
    with pytest.raises(ValueError, match="entries"):
        kernels.d3_spatial_scan(x, torch.zeros(kernels.LUT_SIZE,
                                               dtype=torch.int32), -1)
    with pytest.raises(ValueError, match="axis"):
        kernels.d3_spatial_scan(x, lut, 0)
    with pytest.raises(ValueError, match="prev shape"):
        kernels.d3_temporal_scan(x, torch.zeros((5, 4), dtype=torch.int32),
                                 lut)
    with pytest.raises(ValueError, match="dtype"):
        kernels.d3_temporal_scan(x.to(torch.uint8),
                                 torch.zeros((4, 5), dtype=torch.int32), lut)


# the temporal kernel's vector groups of four and its scalar tail:
# planes with plane % 4 != 0, a single pixel, and 1 frame
TEMPORAL_PLANES = [(1, 1), (3, 5), (7, 13), (31, 33), (2, 2)]


def jax_temporal(v, prev, lut):
    """The JAX filter's temporal step (denoise3d.py:77-82, ``_lowpass``
    with the exact LUT) over the frames of v."""
    out = []
    prev = jnp.asarray(prev)
    for frame in jnp.asarray(v):
        prev = jd3._lowpass(prev, frame, jnp.asarray(lut))
        out.append(prev)
    return np.asarray(jnp.stack(out)).astype(np.uint8), np.asarray(prev)


@pytest.mark.parametrize("plane", TEMPORAL_PLANES)
@pytest.mark.parametrize("frames", [1, 5])
def test_temporal_pass_matches_jax_lut_at_ragged_planes(plane, frames):
    """The temporal pass alone over two batches, the previous output
    carried."""
    rng = np.random.default_rng(frames * 100 + sum(plane))
    lut = td3.precalc_coefs(6.0)
    prev = rand_u8(rng, *plane).astype(np.int32)
    want_prev = prev
    for _ in range(2):
        v = rand_u8(rng, frames, *plane).astype(np.int32)
        got, prev_t = kernels.d3_temporal_scan(torch.from_numpy(v),
                                               torch.from_numpy(prev),
                                               torch.from_numpy(lut))
        want, want_prev = jax_temporal(v, want_prev, lut)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(prev_t.numpy(), want_prev)
        prev = prev_t.numpy()
