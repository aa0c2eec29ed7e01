"""The port's stabilize and transform against the JAX filters on the CPU.

The host math (cleanmean, cleanmaxmin_xy, init_fields, the smoothing,
preprocess_transforms and the ``.trf`` bytes), the field search (through
``kernels.stabilize_field_search``, which runs its plain version on the
CPU: ties placed on purpose, fields at and over the frame's edges,
stepsize 1, 2 and 6), the fields' contrast, the algo=0 search, each
interpolation and ``warp_plane``, and both filters over batches of 5, 5
and 1 frames of ``chip_smoke.write_shaky_y4m``'s clip, every output and
carry compared with the JAX filter under ``jax.jit`` (one trace per
options and batch shape), tolerance 0.

One tolerance is stated: with transform's ``sharpen`` on, XLA fuses the
warp into the unsharp mask and computes the warp again in each fusion
that reads it (the tap gathers, the blur's input and its edge columns,
the sharpened sum), each copy contracted on its own: ``zcos*x + zsin*y``
fused over either product, the bilinear taps' products and sums too.
Where a pixel's value depends on that choice the JAX program's copies
disagree with each other (a coordinate within an ulp of an integer
mixes the taps of one pixel with the weights of the next).  The port
computes one warp per pixel, so there it can differ:
``assert_warp_close`` allows differences only inside the unsharp
footprint of such pixels (``_sensitive``), and no more than 2 per
10,000.
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tcforge_tpu.core.formats import ImageFormat as JImageFormat
from tcforge_tpu.core.frame import FrameBatch as JFrameBatch
from tcforge_tpu.core.job import Job as JJob
from tcforge_tpu.modules.filters import stabilize as jst
from tcforge_tpu_torch import interop
from tcforge_tpu_torch.core.formats import ImageFormat
from tcforge_tpu_torch.core.frame import FrameBatch
from tcforge_tpu_torch.core.job import Job
from tcforge_tpu_torch.io.y4m import Y4MReader
from tcforge_tpu_torch.modules.filters import stabilize as st
from tcforge_tpu_torch.ops import fp32, kernels
from test_torch_deint import assert_states_equal, jax_filter

CPU = torch.device("cpu")
FRAMES = 11
SPLIT = (5, 5, 1)
W, H = 160, 120


@pytest.fixture(scope="module")
def shaky(tmp_path_factory):
    """(y, u, v) of FRAMES frames of the shaky clip at W x H."""
    path = tmp_path_factory.mktemp("stab") / "shaky.y4m"
    chip_smoke.write_shaky_y4m(path, W, H, FRAMES, seed=5)
    with Y4MReader(str(path)) as r:
        return r.read_batch(FRAMES)


# ---------------------------------------------------------------------
# host math


@pytest.mark.parametrize("vals", [
    [100.0, 1.0, 2.0, 3.0, -50.0], [1.0], [2.0, -1.0],
    list(np.random.default_rng(1).normal(size=17)),
    list(np.random.default_rng(2).normal(size=40) * 3)])
def test_cleanmean_matches_jax(vals):
    a = np.asarray(vals)
    assert st.cleanmean(a) == jst.cleanmean(a)


@pytest.mark.parametrize("percentil", (0, 10, 33))
def test_cleanmaxmin_matches_jax(percentil):
    ts = np.random.default_rng(percentil).normal(size=(23, 4))
    for got, want in zip(st.cleanmaxmin_xy(ts, percentil),
                         jst.cleanmaxmin_xy(ts, percentil)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(st.cleanmean_xy(ts), jst.cleanmean_xy(ts))


@pytest.mark.parametrize("w,h,size,maxshift,stepsize", [
    (1920, 1080, 108, 108, 6), (160, 120, 12, 12, 6), (64, 48, 4, 4, 6),
    (37, 25, 2, 2, 1), (720, 480, 120, 120, 2), (24, 18, 1, 1, 32)])
def test_init_fields_matches_jax(w, h, size, maxshift, stepsize):
    np.testing.assert_array_equal(
        st.init_fields(w, h, size, maxshift, stepsize),
        jst.init_fields(w, h, size, maxshift, stepsize))


@pytest.mark.parametrize("smoothing", (1, 3, 10))
def test_smooth_transforms_matches_jax(smoothing):
    ts = np.random.default_rng(smoothing).normal(size=(30, 4))
    np.testing.assert_array_equal(st.smooth_transforms(ts, smoothing),
                                  jst.smooth_transforms(ts, smoothing))


PREPROCESS = [
    dict(smoothing=10, invert=0, relative=1, maxshift=-1, maxangle=-1.0,
         zoom=0.0, optzoom=1),
    dict(smoothing=0, invert=1, relative=1, maxshift=-1, maxangle=-1.0,
         zoom=0.0, optzoom=1),
    dict(smoothing=3, invert=0, relative=0, maxshift=-1, maxangle=-1.0,
         zoom=2.5, optzoom=0),
    dict(smoothing=5, invert=0, relative=1, maxshift=4, maxangle=0.01,
         zoom=0.0, optzoom=1),
    dict(smoothing=1, invert=1, relative=0, maxshift=0, maxangle=0.0,
         zoom=-3.0, optzoom=0),
    dict(smoothing=20, invert=0, relative=1, maxshift=-1, maxangle=-1.0,
         zoom=1.0, optzoom=1),
]


@pytest.mark.parametrize("opts", PREPROCESS)
@pytest.mark.parametrize("n", (1, 25))
def test_preprocess_transforms_matches_jax(opts, n):
    ts = np.random.default_rng(n).normal(size=(n, 4)) * [3, 3, 0.02, 0]
    np.testing.assert_array_equal(
        st.preprocess_transforms(ts, 160, 120, **opts),
        jst.preprocess_transforms(ts, 160, 120, **opts))


def test_preprocess_of_nothing_is_nothing():
    got = st.preprocess_transforms(np.zeros((0, 4)), 64, 48, **PREPROCESS[0])
    assert got.shape == (0, 4)


@pytest.mark.parametrize("case", ("random", "signs", "large"))
def test_trf_bytes_match_jax(tmp_path, case):
    rng = np.random.default_rng(3)
    if case == "random":
        ts = list(rng.normal(size=(12, 4)) * [4, 4, 0.03, 0])
    elif case == "signs":
        ts = [np.array([-0.0, 0.0, -0.0, 0.0]), np.array([-1e-6, 5e-5, -4e-6,
                                                          0.0]),
              np.array([0.5, -0.5, 0.000005, 0.0])]
    else:
        ts = [np.array([12345.678912, -99999.5, 3.14159265, 100.0])]
    params = {"accuracy": 4, "shakiness": 4, "stepsize": 6, "algo": 1,
              "mincontrast": 0.3, "result": "shake.trf"}
    st.write_trf(str(tmp_path / "p.trf"), ts, params)
    jst.write_trf(str(tmp_path / "j.trf"), ts, params)
    assert (tmp_path / "p.trf").read_bytes() == (tmp_path / "j.trf").read_bytes()
    np.testing.assert_array_equal(st.read_trf(str(tmp_path / "p.trf")),
                                  jst.read_trf(str(tmp_path / "j.trf")))


def test_read_trf_takes_the_legacy_form_and_refuses_others(tmp_path):
    p = tmp_path / "legacy.trf"
    p.write_text("# x\n0 1.0 2.0 0.1 0\n\n1 -1 -2 -0.1 0\n")
    np.testing.assert_array_equal(st.read_trf(str(p)), jst.read_trf(str(p)))
    assert st.read_trf(str(p))[:, 3].tolist() == [0.0, 0.0]
    p.write_text("0 1 2\n")
    with pytest.raises(ValueError, match="cannot parse"):
        st.read_trf(str(p))


# ---------------------------------------------------------------------
# the field search


@functools.lru_cache(maxsize=None)
def _jax_field_search(maxshift, stepsize):
    return jax.jit(jax.vmap(
        lambda c, p, fy, fx: jst.field_search(c, p, fy, fx, maxshift,
                                              stepsize),
        in_axes=(0, 0, None, None)))


def _search_pair(prev, frames, centers, size, maxshift, stepsize):
    """kernels.stabilize_field_search (the plain version on the CPU)
    against the JAX field_search over the frames of ``frames``."""
    fy, fx = jst._field_patch_indices(centers, size)
    prevs = np.concatenate([prev[None], frames[:-1]])
    want = np.asarray(_jax_field_search(maxshift, stepsize)(
        frames, prevs, fy, fx))
    got = kernels.stabilize_field_search(
        torch.from_numpy(prev), torch.from_numpy(frames),
        torch.from_numpy(centers), size, maxshift, stepsize).numpy()
    np.testing.assert_array_equal(got, want)
    return got


@pytest.mark.parametrize("stepsize", (1, 2, 6))
def test_field_search_matches_jax_on_shaky_frames(shaky, stepsize):
    y = shaky[0][:4]
    maxshift = min(W, H) * 4 // 40
    centers = jst.init_fields(W, H, maxshift, maxshift, stepsize)
    got = _search_pair(y[0], y[1:], centers, maxshift, maxshift, stepsize)
    assert np.any(got != 0)


@pytest.mark.parametrize("stepsize", (1, 2, 6))
def test_field_search_ties_take_the_first_candidate(stepsize):
    """A texture periodic in x and y with period 4: every candidate 4
    apart ties, and the strict '<' keeps the first in dx-outer order;
    a flat frame ties everywhere."""
    yy, xx = np.mgrid[0:48, 0:64]
    tex = ((xx % 4) * 40 + (yy % 4) * 9).astype(np.uint8)
    frames = np.stack([np.roll(tex, (1, 2), (0, 1)), np.full_like(tex, 77)])
    centers = jst.init_fields(64, 48, 8, 8, stepsize)
    got = _search_pair(tex, frames, centers, 8, 8, stepsize)
    assert not got[1].any()              # flat: (-8, -8) first, discarded


@pytest.mark.parametrize("stepsize", (1, 2, 6))
def test_field_search_fields_at_and_over_the_edges(stepsize):
    """Fields touching every edge and reaching past it (negative
    indices wrap once, then clamp, as jnp indexes)."""
    rng = np.random.default_rng(stepsize)
    frames = rng.integers(0, 256, (3, 30, 41)).astype(np.uint8)
    centers = np.array([[0, 0], [40, 29], [3, 15], [20, 1], [-2, 33],
                        [45, -4], [20, 15]], np.int32)
    _search_pair(frames[0], frames, centers, 7, 5, stepsize)


def test_field_search_module_function_matches_jax(shaky):
    """``stabilize.field_search`` on a single frame pair with its own
    index arrays (the JAX signature)."""
    y = shaky[0]
    centers = jst.init_fields(W, H, 12, 12, 6)
    fy, fx = jst._field_patch_indices(centers, 12)
    want = np.asarray(jax.jit(lambda c, p: jst.field_search(
        c, p, fy, fx, 12, 6))(y[3], y[2]))
    got = st.field_search(torch.from_numpy(y[3]), torch.from_numpy(y[2]),
                          torch.from_numpy(fy), torch.from_numpy(fx), 12, 6)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("size", (12, 5))
def test_field_contrast_matches_jax(shaky, size):
    centers = jst.init_fields(W, H, size, 12, 6)
    fy, fx = jst._field_patch_indices(centers, size)
    y = shaky[0][:3]
    want = np.asarray(jax.jit(jax.vmap(
        lambda c: jst.field_contrast(c, fy, fx)))(y))
    got = st.field_contrast(torch.from_numpy(y), torch.from_numpy(fy),
                            torch.from_numpy(fx)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("h,w,maxshift", ((12, 16, 2), (9, 13, 3),
                                          (24, 32, 2)))
def test_global_shift_search_matches_jax(h, w, maxshift):
    rng = np.random.default_rng(h * w)
    small = rng.integers(0, 256, (h // 2 + 2, w // 2 + 2), dtype=np.uint8)
    base = np.kron(small, np.ones((2, 2), np.uint8))
    prev, curr = base[:h, :w], base[1:h + 1, 2:w + 2]
    want = np.asarray(jax.jit(lambda c, p: jst.global_shift_search(
        c, p, maxshift))(curr, prev))
    got = st.global_shift_search(torch.from_numpy(curr),
                                 torch.from_numpy(prev), maxshift).numpy()
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------
# the warp


def test_myfloor_myround_pixel_match_jax():
    x = np.array([-2.5, -1.0, -0.5, -0.0, 0.0, 0.49999997, 0.5, 1.5, 2.0,
                  7.25, -7.75], np.float32)
    for pf, jf in ((st._myfloor, jst._myfloor), (st._myround, jst._myround)):
        np.testing.assert_array_equal(pf(torch.from_numpy(x)).numpy(),
                                      np.asarray(jf(jnp.asarray(x))))
    img = np.arange(12, dtype=np.uint8).reshape(3, 4)
    xs = np.array([[-1, 0, 3, 4]], np.int32)
    ys = np.array([[0, -1, 2, 3]], np.int32)
    want = jst._pixel(jnp.asarray(img), jnp.asarray(xs), jnp.asarray(ys),
                      jnp.full(xs.shape, 99.0))
    got = st._pixel(torch.from_numpy(img)[None], torch.from_numpy(xs)[None],
                    torch.from_numpy(ys)[None],
                    torch.full((1,) + xs.shape, 99.0))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want))


def test_fma32_is_the_fused_multiply_add():
    """Against exact rational arithmetic, with operands chosen so that
    the float64 sum falls on a float32 rounding midpoint."""
    from fractions import Fraction
    rng = np.random.default_rng(4)
    a = rng.normal(size=2000).astype(np.float32) * 300
    b = rng.random(2000).astype(np.float32)
    c = rng.normal(size=2000).astype(np.float32) * 300
    a[:3] = [1.0, 3.0, 1.0 + 2 ** -23]
    b[:3] = [2 ** -25, 2 ** -24, 1.0 + 2 ** -23]
    c[:3] = [1.0, 1.0, 2 ** -24]
    got = fp32.fma32(torch.from_numpy(a), torch.from_numpy(b),
                   torch.from_numpy(c)).numpy()
    for i in range(len(a)):
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) + \
            Fraction(float(c[i]))
        r = np.float32(float(exact))
        cands = [np.nextafter(r, np.float32(-np.inf)), r,
                 np.nextafter(r, np.float32(np.inf))]
        best = min(cands, key=lambda z: (abs(Fraction(float(z)) - exact),
                                         int(np.float32(z).view(np.int32))
                                         & 1))
        assert got[i] == best, i


def _trans_rows(n, seed, pure_every=0):
    rng = np.random.default_rng(seed)
    t = np.stack([rng.normal(0, 3, n), rng.normal(0, 3, n),
                  rng.normal(0, 0.03, n), np.abs(rng.normal(0, 4, n))],
                 axis=1).astype(np.float32)
    if pure_every:
        t[::pure_every, 2:] = 0          # pure translation: the copy
        t[::pure_every, :2] = np.round(t[::pure_every, :2] * 4) / 4
    return t


ROT_THRESHOLD = 0.25 / (180 / np.pi)


def test_warp_params_match_the_jitted_jax_scalars():
    """zcos, zsin and the offsets of every frame against the same
    expressions jitted in JAX (cos and sin through the C library)."""
    t = _trans_rows(400, 5)
    t[:, 2] = np.random.default_rng(6).normal(0, 0.5, 400)

    def jp(row):
        tx, ty, alpha, tzoom = row
        z = 1.0 - tzoom / 100.0
        return jnp.stack([z * jnp.cos(-alpha), z * jnp.sin(-alpha),
                          81.0 - tx * 0.5, 60.0 - ty * 0.5])
    want = np.asarray(jax.jit(jax.vmap(jp))(t))
    fp, ip = st.warp_params(t, 162, 120, 0.5, ROT_THRESHOLD)
    np.testing.assert_array_equal(fp, want)
    np.testing.assert_array_equal(ip[:, 0], np.asarray(jst._myround(
        jnp.asarray(t[:, 0] * np.float32(0.5)))))


@functools.lru_cache(maxsize=None)
def _jax_warp(interp, crop, scale, default_val):
    return jax.jit(jax.vmap(lambda p, q: jst.warp_plane(
        p, q[0], q[1], q[2], q[3], interp=interp, crop=crop,
        default_val=default_val, rotation_threshold=ROT_THRESHOLD,
        center_scale=scale)))


@pytest.mark.parametrize("scale", (1.0, 0.5))
@pytest.mark.parametrize("crop", (0, 1))
@pytest.mark.parametrize("interp", (0, 1, 2, 3, 4))
def test_warp_plane_matches_jax(shaky, interp, crop, scale):
    plane = shaky[0][:8] if scale == 1.0 else shaky[1][:8]
    n, h, w = plane.shape
    t = _trans_rows(n, interp + 10 * crop, pure_every=3)
    dv = 16 if scale == 1.0 else 128
    want = np.asarray(_jax_warp(interp, crop, scale, dv)(plane, t))
    fp, ip = st.warp_params(t, w, h, scale, ROT_THRESHOLD)
    got = kernels.transform_warp(torch.from_numpy(plane),
                                 torch.from_numpy(fp), torch.from_numpy(ip),
                                 interp, crop, dv).numpy()
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------
# the filters


def _run_filters(port, ref, planes, sizes, w, h, collect=False):
    """Both filters over consecutive batches (frame ids running on);
    every output compared; returns the final carries."""
    ref, apply = ref
    pstate = port.init_state(w, h, ImageFormat.YUV420P, CPU)
    jstate = ref.init_state(w, h, JImageFormat.YUV420P)
    k = 0
    outs = []
    for n in sizes:
        batch = [p[k:k + n] for p in planes]
        pout, pstate = port.apply(FrameBatch.from_numpy(
            *batch, device=CPU, first_id=k, fps=25.0), pstate)
        jout, jstate = apply(JFrameBatch.from_numpy(
            *batch, first_id=k, fps=25.0), jstate)
        outs.append((pout.to_numpy(), [np.asarray(p) for p in jout.planes]))
        if collect:
            port.collect(pstate)
            ref.collect(jax.tree_util.tree_map(np.asarray, jstate))
        k += n
    return outs, pstate, jstate


STABILIZE = ["", "stepsize=2:shakiness=2", "algo=0:shakiness=1",
             "stepsize=1:accuracy=15:shakiness=2",
             "mincontrast=0.6:accuracy=8",
             "shakiness=7:stepsize=4"]


@pytest.mark.parametrize("options", STABILIZE)
def test_stabilize_filter_matches_jax(shaky, tmp_path, options):
    opts = f"{options}:result=p.trf" if options else "result=p.trf"
    port = st.StabilizeFilter(Job(), opts)
    ref = jax_filter(jst.StabilizeFilter, opts)
    planes = ((shaky[0][:, :48, :64], shaky[1][:, :24, :32],
               shaky[2][:, :24, :32]) if "algo=0" in options else shaky)
    h, w = planes[0].shape[1:]
    ref[0].transforms, ref[0]._seen = [], 0
    outs, pstate, jstate = _run_filters(port, ref, planes, SPLIT, w, h,
                                        collect=True)
    for got, want in outs:
        for g, wnt in zip(got, want):
            np.testing.assert_array_equal(g, wnt)
    assert_states_equal(pstate, jax.tree_util.tree_map(np.asarray, jstate))
    assert len(port.transforms) == FRAMES
    np.testing.assert_array_equal(np.array(port.transforms),
                                  np.array(ref[0].transforms))
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        port.finalize(pstate)
        data = (tmp_path / "p.trf").read_bytes()
        ref[0].finalize(jstate)
    finally:
        os.chdir(cwd)
    assert data == (tmp_path / "p.trf").read_bytes()
    assert b"#        result = p.trf\n" in data


def test_stabilize_skips_pad_frames_and_names_its_file():
    port = st.StabilizeFilter(Job(video_in_file="/some/dir/clip.y4m"), "")
    assert port.result == "clip.y4m.trf"
    assert st.StabilizeFilter(Job(), "").result == st.DEFAULT_TRANS_FILE
    state = port.init_state(64, 48, ImageFormat.YUV420P, CPU)
    nf = state["shifts"].shape[1]
    state.update(shifts=torch.zeros((3, nf, 2), dtype=torch.int32),
                 contrast=torch.ones((3, nf)),
                 valid=torch.tensor([False, True, True]),
                 ids=torch.tensor([0, 1, -1], dtype=torch.int32))
    port.collect(state)
    assert len(port.transforms) == 2 and port._seen == 2


def test_stabilize_refuses_rgb():
    port = st.StabilizeFilter(Job(), "")
    with pytest.raises(ValueError, match="use YUV420P input"):
        port.init_state(64, 48, ImageFormat.RGB24, CPU)


@pytest.fixture(scope="module")
def trf(tmp_path_factory, shaky):
    """The .trf the JAX stabilize writes for the shaky clip, and one of
    made-up rows with rotations and a zoom column."""
    d = tmp_path_factory.mktemp("trf")
    ref = jst.StabilizeFilter(JJob(), f"result={d / 'shaky.trf'}")
    state = ref.init_state(W, H, JImageFormat.YUV420P)
    state = jax.jit(ref.apply)(JFrameBatch.from_numpy(*shaky), state)[1]
    ref.collect(jax.tree_util.tree_map(np.asarray, state))
    ref.finalize(state)
    rows = _trans_rows(9, 7).astype(np.float64)
    jst.write_trf(str(d / "rows.trf"), list(rows), {"made": "up"})
    return {"shaky": str(d / "shaky.trf"), "rows": str(d / "rows.trf")}


TRANSFORM = [
    ("shaky", "sharpen=0"), ("shaky", "interpol=0:sharpen=0"),
    ("shaky", "interpol=1:sharpen=0"), ("shaky", "interpol=3:sharpen=0"),
    ("shaky", "interpol=4:sharpen=0"), ("shaky", "crop=1:sharpen=0"),
    ("shaky", "invert=1:sharpen=0:optzoom=0"),
    ("shaky", "relative=0:sharpen=0"),
    ("shaky", "maxshift=2:maxangle=0.005:sharpen=0"),
    ("shaky", "smoothing=0:zoom=5:optzoom=0:sharpen=0"),
    ("rows", "relative=0:smoothing=0:optzoom=0:interpol=3:sharpen=0"),
    ("rows", "relative=0:smoothing=2:interpol=4:crop=1:sharpen=0"),
]


def _transform_pair(trf, key, options):
    opts = f"input={trf[key]}:{options}"
    return st.TransformFilter(Job(), opts), jax_filter(jst.TransformFilter,
                                                        opts)


@pytest.mark.parametrize("key,options", TRANSFORM)
def test_transform_filter_matches_jax(shaky, trf, key, options):
    port, ref = _transform_pair(trf, key, options)
    outs, _, _ = _run_filters(port, ref, shaky, SPLIT, W, H)
    for got, want in outs:
        for g, wnt in zip(got, want):
            np.testing.assert_array_equal(g, wnt)


def assert_warp_close(got, want, sensitive, per=10_000, most=2):
    """The stated tolerance of the sharpened warp: ``got`` equals
    ``want`` but inside the 5x5 footprint of ``sensitive`` pixels, and
    differs in no more than ``most`` of every ``per`` pixels."""
    diff = got != want
    near = torch.nn.functional.max_pool2d(
        torch.from_numpy(sensitive.astype(np.float32))[:, None], 5, 1,
        2)[:, 0].numpy() > 0
    assert not (diff & ~near).any()
    assert diff.sum() * per <= most * diff.size


_COORD_FORMS = ("plain", "f2", "f3", "f4", "f5")


def _coords(form, m1, v1, m2, v2, off):
    """``m1*v1 + m2*v2 + off`` in float32, contracted as ``form``."""
    fma = fp32.fma32
    return {"plain": lambda: m1 * v1 + m2 * v2 + off,
            "f2": lambda: fma(m1, v1, m2 * v2) + off,
            "f3": lambda: fma(m2, v2, m1 * v1) + off,
            "f4": lambda: fma(m1, v1, fma(m2, v2, off)),
            "f5": lambda: fma(m2, v2, fma(m1, v1, off))}[form]()


def _sensitive(plane, t, scale, interp, crop, dv):
    """Pixels whose warped value changes when the source coordinates,
    or the bilinear taps' products and sums, are contracted another way
    (each fusion of the JAX program contracts its own copy), or whose
    source coordinate's integer part does; and the plane's first and
    last columns."""
    n, h, w = plane.shape
    fp, _ = st.warp_params(t, w, h, scale, ROT_THRESHOLD)
    f = torch.from_numpy(fp)
    zcos, zsin, offx, offy = (f[:, i, None, None] for i in range(4))
    xd = (torch.arange(w, dtype=torch.float32)
          - np.float32(w / 2.0))[None, None]
    yd = (torch.arange(h, dtype=torch.float32)
          - np.float32(h / 2.0))[None, :, None]
    img = torch.from_numpy(plane)
    default = (torch.full((n, h, w), float(dv)) if crop else img.float())

    def warp(fx, fy, interp_fn):
        x = _coords(fx, zcos, xd, zsin, yd, offx).expand(n, h, w)
        y = _coords(fy, -zsin, xd, zcos, yd, offy).expand(n, h, w)
        return torch.trunc(interp_fn(img, x, y, default)).numpy()

    base = warp("f2", "f2", st._INTERP[interp])
    # the first and last columns: the blur's edge padding, which XLA
    # computes in fusions of their own
    out = np.zeros(base.shape, bool)
    out[..., [0, -1]] = True
    # a coordinate whose integer part depends on the form: a fusion's
    # taps and another's weights then belong to two pixels
    for m1, v1, m2, v2, off in ((zcos, xd, zsin, yd, offx),
                                (-zsin, xd, zcos, yd, offy)):
        floors = [torch.floor(_coords(f, m1, v1, m2, v2, off))
                  for f in _COORD_FORMS]
        for other in floors[1:]:
            out |= (other != floors[0]).expand(n, h, w).numpy()
    for fx in _COORD_FORMS:
        for fy in _COORD_FORMS:
            out |= warp(fx, fy, st._INTERP[interp]) != base
    if interp == 2:
        for a, b in ((0, 0), (0, 1), (1, 0), (1, 1), (2, 2)):
            def bilin(img, x, y, default, a=a, b=b):
                return _bilin_form(img, x, y, default, a, b)
            out |= warp("f2", "f2", bilin) != base
    return out


def _bilin_form(img, x, y, default, inner, outer):
    """The bilinear taps with the products fused otherwise: 0 rounds
    both products, 1 fuses the second, 2 the first."""
    x_f, y_f = st._myfloor(x), st._myfloor(y)
    x_c, y_c = x_f + 1, y_f + 1
    v1, v2, v3, v4 = (st._pixel(img, a, b, default) for a, b in
                      ((x_c, y_c), (x_c, y_f), (x_f, y_c), (x_f, y_f)))

    def mul_add(p, q, r, s, form):
        return (p * q + r * s if form == 0 else
                fp32.fma32(r, s, p * q) if form == 1 else
                fp32.fma32(p, q, r * s))
    a = mul_add(v1, x - x_f, v3, x_c - x, inner)
    b = mul_add(v2, x - x_f, v4, x_c - x, inner)
    return mul_add(a, y - y_f, b, y_c - y, outer)


@pytest.mark.parametrize("options", ("", "interpol=3", "crop=1"))
def test_transform_sharpened_matches_jax_within_the_stated_tolerance(
        shaky, trf, options):
    """The default sharpen (5x5 unsharp, luma 0.8, chroma 0.4), through
    the port's UnsharpFilter."""
    port, ref = _transform_pair(trf, "shaky", options)
    outs, _, _ = _run_filters(port, ref, shaky, SPLIT, W, H)
    trans = np.asarray(ref[0]._trans)
    interp = 3 if "interpol=3" in options else 2
    crop = int("crop=1" in options)
    k = 0
    for (got, want), n in zip(outs, SPLIT):
        rows = trans[np.clip(np.arange(k, k + n), 0, len(trans) - 1)]
        for i, (g, wnt) in enumerate(zip(got, want)):
            plane = shaky[i][k:k + n]
            assert_warp_close(g, wnt, _sensitive(
                plane, rows, 1.0 if i == 0 else 0.5, interp, crop,
                16 if i == 0 else 128))
        k += n


def test_transform_past_the_file_end_repeats_the_last_row(shaky, trf):
    port, ref = _transform_pair(trf, "rows", "relative=0:sharpen=0")
    pstate = port.init_state(W, H, ImageFormat.YUV420P, CPU)
    jstate = ref[0].init_state(W, H, JImageFormat.YUV420P)
    batch = [p[:3] for p in shaky]
    pout, _ = port.apply(FrameBatch.from_numpy(*batch, device=CPU,
                                               first_id=20), pstate)
    jout, _ = ref[1](JFrameBatch.from_numpy(*batch, first_id=20), jstate)
    for g, wnt in zip(pout.to_numpy(), jout.planes):
        np.testing.assert_array_equal(g, np.asarray(wnt))


@pytest.mark.parametrize("fmt", (ImageFormat.RGB24, ImageFormat.YUV422P))
def test_transform_refuses_other_formats(trf, fmt):
    port = st.TransformFilter(Job(), f"input={trf['rows']}")
    with pytest.raises(ValueError, match="transform needs YUV420P"):
        port.init_state(64, 48, fmt, CPU)


def test_transform_without_its_file_raises(tmp_path):
    with pytest.raises(ValueError, match="cannot open transforms file"):
        st.TransformFilter(Job(), f"input={tmp_path / 'none.trf'}")


def test_transform_sharpens_with_the_ports_unsharp(trf):
    port = st.TransformFilter(Job(), f"input={trf['rows']}:sharpen=1.2")
    assert port._sharpen.luma == (5, 5, 1.2)
    assert port._sharpen.chroma == (5, 5, 0.6)
    assert st.TransformFilter(Job(), f"input={trf['rows']}:sharpen=0"
                              )._sharpen is None


def test_wrappers_run_their_plain_versions_on_the_cpu(shaky):
    kernels.reset_launches()
    y = torch.from_numpy(shaky[0][:2])
    centers = torch.from_numpy(jst.init_fields(W, H, 12, 12, 6))
    kernels.stabilize_field_search(y[0], y, centers, 12, 12, 6)
    fp, ip = st.warp_params(_trans_rows(2, 1), W, H, 1.0, ROT_THRESHOLD)
    kernels.transform_warp(y, torch.from_numpy(fp), torch.from_numpy(ip), 2,
                           0, 16)
    assert kernels.launches["stabilize_field_search"] == 0
    assert kernels.launches["transform_warp"] == 0
    with pytest.raises(ValueError):
        kernels.transform_warp(y, torch.from_numpy(fp),
                               torch.from_numpy(ip), 5, 0, 16)
    with pytest.raises(ValueError):
        kernels.stabilize_field_search(y[0, :4], y, centers, 12, 12, 6)


def test_stabilize_carry_goes_over_through_interop(shaky):
    """A JAX run's carry after 5 frames, handed to the port, which goes
    on for 6 more: the same shifts and transforms as the JAX run."""
    opts = "stepsize=2"
    ref, apply = jax_filter(jst.StabilizeFilter, opts)
    jstate = ref.init_state(W, H, JImageFormat.YUV420P)
    jstate = apply(JFrameBatch.from_numpy(*[p[:5] for p in shaky]),
                   jstate)[1]
    port = st.StabilizeFilter(Job(), opts)
    port.init_state(W, H, ImageFormat.YUV420P, CPU)
    pstate = interop.carry_from_numpy(
        jax.tree_util.tree_map(np.asarray, jstate), CPU)
    assert pstate["init"] is True
    rest = [p[5:] for p in shaky]
    _, pstate = port.apply(FrameBatch.from_numpy(*rest, device=CPU,
                                                 first_id=5), pstate)
    _, jstate = apply(JFrameBatch.from_numpy(*rest, first_id=5), jstate)
    assert_states_equal(pstate, jax.tree_util.tree_map(np.asarray, jstate))
