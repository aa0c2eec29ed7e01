"""The port's field and deinterlace filters against the JAX filters on
the CPU: smartdeinter (diffmode x colordiff, highq, Blend, cubic,
motionOnly, scene change, fieldShift x inswap x outswap, noMotion),
smartyuv, doublefps, smartbob, barrel and the simple filters (invert,
levels, deinterlace, mask, testframe, null).  The content is
``chip_smoke.write_motion_y4m``'s: a static background, a moving block
with its fields half a step apart, one hard cut.  Each case runs two
batches in a row (1 then 5 frames, and for some 5 then 1; 3 and 3 for
the stateless filters) so the carry and ``first`` cross a batch
boundary; every output batch and the final
carry are compared, tolerance 0.  The JAX filters run under
``jax.jit``, as the JAX engine runs them (one trace per options and
batch shape, shared between the cases).  Then each new carry handed
from a JAX run to the port mid-stream through ``interop``."""

from __future__ import annotations

import functools

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from tcforge_tpu.core.formats import ImageFormat as JImageFormat
from tcforge_tpu.core.frame import FrameBatch as JFrameBatch
from tcforge_tpu.core.job import Job as JJob
from tcforge_tpu.modules.filters import bob as jbob
from tcforge_tpu.modules.filters import extras as jextras
from tcforge_tpu.modules.filters import simple as jsimple
from tcforge_tpu.modules.filters import smartdeinter as jsd
from tcforge_tpu_torch import interop
from tcforge_tpu_torch.core.formats import ImageFormat
from tcforge_tpu_torch.core.frame import FrameBatch
from tcforge_tpu_torch.core.job import Job
from tcforge_tpu_torch.io.y4m import Y4MReader
from tcforge_tpu_torch.modules.filters import bob, extras, simple
from tcforge_tpu_torch.modules.filters import smartdeinter as sd

CPU = torch.device("cpu")
FRAMES = 12
# the filters that work in RGB take even sizes (the JAX colour
# conversion needs them); those that work per plane take odd ones too
SHAPES = ((64, 48), (37, 26), (16, 3), (20, 5))
RGB_SHAPES = ((38, 26), (16, 2))
SPLITS = ((1, 5), (5, 1))


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    """{(w, h): (y, u, v)} of FRAMES frames of the motion clip (the cut
    at frame 6), and a 720x480-shaped one cut to 64 columns at h 480."""
    tmp = tmp_path_factory.mktemp("deint")
    out = {}
    for w, h in SHAPES + RGB_SHAPES + ((64, 480),):
        path = tmp / f"m{w}x{h}.y4m"
        chip_smoke.write_motion_y4m(path, w, h, FRAMES, seed=w + h)
        with Y4MReader(str(path)) as r:
            out[(w, h)] = r.read_batch(FRAMES)
    return out


def _np(x):
    return np.asarray(x)


def assert_states_equal(got, want):
    """A port carry (tensors, Python bools and ints) against a JAX one."""
    got = interop.states_to_numpy(got)
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for key in want:
            assert_states_equal_np(got[key], want[key])
    else:
        assert_states_equal_np(got, want)


def assert_states_equal_np(got, want):
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert_states_equal_np(g, w)
    elif isinstance(want, dict):
        for key in want:
            assert_states_equal_np(got[key], want[key])
    elif want is None:
        assert got is None
    else:
        np.testing.assert_array_equal(np.asarray(got).astype(np.int64),
                                      _np(want).astype(np.int64))


@functools.lru_cache(maxsize=None)
def jax_filter(cls, options: str, fps: float = 25.0):
    """A JAX filter and its jitted ``apply``, shared by the cases that
    differ only in how the frames are split (one trace per batch
    shape)."""
    ref = cls(JJob(fps=fps), options)
    return ref, jax.jit(ref.apply)


def run_pair(port, ref, planes, sizes, w, h, rgb=False, first_id=0,
             states=None):
    """Both filters over consecutive batches of ``sizes`` frames (RGB24
    batches when ``rgb``); every output compared; returns the final
    carries (port, JAX).  ``ref`` is ``jax_filter``'s pair."""
    ref, apply = ref
    pfmt = ImageFormat.RGB24 if rgb else ImageFormat.YUV420P
    jfmt = JImageFormat.RGB24 if rgb else JImageFormat.YUV420P
    if states is None:
        pstate = port.init_state(w, h, pfmt, CPU)
        jstate = ref.init_state(w, h, jfmt)
    else:
        pstate, jstate = states
    k = first_id
    for n in sizes:
        batch = [p[k:k + n] for p in planes]
        if rgb:
            pin = FrameBatch.from_numpy(rgb=batch[0], device=CPU, fmt=pfmt,
                                        first_id=k, fps=25.0)
            jin = JFrameBatch.from_numpy(rgb=batch[0], fmt=jfmt,
                                         first_id=k, fps=25.0)
        else:
            pin = FrameBatch.from_numpy(*batch, device=CPU, first_id=k,
                                        fps=25.0)
            jin = JFrameBatch.from_numpy(*batch, first_id=k, fps=25.0)
        pout, pstate = port.apply(pin, pstate)
        jout, jstate = apply(jin, jstate)
        assert len(pout.planes) == len(jout.planes)
        for got, want in zip(pout.to_numpy(), jout.planes):
            np.testing.assert_array_equal(got, _np(want))
        for key in ("attrs", "frame_ids"):
            np.testing.assert_array_equal(getattr(pout, key).numpy(),
                                          _np(getattr(jout, key)))
        assert pout.fps == pytest.approx(float(jout.fps))
        k += n
    return pstate, jstate


def _rgb_frames(planes):
    """The clip as RGB24 frames (the JAX colour conversion, numpy out)."""
    from tcforge_tpu.ops import colorspace as jcs
    fb = JFrameBatch.from_numpy(*planes)
    return (_np(jcs.convert(fb, JImageFormat.RGB24).rgb),)


SMARTDEINTER = [
    "",                                         # the defaults (colordiff)
    "colordiff=0",
    "diffmode=1", "diffmode=1:colordiff=0",
    "diffmode=2", "diffmode=2:colordiff=0",
    "highq=0:colordiff=0",
    "Blend=1", "Blend=1:motionOnly=1:colordiff=0",
    "cubic=1", "cubic=1:highq=0:diffmode=2",
    "motionOnly=1", "threshold=0:scenethreshold=30",
    "threshold=40:colordiff=0", "scenethreshold=5:colordiff=0",
    "scenethreshold=0:Blend=1",
]
ADVANCED = [f"fieldShift={f}:inswap={i}:outswap={o}"
            for f in (0, 1) for i in (0, 1) for o in (0, 1)
            if f or i or o]
ADVANCED += [a + ":noMotion=1" for a in ADVANCED[:4]]
ADVANCED += ["fieldShift=1:colordiff=0", "fieldShift=1:Blend=1:cubic=1"]


@pytest.mark.parametrize("split", SPLITS[:1])
@pytest.mark.parametrize("options", SMARTDEINTER)
def test_smartdeinter_matches_jax(clips, options, split):
    pstate, jstate = run_pair(sd.SmartDeinterFilter(Job(), options),
                              jax_filter(jsd.SmartDeinterFilter, options),
                              clips[(64, 48)], split, 64, 48)
    assert_states_equal(pstate, jstate)


@pytest.mark.parametrize("shape", RGB_SHAPES)
@pytest.mark.parametrize("options", ["", "colordiff=0:diffmode=2",
                                     "cubic=1:diffmode=1",
                                     "fieldShift=1:outswap=1"])
def test_smartdeinter_small_planes_match_jax(clips, options, shape):
    """A half height that is odd (13), and two lines: the borders, the
    rolls' wrap-around and the 5x5 windows at their edges."""
    w, h = shape
    pstate, jstate = run_pair(sd.SmartDeinterFilter(Job(), options),
                              jax_filter(jsd.SmartDeinterFilter, options),
                              clips[shape], (1, 5), w, h)
    assert_states_equal(pstate, jstate)


@pytest.mark.parametrize("split", SPLITS[:1])
@pytest.mark.parametrize("options", ADVANCED)
def test_smartdeinter_phase_shift_matches_jax(clips, options, split):
    """The field swaps and the phase shift with its carried field (even
    heights: the JAX filter stacks the two fields)."""
    pstate, jstate = run_pair(sd.SmartDeinterFilter(Job(), options),
                              jax_filter(jsd.SmartDeinterFilter, options),
                              clips[(64, 48)], split, 64, 48)
    assert_states_equal(pstate, jstate)


def test_smartdeinter_on_rgb_batches(clips):
    planes = _rgb_frames(clips[(64, 48)])
    run_pair(sd.SmartDeinterFilter(Job(), "cubic=1"),
             jax_filter(jsd.SmartDeinterFilter, "cubic=1"), planes, (5, 1),
             64, 48, rgb=True)


def test_smartdeinter_sees_the_cut_and_the_motion(clips):
    """The clip exercises what uniform noise would not: frames with a
    moving block where only part of the map moves, and the cut, where
    the scene-change branch fires."""
    y, u, v = clips[(64, 48)]
    rgb = _rgb_frames((y, u, v))[0]
    prev = rgb[:-1].astype(np.int32)
    moving = (np.abs(rgb[1:].astype(np.int32) - prev) > 15).any(-1)
    share = moving[:, 1:-1].mean(axis=(1, 2))
    assert share[5] > 0.9                    # frame 6 against 5: the cut
    assert 0.01 < np.median(share) < 0.5     # the block alone moves


@pytest.mark.parametrize("m", [1, 2, 3, 7, 24])
def test_box5_and_dilate5_match_jax(m):
    rng = np.random.default_rng(m)
    a = rng.random((2, m, m + 3)) < 0.3
    np.testing.assert_array_equal(
        sd.box5_sum(torch.from_numpy(a.astype(np.int32))).numpy(),
        _np(jsd._box5_sum(a.astype(np.int32))))
    np.testing.assert_array_equal(sd.dilate5(torch.from_numpy(a)).numpy(),
                                  _np(jsd._dilate5(a)))


SMARTYUV = [("", shape) for shape in SHAPES]
SMARTYUV += [(o, SHAPES[0]) for o in ("doChroma=0", "Blend=0:cubic=0",
                                     "diffmode=2:highq=0",
                                     "diffmode=1:motionOnly=1")]
SMARTYUV += [(o, SHAPES[1]) for o in ("Blend=0:cubic=0",
                                     "diffmode=1:motionOnly=1")]


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("options,shape", SMARTYUV)
def test_smartyuv_matches_jax(clips, options, shape, split):
    w, h = shape
    pstate, jstate = run_pair(extras.SmartYuvFilter(Job(), options),
                              jax_filter(jextras.SmartYuvFilter, options),
                              clips[shape], split, w, h)
    assert_states_equal(pstate, jstate)


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("height", [48, 480])
@pytest.mark.parametrize("options", ["", "topfirst=0", "topfirst=1",
                                     "shiftEven=0", "fullheight=1",
                                     "fullheight=1:topfirst=0"])
def test_doublefps_matches_jax(clips, options, height, split):
    """topfirst -1 means top first unless the frame is 480 lines high."""
    job = Job(fps=25.0)
    ref = jax_filter(jbob.DoubleFpsFilter, options)
    pstate, jstate = run_pair(bob.DoubleFpsFilter(job, options), ref,
                              clips[(64, height)], split, 64, height)
    assert_states_equal(pstate, jstate)
    assert job.ex_fps == ref[0].job.ex_fps == 50.0


def test_doublefps_on_rgb_batches(clips):
    planes = _rgb_frames(clips[(64, 48)])
    run_pair(bob.DoubleFpsFilter(Job(fps=25.0), ""),
             jax_filter(jbob.DoubleFpsFilter, ""), planes, (5, 1),
             64, 48, rgb=True)


def _fields(planes, w, h, topfirst="1"):
    """The clip split into fields by the JAX doublefps (2 x FRAMES)."""
    f = jbob.DoubleFpsFilter(JJob(fps=25.0), f"topfirst={topfirst}")
    out, _ = f.apply(JFrameBatch.from_numpy(*planes), None)
    return [_np(p) for p in out.planes], _np(out.attrs)


@pytest.mark.parametrize("split", [(2, 10), (10, 2)])
@pytest.mark.parametrize("options", ["", "shiftEven=1", "denoise=1",
                                     "threshold=0", "threshold=3:denoise=1",
                                     "threshold=40:shiftEven=1"])
def test_smartbob_matches_jax(clips, options, split):
    """smartbob on doublefps' field frames, the WAS_CLONED parity and
    the carried previous field crossing the batch boundary."""
    fields, attrs = _fields(clips[(64, 48)], 64, 48)
    port = bob.SmartBobFilter(Job(), options)
    ref, apply = jax_filter(jbob.SmartBobFilter, options)
    pstate = port.init_state(64, 24, ImageFormat.YUV420P, CPU)
    jstate = ref.init_state(64, 24, JImageFormat.YUV420P)
    k = 0
    for n in split:
        batch = [p[k:k + n] for p in fields]
        pin = FrameBatch.from_numpy(*batch, device=CPU, first_id=k)
        pin = pin.with_attrs(torch.from_numpy(attrs[k:k + n].copy()))
        jin = JFrameBatch.from_numpy(*batch, first_id=k)
        jin = jin.__class__(**{**jin.__dict__, "attrs": attrs[k:k + n]})
        pout, pstate = port.apply(pin, pstate)
        jout, jstate = apply(jin, jstate)
        for got, want in zip(pout.to_numpy(), jout.planes):
            np.testing.assert_array_equal(got, _np(want))
        k += n
    assert_states_equal(pstate, jstate)


@pytest.mark.parametrize("options", [
    "order2=0.2", "order2=-0.15:order4=0.05",
    "order2=0.3:center=20/30", "order2=0.2:range=3-8/2"])
def test_barrel_matches_jax(clips, options):
    run_pair(extras.BarrelFilter(Job(), options),
             jax_filter(jextras.BarrelFilter, options), clips[(64, 48)],
             (3, 3), 64, 48)


SIMPLE = [("InvertFilter", ""), ("LevelsFilter", "input=20-200:gamma=1.7"),
          ("LevelsFilter", "output=16-235:gamma=0.6:pre=1"),
          ("DeinterlaceFilter", ""),
          ("DeinterlaceFilter", "mode=linear_blend"),
          ("MaskFilter", "lefttop=5x7:rightbot=40x30"), ("MaskFilter", ""),
          ("TestFrameFilter", "mode=0"), ("TestFrameFilter", "mode=1"),
          ("TestFrameFilter", "mode=2"), ("NullFilter", "")]


@pytest.mark.parametrize("shape", SHAPES[:2])
@pytest.mark.parametrize("name,options", SIMPLE)
def test_simple_filters_match_jax(clips, name, options, shape):
    w, h = shape
    port = getattr(simple, name)(Job(), options)
    ref = jax_filter(getattr(jsimple, name), options)
    assert port.slots == ref[0].slots
    run_pair(port, ref, clips[shape], (3, 3), w, h)


@pytest.mark.parametrize("name", ["InvertFilter", "DeinterlaceFilter"])
def test_simple_filters_on_rgb_batches(clips, name):
    planes = _rgb_frames(clips[(64, 48)])
    run_pair(getattr(simple, name)(Job(), ""),
             jax_filter(getattr(jsimple, name), ""), planes, (3, 3), 64, 48,
             rgb=True)


def test_deinterlace_filter_refuses_unknown_modes():
    with pytest.raises(ValueError, match="unknown mode"):
        simple.DeinterlaceFilter(Job(), "mode=drop")


# -- carries handed from a JAX run to the port mid-stream --

@pytest.mark.parametrize("port_cls,ref_cls,options,height", [
    (sd.SmartDeinterFilter, jsd.SmartDeinterFilter, "fieldShift=1", 48),
    (sd.SmartDeinterFilter, jsd.SmartDeinterFilter, "colordiff=0", 48),
    (extras.SmartYuvFilter, jextras.SmartYuvFilter, "", 48),
    (bob.DoubleFpsFilter, jbob.DoubleFpsFilter, "fullheight=1", 48)])
def test_jax_carry_resumes_in_the_port(clips, port_cls, ref_cls, options,
                                       height):
    """Five frames through the JAX filter, its carry handed over with
    ``interop.carry_from_numpy``, then five more through both."""
    planes = clips[(64, height)]
    job_kw = dict(fps=25.0)
    port = port_cls(Job(**job_kw), options)
    ref, apply = jax_filter(ref_cls, options)
    jstate = ref.init_state(64, height, JImageFormat.YUV420P)
    _, jstate = apply(JFrameBatch.from_numpy(
        *[p[:5] for p in planes], fps=25.0), jstate)
    pstate = interop.carry_from_numpy(
        jax.tree_util.tree_map(np.asarray, jstate), CPU)
    pstate, jstate = run_pair(port, (ref, apply), planes, (5,), 64, height,
                              first_id=5, states=(pstate, jstate))
    assert_states_equal(pstate, jstate)


def test_smartbob_carry_resumes_in_the_port(clips):
    fields, attrs = _fields(clips[(64, 48)], 64, 48)
    port = bob.SmartBobFilter(Job(), "")
    ref, apply = jax_filter(jbob.SmartBobFilter, "")
    jin = JFrameBatch.from_numpy(*[p[:7] for p in fields])
    jin = jin.__class__(**{**jin.__dict__, "attrs": attrs[:7]})
    _, jstate = apply(jin, ref.init_state(64, 24, None))
    pstate = interop.carry_from_numpy(np.asarray(jstate), CPU)
    batch = [p[7:12] for p in fields]
    pin = FrameBatch.from_numpy(*batch, device=CPU, first_id=7).with_attrs(
        torch.from_numpy(attrs[7:12].copy()))
    jin = JFrameBatch.from_numpy(*batch, first_id=7)
    jin = jin.__class__(**{**jin.__dict__, "attrs": attrs[7:12]})
    pout, _ = port.apply(pin, pstate)
    jout, _ = apply(jin, jstate)
    for got, want in zip(pout.to_numpy(), jout.planes):
        np.testing.assert_array_equal(got, _np(want))
