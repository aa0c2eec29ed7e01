"""The port's clean-up denoisers against the JAX filters on the CPU:
yuvdenoise, dnr, yuvmedian and pp.

The content is ``chip_smoke.write_motion_y4m``'s, with the grain and
the impulse noise of the ``dvdclean`` and ``capture`` paths: a static
background, a moving block, a hard cut at the middle frame.  Each case
runs two batches in a row (1 then 5 frames, or 5 then 1), so every
carry crosses a batch boundary and the cut falls in a batch; every
output batch and the final carry are compared at tolerance 0.

dnr and pp hold float32 arithmetic and run under ``jax.jit``, as the
JAX engine runs them (one trace per options and batch shape).
yuvdenoise is integer arithmetic throughout; jitting its whole step
takes minutes on a CPU (the 288-vector search unrolled inside a scan),
so its JAX filter runs with jit disabled except for ``mc_search``, which
is jitted on its own (``jax_yuvdenoise``).  Then the block search with
ties placed on purpose, the chroma row recurrence at ragged shapes, pp's
option grammar, and each carry handed from a JAX run to the port
mid-stream through ``interop``.
"""

from __future__ import annotations

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tcforge_tpu.core.formats import ImageFormat as JImageFormat
from tcforge_tpu.core.frame import FrameBatch as JFrameBatch
from tcforge_tpu.core.job import Job as JJob
from tcforge_tpu.modules.filters import dnr as jdnr
from tcforge_tpu.modules.filters import median as jmedian
from tcforge_tpu.modules.filters import pp as jpp
from tcforge_tpu.modules.filters import yuvdenoise as jyd
from tcforge_tpu_torch import interop
from tcforge_tpu_torch.core.formats import ImageFormat
from tcforge_tpu_torch.core.job import Job
from tcforge_tpu_torch.io.y4m import Y4MReader
from tcforge_tpu_torch.modules.filters import dnr, median, pp
from tcforge_tpu_torch.modules.filters import yuvdenoise as yd
from tcforge_tpu_torch.ops import kernels
from test_torch_deint import assert_states_equal, jax_filter, run_pair

CPU = torch.device("cpu")
FRAMES = 6
SPLITS = ((1, 5), (5, 1))


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    """{name: (y, u, v)} of FRAMES frames (the cut at frame 3): the
    dvdclean grain clip at 64x48 and 64x64, the capture clip (impulse
    noise) at 64x48 and odd shapes, and a static 36-frame clip for dnr's
    relock."""
    tmp = tmp_path_factory.mktemp("denoise")
    out = {}
    specs = {"grain": (64, 48, dict(grain=2)),
             "grain64": (64, 64, dict(grain=2)),
             "impulse": (64, 48, dict(impulses=0.02)),
             "impulse_odd": (38, 26, dict(impulses=0.02)),
             "impulse_h6": (20, 6, dict(impulses=0.05)),
             "impulse_h4": (20, 4, dict(impulses=0.05))}
    for name, (w, h, kw) in specs.items():
        path = tmp / f"{name}.y4m"
        chip_smoke.write_motion_y4m(path, w, h, FRAMES, seed=w + h, **kw)
        with Y4MReader(str(path)) as r:
            out[name] = r.read_batch(FRAMES)
    rng = np.random.default_rng(5)
    still = [rng.integers(16, 236, (24 // s, 32 // s)).astype(np.int16)
             for s in (1, 2, 2)]
    out["static"] = tuple(
        np.clip(p[None] + rng.integers(-1, 2, (36,) + p.shape), 0, 255)
        .astype(np.uint8) for p in still)
    return out


def _size(planes):
    return planes[0].shape[2], planes[0].shape[1]


# --------------------------------------------------------------------- #
# yuvdenoise

# yuvdenoise's pieces, each jitted on its own (static: the int options)
_JAX_PIECES = {name: jax.jit(getattr(jyd, name), static_argnums=static)
               for name, static in (("mc_search", (2,)),
                                    ("contrast_plane", (1, 2, 3)),
                                    ("sharpen_plane", (1,)),
                                    ("low_contrast_blocks", (6,)),
                                    ("_gather_blocks", (3,)),
                                    ("correct_luma", (2,)),
                                    ("correct_chroma", (2,)),
                                    ("pass2_plane", (2, 3)))}
_JAX_MC = _JAX_PIECES["mc_search"]


def _jitted(fn):
    def call(*args):
        with jax.disable_jit(False):
            return fn(*args)
    return call


@contextlib.contextmanager
def yuvdenoise_pieces_jitted():
    """JAX with jit disabled, but for yuvdenoise's pieces, each jitted on
    its own (integer arithmetic: the values of the jitted filter)."""
    saved = {name: getattr(jyd, name) for name in _JAX_PIECES}
    for name, fn in _JAX_PIECES.items():
        setattr(jyd, name, _jitted(fn))
    try:
        with jax.disable_jit():
            yield
    finally:
        for name, fn in saved.items():
            setattr(jyd, name, fn)


def jax_yuvdenoise(options: str):
    """The JAX yuvdenoise filter and its ``apply`` under
    ``yuvdenoise_pieces_jitted``."""
    ref = jyd.YuvDenoiseFilter(JJob(fps=25.0), options)

    def apply(fb, state):
        with yuvdenoise_pieces_jitted():
            out, st = ref.apply(fb, state)
            return out, jax.tree_util.tree_map(np.asarray, st)
    return ref, apply


YUVDENOISE = [
    ("grain", "", (1, 5)),
    ("grain", "", (5, 1)),
    ("grain", "mode=2:border=0x4-64x40", (1, 5)),
    ("grain", "mode=1:border=8,8,48,24", (5, 1)),   # (h//4) % 8: mode 0
    ("grain64", "mode=1", (1, 5)),                  # fields
    ("grain64", "mode=1:deinterlace=1:border=8,0,48,64", (5, 1)),
    ("grain", "deinterlace=1:sharpen=0:threshold=0:pp_threshold=0:"
              "delay=1", (1, 5)),
    ("grain", "threshold=12:delay=6:sharpen=200:luma_contrast=120:"
              "chroma_contrast=80:increment_cb=-3:increment_cr=120", (5, 1)),
    ("grain", "do_reset=0:radius=2", (1, 5)),       # radius clamped to 8
    ("grain", "scene_thres=5:block_thres=200:do_reset=3", (1, 5)),
]


@pytest.mark.parametrize("clip,options,split", YUVDENOISE)
def test_yuvdenoise_matches_jax(clips, clip, options, split):
    planes = clips[clip]
    w, h = _size(planes)
    pstate, jstate = run_pair(yd.YuvDenoiseFilter(Job(), options),
                              jax_yuvdenoise(options), planes, split, w, h)
    assert_states_equal(pstate, jstate)


def test_yuvdenoise_scene_change_arms_the_reset(clips):
    """On the grain clip the cut at frame 3 arms the reset counter
    (do_reset frames of re-seeded averages) and the frames before it
    search some blocks and gate others as low-contrast."""
    planes = clips["grain"]
    f = yd.YuvDenoiseFilter(Job(), "")
    st = f.init_state(64, 48, ImageFormat.YUV420P, CPU)
    resets, searched = [], []
    real_lcb = yd.low_contrast_blocks

    def spy(*args):
        low = real_lcb(*args)
        searched.append(int((~low).sum()))
        return low
    yd.low_contrast_blocks = spy
    try:
        for i in range(FRAMES):
            fb = _batch(planes, i, 1)
            _, st = f.apply(fb, st)
            resets.append(int(st["reset"]))
    finally:
        yd.low_contrast_blocks = real_lcb
    assert resets[:3] == [0, 0, 0] and resets[3] == 2
    assert 0 < min(searched[1:3]) and max(searched[1:3]) < 48


def _batch(planes, start, n, first_id=None):
    from tcforge_tpu_torch.core.frame import FrameBatch
    return FrameBatch.from_numpy(*[p[start:start + n] for p in planes],
                                 device=CPU, fps=25.0,
                                 first_id=start if first_id is None
                                 else first_id)


def _tie_planes(h, w, kind, rng):
    """(ref, avg) int32 planes whose block SADs tie on purpose."""
    if kind == "flat":               # every vector has SAD 0
        avg = np.full((h, w), 77)
        return avg, avg
    if kind == "period4":            # zero and every dx = 4k tie at 0
        row = rng.integers(16, 236, 4)
        avg = np.tile(row, (h, w // 4))
        return avg, avg
    if kind == "shift_period8":      # zero is worse; dx = -4 and +4 tie
        base = rng.integers(16, 236, (h + 8, 8))
        avg = np.tile(base, (1, w // 8 + 2))[:h + 8]
        ref = avg[2:h + 2, 4:w + 4]
        return ref, avg[:h, :w]
    if kind == "near_edge":          # the best vector leaves the plane
        avg = rng.integers(16, 236, (h, w))
        ref = np.roll(avg, (-3, 5), axis=(0, 1))
        return ref, avg
    noise = rng.integers(0, 4, (h, w))   # many small SADs, some equal
    return noise, np.roll(noise, 1, axis=1)


@pytest.mark.parametrize("shape", ((48, 64), (32, 64)))
@pytest.mark.parametrize("kind", ("flat", "period4", "shift_period8",
                                  "near_edge", "small"))
def test_mc_search_takes_the_first_minimum(shape, kind):
    rng = np.random.default_rng(len(kind))
    ref, avg = (a.astype(np.int32) for a in _tie_planes(*shape, kind, rng))
    searched = rng.random((shape[0] // 8, shape[1] // 8)) < 0.8
    got = yd.mc_search(torch.from_numpy(ref), torch.from_numpy(avg), 8,
                       torch.from_numpy(searched))
    want = _JAX_MC(jnp.asarray(ref), jnp.asarray(avg), 8,
                   jnp.asarray(searched))
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))


@pytest.mark.parametrize("h2,w2", ((2, 5), (3, 4), (3, 7), (24, 33)))
@pytest.mark.parametrize("threshold", (0, 5))
def test_chroma_correction_matches_jax(h2, w2, threshold):
    """The plain version of ``yuvdenoise_chroma`` (the card's kernel is
    held to it by chip_smoke.py) against JAX ``correct_chroma``, on U
    and V at once."""
    rng = np.random.default_rng(h2 * 31 + w2)
    ref = rng.integers(16, 241, (2, h2, w2)).astype(np.int32)
    tmp = np.clip(ref + rng.integers(-20, 21, ref.shape), 0, 255) \
        .astype(np.int32)
    got = kernels.yuvdenoise_chroma(torch.from_numpy(ref),
                                    torch.from_numpy(tmp), threshold)
    for p in range(2):
        want = _JAX_PIECES["correct_chroma"](
            jnp.asarray(ref[p]), jnp.asarray(tmp[p]), threshold)
        np.testing.assert_array_equal(got[p].numpy(), np.asarray(want))


@pytest.mark.parametrize("name", ("contrast", "sharpen", "pass2_luma",
                                  "pass2_chroma", "correct_luma"))
def test_yuvdenoise_pieces_match_jax(name):
    """The pieces around the search, on negative differences too."""
    rng = np.random.default_rng(3)
    a = rng.integers(0, 256, (24, 40)).astype(np.int32)
    b = rng.integers(0, 256, (24, 40)).astype(np.int32)
    ta, tb, ja, jb = (torch.from_numpy(a), torch.from_numpy(b),
                      jnp.asarray(a), jnp.asarray(b))
    if name == "contrast":
        got = yd.contrast_plane(ta.to(torch.uint8), 137, 16, 240)
        want = jyd.contrast_plane(ja.astype(jnp.uint8), 137, 16, 240)
    elif name == "sharpen":
        got = yd.sharpen_plane(ta, 160)
        want = jyd.sharpen_plane(ja.astype(jnp.uint8), 160)
    elif name.startswith("pass2"):
        luma = name.endswith("luma")
        got = yd.pass2_plane(ta, tb, 7, luma)
        want = jyd.pass2_plane(ja, jb, 7, luma)
    else:
        got = yd.correct_luma(ta, tb, 9)
        want = jyd.correct_luma(ja, jb, 9)
    np.testing.assert_array_equal(got.numpy().astype(np.int64),
                                  np.asarray(want).astype(np.int64))


def test_yuvdenoise_refuses_other_formats():
    f = yd.YuvDenoiseFilter(Job(), "")
    with pytest.raises(ValueError):
        f.init_state(64, 48, ImageFormat.RGB24, CPU)
    with pytest.raises(ValueError):
        f.init_state(64, 40, ImageFormat.YUV420P, CPU)


# --------------------------------------------------------------------- #
# dnr

DNR = [
    ("impulse", "", (1, 5)),
    ("impulse", "", (5, 1)),
    ("grain", "lt=20:ll=8", (1, 5)),
    ("grain", "ct=4:cl=2:sc=90", (5, 1)),
    ("grain", "sc=1", (1, 5)),                 # a scene change a frame
    ("impulse_odd", "lt=6:ll=3:ct=12:cl=6", (1, 5)),
]


@pytest.mark.parametrize("clip,options,split", DNR)
def test_dnr_matches_jax(clips, clip, options, split):
    planes = clips[clip]
    w, h = _size(planes)
    pstate, jstate = run_pair(dnr.DnrFilter(Job(), options),
                              jax_filter(jdnr.DnrFilter, options),
                              planes, split, w, h)
    assert_states_equal(pstate, jstate)


def test_dnr_relocks_after_30_frames(clips):
    """A still clip with +-1 of grain: every pixel locks, and the lock
    history passes 30 and relocks through the average, as in JAX."""
    planes = clips["static"]
    pstate, jstate = run_pair(dnr.DnrFilter(Job(), ""),
                              jax_filter(jdnr.DnrFilter, ""), planes,
                              (1, 35), 32, 24)
    assert_states_equal(pstate, jstate)
    hist = pstate["hist"].numpy()
    assert hist.max() <= 31 and (hist < 31).any()


def test_dnr_curves_are_the_float32_tables():
    low, high = jdnr._bias_curve()
    np.testing.assert_array_equal(dnr._LOW, np.asarray(jnp.asarray(low)))
    np.testing.assert_array_equal(dnr._HIGH, np.asarray(jnp.asarray(high)))
    a, b = np.meshgrid(np.arange(256), np.arange(256))
    got = dnr.diff_metric(torch.from_numpy(a), torch.from_numpy(b))
    want = jdnr.diff_metric(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --------------------------------------------------------------------- #
# yuvmedian

MEDIAN = [
    ("impulse", ""),
    ("impulse", "radius_luma=3:radius_chroma=1:threshold_chroma=12"),
    ("impulse", "interlace=1:radius_luma=1:threshold_luma=8"),
    ("impulse_odd", "pre=0:threshold_luma=32:threshold_chroma=6"),
    ("impulse_h6", "radius_luma=1:radius_chroma=1"),
    ("impulse_h4", "radius_luma=1:radius_chroma=1:threshold_luma=20"),
]


@pytest.mark.parametrize("clip,options", MEDIAN)
def test_yuvmedian_matches_jax(clips, clip, options):
    planes = clips[clip]
    w, h = _size(planes)
    run_pair(median.YuvMedianFilter(Job(), options),
             jax_filter(jmedian.YuvMedianFilter, options), planes,
             (1, 5), w, h)


@pytest.mark.parametrize("h", (2, 3))
def test_yuvmedian_stencil_on_short_planes(h):
    rng = np.random.default_rng(h)
    p = rng.integers(0, 256, (2, h, 9)).astype(np.uint8)
    for r, t in ((1, 5), (2, 32)):
        got = median.median_plane(torch.from_numpy(p), r, t)
        want = jax.jit(jmedian.median_plane, static_argnums=(1, 2))(
            jnp.asarray(p), r, t)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_yuvmedian_slot_follows_pre():
    assert int(median.YuvMedianFilter(Job(), "").slots) == \
        int(jmedian.YuvMedianFilter(JJob(), "").slots)
    assert int(median.YuvMedianFilter(Job(), "pre=0").slots) == \
        int(jmedian.YuvMedianFilter(JJob(), "pre=0").slots)


# --------------------------------------------------------------------- #
# pp

# every subfilter, the presets, ``-name``, ``fq`` and the transcode-style
# translation; the deinterlacers in one chain
PP = [
    "de", "fa", "hb:32:20/vb:96:60:y/fq:8", "h1/v1:c/dr:y", "al:f",
    "tn:4:12:20", "tn:30:5:10:y/al", "lb/li/ci/md/fd",
]
# tn and the default preset at both splits, the rest at one
PP_SPLITS = {o: SPLITS if o in ("de", "tn:4:12:20") else SPLITS[:1]
             for o in PP}


@pytest.mark.parametrize("options,split",
                         [(o, s) for o in PP for s in PP_SPLITS[o]])
def test_pp_matches_jax(clips, options, split):
    planes = clips["grain"]
    pstate, jstate = run_pair(pp.PPFilter(Job(), options),
                              jax_filter(jpp.PPFilter, options), planes,
                              split, 64, 48)
    if jstate is not None:
        assert_states_equal(pstate, jstate)


def test_pp_alone_means_the_default_preset():
    assert pp.PPFilter(Job(), "").active == pp.PPFilter(Job(), "de").active


GRAMMAR = [
    "de", "fa", "default", "fast", "hb:a/vb:a", "hdeblock/vdeblock:c",
    "de/-al", "-de", "de,-hb", "de|dr:y", "x1hdeblock,x1vdeblock",
    "dering:c", "autolevels:f", "autopp:fullyrange", "linblenddeint",
    "tmpnoise:1:2:3", "forcequant:9/hb", "fq", "pre/de",
    "hb=64:vb=40:dr", "hb=64:vb", "tn=10:20:30", "al=f", "hb:y:c",
    "HB/VB", "ci|md|fd|li", "hb:-5",
]


@pytest.mark.parametrize("spec", GRAMMAR)
def test_pp_grammar_matches_jax(spec):
    assert pp._translate_optstr(spec) == jpp._translate_optstr(spec)
    assert pp.parse_pp_options(spec) == jpp.parse_pp_options(spec)
    port, ref = pp.PPFilter(Job(), spec), jpp.PPFilter(JJob(), spec)
    assert (port._order, port.qp, int(port.slots)) == \
        (ref._order, ref.qp, int(ref.slots))


@pytest.mark.parametrize("spec", ("zz", "hb:q", "de/nope"))
def test_pp_grammar_refuses_what_jax_refuses(spec):
    with pytest.raises(ValueError):
        jpp.parse_pp_options(spec)
    with pytest.raises(ValueError):
        pp.parse_pp_options(spec)


_PP_ARGS = {"deblock_v": (1, 64, 40), "deblock_h": (2, 48, 24),
            "x1_deblock_v": (3,), "x1_deblock_h": (1,), "dering": (1,)}


@functools.lru_cache(maxsize=None)
def _jax_pp_fn(name):
    fn = getattr(jpp, name)
    args = _PP_ARGS.get(name, ())
    return jax.jit(lambda p: fn(p, *args))


@pytest.mark.parametrize("name", ("deblock_v", "deblock_h", "x1_deblock_v",
                                  "x1_deblock_h", "dering",
                                  "linblend_deint", "linipol_deint",
                                  "median_deint", "ffmpeg_deint"))
@pytest.mark.parametrize("shape", ((2, 3, 17), (1, 17, 33)))
def test_pp_subfilters_on_ragged_planes(name, shape):
    """Planes shorter than a block and off the 8-sample grid."""
    rng = np.random.default_rng(sum(shape))
    p = rng.integers(0, 256, shape).astype(np.uint8)
    got = getattr(pp, name)(torch.from_numpy(p), *_PP_ARGS.get(name, ()))
    want = _jax_pp_fn(name)(jnp.asarray(p))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("fullyrange", (False, True))
def test_autolevels_forms_agree_over_the_whole_domain(fullyrange):
    """autolevels' ``x * scale + lo`` in float32 rounds to the same byte
    whether the multiply-add is fused (the jitted JAX filter) or not,
    for every offset x and every span hi - lo: the port's plain form is
    the jitted result."""
    lo, hi = (0, 255) if fullyrange else (16, 235)
    d = np.arange(1, 256, dtype=np.float32)[:, None]
    x = np.arange(256, dtype=np.float32)[None, :]
    scale = np.float32(hi - lo) / d
    plain = np.clip(x * scale + np.float32(lo) + np.float32(0.5), 0, 255)
    fused = np.clip((x.astype(np.float64) * scale.astype(np.float64) + lo)
                    .astype(np.float32) + np.float32(0.5), 0, 255)
    np.testing.assert_array_equal(plain.astype(np.uint8),
                                  fused.astype(np.uint8))


# --------------------------------------------------------------------- #
# a JAX carry resumes in the port

RESUME = [
    (yd.YuvDenoiseFilter, None, "grain", ""),
    (yd.YuvDenoiseFilter, None, "grain64", "mode=1"),
    (dnr.DnrFilter, jdnr.DnrFilter, "impulse", ""),
    (pp.PPFilter, jpp.PPFilter, "grain", "tn:4:12:20"),
]


@pytest.mark.parametrize("port_cls,ref_cls,clip,options", RESUME)
def test_jax_carry_resumes_in_the_port(clips, port_cls, ref_cls, clip,
                                       options):
    """Two frames through JAX, its carry into the port through
    ``interop.carry_from_numpy``, then four more through both."""
    planes = clips[clip]
    w, h = _size(planes)
    ref = (jax_yuvdenoise(options) if ref_cls is None
           else jax_filter(ref_cls, options))
    jstate = ref[0].init_state(w, h, JImageFormat.YUV420P)
    jin = JFrameBatch.from_numpy(*[p[:2] for p in planes], fps=25.0)
    _, jstate = ref[1](jin, jstate)
    pstate = interop.carry_from_numpy(
        jax.tree_util.tree_map(np.asarray, jstate), CPU)
    pstate, jstate = run_pair(port_cls(Job(), options), ref, planes,
                              (4,), w, h, first_id=2,
                              states=(pstate, jstate))
    assert_states_equal(pstate, jstate)


@pytest.mark.parametrize("bad", ("dtype", "ndim", "shape", "stride"))
def test_chroma_wrapper_refuses_what_its_kernel_does_not_take(bad):
    ref = torch.zeros((2, 4, 6), dtype=torch.int32)
    tmp = torch.zeros((2, 4, 6), dtype=torch.int32)
    if bad == "dtype":
        ref = ref.to(torch.int16)
    elif bad == "ndim":
        ref, tmp = ref[0], tmp[0]
    elif bad == "shape":
        tmp = tmp[:, :3]
    else:
        ref = torch.zeros((2, 6, 4), dtype=torch.int32).transpose(1, 2)
    with pytest.raises(ValueError):
        kernels.yuvdenoise_chroma(ref, tmp, 5)


@pytest.mark.cuda
def test_chroma_kernel_equals_its_plain_version_on_the_card():
    """On a card: the kernel at dvdclean's shape and ragged ones (the
    card's check is chip_smoke.py's phase 3; this test skips here)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(0)
    for p, h2, w2 in ((2, 240, 360), (2, 3, 7), (1, 2, 1)):
        ref = torch.from_numpy(rng.integers(16, 241, (p, h2, w2),
                                            dtype=np.int32)).cuda()
        tmp = (ref + torch.from_numpy(rng.integers(
            -20, 21, (p, h2, w2), dtype=np.int32)).cuda()).clamp_(0, 255)
        for threshold in (0, 5):
            assert torch.equal(
                kernels.yuvdenoise_chroma(ref, tmp, threshold),
                kernels.yuvdenoise_chroma_ref(ref, tmp, threshold))
