"""The port's analysis filters and denoise3d on RGB24 against the JAX
filters on the CPU: whitebalance, detectclipping, facemask, fields,
yait (pass 1's log and pass 2's ops), compare, and denoise3d on an RGB24
job.

The content is ``chip_smoke.write_motion_y4m``'s (with grain), as
YUV420P and as RGB24 through the JAX colour conversion; detectclipping
gets a letterboxed copy.  Each case runs two batches in a row (1 then 5
frames, or 5 then 1), every output batch compared at tolerance 0, then
the final carries; the filters that write a file (detectclipping's log,
yait's log, compare's results) run their ``collect`` after each batch
and ``finalize`` at the end on both sides, and the files must be equal.
The JAX filters run under ``jax.jit``, as the JAX engine runs them:
facemask's cell mean and detectclipping's line means are float32 means,
which XLA compiles to a product with the reciprocal of the count.
Then each carry handed from a JAX run to the port mid-stream through
``interop``.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from tcforge_tpu.core.formats import ImageFormat as JImageFormat
from tcforge_tpu.core.frame import FrameBatch as JFrameBatch
from tcforge_tpu.core.job import Job as JJob
from tcforge_tpu.modules.filters import analysis as janalysis
from tcforge_tpu.modules.filters import denoise3d as jd3
from tcforge_tpu.modules.filters import simple as jsimple
from tcforge_tpu.modules.filters import yait as jyait
from tcforge_tpu_torch import interop
from tcforge_tpu_torch.core.formats import ImageFormat
from tcforge_tpu_torch.core.frame import FrameBatch
from tcforge_tpu_torch.core.job import Job
from tcforge_tpu_torch.io.image import write_png
from tcforge_tpu_torch.io.y4m import Y4MReader
from tcforge_tpu_torch.modules.filters import analysis, denoise3d, simple, yait
from test_torch_deint import assert_states_equal, jax_filter, run_pair

CPU = torch.device("cpu")
FRAMES = 6
SPLITS = ((1, 5), (5, 1))


def _rgb(planes):
    from tcforge_tpu.ops import colorspace as jcs
    fb = JFrameBatch.from_numpy(*planes)
    return (np.asarray(jcs.convert(fb, JImageFormat.RGB24).rgb),)


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    """{name: planes}: the grain clip at 64x48 and 38x26, a letterboxed
    copy (black bars of 6 rows and 4 columns), each also as RGB24."""
    tmp = tmp_path_factory.mktemp("analysis")
    out = {}
    for w, h in ((64, 48), (38, 26)):
        path = tmp / f"g{w}x{h}.y4m"
        chip_smoke.write_motion_y4m(path, w, h, FRAMES, seed=w + 7 * h,
                                    grain=2)
        with Y4MReader(str(path)) as r:
            out[(w, h)] = r.read_batch(FRAMES)
    y, u, v = (p.copy() for p in out[(64, 48)])
    y[:, :6], y[:, -6:], y[:, :, :4], y[:, :, -4:] = 16, 16, 16, 16
    y[:, 10:12, 20:30] = 200            # one bright line inside the bar
    y[:, :4, 30] = 255
    for c in (u, v):
        c[:, :3], c[:, -3:], c[:, :, :2], c[:, :, -2:] = 128, 128, 128, 128
    out["box"] = (y, u, v)
    for key in ((64, 48), (38, 26), "box"):
        out[("rgb", key)] = _rgb(out[key])
    return out


def _run(clips, key, port, ref, split=SPLITS[0]):
    rgb = isinstance(key, tuple) and key[0] == "rgb"
    planes = clips[key]
    w, h = planes[0].shape[2], planes[0].shape[1]
    return run_pair(port, ref, planes, split, w, h, rgb=rgb)


def run_hooks(port, ref, planes, sizes, w, h, rgb=False):
    """Both filters over batches of ``sizes`` frames, each output
    compared, ``collect`` after every batch and ``finalize`` at the end
    on both sides; returns the final carries (port, JAX)."""
    ref_filter, apply = ref
    pfmt = ImageFormat.RGB24 if rgb else ImageFormat.YUV420P
    jfmt = JImageFormat.RGB24 if rgb else JImageFormat.YUV420P
    pstate = port.init_state(w, h, pfmt, CPU)
    jstate = ref_filter.init_state(w, h, jfmt)
    k = 0
    for n in sizes:
        batch = [p[k:k + n] for p in planes]
        pout, pstate = port.apply(FrameBatch.from_numpy(
            *([] if rgb else batch), rgb=batch[0] if rgb else None,
            device=CPU, fmt=pfmt, first_id=k, fps=25.0), pstate)
        jout, jstate = apply(JFrameBatch.from_numpy(
            *([] if rgb else batch), rgb=batch[0] if rgb else None,
            fmt=jfmt, first_id=k, fps=25.0), jstate)
        for got, want in zip(pout.to_numpy(), jout.planes):
            np.testing.assert_array_equal(got, np.asarray(want))
        port.collect(pstate)
        ref_filter.collect(jstate)
        k += n
    port.finalize(pstate)
    ref_filter.finalize(jstate)
    return pstate, jstate


# --------------------------------------------------------------------- #
# whitebalance

WHITEBALANCE = [
    ((64, 48), ""), ((64, 48), "level=-60"),
    ((64, 48), "level=200:limit=+0-2+4"), ((38, 26), "level=15:limit=-1"),
    (("rgb", (64, 48)), ""), (("rgb", (64, 48)), "level=-1000:limit=-3+5"),
    (("rgb", (38, 26)), "level=999"),
]


@pytest.mark.parametrize("key,options", WHITEBALANCE)
@pytest.mark.parametrize("split", SPLITS)
def test_whitebalance_matches_jax(clips, key, options, split):
    _run(clips, key, analysis.WhitebalanceFilter(Job(), options),
         jax_filter(janalysis.WhitebalanceFilter, options), split)


# --------------------------------------------------------------------- #
# detectclipping

DETECTCLIPPING = [
    ("box", ""), ("box", "limit=40"), ("box", "range=0-100/2"),
    ("box", "post=1:limit=10"), ((64, 48), ""), ((38, 26), "limit=100"),
    (("rgb", "box"), ""), (("rgb", "box"), "limit=60:range=3-4/1"),
]


@pytest.mark.parametrize("key,options", DETECTCLIPPING)
@pytest.mark.parametrize("split", SPLITS)
def test_detectclipping_matches_jax(clips, tmp_path, key, options, split):
    """Outputs, the converged box, and the log each writes once, after
    the last collect."""
    rgb = isinstance(key, tuple) and key[0] == "rgb"
    planes = clips[key]
    w, h = planes[0].shape[2], planes[0].shape[1]
    logs = {side: tmp_path / f"{side}.log" for side in ("port", "jax")}
    port = analysis.DetectClippingFilter(Job(), options + (":" if options
                                                          else "")
                                         + f"log={logs['port']}")
    ref = jax_filter(janalysis.DetectClippingFilter,
                     options + (":" if options else "") + f"log={logs['jax']}")
    pstate, jstate = run_hooks(port, ref, planes, split, w, h, rgb=rgb)
    assert_states_equal(pstate, jstate)
    assert port.suggestion(pstate) == ref[0].suggestion(jstate)
    assert logs["port"].read_text() == logs["jax"].read_text()


# --------------------------------------------------------------------- #
# facemask

FACEMASK = [
    ((64, 48), "xpos=8:ypos=8:xdim=32:ydim=16"),
    ((64, 48), "xpos=4:ypos=2:xdim=30:ydim=12:xresolution=5:yresolution=3"),
    ((64, 48), "xpos=0:ypos=0:xdim=64:ydim=48:xresolution=16:"
               "yresolution=12"),
    ((38, 26), "xpos=2:ypos=4:xdim=28:ydim=14:xresolution=7:yresolution=7"),
    ((64, 48), ""),
    (("rgb", (64, 48)), "xpos=8:ypos=8:xdim=40:ydim=24:xresolution=5:"
                        "yresolution=6"),
    (("rgb", (38, 26)), "xpos=1:ypos=1:xdim=36:ydim=24:xresolution=3:"
                        "yresolution=4"),
]


@pytest.mark.parametrize("key,options", FACEMASK)
def test_facemask_matches_jax(clips, key, options):
    _run(clips, key, analysis.FacemaskFilter(Job(), options),
         jax_filter(janalysis.FacemaskFilter, options))


# --------------------------------------------------------------------- #
# fields

FIELDS = ["flip=1", "shift=1", "flip=1:shift=1", "flip=1:shift=1:flip_first=1",
          "shift=1:flip_first=1"]


@pytest.mark.parametrize("options", FIELDS)
@pytest.mark.parametrize("key", ((64, 48), ("rgb", (38, 26))))
@pytest.mark.parametrize("split", SPLITS)
def test_fields_matches_jax(clips, key, options, split):
    pstate, jstate = _run(clips, key, analysis.FieldsFilter(Job(), options),
                          jax_filter(janalysis.FieldsFilter, options), split)
    assert_states_equal(pstate, jstate)


def test_fields_without_an_operation_is_refused():
    with pytest.raises(ValueError):
        analysis.FieldsFilter(Job(), "flip_first=1")


# --------------------------------------------------------------------- #
# yait

@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("key", ((64, 48), (38, 26)))
def test_yait_log_matches_jax(clips, tmp_path, key, split):
    """Pass 1: the row-delta log, written once after the last collect."""
    planes = clips[key]
    w, h = planes[0].shape[2], planes[0].shape[1]
    logs = {side: tmp_path / f"{side}.log" for side in ("port", "jax")}
    port = yait.YaitFilter(Job(), f"log={logs['port']}")
    ref = jax_filter(jyait.YaitFilter, f"log={logs['jax']}")
    pstate, jstate = run_hooks(port, ref, planes, split, w, h)
    assert_states_equal(pstate, jstate)
    text = logs["port"].read_text()
    assert text == logs["jax"].read_text()
    assert text.startswith("0: e: 0, o: 0\n") and text.count("\n") == FRAMES


YAIT_OPS = {
    "all": ["es", "oc", "d", "5", "ec1", "os3"],
    "short": ["s", "c2"],                 # frames past the file: no op
    "copies": ["es", "ec", "os", "oc", "esd", "ec5"],
}


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("ops", sorted(YAIT_OPS))
def test_yait_ops_match_jax(clips, tmp_path, ops, split):
    """Pass 2: save, copy, drop (SKIPPED) and the deinterlacers from an
    ops file, the row buffer carried; the export rate becomes NTSC
    film."""
    path = tmp_path / "yait.ops"
    path.write_text("".join(f"{i}: {code}\n"
                            for i, code in enumerate(YAIT_OPS[ops])))
    job, jjob = Job(fps=25.0), JJob(fps=25.0)
    port = yait.YaitFilter(job, f"ops={path}")
    ref = jyait.YaitFilter(jjob, f"ops={path}")
    pstate, jstate = _run(clips, (64, 48), port, (ref, jax.jit(ref.apply)),
                          split)
    assert_states_equal(pstate, jstate)
    assert (job.ex_fps, job.fps) == (jjob.ex_fps, jjob.fps)


@pytest.mark.parametrize("text", ("0: x\n", "", "0: s\n2: c\n"))
def test_yait_bad_ops_files_are_refused(tmp_path, text):
    path = tmp_path / "bad.ops"
    path.write_text(text)
    with pytest.raises(ValueError):
        jyait.parse_ops_file(str(path))
    with pytest.raises(ValueError):
        yait.parse_ops_file(str(path))


# --------------------------------------------------------------------- #
# compare

@pytest.fixture(scope="module")
def pattern(clips, tmp_path_factory):
    """A 40x30 RGBA PNG of frame 2 of the RGB clip, opaque but for a
    transparent band (which leaves the mask); and a fully transparent
    one (the whole frame is the mask then)."""
    tmp = tmp_path_factory.mktemp("pattern")
    rgb = clips[("rgb", (64, 48))][0][2]
    small = rgb[::48 // 30 + 1, ::64 // 40 + 1][:30, :40]
    rgba = np.concatenate([small, np.full(small.shape[:2] + (1,), 255,
                                          np.uint8)], axis=-1)
    rgba[:, :6, 3] = 0
    paths = {"band": tmp / "band.png", "clear": tmp / "clear.png"}
    write_png(str(paths["band"]), rgba)
    clear = rgba.copy()
    clear[..., 3] = 0
    write_png(str(paths["clear"]), clear)
    return paths


COMPARE = [
    ((64, 48), "band", ""), ((64, 48), "band", "delta=20"),
    ((64, 48), "clear", "delta=60:flip=1"),
    (("rgb", (64, 48)), "band", "delta=30"),
    (("rgb", (64, 48)), "band", "delta=45:rgbswap=1"),
    (("rgb", (64, 48)), "clear", "delta=70"),
]


@pytest.mark.parametrize("key,which,options", COMPARE)
@pytest.mark.parametrize("split", SPLITS)
def test_compare_matches_jax(clips, pattern, tmp_path, key, which, options,
                             split):
    """The per-frame matches and the results file, written by collect and
    closed by finalize."""
    rgb = isinstance(key, tuple) and key[0] == "rgb"
    planes = clips[key]
    res = {side: tmp_path / f"{side}.log" for side in ("port", "jax")}

    def opts(side):
        return ":".join(o for o in (options, f"pattern={pattern[which]}",
                                    f"results={res[side]}") if o)
    port = simple.CompareFilter(Job(fps=25.0), opts("port"))
    ref = jsimple.CompareFilter(JJob(fps=25.0), opts("jax"))
    pstate, jstate = run_hooks(port, (ref, jax.jit(ref.apply)), planes,
                               split, 64, 48, rgb=rgb)
    assert_states_equal(pstate, jstate)
    text = res["port"].read_text()
    assert text == res["jax"].read_text()
    assert text.startswith("#fps:25.000000\n")
    assert len(text.splitlines()[1]) == FRAMES


# --------------------------------------------------------------------- #
# denoise3d on RGB24

DENOISE3D = ["", "luma=8:luma_strength=10", "luma=1:luma_strength=2",
             "chroma=9:chroma_strength=9"]


@pytest.mark.parametrize("options", DENOISE3D)
@pytest.mark.parametrize("key", (("rgb", (64, 48)), ("rgb", (38, 26))))
@pytest.mark.parametrize("split", SPLITS)
def test_denoise3d_rgb24_matches_jax(clips, key, options, split):
    """Every channel through the luma tables, the (H, W, 3) int32 carry
    across the batch boundary."""
    pstate, jstate = _run(clips, key, denoise3d.Denoise3dFilter(Job(),
                                                                options),
                          jax_filter(jd3.Denoise3dFilter, options), split)
    assert_states_equal(pstate, jstate)


def test_denoise3d_rgb24_carry_is_per_channel(clips):
    f = denoise3d.Denoise3dFilter(Job(), "")
    st = f.init_state(64, 48, ImageFormat.RGB24, CPU)
    assert tuple(st["rgb"].shape) == (48, 64, 3)
    rgb = clips[("rgb", (64, 48))][0][:2]
    out, st = f.apply(FrameBatch.from_numpy(rgb=rgb, device=CPU,
                                            fmt=ImageFormat.RGB24), st)
    for c in range(3):
        np.testing.assert_array_equal(st["rgb"][..., c].numpy(),
                                      out.rgb[-1, ..., c].numpy())


# --------------------------------------------------------------------- #
# a JAX carry resumes in the port

RESUME = [
    (analysis.DetectClippingFilter, janalysis.DetectClippingFilter, "box",
     ""),
    (analysis.FieldsFilter, janalysis.FieldsFilter, (64, 48), "shift=1"),
    (analysis.FieldsFilter, janalysis.FieldsFilter, ("rgb", (38, 26)),
     "flip=1:shift=1"),
    (yait.YaitFilter, jyait.YaitFilter, (64, 48), "log=/dev/null"),
    (denoise3d.Denoise3dFilter, jd3.Denoise3dFilter, ("rgb", (64, 48)), ""),
]


@pytest.mark.parametrize("port_cls,ref_cls,key,options", RESUME)
def test_jax_carry_resumes_in_the_port(clips, port_cls, ref_cls, key,
                                       options):
    """Two frames through JAX, its carry into the port through
    ``interop.carry_from_numpy``, then four more through both."""
    rgb = isinstance(key, tuple) and key[0] == "rgb"
    planes = clips[key]
    w, h = planes[0].shape[2], planes[0].shape[1]
    ref = jax_filter(ref_cls, options)
    jfmt = JImageFormat.RGB24 if rgb else JImageFormat.YUV420P
    jstate = ref[0].init_state(w, h, jfmt)
    jin = (JFrameBatch.from_numpy(rgb=planes[0][:2], fmt=jfmt, fps=25.0)
           if rgb else JFrameBatch.from_numpy(*[p[:2] for p in planes],
                                              fps=25.0))
    _, jstate = ref[1](jin, jstate)
    pstate = interop.carry_from_numpy(
        jax.tree_util.tree_map(np.asarray, jstate), CPU)
    port = port_cls(Job(), options)
    if isinstance(port, analysis.DetectClippingFilter):
        port.init_state(w, h, ImageFormat.YUV420P, CPU)
    pstate, jstate = run_pair(port, ref, planes, (4,), w, h, rgb=rgb,
                              first_id=2, states=(pstate, jstate))
    assert_states_equal(pstate, jstate)


# --------------------------------------------------------------------- #
# the registry

NEW_FILTERS = ["yuvdenoise", "pp", "dnr", "yuvmedian", "smooth", "xsharpen",
               "msharpen", "whitebalance", "detectclipping", "facemask",
               "fields", "yait", "compare"]


@pytest.mark.parametrize("name", NEW_FILTERS)
def test_new_filters_register_under_their_jax_names(name):
    """The same name, option table and default slot as the JAX filter."""
    from tcforge_tpu.modules import registry as jregistry
    from tcforge_tpu_torch.modules import registry as tregistry
    cls = tregistry.lookup(tregistry.ModuleKind.FILTER, name)
    jcls = jregistry.lookup(jregistry.ModuleKind.FILTER, name)
    assert cls.info.name == name and int(cls.slots) == int(jcls.slots)
    assert ([(p.name, p.fmt, p.default) for p in cls.desc.params]
            == [(p.name, p.fmt, p.default) for p in jcls.desc.params])


@pytest.mark.parametrize("name", ["divxkey", "control", "text",
                                  "subtitler", "extsub", "ascii", "preview",
                                  "sdlview", "normalize", "astat", "lowpass",
                                  "detectsilence", "resample", "aclip"])
def test_filters_outside_this_slice_still_raise(name):
    """The others but the audio filters, extsub and divxkey wait for
    their own slices: the lookup raises, no stand-in is registered.  The
    audio filters came with the port's audio track: each is registered as
    an audio filter under its JAX name; extsub came with the DVD rip and
    divxkey with the MPEG-4 import: each a video filter under its JAX
    name, with the JAX option table."""
    from tcforge_tpu.modules import registry as jregistry
    from tcforge_tpu_torch.modules import registry as tregistry
    jcls = jregistry.lookup(jregistry.ModuleKind.FILTER, name)
    if issubclass(jcls, jregistry.AudioFilter):
        cls = tregistry.lookup(tregistry.ModuleKind.FILTER, name)
        assert issubclass(cls, tregistry.AudioFilter)
        assert cls.info.name == name and int(cls.slots) == int(jcls.slots)
        return
    if name in ("extsub", "divxkey"):
        cls = tregistry.lookup(tregistry.ModuleKind.FILTER, name)
        assert issubclass(cls, tregistry.VideoFilter)
        assert cls.info.name == name and int(cls.slots) == int(jcls.slots)
        assert ([(p.name, p.fmt, p.default) for p in cls.desc.params]
                == [(p.name, p.fmt, p.default) for p in jcls.desc.params])
        return
    with pytest.raises(KeyError, match=name):
        tregistry.lookup(tregistry.ModuleKind.FILTER, name)
