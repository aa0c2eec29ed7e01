"""The port's overlay filters against the JAX filters on the CPU:
logoaway, logo, fieldanalysis, 29to23 and cpaudio, and the rule that a
``-J`` list may name audio filters, which the video chain builds and
skips.

The content is ``chip_smoke.write_telecine_y4m``'s 3:2 telecined film at
NTSC rate with a static station logo in the top right (``station``),
as YUV420P and as RGB24 through the JAX colour conversion; the logo for
``logo`` is ``chip_smoke.write_logo_png``'s RGBA PNG, whose alpha is 0,
255 and every level between.  Each case runs three batches (7, 7 and 6
frames, the frame ids running on), every output batch and the final
carry compared with the JAX filter under ``jax.jit`` (one trace per
options and batch shape), tolerance 0; fieldanalysis's counters and its
RESULTS and CONCLUSION lines too.  logo's float32 fade and opacity
divide by constants, which XLA compiles to products with the float32
reciprocal; fieldanalysis sums its row sums in float32 in the order of
XLA's tree reduction.
"""

from __future__ import annotations

import functools
import logging
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tcforge_tpu.core.formats import ImageFormat as JImageFormat
from tcforge_tpu.core.frame import AudioBatch as JAudioBatch
from tcforge_tpu.core.frame import FrameBatch as JFrameBatch
from tcforge_tpu.core.job import FilterSpec as JFilterSpec
from tcforge_tpu.core.job import Job as JJob
from tcforge_tpu.modules.filters import overlay as jov
from tcforge_tpu.pipeline.chain import VideoChain as JVideoChain
from tcforge_tpu_torch import interop
from tcforge_tpu_torch.core.formats import ImageFormat
from tcforge_tpu_torch.core.frame import (ATTR_SKIPPED, AudioBatch,
                                          FrameBatch)
from tcforge_tpu_torch.core.job import FilterSpec, Job
from tcforge_tpu_torch.io.y4m import Y4MReader
from tcforge_tpu_torch.modules import registry
from tcforge_tpu_torch.modules.filters import overlay as ov
from tcforge_tpu_torch.pipeline.chain import VideoChain
from test_torch_deint import assert_states_equal

CPU = torch.device("cpu")
FRAMES = 20
SPLIT = (7, 7, 6)
W, H = 64, 48
STATION = (48, 4, 12, 8)
NTSC = 30000 / 1001


def _rgb(planes):
    from tcforge_tpu.ops import colorspace as jcs
    fb = JFrameBatch.from_numpy(*planes)
    return (np.asarray(jcs.convert(fb, JImageFormat.RGB24).rgb),)


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    """{name: planes}: the telecined clip with its station logo at 64x48
    and at 38x26 (odd chroma offsets), and each as RGB24."""
    tmp = tmp_path_factory.mktemp("overlay")
    out = {}
    for (w, h), station in (((W, H), STATION), ((38, 26), (20, 3, 15, 9))):
        path = tmp / f"t{w}x{h}.y4m"
        chip_smoke.write_telecine_y4m(path, w, h, FRAMES, seed=w + h,
                                      station=station)
        with Y4MReader(str(path)) as r:
            out[(w, h)] = r.read_batch(FRAMES)
        out[("rgb", (w, h))] = _rgb(out[(w, h)])
    return out


@pytest.fixture(scope="module")
def aux(tmp_path_factory):
    """The logo PNG (16x8), an odd-sized one (15x7), logoaway's shape
    file (12x8: alpha 255 in a diamond, levels outside) and a PPM."""
    d = tmp_path_factory.mktemp("overlay_aux")
    chip_smoke.write_logo_png(d / "logo.png", 16, 8, seed=1)
    chip_smoke.write_logo_png(d / "odd.png", 15, 7, seed=2)
    from tcforge_tpu_torch.io.image import write_image
    yy, xx = np.mgrid[0:8, 0:12]
    shape = np.where(abs(xx - 6) + abs(yy - 4) < 4, 255,
                     (xx * 20 + yy * 7) % 256)
    write_image(str(d / "shape.ppm"), np.stack([shape] * 3, -1).astype(
        np.uint8))
    write_image(str(d / "logo.ppm"), np.random.default_rng(3).integers(
        0, 256, (6, 10, 3)).astype(np.uint8))
    return d


@functools.lru_cache(maxsize=None)
def _jax_filter(cls, options, fps):
    ref = cls(JJob(fps=fps), options)
    return ref, jax.jit(ref.apply)


def _run(port, ref, planes, w, h, rgb=False, fps=NTSC, sizes=SPLIT,
         skipped=()):
    """Both filters over batches of ``sizes`` frames at ``fps``, frames
    whose id is in ``skipped`` marked SKIPPED; every output compared.
    Returns the final carries."""
    ref, apply = ref
    pfmt = ImageFormat.RGB24 if rgb else ImageFormat.YUV420P
    jfmt = JImageFormat.RGB24 if rgb else JImageFormat.YUV420P
    pstate = port.init_state(w, h, pfmt, CPU)
    jstate = ref.init_state(w, h, jfmt)
    k = 0
    for n in sizes:
        batch = [p[k:k + n] for p in planes]
        attrs = np.array([ATTR_SKIPPED if i in skipped else 0
                          for i in range(k, k + n)], np.int32)
        if rgb:
            pin = FrameBatch.from_numpy(rgb=batch[0], device=CPU, fmt=pfmt,
                                        first_id=k, fps=fps)
            jin = JFrameBatch.from_numpy(rgb=batch[0], fmt=jfmt,
                                         first_id=k, fps=fps)
        else:
            pin = FrameBatch.from_numpy(*batch, device=CPU, first_id=k,
                                        fps=fps)
            jin = JFrameBatch.from_numpy(*batch, first_id=k, fps=fps)
        pin = pin.with_attrs(torch.from_numpy(attrs))
        jin = JFrameBatch(format=jin.format, y=jin.y, u=jin.u, v=jin.v,
                          rgb=jin.rgb, attrs=jnp.asarray(attrs),
                          frame_ids=jin.frame_ids, fps=jin.fps)
        pout, pstate = port.apply(pin, pstate)
        jout, jstate = apply(jin, jstate)
        assert len(pout.planes) == len(jout.planes)
        for got, want in zip(pout.to_numpy(), jout.planes):
            np.testing.assert_array_equal(got, np.asarray(want))
        for key in ("attrs", "frame_ids"):
            np.testing.assert_array_equal(getattr(pout, key).numpy(),
                                          np.asarray(getattr(jout, key)))
        k += n
    return pstate, jax.tree_util.tree_map(np.asarray, jstate)


def _pair(cls, jcls, options, fps=NTSC):
    return cls(Job(fps=fps), options), _jax_filter(jcls, options, fps)


# ---------------------------------------------------------------------
# logoaway

LOGOAWAY = [
    ((W, H), "mode=1:pos=48x4:size=12x8"),
    ((W, H), "mode=1:pos=48x4:size=12x8:fill=FF8010:border=1"),
    ((W, H), "mode=2:pos=48x4:size=12x8"),
    ((W, H), "mode=2:pos=48x4:size=12x8:xweight=0"),
    ((W, H), "mode=2:pos=48x4:size=12x8:xweight=100:border=1"),
    ((W, H), "mode=2:pos=47x5:size=13x9:xweight=37"),
    ((W, H), "mode=2:pos=40x30:size=40x40"),        # clamped at the edge
    ((W, H), "mode=2:pos=10x10:size=12x8:range=3-9"),
    ((W, H), "mode=2:pos=10x10:size=1x8"),          # too small: a no-op
    ((W, H), "mode=0:pos=48x4:size=12x8"),
    ((W, H), "mode=1:pos=48x4:size=12x8:file={aux}/shape.ppm"),
    ((W, H), "mode=3:pos=48x4:size=12x8:file={aux}/shape.ppm"),
    ((W, H), "mode=3:pos=48x4:size=12x8:file={aux}/shape.ppm:border=1:"
             "xweight=70"),
    ((38, 26), "mode=2:pos=20x3:size=15x9"),
    ((38, 26), "mode=3:pos=21x3:size=12x8:file={aux}/shape.ppm"),
    (("rgb", (W, H)), "mode=1:pos=48x4:size=12x8:fill=10A0F0"),
    (("rgb", (W, H)), "mode=2:pos=48x4:size=12x8:border=1"),
    (("rgb", (W, H)), "mode=3:pos=48x4:size=12x8:file={aux}/shape.ppm"),
    (("rgb", (38, 26)), "mode=2:pos=20x3:size=15x9:xweight=20"),
]


@pytest.mark.parametrize("key,options", LOGOAWAY)
def test_logoaway_matches_jax(clips, aux, key, options):
    options = options.replace("{aux}", str(aux))
    rgb = isinstance(key, tuple) and key[0] == "rgb"
    w, h = key[1] if rgb else key
    port, ref = _pair(ov.LogoAwayFilter, jov.LogoAwayFilter, options)
    _run(port, ref, clips[key], w, h, rgb=rgb)


@pytest.mark.parametrize("rgb", (False, True))
def test_logoaway_dump_writes_the_jax_file(clips, tmp_path, monkeypatch,
                                           rgb):
    """``dump`` writes the region of the batch's first frame to
    dump[0].ppm in the working directory (the JAX filter eagerly)."""
    options = "mode=2:pos=48x4:size=12x8:dump=1"
    planes = clips[("rgb", (W, H))] if rgb else clips[(W, H)]
    batch = [p[:3] for p in planes]
    files = {}
    for side in ("port", "jax"):
        d = tmp_path / side
        d.mkdir()
        monkeypatch.chdir(d)
        if side == "port":
            fb = (FrameBatch.from_numpy(rgb=batch[0], device=CPU,
                                        fmt=ImageFormat.RGB24) if rgb
                  else FrameBatch.from_numpy(*batch, device=CPU))
            ov.LogoAwayFilter(Job(), options).apply(fb, None)
        else:
            fb = (JFrameBatch.from_numpy(rgb=batch[0],
                                         fmt=JImageFormat.RGB24) if rgb
                  else JFrameBatch.from_numpy(*batch))
            jov.LogoAwayFilter(JJob(), options).apply(fb, None)
        files[side] = (d / "dump[0].ppm").read_bytes()
    assert files["port"] == files["jax"]


# ---------------------------------------------------------------------
# logo

LOGO = [
    ((W, H), ""), ((W, H), "posdef=1"), ((W, H), "posdef=2"),
    ((W, H), "posdef=3:hqconv=1"), ((W, H), "posdef=4:grayout=1"),
    ((W, H), "posdef=5"), ((W, H), "pos=30x20:flip=1"),
    ((W, H), "pos=8x2:rgbswap=1:hqconv=1"),
    ((W, H), "posdef=3:fade=4-5:range=2-17"),
    ((W, H), "posdef=2:range=5-12"), ((W, H), "posdef=4:fade=0-3"),
    ((38, 26), "pos=21x17:hqconv=1"), ((38, 26), "posdef=5:fade=2-2"),
    (("rgb", (W, H)), "posdef=2"),
    (("rgb", (W, H)), "pos=3x5:flip=1:rgbswap=1:fade=3-3"),
    (("rgb", (38, 26)), "posdef=4:range=4-18"),
]


@pytest.mark.parametrize("key,options", LOGO)
def test_logo_matches_jax(clips, aux, key, options):
    options = f"file={aux / 'logo.png'}" + (f":{options}" if options else "")
    rgb = isinstance(key, tuple) and key[0] == "rgb"
    w, h = key[1] if rgb else key
    port, ref = _pair(ov.LogoFilter, jov.LogoFilter, options)
    _run(port, ref, clips[key], w, h, rgb=rgb)


def test_logo_takes_a_ppm_and_refuses_odd_sizes_on_yuv(clips, aux):
    port, ref = _pair(ov.LogoFilter, jov.LogoFilter,
                      f"file={aux / 'logo.ppm'}:posdef=5")
    _run(port, ref, clips[(W, H)], W, H)
    port = ov.LogoFilter(Job(), f"file={aux / 'odd.png'}")
    port.init_state(W, H, ImageFormat.YUV420P, CPU)
    with pytest.raises(ValueError, match="odd sizes"):
        port.apply(FrameBatch.from_numpy(*[p[:2] for p in clips[(W, H)]],
                                         device=CPU), None)
    port, ref = _pair(ov.LogoFilter, jov.LogoFilter,
                      f"file={aux / 'odd.png'}:pos=3x3")
    _run(port, ref, clips[("rgb", (W, H))], W, H, rgb=True)


@pytest.mark.parametrize("options,message", [
    ("", "'file' option is required"), ("file={aux}/logo.png:pos=60x0",
                                        "invalid position")])
def test_logo_refuses_what_the_jax_filter_refuses(clips, aux, options,
                                                  message):
    options = options.replace("{aux}", str(aux))
    with pytest.raises(ValueError, match=message):
        port = ov.LogoFilter(Job(), options)
        port.init_state(W, H, ImageFormat.YUV420P, CPU)
        port.apply(FrameBatch.from_numpy(*[p[:1] for p in clips[(W, H)]],
                                         device=CPU), None)


@pytest.mark.parametrize("delays,ignore", [
    ((0,), False), ((3, 1, 4), False), ((0, 0), False), ((5, 2), True),
    ((2, 7, 1, 3), False)])
def test_logo_animation_schedule_matches_jax(aux, delays, ignore):
    """set_delay's closed form for a sequence of images (as Pillow
    would load from an animated file): the image index per frame."""
    options = f"file={aux / 'logo.png'}" + (":ignoredelay=1" if ignore
                                             else "")
    port = ov.LogoFilter(Job(fps=25.0), options)
    ref = jov.LogoFilter(JJob(fps=25.0), options)
    port._delays = ref._delays = [int(d * 25 / 100.0) for d in
                                  (x * 20 for x in delays)]
    k = np.arange(60, dtype=np.int32)
    np.testing.assert_array_equal(
        port._seq_index(torch.from_numpy(k)).numpy(),
        np.asarray(ref._seq_index(jnp.asarray(k))))


def test_logo_png_loads_without_pillow(aux, monkeypatch):
    """A PNG (and a PPM) logo never imports Pillow."""
    monkeypatch.setitem(sys.modules, "PIL", None)
    for name in ("logo.png", "logo.ppm"):
        frames, delays = ov._load_logo_frames(str(aux / name))
        assert len(frames) == 1 and frames[0].shape[-1] == 4
        assert delays == [0]


def test_logo_builds_its_planes_on_the_chains_device(aux):
    port = ov.LogoFilter(Job(), f"file={aux / 'logo.png'}:hqconv=1")
    port.init_state(W, H, ImageFormat.YUV420P, CPU)
    ref = jov.LogoFilter(JJob(), f"file={aux / 'logo.png'}:hqconv=1")
    for got, want in zip(port._yuv, ref._yuv):
        assert got.device == CPU
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------
# fieldanalysis


@pytest.fixture
def jax_log(monkeypatch):
    """The JAX package's log.info lines, as "[tag] text"."""
    from tcforge_tpu.core import log as jlog
    lines = []

    def info(tag, msg, *args):
        lines.append(f"[{tag}] " + (msg % args if args else msg))
    monkeypatch.setattr(jlog, "info", info)
    return lines


FIELDANALYSIS = [
    ((W, H), "", NTSC, ()),
    ((W, H), "", 25.0, ()),
    ((W, H), "forcetelecinedetect=1", 25.0, ()),
    ((W, H), "interlacediff=1.5:unknowndiff=3:progressivediff=4", NTSC, ()),
    ((W, H), "progressivechange=0.5:changedifmore=2", NTSC, (3, 4, 11)),
    ((38, 26), "", NTSC, ()),
    ((38, 26), "changedifmore=40", NTSC, (0,)),
    (("rgb", (W, H)), "", NTSC, ()),
    (("rgb", (38, 26)), "forcetelecinedetect=1", 25.0, ()),
] + [((W, H), f"outdiff={od}", NTSC, ()) for od in range(1, 12)]


@pytest.mark.parametrize("key,options,fps,skipped", FIELDANALYSIS)
def test_fieldanalysis_matches_jax(clips, jax_log, caplog, key, options,
                                   fps, skipped):
    """Outputs, carries, counters, the RESULTS and CONCLUSION lines."""
    rgb = isinstance(key, tuple) and key[0] == "rgb"
    w, h = key[1] if rgb else key
    port, ref = _pair(ov.FieldAnalysisFilter, jov.FieldAnalysisFilter,
                      options, fps)
    pstate, jstate = _run(port, ref, clips[key], w, h, rgb=rgb, fps=fps,
                          skipped=skipped)
    assert_states_equal(pstate, jstate)
    # a SKIPPED frame is not counted, but the stream's first frame is
    assert pstate["counts"][0] == FRAMES - sum(1 for i in skipped if i)
    with caplog.at_level(logging.INFO, logger="tcforge_tpu_torch"):
        port.finalize(pstate)
    ref[0].finalize(jstate)
    assert [r.getMessage() for r in caplog.records] == jax_log
    assert len(jax_log) == 5 and port.verdict == ref[0].verdict


def test_fieldanalysis_sums_in_the_order_of_xla():
    """The float32 row sums of a 1080-line frame, whose total is not
    exact in float32: the order of XLA's tree reduction."""
    rng = np.random.default_rng(8)
    for h, w in ((1080, 1920), (480, 720), (577, 99)):
        a = rng.integers(0, 256, (3, h, w)).astype(np.int32)
        b = np.clip(a + rng.integers(-30, 31, a.shape), 0, 255)
        want = np.asarray(jax.jit(lambda x, y: jov._fa_compare(
            x, y, h - 2, h - 2))(a, b.astype(np.int32)))
        got = ov._fa_compare(torch.from_numpy(a), torch.from_numpy(
            b.astype(np.int32)), h - 2, h - 2).numpy()
        np.testing.assert_array_equal(got, want)


def test_fieldanalysis_carry_goes_over_through_interop(clips):
    ref, apply = _jax_filter(jov.FieldAnalysisFilter, "", NTSC)
    planes = clips[(W, H)]
    jstate = ref.init_state(W, H, JImageFormat.YUV420P)
    jstate = apply(JFrameBatch.from_numpy(*[p[:7] for p in planes],
                                          fps=NTSC), jstate)[1]
    pstate = interop.carry_from_numpy(
        jax.tree_util.tree_map(np.asarray, jstate), CPU)
    assert isinstance(pstate["telecine"], int) and \
        isinstance(pstate["counts"], list)
    port = ov.FieldAnalysisFilter(Job(fps=NTSC), "")
    rest = [p[7:] for p in planes]
    _, pstate = port.apply(FrameBatch.from_numpy(*rest, device=CPU,
                                                 first_id=7, fps=NTSC),
                           pstate)
    _, jstate = apply(JFrameBatch.from_numpy(*rest, first_id=7, fps=NTSC),
                      jstate)
    assert_states_equal(pstate, jax.tree_util.tree_map(np.asarray, jstate))


# ---------------------------------------------------------------------
# 29to23, cpaudio and the audio names in -J


@pytest.mark.parametrize("sizes", (SPLIT, (20,), (1, 4, 15)))
def test_29to23_matches_jax(clips, sizes):
    port, ref = _pair(ov.F29to23Filter, jov.F29to23Filter, "")
    _run(port, ref, clips[(W, H)], W, H, sizes=sizes)
    assert port.job.ex_fps == pytest.approx(23.976)


@pytest.mark.parametrize("source,channels", ((0, 2), (1, 2), (0, 1),
                                             (1, 6)))
def test_cpaudio_matches_jax(source, channels):
    pcm = np.random.default_rng(channels).integers(
        -32768, 32768, (3, 1601, channels)).astype(np.int16)
    opts = f"source={source}"
    got = ov.CpAudioFilter(Job(), opts).apply(
        AudioBatch(pcm=torch.from_numpy(pcm), channels=channels), None)[0]
    want = jov.CpAudioFilter(JJob(), opts).apply(
        JAudioBatch(pcm=jnp.asarray(pcm), channels=channels), None)[0]
    np.testing.assert_array_equal(got.pcm.numpy(), np.asarray(want.pcm))
    assert (got.rate, got.channels, got.bits) == (want.rate, want.channels,
                                                  want.bits)


def test_audio_batch_has_the_jax_fields():
    pcm = torch.zeros((2, 5, 2), dtype=torch.int16)
    ab = AudioBatch(pcm=pcm, attrs=torch.tensor([0, ATTR_SKIPPED],
                                                dtype=torch.int32))
    assert (ab.batch, ab.samples_per_frame, ab.rate, ab.bits) == (2, 5,
                                                                  48000, 16)
    assert ab.has_attr(ATTR_SKIPPED).tolist() == [False, True]
    assert AudioBatch(pcm=pcm).has_attr(ATTR_SKIPPED).tolist() == [False,
                                                                    False]
    assert ab.with_pcm(pcm + 1).pcm.sum() == 20


@pytest.mark.parametrize("names", ("hqdn3d,cpaudio", "cpaudio",
                                   "cpaudio=source=1,invert,cpaudio"))
def test_video_chain_builds_and_skips_audio_filters(names):
    """Each -J module is built, and the video chain keeps the video
    filters, as the JAX chain does."""
    specs = [n for n in names.split(",")]
    job = Job(filters=[FilterSpec.parse(s) for s in specs])
    jjob = JJob(filters=[JFilterSpec.parse(s) for s in specs])
    chain = VideoChain(job, ImageFormat.YUV420P, W, H)
    jchain = JVideoChain(jjob, JImageFormat.YUV420P, W, H)
    assert ([f.info.name for f in chain.filters]
            == [f.info.name for f in jchain.filters])
    assert chain.is_identity() == jchain.is_identity()


@pytest.mark.parametrize("name", ("normalize", "astat", "lowpass",
                                  "detectsilence", "resample", "aclip"))
def test_unported_audio_filters_still_raise(name):
    """These audio filters were not ported with this slice and raised
    here; the audio track ported them since: the video chain builds each
    and keeps none, the audio chain keeps it."""
    from tcforge_tpu_torch.pipeline.chain import AudioChain
    job = Job(filters=[FilterSpec(name, "")])
    chain = VideoChain(job, ImageFormat.YUV420P, W, H)
    assert chain.filters == [] and chain.is_identity()
    audio = AudioChain(job, torch.device("cpu"))
    assert [f.info.name for f in audio.filters] == [name]


@pytest.mark.parametrize("name", ("logo", "logoaway", "fieldanalysis",
                                  "29to23", "cpaudio", "stabilize",
                                  "transform"))
def test_filters_are_registered_under_their_jax_names(name):
    from tcforge_tpu.modules import registry as jregistry
    cls = registry.lookup(registry.ModuleKind.FILTER, name)
    jcls = jregistry.lookup(jregistry.ModuleKind.FILTER, name)
    assert cls.info.name == name and int(cls.slots) == int(jcls.slots)
    assert cls.info.media == jcls.info.media
    assert ([(p.name, p.fmt, p.default) for p in cls.desc.params]
            == [(p.name, p.fmt, p.default) for p in jcls.desc.params])
    assert (issubclass(cls, registry.AudioFilter)
            == issubclass(jcls, jregistry.AudioFilter))

