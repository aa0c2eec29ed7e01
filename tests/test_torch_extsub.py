"""The port's extsub (``modules/filters/extsub.py``) against the JAX
filter under ``jax.jit`` on the CPU, tolerance 0.

The subtitles are ``tests/data/dvd``'s: three raw subpicture units
(``small.spu``) and a VobSub pair of two languages (``small.idx`` /
``small.sub``, the second unit of the first language forced) for a
64x48 frame, and the title's pair for 720x480.  The frames are a seeded
clip; each case runs three batches with the frame ids running on, so
that units start and stop inside a batch and across its edge.  Every
option the filter reads is varied: ``track``, ``vertshift``,
``forceshow``, ``forced``, ``timeshift``, ``palette``, ``pre`` and the
reference renderer's class fill (``color1``, ``color2``, ``ca``, ``cb``,
with and without ``antialias``).  The JAX filter blends in float32
inside ``jit``; the same chain is held inside ``VideoChain`` too.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from tcforge_tpu.core.frame import FrameBatch as JFrameBatch
from tcforge_tpu.core.job import FilterSpec as JFilterSpec
from tcforge_tpu.core.job import Job as JJob
from tcforge_tpu.modules.filters import extsub as jextsub
from tcforge_tpu.pipeline.chain import VideoChain as JVideoChain
from tcforge_tpu_torch.core.formats import ImageFormat
from tcforge_tpu_torch.core.frame import FrameBatch
from tcforge_tpu_torch.core.job import FilterSpec, Job
from tcforge_tpu_torch.io.y4m import Y4MReader
from tcforge_tpu_torch.modules import registry
from tcforge_tpu_torch.modules.filters import extsub
from tcforge_tpu_torch.pipeline.chain import VideoChain

DVD = chip_smoke.DVD_DATA
CPU = torch.device("cpu")
NTSC = 30000 / 1001
SPLIT = (5, 7, 6)


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("extsub")
    out = {}
    for w, h, n in ((64, 48, sum(SPLIT)), (720, 480, 24)):
        path = tmp / f"c{w}.y4m"
        chip_smoke.write_motion_y4m(path, w, h, n, seed=w, fps=(30000, 1001))
        with Y4MReader(str(path)) as r:
            out[w] = r.read_batch(n)
    return out


@pytest.fixture(autouse=True)
def _fresh_aa_luts():
    """The JAX antialias caches arrays made inside the first trace."""
    from tcforge_tpu.ops import video as jvideo
    jvideo._aa_luts.cache_clear()
    yield
    jvideo._aa_luts.cache_clear()


def _run(options, planes, w, h, sizes=SPLIT, fps=NTSC):
    """Both filters over batches of ``sizes`` frames; every output
    compared.  Returns the frames that a layer changed."""
    port = extsub.ExtsubFilter(Job(fps=fps), options)
    ref = jextsub.ExtsubFilter(JJob(fps=fps), options)
    assert port.slots == ref.slots
    port.init_state(w, h, ImageFormat.YUV420P, CPU)
    from tcforge_tpu.core.formats import ImageFormat as JImageFormat
    ref.init_state(w, h, JImageFormat.YUV420P)
    apply = jax.jit(ref.apply)
    changed = 0
    k = 0
    for n in sizes:
        batch = [p[k:k + n] for p in planes]
        pout, _ = port.apply(FrameBatch.from_numpy(*batch, device=CPU,
                                                   first_id=k, fps=fps),
                             None)
        jout, _ = apply(JFrameBatch.from_numpy(*batch, first_id=k,
                                               fps=fps), None)
        for got, want in zip(pout.to_numpy(), jout.planes):
            np.testing.assert_array_equal(got, np.asarray(want))
        changed += int((pout.to_numpy()[0] != batch[0]).any(axis=(1, 2))
                       .sum())
        k += n
    return changed


OPTIONS = [
    "subtitle_file={dvd}/small.spu",
    "subtitle_file={dvd}/small.spu:vertshift=20",
    "subtitle_file={dvd}/small.spu:timeshift=250",
    "subtitle_file={dvd}/small.spu:palette=" + ",".join(
        str(16 + 13 * i) for i in range(16)),
    "subtitle_file={dvd}/small.spu:pre=0",
    "subtitle_file={dvd}/small.idx",
    "subtitle_file={dvd}/small.idx:track=1",
    "subtitle_file={dvd}/small.idx:forced=1",
    "subtitle_file={dvd}/small.idx:forceshow=0:timeshift=-100",
    "subtitle_file={dvd}/small.idx:vertshift=100",
    "subtitle_file={dvd}/small.idx:color1=200:color2=40",
    "subtitle_file={dvd}/small.idx:ca=1:cb=2:antialias=0",
    "subtitle_file={dvd}/small.spu:cb=1:color1=90",
    "subtitle_file={dvd}/small.idx:track=1:ca=3:cb=2:antialias=1",
]


@pytest.mark.parametrize("options", OPTIONS)
def test_extsub_matches_the_jitted_jax_filter(clips, options):
    changed = _run(options.format(dvd=DVD), clips[64], 64, 48)
    if "forced=1" not in options and "forceshow=0" not in options:
        assert changed > 0


def test_forced_units_alone(clips):
    """The forced unit alone shows with ``forced=1`` (and with
    ``forceshow=0``), and changes fewer frames than all three."""
    every = _run(f"subtitle_file={DVD}/small.idx", clips[64], 64, 48)
    forced = _run(f"subtitle_file={DVD}/small.idx:forced=1", clips[64],
                  64, 48)
    assert 0 < forced < every


@pytest.mark.parametrize("options", [
    "subtitle_file={dvd}/title.idx",
    "subtitle_file={dvd}/title.idx:vertshift=3:color1=230"])
def test_extsub_at_dvd_width(clips, options):
    assert _run(options.format(dvd=DVD), clips[720], 720, 480,
                sizes=(16, 8)) > 0


def test_extsub_in_the_chain_matches_the_jax_chain(clips):
    """extsub before hqdn3d (the rip's -J) inside VideoChain, the JAX
    chain's step jitted, two batches with the carry threaded."""
    spec = f"subtitle_file={DVD}/small.idx:track=1"
    jchain = JVideoChain(JJob(fps=NTSC, filters=[
        JFilterSpec("extsub", spec), JFilterSpec("hqdn3d", "luma=4.0")]),
        _jfmt(), 64, 48)
    tchain = VideoChain(Job(fps=NTSC, filters=[
        FilterSpec("extsub", spec), FilterSpec("hqdn3d", "luma=4.0")]),
        ImageFormat.YUV420P, 64, 48)
    jstates = jchain.initial_states()
    tstates = tchain.initial_states(CPU)
    k = 0
    for n in (9, 9):
        batch = [p[k:k + n] for p in clips[64]]
        jout, jstates = jchain.trace_step(
            JFrameBatch.from_numpy(*batch, first_id=k, fps=NTSC), jstates)
        tout, tstates = tchain(FrameBatch.from_numpy(
            *batch, device=CPU, first_id=k, fps=NTSC), tstates)
        for got, want in zip(tout.to_numpy(), jout.planes):
            np.testing.assert_array_equal(got, np.asarray(want))
        k += n


def test_a_films_count_of_units_matches_the_jitted_jax_filter(clips,
                                                              tmp_path):
    """Sixty units, one every 100 ms (several a batch, some across its
    edge): the port blends those that meet each batch, the JAX filter
    every one."""
    idx = chip_smoke.film_vobsub(tmp_path, units=60, step_ms=100,
                                 src="small")
    assert _run(f"subtitle_file={idx}", clips[64], 64, 48) > 0


def test_only_the_layers_that_meet_a_batch_blend(clips, tmp_path):
    """A film's VobSub: ``meeting`` names, in file order, exactly the
    layers whose frames meet the batch's ids; a batch that none meets
    comes back as it was, and one without ``id_range`` blends every
    layer to the same bytes."""
    idx = chip_smoke.film_vobsub(tmp_path, units=300)
    port = extsub.ExtsubFilter(Job(fps=NTSC), f"subtitle_file={idx}")
    port.init_state(720, 480, ImageFormat.YUV420P, CPU)
    windows = [layer[:2] for layer in port._layers]
    for lo, hi in ((0, 16), (8, 9), (16, 32), (100, 116), (4000, 4016),
                   (10 ** 6, 10 ** 6 + 16)):
        want = [k for k, (f0, f1) in enumerate(windows)
                if f0 < hi and f1 > lo]
        assert port.meeting(lo, hi).tolist() == want
    assert 0 < len(port.meeting(0, 448)) < 10
    batch = [p[:16] for p in clips[720]]
    for first in (0, 4000):
        fb = FrameBatch.from_numpy(*batch, device=CPU, first_id=first,
                                   fps=NTSC)
        got, _ = port.apply(fb, None)
        every, _ = port.apply(dataclasses.replace(fb, id_range=None), None)
        np.testing.assert_array_equal(got.y.numpy(), every.y.numpy())
        if first:
            assert got is fb


def _jfmt():
    from tcforge_tpu.core.formats import ImageFormat as JImageFormat
    return JImageFormat.YUV420P


@pytest.mark.parametrize("options,message", [
    ("", "subtitle_file= is required"),
    ("subtitle_file={dvd}/small.spu:palette=1,2,3", "16 luma values")])
def test_extsub_refuses_what_the_jax_filter_refuses(options, message):
    for cls, job in ((extsub.ExtsubFilter, Job()),
                     (jextsub.ExtsubFilter, JJob())):
        with pytest.raises(ValueError, match=message):
            cls(job, options.format(dvd=DVD))


def test_extsub_refuses_rgb():
    f = extsub.ExtsubFilter(Job(), f"subtitle_file={DVD}/small.spu")
    with pytest.raises(ValueError, match="YUV420P"):
        f.init_state(64, 48, ImageFormat.RGB24, CPU)


def test_extsub_is_registered_with_the_jax_options():
    cls = registry.lookup(registry.ModuleKind.FILTER, "extsub")
    assert cls is extsub.ExtsubFilter
    assert ([(p.name, p.default) for p in cls.desc.params]
            == [(p.name, p.default) for p in jextsub.ExtsubFilter.desc.params])
    assert cls.slots == jextsub.ExtsubFilter.slots


def test_extsub_reads_the_subtitles_of_a_program_stream(tmp_path):
    """A VOB's own subpicture stream (private stream 1, sub-stream
    0x20): the .sub's packets after a pack header make one."""
    sub = (DVD / "small.sub").read_bytes()
    pack = b"\x00\x00\x01\xba" + bytes([0x44] + [0] * 8 + [0, 0, 0xF8])
    path = tmp_path / "subs.vob"
    path.write_bytes(pack + sub)
    port = extsub.ExtsubFilter(Job(), f"subtitle_file={path}")
    ref = jextsub.ExtsubFilter(JJob(), f"subtitle_file={path}")
    assert len(port.spus) == len(ref.spus) == 3
    for a, b in zip(port.spus, ref.spus):
        np.testing.assert_array_equal(a.bitmap, b.bitmap)
        assert (a.x, a.y, a.pts, a.start_ticks, a.stop_ticks, a.forced) \
            == (b.x, b.y, b.pts, b.start_ticks, b.stop_ticks, b.forced)
