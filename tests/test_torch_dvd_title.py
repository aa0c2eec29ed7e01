"""A DVD's titles in the port, against the JAX package on the CPU: the
IFO navigation (the pinned ``io/ifo.py``), the ``dvd`` importer over the
multi-source importer, directory mode, ``-x auto``'s routing and the
refusals.

The whole-path goldens (``chip_smoke.DVD_GOLDEN``): ``-i VIDEO_TS -x dvd
-T 1`` with extsub and hqdn3d and ``-m`` (the 720x480 rip over its two
VOB files), ``-T 1,2`` (one chapter, cut out by its cells' sectors)
and a directory of two program streams with different audio kinds; each
``.y4m`` and ``.wav`` equal to the JAX CLI's (FFmpeg bridge off), byte
for byte, and pinned for ``chip_smoke.py``.
"""

from __future__ import annotations

import hashlib
import io
import os
from pathlib import Path

import pytest
import torch

import chip_smoke
from tcforge_tpu.io import ifo as jifo
from tcforge_tpu_torch.core.codecs import ContainerFormat
from tcforge_tpu_torch.core.job import Job
from tcforge_tpu_torch.io import ifo as tifo
from tcforge_tpu_torch.modules.registry import ModuleKind, new_module
from tcforge_tpu_torch.pipeline import engine
from test_torch_dvd_audio import bridge_off  # noqa: F401
from test_torch_mpeg_import import jax_cli, jax_native, port_cli  # noqa: F401

DVD = chip_smoke.DVD_DATA
TS = DVD / "VIDEO_TS"
CPU = torch.device("cpu")


# ------------------------------------------------------------------ #
# IFO navigation

def test_title_table_matches_the_jax_parse():
    assert tifo.list_titles(str(TS)) == [
        tifo.DvdTitle(**vars(t)) for t in jifo.list_titles(str(TS))]
    assert tifo.title_vobs(str(TS), 1) == jifo.title_vobs(str(TS), 1)
    assert [os.path.basename(p) for p in tifo.title_vobs(str(TS), 1)] == \
        ["VTS_01_1.VOB", "VTS_01_2.VOB"]


@pytest.mark.parametrize("chapter", [1, 2])
def test_chapter_sectors_match_the_jax_parse(chapter):
    got = tifo.chapter_sectors(str(TS), 1, chapter)
    want = jifo.chapter_sectors(str(TS), 1, chapter)
    assert [(c.first_sector, c.last_sector) for c in got] == \
        [(c.first_sector, c.last_sector) for c in want]
    bufs = [io.BytesIO(), io.BytesIO()]
    assert tifo.extract_sectors(str(TS), 1, got, bufs[0]) == \
        jifo.extract_sectors(str(TS), 1, want, bufs[1])
    assert bufs[0].getvalue() == bufs[1].getvalue()


def test_the_title_has_two_chapters_over_two_files():
    spans = [tifo.chapter_sectors(str(TS), 1, c) for c in (1, 2)]
    sizes = [os.path.getsize(p) for p in tifo.title_vobs(str(TS), 1)]
    assert spans[0][0].first_sector == 0
    assert spans[1][-1].last_sector + 1 == sum(sizes) // tifo.SECTOR
    assert spans[0][-1].last_sector + 1 == spans[1][0].first_sector
    # the second file starts with the second chapter, at its GOP
    assert spans[1][0].first_sector * tifo.SECTOR == sizes[0]
    with pytest.raises(ValueError, match="no chapter 3"):
        tifo.chapter_sectors(str(TS), 1, 3)
    with pytest.raises(ValueError, match="no title 2"):
        tifo.title_vobs(str(TS), 2)


@pytest.mark.parametrize("where", ["disc_root", "VIDEO_TS", "bare"])
def test_find_video_ts_matches_the_jax_lookup(tmp_path, where):
    root = tmp_path / "rip"
    ts = root / "VIDEO_TS" if where != "bare" else root
    ts.mkdir(parents=True)
    (ts / "VTS_01_1.VOB").write_bytes(b"")
    arg = str(root if where != "VIDEO_TS" else ts)
    assert tifo.find_video_ts(arg) == jifo.find_video_ts(arg) == str(ts)


# ------------------------------------------------------------------ #
# the dvd and multi importers

def _dvd(path, **job):
    imp = new_module(ModuleKind.DEMULTIPLEXOR, "dvd", Job(**job))
    imp.open(str(path))
    return imp


def _frames_and_samples(imp, n=5, batches=None):
    """Frames and samples read in batches of ``n`` (at most ``batches``
    of them), the importer closed after."""
    imp.start(CPU)
    frames, samples = 0, 0
    while batches is None or batches > 0:
        got = imp.read_video_batch(n)
        if got is None:
            break
        frames += got["y"].shape[0]
        pcm = imp.read_audio_batch(1602 * got["y"].shape[0])
        samples += 0 if pcm is None else pcm.shape[0]
        batches = None if batches is None else batches - 1
    imp.close()
    return frames, samples


def test_dvd_importer_plays_the_title_and_its_track():
    imp = _dvd(TS, dvd_title=1)
    assert (imp.width, imp.height, imp.audio_rate, imp.audio_channels) == \
        (720, 480, 48000, 2)
    assert _frames_and_samples(imp, 3, batches=1) == (3, 3 * 1602)


def test_a_chapter_spools_and_the_spool_goes_on_close():
    imp = _dvd(TS.parent, dvd_title=1, dvd_chapter1=2)
    spool = imp._spool
    chapter = tifo.chapter_sectors(str(TS), 1, 2)
    assert os.path.getsize(spool) == tifo.SECTOR * sum(
        c.last_sector - c.first_sector + 1 for c in chapter)
    assert _frames_and_samples(imp, 2, batches=1) == (2, 2 * 1602)
    assert not os.path.exists(spool)


def test_directory_mode_routes_to_multi(tmp_path):
    for name in ("1.vob", "2.vob"):
        (tmp_path / name).write_bytes((DVD / "ac3.vob").read_bytes())
    job = Job(video_in_file=str(tmp_path))
    assert engine.video_module(job) == "multi"
    imp = new_module(ModuleKind.DEMULTIPLEXOR, "multi", job)
    imp.open(str(tmp_path))
    frames, samples = _frames_and_samples(imp, 4)
    one = new_module(ModuleKind.DEMULTIPLEXOR, "mpeg", Job())
    one.open(str(DVD / "ac3.vob"))
    single, _ = _frames_and_samples(one, 4)
    assert frames == 2 * single


@pytest.mark.parametrize("order", ["in_turn", "planned_ahead"])
def test_multi_closes_each_file_after_its_last_plan(tmp_path, monkeypatch,
                                                    order):
    """An importer left for the next file keeps its frames on the device
    while a plan of its own waits, and closes once the last has run:
    whether that plan ran before the switch (``in_turn``, as
    ``read_video_batch`` runs them) or after it (``planned_ahead``, as
    the engine's reader thread can run ahead of the main thread)."""
    from tcforge_tpu_torch.modules.importers.mpeg_import import (
        MpegImporter)
    for name in ("1.vob", "2.vob", "3.vob"):
        (tmp_path / name).write_bytes((DVD / "ac3.vob").read_bytes())
    closed = []
    close = MpegImporter.close

    def spy(self):
        closed.append(self)
        close(self)
    monkeypatch.setattr(MpegImporter, "close", spy)
    imp = new_module(ModuleKind.DEMULTIPLEXOR, "multi", Job())
    imp.open(str(tmp_path))
    imp.start(CPU, 32)
    owners = []
    if order == "in_turn":
        while (plan := imp.plan_batch(4)) is not None:
            owners.append(plan.owner)
            assert all(o in closed for o in owners if o is not imp._cur)
            imp.execute(plan)
    else:
        plans = []
        while (plan := imp.plan_batch(4)) is not None:
            plans.append(plan)
        assert closed == []
        for k, plan in enumerate(plans):
            owner = plan.owner
            owners.append(owner)
            imp.execute(plan)
            last = all(p.owner is not owner for p in plans[k + 1:])
            assert (owner in closed) == (last and owner is not imp._cur)
    files = list(dict.fromkeys(owners))
    assert len(files) == 3 and closed == files[:2]
    imp.close()
    assert closed == files


def test_multi_refuses_what_is_not_mpeg(tmp_path):
    (tmp_path / "a.vob").write_bytes((DVD / "ac3.vob").read_bytes())
    chip_smoke.write_test_y4m(tmp_path / "b.y4m", 64, 48, 2, seed=1)
    imp = new_module(ModuleKind.DEMULTIPLEXOR, "multi", Job())
    imp.open(str(tmp_path))
    imp.start(CPU)
    with pytest.raises(NotImplementedError, match="yuv4mpeg"):
        while imp.read_video_batch(8) is not None:
            pass
    imp.close()


@pytest.mark.parametrize("what", ["file", "device"])
def test_dvd_gate_message_is_the_jax_packages(tmp_path, what):
    from tcforge_tpu.core.job import Job as JJob
    from tcforge_tpu.modules.registry import ModuleKind as JKind
    from tcforge_tpu.modules.registry import new_module as jnew
    path = (str(DVD / "ac3.vob") if what == "file"
            else str(tmp_path / "sr0"))
    messages = []
    for make in (lambda: jnew(JKind.DEMULTIPLEXOR, "dvd", JJob()),
                 lambda: new_module(ModuleKind.DEMULTIPLEXOR, "dvd",
                                    Job())):
        with pytest.raises(NotImplementedError) as e:
            make().open(path)
        messages.append(str(e.value))
    assert messages[0] == messages[1]
    assert "no CSS descrambling in this build" in messages[1]


def test_dvd_gate_through_the_cli(tmp_path, caplog):
    rc = port_cli(["-i", str(DVD / "ac3.vob"), "-x", "dvd", "-o",
                   str(tmp_path / "o.y4m")])
    assert rc == 1


# ------------------------------------------------------------------ #
# -x auto

def test_jax_import_modules_table_matches_the_jax_registry():
    import tcforge_tpu.modules  # noqa: F401
    from tcforge_tpu.core.codecs import ContainerFormat as JFormat
    from tcforge_tpu.modules.registry import find_import_module
    want = {f.value: find_import_module(f) for f in JFormat}
    got = {f.value: engine.JAX_IMPORT_MODULES.get(f) for f in
           ContainerFormat}
    assert got == want


@pytest.fixture(scope="module")
def jax_avi(tmp_path_factory, jax_native):
    """A 4-frame 64x48 AVI written by the JAX CLI (-y raw,null,avi)."""
    tmp = tmp_path_factory.mktemp("avi")
    src = tmp / "in.y4m"
    chip_smoke.write_test_y4m(src, 64, 48, 4, seed=3)
    out = tmp / "out.avi"
    assert jax_cli(["-i", str(src), "-o", str(out), "-y",
                    "raw,null,avi"]) == 0
    return out


def test_x_auto_refuses_an_avi_naming_its_module(jax_avi, tmp_path):
    """-x auto takes an AVI to the port's avi import module; a video
    track it cannot decode (the JAX CLI's I420 AVI with its fourcc made
    H264, which the JAX package hands to FFmpeg) is refused naming what
    the port lacks."""
    from tcforge_tpu.io.probe import sniff_magic as jax_sniff
    from tcforge_tpu.core.codecs import ContainerFormat as JFormat
    assert jax_sniff(str(jax_avi)) == JFormat.AVI
    assert engine.video_module(Job(video_in_file=str(jax_avi))) == "avi"
    h264 = tmp_path / "h264.avi"
    h264.write_bytes(jax_avi.read_bytes().replace(b"I420", b"H264"))
    job = Job(video_in_file=str(h264),
              video_out_file=str(tmp_path / "o.y4m"))
    with pytest.raises(NotImplementedError, match="fourcc 'H264'"):
        engine.Pipeline(job, CPU)
    assert port_cli(["-i", str(h264), "-o",
                     str(tmp_path / "o.y4m")]) == 1


@pytest.mark.parametrize("head,kind", [
    (b"YUV4MPEG2 W2 H2 F25:1\n", "y4m"), (b"\x00\x00\x01\xba", "mpeg"),
    (b"\x00\x00\x01\xb3", "mpeg"), (b"junk and more junk", "y4m"),
    (b"fLaC\x00\x00\x00\x22", "flac"), (b"OggS\x00\x02", "ogg")])
def test_x_auto_routes_by_magic(tmp_path, head, kind):
    path = tmp_path / "in"
    path.write_bytes(head + b"\x00" * 4096)
    job = Job(video_in_file=str(path))
    if kind in ("y4m", "mpeg", "flac", "ogg"):
        assert engine.video_module(job) == kind
    else:
        with pytest.raises(NotImplementedError,
                           match=f"the {kind} import module"):
            engine.video_module(job)


# ------------------------------------------------------------------ #
# the CLI

TITLE_CASES = ["rip", "chapter2", "dir"]


@pytest.fixture(scope="module")
def title_outputs(jax_native, bridge_off, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dvd_title")
    out = {}
    for case in TITLE_CASES:
        got = {}
        for key, run in (("jax", jax_cli), ("port", port_cli)):
            stem = tmp / f"{key}_{case}"
            assert run(chip_smoke.dvd_golden_argv(case, tmp, stem)) == 0
            got[key] = tuple(Path(f"{stem}.{ext}").read_bytes()
                             for ext in ("y4m", "wav"))
        out[case] = got
    return out


@pytest.mark.parametrize("case", TITLE_CASES)
@pytest.mark.parametrize("ext", ["y4m", "wav"])
def test_dvd_title_cli_matches_the_jax_cli_byte_for_byte(title_outputs,
                                                         case, ext):
    k = ("y4m", "wav").index(ext)
    got, want = title_outputs[case]["port"][k], title_outputs[case]["jax"][k]
    assert len(got) == len(want) and got == want
    assert hashlib.sha256(got).hexdigest() == \
        chip_smoke.DVD_GOLDEN_SHA256[case][k]


def test_the_rip_keeps_the_title_size_and_its_audio(title_outputs):
    y4m, wav = title_outputs["rip"]["port"]
    assert y4m.startswith(b"YUV4MPEG2 W720 H480 F30000:1001")
    frames = y4m.count(b"FRAME\n")
    assert 20 <= frames <= 28
    assert len(wav) - 44 >= 4 * 1602 * (frames - 2)
