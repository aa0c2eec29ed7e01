"""The engine's audio routes on the CPU, against the JAX engine at
tolerance 0: a source's own track without ``-m``, ``-m`` through any
multiplexor the port has, audio-only sessions through ``-y``'s encoder
and multiplexor, ``-p`` from any container the port imports, and the
audio flags of the CLI.

The golden route is the JAX CLI (``--mesh off``) with its FFmpeg bridge
reported built and its audio decoders replaced by its in-tree ones
(``test_torch_ts.in_tree_bridge``), and its encoders forced to their
in-tree routes by their own switches (``golden_route``).

- the queue of mixes whose source's own track the port dropped without
  ``-m`` (``chip_smoke.ROUTE_GOLDEN`` up to ``late_track``: program
  streams, the DVD title, transport streams, PSU mode, ``multi``, 4:2:2,
  VideoCD, and a program stream whose track starts after the windowed
  reader's discovery budget, which both engines drop) through both
  CLIs, each digest pinned for ``chip_smoke.py``;
- ``-m``'s multiplexor by extension as the JAX engine's aux muxer (the
  ones the port lacks refused by name), the audio-only session's refusal
  of a video-only multiplexor, the demux decision and the warning of a
  dropped track, ``-p``'s module by magic;
- ``-e``, ``-n``, ``-A``, ``-M`` and ``--a52_*`` parsed as the JAX CLI
  parses them, ``-e`` winning over the probe.
"""

from __future__ import annotations

import contextlib
import logging
from pathlib import Path

import pytest
import torch

import chip_smoke
from tcforge_tpu.cli import args_to_job as jax_args_to_job
from tcforge_tpu.cli import build_parser as jax_build_parser
from tcforge_tpu.modules import registry as jregistry
from tcforge_tpu_torch import cli
from tcforge_tpu_torch.core.job import Job
from tcforge_tpu_torch.modules import registry
from tcforge_tpu_torch.pipeline import engine
from test_torch_audio_encode import in_tree_encoders
from test_torch_mpeg_import import jax_cli, jax_native, port_cli  # noqa: F401
from test_torch_ts import in_tree_bridge

CPU = torch.device("cpu")
DVD = chip_smoke.DVD_DATA
TS = chip_smoke.TS_DATA
# the JAX encoders' switches beyond in_tree_encoders', and the MPEG-4
# decoder's and encoder's
SWITCHES = ("TCFORGE_NATIVE_AACENC", "TCFORGE_NATIVE_FLAC",
            "TCFORGE_NATIVE_MPEG4", "TCFORGE_NATIVE_MPEG4ENC")


@contextlib.contextmanager
def golden_route():
    """The JAX package on its in-tree decoders and encoders."""
    with in_tree_bridge(), in_tree_encoders(), \
            pytest.MonkeyPatch.context() as mp:
        for name in SWITCHES:
            mp.setenv(name, "1")
        yield


def run_route_goldens(cases, tmp) -> dict:
    """Each ``chip_smoke.ROUTE_GOLDEN`` case through both CLIs, in order,
    each side in a directory of its own: {case: {"jax": (rc, outputs),
    "port": (rc, outputs)}}, each output bytes (a missing file None)."""
    tmp = Path(tmp)
    inputs = tmp / "inputs"
    inputs.mkdir()
    out = {}
    for case in cases:
        got = {}
        for side, run in (("jax", jax_cli), ("port", port_cli)):
            d = tmp / side / case
            d.mkdir(parents=True)
            with golden_route():
                rc = run(chip_smoke.route_golden_argv(case, d, inputs))
            got[side] = (rc, [f.read_bytes() if f.exists() else None
                              for f in chip_smoke.route_golden_outputs(
                                  case, d)])
        out[case] = got
    return out


QUEUE = list(chip_smoke.ROUTE_GOLDEN)[
    :list(chip_smoke.ROUTE_GOLDEN).index("late_track") + 1]


@pytest.fixture(scope="module")
def goldens(tmp_path_factory, jax_native):
    return run_route_goldens(QUEUE, tmp_path_factory.mktemp("routes"))


@pytest.mark.parametrize("case", QUEUE)
def test_the_sources_own_track_golden_matches_the_jax_cli(case, goldens):
    got = goldens[case]
    assert got["port"] == got["jax"], case
    rc, files = got["port"]
    assert rc == chip_smoke.ROUTE_GOLDEN[case][3] and None not in files
    digests = tuple(chip_smoke.hashlib.sha256(b).hexdigest() for b in files)
    assert digests == chip_smoke.ROUTE_GOLDEN_SHA256[case]


@pytest.mark.parametrize("case,tag", [("lpcm_avi", 1), ("ac3_lame_avi", 0x55),
                                      ("ts_ac3_avi", 1),
                                      ("ts_midpes_avi", 0x55),
                                      ("vcd_xvid_avi", 0x55)])
def test_each_avi_holds_the_sources_track(case, tag, goldens, tmp_path):
    from tcforge_tpu_torch.io.avi import AviReader
    path = tmp_path / "o.avi"
    path.write_bytes(goldens[case]["port"][1][0])
    with AviReader(str(path)) as r:
        assert len(r.audio) == 1 and r.audio[0].format_tag == tag
        assert sum(len(c) for c in r.read_audio_chunks(0)) > 0


def test_the_late_track_is_dropped_and_the_early_one_kept(goldens):
    """The same program stream with 256 KB windows: the track is in the
    first window, so the session takes it (an MPEG audio stream in the
    program stream); with 4 KB windows it comes after the discovery
    budget and both engines drop it."""
    late = goldens["late_track"]["port"][1][0]
    assert b"\x00\x00\x01\xc0" not in late


def test_the_late_track_is_kept_with_wide_windows(tmp_path, jax_native):
    src = chip_smoke.route_input("{late}", tmp_path)
    out = tmp_path / "o.mpg"
    assert port_cli(["-i", str(src), "-y", "mpeg2,mp2enc,mpg", "-o",
                     str(out)]) == 0
    assert b"\x00\x00\x01\xc0" in out.read_bytes()


# ------------------------------------------------------------------ #
# the engine's choices, without a run

M_EXTENSIONS = [".wav", ".ogg", ".ogm", ".avi", ".mpg", ".vob", ".raw",
                ".m2v", ".mp3", ".mp2", ".ac3", ".aac", "", ".y4m", ".mov",
                ".mkv", ".mp4", ".flac", ".nuv", ".pvn", ".ppm", ".ts"]


@pytest.mark.parametrize("ext", M_EXTENSIONS)
def test_minus_m_takes_the_jax_aux_multiplexor(ext):
    """``find_mux_module_for_path(-m) or "wav"``, as the JAX engine; one
    the port lacks is refused by its name."""
    path = "out/a" + ext
    want = jregistry.find_mux_module_for_path(path) or "wav"
    job = Job(audio_out_file=path)
    if want in registry._REGISTRIES[registry.ModuleKind.MULTIPLEXOR]:
        assert engine._aux_module(job) == want
    else:
        with pytest.raises(NotImplementedError,
                           match=f"-m {path}: the {want} multiplexor"):
            engine._aux_module(job)


AUDIO_ONLY_MUXES = ["wav", "y4m", "avi", "raw", "null", "mpg", "ogg",
                    "mov"]


@pytest.mark.parametrize("mux", AUDIO_ONLY_MUXES)
def test_an_audio_only_session_refuses_a_video_only_muxer_as_jax(
        mux, tmp_path):
    """An audio file into ``-y``'s multiplexor: the JAX ValueError where
    it is video-only and no -m is given, else a session."""
    from tcforge_tpu.pipeline.engine import Pipeline as JPipeline
    wav = tmp_path / "a.au"
    chip_smoke.write_au(wav, torch.zeros(100, 2, dtype=torch.int16)
                        .numpy(), 8000)
    argv = ["-i", str(wav), "-o", str(tmp_path / "o.out"), "-y",
            f"raw,raw,{mux}"]
    job = cli.job_from_argv(argv)
    jjob = jax_args_to_job(jax_build_parser().parse_args(argv))
    jjob.a_rate, jjob.a_chan = job.a_rate, job.a_chan
    errors = []
    for make in (lambda: engine.Pipeline(job, CPU),
                 lambda: JPipeline(jjob)):
        try:
            pipe = make()
        except ValueError as e:
            errors.append(str(e))
        else:
            errors.append(None)
            for imp in (pipe._opened if hasattr(pipe, "_opened")
                        else [pipe.importer]):
                imp.close()
    assert errors[0] == errors[1]
    media = registry.lookup(registry.ModuleKind.MULTIPLEXOR, mux).info.media
    assert (errors[0] is not None) == (media == "video")


DEMUX_CASES = [
    # (arguments, the port demuxes the track, it is the session's)
    (["-y", "raw,raw,avi"], True, True),
    (["-y", "mpeg2,mp2enc,mpg"], True, True),
    (["-y", "raw,raw,raw"], True, True),
    (["-y", "raw,raw,null"], True, True),
    (["-y", "mpeg2,raw,y4m"], False, False),
    ([], False, False),
    (["-m", "{tmp}/a.wav"], True, True),
    (["-p", str(TS / "a.ac3"), "-y", "raw,raw,avi"], False, False),
]


@pytest.mark.parametrize("argv,demuxed,source", DEMUX_CASES)
def test_the_track_is_demuxed_where_the_session_takes_it(
        argv, demuxed, source, tmp_path, jax_native):
    """lpcm.vob's own track: demuxed with -m or a multiplexor that takes
    audio (no -p), and then the session's audio as in the JAX engine,
    which takes the importer as its audio source (``audio_importer is
    importer``) unless -p or a video-only multiplexor rules it out."""
    from tcforge_tpu.pipeline.engine import Pipeline as JPipeline
    argv = ["-i", str(DVD / "lpcm.vob"), "-o", str(tmp_path / "o.y4m"),
            *(a.replace("{tmp}", str(tmp_path)) for a in argv)]
    job = cli.job_from_argv(argv)
    pipe = engine.Pipeline(job, CPU)
    try:
        imp = pipe.video_importer
        assert imp.demux_audio == demuxed
        assert (pipe.audio_importer is imp) == source
    finally:
        for i in pipe._opened:
            i.close()
    jpipe = JPipeline(jax_args_to_job(jax_build_parser().parse_args(argv)))
    try:
        assert (jpipe.audio_importer is jpipe.importer) == source
    finally:
        jpipe.importer.close()
        if jpipe.audio_importer not in (None, jpipe.importer):
            jpipe.audio_importer.close()


@pytest.mark.parametrize("argv", [[], ["-y", "mpeg2,raw,y4m"]])
def test_a_dropped_track_warns_as_the_jax_engine(argv, tmp_path, caplog,
                                                 jax_native):
    """No -m and a video-only multiplexor: the track is dropped with the
    JAX engine's warning (the port does not demux it at all)."""
    job = cli.job_from_argv(["-i", str(DVD / "lpcm.vob"), "-o",
                             str(tmp_path / "o.y4m"), *argv])
    with caplog.at_level(logging.WARNING, logger="tcforge_tpu_torch"):
        pipe = engine.Pipeline(job, CPU)
    for imp in pipe._opened:
        imp.close()
    assert "is video-only and no -m given: audio disabled" in caplog.text
    assert pipe.audio_importer is None and pipe.achain is None


@pytest.mark.parametrize("name,module", [
    ("ac3.vob", "mpeg"), ("lpcm.vob", "mpeg"), ("a.ac3", "ac3"),
    ("a.flac", "flac"), ("legacy.avi", "avi"), ("jpeg.mov", "mov")])
def test_p_takes_the_module_the_jax_engine_takes(name, module):
    from tcforge_tpu.io.probe import probe_file
    path = next(d / name for d in (DVD, TS, chip_smoke.MJPEG_DATA)
                if (d / name).is_file())
    assert engine.audio_module(str(path)) == module
    assert jregistry.find_import_module(probe_file(str(path)).magic) \
        == module


# ------------------------------------------------------------------ #
# the audio flags

@pytest.mark.parametrize("argv", [
    ["-e", "44100"], ["-e", "22050,8"], ["-e", "32000,16,1"],
    ["-e", "8000,,2"], ["-n", "0x2000"], ["-n", "55"], ["-A"],
    ["-M", "2"], ["--a52_demux"], ["--a52_drc_off", "--a52_dolby_off"],
    ["--a52_demux", "--a52_drc_off", "--a52_dolby_off", "-A", "-e",
     "48000,24,6", "-n", "0x1"]])
def test_the_audio_flags_parse_like_the_jax_cli(argv):
    base = ["-i", "a.y4m", "-o", "b.y4m"]
    port = cli.args_to_job(cli.build_parser().parse_args(base + argv))
    ref = jax_args_to_job(jax_build_parser().parse_args(base + argv))
    for field in ("a_rate", "a_bits", "a_chan", "a_codec_flag",
                  "a52_mode"):
        assert getattr(port, field) == getattr(ref, field), field
    assert port.im_a_codec.value == ref.im_a_codec.value


def test_minus_e_wins_over_the_probe():
    """The probe sets a.ac3's 48 kHz stereo; -e, applied again after it
    as in the JAX CLI, sets 22050 Hz mono, 8 bits."""
    job = cli.job_from_argv(["-i", str(TS / "a.ac3"), "-o", "o.wav",
                             "-e", "22050,8,1"])
    assert (job.a_rate, job.a_bits, job.a_chan) == (22050, 8, 1)
    job = cli.job_from_argv(["-i", str(TS / "a.ac3"), "-o", "o.wav"])
    assert (job.a_rate, job.a_chan) == (48000, 2)
