"""The port's export stage (``-y``/``-F``/``-w``, the encoders and the
multiplexors) against the JAX CLI, on the CPU.

Whole paths first: each ``chip_smoke.AUTHOR_GOLDEN`` case through both
CLIs (the JAX one with ``--mesh off``), the same bytes, and the port's
digest pinned for ``chip_smoke.py`` to check on the card: the
``dvdauthor`` path at a small size (1080i-style interlaced content with
its 48 kHz WAV, ``-I 5 -Z -J hqdn3d``, ``-y mpeg2,raw,mpg`` at cfg6's
and cfg8's settings: GOP 15/3, rate control toward 6000 kbit/s, a
program stream with DVD LPCM), ``-y mpeg2,raw,raw`` to an ``.m2v``,
``-y mpeg2`` alone (intra only, 4:2:0 and ``-V yuv422p``), dvd.vob
re-encoded from ``-x mpeg``,
an identity chain (no filter: the encoder still gets its frames), field
pictures with ``-w`` and ``--quantizers``, the ``yuv4mpeg`` encoder and
the raw multiplexor with a frame interval.  The JAX CLI runs once per
case, shared through a module fixture.  Then the port alone: its own
MPEG importer reads the program stream back (the frames, their size and
the LPCM samples), its video and audio do not depend on the batch size, the
flags parse as the JAX CLI parses them, the encoder module reads them as
the JAX module does, the multiplexor follows the output's extension, and
what the port lacks is refused by name.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from tcforge_tpu.cli import args_to_job as jax_args_to_job
from tcforge_tpu.cli import build_parser as jax_build_parser
from tcforge_tpu.modules import registry as jregistry
from tcforge_tpu.modules.encoders.mpeg2 import Mpeg2VideoEncoder as JMpeg2
from tcforge_tpu_torch import cli
from tcforge_tpu_torch.io.wav import WavReader
from tcforge_tpu_torch.modules import registry
from tcforge_tpu_torch.modules.encoders.mpeg2 import Mpeg2VideoEncoder
from tcforge_tpu_torch.ops import kernels
from test_torch_engine import run_cli
from test_torch_mpeg_import import jax_cli, jax_native  # noqa: F401

CASES = list(chip_smoke.AUTHOR_GOLDEN)


def port_cli(argv):
    return run_cli([*argv, "--device", "cpu", "-q", "--progress_off"])


def output_of(argv) -> Path:
    return Path(argv[argv.index("-o") + 1])


@pytest.fixture(scope="module")
def goldens(tmp_path_factory, jax_native):
    """Each case's output from the JAX CLI and from the port's, by case:
    (jax bytes, port bytes, the port's argv)."""
    tmp = tmp_path_factory.mktemp("export")
    out = {}
    for case in CASES:
        files = {}
        for side, run in (("jax", jax_cli), ("port", port_cli)):
            argv = chip_smoke.author_golden_argv(case, tmp,
                                                 tmp / f"{case}_{side}")
            assert run(argv) == 0, (case, side)
            files[side] = (output_of(argv).read_bytes(), argv)
        out[case] = (files["jax"][0], files["port"][0], files["port"][1])
    return out


@pytest.mark.parametrize("case", CASES)
def test_export_golden_matches_the_jax_cli_byte_for_byte(case, goldens):
    jax_bytes, port_bytes, argv = goldens[case]
    assert jax_bytes and port_bytes == jax_bytes
    assert chip_smoke.sha256_file(output_of(argv)) == \
        chip_smoke.AUTHOR_GOLDEN_SHA256[case]


def test_the_program_stream_reads_back(goldens, tmp_path):
    """The port's MPEG importer reads the dvdauthor stream: every frame,
    at the zoomed size, and the LPCM track carries the WAV's samples."""
    argv = goldens["dvdauthor"][2]
    back, wav = tmp_path / "back.y4m", tmp_path / "back.wav"
    assert port_cli(["-i", str(output_of(argv)), "-o", str(back), "-m",
                     str(wav)]) == 0
    with open(back, "rb") as f:
        header = f.readline()
        frames = f.read().count(b"FRAME\n")
    assert b" W96 H64 " in header
    assert frames == chip_smoke.AUTHOR_GOLDEN_FRAMES
    with WavReader(argv[argv.index("-p") + 1]) as r:
        want = r.read_samples(r.total_samples)
    with WavReader(str(wav)) as r:
        assert (r.info.rate, r.info.channels) == (48000, 2)
        got = r.read_samples(r.total_samples)
    assert got.shape[0] >= 10 * chip_smoke.AUTHOR_SPF
    assert np.array_equal(got, want[:got.shape[0]])


def streams(path):
    """A program stream's video elementary stream and its LPCM samples'
    bytes (each packet's payload after its 7-byte private header)."""
    from tcforge_tpu_torch.io import mpeg
    video, lpcm = [], []
    for sid, payload in mpeg.iter_pes_packets(str(path)):
        if sid == 0xE0:
            video.append(payload)
        elif sid == 0xBD:
            lpcm.append(payload[7:])
    return b"".join(video), b"".join(lpcm)


@pytest.mark.parametrize("batch", [1, 3, 16])
def test_the_streams_do_not_depend_on_the_batch(batch, goldens, tmp_path):
    """Batches of 1 and 3 (a last batch of one, batch ends inside B runs)
    give the video and the audio of the default 16; only the packets'
    interleaving follows the batches, as in the JAX engine."""
    argv = list(goldens["dvdauthor"][2])
    argv[argv.index("-o") + 1] = str(tmp_path / "o.mpg")
    assert port_cli([*argv, "--batch", str(batch), "--prefetch", "1"]) == 0
    want = streams(output_of(goldens["dvdauthor"][2]))
    assert streams(tmp_path / "o.mpg") == want
    assert len(want[0]) > 10_000 and len(want[1]) > 100_000


def test_an_identity_chain_encodes_without_the_y4m_writer(goldens):
    """No filter and no transform: the frames still reach the encoder
    (the engine's identity shortcut keeps host batches only for a
    host encoder), and the stream is the JAX CLI's."""
    jax_bytes, port_bytes, _ = goldens["identity"]
    assert port_bytes == jax_bytes
    assert port_bytes.startswith(b"\x00\x00\x01\xb3")
    assert port_bytes.endswith(b"\x00\x00\x01\xb7")


@pytest.mark.cuda
def test_an_identity_chain_launches_the_encoder_kernels_on_cuda(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    argv = chip_smoke.author_golden_argv("identity", tmp_path,
                                         tmp_path / "o")
    kernels.reset_launches()
    assert run_cli([*argv, "--device", "cuda", "-q", "--progress_off"]) == 0
    for name in chip_smoke.ENCODE_KERNELS:
        assert kernels.launches[name] > 0, name
    assert chip_smoke.sha256_file(output_of(argv)) == \
        chip_smoke.AUTHOR_GOLDEN_SHA256["identity"]


@pytest.mark.parametrize("route", ["copy,raw,y4m"])
def test_the_y4m_multiplexor_writes_the_y4m_writers_bytes(route, goldens,
                                                         tmp_path):
    """The y4m multiplexor behind another encoder (``copy``: the frames'
    planes) writes the bytes of the default route's Y4M writer, which the
    other CLI tests hold to the JAX CLI."""
    argv = goldens["yuv4mpeg"][2]
    src = argv[argv.index("-i") + 1]
    want, got = tmp_path / "default.y4m", tmp_path / "routed.y4m"
    assert port_cli(["-i", src, "-J", "hqdn3d", "-o", str(want)]) == 0
    assert port_cli(["-i", src, "-J", "hqdn3d", "-y", route, "-o",
                     str(got)]) == 0
    assert got.read_bytes() == want.read_bytes()


def test_the_null_route_encodes_and_writes_nothing(goldens, tmp_path):
    argv = goldens["yuv4mpeg"][2]
    out = tmp_path / "o.m2v"
    assert port_cli(["-i", argv[argv.index("-i") + 1], "-y",
                     "null,null,null", "-o", str(out)]) == 0
    assert not out.exists()


# ------------------------------------------------------------------ #
# flags, modules and refusals

@pytest.mark.parametrize("argv", [
    [], ["-y", "mpeg2"], ["-y", "mpeg2,raw,mpg"],
    ["-y", "mpeg2=gop_n=6,null,raw=x"], ["-F", "gop_n=12:gop_m=3"],
    ["-F", "mpg2"], ["-w", "3000"], ["-w", "3000,30"],
    ["--video_max_bitrate", "9000"], ["--quantizers", "4,20"],
    ["--encode_fields", "t"], ["--encode_fields", "b"],
    ["--encode_fields", "p"], ["--pulldown"]])
def test_export_flags_parse_like_the_jax_cli(argv):
    base = ["-i", "a.y4m", "-o", "b.m2v"]
    port = cli.args_to_job(cli.build_parser().parse_args(base + argv))
    ref = jax_args_to_job(jax_build_parser().parse_args(base + argv))
    for field in ("ex_v_module", "ex_v_string", "ex_a_module", "ex_a_string",
                  "ex_m_module", "ex_m_string", "ex_v_fcc", "bitrate",
                  "keyframes", "rc_requested", "video_max_bitrate",
                  "min_quantizer", "max_quantizer", "encode_fields",
                  "pulldown"):
        assert getattr(port, field) == getattr(ref, field), field


def test_bad_quantizers_are_refused():
    for parse in ((lambda a: cli.args_to_job(cli.build_parser()
                                            .parse_args(a))),
                  (lambda a: jax_args_to_job(jax_build_parser()
                                             .parse_args(a)))):
        with pytest.raises(ValueError, match="quantizers"):
            parse(["-i", "a", "-o", "b", "--quantizers", "0,40"])


@pytest.mark.parametrize("options,flags", [
    ("", []), ("gop_n=15:gop_m=3", ["-w", "2500"]),
    ("gop_n=15:gop_m=3:bitrate=4000", ["-w", "2500"]),
    ("gop_n=15:gop_m=3:rc=0", ["-w", "2500"]),
    ("gop_n=6:gop_m=3", ["--encode_fields", "b"]),
    ("gop_n=6:gop_m=3:fields=0", ["--encode_fields", "t"]),
    ("dpict=1", []), ("mpeg1=1:alt_scan=1:range=16", [])])
def test_the_encoder_module_reads_the_job_as_the_jax_module(options, flags):
    base = ["-i", "a.y4m", "-o", "b.m2v", *flags]
    port_job = cli.args_to_job(cli.build_parser().parse_args(base))
    jax_job = jax_args_to_job(jax_build_parser().parse_args(base))
    ours, ref = Mpeg2VideoEncoder(port_job, options), JMpeg2(jax_job, options)
    assert ours.options == ref.options
    assert ours._top_field_first == ref._top_field_first


@pytest.mark.parametrize("ext", [".y4m", ".wav", ".raw", ".yuv", ".m2v",
                                 ".m1v", ".es", ".mpg", ".mpeg", ".vob",
                                 ".avi", ".ogg", ".mkv", ".mov", ""])
def test_the_multiplexor_follows_the_extension_as_in_jax(ext):
    want = jregistry.find_mux_module_for_path("out" + ext)
    assert registry.jax_mux_module_for_path("out" + ext) == want
    got = registry.find_mux_module_for_path("out" + ext)
    assert got == (want if want in ("y4m", "wav", "raw", "mpg", "avi",
                                    "mov", "ogg")
                   else None)


@pytest.mark.parametrize("name", ["raw", "null", "copy", "yuv4mpeg",
                                  "mpeg2", "xvid"])
def test_encoders_match_the_jax_registry(name):
    ours = registry.lookup(registry.ModuleKind.ENCODER, name)
    ref = jregistry.lookup(jregistry.ModuleKind.ENCODER, name)
    assert ours.info.media == ref.info.media
    assert ([(p.name, p.default) for p in ours.desc.params]
            == [(p.name, p.default) for p in ref.desc.params])


@pytest.mark.parametrize("argv,message", [
    (["-o", "{tmp}/o.mkv", "-y", "mpeg2"], "lavf multiplexor"),
    (["-o", "{tmp}/o.m2v", "-y", "x264"], "x264")])
def test_what_the_port_lacks_is_refused_by_name(argv, message, tmp_path,
                                                capsys):
    src = tmp_path / "in.y4m"
    chip_smoke.write_motion_y4m(src, 64, 48, 3, seed=1)
    argv = ["-i", str(src), *(a.replace("{tmp}", str(tmp_path))
                              for a in argv)]
    try:
        rc = port_cli(argv)
    except SystemExit as e:
        rc = e.code
    assert rc != 0
    assert message in capsys.readouterr().err


def test_lpcm_needs_a_dvd_rate(tmp_path, capsys):
    """The program stream's LPCM takes 48, 96, 44.1 or 32 kHz, as the JAX
    multiplexor refuses the others."""
    src, wav = tmp_path / "in.y4m", tmp_path / "in.wav"
    chip_smoke.write_motion_y4m(src, 64, 48, 3, seed=2)
    chip_smoke.write_test_wav(wav, 3 * 735, seed=2, rate=22050, frame=735)
    assert port_cli(["-i", str(src), "-p", str(wav), "-o",
                     str(tmp_path / "o.mpg"), "-y", "mpeg2,raw,mpg"]) == 1
    assert "DVD rate" in capsys.readouterr().err


# ------------------------------------------------------------------ #
# the synthetic source (cfg6's input)

def test_framegen_through_both_clis(tmp_path, jax_native):
    """``-x framegen``: its colour wave through hqdn3d to a Y4M, its pink
    noise (the source's own track) to ``-m``'s WAV."""
    files = {}
    for side, run in (("jax", jax_cli), ("port", port_cli)):
        out, wav = tmp_path / f"{side}.y4m", tmp_path / f"{side}.wav"
        assert run(["-i", "test://", "-x", "framegen=frames=20", "-o",
                    str(out), "-m", str(wav), "-J", "hqdn3d"]) == 0
        files[side] = (out.read_bytes(), wav.read_bytes())
    assert files["port"] == files["jax"]
    assert len(files["port"][1]) > 20 * 1600 * 4


def test_cfg6_job_through_both_engines(tmp_path, jax_native):
    """cfg6's job (``benches/run_configs.py:277-310``: the synthetic
    source, the MPEG-2 encoder at GOP 15/3 with rate control toward 6000
    kbit/s, the raw multiplexor), cut to 96x64 and 20 frames, through
    both engines' ``Pipeline``: the same elementary stream."""
    from tcforge_tpu.core.job import Job as JJob
    from tcforge_tpu.pipeline.engine import Pipeline as JPipeline
    from tcforge_tpu_torch.core.job import Job
    from tcforge_tpu_torch.pipeline.engine import Pipeline
    from test_torch_engine import run_engine

    def job(cls, out):
        j = cls(video_in_file="test://", video_out_file=str(out),
                im_v_module="framegen", ex_v_module="mpeg2",
                ex_m_module="raw", im_v_width=96, im_v_height=64,
                fps=29.97, max_frames=20, batch_size=16)
        j.ex_v_fcc = "gop_n=15:gop_m=3:rc=1:bitrate=6000"
        return j

    JPipeline(job(JJob, tmp_path / "jax.m2v")).run(progress=False)
    run_engine(Pipeline(job(Job, tmp_path / "port.m2v"),
                        torch.device("cpu")))
    want = (tmp_path / "jax.m2v").read_bytes()
    assert want and (tmp_path / "port.m2v").read_bytes() == want
