"""The port's compressed-audio encoders (``lame``, ``mp2enc`` with its
alias ``toolame``, ``ac3enc``) and the multiplexors that take them, on
the CPU.

The golden is the JAX package with its audio encoders switched to its
in-tree spec encoders (``TCFORGE_NATIVE_MP3ENC``, ``_MP2ENC`` and
``_AC3ENC`` set to 1: its own switches, its route without the FFmpeg
bridge), which the port carries as pinned copies; the bridge's
libmp3lame, twolame and AC-3 bytes are not the port's.  The JAX MP3
encoder raises where a big-values region is all zeros (``_emit`` looks
up table 0's codes, which it does not have); the port codes such a
region in no bits, and the golden runs give the JAX encoder's table 0 an
empty code table (``in_tree_encoders``), which changes nothing where it
does not raise.  Held at tolerance 0:

- each module against the JAX module on 0.1 to 0.25 s of seeded PCM
  with silent and loud runs, at every rate it takes (MPEG-1 and MPEG-2
  rates for MP3 and MP2, 32, 44.1 and 48 kHz for AC-3), 1 and 2
  channels and two bitrates: every payload and the job's extradata;
- the table-0 repair: the JAX encoder raises on such input, the port's
  bytes are the JAX encoder's with table 0 empty, and they decode;
- ``chip_smoke.MJPEGENC_GOLDEN``'s audio cases through both CLIs (the
  DVD-style VOB with AC-3, MP2 in a program stream, AC-3 and MP2 in an
  AVI, MP3 at 44.1 kHz with ``-E`` and ``-b``), each digest pinned for
  ``chip_smoke.py``; the AVI audio tags (``ac3enc``'s AC-3 tagged PCM
  with byte rate 0, as the JAX multiplexor tags it); the program
  streams read back by the port's MPEG importer as the JAX importer
  reads the JAX files;
- the refusals of the encoders the port lacks.
"""

from __future__ import annotations

import contextlib
import struct

import numpy as np
import pytest
import torch

import chip_smoke
from tcforge_tpu.core.frame import AudioBatch as JAudioBatch
from tcforge_tpu.core.job import Job as JJob
from tcforge_tpu.modules import registry as jregistry
from tcforge_tpu_torch.core.frame import AudioBatch
from tcforge_tpu_torch.core.job import Job
from tcforge_tpu_torch.io import mp3dec
from tcforge_tpu_torch.io.avi import AviReader
from tcforge_tpu_torch.modules import registry
from test_torch_mpeg_import import jax_cli, jax_native, port_cli  # noqa: F401

ENC_SWITCHES = ("TCFORGE_NATIVE_MP3ENC", "TCFORGE_NATIVE_MP2ENC",
                "TCFORGE_NATIVE_AC3ENC")
MPA_RATES = (32000, 44100, 48000, 16000, 22050, 24000)
# (module, rates, bitrates in kbit/s)
MODULE_CASES = [("lame", MPA_RATES, (64, 128)),
                ("mp2enc", MPA_RATES, (64, 192)),
                ("ac3enc", (32000, 44100, 48000), (96, 192))]
GOLDEN_HERE = ("dvdauthor_ac3", "mp2_mpg", "ac3_avi", "toolame_avi",
               "lame_44k")


@contextlib.contextmanager
def in_tree_encoders():
    """The JAX package's audio encoders on its in-tree spec encoders (its
    own switches), the MP3 encoder's table 0 an empty code table."""
    import tcforge_tpu.io.mp3enc as jmp3enc
    empty = (np.zeros(256, np.int64), np.zeros(256, np.int64))
    with pytest.MonkeyPatch.context() as mp:
        for name in ENC_SWITCHES:
            mp.setenv(name, "1")
        saved = jmp3enc._VTABS[0]
        jmp3enc._VTABS[0] = empty
        try:
            yield
        finally:
            jmp3enc._VTABS[0] = saved


def level_pcm(seed: int, rate: int, channels: int, seconds: float):
    """Seeded Gaussian noise in ten runs, each at a level from silence to
    loud (chip_smoke.AUDIO_LEVELS): int16 (samples, channels)."""
    rng = np.random.default_rng(seed)
    n = int(rate * seconds)
    levels = rng.choice(np.array(chip_smoke.AUDIO_LEVELS), size=10)
    gain = np.repeat(levels, n // 10 + 1)[:n, None]
    noise = rng.standard_normal((n, channels))
    return np.clip(np.rint(noise * gain), -32768, 32767).astype(np.int16)


def jobs(rate: int, channels: int):
    port, ref = Job(), JJob()
    for job in (port, ref):
        job.a_rate, job.a_chan, job.dm_chan = rate, channels, channels
    return port, ref


def encode_both(name: str, rate: int, channels: int, options: str,
                pcm: np.ndarray, chunk: int):
    """The payloads of the port's module and the JAX module on ``pcm``
    fed in batches of ``chunk``-sample frames, then flushed, and the two
    jobs' extradata."""
    port_job, jax_job = jobs(rate, channels)
    ours = registry.new_module(registry.ModuleKind.ENCODER, name, port_job,
                               options)
    got, want = [], []
    with in_tree_encoders():
        ref = jregistry.new_module(jregistry.ModuleKind.ENCODER, name,
                                   jax_job, options)
        for at in range(0, len(pcm) - chunk + 1, 4 * chunk):
            part = pcm[at:at + 4 * chunk]
            part = part[:len(part) // chunk * chunk].reshape(-1, chunk,
                                                             channels)
            got += ours.encode_audio(AudioBatch(pcm=torch.from_numpy(part)))
            want += ref.encode_audio(JAudioBatch(pcm=part))
        got += ours.flush()
        want += ref.flush()
    return (got, port_job.extradata), (want, jax_job.extradata)


@pytest.mark.parametrize("name,rate,channels,kbps", [
    (name, rate, ch, kbps) for name, rates, kbpss in MODULE_CASES
    for rate in rates for ch in (1, 2) for kbps in kbpss])
def test_the_encoder_modules_match_the_jax_modules(name, rate, channels,
                                                   kbps):
    seconds = 0.25 if rate < 30000 else 0.12
    pcm = level_pcm(rate + channels + kbps, rate, channels, seconds)
    (got, xd), (want, jxd) = encode_both(
        name, rate, channels, f"bitrate={kbps}", pcm,
        int(round(rate / 29.97)))
    assert got == want and len(got) >= 2
    assert xd == jxd
    assert xd["audio_byte_rate"] == struct.pack("<I", kbps * 1000 // 8)


@pytest.mark.parametrize("name,default", [("lame", 128), ("mp2enc", 224),
                                          ("ac3enc", 192)])
def test_the_default_and_job_bitrates_are_the_jax_modules(name, default):
    """No ``bitrate``: the job's ``-b`` (``mp3bitrate``) where set, else
    the module's default."""
    for mp3bitrate, want in ((0, default), (96, 96)):
        port_job, jax_job = jobs(48000, 2)
        port_job.mp3bitrate = jax_job.mp3bitrate = mp3bitrate
        registry.new_module(registry.ModuleKind.ENCODER, name, port_job)
        with in_tree_encoders():
            jregistry.new_module(jregistry.ModuleKind.ENCODER, name,
                                 jax_job)
        assert port_job.extradata == jax_job.extradata
        assert port_job.extradata["audio_byte_rate"] == struct.pack(
            "<I", want * 1000 // 8)


def test_the_mp3_encoder_codes_an_all_zero_region_the_jax_one_raises_on():
    """Silence after noise leaves a big-values region of zeros, which
    the encoder codes with table 0: the JAX encoder looks up that
    table's codes and raises; the port's bytes are the JAX encoder's
    with an empty table 0, and the in-tree decoder reads them back."""
    import tcforge_tpu.io.mp3enc as jmp3enc
    from tcforge_tpu_torch.io.mp3enc import NativeMp3Encoder
    pcm = level_pcm(0, 48000, 2, 0.25)
    ref = jmp3enc.NativeMp3Encoder(48000, 2, 128000)
    with pytest.raises(TypeError):
        ref.feed(pcm)
        ref.flush()
    ours = NativeMp3Encoder(48000, 2, 128000)
    ours.set_framed(True)
    ours.feed(pcm)
    ours.flush()
    got = ours.read_packets()
    with in_tree_encoders():
        ref = jmp3enc.NativeMp3Encoder(48000, 2, 128000)
        ref.set_framed(True)
        ref.feed(pcm)
        ref.flush()
        assert got == ref.read_packets()
    out, rate, channels = mp3dec.decode_stream(b"".join(got))
    assert (rate, channels) == (48000, 2)
    assert out.shape == (1152 * len(got), 2)


def test_toolame_is_the_mp2_encoder():
    assert (registry.lookup(registry.ModuleKind.ENCODER, "toolame")
            is registry.lookup(registry.ModuleKind.ENCODER, "mp2enc"))
    assert jregistry.lookup(jregistry.ModuleKind.ENCODER, "toolame") \
        is jregistry.lookup(jregistry.ModuleKind.ENCODER, "mp2enc")


@pytest.mark.parametrize("name", ["lame", "mp2enc", "ac3enc", "movjpeg"])
def test_the_new_modules_match_the_jax_registry(name):
    ours = registry.lookup(registry.ModuleKind.ENCODER, name)
    ref = jregistry.lookup(jregistry.ModuleKind.ENCODER, name)
    def names(info):
        return (info.media, [c.name for c in info.codecs_in],
                [c.name for c in info.codecs_out])
    assert names(ours.info) == names(ref.info)
    assert ([(p.name, p.fmt, p.default, p.lo, p.hi)
             for p in ours.desc.params]
            == [(p.name, p.fmt, p.default, p.lo, p.hi)
                for p in ref.desc.params])


@pytest.mark.parametrize("name", ["x264", "lavc"])
def test_the_encoders_the_port_lacks_are_refused_by_name(name, tmp_path,
                                                         capsys):
    src, wav = chip_smoke.write_author_inputs(tmp_path, 64, 48, 3)
    rc = port_cli(["-i", str(src), "-p", str(wav), "-o",
                   str(tmp_path / "o.avi"), "-y", f"raw,{name},avi"])
    assert rc == 1
    assert repr(name) in capsys.readouterr().err


# ------------------------------------------------------------------ #
# the CLI goldens

def run_goldens(cases, tmp):
    """Each ``chip_smoke.MJPEGENC_GOLDEN`` case through both CLIs (the
    JAX one on its in-tree encoders): {case: (jax bytes, port bytes,
    the port's argv)}."""
    out = {}
    for case in cases:
        got = {}
        for side, run in (("jax", jax_cli), ("port", port_cli)):
            d = tmp / f"{side}_{case}"
            d.mkdir()
            argv = chip_smoke.mjpegenc_golden_argv(case, d)
            with in_tree_encoders():
                assert run(argv) == 0, (case, side)
            got[side] = (chip_smoke.mjpegenc_golden_output(case, d)
                         .read_bytes(), argv)
        out[case] = (got["jax"][0], got["port"][0], got["port"][1])
    return out


@pytest.fixture(scope="module")
def goldens(tmp_path_factory, jax_native):
    return run_goldens(GOLDEN_HERE, tmp_path_factory.mktemp("audio_enc"))


@pytest.mark.parametrize("case", GOLDEN_HERE)
def test_audio_export_golden_matches_the_jax_cli(case, goldens):
    jax_bytes, port_bytes, argv = goldens[case]
    assert jax_bytes and port_bytes == jax_bytes
    assert chip_smoke.sha256_file(argv[argv.index("-o") + 1]) == \
        chip_smoke.MJPEGENC_GOLDEN_SHA256[case]


@pytest.mark.parametrize("case,tag,byte_rate,rate,channels", [
    ("ac3_avi", 1, 0, 48000, 2), ("toolame_avi", 0x50, 16000, 48000, 1),
    ("lame_44k", 0x55, 12000, 44100, 2)])
def test_the_avi_tags_its_audio_as_the_jax_multiplexor(case, tag, byte_rate,
                                                       rate, channels,
                                                       goldens):
    """lame 0x55 and mp2enc/toolame 0x50 with their byte rates; ac3enc's
    AC-3 into a track tagged PCM with no byte rate, the JAX module's
    quirk (its tag map lacks ac3enc)."""
    argv = goldens[case][2]
    with AviReader(argv[argv.index("-o") + 1]) as r:
        a = r.audio[0]
        assert (a.format_tag, a.byte_rate, a.rate, a.channels) == (
            tag, byte_rate, rate, channels)
        first = next(iter(r.read_audio_chunks(0)))
    sync = {1: b"\x0b\x77", 0x50: b"\xff", 0x55: b"\xff"}[tag]
    assert first.startswith(sync)


@pytest.mark.parametrize("case", ["dvdauthor_ac3", "mp2_mpg"])
def test_the_program_streams_read_back_as_the_jax_importer_reads_them(
        case, goldens, tmp_path):
    """The port's MPEG importer on the port's stream (its AC-3 or MP2
    track through the in-tree decoders) gives what the JAX importer gives
    on the JAX stream with the FFmpeg bridge reported absent."""
    import tcforge_tpu.native.av as av
    argv = goldens[case][2]
    src = argv[argv.index("-o") + 1]
    jax_src = src.replace("port_", "jax_")
    files = {}
    for side, run, path in (("jax", jax_cli, jax_src),
                            ("port", port_cli, src)):
        back, wav = tmp_path / f"{side}.y4m", tmp_path / f"{side}.wav"
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(av, "available", lambda: False)
            assert run(["-i", path, "-x", "mpeg", "-o", str(back), "-m",
                        str(wav)]) == 0
        files[side] = (back.read_bytes(), wav.read_bytes())
    assert files["port"] == files["jax"]
    assert files["port"][0].count(b"FRAME\n") == \
        chip_smoke.MJPEGENC_GOLDEN_FRAMES
    assert len(files["port"][1]) > 44 + 4 * 1602 * 10
