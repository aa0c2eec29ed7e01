"""A DVD's audio tracks in the port, against the JAX package on the CPU.

- the fixtures of ``tests/data/dvd`` (``make_streams.py`` there), each
  pinned by SHA-256;
- the pinned copies of the in-tree decoders against their sources'
  modules: the AC-3 decoder on the crafted dither-free frames of
  ``tests/test_a52.py`` and on streams of the JAX package's AC-3 encoder
  with its dither on (the LFSR is deterministic, so tolerance 0), MPEG
  audio Layers I (crafted), II (the JAX encoder, MPEG-1 and MPEG-2 LSF
  rates, mono and stereo) and III through the stream decoder, and VAG
  ADPCM;
- the importer's demux, windowed and whole-file, against the JAX
  importer over batch sizes, ``-a`` and the LPCM rate codes, and on a
  program stream with ten seconds of AC-3, whose results outgrow the
  decode process's pipes (windowed, whole-file, and ``-L`` and
  ``stream=0`` through both CLIs);
- the CLI: the port's ``.y4m`` and ``.wav`` against the JAX CLI's, byte
  for byte, on ``chip_smoke.DVD_GOLDEN``'s program-stream cases (LPCM,
  MP2 and AC-3 tracks, ``-a 1``, ``-p`` WAV beside MPEG video, ``-L``
  with the track, subtitles), each output's SHA-256 pinned for
  ``chip_smoke.py`` to check on the card.

The JAX CLI and importer run with the FFmpeg bridge reported absent
(``tcforge_tpu.native.av.available`` patched to False), so that they
decode with the in-tree decoders that the port copies; the native MPEG
parse stays on.
"""

from __future__ import annotations

import hashlib
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from tcforge_tpu.io import a52dec as ja52
from tcforge_tpu.io import mp2dec as jmp2
from tcforge_tpu.io import vag as jvag
from tcforge_tpu_torch.core.job import Job
from tcforge_tpu_torch.io import a52dec as ta52
from tcforge_tpu_torch.io import mp2dec as tmp2
from tcforge_tpu_torch.io import vag as tvag
from tcforge_tpu_torch.modules.registry import ModuleKind, new_module
from test_torch_engine import _in_thread
from test_torch_mpeg_import import jax_cli, jax_native, port_cli  # noqa: F401

DVD = chip_smoke.DVD_DATA
CPU = torch.device("cpu")

FIXTURES = {
    "VIDEO_TS/VIDEO_TS.IFO":
        "e8714bd679ffe2af4ccf243d219684211a4f5e66fb1caa7788d0f2b867bc5dbe",
    "VIDEO_TS/VTS_01_0.IFO":
        "4a5a86dc4f701c192b0c58a5bb66bc3133cbca877019c80922c649e20ef6f18a",
    "VIDEO_TS/VTS_01_1.VOB":
        "3c0b893d0b29614c8609407c6cca78d2f0d0f2a54962f0c33b51c0755507fb4b",
    "VIDEO_TS/VTS_01_2.VOB":
        "8cd04c740d05f44b191a8e8993518a00e3252bdd027b158ca3d0608f84e38171",
    "ac3.vob":
        "6ae7a9d3c7ce2bd70a878821c1187d9d1035da3a8cefa72a641ec8bb42584b2a",
    "ac3x2.vob":
        "eb36e4416add6c823e3cde952c5d5cbabc9e991faece034a20d1fffeea11378e",
    "lpcm.vob":
        "3892f579bfc9377923d6cd87ec6b53d93471b86752a0ee3410c1f01fb98a6107",
    "mp2.vob":
        "ae1759664dc19063dc1379d575c5186d865c01dba23b6940f34723632e045bde",
    "small.idx":
        "773e2b07aaa26a037412594dfe683cc006be938186ad268f54dbaf0758738c32",
    "small.spu":
        "12e4eaaa568b7239c8fda8f68a51ceecb453310b3d5dd2f9210fdf66f01fba0a",
    "small.sub":
        "0d89e4e8cbd2460a2ac266465e4434978fe1f0ca45ba1a25c8d59c9377bf6a1b",
    "title.idx":
        "d157d548d7045cb2da8ddef674681f80d79f7d7fbcaa2ff856c2384c1cecf391",
    "title.sub":
        "5b4c849b629ba7537ae1a3fd508f7ebca27c1ef140d3aedf44894b4bfa47f0f1",
}


@pytest.fixture(scope="module")
def bridge_off():
    """The JAX package's FFmpeg bridge reported absent for the module's
    tests: its importers and encoders take the in-tree codecs."""
    import tcforge_tpu.native.av as av
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(av, "available", lambda: False)
        yield


@pytest.mark.parametrize("rel", sorted(FIXTURES))
def test_fixtures_are_the_pinned_files(rel):
    data = (DVD / rel).read_bytes()
    assert hashlib.sha256(data).hexdigest() == FIXTURES[rel]


def test_fixture_directory_stays_small():
    assert sum(p.stat().st_size for p in DVD.rglob("*")
               if p.is_file() and "__pycache__" not in p.parts) < 400_000


# ------------------------------------------------------------------ #
# the decoders

def _crafted_frames():
    import test_a52 as t
    return {
        "expstr1": t.craft_frame([t._rwalk(253, 7, gs=1)], expstr=1,
                                 chbw=(60,)),
        "expstr2": t.craft_frame([t._rwalk(253, 7, gs=2)], expstr=2,
                                 chbw=(60,)),
        "expstr3": t.craft_frame([t._rwalk(253, 7, gs=4)], expstr=3,
                                 chbw=(60,)),
        "bacods0": t.craft_frame([t._rwalk(217, 3)],
                                 bacods=(0, 0, 0, 0, 0)),
        "bacods1": t.craft_frame([t._rwalk(217, 3)],
                                 bacods=(3, 3, 3, 3, 6)),
        "bacods2": t.craft_frame([t._rwalk(217, 3)],
                                 bacods=(2, 1, 1, 3, 7)),
        "coupling": t.craft_cpl(),
        "coupling_expstr2": t.craft_cpl(cpl_expstr=2),
    }


CRAFTED = ("expstr1", "expstr2", "expstr3", "bacods0", "bacods1",
           "bacods2", "coupling", "coupling_expstr2")


@pytest.fixture(scope="module")
def crafted():
    return _crafted_frames()


@pytest.mark.parametrize("name", CRAFTED)
def test_a52_copy_decodes_crafted_frames_as_the_jax_module(crafted, name):
    frame = crafted[name]
    assert frame is not None
    want = ja52.decode_stream(frame * 3, dither=False)
    got = ta52.decode_stream(frame * 3, dither=False)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]


def _tone(rate: int, channels: int, seconds: float, seed: int):
    rng = np.random.default_rng(seed)
    n = int(rate * seconds)
    t = np.arange(n) / rate
    sig = [8000 * np.sin(2 * np.pi * (300 + 500 * c) * t)
           + rng.normal(0, 600, n) for c in range(channels)]
    return np.clip(np.round(np.stack(sig, 1)), -32768,
                   32767).astype(np.int16)


def _ac3_stream(rate, channels, kbps, seconds=0.12, seed=1) -> bytes:
    from tcforge_tpu.io.a52enc import NativeAc3Encoder
    enc = NativeAc3Encoder(rate, channels, kbps * 1000)
    enc.feed(_tone(rate, channels, seconds, seed))
    enc.flush()
    return b"".join(enc.read_packets())


AC3_STREAMS = [(48000, 2, 192), (48000, 1, 96), (44100, 2, 448),
               (32000, 2, 128), (48000, 2, 64)]


@pytest.mark.parametrize("rate,channels,kbps", AC3_STREAMS)
def test_a52_copy_decodes_encoded_streams_with_dither(rate, channels, kbps):
    stream = _ac3_stream(rate, channels, kbps)
    want = ja52.decode_stream(stream, dither=True)
    got = ta52.decode_stream(stream, dither=True)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]


@pytest.mark.parametrize("chunk", [1, 97, 2021])
def test_a52_stream_decoder_copy_over_chunks(chunk):
    stream = _ac3_stream(48000, 2, 192, seconds=0.2, seed=5)
    outs = {}
    for key, mod in (("jax", ja52), ("port", ta52)):
        dec, got = mod.StreamDecoder(), []
        for k in range(0, len(stream), chunk):
            dec.feed(stream[k:k + chunk])
            pcm = dec.read()
            if pcm is not None:
                got.append(pcm)
        dec.flush()
        outs[key] = (np.concatenate(got), dec.rate, dec.channels)
    np.testing.assert_array_equal(outs["port"][0], outs["jax"][0])
    assert outs["port"][1:] == outs["jax"][1:]


def _mp2_stream(rate, channels, kbps, seconds=0.15, seed=2) -> bytes:
    from tcforge_tpu.io.mpaenc import Mp2Encoder
    enc = Mp2Encoder(rate, channels, kbps)
    pcm = _tone(rate, channels, seconds, seed)
    return b"".join(enc.encode_frame(pcm[k:k + 1152])
                    for k in range(0, pcm.shape[0] - 1151, 1152))


MP2_STREAMS = [(48000, 2, 192), (48000, 1, 64), (44100, 2, 256),
               (32000, 2, 128), (24000, 2, 96), (22050, 1, 32),
               (16000, 2, 64)]


@pytest.mark.parametrize("rate,channels,kbps", MP2_STREAMS)
def test_mp2_copy_decodes_layer2_as_the_jax_module(rate, channels, kbps):
    stream = _mp2_stream(rate, channels, kbps)
    want = jmp2.decode_stream(stream)
    got = tmp2.decode_stream(stream)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]


def _layer1_frame(seed: int, mode: int) -> bytes:
    """A crafted MPEG-1 Layer I frame (448 kbit/s, 44.1 kHz; ``mode`` 3
    mono, 0 stereo): random allocations, scale factors and samples."""
    from test_mp2 import _bits_writer
    rng = np.random.RandomState(seed)
    put, done = _bits_writer()
    put(0x7FF, 11); put(3, 2); put(3, 2); put(1, 1)     # noqa: E702
    put(14, 4); put(0, 2); put(0, 1); put(0, 1)         # noqa: E702
    put(mode, 2); put(0, 2); put(0, 1); put(0, 1); put(0, 2)  # noqa: E702
    nch = 1 if mode == 3 else 2
    allocs = [[int(rng.randint(0, 6)) for _ in range(32)]
              for _ in range(nch)]
    for sb in range(32):
        for ch in range(nch):
            put(allocs[ch][sb], 4)
    for sb in range(32):
        for ch in range(nch):
            if allocs[ch][sb]:
                put(int(rng.randint(0, 63)), 6)
    for _ in range(12):
        for sb in range(32):
            for ch in range(nch):
                a = allocs[ch][sb]
                if a:
                    put(int(rng.randint(0, (1 << (a + 1)) - 1)), a + 1)
    return done((12000 * 448 // 44100) * 4)


@pytest.mark.parametrize("mode", [3, 0])
def test_mp2_copy_decodes_layer1_as_the_jax_module(mode):
    stream = b"".join(_layer1_frame(seed, mode) for seed in range(4))
    want = jmp2.decode_stream(stream)
    got = tmp2.decode_stream(stream)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]


@pytest.mark.parametrize("layer", [2, 3])
def test_mp2_stream_decoder_copy_takes_layers_2_and_3(layer):
    """A PS 0xC0 stream decodes as the JAX fallback decodes it: Layer II
    here, Layer III handed to the Layer III decoder copy."""
    if layer == 2:
        stream = _mp2_stream(48000, 2, 192, seconds=0.2)
    else:
        from tcforge_tpu.io.mp3enc import Mp3Encoder
        enc = Mp3Encoder(44100, 2, 128)
        pcm = _tone(44100, 2, 0.2, 3)
        stream = b"".join(enc.encode_frame(pcm[k:k + 1152])
                          for k in range(0, pcm.shape[0] - 1151, 1152))
    outs = {}
    for key, mod in (("jax", jmp2), ("port", tmp2)):
        dec, got = mod.StreamDecoder(), []
        for k in range(0, len(stream), 500):
            dec.feed(stream[k:k + 500])
            pcm = dec.read()
            if pcm is not None:
                got.append(pcm)
        dec.flush()
        pcm = dec.read()
        if pcm is not None:
            got.append(pcm)
        outs[key] = (np.concatenate(got), dec.rate, dec.channels)
    np.testing.assert_array_equal(outs["port"][0], outs["jax"][0])
    assert outs["port"][1:] == outs["jax"][1:]


@pytest.mark.parametrize("stereo", [False, True])
def test_vag_copy_decodes_as_the_jax_module(stereo):
    from test_vag import make_blocks
    rng = np.random.default_rng(12)
    body = make_blocks(rng, 24)
    if stereo:
        import struct
        head = (b"SShd" + struct.pack("<I", 24) + struct.pack("<iii", 16,
                                                               22050, 2)
                + struct.pack("<i", 64) + b"\xff" * 8 + b"SSbd"
                + struct.pack("<I", len(body)))
        body = head + body
    outs = {}
    for key, mod in (("jax", jvag), ("port", tvag)):
        dec, got = mod.VagStreamDecoder(), []
        for k in range(0, len(body), 100):
            pcm = dec.feed(body[k:k + 100])
            if pcm is not None and len(pcm):
                got.append(pcm)
        tail = dec.flush()
        if tail is not None and len(tail):
            got.append(tail)
        outs[key] = np.concatenate(got)
    np.testing.assert_array_equal(outs["port"], outs["jax"])
    blocks = make_blocks(np.random.default_rng(5), 9)
    np.testing.assert_array_equal(
        tvag.decode_blocks(blocks, tvag.VagState()),
        jvag.decode_blocks(blocks, jvag.VagState()))


# ------------------------------------------------------------------ #
# the demux

def _lpcm_vob(path: Path, rate: int, channels: int, track: int = 0):
    """small.mpg's video with an LPCM track at ``rate`` (every DVD rate
    code), written by the JAX package's program-stream writer, its
    sub-stream 0xA0 + ``track``."""
    from tcforge_tpu.io.psmux import PsWriter
    from tcforge_tpu_torch.io import mpeg
    es = b"".join(p for sid, p in mpeg.iter_pes_packets(
        str(chip_smoke.MPEG_DATA / "small.mpg")) if 0xE0 <= sid <= 0xEF)
    pcm = _tone(rate, channels, 0.8, rate + channels)
    with open(path, "wb") as f:
        w = PsWriter(f, fps=29.97, audio_rate=rate, chunk=1500)
        per = -(-len(es) // 10)
        for k in range(10):
            w.write_video(es[k * per:(k + 1) * per])
            w.write_audio_pcm(pcm[k * pcm.shape[0] // 10:
                                  (k + 1) * pcm.shape[0] // 10])
        w.close()
    if track:
        data = bytearray(path.read_bytes())
        at = 0
        while True:
            at = data.find(b"\x00\x00\x01\xbd", at)
            if at < 0:
                break
            data[at + 9 + data[at + 8]] = 0xA0 + track
            at += 4
        path.write_bytes(bytes(data))
    return path


def _read_all(imp, n: int, spf: int, jax: bool):
    """Batches of ``n`` frames, each followed by its samples (the
    engines' order): [(frames, samples or None)]."""
    out = []
    while True:
        got = imp.read_video_batch(n)
        if got is None:
            break
        frames = got["y"].shape[0]
        pcm = imp.read_audio_batch(spf * frames)
        out.append((frames, None if pcm is None else np.asarray(pcm)))
    return out


def _both_importers(path, n, a_track=0, options=""):
    from tcforge_tpu.core.job import Job as JJob
    from tcforge_tpu.modules.registry import ModuleKind as JKind
    from tcforge_tpu.modules.registry import new_module as jnew
    jimp = jnew(JKind.DEMULTIPLEXOR, "mpeg", JJob(a_track=a_track), options)
    jimp.open(str(path))
    rate, channels = jimp.audio_rate, jimp.audio_channels
    spf = int(round((rate or 48000) / jimp.fps))
    want = _read_all(jimp, n, spf, True)
    jimp.close()
    imp = new_module(ModuleKind.DEMULTIPLEXOR, "mpeg",
                     Job(a_track=a_track), options)
    imp.open(str(path))
    imp.start(CPU)
    assert (imp.audio_rate, imp.audio_channels) == (rate, channels)
    got = _read_all(imp, n, spf, False)
    imp.close()
    assert [f for f, _ in got] == [f for f, _ in want]
    for (_, g), (_, w) in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            np.testing.assert_array_equal(g, w)
    return got


DEMUX = [("ac3.vob", 1, 0, ""), ("ac3.vob", 3, 0, ""),
         ("ac3.vob", 16, 0, ""), ("ac3.vob", 4, 0, "stream=0"),
         ("ac3.vob", 2, 0, "window=4"), ("mp2.vob", 1, 0, ""),
         ("mp2.vob", 5, 0, "stream=0"), ("mp2.vob", 16, 0, "window=4"),
         ("lpcm.vob", 1, 0, ""), ("lpcm.vob", 3, 0, "stream=0"),
         ("ac3x2.vob", 3, 0, ""), ("ac3x2.vob", 3, 1, ""),
         ("ac3x2.vob", 5, 1, "stream=0"), ("ac3x2.vob", 2, 2, ""),
         ("VIDEO_TS/VTS_01_1.VOB", 16, 0, ""),
         ("VIDEO_TS/VTS_01_2.VOB", 7, 0, "window=16")]


@pytest.mark.parametrize("name,n,a_track,options", DEMUX)
def test_demux_matches_the_jax_importer(jax_native, bridge_off, name, n,
                                        a_track, options):
    _both_importers(DVD / name, n, a_track, options)


@pytest.mark.parametrize("rate", [48000, 96000, 44100, 32000])
@pytest.mark.parametrize("channels,track", [(2, 0), (1, 1)])
def test_lpcm_rate_codes_match_the_jax_importer(jax_native, bridge_off,
                                                tmp_path, rate, channels,
                                                track):
    path = _lpcm_vob(tmp_path / "l.vob", rate, channels, track)
    got = _both_importers(path, 4, track)
    assert any(pcm is not None for _, pcm in got)


# ac3.vob's 0.42 s of AC-3 (10 KB), 24 times over: ten seconds, whose
# payloads and decoded results each outgrow a 64 KB pipe many times
LONG_REPEAT = 24


@pytest.fixture(scope="module")
def long_ac3(tmp_path_factory):
    path = tmp_path_factory.mktemp("long_ac3") / "long.vob"
    path.write_bytes((DVD / "ac3.vob").read_bytes() * LONG_REPEAT)
    return path


@pytest.mark.parametrize("options", ["stream=0", ""])
def test_a_long_track_decodes_whole_in_its_process(jax_native, bridge_off,
                                                   long_ac3, options):
    got = _in_thread(_both_importers, long_ac3, 16, 0, options)
    samples = sum(pcm.shape[0] for _, pcm in got if pcm is not None)
    assert samples > 9 * 48000


@pytest.mark.parametrize("args", [["-L", "3"], ["-x", "mpeg=stream=0"]])
def test_a_long_track_through_both_clis(jax_native, bridge_off, long_ac3,
                                        tmp_path, args):
    outs = {}
    for key, run in (("jax", jax_cli), ("port", port_cli)):
        stem = tmp_path / key
        assert run(["-i", str(long_ac3), "-o", f"{stem}.y4m", "-m",
                    f"{stem}.wav", "--batch", "8", *args]) == 0
        outs[key] = [Path(f"{stem}.{ext}").read_bytes()
                     for ext in ("y4m", "wav")]
    assert outs["port"][0] == outs["jax"][0]
    assert outs["port"][1] == outs["jax"][1]
    assert len(outs["port"][1]) > 44 + 4 * 9 * 48000


def test_windowed_and_whole_file_give_the_same_track():
    outs = []
    for options in ("", "stream=0", "window=4"):
        imp = new_module(ModuleKind.DEMULTIPLEXOR, "mpeg", Job(), options)
        imp.open(str(DVD / "ac3x2.vob"))
        imp.start(CPU)
        pcm = []
        while imp.read_video_batch(4) is not None:
            got = imp.read_audio_batch(1 << 20)
            if got is not None:
                pcm.append(got)
        outs.append(np.concatenate(pcm))
        imp.close()
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_array_equal(outs[0], outs[2])


@pytest.mark.parametrize("options", ["", "stream=0"])
def test_a_track_not_taken_is_not_demuxed(options):
    imp = new_module(ModuleKind.DEMULTIPLEXOR, "mpeg", Job(), options)
    imp.demux_audio = False
    imp.open(str(DVD / "ac3.vob"))
    assert imp.audio_rate == 0
    imp.start(CPU)
    frames = 0
    while (got := imp.read_video_batch(5)) is not None:
        frames += got["y"].shape[0]
        assert imp.read_audio_batch(1602) is None
    imp.close()
    assert frames > 0


# ------------------------------------------------------------------ #
# the CLI

CLI_CASES = ["lpcm", "mp2", "ac3", "ac3_b3", "track1", "wav", "seek",
             "extsub_spu", "extsub_idx"]


@pytest.fixture(scope="module")
def cli_outputs(jax_native, bridge_off, tmp_path_factory):
    """{case: {"jax"|"port": (y4m bytes, wav bytes)}}: both CLIs on each
    case, once for the module."""
    tmp = tmp_path_factory.mktemp("dvd_cli")
    out = {}
    for case in CLI_CASES:
        got = {}
        for key, run in (("jax", jax_cli), ("port", port_cli)):
            stem = tmp / f"{key}_{case}"
            assert run(chip_smoke.dvd_golden_argv(case, tmp, stem)) == 0
            got[key] = tuple(Path(f"{stem}.{ext}").read_bytes()
                             for ext in ("y4m", "wav"))
        out[case] = got
    return out


@pytest.mark.parametrize("case", CLI_CASES)
@pytest.mark.parametrize("ext", ["y4m", "wav"])
def test_dvd_cli_matches_the_jax_cli_byte_for_byte(cli_outputs, case, ext):
    k = ("y4m", "wav").index(ext)
    got, want = cli_outputs[case]["port"][k], cli_outputs[case]["jax"][k]
    assert len(got) == len(want) and got == want
    assert hashlib.sha256(got).hexdigest() == \
        chip_smoke.DVD_GOLDEN_SHA256[case][k]


def test_the_track_is_in_the_wav(cli_outputs):
    """The goldens carry audio: each WAV holds samples, as many as the
    frames' worth."""
    for case in ("lpcm", "mp2", "ac3", "track1"):
        wav = cli_outputs[case]["port"][1]
        assert len(wav) > 44 + 4 * 1602


def test_without_m_the_track_is_not_demuxed_and_the_video_is_the_same(
        cli_outputs, tmp_path):
    argv = chip_smoke.dvd_golden_argv("ac3_b3", tmp_path, tmp_path / "o")
    at = argv.index("-m")
    del argv[at:at + 2]
    assert port_cli(argv) == 0
    assert (tmp_path / "o.y4m").read_bytes() == \
        cli_outputs["ac3_b3"]["port"][0]
    assert not (tmp_path / "o.wav").exists()
