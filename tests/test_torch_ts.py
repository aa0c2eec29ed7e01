"""The port's MPEG transport stream input, against the JAX package, on the
CPU.

- The fixtures (``tests/data/ts``, the elementary streams the transport
  streams are muxed from at run time) pinned, within their byte bound.
- ``chip_smoke.mux_ts``'s broadcast features (adaptation fields with a
  PCR, PCR-only packets, null packets, two programs, a capture that
  starts inside a PES) through the port's ``io/ts.py`` and the JAX one:
  the same packets, programs, video PID and elementary streams.
- The importer's track (``_TsTrack``) against the JAX importer's
  ``_ts_audio`` for each audio kind (MPEG audio Layers II and III, AC-3,
  ADTS AAC) and both readers; a stream without audio, or whose audio
  never decodes, is video only in both; a decoder that fails after the
  first samples ends the port's track there (the JAX importer drops the
  track); a worker process that dies raises.
- The ``chip_smoke.TS_GOLDEN`` transport stream cases through both CLIs
  (the JAX one with ``--mesh off``), outputs byte for byte and their
  SHA-256 pinned for ``chip_smoke.py`` to check on the card; the
  windowed reader against the whole-stream one and the outputs at other
  ``--batch``, ``--prefetch`` and ``-x mpeg=window=`` values.

The golden rule for this audio: the JAX importer decodes a TS's audio
only through its FFmpeg bridge (``_ts_audio`` returns None without it).
The port decodes with the JAX package's in-tree decoders, so the golden
is the JAX CLI with the bridge reported built and ``AvAudioDecoder``
replaced by those decoders (``in_tree_bridge``): MPEG audio through
``mp2dec.StreamDecoder`` (which hands Layer III to ``mp3dec``), AC-3
through ``a52dec``, AAC through ``aacdec.decode_adts_stream`` at the
flush; the FLAC and AAC file importers take their in-tree route
(``TCFORGE_NATIVE_FLAC``, ``TCFORGE_NATIVE_AAC``).
"""

from __future__ import annotations

import contextlib
import hashlib
import logging
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from tcforge_tpu.core.job import Job as JJob
from tcforge_tpu.io import aacdec as jaacdec
from tcforge_tpu.io.a52dec import parse_syncinfo as jax_parse_syncinfo
from tcforge_tpu.io import ts as jts
from tcforge_tpu.modules.registry import ModuleKind as JKind
from tcforge_tpu.modules.registry import lookup as jax_lookup
from tcforge_tpu.modules.registry import new_module as jax_new_module
from tcforge_tpu_torch.core.job import Job
from tcforge_tpu_torch.io import ts as tts
from tcforge_tpu_torch.modules.registry import ModuleKind, lookup, new_module
from tcforge_tpu_torch.pipeline import engine
from test_torch_mpeg_import import jax_cli, jax_native, port_cli  # noqa: F401

DATA = chip_smoke.TS_DATA
CPU = torch.device("cpu")
FIXTURES = {
    "video.m2v":
        "58ec2d2ebc08ed41c62808f400613d8e453fbec3cdca07df0f8ab253bb351ad8",
    "a.mp2": "878eff58e13cd776ff45fece06586ea743cca12e7a071b56d5703cbe8061d2bc",
    "a.mp3": "5962c49965615c18216d4adf5a90014501a244c0cadbfbacd09b1d2e3e369348",
    "a.ac3": "bd8c0c672ae61eb5e208f5024fc4c3dedbe565776dd9763e8c8f756e6fb4383b",
    "a.aac": "86f743a83b24fd97c80e4996bea13ed9e0086cceea41ab3e6101c2bb7406ee68",
    "a.flac":
        "56400f0b845c4d9d0356f00cc376ea45b1660cb48074fc89a45c38de266bae80",
}
FIXTURE_BYTES = 200_000
TS_CASES = [c for c in chip_smoke.TS_GOLDEN if c.startswith("ts_")]


# ------------------------------------------------------------------ #
# the golden route of the JAX package's bridged audio

class InTreeBridge:
    """The JAX bridge's ``AvAudioDecoder`` shape over the JAX package's
    in-tree decoder of the same kind: ``mp3`` (MPEG audio) and ``ac3``
    stream decoders, ``aac`` the whole ADTS stream at the flush."""

    def __init__(self, name: str):
        from tcforge_tpu.io import a52dec, mp2dec
        self._dec = {"mp3": mp2dec, "ac3": a52dec}.get(name)
        if self._dec is not None:
            self._dec = self._dec.StreamDecoder()
        elif name != "aac":
            raise ValueError(name)
        self._buf = b""
        self._out = None
        self.rate = self.channels = 0

    def feed(self, data: bytes) -> None:
        if self._dec is None:
            self._buf += data
            return
        self._dec.feed(data)
        self.rate, self.channels = self._dec.rate, self._dec.channels

    def flush(self) -> None:
        if self._dec is None:
            self._out, self.rate, self.channels = \
                jaacdec.decode_adts_stream(self._buf)
            return
        self._dec.flush()
        self.rate, self.channels = self._dec.rate, self._dec.channels

    def read(self):
        if self._dec is None:
            out, self._out = self._out, None
            return out
        return self._dec.read()

    def close(self) -> None:
        pass


@contextlib.contextmanager
def in_tree_bridge():
    """The JAX package with its bridge reported built and its audio
    decoded by its in-tree decoders (``InTreeBridge``; the FLAC and AAC
    importers' own in-tree route)."""
    import tcforge_tpu.native.av as av
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(av, "available", lambda: True)
        mp.setattr(av, "AvAudioDecoder", InTreeBridge)
        mp.setenv("TCFORGE_NATIVE_FLAC", "1")
        mp.setenv("TCFORGE_NATIVE_AAC", "1")
        yield


def run_goldens(cases, tmp) -> dict:
    """Each ``chip_smoke.TS_GOLDEN`` case through both CLIs, each in a
    directory of its own: {case: {"jax": outputs, "port": outputs}},
    each a list of bytes (a missing file None)."""
    out = {}
    for case in cases:
        got = {}
        for key, run in (("jax", jax_cli), ("port", port_cli)):
            d = Path(tmp) / f"{key}_{case}"
            d.mkdir()
            with in_tree_bridge():
                rc = run(chip_smoke.ts_golden_argv(case, d))
            assert rc == 0, (case, key)
            got[key] = [f.read_bytes() if f.exists() else None
                        for f in chip_smoke.ts_golden_outputs(case, d)]
        out[case] = got
    return out


def assert_golden(outs, case):
    got = outs[case]
    assert got["port"] == got["jax"], case
    assert None not in got["port"], case
    digests = [hashlib.sha256(b).hexdigest() for b in got["port"]]
    assert digests == list(chip_smoke.TS_GOLDEN_SHA256[case])


# ------------------------------------------------------------------ #
# the fixtures

@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_fixture_is_pinned(name):
    data = (DATA / name).read_bytes()
    assert hashlib.sha256(data).hexdigest() == FIXTURES[name]


def test_fixtures_stay_within_their_byte_bound():
    files = [p for p in DATA.iterdir() if p.suffix != ".py"]
    assert sorted(p.name for p in files) == sorted(FIXTURES)
    assert sum(p.stat().st_size for p in files) <= FIXTURE_BYTES


# ------------------------------------------------------------------ #
# the muxer's broadcast features through io/ts.py

@pytest.mark.parametrize("size,pcr", [
    (size, pcr) for pcr in (None, 123456789)
    for size in (0, 1, 2, 7, 8, 100, 175, 176, 183, 184)
    if pcr is None or size <= 176])        # a PCR leaves 176 bytes
def test_packets_with_adaptation_fields_demux_as_in_jax(size, pcr,
                                                        tmp_path):
    """A payload of ``size`` bytes after an adaptation field (stuffing, a
    PCR, or both), a PCR-only packet where it is empty; between a null
    packet and a packet of a full payload."""
    rng = np.random.default_rng(size)
    payload = rng.integers(0, 256, size, dtype=np.uint8).tobytes()
    full = bytes(range(184))
    data = (chip_smoke.ts_packet(chip_smoke.TS_NULL_PID, 0, b"\xff" * 184)
            + chip_smoke.ts_packet(0x100, 3, payload, True, pcr)
            + chip_smoke.ts_packet(0x100, 4, full))
    path = tmp_path / "p.ts"
    path.write_bytes(data)
    ours = list(tts.iter_ts_packets(str(path)))
    assert ours == list(jts.iter_ts_packets(str(path)))
    got = [(pid, pusi, bytes(p)) for pid, pusi, p in ours]
    want = ([(0x1FFF, False, b"\xff" * 184)]
            + ([(0x100, True, payload)] if size else []) + [(0x100, False,
                                                            full)])
    assert got == want


@pytest.mark.parametrize("junk", [1, 187, 189, 500])
def test_the_resync_over_junk_is_the_jax_one(junk, tmp_path):
    ts = chip_smoke.ts_input("mp2.ts", tmp_path)
    data = ts.read_bytes()
    cut = 188 * 20
    path = tmp_path / "junk.ts"
    path.write_bytes(data[:cut] + bytes(range(256))[:junk % 256] * (
        junk // 256 + 1) + data[cut:])
    assert list(tts.iter_ts_packets(str(path))) == \
        list(jts.iter_ts_packets(str(path)))
    assert b"".join(tts.iter_video_es(str(path))) == \
        b"".join(jts.iter_video_es(str(path)))


def _stream_cases():
    for name, spec in chip_smoke.TS_INPUTS.items():
        for _, _, streams in spec["programs"]:
            for pid, _st, _sid, es in streams:
                yield name, pid, es


@pytest.mark.parametrize("name,pid,es", list(_stream_cases()),
                         ids=lambda v: v if isinstance(v, str) else None)
def test_muxed_streams_demux_as_in_jax(name, pid, es, tmp_path):
    path = str(chip_smoke.ts_input(name, tmp_path))
    assert tts.scan_programs(path) == jts.scan_programs(path)
    assert tts.find_video_pid(path) == jts.find_video_pid(path)
    ours = b"".join(tts.iter_video_es(path, pid=pid))
    assert ours == b"".join(jts.iter_video_es(path, pid=pid))
    if not chip_smoke.TS_INPUTS[name].get("skip"):
        assert ours == chip_smoke._ts_es(es)
    else:                    # the capture starts inside a PES of each
        assert ours and chip_smoke._ts_es(es).endswith(ours)


def test_mux_ts_writes_the_broadcast_features(tmp_path):
    """PAT and PMT repeated, the PCR in the video's adaptation fields,
    PCR-only and null packets, continuity counters per PID."""
    data = chip_smoke.ts_input("ac3.ts", tmp_path).read_bytes()
    pkts = [data[k:k + 188] for k in range(0, len(data), 188)]
    assert all(p[0] == 0x47 for p in pkts)
    pids = [((p[1] & 0x1F) << 8) | p[2] for p in pkts]
    afc = [(p[3] >> 4) & 3 for p in pkts]
    assert pids.count(0) > 1 and pids.count(0x30) > 1
    assert 0x1FFF in pids
    assert any(a == 2 for a in afc)                  # PCR-only
    assert any(a == 3 and p[5] & 0x10 for a, p in zip(afc, pkts))
    for pid in set(pids) - {0x1FFF}:
        ccs = [p[3] & 15 for p, q, a in zip(pkts, pids, afc)
               if q == pid and a & 1]
        assert all((b - a) % 16 == 1 for a, b in zip(ccs, ccs[1:])), pid


# ------------------------------------------------------------------ #
# the importer's audio track

def _jax_importer(path, stream: int = 1):
    imp = jax_new_module(JKind.DEMULTIPLEXOR, "mpeg", JJob(),
                         f"stream={stream}")
    with in_tree_bridge():
        imp.open(str(path))
    return imp


def _port_importer(path, stream: int = 1):
    imp = new_module(ModuleKind.DEMULTIPLEXOR, "mpeg", Job(),
                     f"stream={stream}")
    imp.open(str(path))
    imp.start(CPU)
    return imp


def _all_audio(imp, n: int = 3000):
    out = []
    while True:
        got = imp.read_audio_batch(n)
        if got is None:
            break
        out.append(np.asarray(got))
    return np.concatenate(out) if out else None


@pytest.mark.parametrize("stream", [1, 0])
@pytest.mark.parametrize("kind", ["mp2", "mp3", "ac3", "aac"])
def test_the_track_is_the_jax_importers(kind, stream, tmp_path,
                                        jax_native):
    path = chip_smoke.ts_input(f"{kind}.ts", tmp_path)
    jimp = _jax_importer(path, stream)
    imp = _port_importer(path, stream)
    try:
        assert (imp.audio_rate, imp.audio_channels) == \
            (jimp.audio_rate, jimp.audio_channels) != (0, 0)
        assert (imp.width, imp.height, imp.fps) == \
            (jimp.width, jimp.height, jimp.fps)
        want = _all_audio(jimp)
        got = _all_audio(imp, 1000 + 777 * stream)
        assert got.dtype == np.int16 and got.shape[0] > 20000
        assert np.array_equal(got, want)
    finally:
        imp.close()
        jimp.close()


def adts_frames(data: bytes):
    """The ADTS frames of ``data``, each whole."""
    out, pos = [], 0
    while pos < len(data):
        n = jaacdec.parse_adts_header(data[pos:pos + 9])["frame_length"]
        out.append(data[pos:pos + n])
        pos += n
    return out


def _with_audio(tmp_path, stype, audio: bytes) -> Path:
    path = tmp_path / "x.ts"
    path.write_bytes(chip_smoke.mux_ts([(1, 0x30, [
        (0x100, 0x02, 0xE0, chip_smoke._ts_es("video.m2v")),
        (0x101, stype, 0xC0, audio)])]))
    return path


@pytest.mark.parametrize("why", ["no_pid", "mp2", "ac3", "aac"])
def test_a_track_that_is_not_there_leaves_the_video(why, tmp_path, caplog,
                                                    jax_native):
    """No audio stream in the PMT, or one with no frame that decodes:
    the JAX importer has no track, and the port logs why."""
    if why == "no_pid":
        path = chip_smoke.ts_input("none.ts", tmp_path)
        match = "no MPEG audio, AC-3 or AAC stream"
    else:
        stype = {"mp2": 0x03, "ac3": 0x81, "aac": 0x0F}[why]
        # no byte of a sync word (0xFF, 0x0B)
        junk = np.random.default_rng(5).integers(
            0x10, 0x70, 6000, dtype=np.uint8).tobytes()
        path = _with_audio(tmp_path, stype, junk)
        match = "no decodable frame"
    jimp = _jax_importer(path)
    with caplog.at_level(logging.WARNING, logger="tcforge_tpu_torch"):
        imp = _port_importer(path)
    try:
        assert jimp.audio_rate == imp.audio_rate == 0
        assert imp.read_audio_batch(1000) is None
        assert jimp.read_audio_batch(1000) is None
        assert match in caplog.text
        assert imp.read_video_batch(16)["y"].shape[0] == 15
    finally:
        imp.close()
        jimp.close()


def ac3_frames(data: bytes):
    """The AC-3 frames of ``data``, each whole."""
    out, pos = [], 0
    while pos < len(data):
        n = jax_parse_syncinfo(data[pos:pos + 8])[0]
        out.append(data[pos:pos + n])
        pos += n
    return out


@pytest.mark.parametrize("kind", ["aac", "ac3"])
def test_a_decoder_that_fails_after_its_first_samples_ends_the_track(
        kind, tmp_path, monkeypatch, caplog, jax_native):
    """Frames that decode, then one that the decoder refuses (AAC: the
    Main profile where LC is decoded; AC-3: 1+1 dual mono): the JAX
    importer's whole-stream decode fails, so its session has no track.
    The port has served samples already (the track goes to the decoder
    in pieces of 1 KB here): its track ends at the failure, with a
    warning, and holds the samples of every frame before it, which are
    those of the JAX track of the frames before it; the video plays on."""
    from tcforge_tpu_torch.modules.importers import mpeg_import
    monkeypatch.setattr(mpeg_import, "_TS_AUDIO_CHUNK", 1024)
    data = (DATA / f"a.{kind}").read_bytes()
    if kind == "aac":
        frames, stype = adts_frames(data), 0x0F
        bad = bytearray(frames[1])
        bad[2] &= 0x3F                 # profile 0 (Main) where 1 is LC
    else:
        frames, stype = ac3_frames(data), 0x81
        bad = bytearray(frames[1])
        bad[6] &= 0x1F                 # acmod 0 (1+1)
    good = b"".join(frames)
    (tmp_path / "good").mkdir()
    jimp = _jax_importer(_with_audio(tmp_path / "good", stype, good))
    rate = (jimp.audio_rate, jimp.audio_channels)
    want = _all_audio(jimp)
    jimp.close()
    path = _with_audio(tmp_path, stype, good + bytes(bad) + frames[2])
    jimp = _jax_importer(path)
    with caplog.at_level(logging.WARNING, logger="tcforge_tpu_torch"):
        imp = _port_importer(path)
        try:
            assert jimp.audio_rate == 0
            assert (imp.audio_rate, imp.audio_channels) == rate
            got = _all_audio(imp, 1000)
            assert "failed to decode part-way" in caplog.text
            assert want.shape[0] > 20000 and np.array_equal(got, want)
            assert imp.read_video_batch(16)["y"].shape[0] == 15
        finally:
            imp.close()
            jimp.close()


def test_a_worker_process_that_dies_raises(tmp_path, monkeypatch):
    from tcforge_tpu_torch.modules.importers import mpeg_import
    monkeypatch.setattr(mpeg_import, "_TS_AUDIO_CHUNK", 1024)
    path = _with_audio(tmp_path, 0x81, (DATA / "a.ac3").read_bytes() * 2)
    imp = _port_importer(path)
    try:
        worker = imp._ts_track.samples.dec._worker
        worker.proc.kill()
        worker.proc.wait()
        with pytest.raises((RuntimeError, OSError)):
            _all_audio(imp, 48000)
    finally:
        imp.close()


# ------------------------------------------------------------------ #
# the CLI

@pytest.fixture(scope="module")
def ts_outputs(jax_native, tmp_path_factory):
    return run_goldens(TS_CASES, tmp_path_factory.mktemp("ts_goldens"))


@pytest.mark.parametrize("case", TS_CASES)
def test_ts_golden_cli_matches_jax_cli_byte_for_byte(case, ts_outputs):
    assert_golden(ts_outputs, case)


def test_the_whole_stream_reader_gives_the_windowed_readers_bytes(
        ts_outputs):
    assert ts_outputs["ts_whole"]["port"] == ts_outputs["ts_ac3"]["port"]


@pytest.mark.parametrize("flags", [
    ["--batch", "1", "--prefetch", "1"], ["--batch", "5", "--prefetch", "4"],
    ["--batch", "16", "--prefetch", "4"],
    ["-x", "mpeg=window=4", "--batch", "3"],
    ["-x", "mpeg=window=16", "--batch", "7", "--prefetch", "4"]],
    ids=lambda f: "_".join(a.strip("-") for a in f))
def test_batches_prefetch_and_windows_keep_the_bytes(flags, ts_outputs,
                                                     tmp_path):
    argv = chip_smoke.ts_golden_argv("ts_ac3", tmp_path)
    argv = [a for a in argv if a != "16" and a != "--batch"]
    assert port_cli([*argv, *flags]) == 0
    got = [f.read_bytes()
           for f in chip_smoke.ts_golden_outputs("ts_ac3", tmp_path)]
    assert got == ts_outputs["ts_ac3"]["jax"]


def test_x_auto_and_the_registry_take_a_ts_to_mpeg(tmp_path):
    path = chip_smoke.ts_input("none.ts", tmp_path)
    assert engine.video_module(Job(video_in_file=str(path))) == "mpeg"
    ours = lookup(ModuleKind.DEMULTIPLEXOR, "mpeg").info.formats_in
    ref = jax_lookup(JKind.DEMULTIPLEXOR, "mpeg").info.formats_in
    assert [f.value for f in ours] == [f.value for f in ref]


@pytest.mark.parametrize("window", [5])
def test_a_window_that_ends_between_macroblocks_cuts_no_picture(
        window, tmp_path, jax_native):
    """The parse takes the end of its data for the end of a picture, so
    the JAX windowed reader keeps a picture cut where a window ends
    between two of its macroblocks (video.m2v at windows of 5 KB).
    The port parses that picture again with the next window: its frames
    are the whole-stream reader's at every window."""
    src = str(DATA / "video.m2v")
    outs = {}
    for key, run, opts in (("jax_window", jax_cli, f"mpeg=window={window}"),
                           ("jax_whole", jax_cli, "mpeg=stream=0"),
                           ("port_window", port_cli,
                            f"mpeg=window={window}")):
        out = tmp_path / f"{key}.y4m"
        assert run(["-i", src, "-x", opts, "-o", str(out)]) == 0
        outs[key] = out.read_bytes()
    assert outs["port_window"] == outs["jax_whole"]
    assert outs["jax_window"] != outs["jax_whole"]
