"""The port's Ogg/OGM container, its Vorbis codec, the ``faac`` and
``flac`` encoders and the ``au``, ``vag``, ``null`` and ``ogg`` importers,
on the CPU, against the JAX package at tolerance 0.

- the Ogg page CRC, the lacing and the page writer on packets at every
  lacing edge, ``identify_streams`` and the ``ogg`` multiplexor's bytes
  (OGM raw video, PCM audio, the Vorbis logical stream, ``-m``'s case of
  no audio stream) against the JAX module;
- the Vorbis encoder module on short seeded signals (mono and stereo, 8
  to 48 kHz, each block size from 64 to 2048) fed in batches with a
  short last one, its packets and extradata against the JAX module's,
  and both decoders on them;
- ``faac`` (AAC-LC frames) and ``flac`` against the JAX modules on their
  in-tree encoders (``TCFORGE_NATIVE_AACENC``, ``TCFORGE_NATIVE_FLAC``);
  FLAC decodes back to its input;
- AU (16- and 8-bit linear, μ-law; A-law refused alike) and VAG (VAGp,
  SShd ADPCM and PCM) parsing, and the importer modules against the JAX
  ones; the registry entries of the slice's eight modules;
- the slice's ``chip_smoke.ROUTE_GOLDEN`` cases (audio-only sessions
  through -y's encoders and multiplexors, Ogg both ways, -m through the
  multiplexors, -p from the containers) through both CLIs, each digest
  pinned for ``chip_smoke.py``.  The queue of the source's own track
  without -m is ``tests/test_torch_audio_routes.py``.
"""

from __future__ import annotations

import io
import struct
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from tcforge_tpu.core.frame import AudioBatch as JAudioBatch
from tcforge_tpu.core.job import Job as JJob
from tcforge_tpu.io import au as jau
from tcforge_tpu.io import ogg as jogg
from tcforge_tpu.io import vag as jvag
from tcforge_tpu.io import vorbis as jvorbis
from tcforge_tpu.modules import registry as jregistry
from tcforge_tpu_torch.core.frame import AudioBatch
from tcforge_tpu_torch.core.job import Job
from tcforge_tpu_torch.io import au as tau
from tcforge_tpu_torch.io import flac as tflac
from tcforge_tpu_torch.io import ogg as togg
from tcforge_tpu_torch.io import vag as tvag
from tcforge_tpu_torch.io import vorbis as tvorbis
from tcforge_tpu_torch.modules import registry
from tcforge_tpu_torch.modules.encoders.vorbis_enc import \
    unpack_header_packets
from test_torch_audio_encode import encode_both, level_pcm
from test_torch_audio_routes import run_route_goldens
from test_torch_mpeg_import import jax_native  # noqa: F401

K = registry.ModuleKind
JK = jregistry.ModuleKind


def seeded_pcm(seed: int, samples: int, channels: int,
               level: float = 6000.0) -> np.ndarray:
    """A seeded tone under noise, int16 (samples, channels)."""
    rng = np.random.default_rng(seed)
    t = np.arange(samples)[:, None]
    tone = np.sin(2 * np.pi * t * (0.01 + 0.02 * np.arange(channels)))
    x = level * tone + 0.3 * level * rng.standard_normal((samples, channels))
    return np.clip(np.rint(x), -32768, 32767).astype(np.int16)


# ------------------------------------------------------------------ #
# Ogg framing

@pytest.mark.parametrize("n", [0, 1, 27, 255, 4096, 65307])
def test_the_page_crc_matches_jax(n):
    data = np.random.default_rng(n).integers(0, 256, n, np.uint8).tobytes()
    assert togg.ogg_crc(data) == jogg.ogg_crc(data)


LACING_SIZES = [0, 1, 254, 255, 256, 509, 510, 511, 51000, 65025, 70000]


def _written(mod, packets, flushes, granules) -> bytes:
    f = io.BytesIO()
    w = mod.OggPageWriter(f, 0x1234)
    for pkt, flush, g in zip(packets, flushes, granules):
        w.write_packet(pkt, g, flush=flush)
    w.close()
    return f.getvalue()


@pytest.mark.parametrize("size", LACING_SIZES)
def test_lacing_and_pages_match_jax(size):
    """One packet of ``size`` bytes: its lacing segments, its pages (a
    255-byte last segment continues on an empty one; 200 segments fill a
    page), and the packet read back."""
    pkt = bytes(np.random.default_rng(size).integers(0, 256, size,
                                                     np.uint8))
    assert togg._lace(pkt) == jogg._lace(pkt)
    got = _written(togg, [pkt], [True], [size])
    assert got == _written(jogg, [pkt], [True], [size])
    pages = list(togg.iter_pages(io.BytesIO(got), check_crc=True))
    assert [p for _, p in togg.pages_to_packets(iter(pages), 0x1234)] \
        == [pkt]


@pytest.mark.parametrize("seed,count", [(1, 3), (2, 10), (3, 40),
                                        (4, 300), (5, 7), (6, 64)])
def test_packet_sequences_match_jax(seed, count):
    """Packets of random sizes, some held for the next page, granules
    rising: the pages, and the packets the reader gives back."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(0, 1200, count)
    packets = [bytes(rng.integers(0, 256, s, np.uint8)) for s in sizes]
    flushes = [bool(b) for b in rng.integers(0, 2, count)]
    granules = list(np.cumsum(rng.integers(1, 500, count)))
    got = _written(togg, packets, flushes, granules)
    assert got == _written(jogg, packets, flushes, granules)
    back = [p for _, p in togg.pages_to_packets(
        togg.iter_pages(io.BytesIO(got), check_crc=True), 0x1234)]
    assert back == packets


@pytest.mark.parametrize("what", ["video", "audio", "rate", "comment"])
def test_the_ogm_headers_match_jax(what):
    if what == "video":
        args = ("XVID", 640, 480, 29.97)
        fn = "ogm_video_header"
    elif what == "audio":
        args = (48000, 2, 16, 4)
        fn = "ogm_audio_header"
    elif what == "rate":
        args = ("I420", 176, 144, 25.0)
        fn = "ogm_video_header"
    else:
        args = ()
        fn = "ogm_comment_header"
    assert getattr(togg, fn)(*args) == getattr(jogg, fn)(*args)


@pytest.mark.parametrize("samples,key", [(1, True), (1, False),
                                         (4096, True), (70000, False)])
def test_ogm_data_packets_match_jax(samples, key):
    payload = bytes(range(200))
    pkt = togg.ogm_data_packet(payload, samples, key)
    assert pkt == jogg.ogm_data_packet(payload, samples, key)
    assert togg.ogm_parse_data_packet(pkt) == \
        jogg.ogm_parse_data_packet(pkt)


# ------------------------------------------------------------------ #
# the ogg multiplexor against the JAX module

def jobs(**fields):
    port, ref = Job(), JJob()
    for job in (port, ref):
        for k, v in fields.items():
            setattr(job, k, v)
    return port, ref


def vorbis_modules(port_job, jax_job, options=""):
    ours = registry.new_module(K.ENCODER, "vorbis", port_job, options)
    ref = jregistry.new_module(JK.ENCODER, "vorbis", jax_job, options)
    return ours, ref


MUX_CASES = {
    "video": dict(im_v_width=64, im_v_height=48, fps=25.0, a_rate=0),
    "pcm": dict(im_v_width=32, im_v_height=16, fps=29.97, a_rate=44100,
                dm_chan=2),
    "audio_only_pcm": dict(a_rate=22050, dm_chan=1),
    "m_given": dict(im_v_width=64, im_v_height=48, a_rate=48000,
                    dm_chan=2, audio_out_file="x.wav"),
    "vorbis": dict(im_v_width=64, im_v_height=48, a_rate=16000,
                   dm_chan=1),
    "vorbis_only": dict(a_rate=8000, dm_chan=2),
    "fourcc": dict(im_v_width=16, im_v_height=16, a_rate=0),
    "ex_size": dict(im_v_width=64, im_v_height=48, ex_v_width=32,
                    ex_v_height=24, a_rate=32000, dm_chan=1),
}


@pytest.mark.parametrize("case", sorted(MUX_CASES))
def test_the_ogg_multiplexor_matches_the_jax_module(case, tmp_path):
    fields = MUX_CASES[case]
    port_job, jax_job = jobs(**fields)
    options = "fourcc=XVID" if case == "fourcc" else ""
    encs = None
    if case.startswith("vorbis"):
        encs = vorbis_modules(port_job, jax_job, "blocksize=256")
    rng = np.random.default_rng(len(case))
    frames = [bytes(rng.integers(0, 256, int(s), np.uint8))
              for s in rng.integers(10, 900, 6)]
    pcm = seeded_pcm(3, 1500, fields.get("dm_chan", 2) or 2)
    out = {}
    for side, reg, job, kind in (("port", registry, port_job, K),
                                 ("jax", jregistry, jax_job, JK)):
        mux = reg.new_module(kind.MULTIPLEXOR, "ogg", job, options)
        path = tmp_path / f"{side}.ogg"
        mux.open(str(path))
        enc = None if encs is None else encs[side == "jax"]
        batch = AudioBatch if side == "port" else JAudioBatch
        for k, frame in enumerate(frames):
            if mux._vw is not None:
                mux.write_video(frame, keyframe=k % 3 == 0)
            part = pcm[k * 250:(k + 1) * 250]
            if enc is not None:
                data = (torch.from_numpy(part[None]) if side == "port"
                        else part[None])
                for payload in enc.encode_audio(batch(pcm=data)):
                    mux.write_audio(payload)
            else:
                mux.write_audio(part.tobytes())
        if enc is not None:
            for payload in enc.flush():
                mux.write_audio(payload)
        mux.close()
        out[side] = path.read_bytes()
    assert out["port"] == out["jax"] and out["port"].startswith(b"OggS")
    with open(tmp_path / "port.ogg", "rb") as f:
        ours = togg.identify_streams(f)
    with open(tmp_path / "port.ogg", "rb") as f:
        ref = jogg.identify_streams(f)
    assert [vars(s) for s in ours] == [vars(s) for s in ref]


def test_shout_streaming_is_refused_by_name(tmp_path):
    job, _ = jobs(im_v_width=16, im_v_height=16)
    mux = registry.new_module(K.MULTIPLEXOR, "ogg", job, "stream=radio")
    with pytest.raises(NotImplementedError, match="stream= .shout"):
        mux.open(str(tmp_path / "o.ogg"))
    assert not (tmp_path / "o.ogg").exists()


# ------------------------------------------------------------------ #
# Vorbis

VORBIS_CASES = [(rate, ch, n) for rate in (8000, 22050, 48000)
                for ch in (1, 2) for n in (64, 256, 2048)] + [
    (44100, 2, 128), (16000, 1, 512), (32000, 2, 1024), (11025, 1, 64)]


@pytest.mark.parametrize("rate,channels,blocksize", VORBIS_CASES)
def test_the_vorbis_module_matches_the_jax_module(rate, channels,
                                                  blocksize):
    """Batches of per-frame audio with a short last batch, then the
    flush: every packet, the header and hop extradata and the true
    length; both decoders give the same samples from them."""
    port_job, jax_job = jobs(a_rate=rate, a_chan=channels,
                             dm_chan=channels)
    ours, ref = vorbis_modules(port_job, jax_job, f"blocksize={blocksize}")
    n = 3 * blocksize + blocksize // 3 + 5
    pcm = seeded_pcm(rate + channels + blocksize, n, channels)
    spf = max(1, blocksize // 3)
    got, want = [], []
    for at in range(0, n, 4 * spf):
        part = pcm[at:at + 4 * spf]
        frames = max(1, len(part) // spf)
        part = part[:frames * spf].reshape(frames, -1, channels)
        got += ours.encode_audio(AudioBatch(pcm=torch.from_numpy(part)))
        want += ref.encode_audio(JAudioBatch(pcm=part))
    got += ours.flush()
    want += ref.flush()
    assert got == want and len(got) >= 3
    assert port_job.extradata == jax_job.extradata
    (hop,) = struct.unpack("<I", port_job.extradata["vorbis_hop"])
    assert hop == blocksize // 2
    decoded = {}
    for side, mod in (("port", tvorbis), ("jax", jvorbis)):
        dec = mod.VorbisDecoder()
        for pkt in unpack_header_packets(port_job.extradata[
                "vorbis_headers"]):
            dec.header_packet(pkt)
        outs = [dec.audio_packet(p) for p in got]
        decoded[side] = np.concatenate([o for o in outs
                                        if o is not None and len(o)])
    np.testing.assert_array_equal(decoded["port"], decoded["jax"])
    assert decoded["port"].shape[1] == channels


@pytest.mark.parametrize("blocksize", [100, 384, 1000])
def test_a_blocksize_not_a_power_of_two_raises_as_in_jax(blocksize):
    port_job, jax_job = jobs(a_rate=48000, dm_chan=2)
    with pytest.raises(ValueError) as ours:
        registry.new_module(K.ENCODER, "vorbis", port_job,
                            f"blocksize={blocksize}")
    with pytest.raises(ValueError) as ref:
        jregistry.new_module(JK.ENCODER, "vorbis", jax_job,
                             f"blocksize={blocksize}")
    assert str(ours.value) == str(ref.value)


@pytest.mark.parametrize("options", ["", "delta=0.25", "passes=2",
                                     "passes=7:delta=0.09"])
def test_the_vorbis_options_match_jax(options):
    port_job, jax_job = jobs(a_rate=22050, dm_chan=1)
    ours, ref = vorbis_modules(port_job, jax_job,
                               f"blocksize=128:{options}".rstrip(":"))
    assert ours.options == ref.options
    pcm = seeded_pcm(9, 700, 1)[None]
    assert (ours.encode_audio(AudioBatch(pcm=torch.from_numpy(pcm)))
            + ours.flush()) == (ref.encode_audio(JAudioBatch(pcm=pcm))
                                + ref.flush())


# ------------------------------------------------------------------ #
# faac and flac

@pytest.fixture
def native_encoders(monkeypatch):
    """The JAX faac and flac modules on their in-tree encoders."""
    monkeypatch.setenv("TCFORGE_NATIVE_AACENC", "1")
    monkeypatch.setenv("TCFORGE_NATIVE_FLAC", "1")


AAC_CASES = [(rate, ch, kbps) for rate in (8000, 16000, 22050, 32000,
                                           44100, 48000)
             for ch in (1, 2) for kbps in (64, 128)]


@pytest.mark.parametrize("rate,channels,kbps", AAC_CASES)
def test_faac_matches_the_jax_module(rate, channels, kbps, native_encoders):
    pcm = level_pcm(rate + channels + kbps, rate, channels,
                    max(0.06, 3000 / rate))
    (got, xd), (want, jxd) = encode_both(
        "faac", rate, channels, f"bitrate={kbps}", pcm,
        int(round(rate / 25.0)))
    assert got == want and len(got) >= 2
    assert xd == jxd
    assert xd["audio_byte_rate"] == struct.pack("<I", kbps * 1000 // 8)
    # raw AAC-LC frames behind the AudioSpecificConfig, 1024 samples each
    assert xd["audio_frame_size"] == struct.pack("<I", 1024)
    assert xd["audio_extradata"][0] >> 3 == 2


FLAC_CASES = [(rate, ch) for rate in (8000, 22050, 44100, 48000, 96000)
              for ch in (1, 2)]


@pytest.mark.parametrize("rate,channels", FLAC_CASES)
def test_flac_matches_the_jax_module_and_decodes_to_its_input(
        rate, channels, native_encoders):
    pcm = level_pcm(rate + channels, rate, channels, 0.1)
    (got, xd), (want, jxd) = encode_both(
        "flac", rate, channels, "", pcm, int(round(rate / 25.0)))
    assert got == want and got
    assert xd == jxd
    stream = (b"fLaC" + bytes([0x80]) + len(xd["audio_extradata"])
              .to_bytes(3, "big") + xd["audio_extradata"] + b"".join(got))
    out, r, ch, bps = tflac.decode_stream(stream)
    used = len(pcm) // int(round(rate / 25.0)) * int(round(rate / 25.0))
    assert (r, ch, bps) == (rate, channels, 16)
    np.testing.assert_array_equal(out, pcm[:used])


@pytest.mark.parametrize("name,default", [("faac", 128), ("flac", 0)])
def test_the_default_and_job_bitrates_match_jax(name, default,
                                                native_encoders):
    for mp3bitrate, want in ((0, default), (96, 96)):
        port_job, jax_job = jobs(a_rate=44100, a_chan=2, dm_chan=2)
        port_job.mp3bitrate = jax_job.mp3bitrate = mp3bitrate
        registry.new_module(K.ENCODER, name, port_job)
        jregistry.new_module(JK.ENCODER, name, jax_job)
        assert port_job.extradata == jax_job.extradata
        assert port_job.extradata["audio_byte_rate"] == struct.pack(
            "<I", want * 1000 // 8)


# ------------------------------------------------------------------ #
# AU and VAG

AU_CASES = {
    "linear16_stereo": (3, 44100, 2), "linear16_mono": (3, 8000, 1),
    "linear8": (2, 11025, 1), "mulaw": (1, 8000, 1),
    "mulaw_stereo": (1, 16000, 2), "unknown_length": (3, 22050, 2),
}


def write_au_file(path, encoding, rate, channels, seed, frames=3000,
                  size=None):
    body = np.random.default_rng(seed).integers(
        0, 256, frames * channels * (2 if encoding == 3 else 1),
        np.uint8).tobytes()
    size = len(body) if size is None else size
    Path(path).write_bytes(b".snd" + struct.pack(
        ">IIIII", 28, size, encoding, rate, channels) + b"info" + body)


@pytest.mark.parametrize("case", sorted(AU_CASES))
def test_au_files_read_as_in_jax(case, tmp_path):
    enc, rate, ch = AU_CASES[case]
    path = tmp_path / "a.au"
    write_au_file(path, enc, rate, ch, len(case),
                  size=0xFFFFFFFF if case == "unknown_length" else None)
    ours, ref = tau.AuReader(str(path)), jau.AuReader(str(path))
    assert (ours.rate, ours.channels, ours.encoding) == \
        (ref.rate, ref.channels, ref.encoding) == (rate, ch, enc)
    for n in (1, 700, 4096, 5000):
        a, b = ours.read_samples(n), ref.read_samples(n)
        if b is None:
            assert a is None
            break
        np.testing.assert_array_equal(a, b)
        assert a.dtype == np.int16 and a.shape[1] == ch
    ours.close()
    ref.close()


@pytest.mark.parametrize("encoding,error", [(27, NotImplementedError),
                                            (6, NotImplementedError)])
def test_au_encodings_the_reader_lacks_are_refused_alike(
        encoding, error, tmp_path):
    """A-law (27) and float (6): the JAX reader refuses them, and so does
    the port's copy, with the same message."""
    path = tmp_path / "a.au"
    write_au_file(path, encoding, 8000, 1, 0)
    with pytest.raises(error) as ours:
        tau.AuReader(str(path))
    with pytest.raises(error) as ref:
        jau.AuReader(str(path))
    assert str(ours.value) == str(ref.value)


def test_au_junk_is_refused_alike(tmp_path):
    path = tmp_path / "a.au"
    path.write_bytes(b".snx" + bytes(40))
    with pytest.raises(ValueError):
        tau.AuReader(str(path))
    with pytest.raises(ValueError):
        jau.AuReader(str(path))


def write_sshd(path, seed, channels, block, pcm=False, blocks=40):
    rng = np.random.default_rng(seed)
    body = bytearray()
    for _ in range(blocks * channels):
        body += bytes([int(rng.integers(0, 5)) << 4
                       | int(rng.integers(0, 13)), 0])
        body += rng.integers(0, 256, 14, dtype=np.uint8).tobytes()
    head = b"SShd" + struct.pack("<I", 24) + struct.pack(
        "<IIII", 1 if pcm else 0, 32000, channels, block) + bytes(8)
    Path(path).write_bytes(head + b"SSbd" + struct.pack("<I", len(body))
                           + bytes(body))


VAG_CASES = ["vagp", "sshd_stereo_256", "sshd_stereo_64", "sshd_mono",
             "sshd_pcm"]


def vag_file(case, path):
    if case == "vagp":
        chip_smoke.write_vag(path, 5, 120)
    elif case == "sshd_pcm":
        write_sshd(path, 7, 2, 0x100, pcm=True)
    else:
        block = 64 if case.endswith("64") else 256
        write_sshd(path, 9, 1 if case == "sshd_mono" else 2, block)


@pytest.mark.parametrize("case", VAG_CASES)
def test_vag_files_read_as_in_jax(case, tmp_path):
    path = tmp_path / "a.vag"
    vag_file(case, path)
    ours, ref = tvag.VagReader(str(path)), jvag.VagReader(str(path))
    assert vars(ours.info) == vars(ref.info)
    for n in (28, 100, 1000, 5000):
        a, b = ours.read(n), ref.read(n)
        if b is None:
            assert a is None
            break
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------------ #
# the importer modules against the JAX modules

def read_all(imp, n=333):
    out = []
    while (got := imp.read_audio_batch(n)) is not None and len(got):
        out.append(np.asarray(got))
    return np.concatenate(out) if out else None


def both_importers(name, path, options=""):
    port = registry.new_module(K.DEMULTIPLEXOR, name, Job(), options)
    ref = jregistry.new_module(JK.DEMULTIPLEXOR, name, JJob(), options)
    port.open(str(path))
    ref.open(str(path))
    return port, ref


IMPORT_CASES = ["au", "mulaw", "vag", "vag_blocksize", "sshd_pcm"]


@pytest.mark.parametrize("case", IMPORT_CASES)
def test_the_audio_importers_match_the_jax_modules(case, tmp_path):
    path = tmp_path / "a.bin"
    options = ""
    if case in ("au", "mulaw"):
        chip_smoke.write_au(path, seeded_pcm(4, 5000, 2), 44100,
                            ulaw=case == "mulaw")
        name = "au"
    else:
        vag_file("sshd_pcm" if case == "sshd_pcm" else "sshd_stereo_256",
                 path)
        name = "vag"
        if case == "vag_blocksize":
            options = "blocksize=128"
    port, ref = both_importers(name, path, options)
    assert (port.audio_rate, port.audio_channels) == \
        (ref.audio_rate, ref.audio_channels)
    assert port.read_video_batch(4) is None
    np.testing.assert_array_equal(read_all(port), read_all(ref))
    port.close()
    ref.close()


def test_the_null_importer_matches_the_jax_module(tmp_path):
    port, ref = both_importers("null", tmp_path / "none")
    assert (port.width, port.audio_rate) == (ref.width, ref.audio_rate) \
        == (0, 0)
    assert port.read_video_batch(3) is None
    assert port.read_audio_batch(100) is None


def ogm_file(path, kind: str):
    """An Ogg file the JAX ogg multiplexor writes: raw I420/YV12 video
    with PCM or Vorbis audio, a fourcc it does not decode, or nothing it
    reads."""
    fourcc = {"yv12": "YV12", "divx": "XVID", "yuy2": "YUY2"}.get(kind,
                                                                  "I420")
    job = JJob()
    job.im_v_width, job.im_v_height, job.fps = 32, 16, 25.0
    job.a_rate, job.dm_chan = 16000, 2
    enc = None
    if kind in ("vorbis", "divx"):
        enc = jregistry.new_module(JK.ENCODER, "vorbis", job,
                                   "blocksize=256")
    if kind == "none":
        job.a_rate = 0
    mux = jregistry.new_module(JK.MULTIPLEXOR, "ogg", job,
                               f"fourcc={fourcc}")
    mux.open(str(path))
    rng = np.random.default_rng(2)
    pcm = seeded_pcm(8, 640 * 6, 2)
    for k in range(6):
        mux.write_video(rng.integers(0, 256, 32 * 16 * 3 // 2,
                                     np.uint8).tobytes())
        part = pcm[640 * k:640 * (k + 1)]
        if enc is not None:
            for p in enc.encode_audio(JAudioBatch(pcm=part[None])):
                mux.write_audio(p)
        elif kind != "none":
            mux.write_audio(part.tobytes())
    if enc is not None:
        for p in enc.flush():
            mux.write_audio(p)
    mux.close()


@pytest.mark.parametrize("kind", ["pcm", "vorbis", "yv12"])
def test_the_ogg_importer_matches_the_jax_module(kind, tmp_path):
    path = tmp_path / "a.ogm"
    ogm_file(path, kind)
    port, ref = both_importers("ogg", path)
    assert (port.width, port.height, port.fps, port.total_frames,
            port.audio_rate, port.audio_channels) == \
        (ref.width, ref.height, ref.fps, ref.total_frames,
         ref.audio_rate, ref.audio_channels)
    for n in (4, 4):
        a, b = port.read_video_batch(n), ref.read_video_batch(n)
        for key in "yuv":
            np.testing.assert_array_equal(a[key], b[key])
    np.testing.assert_array_equal(read_all(port, 700), read_all(ref, 700))


def test_a_divx_ogm_plays_as_its_audio_as_in_jax(tmp_path):
    """The JAX module decodes no DivX/Xvid OGM video: the file has no
    width and its Vorbis track alone serves (an audio-only session)."""
    path = tmp_path / "a.ogm"
    ogm_file(path, "divx")
    port, ref = both_importers("ogg", path)
    assert (port.width, ref.width) == (0, 0)
    assert port.audio_rate == ref.audio_rate == 16000
    np.testing.assert_array_equal(read_all(port), read_all(ref))


@pytest.mark.parametrize("kind,match", [
    ("yuy2", "OGM raw fourcc 'YUY2' not wired yet"),
    ("none", "found streams: I420 .video.")])
def test_what_the_ogg_importer_refuses_is_the_jax_modules(kind, match,
                                                          tmp_path):
    path = tmp_path / "a.ogm"
    ogm_file(path, kind)
    if kind == "none":
        # a video stream with a fourcc neither reads, and no audio
        data = path.read_bytes().replace(b"I420", b"HFYU")
        path.write_bytes(data)
        match = "found streams: HFYU .video."
    for reg, kinds, job in ((registry, K, Job()), (jregistry, JK, JJob())):
        imp = reg.new_module(kinds.DEMULTIPLEXOR, "ogg", job)
        with pytest.raises(NotImplementedError, match=match):
            imp.open(str(path))


def test_theora_video_is_refused_by_name_and_its_audio_serves_p(
        tmp_path, monkeypatch):
    """Theora video decodes now (the JAX module's in-tree route, its
    Python token path): a fixture's batches equal the JAX importer's.  As
    -p (``video_wanted`` False) a file's Theora stream is not decoded and
    its audio serves, even beside a Theora stream with no setup header,
    which as -i raises the JAX decoder's message."""
    from tcforge_tpu.io.ogg import (OggPageWriter, ogm_audio_header,
                                    ogm_data_packet)
    monkeypatch.setenv("TCFORGE_NATIVE_THEORA", "1")
    monkeypatch.setenv("TCFORGE_NATIVE_THEORA_TOKENS", "0")
    fixture = Path(__file__).resolve().parent / "data" / "theora" / \
        "yuv420.ogv"
    imp = registry.new_module(K.DEMULTIPLEXOR, "ogg", Job())
    imp.open(str(fixture))
    imp.start(torch.device("cpu"))
    ref = jregistry.new_module(JK.DEMULTIPLEXOR, "ogg", JJob())
    ref.open(str(fixture))
    for n in (3, 5):
        got, want = imp.read_video_batch(n), ref.read_video_batch(n)
        for k in "yuv":
            np.testing.assert_array_equal(got[k].numpy(), want[k])
    path = tmp_path / "t.ogg"
    ident = bytearray(42)
    ident[0:7] = b"\x80theora"
    ident[7:10] = bytes([3, 2, 1])
    ident[10:14] = struct.pack(">HH", 2, 1)
    ident[14:20] = (32).to_bytes(3, "big") + (16).to_bytes(3, "big")
    ident[22:30] = struct.pack(">II", 25, 1)
    pcm = (np.arange(800, dtype=np.int16) * 37).tobytes()
    with open(path, "wb") as f:
        video, audio = OggPageWriter(f, 7), OggPageWriter(f, 8)
        video.write_packet(bytes(ident), 0, flush=True)
        audio.write_packet(ogm_audio_header(8000, 2, 16, 4), 0, flush=True)
        audio.write_packet(ogm_data_packet(pcm, len(pcm) // 4, True),
                           len(pcm) // 4, flush=True)
        video.close()
        audio.close()
    imp = registry.new_module(K.DEMULTIPLEXOR, "ogg", Job())
    with pytest.raises(ValueError, match="3 header packets"):
        imp.open(str(path))
    imp = registry.new_module(K.DEMULTIPLEXOR, "ogg", Job())
    imp.video_wanted = False
    imp.open(str(path))
    assert not imp.width and imp.audio_rate == 8000
    np.testing.assert_array_equal(imp.read_audio_batch(400).reshape(-1),
                                  np.frombuffer(pcm, np.int16))


# ------------------------------------------------------------------ #
# the registry

SLICE_MODULES = [(K.DEMULTIPLEXOR, n) for n in ("ogg", "au", "vag",
                                                "null")] + [
    (K.ENCODER, n) for n in ("vorbis", "faac", "flac")] + [
    (K.MULTIPLEXOR, "ogg")]


@pytest.mark.parametrize("kind,name", SLICE_MODULES,
                         ids=[f"{k.value}-{n}" for k, n in SLICE_MODULES])
def test_the_slice_modules_carry_the_jax_registry_entries(kind, name):
    ours = registry.lookup(kind, name)
    ref = jregistry.lookup(JK(kind.value), name)

    def info(i):
        return (i.name, i.kind.value, i.media,
                [c.value for c in i.codecs_in],
                [c.value for c in i.codecs_out],
                [f.value for f in i.formats_in],
                [f.value for f in i.formats_out])
    assert info(ours.info) == info(ref.info)
    assert ours.desc.name == ref.desc.name
    if name not in ("faac", "flac"):
        # the two encoders' comments name the port's in-tree route alone
        assert ours.desc.comment == ref.desc.comment
    assert ([(p.name, p.fmt, p.default, p.lo, p.hi)
             for p in ours.desc.params]
            == [(p.name, p.fmt, p.default, p.lo, p.hi)
                for p in ref.desc.params])


# ------------------------------------------------------------------ #
# the slice's CLI goldens

HERE = [case for case in chip_smoke.ROUTE_GOLDEN
        if list(chip_smoke.ROUTE_GOLDEN).index(case)
        >= list(chip_smoke.ROUTE_GOLDEN).index("aac_lame_avi")]


@pytest.fixture(scope="module")
def goldens(tmp_path_factory, jax_native):
    return run_route_goldens(HERE, tmp_path_factory.mktemp("ogg_routes"))


@pytest.mark.parametrize("case", HERE)
def test_the_slice_golden_matches_the_jax_cli(case, goldens):
    got = goldens[case]
    assert got["port"] == got["jax"], case
    rc, files = got["port"]
    assert rc == chip_smoke.ROUTE_GOLDEN[case][3]
    assert None not in files
    digests = tuple(chip_smoke.hashlib.sha256(b).hexdigest() for b in files)
    assert digests == chip_smoke.ROUTE_GOLDEN_SHA256[case]


def test_the_ogm_reads_back_as_it_was_written(goldens):
    """ogm_in reads vob_vorbis_ogg's OGM: a Y4M frame for each OGM video
    packet, and a WAV of the VOB track's rate and channels whose length
    is the last page's granule (the encoder's true sample count)."""
    _, (ogm,) = goldens["vob_vorbis_ogg"]["port"]
    _, (y4m, wav) = goldens["ogm_in"]["port"]
    streams = togg.identify_streams(io.BytesIO(ogm))
    assert [(s.kind, s.codec) for s in streams] == [("video", "I420"),
                                                    ("audio", "vorbis")]
    pages = list(togg.iter_pages(io.BytesIO(ogm), check_crc=True))
    video = [p for _, p in togg.pages_to_packets(iter(pages),
                                                 streams[0].serial)]
    assert y4m.count(b"FRAME\n") == len(video) - 2   # two header packets
    channels, rate = struct.unpack("<HI", wav[22:28])
    assert (channels, rate) == (streams[1].channels, streams[1].samplerate)
    last = max(p.granule for p in pages if p.serial == streams[1].serial)
    assert (len(wav) - 44) // (2 * channels) == last
