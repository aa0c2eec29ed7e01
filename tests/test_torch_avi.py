"""The port's AVI container, raw and LZO2 frames and the ``avi``
multiplexor, on the CPU, against the JAX package.

- ``io/avi.AviWriter`` (pinned copy) writes the JAX writer's bytes: PCM
  tracks, OpenDML segments with their ``ix##`` indexes, LIST INFO; and
  ``AviReader`` reads every fixture and an OpenDML file as the JAX
  reader does;
- ``io/rawio`` unpacks and packs every raw fourcc's layout as JAX's;
  the port's LZO1X decoder (``native/av.py``, the JAX package reaches
  libavutil's) inverts the JAX compressor and equals the bridge;
- ``probe_file`` on an AVI answers as the JAX probe;
- raw fourccs through both CLIs (I420, YV12, UYVY, RGB, DIB), the
  ``avi`` multiplexor with ``-F`` and ``--avi_comments``, and the
  ``lzo`` encoder, byte for byte.
"""

from __future__ import annotations

import numpy as np
import pytest

import chip_smoke
from tcforge_tpu.cli import main as jax_cli_main
from tcforge_tpu.core.formats import ImageFormat as JFormat
from tcforge_tpu.io import avi as javi
from tcforge_tpu.io import rawio as jrawio
from tcforge_tpu.io import tclzo as jlzo
from tcforge_tpu.io.probe import probe_file as jax_probe_file
from tcforge_tpu_torch.core.formats import ImageFormat
from tcforge_tpu_torch.io import avi as tavi
from tcforge_tpu_torch.io import rawio as trawio
from tcforge_tpu_torch.io import tclzo as tlzo
from tcforge_tpu_torch.io.probe import probe_file
from tcforge_tpu_torch.native.av import lzo1x_decode
from test_torch_engine import run_cli

DATA = chip_smoke.MPEG4_DATA
AVIS = sorted(p.name for p in DATA.glob("*.avi"))


def _write(mod, path, spec, frames):
    """An AVI written by ``mod``'s writer from ``spec``: the video fourcc
    and size, the audio tracks, the segment limit and comments."""
    tracks = [mod.AviAudioStream(**t) for t in spec.get("audio", [])]
    w = mod.AviWriter(str(path), mod.AviVideoStream(
        fourcc=spec.get("fourcc", "I420"), width=32, height=16, fps=25.0),
        tracks, comments=spec.get("comments"),
        **({"segment_limit": spec["limit"]} if "limit" in spec else {}))
    rng = np.random.default_rng(4)
    for i in range(frames):
        w.write_video_frame(rng.integers(0, 256, 768, dtype=np.uint8)
                            .tobytes(), keyframe=(i % 3 == 0))
        for k in range(len(tracks)):
            w.write_audio(rng.integers(0, 256, 400 + 4 * k, dtype=np.uint8)
                          .tobytes(), k)
    w.close()
    return path


WRITER_CASES = {
    "video": {},
    "pcm": {"audio": [dict(rate=48000, channels=2, bits=16)]},
    "two_tracks": {"audio": [dict(rate=48000, channels=2, bits=16),
                             dict(rate=22050, channels=1, bits=8)]},
    "mp3_tag": {"audio": [dict(format_tag=0x55, byte_rate=16000)]},
    "info": {"comments": {"INAM": "a title", "ICMT": "a comment"}},
    "opendml": {"limit": 8192, "audio": [dict(rate=8000)]},
    "yuy2": {"fourcc": "YUY2"},
    "xvid": {"fourcc": "XVID"},
}


@pytest.mark.parametrize("case", sorted(WRITER_CASES))
def test_avi_writer_writes_the_jax_writers_bytes(case, tmp_path):
    spec = WRITER_CASES[case]
    ours = _write(tavi, tmp_path / "port.avi", spec, 40)
    ref = _write(javi, tmp_path / "jax.avi", spec, 40)
    assert ours.read_bytes() == ref.read_bytes()


def _read(mod, path):
    with mod.AviReader(str(path)) as r:
        video = [r.read_video_frame(i) for i in range(r.video_frames)]
        audio = [list(r.read_audio_chunks(k)) for k in range(len(r.audio))]
        return (vars(r.video), [vars(a) for a in r.audio], video, audio)


@pytest.mark.parametrize("name", AVIS)
def test_avi_reader_reads_every_fixture_as_jax(name):
    assert _read(tavi, DATA / name) == _read(javi, DATA / name)


@pytest.mark.parametrize("case", ["opendml", "two_tracks", "info"])
def test_avi_reader_reads_written_files_as_jax(case, tmp_path):
    path = _write(javi, tmp_path / "in.avi", WRITER_CASES[case], 40)
    assert _read(tavi, path) == _read(javi, path)


@pytest.mark.parametrize("name", AVIS)
def test_probe_file_answers_as_the_jax_probe(name):
    ours, ref = probe_file(str(DATA / name)), jax_probe_file(str(DATA / name))
    assert ours.magic.value == ref.magic.value
    assert (ours.width, ours.height, ours.fps, ours.num_frames) == \
        (ref.width, ref.height, ref.fps, ref.num_frames)
    assert ours.codec.value == ref.codec.value
    assert ours.format.value == ref.format.value
    assert [(t.codec.value, t.samplerate, t.channels, t.bits)
            for t in ours.tracks] == [(t.codec.value, t.samplerate,
                                       t.channels, t.bits)
                                      for t in ref.tracks]


FORMATS = ["YUV420P", "YV12", "YUY2", "UYVY", "YVYU", "RGB24", "BGR24",
           "YUV422P"]


@pytest.mark.parametrize("fmt", FORMATS)
def test_rawio_unpacks_and_packs_as_jax(fmt):
    w, h = 10, 6
    size = JFormat[fmt].frame_bytes(w, h)
    raw = np.random.default_rng(1).integers(0, 256, size,
                                            dtype=np.uint8).tobytes()
    ours = trawio.unpack_frame(raw, ImageFormat[fmt], w, h)
    ref = jrawio.unpack_frame(raw, JFormat[fmt], w, h)
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        assert np.array_equal(a, b)
    assert trawio.pack_frame(ours, ImageFormat[fmt]) == \
        jrawio.pack_frame(ref, JFormat[fmt]) == raw


@pytest.mark.parametrize("seed", range(8))
def test_lzo1x_decoder_inverts_the_compressor_and_equals_the_bridge(seed):
    from tcforge_tpu.native import av
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 30000))
    kind = seed % 4
    if kind == 0:
        data = rng.integers(0, 4, n, dtype=np.uint8)
    elif kind == 1:
        data = (np.arange(n) // int(rng.integers(1, 40))).astype(np.uint8)
    elif kind == 2:
        data = np.repeat(rng.integers(0, 256, n // 5 + 1, dtype=np.uint8),
                         5)[:n]
    else:
        data = rng.integers(0, 256, n, dtype=np.uint8)
    data = data.tobytes()
    comp = jlzo.lzo1x_compress(data)
    assert lzo1x_decode(comp, n + 64) == data
    assert lzo1x_decode(comp, n + 64) == av.lzo1x_decode(comp, n + 64)


@pytest.mark.parametrize("bad", [b"", b"\x40", b"\x12\x00"])
def test_lzo1x_decoder_refuses_a_broken_stream(bad):
    with pytest.raises(ValueError):
        lzo1x_decode(bad, 100)


def test_lzo_frames_unpack_as_jax():
    with tavi.AviReader(str(DATA / "lzo.avi")) as r:
        for i in range(r.video_frames):
            raw = r.read_video_frame(i)[0]
            assert tlzo.unpack_frame(raw, 64 * 48 * 3 // 2 + 64) == \
                jlzo.unpack_frame(raw, 64 * 48 * 3 // 2 + 64)


# ------------------------------------------------------------------ #
# through both CLIs

def jax_cli(argv):
    return jax_cli_main([*argv, "--mesh", "off", "-q", "--progress_off"])


def port_cli(argv):
    return run_cli([*argv, "--device", "cpu", "-q", "--progress_off"])


def _raw_avi(path, fourcc, fmt, frames=3, w=32, h=16, audio=True):
    """A raw AVI of seeded frames in ``fmt``'s layout with a PCM track."""
    rng = np.random.default_rng(9)
    tracks = [javi.AviAudioStream(rate=8000, channels=2, bits=16)] \
        if audio else []
    wr = javi.AviWriter(str(path), javi.AviVideoStream(
        fourcc=fourcc, width=w, height=h, fps=25.0), tracks)
    for _ in range(frames):
        wr.write_video_frame(rng.integers(
            0, 256, JFormat[fmt].frame_bytes(w, h), dtype=np.uint8)
            .tobytes())
        if audio:
            wr.write_audio(rng.integers(-3000, 3000, 640, dtype=np.int16)
                           .tobytes())
    wr.close()
    return path


RAW_CASES = {
    "i420_y4m": ("I420", "YUV420P", ["-J", "hqdn3d"], "y4m"),
    "yv12_avi": ("YV12", "YV12", [], "avi"),
    "uyvy_avi": ("UYVY", "UYVY", ["-y", "raw,raw,avi"], "avi"),
    "rgb_avi": ("RGB ", "RGB24", ["-y", "raw,raw,avi"], "avi"),
    "dib_y4m": ("DIB ", "BGR24", [], "y4m"),
    "fourcc_comments": ("I420", "YUV420P",
                        ["-y", "raw,raw,avi", "-F", "XVID",
                         "--avi_comments", "{dir}/c.txt"], "avi"),
    "lzo_encoder": ("I420", "YUV420P", ["-y", "lzo,raw,avi", "-F", "LZO2",
                                        "-c", "1-3"], "avi"),
}


@pytest.mark.parametrize("case", sorted(RAW_CASES))
def test_raw_avi_cli_matches_jax_cli_byte_for_byte(case, tmp_path):
    fourcc, fmt, args, ext = RAW_CASES[case]
    src = _raw_avi(tmp_path / "in.avi", fourcc, fmt)
    (tmp_path / "c.txt").write_text("INAM a title\n# no\nICMT a comment\n")
    args = [a.replace("{dir}", str(tmp_path)) for a in args]
    outs = {}
    for key, run in (("jax", jax_cli), ("port", port_cli)):
        out = tmp_path / f"{key}.{ext}"
        assert run(["-i", str(src), "-o", str(out), *args]) == 0, key
        outs[key] = out.read_bytes()
    assert outs["port"] == outs["jax"]
