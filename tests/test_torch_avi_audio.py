"""An AVI's compressed audio track through the port, on the CPU.

The JAX avi importer decodes MP2, MP3 (tags 0x50, 0x55) and AC-3
(0x2000) through its FFmpeg bridge (libavcodec), which the port does not
carry.  The port feeds the track's chunks in file order to the in-tree
decoders (``io/mp2dec.py``'s ``StreamDecoder``, which hands Layer III to
``io/mp3dec.py``, and ``io/a52dec.py``) in a worker process
(``io/adec_worker.py``) and flushes them at the track's end: the JAX
package's own route without the bridge (its ``audio_import`` and
``mpeg_import`` take it).  So the golden is the JAX importer and CLI with
``AvAudioDecoder`` patched to those decoders (``in_tree_audio``), held
exactly; against the unpatched JAX importer (libavcodec) the samples
have the same count and stay within the bounds the JAX package's own
tests set for each codec (``tests/test_mp3dec.py``: 2, ``test_mp2.py``:
4, ``test_a52.py``: 1 LSB).  ``-a`` picks the track, ``-L`` drops the
decoded samples, ``audio_channels`` follows the decoder.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import chip_smoke
from tcforge_tpu.core.job import Job as JJob
from tcforge_tpu.io.avi import (AviAudioStream, AviReader, AviVideoStream,
                                AviWriter)
from tcforge_tpu.modules.registry import ModuleKind as JKind
from tcforge_tpu.modules.registry import new_module as jax_new_module
from tcforge_tpu_torch.core.job import Job
from tcforge_tpu_torch.io import adec_worker
from tcforge_tpu_torch.modules.registry import ModuleKind, new_module
from test_torch_mjpeg import (assert_golden, in_tree_audio, jax_cli,
                              make_streams, port_cli, run_goldens)

DATA = chip_smoke.MJPEG_DATA
CPU = torch.device("cpu")
# the track of each kind, and the JAX package's bound against libavcodec
TRACKS = {"mp3": ("legacy.avi", 2), "mp3_small": ("small.avi", 2),
          "mp2": ("mp2.avi", 4), "ac3": ("ac3.avi", 1)}
AUDIO_GOLDEN = ("small_b4", "mp2", "ac3_seek")


def _importer(path, jax: bool, **opts):
    if jax:
        import tcforge_tpu.modules  # noqa: F401
        imp = jax_new_module(JKind.DEMULTIPLEXOR, "avi", JJob(**opts))
    else:
        import tcforge_tpu_torch.modules  # noqa: F401
        imp = new_module(ModuleKind.DEMULTIPLEXOR, "avi", Job(**opts))
    imp.open(str(path))
    return imp


def read_track(path, jax: bool, n: int, skip: int = 0, **opts):
    """Every sample of ``path``'s track read ``n`` at a time after
    ``seek(skip)`` where ``skip``: (samples, channels after)."""
    imp = _importer(path, jax, **opts)
    if skip:
        assert imp.seek(skip)
    out = []
    while (pcm := imp.read_audio_batch(n)) is not None:
        out.append(np.asarray(pcm))
    channels = imp.audio_channels
    imp.close()
    return np.concatenate(out), channels


@pytest.mark.parametrize("n", [1152, 1602, 100000])
@pytest.mark.parametrize("kind", sorted(TRACKS))
def test_track_matches_the_jax_importers_in_tree_route(kind, n):
    path = DATA / TRACKS[kind][0]
    got, ch = read_track(path, False, n)
    with in_tree_audio():
        want, jch = read_track(path, True, n)
    assert got.dtype == np.int16 and ch == jch == got.shape[1]
    assert np.array_equal(got, want)


@pytest.mark.parametrize("kind", sorted(TRACKS))
def test_track_matches_the_jax_bridge_within_its_bound(kind):
    """The stated difference from the JAX CLI in its bridge build: the
    same count of samples, within the JAX package's own bound for the
    codec against libavcodec."""
    import tcforge_tpu.native.av as av
    if not av.available():
        pytest.fail("the JAX package's FFmpeg bridge is not built")
    name, bound = TRACKS[kind]
    got, _ = read_track(DATA / name, False, 100000)
    want, _ = read_track(DATA / name, True, 100000)
    assert got.shape == want.shape
    assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() \
        <= bound


@pytest.mark.parametrize("skip", [1, 3])
@pytest.mark.parametrize("kind", ["mp2", "ac3"])
def test_a_seek_drops_the_decoded_samples_as_the_jax_importer(kind, skip):
    path = DATA / TRACKS[kind][0]
    got, _ = read_track(path, False, 4000, skip=skip)
    with in_tree_audio():
        want, _ = read_track(path, True, 4000, skip=skip)
    assert np.array_equal(got, want)


@pytest.fixture(scope="module")
def two_tracks(tmp_path_factory):
    """small.avi's video with mp2.avi's track first and ac3.avi's
    second."""
    path = tmp_path_factory.mktemp("tracks") / "two.avi"
    tracks = []
    for name in ("mp2.avi", "ac3.avi"):
        with AviReader(str(DATA / name)) as r:
            a = r.audio[0]
            tracks.append((AviAudioStream(
                format_tag=a.format_tag, channels=a.channels, rate=a.rate,
                bits=a.bits, byte_rate=a.byte_rate),
                list(r.read_audio_chunks(0))))
            video = [r.read_video_frame(i)[0]
                     for i in range(r.video_frames)]
    w = AviWriter(str(path), AviVideoStream(fourcc="MJPG", width=64,
                                            height=48, fps=30000 / 1001),
                  [t[0] for t in tracks])
    for i, chunk in enumerate(video):
        w.write_video_frame(chunk)
        for k, (_s, payloads) in enumerate(tracks):
            per = -(-len(payloads) // len(video))
            for p in payloads[i * per:(i + 1) * per]:
                w.write_audio(p, k)
    w.close()
    return path


@pytest.mark.parametrize("how", ["option", "job"])
@pytest.mark.parametrize("track", [0, 1])
def test_the_track_option_and_a_pick_the_track(two_tracks, track, how):
    opts = ({"a_track": track} if how == "job" else {})
    imp = _importer(two_tracks, False, **opts)
    if how == "option":
        imp.close()
        import tcforge_tpu_torch.modules  # noqa: F401
        imp = new_module(ModuleKind.DEMULTIPLEXOR, "avi", Job(),
                         f"track={track}")
        imp.open(str(two_tracks))
    got = []
    while (pcm := imp.read_audio_batch(3000)) is not None:
        got.append(pcm)
    imp.close()
    want, _ = read_track(DATA / ("mp2.avi", "ac3.avi")[track], False, 3000)
    assert np.array_equal(np.concatenate(got), want)


@pytest.mark.parametrize("track", ["0", "1"])
def test_a_picks_the_track_through_both_clis(two_tracks, track, tmp_path):
    outs = {}
    for key, run in (("jax", jax_cli), ("port", port_cli)):
        wav = tmp_path / f"{key}.wav"
        with in_tree_audio():
            assert run(["-i", str(two_tracks), "-a", track, "-o",
                        str(tmp_path / f"{key}.y4m"), "-m", str(wav)]) == 0
        outs[key] = wav.read_bytes()
    assert outs["port"] == outs["jax"]
    assert len(outs["port"]) > 20000


@pytest.fixture(scope="module")
def mono_in_stereo(tmp_path_factory):
    """An MP2 track whose header says stereo and whose frames are mono."""
    from tcforge_tpu.io.mpaenc import NativeAudioEncoder
    path = tmp_path_factory.mktemp("mono") / "mono.avi"
    rng = np.random.default_rng(3)
    enc = NativeAudioEncoder(48000, 1, 96000)
    enc.feed((rng.standard_normal((48000 // 4, 1)) * 3000).astype(np.int16))
    enc.flush()
    frames = enc.read_packets()
    w = AviWriter(str(path), AviVideoStream(fourcc="MJPG", width=64,
                                            height=48, fps=25.0),
                  [AviAudioStream(format_tag=0x50, channels=2, rate=48000,
                                  bits=0, byte_rate=12000)])
    video = make_streams.pil_jpeg(make_streams.test_rgb(64, 48, 1))
    for i in range(6):
        w.write_video_frame(video)
        for f in frames[2 * i:2 * i + 2]:
            w.write_audio(f)
    w.close()
    return path


def test_audio_channels_follow_the_decoder(mono_in_stereo, tmp_path):
    got, ch = read_track(mono_in_stereo, False, 1920)
    with in_tree_audio():
        want, jch = read_track(mono_in_stereo, True, 1920)
    assert ch == jch == 1 and np.array_equal(got, want)
    outs = {}
    for key, run in (("jax", jax_cli), ("port", port_cli)):
        d = tmp_path / key
        d.mkdir()
        with in_tree_audio():
            rc = run(["-i", str(mono_in_stereo), "-y", "raw,raw,avi", "-o",
                      str(d / "o.avi")])
        outs[key] = (rc, (d / "o.avi").read_bytes() if rc == 0 else None)
    assert outs["port"] == outs["jax"]


def test_the_decode_runs_in_the_worker_process():
    """The samples come from the worker (its decoders' own time counts
    there), and a closed importer leaves its worker idle for the next."""
    before = adec_worker.decode_seconds()
    read_track(DATA / "mp2.avi", False, 100000)
    assert adec_worker.decode_seconds() > before
    assert adec_worker._IDLE.get("mp2")


@pytest.fixture(scope="module")
def audio_goldens(tmp_path_factory):
    return run_goldens(AUDIO_GOLDEN, tmp_path_factory.mktemp("avi_audio"))


@pytest.mark.parametrize("case", AUDIO_GOLDEN)
def test_audio_golden_cli_matches_jax_cli_byte_for_byte(case, audio_goldens):
    assert_golden(audio_goldens, case)
