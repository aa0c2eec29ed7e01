"""The port's compressed-audio import modules (``mp3``, ``ac3``, ``flac``,
``aac``) against the JAX package's, on the CPU.

- Each module's samples, rate and channels against the JAX module's with
  its FFmpeg bridge's decoder replaced by the JAX package's in-tree
  decoders (``test_torch_ts.in_tree_bridge``), at several read sizes;
  each registered under its JAX name with the JAX module's description.
- ``-p`` picks the module by the file's magic as the JAX engine does,
  and refuses, naming the JAX module, a format the port still lacks
  (Ogg/Vorbis, Sun AU, a program stream); a worker process that dies
  raises.
- The worker process's kinds ``mp3`` and ``aac`` (and ``mp2``,
  ``ac3``) against the same decoders in this process;
  ``AdtsStreamDecoder`` against the JAX ``decode_adts_stream`` for every
  way of cutting the stream.
- The ``chip_smoke.TS_GOLDEN`` ``-p`` and audio-only cases through both
  CLIs, byte for byte, their SHA-256 pinned for ``chip_smoke.py``; an
  audio-only ``-i`` of each format through both CLIs.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest

import chip_smoke
from tcforge_tpu.io import aacdec as jaacdec
from tcforge_tpu.core.job import Job as JJob
from tcforge_tpu.modules.registry import ModuleKind as JKind
from tcforge_tpu.modules.registry import lookup as jax_lookup
from tcforge_tpu.modules.registry import new_module as jax_new_module
from tcforge_tpu_torch.core.job import Job
from tcforge_tpu_torch.io import adec_worker
from tcforge_tpu_torch.modules.registry import ModuleKind, lookup, new_module
from tcforge_tpu_torch.pipeline import engine
from test_torch_mpeg_import import jax_cli, jax_native, port_cli  # noqa: F401
from test_torch_ts import (adts_frames, assert_golden, in_tree_bridge,
                           run_goldens)

DATA = chip_smoke.TS_DATA
AUDIO_CASES = [c for c in chip_smoke.TS_GOLDEN
               if c.startswith("p_") or c == "audio_only"]
FILES = {"a.mp2": "mp3", "a.mp3": "mp3", "a.ac3": "ac3", "a.flac": "flac",
         "a.aac": "aac"}


def _read_all(imp, n: int):
    out = []
    while True:
        got = imp.read_audio_batch(n)
        if got is None:
            break
        assert 0 < got.shape[0] <= n
        out.append(np.asarray(got))
    return np.concatenate(out)


@pytest.fixture(scope="module")
def jax_samples():
    """Each file through the JAX module: (pcm, rate, channels)."""
    out = {}
    for name, module in FILES.items():
        imp = jax_new_module(JKind.DEMULTIPLEXOR, module, JJob())
        with in_tree_bridge():
            imp.open(str(DATA / name))
            out[name] = (_read_all(imp, 4096), imp.audio_rate,
                         imp.audio_channels)
        imp.close()
    return out


@pytest.mark.parametrize("n", [1, 1000, 48000])
@pytest.mark.parametrize("name", sorted(FILES))
def test_the_module_reads_what_the_jax_module_reads(name, n, jax_samples):
    imp = new_module(ModuleKind.DEMULTIPLEXOR, FILES[name], Job())
    imp.open(str(DATA / name))
    try:
        want, rate, channels = jax_samples[name]
        assert (imp.audio_rate, imp.audio_channels) == (rate, channels)
        got = _read_all(imp, n) if n > 1 else np.concatenate(
            [imp.read_audio_batch(1) for _ in range(50)]
            + [_read_all(imp, 7777)])
        assert got.dtype == np.int16
        assert np.array_equal(got, want) and want.shape[0] > 4000
        assert imp.read_audio_batch(10) is None
    finally:
        imp.close()


@pytest.mark.parametrize("module", ["mp3", "ac3", "flac", "aac"])
def test_the_modules_are_registered_as_in_jax(module):
    ours = lookup(ModuleKind.DEMULTIPLEXOR, module)
    ref = jax_lookup(JKind.DEMULTIPLEXOR, module)
    assert (ours.info.name, ours.info.media,
            [c.value for c in ours.info.codecs_out],
            [f.value for f in ours.info.formats_in]) == \
        (ref.info.name, ref.info.media,
         [c.value for c in ref.info.codecs_out],
         [f.value for f in ref.info.formats_in])
    assert (ours.desc.name, ours.desc.comment,
            [p.name for p in ours.desc.params]) == \
        (ref.desc.name, ref.desc.comment, [p.name for p in ref.desc.params])


@pytest.mark.parametrize("name", sorted(FILES))
def test_p_and_x_auto_pick_the_module_by_magic(name):
    assert engine.audio_module(str(DATA / name)) == FILES[name]
    job = Job(video_in_file=str(DATA / name))
    assert engine.video_module(job) == FILES[name]


@pytest.mark.parametrize("head,module", [
    (b"<?xml version" + bytes(64), "xml"), (b"PV5a" + bytes(64), "pvn"),
    (b"\x89PNG\r\n\x1a\n" + bytes(64), "im")])
def test_p_refuses_what_the_port_lacks_by_the_jax_module(head, module,
                                                         tmp_path):
    path = tmp_path / "a.bin"
    path.write_bytes(head + bytes(4096))
    with pytest.raises(NotImplementedError,
                       match=f"the {module} import module"):
        engine.audio_module(str(path))


def test_a_dead_worker_raises(monkeypatch):
    from tcforge_tpu_torch.modules.importers import audio_import
    monkeypatch.setattr(audio_import, "_CHUNK", 512)
    imp = new_module(ModuleKind.DEMULTIPLEXOR, "ac3", Job())
    imp.open(str(DATA / "a.ac3"))
    try:
        worker = imp._s.dec._worker
        worker.proc.kill()
        worker.proc.wait()
        with pytest.raises((RuntimeError, OSError)):
            _read_all(imp, 1 << 20)
    finally:
        imp.close()


# ------------------------------------------------------------------ #
# the worker process's decoders

@functools.lru_cache(maxsize=None)
def _adts_variant(name: str):
    """Four ADTS frames cut or wrapped as ``name`` says, and the JAX
    decoder's output of the whole."""
    frames = adts_frames((DATA / "a.aac").read_bytes())[:4]
    whole = b"".join(frames)
    data = {"whole": whole,
            "junk_ahead": bytes(range(200)) + whole,
            "junk_between": b"".join(f + b"\x00\x11\x22" for f in frames),
            "cut_last": whole[:-40],
            "sync_in_junk": b"\xff\xf1" * 30 + whole}[name]
    return data, jaacdec.decode_adts_stream(data)


@pytest.mark.parametrize("variant", ["whole", "junk_ahead", "junk_between",
                                     "cut_last", "sync_in_junk"])
@pytest.mark.parametrize("piece", [1, 7, 333, 1 << 20])
def test_adts_pieces_decode_as_the_whole_stream(variant, piece):
    data, (want, rate, channels) = _adts_variant(variant)
    dec = adec_worker.AdtsStreamDecoder()
    got = []
    for off in range(0, len(data), piece):
        dec.feed(data[off:off + piece])
        pcm = dec.read()
        if pcm is not None:
            got.append(pcm)
    dec.flush()
    pcm = dec.read()
    if pcm is not None:
        got.append(pcm)
    assert np.array_equal(np.concatenate(got), want)
    assert (dec.rate, dec.channels) == (rate, channels)


def test_adts_without_a_frame_raises_at_the_flush():
    dec = adec_worker.AdtsStreamDecoder()
    dec.feed(b"\x00" * 500)
    with pytest.raises(ValueError, match="no decodable ADTS frames"):
        dec.flush()


@pytest.mark.parametrize("kind,name", [("mp3", "a.mp3"), ("mp2", "a.mp2"),
                                       ("aac", "a.aac"), ("ac3", "a.ac3")])
def test_the_worker_kinds_decode_as_in_process(kind, name):
    data = (DATA / name).read_bytes()
    ref = adec_worker.new_stream_decoder(kind)
    ref.feed(data)
    ref.flush()
    want = ref.read()
    dec = adec_worker.Decoder(kind)
    try:
        got = []
        for off in range(0, len(data), 1000):
            dec.submit("feed", data[off:off + 1000])
        dec.submit("flush")
        while dec.pending:
            pcm, rate = dec.result()
            if pcm is not None:
                got.append(pcm)
    finally:
        dec.close()
    assert np.array_equal(np.concatenate(got), want)
    assert rate == ref.rate


# ------------------------------------------------------------------ #
# the CLI

@pytest.fixture(scope="module")
def audio_outputs(jax_native, tmp_path_factory):
    return run_goldens(AUDIO_CASES, tmp_path_factory.mktemp("audio_goldens"))


@pytest.mark.parametrize("case", AUDIO_CASES)
def test_audio_golden_cli_matches_jax_cli_byte_for_byte(case,
                                                        audio_outputs):
    assert_golden(audio_outputs, case)


@pytest.mark.parametrize("name", ["a.mp2", "a.mp3", "a.flac", "a.aac"])
def test_an_audio_only_session_of_each_format(name, tmp_path, jax_native):
    outs = []
    for side, run in (("jax", jax_cli), ("port", port_cli)):
        out = tmp_path / f"{side}.wav"
        with in_tree_bridge():
            assert run(["-i", str(DATA / name), "-o", str(out)]) == 0
        outs.append(out.read_bytes())
    assert outs[0] == outs[1] and len(outs[0]) > 5000
