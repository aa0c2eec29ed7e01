"""The port's QuickTime/MOV import (``-x mov``), on the CPU.

The reader is a pinned copy of the JAX package's ``io/mov.py``
(``tests/test_torch_core.py`` ``RANGE_COPIES``: the atom walk,
``MovTrack``, ``MovReader``, ``decode_video_sample``'s uncompressed
branches, ``decode_audio_bytes``); its photo-JPEG branch is the port's
own (``io/jpeg.py`` on the card, the plain versions here), held to PIL's
bytes as the JAX reader's ``Image.open``.  The ``mov`` importer against
the JAX importer on every video fourcc it decodes and on classic PCM,
through both CLIs (``chip_smoke.MJPEG_GOLDEN``'s MOV cases, pinned for
the card), ``-x auto`` and ``-x mov``, the refusal of the fourccs the JAX
package hands to FFmpeg.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import chip_smoke
from tcforge_tpu.core.job import Job as JJob
from tcforge_tpu.io import mov as jmov
from tcforge_tpu.modules.registry import ModuleKind as JKind
from tcforge_tpu.modules.registry import new_module as jax_new_module
from tcforge_tpu_torch.core.job import Job
from tcforge_tpu_torch.io import mov as tmov
from tcforge_tpu_torch.modules.registry import ModuleKind, new_module
from tcforge_tpu_torch.pipeline import engine
from test_torch_mjpeg import (assert_golden, jax_cli, make_streams,
                              port_cli, run_goldens)

DATA = chip_smoke.MJPEG_DATA
CPU = torch.device("cpu")
MOV_GOLDEN = ("mov_jpeg", "mov_mjpa", "mov_seek")
# what the JAX writer writes for each uncompressed fourcc
RAW_FOURCCS = ("raw ", "yv12", "y420", "2vuy", "yuv2")


def _mov(path, fourcc: str, frames: int = 3, w: int = 32, h: int = 16,
         audio: bool = True):
    """A MOV of seeded frames in ``fourcc`` by the JAX ``MovWriter``
    (packed 4:2:2 and y420 samples written as bytes), with a ``sowt``
    track."""
    rng = np.random.default_rng(sum(map(ord, fourcc)))
    wr = jmov.MovWriter(str(path), w, h, 25.0, fourcc=fourcc,
                        audio_rate=8000 if audio else 0, audio_channels=2)
    for _ in range(frames):
        if fourcc == "raw ":
            wr.write_video_frame(rng.integers(0, 256, (h, w, 3), np.uint8))
        elif fourcc == "jpeg":
            wr.write_video_frame(make_streams.test_rgb(w, h, 7))
        elif fourcc in ("yv12", "y420"):
            wr.write_video_sample(rng.integers(0, 256, w * h * 3 // 2,
                                               np.uint8).tobytes())
        else:
            wr.write_video_sample(rng.integers(0, 256, w * h * 2,
                                               np.uint8).tobytes())
        if audio:
            wr.write_audio(rng.integers(-3000, 3000, (320, 2), np.int16))
    wr.close()
    return path


def _frames(path, jax: bool, batch: int = 2):
    if jax:
        import tcforge_tpu.modules  # noqa: F401
        imp = jax_new_module(JKind.DEMULTIPLEXOR, "mov", JJob())
    else:
        import tcforge_tpu_torch.modules  # noqa: F401
        imp = new_module(ModuleKind.DEMULTIPLEXOR, "mov", Job())
    imp.open(str(path))
    if not jax and imp.planned:
        imp.start(CPU)
    out, pcm = [], []
    while (b := imp.read_video_batch(batch)) is not None:
        out.append({k: np.asarray(v) for k, v in b.items()})
    while (a := imp.read_audio_batch(500)) is not None:
        pcm.append(np.asarray(a))
    info = (imp.width, imp.height, imp.fps, imp.format.value,
            imp.audio_rate, imp.audio_channels)
    imp.close()
    return out, pcm, info


def assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            assert np.array_equal(g[k], w[k]), k


@pytest.mark.parametrize("fourcc", [*RAW_FOURCCS, "jpeg"])
def test_importer_matches_the_jax_importer(fourcc, tmp_path):
    path = _mov(tmp_path / "in.mov", fourcc)
    got = _frames(path, False)
    want = _frames(path, True)
    assert got[2] == want[2]
    assert_same(got[0], want[0])
    assert_same([{"a": a} for a in got[1]], [{"a": a} for a in want[1]])


@pytest.mark.parametrize("name", ["jpeg.mov", "mjpa.mov"])
@pytest.mark.parametrize("batch", [1, 4])
def test_fixture_matches_the_jax_importer(name, batch):
    got = _frames(DATA / name, False, batch)
    want = _frames(DATA / name, True, batch)
    assert got[2] == want[2]
    assert_same(got[0], want[0])


@pytest.mark.parametrize("name", ["jpeg.mov", "mjpa.mov"])
def test_reader_parses_as_the_jax_reader(name):
    with tmov.MovReader(str(DATA / name)) as ours, \
            jmov.MovReader(str(DATA / name)) as ref:
        assert len(ours.tracks) == len(ref.tracks)
        for a, b in zip(ours.tracks, ref.tracks):
            assert (a.kind, a.fourcc, a.width, a.height, a.n_samples,
                    a.fps) == (b.kind, b.fourcc, b.width, b.height,
                               b.n_samples, b.fps)
            assert a.sample_locations() == b.sample_locations()


@pytest.mark.parametrize("fourcc,bits", [("twos", 16), ("sowt", 16),
                                         ("raw ", 8), ("lpcm", 16),
                                         ("twos", 8), ("sowt", 8)])
def test_pcm_fourccs_decode_as_the_jax_reader(fourcc, bits):
    data = np.random.default_rng(5).integers(0, 256, 1000,
                                             np.uint8).tobytes()
    assert np.array_equal(tmov.decode_audio_bytes(fourcc, data, 2, bits),
                          jmov.decode_audio_bytes(fourcc, data, 2, bits))


def test_a_compressed_fourcc_is_refused_by_name(tmp_path):
    """avc1 (and the other fourccs the JAX package hands to FFmpeg)."""
    data = (DATA / "jpeg.mov").read_bytes()
    at = data.index(b"jpeg", data.index(b"stsd"))
    path = tmp_path / "avc1.mov"
    path.write_bytes(data[:at] + b"avc1" + data[at + 4:])
    imp = new_module(ModuleKind.DEMULTIPLEXOR, "mov", Job())
    with pytest.raises(NotImplementedError, match="fourcc 'avc1'") as e:
        imp.open(str(path))
    assert "not ported to the torch port yet" in str(e.value)
    assert port_cli(["-i", str(path), "-o", str(tmp_path / "o.y4m")]) == 1


@pytest.mark.parametrize("x", ["auto", "mov"])
def test_x_auto_and_x_mov_take_the_mov_module(x):
    job = Job(video_in_file=str(DATA / "jpeg.mov"),
              im_v_module="" if x == "auto" else x)
    assert engine.video_module(job) == "mov"


@pytest.mark.parametrize("fourcc", ["yv12", "2vuy", "raw "])
def test_raw_fourccs_through_both_clis(fourcc, tmp_path):
    """Host planes through the engine: -L decodes and drops (no index
    seek), the PCM track to a WAV; a 2vuy file's probe makes the job's
    colorspace UYVY, which hqdn3d refuses in both CLIs."""
    path = _mov(tmp_path / "in.mov", fourcc, frames=5)
    outs = {}
    for key, run in (("jax", jax_cli), ("port", port_cli)):
        d = tmp_path / key
        d.mkdir()
        rc = run(["-i", str(path), "-L", "1", "-J", "hqdn3d", "-o",
                  str(d / "o.y4m"), "-m", str(d / "o.wav")])
        outs[key] = (rc, [(d / f).read_bytes() for f in ("o.y4m", "o.wav")]
                     if rc == 0 else None)
    assert outs["port"] == outs["jax"]
    assert (outs["port"][0] == 0) == (fourcc != "2vuy")


def test_an_importer_given_no_device_decodes_on_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    imp = new_module(ModuleKind.DEMULTIPLEXOR, "mov", Job())
    imp.open(str(DATA / "jpeg.mov"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        imp.read_video_batch(3)


@pytest.fixture(scope="module")
def mov_goldens(tmp_path_factory):
    return run_goldens(MOV_GOLDEN, tmp_path_factory.mktemp("mov"))


@pytest.mark.parametrize("case", MOV_GOLDEN)
def test_mov_golden_cli_matches_jax_cli_byte_for_byte(case, mov_goldens):
    assert_golden(mov_goldens, case)
