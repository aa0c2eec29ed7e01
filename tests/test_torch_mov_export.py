"""The port's QuickTime export (the ``mov`` multiplexor over the pinned
``io/mov.MovWriter``), on the CPU, against the JAX package.

- ``MovWriter`` against the JAX writer: the same samples and PCM give
  the same file, for the ``jpeg``, ``raw `` and ``yv12`` fourccs, with
  and without a ``sowt`` track and with chunks of several sizes;
- ``chip_smoke.MJPEGENC_GOLDEN``'s MOV cases through both CLIs (photo-JPEG
  at quality 50 with its PCM track, raw I420 reordered to YV12, RGB24 as
  ``raw ``), each digest pinned for ``chip_smoke.py``, and read back
  through the port's ``mov`` importer as the JAX CLI reads the JAX file;
- ``-o x.mov`` finds the multiplexor, as in the JAX CLI.
"""

from __future__ import annotations

import numpy as np
import pytest

import chip_smoke
from tcforge_tpu.io import mov as jmov
from tcforge_tpu_torch.io import mov
from tcforge_tpu_torch.modules import registry
from test_torch_audio_encode import run_goldens
from test_torch_mpeg_import import jax_cli, jax_native, port_cli  # noqa: F401

GOLDEN_HERE = ("mov_q50", "mov_raw", "mov_rgb")


@pytest.mark.parametrize("fourcc,audio", [
    ("jpeg", 0), ("jpeg", 2), ("raw ", 1), ("raw ", 2), ("yv12", 0),
    ("yv12", 2)])
def test_the_writer_matches_the_jax_writer(fourcc, audio, tmp_path):
    rng = np.random.default_rng(len(fourcc) + audio)
    samples = [rng.integers(0, 256, int(n), dtype=np.uint8).tobytes()
               for n in rng.integers(100, 4000, 7)]
    pcm = [rng.integers(-3000, 3000, (int(n), max(1, audio)),
                        dtype=np.int16) for n in (1601, 1602, 1602, 800)]
    files = []
    for side, module in (("jax", jmov), ("port", mov)):
        path = tmp_path / f"{side}.mov"
        w = module.MovWriter(str(path), 64, 48, 29.97, fourcc=fourcc,
                             audio_rate=48000 if audio else 0,
                             audio_channels=max(1, audio))
        for i, sample in enumerate(samples):
            w.write_video_sample(sample)
            if audio and i < len(pcm):
                w.write_audio(pcm[i])
        w.close()
        files.append(path.read_bytes())
    assert files[0] == files[1]
    with mov.MovReader(str(tmp_path / "port.mov")) as r:
        assert r.video.fourcc == fourcc
        assert [r.read_sample(loc) for loc in r.video.sample_locations()] \
            == samples
        assert (r.audio is not None) == bool(audio)


def test_a_mov_output_finds_the_mov_multiplexor():
    assert registry.find_mux_module_for_path("out.mov") == "mov"
    assert registry.find_mux_module_for_path("out.qt") == "mov"


@pytest.fixture(scope="module")
def goldens(tmp_path_factory, jax_native):
    return run_goldens(GOLDEN_HERE, tmp_path_factory.mktemp("mov_export"))


@pytest.mark.parametrize("case", GOLDEN_HERE)
def test_mov_export_golden_matches_the_jax_cli(case, goldens):
    jax_bytes, port_bytes, argv = goldens[case]
    assert jax_bytes and port_bytes == jax_bytes
    assert chip_smoke.sha256_file(argv[argv.index("-o") + 1]) == \
        chip_smoke.MJPEGENC_GOLDEN_SHA256[case]


@pytest.mark.parametrize("case,fourcc", [("mov_q50", "jpeg"),
                                         ("mov_raw", "yv12"),
                                         ("mov_rgb", "raw ")])
def test_mov_export_reads_back_as_the_jax_cli_reads_it(case, fourcc,
                                                       goldens, tmp_path):
    argv = goldens[case][2]
    src = argv[argv.index("-o") + 1]
    with mov.MovReader(src) as r:
        assert r.video.fourcc == fourcc
        assert (r.video.width, r.video.height) == (96, 64)
    files = {}
    for side, run, path in (("jax", jax_cli, src.replace("port_", "jax_")),
                            ("port", port_cli, src)):
        back, wav = tmp_path / f"{side}.y4m", tmp_path / f"{side}.wav"
        assert run(["-i", path, "-o", str(back), "-m", str(wav)]) == 0
        files[side] = (back.read_bytes(), wav.read_bytes())
    assert files["port"] == files["jax"]
    assert files["port"][0].count(b"FRAME\n") == \
        chip_smoke.MJPEGENC_GOLDEN_FRAMES
