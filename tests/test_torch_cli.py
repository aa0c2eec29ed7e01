"""The port's CLI and engine against the JAX CLI, byte for byte.

The small case of ``chip_smoke.py`` (a seeded 128x72 Y4M of 7 frames,
``--batch 3`` so the last batch is short, ``-I 5 -Z 64x48 -J
hqdn3d=luma=4.0``) goes through both CLIs on the CPU; the output files
must be identical, and their SHA-256 is the constant that
``chip_smoke.py`` checks again on the card.
"""

from __future__ import annotations

import pytest
import torch

import chip_smoke
from tcforge_tpu.cli import main as jax_cli_main
from tcforge_tpu_torch import cli
from tcforge_tpu_torch.core.job import Job
from tcforge_tpu_torch.io.y4m import Y4MReader
from tcforge_tpu_torch.pipeline.engine import Pipeline


@pytest.fixture(scope="module")
def golden_input(tmp_path_factory):
    path = tmp_path_factory.mktemp("golden") / "in.y4m"
    chip_smoke.write_test_y4m(path, chip_smoke.GOLDEN_W, chip_smoke.GOLDEN_H,
                              chip_smoke.GOLDEN_FRAMES,
                              chip_smoke.GOLDEN_SEED)
    return path


def test_port_cli_matches_jax_cli_byte_for_byte(golden_input, tmp_path):
    ref, out = tmp_path / "jax.y4m", tmp_path / "port.y4m"
    assert jax_cli_main(["-i", str(golden_input), "-o", str(ref),
                         *chip_smoke.GOLDEN_ARGS, "--progress_off",
                         "-q"]) == 0
    assert cli.main(["-i", str(golden_input), "-o", str(out),
                     *chip_smoke.GOLDEN_ARGS, "--device", "cpu",
                     "--progress_off", "-q"]) == 0
    assert out.read_bytes() == ref.read_bytes()
    assert chip_smoke.sha256_file(out) == chip_smoke.GOLDEN_SHA256
    with Y4MReader(str(out)) as r:
        assert (r.header.width, r.header.height) == (64, 48)
        assert sum(1 for _ in r) == chip_smoke.GOLDEN_FRAMES


def test_engine_counters_and_max_frames(golden_input, tmp_path):
    job = Job(video_in_file=str(golden_input),
              video_out_file=str(tmp_path / "o.y4m"), deinterlace=5,
              zoom_width=64, zoom_height=48, batch_size=3, max_frames=5)
    counters = Pipeline(job, torch.device("cpu")).run()
    assert (counters.frames, counters.batches) == (5, 2)
    assert counters.seconds > 0
    with Y4MReader(str(tmp_path / "o.y4m")) as r:
        assert r.header.fps_num == 25000 and r.header.fps_den == 1000
        assert sum(1 for _ in r) == 5


def test_cli_refuses_flags_it_lacks(golden_input, tmp_path, capsys):
    with pytest.raises(SystemExit) as exc:
        cli.main(["-i", str(golden_input), "-o", str(tmp_path / "o.y4m"),
                  "-g", "128x72", "--device", "cpu"])
    assert exc.value.code == 2
    assert "not supported by the torch port yet: -g 128x72" in \
        capsys.readouterr().err


def test_cli_cuda_without_a_card_raises(golden_input, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["-i", str(golden_input), "-o", str(tmp_path / "o.y4m"),
                  "-q"])
    assert not (tmp_path / "o.y4m").exists()


def test_chip_smoke_fails_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    assert chip_smoke.main() != 0
    out = capsys.readouterr().out
    assert '"ok"' not in out
