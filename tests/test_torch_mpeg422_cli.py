"""The port's 4:2:2 export and import through its CLI, ``-R`` and ``-N``,
against the JAX package, on the CPU.

- ``Mpeg2FullEncoder(chroma=422)``'s bytes against the JAX class's: I/P/B
  frame and field pictures, gop_m 1, 2 and 3, rate control on and off,
  alternate scan, pulldown, search ranges 1 and 16, the quantiser's
  bounds, flushes with B pictures waiting, one and two frames, and noise
  that P pictures code intra; ``-R``'s pass 1 log and pass 2 bytes.
- The ``chip_smoke.MPEG422_GOLDEN`` cases through both CLIs (the JAX one
  with ``--mesh off``), in order: the 4:2:2 encode of 4:2:2 interlaced
  content (``-V yuv422p -I 5 -Z -J denoise3d``, GOP 6/3 with rate
  control), its field-picture form, ``-R 1`` and ``-N mpeg2video -R 2``,
  and the streams read back kept at 4:2:2 (frame and field pictures) and
  decimated to 4:2:0 (``-J hqdn3d``); the same bytes, the same pass log,
  and the port's digests pinned for ``chip_smoke.py`` to check on the
  card.
- ``-N``: the encoders by format name as the JAX CLI chooses them from
  the JAX registry's table; a format whose encoder the port lacks is
  refused naming the JAX module; ``-y`` given wins.  ``-R`` parses as in
  the JAX CLI.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from tcforge_tpu.cli import args_to_job as jax_args_to_job
from tcforge_tpu.cli import build_parser as jax_build_parser
from tcforge_tpu.io.mpeg2enc import Mpeg2FullEncoder as JEncoder
from tcforge_tpu.modules import registry as jregistry
from tcforge_tpu_torch import cli
from tcforge_tpu_torch.io import mpeg2enc
from tcforge_tpu_torch.io.mpeg2enc import Mpeg2FullEncoder
from test_torch_engine import run_cli
from test_torch_mpeg_import import jax_cli, jax_native  # noqa: F401


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def port_cli(argv):
    return run_cli([*argv, "--device", "cpu", "-q", "--progress_off"])


def output_of(argv) -> Path:
    return Path(argv[argv.index("-o") + 1])


# ------------------------------------------------------------------ #
# the encoder class


def frames422(n: int, h: int, w: int, seed: int, noise: bool = False):
    """Display-order 4:2:2 frames: moving waves with grain, or (``noise``)
    uniform noise every other frame, which P pictures code intra."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    out = []
    for i in range(n):
        if noise and i % 2:
            out.append(tuple(rng.integers(0, 256, (h, pw), dtype=np.uint8)
                             for pw in (w, w // 2, w // 2)))
            continue
        y = (128 + 60 * np.sin((xx + 3 * i) / 7.0)
             + 50 * np.cos((yy + 2 * i) / 5.0) + rng.normal(0, 6, (h, w)))
        u = 128 + 30 * np.sin((xx[:, ::2] + i) / 9.0) + rng.normal(
            0, 3, (h, w // 2))
        v = 128 + 30 * np.cos((yy[:, ::2] + 2 * i) / 6.0) + rng.normal(
            0, 3, (h, w // 2))
        out.append(tuple(np.clip(p, 0, 255).astype(np.uint8)
                         for p in (y, u, v)))
    return out


# case -> (frames, noise, settings); 4:2:2 throughout
ENCODER_CASES = {
    "gop12_3_rc": (11, False, dict(w=96, h=64, fps=25.0, gop_n=12, gop_m=3,
                                   rate_control=True, bitrate_kbps=1500)),
    "gop6_3_cq": (9, False, dict(w=96, h=64, gop_n=6, gop_m=3, qscale=5)),
    "gop4_1_cq": (7, False, dict(w=64, h=48, gop_n=4, gop_m=1, qscale=3)),
    "gop6_2_rc": (8, False, dict(w=96, h=64, gop_n=6, gop_m=2,
                                 rate_control=True, bitrate_kbps=900,
                                 qmin=2)),
    "fields_tff": (7, False, dict(w=64, h=64, fps=29.97, gop_n=6, gop_m=3,
                                  fields=True, qscale=6)),
    "fields_bff_rc": (7, False, dict(w=64, h=64, gop_n=6, gop_m=3,
                                     fields=True, top_field_first=False,
                                     rate_control=True, bitrate_kbps=800)),
    "fields_m1": (5, False, dict(w=96, h=64, gop_n=4, gop_m=1, fields=True,
                                 qscale=4)),
    "alt_scan": (7, False, dict(w=64, h=48, gop_n=6, gop_m=3, alt_scan=True,
                                qscale=3)),
    "alt_fields": (5, False, dict(w=64, h=64, gop_n=6, gop_m=3, fields=True,
                                  alt_scan=True, qscale=5)),
    "pulldown": (9, False, dict(w=64, h=48, fps=23.976, gop_n=6, gop_m=3,
                                pulldown=True, qscale=4)),
    "range1": (6, False, dict(w=64, h=48, gop_n=6, gop_m=3, search_range=1,
                              qscale=2)),
    "range16": (6, False, dict(w=96, h=64, gop_n=6, gop_m=3,
                               search_range=16, qscale=9)),
    "q_bounds": (8, False, dict(w=64, h=48, gop_n=8, gop_m=2,
                                rate_control=True, bitrate_kbps=100, qmin=4,
                                qmax=12)),
    "noise_intra": (7, True, dict(w=64, h=48, gop_n=6, gop_m=3, qscale=6)),
    "flush_bs_waiting": (5, False, dict(w=64, h=48, gop_n=15, gop_m=3,
                                        qscale=5)),
    "one_frame": (1, False, dict(w=64, h=48, gop_n=15, gop_m=3, qscale=5)),
    "two_frames": (2, False, dict(w=64, h=48, gop_n=15, gop_m=3,
                                  qscale=5)),
}


@pytest.mark.parametrize("case", sorted(ENCODER_CASES))
def test_full_encoder_422_matches_the_jax_class(case, jax_native):
    n, noise, kw = ENCODER_CASES[case]
    kw = dict(kw)
    w, h = kw.pop("w"), kw.pop("h")
    fr = frames422(n, h, w, seed=len(case), noise=noise)
    jax_enc = JEncoder(w, h, chroma=422, **kw)
    port_enc = Mpeg2FullEncoder(w, h, chroma=422, **kw)
    want = [jax_enc.push_frame(*f) for f in fr]
    got = [port_enc.push_frame(*map(t, f)) for f in fr]
    assert got == want
    assert port_enc.flush() == jax_enc.flush()


@pytest.mark.parametrize("fields", [False, True])
def test_two_passes_match_the_jax_class(fields, tmp_path, jax_native):
    """-R 1 writes the same log (each picture's type and bits), -R 2
    reads it into the same rate control and the same bytes."""
    fr = frames422(9, 64, 96, seed=3)
    kw = dict(gop_n=6, gop_m=3, bitrate_kbps=1200, fields=fields)
    streams = {}
    for side, cls in (("jax", JEncoder), ("port", Mpeg2FullEncoder)):
        log = str(tmp_path / f"{side}.log")
        for mode in (1, 2):
            enc = cls(96, 64, chroma=422, pass_mode=mode, pass_log=log, **kw)
            conv = t if side == "port" else np.asarray
            out = b"".join(enc.push_frame(*map(conv, f)) for f in fr)
            streams[side, mode] = out + enc.flush()
    assert (tmp_path / "jax.log").read_text() == \
        (tmp_path / "port.log").read_text()
    assert len((tmp_path / "port.log").read_text().splitlines()) == \
        (18 if fields else 9)
    for mode in (1, 2):
        assert streams["port", mode] == streams["jax", mode]
    assert streams["port", 2] != streams["port", 1]


# ------------------------------------------------------------------ #
# the CLI goldens


@pytest.fixture(scope="module")
def goldens(tmp_path_factory, jax_native):
    """Every MPEG422_GOLDEN case through the JAX CLI and the port's, in
    order: case -> (jax bytes, port bytes); the directory."""
    tmp = tmp_path_factory.mktemp("m422cli")
    out = {}
    for case in chip_smoke.MPEG422_GOLDEN:
        got = {}
        for side, run in (("jax", jax_cli), ("port", port_cli)):
            argv = chip_smoke.mpeg422_golden_argv(case, tmp, side)
            assert run(argv) == 0, (case, side)
            got[side] = output_of(argv).read_bytes()
        out[case] = (got["jax"], got["port"])
    return out, tmp


@pytest.mark.parametrize("case", list(chip_smoke.MPEG422_GOLDEN))
def test_mpeg422_golden_matches_the_jax_cli_byte_for_byte(case, goldens):
    jax_bytes, port_bytes = goldens[0][case]
    assert jax_bytes and port_bytes == jax_bytes
    out = output_of(chip_smoke.mpeg422_golden_argv(case, goldens[1], "port"))
    assert chip_smoke.sha256_file(out) == \
        chip_smoke.MPEG422_GOLDEN_SHA256[case]


def test_the_pass_log_matches_the_jax_cli(goldens):
    tmp = goldens[1]
    port = (tmp / "mpeg422_port.log").read_text()
    assert port == (tmp / "mpeg422_jax.log").read_text()
    types = [int(line.split()[0]) for line in port.splitlines()]
    assert types[:3] == [1, 2, 3] and len(types) == \
        chip_smoke.MPEG422_GOLDEN_FRAMES


def test_pass_two_codes_with_the_log(goldens):
    """Pass 2 rate-controls from pass 1's bits: other bytes than pass 1,
    whose stream is the single-pass one."""
    g = goldens[0]
    assert g["pass1"][1] == g["enc"][1]
    assert g["pass2"][1] != g["pass1"][1]


@pytest.mark.parametrize("case,csp", [("keep", b"C422"),
                                      ("keep_fields", b"C422"),
                                      ("decimate", b"C420")])
def test_the_read_back_is_every_frame_in_its_format(case, csp, goldens):
    data = goldens[0][case][1]
    header = data.split(b"\n", 1)[0]
    assert b" W96 H64 " in header and csp in header
    assert data.count(b"FRAME\n") == chip_smoke.MPEG422_GOLDEN_FRAMES


def test_the_422_read_back_is_batch_independent(goldens, tmp_path):
    """The kept read-back of the field stream at batches of 1 and 5 (a
    batch boundary inside each B run) gives the default's bytes."""
    want = goldens[0]["keep_fields"][1]
    src = goldens[1] / "mpeg422_enc_fields_port.m2v"
    for batch in (1, 5):
        out = tmp_path / f"b{batch}.y4m"
        assert port_cli(["-i", str(src), "-o", str(out),
                         *chip_smoke.MPEG422_KEEP, "--batch",
                         str(batch)]) == 0
        assert out.read_bytes() == want


# ------------------------------------------------------------------ #
# -N and -R


def port_job(argv):
    return cli.args_to_job(cli._parse(["-i", "in.y4m", "-o", "out.m2v",
                                       *argv]))


def jax_choice(names: str):
    """The JAX CLI's -N choice (tcforge_tpu/cli.py:625-641) from its own
    registry: (video encoder, audio encoder or None)."""
    parts = names.split(",")
    v = jregistry.module_name_for_format("encoder", parts[0])
    a = None
    if len(parts) > 1 and parts[1]:
        a = jregistry.module_name_for_format("encoder", parts[1]) or "raw"
    return v, a


@pytest.mark.parametrize("names", [
    "mpeg2video", "mpeg2video,mp2", "mjpeg", "mpeg4video", "mpeg1video",
    "mpeg2", "mpeg2video,mp3", "mpeg2video,ac3", "mpeg2video,pcm",
    "yuv420p", "mpeg2video,vorbis", "mpeg2video,aac", "dvvideo",
    "rtjpeg", "theora", "mpeg2video,theora"])
def test_minus_n_selects_encoders_as_the_jax_cli(names):
    v, a = jax_choice(names)
    job = port_job(["-N", names])
    assert job.ex_codec_names == names
    assert job.ex_v_module == v
    assert job.ex_a_module == (a or "raw")


@pytest.mark.parametrize("names,module", [
    ("h264", "x264"), ("mpeg2video,h264", "x264")])
def test_minus_n_refuses_what_the_port_lacks_by_name(names, module):
    for name in names.split(","):
        if name != "mpeg2video":
            assert jregistry._FORMAT_MAP[("encoder", name)][0] == module
    with pytest.raises(NotImplementedError, match=f"the {module} encoder"):
        port_job(["-N", names])


def test_minus_n_h264_is_refused_through_the_cli(tmp_path, capsys):
    src = tmp_path / "in.y4m"
    chip_smoke.write_motion_y4m(src, 64, 48, 3, seed=1)
    assert port_cli(["-i", str(src), "-o", str(tmp_path / "o.m2v"), "-N",
                     "h264"]) != 0
    assert "x264" in capsys.readouterr().err


def test_minus_n_of_an_unknown_format_fails_as_in_jax():
    assert jax_choice("nosuch")[0] is None
    with pytest.raises(ValueError, match="no encoder for format"):
        port_job(["-N", "nosuch"])


def test_minus_y_wins_over_minus_n():
    job = port_job(["-N", "h264", "-y", "mpeg2,raw,raw"])
    assert (job.ex_v_module, job.ex_a_module) == ("mpeg2", "raw")


@pytest.mark.parametrize("arg", ["1", "2,pass.log", "1,", "0", "2"])
def test_minus_r_parses_as_the_jax_cli(arg):
    argv = ["-i", "in.y4m", "-o", "out.m2v", "-R", arg]
    want = jax_args_to_job(jax_build_parser().parse_args(argv))
    job = port_job(["-R", arg])
    assert (job.divxmultipass, job.divxlogfile) == \
        (want.divxmultipass, want.divxlogfile)


def test_the_encoder_module_reads_minus_r(tmp_path, jax_native):
    """-R 1 through the port's CLI writes the JAX CLI's log beside the
    JAX CLI's stream (the log's default name in the working directory
    is divx4.log)."""
    src = tmp_path / "in.y4m"
    chip_smoke.write_motion_y4m(src, 64, 64, 5, seed=4, chroma=422)
    logs = {}
    for side, run in (("jax", jax_cli), ("port", port_cli)):
        log = tmp_path / f"{side}.log"
        assert run(["-i", str(src), "-o", str(tmp_path / f"{side}.m2v"),
                    "-V", "yuv422p", "-y", "mpeg2", "-F",
                    "gop_n=4:gop_m=2", "-R", f"1,{log}"]) == 0
        logs[side] = log.read_text()
    assert logs["port"] == logs["jax"] and logs["port"]
    assert (tmp_path / "port.m2v").read_bytes() == \
        (tmp_path / "jax.m2v").read_bytes()


def test_4_2_2_with_mpeg1_is_refused_as_in_jax(tmp_path, capsys):
    src = tmp_path / "in.y4m"
    chip_smoke.write_motion_y4m(src, 64, 48, 3, seed=1, chroma=422)
    assert port_cli(["-i", str(src), "-o", str(tmp_path / "o.m1v"), "-V",
                     "yuv422p", "-y", "mpeg2", "-F", "mpeg1=1"]) != 0
    assert "4:2:2" in capsys.readouterr().err
    with pytest.raises(ValueError, match="4:2:2"):
        mpeg2enc.Mpeg2FullEncoder(64, 48, chroma=422, mpeg1=True)
