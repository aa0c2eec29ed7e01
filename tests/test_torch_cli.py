"""The port's CLI and engine against the JAX CLI, byte for byte.

The small cases of ``chip_smoke.py`` (a seeded 128x72 Y4M of 7 frames,
``--batch 3`` so the last batch is short; ``-I 5 -Z 64x48 -J
hqdn3d=luma=4.0`` and the slice's paths cfg2, cfg4 and denoise3d) go
through both CLIs on the CPU; the output files must be identical, and
their SHA-256 values are the constants that ``chip_smoke.py`` checks
again on the card.  The engine drops the frames a filter marks SKIPPED
or BROKEN, as the JAX engine does, and calls each filter's ``finalize``
once, after the last ``collect``, also when the reader raises.  Then
cfg3 on a telecined 64x48 stream of 20 frames (bytes, frame count and
the skipped counter equal to the JAX engine's), the field-rate paths'
small cases on an interlaced clip with motion, the small ``-V rgb24``
case, the ``FLAG_CASES`` (the internal transforms, ``-I 2``, the
engine's flags and the filters of plain torch ops), and the internal
transforms' flags through both parsers.  The DVD path: MPEG-2 import
of a 720x480 program stream into hqdn3d, frame pictures and field
pictures, port CLI against JAX CLI (``chip_smoke.MPEG_GOLDEN``; the
other MPEG goldens are in ``test_torch_mpeg_import.py``).  The audio
track: the A/V and
audio-only golden cases (``chip_smoke.AUDIO_GOLDEN_ARGS``), an audio
filter in ``-J`` without ``-p``, the synchronizer's cases against the
JAX CLI without its device mesh (its batches then match the port's),
the audio-only session's flags, the refusals, and the audio flags
through both parsers.  Every run of the port's engine goes through
``test_torch_engine.run_cli`` or ``run_engine``: in a thread joined
with a timeout.
"""

from __future__ import annotations

import hashlib
from pathlib import Path
from typing import Any, Tuple

import pytest
import torch

import chip_smoke
from tcforge_tpu.cli import build_parser as jax_build_parser
from tcforge_tpu.cli import args_to_job as jax_args_to_job
from tcforge_tpu.cli import main as jax_cli_main
from tcforge_tpu.core.job import Job as JJob
from tcforge_tpu.ops import video as jax_video
from tcforge_tpu.pipeline.engine import Pipeline as JPipeline
from tcforge_tpu_torch import cli
from tcforge_tpu_torch.core.frame import (ATTR_BROKEN, ATTR_SKIPPED,
                                          FrameBatch)
from tcforge_tpu_torch.core.job import FilterSpec, Job
from tcforge_tpu_torch.io.y4m import Y4MReader
from tcforge_tpu_torch.modules import registry
from tcforge_tpu_torch.modules.registry import (ModuleInfo, ModuleKind,
                                                VideoFilter)
from tcforge_tpu_torch.pipeline.engine import Pipeline
from test_torch_denoise import yuvdenoise_pieces_jitted
from test_torch_engine import run_cli, run_engine
from test_torch_mpeg_import import jax_native  # noqa: F401  (a fixture)


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
    assert run_cli(["-i", str(golden_input), "-o", str(out),
                     *chip_smoke.GOLDEN_ARGS, "--device", "cpu",
                     "--progress_off", "-q"]) == 0
    assert out.read_bytes() == ref.read_bytes()
    assert chip_smoke.sha256_file(out) == chip_smoke.GOLDEN_SHA256
    with Y4MReader(str(out)) as r:
        assert (r.header.width, r.header.height) == (64, 48)
        assert sum(1 for _ in r) == chip_smoke.GOLDEN_FRAMES


@pytest.mark.parametrize("path", sorted(chip_smoke.PATHS))
def test_path_cli_matches_jax_cli_byte_for_byte(path, golden_input,
                                                tmp_path):
    args = [*chip_smoke.PATHS[path]["args"], "--batch", "3",
            "--progress_off", "-q"]
    ref, out = tmp_path / "jax.y4m", tmp_path / "port.y4m"
    assert jax_cli_main(["-i", str(golden_input), "-o", str(ref),
                         *args]) == 0
    assert run_cli(["-i", str(golden_input), "-o", str(out), *args,
                     "--device", "cpu"]) == 0
    assert out.read_bytes() == ref.read_bytes()
    assert chip_smoke.sha256_file(out) == chip_smoke.PATH_GOLDEN_SHA256[path]
    skipped = chip_smoke.PATH_FRAMES - chip_smoke.PATHS[path]["frames_out"]
    with Y4MReader(str(out)) as r:
        assert (r.header.width, r.header.height) == (chip_smoke.GOLDEN_W,
                                                     chip_smoke.GOLDEN_H)
        assert sum(1 for _ in r) == chip_smoke.GOLDEN_FRAMES - skipped


class _MarkFrames(VideoFilter):
    """Marks frame ids listed in its options SKIPPED (``s<id>``) or
    BROKEN (``b<id>``)."""

    info = ModuleInfo(name="test_mark_frames", kind=ModuleKind.FILTER)
    desc = None

    def __init__(self, job, options: str = ""):
        self.job = job
        self.marks = {int(o[1:]): (ATTR_SKIPPED if o[0] == "s"
                                   else ATTR_BROKEN)
                      for o in options.split("/") if o}

    def apply(self, fb: FrameBatch, state: Any) -> Tuple[FrameBatch, Any]:
        attrs = fb.attrs.clone()
        for i, fid in enumerate(fb.frame_ids.tolist()):
            attrs[i] |= self.marks.get(fid, 0)
        y = fb.y.clone()
        y[:, 0, 0] = fb.frame_ids.to(torch.uint8)    # tag each frame
        return fb.with_planes(y=y).with_attrs(attrs), state


@pytest.fixture
def mark_filter(monkeypatch):
    monkeypatch.setitem(registry._REGISTRIES[ModuleKind.FILTER],
                        _MarkFrames.info.name, _MarkFrames)


@pytest.mark.parametrize("marks,kept,skipped,dropped", [
    ("s0/s1", [2, 3, 4, 5, 6], 2, 0),
    ("b3/s5", [0, 1, 2, 4, 6], 1, 1),
    ("s0/s1/s2", [3, 4, 5, 6], 3, 0),           # a whole batch goes
    ("", list(range(7)), 0, 0)])
def test_engine_drops_skipped_and_broken_frames(golden_input, tmp_path,
                                                mark_filter, marks, kept,
                                                skipped, dropped):
    out = tmp_path / "o.y4m"
    job = Job(video_in_file=str(golden_input), video_out_file=str(out),
              batch_size=3,
              filters=[FilterSpec("test_mark_frames", marks)])
    counters = run_engine(Pipeline(job, torch.device("cpu")))
    assert (counters.frames, counters.written) == (7, len(kept))
    assert (counters.skipped, counters.dropped) == (skipped, dropped)
    with Y4MReader(str(out)) as r:
        assert [int(y[0, 0]) for y, _, _ in r] == kept


@pytest.fixture
def recorders(monkeypatch):
    """Registers ``test_record_calls``, a filter that records the engine's
    calls of ``collect`` and ``finalize`` with the frames seen so far;
    returns the list of its instances."""
    made = []

    class _RecordCalls(VideoFilter):
        info = ModuleInfo(name="test_record_calls", kind=ModuleKind.FILTER)
        desc = None

        def __init__(self, job, options: str = ""):
            self.job = job
            self.calls = []
            made.append(self)

        def init_state(self, width, height, fmt, device):
            return 0

        def apply(self, fb, state):
            return fb, state + fb.batch

        def collect(self, state):
            self.calls.append(("collect", state))

        def finalize(self, state):
            self.calls.append(("finalize", state))

    monkeypatch.setitem(registry._REGISTRIES[ModuleKind.FILTER],
                        "test_record_calls", _RecordCalls)
    return made


def test_finalize_runs_once_per_filter_after_the_last_collect(
        golden_input, tmp_path, recorders):
    assert run_cli(["-i", str(golden_input), "-o", str(tmp_path / "o.y4m"),
                    "-J", "test_record_calls,test_record_calls", "--batch",
                    "3", "--device", "cpu", "-q"]) == 0
    assert len(recorders) == 2
    for r in recorders:
        assert r.calls == [("collect", 3), ("collect", 6), ("collect", 7),
                           ("finalize", 7)]


def test_finalize_runs_when_the_reader_raises(golden_input, tmp_path,
                                              recorders):
    """A file cut in its sixth frame: two batches of 2 go through, the
    reader raises on the third, the CLI exits 1, and each filter is
    finalized once with the state the last batch left."""
    data = golden_input.read_bytes()
    frame = 6 + GOLDEN_FRAME_BYTES
    header = len(data) - chip_smoke.GOLDEN_FRAMES * frame
    src = tmp_path / "cut.y4m"
    src.write_bytes(data[:header + 5 * frame + 100])
    assert run_cli(["-i", str(src), "-o", str(tmp_path / "o.y4m"), "-J",
                    "test_record_calls,test_record_calls", "--batch", "2",
                    "--prefetch", "1", "--device", "cpu", "-q"]) == 1
    for r in recorders:
        assert r.calls == [("collect", 2), ("collect", 4), ("finalize", 4)]


GOLDEN_FRAME_BYTES = chip_smoke.GOLDEN_W * chip_smoke.GOLDEN_H * 3 // 2


@pytest.mark.parametrize("path", sorted(chip_smoke.FIELD_PATHS))
def test_field_path_cli_matches_jax_cli_byte_for_byte(path, tmp_path):
    """The field-rate paths' small golden cases on write_motion_y4m's
    clip: both CLIs, the same bytes, the digest chip_smoke.py checks on
    the card, and the frames out (doublefps doubles them; modfps trails
    its buffer of 7 and drops one in six at 29.97 -> 25)."""
    spec = chip_smoke.FIELD_PATHS[path]
    g = spec["golden"]
    frames = g.get("frames", chip_smoke.GOLDEN_FRAMES)
    src = tmp_path / "in.y4m"
    chip_smoke.write_input({**spec, **g}, src, frames,
                           chip_smoke.GOLDEN_SEED)
    args = [*g["args"], "--batch", "3", "--progress_off", "-q"]
    ref, out = tmp_path / "jax.y4m", tmp_path / "port.y4m"
    assert jax_cli_main(["-i", str(src), "-o", str(ref), *args]) == 0
    assert run_cli(["-i", str(src), "-o", str(out), *args,
                    "--device", "cpu"]) == 0
    assert out.read_bytes() == ref.read_bytes()
    assert chip_smoke.sha256_file(out) == chip_smoke.FIELD_GOLDEN_SHA256[path]
    with Y4MReader(str(out)) as r:
        n = sum(1 for _ in r)
    assert n == {"smartdeint": frames, "bob": 2 * frames, "modfps": 11}[path]


def jax_cli(argv):
    """The JAX CLI on ``argv``.  A job with yuvdenoise runs with jit
    disabled but for yuvdenoise's pieces, each jitted on its own:
    jitting the whole step takes minutes on a CPU.  Its other filters
    (pp's deblock, dering and autolevels at their defaults) give the
    same bytes jitted and not (tests/test_torch_denoise.py)."""
    if any("yuvdenoise" in a for a in argv):
        with yuvdenoise_pieces_jitted():
            return jax_cli_main(argv)
    return jax_cli_main(argv)


@pytest.mark.parametrize("path", sorted(chip_smoke.CLEAN_PATHS))
def test_clean_path_cli_matches_jax_cli_byte_for_byte(path, tmp_path):
    """The clean-up paths' small golden cases (64x48, the grain or
    impulse clip with its cut, --batch 3): both CLIs, the same bytes and
    the digest chip_smoke.py checks on the card."""
    spec = chip_smoke.CLEAN_PATHS[path]
    g = spec["golden"]
    src = tmp_path / "in.y4m"
    chip_smoke.write_input({**spec, **g}, src, chip_smoke.GOLDEN_FRAMES,
                           chip_smoke.GOLDEN_SEED)
    args = [*g["args"], "--batch", "3", "--progress_off", "-q"]
    ref, out = tmp_path / "jax.y4m", tmp_path / "port.y4m"
    assert jax_cli(["-i", str(src), "-o", str(ref), *args]) == 0
    assert run_cli(["-i", str(src), "-o", str(out), *args,
                    "--device", "cpu"]) == 0
    assert out.read_bytes() == ref.read_bytes()
    assert chip_smoke.sha256_file(out) == chip_smoke.CLEAN_GOLDEN_SHA256[path]
    with Y4MReader(str(out)) as r:
        assert sum(1 for _ in r) == chip_smoke.GOLDEN_FRAMES


@pytest.fixture(scope="module")
def clean_flag_input(tmp_path_factory):
    path = tmp_path_factory.mktemp("clean") / "in.y4m"
    chip_smoke.write_input(chip_smoke.CLEAN_FLAG_INPUT, path,
                           chip_smoke.GOLDEN_FRAMES, chip_smoke.GOLDEN_SEED)
    return path


@pytest.mark.parametrize("case", sorted(chip_smoke.CLEAN_FLAG_CASES))
def test_clean_flags_cli_matches_jax_cli_byte_for_byte(case, clean_flag_input,
                                                       tmp_path):
    """The clean-up filters' other options through both CLIs: the same
    Y4M bytes, and the same log or results file where the filter writes
    one."""
    dirs = {side: tmp_path / side for side in ("jax", "port")}
    for d in dirs.values():
        d.mkdir()
        chip_smoke.write_clean_aux(d)
    outs = {side: dirs[side] / "out.y4m" for side in dirs}
    common = ["-i", str(clean_flag_input), "--progress_off", "-q"]
    assert jax_cli([*common, "-o", str(outs["jax"]),
                    *chip_smoke.clean_flag_argv(case, dirs["jax"])]) == 0
    assert run_cli([*common, "-o", str(outs["port"]), "--device", "cpu",
                    *chip_smoke.clean_flag_argv(case, dirs["port"])]) == 0
    assert outs["port"].read_bytes() == outs["jax"].read_bytes()
    name = chip_smoke.CLEAN_FLAG_FILES.get(case)
    if name:
        text = (dirs["port"] / name).read_text()
        want = (dirs["jax"] / name).read_text()
        if case == "compare":
            # the JAX engine on a multi-device CPU mesh pads the last
            # batch with copies of its last frame, and the JAX compare
            # writes a result for those too, after the real frames'
            head, results = want.split("\n", 1)
            assert len(results) >= chip_smoke.GOLDEN_FRAMES
            want = head + "\n" + results[:chip_smoke.GOLDEN_FRAMES]
            assert len(text.split("\n", 1)[1]) == chip_smoke.GOLDEN_FRAMES
        assert text and text == want


@pytest.mark.parametrize("case,module", [
    ("detectclipping", "analysis"), ("compare", "simple"),
    ("yait_log", "yait")])
def test_logs_are_written_once_after_the_last_collect(
        case, module, clean_flag_input, tmp_path, monkeypatch):
    """detectclipping and yait open their file once, in ``finalize``,
    after the last ``collect``; compare opens its results once, at the
    first ``collect``, and closes it in ``finalize``.  Through the CLI,
    in batches of 3 (7 frames: three collects)."""
    import builtins
    import importlib
    mod = importlib.import_module(
        f"tcforge_tpu_torch.modules.filters.{module}")
    events = []
    cls = next(c for c in vars(mod).values() if isinstance(c, type)
               and getattr(c, "info", None) is not None
               and c.info.name == case.split("_")[0])
    for hook in ("collect", "finalize"):
        def spy(self, state, _orig=getattr(cls, hook), _hook=hook):
            events.append(_hook)
            return _orig(self, state)
        monkeypatch.setattr(cls, hook, spy)

    def opened(path, mode="r", *a, **k):
        if "w" in mode:
            events.append("open")
        return builtins.open(path, mode, *a, **k)
    monkeypatch.setattr(mod, "open", opened, raising=False)
    chip_smoke.write_clean_aux(tmp_path)
    assert run_cli(["-i", str(clean_flag_input), "-o",
                    str(tmp_path / "o.y4m"), "--device", "cpu", "-q",
                    *chip_smoke.clean_flag_argv(case, tmp_path)]) == 0
    first = ["collect", "open"] if case == "compare" else ["collect"]
    assert events == first + ["collect", "collect", "finalize"] + (
        [] if case == "compare" else ["open"])
    assert (tmp_path / chip_smoke.CLEAN_FLAG_FILES[case]).stat().st_size


def test_engine_counters_and_max_frames(golden_input, tmp_path):
    job = Job(video_in_file=str(golden_input),
              video_out_file=str(tmp_path / "o.y4m"), deinterlace=5,
              zoom_width=64, zoom_height=48, batch_size=3, max_frames=5)
    counters = run_engine(Pipeline(job, torch.device("cpu")))
    assert (counters.frames, counters.batches) == (5, 2)
    assert counters.seconds > 0
    with Y4MReader(str(tmp_path / "o.y4m")) as r:
        assert r.header.fps_num == 25000 and r.header.fps_den == 1000
        assert sum(1 for _ in r) == 5


@pytest.fixture(scope="module")
def telecine_input(tmp_path_factory):
    spec = chip_smoke.CFG3_GOLDEN
    path = tmp_path_factory.mktemp("cfg3") / "in.y4m"
    chip_smoke.write_telecine_y4m(path, spec["w"], spec["h"],
                                  spec["frames"], spec["seed"])
    return path


def test_cfg3_cli_matches_jax_cli_byte_for_byte(telecine_input, tmp_path):
    args = [*chip_smoke.CFG3_GOLDEN["args"], "--progress_off", "-q"]
    ref, out = tmp_path / "jax.y4m", tmp_path / "port.y4m"
    assert jax_cli_main(["-i", str(telecine_input), "-o", str(ref),
                         *args]) == 0
    assert run_cli(["-i", str(telecine_input), "-o", str(out), *args,
                     "--device", "cpu"]) == 0
    assert out.read_bytes() == ref.read_bytes()
    assert chip_smoke.sha256_file(out) == chip_smoke.CFG3_GOLDEN_SHA256
    with Y4MReader(str(out)) as r:
        assert (r.header.fps_num, r.header.fps_den) == (30000, 1001)
        assert sum(1 for _ in r) == 13


@pytest.mark.parametrize("batch", [1, 5, 7, 16])
def test_cfg3_engine_counters_match_the_jax_engine(telecine_input, tmp_path,
                                                   batch):
    """Most batches of cfg3 drop some frames: written and skipped equal
    the JAX engine's at every batch size, and the files are equal."""
    filters = "32detect,ivtc,decimate".split(",")
    ref, out = tmp_path / "jax.y4m", tmp_path / "port.y4m"
    jc = JPipeline(JJob(
        video_in_file=str(telecine_input), video_out_file=str(ref),
        ex_m_module="y4m", batch_size=batch, mesh_mode="off",
        filters=[chip_smoke_filter(f, jax=True) for f in filters])
    ).run(progress=False)
    pc = run_engine(Pipeline(Job(
        video_in_file=str(telecine_input), video_out_file=str(out),
        batch_size=batch,
        filters=[chip_smoke_filter(f, jax=False) for f in filters]),
        torch.device("cpu")))
    assert (pc.frames, pc.written, pc.skipped, pc.dropped) == \
        (jc.frames_in, jc.encoded, jc.skipped, jc.dropped)
    assert pc.written == 13 and pc.skipped == 7
    assert out.read_bytes() == ref.read_bytes()


def chip_smoke_filter(text, jax):
    from tcforge_tpu.core.job import FilterSpec as JFilterSpec
    return (JFilterSpec if jax else FilterSpec).parse(text)


def test_rgb_job_cli_matches_jax_cli_byte_for_byte(golden_input,
                                                       tmp_path):
    args = [*chip_smoke.RGB_GOLDEN_ARGS, "--progress_off", "-q"]
    ref, out = tmp_path / "jax.y4m", tmp_path / "port.y4m"
    assert jax_cli_main(["-i", str(golden_input), "-o", str(ref), *args]) == 0
    assert run_cli(["-i", str(golden_input), "-o", str(out), *args,
                     "--device", "cpu"]) == 0
    assert out.read_bytes() == ref.read_bytes()
    assert chip_smoke.sha256_file(out) == chip_smoke.RGB_GOLDEN_SHA256
    with Y4MReader(str(out)) as r:
        assert (r.header.width, r.header.height) == (128 - 32, 72 - 16)


@pytest.fixture
def fresh_aa_tables():
    """No antialias table of an earlier trace in the JAX package's
    cache, before the test and after it."""
    jax_video._aa_luts.cache_clear()
    yield
    jax_video._aa_luts.cache_clear()


@pytest.mark.parametrize("case", sorted(chip_smoke.FLAG_CASES))
def test_flags_cli_matches_jax_cli_byte_for_byte(case, golden_input,
                                                 tmp_path, fresh_aa_tables):
    """The cases that ``chip_smoke.py`` runs on the card and on the CPU,
    here against the JAX CLI."""
    args = [*chip_smoke.FLAG_CASES[case], "--progress_off", "-q"]
    ref, out = tmp_path / "jax.y4m", tmp_path / "port.y4m"
    assert jax_cli_main(["-i", str(golden_input), "-o", str(ref), *args]) == 0
    assert run_cli(["-i", str(golden_input), "-o", str(out), *args,
                     "--device", "cpu"]) == 0
    assert out.read_bytes() == ref.read_bytes()


@pytest.mark.parametrize("argv", [
    ["-j", "8"], ["-j", "8,16"], ["-j", "8,16,2"], ["-j", "1,2,3,4"],
    ["--pre_clip", "2,4", "--post_clip", "6"], ["-Y", "0,8,2"],
    ["-X", "1"], ["-X", "1,2"], ["-B", "2,1,8"], ["-X", "1,1,16", "-B", "1"],
    ["-r", "2"], ["-r", "2,3"], ["-z", "-l", "-k", "-K"], ["-G", "0.7"],
    ["-C", "3", "--antialias_para", "0.4,0.6"], ["-V", "rgb24"],
    ["-V", "yuv422p"], ["-V", "rgb"], ["-Z", "320x240", "--zoom_filter",
                                       "bell"]])
def test_flags_parse_like_the_jax_cli(argv):
    """The internal transforms' fields of the job, from both parsers."""
    base = ["-i", "a.y4m", "-o", "b.y4m"]
    port = cli.args_to_job(cli.build_parser().parse_args(base + argv))
    ref = jax_args_to_job(jax_build_parser().parse_args(base + argv))
    for field in ("pre_im_clip", "im_clip", "ex_clip", "post_ex_clip",
                  "resize_up", "resize_down", "zoom_width", "zoom_height",
                  "zoom_filter", "reduce_w", "reduce_h", "flip_v", "flip_h",
                  "rgbswap", "decolor", "gamma", "antialias",
                  "antialias_weight", "antialias_bias", "deinterlace"):
        assert getattr(port, field) == getattr(ref, field), field
    assert port.im_colorspace.value == ref.im_colorspace.value


def test_resize_multiplier_is_checked():
    with pytest.raises(SystemExit):
        cli.args_to_job(cli.build_parser().parse_args(
            ["-i", "a", "-o", "b", "-X", "1,1,12"]))


@pytest.mark.parametrize("csp", ["bgr24", "rgba32", "y8", "yv12"])
def test_engine_refuses_colorspaces_the_y4m_writer_cannot_take(golden_input,
                                                            tmp_path, csp):
    from tcforge_tpu_torch.core.formats import ImageFormat
    job = Job(video_in_file=str(golden_input),
              video_out_file=str(tmp_path / "o.y4m"),
              im_colorspace=ImageFormat(csp))
    with pytest.raises(NotImplementedError, match=csp):
        Pipeline(job, torch.device("cpu"))


def test_cli_refuses_flags_it_lacks(golden_input, tmp_path, capsys):
    with pytest.raises(SystemExit) as exc:
        run_cli(["-i", str(golden_input), "-o", str(tmp_path / "o.y4m"),
                  "-g", "128x72", "--device", "cpu"])
    assert exc.value.code == 2
    assert "not supported by the torch port yet: -g 128x72" in \
        capsys.readouterr().err


def test_cli_cuda_without_a_card_raises(golden_input, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_cli(["-i", str(golden_input), "-o", str(tmp_path / "o.y4m"),
                  "-q"])
    assert not (tmp_path / "o.y4m").exists()


def test_chip_smoke_fails_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    assert chip_smoke.main() != 0
    out = capsys.readouterr().out
    assert '"ok"' not in out


def test_stabilize_two_pass_cli_matches_jax_cli_byte_for_byte(tmp_path,
                                                              monkeypatch):
    """The stabilize path's small case (160x120 of shaky footage, 12
    frames, --batch 5): pass 1 writes shake.trf in the run's directory,
    pass 2 reads it; both CLIs give the same .trf and Y4M bytes, and the
    digests chip_smoke.py checks on the card."""
    spec = chip_smoke.OVERLAY_PATHS["stabilize"]
    g = spec["golden"]
    src = tmp_path / "in.y4m"
    chip_smoke.write_input({**spec, **g}, src, g["frames"],
                           chip_smoke.GOLDEN_SEED)
    common = ["-i", str(src), "--batch", str(g["batch"]), "--progress_off",
              "-q"]
    files = {}
    for side, main, extra in (("jax", jax_cli_main, []),
                              ("port", run_cli, ["--device", "cpu"])):
        d = tmp_path / side
        d.mkdir()
        monkeypatch.chdir(d)
        assert main([*common, "-o", "pass1.y4m", *g["passes"][0],
                     *extra]) == 0
        assert main([*common, "-o", "out.y4m", *g["passes"][1], *extra]) == 0
        files[side] = [(d / f).read_bytes() for f in ("shake.trf",
                                                      "out.y4m")]
    assert files["port"] == files["jax"]
    assert b"#        result = shake.trf\n" in files["port"][0]
    assert (hashlib.sha256(files["port"][0]).hexdigest()
            == chip_smoke.OVERLAY_GOLDEN_SHA256["stabilize.trf"])
    assert (hashlib.sha256(files["port"][1]).hexdigest()
            == chip_smoke.OVERLAY_GOLDEN_SHA256["stabilize"])


def test_broadcast_cli_matches_jax_cli_byte_for_byte(tmp_path):
    """The broadcast path's small case (64x48 telecined film with its
    station logo, the logo options scaled down, --batch 3)."""
    spec = chip_smoke.OVERLAY_PATHS["broadcast"]
    g = spec["golden"]
    src = tmp_path / "in.y4m"
    chip_smoke.write_input({**spec, **g}, src, chip_smoke.GOLDEN_FRAMES,
                           chip_smoke.GOLDEN_SEED)
    outs = {}
    for side, main, extra in (("jax", jax_cli_main, []),
                              ("port", run_cli, ["--device", "cpu"])):
        d = tmp_path / side
        d.mkdir()
        chip_smoke.write_overlay_aux(d, logo=g["logo"])
        outs[side] = d / "out.y4m"
        assert main(["-i", str(src), "-o", str(outs[side]),
                     *chip_smoke.overlay_argv(g["args"], d), "--batch",
                     str(g["batch"]), "--progress_off", "-q", *extra]) == 0
    assert outs["port"].read_bytes() == outs["jax"].read_bytes()
    assert (chip_smoke.sha256_file(outs["port"])
            == chip_smoke.OVERLAY_GOLDEN_SHA256["broadcast"])


@pytest.fixture(scope="module")
def overlay_flag_input(tmp_path_factory):
    path = tmp_path_factory.mktemp("overlay") / "in.y4m"
    chip_smoke.write_input(chip_smoke.OVERLAY_FLAG_INPUT, path,
                           chip_smoke.GOLDEN_FRAMES, chip_smoke.GOLDEN_SEED)
    return path


@pytest.mark.parametrize("case", sorted(chip_smoke.OVERLAY_FLAG_CASES))
def test_overlay_flags_cli_matches_jax_cli_byte_for_byte(
        case, overlay_flag_input, tmp_path):
    """The slice's other option families through both CLIs: the same Y4M
    bytes, and the same .trf where the case writes one (audio filter
    names in -J are built and skipped by the video chain)."""
    files = {}
    for side, main, extra in (("jax", jax_cli_main, []),
                              ("port", run_cli, ["--device", "cpu"])):
        d = tmp_path / side
        d.mkdir()
        chip_smoke.write_overlay_aux(d)
        assert main(["-i", str(overlay_flag_input), "-o", str(d / "out.y4m"),
                     *chip_smoke.overlay_argv(
                         chip_smoke.OVERLAY_FLAG_CASES[case], d),
                     "--progress_off", "-q", *extra]) == 0
        name = chip_smoke.OVERLAY_FLAG_FILES.get(case)
        files[side] = [(d / f).read_bytes() for f in ("out.y4m", name)
                       if f]
    if case == "stabilize_algo0":
        # the header names the file by its path, which is the run's own
        for side in files:
            files[side][1] = files[side][1].replace(
                str(tmp_path / side).encode(), b"{dir}")
    assert files["port"] == files["jax"]


# -- the audio track ---------------------------------------------------

@pytest.fixture(scope="module")
def audio_inputs(tmp_path_factory):
    return chip_smoke.audio_golden_inputs(tmp_path_factory.mktemp("audio"))


@pytest.mark.parametrize("case", sorted(chip_smoke.AUDIO_GOLDEN_ARGS))
def test_audio_cli_matches_jax_cli_byte_for_byte(case, audio_inputs,
                                                 tmp_path):
    """The audio track's small cases through both CLIs: the A/V session
    (-p, -m; with -E 44100 and without; -s 1.5 -d 1) on the golden Y4M
    and the audio-only WAV-to-WAV session with -E and without: the same
    Y4M and WAV bytes, and the digests chip_smoke.py checks on the
    card."""
    outs = {}
    for side, main, extra in (("jax", jax_cli_main, []),
                              ("port", run_cli, ["--device", "cpu"])):
        base = tmp_path / side
        assert main([*chip_smoke.audio_golden_argv(case, audio_inputs, base),
                     "--progress_off", "-q", *extra]) == 0
        outs[side] = {ext: Path(f"{base}.{ext}").read_bytes()
                      for ext in ("y4m", "wav")
                      if Path(f"{base}.{ext}").exists()}
    assert outs["port"] == outs["jax"]
    assert {f"{case}.{ext}": hashlib.sha256(data).hexdigest()
            for ext, data in outs["port"].items()} == {
        k: v for k, v in chip_smoke.AUDIO_GOLDEN_SHA256.items()
        if k.startswith(case + ".")}


def test_audio_filter_in_j_without_an_audio_track(audio_inputs, tmp_path):
    """-J hqdn3d=luma=4.0,normalize with no -p: normalize is built and
    has nothing to run on; the Y4M is -J hqdn3d=luma=4.0's, as in the JAX
    CLI."""
    src = str(audio_inputs["y4m"])
    outs = {}
    for name, main, filters, extra in (
            ("jax", jax_cli_main, "hqdn3d=luma=4.0,normalize", []),
            ("port", run_cli, "hqdn3d=luma=4.0,normalize",
             ["--device", "cpu"]),
            ("video", run_cli, "hqdn3d=luma=4.0", ["--device", "cpu"])):
        outs[name] = tmp_path / f"{name}.y4m"
        assert main(["-i", src, "-o", str(outs[name]), "-J", filters,
                     "--batch", "3", "-q", *extra]) == 0
    assert (outs["port"].read_bytes() == outs["jax"].read_bytes()
            == outs["video"].read_bytes())


@pytest.mark.parametrize("batch", [3, 16])
def test_av_wav_under_resample_is_the_audio_only_sessions(batch,
                                                          audio_inputs,
                                                          tmp_path):
    """With -E the filters see the resampler's 2048-sample chunks, which
    do not depend on how the samples arrive: the A/V session's WAV is the
    audio-only session's of the same samples (``chip_smoke._run_av``
    holds the card's whole av WAV to the CPU's audio-only run so)."""
    audio = chip_smoke.AV_AUDIO_ARGS
    av = tmp_path / "av"
    assert run_cli(["-i", str(audio_inputs["y4m"]), "-p",
                    str(audio_inputs["wav"]), "-o", f"{av}.y4m", "-m",
                    f"{av}.wav", "-J", "hqdn3d=luma=4.0", *audio,
                    "--batch", str(batch), "--device", "cpu", "-q"]) == 0
    alone = tmp_path / "alone.wav"
    assert run_cli(["-i", str(audio_inputs["wav"]), "-o", str(alone),
                    *audio, "--device", "cpu", "-q"]) == 0
    assert Path(f"{av}.wav").read_bytes() == alone.read_bytes()


@pytest.fixture(scope="module")
def sync_inputs(tmp_path_factory):
    """20 frames of 64x48 at 25 fps, a WAV six frames short of it and
    one of its length."""
    d = tmp_path_factory.mktemp("sync")
    paths = {"y4m": d / "in.y4m", "short": d / "short.wav",
             "exact": d / "exact.wav"}
    chip_smoke.write_test_y4m(paths["y4m"], 64, 48, 20, 5)
    chip_smoke.write_test_wav(paths["short"], 14 * 1920, 6, frame=1920)
    chip_smoke.write_test_wav(paths["exact"], 20 * 1920, 7, frame=1920)
    return paths


SYNC_CASES = {
    "clone": ("exact", ["-D", "-3", "--resync_interval", "4"]),
    "drop": ("short", ["-D", "3", "--resync_interval", "4", "-c",
                       "0.3-0.15"]),
    "short_audio": ("short", ["--resync_interval", "0", "--resync_margin",
                              "2", "--frame_interval", "2"]),
    "clone_normalize": ("short", ["-D", "-5", "--resync_interval", "0",
                                  "-J", "normalize"]),
    "fine_ahead": ("exact", ["--av_fine_ms", "20", "-J", "normalize"]),
    "fine_behind": ("exact", ["--av_fine_ms", "-20", "--sync", "none"]),
    "seek": ("exact", ["-L", "3", "--max_frames", "11", "-D", "-3"]),
}


@pytest.mark.parametrize("case", sorted(SYNC_CASES))
def test_sync_cli_matches_jax_cli_byte_for_byte(case, sync_inputs,
                                                tmp_path):
    """The A/V synchronizer through both CLIs (batches of 8, the JAX
    engine without its device mesh so that the batches match): -D's
    audio shift, --av_fine_ms, and adjust's clones and drops with audio
    shorter than the video, the frame ids after sync under -c and
    --frame_interval."""
    wav, extra = SYNC_CASES[case]
    common = ["-i", str(sync_inputs["y4m"]), "-p", str(sync_inputs[wav]),
              "--batch", "8", *extra, "--progress_off", "-q"]
    files = {}
    for side, main, flags in (("jax", jax_cli_main, ["--mesh", "off"]),
                              ("port", run_cli, ["--device", "cpu"])):
        out = tmp_path / side
        assert main([*common, "-o", f"{out}.y4m", "-m", f"{out}.wav",
                     *flags]) == 0
        files[side] = [Path(f"{out}.{e}").read_bytes() for e in ("y4m",
                                                               "wav")]
    assert files["port"] == files["jax"]


def test_sync_counters_match_the_jax_engine(sync_inputs, tmp_path):
    """Clones and drops land in the counters as in the JAX engine."""
    argv = ["-i", str(sync_inputs["y4m"]), "-p", str(sync_inputs["short"]),
            "-o", str(tmp_path / "o.y4m"), "-m", str(tmp_path / "o.wav"),
            "--batch", "8", "-D", "-5", "--resync_interval", "0"]
    from tcforge_tpu.cli import args_to_job as jargs, build_parser as jp
    from tcforge_tpu.io.probe import probe_file, probe_to_job
    jjob = jargs(jp().parse_args(argv + ["--mesh", "off"]))
    probe_to_job(probe_file(jjob.video_in_file), jjob)
    jc = JPipeline(jjob).run(progress=False)
    pc = run_engine(Pipeline(cli.job_from_argv(argv), torch.device("cpu")))
    assert (pc.written, pc.dropped, pc.cloned) == (jc.encoded, jc.dropped,
                                                   jc.cloned)
    assert pc.cloned == 5 and pc.dropped == 2
    assert pc.audio_frames == jc.audio_frames


@pytest.mark.parametrize("argv", [
    ["-L", "2", "--max_frames", "9"], ["--max_frames", "3"],
    ["-E", "22050,16,1", "-J", "aclip"], ["-d", "1", "--batch", "5"]])
def test_audio_only_cli_flags_match_jax_cli(argv, audio_inputs, tmp_path):
    """-L and --max_frames count the audio-only session's nominal frames
    of round(rate/fps) samples; -E's bits and channels; -d."""
    files = {}
    for side, main, flags in (("jax", jax_cli_main, []),
                              ("port", run_cli, ["--device", "cpu"])):
        out = tmp_path / f"{side}.wav"
        assert main(["-i", str(audio_inputs["long"]), "-o", str(out),
                     *argv, "--progress_off", "-q", *flags]) == 0
        files[side] = out.read_bytes()
    assert files["port"] == files["jax"]


@pytest.mark.parametrize("argv,message", [
    (["-p", "{wav}", "-m", "{tmp}/a.mkv"],
     "-m {tmp}/a.mkv: the lavf multiplexor"),
    (["-p", "{y4m}", "-m", "{tmp}/a.wav"], "-p {y4m}"),
    (["-i", "{wav}", "-o", "{tmp}/a.y4m"],
     "has no video stream and muxer 'y4m' is video-only")])
def test_audio_outputs_the_port_lacks_are_refused(argv, message,
                                                  audio_inputs, tmp_path,
                                                  capsys):
    def fill(text):
        return (text.replace("{wav}", str(audio_inputs["wav"]))
                .replace("{y4m}", str(audio_inputs["y4m"]))
                .replace("{tmp}", str(tmp_path)))
    argv = [fill(a) for a in argv]
    if "-i" not in argv:
        argv = ["-i", str(audio_inputs["y4m"]), "-o",
                str(tmp_path / "v.y4m"), *argv]
    assert run_cli([*argv, "--device", "cpu", "-q"]) == 1
    assert fill(message) in capsys.readouterr().err


@pytest.mark.parametrize("argv", [
    ["-s", "1.5", "-d", "1"], ["-E", "44100"], ["-E", "44100,8,1"],
    ["-E", "32000,,2", "-d", "1"], ["-D", "-3", "--av_fine_ms", "20"],
    ["--sync", "none", "--resync_margin", "3", "--resync_interval", "7",
     "--no_audio_adjust"], ["-p", "a.wav", "-m", "b.wav"]])
def test_audio_flags_parse_like_the_jax_cli(argv):
    base = ["-i", "a.y4m", "-o", "b.y4m"]
    port = cli.args_to_job(cli.build_parser().parse_args(base + argv))
    ref = jax_args_to_job(jax_build_parser().parse_args(base + argv))
    for field in ("volume", "mp3frequency", "dm_bits", "dm_chan",
                  "av_offset", "av_fine_ms", "sync_method", "resync_margin",
                  "resync_interval", "no_audio_adjust", "audio_in_file",
                  "audio_out_file"):
        assert getattr(port, field) == getattr(ref, field), field


@pytest.mark.parametrize("case", ["dvd", "dvd_fields"])
def test_dvd_path_cli_matches_jax_cli_byte_for_byte(case, tmp_path,
                                                    jax_native):
    """The slice's path at full width: NTSC DVD video (720x480, 29.97
    fps, MP@ML, GOP N=15 M=3, 48 frames; and 6 frames of field
    pictures) through the MPEG import and hqdn3d, both CLIs on the CPU:
    the same bytes, and the digest chip_smoke.py checks on the card."""
    src = chip_smoke.mpeg_golden_input(case, tmp_path)
    args = [*chip_smoke.MPEG_GOLDEN[case][1], "--progress_off", "-q"]
    ref, out = tmp_path / "jax.y4m", tmp_path / "port.y4m"
    assert jax_cli_main(["-i", str(src), "-o", str(ref), *args, "--mesh",
                         "off"]) == 0
    assert run_cli(["-i", str(src), "-o", str(out), *args, "--device",
                    "cpu"]) == 0
    assert out.read_bytes() == ref.read_bytes()
    assert chip_smoke.sha256_file(out) == chip_smoke.MPEG_GOLDEN_SHA256[case]
    with Y4MReader(str(out)) as r:
        assert (r.header.width, r.header.height) == (chip_smoke.DVD_W,
                                                     chip_smoke.DVD_H)
        assert abs(r.header.fps - 30000 / 1001) < 1e-9
        assert sum(1 for _ in r) == (chip_smoke.DVD_FRAMES if case == "dvd"
                                     else 6)


@pytest.mark.parametrize("filters", ["detectclipping=log={log}",
                                     "detectclipping=log={log}:post=1,"
                                     "astat"])
def test_audio_only_session_inits_and_finalizes_video_filters(
        filters, audio_inputs, tmp_path):
    """A WAV-to-WAV session builds the -J video filters, gives them their
    initial states and their finalize (they see no frame), as the JAX
    engine does: detectclipping writes its suggestion at the end, the
    same line as the JAX CLI's."""
    outs = {}
    for side, main, extra in (("jax", jax_cli_main, []),
                              ("port", run_cli, ["--device", "cpu"])):
        log = tmp_path / f"{side}.log"
        assert main(["-i", str(audio_inputs["wav"]), "-o",
                     str(tmp_path / f"{side}.wav"), "-J",
                     filters.format(log=log), "--progress_off", "-q",
                     *extra]) == 0
        outs[side] = (log.read_bytes(),
                      (tmp_path / f"{side}.wav").read_bytes())
    assert outs["port"] == outs["jax"]
    assert outs["port"][0]
