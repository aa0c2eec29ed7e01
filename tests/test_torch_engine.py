"""The port's streaming engine against the JAX engine, through both CLIs
on the CPU: the output files byte for byte and the counters (frames
read, written, skipped, dropped) equal, for ``-c`` ranges,
``--frame_interval``, ``-L``, ``--max_frames``, every ``--prefetch`` and
``--batch`` pairing tested, the identity job and ``-I 2``, selection on
the repeated ids of doublefps and on a rate change, and a Y4M cut in
the middle of a frame, which both CLIs refuse.  The input is
``chip_smoke.write_motion_y4m``'s clip, 20 frames of 64x48 at 25 fps.

There is no pytest-timeout here: every engine run goes through
``run_cli`` or ``run_engine``, which run it in a thread, join it with a
timeout and fail the test if it did not end, so that a hang fails one
test.  The engine's own waits are bounded (``_POLL_S``): a dead thread
on the other side of a queue raises instead of blocking forever."""

from __future__ import annotations

import queue
import threading

import numpy as np
import pytest
import torch

import chip_smoke
from tcforge_tpu.cli import main as jax_cli_main
from tcforge_tpu.pipeline.engine import Pipeline as JPipeline
from tcforge_tpu_torch import cli
from tcforge_tpu_torch.core.job import Job
from tcforge_tpu_torch.io.y4m import Y4MReader
from tcforge_tpu_torch.pipeline import engine
from tcforge_tpu_torch.pipeline.engine import Pipeline

FRAMES = 20
TIMEOUT_S = 120.0


def _in_thread(fn, *args):
    """``fn(*args)`` in a thread joined with a timeout: its result, or
    the exception it raised; the test fails if it did not end."""
    result = {}

    def target():
        try:
            result["value"] = fn(*args)
        except BaseException as e:      # handed to the test
            result["error"] = e

    t = threading.Thread(target=target, daemon=True)
    t.start()
    t.join(TIMEOUT_S)
    assert not t.is_alive(), f"{fn.__name__} did not end in {TIMEOUT_S} s"
    if "error" in result:
        raise result["error"]
    return result["value"]


def run_cli(argv):
    """The port's CLI on ``argv``, in a thread joined with a timeout."""
    return _in_thread(cli.main, argv)


def run_engine(pipe: Pipeline, **kwargs):
    """``pipe.run()`` in a thread joined with a timeout."""
    return _in_thread(lambda: pipe.run(**kwargs))


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    path = tmp_path_factory.mktemp("engine") / "m.y4m"
    chip_smoke.write_motion_y4m(path, 64, 48, FRAMES, seed=31, fps=(25, 1))
    return path


@pytest.fixture
def counters(monkeypatch):
    """The counters each engine's ``run`` returned, by engine."""
    got = {"jax": [], "port": []}
    for key, cls in (("jax", JPipeline), ("port", Pipeline)):
        def run(self, *a, _orig=cls.run, _key=key, **k):
            c = _orig(self, *a, **k)
            got[_key].append(c)
            return c
        monkeypatch.setattr(cls, "run", run)
    return got


def both_clis(src, tmp_path, argv, counters):
    """Both CLIs on ``src``: equal exit codes (1 when no frame was
    read), equal files and equal counters; returns the port's
    counters."""
    ref, out = tmp_path / "jax.y4m", tmp_path / "port.y4m"
    args = [*argv, "--progress_off", "-q"]
    rc = jax_cli_main(["-i", str(src), "-o", str(ref), *args])
    assert run_cli(["-i", str(src), "-o", str(out), *args,
                    "--device", "cpu"]) == rc
    assert out.read_bytes() == ref.read_bytes()
    (jc,), (pc,) = counters["jax"], counters["port"]
    assert (pc.frames, pc.written, pc.skipped, pc.dropped) == \
        (jc.frames_in, jc.encoded, jc.skipped, jc.dropped)
    return pc


# -c takes times: a bare number is seconds and ".F" adds F frames, so
# 0.2-0.5 is frames [2, 5) and 2-5 is [50, 125) at 25 fps
CASES = {
    "ranges": ["-c", "0.2-0.5,0.9-0.12"],
    "ranges_batch4": ["-c", "0.2-0.5,0.9-0.12", "--batch", "4"],
    "ranges_step": ["-c", "0.1-0.19/3", "--batch", "7"],
    "ranges_in_seconds": ["-c", "2-5,9-12"],
    "frame_interval": ["--frame_interval", "2"],
    "frame_interval_batch5": ["--frame_interval", "3", "--batch", "5"],
    "seek": ["-L", "3"],
    "seek_ranges": ["-L", "3", "-c", "0.0-0.4,0.10-0.40"],
    "seek_past_the_end": ["-L", "30"],
    "max_frames": ["--max_frames", "5"],
    "max_frames_ranges": ["--max_frames", "12", "-c", "0.1-0.15"],
    "identity": [],
    "identity_batch1": ["--batch", "1"],
    "deinterlace_2": ["-I", "2"],
    "bob_ranges": ["-J", "doublefps,smartbob", "-c", "0.3-0.9"],
    "bob_interval": ["-J", "doublefps", "--frame_interval", "2"],
    "fps_up_ranges": ["-J", "fps=25:50", "-c", "0.2-0.12", "--batch", "6"],
    "fps_down_ranges": ["-J", "fps=infps=25:outfps=15", "-c", "0.0-0.10"],
    "slowmo_interval": ["-J", "slowmo=factor=3", "--frame_interval", "2"],
    "skip_ranges": ["-J", "skip=0.3-0.7", "-c", "0.1-0.15"],
    "modfps_export_fps": ["-J", "modfps=buffer=7", "--export_fps", "20"],
    "modfps_up": ["-J", "modfps=clonetype=3", "--export_fps", "30",
                  "--batch", "3"],
    "smartdeinter_hqdn3d": ["-J", "smartdeinter,hqdn3d=luma=4.0",
                            "--batch", "6"],
    "smartyuv": ["-J", "smartyuv", "--batch", "7"],
    "barrel": ["-J", "barrel=order2=0.2:range=2-15/3"],
    "simple": ["-J", "invert,levels=gamma=1.4,mask=lefttop=4x4,null"],
    "testframe_deinterlace": ["-J", "testframe=mode=1,deinterlace"],
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_engine_matches_the_jax_engine(clip, tmp_path, counters, case):
    both_clis(clip, tmp_path, CASES[case], counters)


@pytest.mark.parametrize("batch", [1, 3, 16])
@pytest.mark.parametrize("prefetch", [1, 2, 4])
def test_prefetch_and_batch_give_the_same_bytes(clip, tmp_path, counters,
                                                prefetch, batch):
    """The same bytes as the JAX CLI at every read-ahead depth and
    batch size, through a chain that carries state (hqdn3d) and a frame
    selection."""
    pc = both_clis(clip, tmp_path, [
        "-I", "5", "-J", "hqdn3d=luma=4.0", "-c", "0.0-0.7,0.11-0.20",
        "--prefetch", str(prefetch), "--batch", str(batch)], counters)
    assert pc.batches == -(-FRAMES // batch)


def test_selection_counts_each_frame_once(clip, tmp_path, counters):
    """The engine reads up to the end of the ranges (9 frames), and
    doublefps emits two frames an id: frames [3, 9) select 12 of the 18
    emitted, and the other 6 are counted skipped."""
    pc = both_clis(clip, tmp_path, ["-J", "doublefps", "-c", "0.3-0.9"],
                   counters)
    assert (pc.frames, pc.written, pc.skipped) == (9, 12, 6)
    with Y4MReader(str(tmp_path / "port.y4m")) as r:
        assert r.header.fps == 50.0
        assert r.header.height == 24


def test_identity_job_never_reaches_the_device(clip, tmp_path, monkeypatch):
    """No filter and no transform: the chain is skipped, the planes stay
    in host memory (the batch tensors are numpy's)."""
    seen = []
    real = engine.FrameBatch

    def spy(**kw):
        fb = real(**kw)
        seen.append(fb.y.device.type)
        return fb

    monkeypatch.setattr(engine, "FrameBatch", spy)
    job = Job(video_in_file=str(clip), video_out_file=str(tmp_path / "o.y4m"),
              batch_size=6)
    pipe = Pipeline(job, torch.device("cpu"))
    assert pipe.chain.is_identity()
    monkeypatch.setattr(type(pipe.chain), "__call__",
                        lambda *a: pytest.fail("the chain ran"))
    c = run_engine(pipe)
    assert seen == ["cpu"] * 4 and c.written == FRAMES
    with Y4MReader(str(clip)) as a, Y4MReader(str(tmp_path / "o.y4m")) as b:
        for want, got in zip(a.read_batch(FRAMES), b.read_batch(FRAMES)):
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("flags", [["-I", "2"], ["-J", "null"],
                                   ["-G", "1.0"]])
def test_no_ops_that_are_not_identity(clip, flags):
    """-I 2 does nothing and is not the identity job (the JAX
    ``is_identity`` rule); neither is a null filter."""
    job = cli.job_from_argv(["-i", str(clip), "-o", "x.y4m", *flags])
    from tcforge_tpu_torch.pipeline.chain import VideoChain
    from tcforge_tpu_torch.core.formats import ImageFormat
    chain = VideoChain(job, ImageFormat.YUV420P, 64, 48)
    assert chain.is_identity() == (flags == ["-G", "1.0"])


@pytest.mark.parametrize("cut", [3, 6 + 64 * 48 * 3 // 2 - 1])
def test_a_cut_frame_fails_the_cli(clip, tmp_path, cut):
    """A file that ends inside a frame (in its FRAME line, or one byte
    short of its planes): the port's CLI exits non-zero, as the JAX
    package's Y4M reader raises (its native reader, where it is built,
    stops at the cut instead)."""
    from tcforge_tpu.io.y4m import Y4MReader as JY4MReader
    data = clip.read_bytes()
    frame = 6 + 64 * 48 * 3 // 2
    header = len(data) - FRAMES * frame
    src = tmp_path / "cut.y4m"
    src.write_bytes(data[:header + 7 * frame + cut])
    with pytest.raises(ValueError), JY4MReader(str(src)) as r:
        r.read_batch(FRAMES)
    args = ["-i", str(src), "--progress_off", "-q"]
    for argv in ([], ["-J", "hqdn3d", "--batch", "3"]):
        assert run_cli([*args, "-o", str(tmp_path / "p.y4m"), *argv,
                        "--device", "cpu"]) == 1


@pytest.mark.parametrize("batch", [1, 4, 16])
def test_frame_lines_with_parameters(clip, tmp_path, batch):
    """Frame lines that carry parameters (``FRAME Ip``) are longer than
    the bare marker the batched read expects: those frames are parsed
    one by one, and every frame still comes out as the input's."""
    data = clip.read_bytes()
    frame = 6 + 64 * 48 * 3 // 2
    header = len(data) - FRAMES * frame
    parts = [data[:header]]
    for k in range(FRAMES):
        body = data[header + k * frame + 6:header + (k + 1) * frame]
        parts.append((b"FRAME Ip XA1:1\n" if k % 3 == 1 else b"FRAME\n")
                     + body)
    src = tmp_path / "params.y4m"
    src.write_bytes(b"".join(parts))
    out = tmp_path / "o.y4m"
    assert run_cli(["-i", str(src), "-o", str(out), "-J", "null", "--batch",
                    str(batch), "--device", "cpu", "-q"]) == 0
    with Y4MReader(str(clip)) as a, Y4MReader(str(out)) as b:
        for want, got in zip(a.read_batch(FRAMES), b.read_batch(FRAMES)):
            np.testing.assert_array_equal(got, want)


def test_a_failing_writer_ends_the_run(clip, tmp_path):
    """An output that cannot be opened: the writer thread's error comes
    out of the run, and no thread is left behind."""
    before = threading.active_count()
    job = Job(video_in_file=str(clip),
              video_out_file=str(tmp_path / "no" / "such" / "dir.y4m"),
              batch_size=2, prefetch_depth=1, deinterlace=5)
    with pytest.raises(OSError):
        run_engine(Pipeline(job, torch.device("cpu")))
    assert threading.active_count() == before


def test_a_failing_chain_ends_the_run(clip, tmp_path, monkeypatch):
    """A filter that raises on the third batch: the error comes out of
    the run, the reader stops though its queue is full, and every
    filter is finalized."""
    before = threading.active_count()
    job = Job(video_in_file=str(clip), video_out_file=str(tmp_path / "o.y4m"),
              batch_size=1, prefetch_depth=1, deinterlace=5)
    pipe = Pipeline(job, torch.device("cpu"))
    calls = []
    real = pipe.chain.__class__.__call__

    def step(self, fb, states):
        calls.append(fb.batch)
        if len(calls) == 3:
            raise ValueError("a filter failed")
        return real(self, fb, states)

    monkeypatch.setattr(pipe.chain.__class__, "__call__", step)
    with pytest.raises(ValueError, match="a filter failed"):
        run_engine(pipe)
    assert threading.active_count() == before
    with Y4MReader(str(tmp_path / "o.y4m")) as r:
        assert sum(1 for _ in r) == 2


def test_bounded_get_raises_when_the_producer_is_gone():
    q = queue.Queue()
    with pytest.raises(RuntimeError, match="reader thread ended"):
        engine._get(q, lambda: False, "reader")
    q.put(5)
    assert engine._get(q, lambda: False, "reader") == 5


def test_bounded_put_gives_up_when_stopped():
    q = queue.Queue(maxsize=1)
    stop = threading.Event()
    assert engine._put(q, 1, stop)
    stop.set()
    assert not engine._put(q, 2, stop)


def test_progress_meter_writes_to_a_terminal_only(capsys):
    """Off unless stderr is a terminal (it is not under pytest)."""
    meter = engine.ProgressMeter(10, enabled=True, interval=0.0)
    meter.update(5)
    meter.finish()
    assert not meter.enabled and capsys.readouterr().err == ""


@pytest.mark.parametrize("argv,field,value", [
    (["-c", "0.2-0.5,0.9-0.12"], "ranges", [(2, 5, 1), (9, 12, 1)]),
    (["-c", "2-5/2"], "ranges", [(50, 125, 2)]),
    (["-c", "0:00:01-0:00:02.3"], "ranges", [(25, 53, 1)]),
    (["--frame_interval", "3"], "frame_interval", 3),
    (["-L", "4"], "vob_offset", 4), (["--vob_seek", "7"], "vob_offset", 7),
    (["--export_fps", "29.97"], "ex_fps", 29.97),
    (["--prefetch", "4"], "prefetch_depth", 4),
    (["--progress_rate", "2.5"], "progress_rate", 2.5)])
def test_engine_flags_parse_like_the_jax_cli(clip, argv, field, value):
    """The engine's flags, from both parsers; -c after the probe, so a
    time range counts frames at the input's rate (25 fps here)."""
    from tcforge_tpu.cli import args_to_job as jax_args_to_job
    from tcforge_tpu.cli import build_parser as jax_build_parser
    from tcforge_tpu.core.framecode import parse_ranges as jax_parse_ranges
    base = ["-i", str(clip), "-o", "b.y4m"]
    port = cli.job_from_argv(base + argv)
    args = jax_build_parser().parse_args(base + argv)
    ref = jax_args_to_job(args)
    if args.ranges:
        ref.ranges = jax_parse_ranges(args.ranges, 25.0)

    def plain(job):
        got = getattr(job, field)
        if field == "ranges":
            return [(r.stf, r.etf, r.stepf) for r in got.ranges]
        return got

    assert plain(port) == plain(ref) == value


@pytest.mark.cuda
@pytest.mark.parametrize("argv", [
    ["-J", "smartdeinter,hqdn3d=luma=4.0", "-Z", "48x32"],
    ["-J", "doublefps,smartbob", "-c", "0.3-0.9"],
    ["-J", "modfps=clonetype=4", "--export_fps", "30"], ["-J", "null"]])
def test_staged_engine_on_the_card_matches_the_cpu(clip, tmp_path, argv):
    """On a card the batches cross through pinned buffers and two copy
    streams: the same bytes as on the CPU at every prefetch depth and
    batch size (``chip_smoke.py`` runs the full-size paths)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    want = tmp_path / "cpu.y4m"
    assert run_cli(["-i", str(clip), "-o", str(want), *argv, "--device",
                    "cpu", "-q"]) == 0
    for prefetch in (1, 2, 4):
        for batch in (1, 3, 16):
            got = tmp_path / f"cuda_{prefetch}_{batch}.y4m"
            assert run_cli(["-i", str(clip), "-o", str(got), *argv,
                            "--prefetch", str(prefetch), "--batch",
                            str(batch), "--device", "cuda", "-q"]) == 0
            assert got.read_bytes() == want.read_bytes()
