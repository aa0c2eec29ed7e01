"""The port's MPEG navigation, VideoCD input and ``multi`` over transport
streams, against the JAX package, on the CPU.

- The CLI's PSU and cluster flags (``--psu_mode``, ``--psu_first``,
  ``--psu_last``, ``--psu_chunks``, ``--no_split``, ``-S``, ``-W
  n,m[,navfile]``, ``--cluster_chunks``, ``--cluster_percentage``,
  ``--nav_seek``, ``--ts_pid``) in every combination the tests name,
  each pipeline replaced by a stand-in that records its job: the port's
  CLI builds the pipelines the JAX CLI builds, with the same units,
  outputs, seeks and lengths, and returns the same code.
- The ``chip_smoke.TS_GOLDEN`` VideoCD, PSU and cluster cases through
  both CLIs, byte for byte, their SHA-256 pinned for ``chip_smoke.py``
  (each unit's WAV starts at the track's first sample, as in the JAX
  importer; ``--psu_chunks`` with ``--no_split`` runs the whole stream).
- The importer's unit cuts and their errors against the JAX importer's;
  the VideoCD temporary file gone after ``close`` and after a failed
  ``open``; ``multi`` over transport streams and over VideoCD tracks
  through both CLIs; ``-x auto`` takes a VideoCD track to ``mpeg``.
"""

from __future__ import annotations

import itertools
import json
import tempfile
import threading
from pathlib import Path

import pytest
import torch

import chip_smoke
import tcforge_tpu.pipeline.engine as jengine
from tcforge_tpu.cli import main as jax_cli_main
from tcforge_tpu.core.job import Job as JJob
from tcforge_tpu.modules.registry import ModuleKind as JKind
from tcforge_tpu.modules.registry import new_module as jax_new_module
from tcforge_tpu_torch import cli
from tcforge_tpu_torch.core.job import Job
from tcforge_tpu_torch.modules.registry import ModuleKind, new_module
from tcforge_tpu_torch.pipeline import engine
from test_torch_mpeg_import import jax_cli, jax_native, port_cli  # noqa: F401
from test_torch_ts import assert_golden, in_tree_bridge, run_goldens

DATA = chip_smoke.TS_DATA
CPU = torch.device("cpu")
NAV_CASES = ["cdxa", "psu", "psu_range", "psu_chunks", "no_split",
             "chunks_no_split", "seek_unit", "w_nav", "w_pct", "w_chunks"]
# what a pipeline of the CLI is asked to run
FIELDS = ("video_out_file", "psu_unit", "psu_unit_end", "seek_unit",
          "vob_offset", "max_frames", "ts_pid1", "vob_chunk",
          "vob_chunk_max", "vob_chunk_num1", "vob_chunk_num2",
          "nav_seek_file")


# ------------------------------------------------------------------ #
# the CLI's flags, each pipeline a stand-in that records its job

class _Counters:
    frames = frames_in = 1

    def summary(self) -> str:
        return ""


def _recorder(jobs):
    class Recorder:
        def __init__(self, job, *device):
            jobs.append({f: getattr(job, f) for f in FIELDS})
            self.interrupted = threading.Event()
            self.paused = threading.Event()
            self.device = device

        def run(self, progress=True):
            return _Counters()
    return Recorder


def _both(argv, monkeypatch):
    """Each CLI's exit code and the jobs of the pipelines it built."""
    got = {}
    for side, main, module, extra in (
            ("jax", jax_cli_main, jengine, ["--mesh", "off"]),
            ("port", cli.main, engine, ["--device", "cpu"])):
        jobs = []
        monkeypatch.setattr(module, "Pipeline", _recorder(jobs))
        rc = main([*argv, *extra, "-q", "--progress_off"])
        got[side] = (rc, jobs)
    return got


@pytest.fixture(scope="module")
def nav_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("nav") / "nav.json"
    path.write_text(json.dumps({"total_pictures": 15}))
    return path


PSU_COMBOS = list(itertools.product(
    (False, True), (False, True), (0, 2, 7), (-1, 3, 9), ("", "1-3", "4-9")))


@pytest.mark.parametrize("mode,no_split,first,last,chunks", PSU_COMBOS)
def test_psu_flags_build_the_jax_clis_pipelines(mode, no_split, first, last,
                                                chunks, monkeypatch,
                                                tmp_path):
    argv = ["-i", str(DATA / "video.m2v"), "-o", str(tmp_path / "u%d.y4m"),
            "--psu_first", str(first), "--psu_last", str(last)]
    argv += ["--psu_mode"] * mode + ["--no_split"] * no_split
    argv += ["--psu_chunks", chunks] if chunks else []
    got = _both(argv, monkeypatch)
    assert got["port"] == got["jax"]


@pytest.mark.parametrize("no_split", [False, True])
def test_psu_mode_without_a_unit_number_in_the_output(no_split,
                                                      monkeypatch, tmp_path):
    argv = ["-i", str(DATA / "video.m2v"), "-o", str(tmp_path / "u.y4m"),
            "--psu_mode"] + ["--no_split"] * no_split
    got = _both(argv, monkeypatch)
    assert got["port"] == got["jax"]
    assert got["port"][0] == (0 if no_split else 1)


W_COMBOS = list(itertools.product(
    ("0,3", "2,3", "1,4", "25,50", "90,20"),
    ("in_w", "nav_seek", "max_frames", "none", "missing"),
    (False, True), ("", "1-3")))


@pytest.mark.parametrize("w,length,pct,chunks", W_COMBOS)
def test_cluster_flags_build_the_jax_clis_pipelines(w, length, pct, chunks,
                                                    monkeypatch, tmp_path,
                                                    nav_file):
    spec = w + (f",{nav_file}" if length == "in_w" else
                f",{tmp_path / 'absent.json'}" if length == "missing"
                else "")
    argv = ["-i", str(DATA / "video.m2v"), "-o", str(tmp_path / "o.y4m"),
            "-W", spec]
    if length == "nav_seek":
        argv += ["--nav_seek", str(nav_file)]
    if length == "max_frames":
        argv += ["--max_frames", "12"]
    argv += ["--cluster_percentage"] * pct
    argv += ["--cluster_chunks", chunks] if chunks else []
    got = _both(argv, monkeypatch)
    assert got["port"] == got["jax"]
    assert got["port"][0] == (1 if length in ("none", "missing") else 0)


@pytest.mark.parametrize("flags", [
    ["-S", "1"], ["-S", "2,5"], ["-S", "0"], ["-S", "4,1", "-L", "3"],
    ["--ts_pid", "100"], ["--ts_pid", "0x200"], ["--ts_pid", "1fff"],
    ["-W", "3"], ["--nav_seek", "{nav}"]], ids=lambda f: "_".join(f))
def test_seek_and_pid_flags_reach_the_job_as_in_jax(flags, monkeypatch,
                                                    tmp_path, nav_file):
    flags = [str(nav_file) if f == "{nav}" else f for f in flags]
    argv = ["-i", str(DATA / "video.m2v"), "-o", str(tmp_path / "o.y4m"),
            *flags]
    got = _both(argv, monkeypatch)
    assert got["port"] == got["jax"]


# ------------------------------------------------------------------ #
# the importer

def _vcd(tmp_path) -> Path:
    return chip_smoke.ts_input("vcd.dat", tmp_path)


@pytest.mark.parametrize("what,value", [("psu_unit", 5), ("psu_unit", 99),
                                        ("seek_unit", 5), ("seek_unit", 9)])
def test_units_out_of_range_raise_the_jax_error(what, value, tmp_path,
                                                jax_native):
    src = str(DATA / "video.m2v")
    errors = []
    for job, new in ((JJob(), jax_new_module), (Job(), new_module)):
        setattr(job, what, value)
        imp = new(JKind.DEMULTIPLEXOR if new is jax_new_module
                  else ModuleKind.DEMULTIPLEXOR, "mpeg", job)
        with pytest.raises(ValueError) as e:
            imp.open(src)
        errors.append(str(e.value))
    assert errors[0] == errors[1] and "out of range (5 units)" in errors[0]


@pytest.mark.parametrize("unit,end", [(0, -1), (2, -1), (4, -1), (1, 3),
                                      (3, 2)])
def test_a_units_frames_are_the_jax_importers(unit, end, jax_native):
    src = str(DATA / "video.m2v")
    frames = []
    for side in ("jax", "port"):
        if side == "jax":
            imp = jax_new_module(JKind.DEMULTIPLEXOR, "mpeg",
                                 JJob(psu_unit=unit, psu_unit_end=end))
        else:
            imp = new_module(ModuleKind.DEMULTIPLEXOR, "mpeg",
                             Job(psu_unit=unit, psu_unit_end=end))
        imp.open(src)
        if side == "port":
            imp.start(CPU)
        got = []
        while True:
            b = imp.read_video_batch(4)
            if b is None:
                break
            got.extend(bytes(memoryview(
                b["y"][k].numpy() if isinstance(b["y"], torch.Tensor)
                else b["y"][k])) for k in range(b["y"].shape[0]))
        imp.close()
        frames.append(got)
    assert frames[0] == frames[1] and frames[0]


@pytest.fixture
def temp_dir(tmp_path, monkeypatch):
    """The directory where ``tempfile`` makes its files."""
    d = tmp_path / "temp"
    d.mkdir()
    monkeypatch.setattr(tempfile, "tempdir", str(d))
    return d


def test_the_vcd_temporary_file_goes_at_close(tmp_path, temp_dir):
    imp = new_module(ModuleKind.DEMULTIPLEXOR, "mpeg", Job())
    imp.open(str(_vcd(tmp_path)))
    assert [p.suffix for p in temp_dir.iterdir()] == [".mpg"]
    imp.start(CPU)
    assert imp.read_video_batch(4)["y"].shape == (4, 144, 176)
    imp.close()
    assert not list(temp_dir.iterdir())


@pytest.mark.parametrize("what", ["psu_unit", "seek_unit"])
def test_the_vcd_temporary_file_goes_when_open_fails(what, tmp_path,
                                                     temp_dir):
    job = Job(**{what: 12})
    imp = new_module(ModuleKind.DEMULTIPLEXOR, "mpeg", job)
    with pytest.raises(ValueError, match="out of range"):
        imp.open(str(_vcd(tmp_path)))
    assert not list(temp_dir.iterdir())


def test_x_auto_takes_a_vcd_track_to_mpeg(tmp_path):
    job = Job(video_in_file=str(_vcd(tmp_path)))
    assert engine.video_module(job) == "mpeg"


# ------------------------------------------------------------------ #
# the CLI

@pytest.fixture(scope="module")
def nav_outputs(jax_native, tmp_path_factory):
    return run_goldens(NAV_CASES, tmp_path_factory.mktemp("nav_goldens"))


@pytest.mark.parametrize("case", NAV_CASES)
def test_nav_golden_cli_matches_jax_cli_byte_for_byte(case, nav_outputs):
    assert_golden(nav_outputs, case)


def test_each_psu_writes_the_tracks_start(nav_outputs, tmp_path):
    """PSU mode with -m: each unit's WAV starts at the track's first
    sample (the JAX importer cuts the video alone), so the last unit's
    file, which -m names, holds the head of the track that units 1 to 4
    in one file (--no_split) hold too."""
    from tcforge_tpu_torch.io.wav import WavReader
    pcm = []
    for case in ("psu", "no_split"):
        path = tmp_path / f"{case}.wav"
        path.write_bytes(nav_outputs[case]["port"][-1])
        with WavReader(str(path)) as r:
            pcm.append(r.read_samples(1 << 20))
    n = pcm[0].shape[0]
    assert 0 < n < pcm[1].shape[0]
    assert (pcm[0] == pcm[1][:n]).all()


def test_psu_chunks_with_no_split_runs_the_whole_stream(nav_outputs):
    assert nav_outputs["chunks_no_split"]["port"][0].count(b"FRAME") == 15


@pytest.mark.parametrize("kind", ["ts", "dat"])
def test_multi_plays_transport_streams_and_vcd_tracks(kind, tmp_path,
                                                      jax_native):
    names = (("mp2.ts", "aac.ts") if kind == "ts"
             else ("vcd.dat", "vcd.dat"))
    src = tmp_path / "dir"
    src.mkdir()
    for k, name in enumerate(names):
        (src / f"{k}_{name}").write_bytes(
            chip_smoke.ts_input(name, tmp_path).read_bytes())
    outs = {}
    for side, run in (("jax", jax_cli), ("port", port_cli)):
        o = tmp_path / side
        with in_tree_bridge():
            assert run(["-i", str(src), "-o", f"{o}.y4m", "-m", f"{o}.wav",
                        "-J", "hqdn3d=luma=4.0", "--batch", "6"]) == 0
        outs[side] = [Path(f"{o}.{e}").read_bytes() for e in ("y4m", "wav")]
    assert outs["port"] == outs["jax"]
    assert outs["port"][0].count(b"FRAME") == 30
