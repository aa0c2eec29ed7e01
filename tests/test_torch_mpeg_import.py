"""The port's MPEG import (``modules/importers/mpeg_import.py``) and the
engine's MPEG input, on the CPU.

Whole paths first: the port's CLI against the JAX CLI byte for byte on
the ``chip_smoke.MPEG_GOLDEN`` cases (a small program and elementary
stream, field pictures, MPEG-1 with B pictures and with D-pictures, all
intra, a size that is not a multiple of 16, the synthetic streams, a
stream cut mid-picture, ``-c``, ``-L`` on a program and an elementary
stream, ``--frame_interval`` with batches of 2 that end inside B runs),
each output's SHA-256 pinned for ``chip_smoke.py`` to check on the card.
The JAX importer needs the JAX package's native library; these goldens
are the only tests here that reach it (``jax_native``), and none of them
skips.  Then the port alone: its batches do not change its frames, the
windowed reader equals the whole-stream one, the probe sets what the JAX
CLI's sets, the pieces out of this slice raise, and the decoder's state
carries over from the JAX importer (``interop.py``).
"""

from __future__ import annotations

import fcntl
import hashlib
import logging
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from tcforge_tpu.cli import main as jax_cli_main
from tcforge_tpu.core.job import Job as JJob
from tcforge_tpu.io.probe import probe_file as jax_probe_file
from tcforge_tpu.io.probe import probe_to_job as jax_probe_to_job
from tcforge_tpu.modules.registry import ModuleKind as JKind
from tcforge_tpu.modules.registry import new_module as jax_new_module
from tcforge_tpu_torch import interop
from tcforge_tpu_torch.core.job import Job
from tcforge_tpu_torch.modules.registry import ModuleKind, new_module
from tcforge_tpu_torch.pipeline import engine
from test_torch_engine import run_cli

DATA = chip_smoke.MPEG_DATA
ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def jax_native():
    """The JAX package's native library, which its MPEG importer needs.
    Its loader builds it on first use with no lock, so test processes
    that start together can race; here the first load waits on a file
    lock, runs the package's own make where no library exists yet, and
    tries again while another process is writing the library.  A
    library that still does not load fails the test: nothing skips."""
    from tcforge_tpu import native
    from tcforge_tpu.native import build as native_build
    build = ROOT / "tcforge_tpu_torch" / "_build"
    build.mkdir(exist_ok=True)
    with open(build / "jax_native.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        for attempt in range(60):
            try:
                if native.available():
                    break
            except OSError:
                pass
            if attempt == 0 and not Path(native._lib_path()).exists():
                # nobody built it in this process: build it (the
                # package's own make), quietly
                import subprocess
                subprocess.call(["make", "-C", native_build.native_dir()],
                                stdout=subprocess.DEVNULL,
                                stderr=subprocess.DEVNULL, timeout=600)
            native._SEARCHED = False        # look for it again
            time.sleep(2.0)
    assert native.available(), "the JAX package's native library"
    return native


def jax_cli(argv):
    return jax_cli_main([*argv, "--mesh", "off", "-q", "--progress_off"])


def port_cli(argv):
    return run_cli([*argv, "--device", "cpu", "-q", "--progress_off"])


# the slice's own path, dvd and dvd_fields, is in test_torch_cli.py
GOLDEN_HERE = sorted(set(chip_smoke.MPEG_GOLDEN) - {"dvd", "dvd_fields"})


@pytest.mark.parametrize("case", GOLDEN_HERE)
def test_mpeg_golden_cli_matches_jax_cli_byte_for_byte(case, tmp_path,
                                                       jax_native):
    src = chip_smoke.mpeg_golden_input(case, tmp_path)
    args = chip_smoke.MPEG_GOLDEN[case][1]
    ref, out = tmp_path / "jax.y4m", tmp_path / "port.y4m"
    assert jax_cli(["-i", str(src), "-o", str(ref), *args]) == 0
    assert port_cli(["-i", str(src), "-o", str(out), *args]) == 0
    assert out.read_bytes() == ref.read_bytes()
    assert chip_smoke.sha256_file(out) == chip_smoke.MPEG_GOLDEN_SHA256[case]


def test_a_cut_stream_warns_and_keeps_what_decoded(tmp_path, caplog):
    src = chip_smoke.mpeg_golden_input("cut", tmp_path)
    with caplog.at_level(logging.WARNING, logger="tcforge_tpu_torch"):
        assert port_cli(["-i", str(src), "-o", str(tmp_path / "o.y4m")]) == 0
    assert "broken picture dropped" in caplog.text


# ------------------------------------------------------------------ #
# the port alone

def importer(name: str, options: str = "", **job):
    """The port's importer on ``name``, decoding on the CPU."""
    imp = new_module(ModuleKind.DEMULTIPLEXOR, "mpeg", Job(**job), options)
    imp.open(str(DATA / name))
    imp.start(torch.device("cpu"))
    return imp


def decode_all(imp, n: int):
    out = []
    while True:
        got = imp.read_video_batch(n)
        if got is None:
            return out
        assert 0 < got["y"].shape[0] <= n
        out.append(got)


def frames(batches):
    return {k: torch.cat([b[k] for b in batches]) for k in "yuv"}


_WHOLE = {}


def whole(name: str):
    if name not in _WHOLE:
        _WHOLE[name] = frames(decode_all(importer(name), 16))
    return _WHOLE[name]


@pytest.mark.parametrize("name,batch", [
    (n, b) for n in ("small.mpg", "small.m2v", "fields.m2v",
                     "synth_fields.m2v", "mpeg1.m1v", "dpict.m1v",
                     "intra.m2v", "synth_odd.m2v")
    for b in (1, 3, 7)])
def test_batches_do_not_change_the_frames(name, batch):
    """The display order, the spill of frames beyond a request and the
    intra runs the JAX importer flushes when its n slots fill: every
    batch size gives the same frames."""
    got = frames(decode_all(importer(name), batch))
    want = whole(name)
    for k in "yuv":
        assert torch.equal(got[k], want[k])


@pytest.mark.parametrize("name", ["small.mpg", "small.m2v", "fields.m2v",
                                  "dvd_fields.vob"])
def test_windowed_reader_equals_the_whole_stream(name):
    """4 KB windows of the program stream's video (or of the file)
    against the whole elementary stream parsed at once."""
    small = frames(decode_all(importer(name, "window=4"), 5))
    buffered = frames(decode_all(importer(name, "stream=0"), 5))
    for k in "yuv":
        assert torch.equal(small[k], buffered[k])


@pytest.mark.parametrize("name", sorted(p.name for p in DATA.iterdir()
                                        if p.suffix != ".py"))
def test_probe_sets_what_the_jax_cli_sets(name):
    job = Job(video_in_file=str(DATA / name))
    assert engine.video_module(job) == "mpeg"
    assert engine.probe(job) is None
    jjob = jax_probe_to_job(jax_probe_file(str(DATA / name)), JJob())
    assert (job.im_v_width, job.im_v_height, job.fps) == \
        (jjob.im_v_width, jjob.im_v_height, jjob.fps)
    assert job.im_v_format.value == jjob.im_v_format.value
    imp = importer(name)
    assert (imp.width, imp.height) == (job.im_v_width, job.im_v_height)


@pytest.mark.parametrize("spec,kind", [("auto", "mpeg"), ("mpeg", "mpeg"),
                                       ("mpeg2", "mpeg"), ("vob", "mpeg"),
                                       ("mpg", "mpeg"), ("y4m", "y4m")])
def test_import_module_names(spec, kind):
    job = Job(video_in_file=str(DATA / "small.mpg"), im_v_module=spec)
    assert engine.video_module(job) == kind


def test_cli_takes_x_like_the_jax_cli():
    from tcforge_tpu.cli import args_to_job as jax_args_to_job
    from tcforge_tpu.cli import build_parser as jax_build_parser
    from tcforge_tpu_torch import cli
    argv = ["-i", "in.vob", "-o", "o.y4m", "-x", "vob=window=64,auto"]
    ours = cli.args_to_job(cli.build_parser().parse_args(argv))
    theirs = jax_args_to_job(jax_build_parser().parse_args(argv))
    assert (ours.im_v_module, ours.im_v_string, ours.im_a_module) == \
        (theirs.im_v_module, theirs.im_v_string, theirs.im_a_module)
    # -a and -T (title[,chapter[-chapter][,angle]]) as the JAX parser
    # sets them
    fields = ("a_track", "dvd_title", "dvd_chapter1", "dvd_chapter2",
              "dvd_angle", "im_v_module")
    for extra in (["-a", "1"], ["-x", "dvd", "-T", "2"],
                  ["-x", "dvd", "-T", "1,3"], ["-T", "1,2-4"],
                  ["-T", "3,,2", "-a", "2"], ["-T", "1,2-,3"]):
        argv = ["-i", "VIDEO_TS", "-o", "o.y4m", *extra]
        ours = cli.args_to_job(cli.build_parser().parse_args(argv))
        theirs = jax_args_to_job(jax_build_parser().parse_args(argv))
        assert ([getattr(ours, f) for f in fields]
                == [getattr(theirs, f) for f in fields]), extra


@pytest.mark.parametrize("what", ["audio_in_not_wav", "audio_out_not_wav",
                                  "module"])
def test_pieces_out_of_this_slice_raise(what, tmp_path):
    """Each names what the port lacks; nothing decodes in silence."""
    src = DATA / "small.mpg"
    job = dict(video_in_file=str(src), video_out_file=str(tmp_path / "o"))
    if what == "audio_in_not_wav":
        # a PVN file: the JAX package's pvn import module, not ported
        pvn = tmp_path / "a.pvn"
        pvn.write_bytes(b"PV5a" + bytes(4096))
        job["audio_in_file"] = str(pvn)
        match = "the pvn import module"
    elif what == "audio_out_not_wav":
        # .mkv: the JAX package's lavf multiplexor, not ported
        job["audio_out_file"] = str(tmp_path / "a.mkv")
        match = "the lavf multiplexor"
    else:
        job["im_v_module"] = "pvn"
        match = "-x pvn"
    with pytest.raises(NotImplementedError, match=match):
        engine.Pipeline(Job(**job), torch.device("cpu"))


def test_prefetch_and_batch_give_the_same_bytes(tmp_path):
    src = DATA / "small.mpg"
    outs = []
    for prefetch, batch in ((1, 1), (4, 16), (2, 5)):
        out = tmp_path / f"o{prefetch}_{batch}.y4m"
        assert port_cli(["-i", str(src), "-o", str(out), "-J",
                         "hqdn3d=luma=4.0", "--prefetch", str(prefetch),
                         "--batch", str(batch)]) == 0
        outs.append(out.read_bytes())
    assert outs[0] == outs[1] == outs[2]


def test_decoded_frames_are_the_chains_input_on_its_device():
    """The importer hands the engine tensors on the device it decodes
    onto, cropped to the display size: no host copy of the frames."""
    imp = importer("synth_odd.m2v")
    plan = imp.plan_batch(3)
    out = imp.execute(plan)
    assert all(isinstance(out[k], torch.Tensor) for k in "yuv")
    assert tuple(out["y"].shape) == (3, 40, 72)
    assert tuple(out["u"].shape) == (3, 20, 36)


@pytest.mark.parametrize("call", ["read_video_batch", "set_references"])
def test_an_importer_given_no_device_decodes_on_the_card(call, monkeypatch):
    """Without ``start``, the importer's entry points decode on the card
    and raise where there is none, as the CLI's ``--device cuda`` does:
    no quiet switch to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    imp = new_module(ModuleKind.DEMULTIPLEXOR, "mpeg", Job(), "")
    imp.open(str(DATA / "small.m2v"))
    args = (4,) if call == "read_video_batch" else (None, None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(imp, call)(*args)
    imp.start(torch.device("cpu"))
    assert imp.read_video_batch(4)["y"].device.type == "cpu"


def test_decoder_state_carries_over_from_the_jax_importer(jax_native):
    """Both importers decode a batch; the port's anchors are then wiped
    and replaced by the JAX importer's (interop), and the next batches
    agree; the port's anchors read back as the JAX importer's."""
    name = "small.m2v"
    jimp = jax_new_module(JKind.DEMULTIPLEXOR, "mpeg", JJob())
    jimp.open(str(DATA / name))
    pimp = importer(name)
    jimp.read_video_batch(4)
    pimp.read_video_batch(4)
    zero = tuple(torch.zeros_like(p) for p in pimp.references()[1])
    pimp.set_references(zero, zero)
    interop.mpeg_refs_from_numpy(pimp, jimp._ref_fwd, jimp._ref_bwd)
    for got, want in zip(interop.mpeg_refs_to_numpy(pimp),
                         (jimp._ref_fwd, jimp._ref_bwd)):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, np.asarray(w))
    while True:
        a, b = jimp.read_video_batch(5), pimp.read_video_batch(5)
        if a is None:
            assert b is None
            break
        for k in "yuv":
            np.testing.assert_array_equal(b[k].numpy(), a[k])


def test_the_parse_library_builds_once_under_its_own_name():
    from tcforge_tpu_torch.ops import _build
    path, _ = _build.build_host("mpeg2intra")
    again, report = _build.build_host("mpeg2intra")
    assert again == path and report == ""
    digest = hashlib.sha256(" ".join(_build.CXX_FLAGS).encode())
    for dep in [_build.CSRC_DIR / "mpeg2intra.cpp",
                _build.CSRC_DIR / "mpeg2tables.h"]:
        digest.update(dep.read_bytes())
    assert path.name == f"libmpeg2intra-{digest.hexdigest()[:16]}.so"
