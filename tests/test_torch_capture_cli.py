"""The capture codecs through the port's CLI on the CPU, against the JAX
CLI's bytes (``chip_smoke.CAPTURE_GOLDEN``, their digests pinned in
``chip_smoke.CAPTURE_GOLDEN_SHA256`` for the card's run to check):

- ``-x dv`` on the PAL fixture with ``-m``, on the NTSC one (4:1:1 to
  4:2:0), ``-x auto`` with hqdn3d, the DV's own AAUX track into ``-y
  mpeg2,mp2enc,mpg``; ``-x nuv`` with ``-m`` and ``-y nuvrtj,raw,nuv``:
  both CLIs run here, byte for byte;
- ``-y dv,raw,dv`` with ``-p`` (AAUX injected), the NTSC encode into
  ``-y dv,raw,raw``, and the refusals (NTSC frames and 44.1 kHz audio
  into the ``dv`` multiplexor, a size DV cannot carry): the port's CLI
  against the JAX CLI's pinned digests and exit codes (the JAX DV
  encoder takes seconds a frame; ``tests/data/dv/make_capture_goldens.py``
  remakes the digests);
- ``-L`` and ``--batch`` on a DV input, the ``--dv_*`` flags, the
  registry's new entries.

The JAX CLI runs its in-tree routes (``TCFORGE_NATIVE_DV=1``,
``TCFORGE_NATIVE_DVENC=1``, the in-tree audio encoders) with ``--mesh
off``.
"""

from __future__ import annotations

import hashlib

import pytest

import chip_smoke
from tcforge_tpu import cli as jax_cli
from tcforge_tpu.cli import main as jax_cli_main
from tcforge_tpu_torch import cli as port_cli
from test_torch_audio_encode import in_tree_encoders
from test_torch_engine import run_cli

# the cases whose JAX run encodes DV (seconds a frame): pinned only
PINNED_ONLY = ("dvenc_pal", "dvenc_ntsc", "dv_ntsc_into_dv",
               "dv_44k_into_dv")
CASES = list(chip_smoke.CAPTURE_GOLDEN)
LIVE = [c for c in CASES if c not in PINNED_ONLY]


def sha(path):
    return hashlib.sha256(path.read_bytes()).hexdigest() \
        if path.exists() else None


@pytest.fixture(scope="module")
def golden_runs(tmp_path_factory):
    """Every case in order through the port's CLI on the CPU, and the
    live ones through the JAX CLI: by case, (exit code, digests)."""
    port_dir = tmp_path_factory.mktemp("capture_port")
    jax_dir = tmp_path_factory.mktemp("capture_jax")
    got = {"port": {}, "jax": {}}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TCFORGE_NATIVE_DV", "1")
        mp.setenv("TCFORGE_NATIVE_DVENC", "1")
        for case in CASES:
            rc = run_cli([*chip_smoke.capture_golden_argv(case, port_dir),
                          "--device", "cpu"])
            got["port"][case] = (rc, [sha(f) for f in chip_smoke
                                      .capture_golden_outputs(case,
                                                              port_dir)])
            if case in LIVE:
                with in_tree_encoders():
                    rc = jax_cli_main([*chip_smoke.capture_golden_argv(
                        case, jax_dir), "--mesh", "off"])
                got["jax"][case] = (rc, [sha(f) for f in chip_smoke
                                         .capture_golden_outputs(case,
                                                                 jax_dir)])
    return got


@pytest.mark.parametrize("case", CASES)
def test_the_port_cli_gives_the_pinned_jax_outputs(case, golden_runs):
    rc, digests = golden_runs["port"][case]
    want_rc = chip_smoke.CAPTURE_GOLDEN[case][3]
    assert (rc != 0) == (want_rc != 0)
    assert digests == chip_smoke.CAPTURE_GOLDEN_SHA256[case]


@pytest.mark.parametrize("case", LIVE)
def test_the_port_cli_matches_the_jax_cli(case, golden_runs):
    assert golden_runs["port"][case] == golden_runs["jax"][case]


def test_the_goldens_cover_both_systems_and_both_containers():
    outs = {o for _, _, outs, _ in chip_smoke.CAPTURE_GOLDEN.values()
            for o in outs}
    assert {"o.y4m", "o.wav", "o.dv", "o.nuv", "o.mpg"} <= outs
    assert sum(1 for *_, rc in chip_smoke.CAPTURE_GOLDEN.values() if rc) == 3


@pytest.fixture
def native_dv(monkeypatch):
    monkeypatch.setenv("TCFORGE_NATIVE_DV", "1")
    monkeypatch.setenv("TCFORGE_NATIVE_DVENC", "1")


@pytest.mark.parametrize("args", [
    ["-L", "1"], ["--batch", "1"], ["--max_frames", "1"],
    ["-c", "0.1-0.2"], ["-J", "hqdn3d=luma=4.0", "--batch", "3"]],
    ids=lambda a: " ".join(a))
@pytest.mark.parametrize("name", ("pal.dv", "ntsc.dv"))
def test_engine_flags_on_a_dv_input(name, args, tmp_path, native_dv):
    src = chip_smoke.DV_DATA / name
    outs = {}
    for side, fn, extra in (("jax", jax_cli_main, ["--mesh", "off"]),
                            ("port", run_cli, ["--device", "cpu"])):
        out = tmp_path / f"{side}.y4m"
        rc = fn(["-i", str(src), "-x", "dv", *args, "-o", str(out), "-q",
                 "--progress_off", *extra])
        outs[side] = (rc, sha(out))
    assert outs["port"] == outs["jax"]


@pytest.mark.parametrize("flags", [[], ["--dv_yuy2_mode"], ["--dv_yv12_mode"],
                                   ["--dv_yuy2_mode", "--dv_yv12_mode"]])
def test_the_dv_flags_reach_the_job_as_in_the_jax_cli(flags):
    argv = ["-i", "in.dv", "-o", "out.y4m", *flags]
    jax_job = jax_cli.args_to_job(jax_cli.build_parser().parse_args(argv))
    port_job = port_cli.args_to_job(port_cli.build_parser().parse_args(argv))
    assert port_job.dv_yuy2_mode == jax_job.dv_yuy2_mode


@pytest.mark.parametrize("kind,name", [
    ("DEMULTIPLEXOR", "dv"), ("ENCODER", "dv"), ("MULTIPLEXOR", "dv"),
    ("DEMULTIPLEXOR", "nuv"), ("MULTIPLEXOR", "nuv"), ("ENCODER", "nuvrtj")])
def test_the_registry_has_the_capture_modules(kind, name):
    from tcforge_tpu.modules import registry as jreg
    from tcforge_tpu_torch.modules import registry as treg
    jcls = jreg.lookup(getattr(jreg.ModuleKind, kind), name)
    tcls = treg.lookup(getattr(treg.ModuleKind, kind), name)
    assert tcls.info.name == jcls.info.name
    assert tcls.info.media == jcls.info.media
    assert [p.name for p in tcls.desc.params] == \
        [p.name for p in jcls.desc.params]


def test_33_jax_registry_entries_have_no_port_entry():
    import tcforge_tpu.modules  # noqa: F401
    import tcforge_tpu_torch.modules  # noqa: F401
    from tcforge_tpu.modules import registry as jreg
    from tcforge_tpu_torch.modules import registry as treg
    jax = {(k.value, n) for k, t in jreg._REGISTRIES.items() for n in t}
    port = {(k.value, n) for k, t in treg._REGISTRIES.items() for n in t}
    missing = jax - port
    assert len(missing) == 32
    assert not {("demultiplexor", "dv"), ("encoder", "dv"),
                ("multiplexor", "dv"), ("demultiplexor", "nuv"),
                ("multiplexor", "nuv"), ("encoder", "nuvrtj")} & missing
