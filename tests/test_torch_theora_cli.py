"""Theora through the port's CLI on the CPU, against the JAX CLI's bytes
(``chip_smoke.THEORA_GOLDEN``, their digests pinned in
``chip_smoke.THEORA_GOLDEN_SHA256`` for the card's run to check):

- ``-y theora,vorbis,ogg`` on an interlaced clip with ``-p``, ``-I 5`` and
  hqdn3d (the ``ogg`` multiplexor's Theora logical stream beside Vorbis),
  and that OGV read back through ``-x ogg`` with ``-m``;
- ``-y theora,raw,avi`` (the ``theo`` fourcc) and ``-N theora``;
- the 4:2:2 and 4:4:4 fixtures decoded to Y4M, where the JAX importer
  keeps the top-left quarter or half of the chroma (its 4:2:0 crop);
- the registry's ``theora`` encoder entry.

The JAX CLI runs its in-tree routes (``TCFORGE_NATIVE_THEORAENC=1``,
``TCFORGE_NATIVE_THEORA=1``, ``TCFORGE_NATIVE_THEORA_TOKENS=0``, the
in-tree audio encoders) with ``--mesh off``.
"""

from __future__ import annotations

import hashlib

import pytest

import chip_smoke
from tcforge_tpu.cli import main as jax_cli_main
from test_torch_audio_encode import in_tree_encoders
from test_torch_engine import run_cli

CASES = list(chip_smoke.THEORA_GOLDEN)


def sha(path):
    return hashlib.sha256(path.read_bytes()).hexdigest() \
        if path.exists() else None


@pytest.fixture(scope="module")
def golden_runs(tmp_path_factory):
    """Every case in order through both CLIs: by side and case, (exit
    code, digests)."""
    got = {"port": {}, "jax": {}, "dir": {}}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TCFORGE_NATIVE_THEORAENC", "1")
        mp.setenv("TCFORGE_NATIVE_THEORA", "1")
        mp.setenv("TCFORGE_NATIVE_THEORA_TOKENS", "0")
        for side in ("port", "jax"):
            d = tmp_path_factory.mktemp(f"theora_{side}")
            got["dir"][side] = d
            for case in CASES:
                argv = chip_smoke.theora_golden_argv(case, d)
                if side == "port":
                    rc = run_cli([*argv, "--device", "cpu"])
                else:
                    with in_tree_encoders():
                        rc = jax_cli_main([*argv, "--mesh", "off"])
                got[side][case] = (rc, [
                    sha(f) for f in chip_smoke.theora_golden_outputs(case, d)])
    return got


@pytest.mark.parametrize("case", CASES)
def test_the_port_cli_gives_the_pinned_jax_outputs(case, golden_runs):
    rc, digests = golden_runs["port"][case]
    assert rc == chip_smoke.THEORA_GOLDEN[case][3]
    assert digests == chip_smoke.THEORA_GOLDEN_SHA256[case]


@pytest.mark.parametrize("case", CASES)
def test_the_port_cli_matches_the_jax_cli(case, golden_runs):
    assert golden_runs["port"][case] == golden_runs["jax"][case]


def test_the_ogv_holds_a_theora_and_a_vorbis_stream(golden_runs):
    from tcforge_tpu_torch.io.ogg import identify_streams
    with open(golden_runs["dir"]["port"] / "o.ogv", "rb") as f:
        streams = [(s.kind, s.codec, s.width, s.height)
                   for s in identify_streams(f)]
    assert streams == [("video", "theora", 176, 144),
                       ("audio", "vorbis", 0, 0)]


def test_the_avi_carries_the_theo_fourcc(golden_runs):
    from tcforge_tpu_torch.io.avi import AviReader
    with AviReader(str(golden_runs["dir"]["port"] / "o.avi")) as r:
        assert (r.video.fourcc, r.video_frames) == ("theo", 6)


def test_the_registry_has_the_theora_encoder():
    from tcforge_tpu.modules import registry as jreg
    from tcforge_tpu_torch.modules import registry as treg
    jcls = jreg.lookup(jreg.ModuleKind.ENCODER, "theora")
    tcls = treg.lookup(treg.ModuleKind.ENCODER, "theora")
    assert (tcls.info.name, tcls.info.media) == (jcls.info.name,
                                                 jcls.info.media)
    assert [(p.name, p.default, p.lo, p.hi) for p in tcls.desc.params] == \
        [(p.name, p.default, p.lo, p.hi) for p in jcls.desc.params]
