#!/usr/bin/env python3
"""Print the digests that ``chip_smoke.py`` pins for Theora:
``THEORA_GOLDEN_SHA256`` (every ``THEORA_GOLDEN`` case through the JAX
CLI, which the port's CLI on the CPU must equal), ``THEORA_INPUT_SHA256``
(the ogv path's OGV from the JAX CLI) and ``THEORA_CPU_SHA256`` (the
ogv_dec path's programme stream and the fixtures' Y4M decodes from the
port's CLI with --device cpu, each checked against the JAX CLI on the same
files).

    JAX_PLATFORMS=cpu python tests/data/theora/make_goldens.py [--paths]

The JAX CLI runs its in-tree routes: ``TCFORGE_NATIVE_THEORAENC=1`` and
``TCFORGE_NATIVE_THEORA=1`` (the encoder and decoder, not the FFmpeg
bridge) with ``TCFORGE_NATIVE_THEORA_TOKENS=0`` (the Python token path,
not the native one), ``TCFORGE_NATIVE_MP2ENC=1`` and the other audio
encoders' switches (``tests/test_torch_audio_encode.py``
``in_tree_encoders``), with ``--mesh off``.  The cases take about a
minute; ``--paths`` runs the full-width paths instead, whose JAX runs
take several minutes (its encoder and decoder take seconds a 720p frame).
"""

import hashlib
import os
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))
for name in ("TCFORGE_NATIVE_THEORAENC", "TCFORGE_NATIVE_THEORA"):
    os.environ[name] = "1"
os.environ["TCFORGE_NATIVE_THEORA_TOKENS"] = "0"

import chip_smoke  # noqa: E402
from tcforge_tpu.cli import main as jax_cli  # noqa: E402
from tcforge_tpu_torch import cli as port_cli  # noqa: E402
from test_torch_audio_encode import in_tree_encoders  # noqa: E402


def sha(path: Path):
    return hashlib.sha256(path.read_bytes()).hexdigest() if path.exists() \
        else None


def cases() -> None:
    with tempfile.TemporaryDirectory() as jd, \
            tempfile.TemporaryDirectory() as td:
        for case in chip_smoke.THEORA_GOLDEN:
            want_rc = chip_smoke.THEORA_GOLDEN[case][3]
            with in_tree_encoders():
                jrc = jax_cli([*chip_smoke.theora_golden_argv(case, jd),
                               "--mesh", "off"])
            trc = port_cli.main([*chip_smoke.theora_golden_argv(case, td),
                                 "--device", "cpu"])
            j = [sha(f) for f in chip_smoke.theora_golden_outputs(case, jd)]
            t = [sha(f) for f in chip_smoke.theora_golden_outputs(case, td)]
            if (jrc != 0) != (want_rc != 0) or (trc != 0) != (jrc != 0) \
                    or j != t:
                raise SystemExit(f"{case}: JAX rc {jrc} {j}, port rc {trc} "
                                 f"{t}")
            print(f'    "{case}": {j!r},', flush=True)


def paths() -> None:
    with tempfile.TemporaryDirectory() as jd, \
            tempfile.TemporaryDirectory() as td:
        jd, td = Path(jd), Path(td)
        for d in (jd, td):
            chip_smoke.theora_inputs(d)
        for name, out in chip_smoke.theora_outputs():
            port, jax = td / out, jd / out
            rc = port_cli.main([*chip_smoke.theora_argv(name, td, port),
                                "--device", "cpu"])
            with in_tree_encoders():
                jrc = jax_cli([*chip_smoke.theora_argv(name, jd, jax),
                               "--mesh", "off"])
            if rc != 0 or jrc != 0 or sha(port) != sha(jax):
                raise SystemExit(f"{name}: port rc {rc} {sha(port)}, JAX rc "
                                 f"{jrc} {sha(jax)}")
            print(f'    "{name}": "{sha(port)}",', flush=True)


if __name__ == "__main__":
    if "--paths" in sys.argv[1:]:
        paths()
    else:
        cases()
