#!/usr/bin/env python3
"""Print the digests that ``chip_smoke.py`` pins for the capture codecs:
``CAPTURE_GOLDEN_SHA256`` (every ``CAPTURE_GOLDEN`` case through the JAX
CLI, which the port's CLI on the CPU must equal), and
``CAPTURE_INPUT_SHA256`` and ``CAPTURE_CPU_SHA256`` (the dv, dvenc, nuv
and nuvrtj paths' inputs and outputs from the port's CLI with --device
cpu, each checked against the JAX CLI on the same files).

    JAX_PLATFORMS=cpu python tests/data/dv/make_capture_goldens.py \
        [--paths [dv dvenc nuv nuvrtj]]

The JAX CLI runs its in-tree routes: ``TCFORGE_NATIVE_DV=1`` and
``TCFORGE_NATIVE_DVENC=1`` (the DV decoder and encoder, not the FFmpeg
bridge), ``TCFORGE_NATIVE_MPEG4ENC=1``, and the audio encoders' switches
with the MP3 encoder's empty table 0 (``tests/test_torch_audio_encode.py``
``in_tree_encoders``), with ``--mesh off``.  The cases take about a
minute; ``--paths`` runs the full-width paths instead, whose JAX runs
take several minutes (the DV encoder alone takes seconds a frame).
"""

import hashlib
import os
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))
for name in ("TCFORGE_NATIVE_DV", "TCFORGE_NATIVE_DVENC",
             "TCFORGE_NATIVE_MPEG4ENC", "TCFORGE_NATIVE_MPEG4"):
    os.environ[name] = "1"

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
        for case in chip_smoke.CAPTURE_GOLDEN:
            want_rc = chip_smoke.CAPTURE_GOLDEN[case][3]
            with in_tree_encoders():
                jrc = jax_cli([*chip_smoke.capture_golden_argv(case, jd),
                               "--mesh", "off"])
            trc = port_cli.main([*chip_smoke.capture_golden_argv(case, td),
                                 "--device", "cpu"])
            j = [sha(f) for f in chip_smoke.capture_golden_outputs(case, jd)]
            t = [sha(f) for f in chip_smoke.capture_golden_outputs(case, td)]
            if (jrc != 0) != (want_rc != 0) or (trc != 0) != (jrc != 0) \
                    or j != t:
                raise SystemExit(f"{case}: JAX rc {jrc} {j}, port rc {trc} "
                                 f"{t}")
            print(f'    "{case}": {j!r},', flush=True)


def paths(names) -> None:
    from tcforge_tpu_torch.ops import kernels
    with tempfile.TemporaryDirectory() as d:
        d = Path(d)
        inputs = chip_smoke.capture_inputs(port_cli, kernels, d, "cpu")
        got = {"camcorder.dv": sha(inputs["clip"]),
               "capture.nuv": sha(inputs["nuv"])}
        # the inputs as the JAX encoders write them
        for key, argv in (
                ("camcorder.dv", ["-i", str(d / "camcorder.y4m"), "-p",
                                  str(d / "camcorder.wav"), "-y",
                                  "dv,raw,dv"]),
                ("capture.nuv", ["-i", str(d / "capture.y4m"), "-p",
                                 str(d / "capture.wav"), "-y",
                                 "nuvrtj,raw,nuv"])):
            out = d / f"jax_{key}"
            with in_tree_encoders():
                rc = jax_cli([*argv, "-o", str(out), "--mesh", "off", "-q",
                              "--progress_off"])
            if rc != 0 or sha(out) != got[key]:
                raise SystemExit(f"{key}: the JAX CLI's differs")
        print("CAPTURE_INPUT_SHA256 =", got, flush=True)
        for name, suffix in (("dvenc", "dv"), ("nuvrtj", "nuv"), ("dv", "mpg"),
                             ("nuv", "avi")):
            if names and name not in names:
                continue
            port = d / f"port_{name}.{suffix}"
            rc = port_cli.main([*chip_smoke.capture_argv(name, inputs, port),
                                "--device", "cpu"])
            jax = d / f"jax_{name}.{suffix}"
            with in_tree_encoders():
                jrc = jax_cli([*chip_smoke.capture_argv(name, inputs, jax),
                               "--mesh", "off"])
            if rc != 0 or jrc != 0 or sha(port) != sha(jax):
                raise SystemExit(f"{name}: port rc {rc} {sha(port)}, JAX rc "
                                 f"{jrc} {sha(jax)}")
            print(f'    "{name}": "{sha(port)}",', flush=True)


if __name__ == "__main__":
    if "--paths" in sys.argv[1:]:
        paths([a for a in sys.argv[1:] if a != "--paths"])
    else:
        cases()
