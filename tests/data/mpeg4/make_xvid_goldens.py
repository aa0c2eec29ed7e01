#!/usr/bin/env python3
"""Print the SHA-256 of the JAX CLI's outputs for every MPEG-4 export
golden (``chip_smoke.XVID_GOLDEN``), to pin as
``chip_smoke.XVID_GOLDEN_SHA256``.

    JAX_PLATFORMS=cpu python tests/data/mpeg4/make_xvid_goldens.py [case ...]

The JAX CLI runs with ``TCFORGE_NATIVE_MPEG4ENC=1`` (its in-tree
encoder, not the FFmpeg bridge's libxvid), ``TCFORGE_NATIVE_MPEG4=1``
(its numpy MPEG-4 decoder for an AVI input) and ``--mesh off``, as
``tests/test_torch_xvid.py`` runs it.  The full-width cases (``divxenc``,
``divx``) take a minute or two each on one CPU.
"""

import hashlib
import os
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]
sys.path.insert(0, str(ROOT))
os.environ["TCFORGE_NATIVE_MPEG4ENC"] = "1"
os.environ["TCFORGE_NATIVE_MPEG4"] = "1"

import chip_smoke  # noqa: E402
from tcforge_tpu.cli import main as jax_cli  # noqa: E402


def digests(case: str) -> tuple:
    with tempfile.TemporaryDirectory() as d:
        argv = chip_smoke.xvid_golden_argv(case, d)
        rc = jax_cli([*argv, "--mesh", "off", "-q", "--progress_off"])
        if rc != 0:
            raise SystemExit(f"{case}: the JAX CLI exited {rc}")
        return tuple(hashlib.sha256(f.read_bytes()).hexdigest()
                     for f in chip_smoke.xvid_golden_outputs(case, d))


if __name__ == "__main__":
    for case in sys.argv[1:] or chip_smoke.XVID_GOLDEN:
        print(f'    "{case}": {digests(case)!r},', flush=True)
