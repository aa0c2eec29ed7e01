"""Build the CUDA sources under ``csrc/`` at first use and load them.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared
library with a plain C interface, which ``ctypes`` loads: no PyTorch
headers, so a build takes seconds.  The library lands in ``_build/``
(listed in ``.gitignore``) under a name that carries a hash of the
sources and flags, so an edited source never meets a stale library.
Nothing is downloaded; only the sources in the package are compiled.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from functools import lru_cache
from pathlib import Path
from typing import Tuple

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    """Path of the CUDA compiler; raises if the toolkit is absent."""
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels of "
                       "tcforge_tpu_torch need the CUDA toolkit")


def _digest(src: Path) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for dep in [src] + sorted(CSRC_DIR.glob("*.cuh")):
        h.update(dep.read_bytes())
    return h.hexdigest()[:16]


def build(name: str) -> Tuple[Path, str]:
    """Build ``csrc/<name>.cu`` unless an up-to-date library exists.

    Returns the library's path and the compiler's report (registers,
    shared memory, spills), which is empty when nothing was built."""
    src = CSRC_DIR / f"{name}.cu"
    if not src.exists():
        raise FileNotFoundError(src)
    out = BUILD_DIR / f"lib{name}-{_digest(src)}.so"
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [nvcc(), *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", tmp, str(src)],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name}:\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out, proc.stdout + proc.stderr


@lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    return ctypes.CDLL(str(build(name)[0]))
