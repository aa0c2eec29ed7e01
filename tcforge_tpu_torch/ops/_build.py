"""Build the CUDA and C++ sources under ``csrc/`` at first use and load them.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared
library with a plain C interface, which ``ctypes`` loads: no PyTorch
headers, so a build takes seconds.  A host library (``csrc/<name>.cpp``,
the MPEG-2 parse) compiles with ``g++`` the same way, also where there is
no card.  A library lands in ``_build/`` (listed in ``.gitignore``) under
a name that carries a hash of the sources and flags, so an edited source
never meets a stale library; it is written to a temporary file and moved
into place, so processes that build at once never load a half-written
one.  Nothing is downloaded; only the sources in the package are
compiled, and a failed build raises.
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
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")


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


def _digest(src: Path, flags, headers: str) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for dep in [src] + sorted(CSRC_DIR.glob(headers)):
        h.update(dep.read_bytes())
    return h.hexdigest()[:16]


def _compile(src: Path, command, flags, headers: str) -> Tuple[Path, str]:
    """Compile ``src`` into ``_build/`` unless an up-to-date library
    exists: the library's path and the compiler's report."""
    if not src.exists():
        raise FileNotFoundError(src)
    out = BUILD_DIR / f"lib{src.stem}-{_digest(src, flags, headers)}.so"
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [command, *flags, "-I", str(CSRC_DIR), "-o", tmp, str(src)],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{Path(command).name} failed on {src.name}:"
                               f"\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out, proc.stdout + proc.stderr


def build(name: str) -> Tuple[Path, str]:
    """Build ``csrc/<name>.cu`` unless an up-to-date library exists.

    Returns the library's path and the compiler's report (registers,
    shared memory, spills), which is empty when nothing was built."""
    return _compile(CSRC_DIR / f"{name}.cu", nvcc(), NVCC_FLAGS, "*.cuh")


def build_host(name: str) -> Tuple[Path, str]:
    """Build the host library ``csrc/<name>.cpp`` with ``g++`` unless an
    up-to-date one exists; its path and the compiler's report."""
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the MPEG-2 parse of "
                           "tcforge_tpu_torch needs a C++ compiler")
    return _compile(CSRC_DIR / f"{name}.cpp", cxx, CXX_FLAGS, "*.h")


@lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    return ctypes.CDLL(str(build(name)[0]))


@lru_cache(maxsize=None)
def load_host(name: str) -> ctypes.CDLL:
    """The loaded host library of ``csrc/<name>.cpp``, built at first
    use."""
    return ctypes.CDLL(str(build_host(name)[0]))
