"""Build and load the port's CUDA C++ kernels (``ops/csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, at its first use, and loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false -std=c++17
         -shared -Xcompiler -fPIC -Xptxas -v -o lib<name>_<hash>.so <name>.cu

The library goes into ``ops/_build/`` (listed in ``.gitignore``), named by a
hash of the source and the flags, so an edited source builds anew and an
unchanged one is loaded from the last build.  ``ptxas``'s report (registers,
shared memory, spills) is kept beside it as ``.log``.  A missing ``nvcc`` or
a failed build raises: there is no fallback.  Nothing here runs at import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Dict

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "--fmad=false", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """``nvcc`` on the PATH, else the CUDA toolkit's default location."""
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("deep3dmap_tpu_torch: nvcc not found (PATH or "
                       "/usr/local/cuda/bin); the CUDA kernels are built from "
                       "ops/csrc at first use and need the CUDA toolkit")


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless its hashed library exists; returns
    the library's path.  Raises ``RuntimeError`` with nvcc's output if the
    build fails."""
    with open(os.path.join(CSRC, f"{name}.cu"), "rb") as f:
        src = f.read()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    so = os.path.join(BUILD_DIR, f"lib{name}_{key}.so")
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC, f"{name}.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}) building "
                               f"{name}.cu:\n{' '.join(cmd)}\n{proc.stdout}"
                               f"{proc.stderr}")
        with open(so[:-3] + ".log", "w") as f:
            f.write(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        os.replace(tmp, so)   # atomic: a concurrent build sees all or nothing
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return so


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    if name not in _loaded:
        _loaded[name] = ctypes.CDLL(build(name))
    return _loaded[name]
