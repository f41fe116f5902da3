"""Build the package's CUDA sources with ``nvcc`` at first use, load by ctypes.

Each ``csrc/<name>.cu`` exports a plain C interface and is compiled for
Hopper (``sm_90a``) into ``csrc/_build/lib<name>-<hash>.so``; the hash of
the source keys the cache, so an edited source rebuilds. Nothing here runs
at import time, and nothing needs PyTorch's C++ headers.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Dict

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "csrc")
BUILD_DIR = os.path.join(CSRC, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}
BUILD_LOGS: Dict[str, str] = {}  # name -> nvcc output (ptxas register/spill report)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    for cand in (os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None,
                 shutil.which("nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def load_library(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` unless a build of this exact source exists,
    then load it. Raises with the compiler's output if the build fails."""
    if name in _LIBS:
        return _LIBS[name]
    src = os.path.join(CSRC, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    out = os.path.join(BUILD_DIR, f"lib{name}-{digest[:16]}.so")
    if not os.path.isfile(out):
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                                  capture_output=True, text=True)
            BUILD_LOGS[name] = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src}:\n{BUILD_LOGS[name]}")
            os.replace(tmp, out)  # atomic: a reader never sees a partial file
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    _LIBS[name] = ctypes.CDLL(out)
    return _LIBS[name]
