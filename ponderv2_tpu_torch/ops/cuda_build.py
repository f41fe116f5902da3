"""Build the package's CUDA sources with ``nvcc`` at first use, load by ctypes.

Each ``csrc/<name>.cu`` exports a plain C interface and is compiled for
Hopper (``sm_90a``) into ``csrc/_build/lib<name>-<hash>.so``; the hash of
the source, the shared ``csrc/*.cuh`` headers and the flags keys the cache,
so an edited source rebuilds. Several sources build in parallel, one
``nvcc`` each. Nothing here runs at import time, and nothing needs
PyTorch's C++ headers.
"""

from __future__ import annotations

import ctypes
import glob
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


def _lib_path(name: str) -> str:
    digest = hashlib.sha256()
    for path in [os.path.join(CSRC, f"{name}.cu")] + sorted(
            glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(path, "rb") as f:
            digest.update(f.read())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def load_libraries(*names: str) -> Dict[str, ctypes.CDLL]:
    """Compile every ``csrc/<name>.cu`` that has no build of its exact source
    yet, all at once, then load them. Raises with the compiler's output if a
    build fails."""
    pending = {}
    try:
        for name in names:
            out = _lib_path(name)
            if name in _LIBS or os.path.isfile(out) or name in pending:
                continue
            os.makedirs(BUILD_DIR, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            src = os.path.join(CSRC, f"{name}.cu")
            proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                                    stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            pending[name] = (proc, tmp, out)
        failed = []
        for name, (proc, tmp, out) in pending.items():
            BUILD_LOGS[name] = proc.communicate()[0]
            if proc.returncode != 0:
                failed.append(f"nvcc failed on csrc/{name}.cu:\n{BUILD_LOGS[name]}")
            else:
                os.replace(tmp, out)  # atomic: a reader never sees a partial file
        if failed:
            raise RuntimeError("\n".join(failed))
    finally:
        for proc, tmp, _ in pending.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.remove(tmp)
    for name in names:
        if name not in _LIBS:
            _LIBS[name] = ctypes.CDLL(_lib_path(name))
    return {name: _LIBS[name] for name in names}


def load_library(name: str) -> ctypes.CDLL:
    """``load_libraries`` for one source."""
    return load_libraries(name)[name]
