"""The port's host C++ libraries (``csrc/*.cpp``): built with ``g++`` at
first use into ``csrc/_build/`` and loaded by ctypes.

A build is named after a hash of its source and flags, so an edited source
rebuilds, and is written to a temporary file and moved into place, so a
reader never sees a partial library. A failed build raises with the
compiler's output: there is no fallback.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Sequence

# No -march=native: a library is built on whatever host first loads it, and
# a compiler may reject the flag. -ffp-contract=off keeps each floating-point
# expression rounded as written (no fused multiply-add), as the numpy and
# PIL arithmetic the libraries are held against rounds it.
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-ffp-contract=off")


def library_path(cpp: str, build_dir: str, flags: Sequence[str] = CXX_FLAGS) -> str:
    """Where the build of ``cpp`` with ``flags`` lands in ``build_dir``."""
    digest = hashlib.sha256()
    with open(cpp, "rb") as f:
        digest.update(f.read())
    digest.update(" ".join(flags).encode())
    name = os.path.splitext(os.path.basename(cpp))[0]
    return os.path.join(build_dir, f"lib{name}-{digest.hexdigest()[:16]}.so")


def build_library(cpp: str, build_dir: str, flags: Sequence[str] = CXX_FLAGS) -> str:
    """Build ``cpp`` with ``g++`` (or ``$CXX``) unless this source and these
    flags have a build already; returns the library's path."""
    out = library_path(cpp, build_dir, flags)
    if os.path.isfile(out):
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++")
    name = os.path.basename(cpp)
    if not cxx:
        raise RuntimeError(f"no C++ compiler for csrc/{name}: put g++ on PATH or set CXX")
    os.makedirs(build_dir, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
    os.close(fd)
    try:
        proc = subprocess.run([cxx, *flags, "-o", tmp, cpp], capture_output=True, text=True,
                              timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on csrc/{name}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)  # atomic: a reader never sees a partial file
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out
