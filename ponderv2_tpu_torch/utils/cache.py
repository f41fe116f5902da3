"""Cross-process shared-memory array cache (reference: ``ponder/utils/cache.py:21-57``).

The reference uses the SharedArray package over /dev/shm; here we use the stdlib
``multiprocessing.shared_memory`` with a tiny on-disk manifest so dataloader worker
processes can attach to arrays cached by any other process on the same host.
"""

from __future__ import annotations

import json
import os
from multiprocessing import shared_memory
from typing import Any, Dict

import numpy as np

_MANIFEST_DIR = "/dev/shm/ponderv2_tpu_cache"


def _safe_name(name: str) -> str:
    return "pv2_" + name.replace("/", "_").replace(".", "_")


def _manifest_path(name: str) -> str:
    return os.path.join(_MANIFEST_DIR, _safe_name(name) + ".json")


def shared_array(name: str, var: np.ndarray = None) -> np.ndarray:
    """Create (if ``var`` given and absent) or attach to a named shared array."""
    os.makedirs(_MANIFEST_DIR, exist_ok=True)
    sname = _safe_name(name)
    manifest = _manifest_path(name)
    if not os.path.exists(manifest):
        assert var is not None, f"shared array {name} does not exist"
        var = np.ascontiguousarray(var)
        try:
            shm = shared_memory.SharedMemory(name=sname, create=True, size=var.nbytes)
        except FileExistsError:
            shm = shared_memory.SharedMemory(name=sname)
        arr = np.ndarray(var.shape, dtype=var.dtype, buffer=shm.buf)
        arr[...] = var
        tmp = manifest + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"shape": list(var.shape), "dtype": str(var.dtype)}, f)
        os.replace(tmp, manifest)
        arr.flags.writeable = False
        # keep a reference so the segment outlives this function
        _ATTACHED[sname] = shm
        return arr
    with open(manifest) as f:
        meta = json.load(f)
    shm = shared_memory.SharedMemory(name=sname)
    _ATTACHED[sname] = shm
    arr = np.ndarray(tuple(meta["shape"]), dtype=np.dtype(meta["dtype"]), buffer=shm.buf)
    arr.flags.writeable = False
    return arr


_ATTACHED: Dict[str, shared_memory.SharedMemory] = {}


def shared_dict(name: str, var: Dict[str, Any] = None) -> Dict[str, Any]:
    """Cache/attach a dict of numpy arrays under a common prefix."""
    name = name.replace(os.path.sep, "_")
    if var is not None:
        assert isinstance(var, dict)
        keys = sorted(var.keys())
        shared_array(name + "._keys", np.array([k.encode() for k in keys]))
        return {k: shared_array(f"{name}.{k}", np.asarray(var[k])) for k in keys}
    keys = [k.decode() if isinstance(k, bytes) else str(k)
            for k in shared_array(name + "._keys")]
    return {k: shared_array(f"{name}.{k}") for k in keys}


def exists(name: str) -> bool:
    return os.path.exists(_manifest_path(name + "._keys")) or os.path.exists(
        _manifest_path(name)
    )


def clear(prefix: str = "") -> None:
    """Unlink cached arrays whose name starts with ``prefix``."""
    if not os.path.isdir(_MANIFEST_DIR):
        return
    for fn in os.listdir(_MANIFEST_DIR):
        if not fn.startswith(_safe_name(prefix).rstrip("_")) and prefix:
            continue
        sname = fn[: -len(".json")]
        try:
            shm = shared_memory.SharedMemory(name=sname)
            shm.close()
            shm.unlink()
        except FileNotFoundError:
            pass
        os.remove(os.path.join(_MANIFEST_DIR, fn))
