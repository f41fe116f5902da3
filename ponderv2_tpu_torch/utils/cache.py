"""Cross-process shared-memory array cache, keyed on the run (reference:
``ponder/utils/cache.py:21-57``).

Counterpart of ``ponderv2_tpu/utils/cache.py``: arrays live in stdlib
``multiprocessing.shared_memory`` segments with a small on-disk manifest
each, so dataloader worker processes can attach to arrays that any other
process of the run cached. One difference, a fault of the JAX module
(ROADMAP Queue 3): it keeps every run's manifests in one fixed directory and
names segments only after the caller's name, so two runs on one host whose
data roots share a basename read each other's scenes, and nothing unlinks
them. Here every name lives under a run key (``new_run_key``): the
manifests in a directory of the run's own under the temporary directory
(``tempfile.gettempdir()``, which forked loader workers share), the segments
``pv2_{run}_...``, and ``clear(run=...)`` unlinks all of one run's segments
and removes its directory. Nothing is kept at a fixed path.
"""

from __future__ import annotations

import json
import os
import secrets
import shutil
import tempfile
from multiprocessing import shared_memory
from typing import Any, Dict

import numpy as np

def new_run_key() -> str:
    """A key private to one run: this process's id and 8 random hex digits."""
    return f"{os.getpid()}-{secrets.token_hex(4)}"


def _manifest_dir(run: str) -> str:
    if not run or os.path.sep in run:
        raise ValueError(f"the scene cache needs a run key (new_run_key), got {run!r}")
    return os.path.join(tempfile.gettempdir(), f"ponderv2_tpu_cache-{run}")


def _safe_name(name: str, run: str) -> str:
    return f"pv2_{run}_" + name.replace("/", "_").replace(".", "_")


def _manifest_path(name: str, run: str) -> str:
    return os.path.join(_manifest_dir(run), _safe_name(name, run) + ".json")


def shared_array(name: str, var: np.ndarray = None, *, run: str) -> np.ndarray:
    """Create (if ``var`` given and absent) or attach to the run's named
    shared array."""
    os.makedirs(_manifest_dir(run), exist_ok=True)
    sname = _safe_name(name, run)
    manifest = _manifest_path(name, run)
    if not os.path.exists(manifest):
        if var is None:
            raise FileNotFoundError(f"shared array {name} of run {run} does not exist")
        var = np.ascontiguousarray(var)
        try:
            shm = shared_memory.SharedMemory(name=sname, create=True, size=var.nbytes)
        except FileExistsError:
            shm = _attach(sname)
        arr = np.ndarray(var.shape, dtype=var.dtype, buffer=shm.buf)
        arr[...] = var
        tmp = f"{manifest}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            json.dump({"shape": list(var.shape), "dtype": str(var.dtype)}, f)
        os.replace(tmp, manifest)
        arr.flags.writeable = False
        # keep a reference so the segment outlives this function
        _ATTACHED[sname] = shm
        return arr
    with open(manifest) as f:
        meta = json.load(f)
    shm = _attach(sname)
    _ATTACHED[sname] = shm
    arr = np.ndarray(tuple(meta["shape"]), dtype=np.dtype(meta["dtype"]), buffer=shm.buf)
    arr.flags.writeable = False
    return arr


# this process's mappings, one a segment: arrays returned earlier are views
# of them, so a mapping is never replaced (which would close it under them)
_ATTACHED: Dict[str, shared_memory.SharedMemory] = {}


def _attach(sname: str) -> shared_memory.SharedMemory:
    return _ATTACHED.get(sname) or shared_memory.SharedMemory(name=sname)


def shared_dict(name: str, var: Dict[str, Any] = None, *, run: str) -> Dict[str, Any]:
    """Cache/attach a dict of numpy arrays under a common prefix."""
    name = name.replace(os.path.sep, "_")
    if var is not None:
        assert isinstance(var, dict)
        keys = sorted(var.keys())
        shared_array(name + "._keys", np.array([k.encode() for k in keys]), run=run)
        return {k: shared_array(f"{name}.{k}", np.asarray(var[k]), run=run) for k in keys}
    keys = [k.decode() if isinstance(k, bytes) else str(k)
            for k in shared_array(name + "._keys", run=run)]
    return {k: shared_array(f"{name}.{k}", run=run) for k in keys}


def segments(run: str) -> list:
    """The names of the run's segments in ``/dev/shm``."""
    prefix = _safe_name("", run)
    return sorted(f for f in os.listdir("/dev/shm") if f.startswith(prefix))


def clear(*, run: str) -> None:
    """Unlink every cached array of the run and remove its manifests."""
    mdir = _manifest_dir(run)
    names = set(segments(run))
    if os.path.isdir(mdir):
        names |= {fn[: -len(".json")] for fn in os.listdir(mdir) if fn.endswith(".json")}
    for sname in sorted(names):
        mapped = _ATTACHED.pop(sname, None)
        if mapped is not None:
            try:
                mapped.close()
            except BufferError:  # arrays still view it: it lives on unnamed
                _ATTACHED[sname] = mapped
        try:
            shm = shared_memory.SharedMemory(name=sname)
            shm.close()
            shm.unlink()
        except FileNotFoundError:
            pass
    shutil.rmtree(mdir, ignore_errors=True)
