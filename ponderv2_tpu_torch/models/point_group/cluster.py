"""Instance clustering: radius-graph BFS components on the host.

Counterpart of ``ponderv2_tpu/models/point_group/cluster.py``, with the same
protocol: per point, its in-radius neighbours (strict ``d2 < r2``, itself
included) in ascending index order, cut at ``NEIGHBOR_CAP``; components grow
by BFS through neighbours that share the current point's class, seeded in
ascending index order; components under ``min_points`` are dropped but stay
visited.

``bfs_cluster`` runs the native BFS of ``csrc/cluster.cpp`` (a copy of
``ponderv2_tpu/csrc/cluster.cpp``, byte-equal but for where its header
comment cites the reference), compiled with ``g++`` at first
use into ``csrc/_build/libcluster-<hash>.so`` and loaded by ctypes. A failed
build raises with the compiler's output: there is no silent fallback.
``bfs_cluster_plain`` is the JAX module's numpy BFS, the plain version that
the native one is held against.
"""

from __future__ import annotations

import ctypes
import os
from typing import List, Optional, Tuple

import numpy as np

from ...utils.host_build import CXX_FLAGS, build_library, library_path

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "csrc")
BUILD_DIR = os.path.join(CSRC, "_build")
CPP = os.path.join(CSRC, "cluster.cpp")
# (utils/host_build.py's CXX_FLAGS: -ffp-contract=off keeps each squared
# distance rounded as the numpy plain version rounds it, so the two agree on
# points at the radius)

NEIGHBOR_CAP = 1000  # reference kernel idx_temp[1000]

_NATIVE: Optional[ctypes.CDLL] = None


class _Calls:
    """Calls of the native BFS, counted as the CUDA kernels count their
    launches (``launches``)."""

    launches = 0


NATIVE = _Calls()


def _lib_path() -> str:
    return library_path(CPP, BUILD_DIR, CXX_FLAGS)


def load_native() -> ctypes.CDLL:
    """Build ``csrc/cluster.cpp`` if this source has no build yet, then load
    it. Raises with the compiler's output if the build fails."""
    global _NATIVE
    if _NATIVE is not None:
        return _NATIVE
    out = build_library(CPP, BUILD_DIR, CXX_FLAGS)
    lib = ctypes.CDLL(out)
    lib.ponder_bfs_cluster.restype = ctypes.c_int32
    lib.ponder_bfs_cluster.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int32, ctypes.c_float, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32),
    ]
    _NATIVE = lib
    return lib


def bfs_cluster(
    coords: np.ndarray,
    classes: np.ndarray,
    radius: float = 0.03,
    min_points: int = 50,
) -> Tuple[np.ndarray, int]:
    """Cluster ``coords`` (M, 3) with per-point ``classes`` (M,) into
    instances with the native BFS. Returns (instance_ids (M,), num_instances);
    unclustered points get -1; ids in BFS seed order (ascending first-member
    index)."""
    m = len(coords)
    if m == 0:
        return np.full(0, -1, np.int64), 0
    lib = load_native()
    c = np.ascontiguousarray(coords, np.float32)
    cl = np.ascontiguousarray(classes, np.int32)
    out = np.empty(m, np.int32)
    n_clusters = lib.ponder_bfs_cluster(
        c.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        cl.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int32(m), ctypes.c_float(radius),
        ctypes.c_int32(min_points),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    NATIVE.launches += 1
    return out.astype(np.int64), int(n_clusters)


def bfs_cluster_plain(
    coords: np.ndarray,
    classes: np.ndarray,
    radius: float = 0.03,
    min_points: int = 50,
) -> Tuple[np.ndarray, int]:
    """``bfs_cluster`` in numpy (the JAX module's fallback): the same ids."""
    m = len(coords)
    if m == 0:
        return np.full(0, -1, np.int64), 0

    from scipy.spatial import cKDTree

    tree = cKDTree(coords)
    # index-ordered, capped neighbor lists; strict < via tiny radius shrink is
    # wrong for exactness — filter strictly instead
    raw = tree.query_ball_point(coords, radius)
    nbr = []
    for i, cand in enumerate(raw):
        cand = np.sort(np.asarray(cand, np.int64))
        d2 = np.sum((coords[cand] - coords[i]) ** 2, axis=1)
        cand = cand[d2 < radius * radius]
        nbr.append(cand[:NEIGHBOR_CAP])

    visited = np.zeros(m, bool)
    ids = np.full(m, -1, np.int64)
    next_id = 0
    for seed in range(m):
        if visited[seed]:
            continue
        members = [seed]
        visited[seed] = True
        queue = [seed]
        head = 0
        while head < len(queue):
            cur = queue[head]
            head += 1
            for j in nbr[cur]:
                if visited[j] or classes[j] != classes[cur]:
                    continue
                visited[j] = True
                members.append(j)
                queue.append(j)
        if len(members) >= min_points:
            ids[np.asarray(members)] = next_id
            next_id += 1
    return ids, next_id


def cluster_proposals(
    coords: np.ndarray,
    shifted_coords: np.ndarray,
    classes: np.ndarray,
    valid: np.ndarray,
    radius: float = 0.03,
    min_points: int = 50,
    dual_set: bool = False,
) -> List[np.ndarray]:
    """PointGroup proposal clustering over the bias-shifted coordinates
    (reference clusters ONLY ``center_pred``, point_group_v1m1_base.py:92-131).
    ``dual_set=True`` additionally clusters the original coordinates and
    concatenates both proposal sets — an extension beyond the reference
    protocol, off by default.

    Returns a list of boolean masks over the full point set, in cluster order.
    """
    idx = np.where(valid)[0]
    proposals: List[np.ndarray] = []
    sets = [shifted_coords[idx]] + ([coords[idx]] if dual_set else [])
    for pts in sets:
        ids, n = bfs_cluster(pts, classes[idx], radius=radius, min_points=min_points)
        for k in range(n):
            mask = np.zeros(len(coords), bool)
            mask[idx[ids == k]] = True
            proposals.append(mask)
    return proposals
