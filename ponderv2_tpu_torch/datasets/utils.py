"""Collation: variable-size scenes -> fixed-capacity padded batches.

A copy of ``collate_fn`` from ``ponderv2_tpu/datasets/utils.py`` (see
``transform.py`` for why it is a copy), and its train-loader alias
``point_collate_fn`` with the single-shard branch only (the sharded collate
belongs to the data-parallel trainer, not ported yet). Rows come out sorted
by (batch, voxel key), padding last.

One difference, a fault of the JAX function (ROADMAP Queue 3, F14): the
``origin_*`` keys (the original points that ``Copy`` keeps for projecting
labels back onto them) are a point set of their own. They are concatenated
in scene order with no padding, no sort and no Mix3D merge, and
``origin_batch`` / ``origin_offset`` give their scenes. The JAX function
pads and sorts them as voxel rows when their length happens to equal the
voxels', and makes no ``origin_batch``, so its evaluator cannot project.
"""

from __future__ import annotations

import random
from collections.abc import Mapping
from typing import Any, Dict, List, Optional

import numpy as np


_INT_PAD_KEYS = {"segment", "instance", "category", "index"}  # pad ignore -1
_COORD_PAD_KEYS = {"grid_coord"}  # pad with -1 (invalid voxel)


def _n_points(scene: Mapping) -> int:
    for key in ("coord", "grid_coord", "feat"):
        if key in scene:
            return scene[key].shape[0]
    raise KeyError("scene has no point-dim key (coord/grid_coord/feat)")


def collate_fn(
    batch: List[Mapping],
    point_budget: Optional[int] = None,
    mix_prob: float = 0.0,
    scene_budget: Optional[int] = None,
) -> Dict[str, Any]:
    """``scene_budget`` fixes the scene dimension too: per-scene stacked arrays are
    zero-padded to that many scenes (padding scenes own no points, so they are
    inert downstream) — keeping every array shape static even when over-budget
    scenes get dropped."""
    assert len(batch) > 0
    sizes = [_n_points(s) for s in batch]

    if point_budget is not None:
        # drop trailing scenes that overflow the budget (keep at least one)
        keep, total = [], 0
        for i, n in enumerate(sizes):
            if keep and total + n > point_budget:
                break
            keep.append(i)
            total += n
        batch = [batch[i] for i in keep]
        sizes = sizes[: len(keep)]
        if sizes and sizes[0] > point_budget:
            # single over-budget scene: truncate (should be prevented upstream)
            batch0 = {
                k: (v[:point_budget] if isinstance(v, np.ndarray) and v.ndim >= 1
                    and v.shape[0] == sizes[0] and not k.startswith("origin_") else v)
                for k, v in batch[0].items()
            }
            batch = [batch0] + list(batch[1:])
            sizes[0] = point_budget

    total = sum(sizes)
    budget = point_budget if point_budget is not None else total
    pad = budget - total
    batch_size = len(batch)

    out: Dict[str, Any] = {}
    point_keys = []
    keys = [k for k in batch[0].keys() if not k.startswith("origin_")]
    for key in keys:
        vals = [s[key] for s in batch]
        v0 = vals[0]
        if isinstance(v0, np.ndarray) and v0.ndim >= 1 and v0.shape[0] == sizes[0]:
            point_keys.append(key)
            cat = np.concatenate(vals, axis=0)
            if pad > 0:
                if key in _INT_PAD_KEYS:
                    fill = np.full((pad, *cat.shape[1:]), -1, dtype=cat.dtype)
                elif key in _COORD_PAD_KEYS:
                    fill = np.full((pad, *cat.shape[1:]), -1, dtype=cat.dtype)
                else:
                    fill = np.zeros((pad, *cat.shape[1:]), dtype=cat.dtype)
                cat = np.concatenate([cat, fill], axis=0)
            out[key] = cat
        elif key == "offset":
            continue  # recomputed below
        elif isinstance(v0, np.ndarray):
            stacked = np.stack(vals, axis=0)
            if scene_budget is not None and stacked.shape[0] < scene_budget:
                fill = np.zeros(
                    (scene_budget - stacked.shape[0], *stacked.shape[1:]),
                    dtype=stacked.dtype,
                )
                stacked = np.concatenate([stacked, fill], axis=0)
            out[key] = stacked
        else:
            out[key] = vals

    batch_ids = np.concatenate(
        [np.full(n, i, dtype=np.int32) for i, n in enumerate(sizes)]
        + ([np.full(pad, -1, dtype=np.int32)] if pad > 0 else [])
    )

    if mix_prob > 0 and batch_size > 1 and random.random() < mix_prob:
        # Mix3D: merge scene pairs (0,1), (2,3), ... into single scenes
        merged = batch_ids.copy()
        merged[batch_ids >= 0] = batch_ids[batch_ids >= 0] // 2
        batch_ids = merged

    if "grid_coord" in out:
        # pre-sort rows by (batch, voxel ravel key), padding last — the
        # lexicographic (b, x, y, z) order equals the device-side ravel-key
        # order for ANY spatial_shape, so models built with
        # ``assume_sorted=True`` skip the per-step device argsort +
        # un-permute gather (ops.sparse.sort_by_key) entirely. Host cost:
        # one np.lexsort per batch, overlapped with device compute.
        g = out["grid_coord"]
        b64 = batch_ids.astype(np.int64)
        b_key = np.where(b64 < 0, np.iinfo(np.int64).max, b64)
        perm = np.lexsort((g[:, 2], g[:, 1], g[:, 0], b_key))
        for key in point_keys:
            out[key] = out[key][perm]
        batch_ids = batch_ids[perm]

    out["batch"] = batch_ids
    out["offset"] = np.cumsum(np.asarray(sizes, dtype=np.int64))
    out["batch_size"] = scene_budget if scene_budget is not None else batch_size
    if "origin_coord" in batch[0]:
        out.update(_collate_origin(batch))
    return out


def _collate_origin(batch: List[Mapping]) -> Dict[str, Any]:
    """The scenes' ``origin_*`` point arrays concatenated in scene order (no
    padding, no sort, no Mix3D merge), their ``origin_batch`` ids and
    cumulative ``origin_offset``; each scene counts its ``origin_coord``'s
    points, and every other ``origin_*`` array must hold as many."""
    counts = [len(s["origin_coord"]) for s in batch]
    out: Dict[str, Any] = {}
    for key in batch[0]:
        if key.startswith("origin_") and key != "origin_offset":
            vals = [np.asarray(s[key]) for s in batch]
            if [len(v) for v in vals] != counts:
                raise ValueError(f"{key}: {[len(v) for v in vals]} points for the "
                                 f"scenes' {counts} original points")
            out[key] = np.concatenate(vals, axis=0)
    out["origin_batch"] = np.concatenate(
        [np.full(n, i, dtype=np.int32) for i, n in enumerate(counts)])
    out["origin_offset"] = np.cumsum(np.asarray(counts, dtype=np.int64))
    return out


def point_collate_fn(batch, point_budget=None, mix_prob=0.0, scene_budget=None,
                     num_shards=1):
    """Reference-named alias used by train loaders."""
    if num_shards > 1:
        raise NotImplementedError("sharded collate (num_shards > 1) is not ported")
    return collate_fn(
        batch, point_budget=point_budget, mix_prob=mix_prob, scene_budget=scene_budget
    )
