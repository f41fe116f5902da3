"""SparseTensor: fixed-capacity batched sparse voxel tensors, and voxel set ops.

Counterpart of ``ponderv2_tpu/ops/sparse.py``: a padded ``(capacity, C)``
feature buffer plus ``(capacity, 4)`` int32 ``(b, x, y, z)`` coordinates.
Padding rows have coords ``(-1, -1, -1, -1)`` and zero features; every op
keeps that invariant. ``voxel_pool``, ``to_dense``, ``offset2batch`` and
``batch2offset`` sum in a fixed order (``ops/scatter.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import torch

from . import hashing
from .scatter import ordered_scatter_add, segment_mean, segment_sum


@dataclasses.dataclass(frozen=True)
class SparseTensor:
    features: torch.Tensor  # (N, C) float
    coords: torch.Tensor  # (N, 4) int32 (b, x, y, z); padding rows all -1
    spatial_shape: Tuple[int, int, int]
    batch_size: int

    @property
    def mask(self) -> torch.Tensor:
        return self.coords[:, 0] >= 0

    @property
    def capacity(self) -> int:
        return self.features.shape[0]

    def replace(self, **changes) -> "SparseTensor":
        return dataclasses.replace(self, **changes)

    def replace_features(self, features: torch.Tensor) -> "SparseTensor":
        """Swap the feature buffer, re-zeroing padding rows."""
        return self.replace(features=torch.where(
            self.mask[:, None], features, torch.zeros_like(features)))


def make_sparse_tensor(
    features: torch.Tensor,
    coords: torch.Tensor,
    spatial_shape: Sequence[int],
    batch_size: int,
) -> SparseTensor:
    coords = coords.to(torch.int32)
    mask = coords[:, 0] >= 0
    coords = torch.where(mask[:, None], coords, torch.full_like(coords, -1))
    features = torch.where(mask[:, None], features, torch.zeros_like(features))
    return SparseTensor(
        features=features,
        coords=coords,
        spatial_shape=tuple(int(s) for s in spatial_shape),
        batch_size=int(batch_size),
    )


def unique_voxels(
    coords: torch.Tensor,
    spatial_shape: Sequence[int],
    batch_size: int,
    capacity: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Deduplicate (N, 4) voxel coords into a fixed-capacity unique set.

    Returns ``(unique_coords (capacity, 4) int32 padded with -1, inverse (N,)
    int32 mapping each input row to its unique id (``capacity`` for padding
    or overflow rows), count () int32 number of unique voxels)``.

    Unique voxels come out in ascending key order; beyond ``capacity`` the
    largest keys are dropped and their inverse ids point at ``capacity``.
    """
    n = coords.shape[0]
    dev = coords.device
    keys = hashing.ravel_key(coords, spatial_shape)
    s_keys, order = torch.sort(keys, stable=True)
    first = torch.ones(n, dtype=torch.bool, device=dev)
    first[1:] = s_keys[1:] != s_keys[:-1]
    valid = s_keys != hashing.INVALID_KEY
    is_new = first & valid
    uid_sorted = torch.cumsum(is_new.to(torch.int32), 0, dtype=torch.int32) - 1
    count = is_new.sum().to(torch.int32)
    dump = torch.full_like(uid_sorted, capacity)
    uid_sorted = torch.where(valid & (uid_sorted < capacity), uid_sorted, dump)

    # representative (first occurrence) coords per unique id; row
    # ``capacity`` is the dump slot for repeats and overflow
    scatter_ids = torch.where(is_new, uid_sorted, dump).to(torch.int64)
    unique_coords = torch.full((capacity + 1, 4), -1, dtype=torch.int32, device=dev)
    unique_coords[scatter_ids] = coords.to(torch.int32)[order]
    inverse = torch.empty(n, dtype=torch.int32, device=dev)
    inverse[order] = uid_sorted
    return unique_coords[:capacity], inverse, count.clamp(max=capacity)


def voxel_pool(
    features: torch.Tensor,
    coords: torch.Tensor,
    spatial_shape: Sequence[int],
    batch_size: int,
    capacity: int,
    reduce: str = "mean",
) -> Tuple[SparseTensor, torch.Tensor]:
    """Pool point/voxel features into unique voxels (mean by default).
    Returns the pooled SparseTensor and the (N,) inverse map (input row ->
    voxel id, ``capacity`` for dropped rows)."""
    unique_coords, inverse, _ = unique_voxels(coords, spatial_shape, batch_size, capacity)
    if reduce == "mean":
        pooled = segment_mean(features, inverse, capacity)
    elif reduce == "sum":
        pooled = segment_sum(features, inverse, capacity)
    else:
        raise ValueError(f"unsupported reduce: {reduce}")
    return make_sparse_tensor(pooled, unique_coords, spatial_shape, batch_size), inverse


def to_dense(st: SparseTensor, channels_last: bool = False) -> torch.Tensor:
    """Densify to (B, C, X, Y, Z) (or (B, X, Y, Z, C)); padding rows are
    dropped and rows on one voxel add up (spconv's ``dense()``)."""
    X, Y, Z = st.spatial_shape
    B, C = st.batch_size, st.features.shape[1]
    c = st.coords.to(torch.int64)
    idx = ((c[:, 0] * X + c[:, 1]) * Y + c[:, 2]) * Z + c[:, 3]
    idx = torch.where(st.mask, idx, B * X * Y * Z)
    flat = st.features.new_zeros((B * X * Y * Z + 1, C))
    flat = ordered_scatter_add(flat, idx, st.features)
    dense = flat[:-1].reshape(B, X, Y, Z, C)
    return dense if channels_last else dense.permute(0, 4, 1, 2, 3)


def offset2batch(offset: torch.Tensor, total: int) -> torch.Tensor:
    """Cumulative ``offset`` (B,) -> per-row batch ids (total,) int32; rows
    past ``offset[-1]`` get -1 (padding)."""
    row = torch.arange(total, device=offset.device)
    batch = (row[:, None] >= offset[None, :]).sum(1)
    return torch.where(row < offset[-1], batch, -1).to(torch.int32)


def batch2offset(batch: torch.Tensor, batch_size: int) -> torch.Tensor:
    """Per-row batch ids -> cumulative offsets (batch_size,) int32; ids
    outside [0, batch_size) count for no scene."""
    counts = segment_sum(torch.ones_like(batch, dtype=torch.int32), batch, batch_size)
    return torch.cumsum(counts, 0, dtype=torch.int32)


def maybe_sort_by_key(st: SparseTensor, assume_sorted: bool = False):
    """``sort_by_key`` unless the data pipeline already guarantees the order
    (``datasets.utils.collate_fn`` sorts rows by (batch, voxel key)).
    Returns (st, None) then; callers treat ``inverse=None`` as the identity."""
    if assume_sorted:
        return st, None
    return sort_by_key(st)


def sort_by_key(st: SparseTensor) -> Tuple[SparseTensor, torch.Tensor]:
    """Sort rows by spatial key (padding last). Returns (sorted_st,
    inverse_perm); ``out_unsorted = out_sorted[inverse_perm]``."""
    keys = hashing.ravel_key(st.coords, st.spatial_shape)
    perm = torch.sort(keys, stable=True).indices
    inverse = torch.empty_like(perm)
    inverse[perm] = torch.arange(perm.shape[0], device=perm.device)
    sorted_st = st.replace(features=st.features[perm], coords=st.coords[perm])
    return sorted_st, inverse
