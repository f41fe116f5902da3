"""Exact voxel-coordinate keys and sorted-key lookup.

Counterpart of ``ponderv2_tpu/ops/hashing.py`` (``build_table``, ``lookup``).
Keys are int64 ravels ``((b * X + x) * Y + y) * Z + z``, exact for every
spatial shape, so the JAX package's int32 / (hi, lo) pair split is not
needed. Lookups are a binary search (``torch.searchsorted``) over the sorted
key table. The JAX package's dense, packed and bitmap tables exist to cut
TPU gather counts; they give the same answers and are not ported.

Invalid or padding rows carry ``INVALID_KEY`` (int64 max), which sorts last
and never matches a query.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

INVALID_KEY = torch.iinfo(torch.int64).max

# Cell count up to which the JAX package builds its dense membership grid
# (``ponderv2_tpu/ops/hashing.py:DENSE_GRID_LIMIT``). The port never builds
# that grid, but the limit decides which conv plans exist at a level (slab
# ``SubmPlan`` with a band plan, or a plain rulebook), so it is kept to
# mirror the JAX routing.
DENSE_GRID_LIMIT = 192 * 1024 * 1024


def key_fits_int32(spatial_shape: Sequence[int], batch_size: int) -> bool:
    X, Y, Z = spatial_shape
    return batch_size * X * Y * Z < 2**31


def dense_table_fits(spatial_shape: Sequence[int], batch_size: int) -> bool:
    X, Y, Z = (int(s) for s in spatial_shape)
    cells = int(batch_size) * X * Y * Z
    return cells <= DENSE_GRID_LIMIT and key_fits_int32(spatial_shape, batch_size)


def ravel_key(coords: torch.Tensor, spatial_shape: Sequence[int]) -> torch.Tensor:
    """(N, 4) int bxyz -> (N,) int64 key. Rows with any negative coordinate
    or a coordinate outside the spatial shape map to ``INVALID_KEY``."""
    X, Y, Z = (int(s) for s in spatial_shape)
    c = coords.to(torch.int64)
    b, x, y, z = c[:, 0], c[:, 1], c[:, 2], c[:, 3]
    key = ((b * X + x) * Y + y) * Z + z
    valid = (c >= 0).all(dim=1) & (x < X) & (y < Y) & (z < Z)
    return torch.where(valid, key, torch.full_like(key, INVALID_KEY))


class HashTable(NamedTuple):
    """Sorted key table over a fixed-capacity coordinate set."""

    sorted_keys: torch.Tensor  # (N,) int64
    perm: torch.Tensor  # (N,) int32: sorted position -> original row


def build_table(
    coords: torch.Tensor, spatial_shape: Sequence[int], batch_size: int
) -> HashTable:
    """Sorted key table. The sort is stable, so among duplicate coordinates
    the lowest original row answers, as in the JAX package."""
    keys = ravel_key(coords, spatial_shape)
    sorted_keys, order = torch.sort(keys, stable=True)
    return HashTable(sorted_keys, order.to(torch.int32))


def lookup_keys(table: HashTable, keys: torch.Tensor) -> torch.Tensor:
    """Query int64 keys (any shape) against the table -> int32 row or -1."""
    n = table.sorted_keys.shape[0]
    pos = torch.searchsorted(table.sorted_keys, keys)
    pos_c = pos.clamp(0, max(n - 1, 0))
    found = (table.sorted_keys[pos_c] == keys) & (keys != INVALID_KEY) & (pos < n)
    rows = table.perm[pos_c]
    return torch.where(found, rows, torch.full_like(rows, -1))


def lookup(
    table: HashTable, coords: torch.Tensor, spatial_shape: Sequence[int]
) -> torch.Tensor:
    """Query (M, 4) coords against the table -> (M,) int32 row index or -1."""
    return lookup_keys(table, ravel_key(coords, spatial_shape))
