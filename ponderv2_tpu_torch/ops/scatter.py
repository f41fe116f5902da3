"""Segment reductions with static segment counts.

Counterpart of ``ponderv2_tpu/ops/scatter.py``: out-of-range and negative
segment ids go to a dump row ``num_segments`` that is allocated and then
dropped, so padding rows never reach a real segment. ``initial`` replaces
the value of an empty segment in ``segment_max``/``segment_min``.
"""

from __future__ import annotations

from typing import Optional

import torch


def _clean_ids(segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    bad = (segment_ids < 0) | (segment_ids >= num_segments)
    return torch.where(bad, num_segments, segment_ids).to(torch.int64)


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    ids = _clean_ids(segment_ids, num_segments)
    out = data.new_zeros((num_segments + 1, *data.shape[1:]))
    return out.index_add(0, ids, data)[:num_segments]


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    ids = _clean_ids(segment_ids, num_segments)
    total = data.new_zeros((num_segments + 1, *data.shape[1:])).index_add(0, ids, data)
    count = data.new_zeros(num_segments + 1).index_add(
        0, ids, data.new_ones(data.shape[0]))
    count = count.clamp(min=1.0)
    out = total / (count[:, None] if data.dim() > 1 else count)
    return out[:num_segments]


def _segment_extreme(data, segment_ids, num_segments, initial, reduce):
    ids = _clean_ids(segment_ids, num_segments)
    fill = float("-inf") if reduce == "amax" else float("inf")
    out = data.new_full((num_segments + 1, *data.shape[1:]), fill)
    index = ids.reshape(-1, *([1] * (data.dim() - 1))).expand_as(data)
    out = out.scatter_reduce(0, index, data, reduce=reduce, include_self=True)
    if initial is not None:
        out = torch.where(out == fill, torch.full_like(out, initial), out)
    return out[:num_segments]


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int, initial: Optional[float] = None) -> torch.Tensor:
    return _segment_extreme(data, segment_ids, num_segments, initial, "amax")


def segment_min(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int, initial: Optional[float] = None) -> torch.Tensor:
    return _segment_extreme(data, segment_ids, num_segments, initial, "amin")
