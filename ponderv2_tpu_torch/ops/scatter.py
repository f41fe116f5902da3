"""Segment reductions with static segment counts.

Counterpart of ``ponderv2_tpu/ops/scatter.py``: out-of-range and negative
segment ids go to a dump row ``num_segments`` that is allocated and then
dropped, so padding rows never reach a real segment. ``initial`` replaces
the value of an empty segment in ``segment_max``/``segment_min``.

The sums run in a fixed order on every device (``ordered_scatter_add``), so
a step on the GPU gives the same bits run to run, as the JAX step does.
"""

from __future__ import annotations

from typing import Optional

import torch


def _clean_ids(segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    bad = (segment_ids < 0) | (segment_ids >= num_segments)
    return torch.where(bad, num_segments, segment_ids).to(torch.int64)


def sum_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype sums of ``dtype`` values run in: f32 for bf16 and f32 (as
    the kernels sum), f64 for f64 (a float64 reference run of the plain
    versions)."""
    return torch.promote_types(dtype, torch.float32)


# rows bound for no output row are spread over this many dump rows: on CUDA
# the ordered sum handles one destination's rows in turn, so a single dump
# row taking every padding row would serialize them
DUMP_ROWS = 4096


def ordered_scatter_add(out: torch.Tensor, index: torch.Tensor,
                        values: torch.Tensor) -> torch.Tensor:
    """``out[index[e]] += values[e]`` out of place, each destination row's
    values added one after the other in the order of e, on either device:
    on the CPU by ``index_add`` (a serial loop over e); on CUDA by
    ``index_put`` with ``accumulate``, which sorts the destinations stably
    and sums each one's values in turn, with no atomics. (``index_add_`` on
    CUDA adds with atomics, in whatever order the threads reach a row, and
    ``index_put`` with ``accumulate`` on the CPU with parallel atomics, so
    their bits vary run to run.) Differentiable in ``values``: the backward
    is the gather ``grad[index]``."""
    index = index.to(torch.int64)
    if out.device.type == "cpu":
        return out.index_add(0, index, values)
    return out.index_put((index,), values, accumulate=True)


def dump_ids(ids: torch.Tensor, dead: torch.Tensor, num_rows: int) -> torch.Tensor:
    """``ids`` with the ``dead`` rows sent to ``DUMP_ROWS`` dump rows past
    ``num_rows`` (row ``num_rows + e % DUMP_ROWS`` for row e)."""
    spread = num_rows + torch.arange(ids.shape[0], device=ids.device) % DUMP_ROWS
    return torch.where(dead, spread, ids.to(torch.int64))


def _segment_total(data, segment_ids, num_segments):
    bad = (segment_ids < 0) | (segment_ids >= num_segments)
    ids = dump_ids(segment_ids, bad, num_segments)
    out = data.new_zeros((num_segments + DUMP_ROWS, *data.shape[1:]))
    return ordered_scatter_add(out, ids, data)[:num_segments], ids


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    return _segment_total(data, segment_ids, num_segments)[0]


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    total, ids = _segment_total(data, segment_ids, num_segments)
    # integer counts: exact in any order
    count = torch.bincount(ids, minlength=num_segments + DUMP_ROWS)[:num_segments]
    count = count.clamp(min=1).to(data.dtype)
    return total / (count[:, None] if data.dim() > 1 else count)


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


class _OrderedGather(torch.autograd.Function):
    """``data[index]`` whose backward adds the grads into each row in a fixed
    order (``ordered_scatter_add``): the backward of plain indexing is an
    ``index_add_`` with atomics on CUDA, whose bits vary run to run."""

    @staticmethod
    def forward(ctx, data, index):
        flat = index.reshape(-1).to(torch.int64)
        ctx.save_for_backward(flat)
        ctx.rows, ctx.index_shape = data.shape[0], index.shape
        return data.index_select(0, flat).reshape(*index.shape, *data.shape[1:])

    @staticmethod
    def backward(ctx, grad):
        (flat,) = ctx.saved_tensors
        grad = grad.reshape(flat.shape[0], *grad.shape[len(ctx.index_shape):])
        out = grad.new_zeros((ctx.rows, *grad.shape[1:]))
        return ordered_scatter_add(out, flat, grad), None


def ordered_gather(data: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``data[index]`` along the first axis (negative indices count from the
    end, as in numpy and JAX), differentiable in ``data`` with a fixed-order
    backward (``_OrderedGather``)."""
    index = torch.where(index < 0, index + data.shape[0], index)
    return _OrderedGather.apply(data, index)
