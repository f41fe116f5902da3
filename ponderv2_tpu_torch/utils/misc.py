"""Small utilities: meters and IoU accounting (reference: ``ponder/utils/misc.py``)."""

from __future__ import annotations

import numpy as np
import torch


class AverageMeter:
    """Tracks the latest value, sum, count, and running mean."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


def intersection_and_union(
    output: np.ndarray,
    target: np.ndarray,
    num_classes: int,
    ignore_index: int = -1,
):
    """Histogram intersection/union/target counts per class.

    ``output`` and ``target`` are integer label arrays of the same shape. Pixels whose
    target equals ``ignore_index`` are excluded. Returns
    ``(intersection, union, target_count)`` arrays of length ``num_classes``.
    Reference semantics: ``ponder/utils/misc.py:39-66``.
    """
    output = np.asarray(output).reshape(-1).copy()
    target = np.asarray(target).reshape(-1)
    assert output.shape == target.shape
    output[target == ignore_index] = ignore_index
    intersection = output[output == target]
    area_intersection, _ = np.histogram(
        intersection, bins=np.arange(num_classes + 1)
    )
    area_output, _ = np.histogram(output, bins=np.arange(num_classes + 1))
    area_target, _ = np.histogram(target, bins=np.arange(num_classes + 1))
    area_union = area_output + area_target - area_intersection
    return area_intersection, area_union, area_target


def as_dtype(dtype):
    """A config's compute dtype: None, a ``torch.dtype``, or its name
    (``"bfloat16"``), so configs name it without importing a framework."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    out = getattr(torch, str(dtype), None)
    if not isinstance(out, torch.dtype):
        raise ValueError(f"unknown dtype {dtype!r}")
    return out
