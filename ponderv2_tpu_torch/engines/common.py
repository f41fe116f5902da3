"""Shared engine helpers (counterpart of ``ponderv2_tpu/engines/common.py``)."""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def _is_array(v) -> bool:
    return (isinstance(v, np.ndarray) and v.dtype != object) or isinstance(
        v, torch.Tensor)


def split_batch(batch: Dict[str, Any]):
    """Split a collated batch into (arrays, static/host context)."""
    arrays, static = {}, {}
    for k, v in batch.items():
        (arrays if _is_array(v) else static)[k] = v
    return arrays, static
