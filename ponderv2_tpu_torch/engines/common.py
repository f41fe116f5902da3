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


def plans_to_device(plans, device: torch.device):
    """Host-built ``spunet_plans`` (``engines/plan_prefetch.py``) on
    ``device``: every tensor leaf copied without blocking from its pinned
    memory, the tree's NamedTuples and ``None`` leaves kept."""
    from ..models.sparse_unet.plans import map_tensors

    return map_tensors(plans, lambda t: t.to(device, non_blocking=True))


def with_condition(arrays: Dict[str, Any], static: Dict[str, Any]) -> Dict[str, Any]:
    """``arrays`` plus the batch's ``condition`` (the dataset name an ``Add``
    transform set) when it has one: the first scene's when collated to a
    list, as PPT reads it. The JAX engines drop it with the rest of the
    static half (ROADMAP Queue 3)."""
    cond = static.get("condition")
    if isinstance(cond, (list, tuple)):
        cond = cond[0] if cond else None
    return arrays if cond is None else {**arrays, "condition": cond}


def resolve_device(cfg) -> torch.device:
    """``cfg.device`` when given, else CUDA. Without CUDA an entry point does
    not fall back to the CPU on its own: the caller asks for it."""
    device = cfg.get("device")
    if device:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device=cpu (e.g. --options device=cpu) "
            "to run on the CPU")
    return torch.device("cuda")
