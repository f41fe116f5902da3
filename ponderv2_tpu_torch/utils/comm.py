"""Process identity and object gathering over ``torch.distributed``.

Counterpart of ``ponderv2_tpu/utils/comm.py``. A process that never called
``torch.distributed.init_process_group`` is rank 0 of a world of one.
"""

from __future__ import annotations

from typing import Any, List

import torch.distributed as dist


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def get_world_size() -> int:
    return dist.get_world_size() if _initialized() else 1


def get_rank() -> int:
    return dist.get_rank() if _initialized() else 0


def is_main_process() -> bool:
    return get_rank() == 0


def gather(data: Any, dst: int = 0) -> List[Any]:
    """Gather picklable objects onto rank ``dst`` (others receive [])."""
    if get_world_size() == 1:
        return [data]
    out = [None] * get_world_size() if get_rank() == dst else None
    dist.gather_object(data, out, dst=dst)
    return out if get_rank() == dst else []


def reduce_dict(input_dict: dict, average: bool = True) -> dict:
    """Reduce scalar dict values across processes (mean by default)."""
    world = get_world_size()
    if world == 1:
        return dict(input_dict)
    gathered = [None] * world
    dist.all_gather_object(gathered, input_dict)
    out = {}
    for k in sorted(input_dict.keys()):
        vals = [float(g[k]) for g in gathered]
        out[k] = sum(vals) / world if average else sum(vals)
    return out
