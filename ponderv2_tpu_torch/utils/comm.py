"""Process identity, object gathering and tensor sums over ``torch.distributed``.

Counterpart of ``ponderv2_tpu/utils/comm.py``. A process that never called
``torch.distributed.init_process_group`` is rank 0 of a world of one, and a
world of one makes no collective call at all.

``all_reduce`` is the sum that SyncBN's statistics go through: unlike
``torch.distributed.all_reduce`` it is differentiable, and its backward
sums the cotangent over the ranks, as the transpose of JAX's ``psum`` does
inside ``shard_map``. Each rank's statistics then get the cotangents of
every rank's loss.
"""

from __future__ import annotations

import os
import random
from typing import Any, List

import torch
import torch.distributed as dist


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def get_world_size() -> int:
    return dist.get_world_size() if _initialized() else 1


def get_rank() -> int:
    return dist.get_rank() if _initialized() else 0


def get_local_rank() -> int:
    """This process's rank on its machine: torchrun's ``LOCAL_RANK``, else
    SLURM's ``SLURM_LOCALID``, else 0."""
    for var in ("LOCAL_RANK", "SLURM_LOCALID"):
        if var in os.environ:
            return int(os.environ[var])
    return 0


def is_main_process() -> bool:
    return get_rank() == 0


def gather(data: Any, dst: int = 0) -> List[Any]:
    """Gather picklable objects onto rank ``dst`` (others receive [])."""
    if get_world_size() == 1:
        return [data]
    out = [None] * get_world_size() if get_rank() == dst else None
    dist.gather_object(data, out, dst=dst)
    return out if get_rank() == dst else []


def all_gather(data: Any) -> List[Any]:
    """All-gather picklable objects across processes."""
    if get_world_size() == 1:
        return [data]
    out = [None] * get_world_size()
    dist.all_gather_object(out, data)
    return out


def shared_random_seed() -> int:
    """A random seed shared by all processes (rank 0's draw wins)."""
    seed = random.SystemRandom().randrange(2 ** 31)
    return int(all_gather(seed)[0])


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


def synchronize() -> None:
    """Barrier across processes (no-op in a world of one)."""
    if get_world_size() > 1:
        dist.barrier()


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        out = x.clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad)
        return grad


def all_reduce(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over all processes, differentiable: the backward
    sums the incoming gradient over the processes too. ``x`` itself in a
    world of one."""
    if get_world_size() == 1:
        return x
    return _AllReduceSum.apply(x)


def all_reduce_(tensors: List[torch.Tensor], op: str = "mean") -> None:
    """In place, without autograd: each tensor becomes its ``mean`` (or with
    ``op="min"`` its minimum) over all processes, in one collective for all
    of them (one dtype and device). Nothing happens in a world of one."""
    world = get_world_size()
    if world == 1 or not tensors:
        return
    flat = torch.cat([t.detach().reshape(-1) for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.MIN if op == "min" else dist.ReduceOp.SUM)
    if op == "mean":
        flat /= world
    start = 0
    for t in tensors:
        t.copy_(flat[start:start + t.numel()].view_as(t))
        start += t.numel()
