"""Data parallelism over ``torch.distributed``: counterpart of
``ponderv2_tpu/parallel/mesh.py``.

JAX runs one process over a ``data`` mesh of its devices and
``shard_map``s the train step over it; the reference runs one process per
GPU under DDP. The port runs as the reference does (``engines/launch.py``
starts the ranks) and keeps JAX's semantics for the step:

- every rank runs the whole model on its own group of scenes of one global
  batch (``datasets/dataloader.py:build_rank_dataloader``), so sparse conv
  rulebooks stay exact per rank;
- gradients are averaged (DDP's allreduce, ``data_parallel_model``), and so
  are the loss and the ``metric_keys``; ``contract_ok`` is the minimum over
  the ranks (``reduce_metrics``);
- the BN running statistics are averaged after each step
  (``average_bn_stats``), JAX's ``pmean`` of ``batch_stats``: DDP's own
  ``broadcast_buffers`` would copy rank 0's instead, so it is off;
- with ``sync_bn`` the masked BNs take their statistics over all ranks
  (``models/norm.py:bn_sync``);
- parameters and optimizer state are replicated: DDP broadcasts rank 0's
  parameters and buffers when it wraps the model (JAX's ``replicate_state``),
  and every rank then takes the same update.

JAX's ``shard_collate`` and ``shard_batch`` have no function here: a rank
reads and collates only its own group (``datasets/utils.py:
shard_collate_fn``, the slice of ``sharded_collate_fn``'s stacked batch
that JAX's ``shard_batch`` would place on its device).
``engines/train.py:Trainer.run_step`` composes the pieces below into the
step of ``make_sharded_train_step``; a rank's random draws fold in its
rank (``Trainer.step_generator``), as the JAX step folds in the device's
axis index.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch
from torch import nn

from ..utils import comm


def create_mesh(num_devices: Optional[int] = None) -> int:
    """The number of data-parallel ranks: the world size. Refuses a world
    of another size than ``num_devices``, where given, as JAX refuses a
    mesh larger than the devices there are: a rank cannot be left out of
    DDP's collectives."""
    world = comm.get_world_size()
    if num_devices is not None and num_devices != world:
        raise RuntimeError(
            f"create_mesh: {num_devices} data-parallel ranks were asked for and the "
            f"world has {world}; start that many processes (engines/launch.py)")
    return world


class _LossOnly(nn.Module):
    """The model's output with every tensor but ``loss`` detached, so that
    DDP looks for the parameters the loss does not reach from the loss
    alone: a parameter that only another output uses would otherwise be
    waited for in a backward that never reaches it."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, inputs):
        out = self.model(inputs)
        return {k: v.detach() if torch.is_tensor(v) and k != "loss" else v
                for k, v in out.items()}


def data_parallel_model(model: nn.Module) -> nn.Module:
    """``model`` (on its device) under DDP, whose backward averages the
    gradients over the ranks. ``find_unused_parameters``: a step may leave
    parameters without gradients (PDNorm's other conditions, the PPT heads
    of other datasets); a parameter no rank reached keeps no gradient, and
    ``utils/optimizer.py:fill_missing_grads`` gives it zeros, as optax
    updates every leaf. ``broadcast_buffers`` is off: ``average_bn_stats``
    averages the running statistics instead."""
    import inspect

    from torch.nn.parallel import DistributedDataParallel

    # later torch names the per-forward buffer broadcast forward_sync_buffers
    no_buffer_sync = ("forward_sync_buffers" if "forward_sync_buffers" in inspect.signature(
        DistributedDataParallel).parameters else "broadcast_buffers")
    return DistributedDataParallel(_LossOnly(model), find_unused_parameters=True,
                                   **{no_buffer_sync: False})


def bn_stat_buffers(model: nn.Module):
    """The BN running statistics: JAX's ``batch_stats`` collection."""
    return [b for name, b in model.named_buffers()
            if name.rsplit(".", 1)[-1] in ("running_mean", "running_var")]


def average_bn_stats(model: nn.Module) -> None:
    """Each BN running statistic becomes its mean over the ranks."""
    buffers = bn_stat_buffers(model)
    for dtype in sorted({b.dtype for b in buffers}, key=str):  # one order on every rank
        comm.all_reduce_([b for b in buffers if b.dtype == dtype], "mean")


def reduce_metrics(metrics: Dict[str, Any], metric_keys: Sequence[str] = ()) -> Dict[str, Any]:
    """The step's metrics over the ranks: the loss and the ``metric_keys``
    averaged, ``contract_ok`` the minimum (1 only where every rank's plan
    contracts held); others (the lr) as they are."""
    out = dict(metrics)
    keys = ["loss"] + [k for k in metric_keys if k in metrics and k != "loss"]
    values = torch.stack([metrics[k].detach().float().reshape(()) for k in keys])
    comm.all_reduce_([values], "mean")
    out.update(zip(keys, values.unbind()))
    if "contract_ok" in metrics:
        ok = metrics["contract_ok"].detach().float().reshape(1)
        comm.all_reduce_([ok], "min")
        out["contract_ok"] = ok[0]
    return out
