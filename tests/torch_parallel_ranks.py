"""Rank bodies of the data-parallel CPU tests (``tests/test_torch_parallel*.py``).

``ponderv2_tpu_torch/engines/launch.py`` spawns them with gloo on the CPU.
A spawned process imports the module of the function it runs, so this
module imports the port and never JAX (the test modules import both).
Each body reads its job from its argument and writes what it saw to
``{out}/rank{r}.pt`` for the test to read.
"""

from __future__ import annotations

import copy
import os

import numpy as np
import torch

from ponderv2_tpu_torch.datasets.builder import DATASETS
from ponderv2_tpu_torch.datasets.defaults import SyntheticDataset

THREADS_PER_RANK = 1  # 6 xdist workers x 2 ranks on the host's cores


@DATASETS.register_module(force=True)
class PinnedSyntheticDataset(SyntheticDataset):
    """``SyntheticDataset`` whose scene i takes its augmentation draws from
    ``np.random`` seeded with (seed, i), in whichever process or rank reads
    it, so that a split val set gives the same scenes as a whole one."""

    def __getitem__(self, idx):
        state = np.random.get_state()
        np.random.seed([self.seed, idx])
        try:
            return super().__getitem__(idx)
        finally:
            np.random.set_state(state)


def _rank_setup():
    from ponderv2_tpu_torch.utils import comm

    torch.set_num_threads(THREADS_PER_RANK)
    return comm.get_rank(), comm.get_world_size()


def _save(job, rank, result):
    torch.save(result, os.path.join(job["out"], f"rank{rank}.pt"))


def launch_record(job):
    """What ``launch`` gave this process: its rank, world, local rank,
    backend and device, and the seed the ranks share."""
    import torch.distributed as dist

    from ponderv2_tpu_torch.utils import comm

    rank, world = _rank_setup()
    return dict(rank=rank, world=world, local_rank=comm.get_local_rank(),
                backend=dist.get_backend(), device=job["device"],
                seed=comm.shared_random_seed())


def record_rank(job):
    """``launch_record``, written for the test."""
    _save(job, _rank_setup()[0], launch_record(job))


def syncbn_rank(job):
    """For each of ``job["cases"]``, a ``MaskedBatchNorm`` (or
    ``PDBatchNorm``) forward under ``bn_sync`` on this rank's rows and the
    backward of ``sum(y * cot)``: the output, the moved running statistics
    and the grads of x and the parameters."""
    from ponderv2_tpu_torch.models.norm import bn_sync

    rank, _ = _rank_setup()
    seen = []
    for case in job["cases"]:
        # a copy: spawn hands every rank the same shared-memory tensors
        layer = copy.deepcopy(case["layer"])
        layer.train()
        x = torch.from_numpy(case["x"][rank]).requires_grad_()
        mask = torch.from_numpy(case["mask"][rank])
        with bn_sync(job["sync"]):
            y = layer(x, mask, *case["extra"])
        (y * torch.from_numpy(case["cot"][rank])).sum().backward()
        seen.append(dict(
            y=y.detach(), x_grad=x.grad,
            grads={n: p.grad.clone() for n, p in layer.named_parameters()
                   if p.grad is not None},
            buffers={n: b.clone() for n, b in layer.named_buffers()}))
    _save(job, rank, seen)


def dp_step_rank(job):
    """``Trainer`` (the data-parallel branch) from ``job["state"]``: for each
    of ``job["batches"]`` (a list per step of every rank's batch) one
    ``run_step`` on this rank's batch. Records each step's synced metrics,
    the grads the optimizer stepped with, the BN statistics before the
    ranks averaged them, the generator's first draws, the state after;
    with ``job["evaluate"]`` then ``SemSegEvaluator`` over the rank's share
    of the val set."""
    from ponderv2_tpu_torch.engines import train as engine
    from ponderv2_tpu_torch.engines.hooks.evaluator import SemSegEvaluator
    from ponderv2_tpu_torch.parallel import mesh
    from ponderv2_tpu_torch.utils.events import EventStorage
    from ponderv2_tpu_torch.utils.scheduler import build_scheduler

    rank, world = _rank_setup()
    launched = launch_record(job)
    cfg = job["cfg"]
    trainer = engine.TRAINERS.build(dict(type=cfg.get("train_type", "Trainer"), cfg=cfg))
    trainer.model.load_state_dict(job["state"])
    if "total_steps" in job:
        trainer.schedule = build_scheduler(dict(cfg.scheduler), job["total_steps"])
    seen = dict(launched, metrics=[], grads=[], local_stats=[],
                draws=torch.rand(4, generator=trainer.step_generator()),
                static_ctx=dict(trainer.static_ctx), val_ctx=dict(trainer.val_static_ctx))

    step = trainer.optimizer.step

    def recorded_step(*args, **kwargs):
        seen["grads"].append({n: p.grad.detach().clone()
                              for n, p in trainer.model.named_parameters()})
        return step(*args, **kwargs)

    trainer.optimizer.step = recorded_step
    average = engine.average_bn_stats

    def recorded_average(model):
        seen["local_stats"].append({n: b.clone() for n, b in model.named_buffers()
                                    if "running" in n})
        average(model)

    engine.average_bn_stats = recorded_average
    try:
        for batches in job["batches"]:
            trainer.comm_info["input_dict"] = batches[rank]
            trainer.run_step()
            seen["metrics"].append(trainer.sync_metrics())
    finally:
        engine.average_bn_stats = average
    seen["state"] = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    seen["ddp"] = type(trainer.step_model).__name__
    seen["cache_run"] = trainer.cache_run
    seen["bn_buffers"] = len(mesh.bn_stat_buffers(trainer.model))
    if job.get("evaluate"):
        evaluator = SemSegEvaluator()
        evaluator.trainer = trainer
        with EventStorage() as trainer.storage:
            evaluator.eval()
            seen["val"] = {k: v for k, (v, _) in trainer.storage.latest().items()
                           if k.startswith("val/")}
        seen["val_scenes"] = len(trainer.val_loader.dataset)
    _save(job, rank, seen)


def rank_loader_rank(job):
    """The first batches of this rank's train loader as ``Trainer`` builds it
    (``MultiDatasetTrainer``'s too), with each batch's ``condition``."""
    from ponderv2_tpu_torch.engines import train as engine

    rank, _ = _rank_setup()
    trainer = engine.TRAINERS.build(dict(type=job["cfg"].get("train_type", "Trainer"),
                                         cfg=job["cfg"]))
    batches = []
    for i, batch in enumerate(trainer.train_loader):
        if i == job["batches"]:
            break
        batches.append(batch)
    _save(job, rank, dict(batches=batches, length=len(trainer.train_loader)))


def spawn(body, job, tmp_path, nprocs=2, **launch_kwargs):
    """Run ``body(job)`` on ``nprocs`` gloo ranks on the CPU; returns each
    rank's record."""
    from ponderv2_tpu_torch.engines.launch import launch

    out = os.path.join(str(tmp_path), body.__name__)
    os.makedirs(out, exist_ok=True)
    job = dict(job, out=out, device="cpu")
    launch(body, num_gpus_per_machine=nprocs, cfg=(job,), **launch_kwargs)
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(nprocs)]


def np_tree(batch):
    """The numpy arrays of a collated batch (the rest dropped)."""
    return {k: v for k, v in batch.items() if isinstance(v, np.ndarray)}
