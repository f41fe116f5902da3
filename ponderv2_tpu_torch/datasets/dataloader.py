"""Data loaders: torch DataLoader under the hood (CPU-side), emitting padded
numpy batches ready for device transfer.

A copy of ``build_dataloader`` (with ``_worker_init`` and
``_TorchDatasetAdapter``) from ``ponderv2_tpu/datasets/dataloader.py`` with
only the import lines changed (see ``transform.py`` for why it is a copy),
and ``MultiDatasetDataloader``, the round-robin loader of the multi-dataset
pretrain, with the three differences its docstring lists.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import numpy as np

from ..utils.env import derive_seed
from .defaults import ConcatDataset
from .utils import point_collate_fn


def _worker_init(worker_id: int, base_seed: int = 0):
    np.random.seed(derive_seed(base_seed, worker_id))


def build_dataloader(
    dataset,
    batch_size: int = 1,
    num_workers: int = 0,
    shuffle: bool = False,
    drop_last: bool = False,
    point_budget: Optional[int] = None,
    mix_prob: float = 0.0,
    scene_budget: Optional[int] = None,
    seed: int = 0,
    persistent_workers: bool = False,
    num_shards: int = 1,
):
    import torch.utils.data as tud

    return tud.DataLoader(
        _TorchDatasetAdapter(dataset),
        batch_size=batch_size,
        shuffle=shuffle,
        drop_last=drop_last,
        num_workers=num_workers,
        collate_fn=partial(
            point_collate_fn, point_budget=point_budget, mix_prob=mix_prob,
            scene_budget=scene_budget, num_shards=num_shards,
        ),
        worker_init_fn=partial(_worker_init, base_seed=seed),
        persistent_workers=persistent_workers and num_workers > 0,
    )


class _TorchDatasetAdapter:
    """Expose our dataset protocol as a torch map-style dataset."""

    def __init__(self, dataset):
        self.dataset = dataset

    def __getitem__(self, idx):
        return self.dataset[idx]

    def __len__(self):
        return len(self.dataset)


class MultiDatasetDataloader:
    """Round-robin over one ``build_dataloader`` per dataset of a
    ``ConcatDataset``: ``ratio_i`` consecutive batches from dataset i, where
    ``ratio_i`` is the dataset's ``loop``, with every argument and seed of
    ``ponderv2_tpu/datasets/dataloader.py:MultiDatasetDataloader``. Three
    differences, each a fault of the JAX loader (ROADMAP Queue 3):

    (a) Condition (F1). A batch keeps the ``condition`` its scenes' ``Add``
        transform set, collated to a list; only a batch without one gets the
        JAX loader's value, the dataset's ``condition`` attribute or its
        class name. The JAX loader gives every batch the class name, which
        is in no model's ``conditions``, so the model takes condition 0 for
        all of them.
    (b) Epoch loop (F3). The main (first) dataset's ``loop`` is the
        ``ConcatDataset``'s (the config parser's ``epoch // eval_epoch``);
        the others' are 1. The JAX loader sets all of them to 1.
    (c) Epoch end (F2). The epoch ends when the main loader is exhausted at
        its turn, so that ``len()`` is exactly the number of batches
        ``__iter__`` yields: ``(m // r0) * sum(ratios) + m % r0`` for ``m``
        main batches and main ratio ``r0``. The JAX loader stops right after
        the main loader's last batch, before the other datasets' turns of
        that round, while its ``len()`` counts them.
    """

    def __init__(
        self,
        concat_dataset: ConcatDataset,
        batch_size_per_dataset: int,
        num_workers: int = 0,
        point_budget: Optional[int] = None,
        mix_prob: float = 0.0,
        seed: int = 0,
        num_shards: int = 1,
    ):
        self.datasets = concat_dataset.datasets
        self.ratios = [getattr(ds, "loop", 1) for ds in self.datasets]
        if min(self.ratios) < 1:
            raise ValueError(f"every dataset's loop (its batch ratio) must be >= 1: "
                             f"{self.ratios}")
        # the loop was consumed as a ratio; the epoch loop goes to the main one
        for ds in self.datasets:
            ds.loop = 1
        self.datasets[0].loop = getattr(concat_dataset, "loop", 1)
        self.loaders = [
            build_dataloader(
                ds,
                batch_size=batch_size_per_dataset,
                num_workers=num_workers,
                shuffle=True,
                drop_last=True,
                point_budget=point_budget,
                scene_budget=batch_size_per_dataset,
                mix_prob=mix_prob,
                seed=derive_seed(seed, i),
                num_shards=num_shards,
            )
            for i, ds in enumerate(self.datasets)
        ]

    def __iter__(self):
        iters = [iter(ld) for ld in self.loaders]
        main_steps = len(self.loaders[0])
        done_main = 0
        while True:
            for i, ratio in enumerate(self.ratios):
                for _ in range(ratio):
                    if i == 0:
                        if done_main == main_steps:
                            return
                        done_main += 1
                        batch = next(iters[0])
                    else:
                        try:
                            batch = next(iters[i])
                        except StopIteration:
                            iters[i] = iter(self.loaders[i])
                            batch = next(iters[i])
                    batch.setdefault("condition", getattr(
                        self.datasets[i], "condition", type(self.datasets[i]).__name__))
                    yield batch

    def __len__(self):
        main_steps, r0 = len(self.loaders[0]), self.ratios[0]
        return (main_steps // r0) * sum(self.ratios) + main_steps % r0
