"""Data loaders: torch DataLoader under the hood (CPU-side), emitting padded
numpy batches ready for device transfer.

A copy of ``build_dataloader`` (with ``_worker_init`` and
``_TorchDatasetAdapter``) from ``ponderv2_tpu/datasets/dataloader.py`` with
only the import lines changed (see ``transform.py`` for why it is a copy).
``MultiDatasetDataloader`` is not ported yet.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import numpy as np

from ..utils.env import derive_seed
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
