"""ScanNet / ScanNet200 semantic-segmentation datasets.

Copies of ``VALID_CLASS_IDS_20``, ``CLASS_NAMES_20``, ``ScanNetDataset`` and
``ScanNet200Dataset`` from ``ponderv2_tpu/datasets/scannet.py`` with only
the import lines changed (see ``transform.py`` for why they are copies).
Scenes are preprocessed ``.pth`` dicts under ``{data_root}/{split}/``:
``coord``/``color``/``normal`` and ``semantic_gt20`` / ``semantic_gt200`` /
``instance_gt``. The RGB-D pretraining variant is not ported yet.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

import numpy as np

from .builder import DATASETS
from .defaults import DefaultDataset, load_scene

VALID_CLASS_IDS_20 = (
    1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24, 28, 33, 34, 36, 39,
)

CLASS_NAMES_20 = (
    "wall", "floor", "cabinet", "bed", "chair", "sofa", "table", "door",
    "window", "bookshelf", "picture", "counter", "desk", "curtain",
    "refrigerator", "shower curtain", "toilet", "sink", "bathtub",
    "otherfurniture",
)


@DATASETS.register_module()
class ScanNetDataset(DefaultDataset):
    class2id = np.array(VALID_CLASS_IDS_20)

    def __init__(
        self,
        lr_file: Optional[str] = None,
        la_file: Optional[str] = None,
        **kwargs,
    ):
        self.lr = np.loadtxt(lr_file, dtype=str) if lr_file is not None else None
        self.la = (
            __import__("torch").load(la_file) if la_file is not None else None
        )
        super().__init__(**kwargs)

    def get_data_list(self) -> List[str]:
        if self.lr is not None:
            return [
                os.path.join(self.data_root, "train", name + ".pth")
                for name in self.lr
            ]
        return super().get_data_list()

    def get_data(self, idx: int) -> Dict[str, Any]:
        data = super().get_data(idx)
        out = dict(
            coord=np.asarray(data["coord"], np.float32),
            color=np.asarray(data.get("color", np.zeros_like(data["coord"])),
                             np.float32),
            normal=np.asarray(data.get("normal", np.zeros_like(data["coord"])),
                              np.float32),
        )
        if "semantic_gt20" in data:
            out["segment"] = np.asarray(data["semantic_gt20"]).reshape(-1).astype(np.int64)
        else:
            out["segment"] = np.full(out["coord"].shape[0], -1, np.int64)
        if "instance_gt" in data:
            out["instance"] = np.asarray(data["instance_gt"]).reshape(-1).astype(np.int64)
        else:
            out["instance"] = np.full(out["coord"].shape[0], -1, np.int64)
        if self.la is not None:
            # data-efficient limited-annotation: mask all but the listed points
            name = self.get_data_name(idx)
            sampled = self.la[name]
            mask = np.ones_like(out["segment"], bool)
            mask[sampled] = False
            out["segment"][mask] = -1
        return out


@DATASETS.register_module()
class ScanNet200Dataset(ScanNetDataset):
    def get_data(self, idx: int) -> Dict[str, Any]:
        data = load_scene(self.data_list[idx % len(self.data_list)])
        out = dict(
            coord=np.asarray(data["coord"], np.float32),
            color=np.asarray(data.get("color", np.zeros_like(data["coord"])),
                             np.float32),
            normal=np.asarray(data.get("normal", np.zeros_like(data["coord"])),
                              np.float32),
        )
        key = "semantic_gt200" if "semantic_gt200" in data else "segment"
        out["segment"] = (
            np.asarray(data[key]).reshape(-1).astype(np.int64)
            if key in data
            else np.full(out["coord"].shape[0], -1, np.int64)
        )
        out["instance"] = (
            np.asarray(data["instance_gt"]).reshape(-1).astype(np.int64)
            if "instance_gt" in data
            else np.full(out["coord"].shape[0], -1, np.int64)
        )
        return out
