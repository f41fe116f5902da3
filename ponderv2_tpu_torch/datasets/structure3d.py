"""Structured3D semantic-segmentation dataset.

A copy of ``Structured3DDataset`` from ``ponderv2_tpu/datasets/structure3d.py``
with only the import lines changed (see ``transform.py`` for why it is a
copy): rooms as ``{data_root}/{split}/scene_*/room_*/`` directories of one
``.pth`` (or ``.npz``) scene, or as scene files under ``{split}/``. The
RGB-D pretraining variant is not ported yet.
"""

from __future__ import annotations

import glob
import os
from typing import Any, Dict, List

import numpy as np

from .builder import DATASETS
from .defaults import DefaultDataset, load_scene


@DATASETS.register_module()
class Structured3DDataset(DefaultDataset):
    def get_data_list(self) -> List[str]:
        if isinstance(self.split, str):
            splits = [self.split]
        else:
            splits = list(self.split)
        data_list = []
        for split in splits:
            data_list += sorted(
                glob.glob(os.path.join(self.data_root, split, "scene_*/room_*"))
            ) or sorted(glob.glob(os.path.join(self.data_root, split, "*")))
        return data_list

    def get_data(self, idx: int) -> Dict[str, Any]:
        path = self.data_list[idx % len(self.data_list)]
        if os.path.isdir(path):
            files = sorted(glob.glob(os.path.join(path, "*.pth"))) or sorted(
                glob.glob(os.path.join(path, "*.npz"))
            )
            data = load_scene(files[0])
        else:
            data = load_scene(path)
        out = dict(
            coord=np.asarray(data["coord"], np.float32),
            color=np.asarray(
                data.get("color", np.zeros_like(data["coord"])), np.float32
            ),
        )
        if "normal" in data:
            out["normal"] = np.asarray(data["normal"], np.float32)
        for src in ("semantic_gt25", "semantic_gt", "segment"):
            if src in data:
                out["segment"] = np.asarray(data[src]).reshape(-1).astype(np.int64)
                break
        out.setdefault("segment", np.full(out["coord"].shape[0], -1, np.int64))
        out["instance"] = (
            np.asarray(data["instance_gt"]).reshape(-1).astype(np.int64)
            if "instance_gt" in data
            else np.full(out["coord"].shape[0], -1, np.int64)
        )
        return out
