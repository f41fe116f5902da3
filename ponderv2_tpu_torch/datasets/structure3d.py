"""Structured3D datasets.

``Structured3DDataset`` is ``ponderv2_tpu/datasets/structure3d.py``'s with
one change: its room list skips the ``room_*_rgbd`` view folders, which the
JAX list takes for rooms (ROADMAP Queue 3). Rooms are
``{data_root}/{split}/scene_*/room_*.pth`` files (as
``preprocess_structured3d.py`` writes them) or ``room_*/`` directories of
one ``.pth`` (or ``.npz``) scene, else scene files under ``{split}/``.
``Structured3DRGBDDataset`` (the RGB-D pretraining variant) takes its rooms
from that list and each room's views from ``room_*_rgbd/``.
"""

from __future__ import annotations

import glob
import os
from typing import Any, Dict, List

import numpy as np

from .builder import DATASETS
from .defaults import DefaultDataset, load_scene
from .s3dis import RGBDViews


@DATASETS.register_module()
class Structured3DDataset(DefaultDataset):
    def get_data_list(self) -> List[str]:
        if isinstance(self.split, str):
            splits = [self.split]
        else:
            splits = list(self.split)
        data_list = []
        for split in splits:
            data_list += [p for p in (
                sorted(glob.glob(os.path.join(self.data_root, split, "scene_*/room_*")))
                or sorted(glob.glob(os.path.join(self.data_root, split, "*"))))
                if not p.endswith("_rgbd")]
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


@DATASETS.register_module()
class Structured3DRGBDDataset(RGBDViews, Structured3DDataset):
    """``Structured3DDataset``'s rooms that have views under
    ``room_*_rgbd/``, read as ``s3dis.py:read_rgbd_views`` reads them; the
    preprocessor's depth is in mm
    (``preprocess_structured3d.py:Structured3DReader.read_depth``). The JAX
    dataset lists ``{split}/*`` instead, which finds no room in the
    preprocessor's layout, and applies a ``depth_mask`` only from the scene
    dict (ROADMAP Queue 3)."""

    depth_scale = 1000.0
