"""SyntheticDataset: procedurally generated scenes, no disk assets.

A copy of ``SyntheticDataset`` from ``ponderv2_tpu/datasets/defaults.py``
with only the import lines changed (see ``transform.py`` for why it is a
copy).
"""

from __future__ import annotations

from copy import deepcopy
from typing import Dict, List, Optional

import numpy as np

from .builder import DATASETS
from .transform import TRANSFORMS, Compose



@DATASETS.register_module()
class SyntheticDataset:
    """Procedurally generated scenes for tests/benchmarks (no disk assets).

    Generates deterministic per-index random rooms: a floor/wall shell plus
    box-shaped "furniture", with colors, normals, and semantic labels — enough
    structure to exercise the whole pipeline.
    """

    def __init__(
        self,
        num_scenes: int = 8,
        points_per_scene: int = 20000,
        num_classes: int = 20,
        transform: Optional[List[dict]] = None,
        test_mode: bool = False,
        test_cfg: Optional[dict] = None,
        loop: int = 1,
        seed: int = 0,
    ):
        self.num_scenes = num_scenes
        self.points_per_scene = points_per_scene
        self.num_classes = num_classes
        self.transform = Compose(transform or [])
        self.test_mode = test_mode
        self.loop = loop
        self.seed = seed
        if test_mode:
            tc = test_cfg or {}
            self.test_voxelize = (
                TRANSFORMS.build(tc["voxelize"]) if tc.get("voxelize") else None
            )
            self.test_crop = None
            self.post_transform = Compose(tc.get("post_transform", []))
            self.aug_transform = [Compose(a) for a in tc.get("aug_transform", [[]])]

    def make_scene(self, idx: int) -> Dict[str, np.ndarray]:
        rng = np.random.RandomState(self.seed + idx % self.num_scenes)
        n = self.points_per_scene
        n_floor = n // 4
        n_wall = n // 4
        n_obj = n - n_floor - n_wall
        room = rng.uniform(3.0, 8.0, 2)
        floor = np.stack(
            [rng.uniform(0, room[0], n_floor), rng.uniform(0, room[1], n_floor),
             np.abs(rng.randn(n_floor)) * 0.02], axis=1)
        side = rng.randint(0, 2, n_wall)
        wall = np.stack(
            [np.where(side, rng.uniform(0, room[0], n_wall), 0.0),
             np.where(side, 0.0, rng.uniform(0, room[1], n_wall)),
             rng.uniform(0, 2.8, n_wall)], axis=1)
        n_boxes = rng.randint(3, 8)
        obj_pts, obj_lbl = [], []
        for b in range(n_boxes):
            cnt = n_obj // n_boxes
            center = np.array([rng.uniform(0.5, room[0] - 0.5),
                               rng.uniform(0.5, room[1] - 0.5),
                               rng.uniform(0.2, 1.2)])
            size = rng.uniform(0.2, 1.0, 3)
            obj_pts.append(center + (rng.rand(cnt, 3) - 0.5) * size)
            obj_lbl.append(np.full(cnt, 2 + (b % (self.num_classes - 2))))
        obj = np.concatenate(obj_pts)
        coord = np.concatenate([floor, wall, obj]).astype(np.float32)
        segment = np.concatenate(
            [np.zeros(n_floor), np.ones(n_wall), np.concatenate(obj_lbl)]
        ).astype(np.int64)
        m = len(coord)
        color = (rng.rand(m, 3) * 255).astype(np.float32)
        normal = rng.randn(m, 3).astype(np.float32)
        normal /= np.linalg.norm(normal, axis=1, keepdims=True) + 1e-9
        instance = np.full(m, -1, dtype=np.int64)
        return dict(coord=coord, color=color, normal=normal, segment=segment,
                    instance=instance)

    def get_data_name(self, idx: int) -> str:
        return f"synthetic_{idx % self.num_scenes}"

    def __getitem__(self, idx):
        data = self.make_scene(idx)
        if self.test_mode:
            segment = data.pop("segment")
            data = self.transform(data)
            result = dict(name=self.get_data_name(idx), segment=segment)
            fragment_list = []
            for aug in self.aug_transform:
                d = aug(deepcopy(data))
                if self.test_voxelize is not None:
                    parts = self.test_voxelize(d)["fragment_list"]
                else:
                    d["index"] = np.arange(d["coord"].shape[0])
                    parts = [d]
                fragment_list += [self.post_transform(p) for p in parts]
            result["fragment_list"] = fragment_list
            return result
        return self.transform(data)

    def __len__(self):
        return self.num_scenes * self.loop
