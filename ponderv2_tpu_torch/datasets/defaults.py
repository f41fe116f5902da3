"""Dataset bases: DefaultDataset / ConcatDataset over scene files, and
SyntheticDataset / SyntheticRGBDDataset (procedurally generated scenes,
with RGB-D views for pretraining; no disk assets).

Copies of ``load_scene``, ``DefaultDataset``, ``ConcatDataset``,
``SyntheticDataset``, ``_lookat_world2cam`` and ``SyntheticRGBDDataset``
from ``ponderv2_tpu/datasets/defaults.py`` with only the import lines
changed (see ``transform.py`` for why they are copies), but for the scene
cache's key (ROADMAP Queue 3): with ``cache`` the JAX ``get_data`` names a
scene ``ponderv2-{basename(data_root)}-{basename(path)}`` in one host-wide
namespace, so two runs whose data roots share a basename read each other's
scenes. Here a scene is named after its full data root, under the dataset's
``cache_run`` key (``utils/cache.py``), which only the trainer sets, to its
own (``set_cache_run``), and unlinks after training; with ``cache`` and no
key, ``get_data`` raises. Scenes are dicts of
numpy arrays (``coord``, ``color``, ``normal``, ``segment``, ...) in
``.pth`` (torch pickles of numpy arrays), ``.npz`` or ``.npy`` files.
"""

from __future__ import annotations

import glob
import hashlib
import os
from copy import deepcopy
from typing import Any, Dict, List, Optional

import numpy as np

from ..utils.cache import shared_dict
from ..utils.logger import get_root_logger
from .builder import DATASETS, build_dataset
from .transform import TRANSFORMS, Compose


def load_scene(path: str) -> Dict[str, np.ndarray]:
    if path.endswith(".npz"):
        return dict(np.load(path, allow_pickle=True))
    if path.endswith(".npy"):
        return np.load(path, allow_pickle=True).item()
    # .pth: torch pickle of a dict of numpy arrays
    import torch

    data = torch.load(path, map_location="cpu", weights_only=False)
    return {
        k: (v.numpy() if hasattr(v, "numpy") else v) for k, v in data.items()
    }


def scene_cache_name(data_root: str, path: str) -> str:
    """A scene's name in the run's cache: a digest of its data root's
    absolute path, and its file name."""
    root = hashlib.sha1(os.path.abspath(data_root).encode()).hexdigest()[:12]
    return f"ponderv2-{root}-{os.path.basename(path)}"


def set_cache_run(dataset, run: str) -> None:
    """Give ``dataset`` and the datasets it holds (``ConcatDataset``) the
    cache key ``run``."""
    if getattr(dataset, "cache", False):
        dataset.cache_run = run
    for inner in getattr(dataset, "datasets", ()):
        set_cache_run(inner, run)


@DATASETS.register_module()
class DefaultDataset:
    def __init__(
        self,
        split: str = "train",
        data_root: str = "data/dataset",
        transform: Optional[List[dict]] = None,
        test_mode: bool = False,
        test_cfg: Optional[dict] = None,
        cache: bool = False,
        loop: int = 1,
    ):
        self.data_root = data_root
        self.split = split
        self.transform = Compose(transform or [])
        self.test_mode = test_mode
        self.test_cfg = test_cfg if test_mode else None
        self.cache = cache
        self.cache_run = None
        self.loop = loop if not test_mode else 1

        if test_mode:
            tc = self.test_cfg or {}
            self.test_voxelize = (
                TRANSFORMS.build(tc["voxelize"]) if tc.get("voxelize") else None
            )
            self.test_crop = TRANSFORMS.build(tc["crop"]) if tc.get("crop") else None
            self.post_transform = Compose(tc.get("post_transform", []))
            self.aug_transform = [Compose(a) for a in tc.get("aug_transform", [[]])]

        self.data_list = self.get_data_list()
        get_root_logger().info(
            f"Totally {len(self.data_list)} x {self.loop} samples in {split} set."
        )

    def get_data_list(self) -> List[str]:
        if isinstance(self.split, str):
            splits = [self.split]
        else:
            splits = list(self.split)
        data_list = []
        for split in splits:
            data_list += sorted(
                glob.glob(os.path.join(self.data_root, split, "*"))
            )
        return data_list

    def get_data(self, idx: int) -> Dict[str, Any]:
        path = self.data_list[idx % len(self.data_list)]
        if self.cache:
            cache_name = scene_cache_name(self.data_root, path)
            try:
                return dict(shared_dict(cache_name, run=self.cache_run))
            except (AssertionError, FileNotFoundError):
                data = load_scene(path)
                return dict(shared_dict(cache_name, data, run=self.cache_run))
        return load_scene(path)

    def get_data_name(self, idx: int) -> str:
        return os.path.splitext(os.path.basename(self.data_list[idx % len(self.data_list)]))[0]

    def prepare_train_data(self, idx: int) -> Dict[str, Any]:
        return self.transform(self.get_data(idx))

    def prepare_test_data(self, idx: int) -> Dict[str, Any]:
        data_dict = self.get_data(idx)
        segment = data_dict.pop("segment", None)
        data_dict = self.transform(data_dict)
        result_dict = dict(name=self.get_data_name(idx))
        if segment is not None:
            result_dict["segment"] = segment

        fragment_list = []
        for aug in self.aug_transform:
            data = aug(deepcopy(data_dict))
            if self.test_voxelize is not None:
                data_part_list = self.test_voxelize(data)["fragment_list"]
            else:
                data["index"] = np.arange(data["coord"].shape[0])
                data_part_list = [data]
            for part in data_part_list:
                if self.test_crop is not None:
                    part = self.test_crop(part)
                    parts = part if isinstance(part, list) else [part]
                else:
                    parts = [part]
                for p in parts:
                    fragment_list.append(self.post_transform(p))
        result_dict["fragment_list"] = fragment_list
        return result_dict

    def __getitem__(self, idx):
        if self.test_mode:
            return self.prepare_test_data(idx)
        return self.prepare_train_data(idx)

    def __len__(self):
        return len(self.data_list) * self.loop


@DATASETS.register_module()
class ConcatDataset:
    def __init__(self, datasets: List[dict], loop: int = 1):
        self.datasets = [build_dataset(d) for d in datasets]
        self.loop = loop
        self.data_list = []
        for i, ds in enumerate(self.datasets):
            self.data_list += [(i, j) for j in range(len(ds))]
        get_root_logger().info(
            f"Totally {len(self.data_list)} x {self.loop} samples in the concat set."
        )

    def __getitem__(self, idx):
        ds_idx, sample_idx = self.data_list[idx % len(self.data_list)]
        return self.datasets[ds_idx][sample_idx]

    def __len__(self):
        return len(self.data_list) * self.loop


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


def _lookat_world2cam(eye, target, up=(0.0, 0.0, 1.0)):
    """CV-convention world->cam: x right, y down, z forward."""
    eye = np.asarray(eye, np.float64)
    fwd = np.asarray(target, np.float64) - eye
    fwd /= np.linalg.norm(fwd) + 1e-12
    right = np.cross(fwd, np.asarray(up, np.float64))
    if np.linalg.norm(right) < 1e-6:
        right = np.array([1.0, 0.0, 0.0])
    right /= np.linalg.norm(right) + 1e-12
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd], axis=0)
    t = -R @ eye
    E = np.eye(4)
    E[:3, :3] = R
    E[:3, 3] = t
    return E.astype(np.float32)


@DATASETS.register_module()
class SyntheticRGBDDataset(SyntheticDataset):
    """Synthetic scenes + geometrically consistent RGB-D views for pretraining.

    Views are rendered by z-buffered point projection (nearest point wins), so
    depth/color/semantic images agree exactly with the point cloud — enough to
    validate the whole render-pretraining path without disk assets. Mirrors the
    data contract of ScanNetRGBDDataset (reference ponder/datasets/scannet.py:
    212-599): per scene ``rgb/depth/semantic2d (V,H,W[,3])``, ``intrinsic
    (V,3,3)``, ``extrinsic (V,4,4)`` world2cam.
    """

    def __init__(self, num_cameras: int = 3, image_size: int = 48,
                 render_semantic: bool = True, **kwargs):
        super().__init__(**kwargs)
        self.num_cameras = num_cameras
        self.image_size = image_size
        self.render_semantic = render_semantic

    def make_scene(self, idx):
        data = super().make_scene(idx)
        rng = np.random.RandomState(self.seed + 10000 + idx % self.num_scenes)
        coord, color, segment = data["coord"], data["color"], data["segment"]
        center = (coord.min(0) + coord.max(0)) / 2
        radius = np.linalg.norm(coord.max(0) - coord.min(0)) / 2
        H = W = self.image_size
        f = 0.8 * W
        K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)

        rgbs, depths, sems, intrs, extrs = [], [], [], [], []
        for v in range(self.num_cameras):
            ang = rng.uniform(0, 2 * np.pi)
            eye = center + np.array(
                [np.cos(ang) * radius * 1.2, np.sin(ang) * radius * 1.2,
                 rng.uniform(0.5, 1.5)]
            )
            E = _lookat_world2cam(eye, center)
            cam = coord @ E[:3, :3].T + E[:3, 3]
            z = cam[:, 2]
            valid = z > 0.05
            u = np.round(K[0, 0] * cam[:, 0] / np.maximum(z, 1e-6) + K[0, 2]).astype(int)
            vv = np.round(K[1, 1] * cam[:, 1] / np.maximum(z, 1e-6) + K[1, 2]).astype(int)
            valid &= (u >= 0) & (u < W) & (vv >= 0) & (vv < H)
            order = np.argsort(-z)  # far first; near overwrites
            ui, vi, zi = u[order][valid[order]], vv[order][valid[order]], z[order][valid[order]]
            ci = color[order][valid[order]]
            si = segment[order][valid[order]]
            depth = np.zeros((H, W), np.float32)
            rgb = np.zeros((H, W, 3), np.float32)
            sem = np.full((H, W), -1, np.int64)
            depth[vi, ui] = zi
            rgb[vi, ui] = ci
            sem[vi, ui] = si
            rgbs.append(rgb)
            depths.append(depth)
            sems.append(sem)
            intrs.append(K)
            extrs.append(E)

        data["rgb"] = np.stack(rgbs)
        data["depth"] = np.stack(depths)
        if self.render_semantic:
            data["semantic2d"] = np.stack(sems)
        data["intrinsic"] = np.stack(intrs)
        data["extrinsic"] = np.stack(extrs)
        return data
