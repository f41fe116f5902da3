"""nuScenes LiDAR dataset (the JAX package's ``datasets/nuscenes.py``).

A copy with only the import lines changed (see ``transform.py`` for why it
is a copy), but for two repairs that ``tests/test_torch_nuscenes.py``
names: camera images are read by ``image_io.read_image`` (PNG and JPEG
with the port's codec; the JAX dataset needs ``imageio``), and a test scan's
``segment`` is taken after its transform, so that ``PointRangeFilter``
drops the labels of the points it drops (the JAX ``DefaultDataset`` takes
it before, and scores predictions against labels of other points; ROADMAP
Queue 3, F11). Scenes come from pickled "info" files: each record carries
the lidar path, the lidarseg label path, the sweep list and (with
``use_camera``) six camera image paths with their lidar2img / lidar2cam
matrices. Only the keyframe sweep is read, as in the JAX package.
"""

from __future__ import annotations

import os
import pickle
from copy import deepcopy
from typing import Any, Dict, List, Optional

import numpy as np

from ..utils.logger import get_root_logger
from .builder import DATASETS
from .defaults import DefaultDataset
from .image_io import read_image

# 32 raw classes -> 16 learning classes (reference nuscenes.py:139-175)
LEARNING_MAP = {
    1: 0, 5: 0, 7: 0, 8: 0, 10: 0, 11: 0, 13: 0, 19: 0, 20: 0, 0: 0, 29: 0,
    31: 0, 9: 1, 14: 2, 15: 3, 16: 3, 17: 4, 18: 5, 21: 6, 2: 7, 3: 7, 4: 7,
    6: 7, 12: 8, 22: 9, 23: 10, 24: 11, 25: 12, 26: 13, 27: 14, 28: 15, 30: 16,
}

CLASS_NAMES_16 = (
    "barrier", "bicycle", "bus", "car", "construction_vehicle", "motorcycle",
    "pedestrian", "traffic_cone", "trailer", "truck", "driveable_surface",
    "other_flat", "sidewalk", "terrain", "manmade", "vegetation",
)


@DATASETS.register_module()
class NuScenesDataset(DefaultDataset):
    def __init__(
        self,
        sweeps: int = 10,
        use_camera: bool = False,
        num_cameras: int = 6,
        **kwargs,
    ):
        self.sweeps = sweeps
        self.use_camera = use_camera
        self.num_cameras = num_cameras
        self.learning_map = np.full(
            max(LEARNING_MAP.keys()) + 1, -1, dtype=np.int64
        )
        for k, v in LEARNING_MAP.items():
            # 0 is "ignore" in the reference map (mapped to ignore_index later);
            # shift so classes are 0..15 and ignore is -1
            self.learning_map[k] = v - 1 if v > 0 else -1
        super().__init__(**kwargs)

    def get_data_list(self) -> List[Dict]:
        info_path = os.path.join(
            self.data_root, "info", f"nuscenes_infos_{self.sweeps}sweeps_{self.split}.pkl"
        )
        if not os.path.isfile(info_path):
            get_root_logger().warning(f"nuScenes info file missing: {info_path}")
            return []
        with open(info_path, "rb") as f:
            return pickle.load(f)

    def get_data(self, idx: int) -> Dict[str, Any]:
        info = self.data_list[idx % len(self.data_list)]
        lidar_path = os.path.join(self.data_root, "raw", info["lidar_path"])
        points = np.fromfile(lidar_path, dtype=np.float32).reshape(-1, 5)
        coord = points[:, :3]
        strength = points[:, 3:4] / 255.0

        out: Dict[str, Any] = dict(coord=coord, strength=strength.astype(np.float32))
        if "gt_segment_path" in info:
            seg_path = os.path.join(self.data_root, "raw", info["gt_segment_path"])
            raw = np.fromfile(seg_path, dtype=np.uint8).reshape(-1)
            out["segment"] = self.learning_map[raw]
        else:
            out["segment"] = np.full(coord.shape[0], -1, np.int64)

        if self.use_camera and "cams" in info:
            rgbs, l2i, l2c, intrs = [], [], [], []
            for cam, cam_info in list(info["cams"].items())[: self.num_cameras]:
                img = read_image(
                    os.path.join(self.data_root, "raw", cam_info["data_path"])
                )
                rgbs.append(np.asarray(img, np.float32))
                l2i.append(np.asarray(cam_info["lidar2img"], np.float32))
                l2c.append(np.asarray(cam_info["lidar2cam"], np.float32))
                intrs.append(np.asarray(cam_info["cam_intrinsic"], np.float32))
            out["rgb"] = np.stack(rgbs)
            out["lidar2img"] = np.stack(l2i)
            out["lidar2cam"] = np.stack(l2c)
            out["intrinsic"] = np.stack(intrs)
        return out

    def get_data_name(self, idx: int) -> str:
        info = self.data_list[idx % len(self.data_list)]
        return str(info.get("token", idx))

    def prepare_test_data(self, idx: int) -> Dict[str, Any]:
        """``DefaultDataset.prepare_test_data`` with the transform run before
        ``segment`` is taken out (F11)."""
        data_dict = self.transform(self.get_data(idx))
        segment = data_dict.pop("segment", None)
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
