"""ScanNet / ScanNet200 datasets (+ RGB-D pretraining variant).

Copies of ``VALID_CLASS_IDS_20``, ``CLASS_NAMES_20``, ``ScanNet200Dataset``
and ``ScanNetRGBDDataset`` from ``ponderv2_tpu/datasets/scannet.py`` with
only the import lines changed (see ``transform.py`` for why they are copies),
but for ``ScanNetRGBDDataset._load_dir_frame``, which reads the extractor's
JPEG and PNG frames and resizes them through ``image_io.py`` (PIL's pixels
and resamples) in place of PIL.
``ScanNetDataset`` differs where the JAX one fails: a one-scene ``lr_file``
(``np.loadtxt`` gives a 0-d array) and an ``la_file`` of numpy index arrays
(which ``torch.load``'s default ``weights_only`` refuses). Scenes are preprocessed ``.pth``
dicts under ``{data_root}/{split}/``: ``coord``/``color``/``normal`` and
``semantic_gt20`` / ``semantic_gt200`` / ``instance_gt``; the RGB-D
pretraining variant adds ``num_cameras`` frames per scene from
``rgbd_root`` (the extractor's folders, or per-frame ``.npz`` files).
"""

from __future__ import annotations

import glob
import json
import os
from typing import Any, Dict, List, Optional

import numpy as np

from .builder import DATASETS
from .defaults import DefaultDataset, load_scene
from .image_io import read_image, resize_bicubic, resize_nearest

VALID_CLASS_IDS_20 = (
    1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24, 28, 33, 34, 36, 39,
)

CLASS_NAMES_20 = (
    "wall", "floor", "cabinet", "bed", "chair", "sofa", "table", "door",
    "window", "bookshelf", "picture", "counter", "desk", "curtain",
    "refrigerator", "shower curtain", "toilet", "sink", "bathtub",
    "otherfurniture",
)


def _load_la_file(path: str) -> Dict[str, Any]:
    """The limited-annotation file: scene name -> indices of its labelled
    points, as plain lists or numpy arrays. ``torch.load``'s default
    ``weights_only`` refuses numpy arrays, so the types a pickled integer
    array names are allowed, and nothing else."""
    import torch

    reconstruct = np.zeros(0).__reduce__()[0]  # numpy's module path differs by version
    dtypes = [type(np.dtype(c)) for c in np.typecodes["AllInteger"]]
    with torch.serialization.safe_globals([reconstruct, np.ndarray, np.dtype, *dtypes]):
        return torch.load(path)


@DATASETS.register_module()
class ScanNetDataset(DefaultDataset):
    class2id = np.array(VALID_CLASS_IDS_20)

    def __init__(
        self,
        lr_file: Optional[str] = None,
        la_file: Optional[str] = None,
        **kwargs,
    ):
        self.lr = (np.atleast_1d(np.loadtxt(lr_file, dtype=str))
                   if lr_file is not None else None)
        self.la = _load_la_file(la_file) if la_file is not None else None
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


@DATASETS.register_module()
class ScanNetRGBDDataset(ScanNetDataset):
    """Pretraining: scene cloud + ``num_cameras`` random RGB-D frames.

    Two ``rgbd_root`` layouts are supported:

    1. the reference extractor layout (our ``preprocessing/sensor_data.py``,
       equal to reference reader.py output): per scene ``color/N.jpg``,
       ``depth/N.png`` (uint16 mm), ``pose/N.txt`` (cam2world),
       ``intrinsic/intrinsic_depth.txt``, optional ``label/N.png`` (nyu40 ids,
       remapped here to the 20-class subset — reference scannet.py:503-511),
       optional ``<scene>.txt`` with the axisAlignment meta;
    2. per-frame ``{scene}/*.npz`` files with color/depth/pose/intrinsic
       (+label) arrays (synthetic-fixture friendly).

    A ``skip.json`` may list bad frames (reference frame skip-list).
    """

    def __init__(
        self,
        rgbd_root: str = "data/scannet_rgbd",
        num_cameras: int = 5,
        render_semantic: bool = True,
        depth_scale: float = 1.0 / 1000.0,
        align_axis: bool = True,
        frame_skip_list: Optional[str] = None,
        **kwargs,
    ):
        self.rgbd_root = rgbd_root
        self.num_cameras = num_cameras
        self.render_semantic = render_semantic
        self.depth_scale = depth_scale
        self.align_axis = align_axis
        self.skip = set()
        if frame_skip_list and os.path.isfile(frame_skip_list):
            with open(frame_skip_list) as f:
                self.skip = set(json.load(f))
        super().__init__(**kwargs)

    # ------------------------------------------------- reference-layout IO
    def _get_axis_align_matrix(self, scene_dir: str, name: str) -> np.ndarray:
        txt = os.path.join(scene_dir, f"{name}.txt")
        if os.path.isfile(txt):
            with open(txt) as f:
                for line in f:
                    if "axisAlignment" in line:
                        vals = [
                            float(x)
                            for x in line.rstrip().strip("axisAlignment = ").split()
                        ]
                        return np.asarray(vals, np.float32).reshape(4, 4)
        return np.eye(4, dtype=np.float32)

    def _load_dir_frame(self, scene_dir: str, name: str, frame: str):
        """Read one frame from the extractor layout -> frame dict."""
        fid = frame.split(".")[0]
        rgb = np.asarray(
            read_image(os.path.join(scene_dir, "color", f"{fid}.jpg"), rgb=True),
            np.float32,
        )
        depth = np.asarray(
            read_image(os.path.join(scene_dir, "depth", f"{fid}.png")), np.float32
        ) * self.depth_scale
        if rgb.shape[:2] != depth.shape:
            rgb = np.asarray(
                resize_bicubic(rgb.astype(np.uint8), (depth.shape[1], depth.shape[0])),
                np.float32,
            )
        pose = np.loadtxt(
            os.path.join(scene_dir, "pose", f"{fid}.txt")
        ).astype(np.float32)  # cam2world
        if self.align_axis:
            pose = self._get_axis_align_matrix(scene_dir, name) @ pose
        intr = np.loadtxt(
            os.path.join(scene_dir, "intrinsic", "intrinsic_depth.txt")
        ).astype(np.float32)
        out = dict(color=rgb, depth=depth, pose=pose, intrinsic=intr)
        label_path = os.path.join(scene_dir, "label", f"{fid}.png")
        if self.render_semantic and os.path.isfile(label_path):
            nyu40 = np.asarray(read_image(label_path), np.int16)
            if nyu40.shape != depth.shape:
                nyu40 = resize_nearest(nyu40, (depth.shape[1], depth.shape[0]))
            # nyu40 -> 0..19 over VALID_CLASS_IDS_20 (reference :503-511)
            label = np.full_like(nyu40, -1, dtype=np.int64)
            for i, vid in enumerate(VALID_CLASS_IDS_20):
                label[nyu40 == vid] = i
            out["label"] = label
        return out

    def get_data(self, idx: int) -> Dict[str, Any]:
        data = super().get_data(idx)
        name = self.get_data_name(idx)
        frame_dir = os.path.join(self.rgbd_root, name)
        dir_layout = os.path.isdir(os.path.join(frame_dir, "color"))
        if dir_layout:
            frames = sorted(
                (
                    f for f in os.listdir(os.path.join(frame_dir, "color"))
                    if f.endswith(".jpg") and f"{name}/{f}" not in self.skip
                ),
                key=lambda x: int(x.split(".")[0]),
            )
        else:
            frames = sorted(
                f for f in glob.glob(os.path.join(frame_dir, "*.npz"))
                if os.path.basename(f) not in self.skip
            )
        if not frames:
            raise FileNotFoundError(f"no RGB-D frames for scene {name} in {frame_dir}")
        # seeded per (epoch-looped) index: deterministic across workers/resume
        # (python's str hash is process-salted; crc32 is stable)
        import zlib

        picker = np.random.RandomState(
            np.uint32((zlib.crc32(name.encode()) ^ (idx * 0x9E3779B9)) & 0xFFFFFFFF)
        )
        pick = picker.choice(
            len(frames), self.num_cameras, replace=len(frames) < self.num_cameras
        )
        rgbs, depths, sems, intrs, extrs = [], [], [], [], []
        for i in pick:
            if dir_layout:
                fr = self._load_dir_frame(frame_dir, name, frames[i])
            else:
                fr = dict(np.load(frames[i]))
            rgbs.append(np.asarray(fr["color"], np.float32))
            depths.append(np.asarray(fr["depth"], np.float32))
            intrs.append(np.asarray(fr["intrinsic"], np.float32)[:3, :3])
            pose = np.asarray(fr["pose"], np.float32)  # cam2world
            extrs.append(np.linalg.inv(pose).astype(np.float32))
            if self.render_semantic:
                sems.append(
                    np.asarray(fr["label"], np.int64)
                    if "label" in fr
                    else np.full(depths[-1].shape, -1, np.int64)
                )
        data["rgb"] = np.stack(rgbs)
        data["depth"] = np.stack(depths)
        data["intrinsic"] = np.stack(intrs)
        data["extrinsic"] = np.stack(extrs)
        if self.render_semantic:
            data["semantic2d"] = np.stack(sems)
        return data
