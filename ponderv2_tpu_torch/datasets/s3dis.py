"""S3DIS datasets.

Copies of ``S3DIS_CLASS_NAMES`` and ``S3DISDataset`` from
``ponderv2_tpu/datasets/s3dis.py`` with only the import lines changed (see
``transform.py`` for why they are copies): area-split rooms stored as
``.pth`` dicts under ``{data_root}/{split}/``; but ``S3DISDataset``'s list
skips the ``{room}_rgbd/`` folders beside the rooms, which the JAX list
takes for rooms (ROADMAP Queue 3, F7). ``S3DISRGBDDataset`` (the
RGB-D pretraining variant) keeps the JAX package's room list, view picks and
items, and reads the views ``preprocess_s3dis.py`` writes as well
(``read_rgbd_views``).
"""

from __future__ import annotations

import glob
import os
from typing import Any, Dict, List

import numpy as np

from .builder import DATASETS
from .defaults import DefaultDataset, load_scene

S3DIS_CLASS_NAMES = (
    "ceiling", "floor", "wall", "beam", "column", "window", "door", "table",
    "chair", "sofa", "bookcase", "board", "clutter",
)


@DATASETS.register_module()
class S3DISDataset(DefaultDataset):
    """Area-split rooms stored as .pth dicts (coord/color/normal/segment/instance)."""

    def get_data_list(self) -> List[str]:
        """The rooms under each split: ``DefaultDataset``'s list without the
        ``{room}_rgbd/`` view folders that ``preprocess_s3dis.py
        --parse_rgbd`` writes beside each ``{room}.pth`` (the JAX list takes
        them for rooms)."""
        return [p for p in super().get_data_list()
                if not (p.endswith("_rgbd") and os.path.isfile(p[:-len("_rgbd")] + ".pth"))]

    def get_data(self, idx: int) -> Dict[str, Any]:
        data = super().get_data(idx)
        out = dict(
            coord=np.asarray(data["coord"], np.float32),
            color=np.asarray(
                data.get("color", np.zeros_like(data["coord"])), np.float32
            ),
        )
        if "normal" in data:
            out["normal"] = np.asarray(data["normal"], np.float32)
        for src, dst in (("semantic_gt", "segment"), ("segment", "segment"),
                         ("instance_gt", "instance"), ("instance", "instance")):
            if src in data and dst not in out:
                out[dst] = np.asarray(data[src]).reshape(-1).astype(np.int64)
        out.setdefault("segment", np.full(out["coord"].shape[0], -1, np.int64))
        out.setdefault("instance", np.full(out["coord"].shape[0], -1, np.int64))
        return out


def read_rgbd_views(path: str, num_cameras: int, render_semantic: bool,
                    depth_scale: float) -> Dict[str, np.ndarray]:
    """``num_cameras`` views of the room at ``path``, picked from
    ``{room}_rgbd/*`` with numpy's global generator: ``rgb`` (V, H, W, 3),
    ``depth`` (V, H, W) in metres, ``intrinsic`` (V, 3, 3), ``extrinsic``
    (V, 4, 4) world2cam and, with ``render_semantic``, ``semantic2d``.

    A view holds one of two sets of keys:

    - ``color``, ``depth`` (m), ``intrinsic``, ``extrinsic`` (world2cam) or
      ``pose`` (cam2world), optional ``label``: read as the JAX package's
      ``S3DISRGBDDataset.get_data`` reads them, to the same bytes;
    - the preprocessors' (``preprocess_s3dis.py:parse_room_rgbd``,
      ``preprocess_structured3d.py:parse_scene``): ``rgb``, ``depth`` in
      1/``depth_scale`` m, ``depth_mask``, ``semantic_map``, ``intrinsic``
      and ``extrinsic`` as cam2world (camera x right, y down, z forward, in
      metres, to the room's world frame). Depth outside ``depth_mask`` is
      0 (no ray), and ``extrinsic`` is inverted to the world2cam the
      renderer takes. The JAX dataset raises on these (ROADMAP Queue 3).

    A view with neither set raises, naming the keys it holds."""
    views = sorted(glob.glob(os.path.join(os.path.splitext(path)[0] + "_rgbd", "*")))
    pick = np.random.choice(
        len(views), num_cameras, replace=len(views) < num_cameras
    )
    rgbs, depths, sems, intrs, extrs = [], [], [], [], []
    for i in pick:
        view = load_scene(views[i])
        if "color" in view:
            rgbs.append(np.asarray(view["color"], np.float32))
            depths.append(np.asarray(view["depth"], np.float32))
            intrs.append(np.asarray(view["intrinsic"], np.float32)[:3, :3])
            extr = np.asarray(view.get("extrinsic", view.get("pose")), np.float32)
            if "pose" in view and "extrinsic" not in view:
                extr = np.linalg.inv(extr)
            extrs.append(extr.astype(np.float32))
            label = view.get("label")
        elif {"rgb", "depth", "depth_mask", "intrinsic", "extrinsic"} <= view.keys():
            rgbs.append(np.asarray(view["rgb"], np.float32))
            depth = np.asarray(view["depth"], np.float64) / depth_scale
            depths.append(np.where(np.asarray(view["depth_mask"], bool), depth,
                                   0.0).astype(np.float32))
            intrs.append(np.asarray(view["intrinsic"], np.float32)[:3, :3])
            extrs.append(np.linalg.inv(np.asarray(view["extrinsic"], np.float64))
                         .astype(np.float32))
            label = view.get("semantic_map")
        else:
            raise KeyError(
                f"{views[i]}: an RGB-D view holds color/depth/intrinsic/extrinsic "
                "(or pose), or the preprocessors' rgb/depth/depth_mask/intrinsic/"
                f"extrinsic; this one holds {sorted(view)}")
        if render_semantic:
            sems.append(
                np.asarray(label, np.int64) if label is not None
                else np.full(depths[-1].shape, -1, np.int64)
            )
    out = dict(rgb=np.stack(rgbs), depth=np.stack(depths),
               intrinsic=np.stack(intrs), extrinsic=np.stack(extrs))
    if render_semantic:
        out["semantic2d"] = np.stack(sems)
    return out


class RGBDViews:
    """Mixin of the RGB-D pretraining datasets over a room dataset: its
    rooms that have views under ``{room}_rgbd/``, each item with
    ``num_cameras`` of them (``read_rgbd_views``, depth of the
    preprocessor's in 1/``depth_scale`` m)."""

    depth_scale: float

    def __init__(self, num_cameras: int = 5, render_semantic: bool = True,
                 **kwargs):
        self.num_cameras = num_cameras
        self.render_semantic = render_semantic
        super().__init__(**kwargs)

    def get_data_list(self) -> List[str]:
        return [
            p for p in super().get_data_list()
            if glob.glob(os.path.join(os.path.splitext(p)[0] + "_rgbd", "*"))
        ]

    def get_data(self, idx: int) -> Dict[str, Any]:
        data = super().get_data(idx)
        path = self.data_list[idx % len(self.data_list)]
        data.update(read_rgbd_views(path, self.num_cameras, self.render_semantic,
                                    self.depth_scale))
        return data


@DATASETS.register_module()
class S3DISRGBDDataset(RGBDViews, S3DISDataset):
    """Rooms that have per-view RGB-D dicts under ``{room}_rgbd/*.pth``
    (reference filter at s3dis.py:185-208), the JAX package's list; the
    preprocessor's depth is in 1/4000 m
    (``preprocess_s3dis.py:unproject_filtering_depths``)."""

    depth_scale = 4000.0
