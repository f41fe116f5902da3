"""Procedural indoor scenes written from the run's seed, in ScanNet's
processed layout (the one ``ScanNetDataset`` reads).

``make_scene`` is a frozen copy of ``ponderv2_tpu_torch/datasets/defaults.py:
SyntheticDataset.make_scene`` and ``write_scannet_scenes`` of
``chip_smoke.py:write_scannet_scenes``, changed in one respect: a scene's
geometry (the room, its boxes and every point's position) is drawn from
the scene's index alone, and its colours and normals from the seed. The
test voxelisation's work (voxels, and fragments: as many as the fullest
voxel has points) follows from the positions, so every seed gives the
same work and a run's rate does not move with its seed.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np


def make_scene(seed: int, idx: int, points: int, num_classes: int = 20
               ) -> Dict[str, np.ndarray]:
    """A box room: a floor, two walls and 3-7 boxes of ``points`` points
    with random colours and unit normals; labels 0 floor, 1 wall, 2.. a
    box's class."""
    geo = np.random.RandomState(idx)
    rng = np.random.RandomState((seed * 1000003 + idx) % 2 ** 32)
    n = points
    n_floor = n // 4
    n_wall = n // 4
    n_obj = n - n_floor - n_wall
    room = geo.uniform(3.0, 8.0, 2)
    floor = np.stack(
        [geo.uniform(0, room[0], n_floor), geo.uniform(0, room[1], n_floor),
         np.abs(geo.randn(n_floor)) * 0.02], axis=1)
    side = geo.randint(0, 2, n_wall)
    wall = np.stack(
        [np.where(side, geo.uniform(0, room[0], n_wall), 0.0),
         np.where(side, 0.0, geo.uniform(0, room[1], n_wall)),
         geo.uniform(0, 2.8, n_wall)], axis=1)
    n_boxes = geo.randint(3, 8)
    obj_pts, obj_lbl = [], []
    for b in range(n_boxes):
        cnt = n_obj // n_boxes
        center = np.array([geo.uniform(0.5, room[0] - 0.5),
                           geo.uniform(0.5, room[1] - 0.5),
                           geo.uniform(0.2, 1.2)])
        box = geo.uniform(0.2, 1.0, 3)
        obj_pts.append(center + (geo.rand(cnt, 3) - 0.5) * box)
        obj_lbl.append(np.full(cnt, 2 + (b % (num_classes - 2))))
    obj = np.concatenate(obj_pts)
    coord = np.concatenate([floor, wall, obj]).astype(np.float32)
    segment = np.concatenate(
        [np.zeros(n_floor), np.ones(n_wall), np.concatenate(obj_lbl)]).astype(np.int64)
    m = len(coord)
    color = (rng.rand(m, 3) * 255).astype(np.float32)
    normal = rng.randn(m, 3).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=1, keepdims=True) + 1e-9
    return dict(coord=coord, color=color, normal=normal, segment=segment,
                instance=np.full(m, -1, dtype=np.int64))


def write_scannet_scenes(root: str, split: str, count: int, points: int,
                         seed: int) -> List[Dict[str, np.ndarray]]:
    """``{root}/{split}/sceneXXXX_00.pth``, each a dict of ``coord``,
    ``color``, ``normal``, ``semantic_gt20`` and ``instance_gt``; returns
    the scenes as written."""
    import torch

    os.makedirs(os.path.join(root, split), exist_ok=True)
    out = []
    for i in range(count):
        s = make_scene(seed, i, points)
        torch.save(dict(coord=s["coord"], color=s["color"], normal=s["normal"],
                        semantic_gt20=s["segment"], instance_gt=s["instance"]),
                   os.path.join(root, split, f"scene{i:04d}_00.pth"))
        out.append(s)
    return out
