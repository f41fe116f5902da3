"""Point-cloud visualization savers (reference ponder/utils/visualization.py:22-90).

Writes PLY files directly (no open3d dependency): colored point clouds, bounding
boxes as line sets, and per-point label colorizations.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def _write_ply(path: str, coords: np.ndarray, colors: Optional[np.ndarray] = None,
               edges: Optional[np.ndarray] = None):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    n = len(coords)
    header = ["ply", "format ascii 1.0", f"element vertex {n}",
              "property float x", "property float y", "property float z"]
    if colors is not None:
        header += ["property uchar red", "property uchar green",
                   "property uchar blue"]
    if edges is not None:
        header += [f"element edge {len(edges)}", "property int vertex1",
                   "property int vertex2"]
    header.append("end_header")
    with open(path, "w") as f:
        f.write("\n".join(header) + "\n")
        for i in range(n):
            row = f"{coords[i, 0]:.6f} {coords[i, 1]:.6f} {coords[i, 2]:.6f}"
            if colors is not None:
                c = np.clip(colors[i], 0, 255).astype(int)
                row += f" {c[0]} {c[1]} {c[2]}"
            f.write(row + "\n")
        if edges is not None:
            for e in edges:
                f.write(f"{int(e[0])} {int(e[1])}\n")


def save_point_cloud(coord: np.ndarray, color: Optional[np.ndarray] = None,
                     file_path: str = "pc.ply", logger=None):
    coord = np.asarray(coord)
    if color is not None:
        color = np.asarray(color)
        if color.max() <= 1.001:
            color = color * 255.0
    _write_ply(file_path, coord, color)
    if logger is not None:
        logger.info(f"Saved point cloud to: {file_path}")


def label_palette(num_classes: int, seed: int = 7) -> np.ndarray:
    rng = np.random.RandomState(seed)
    return rng.randint(40, 255, (num_classes + 1, 3)).astype(np.uint8)


def save_labeled_cloud(coord: np.ndarray, labels: np.ndarray,
                       file_path: str = "seg.ply", num_classes: int = 20):
    palette = label_palette(num_classes)
    colors = palette[np.clip(np.asarray(labels) + 1, 0, num_classes)]
    _write_ply(file_path, np.asarray(coord), colors)


def save_bounding_boxes(bboxes: np.ndarray, file_path: str = "bbox.ply",
                        logger=None):
    """bboxes (K, 6): xyz_min, xyz_max -> wireframe PLY."""
    bboxes = np.asarray(bboxes)
    verts, edges = [], []
    for k, b in enumerate(bboxes):
        lo, hi = b[:3], b[3:6]
        corners = np.array([[x, y, z] for x in (lo[0], hi[0])
                            for y in (lo[1], hi[1]) for z in (lo[2], hi[2])])
        base = 8 * k
        verts.append(corners)
        for i, j in ((0, 1), (0, 2), (1, 3), (2, 3), (4, 5), (4, 6), (5, 7),
                     (6, 7), (0, 4), (1, 5), (2, 6), (3, 7)):
            edges.append((base + i, base + j))
    _write_ply(file_path, np.concatenate(verts), None, np.asarray(edges))
    if logger is not None:
        logger.info(f"Saved bboxes to: {file_path}")


def save_lines(points: np.ndarray, edges: np.ndarray, file_path: str = "line.ply"):
    _write_ply(file_path, np.asarray(points), None, np.asarray(edges))
