"""Offline ScanNet preprocessing: raw scans -> per-scene .npz/.pth dicts.

Reference: the reference's ponder/datasets/preprocessing/scannet/
preprocess_scannet.py:97-186. Reads ``scene*_vh_clean_2.ply`` +
``.aggregation.json`` + ``[...]_vh_clean_2.0.010000.segs.json``, produces
``coord/color/normal/semantic_gt20/semantic_gt200/instance_gt`` arrays.

A copy of ``ponderv2_tpu/datasets/preprocessing/preprocess_scannet.py`` but
for ``read_plymesh`` and the labels' read in ``parse_scene``, which use the
port's PLY reader (``ply.py``) in place of ``plyfile``, and two repairs:

- ``parse_scene`` writes the ``semantic_gt200`` the docstring promises (the
  JAX one writes none, so ScanNet200's items are all -1): each aggregation
  group's raw category through ``scannetv2-labels.combined.tsv``'s ``id``
  column (``category_ids``), then its index in ``VALID_CLASS_IDS_200``;
- ``main`` takes each split's scenes from ScanNet's list files
  (``scannetv2_{train,val,test}.txt``, in ``--splits_dir``), where the JAX
  one puts every scene of ``scans/`` in both train and val; a scene listed
  in two splits raises.

Usage:
  python -m ponderv2_tpu_torch.datasets.preprocessing.preprocess_scannet \
      --dataset_root /data/scannet_raw --output_root /data/scannet \
      [--splits_dir DIR] [--label_map_file TSV] [--parse_normals]
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor

import numpy as np

from .ply import read_ply
from .scannet200_constants import VALID_CLASS_IDS_200

# nyu40 ids used for the 20-class benchmark
VALID_CLASS_IDS_20 = (
    1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24, 28, 33, 34, 36, 39,
)


def read_plymesh(path):
    ply = read_ply(path)
    v = ply["vertex"]
    coords = np.stack([v["x"], v["y"], v["z"]], axis=1).astype(np.float32)
    colors = np.stack([v["red"], v["green"], v["blue"]], axis=1).astype(np.float32)
    faces = np.vstack(ply["face"]["vertex_indices"]) if "face" in ply else None
    return coords, colors, faces


def read_category_ids(tsv_path):
    """``scannetv2-labels.combined.tsv``: raw category -> its ScanNet ``id``
    (the ids ``VALID_CLASS_IDS_200`` lists)."""
    import csv

    with open(tsv_path) as f:
        return {row["raw_category"]: int(row["id"])
                for row in csv.DictReader(f, delimiter="\t")}


def face_normals(coords, faces):
    tris = coords[faces]
    n = np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
    vn = np.zeros_like(coords)
    for i in range(3):
        np.add.at(vn, faces[:, i], n)
    norm = np.linalg.norm(vn, axis=1, keepdims=True)
    return vn / np.maximum(norm, 1e-8)


def parse_scene(scene_dir: str, output_root: str, split: str,
                parse_normals: bool = True, label_map=None, category_ids=None):
    scene = os.path.basename(scene_dir.rstrip("/"))
    mesh = os.path.join(scene_dir, f"{scene}_vh_clean_2.ply")
    coords, colors, faces = read_plymesh(mesh)
    out = dict(coord=coords, color=colors)
    if parse_normals and faces is not None:
        out["normal"] = face_normals(coords, faces).astype(np.float32)

    agg = os.path.join(scene_dir, f"{scene}.aggregation.json")
    segs = os.path.join(scene_dir, f"{scene}_vh_clean_2.0.010000.segs.json")
    lbl = os.path.join(scene_dir, f"{scene}_vh_clean_2.labels.ply")
    if os.path.isfile(agg) and os.path.isfile(segs):
        with open(segs) as f:
            seg_indices = np.asarray(json.load(f)["segIndices"])
        with open(agg) as f:
            groups = json.load(f)["segGroups"]
        instance = np.full(len(coords), -1, np.int64)
        semantic40 = np.full(len(coords), -1, np.int64)
        sem200 = np.full(len(coords), -1, np.int64)
        for gi, group in enumerate(groups):
            mask = np.isin(seg_indices, group["segments"])
            instance[mask] = gi
            if label_map is not None:
                semantic40[mask] = label_map.get(group["label"], -1)
            scannet_id = (category_ids or {}).get(group["label"])
            if scannet_id in VALID_CLASS_IDS_200:
                sem200[mask] = VALID_CLASS_IDS_200.index(scannet_id)
        if os.path.isfile(lbl):
            semantic40 = np.asarray(read_ply(lbl)["vertex"]["label"]).astype(np.int64)
        sem20 = np.full(len(coords), -1, np.int64)
        for new_id, nyu_id in enumerate(VALID_CLASS_IDS_20):
            sem20[semantic40 == nyu_id] = new_id
        out["semantic_gt20"] = sem20
        if category_ids is not None:
            out["semantic_gt200"] = sem200
        out["instance_gt"] = instance
    os.makedirs(os.path.join(output_root, split), exist_ok=True)
    np.savez(os.path.join(output_root, split, f"{scene}.npz"), **out)
    return scene


def split_scenes(dataset_root, splits_dir):
    """split -> scene directories, from ``scannetv2_{split}.txt`` in
    ``splits_dir``: train and val under ``scans/``, test under
    ``scans_test/``. A split without its list file is left out; no list
    file, or a scene in two lists, raises."""
    out, owner = {}, {}
    for split, sub in (("train", "scans"), ("val", "scans"),
                       ("test", "scans_test")):
        path = os.path.join(splits_dir, f"scannetv2_{split}.txt")
        if not os.path.isfile(path):
            continue
        with open(path) as f:
            names = [line.strip() for line in f if line.strip()]
        for name in names:
            if name in owner:
                raise ValueError(f"{name} is listed in both {owner[name]} and {split}")
            owner[name] = split
        out[split] = [os.path.join(dataset_root, sub, name) for name in names]
    if not out:
        raise FileNotFoundError(
            f"no scannetv2_{{train,val,test}}.txt in {splits_dir}: ScanNet's split "
            "lists name each split's scenes")
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--dataset_root", required=True)
    p.add_argument("--output_root", required=True)
    p.add_argument("--splits_dir", default=None,
                   help="dir of scannetv2_{train,val,test}.txt (default: dataset_root)")
    p.add_argument("--label_map_file", default=None,
                   help="scannetv2-labels.combined.tsv (default: in dataset_root)")
    p.add_argument("--parse_normals", action="store_true", default=True)
    p.add_argument("--num_workers", type=int, default=8)
    args = p.parse_args(argv)

    tsv = args.label_map_file or os.path.join(args.dataset_root,
                                              "scannetv2-labels.combined.tsv")
    category_ids = read_category_ids(tsv) if os.path.isfile(tsv) else None
    if category_ids is None:
        print(f"no {tsv}: semantic_gt200 is not written")
    splits = split_scenes(args.dataset_root, args.splits_dir or args.dataset_root)
    for split, scene_dirs in splits.items():
        n = len(scene_dirs)
        with ProcessPoolExecutor(args.num_workers,
                                 mp_context=multiprocessing.get_context("spawn")) as ex:
            for scene in ex.map(
                parse_scene,
                scene_dirs,
                [args.output_root] * n,
                [split] * n,
                [args.parse_normals] * n,
                [None] * n,
                [category_ids] * n,
            ):
                print(f"[{split}] {scene}")


if __name__ == "__main__":
    main()
