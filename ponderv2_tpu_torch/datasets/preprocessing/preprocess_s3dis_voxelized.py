"""Offline voxelization of preprocessed S3DIS rooms.

Mirrors the reference utility
(the reference's ponder/datasets/preprocessing/s3dis/preprocess_s3dis_voxelized.py:22-60):
apply a train-mode GridSample (one random survivor per voxel) to every
``Area_*/room.pth`` dict produced by :mod:`preprocess_s3dis` and write the
shrunken dicts to a parallel output tree — trading a little sampling
randomness for much faster epoch IO on dense (1 cm) grids.

A copy of ``ponderv2_tpu/datasets/preprocessing/preprocess_s3dis_voxelized.py``
whose ``GridSample`` is the port's (``datasets/transform.py``).

Run: ``python -m ponderv2_tpu_torch.datasets.preprocessing.preprocess_s3dis_voxelized
--dataset_root <processed s3dis> --output_root <out> [--voxel_size 0.01]``
"""

from __future__ import annotations

import argparse
import glob
import multiprocessing as mp
import os
from concurrent.futures import ProcessPoolExecutor
from itertools import repeat

from ..transform import GridSample


def _load(path):
    import torch

    # room dicts hold plain numpy arrays (weights_only rejects them)
    return torch.load(path, map_location="cpu", weights_only=False)


def _save(obj, path):
    import torch

    torch.save(obj, path)


def voxelize_room(data_path: str, dataset_root: str, output_root: str,
                  voxel_size: float) -> str:
    """GridSample one room dict offline and write it under ``output_root``."""
    out_path = os.path.join(
        output_root, os.path.relpath(data_path, dataset_root)
    )
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    data = _load(data_path)
    data = GridSample(
        grid_size=voxel_size, hash_type="fnv", mode="train",
        keys=tuple(data.keys()),
    )(data)
    _save(data, out_path)
    return out_path


def main_process(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset_root", required=True,
                        help="Path to processed S3DIS dataset (.pth rooms)")
    parser.add_argument("--output_root", required=True,
                        help="Output path for the voxelized area folders")
    parser.add_argument("--voxel_size", default=0.01, type=float)
    parser.add_argument("--num_workers", default=mp.cpu_count(), type=int)
    args = parser.parse_args(argv)

    data_list = glob.glob(os.path.join(args.dataset_root, "*/*.pth"))
    print(f"Voxelizing {len(data_list)} rooms at {args.voxel_size} m ...")
    with ProcessPoolExecutor(max_workers=args.num_workers) as pool:
        for out in pool.map(
            voxelize_room,
            data_list,
            repeat(args.dataset_root),
            repeat(args.output_root),
            repeat(args.voxel_size),
        ):
            print(f"  wrote {out}")


if __name__ == "__main__":
    main_process()
