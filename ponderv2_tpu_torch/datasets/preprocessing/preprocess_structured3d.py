"""Offline Structured3D preprocessing: Scene zips -> per-room .pth dicts
(fused perspective + panorama clouds with normals and 25-class labels) and
optional per-view RGB-D dicts for rendering pretraining.

Reference contract: the reference's ponder/datasets/preprocessing/structured3d/
preprocess_structured3d.py:92-481. Faithful pieces: multi-zip name-mapped
reader; train/val/test split by scene id (<3000 / <3250 / rest); camera txt
parsing with the z-up rotation; perspective unprojection from half-angle
focal lengths; cross-product normals; the cosine-incidence x depth x semantic
validity filter; world fusion; the 40->25 class remap (VALID_CLASS_IDS_25);
panorama spherical unprojection; the final y/z axis swap; optional GridSample;
per-view RGB-D dicts with the reference's extrinsic convention chain.

A copy of ``ponderv2_tpu/datasets/preprocessing/preprocess_structured3d.py``
but for ``Structured3DReader.read_depth`` / ``read_color`` /
``read_segment``, which decode the zips' PNGs through
``datasets/image_io.py`` (the port's codec; PIL's pixels) in place of PIL;
its ``GridSample`` is the port's.

    python -m ponderv2_tpu_torch.datasets.preprocessing.preprocess_structured3d \
        --dataset_root DIR_OF_ZIPS --output_root DIR [--parse_rgbd] [--grid_size G]
"""

from __future__ import annotations

import argparse
import os
import zipfile

import numpy as np

from ..image_io import decode_png

VALID_CLASS_IDS_25 = (
    1, 2, 3, 4, 5, 6, 7, 8, 9, 11, 14, 15, 16, 17, 18, 19, 22, 24, 25, 32,
    34, 35, 38, 39, 40,
)
CLASS_NAMES_25 = (
    "wall", "floor", "cabinet", "bed", "chair", "sofa", "table", "door",
    "window", "picture", "desk", "shelves", "curtain", "dresser", "pillow",
    "mirror", "ceiling", "refrigerator", "television", "nightstand", "sink",
    "lamp", "otherstructure", "otherfurniture", "otherprop",
)

# camera frame -> z-up world intermediate (reference read_camera)
_Z2Y_TOP = np.array([[0, 1, 0], [0, 0, 1], [1, 0, 0]], np.float32)
# perspective camera-axis permutation applied to unprojected coords
_PRSP_AXES = np.array([[0, 0, 1], [0, -1, 0], [1, 0, 0]], np.float32)
# final fused-cloud axis swap (y <-> z)
_SWAP_YZ = np.array([[1, 0, 0], [0, 0, 1], [0, 1, 0]], np.float32)


def normal_from_cross_product(points_2d: np.ndarray) -> np.ndarray:
    """Per-pixel normals from neighboring-point cross products (reference
    :99-110)."""
    pad = np.pad(points_2d, ((0, 1), (0, 1), (0, 0)), mode="symmetric")
    ver = (pad[:, :-1, :] - pad[:, 1:, :])[:-1, :, :]
    hor = (pad[:-1, :, :] - pad[1:, :, :])[:, :-1, :]
    n = np.cross(hor, ver)
    d = np.linalg.norm(n, axis=-1, keepdims=True)
    return np.divide(n, d, out=np.zeros_like(n), where=d != 0)


class Structured3DReader:
    """Name-mapped reader over one or many Structured3D zips (reference
    :113-157)."""

    def __init__(self, files):
        if isinstance(files, str):
            files = [files]
        self.readers = [zipfile.ZipFile(f, "r") for f in files]
        self.names_mapper = {}
        for idx, reader in enumerate(self.readers):
            for name in reader.namelist():
                self.names_mapper[name] = idx

    def filelist(self):
        return list(self.names_mapper.keys())

    def listdir(self, dir_name):
        dir_name = dir_name.strip("/")
        entries = {
            f.replace(dir_name + "/", "", 1).split("/")[0]
            for f in self.filelist()
            if f.startswith(dir_name + "/")
        }
        entries.discard("")
        return sorted(entries)

    def read(self, name):
        return self.readers[self.names_mapper[name]].read(name)

    def read_camera(self, camera_path):
        cam_extr = np.fromstring(self.read(camera_path), dtype=np.float32,
                                 sep=" ")
        cam_t = _Z2Y_TOP @ (cam_extr[:3] / 1000.0)
        if cam_extr.shape[0] > 3:
            cam_front, cam_up = cam_extr[3:6], cam_extr[6:9]
            cam_n = np.cross(cam_front, cam_up)
            cam_r = np.stack((cam_front, cam_up, cam_n), axis=1).astype(
                np.float32
            )
            cam_r = _Z2Y_TOP @ cam_r
            cam_f = cam_extr[9:11]  # half-angle FOV (fx, fy)
        else:
            cam_r = np.eye(3, dtype=np.float32)
            cam_f = None
        return cam_r, cam_t, cam_f

    def read_depth(self, path):
        depth = decode_png(self.read(path), path)[..., None]
        depth = depth.astype(np.int32)
        depth[depth == 0] = 65535  # invalid sentinel (reference :141)
        return depth

    def read_color(self, path):
        return decode_png(self.read(path), path, rgb=True)

    def read_segment(self, path):
        return decode_png(self.read(path), path)[..., None]


def _remap25(segment, ignore_index):
    out = np.full(segment.shape, ignore_index, np.int64)
    for idx, value in enumerate(VALID_CLASS_IDS_25):
        out[np.all(segment == value, axis=-1)] = idx
    return out


def scene_split(scene_name: str) -> str:
    scene_id = int(os.path.basename(scene_name).split("_")[-1])
    if scene_id < 3000:
        return "train"
    if scene_id < 3250:
        return "val"
    return "test"


def parse_scene(scene, reader_or_root, output_root, ignore_index=-1,
                grid_size=None, fuse_prsp=True, fuse_pano=True,
                parse_rgbd=False, plugin_rgbd=False):
    """Process one scene (reference parse_scene, :159-410)."""
    import torch

    assert fuse_prsp or fuse_pano or parse_rgbd or plugin_rgbd
    if isinstance(reader_or_root, Structured3DReader):
        reader = reader_or_root
    else:
        reader = Structured3DReader(
            [
                os.path.join(reader_or_root, f)
                for f in os.listdir(reader_or_root)
                if f.endswith(".zip")
            ]
        )
    split = scene_split(scene)
    scene_out = os.path.join(output_root, split, os.path.basename(scene))
    os.makedirs(scene_out, exist_ok=True)
    rooms = reader.listdir(f"Structured3D/{scene}/2D_rendering")
    for room in rooms:
        room_path = f"Structured3D/{scene}/2D_rendering/{room}"
        coords, colors, normals, segments = [], [], [], []

        if fuse_prsp or parse_rgbd or plugin_rgbd:
            prsp_path = f"{room_path}/perspective/full"
            for frame in reader.listdir(prsp_path):
                try:
                    cam_r, cam_t, cam_f = reader.read_camera(
                        f"{prsp_path}/{frame}/camera_pose.txt"
                    )
                    depth = reader.read_depth(f"{prsp_path}/{frame}/depth.png")
                    color = reader.read_color(
                        f"{prsp_path}/{frame}/rgb_rawlight.png"
                    )
                    segment = reader.read_segment(
                        f"{prsp_path}/{frame}/semantic.png"
                    )
                except Exception:
                    print(f"Skipping {scene}_room{room}_frame{frame} "
                          "perspective view due to loading error")
                    continue
                fx, fy = cam_f
                h, w = depth.shape[:2]
                pixel = np.transpose(np.indices((w, h)), (2, 1, 0)).reshape(
                    -1, 2
                )
                pixel = np.hstack([pixel, np.ones((len(pixel), 1))])
                k = np.diag([1.0, 1.0, 1.0])
                k[0, 2] = w / 2
                k[1, 2] = h / 2
                k[0, 0] = k[0, 2] / np.tan(fx)
                k[1, 1] = k[1, 2] / np.tan(fy)
                coord = (
                    depth.reshape(-1, 1) * (np.linalg.inv(k) @ pixel.T).T
                ).reshape(h, w, 3)
                coord = coord @ _PRSP_AXES
                normal = normal_from_cross_product(coord)
                # validity: grazing-incidence + invalid-depth + void-semantic
                view_dist = np.maximum(
                    np.linalg.norm(coord, axis=-1, keepdims=True), 1e-4
                )
                cosine = np.abs(
                    np.sum(coord * normal / view_dist, axis=-1, keepdims=True)
                )
                mask = (
                    (cosine > 0.15) & (depth < 65535) & (segment > 0)
                )[..., 0].reshape(-1)

                if fuse_prsp:
                    coord_w = coord / 1000.0 @ cam_r.T + cam_t
                    normal_w = normal_from_cross_product(coord_w)

                if parse_rgbd or plugin_rgbd:
                    d2 = depth[:, :, 0]
                    extrinsic = np.eye(4)
                    extrinsic[:3, :3] = cam_r
                    extrinsic[:3, 3] = cam_t
                    # reference extrinsic convention chain (:263-277)
                    extrinsic = np.array(
                        [[1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0],
                         [0, 0, 0, 1]]
                    ) @ np.linalg.inv(
                        np.array(
                            [[0, 0, 1, 0], [0, -1, 0, 0], [1, 0, 0, 0],
                             [0, 0, 0, 1]]
                        ) @ np.linalg.inv(extrinsic)
                    )
                    semantic_map = _remap25(segment, ignore_index)[..., 0]

                if mask.sum() > 0:
                    if fuse_prsp:
                        coords.append(coord_w.reshape(-1, 3)[mask])
                        colors.append(color.reshape(-1, 3)[mask])
                        normals.append(normal_w.reshape(-1, 3)[mask])
                        segments.append(segment.reshape(-1, 1)[mask])
                    if parse_rgbd or plugin_rgbd:
                        rgbd = dict(
                            intrinsic=k, extrinsic=extrinsic, rgb=color,
                            depth=d2,
                            depth_mask=mask.reshape(h, w),
                            semantic_map=semantic_map,
                        )
                        rgbd_dir = os.path.join(scene_out,
                                                f"room_{room}_rgbd")
                        os.makedirs(rgbd_dir, exist_ok=True)
                        torch.save(
                            rgbd, os.path.join(rgbd_dir,
                                               f"frame_{frame}.pth")
                        )
                else:
                    print(f"Skipping {scene}_room{room}_frame{frame} "
                          "perspective view: all points filtered")

        if plugin_rgbd:  # RGB-D-only extraction mode
            continue

        if fuse_pano:
            pano_path = f"{room_path}/panorama"
            try:
                _, cam_t, _ = reader.read_camera(
                    f"{pano_path}/camera_xyz.txt"
                )
                depth = reader.read_depth(f"{pano_path}/full/depth.png")
                color = reader.read_color(f"{pano_path}/full/rgb_rawlight.png")
                segment = reader.read_segment(f"{pano_path}/full/semantic.png")
            except Exception:
                print(f"Skipping {scene}_room{room} panorama view due to "
                      "loading error")
            else:
                p_h, p_w = depth.shape[:2]
                p_a = (np.arange(p_w, dtype=np.float32) / p_w * 2 * np.pi
                       - np.pi)
                p_b = (np.arange(p_h, dtype=np.float32) / p_h * np.pi * -1
                       + np.pi / 2)
                p_a = np.tile(p_a[None], [p_h, 1])[..., None]
                p_b = np.tile(p_b[:, None], [1, p_w])[..., None]
                x = depth * np.cos(p_a) * np.cos(p_b)
                y = depth * np.sin(p_b)
                z = depth * np.sin(p_a) * np.cos(p_b)
                coord = np.concatenate([x, y, z], axis=-1) / 1000.0
                normal = normal_from_cross_product(coord)
                view_dist = np.maximum(
                    np.linalg.norm(coord, axis=-1, keepdims=True), 1e-4
                )
                cosine = np.abs(
                    np.sum(coord * normal / view_dist, axis=-1, keepdims=True)
                )
                mask = (
                    (cosine > 0.15) & (depth < 65535) & (segment > 0)
                )[..., 0].reshape(-1)
                coord = coord + cam_t
                if mask.sum() > 0:
                    coords.append(coord.reshape(-1, 3)[mask])
                    colors.append(color.reshape(-1, 3)[mask])
                    normals.append(normal.reshape(-1, 3)[mask])
                    segments.append(segment.reshape(-1, 1)[mask])
                else:
                    print(f"Skipping {scene}_room{room} panorama: all points "
                          "filtered")

        if coords:
            coord = np.concatenate(coords, axis=0) @ _SWAP_YZ
            color = np.concatenate(colors, axis=0)
            normal = np.concatenate(normals, axis=0) @ _SWAP_YZ
            segment = np.concatenate(segments, axis=0)
            data_dict = dict(
                coord=coord.astype(np.float32),
                color=color.astype(np.uint8),
                normal=normal.astype(np.float32),
                semantic_gt=_remap25(segment, ignore_index).astype(np.int16),
            )
            if grid_size is not None:
                from ..transform import GridSample

                data_dict = GridSample(
                    grid_size=grid_size,
                    keys=("coord", "color", "normal", "semantic_gt"),
                )(data_dict)
            torch.save(data_dict, os.path.join(scene_out,
                                               f"room_{room}.pth"))
        else:
            print(f"Skipping {scene}_room{room}: no valid points")
    return scene


# Back-compat shim for the earlier single-zip entry point
def parse_scene_zip(zip_path: str, output_root: str, split: str = None,
                    **kwargs):
    scene = os.path.splitext(os.path.basename(zip_path))[0]
    if scene.startswith("Structured3D_"):
        scene = scene[len("Structured3D_"):]
    reader = Structured3DReader([zip_path])
    return parse_scene(scene, reader, output_root, **kwargs)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--dataset_root", required=True,
                   help="dir with Structured3D zips")
    p.add_argument("--output_root", required=True)
    p.add_argument("--grid_size", type=float, default=None)
    p.add_argument("--ignore_index", type=int, default=-1)
    p.add_argument("--fuse_prsp", action="store_true", default=True)
    p.add_argument("--no_fuse_prsp", dest="fuse_prsp", action="store_false")
    p.add_argument("--fuse_pano", action="store_true", default=True)
    p.add_argument("--no_fuse_pano", dest="fuse_pano", action="store_false")
    p.add_argument("--parse_rgbd", action="store_true")
    p.add_argument("--plugin_rgbd", action="store_true")
    p.add_argument("--num_workers", type=int, default=8)
    args = p.parse_args()

    reader = Structured3DReader(
        [
            os.path.join(args.dataset_root, f)
            for f in os.listdir(args.dataset_root)
            if f.endswith(".zip")
        ]
    )
    scenes = sorted(
        {
            n.split("/")[1]
            for n in reader.filelist()
            if n.startswith("Structured3D/scene_")
        }
    )
    for scene in scenes:
        parse_scene(
            scene, reader, args.output_root,
            ignore_index=args.ignore_index, grid_size=args.grid_size,
            fuse_prsp=args.fuse_prsp, fuse_pano=args.fuse_pano,
            parse_rgbd=args.parse_rgbd, plugin_rgbd=args.plugin_rgbd,
        )


if __name__ == "__main__":
    main()
