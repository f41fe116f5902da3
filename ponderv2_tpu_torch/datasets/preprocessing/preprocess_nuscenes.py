"""Offline nuScenes info-pickle generation (lidar paths, lidarseg, sweeps,
camera infos with sensor->lidar transforms, GT boxes).

Reference contract: the reference's ponder/datasets/preprocessing/nuscenes/
preprocess_nuscenes_info.py:155-529. Faithful pieces: per-sample infos with
``ego2lidar``/``global2ego`` transforms; up to ``max_sweeps`` previous lidar
sweeps, each with the ``obtain_sensor2top`` transform chain
(ego2lidar @ global2ego @ ego2global @ sensor2ego); per-camera infos (and
camera sweeps) with intrinsics; GT boxes in the lidar frame
(center, dxdydz, yaw, vx, vy) filtered to annotations with lidar/radar hits,
with the general->detection name map; lidarseg label paths.

The transform/box math lives in pure-numpy helpers so it is testable without
the nuscenes-devkit (only ``build_infos`` needs the devkit + raw dataset).

A copy of ``ponderv2_tpu/datasets/preprocessing/preprocess_nuscenes.py``
(the functions and tables unchanged); nuscenes-devkit is not among the
port's requirements, so ``build_infos`` exits naming it where it is missing.
"""

from __future__ import annotations

import argparse
import os
import pickle
from functools import reduce
from typing import Dict, Optional

import numpy as np

CAMERA_TYPES = (
    "CAM_FRONT", "CAM_FRONT_RIGHT", "CAM_FRONT_LEFT",
    "CAM_BACK", "CAM_BACK_LEFT", "CAM_BACK_RIGHT",
)

# benchmark-defined general -> detection name map (reference :14-38)
MAP_NAME_FROM_GENERAL_TO_DETECTION = {
    "human.pedestrian.adult": "pedestrian",
    "human.pedestrian.child": "pedestrian",
    "human.pedestrian.wheelchair": "ignore",
    "human.pedestrian.stroller": "ignore",
    "human.pedestrian.personal_mobility": "ignore",
    "human.pedestrian.police_officer": "pedestrian",
    "human.pedestrian.construction_worker": "pedestrian",
    "animal": "ignore",
    "vehicle.car": "car",
    "vehicle.motorcycle": "motorcycle",
    "vehicle.bicycle": "bicycle",
    "vehicle.bus.bendy": "bus",
    "vehicle.bus.rigid": "bus",
    "vehicle.truck": "truck",
    "vehicle.construction": "construction_vehicle",
    "vehicle.emergency.ambulance": "ignore",
    "vehicle.emergency.police": "ignore",
    "vehicle.trailer": "trailer",
    "movable_object.barrier": "barrier",
    "movable_object.trafficcone": "traffic_cone",
    "movable_object.pushable_pullable": "ignore",
    "movable_object.debris": "ignore",
    "static_object.bicycle_rack": "ignore",
}


# ------------------------------------------------------------ pure-numpy math

def quat_to_matrix(q) -> np.ndarray:
    """Unit quaternion (w, x, y, z) -> 3x3 rotation matrix."""
    w, x, y, z = (float(v) for v in q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def transform_matrix(translation, rotation_quat, inverse: bool = False
                     ) -> np.ndarray:
    """4x4 homogeneous transform from translation + quaternion (the
    nuscenes-devkit convention used throughout the reference)."""
    R = quat_to_matrix(rotation_quat)
    t = np.asarray(translation, np.float64)
    tm = np.eye(4)
    if inverse:
        tm[:3, :3] = R.T
        tm[:3, 3] = -R.T @ t
    else:
        tm[:3, :3] = R
        tm[:3, 3] = t
    return tm


def quaternion_yaw(q) -> float:
    """Yaw of a box orientation quaternion (reference :225-240)."""
    v = quat_to_matrix(q) @ np.array([1.0, 0.0, 0.0])
    return float(np.arctan2(v[1], v[0]))


def sensor2top_transform(cs_translation, cs_rotation, pose_translation,
                         pose_rotation, ego2lidar, global2ego):
    """sensor -> top-lidar RT chain (reference obtain_sensor2top, :243-277).

    Returns (sensor2ego, ego2global, sensor2lidar)."""
    sensor2ego = transform_matrix(cs_translation, cs_rotation, inverse=False)
    ego2global = transform_matrix(pose_translation, pose_rotation,
                                  inverse=False)
    sensor2lidar = reduce(np.dot, [ego2lidar, global2ego, ego2global,
                                   sensor2ego])
    return sensor2ego, ego2global, sensor2lidar


def gt_boxes_from_annotations(boxes, annotations):
    """GT box array in the lidar frame (reference :383-407): rows are
    [x y z dx dy dz yaw vx vy]; filtered to annotations with at least one
    lidar or radar point; names mapped general->detection.

    ``boxes``: list of dicts with center (3,), wlh (3,), velocity (3,),
    orientation quaternion (4,), name, token — already transformed into the
    lidar frame (the devkit's get_sample_data does this).
    """
    if not boxes:
        z = np.zeros((0,))
        return dict(gt_boxes=np.zeros((0, 9)), gt_boxes_velocity=np.zeros(
            (0, 3)), gt_names=np.zeros((0,), dtype=object),
            gt_boxes_token=np.zeros((0,), dtype=object),
            num_lidar_pts=z, num_radar_pts=z)
    num_lidar = np.array([a["num_lidar_pts"] for a in annotations])
    num_radar = np.array([a["num_radar_pts"] for a in annotations])
    mask = num_lidar + num_radar > 0
    locs = np.array([b["center"] for b in boxes]).reshape(-1, 3)
    # wlh -> dx dy dz (lwh)
    dims = np.array([b["wlh"] for b in boxes]).reshape(-1, 3)[:, [1, 0, 2]]
    velocity = np.array([b["velocity"] for b in boxes]).reshape(-1, 3)
    rots = np.array(
        [quaternion_yaw(b["orientation"]) for b in boxes]
    ).reshape(-1, 1)
    names = np.array([
        MAP_NAME_FROM_GENERAL_TO_DETECTION.get(b["name"], "ignore")
        for b in boxes
    ])
    tokens = np.array([b["token"] for b in boxes])
    gt_boxes = np.concatenate([locs, dims, rots, velocity[:, :2]], axis=1)
    return dict(
        gt_boxes=gt_boxes[mask],
        gt_boxes_velocity=velocity[mask],
        gt_names=names[mask],
        gt_boxes_token=tokens[mask],
        num_lidar_pts=num_lidar[mask],
        num_radar_pts=num_radar[mask],
    )


# --------------------------------------------------------- devkit-driven CLI

def _obtain_sensor2top(nusc, sensor_token, ego2lidar, global2ego, data_path,
                       sensor_type="lidar"):
    sd_rec = nusc.get("sample_data", sensor_token)
    cs_rec = nusc.get("calibrated_sensor", sd_rec["calibrated_sensor_token"])
    pose_rec = nusc.get("ego_pose", sd_rec["ego_pose_token"])
    sensor2ego, ego2global, sensor2lidar = sensor2top_transform(
        cs_rec["translation"], cs_rec["rotation"],
        pose_rec["translation"], pose_rec["rotation"], ego2lidar, global2ego,
    )
    return dict(
        data_path=os.path.relpath(
            str(nusc.get_sample_data_path(sd_rec["token"])), data_path
        ),
        type=sensor_type,
        sample_data_token=sd_rec["token"],
        ego2global=ego2global,
        sensor2ego=sensor2ego,
        sensor2lidar=sensor2lidar,
        timestamp=1e-6 * sd_rec["timestamp"],
    )


def build_infos(dataset_root: str, output_root: str, max_sweeps: int = 10,
                with_camera: bool = False, version: str = "v1.0-trainval"):
    try:
        from nuscenes.nuscenes import NuScenes
        from nuscenes.utils import splits
    except ImportError as e:
        raise SystemExit(
            "nuscenes-devkit required: run preprocessing on a machine with it "
            "installed (the training job only reads the emitted pickles)"
        ) from e

    nusc = NuScenes(version=version, dataroot=dataset_root, verbose=True)
    train_scenes = {
        s["token"] for s in nusc.scene if s["name"] in set(splits.train)
    }
    train_infos, val_infos = [], []

    for sample in nusc.sample:
        lidar_token = sample["data"]["LIDAR_TOP"]
        sd_rec = nusc.get("sample_data", lidar_token)
        cs_rec = nusc.get("calibrated_sensor",
                          sd_rec["calibrated_sensor_token"])
        pose_rec = nusc.get("ego_pose", sd_rec["ego_pose_token"])
        lidar_path, boxes, _ = nusc.get_sample_data(lidar_token)

        ego2lidar = transform_matrix(cs_rec["translation"],
                                     cs_rec["rotation"], inverse=True)
        global2ego = transform_matrix(pose_rec["translation"],
                                      pose_rec["rotation"], inverse=True)
        info = dict(
            lidar_path=os.path.relpath(str(lidar_path), dataset_root),
            lidar_token=lidar_token,
            token=sample["token"],
            sweeps=[],
            ego2lidar=ego2lidar,
            global2ego=global2ego,
            timestamp=1e-6 * sd_rec["timestamp"],
        )
        if with_camera:
            info["cams"] = {}
            info["cam_sweeps"] = {}
            for cam in CAMERA_TYPES:
                cam_token = sample["data"][cam]
                _, _, cam_intrinsic = nusc.get_sample_data(cam_token)
                cam_info = _obtain_sensor2top(
                    nusc, cam_token, ego2lidar, global2ego, dataset_root, cam
                )
                cam_info["cam_intrinsic"] = cam_intrinsic
                # back-compat matrices for the dataset loader
                l2c = np.linalg.inv(cam_info["sensor2lidar"])
                P = np.eye(4)
                P[:3, :3] = cam_intrinsic
                cam_info["lidar2cam"] = l2c
                cam_info["lidar2img"] = P @ l2c
                info["cams"][cam] = cam_info
                # camera sweeps (reference :355-379)
                cam_rec = nusc.get("sample_data", cam_token)
                cam_sweeps = []
                while len(cam_sweeps) < max_sweeps and cam_rec["prev"]:
                    cam_rec = nusc.get("sample_data", cam_rec["prev"])
                    sweep = _obtain_sensor2top(
                        nusc, cam_rec["token"], ego2lidar, global2ego,
                        dataset_root, cam,
                    )
                    _, _, intr = nusc.get_sample_data(cam_rec["token"])
                    sweep["cam_intrinsic"] = intr
                    cam_sweeps.append(sweep)
                info["cam_sweeps"][cam] = cam_sweeps

        # previous lidar sweeps (reference :337-353)
        sweep_rec = sd_rec
        while len(info["sweeps"]) < max_sweeps and sweep_rec["prev"]:
            info["sweeps"].append(_obtain_sensor2top(
                nusc, sweep_rec["prev"], ego2lidar, global2ego, dataset_root,
                "lidar",
            ))
            sweep_rec = nusc.get("sample_data", sweep_rec["prev"])

        annotations = [
            nusc.get("sample_annotation", t) for t in sample["anns"]
        ]
        box_dicts = [
            dict(center=b.center, wlh=b.wlh,
                 velocity=nusc.box_velocity(b.token),
                 orientation=list(b.orientation), name=b.name, token=b.token)
            for b in boxes
        ]
        info.update(gt_boxes_from_annotations(box_dicts, annotations))
        if "lidarseg" in getattr(nusc, "table_names", ()):
            info["gt_segment_path"] = nusc.get("lidarseg",
                                               lidar_token)["filename"]

        (train_infos if sample["scene_token"] in train_scenes
         else val_infos).append(info)

    os.makedirs(os.path.join(output_root, "info"), exist_ok=True)
    for split, infos in (("train", train_infos), ("val", val_infos)):
        out = os.path.join(
            output_root, "info",
            f"nuscenes_infos_{max_sweeps}sweeps_{split}.pkl",
        )
        with open(out, "wb") as f:
            pickle.dump(infos, f)
        print(f"{split}: {len(infos)} samples -> {out}")


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--dataset_root", required=True)
    p.add_argument("--output_root", required=True)
    p.add_argument("--max_sweeps", type=int, default=10)
    p.add_argument("--with_camera", action="store_true")
    p.add_argument("--version", default="v1.0-trainval")
    args = p.parse_args()
    build_infos(args.dataset_root, args.output_root, args.max_sweeps,
                args.with_camera, args.version)


if __name__ == "__main__":
    main()
