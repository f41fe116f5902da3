"""Offline S3DIS preprocessing: Stanford3dDataset rooms -> .pth dicts
(+ optional per-view RGB-D dicts for the rendering-pretrain datasets).

Reference contract:
the reference's ponder/datasets/preprocessing/s3dis/preprocess_s3dis.py:1-470.
Per room: concatenated Annotations/<object>_<i>.txt point clouds with
semantic_gt (13 classes, unknown names -> clutter) and per-object instance_gt,
optional alignment-angle rotation about the room center, optional mesh-derived
normals, and — with the raw Stanford2d3d dataset — per-view RGB-D dicts
(undistorted rgb/depth, depth_mask + semantic_map from unprojection against the
room cloud).

A copy of ``ponderv2_tpu/datasets/preprocessing/preprocess_s3dis.py`` but
for ``parse_room_rgbd``, which reads the 2D-3D-S ``.jpg`` / ``.png`` views
through ``datasets/image_io.py`` (the port's codec; PIL's pixels) in place
of PIL, and ``--point_normals`` (``parse_room``'s ``point_normals``): the
S3DIS SpUNet and pretrain recipes read ``normal``, which the JAX
preprocessor writes only from 2D-3D-S's meshes through open3d and trimesh
(``--parse_normal``), neither installed where the card is; with it each
point's normal is estimated from its nearest room points
(``estimate_point_normals``).

    python -m ponderv2_tpu_torch.datasets.preprocessing.preprocess_s3dis \
        --dataset_root DIR --output_root DIR [--raw_root DIR --parse_rgbd] \
        [--align_angle] [--num_workers N]

Environment notes (divergences by necessity, not semantics):
- image IO uses the port's codec instead of cv2; undistortion is a numpy Brown-Conrady
  remap (bilinear for rgb, nearest for depth) equivalent to cv2.undistort;
- mesh normals need open3d + trimesh (same as the reference) and are skipped
  with a warning when unavailable.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import warnings
from collections import defaultdict

import numpy as np

from ..image_io import read_image

CLASS_NAMES = (
    "ceiling", "floor", "wall", "beam", "column", "window", "door", "table",
    "chair", "sofa", "bookcase", "board", "clutter",
)
CLASS2ID = {n: i for i, n in enumerate(CLASS_NAMES)}

# reference preprocess_s3dis.py:258-268: area 5b raw poses live in a different
# world frame; this fixed transform moves them into the aligned area-5 frame
AREA_5B_POSE_FIX = np.array(
    [[0, 1, 0, -4.09703582], [-1, 0, 0, 6.22617759], [0, 0, 1, 0],
     [0, 0, 0, 1]]
)


def load_alignment(dataset_root):
    """room -> alignment angle, from Area_i_alignmentAngle.txt (reference
    main_process, preprocess_s3dis.py:374-390)."""
    rooms, angles = [], []
    for i in range(1, 7):
        path = os.path.join(dataset_root, f"Area_{i}",
                            f"Area_{i}_alignmentAngle.txt")
        if not os.path.isfile(path):
            continue
        info = np.loadtxt(path, dtype=str, ndmin=2)
        rooms += [os.path.join(f"Area_{i}", r[0]) for r in info]
        angles += [int(r[1]) for r in info]
    return rooms, angles


def _align_rotation(angle_deg):
    angle = (2 - angle_deg / 180) * np.pi
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])


def parse_room_points(room_dir, angle, align_angle=True, parse_normal=False,
                      area_mesh=None):
    """Room cloud dict (reference parse_room points branch, :88-205)."""
    ann_files = sorted(glob.glob(os.path.join(room_dir, "Annotations",
                                              "*.txt")))
    coords, colors, segments, instances = [], [], [], []
    for inst_id, fn in enumerate(ann_files):
        cls_name = os.path.basename(fn).split("_")[0]
        # some rooms carry extra names ('stairs') -> clutter (reference :136)
        cls = CLASS2ID.get(cls_name, CLASS2ID["clutter"])
        data = np.loadtxt(fn)
        if data.ndim == 1:
            data = data[None]
        coords.append(data[:, :3])
        colors.append(data[:, 3:6])
        segments.append(np.full(len(data), cls, np.int64))
        instances.append(np.full(len(data), inst_id, np.int64))
    if not coords:
        return None
    coord = np.ascontiguousarray(np.vstack(coords))
    normal = None
    if parse_normal:
        normal = _mesh_normals(coord, area_mesh)
    room_center = (coord.max(0) + coord.min(0)) / 2
    if align_angle:
        rot = _align_rotation(angle)
        coord = (coord - room_center) @ rot.T + room_center
        if normal is not None:
            normal = normal @ rot.T
    out = dict(
        coord=coord.astype(np.float32),
        color=np.ascontiguousarray(np.vstack(colors)).astype(np.float32),
        semantic_gt=np.concatenate(segments).reshape(-1, 1),
        instance_gt=np.concatenate(instances).reshape(-1, 1),
        room_center=room_center,
    )
    if normal is not None:
        out["normal"] = normal.astype(np.float32)
    return out


def _mesh_normals(coords, area_mesh):
    """Mesh-face normals at the nearest surface point (reference :149-178).
    Needs open3d-loaded area mesh cropped by caller + trimesh."""
    if area_mesh is None:
        warnings.warn("parse_normal requested but no mesh available; skipping")
        return None
    import trimesh

    mesh = trimesh.Trimesh(
        vertices=np.asarray(area_mesh.vertices),
        faces=np.asarray(area_mesh.triangles),
        vertex_normals=np.asarray(area_mesh.vertex_normals),
    )
    _, _, face_id = mesh.nearest.on_surface(coords)
    return mesh.face_normals[face_id]


def undistort_image(img, intrinsic, dist, nearest=False):
    """numpy equivalent of cv2.undistort (Brown-Conrady k1 k2 p1 p2 k3):
    for each undistorted pixel, apply the FORWARD distortion model to find its
    source pixel in the distorted image, then sample (bilinear / nearest)."""
    h, w = img.shape[:2]
    fx, fy = intrinsic[0, 0], intrinsic[1, 1]
    cx, cy = intrinsic[0, 2], intrinsic[1, 2]
    k1, k2, p1, p2, k3 = dist
    xs, ys = np.meshgrid(np.arange(w), np.arange(h))
    x = (xs - cx) / fx
    y = (ys - cy) / fy
    r2 = x * x + y * y
    radial = 1 + k1 * r2 + k2 * r2**2 + k3 * r2**3
    x_d = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    y_d = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    u = x_d * fx + cx
    v = y_d * fy + cy
    if nearest:
        ui = np.clip(np.round(u).astype(int), 0, w - 1)
        vi = np.clip(np.round(v).astype(int), 0, h - 1)
        out = img[vi, ui]
        oob = (u < 0) | (u > w - 1) | (v < 0) | (v > h - 1)
        out = np.where(oob[..., None] if out.ndim == 3 else oob, 0, out)
        return out
    u0 = np.clip(np.floor(u).astype(int), 0, w - 2)
    v0 = np.clip(np.floor(v).astype(int), 0, h - 2)
    du = np.clip(u - u0, 0, 1)[..., None] if img.ndim == 3 else np.clip(u - u0, 0, 1)
    dv = np.clip(v - v0, 0, 1)[..., None] if img.ndim == 3 else np.clip(v - v0, 0, 1)
    imgf = img.astype(np.float64)
    out = (
        imgf[v0, u0] * (1 - du) * (1 - dv)
        + imgf[v0, u0 + 1] * du * (1 - dv)
        + imgf[v0 + 1, u0] * (1 - du) * dv
        + imgf[v0 + 1, u0 + 1] * du * dv
    )
    oob = (u < 0) | (u > w - 1) | (v < 0) | (v > h - 1)
    out = np.where(oob[..., None] if img.ndim == 3 else oob, 0, out)
    return out.astype(img.dtype)


def unproject_filtering_depths(depths, camera_matrix, extrinsic,
                               depth_scale=4000.0, room_coords=None,
                               room_semantic=None, max_dist=0.1):
    """Depth validity mask + per-pixel semantic map by unprojecting to world
    and matching the room cloud (reference :42-88)."""
    from scipy.spatial import KDTree

    depths = depths.astype(np.float64).copy()
    depths[np.isnan(depths)] = 0
    depths[depths >= 65500] = 0
    depths /= depth_scale

    fx, fy = camera_matrix[0, 0], camera_matrix[1, 1]
    cx, cy = camera_matrix[0, 2], camera_matrix[1, 2]
    xmap, ymap = np.meshgrid(np.arange(depths.shape[1]),
                             np.arange(depths.shape[0]))
    pz = depths
    px = (xmap - cx) / fx * pz
    py = (ymap - cy) / fy * pz
    mask = (pz > 0.0).reshape(-1)
    points = np.stack([px, py, pz], axis=-1).reshape(-1, 3)
    points_h = np.concatenate([points, np.ones((len(points), 1))], axis=1)
    world = (extrinsic @ points_h.T).T
    world = world[:, :3] / world[:, 3:4]

    kdtree = KDTree(room_coords)
    dists, indices = kdtree.query(world, workers=-1)
    mask = mask & (dists < max_dist)
    semantic_map = np.asarray(room_semantic).reshape(-1)[indices].reshape(
        depths.shape
    )
    depth_mask = mask.reshape(depths.shape)
    semantic_map = np.where(depth_mask, semantic_map, -1)
    return depth_mask, semantic_map


def parse_room_rgbd(room, raw_root, output_root, room_coords, room_semantic,
                    room_center, angle, align_angle=True):
    """Per-view RGB-D dicts for one room (reference :206-335): resolve the
    room's camera uuids via 3d/camera_to_room.json, read pose/intrinsics txt,
    undistort rgb/depth, compute depth_mask + semantic_map, save
    {room}_rgbd/{uuid}_{pitch}_{yaw}.pth."""
    import torch

    area_idx = int(room.split("/")[0].split("_")[1])
    area_indices = [area_idx] if area_idx != 5 else ["5a", "5b"]
    rot = _align_rotation(angle) if align_angle else None
    n_views = 0
    for area_index in area_indices:
        cam_json = os.path.join(raw_root, f"area_{area_index}", "3d",
                                "camera_to_room.json")
        if not os.path.isfile(cam_json):
            continue
        cam2room = json.load(open(cam_json))
        room2cam = defaultdict(list)
        for k, v in cam2room.items():
            room2cam[v].append(k)
        key_area = area_index if isinstance(area_index, int) else int(
            area_index[0]
        )
        uuids = room2cam[f"{room.split('/')[1]}_{key_area}"]
        for uuid in uuids:
            pose_paths = glob.glob(
                os.path.join(raw_root, f"area_{area_index}", "raw",
                             f"{uuid}_pose_*.txt")
            )
            for pose_path in pose_paths:
                try:
                    uuid, _, pitch, yaw = (
                        os.path.basename(pose_path).split(".")[0].split("_")
                    )
                    raw_dir = os.path.join(raw_root, f"area_{area_index}",
                                           "raw")
                    intr = np.loadtxt(
                        os.path.join(raw_dir, f"{uuid}_intrinsics_{pitch}.txt")
                    )
                    h, w, fx, fy, cx, cy, k1, k2, p1, p2, k3 = intr
                    intrinsic = np.array(
                        [[fx, 0, cx], [0, fy, cy], [0, 0, 1]]
                    )
                    pose = np.loadtxt(pose_path)
                    if area_index == "5b":
                        pose = AREA_5B_POSE_FIX @ pose
                    if align_angle:
                        S1, S2, S3 = np.eye(4), np.eye(4), np.eye(4)
                        S1[:3, 3] = -room_center
                        S2[:3, :3] = rot
                        S3[:3, 3] = room_center
                        pose = S3 @ S2 @ S1 @ pose
                    rgb = read_image(
                        os.path.join(raw_dir, f"{uuid}_i{pitch}_{yaw}.jpg"), rgb=True)
                    depth = read_image(
                        os.path.join(raw_dir, f"{uuid}_d{pitch}_{yaw}.png"))
                    dist = (k1, k2, p1, p2, k3)
                    und_rgb = undistort_image(rgb, intrinsic, dist)
                    und_depth = undistort_image(depth, intrinsic, dist,
                                                nearest=True)
                    depth_mask, semantic_map = unproject_filtering_depths(
                        und_depth.astype(float), intrinsic, pose,
                        depth_scale=4000.0, room_coords=room_coords,
                        room_semantic=room_semantic,
                    )
                    rgbd = dict(
                        intrinsic=intrinsic, extrinsic=pose, rgb=und_rgb,
                        depth=und_depth, depth_mask=depth_mask,
                        semantic_map=semantic_map,
                    )
                    save = os.path.join(output_root, f"{room}_rgbd",
                                        f"{uuid}_{pitch}_{yaw}.pth")
                    os.makedirs(os.path.dirname(save), exist_ok=True)
                    torch.save(rgbd, save)
                    n_views += 1
                except Exception as e:  # skip broken views like the reference
                    print(f"Skip {pose_path}. Error: {e}")
                    continue
    return n_views


def estimate_point_normals(coord, center, k=16):
    """Per point, the unit normal of the plane through its ``k`` nearest
    room points (the smallest principal axis of their covariance), turned
    toward ``center``: S3DIS's recipes read ``normal``, and the mesh path
    (``_mesh_normals``) needs open3d and trimesh."""
    from scipy.spatial import cKDTree

    coord = np.asarray(coord, np.float64)
    _, idx = cKDTree(coord).query(coord, k=min(k, len(coord)), workers=-1)
    nbr = coord[idx] - coord[idx].mean(axis=1, keepdims=True)
    _, vecs = np.linalg.eigh(np.einsum("nki,nkj->nij", nbr, nbr))
    normal = vecs[:, :, 0]
    flip = np.einsum("ni,ni->n", normal, np.asarray(center) - coord) < 0
    normal[flip] *= -1
    return normal.astype(np.float32)


def parse_room(room, angle, dataset_root, raw_root, output_root,
               align_angle=True, parse_normal=False, parse_rgbd=False,
               area_mesh=None, point_normals=False):
    print(f"Parsing: {room}")
    import torch

    save_path = os.path.join(output_root, room) + ".pth"
    os.makedirs(os.path.dirname(save_path), exist_ok=True)
    out = parse_room_points(
        os.path.join(dataset_root, room), angle, align_angle=align_angle,
        parse_normal=parse_normal, area_mesh=area_mesh,
    )
    if out is None:
        return None
    if point_normals and "normal" not in out:
        out["normal"] = estimate_point_normals(out["coord"], out["room_center"])
    torch.save(out, save_path)
    if parse_rgbd and raw_root:
        parse_room_rgbd(
            room, raw_root, output_root, out["coord"], out["semantic_gt"],
            out["room_center"], angle, align_angle=align_angle,
        )
    return room


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--dataset_root", required=True,
                   help="Stanford3dDataset_v1.2(_Aligned_Version) root")
    p.add_argument("--output_root", required=True)
    p.add_argument("--raw_root", default=None,
                   help="Stanford2d3dDataset_noXYZ root (RGB-D / normals)")
    p.add_argument("--align_angle", action="store_true")
    p.add_argument("--parse_normal", action="store_true")
    p.add_argument("--parse_rgbd", action="store_true")
    p.add_argument("--point_normals", action="store_true",
                   help="normals from each point's nearest room points, where the "
                        "mesh normals (--parse_normal: open3d + trimesh) are not made")
    p.add_argument("--num_workers", type=int, default=8)
    args = p.parse_args()

    rooms, angles = load_alignment(args.dataset_root)
    if not rooms:  # datasets without alignment files: plain directory walk
        rooms = [
            os.path.relpath(r, args.dataset_root)
            for r in sorted(glob.glob(os.path.join(args.dataset_root,
                                                   "Area_*", "*")))
            if os.path.isdir(r)
        ]
        angles = [0] * len(rooms)

    meshes = {}
    if args.parse_normal:
        try:
            import open3d

            for i in range(1, 7):
                mesh_dir = os.path.join(args.raw_root, f"area_{i}", "3d",
                                        "rgb.obj")
                if os.path.isfile(mesh_dir):
                    m = open3d.io.read_triangle_mesh(mesh_dir)
                    m.compute_vertex_normals()
                    meshes[f"Area_{i}"] = m
        except ImportError:
            warnings.warn("open3d unavailable; normals skipped")

    from concurrent.futures import ProcessPoolExecutor

    with ProcessPoolExecutor(max_workers=args.num_workers) as ex:
        futs = [
            ex.submit(
                parse_room, room, angle, args.dataset_root, args.raw_root,
                args.output_root, args.align_angle, args.parse_normal,
                args.parse_rgbd, meshes.get(room.split("/")[0]), args.point_normals,
            )
            for room, angle in zip(rooms, angles)
        ]
        for f in futs:
            f.result()


if __name__ == "__main__":
    main()
