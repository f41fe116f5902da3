"""Procedural raw ScanNet, S3DIS and Structured3D files, in the layouts the
preprocessors read.

No dataset is in the repository. These writers draw rooms from a seed with
numpy and write them as each dataset's download holds them, at its real
widths (only the counts of scenes, rooms and frames are the caller's):

- ScanNet (``write_scannet_scene``, ``write_scannet_meta``):
  ``scans/<scene>/<scene>_vh_clean_2.ply`` (binary PLY, ``vertices`` mesh
  vertices and about twice as many faces: floor, walls and furniture boxes as
  grids of triangles), ``_vh_clean_2.labels.ply`` (nyu40 ``label`` per
  vertex), ``_vh_clean_2.0.010000.segs.json``, ``.aggregation.json`` (one
  group per object, raw category names), ``<scene>.sens`` (``frames`` frames:
  1296 x 968 JPEG color, 640 x 480 zlib depth in mm, poses, ScanNet's
  intrinsics), ``<scene>_2d-label-filt.zip`` (1296 x 968 16-bit label images
  of ScanNet ids) and ``<scene>.txt`` (axisAlignment); beside ``scans/``,
  ``scannetv2-labels.combined.tsv`` and ``scannetv2_{train,val}.txt``.
- S3DIS (``write_s3dis_room``): ``Area_<a>/<room>/Annotations/<class>_<i>.txt``
  (x y z r g b, ``points`` in all), ``Area_<a>/Area_<a>_alignmentAngle.txt``
  and, with ``views``, the 2D-3D-S frames ``parse_room_rgbd`` reads:
  ``area_<a>/3d/camera_to_room.json``, ``area_<a>/raw/<uuid>_pose_<p>_<y>.txt``,
  ``<uuid>_intrinsics_<p>.txt``, ``<uuid>_i<p>_<y>.jpg`` and 16-bit
  ``<uuid>_d<p>_<y>.png`` (1/4000 m) at 1080 x 1080.
- Structured3D (``write_structured3d_zip``): ``Structured3D_<scene>.zip``
  holding per room a 1024 x 512 panorama and ``perspective`` 1280 x 720 views
  (``rgb_rawlight.png``, 16-bit ``depth.png`` in mm, 8-bit ``semantic.png`` of
  nyu40 ids, ``camera_xyz.txt`` / ``camera_pose.txt``).

Every depth is the distance to the room's box (floor, walls, ceiling) along
the pixel's ray, so views and clouds agree; colours are a texture per
surface plus noise. Images are written by ``datasets/image_io.py``.
"""

from __future__ import annotations

import io
import json
import os
import zipfile
import zlib
from typing import Dict, List, Tuple

import numpy as np

from ..image_io import encode_jpeg, encode_png, write_jpeg, write_png
from .ply import write_ply
from .scannet200_constants import CLASS_LABELS_200, VALID_CLASS_IDS_200
from .sensor_data import SensFrame, SensStream

SCANNET_COLOR_HW = (968, 1296)
SCANNET_DEPTH_HW = (480, 640)
# ScanNet's typical intrinsics (scene0000_00)
SCANNET_COLOR_K = (1170.187988, 1170.187988, 647.75, 483.75)
SCANNET_DEPTH_K = (577.870605, 577.870605, 319.5, 239.5)
S3DIS_VIEW_HW = (1080, 1080)
S3D_PANO_HW = (512, 1024)
S3D_PERSP_HW = (720, 1280)

# raw category -> nyu40 id; the ScanNet id is its place in ScanNet200's table
SCANNET_CATEGORIES = {
    "wall": 1, "floor": 2, "cabinet": 3, "bed": 4, "chair": 5, "couch": 6,
    "table": 7, "door": 8, "window": 9, "bookshelf": 10, "picture": 11, "desk": 14,
}
FURNITURE = ("chair", "table", "cabinet", "bed", "couch", "desk", "bookshelf", "door")
S3DIS_OBJECTS = ("table", "chair", "chair", "bookcase", "board", "door", "window", "clutter")


def scannet_id(category: str) -> int:
    return VALID_CLASS_IDS_200[CLASS_LABELS_200.index(category)]


def box_hits(origin: np.ndarray, dirs: np.ndarray, size) -> Tuple[np.ndarray, np.ndarray]:
    """The ray parameter and plane where each ray from ``origin`` (inside
    the box [0, size]) along ``dirs`` (..., 3, z up) leaves the box; the
    planes are 0 floor, 1 ceiling, 2-5 the walls at x = 0, x = X, y = 0 and
    y = Y."""
    t = np.full(dirs.shape[:-1] + (6,), np.inf)
    with np.errstate(divide="ignore", invalid="ignore"):
        for plane, (axis, bound) in enumerate(((2, 0.0), (2, size[2]), (0, 0.0), (0, size[0]),
                                               (1, 0.0), (1, size[1]))):
            tp = (bound - origin[axis]) / dirs[..., axis]
            t[..., plane] = np.where(tp > 1e-6, tp, np.inf)
    plane = t.argmin(-1)
    return np.take_along_axis(t, plane[..., None], -1)[..., 0], plane


def surface_color(rng, points: np.ndarray, plane: np.ndarray) -> np.ndarray:
    """A texture per box plane: stripes of the plane's base colour, noise on
    top."""
    base = np.array([[150, 120, 90], [230, 230, 225], [200, 190, 170], [190, 200, 180],
                     [180, 180, 200], [205, 185, 185]], np.float64)
    stripe = np.sin(points[..., 0] * 3.1 + points[..., 1] * 2.3 + points[..., 2] * 4.7) * 25
    noise = rng.randint(-12, 13, points.shape)
    return np.clip(base[plane] + stripe[..., None] + noise, 0, 255).astype(np.uint8)


def camera_rays(hw, k, cam2world: np.ndarray) -> np.ndarray:
    """World directions (H, W, 3) of the pixels of an OpenCV camera (x right,
    y down, z forward) with intrinsics ``k`` = (fx, fy, cx, cy); a unit step
    is a unit of camera depth."""
    fx, fy, cx, cy = k
    v, u = np.mgrid[:hw[0], :hw[1]].astype(np.float64)
    d = np.stack([(u - cx) / fx, (v - cy) / fy, np.ones_like(u)], -1)
    return d @ cam2world[:3, :3].T


def look_pose(position, yaw: float, pitch: float) -> np.ndarray:
    """cam2world of an OpenCV camera at ``position`` looking along ``yaw``
    (about z, from +x) tilted down by ``pitch``."""
    fwd = np.array([np.cos(yaw) * np.cos(pitch), np.sin(yaw) * np.cos(pitch), -np.sin(pitch)])
    right = np.cross(fwd, [0.0, 0.0, 1.0])
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    pose = np.eye(4)
    pose[:3, :3] = np.stack([right, down, fwd], 1)
    pose[:3, 3] = position
    return pose


def grid_patch(origin, u, v, spacing: float):
    """A rectangle ``origin + a u + b v`` (a, b in [0, 1]) as a grid of
    vertices about ``spacing`` apart: (vertices, faces)."""
    nu = max(2, int(round(np.linalg.norm(u) / spacing)) + 1)
    nv = max(2, int(round(np.linalg.norm(v) / spacing)) + 1)
    a, b = np.meshgrid(np.linspace(0, 1, nu), np.linspace(0, 1, nv), indexing="ij")
    verts = np.asarray(origin) + a[..., None] * np.asarray(u) + b[..., None] * np.asarray(v)
    idx = np.arange(nu * nv).reshape(nu, nv)
    q = np.stack([idx[:-1, :-1], idx[1:, :-1], idx[1:, 1:], idx[:-1, 1:]], -1).reshape(-1, 4)
    faces = np.concatenate([q[:, [0, 1, 2]], q[:, [0, 2, 3]]])
    return verts.reshape(-1, 3), faces


def room_objects(rng, size, names) -> List[Tuple[str, np.ndarray, np.ndarray]]:
    """Boxes standing on the floor: (name, min corner, max corner)."""
    out = []
    for name in names:
        ext = rng.uniform([0.4, 0.4, 0.4], [1.6, 1.2, 1.8])
        lo = np.r_[rng.uniform(0.2, size[0] - ext[0] - 0.2), rng.uniform(0.2, size[1] - ext[1] - 0.2), 0.0]
        out.append((name, lo, lo + ext))
    return out


def box_faces(lo, hi):
    """The top and four sides of a box as (origin, u, v) rectangles."""
    dx, dy, dz = hi - lo
    ex, ey, ez = np.array([dx, 0, 0]), np.array([0, dy, 0]), np.array([0, 0, dz])
    return [(lo + ez, ex, ey), (lo, ex, ez), (lo + ey, ex, ez), (lo, ey, ez), (lo + ex, ey, ez)]


# ---------------------------------------------------------------- ScanNet

def write_scannet_meta(root: str, splits: Dict[str, List[str]]) -> None:
    """``scannetv2-labels.combined.tsv`` (the categories these rooms use)
    and ``scannetv2_{split}.txt`` under ``root``."""
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "scannetv2-labels.combined.tsv"), "w") as f:
        f.write("id\traw_category\tcategory\tcount\tnyu40id\tnyu40class\n")
        for name, nyu in SCANNET_CATEGORIES.items():
            f.write(f"{scannet_id(name)}\t{name}\t{name}\t1\t{nyu}\t{name}\n")
    for split, scenes in splits.items():
        with open(os.path.join(root, f"scannetv2_{split}.txt"), "w") as f:
            f.write("".join(s + "\n" for s in scenes))


def write_scannet_scene(scans_dir: str, scene: str, seed: int, vertices: int = 150_000,
                        frames: int = 10, frame_hw=SCANNET_COLOR_HW, depth_hw=SCANNET_DEPTH_HW,
                        objects: int = 6) -> Dict[str, int]:
    """One scan's raw files under ``scans_dir/scene`` (module docstring).
    Returns the counts written."""
    rng = np.random.RandomState(seed)
    out = os.path.join(scans_dir, scene)
    os.makedirs(out, exist_ok=True)
    size = rng.uniform([4.0, 3.5, 2.6], [7.0, 6.0, 3.0])
    boxes = room_objects(rng, size, [FURNITURE[(seed + i) % len(FURNITURE)]
                                     for i in range(objects)])
    X, Y, Z = size
    rects = [("floor", [(np.zeros(3), [X, 0, 0], [0, Y, 0])]),
             ("wall", [(np.zeros(3), [X, 0, 0], [0, 0, Z]), (np.array([0, Y, 0]), [X, 0, 0], [0, 0, Z])]),
             ("wall", [(np.zeros(3), [0, Y, 0], [0, 0, Z]), (np.array([X, 0, 0]), [0, Y, 0], [0, 0, Z])])]
    rects += [(name, box_faces(lo, hi)) for name, lo, hi in boxes]
    area = sum(np.linalg.norm(np.cross(u, v)) for _, rs in rects for _, u, v in rs)
    spacing = np.sqrt(area / vertices)
    verts, faces, labels, segs, groups = [], [], [], [], []
    n = seg = 0
    for gi, (name, rs) in enumerate(rects):
        members = []
        for origin, u, v in rs:
            pv, pf = grid_patch(origin, u, v, spacing)
            verts.append(pv)
            faces.append(pf + n)
            # segments: 0.5 m tiles of the rectangle
            tile = np.floor((pv - origin) / 0.5).astype(np.int64) @ np.array([1, 1000, 1000000])
            _, tid = np.unique(tile, return_inverse=True)
            segs.append(tid.reshape(-1) + seg)
            members += list(range(seg, seg + int(tid.max()) + 1))
            seg += int(tid.max()) + 1
            labels.append(np.full(len(pv), SCANNET_CATEGORIES[name], np.uint16))
            n += len(pv)
        # a few tiles of each object stay unannotated, as in ScanNet
        keep = members[: max(1, len(members) - len(members) // 10)]
        groups.append(dict(id=gi, objectId=gi, segments=keep, label=name))
    verts = np.concatenate(verts)
    faces = np.concatenate(faces).astype(np.int32)
    segs = np.concatenate(segs)
    labels = np.concatenate(labels)
    annotated = np.isin(segs, np.concatenate([g["segments"] for g in groups]))
    labels[~annotated] = 0
    plane = np.where(verts[:, 2] < 1e-6, 0, 2)
    color = surface_color(rng, verts, plane)
    vertex = dict(x=verts[:, 0].astype(np.float32), y=verts[:, 1].astype(np.float32),
                  z=verts[:, 2].astype(np.float32), red=color[:, 0], green=color[:, 1],
                  blue=color[:, 2], alpha=np.full(len(verts), 255, np.uint8))
    write_ply(os.path.join(out, f"{scene}_vh_clean_2.ply"),
              {"vertex": vertex, "face": {"vertex_indices": faces}})
    write_ply(os.path.join(out, f"{scene}_vh_clean_2.labels.ply"),
              {"vertex": {**vertex, "label": labels}, "face": {"vertex_indices": faces}})
    with open(os.path.join(out, f"{scene}_vh_clean_2.0.010000.segs.json"), "w") as f:
        json.dump({"sceneId": scene, "segIndices": segs.tolist()}, f)
    with open(os.path.join(out, f"{scene}.aggregation.json"), "w") as f:
        json.dump({"sceneId": scene, "segGroups": groups}, f)
    align = np.eye(4)
    align[:3, 3] = [-X / 2, -Y / 2, 0.0]
    with open(os.path.join(out, f"{scene}.txt"), "w") as f:
        f.write("axisAlignment = " + " ".join(f"{v:g}" for v in align.reshape(-1)) + "\n"
                f"colorHeight = {frame_hw[0]}\ncolorWidth = {frame_hw[1]}\n"
                f"depthHeight = {depth_hw[0]}\ndepthWidth = {depth_hw[1]}\n")
    if frames:
        write_sens(out, scene, rng, size, frames, frame_hw, depth_hw)
    return dict(vertices=len(verts), faces=len(faces), frames=frames)


def _k4(k):
    fx, fy, cx, cy = k
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[1, 1], m[0, 2], m[1, 2] = fx, fy, cx, cy
    return m


def write_sens(out: str, scene: str, rng, size, frames: int, color_hw, depth_hw) -> None:
    """``<scene>.sens`` and ``<scene>_2d-label-filt.zip`` of ``frames`` views
    from inside the room box ``size``."""
    sx, sy = color_hw[1] / SCANNET_COLOR_HW[1], color_hw[0] / SCANNET_COLOR_HW[0]
    kc = (SCANNET_COLOR_K[0] * sx, SCANNET_COLOR_K[1] * sy, SCANNET_COLOR_K[2] * sx,
          SCANNET_COLOR_K[3] * sy)
    dx, dy = depth_hw[1] / SCANNET_DEPTH_HW[1], depth_hw[0] / SCANNET_DEPTH_HW[0]
    kd = (SCANNET_DEPTH_K[0] * dx, SCANNET_DEPTH_K[1] * dy, SCANNET_DEPTH_K[2] * dx,
          SCANNET_DEPTH_K[3] * dy)
    stream = SensStream(
        sensor_name="StructureSensor", intrinsic_color=_k4(kc),
        extrinsic_color=np.eye(4, dtype=np.float32), intrinsic_depth=_k4(kd),
        extrinsic_depth=np.eye(4, dtype=np.float32), color_compression="jpeg",
        depth_compression="zlib_ushort", color_width=color_hw[1], color_height=color_hw[0],
        depth_width=depth_hw[1], depth_height=depth_hw[0], depth_shift=1000.0)
    plane_ids = np.array([scannet_id("floor"), 0, *[scannet_id("wall")] * 4], np.uint16)
    label_buf = io.BytesIO()
    with zipfile.ZipFile(label_buf, "w", zipfile.ZIP_STORED) as zf:
        for i in range(frames):
            pos = np.r_[rng.uniform(0.8, size[0] - 0.8), rng.uniform(0.8, size[1] - 0.8),
                        rng.uniform(1.3, 1.7)]
            pose = look_pose(pos, 2 * np.pi * i / frames + rng.uniform(-0.2, 0.2),
                             rng.uniform(0.2, 0.5))
            t, plane = box_hits(pos, camera_rays(color_hw, kc, pose), size)
            hit = pos + t[..., None] * camera_rays(color_hw, kc, pose)
            color = surface_color(rng, hit, plane)
            td, _ = box_hits(pos, camera_rays(depth_hw, kd, pose), size)
            depth = np.clip(np.round(td * 1000.0), 0, 65535).astype(np.uint16)
            stream.frames.append(SensFrame(pose.astype(np.float32), i, i,
                                           encode_jpeg(color, 90),
                                           zlib.compress(depth.tobytes(), 1)))
            zf.writestr(f"label-filt/{i}.png", encode_png(plane_ids[plane]))
    stream.write(os.path.join(out, f"{scene}.sens"))
    with open(os.path.join(out, f"{scene}_2d-label-filt.zip"), "wb") as f:
        f.write(label_buf.getvalue())


# ---------------------------------------------------------------- S3DIS

def write_s3dis_room(root: str, raw_root: str, area: int, room: str, seed: int,
                     points: int = 300_000, views: int = 0, view_hw=S3DIS_VIEW_HW) -> int:
    """One room's ``Annotations/*.txt`` under ``root/Area_<area>/<room>``
    (floor, ceiling, four walls and ``S3DIS_OBJECTS`` boxes, ``points`` in
    all), its line in the area's alignment file (angle 0) and, with
    ``views``, that many 2D-3D-S frames under ``raw_root``. Returns the
    points written."""
    rng = np.random.RandomState(seed)
    size = rng.uniform([4.0, 3.5, 2.8], [7.0, 6.0, 3.2])
    X, Y, Z = size
    parts = [("floor", [(np.zeros(3), [X, 0, 0], [0, Y, 0])]),
             ("ceiling", [(np.array([0, 0, Z]), [X, 0, 0], [0, Y, 0])])]
    parts += [("wall", [r]) for r in ((np.zeros(3), [X, 0, 0], [0, 0, Z]),
                                      (np.array([0, Y, 0]), [X, 0, 0], [0, 0, Z]),
                                      (np.zeros(3), [0, Y, 0], [0, 0, Z]),
                                      (np.array([X, 0, 0]), [0, Y, 0], [0, 0, Z]))]
    parts += [(name, box_faces(lo, hi)) for name, lo, hi in room_objects(rng, size, S3DIS_OBJECTS)]
    areas = np.array([sum(np.linalg.norm(np.cross(u, v)) for _, u, v in rs) for _, rs in parts])
    counts = np.maximum(1, np.round(areas / areas.sum() * points).astype(int))
    counts[0] += points - counts.sum()
    ann = os.path.join(root, f"Area_{area}", room, "Annotations")
    os.makedirs(ann, exist_ok=True)
    seen: Dict[str, int] = {}
    for (name, rs), n in zip(parts, counts):
        r_area = np.array([np.linalg.norm(np.cross(u, v)) for _, u, v in rs])
        which = rng.choice(len(rs), n, p=r_area / r_area.sum())
        ab = rng.uniform(0, 1, (n, 2))
        o = np.stack([rs[w][0] for w in which])
        pts = o + ab[:, :1] * np.stack([rs[w][1] for w in which]) \
            + ab[:, 1:] * np.stack([rs[w][2] for w in which])
        plane = np.where(pts[:, 2] < 1e-6, 0, np.where(pts[:, 2] > Z - 1e-6, 1, 2))
        rgb = surface_color(rng, pts, plane)
        seen[name] = seen.get(name, 0) + 1
        with open(os.path.join(ann, f"{name}_{seen[name]}.txt"), "w") as f:
            np.savetxt(f, np.concatenate([pts, rgb], 1), fmt="%.6f %.6f %.6f %d %d %d")
    with open(os.path.join(root, f"Area_{area}", f"Area_{area}_alignmentAngle.txt"), "a") as f:
        if f.tell() == 0:
            f.write(f"## Global alignment angle per disjoint space in Area_{area} ##\n")
        f.write(f"{room} 0\n")
    if views:
        write_s3dis_views(raw_root, area, room, rng, size, views, view_hw)
    return int(counts.sum())


def write_s3dis_views(raw_root: str, area: int, room: str, rng, size, views: int,
                      hw=S3DIS_VIEW_HW) -> None:
    """2D-3D-S frames of ``room`` (module docstring): a camera in the
    room's middle turning through ``views`` yaws."""
    d3 = os.path.join(raw_root, f"area_{area}", "3d")
    raw = os.path.join(raw_root, f"area_{area}", "raw")
    os.makedirs(d3, exist_ok=True)
    os.makedirs(raw, exist_ok=True)
    cam_json = os.path.join(d3, "camera_to_room.json")
    cams = json.load(open(cam_json)) if os.path.isfile(cam_json) else {}
    uuid = f"cam{zlib.crc32(room.encode()):08x}"
    cams[uuid] = f"{room}_{area}"
    with open(cam_json, "w") as f:
        json.dump(cams, f)
    f_px = hw[1] / 2.0  # 90 degrees across
    k = (f_px, f_px, hw[1] / 2.0, hw[0] / 2.0)
    pitch = 0
    np.savetxt(os.path.join(raw, f"{uuid}_intrinsics_{pitch}.txt"),
               np.array([hw[0], hw[1], *k, 0.0, 0.0, 0.0, 0.0, 0.0]))
    pos = np.r_[size[0] / 2, size[1] / 2, 1.5]
    for v in range(views):
        yaw = v * 360 // views
        pose = look_pose(pos, np.deg2rad(yaw), 0.15)
        np.savetxt(os.path.join(raw, f"{uuid}_pose_{pitch}_{yaw}.txt"), pose)
        rays = camera_rays(hw, k, pose)
        t, plane = box_hits(pos, rays, size)
        write_jpeg(os.path.join(raw, f"{uuid}_i{pitch}_{yaw}.jpg"),
                   surface_color(rng, pos + t[..., None] * rays, plane), quality=90)
        write_png(os.path.join(raw, f"{uuid}_d{pitch}_{yaw}.png"),
                  np.clip(np.round(t * 4000.0), 0, 65535).astype(np.uint16))


# ---------------------------------------------------------------- Structured3D

_Z2Y = np.array([[0, 1, 0], [0, 0, 1], [1, 0, 0]], np.float64)
_PRSP_AXES = np.array([[0, 0, 1], [0, -1, 0], [1, 0, 0]], np.float64)
S3D_PLANE_NYU40 = np.array([2, 22, 1, 1, 1, 1], np.uint8)  # floor, ceiling, walls


def write_structured3d_zip(root: str, scene_id: int, seed: int, rooms: int = 2,
                           perspectives: int = 2, pano_hw=S3D_PANO_HW,
                           persp_hw=S3D_PERSP_HW) -> str:
    """``root/Structured3D_scene_<id>.zip`` (module docstring): ``rooms``
    rooms, each a panorama and ``perspectives`` perspective views. Returns
    the zip's path."""
    rng = np.random.RandomState(seed)
    scene = f"scene_{scene_id:05d}"
    path = os.path.join(root, f"Structured3D_{scene}.zip")
    os.makedirs(root, exist_ok=True)
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as zf:
        for r in range(rooms):
            room = str(485142 + r)
            base = f"Structured3D/{scene}/2D_rendering/{room}"
            size = rng.uniform([4.0, 3.5, 2.6], [7.0, 6.0, 3.0])
            cam_mm = np.round(np.r_[size[0] / 2, size[1] / 2, 1.4] * 1000)
            # raw coordinates are z up in mm; the preprocessor's world is
            # _Z2Y @ raw, so the box is cast in raw metres
            pos = cam_mm / 1000.0
            # panorama: x = d cos a cos b, y (up) = d sin b, z = d sin a cos b
            # about the camera, in the preprocessor's y-up frame
            ph, pw = pano_hw
            a = np.arange(pw) / pw * 2 * np.pi - np.pi
            b = np.arange(ph) / ph * np.pi * -1 + np.pi / 2
            A, B = np.meshgrid(a, b)
            d_y_up = np.stack([np.cos(A) * np.cos(B), np.sin(B), np.sin(A) * np.cos(B)], -1)
            d_raw = d_y_up @ _Z2Y  # y-up -> raw z-up (the inverse of _Z2Y)
            t, plane = box_hits(pos, d_raw, size)
            zf.writestr(f"{base}/panorama/camera_xyz.txt", " ".join(f"{v:g}" for v in cam_mm))
            _s3d_view(zf, f"{base}/panorama/full", rng, pos, d_raw, t, plane)
            for f in range(perspectives):
                yaw = 2 * np.pi * f / max(perspectives, 1) + rng.uniform(-0.3, 0.3)
                front = np.array([np.cos(yaw), np.sin(yaw), -0.15])
                up = np.array([0.0, 0.0, 1.0])
                half_fov = (0.6, 0.6 * persp_hw[0] / persp_hw[1])
                cam_r = _Z2Y @ np.stack([front, up, np.cross(front, up)], 1)
                h, w = persp_hw
                v, u = np.mgrid[:h, :w].astype(np.float64)
                kx, ky = (w / 2) / np.tan(half_fov[0]), (h / 2) / np.tan(half_fov[1])
                d_cam = np.stack([(u - w / 2) / kx, (v - h / 2) / ky, np.ones_like(u)], -1)
                d_world = (d_cam @ _PRSP_AXES) @ cam_r.T  # y-up, a unit of camera depth
                d_raw = d_world @ _Z2Y
                t, plane = box_hits(pos, d_raw, size)
                pb = f"{base}/perspective/full/{f}"
                zf.writestr(f"{pb}/camera_pose.txt", " ".join(
                    f"{v:g}" for v in (*cam_mm, *front, *up, *half_fov)))
                _s3d_view(zf, pb, rng, pos, d_raw, t, plane)
    return path


def _s3d_view(zf, prefix, rng, pos, dirs, t, plane) -> None:
    hit = pos + t[..., None] * dirs
    zf.writestr(f"{prefix}/rgb_rawlight.png", encode_png(surface_color(rng, hit, plane)))
    zf.writestr(f"{prefix}/depth.png",
                encode_png(np.clip(np.round(t * 1000.0), 1, 65535).astype(np.uint16)))
    zf.writestr(f"{prefix}/semantic.png", encode_png(S3D_PLANE_NYU40[plane]))

