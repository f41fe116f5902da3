"""Procedural nuScenes scans in the layout ``NuScenesDataset`` reads.

No nuScenes data is in the repository. This writes LiDAR keyframes of a
street scene in the files that the nuScenes preprocessor's info pickles
name (``datasets/nuscenes.py:get_data_list`` / ``get_data``):

- ``info/nuscenes_infos_{sweeps}sweeps_{split}.pkl``: one record per scan;
- ``raw/samples/LIDAR_TOP/<token>.bin``: float32 (N, 5), x y z intensity ring;
- ``raw/lidarseg/<token>_lidarseg.bin``: uint8 raw lidarseg ids (0-31);
- with ``cameras``, six PNG images a scan, ``raw/samples/<CAM>/<token>.png``,
  with each camera's ``lidar2cam``, ``cam_intrinsic`` and ``lidar2img``
  (``K @ lidar2cam``, 4 x 4) in the record.

The LiDAR is a spinning 32-beam scan in the HDL-32E pattern of nuScenes
(elevations -30.67 to +10.67 degrees, ``AZIMUTH_STEPS`` azimuths), cast from
``SENSOR_HEIGHT`` above a ground plane (road, sidewalk, terrain) against
axis-aligned boxes (cars, trucks, pedestrians, barriers, buildings,
vegetation) up to ``MAX_RANGE``: about 25-35k points a scan. The lidar
frame has x forward, y left and z up. The six cameras (1600 x 900, focal
1266 px) look out at yaws 0, -55, 55, 180, 110 and -110 degrees; each pixel
is coloured by the lidarseg class of the surface its ray meets (cast at
an eighth of the resolution and repeated), plus noise per pixel.
Everything is drawn from ``seed`` with numpy.

    python -m ponderv2_tpu_torch.datasets.preprocessing.synthetic_nuscenes \\
        --root data/nuscenes_synthetic --train 12 --val 2 --seed 0
"""

from __future__ import annotations

import argparse
import os
import pickle
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Sequence

import numpy as np

from ..image_io import write_png

BEAM_ELEVATIONS_DEG = np.linspace(-30.67, 10.67, 32)
AZIMUTH_STEPS = 1085
SENSOR_HEIGHT = 1.84
MAX_RANGE = 70.0
RANGE_NOISE = 0.02
IMAGE_HW = (900, 1600)
FOCAL = 1266.0
RENDER_STRIDE = 8  # camera labels are cast at an eighth of the resolution
CAMERAS = (("CAM_FRONT", 0.0), ("CAM_FRONT_RIGHT", -55.0), ("CAM_FRONT_LEFT", 55.0),
           ("CAM_BACK", 180.0), ("CAM_BACK_LEFT", 110.0), ("CAM_BACK_RIGHT", -110.0))
CAMERA_HEIGHT = -0.34  # below the lidar
CAMERA_OFFSET = 0.5  # forward of the lidar, along each camera's yaw
SKY = -1
# raw lidarseg ids (nuScenes-lidarseg) of the surfaces
ROAD, SIDEWALK, TERRAIN = 24, 26, 27
# box kinds: raw id, (length, width, height) ranges in metres, count range
BOX_KINDS = (
    (17, ((3.8, 5.0), (1.7, 2.0), (1.4, 1.8)), (6, 12)),     # car
    (23, ((6.0, 10.0), (2.3, 2.6), (2.8, 3.6)), (1, 3)),     # truck
    (2, ((0.5, 0.8), (0.5, 0.8), (1.6, 1.9)), (3, 8)),       # adult pedestrian
    (9, ((2.0, 4.0), (0.3, 0.5), (0.8, 1.1)), (2, 5)),       # barrier
    (12, ((0.3, 0.4), (0.3, 0.4), (0.6, 0.8)), (2, 5)),      # traffic cone
    (28, ((8.0, 25.0), (8.0, 20.0), (6.0, 15.0)), (6, 10)),  # building (man-made)
    (30, ((2.0, 6.0), (2.0, 6.0), (3.0, 8.0)), (4, 8)),      # vegetation
)
ROAD_HALF_WIDTH, SIDEWALK_WIDTH = 6.0, 3.0
# an RGB colour per raw id (others grey)
PALETTE = {ROAD: (70, 70, 75), SIDEWALK: (150, 140, 130), TERRAIN: (90, 120, 60),
           17: (30, 60, 200), 23: (200, 160, 40), 2: (220, 20, 60), 9: (240, 240, 240),
           12: (250, 120, 20), 28: (120, 100, 90), 30: (40, 150, 40), SKY: (135, 190, 235)}


def _ground_label(x, y):
    ay = np.abs(y)
    return np.where(ay < ROAD_HALF_WIDTH, ROAD,
                    np.where(ay < ROAD_HALF_WIDTH + SIDEWALK_WIDTH, SIDEWALK, TERRAIN))


def draw_boxes(rng: np.random.Generator) -> np.ndarray:
    """(K, 7) axis-aligned boxes: x_lo y_lo z_lo x_hi y_hi z_hi raw_id.
    Vehicles stand on the road, pedestrians, barriers and cones on the
    sidewalk, buildings and vegetation beyond it; none covers the sensor."""
    ground = -SENSOR_HEIGHT
    boxes = []
    for raw, (lr, wr, hr), (n_lo, n_hi) in BOX_KINDS:
        for _ in range(int(rng.integers(n_lo, n_hi + 1))):
            l, w, h = (rng.uniform(*r) for r in (lr, wr, hr))
            side = rng.choice([-1.0, 1.0])
            if raw in (17, 23):  # a lane of the road, along x
                cx = rng.uniform(-60.0, 60.0)
                cy = side * rng.uniform(1.8, ROAD_HALF_WIDTH - 1.2)
                if abs(cx) < l / 2 + 3.0 and abs(cy) < w / 2 + 1.0:
                    cx += np.sign(cx + 1e-9) * (l + 6.0)
            elif raw in (2, 9, 12):
                cx = rng.uniform(-50.0, 50.0)
                cy = side * rng.uniform(ROAD_HALF_WIDTH + 0.3,
                                        ROAD_HALF_WIDTH + SIDEWALK_WIDTH - 0.3)
            else:
                cx = rng.uniform(-60.0, 60.0)
                cy = side * (ROAD_HALF_WIDTH + SIDEWALK_WIDTH + 1.0 + w / 2
                             + rng.uniform(0.0, 25.0))
            boxes.append((cx - l / 2, cy - w / 2, ground, cx + l / 2, cy + w / 2,
                          ground + h, raw))
    return np.asarray(boxes, np.float64)


def cast(origin: np.ndarray, dirs: np.ndarray, boxes: np.ndarray, max_range: float):
    """The first surface each ray from ``origin`` along unit ``dirs`` (M, 3)
    meets within ``max_range``: (distance (M,), raw id (M,), SKY where none)."""
    t_best = np.full(len(dirs), np.inf)
    label = np.full(len(dirs), SKY, np.int64)
    dz = dirs[:, 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        t_ground = np.where(dz < -1e-9, (-SENSOR_HEIGHT - origin[2]) / dz, np.inf)
        inv = 1.0 / np.where(np.abs(dirs) < 1e-12, 1e-12, dirs)
    hit = t_ground < t_best
    t_best[hit] = t_ground[hit]
    p = origin + dirs * np.where(np.isfinite(t_best), t_best, 0.0)[:, None]
    label[hit] = _ground_label(p[hit, 0], p[hit, 1])
    if len(boxes):
        inv32 = inv.astype(np.float32)[:, None, :]
        lo = (boxes[None, :, 0:3] - origin).astype(np.float32) * inv32
        hi = (boxes[None, :, 3:6] - origin).astype(np.float32) * inv32
        t_near = np.minimum(lo, hi).max(-1)
        t_far = np.maximum(lo, hi).min(-1)
        ok = (t_far >= t_near) & (t_near > 1e-6)
        t_box = np.where(ok, t_near, np.inf)
        k = t_box.argmin(1)
        tb = t_box[np.arange(len(dirs)), k]
        hit = tb < t_best
        t_best[hit] = tb[hit]
        label[hit] = boxes[k[hit], 6].astype(np.int64)
    far = t_best > max_range
    label[far] = SKY
    t_best[far] = np.inf
    return t_best, label


def lidar_scan(rng: np.random.Generator, boxes: np.ndarray):
    """(points (N, 5) float32: x y z intensity ring, raw labels (N,) uint8)."""
    elev = np.deg2rad(BEAM_ELEVATIONS_DEG)
    azim = np.linspace(-np.pi, np.pi, AZIMUTH_STEPS, endpoint=False)
    azim = azim + rng.uniform(0, 2 * np.pi / AZIMUTH_STEPS)
    e, a = np.meshgrid(elev, azim, indexing="ij")
    dirs = np.stack([np.cos(e) * np.cos(a), np.cos(e) * np.sin(a), np.sin(e)], -1)
    ring = np.broadcast_to(np.arange(len(elev))[:, None], e.shape)
    dirs, ring = dirs.reshape(-1, 3), ring.reshape(-1)
    t, label = cast(np.zeros(3), dirs, boxes, MAX_RANGE)
    keep = label != SKY
    t = t[keep] + rng.normal(0.0, RANGE_NOISE, int(keep.sum()))
    xyz = dirs[keep] * t[:, None]
    label = label[keep]
    base = np.where(np.isin(label, (ROAD, SIDEWALK)), 12.0,
                    np.where(np.isin(label, (9, 12)), 120.0, 40.0))
    intensity = np.clip(base + rng.normal(0.0, 8.0, len(label)) + 200.0 / (1.0 + t), 0, 255)
    points = np.concatenate([xyz, intensity[:, None].round(), ring[keep, None]], 1)
    return points.astype(np.float32), label.astype(np.uint8)


def camera(yaw_deg: float, image_hw=IMAGE_HW):
    """(lidar2cam (4, 4), intrinsic (3, 3)) of a camera at ``yaw_deg``
    (OpenCV axes: x right, y down, z along the view) whose image is
    ``image_hw``; the focal length scales with the width."""
    phi = np.deg2rad(yaw_deg)
    fwd = np.array([np.cos(phi), np.sin(phi), 0.0])
    right = np.array([np.sin(phi), -np.cos(phi), 0.0])
    down = np.array([0.0, 0.0, -1.0])
    R = np.stack([right, down, fwd])
    centre = CAMERA_OFFSET * fwd + np.array([0.0, 0.0, CAMERA_HEIGHT])
    l2c = np.eye(4)
    l2c[:3, :3] = R
    l2c[:3, 3] = -R @ centre
    h, w = image_hw
    f = FOCAL * w / IMAGE_HW[1]
    K = np.array([[f, 0.0, w / 2.0], [0.0, f, h / 2.0], [0.0, 0.0, 1.0]])
    return l2c, K


def camera_image(rng: np.random.Generator, boxes: np.ndarray, l2c: np.ndarray,
                 K: np.ndarray, image_hw=IMAGE_HW) -> np.ndarray:
    """(H, W, 3) uint8: each pixel the colour of the class its ray meets
    (H and W multiples of ``RENDER_STRIDE``)."""
    h, w = image_hw
    s = RENDER_STRIDE
    v, u = np.mgrid[s / 2:h:s, s / 2:w:s]
    pix = np.stack([u, v, np.ones_like(u)], -1).reshape(-1, 3)
    rays_cam = pix @ np.linalg.inv(K).T
    R, t = l2c[:3, :3], l2c[:3, 3]
    dirs = rays_cam @ R  # R^T applied to each row: camera -> lidar frame
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    centre = -R.T @ t
    _, label = cast(centre, dirs, boxes, np.inf)
    lut = np.full((max(PALETTE) + 2, 3), 128, np.int16)
    for raw, rgb in PALETTE.items():
        lut[raw] = rgb  # SKY (-1) lands on the last row
    img = lut[label].reshape(h // s, w // s, 3)
    img = np.repeat(np.repeat(img, s, 0), s, 1)
    img = img + rng.integers(-12, 13, img.shape, dtype=np.int16)
    return np.clip(img, 0, 255).astype(np.uint8)


def write_scan(root: str, token: str, seed: Sequence[int], cameras: bool = True,
               image_hw=IMAGE_HW) -> Dict:
    """Write one scan's files under ``root/raw``; returns its info record."""
    rng = np.random.default_rng(list(seed))
    boxes = draw_boxes(rng)
    points, label = lidar_scan(rng, boxes)
    raw = os.path.join(root, "raw")
    info = dict(token=token, lidar_token=token, sweeps=[],
                lidar_path=f"samples/LIDAR_TOP/{token}.bin",
                gt_segment_path=f"lidarseg/{token}_lidarseg.bin")
    for rel, arr in ((info["lidar_path"], points), (info["gt_segment_path"], label)):
        os.makedirs(os.path.dirname(os.path.join(raw, rel)), exist_ok=True)
        arr.tofile(os.path.join(raw, rel))
    if cameras:
        info["cams"] = {}
        for name, yaw in CAMERAS:
            l2c, K = camera(yaw, image_hw)
            P = np.eye(4)
            P[:3, :3] = K
            rel = f"samples/{name}/{token}.png"
            write_png(os.path.join(raw, rel), camera_image(rng, boxes, l2c, K, image_hw))
            info["cams"][name] = dict(data_path=rel, cam_intrinsic=K, lidar2cam=l2c,
                                      lidar2img=P @ l2c)
    return info


def write_synthetic_nuscenes(root: str, counts: Dict[str, int], seed: int = 0,
                             cameras: bool = True, workers: int = 1,
                             image_hw=IMAGE_HW) -> Dict[str, List[Dict]]:
    """``counts[split]`` scans per split under ``root`` with their info
    pickles (camera images of ``image_hw``), written by ``workers``
    threads (numpy and zlib release the GIL); returns the records by split.
    Scan ``i`` of the ``k``-th split is drawn from ``(seed, k, i)``, so the
    files do not depend on ``workers``."""
    jobs = [(split, (root, f"{split}_{i:04d}", (seed, k, i), cameras, tuple(image_hw)))
            for k, (split, n) in enumerate(counts.items()) for i in range(n)]
    with ThreadPoolExecutor(max(1, workers)) as pool:
        infos = list(pool.map(lambda job: write_scan(*job[1]), jobs))
    out: Dict[str, List[Dict]] = {split: [] for split in counts}
    for (split, _), info in zip(jobs, infos):
        out[split].append(info)
    os.makedirs(os.path.join(root, "info"), exist_ok=True)
    for split, split_infos in out.items():
        # the info file the configs' ``sweeps=10`` names
        with open(os.path.join(root, "info", f"nuscenes_infos_10sweeps_{split}.pkl"),
                  "wb") as f:
            pickle.dump(split_infos, f)
    return out



def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", required=True)
    parser.add_argument("--train", type=int, default=12)
    parser.add_argument("--val", type=int, default=2)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--no-cameras", action="store_true")
    parser.add_argument("--workers", type=int, default=1)
    args = parser.parse_args(argv)
    infos = write_synthetic_nuscenes(args.root, {"train": args.train, "val": args.val},
                                     args.seed, cameras=not args.no_cameras,
                                     workers=args.workers)
    print({k: len(v) for k, v in infos.items()})


if __name__ == "__main__":
    main()
