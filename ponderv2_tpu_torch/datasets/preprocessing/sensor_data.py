"""ScanNet ``.sens`` sensor-stream parser + frame extractor.

Original implementation of the public ScanNet .sens binary format
(http://www.scan-net.org; the reference vendors ScanNet's own reader at
ponder/datasets/preprocessing/scannet/SensorData.py + reader.py). Layout:

    uint32  version (=4)
    uint64  strlen; char[strlen] sensor_name
    float32[16] x4   intrinsic/extrinsic for color and depth (4x4 row-major)
    int32   color_compression   (0 raw, 1 png, 2 jpeg)
    int32   depth_compression   (0 raw_ushort, 1 zlib_ushort, 2 occi_ushort)
    uint32  color_width, color_height, depth_width, depth_height
    float32 depth_shift         (depth[mm] = stored / shift ... stored = m * shift)
    uint64  num_frames
    per frame:
        float32[16] camera_to_world
        uint64 timestamp_color, timestamp_depth
        uint64 color_size_bytes, depth_size_bytes
        byte[color_size_bytes], byte[depth_size_bytes]

The extractor writes the directory layout the RGB-D datasets consume
(identical to what the reference's reader.py produces):

    <out>/<scene>/color/N.jpg
    <out>/<scene>/depth/N.png          (uint16, millimetres)
    <out>/<scene>/pose/N.txt           (4x4 cam2world)
    <out>/<scene>/intrinsic/intrinsic_{color,depth}.txt (+ extrinsics)
    <out>/<scene>/label/N.png          (uint8 nyu40 ids, optional)
    <out>/<scene>/<scene>.txt          (scene meta incl. axisAlignment)

A copy of ``ponderv2_tpu/datasets/preprocessing/sensor_data.py`` but for
``SensFrame.decode_color`` and ``extract_sens``, which decode, write and read
their images through ``datasets/image_io.py`` (the port's codec) in place of
PIL: the same pixels, and ``color/N.jpg`` the same file PIL writes at
quality 95.

    python -m ponderv2_tpu_torch.datasets.preprocessing.sensor_data \
        --scans_path DIR --output_path DIR [--frame_skip N] [--export_label]
"""

from __future__ import annotations

import os
import struct
import zlib
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ..image_io import decode_image, decode_png, write_jpeg, write_png

COLOR_COMPRESSION = {-1: "unknown", 0: "raw", 1: "png", 2: "jpeg"}
DEPTH_COMPRESSION = {-1: "unknown", 0: "raw_ushort", 1: "zlib_ushort",
                     2: "occi_ushort"}


def _read_mat4(f) -> np.ndarray:
    return np.frombuffer(f.read(64), dtype="<f4").reshape(4, 4).copy()


@dataclass
class SensFrame:
    camera_to_world: np.ndarray
    timestamp_color: int
    timestamp_depth: int
    color_bytes: bytes
    depth_bytes: bytes

    def decode_color(self, compression: str) -> np.ndarray:
        if compression in ("jpeg", "png"):
            return decode_image(self.color_bytes, "color frame", rgb=True)
        if compression == "raw":
            return np.frombuffer(self.color_bytes, np.uint8)
        raise ValueError(f"unsupported color compression: {compression}")

    def decode_depth(self, compression: str, height: int, width: int) -> np.ndarray:
        """-> uint16 (H, W) in the stream's native units (usually mm)."""
        if compression == "zlib_ushort":
            raw = zlib.decompress(self.depth_bytes)
        elif compression == "raw_ushort":
            raw = self.depth_bytes
        else:
            raise ValueError(f"unsupported depth compression: {compression}")
        return np.frombuffer(raw, dtype="<u2").reshape(height, width).copy()


@dataclass
class SensStream:
    sensor_name: str = ""
    intrinsic_color: np.ndarray = None
    extrinsic_color: np.ndarray = None
    intrinsic_depth: np.ndarray = None
    extrinsic_depth: np.ndarray = None
    color_compression: str = "jpeg"
    depth_compression: str = "zlib_ushort"
    color_width: int = 0
    color_height: int = 0
    depth_width: int = 0
    depth_height: int = 0
    depth_shift: float = 1000.0
    frames: List[SensFrame] = field(default_factory=list)

    VERSION = 4

    @classmethod
    def read(cls, path: str) -> "SensStream":
        s = cls()
        with open(path, "rb") as f:
            (version,) = struct.unpack("<I", f.read(4))
            if version != cls.VERSION:
                raise ValueError(f".sens version {version} != {cls.VERSION}")
            (strlen,) = struct.unpack("<Q", f.read(8))
            s.sensor_name = f.read(strlen).decode("utf-8", "replace")
            s.intrinsic_color = _read_mat4(f)
            s.extrinsic_color = _read_mat4(f)
            s.intrinsic_depth = _read_mat4(f)
            s.extrinsic_depth = _read_mat4(f)
            (cc,) = struct.unpack("<i", f.read(4))
            (dc,) = struct.unpack("<i", f.read(4))
            s.color_compression = COLOR_COMPRESSION[cc]
            s.depth_compression = DEPTH_COMPRESSION[dc]
            (s.color_width, s.color_height, s.depth_width, s.depth_height) = (
                struct.unpack("<4I", f.read(16))
            )
            (s.depth_shift,) = struct.unpack("<f", f.read(4))
            (num_frames,) = struct.unpack("<Q", f.read(8))
            for _ in range(num_frames):
                pose = _read_mat4(f)
                tc, td, nc, nd = struct.unpack("<4Q", f.read(32))
                s.frames.append(
                    SensFrame(pose, tc, td, f.read(nc), f.read(nd))
                )
        return s

    # ----------------------------------------------------------------- writer
    def write(self, path: str) -> None:
        """Serialize back to .sens (used to build test fixtures)."""
        cc = {v: k for k, v in COLOR_COMPRESSION.items()}[self.color_compression]
        dc = {v: k for k, v in DEPTH_COMPRESSION.items()}[self.depth_compression]
        with open(path, "wb") as f:
            f.write(struct.pack("<I", self.VERSION))
            name = self.sensor_name.encode()
            f.write(struct.pack("<Q", len(name)) + name)
            for m in (self.intrinsic_color, self.extrinsic_color,
                      self.intrinsic_depth, self.extrinsic_depth):
                f.write(np.asarray(m, "<f4").tobytes())
            f.write(struct.pack("<i", cc) + struct.pack("<i", dc))
            f.write(struct.pack("<4I", self.color_width, self.color_height,
                                self.depth_width, self.depth_height))
            f.write(struct.pack("<f", self.depth_shift))
            f.write(struct.pack("<Q", len(self.frames)))
            for fr in self.frames:
                f.write(np.asarray(fr.camera_to_world, "<f4").tobytes())
                f.write(struct.pack("<4Q", fr.timestamp_color,
                                    fr.timestamp_depth, len(fr.color_bytes),
                                    len(fr.depth_bytes)))
                f.write(fr.color_bytes)
                f.write(fr.depth_bytes)


def read_label_mapping(tsv_path: str, label_from: str = "id",
                       label_to: str = "nyu40id") -> dict:
    """scannetv2-labels.combined.tsv raw-id -> nyu40 mapping
    (reference reader.py:55-66)."""
    import csv

    mapping = {}
    with open(tsv_path) as f:
        for row in csv.DictReader(f, delimiter="\t"):
            mapping[row[label_from]] = int(row[label_to])
    try:
        mapping = {int(k): v for k, v in mapping.items()}
    except ValueError:
        pass
    return mapping


def map_label_image(image: np.ndarray, mapping: dict) -> np.ndarray:
    """Raw-label image -> mapped ids via a lookup table (vectorized; unknown
    ids -> 0, which the 20-class remap drops downstream)."""
    max_id = max(int(image.max()), max(mapping.keys(), default=0))
    lut = np.zeros(max_id + 1, np.uint8)
    for k, v in mapping.items():
        if 0 <= k <= max_id:
            lut[k] = v
    return lut[image]


def extract_sens(
    sens_path: str,
    output_dir: str,
    frame_skip: int = 1,
    label_zip: Optional[str] = None,
    label_map_tsv: Optional[str] = None,
    scene_meta_txt: Optional[str] = None,
) -> int:
    """Extract one scene's .sens into the reference directory layout.

    Returns the number of frames written. ``label_zip`` is the ScanNet
    ``<scene>_2d-label-filt.zip``; raw ids are remapped to nyu40 with the tsv.
    """
    scene = os.path.basename(output_dir.rstrip("/"))
    s = SensStream.read(sens_path)
    for sub in ("color", "depth", "pose", "intrinsic"):
        os.makedirs(os.path.join(output_dir, sub), exist_ok=True)

    def save_mat(m, name):
        np.savetxt(os.path.join(output_dir, "intrinsic", name),
                   np.asarray(m, np.float64), fmt="%f")

    save_mat(s.intrinsic_color, "intrinsic_color.txt")
    save_mat(s.extrinsic_color, "extrinsic_color.txt")
    save_mat(s.intrinsic_depth, "intrinsic_depth.txt")
    save_mat(s.extrinsic_depth, "extrinsic_depth.txt")

    label_map = None
    zf = None
    if label_zip and label_map_tsv:
        import zipfile

        label_map = read_label_mapping(label_map_tsv, "id", "nyu40id")
        zf = zipfile.ZipFile(label_zip)
        os.makedirs(os.path.join(output_dir, "label"), exist_ok=True)

    n = 0
    for i in range(0, len(s.frames), frame_skip):
        fr = s.frames[i]
        color = fr.decode_color(s.color_compression)
        write_jpeg(os.path.join(output_dir, "color", f"{i}.jpg"), color, quality=95)
        depth = fr.decode_depth(s.depth_compression, s.depth_height,
                                s.depth_width)
        write_png(os.path.join(output_dir, "depth", f"{i}.png"), depth)
        np.savetxt(os.path.join(output_dir, "pose", f"{i}.txt"),
                   np.asarray(fr.camera_to_world, np.float64), fmt="%f")
        if zf is not None:
            raw = decode_png(zf.read(f"label-filt/{i}.png"), f"label-filt/{i}.png")
            mapped = map_label_image(raw, label_map)
            write_png(os.path.join(output_dir, "label", f"{i}.png"), mapped)
        n += 1

    if scene_meta_txt and os.path.isfile(scene_meta_txt):
        import shutil

        shutil.copy(scene_meta_txt, os.path.join(output_dir, f"{scene}.txt"))
    return n


def main(argv=None):
    import argparse
    import glob

    p = argparse.ArgumentParser(
        description=".sens RGB-D extractor (reference reader.py equivalent)"
    )
    p.add_argument("--scans_path", required=True, help="dir of <scene>/ dirs")
    p.add_argument("--output_path", required=True)
    p.add_argument("--frame_skip", type=int, default=1)
    p.add_argument("--export_label", action="store_true")
    p.add_argument("--label_map_tsv", default=None,
                   help="scannetv2-labels.combined.tsv (default: <scans>/..)")
    args = p.parse_args(argv)

    tsv = args.label_map_tsv or os.path.join(
        os.path.dirname(args.scans_path.rstrip("/")),
        "scannetv2-labels.combined.tsv",
    )
    for scan in sorted(glob.glob(os.path.join(args.scans_path, "*"))):
        scene = os.path.basename(scan.rstrip("/"))
        sens = os.path.join(scan, f"{scene}.sens")
        if not os.path.isfile(sens):
            continue
        out = os.path.join(args.output_path, scene)
        label_zip = os.path.join(scan, f"{scene}_2d-label-filt.zip")
        n = extract_sens(
            sens, out, frame_skip=args.frame_skip,
            label_zip=label_zip if args.export_label
            and os.path.isfile(label_zip) else None,
            label_map_tsv=tsv if os.path.isfile(tsv) else None,
            scene_meta_txt=os.path.join(scan, f"{scene}.txt"),
        )
        print(f"{scene}: {n} frames")


if __name__ == "__main__":
    main()
