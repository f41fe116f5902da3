"""PyTorch port vs JAX package: the dataset preprocessors.

The port's preprocessors (``ponderv2_tpu_torch/datasets/preprocessing/``)
are the JAX ones with their images read and written by the port's codec
(``datasets/image_io.py``) and ScanNet's meshes by its PLY reader
(``preprocessing/ply.py``). Each is given the same seeded raw files as the
JAX one here and must write the same arrays:

- ScanNet's ``parse_scene`` (plyfile is not installed: the JAX module's
  ``plyfile`` is this file's own reader of the binary meshes written here),
  ``extract_sens`` (the ``.sens`` fixture of ``test_sens_pipeline.py``: the
  same ``color/N.jpg`` bytes, depth, labels, poses and intrinsics) and
  ``ScanNetRGBDDataset`` over the extracted folders where color, depth and
  labels differ in size (both resizes);
- S3DIS's ``parse_room`` with its RGB-D views (``test_preprocessing.py``'s
  room and 2D-3D-S writers) and ``voxelize_room``;
- Structured3D's ``parse_scene_zip`` (``test_preprocessing.py``'s zip),
  fused clouds, views and the optional ``GridSample``;
- nuScenes' helpers (the module's functions are the JAX ones; ``build_infos``
  names the devkit it needs).

The faults both packages had, repaired in the port only (``*_port_only``):
F7, S3DIS's list takes the ``{room}_rgbd`` folders for rooms; F16, ScanNet
has no ``semantic_gt200``; F17, every ScanNet scene lands in train and val.

Last, the card machine's installations: with ``jax``, ``jaxlib``, ``flax``,
``optax``, ``PIL``, ``imageio``, ``cv2`` and ``plyfile`` blocked in every
process (a ``sitecustomize`` on ``PYTHONPATH``), each preprocessor runs as
``python -m ponderv2_tpu_torch.datasets.preprocessing.<name>`` on raw files
of every dataset (``synthetic_raw.py``), its output equal to the JAX
preprocessor's from the same files, and ``ScanNetRGBDDataset`` reads the
extracted folders.
"""

import json
import os
import subprocess
import sys
import textwrap
import types
import zipfile

import numpy as np
import pytest
import torch

import ponderv2_tpu.datasets.preprocessing.preprocess_nuscenes as jnus
import ponderv2_tpu.datasets.preprocessing.preprocess_s3dis as js3
import ponderv2_tpu.datasets.preprocessing.preprocess_s3dis_voxelized as jvox
import ponderv2_tpu.datasets.preprocessing.preprocess_scannet as jsc
import ponderv2_tpu.datasets.preprocessing.preprocess_structured3d as js3d
import ponderv2_tpu.datasets.preprocessing.sensor_data as jsens
import ponderv2_tpu_torch.datasets.preprocessing.preprocess_nuscenes as tnus
import ponderv2_tpu_torch.datasets.preprocessing.preprocess_s3dis as ts3
import ponderv2_tpu_torch.datasets.preprocessing.preprocess_s3dis_voxelized as tvox
import ponderv2_tpu_torch.datasets.preprocessing.preprocess_scannet as tsc
import ponderv2_tpu_torch.datasets.preprocessing.preprocess_structured3d as ts3d
import ponderv2_tpu_torch.datasets.preprocessing.sensor_data as tsens
from ponderv2_tpu.datasets import build_dataset as jbuild_dataset
from ponderv2_tpu_torch.datasets import build_dataset as tbuild_dataset
from ponderv2_tpu_torch.datasets.image_io import read_image
from ponderv2_tpu_torch.datasets.preprocessing import synthetic_raw as sr
from ponderv2_tpu_torch.datasets.preprocessing.ply import read_ply, write_ply
from ponderv2_tpu_torch.datasets.preprocessing.scannet200_constants import VALID_CLASS_IDS_200
import test_preprocessing  # the JAX tests' raw-file writers
from test_sens_pipeline import scene_fixture  # noqa: F401  (the .sens fixture)
from test_torch_data import assert_same_tree
from torch_threads import _torch_threads  # noqa: F401  (autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("jax", "jaxlib", "flax", "optax", "PIL", "imageio", "cv2", "plyfile")


# ------------------------------------------------------------ helpers

def _test_ply_read(path):
    """This file's own reader of the binary little-endian PLYs written here
    (scalar properties; ``list uchar int`` of three): element -> property ->
    array, as ``plyfile`` indexes them."""
    with open(path, "rb") as f:
        head, body = f.read().split(b"end_header\n", 1)
    lines = head.decode().splitlines()
    assert "format binary_little_endian 1.0" in lines
    types_ = {"float": "<f4", "uchar": "u1", "ushort": "<u2", "int": "<i4"}
    elements = []
    for line in lines:
        w = line.split()
        if w[0] == "element":
            elements.append((w[1], int(w[2]), []))
        elif w[0] == "property" and w[1] == "list":
            assert w[2:4] == ["uchar", "int"]
            elements[-1][2].extend([(w[4] + "_n", "u1"), (w[4], "<i4", (3,))])
        elif w[0] == "property":
            elements[-1][2].append((w[2], types_[w[1]]))
    out, pos = {}, 0
    for name, count, fields in elements:
        rows = np.frombuffer(body, np.dtype(fields), count, pos)
        pos += count * rows.dtype.itemsize
        out[name] = {f[0]: rows[f[0]] for f in fields}
    return out


def fake_plyfile():
    """A ``plyfile`` module over ``_test_ply_read``, for the JAX module."""
    class PlyData(dict):
        @staticmethod
        def read(path):
            return PlyData(_test_ply_read(path))

    module = types.ModuleType("plyfile")
    module.PlyData = PlyData
    return module


def load_tree(root):
    """Every file under ``root`` by its relative path: ``.npz`` and ``.pth``
    as dicts of arrays, images as PIL decodes them, text and others as
    bytes."""
    from PIL import Image

    out = {}
    for dirpath, _, files in os.walk(root):
        for name in files:
            path = os.path.join(dirpath, name)
            rel = os.path.relpath(path, root)
            if name.endswith(".npz"):
                out[rel] = dict(np.load(path))
            elif name.endswith(".pth"):
                out[rel] = torch.load(path, weights_only=False)
            elif name.endswith((".png", ".jpg")):
                out[rel] = np.asarray(Image.open(path))
            else:
                with open(path, "rb") as f:
                    out[rel] = f.read()
    return out


def assert_trees_equal(jroot, troot, skip_keys=()):
    j, t = load_tree(jroot), load_tree(troot)
    assert sorted(j) == sorted(t) and j
    for rel in j:
        a, b = j[rel], t[rel]
        if isinstance(a, dict):
            b = {k: v for k, v in b.items() if k not in skip_keys}
        assert_same_tree(a, b, rel)


def scannet_raw(root, scenes, vertices=3000, frames=0, frame_hw=(97, 130), depth_hw=(48, 64)):
    scans = os.path.join(root, "scans")
    for i, scene in enumerate(scenes):
        sr.write_scannet_scene(scans, scene, i, vertices=vertices, frames=frames,
                               frame_hw=frame_hw, depth_hw=depth_hw, objects=3)
    return scans


# ------------------------------------------------------------ ScanNet

def test_scannet_parse_scene_matches_jax(tmp_path, monkeypatch):
    """``parse_scene`` on one scan: the JAX arrays (coord, color, normal,
    semantic_gt20, instance_gt) byte-equal; the port's PLY reader gives the
    arrays the writer wrote."""
    monkeypatch.setitem(sys.modules, "plyfile", fake_plyfile())
    scans = scannet_raw(tmp_path / "raw", ["scene0000_00"])
    scene = os.path.join(scans, "scene0000_00")
    jsc.parse_scene(scene, str(tmp_path / "jax"), "train")
    sr.write_scannet_meta(str(tmp_path / "raw"), {})
    ids = tsc.read_category_ids(str(tmp_path / "raw" / "scannetv2-labels.combined.tsv"))
    tsc.parse_scene(scene, str(tmp_path / "torch"), "train", category_ids=ids)
    assert_trees_equal(tmp_path / "jax", tmp_path / "torch", skip_keys=("semantic_gt200",))
    out = dict(np.load(tmp_path / "torch" / "train" / "scene0000_00.npz"))
    assert set(out) == {"coord", "color", "normal", "semantic_gt20", "semantic_gt200",
                        "instance_gt"}
    assert (out["semantic_gt20"] >= 0).any() and (out["instance_gt"] >= 0).any()
    for name in ("scene0000_00_vh_clean_2.ply", "scene0000_00_vh_clean_2.labels.ply"):
        want, got = _test_ply_read(os.path.join(scene, name)), read_ply(os.path.join(scene, name))
        for element in want:
            for prop, arr in want[element].items():
                if prop.endswith("_n"):
                    continue
                assert np.array_equal(got[element][prop], arr) and \
                    got[element][prop].dtype == arr.dtype.newbyteorder("="), (name, prop)


def test_ply_reader_ascii_big_endian_and_ragged_lists(tmp_path):
    """The formats ScanNet does not use but PLY files have: ascii, big
    endian, and faces of several sizes (an object array of rows)."""
    xyz = np.array([[0.5, 1, 2], [3, 4.25, 5], [6, 7, 8.5], [9, 10, 11]], np.float32)
    faces = [[0, 1, 2], [0, 2, 3, 1]]
    header = ("ply\nformat {fmt} 1.0\ncomment test\nelement vertex 4\nproperty float x\n"
              "property float y\nproperty float z\nproperty uchar red\nelement face 2\n"
              "property list uchar int vertex_indices\nend_header\n")
    red = np.array([1, 2, 3, 250], np.uint8)
    ascii_body = "".join(f"{x} {y} {z} {r}\n" for (x, y, z), r in zip(xyz, red))
    ascii_body += "".join(f"{len(f)} " + " ".join(map(str, f)) + "\n" for f in faces)
    (tmp_path / "a.ply").write_text(header.format(fmt="ascii") + ascii_body)
    rows = np.zeros(4, [("x", ">f4"), ("y", ">f4"), ("z", ">f4"), ("red", "u1")])
    rows["x"], rows["y"], rows["z"], rows["red"] = xyz[:, 0], xyz[:, 1], xyz[:, 2], red
    body = rows.tobytes() + b"".join(
        bytes([len(f)]) + np.asarray(f, ">i4").tobytes() for f in faces)
    (tmp_path / "b.ply").write_bytes(header.format(fmt="binary_big_endian").encode() + body)
    for name in ("a.ply", "b.ply"):
        ply = read_ply(str(tmp_path / name))
        got = np.stack([ply["vertex"][k] for k in "xyz"], 1)
        assert np.array_equal(got, xyz) and np.array_equal(ply["vertex"]["red"], red)
        assert [list(f) for f in ply["face"]["vertex_indices"]] == faces
    write_ply(str(tmp_path / "c.ply"), {"vertex": {"x": xyz[:, 0], "red": red},
                                         "face": {"vertex_indices": np.array([[0, 1, 2]],
                                                                             np.int32)}})
    ply = read_ply(str(tmp_path / "c.ply"))
    assert np.array_equal(ply["vertex"]["x"], xyz[:, 0])
    assert np.array_equal(ply["face"]["vertex_indices"], [[0, 1, 2]])


def test_scannet200_labels_port_only(tmp_path, monkeypatch):
    """F16: the port writes ``semantic_gt200``, each aggregation group's raw
    category through the tsv's ``id`` column and ``VALID_CLASS_IDS_200``;
    ``ScanNet200Dataset`` then labels points. The JAX preprocessor writes
    none, and its items are all -1."""
    monkeypatch.setitem(sys.modules, "plyfile", fake_plyfile())
    raw = tmp_path / "raw"
    scans = scannet_raw(raw, ["scene0000_00"])
    sr.write_scannet_meta(str(raw), {})
    ids = tsc.read_category_ids(str(raw / "scannetv2-labels.combined.tsv"))
    scene = os.path.join(scans, "scene0000_00")
    tsc.parse_scene(scene, str(tmp_path / "torch"), "train", category_ids=ids)
    jsc.parse_scene(scene, str(tmp_path / "jax"), "train")
    out = dict(np.load(tmp_path / "torch" / "train" / "scene0000_00.npz"))
    with open(os.path.join(scene, "scene0000_00_vh_clean_2.0.010000.segs.json")) as f:
        segs = np.asarray(json.load(f)["segIndices"])
    with open(os.path.join(scene, "scene0000_00.aggregation.json")) as f:
        groups = json.load(f)["segGroups"]
    want = np.full(len(segs), -1)
    for g in groups:
        want[np.isin(segs, g["segments"])] = VALID_CLASS_IDS_200.index(ids[g["label"]])
    assert np.array_equal(out["semantic_gt200"], want) and (want >= 0).mean() > 0.5
    for build, root, labelled in ((tbuild_dataset, tmp_path / "torch", True),
                                  (jbuild_dataset, tmp_path / "jax", False)):
        item = build(dict(type="ScanNet200Dataset", split="train", data_root=str(root),
                          transform=[])).get_data(0)
        assert (item["segment"] >= 0).any() == labelled


def test_scannet_splits_port_only(tmp_path):
    """F17: each split's scenes come from ScanNet's list files; a scene
    listed twice raises. The JAX ``main`` globs ``scans/scene*`` for both
    train and val."""
    for name in ("scans/scene0000_00", "scans/scene0001_00", "scans/scene0002_00",
                 "scans_test/scene0707_00"):
        os.makedirs(tmp_path / name)
    sr.write_scannet_meta(str(tmp_path), {"train": ["scene0000_00", "scene0001_00"],
                                          "val": ["scene0002_00"], "test": ["scene0707_00"]})
    splits = tsc.split_scenes(str(tmp_path), str(tmp_path))
    assert {k: [os.path.relpath(p, tmp_path) for p in v] for k, v in splits.items()} == {
        "train": ["scans/scene0000_00", "scans/scene0001_00"], "val": ["scans/scene0002_00"],
        "test": ["scans_test/scene0707_00"]}
    with open(tmp_path / "scannetv2_val.txt", "a") as f:
        f.write("scene0000_00\n")
    with pytest.raises(ValueError, match="scene0000_00 is listed in both train and val"):
        tsc.split_scenes(str(tmp_path), str(tmp_path))
    with pytest.raises(FileNotFoundError, match="scannetv2_"):
        tsc.split_scenes(str(tmp_path), str(tmp_path / "scans"))


def test_extract_sens_matches_jax(scene_fixture):  # noqa: F811
    """``extract_sens`` on the ``.sens`` fixture: the same files, the color
    JPEGs byte for byte."""
    fx = scene_fixture
    out = {}
    for tag, mod in (("jax", jsens), ("torch", tsens)):
        out[tag] = fx["tmp_path"] / tag / fx["scene"]
        n = mod.extract_sens(str(fx["sens_path"]), str(out[tag]), frame_skip=1,
                             label_zip=str(fx["label_zip"]), label_map_tsv=str(fx["tsv"]),
                             scene_meta_txt=str(fx["meta"]))
        assert n == len(fx["poses"])
    assert_trees_equal(out["jax"], out["torch"])
    for name in os.listdir(out["jax"] / "color"):
        assert (out["jax"] / "color" / name).read_bytes() == \
            (out["torch"] / "color" / name).read_bytes()
    stream = tsens.SensStream.read(str(fx["sens_path"]))
    for fr in stream.frames:
        assert np.array_equal(fr.decode_color("jpeg"),
                              jsens.SensFrame.decode_color(fr, "jpeg"))


@pytest.mark.parametrize("render_semantic", [True, False], ids=["semantic", "no-semantic"])
def test_scannet_rgbd_items_on_resized_frames_match_jax(tmp_path, monkeypatch, render_semantic):
    """ScanNet's own shapes: color and labels larger than depth, so
    ``_load_dir_frame`` resizes both (bicubic, nearest). The JAX extractor
    and dataset against the port's, on one ``.sens``: byte-equal items."""
    monkeypatch.setitem(sys.modules, "plyfile", fake_plyfile())
    raw = tmp_path / "raw"
    scans = scannet_raw(raw, ["scene0000_00"], frames=3)
    sr.write_scannet_meta(str(raw), {})
    scene = os.path.join(scans, "scene0000_00")
    tsc.parse_scene(scene, str(tmp_path / "data"), "train")
    items = {}
    for tag, mod, build in (("jax", jsens, jbuild_dataset), ("torch", tsens, tbuild_dataset)):
        mod.extract_sens(os.path.join(scene, "scene0000_00.sens"),
                         str(tmp_path / tag / "scene0000_00"),
                         label_zip=os.path.join(scene, "scene0000_00_2d-label-filt.zip"),
                         label_map_tsv=str(raw / "scannetv2-labels.combined.tsv"),
                         scene_meta_txt=os.path.join(scene, "scene0000_00.txt"))
        ds = build(dict(type="ScanNetRGBDDataset", split="train",
                        data_root=str(tmp_path / "data"), rgbd_root=str(tmp_path / tag),
                        num_cameras=2, render_semantic=render_semantic, transform=[]))
        items[tag] = ds.get_data(0)
    assert_same_tree(items["jax"], items["torch"])
    assert items["torch"]["rgb"].shape == (2, 48, 64, 3)
    if render_semantic:
        assert (items["torch"]["semantic2d"] >= 0).any()


# ------------------------------------------------------------ S3DIS

def write_s3dis_fixture(root, rng):
    """``test_preprocessing.py``'s room and 2D-3D-S writers, two views with
    lens distortion (so ``undistort_image`` remaps)."""
    from PIL import Image

    test_preprocessing.TestS3DISFullPipeline()._make_room(root, rng, angle=90)
    raw = root / "raw2d3d"
    (raw / "area_1" / "3d").mkdir(parents=True)
    (raw / "area_1" / "3d" / "camera_to_room.json").write_text('{"cam0uuid": "office_1_1"}')
    rdir = raw / "area_1" / "raw"
    rdir.mkdir()
    H, W = 24, 32
    np.savetxt(rdir / "cam0uuid_intrinsics_0.txt",
               np.array([H, W, 25.0, 25.0, W / 2, H / 2, 0.05, -0.01, 0.001, 0.002, 0.0]))
    for yaw in (0, 90):
        pose = np.eye(4)
        pose[:3, 3] = [1.0, 1.0, 1.0]
        np.savetxt(rdir / f"cam0uuid_pose_0_{yaw}.txt", pose)
        Image.fromarray(rng.randint(0, 255, (H, W, 3)).astype(np.uint8)).save(
            rdir / f"cam0uuid_i0_{yaw}.jpg")
        Image.fromarray(rng.randint(3000, 9000, (H, W)).astype(np.int32), mode="I").save(
            rdir / f"cam0uuid_d0_{yaw}.png")
    return raw


def test_s3dis_parse_room_matches_jax(tmp_path, rng):
    """``parse_room`` with the RGB-D views: the room and each view dict
    byte-equal."""
    raw = write_s3dis_fixture(tmp_path, rng)
    rooms, angles = js3.load_alignment(tmp_path)
    for tag, mod in (("jax", js3), ("torch", ts3)):
        mod.parse_room(rooms[0], angles[0], str(tmp_path), str(raw), str(tmp_path / tag),
                       align_angle=True, parse_rgbd=True)
    assert_trees_equal(tmp_path / "jax", tmp_path / "torch")
    views = os.listdir(tmp_path / "torch" / "Area_1" / "office_1_rgbd")
    assert len(views) == 2


def test_s3dis_list_skips_rgbd_folders_port_only(tmp_path, rng):
    """F7: on ``parse_room(..., parse_rgbd=True)``'s output the port's
    ``S3DISDataset`` lists the room only; the JAX list takes
    ``office_1_rgbd/`` for a second room."""
    raw = write_s3dis_fixture(tmp_path, rng)
    rooms, angles = js3.load_alignment(tmp_path)
    ts3.parse_room(rooms[0], angles[0], str(tmp_path), str(raw), str(tmp_path / "out"),
                   align_angle=True, parse_rgbd=True)
    cfg = dict(type="S3DISDataset", split="Area_1", data_root=str(tmp_path / "out"),
               transform=[])
    names = {tag: [os.path.basename(p) for p in build(dict(cfg)).data_list]
             for tag, build in (("jax", jbuild_dataset), ("torch", tbuild_dataset))}
    assert names["torch"] == ["office_1.pth"]
    assert names["jax"] == ["office_1.pth", "office_1_rgbd"]
    rgbd = tbuild_dataset(dict(cfg, type="S3DISRGBDDataset", num_cameras=2))
    assert [os.path.basename(p) for p in rgbd.data_list] == ["office_1.pth"]


def test_s3dis_voxelize_room_matches_jax(tmp_path):
    rng = np.random.RandomState(5)
    src = tmp_path / "in" / "Area_1"
    src.mkdir(parents=True)
    n = 4000
    torch.save(dict(coord=rng.rand(n, 3).astype(np.float32) * 2,
                    color=rng.randint(0, 255, (n, 3)).astype(np.float32),
                    semantic_gt=rng.randint(0, 13, (n, 1)), instance_gt=rng.randint(0, 5, (n, 1))),
               src / "office_1.pth")
    for tag, mod in (("jax", jvox), ("torch", tvox)):
        np.random.seed(0)
        mod.voxelize_room(str(src / "office_1.pth"), str(tmp_path / "in"),
                          str(tmp_path / tag), 0.2)
    assert_trees_equal(tmp_path / "jax", tmp_path / "torch")


def test_s3dis_point_normals(tmp_path):
    """``--point_normals``: on a room of ``synthetic_raw.py`` (a box with
    furniture boxes) the floor's points get +z and the ceiling's -z, each
    wall's its inward axis; the JAX arrays stay as they are."""
    sr.write_s3dis_room(str(tmp_path / "raw"), None, 1, "office_1", 3, points=20000)
    rooms, angles = js3.load_alignment(str(tmp_path / "raw"))
    ts3.parse_room(rooms[0], angles[0], str(tmp_path / "raw"), None, str(tmp_path / "torch"),
                   align_angle=False, point_normals=True)
    js3.parse_room(rooms[0], angles[0], str(tmp_path / "raw"), None, str(tmp_path / "jax"),
                   align_angle=False)
    assert_trees_equal(tmp_path / "jax", tmp_path / "torch", skip_keys=("normal",))
    room = torch.load(tmp_path / "torch" / "Area_1" / "office_1.pth", weights_only=False)
    coord, normal = room["coord"], room["normal"]
    assert normal.dtype == np.float32 and np.allclose(np.linalg.norm(normal, axis=1), 1, atol=1e-5)
    sem = room["semantic_gt"][:, 0]
    floor, ceiling = sem == js3.CLASS2ID["floor"], sem == js3.CLASS2ID["ceiling"]
    # points away from the furniture: the plane through their neighbours is the room's
    top = coord[:, 2].max()
    assert np.median(normal[floor, 2]) > 0.99 and np.median(normal[ceiling, 2]) < -0.99
    assert np.isclose(coord[ceiling, 2], top).all()
    wall = sem == js3.CLASS2ID["wall"]
    x0 = wall & np.isclose(coord[:, 0], coord[:, 0].min(), atol=1e-4)
    assert x0.sum() > 100 and np.median(normal[x0, 0]) > 0.99


def test_inline_band_plan_doubles_past_the_attached_limit_port_only(monkeypatch):
    """F19: a plan built inside a conv keeps doubling its budgets past the
    attached plans' ``MAX_DOUBLINGS`` (4), up to ``INLINE_MAX_DOUBLINGS``:
    the S3DIS PPT recipe's batch of 12 dense rooms at 4 cm overflows L0's
    inline plan up to 32x (5 doublings), which zeroed its convs and stopped
    the run. Budgets of 64 and a small window stand in for that batch here
    (7 doublings)."""
    from ponderv2_tpu_torch.ops import band_conv as tbc
    from ponderv2_tpu_torch.ops import spconv as tsp

    rng = np.random.RandomState(7)
    coords = np.unique(rng.randint(0, 12, (900, 3)), axis=0)
    coords = np.concatenate([np.zeros((len(coords), 1), np.int64), coords], 1)
    rb = tsp.build_subm_rulebook(torch.from_numpy(coords.astype(np.int32)), (12, 12, 12), 1, 3)
    calls = []
    build = tbc.build_band_plan

    def small_window(rulebook, kz, pair_budget, entry_budget):
        calls.append((pair_budget, entry_budget))
        return build(rulebook, kz, block=32, window=8, pair_budget=pair_budget,
                     entry_budget=entry_budget)

    monkeypatch.setattr(tbc, "build_band_plan", small_window)
    monkeypatch.setattr(tbc, "PAIR_BUDGET", 64)
    monkeypatch.setattr(tbc, "ENTRY_BUDGET", 64)
    plan = tbc.build_band_plan_auto(rb, 3)
    assert bool(plan.ok)
    assert tbc.MAX_DOUBLINGS + 1 < len(calls) <= tbc.INLINE_MAX_DOUBLINGS + 1
    last = 64 << tbc.MAX_DOUBLINGS
    assert not bool(small_window(rb, 3, last, last).ok)


# ------------------------------------------------------------ Structured3D

@pytest.mark.parametrize("grid_size", [None, 0.1], ids=["points", "grid-sampled"])
def test_structured3d_matches_jax(tmp_path, rng, grid_size):
    """``parse_scene_zip`` with perspective views and RGB-D dicts: every
    room and view byte-equal."""
    zpath = tmp_path / "Structured3D_scene_00000.zip"
    test_preprocessing.TestStructured3D()._make_zip(zpath, rng, with_prsp=True)
    for tag, mod in (("jax", js3d), ("torch", ts3d)):
        np.random.seed(0)
        mod.parse_scene_zip(str(zpath), str(tmp_path / tag), parse_rgbd=True,
                            grid_size=grid_size)
    assert_trees_equal(tmp_path / "jax", tmp_path / "torch")


# ------------------------------------------------------------ nuScenes

def test_nuscenes_helpers_match_jax(rng):
    """The pure-numpy helpers give JAX's numbers; ``build_infos`` names the
    devkit it needs (neither machine has it)."""
    q = rng.randn(4)
    q /= np.linalg.norm(q)
    t = rng.randn(3)
    for inverse in (False, True):
        assert np.array_equal(tnus.transform_matrix(t, q, inverse),
                              jnus.transform_matrix(t, q, inverse))
    args = [rng.randn(3), q, rng.randn(3), rng.randn(4), np.eye(4), np.eye(4)]
    assert np.array_equal(tnus.sensor2top_transform(*args), jnus.sensor2top_transform(*args))
    assert tnus.quaternion_yaw(q) == jnus.quaternion_yaw(q)
    with pytest.raises(SystemExit, match="nuscenes-devkit"):
        tnus.build_infos("/nonexistent", "/nonexistent")


# ------------------------------------------------------------ the card's installations

BLOCKER = """\
import sys

class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {blocked!r}:
            raise ImportError(f"import of {{name}} halted: not installed on the card's machine")
        return None

sys.meta_path.insert(0, _Block())
"""


def _run_modules(runs, env, cwd):
    """Start each (module, args) as ``python -m``, all together; wait for
    them and return their outputs, raising on a failed one."""
    procs = [(m, subprocess.Popen([sys.executable, "-m", m, *args], env=env, cwd=cwd,
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
             for m, args in runs]
    outs = {}
    for m, p in procs:
        out, _ = p.communicate(timeout=300)
        assert p.returncode == 0, f"{m} exited {p.returncode}:\n{out[-3000:]}"
        outs[m] = out
    return outs


def test_preprocessor_clis_run_with_the_cards_installations(tmp_path, monkeypatch):
    """Raw ScanNet (2 train + 1 val scans with frames), S3DIS (2 rooms, one
    with 2D-3D-S views) and Structured3D (a zip) through every preprocessor
    CLI with JAX, PIL, imageio, cv2 and plyfile blocked; then
    ``ScanNetRGBDDataset`` and ``S3DISDataset`` on the outputs in the same
    kind of process. Each output equals the JAX preprocessor's from the same
    raw files here (the voxelized rooms draw their points at random: each is
    checked to be one point per voxel of the port's room)."""
    raw, out = tmp_path / "raw", tmp_path / "out"
    scan_names = ["scene0000_00", "scene0001_00", "scene0002_00"]
    scans = scannet_raw(raw / "scannet", scan_names, frames=2)
    sr.write_scannet_meta(str(raw / "scannet"), {"train": scan_names[:2], "val": scan_names[2:]})
    sr.write_s3dis_room(str(raw / "s3dis"), str(raw / "s3dis_raw"), 1, "office_1", 0,
                        points=6000, views=2, view_hw=(60, 80))
    sr.write_s3dis_room(str(raw / "s3dis"), str(raw / "s3dis_raw"), 5, "hallway_1", 1,
                        points=6000)
    sr.write_structured3d_zip(str(raw / "s3d"), 0, 2, rooms=2, perspectives=1,
                              pano_hw=(32, 64), persp_hw=(24, 40))
    blocker = tmp_path / "blocker"
    blocker.mkdir()
    (blocker / "sitecustomize.py").write_text(BLOCKER.format(blocked=BLOCKED))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(blocker), ROOT]),
               OMP_NUM_THREADS="2")
    pre = "ponderv2_tpu_torch.datasets.preprocessing."
    _run_modules([
        (pre + "preprocess_scannet", ["--dataset_root", str(raw / "scannet"),
                                      "--output_root", str(out / "scannet"),
                                      "--num_workers", "1"]),
        (pre + "sensor_data", ["--scans_path", scans, "--output_path", str(out / "rgbd"),
                               "--export_label"]),
        (pre + "preprocess_s3dis", ["--dataset_root", str(raw / "s3dis"),
                                    "--output_root", str(out / "s3dis"),
                                    "--raw_root", str(raw / "s3dis_raw"), "--parse_rgbd",
                                    "--align_angle", "--point_normals", "--num_workers", "1"]),
        (pre + "preprocess_structured3d", ["--dataset_root", str(raw / "s3d"),
                                           "--output_root", str(out / "s3d"), "--parse_rgbd"]),
    ], env, str(tmp_path))
    check = textwrap.dedent(f"""
        import sys
        assert "PIL" not in sys.modules and "jax" not in sys.modules
        from ponderv2_tpu_torch.datasets import build_dataset
        ds = build_dataset(dict(type="ScanNetRGBDDataset", split="train",
                                data_root={str(out / "scannet")!r},
                                rgbd_root={str(out / "rgbd")!r}, num_cameras=2, transform=[]))
        item = ds.get_data(0)
        assert len(ds) == 2 and item["rgb"].shape == (2, 48, 64, 3), item["rgb"].shape
        assert (item["semantic2d"] >= 0).any() and (item["segment"] >= 0).any()
        rooms = build_dataset(dict(type="S3DISDataset", split="Area_1",
                                   data_root={str(out / "s3dis")!r}, transform=[]))
        assert [p.rsplit("/", 1)[1] for p in rooms.data_list] == ["office_1.pth"]
        print("datasets ok")
    """)
    (tmp_path / "check_datasets.py").write_text(check)
    outs = _run_modules([
        (pre + "preprocess_s3dis_voxelized", ["--dataset_root", str(out / "s3dis"),
                                              "--output_root", str(out / "s3dis_vox"),
                                              "--voxel_size", "0.1", "--num_workers", "1"]),
        (pre + "preprocess_nuscenes", ["--help"]),
        ("check_datasets", []),
    ], dict(env, PYTHONPATH=env["PYTHONPATH"] + os.pathsep + str(tmp_path)), str(tmp_path))
    assert "datasets ok" in outs["check_datasets"]
    nus = subprocess.run([sys.executable, "-m", pre + "preprocess_nuscenes", "--dataset_root",
                          str(raw), "--output_root", str(out / "nus")], env=env,
                         capture_output=True, text=True, timeout=120)
    assert nus.returncode == 1 and "nuscenes-devkit" in nus.stderr

    # the JAX preprocessors on the same raw files, here
    monkeypatch.setitem(sys.modules, "plyfile", fake_plyfile())
    jout = tmp_path / "jax"
    ids = tsc.read_category_ids(str(raw / "scannet" / "scannetv2-labels.combined.tsv"))
    for split, names in (("train", scan_names[:2]), ("val", scan_names[2:])):
        for name in names:
            jsc.parse_scene(os.path.join(scans, name), str(jout / "scannet"), split)
            want = dict(np.load(out / "scannet" / split / f"{name}.npz"))
            tsc.parse_scene(os.path.join(scans, name), str(tmp_path / "inproc"), split,
                            category_ids=ids)
            assert_same_tree(dict(np.load(tmp_path / "inproc" / split / f"{name}.npz")), want)
            assert (want["semantic_gt200"] >= 0).any()
    assert_trees_equal(jout / "scannet", out / "scannet", skip_keys=("semantic_gt200",))
    for name in scan_names:
        jsens.extract_sens(os.path.join(scans, name, f"{name}.sens"),
                           str(jout / "rgbd" / name),
                           label_zip=os.path.join(scans, name, f"{name}_2d-label-filt.zip"),
                           label_map_tsv=str(raw / "scannet" / "scannetv2-labels.combined.tsv"),
                           scene_meta_txt=os.path.join(scans, name, f"{name}.txt"))
    assert_trees_equal(jout / "rgbd", out / "rgbd")
    rooms, angles = js3.load_alignment(str(raw / "s3dis"))
    for room, angle in zip(rooms, angles):
        js3.parse_room(room, angle, str(raw / "s3dis"), str(raw / "s3dis_raw"),
                       str(jout / "s3dis"), align_angle=True, parse_rgbd=True)
    assert_trees_equal(jout / "s3dis", out / "s3dis", skip_keys=("normal",))
    assert len(os.listdir(out / "s3dis" / "Area_1" / "office_1_rgbd")) == 2
    js3d.parse_scene("scene_00000", str(raw / "s3d"), str(jout / "s3d"), parse_rgbd=True)
    assert_trees_equal(jout / "s3d", out / "s3d")
    assert os.listdir(out / "s3d" / "train" / "scene_00000" / "room_485142_rgbd")
    for rel in ("Area_1/office_1.pth", "Area_5/hallway_1.pth"):
        room = torch.load(out / "s3dis" / rel, weights_only=False)
        vox = torch.load(out / "s3dis_vox" / rel, weights_only=False)
        assert sorted(vox) == sorted(room)
        grid = np.floor(vox["coord"] / 0.1).astype(np.int64)
        assert len(np.unique(grid, axis=0)) == len(grid) == len(np.unique(
            np.floor(room["coord"] / 0.1).astype(np.int64), axis=0))
    # the color frames the CLI wrote are PIL's decode of the stream's JPEGs
    img = read_image(str(out / "rgbd" / "scene0000_00" / "color" / "0.jpg"))
    assert img.shape == (97, 130, 3)
    with zipfile.ZipFile(os.path.join(scans, "scene0000_00",
                                      "scene0000_00_2d-label-filt.zip")) as zf:
        assert zf.namelist() == ["label-filt/0.png", "label-filt/1.png"]
