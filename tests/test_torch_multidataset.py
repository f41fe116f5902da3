"""PyTorch port vs JAX package: the data and engine layers of the paper's
multi-dataset pretrain (``configs/scannet/pretrain-ponder-ppt-v1m1-0-sc-s3-
st-spunet.py``).

- The RGB-D datasets: ``ScanNetRGBDDataset`` (a byte-equal copy) on
  per-frame ``.npz`` files and on the extractor's folders; ``S3DISRGBDDataset``
  and ``Structured3DRGBDDataset`` on views with the keys the JAX datasets
  read: byte-equal items. On the views the JAX preprocessors write
  (``parse_room(..., parse_rgbd=True)``, ``parse_scene_zip(...,
  parse_rgbd=True)``) the JAX datasets raise or find no room; the port's
  masked depth, unprojected with its intrinsics and world2cam extrinsics,
  lands on the room's points (``*_port_only``).
- ``Structured3DDataset``'s room list skips the ``room_*_rgbd`` folders.
- ``MultiDatasetDataloader``: the condition, ``len()`` against the batches
  yielded, the epoch loop, and byte-equal batches where both loaders yield.
- SpUNet-v1m1's ``remat``: the same running statistics and grads.
- ``tools/train_torch.py:main_worker`` with ``MultiDatasetTrainer`` on the
  CPU, the single-dataset pretrain configs' datasets on written files, and
  ``chip_smoke.py`` phase 15's options and scene files.
"""

import os
import random
import sys

import numpy as np
import pytest
import torch

from ponderv2_tpu.datasets import build_dataset as jbuild_dataset
from ponderv2_tpu.datasets.dataloader import MultiDatasetDataloader as JLoader
from ponderv2_tpu_torch.datasets import build_dataset as tbuild_dataset
from ponderv2_tpu_torch.datasets.dataloader import MultiDatasetDataloader as TLoader
from ponderv2_tpu_torch.utils.config import Config as TConfig
from test_sens_pipeline import scene_fixture  # noqa: F401  (the extractor's fixture)
from test_torch_data import assert_same_tree

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tools")]
import chip_smoke  # noqa: E402
from torch_threads import _torch_threads  # noqa: F401, E402  (autouse fixture)

MULTI_CFG = TConfig.fromfile(chip_smoke.MULTI_CONFIG)
# the preprocessors' distance filter (preprocess_s3dis.py:unproject_filtering_depths)
MAX_DIST = 0.1


@pytest.fixture(autouse=True)
def _torch_state():
    dtype, threads = torch.get_default_dtype(), torch.get_num_threads()
    torch.set_default_dtype(torch.float32)
    torch.set_num_threads(2)
    yield
    torch.set_default_dtype(dtype)
    torch.set_num_threads(threads)


@pytest.fixture
def seeded():
    """Seed numpy's, python's and torch's global generators alike (the
    transforms, the view picks, Mix3D and the loaders' shuffles draw from
    them) and restore them afterwards."""
    state = np.random.get_state(), random.getstate(), torch.get_rng_state()

    def seed():
        np.random.seed(0)
        random.seed(0)
        torch.manual_seed(0)

    yield seed
    np.random.set_state(state[0])
    random.setstate(state[1])
    torch.set_rng_state(state[2])


@pytest.fixture(scope="module")
def small_roots(tmp_path_factory):
    """``chip_smoke.py``'s phase-15 scenes at a small size: 300 points, 3
    views of 24 x 32 per room; 4 Structured3D rooms, 2 ScanNet scenes, 5
    S3DIS rooms (one per training area)."""
    root = tmp_path_factory.mktemp("multi")
    return chip_smoke.write_multidataset_scenes(
        str(root), counts={"Structured3D": 4, "ScanNet": 2, "S3DIS": 5}, points=300,
        views=3, hw=(24, 32))


def unprojected(item, view):
    """World points of a dataset item's view: every pixel with depth,
    unprojected with the view's intrinsics and the inverse of its world2cam
    extrinsic. Returns (points (P, 3), depth (P,))."""
    depth = item["depth"][view].astype(np.float64)
    v, u = np.nonzero(depth > 0)
    z = depth[v, u]
    cam = np.linalg.inv(item["intrinsic"][view].astype(np.float64)) @ np.stack(
        [u * z, v * z, z])
    cam2world = np.linalg.inv(item["extrinsic"][view].astype(np.float64))
    return (cam2world[:3, :3] @ cam + cam2world[:3, 3:]).T, z


def nearest(points, cloud):
    from scipy.spatial import cKDTree

    return cKDTree(np.asarray(cloud, np.float64)).query(points)[0]


# ------------------------------------------------------------------ datasets
def _pair(cfg, seeded, idx=None):
    """The JAX and the port dataset of ``cfg`` and their items, each drawn
    after the same seeding."""
    jds, tds = jbuild_dataset(dict(cfg)), tbuild_dataset(dict(cfg))
    assert len(jds) == len(tds) >= 1 and jds.data_list == tds.data_list
    for i in range(len(jds)) if idx is None else idx:
        seeded()
        j = jds[i]
        seeded()
        t = tds[i]
        assert_same_tree(j, t, f"{cfg['type']}[{i}]")
    return jds, tds


def test_scannet_rgbd_npz_frames_match_jax(small_roots, seeded):
    """Per-frame ``.npz`` files, with the ScanNet pretrain config's train
    transform (every augmentation): byte-equal items."""
    cfg = dict(MULTI_CFG.data.train.datasets[1], data_root=small_roots["scannet"],
               rgbd_root=small_roots["scannet_rgbd"], num_cameras=2)
    _, tds = _pair(cfg, seeded)
    seeded()
    item = tds[0]
    assert item["rgb"].shape == (2, 24, 32, 3) and item["condition"] == "ScanNet"


@pytest.mark.parametrize("render_semantic", [True, False])
def test_scannet_rgbd_extractor_layout_matches_jax(scene_fixture, seeded,  # noqa: F811
                                                   render_semantic):
    """The extractor's ``color/depth/pose/intrinsic/label`` folders (the
    ``.sens`` fixture of ``test_sens_pipeline.py``, through
    ``extract_sens``): byte-equal items."""
    from ponderv2_tpu.datasets.preprocessing.sensor_data import extract_sens

    fx = scene_fixture
    extract_sens(str(fx["sens_path"]), str(fx["tmp_path"] / "rgbd" / fx["scene"]),
                 frame_skip=1, label_zip=str(fx["label_zip"]),
                 label_map_tsv=str(fx["tsv"]), scene_meta_txt=str(fx["meta"]))
    transform = [dict(t) for t in MULTI_CFG.data.train.datasets[1].transform]
    if not render_semantic:
        transform[-1]["keys"] = tuple(k for k in transform[-1]["keys"] if k != "semantic2d")
    cfg = dict(type="ScanNetRGBDDataset", split="train",
               data_root=str(fx["tmp_path"] / "data"), rgbd_root=str(fx["tmp_path"] / "rgbd"),
               num_cameras=3, render_semantic=render_semantic, transform=transform)
    _, tds = _pair(cfg, seeded)
    assert ("semantic2d" in tds[0]) == render_semantic


def _write_jax_keyed_views(root, rng, rooms, pose):
    """Rooms with views in the keys the JAX datasets read: ``color``,
    ``depth`` (m), ``intrinsic`` and ``pose`` (cam2world) with a ``label``,
    or ``extrinsic`` (world2cam) without one."""
    for r, room in enumerate(rooms):
        n = 400
        os.makedirs(os.path.dirname(room), exist_ok=True)
        torch.save(dict(coord=rng.uniform(0, 3, (n, 3)).astype(np.float32),
                        color=rng.randint(0, 256, (n, 3)).astype(np.uint8),
                        normal=rng.randn(n, 3).astype(np.float32),
                        semantic_gt=rng.randint(-1, 13, (n, 1)).astype(np.int16),
                        instance_gt=rng.randint(-1, 5, (n, 1)).astype(np.int16)),
                   room + ".pth")
        os.makedirs(room + "_rgbd")
        for v in range(3 + r):
            m = np.eye(4)
            m[:3, 3] = rng.uniform(-1, 1, 3)
            view = dict(color=rng.randint(0, 256, (6, 8, 3)).astype(np.uint8),
                        depth=rng.uniform(0.5, 3, (6, 8)).astype(np.float32),
                        intrinsic=np.array([[6.0, 0, 4], [0, 6, 3], [0, 0, 1]]))
            if pose:
                view.update(pose=m, label=rng.randint(-1, 13, (6, 8)))
            else:
                view["extrinsic"] = m
            torch.save(view, os.path.join(room + "_rgbd", f"v{v}.pth"))


@pytest.mark.parametrize("pose", [True, False], ids=["pose", "extrinsic"])
@pytest.mark.parametrize("name", ["S3DISRGBDDataset", "Structured3DRGBDDataset"])
def test_jax_keyed_views_match_jax(tmp_path, seeded, name, pose):
    """S3DIS and Structured3D rooms whose views hold the keys the JAX
    datasets read, with the pretrain config's train transform: the same
    rooms and byte-equal items (a room with fewer views than cameras picks
    with replacement)."""
    rng = np.random.RandomState(0)
    if name == "S3DISRGBDDataset":
        rooms = [tmp_path / "Area_1" / "office_1", tmp_path / "Area_2" / "hallway_2"]
        split = ("Area_1", "Area_2")
    else:  # the layout the JAX list finds: room files under the split
        rooms = [tmp_path / "train" / "room_a", tmp_path / "train" / "room_b"]
        split = "train"
    _write_jax_keyed_views(tmp_path, rng, [str(r) for r in rooms], pose)
    cfg = dict(MULTI_CFG.data.train.datasets[0 if name.startswith("Struct") else 2],
               type=name, split=split, data_root=str(tmp_path), num_cameras=4, loop=1)
    _, tds = _pair(cfg, seeded)
    assert len(tds) == 2 and tds[0]["extrinsic"].shape == (4, 4, 4)


@pytest.fixture
def s3dis_preprocessed(tmp_path):
    """One S3DIS room through ``preprocess_s3dis.py:parse_room(...,
    parse_rgbd=True)``: a wall of points on the plane z = 2 and one view of
    it from a camera turned about z and moved off the origin (cam2world
    pose), depth 2 m everywhere (8000 in 1/4000 m)."""
    from PIL import Image

    from ponderv2_tpu.datasets.preprocessing.preprocess_s3dis import (
        load_alignment, parse_room)

    H, W, f = 12, 16, 15.0
    ann = tmp_path / "Area_1" / "office_1" / "Annotations"
    ann.mkdir(parents=True)
    xs, ys = np.meshgrid(np.arange(-1.5, 1.5, 0.05), np.arange(-1.5, 1.5, 0.05))
    wall = np.stack([xs.ravel(), ys.ravel(), np.full(xs.size, 2.0)], 1)
    rng = np.random.RandomState(0)
    np.savetxt(ann / "wall_1.txt", np.concatenate(
        [wall, rng.randint(0, 255, (len(wall), 3))], 1))
    np.savetxt(tmp_path / "Area_1" / "Area_1_alignmentAngle.txt",
               np.array([["office_1", "0"]], dtype=object), fmt="%s")
    raw = tmp_path / "raw"
    (raw / "area_1" / "3d").mkdir(parents=True)
    (raw / "area_1" / "3d" / "camera_to_room.json").write_text('{"cam0": "office_1_1"}')
    rdir = raw / "area_1" / "raw"
    rdir.mkdir()
    a = 0.3
    pose = np.eye(4)
    pose[:3, :3] = [[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]]
    pose[:3, 3] = [0.3, -0.2, 0.0]
    np.savetxt(rdir / "cam0_pose_0_0.txt", pose)
    np.savetxt(rdir / "cam0_intrinsics_0.txt",
               np.array([H, W, f, f, W / 2, H / 2, 0, 0, 0, 0, 0]))
    Image.fromarray(rng.randint(0, 255, (H, W, 3)).astype(np.uint8)).save(
        rdir / "cam0_i0_0.jpg")
    Image.fromarray(np.full((H, W), 8000, np.int32), mode="I").save(rdir / "cam0_d0_0.png")
    rooms, angles = load_alignment(tmp_path)
    out = tmp_path / "out"
    parse_room(rooms[0], angles[0], str(tmp_path), str(raw), str(out),
               align_angle=True, parse_rgbd=True)
    return out


def test_s3dis_preprocessed_views_port_only(s3dis_preprocessed):
    """On the views ``preprocess_s3dis.py`` writes (``rgb``, ``depth`` in
    1/4000 m, ``depth_mask``, ``semantic_map``, cam2world ``extrinsic``) the
    JAX dataset raises ``KeyError: 'color'``; the port's masked depth,
    unprojected, lands on the room's points, its semantics are the view's
    semantic map and its extrinsic is world2cam."""
    cfg = dict(type="S3DISRGBDDataset", split="Area_1", data_root=str(s3dis_preprocessed),
               num_cameras=1)
    with pytest.raises(KeyError, match="color"):
        jbuild_dataset(dict(cfg))[0]
    item = tbuild_dataset(dict(cfg))[0]
    view = torch.load(next((s3dis_preprocessed / "Area_1" / "office_1_rgbd").glob("*.pth")),
                      weights_only=False)
    assert set(view) == {"intrinsic", "extrinsic", "rgb", "depth", "depth_mask",
                         "semantic_map"}
    mask = view["depth_mask"]
    assert mask.sum() >= 100
    np.testing.assert_array_equal(item["depth"][0] > 0, mask)
    np.testing.assert_allclose(item["depth"][0][mask], view["depth"][mask] / 4000.0)
    np.testing.assert_array_equal(item["semantic2d"][0], view["semantic_map"])
    np.testing.assert_allclose(item["extrinsic"][0] @ view["extrinsic"], np.eye(4), atol=1e-6)
    points, _ = unprojected(item, 0)
    assert nearest(points, item["coord"]).max() < MAX_DIST


@pytest.fixture
def structured3d_preprocessed(tmp_path):
    """One Structured3D room through ``preprocess_structured3d.py:
    parse_scene_zip(..., parse_rgbd=True)`` from ``test_preprocessing.py``'s
    zip fixture with a perspective view: ``scene_00000/room_485142.pth``
    (the fused perspective and panorama points) and its view under
    ``room_485142_rgbd/``."""
    import test_preprocessing as tp
    from ponderv2_tpu.datasets.preprocessing.preprocess_structured3d import parse_scene_zip

    zpath = tmp_path / "Structured3D_scene_00000.zip"
    tp.TestStructured3D()._make_zip(zpath, np.random.RandomState(0), rooms=("485142",),
                                    with_prsp=True)
    out = tmp_path / "out"
    parse_scene_zip(str(zpath), str(out), parse_rgbd=True)
    return out


def test_structured3d_preprocessed_views_port_only(structured3d_preprocessed):
    """On ``preprocess_structured3d.py``'s layout the JAX dataset finds no
    room; the port finds the room and its view, with depth in mm masked by
    ``depth_mask``, and its extrinsic, derived from the preprocessor's
    convention chain, puts every unprojected pixel on the fused room
    points the same pixel made."""
    cfg = dict(type="Structured3DRGBDDataset", split="train",
               data_root=str(structured3d_preprocessed), num_cameras=1)
    assert len(jbuild_dataset(dict(cfg))) == 0
    tds = tbuild_dataset(dict(cfg))
    assert [os.path.basename(p) for p in tds.data_list] == ["room_485142.pth"]
    item = tds[0]
    view = torch.load(next((structured3d_preprocessed / "train" / "scene_00000"
                            / "room_485142_rgbd").glob("*.pth")), weights_only=False)
    mask = view["depth_mask"]
    assert mask.sum() >= 20 and (~mask).sum() >= 20
    np.testing.assert_array_equal(item["depth"][0] > 0, mask)
    np.testing.assert_allclose(item["depth"][0][mask], view["depth"][mask] / 1000.0)
    np.testing.assert_array_equal(item["semantic2d"][0], view["semantic_map"])
    points, _ = unprojected(item, 0)
    dist = nearest(points, item["coord"])
    assert dist.max() < 1e-3, dist.max()  # the same pixel's fused point


def test_structured3d_room_list_skips_view_folders_port_only(structured3d_preprocessed):
    """``Structured3DDataset`` (the PPT recipe's) on data preprocessed with
    ``parse_rgbd=True``: the JAX list takes ``room_485142_rgbd`` for a room
    and reading it raises ``KeyError: 'coord'``; the port lists the room
    file only, and reads it as the JAX dataset does."""
    cfg = dict(type="Structured3DDataset", split="train",
               data_root=str(structured3d_preprocessed))
    jds, tds = jbuild_dataset(dict(cfg)), tbuild_dataset(dict(cfg))
    assert [os.path.basename(p) for p in jds.data_list] == ["room_485142.pth",
                                                            "room_485142_rgbd"]
    with pytest.raises(KeyError, match="coord"):
        jds[1]
    assert tds.data_list == jds.data_list[:1]
    assert_same_tree(jds[0], tds[0], "room")


def test_view_without_known_keys_raises(tmp_path):
    """A view with neither set of keys names the keys it holds."""
    room = tmp_path / "Area_1" / "office_1"
    room.parent.mkdir(parents=True)
    torch.save(dict(coord=np.zeros((4, 3), np.float32)), str(room) + ".pth")
    (tmp_path / "Area_1" / "office_1_rgbd").mkdir()
    torch.save(dict(image=np.zeros((2, 2, 3))), tmp_path / "Area_1" / "office_1_rgbd" / "v.pth")
    ds = tbuild_dataset(dict(type="S3DISRGBDDataset", split="Area_1",
                             data_root=str(tmp_path), num_cameras=1))
    with pytest.raises(KeyError, match=r"holds \['image'\]"):
        ds[0]


# -------------------------------------------------------------------- loader
def _synthetic(n, loop=1, condition=None):
    transform = [dict(type="GridSample", grid_size=0.1, hash_type="fnv", mode="train",
                      return_grid_coord=True)]
    keys = ("coord", "grid_coord", "segment")
    if condition is not None:
        transform.append(dict(type="Add", keys_dict=dict(condition=condition)))
        keys += ("condition",)
    transform.append(dict(type="Collect", keys=keys, feat_keys=("color", "normal")))
    return dict(type="SyntheticDataset", num_scenes=n, points_per_scene=60, num_classes=5,
                loop=loop, transform=transform)


def _loaders(datasets, batch_size=1, concat_loop=1):
    """The JAX and the port loader over the same ``ConcatDataset`` config."""
    cfg = dict(type="ConcatDataset", datasets=datasets, loop=concat_loop)
    return [loader(build(dict(cfg)), batch_size_per_dataset=batch_size, point_budget=512)
            for build, loader in ((jbuild_dataset, JLoader), (tbuild_dataset, TLoader))]


def test_without_add_the_condition_is_the_class_name_as_in_jax():
    """As ``tests/test_data.py::test_multidataset_round_robin``: without an
    ``Add`` transform every batch's condition is the dataset's class name."""
    for loader in _loaders([_synthetic(4, loop=2), _synthetic(4)], batch_size=2):
        conditions = [b["condition"] for b in loader]
        assert conditions and conditions.count("SyntheticDataset") == len(conditions)


def test_add_condition_reaches_the_batch_port_only():
    """With ``Add``, the port's batches keep each scene's condition (F1); the
    JAX loader overwrites it with the class name."""
    jl, tl = _loaders([_synthetic(4, loop=2, condition="A"), _synthetic(2, condition="B")],
                      batch_size=2)
    assert [b["condition"] for b in tl] == [["A", "A"], ["A", "A"], ["B", "B"]]
    assert {b["condition"] for b in jl} == {"SyntheticDataset"}


@pytest.mark.parametrize("ratios", [(2, 1, 1), (1, 1), (3, 2)])
def test_len_is_the_batches_yielded(ratios):
    """For 1-6 main batches: ``len()`` equals the batches ``__iter__``
    yields, in whole rounds of ``ratio_i`` batches of dataset i, then the
    main dataset's ``m % r0`` left (F2). The JAX loader's ``len()`` counts
    whole rounds while its ``__iter__`` stops after the main loader's last
    batch."""
    disagree = 0
    for m in range(1, 7):
        datasets = [_synthetic(m, loop=ratios[0], condition="d0")] + [
            _synthetic(2, loop=r, condition=f"d{i + 1}") for i, r in enumerate(ratios[1:])]
        jl, tl = _loaders(datasets)
        order = [b["condition"][0] for b in tl]
        round_ = [f"d{i}" for i, r in enumerate(ratios) for _ in range(r)]
        assert order == round_ * (m // ratios[0]) + ["d0"] * (m % ratios[0]), (m, order)
        assert len(tl) == len(order)
        disagree += len(jl) != len(list(jl))
    assert disagree >= 1


def test_jax_loader_stops_early_port_only():
    """The table of F2 under ratios (2, 1, 1): with 2, 3 and 4 main batches
    the JAX loader's ``len()`` is 4, 7, 8 and it yields 2, 5, 6 batches
    (with 2, the second and third datasets' turns never come); the port's
    ``len()`` and batches are 4, 5, 8."""
    for m, jlen, jyield, tlen in ((2, 4, 2, 4), (3, 7, 5, 5), (4, 8, 6, 8)):
        jl, tl = _loaders([_synthetic(m, loop=2), _synthetic(2), _synthetic(2)])
        assert (len(jl), len(list(jl))) == (jlen, jyield)
        assert len(tl) == len(list(tl)) == tlen


def test_shared_batches_match_jax(seeded):
    """Seeded alike, the batches both loaders yield are byte-equal but for
    the condition, which the JAX loader overwrites."""
    datasets = [_synthetic(3, loop=2, condition="A"), _synthetic(3, condition="B"),
                _synthetic(2, condition="C")]
    batches = []
    for loader in _loaders(datasets):
        seeded()
        batches.append(list(loader))
    jb, tb = batches
    assert (len(jb), len(tb)) == (5, 5)
    for i, (j, t) in enumerate(zip(jb, tb)):
        assert j.pop("condition") == "SyntheticDataset"
        assert t.pop("condition") == [["A", "A", "B", "C", "A"][i]]
        assert_same_tree(j, t, f"batch {i}")


def test_epoch_loop_reaches_the_main_dataset_port_only():
    """The ``ConcatDataset``'s loop (the config parser's ``epoch //
    eval_epoch``) becomes the main dataset's loop, so an epoch runs that
    many passes of it (F3); the JAX loader sets it to 1."""
    jl, tl = _loaders([_synthetic(2, loop=2), _synthetic(2)], concat_loop=3)
    assert [ds.loop for ds in tl.datasets] == [3, 1] and len(tl.loaders[0]) == 6
    assert [ds.loop for ds in jl.datasets] == [1, 1] and len(jl.loaders[0]) == 2
    assert len(tl) == len(list(tl)) == 3 * 3


# --------------------------------------------------------------------- remat
def test_remat_keeps_running_stats_and_grads():
    """SpUNet-v1m1 with ``remat`` (each block and conv unit checkpointed)
    against without: one training forward and backward of PonderIndoor-v2
    with the same draws gives the same loss and running statistics (the
    recomputed forward does not move them a second time) and the same
    backbone grads within 1e-5 of their max."""
    from ponderv2_tpu_torch.models import build_model
    from test_torch_pretrain_step import CFG, pretrain_batch

    arrays = {k: torch.from_numpy(v) for k, v in pretrain_batch().items()}
    B, V, H, W = arrays["depth"].shape
    runs = {}
    for remat in (False, True):
        model = build_model(dict(CFG.model, backbone=dict(CFG.model.backbone, remat=remat)))
        model.reset_parameters(torch.Generator().manual_seed(0))
        model.train()
        draws = model.draw_noise(torch.Generator().manual_seed(0), B, V, H * W)
        out = model({**arrays, "spatial_shape": tuple(CFG.sparse_shape), "batch_size": B,
                     "draws": draws})
        out["loss"].backward()
        runs[remat] = (out["loss"].item(),
                       {k: v.clone() for k, v in model.state_dict().items() if "running" in k},
                       {n: p.grad for n, p in model.named_parameters()
                        if n.startswith("backbone.")})
    (l0, s0, g0), (l1, s1, g1) = runs[False], runs[True]
    assert l0 == l1
    moved = [k for k in s0 if k.startswith("backbone.")]
    assert moved and all(torch.equal(s0[k], s1[k]) for k in s0)
    for name, g in g0.items():
        scale = g.abs().max().item()
        assert (g1[name] - g).abs().max().item() <= 1e-5 * max(scale, 1e-12), name


def test_spunet_v1m1_remat_default_is_the_jax_one():
    """SpUNet-v1m1's ``remat`` is on by default in both packages, so a config
    that names none (the multi-dataset pretrain, the insseg base recipe)
    runs checkpointed in both."""
    import inspect

    from ponderv2_tpu.models.sparse_unet.spunet import SpUNet as JSpUNet
    from ponderv2_tpu_torch.models.sparse_unet.spunet import SpUNet as TSpUNet

    default = inspect.signature(TSpUNet).parameters["remat"].default
    assert default is JSpUNet.__dataclass_fields__["remat"].default is True


# ----------------------------------------------------------- CLI and configs
def tiny_multi_cfg(roots, save_path):
    """``chip_smoke.py`` phase 15's options on ``roots``, with the model cut
    to ``configs/_test_/pretrain_synthetic.py``'s widths (its three
    conditions, class vocabulary and losses kept, the backbone's ``remat``
    on), batch 2, on the CPU."""
    from ponderv2_tpu_torch.engines.defaults import default_config_parser

    tiny = TConfig.fromfile(os.path.join(ROOT, "configs/_test_/pretrain_synthetic.py"))
    opts = chip_smoke.multi_pretrain_options(roots, save_path, 0)
    opts.update({"batch_size": 2, "point_budget": 4096, "device": "cpu",
                 "sparse_shape": list(tiny.sparse_shape),
                 "model.grid_shape": list(tiny.model.grid_shape), "model.ray_nsample": 8,
                 "model.backbone": dict(tiny.model.backbone, remat=True),
                 **{f"model.{k}": dict(tiny.model[k]) for k in ("projection", "renderer")}})
    return default_config_parser(chip_smoke.MULTI_CONFIG, opts)


def test_train_cli_runs_the_multidataset_trainer_on_cpu(tmp_path, small_roots):
    """``tools/train_torch.py:main_worker`` on the multi-dataset config cut
    to test widths, over phase 15's scenes: the scheduler's total steps are
    the steps taken (one round: 2 Structured3D batches, then ScanNet's and
    S3DIS's), every batch's condition reaches the model, and the checkpoint
    holds the last step."""
    from train_torch import main_worker

    cfg = tiny_multi_cfg(small_roots, str(tmp_path / "save"))
    records = {"steps": [], "conditions": []}
    cfg.hooks = list(cfg.hooks) + [dict(type=chip_smoke.step_probe(records))]
    trainer = main_worker(cfg)
    assert cfg.train.type == "MultiDatasetTrainer" and trainer.model.backbone.remat
    assert len(trainer.train_loader) == len(records["steps"]) == trainer.step == 4
    assert records["conditions"] == chip_smoke.MULTI_ORDER
    assert all(np.isfinite(m["loss"]) and m["contract_ok"] == 1.0 for m in records["steps"])
    assert all(torch.isfinite(t["ppt_loss"]) for t in records["terms"])
    ckpt = torch.load(tmp_path / "save" / "model" / "model_last.pth", weights_only=True)
    assert ckpt["step"] == 4


@pytest.mark.parametrize("name", ["scannet", "s3dis", "structured3d"])
def test_single_dataset_pretrain_configs_build_on_files(small_roots, name):
    """The ScanNet, S3DIS and Structured3D pretrain configs build their
    models and their train datasets in the port over phase 15's scene
    files, each item with its views in the model's input layout. The
    configs' ``field.feature_dim`` (the JAX field ignores it and infers the
    volume's width) no longer clashes with the width the model passes."""
    from ponderv2_tpu_torch.models import build_model

    cfg = TConfig.fromfile(os.path.join(ROOT, f"configs/{name}/pretrain-ponder-spunet-v1m1-0-base.py"))
    model = build_model(dict(cfg.model))
    assert cfg.model.renderer.field.feature_dim == cfg.model.projection.out_channels == 128
    assert model.renderer.field.sdf_decoder is not None
    data = dict(cfg.data.train, data_root=small_roots[name], num_cameras=2)
    if name == "scannet":
        data["rgbd_root"] = small_roots["scannet_rgbd"]
    ds = tbuild_dataset(data)
    assert len(ds) == {"scannet": 2, "s3dis": 5, "structured3d": 4}[name]
    item = ds[0]
    assert item["rgb"].shape == (2, 24, 32, 3) and item["extrinsic"].shape == (2, 4, 4)
    assert item["semantic2d"].max() < cfg.num_classes
    assert "condition" not in item  # one condition: the Collect keeps none


def test_chip_smoke_multi_phase_keeps_the_config(tmp_path, small_roots):
    """Phase 15 runs the multi-dataset config with only its data roots,
    epochs, save path and ``num_worker`` changed (plus what the config
    parser derives: the seed and the train loop), so the backbone's
    ``remat`` is the default, on, as in JAX, and the scenes it writes
    read back through the port's datasets with every view's depth on the
    scene's points (within the pixel's footprint and the depth unit)."""
    from ponderv2_tpu_torch.engines.defaults import default_config_parser
    from test_torch_data import _comparable, _flat

    opts = chip_smoke.multi_pretrain_options(small_roots, str(tmp_path / "save"), 2)
    base = _flat(_comparable(MULTI_CFG.to_dict()))
    run = default_config_parser(chip_smoke.MULTI_CONFIG, dict(opts))
    flat = _flat(_comparable(run.to_dict()))
    changed = {k for k in base.keys() | flat.keys() if base.get(k) != flat.get(k)}
    assert changed <= {"data.train.datasets", "epoch", "eval_epoch", "save_path",
                       "num_worker", "seed", "data.train.loop"}
    assert "remat" not in run.model.backbone
    for i, ds in enumerate(run.data.train.datasets):
        want = dict(MULTI_CFG.data.train.datasets[i], **{
            k.rsplit(".", 1)[1]: v for k, v in opts.items()
            if k.startswith(f"data.train.datasets.{i}.")})
        assert dict(ds) == want
    assert run.batch_size == 8 and run.point_budget == 1_048_576
    assert run.model.backbone.type == "SpUNet-v1m1" and "compute_dtype" not in run.model.backbone
    assert run.model.conditions == ("Structured3D", "ScanNet", "S3DIS")
    assert (run.epoch, run.eval_epoch, run.data.train.loop) == (1, 1, 1)

    for i, (name, key) in enumerate((("Structured3D", "structured3d"), ("ScanNet", "scannet"),
                                     ("S3DIS", "s3dis"))):
        cfg = dict(run.data.train.datasets[i], transform=[], num_cameras=3, loop=1)
        ds = tbuild_dataset(cfg)
        assert len(ds) == {"structured3d": 4, "scannet": 2, "s3dis": 5}[key]
        item = ds[len(ds) - 1]
        f = item["intrinsic"][0, 0, 0]
        unit = {"structured3d": 1e-3, "scannet": 0.0, "s3dis": 2.5e-4}[key]
        for v in range(3):
            points, z = unprojected(item, v)
            assert len(points) >= 20
            # the z-buffer puts a point at its rounded pixel: half a pixel's
            # diagonal off the pixel's ray, plus the file's depth unit
            assert (nearest(points, item["coord"]) <= 0.71 * z / f + unit + 1e-5).all(), name
