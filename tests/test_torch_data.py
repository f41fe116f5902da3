"""PyTorch port vs JAX package: the copied data path, tester votes, and the
port's independence from JAX."""

import os
import random
import re
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ponderv2_tpu.datasets import build_dataset as jbuild_dataset
from ponderv2_tpu.datasets.utils import collate_fn as jcollate
from ponderv2_tpu.engines.test import SemSegTester as JSemSegTester
from ponderv2_tpu.utils.config import Config as JConfig
from ponderv2_tpu_torch.datasets import build_dataset as tbuild_dataset
from ponderv2_tpu_torch.datasets import collate_fn as tcollate
from ponderv2_tpu_torch.engines.test import SemSegTester as TSemSegTester
from ponderv2_tpu_torch.utils.config import Config as TConfig
from ponderv2_tpu_torch.utils.logger import get_root_logger
from torch_threads import _torch_threads  # noqa: F401, E402  (autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCANNET_TEST_CFG = os.path.join(
    ROOT, "configs/_test_/semseg_spunet_scannet_synthetic.py")


@pytest.fixture(autouse=True)
def _torch_state():
    dtype, threads = torch.get_default_dtype(), torch.get_num_threads()
    torch.set_default_dtype(torch.float32)
    torch.set_num_threads(2)
    yield
    torch.set_default_dtype(dtype)
    torch.set_num_threads(threads)


@pytest.fixture
def np_global_seed():
    """Seed numpy's global generator (the transforms draw from it) and
    restore it afterwards."""
    state = np.random.get_state()
    yield lambda: np.random.seed(0)
    np.random.set_state(state)


def _test_data_cfg(points):
    cfg = dict(TConfig.fromfile(SCANNET_TEST_CFG).data.test)
    cfg["points_per_scene"] = points
    return cfg


def assert_same(a, b, where):
    """Byte-equal: same type, dtype, shape and values."""
    if isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), where
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert a.tobytes() == b.tobytes(), where
    else:
        assert a == b, where


class TestDataPath:
    def test_synthetic_config_keeps_scannet_test_path(self):
        """The synthetic serving config is the ScanNet one with only the test
        scenes swapped: same model, sparse_shape, transform and test_cfg."""
        base = TConfig.fromfile(os.path.join(
            ROOT, "configs/scannet/semseg-spunet-v1m1-0-base.py"))
        cfg = TConfig.fromfile(SCANNET_TEST_CFG)
        assert cfg.model == base.model
        assert tuple(cfg.sparse_shape) == tuple(base.sparse_shape)
        for key in ("transform", "test_mode", "test_cfg"):
            assert cfg.data.test[key] == base.data.test[key], key
        assert cfg.data.test.type == "SyntheticDataset"
        assert cfg.point_budget_test == 131072

    def test_scannet_test_fragments_and_batches(self, np_global_seed):
        """The ScanNet test transform + test_cfg (GridSample test mode, 4
        rotations) give byte-equal fragments and collated batches."""
        cfg = _test_data_cfg(4000)
        jds, tds = jbuild_dataset(dict(cfg)), tbuild_dataset(dict(cfg))
        assert len(jds) == len(tds) == 2
        for i in range(2):
            np_global_seed()
            j = jds[i]
            np_global_seed()
            t = tds[i]
            assert j["name"] == t["name"]
            assert_same(j["segment"], t["segment"], "segment")
            assert len(j["fragment_list"]) == len(t["fragment_list"]) >= 4
            for fj, ft in zip(j["fragment_list"], t["fragment_list"]):
                assert sorted(fj) == sorted(ft)
                for k in fj:
                    assert_same(fj[k], ft[k], k)
                bj = jcollate([dict(fj)], point_budget=4096, scene_budget=1)
                bt = tcollate([dict(ft)], point_budget=4096, scene_budget=1)
                assert sorted(bj) == sorted(bt)
                for k in bj:
                    assert_same(bj[k], bt[k], k)

    def test_train_transforms_and_multi_scene_collate(self, np_global_seed):
        """Random transforms draw the same numbers; a two-scene collate with
        padding agrees too."""
        transform = [
            dict(type="CenterShift", apply_z=True),
            dict(type="RandomRotate", angle=[-1, 1], axis="z", p=0.5),
            dict(type="PositiveShift"),
            dict(type="GridSample", grid_size=0.05, hash_type="fnv",
                 mode="train", return_grid_coord=True),
            dict(type="NormalizeColor"),
            dict(type="Collect", keys=("coord", "grid_coord", "segment"),
                 feat_keys=("color", "normal")),
        ]
        cfg = dict(type="SyntheticDataset", num_scenes=2, points_per_scene=2000,
                   num_classes=20, transform=transform)
        np_global_seed()
        j = [jbuild_dataset(dict(cfg))[i] for i in range(2)]
        np_global_seed()
        t = [tbuild_dataset(dict(cfg))[i] for i in range(2)]
        bj = jcollate(j, point_budget=4096, scene_budget=2)
        bt = tcollate(t, point_budget=4096, scene_budget=2)
        assert sorted(bj) == sorted(bt)
        for k in bj:
            assert_same(bj[k], bt[k], k)


SCANNET_TRAIN_CFG = os.path.join(
    ROOT, "configs/_test_/semseg_spunet_scannet_synthetic_train.py")
SCANNET_BASE_CFG = os.path.join(ROOT, "configs/scannet/semseg-spunet-v1m1-0-base.py")


class TestTrainDataPath:
    def test_synthetic_train_config_keeps_scannet_train_path(self):
        """The synthetic training config is the ScanNet one with only the
        train/val scenes swapped and one epoch with one evaluation."""
        base = TConfig.fromfile(SCANNET_BASE_CFG)
        cfg = TConfig.fromfile(SCANNET_TRAIN_CFG)
        for key in ("model", "optimizer", "scheduler", "batch_size",
                    "point_budget", "point_budget_val", "mix_prob", "num_worker"):
            assert cfg[key] == base[key], key
        assert tuple(cfg.sparse_shape) == tuple(base.sparse_shape)
        for split in ("train", "val"):
            assert cfg.data[split].transform == base.data[split].transform, split
            assert cfg.data[split].type == "SyntheticDataset"
        assert (cfg.data.train.num_scenes, cfg.data.val.num_scenes) == (36, 2)
        assert cfg.epoch == cfg.eval_epoch == 1

    def test_copied_sources_are_the_jax_ones(self):
        """Every function and class the port copied for the training slice
        has the JAX package's source, byte for byte."""
        import inspect

        import ponderv2_tpu.datasets.dataloader as jdl
        import ponderv2_tpu.datasets.defaults as jdef
        import ponderv2_tpu.datasets.s3dis as js3
        import ponderv2_tpu.datasets.scannet as jsc
        import ponderv2_tpu.datasets.ppt_vocab as jvocab
        import ponderv2_tpu.datasets.preprocessing.scannet200_constants as jsc200
        import ponderv2_tpu.datasets.transform as jtr
        import ponderv2_tpu.utils.clip_text as jclip
        import ponderv2_tpu.utils.env as jenv
        import ponderv2_tpu.utils.events as jev
        import ponderv2_tpu.utils.timer as jtm
        import ponderv2_tpu.engines.hooks.evaluator as jhev
        import ponderv2_tpu.models.point_group.cluster as jcl
        import ponderv2_tpu.models.point_group.point_group as jpg
        import ponderv2_tpu.datasets.preprocessing.sensor_data as jsens
        import ponderv2_tpu.datasets.preprocessing.preprocess_scannet as jpsc
        import ponderv2_tpu.datasets.preprocessing.preprocess_s3dis as jps3
        import ponderv2_tpu.datasets.preprocessing.preprocess_s3dis_voxelized as jvox
        import ponderv2_tpu.datasets.preprocessing.preprocess_structured3d as js3d
        import ponderv2_tpu_torch.datasets.dataloader as tdl
        import ponderv2_tpu_torch.datasets.defaults as tdef
        import ponderv2_tpu_torch.datasets.s3dis as ts3
        import ponderv2_tpu_torch.datasets.scannet as tsc
        import ponderv2_tpu_torch.datasets.ppt_vocab as tvocab
        import ponderv2_tpu_torch.datasets.preprocessing.scannet200_constants as tsc200
        import ponderv2_tpu_torch.datasets.transform as ttr
        import ponderv2_tpu_torch.utils.clip_text as tclip
        import ponderv2_tpu_torch.utils.env as tenv
        import ponderv2_tpu_torch.utils.events as tev
        import ponderv2_tpu_torch.utils.timer as ttm
        import ponderv2_tpu_torch.engines.hooks.evaluator as thev
        import ponderv2_tpu_torch.models.point_group.cluster as tcl
        import ponderv2_tpu_torch.models.point_group.point_group as tpg
        import ponderv2_tpu_torch.datasets.preprocessing.sensor_data as tsens
        import ponderv2_tpu_torch.datasets.preprocessing.preprocess_scannet as tpsc
        import ponderv2_tpu_torch.datasets.preprocessing.preprocess_s3dis as tps3
        import ponderv2_tpu_torch.datasets.preprocessing.preprocess_s3dis_voxelized as tvox
        import ponderv2_tpu_torch.datasets.preprocessing.preprocess_structured3d as ts3d

        copies = [
            (jtr, ttr, ["RandomScale", "RandomFlip", "RandomJitter", "RandomDropout",
                        "ElasticDistortion", "ChromaticAutoContrast",
                        "ChromaticTranslation", "ChromaticJitter", "SphereCrop",
                        "ShufflePoint"]),
            (jdl, tdl, ["_worker_init", "build_dataloader", "_TorchDatasetAdapter"]),
            (jenv, tenv, ["derive_seed"]),
            (jev, tev, ["get_event_storage", "HistoryBuffer", "EventStorage",
                        "EventWriter", "JSONWriter", "TensorboardWriter",
                        "CommonMetricPrinter"]),
            (jtm, ttm, ["Timer"]),
            # the pretrain slice
            (jdef, tdef, ["_lookat_world2cam", "SyntheticRGBDDataset"]),
            (jclip, tclip, ["_fallback_embeddings", "_find_committed_asset",
                            "get_text_embeddings"]),
            # the file-backed datasets of the PPT fine-tune recipe;
            # DefaultDataset's scene cache is keyed on the run (below)
            (jdef, tdef, ["load_scene", "ConcatDataset"]),
            (jtr, ttr, ["Add"]),
            # (ScanNetDataset is no longer a copy: the JAX one fails on a
            # one-scene lr_file and an la_file of numpy arrays, ROADMAP
            # Queue 3; test_scannet_lr_la_files_port_only holds the port's)
            (jsc, tsc, ["ScanNet200Dataset"]),
            # S3DISDataset's get_data_list skips the {room}_rgbd folders (F7,
            # tests/test_torch_preprocessing.py)
            (js3.S3DISDataset, ts3.S3DISDataset, ["get_data"]),
            # the multi-dataset pretrain's; S3DISRGBDDataset, Structured3DDataset
            # and Structured3DRGBDDataset differ from the JAX ones where those
            # fail (tests/test_torch_multidataset.py)
            # (but _load_dir_frame, which reads through the port's codec,
            # tests/test_torch_preprocessing.py)
            (jsc.ScanNetRGBDDataset, tsc.ScanNetRGBDDataset,
             ["__init__", "_get_axis_align_matrix", "get_data"]),
            # instance segmentation's (tests/test_torch_insseg.py holds
            # csrc/cluster.cpp and the native BFS against the JAX ones)
            (jtr, ttr, ["InstanceParser"]),
            (jhev, thev, ["_associate_scene", "_scannet_ap", "evaluate_instance_ap"]),
            (jcl, tcl, ["cluster_proposals"]),
            # the transforms no recipe names (``_index_points`` and
            # ``CenterShift``, which they call or sit beside, differ: F14)
            (jtr, ttr, ["Copy", "ToTensor", "NormalizeCoord", "ClipGaussianJitter",
                        "PointClip", "RandomColorGrayScale", "RandomColorJitter",
                        "RandomColorDrop", "HueSaturationTranslation", "CropBoundary",
                        "ContrastiveViewsGenerator"]),
            # the preprocessors: the JAX ones but where they read or write
            # images (the port's codec) or meshes (its PLY reader), and
            # ScanNet's F16 / F17 (tests/test_torch_preprocessing.py)
            (jsens, tsens, ["_read_mat4", "SensStream", "read_label_mapping",
                            "map_label_image", "main"]),
            (jsens.SensFrame, tsens.SensFrame, ["decode_depth"]),
            (jpsc, tpsc, ["face_normals"]),
            (jps3, tps3, ["load_alignment", "_align_rotation", "parse_room_points",
                          "_mesh_normals", "undistort_image", "unproject_filtering_depths"]),
            (jvox, tvox, ["_load", "_save", "voxelize_room", "main_process"]),
            (js3d, ts3d, ["normal_from_cross_product", "_remap25", "scene_split",
                          "parse_scene", "parse_scene_zip", "main"]),
            (js3d.Structured3DReader, ts3d.Structured3DReader,
             ["__init__", "filelist", "listdir", "read", "read_camera"]),
        ]
        for jmod, tmod, names in copies:
            for name in names:
                assert inspect.getsource(getattr(tmod, name)) == inspect.getsource(
                    getattr(jmod, name)), f"{tmod.__name__}.{name}"
        assert inspect.getsource(tpg.PointGroup.propose_instances) == inspect.getsource(
            jpg.PointGroup.propose_instances)
        for jmod, tmod, names in [(jsc, tsc, ["VALID_CLASS_IDS_20", "CLASS_NAMES_20"]),
                                  (js3, ts3, ["S3DIS_CLASS_NAMES"]),
                                  (jsens, tsens, ["COLOR_COMPRESSION", "DEPTH_COMPRESSION"]),
                                  (jpsc, tpsc, ["VALID_CLASS_IDS_20"]),
                                  (jps3, tps3, ["CLASS_NAMES", "CLASS2ID"]),
                                  (js3d, ts3d, ["VALID_CLASS_IDS_25", "CLASS_NAMES_25"])]:
            for name in names:
                assert getattr(tmod, name) == getattr(jmod, name), name
        # the data modules the configs import (utils/config.py:PORTED_MODULES),
        # the scene cache and ScanNet200's split tables, whole
        import ponderv2_tpu.datasets.preprocessing.scannet200_splits as jsplits
        import ponderv2_tpu_torch.datasets.preprocessing.scannet200_splits as tsplits

        # (the scene cache, ``utils/cache.py``, is no longer a copy: the JAX
        # one keys every run's segments on the data root's basename in one
        # host-wide namespace, ROADMAP Queue 3's cache-key fault; the port's
        # is keyed on the run, tests/test_torch_origin_eval.py holds it)
        import ponderv2_tpu.utils.visualization as jvis
        import ponderv2_tpu_torch.utils.visualization as tvis

        import ponderv2_tpu.datasets.preprocessing.preprocess_nuscenes as jpnus
        import ponderv2_tpu_torch.datasets.preprocessing.preprocess_nuscenes as tpnus

        assert (tps3.AREA_5B_POSE_FIX == jps3.AREA_5B_POSE_FIX).all()
        for name in ("quat_to_matrix", "transform_matrix", "quaternion_yaw",
                     "sensor2top_transform", "gt_boxes_from_annotations",
                     "_obtain_sensor2top", "build_infos", "main"):
            assert inspect.getsource(getattr(tpnus, name)) == inspect.getsource(
                getattr(jpnus, name)), name
        assert tpnus.CAMERA_TYPES == jpnus.CAMERA_TYPES
        assert (tpnus.MAP_NAME_FROM_GENERAL_TO_DETECTION
                == jpnus.MAP_NAME_FROM_GENERAL_TO_DETECTION)
        for jmod, tmod in [(jvocab, tvocab), (jsc200, tsc200), (jsplits, tsplits),
                           (jvis, tvis)]:
            with open(jmod.__file__, "rb") as fj, open(tmod.__file__, "rb") as ft:
                assert fj.read() == ft.read(), tmod.__name__
        # DefaultDataset is the JAX one but for the cache key of get_data and
        # the run key its trainer sets (the cache-key fault)
        jsrc = inspect.getsource(jdef.DefaultDataset).replace(
            "        self.cache = cache\n",
            "        self.cache = cache\n"
            "        self.cache_run = None\n").replace(
            '            cache_name = f"ponderv2-{os.path.basename(self.data_root)}-'
            '{os.path.basename(path)}"\n',
            "            cache_name = scene_cache_name(self.data_root, path)\n").replace(
            "return dict(shared_dict(cache_name))",
            "return dict(shared_dict(cache_name, run=self.cache_run))").replace(
            "return dict(shared_dict(cache_name, data))",
            "return dict(shared_dict(cache_name, data, run=self.cache_run))")
        assert jsrc.count("run=self.cache_run") == 2
        assert inspect.getsource(tdef.DefaultDataset) == jsrc

    def test_scannet_train_batches_match_jax(self, np_global_seed):
        """The ScanNet train transform (every random augmentation) and the
        train loader's Mix3D collate give byte-equal batches."""
        import random

        from ponderv2_tpu.datasets.dataloader import build_dataloader as jloader
        from ponderv2_tpu_torch.datasets import build_dataloader as tloader

        cfg = dict(TConfig.fromfile(SCANNET_TRAIN_CFG).data.train)
        cfg.update(num_scenes=4, points_per_scene=3000)
        batches = {}
        for name, build, loader in [("jax", jbuild_dataset, jloader),
                                    ("torch", tbuild_dataset, tloader)]:
            np_global_seed()
            random.seed(0)  # the Mix3D draw
            batches[name] = list(loader(
                build(dict(cfg)), batch_size=2, shuffle=False, drop_last=True,
                point_budget=8192, scene_budget=2, mix_prob=0.8))
        assert len(batches["jax"]) == len(batches["torch"]) == 2
        mixed = 0
        for bj, bt in zip(batches["jax"], batches["torch"]):
            assert sorted(bj) == sorted(bt)
            for k in bj:
                assert_same(bj[k], bt[k], k)
            mixed += int(bt["batch"].max() == 0)
        assert mixed >= 1  # Mix3D merged a pair at least once

    def test_config_parser_rebases_epochs_like_jax(self, tmp_path):
        """The ScanNet config (epoch 800, eval_epoch 100) through both
        parsers: 100 outer epochs of 8 data loops, and save_path/model made."""
        from ponderv2_tpu.engines.defaults import default_config_parser as jparse
        from ponderv2_tpu_torch.engines.defaults import default_config_parser as tparse

        cfgs = {}
        for name, parse in [("jax", jparse), ("torch", tparse)]:
            save = tmp_path / name
            cfgs[name] = parse(SCANNET_BASE_CFG, {"save_path": str(save)})
            assert (save / "model").is_dir() and (save / "config.py").is_file()
        for cfg in cfgs.values():
            assert cfg.eval_epoch == 100 and cfg.data.train.loop == 8


def _oracle_logits(feat):
    """Deterministic logits of the features, the same for both testers."""
    w = np.random.RandomState(3).randn(feat.shape[1], 20).astype(np.float32)
    return np.tanh(np.asarray(feat, np.float32) @ w) * 4.0


class _JOracle(JSemSegTester):
    def __init__(self, cfg, dataset):
        self.logger = get_root_logger()
        self.cfg, self.test_dataset = cfg, dataset

    def eval_fragment(self, arrays):
        return {"seg_logits": jnp.asarray(_oracle_logits(arrays["feat"]))}


class _TOracle(TSemSegTester):
    def __init__(self, cfg, dataset):
        self.logger = get_root_logger()
        self.cfg, self.test_dataset = cfg, dataset

    def eval_fragment(self, arrays):
        return {"seg_logits": _oracle_logits(arrays["feat"])}


def test_semseg_tester_votes_match_jax(tmp_path, np_global_seed):
    """Same logits in, identical fragment votes and saved predictions out."""
    data_cfg = _test_data_cfg(3000)
    metrics = {}
    for name, tester_cls, config_cls, build in [
            ("jax", _JOracle, JConfig, jbuild_dataset),
            ("torch", _TOracle, TConfig, tbuild_dataset)]:
        np_global_seed()
        cfg = config_cls(dict(save_path=str(tmp_path / name),
                              point_budget_test=4096,
                              data=dict(num_classes=20, ignore_index=-1)))
        metrics[name] = tester_cls(cfg, build(dict(data_cfg))).test()
    for scene in ("synthetic_0", "synthetic_1"):
        pj = np.load(tmp_path / "jax" / "result" / f"{scene}_pred.npy")
        pt = np.load(tmp_path / "torch" / "result" / f"{scene}_pred.npy")
        np.testing.assert_array_equal(pj, pt)
    for k in ("m_iou", "m_acc", "all_acc"):
        assert metrics["jax"][k] == metrics["torch"][k]


# -------------------------------------------------- file-backed datasets
# The PPT fine-tune recipes' datasets read processed scenes from data_root:
# small ones are written to tmp_path in each dataset's layout.

PPT_CONFIGS = {
    "scannet": "configs/scannet/semseg-ppt-v1m1-0-sc-s3-st-spunet-lovasz-ft.py",
    "scannet200": "configs/scannet200/semseg-ppt-v1m1-0-spunet-lovasz-ft.py",
    "s3dis": "configs/s3dis/semseg-ppt-v1m1-0-s3-sc-st-spunet-lovasz-ft.py",
}


def write_scene_files(root, points=1500):
    """Processed scenes, dicts of numpy arrays in ``.pth`` files: ScanNet's
    ``{train,val}/sceneXXXX_XX.pth``, S3DIS's ``Area_N/room.pth`` and
    Structured3D's ``train/scene_XXXXX/room_N/`` directories. Returns
    {dataset: data_root}."""
    rng = np.random.RandomState(0)

    def scene(**labels):
        out = dict(coord=rng.uniform(0, 3, (points, 3)).astype(np.float32),
                   color=rng.randint(0, 256, (points, 3)).astype(np.uint8),
                   normal=rng.randn(points, 3).astype(np.float32),
                   instance_gt=rng.randint(-1, 9, points).astype(np.int16))
        out.update({k: rng.randint(-1, n, points).astype(np.int16)
                    for k, n in labels.items()})
        return out

    files = {
        "scannet/train/scene0000_00.pth": scene(semantic_gt20=20, semantic_gt200=200),
        "scannet/train/scene0001_01.pth": scene(semantic_gt20=20, semantic_gt200=200),
        "scannet/val/scene0002_00.pth": scene(semantic_gt20=20, semantic_gt200=200),
        "s3dis/Area_1/office_1.pth": scene(semantic_gt=13),
        "s3dis/Area_2/hallway_3.pth": scene(semantic_gt=13),
        "s3dis/Area_5/office_2.pth": scene(semantic_gt=13),
        "structured3d/train/scene_00000/room_1/room.pth": scene(semantic_gt25=25),
        "structured3d/train/scene_00001/room_0/room.pth": scene(semantic_gt25=25),
    }
    for rel, data in files.items():
        path = os.path.join(root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        torch.save(data, path)
    return {name: os.path.join(root, name) for name in ("scannet", "s3dis", "structured3d")}


def assert_same_tree(a, b, where=""):
    """Byte-equal nested dicts, lists and arrays."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), where
        for k in a:
            assert_same_tree(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same_tree(x, y, f"{where}[{i}]")
    else:
        assert_same(a, b, where)


def ppt_data_cfgs(data_roots):
    """Each dataset's (train, test) configs: the PPT recipes' transforms and
    test_cfg (Structured3D takes ScanNet's) on the written scenes."""
    cfgs = {}
    for name, path in PPT_CONFIGS.items():
        data = TConfig.fromfile(os.path.join(ROOT, path)).data
        root = data_roots["s3dis" if name == "s3dis" else "scannet"]
        cfgs[name] = [dict(data[split], data_root=root) for split in ("train", "test")]
    cfgs["s3dis"][0]["split"] = ("Area_1", "Area_2")
    cfgs["structured3d"] = [
        dict(c, type="Structured3DDataset", split="train", data_root=data_roots["structured3d"])
        for c in cfgs["scannet"]]
    return cfgs


@pytest.mark.parametrize("name", ["scannet", "scannet200", "s3dis", "structured3d"])
def test_file_dataset_items_and_fragments_match_jax(tmp_path, np_global_seed, name):
    """ScanNet, ScanNet200, S3DIS and Structured3D over scene files, with the
    recipes' transforms (every random augmentation, ``Add``'s condition)
    and test plan (rotations x fragments): byte-equal train items and
    test fragments, and equal collated batches."""
    train_cfg, test_cfg = ppt_data_cfgs(write_scene_files(str(tmp_path)))[name]
    for cfg in (train_cfg, test_cfg):
        jds, tds = jbuild_dataset(dict(cfg)), tbuild_dataset(dict(cfg))
        assert len(jds) == len(tds) >= 1 and jds.data_list == tds.data_list
        for i in range(len(jds)):
            np_global_seed()
            j = jds[i]
            np_global_seed()
            t = tds[i]
            assert_same_tree(j, t, f"{name}[{i}]")
        if cfg is train_cfg:
            assert t["condition"] == {"s3dis": "S3DIS"}.get(name, "ScanNet")
            assert t["segment"].dtype == np.int64
            assert t["feat"].shape[1] == (3 if name == "s3dis" else 6)  # S3DIS: color
            batches = []
            for ds, collate in ((jds, jcollate), (tds, tcollate)):
                np_global_seed()
                items = [ds[0], ds[-1]]
                random.seed(0)  # Mix3D's draw
                batches.append(collate(items, point_budget=4096, mix_prob=0.8,
                                       scene_budget=2))
            bj, bt = batches
            assert_same_tree(bj, bt, f"{name} batch")
            assert bt["condition"] == [t["condition"]] * 2
        else:
            assert len(t["fragment_list"]) >= len(cfg["test_cfg"]["aug_transform"]) >= 1
            assert all(f["condition"] == t["fragment_list"][0]["condition"]
                       for f in t["fragment_list"])


def test_concat_dataset_and_limited_annotation_match_jax(tmp_path, np_global_seed):
    """``ConcatDataset`` over ScanNet and S3DIS, and ScanNet with an
    ``lr_file`` scene list and an ``la_file`` of labelled points: the same
    items as the JAX package's."""
    roots = write_scene_files(str(tmp_path))
    lr_file = tmp_path / "lr.txt"
    lr_file.write_text("scene0001_01\nscene0000_00\n")
    la_file = tmp_path / "la.pth"
    # plain ints: the datasets read it with torch.load's default weights_only
    torch.save({"scene0001_01": list(range(0, 1500, 7)),
                "scene0000_00": list(range(3, 1500, 11))}, la_file)
    cfgs = [
        dict(type="ConcatDataset", loop=2, datasets=[
            dict(type="ScanNetDataset", split="train", data_root=roots["scannet"]),
            dict(type="S3DISDataset", split=("Area_1", "Area_5"), data_root=roots["s3dis"])]),
        dict(type="ScanNetDataset", data_root=roots["scannet"], lr_file=str(lr_file),
             la_file=str(la_file)),
    ]
    for cfg in cfgs:
        jds, tds = jbuild_dataset(dict(cfg)), tbuild_dataset(dict(cfg))
        assert len(jds) == len(tds)
        for i in range(len(jds)):
            assert_same_tree(jds[i], tds[i], f"{cfg['type']}[{i}]")
    assert tds.get_data_name(0) == "scene0001_01" and len(tds) == 2
    assert int((tds[0]["segment"] >= 0).sum()) <= 215
    assert len(tbuild_dataset(dict(cfgs[0]))) == 2 * 4


def test_scannet_lr_la_files_port_only(tmp_path):
    """A one-scene ``lr_file`` and an ``la_file`` that ``torch.save``d numpy
    index arrays: the JAX ``ScanNetDataset`` fails on each (``np.loadtxt``
    gives a 0-d array, which it cannot iterate; ``torch.load``'s default
    ``weights_only`` refuses the arrays). The port's lists the one scene and
    keeps only the listed points' labels."""
    import pickle

    roots = write_scene_files(str(tmp_path))
    lr_file = tmp_path / "lr.txt"
    lr_file.write_text("scene0001_01\n")
    la_file = tmp_path / "la.pth"
    listed = np.arange(0, 1500, 7, dtype=np.int64)
    torch.save({"scene0001_01": listed, "scene0000_00": np.arange(3, 1500, 11)}, la_file)
    base = dict(type="ScanNetDataset", data_root=roots["scannet"])
    with pytest.raises(TypeError):
        jbuild_dataset(dict(base, lr_file=str(lr_file)))
    with pytest.raises(pickle.UnpicklingError):
        jbuild_dataset(dict(base, la_file=str(la_file)))
    ds = tbuild_dataset(dict(base, lr_file=str(lr_file), la_file=str(la_file)))
    assert len(ds) == 1 and ds.get_data_name(0) == "scene0001_01"
    full = tbuild_dataset(dict(base, lr_file=str(lr_file)))
    segment, ref = ds.get_data(0)["segment"], full.get_data(0)["segment"]
    keep = np.zeros(len(ref), bool)
    keep[listed] = True
    np.testing.assert_array_equal(segment[keep], ref[keep])
    assert (segment[~keep] == -1).all() and (ref[~keep] >= 0).any()


def _flat(d, prefix=""):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def test_chip_smoke_ppt_phase_keeps_the_recipe(tmp_path):
    """``chip_smoke.py`` phase 14 runs the ScanNet PPT recipe with only its
    data roots, epochs, weight and save path changed (plus what the config
    parser derives: the seed and the train loop), and the scenes it writes
    read back through ``ScanNetDataset`` as SyntheticDataset made them."""
    sys.path.insert(0, ROOT)
    import chip_smoke
    from ponderv2_tpu_torch.datasets.defaults import SyntheticDataset
    from ponderv2_tpu_torch.engines.defaults import default_config_parser

    opts = chip_smoke.ppt_recipe_options(str(tmp_path / "data"), str(tmp_path / "save"))
    base = _flat(TConfig.fromfile(chip_smoke.PPT_CONFIG).to_dict())
    run = _flat(default_config_parser(chip_smoke.PPT_CONFIG, dict(opts)).to_dict())
    changed = {k for k in base.keys() | run.keys() if base.get(k) != run.get(k)}
    assert changed <= set(opts) | {"seed", "data.train.loop"}
    assert run["model.type"] == "PPT-v1m1" and run["batch_size"] == 12
    assert run["data.train.type"] == "ScanNetDataset"

    chip_smoke.write_scannet_scenes(str(tmp_path / "data"), 2, 1, points=500)
    synth = SyntheticDataset(num_scenes=3, points_per_scene=500, seed=chip_smoke.SEED)
    for split, idx in (("train", [0, 1]), ("val", [2])):
        ds = tbuild_dataset(dict(type="ScanNetDataset", split=split,
                                 data_root=str(tmp_path / "data")))
        assert len(ds) == len(idx)
        for i, j in enumerate(idx):
            want = synth.make_scene(j)
            assert_same_tree(ds.get_data(i), {k: want[k] for k in (
                "coord", "color", "normal", "segment", "instance")}, f"{split}[{i}]")


def test_chip_smoke_prints_the_tightest_margins_first():
    """Phase 8's ``[grad]`` line names the gradients closest to their bound
    tightest first, and labels them so."""
    sys.path.insert(0, ROOT)
    import chip_smoke

    margins = [(0.572, "a", "plain", 1e-6, 1e-3, 1e-7), (0.953, "b", "plain", 2e-6, 1e-3, 1e-7),
               (0.1, "c", "plain", 1e-7, 1e-3, 1e-7), (0.590, "d", "float64", 1e-6, 1e-3, 1e-7)]
    line = chip_smoke.tightest_margins_line("step", margins, 1.0, "reordered")
    assert "tightest first" in line
    shown = [part.split(" vs ")[0].rsplit(" ", 1)[-1] for part in line.split(": ", 2)[2].split("; ")]
    assert shown == ["b", "d", "a"]
    assert "b vs plain 0.953" in line and "d vs float64 0.590" in line
    assert len(chip_smoke.tightest_margins_line("s", margins[:2], 1.0, "r").split("; ")) == 2


def test_add_transform_copies_its_values():
    """``Add`` sets each key to a fresh copy of its value, as the JAX one."""
    from ponderv2_tpu.datasets.transform import TRANSFORMS as JTRANSFORMS
    from ponderv2_tpu_torch.datasets.transform import TRANSFORMS as TTRANSFORMS

    keys = dict(condition="ScanNet", extra=[1, 2])
    for registry in (JTRANSFORMS, TTRANSFORMS):
        add = registry.build(dict(type="Add", keys_dict=keys))
        out = add({"coord": np.zeros((2, 3))})
        assert out["condition"] == "ScanNet" and out["extra"] == [1, 2]
        out["extra"].append(3)
        assert add({})["extra"] == [1, 2]


_BLOCKED_IMPORT_CHECK = r"""
import importlib.abc, os, sys
BLOCKED = {"jax", "jaxlib", "flax", "optax", "ponderv2_tpu"}

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import: {name}")
        return None

assert not [m for m in sys.modules if m.split(".")[0] in BLOCKED]
sys.meta_path.insert(0, Block())
root = sys.argv[1]
sys.path[:0] = [root, root + "/tools"]
import numpy as np
import torch
import ponderv2_tpu_torch.engines.test
import ponderv2_tpu_torch.engines.hooks
import ponderv2_tpu_torch.engines.train
import ponderv2_tpu_torch.ops.band_conv
import ponderv2_tpu_torch.ops.probe_kernels
import ponderv2_tpu_torch.ops.row_gather
import ponderv2_tpu_torch.ops.windowed_gather
import ponderv2_tpu_torch.models.ponder.ponder_indoor
import ponderv2_tpu_torch.models.point_prompt_training.ppt
import ponderv2_tpu_torch.models.sparse_unet.spunet_pdnorm
import ponderv2_tpu_torch.datasets.scannet, ponderv2_tpu_torch.datasets.s3dis
import ponderv2_tpu_torch.datasets.structure3d, ponderv2_tpu_torch.utils.cache
import ponderv2_tpu_torch.datasets.dataloader
import ponderv2_tpu_torch.utils.clip_text
import ponderv2_tpu_torch.utils.convert
import ponderv2_tpu_torch.models.point_group.point_group
import ponderv2_tpu_torch.models.point_group.cluster
import ponderv2_tpu_torch.models.ponder.ponder_outdoor
import ponderv2_tpu_torch.datasets.nuscenes, ponderv2_tpu_torch.datasets.image_io
import ponderv2_tpu_torch.ops.pointops, ponderv2_tpu_torch.ops.sparse
import ponderv2_tpu_torch.models.ponder.render.samplers
import ponderv2_tpu_torch.models.ponder.render.surface_models
import ponderv2_tpu_torch.utils.visualization
sys.path.insert(0, root + "/tools/experiments")
import chip_smoke, probe_windowed_torch, test_torch, train_torch
import probe_bisect_torch, probe_gather_torch, profile_pretrain_torch, profile_semseg_torch
import ppt_grads_torch, multi_pretrain_torch, insseg_torch, nuscenes_torch
from ponderv2_tpu_torch.datasets import build_dataset, collate_fn
from ponderv2_tpu_torch.models import build_model
from ponderv2_tpu_torch.utils.config import Config

cfg = Config.fromfile(root + "/configs/_test_/semseg_spunet_scannet_synthetic.py")
data = dict(cfg.data.test)
data["points_per_scene"] = 2000
frag = build_dataset(data)[0]["fragment_list"][0]
batch = collate_fn([frag], point_budget=2048, scene_budget=1)
model = build_model(dict(type="DefaultSegmentor", backbone=dict(
    type="SpUNet-v1m1", in_channels=9, num_classes=20, base_channels=8,
    channels=(8, 16, 16, 16, 16, 16, 8, 8), layers=(1,) * 8))).eval()
inputs = {k: torch.as_tensor(batch[k]) for k in ("feat", "grid_coord", "batch")}
with torch.inference_mode():
    out = model({**inputs, "spatial_shape": tuple(cfg.sparse_shape), "batch_size": 1})
assert out["seg_logits"].shape == (2048, 20)
assert bool(torch.isfinite(out["seg_logits"]).all()) and bool(out["contract_ok"])

# the pretrain slice: its configs load, and a PonderIndoor-v2 training
# forward and backward run on the CPU
bench = Config.fromfile(root + "/configs/_test_/pretrain_bench_torch.py")
assert bench.model.backbone.compute_dtype == "bfloat16"
pcfg = Config.fromfile(root + "/configs/_test_/pretrain_synthetic.py")
ds = build_dataset(dict(pcfg.data.train))
pb = collate_fn([ds[0], ds[1]], point_budget=pcfg.point_budget, scene_budget=2)
pmodel = build_model(dict(pcfg.model)).train()
pout = pmodel({**{k: torch.as_tensor(v) for k, v in pb.items() if isinstance(v, np.ndarray)},
               "spatial_shape": tuple(pcfg.sparse_shape), "batch_size": 2,
               "generator": torch.Generator().manual_seed(0)})
pout["loss"].backward()
assert bool(torch.isfinite(pout["loss"])) and bool(pout["contract_ok"])

# the PPT fine-tune recipes, unchanged but for data_root: their datasets read
# scene files written here, and their models (ScanNet200's a DefaultSegmentor
# around PPT-v1m1 in backbone_mode) run a full-width training forward and
# backward on the CPU
import shutil, tempfile
torch.set_num_threads(2)
data_root = tempfile.mkdtemp()
rng = np.random.RandomState(0)
for rel in ("train/scene0000_00.pth", "val/scene0001_00.pth", "Area_1/office_1.pth",
            "Area_5/office_2.pth"):
    n = 2000
    os.makedirs(os.path.dirname(os.path.join(data_root, rel)), exist_ok=True)
    torch.save(dict(coord=rng.uniform(0, 3, (n, 3)).astype(np.float32),
                    color=rng.randint(0, 256, (n, 3)).astype(np.uint8),
                    normal=rng.randn(n, 3).astype(np.float32),
                    semantic_gt20=rng.randint(-1, 20, n), semantic_gt200=rng.randint(-1, 200, n),
                    semantic_gt=rng.randint(-1, 13, n), instance_gt=rng.randint(-1, 9, n)),
               os.path.join(data_root, rel))
for name in ("scannet/semseg-ppt-v1m1-0-sc-s3-st-spunet-lovasz-ft.py",
             "scannet200/semseg-ppt-v1m1-0-spunet-lovasz-ft.py",
             "s3dis/semseg-ppt-v1m1-0-s3-sc-st-spunet-lovasz-ft.py"):
    rcfg = Config.fromfile(os.path.join(root, "configs", name))
    items = {}
    for split in ("train", "val", "test"):
        rcfg.data[split].data_root = data_root
        items[split] = build_dataset(dict(rcfg.data[split]))[0]
    assert items["train"]["condition"] == rcfg.data.train.transform[-2].keys_dict.condition
    assert items["test"]["fragment_list"][0]["condition"] == items["train"]["condition"]
    rmodel = build_model(dict(rcfg.model))
    rb = collate_fn([items["train"]], point_budget=2048, scene_budget=1)
    rout = rmodel.train()({**{k: torch.as_tensor(v) for k, v in rb.items()
                              if isinstance(v, np.ndarray)},
                           "spatial_shape": tuple(rcfg.sparse_shape), "batch_size": 1,
                           "condition": rb["condition"]})
    rout["loss"].backward()
    assert rout["seg_logits"].shape == (2048, rcfg.data.num_classes)
    assert bool(rout["contract_ok"]) and bool(torch.isfinite(rout["loss"]))
shutil.rmtree(data_root)

# the three instance-segmentation recipes at full width, unchanged but for
# data_root: their datasets read scene files with instance labels (through
# InstanceParser, ScanNet200's ignore set included) and their PG-v1m1 models
# run a training forward on the CPU
data_root = tempfile.mkdtemp()
chip_smoke.write_scannet_scenes(data_root, 1, 1, points=2000, instances=True)
for i, split in enumerate(("train", "val")):
    path = os.path.join(data_root, split, f"scene{i:04d}_00.pth")
    scene = torch.load(path, weights_only=False)
    scene["semantic_gt200"] = scene["semantic_gt20"]  # ScanNet200Dataset's labels
    torch.save(scene, path)
for name in ("scannet/insseg-pointgroup-v1m1-0-spunet-base.py",
             "scannet/insseg-ppt-v1m1-0-pointgroup-spunet-ft.py",
             "scannet200/insseg-ppt-v1m1-0-pointgroup-spunet-ft.py"):
    rcfg = Config.fromfile(os.path.join(root, "configs", name))
    items = {}
    for split in ("train", "val"):
        rcfg.data[split].data_root = data_root
        items[split] = build_dataset(dict(rcfg.data[split]))[0]
    ignore = rcfg.model.segment_ignore_index
    assert (items["val"]["instance"][np.isin(items["val"]["segment"], ignore)] == -1).all()
    assert (items["val"]["instance"] >= 0).any()
    rmodel = build_model(dict(rcfg.model)).train()
    assert type(rmodel).__name__ == "PointGroup"
    rb = collate_fn([items["train"]], point_budget=2048, scene_budget=1)
    rout = rmodel({**{k: torch.as_tensor(v) for k, v in rb.items() if isinstance(v, np.ndarray)},
                   "spatial_shape": tuple(rcfg.sparse_shape), "batch_size": 1,
                   "condition": rb.get("condition", [None])[0]})
    assert rout["seg_logits"].shape == (2048, rcfg.data.num_classes)
    assert rout["bias_pred"].shape == (2048, 3) and rout["loss"].shape == ()
    assert bool(rout["contract_ok"]) and all(bool(torch.isfinite(rout[k])) for k in (
        "loss", "seg_loss", "bias_l1_loss", "bias_cosine_loss"))
shutil.rmtree(data_root)

# the multi-dataset pretrain: its three RGB-D datasets over scene files in
# their layouts, one round of its loader, its trainer
from ponderv2_tpu_torch.datasets.dataloader import MultiDatasetDataloader
from ponderv2_tpu_torch.engines.train import TRAINERS
assert "MultiDatasetTrainer" in TRAINERS
data_root = tempfile.mkdtemp()
roots = chip_smoke.write_multidataset_scenes(
    data_root, counts={"Structured3D": 2, "ScanNet": 1, "S3DIS": 1}, points=500, views=2,
    hw=(12, 16))
mcfg = Config.fromfile(chip_smoke.MULTI_CONFIG)
mcfg.merge_from_dict({k: v for k, v in chip_smoke.multi_pretrain_options(roots, data_root).items()
                      if k.startswith("data.")})
mcfg.merge_from_dict({f"data.train.datasets.{i}.num_cameras": 2 for i in range(3)})
loader = MultiDatasetDataloader(build_dataset(dict(mcfg.data.train)), batch_size_per_dataset=1,
                                point_budget=2048)
assert len(loader) == 4
assert [b["condition"] for b in loader] == [[c] for c in chip_smoke.MULTI_ORDER]
shutil.rmtree(data_root)

# the MinkUNet34C recipe (phase 19) and the SpUNet classifier recipe (phase
# 20) build and run an eval forward at full width; every new hook and
# tester builds, the testers over the recipes' data
import ponderv2_tpu_torch.engines.launch
from ponderv2_tpu_torch.engines.hooks import build_hooks
from ponderv2_tpu_torch.engines.test import TESTERS
data_root = tempfile.mkdtemp()
chip_smoke.write_scannet_scenes(data_root, 1, 1, points=2000)
mcfg = chip_smoke.minkunet_recipe(data_root, os.path.join(data_root, "exp"))
assert mcfg.model.backbone["type"] == "MinkUNet34C" and mcfg.hooks[-1]["type"] == "PreciseEvaluator"
mink = build_model(dict(mcfg.model)).eval()
item = build_dataset(dict(mcfg.data.val))[0]
mb = collate_fn([item], point_budget=2048, scene_budget=1)
with torch.inference_mode():
    mout = mink({**{k: torch.as_tensor(v) for k, v in mb.items() if isinstance(v, np.ndarray)},
                 "spatial_shape": tuple(mcfg.sparse_shape), "batch_size": 1})
assert mout["seg_logits"].shape == (2048, 20) and bool(mout["contract_ok"])
chip_smoke.register_object_dataset()
ccfg = chip_smoke.classifier_recipe(data_root, os.path.join(data_root, "cls"))
cds = build_dataset(dict(ccfg.data.train, num_objects=2, points=3000))
cb = collate_fn([cds[0], cds[1]], point_budget=6000, scene_budget=2)
clf = build_model(dict(ccfg.model)).eval()
with torch.inference_mode():
    cout = clf({**{k: torch.as_tensor(v) for k, v in cb.items() if isinstance(v, np.ndarray)},
                "spatial_shape": tuple(ccfg.sparse_shape), "batch_size": 2})
assert cout["cls_logits"].shape == (2, 40) and bool(cout["contract_ok"])
hooks = build_hooks([dict(type="ClsEvaluator"), dict(type="PreciseEvaluator"),
                     dict(type="RuntimeProfiler"), dict(type="SemSegEvaluator"),
                     dict(type="DataCacheOperator", data_root=data_root, split="train")])
assert [type(h).__name__ for h in hooks] == ["ClsEvaluator", "PreciseEvaluator",
                                             "RuntimeProfiler", "SemSegEvaluator",
                                             "DataCacheOperator"]
torch.save(clf.state_dict(), os.path.join(data_root, "clf.pth"))
ccfg.weight, ccfg.device = os.path.join(data_root, "clf.pth"), "cpu"
ccfg.data.test = dict(ccfg.data.test, num_objects=1, points=500)
assert type(TESTERS.build(dict(type="ClsTester", cfg=ccfg))).__name__ == "ClsTester"
torch.save(mink.state_dict(), os.path.join(data_root, "mink.pth"))
mcfg.weight, mcfg.device, mcfg.data.test = os.path.join(data_root, "mink.pth"), "cpu", mcfg.data.val
assert type(TESTERS.build(dict(type="PartSegTester", cfg=mcfg))).__name__ == "PartSegTester"
shutil.rmtree(data_root)

assert not [m for m in sys.modules if m.split(".")[0] in BLOCKED]
print("NO_JAX_OK")
"""


def test_port_imports_and_runs_without_jax():
    """``ponderv2_tpu_torch``, ``chip_smoke.py``, ``tools/test_torch.py``,
    ``tools/train_torch.py``, the two profilers, the probe entry points
    ``tools/experiments/probe_{windowed,gather,bisect}_torch.py``,
    ``tools/experiments/ppt_grads_torch.py``,
    ``tools/experiments/multi_pretrain_torch.py``,
    ``tools/experiments/insseg_torch.py`` and
    ``tools/experiments/nuscenes_torch.py`` import,
    the pretrain configs load, a segmentor forward and a PonderIndoor-v2
    training step's forward and backward run on the CPU, and the three PPT
    fine-tune recipes build their datasets (over scene files) and models,
    the ScanNet one running a training forward and backward, and the
    multi-dataset pretrain's datasets and loader run one round over scene
    files, and the three instance-segmentation recipes build their datasets
    (over scene files with instance labels) and run a full-width training
    forward of their PG-v1m1 models, the MinkUNet34C and SpUNet classifier
    recipes of ``chip_smoke.py`` run a full-width eval forward and every
    new hook and tester builds, and the pointops, the sparse helpers, the
    VolSDF / UniSurf render modules and the ply writers import (the
    nuScenes configs:
    ``test_nuscenes_configs_run_without_jax``),
    with jax/jaxlib/flax/optax/ponderv2_tpu blocked; no port source
    names them in an import statement."""
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORT_CHECK, ROOT],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_JAX_OK" in proc.stdout
    pattern = re.compile(r"^\s*(import|from) (jax|jaxlib|flax|optax|ponderv2_tpu)\b")
    sources = [os.path.join(ROOT, "chip_smoke.py"),
               os.path.join(ROOT, "tools", "test_torch.py"),
               os.path.join(ROOT, "tools", "train_torch.py"),
               os.path.join(ROOT, "tools", "experiments", "probe_windowed_torch.py"),
               os.path.join(ROOT, "tools", "experiments", "probe_gather_torch.py"),
               os.path.join(ROOT, "tools", "experiments", "probe_bisect_torch.py"),
               os.path.join(ROOT, "tools", "experiments", "ppt_grads_torch.py"),
               os.path.join(ROOT, "tools", "experiments", "multi_pretrain_torch.py"),
               os.path.join(ROOT, "tools", "experiments", "insseg_torch.py"),
               os.path.join(ROOT, "tools", "experiments", "nuscenes_torch.py"),
               os.path.join(ROOT, "tools", "profile_pretrain_torch.py"),
               os.path.join(ROOT, "tools", "profile_semseg_torch.py"),
               os.path.join(ROOT, "configs", "_test_", "pretrain_bench_torch.py")]
    for d, _, files in os.walk(os.path.join(ROOT, "ponderv2_tpu_torch")):
        sources += [os.path.join(d, f) for f in files if f.endswith(".py")]
    for path in sources:
        with open(path) as f:
            for i, line in enumerate(f, 1):
                assert not pattern.match(line), f"{path}:{i}: {line.strip()}"


_BLOCKED_NUSCENES_CHECK = r"""
import importlib.abc, os, shutil, sys, tempfile
BLOCKED = {"jax", "jaxlib", "flax", "optax", "ponderv2_tpu"}

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import: {name}")
        return None

sys.meta_path.insert(0, Block())
root = sys.argv[1]
sys.path.insert(0, root)
import numpy as np
import torch
from ponderv2_tpu_torch.datasets import build_dataset, collate_fn
from ponderv2_tpu_torch.engines.train import TRAINERS
from ponderv2_tpu_torch.models import build_model
from ponderv2_tpu_torch.utils.config import Config
torch.set_num_threads(2)
# the five nuScenes configs at full width, unchanged but for data_root: their
# datasets read a procedural scan (cut to 64 azimuths, cameras 96 x 160)
# through the outdoor transforms, and their models (PonderOutdoor-v2, and
# DefaultSegmentor with 4 input channels) run a training forward
from ponderv2_tpu_torch.datasets.preprocessing import synthetic_nuscenes
synthetic_nuscenes.AZIMUTH_STEPS = 64
data_root = tempfile.mkdtemp()
synthetic_nuscenes.write_synthetic_nuscenes(data_root, {"train": 1, "val": 1}, 0,
                                            image_hw=(96, 160))
np.random.seed(0)
for name in ("base", "base-color", "base-color-amp", "base-semantic", "semseg"):
    rcfg = Config.fromfile(os.path.join(root, "configs", "nuscenes", (
        "semseg-ppt-v1m1-0-nu-sk-wa-spunet-ft.py" if name == "semseg"
        else f"pretrain-ponder-spunet-v1m1-0-{name}.py")))
    rcfg.data.train.data_root = data_root
    item = build_dataset(dict(rcfg.data.train))[0]
    rmodel = build_model(dict(rcfg.model)).train()
    rb = collate_fn([item], point_budget=4096, scene_budget=1)
    rout = rmodel({**{k: torch.as_tensor(v) for k, v in rb.items() if isinstance(v, np.ndarray)},
                   "spatial_shape": tuple(rcfg.sparse_shape), "batch_size": 1,
                   "generator": torch.Generator().manual_seed(0)})
    assert bool(rout["contract_ok"]) and bool(torch.isfinite(rout["loss"])), name
    if name == "semseg":
        assert rout["seg_logits"].shape == (4096, 16)
    else:
        assert rb["ray_start"].shape == (1, 512, 3)
        assert all(bool(torch.isfinite(rout[k])) for k in rcfg.metric_keys), name
    if rcfg.data.get("test"):
        rcfg.data.test.data_root = data_root
        assert build_dataset(dict(rcfg.data.test))[0]["fragment_list"]
shutil.rmtree(data_root)

# every config outside configs/_test_/ (and the _base_ runtime) names only
# types that the port registers
from ponderv2_tpu_torch.datasets import DATASETS, TRANSFORMS
from ponderv2_tpu_torch.engines.hooks.builder import HOOKS
from ponderv2_tpu_torch.engines.test import TESTERS
from ponderv2_tpu_torch.models import MODELS
from ponderv2_tpu_torch.models.losses.builder import LOSSES
from ponderv2_tpu_torch.models.ponder.render.colliders import COLLIDERS
from ponderv2_tpu_torch.models.ponder.render.samplers import SAMPLERS
from ponderv2_tpu_torch.models.ponder.render.surface_models import RENDERERS
from ponderv2_tpu_torch.utils.optimizer import OPTIMIZERS
from ponderv2_tpu_torch.utils.scheduler import SCHEDULERS
registries = (MODELS, DATASETS, TRANSFORMS, HOOKS, TRAINERS, TESTERS, LOSSES, COLLIDERS,
              SAMPLERS, RENDERERS, OPTIMIZERS, SCHEDULERS)

def types(v):
    if isinstance(v, dict):
        if isinstance(v.get("type"), str):
            yield v["type"]
        for x in v.values():
            yield from types(x)
    elif isinstance(v, (list, tuple)):
        for x in v:
            yield from types(x)

unknown, n_configs = {}, 0
for d, _, files in os.walk(os.path.join(root, "configs")):
    if os.path.basename(d) in ("_test_", "_base_"):
        continue
    for f in files:
        if f.endswith(".py"):
            n_configs += 1
            bad = sorted({t for t in types(Config.fromfile(os.path.join(d, f)).to_dict())
                          if not any(t in r for r in registries)})
            if bad:
                unknown[f] = bad
assert n_configs == 18 and not unknown, (n_configs, unknown)
assert not [m for m in sys.modules if m.split(".")[0] in BLOCKED]
print("NO_JAX_OK")
"""


def test_nuscenes_configs_run_without_jax():
    """With jax/jaxlib/flax/optax/ponderv2_tpu blocked, the five nuScenes
    configs read a procedural scan through their transforms and run a
    full-width training forward of their models (PonderOutdoor-v2,
    DefaultSegmentor with 4 input channels), and each of the 18 configs
    outside ``configs/_test_/`` names only types that the port's
    registries hold."""
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_NUSCENES_CHECK, ROOT],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_JAX_OK" in proc.stdout


# ------------------------------------------------------------------ configs
# Every config file loads through the port's Config with JAX blocked: the
# two JAX data modules configs import resolve to the port's copies
# (ponderv2_tpu_torch/utils/config.py:PORTED_MODULES). The JAX bench's own
# config, configs/_test_/pretrain_bench.py, imports jax.numpy for itself and
# stays JAX-only; the port runs configs/_test_/pretrain_bench_torch.py.

CONFIG_DIR = os.path.join(ROOT, "configs")
CONFIGS = sorted(os.path.relpath(os.path.join(d, f), CONFIG_DIR)
                 for d, _, files in os.walk(CONFIG_DIR) for f in files if f.endswith(".py"))
JAX_ONLY_CONFIG = os.path.join("_test_", "pretrain_bench.py")

_CONFIG_LOAD_CHECK = r"""
import importlib.abc, json, os, sys
BLOCKED = {"jax", "jaxlib", "flax", "optax", "ponderv2_tpu"}

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import: {name}")
        return None

sys.meta_path.insert(0, Block())
root, names = sys.argv[1], json.loads(sys.argv[2])
sys.path.insert(0, root)
from ponderv2_tpu_torch.utils.config import Config

loaded = {}
for name in names:
    try:
        Config.fromfile(os.path.join(root, "configs", name))
        loaded[name] = "ok"
    except Exception as e:
        loaded[name] = f"{type(e).__name__}: {e}"
print(json.dumps({"loaded": loaded,
                  "jax_modules": [m for m in sys.modules if m.split(".")[0] in BLOCKED]}))
"""


@pytest.fixture(scope="module")
def configs_without_jax():
    """Each config loaded through the port's ``Config.fromfile`` in one
    subprocess with jax/jaxlib/flax/optax/ponderv2_tpu blocked: {"loaded":
    {name: "ok" or the error}, "jax_modules": blocked modules imported}."""
    import json

    proc = subprocess.run([sys.executable, "-c", _CONFIG_LOAD_CHECK, ROOT, json.dumps(CONFIGS)],
                          capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("name", [c for c in CONFIGS if c != JAX_ONLY_CONFIG])
def test_config_loads_without_jax(configs_without_jax, name):
    """The config loads with JAX blocked, leaves no module of the JAX package
    in ``sys.modules``, and gives the values the JAX package's loader gives."""
    assert configs_without_jax["loaded"][name] == "ok"
    assert configs_without_jax["jax_modules"] == []
    path = os.path.join(CONFIG_DIR, name)
    assert _comparable(TConfig.fromfile(path).to_dict()) == _comparable(
        JConfig.fromfile(path).to_dict())


def _comparable(v):
    """A config's values with each function (a config may define one, e.g.
    a transform lambda) replaced by its bytecode and constants."""
    if isinstance(v, dict):
        return {k: _comparable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(_comparable(x) for x in v)
    if callable(v) and hasattr(v, "__code__"):
        return ("function", v.__code__.co_code, v.__code__.co_consts)
    return v


def test_jax_bench_config_stays_jax_only(configs_without_jax):
    """``configs/_test_/pretrain_bench.py`` (the JAX bench's config) imports
    jax itself, so it is the one config that needs JAX."""
    assert configs_without_jax["loaded"][JAX_ONLY_CONFIG] == "ImportError: blocked import: jax"


def test_config_import_mapping_adds_no_jax_module():
    """In a process that has the JAX package too, a config's import of a
    ported data module returns the port's copy and puts nothing under the
    JAX package's name into ``sys.modules``."""
    from ponderv2_tpu_torch.utils import config as tconfig

    before = {m for m in sys.modules if m.split(".")[0] == "ponderv2_tpu"}
    for jname, tname in tconfig.PORTED_MODULES.items():
        mod = tconfig._config_import(jname, None, None, ("x",), 0)
        assert mod is sys.modules[tname]
    assert {m for m in sys.modules if m.split(".")[0] == "ponderv2_tpu"} == before
