"""PyTorch port vs JAX package: the copied data path, tester votes, and the
port's independence from JAX."""

import os
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
        import ponderv2_tpu.datasets.ppt_vocab as jvocab
        import ponderv2_tpu.datasets.preprocessing.scannet200_constants as jsc200
        import ponderv2_tpu.datasets.transform as jtr
        import ponderv2_tpu.utils.clip_text as jclip
        import ponderv2_tpu.utils.env as jenv
        import ponderv2_tpu.utils.events as jev
        import ponderv2_tpu.utils.timer as jtm
        import ponderv2_tpu_torch.datasets.dataloader as tdl
        import ponderv2_tpu_torch.datasets.defaults as tdef
        import ponderv2_tpu_torch.datasets.ppt_vocab as tvocab
        import ponderv2_tpu_torch.datasets.preprocessing.scannet200_constants as tsc200
        import ponderv2_tpu_torch.datasets.transform as ttr
        import ponderv2_tpu_torch.utils.clip_text as tclip
        import ponderv2_tpu_torch.utils.env as tenv
        import ponderv2_tpu_torch.utils.events as tev
        import ponderv2_tpu_torch.utils.timer as ttm

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
        ]
        for jmod, tmod, names in copies:
            for name in names:
                assert inspect.getsource(getattr(tmod, name)) == inspect.getsource(
                    getattr(jmod, name)), f"{tmod.__name__}.{name}"
        # the data modules the configs import, whole (utils/config.py:PORTED_MODULES)
        for jmod, tmod in [(jvocab, tvocab), (jsc200, tsc200)]:
            with open(jmod.__file__, "rb") as fj, open(tmod.__file__, "rb") as ft:
                assert fj.read() == ft.read(), tmod.__name__

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


_BLOCKED_IMPORT_CHECK = r"""
import importlib.abc, sys
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
import ponderv2_tpu_torch.utils.clip_text
import ponderv2_tpu_torch.utils.convert
sys.path.insert(0, root + "/tools/experiments")
import chip_smoke, probe_windowed_torch, test_torch, train_torch
import probe_bisect_torch, probe_gather_torch, profile_pretrain_torch, profile_semseg_torch
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
assert not [m for m in sys.modules if m.split(".")[0] in BLOCKED]
print("NO_JAX_OK")
"""


def test_port_imports_and_runs_without_jax():
    """``ponderv2_tpu_torch``, ``chip_smoke.py``, ``tools/test_torch.py``,
    ``tools/train_torch.py``, the two profilers and the probe entry points
    ``tools/experiments/probe_{windowed,gather,bisect}_torch.py`` import,
    the pretrain configs load, and a segmentor forward and a
    PonderIndoor-v2 training step's forward and backward run on the CPU,
    with jax/jaxlib/flax/optax/ponderv2_tpu blocked; no port source names
    them in an import statement."""
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORT_CHECK, ROOT],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_JAX_OK" in proc.stdout
    pattern = re.compile(r"^\s*(import|from) (jax|jaxlib|flax|optax|ponderv2_tpu)\b")
    sources = [os.path.join(ROOT, "chip_smoke.py"),
               os.path.join(ROOT, "tools", "test_torch.py"),
               os.path.join(ROOT, "tools", "train_torch.py"),
               os.path.join(ROOT, "tools", "experiments", "probe_windowed_torch.py"),
               os.path.join(ROOT, "tools", "experiments", "probe_gather_torch.py"),
               os.path.join(ROOT, "tools", "experiments", "probe_bisect_torch.py"),
               os.path.join(ROOT, "tools", "profile_pretrain_torch.py"),
               os.path.join(ROOT, "tools", "profile_semseg_torch.py"),
               os.path.join(ROOT, "configs", "_test_", "pretrain_bench_torch.py")]
    for d, _, files in os.walk(os.path.join(ROOT, "ponderv2_tpu_torch")):
        sources += [os.path.join(d, f) for f in files if f.endswith(".py")]
    for path in sources:
        with open(path) as f:
            for i, line in enumerate(f, 1):
                assert not pattern.match(line), f"{path}:{i}: {line.strip()}"


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
