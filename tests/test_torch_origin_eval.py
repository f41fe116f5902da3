"""PyTorch port vs JAX package: labels projected onto the original points,
the transforms no recipe names, and the run-keyed scene cache, on the CPU.

- The 11 transforms the port copied last (``Copy``, ``ToTensor``,
  ``NormalizeCoord``, ``ClipGaussianJitter``, ``PointClip``,
  ``RandomColorGrayScale``, ``RandomColorJitter``, ``RandomColorDrop``,
  ``HueSaturationTranslation``, ``CropBoundary``,
  ``ContrastiveViewsGenerator``): equal outputs under the same
  ``np.random`` seed (their sources are held byte-equal in
  ``test_torch_data.py``).
- ``SemSegEvaluator``'s projection onto ``origin_coord``: the same scalars
  as JAX's evaluator on the same batch (within 1e-6), and, as a port-only
  repair (F14), a val pipeline with ``Copy`` that keeps the original points
  through ``GridSample`` and collate, where the JAX one makes the
  projection the identity and its evaluator raises.
- The scene cache (``utils/cache.py``): two runs whose data roots share a
  basename read their own scenes (the JAX cache hands one run the other's),
  ``DataCacheOperator`` fills the run's cache, and the trainer unlinks every
  segment of the run after training and after a step that raises.

Tolerances: arrays and integer outputs exactly; metric scalars 1e-6.
"""

import os
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ponderv2_tpu.datasets.builder import build_dataset as jbuild_dataset
from ponderv2_tpu.datasets.transform import TRANSFORMS as JTRANSFORMS
from ponderv2_tpu.datasets.utils import collate_fn as jcollate
from ponderv2_tpu.engines.hooks import evaluator as jev
from ponderv2_tpu.utils.config import Config as JConfig
from ponderv2_tpu.utils.events import EventStorage as JStorage
from ponderv2_tpu_torch.datasets import build_dataset as tbuild_dataset
from ponderv2_tpu_torch.datasets import collate_fn as tcollate
from ponderv2_tpu_torch.datasets.transform import TRANSFORMS as TTRANSFORMS
from ponderv2_tpu_torch.engines.hooks import evaluator as tev
from ponderv2_tpu_torch.utils import cache
from ponderv2_tpu_torch.utils.config import Config as TConfig
from ponderv2_tpu_torch.utils.events import EventStorage as TStorage
from ponderv2_tpu_torch.utils.logger import get_root_logger
from torch_threads import _torch_threads  # noqa: F401, E402  (autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _torch_state():
    dtype, threads = torch.get_default_dtype(), torch.get_num_threads()
    torch.set_default_dtype(torch.float32)
    torch.set_num_threads(2)
    yield
    torch.set_default_dtype(dtype)
    torch.set_num_threads(threads)


def scene(rng, n=400):
    return dict(coord=(rng.rand(n, 3) * 4 - 2).astype(np.float32),
                color=(rng.rand(n, 3) * 255).astype(np.float32),
                normal=rng.randn(n, 3).astype(np.float32),
                segment=rng.randint(-1, 6, n).astype(np.int64))


TRANSFORM_CASES = {
    "Copy": dict(type="Copy"),
    "ToTensor": dict(type="ToTensor"),
    "NormalizeCoord": dict(type="NormalizeCoord"),
    "ClipGaussianJitter": dict(type="ClipGaussianJitter", scalar=0.05),
    "PointClip": dict(type="PointClip", point_cloud_range=(-1, -1, -1, 1, 1, 0.5)),
    "RandomColorGrayScale": dict(type="RandomColorGrayScale", p=1.0),
    "RandomColorJitter": dict(type="RandomColorJitter", p=0.7),
    "RandomColorDrop": dict(type="RandomColorDrop", p=1.0, color_augment=0.5),
    "HueSaturationTranslation": dict(type="HueSaturationTranslation"),
    "CropBoundary": dict(type="CropBoundary"),
    "ContrastiveViewsGenerator": dict(
        type="ContrastiveViewsGenerator",
        view_trans_cfg=[dict(type="RandomScale", scale=[0.8, 1.2]),
                        dict(type="ChromaticJitter", p=1.0, std=0.05)]),
}


@pytest.mark.parametrize("name", list(TRANSFORM_CASES))
def test_transforms_match_jax(name):
    """The same seeded scene and the same ``np.random`` seed through both
    packages' transform: every output array equal."""
    outs = []
    for registry in (JTRANSFORMS, TTRANSFORMS):
        np.random.seed(7)
        data = scene(np.random.RandomState(1))
        outs.append(registry.build(dict(TRANSFORM_CASES[name]))(data))
    jout, tout = outs
    assert sorted(jout) == sorted(tout)
    for k in jout:
        np.testing.assert_array_equal(tout[k], jout[k], err_msg=k)


# ------------------------------------------------------------- F14

VAL_PIPELINE = [
    dict(type="CenterShift", apply_z=True),
    dict(type="Copy", keys_dict=dict(coord="origin_coord", segment="origin_segment")),
    dict(type="GridSample", grid_size=0.1, hash_type="fnv", mode="train",
         return_grid_coord=True),
    dict(type="CenterShift", apply_z=False),
    dict(type="NormalizeColor"),
    dict(type="Collect", keys=("coord", "grid_coord", "segment", "origin_coord",
                               "origin_segment"),
         offset_keys_dict=dict(offset="coord", origin_offset="origin_coord"),
         feat_keys=("color", "normal")),
]
NUM_CLASSES = 8


def val_batch(build, collate, n_scenes=2, points=1500):
    ds = build(dict(type="SyntheticDataset", num_scenes=n_scenes, points_per_scene=points,
                    num_classes=NUM_CLASSES, transform=VAL_PIPELINE))
    np.random.seed(0)  # GridSample's draw
    return collate([ds[i] for i in range(n_scenes)], point_budget=4096,
                   scene_budget=n_scenes), ds


class _Stub:
    """A trainer's attributes that an evaluator reads."""

    def __init__(self, cfg, val_loader, eval_step, storage):
        self.cfg, self.val_loader, self.eval_step = cfg, val_loader, eval_step
        self.storage, self.logger, self.comm_info = storage, get_root_logger(), {}
        self.device, self.state = torch.device("cpu"), None


def oracle_logits(feat):
    w = np.random.RandomState(3).randn(feat.shape[1], NUM_CLASSES).astype(np.float32)
    return np.tanh(np.asarray(feat, np.float32) @ w) * 4.0


def evaluate(pkg, batch):
    """One SemSegEvaluator pass over ``batch``: the latest scalars."""
    cfg_cls, storage, ev = ((JConfig, JStorage(), jev) if pkg == "jax"
                            else (TConfig, TStorage(), tev))
    cfg = cfg_cls(dict(data=dict(num_classes=NUM_CLASSES, ignore_index=-1)))
    logits = oracle_logits(batch["feat"])
    if pkg == "jax":
        step = lambda state, arrays: {"seg_logits": jnp.asarray(logits)}  # noqa: E731
    else:
        step = lambda input_dict: {"seg_logits": torch.from_numpy(logits)}  # noqa: E731
    hook = ev.SemSegEvaluator()
    hook.trainer = _Stub(cfg, [batch], step, storage)
    hook.eval()
    return {k: v[0] for k, v in storage.latest().items()}


def host_miou(batch):
    """mIoU of the oracle's voxel labels carried to each original point by
    its exact nearest voxel of the same scene (float64 brute force)."""
    pred = oracle_logits(batch["feat"]).argmax(-1)
    coord, b = batch["coord"].astype(np.float64), batch["batch"]
    out = np.empty(len(batch["origin_coord"]), np.int64)
    for i, (p, pb) in enumerate(zip(batch["origin_coord"].astype(np.float64),
                                    batch["origin_batch"])):
        d = ((coord - p) ** 2).sum(1)
        d[b != pb] = np.inf
        out[i] = pred[np.argmin(d)]
    seg = batch["origin_segment"]
    inter = np.array([((out == c) & (seg == c)).sum() for c in range(NUM_CLASSES)], float)
    union = np.array([((out == c) | (seg == c))[seg != -1].sum() for c in range(NUM_CLASSES)],
                     float)
    return float(np.mean(inter / (union + 1e-10)))


def test_origin_projection_matches_jax():
    """On a batch that carries the original points, the JAX evaluator and
    the port's store the same scalars (within 1e-6), equal to the mIoU of
    an exact nearest-voxel projection on the host."""
    batch, _ = val_batch(tbuild_dataset, tcollate)
    jout, tout = evaluate("jax", batch), evaluate("torch", batch)
    assert sorted(jout) == sorted(tout)
    for k, v in jout.items():
        assert abs(tout[k] - v) <= 1e-6, (k, tout[k], v)
    assert abs(tout["val/mIoU"] - host_miou(batch)) <= 1e-6


def test_origin_points_survive_sampling_and_collate_port_only():
    """F14. Through the JAX pipeline ``origin_coord`` is subsampled with
    ``coord`` (the projection becomes the identity: each row is its own
    voxel) and the collate makes no ``origin_batch``, so the JAX evaluator
    raises ``KeyError``. The port keeps every original point (in ``coord``'s
    frame: each voxel row is one of its scene's original points), collates
    them apart with ``origin_batch`` / ``origin_offset``, and its evaluator
    scores all of them."""
    jbatch, _ = val_batch(jbuild_dataset, jcollate)
    n_live = int((jbatch["batch"] >= 0).sum())
    assert "origin_batch" not in jbatch
    live = jbatch["batch"] >= 0
    assert len(jbatch["origin_coord"]) == len(jbatch["coord"])
    np.testing.assert_array_equal(jbatch["origin_coord"][live], jbatch["coord"][live])
    with pytest.raises(KeyError, match="origin_batch"):
        evaluate("jax", jbatch)

    tbatch, tds = val_batch(tbuild_dataset, tcollate)
    assert int((tbatch["batch"] >= 0).sum()) == n_live
    n_points = [len(tds.make_scene(i)["coord"]) for i in range(2)]
    assert len(tbatch["origin_coord"]) == sum(n_points) > n_live
    np.testing.assert_array_equal(tbatch["origin_offset"], np.cumsum(n_points))
    np.testing.assert_array_equal(
        tbatch["origin_batch"], np.repeat(np.arange(2, dtype=np.int32), n_points))
    for s in range(2):
        rows = tbatch["coord"][tbatch["batch"] == s]
        origin = tbatch["origin_coord"][tbatch["origin_batch"] == s]
        d = ((rows[:, None].astype(np.float64) - origin[None]) ** 2).sum(-1).min(1)
        assert (d == 0).all()  # the same frame
    out = evaluate("torch", tbatch)
    assert abs(out["val/mIoU"] - host_miou(tbatch)) <= 1e-6


# ------------------------------------------------------------- the cache


def write_scenes(root, n, seed, points=600):
    rng = np.random.RandomState(seed)
    for split in ("train", "val"):
        os.makedirs(os.path.join(root, split), exist_ok=True)
        for i in range(n):
            s = scene(rng, points)
            torch.save(dict(coord=s["coord"], color=s["color"], normal=s["normal"],
                            semantic_gt20=s["segment"]),
                       os.path.join(root, split, f"scene{i:04d}_00.pth"))


def test_scene_cache_is_keyed_on_the_run_port_only(tmp_path, monkeypatch):
    """Two runs whose data roots share a basename (``a/scannet`` and
    ``b/scannet``, other scenes): the JAX cache hands the second run the
    first run's scene; the port's runs each read their own, and clearing a
    run leaves none of its segments in /dev/shm. (The JAX cache keeps its
    manifests in ``tmp_path`` here, not in its host-wide directory.)"""
    import ponderv2_tpu.utils.cache as jcache
    from ponderv2_tpu_torch.datasets.defaults import set_cache_run

    monkeypatch.setattr(jcache, "_MANIFEST_DIR", str(tmp_path / "jax_manifests"))

    roots = [str(tmp_path / r / "scannet") for r in ("a", "b")]
    name = f"scene{os.getpid()}_00"  # a name no other run on this host caches
    for seed, root in enumerate(roots):
        write_scenes(root, 1, seed)
        os.rename(os.path.join(root, "train", "scene0000_00.pth"),
                  os.path.join(root, "train", f"{name}.pth"))
    cfg = dict(type="ScanNetDataset", split="train", cache=True)
    jsets = [jbuild_dataset(dict(cfg, data_root=r)) for r in roots]
    files = [torch.load(ds.data_list[0], weights_only=False)["coord"] for ds in jsets]
    assert not np.array_equal(files[0], files[1])
    try:
        a = jsets[0].get_data(0)["coord"].copy()
        b = jsets[1].get_data(0)["coord"].copy()
    finally:
        jcache.clear(f"ponderv2-scannet-{name}")
    np.testing.assert_array_equal(a, files[0])
    np.testing.assert_array_equal(b, files[0])  # b got a's scene

    tsets = [tbuild_dataset(dict(cfg, data_root=r)) for r in roots]
    with pytest.raises(ValueError, match="run key"):  # only a trainer gives one
        tsets[0].get_data(0)
    runs = [cache.new_run_key() for _ in roots]
    try:
        for ds, run in zip(tsets, runs):
            set_cache_run(ds, run)
        first = [ds.get_data(0)["coord"].copy() for ds in tsets]
        again = [ds.get_data(0)["coord"].copy() for ds in tsets]  # from the cache
        for got, fresh, file, run in zip(first, again, files, runs):
            np.testing.assert_array_equal(got, file)
            np.testing.assert_array_equal(fresh, file)
            assert cache.segments(run)
    finally:
        for run in runs:
            cache.clear(run=run)
    assert not any(cache.segments(run) for run in runs)
    assert not any(os.path.exists(cache._manifest_dir(run)) for run in runs)


def cached_run_cfg(data_root, save_path):
    """``configs/_test_/semseg_synthetic.py`` over ScanNet scene files with
    the cache on, ``DataCacheOperator``, one step, and a val pipeline that
    projects onto the original points."""
    from ponderv2_tpu_torch.engines.defaults import default_config_parser

    cfg = default_config_parser(os.path.join(ROOT, "configs/_test_/semseg_synthetic.py"),
                                {"save_path": save_path, "device": "cpu", "epoch": 1,
                                 "eval_epoch": 1})
    base = dict(type="ScanNetDataset", data_root=data_root, cache=True)
    cfg.data.train = dict(base, split="train", transform=cfg.data.train.transform)
    cfg.data.val = dict(base, split="val", transform=VAL_PIPELINE)
    cfg.hooks = [dict(type="DataCacheOperator", data_root=data_root, split="train")] + [
        h for h in cfg.hooks if h["type"] in ("IterationTimer", "SemSegEvaluator")]
    return cfg


SEEN = {}


def _register_cache_probe():
    """A hook that, after each step, reads the run's segments and its train
    scenes (from the cache) into ``SEEN``."""
    from ponderv2_tpu_torch.engines.hooks.builder import HOOKS
    from ponderv2_tpu_torch.engines.hooks.default import HookBase

    class CacheProbe(HookBase):
        def after_step(self):
            t = self.trainer
            ds = t.train_loader.dataset.dataset
            SEEN.update(run=t.cache_run, segments=cache.segments(t.cache_run),
                        paths=list(ds.data_list),
                        coords=[ds.get_data(i)["coord"].copy()
                                for i in range(len(ds.data_list))])

    HOOKS.register_module(name="_CacheProbe", module=CacheProbe, force=True)


def test_data_cache_operator_and_the_trainer_unlink_the_run_port_only(tmp_path, monkeypatch):
    """A CPU training run with ``cache=True``: ``DataCacheOperator`` caches
    every train scene before the first step (each equal to its file), the
    evaluation scores the original points, and no segment of the run is
    left afterwards; nor when a step raises."""
    from ponderv2_tpu_torch.engines import train as ttrain

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from train_torch import main_worker

    data_root = str(tmp_path / "scannet")
    write_scenes(data_root, 2, 5)
    _register_cache_probe()
    cfg = cached_run_cfg(data_root, str(tmp_path / "run"))
    cfg.hooks = list(cfg.hooks) + [dict(type="_CacheProbe")]
    trainer = main_worker(cfg)
    run = SEEN["run"]
    assert len(SEEN["segments"]) == 2 * 5  # each train scene's 4 arrays and keys
    for got, path in zip(SEEN["coords"], SEEN["paths"]):
        np.testing.assert_array_equal(got, torch.load(path, weights_only=False)["coord"])
    assert np.isfinite(trainer.storage.history("val/mIoU").latest())
    assert not cache.segments(run) and not os.path.exists(cache._manifest_dir(run))

    def boom(self):
        raise RuntimeError("a step raised")

    monkeypatch.setattr(ttrain.Trainer, "run_step", boom)
    cfg = cached_run_cfg(data_root, str(tmp_path / "run2"))
    with pytest.raises(RuntimeError, match="a step raised"):
        trainer = ttrain.Trainer(cfg)
        trainer.train()
    assert trainer.cache_run != run
    assert not cache.segments(trainer.cache_run)
    assert not os.path.exists(cache._manifest_dir(trainer.cache_run))
