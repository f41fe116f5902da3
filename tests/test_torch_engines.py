"""PyTorch port vs JAX package: the engine pieces of the classifier and
part-segmentation paths, the submissions and the after-train hooks.

Each tester and evaluator runs in both packages over the same data with an
oracle in place of the model (a fixed function of the features, as
``tests/test_testers.py`` does), so what is compared is the engine code:
ScanNet200's split mIoU scalars (within 1e-6), the submission files (byte
for byte, first run and cached resume), ``ClsTester``'s and
``PartSegTester``'s log lines (equal) and returned metrics,
``ClsEvaluator``'s scalar. ``PreciseEvaluator``, ``RuntimeProfiler`` and
``launch`` are held on their own: the checkpoint each picks, a Chrome
trace on the CPU and the exit code, the single-process rule.
"""

import json
import logging
import os
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ponderv2_tpu.engines.hooks import evaluator as jev
from ponderv2_tpu.engines import test as jtest
from ponderv2_tpu.utils.config import Config as JConfig
from ponderv2_tpu.utils.events import EventStorage as JStorage
from ponderv2_tpu_torch.engines import launch as tlaunch
from ponderv2_tpu_torch.engines import test as ttest
from ponderv2_tpu_torch.engines.hooks import evaluator as tev
from ponderv2_tpu_torch.engines.hooks import misc as tmisc
from ponderv2_tpu_torch.utils.config import Config as TConfig
from ponderv2_tpu_torch.utils.events import EventStorage as TStorage
from ponderv2_tpu_torch.utils.logger import get_root_logger

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _torch_state():
    dtype, threads = torch.get_default_dtype(), torch.get_num_threads()
    torch.set_default_dtype(torch.float32)
    torch.set_num_threads(2)
    yield
    torch.set_default_dtype(dtype)
    torch.set_num_threads(threads)


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def logged(fn):
    """(fn's return value, the lines the framework logger logged meanwhile):
    both packages log to the logger named ``ponderv2_tpu``."""
    logger, handler = get_root_logger(), _Lines()
    logger.addHandler(handler)
    try:
        return fn(), handler.lines
    finally:
        logger.removeHandler(handler)


class _Stub:
    """A trainer's attributes that an evaluator reads."""

    def __init__(self, cfg, val_loader, eval_step, storage):
        self.cfg, self.val_loader, self.eval_step = cfg, val_loader, eval_step
        self.storage, self.logger, self.comm_info = storage, get_root_logger(), {}
        self.state = None


def oracle_logits(feat, num_classes, seed=3):
    """Deterministic logits of the features, the same for both packages."""
    w = np.random.RandomState(seed).randn(feat.shape[1], num_classes).astype(np.float32)
    return np.tanh(np.asarray(feat, np.float32) @ w) * 4.0


# ------------------------------------------------------ split mIoU scalars


def split_run(pkg, names, pred, segment):
    """One SemSegEvaluator pass over one val batch whose logits give
    ``pred``; the storage's latest scalars."""
    n = len(names)
    logits = np.full((len(pred), n), -5.0, np.float32)
    logits[np.arange(len(pred)), pred] = 5.0
    batch = {"segment": segment, "batch": np.zeros(len(pred), np.int32),
             "feat": np.zeros((len(pred), 1), np.float32)}
    cfg_cls, storage, ev = ((JConfig, JStorage(), jev) if pkg == "jax"
                            else (TConfig, TStorage(), tev))
    cfg = cfg_cls(dict(data=dict(num_classes=n, ignore_index=-1, names=list(names))))
    if pkg == "jax":
        step = lambda state, arrays: {"seg_logits": jnp.asarray(logits)}  # noqa: E731
    else:
        step = lambda input_dict: {"seg_logits": torch.from_numpy(logits)}  # noqa: E731
    hook = ev.SemSegEvaluator()
    hook.trainer = _Stub(cfg, [batch], step, storage)
    hook.eval()
    return {k: v[0] for k, v in storage.latest().items()}, hook.trainer.comm_info


def split_labels(n, seed=0):
    rng = np.random.RandomState(seed)
    segment = rng.randint(-1, n, 20000)
    pred = np.where(rng.rand(20000) < 0.6, np.clip(segment, 0, None), rng.randint(0, n, 20000))
    return pred, segment


def test_scannet200_split_mious_match_jax():
    """On ScanNet200's 200 names the port stores ``val/mIoU_{head,common,
    tail}`` equal to JAX's within 1e-6, and every other scalar and the
    metric handed to CheckpointSaver as JAX does."""
    from ponderv2_tpu_torch.datasets.preprocessing.scannet200_constants import (
        CLASS_LABELS_200)

    pred, segment = split_labels(len(CLASS_LABELS_200))
    jout, jinfo = split_run("jax", CLASS_LABELS_200, pred, segment)
    tout, tinfo = split_run("torch", CLASS_LABELS_200, pred, segment)
    assert sorted(tout) == sorted(jout)
    assert sorted(k for k in tout if k.startswith("val/mIoU_")) == [
        "val/mIoU_common", "val/mIoU_head", "val/mIoU_tail"]
    for k, v in jout.items():
        assert abs(tout[k] - v) <= 1e-6, (k, tout[k], v)
    assert tinfo == jinfo


def test_scannet20_names_store_no_split_port_only():
    """On ScanNet's 20 names the port stores no split scalar. JAX fault
    F13: 18 of the 20 names are ScanNet200 head categories, and the JAX
    evaluator stores a ``val/mIoU_head`` over them (its docstring promises
    none for 20-class ScanNet); the other scalars agree."""
    from ponderv2_tpu_torch.datasets.scannet import CLASS_NAMES_20

    pred, segment = split_labels(len(CLASS_NAMES_20), seed=1)
    jout, _ = split_run("jax", CLASS_NAMES_20, pred, segment)
    tout, _ = split_run("torch", CLASS_NAMES_20, pred, segment)
    assert not any(k.startswith("val/mIoU_") for k in tout)
    assert [k for k in jout if k.startswith("val/mIoU_")] == ["val/mIoU_head"]
    assert sorted(tout) == sorted(k for k in jout if k != "val/mIoU_head")
    for k, v in tout.items():
        assert abs(v - jout[k]) <= 1e-6, k


# ------------------------------------------------------------- submissions


def fragment_scene(rng, name, n_points, n_frag, num_classes):
    segment = rng.randint(0, num_classes, n_points).astype(np.int64)
    coord = rng.rand(n_points, 3).astype(np.float32)
    grid = rng.permutation(n_points)[:, None].repeat(3, 1).astype(np.int32)
    feat = rng.randn(n_points, 4).astype(np.float32)
    fragments = []
    for f in range(n_frag):
        idx = np.concatenate([np.arange(f, n_points, n_frag), rng.randint(0, n_points, 5)])
        fragments.append(dict(index=idx, coord=coord[idx], grid_coord=grid[idx],
                              feat=feat[idx]))
    return dict(name=name, segment=segment, fragment_list=fragments)


def oracle_tester(pkg, base, cfg, dataset, num_classes, key="seg_logits"):
    """``base``'s ``test`` and writers around an oracle ``eval_fragment``."""

    class Oracle(base):
        def __init__(self):
            self.logger = get_root_logger()
            self.cfg, self.test_dataset = cfg, dataset

        def eval_fragment(self, arrays):
            out = oracle_logits(arrays["feat"], num_classes)
            if key == "cls_logits":  # one row per sample: its rows' mean
                out = out.mean(0, keepdims=True)
            return {key: jnp.asarray(out) if pkg == "jax" else out}

    return Oracle()


@pytest.mark.parametrize("ds_type,ext", [("ScanNetDataset", ".txt"),
                                         ("NuScenesDataset", "_lidarseg.bin"),
                                         ("SyntheticDataset", ".txt")])
def test_submissions_match_jax(tmp_path, ds_type, ext):
    """``submit=True``: each scene's submission file equals JAX's byte for
    byte, written on the first run and again from the cached prediction."""
    num_classes = 16 if ds_type == "NuScenesDataset" else 20
    rng = np.random.RandomState(1)
    scenes = [fragment_scene(rng, f"scene{i}", 150, 3, num_classes) for i in range(2)]
    files = {}
    for pkg, base, cfg_cls in (("jax", jtest.SemSegTester, JConfig),
                               ("torch", ttest.SemSegTester, TConfig)):
        save = tmp_path / pkg
        cfg = cfg_cls(dict(save_path=str(save), point_budget_test=256, submit=True,
                           data=dict(num_classes=num_classes, ignore_index=-1,
                                     test=dict(type=ds_type))))
        tester = oracle_tester(pkg, base, cfg, scenes, num_classes)
        tester.test()
        first = {p.name: p.read_bytes() for p in sorted((save / "submit").iterdir())}
        for p in (save / "submit").iterdir():
            p.unlink()
        tester.test()  # every scene from result/{name}_pred.npy
        resumed = {p.name: p.read_bytes() for p in sorted((save / "submit").iterdir())}
        assert resumed == first
        files[pkg] = first
    assert sorted(files["torch"]) == [f"scene{i}{ext}" for i in range(2)]
    assert files["torch"] == files["jax"]
    if ds_type == "ScanNetDataset":
        from ponderv2_tpu_torch.datasets.scannet import VALID_CLASS_IDS_20

        ids = np.loadtxt(tmp_path / "torch" / "submit" / "scene0.txt", dtype=int)
        assert len(ids) == 150 and set(ids) <= set(VALID_CLASS_IDS_20)


# ------------------------------------------------- classification testers


def cls_samples(rng, n, num_classes):
    """Samples of 60-100 points with a 0-d ``category``."""
    out = []
    for _ in range(n):
        k = rng.randint(60, 100)
        out.append(dict(coord=rng.rand(k, 3).astype(np.float32),
                        grid_coord=rng.randint(0, 30, (k, 3)).astype(np.int32),
                        feat=rng.randn(k, 4).astype(np.float32),
                        category=np.asarray(rng.randint(0, num_classes))))
    return out


def test_cls_tester_matches_jax():
    """Same logits in: ``ClsTester`` logs JAX's line and returns its
    accuracy, which is the share of samples whose argmax is their class."""
    num_classes = 5
    samples = cls_samples(np.random.RandomState(2), 24, num_classes)
    runs = {}
    for pkg, base, cfg_cls in (("jax", jtest.ClsTester, JConfig),
                               ("torch", ttest.ClsTester, TConfig)):
        cfg = cfg_cls(dict(point_budget=128, data=dict(num_classes=num_classes)))
        tester = oracle_tester(pkg, base, cfg, samples, num_classes, key="cls_logits")
        runs[pkg] = logged(tester.test)
    (metrics, lines), (_, jlines) = runs["torch"], runs["jax"]
    assert lines == jlines and lines == [f"Test result: allAcc {metrics['all_acc']:.4f}"]
    hits = [int(oracle_logits(s["feat"], num_classes).mean(0).argmax() == s["category"])
            for s in samples]
    assert abs(metrics["all_acc"] - np.mean(hits)) < 1e-9 and 0 < np.mean(hits) < 1


class _PartDataset(list):
    categories = ("mug", "lamp", "cap")
    category2part = {"mug": [0, 1], "lamp": [2, 3, 4], "cap": [5, 6]}


def part_samples(rng, n):
    """Samples whose labels lie in their category's parts; some miss a part
    that the oracle never predicts either (the both-empty rule)."""
    out = _PartDataset()
    for i in range(n):
        ci = i % 3
        parts = _PartDataset.category2part[_PartDataset.categories[ci]]
        k = rng.randint(60, 100)
        present = parts[:-1] if i % 2 else parts
        out.append(dict(coord=rng.rand(k, 3).astype(np.float32),
                        grid_coord=rng.randint(0, 30, (k, 3)).astype(np.int32),
                        feat=rng.randn(k, 4).astype(np.float32),
                        segment=rng.choice(present, k).astype(np.int64),
                        category=np.asarray(ci)))
    return out


def test_part_seg_tester_matches_jax():
    """Same logits in: ``PartSegTester`` logs JAX's lines (ins.mIoU,
    cat.mIoU and each category's), and its returned metrics are those."""
    num_classes = 7
    samples = part_samples(np.random.RandomState(4), 12)
    runs = {}
    for pkg, base, cfg_cls in (("jax", jtest.PartSegTester, JConfig),
                               ("torch", ttest.PartSegTester, TConfig)):
        cfg = cfg_cls(dict(point_budget=128, data=dict(num_classes=num_classes)))
        tester = oracle_tester(pkg, base, cfg, samples, num_classes)
        runs[pkg] = logged(tester.test)
    (metrics, lines), (_, jlines) = runs["torch"], runs["jax"]
    assert lines == jlines and len(lines) == 4
    assert lines[0] == (f"Test result: ins.mIoU/cat.mIoU {metrics['ins_miou']:.4f}/"
                        f"{metrics['cat_miou']:.4f}")
    assert list(metrics["iou_count"]) == [4, 4, 4]
    # the both-empty rule: a part absent from labels and prediction scores 1
    assert metrics["ins_miou"] > 0


def test_part_seg_tester_default_category():
    """Without categories the tester scores every class as one category."""
    num_classes = 4
    rng = np.random.RandomState(5)
    samples = [dict(coord=rng.rand(50, 3).astype(np.float32),
                    grid_coord=rng.randint(0, 20, (50, 3)).astype(np.int32),
                    feat=rng.randn(50, 4).astype(np.float32),
                    segment=rng.randint(0, num_classes, 50)) for _ in range(3)]
    cfg = TConfig(dict(point_budget=64, data=dict(num_classes=num_classes)))
    tester = oracle_tester("torch", ttest.PartSegTester, cfg, samples, num_classes)
    metrics = tester.test()
    assert list(metrics["iou_count"]) == [3]
    assert metrics["ins_miou"] == pytest.approx(metrics["cat_miou"], abs=1e-9)


def test_cls_evaluator_matches_jax():
    """``ClsEvaluator`` over two val batches: ``val/allAcc`` and the metric
    handed to CheckpointSaver equal JAX's."""
    rng = np.random.RandomState(6)
    batches = [dict(category=rng.randint(0, 5, 8), feat=rng.randn(8, 4).astype(np.float32))
               for _ in range(2)]
    out = {}
    for pkg, cfg_cls, storage, ev in (("jax", JConfig, JStorage(), jev),
                                      ("torch", TConfig, TStorage(), tev)):
        def step(*args):
            b = args[-1]
            logits = oracle_logits(b["feat"], 5)
            return {"cls_logits": jnp.asarray(logits) if pkg == "jax"
                    else torch.from_numpy(logits)}

        hook = ev.ClsEvaluator()
        hook.trainer = _Stub(cfg_cls(dict(data=dict(num_classes=5))), batches, step, storage)
        hook.eval()
        out[pkg] = ({k: v[0] for k, v in storage.latest().items()}, hook.trainer.comm_info)
    assert out["torch"] == out["jax"]
    assert sorted(out["torch"][0]) == ["val/allAcc"]
    assert out["torch"][1]["current_metric_name"] == "allAcc"


# -------------------------------------------------------- hooks and launch


@ttest.TESTERS.register_module()
class _RecordingTester:
    """A tester that records the weight it was given."""

    def __init__(self, cfg):
        self.weight = cfg.weight

    def test(self):
        return {"weight": os.path.basename(self.weight)}


def test_precise_evaluator_picks_best_then_last(tmp_path):
    """``PreciseEvaluator`` tests ``model_best.pth`` where there is one,
    else ``model_last.pth`` (always with ``test_last``), and ``cfg.weight``
    names it after."""
    os.makedirs(tmp_path / "model")
    (tmp_path / "model" / "model_last.pth").write_bytes(b"")
    picked = []
    for best, test_last in ((False, False), (True, False), (True, True)):
        if best:
            (tmp_path / "model" / "model_best.pth").write_bytes(b"")
        cfg = TConfig(dict(save_path=str(tmp_path), test=dict(type="_RecordingTester")))
        hook = tmisc.PreciseEvaluator(test_last=test_last)
        hook.trainer = _Stub(cfg, None, None, None)
        hook.after_train()
        picked.append(hook.trainer.comm_info["precise_metrics"]["weight"])
        assert cfg.weight == str(tmp_path / "model" / picked[-1])
    assert picked == ["model_last.pth", "model_best.pth", "model_last.pth"]


def test_runtime_profiler_writes_a_trace_and_exits(tmp_path):
    """The synthetic config's trainer on the CPU with ``RuntimeProfiler``
    alone: 1 warm-up step, 2 recorded, a Chrome trace of them with the
    convs' ops in it, then ``SystemExit(0)``."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from train_torch import main_worker

    from ponderv2_tpu_torch.engines.defaults import default_config_parser

    cfg = default_config_parser(os.path.join(ROOT, "configs/_test_/semseg_synthetic.py"),
                                {"save_path": str(tmp_path), "device": "cpu"})
    trace_dir = str(tmp_path / "trace")
    cfg.hooks = [dict(type="RuntimeProfiler", trace_dir=trace_dir, warm_up=1, record=2)]
    with pytest.raises(SystemExit) as exit_info:
        main_worker(cfg)
    assert exit_info.value.code == 0
    with open(os.path.join(trace_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any("matmul" in n or "mm" in n for n in names), sorted(names)[:20]


def test_launch_runs_one_process(monkeypatch):
    """``launch`` calls ``main_func(*cfg)`` in this process, with no process
    group, where one process is asked for: no environment, one GPU, a
    one-task SLURM job, JAX's coordinator variables (they are
    ``jax.distributed``'s), and any environment under
    ``PONDER_DISABLE_DISTRIBUTED``. Several machines need an address
    (``dist_url``). More processes: ``tests/test_torch_parallel.py``."""
    import torch.distributed as dist

    calls = []

    def main(*args):
        calls.append((args, dist.is_initialized()))

    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "SLURM_NTASKS", "SLURM_PROCID",
                "SLURM_LOCALID", "SLURM_JOB_NUM_NODES", "PONDER_DISABLE_DISTRIBUTED",
                "COORDINATOR_ADDRESS", "JAX_COORDINATOR_ADDRESS"):
        monkeypatch.delenv(var, raising=False)
    tlaunch.launch(main, cfg=(1, "x"))
    tlaunch.launch(main, num_gpus_per_machine=1, cfg=(2,))
    assert calls == [((1, "x"), False), ((2,), False)] and tlaunch.slurm_launch is tlaunch.launch
    for env in ({"SLURM_JOB_NUM_NODES": "1", "SLURM_NTASKS": "1"},
                {"JAX_COORDINATOR_ADDRESS": "localhost:1234"},
                {"PONDER_DISABLE_DISTRIBUTED": "1", "WORLD_SIZE": "2", "RANK": "1"}):
        with monkeypatch.context() as m:
            for var, value in env.items():
                m.setenv(var, value)
            tlaunch.launch(main, cfg=(3,))
        assert calls[-1] == ((3,), False), env
    with pytest.raises(ValueError, match="dist_url"):
        tlaunch.launch(main, num_gpus_per_machine=2, num_machines=2)
    assert len(calls) == 5
