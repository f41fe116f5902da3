"""PyTorch port vs JAX package: instance segmentation's host side on the CPU.

The same numpy inputs, made from a seed, go through the JAX functions and
the port's:

- the clustering: the port's native BFS (``csrc/cluster.cpp``, a copy of
  the JAX package's, built into ``csrc/_build/``), its numpy plain
  version and the JAX ``bfs_cluster`` give equal ids, on random clouds, on a
  blob where every point has more than ``NEIGHBOR_CAP`` neighbours, and on
  points exactly one radius apart (strict ``<``); a failed build raises;
- the proposals (``cluster_proposals``, ``PointGroup.propose_instances``):
  equal masks and classes, scores within 1e-6;
- the ScanNet AP (``evaluate_instance_ap``): equal to JAX's, nan positions
  too, on random proposals and on the protocol cases of
  ``tests/test_models_extra.py``;
- ``tools/train_torch.py`` on the insseg PPT recipe cut to test widths over
  scene files with instance labels: one step, then ``InsSegEvaluator`` with
  ``val/mAP*`` in storage, the condition "ScanNet" in its forwards, and the
  ground truth as predictions scoring mAP50 1.0;
- the PG-v1m1 converter against ``tools/convert_torch_checkpoint.py``'s names.

The JAX ``bfs_cluster`` runs its numpy path here (``_load_native`` patched
to None), so that nothing is built beside the JAX package's source.
"""

import os
import sys

import numpy as np
import pytest
import torch

from ponderv2_tpu.engines.hooks import evaluator as jev
from ponderv2_tpu.models.point_group import cluster as jcluster
from ponderv2_tpu.models.point_group.point_group import PointGroup as JPointGroup
from ponderv2_tpu_torch.engines.hooks import evaluator as tev
from ponderv2_tpu_torch.models.point_group import cluster as tcluster

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tools")]
import chip_smoke  # noqa: E402
from torch_threads import _torch_threads  # noqa: F401, E402  (autouse fixture)

PG_KW = dict(segment_ignore_index=(-1, 0, 1), cluster_thresh=1.5, voxel_size=0.02,
             cluster_min_points=5, cluster_propose_points=8, semantic_num_classes=6)


@pytest.fixture(autouse=True)
def _jax_numpy_clustering(monkeypatch):
    monkeypatch.setattr(jcluster, "_load_native", lambda: None)


def all_three(coords, classes, radius, min_points):
    """(native, plain, JAX) ids and counts; asserts they agree."""
    native = tcluster.bfs_cluster(coords, classes, radius, min_points)
    plain = tcluster.bfs_cluster_plain(coords, classes, radius, min_points)
    ref = jcluster.bfs_cluster(coords, classes, radius, min_points)
    for name, (ids, n) in (("native", native), ("plain", plain)):
        assert n == ref[1], name
        np.testing.assert_array_equal(ids, ref[0], err_msg=name)
    return native


# -------------------------------------------------------------- clustering
def test_cluster_source_is_the_jax_one():
    """``csrc/cluster.cpp`` is the JAX package's, byte for byte but for the
    reference's location in its header comment, and its build lands in the
    port's ``csrc/_build/``."""
    with open(os.path.join(ROOT, "ponderv2_tpu", "csrc", "cluster.cpp"), "rb") as f:
        jax_src = f.read()
    with open(tcluster.CPP, "rb") as f:
        port_src = f.read()
    cited = jax_src.index(b"libs/pointgroup_ops/src/bfs_cluster.cpp:40-145)")
    start = jax_src.rindex(b"(", 0, cited)
    assert port_src == jax_src[:start] + b"(reference " + jax_src[cited:]
    assert tcluster.NEIGHBOR_CAP == jcluster.NEIGHBOR_CAP
    tcluster.load_native()
    assert os.path.isfile(tcluster._lib_path())
    assert os.path.dirname(tcluster._lib_path()) == os.path.join(
        ROOT, "ponderv2_tpu_torch", "csrc", "_build")


@pytest.mark.parametrize("seed", range(4))
def test_bfs_cluster_matches_jax_on_random_clouds(seed):
    rng = np.random.RandomState(seed)
    blobs = [rng.randn(rng.randint(20, 120), 3) * rng.uniform(0.005, 0.03)
             + rng.uniform(-1, 1, 3) for _ in range(6)]
    coords = np.concatenate(blobs + [rng.uniform(-1, 1, (200, 3))]).astype(np.float32)
    classes = rng.randint(0, 3, len(coords)).astype(np.int32)
    perm = rng.permutation(len(coords))
    ids, n = all_three(coords[perm], classes[perm], 0.04, 5)
    assert n >= 2 and (ids == -1).any()


def test_bfs_cluster_neighbour_cap():
    """1500 points of one class within the radius of each other: each
    neighbour list keeps the first 1000 indices, so the BFS reaches those
    only and the rest, each alone, fall under ``min_points``."""
    rng = np.random.RandomState(0)
    coords = (rng.rand(1500, 3) * 0.01).astype(np.float32)
    ids, n = all_three(coords, np.zeros(1500, np.int32), 0.05, 2)
    assert n == 1 and (ids[:tcluster.NEIGHBOR_CAP] == 0).all()
    assert (ids[tcluster.NEIGHBOR_CAP:] == -1).all()


def test_bfs_cluster_strict_radius():
    """Points exactly one radius apart (0.5, exact in float32) do not
    connect; at 0.25 they do."""
    line = np.zeros((8, 3), np.float32)
    line[:, 0] = np.arange(8) * 0.5
    ids, n = all_three(line, np.zeros(8, np.int32), 0.5, 1)
    assert n == 8 and sorted(ids) == list(range(8))
    line[:, 0] = np.arange(8) * 0.25
    ids, n = all_three(line, np.zeros(8, np.int32), 0.5, 1)
    assert n == 1 and (ids == 0).all()


def test_bfs_cluster_empty():
    ids, n = tcluster.bfs_cluster(np.zeros((0, 3), np.float32), np.zeros(0, np.int32))
    assert n == 0 and ids.shape == (0,)


def test_failed_build_raises(monkeypatch, tmp_path):
    """A source the compiler rejects raises with the compiler's output;
    there is no fallback to the plain version."""
    bad = tmp_path / "cluster.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tcluster, "CPP", str(bad))
    monkeypatch.setattr(tcluster, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(tcluster, "_NATIVE", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed on csrc/cluster.cpp"):
        tcluster.bfs_cluster(np.zeros((3, 3), np.float32), np.zeros(3, np.int32))
    assert not any(p.suffix == ".so" for p in (tmp_path / "_build").iterdir())


def test_native_calls_are_counted():
    before = tcluster.NATIVE.launches
    tcluster.bfs_cluster(np.zeros((3, 3), np.float32), np.zeros(3, np.int32), 0.1, 1)
    tcluster.bfs_cluster_plain(np.zeros((3, 3), np.float32), np.zeros(3, np.int32), 0.1, 1)
    assert tcluster.NATIVE.launches == before + 1


# --------------------------------------------------------------- proposals
def proposal_inputs(seed, n_scenes=2, pad=7, classes=6):
    """Blobs of points per scene with logits that favour one class per blob,
    small offsets, and ``pad`` padding rows (batch -1)."""
    rng = np.random.RandomState(seed)
    coord, logits, batch = [], [], []
    for b in range(n_scenes):
        for _ in range(5):
            k = rng.randint(5, 40)
            coord.append(rng.randn(k, 3) * 0.01 + rng.uniform(-2, 2, 3))
            lg = rng.randn(k, classes)
            lg[:, rng.randint(0, classes)] += 4.0
            logits.append(lg)
            batch.append(np.full(k, b))
    coord = np.concatenate(coord + [np.zeros((pad, 3))]).astype(np.float32)
    logits = np.concatenate(logits + [rng.randn(pad, classes)]).astype(np.float32)
    batch = np.concatenate(batch + [np.full(pad, -1)]).astype(np.int32)
    bias = (rng.randn(len(coord), 3) * 0.005).astype(np.float32)
    return coord, logits, bias, batch


@pytest.mark.parametrize("seed", range(3))
def test_cluster_proposals_match_jax(seed):
    coord, logits, bias, batch = proposal_inputs(seed)
    valid = (batch >= 0) & (logits.argmax(-1) > 1)
    args = (coord, coord + bias, logits.argmax(-1), valid, 0.03, 5)
    ref = jcluster.cluster_proposals(*args)
    out = tcluster.cluster_proposals(*args)
    assert len(out) == len(ref) > 0
    for o, r in zip(out, ref):
        np.testing.assert_array_equal(o, r)


@pytest.mark.parametrize("seed", range(3))
def test_propose_instances_matches_jax(seed):
    """Masks and classes equal, scores within 1e-6; padding rows in no
    proposal."""
    from ponderv2_tpu_torch.models import build_model

    coord, logits, bias, batch = proposal_inputs(seed)
    backbone = dict(type="SpUNet-v1m1", in_channels=6, num_classes=0, base_channels=8,
                    channels=(8, 16, 16, 16, 16, 16, 8, 8), layers=(1,) * 8)
    ref = JPointGroup(backbone=backbone, backbone_out_channels=8, **PG_KW).propose_instances(
        coord, logits, bias, batch)
    model = build_model(dict(type="PG-v1m1", backbone=backbone, backbone_out_channels=8,
                             **PG_KW))
    out = model.propose_instances(coord, logits, bias, batch)
    assert len(out) == len(ref) > 0
    for o, r in zip(out, ref):
        np.testing.assert_array_equal(o["mask"], r["mask"])
        assert (o["cls"], o["batch"]) == (r["cls"], r["batch"])
        assert abs(o["score"] - r["score"]) <= 1e-6
        assert not o["mask"][batch < 0].any()


# ---------------------------------------------------------------------- AP
def random_scene(rng, classes=6):
    """A scene of instances of 40-160 rows with random classes (void rows
    segment 0/1), and proposals that cover parts of instances, parts of two,
    or void, with random classes and scores."""
    sizes = rng.randint(40, 160, rng.randint(2, 7))
    inst = np.concatenate([np.full(s, i) for i, s in enumerate(sizes)])
    seg = np.concatenate([np.full(s, rng.randint(2, classes)) for s in sizes])
    void = rng.randint(50, 200)
    n = len(inst) + void
    inst = np.concatenate([inst, np.full(void, -1)])
    seg = np.concatenate([seg, rng.randint(0, 2, void)])
    perm = rng.permutation(n)
    inst, seg = inst[perm], seg[perm]
    preds = []
    for _ in range(rng.randint(1, 9)):
        mask = np.zeros(n, bool)
        kind = rng.randint(3)
        if kind == 0:  # a share of one instance
            rows = np.nonzero(inst == rng.randint(len(sizes)))[0]
            mask[rows[: max(1, int(len(rows) * rng.uniform(0.2, 1.0)))]] = True
        elif kind == 1:  # two instances
            mask[np.isin(inst, rng.randint(len(sizes), size=2))] = True
        else:  # random rows, void among them
            mask[rng.rand(n) < rng.uniform(0.05, 0.4)] = True
        cls = int(seg[np.argmax(mask)]) if rng.rand() < 0.7 else int(rng.randint(classes))
        preds.append(dict(mask=mask, cls=cls, score=float(rng.rand())))
    return preds, dict(instance=inst, segment=seg)


def assert_same_ap(out, ref):
    for k in ("mAP", "mAP50", "mAP25"):
        assert out[k] == ref[k], k
    np.testing.assert_array_equal(out["ap_table"], ref["ap_table"])  # nan where nan


@pytest.mark.parametrize("seed", range(4))
def test_evaluate_instance_ap_matches_jax_on_random_proposals(seed):
    rng = np.random.RandomState(seed)
    scenes = [random_scene(rng) for _ in range(3)]
    preds, gts = [p for p, _ in scenes], [g for _, g in scenes]
    ref = jev.evaluate_instance_ap(preds, gts, 6)
    out = tev.evaluate_instance_ap(preds, gts, 6)
    assert_same_ap(out, ref)
    assert np.isnan(ref["ap_table"]).any() and np.isfinite(ref["ap_table"]).any()


def _protocol_cases():
    """The cases of ``TestInstanceAP`` and ``TestInstanceAPProtocol``
    (tests/test_models_extra.py): (name, preds, instance, segment, key,
    expected)."""
    cases = []
    instance = np.repeat(np.arange(4), 100)
    segment = np.repeat([2, 2, 3, 3], 100)
    preds = [dict(mask=instance == i, cls=int(segment[i * 100]), score=0.9) for i in range(4)]
    cases.append(("perfect", preds, instance, segment, "mAP", 1.0))
    instance = np.repeat(np.arange(2), 100)
    cases.append(("disjoint", [dict(mask=np.zeros(200, bool), cls=2, score=0.9)], instance,
                  np.full(200, 2), "mAP", 0.0))
    instance = np.concatenate([np.zeros(120, int), np.full(200, -1)])
    segment = np.concatenate([np.full(120, 2), np.zeros(200, int)])
    good = dict(mask=instance == 0, cls=2, score=0.9)
    void_pred = dict(mask=np.concatenate([np.zeros(120, bool), np.ones(200, bool)]), cls=2,
                     score=0.95)
    cases.append(("void-dominated", [good, void_pred], instance, segment, "mAP", 1.0))
    segment_no_void = np.concatenate([np.full(120, 2), np.full(200, 3)])
    cases.append(("void relabelled", [good, void_pred], instance, segment_no_void, "mAP",
                  None))
    instance = np.repeat([0, 1], 100)
    cases.append(("hard false negative", [dict(mask=instance == 0, cls=2, score=0.9)],
                  instance, np.full(200, 2), "mAP50", 0.5))
    half = np.zeros(200, bool)
    half[:100] = True
    for key, want in (("mAP50", 0.0), ("mAP25", 1.0)):
        cases.append((f"strict overlap {key}", [dict(mask=half, cls=2, score=0.9)],
                      np.zeros(200, int), np.full(200, 2), key, want))
    tiny = np.zeros(200, bool)
    tiny[:10] = True
    cases.append(("small prediction", [dict(mask=np.ones(200, bool), cls=2, score=0.9),
                                       dict(mask=tiny, cls=2, score=0.95)],
                  np.zeros(200, int), np.full(200, 2), "mAP", 1.0))
    return cases


@pytest.mark.parametrize("case", _protocol_cases(), ids=lambda c: c[0])
def test_evaluate_instance_ap_protocol_matches_jax(case):
    """Each protocol case gives the JAX package's result, and the value the
    JAX tests expect (below 1.0 where the void points are relabelled)."""
    _, preds, instance, segment, key, want = case
    args = ([preds], [dict(instance=instance, segment=segment)])
    ref = jev.evaluate_instance_ap(*args, num_classes=5, segment_ignore_index=(-1, 0, 1))
    out = tev.evaluate_instance_ap(*args, num_classes=5, segment_ignore_index=(-1, 0, 1))
    assert_same_ap(out, ref)
    if want is None:
        assert out[key] < 1.0
    else:
        assert out[key] == pytest.approx(want)


def test_scannet200_ignore_set_goes_through_parser_and_ap():
    """ScanNet200's ``(-1, 0, 2)``: ``InstanceParser`` and the AP take it as
    the JAX ones do (class 1 counts, class 2 is void)."""
    from ponderv2_tpu.datasets.transform import TRANSFORMS as JT
    from ponderv2_tpu_torch.datasets.transform import TRANSFORMS as TT

    rng = np.random.RandomState(0)
    segment = rng.randint(0, 5, 400)
    instance = rng.randint(-1, 6, 400)
    coord = rng.rand(400, 3).astype(np.float32)
    outs = []
    for reg in (JT, TT):
        parse = reg.build(dict(type="InstanceParser", segment_ignore_index=(-1, 0, 2)))
        outs.append(parse(dict(coord=coord, segment=segment.copy(), instance=instance.copy())))
    for k in ("instance", "instance_centroid", "bbox"):
        np.testing.assert_array_equal(outs[0][k], outs[1][k])
    assert (outs[1]["instance"][np.isin(segment, (0, 2))] == -1).all()
    preds, gt = random_scene(rng)
    ref = jev.evaluate_instance_ap([preds], [gt], 6, (-1, 0, 2))
    assert_same_ap(tev.evaluate_instance_ap([preds], [gt], 6, (-1, 0, 2)), ref)


# ----------------------------------------------------- the evaluator, e2e
INSSEG_TEST_WIDTHS = {
    "model.backbone.backbone.channels": (8, 16, 16, 16, 16, 16, 8, 8),
    "model.backbone.backbone.layers": (1,) * 8,
    "model.backbone.backbone.base_channels": 8,
    "model.backbone.backbone.context_channels": 16,
    "model.backbone.context_channels": 16,
    "model.backbone.backbone_out_channels": 8,
    "model.backbone_out_channels": 8,
}


@pytest.fixture(scope="module")
def insseg_run(tmp_path_factory):
    """``tools/train_torch.py:main_worker`` on the ScanNet insseg PPT recipe
    at test widths (batch 2, 8192-row budget) over 4 + 2 scene files of
    4,000 points with one instance per box: one step, then the recipe's
    ``InsSegEvaluator``; records the condition of every forward."""
    from ponderv2_tpu_torch.engines.defaults import default_config_parser
    from ponderv2_tpu_torch.engines.hooks import HookBase
    from train_torch import main_worker

    tmp = tmp_path_factory.mktemp("insseg")
    chip_smoke.write_scannet_scenes(str(tmp / "data"), 2, 2, points=4000, instances=True)
    conditions = []

    class Record(HookBase):
        def before_train(self):
            self.trainer.model.register_forward_pre_hook(
                lambda module, args: conditions.append(args[0].get("condition")))

    opts = chip_smoke.insseg_recipe_options(str(tmp / "data"), str(tmp / "save"))
    opts.update(INSSEG_TEST_WIDTHS, device="cpu", batch_size=2, num_worker=0,
                point_budget=8192, point_budget_val=4096)
    cfg = default_config_parser(chip_smoke.INSSEG_CONFIG, opts)
    cfg.seed = 0
    cfg.hooks = list(cfg.hooks) + [dict(type=Record)]
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        trainer = main_worker(cfg)
    finally:
        torch.set_num_threads(threads)
    return trainer, conditions


def test_train_torch_runs_insseg_evaluator(insseg_run):
    """One step, one evaluation; ``val/mAP``, ``val/mAP50`` and ``val/mAP25``
    land in storage and ``mAP50`` is the checkpoint metric."""
    trainer, _ = insseg_run
    assert trainer.step == 1 and len(trainer.val_loader) == 2
    scalars = {k: trainer.storage.history(f"val/{k}").latest()
               for k in ("mAP", "mAP50", "mAP25")}
    assert all(np.isfinite(v) for v in scalars.values())
    assert trainer.comm_info["current_metric_name"] == "mAP50"
    assert trainer.comm_info["current_metric_value"] == scalars["mAP50"]
    assert os.path.isfile(os.path.join(trainer.cfg.save_path, "model", "model_last.pth"))


def test_insseg_evaluation_condition_port_only(insseg_run):
    """Every forward, the evaluator's included, got the recipe's "ScanNet";
    the JAX trainer and evaluator drop it and PPT-v1m1 falls back to its
    first condition, "Structured3D" (ROADMAP Queue 3)."""
    trainer, conditions = insseg_run
    assert conditions == ["ScanNet"] * 3
    assert trainer.model.backbone.conditions[0] == "Structured3D"


def test_oracle_predictions_score_map50_one(insseg_run):
    """The val batches with the ground truth as predictions
    (``chip_smoke.oracle_predictions``, the full offset: these instances have
    fewer rows than the neighbour cap) give mAP50 1.0 through
    ``propose_instances`` and ``evaluate_instance_ap``."""
    trainer, _ = insseg_run
    preds, gts = [], []
    for batch in trainer.val_loader:
        logits, bias = chip_smoke.oracle_predictions(batch, 20, 1.0)
        proposals = trainer.model.propose_instances(
            np.asarray(batch["coord"], np.float32), logits, bias, batch["batch"])
        p, g = tev.split_scenes(batch, proposals)
        preds += p
        gts += g
    res = tev.evaluate_instance_ap(preds, gts, 20, (-1, 0, 1))
    assert len(gts) == 2 and sum(len(p) for p in preds) >= 4
    assert res["mAP50"] == 1.0 and res["mAP"] == 1.0


def test_scene_instance_ids_follow_the_layout():
    """One id per box, -1 on the floor and wall, each box its own class."""
    from ponderv2_tpu_torch.datasets.defaults import SyntheticDataset

    for i in range(3):
        scene = SyntheticDataset(num_scenes=3, points_per_scene=5000).make_scene(i)
        ids = chip_smoke.scene_instance_ids(scene["segment"], 5000)
        seg = scene["segment"]
        assert (ids[seg <= 1] == -1).all() and (ids[seg > 1] >= 0).all()
        for b in np.unique(ids[ids >= 0]):
            assert len(np.unique(seg[ids == b])) == 1
        assert len(np.unique(ids[ids >= 0])) == len(np.unique(seg[seg > 1]))


# -------------------------------------------------------------- converter
def test_point_group_converter_names():
    """``state_dict_from_jax_point_group`` gives the port's keys: the
    backbone under ``backbone.`` (SpUNet-v1m1's converter), the heads'
    kernels transposed into ``Linear.weight``."""
    from ponderv2_tpu_torch.models import build_model
    from ponderv2_tpu_torch.utils.convert import state_dict_from_jax_point_group
    from convert_torch_checkpoint import convert_spunet_v1m1

    backbone = dict(type="SpUNet-v1m1", in_channels=6, num_classes=0, base_channels=8,
                    channels=(8, 16, 16, 16, 16, 16, 8, 8), layers=(1,) * 8)
    model = build_model(dict(type="PG-v1m1", backbone=backbone, backbone_out_channels=8,
                             semantic_num_classes=6))
    model.reset_parameters(torch.Generator().manual_seed(0))
    state = {k: v.numpy() for k, v in model.state_dict().items()}
    bb = {k[len("backbone."):]: v for k, v in state.items() if k.startswith("backbone.")}
    params, stats = convert_spunet_v1m1(bb, backbone["channels"], backbone["layers"])
    params = {"backbone_net": params,
              "bias_head": {"layers_0": {"kernel": state["bias_head.0.weight"].T,
                                         "bias": state["bias_head.0.bias"]},
                            "layers_2": {"kernel": state["bias_head.2.weight"].T,
                                         "bias": state["bias_head.2.bias"]}},
              "seg_head": {"kernel": state["seg_head.weight"].T, "bias": state["seg_head.bias"]}}
    back = state_dict_from_jax_point_group(
        {"params": params, "batch_stats": {"backbone_net": stats}}, backbone)
    assert sorted(back) == sorted(state)
    for k, v in state.items():
        assert np.asarray(back[k], v.dtype).tobytes() == v.tobytes(), k
