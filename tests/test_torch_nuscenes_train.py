"""PyTorch port on the CPU: the nuScenes entry points, cut to test widths.

``tools/train_torch.py`` on the base outdoor pretrain config (one step at
``test_torch_nuscenes.py``'s widths on its writer's scans), then on the
nuScenes semseg config from that pretrain's checkpoint, and
``tools/test_torch.py`` on the fine-tuned weights.
``test_torch_nuscenes_pretrain.py`` runs the other three pretrain configs.
"""

import os

import numpy as np
import pytest
import torch

import ponderv2_tpu_torch.datasets.nuscenes as tnus
import ponderv2_tpu_torch.datasets.transform as ttr
from ponderv2_tpu_torch.engines.defaults import default_config_parser
from test_torch_nuscenes import PRETRAIN, RANGE, SEMSEG, SMALL, SMALL_RENDER, scans  # noqa: F401
from torch_threads import _torch_threads  # noqa: F401  (autouse fixture)


def _train(config, root, save, opts=None, weight=None):
    from train_torch import main_worker

    options = {**SMALL, "data.train.data_root": root, "batch_size": 2, "num_worker": 0,
               "epoch": 1, "eval_epoch": 1, "save_path": save, "device": "cpu",
               "weight": weight, **(opts or {})}
    cfg = default_config_parser(config, options)
    return main_worker(cfg)


@pytest.fixture(scope="module")
def pretrained(scans, tmp_path_factory):
    """The base outdoor pretrain config, one step at test widths."""
    save = str(tmp_path_factory.mktemp("pretrain"))
    trainer = _train(PRETRAIN["base"], scans[0], save, SMALL_RENDER)
    return trainer, os.path.join(save, "model", "model_last.pth")


def check_outdoor_pretrain(trainer, save):
    """One step, every metric key of the config in the log's metrics and
    finite, the block mask's token trained, and the checkpoint written."""
    metrics = trainer.comm_info["metrics"]
    assert trainer.step == 1 and bool(metrics["contract_ok"])
    for key in trainer.cfg.metric_keys:
        assert key in metrics and np.isfinite(float(metrics[key])), key
    assert type(trainer.model).__name__ == "PonderOutdoor"
    assert trainer.model.mtoken.shape == (1, 4)
    assert os.path.isfile(os.path.join(save, "model", "model_last.pth"))


@pytest.mark.parametrize("name", ["base"])
def test_train_torch_outdoor_pretrain_on_cpu(scans, pretrained, tmp_path, name):
    """``tools/train_torch.py`` on each nuScenes pretrain config (test
    widths, batch 2 of the writer's scans, cameras 96 x 160): one step,
    every metric key of the config in the log's metrics and finite, the
    block mask's token trained, and the checkpoint written. The base
    config's run is the ``pretrained`` fixture's; the other three configs
    are ``test_torch_nuscenes_pretrain.py``'s cases."""
    trainer = pretrained[0]
    save = os.path.dirname(os.path.dirname(pretrained[1]))
    check_outdoor_pretrain(trainer, save)


def test_train_and_test_torch_nuscenes_semseg_from_the_pretrain_on_cpu(
        scans, pretrained, tmp_path):
    """``tools/train_torch.py`` on the nuScenes semseg config with the
    pretrain's checkpoint as ``weight``: the checkpoint's ``backbone.*``
    load (and nothing else; the head ``backbone.final.*`` stays the
    seeded one), one step, one evaluation; then ``tools/test_torch.py``
    serves the val scan with the fine-tuned weights (one rotation, every
    point of the filtered scan voted); point budgets cut to 65,536 rows."""
    from test_torch import main_worker as test_worker

    root = scans[0]
    opts = {"data.val.data_root": root, "data.test.data_root": root,
            "point_budget": 65_536, "point_budget_val": 65_536}
    trainer = _train(SEMSEG, root, str(tmp_path / "ft"), opts, weight=pretrained[1])
    report = trainer.comm_info["weight_load"]
    ckpt = torch.load(pretrained[1], map_location="cpu", weights_only=True)["state_dict"]
    assert report["loaded"] == sorted(k for k in ckpt if k.startswith("backbone."))
    assert report["missing"] == ["backbone.final.bias", "backbone.final.weight"]
    assert {k.split(".")[0] for k in report["skipped"]} == {"mtoken", "proj_net", "renderer"}
    assert trainer.step == 1 and bool(trainer.comm_info["metrics"]["contract_ok"])
    assert "val/mIoU" in trainer.storage.histories()

    cfg = default_config_parser(SEMSEG, {
        **SMALL, "data.test.data_root": root, "point_budget": 65_536,
        "save_path": str(tmp_path / "test"),
        "device": "cpu", "weight": os.path.join(str(tmp_path / "ft"), "model",
                                                "model_last.pth")})
    tester = test_worker(cfg)
    assert tester.fragment_seconds and all(tester.contract_ok)
    pred = np.load(os.path.join(str(tmp_path / "test"), "result", "val_0000_pred.npy"))
    raw = tnus.NuScenesDataset(split="val", data_root=root).get_data(0)
    keep = ttr.TRANSFORMS.build(dict(type="PointRangeFilter", point_cloud_range=RANGE,
                                     padding=0.1))(dict(raw))
    assert pred.shape == (len(keep["coord"]),) and pred.min() >= 0 and pred.max() < 16
