"""PyTorch port on the CPU: ``tools/train_torch.py`` on the nuScenes
pretrain configs ``-base-color``, ``-base-color-amp`` and
``-base-semantic``, one step each at ``test_torch_nuscenes.py``'s widths on
its writer's scans (``test_torch_nuscenes_train.py`` runs ``-base``)."""

import pytest

from test_torch_nuscenes import PRETRAIN, SMALL_RENDER, scans  # noqa: F401
from test_torch_nuscenes_train import _train, check_outdoor_pretrain
from torch_threads import _torch_threads  # noqa: F401  (autouse fixture)


@pytest.mark.parametrize("name", ["base-color", "base-color-amp", "base-semantic"])
def test_train_torch_outdoor_pretrain_on_cpu(scans, tmp_path, name):
    """``tools/train_torch.py`` on each nuScenes pretrain config (test
    widths, batch 2 of the writer's scans, cameras 96 x 160): one step,
    every metric key of the config in the log's metrics and finite, the
    block mask's token trained, and the checkpoint written."""
    save = str(tmp_path)
    opts = dict(SMALL_RENDER)
    if name == "base-semantic":
        opts["model.renderer.field.semantic_dim"] = 512
    trainer = _train(PRETRAIN[name], scans[0], save, opts)
    check_outdoor_pretrain(trainer, save)
