"""Training entry point of the PyTorch port (mirrors tools/train.py).

    python tools/train_torch.py --config-file configs/scannet/semseg-spunet-v1m1-0-base.py \
        --options save_path=exp/scannet-train

Runs on one GPU, or on the CPU with ``device=cpu``. Writes ``train.log``,
``config.py`` and ``model/model_last.pth`` (the model's ``state_dict``, the
optimizer's and the step) under ``save_path``.

Data parallel over two GPUs of one machine (one process each, NCCL; the
global ``batch_size`` split between them, ``engines/launch.py``), started
by torchrun or by the script itself:

    torchrun --nproc_per_node 2 tools/train_torch.py \
        --config-file configs/scannet/semseg-spunet-v1m1-0-base.py \
        --options save_path=exp/scannet-train
    python tools/train_torch.py --num-devices 2 --config-file ... --options ...

Two processes on one GPU need ``--backend gloo`` and ``device=cuda:0``;
on the CPU, ``device=cpu`` (gloo).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ponderv2_tpu_torch.engines.defaults import (  # noqa: E402
    default_argument_parser,
    default_config_parser,
    default_setup,
)
from ponderv2_tpu_torch.engines.launch import launch  # noqa: E402
from ponderv2_tpu_torch.engines.train import TRAINERS  # noqa: E402


def main_worker(cfg):
    """Build the configured trainer, train, and return it (its model,
    storage and step are read by chip_smoke.py)."""
    cfg = default_setup(cfg)
    trainer_cfg = dict(cfg.get("train", {"type": "Trainer"}))
    trainer_cfg.setdefault("type", "Trainer")
    trainer = TRAINERS.build(dict(type=trainer_cfg["type"], cfg=cfg))
    trainer.train()
    return trainer


def main():
    args = default_argument_parser().parse_args()
    cfg = default_config_parser(args.config_file, args.options)
    launch(main_worker, num_gpus_per_machine=args.num_devices or 1, backend=args.backend,
           cfg=(cfg,))


if __name__ == "__main__":
    main()
