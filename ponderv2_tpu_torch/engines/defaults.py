"""CLI/default plumbing (counterpart of ``ponderv2_tpu/engines/defaults.py``)."""

from __future__ import annotations

import argparse
import os
from typing import Optional

from ..utils.config import Config, DictAction
from ..utils.env import set_seed


def default_argument_parser(epilog: Optional[str] = None) -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        epilog=epilog or "PonderV2 on PyTorch/CUDA", add_help=True)
    parser.add_argument("--config-file", default="", metavar="FILE",
                        help="path to config file")
    parser.add_argument("--options", nargs="+", action=DictAction,
                        help="custom options (k=v, dotted keys)")
    return parser


def default_config_parser(file_path: str, options: Optional[dict]) -> Config:
    if not os.path.isfile(file_path):
        raise FileNotFoundError(f"config not found: {file_path}")
    cfg = Config.fromfile(file_path)
    if options is not None:
        cfg.merge_from_dict(options)
    if cfg.get("seed", None) is None:
        cfg.seed = 0

    # epoch rebasing: run `eval_epoch` outer epochs of `loop`-repeated data
    # (reference defaults.py:125: data.train.loop = epoch // eval_epoch)
    cfg.setdefault("eval_epoch", cfg.get("epoch", 1))
    if "data" in cfg and "train" in cfg.data:
        cfg.data.train.loop = max(cfg.get("epoch", 1) // cfg.eval_epoch, 1)

    os.makedirs(os.path.join(cfg.save_path, "model"), exist_ok=True)
    if not cfg.get("resume", False):
        cfg.dump(os.path.join(cfg.save_path, "config.py"))
    return cfg


def default_setup(cfg: Config) -> Config:
    """Seed python, numpy and torch from ``cfg.seed`` (one process), with
    cuDNN deterministic (``utils/env.py:set_seed``)."""
    cfg.seed = set_seed(int(cfg.get("seed") or 0))
    return cfg
