"""CLI/default plumbing (counterpart of ``ponderv2_tpu/engines/defaults.py``)."""

from __future__ import annotations

import argparse
import os
from typing import Optional

from ..utils import comm
from ..utils.config import Config, DictAction
from ..utils.env import set_seed


def default_argument_parser(epilog: Optional[str] = None) -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        epilog=epilog or "PonderV2 on PyTorch/CUDA", add_help=True)
    parser.add_argument("--config-file", default="", metavar="FILE",
                        help="path to config file")
    parser.add_argument("--num-devices", type=int, default=None,
                        help="processes to spawn on this machine, one a GPU (default: "
                             "one, or the torchrun / SLURM environment's ranks)")
    parser.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                        help="the process group's backend (default: nccl on GPUs, gloo "
                             "on the CPU; gloo for ranks that share one GPU)")
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
        cfg.seed = comm.shared_random_seed()

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
    """Seed python, numpy and torch with ``seed * world + rank``, as JAX
    seeds each process, with cuDNN deterministic (``utils/env.py:set_seed``),
    and set ``num_devices`` to the world size. ``cfg.seed`` stays the seed
    every rank shares: the train loader shuffles with it, so that rank d
    takes group d of one global batch; augmentation draws take the
    process's own seed. In a world of one both are ``cfg.seed``."""
    world, rank = comm.get_world_size(), comm.get_rank()
    # rank 0's: processes started apart (torchrun) each parsed, and drew, their own
    cfg.seed = int(comm.all_gather(cfg.get("seed") or 0)[0])
    set_seed(cfg.seed * world + rank)
    cfg.num_devices = world
    return cfg
