"""Core hooks: timing, logging, checkpointing.

Counterpart of ``ponderv2_tpu/engines/hooks/misc.py`` (``IterationTimer``,
``InformationWriter``, ``CheckpointSaver``, ``CheckpointLoader``).
Checkpoints hold the model's ``state_dict`` (reference PyTorch names), the
optimizer's and the step count, written atomically with ``torch.save``.
"""

from __future__ import annotations

import os
import shutil
import time
from typing import Optional

import numpy as np
import torch

from ...utils import comm
from ...utils.timer import Timer
from .builder import HOOKS
from .default import HookBase


@HOOKS.register_module()
class IterationTimer(HookBase):
    """Tracks data/batch time and ETA."""

    def __init__(self, warmup_iter: int = 2):
        self._warmup_iter = warmup_iter
        self._start_time = time.perf_counter()
        self._iter_timer = Timer()
        self._remain_iter = 0

    def before_train(self):
        self._start_time = time.perf_counter()
        self._remain_iter = self.trainer.max_epoch * len(self.trainer.train_loader)

    def before_epoch(self):
        self._iter_timer.reset()

    def before_step(self):
        data_time = self._iter_timer.seconds()
        self.trainer.storage.put_scalar("data_time", data_time)

    def after_step(self):
        # force device sync so batch_time is honest
        self.trainer.sync_metrics()
        batch_time = self._iter_timer.seconds()
        self._iter_timer.reset()
        self.trainer.storage.put_scalar("batch_time", batch_time)
        self._remain_iter -= 1
        remain_time = self._remain_iter * self.trainer.storage.history(
            "batch_time"
        ).avg(20)
        t_m, t_s = divmod(remain_time, 60)
        t_h, t_m = divmod(t_m, 60)
        self.trainer.comm_info["eta"] = f"{int(t_h):02d}:{int(t_m):02d}:{int(t_s):02d}"


@HOOKS.register_module()
class InformationWriter(HookBase):
    """Console line per iter + scalar logging."""

    def __init__(self, log_interval: int = 1):
        self.log_interval = log_interval
        self.curr_iter = 0

    def before_train(self):
        self.trainer.comm_info["iter_info"] = ""
        self.curr_iter = self.trainer.start_epoch * len(self.trainer.train_loader)

    def after_step(self):
        self.curr_iter += 1
        metrics = self.trainer.sync_metrics()
        for k, v in metrics.items():
            smooth = k != "lr"
            self.trainer.storage.put_scalar(k, v, smoothing_hint=smooth)
        if self.curr_iter % self.log_interval != 0:
            return
        storage = self.trainer.storage
        info = (
            f"Train: [{self.trainer.epoch + 1}/{self.trainer.max_epoch}]"
            f"[{self.trainer.comm_info.get('iter', 0) + 1}/{len(self.trainer.train_loader)}] "
        )
        try:
            info += (
                f"data {storage.history('data_time').avg(10):.3f} "
                f"batch {storage.history('batch_time').avg(10):.3f} "
            )
        except KeyError:
            pass
        for k in metrics:
            info += f"{k}: {storage.history(k).latest():.4g} "
        eta = self.trainer.comm_info.get("eta")
        if eta:
            info += f"eta: {eta}"
        self.trainer.logger.info(info)
        storage.step()


def save_checkpoint(trainer, path: str, extra: Optional[dict] = None) -> None:
    """Atomic checkpoint: the model's and the optimizer's state_dicts, the
    step count and ``extra`` metadata."""
    payload = {
        "state_dict": trainer.model.state_dict(),
        "optimizer": trainer.optimizer.state_dict(),
        "step": trainer.step,
        "extra": extra or {},
    }
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> dict:
    return torch.load(path, map_location="cpu", weights_only=True)


@HOOKS.register_module()
class CheckpointSaver(HookBase):
    """Saves model_last.pth each epoch; copies to model_best.pth on metric
    improvement."""

    def __init__(self, save_freq: Optional[int] = None):
        self.save_freq = save_freq

    def after_epoch(self):
        if not comm.is_main_process():
            return
        trainer = self.trainer
        save_path = trainer.cfg.get("save_path")
        if not save_path:
            return
        os.makedirs(os.path.join(save_path, "model"), exist_ok=True)
        is_best = False
        current = trainer.comm_info.get("current_metric_value")
        if current is not None and current > trainer.best_metric_value:
            trainer.best_metric_value = current
            is_best = True
        filename = os.path.join(save_path, "model", "model_last.pth")
        extra = dict(
            epoch=trainer.epoch + 1,
            best_metric_value=trainer.best_metric_value,
        )
        save_checkpoint(trainer, filename, extra)
        trainer.logger.info(
            f"Saved checkpoint to {filename} "
            f"(best {trainer.cfg.get('evaluate_metric', 'metric')}: "
            f"{trainer.best_metric_value:.4f})"
        )
        if is_best:
            shutil.copyfile(
                filename, os.path.join(save_path, "model", "model_best.pth")
            )
            trainer.logger.info("Best validation model updated.")
        if self.save_freq and (trainer.epoch + 1) % self.save_freq == 0:
            shutil.copyfile(
                filename,
                os.path.join(save_path, "model", f"epoch_{trainer.epoch + 1}.pth"),
            )


@HOOKS.register_module()
class CheckpointLoader(HookBase):
    """Loads weights / resumes state before training. ``weight`` may also be
    a bare ``state_dict`` (e.g. one converted from a JAX checkpoint)."""

    def __init__(self, keywords: str = "", replacement: Optional[str] = None,
                 strict: bool = False):
        self.keywords = keywords
        self.replacement = replacement if replacement is not None else keywords
        self.strict = strict

    def before_train(self):
        trainer = self.trainer
        weight = trainer.cfg.get("weight")
        resume = trainer.cfg.get("resume", False)
        if not weight:
            return
        if not os.path.isfile(weight):
            raise FileNotFoundError(f"checkpoint not found: {weight}")
        trainer.logger.info(f"Loading weight at: {weight}")
        payload = load_checkpoint(weight)
        state = payload.get("state_dict", payload)
        trainer.model.load_state_dict(state)
        if resume:
            trainer.optimizer.load_state_dict(payload["optimizer"])
            trainer.step = int(payload["step"])
            extra = payload.get("extra", {})
            trainer.start_epoch = int(extra.get("epoch", 0))
            trainer.best_metric_value = float(extra.get("best_metric_value", -np.inf))
            trainer.logger.info(
                f"Resuming train at epoch {trainer.start_epoch + 1}"
            )
        else:
            trainer.logger.info("Loaded model weights (optimizer state fresh).")
