"""Core hooks: timing, logging, checkpointing, profiling, the precise test.

Counterpart of ``ponderv2_tpu/engines/hooks/misc.py`` (``IterationTimer``,
``InformationWriter``, ``CheckpointSaver``, ``CheckpointLoader``,
``RuntimeProfiler``, ``PreciseEvaluator``). Checkpoints hold the model's
``state_dict`` (reference PyTorch names), the optimizer's and the step
count, written atomically with ``torch.save``. ``DataCacheOperator``
fills the run's scene cache before training (the trainer unlinks it after).
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


def load_matching_weights(model: torch.nn.Module, state: dict, keywords: str = "",
                          replacement: str = "", strict: bool = False) -> dict:
    """Load the entries of ``state`` (names with ``keywords`` replaced by
    ``replacement``) that the model has, as the reference's non-strict
    weight load does: a pretrain checkpoint gives a segmentor its
    ``backbone.*`` and nothing else. An entry the model has in another
    shape raises, as ``torch.nn.Module.load_state_dict(strict=False)``
    does. Returns the names ``loaded``, the checkpoint's names ``skipped``
    (absent from the model) and the model's names ``missing`` from the
    checkpoint; with ``strict`` either of the last two raises."""
    own = model.state_dict()
    renamed = {(k.replace(keywords, replacement, 1) if keywords else k): v
               for k, v in state.items()}
    take = {k: v for k, v in renamed.items() if k in own}
    mismatched = [f"{k}: checkpoint {tuple(v.shape)}, model {tuple(own[k].shape)}"
                  for k, v in take.items() if own[k].shape != v.shape]
    if mismatched:
        raise RuntimeError(f"weight load: {len(mismatched)} entries of another shape than "
                           f"the model's: {mismatched[:5]}")
    report = dict(loaded=sorted(take), skipped=sorted(set(renamed) - set(take)),
                  missing=sorted(set(own) - set(take)))
    if strict and (report["skipped"] or report["missing"]):
        raise KeyError(f"strict weight load: {len(report['skipped'])} checkpoint entries "
                       f"skipped ({report['skipped'][:5]}), {len(report['missing'])} model "
                       f"entries missing ({report['missing'][:5]})")
    model.load_state_dict(take, strict=False)
    return report


@HOOKS.register_module()
class CheckpointLoader(HookBase):
    """Loads weights / resumes state before training. ``weight`` may also be
    a bare ``state_dict`` (e.g. one converted from a JAX checkpoint). A
    resume loads everything; a weight load takes the entries the model
    names and raises on one of another shape (``load_matching_weights``),
    logs what it loaded and skipped, and leaves the report in
    ``trainer.comm_info["weight_load"]``."""

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
        if resume:
            trainer.model.load_state_dict(state)
            trainer.optimizer.load_state_dict(payload["optimizer"])
            trainer.step = int(payload["step"])
            extra = payload.get("extra", {})
            trainer.start_epoch = int(extra.get("epoch", 0))
            trainer.best_metric_value = float(extra.get("best_metric_value", -np.inf))
            trainer.logger.info(
                f"Resuming train at epoch {trainer.start_epoch + 1}"
            )
        else:
            report = load_matching_weights(trainer.model, state, self.keywords,
                                           self.replacement, self.strict)
            trainer.comm_info["weight_load"] = report
            trainer.logger.info(
                f"Loaded model weights (optimizer state fresh): {len(report['loaded'])} "
                f"entries; skipped {len(report['skipped'])} of the checkpoint "
                f"{report['skipped']}; {len(report['missing'])} of the model's not in it "
                f"{report['missing']}")


@HOOKS.register_module()
class DataCacheOperator(HookBase):
    """Pre-populates the shared-memory scene cache (reference misc.py:283-314):
    before training, reads every scene of the train set once (into the
    run's cache where the dataset has ``cache=True``), then synchronizes."""

    def __init__(self, data_root: str, split: str):
        self.data_root = data_root
        self.split = split

    def before_train(self):
        self.trainer.logger.info("=> Caching dataset ...")
        dataset = getattr(self.trainer.train_loader, "dataset", None)
        inner = getattr(dataset, "dataset", dataset)
        if inner is None or not hasattr(inner, "get_data"):
            return
        for i in range(len(inner.data_list)):
            inner.get_data(i)
        comm.synchronize()


@HOOKS.register_module()
class RuntimeProfiler(HookBase):
    """Before training: ``warm_up`` train steps, then ``record`` more under
    ``torch.profiler`` (host ops, and the card's kernels on CUDA), written
    as a Chrome trace ``{trace_dir}/trace.json`` (default
    ``{save_path}/trace``); with ``exit_after`` the run then ends with
    ``SystemExit(0)``, as the JAX hook's does."""

    def __init__(self, trace_dir: Optional[str] = None, warm_up: int = 2,
                 record: int = 3, exit_after: bool = True):
        self.trace_dir = trace_dir
        self.warm_up = warm_up
        self.record = record
        self.exit_after = exit_after
        self.trace_path: Optional[str] = None

    def _steps(self, n: int, batches) -> None:
        trainer = self.trainer
        for _ in range(n):
            trainer.comm_info["input_dict"] = next(batches)
            trainer.run_step()
            trainer.sync_metrics()

    def before_train(self):
        from torch.profiler import ProfilerActivity, profile

        trainer = self.trainer
        trace_dir = self.trace_dir or os.path.join(trainer.cfg.get("save_path", "."),
                                                   "trace")
        os.makedirs(trace_dir, exist_ok=True)
        trainer.logger.info(f"Profiling {self.record} steps -> {trace_dir}")

        def batches():
            while True:
                yield from trainer.train_loader

        it = batches()
        self._steps(self.warm_up, it)
        activities = [ProfilerActivity.CPU]
        if trainer.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize(trainer.device)
        with profile(activities=activities) as prof:
            self._steps(self.record, it)
            if trainer.device.type == "cuda":
                torch.cuda.synchronize(trainer.device)
        self.trace_path = os.path.join(trace_dir, "trace.json")
        prof.export_chrome_trace(self.trace_path)
        trainer.logger.info(f"Profiling done: {self.trace_path}")
        if self.exit_after:
            raise SystemExit(0)


@HOOKS.register_module()
class PreciseEvaluator(HookBase):
    """After training, the configured tester (``cfg.test``, SemSegTester by
    default) over the test set with ``model_best.pth``, else (or with
    ``test_last``) ``model_last.pth``, which ``cfg.weight`` then names; its
    metrics go to
    ``trainer.comm_info["precise_metrics"]``."""

    def __init__(self, test_last: bool = False):
        self.test_last = test_last

    def after_train(self):
        from ..test import TESTERS

        trainer = self.trainer
        trainer.logger.info(">>>>>>>>>>>>>>>> Start Precise Evaluation >>>>>>>>>>>>>>>>")
        cfg = trainer.cfg
        tester_cfg = dict(cfg.get("test", {"type": "SemSegTester"}))
        which = "model_last.pth" if self.test_last else "model_best.pth"
        weight = os.path.join(cfg.save_path, "model", which)
        if not os.path.isfile(weight):
            weight = os.path.join(cfg.save_path, "model", "model_last.pth")
        cfg.weight = weight
        tester = TESTERS.build(dict(type=tester_cfg.get("type", "SemSegTester"), cfg=cfg))
        trainer.comm_info["precise_metrics"] = tester.test()
        trainer.comm_info["precise_tester"] = tester
