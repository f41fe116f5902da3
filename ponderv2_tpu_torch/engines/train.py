"""Trainer: hook-instrumented epoch loop around one eager train step.

Counterpart of ``ponderv2_tpu/engines/train.py`` (``TrainerBase``,
``Trainer``) on one device. The JAX package jits the whole step as a pure
function of its TrainState; here the state is the model (parameters and BN
running stats), the ``torch.optim`` optimizer and the step count, and
``run_step`` is: batch to the device, forward, ``loss.backward()``,
``optimizer.step()`` at ``schedule(step)``, ``zero_grad``. Conv plans are
built on the device inside the step; a config's ``host_plans`` key is
accepted and has no effect. Not ported yet: the data-parallel mesh branch,
the host plan prefetch (``engines/plan_prefetch.py``) and
``MultiDatasetTrainer``.
"""

from __future__ import annotations

import weakref
from typing import Any, Dict, Optional

import torch

from ..datasets import build_dataloader, build_dataset
from ..models import build_model
from ..utils.config import Config
from ..utils.events import EventStorage
from ..utils.logger import get_root_logger
from ..utils.optimizer import build_optimizer, set_lr
from ..utils.registry import Registry
from ..utils.scheduler import build_scheduler
from .common import resolve_device, split_batch

TRAINERS = Registry("trainers")


class TrainerBase:
    def __init__(self):
        self.hooks = []
        self.epoch = 0
        self.start_epoch = 0
        self.max_epoch = 0
        self.comm_info: Dict[str, Any] = {}
        self.storage: Optional[EventStorage] = None

    def register_hooks(self, hooks_cfg) -> None:
        from .hooks.builder import build_hooks

        hooks = build_hooks(hooks_cfg)
        for h in hooks:
            h.trainer = weakref.proxy(self)
        self.hooks = hooks

    def before_train(self):
        for h in self.hooks:
            h.before_train()

    def before_epoch(self):
        for h in self.hooks:
            h.before_epoch()

    def before_step(self):
        for h in self.hooks:
            h.before_step()

    def after_step(self):
        for h in self.hooks:
            h.after_step()

    def after_epoch(self):
        for h in self.hooks:
            h.after_epoch()

    def after_train(self):
        for h in self.hooks:
            h.after_train()

    def train(self):
        with EventStorage(self.start_epoch * len(self.train_loader)) as self.storage:
            self.before_train()
            self.logger.info(">>>>>>>>>>>>>>>> Start Training >>>>>>>>>>>>>>>>")
            for self.epoch in range(self.start_epoch, self.max_epoch):
                self.before_epoch()
                for i, input_dict in enumerate(self.train_loader):
                    self.comm_info["iter"] = i
                    self.comm_info["input_dict"] = input_dict
                    self.before_step()
                    self.run_step()
                    self.after_step()
                self.after_epoch()
            self.after_train()
            self.logger.info("<<<<<<<<<<<<<<<<< End Training <<<<<<<<<<<<<<<<<")


@TRAINERS.register_module("Trainer")
class Trainer(TrainerBase):
    """Runs on ``cfg.device``, else on CUDA (raising without it). Parameters are
    initialized from ``cfg.seed`` (``reset_parameters``); a ``weight``
    checkpoint replaces them through the ``CheckpointLoader`` hook."""

    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(cfg)
        self.max_epoch = cfg.eval_epoch  # loop-rebased epochs (engines/defaults.py)
        self.best_metric_value = -float("inf")
        self.logger = get_root_logger(
            log_file=f"{cfg.save_path}/train.log" if cfg.get("save_path") else None
        )
        self.logger.info(f"Save path: {cfg.get('save_path')}")
        self.logger.info(f"Config:\n{cfg.pretty_text}")

        self.logger.info("=> Building model ...")
        self.model = build_model(dict(cfg.model))
        self.model.reset_parameters(torch.Generator().manual_seed(int(cfg.get("seed") or 0)))
        self.model.to(self.device)
        n_params = sum(p.numel() for p in self.model.parameters())
        self.logger.info(f"Num params: {n_params}")
        self.logger.info("=> Building train dataset & loader ...")
        self.train_loader = self.build_train_loader()
        self.val_loader = self.build_val_loader()

        total_steps = len(self.train_loader) * self.max_epoch
        self.logger.info(f"=> Total steps: {total_steps}")
        self.schedule = build_scheduler(dict(cfg.scheduler), total_steps)
        self.optimizer = build_optimizer(dict(cfg.optimizer), self.model)
        self.step = 0  # optimizer updates taken; update k runs at schedule(k)
        self.static_ctx = self.build_static_ctx()
        self.register_hooks(cfg.get("hooks", []))

    # ------------------------------------------------------------------ build
    def build_static_ctx(self) -> Dict[str, Any]:
        ctx = dict(
            spatial_shape=tuple(self.cfg.get("sparse_shape", (1024, 1024, 1024))),
            batch_size=int(self.cfg.batch_size),
        )
        ctx.update(self.cfg.get("static_ctx", {}))
        return ctx

    @property
    def val_static_ctx(self) -> Dict[str, Any]:
        """The val loader collates ``batch_size_val`` scenes per batch."""
        ctx = dict(self.static_ctx)
        ctx["batch_size"] = int(self.cfg.get("batch_size_val", 1))
        ctx.update(self.cfg.get("static_ctx_val", {}))
        return ctx

    def build_train_loader(self):
        cfg = self.cfg
        dataset = build_dataset(dict(cfg.data.train))
        return build_dataloader(
            dataset,
            batch_size=cfg.batch_size,
            num_workers=cfg.get("num_worker", 0),
            shuffle=True,
            drop_last=True,
            point_budget=cfg.get("point_budget"),
            scene_budget=cfg.batch_size,
            mix_prob=cfg.get("mix_prob", 0.0),
            seed=cfg.get("seed", 0),
        )

    def build_val_loader(self):
        cfg = self.cfg
        if not cfg.get("evaluate", True) or "val" not in cfg.data:
            return None
        dataset = build_dataset(dict(cfg.data.val))
        return build_dataloader(
            dataset,
            batch_size=cfg.get("batch_size_val", 1),
            num_workers=cfg.get("num_worker", 0),
            shuffle=False,
            drop_last=False,
            point_budget=cfg.get("point_budget_val", cfg.get("point_budget")),
            scene_budget=cfg.get("batch_size_val", 1),
            seed=cfg.get("seed", 0),
        )

    # ------------------------------------------------------------------- step
    def _to_device(self, input_dict) -> Dict[str, torch.Tensor]:
        arrays, _ = split_batch(input_dict)
        return {k: torch.as_tensor(v).to(self.device, non_blocking=True)
                for k, v in arrays.items()}

    def step_generator(self) -> torch.Generator:
        """The generator of this step's random draws (ray picks, sampler
        jitter, mask salt), seeded from ``cfg.seed`` and the step, as the JAX
        step folds the step into its key. Models without draws ignore it."""
        seed = (int(self.cfg.get("seed") or 0) << 32) | self.step
        return torch.Generator(device=self.device).manual_seed(seed)

    def run_step(self):
        inputs = self._to_device(self.comm_info["input_dict"])
        lr = float(self.schedule(self.step))
        set_lr(self.optimizer, lr)
        self.model.train()
        out = self.model({**inputs, **self.static_ctx,
                          "generator": self.step_generator()})
        out["loss"].backward()
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        self.step += 1
        metrics = {"loss": out["loss"].detach(), "lr": lr,
                   "contract_ok": out["contract_ok"]}
        for k in self.cfg.get("metric_keys", ()):
            if k in out:
                metrics[k] = out[k].detach()
        self.comm_info["metrics"] = metrics

    def eval_step(self, input_dict) -> Dict[str, torch.Tensor]:
        """Eval-mode forward of one val batch (BN on its running stats).
        ``no_grad`` and not ``inference_mode``: a render field takes the
        sdf's spatial gradient at eval too."""
        inputs = self._to_device(input_dict)
        self.model.eval()
        with torch.no_grad():
            return self.model({**inputs, **self.val_static_ctx})

    def sync_metrics(self) -> Dict[str, float]:
        """Device->host fetch of the last step's metrics (blocks)."""
        metrics = {
            k: float(v) for k, v in self.comm_info.get("metrics", {}).items()
        }
        if metrics.get("contract_ok", 1.0) < 0.5:
            raise RuntimeError(
                "sparse-conv kernel contract violated this step "
                "(rows not key-sorted or band window overflow): conv outputs "
                "were zero-poisoned by design. Check that the collate path "
                "sorts rows when the model sets assume_sorted=True, or raise "
                "the band plan budgets. Refusing to continue training."
            )
        return metrics
