"""Optimizer builders on ``torch.optim``.

Counterpart of ``ponderv2_tpu/utils/optimizer.py`` (optax). SGD, Adam and
AdamW with per-parameter-group learning-rate multipliers by keyword match on
the parameter name (the reference's ``param_dicts``; the port's parameter
names are the reference PyTorch ones). Each group carries ``lr_ratio``
(group lr / base lr); ``set_lr`` applies one shared schedule value to every
group, as the JAX package scales ``schedule(step)`` per group.

The optax chains and ``torch.optim`` compute the same update:
``add_decayed_weights(wd) + sgd(momentum, nesterov)`` is ``SGD(weight_decay,
momentum, nesterov)`` (the trace starts at zero, as torch's first buffer is
the gradient itself); ``add_decayed_weights + adam`` is ``Adam(weight_decay)``;
``adamw`` is ``AdamW``.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from .registry import Registry

OPTIMIZERS = Registry("optimizers")


def _param_groups(model: torch.nn.Module, base_lr: float,
                  param_dicts: Optional[Sequence[Dict]]):
    """Each parameter goes to the first group whose keyword its name
    contains, else to the default group (first in the list)."""
    keywords = [d["keyword"] for d in (param_dicts or [])]
    groups = [dict(params=[], lr=base_lr, lr_ratio=1.0)] + [
        dict(params=[], lr=float(d.get("lr", base_lr)),
             lr_ratio=float(d.get("lr", base_lr)) / float(base_lr))
        for d in (param_dicts or [])]
    for name, p in model.named_parameters():
        if not p.requires_grad:
            continue
        hit = next((i + 1 for i, kw in enumerate(keywords) if kw in name), 0)
        groups[hit]["params"].append(p)
    return [g for g in groups if g["params"]]


@OPTIMIZERS.register_module(name="SGD")
def sgd(model, lr: float, momentum: float = 0.9, weight_decay: float = 0.0,
        nesterov: bool = False, dampening: float = 0.0,
        param_dicts: Optional[Sequence[Dict]] = None) -> torch.optim.Optimizer:
    del dampening  # accepted for config parity; optax's sgd has none
    return torch.optim.SGD(_param_groups(model, lr, param_dicts), lr=lr,
                           momentum=momentum, weight_decay=weight_decay,
                           nesterov=nesterov)


@OPTIMIZERS.register_module(name="Adam")
def adam(model, lr: float, betas=(0.9, 0.999), eps: float = 1e-8,
         weight_decay: float = 0.0,
         param_dicts: Optional[Sequence[Dict]] = None) -> torch.optim.Optimizer:
    return torch.optim.Adam(_param_groups(model, lr, param_dicts), lr=lr,
                            betas=tuple(betas), eps=eps, weight_decay=weight_decay)


@OPTIMIZERS.register_module(name="AdamW")
def adamw(model, lr: float, betas=(0.9, 0.999), eps: float = 1e-8,
          weight_decay: float = 0.01,
          param_dicts: Optional[Sequence[Dict]] = None) -> torch.optim.Optimizer:
    return torch.optim.AdamW(_param_groups(model, lr, param_dicts), lr=lr,
                             betas=tuple(betas), eps=eps, weight_decay=weight_decay)


def build_optimizer(cfg: Dict, model: torch.nn.Module) -> torch.optim.Optimizer:
    """Build a ``torch.optim`` optimizer over ``model``'s parameters from a
    config dict."""
    cfg = dict(cfg)
    cfg["model"] = model
    return OPTIMIZERS.build(cfg)


def fill_missing_grads(optimizer: torch.optim.Optimizer) -> None:
    """Give every parameter the backward did not reach a zero gradient.
    optax updates every leaf, so a parameter no path of this step touched
    (the norms of PDNorm's other conditions) still takes its weight decay
    and momentum there; ``torch.optim`` would skip it."""
    for group in optimizer.param_groups:
        for p in group["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Set every group's lr to ``lr`` times its ``lr_ratio``."""
    for group in optimizer.param_groups:
        group["lr"] = lr * group["lr_ratio"]
