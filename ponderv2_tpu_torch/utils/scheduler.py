"""Learning-rate schedules as plain ``step -> lr`` callables.

Counterpart of ``ponderv2_tpu/utils/scheduler.py``, with the same formulas
(e.g. OneCycle's ``int(pct_start * total_steps) - 1`` warm-up steps, not
``torch.optim.lr_scheduler.OneCycleLR``'s). The k-th optimizer update
(0-based) uses ``schedule(k)``, as optax does. All are rebased on
``total_steps``, which the trainer injects.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

from .registry import Registry

SCHEDULERS = Registry("schedulers")

Schedule = Callable[[int], float]


@SCHEDULERS.register_module(name="MultiStepLR")
def multi_step_lr(
    total_steps: int,
    base_lr: float,
    milestones: Sequence[float],
    gamma: float = 0.1,
) -> Schedule:
    """Step decay at epoch-fraction milestones (fractions of total_steps)."""
    boundaries = [int(m * total_steps) for m in milestones]

    def schedule(step):
        return base_lr * gamma ** sum(1 for b in boundaries if step >= b)

    return schedule


@SCHEDULERS.register_module(name="MultiStepWithWarmupLR")
def multi_step_warmup_lr(
    total_steps: int,
    base_lr: float,
    milestones: Sequence[float],
    gamma: float = 0.1,
    warmup_rate: float = 0.05,
    warmup_scale: float = 1e-6,
) -> Schedule:
    warmup_steps = max(int(warmup_rate * total_steps), 1)
    base = multi_step_lr(total_steps, base_lr, milestones, gamma)

    def schedule(step):
        if step >= warmup_steps:
            return base(step)
        alpha = min(max(step / warmup_steps, 0.0), 1.0)
        return base(step) * (warmup_scale + (1.0 - warmup_scale) * alpha)

    return schedule


@SCHEDULERS.register_module(name="PolyLR")
def poly_lr(total_steps: int, base_lr: float, power: float = 0.9) -> Schedule:
    def schedule(step):
        frac = min(max(step / max(total_steps, 1), 0.0), 1.0)
        return base_lr * (1.0 - frac) ** power

    return schedule


@SCHEDULERS.register_module(name="ExpLR")
def exp_lr(total_steps: int, base_lr: float, gamma: float = 0.95) -> Schedule:
    def schedule(step):
        return base_lr * gamma ** (step / max(total_steps, 1))

    return schedule


@SCHEDULERS.register_module(name="CosineAnnealingLR")
def cosine_annealing_lr(
    total_steps: int, base_lr: float, eta_min: float = 0.0
) -> Schedule:
    def schedule(step):
        frac = min(max(step / max(total_steps, 1), 0.0), 1.0)
        return eta_min + 0.5 * (base_lr - eta_min) * (1.0 + math.cos(math.pi * frac))

    return schedule


@SCHEDULERS.register_module(name="OneCycleLR")
def one_cycle_lr(
    total_steps: int,
    max_lr,
    pct_start: float = 0.3,
    anneal_strategy: str = "cos",
    div_factor: float = 25.0,
    final_div_factor: float = 1e4,
) -> Schedule:
    """Two-phase one-cycle schedule (warmup to max_lr, anneal to
    max_lr/(div*final)). ``max_lr`` may be a list (per param group); the
    first entry drives the schedule and groups scale it by their lr ratio."""
    if isinstance(max_lr, (list, tuple)):
        max_lr = float(max_lr[0])
    initial_lr = max_lr / div_factor
    min_lr = initial_lr / final_div_factor
    up_steps = max(int(pct_start * total_steps) - 1, 1)
    down_steps = max(total_steps - up_steps - 1, 1)

    def _anneal(lo, hi, frac):
        if anneal_strategy == "cos":
            return hi + (lo - hi) * 0.5 * (1.0 - math.cos(math.pi * frac))
        return hi + (lo - hi) * frac  # linear

    def schedule(step):
        if step <= up_steps:
            return _anneal(max_lr, initial_lr, min(max(step / up_steps, 0.0), 1.0))
        frac = min(max((step - up_steps) / down_steps, 0.0), 1.0)
        return _anneal(min_lr, max_lr, frac)

    return schedule


def build_scheduler(cfg: dict, total_steps: int) -> Schedule:
    """Build a schedule fn from a config dict, injecting total_steps."""
    cfg = dict(cfg)
    cfg.setdefault("total_steps", total_steps)
    return SCHEDULERS.build(cfg)
