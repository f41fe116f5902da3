"""LOSSES registry + summing Criteria container.

Counterpart of ``ponderv2_tpu/models/losses/builder.py``."""

from __future__ import annotations

from ...utils.registry import Registry

LOSSES = Registry("losses")


class Criteria:
    """Sums a list of configured losses: ``criteria(pred, target, mask)``."""

    def __init__(self, cfg=None):
        self.cfg = cfg if cfg is not None else []
        self.criteria = [LOSSES.build(c) for c in self.cfg]

    def __call__(self, pred, target, mask=None):
        if len(self.criteria) == 0:
            return pred
        loss = 0.0
        for c in self.criteria:
            loss = loss + c(pred, target, mask)
        return loss


def build_criteria(cfg) -> Criteria:
    return Criteria(cfg)
