"""Lovász-softmax loss (the Lovász extension of the Jaccard index [Berman
et al., CVPR 2018]).

Counterpart of ``ponderv2_tpu/models/losses/lovasz.py``. Errors are sorted
with ``torch.sort(-errors, stable=True)``, which gives the order of
``jnp.argsort(-errors)``, ties included.
"""

from __future__ import annotations

from typing import Optional

import torch

from .builder import LOSSES


def _lovasz_grad(gt_sorted: torch.Tensor) -> torch.Tensor:
    """Gradient of the Lovász extension w.r.t. sorted errors."""
    gts = gt_sorted.sum()
    intersection = gts - torch.cumsum(gt_sorted, 0)
    union = gts + torch.cumsum(1.0 - gt_sorted, 0)
    jaccard = 1.0 - intersection / union.clamp(min=1e-12)
    # difference trick: grad[0] = jaccard[0], grad[i] = jaccard[i] - jaccard[i-1]
    return torch.cat([jaccard[:1], jaccard[1:] - jaccard[:-1]])


def _lovasz_flat(errors: torch.Tensor, fg: torch.Tensor) -> torch.Tensor:
    order = torch.sort(-errors, stable=True).indices
    return torch.dot(errors[order], _lovasz_grad(fg[order]))


@LOSSES.register_module()
class LovaszLoss:
    """mode='multiclass' Lovász-softmax over valid rows; per-image=False
    (whole-batch flat, the reference's default for semseg)."""

    def __init__(
        self,
        mode: str = "multiclass",
        class_seen: Optional[list] = None,
        per_image: bool = False,
        loss_weight: float = 1.0,
        ignore_index: int = -1,
    ):
        assert mode in ("multiclass", "binary")
        self.mode = mode
        self.class_seen = class_seen
        self.per_image = per_image  # flat-batch only (per_image unused in ref configs)
        self.loss_weight = loss_weight
        self.ignore_index = ignore_index

    def __call__(self, pred, target, mask=None):
        valid = target != self.ignore_index
        if mask is not None:
            valid = valid & mask
        vf = valid.to(pred.dtype)

        if self.mode == "binary":
            p = torch.sigmoid(pred[:, 0] if pred.dim() > 1 else pred)
            fg = (target > 0).to(p.dtype) * vf
            errors = (fg - p).abs() * vf
            return self.loss_weight * _lovasz_flat(errors, fg)

        num_classes = pred.shape[-1]
        probs = torch.softmax(pred, dim=-1)
        t = target.clamp(0, num_classes - 1)
        losses, present = [], []
        classes = (
            range(num_classes) if self.class_seen is None else self.class_seen
        )
        for c in classes:
            fg = ((t == c) & valid).to(pred.dtype)
            errors = (fg - probs[:, c]).abs() * vf
            losses.append(_lovasz_flat(errors, fg))
            present.append((fg.sum() > 0).to(pred.dtype))
        losses = torch.stack(losses)
        present = torch.stack(present)
        mean = (losses * present).sum() / present.sum().clamp(min=1.0)
        return self.loss_weight * mean
