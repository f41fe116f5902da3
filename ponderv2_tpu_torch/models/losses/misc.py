"""Classification/segmentation losses on padded logits.

Counterpart of ``ponderv2_tpu/models/losses/misc.py``. All losses take
``(pred (N, C) logits, target (N,) int labels, mask (N,) bool)``; rows
failing the mask or labelled ``ignore_index`` contribute zero and are
excluded from the normalizer.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from .builder import LOSSES


def _valid(target, mask, ignore_index):
    v = target != ignore_index
    if mask is not None:
        v = v & mask
    return v


@LOSSES.register_module()
class CrossEntropyLoss:
    def __init__(
        self,
        weight: Optional[Sequence[float]] = None,
        reduction: str = "mean",
        label_smoothing: float = 0.0,
        loss_weight: float = 1.0,
        ignore_index: int = -1,
    ):
        self.weight = None if weight is None else torch.tensor(weight, dtype=torch.float32)
        self.reduction = reduction
        self.label_smoothing = label_smoothing
        self.loss_weight = loss_weight
        self.ignore_index = ignore_index

    def __call__(self, pred, target, mask=None):
        num_classes = pred.shape[-1]
        valid = _valid(target, mask, self.ignore_index)
        t = target.clamp(0, num_classes - 1).long()
        logp = F.log_softmax(pred, dim=-1)
        if self.label_smoothing > 0:
            eps = self.label_smoothing
            onehot = F.one_hot(t, num_classes).to(logp.dtype) * (1.0 - eps) + eps / num_classes
            nll = -(onehot * logp).sum(-1)
        else:
            nll = -logp.gather(1, t[:, None])[:, 0]
        w = (torch.ones_like(nll) if self.weight is None
             else self.weight.to(nll.device)[t])
        w = torch.where(valid, w, torch.zeros((), dtype=w.dtype, device=w.device))
        if self.reduction == "sum":
            loss = (nll * w).sum()
        else:
            loss = (nll * w).sum() / w.sum().clamp(min=1e-12)
        return self.loss_weight * loss


@LOSSES.register_module()
class SmoothCELoss:
    """CE with smoothing expressed as (1-s)·CE + s·uniform (reference SmoothCELoss)."""

    def __init__(self, smoothing_ratio: float = 0.1, loss_weight: float = 1.0,
                 ignore_index: int = -1):
        self.inner = CrossEntropyLoss(
            label_smoothing=smoothing_ratio, loss_weight=loss_weight,
            ignore_index=ignore_index,
        )

    def __call__(self, pred, target, mask=None):
        return self.inner(pred, target, mask)


@LOSSES.register_module()
class FocalLoss:
    def __init__(self, gamma: float = 2.0, alpha: float = 0.5,
                 loss_weight: float = 1.0, ignore_index: int = -1):
        self.gamma, self.alpha = gamma, alpha
        self.loss_weight, self.ignore_index = loss_weight, ignore_index

    def __call__(self, pred, target, mask=None):
        num_classes = pred.shape[-1]
        valid = _valid(target, mask, self.ignore_index)
        t = target.clamp(0, num_classes - 1).long()
        logpt = F.log_softmax(pred, dim=-1).gather(1, t[:, None])[:, 0]
        pt = torch.exp(logpt)
        focal = -self.alpha * (1.0 - pt) ** self.gamma * logpt
        focal = torch.where(valid, focal, torch.zeros((), dtype=focal.dtype,
                                                      device=focal.device))
        return self.loss_weight * focal.sum() / valid.float().sum().clamp(min=1.0)


@LOSSES.register_module()
class BinaryFocalLoss:
    def __init__(self, gamma: float = 2.0, alpha: float = 0.5, logits: bool = True,
                 loss_weight: float = 1.0):
        self.gamma, self.alpha, self.logits = gamma, alpha, logits
        self.loss_weight = loss_weight

    def __call__(self, pred, target, mask=None):
        p = torch.sigmoid(pred) if self.logits else pred
        t = target.to(p.dtype)
        pt = torch.where(t > 0.5, p, 1.0 - p)
        alpha_t = torch.where(t > 0.5, self.alpha, 1.0 - self.alpha)
        loss = -alpha_t * (1.0 - pt) ** self.gamma * torch.log(pt.clamp(min=1e-12))
        if mask is not None:
            loss = torch.where(mask, loss, torch.zeros((), dtype=loss.dtype,
                                                       device=loss.device))
            n = mask.to(loss.dtype).sum().clamp(min=1.0)
        else:
            n = loss.numel()
        return self.loss_weight * loss.sum() / n


@LOSSES.register_module()
class DiceLoss:
    def __init__(self, smooth: float = 1.0, exponent: float = 2.0,
                 loss_weight: float = 1.0, ignore_index: int = -1):
        self.smooth, self.exponent = smooth, exponent
        self.loss_weight, self.ignore_index = loss_weight, ignore_index

    def __call__(self, pred, target, mask=None):
        num_classes = pred.shape[-1]
        valid = _valid(target, mask, self.ignore_index)
        probs = F.softmax(pred, dim=-1)
        probs = torch.where(valid[:, None], probs,
                            torch.zeros((), dtype=probs.dtype, device=probs.device))
        t = target.clamp(0, num_classes - 1).long()
        onehot = F.one_hot(t, num_classes).to(probs.dtype) * valid[:, None]
        num = 2.0 * (probs * onehot).sum(0) + self.smooth
        den = ((probs ** self.exponent).sum(0) + (onehot ** self.exponent).sum(0)
               + self.smooth)
        return self.loss_weight * (1.0 - num / den).mean()
