"""Masked batch norm for padded sparse tensors.

Counterpart of ``ponderv2_tpu/models/norm.py:MaskedBatchNorm``: statistics
over valid rows only, padding rows zeroed on output. ``momentum`` follows
the torch convention (running = (1 - m) * running + m * batch) and the
running variance is the unbiased one, as torch tracks it. Parameter and
buffer names are torch ``BatchNorm1d``'s (``weight``, ``bias``,
``running_mean``, ``running_var``) so reference checkpoints load as they are.

``PDBatchNorm`` is the counterpart of ``norm.py:PDBatchNorm``: the
Prompt-Driven BatchNorm of SpUNet-v1m3, one ``MaskedBatchNorm`` per condition
(``bns.{i}``) and an optional FiLM ``modulation`` from a context embedding.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import torch
from torch import nn

# > 0 while a forward runs again for the backward (activation checkpointing):
# the running statistics moved in the first run and must not move twice
_RECOMPUTING = [0]


@contextlib.contextmanager
def recomputing():
    """Within: every ``MaskedBatchNorm`` normalizes with its batch statistics
    but leaves its running statistics as they are."""
    _RECOMPUTING[0] += 1
    try:
        yield
    finally:
        _RECOMPUTING[0] -= 1


class MaskedBatchNorm(nn.Module):
    def __init__(self, num_features: int, eps: float = 1e-3,
                 momentum: float = 0.01):
        super().__init__()
        self.num_features = num_features
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def reset_parameters(self, generator=None) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def batch_stats(self, x: torch.Tensor, mask: torch.Tensor):
        """(mean, var) to normalize with: over the valid rows in training,
        where the running statistics move too, else the running ones."""
        if not self.training:
            return self.running_mean, self.running_var
        m = mask.to(x.dtype)[:, None]
        s1 = (x * m).sum(0)
        s2 = (x * x * m).sum(0)
        count = m.sum().clamp(min=1.0)
        mean = s1 / count
        var = (s2 / count - mean * mean).clamp(min=0.0)
        if _RECOMPUTING[0]:
            return mean, var
        with torch.no_grad():
            unbiased = var * count / (count - 1.0).clamp(min=1.0)
            self.running_mean.mul_(1.0 - self.momentum).add_(self.momentum * mean)
            self.running_var.mul_(1.0 - self.momentum).add_(self.momentum * unbiased)
        return mean, var

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """x: (N, C); mask: (N,) bool. Returns normalized (N, C), padding zeroed."""
        mean, var = self.batch_stats(x, mask)
        y = (x - mean) * torch.reciprocal(torch.sqrt(var + self.eps))
        y = y * self.weight + self.bias
        return torch.where(mask[:, None], y, torch.zeros((), dtype=y.dtype,
                                                          device=y.device))


class PDBatchNorm(nn.Module):
    """Prompt-Driven BatchNorm (reference ``spconv_unet_v1m3_pdnorm.py:23-72``).

    With ``decouple`` it holds ``bns``, one ``MaskedBatchNorm`` per condition,
    and the Python int ``condition_idx`` picks the one that runs (only its
    running statistics move); without, one ``bn``. With ``adaptive`` the
    normalized rows are modulated by ``modulation = (SiLU, Linear)`` of the
    context embedding, ``y * (1 + scale) + shift`` with ``shift, scale`` its
    two halves in that order, and the padding rows zeroed again. The
    modulation is folded into the BN's affine, ``(x - mean) * a + b`` with
    ``a = rstd * weight * (1 + scale)``: the same function, keeping one
    (N, C) tensor for the backward instead of three."""

    def __init__(self, num_features: int,
                 conditions: Sequence[str] = ("ScanNet", "S3DIS", "Structured3D"),
                 eps: float = 1e-3, momentum: float = 0.01, decouple: bool = True,
                 adaptive: bool = False, context_channels: int = 256):
        super().__init__()
        self.conditions = tuple(conditions)
        self.decouple = decouple
        self.adaptive = adaptive
        if decouple:
            self.bns = nn.ModuleList(
                MaskedBatchNorm(num_features, eps, momentum) for _ in self.conditions)
        else:
            self.bn = MaskedBatchNorm(num_features, eps, momentum)
        if adaptive:
            self.modulation = nn.Sequential(
                nn.SiLU(), nn.Linear(context_channels, 2 * num_features))

    def forward(self, x: torch.Tensor, mask: torch.Tensor, condition_idx: int = 0,
                context: Optional[torch.Tensor] = None) -> torch.Tensor:
        bn = self.bns[condition_idx] if self.decouple else self.bn
        if not self.adaptive:
            return bn(x, mask)
        if context is None:
            raise ValueError("adaptive PDBatchNorm needs a context embedding")
        shift, scale = self.modulation(context).chunk(2, dim=-1)
        mean, var = bn.batch_stats(x, mask)
        a = torch.reciprocal(torch.sqrt(var + bn.eps)) * bn.weight * (1.0 + scale)
        y = (x - mean) * a + (bn.bias * (1.0 + scale) + shift)
        return torch.where(mask[:, None], y, torch.zeros((), dtype=y.dtype,
                                                          device=y.device))
