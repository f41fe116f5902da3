"""Masked batch norm for padded sparse tensors.

Counterpart of ``ponderv2_tpu/models/norm.py:MaskedBatchNorm``: statistics
over valid rows only, padding rows zeroed on output. ``momentum`` follows
the torch convention (running = (1 - m) * running + m * batch) and the
running variance is the unbiased one, as torch tracks it. Parameter and
buffer names are torch ``BatchNorm1d``'s (``weight``, ``bias``,
``running_mean``, ``running_var``) so reference checkpoints load as they are.
"""

from __future__ import annotations

import torch
from torch import nn


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

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """x: (N, C); mask: (N,) bool. Returns normalized (N, C), padding zeroed."""
        if self.training:
            m = mask.to(x.dtype)[:, None]
            s1 = (x * m).sum(0)
            s2 = (x * x * m).sum(0)
            count = m.sum().clamp(min=1.0)
            mean = s1 / count
            var = (s2 / count - mean * mean).clamp(min=0.0)
            with torch.no_grad():
                unbiased = var * count / (count - 1.0).clamp(min=1.0)
                self.running_mean.mul_(1.0 - self.momentum).add_(self.momentum * mean)
                self.running_var.mul_(1.0 - self.momentum).add_(self.momentum * unbiased)
        else:
            mean, var = self.running_mean, self.running_var
        y = (x - mean) * torch.reciprocal(torch.sqrt(var + self.eps))
        y = y * self.weight + self.bias
        return torch.where(mask[:, None], y, torch.zeros((), dtype=y.dtype,
                                                          device=y.device))
