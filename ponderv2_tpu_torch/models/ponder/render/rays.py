"""Ray/sample math for volume rendering, over a trailing sample axis.

Counterpart of ``ponderv2_tpu/models/ponder/render/rays.py``:
origins (..., R, 3), directions (..., R, 3), starts/ends (..., R, S).
"""

from __future__ import annotations

from typing import Tuple

import torch


def sample_positions(origins: torch.Tensor, directions: torch.Tensor,
                     starts: torch.Tensor, ends: torch.Tensor) -> torch.Tensor:
    """Frustum centers: o + d * (s+e)/2 -> (..., R, S, 3)."""
    mid = 0.5 * (starts + ends)
    return origins[..., None, :] + directions[..., None, :] * mid[..., None]


def get_weights_from_alphas(alphas: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Alpha compositing along the sample axis: (weights, transmittance),
    w_i = alpha_i * prod_{j<i} (1 - alpha_j)."""
    one_minus = torch.clamp(1.0 - alphas, 1e-7, 1.0)
    trans = torch.cumprod(one_minus, dim=-1)
    trans_shifted = torch.cat([torch.ones_like(trans[..., :1]), trans[..., :-1]], -1)
    return alphas * trans_shifted, trans_shifted


def safe_norm(x: torch.Tensor, dim: int = -1, keepdim: bool = False,
              eps: float = 1e-8) -> torch.Tensor:
    """Differentiable-at-zero vector norm: sqrt(sum x^2 + eps^2)."""
    return torch.sqrt((x * x).sum(dim, keepdim=keepdim) + eps * eps)


def safe_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-8) -> torch.Tensor:
    """Normalize with a smooth zero-safe denominator."""
    return x / safe_norm(x, dim=dim, keepdim=True, eps=eps)
