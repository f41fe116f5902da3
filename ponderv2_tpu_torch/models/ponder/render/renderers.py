"""Output renderers: weighted compositing along rays.

Counterpart of ``ponderv2_tpu/models/ponder/render/renderers.py``.
"""

from __future__ import annotations

import torch

from .rays import safe_normalize


def render_rgb(weights: torch.Tensor, rgb: torch.Tensor) -> torch.Tensor:
    """(..., S), (..., S, 3) -> (..., 3)."""
    return (weights[..., None] * rgb).sum(-2)


def render_depth(weights: torch.Tensor, starts: torch.Tensor,
                 ends: torch.Tensor) -> torch.Tensor:
    """Expected termination depth, normalized by the accumulated weight."""
    mid = 0.5 * (starts + ends)
    acc = weights.sum(-1)
    depth = (weights * mid).sum(-1) / torch.clamp(acc, min=1e-8)
    return torch.clamp(depth, mid.amin(-1), mid.amax(-1))


def render_accumulation(weights: torch.Tensor) -> torch.Tensor:
    return weights.sum(-1)


def render_normal(weights: torch.Tensor, gradients: torch.Tensor) -> torch.Tensor:
    """Composite (unnormalized) sdf gradients into a per-ray normal."""
    return safe_normalize((weights[..., None] * gradients).sum(-2))


def render_semantic(weights: torch.Tensor, semantic: torch.Tensor) -> torch.Tensor:
    """(..., S), (..., S, D) -> (..., D)."""
    return (weights[..., None] * semantic).sum(-2)
