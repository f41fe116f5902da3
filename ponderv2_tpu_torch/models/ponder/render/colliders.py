"""Scene colliders: ray near/far bounds.

Counterpart of ``ponderv2_tpu/models/ponder/render/colliders.py``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ....utils.registry import Registry

COLLIDERS = Registry("colliders")


@COLLIDERS.register_module()
class AABBBoxCollider:
    """Slab-test intersection with an axis-aligned box; ``near_plane`` clamps
    the entry distance. The default box is the unit cube."""

    def __init__(self, near_plane: float = 0.05, bbox_min=(0.0, 0.0, 0.0),
                 bbox_max=(1.0, 1.0, 1.0)):
        self.near_plane = near_plane
        self.bbox_min = tuple(float(v) for v in bbox_min)
        self.bbox_max = tuple(float(v) for v in bbox_max)

    def __call__(self, origins: torch.Tensor, directions: torch.Tensor,
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """origins/directions (..., 3) -> (nears (...), fars (...))."""
        bmin = origins.new_tensor(self.bbox_min)
        bmax = origins.new_tensor(self.bbox_max)
        small = directions.abs() < 1e-10
        inv_d = 1.0 / torch.where(small, torch.sign(directions) * 1e-10 + 1e-10,
                                  directions)
        t0 = (bmin - origins) * inv_d
        t1 = (bmax - origins) * inv_d
        t_near = torch.minimum(t0, t1).amax(-1)
        t_far = torch.maximum(t0, t1).amin(-1)
        nears = torch.clamp(t_near, min=self.near_plane)
        fars = torch.maximum(t_far, nears + 1e-4)
        return nears, fars


@COLLIDERS.register_module()
class NearFarCollider:
    def __init__(self, near_plane: float = 0.05, far_plane: float = 2.0):
        self.near_plane = near_plane
        self.far_plane = far_plane

    def __call__(self, origins, directions):
        shape = origins.shape[:-1]
        return (origins.new_full(shape, self.near_plane),
                origins.new_full(shape, self.far_plane))
