"""Sparse conv modules over ops.spconv rulebooks.

Counterpart of ``ponderv2_tpu/models/sparse_unet/layers.py``. Weights keep
the reference spconv layout ``(kx, ky, kz, Cin, Cout)``; the tap order is
``itertools.product`` over (x, y, z), so ``weight.reshape(K^3, Cin, Cout)``
is the JAX package's ``kernel``.

``SubMConv`` mirrors the JAX routing exactly (``subm_route``):

- ``band-attached`` / ``band-inline``: the band conv (``ops.band_conv``),
  with the level's shared plan (a ``SubmPlan``'s or a ``BandedRulebook``'s),
  or with a plan built inline from a plain rulebook when ``cin > 64`` (with
  the attached plans' budget retry, which the JAX package's inline plans
  lack);
- ``slab``: where the JAX package takes its slab conv (a ``SubmPlan`` and
  ``cin <= 64``), the port computes that function with the plain gather conv,
  zeroed when the plan's ``sorted_ok`` is False as the slab conv is; never
  the windowed route, which the JAX slab conv does not take;
- ``windowed``: where the route would be ``plain`` and
  ``ops.spconv.use_windowed_gather`` holds (``PONDER_WINDOWED_GATHER`` set,
  at least 4096 rows, at most 128 channels), the windowed gather conv (K4 /
  K5 plus their residual, ``ops.spconv.apply_sparse_conv_windowed``);
- ``plain``: the plain gather conv over the rulebook.

The gather routes run the mirrored-gather backward: ``subm_conv_symmetric``
on the windowed route, ``subm_conv_gather`` on the others; the band routes
run the differentiable ``band_subm_conv``. ``StridedConv`` and
``InverseConv`` run their packed parent / tap forms where the plan has them,
else the gather conv over a rulebook (``_apply_conv``: windowed where
``use_windowed_gather`` holds, as JAX ``layers.py:45-51``). A rulebook's
windowed route is built once and shared by the convs over it
(``ops.spconv.windowed_route``). Each gather conv on the windowed route
keeps its last call's count of entries inside their windows and of all
entries (``last_window``; None off the route).
"""

from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn

from ...ops.band_conv import (
    BLOCK as BAND_BLOCK,
    WINDOW as BAND_WINDOW,
    band_eligible,
    band_subm_conv,
    build_band_plan_auto,
)
from ...ops.sparse import SparseTensor, make_sparse_tensor
from ...ops.spconv import (
    BandedRulebook,
    StridedPlan,
    SubmPlan,
    apply_sparse_conv,
    apply_sparse_conv_windowed,
    build_inverse_rulebook,
    build_strided_plan,
    build_subm_rulebook,
    inverse_conv_packed,
    strided_conv_packed,
    subm_conv_gather,
    subm_conv_symmetric,
    use_windowed_gather,
    windowed_route,
)


def _apply_conv(features, rulebook, w, mask, compute_dtype):
    """The strided / inverse conv over a rulebook: the windowed route where
    ``use_windowed_gather`` holds (JAX ``layers.py:45-51``), else the plain
    gather conv. Returns the output and the route's counts (or None)."""
    if use_windowed_gather(rulebook.shape[1], w.shape[1], w.shape[2]):
        route = windowed_route(rulebook, features.shape[0])
        out = apply_sparse_conv_windowed(features, rulebook, w, mask, compute_dtype,
                                         route)
        return out, (route.inside, route.live)
    return apply_sparse_conv(features, rulebook, w, mask, compute_dtype), None


def subm_route(rulebook, cin: int, cout: int, kernel_size: int) -> str:
    """Which conv ``SubMConv`` runs for this plan and width (layers.py:88-123
    of the JAX package)."""
    carrier = isinstance(rulebook, (SubmPlan, BandedRulebook))
    legacy = rulebook.legacy if carrier else rulebook
    band_plan = rulebook.band if carrier else None
    if band_eligible(cin, cout, kernel_size):
        if band_plan is not None:
            return "band-attached"
        if legacy is not None and cin > 64:
            return "band-inline"
    if isinstance(rulebook, SubmPlan) and cin <= 64:
        return "slab"
    if use_windowed_gather(legacy.shape[1], cin, cout):
        return "windowed"
    return "plain"


class _SparseConvBase(nn.Module):
    """A ``(k, k, k, Cin, Cout)`` kernel with torch's default conv init law
    (kaiming-uniform, bound sqrt(1 / fan_in)), as the JAX package uses."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.kernel_size = kernel_size
        self.compute_dtype = compute_dtype
        k = kernel_size
        self.weight = nn.Parameter(torch.empty(k, k, k, in_channels, out_channels))
        self.reset_parameters(torch.Generator().manual_seed(0))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        bound = (1.0 / (self.kernel_size ** 3 * self.in_channels)) ** 0.5
        with torch.no_grad():
            self.weight.uniform_(-bound, bound, generator=generator)

    def taps(self) -> torch.Tensor:
        """The kernel as (K^3, Cin, Cout)."""
        return self.weight.reshape(-1, self.in_channels, self.out_channels)


class SubMConv(_SparseConvBase):
    """Submanifold sparse conv (spconv SubMConv3d equivalent)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__(in_channels, out_channels, kernel_size, compute_dtype)
        self.last_route: Optional[str] = None
        self.last_window = None

    def forward(self, st: SparseTensor, rulebook=None,
                flags: Optional[List[torch.Tensor]] = None) -> SparseTensor:
        """``flags`` collects the ``ok`` of every band plan this conv used,
        inline ones included (the JAX package surfaces only attached plans'
        flags; see ROADMAP Queue 3)."""
        if rulebook is None:
            rulebook = build_subm_rulebook(st.coords, st.spatial_shape,
                                           st.batch_size, self.kernel_size)
        route = subm_route(rulebook, self.in_channels, self.out_channels,
                           self.kernel_size)
        self.last_route, self.last_window = route, None
        w = self.taps()
        legacy = (rulebook.legacy if isinstance(rulebook, (SubmPlan, BandedRulebook))
                  else rulebook)
        if route.startswith("band"):
            plan = (rulebook.band if route == "band-attached"
                    else build_band_plan_auto(legacy, 3))
            if flags is not None:
                flags.append(plan.ok)
            out = band_subm_conv((3, BAND_BLOCK, BAND_WINDOW), st.features, plan,
                                 w, st.mask, self.compute_dtype)
        else:
            if route == "windowed":
                windowed = windowed_route(legacy, st.features.shape[0])
                self.last_window = (windowed.inside, windowed.live)
                out = subm_conv_symmetric(st.features, legacy, w, st.mask,
                                          self.compute_dtype, windowed)
            else:
                out = subm_conv_gather(st.features, legacy, w, st.mask,
                                       self.compute_dtype)
            if route == "slab":
                out = out * rulebook.sorted_ok.to(out.dtype)
        return st.replace(features=out)


class StridedConv(_SparseConvBase):
    """Downsampling sparse conv (spconv SparseConv3d equivalent)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 2,
                 stride: int = 2, padding: int = 0,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__(in_channels, out_channels, kernel_size, compute_dtype)
        self.stride = stride
        self.padding = padding
        self.last_route: Optional[str] = None
        self.last_window = None

    def forward(self, st: SparseTensor, plan: Optional[StridedPlan] = None,
                out_capacity: Optional[int] = None) -> SparseTensor:
        if plan is None:
            plan = build_strided_plan(st.coords, st.spatial_shape, st.batch_size,
                                      self.kernel_size, self.stride, self.padding,
                                      out_capacity or st.capacity)
        mask = plan.out_coords[:, 0] >= 0
        self.last_window = None
        if plan.parent is not None:
            self.last_route = "packed"
            out = strided_conv_packed(st.features, plan.parent, plan.tap,
                                      self.taps(), plan.out_coords.shape[0],
                                      mask, self.compute_dtype)
        else:
            out, self.last_window = _apply_conv(st.features, plan.rulebook, self.taps(),
                                                mask, self.compute_dtype)
            self.last_route = "plain" if self.last_window is None else "windowed"
        return make_sparse_tensor(out, plan.out_coords, plan.spatial_shape,
                                  st.batch_size)


class InverseConv(_SparseConvBase):
    """Upsampling inverse sparse conv (spconv SparseInverseConv3d equivalent)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 2,
                 stride: int = 2, padding: int = 0,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__(in_channels, out_channels, kernel_size, compute_dtype)
        self.stride = stride
        self.padding = padding
        self.last_route: Optional[str] = None
        self.last_window = None

    def forward(self, st: SparseTensor, fine_coords: torch.Tensor,
                fine_spatial_shape, rulebook: Optional[torch.Tensor] = None,
                parent: Optional[torch.Tensor] = None,
                tap: Optional[torch.Tensor] = None) -> SparseTensor:
        mask = fine_coords[:, 0] >= 0
        self.last_window = None
        if parent is not None:
            # indice_key reuse: the down plan's parent/tap pair the rows
            self.last_route = "packed"
            out = inverse_conv_packed(st.features, parent, tap, self.taps(),
                                      mask, self.compute_dtype)
        else:
            if rulebook is None:
                rulebook = build_inverse_rulebook(
                    st.coords, st.spatial_shape, st.batch_size, fine_coords,
                    self.kernel_size, self.stride, self.padding)
            out, self.last_window = _apply_conv(st.features, rulebook, self.taps(), mask,
                                                self.compute_dtype)
            self.last_route = "plain" if self.last_window is None else "windowed"
        return make_sparse_tensor(out, fine_coords, fine_spatial_shape,
                                  st.batch_size)
