"""SpUNet conv plans: every data-dependent rulebook, built in one place.

Counterpart of ``ponderv2_tpu/models/sparse_unet/plans.py``. All plans
derive from the sorted L0 voxel coords plus static config (spatial shape,
capacities, channel widths). The port builds them on the tensor's device.

Which plans exist follows the JAX package exactly: a level whose
``dense_table_fits`` holds gets a ``SubmPlan`` (with a band plan attached when
a conv at that level is band-eligible); a level that does not gets a plain
``(K^3, N)`` rulebook, and its wide convs build band plans inline.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Sequence, Tuple

import torch

from ...ops import hashing as _hashing
from ...ops.band_conv import ENTRY_BUDGET, PAIR_BUDGET, band_eligible
from ...ops.spconv import (
    SubmPlan,
    attach_band_plan,
    build_strided_plan,
    build_subm_plan,
    build_subm_rulebook,
    derive_inner_subm_plan,
    downsample_shape,
    inner_k3_rulebook,
    invert_strided_rulebook,
)


class SpUNetPlans(NamedTuple):
    stem: Any  # SubmPlan or (125, N) rulebook - k5 at L0
    strided: Tuple[Tuple[torch.Tensor, ...], ...]  # (out_coords, rb, parent, tap)
    subm: Tuple[Any, ...]  # k3 plan per level 1..num_stages
    l0: Any  # k3 plan at L0 (the stem's inner taps)
    inv: Tuple[Optional[torch.Tensor], ...]  # inverse rulebooks per decoder
    #   stage; None when the packed parent/tap form covers the stage


def capacity_schedule(base_capacity: int, num_stages: int, decay: float = 2.0,
                      floor: int = 1024) -> Tuple[int, ...]:
    """Per-level voxel budgets: level 0 = base, each deeper level /= decay."""
    caps = []
    c = base_capacity
    for _ in range(num_stages + 1):
        caps.append(max(int(c), floor))
        c = c / decay
    return tuple(caps)


def _build_subm(coords, spatial_shape, batch_size, kernel_size):
    """SubmPlan when the JAX package's dense-grid regime applies, else a
    plain rulebook."""
    if _hashing.dense_table_fits(spatial_shape, batch_size):
        return build_subm_plan(coords, spatial_shape, batch_size, kernel_size)
    return build_subm_rulebook(coords, spatial_shape, batch_size, kernel_size)


def build_spunet_plans(
    coords: torch.Tensor,
    spatial_shape: Sequence[int],
    batch_size: int,
    capacities: Sequence[int],
    channels: Sequence[int],
    band_budgets: Optional[Tuple[int, int]] = None,
) -> SpUNetPlans:
    """Build every plan the SpUNet forward consumes, in model order.

    ``coords`` must be the sorted (batch, x, y, z) voxel coords the backbone
    runs on. ``channels`` is the full 2 * num_stages channel tuple."""
    num_stages = len(channels) // 2
    caps = tuple(capacities)
    pair_budget, entry_budget = band_budgets or (None, None)

    stem = _build_subm(coords, tuple(spatial_shape), batch_size, 5)
    c, shape = coords, tuple(spatial_shape)
    strided, subm = [], []
    for s in range(num_stages):
        plan = build_strided_plan(c, shape, batch_size, 2, 2, 0, caps[s + 1])
        strided.append((plan.out_coords, plan.rulebook, plan.parent, plan.tap))
        c, shape = plan.out_coords, plan.spatial_shape
        rb = _build_subm(c, shape, batch_size, 3)
        # a band plan if the encoder OR the decoder blocks at this level take
        # the band path (decoder stage s runs at level num_stages - 1 - s)
        dec_ch = channels[num_stages + (num_stages - 1 - (s + 1))] if (
            s + 1 < num_stages) else None
        wants_band = band_eligible(channels[s], channels[s], 3) or (
            dec_ch is not None and band_eligible(dec_ch, dec_ch, 3))
        if wants_band and isinstance(rb, SubmPlan):
            rb = attach_band_plan(rb, pair_budget, entry_budget)
        subm.append(rb)

    level_rows = [coords.shape[0]] + [entry[0].shape[0] for entry in strided]
    inv = []
    for s in range(num_stages):
        level = num_stages - 1 - s
        if strided[level][2] is not None:
            inv.append(None)  # packed parent/tap is the inverse pairing
        else:
            inv.append(invert_strided_rulebook(strided[level][1],
                                               level_rows[level]))

    if isinstance(stem, SubmPlan):
        l0 = derive_inner_subm_plan(stem, 5)
    else:
        l0 = inner_k3_rulebook(stem)
    last_ch = channels[2 * num_stages - 1]
    if band_eligible(last_ch, last_ch, 3) and isinstance(l0, SubmPlan):
        l0 = attach_band_plan(l0, pair_budget, entry_budget)

    return SpUNetPlans(stem=stem, strided=tuple(strided), subm=tuple(subm),
                       l0=l0, inv=tuple(inv))


def level_spatial_shapes(spatial_shape: Sequence[int],
                         num_stages: int) -> Tuple[Tuple[int, int, int], ...]:
    """Static per-level spatial shapes (L0..L_num_stages)."""
    shapes = [tuple(int(d) for d in spatial_shape)]
    for _ in range(num_stages):
        shapes.append(downsample_shape(shapes[-1], 2, 2, 0))
    return tuple(shapes)


def band_ok_flags(plans: SpUNetPlans):
    """The attached band plans' overflow-budget flags."""
    flags = []
    for p in list(plans.subm) + [plans.l0]:
        band = getattr(p, "band", None)
        if band is not None:
            flags.append(band.ok)
    return flags


MAX_DOUBLINGS = 4


def build_spunet_plans_auto(coords, spatial_shape, batch_size, capacities,
                            channels):
    """``build_spunet_plans`` with the JAX input pipeline's budget retry
    (``host_build_spunet_plans``): when an attached band plan's budgets
    overflow (``ok`` False), rebuild with both budgets doubled, up to
    ``MAX_DOUBLINGS`` times, so a dense scene gets a bigger overflow
    residual instead of zeroed convs. Runs on the coords' device; reading
    the flags is one host sync per attempt."""
    pair, entry = PAIR_BUDGET, ENTRY_BUDGET
    for attempt in range(MAX_DOUBLINGS + 1):
        plans = build_spunet_plans(coords, spatial_shape, batch_size,
                                   capacities, channels, (pair, entry))
        flags = band_ok_flags(plans)
        if not flags or bool(torch.stack(flags).all()) or attempt == MAX_DOUBLINGS:
            return plans
        pair, entry = pair * 2, entry * 2
