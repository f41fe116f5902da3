"""SpUNet-v1m1: sparse-voxel U-Net backbone.

Counterpart of ``ponderv2_tpu/models/sparse_unet/spunet.py`` (and of the
reference ``spconv_unet_v1m1_base.py``): a k5 submanifold stem, 4 strided
encoder stages of BasicBlocks, 4 inverse-conv decoder stages with skip
concat, and a linear head. Module names are the reference PyTorch ones, so
``state_dict()`` keys are ``conv_input.0.weight``, ``down.{s}.{0,1}``,
``enc.{s}.block{b}.*``, ``up.{ref}.*``, ``dec.{ref}.block{b}.*`` and
``final.*``, where decoder step ``s`` runs module index
``ref = num_stages - 1 - s`` (the reference builds up/dec ascending and runs
them reversed). A Python loop replaces the JAX package's ``nn.scan``.
``remat`` (on by default, as the JAX package's) runs each BasicBlock and
ConvBNRelu of a training forward under activation checkpointing, as its
``nn.remat``: the backward runs the unit's forward again, band convs (K1)
included, with the running statistics held (``norm.py:recomputing``).

``cls_mode`` runs the encoder only and mean-pools the last level's valid
voxels per scene, then ``final``; with ``num_classes == 0`` there is no
``final`` and the backbone returns the pooled ``(B, channels[3])``
features, as the reference's classifier recipe wants them (the JAX model
always builds its ``final`` Dense here and fails at ``num_classes == 0``,
ROADMAP Queue 3 F12). ``plans`` (the trainer's host-built plans,
``engines/plan_prefetch.py``) replaces the build inside the forward.
``SpUNet-v1m2`` is v1m1 under another name (its BN
momentum is v1m1's ``bn_momentum``). ``SpUNetNoSkipBase`` is the U-Net
without skip concatenation, over plain rulebooks built per level, so its
convs wider than 64 channels build their band plans inline.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ...ops.scatter import segment_mean
from ...ops.sparse import SparseTensor
from ...ops.spconv import (
    StridedPlan,
    build_strided_plan,
    build_subm_rulebook,
    invert_strided_rulebook,
    plan_contract_flags,
)
from ...utils.misc import as_dtype
from ..builder import MODELS
from ..norm import MaskedBatchNorm, recomputing
from .layers import InverseConv, StridedConv, SubMConv
from .plans import (
    build_spunet_plans_auto,
    capacity_schedule,
    level_spatial_shapes,
)


class Proj(nn.Module):
    """The reference's 1x1x1 subm conv shortcut (no bias): a plain matmul,
    weight kept in the spconv layout (1, 1, 1, Cin, Cout)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(1, 1, 1, in_channels, out_channels))
        self.reset_parameters(torch.Generator().manual_seed(0))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        cin = self.weight.shape[3]
        with torch.no_grad():
            self.weight.normal_(0.0, cin ** -0.5, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.reshape(self.weight.shape[3], self.weight.shape[4])
        return x @ w.to(x.dtype)


class BasicBlock(nn.Module):
    """Residual block: subm k3 -> BN -> relu -> subm k3 -> BN, + shortcut, relu."""

    def __init__(self, in_channels: int, channels: int, eps: float = 1e-3,
                 momentum: float = 0.01,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv1 = SubMConv(in_channels, channels, 3, compute_dtype)
        self.bn1 = MaskedBatchNorm(channels, eps, momentum)
        self.conv2 = SubMConv(channels, channels, 3, compute_dtype)
        self.bn2 = MaskedBatchNorm(channels, eps, momentum)
        self.proj = None
        if in_channels != channels:
            self.proj = nn.Sequential(Proj(in_channels, channels),
                                      MaskedBatchNorm(channels, eps, momentum))

    def forward(self, st: SparseTensor, rulebook,
                flags: Optional[List[torch.Tensor]] = None) -> SparseTensor:
        identity = st.features
        x = self.conv1(st, rulebook, flags)
        h = torch.relu(self.bn1(x.features, st.mask))
        x = self.conv2(st.replace(features=h), rulebook, flags)
        h = self.bn2(x.features, st.mask)
        if self.proj is not None:
            identity = self.proj[1](self.proj[0](identity), st.mask)
        out = torch.relu(h + identity)
        return st.replace_features(out)


class ConvBNRelu(nn.Sequential):
    """conv -> masked BN -> relu; children ``0`` (conv) and ``1`` (BN) keep
    the reference's ``conv_input``/``down.{s}``/``up.{s}`` names. The conv's
    own arguments (plan, or fine coords and pairing) pass through."""

    def forward(self, st: SparseTensor, *conv_args) -> SparseTensor:
        x = self[0](st, *conv_args)
        return x.replace(features=torch.relu(self[1](x.features, x.mask)))


def _reset_all(module: nn.Module, generator: Optional[torch.Generator]) -> None:
    """Re-initialize every submodule in registration order from one generator."""
    for m in module.modules():
        if m is not module and hasattr(m, "reset_parameters"):
            if isinstance(m, nn.Linear):
                with torch.no_grad():
                    m.weight.normal_(0.0, m.in_features ** -0.5, generator=generator)
                    m.bias.zero_()
            else:
                m.reset_parameters(generator)


@MODELS.register_module(name="SpUNet-v1m1")
class SpUNet(nn.Module):
    def __init__(
        self,
        in_channels: int = 6,
        num_classes: int = 20,
        base_channels: int = 32,
        channels: Sequence[int] = (32, 64, 128, 256, 256, 128, 96, 96),
        layers: Sequence[int] = (2, 3, 4, 6, 2, 2, 2, 2),
        bn_eps: float = 1e-3,
        bn_momentum: float = 0.01,
        capacities: Optional[Sequence[int]] = None,
        compute_dtype: Optional[torch.dtype] = None,
        remat: bool = True,
        cls_mode: bool = False,
    ):
        super().__init__()
        self.num_classes = num_classes
        self.remat = remat
        self.cls_mode = cls_mode
        self.channels = tuple(channels)
        self.layers = tuple(layers)
        self.capacities = tuple(capacities) if capacities is not None else None
        num_stages = len(layers) // 2
        self.num_stages = num_stages
        eps, mom, cdt = bn_eps, bn_momentum, as_dtype(compute_dtype)

        self.conv_input = ConvBNRelu(
            SubMConv(in_channels, base_channels, 5, cdt),
            MaskedBatchNorm(base_channels, eps, mom))
        self.down = nn.ModuleList()
        self.enc = nn.ModuleList()
        enc_channels = [base_channels]
        prev = base_channels
        for s in range(num_stages):
            self.down.append(ConvBNRelu(
                StridedConv(prev, channels[s], 2, 2, 0, cdt),
                MaskedBatchNorm(channels[s], eps, mom)))
            self.enc.append(nn.ModuleDict({
                f"block{b}": BasicBlock(channels[s], channels[s], eps, mom, cdt)
                for b in range(layers[s])}))
            prev = channels[s]
            enc_channels.append(prev)

        # built in reference module order (index ref), run reversed
        up, dec = [None] * num_stages, [None] * num_stages
        dec_prev = prev
        for s in range(0 if cls_mode else num_stages):
            ref = num_stages - 1 - s
            dec_c = channels[num_stages + s]
            skip_c = enc_channels[num_stages - 1 - s]
            up[ref] = ConvBNRelu(InverseConv(dec_prev, dec_c, 2, 2, 0, cdt),
                                 MaskedBatchNorm(dec_c, eps, mom))
            dec[ref] = nn.ModuleDict({
                f"block{b}": BasicBlock(dec_c + skip_c if b == 0 else dec_c,
                                        dec_c, eps, mom, cdt)
                for b in range(layers[num_stages + s])})
            dec_prev = dec_c
        if not cls_mode:
            self.up = nn.ModuleList(up)
            self.dec = nn.ModuleList(dec)
        self.final = nn.Linear(dec_prev, num_classes) if num_classes > 0 else None
        self.reset_parameters(torch.Generator().manual_seed(0))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        _reset_all(self, generator)

    def _unit(self, module: nn.Module, *args):
        """``module(*args)``; under ``remat`` in a training forward that
        records grads, activation-checkpointed."""
        if self.remat and self.training and torch.is_grad_enabled():
            return checkpoint(module, *args, use_reentrant=False,
                              context_fn=lambda: (contextlib.nullcontext(), recomputing()))
        return module(*args)

    def forward(self, st: SparseTensor, plans=None):
        """Returns ``(logits (N, num_classes), contract_ok () bool)`` (in
        ``cls_mode`` ``(B, num_classes)``, or the pooled ``(B, channels[3])``
        features without ``final``). ``contract_ok`` ANDs every plan
        contract flag, including the ``ok`` of band plans built inline."""
        num_stages = self.num_stages
        caps = self.capacities or capacity_schedule(st.capacity, num_stages)
        if plans is None:
            plans = build_spunet_plans_auto(st.coords, st.spatial_shape,
                                            st.batch_size, caps, self.channels)
        shapes = level_spatial_shapes(st.spatial_shape, num_stages)
        contract = plan_contract_flags(plans.stem)
        band_flags: List[torch.Tensor] = []

        x = self._unit(self.conv_input, st, plans.stem, band_flags)

        skips = [x]
        for s in range(num_stages):
            out_coords, rb, parent, tap = plans.strided[s]
            x = self._unit(self.down[s], x, StridedPlan(out_coords, rb, shapes[s + 1],
                                                        parent, tap))
            rb = plans.subm[s]
            contract += plan_contract_flags(rb)
            for block in self.enc[s].values():
                x = self._unit(block, x, rb, band_flags)
            skips.append(x)

        if self.cls_mode:
            # global mean pool over each scene's valid voxels -> classifier
            pooled = segment_mean(x.features, x.coords[:, 0], x.batch_size)
            out = pooled if self.final is None else self.final(pooled)
            return out, _all_flags(contract + band_flags, st)

        for s in range(num_stages):
            ref = num_stages - 1 - s
            skip = skips[ref]
            _, _, parent, tap = plans.strided[ref]
            x = self._unit(self.up[ref], x, skip.coords, skip.spatial_shape,
                           plans.inv[s], parent, tap)
            x = x.replace_features(torch.cat([x.features, skip.features], 1))
            rb = plans.l0 if ref == 0 else plans.subm[ref - 1]
            contract += plan_contract_flags(rb)
            for block in self.dec[ref].values():
                x = self._unit(block, x, rb, band_flags)

        contract_ok = _all_flags(contract + band_flags, st)
        if self.final is None:
            return x.features, contract_ok
        logits = self.final(x.features)
        return x.replace_features(logits).features, contract_ok


def _all_flags(flags: List[torch.Tensor], st: SparseTensor) -> torch.Tensor:
    """The AND of contract flags (True when there are none)."""
    if flags:
        return torch.stack(flags).all()
    return torch.ones((), dtype=torch.bool, device=st.features.device)


# the reference's v1m2 is v1m1 with a configurable BN momentum, which v1m1's
# ``bn_momentum`` already is (JAX ``spunet.py:303-306``)
MODELS.register_module(name="SpUNet-v1m2", module=SpUNet)


@MODELS.register_module(name="SpUNetNoSkipBase")
class SpUNetNoSkip(nn.Module):
    """Encoder-decoder without skip concatenation (JAX ``spunet.py:309-386``,
    reference ``spconv_unet_v1m1_base.py:281-461``). Each level builds its
    own plain k3 rulebook; the inverse convs run the down conv's rulebook
    inverted by scatter. Module names as SpUNet-v1m1's."""

    def __init__(
        self,
        in_channels: int = 6,
        num_classes: int = 0,
        base_channels: int = 32,
        channels: Sequence[int] = (32, 64, 128, 256, 256, 128, 96, 96),
        layers: Sequence[int] = (2, 3, 4, 6, 2, 2, 2, 2),
        bn_eps: float = 1e-3,
        bn_momentum: float = 0.01,
        capacities: Optional[Sequence[int]] = None,
        compute_dtype: Optional[torch.dtype] = None,
        remat: bool = True,
    ):
        super().__init__()
        self.num_classes = num_classes
        self.remat = remat
        self.channels = tuple(channels)
        self.layers = tuple(layers)
        self.capacities = tuple(capacities) if capacities is not None else None
        num_stages = len(layers) // 2
        self.num_stages = num_stages
        eps, mom, cdt = bn_eps, bn_momentum, as_dtype(compute_dtype)

        self.conv_input = ConvBNRelu(
            SubMConv(in_channels, base_channels, 5, cdt),
            MaskedBatchNorm(base_channels, eps, mom))
        self.down = nn.ModuleList()
        self.enc = nn.ModuleList()
        prev = base_channels
        for s in range(num_stages):
            self.down.append(ConvBNRelu(
                StridedConv(prev, channels[s], 2, 2, 0, cdt),
                MaskedBatchNorm(channels[s], eps, mom)))
            self.enc.append(nn.ModuleDict({
                f"block{b}": BasicBlock(channels[s], channels[s], eps, mom, cdt)
                for b in range(layers[s])}))
            prev = channels[s]
        up, dec = [None] * num_stages, [None] * num_stages
        for s in range(num_stages):
            ref = num_stages - 1 - s
            dec_c = channels[num_stages + s]
            up[ref] = ConvBNRelu(InverseConv(prev, dec_c, 2, 2, 0, cdt),
                                 MaskedBatchNorm(dec_c, eps, mom))
            dec[ref] = nn.ModuleDict({
                f"block{b}": BasicBlock(dec_c, dec_c, eps, mom, cdt)
                for b in range(layers[num_stages + s])})
            prev = dec_c
        self.up = nn.ModuleList(up)
        self.dec = nn.ModuleList(dec)
        self.final = nn.Linear(prev, num_classes) if num_classes > 0 else None
        self.reset_parameters(torch.Generator().manual_seed(0))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        _reset_all(self, generator)

    _unit = SpUNet._unit

    def forward(self, st: SparseTensor, plans=None):
        """Returns ``(logits or features (N, C), contract_ok () bool)``;
        ``contract_ok`` ANDs the ``ok`` of the band plans the wide convs
        build inline. ``plans`` is accepted for the segmentors' call and
        unused: this U-Net builds its rulebooks level by level."""
        del plans
        num_stages = self.num_stages
        caps = self.capacities or capacity_schedule(st.capacity, num_stages)
        band_flags: List[torch.Tensor] = []
        x = self._unit(self.conv_input, st,
                       build_subm_rulebook(st.coords, st.spatial_shape, st.batch_size, 5),
                       band_flags)
        levels = [x]
        down_rulebooks = []
        for s in range(num_stages):
            plan = build_strided_plan(x.coords, x.spatial_shape, x.batch_size, 2, 2, 0,
                                      caps[s + 1])
            down_rulebooks.append(plan.rulebook)
            x = self._unit(self.down[s], x, plan)
            rb = build_subm_rulebook(x.coords, x.spatial_shape, x.batch_size, 3)
            for block in self.enc[s].values():
                x = self._unit(block, x, rb, band_flags)
            levels.append(x)
        for s in range(num_stages):
            ref = num_stages - 1 - s
            fine = levels[ref]
            rb_inv = invert_strided_rulebook(down_rulebooks[ref], fine.coords.shape[0])
            x = self._unit(self.up[ref], x, fine.coords, fine.spatial_shape, rb_inv)
            rb = build_subm_rulebook(x.coords, x.spatial_shape, x.batch_size, 3)
            for block in self.dec[ref].values():
                x = self._unit(block, x, rb, band_flags)
        contract_ok = _all_flags(band_flags, st)
        if self.final is None:
            return x.features, contract_ok
        return x.replace_features(self.final(x.features)).features, contract_ok
