"""SpUNet-v1m3: the sparse U-Net with Prompt-Driven BatchNorm.

Counterpart of ``ponderv2_tpu/models/sparse_unet/spunet_pdnorm.py`` (and of
the reference ``spconv_unet_v1m3_pdnorm.py``): SpUNet-v1m1's layout with
every norm a ``PDBatchNorm`` that takes the dataset's condition and a
context embedding. Module names are the reference ones, so ``state_dict()``
keys are ``conv_input.{conv,bn}``, ``down.{s}.{conv,bn}``,
``enc.{s}.block{b}.{conv1,bn1,conv2,bn2,proj_conv,proj_norm}``,
``up.{ref}.{conv,bn}``, ``dec.{ref}.block{b}.*`` and ``final.*``, where
decoder step ``s`` runs module index ``ref = num_stages - 1 - s``.

``cls_mode`` runs the encoder only and mean-pools each scene's voxels of the
last level, then ``final`` (none with ``num_classes == 0``: the pooled
``(B, channels[num_stages - 1])`` features), as the JAX model does.

The conv plans come from ``build_spunet_plans_auto``, as SpUNet-v1m1's do,
so the band convs take the same routes (and the same budget retry). The JAX
v1m3 builds its own rulebooks (band plans only where a level is wider than
64, inline plans elsewhere); the convs compute the same function.
"""

from __future__ import annotations

from functools import partial
from typing import List, Optional, Sequence

import torch
from torch import nn

from ...ops.scatter import segment_mean
from ...ops.sparse import SparseTensor
from ...ops.spconv import StridedPlan, plan_contract_flags
from ...utils.misc import as_dtype
from ..builder import MODELS
from ..norm import PDBatchNorm
from .layers import InverseConv, StridedConv, SubMConv
from .plans import build_spunet_plans_auto, capacity_schedule, level_spatial_shapes
from .spunet import Proj, _all_flags, _reset_all


class PDBasicBlock(nn.Module):
    """Residual block: subm k3 -> PDNorm -> relu -> subm k3 -> PDNorm, plus
    the shortcut (``proj_conv`` -> ``proj_norm`` when the width changes), relu."""

    def __init__(self, in_channels: int, channels: int, norm,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv1 = SubMConv(in_channels, channels, 3, compute_dtype)
        self.bn1 = norm(channels)
        self.conv2 = SubMConv(channels, channels, 3, compute_dtype)
        self.bn2 = norm(channels)
        self.proj_conv = self.proj_norm = None
        if in_channels != channels:
            self.proj_conv = Proj(in_channels, channels)
            self.proj_norm = norm(channels)

    def forward(self, st: SparseTensor, rulebook, flags: List[torch.Tensor],
                ci: int, context: Optional[torch.Tensor]) -> SparseTensor:
        identity = st.features
        x = self.conv1(st, rulebook, flags)
        h = torch.relu(self.bn1(x.features, st.mask, ci, context))
        x = self.conv2(st.replace(features=h), rulebook, flags)
        h = self.bn2(x.features, st.mask, ci, context)
        if self.proj_conv is not None:
            identity = self.proj_norm(self.proj_conv(identity), st.mask, ci, context)
        return st.replace_features(torch.relu(h + identity))


class PDConvNorm(nn.Module):
    """conv -> PDNorm -> relu (the reference's ``conv_input``, ``SPConvDown``
    and ``SPConvUp``); the conv's own arguments pass through."""

    def __init__(self, conv: nn.Module, bn: PDBatchNorm):
        super().__init__()
        self.conv = conv
        self.bn = bn

    def forward(self, st: SparseTensor, ci: int, context: Optional[torch.Tensor],
                *conv_args) -> SparseTensor:
        x = self.conv(st, *conv_args)
        return x.replace(features=torch.relu(self.bn(x.features, x.mask, ci, context)))


@MODELS.register_module(name="SpUNet-v1m3")
class SpUNetPDNorm(nn.Module):
    def __init__(
        self,
        in_channels: int = 6,
        num_classes: int = 0,
        base_channels: int = 32,
        channels: Sequence[int] = (32, 64, 128, 256, 256, 128, 96, 96),
        layers: Sequence[int] = (2, 3, 4, 6, 2, 2, 2, 2),
        cls_mode: bool = False,
        conditions: Sequence[str] = ("ScanNet", "S3DIS", "Structured3D"),
        zero_init: bool = False,
        norm_decouple: bool = True,
        norm_adaptive: bool = True,
        norm_affine: bool = True,
        context_channels: int = 256,
        bn_eps: float = 1e-3,
        bn_momentum: float = 0.01,
        capacities: Optional[Sequence[int]] = None,
        compute_dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        del zero_init, norm_affine  # accepted for config parity, as in the JAX model
        self.num_classes = num_classes
        self.cls_mode = cls_mode
        self.channels = tuple(channels)
        self.layers = tuple(layers)
        self.conditions = tuple(conditions)
        self.capacities = tuple(capacities) if capacities is not None else None
        num_stages = len(layers) // 2
        self.num_stages = num_stages
        cdt = as_dtype(compute_dtype)
        norm = partial(PDBatchNorm, conditions=self.conditions, eps=bn_eps,
                       momentum=bn_momentum, decouple=norm_decouple,
                       adaptive=norm_adaptive, context_channels=context_channels)

        self.conv_input = PDConvNorm(SubMConv(in_channels, base_channels, 5, cdt),
                                     norm(base_channels))
        self.down = nn.ModuleList()
        self.enc = nn.ModuleList()
        enc_channels = [base_channels]
        prev = base_channels
        for s in range(num_stages):
            self.down.append(PDConvNorm(StridedConv(prev, channels[s], 2, 2, 0, cdt),
                                        norm(channels[s])))
            self.enc.append(nn.ModuleDict({
                f"block{b}": PDBasicBlock(channels[s], channels[s], norm, cdt)
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
            up[ref] = PDConvNorm(InverseConv(dec_prev, dec_c, 2, 2, 0, cdt), norm(dec_c))
            dec[ref] = nn.ModuleDict({
                f"block{b}": PDBasicBlock(dec_c + skip_c if b == 0 else dec_c, dec_c,
                                          norm, cdt)
                for b in range(layers[num_stages + s])})
            dec_prev = dec_c
        if not cls_mode:
            self.up = nn.ModuleList(up)
            self.dec = nn.ModuleList(dec)
        self.final = nn.Linear(dec_prev, num_classes) if num_classes > 0 else None
        self.reset_parameters(torch.Generator().manual_seed(0))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        _reset_all(self, generator)

    def forward(self, st: SparseTensor, condition: Optional[str] = None,
                context: Optional[torch.Tensor] = None, plans=None):
        """Returns ``(features or logits (N, C), contract_ok () bool)`` (in
        ``cls_mode`` ``(B, num_classes)`` or the pooled features).
        ``condition`` is the dataset's name: this backbone takes its own index
        of it (the first condition when it names none of them), so a head
        may order its conditions otherwise. ``context`` is the (C_ctx,)
        embedding the adaptive norms modulate by."""
        ci = self.conditions.index(condition) if condition in self.conditions else 0
        num_stages = self.num_stages
        caps = self.capacities or capacity_schedule(st.capacity, num_stages)
        if plans is None:
            plans = build_spunet_plans_auto(st.coords, st.spatial_shape,
                                            st.batch_size, caps, self.channels)
        shapes = level_spatial_shapes(st.spatial_shape, num_stages)
        contract = plan_contract_flags(plans.stem)
        band_flags: List[torch.Tensor] = []

        x = self.conv_input(st, ci, context, plans.stem, band_flags)

        skips = [x]
        for s in range(num_stages):
            out_coords, rb, parent, tap = plans.strided[s]
            x = self.down[s](x, ci, context,
                             StridedPlan(out_coords, rb, shapes[s + 1], parent, tap))
            rb = plans.subm[s]
            contract += plan_contract_flags(rb)
            for block in self.enc[s].values():
                x = block(x, rb, band_flags, ci, context)
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
            x = self.up[ref](x, ci, context, skip.coords, skip.spatial_shape,
                             plans.inv[s], parent, tap)
            x = x.replace_features(torch.cat([x.features, skip.features], 1))
            rb = plans.l0 if ref == 0 else plans.subm[ref - 1]
            contract += plan_contract_flags(rb)
            for block in self.dec[ref].values():
                x = block(x, rb, band_flags, ci, context)

        contract_ok = _all_flags(contract + band_flags, st)
        if self.final is None:
            return x.features, contract_ok
        return x.replace_features(self.final(x.features)).features, contract_ok
