"""MinkUNet family: ResNet-style sparse U-Nets.

Counterpart of ``ponderv2_tpu/models/sparse_unet/mink_unet.py`` (the
reference's ``mink_unet.py``, MinkowskiEngine 14/18/34/50/101 variants with
A-D widths), over the same sparse convs as SpUNet: a k5 stem, per stage a
k2s2 strided conv + BN + relu and residual blocks, per decoder stage an
inverse conv + BN + relu over the down conv's own pairing (``parent`` /
``tap``), the skip concat and residual blocks, and a linear head.

Each level builds a plain k3 rulebook; a level whose blocks are wider than
64 channels carries its band plan in a ``BandedRulebook``, so its convs run
the band conv (K1-K3 on a CUDA tensor) with one plan per level. A level's
encoder runs before its decoder attaches a plan, so the encoder convs of
narrow levels take the plain gather conv, and a decoder's first conv wider
than 64 channels over a plain rulebook builds its plan inline, as in JAX.
(The JAX package sends a conv whose TPU VMEM estimate fails, the first of
each decoder stage of MinkUNet14D and 18D, to the plain gather conv; the
port's band conv takes every width, ``ops/band_conv.py:band_eligible``: the
same function.)

Module names are the reference's (``conv0p1s1``, ``bn0``,
``conv{s+1}p{2^s}s2``, ``bn{s+1}``, ``block{s+1}``,
``convtr{4+s}p{2^(4-s)}s2``, ``bntr{4+s}``, ``block{5+s}``, ``final``; in
a block ``conv1..3``, ``norm1..3`` and the shortcut ``downsample.{0,1}``),
conv kernels in the layout ``(kx, ky, kz, Cin, Cout)``. The stage widths are
the JAX model's (its strided conv goes to the stage's width at once).
``remat`` (on by default, as in JAX) checkpoints each residual block of a
training forward, with the running statistics moved once
(``norm.py:recomputing``).
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ...ops.sparse import SparseTensor
from ...ops.spconv import (
    BandedRulebook,
    attach_band_rulebook,
    build_strided_plan,
    build_subm_rulebook,
    plan_contract_flags,
)
from ...utils.misc import as_dtype
from ..builder import MODELS
from ..norm import MaskedBatchNorm, recomputing
from .layers import InverseConv, StridedConv, SubMConv
from .plans import capacity_schedule
from .spunet import Proj, _all_flags, _reset_all


def _shortcut(in_channels, channels, eps, mom):
    """The reference's ``downsample``: a 1x1x1 conv + BN where widths differ."""
    if in_channels == channels:
        return None
    return nn.Sequential(Proj(in_channels, channels), MaskedBatchNorm(channels, eps, mom))


class BasicBlock(nn.Module):
    """subm k3 -> BN -> relu -> subm k3 -> BN, + shortcut, relu."""

    expansion = 1

    def __init__(self, in_channels: int, channels: int, eps: float, mom: float,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv1 = SubMConv(in_channels, channels, 3, compute_dtype)
        self.norm1 = MaskedBatchNorm(channels, eps, mom)
        self.conv2 = SubMConv(channels, channels, 3, compute_dtype)
        self.norm2 = MaskedBatchNorm(channels, eps, mom)
        self.downsample = _shortcut(in_channels, channels, eps, mom)

    def forward(self, st: SparseTensor, rulebook, flags: List[torch.Tensor]) -> SparseTensor:
        identity = st.features
        x = self.conv1(st, rulebook, flags)
        h = torch.relu(self.norm1(x.features, st.mask))
        x = self.conv2(st.replace(features=h), rulebook, flags)
        h = self.norm2(x.features, st.mask)
        if self.downsample is not None:
            identity = self.downsample[1](self.downsample[0](identity), st.mask)
        return st.replace_features(torch.relu(h + identity))


class Bottleneck(nn.Module):
    """1x1x1 -> BN -> relu -> subm k3 -> BN -> relu -> 1x1x1 -> BN, +
    shortcut, relu; the k3 conv at a quarter of the block's width (JAX
    ``mink_unet.py:33-57``)."""

    expansion = 4

    def __init__(self, in_channels: int, channels: int, eps: float, mom: float,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        planes = channels // self.expansion
        self.conv1 = Proj(in_channels, planes)
        self.norm1 = MaskedBatchNorm(planes, eps, mom)
        self.conv2 = SubMConv(planes, planes, 3, compute_dtype)
        self.norm2 = MaskedBatchNorm(planes, eps, mom)
        self.conv3 = Proj(planes, channels)
        self.norm3 = MaskedBatchNorm(channels, eps, mom)
        self.downsample = _shortcut(in_channels, channels, eps, mom)

    def forward(self, st: SparseTensor, rulebook, flags: List[torch.Tensor]) -> SparseTensor:
        identity = st.features
        h = torch.relu(self.norm1(self.conv1(st.features), st.mask))
        x = self.conv2(st.replace(features=h), rulebook, flags)
        h = torch.relu(self.norm2(x.features, st.mask))
        h = self.norm3(self.conv3(h), st.mask)
        if self.downsample is not None:
            identity = self.downsample[1](self.downsample[0](identity), st.mask)
        return st.replace_features(torch.relu(h + identity))


class MinkUNetBase(nn.Module):
    def __init__(
        self,
        in_channels: int = 3,
        out_channels: int = 20,
        block_type: str = "basic",
        layers: Sequence[int] = (2, 2, 2, 2, 2, 2, 2, 2),
        planes: Sequence[int] = (32, 64, 128, 256, 256, 128, 96, 96),
        init_dim: int = 32,
        bn_eps: float = 1e-3,
        bn_momentum: float = 0.01,
        capacities: Optional[Sequence[int]] = None,
        compute_dtype: Optional[torch.dtype] = None,
        remat: bool = True,
        scan_blocks: bool = True,
    ):
        super().__init__()
        del scan_blocks  # the JAX model's nn.scan switch: a Python loop here
        block = {"basic": BasicBlock, "bottleneck": Bottleneck}[block_type]
        self.out_channels = out_channels
        self.remat = remat
        self.layers = tuple(layers)
        self.capacities = tuple(capacities) if capacities is not None else None
        ns = len(layers) // 2
        self.num_stages = ns
        # each level's block width (encoder levels 1..ns, decoder stages)
        self.widths = tuple(p * block.expansion for p in planes)
        eps, mom, cdt = bn_eps, bn_momentum, as_dtype(compute_dtype)

        self.conv0p1s1 = SubMConv(in_channels, init_dim, 5, cdt)
        self.bn0 = MaskedBatchNorm(init_dim, eps, mom)
        skip_c, prev = [init_dim], init_dim
        for s in range(ns):
            ch = self.widths[s]
            setattr(self, f"conv{s + 1}p{2 ** s}s2", StridedConv(prev, ch, 2, 2, 0, cdt))
            setattr(self, f"bn{s + 1}", MaskedBatchNorm(ch, eps, mom))
            setattr(self, f"block{s + 1}", nn.ModuleList(
                block(ch, ch, eps, mom, cdt) for _ in range(layers[s])))
            skip_c.append(ch)
            prev = ch
        for s in range(ns):
            ch = self.widths[ns + s]
            setattr(self, f"convtr{ns + s}p{2 ** (ns - s)}s2",
                    InverseConv(prev, ch, 2, 2, 0, cdt))
            setattr(self, f"bntr{ns + s}", MaskedBatchNorm(ch, eps, mom))
            setattr(self, f"block{ns + 1 + s}", nn.ModuleList(
                block(ch + skip_c[ns - 1 - s] if b == 0 else ch, ch, eps, mom, cdt)
                for b in range(layers[ns + s])))
            prev = ch
        self.final = nn.Linear(prev, out_channels) if out_channels > 0 else None
        self.reset_parameters(torch.Generator().manual_seed(0))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        _reset_all(self, generator)

    def down(self, s: int) -> nn.Module:
        return getattr(self, f"conv{s + 1}p{2 ** s}s2")

    def up(self, s: int) -> nn.Module:
        ns = self.num_stages
        return getattr(self, f"convtr{ns + s}p{2 ** (ns - s)}s2")

    def blocks(self, stage: int) -> nn.ModuleList:
        """Stage ``stage``'s blocks: encoder stages 0..ns-1, then decoder."""
        return getattr(self, f"block{stage + 1}")

    def _block(self, block: nn.Module, *args):
        """``block(*args)``; under ``remat`` in a training forward that
        records grads, activation-checkpointed."""
        if self.remat and self.training and torch.is_grad_enabled():
            return checkpoint(block, *args, use_reentrant=False,
                              context_fn=lambda: (contextlib.nullcontext(), recomputing()))
        return block(*args)

    @staticmethod
    def _bn_relu(bn: MaskedBatchNorm, x: SparseTensor) -> SparseTensor:
        return x.replace(features=torch.relu(bn(x.features, x.mask)))

    def forward(self, st: SparseTensor, plans=None):
        """Returns ``(logits or features (N, C), contract_ok () bool)``;
        ``contract_ok`` ANDs the ``ok`` of every band plan, the attached and
        the inline ones. ``plans`` is accepted for the segmentors' call and
        unused: this U-Net builds its rulebooks level by level."""
        del plans
        ns = self.num_stages
        caps = self.capacities or capacity_schedule(st.capacity, ns)
        contract: List[torch.Tensor] = []
        band_flags: List[torch.Tensor] = []

        rb0 = build_subm_rulebook(st.coords, st.spatial_shape, st.batch_size, 5)
        x = self._bn_relu(self.bn0, self.conv0p1s1(st, rb0, band_flags))
        skips, rbs, down_plans = [x], [None] * (ns + 1), []
        for s in range(ns):
            plan = build_strided_plan(x.coords, x.spatial_shape, x.batch_size, 2, 2, 0,
                                      caps[s + 1])
            down_plans.append(plan)
            x = self._bn_relu(getattr(self, f"bn{s + 1}"), self.down(s)(x, plan))
            rb = build_subm_rulebook(x.coords, x.spatial_shape, x.batch_size, 3)
            if self.widths[s] > 64:
                # wide blocks take the band conv; one shared plan per level
                rb = attach_band_rulebook(rb)
            rbs[s + 1] = rb
            contract += plan_contract_flags(rb)
            for block in self.blocks(s):
                x = self._block(block, x, rb, band_flags)
            skips.append(x)

        for s in range(ns):
            level = ns - 1 - s
            skip, down = skips[level], down_plans[level]
            # indice_key reuse: the inverse conv transposes the down conv
            # over its own parent/tap pairing
            x = self.up(s)(x, skip.coords, skip.spatial_shape, None, down.parent, down.tap)
            x = self._bn_relu(getattr(self, f"bntr{ns + s}"), x)
            x = x.replace_features(torch.cat([x.features, skip.features], 1))
            rb = rbs[level]
            if rb is None:
                rb = rbs[level] = build_subm_rulebook(x.coords, x.spatial_shape,
                                                      x.batch_size, 3)
            if self.widths[ns + s] > 64 and not isinstance(rb, BandedRulebook):
                rb = rbs[level] = attach_band_rulebook(rb)
            contract += plan_contract_flags(rb)
            for block in self.blocks(ns + s):
                x = self._block(block, x, rb, band_flags)

        contract_ok = _all_flags(contract + band_flags, st)
        if self.final is None:
            return x.features, contract_ok
        return x.replace_features(self.final(x.features)).features, contract_ok


# name: (block, layers, planes), the JAX package's table (mink_unet.py:169-185)
_VARIANTS = {
    "MinkUNet14": ("basic", (1, 1, 1, 1, 1, 1, 1, 1), (32, 64, 128, 256, 128, 128, 96, 96)),
    "MinkUNet18": ("basic", (2, 2, 2, 2, 2, 2, 2, 2), (32, 64, 128, 256, 128, 128, 96, 96)),
    "MinkUNet34": ("basic", (2, 3, 4, 6, 2, 2, 2, 2), (32, 64, 128, 256, 256, 128, 64, 64)),
    "MinkUNet50": ("bottleneck", (2, 3, 4, 6, 2, 2, 2, 2), (32, 64, 128, 256, 256, 128, 64, 64)),
    "MinkUNet101": ("bottleneck", (2, 3, 4, 23, 2, 2, 2, 2), (32, 64, 128, 256, 256, 128, 64, 64)),
    "MinkUNet14A": ("basic", (1, 1, 1, 1, 1, 1, 1, 1), (32, 64, 128, 256, 128, 128, 96, 96)),
    "MinkUNet14B": ("basic", (1, 1, 1, 1, 1, 1, 1, 1), (32, 64, 128, 256, 128, 128, 128, 128)),
    "MinkUNet14C": ("basic", (1, 1, 1, 1, 1, 1, 1, 1), (32, 64, 128, 256, 192, 192, 128, 128)),
    "MinkUNet14D": ("basic", (1, 1, 1, 1, 1, 1, 1, 1), (32, 64, 128, 256, 384, 384, 384, 384)),
    "MinkUNet18A": ("basic", (2, 2, 2, 2, 2, 2, 2, 2), (32, 64, 128, 256, 128, 128, 96, 96)),
    "MinkUNet18B": ("basic", (2, 2, 2, 2, 2, 2, 2, 2), (32, 64, 128, 256, 128, 128, 128, 128)),
    "MinkUNet18D": ("basic", (2, 2, 2, 2, 2, 2, 2, 2), (32, 64, 128, 256, 384, 384, 384, 384)),
    "MinkUNet34A": ("basic", (2, 3, 4, 6, 2, 2, 2, 2), (32, 64, 128, 256, 256, 128, 64, 64)),
    "MinkUNet34B": ("basic", (2, 3, 4, 6, 2, 2, 2, 2), (32, 64, 128, 256, 256, 128, 64, 32)),
    "MinkUNet34C": ("basic", (2, 3, 4, 6, 2, 2, 2, 2), (32, 64, 128, 256, 256, 128, 96, 96)),
}


def _register_variant(name, block, layer_counts, plane_widths):
    def factory(**kwargs):
        kwargs.setdefault("block_type", block)
        kwargs.setdefault("layers", layer_counts)
        kwargs.setdefault("planes", plane_widths)
        return MinkUNetBase(**kwargs)

    factory.__name__ = name
    MODELS.register_module(name=name, module=factory)
    return factory


for _name, (_block, _layers, _planes) in _VARIANTS.items():
    _register_variant(_name, _block, _layers, _planes)
