"""Dense 3D projection networks applied to the voxelized feature volume.

Counterpart of ``ponderv2_tpu/models/ponder/unet3d.py`` (reference
``ponder/models/ponder/unet3d.py``: Abstract3DUNet, v1m1 = DoubleConv +
interpolation/concat decoder, v1m2 = SingleConv + transposed-conv/sum
decoder in regression mode, the indoor-pretrain projector; SimpleConv3D).
Volumes are ``(B, C, X, Y, Z)``, torch's ``Conv3d`` layout, so the kernels
are torch ``Conv3d``/``ConvTranspose3d`` weights and module names are the
reference's (``encoders.{i}.basic_module.{batchnorm,conv}``,
``decoders.{i}.upsampling.upsample``, ``final_conv``).

- layer order ``bcr``: BatchNorm on the INPUT channels, bias-free 3x3x3
  conv, ReLU;
- ``FlaxBatchNorm`` keeps the JAX package's ``nn.BatchNorm`` arithmetic:
  statistics in f32 as E[x^2] - E[x]^2, the biased variance in the running
  update, momentum 0.1 (flax's 0.9 decay), eps 1e-5, output in the compute
  dtype;
- the transposed conv is ``ConvTranspose3d(k3, s2, p1, output_padding=1)``
  cropped to the skip. The TPU package's z-packed conv and subpixel
  transposed conv are TPU reformulations of the same functions and are not
  ported.

cuDNN runs float32 convolutions in TF32 unless
``torch.backends.cudnn.allow_tf32`` is False; callers that compare against
an f32 reference set it (``chip_smoke.py`` does).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...utils.misc import as_dtype
from ..builder import MODELS


class FlaxBatchNorm(nn.Module):
    """Batch norm over all but the channel axis 1, as ``flax.linen.BatchNorm``
    computes it (see module doc). Names are torch ``BatchNorm3d``'s."""

    def __init__(self, num_features: int, eps: float = 1e-5, momentum: float = 0.1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.eps, self.momentum, self.dtype = eps, momentum, dtype
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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1) + (1,) * (x.dim() - 2)
        xf = x.float()
        if self.training:
            axes = [0] + list(range(2, x.dim()))
            mean = xf.mean(axes)
            var = ((xf * xf).mean(axes) - mean * mean).clamp(min=0.0)
            with torch.no_grad():
                self.running_mean.mul_(1.0 - self.momentum).add_(self.momentum * mean)
                self.running_var.mul_(1.0 - self.momentum).add_(self.momentum * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean.reshape(shape)) * mul.reshape(shape) + self.bias.reshape(shape)
        return y.to(self.dtype or torch.result_type(x, self.weight))


def _init_conv(conv: nn.Module, generator) -> None:
    """lecun-normal law (variance 1 / fan_in), zero bias."""
    w = conv.weight
    fan_in = w.shape[1] * w[0, 0].numel()
    if isinstance(conv, nn.ConvTranspose3d):
        fan_in = w.shape[0] * w[0, 0].numel()
    with torch.no_grad():
        w.normal_(0.0, fan_in ** -0.5, generator=generator)
        if conv.bias is not None:
            conv.bias.zero_()


def _conv(x: torch.Tensor, conv: nn.Module, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """``conv`` in the compute dtype (inputs and weights cast, bias too)."""
    dtype = dtype or x.dtype
    w = conv.weight.to(dtype)
    b = None if conv.bias is None else conv.bias.to(dtype)
    if isinstance(conv, nn.ConvTranspose3d):
        return F.conv_transpose3d(x.to(dtype), w, b, conv.stride, conv.padding,
                                  conv.output_padding)
    return F.conv3d(x.to(dtype), w, b, conv.stride, conv.padding)


class SingleConv(nn.Module):
    """norm/conv/relu in ``order`` ('b' BatchNorm, 'g' GroupNorm, 'c' 3x3x3
    conv, 'r' ReLU); the conv has a bias iff there is no norm."""

    def __init__(self, in_channels: int, out_channels: int, num_groups: int = 1,
                 order: str = "bcr", dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.order, self.dtype = order, dtype
        use_bias = not ("g" in order or "b" in order)
        ch = in_channels
        for c in order:
            if c == "c":
                self.conv = nn.Conv3d(ch, out_channels, 3, padding=1, bias=use_bias)
                ch = out_channels
            elif c == "b":
                self.batchnorm = FlaxBatchNorm(ch, dtype=dtype)
            elif c == "g":
                self.groupnorm = nn.GroupNorm(num_groups, ch, eps=1e-6)
            elif c != "r":
                raise ValueError(f"unsupported layer order char {c!r}")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for c in self.order:
            if c == "c":
                x = _conv(x, self.conv, self.dtype)
            elif c == "b":
                x = self.batchnorm(x)
            elif c == "g":
                x = self.groupnorm(x.float())
            else:
                x = torch.relu(x)
        return x


class DoubleConv(nn.Module):
    """Two SingleConvs; an encoder halves the middle width."""

    def __init__(self, in_channels: int, out_channels: int, num_groups: int = 8,
                 encoder: bool = True, order: str = "bcr",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        mid = max(out_channels // 2 if encoder else out_channels, 1)
        self.SingleConv1 = SingleConv(in_channels, mid, num_groups, order, dtype)
        self.SingleConv2 = SingleConv(mid, out_channels, num_groups, order, dtype)

    def forward(self, x):
        return self.SingleConv2(self.SingleConv1(x))


class _Wrap(nn.Module):
    """A named holder, so state_dict keys read ``basic_module.*`` and
    ``upsampling.upsample.*`` as in the reference."""

    def __init__(self, **modules):
        super().__init__()
        for k, m in modules.items():
            setattr(self, k, m)


class Abstract3DUNet(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, f_maps: int = 32,
                 num_levels: int = 3, num_groups: int = 1, layer_order: str = "bcr",
                 double_conv: bool = False, final_sigmoid: bool = False,
                 is_segmentation: bool = False, compute_dtype=None):
        super().__init__()
        self.double_conv = double_conv
        self.final_sigmoid = final_sigmoid and is_segmentation
        self.dtype = as_dtype(compute_dtype)
        maps = [f_maps * 2 ** k for k in range(num_levels)]
        block = DoubleConv if double_conv else SingleConv
        self.encoders = nn.ModuleList()
        prev = in_channels
        for ch in maps:
            kw = dict(encoder=True) if double_conv else {}
            self.encoders.append(_Wrap(basic_module=block(
                prev, ch, num_groups, order=layer_order, dtype=self.dtype, **kw)))
            prev = ch
        self.decoders = nn.ModuleList()
        for ch in reversed(maps[:-1]):
            if double_conv:
                self.decoders.append(_Wrap(basic_module=DoubleConv(
                    ch + prev, ch, num_groups, encoder=False, order=layer_order,
                    dtype=self.dtype)))
            else:
                up = nn.ConvTranspose3d(prev, ch, 3, stride=2, padding=1,
                                        output_padding=1)
                self.decoders.append(_Wrap(
                    upsampling=_Wrap(upsample=up),
                    basic_module=SingleConv(ch, ch, num_groups, order=layer_order,
                                            dtype=self.dtype)))
            prev = ch
        self.final_conv = nn.Conv3d(maps[0], out_channels, 1)
        self.reset_parameters(torch.Generator().manual_seed(0))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for m in self.modules():
            if isinstance(m, (nn.Conv3d, nn.ConvTranspose3d)):
                _init_conv(m, generator)
            elif isinstance(m, (FlaxBatchNorm, nn.GroupNorm)):
                m.reset_parameters()

    def forward(self, volume: torch.Tensor) -> torch.Tensor:
        """(B, C, X, Y, Z) -> (B, out_channels, X, Y, Z) f32."""
        x = volume
        skips = []
        for li, enc in enumerate(self.encoders):
            if li > 0:
                x = F.max_pool3d(x, 2, 2)
            x = enc.basic_module(x)
            skips.append(x)
        for li, dec in enumerate(self.decoders):
            skip = skips[-(li + 2)]
            X, Y, Z = skip.shape[2:]
            if self.double_conv:
                x = x.repeat_interleave(2, 2).repeat_interleave(2, 3).repeat_interleave(2, 4)
                x = torch.cat([skip, x[:, :, :X, :Y, :Z]], 1)
            else:
                x = _conv(x, dec.upsampling.upsample, self.dtype)[:, :, :X, :Y, :Z]
                x = skip.to(x.dtype) + x
            x = dec.basic_module(x)
        x = _conv(x, self.final_conv, self.dtype)
        if self.final_sigmoid:
            x = torch.sigmoid(x)
        return x.float()


@MODELS.register_module(name="UNet3D-v1m1")
class UNet3Dv1m1(Abstract3DUNet):
    def __init__(self, in_channels: int, out_channels: int, f_maps: int = 32,
                 num_levels: int = 4, num_groups: int = 8, **kwargs):
        kwargs.setdefault("double_conv", True)
        super().__init__(in_channels, out_channels, f_maps, num_levels, num_groups,
                         **kwargs)


@MODELS.register_module(name="UNet3D-v1m2")
class UNet3Dv1m2(Abstract3DUNet):
    """SingleConv + bcr + transposed-conv/sum decoder, regression mode."""

    def __init__(self, in_channels: int, out_channels: int, f_maps: int = 32,
                 num_levels: int = 4, num_groups: int = 1, **kwargs):
        kwargs.setdefault("double_conv", False)
        kwargs.setdefault("is_segmentation", False)
        super().__init__(in_channels, out_channels, f_maps, num_levels, num_groups,
                         **kwargs)


@MODELS.register_module(name="SimpleConv3D-v1m1")
class SimpleConv3D(nn.Module):
    """One conv (with bias) + BatchNorm + ReLU (the outdoor projector)."""

    def __init__(self, in_channels: int = 32, out_channels: int = 32,
                 kernel_size: int = 3):
        super().__init__()
        self.conv = nn.Conv3d(in_channels, out_channels, kernel_size,
                              padding=kernel_size // 2)
        self.batchnorm = FlaxBatchNorm(out_channels)
        self.reset_parameters(torch.Generator().manual_seed(0))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        _init_conv(self.conv, generator)
        self.batchnorm.reset_parameters()

    def forward(self, volume: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.batchnorm(self.conv(volume)))
