"""Neural fields: SDF field over a dense feature volume, and its decoders.

Counterpart of ``ponderv2_tpu/models/ponder/render/fields.py``
(``ResidualDecoder``, ``SingleVarianceNetwork``, ``LaplaceDensity``,
``SDFField``). Volume features come from the twice-differentiable
trilinear smooth sampler (``ops.interp``); the spatial sdf gradient is
``torch.autograd.grad`` of the sdf with ``create_graph=True``, so the
eikonal loss differentiates through it. Module and parameter names are the
reference's (``sdf_decoder.fc_p``, ``fc_c.{l}``, ``lin{l}``,
``deviation_network.variance``), as torch ``nn.Linear`` weights.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ....ops.interp import sample_channels_last
from ....utils.misc import as_dtype


def _softplus100(x: torch.Tensor) -> torch.Tensor:
    return F.softplus(x * 100.0) / 100.0


def _linear(x: torch.Tensor, layer: nn.Linear, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """flax ``Dense(dtype=...)``: input, kernel and bias in the compute dtype."""
    if dtype is None:
        return layer(x)
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


class ResidualDecoder(nn.Module):
    """Per-layer residually re-injected conditioning. With L = n_blocks + 1
    linears: x = fc_p(points) * points_factor; for l in 0..L-1:
    x = lin_l(x + fc_c_l(feats)), activation unless last. Several
    conditioning tensors are concatenated."""

    def __init__(self, in_dim: int, cond_dim: int, hidden_dim: int = 128,
                 n_blocks: int = 1, out_dim: int = 1, points_factor: float = 1.0,
                 activation: str = "softplus", final: Optional[str] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.points_factor, self.final, self.dtype = points_factor, final, dtype
        self.act = _softplus100 if activation == "softplus" else torch.relu
        n_lin = n_blocks + 1
        self.fc_p = nn.Linear(in_dim, hidden_dim)
        self.fc_c = nn.ModuleList([nn.Linear(cond_dim, hidden_dim) for _ in range(n_lin)])
        for l in range(n_lin):
            setattr(self, f"lin{l}", nn.Linear(
                hidden_dim, out_dim if l == n_lin - 1 else hidden_dim))
        self.n_lin = n_lin

    def forward(self, points: torch.Tensor, *conds: torch.Tensor) -> torch.Tensor:
        feats = conds[0] if len(conds) == 1 else torch.cat(conds, -1)
        x = _linear(points, self.fc_p, self.dtype) * self.points_factor
        for l in range(self.n_lin):
            x = x + _linear(feats, self.fc_c[l], self.dtype)
            x = _linear(x, getattr(self, f"lin{l}"), self.dtype)
            if l < self.n_lin - 1:
                x = self.act(x)
        x = x.float()
        if self.final == "sigmoid":
            x = torch.sigmoid(x)
        return x


class SingleVarianceNetwork(nn.Module):
    """NeuS learnable inverse variance: inv_s = exp(10 * variance)."""

    def __init__(self, init_val: float = 0.3):
        super().__init__()
        self.init_val = init_val
        self.variance = nn.Parameter(torch.tensor(float(init_val)))

    def reset_parameters(self, generator=None) -> None:
        with torch.no_grad():
            self.variance.fill_(self.init_val)

    def forward(self) -> torch.Tensor:
        return torch.exp(10.0 * self.variance)


class LaplaceDensity(nn.Module):
    """VolSDF sdf -> density: (1/beta) (0.5 + 0.5 sign(-sdf)(1 - exp(-|sdf|/beta)))."""

    def __init__(self, beta_init: float = 0.1, beta_min: float = 1e-4):
        super().__init__()
        self.beta_init, self.beta_min = beta_init, beta_min
        self.beta = nn.Parameter(torch.tensor(float(beta_init)))

    def reset_parameters(self, generator=None) -> None:
        with torch.no_grad():
            self.beta.fill_(self.beta_init)

    def forward(self, sdf: torch.Tensor) -> torch.Tensor:
        beta = self.beta.abs() + self.beta_min
        return (1.0 / beta) * (
            0.5 + 0.5 * torch.sign(-sdf) * (1.0 - torch.exp(-sdf.abs() / beta)))


class SDFField(nn.Module):
    """SDF + color + semantic field conditioned on a dense feature volume
    ``(B, C, X, Y, Z)``; points are in the unit cube [0, 1]^3. ``feature_dim``
    is the volume's channel count (the JAX module infers it at init)."""

    def __init__(self, feature_dim: int = 32, hidden_dim: int = 128, num_layers: int = 3,
                 geo_feat_dim: int = 15, use_color: bool = True,
                 use_semantic: bool = True, semantic_dim: int = 512,
                 points_factor: float = 0.0, smoothstep: bool = True,
                 variance_init: float = 0.3, sdf_bias: float = 0.0,
                 rgb_n_blocks: int = 0, semantic_n_blocks: int = 0,
                 compute_dtype=None, share_volume: bool = False):
        super().__init__()
        self.smoothstep, self.sdf_bias, self.share_volume = smoothstep, sdf_bias, share_volume
        self.use_color, self.use_semantic = use_color, use_semantic
        self.dtype = as_dtype(compute_dtype)
        half = feature_dim if share_volume else feature_dim // 2
        app = feature_dim if share_volume else feature_dim - half
        self.sdf_decoder = ResidualDecoder(
            3, half, hidden_dim, max(num_layers - 1, 0), 1 + geo_feat_dim,
            points_factor, "softplus", dtype=self.dtype)
        # reference input order: gradients, appearance feat, geo, dirs
        if use_color:
            self.rgb_decoder = ResidualDecoder(
                3, 3 + app + geo_feat_dim + 3, hidden_dim, rgb_n_blocks, 3,
                activation="relu", dtype=self.dtype)
        if use_semantic:
            self.semantic_decoder = ResidualDecoder(
                3, 3 + app + geo_feat_dim, hidden_dim, semantic_n_blocks,
                semantic_dim, activation="relu", dtype=self.dtype)
        self.deviation_network = SingleVarianceNetwork(variance_init)
        self.reset_parameters(torch.Generator().manual_seed(0))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """flax Dense's law: lecun-normal kernels (variance 1 / fan_in), zero
        biases."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                with torch.no_grad():
                    m.weight.normal_(0.0, m.in_features ** -0.5, generator=generator)
                    m.bias.zero_()
        self.deviation_network.reset_parameters()

    # ------------------------------------------------------------- primitives
    def volume_channels_last(self, volume: torch.Tensor) -> torch.Tensor:
        """(B, C, X, Y, Z) -> (B, Z, Y, X, C) in the compute dtype: the
        sampler's (D, H, W) axes with W = x."""
        if self.dtype is not None:
            volume = volume.to(self.dtype)
        return volume.permute(0, 4, 3, 2, 1).contiguous()

    def sample_features(self, vol_cl: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
        """points (B, ..., 3) in [0, 1] -> (B, ..., C) f32."""
        B = vol_cl.shape[0]
        grid = points.reshape(B, -1, 3) * 2.0 - 1.0
        out = sample_channels_last(vol_cl, grid, align_corners=True,
                                   smoothstep=self.smoothstep)
        return out.reshape(*points.shape[:-1], vol_cl.shape[-1])

    def _split(self, feat: torch.Tensor):
        if self.share_volume:
            return feat, feat
        half = feat.shape[-1] // 2
        return feat[..., :half], feat[..., half:]

    def get_sdf(self, vol_cl: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
        """(B, ..., 3) -> sdf (B, ...)."""
        feat_sdf, _ = self._split(self.sample_features(vol_cl, points))
        return self.sdf_decoder(points, feat_sdf)[..., 0] - self.sdf_bias

    def get_alpha(self, sdf, gradients, directions, deltas, inv_s,
                  cos_anneal_ratio: float = 1.0):
        """NeuS alpha from the sdf and its gradient."""
        true_cos = (directions[..., None, :] * gradients).sum(-1)
        iter_cos = -(torch.relu(-true_cos * 0.5 + 0.5) * (1.0 - cos_anneal_ratio)
                     + torch.relu(-true_cos) * cos_anneal_ratio)
        est_next = sdf + iter_cos * deltas * 0.5
        est_prev = sdf - iter_cos * deltas * 0.5
        cdf_next = torch.sigmoid(est_next * inv_s)
        cdf_prev = torch.sigmoid(est_prev * inv_s)
        alpha = (cdf_prev - cdf_next + 1e-5) / (cdf_prev + 1e-5)
        return torch.clamp(alpha, 0.0, 1.0)

    # ------------------------------------------------------------ full forward
    def forward(self, vol_cl, origins, directions, starts, ends,
                cos_anneal_ratio: float = 1.0):
        """The field at ray samples: origins/directions (B, R, 3), starts/ends
        (B, R, S); returns sdf, alphas, gradients, positions, inv_s, rgb,
        semantic."""
        mid = 0.5 * (starts + ends)
        positions = origins[..., None, :] + directions[..., None, :] * mid[..., None]
        # one forward gives sdf, geo and appearance features, and the sdf's
        # spatial gradient by one pullback (sdf_i depends on p_i alone); the
        # gradient keeps its graph when the caller records one (training)
        create_graph = torch.is_grad_enabled()
        with torch.enable_grad():
            positions = positions.detach().requires_grad_(True)
            feat_sdf, feat = self._split(self.sample_features(vol_cl, positions))
            out = self.sdf_decoder(positions, feat_sdf)
            sdf = out[..., 0] - self.sdf_bias
            geo = out[..., 1:]
            gradients, = torch.autograd.grad(sdf, positions, torch.ones_like(sdf),
                                             create_graph=create_graph)
        inv_s = self.deviation_network()
        deltas = torch.clamp(ends - starts, min=1e-6)
        alphas = self.get_alpha(sdf, gradients, directions, deltas, inv_s,
                                cos_anneal_ratio)
        result = dict(sdf=sdf, alphas=alphas, gradients=gradients,
                      positions=positions, inv_s=inv_s)
        if self.use_color:
            dirs = directions[..., None, :].expand(positions.shape)
            result["rgb"] = torch.sigmoid(
                self.rgb_decoder(positions, gradients, feat, geo, dirs))
        if self.use_semantic:
            result["semantic"] = self.semantic_decoder(positions, gradients, feat, geo)
        return result
