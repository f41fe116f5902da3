"""Differentiable trilinear volume sampling.

Counterpart of ``ponderv2_tpu/ops/interp.py`` (``grid_sample_3d``,
``sample_feature_volume``). Written as row indexing plus lerps, so autograd
differentiates it twice with respect to the sample points: the eikonal loss
takes the gradient of the sdf's input gradient. ``F.grid_sample`` has no
smoothstep and no double backward with respect to the grid. The TPU
package's corner packing (pair/quad/octet rows, a gather-descriptor trick)
is not ported: here each corner is one direct row read.

Conventions match ``torch.nn.functional.grid_sample`` for 3D: the volume is
``(B, C, D, H, W)`` and normalized sample coordinates are ``(x, y, z)`` in
[-1, 1], with x indexing W (fastest), y indexing H and z indexing D.
"""

from __future__ import annotations

import torch


def _unnormalize(g: torch.Tensor, size: int, align_corners: bool) -> torch.Tensor:
    if align_corners:
        return (g + 1.0) * 0.5 * (size - 1)
    return ((g + 1.0) * size - 1.0) * 0.5


def sample_channels_last(
    vol_cl: torch.Tensor,
    points: torch.Tensor,
    align_corners: bool = True,
    padding_mode: str = "zeros",
    smoothstep: bool = False,
) -> torch.Tensor:
    """``grid_sample_3d`` on a channels-last volume ``(B, D, H, W, C)``;
    returns ``(B, M, C)`` in f32. Corners are read from an f32 copy of the
    volume: the same values as upcasting each corner (the JAX package's f32
    weights promote them), and the volume's gradient, summed over every
    sample that reads a voxel, then accumulates in f32, not in a bf16
    volume's dtype."""
    B, D, H, W, C = vol_cl.shape
    x = _unnormalize(points[..., 0], W, align_corners)
    y = _unnormalize(points[..., 1], H, align_corners)
    z = _unnormalize(points[..., 2], D, align_corners)
    x0, y0, z0 = torch.floor(x), torch.floor(y), torch.floor(z)
    tx, ty, tz = x - x0, y - y0, z - z0
    if smoothstep:
        tx = tx * tx * (3.0 - 2.0 * tx)
        ty = ty * ty * (3.0 - 2.0 * ty)
        tz = tz * tz * (3.0 - 2.0 * tz)
    ix0, iy0, iz0 = x0.long(), y0.long(), z0.long()
    flat = vol_cl.reshape(B, D * H * W, C).float()
    bidx = torch.arange(B, device=vol_cl.device)[:, None]

    out = None
    for dz in (0, 1):
        wz = (1.0 - tz) if dz == 0 else tz
        iz = iz0 + dz
        for dy in (0, 1):
            wy = (1.0 - ty) if dy == 0 else ty
            iy = iy0 + dy
            for dx in (0, 1):
                wx = (1.0 - tx) if dx == 0 else tx
                ix = ix0 + dx
                if padding_mode == "border":
                    cx, cy, cz = ix.clamp(0, W - 1), iy.clamp(0, H - 1), iz.clamp(0, D - 1)
                    valid = None
                else:  # zeros
                    valid = ((ix >= 0) & (ix < W) & (iy >= 0) & (iy < H)
                             & (iz >= 0) & (iz < D))
                    cx, cy, cz = ix.clamp(0, W - 1), iy.clamp(0, H - 1), iz.clamp(0, D - 1)
                v = flat[bidx, (cz * H + cy) * W + cx]  # (B, M, C)
                if valid is not None:
                    v = v * valid[..., None].to(v.dtype)
                term = (wz * wy * wx)[..., None] * v
                out = term if out is None else out + term
    return out


def grid_sample_3d(
    volume: torch.Tensor,
    points: torch.Tensor,
    align_corners: bool = True,
    padding_mode: str = "zeros",
    smoothstep: bool = False,
) -> torch.Tensor:
    """Trilinearly sample ``volume (B, C, D, H, W)`` at ``points (B, M, 3)``
    (normalized (x, y, z) in [-1, 1]). Returns (B, C, M) f32.
    ``smoothstep=True`` applies the Hermite smoothstep to the interpolation
    fractions, which makes the sampled field C1-continuous across voxel
    boundaries."""
    vol_cl = volume.permute(0, 2, 3, 4, 1)
    return sample_channels_last(vol_cl, points, align_corners, padding_mode,
                                smoothstep).transpose(1, 2)


def sample_feature_volume(
    volume: torch.Tensor,
    points: torch.Tensor,
    concat_levels: int = 1,
    align_corners: bool = True,
    smoothstep: bool = True,
) -> torch.Tensor:
    """Per-point features ``(B, M, C)`` of ``volume (B, C, D, H, W)`` at
    normalized ``points (B, M, 3)``; ``concat_levels`` is kept for API parity
    (channel groups sample identically)."""
    del concat_levels
    return grid_sample_3d(volume, points, align_corners=align_corners,
                          smoothstep=smoothstep).transpose(1, 2)
