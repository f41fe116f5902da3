"""Surface rendering models: NeuS forward and the render losses.

Counterpart of ``ponderv2_tpu/models/ponder/render/surface_models.py``
(``SurfaceModel.get_loss``, ``NeuSModel``). One pass renders all scenes'
rays at once: (B, R) rays x S samples. ``VolSDFModel`` is not ported yet.

Losses: depth L1, RGB L1 (+ PSNR), ray-batch contrastive semantic CE
against CLIP text embeddings (chunk-local at eval), free-space/truncation
SDF supervision from sensor depth, eikonal, and sparse input-point SDF.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch
from torch import nn

from ....utils.registry import Registry
from .colliders import COLLIDERS
from .fields import SDFField
from .rays import get_weights_from_alphas, safe_norm, safe_normalize
from .renderers import (
    render_accumulation,
    render_depth,
    render_normal,
    render_rgb,
    render_semantic,
)
from .samplers import SAMPLERS

RENDERERS = Registry("renderers")


def _contrastive_ce(pred: torch.Tensor, gt: torch.Tensor, valid: torch.Tensor,
                    temperature: float) -> torch.Tensor:
    """InfoNCE over a ray batch: ``logits = pred @ gt.T / temperature``, the
    label of ray i is i; rows with ``valid`` False are left out of the mean.
    The last two axes are (rays, channels); leading axes are chunks."""
    logits = pred @ gt.transpose(-1, -2) / temperature
    nll = -torch.log_softmax(logits, -1).diagonal(dim1=-2, dim2=-1)
    v = valid.float()
    return (nll * v).sum(-1) / torch.clamp(v.sum(-1), min=1.0)


class SurfaceModel(nn.Module):
    """Base: collider -> sampler -> field -> compositing -> outputs.
    ``feature_dim`` is the volume's channel count."""

    def __init__(self, field: Optional[Dict[str, Any]] = None,
                 collider: Optional[Dict[str, Any]] = None,
                 sampler: Optional[Dict[str, Any]] = None,
                 loss: Optional[Dict[str, Any]] = None, feature_dim: int = 32):
        super().__init__()
        field_cfg = dict(field or {})
        field_cfg.pop("type", None)
        self.field = SDFField(feature_dim=feature_dim, **field_cfg)
        self.collider = COLLIDERS.build(dict(collider or {"type": "AABBBoxCollider"}))
        self.sampler = SAMPLERS.build(dict(sampler or {"type": "NeuSSampler"}))
        self.loss_cfg = dict(loss or {})

    def reset_parameters(self, generator=None) -> None:
        self.field.reset_parameters(generator)

    def forward(self, vol_cl, origins, directions, draws=None,
                cos_anneal_ratio: float = 1.0):
        raise NotImplementedError

    # ------------------------------------------------------------------ losses
    def get_loss(self, outputs: Dict[str, torch.Tensor],
                 targets: Dict[str, torch.Tensor],
                 class_embeddings: Optional[torch.Tensor] = None,
                 train: bool = True) -> Dict[str, torch.Tensor]:
        """The render losses; targets ``rgb (B,R,3)``, ``depth (B,R)``,
        ``semantic (B,R)`` (class ids; ids below ``semantic_min_label`` carry
        no CLIP target), ``ray_mask (B,R)``. Weight keys take the reference
        spelling (``rgb_loss``) or the short one (``rgb``). rgb and psnr
        average over valid rays only."""
        cfg = self.loss_cfg
        w = cfg.get("weights", {})

        def _w(name, default):
            return w.get(f"{name}_loss", w.get(name, default))

        mask = targets.get("ray_mask")
        if mask is None:
            mask = torch.ones(targets["rgb"].shape[:-1], dtype=torch.bool,
                              device=targets["rgb"].device)
        fmask = mask.float()
        n_rays = torch.clamp(fmask.sum(), min=1.0)
        losses: Dict[str, torch.Tensor] = {}

        if "rgb" in outputs and "rgb" in targets:
            diff = outputs["rgb"] - targets["rgb"]
            losses["rgb_loss"] = (diff.abs().mean(-1) * fmask).sum() / n_rays * _w("rgb", 10.0)
            mse = ((diff ** 2).mean(-1) * fmask).sum() / n_rays
            losses["psnr"] = -10.0 * torch.log10(torch.clamp(mse, min=1e-10))

        if "depth" in outputs and "depth" in targets:
            dmask = fmask * (targets["depth"] > 0)
            nd = torch.clamp(dmask.sum(), min=1.0)
            err = (outputs["depth"] - targets["depth"]).abs()
            losses["depth_loss"] = (err * dmask).sum() / nd * _w("depth", 1.0)

        if ("semantic" in outputs and "semantic" in targets
                and class_embeddings is not None):
            temperature = float(cfg.get("temperature", 0.01))
            min_label = int(cfg.get("semantic_min_label", 1))
            labels = targets["semantic"]
            pred = safe_normalize(outputs["semantic"])
            lab_ok = labels >= min_label
            gt_emb = torch.where(lab_ok[..., None],
                                 class_embeddings[labels.clamp(min=0)],
                                 torch.zeros((), device=pred.device))
            valid = fmask * (targets.get("depth", fmask) > 0) * lab_ok
            C = pred.shape[-1]
            pred_f, gt_f, valid_f = pred.reshape(-1, C), gt_emb.reshape(-1, C), valid.reshape(-1)
            if train:
                sem = _contrastive_ce(pred_f, gt_f, valid_f, temperature)
            else:
                # eval: chunk-local contrast
                chunk = int(cfg.get("val_ray_split", 128))
                pad = (-pred_f.shape[0]) % chunk
                if pad:
                    pred_f = torch.nn.functional.pad(pred_f, (0, 0, 0, pad))
                    gt_f = torch.nn.functional.pad(gt_f, (0, 0, 0, pad))
                    valid_f = torch.nn.functional.pad(valid_f, (0, pad))
                sem = _contrastive_ce(pred_f.reshape(-1, chunk, C),
                                      gt_f.reshape(-1, chunk, C),
                                      valid_f.reshape(-1, chunk), temperature).mean()
            losses["semantic_loss"] = sem * _w("semantic", 1.0)

        if "sdf" in outputs and "depth" in targets:
            truncation = cfg.get("sensor_depth_truncation", 0.05)
            mid = outputs["sample_depths"]
            gt = targets["depth"][..., None]
            valid = (fmask * (targets["depth"] > 0))[..., None]
            sdf = outputs["sdf"]
            approx_sdf = gt - mid
            front = (approx_sdf > truncation) * valid
            near = (approx_sdf.abs() <= truncation) * valid
            nf = torch.clamp(front.sum(), min=1.0)
            nn_ = torch.clamp(near.sum(), min=1.0)
            losses["free_space_loss"] = ((torch.relu(truncation - sdf) * front).sum()
                                         / nf * _w("free_space", 1.0))
            losses["sdf_loss"] = ((sdf - approx_sdf).abs() * near).sum() / nn_ * _w("sdf", 1.0)

        if "gradients" in outputs:
            # over ALL samples, no ray mask (as the reference)
            grad_norm = safe_norm(outputs["gradients"], dim=-1)
            losses["eikonal_loss"] = ((grad_norm - 1.0) ** 2).mean() * _w("eikonal", 0.1)

        if "sparse_sdf" in outputs:
            sp_mask = outputs.get("sparse_sdf_mask")
            if sp_mask is None:
                sp_mask = torch.ones_like(outputs["sparse_sdf"], dtype=torch.bool)
            spm = sp_mask.float()
            losses["sparse_sdf_loss"] = (
                (outputs["sparse_sdf"].abs() * spm).sum() / torch.clamp(spm.sum(), min=1.0)
                * _w("sparse_sdf", w.get("sparse_points_sdf_loss", 0.0)))

        losses["render_loss"] = sum(v for k, v in losses.items() if k.endswith("_loss"))
        return losses


@RENDERERS.register_module()
class NeuSModel(SurfaceModel):
    def draw_shapes(self, rays_shape) -> Sequence[Sequence[int]]:
        """Shapes of the uniforms one training render takes (``draws``)."""
        return self.sampler.draw_shapes(rays_shape)

    def forward(self, vol_cl, origins, directions, draws=None,
                cos_anneal_ratio: float = 1.0) -> Dict[str, torch.Tensor]:
        """Render rays through the channels-last volume ``vol_cl``
        (``field.volume_channels_last``). ``draws``: the sampler's uniforms
        when training (stratified, one per upsample step), None at eval."""
        nears, fars = self.collider(origins, directions)
        starts, ends = self.sampler(
            nears, fars, lambda p: self.field.get_sdf(vol_cl, p), origins,
            directions, train=draws is not None, draws=draws)
        field_out = self.field(vol_cl, origins, directions, starts, ends,
                               cos_anneal_ratio=cos_anneal_ratio)
        weights, _ = get_weights_from_alphas(field_out["alphas"])
        outputs = dict(
            weights=weights,
            sdf=field_out["sdf"],
            gradients=field_out["gradients"],
            inv_s=field_out["inv_s"],
            sample_depths=0.5 * (starts + ends),
            depth=render_depth(weights, starts, ends),
            accumulation=render_accumulation(weights),
            normal=render_normal(weights, field_out["gradients"]),
        )
        if "rgb" in field_out:
            outputs["rgb"] = render_rgb(weights, field_out["rgb"])
        if "semantic" in field_out:
            outputs["semantic"] = render_semantic(weights, field_out["semantic"])
        return outputs
