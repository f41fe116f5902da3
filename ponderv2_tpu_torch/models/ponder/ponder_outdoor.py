"""PonderOutdoor-v2: LiDAR pretraining by neural rendering.

Counterpart of ``ponderv2_tpu/models/ponder/ponder_outdoor.py``:

1. MAE-style block masking of the input features (``block_mask_keep``:
   one keep decision per (scene, block of ``size`` voxels), hashed from the
   block and a per-step seed; masked rows take the learned ``mtoken``);
2. backbone (SpUNet, ``num_classes=0``) -> per-voxel features;
3. dense feature volume: scatter-mean (or max) of the features onto the
   condition's ``grid_shape`` over its ``point_cloud_range`` ->
   SimpleConv3D projection;
4. rays precomputed by the ``ProjectOnImage`` / ``RaySample`` transforms
   (camera origin -> lidar point, (B, R, 3)), normalised into [0, 1]^3
   over the point-cloud range (per axis: the box is 108 x 108 x 8 m on
   nuScenes, so the unit cube is anisotropic, as in the JAX model);
5. one NeuS render of the B x R rays; the render losses (depth, sdf, free
   space, eikonal; rgb and the CLIP-contrastive semantic term where the
   config has them).

Random draws are tensors: ``input_dict["draws"]`` holds them
(``mask_seed``, the integer seed of ``block_mask_keep``, and ``sampler``,
the NeuS sampler's uniforms), or the model draws them from
``input_dict["generator"]`` (a ``torch.Generator`` on the batch's device).
Train or eval is the module's ``training`` flag.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ...ops.scatter import segment_max, segment_mean
from ...ops.sparse import maybe_sort_by_key
from ...utils.clip_text import get_text_embeddings
from ..builder import MODELS, build_model
from ..default import batch_to_sparse_tensor
from .render.surface_models import RENDERERS

_MASK_SEED_HIGH = 2 ** 31 - 1  # jax.random.randint(rng, (), 0, int32 max)
_U32 = 0xFFFFFFFF


def block_mask_keep(grid_coord: torch.Tensor, batch: torch.Tensor, size: int,
                    ratio: float, seed) -> torch.Tensor:
    """Per-row keep decision of the block mask, bit for bit the JAX
    function's: its uint32 hash computed in int64, the low 32 bits kept
    after every product (the low 32 bits of a product depend only on the
    operands' low 32 bits). ``seed``: an int or a 0-d integer tensor.
    Padding rows (``batch < 0``) are kept."""
    blk = (grid_coord.to(torch.int64) & _U32) // size
    b = torch.where(batch >= 0, batch, torch.zeros_like(batch)).to(torch.int64)
    s = torch.as_tensor(seed, device=grid_coord.device).to(torch.int64) & _U32
    h = (((b * 73856093) & _U32) ^ ((blk[:, 0] * 19349663) & _U32)
         ^ ((blk[:, 1] * 83492791) & _U32) ^ ((blk[:, 2] * 2654435761) & _U32) ^ s)
    # murmur3 finalizer
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & _U32
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & _U32
    h = h ^ (h >> 16)
    u = h.to(torch.float32) / torch.tensor(2.0 ** 32, dtype=torch.float32)
    keep = u >= torch.tensor(ratio, dtype=torch.float32)
    return keep | (batch < 0)


def _per_condition(value, ci):
    """Resolve a possibly per-condition tuple-of-tuples to condition ``ci``.

    The reference indexes ``scene_bbox/grid_size/grid_shape[dataset_idx]``
    (ponder_outdoor_base.py:203-209); flat tuples mean "same for all"."""
    if value and isinstance(value[0], (tuple, list)):
        return tuple(value[ci])
    return tuple(value)


@MODELS.register_module(name="PonderOutdoor-v2")
class PonderOutdoor(nn.Module):
    def __init__(
        self,
        backbone=None,
        projection=None,
        renderer=None,
        grid_shape: Sequence = (180, 180, 5),
        point_cloud_range: Sequence = (-54.0, -54.0, -5.0, 54.0, 54.0, 3.0),
        grid_size: Optional[Sequence] = None,
        mask: Optional[Dict[str, Any]] = None,
        assume_sorted: bool = False,
        share_volume: bool = True,
        pool_type: str = "mean",
        render_semantic: bool = False,
        conditions: Sequence[str] = ("NuScenes",),
        val_ray_split: int = 8192,
        template: Any = "[x]",
        clip_model: str = "openai/clip-vit-base-patch16",
        class_name: Sequence[str] = (),
        valid_index: Sequence[Sequence[int]] = (),
        embedding_path: Optional[str] = None,
    ):
        super().__init__()
        del share_volume, val_ray_split, template  # unused, as in the JAX model
        self.grid_shape = tuple(grid_shape)
        self.point_cloud_range = tuple(point_cloud_range)
        self.grid_size = tuple(grid_size) if grid_size is not None else None
        self.mask = dict(mask) if mask else None
        self.assume_sorted = assume_sorted
        self.pool_type = pool_type
        self.render_semantic = render_semantic
        self.conditions = tuple(conditions)
        self.valid_index = tuple(tuple(v) for v in valid_index)

        self.backbone = build_model(dict(backbone))
        self.proj_net = build_model(dict(projection))
        rcfg = dict(renderer)
        self.renderer = RENDERERS.get(rcfg.pop("type", "NeuSModel"))(
            feature_dim=int(projection["out_channels"]), **rcfg)
        if self.mask:
            self.mtoken = nn.Parameter(torch.zeros(1, int(self.mask["channel"])))
        if render_semantic:
            names = list(class_name) or [f"class_{i}" for i in range(16)]
            emb = get_text_embeddings(names, embedding_path=embedding_path,
                                      clip_model=clip_model)
            self.register_buffer("class_embedding", torch.from_numpy(np.asarray(emb)))
        else:
            self.class_embedding = None

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Seeded init in module order: backbone, projection, field, then the
        mask token (flax's ``truncated_normal(0.02)``: a unit normal cut at
        +-2, times 0.02)."""
        self.backbone.reset_parameters(generator)
        self.proj_net.reset_parameters(generator)
        self.renderer.reset_parameters(generator)
        if self.mask:
            with torch.no_grad():
                nn.init.trunc_normal_(self.mtoken, 0.0, 0.02, -0.04, 0.04,
                                      generator=generator)

    # ------------------------------------------------------------- draws
    def draw_noise(self, generator: torch.Generator, batch_size: int,
                   rays: int) -> Dict[str, Any]:
        """The random draws of one training forward, from ``generator``."""
        dev = generator.device
        return dict(
            mask_seed=torch.randint(0, _MASK_SEED_HIGH, (), generator=generator,
                                    device=dev),
            sampler=[torch.rand(s, generator=generator, device=dev)
                     for s in self.renderer.draw_shapes((batch_size, rays))],
        )

    def _condition_index(self, input_dict) -> int:
        cond = input_dict.get("condition", self.conditions[0])
        if isinstance(cond, (list, tuple)):
            cond = cond[0]
        return self.conditions.index(cond) if cond in self.conditions else 0

    def _bbox(self, ci: int, like: torch.Tensor):
        bbox = _per_condition(self.point_cloud_range, ci)
        lo = torch.tensor(bbox[:3], dtype=torch.float32, device=like.device)
        hi = torch.tensor(bbox[3:], dtype=torch.float32, device=like.device)
        return lo, hi

    def _normalize(self, p: torch.Tensor, ci: int = 0) -> torch.Tensor:
        """World coords -> [0, 1]^3 over condition ``ci``'s point-cloud range."""
        lo, hi = self._bbox(ci, p)
        return torch.clamp((p - lo) / (hi - lo), 1e-5, 1.0 - 1e-5)

    def _build_volume(self, feat, coord, batch, batch_size, ci=0):
        gx, gy, gz = _per_condition(self.grid_shape, ci)
        lo, hi = self._bbox(ci, coord)
        if self.grid_size is not None:
            gsize = torch.tensor(_per_condition(self.grid_size, ci), dtype=torch.float32,
                                 device=coord.device)
        else:
            gsize = (hi - lo) / torch.tensor([gx, gy, gz], dtype=torch.float32,
                                             device=coord.device)
        vox = torch.floor((coord - lo) / gsize).to(torch.int64)
        top = torch.tensor([gx - 1, gy - 1, gz - 1], device=coord.device)
        vox = torch.minimum(vox.clamp(min=0), top)
        b = batch.clamp(min=0).to(torch.int64)
        flat = ((b * gx + vox[:, 0]) * gy + vox[:, 1]) * gz + vox[:, 2]
        num = batch_size * gx * gy * gz
        flat = torch.where(batch >= 0, flat, torch.full_like(flat, num))
        if self.pool_type == "mean":
            pooled = segment_mean(feat, flat, num)
        else:
            pooled = segment_max(feat, flat, num, initial=0.0)
        return pooled.reshape(batch_size, gx, gy, gz, -1).permute(0, 4, 1, 2, 3)

    # --------------------------------------------------------------- forward
    def forward(self, input_dict: Dict[str, Any]) -> Dict[str, Any]:
        """Returns ``loss`` (the render losses), the detached loss terms
        (and ``psnr`` with colour), and ``contract_ok`` from the backbone."""
        train = self.training
        batch = input_dict["batch"]
        B = int(input_dict["batch_size"])
        ci = self._condition_index(input_dict)
        ray_start = self._normalize(input_dict["ray_start"].float(), ci)
        ray_end = self._normalize(input_dict["ray_end"].float(), ci)
        draws = input_dict.get("draws")
        if draws is None and train:
            gen = input_dict.get("generator")
            if gen is None:
                gen = torch.Generator(device=batch.device).manual_seed(0)
            draws = self.draw_noise(gen, ray_start.shape[0], ray_start.shape[1])

        st = batch_to_sparse_tensor(input_dict)
        if self.mask and train:
            keep = block_mask_keep(input_dict["grid_coord"], batch, int(self.mask["size"]),
                                   float(self.mask["ratio"]), draws["mask_seed"])
            st = st.replace_features(torch.where(
                keep[:, None], st.features, self.mtoken.to(st.features.dtype)))
        st_sorted, inverse = maybe_sort_by_key(st, self.assume_sorted)
        feat, contract_ok = self.backbone(st_sorted)
        if inverse is not None:
            feat = feat[inverse]

        coord = input_dict["coord"].float()
        volume = self.proj_net(self._build_volume(feat, coord, batch, B, ci))

        delta = ray_end - ray_start
        dist = torch.linalg.vector_norm(delta, dim=-1)
        dirs = delta / torch.clamp(dist[..., None], min=1e-8)
        valid = input_dict.get("ray_valid")
        valid = (torch.ones_like(dist, dtype=torch.bool) if valid is None
                 else valid.bool()) & (dist > 1e-6)

        vol_cl = self.renderer.field.volume_channels_last(volume)
        render_out = self.renderer(vol_cl, ray_start, dirs,
                                   draws=draws["sampler"] if train else None)
        targets = dict(depth=torch.where(valid, dist, torch.full_like(dist, -0.001)),
                       ray_mask=valid)
        if "ray_rgb" in input_dict:  # colour variant (reference `-color` cfg)
            targets["rgb"] = input_dict["ray_rgb"].float() / 255.0
        class_emb = None
        if self.render_semantic and "ray_segment" in input_dict:
            targets["semantic"] = input_dict["ray_segment"]
            # per-condition class subset (reference :168-174)
            class_emb = self.class_embedding
            if self.valid_index:
                class_emb = class_emb[list(self.valid_index[ci])]
        loss_dict = self.renderer.get_loss(render_out, targets,
                                           class_embeddings=class_emb, train=train)
        out = dict(loss=loss_dict.pop("render_loss"))
        out.update({k: v.detach() for k, v in loss_dict.items()})
        out["contract_ok"] = contract_ok
        return out
