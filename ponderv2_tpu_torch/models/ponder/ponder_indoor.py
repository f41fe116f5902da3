"""PonderIndoor-v2: indoor pretraining by differentiable neural rendering.

Counterpart of ``ponderv2_tpu/models/ponder/ponder_indoor.py``:

1. backbone (SpUNet, ``num_classes=0``) -> per-voxel features, with an
   optional block mask of the inputs;
2. per-scene unit-cube normalization by segment min/max, applied to the
   points and to the camera poses and depths;
3. dense feature volume: scatter-mean onto ``grid_shape`` over the unit
   cube -> UNet3D projection;
4. ray picking: per (scene, view) the ``ray_nsample`` valid-depth pixels
   with the highest random scores; K/R/T backprojection; plane -> point depth;
5. one NeuS render of all B x V*R rays; render losses with the CLIP
   contrastive semantic term; the PPT loss on the sparse features.

The JAX model draws from ``jax.random`` keys. Here every random draw is a
tensor: ``input_dict["draws"]`` holds them (``ray_score`` (B, V, H*W),
``sampler`` (the NeuS sampler's uniforms), ``mask_salt``), or the model
draws them from ``input_dict["generator"]`` (a ``torch.Generator`` on the
batch's device) in that order. Train or eval is the module's ``training``
flag. Eval renders every pixel in chunks of ``val_ray_split`` rays (a
Python loop where the JAX package uses ``nn.scan``).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ...ops.scatter import segment_max, segment_mean, segment_min
from ...ops.sparse import maybe_sort_by_key
from ...utils.clip_text import get_text_embeddings
from ..builder import MODELS, build_model
from ..default import batch_to_sparse_tensor
from .render.rays import safe_normalize
from .render.surface_models import RENDERERS

_MASK_SALT_HIGH = 2 ** 31 - 1


def _fnv_hash(coords: torch.Tensor) -> torch.Tensor:
    """FNV-1a 32-bit hash of (N, D) int coordinates, as int64 in [0, 2^32)
    (the JAX ``ops.hashing.fnv_hash`` with its uint32 wrap-around)."""
    mask32 = 0xFFFFFFFF
    x = coords.to(torch.int64) & mask32
    h = torch.full(coords.shape[:-1], 2166136261, dtype=torch.int64,
                   device=coords.device)
    for d in range(coords.shape[-1]):
        h = ((h ^ x[..., d]) * 16777619) & mask32
    return h


@MODELS.register_module(name="PonderIndoor-v2")
class PonderIndoor(nn.Module):
    def __init__(
        self,
        backbone=None,
        projection=None,
        renderer=None,
        mask: Optional[Dict[str, Any]] = None,
        grid_shape: Tuple[int, int, int] = (128, 128, 32),
        grid_size: float = 0.02,
        val_ray_split: int = 10240,
        assume_sorted: bool = False,
        ray_nsample: int = 256,
        padding: float = 0.1,
        pool_type: str = "mean",
        render_semantic: bool = True,
        conditions: Sequence[str] = ("ScanNet",),
        template: Any = "[x]",
        clip_model: str = "openai/clip-vit-base-patch16",
        class_name: Sequence[str] = (),
        valid_index: Sequence[Sequence[int]] = (),
        ppt_loss_weight: float = 0.0,
        ppt_criteria: Any = None,
        embedding_path: Optional[str] = None,
        image_scale: float = 1.0 / 255.0,
    ):
        super().__init__()
        del template, ppt_criteria  # unused, as in the JAX model
        self.mask = dict(mask) if mask else None
        self.grid_shape = tuple(grid_shape)
        self.grid_size = grid_size
        self.val_ray_split = val_ray_split
        self.assume_sorted = assume_sorted
        self.ray_nsample = ray_nsample
        self.padding = padding
        self.pool_type = pool_type
        self.render_semantic = render_semantic
        self.conditions = tuple(conditions)
        self.valid_index = tuple(tuple(v) for v in valid_index)
        self.ppt_loss_weight = ppt_loss_weight
        self.image_scale = image_scale

        self.backbone = build_model(dict(backbone))
        self.proj_net = build_model(dict(projection))
        rcfg = dict(renderer)
        self.renderer = RENDERERS.get(rcfg.pop("type", "NeuSModel"))(
            feature_dim=int(projection["out_channels"]), **rcfg)
        if render_semantic or ppt_loss_weight > 0:
            names = list(class_name) or [f"class_{i}" for i in range(20)]
            emb = get_text_embeddings(names, embedding_path=embedding_path,
                                      clip_model=clip_model)
            self.register_buffer("class_embedding", torch.from_numpy(np.asarray(emb)))
        else:
            self.class_embedding = None
        if ppt_loss_weight > 0:
            self.proj_head = nn.Linear(self.backbone.channels[-1], 512)
            self.logit_scale = nn.Parameter(torch.tensor(math.log(1.0 / 0.07)))
        if self.mask:
            self.mask_token = nn.Parameter(torch.zeros(int(self.mask.get("channel", 6))))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Seeded init in module order: backbone, projection, field, then the
        PPT head (lecun-normal, as flax Dense), logit scale log(1/0.07) and
        the mask token (normal, std 0.02)."""
        self.backbone.reset_parameters(generator)
        self.proj_net.reset_parameters(generator)
        self.renderer.reset_parameters(generator)
        with torch.no_grad():
            if self.ppt_loss_weight > 0:
                self.proj_head.weight.normal_(
                    0.0, self.proj_head.in_features ** -0.5, generator=generator)
                self.proj_head.bias.zero_()
                self.logit_scale.fill_(math.log(1.0 / 0.07))
            if self.mask:
                self.mask_token.normal_(0.0, 0.02, generator=generator)

    # ------------------------------------------------------------- draws
    def draw_noise(self, generator: torch.Generator, batch_size: int, views: int,
                   pixels: int) -> Dict[str, Any]:
        """The random draws of one training forward, from ``generator``."""
        dev = generator.device
        rays = views * self.ray_nsample
        return dict(
            ray_score=torch.rand((batch_size, views, pixels), generator=generator,
                                 device=dev),
            sampler=[torch.rand(s, generator=generator, device=dev)
                     for s in self.renderer.draw_shapes((batch_size, rays))],
            mask_salt=torch.randint(0, _MASK_SALT_HIGH, (), generator=generator,
                                    device=dev),
        )

    # -------------------------------------------------------------- masking
    def _apply_block_mask(self, feat, grid_coord, batch, salt):
        size = int(self.mask.get("size", 8))
        ratio = float(self.mask.get("ratio", 0.8))
        channel = int(self.mask.get("channel", feat.shape[-1]))
        block = torch.cat([batch[:, None].to(torch.int64),
                           torch.div(grid_coord.to(torch.int64), size,
                                     rounding_mode="floor")], 1)
        h = _fnv_hash(block)
        u = ((h ^ torch.as_tensor(salt, device=h.device).to(torch.int64)) % 10000
             ).float() / 10000.0
        masked = (u < ratio) & (batch >= 0)
        token = torch.cat([self.mask_token.expand(feat.shape[0], channel),
                           feat[:, channel:]], -1)
        return torch.where(masked[:, None], token, feat)

    # -------------------------------------------------------- normalization
    @staticmethod
    def _unit_cube_params(coord, batch, batch_size):
        """Per-scene (loc (B,3), scale (B,), z_shift (B,)) of the map
        p' = (p - loc) * scale + [0, 0, z_shift] (floor at z = -0.5)."""
        big = 1e9
        mins = segment_min(coord, batch, batch_size, initial=big)
        maxs = segment_max(coord, batch, batch_size, initial=-big)
        loc = (mins + maxs) / 2.0
        extent = (maxs - mins).amax(1)
        scale = 1.0 / torch.clamp(extent, min=1e-6)
        z_shift = -((mins[:, 2] - loc[:, 2]) * scale) - 0.5
        return loc, scale, z_shift

    @staticmethod
    def _normalize_points(coord, batch, loc, scale, z_shift):
        b = batch.clamp(min=0).to(torch.int64)
        p = (coord - loc[b]) * scale[b, None]
        p = p + torch.stack([torch.zeros_like(z_shift[b]), torch.zeros_like(z_shift[b]),
                             z_shift[b]], -1)
        return torch.clamp(p, -0.5 + 1e-5, 0.5 - 1e-5)

    # ------------------------------------------------------------ the volume
    def _build_volume(self, feat, p_norm, batch, batch_size):
        gx, gy, gz = self.grid_shape
        dims = p_norm.new_tensor([gx, gy, gz])
        vox = torch.floor((p_norm + 0.5) * dims).to(torch.int64)
        vox = torch.minimum(vox.clamp(min=0), (dims - 1).to(torch.int64))
        b = batch.clamp(min=0).to(torch.int64)
        flat = ((b * gx + vox[:, 0]) * gy + vox[:, 1]) * gz + vox[:, 2]
        num = batch_size * gx * gy * gz
        flat = torch.where(batch >= 0, flat, num)
        if self.pool_type == "mean":
            dense = segment_mean(feat, flat, num)
        else:
            dense = segment_max(feat, flat, num, initial=0.0)
        return dense.reshape(batch_size, gx, gy, gz, -1).permute(0, 4, 1, 2, 3)

    # ---------------------------------------------------------------- rays
    @staticmethod
    def _get_rays(intrinsic, extrinsic, H, W):
        """Per-view rays for every pixel: (origins (..., 3), dirs (..., H, W, 3),
        depth_factor (..., H, W)). All-zero camera matrices (padding scenes)
        become the identity, so that their inverse stays finite; their rays
        are masked downstream by depth <= 0."""
        def guard(m):
            degenerate = m.abs().sum((-2, -1), keepdim=True) < 1e-8
            eye = torch.eye(m.shape[-1], dtype=m.dtype, device=m.device).expand(m.shape)
            return torch.where(degenerate, eye, m)

        K = guard(intrinsic[..., :3, :3])
        pose = torch.linalg.inv(guard(extrinsic))  # cam2world
        R, t = pose[..., :3, :3], pose[..., :3, 3]
        gx, gy = torch.meshgrid(torch.arange(W, dtype=torch.float32, device=K.device),
                                torch.arange(H, dtype=torch.float32, device=K.device),
                                indexing="xy")
        pix = torch.stack([gx, gy, torch.ones_like(gx)], -1)  # (H, W, 3)
        d_cam = torch.einsum("...ij,hwj->...hwi", torch.linalg.inv(K), pix)
        d_norm = torch.linalg.norm(d_cam, dim=-1, keepdim=True)
        d_world = torch.einsum("...ij,...hwj->...hwi", R, d_cam / torch.clamp(d_norm, min=1e-8))
        cosang = torch.einsum("...hwi,...i->...hw", d_world, R[..., :, 2])
        return t, d_world, 1.0 / torch.clamp(cosang, min=1e-6)

    def _sample_rays(self, input_dict, loc, scale, z_shift, ray_score):
        rgb = input_dict["rgb"].float() * self.image_scale  # (B, V, H, W, 3)
        depth = input_dict["depth"].float()  # (B, V, H, W)
        B, V, H, W = depth.shape
        semantic = input_dict.get("semantic2d")
        origins, dirs, depth_factor = self._get_rays(
            input_dict["intrinsic"].float(), input_dict["extrinsic"].float(), H, W)
        flat_valid = (depth > 0).reshape(B, V, H * W)
        if ray_score is not None:
            # valid-first random picking of ray_nsample rays per view; a
            # stable descending sort breaks ties by lower index, as top_k
            n = self.ray_nsample
            score = ray_score + flat_valid.float() * 10.0
            pick = torch.sort(score, stable=True, dim=-1, descending=True).indices[..., :n]

            def take(x):
                x = x.reshape(B, V, H * W, -1)
                return x.gather(2, pick[..., None].expand(B, V, n, x.shape[-1]))

            sel_rgb = take(rgb)
            sel_depth = take(depth)[..., 0]
            sel_dirs = take(dirs)
            sel_dfac = take(depth_factor)[..., 0]
            sel_valid = take(flat_valid)[..., 0]
            sel_sem = take(semantic)[..., 0].to(torch.int64) if semantic is not None else None
        else:
            # eval renders every pixel; invalid pixels stay masked
            n = H * W
            sel_rgb = rgb.reshape(B, V, n, 3)
            sel_depth = depth.reshape(B, V, n)
            sel_dirs = dirs.reshape(B, V, n, 3)
            sel_dfac = depth_factor.reshape(B, V, n)
            sel_valid = flat_valid
            sel_sem = (semantic.reshape(B, V, n).to(torch.int64)
                       if semantic is not None else None)

        # into the unit cube: the uniform scale keeps directions
        o_norm = (origins - loc[:, None, :]) * scale[:, None, None]
        o_norm = o_norm + torch.stack([torch.zeros_like(o_norm[..., 0]),
                                       torch.zeros_like(o_norm[..., 0]),
                                       z_shift[:, None].expand(B, V)], -1)
        o_norm = o_norm[:, :, None, :].expand(sel_dirs.shape)
        t_gt = sel_depth * sel_dfac * scale[:, None, None]
        R = V * n
        ray_dict = dict(
            ray_o=o_norm.reshape(B, R, 3),
            ray_d=sel_dirs.reshape(B, R, 3),
            rgb=sel_rgb.reshape(B, R, 3),
            depth=torch.where(sel_valid, t_gt, torch.full_like(t_gt, -0.001)).reshape(B, R),
            ray_mask=sel_valid.reshape(B, R),
        )
        if sel_sem is not None:
            ray_dict["semantic"] = torch.where(sel_valid, sel_sem,
                                               torch.full_like(sel_sem, -1)).reshape(B, R)
        return ray_dict

    def _render_chunked(self, vol_cl, ray_o, ray_d):
        """Eval: ``val_ray_split`` rays at a time, outputs joined on the ray
        axis (per-render scalars such as inv_s are the same in every chunk)."""
        chunk = self.val_ray_split
        outs = [self.renderer(vol_cl, ray_o[:, c:c + chunk], ray_d[:, c:c + chunk])
                for c in range(0, ray_o.shape[1], chunk)]
        return {k: (outs[0][k] if outs[0][k].dim() <= 1
                    else torch.cat([o[k] for o in outs], 1)) for k in outs[0]}

    # --------------------------------------------------------------- forward
    def forward(self, input_dict: Dict[str, Any]) -> Dict[str, Any]:
        """Returns ``loss`` (the render losses + PPT), the detached loss terms
        and ``psnr``, ``contract_ok`` from the backbone, and at eval the
        ``render`` outputs (rgb, depth, normal, accumulation)."""
        train = self.training
        batch = input_dict["batch"]
        B = int(input_dict["batch_size"])
        B_, V, H, W = input_dict["depth"].shape
        draws = input_dict.get("draws")
        if draws is None and train:
            gen = input_dict.get("generator")
            if gen is None:
                gen = torch.Generator(device=batch.device).manual_seed(0)
            draws = self.draw_noise(gen, B_, V, H * W)

        st = batch_to_sparse_tensor(input_dict)
        if self.mask:
            salt = draws["mask_salt"] if draws is not None else 0
            st = st.replace_features(self._apply_block_mask(
                st.features, input_dict["grid_coord"], batch, salt))
        st_sorted, inverse = maybe_sort_by_key(st, self.assume_sorted)
        # host-built conv plans (engines/plan_prefetch.py), valid only where
        # the rows come sorted, so that host and device see one row order
        plans = input_dict.get("spunet_plans") if self.assume_sorted else None
        if plans is not None:
            sparse_feat, contract_ok = self.backbone(st_sorted, plans=plans)
        else:
            sparse_feat, contract_ok = self.backbone(st_sorted)
        if inverse is not None:
            sparse_feat = sparse_feat[inverse]

        coord = input_dict["coord"].float()
        loc, scale, z_shift = self._unit_cube_params(coord, batch, B)
        p_norm = self._normalize_points(coord, batch, loc, scale, z_shift)
        volume = self.proj_net(self._build_volume(sparse_feat, p_norm, batch, B))

        ray_dict = self._sample_rays(input_dict, loc, scale, z_shift,
                                     draws["ray_score"] if train else None)
        pad = 1.0 + self.padding
        ray_o = ray_dict["ray_o"] / pad + 0.5
        ray_d = ray_dict["ray_d"]
        vol_cl = self.renderer.field.volume_channels_last(volume)
        if not train and ray_o.shape[1] > self.val_ray_split:
            render_out = self._render_chunked(vol_cl, ray_o, ray_d)
        else:
            render_out = self.renderer(vol_cl, ray_o, ray_d,
                                       draws=draws["sampler"] if train else None)
        # sdf at the sparse input points (sparse-point sdf loss); the points
        # are split over the volume's batch axis by position, as the JAX
        # model reshapes them
        sp_points = p_norm / pad + 0.5
        render_out["sparse_sdf"] = self.renderer.field.get_sdf(vol_cl, sp_points[None])[0]
        render_out["sparse_sdf_mask"] = batch >= 0

        class_emb = self.class_embedding
        cond = input_dict.get("condition", self.conditions[0])
        if isinstance(cond, (list, tuple)):
            cond = cond[0]
        ci = self.conditions.index(cond) if cond in self.conditions else 0
        index2semantic = None
        if class_emb is not None:
            index2semantic = (class_emb[list(self.valid_index[ci])]
                              if self.valid_index else class_emb)
        targets = dict(ray_dict)
        targets["depth"] = torch.where(ray_dict["depth"] > 0, ray_dict["depth"] / pad,
                                       ray_dict["depth"])
        loss_dict = self.renderer.get_loss(render_out, targets,
                                           class_embeddings=index2semantic, train=train)
        out = dict(loss=loss_dict.pop("render_loss"))
        out.update({k: v.detach() for k, v in loss_dict.items()})

        if self.ppt_loss_weight > 0 and "segment" in input_dict:
            feat = safe_normalize(self.proj_head(sparse_feat))
            emb = safe_normalize(index2semantic)
            logits = feat @ emb.T * torch.exp(self.logit_scale)
            labels = input_dict["segment"]
            valid = (labels >= 0) & (batch >= 0)
            logp = torch.log_softmax(logits, -1)
            nll = -logp.gather(1, labels.clamp(min=0).to(torch.int64)[:, None])[:, 0]
            ppt = (nll * valid).sum() / torch.clamp(valid.sum(), min=1.0)
            out["ppt_loss"] = ppt.detach()
            out["loss"] = out["loss"] + self.ppt_loss_weight * ppt

        out["contract_ok"] = contract_ok
        if not train:
            out["render"] = {k: v for k, v in render_out.items()
                             if k in ("rgb", "depth", "normal", "accumulation")}
        return out
