"""PointGroup instance segmentation (PG-v1m1).

Counterpart of ``ponderv2_tpu/models/point_group/point_group.py`` (reference
``point_group_v1m1_base.py``). Train: backbone -> semantic head (the
criteria) + bias (offset) head, held by a masked L1 and a cosine-direction
loss toward the instance centroids. Eval: the forward gives semantic logits
and the predicted offsets; ``propose_instances`` clusters them on the host
(``cluster.cluster_proposals``) into proposals scored by mean class
probability. Module names: ``backbone.*``, ``bias_head.{0,2}``,
``seg_head``. Unlike the JAX model the output carries ``contract_ok``, and
a model given no ``criteria`` takes the reference's cross-entropy.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from ...ops.sparse import maybe_sort_by_key
from ..builder import MODELS, build_model
from ..default import batch_to_sparse_tensor
from ..losses import build_criteria
from ..point_prompt_training.ppt import _lecun_linear


@MODELS.register_module(name="PG-v1m1")
class PointGroup(nn.Module):
    def __init__(
        self,
        backbone=None,
        assume_sorted: bool = False,
        criteria=None,
        backbone_out_channels: int = 64,
        semantic_num_classes: int = 20,
        semantic_ignore_index: int = -1,
        segment_ignore_index: Tuple[int, ...] = (-1, 0, 1),
        instance_ignore_index: int = -1,
        cluster_thresh: float = 1.5,
        cluster_closed_points: int = 300,
        cluster_propose_points: int = 100,
        cluster_min_points: int = 50,
        cluster_dual_set: bool = False,
        voxel_size: float = 0.02,
    ):
        super().__init__()
        self.backbone = build_model(dict(backbone))
        # without criteria, the reference's semantic loss: cross-entropy at
        # semantic_ignore_index. The insseg-ppt configs name none for PG-v1m1
        # (theirs sit in the PPT-v1m1 backbone, unused in backbone_mode), and
        # the JAX model's empty criteria return the logits themselves, so
        # its loss there is not a scalar (ROADMAP Queue 3)
        self.criteria = build_criteria(criteria or [dict(
            type="CrossEntropyLoss", loss_weight=1.0, ignore_index=semantic_ignore_index)])
        self.assume_sorted = assume_sorted  # rows pre-sorted by collate_fn
        self.semantic_ignore_index = semantic_ignore_index
        self.segment_ignore_index = tuple(segment_ignore_index)
        self.instance_ignore_index = instance_ignore_index
        self.cluster_thresh = cluster_thresh
        # a ballquery buffer hint; the per-point neighbour cap is
        # cluster.NEIGHBOR_CAP, as in the JAX model
        self.cluster_closed_points = cluster_closed_points
        self.cluster_propose_points = cluster_propose_points
        self.cluster_min_points = cluster_min_points
        self.cluster_dual_set = cluster_dual_set
        self.voxel_size = voxel_size
        c = backbone_out_channels
        self.bias_head = nn.Sequential(nn.Linear(c, c), nn.ReLU(), nn.Linear(c, 3))
        self.seg_head = nn.Linear(c, semantic_num_classes)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Seeded init in module order: the backbone, then the heads."""
        self.backbone.reset_parameters(generator)
        for lin in (self.bias_head[0], self.bias_head[2], self.seg_head):
            _lecun_linear(lin, generator)

    def forward(self, input_dict: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """Returns ``seg_logits`` (N, K), ``bias_pred`` (N, 3) in input row
        order and ``contract_ok``; with ``segment`` in the batch also
        ``loss`` and the detached ``seg_loss``, and with ``instance`` and
        ``instance_centroid`` the detached ``bias_l1_loss`` and
        ``bias_cosine_loss``, which ``loss`` then adds."""
        st = batch_to_sparse_tensor(input_dict)
        if getattr(self.backbone, "takes_input_dict", False):
            # PPT-v1m1 in backbone_mode (the insseg-ppt configs): it reads
            # the batch, its condition included
            bout = self.backbone(input_dict)
            feat, contract_ok = bout["feat"], bout["contract_ok"]
        else:
            # rows sorted by voxel key: the band plans' windows rely on it
            st_sorted, inverse = maybe_sort_by_key(st, self.assume_sorted)
            feat, contract_ok = self.backbone(st_sorted)
            if inverse is not None:
                feat = feat[inverse]
        bias_pred = self.bias_head(feat)
        logits = self.seg_head(feat)
        mask = st.mask
        out: Dict[str, torch.Tensor] = {"seg_logits": logits, "bias_pred": bias_pred,
                                        "contract_ok": contract_ok}
        if "segment" not in input_dict:
            return out

        seg_loss = self.criteria(logits, input_dict["segment"], mask)
        instance = input_dict.get("instance")
        centroid = input_dict.get("instance_centroid")
        if instance is not None and centroid is not None:
            gt_bias = centroid.float() - input_dict["coord"].float()
            valid = ((instance != self.instance_ignore_index) & mask).float()
            nv = valid.sum().clamp_min(1.0)
            l1 = (bias_pred - gt_bias).abs().sum(-1)
            bias_l1_loss = (l1 * valid).sum() / nv
            pred_n = bias_pred / torch.linalg.vector_norm(
                bias_pred, dim=-1, keepdim=True).clamp_min(1e-8)
            gt_n = gt_bias / torch.linalg.vector_norm(
                gt_bias, dim=-1, keepdim=True).clamp_min(1e-8)
            cosine = -(pred_n * gt_n).sum(-1)
            bias_cosine_loss = (cosine * valid).sum() / nv
            out["bias_l1_loss"] = bias_l1_loss.detach()
            out["bias_cosine_loss"] = bias_cosine_loss.detach()
            loss = seg_loss + bias_l1_loss + bias_cosine_loss
        else:
            loss = seg_loss
        out["loss"] = loss
        out["seg_loss"] = seg_loss.detach()
        return out

    # ------------------------------------------------- host-side proposals
    def propose_instances(
        self,
        coord,
        seg_logits,
        bias_pred,
        batch,
    ):
        """Host-side: cluster into instance proposals (numpy in, numpy out).

        Returns list of dicts: {"mask", "cls", "score"} per proposal.
        """
        import numpy as np

        from .cluster import cluster_proposals

        coord = np.asarray(coord)
        logits = np.asarray(seg_logits)
        bias = np.asarray(bias_pred)
        batch = np.asarray(batch)
        probs = np.exp(logits - logits.max(-1, keepdims=True))
        probs = probs / probs.sum(-1, keepdims=True)
        classes = logits.argmax(-1)
        proposals = []
        for b in np.unique(batch[batch >= 0]):
            sel = batch == b
            valid = sel & ~np.isin(classes, self.segment_ignore_index)
            # reference protocol (point_group_v1m1_base.py:92-131): cluster
            # ONLY center_pred = (coord + bias) / voxel_size at radius
            # cluster_thresh — equivalent to unscaled coords at radius
            # cluster_thresh * voxel_size
            masks = cluster_proposals(
                coord,
                coord + bias,
                classes,
                valid,
                radius=self.cluster_thresh * self.voxel_size,
                min_points=self.cluster_min_points,
                dual_set=self.cluster_dual_set,
            )
            for m in masks:
                # reference keeps proposals with point count STRICTLY greater
                # (proposals_point_num > cluster_propose_points, line 144)
                if m.sum() <= self.cluster_propose_points:
                    continue
                # BFS components are label-uniform; the reference takes the
                # first member's class (line 141)
                cls = classes[np.argmax(m)]
                score = float(probs[m, cls].mean())
                proposals.append(dict(mask=m, cls=int(cls), score=score, batch=int(b)))
        return proposals
