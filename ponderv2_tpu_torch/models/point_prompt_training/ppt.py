"""Point Prompt Training: multi-dataset fine-tuning with language guidance.

Counterpart of ``ponderv2_tpu/models/point_prompt_training/ppt.py``
(reference ``point_prompt_training_v1m1_language_guided.py`` and
``point_prompt_training_v1m2_decoupled.py``). The batch's ``condition``, a
dataset name, selects a row of ``embedding_table`` (the context of the
SpUNet-v1m3 backbone's PDNorm) and, in PPT-v1m1, the dataset's
``valid_index`` into the frozen CLIP text embeddings the projected features
are scored against. Module names are the reference ones: ``backbone``,
``embedding_table``, ``proj_head``, ``logit_scale``, ``class_embedding``
(v1m1) and ``seg_heads.{i}`` (v1m2). A batch holds one condition: the first
scene's, when the collated batch lists one per scene.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ...ops.sparse import maybe_sort_by_key
from ...utils.clip_text import get_text_embeddings
from ..builder import MODELS, build_model
from ..default import batch_to_sparse_tensor
from ..losses import build_criteria
from ..ponder.render.rays import safe_norm, safe_normalize


class _PromptBase(nn.Module):
    """The backbone, its criteria and the per-condition context embedding."""

    takes_input_dict = True  # a segmentor wrapping it passes the batch dict

    def __init__(self, backbone, criteria, context_channels: int,
                 conditions: Sequence[str], assume_sorted: bool):
        super().__init__()
        self.backbone = build_model(dict(backbone))
        self.criteria = build_criteria(criteria or [])
        self.conditions = tuple(conditions)
        self.assume_sorted = assume_sorted  # rows pre-sorted by collate_fn
        self.embedding_table = nn.Embedding(len(self.conditions), context_channels)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Seeded init in module order: the backbone, the context embedding
        (normal, std 1, as flax's Embed), then the heads."""
        self.backbone.reset_parameters(generator)
        with torch.no_grad():
            self.embedding_table.weight.normal_(0.0, 1.0, generator=generator)
        self.reset_heads(generator)

    def reset_heads(self, generator: Optional[torch.Generator]) -> None:
        raise NotImplementedError

    def backbone_features(self, input_dict: Dict[str, Any]):
        """(condition index, features (N, C) in input row order, contract_ok,
        the input's SparseTensor)."""
        cond = input_dict.get("condition", self.conditions[0])
        if isinstance(cond, (list, tuple)):
            cond = cond[0]
        ci = self.conditions.index(cond) if cond in self.conditions else 0
        context = self.embedding_table.weight[ci]
        st = batch_to_sparse_tensor(input_dict)
        # rows sorted by voxel key: the band plans' windows rely on it
        st_sorted, inverse = maybe_sort_by_key(st, self.assume_sorted)
        # the backbone takes the condition by name, with its own index of it
        feat, contract_ok = self.backbone(st_sorted, condition=cond, context=context)
        if inverse is not None:
            feat = feat[inverse]
        return ci, feat, contract_ok, st

    def with_loss(self, input_dict, seg_logits, contract_ok, st) -> Dict[str, torch.Tensor]:
        out = {"seg_logits": seg_logits, "contract_ok": contract_ok}
        if "segment" in input_dict:
            out["loss"] = self.criteria(seg_logits, input_dict["segment"], st.mask)
        return out


def _lecun_linear(lin: nn.Linear, generator: Optional[torch.Generator]) -> None:
    with torch.no_grad():
        lin.weight.normal_(0.0, lin.in_features ** -0.5, generator=generator)
        lin.bias.zero_()


@MODELS.register_module(name="PPT-v1m1")
class PointPromptTraining(_PromptBase):
    """Language-guided PPT: logits are the cosine similarity of the
    projected features and the dataset's class text embeddings, times the
    learned ``exp(logit_scale)``. ``backbone_mode`` returns the features."""

    def __init__(
        self,
        backbone=None,
        criteria=None,
        backbone_out_channels: int = 96,
        context_channels: int = 256,
        conditions: Sequence[str] = ("Structured3D", "ScanNet", "S3DIS"),
        template: str = "[x]",
        clip_model: str = "openai/clip-vit-base-patch16",
        class_name: Sequence[str] = (),
        valid_index: Sequence[Sequence[int]] = (),
        backbone_mode: bool = False,
        assume_sorted: bool = False,
        embedding_path: Optional[str] = None,
    ):
        super().__init__(backbone, criteria, context_channels, conditions, assume_sorted)
        del template  # unused, as in the JAX model
        self.valid_index = tuple(tuple(v) for v in valid_index)
        self.backbone_mode = backbone_mode
        if not backbone_mode:
            emb = get_text_embeddings(list(class_name), embedding_path=embedding_path,
                                      clip_model=clip_model)
            self.register_buffer("class_embedding", torch.from_numpy(np.asarray(emb)))
            self.proj_head = nn.Linear(backbone_out_channels, 512)
            self.logit_scale = nn.Parameter(torch.tensor(math.log(1.0 / 0.07)))

    def reset_heads(self, generator: Optional[torch.Generator]) -> None:
        if not self.backbone_mode:
            _lecun_linear(self.proj_head, generator)
            with torch.no_grad():
                self.logit_scale.fill_(math.log(1.0 / 0.07))

    def forward(self, input_dict: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """``seg_logits`` (N, len(valid_index[ci])) in input row order,
        ``contract_ok``, and ``loss`` when the batch carries ``segment``
        (``feat`` and ``contract_ok`` in ``backbone_mode``)."""
        ci, feat, contract_ok, st = self.backbone_features(input_dict)
        if self.backbone_mode:
            return {"feat": feat, "contract_ok": contract_ok}
        emb = self.class_embedding
        if self.valid_index:
            emb = emb[torch.as_tensor(self.valid_index[ci], device=emb.device)]
        # normalize(proj) @ emb^T, with the row norms divided out after the
        # product: the same function without a normalized (N, 512) copy
        proj = self.proj_head(feat)
        seg_logits = ((proj @ safe_normalize(emb).T) / safe_norm(proj, keepdim=True)
                      * torch.exp(self.logit_scale))
        return self.with_loss(input_dict, seg_logits, contract_ok, st)


@MODELS.register_module(name="PPT-v1m2")
class PointPromptTrainingDecoupled(_PromptBase):
    """Decoupled PPT: one linear segmentation head per condition (no CLIP)."""

    def __init__(
        self,
        backbone=None,
        criteria=None,
        backbone_out_channels: int = 96,
        context_channels: int = 256,
        conditions: Sequence[str] = ("Structured3D", "ScanNet", "S3DIS"),
        num_classes: Sequence[int] = (25, 20, 13),
        assume_sorted: bool = False,
    ):
        super().__init__(backbone, criteria, context_channels, conditions, assume_sorted)
        self.seg_heads = nn.ModuleList(
            nn.Linear(backbone_out_channels, n) for n in num_classes)

    def reset_heads(self, generator: Optional[torch.Generator]) -> None:
        for head in self.seg_heads:
            _lecun_linear(head, generator)

    def forward(self, input_dict: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        ci, feat, contract_ok, st = self.backbone_features(input_dict)
        return self.with_loss(input_dict, self.seg_heads[ci](feat), contract_ok, st)
