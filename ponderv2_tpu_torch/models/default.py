"""Task wrappers: collated batch dict -> per-row or per-scene logits (and loss).

Counterpart of ``ponderv2_tpu/models/default.py`` (``batch_to_sparse_tensor``,
``DefaultSegmentor``, ``DefaultClassifier``). Train or eval is the module's
``training`` flag (``model.train()`` / ``model.eval()``), the JAX ``train``
argument.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

from ..ops.scatter import segment_mean
from ..ops.sparse import make_sparse_tensor, maybe_sort_by_key, sort_by_key
from .builder import MODELS, build_model
from .losses import build_criteria


def batch_to_sparse_tensor(input_dict: Dict[str, Any]):
    """SparseTensor from a collated batch: ``feat (N, C)``, ``grid_coord
    (N, 3)``, ``batch (N,)`` (padding -1) tensors, plus ints
    ``spatial_shape`` and ``batch_size``."""
    coords = torch.cat([input_dict["batch"][:, None].to(torch.int32),
                        input_dict["grid_coord"].to(torch.int32)], 1)
    return make_sparse_tensor(
        input_dict["feat"],
        coords,
        tuple(int(s) for s in input_dict["spatial_shape"]),
        int(input_dict["batch_size"]),
    )


@MODELS.register_module()
class DefaultSegmentor(nn.Module):
    def __init__(self, backbone=None, criteria=None, assume_sorted: bool = False):
        super().__init__()
        self.backbone = build_model(dict(backbone))
        self.criteria = build_criteria(criteria or [])
        self.assume_sorted = assume_sorted  # rows pre-sorted by collate_fn

    def reset_parameters(self, generator=None) -> None:
        self.backbone.reset_parameters(generator)

    def forward(self, input_dict: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """Returns ``seg_logits`` (N, num_classes) in input row order,
        ``contract_ok``, a () bool tensor (False means some conv plan broke
        its contract and that conv's output was zeroed), and ``loss`` when the
        batch carries ``segment``: the criteria on the logits in input row
        order, masked by the input rows' validity."""
        st = batch_to_sparse_tensor(input_dict)
        if getattr(self.backbone, "takes_input_dict", False):
            # a model as the backbone (PPT-v1m1 in backbone_mode, as the
            # ScanNet200 fine-tune config wraps it): it reads the input_dict
            bout = self.backbone(input_dict)
            seg_logits = bout.get("feat", bout.get("seg_logits"))
            contract_ok = bout["contract_ok"]
        else:
            # rows sorted by voxel key: the band plans' windows rely on it
            st_sorted, inverse = maybe_sort_by_key(st, self.assume_sorted)
            seg_logits, contract_ok = self.backbone(st_sorted)
            if inverse is not None:
                seg_logits = seg_logits[inverse]
        out = {"seg_logits": seg_logits, "contract_ok": contract_ok}
        if "segment" in input_dict:
            out["loss"] = self.criteria(seg_logits, input_dict["segment"], st.mask)
        return out


@MODELS.register_module()
class DefaultClassifier(nn.Module):
    """A backbone and a linear ``cls_head`` from ``backbone_embed_dim`` to
    ``num_classes``. A backbone that returns per-voxel rows (not a
    ``cls_mode`` one) is mean-pooled per scene first, as in JAX."""

    def __init__(self, backbone=None, criteria=None, num_classes: int = 40,
                 backbone_embed_dim: int = 256):
        super().__init__()
        self.backbone = build_model(dict(backbone))
        self.criteria = build_criteria(criteria or [])
        self.num_classes = num_classes
        self.cls_head = nn.Linear(backbone_embed_dim, num_classes)

    def reset_parameters(self, generator=None) -> None:
        self.backbone.reset_parameters(generator)
        with torch.no_grad():
            self.cls_head.weight.normal_(0.0, self.cls_head.in_features ** -0.5,
                                         generator=generator)
            self.cls_head.bias.zero_()

    def forward(self, input_dict: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """Returns ``cls_logits`` (B, num_classes), ``contract_ok``, and
        ``loss`` when the batch carries ``category``. Rows are sorted by
        voxel key for the band plans; a per-scene mean does not depend on
        the row order."""
        st, _ = sort_by_key(batch_to_sparse_tensor(input_dict))
        feat, contract_ok = self.backbone(st)
        if feat.dim() == 2 and feat.shape[0] == st.capacity:
            # per-voxel rows: pool per scene
            feat = segment_mean(feat, st.coords[:, 0], st.batch_size)
        cls_logits = self.cls_head(feat)
        out = {"cls_logits": cls_logits, "contract_ok": contract_ok}
        if "category" in input_dict:
            out["loss"] = self.criteria(cls_logits, input_dict["category"].reshape(-1), None)
        return out
