"""Segmentor wrapper: collated batch dict -> per-row logits (and loss).

Counterpart of ``ponderv2_tpu/models/default.py`` (``batch_to_sparse_tensor``,
``DefaultSegmentor``). Train or eval is the module's ``training`` flag
(``model.train()`` / ``model.eval()``), the JAX ``train`` argument.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

from ..ops.sparse import make_sparse_tensor, maybe_sort_by_key
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
        # rows sorted by voxel key: the band plans' windows rely on it
        st_sorted, inverse = maybe_sort_by_key(st, self.assume_sorted)
        seg_logits, contract_ok = self.backbone(st_sorted)
        if inverse is not None:
            seg_logits = seg_logits[inverse]
        out = {"seg_logits": seg_logits, "contract_ok": contract_ok}
        if "segment" in input_dict:
            out["loss"] = self.criteria(seg_logits, input_dict["segment"], st.mask)
        return out
