"""S3DIS semantic-segmentation dataset.

Copies of ``S3DIS_CLASS_NAMES`` and ``S3DISDataset`` from
``ponderv2_tpu/datasets/s3dis.py`` with only the import lines changed (see
``transform.py`` for why they are copies): area-split rooms stored as
``.pth`` dicts under ``{data_root}/{split}/``. The RGB-D pretraining variant
is not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from .builder import DATASETS
from .defaults import DefaultDataset

S3DIS_CLASS_NAMES = (
    "ceiling", "floor", "wall", "beam", "column", "window", "door", "table",
    "chair", "sofa", "bookcase", "board", "clutter",
)


@DATASETS.register_module()
class S3DISDataset(DefaultDataset):
    """Area-split rooms stored as .pth dicts (coord/color/normal/segment/instance)."""

    def get_data(self, idx: int) -> Dict[str, Any]:
        data = super().get_data(idx)
        out = dict(
            coord=np.asarray(data["coord"], np.float32),
            color=np.asarray(
                data.get("color", np.zeros_like(data["coord"])), np.float32
            ),
        )
        if "normal" in data:
            out["normal"] = np.asarray(data["normal"], np.float32)
        for src, dst in (("semantic_gt", "segment"), ("segment", "segment"),
                         ("instance_gt", "instance"), ("instance", "instance")):
            if src in data and dst not in out:
                out[dst] = np.asarray(data[src]).reshape(-1).astype(np.int64)
        out.setdefault("segment", np.full(out["coord"].shape[0], -1, np.int64))
        out.setdefault("instance", np.full(out["coord"].shape[0], -1, np.int64))
        return out
