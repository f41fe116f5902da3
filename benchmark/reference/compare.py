"""The number a run's logits are judged by, program against the plain
reference."""

from __future__ import annotations

import numpy as np


def logit_gap(program: np.ndarray, reference: np.ndarray) -> float:
    """max |program - reference| / max |reference| over one input's logits."""
    if program.shape != reference.shape:
        return float("inf")
    scale = float(np.abs(reference).max())
    return float(np.abs(program.astype(np.float64) - reference).max()) / max(scale, 1e-30)
