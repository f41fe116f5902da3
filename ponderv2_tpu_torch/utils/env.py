"""Seeding and determinism helpers (reference: ``ponder/utils/env.py:17-36``).

JAX is functionally deterministic by construction (explicit PRNG keys); what this
module standardises is host-side numpy/python RNG seeding and per-rank/worker seed
derivation so data augmentation streams differ across processes and workers.

``derive_seed`` is a copy of ``ponderv2_tpu/utils/env.py``'s; ``set_seed``
also seeds torch and, as the reference's does, makes cuDNN pick deterministic
algorithms, so that a step on the GPU gives the same bits run to run.
"""

from __future__ import annotations

import os
import random
from datetime import datetime
from typing import Optional

import numpy as np
import torch


def derive_seed(base_seed: int, *streams: int) -> int:
    """Deterministically derive a sub-seed from a base seed and stream ids."""
    with np.errstate(over="ignore"):
        seed = np.uint64(base_seed)
        for s in streams:
            # splitmix64-style mixing (wrapping uint64 arithmetic is intended)
            seed = np.uint64(seed + np.uint64(0x9E3779B97F4A7C15) + np.uint64(s))
            z = seed
            z = np.uint64((z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9))
            z = np.uint64((z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB))
            seed = np.uint64(z ^ (z >> np.uint64(31)))
    return int(seed % np.uint64(2**31))


def set_seed(seed: Optional[int] = None) -> int:
    """Seed python/numpy/torch RNGs and make cuDNN deterministic
    (``cudnn.deterministic``, no ``cudnn.benchmark``); returns the seed used."""
    if seed is None:
        seed = int(datetime.now().timestamp() * 1e6) % (2**31)
    random.seed(seed)
    np.random.seed(seed % (2**32 - 1))
    torch.manual_seed(seed)
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    os.environ["PYTHONHASHSEED"] = str(seed)
    return seed
