"""Seeded weights, made on the device in a few large calls.

The benchmark makes the weights itself from ``--seed`` and hands the same
tensors to the program (as a state dict) and to the plain reference.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch


def seeded_params(specs: List[Tuple[str, Tuple[int, ...], str]], seed: int,
                  device) -> Dict[str, torch.Tensor]:
    """f32 tensors for ``(name, shape, init)`` specs: ``conv`` uniform in
    +-sqrt(1 / fan_in) (fan_in: every dim but the last), ``normal``
    N(0, 1 / fan_in) (fan_in: the last dim of a 2-d ``(out, in)`` weight, else
    every dim but the last), ``one`` and ``zero``. One uniform and one
    normal draw serve all leaves."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def fan_in(shape, init):
        if init == "normal" and len(shape) == 2:
            return shape[1]
        return math.prod(shape[:-1])

    sizes = {kind: sum(math.prod(s) for _, s, i in specs if i == kind)
             for kind in ("conv", "normal")}
    draws = {"conv": torch.rand(sizes["conv"], generator=gen, device=device),
             "normal": torch.randn(sizes["normal"], generator=gen, device=device)}
    at = {"conv": 0, "normal": 0}
    out = {}
    for name, shape, init in specs:
        n = math.prod(shape)
        if init in draws:
            chunk = draws[init][at[init]:at[init] + n].reshape(shape)
            at[init] += n
            scale = fan_in(shape, init) ** -0.5
            out[name] = (chunk * 2.0 - 1.0) * scale if init == "conv" else chunk * scale
        else:
            fill = 1.0 if init == "one" else 0.0
            out[name] = torch.full(shape, fill, dtype=torch.float32, device=device)
    return out
