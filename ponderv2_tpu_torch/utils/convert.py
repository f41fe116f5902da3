"""JAX SpUNet-v1m1 variables -> the reference PyTorch state_dict (numpy only).

The inverse of ``tools/convert_torch_checkpoint.py:convert_spunet_v1m1``
(with ``scan_blocks=True``): it unstacks the ``nn.scan`` leading block axis
and restores the reference module names and layouts, which are the port's
``SpUNet`` names:

- conv kernels ``(K^3, Cin, Cout)`` -> ``(k, k, k, Cin, Cout)``;
- BN ``scale/bias`` + ``mean/var`` -> ``weight/bias/running_mean/running_var``;
- the block shortcut ``proj`` Dense ``(Cin, Cout)`` -> ``proj.0.weight``
  ``(1, 1, 1, Cin, Cout)`` and ``proj_bn`` -> ``proj.1.*``;
- ``final`` Dense ``(in, out)`` -> torch Linear ``(out, in)``;
- decoder step ``s`` -> module index ``ref = num_stages - 1 - s``.
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence

import numpy as np


def _kernel(k: np.ndarray) -> np.ndarray:
    k3, cin, cout = k.shape
    side = round(k3 ** (1.0 / 3.0))
    assert side ** 3 == k3, k.shape
    return np.asarray(k).reshape(side, side, side, cin, cout)


def _bn(out: Dict[str, np.ndarray], name: str, p: Mapping, s: Mapping) -> None:
    out[f"{name}.weight"] = np.asarray(p["scale"])
    out[f"{name}.bias"] = np.asarray(p["bias"])
    out[f"{name}.running_mean"] = np.asarray(s["mean"])
    out[f"{name}.running_var"] = np.asarray(s["var"])


def _block(out, name, p, s) -> None:
    out[f"{name}.conv1.weight"] = _kernel(p["conv1"]["kernel"])
    _bn(out, f"{name}.bn1", p["bn1"], s["bn1"])
    out[f"{name}.conv2.weight"] = _kernel(p["conv2"]["kernel"])
    _bn(out, f"{name}.bn2", p["bn2"], s["bn2"])
    if "proj" in p:
        w = np.asarray(p["proj"]["kernel"])
        out[f"{name}.proj.0.weight"] = w.reshape(1, 1, 1, *w.shape)
        _bn(out, f"{name}.proj.1", p["proj_bn"], s["proj_bn"])


def _unstack(tree, i):
    if isinstance(tree, Mapping):
        return {k: _unstack(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def state_dict_from_jax_spunet(params: Mapping, batch_stats: Mapping,
                               channels: Sequence[int],
                               layers: Sequence[int]) -> Dict[str, np.ndarray]:
    """``params``/``batch_stats``: the JAX SpUNet-v1m1 collections (numpy
    leaves), as ``convert_spunet_v1m1`` produces them. Returns the reference
    state_dict of numpy arrays."""
    num_stages = len(layers) // 2
    out: Dict[str, np.ndarray] = {}
    out["conv_input.0.weight"] = _kernel(params["stem"]["conv"]["kernel"])
    _bn(out, "conv_input.1", params["stem"]["bn"], batch_stats["stem"]["bn"])
    for s in range(num_stages):
        out[f"down.{s}.0.weight"] = _kernel(params[f"down{s}"]["conv"]["kernel"])
        _bn(out, f"down.{s}.1", params[f"down{s}"]["bn"],
            batch_stats[f"down{s}"]["bn"])
        p = params[f"enc{s}_blocks"]["blocks"]
        st = batch_stats[f"enc{s}_blocks"]["blocks"]
        for b in range(layers[s]):
            _block(out, f"enc.{s}.block{b}", _unstack(p, b), _unstack(st, b))
    for s in range(num_stages):
        ref = num_stages - 1 - s
        out[f"up.{ref}.0.weight"] = _kernel(params[f"up{s}"]["conv"]["kernel"])
        _bn(out, f"up.{ref}.1", params[f"up{s}"]["bn"], batch_stats[f"up{s}"]["bn"])
        _block(out, f"dec.{ref}.block0", params[f"dec{s}_block0"],
               batch_stats[f"dec{s}_block0"])
        for b in range(1, layers[num_stages + s]):
            _block(out, f"dec.{ref}.block{b}",
                   _unstack(params[f"dec{s}_blocks"]["blocks"], b - 1),
                   _unstack(batch_stats[f"dec{s}_blocks"]["blocks"], b - 1))
    if "final" in params:
        out["final.weight"] = np.asarray(params["final"]["kernel"]).T
        out["final.bias"] = np.asarray(params["final"]["bias"])
    return out
