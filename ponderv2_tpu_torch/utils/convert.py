"""JAX variables -> the reference PyTorch state_dict (numpy only).

``state_dict_from_jax_spunet`` is the inverse of
``tools/convert_torch_checkpoint.py:convert_spunet_v1m1`` (with
``scan_blocks=True``): it unstacks the ``nn.scan`` leading block axis and
restores the reference module names and layouts, which are the port's
``SpUNet`` names:

- conv kernels ``(K^3, Cin, Cout)`` -> ``(k, k, k, Cin, Cout)``;
- BN ``scale/bias`` + ``mean/var`` -> ``weight/bias/running_mean/running_var``;
- the block shortcut ``proj`` Dense ``(Cin, Cout)`` -> ``proj.0.weight``
  ``(1, 1, 1, Cin, Cout)`` and ``proj_bn`` -> ``proj.1.*``;
- ``final`` Dense ``(in, out)`` -> torch Linear ``(out, in)``;
- decoder step ``s`` -> module index ``ref = num_stages - 1 - s``.

``state_dict_from_jax_ponder_indoor`` inverts ``convert_ponder_indoor``
(with ``convert_unet3d_v1m2`` and ``convert_residual_decoder``) for the
port's ``PonderIndoor-v2``: the backbone as above, UNet3D-v1m2 conv kernels
``(kx, ky, kz, in, out)`` -> torch ``Conv3d`` ``(out, in, kx, ky, kz)``,
transposed-conv kernels ``(kx, ky, kz, out, in)`` -> ``ConvTranspose3d``
``(in, out, kx, ky, kz)``, Dense kernels -> ``nn.Linear`` weights, and the
``constants`` collection's CLIP ``class_embedding``.

``state_dict_from_jax_spunet_v1m3`` and ``state_dict_from_jax_ppt_v1m1``
invert ``convert_spunet_v1m3`` and ``convert_ppt_v1m1`` for the port's
``SpUNet-v1m3`` and ``PPT-v1m1``: the flat ``stem_conv`` / ``down{s}`` /
``up{s}`` kernels -> ``conv_input.conv`` / ``down.{s}.conv`` /
``up.{ref}.conv``, every PDNorm's ``bn_{cond}`` -> ``bns.{i}`` in
``conditions`` order (or ``bn``), its ``modulation`` Dense -> the Linear
``modulation.1``, the block shortcut ``proj`` / ``proj_bn`` ->
``proj_conv`` / ``proj_norm``, ``context.embedding`` ->
``embedding_table.weight``, and ``constants.class_embedding`` -> the buffer;
in ``cls_mode`` there is no decoder, and ``final`` where the model has one.
A VolSDF renderer's ``laplace_density.beta`` goes across with the field.

``state_dict_from_jax_ponder_outdoor`` does PonderOutdoor-v2: the backbone
as above, SimpleConv3D's conv and BatchNorm, the render field as in
PonderIndoor-v2, and the mask token ``mtoken``.

``state_dict_from_jax_point_group`` does PG-v1m1: its backbone through the
SpUNet-v1m1 or PPT-v1m1 converter above, its heads' Dense kernels ->
``nn.Linear`` weights.

``state_dict_from_jax_mink_unet`` does the MinkUNet family (basic and
bottleneck blocks, scanned or not) into the reference names
(``conv0p1s1``, ``bn0``, ``conv{s+1}p{2^s}s2``, ``bntr{4+s}``,
``block{i}.{b}.{conv,norm}{1,2,3}``, ``downsample.{0,1}``; the Dense 1x1
convs as ``(1, 1, 1, Cin, Cout)`` kernels), ``state_dict_from_jax_spunet_noskip``
SpUNetNoSkipBase into SpUNet-v1m1's names, and
``state_dict_from_jax_classifier`` a DefaultClassifier: its backbone by the
converter of its type (SpUNet-v1m1 / v1m2 in ``cls_mode`` or not,
SpUNetNoSkipBase, a MinkUNet) and ``cls_head``.
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
    for s in range(num_stages if "up0" in params else 0):  # none in cls_mode
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


def _dense(out, name, p) -> None:
    out[f"{name}.weight"] = np.asarray(p["kernel"]).T
    out[f"{name}.bias"] = np.asarray(p["bias"])


def _unet3d_v1m2(out, prefix, p, s, num_levels: int) -> None:
    def conv3d(k):
        return np.transpose(np.asarray(k), (4, 3, 0, 1, 2))

    def single(name, bp, bs):
        _bn(out, f"{name}.batchnorm", bp["batchnorm"], bs["batchnorm"])
        out[f"{name}.conv.weight"] = conv3d(bp["conv"]["kernel"])

    for i in range(num_levels):
        single(f"{prefix}.encoders.{i}.basic_module", p[f"enc{i}"], s[f"enc{i}"])
    for i in range(num_levels - 1):
        up = p[f"dec{i}_up"]
        # (kx, ky, kz, out, in) -> (in, out, kx, ky, kz): the same axis order
        out[f"{prefix}.decoders.{i}.upsampling.upsample.weight"] = conv3d(up["kernel"])
        out[f"{prefix}.decoders.{i}.upsampling.upsample.bias"] = np.asarray(up["bias"])
        single(f"{prefix}.decoders.{i}.basic_module", p[f"dec{i}"], s[f"dec{i}"])
    out[f"{prefix}.final_conv.weight"] = conv3d(p["final"]["kernel"])
    out[f"{prefix}.final_conv.bias"] = np.asarray(p["final"]["bias"])


def _residual_decoder(out, prefix, p) -> None:
    _dense(out, f"{prefix}.fc_p", p["fc_p"])
    l = 0
    while f"lin{l}" in p:
        _dense(out, f"{prefix}.lin{l}", p[f"lin{l}"])
        _dense(out, f"{prefix}.fc_c.{l}", p[f"fc_c{l}"])
        l += 1


def _render_field(out, prefix, field) -> None:
    for name in ("sdf_decoder", "rgb_decoder", "semantic_decoder"):
        if name in field:
            _residual_decoder(out, f"{prefix}.{name}", field[name])
    out[f"{prefix}.deviation_network.variance"] = np.asarray(
        field["deviation_network"]["variance"], np.float32).reshape(())


def _render_model(out, prefix, render_model) -> None:
    """The renderer's field and, for VolSDF, its ``laplace_density`` beta."""
    _render_field(out, f"{prefix}.field", render_model["field"])
    if "laplace_density" in render_model:
        out[f"{prefix}.laplace_density.beta"] = np.asarray(
            render_model["laplace_density"]["beta"], np.float32).reshape(())


def state_dict_from_jax_ponder_indoor(variables: Mapping, channels: Sequence[int],
                                      layers: Sequence[int],
                                      num_levels: int = 4) -> Dict[str, np.ndarray]:
    """``variables``: the JAX PonderIndoor-v2 collections ``params``,
    ``batch_stats`` and (optionally) ``constants``, with numpy leaves.
    Returns the port's state_dict of numpy arrays."""
    params, stats = variables["params"], variables["batch_stats"]
    out: Dict[str, np.ndarray] = {}
    for k, v in state_dict_from_jax_spunet(params["backbone_net"], stats["backbone_net"],
                                           channels, layers).items():
        out[f"backbone.{k}"] = v
    _unet3d_v1m2(out, "proj_net", params["proj_net"], stats["proj_net"], num_levels)
    _render_model(out, "renderer", params["render_model"])
    if "proj_head" in params:
        _dense(out, "proj_head", params["proj_head"])
        out["logit_scale"] = np.asarray(params["logit_scale"], np.float32).reshape(())
    if "mask_token" in params:
        out["mask_token"] = np.asarray(params["mask_token"])
    constants = variables.get("constants") or {}
    if "class_embedding" in constants:
        out["class_embedding"] = np.asarray(constants["class_embedding"])
    return out


def _pdnorm(out, name, p, s, conditions) -> None:
    if "bn" in p:  # decouple=False
        _bn(out, f"{name}.bn", p["bn"], s["bn"])
    else:
        for i, c in enumerate(conditions):
            _bn(out, f"{name}.bns.{i}", p[f"bn_{c}"], s[f"bn_{c}"])
    if "modulation" in p:
        _dense(out, f"{name}.modulation.1", p["modulation"])


def _pd_block(out, name, p, s, conditions) -> None:
    out[f"{name}.conv1.weight"] = _kernel(p["conv1"]["kernel"])
    _pdnorm(out, f"{name}.bn1", p["bn1"], s["bn1"], conditions)
    out[f"{name}.conv2.weight"] = _kernel(p["conv2"]["kernel"])
    _pdnorm(out, f"{name}.bn2", p["bn2"], s["bn2"], conditions)
    if "proj" in p:
        w = np.asarray(p["proj"]["kernel"])
        out[f"{name}.proj_conv.weight"] = w.reshape(1, 1, 1, *w.shape)
        _pdnorm(out, f"{name}.proj_norm", p["proj_bn"], s["proj_bn"], conditions)


def _block_tree(params, stats, prefix, b, first):
    """Block ``b`` of a stage: scanned (``{prefix}_blocks``, stacked from
    block ``first``) or standalone (``{prefix}_block{b}``)."""
    if f"{prefix}_block{b}" in params:
        return params[f"{prefix}_block{b}"], stats[f"{prefix}_block{b}"]
    return (_unstack(params[f"{prefix}_blocks"]["blocks"], b - first),
            _unstack(stats[f"{prefix}_blocks"]["blocks"], b - first))


def state_dict_from_jax_spunet_v1m3(params: Mapping, batch_stats: Mapping,
                                    layers: Sequence[int],
                                    conditions: Sequence[str]) -> Dict[str, np.ndarray]:
    """``params``/``batch_stats``: the JAX SpUNet-v1m3 collections (numpy
    leaves), scanned or not; ``conditions`` the backbone's own order.
    Returns the reference state_dict of numpy arrays."""
    num_stages = len(layers) // 2
    out: Dict[str, np.ndarray] = {}
    out["conv_input.conv.weight"] = _kernel(params["stem_conv"]["kernel"])
    _pdnorm(out, "conv_input.bn", params["stem_bn"], batch_stats["stem_bn"], conditions)
    for s in range(num_stages):
        out[f"down.{s}.conv.weight"] = _kernel(params[f"down{s}"]["kernel"])
        _pdnorm(out, f"down.{s}.bn", params[f"down{s}_bn"], batch_stats[f"down{s}_bn"],
                conditions)
        for b in range(layers[s]):
            _pd_block(out, f"enc.{s}.block{b}",
                      *_block_tree(params, batch_stats, f"enc{s}", b, 0), conditions)
    for s in range(num_stages if "up0" in params else 0):  # none in cls_mode
        ref = num_stages - 1 - s
        out[f"up.{ref}.conv.weight"] = _kernel(params[f"up{s}"]["kernel"])
        _pdnorm(out, f"up.{ref}.bn", params[f"up{s}_bn"], batch_stats[f"up{s}_bn"],
                conditions)
        for b in range(layers[num_stages + s]):
            _pd_block(out, f"dec.{ref}.block{b}",
                      *_block_tree(params, batch_stats, f"dec{s}", b, 1), conditions)
    if "final" in params:
        _dense(out, "final", params["final"])
    return out


def state_dict_from_jax_ppt_v1m1(variables: Mapping, layers: Sequence[int],
                                 conditions: Sequence[str]) -> Dict[str, np.ndarray]:
    """``variables``: the JAX PPT-v1m1 collections ``params``,
    ``batch_stats`` and (optionally) ``constants``, with numpy leaves;
    ``conditions`` the backbone's order. Returns the port's state_dict of
    numpy arrays."""
    params, stats = variables["params"], variables["batch_stats"]
    out: Dict[str, np.ndarray] = {
        f"backbone.{k}": v for k, v in state_dict_from_jax_spunet_v1m3(
            params["backbone_net"], stats["backbone_net"], layers, conditions).items()}
    out["embedding_table.weight"] = np.asarray(params["context"]["embedding"])
    if "proj_head" in params:
        _dense(out, "proj_head", params["proj_head"])
        out["logit_scale"] = np.asarray(params["logit_scale"], np.float32).reshape(())
    constants = variables.get("constants") or {}
    if "class_embedding" in constants:
        out["class_embedding"] = np.asarray(constants["class_embedding"])
    return out


def state_dict_from_jax_point_group(variables: Mapping,
                                    backbone: Mapping) -> Dict[str, np.ndarray]:
    """``variables``: the JAX PG-v1m1 collections ``params``,
    ``batch_stats`` (and ``constants``) with numpy leaves; ``backbone`` its
    backbone's config: SpUNet-v1m1, or PPT-v1m1 over SpUNet-v1m3. Returns
    the port's state_dict of numpy arrays: the backbone's (by its converter)
    under ``backbone.``, the offset head's two Dense layers as
    ``bias_head.0`` / ``bias_head.2`` and ``seg_head``, kernels transposed
    into ``Linear.weight``."""
    params, stats = variables["params"], variables["batch_stats"]
    if backbone["type"] == "PPT-v1m1":
        inner = {"params": params["backbone_net"], "batch_stats": stats["backbone_net"],
                 "constants": (variables.get("constants") or {}).get("backbone_net") or {}}
        v1m3 = backbone["backbone"]
        bb = state_dict_from_jax_ppt_v1m1(inner, v1m3["layers"], v1m3["conditions"])
    else:
        bb = state_dict_from_jax_spunet(params["backbone_net"], stats["backbone_net"],
                                        backbone["channels"], backbone["layers"])
    out: Dict[str, np.ndarray] = {f"backbone.{k}": v for k, v in bb.items()}
    _dense(out, "bias_head.0", params["bias_head"]["layers_0"])
    _dense(out, "bias_head.2", params["bias_head"]["layers_2"])
    _dense(out, "seg_head", params["seg_head"])
    return out


def state_dict_from_jax_ponder_outdoor(variables: Mapping, channels: Sequence[int],
                                       layers: Sequence[int]) -> Dict[str, np.ndarray]:
    """``variables``: the JAX PonderOutdoor-v2 collections ``params``,
    ``batch_stats`` and (optionally) ``constants``, with numpy leaves.
    Returns the port's state_dict of numpy arrays: the SpUNet-v1m1 backbone
    (``in_channels`` 4 on nuScenes) under ``backbone.``; SimpleConv3D's conv
    kernel ``(kx, ky, kz, in, out)`` -> ``proj_net.conv.weight`` ``(out, in,
    kx, ky, kz)`` and its BatchNorm -> ``proj_net.batchnorm.*``; the render
    field's decoders (sdf, and rgb / semantic where the config has them)
    and variance under ``renderer.field.``; the mask token ``mtoken`` (1, C)
    and the CLIP ``class_embedding``."""
    params, stats = variables["params"], variables["batch_stats"]
    out: Dict[str, np.ndarray] = {
        f"backbone.{k}": v for k, v in state_dict_from_jax_spunet(
            params["backbone_net"], stats["backbone_net"], channels, layers).items()}
    proj, proj_stats = params["proj_net"], stats["proj_net"]
    out["proj_net.conv.weight"] = np.transpose(np.asarray(proj["conv"]["kernel"]),
                                               (4, 3, 0, 1, 2))
    out["proj_net.conv.bias"] = np.asarray(proj["conv"]["bias"])
    _bn(out, "proj_net.batchnorm", proj["batchnorm"], proj_stats["batchnorm"])
    _render_model(out, "renderer", params["render_model"])
    if "mtoken" in params:
        out["mtoken"] = np.asarray(params["mtoken"])
    constants = variables.get("constants") or {}
    if "class_embedding" in constants:
        out["class_embedding"] = np.asarray(constants["class_embedding"])
    return out


def _proj(out, name, p) -> None:
    """A Dense kernel (Cin, Cout) as a 1x1x1 conv kernel (1, 1, 1, Cin, Cout)."""
    w = np.asarray(p["kernel"])
    out[name] = w.reshape(1, 1, 1, *w.shape)


def _mink_block(out, name, p, s) -> None:
    """A JAX MinkUNet BasicBlock / Bottleneck into the reference names."""
    if np.asarray(p["conv1"]["kernel"]).ndim == 2:  # Bottleneck: 1x1 -> k3 -> 1x1
        _proj(out, f"{name}.conv1.weight", p["conv1"])
        out[f"{name}.conv2.weight"] = _kernel(p["conv2"]["kernel"])
        _proj(out, f"{name}.conv3.weight", p["conv3"])
        _bn(out, f"{name}.norm3", p["bn3"], s["bn3"])
    else:
        out[f"{name}.conv1.weight"] = _kernel(p["conv1"]["kernel"])
        out[f"{name}.conv2.weight"] = _kernel(p["conv2"]["kernel"])
    _bn(out, f"{name}.norm1", p["bn1"], s["bn1"])
    _bn(out, f"{name}.norm2", p["bn2"], s["bn2"])
    if "proj" in p:
        _proj(out, f"{name}.downsample.0.weight", p["proj"])
        _bn(out, f"{name}.downsample.1", p["proj_bn"], s["proj_bn"])


def state_dict_from_jax_mink_unet(params: Mapping, batch_stats: Mapping,
                                  layers: Sequence[int]) -> Dict[str, np.ndarray]:
    """``params``/``batch_stats``: a JAX MinkUNet's collections (numpy
    leaves), its blocks scanned (``{prefix}_blocks``, stacked after the
    decoder's standalone ``{prefix}_b0``) or not (``{prefix}_b{b}``).
    Returns the port's ``MinkUNetBase`` state_dict of numpy arrays."""
    ns = len(layers) // 2
    out: Dict[str, np.ndarray] = {}
    out["conv0p1s1.weight"] = _kernel(params["stem"]["kernel"])
    _bn(out, "bn0", params["stem_bn"], batch_stats["stem_bn"])

    def blocks(prefix, module, n_blocks):
        for b in range(n_blocks):
            if f"{prefix}_b{b}" in params:
                p, st = params[f"{prefix}_b{b}"], batch_stats[f"{prefix}_b{b}"]
            else:  # scanned from the first block that is not standalone
                first = int(f"{prefix}_b0" in params)
                p = _unstack(params[f"{prefix}_blocks"]["blocks"], b - first)
                st = _unstack(batch_stats[f"{prefix}_blocks"]["blocks"], b - first)
            _mink_block(out, f"{module}.{b}", p, st)

    for s in range(ns):
        out[f"conv{s + 1}p{2 ** s}s2.weight"] = _kernel(params[f"down{s}"]["kernel"])
        _bn(out, f"bn{s + 1}", params[f"down{s}_bn"], batch_stats[f"down{s}_bn"])
        blocks(f"enc{s}", f"block{s + 1}", layers[s])
    for s in range(ns):
        out[f"convtr{ns + s}p{2 ** (ns - s)}s2.weight"] = _kernel(params[f"up{s}"]["kernel"])
        _bn(out, f"bntr{ns + s}", params[f"up{s}_bn"], batch_stats[f"up{s}_bn"])
        blocks(f"dec{s}", f"block{ns + 1 + s}", layers[ns + s])
    if "final" in params:
        _dense(out, "final", params["final"])
    return out


def state_dict_from_jax_spunet_noskip(params: Mapping, batch_stats: Mapping,
                                      layers: Sequence[int]) -> Dict[str, np.ndarray]:
    """``params``/``batch_stats``: the JAX SpUNetNoSkipBase collections
    (numpy leaves). Returns the port's state_dict (SpUNet-v1m1's names)."""
    ns = len(layers) // 2
    out: Dict[str, np.ndarray] = {}
    out["conv_input.0.weight"] = _kernel(params["stem_conv"]["kernel"])
    _bn(out, "conv_input.1", params["stem_bn"], batch_stats["stem_bn"])
    for s in range(ns):
        out[f"down.{s}.0.weight"] = _kernel(params[f"down{s}"]["kernel"])
        _bn(out, f"down.{s}.1", params[f"down{s}_bn"], batch_stats[f"down{s}_bn"])
        for b in range(layers[s]):
            _block(out, f"enc.{s}.block{b}", params[f"enc{s}_block{b}"],
                   batch_stats[f"enc{s}_block{b}"])
    for s in range(ns):
        ref = ns - 1 - s
        out[f"up.{ref}.0.weight"] = _kernel(params[f"up{s}"]["kernel"])
        _bn(out, f"up.{ref}.1", params[f"up{s}_bn"], batch_stats[f"up{s}_bn"])
        for b in range(layers[ns + s]):
            _block(out, f"dec.{ref}.block{b}", params[f"dec{s}_block{b}"],
                   batch_stats[f"dec{s}_block{b}"])
    if "final" in params:
        _dense(out, "final", params["final"])
    return out


def state_dict_from_jax_backbone(params: Mapping, batch_stats: Mapping,
                                 backbone: Mapping) -> Dict[str, np.ndarray]:
    """A sparse backbone's state_dict by the converter of its config's type."""
    kind = backbone["type"]
    if kind in ("SpUNet-v1m1", "SpUNet-v1m2"):
        return state_dict_from_jax_spunet(params, batch_stats, backbone.get("channels"),
                                          backbone["layers"])
    if kind == "SpUNetNoSkipBase":
        return state_dict_from_jax_spunet_noskip(params, batch_stats, backbone["layers"])
    if kind.startswith("MinkUNet"):
        from ..models.sparse_unet.mink_unet import _VARIANTS

        layers = backbone.get("layers") or _VARIANTS.get(kind, (None, (2,) * 8))[1]
        return state_dict_from_jax_mink_unet(params, batch_stats, layers)
    raise KeyError(f"no converter for a {kind} backbone")


def state_dict_from_jax_classifier(variables: Mapping,
                                   backbone: Mapping) -> Dict[str, np.ndarray]:
    """``variables``: the JAX DefaultClassifier collections ``params`` and
    ``batch_stats`` with numpy leaves; ``backbone`` its backbone's config.
    Returns the port's state_dict: the backbone's under ``backbone.`` (a
    ``cls_mode`` SpUNet's ``final`` with it where it has one), and
    ``cls_head`` as an ``nn.Linear``."""
    params, stats = variables["params"], variables["batch_stats"]
    out: Dict[str, np.ndarray] = {
        f"backbone.{k}": v for k, v in state_dict_from_jax_backbone(
            params["backbone_net"], stats["backbone_net"], backbone).items()}
    _dense(out, "cls_head", params["cls_head"])
    return out
