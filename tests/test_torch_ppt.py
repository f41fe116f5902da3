"""PyTorch port vs JAX package: PDNorm, SpUNet-v1m3 and PPT on the CPU.

The same numpy inputs, made from a seed, go through the JAX modules and the
port's: ``PDBatchNorm`` in every mode, a SpUNet-v1m3 forward with weights
through the JAX package's ``convert_spunet_v1m3``, the weight converters,
a DefaultSegmentor around PPT-v1m1 in backbone mode (the ScanNet200
recipe's layout), and the JAX trainer's dropped ``condition``;
``test_torch_ppt_heads.py`` holds PPT-v1m1's and PPT-v1m2's logits and
loss, ``test_torch_ppt_train.py`` two train steps. The JAX backbone runs
without ``nn.remat`` (ROADMAP Queue 3) and with its band convs' Pallas
kernels in interpret mode.
Tolerances: 1e-5 for a norm and for the loss; 1e-4 of max|ref| for
backbone outputs and logits (convs summed in another order than XLA's).
"""

import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ponderv2_tpu.engines.train import Trainer as JTrainer
from ponderv2_tpu.models import build_model as jbuild
from ponderv2_tpu.models.norm import PDBatchNorm as JPDBatchNorm
from ponderv2_tpu_torch.datasets import build_dataset, collate_fn
from ponderv2_tpu_torch.datasets.ppt_vocab import PPT_CLASS_NAMES, PPT_VALID_INDEX
from ponderv2_tpu_torch.engines.train import Trainer as TTrainer
from ponderv2_tpu_torch.models import build_model as tbuild
from ponderv2_tpu_torch.models.norm import PDBatchNorm
from ponderv2_tpu_torch.models.sparse_unet.layers import SubMConv
from ponderv2_tpu_torch.utils.optimizer import build_optimizer
from ponderv2_tpu_torch.utils.convert import (
    state_dict_from_jax_ppt_v1m1,
    state_dict_from_jax_spunet_v1m3,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
from convert_torch_checkpoint import convert_ppt_v1m1, convert_spunet_v1m3  # noqa: E402
from jax_compile import jit  # noqa: E402
from torch_threads import _torch_threads  # noqa: F401, E402  (autouse fixture)

SHAPE = (160, 160, 64)
# the backbone's order and the head's differ, as in
# configs/scannet200/semseg-ppt-v1m1-0-spunet-lovasz-ft.py:38, :47
BB_CONDITIONS = ("ScanNet", "S3DIS", "Structured3D")
HEAD_CONDITIONS = ("Structured3D", "ScanNet", "S3DIS")
CRITERIA = [dict(type="CrossEntropyLoss", loss_weight=1.0, ignore_index=-1),
            dict(type="LovaszLoss", mode="multiclass", loss_weight=1.0, ignore_index=-1)]


@pytest.fixture(autouse=True)
def _torch_state():
    dtype, threads = torch.get_default_dtype(), torch.get_num_threads()
    torch.set_default_dtype(torch.float32)
    torch.set_num_threads(2)
    yield
    torch.set_default_dtype(dtype)
    torch.set_num_threads(threads)


def assert_rel(out, ref, bound, where=""):
    """max|out - ref| <= bound * max|ref| (ref nonzero somewhere)."""
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape, (where, out.shape, ref.shape)
    scale = np.abs(ref).max()
    assert scale > 0, where
    err = np.abs(out - ref).max()
    assert err <= bound * scale, f"{where}: err {err:.3e} vs {bound} x {scale:.3e}"


def backbone_cfg(channels, layers, base, context=16, num_classes=0):
    return dict(type="SpUNet-v1m3", in_channels=6, num_classes=num_classes,
                base_channels=base, channels=channels, layers=layers,
                conditions=BB_CONDITIONS, norm_decouple=True, norm_adaptive=True,
                context_channels=context)


def jax_cfg(cfg):
    """The JAX counterpart of a port model config: the backbone without
    ``nn.remat``."""
    cfg = dict(cfg)
    if "backbone" in cfg:
        cfg["backbone"] = dict(cfg["backbone"], remat=False)
    else:
        cfg["remat"] = False
    return cfg


def scene_batch(n_scenes=2, budget=8192, condition="ScanNet"):
    """~3k-point synthetic scenes with labels, voxelized at 5 cm and
    collated (color and normal features, as the PPT configs collect)."""
    ds = build_dataset(dict(
        type="SyntheticDataset", num_scenes=n_scenes, points_per_scene=3000,
        num_classes=20, transform=[
            dict(type="CenterShift", apply_z=True),
            dict(type="GridSample", grid_size=0.05, hash_type="fnv",
                 mode="train", return_grid_coord=True),
            dict(type="CenterShift", apply_z=False),
            dict(type="NormalizeColor"),
            dict(type="Add", keys_dict=dict(condition=condition)),
            dict(type="Collect", keys=("coord", "grid_coord", "segment", "condition"),
                 feat_keys=("color", "normal"))]))
    state = np.random.get_state()
    np.random.seed(0)  # GridSample's train-mode draw
    try:
        batch = collate_fn([ds[i] for i in range(n_scenes)], point_budget=budget,
                           scene_budget=n_scenes)
    finally:
        np.random.set_state(state)
    return batch


def arrays_of(batch):
    return {k: batch[k] for k in ("feat", "grid_coord", "batch", "segment")}


def randomize(model, seed=0):
    """Seeded init, then BN scale/bias and running statistics and the
    modulation's weights drawn from a seed so every condition differs."""
    model.reset_parameters(torch.Generator().manual_seed(seed))
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "modulation" in name:
                p.copy_(torch.from_numpy(rng.uniform(-0.1, 0.1, p.shape)))
            elif ".bns." in name or ".bn." in name:  # BN scale and bias
                lo, hi = (-0.2, 0.2) if name.endswith(".bias") else (0.5, 1.5)
                p.copy_(torch.from_numpy(rng.uniform(lo, hi, p.shape)))
        for name, b in model.named_buffers():
            if name.endswith("running_mean"):
                b.copy_(torch.from_numpy(rng.uniform(-0.2, 0.2, b.shape)))
            elif name.endswith("running_var"):
                b.copy_(torch.from_numpy(rng.uniform(0.5, 2.0, b.shape)))
    return model


def numpy_state(model, prefix=""):
    return {k[len(prefix):]: v.detach().numpy().copy()
            for k, v in model.state_dict().items() if k.startswith(prefix)}


# ------------------------------------------------------------------ PDNorm


@pytest.mark.parametrize("ci", [0, 1])
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("adaptive", [True, False], ids=["adaptive", "plain"])
@pytest.mark.parametrize("decouple", [True, False], ids=["decouple", "shared"])
def test_pdbatchnorm_matches_jax(rng, decouple, adaptive, train, ci):
    """Outputs within 1e-5 of max|ref|, and the running statistics as JAX
    moves them: in training only the selected condition's."""
    n, c, ctx_c = 200, 12, 8
    conditions = ("A", "B")
    x = (rng.randn(n, c) * 1.5 + rng.uniform(-1, 1, c)).astype(np.float32)
    mask = rng.rand(n) > 0.2
    x[~mask] = 0.0
    context = rng.randn(ctx_c).astype(np.float32)

    jmod = JPDBatchNorm(features=c, conditions=conditions, decouple=decouple,
                        adaptive=adaptive, context_channels=ctx_c)
    variables = jax.device_get(jmod.init(
        jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(mask), False, ci,
        jnp.asarray(context)))
    params = jax.tree.map(
        lambda a: (rng.uniform(0.5, 1.5, a.shape) if a.ndim == 1 else
                   rng.uniform(-0.3, 0.3, a.shape)).astype(np.float32),
        variables["params"])
    stats = jax.tree.map(lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32),
                         variables["batch_stats"])
    out, mutated = jmod.apply({"params": params, "batch_stats": stats},
                              jnp.asarray(x), jnp.asarray(mask), train, ci,
                              jnp.asarray(context), mutable=["batch_stats"])

    from ponderv2_tpu_torch.utils.convert import _pdnorm

    sd = {}
    _pdnorm(sd, "n", params, stats, conditions)
    mod = PDBatchNorm(c, conditions, decouple=decouple, adaptive=adaptive,
                      context_channels=ctx_c)
    mod.load_state_dict({k[2:]: torch.from_numpy(np.asarray(v)) for k, v in sd.items()})
    mod.train(train)
    with torch.no_grad():
        tout = mod(torch.from_numpy(x), torch.from_numpy(mask), ci,
                   torch.from_numpy(context))
    assert_rel(tout.numpy(), out, 1e-5, "output")
    assert not tout.numpy()[~mask].any()

    sd_after = {}
    _pdnorm(sd_after, "n", params, jax.device_get(mutated["batch_stats"]), conditions)
    for k, v in mod.state_dict().items():
        assert_rel(v.numpy(), sd_after[f"n.{k}"], 1e-5, k)
        moved = not np.array_equal(v.numpy(), sd[f"n.{k}"])
        selected = not decouple or f"bns.{ci}." in k
        assert moved == (train and selected and "running" in k), k


# ------------------------------------------------------------- SpUNet-v1m3

V1M3 = backbone_cfg((16, 32, 64, 96, 96, 64, 48, 72), (1,) * 8, 16)


def test_spunet_v1m3_forward_matches_jax():
    """Eval forward (one condition) of one scene at dense-grid shapes: the
    JAX v1m3 attaches band plans where a level is wider than 64 and builds
    inline ones where a block's input is, the port runs the plans of
    ``build_spunet_plans_auto``; features within 1e-4 of max|ref| and both
    contract flags true."""
    batch = scene_batch(n_scenes=1, budget=4096)
    arrays = arrays_of(batch)
    model = randomize(tbuild(dict(V1M3))).eval()
    state = numpy_state(model)
    params, stats = convert_spunet_v1m3(state, V1M3["channels"], V1M3["layers"],
                                        BB_CONDITIONS, adaptive=True)
    context = np.random.RandomState(1).randn(16).astype(np.float32)

    from ponderv2_tpu.ops.sparse import make_sparse_tensor, sort_by_key

    jmodel = jbuild(jax_cfg(V1M3))
    coords = jnp.asarray(np.concatenate([arrays["batch"][:, None],
                                         arrays["grid_coord"]], 1).astype(np.int32))
    st = make_sparse_tensor(jnp.asarray(arrays["feat"]), coords, SHAPE, 1)
    st_sorted, inverse = sort_by_key(st)
    variables = {"params": params, "batch_stats": stats}

    @jit
    def fwd(v, s, ctx):
        return jmodel.apply(v, s, train=False, condition="S3DIS", context=ctx,
                            mutable=["diagnostics"])

    ref, diag = fwd(variables, st_sorted, jnp.asarray(context))
    ref = np.asarray(ref)[np.asarray(inverse)]
    assert bool(jax.tree.leaves(diag["diagnostics"])[0])

    from ponderv2_tpu_torch.models.default import batch_to_sparse_tensor
    from ponderv2_tpu_torch.ops.sparse import sort_by_key as tsort

    tst = batch_to_sparse_tensor({**{k: torch.from_numpy(v) for k, v in arrays.items()},
                                  "spatial_shape": SHAPE, "batch_size": 1})
    tst_sorted, tinv = tsort(tst)
    with torch.inference_mode():
        out, ok = model(tst_sorted, condition="S3DIS", context=torch.from_numpy(context))
    assert bool(ok)
    assert np.abs(ref).max() > 0.3
    assert_rel(out[tinv].numpy(), ref, 1e-4, "features")
    routes = [m.last_route for m in model.modules() if isinstance(m, SubMConv)]
    assert routes == ["slab"] + ["band-attached"] * 16


def test_spunet_v1m3_state_dict_round_trips_through_jax_converter():
    """``state_dict_from_jax_spunet_v1m3`` inverts ``convert_spunet_v1m3``
    (scanned blocks), key for key and byte for byte, at two blocks a stage."""
    cfg = backbone_cfg((8, 16, 16, 16, 16, 16, 8, 8), (2, 3, 1, 2, 2, 1, 2, 2), 8,
                       num_classes=5)
    state = numpy_state(randomize(tbuild(dict(cfg))))
    params, stats = convert_spunet_v1m3(state, cfg["channels"], cfg["layers"],
                                        BB_CONDITIONS, adaptive=True)
    back = state_dict_from_jax_spunet_v1m3(params, stats, cfg["layers"], BB_CONDITIONS)
    assert sorted(back) == sorted(state)
    for k, v in state.items():
        assert np.asarray(back[k]).tobytes() == v.tobytes(), k


# --------------------------------------------------------------------- PPT

SMALL = backbone_cfg((8, 16, 16, 16, 16, 16, 8, 8), (1,) * 8, 8)
# the recipe's vocabulary: its text embeddings are the committed ppt36 asset
PPT = dict(type="PPT-v1m1", backbone=SMALL, criteria=CRITERIA, backbone_out_channels=8,
           context_channels=16, conditions=HEAD_CONDITIONS, class_name=PPT_CLASS_NAMES,
           valid_index=PPT_VALID_INDEX)
PPT_V1M2 = dict(type="PPT-v1m2", backbone=SMALL, criteria=CRITERIA,
                backbone_out_channels=8, context_channels=16,
                conditions=HEAD_CONDITIONS, num_classes=(7, 6, 5))


def ppt_variables(model, cfg):
    """The port PPT's weights as JAX variables: v1m1 through the JAX
    package's ``convert_ppt_v1m1``, v1m2 by name (flax checks each
    parameter's shape where the model reads it)."""
    state = numpy_state(model)
    layers = cfg["backbone"]["layers"]
    channels = cfg["backbone"]["channels"]
    if cfg["type"] == "PPT-v1m1":
        params, stats, constants = convert_ppt_v1m1(state, channels, layers,
                                                    BB_CONDITIONS, adaptive=True)
        return {"params": params, "batch_stats": stats, "constants": constants}
    bb = {k[len("backbone."):]: v for k, v in state.items() if k.startswith("backbone.")}
    bp, bs = convert_spunet_v1m3(bb, channels, layers, BB_CONDITIONS, adaptive=True)
    params = {"backbone_net": bp, "context": {"embedding": state["embedding_table.weight"]}}
    for i, c in enumerate(cfg["conditions"]):
        params[f"seg_head_{c}"] = {"kernel": state[f"seg_heads.{i}.weight"].T,
                                   "bias": state[f"seg_heads.{i}.bias"]}
    return {"params": params, "batch_stats": {"backbone_net": bs}}


def test_ppt_state_dict_round_trips_through_jax_converter():
    """``state_dict_from_jax_ppt_v1m1`` inverts ``convert_ppt_v1m1``: every
    key of the port's PPT-v1m1 (embedding table, projection head, logit
    scale, class embedding buffer, the v1m3 backbone) byte for byte."""
    cfg = dict(PPT, backbone=dict(SMALL, layers=(2, 2, 1, 1, 1, 2, 1, 2)))
    state = numpy_state(randomize(tbuild(cfg)))
    params, stats, constants = convert_ppt_v1m1(
        state, SMALL["channels"], cfg["backbone"]["layers"], BB_CONDITIONS,
        adaptive=True)
    back = state_dict_from_jax_ppt_v1m1(
        {"params": params, "batch_stats": stats, "constants": constants},
        cfg["backbone"]["layers"], BB_CONDITIONS)
    assert sorted(back) == sorted(state)
    for k, v in state.items():
        assert np.asarray(back[k], v.dtype).tobytes() == v.tobytes(), k


SEGMENTOR_PPT = dict(type="DefaultSegmentor", criteria=CRITERIA, backbone=dict(
    PPT, backbone=dict(SMALL, num_classes=7), backbone_mode=True, criteria=None))


def test_segmentor_around_ppt_backbone_mode_matches_jax():
    """The ScanNet200 recipe's layout: a DefaultSegmentor around PPT-v1m1 in
    backbone_mode, whose SpUNet-v1m3 holds the class head. The PPT keeps no
    projection head; logits within 1e-4 of max|ref| and the loss within
    1e-5 of the JAX package's, for one condition."""
    model = randomize(tbuild(dict(SEGMENTOR_PPT))).eval()
    assert not any(k.startswith(("backbone.proj_head", "backbone.class_embedding",
                                 "backbone.logit_scale")) for k in model.state_dict())
    state = numpy_state(model, "backbone.")
    bb = {k[len("backbone."):]: v for k, v in state.items() if k.startswith("backbone.")}
    cfg = SEGMENTOR_PPT["backbone"]["backbone"]
    bp, bs = convert_spunet_v1m3(bb, cfg["channels"], cfg["layers"], BB_CONDITIONS,
                                 adaptive=True)
    variables = {"params": {"backbone_net": {
        "backbone_net": bp, "context": {"embedding": state["embedding_table.weight"]}}},
        "batch_stats": {"backbone_net": {"backbone_net": bs}}}
    jmodel = jbuild(dict(SEGMENTOR_PPT, backbone=jax_cfg(SEGMENTOR_PPT["backbone"])))
    batch = arrays_of(scene_batch())
    ctx = {"spatial_shape": SHAPE, "batch_size": 2, "condition": "S3DIS"}
    ref = jit(lambda v, b: jmodel.apply(v, {**b, **ctx}, train=False))(
        variables, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.inference_mode():
        out = model({**{k: torch.from_numpy(v) for k, v in batch.items()}, **ctx})
    assert bool(out["contract_ok"])
    assert_rel(out["seg_logits"].numpy(), ref["seg_logits"], 1e-4, "logits")
    assert abs(float(out["loss"]) - float(ref["loss"])) <= 1e-5 * float(ref["loss"])


# ----------------------------------------------- the trainers' condition


class _Recorder(torch.nn.Module):
    """Records the inputs of each forward; its loss is a weight's square."""

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.ones(()))
        self.seen = []

    def forward(self, input_dict):
        self.seen.append(dict(input_dict))
        return {"loss": self.w * self.w, "contract_ok": torch.ones((), dtype=torch.bool)}


def test_trainers_pass_condition_port_only():
    """The recipe's collated batch lists one ``condition`` per scene. The
    JAX ``Trainer.run_step`` hands its step only the arrays (the condition
    falls into ``split_batch``'s static half, and ``make_train_step``'s
    context is the config's), so a PPT model falls back to its first
    condition: a fault of the JAX package, recorded in ROADMAP Queue 3. The
    port's ``Trainer`` passes the first scene's condition."""
    batch = scene_batch(condition="ScanNet")
    assert batch["condition"] == ["ScanNet", "ScanNet"]

    jtrainer = object.__new__(JTrainer)
    jtrainer.comm_info = {"input_dict": batch}
    jtrainer.mesh = None
    jtrainer.state = None
    seen = []
    jtrainer.train_step = lambda state, arrays: (seen.append(arrays), (state, {}))[1]
    jtrainer.run_step()
    assert "condition" not in seen[0] and "feat" in seen[0]

    ttrainer = object.__new__(TTrainer)
    ttrainer.comm_info = {"input_dict": batch}
    ttrainer.device = torch.device("cpu")
    ttrainer.cfg = {"seed": 0}
    ttrainer.static_ctx = {"spatial_shape": SHAPE, "batch_size": 2}
    ttrainer.model = _Recorder()
    ttrainer.optimizer = build_optimizer(dict(type="SGD", lr=0.1), ttrainer.model)
    ttrainer.schedule = lambda step: 0.1
    ttrainer.step = 0
    ttrainer.run_step()
    assert ttrainer.model.seen[0]["condition"] == "ScanNet"
    ttrainer.eval_step(batch)
    assert ttrainer.model.seen[1]["condition"] == "ScanNet"
