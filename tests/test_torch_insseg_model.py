"""PyTorch port vs JAX package: PG-v1m1 (PointGroup) on the CPU.

One batch of two synthetic scenes written as ScanNet scene files with one
instance per box (``chip_smoke.write_scannet_scenes``), through the insseg
recipe's val transforms (``InstanceParser`` included) and collated, goes
through the JAX model and the port's, at test widths (channels (8, 16, 16,
16, 16, 16, 8, 8), one block a stage, as ``tests/test_models_extra.py::
TestPointGroup``). The port's weights, made from a seed (every norm's scale,
bias and running statistics drawn from it too), reach JAX through the JAX
package's converters (``tools/convert_torch_checkpoint.py``), and
``utils/convert.py:state_dict_from_jax_point_group`` brings them back byte
for byte.

- Over SpUNet-v1m1: a training forward's ``seg_logits`` and ``bias_pred``
  within 1e-5 of their max|ref|, ``seg_loss``, ``bias_l1_loss``,
  ``bias_cosine_loss`` and ``loss`` within 1e-5 relative, and the grads of
  that loss within 1e-5 of the largest |grad|. Where an offset is the zero
  vector the JAX grads are nan and the port's finite (a port-only repair,
  ROADMAP Queue 3).
- Over PPT-v1m1 in backbone_mode over SpUNet-v1m3 (the insseg-ppt recipes'
  layout): the forward and the losses, with ``condition`` "ScanNet" in the
  input of both; the same tolerances.
- Without ``criteria`` (as the insseg-ppt recipes give PG-v1m1): the JAX
  model's loss is the logits plus the offset losses, not a scalar, and the
  port's is the reference's cross-entropy (a port-only repair, ROADMAP
  Queue 3).

The JAX backbones run without ``nn.remat`` (ROADMAP Queue 3) and with their
band convs' Pallas kernels in interpret mode.
"""

import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ponderv2_tpu.models import build_model as jbuild
from ponderv2_tpu_torch.datasets import build_dataset, collate_fn
from ponderv2_tpu_torch.datasets.ppt_vocab import PPT_CLASS_NAMES_INSSEG, PPT_VALID_INDEX
from ponderv2_tpu_torch.models import build_model as tbuild
from ponderv2_tpu_torch.utils.config import Config
from ponderv2_tpu_torch.utils.convert import state_dict_from_jax_point_group

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tools")]
import chip_smoke  # noqa: E402
from convert_torch_checkpoint import convert_ppt_v1m1, convert_spunet_v1m1  # noqa: E402
from jax_compile import background_compile  # noqa: E402
from torch_threads import _torch_threads  # noqa: F401, E402  (autouse fixture)

SHAPE = (1024, 1024, 512)
CE = [dict(type="CrossEntropyLoss", loss_weight=1.0, ignore_index=-1)]
V1M1 = dict(type="SpUNet-v1m1", in_channels=6, num_classes=0, base_channels=8,
            channels=(8, 16, 16, 16, 16, 16, 8, 8), layers=(1,) * 8)
V1M3 = dict(type="SpUNet-v1m3", in_channels=6, num_classes=0, base_channels=8,
            context_channels=16, channels=(8, 16, 16, 16, 16, 16, 8, 8), layers=(1,) * 8,
            conditions=("ScanNet", "S3DIS", "Structured3D"), zero_init=False,
            norm_decouple=True, norm_adaptive=True, norm_affine=True)
PPT = dict(type="PPT-v1m1", backbone=V1M3, criteria=CE, backbone_out_channels=8,
           context_channels=16, conditions=("Structured3D", "ScanNet", "S3DIS"),
           template="[x]", class_name=PPT_CLASS_NAMES_INSSEG, valid_index=PPT_VALID_INDEX,
           backbone_mode=True)
PG = dict(type="PG-v1m1", criteria=CE, backbone_out_channels=8, semantic_num_classes=20,
          semantic_ignore_index=-1, segment_ignore_index=(-1, 0, 1), instance_ignore_index=-1)
TERMS = ("seg_loss", "bias_l1_loss", "bias_cosine_loss", "loss")
REL = 1e-5


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


def without_remat(cfg):
    """The JAX counterpart of a port model config: every SpUNet without
    ``nn.remat``."""
    cfg = dict(cfg)
    if cfg["type"].startswith("SpUNet"):
        cfg["remat"] = False
    if "backbone" in cfg:
        cfg["backbone"] = without_remat(cfg["backbone"])
    return cfg


@pytest.fixture(scope="module")
def batch(tmp_path_factory):
    """Two 2,000-point scenes through the ScanNet insseg recipe's val
    transforms, collated to 4096 rows (padding rows included)."""
    root = str(tmp_path_factory.mktemp("scenes"))
    chip_smoke.write_scannet_scenes(root, 0, 2, points=2000, instances=True)
    cfg = Config.fromfile(chip_smoke.INSSEG_CONFIG)
    ds = build_dataset(dict(cfg.data.val, data_root=root))
    state = np.random.get_state()
    np.random.seed(0)  # GridSample's train-mode draw
    try:
        b = collate_fn([ds[0], ds[1]], point_budget=4096, scene_budget=2)
    finally:
        np.random.set_state(state)
    arrays = {k: b[k] for k in ("coord", "grid_coord", "segment", "instance",
                                "instance_centroid", "feat", "batch")}
    assert (arrays["instance"] >= 0).sum() > 500 and (arrays["batch"] < 0).any()
    return arrays


def seeded_model(cfg, seed=0, head_biases=True):
    """The port's model from ``seed``, every norm's scale and bias, running
    statistics and PDNorm modulation drawn from it too, and the heads'
    biases unless ``head_biases`` is False (``reset_parameters`` zeroes
    them, so that the offsets of the padding rows, whose features are 0,
    are 0 too)."""
    model = tbuild(dict(cfg))
    model.reset_parameters(torch.Generator().manual_seed(seed))
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "modulation" in name:
                p.copy_(torch.from_numpy(rng.uniform(-0.1, 0.1, p.shape)))
            elif "head" in name:
                if head_biases and name.endswith(".bias"):
                    p.copy_(torch.from_numpy(rng.uniform(-0.2, 0.2, p.shape)))
            elif p.ndim == 1:  # norm scale and bias
                lo, hi = (-0.2, 0.2) if name.endswith(".bias") else (0.5, 1.5)
                p.copy_(torch.from_numpy(rng.uniform(lo, hi, p.shape)))
        for name, b in model.named_buffers():
            if name.endswith("running_mean"):
                b.copy_(torch.from_numpy(rng.uniform(-0.2, 0.2, b.shape)))
            elif name.endswith("running_var"):
                b.copy_(torch.from_numpy(rng.uniform(0.5, 2.0, b.shape)))
    return model.train()


def jax_variables(model, cfg):
    """The port model's weights as JAX PG-v1m1 variables, through the JAX
    package's converters (``tools/convert_torch_checkpoint.py``); checks
    that ``state_dict_from_jax_point_group`` brings them back byte for
    byte."""
    state = {k: v.numpy() for k, v in model.state_dict().items()}
    bb = {k[len("backbone."):]: v for k, v in state.items() if k.startswith("backbone.")}
    bcfg = cfg["backbone"]
    if bcfg["type"] == "PPT-v1m1":
        inner = bcfg["backbone"]
        bp, bs, constants = convert_ppt_v1m1(bb, inner["channels"], inner["layers"],
                                             inner["conditions"], adaptive=True)
    else:
        bp, bs = convert_spunet_v1m1(bb, bcfg["channels"], bcfg["layers"])
        constants = {}

    def dense(name):
        return {"kernel": state[f"{name}.weight"].T, "bias": state[f"{name}.bias"]}

    variables = {"params": {"backbone_net": bp, "seg_head": dense("seg_head"),
                            "bias_head": {"layers_0": dense("bias_head.0"),
                                          "layers_2": dense("bias_head.2")}},
                 "batch_stats": {"backbone_net": bs}}
    if constants:
        variables["constants"] = {"backbone_net": constants}
    back = state_dict_from_jax_point_group(variables, bcfg)
    assert sorted(back) == sorted(state)
    for k, v in state.items():
        assert np.asarray(back[k], v.dtype).tobytes() == v.tobytes(), k
    return jax.tree.map(jnp.asarray, variables)


def jax_inputs(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def port_inputs(batch, condition=None):
    out = {k: torch.from_numpy(v) for k, v in batch.items()}
    out.update(spatial_shape=SHAPE, batch_size=2)
    if condition is not None:
        out["condition"] = condition
    return out


def jax_forward(jmodel, condition=None):
    """The JAX model's jitted training forward, with the static context
    (shape, batch size, condition) closed over."""
    ctx = dict(spatial_shape=SHAPE, batch_size=2)
    if condition is not None:
        ctx["condition"] = condition
    return lambda v, b: jmodel.apply(v, {**b, **ctx}, train=True, mutable=["batch_stats"])[0]


@pytest.fixture(scope="module")
def jax_compiled(batch):
    """The module's two JAX graphs, lowered in turn and compiled side by
    side: PG-v1m1 over SpUNet-v1m1's training forward with the grads of
    its loss (``v1m1``), and PG-v1m1 over PPT-v1m1's training forward at
    "ScanNet" (``ppt``); futures of the compiled functions."""
    v1m1 = dict(PG, backbone=V1M1)
    fwd = jax_forward(jbuild(without_remat(v1m1)))

    @jax.jit
    def value_and_grad(variables, b):
        def loss_fn(params):
            out = fwd({**variables, "params": params}, b)
            return out["loss"], out

        return jax.value_and_grad(loss_fn, has_aux=True)(variables["params"])

    ppt = dict(PG, backbone=PPT)
    ppt_forward = jax.jit(jax_forward(jbuild(without_remat(ppt)), "ScanNet"))
    b = jax_inputs(batch)
    return {"v1m1": background_compile(value_and_grad,
                                       jax_variables(seeded_model(v1m1), v1m1), b),
            "ppt": background_compile(ppt_forward, jax_variables(seeded_model(ppt), ppt), b)}


@pytest.fixture(scope="module")
def v1m1_grads(jax_compiled):
    """PG-v1m1 over SpUNet-v1m1: the JAX training forward's outputs and the
    grads of its loss, as a function of the port model's weights (one jit
    compile for the module)."""
    cfg = dict(PG, backbone=V1M1)

    def run(model, batch):
        variables = jax_variables(model, cfg)
        value_and_grad = jax_compiled["v1m1"].result()
        (_, ref), grads = jax.device_get(value_and_grad(variables, jax_inputs(batch)))
        return ref, state_dict_from_jax_point_group(
            {"params": grads, "batch_stats": jax.device_get(variables["batch_stats"])}, V1M1)

    return cfg, run


def test_pg_over_spunet_v1m1_matches_jax(batch, v1m1_grads):
    """The training forward's outputs and losses, and the loss's grads (the
    heads' biases drawn from the seed, so that no offset is the zero
    vector: see the next test)."""
    cfg, run = v1m1_grads
    model = seeded_model(cfg)
    ref, grads = run(model, batch)
    out = model(port_inputs(batch))
    out["loss"].backward()
    assert bool(out["contract_ok"])
    for k in ("seg_logits", "bias_pred"):
        assert_rel(out[k].detach().numpy(), ref[k], REL, k)
    for k in TERMS:
        assert_rel(float(out[k].detach()), float(ref[k]), REL, k)
    top = max(np.abs(grads[n]).max() for n, _ in model.named_parameters())
    for name, p in model.named_parameters():
        err = np.abs(p.grad.numpy() - grads[name]).max()
        assert err <= REL * top, f"grad {name}: err {err:.3e} vs {REL} x {top:.3e}"
    assert {"bias_head.0.weight", "bias_head.2.weight", "seg_head.weight"} <= set(grads)


def test_zero_offset_rows_give_finite_grads_port_only(batch, v1m1_grads):
    """With the heads' biases zero, as both packages initialise them, every
    padding row (features 0) predicts the zero offset. The JAX cosine loss
    divides by ``max(norm, 1e-8)`` and differentiates ``jnp.linalg.norm`` at
    0, which is nan; masked by 0 it stays nan, so the JAX step's grads of the
    offset head's last layer are nan (ROADMAP Queue 3). The port's
    ``vector_norm`` takes 0 there: its grads are finite and equal JAX's
    everywhere JAX's are."""
    cfg, run = v1m1_grads
    model = seeded_model(cfg, head_biases=False)
    ref, grads = run(model, batch)
    out = model(port_inputs(batch))
    out["loss"].backward()
    zero = np.abs(ref["bias_pred"]).sum(-1) == 0
    assert zero.sum() == (batch["batch"] < 0).sum() > 0
    nan = sorted(n for n, g in grads.items() if np.isnan(g).any())
    assert nan == ["bias_head.2.bias", "bias_head.2.weight"]
    top = max(np.abs(np.nan_to_num(grads[n])).max() for n, _ in model.named_parameters())
    for name, p in model.named_parameters():
        assert bool(torch.isfinite(p.grad).all()), name
        if name not in nan:
            err = np.abs(p.grad.numpy() - grads[name]).max()
            assert err <= REL * top, f"grad {name}: err {err:.3e} vs {REL} x {top:.3e}"


def test_pg_over_ppt_backbone_mode_matches_jax(batch, jax_compiled):
    """PG-v1m1 over PPT-v1m1 (backbone_mode) over SpUNet-v1m3, condition
    "ScanNet" given to both: outputs and losses."""
    cfg = dict(PG, backbone=PPT)
    model = seeded_model(cfg)
    variables = jax_variables(model, cfg)
    ref = jax.device_get(jax_compiled["ppt"].result()(variables, jax_inputs(batch)))

    with torch.no_grad():
        out = model(port_inputs(batch, "ScanNet"))
    assert bool(out["contract_ok"])
    for k in ("seg_logits", "bias_pred"):
        assert_rel(out[k].numpy(), ref[k], REL, k)
    for k in TERMS:
        assert_rel(float(out[k]), float(ref[k]), REL, k)


def test_pg_without_criteria_takes_cross_entropy_port_only(batch):
    """The insseg-ppt recipes give PG-v1m1 no ``criteria``. The JAX model's
    empty criteria return the logits, so its loss is (N, K), not a scalar,
    and its train step cannot take a gradient; the port takes the
    reference's cross-entropy at ``semantic_ignore_index``."""
    cfg = {k: v for k, v in dict(PG, backbone=V1M1).items() if k != "criteria"}
    model = seeded_model(cfg)
    variables = jax_variables(model, cfg)
    jmodel = jbuild(without_remat(cfg))
    ref = jax.eval_shape(jax_forward(jmodel), variables, jax_inputs(batch))
    assert ref["loss"].shape == ref["seg_logits"].shape == (4096, 20)

    with torch.no_grad():
        out = model(port_inputs(batch))
    assert out["loss"].shape == ()
    mask = torch.from_numpy(batch["batch"] >= 0)
    ce = torch.nn.functional.cross_entropy(
        out["seg_logits"][mask], torch.from_numpy(batch["segment"])[mask], ignore_index=-1)
    assert_rel(float(out["seg_loss"]), float(ce), REL, "seg_loss")
    assert_rel(float(out["loss"]), float(ce + out["bias_l1_loss"] + out["bias_cosine_loss"]),
               REL, "loss")
