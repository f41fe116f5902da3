"""PyTorch port vs JAX package: two SGD-Nesterov steps of PPT-v1m1 on the CPU.

A PPT-v1m1 over a narrow SpUNet-v1m3 (its fourth level 72 wide, so the JAX
backbone runs its band convs there, in interpret mode, without
``nn.remat``; ROADMAP Queue 3) with CE + Lovász, on one seeded batch of two
synthetic scenes, against the JAX package's jitted ``make_train_step``,
with the condition passed explicitly to both. Tolerances, as for
SpUNet-v1m1 in ``test_torch_train.py``: the loss 1e-5, grads 1e-4 of each
tensor's max|ref|, parameters and BN running statistics after the steps
1e-5 of max|ref|; then the trained model's logits and loss in eval mode
on another condition, logits 1e-4 of max|ref|.
"""

from types import SimpleNamespace

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from ponderv2_tpu.engines.train import TrainState, make_train_step
from ponderv2_tpu.models import build_model as jbuild
from ponderv2_tpu.utils.optimizer import build_optimizer as jbuild_optimizer
from ponderv2_tpu.utils.scheduler import build_scheduler as jbuild_scheduler
from ponderv2_tpu_torch.models import build_model as tbuild
from ponderv2_tpu_torch.utils.convert import state_dict_from_jax_ppt_v1m1
from ponderv2_tpu_torch.utils.optimizer import build_optimizer, fill_missing_grads, set_lr
from ponderv2_tpu_torch.utils.scheduler import build_scheduler
from test_torch_ppt import (
    BB_CONDITIONS,
    PPT,
    SHAPE,
    _torch_state,  # noqa: F401  (autouse fixture)
    arrays_of,
    assert_rel,
    backbone_cfg,
    jax_cfg,
    numpy_state,
    ppt_variables,
    randomize,
    scene_batch,
)
from jax_compile import background_compile  # noqa: E402
from torch_threads import _torch_threads  # noqa: F401, E402  (autouse fixture)

TRAIN_PPT = dict(PPT, backbone=backbone_cfg((8, 16, 32, 72, 72, 32, 16, 16), (1,) * 8, 8),
                 backbone_out_channels=16)
OPTIMIZER = dict(type="SGD", lr=0.05, momentum=0.9, weight_decay=1e-4, nesterov=True)
SCHEDULER = dict(type="OneCycleLR", max_lr=0.05, pct_start=0.05,
                 anneal_strategy="cos", div_factor=10.0, final_div_factor=10000.0)


def to_port_names(params, stats, constants):
    return {k: np.asarray(v) for k, v in state_dict_from_jax_ppt_v1m1(
        jax.device_get({"params": params, "batch_stats": stats, "constants": constants}),
        TRAIN_PPT["backbone"]["layers"], BB_CONDITIONS).items()}


@pytest.fixture(scope="module")
def two_steps():
    """Two SGD-Nesterov steps (OneCycle lr) of PPT-v1m1 with CE + Lovász on
    condition "ScanNet", passed explicitly to both (the JAX step through its
    static context): each side's losses, first-step grads and state after,
    and the JAX eval forward on condition "S3DIS", compiled beside the step
    (``torch_threads`` holds the port at 2 threads)."""
    batch = arrays_of(scene_batch())
    ctx = dict(spatial_shape=SHAPE, batch_size=2)
    total_steps = 10
    model = randomize(tbuild(dict(TRAIN_PPT))).train()
    init_state = numpy_state(model)

    jmodel = jbuild(jax_cfg(TRAIN_PPT))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = ppt_variables(model, TRAIN_PPT)
    capture = optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p), lambda g, s, p=None: (g, g))
    schedule = jbuild_scheduler(dict(SCHEDULER), total_steps)
    tx = optax.chain(capture, jbuild_optimizer(dict(OPTIMIZER), variables["params"],
                                               schedule))
    state = TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                       batch_stats=variables["batch_stats"],
                       opt_state=tx.init(variables["params"]),
                       constants=variables["constants"])
    step = background_compile(make_train_step(jmodel, tx, schedule,
                                              {**ctx, "condition": "ScanNet"}), state, jbatch)
    # the trained model's eval forward on another condition, for
    # test_ppt_logits_and_loss_after_two_steps_match_jax
    jeval = background_compile(jax.jit(lambda v, b: jmodel.apply(
        v, {**b, **ctx, "condition": "S3DIS"}, train=False)), variables, jbatch)

    opt = build_optimizer(dict(OPTIMIZER), model)
    tsched = build_scheduler(dict(SCHEDULER), total_steps)
    inputs = {**{k: torch.from_numpy(v) for k, v in batch.items()}, **ctx,
              "condition": "ScanNet"}
    metrics, grads = [], None
    for k in range(2):
        set_lr(opt, tsched(k))
        out = model(inputs)
        out["loss"].backward()
        metrics.append(dict(loss=float(out["loss"].detach()),
                            contract_ok=bool(out["contract_ok"])))
        if k == 0:
            grads = {name: None if p.grad is None else p.grad.numpy().copy()
                     for name, p in model.named_parameters()}
        fill_missing_grads(opt)  # as the Trainer does: optax updates every leaf
        opt.step()
        opt.zero_grad(set_to_none=True)

    step = step.result()
    jmetrics = []
    for k in range(2):
        state, m = step(state, jbatch)
        jmetrics.append({key: float(v) for key, v in m.items()})
        if k == 0:
            jgrads = to_port_names(state.opt_state[0], variables["batch_stats"],
                                   variables["constants"])
    return SimpleNamespace(model=model, inputs=inputs, init_state=init_state,
                           jeval=jeval.result(), jbatch=jbatch, jstate=state,
                           jmetrics=jmetrics, jgrads=jgrads, metrics=metrics, grads=grads)


def test_two_sgd_steps_of_ppt_match_jax_train_step(two_steps):
    """Loss within 1e-5, the first step's grads within 1e-4 of max|ref|,
    and params and BN running statistics after both steps within 1e-5 of
    max|ref|; only ScanNet's norms' statistics move."""
    r = two_steps
    for m, jm in zip(r.metrics, r.jmetrics):
        assert m["contract_ok"] and jm["contract_ok"] == 1.0
        assert abs(m["loss"] - jm["loss"]) <= 1e-5 * jm["loss"]
    for name, g in r.grads.items():
        if not r.jgrads[name].any():  # another condition's norm
            assert g is None, name
        else:
            assert_rel(g, r.jgrads[name], 1e-4, f"grad {name}")
    jafter = to_port_names(r.jstate.params, r.jstate.batch_stats, r.jstate.constants)
    after = numpy_state(r.model)
    for name, v in after.items():
        assert_rel(v, jafter[name], 1e-5, f"after {name}")
        if "running" in name:
            moved = not np.array_equal(v, r.init_state[name])
            assert moved == (".bns.0." in name), name  # ScanNet is the backbone's 0


def test_ppt_logits_and_loss_after_two_steps_match_jax(two_steps):
    """The trained PPT-v1m1 in eval mode on condition "S3DIS", which the
    head and the backbone order differently (index 2 of the head's, 1 of
    the backbone's): logits (input row order) within 1e-4 of max|ref| and
    the loss within 1e-5; the port's logits differ from its "ScanNet" ones."""
    r = two_steps
    model = r.model.eval()
    js = r.jstate
    jvars = {"params": js.params, "batch_stats": js.batch_stats, "constants": js.constants}
    ref = r.jeval(jvars, r.jbatch)
    logits = {}
    with torch.inference_mode():
        for cond in ("S3DIS", "ScanNet"):
            out = model({**r.inputs, "condition": cond})
            assert bool(out["contract_ok"])
            logits[cond] = out["seg_logits"].numpy()
            if cond == "S3DIS":
                assert_rel(logits[cond], ref["seg_logits"], 1e-4, "S3DIS logits")
                assert abs(float(out["loss"]) - float(ref["loss"])) <= 1e-5 * float(
                    ref["loss"])
    a, b = logits["S3DIS"], logits["ScanNet"]
    assert a.shape != b.shape or not np.allclose(a, b)
