"""PyTorch port vs JAX package: PonderIndoor-v2 with the multi-dataset
pretrain's three conditions.

The model of ``configs/_test_/pretrain_synthetic.py`` (test widths) with
the multi-dataset config's conditions (Structured3D, ScanNet, S3DIS), its
36-name class vocabulary with each condition's ``valid_index`` subset, and
its PPT loss weight 1.0, on ``test_torch_pretrain_step.py``'s batch and
seeded weights (carried to JAX by ``convert_ponder_indoor`` and back by
``state_dict_from_jax_ponder_indoor``):

- one SGD step at "S3DIS" against ``make_train_step`` with ``condition`` in
  its ``static_ctx``: every grad within 1e-2 of its max|ref| and every
  parameter's and running statistic's update within 1e-2 of its max|ref
  update|, the tolerances and floors of ``test_torch_pretrain_step.py``
  (whose docstring says why the whole step is held that loosely);
- the multi-dataset pretrain's optimizer and 4-step OneCycle schedule (the
  steps of ``chip_smoke.py`` phase 15) run 4 steps at "S3DIS" on the batch
  in JAX, the step the one compiled above; from the state each step started
  from, the port's eikonal term within 1e-3 relative (``LOSS_REL``).

``test_torch_multidataset_terms.py`` holds the loss and its terms of one
training forward per condition. The optimizer and schedule are the
multi-dataset config's throughout.

The JAX backbone runs with ``remat=False`` (ROADMAP Queue 3).
"""

import os
import sys
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
from ponderv2_tpu_torch.datasets.ppt_vocab import PPT_CLASS_NAMES, PPT_VALID_INDEX
from ponderv2_tpu_torch.models import build_model as tbuild
from ponderv2_tpu_torch.utils.convert import state_dict_from_jax_ponder_indoor
from ponderv2_tpu_torch.utils.config import Config
from ponderv2_tpu_torch.utils.optimizer import build_optimizer, set_lr
from ponderv2_tpu_torch.utils.scheduler import build_scheduler
from test_torch_pretrain_step import (CFG, GRAD_REL, LOSS_REL, SEED, assert_rel,
                                      port_draws, pretrain_batch, seeded_state_dict)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
from convert_torch_checkpoint import convert_ponder_indoor  # noqa: E402
from jax_compile import compile_now  # noqa: E402
from torch_threads import _torch_threads  # noqa: F401, E402  (autouse fixture)

CONDITIONS = ("Structured3D", "ScanNet", "S3DIS")
MODEL = dict(CFG.model, conditions=CONDITIONS, class_name=PPT_CLASS_NAMES,
             valid_index=PPT_VALID_INDEX, ppt_loss_weight=1.0)
TERMS = ("loss", "ppt_loss") + tuple(CFG.metric_keys)
# the multi-dataset pretrain's optimizer and OneCycle schedule over the 4
# steps of one round (chip_smoke.py phase 15)
MULTI = Config.fromfile(os.path.join(
    ROOT, "configs/scannet/pretrain-ponder-ppt-v1m1-0-sc-s3-st-spunet.py"))
TOTAL_STEPS = 4


@pytest.fixture(autouse=True)
def _torch_state():
    dtype, threads = torch.get_default_dtype(), torch.get_num_threads()
    torch.set_default_dtype(torch.float32)
    torch.set_num_threads(2)
    yield
    torch.set_default_dtype(dtype)
    torch.set_num_threads(threads)


def seeded_setup():
    """The batch, its static context, the port's seeded weights, the JAX
    model (without ``nn.remat``) and its variables made from those weights,
    and the JAX key of the train step at step 0."""
    arrays = pretrain_batch()
    ctx = dict(spatial_shape=tuple(CFG.sparse_shape), batch_size=2)
    channels, layers = CFG.model.backbone.channels, CFG.model.backbone.layers
    levels = CFG.model.projection.num_levels
    init = seeded_state_dict(tbuild(dict(MODEL)))
    params, stats, constants = convert_ponder_indoor(init, channels, layers, levels)
    jmodel = jbuild(dict(MODEL, backbone=dict(MODEL["backbone"], remat=False)))
    key = jax.random.fold_in(jax.random.PRNGKey(SEED), 0)  # the train step's at step 0
    return SimpleNamespace(arrays=arrays, ctx=ctx, init=init, params=params, stats=stats,
                           constants=constants, jmodel=jmodel, key=key)


@pytest.fixture(scope="module")
def jax_run():
    """The seeded weights and one JAX train step at S3DIS: its metrics,
    grads and the state after it, in the port's names; then the rest of the
    OneCycle round."""
    setup = seeded_setup()
    arrays, ctx, init, key = setup.arrays, setup.ctx, setup.init, setup.key
    params, stats, constants = setup.params, setup.stats, setup.constants
    channels, layers = CFG.model.backbone.channels, CFG.model.backbone.layers
    levels = CFG.model.projection.num_levels
    jarr = {k: jnp.asarray(v) for k, v in arrays.items()}

    capture = optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p), lambda g, s, p=None: (g, g))
    schedule = jbuild_scheduler(dict(MULTI.scheduler), TOTAL_STEPS)
    jparams = jax.tree.map(jnp.asarray, params)
    tx = optax.chain(capture, jbuild_optimizer(dict(MULTI.optimizer), jparams, schedule))
    state = TrainState(step=jnp.zeros((), jnp.int32), params=jparams,
                       batch_stats=jax.tree.map(jnp.asarray, stats),
                       opt_state=tx.init(jparams),
                       constants=jax.tree.map(jnp.asarray, constants))
    step = compile_now(make_train_step(setup.jmodel, tx, schedule,
                                       {**ctx, "condition": "S3DIS"},
                                       metric_keys=TERMS[1:] + ("eikonal_loss",),
                                       rng_seed=SEED), state, jarr)
    state, metrics = step(state, jarr)

    def to_port(p, s):
        return state_dict_from_jax_ponder_indoor(
            jax.device_get({"params": p, "batch_stats": s, "constants": constants}),
            channels, layers, levels)

    first = SimpleNamespace(lr=float(metrics["lr"]), contract_ok=float(metrics["contract_ok"]),
                            grads=to_port(state.opt_state[0], stats),
                            after=to_port(state.params, state.batch_stats))
    # the rest of the round, the same executable: (lr, eikonal term, the
    # state the step started from) per step
    schedule_run = [(float(metrics["lr"]), float(metrics["eikonal_loss"]), init)]
    for _ in range(TOTAL_STEPS - 1):
        start = to_port(state.params, state.batch_stats)
        state, metrics = step(state, jarr)
        schedule_run.append((float(metrics["lr"]), float(metrics["eikonal_loss"]), start))
    return SimpleNamespace(arrays=arrays, ctx=ctx, init=init, key=key,
                           schedule_run=schedule_run, **vars(first))


def port_forward(model, run, condition):
    B, V, H, W = run.arrays["depth"].shape
    inputs = {k: torch.from_numpy(v) for k, v in run.arrays.items()}
    return model({**inputs, **run.ctx, "condition": condition,
                  "draws": port_draws(model, run.key, B, V, H * W)})


def test_sgd_step_at_s3dis_matches_jax_train_step(jax_run):
    """One SGD step at "S3DIS": the lr, every grad, and every parameter's
    and running statistic's update against ``make_train_step``."""
    model = tbuild(dict(MODEL))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in jax_run.init.items()})
    model.train()
    opt = build_optimizer(dict(MULTI.optimizer), model)
    tsched = build_scheduler(dict(MULTI.scheduler), TOTAL_STEPS)
    set_lr(opt, tsched(0))
    assert tsched(0) == pytest.approx(jax_run.lr, rel=1e-6)
    out = port_forward(model, jax_run, "S3DIS")
    out["loss"].backward()
    assert bool(out["contract_ok"]) and jax_run.contract_ok == 1.0
    failures = []

    def check(*args, **kw):
        try:
            assert_rel(*args, **kw)
        except AssertionError as e:
            failures.append(str(e).splitlines()[0])

    grads = {n: p.grad.numpy() for n, p in model.named_parameters()}
    top = max(np.abs(jax_run.grads[n]).max() for n in grads)
    for name, g in grads.items():
        floor = top if np.abs(jax_run.grads[name]).max() < GRAD_REL * top else None
        check(g, jax_run.grads[name], GRAD_REL, f"grad {name}", scale=floor)
    opt.step()
    before, after = jax_run.init, jax_run.after
    for name, v in model.state_dict().items():
        if name == "class_embedding":
            np.testing.assert_array_equal(v.numpy(), after[name])
            continue
        ref = after[name] - before[name]
        floor = max(np.abs(ref).max(), 1e3 * np.finfo(np.float32).eps
                    * np.abs(after[name]).max(), tsched(0) * top if name in grads else 0.0)
        check(v.numpy() - before[name], ref, GRAD_REL, f"update {name}", scale=floor)
    assert not failures, "\n".join(failures)


def test_eikonal_term_over_four_onecycle_steps_matches_jax(jax_run):
    """The multi-dataset pretrain's 4-step OneCycle round at "S3DIS" on the
    batch: at every step the lr (within 1e-6 of the peak lr), and the
    eikonal term from the state that
    step of the JAX run started from, with that step's draws (the JAX key
    ``fold_in(seed, step)``), within 1e-3 relative of the JAX package's. So
    the term moves over the round as the schedule moves the weights. Each
    step starts from the JAX state, as in ``test_torch_pretrain_step.py``:
    run on from its own state, the port's term drifts from JAX's by 7-8% at
    steps 2-3 here, and its own term moves by 17% at step 3 under a 1e-6
    relative perturbation of the initial weights (the step amplifies f32
    rounding; that module's docstring)."""
    model = tbuild(dict(MODEL))
    model.train()
    tsched = build_scheduler(dict(MULTI.scheduler), TOTAL_STEPS)
    B, V, H, W = jax_run.arrays["depth"].shape
    inputs = {k: torch.from_numpy(v) for k, v in jax_run.arrays.items()}
    terms = []
    peak = MULTI.scheduler.max_lr
    for k, (lr, eikonal, start) in enumerate(jax_run.schedule_run):
        # JAX's schedule is f32: near its 5e-9 end it carries ~1e-7 of the peak
        assert abs(tsched(k) - lr) <= 1e-6 * peak, (k, tsched(k), lr)
        model.load_state_dict({n: torch.from_numpy(np.asarray(v)) for n, v in start.items()})
        key = jax.random.fold_in(jax.random.PRNGKey(SEED), k)
        with torch.no_grad():
            out = model({**inputs, **jax_run.ctx, "condition": "S3DIS",
                         "draws": port_draws(model, key, B, V, H * W)})
        assert_rel(float(out["eikonal_loss"]), eikonal, LOSS_REL, f"step {k} eikonal")
        terms.append(eikonal)
    assert len(set(terms)) == TOTAL_STEPS
