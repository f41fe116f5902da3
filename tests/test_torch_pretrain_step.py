"""PyTorch port vs JAX package: the PonderIndoor-v2 pretrain train step.

Two SGD steps (momentum, weight decay, OneCycle lr) of the model of
``configs/_test_/pretrain_synthetic.py`` on one batch of two synthetic
RGB-D scenes, against the JAX package's jitted ``make_train_step``. The
weights are the port's seeded ones (BN scale, bias and running stats drawn
from a seed too), carried to JAX by the JAX package's converter
(``tools/convert_torch_checkpoint.py:convert_ponder_indoor``) and back by
the port's (``utils.convert.state_dict_from_jax_ponder_indoor``). The JAX
step draws its ray picks and sampler jitter from
``fold_in(PRNGKey(seed), step)``; the test builds the same uniforms from
the same key tree and hands them to the port.

Tolerances: the loss and its terms 1e-3 relative; every grad of each
step 1e-2 of its max|ref| (a grad that is zero by construction up to f32
cancellation, ahead of a training-mode BN, is held to 1e-2 of the largest
grad); each step's update of every parameter and BN running stat 1e-2 of
its max|ref update| (or of the tensor's f32 resolution, 1.2e-4 of its
max|value|, or of lr x the largest grad, where the update is smaller). The second step starts from the
JAX state after the first, loaded through the port's converter: from the
port's own state, which differs from it by the first step's grad
differences times the lr (up to 3e-4 of a conv weight), the second step's
grads differ by up to 27%. These bounds are wider than the single-module
ones of ``test_torch_pretrain_ops.py`` (1e-5 values, 1e-4 grads) because
the whole step is ill-conditioned against f32 rounding, and the JAX
reference carries more of it than the port: its UNet3D BatchNorm (flax,
batch statistics over the 2 x 32 x 32 x 16 volume) is off from a float64
evaluation by 2.5e-5 of max|out| at the first decoder on this batch, the
port's by 9e-8; and a relative perturbation of 1e-5 of the port's own
UNet3D output moves the backbone grads by 1e-3 of max|grad| (median over
tensors; 5.6e-3 at most), because the render losses switch discretely (L1
signs, the near-surface and free-space sample masks, ReLUs) under the
sample positions that the sdf picks. A wiring fault moves them by O(1). The JAX backbone runs with
``remat=False``, as in ``test_torch_train.py`` (ROADMAP Queue 3).
"""

import os
import sys

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
from ponderv2_tpu_torch.datasets import build_dataset, collate_fn
from ponderv2_tpu_torch.models import build_model as tbuild
from ponderv2_tpu_torch.models.sparse_unet.layers import SubMConv
from ponderv2_tpu_torch.utils.config import Config
from ponderv2_tpu_torch.utils.convert import state_dict_from_jax_ponder_indoor
from ponderv2_tpu_torch.utils.optimizer import build_optimizer, set_lr
from ponderv2_tpu_torch.utils.scheduler import build_scheduler

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
from convert_torch_checkpoint import convert_ponder_indoor  # noqa: E402

CFG = Config.fromfile(os.path.join(ROOT, "configs/_test_/pretrain_synthetic.py"))
SEED = 0
LOSS_REL, GRAD_REL = 1e-3, 1e-2


@pytest.fixture(autouse=True)
def _torch_state():
    dtype, threads = torch.get_default_dtype(), torch.get_num_threads()
    torch.set_default_dtype(torch.float32)
    torch.set_num_threads(2)
    yield
    torch.set_default_dtype(dtype)
    torch.set_num_threads(threads)


def assert_rel(out, ref, bound, where="", scale=None):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape, (where, out.shape, ref.shape)
    scale = np.abs(ref).max() if scale is None else scale
    err = np.abs(out - ref).max()
    assert err <= bound * scale, f"{where}: err {err:.3e} vs {bound} x {scale:.3e}"


def pretrain_batch():
    """Two synthetic RGB-D scenes under the config's train transform,
    collated to its point budget (rows pre-sorted by the collate)."""
    state = np.random.get_state()
    np.random.seed(0)  # GridSample's train-mode draw
    try:
        ds = build_dataset(dict(CFG.data.train))
        batch = collate_fn([ds[0], ds[1]], point_budget=CFG.point_budget,
                           scene_budget=2)
    finally:
        np.random.set_state(state)
    return {k: np.asarray(v) for k, v in batch.items()
            if isinstance(v, np.ndarray)}


def seeded_state_dict(model):
    """The port's seeded weights, with BN scale, bias and running stats
    drawn from a seed as well (a fresh BN would hide a mapping fault)."""
    model.reset_parameters(torch.Generator().manual_seed(SEED))
    rng = np.random.RandomState(SEED)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "batchnorm" in name or (name.startswith("backbone.") and p.ndim == 1):
                lo, hi = (-0.2, 0.2) if name.endswith(".bias") else (0.5, 1.5)
                p.copy_(torch.from_numpy(rng.uniform(lo, hi, p.shape)))
        for name, b in model.named_buffers():
            if name.endswith("running_mean"):
                b.copy_(torch.from_numpy(rng.uniform(-0.2, 0.2, b.shape)))
            elif name.endswith("running_var"):
                b.copy_(torch.from_numpy(rng.uniform(0.5, 2.0, b.shape)))
    return {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}


def port_draws(model, key, batch_size, views, pixels):
    """The JAX step's uniforms from its key tree (``PonderIndoor.__call__``
    splits the step key in 3; ``NeuSSampler`` splits the render key in
    ``steps + 1``), as the port's ``draws``."""
    rng_mask, rng_ray, rng_render = jax.random.split(key, 3)
    rays = views * model.ray_nsample
    shapes = model.renderer.draw_shapes((batch_size, rays))
    keys = jax.random.split(rng_render, len(shapes))
    t = lambda x: torch.from_numpy(np.asarray(x))  # noqa: E731
    return dict(
        ray_score=t(jax.random.uniform(rng_ray, (batch_size, views, pixels))),
        sampler=[t(jax.random.uniform(k, s)) for k, s in zip(keys, shapes)],
        mask_salt=t(jax.random.randint(rng_mask, (), 0, 2 ** 31 - 1)),
    )


def test_two_sgd_steps_match_jax_train_step():
    """Loss, metrics and every grad of both steps, and each step's update of
    every parameter and BN running stat."""
    arrays = pretrain_batch()
    ctx = dict(spatial_shape=tuple(CFG.sparse_shape), batch_size=2)
    total_steps = 10
    channels, layers = CFG.model.backbone.channels, CFG.model.backbone.layers
    levels = CFG.model.projection.num_levels

    model = tbuild(dict(CFG.model))
    init = seeded_state_dict(model)
    params, stats, constants = convert_ponder_indoor(init, channels, layers, levels)

    # --- JAX: two steps of the jitted train step. An identity transform in
    # front of the optimizer keeps each step's incoming grads in opt_state.
    jcfg = dict(CFG.model, backbone=dict(CFG.model.backbone, remat=False))
    jmodel = jbuild(jcfg)
    capture = optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p), lambda g, s, p=None: (g, g))
    schedule = jbuild_scheduler(dict(CFG.scheduler), total_steps)
    params = jax.tree.map(jnp.asarray, params)
    tx = optax.chain(capture, jbuild_optimizer(dict(CFG.optimizer), params, schedule))
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats=jax.tree.map(jnp.asarray, stats),
                       opt_state=tx.init(params),
                       constants=jax.tree.map(jnp.asarray, constants))
    step = make_train_step(jmodel, tx, schedule, ctx, metric_keys=CFG.metric_keys,
                           rng_seed=SEED)
    jarr = {k: jnp.asarray(v) for k, v in arrays.items()}
    failures = []

    def check(fn, *args, **kw):
        try:
            fn(*args, **kw)
        except AssertionError as e:
            failures.append(str(e).splitlines()[0])

    def to_port(p, s):
        return state_dict_from_jax_ponder_indoor(
            jax.device_get({"params": p, "batch_stats": s, "constants": constants}),
            channels, layers, levels)

    jmetrics, jgrads, jstate = [], [], [init]
    for k in range(2):
        state, m = step(state, jarr)
        jmetrics.append({key: float(v) for key, v in m.items()})
        jgrads.append(to_port(state.opt_state[0], stats))
        jstate.append(to_port(state.params, state.batch_stats))
    assert sorted(jstate[-1]) == sorted(init)  # the converters are inverses

    # --- port: the same weights, the Trainer's step, the JAX step's draws;
    # step 1 starts from the JAX state after step 0 (the optimizer keeps its
    # own momentum), so that each step is held from the same state
    model.load_state_dict({k: torch.from_numpy(v) for k, v in init.items()})
    model.train()
    opt = build_optimizer(dict(CFG.optimizer), model)
    tsched = build_scheduler(dict(CFG.scheduler), total_steps)
    inputs = {**{k: torch.from_numpy(v) for k, v in arrays.items()}, **ctx}
    B, V, H, W = arrays["depth"].shape
    for k in range(2):
        model.load_state_dict({n: torch.from_numpy(np.ascontiguousarray(v))
                               for n, v in jstate[k].items()})
        key = jax.random.fold_in(jax.random.PRNGKey(SEED), k)
        set_lr(opt, tsched(k))
        out = model({**inputs, "draws": port_draws(model, key, B, V, H * W)})
        out["loss"].backward()
        assert bool(out["contract_ok"]) and jmetrics[k]["contract_ok"] == 1.0
        for name in ("loss",) + tuple(CFG.metric_keys):
            check(assert_rel, float(out[name]), jmetrics[k][name], LOSS_REL,
                  f"step {k} {name}")
        assert tsched(k) == pytest.approx(jmetrics[k]["lr"], rel=1e-6)
        grads = {n: p.grad.numpy() for n, p in model.named_parameters()}
        top = max(np.abs(jgrads[k][n]).max() for n in grads)
        for name, g in grads.items():
            floor = top if np.abs(jgrads[k][name]).max() < GRAD_REL * top else None
            check(assert_rel, g, jgrads[k][name], GRAD_REL, f"step {k} grad {name}",
                  scale=floor)
        opt.step()
        opt.zero_grad(set_to_none=True)
        before, after = jstate[k], jstate[k + 1]
        for name, v in model.state_dict().items():
            if name == "class_embedding":
                np.testing.assert_array_equal(v.numpy(), after[name])
                continue
            # the step's update of each tensor; an update below the f32
            # resolution of the tensor, or below lr x the largest grad (a
            # grad that is zero by construction), is held to that instead
            ref = after[name] - before[name]
            floor = max(np.abs(ref).max(), 1e3 * np.finfo(np.float32).eps
                        * np.abs(after[name]).max(),
                        tsched(k) * top if name in grads else 0.0)
            check(assert_rel, v.numpy() - before[name], ref, GRAD_REL,
                  f"step {k} update {name}", scale=floor)
    assert not failures, "\n".join(failures)
    routes = [m.last_route for m in model.modules() if isinstance(m, SubMConv)]
    assert routes[0] == "slab" and routes[1:] == ["band-attached"] * 16
