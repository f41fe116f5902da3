"""PyTorch port vs JAX package: PonderOutdoor-v2 (the nuScenes LiDAR
pretrain).

On ``tests/test_ponder_outdoor.py``'s model (test widths) and batch (two
scenes, 800 voxels, 64 rays each; copied here, since that file is the JAX
package's and marked slow), with the block mask of the nuScenes configs
(ratio 0.8, blocks of 8, 4 channels), the colour head, and the CLIP
semantic head of ``-base-semantic`` (its temperature, ``semantic_min_label``
0 and the committed nuScenes class embeddings):

- ``block_mask_keep`` equal to the JAX function's bit for bit for the same
  seed, padding rows kept;
- one JAX ``make_train_step`` with the nuScenes pretrain's AdamW and
  OneCycle, from random weights (every leaf, BN statistics included, drawn
  from a seed; carried to the port by ``state_dict_from_jax_ponder_outdoor``)
  and the step's own key; the port's forward on the same weights with the
  JAX step's draws (its mask seed and the NeuS sampler's uniforms):
  every loss term within 1e-5 relative; every grad within 1e-5 of its
  max|ref| (``GRAD_REL``) plus 3x the JAX step's own f32 rounding of that
  grad (its distance from the port's float64 run on the same weights,
  batch and draws); the running statistics after the step within
  1e-5 of max|ref|; the port's AdamW fed the JAX step's grads gives the JAX
  step's parameters within 1e-6 of the update's max|ref| (or f32's
  resolution of the value);
- the plan kind at each level, the rulebooks and the band plans at
  nuScenes' ``sparse_shape``: ``test_torch_outdoor_plans.py``.

Why a grad's bound holds its f32 rounding beside 1e-5: on this batch the
JAX step in f32 is up to 3.2e-5 of a grad's max|ref| from the same step in
float64 (the BN biases and scales of the backbone, ``mtoken``), so two
correct f32 steps can differ by more than 1e-5. The JAX backbone runs with
``remat=False`` (ROADMAP Queue 3).
"""

import os
from types import SimpleNamespace

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from ponderv2_tpu.engines.train import TrainState, make_train_step
from ponderv2_tpu.models import build_model as jbuild
from ponderv2_tpu.models.ponder.ponder_outdoor import block_mask_keep as jax_keep
from ponderv2_tpu.utils.optimizer import build_optimizer as jbuild_optimizer
from ponderv2_tpu.utils.scheduler import build_scheduler as jbuild_scheduler
from ponderv2_tpu_torch.models import build_model as tbuild
from ponderv2_tpu_torch.models.ponder.ponder_outdoor import block_mask_keep
from ponderv2_tpu_torch.utils.config import Config
from ponderv2_tpu_torch.utils.convert import state_dict_from_jax_ponder_outdoor
from ponderv2_tpu_torch.utils.optimizer import build_optimizer, set_lr
from ponderv2_tpu_torch.utils.scheduler import build_scheduler
from jax_compile import compile_now  # noqa: E402
from torch_threads import _torch_threads  # noqa: F401, E402  (autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUSCENES = Config.fromfile(os.path.join(
    ROOT, "configs/nuscenes/pretrain-ponder-spunet-v1m1-0-base-semantic.py"))
SEED = 0
TOTAL_STEPS = 10
LOSS_REL, GRAD_REL = 1e-5, 1e-5
TERMS = ("depth_loss", "rgb_loss", "psnr", "semantic_loss", "eikonal_loss",
         "free_space_loss", "sdf_loss")
NUSCENES_SHAPE = tuple(NUSCENES.sparse_shape)

# tests/test_ponder_outdoor.py:MODEL_CFG, with the nuScenes configs' mask,
# the colour head and the semantic head of -base-semantic
MODEL_CFG = dict(
    type="PonderOutdoor-v2",
    backbone=dict(
        type="SpUNet-v1m1",
        in_channels=4,
        num_classes=0,
        base_channels=8,
        channels=(8, 16, 16, 16, 16, 16, 8, 8),
        layers=(1, 1, 1, 1, 1, 1, 1, 1),
    ),
    projection=dict(type="SimpleConv3D-v1m1", in_channels=8, out_channels=16),
    renderer=dict(
        type="NeuSModel",
        field=dict(hidden_dim=32, num_layers=2, geo_feat_dim=8,
                   use_color=True, use_semantic=True, semantic_dim=512,
                   share_volume=True),
        collider=dict(type="AABBBoxCollider", near_plane=0.01),
        sampler=dict(type="NeuSSampler", num_samples=12,
                     num_samples_importance=4, num_upsample_steps=1),
        loss=dict(sensor_depth_truncation=0.01, temperature=0.01, semantic_min_label=0,
                  weights=dict(rgb=10.0, depth=1.0, eikonal=0.01,
                               free_space=1.0, sdf=10.0, semantic=0.1)),
    ),
    grid_shape=(24, 24, 4),
    point_cloud_range=(-10.0, -10.0, -2.0, 10.0, 10.0, 2.0),
    conditions=("NuScenes",),
    mask=dict(NUSCENES.model.mask),
    render_semantic=True,
    class_name=tuple(NUSCENES.model.class_name),
    valid_index=tuple(tuple(v) for v in NUSCENES.model.valid_index),
)
CTX = dict(spatial_shape=(128, 128, 32), batch_size=2)


@pytest.fixture(autouse=True)
def _torch_state():
    dtype, threads = torch.get_default_dtype(), torch.get_num_threads()
    torch.set_default_dtype(torch.float32)
    torch.set_num_threads(2)
    yield
    torch.set_default_dtype(dtype)
    torch.set_num_threads(threads)


def make_outdoor_batch(rng, n=800, cap=1024, batch=2, rays=64):
    """``tests/test_ponder_outdoor.py:make_outdoor_batch`` (numpy arrays),
    with ``ray_segment`` labels (-1 and the 16 classes) for the semantic
    head."""
    b_all = rng.randint(0, batch, n)
    cells = np.stack(np.meshgrid(np.arange(80), np.arange(80), np.arange(15),
                                 indexing="ij"), -1).reshape(-1, 3)
    grid_list = np.zeros((n, 3), np.int64)
    for i in range(batch):
        m = b_all == i
        grid_list[m] = cells[rng.choice(len(cells), int(m.sum()), replace=False)]
    coord = (grid_list * 0.2 - np.array([8, 8, 1.5])
             + rng.rand(n, 3) * 0.2).astype(np.float32)
    pad = cap - n
    coordp = np.concatenate([coord, np.zeros((pad, 3), np.float32)])
    strength = rng.rand(cap, 1).astype(np.float32)
    feat = np.concatenate([coordp, strength], axis=1).astype(np.float32)
    grid = np.concatenate([grid_list.astype(np.int32), np.full((pad, 3), -1, np.int32)])
    b = np.concatenate([b_all, np.full(pad, -1)]).astype(np.int32)
    pick = rng.randint(0, n, (batch, rays))
    ray_end = coord[pick]
    ray_start = np.tile(np.array([[0.0, 0.0, 1.0]], np.float32), (batch, rays, 1))
    ray_rgb = (rng.rand(batch, rays, 3) * 255).astype(np.float32)
    return dict(feat=feat, grid_coord=grid, batch=b, coord=coordp,
                ray_start=ray_start, ray_end=ray_end.astype(np.float32), ray_rgb=ray_rgb,
                ray_segment=rng.randint(-1, 16, (batch, rays)).astype(np.int64),
                ray_valid=np.ones((batch, rays), bool))


def random_variables(shapes, class_embedding):
    """Every leaf of the JAX variables drawn from a seed: BN scales in
    [0.5, 1.5], biases and means in [-0.2, 0.2], variances in [0.5, 2],
    kernels uniform over +-1/sqrt(fan_in); the NeuS variance 0.3 and the
    committed class embeddings."""
    vr = np.random.RandomState(SEED + 1)

    def fill(path, s):
        name = "/".join(str(getattr(p, "key", p)) for p in path)
        if name.endswith("var"):
            return vr.uniform(0.5, 2.0, s.shape).astype(np.float32)
        if name.endswith("scale"):
            return vr.uniform(0.5, 1.5, s.shape).astype(np.float32)
        if name.endswith("mean") or name.endswith("bias"):
            return vr.uniform(-0.2, 0.2, s.shape).astype(np.float32)
        fan_in = int(np.prod(s.shape[:-1])) or 1
        return (vr.uniform(-1, 1, s.shape) / np.sqrt(fan_in)).astype(np.float32)

    variables = {k: v for k, v in shapes.items() if k in ("params", "batch_stats")}
    variables = jax.tree_util.tree_map_with_path(fill, variables)
    field = variables["params"]["render_model"]["field"]
    field["deviation_network"]["variance"] = np.full(
        np.shape(field["deviation_network"]["variance"]), 0.3, np.float32)
    variables["constants"] = {"class_embedding": np.asarray(class_embedding)}
    return variables


def to_port(variables):
    bb = MODEL_CFG["backbone"]
    return state_dict_from_jax_ponder_outdoor(jax.device_get(variables), bb["channels"],
                                              bb["layers"])


@pytest.fixture(scope="module")
def jax_step():
    """One JAX train step (AdamW, OneCycle over ``TOTAL_STEPS``) from random
    weights: its metrics, grads and the state after it, in the port's
    names, and the draws its key gives."""
    arrays = make_outdoor_batch(np.random.RandomState(SEED))
    tmodel = tbuild(dict(MODEL_CFG))
    jmodel = jbuild(dict(MODEL_CFG, backbone=dict(MODEL_CFG["backbone"], remat=False)))
    jarr = {k: jnp.asarray(v) for k, v in arrays.items()}
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(1), {**jarr, **CTX},
                                                train=False))
    variables = random_variables(shapes, tmodel.class_embedding.numpy())
    init = to_port(variables)

    capture = optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p), lambda g, s, p=None: (g, g))
    schedule = jbuild_scheduler(dict(NUSCENES.scheduler), TOTAL_STEPS)
    params = jax.tree.map(jnp.asarray, variables["params"])
    tx = optax.chain(capture, jbuild_optimizer(dict(NUSCENES.optimizer), params, schedule))
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
                       opt_state=tx.init(params),
                       constants=jax.tree.map(jnp.asarray, variables["constants"]))
    step = compile_now(make_train_step(jmodel, tx, schedule, CTX, metric_keys=TERMS,
                                       rng_seed=SEED), state, jarr)
    state, metrics = step(state, jarr)
    grads = to_port({"params": state.opt_state[0], "batch_stats": variables["batch_stats"]})
    after = to_port({"params": state.params, "batch_stats": state.batch_stats})

    # the step's draws: PonderOutdoor splits its key into (render, mask);
    # the mask seed is randint(mask key, 0, int32 max); NeuSSampler splits
    # the render key once per draw
    key = jax.random.fold_in(jax.random.PRNGKey(SEED), 0)
    render_key, mask_key = jax.random.split(key)
    draw_shapes = tmodel.renderer.draw_shapes(arrays["ray_start"].shape[:2])
    keys = jax.random.split(render_key, len(draw_shapes))
    draws = dict(
        mask_seed=int(jax.random.randint(mask_key, (), 0, jnp.iinfo(jnp.int32).max)),
        sampler=[torch.from_numpy(np.array(jax.random.uniform(k, s)))
                 for k, s in zip(keys, draw_shapes)])
    return SimpleNamespace(arrays=arrays, init=init, grads=grads, after=after, draws=draws,
                           metrics={k: float(v) for k, v in metrics.items()},
                           mask_key=mask_key)


@pytest.fixture(scope="module")
def port_step(jax_step):
    """The port's training forward and backward on the JAX step's weights,
    batch and draws."""
    model = tbuild(dict(MODEL_CFG))
    model.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in jax_step.init.items()})
    model.train()
    inputs = {k: torch.from_numpy(v) for k, v in jax_step.arrays.items()}
    out = model({**inputs, **CTX, "draws": jax_step.draws})
    out["loss"].backward()
    return SimpleNamespace(model=model, out=out)


@pytest.fixture(scope="module")
def port_grads_float64(jax_step):
    """The port's grads in float64 on the JAX step's weights, batch and
    draws: the reference that measures each grad's f32 rounding."""
    def f64(t):
        return t.double() if t.is_floating_point() else t

    model = tbuild(dict(MODEL_CFG)).double()
    model.load_state_dict({k: f64(torch.from_numpy(np.array(v)))
                           for k, v in jax_step.init.items()})
    model.train()
    inputs = {k: f64(torch.from_numpy(v)) for k, v in jax_step.arrays.items()}
    draws = dict(jax_step.draws, sampler=[f64(u) for u in jax_step.draws["sampler"]])
    model({**inputs, **CTX, "draws": draws})["loss"].backward()
    return {n: p.grad.numpy() for n, p in model.named_parameters()}


def assert_within(out, ref, bound, where):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape, (where, out.shape, ref.shape)
    err = np.abs(out - ref).max()
    assert err <= bound, f"{where}: err {err:.3e} > {bound:.3e}"


@pytest.mark.parametrize("size,ratio,seed", [(8, 0.8, 12345), (1, 0.5, 2 ** 31 - 2),
                                             (4, 0.0, 7), (8, 1.0, 0)])
def test_block_mask_keep_equals_jax_bit_for_bit(size, ratio, seed):
    """The keep mask over coordinates up to nuScenes' grid (and -1 padding
    rows) for one seed equals JAX's; padding rows are kept; the mask is
    constant over each (scene, block)."""
    rng = np.random.RandomState(size)
    n = 20000
    grid = rng.randint(0, 1440, (n, 3)).astype(np.int32)
    grid[:, 2] %= 108
    batch = rng.randint(-1, 12, n).astype(np.int32)
    grid[batch < 0] = -1
    want = np.asarray(jax_keep(jnp.asarray(grid), jnp.asarray(batch), size, ratio,
                               jax.random.PRNGKey(0)))
    # the JAX function draws its seed from the key; hand the port the same
    jseed = int(jax.random.randint(jax.random.PRNGKey(0), (), 0,
                                   jnp.iinfo(jnp.int32).max))
    got = block_mask_keep(torch.from_numpy(grid), torch.from_numpy(batch), size, ratio,
                          jseed).numpy()
    assert np.array_equal(got, want)
    assert got[batch < 0].all()
    # and an explicit seed through a 0-d tensor, as the trainer's draws give it
    t = block_mask_keep(torch.from_numpy(grid), torch.from_numpy(batch), size, ratio,
                        torch.tensor(seed))
    assert np.array_equal(t.numpy(), block_mask_keep(torch.from_numpy(grid),
                                                     torch.from_numpy(batch), size,
                                                     ratio, seed).numpy())
    live = batch >= 0
    blocks = np.stack([batch, *(grid // size).T], 1)[live]
    _, inverse = np.unique(blocks, axis=0, return_inverse=True)
    per_block = np.zeros(inverse.max() + 1, int)
    np.add.at(per_block, inverse.reshape(-1), 1)
    kept = np.zeros_like(per_block)
    np.add.at(kept, inverse.reshape(-1), got[live].astype(int))
    assert np.all((kept == 0) | (kept == per_block))


def test_per_condition_is_the_jax_one():
    """``_per_condition`` is a copy of the JAX function, and resolves flat
    and per-condition tuples alike."""
    import inspect

    from ponderv2_tpu.models.ponder import ponder_outdoor as jpo
    from ponderv2_tpu_torch.models.ponder import ponder_outdoor as tpo

    assert inspect.getsource(tpo._per_condition) == inspect.getsource(jpo._per_condition)
    flat = (-10.0, -10.0, -2.0, 10.0, 10.0, 2.0)
    per = ((-10.0,) * 6, (-20.0,) * 6)
    assert tpo._per_condition(flat, 1) == flat and tpo._per_condition(per, 1) == (-20.0,) * 6


def test_mask_seed_and_keep_of_the_train_step(jax_step):
    """The seed the port takes from the step's key gives the mask the JAX
    model applies in that step."""
    arrays = jax_step.arrays
    want = np.asarray(jax_keep(jnp.asarray(arrays["grid_coord"]),
                               jnp.asarray(arrays["batch"]), 8, 0.8, jax_step.mask_key))
    got = block_mask_keep(torch.from_numpy(arrays["grid_coord"]),
                          torch.from_numpy(arrays["batch"]), 8, 0.8,
                          jax_step.draws["mask_seed"]).numpy()
    assert np.array_equal(got, want)
    assert 0.1 < got[arrays["batch"] >= 0].mean() < 0.5  # about 1 - ratio of blocks


def test_loss_terms_match_jax(jax_step, port_step):
    """The loss and each term (depth, rgb, psnr, semantic, eikonal, free
    space, sdf) within 1e-5 relative of the JAX step's; contract_ok."""
    out = port_step.out
    for k in ("loss",) + TERMS:
        ref = jax_step.metrics[k]
        got = float(out[k].detach())
        assert abs(got - ref) <= LOSS_REL * abs(ref), (k, got, ref)
    assert bool(out["contract_ok"]) and jax_step.metrics["contract_ok"] == 1.0


def test_grads_match_jax(jax_step, port_step, port_grads_float64):
    """Every parameter's grad (backbone, projection, field, mask token)
    within ``GRAD_REL`` of its max|ref| plus 3x the JAX grad's distance
    from the port's float64 grad; a grad that is zero by construction up
    to f32 cancellation (the projection's conv bias, ahead of a training-
    mode BN) against the largest grad. The port's own f32 rounding is held
    no coarser than the JAX step's, within the same bound."""
    grads = {n: p.grad for n, p in port_step.model.named_parameters()}
    assert sorted(grads) == sorted(k for k in jax_step.grads if k in grads)
    assert {"mtoken", "proj_net.conv.weight",
            "renderer.field.semantic_decoder.lin0.weight"} <= set(grads)
    top = max(np.abs(g).max() for g in jax_step.grads.values())
    for name, g in grads.items():
        ref = jax_step.grads[name]
        scale = top if name == "proj_net.conv.bias" else np.abs(ref).max()
        assert g is not None and np.isfinite(g.numpy()).all(), name
        rounding = np.abs(ref.astype(np.float64) - port_grads_float64[name]).max()
        assert_within(g.numpy(), ref, GRAD_REL * scale + 3 * rounding, name)
        assert_within(g.numpy(), port_grads_float64[name], GRAD_REL * scale + 3 * rounding,
                      f"{name} (float64)")
    assert np.abs(grads["mtoken"].numpy()).sum() > 0


def test_running_stats_after_the_step_match_jax(jax_step, port_step):
    """The backbone's and the projection's BN running statistics after the
    training forward within 1e-5 of max|ref| of the JAX step's."""
    state = port_step.model.state_dict()
    names = [k for k in jax_step.after if "running_" in k]
    assert any(k.startswith("proj_net.") for k in names)
    for k in names:
        ref = jax_step.after[k]
        assert_within(state[k].numpy(), ref, 1e-5 * np.abs(ref).max(), k)


def test_adamw_step_matches_jax_train_step(jax_step):
    """The port's AdamW at the OneCycle lr of step 0, fed the JAX step's
    grads, moves every parameter as the JAX step did: within 1e-6 of the
    update's max|ref| or f32's resolution of the value."""
    model = tbuild(dict(MODEL_CFG))
    model.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in jax_step.init.items()})
    opt = build_optimizer(dict(NUSCENES.optimizer), model)
    schedule = build_scheduler(dict(NUSCENES.scheduler), TOTAL_STEPS)
    lr = float(schedule(0))
    assert abs(lr - jax_step.metrics["lr"]) <= 1e-6 * jax_step.metrics["lr"]
    set_lr(opt, lr)
    for name, p in model.named_parameters():
        p.grad = torch.from_numpy(np.array(jax_step.grads[name]))
    opt.step()
    for name, p in model.named_parameters():
        ref = jax_step.after[name]
        update = ref - jax_step.init[name]
        bound = max(1e-6 * np.abs(update).max(), 1.2e-7 * np.abs(ref).max())
        assert_within(p.detach().numpy(), ref, bound, name)
