"""The port's data-parallel train step against JAX's mesh step (P14).

Two SGD-Nesterov steps (OneCycle lr) of a small ``DefaultSegmentor`` (a
two-stage SpUNet-v1m1, ``test_torch_train.py``'s criteria, optimizer and
schedule; two stages keep the mesh compile short) with SyncBN: the port's
``Trainer`` in its
data-parallel branch on two gloo ranks (one scene each, the backbone's
``remat`` on, its default) against ``ponderv2_tpu.parallel.mesh.
make_sharded_train_step(sync_bn=True)`` on a two-device CPU mesh (the JAX
backbone without ``nn.remat``, as ``test_torch_train.py`` builds it), from
the same converted weights, on the same scenes collated by each package's
sharded collate. Compared: each step's loss and lr within 1e-5 relative,
``contract_ok``, every gradient of both steps within 1e-4 of max|ref|, and
the parameters and BN running statistics after the two steps within 1e-5;
the two ranks end with equal bits. One mesh compile serves the module.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_parallel_ranks as ranks
from ponderv2_tpu.datasets.utils import sharded_collate_fn as jsharded
from ponderv2_tpu.engines.train import TrainState
from ponderv2_tpu.models import build_model as jbuild
from ponderv2_tpu.parallel.mesh import (create_mesh, make_sharded_train_step,
                                        replicate_state, shard_batch)
from ponderv2_tpu.utils.optimizer import build_optimizer as jbuild_optimizer
from ponderv2_tpu.utils.scheduler import build_scheduler as jbuild_scheduler
from ponderv2_tpu_torch.datasets import build_dataset
from ponderv2_tpu_torch.datasets.utils import shard_collate_fn
from ponderv2_tpu_torch.engines.defaults import default_config_parser
from ponderv2_tpu_torch.models import build_model as tbuild
from ponderv2_tpu_torch.utils.convert import state_dict_from_jax_spunet
from test_torch_train import OPTIMIZER, SCHEDULER, SEGMENTOR as TRAIN_SEGMENTOR, assert_rel
from convert_torch_checkpoint import convert_spunet_v1m1  # noqa: E402  (tools/, on the path)
from jax_compile import background_compile  # noqa: E402
from torch_threads import _torch_threads  # noqa: F401, E402  (autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPATIAL = (160, 160, 64)
BUDGET = 8192  # global; 4096 a device
KEYS = ("feat", "grid_coord", "batch", "segment")
TOTAL_STEPS = 10
BACKBONE = dict(type="SpUNet-v1m1", in_channels=9, num_classes=20, base_channels=16,
                channels=(16, 32, 32, 16), layers=(1, 1, 1, 1))
SEGMENTOR = dict(TRAIN_SEGMENTOR, backbone=BACKBONE)
# the JAX backbone without nn.remat, as test_torch_train.py builds it
JSEGMENTOR = dict(SEGMENTOR, backbone=dict(BACKBONE, remat=False))


def seeded_weights():
    """Port weights from a seed (BN scale/bias and running stats drawn too)
    and the JAX variables the JAX package's converter makes of them."""
    model = tbuild(dict(SEGMENTOR))
    model.reset_parameters(torch.Generator().manual_seed(0))
    rng = np.random.RandomState(0)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.ndim == 1 and "final" not in name:
                lo, hi = (-0.2, 0.2) if name.endswith(".bias") else (0.5, 1.5)
                p.copy_(torch.from_numpy(rng.uniform(lo, hi, p.shape)))
        for name, b in model.named_buffers():
            lo, hi = (-0.2, 0.2) if name.endswith("running_mean") else (0.5, 2.0)
            b.copy_(torch.from_numpy(rng.uniform(lo, hi, b.shape)))
    sd = {k[len("backbone."):]: v.numpy() for k, v in model.state_dict().items()}
    params, stats = convert_spunet_v1m1(sd, BACKBONE["channels"], BACKBONE["layers"])
    return {"params": {"backbone_net": params}, "batch_stats": {"backbone_net": stats}}


def to_port_names(params, stats):
    """JAX SpUNet collections -> {port state_dict key: numpy array}."""
    sd = state_dict_from_jax_spunet(jax.device_get(params["backbone_net"]),
                                    jax.device_get(stats["backbone_net"]),
                                    BACKBONE["channels"], BACKBONE["layers"])
    return {f"backbone.{k}": np.asarray(v) for k, v in sd.items()}


def two_scenes():
    """Two ~3k-point synthetic scenes in ``test_torch_train.py``'s layout."""
    ds = build_dataset(dict(
        type="SyntheticDataset", num_scenes=2, points_per_scene=3000, num_classes=20,
        transform=[
            dict(type="CenterShift", apply_z=True),
            dict(type="GridSample", grid_size=0.05, hash_type="fnv", mode="train",
                 return_grid_coord=True),
            dict(type="CenterShift", apply_z=False),
            dict(type="NormalizeColor"),
            dict(type="Collect", keys=("coord", "grid_coord", "segment"),
                 feat_keys=("color", "normal", "coord"))]))
    state = np.random.get_state()
    np.random.seed(0)
    try:
        return [ds[0], ds[1]]
    finally:
        np.random.set_state(state)


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp_step")
    items = two_scenes()
    variables = seeded_weights()
    init = to_port_names(variables["params"], variables["batch_stats"])

    # --- JAX: two steps of the mesh step; an identity transform in front of
    # the optimizer keeps each step's (averaged) grads in opt_state
    glob = jsharded(copy.deepcopy(items), 2, point_budget=BUDGET, scene_budget=2)
    arrays = {k: glob[k] for k in KEYS}
    mesh = create_mesh(2)
    schedule = jbuild_scheduler(dict(SCHEDULER), TOTAL_STEPS)
    capture = optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p), lambda g, s, p=None: (g, g))
    tx = optax.chain(capture, jbuild_optimizer(dict(OPTIMIZER), variables["params"],
                                               schedule))
    state = replicate_state(TrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        batch_stats=variables["batch_stats"], opt_state=tx.init(variables["params"]),
        constants={}), mesh)
    # compiled in the background while the port's ranks run
    step = background_compile(make_sharded_train_step(
        jbuild(dict(JSEGMENTOR)), tx, schedule, dict(spatial_shape=SPATIAL, batch_size=1),
        mesh, sync_bn=True), state, shard_batch(arrays, mesh))

    # --- port: the Trainer's data-parallel branch on two gloo ranks
    cfg = default_config_parser(os.path.join(ROOT, "configs/_test_/semseg_synthetic.py"), {
        "save_path": str(tmp / "run"), "device": "cpu", "hooks": [], "seed": 0,
        "model": SEGMENTOR, "optimizer": OPTIMIZER, "scheduler": SCHEDULER,
        "sparse_shape": SPATIAL, "batch_size": 2, "point_budget": BUDGET,
        "sync_bn": True, "evaluate": False})
    shards = [{k: v for k, v in shard_collate_fn([copy.deepcopy(s)], 2, BUDGET, 2).items()
               if k in KEYS} for s in items]
    for r in range(2):
        for k in KEYS:
            assert np.array_equal(shards[r][k], glob[k][r]), k
    got = ranks.spawn(ranks.dp_step_rank, dict(
        cfg=cfg, state={k: torch.from_numpy(v) for k, v in init.items()},
        batches=[shards, shards], total_steps=TOTAL_STEPS), tmp)

    # --- JAX: the two mesh steps
    step = step.result()
    jmetrics, jgrads = [], []
    for _ in range(2):
        state, m = step(state, shard_batch(arrays, mesh))
        jmetrics.append({k: float(v) for k, v in m.items()})
        jgrads.append(to_port_names(state.opt_state[0], variables["batch_stats"]))
    jafter = to_port_names(state.params, state.batch_stats)
    return dict(jmetrics=jmetrics, jgrads=jgrads, jafter=jafter, ranks=got)


def test_dp_step_metrics_match_jax_mesh_step(steps):
    for k, (jm, m) in enumerate(zip(steps["jmetrics"], steps["ranks"][0]["metrics"])):
        assert m["loss"] == pytest.approx(jm["loss"], rel=1e-5), k
        assert m["lr"] == pytest.approx(jm["lr"], rel=1e-5), k
        assert m["contract_ok"] == jm["contract_ok"] == 1.0, k
    assert steps["ranks"][1]["metrics"] == steps["ranks"][0]["metrics"]


@pytest.mark.parametrize("k", [0, 1])
def test_dp_step_grads_match_jax_mesh_step(steps, k):
    """Every averaged gradient of step k, SyncBN's cross terms included."""
    grads = steps["ranks"][0]["grads"][k]
    assert len(grads) > 0 and set(grads) <= set(steps["jgrads"][k])
    for name, g in grads.items():
        assert_rel(g.numpy(), steps["jgrads"][k][name], 1e-4, f"grad {name}")
        assert torch.equal(g, steps["ranks"][1]["grads"][k][name]), name


def test_dp_params_and_stats_match_jax_mesh_step(steps):
    r0, r1 = steps["ranks"]
    for name, v in r0["state"].items():
        assert_rel(v.numpy(), steps["jafter"][name], 1e-5, f"after {name}")
        assert torch.equal(v, r1["state"][name]), name
