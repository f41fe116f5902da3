"""PyTorch port vs JAX package: the host SpUNet plan prefetch.

``models/sparse_unet/plans.py:host_build_spunet_plans`` against the JAX
function of that name: every integer leaf of the plans equal, on a collated
batch with padding rows and on a scene dense enough that the budget retry
doubles the band budgets. ``engines/plan_prefetch.py``'s
``plan_cfg_from_model_cfg`` against JAX's for every config under
``configs/``, ``PlanPrefetchLoader`` (order, ``len``, an exception raised in
the consumer), the pretrain ``Trainer`` with ``host_plans`` on and off (the
same bits), and PonderIndoor-v2's forward on host-built plans against the
JAX model's on the JAX host build (backbone features within 1e-5 of
max|ref| in f32, through the JAX package's converter). The JAX compiles
are shared through module fixtures.
"""

import glob
import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ponderv2_tpu.engines import plan_prefetch as jprefetch
from ponderv2_tpu.models import build_model as jbuild
from ponderv2_tpu.models.sparse_unet import plans as jplans
from ponderv2_tpu.ops import spconv as jsp
from ponderv2_tpu_torch.engines import plan_prefetch as tprefetch
from ponderv2_tpu_torch.models import build_model as tbuild
from ponderv2_tpu_torch.models.sparse_unet import plans as tplans
from ponderv2_tpu_torch.ops.spconv import SubmPlan
from ponderv2_tpu_torch.utils.config import Config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from convert_torch_checkpoint import convert_ponder_indoor  # noqa: E402
from test_torch_pretrain_step import CFG, pretrain_batch, seeded_state_dict  # noqa: E402

# pretrain_synthetic.py's grid, batch and budget, its backbone cut to two
# stages (short JAX compiles; the plans' tests and the forward's share one)
SHAPE = tuple(CFG.sparse_shape)
BATCH = CFG.batch_size
CAP = CFG.point_budget
CHANNELS = (8, 16, 16, 8)


@pytest.fixture(autouse=True)
def _torch_state():
    dtype, threads = torch.get_default_dtype(), torch.get_num_threads()
    torch.set_default_dtype(torch.float32)
    torch.set_num_threads(1)  # one thread: CPU row-gather backwards in one order
    yield
    torch.set_default_dtype(dtype)
    torch.set_num_threads(threads)


def collated(rng, n=3000, cap=CAP):
    """A collated batch's ``grid_coord`` (cap, 3) and ``batch`` (cap,):
    unique voxels of two scenes sorted by (b, x, y, z), then padding rows
    with ``batch`` -1 and arbitrary grid coordinates (the build makes them
    all -1)."""
    c = np.stack([rng.randint(0, BATCH, n), rng.randint(0, SHAPE[0], n),
                  rng.randint(0, SHAPE[1], n), rng.randint(0, SHAPE[2], n)], 1)
    c = np.unique(c, axis=0).astype(np.int32)
    pad = cap - len(c)
    grid = np.concatenate([c[:, 1:], rng.randint(0, 9, (pad, 3)).astype(np.int32)])
    batch = np.concatenate([c[:, 0], np.full(pad, -1, np.int32)])
    return grid, batch


def _arr(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def assert_plans_equal(jp, tp):
    """Every integer leaf of the port's plans equal to JAX's: the rulebooks
    (a ``SubmPlan``'s ``legacy``, or a plain one), ``sorted_ok``, the band
    plans' windows, tap rows, overflow entries and ``ok``, the strided
    plans' coords, rulebooks and parent / tap, the inverse rulebooks, with
    ``None`` where JAX has ``None``. The JAX stem plan carries no legacy
    rulebook; the port's is held to JAX's k5 rulebook of the same coords."""
    def plan(a, b, where, ref_legacy=None):
        assert isinstance(a, jsp.SubmPlan) == isinstance(b, SubmPlan), where
        if not isinstance(b, SubmPlan):
            np.testing.assert_array_equal(_arr(a), _arr(b), err_msg=where)
            return
        legacy = a.legacy if a.legacy is not None else ref_legacy
        np.testing.assert_array_equal(_arr(legacy), _arr(b.legacy), err_msg=where)
        assert bool(a.sorted_ok) == bool(b.sorted_ok), where
        assert (a.band is None) == (b.band is None), where
        if b.band is not None:
            for field in ("rbt", "w0", "ok", "ov_i", "ov_j", "ov_t"):
                np.testing.assert_array_equal(_arr(getattr(a.band, field)),
                                              _arr(getattr(b.band, field)),
                                              err_msg=f"{where} band.{field}")
    return plan


def check_plans(jp, tp, coords, shape, batch_size):
    plan = assert_plans_equal(jp, tp)
    stem_legacy = jsp.build_subm_rulebook(jnp.asarray(coords), shape, batch_size, 5)
    plan(jp.stem, tp.stem, "stem", stem_legacy)
    assert len(jp.strided) == len(tp.strided)
    for s, (a, b) in enumerate(zip(jp.strided, tp.strided)):
        for i, (x, y) in enumerate(zip(a, b)):
            assert (x is None) == (y is None), (s, i)
            if y is not None:
                np.testing.assert_array_equal(_arr(x), _arr(y), err_msg=f"strided {s}.{i}")
    for s, (a, b) in enumerate(zip(jp.subm, tp.subm)):
        plan(a, b, f"subm {s}")
    plan(jp.l0, tp.l0, "l0")
    for s, (a, b) in enumerate(zip(jp.inv, tp.inv)):
        assert (a is None) == (b is None), s
        if b is not None:
            np.testing.assert_array_equal(_arr(a), _arr(b), err_msg=f"inv {s}")


def test_host_build_matches_jax_with_padding_rows():
    """A collated batch of two scenes with padding rows: the port's host
    build equals JAX's leaf for leaf (a band plan at every level, as every
    k3 conv is band-eligible), and equals the port's own build on the
    model's coords (what the model builds inline)."""
    grid, batch = collated(np.random.RandomState(3))
    caps = tplans.capacity_schedule(grid.shape[0], len(CHANNELS) // 2)
    jp = jplans.host_build_spunet_plans(grid, batch, SHAPE, BATCH, caps, CHANNELS)
    tp = tplans.host_build_spunet_plans(grid, batch, SHAPE, BATCH, caps, CHANNELS)
    coords = np.concatenate([batch[:, None], grid], 1)
    coords = np.where((batch >= 0)[:, None], coords, -1).astype(np.int32)
    check_plans(jp, tp, coords, SHAPE, BATCH)
    assert tp.l0.band is not None and all(bool(f) for f in tplans.band_ok_flags(tp))
    inline = tplans.build_spunet_plans_auto(torch.from_numpy(coords), SHAPE, BATCH, caps,
                                            CHANNELS)
    flat = lambda p: [x for x in jax.tree.leaves(  # noqa: E731
        tplans.map_tensors(p, lambda t: t.numpy()))]
    assert all(np.array_equal(a, b) for a, b in zip(flat(inline), flat(tp)))


def test_host_build_doubles_budgets_as_jax():
    """``tests/test_plans.py::test_band_budgets_auto_size``'s scene: dense
    (32 y x 16 z) and sparse (4 y x 4 z) x-slices alternate, so that L0's
    band plan overflows entry budgets of 1024; both builds double the
    budgets once, to (128, 2048), and give equal plans (one stage, to keep
    the two JAX compiles short)."""
    S = 32
    rows = [(0, x, y, z) for x in range(S)
            for y in (range(S) if x % 2 == 0 else range(0, S, 8))
            for z in range(16 if x % 2 == 0 else 4)]
    coords = np.array(rows, np.int32)
    shape = (S, S, 16)
    channels = (8, 8)
    caps = tplans.capacity_schedule(len(coords), 1)
    args = (coords[:, 1:], coords[:, 0], shape, 1, caps, channels)
    jp = jplans.host_build_spunet_plans(*args, band_budgets=(64, 1024))
    tp = tplans.host_build_spunet_plans(*args, band_budgets=(64, 1024))
    check_plans(jp, tp, coords, shape, 1)
    assert all(bool(f) for f in tplans.band_ok_flags(tp))
    assert tp.l0.band.ov_i.shape[0] == jp.l0.band.ov_i.shape[0] == 2048
    assert int((tp.l0.band.ov_i >= 0).sum()) > 1024
    first = tplans.build_spunet_plans(torch.from_numpy(coords), shape, 1, caps, channels,
                                      (64, 1024))
    assert not all(bool(f) for f in tplans.band_ok_flags(first))


def _configs():
    return sorted(glob.glob(os.path.join(ROOT, "configs", "**", "*.py"), recursive=True))


def test_plan_cfg_matches_jax_for_every_config():
    """``plan_cfg_from_model_cfg`` equal to JAX's for every config that
    the port loads (the JAX bench's own ``pretrain_bench.py`` names JAX
    dtypes and is read through its port twin), and on the model dicts that
    test each condition."""
    from ponderv2_tpu.utils.config import Config as JConfig

    ctx = dict(spatial_shape=(544, 544, 192), batch_size=2)
    applied = []
    for path in _configs():
        if os.path.basename(os.path.dirname(path)) == "_base_":
            continue
        if path.endswith("_test_/pretrain_bench.py"):
            continue
        tcfg = Config.fromfile(path)
        if "model" not in tcfg:
            continue
        jcfg = JConfig.fromfile(path)
        got = tprefetch.plan_cfg_from_model_cfg(dict(tcfg.model), ctx)
        assert got == jprefetch.plan_cfg_from_model_cfg(dict(jcfg.model), ctx), path
        if got is not None:
            applied.append(os.path.relpath(path, ROOT))
    assert applied == ["configs/_test_/pretrain_bench_torch.py"]
    for model in (dict(assume_sorted=True, backbone=dict(type="SpUNet-v1m2")),
                  dict(assume_sorted=True, backbone=dict(
                      type="SpUNet-v1m1", capacities=[8, 4], channels=[8, 8],
                      slab_conv=False)),
                  dict(assume_sorted=True, backbone=dict(type="MinkUNet34C")),
                  dict(assume_sorted=False, backbone=dict(type="SpUNet-v1m1")),
                  dict(type="PonderOutdoor-v2", assume_sorted=True,
                       backbone=dict(type="SpUNet-v1m1")), [], None):
        assert (tprefetch.plan_cfg_from_model_cfg(model, ctx)
                == jprefetch.plan_cfg_from_model_cfg(model, ctx)), model


class _Loader:
    def __init__(self, batches, fail_at=None):
        self.batches, self.fail_at = batches, fail_at

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        for i, b in enumerate(self.batches):
            if i == self.fail_at:
                raise ValueError("the loader raised")
            yield b


def test_prefetch_loader_order_len_and_errors():
    """Batches come in the loader's order with their plans attached, one
    ``build_seconds`` each; ``len`` is the loader's; an exception in the
    loader, or in the build (a batch without ``grid_coord``), is raised in
    the consumer."""
    rng = np.random.RandomState(5)
    batches = []
    for i in range(3):
        grid, batch = collated(rng, n=600, cap=1024)
        batches.append(dict(grid_coord=grid, batch=batch, index=i))
    cfg = dict(spatial_shape=SHAPE, batch_size=BATCH, capacities=None,
               channels=CHANNELS, slab_conv=True)
    loader = tprefetch.PlanPrefetchLoader(_Loader(batches), cfg)
    assert len(loader) == 3
    got = list(loader)
    assert [b["index"] for b in got] == [0, 1, 2]
    assert len(loader.build_seconds) == 3
    for b in got:
        ref = tprefetch.attach_plans(b, cfg)["spunet_plans"]
        assert torch.equal(b["spunet_plans"].stem.legacy, ref.stem.legacy)
    with pytest.raises(ValueError, match="the loader raised"):
        list(tprefetch.PlanPrefetchLoader(_Loader(batches, fail_at=1), cfg))
    with pytest.raises(KeyError, match="grid_coord"):
        list(tprefetch.PlanPrefetchLoader(_Loader([dict(batch=batches[0]["batch"])]), cfg))


def _trainer_steps(tmp, host_plans, monkeypatch):
    """Two SGD steps of the pretrain ``Trainer`` on the CPU
    (``configs/_test_/pretrain_synthetic.py`` with ``assume_sorted``):
    (losses, each step's grads, the parameters after), and the number of
    plan builds inside the steps."""
    from ponderv2_tpu_torch.engines.defaults import default_config_parser, default_setup
    from ponderv2_tpu_torch.engines.train import Trainer
    from ponderv2_tpu_torch.models.sparse_unet import spunet

    cfg = default_config_parser(
        os.path.join(ROOT, "configs/_test_/pretrain_synthetic.py"),
        {"save_path": str(tmp), "device": "cpu", "seed": 0, "host_plans": host_plans,
         "model.assume_sorted": True, "hooks": []})
    trainer = Trainer(default_setup(cfg))
    assert isinstance(trainer.train_loader, tprefetch.PlanPrefetchLoader) == host_plans
    builds = []
    inline = spunet.build_spunet_plans_auto
    monkeypatch.setattr(spunet, "build_spunet_plans_auto",
                        lambda *a, **k: builds.append(1) or inline(*a, **k))
    grads, losses = [], []
    step = trainer.optimizer.step

    def recording_step(*a, **k):
        grads.append([p.grad.clone() for p in trainer.model.parameters()
                      if p.grad is not None])
        return step(*a, **k)

    trainer.optimizer.step = recording_step
    for i, batch in enumerate(trainer.train_loader):
        assert ("spunet_plans" in batch) == host_plans
        trainer.comm_info["input_dict"] = batch
        trainer.run_step()
        losses.append(trainer.comm_info["metrics"]["loss"])
        if i == 1:
            break
    return losses, grads, [p.detach().clone() for p in trainer.model.parameters()], len(builds)


def test_trainer_host_plans_give_the_same_bits(tmp_path, monkeypatch):
    """Two SGD steps with ``host_plans`` on and off: the loss, every grad
    and every parameter bit-equal; with it on no plan is built inside a
    step."""
    on = _trainer_steps(tmp_path / "on", True, monkeypatch)
    off = _trainer_steps(tmp_path / "off", False, monkeypatch)
    assert on[3] == 0 and off[3] == 2
    assert [torch.equal(a, b) for a, b in zip(on[0], off[0])] == [True, True]
    for ga, gb in zip(on[1], off[1]):
        assert len(ga) == len(gb) and all(torch.equal(a, b) for a, b in zip(ga, gb))
    assert all(torch.equal(a, b) for a, b in zip(on[2], off[2]))


def test_ponder_forward_on_host_plans_matches_jax():
    """PonderIndoor-v2 (``pretrain_synthetic.py`` with ``assume_sorted``,
    its backbone cut to two stages to keep the JAX compiles short) in eval
    mode on the port's host-built plans: its backbone's features within
    1e-5 of max|ref| of the JAX model's backbone call on the JAX host build
    (``ponder_indoor.py:280-288``, the JAX backbone without ``remat``), and
    equal to the port's own forward that builds its plans inside."""
    from ponderv2_tpu.models.default import batch_to_sparse_tensor as jto_sparse
    from ponderv2_tpu.ops.sparse import make_sparse_tensor, maybe_sort_by_key as jsort

    batch = pretrain_batch()
    bcfg = dict(CFG.model.backbone, channels=CHANNELS, layers=(1, 1, 1, 1))
    model_cfg = dict(CFG.model, assume_sorted=True, backbone=bcfg)
    ctx = dict(spatial_shape=tuple(CFG.sparse_shape), batch_size=CFG.batch_size)
    model = tbuild(dict(model_cfg))
    sd = seeded_state_dict(model)
    model.eval()
    plan_cfg = tprefetch.plan_cfg_from_model_cfg(model_cfg, ctx)
    plans = tprefetch.attach_plans(batch, plan_cfg)["spunet_plans"]
    feats = []
    model.backbone.register_forward_hook(lambda m, a, out: feats.append(out[0]) and None)
    inputs = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        model({**inputs, **ctx, "spunet_plans": plans})
        model({**inputs, **ctx})
    assert torch.equal(feats[0], feats[1])

    jcfg = dict(model_cfg, backbone=dict(model_cfg["backbone"], remat=False))
    jmodel = jbuild(jcfg)
    assert jprefetch.plan_cfg_from_model_cfg(jcfg, ctx) == plan_cfg
    jplans_ = jprefetch.attach_plans(batch, plan_cfg)["spunet_plans"]
    params, stats, constants = convert_ponder_indoor(
        sd, bcfg["channels"], bcfg["layers"], CFG.model.projection.num_levels)
    variables = {"params": params, "batch_stats": stats,
                 "constants": jax.tree.map(jnp.asarray, constants)}
    jst, _ = jsort(jto_sparse({**{k: jnp.asarray(v) for k, v in batch.items()}, **ctx}),
                   True)
    backbone = jax.jit(lambda v, f, c, p: jmodel.apply(
        v, make_sparse_tensor(f, c, ctx["spatial_shape"], ctx["batch_size"]), p,
        method=lambda m, st, p: m.backbone_net(st, train=False, plans=p)))
    ref = np.asarray(backbone(variables, jst.features, jst.coords,
                              jax.tree.map(jnp.asarray, jplans_)))
    got = feats[0].numpy()
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
