"""Data parallelism of the PyTorch port (P14) on the CPU, two gloo ranks.

- The sharded collate against JAX's (``sharded_collate_fn``,
  ``point_collate_fn(num_shards=...)``), exactly; a rank's loader batch
  (``build_rank_dataloader``) against its slice, with and without shuffle.
- SyncBN: ``MaskedBatchNorm`` and ``PDBatchNorm`` under ``bn_sync`` on two
  ranks against JAX's under ``bn_sync_axis`` in ``shard_map`` on two of
  conftest's CPU devices: outputs, moved running statistics, and the grads
  of x and the parameters, within 1e-5.
- The ``Trainer``'s data-parallel step (port only): without SyncBN it is
  the mean of the per-shard single-process steps (the JAX mesh step is
  that mean, ``tests/test_multichip.py``), the replicas stay equal, the
  running statistics are the mean of the ranks' moves (not rank 0's, which
  DDP's ``broadcast_buffers`` would copy), the ranks draw other streams,
  rank 0 draws what one process draws, and the evaluator over the split
  val set gives the world of one's metrics. In a world of one the branch
  equals the single-process trainer bit for bit. ``MultiDatasetTrainer``'s
  ranks see one condition a global batch.
- ``launch`` from ``num_gpus_per_machine`` and from a torchrun environment;
  concurrent first builds in ``ops/cuda_build.py``.
- The JAX evaluators under a world of two processes (their val loader is
  not split): each scene counted and gathered ``world`` times (ROADMAP
  Queue 3).

The spawned ranks run the bodies in ``tests/torch_parallel_ranks.py``,
which imports no JAX.
"""

import copy
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from ponderv2_tpu_torch.datasets import build_dataset
from ponderv2_tpu_torch.datasets.dataloader import (MultiDatasetDataloader,
                                                    build_rank_dataloader)
from ponderv2_tpu_torch.datasets.defaults import ConcatDataset
from ponderv2_tpu_torch.datasets.utils import (point_collate_fn, shard_collate_fn,
                                               sharded_collate_fn)
from ponderv2_tpu_torch.engines.defaults import default_config_parser, default_setup
from ponderv2_tpu_torch.engines.train import TRAINERS
from ponderv2_tpu_torch.models import build_model
from ponderv2_tpu_torch.models.norm import MaskedBatchNorm, PDBatchNorm
from ponderv2_tpu_torch.parallel import mesh
from torch_threads import _torch_threads  # noqa: F401, E402  (autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYNTHETIC = os.path.join(ROOT, "configs/_test_/semseg_synthetic.py")
BUDGET = 8192  # global: 4096 a rank of 2, 2048 a rank of 4

_TRAIN = [
    dict(type="CenterShift", apply_z=True),
    dict(type="PositiveShift"),
    dict(type="GridSample", grid_size=0.05, hash_type="fnv", mode="train",
         return_grid_coord=True),
    dict(type="NormalizeColor"),
    dict(type="Collect", keys=("coord", "grid_coord", "segment"),
         feat_keys=("color", "normal")),
]


@pytest.fixture(autouse=True)
def _threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def scenes(n, points=800, seed=0):
    """``n`` voxelized synthetic scenes, drawn once (GridSample draws)."""
    ds = build_dataset(dict(type="SyntheticDataset", num_scenes=n, points_per_scene=points,
                            num_classes=8, transform=_TRAIN, seed=seed))
    state = np.random.get_state()
    np.random.seed(seed)
    try:
        return [ds[i] for i in range(n)]
    finally:
        np.random.set_state(state)


class ListDataset:
    def __init__(self, items):
        self.items = items

    def __getitem__(self, i):
        return copy.deepcopy(self.items[i])

    def __len__(self):
        return len(self.items)


def assert_same_batch(out, ref, where=""):
    assert sorted(out) == sorted(ref), (where, sorted(out), sorted(ref))
    for k in ref:
        if isinstance(ref[k], np.ndarray):
            assert out[k].dtype == ref[k].dtype and np.array_equal(out[k], ref[k]), (where, k)
        else:
            assert out[k] == ref[k], (where, k)


def assert_rel(out, ref, bound, where=""):
    """max|out - ref| <= bound * max|ref|."""
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape, (where, out.shape, ref.shape)
    scale = np.abs(ref).max()
    assert np.abs(out - ref).max() <= bound * max(scale, 1e-30), (
        f"{where}: {np.abs(out - ref).max():.3e} vs {bound} x {scale:.3e}")


# ------------------------------------------------------------------ collate

@pytest.mark.parametrize("num_shards", [2, 4])
def test_sharded_collate_matches_jax(num_shards):
    """``sharded_collate_fn`` and ``point_collate_fn(num_shards=...)`` equal
    JAX's on the same scenes, every key and dtype; rank d's loader (in
    order, and shuffled by the shared seed) yields slice d of the global
    batch."""
    from ponderv2_tpu.datasets.utils import point_collate_fn as jpoint
    from ponderv2_tpu.datasets.utils import sharded_collate_fn as jsharded

    items = scenes(8)
    ref = jsharded(copy.deepcopy(items), num_shards, point_budget=BUDGET, scene_budget=8)
    assert_same_batch(sharded_collate_fn(copy.deepcopy(items), num_shards, point_budget=BUDGET,
                                         scene_budget=8), ref, "sharded")
    assert_same_batch(point_collate_fn(copy.deepcopy(items), point_budget=BUDGET,
                                       scene_budget=8, num_shards=num_shards),
                      jpoint(copy.deepcopy(items), point_budget=BUDGET, scene_budget=8,
                             num_shards=num_shards), "point_collate_fn")
    ds = ListDataset(items)
    order = list(torch.utils.data.RandomSampler(
        ds, generator=torch.Generator().manual_seed(3)))
    shuffled = jsharded([copy.deepcopy(items[i]) for i in order], num_shards,
                        point_budget=BUDGET, scene_budget=8)
    for d in range(num_shards):
        for shuffle, glob in ((False, ref), (True, shuffled)):
            loader = build_rank_dataloader(ds, 8, num_shards, d, shuffle=shuffle,
                                           point_budget=BUDGET, seed=3)
            batch = next(iter(loader))
            assert batch["batch_size"] == 8 // num_shards and len(loader) == 1
            assert_same_batch(ranks.np_tree(batch),
                              {k: v[d] for k, v in ranks.np_tree(glob).items()},
                              f"rank {d} shuffle {shuffle}")
            assert_same_batch(ranks.np_tree(batch), ranks.np_tree(shard_collate_fn(
                [copy.deepcopy(items[i]) for i in (order if shuffle else range(8))]
                [d * 8 // num_shards:(d + 1) * 8 // num_shards], num_shards, BUDGET, 8)),
                f"shard_collate_fn {d}")


# ------------------------------------------------------------------- SyncBN

def _jax_sync_bn(module, variables, x, mask, cot, call_args=()):
    """JAX: ``module`` under ``bn_sync_axis`` in shard_map over 2 devices;
    per device the output, the moved statistics and the vjp of cot."""
    import jax
    from jax.sharding import PartitionSpec as P

    from ponderv2_tpu.models.norm import bn_sync_axis
    from ponderv2_tpu.parallel.mesh import create_mesh

    def per_device(xs, ms, cs, params):
        def f(x, params):
            with bn_sync_axis("data"):
                y, mut = module.apply({"params": params,
                                       "batch_stats": variables["batch_stats"]},
                                      x, ms[0], True, *call_args, mutable=["batch_stats"])
            return y, mut["batch_stats"]

        y, vjp, stats = jax.vjp(f, xs[0], params, has_aux=True)
        gx, gp = vjp(cs[0])
        return jax.tree.map(lambda a: a[None], (y, gx, gp, stats))

    fn = jax.jit(jax.shard_map(per_device, mesh=create_mesh(2),
                               in_specs=(P("data"), P("data"), P("data"), P()),
                               out_specs=P("data"), check_vma=False))
    return jax.tree.map(np.asarray, fn(x, mask, cot, variables["params"]))


SYNC_BN_KINDS = ("MaskedBatchNorm", "PDBatchNorm")


def sync_bn_case(kind):
    """The layer (its parameters and running statistics drawn), 2 ranks'
    rows, masks (rank 1 with fewer valid rows) and cotangents, and the
    extra forward arguments (``PDBatchNorm``: the second of two
    conditions, a context embedding)."""
    rng = np.random.RandomState(SYNC_BN_KINDS.index(kind))
    C, N = 6, 40
    x = rng.randn(2, N, C).astype(np.float32) * 2 + 0.5
    mask = rng.rand(2, N) > 0.3
    mask[1, :] = False
    mask[1, :5] = True
    cot = rng.randn(2, N, C).astype(np.float32)
    if kind == "MaskedBatchNorm":
        layer, extra = MaskedBatchNorm(C), ()
    else:
        layer = PDBatchNorm(C, conditions=("A", "B"), adaptive=True, context_channels=8)
        extra = (1, torch.from_numpy(rng.randn(8).astype(np.float32)))
    with torch.no_grad():
        for p in layer.parameters():
            p.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, p.shape).astype(np.float32)))
        for b in layer.buffers():
            b.copy_(torch.from_numpy(rng.uniform(0.2, 2.0, b.shape).astype(np.float32)))
    return dict(layer=layer, x=x, mask=mask, cot=cot, extra=extra)


@pytest.fixture(scope="module")
def sync_bn_ranks(tmp_path_factory):
    """Both layers under ``bn_sync`` on one pair of gloo ranks."""
    cases = [sync_bn_case(kind) for kind in SYNC_BN_KINDS]
    return ranks.spawn(ranks.syncbn_rank, dict(cases=cases, sync=True),
                       tmp_path_factory.mktemp("sync_bn"))


@pytest.mark.parametrize("kind", SYNC_BN_KINDS)
def test_sync_bn_matches_jax_on_two_ranks(sync_bn_ranks, kind):
    """Two gloo ranks under ``bn_sync`` against JAX under ``bn_sync_axis``:
    each rank's output, moved running statistics and grads of x and the
    parameters (its loss ``sum(y * cot)``; the statistics' cotangents are
    summed over the ranks) within 1e-5 of max|ref|; with ``PDBatchNorm``
    (adaptive, the second of two conditions) only that condition's stats
    move."""
    import jax.numpy as jnp

    from ponderv2_tpu.models import norm as jnorm
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from convert_torch_checkpoint import bn_params, pdnorm_params

    case = sync_bn_case(kind)
    layer = case["layer"]
    sd = {f"n.{k}": v.numpy() for k, v in layer.state_dict().items()}
    if kind == "MaskedBatchNorm":
        jmodule, jextra = jnorm.MaskedBatchNorm(6), ()
        params, stats = bn_params(sd, "n")
    else:
        jmodule = jnorm.PDBatchNorm(6, conditions=("A", "B"), adaptive=True,
                                    context_channels=8)
        jextra = (1, jnp.asarray(case["extra"][1].numpy()))
        params, stats = pdnorm_params(sd, "n", ("A", "B"), True)
    y, gx, gp, jstats = _jax_sync_bn(jmodule, {"params": params, "batch_stats": stats},
                                     case["x"], case["mask"], case["cot"], jextra)
    prefix = "" if kind == "MaskedBatchNorm" else "bns.1."
    jbn = (lambda t: t) if kind == "MaskedBatchNorm" else (lambda t: t["bn_B"])
    for r, rank_cases in enumerate(sync_bn_ranks):
        g = rank_cases[SYNC_BN_KINDS.index(kind)]
        assert_rel(g["y"], y[r], 1e-5, f"y rank {r}")
        assert_rel(g["x_grad"], gx[r], 1e-5, f"dx rank {r}")
        assert_rel(g["grads"][prefix + "weight"], jbn(gp)["scale"][r], 1e-5, "dscale")
        assert_rel(g["grads"][prefix + "bias"], jbn(gp)["bias"][r], 1e-5, "dbias")
        assert_rel(g["buffers"][prefix + "running_mean"], jbn(jstats)["mean"][r], 1e-5, "mean")
        assert_rel(g["buffers"][prefix + "running_var"], jbn(jstats)["var"][r], 1e-5, "var")
        if kind == "PDBatchNorm":
            assert_rel(g["grads"]["modulation.1.weight"],
                       gp["modulation"]["kernel"][r].T, 1e-5, "dmodulation")
            for name in ("running_mean", "running_var"):  # the other condition's
                assert torch.equal(g["buffers"][f"bns.0.{name}"], getattr(layer.bns[0], name))


# ------------------------------------------------------ the data-parallel step

def synthetic_cfg(save_path, **options):
    cfg = default_config_parser(SYNTHETIC, {
        "save_path": str(save_path), "device": "cpu", "seed": 0, "hooks": [],
        "data.val.type": "PinnedSyntheticDataset", "data.val.num_scenes": 4,
        "batch_size_val": 1, **options})
    return cfg


def seeded_state(cfg):
    """Seeded weights with the BN parameters and running stats drawn too."""
    model = build_model(dict(cfg.model))
    model.reset_parameters(torch.Generator().manual_seed(0))
    rng = np.random.RandomState(1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.ndim == 1 and "final" not in name:
                p.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, p.shape)))
        for name, b in model.named_buffers():
            b.copy_(torch.from_numpy(rng.uniform(0.2, 1.5, b.shape)))
    return {k: v.clone() for k, v in model.state_dict().items()}


@pytest.fixture(scope="module")
def dp_run(tmp_path_factory):
    """One data-parallel step of the synthetic config's segmentor (global
    batch 2, one scene a rank, no SyncBN) on two ranks, then the evaluator
    on each rank's half of 4 val scenes; and the per-shard steps of one
    process from the same state."""
    tmp = tmp_path_factory.mktemp("dp")
    cfg = synthetic_cfg(tmp / "run", data_parallel=True, evaluate=True)
    state = seeded_state(cfg)
    items = scenes(2, points=3000)
    shards = [shard_collate_fn([copy.deepcopy(s)], 2, BUDGET, 2) for s in items]
    got = ranks.spawn(ranks.dp_step_rank, dict(cfg=cfg, state=state, batches=[shards],
                                               evaluate=True), tmp)
    ctx = dict(spatial_shape=tuple(cfg.sparse_shape), batch_size=1)
    per_shard = []
    for batch in shards:
        model = build_model(dict(cfg.model))
        model.load_state_dict(state)
        model.train()
        out = model({**{k: torch.as_tensor(v) for k, v in ranks.np_tree(batch).items()},
                     **ctx})
        out["loss"].backward()
        per_shard.append(dict(
            loss=float(out["loss"].detach()), grads={n: p.grad for n, p in model.named_parameters()},
            stats={n: b for n, b in model.named_buffers() if "running" in n}))
    return dict(cfg=cfg, state=state, ranks=got, per_shard=per_shard)


def test_dp_step_is_the_mean_of_the_per_shard_steps(dp_run):
    """Without SyncBN the world-2 step averages the per-shard grads, loss
    and BN moves of one process (within 1e-5 of max|ref|); both ranks step
    with the same grads and end with equal bits."""
    r0, r1 = dp_run["ranks"]
    per = dp_run["per_shard"]
    assert r0["ddp"] == "DistributedDataParallel" and r0["world"] == 2
    assert r0["static_ctx"]["batch_size"] == 1 and r0["val_ctx"]["batch_size"] == 1
    for name, g in r0["grads"][0].items():
        assert torch.equal(g, r1["grads"][0][name]), name
        assert_rel(g, (per[0]["grads"][name] + per[1]["grads"][name]) / 2, 1e-5, name)
    for r, rec in enumerate((r0, r1)):
        assert rec["metrics"][0]["loss"] == pytest.approx(
            (per[0]["loss"] + per[1]["loss"]) / 2, rel=1e-6)
        assert rec["metrics"][0]["contract_ok"] == 1.0
        for name, b in rec["local_stats"][0].items():  # the rank's own move
            assert_rel(b, per[r]["stats"][name], 1e-5, name)
    for name, v in r0["state"].items():
        assert torch.equal(v, r1["state"][name]), name


def test_dp_averages_the_bn_stats_not_rank0s(dp_run):
    """The running statistics after the step are the mean of the two
    ranks' moves, bit for bit; rank 0's own move, which DDP's
    ``broadcast_buffers`` would copy to every rank, differs from it."""
    r0, r1 = dp_run["ranks"]
    assert r0["bn_buffers"] == len(r0["local_stats"][0]) > 0
    differ = 0
    for name, mine in r0["local_stats"][0].items():
        mean = (mine + r1["local_stats"][0][name]) / 2
        assert torch.equal(r0["state"][name], mean), name
        differ += not torch.equal(mine, mean)
    assert differ == len(r0["local_stats"][0])


def test_dp_ranks_draw_other_streams(dp_run):
    """Each rank's step generator folds in its rank; rank 0 draws what a
    world of one draws. Each rank keys its scene cache on a run key of its
    own, so no rank unlinks what another still reads."""
    r0, r1 = dp_run["ranks"]
    assert r0["cache_run"] != r1["cache_run"]
    assert not torch.equal(r0["draws"], r1["draws"])
    one = torch.rand(4, generator=torch.Generator().manual_seed(0 << 32 | 0))
    assert torch.equal(r0["draws"], one)


def test_dp_evaluator_matches_world_one(dp_run, tmp_path):
    """Each rank evaluates every other val scene; the reduced metrics equal
    one process's over all four within 1e-6."""
    r0, r1 = dp_run["ranks"]
    assert (r0["val_scenes"], r1["val_scenes"]) == (2, 2)
    from ponderv2_tpu_torch.engines.hooks.evaluator import SemSegEvaluator
    from ponderv2_tpu_torch.utils.events import EventStorage

    cfg = synthetic_cfg(tmp_path, evaluate=True)
    trainer = TRAINERS.build(dict(type="Trainer", cfg=cfg))
    trainer.model.load_state_dict(r0["state"])
    evaluator = SemSegEvaluator()
    evaluator.trainer = trainer
    with EventStorage() as trainer.storage:
        evaluator.eval()
        ref = {k: v for k, (v, _) in trainer.storage.latest().items()}
    assert len(trainer.val_loader.dataset) == 4
    for rec in (r0, r1):
        assert sorted(rec["val"]) == sorted(ref)
        for k, v in ref.items():
            assert rec["val"][k] == pytest.approx(v, abs=1e-6), k


def test_dp_branch_in_a_world_of_one_is_the_single_process_trainer(tmp_path):
    """``data_parallel=True`` in a gloo world of one (DDP, the reductions)
    trains 2 steps to the same bits as the single-process trainer: every
    step's loss, the parameters and the running statistics. A world of
    another size than asked for is refused (``create_mesh``)."""
    import torch.distributed as dist

    from ponderv2_tpu_torch.engines.launch import _free_port

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{_free_port()}",
                            world_size=1, rank=0)
    try:
        assert mesh.create_mesh() == mesh.create_mesh(1) == 1
        with pytest.raises(RuntimeError, match="ranks were asked for"):
            mesh.create_mesh(2)
        runs = []
        for dp in (False, True):
            cfg = default_setup(synthetic_cfg(tmp_path / str(dp), data_parallel=dp,
                                              evaluate=False, epoch=1, eval_epoch=1))
            trainer = TRAINERS.build(dict(type="Trainer", cfg=cfg))
            assert trainer.data_parallel == dp and trainer.num_devices == 1
            losses = []
            trainer.register_hooks([])
            step = trainer.run_step

            def run_step(step=step, losses=losses, trainer=trainer):
                step()
                losses.append(trainer.sync_metrics())

            trainer.run_step = run_step
            trainer.train()
            runs.append((losses, trainer.model.state_dict()))
    finally:
        dist.destroy_process_group()
    (l0, s0), (l1, s1) = runs
    assert len(l0) == 2 and l0 == l1
    for name, v in s0.items():
        assert torch.equal(v, s1[name]), name


def test_multidataset_ranks_see_one_condition_a_batch(tmp_path):
    """Two ranks' ``MultiDatasetTrainer`` loaders: every global batch comes
    from one dataset, so both ranks' parts carry its ``condition``, in the
    round-robin order of one process; each rank's part is its group of
    the global batch a one-process loader with the same shuffle cuts."""
    def dataset(name, n, seed):
        return dict(type="PinnedSyntheticDataset", num_scenes=n, points_per_scene=600,
                    num_classes=8, seed=seed,
                    transform=_TRAIN[:-1] + [dict(type="Add", keys_dict={"condition": name}),
                                             dict(_TRAIN[-1], keys=("coord", "grid_coord",
                                                                    "segment", "condition"))])

    data_train = dict(type="ConcatDataset", datasets=[dataset("A", 8, 0), dataset("B", 4, 1)],
                      loop=1)
    cfg = synthetic_cfg(tmp_path, **{"train_type": "MultiDatasetTrainer", "evaluate": False,
                                     "data.train": data_train, "batch_size": 4,
                                     "data_parallel": True})
    got = ranks.spawn(ranks.rank_loader_rank, dict(cfg=cfg, batches=4), tmp_path)
    conditions = [[b["condition"] for b in g["batches"]] for g in got]
    assert conditions[0] == conditions[1]
    assert [c[0] for c in conditions[0]] == ["A", "B", "A", "B"]
    assert all(len(set(c)) == 1 and len(c) == 2 for c in conditions[0])
    assert got[0]["length"] == got[1]["length"] == 4
    # the same global batches in one process, cut into the two groups
    for d in range(2):
        loader = MultiDatasetDataloader(ConcatDataset(list(data_train["datasets"])), 4,
                                        point_budget=BUDGET, seed=0, num_shards=2, shard=d)
        for i, batch in enumerate(loader):
            if i == 4:
                break
            assert_same_batch(ranks.np_tree(batch), ranks.np_tree(got[d]["batches"][i]),
                              f"rank {d} batch {i}")


# ------------------------------------------------------------------- launch

def test_launch_spawns_ranks_from_num_gpus_per_machine(dp_run):
    """``launch(num_gpus_per_machine=2)`` on the CPU (``dp_run``'s ranks):
    ranks 0 and 1 of a world of 2 over gloo, local ranks 0 and 1, one
    shared seed."""
    got = dp_run["ranks"]
    assert [(g["rank"], g["world"], g["local_rank"], g["backend"], g["device"])
            for g in got] == [(0, 2, 0, "gloo", "cpu"), (1, 2, 1, "gloo", "cpu")]
    assert got[0]["seed"] == got[1]["seed"]


def test_launch_joins_a_torchrun_environment(tmp_path):
    """Two processes started apart with torchrun's variables (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) each
    join the group through ``launch`` as the rank they were given."""
    from ponderv2_tpu_torch.engines.launch import _free_port

    code = textwrap.dedent(f"""
        import sys
        sys.path[:0] = [{ROOT!r}, {os.path.join(ROOT, 'tests')!r}]
        import torch_parallel_ranks as ranks
        from ponderv2_tpu_torch.engines.launch import launch
        launch(ranks.record_rank, cfg=(dict(out={str(tmp_path)!r}, device="cpu"),))
    """)
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, "-c", code], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=dict(os.environ, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE="2",
                            MASTER_ADDR="127.0.0.1", MASTER_PORT=port, OMP_NUM_THREADS="1"))
        for r in range(2)]
    for p in procs:
        out = p.communicate(timeout=300)[0]
        assert p.returncode == 0, out[-3000:]
    got = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(2)]
    assert [(g["rank"], g["world"], g["local_rank"]) for g in got] == [(0, 2, 0), (1, 2, 1)]


def test_concurrent_first_builds_leave_one_whole_library(tmp_path):
    """Two processes building the same source at once (as two ranks on one
    card do on a fresh checkout): each compiles into a file of its own and
    renames it into place, so both load a whole library and one build is
    left, with no temporary file. A stand-in for nvcc (g++ on a C source,
    after a pause) takes its place here."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "answer.cu").write_text("int answer(void) { return 42; }\n")
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(textwrap.dedent(f"""\
        #!{sys.executable}
        import subprocess, sys, time
        args = sys.argv[1:]
        time.sleep(1.0)
        sys.exit(subprocess.call(["g++", "-x", "c", "-shared", "-fPIC", "-o",
                                  args[args.index("-o") + 1], args[-1]]))
    """))
    nvcc.chmod(0o755)
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {ROOT!r})
        from ponderv2_tpu_torch.ops import cuda_build as cb
        cb.CSRC, cb.BUILD_DIR = {str(csrc)!r}, {str(csrc / "_build")!r}
        cb._nvcc = lambda: {str(nvcc)!r}
        assert cb.load_library("answer").answer() == 42
    """)
    procs = [subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for _ in range(2)]
    for p in procs:
        out = p.communicate(timeout=300)[0]
        assert p.returncode == 0, out[-3000:]
    (lib,) = (csrc / "_build").iterdir()
    assert lib.name.startswith("libanswer-") and lib.suffix == ".so"


# -------------------------------------------- the JAX evaluators in a world of 2

def test_jax_evaluators_count_each_scene_world_times_port_only(tmp_path):
    """JAX's val loader is not split over processes, so in a world of two
    each process evaluates every scene: ``SemSegEvaluator``'s summed
    counters come out twice the scenes' (its ratios, mIoU / mAcc / allAcc,
    stay the same) and ``InsSegEvaluator`` scores every scene twice (the
    same AP on these scenes: every scene's matches come twice). Shown
    with JAX's ``comm`` standing in for two processes that evaluated the
    same batches. The port splits the val set (``Trainer.build_val_loader``)
    and reduces once per scene (``test_dp_evaluator_matches_world_one``)."""
    from ponderv2_tpu.engines.hooks import evaluator as jev
    from ponderv2_tpu.utils import comm as jcomm
    from ponderv2_tpu.utils.events import EventStorage as JStorage

    rng = np.random.RandomState(0)
    n, num_classes = 50, 4
    batches = [dict(segment=rng.randint(0, num_classes, n), batch=np.zeros(n, np.int32),
                    feat=np.zeros((n, 3), np.float32)) for _ in range(3)]
    logits = [rng.randn(n, num_classes).astype(np.float32) for _ in range(3)]

    class Cfg(dict):
        __getattr__ = dict.__getitem__

    class FakeTrainer:
        cfg = Cfg(data=Cfg(num_classes=num_classes, ignore_index=-1,
                           names=[f"c{i}" for i in range(num_classes)]), evaluate=True)
        val_loader = batches
        state = None
        comm_info = {}
        logger = __import__("logging").getLogger("jax-evaluator")

        def eval_step(self, state, arrays):
            return {"seg_logits": logits[self.calls.pop(0)]}

    seen = []

    def reduce_dict(d, average=True):
        seen.append(dict(d))
        return {k: 2 * v for k, v in d.items()}  # two processes, the same scenes

    results = []
    for world in (1, 2):
        trainer = FakeTrainer()
        trainer.calls = [0, 1, 2]
        evaluator = jev.SemSegEvaluator()
        evaluator.trainer = trainer
        with JStorage() as trainer.storage:
            if world == 2:
                orig = jcomm.reduce_dict
                jev.comm.reduce_dict = reduce_dict
                try:
                    evaluator.eval()
                finally:
                    jev.comm.reduce_dict = orig
            else:
                evaluator.eval()
            results.append({k: v for k, (v, _) in trainer.storage.latest().items()})
    assert seen and sum(seen[0][f"t{c}"] for c in range(num_classes)) == 3 * n
    for k, v in results[0].items():
        assert results[1][k] == pytest.approx(v, rel=1e-12), k

    # InsSegEvaluator's all_gather hands the scorer each scene once per process
    # three instances a scene, each predicted with some points flipped, and
    # a false positive, all of class 2, at random scores
    instance = np.repeat(np.arange(-1, 4), n // 5)
    gts = [dict(instance=instance, segment=np.where(instance >= 0, 2, 0)) for _ in range(3)]
    preds = [[dict(mask=(instance == i) ^ (rng.rand(n) < 0.05), cls=2,
                   score=float(rng.rand())) for i in (0, 1, 2, -1)] for _ in range(3)]
    once = jev.evaluate_instance_ap(preds, gts, num_classes, (-1, 0, 1), min_region_size=1)
    twice = jev.evaluate_instance_ap(preds * 2, gts * 2, num_classes, (-1, 0, 1),
                                     min_region_size=1)
    print(f"InsSeg over the scenes once / twice: mAP {once['mAP']:.6f} / {twice['mAP']:.6f}, "
          f"mAP50 {once['mAP50']:.6f} / {twice['mAP50']:.6f}, mAP25 {once['mAP25']:.6f} / "
          f"{twice['mAP25']:.6f}")
    assert 0 < once["mAP"] < 1
    for k in ("mAP", "mAP50", "mAP25"):  # scenes scored twice: the same AP here
        assert twice[k] == pytest.approx(once[k], rel=1e-12), k
