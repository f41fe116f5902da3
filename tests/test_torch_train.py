"""PyTorch port vs JAX package: the training slice on the CPU.

Each comparison feeds the same numpy inputs, made from a seed, to the JAX
function and to the port: the band conv's dx/dW on both backward routes
(the JAX Pallas kernels in interpret mode, as the JAX package's own tests
run them; the port's plain versions of K1-K3), the mirrored-gather subm
conv backward, the losses, the schedules, and two SGD-Nesterov steps of a
small ``DefaultSegmentor`` against ``engines.train.make_train_step``.
Tolerances: 1e-5 relative for a single op (f32, sums in another order);
grads of the whole segmentor 1e-4 of each tensor's max|ref| (17 convs with
BN, each summed in another order than XLA's); parameters and BN running
stats after the steps 1e-5 of each tensor's max|ref|. The two steps run
(``run_two_steps``) in ``test_torch_train_dense.py`` (every level dense)
and ``test_torch_train_scannet.py`` (ScanNet's sparse_shape).
"""

import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from ponderv2_tpu.engines.train import TrainState, make_train_step
from ponderv2_tpu.models import build_model as jbuild
from ponderv2_tpu.models.losses import lovasz as _jlovasz  # noqa: F401
from ponderv2_tpu.models.losses import misc as _jmisc  # noqa: F401
from ponderv2_tpu.models.losses.builder import LOSSES as JLOSSES
from ponderv2_tpu.models.losses.builder import build_criteria as jcriteria
from ponderv2_tpu.ops import band_conv as jbc
from ponderv2_tpu.ops import spconv as jsp
from ponderv2_tpu.utils.optimizer import build_optimizer as jbuild_optimizer
from ponderv2_tpu.utils.scheduler import build_scheduler as jbuild_scheduler
from ponderv2_tpu_torch.datasets import build_dataset, collate_fn
from ponderv2_tpu_torch.models import build_model as tbuild
from ponderv2_tpu_torch.models.losses import LOSSES as TLOSSES
from ponderv2_tpu_torch.models.losses import build_criteria as tcriteria
from ponderv2_tpu_torch.models.sparse_unet.layers import SubMConv
from ponderv2_tpu_torch.ops import band_conv as tbc
from ponderv2_tpu_torch.ops import spconv as tsp
from ponderv2_tpu_torch.utils.convert import state_dict_from_jax_spunet
from ponderv2_tpu_torch.utils.optimizer import build_optimizer, set_lr
from ponderv2_tpu_torch.utils.scheduler import build_scheduler
from jax_compile import background_compile, jit  # noqa: E402
from torch_threads import _torch_threads  # noqa: F401, E402  (autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def make_scene(rng, n, shape, cin, pad_rows=6):
    """Unique voxel coords of 2 scenes in ascending key order, -1 padding,
    with zeroed padding features."""
    coords = np.unique(np.stack([
        rng.randint(0, 2, n), rng.randint(0, shape[0], n),
        rng.randint(0, shape[1], n), rng.randint(0, shape[2], n)], 1),
        axis=0).astype(np.int32)
    feats = rng.randn(len(coords), cin).astype(np.float32)
    coords = np.concatenate([coords, np.full((pad_rows, 4), -1, np.int32)])
    feats = np.concatenate([feats, np.zeros((pad_rows, cin), np.float32)])
    return coords, feats


# ------------------------------------------------------------- band conv


class _Spy:
    """Counts the calls of one port band core and runs it."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *args):
        self.calls += 1
        return self.fn(*args)


BAND_GRAD_CASES = {
    # block 8 / window 32: every entry in its window
    "b8w32": dict(block=8, window=32),
    # block 32 / window 8: spans overflow -> overflow residual and _overflow_dw
    "b32w8": dict(block=32, window=8),
    # budget exceeded: ok False, zero output and zero grads
    "pair0": dict(block=32, window=8, pair_budget=0),
}


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "split"])
@pytest.mark.parametrize("case", list(BAND_GRAD_CASES))
def test_band_conv_grads_match_jax(rng, monkeypatch, case, fused):
    """dx and dW of ``band_subm_conv`` for one cotangent, against the VJP of
    the JAX custom_vjp, on the fused (K2) and split (K1 + K3) routes."""
    kw = BAND_GRAD_CASES[case]
    shape, cin, cout = (12, 12, 12), 12, 9
    coords, feats = make_scene(rng, 200, shape, cin)
    rb = np.asarray(jsp.build_subm_rulebook(jnp.asarray(coords), shape, 2, 3))
    w = (rng.randn(27, cin, cout) * 0.2).astype(np.float32)
    cot = rng.randn(len(coords), cout).astype(np.float32)
    mask = coords[:, 0] >= 0
    cfg = (3, kw["block"], kw["window"])

    monkeypatch.setenv("PONDER_BAND_FUSED_BWD", "1" if fused else "0")
    jplan = jbc.build_band_plan(jnp.asarray(rb), 3, kw["block"], kw["window"],
                                kw.get("pair_budget"))
    token = jnp.zeros((0,), jnp.float32)

    def jvjp(f, wt):  # a fresh function: the env var is read while tracing
        out, pull = jax.vjp(
            lambda a, b: jbc.band_subm_conv(cfg, a, jplan, b, jnp.asarray(mask),
                                            token), f, wt)
        return (out,) + pull(jnp.asarray(cot))

    jout, jdx, jdw = (np.asarray(a) for a in jit(jvjp)(
        jnp.asarray(feats), jnp.asarray(w)))

    spies = {name: _Spy(getattr(tbc, name))
             for name in ("band_dxdw_core", "band_dw_core")}
    for name, spy in spies.items():
        monkeypatch.setattr(tbc, name, spy)
    monkeypatch.setattr(tbc, "fused_bwd_fits", lambda *a, **k: fused)
    plan = tbc.build_band_plan(torch.from_numpy(rb), 3, **kw)
    f = torch.from_numpy(feats).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    out = tbc.band_subm_conv(cfg, f, plan, wt, torch.from_numpy(mask))
    out.backward(torch.from_numpy(cot))
    assert (spies["band_dxdw_core"].calls, spies["band_dw_core"].calls) == (
        (1, 0) if fused else (0, 1))
    if case == "pair0":
        assert not bool(plan.ok)
        for a in (out, f.grad, wt.grad, jdx, jdw):
            assert np.abs(np.asarray(a.detach() if torch.is_tensor(a) else a)).sum() == 0.0
        return
    if case == "b32w8":
        assert sum(plan.ov_counts) > 0
    assert_rel(out.detach().numpy(), jout, 1e-5, "out")
    assert_rel(f.grad.numpy(), jdx, 1e-5, "dx")
    assert_rel(wt.grad.numpy(), jdw, 1e-5, "dW")


def test_inline_band_plan_doubles_its_budgets(rng, monkeypatch):
    """An inline plan whose budgets overflow is rebuilt with both budgets
    doubled until it is ok (block 32 / window 8 stands in for a dense
    12-scene batch at the default block and window)."""
    coords, _ = make_scene(rng, 200, (12, 12, 12), 1)
    rb = tsp.build_subm_rulebook(torch.from_numpy(coords), (12, 12, 12), 2, 3)
    calls = []
    build = tbc.build_band_plan

    def small_window(rulebook, kz, pair_budget, entry_budget):
        calls.append((pair_budget, entry_budget))
        return build(rulebook, kz, block=32, window=8, pair_budget=pair_budget,
                     entry_budget=entry_budget)

    monkeypatch.setattr(tbc, "build_band_plan", small_window)
    monkeypatch.setattr(tbc, "PAIR_BUDGET", 8)
    monkeypatch.setattr(tbc, "ENTRY_BUDGET", 64)
    plan = tbc.build_band_plan_auto(rb, 3)
    assert bool(plan.ok) and sum(plan.ov_counts) > 64
    assert len(calls) > 1 and not bool(small_window(rb, 3, 8, 64).ok)
    assert calls[:len(calls) - 1] == [(8 << k, 64 << k) for k in range(len(calls) - 1)]


@pytest.mark.parametrize("kernel", [3, 5])
def test_subm_conv_symmetric_grads_match_jax(rng, kernel):
    shape = (10, 10, 10)
    coords, feats = make_scene(rng, 150, shape, 6)
    rb = np.asarray(jsp.build_subm_rulebook(jnp.asarray(coords), shape, 2, kernel))
    w = (rng.randn(kernel ** 3, 6, 5) * 0.2).astype(np.float32)
    cot = rng.randn(len(coords), 5).astype(np.float32)
    mask = coords[:, 0] >= 0
    token = jnp.zeros((0,), jnp.float32)

    @jit
    def jvjp(f, wt):
        out, pull = jax.vjp(lambda a, b: jsp.subm_conv_symmetric(
            a, jnp.asarray(rb), b, jnp.asarray(mask), token), f, wt)
        return (out,) + pull(jnp.asarray(cot))

    jout, jdx, jdw = (np.asarray(a) for a in jvjp(jnp.asarray(feats),
                                                   jnp.asarray(w)))
    f = torch.from_numpy(feats).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    out = tsp.subm_conv_symmetric(f, torch.from_numpy(rb), wt,
                                  torch.from_numpy(mask))
    out.backward(torch.from_numpy(cot))
    assert_rel(out.detach().numpy(), jout, 1e-5, "out")
    assert_rel(f.grad.numpy(), jdx, 1e-5, "dx")
    assert_rel(wt.grad.numpy(), jdw, 1e-5, "dW")


# ------------------------------------------------------------------ losses

LOSS_CFGS = {
    "ce": dict(type="CrossEntropyLoss", loss_weight=1.0, ignore_index=-1),
    "ce_weighted_smooth": dict(type="CrossEntropyLoss", weight=[0.5 + 0.1 * i for i in range(6)],
                               label_smoothing=0.1, loss_weight=0.7),
    "smooth_ce": dict(type="SmoothCELoss", smoothing_ratio=0.2),
    "focal": dict(type="FocalLoss", gamma=2.0, alpha=0.25),
    "dice": dict(type="DiceLoss", smooth=1.0, exponent=2.0),
    "lovasz": dict(type="LovaszLoss", mode="multiclass", loss_weight=1.0, ignore_index=-1),
    "lovasz_seen": dict(type="LovaszLoss", mode="multiclass", class_seen=[0, 2, 5]),
    "lovasz_binary": dict(type="LovaszLoss", mode="binary"),
    "binary_focal": dict(type="BinaryFocalLoss", gamma=2.0, alpha=0.25),
}


def _loss_inputs(rng, binary=False):
    n, c = 400, 6
    logits = (rng.randn(n, 1 if binary else c) * 2).astype(np.float32)
    target = rng.randint(0, 2 if binary else c, n).astype(np.int64)
    target[rng.rand(n) < 0.1] = -1  # ignored rows
    mask = rng.rand(n) > 0.1  # padding rows
    logits[~mask] = 0.0  # padded logits tie in the sort
    return logits, target, mask


@pytest.mark.parametrize("name", list(LOSS_CFGS))
def test_loss_values_and_grads_match_jax(rng, name):
    binary = name in ("lovasz_binary", "binary_focal")
    logits, target, mask = _loss_inputs(rng, binary)
    if name == "binary_focal":  # float targets, logits (N,)
        logits, target = logits[:, 0], (target > 0).astype(np.float32)
    jloss_fn = JLOSSES.build(dict(LOSS_CFGS[name]))
    jval, jgrad = jax.jit(jax.value_and_grad(
        lambda p: jloss_fn(p, jnp.asarray(target), jnp.asarray(mask))))(
            jnp.asarray(logits))
    p = torch.from_numpy(logits).requires_grad_()
    tval = TLOSSES.build(dict(LOSS_CFGS[name]))(p, torch.from_numpy(target),
                                                torch.from_numpy(mask))
    tval.backward()
    assert abs(float(tval.detach()) - float(jval)) <= 1e-5 * max(abs(float(jval)), 1e-3)
    assert_rel(p.grad.numpy(), np.asarray(jgrad), 1e-5, name)


def test_criteria_ce_plus_lovasz_match_jax(rng):
    """The ScanNet config's criteria: CE + Lovász, summed."""
    cfg = [LOSS_CFGS["ce"], LOSS_CFGS["lovasz"]]
    logits, target, mask = _loss_inputs(rng)
    jc = jcriteria(cfg)
    jval, jgrad = jax.jit(jax.value_and_grad(
        lambda p: jc(p, jnp.asarray(target), jnp.asarray(mask))))(jnp.asarray(logits))
    p = torch.from_numpy(logits).requires_grad_()
    tval = tcriteria(cfg)(p, torch.from_numpy(target), torch.from_numpy(mask))
    tval.backward()
    assert abs(float(tval.detach()) - float(jval)) <= 1e-5 * abs(float(jval))
    assert_rel(p.grad.numpy(), np.asarray(jgrad), 1e-5, "criteria")


# --------------------------------------------------------------- schedules

SCHEDULES = [
    dict(type="OneCycleLR", max_lr=0.05, pct_start=0.05, anneal_strategy="cos",
         div_factor=10.0, final_div_factor=10000.0),
    dict(type="OneCycleLR", max_lr=[0.002, 0.0002], pct_start=0.3,
         anneal_strategy="linear"),
    dict(type="MultiStepLR", base_lr=0.1, milestones=[0.6, 0.8], gamma=0.1),
    dict(type="MultiStepWithWarmupLR", base_lr=0.1, milestones=[0.6, 0.8],
         warmup_rate=0.05, warmup_scale=1e-6),
    dict(type="PolyLR", base_lr=0.1, power=0.9),
    dict(type="ExpLR", base_lr=0.1, gamma=0.9),
    dict(type="CosineAnnealingLR", base_lr=0.1, eta_min=1e-4),
]


@pytest.mark.parametrize("cfg", SCHEDULES, ids=lambda c: c["type"])
def test_schedule_matches_jax_over_a_run(cfg):
    """Every step of a 500-step run, and 3 past its end. The JAX schedules
    run in f32: near the end of a cosine anneal its ``hi + (lo - hi) * ...``
    cancels to ~1e-9 absolute, hence the absolute bound of 1e-7 of the peak
    lr beside the 1e-5 relative one."""
    total = 500
    jsched = jbuild_scheduler(dict(cfg), total)
    tsched = build_scheduler(dict(cfg), total)
    steps = np.arange(total + 3)
    ref = np.asarray(jax.jit(jax.vmap(jsched))(jnp.asarray(steps)))
    out = np.asarray([tsched(int(k)) for k in steps])
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-7 * ref.max())


# ------------------------------------------------------- segmentor steps

sys.path.insert(0, os.path.join(ROOT, "tools"))
from convert_torch_checkpoint import convert_spunet_v1m1  # noqa: E402

BACKBONE = dict(type="SpUNet-v1m1", in_channels=9, num_classes=20,
                base_channels=16, channels=(16, 32, 64, 96, 96, 64, 48, 72),
                layers=(1,) * 8)
SEGMENTOR = dict(type="DefaultSegmentor", backbone=BACKBONE, criteria=[
    dict(type="CrossEntropyLoss", loss_weight=1.0, ignore_index=-1),
    dict(type="LovaszLoss", mode="multiclass", loss_weight=1.0, ignore_index=-1)])
# The JAX backbone runs without nn.remat: with it, the band-conv grads of
# the jitted step drift from autodiff by up to ~2e-2 of max|grad| on the CPU
# (ROADMAP Queue 3); without it they agree with the port to ~2e-6.
JSEGMENTOR = dict(SEGMENTOR, backbone=dict(BACKBONE, remat=False))
OPTIMIZER = dict(type="SGD", lr=0.05, momentum=0.9, weight_decay=1e-4, nesterov=True)
SCHEDULER = dict(type="OneCycleLR", max_lr=0.05, pct_start=0.05,
                 anneal_strategy="cos", div_factor=10.0, final_div_factor=10000.0)


def train_batch():
    """Two ~3k-point synthetic scenes with labels, voxelized at 5 cm and
    collated to 8192 rows (the ScanNet feature layout: color, normal, coord)."""
    ds = build_dataset(dict(
        type="SyntheticDataset", num_scenes=2, points_per_scene=3000,
        num_classes=20, transform=[
            dict(type="CenterShift", apply_z=True),
            dict(type="GridSample", grid_size=0.05, hash_type="fnv",
                 mode="train", return_grid_coord=True),
            dict(type="CenterShift", apply_z=False),
            dict(type="NormalizeColor"),
            dict(type="Collect", keys=("coord", "grid_coord", "segment"),
                 feat_keys=("color", "normal", "coord"))]))
    state = np.random.get_state()
    np.random.seed(0)  # GridSample's train-mode draw
    try:
        batch = collate_fn([ds[0], ds[1]], point_budget=8192, scene_budget=2)
    finally:
        np.random.set_state(state)
    return {k: batch[k] for k in ("feat", "grid_coord", "batch", "segment")}


def seeded_weights():
    """Port weights from a seed (BN scale/bias and running stats too), and
    the JAX variables made from them by the JAX package's converter."""
    model = tbuild(dict(SEGMENTOR))
    model.reset_parameters(torch.Generator().manual_seed(0))
    rng = np.random.RandomState(0)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.ndim == 1 and "final" not in name:  # BN scale and bias
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


def run_two_steps(spatial_shape):
    """Loss, grads, and params + BN running stats after two SGD-Nesterov
    steps (OneCycle lr) of a small DefaultSegmentor, against the JAX
    package's jitted ``make_train_step``, on one batch of 2 scenes at
    ``spatial_shape``. The JAX step compiles while the port takes its
    steps. Asserts, and returns the port's conv routes."""
    arrays = train_batch()
    ctx = dict(spatial_shape=spatial_shape, batch_size=2)
    total_steps = 10
    variables = seeded_weights()
    jarr = {k: jnp.asarray(v) for k, v in arrays.items()}

    # --- JAX: the jitted train step, compiled in the background. An
    # identity transform in front of the optimizer keeps each step's
    # incoming grads in opt_state.
    jmodel = jbuild(dict(JSEGMENTOR))
    capture = optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p), lambda g, s, p=None: (g, g))
    schedule = jbuild_scheduler(dict(SCHEDULER), total_steps)
    tx = optax.chain(capture, jbuild_optimizer(dict(OPTIMIZER), variables["params"],
                                               schedule))
    init = to_port_names(variables["params"], variables["batch_stats"])
    state = TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                       batch_stats=variables["batch_stats"],
                       opt_state=tx.init(variables["params"]), constants={})
    # at XLA's default optimization level (tests/jax_compile.py says why)
    step = background_compile(make_train_step(jmodel, tx, schedule, ctx), state, jarr,
                              compiler_options=None)

    # --- port: the same weights, the Trainer's step
    model = tbuild(dict(SEGMENTOR)).train()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in init.items()})
    opt = build_optimizer(dict(OPTIMIZER), model)
    tsched = build_scheduler(dict(SCHEDULER), total_steps)
    inputs = {**{k: torch.from_numpy(v) for k, v in arrays.items()}, **ctx}
    outs = []
    for k in range(2):
        set_lr(opt, tsched(k))
        out = model(inputs)
        out["loss"].backward()
        outs.append(dict(contract_ok=bool(out["contract_ok"]),
                         loss=float(out["loss"].detach()),
                         grads={name: p.grad.numpy().copy()
                                for name, p in model.named_parameters()}))
        opt.step()
        opt.zero_grad(set_to_none=True)

    # --- JAX: two steps
    step = step.result()
    jmetrics = []
    for k in range(2):
        state, m = step(state, jarr)
        jmetrics.append({key: float(v) for key, v in m.items()})
        if k == 0:
            jgrads = to_port_names(state.opt_state[0], variables["batch_stats"])
    jafter = to_port_names(state.params, state.batch_stats)

    for k, out in enumerate(outs):
        assert out["contract_ok"] and jmetrics[k]["contract_ok"] == 1.0
        assert abs(out["loss"] - jmetrics[k]["loss"]) <= 1e-5 * jmetrics[k]["loss"]
        assert tsched(k) == pytest.approx(jmetrics[k]["lr"], rel=1e-6)
        if k == 0:
            for name, g in out["grads"].items():
                assert_rel(g, jgrads[name], 1e-4, f"grad {name}")
    for name, v in model.state_dict().items():
        assert_rel(v.numpy(), jafter[name], 1e-5, f"after {name}")
    return [m.last_route for m in model.modules() if isinstance(m, SubMConv)]


def test_train_torch_cli_two_steps_on_cpu(tmp_path):
    """``tools/train_torch.py`` on the tiny synthetic config, one epoch of 2
    steps on the CPU: a log line per step, an evaluation, and a checkpoint
    that loads into a fresh model."""
    cfg_file = os.path.join(ROOT, "configs/_test_/semseg_synthetic.py")
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "train_torch.py"),
         "--config-file", cfg_file, "--options", f"save_path={tmp_path}",
         "device=cpu", "epoch=1", "eval_epoch=1"],
        capture_output=True, text=True, timeout=600, cwd=ROOT,
        env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    log = (tmp_path / "train.log").read_text()
    assert log.count("Train: [1/1][") == 2 and "Val result: mIoU" in log
    ckpt = torch.load(tmp_path / "model" / "model_last.pth", weights_only=True)
    assert ckpt["step"] == 2 and ckpt["extra"]["epoch"] == 1
    from ponderv2_tpu_torch.utils.config import Config

    model = tbuild(dict(Config.fromfile(cfg_file).model))
    model.load_state_dict(ckpt["state_dict"])
    assert all(torch.isfinite(v).all() for v in model.state_dict().values())
