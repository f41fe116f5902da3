"""The port's plain path in float64, the reference ``chip_smoke.py`` phase
14 holds the kernels' f32 grads to.

The plain versions of K1-K3 and the plain gather, strided and inverse
convs sum in f32 for bf16 and f32 operands and in float64 for float64 ones
(``ops/scatter.py:sum_dtype``), so a float64 copy of a model runs its
forward and backward in float64 on either device. Checked on the CPU:
each plain core's output dtype; each conv's backward against finite
differences (``torch.autograd.gradcheck``, which needs float64); and
``chip_smoke.py:float64_step_grads`` (a float64 copy of a PPT-v1m1 step,
its blocks under activation checkpointing) against the same step without
checkpointing (1e-10 of max|grad|) and against the f32 step (1e-4 of
max|grad|, f32 rounding); ``chip_smoke.py:PinnedRelu``, which shares one
run's relu decisions with the others of a grads check.
"""

import copy
import os
import sys

import numpy as np
import pytest
import torch

from ponderv2_tpu_torch.models import build_model
from ponderv2_tpu_torch.ops import band_conv as bc
from ponderv2_tpu_torch.ops import spconv as sp
from ponderv2_tpu_torch.ops.scatter import sum_dtype
from test_torch_ppt import PPT, SHAPE, arrays_of, randomize, scene_batch
from torch_threads import _torch_threads  # noqa: F401, E402  (autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tools")]

GRID = (8, 8, 8)


@pytest.fixture(autouse=True)
def _threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def scene(n=48, seed=0):
    """Unique voxels of 2 scenes in ascending key order, 4 padding rows."""
    rng = np.random.RandomState(seed)
    coords = np.unique(np.stack([rng.randint(0, 2, n)] + [
        rng.randint(0, s, n) for s in GRID], 1), axis=0).astype(np.int32)
    coords = np.concatenate([coords, np.full((4, 4), -1, np.int32)])
    return torch.from_numpy(coords)


def randn(*shape, seed=0, dtype=torch.float64):
    return torch.from_numpy(np.random.RandomState(seed).randn(*shape)).to(dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float64],
                         ids=["bf16", "f32", "f64"])
def test_plain_cores_sum_in_the_operands_sum_dtype(dtype):
    """f32 sums for bf16 and f32 operands (as the kernels sum), float64 for
    float64: K1-K3's plain versions and the plain gather conv."""
    coords = scene()
    rb = sp.build_subm_rulebook(coords, GRID, 2, 3)
    plan = bc.build_band_plan_auto(rb, 3)
    n = coords.shape[0]
    f, g = randn(n, 3, dtype=dtype), randn(n, 2, seed=1, dtype=dtype)
    w = randn(27, 3, 2, seed=2, dtype=dtype)
    tail = (3, bc.BLOCK, bc.WINDOW)
    want = sum_dtype(dtype)
    assert want == (torch.float64 if dtype == torch.float64 else torch.float32)
    assert bc.band_fwd_core_plain(f, plan.rbt, plan.w0, w, *tail).dtype == want
    dx, dwr = bc.band_dxdw_core_plain(g, f, plan.rbt, plan.w0,
                                      w.flip(0).transpose(1, 2).contiguous(), *tail)
    assert dx.dtype == dwr.dtype == want
    assert bc.band_dw_core_plain(f, g, plan.rbt, plan.w0, *tail).dtype == want
    if dtype == torch.float64:
        assert sp.apply_sparse_conv(f, rb, w, coords[:, 0] >= 0).dtype == torch.float64


def _band(route, block, window):
    def conv(f, w, coords):
        rb = sp.build_subm_rulebook(coords, GRID, 2, 3)
        plan = bc.build_band_plan(rb, 3, block=block, window=window)
        assert bool(plan.ok)
        fits = bc.fused_bwd_fits
        bc.fused_bwd_fits = lambda *a, **k: route == "fused"
        try:
            return bc.band_subm_conv((3, block, window), f, plan, w, coords[:, 0] >= 0)
        finally:
            bc.fused_bwd_fits = fits
    return conv


def _subm(f, w, coords):
    rb = sp.build_subm_rulebook(coords, GRID, 2, 3)
    return sp.subm_conv_symmetric(f, rb, w, coords[:, 0] >= 0)


def _strided(f, w, coords):
    plan = sp.build_strided_plan(coords, GRID, 2, 2, 2, 0, coords.shape[0])
    return sp.strided_conv_packed(f, plan.parent, plan.tap, w, coords.shape[0],
                                  plan.out_coords[:, 0] >= 0)


def _inverse(f, w, coords):
    plan = sp.build_strided_plan(coords, GRID, 2, 2, 2, 0, coords.shape[0])
    coarse = torch.zeros(coords.shape[0], f.shape[1], dtype=f.dtype)
    coarse = coarse.index_add(0, plan.parent.clamp(min=0).long(), f)  # any coarse rows
    return sp.inverse_conv_packed(coarse, plan.parent, plan.tap, w, coords[:, 0] >= 0)


CONVS = {
    "band-fused": (_band("fused", bc.BLOCK, bc.WINDOW), 27),
    "band-split": (_band("split", bc.BLOCK, bc.WINDOW), 27),
    "band-overflow": (_band("split", 32, 8), 27),
    "subm-gather": (_subm, 27),
    "strided": (_strided, 8),
    "inverse": (_inverse, 8),
}


@pytest.mark.parametrize("name", list(CONVS))
def test_plain_convs_backward_in_float64(name):
    """Each conv's backward (the band conv's fused and split routes and its
    overflow residual, the mirrored-gather subm conv, the packed strided
    and inverse convs) against finite differences in float64."""
    conv, taps = CONVS[name]
    coords = scene()
    n = coords.shape[0]
    valid = (coords[:, 0] >= 0).double()[:, None]
    f = (randn(n, 3) * valid).requires_grad_()
    w = (randn(taps, 3, 2, seed=1) * 0.3).requires_grad_()
    assert conv(f, w, coords).dtype == torch.float64
    assert torch.autograd.gradcheck(lambda a, b: conv(a, b, coords), (f, w))


def test_float64_reference_step_matches_f32():
    """``chip_smoke.py:float64_step_grads`` on a PPT-v1m1 step: float64
    grads of every parameter the f32 step reaches, equal (1e-10 of
    max|grad|) to a float64 run without checkpointing, and within 1e-4 of
    max|grad| of the f32 step."""
    import chip_smoke as cs

    model = randomize(build_model(dict(PPT))).train()
    inputs = {**{k: torch.from_numpy(v) for k, v in arrays_of(scene_batch()).items()},
              "spatial_shape": SHAPE, "batch_size": 2, "condition": "ScanNet"}
    loss32, g32, _, _ = cs.step_grads(model, inputs)
    loss64, g64, _ = cs.float64_step_grads(model, inputs)
    m64 = copy.deepcopy(model).double()
    x64 = {k: v.double() if torch.is_tensor(v) and v.is_floating_point() else v
           for k, v in inputs.items()}
    out = m64(x64)
    out["loss"].backward()
    assert sorted(g64) == sorted(g32)
    assert abs(loss64 - float(out["loss"].detach())) <= 1e-12 * abs(loss64)
    assert abs(loss64 - loss32) <= 1e-6 * abs(loss64)
    for name, g in g64.items():
        assert g.dtype == torch.float64, name
        scale = g.abs().max().item()
        ref = m64.get_parameter(name).grad
        assert (g - ref).abs().max().item() <= 1e-10 * scale, name
        assert (g32[name].double() - g).abs().max().item() <= 1e-4 * scale, name


def test_pinned_relu_shares_the_plain_path_decisions():
    """``chip_smoke.py:PinnedRelu``: a replay of a recorded step gives its
    loss and grads bit for bit with no decision flipped; a float64 step
    without checkpointing replays every relu call in order; a changed
    record changes the step; and ``grads_kernel_vs_plain`` with
    ``pin_relu`` (on the CPU both paths are the plain one) holds. One
    thread, so that the CPU step is bit-reproducible (with more, the row
    gathers' backward adds in a varying order)."""
    import chip_smoke as cs

    torch.set_num_threads(1)
    model = randomize(build_model(dict(PPT))).train()
    inputs = {**{k: torch.from_numpy(v) for k, v in arrays_of(scene_batch()).items()},
              "spatial_shape": SHAPE, "batch_size": 2, "condition": "ScanNet"}
    pin = cs.PinnedRelu()
    loss, grads, _, _ = pin.run("record", lambda: cs.step_grads(model, inputs))
    assert len(pin.masks) > 10
    loss2, grads2, _, _ = pin.run("replay", lambda: cs.step_grads(model, inputs))
    assert pin.flips == 0 and loss2 == loss
    assert all(torch.equal(grads2[k], g) for k, g in grads.items())
    loss64, g64, _ = cs.float64_step_grads(model, inputs)
    pinned64 = pin.run("replay", lambda: cs.float64_step_grads(model, inputs, remat=False))
    assert pin.i == len(pin.masks) and pin.flips == 0
    assert abs(pinned64[0] - loss64) <= 1e-12 * abs(loss64)
    for k, g in g64.items():
        assert (pinned64[1][k] - g).abs().max().item() <= 1e-10 * g.abs().max().item(), k
    pin.masks[0] = torch.zeros_like(pin.masks[0])
    loss3, _, _, _ = pin.run("replay", lambda: cs.step_grads(model, inputs))
    assert pin.flips > 0 and loss3 != loss
    pin.masks.pop()
    with pytest.raises(IndexError):
        pin.run("replay", lambda: cs.step_grads(model, inputs))
    assert torch.relu is not pin  # restored after a failed run
    cs.grads_kernel_vs_plain("pinned", model, inputs, [0, 0, 0], 1e-5, 1e-3, False,
                             reference="float64", pin_relu=True)
