"""The CUDA band conv kernels (K1, K2, K3) and windowed gather-GEMM kernels
(K4, K5) against their plain PyTorch versions, on a GPU.

Marked ``requires_cuda``: each test skips where there is no CUDA device (the
kernel has no CPU or interpret mode). The file imports no JAX, so it also
runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

The f32 comparisons run with TF32 off; the kernel and the plain version sum
the same f32 products in another order, hence the 1e-5 relative bound. bf16
inputs are multiplied and summed in f32 by both, in another order; they are
held to 3e-2 of max|ref| (the bound bench.py:227 uses).
dW is reduced over row chunks in a fixed order (no atomics), so K2/K3 are
deterministic; their bounds are K1's, for the same reasons. K4/K5's plain
versions multiply the same bf16 values in f32, as the kernels do, so both
dtypes are held to 1e-5; K5 is deterministic too.
"""

import numpy as np
import pytest
import torch

from ponderv2_tpu_torch.models import build_model
from ponderv2_tpu_torch.ops import band_conv as bc
from ponderv2_tpu_torch.ops import windowed_gather as wg
from ponderv2_tpu_torch.ops.spconv import apply_sparse_conv, build_subm_rulebook

pytestmark = pytest.mark.requires_cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the band conv kernel has no CPU mode")
    matmul, cudnn = (torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = matmul
    torch.backends.cudnn.allow_tf32 = cudnn


def _scene(n, shape, seed=0):
    rng = np.random.RandomState(seed)
    coords = np.unique(np.stack([rng.randint(0, 2, n), rng.randint(0, shape[0], n),
                                 rng.randint(0, shape[1], n),
                                 rng.randint(0, shape[2], n)], 1), axis=0)
    coords = np.concatenate([coords, np.full((7, 4), -1)]).astype(np.int32)
    return torch.from_numpy(coords)


def _rel_err(out, ref):
    return ((out - ref).abs().max() / ref.abs().max().clamp(min=1e-12)).item()


@pytest.mark.parametrize("block,window", [(8, 32), (32, 8), (256, 384)])
@pytest.mark.parametrize("cin,cout", [(5, 7), (40, 24), (96, 96), (130, 70)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_matches_plain(cuda, block, window, cin, cout, dtype):
    coords = _scene(3000, (24, 24, 24)).to(cuda)
    rb = build_subm_rulebook(coords, (24, 24, 24), 2, 3)
    plan = bc.build_band_plan(rb, 3, block=block, window=window)
    gen = torch.Generator(device=cuda).manual_seed(cin * cout)
    f = torch.randn(rb.shape[1], cin, device=cuda, generator=gen).to(dtype)
    w = (torch.randn(27, cin, cout, device=cuda, generator=gen) / cin ** 0.5).to(dtype)
    out = bc.band_fwd_core(f, plan.rbt, plan.w0, w, 3, block, window)
    ref = bc.band_fwd_core_plain(f, plan.rbt, plan.w0, w, 3, block, window)
    torch.cuda.synchronize()
    assert out.dtype == torch.float32 and out.shape == ref.shape
    assert _rel_err(out, ref.float()) <= (1e-5 if dtype == torch.float32 else 3e-2)


@pytest.mark.parametrize("block,window", [(8, 32), (32, 8), (256, 384)])
@pytest.mark.parametrize("cin,cout", [(5, 7), (40, 24), (96, 96), (130, 70)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_k3_match_plain(cuda, block, window, cin, cout, dtype):
    coords = _scene(3000, (24, 24, 24)).to(cuda)
    rb = build_subm_rulebook(coords, (24, 24, 24), 2, 3)
    plan = bc.build_band_plan(rb, 3, block=block, window=window)
    gen = torch.Generator(device=cuda).manual_seed(cin * cout)
    n = rb.shape[1]
    f = torch.randn(n, cin, device=cuda, generator=gen).to(dtype)
    g = torch.randn(n, cout, device=cuda, generator=gen).to(dtype)
    wmt = (torch.randn(27, cout, cin, device=cuda, generator=gen)
           / cout ** 0.5).to(dtype)
    args = (plan.rbt, plan.w0)
    tail = (3, block, window)
    dx, dwr = bc.band_dxdw_core(g, f, *args, wmt, *tail)
    rdx, rdwr = bc.band_dxdw_core_plain(g, f, *args, wmt, *tail)
    dw3 = bc.band_dw_core(f, g, *args, *tail)
    rdw3 = bc.band_dw_core_plain(f, g, *args, *tail)
    torch.cuda.synchronize()
    bound = 1e-5 if dtype == torch.float32 else 3e-2
    for out, ref in [(dx, rdx), (dwr, rdwr), (dw3, rdw3)]:
        assert out.dtype == torch.float32 and out.shape == ref.shape
        assert _rel_err(out, ref.float()) <= bound
    # deterministic: the same launch gives the same bits
    assert torch.equal(bc.band_dw_core(f, g, *args, *tail), dw3)


def test_band_subm_conv_cuda_equals_plain_conv(cuda):
    """The whole wrapper on CUDA (K1 + overflow residual + gate + mask) is the
    plain subm conv, with and without window overflow; a plan whose budget
    overflowed gives exact zeros."""
    coords = _scene(3000, (24, 24, 24)).to(cuda)
    rb = build_subm_rulebook(coords, (24, 24, 24), 2, 3)
    mask = coords[:, 0] >= 0
    gen = torch.Generator(device=cuda).manual_seed(0)
    f = torch.randn(rb.shape[1], 64, device=cuda, generator=gen) * mask[:, None]
    w = torch.randn(27, 64, 32, device=cuda, generator=gen) / 8.0
    ref = apply_sparse_conv(f, rb, w, mask)
    for block, window in [(256, 384), (32, 8)]:
        plan = bc.build_band_plan(rb, 3, block=block, window=window,
                                  pair_budget=10 ** 6, entry_budget=27 * len(f))
        assert bool(plan.ok)
        out = bc.band_subm_conv((3, block, window), f, plan, w, mask)
        assert _rel_err(out, ref) <= 1e-5
        for fused in (True, False):  # K2, and K1 on the cotangent + K3
            fb, wb = f.clone().requires_grad_(), w.clone().requires_grad_()
            fp, wp = f.clone().requires_grad_(), w.clone().requires_grad_()
            route = bc.fused_bwd_fits
            bc.fused_bwd_fits = lambda *a, **k: fused
            try:
                before = (bc.BAND_DXDW.launches, bc.BAND_DW.launches)
                bc.band_subm_conv((3, block, window), fb, plan, wb, mask).square().sum().backward()
            finally:
                bc.fused_bwd_fits = route
            assert (bc.BAND_DXDW.launches - before[0], bc.BAND_DW.launches - before[1]) == (
                (1, 0) if fused else (0, 1))
            apply_sparse_conv(fp, rb, wp, mask).square().sum().backward()
            assert _rel_err(fb.grad, fp.grad) <= 1e-5
            assert _rel_err(wb.grad, wp.grad) <= 1e-5
    gated = bc.build_band_plan(rb, 3, block=32, window=8, pair_budget=0)
    assert not bool(gated.ok)
    fz, wz = f.clone().requires_grad_(), w.clone().requires_grad_()
    zero = bc.band_subm_conv((3, 32, 8), fz, gated, wz, mask)
    assert zero.abs().sum().item() == 0.0
    zero.sum().backward()
    assert fz.grad.abs().sum().item() == 0.0 and wz.grad.abs().sum().item() == 0.0


def test_k1_counts_launches_and_rejects_bad_input(cuda):
    coords = _scene(500, (12, 12, 12)).to(cuda)
    rb = build_subm_rulebook(coords, (12, 12, 12), 2, 3)
    plan = bc.build_band_plan(rb, 3)
    f = torch.randn(rb.shape[1], 16, device=cuda)
    w = torch.randn(27, 16, 8, device=cuda)
    args = (plan.rbt, plan.w0)
    before = bc.BAND_FWD.launches
    bc.band_fwd_core(f, *args, w, 3, bc.BLOCK, bc.WINDOW)
    assert bc.BAND_FWD.launches == before + 1
    # a backward through the autograd wrapper launches K1 once more for the
    # forward and one K2 (16 -> 8 fits the fused route)
    mask = coords[:, 0] >= 0
    fused_before = bc.BAND_DXDW.launches
    out = bc.band_subm_conv((3, bc.BLOCK, bc.WINDOW), f.clone().requires_grad_(),
                            plan, w, mask)
    out.sum().backward()
    assert bc.BAND_FWD.launches == before + 2
    assert bc.BAND_DXDW.launches == fused_before + 1
    before = bc.BAND_FWD.launches
    with pytest.raises(TypeError):
        bc.band_fwd_core(f.half(), *args, w.half(), 3, bc.BLOCK, bc.WINDOW)
    with pytest.raises(ValueError):
        bc.band_fwd_core(f.t().contiguous().t(), *args, w, 3, bc.BLOCK, bc.WINDOW)
    with pytest.raises(ValueError):
        bc.band_fwd_core(f, *args, w[:, :8], 3, bc.BLOCK, bc.WINDOW)
    with pytest.raises(ValueError):
        bc.band_dw_core(f, f[:-1], *args, 3, bc.BLOCK, bc.WINDOW)
    with pytest.raises(TypeError):
        bc.band_dxdw_core(f.half(), f.half(), *args, w.half().transpose(1, 2),
                          3, bc.BLOCK, bc.WINDOW)
    assert bc.BAND_FWD.launches == before


def test_segmentor_cuda_matches_cpu(cuda):
    """A small DefaultSegmentor forward on the GPU (K1 on every band conv)
    matches the same model on the CPU (plain versions throughout)."""
    model = build_model(dict(type="DefaultSegmentor", backbone=dict(
        type="SpUNet-v1m1", in_channels=9, num_classes=20, base_channels=16,
        channels=(16, 32, 64, 96, 96, 64, 48, 72), layers=(1,) * 8))).eval()
    coords = _scene(4000, (100, 100, 40))
    coords = coords[coords[:, 0] <= 0]  # one scene and the padding rows
    inputs = dict(feat=torch.randn(len(coords), 9,
                                   generator=torch.Generator().manual_seed(0)),
                  grid_coord=coords[:, 1:], batch=coords[:, 0],
                  spatial_shape=(1024, 1024, 512), batch_size=1)
    with torch.inference_mode():
        ref = model(inputs)
        before = bc.BAND_FWD.launches
        gpu = model.to(cuda)({k: v.to(cuda) if torch.is_tensor(v) else v
                              for k, v in inputs.items()})
    assert bc.BAND_FWD.launches - before == 16
    assert bool(gpu["contract_ok"]) and bool(ref["contract_ok"])
    assert _rel_err(gpu["seg_logits"].cpu(), ref["seg_logits"]) <= 1e-4


def _monotone_rulebook(n, k3, group, spread, seed=0):
    """Group-coherent per-tap shifts, as sorted rulebooks have; 30% absent."""
    rng = np.random.RandomState(seed)
    rbs = []
    for t in range(k3):
        shift = rng.randint(-spread, spread) if t % group == 0 else shift
        idx = np.arange(n) + shift + t % group * 3 + rng.randint(-8, 8, n)
        idx = np.clip(np.sort(idx), 0, n - 1)
        rbs.append(np.where(rng.rand(n) < 0.3, -1, idx))
    return torch.from_numpy(np.stack(rbs).astype(np.int32))


@pytest.mark.parametrize("k3,cin,cout,group", [(27, 32, 32, 9), (27, 70, 130, 9),
                                               (125, 6, 32, 25)])
@pytest.mark.parametrize("block,wb", [(64, 256), (128, 32)], ids=["covered", "uncovered"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k4_k5_match_plain(cuda, k3, cin, cout, group, block, wb, dtype):
    n = 3000
    rb = _monotone_rulebook(n, k3, group, 40).to(cuda)
    geom = wg.prepare_geometry(rb, n, block, wb, group)
    assert bool(geom.covered) == (wb == 256)
    gen = torch.Generator(device=cuda).manual_seed(cin * cout)
    f = wg.pad_features(torch.randn(n, cin, device=cuda, generator=gen),
                        wg.padded_rows(n, wb), dtype)
    w = (torch.randn(k3, cin, cout, device=cuda, generator=gen) / cin ** 0.5).to(dtype)
    g = torch.randn(geom.rbb.shape[1] * block, cout, device=cuda, generator=gen).to(dtype)
    before = (wg.WINDOWED_FWD.launches, wg.WINDOWED_DW.launches)
    out = wg.windowed_conv_fwd(f, geom, w, wb, group)
    dw = wg.windowed_conv_dw(f, geom, g, wb, group)
    assert (wg.WINDOWED_FWD.launches, wg.WINDOWED_DW.launches) == (before[0] + 1,
                                                                  before[1] + 1)
    ref = wg.windowed_conv_fwd_plain(f, geom, w, wb, group)
    rdw = wg.windowed_conv_dw_plain(f, geom, g, wb, group)
    torch.cuda.synchronize()
    assert out.dtype == dw.dtype == torch.float32
    assert out.shape == ref.shape and dw.shape == rdw.shape
    assert _rel_err(out, ref) <= 1e-5 and _rel_err(dw, rdw) <= 1e-5
    assert torch.equal(wg.windowed_conv_dw(f, geom, g, wb, group), dw)


def test_k4_k5_reject_bad_input(cuda):
    n, wb, group = 500, 64, 9
    rb = _monotone_rulebook(n, 27, group, 10).to(cuda)
    geom = wg.prepare_geometry(rb, n, 64, wb, group)
    f = wg.pad_features(torch.randn(n, 8, device=cuda), wg.padded_rows(n, wb),
                        torch.float32)
    w = torch.randn(27, 8, 4, device=cuda)
    before = (wg.WINDOWED_FWD.launches, wg.WINDOWED_DW.launches)
    with pytest.raises(TypeError):
        wg.windowed_conv_fwd(f.half(), geom, w.half(), wb, group)
    with pytest.raises(ValueError):
        wg.windowed_conv_fwd(f[:-1], geom, w, wb, group)
    with pytest.raises(ValueError):
        wg.windowed_conv_fwd(f, geom, w[:, :4], wb, group)
    with pytest.raises(ValueError):
        wg.windowed_conv_dw(f, geom, torch.randn(7, 4, device=cuda), wb, group)
    assert (wg.WINDOWED_FWD.launches, wg.WINDOWED_DW.launches) == before
