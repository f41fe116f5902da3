"""The CUDA band conv kernels (K1, K2, K3), windowed gather-GEMM kernels
(K4, K5) and probe kernels (P1-P5, P7) against their plain PyTorch
versions, on a GPU.

Marked ``requires_cuda``: each test skips where there is no CUDA device (the
kernel has no CPU or interpret mode). The file imports no JAX, so it also
runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

The f32 comparisons run with TF32 off; the kernel and the plain version sum
the same f32 products in another order (K1-K3 as 3xTF32 products, within
about 3 x 2^-22 of each f32 product), hence the 1e-5 relative bound. bf16
inputs are multiplied and summed in f32 by both, in another order; they are
held to 3e-2 of max|ref| (the bound bench.py:227 uses).
Every sum of K1-K3 runs in a fixed order (K1 adds each tap's compacted
slabs into its output tile, taps in order; dW is reduced over row chunks in
two passes; no atomics), so a second launch gives equal bits. K4/K5's plain
versions multiply the same bf16 values in f32, as the kernels do (on the
tensor-core tiles too: both add each stage's products into f32 sums with
round-to-nearest adds, also over K5's 12,000-row chunks at the pretrain
stem's shape), so both dtypes are held to 1e-5; K4 and K5 are
deterministic too.
"""

import ctypes
import os
import sys

import numpy as np
import pytest
import torch

from ponderv2_tpu_torch.models import build_model
from ponderv2_tpu_torch.ops import band_conv as bc
from ponderv2_tpu_torch.ops import probe_kernels as pk
from ponderv2_tpu_torch.ops import row_gather as rg
from ponderv2_tpu_torch.ops import windowed_gather as wg
from ponderv2_tpu_torch.ops.spconv import apply_sparse_conv, build_subm_rulebook

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "tools", "experiments"))

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


# every (cin, cout) K1 runs on the fine-tune and pretrain steps: each band
# conv's forward and the split convs' dx (cout -> cin)
K1_WIDTHS = [(32, 32), (64, 64), (96, 96), (128, 96), (128, 128), (192, 128), (256, 256),
             (384, 256), (256, 384)]
SPLIT_WIDTHS = [(256, 256), (384, 256)]


def _plan_and_operands(device, cin, cout, dtype, seed, block=bc.BLOCK, window=bc.WINDOW):
    coords = _scene(3000, (24, 24, 24)).to(device)
    rb = build_subm_rulebook(coords, (24, 24, 24), 2, 3)
    plan = bc.build_band_plan(rb, 3, block=block, window=window)
    gen = torch.Generator(device=device).manual_seed(seed)
    n = rb.shape[1]
    f = torch.randn(n, cin, device=device, generator=gen).to(dtype)
    g = torch.randn(n, cout, device=device, generator=gen).to(dtype)
    w = (torch.randn(27, cin, cout, device=device, generator=gen) / cin ** 0.5).to(dtype)
    return plan, f, g, w


@pytest.mark.parametrize("cin,cout", K1_WIDTHS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_routed_widths(cuda, cin, cout, dtype):
    """K1 at every routed width against its plain version, equal bits on a
    second launch, its shared memory as ``fwd_plan`` reckons it."""
    plan, f, _, w = _plan_and_operands(cuda, cin, cout, dtype, cin + cout)
    args, tail = (plan.rbt, plan.w0), (3, bc.BLOCK, bc.WINDOW)
    out = bc.band_fwd_core(f, *args, w, *tail)
    ref = bc.band_fwd_core_plain(f, *args, w, *tail)
    torch.cuda.synchronize()
    assert _rel_err(out, ref) <= (1e-5 if dtype == torch.float32 else 3e-2)
    assert torch.equal(bc.band_fwd_core(f, *args, w, *tail), out)
    p = bc.fwd_plan(len(f), cin, cout, 27, dtype)
    smem = bc.BAND_FWD.lib().band_fwd_smem_bytes
    smem.restype = ctypes.c_longlong
    assert smem(int(dtype == torch.bfloat16), p.co_tile, 27) == p.smem_bytes


@pytest.mark.parametrize("cin,cout", SPLIT_WIDTHS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_split_widths(cuda, cin, cout, dtype):
    """K3 at the split convs' widths against its plain version, equal bits
    on a second launch, its shared memory as ``dw_plan`` reckons it."""
    plan, f, g, _ = _plan_and_operands(cuda, cin, cout, dtype, cin * cout)
    args, tail = (plan.rbt, plan.w0), (3, bc.BLOCK, bc.WINDOW)
    dwr = bc.band_dw_core(f, g, *args, *tail)
    ref = bc.band_dw_core_plain(f, g, *args, *tail)
    torch.cuda.synchronize()
    assert _rel_err(dwr, ref) <= (1e-5 if dtype == torch.float32 else 3e-2)
    assert torch.equal(bc.band_dw_core(f, g, *args, *tail), dwr)
    p = bc.dw_plan(len(f), cin, cout, 27, dtype)
    smem = bc.BAND_DW.lib().band_dw_smem_bytes
    smem.restype = ctypes.c_longlong
    assert smem(int(dtype == torch.bfloat16), p.ci_tile, p.co_tile) == p.smem_bytes


@pytest.mark.parametrize("cin,cout", [(96, 96), (256, 256)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])  # K1's two tiles
def test_k1_k3_dead_tile_and_gated(cuda, cin, cout, dtype):
    """K1 and K3 on a plan with a whole 256-row tile and a 1024-row dW window
    dead in every tap and one tap dead everywhere; and the split route
    (K1 on the cotangent + K3) of a ``pair_budget=0`` plan gives exact zeros."""
    plan, f, g, w = _plan_and_operands(cuda, cin, cout, dtype, 11)
    rbt = plan.rbt.clone()
    rbt[256:512] = -1
    rbt[1024:2048] = -1
    rbt[:, 5] = -1
    args, tail = (rbt, plan.w0), (3, bc.BLOCK, bc.WINDOW)
    bound = 1e-5 if dtype == torch.float32 else 3e-2
    out = bc.band_fwd_core(f, *args, w, *tail)
    assert _rel_err(out, bc.band_fwd_core_plain(f, *args, w, *tail)) <= bound
    assert float(out[256:512].abs().max()) == 0.0
    dwr = bc.band_dw_core(f, g, *args, *tail)
    assert _rel_err(dwr, bc.band_dw_core_plain(f, g, *args, *tail)) <= bound
    assert float(dwr[5].abs().max()) == 0.0
    coords = _scene(3000, (24, 24, 24)).to(cuda)
    rb = build_subm_rulebook(coords, (24, 24, 24), 2, 3)
    gated = bc.build_band_plan(rb, 3, block=32, window=8, pair_budget=0)
    assert not bool(gated.ok)
    fz, wz = f.float().clone().requires_grad_(), w.float().clone().requires_grad_()
    before = (bc.BAND_FWD.launches, bc.BAND_DW.launches)
    route = bc.fused_bwd_fits
    bc.fused_bwd_fits = lambda *a, **k: False  # block 32 / window 8 would fit K2
    try:
        zero = bc.band_subm_conv((3, 32, 8), fz, gated, wz, coords[:, 0] >= 0, dtype)
        zero.sum().backward()
    finally:
        bc.fused_bwd_fits = route
    assert (bc.BAND_FWD.launches - before[0], bc.BAND_DW.launches - before[1]) == (2, 1)
    assert zero.abs().sum().item() == 0.0
    assert fz.grad.abs().sum().item() == 0.0 and wz.grad.abs().sum().item() == 0.0


def test_ordered_scatter_add_on_cuda_sums_in_order(cuda):
    """The fixed-order sum of the reproducible steps: on CUDA each row's
    values are added in the order given, as on the CPU (equal bits), and a
    second call gives the same bits."""
    from ponderv2_tpu_torch.ops.scatter import ordered_scatter_add

    gen = torch.Generator().manual_seed(0)
    idx = torch.randint(0, 300, (200_000,), generator=gen)
    vals = torch.randn(200_000, 24, generator=gen) * 10.0 ** torch.randint(
        -3, 4, (200_000, 1), generator=gen)
    ref = ordered_scatter_add(torch.zeros(300, 24), idx, vals)
    out = ordered_scatter_add(torch.zeros(300, 24, device=cuda), idx.to(cuda), vals.to(cuda))
    assert torch.equal(out.cpu(), ref)
    assert torch.equal(ordered_scatter_add(torch.zeros(300, 24, device=cuda), idx.to(cuda),
                                           vals.to(cuda)), out)


# every width the fine-tune and pretrain steps route to K2, and ragged ones
K2_WIDTHS = [(32, 32), (64, 64), (96, 96), (128, 96), (128, 128), (192, 128), (5, 7),
             (40, 24), (130, 70)]


@pytest.mark.parametrize("block,window", [(8, 32), (32, 8), (256, 384)])
@pytest.mark.parametrize("cin,cout", K2_WIDTHS)
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
    dx2, dwr2 = bc.band_dxdw_core(g, f, *args, wmt, *tail)
    assert torch.equal(dx2, dx) and torch.equal(dwr2, dwr)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_dead_slabs(cuda, dtype):
    """K2 on a plan whose taps are dead for whole 16-row slabs (the warps'
    and the dW slabs' skips), with a slab dead in every tap and a tap dead
    in every row, at 96 -> 96."""
    coords = _scene(3000, (24, 24, 24)).to(cuda)
    rb = build_subm_rulebook(coords, (24, 24, 24), 2, 3)
    plan = bc.build_band_plan(rb, 3)
    rbt = plan.rbt.clone()
    rbt[16:32] = -1                   # one slab dead in every tap
    rbt[48:64, :14] = -1              # one slab dead in half the taps
    rbt[:, 5] = -1                    # one tap dead everywhere
    rbt[160:1184, 20:] = -1           # whole dx CTAs and dW windows dead in most taps
    gen = torch.Generator(device=cuda).manual_seed(7)
    n = rb.shape[1]
    f = torch.randn(n, 96, device=cuda, generator=gen).to(dtype)
    g = torch.randn(n, 96, device=cuda, generator=gen).to(dtype)
    wmt = (torch.randn(27, 96, 96, device=cuda, generator=gen) / 96 ** 0.5).to(dtype)
    args, tail = (rbt, plan.w0, wmt), (3, bc.BLOCK, bc.WINDOW)
    dx, dwr = bc.band_dxdw_core(g, f, *args, *tail)
    rdx, rdwr = bc.band_dxdw_core_plain(g, f, *args, *tail)
    torch.cuda.synchronize()
    bound = 1e-5 if dtype == torch.float32 else 3e-2
    assert _rel_err(dx, rdx) <= bound and _rel_err(dwr, rdwr) <= bound
    assert float(dwr[5].abs().max()) == 0.0


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


def test_mink_unet_cuda_routes_band_levels_to_k1(cuda, monkeypatch):
    """A MinkUNet segmentor on the GPU: its convs over the levels wider than
    64 channels (``BandedRulebook``) launch K1, one each, and match the
    model on the CPU; a carrier whose ``ok`` is False turns ``contract_ok``
    False (and zeroes its convs)."""
    from ponderv2_tpu_torch.models.sparse_unet import mink_unet
    from ponderv2_tpu_torch.models.sparse_unet.layers import SubMConv

    model = build_model(dict(type="DefaultSegmentor", backbone=dict(
        type="MinkUNet14A", in_channels=9, out_channels=20, init_dim=16,
        planes=(16, 72, 72, 16), layers=(1, 2, 2, 1)))).eval()
    coords = _scene(4000, (100, 100, 40))
    inputs = dict(feat=torch.randn(len(coords), 9,
                                   generator=torch.Generator().manual_seed(0)),
                  grid_coord=coords[:, 1:], batch=coords[:, 0],
                  spatial_shape=(1024, 1024, 512), batch_size=2)
    with torch.inference_mode():
        ref = model(inputs)
        model.to(cuda)
        gpu_inputs = {k: v.to(cuda) if torch.is_tensor(v) else v for k, v in inputs.items()}
        before = bc.BAND_FWD.launches
        gpu = model(gpu_inputs)
        routes = [m.last_route for m in model.modules() if isinstance(m, SubMConv)]
        assert bc.BAND_FWD.launches - before == routes.count("band-attached") == 8
        assert bool(gpu["contract_ok"]) and bool(ref["contract_ok"])
        assert _rel_err(gpu["seg_logits"].cpu(), ref["seg_logits"]) <= 1e-4

        attach = mink_unet.attach_band_rulebook

        def failed(legacy):
            rb = attach(legacy)
            return rb._replace(band=rb.band._replace(ok=torch.zeros_like(rb.band.ok)))

        monkeypatch.setattr(mink_unet, "attach_band_rulebook", failed)
        assert not bool(model(gpu_inputs)["contract_ok"])


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("adaptive", [True, False], ids=["adaptive", "plain"])
def test_pdbatchnorm_cuda_matches_cpu(cuda, adaptive, train):
    """PDBatchNorm on the GPU gives the CPU's output (1e-5 of max|ref|) and
    moves only the selected condition's running statistics."""
    from ponderv2_tpu_torch.models.norm import PDBatchNorm

    gen = torch.Generator().manual_seed(0)
    x = torch.randn(5000, 96, generator=gen) * 2 + 0.5
    mask = torch.rand(5000, generator=gen) > 0.1
    context = torch.randn(256, generator=gen)
    norm = PDBatchNorm(96, adaptive=adaptive).train(train)
    with torch.no_grad():
        for p in norm.parameters():
            p.uniform_(0.5, 1.5, generator=gen)
    before = {k: v.clone() for k, v in norm.state_dict().items()}
    gpu = PDBatchNorm(96, adaptive=adaptive).train(train).to(cuda)
    gpu.load_state_dict(before)
    with torch.no_grad():
        ref = norm(x, mask, 1, context)
        out = gpu(x.to(cuda), mask.to(cuda), 1, context.to(cuda))
    assert _rel_err(out.cpu(), ref) <= 1e-5
    for name, v in gpu.state_dict().items():
        assert _rel_err(v.cpu(), norm.state_dict()[name]) <= 1e-5, name
        moved = not torch.equal(v.cpu(), before[name])
        assert moved == (train and name.startswith("bns.1.running")), name


V1M3 = dict(type="SpUNet-v1m3", in_channels=6, num_classes=0, base_channels=16,
            channels=(16, 32, 64, 96, 96, 64, 48, 72), layers=(1,) * 8,
            context_channels=32)


def test_spunet_v1m3_cuda_matches_cpu(cuda):
    """A narrow SpUNet-v1m3 forward on the GPU (K1 on every band conv)
    matches the same model on the CPU (plain versions throughout) within
    K1's f32 bound here, 1e-4 of max|ref|, for two conditions."""
    from ponderv2_tpu_torch.ops.sparse import make_sparse_tensor

    model = build_model(dict(V1M3)).eval()
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():  # per-condition norms that differ
        for name, v in list(model.named_parameters()) + list(model.named_buffers()):
            if ".bns." in name and not name.endswith("num_batches_tracked"):
                v.uniform_(0.5, 1.5, generator=gen)
    gpu = build_model(dict(V1M3)).eval().to(cuda)
    gpu.load_state_dict(model.state_dict())
    coords = _scene(4000, (100, 100, 40))
    coords = coords[coords[:, 0] <= 0]  # one scene and the padding rows
    st = make_sparse_tensor(torch.randn(len(coords), 6, generator=gen), coords,
                            (1024, 1024, 512), 1)
    gst = make_sparse_tensor(st.features.to(cuda), coords.to(cuda), (1024, 1024, 512), 1)
    context = torch.randn(32, generator=gen)
    outs = []
    for cond in ("ScanNet", "S3DIS"):
        with torch.inference_mode():
            ref, ok_ref = model(st, cond, context)
            before = bc.BAND_FWD.launches
            out, ok = gpu(gst, cond, context.to(cuda))
        assert bc.BAND_FWD.launches - before == 16
        assert bool(ok) and bool(ok_ref)
        assert _rel_err(out.cpu(), ref) <= 1e-4
        outs.append(out)
    assert not torch.equal(outs[0], outs[1])


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


@pytest.mark.parametrize("k3,cin,cout,group,n", [
    (27, 32, 32, 9, 3000), (27, 70, 130, 9, 3000), (125, 6, 32, 25, 3000),
    (9, 8, 40, 9, 3000), (25, 40, 8, 25, 3000), (27, 96, 96, 9, 3000), (125, 8, 96, 25, 3000),
    (27, 40, 6, 1, 3000),
    (125, 6, 32, 25, 204_800)])  # the pretrain stem: K5's row chunks of 12,048 rows
@pytest.mark.parametrize("block,wb", [(64, 256), (128, 32)], ids=["covered", "uncovered"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k4_k5_match_plain(cuda, k3, cin, cout, group, n, block, wb, dtype):
    """K4 and K5 on the tensor-core tiles against their plain versions at
    narrow, ragged and wide widths, 9-125 taps and K5 chunks of 1,000 to
    12,000 rows, with tap 5 dead and, in the uncovered case, entries
    outside their windows; equal bits on a second launch."""
    rb = _monotone_rulebook(n, k3, group, 40)
    rb[5] = -1
    rb = rb.to(cuda)
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
    assert float(dw[5].abs().max()) == 0.0
    assert torch.equal(wg.windowed_conv_dw(f, geom, g, wb, group), dw)
    assert torch.equal(wg.windowed_conv_fwd(f, geom, w, wb, group), out)


@pytest.mark.parametrize("k3,cin,cout", [(27, 32, 32), (27, 96, 96), (125, 8, 32), (125, 6, 32),
                                         (27, 40, 130)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k4_k5_shared_memory_is_the_plans(cuda, k3, cin, cout, dtype):
    """The dynamic shared memory each kernel asks for is what
    ``windowed_fwd_plan`` / ``windowed_dw_plan`` reckon, within an H100's
    232,448 bytes."""
    lib = wg.WINDOWED_FWD.lib()
    fwd, dw = lib.windowed_fwd_smem_bytes, lib.windowed_dw_smem_bytes
    fwd.restype = dw.restype = ctypes.c_longlong
    bf16 = int(dtype == torch.bfloat16)
    p = wg.windowed_fwd_plan(163_840, cin, cout, k3, dtype)
    assert fwd(bf16, p.co_tile, k3) == p.smem_bytes <= 232_448
    d = wg.windowed_dw_plan(163_840, cin, cout, k3, dtype)
    assert dw(bf16, d.co_tile, d.ci_tile) == d.smem_bytes <= 232_448 // 2


def test_k4_k5_dead_block(cuda):
    """An output block whose entries are all dead gives zero rows (K4), and
    a rulebook with no live entry a zero dW (K5)."""
    n, k3, group, block, wb = 3000, 27, 9, 512, 256
    rb = _monotone_rulebook(n, k3, group, 40)
    rb[:, 512:1024] = -1
    rb = rb.to(cuda)
    geom = wg.prepare_geometry(rb, n, block, wb, group)
    for dtype in (torch.float32, torch.bfloat16):
        f = wg.pad_features(torch.randn(n, 32, device=cuda), wg.padded_rows(n, wb), dtype)
        w = torch.randn(k3, 32, 32, device=cuda).to(dtype)
        out = wg.windowed_conv_fwd(f, geom, w, wb, group)
        assert float(out[512:1024].abs().max()) == 0.0
        assert _rel_err(out, wg.windowed_conv_fwd_plain(f, geom, w, wb, group)) <= 1e-5
        dead = wg.prepare_geometry(torch.full_like(rb, -1), n, block, wb, group)
        g = torch.randn(dead.rbb.shape[1] * block, 32, device=cuda).to(dtype)
        assert float(wg.windowed_conv_dw(f, dead, g, wb, group).abs().max()) == 0.0


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


@pytest.mark.parametrize("kind", ["subm k3", "subm k5", "strided k2"])
@pytest.mark.parametrize("order", ["covered", "shuffled"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_windowed_route_on_cuda(cuda, monkeypatch, kind, order, dtype):
    """The windowed route (``PONDER_WINDOWED_GATHER`` set) on the card: the
    subm conv (K4 forward, dx as K4 over g, dW by K5) and the strided k2s2
    conv over its rulebook (8 taps in groups of 4; dx by the rulebook
    backward, dW by K5), each plus its residual, against the plain gather
    conv on the same inputs: output, dx and dW within 1e-5 of max|ref| in
    f32 and 3e-2 in bf16, with the rows in order and shuffled (most entries
    then outside their windows); K4 and K5 launch."""
    from ponderv2_tpu_torch.ops import spconv as sc

    monkeypatch.setenv("PONDER_WINDOWED_GATHER", "1")
    shape = (96, 96, 32)
    coords = _scene(12000, shape).to(cuda)
    n = coords.shape[0]
    mask = coords[:, 0] >= 0
    if kind == "strided k2":
        plan = sc.build_strided_plan(coords, shape, 2, 2, 2, 0, n)
        rb, out_mask = plan.rulebook, plan.out_coords[:, 0] >= 0
    else:
        rb = sc.build_subm_rulebook(coords, shape, 2, 3 if kind == "subm k3" else 5)
        out_mask = mask
    if order == "shuffled":
        # the rows relabelled by a permutation, outputs with inputs, so that
        # a subm rulebook stays mirror-symmetric
        perm = torch.randperm(n, generator=torch.Generator().manual_seed(1)).to(cuda)
        rb = torch.where(rb >= 0, perm[rb.clamp(min=0).long()].int(), rb)
        if kind != "strided k2":
            rb = rb[:, torch.argsort(perm)]
            mask = out_mask = mask[torch.argsort(perm)]
    assert rb.shape[1] >= 4096
    gen = torch.Generator(device=cuda).manual_seed(3)
    cin, cout = (6, 32) if kind == "subm k5" else (32, 48)
    x = (torch.randn(n, cin, device=cuda, generator=gen) * mask[:, None]).requires_grad_()
    w = (torch.randn(rb.shape[0], cin, cout, device=cuda, generator=gen)
         / (rb.shape[0] * cin) ** 0.5).requires_grad_()
    route = sc.windowed_route(rb, n)
    inside, live = int(route.inside), int(route.live)
    assert (inside == live) if order == "covered" else inside < live
    before = (wg.WINDOWED_FWD.launches, wg.WINDOWED_DW.launches)
    if kind == "strided k2":
        out = sc.apply_sparse_conv_windowed(x, rb, w, out_mask, dtype, route)
    else:
        out = sc.subm_conv_symmetric(x, rb, w, out_mask, dtype, route)
    g = torch.randn(out.shape, device=cuda, generator=gen)
    dx, dw = torch.autograd.grad(out, (x, w), g)
    launches = (wg.WINDOWED_FWD.launches - before[0], wg.WINDOWED_DW.launches - before[1])
    assert launches == ((1, 1) if kind == "strided k2" else (2, 1))
    ref = apply_sparse_conv(x, rb, w, out_mask, dtype)
    rdx, rdw = torch.autograd.grad(ref, (x, w), g)
    bound = 1e-5 if dtype == torch.float32 else 3e-2
    for got, r in ((out, ref), (dx, rdx), (dw, rdw)):
        assert _rel_err(got.detach(), r.detach()) <= bound


# ------------------------------------------------------------------ probe kernels
# (csrc/row_gather.cu, csrc/probe_kernels.cu, the P7 forward of
# csrc/windowed_gather.cu). Their plain versions add the same values in the
# kernels' order, so they are held equal; the slab forward and tile_matmul
# sum products in another order than the plain matmul, to 1e-5 of max|ref|.


def _unaligned(t):
    """A contiguous copy of ``t`` whose data starts one element past a
    16-byte boundary (the kernels' scalar paths)."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = flat[1:].view(t.shape)
    view.copy_(t)
    assert view.data_ptr() % 16 != 0
    return view


@pytest.mark.parametrize("c", [128, 37, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_row_gather_kernels_match_plain(cuda, c, dtype):
    """P1/P2 and P3 k1 at a row count that is not a multiple of a CTA's
    items, at 100,000 rows (more items than the resident grid's threads, so
    each thread walks several), with absent entries (zero rows), a tap with
    no live entry, 1, 3, 4, 8 and 9 taps (the last on the scalar path), the
    features at an unaligned offset or a ragged width (the scalar path), and
    512 f32 columns (128 pieces a row on the vector path)."""
    gen = torch.Generator(device=cuda).manual_seed(c)
    feats = torch.randn(1000, c, device=cuda, generator=gen).to(dtype)
    views = [feats] + ([_unaligned(feats)] if c != 37 else [])
    for n in (777, 100_000):
        idx = torch.randint(-1, 1000, (n,), device=cuda, generator=gen, dtype=torch.int32)
        for f in views:
            before = rg.GATHER_SUM.launches
            out = rg.row_gather(f, idx)
            assert rg.GATHER_SUM.launches == before + 1
            assert torch.equal(out, rg.row_gather_plain(f, idx))
    for taps, nb, block, wb in ((3, 7, 64, 128), (4, 1000, 100, 128), (8, 5, 61, 256),
                                (9, 3, 40, 128)):
        rb = torch.randint(-1, 1000, (taps, nb, block), device=cuda, generator=gen,
                           dtype=torch.int32)
        rb[1] = -1
        w0 = torch.randint(0, 1000 // wb, (taps, nb), device=cuda, generator=gen,
                           dtype=torch.int32)
        for f in views:
            before = rg.GATHER_SUM.launches
            out = rg.window_gather_sum(f, rb, w0, block, wb)
            assert rg.GATHER_SUM.launches == before + 1
            ref = rg.window_gather_sum_plain(f, rb, w0, block, wb)
            torch.cuda.synchronize()
            assert out.shape == (nb * block, c) and torch.equal(out, ref)
            assert ref.abs().max() > 0


@pytest.mark.parametrize("c", [32, 13, 2064])
def test_window_read_kernels_match_plain(cuda, c):
    """P3 k0 / P4 and P7 V5 with strided window tables (one repeated over the
    taps with stride 0, as P4's static and data-dependent tables are), an add
    table read through a strided view (P4 D), windows that start before the
    features' first row or run past their last (those rows read as zero), a
    block that is not a multiple of a CTA's rows, 3 and 11 taps (two rounds
    of table reads), x at an unaligned offset (the scalar path), and, at
    2064 columns, a CTA that splits the columns (the register route)."""
    gen = torch.Generator(device=cuda).manual_seed(c)
    rows_x, nb, block, wb = 700, 5, 48, 64
    x = torch.randn(rows_x, c, device=cuda, generator=gen).bfloat16()
    for taps in (3, 11):
        w0 = torch.randint(-1, rows_x // wb + 1, (taps, nb), device=cuda, generator=gen,
                           dtype=torch.int32)
        rb = torch.randint(-5, 5, (taps * nb * block,), device=cuda, generator=gen,
                           dtype=torch.int32)
        add = rb.view(taps, nb, block)[:, :, 0]
        repeated = w0[0].expand(taps, nb)
        static = (torch.arange(nb, device=cuda, dtype=torch.int32) % 8).expand(taps, nb)
        for xv in (x, _unaligned(x)):
            for table, extra in ((w0, None), (repeated, None), (static, None),
                                 (repeated, add), (w0, add)):
                before = pk.WINDOW_COPY_SUM.launches
                out = pk.window_copy_sum(xv, table, wb, block, extra)
                assert pk.WINDOW_COPY_SUM.launches == before + 1
                assert torch.equal(out, pk.window_copy_sum_plain(xv, table, wb, block, extra))
        out = pk.window_head_sum(x, repeated, wb, block)
        ref = pk.window_head_sum_plain(x, repeated, wb, block)
        torch.cuda.synchronize()
        assert out.shape == (nb * block, c) and torch.equal(out, ref)


@pytest.mark.parametrize("windows,rebase", [(2, False), (2, True), (1, False)],
                         ids=["V2", "V3", "V4"])
def test_windowed_slab_fwd_matches_plain(cuda, windows, rebase):
    """P7 V2-V4 at 3000 rows (not a multiple of the 64-row block, so a
    128-row CTA of K4's tile spans two output blocks and their windows),
    13 -> 19 channels (padded to 16 -> 24 for the tile), with a tap that
    has no live entry."""
    n, block, wb, k3 = 3000, 64, 256, 4
    rb = _monotone_rulebook(n, k3, 1, 40).to(cuda)
    rb[2] = -1
    geom = wg.prepare_geometry(rb, n, block, wb, 1)
    gen = torch.Generator(device=cuda).manual_seed(windows + rebase)
    f = wg.pad_features(torch.randn(n, 13, device=cuda, generator=gen),
                        wg.padded_rows(n, wb), torch.bfloat16)
    w = (torch.randn(k3, 13, 19, device=cuda, generator=gen) / 4).bfloat16()
    before = wg.WINDOWED_SLAB_FWD.launches
    out = wg.windowed_slab_fwd(f, geom, w, wb, 1, windows, rebase)
    assert wg.WINDOWED_SLAB_FWD.launches == before + 1
    ref = wg.windowed_slab_fwd_plain(f, geom, w, wb, 1, windows, rebase)
    torch.cuda.synchronize()
    assert out.shape == ref.shape == (geom.rbb.shape[1] * block, 19)
    assert _rel_err(out, ref) <= 1e-5


@pytest.fixture(scope="module")
def profile_variants():
    """``probe_windowed_torch.profile_variants`` on the card: P7 V2-V5 at the
    profile probe's shape (163,840 rows, 27 taps, 32 -> 32) and inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the probe kernels have no CPU mode")
    import probe_windowed_torch as pw

    return {v.name.split()[1]: v for v in pw.profile_variants(torch.device("cuda"))}


@pytest.mark.parametrize("label", ["V2", "V3", "V4"])
def test_profile_slab_fwd_matches_plain(cuda, profile_variants, label):
    """P7 V2-V4 on K4's slab tile at the profile probe's shape: one launch,
    within 1e-5 of max|ref| of the plain version, equal bits relaunched."""
    v = profile_variants[label]
    before = wg.WINDOWED_SLAB_FWD.launches
    out = v.run(False)
    assert wg.WINDOWED_SLAB_FWD.launches == before + 1
    ref = v.run(True)
    torch.cuda.synchronize()
    assert out.shape == ref.shape == (163_840, 32)
    assert _rel_err(out, ref) <= 1e-5 and bool(torch.isfinite(out).all())
    assert torch.equal(v.run(False), out)


def test_profile_window_head_sum_is_plain(cuda, profile_variants):
    """P7 V5 at the profile probe's shape: one launch, equal to the plain
    version bit for bit, and to itself relaunched."""
    v = profile_variants["V5"]
    before = pk.WINDOW_HEAD_SUM.launches
    out = v.run(False)
    assert pk.WINDOW_HEAD_SUM.launches == before + 1
    ref = v.run(True)
    torch.cuda.synchronize()
    assert out.shape == (163_840, 32) and torch.equal(out, ref)
    assert torch.equal(v.run(False), out)


def test_grouped_construct_kernels_match_plain(cuda):
    """P5 ka, kb, kc2, kd at a ragged width: 333 rows, pieces of 5 columns,
    a 45-deep product (not a multiple of the tile's 32)."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    rb = torch.randint(-1, 333, (16, 333), device=cuda, generator=gen, dtype=torch.int32)
    x = torch.randn(333, 35, device=cuda, generator=gen).bfloat16()
    g = torch.randn(333, 45, device=cuda, generator=gen).bfloat16()
    w = torch.randn(1, 45, 19, device=cuda, generator=gen).bfloat16()
    assert torch.equal(pk.slab_slots(rb), pk.slab_slots_plain(rb))
    assert torch.equal(pk.lane_concat(x, 5, 9), pk.lane_concat_plain(x, 5, 9))
    assert torch.equal(pk.sum_rows(rb, 9), pk.sum_rows_plain(rb, 9))
    out = pk.tile_matmul(g, w)
    torch.cuda.synchronize()
    assert out.shape == (333, 19) and _rel_err(out, pk.tile_matmul_plain(g, w)) <= 1e-5


SLOT_ENTRIES = [-2 ** 31, -9, -1, 0, 7, 8, 2 ** 31 - 1]


@pytest.mark.parametrize("shape,unaligned", [
    ((16, 512), False),  # the probe's: 4 CTAs of 128
    ((16, 1), False),
    ((16, 333), False),  # a ragged last CTA
    ((16, 100_000), False),
    ((1, 512), False),  # an rb of one row
    ((16, 512), True),  # rb at a 4-byte offset
], ids=["probe", "b1", "b333", "b100k", "one_row", "unaligned"])
def test_slab_slots_matches_plain(cuda, shape, unaligned):
    """P5 ka on entries over the whole int32 range, the edges included
    (``SLOT_ENTRIES``, at the start of the first row): one launch, equal
    to the plain version bit for bit, and to itself relaunched."""
    gen = torch.Generator(device=cuda).manual_seed(shape[0] + shape[1])
    rb = torch.randint(-2 ** 31, 2 ** 31 - 1, shape, device=cuda, generator=gen,
                       dtype=torch.int32)
    n = min(len(SLOT_ENTRIES), shape[1])
    rb[0, :n] = torch.tensor(SLOT_ENTRIES[:n], dtype=torch.int32)
    if unaligned:
        rb = _unaligned(rb)
    before = pk.SLAB_SLOTS.launches
    out = pk.slab_slots(rb)
    assert pk.SLAB_SLOTS.launches == before + 1
    ref = pk.slab_slots_plain(rb)
    torch.cuda.synchronize()
    assert out.shape == (shape[1], 8) and torch.equal(out, ref)
    assert torch.equal(pk.slab_slots(rb), out)


@pytest.mark.parametrize("rows,w_in,width,pieces,unaligned", [
    (512, 256, 32, 9, False),  # the probe's shape: block 0 written to pieces 0 and 8
    (333, 35, 5, 9, False),  # a width of 5: the scalar path
    (512, 256, 32, 9, True),  # x at a 2-byte offset: the scalar path
    (77, 64, 8, 1, False),  # fewer pieces than x's blocks
    (77, 64, 8, 17, False),
    (100_000, 64, 16, 9, False),
    (64, 4096, 512, 9, False),  # 512 pieces a row: two CTAs of columns
], ids=["probe", "width5", "unaligned", "pieces1", "pieces17", "rows100k", "w_in4096"])
def test_lane_concat_matches_plain(cuda, rows, w_in, width, pieces, unaligned):
    """P5 kb: one launch, equal to the plain version bit for bit, and to
    itself relaunched."""
    gen = torch.Generator(device=cuda).manual_seed(rows + w_in + pieces)
    x = torch.randn(rows, w_in, device=cuda, generator=gen).bfloat16()
    if unaligned:
        x = _unaligned(x)
    before = pk.LANE_CONCAT.launches
    out = pk.lane_concat(x, width, pieces)
    assert pk.LANE_CONCAT.launches == before + 1
    ref = pk.lane_concat_plain(x, width, pieces)
    torch.cuda.synchronize()
    assert out.shape == (rows, width * pieces) and torch.equal(out, ref)
    assert torch.equal(pk.lane_concat(x, width, pieces), out)


@pytest.mark.parametrize("shape,rows,unaligned", [
    ((16, 512), 0, False),
    ((16, 512), 1, False),
    ((16, 512), 9, False),  # the probe's
    ((16, 512), 16, False),  # one full round
    ((40, 1000), 33, False),  # two rounds of 16 and a tail
    ((16, 512), 9, True),  # rb at a 4-byte offset
    ((16, 1), 9, False),
], ids=["rows0", "rows1", "rows9", "rows16", "rows33", "unaligned", "b1"])
def test_sum_rows_matches_plain(cuda, shape, rows, unaligned):
    """P5 kc2 on int32 values up to 2^30 (each rounds to f32, and so do the
    sums, so the order of the adds shows): one launch, equal to the plain
    version bit for bit, and to itself relaunched."""
    gen = torch.Generator(device=cuda).manual_seed(shape[1] + rows)
    rb = torch.randint(-2 ** 30, 2 ** 30, shape, device=cuda, generator=gen,
                       dtype=torch.int32)
    if unaligned:
        rb = _unaligned(rb)
    before = pk.SUM_ROWS.launches
    out = pk.sum_rows(rb, rows)
    assert pk.SUM_ROWS.launches == before + 1
    ref = pk.sum_rows_plain(rb, rows)
    torch.cuda.synchronize()
    assert out.shape == (1, shape[1]) and torch.equal(out, ref)
    assert torch.equal(pk.sum_rows(rb, rows), out)


@pytest.mark.parametrize("m,k,n", [(512, 288, 32), (77, 288, 13), (1000, 40, 100)])
def test_tile_matmul_matches_plain(cuda, m, k, n):
    """P5 kd at the probe's (512, 288) x (288, 32), and at an M and an N
    that are not multiples of 16 and 8; one launch each, deterministic."""
    gen = torch.Generator(device=cuda).manual_seed(m)
    g = torch.randn(m, k, device=cuda, generator=gen).bfloat16()
    w = torch.randn(1, k, n, device=cuda, generator=gen).bfloat16()
    before = pk.TILE_MATMUL.launches
    out = pk.tile_matmul(g, w)
    assert pk.TILE_MATMUL.launches == before + 1
    torch.cuda.synchronize()
    assert out.shape == (m, n) and _rel_err(out, pk.tile_matmul_plain(g, w)) <= 1e-5
    assert torch.equal(pk.tile_matmul(g, w), out)


def test_probe_kernels_reject_bad_input(cuda):
    x = torch.randn(256, 8, device=cuda).bfloat16()
    w0 = torch.zeros(2, 3, dtype=torch.int32, device=cuda)
    rb = torch.zeros(2, 3 * 16, dtype=torch.int32, device=cuda)
    counts = [k.launches for k in rg.KERNELS + pk.KERNELS + wg.PROBE_KERNELS]
    with pytest.raises(TypeError):
        rg.row_gather(x.half(), rb[0])
    with pytest.raises(TypeError):
        rg.row_gather(x, rb[0].long())
    with pytest.raises(ValueError):
        rg.window_gather_sum(x, rb[:, :40], w0, 16, 64)
    with pytest.raises(ValueError):
        pk.window_copy_sum(x.t(), w0, 64, 16)
    with pytest.raises(TypeError):
        pk.window_copy_sum(x, w0.long(), 64, 16)
    with pytest.raises(TypeError):  # the probes' kernels read bf16 only
        pk.window_copy_sum(x.float(), w0, 64, 16)
    with pytest.raises(TypeError):
        pk.tile_matmul(x.float(), torch.randn(1, 8, 4, device=cuda))
    with pytest.raises(ValueError):
        pk.window_head_sum(x, w0[0], 64, 16)
    with pytest.raises(ValueError):
        pk.lane_concat(x, 3, 9)
    with pytest.raises(RuntimeError):  # no column to concatenate: the launcher refuses
        pk.lane_concat(x[:, :0], 3, 9)
    with pytest.raises(ValueError):
        pk.tile_matmul(x, torch.randn(1, 7, 4, device=cuda))
    with pytest.raises(ValueError):
        pk.sum_rows(rb, 9)
    with pytest.raises(ValueError):  # no first row to read
        pk.slab_slots(rb[:0])
    out = torch.empty(8 * 4 + 1, device=cuda)
    with pytest.raises(RuntimeError):  # an output not 16-byte aligned: the launcher refuses
        pk.SLAB_SLOTS.launch(None, rb.device, rb.data_ptr(), out.data_ptr() + 4, 4)
    with pytest.raises(ValueError):
        wg.windowed_slab_fwd(x, wg.prepare_geometry(rb, 48, 16, 64, 1),
                             torch.randn(2, 8, 4, device=cuda), 60, 1)
    assert [k.launches for k in rg.KERNELS + pk.KERNELS + wg.PROBE_KERNELS] == counts


def test_probe_entry_points_on_cuda(cuda):
    """Every probe entry point's variants at the probes' shapes: one launch
    of its own kernel each, agreeing with the plain version."""
    import probe_bisect_torch
    import probe_gather_torch
    import probe_windowed_torch

    kernels = bc.KERNELS + wg.KERNELS + wg.PROBE_KERNELS + rg.KERNELS + pk.KERNELS
    for v in (probe_gather_torch.variants(cuda) + probe_bisect_torch.variants(cuda)
              + probe_windowed_torch.profile_variants(cuda)):
        before = [k.launches for k in kernels]
        out = v.run(False)
        torch.cuda.synchronize()
        assert [k.launches - b for k, b in zip(kernels, before)] == [
            int(k is v.kernel) for k in kernels], v.name
        assert probe_windowed_torch.agree(out, v.run(True), v.tol)[0], v.name


# ------------------------------------------------------------- pointops, VolSDF


def _room(n, seed):
    """``n`` points of a 8 x 6 x 3 m room centred on the origin, as a
    CenterShift-ed ScanNet scene's coordinates lie."""
    rng = np.random.RandomState(seed)
    return ((rng.rand(n, 3) - [0.5, 0.5, 0.0]) * [8.0, 6.0, 3.0]).astype(np.float32)


def test_knn_and_ball_query_match_float64_on_cuda(cuda):
    """``knn_query`` (k 1 and 8, in the expanded and the direct form) and
    ``ball_query`` on CUDA tensors against a float64 search on the CPU
    (``scipy.spatial.cKDTree``): indices equal wherever the squared
    distances around a rank differ by more than 16 f32 ulps of |q|^2 +
    max|r|^2 (the rounding of the expanded form, more than the direct
    form's), the distances within that tolerance."""
    from scipy.spatial import cKDTree

    from ponderv2_tpu_torch.ops import pointops as po

    ref, q = _room(20_000, 0), _room(30_000, 1)
    rb = torch.zeros(len(ref), dtype=torch.int32, device=cuda)
    qb = torch.zeros(len(q), dtype=torch.int32, device=cuda)
    ref64, q64 = ref.astype(np.float64), q.astype(np.float64)
    tree = cKDTree(ref64)
    dist, hidx = tree.query(q64, k=9)
    d2 = dist ** 2
    tol = 16 * 2.0 ** -24 * ((q64 ** 2).sum(1) + (ref64 ** 2).sum(1).max())
    for k, direct in ((1, False), (8, False), (1, True), (8, True)):
        idx, sq = po.knn_query(k, torch.from_numpy(ref).to(cuda), rb,
                               torch.from_numpy(q).to(cuda), qb, direct=direct)
        idx, sq = idx.cpu().numpy(), sq.cpu().numpy().astype(np.float64)
        gaps = np.diff(d2, axis=1)
        tie = np.concatenate([np.zeros((len(q), 1), bool), gaps[:, :k - 1] <= tol[:, None]], 1)
        tie |= gaps[:, :k] <= tol[:, None]
        assert not ((idx != hidx[:, :k]) & ~tie).any()
        assert (np.abs(sq - d2[:, :k]) <= tol[:, None]).all()
    radius, nsample = 0.2, 8
    idx, _ = po.ball_query(radius, nsample, torch.from_numpy(ref).to(cuda), rb,
                           torch.from_numpy(q).to(cuda), qb)
    idx = idx.cpu().numpy()
    checked = 0
    for i, cand in enumerate(tree.query_ball_point(q64[:3000], radius * 1.001)):
        cand = np.sort(np.asarray(cand, np.int64))
        dc = ((ref64[cand] - q64[i]) ** 2).sum(1)
        if (np.abs(dc - radius ** 2) <= tol[i]).any():
            continue  # a ref on the sphere, within rounding
        hits = cand[dc <= radius ** 2][:nsample]
        first = hits[0] if len(hits) else 0
        np.testing.assert_array_equal(
            idx[i], np.concatenate([hits, np.full(nsample - len(hits), first)]))
        checked += 1
    assert checked > 2900


def test_volsdf_render_forward_and_backward_on_cuda(cuda):
    """A training render of ``VolSDFModel`` (``ErrorBoundedSampler``) on the
    card and its backward: finite, the same bits twice (every sum in a
    fixed order), and, on the samples it drew, the field and compositing of
    the same model on the CPU within 1e-4 of max|ref| (outputs) and 1e-3 of
    max|ref| (grads: second order through the field's spatial gradient).
    The depth divides by the accumulated weight, which a random field
    leaves near 0 on some rays: it is compared where the accumulation is
    0.1 or more, and the loss leaves it out."""
    from ponderv2_tpu_torch.models.ponder.render.surface_models import RENDERERS

    cfg = dict(type="VolSDFModel", feature_dim=6,
               field=dict(hidden_dim=16, num_layers=2, geo_feat_dim=4, semantic_dim=8,
                          share_volume=False),
               collider=dict(type="AABBBoxCollider", near_plane=0.01),
               sampler=dict(type="ErrorBoundedSampler", num_samples=16, num_samples_eval=32,
                            num_samples_extra=8),
               loss=dict(weights=dict(rgb=10.0, depth=0.0, eikonal=0.01, sdf=10.0)))
    model = RENDERERS.build(dict(cfg))
    model.reset_parameters(torch.Generator().manual_seed(0))
    rng = np.random.RandomState(0)
    vol = torch.from_numpy(rng.randn(2, 6, 8, 8, 6).astype(np.float32))
    o = torch.from_numpy(rng.rand(2, 64, 3).astype(np.float32) * 0.3 + 0.1)
    d = torch.nn.functional.normalize(torch.from_numpy(rng.randn(2, 64, 3).astype(np.float32)),
                                      dim=-1)
    targets = dict(rgb=torch.rand(2, 64, 3), depth=torch.rand(2, 64) + 0.1)
    gen = torch.Generator(device=cuda).manual_seed(1)
    draws = [torch.rand(s, generator=gen, device=cuda) for s in model.draw_shapes((2, 64))]

    def run(m, device, draws, samples=None):
        m.zero_grad(set_to_none=True)
        v = vol.to(device).requires_grad_()
        if samples is not None:
            m.sampler = lambda *a, **k: samples
        out = m(m.field.volume_channels_last(v), o.to(device), d.to(device), draws=draws)
        loss = m.get_loss(out, {k: x.to(device) for k, x in targets.items()})["render_loss"]
        loss.backward()
        grads = {n: p.grad for n, p in m.named_parameters() if p.grad is not None}
        return out, grads, v.grad

    gpu = RENDERERS.build(dict(cfg)).to(cuda)
    gpu.load_state_dict(model.state_dict())
    first = run(gpu, cuda, draws)
    second = run(gpu, cuda, draws)
    for k, x in first[0].items():
        assert torch.isfinite(x).all() and torch.equal(x, second[0][k]), k
    for n, g in first[1].items():
        assert torch.isfinite(g).all() and torch.equal(g, second[1][n]), n
    assert torch.equal(first[2], second[2])
    samples = gpu._samples(gpu.field.volume_channels_last(vol.to(cuda)), o.to(cuda),
                           d.to(cuda), draws)
    cpu = run(model, "cpu", None, tuple(s.cpu() for s in samples))
    for k in ("weights", "sdf", "gradients", "accumulation", "rgb"):
        assert _rel_err(first[0][k].cpu(), cpu[0][k]) <= 1e-4, k
    well = cpu[0]["accumulation"] >= 0.1
    assert well.sum() >= 16
    assert _rel_err(first[0]["depth"].cpu()[well], cpu[0]["depth"][well]) <= 1e-4
    for n, g in cpu[1].items():
        assert (first[1][n].cpu() - g).abs().max() <= 1e-3 * g.abs().max().clamp(min=1e-12), n
    assert _rel_err(first[2].cpu(), cpu[2]) <= 1e-3
