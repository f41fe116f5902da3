"""K1 (the CUDA band conv kernel) against its plain PyTorch version, on a GPU.

Marked ``requires_cuda``: each test skips where there is no CUDA device (the
kernel has no CPU or interpret mode). The file imports no JAX, so it also
runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

The f32 comparisons run with TF32 off; the kernel and the plain version sum
the same f32 products in another order, hence the 1e-5 relative bound. bf16
inputs accumulate in f32 in the kernel while the plain version rounds each
tap's product to bf16: 3e-2 of max|ref| (the bound bench.py:227 uses).
"""

import numpy as np
import pytest
import torch

from ponderv2_tpu_torch.models import build_model
from ponderv2_tpu_torch.ops import band_conv as bc
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
    gated = bc.build_band_plan(rb, 3, block=32, window=8, pair_budget=0)
    assert not bool(gated.ok)
    assert bc.band_subm_conv((3, 32, 8), f, gated, w, mask).abs().sum().item() == 0.0


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
    with pytest.raises(NotImplementedError):  # no backward kernel yet
        bc.band_fwd_core(f.requires_grad_(), *args, w, 3, bc.BLOCK, bc.WINDOW)
    f = f.detach()
    with pytest.raises(TypeError):
        bc.band_fwd_core(f.half(), *args, w.half(), 3, bc.BLOCK, bc.WINDOW)
    with pytest.raises(ValueError):
        bc.band_fwd_core(f.t().contiguous().t(), *args, w, 3, bc.BLOCK, bc.WINDOW)
    with pytest.raises(ValueError):
        bc.band_fwd_core(f, *args, w[:, :8], 3, bc.BLOCK, bc.WINDOW)
    assert bc.BAND_FWD.launches == before + 1


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
