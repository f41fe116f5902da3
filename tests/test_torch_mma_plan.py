"""The launch plans of the tensor-core gather-GEMM kernels (K2,
``band_dxdw_core``; P5 ``kd``, ``tile_matmul``) and the arithmetic of K2's
f32 route, on the CPU.

The kernels themselves run only on a GPU (``tests/test_torch_cuda.py``).
What the wrappers decide in Python is checked here: tile widths, padded
widths, CTA ranges, row chunks and scratch of the dW reduction. The f32
route multiplies as 3xTF32 (``csrc/mma_tile.cuh``); a numpy emulation of
that split shows it holds the f32 bound of the GPU tests (1e-5 of max|ref|)
over the reduction lengths of the fine-tune step's L0 convs, where one TF32
pass would not.
"""

import numpy as np
import pytest
import torch

from ponderv2_tpu_torch.ops import band_conv as bc
from ponderv2_tpu_torch.ops import probe_kernels as pk

# (cin, cout) of every band conv the fine-tune and pretrain steps route to K2
ROUTED = [(32, 32), (64, 64), (96, 96), (128, 96), (128, 128), (192, 128)]
FINE_TUNE_L0_ROWS = 1_572_864
PRETRAIN_L0_ROWS = 204_800


@pytest.mark.parametrize("cin,cout", ROUTED)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dxdw_plan_routed_widths(cin, cout, dtype):
    for n in (FINE_TUNE_L0_ROWS, PRETRAIN_L0_ROWS, 3007):
        p = bc.dxdw_plan(n, cin, cout, 27, dtype)
        # the tiles cover each width with no padding column
        assert cin % p.ci_tile == 0 and cout % p.co_tile == 0
        assert p.ci_tile in bc.TILE_WIDTHS and p.co_tile in bc.TILE_WIDTHS
        assert p.ci_tile <= (128 if dtype == torch.bfloat16 else 96)
        assert (p.cin_p, p.cout_p) == (cin, cout)  # whole 16-byte copies
        # CTA ranges: dW partials (chunk, tap, channel tile), then dx tiles
        tiles = (cin // p.ci_tile) * (cout // p.co_tile)
        assert p.ndw == p.nchunks * 27 * tiles
        assert p.ndx == -(-n // bc.DX_ROWS) * (cin // p.ci_tile)
        # the chunks cover the rows, each a whole number of 16-row slabs
        assert p.chunk % 16 == 0 and (p.nchunks - 1) * p.chunk < n <= p.nchunks * p.chunk
        assert p.scratch_bytes == p.nchunks * 27 * cin * cout * 4 <= bc.DXDW_SCRATCH_BYTES


@pytest.mark.parametrize("cin", [32, 64, 96, 128])
def test_tile_width_no_padding(cin):
    for dtype in (torch.float32, torch.bfloat16):
        w = bc.tile_width(cin, dtype)
        assert cin % w == 0
    assert bc.tile_width(cin, torch.bfloat16) == cin
    assert bc.tile_width(cin, torch.float32) == (64 if cin == 128 else cin)


@pytest.mark.parametrize("c,dtype,width,padded", [
    (5, torch.float32, 32, 8), (7, torch.bfloat16, 32, 8), (24, torch.float32, 32, 24),
    (40, torch.bfloat16, 64, 40), (70, torch.float32, 96, 72), (130, torch.bfloat16, 32, 136),
    (192, torch.float32, 96, 192)])
def test_tile_width_ragged(c, dtype, width, padded):
    assert bc.tile_width(c, dtype) == width
    assert bc.padded_width(c, dtype) == padded


def test_dxdw_plan_fills_the_card():
    """At least one CTA per SM of an H100 (132) in each range at the
    fine-tune step's L0, and the pretrain step's; scratch within its cap."""
    for n in (FINE_TUNE_L0_ROWS, PRETRAIN_L0_ROWS):
        for cin, cout in ((96, 96), (128, 96)):
            for dtype in (torch.float32, torch.bfloat16):
                p = bc.dxdw_plan(n, cin, cout, 27, dtype)
                assert p.ndw >= 132 and p.ndx >= 132
    p = bc.dxdw_plan(FINE_TUNE_L0_ROWS, 96, 96, 27, torch.float32)
    assert p.nchunks * p.chunk >= FINE_TUNE_L0_ROWS and p.scratch_bytes <= 128 * 2 ** 20


def test_operand_padding():
    """The wrappers' padded copy: zero columns past the width, values kept."""
    x = torch.arange(15, dtype=torch.float32).reshape(3, 5)
    y = bc._operand(x, 8)
    assert y.shape == (3, 8) and torch.equal(y[:, :5], x) and not y[:, 5:].any()
    assert bc._operand(y, 8) is y


@pytest.mark.parametrize("m,n,ctas", [(512, 32, 32), (333, 19, 21), (16, 33, 2)])
def test_tile_matmul_ctas(m, n, ctas):
    assert pk.tile_matmul_ctas(m, n) == ctas
    assert pk.tile_matmul_ctas(512, 32) >= 16


def _tf32(x: np.ndarray) -> np.ndarray:
    """Round f32 to TF32 (10 mantissa bits), to nearest, ties away from zero
    (``cvt.rna.tf32.f32``)."""
    bits = x.astype(np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _emulate(a: np.ndarray, b: np.ndarray, passes: int, stage: int = 32) -> np.ndarray:
    """a @ b as the f32 tile computes it: per stage of ``stage`` products,
    the TF32 parts' products summed exactly (hi.hi + hi.lo + lo.hi for 3
    passes, hi.hi for 1), rounded to f32 and added in f32."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    out = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k in range(0, a.shape[1], stage):
        s = slice(k, k + stage)
        part = ah[:, s].astype(np.float64) @ bh[s].astype(np.float64)
        if passes == 3:
            part += (ah[:, s].astype(np.float64) @ bl[s].astype(np.float64)
                     + al[:, s].astype(np.float64) @ bh[s].astype(np.float64))
        out += part.astype(np.float32)
    return out


@pytest.mark.parametrize("k", [27 * 96, 27 * 128, 20_704])
def test_3xtf32_holds_the_f32_bound(k):
    """Over L0's reduction lengths (dx: 27 taps x 96 or 128 channels; dW:
    a 20,704-row chunk of the fine-tune L0 plan), 3xTF32 stays within 1e-5
    of max|ref| of the float64 product; one TF32 pass does not."""
    rng = np.random.RandomState(k)
    a = rng.randn(16, k).astype(np.float32)
    b = rng.randn(k, 16).astype(np.float32)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    scale = np.abs(ref).max()
    err3 = np.abs(_emulate(a, b, 3) - ref).max() / scale
    err1 = np.abs(_emulate(a, b, 1) - ref).max() / scale
    assert err3 <= 1e-5
    assert err1 > 1e-5
