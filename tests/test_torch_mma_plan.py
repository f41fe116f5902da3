"""The launch plans of the tensor-core gather-GEMM kernels (K1,
``band_fwd_core``; K2, ``band_dxdw_core``; K3, ``band_dw_core``; K4/K5,
``windowed_conv_fwd``/``windowed_conv_dw``; P5 ``kd``, ``tile_matmul``),
the arithmetic of their f32 route, and the fixed-order sums of the
reproducible steps, on the CPU.

The kernels themselves run only on a GPU (``tests/test_torch_cuda.py``).
What the wrappers decide in Python is checked here: tile widths, padded
widths, CTA ranges, row chunks and scratch of the dW reduction, dynamic
shared memory. The f32 route multiplies as 3xTF32 (``csrc/mma_tile.cuh``); a
numpy emulation of that split shows it holds the f32 bound of the GPU tests
(1e-5 of max|ref|) over the reduction lengths of the fine-tune step's L0
convs, where one TF32 pass would not, and emulations of K1's compacted
tile and of K5's swapped dW tile (their summation orders) hold the same
bound against the plain versions (K5's also against the JAX kernel).
"""

import os
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ponderv2_tpu.ops import pallas_gather as jpg
from ponderv2_tpu_torch.ops import band_conv as bc
from ponderv2_tpu_torch.ops import probe_kernels as pk
from ponderv2_tpu_torch.ops import windowed_gather as wg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools", "experiments"))
import probe_windowed_torch as probe  # noqa: E402

# (cin, cout) of every band conv the fine-tune and pretrain steps route to K2
ROUTED = [(32, 32), (64, 64), (96, 96), (128, 96), (128, 128), (192, 128)]
# the split convs (K1 on the cotangent + K3), and every (cin, cout) K1 runs:
# each band conv's forward and the split convs' dx (cout -> cin)
SPLIT = [(256, 256), (384, 256)]
K1_ROUTED = ROUTED + SPLIT + [(256, 384)]
SMEM_LIMIT = 232_448  # bytes of shared memory one CTA may use on an H100
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


@pytest.mark.parametrize("cin,cout", K1_ROUTED)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fwd_plan_routed_widths(cin, cout, dtype):
    for n in (FINE_TUNE_L0_ROWS, PRETRAIN_L0_ROWS, 3007):
        p = bc.fwd_plan(n, cin, cout, 27, dtype)
        assert cout % p.co_tile == 0 and p.co_tile in bc.TILE_WIDTHS  # no padding column
        assert p.co_tile <= (128 if dtype == torch.bfloat16 else 96)
        assert (p.cin_p, p.cout_p) == (cin, cout)
        assert p.compact == (dtype == torch.float32)
        rows = bc.K1_TILE[0] if p.compact else bc.DX_ROWS
        assert p.ctas == -(-n // rows) * (cout // p.co_tile)
        assert p.smem_bytes <= SMEM_LIMIT
    # the compacted tile at 96 columns: 256 rows, 16-deep stages, 3 in flight
    assert bc.fwd_plan(10, 96, 96, 27, torch.float32).smem_bytes == (
        3 * (256 * 20 + 16 * 104) * 4 + 256 * 104 * 4 + 27 * 256 * 5 + 65 * 4)
    # the slab tile (K2's dx tile): three CTAs fit on an SM
    assert bc.fwd_plan(10, 96, 96, 27, torch.bfloat16).smem_bytes <= SMEM_LIMIT // 3


@pytest.mark.parametrize("cin,cout", SPLIT)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dw_plan_split_widths(cin, cout, dtype):
    """K3's tiles at the split convs: 64 / 96 x 64 in f32, 128 x 128 in bf16,
    no padding column; chunks, CTAs, scratch and shared memory."""
    for n in (FINE_TUNE_L0_ROWS, PRETRAIN_L0_ROWS, 40_000, 3007):
        p = bc.dw_plan(n, cin, cout, 27, dtype)
        want = ((96 if cin == 384 else 64), 64) if dtype == torch.float32 else (128, 128)
        assert (p.ci_tile, p.co_tile) == want and (p.ci_tile, p.co_tile) in bc.K3_TILES[dtype]
        assert cin % p.ci_tile == 0 and cout % p.co_tile == 0
        assert p.ctas == p.nchunks * 27 * (cin // p.ci_tile) * (cout // p.co_tile)
        assert p.chunk % 16 == 0 and (p.nchunks - 1) * p.chunk < n <= p.nchunks * p.chunk
        assert p.scratch_bytes == p.nchunks * 27 * cin * cout * 4 <= bc.DXDW_SCRATCH_BYTES
        assert p.smem_bytes <= SMEM_LIMIT // 2  # two CTAs per SM
    # the same chunking as K2's dW range over the same tiles
    p2 = bc.dxdw_plan(40_000, 128, 128, 27, torch.bfloat16)
    p3 = bc.dw_plan(40_000, 128, 128, 27, torch.bfloat16)
    assert (p3.chunk, p3.nchunks, p3.ctas) == (p2.chunk, p2.nchunks, p2.ndw)


def test_dw_plan_other_widths_take_a_split_tile():
    for cin, cout, dtype, tile in [(5, 7, torch.float32, (64, 64)),
                                   (96, 96, torch.float32, (96, 64)),
                                   (130, 70, torch.bfloat16, (128, 128))]:
        p = bc.dw_plan(3007, cin, cout, 27, dtype)
        assert (p.ci_tile, p.co_tile) == tile
        assert (p.cin_p, p.cout_p) == (bc.padded_width(cin, dtype), bc.padded_width(cout, dtype))


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


def _emulate_k1(f, rbt, w0, w, n, kz, block, window):
    """K1's compacted tile (``csrc/mma_tile.cuh:compact_gather_gemm``) in
    numpy, f32: per tile of ``K1_TILE`` rows and tap in order, the live
    entries in row order; per stage (``K1_TILE``'s depth), their TF32 parts' products
    (hi.hi + hi.lo + lo.hi) summed exactly, rounded to f32 and added into
    the f32 output rows. Returns (out, rows multiplied: the live entries of
    each (tile, tap) rounded up to whole 16-row slabs)."""
    k3 = rbt.shape[1]
    j = rbt[:n].astype(np.int64)
    pos = j - w0[np.arange(k3)[None, :] // kz, (np.arange(n) // block)[:, None]]
    live = (j >= 0) & (pos >= 0) & (pos < window)
    fh = _tf32(f)
    fl = _tf32(f - fh)
    wh = _tf32(w)
    wl = _tf32(w - wh)
    fh, fl, wh, wl = (x.astype(np.float64) for x in (fh, fl, wh, wl))
    out = np.zeros((n, w.shape[2]), np.float32)
    multiplied = 0
    rows, kc, _ = bc.K1_TILE
    for r0 in range(0, n, rows):
        for t in range(k3):
            li = r0 + np.nonzero(live[r0:r0 + rows, t])[0]
            multiplied += -(-len(li) // 16) * 16
            jj = j[li, t]
            for k0 in range(0, f.shape[1], kc):
                s = slice(k0, k0 + kc)
                part = fh[jj, s] @ wh[t, s] + fh[jj, s] @ wl[t, s] + fl[jj, s] @ wh[t, s]
                out[li] += part.astype(np.float32)
    return out, multiplied


def test_compacted_k1_order_holds_the_f32_bound():
    """K1's summation order (per-tap compaction in row order, taps in order,
    KC-deep stages, the 3xTF32 split) against ``band_fwd_core_plain`` at 1e-5
    of max|ref|, on a plan with window overflow, a dead tap, a dead 128-row
    tile and a ragged last tile; and the rows it multiplies, as
    ``chip_smoke.py`` counts them from the plan."""
    import chip_smoke
    from ponderv2_tpu_torch.ops.spconv import build_subm_rulebook

    rng = np.random.RandomState(4)
    shape = (24, 24, 24)
    coords = np.unique(np.stack([rng.randint(0, 2, 3000)] + [rng.randint(0, s, 3000)
                                                             for s in shape], 1), axis=0)
    coords = coords.astype(np.int32)
    n = len(coords)
    assert n % bc.K1_TILE[0]
    rb = build_subm_rulebook(torch.from_numpy(coords), shape, 2, 3)
    plan = bc.build_band_plan(rb, 3, block=32, window=8)
    rbt = plan.rbt.clone()
    rbt[:, 5] = -1
    rbt[128:256] = -1
    plan = plan._replace(rbt=rbt)
    f = rng.randn(n, 40).astype(np.float32)
    w = (rng.randn(27, 40, 24) / 6).astype(np.float32)
    out, multiplied = _emulate_k1(f, rbt.numpy(), plan.w0.numpy(), w, n, 3, 32, 8)
    ref = bc.band_fwd_core_plain(torch.from_numpy(f), rbt, plan.w0, torch.from_numpy(w), 3,
                                 32, 8).numpy()
    assert np.abs(out - ref).max() <= 1e-5 * np.abs(ref).max()
    assert not out[128:256].any()
    live, k1_rows, k2_rows = chip_smoke.band_rows_multiplied(plan, n, 3, 32, 8)
    assert k1_rows == multiplied and live <= k1_rows < live + 16 * 27 * -(-n // 256)
    assert k2_rows >= k1_rows


# ------------------------------------------------------------------ K4, K5
# chip_smoke.py phase 12's six windowed convs: (taps, cin, cout, output
# rows): the probe's three shapes and its profile kernel's (N = 163,840),
# then the pretrain batch's k5 stem and L0 k3 rulebooks (204,800 rows)
PHASE12 = {
    "probe k3=27 32->32": (27, 32, 32, 163_840),
    "probe k3=27 96->96": (27, 96, 96, 163_840),
    "probe k3=125 8->32": (125, 8, 32, 163_840),
    "profile k3=27 32->32": (27, 32, 32, 163_840),
    "pretrain stem k5 6->32": (125, 6, 32, 204_800),
    "pretrain L0 k3 32->32": (27, 32, 32, 204_800),
}


@pytest.mark.parametrize("label", list(PHASE12))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_windowed_plans_at_phase12_convs(label, dtype):
    """K4's and K5's launch plans at the six convs: tiles, padded widths,
    CTAs, row chunks, scratch and shared memory within an H100's 232,448
    bytes (K4's tile walks 125 taps in groups of 32)."""
    k3, cin, cout, n = PHASE12[label]
    f = wg.windowed_fwd_plan(n, cin, cout, k3, dtype)
    assert f.co_tile == cout == f.cout_p  # 32 or 96: no padding column
    assert f.cin_p == (8 if cin < 8 else cin)  # whole 16-byte copies
    assert 512 % bc.DX_ROWS == 0  # a CTA lies in one 512-row output block
    assert f.ctas == n // bc.DX_ROWS * (cout // f.co_tile)
    assert f.smem_bytes <= SMEM_LIMIT
    d = wg.windowed_dw_plan(n, cin, cout, k3, dtype)
    # dW^T tiles: the cotangent's columns by the gathered features' (>= 32)
    assert d.co_tile == cout and d.ci_tile == max(cin, 32)
    assert (d.cin_p, d.cout_p) == (f.cin_p, f.cout_p)
    assert d.ctas == d.nchunks * k3 >= 132  # one tile; at least one CTA per SM
    assert d.chunk % 16 == 0 and (d.nchunks - 1) * d.chunk < n <= d.nchunks * d.chunk
    assert d.scratch_bytes == d.nchunks * k3 * cin * cout * 4 <= bc.DXDW_SCRATCH_BYTES
    assert d.smem_bytes <= SMEM_LIMIT // 2  # two CTAs per SM


def test_windowed_plan_shared_memory():
    """The plans' shared memory as the tiles lay it out: K4's slab tile
    (128 rows, 32-deep stages, 3 in flight, the entry table of one group of
    32 taps) at 125 and 9 taps; K5's dW tile (32 entries a stage); K4's and
    K5's tiles stop at 96 columns in both dtypes (stage sums)."""
    assert wg.windowed_fwd_plan(512, 8, 32, 125, torch.bfloat16).smem_bytes == (
        3 * (128 * 40 + 32 * 40) * 2 + 32 * 128 * 4 + 41 * 4)
    assert wg.windowed_fwd_plan(512, 8, 32, 125, torch.float32).smem_bytes == (
        3 * (128 * 36 + 32 * 40) * 4 + 32 * 128 * 4 + 41 * 4)
    assert wg.windowed_fwd_plan(512, 8, 32, 9, torch.float32).smem_bytes == (
        3 * (128 * 36 + 32 * 40) * 4 + 9 * 128 * 4 + 41 * 4)
    for dtype in (torch.float32, torch.bfloat16):
        assert wg.windowed_fwd_plan(512, 8, 128, 27, dtype).co_tile == 64
        d = wg.windowed_dw_plan(4096, 128, 192, 27, dtype)
        assert (d.co_tile, d.ci_tile) == (96, 64)
    assert wg.windowed_dw_plan(4096, 6, 96, 27, torch.float32).smem_bytes == (
        3 * 32 * (96 + 8 + 32 + 8) * 4 + (2 * 1024 + 32) * 4)
    # K1's plans are unchanged by the tap groups (27 taps fit one group)
    assert bc.fwd_plan(10, 96, 96, 27, torch.bfloat16).smem_bytes == (
        3 * (128 * 40 + 32 * 104) * 2 + 27 * 128 * 4 + 41 * 4)


def _windowed_case(rng, n, k3, group, block, wb, cin, cout):
    """A monotone rulebook (probe_windowed_torch.make_monotone_rulebook,
    spread 40), its geometry, f32 features padded to whole windows and a
    cotangent over the output rows, with tap 3 dead."""
    rb = probe.make_monotone_rulebook(n, k3, rng, group=group)
    rb = np.clip(rb, -1, n - 1)
    rb[3] = -1
    geom = wg.prepare_geometry(torch.from_numpy(rb), n, block, wb, group)
    x = rng.randn(n, cin).astype(np.float32)
    f = wg.pad_features(torch.from_numpy(x), wg.padded_rows(n, wb), torch.float32)
    g = rng.randn(geom.rbb.shape[1] * block, cout).astype(np.float32)
    return rb, geom, x, f, g


def _emulate_k5(f, g, geom, wb, group, chunk, nchunks):
    """K5 in numpy, f32, in the kernel's order: per (row chunk, tap), the
    live entries of each 1024-row window from the chunk's start in row
    order, 32 a stage; a stage's TF32 parts' products of dW[t]^T = g^T x
    (hi.hi + hi.lo + lo.hi) summed exactly, rounded to f32 and added into
    the chunk's f32 partial; then the partials added in chunk order from
    zero and transposed. Returns (dW (k3, cin, cout), rows multiplied at
    f32's mma depth of 8)."""
    k3, nb, _, block = geom.rbb.shape
    rb = geom.rbb.reshape(k3, -1).numpy().astype(np.int64)
    nrows = rb.shape[1]
    lo = np.repeat(geom.w0.numpy().astype(np.int64) * wb, group, 0)[:, np.arange(nrows) // block]
    live = (rb >= lo) & (rb < lo + 2 * wb)
    gh = _tf32(g)
    gl = _tf32(g - gh)
    xh = _tf32(f)
    xl = _tf32(f - xh)
    gh, gl, xh, xl = (v.astype(np.float64) for v in (gh, gl, xh, xl))
    partial = np.zeros((nchunks, k3, g.shape[1], f.shape[1]), np.float32)
    multiplied = 0
    for s in range(nchunks):
        end = min(nrows, (s + 1) * chunk)
        for t in range(k3):
            acc = np.zeros(partial.shape[2:], np.float32)
            for w0 in range(s * chunk, end, 1024):
                ii = w0 + np.nonzero(live[t, w0:min(w0 + 1024, end)])[0]
                multiplied += -(-len(ii) // 8) * 8
                for k in range(0, len(ii), 32):
                    i = ii[k:k + 32]
                    j = rb[t, i]
                    part = gh[i].T @ xh[j] + gh[i].T @ xl[j] + gl[i].T @ xh[j]
                    acc += part.astype(np.float32)
            partial[s, t] = acc
    dw = np.zeros((k3, f.shape[1], g.shape[1]), np.float32)
    for s in range(nchunks):
        dw += partial[s].transpose(0, 2, 1)
    return dw, multiplied


@pytest.mark.parametrize("wb", [256, 32], ids=["covered", "uncovered"])
def test_k5_swapped_order_holds_the_f32_bound(wb):
    """K5's summation order (dw_gather_gemm with the cotangent read by row
    and the features gathered: per chunk and tap, each window's live
    entries compacted in row order, 32-entry stages, the 3xTF32 split, the
    chunk partials summed in order and transposed) against
    ``windowed_conv_dw_plain`` at 1e-5 of max|ref| in f32, at the plan's
    chunks and at 2048-row chunks (two windows a chunk), with windows that
    drop entries and a dead tap; against the JAX kernel
    (``pallas_gather.windowed_conv_dw``, interpret mode) too; and the rows
    it multiplies, as ``chip_smoke.py`` counts them from the geometry."""
    rng = np.random.RandomState(wb)
    n, k3, group, block, cin, cout = 2600, 27, 9, 64, 6, 40
    rb, geom, x, f, g = _windowed_case(rng, n, k3, group, block, wb, cin, cout)
    assert bool(geom.covered) == (wb == 256)
    ref = wg.windowed_conv_dw_plain(f, geom, torch.from_numpy(g), wb, group).numpy()
    plan = wg.windowed_dw_plan(geom.rbb.shape[1] * block, cin, cout, k3, torch.float32)
    assert plan.nchunks >= 2
    scale = np.abs(ref).max()
    for chunk in (plan.chunk, 2048):
        nchunks = -(-g.shape[0] // chunk)
        out, multiplied = _emulate_k5(f.numpy(), g, geom, wb, group, chunk, nchunks)
        assert np.abs(out - ref).max() <= 1e-5 * scale, chunk
        assert not out[3].any()
        if chunk == plan.chunk:
            assert multiplied == probe.k5_rows_multiplied(geom, wb, plan, torch.float32)
    jgeom = jpg.prepare_geometry(jnp.asarray(rb), n, block, wb, group)
    jf8 = jpg.pad_features(jnp.asarray(x), wg.padded_rows(n, wb), jnp.float32)
    jdw = np.asarray(jpg.windowed_conv_dw(jf8, jgeom, jnp.asarray(g), wb, group))
    out, _ = _emulate_k5(f.numpy(), g, geom, wb, group, plan.chunk, plan.nchunks)
    assert np.abs(out - jdw).max() <= 1e-5 * np.abs(jdw).max()


def test_k4_rows_multiplied_counts_the_tiles():
    """``probe_windowed_torch.k4_rows_multiplied`` against a count by row
    blocks: the slab tile's 16-row slabs with a live entry per tap."""
    rng = np.random.RandomState(5)
    _, geom, _, _, _ = _windowed_case(rng, 3000, 27, 9, 512, 256, 8, 8)
    k3 = geom.rbb.shape[0]
    live = probe._live(geom, 256, 2)[2].reshape(k3, -1).numpy()
    slabs = sum(16 * int(live[t, r:r + 16].any()) for t in range(k3)
                for r in range(0, live.shape[1], 16))
    assert probe.k4_rows_multiplied(geom, 256) == slabs
    assert live.sum() <= slabs <= 16 * live.sum()


# ------------------------------------------------------------------ P7 V2-V4
# The profile probe's slab-head forward runs K4's kernel, tile and plan
# over the slab heads (csrc/windowed_gather.cu: SlabRows).


@pytest.mark.parametrize("cin,cout", [(13, 19), (32, 32)])
def test_slab_fwd_launches_k4s_plan(monkeypatch, cin, cout):
    """What ``windowed_slab_fwd`` hands its kernel, caught at the launch (the
    wrapper made to take the CUDA route with CPU tensors): K4's plan for the
    same widths (tile width, padded widths, the slab tile's shared memory at
    27 taps), the features and weights zero-padded to those widths, and
    the C entry point's 5 pointers and 12 ints in their order."""
    n, block, wb, k3 = 700, 64, 256, 27
    rng = np.random.RandomState(cin)
    rb = np.clip(probe.make_monotone_rulebook(n, k3, rng, group=1), -1, n - 1)
    geom = wg.prepare_geometry(torch.from_numpy(rb), n, block, wb, 1)
    f = wg.pad_features(torch.from_numpy(rng.randn(n, cin).astype(np.float32)),
                        wg.padded_rows(n, wb), torch.bfloat16)
    w = torch.from_numpy(rng.randn(k3, cin, cout).astype(np.float32)).bfloat16()
    seen, fwd_operands = {}, wg.fwd_operands

    def operands(feats, weights, p):
        seen["x"], seen["w"] = fwd_operands(feats, weights, p)
        return seen["x"], seen["w"]

    monkeypatch.setattr(wg, "_on_cuda", lambda name, t: True)
    monkeypatch.setattr(wg, "fwd_operands", operands)
    monkeypatch.setattr(wg.WINDOWED_SLAB_FWD, "launch",
                        lambda dtype, device, *args: seen.update(dtype=dtype, args=args))
    nrows = geom.rbb.shape[1] * block
    out = wg.windowed_slab_fwd(f, geom, w, wb, 1, 2, True)
    assert out.shape == (nrows, cout) and out.dtype == torch.float32
    plan = wg.windowed_fwd_plan(nrows, cin, cout, k3, torch.bfloat16)
    assert plan.co_tile == 32
    assert (plan.cin_p, plan.cout_p) == ((16, 24) if cin == 13 else (32, 32))
    assert plan.smem_bytes == bc.gather_gemm_smem(32, 27, torch.bfloat16) == (
        3 * (128 * 40 + 32 * 40) * 2 + 27 * 128 * 4 + 41 * 4)
    x, wp = seen["x"], seen["w"]
    assert x.shape == (f.shape[0], plan.cin_p) and torch.equal(x[:, :cin], f)
    assert wp.shape == (k3, plan.cin_p, plan.cout_p) and torch.equal(wp[:, :cin, :cout], w)
    assert not x[:, cin:].any() and not wp[:, cin:].any() and not wp[:, :, cout:].any()
    assert seen["dtype"] == torch.bfloat16
    args = seen["args"]
    assert len(args) == len(wg.WINDOWED_SLAB_FWD.argtypes) - 1  # and the stream
    assert args[:5] == (x.data_ptr(), geom.rbb.data_ptr(), geom.w0.data_ptr(),
                        wp.data_ptr(), out.data_ptr())
    assert args[5:] == (nrows, plan.cin_p, cout, plan.cout_p, k3, geom.rbb.shape[1], block,
                        wb, 1, 2, 1, plan.co_tile)


@pytest.mark.parametrize("windows,rebase", [(2, False), (2, True), (1, False)],
                         ids=["V2", "V3", "V4"])
def test_slab_fwd_rows_multiplied_on_the_profile_rulebook(windows, rebase):
    """The rows the slab tile multiplies for P7 V2-V4 on the profile probe's
    rulebook (N = 163,840, 27 taps; ``profile_variants``' ``rows``), counted
    here from the geometry in numpy (16-row slabs of a tap with a live entry)
    against the live entries: at 70% density every slab holds one, so the
    tile multiplies 27 N rows, ~1.43x the live entries."""
    _, _, rb = probe.profile_inputs()
    nb, n_pad = probe.N // probe.BLOCK, (probe.N // probe.WB + 1) * probe.WB
    rbb = rb.reshape(probe.PROFILE_K3, nb, probe.BLOCK).astype(np.int64)
    lo = probe.probe_w0(rbb, probe.WB, n_pad).astype(np.int64)[:, :, None] * probe.WB
    live = ((rbb >= lo) & (rbb < lo + windows * probe.WB)).reshape(probe.PROFILE_K3, -1)
    slabs = int(live.reshape(probe.PROFILE_K3, -1, 16).any(2).sum()) * 16
    label = {(2, False): "V2", (2, True): "V3", (1, False): "V4"}[windows, rebase]
    v = next(v for v in probe.profile_variants(torch.device("cpu"))
             if v.name.split()[1] == label)
    assert v.kernel is wg.WINDOWED_SLAB_FWD
    assert v.rows == (slabs, int(live.sum()))
    assert live.sum() <= slabs <= 16 * live.sum()
    if windows == 2:
        assert slabs == probe.PROFILE_K3 * probe.N
        assert 1.40 < slabs / live.sum() < 1.46
    assert v.flops == 2.0 * live.sum() * probe.PROFILE_C ** 2


# ------------------------------------------------------------------ fixed-order sums
# The sums that replaced atomic index_add_ calls (reproducible steps on the
# GPU) compute the JAX package's functions, each destination's values added
# in the order given (on the GPU too: tests/test_torch_cuda.py).


def test_ordered_scatter_add_sums_in_the_order_given():
    from ponderv2_tpu_torch.ops.scatter import ordered_scatter_add

    rng = np.random.RandomState(0)
    idx = rng.randint(0, 7, 500)
    vals = (rng.randn(500, 3) * 10.0 ** rng.randint(-4, 5, (500, 1))).astype(np.float32)
    ref = np.zeros((7, 3), np.float32)
    for e in range(500):  # f32 adds, one entry after the other
        ref[idx[e]] += vals[e]
    out = ordered_scatter_add(torch.zeros(7, 3), torch.from_numpy(idx),
                              torch.from_numpy(vals))
    assert np.array_equal(out.numpy(), ref)


@pytest.mark.parametrize("op", ["sum", "mean"])
def test_fixed_order_segment_reductions_match_jax(op):
    import jax.numpy as jnp

    from ponderv2_tpu.ops import scatter as jscatter
    from ponderv2_tpu_torch.ops import scatter as tscatter

    rng = np.random.RandomState(1)
    n = 3 * tscatter.DUMP_ROWS + 17  # more dead rows than dump rows
    data = rng.randn(n, 6).astype(np.float32)
    ids = rng.randint(-40, 300, n).astype(np.int32)  # dead: negative or >= num
    num = 257
    ref = getattr(jscatter, f"segment_{op}")(jnp.asarray(data), jnp.asarray(ids), num)
    out = getattr(tscatter, f"segment_{op}")(torch.from_numpy(data), torch.from_numpy(ids),
                                            num)
    ref = np.asarray(ref)
    assert out.shape == ref.shape
    assert np.abs(out.numpy() - ref).max() <= 1e-6 * np.abs(ref).max()


def test_fixed_order_strided_conv_matches_jax():
    import jax.numpy as jnp

    from ponderv2_tpu.ops import spconv as jsp
    from ponderv2_tpu_torch.ops import spconv as tsp

    rng = np.random.RandomState(2)
    shape = (24, 24, 24)
    coords = np.unique(np.stack([rng.randint(0, 2, 3000)] + [rng.randint(0, s, 3000)
                                                             for s in shape], 1), axis=0)
    coords = np.concatenate([coords, np.full((300, 4), -1)]).astype(np.int32)
    feats = (rng.randn(len(coords), 6) * (coords[:, :1] >= 0)).astype(np.float32)
    cap = 1024
    j = jsp.build_strided_plan(jnp.asarray(coords), shape, 2, 2, 2, 0, cap)
    t = tsp.build_strided_plan(torch.from_numpy(coords), shape, 2, 2, 2, 0, cap)
    w = (rng.randn(8, 6, 5) * 0.3).astype(np.float32)
    omask = np.array(j.out_coords[:, 0] >= 0, copy=True)
    ref = np.asarray(jsp.strided_conv_packed(jnp.asarray(feats), j.parent, j.tap,
                                             jnp.asarray(w), cap, jnp.asarray(omask)))
    out = tsp.strided_conv_packed(torch.from_numpy(feats), t.parent, t.tap,
                                  torch.from_numpy(w), cap, torch.from_numpy(omask))
    assert np.abs(out.numpy() - ref).max() <= 1e-6 * np.abs(ref).max()


def test_fixed_order_overflow_residual_matches_jax():
    import jax.numpy as jnp

    from ponderv2_tpu.ops import band_conv as jbc
    from ponderv2_tpu_torch.ops.spconv import build_subm_rulebook

    rng = np.random.RandomState(3)
    shape = (16, 16, 16)
    coords = np.unique(np.stack([rng.randint(0, 2, 1500)] + [rng.randint(0, s, 1500)
                                                             for s in shape], 1), axis=0)
    coords = coords.astype(np.int32)
    rb = build_subm_rulebook(torch.from_numpy(coords), shape, 2, 3)
    plan = bc.build_band_plan(rb, 3, block=32, window=8, pair_budget=10 ** 6,
                              entry_budget=27 * len(coords))
    assert bool(plan.ok) and sum(plan.ov_counts) > 1000
    n = len(coords)
    f = rng.randn(n, 7).astype(np.float32)
    w = (rng.randn(27, 7, 5) * 0.3).astype(np.float32)
    out = bc._overflow_residual(torch.from_numpy(f), plan.ov_j, plan.ov_i, plan.ov_order,
                                plan.ov_counts, torch.from_numpy(w), n, torch.float32)
    ref = np.asarray(jbc._overflow_residual(
        jnp.asarray(f), jnp.asarray(plan.ov_j.numpy()), jnp.asarray(plan.ov_i.numpy()),
        jnp.asarray(plan.ov_t.numpy()), jnp.asarray(w), n, 5, jnp.float32))
    assert np.abs(out.numpy() - ref).max() <= 1e-6 * np.abs(ref).max()


def test_set_seed_makes_cudnn_deterministic():
    from ponderv2_tpu_torch.engines.defaults import default_setup
    from ponderv2_tpu_torch.utils.config import Config
    from ponderv2_tpu_torch.utils.env import set_seed

    saved = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    try:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = False, True
        assert set_seed(5) == 5
        assert torch.backends.cudnn.deterministic and not torch.backends.cudnn.benchmark
        a = (np.random.rand(), torch.rand(2))
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = False, True
        cfg = default_setup(Config(dict(seed=5)))
        assert cfg.seed == 5
        assert torch.backends.cudnn.deterministic and not torch.backends.cudnn.benchmark
        b = (np.random.rand(), torch.rand(2))
        assert a[0] == b[0] and torch.equal(a[1], b[1])
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
