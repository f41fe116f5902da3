"""The launch plans of the tensor-core gather-GEMM kernels (K1,
``band_fwd_core``; K2, ``band_dxdw_core``; K3, ``band_dw_core``; P5 ``kd``,
``tile_matmul``), the arithmetic of their f32 route, and the fixed-order
sums of the reproducible steps, on the CPU.

The kernels themselves run only on a GPU (``tests/test_torch_cuda.py``).
What the wrappers decide in Python is checked here: tile widths, padded
widths, CTA ranges, row chunks and scratch of the dW reduction, dynamic
shared memory. The f32 route multiplies as 3xTF32 (``csrc/mma_tile.cuh``); a
numpy emulation of that split shows it holds the f32 bound of the GPU tests
(1e-5 of max|ref|) over the reduction lengths of the fine-tune step's L0
convs, where one TF32 pass would not, and an emulation of K1's compacted
tile (its summation order) holds the same bound against the plain version.
"""

import numpy as np
import pytest
import torch

from ponderv2_tpu_torch.ops import band_conv as bc
from ponderv2_tpu_torch.ops import probe_kernels as pk

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
