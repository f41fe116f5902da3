"""Block-banded windowed submanifold conv and its Hopper kernels.

Counterpart of ``ponderv2_tpu/ops/band_conv.py``. Voxel rows are sorted by
ravel key and a tap's query key is the row key plus a constant, so over a
block of ``BLOCK`` consecutive output rows each tap-column's input rows fall
in one narrow window. ``build_band_plan`` records, per (tap-column, block),
an 8-aligned window start ``w0``; entries that fall outside their window go
to a budgeted overflow list (``ov_i/ov_j/ov_t``) that ``_overflow_residual``
adds back, and ``ok`` zero-gates the conv when a budget overflows.

Three cores carry the TPU kernels: ``band_fwd_core`` (K1, the forward and
the split backward's dx), ``band_dxdw_core`` (K2, the fused dx + dW) and
``band_dw_core`` (K3, the split dW). On a CUDA tensor each launches its
kernel (``csrc/band_conv.cu``, ``csrc/band_conv_bwd.cu``, built with nvcc at
first use, all three on the tensor-core tiles of ``csrc/mma_tile.cuh``,
planned by ``fwd_plan``, ``dxdw_plan`` and ``dw_plan``) or raises; on a CPU
tensor it runs its ``*_plain`` version, a per-tap masked gather + matmuls of
the same function. ``band_subm_conv`` is
a ``torch.autograd.Function`` over them, with the JAX package's backward
routing (``fused_bwd_fits``).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from .scatter import ordered_scatter_add

BLOCK = 256
WINDOW = 384
PAIR_BUDGET = 96
ENTRY_BUDGET = 8192


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class BandPlan(NamedTuple):
    """Banded rulebook (fields as in the JAX ``BandPlan``, minus ``rbt3``:
    the dW kernel K3 reads a tap-column's taps from ``rbt`` with a stride).

    - ``rbt``: (Npad, K^3) int32 - input row feeding output i via tap t.
    - ``w0``: (ncols, nblocks) int32 - 8-aligned window start per
      (tap-column, output block).
    - ``ok``: () bool - the overflow budgets sufficed.
    - ``ov_i/ov_j/ov_t``: (E,) int32 - overflow entries (output row, input
      row, tap), -1-padded, live entries first.
    - ``ov_order``/``ov_counts``: the live overflow entries grouped by tap
      (a permutation and per-tap counts), so the residual runs one matmul
      per tap over only its own entries without a host sync per conv.
    """

    rbt: torch.Tensor
    w0: torch.Tensor
    ok: torch.Tensor
    ov_i: torch.Tensor
    ov_j: torch.Tensor
    ov_t: torch.Tensor
    ov_order: torch.Tensor
    ov_counts: Tuple[int, ...]


def build_band_plan(
    rulebook: torch.Tensor,
    kz: int,
    block: Optional[int] = None,
    window: Optional[int] = None,
    pair_budget: Optional[int] = None,
    entry_budget: Optional[int] = None,
) -> BandPlan:
    """Derive the banded plan from a (K^3, N) subm rulebook (-1 = absent).

    Integer-exact with the JAX builder: the pair selection is a stable
    argsort, and the capped scatter of overflow entries writes into an
    ``E + 1`` buffer whose last slot is a dump slot."""
    block = block or BLOCK
    window = window or WINDOW
    pair_budget = PAIR_BUDGET if pair_budget is None else pair_budget
    entry_budget = ENTRY_BUDGET if entry_budget is None else entry_budget
    dev = rulebook.device
    k3, n = rulebook.shape
    ncols = k3 // kz
    npad = _cdiv(max(n, window), block) * block
    nblocks = npad // block
    rpad = torch.full((k3, npad), -1, dtype=torch.int64, device=dev)
    rpad[:, :n] = rulebook
    rcol = rpad.reshape(ncols, kz, nblocks, block)
    valid = rcol >= 0
    big = torch.iinfo(torch.int32).max
    lo = torch.where(valid, rcol, big).amin(dim=(1, 3))  # (ncols, nb)
    hi = torch.where(valid, rcol, -1).amax(dim=(1, 3))
    lo = torch.where(lo == big, 0, lo)
    cnt = valid.sum(dim=(1, 3)).clamp(min=1)
    mean = torch.div(torch.where(valid, rcol, 0).sum(dim=(1, 3)), cnt,
                     rounding_mode="floor")
    span_fits = (hi - (lo & ~7)) < window
    w0_lo = (lo & ~7).clamp(0, npad - window)
    w0_c = ((mean - window // 2) & ~7).clamp(0, npad - window)
    w0 = torch.where(span_fits, w0_lo, w0_c)

    # ---- overflow entries (tails outside the centered windows)
    pos = rcol - w0[:, None, :, None]
    ovf = valid & ((pos < 0) | (pos >= window))  # (ncols, kz, nb, block)
    pair_ovf = ovf.any(dim=3).any(dim=1).reshape(-1)  # (ncols * nblocks,)
    npairs = ncols * nblocks
    bud = min(pair_budget, npairs)
    # overflowing pairs first (stable argsort ascending on !flag)
    order = torch.argsort(1 - pair_ovf.to(torch.int32), stable=True)
    sel = order[:bud]  # flat pair ids = col * nblocks + blk
    live = pair_ovf[sel]
    sel_col = torch.div(sel, nblocks, rounding_mode="floor")
    sel_blk = sel % nblocks
    rows = sel_blk[:, None] * block + torch.arange(block, device=dev)
    # (bud, block, kz) input rows of the selected pairs' entries
    ent = rcol[sel_col, :, sel_blk, :].permute(0, 2, 1)
    w0_sel = w0.reshape(-1)[sel]
    posn = ent - w0_sel[:, None, None]
    eovf = (ent >= 0) & ((posn < 0) | (posn >= window)) & live[:, None, None]
    flat = eovf.reshape(-1)
    slot = torch.cumsum(flat.to(torch.int64), 0) - 1
    total = flat.sum()
    E = entry_budget
    tgt = torch.where(flat & (slot < E), slot, E)  # E = dump slot
    src_i = rows[:, :, None].expand(ent.shape).reshape(-1)
    src_j = ent.reshape(-1)
    src_t = (sel_col[:, None, None] * kz
             + torch.arange(kz, device=dev)[None, None, :]).expand(ent.shape).reshape(-1)

    def compact(src):
        buf = torch.full((E + 1,), -1, dtype=torch.int64, device=dev)
        buf.scatter_(0, tgt, src)
        return buf[:E].to(torch.int32)

    ov_i, ov_j, ov_t = compact(src_i), compact(src_j), compact(src_t)
    ok = (pair_ovf.sum() <= bud) & (total <= E)

    # residual grouping: live entries are the first min(total, E) slots
    n_live = min(int(total), E)
    ov_order = torch.argsort(ov_t[:n_live], stable=True)
    ov_counts = tuple(torch.bincount(ov_t[:n_live].to(torch.int64),
                                     minlength=k3).tolist())
    return BandPlan(rbt=rpad.T.contiguous().to(torch.int32),
                    w0=w0.to(torch.int32).contiguous(), ok=ok,
                    ov_i=ov_i, ov_j=ov_j, ov_t=ov_t,
                    ov_order=ov_order, ov_counts=ov_counts)


# The budget retry of the JAX input pipeline (``host_build_spunet_plans``):
# a plan whose budgets overflowed is rebuilt with both budgets doubled, up
# to this many times.
MAX_DOUBLINGS = 4


def build_band_plan_auto(rulebook: torch.Tensor, kz: int) -> BandPlan:
    """``build_band_plan`` at the default budgets, doubled (up to
    ``MAX_DOUBLINGS`` times) while ``ok`` is False, so that a dense batch
    gets a bigger overflow residual instead of a zeroed conv. The JAX
    package applies this retry to the attached plans only; its inline plans
    keep the default budgets, which a 12-scene ScanNet batch overflows at
    L0 and L1 (ROADMAP Queue 3). ``build_band_plan`` syncs with the host, so
    reading ``ok`` costs nothing more."""
    pair, entry = PAIR_BUDGET, ENTRY_BUDGET
    for attempt in range(MAX_DOUBLINGS + 1):
        plan = build_band_plan(rulebook, kz, pair_budget=pair, entry_budget=entry)
        if bool(plan.ok) or attempt == MAX_DOUBLINGS:
            return plan
        pair, entry = pair * 2, entry * 2


# ------------------------------------------------------------------ kernels


_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


class _CudaKernel:
    """ctypes entry points and launch count of one CUDA kernel of
    ``csrc/<source>.cu``: one entry point ``<symbol>_f32`` / ``<symbol>_bf16``
    per dtype in ``dtypes`` (both, or the one a kernel reads), or the bare
    ``<symbol>`` for a kernel of int32 inputs (``dtypes=()``; ``launch`` then
    takes ``dtype=None``).
    ``launches`` grows by one each time the wrapper launches the kernel, and
    nowhere else."""

    def __init__(self, source: str, symbol: str, n_ptrs: int, n_ints: int,
                 error_symbol: str, dtypes=(torch.float32, torch.bfloat16)):
        self.source = source
        self.symbol = symbol
        self.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                         + [ctypes.c_void_p])
        self.error_symbol = error_symbol
        self.dtypes = tuple(dtypes)
        self.launches = 0
        self._lib = None

    def _entry(self, dtype: Optional[torch.dtype]) -> str:
        return f"{self.symbol}_{_SUFFIX[dtype]}" if self.dtypes else self.symbol

    def lib(self) -> ctypes.CDLL:
        if self._lib is None:
            from .cuda_build import load_library

            lib = load_library(self.source)
            for dtype in self.dtypes or (None,):
                fn = getattr(lib, self._entry(dtype))
                fn.argtypes = self.argtypes
                fn.restype = ctypes.c_int
            err = getattr(lib, self.error_symbol)
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def launch(self, dtype: Optional[torch.dtype], device: torch.device,
               *args) -> None:
        """Launch on the device's current stream; raise if the launch failed."""
        if self.dtypes and dtype not in self.dtypes:
            raise TypeError(f"{self.symbol}: no kernel for {dtype}")
        lib = self.lib()
        fn = getattr(lib, self._entry(dtype))
        with torch.cuda.device(device):
            err = fn(*args, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"{self.symbol}: launch failed: "
                               + getattr(lib, self.error_symbol)(err).decode())
        self.launches += 1


BAND_FWD = _CudaKernel("band_conv", "band_fwd", 5, 10, "band_error_string")
BAND_DXDW = _CudaKernel("band_conv_bwd", "band_dxdw", 8, 14,
                        "band_bwd_error_string")
BAND_DW = _CudaKernel("band_conv_bwd", "band_dw", 6, 14, "band_bwd_error_string")
KERNELS = (BAND_FWD, BAND_DXDW, BAND_DW)


def build_kernels() -> None:
    """Build (one nvcc per source, in parallel) and bind every band kernel."""
    from .cuda_build import load_libraries

    load_libraries(*sorted({k.source for k in KERNELS}))
    for k in KERNELS:
        k.lib()


def _on_cuda(name: str, features: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises on other devices."""
    if features.device.type == "cpu":
        return False
    if features.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {features.device}")
    return True


def _check(name: str, n: int, feats, rbt, w0, weights, kz: int, block: int,
           others=()) -> None:
    """What the kernels take: f32 or bf16 operands of one dtype, int32
    (Npad, K^3) ``rbt`` and (ncols, nblocks) ``w0``, one device, contiguous."""
    k3 = rbt.shape[1] if rbt.dim() == 2 else -1
    npad = rbt.shape[0]
    if feats.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: dtype {feats.dtype}")
    if any(t.dtype != feats.dtype for t in (weights, *others)):
        raise TypeError(f"{name}: operand dtypes differ")
    if rbt.dtype != torch.int32 or w0.dtype != torch.int32:
        raise TypeError(f"{name}: rbt and w0 must be int32")
    if npad < n or k3 <= 0 or k3 % kz or npad % block:
        raise ValueError(f"{name}: rbt shape {tuple(rbt.shape)} for {n} rows")
    if w0.shape != (k3 // kz, npad // block):
        raise ValueError(f"{name}: w0 shape {tuple(w0.shape)}")
    tensors = (feats, rbt, w0, weights, *others)
    if any(t.device != feats.device for t in tensors):
        raise ValueError(f"{name}: tensors on different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: tensors must be contiguous")


def _tap_rows(src: torch.Tensor, rbt: torch.Tensor, w0: torch.Tensor, t: int,
              n: int, kz: int, block: int, window: int) -> torch.Tensor:
    """Rows ``src[rbt[i, t]]`` for i < n, zero where the entry is inactive or
    outside its window: the plain versions' masked gather."""
    j = rbt[:n, t].to(torch.int64)
    blk = torch.div(torch.arange(n, device=src.device), block, rounding_mode="floor")
    pos = j - w0[t // kz][blk]
    live = (j >= 0) & (pos >= 0) & (pos < window)
    zero = torch.zeros((), dtype=src.dtype, device=src.device)
    return torch.where(live[:, None], src[j.clamp(min=0)], zero)


# ------------------------------------------------------------------ K1


def band_fwd_core(features: torch.Tensor, rbt: torch.Tensor, w0: torch.Tensor,
                  weights: torch.Tensor, kz: int, block: int,
                  window: int) -> torch.Tensor:
    """K1: banded forward core, (N, Cin) x (K^3, Cin, Cout) -> (N, Cout) f32.

    Entries outside their window are dropped (the caller adds the overflow
    residual). CPU tensors take ``band_fwd_core_plain``; CUDA tensors launch
    ``csrc/band_conv.cu`` (a tensor-core tile of ``csrc/mma_tile.cuh``,
    picked and planned by ``fwd_plan``) and raise on anything it does not
    take."""
    if not _on_cuda("band_fwd_core", features):
        return band_fwd_core_plain(features, rbt, w0, weights, kz, block, window)
    n, cin = features.shape
    _check("band_fwd_core", n, features, rbt, w0, weights, kz, block)
    k3, cin_w, cout = weights.shape
    if cin_w != cin or k3 != rbt.shape[1]:
        raise ValueError(f"band_fwd_core: weights {tuple(weights.shape)} for "
                         f"features {tuple(features.shape)}")
    if k3 > 32:
        raise ValueError(f"band_fwd_core: {k3} taps, the kernel takes at most 32")
    out = torch.empty((n, cout), dtype=torch.float32, device=features.device)
    if n == 0 or cout == 0:
        return out
    p = fwd_plan(n, cin, cout, k3, features.dtype)
    fp = _operand(features, p.cin_p)
    wp = _operand(weights, p.cout_p)
    if p.cin_p != cin:
        wp = torch.nn.functional.pad(wp, (0, 0, 0, p.cin_p - cin))
    BAND_FWD.launch(features.dtype, features.device, fp.data_ptr(), rbt.data_ptr(),
                    w0.data_ptr(), wp.data_ptr(), out.data_ptr(), n, p.cin_p, cout,
                    p.cout_p, k3, kz, rbt.shape[0] // block, block, window, p.co_tile)
    return out


def band_fwd_core_plain(features: torch.Tensor, rbt: torch.Tensor,
                        w0: torch.Tensor, weights: torch.Tensor, kz: int,
                        block: int, window: int) -> torch.Tensor:
    """Plain PyTorch version of K1: per tap, a masked row gather and a matmul
    of the compute-dtype values in f32, as K1 multiplies and sums them. The
    loop keeps the transient at (N, Cin); a batched gather over all taps
    would materialize 27 x N x Cin."""
    n = features.shape[0]
    k3, _, cout = weights.shape
    wf = weights.float()
    out = torch.zeros((n, cout), dtype=torch.float32, device=features.device)
    for t in range(k3):
        out += _tap_rows(features, rbt, w0, t, n, kz, block, window).float() @ wf[t]
    return out


# ------------------------------------------------------------------ plans

# The tensor-core tiles (csrc/mma_tile.cuh) are 32, 64, 96 or 128 channels
# wide; f32 stops at 96 (K2's and K3's f32 tiles keep a second accumulator,
# kStageSums, and K1 follows the same widths).
TILE_WIDTHS = (128, 96, 64, 32)
MIN_DW_CHUNK = 1024


def tile_width(c: int, dtype: torch.dtype) -> int:
    """The tile width that covers ``c`` channels with the fewest padding
    columns, the wider on a tie (96 for 96 and 192; 32 for 5; 128 in bf16
    and 64 in f32 for 128)."""
    widths = TILE_WIDTHS if dtype == torch.bfloat16 else TILE_WIDTHS[1:]
    return min(widths, key=lambda w: (_cdiv(c, w) * w, -w))


def padded_width(c: int, dtype: torch.dtype) -> int:
    """``c`` rounded up to whole 16-byte copies: 8 bf16 or 4 f32 elements."""
    vec = 8 if dtype == torch.bfloat16 else 4
    return _cdiv(c, vec) * vec


def _elt(dtype: torch.dtype) -> int:
    return 2 if dtype == torch.bfloat16 else 4


# K2: a dx CTA holds 128 rows (8 warps x 16). The dW partials (chunks x k3 x
# cin x cout f32, of K2 and K3) are capped at DXDW_SCRATCH_BYTES; within
# that, about DXDW_DW_CTAS dW CTAs (~8 waves of 2 per SM), of at least
# MIN_DW_CHUNK rows each.
DX_ROWS = 128
DXDW_DW_CTAS = 2048
DXDW_SCRATCH_BYTES = 128 * 2 ** 20

# K1 (csrc/band_conv.cu) runs one of two tiles, by dtype. In f32 the
# compacted tile (K1_TILE: a CTA owns this many output rows x one column
# tile; stages this deep, this many in flight) multiplies only live entries:
# there the 3xTF32 products set the pace. In bf16 K2's dx tile, gather_gemm
# (DX_ROWS rows per CTA, whole 16-row slabs), is faster at every measured
# conv (PERF.md; tools/experiments/probe_mma_variants_torch.py k1).
K1_TILE = (256, 16, 3)


# shared-memory layouts of the tiles that K1-K5 share (csrc/mma_tile.cuh),
# as each tile's ``smem_bytes`` computes them: the slab tile keeps the
# entry table of up to TAP_GROUP taps at a time (kTapGroup)
TAP_GROUP = 32
DW_STAGES = 3  # mma_tile.cuh:DwGemm, as band_conv_bwd.cu and windowed_gather.cu instantiate it


def gather_gemm_smem(co: int, k3: int, dtype: torch.dtype) -> int:
    """``GatherGemm<T, co, 8, 1, 32, 3>::smem_bytes(k3)``: the slab tile of
    K2's dx, K1 in bf16 and K4 (DX_ROWS rows, 32-deep stages, 3 in flight)."""
    pad = 8 if dtype == torch.bfloat16 else 4
    rows, kc, stages = DX_ROWS, 32, 3
    return (stages * (rows * (kc + pad) + kc * (co + 8)) * _elt(dtype)
            + min(k3, TAP_GROUP) * rows * 4 + (8 + 33) * 4)


def dw_gemm_smem(mt: int, nt: int, dtype: torch.dtype) -> int:
    """``DwGemm<T, mt, nt, DW_STAGES>::smem_bytes()``: stages of 32 live
    entries' f and gathered rows, and a 1024-row window's lists."""
    return DW_STAGES * 32 * (mt + 8 + nt + 8) * _elt(dtype) + (2 * 1024 + 32) * 4


class FwdPlan(NamedTuple):
    """K1's launch plan: the tile (compacted or slabs), output column tile,
    padded widths, CTAs and the dynamic shared memory of one CTA
    (``CompactGemm::smem_bytes`` / ``GatherGemm::smem_bytes``)."""

    compact: bool
    co_tile: int
    cin_p: int
    cout_p: int
    ctas: int
    smem_bytes: int


def fwd_plan(n: int, cin: int, cout: int, k3: int, dtype: torch.dtype) -> FwdPlan:
    """K1's launch plan for ``n`` rows, ``cin`` -> ``cout`` channels and
    ``k3`` taps in ``dtype``."""
    co = tile_width(cout, dtype)
    compact = dtype == torch.float32
    if compact:
        pad = 8 if dtype == torch.bfloat16 else 4
        rows, kc, stages = K1_TILE
        smem = (stages * (rows * (kc + pad) + kc * (co + 8)) * _elt(dtype)
                + rows * (co + 8) * 4 + k3 * rows * 4 + 65 * 4 + k3 * rows)
    else:
        rows, smem = DX_ROWS, gather_gemm_smem(co, k3, dtype)
    return FwdPlan(compact=compact, co_tile=co, cin_p=padded_width(cin, dtype),
                   cout_p=padded_width(cout, dtype),
                   ctas=_cdiv(n, rows) * _cdiv(cout, co), smem_bytes=smem)


# K3 runs only the split convs (256 and 384 channels), so its kernel holds
# only their (input, output) channel tiles; other widths take one of these
# with zero padding.
K3_TILES = {torch.float32: ((64, 64), (96, 64)), torch.bfloat16: ((128, 128),)}


def _dw_chunks(n: int, cin: int, cout: int, k3: int, tiles: int) -> Tuple[int, int]:
    """(rows per chunk, number of chunks) of a dW reduction over ``tiles``
    channel tiles: about DXDW_DW_CTAS CTAs, chunks of at least MIN_DW_CHUNK
    rows, partials within DXDW_SCRATCH_BYTES; chunks are whole 16-row slabs."""
    per_chunk = k3 * cin * cout * 4
    nchunks = max(1, min(_cdiv(DXDW_DW_CTAS, k3 * tiles), _cdiv(n, MIN_DW_CHUNK),
                         DXDW_SCRATCH_BYTES // per_chunk))
    chunk = _cdiv(_cdiv(n, nchunks), 16) * 16
    return chunk, _cdiv(n, chunk)


class DxdwPlan(NamedTuple):
    """K2's launch plan: channel tiles, padded widths, CTA ranges (dW
    first, then dx), row chunks of the dW reduction and its scratch."""

    ci_tile: int
    co_tile: int
    cin_p: int
    cout_p: int
    ndw: int
    ndx: int
    chunk: int
    nchunks: int
    scratch_bytes: int


def dxdw_plan(n: int, cin: int, cout: int, k3: int, dtype: torch.dtype) -> DxdwPlan:
    """K2's launch plan for ``n`` rows, ``cin`` -> ``cout`` channels and
    ``k3`` taps in ``dtype``."""
    ci, co = tile_width(cin, dtype), tile_width(cout, dtype)
    tiles = _cdiv(cin, ci) * _cdiv(cout, co)
    chunk, nchunks = _dw_chunks(n, cin, cout, k3, tiles)
    return DxdwPlan(ci_tile=ci, co_tile=co, cin_p=padded_width(cin, dtype),
                    cout_p=padded_width(cout, dtype), ndw=nchunks * k3 * tiles,
                    ndx=_cdiv(n, DX_ROWS) * _cdiv(cin, ci), chunk=chunk,
                    nchunks=nchunks, scratch_bytes=nchunks * k3 * cin * cout * 4)


class DwPlan(NamedTuple):
    """K3's launch plan: channel tiles (from ``K3_TILES``), padded widths,
    CTAs, row chunks and scratch of the dW reduction, and the dynamic shared
    memory of one CTA (``DwGemm::smem_bytes``)."""

    ci_tile: int
    co_tile: int
    cin_p: int
    cout_p: int
    ctas: int
    chunk: int
    nchunks: int
    scratch_bytes: int
    smem_bytes: int


def dw_plan(n: int, cin: int, cout: int, k3: int, dtype: torch.dtype) -> DwPlan:
    """K3's launch plan for ``n`` rows, ``cin`` -> ``cout`` channels and
    ``k3`` taps in ``dtype``: the tile of ``K3_TILES`` with the fewest
    padded products, the larger on a tie."""
    ci, co = min(K3_TILES[dtype], key=lambda t: (
        _cdiv(cin, t[0]) * t[0] * _cdiv(cout, t[1]) * t[1], -t[0] * t[1]))
    tiles = _cdiv(cin, ci) * _cdiv(cout, co)
    chunk, nchunks = _dw_chunks(n, cin, cout, k3, tiles)
    return DwPlan(ci_tile=ci, co_tile=co, cin_p=padded_width(cin, dtype),
                  cout_p=padded_width(cout, dtype), ctas=nchunks * k3 * tiles,
                  chunk=chunk, nchunks=nchunks,
                  scratch_bytes=nchunks * k3 * cin * cout * 4,
                  smem_bytes=dw_gemm_smem(ci, co, dtype))


def _operand(t: torch.Tensor, width: int) -> torch.Tensor:
    """``t`` with its last dim zero-padded to ``width``, contiguous and
    16-byte aligned, as the tensor-core tiles copy it."""
    if t.shape[-1] != width:
        t = torch.nn.functional.pad(t, (0, width - t.shape[-1]))
    if t.data_ptr() % 16:
        t = t.clone()
    return t


def band_dxdw_core(g: torch.Tensor, features: torch.Tensor, rbt: torch.Tensor,
                   w0: torch.Tensor, w_mirT: torch.Tensor, kz: int, block: int,
                   window: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2: fused backward core. ``g`` (N, Cout) cotangent, ``features`` (N,
    Cin), ``w_mirT`` (K^3, Cout, Cin) = ``W[mirror t]^T``. Over in-window
    entries j = rbt[i, t]:

        dx[i]  += g[j] @ w_mirT[t]       -> (N, Cin) f32
        dwr[t] += features[i]^T g[j]     -> (K^3, Cin, Cout) f32

    ``dwr[t]`` holds dW[mirror t]. CPU tensors take ``band_dxdw_core_plain``;
    CUDA tensors launch ``csrc/band_conv_bwd.cu`` (the tensor-core tiles of
    ``csrc/mma_tile.cuh``, planned by ``dxdw_plan``) or raise."""
    if not _on_cuda("band_dxdw_core", g):
        return band_dxdw_core_plain(g, features, rbt, w0, w_mirT, kz, block,
                                    window)
    n, cout = g.shape
    _check("band_dxdw_core", n, g, rbt, w0, w_mirT, kz, block, (features,))
    cin = features.shape[1]
    k3 = rbt.shape[1]
    if features.shape[0] != n or w_mirT.shape != (k3, cout, cin):
        raise ValueError(f"band_dxdw_core: shapes g {tuple(g.shape)} features "
                         f"{tuple(features.shape)} w_mirT {tuple(w_mirT.shape)}")
    if k3 > 32:
        raise ValueError(f"band_dxdw_core: {k3} taps, the kernel takes at most 32")
    dev = g.device
    if n == 0 or cin == 0 or cout == 0:
        return (torch.zeros((n, cin), dtype=torch.float32, device=dev),
                torch.zeros((k3, cin, cout), dtype=torch.float32, device=dev))
    p = dxdw_plan(n, cin, cout, k3, g.dtype)
    gp, fp = _operand(g, p.cout_p), _operand(features, p.cin_p)
    wp = _operand(w_mirT, p.cin_p)
    if p.cout_p != cout:
        wp = torch.nn.functional.pad(wp, (0, 0, 0, p.cout_p - cout))
    dx = torch.empty((n, cin), dtype=torch.float32, device=dev)
    dwr = torch.empty((k3, cin, cout), dtype=torch.float32, device=dev)
    partial = torch.empty((p.nchunks, k3, cin, cout), dtype=torch.float32, device=dev)
    BAND_DXDW.launch(g.dtype, dev, gp.data_ptr(), fp.data_ptr(), rbt.data_ptr(),
                     w0.data_ptr(), wp.data_ptr(), dx.data_ptr(), partial.data_ptr(),
                     dwr.data_ptr(), n, cin, cout, p.cin_p, p.cout_p, k3, kz,
                     rbt.shape[0] // block, block, window, p.chunk, p.nchunks,
                     p.ci_tile, p.co_tile)
    return dx, dwr


def band_dxdw_core_plain(g: torch.Tensor, features: torch.Tensor,
                         rbt: torch.Tensor, w0: torch.Tensor,
                         w_mirT: torch.Tensor, kz: int, block: int,
                         window: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K2: per tap, one masked gather of ``g``
    through ``rbt`` serves both matmuls, in f32 as in K2."""
    n, cin = features.shape
    k3, cout, _ = w_mirT.shape
    ff, wf = features.float(), w_mirT.float()
    dx = torch.zeros((n, cin), dtype=torch.float32, device=g.device)
    dwr = torch.empty((k3, cin, cout), dtype=torch.float32, device=g.device)
    for t in range(k3):
        rows = _tap_rows(g, rbt, w0, t, n, kz, block, window).float()
        dx += rows @ wf[t]
        dwr[t] = ff.T @ rows
    return dx, dwr


def band_dw_core(features: torch.Tensor, g: torch.Tensor, rbt: torch.Tensor,
                 w0: torch.Tensor, kz: int, block: int,
                 window: int) -> torch.Tensor:
    """K3: split dW core, ``dwr[t] += features[i]^T g[rbt[i, t]]`` over
    in-window entries -> (K^3, Cin, Cout) f32, ``dwr[t]`` = dW[mirror t].
    CPU tensors take ``band_dw_core_plain``; CUDA tensors launch
    ``csrc/band_conv_bwd.cu`` (K2's dW tile of ``csrc/mma_tile.cuh``,
    planned by ``dw_plan``) or raise."""
    if not _on_cuda("band_dw_core", features):
        return band_dw_core_plain(features, g, rbt, w0, kz, block, window)
    n, cin = features.shape
    _check("band_dw_core", n, features, rbt, w0, g, kz, block)
    cout = g.shape[1]
    k3 = rbt.shape[1]
    if g.shape[0] != n:
        raise ValueError(f"band_dw_core: g {tuple(g.shape)} for features "
                         f"{tuple(features.shape)}")
    dev = features.device
    if n == 0 or cin == 0 or cout == 0:
        return torch.zeros((k3, cin, cout), dtype=torch.float32, device=dev)
    p = dw_plan(n, cin, cout, k3, features.dtype)
    fp, gp = _operand(features, p.cin_p), _operand(g, p.cout_p)
    dwr = torch.empty((k3, cin, cout), dtype=torch.float32, device=dev)
    partial = torch.empty((p.nchunks, k3, cin, cout), dtype=torch.float32, device=dev)
    BAND_DW.launch(features.dtype, dev, fp.data_ptr(), gp.data_ptr(), rbt.data_ptr(),
                   w0.data_ptr(), partial.data_ptr(), dwr.data_ptr(), n, cin, cout,
                   p.cin_p, p.cout_p, k3, kz, rbt.shape[0] // block, block, window,
                   p.chunk, p.nchunks, p.ci_tile, p.co_tile)
    return dwr


def band_dw_core_plain(features: torch.Tensor, g: torch.Tensor,
                       rbt: torch.Tensor, w0: torch.Tensor, kz: int, block: int,
                       window: int) -> torch.Tensor:
    """Plain PyTorch version of K3: per tap, a masked gather of ``g`` and one
    TN matmul, in f32 as in K3."""
    n, cin = features.shape
    k3, cout = rbt.shape[1], g.shape[1]
    ff = features.float()
    dwr = torch.empty((k3, cin, cout), dtype=torch.float32, device=g.device)
    for t in range(k3):
        dwr[t] = ff.T @ _tap_rows(g, rbt, w0, t, n, kz, block, window).float()
    return dwr


def fused_bwd_fits(cp: int, cop: int, window: int = WINDOW, block: int = BLOCK,
                   k3: int = 27, ncols: int = 9) -> bool:
    """The JAX package's backward routing (``_fused_bwd_fits``, its TPU VMEM
    estimate over 128-padded widths) without its env var: True takes K2,
    False K1 on the cotangent plus K3. Kept so that the port runs the same
    kernels on the same shapes as the reference."""
    est = (
        ncols * window * cop * 2
        + k3 * cop * cp * 2
        + k3 * cp * cop * 4
        + block * cp * (2 + 4)
        + 2 * block * window * 4
    )
    return est < 12 * 1024 * 1024


# ------------------------------------------------------------------ wrappers


def _overflow_residual(src, ov_src, ov_dst, order, counts, w_taps, n_out,
                       compute_dtype):
    """Budgeted overflow contributions: rows ``src[ov_src[e]] @ w_taps[t_e]``
    added at ``ov_dst[e]`` -> (n_out, cout) f32. The live entries, grouped by
    tap through ``order``/``counts``, get one matmul per tap; each output row
    sums its entries in tap order (``ordered_scatter_add``)."""
    cout = w_taps.shape[2]
    out = torch.zeros((n_out, cout), dtype=torch.float32, device=src.device)
    n_live = sum(counts)
    if n_live == 0:
        return out
    j = ov_src[:n_live][order].to(torch.int64)
    i = ov_dst[:n_live][order].to(torch.int64)
    g = src[j].to(compute_dtype)
    w = w_taps.to(compute_dtype)
    acc = torch.empty((n_live, cout), dtype=torch.float32, device=src.device)
    start = 0
    for t, c in enumerate(counts):
        if c:
            acc[start:start + c] = (g[start:start + c] @ w[t]).float()
            start += c
    return ordered_scatter_add(out, i, acc)


def _overflow_dw(f, g, plan: BandPlan, compute_dtype):
    """Budgeted overflow dW: ``f[ov_i[e]]^T g[ov_j[e]]`` summed per tap
    -> (K^3, Cin, Cout) f32, slot t holding dW[mirror t] as the cores' dwr
    does. Grouped by tap like ``_overflow_residual``."""
    counts = plan.ov_counts
    out = torch.zeros((len(counts), f.shape[1], g.shape[1]), dtype=torch.float32,
                      device=f.device)
    n_live = sum(counts)
    if n_live == 0:
        return out
    fe = f[plan.ov_i[:n_live][plan.ov_order].to(torch.int64)].to(compute_dtype)
    ge = g[plan.ov_j[:n_live][plan.ov_order].to(torch.int64)].to(compute_dtype)
    start = 0
    for t, c in enumerate(counts):
        if c:
            out[t] = (fe[start:start + c].T @ ge[start:start + c]).float()
            start += c
    return out


def _pad128(c: int) -> int:
    return _cdiv(c, 128) * 128


class _BandSubmConv(torch.autograd.Function):
    """The JAX package's ``band_subm_conv`` custom VJP (``_fwd_impl`` /
    ``_bwd_impl``)."""

    @staticmethod
    def forward(ctx, features, weights, cfg, plan, out_mask, compute_dtype):
        kz, block, window = cfg
        n = features.shape[0]
        out = band_fwd_core(features.to(compute_dtype).contiguous(), plan.rbt,
                            plan.w0, weights.to(compute_dtype).contiguous(), kz,
                            block, window)
        # out-of-window tail entries, dropped by the core
        out = out + _overflow_residual(features, plan.ov_j, plan.ov_i,
                                       plan.ov_order, plan.ov_counts, weights,
                                       n, compute_dtype)
        out = out * plan.ok.to(torch.float32)
        out = torch.where(out_mask[:, None], out,
                          torch.zeros((), device=out.device))
        ctx.save_for_backward(features, weights)
        ctx.cfg, ctx.plan, ctx.out_mask, ctx.cdt = cfg, plan, out_mask, compute_dtype
        return out.to(features.dtype)

    @staticmethod
    def backward(ctx, g):
        features, weights = ctx.saved_tensors
        kz, block, window = ctx.cfg
        plan, cdt = ctx.plan, ctx.cdt
        n, cin = features.shape
        k3, _, cout = weights.shape
        g = torch.where(ctx.out_mask[:, None], g, torch.zeros((), dtype=g.dtype,
                                                               device=g.device))
        gate = plan.ok.to(torch.float32)
        gc = g.to(cdt).contiguous()
        fc = features.to(cdt).contiguous()
        # dx: tap t of the cotangent gather pairs with weight tap mirror(t) =
        # k3-1-t (subm symmetry): the forward's banded product with mirrored,
        # transposed weights
        w_mirT = weights.flip(0).transpose(1, 2)
        wmt = w_mirT.to(cdt).contiguous()
        if fused_bwd_fits(_pad128(cin), _pad128(cout), window, block, k3,
                          k3 // kz):
            dx, dwr = band_dxdw_core(gc, fc, plan.rbt, plan.w0, wmt, kz, block,
                                     window)
        else:
            dx = band_fwd_core(gc, plan.rbt, plan.w0, wmt, kz, block, window)
            dwr = band_dw_core(fc, gc, plan.rbt, plan.w0, kz, block, window)
        # dropped mirrored entries: dx[i] += g[rbt[i, t]] @ W[mirror t]^T
        dx = dx + _overflow_residual(g, plan.ov_j, plan.ov_i, plan.ov_order,
                                     plan.ov_counts, w_mirT, n, cdt)
        dx = dx * gate
        # slot t holds dW[mirror t], the overflow entries' included
        dw = (dwr + _overflow_dw(features, g, plan, cdt)).flip(0) * gate
        return (dx.to(features.dtype), dw.to(weights.dtype), None, None, None,
                None)


def band_subm_conv(cfg, features: torch.Tensor, plan: BandPlan,
                   weights: torch.Tensor, out_mask: torch.Tensor,
                   compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Banded windowed submanifold conv, differentiable in ``features`` and
    ``weights``. ``cfg`` = (kz, block, window); ``weights`` (K^3, Cin, Cout).
    Same contract as the plain subm conv over rows sorted by key; a plan
    whose budgets overflowed (``plan.ok`` False) gives all-zero output and
    all-zero gradients."""
    return _BandSubmConv.apply(features, weights, tuple(cfg), plan, out_mask,
                               compute_dtype or features.dtype)


def band_eligible(cin: int, cout: int, kernel_size) -> bool:
    """k3 subm convs take the band path at every width (the JAX package's
    ``min_cin`` is 1). Its TPU VMEM estimate is not ported: it refuses no
    width of the SpUNet-v1m1 configs."""
    k = kernel_size if isinstance(kernel_size, int) else max(kernel_size)
    return k == 3 and cin >= 1
