"""Block-banded windowed submanifold conv (forward) and its Hopper kernel.

Counterpart of ``ponderv2_tpu/ops/band_conv.py``. Voxel rows are sorted by
ravel key and a tap's query key is the row key plus a constant, so over a
block of ``BLOCK`` consecutive output rows each tap-column's input rows fall
in one narrow window. ``build_band_plan`` records, per (tap-column, block),
an 8-aligned window start ``w0``; entries that fall outside their window go
to a budgeted overflow list (``ov_i/ov_j/ov_t``) that ``_overflow_residual``
adds back, and ``ok`` zero-gates the conv when a budget overflows.

The forward core (``band_fwd_core``) is the TPU kernel K1. On a CUDA tensor
it launches ``csrc/band_conv.cu`` (built with nvcc at first use) or raises;
on a CPU tensor it runs ``band_fwd_core_plain``, a per-tap masked gather +
matmul of the same function. The backward kernels (K2, K3) are not ported
yet, so the CUDA path refuses tensors that require grad.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

BLOCK = 256
WINDOW = 384
PAIR_BUDGET = 96
ENTRY_BUDGET = 8192


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class BandPlan(NamedTuple):
    """Banded rulebook (fields as in the JAX ``BandPlan``, minus ``rbt3``,
    which only the dW kernel K3 reads).

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


# ------------------------------------------------------------------ K1


class _CudaKernel:
    """ctypes handle and launch count of one CUDA kernel of ``csrc/``."""

    def __init__(self, source: str):
        self.source = source
        self.launches = 0
        self._lib = None

    def lib(self) -> ctypes.CDLL:
        if self._lib is None:
            from .cuda_build import load_library

            lib = load_library(self.source)
            args = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
            for fn in (lib.band_fwd_f32, lib.band_fwd_bf16):
                fn.argtypes = args
                fn.restype = ctypes.c_int
            lib.band_error_string.argtypes = [ctypes.c_int]
            lib.band_error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib


BAND_FWD = _CudaKernel("band_conv")


def band_fwd_core(features: torch.Tensor, rbt: torch.Tensor, w0: torch.Tensor,
                  weights: torch.Tensor, kz: int, block: int,
                  window: int) -> torch.Tensor:
    """K1: banded forward core, (N, Cin) x (K^3, Cin, Cout) -> (N, Cout) f32.

    Entries outside their window are dropped (the caller adds the overflow
    residual). CPU tensors take ``band_fwd_core_plain``; CUDA tensors launch
    ``csrc/band_conv.cu`` and raise on anything it does not take."""
    if features.device.type == "cpu":
        return band_fwd_core_plain(features, rbt, w0, weights, kz, block, window)
    if features.device.type != "cuda":
        raise ValueError(f"band_fwd_core: unsupported device {features.device}")
    if torch.is_grad_enabled() and (features.requires_grad
                                    or weights.requires_grad):
        raise NotImplementedError(
            "band_fwd_core: the CUDA band conv has no backward yet (K2/K3)")
    n, cin = features.shape
    k3, cin_w, cout = weights.shape
    npad = rbt.shape[0]
    if features.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"band_fwd_core: features dtype {features.dtype}")
    if weights.dtype != features.dtype:
        raise TypeError("band_fwd_core: weights and features dtypes differ")
    if rbt.dtype != torch.int32 or w0.dtype != torch.int32:
        raise TypeError("band_fwd_core: rbt and w0 must be int32")
    if cin_w != cin or rbt.shape != (npad, k3) or npad < n or k3 % kz:
        raise ValueError("band_fwd_core: inconsistent shapes "
                         f"{tuple(features.shape)} {tuple(rbt.shape)} "
                         f"{tuple(weights.shape)}")
    if w0.shape != (k3 // kz, npad // block) or npad % block:
        raise ValueError(f"band_fwd_core: w0 shape {tuple(w0.shape)}")
    tensors = (features, rbt, w0, weights)
    if any(t.device != features.device for t in tensors):
        raise ValueError("band_fwd_core: tensors on different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("band_fwd_core: tensors must be contiguous")
    out = torch.empty((n, cout), dtype=torch.float32, device=features.device)
    if n == 0 or cout == 0:
        return out
    lib = BAND_FWD.lib()
    fn = lib.band_fwd_f32 if features.dtype == torch.float32 else lib.band_fwd_bf16
    with torch.cuda.device(features.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(features.data_ptr(), rbt.data_ptr(), w0.data_ptr(),
                 weights.data_ptr(), out.data_ptr(), n, cin, cout, k3, kz,
                 npad // block, block, window, stream)
    if err != 0:
        raise RuntimeError("band_fwd_core: launch failed: "
                           + lib.band_error_string(err).decode())
    BAND_FWD.launches += 1
    return out


def band_fwd_core_plain(features: torch.Tensor, rbt: torch.Tensor,
                        w0: torch.Tensor, weights: torch.Tensor, kz: int,
                        block: int, window: int) -> torch.Tensor:
    """Plain PyTorch version of K1: per tap, a masked row gather and a matmul.
    The loop keeps the transient at (N, Cin); a batched gather over all taps
    would materialize 27 x N x Cin."""
    n = features.shape[0]
    k3, _, cout = weights.shape
    rows = torch.arange(n, device=features.device)
    blk = torch.div(rows, block, rounding_mode="floor")
    zero = torch.zeros((), dtype=features.dtype, device=features.device)
    out = torch.zeros((n, cout), dtype=torch.float32, device=features.device)
    for t in range(k3):
        j = rbt[:n, t].to(torch.int64)
        pos = j - w0[t // kz][blk]
        live = (j >= 0) & (pos >= 0) & (pos < window)
        g = torch.where(live[:, None], features[j.clamp(min=0)], zero)
        out += (g @ weights[t]).float()
    return out


# ------------------------------------------------------------------ wrappers


def _overflow_residual(src, ov_src, ov_dst, order, counts, w_taps, n_out,
                       compute_dtype):
    """Budgeted overflow contributions: rows ``src[ov_src[e]] @ w_taps[t_e]``
    added at ``ov_dst[e]`` -> (n_out, cout) f32. The live entries, grouped by
    tap through ``order``/``counts``, get one matmul per tap."""
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
    return out.index_add_(0, i, acc)


def band_subm_conv(cfg, features: torch.Tensor, plan: BandPlan,
                   weights: torch.Tensor, out_mask: torch.Tensor,
                   compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Banded windowed submanifold conv forward. ``cfg`` = (kz, block,
    window); ``weights`` (K^3, Cin, Cout). Same contract as the plain subm
    conv over rows sorted by key; a plan whose budgets overflowed
    (``plan.ok`` False) gives all-zero output."""
    kz, block, window = cfg
    cdt = compute_dtype or features.dtype
    n = features.shape[0]
    out = band_fwd_core(features.to(cdt).contiguous(), plan.rbt, plan.w0,
                        weights.to(cdt).contiguous(), kz, block, window)
    out = out + _overflow_residual(features, plan.ov_j, plan.ov_i,
                                   plan.ov_order, plan.ov_counts, weights, n,
                                   cdt)
    out = out * plan.ok.to(torch.float32)
    out = torch.where(out_mask[:, None], out, torch.zeros((), device=out.device))
    return out.to(features.dtype)


def band_eligible(cin: int, cout: int, kernel_size) -> bool:
    """k3 subm convs take the band path at every width (the JAX package's
    ``min_cin`` is 1). Its TPU VMEM estimate is not ported: it refuses no
    width of the SpUNet-v1m1 configs."""
    k = kernel_size if isinstance(kernel_size, int) else max(kernel_size)
    return k == 3 and cin >= 1
