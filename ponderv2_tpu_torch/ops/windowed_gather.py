"""Windowed gather-GEMM sparse conv and its Hopper kernels (K4, K5).

Counterpart of ``ponderv2_tpu/ops/pallas_gather.py``. Rulebooks are per-tap
monotone over their valid entries (rows sorted by ravel key plus a
constant tap offset), so a block of ``block`` output rows reads inputs
from a narrow window. ``prepare_geometry`` groups taps ``group`` at a time
under one window of two aligned ``wb``-row blocks per (group, output
block), and reports whether every entry fell inside its window
(``covered``); an entry outside contributes zero, as the TPU kernels' one-hot
drops it, so a caller checks ``covered`` before it trusts the result.

``windowed_conv_fwd`` (K4) and ``windowed_conv_dw`` (K5) launch
``csrc/windowed_gather.cu`` on CUDA tensors, or raise; on CPU tensors they
run their ``*_plain`` versions. Both run the band conv's tensor-core tiles
(``csrc/mma_tile.cuh``), planned by ``windowed_fwd_plan`` and
``windowed_dw_plan``. With ``PONDER_WINDOWED_GATHER`` set (off by default,
as in the JAX package) the gather convs of at most 128 channels and at
least 4096 rows run them: ``ops/spconv.py:apply_sparse_conv_windowed`` and
the windowed ``subm_conv_symmetric`` (K4 forward, K5 dW, plus a residual
for the entries outside their windows), through SubMConv's ``windowed``
route and the strided / inverse convs over a rulebook
(``models/sparse_unet/layers.py``); the probe
``tools/experiments/probe_windowed_torch.py`` and ``chip_smoke.py`` (phases
12 and 23b) run them too. ``windowed_slab_fwd`` is K4's forward (its kernel, tile and
plan) over the entries of ``probe_pallas_profile.py``'s ablations (P7
V2-V4), which read the head row of each entry's 8-row slab; the same probe
entry point runs it.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .band_conv import (DX_ROWS, _cdiv, _CudaKernel, _dw_chunks, _on_cuda, _operand,
                        dw_gemm_smem, gather_gemm_smem, padded_width, tile_width)


def padded_rows(n_in: int, wb: int) -> int:
    """Rows the feature array is padded to: one whole window past the data."""
    return (_cdiv(n_in, wb) + 1) * wb


class WindowGeometry(NamedTuple):
    """``rbb`` (K3, nb, 1, block) int32 tap blocks, -1-padded; ``w0`` (G, nb)
    int32 window block index per (group, output block); ``covered`` () bool:
    every entry of every (group, block) fits its window."""

    rbb: torch.Tensor
    w0: torch.Tensor
    covered: torch.Tensor


def prepare_geometry(rulebook: torch.Tensor, n_in: int, block: int, wb: int,
                     group: int) -> WindowGeometry:
    """Group taps [g * group, (g + 1) * group) under shared per-block
    windows; integer-equal to the JAX ``prepare_geometry``."""
    k3, n_out = rulebook.shape
    if k3 % group:
        raise ValueError(f"group {group} does not divide {k3} taps")
    ngroups = k3 // group
    nb = _cdiv(n_out, block)
    rbb = torch.full((k3, nb * block), -1, dtype=torch.int32, device=rulebook.device)
    rbb[:, :n_out] = rulebook
    rbb = rbb.reshape(k3, nb, 1, block)
    grouped = rbb.reshape(ngroups, group, nb, block).to(torch.int64)
    valid = grouped >= 0
    big = torch.iinfo(torch.int32).max
    mn = torch.where(valid, grouped, big).amin(dim=(1, 3))  # (G, nb)
    mx = torch.where(valid, grouped, -1).amax(dim=(1, 3))
    n_pad = padded_rows(n_in, wb)
    w0 = torch.div(torch.where(mn == big, 0, mn), wb, rounding_mode="floor")
    w0 = w0.clamp(0, n_pad // wb - 2)
    covered = (mx < (w0 + 2) * wb).all()
    return WindowGeometry(rbb, w0.to(torch.int32), covered)


def pad_features(features: torch.Tensor, n_pad: int, dtype: torch.dtype) -> torch.Tensor:
    """Cast and zero-pad the rows to ``n_pad``: (n_pad, C). The JAX version
    also views it as (n_pad / 8, 8 C) for the TPU's slab gather; the kernels
    here read rows directly."""
    n, c = features.shape
    out = torch.zeros((n_pad, c), dtype=dtype, device=features.device)
    out[:n] = features.to(dtype)
    return out


WINDOWED_FWD = _CudaKernel("windowed_gather", "windowed_fwd", 5, 10,
                           "windowed_error_string")
WINDOWED_DW = _CudaKernel("windowed_gather", "windowed_dw", 6, 14,
                          "windowed_error_string")
WINDOWED_SLAB_FWD = _CudaKernel("windowed_gather", "windowed_slab_fwd", 5, 12,
                                "windowed_error_string", dtypes=(torch.bfloat16,))
KERNELS = (WINDOWED_FWD, WINDOWED_DW)
PROBE_KERNELS = (WINDOWED_SLAB_FWD,)


def build_kernels() -> None:
    """Build and bind K4, K5 and the P7 ablations' forward (one source)."""
    for k in KERNELS + PROBE_KERNELS:
        k.lib()


def _check(name: str, feats: torch.Tensor, geom: WindowGeometry, wb: int,
           group: int, other: torch.Tensor) -> None:
    """What the kernels take: f32 or bf16 operands of one dtype, int32
    geometry of matching shapes, features padded to a whole window, one
    device, contiguous."""
    k3, nb, _, block = geom.rbb.shape
    if feats.dtype not in (torch.float32, torch.bfloat16) or other.dtype != feats.dtype:
        raise TypeError(f"{name}: dtypes {feats.dtype}, {other.dtype}")
    if geom.rbb.dtype != torch.int32 or geom.w0.dtype != torch.int32:
        raise TypeError(f"{name}: rbb and w0 must be int32")
    if k3 % group or geom.w0.shape != (k3 // group, nb):
        raise ValueError(f"{name}: w0 shape {tuple(geom.w0.shape)} for {k3} taps "
                         f"in groups of {group}")
    if feats.shape[0] % wb or feats.shape[0] < 2 * wb:
        raise ValueError(f"{name}: {feats.shape[0]} feature rows is not a whole "
                         f"number (>= 2) of {wb}-row windows")
    tensors = (feats, geom.rbb, geom.w0, other)
    if any(t.device != feats.device for t in tensors):
        raise ValueError(f"{name}: tensors on different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: tensors must be contiguous")


def _tap_rows(feats: torch.Tensor, geom: WindowGeometry, t: int, wb: int,
              group: int) -> torch.Tensor:
    """Rows ``feats[rbb[t, i]]`` for every output row i, zero where the entry
    is -1 or outside its window: the plain versions' masked gather."""
    k3, nb, _, block = geom.rbb.shape
    idx = geom.rbb[t].reshape(nb, block).to(torch.int64)
    lo = (geom.w0[t // group].to(torch.int64) * wb)[:, None]
    live = (idx >= lo) & (idx < lo + 2 * wb)
    rows = feats[idx.clamp(min=0).reshape(-1)]
    return torch.where(live.reshape(-1, 1), rows, torch.zeros((), dtype=rows.dtype,
                                                             device=rows.device))


# ------------------------------------------------------------------ plans

# K4 and K5 keep per-stage sums in bf16 as in f32 (csrc/windowed_gather.cu),
# so their tiles stop at 96 columns in both dtypes: tile_width's f32 widths.
TILE_DTYPE = torch.float32


class WindowedFwdPlan(NamedTuple):
    """K4's (and the P7 forward's) launch plan on the slab tile gather_gemm
    (DX_ROWS rows a CTA, whole 16-row slabs): output column tile, padded
    widths, CTAs and the dynamic shared memory of one CTA."""

    co_tile: int
    cin_p: int
    cout_p: int
    ctas: int
    smem_bytes: int


def windowed_fwd_plan(nrows: int, cin: int, cout: int, k3: int,
                      dtype: torch.dtype) -> WindowedFwdPlan:
    """K4's launch plan for ``nrows`` output rows, ``cin`` -> ``cout``
    channels and ``k3`` taps in ``dtype``."""
    co = tile_width(cout, TILE_DTYPE)
    return WindowedFwdPlan(co_tile=co, cin_p=padded_width(cin, dtype),
                           cout_p=padded_width(cout, dtype),
                           ctas=_cdiv(nrows, DX_ROWS) * _cdiv(cout, co),
                           smem_bytes=gather_gemm_smem(co, k3, dtype))


class WindowedDwPlan(NamedTuple):
    """K5's launch plan: the swapped tile (``co_tile`` x ``ci_tile`` of
    dW[t]^T, the cotangent's columns by the gathered features'), padded
    widths, CTAs, row chunks and scratch of the two-pass reduction, and the
    dynamic shared memory of one CTA."""

    co_tile: int
    ci_tile: int
    cin_p: int
    cout_p: int
    ctas: int
    chunk: int
    nchunks: int
    scratch_bytes: int
    smem_bytes: int


def windowed_dw_plan(nrows: int, cin: int, cout: int, k3: int,
                     dtype: torch.dtype) -> WindowedDwPlan:
    """K5's launch plan for ``nrows`` output rows, ``cin`` -> ``cout``
    channels and ``k3`` taps in ``dtype``: K3's dW tile with its operands
    swapped, each side the tile width of its own channels (at least 32: 6
    or 8 input channels run a 32-wide tile), the row chunks of the band
    conv's dW reductions (``band_conv._dw_chunks``)."""
    co, ci = tile_width(cout, TILE_DTYPE), tile_width(cin, TILE_DTYPE)
    tiles = _cdiv(cout, co) * _cdiv(cin, ci)
    chunk, nchunks = _dw_chunks(nrows, cin, cout, k3, tiles)
    return WindowedDwPlan(co_tile=co, ci_tile=ci, cin_p=padded_width(cin, dtype),
                          cout_p=padded_width(cout, dtype), ctas=nchunks * k3 * tiles,
                          chunk=chunk, nchunks=nchunks,
                          scratch_bytes=nchunks * k3 * cin * cout * 4,
                          smem_bytes=dw_gemm_smem(co, ci, dtype))


def fwd_operands(feats: torch.Tensor, weights: torch.Tensor,
                 p: WindowedFwdPlan) -> Tuple[torch.Tensor, torch.Tensor]:
    """The features (n_pad, cin_p) and weights (K3, cin_p, cout_p) as the
    slab tile copies them: zero-padded to the plan's widths, contiguous and
    16-byte aligned (K4 and the P7 forward)."""
    x, w = _operand(feats, p.cin_p), _operand(weights, p.cout_p)
    if p.cin_p != feats.shape[1]:
        w = torch.nn.functional.pad(w, (0, 0, 0, p.cin_p - feats.shape[1]))
    return x, w


# ------------------------------------------------------------------ K4


def windowed_conv_fwd(feats: torch.Tensor, geom: WindowGeometry,
                      weights: torch.Tensor, wb: int, group: int) -> torch.Tensor:
    """K4: the accumulated conv output (nb * block, cout) f32 of padded
    features (n_pad, cin) and weights (K3, cin, cout), both in the compute
    dtype. CPU tensors take ``windowed_conv_fwd_plain``; CUDA tensors launch
    ``csrc/windowed_gather.cu`` (planned by ``windowed_fwd_plan``) or
    raise."""
    if not _on_cuda("windowed_conv_fwd", feats):
        return windowed_conv_fwd_plain(feats, geom, weights, wb, group)
    _check("windowed_conv_fwd", feats, geom, wb, group, weights)
    k3, nb, _, block = geom.rbb.shape
    cin = feats.shape[1]
    if weights.shape[:2] != (k3, cin):
        raise ValueError(f"windowed_conv_fwd: weights {tuple(weights.shape)} for "
                         f"{k3} taps of {cin} channels")
    cout = weights.shape[2]
    nrows = nb * block
    out = torch.empty((nrows, cout), dtype=torch.float32, device=feats.device)
    if nrows == 0 or cout == 0:
        return out
    p = windowed_fwd_plan(nrows, cin, cout, k3, feats.dtype)
    x, w = fwd_operands(feats, weights, p)
    WINDOWED_FWD.launch(feats.dtype, feats.device, x.data_ptr(), geom.rbb.data_ptr(),
                        geom.w0.data_ptr(), w.data_ptr(), out.data_ptr(), nrows, p.cin_p,
                        cout, p.cout_p, k3, nb, block, wb, group, p.co_tile)
    return out


def windowed_conv_fwd_plain(feats: torch.Tensor, geom: WindowGeometry,
                            weights: torch.Tensor, wb: int, group: int) -> torch.Tensor:
    """Plain PyTorch version of K4: per tap, a masked row gather and an f32
    matmul of the compute-dtype values."""
    k3, nb, _, block = geom.rbb.shape
    out = torch.zeros((nb * block, weights.shape[2]), dtype=torch.float32,
                      device=feats.device)
    for t in range(k3):
        out += _tap_rows(feats, geom, t, wb, group).float() @ weights[t].float()
    return out


# ------------------------------------------------------------------ P7 V2-V4


def _slab_rows(feats: torch.Tensor, geom: WindowGeometry, t: int, wb: int,
               group: int, windows: int, rebase: bool) -> torch.Tensor:
    """Rows of tap t as ``windowed_slab_fwd`` reads them, zero where the
    entry is not live: the plain version's masked gather."""
    k3, nb, _, block = geom.rbb.shape
    r = geom.rbb[t].reshape(nb, block).to(torch.int64)
    lo = (geom.w0[t // group].to(torch.int64) * wb)[:, None]
    live = (r >= lo) & (r < lo + windows * wb)
    j = (r.clamp(min=0) // 8 * 8 - (lo if rebase else 0)).clamp(0, feats.shape[0] - 1)
    return torch.where(live.reshape(-1, 1), feats[j.reshape(-1)],
                       torch.zeros((), dtype=feats.dtype, device=feats.device))


def windowed_slab_fwd(feats: torch.Tensor, geom: WindowGeometry,
                      weights: torch.Tensor, wb: int, group: int, windows: int = 2,
                      rebase: bool = False) -> torch.Tensor:
    """The ablations of ``probe_pallas_profile.py`` (P7): K4's forward, but an
    entry ``r`` is live inside ``windows`` (1 or 2) blocks of ``wb`` rows from
    its window start ``lo`` and reads the head row of its 8-row slab,
    ``8 * (r // 8)``, less ``lo`` with ``rebase``:

        V2 (kern_norbc, dynamic windows): windows=2
        V3 (kern_norbc, static windows):  windows=2, rebase=True
        V4 (kern_lo, one window):         windows=1

    ``w0`` >= 0 and ``wb`` a multiple of 8, as in the probe. Padded bf16
    features (n_pad, cin), weights (K3, cin, cout) -> (nb * block, cout) f32
    (the probe's one dtype: the kernel reads bf16 only). CPU
    tensors take ``windowed_slab_fwd_plain``; CUDA tensors launch K4's
    kernel of ``csrc/windowed_gather.cu`` over the slab heads (planned by
    ``windowed_fwd_plan``, operands padded as K4's) or raise."""
    if windows not in (1, 2) or wb % 8:
        raise ValueError(f"windowed_slab_fwd: {windows} windows of {wb} rows")
    if not _on_cuda("windowed_slab_fwd", feats):
        return windowed_slab_fwd_plain(feats, geom, weights, wb, group, windows, rebase)
    _check("windowed_slab_fwd", feats, geom, wb, group, weights)
    if feats.dtype != torch.bfloat16:
        raise TypeError(f"windowed_slab_fwd: {feats.dtype}, not bfloat16")
    k3, nb, _, block = geom.rbb.shape
    cin = feats.shape[1]
    if weights.shape[:2] != (k3, cin):
        raise ValueError(f"windowed_slab_fwd: weights {tuple(weights.shape)} for "
                         f"{k3} taps of {cin} channels")
    cout = weights.shape[2]
    nrows = nb * block
    out = torch.empty((nrows, cout), dtype=torch.float32, device=feats.device)
    if nrows == 0 or cout == 0:
        return out
    p = windowed_fwd_plan(nrows, cin, cout, k3, feats.dtype)
    x, w = fwd_operands(feats, weights, p)
    WINDOWED_SLAB_FWD.launch(feats.dtype, feats.device, x.data_ptr(), geom.rbb.data_ptr(),
                             geom.w0.data_ptr(), w.data_ptr(), out.data_ptr(), nrows,
                             p.cin_p, cout, p.cout_p, k3, nb, block, wb, group, windows,
                             int(rebase), p.co_tile)
    return out


def windowed_slab_fwd_plain(feats: torch.Tensor, geom: WindowGeometry,
                            weights: torch.Tensor, wb: int, group: int,
                            windows: int = 2, rebase: bool = False) -> torch.Tensor:
    """Plain PyTorch version of ``windowed_slab_fwd``: per tap, a masked
    gather of slab-head rows and an f32 matmul of the compute-dtype values."""
    k3, nb, _, block = geom.rbb.shape
    out = torch.zeros((nb * block, weights.shape[2]), dtype=torch.float32,
                      device=feats.device)
    for t in range(k3):
        out += (_slab_rows(feats, geom, t, wb, group, windows, rebase).float()
                @ weights[t].float())
    return out


# ------------------------------------------------------------------ K5

def windowed_conv_dw(feats: torch.Tensor, geom: WindowGeometry, g: torch.Tensor,
                     wb: int, group: int) -> torch.Tensor:
    """K5: dW (K3, cin, cout) f32, dW[t] = sum_i x[rbb[t, i]]^T g[i] over live
    entries; ``g`` (nb * block, cout) in the features' dtype. CPU tensors
    take ``windowed_conv_dw_plain``; CUDA tensors launch
    ``csrc/windowed_gather.cu`` (planned by ``windowed_dw_plan``: per row
    chunk, dW[t]^T's partials, then their sum in chunk order, transposed)
    or raise."""
    if not _on_cuda("windowed_conv_dw", feats):
        return windowed_conv_dw_plain(feats, geom, g, wb, group)
    _check("windowed_conv_dw", feats, geom, wb, group, g)
    k3, nb, _, block = geom.rbb.shape
    cin, cout = feats.shape[1], g.shape[1]
    nrows = nb * block
    if g.shape[0] != nrows:
        raise ValueError(f"windowed_conv_dw: g {tuple(g.shape)} for {nrows} rows")
    dev = feats.device
    if cin == 0 or cout == 0:
        return torch.zeros((k3, cin, cout), dtype=torch.float32, device=dev)
    dw = torch.empty((k3, cin, cout), dtype=torch.float32, device=dev)
    p = windowed_dw_plan(nrows, cin, cout, k3, feats.dtype)
    x, gp = _operand(feats, p.cin_p), _operand(g, p.cout_p)
    partial = torch.empty((p.nchunks, k3, cout, cin), dtype=torch.float32, device=dev)
    WINDOWED_DW.launch(feats.dtype, dev, gp.data_ptr(), x.data_ptr(), geom.rbb.data_ptr(),
                       geom.w0.data_ptr(), partial.data_ptr(), dw.data_ptr(), nrows, cin,
                       cout, p.cin_p, p.cout_p, k3, nb, block, wb, group, p.chunk,
                       p.nchunks, p.co_tile, p.ci_tile)
    return dw


def windowed_conv_dw_plain(feats: torch.Tensor, geom: WindowGeometry,
                           g: torch.Tensor, wb: int, group: int) -> torch.Tensor:
    """Plain PyTorch version of K5: per tap, a masked row gather and one TN
    f32 matmul of the compute-dtype values."""
    k3 = geom.rbb.shape[0]
    gf = g.float()
    return torch.stack([_tap_rows(feats, geom, t, wb, group).float().T @ gf
                        for t in range(k3)])
