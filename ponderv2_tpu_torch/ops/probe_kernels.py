"""Window reads and small grouped constructs, and their Hopper kernels
(families C and D of the probe kernels).

Counterpart of the Pallas probe bodies that the TPU windowed conv's compile
bisects and cost ablations launched (``tools/experiments/``):

- family C, window copy-accumulate: ``window_copy_sum`` (``k0`` of
  ``probe_pallas_bisect.py``, P3; ``a.k``-``d.k`` of
  ``probe_pallas_bisect2.py``, P4) and ``window_head_sum``
  (``kern_dma2`` of ``probe_pallas_profile.py``, P7 V5);
- family D, the grouped-kernel constructs of ``probe_pallas_bisect3.py``
  (P5): ``slab_slots`` (``ka``), ``lane_concat`` (``kb``), ``sum_rows``
  (``kc2``) and ``tile_matmul`` (``kd``).

Each function launches its kernel of ``csrc/probe_kernels.cu`` on CUDA
tensors, or raises; on CPU tensors it runs its ``*_plain`` version. The
kernels read the probes' one float type, bf16, or int32. Window
tables keep the probes' layout: ``w0`` (taps, nb) int32 block indices, in
any strides (a table that repeats over the taps is an ``expand``). The
probe entry point ``tools/experiments/probe_bisect_torch.py``,
``probe_windowed_torch.py`` and ``chip_smoke.py`` run them.
"""

from __future__ import annotations

from typing import Optional

import torch

from .band_conv import _CudaKernel, _cdiv, _on_cuda, _operand

_ERR = "probe_error_string"
# the probes read bf16 features (P3, P4, P5 kb/kd, P7 V5) or int32 rows (P5
# ka/kc2): one entry point each
_BF16 = (torch.bfloat16,)
WINDOW_COPY_SUM = _CudaKernel("probe_kernels", "window_copy_sum", 4, 10, _ERR, _BF16)
WINDOW_HEAD_SUM = _CudaKernel("probe_kernels", "window_head_sum", 3, 8, _ERR, _BF16)
SLAB_SLOTS = _CudaKernel("probe_kernels", "slab_slots", 2, 1, _ERR, dtypes=())
LANE_CONCAT = _CudaKernel("probe_kernels", "lane_concat", 2, 4, _ERR, _BF16)
SUM_ROWS = _CudaKernel("probe_kernels", "sum_rows", 2, 2, _ERR, dtypes=())
TILE_MATMUL = _CudaKernel("probe_kernels", "tile_matmul", 3, 4, _ERR, _BF16)
KERNELS = (WINDOW_COPY_SUM, WINDOW_HEAD_SUM, SLAB_SLOTS, LANE_CONCAT, SUM_ROWS,
           TILE_MATMUL)


def build_kernels() -> None:
    """Build (one source) and bind every kernel of this module."""
    for k in KERNELS:
        k.lib()


def _check(name: str, floats=(), ints=(), tables=()) -> None:
    """bf16 ``floats`` and int32 ``ints``, contiguous; int32 ``tables`` in
    any strides; all on one device."""
    tensors = (*floats, *ints, *tables)
    if any(t.dtype != torch.bfloat16 for t in floats):
        raise TypeError(f"{name}: dtypes {[t.dtype for t in floats]}, not bfloat16")
    if any(t.dtype != torch.int32 for t in (*ints, *tables)):
        raise TypeError(f"{name}: index tensors must be int32")
    if any(t.device != tensors[0].device for t in tensors):
        raise ValueError(f"{name}: tensors on different devices")
    if not all(t.is_contiguous() for t in (*floats, *ints)):
        raise ValueError(f"{name}: tensors must be contiguous")


def _window_rows(x: torch.Tensor, w0: torch.Tensor, t: int, wb: int,
                 offset) -> torch.Tensor:
    """Rows ``x[w0[t, j] * wb + offset]`` in f32 for every block j (and every
    offset of a (1, k) ``offset``), zero where the row lies outside ``x``."""
    r = (w0[t].to(torch.int64) * wb)[:, None] + offset
    ok = (r >= 0) & (r < x.shape[0])
    rows = x[r.clamp(0, max(x.shape[0] - 1, 0))].float()
    return torch.where(ok[..., None], rows, torch.zeros((), device=x.device))


# ------------------------------------------------------------------ family C


def window_copy_sum(x: torch.Tensor, w0: torch.Tensor, wb: int, block: int,
                    add: Optional[torch.Tensor] = None) -> torch.Tensor:
    """P3 ``k0``, P4 A-D: ``out[j * block + i] = sum_t (x[w0[t, j] * wb + i]
    + add[t, j])`` in f32, taps in order, with ``w0`` and ``add`` (taps, nb)
    int32 tables in any strides (``add`` absent: no add term); a window row
    outside ``x`` reads as zero. bf16 ``x`` (rows, C) -> (nb * block, C) f32. CPU
    tensors take ``window_copy_sum_plain``; CUDA tensors launch
    ``csrc/probe_kernels.cu`` or raise."""
    if w0.dim() != 2 or (add is not None and add.shape != w0.shape):
        raise ValueError(f"window_copy_sum: w0 {tuple(w0.shape)}, add "
                         f"{None if add is None else tuple(add.shape)}")
    if not _on_cuda("window_copy_sum", x):
        return window_copy_sum_plain(x, w0, wb, block, add)
    tables = (w0,) if add is None else (w0, add)
    _check("window_copy_sum", floats=(x,), tables=tables)
    taps, nb = w0.shape
    rows_x, c = x.shape
    out = torch.empty((nb * block, c), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    a_s = (0, 0) if add is None else add.stride()
    WINDOW_COPY_SUM.launch(x.dtype, x.device, x.data_ptr(), w0.data_ptr(),
                           None if add is None else add.data_ptr(), out.data_ptr(),
                           rows_x, c, taps, nb, block, wb, *w0.stride(), *a_s)
    return out


def window_copy_sum_plain(x: torch.Tensor, w0: torch.Tensor, wb: int, block: int,
                          add: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of ``window_copy_sum``, summing as the kernel
    does: per tap, (window row + add) added to the f32 total."""
    taps, nb = w0.shape
    rows_x, c = x.shape
    out = torch.zeros((nb * block, c), dtype=torch.float32, device=x.device)
    i = torch.arange(block, device=x.device)[None]
    for t in range(taps):
        v = _window_rows(x, w0, t, wb, i).reshape(nb * block, c)
        if add is not None:
            v = v + add[t].float().repeat_interleave(block)[:, None]
        out += v
    return out


def window_head_sum(x: torch.Tensor, w0: torch.Tensor, wb: int,
                    block: int) -> torch.Tensor:
    """P7 V5: ``out[j * block + i, :] = sum_t (R(sum_c x[lo, c]) + R(sum_c
    x[lo + wb, c]))`` with ``lo = w0[t, j] * wb``: each window's head row
    summed in f32 over its columns in order and rounded to bf16, ``x``'s
    dtype (``R``, as ``jnp.sum`` of a bf16 array gives bf16), then added in f32,
    taps in order. ``w0`` (taps, nb) int32 in any strides -> (nb * block, C)
    f32. CPU tensors take ``window_head_sum_plain``; CUDA tensors launch
    ``csrc/probe_kernels.cu`` or raise."""
    if w0.dim() != 2:
        raise ValueError(f"window_head_sum: w0 {tuple(w0.shape)}")
    if not _on_cuda("window_head_sum", x):
        return window_head_sum_plain(x, w0, wb, block)
    _check("window_head_sum", floats=(x,), tables=(w0,))
    taps, nb = w0.shape
    rows_x, c = x.shape
    out = torch.empty((nb * block, c), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    WINDOW_HEAD_SUM.launch(x.dtype, x.device, x.data_ptr(), w0.data_ptr(),
                           out.data_ptr(), rows_x, c, taps, nb, block, wb, *w0.stride())
    return out


def window_head_sums_plain(x: torch.Tensor, w0: torch.Tensor, wb: int) -> torch.Tensor:
    """The (taps, nb, 2) rounded head sums of ``window_head_sum``: the rows
    ``lo`` and ``lo + wb`` summed over their columns in order (zero outside
    ``x``) and rounded to ``x``'s dtype, as f32."""
    offsets = (torch.arange(2, device=x.device) * wb)[None]
    heads = torch.stack([_window_rows(x, w0, t, wb, offsets)
                         for t in range(w0.shape[0])])  # (taps, nb, 2, C)
    s = torch.zeros(heads.shape[:3], dtype=torch.float32, device=x.device)
    for k in range(x.shape[1]):
        s = s + heads[..., k]
    return s.to(x.dtype).float()


def window_head_sum_plain(x: torch.Tensor, w0: torch.Tensor, wb: int,
                          block: int) -> torch.Tensor:
    """Plain PyTorch version of ``window_head_sum``, summing in the kernel's
    order."""
    heads = window_head_sums_plain(x, w0, wb)
    total = torch.zeros(w0.shape[1], dtype=torch.float32, device=x.device)
    for t in range(w0.shape[0]):
        total = total + (heads[t, :, 0] + heads[t, :, 1])
    return total.repeat_interleave(block)[:, None].expand(-1, x.shape[1]).contiguous()


# ------------------------------------------------------------------ family D


def slab_slots(rb: torch.Tensor) -> torch.Tensor:
    """P5 ``ka`` (the identity-matmul transpose of a row into a column):
    ``out[b, r] = rb[0, b] % 8 + 1`` where ``rb[0, b] >= 0``, else 0, for
    r < 8, from the first row of an int32 (rows, B) ``rb`` -> (B, 8) f32. CPU
    tensors take ``slab_slots_plain``; CUDA tensors launch
    ``csrc/probe_kernels.cu`` or raise. The kernel gives a thread one
    column: one load of its entry, its output row written by two 16-byte
    stores (the output, made here, is 16-byte aligned; the launcher refuses
    one that is not)."""
    if rb.dim() != 2 or rb.shape[0] == 0:
        raise ValueError(f"slab_slots: rb {tuple(rb.shape)} has no first row")
    if not _on_cuda("slab_slots", rb):
        return slab_slots_plain(rb)
    _check("slab_slots", ints=(rb,))
    b = rb.shape[1]
    if b > torch.iinfo(torch.int32).max:  # the kernel's column index is 32-bit
        raise ValueError(f"slab_slots: {b} columns do not fit in an int32")
    out = torch.empty((b, 8), dtype=torch.float32, device=rb.device)
    if b:
        SLAB_SLOTS.launch(None, rb.device, rb.data_ptr(), out.data_ptr(), b)
    return out


def slab_slots_plain(rb: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``slab_slots``."""
    v = torch.where(rb[0] >= 0, rb[0] % 8 + 1, 0).float()
    return v[:, None].expand(-1, 8).contiguous()


def lane_concat(x: torch.Tensor, width: int, pieces: int) -> torch.Tensor:
    """P5 ``kb``: the concatenation of ``pieces`` column blocks of ``width``,
    piece p being x's block ``p mod (W / width)`` (``kb``: the 8 blocks of a
    (B, 8 C) x, then its first again), bf16 in, f32 -> (rows, pieces *
    width); that is ``out[:, c] = x[:, c mod W]``. CPU tensors take
    ``lane_concat_plain``; CUDA tensors launch ``csrc/probe_kernels.cu`` or
    raise. The kernel gives a thread one 16-byte piece of x (8 columns; one
    column where ``width`` is not a multiple of 8 or x is not 16-byte
    aligned), read once and written to every output column it feeds."""
    rows, w_in = x.shape
    if width <= 0 or w_in % width:
        raise ValueError(f"lane_concat: width {width} does not divide {w_in} columns")
    if not _on_cuda("lane_concat", x):
        return lane_concat_plain(x, width, pieces)
    _check("lane_concat", floats=(x,))
    out = torch.empty((rows, width * pieces), dtype=torch.float32, device=x.device)
    if out.numel():
        LANE_CONCAT.launch(x.dtype, x.device, x.data_ptr(), out.data_ptr(), rows, w_in,
                           width, pieces)
    return out


def lane_concat_plain(x: torch.Tensor, width: int, pieces: int) -> torch.Tensor:
    """Plain PyTorch version of ``lane_concat``."""
    n_src = x.shape[1] // width
    return torch.cat([x[:, p % n_src * width:(p % n_src + 1) * width]
                      for p in range(pieces)], 1).float()


def sum_rows(rb: torch.Tensor, rows: int) -> torch.Tensor:
    """P5 ``kc2``: ``out[0, b] = sum_{t < rows} rb[t, b]`` in f32, rows in
    order, for an int32 (R, B) ``rb`` -> (1, B) f32. CPU tensors take
    ``sum_rows_plain``; CUDA tensors launch ``csrc/probe_kernels.cu`` or
    raise. The kernel gives a thread one column, whose loads of up to 16
    rows all go out before their adds."""
    if not 0 <= rows <= rb.shape[0]:
        raise ValueError(f"sum_rows: {rows} rows of {rb.shape[0]}")
    if not _on_cuda("sum_rows", rb):
        return sum_rows_plain(rb, rows)
    _check("sum_rows", ints=(rb,))
    b = rb.shape[1]
    out = torch.empty((1, b), dtype=torch.float32, device=rb.device)
    if b:
        SUM_ROWS.launch(None, rb.device, rb.data_ptr(), out.data_ptr(), rows, b)
    return out


def sum_rows_plain(rb: torch.Tensor, rows: int) -> torch.Tensor:
    """Plain PyTorch version of ``sum_rows``."""
    acc = torch.zeros(rb.shape[1], dtype=torch.float32, device=rb.device)
    for t in range(rows):
        acc = acc + rb[t].float()
    return acc[None]


# kd's tile (csrc/probe_kernels.cu): 16 rows x 32 columns per CTA
KD_ROWS, KD_COLS = 16, 32


def tile_matmul_ctas(m: int, n: int) -> int:
    """CTAs of one ``tile_matmul`` launch: 32 at the probe's 512 x 32."""
    return _cdiv(m, KD_ROWS) * _cdiv(n, KD_COLS)


def tile_matmul(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """P5 ``kd``: ``g @ w[0]`` of (M, K) ``g`` and the (1, K, N) grouped
    weight block ``w``, bf16 products summed in f32 -> (M, N) f32, on
    K2's tensor-core tile (``csrc/mma_tile.cuh``; one tap, every row its
    own; K and N zero-padded to multiples of 8). CPU tensors take
    ``tile_matmul_plain``; CUDA tensors launch ``csrc/probe_kernels.cu`` or
    raise."""
    m, k = g.shape
    if w.dim() != 3 or w.shape[:2] != (1, k):
        raise ValueError(f"tile_matmul: w {tuple(w.shape)} for g {tuple(g.shape)}")
    if not _on_cuda("tile_matmul", g):
        return tile_matmul_plain(g, w)
    _check("tile_matmul", floats=(g, w))
    n = w.shape[2]
    out = torch.empty((m, n), dtype=torch.float32, device=g.device)
    if out.numel():
        kp, np_ = _cdiv(k, 8) * 8, _cdiv(n, 8) * 8
        gp = _operand(g, kp)
        wp = _operand(w[0], np_)
        if kp != k:
            wp = torch.nn.functional.pad(wp, (0, 0, 0, kp - k))
        TILE_MATMUL.launch(g.dtype, g.device, gp.data_ptr(), wp.data_ptr(),
                           out.data_ptr(), m, kp, n, np_)
    return out


def tile_matmul_plain(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``tile_matmul``: the same values multiplied
    and summed in f32."""
    return g.float() @ w[0].float()
