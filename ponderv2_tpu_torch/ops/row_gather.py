"""Row gather-sum and its Hopper kernel (family A of the probe kernels).

Counterpart of the Pallas probe bodies that gather rows inside a TPU
kernel: ``tools/experiments/probe_pallas_gather.py``'s ``kernel_take`` (P1,
a ``jnp.take`` of 1024-row tiles) and ``probe_full_length``'s ``kernel``
(P2, the same over the full length), and ``probe_pallas_bisect.py``'s
``k1`` (P3), which picks rows out of one window per (tap, output block)
with a one-hot matmul. Both functions here are one kernel,

    out[i] = sum_t [live(t, i)] feats[rows[t, i]]   (f32, taps in order)

``row_gather`` (one tap, every entry >= 0 live) and ``window_gather_sum``
(live inside the entry's window) launch ``csrc/row_gather.cu`` on CUDA
tensors, or raise; on CPU tensors they run their ``*_plain`` versions. The
probe entry points ``tools/experiments/probe_gather_torch.py`` and
``probe_bisect_torch.py`` and ``chip_smoke.py`` run them.
"""

from __future__ import annotations

from typing import Optional

import torch

from .band_conv import _CudaKernel, _on_cuda

GATHER_SUM = _CudaKernel("row_gather", "gather_sum", 4, 7, "gather_error_string")
KERNELS = (GATHER_SUM,)


def build_kernels() -> None:
    """Build and bind the gather-sum kernel."""
    GATHER_SUM.lib()


def _gather_sum(name: str, feats: torch.Tensor, rows: torch.Tensor,
                w0: Optional[torch.Tensor], block: int, wb: int) -> torch.Tensor:
    """Launch the kernel over (taps, n) int32 ``rows`` and, where given, the
    (taps, nb) int32 window table ``w0``: -> (n, C) f32."""
    tables = (rows,) if w0 is None else (rows, w0)
    if feats.dtype not in (torch.float32, torch.bfloat16) or feats.dim() != 2:
        raise TypeError(f"{name}: features {feats.dtype} of shape {tuple(feats.shape)}")
    if any(t.dtype != torch.int32 for t in tables):
        raise TypeError(f"{name}: row and window tables must be int32")
    if any(t.device != feats.device for t in tables):
        raise ValueError(f"{name}: tensors on different devices")
    if not all(t.is_contiguous() for t in (feats, *tables)):
        raise ValueError(f"{name}: tensors must be contiguous")
    taps, n = rows.shape
    c = feats.shape[1]
    out = torch.empty((n, c), dtype=torch.float32, device=feats.device)
    if n == 0 or c == 0:
        return out
    per_load = 16 // feats.element_size()
    vec = int(c % per_load == 0 and feats.data_ptr() % 16 == 0)
    GATHER_SUM.launch(feats.dtype, feats.device, feats.data_ptr(), rows.data_ptr(),
                      None if w0 is None else w0.data_ptr(), out.data_ptr(), n, c,
                      taps, 1 if w0 is None else w0.shape[1], block, wb, vec)
    return out


# ------------------------------------------------------------------ P1, P2


def row_gather(feats: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """P1/P2: ``feats[idx]`` in f32, (idx.numel(), C), for an int32 ``idx``
    of any shape (the probes view it as (16, 8, 128) tiles or (128, 128));
    an index of -1 gives a zero row. CPU tensors take ``row_gather_plain``;
    CUDA tensors launch ``csrc/row_gather.cu`` or raise."""
    if not _on_cuda("row_gather", feats):
        return row_gather_plain(feats, idx)
    rows = idx.reshape(1, -1)
    return _gather_sum("row_gather", feats, rows, None, max(rows.shape[1], 1), 0)


def row_gather_plain(feats: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``row_gather``."""
    j = idx.reshape(-1).to(torch.int64)
    rows = feats[j.clamp(min=0)].float()
    return torch.where((j >= 0)[:, None], rows, torch.zeros((), device=feats.device))


# ------------------------------------------------------------------ P3 k1


def _window_shapes(name: str, rb: torch.Tensor, w0: torch.Tensor,
                   block: int) -> torch.Tensor:
    """``rb`` as (taps, nb * block) after checking it against ``w0``."""
    if w0.dim() != 2 or rb.shape[0] != w0.shape[0] or rb.numel() != w0.numel() * block:
        raise ValueError(f"{name}: rb {tuple(rb.shape)} and w0 {tuple(w0.shape)} "
                         f"for blocks of {block}")
    return rb.reshape(rb.shape[0], -1)


def window_gather_sum(feats: torch.Tensor, rb: torch.Tensor, w0: torch.Tensor,
                      block: int, wb: int) -> torch.Tensor:
    """P3 ``k1``: ``out[i] = sum_t [lo <= r < lo + wb] feats[r]`` in f32, taps
    in order, with ``r = rb[t, i]`` and ``lo = w0[t, i // block] * wb``.
    ``rb`` holds taps x nb x block int32 entries (-1 = absent) in any shape
    led by the taps (the probe's flat (taps * nb * block,) blocks viewed as
    (taps, nb, block)), ``w0`` (taps, nb) int32 -> (nb * block, C) f32. CPU
    tensors take ``window_gather_sum_plain``; CUDA tensors launch
    ``csrc/row_gather.cu`` or raise."""
    rows = _window_shapes("window_gather_sum", rb, w0, block)
    if not _on_cuda("window_gather_sum", feats):
        return window_gather_sum_plain(feats, rb, w0, block, wb)
    return _gather_sum("window_gather_sum", feats, rows, w0, block, wb)


def window_gather_sum_plain(feats: torch.Tensor, rb: torch.Tensor, w0: torch.Tensor,
                            block: int, wb: int) -> torch.Tensor:
    """Plain PyTorch version of ``window_gather_sum``: per tap, a masked row
    gather added in f32, taps in order as the kernel adds them."""
    rows = _window_shapes("window_gather_sum", rb, w0, block).to(torch.int64)
    lo = (w0.to(torch.int64) * wb).repeat_interleave(block, 1)
    out = torch.zeros((rows.shape[1], feats.shape[1]), dtype=torch.float32,
                      device=feats.device)
    zero = torch.zeros((), device=feats.device)
    for t in range(rows.shape[0]):
        r = rows[t]
        live = (r >= 0) & (r >= lo[t]) & (r < lo[t] + wb)
        out += torch.where(live[:, None], feats[r.clamp(min=0)].float(), zero)
    return out
