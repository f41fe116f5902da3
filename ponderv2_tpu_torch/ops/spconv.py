"""Sparse 3D convolution: exact rulebooks + gather-GEMM accumulate (forward).

Counterpart of ``ponderv2_tpu/ops/spconv.py``. A *rulebook* is a ``(K^3,
N_out)`` int32 gather-index array: entry ``[k, i]`` is the input row feeding
output row ``i`` through kernel tap ``k`` (-1 when the tap is inactive),
built from exact sorted-key lookups (``ops.hashing``). Kernel taps are
enumerated as ``itertools.product(range(kx), range(ky), range(kz))``, the
memory order of a dense ``(kx, ky, kz)`` kernel.

The JAX package's slab layout (``SubmPlan.r0/selp``, ``subm_conv_slab``) is
a TPU gather-count layout. The port keeps ``SubmPlan`` as the carrier of a
level's rulebook, its ``sorted_ok`` contract flag and its band plan, and
computes the slab conv's function with the plain gather conv
(``subm_conv_symmetric``, with the mirrored-gather backward). The packed
strided/inverse convs differentiate through plain autograd, as the JAX
package leaves them to XLA's autodiff.
"""

from __future__ import annotations

import itertools
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from . import hashing
from .sparse import unique_voxels


def _triple(v) -> Tuple[int, int, int]:
    if isinstance(v, (tuple, list)):
        assert len(v) == 3
        return tuple(int(x) for x in v)
    return (int(v),) * 3


def kernel_offsets(kernel_size) -> list:
    kx, ky, kz = _triple(kernel_size)
    return list(itertools.product(range(kx), range(ky), range(kz)))


def _tap_keys(coords, offsets, stride, padding, spatial_shape) -> torch.Tensor:
    """Ravel keys of the input cell each output row queries through each
    kernel tap: ``(T, N)`` int64, ``INVALID_KEY`` for padding rows and for
    queries outside the spatial shape."""
    X, Y, Z = (int(s) for s in spatial_shape)
    dev = coords.device
    c = coords.to(torch.int64)
    b = c[:, 0]
    s = torch.tensor(_triple(stride), dtype=torch.int64, device=dev)
    p = torch.tensor(_triple(padding), dtype=torch.int64, device=dev)
    off = torch.tensor(offsets, dtype=torch.int64, device=dev).reshape(-1, 3)
    q = c[None, :, 1:4] * s - p + off[:, None, :]  # (T, N, 3)
    dims = torch.tensor([X, Y, Z], dtype=torch.int64, device=dev)
    valid = (b >= 0)[None] & (q >= 0).all(-1) & (q < dims).all(-1)
    key = ((b[None] * X + q[..., 0]) * Y + q[..., 1]) * Z + q[..., 2]
    return torch.where(valid, key, torch.full_like(key, hashing.INVALID_KEY))


def build_subm_rulebook(
    coords: torch.Tensor,
    spatial_shape: Sequence[int],
    batch_size: int,
    kernel_size,
) -> torch.Tensor:
    """Submanifold conv rulebook: in/out coords identical, stride 1, centered.

    Returns (K^3, N) int32 gather indices into the input rows. For unique
    coordinates this equals every route of the JAX builder (dense-grid,
    bitmap-run and mirrored sorted-key lookups): they are exact lookups of
    the same queries."""
    k = _triple(kernel_size)
    pad = tuple((s - 1) // 2 for s in k)
    table = hashing.build_table(coords, spatial_shape, batch_size)
    keys = _tap_keys(coords, kernel_offsets(k), 1, pad, spatial_shape)
    return hashing.lookup_keys(table, keys)


def subm_sorted_ok(coords: torch.Tensor, spatial_shape: Sequence[int]) -> torch.Tensor:
    """The JAX slab plan's ``sorted_ok`` flag (``spconv.py:300-310``): every
    valid in-shape row's rank among the occupied cells equals its row index,
    i.e. rows are unique, ascending by key, with padding last."""
    keys = hashing.ravel_key(coords, spatial_shape)
    rank = torch.searchsorted(torch.sort(keys).values, keys)
    arange = torch.arange(keys.shape[0], device=keys.device)
    return ((rank == arange) | (keys == hashing.INVALID_KEY)).all()


class SubmPlan(NamedTuple):
    """A level's submanifold plan (JAX ``SubmPlan`` minus its slab layout).

    - ``legacy``: (K^3, N) int32 exact rulebook.
    - ``sorted_ok``: () bool - rows passed the rank == row check; where the
      JAX package would take its slab conv, a False flag zeroes the output.
    - ``band``: optional ``ops.band_conv.BandPlan`` shared by the level's
      band convs (``attach_band_plan``).
    """

    legacy: torch.Tensor
    sorted_ok: torch.Tensor
    band: Optional[tuple] = None


def build_subm_plan(
    coords: torch.Tensor,
    spatial_shape: Sequence[int],
    batch_size: int,
    kernel_size,
) -> SubmPlan:
    """The port's ``build_subm_plan``: the exact rulebook plus ``sorted_ok``.
    (The JAX stem plan skips its legacy rulebook; the port always keeps it,
    because its plain gather conv reads it.)"""
    k = _triple(kernel_size)
    assert k[2] <= 5 and all(d % 2 == 1 for d in k), (
        "slab plans support odd centered kernels with kz <= 5"
    )
    return SubmPlan(
        build_subm_rulebook(coords, spatial_shape, batch_size, k),
        subm_sorted_ok(coords, spatial_shape),
    )


_INNER_K3_OF_K5 = [
    (dx * 5 + dy) * 5 + dz
    for dx in (1, 2, 3) for dy in (1, 2, 3) for dz in (1, 2, 3)
]


def derive_inner_subm_plan(plan: SubmPlan, outer_kernel: int = 5) -> SubmPlan:
    """The k3 plan as the k5 plan's inner taps (k5 pad 2 + tap d == k3 pad 1
    + tap d-1). Gated to all-inactive when ``sorted_ok`` is False, as the
    JAX package derives it from a stem plan built without legacy."""
    assert _triple(outer_kernel) == (5, 5, 5)
    inner = plan.legacy[_INNER_K3_OF_K5]
    legacy = torch.where(plan.sorted_ok, inner, torch.full_like(inner, -1))
    return SubmPlan(legacy, plan.sorted_ok)


def inner_k3_rulebook(rulebook: torch.Tensor) -> torch.Tensor:
    """Inner k3 taps of a plain (125, N) k5 rulebook."""
    return rulebook[_INNER_K3_OF_K5]


def attach_band_plan(
    plan: SubmPlan,
    pair_budget: Optional[int] = None,
    entry_budget: Optional[int] = None,
) -> SubmPlan:
    """Attach the block-banded plan (ops.band_conv) that every band conv on
    the level shares."""
    from .band_conv import build_band_plan

    return plan._replace(
        band=build_band_plan(plan.legacy, 3, pair_budget=pair_budget,
                             entry_budget=entry_budget)
    )


def plan_contract_flags(rb) -> list:
    """The loud-failure contract flags a rulebook/plan carries:
    ``SubmPlan.sorted_ok`` and ``BandPlan.ok``."""
    flags = []
    if isinstance(rb, SubmPlan):
        flags.append(rb.sorted_ok)
        if rb.band is not None:
            flags.append(rb.band.ok)
    return flags


class StridedPlan(NamedTuple):
    out_coords: torch.Tensor  # (out_capacity, 4) int32, padded with -1
    rulebook: torch.Tensor  # (K^3, out_capacity) int32
    spatial_shape: Tuple[int, int, int]  # output spatial shape
    # packed form (k == s, p == 0 only): every input row feeds exactly one
    # (output, tap) pair: parent[i] = output row (or -1), tap[i] = kernel tap
    parent: Optional[torch.Tensor] = None  # (N_in,) int32
    tap: Optional[torch.Tensor] = None  # (N_in,) int32


def downsample_shape(spatial_shape, kernel_size, stride, padding):
    k, s, p = _triple(kernel_size), _triple(stride), _triple(padding)
    return tuple(
        (int(d) + 2 * p[i] - k[i]) // s[i] + 1 for i, d in enumerate(spatial_shape)
    )


def _floordiv(a: torch.Tensor, b: int) -> torch.Tensor:
    return torch.div(a, b, rounding_mode="floor")


def build_strided_plan(
    coords: torch.Tensor,
    spatial_shape: Sequence[int],
    batch_size: int,
    kernel_size,
    stride,
    padding,
    out_capacity: int,
) -> StridedPlan:
    """Regular (downsampling) sparse conv: output sites are every voxel whose
    receptive field touches an input voxel (spconv SparseConv3d semantics),
    deduplicated to ``out_capacity`` in ascending key order."""
    k = _triple(kernel_size)
    s = _triple(stride)
    p = _triple(padding)
    out_shape = downsample_shape(spatial_shape, k, s, p)
    dev = coords.device
    coords = coords.to(torch.int32)
    b = coords[:, 0]
    n = coords.shape[0]
    k3 = len(kernel_offsets(k))

    if k == s and p == (0, 0, 0):
        # non-overlapping windows: every input hits exactly one (output
        # voxel, tap) pair, read off unique_voxels' inverse map
        div = torch.stack([_floordiv(coords[:, 1 + i], s[i]) for i in range(3)], 1)
        cand = torch.cat([b[:, None], div], 1)
        cand = torch.where((b >= 0)[:, None], cand, torch.full_like(cand, -1))
        out_coords, inverse, _ = unique_voxels(cand, out_shape, batch_size,
                                               out_capacity)
        delta = coords[:, 1:4] - div * torch.tensor(s, dtype=torch.int32, device=dev)
        tap = (delta[:, 0] * k[1] + delta[:, 1]) * k[2] + delta[:, 2]
        valid = (b >= 0) & (inverse < out_capacity)
        slot = torch.where(valid, tap * out_capacity + inverse,
                           torch.full_like(tap, k3 * out_capacity))
        rows = torch.arange(n, dtype=torch.int32, device=dev)
        rulebook = torch.full((k3 * out_capacity + 1,), -1, dtype=torch.int32,
                              device=dev)
        rulebook[slot.to(torch.int64)] = torch.where(valid, rows,
                                                     torch.full_like(rows, -1))
        rulebook = rulebook[:-1].reshape(k3, out_capacity)
        parent = torch.where(valid, inverse, torch.full_like(inverse, -1))
        return StridedPlan(out_coords, rulebook, out_shape,
                           parent=parent, tap=tap.to(torch.int32))

    # general case: candidate output for input v and tap d is (v + p - d) / s
    s_t = torch.tensor(s, dtype=torch.int32, device=dev)
    p_t = torch.tensor(p, dtype=torch.int32, device=dev)
    shape_t = torch.tensor(out_shape, dtype=torch.int32, device=dev)
    cands = []
    for off in kernel_offsets(k):
        num = coords[:, 1:4] + p_t - torch.tensor(off, dtype=torch.int32, device=dev)
        div = torch.stack([_floordiv(num[:, i], s[i]) for i in range(3)], 1)
        exact = (num == div * s_t).all(1)
        inb = ((div >= 0) & (div < shape_t)).all(1)
        ok = exact & inb & (b >= 0)
        cand = torch.cat([b[:, None], div], 1)
        cands.append(torch.where(ok[:, None], cand, torch.full_like(cand, -1)))
    out_coords, _, _ = unique_voxels(torch.cat(cands, 0), out_shape, batch_size,
                                     out_capacity)
    table = hashing.build_table(coords, spatial_shape, batch_size)
    keys = _tap_keys(out_coords, kernel_offsets(k), s, p, spatial_shape)
    return StridedPlan(out_coords, hashing.lookup_keys(table, keys), out_shape)


def build_inverse_rulebook(
    coarse_coords: torch.Tensor,
    coarse_spatial_shape: Sequence[int],
    batch_size: int,
    fine_coords: torch.Tensor,
    kernel_size,
    stride,
    padding,
) -> torch.Tensor:
    """Inverse (transposed) sparse conv rulebook (spconv SparseInverseConv3d).
    Output sites are exactly ``fine_coords``; tap ``d`` of fine output ``f``
    reads coarse voxel ``(f + p - d) / s`` when that division is exact."""
    k = _triple(kernel_size)
    s = _triple(stride)
    p = _triple(padding)
    dev = fine_coords.device
    table = hashing.build_table(coarse_coords, coarse_spatial_shape, batch_size)
    fine = fine_coords.to(torch.int32)
    b = fine[:, 0]
    s_t = torch.tensor(s, dtype=torch.int32, device=dev)
    p_t = torch.tensor(p, dtype=torch.int32, device=dev)
    rows = []
    for off in kernel_offsets(k):
        num = fine[:, 1:4] + p_t - torch.tensor(off, dtype=torch.int32, device=dev)
        div = torch.stack([_floordiv(num[:, i], s[i]) for i in range(3)], 1)
        exact = (num == div * s_t).all(1) & (b >= 0)
        q = torch.cat([b[:, None], div], 1)
        q = torch.where(exact[:, None], q, torch.full_like(q, -1))
        rows.append(hashing.lookup(table, q, coarse_spatial_shape))
    return torch.stack(rows, 0)


def invert_strided_rulebook(rulebook: torch.Tensor, num_fine: int) -> torch.Tensor:
    """The inverse conv's rulebook from its paired strided plan, by scatter:
    if the down conv's tap d maps coarse row o -> fine row f, the inverse
    conv's tap d maps fine row f -> coarse row o."""
    k3, n_coarse = rulebook.shape
    dev = rulebook.device
    coarse_ids = torch.arange(n_coarse, dtype=torch.int32, device=dev)
    rows = []
    for t in range(k3):
        f = rulebook[t]
        tgt = torch.where(f >= 0, f, torch.full_like(f, num_fine)).to(torch.int64)
        row = torch.full((num_fine + 1,), -1, dtype=torch.int32, device=dev)
        row[tgt] = torch.where(f >= 0, coarse_ids, torch.full_like(coarse_ids, -1))
        rows.append(row[:num_fine])
    return torch.stack(rows, 0)


def apply_sparse_conv(
    features: torch.Tensor,
    rulebook: torch.Tensor,
    weights: torch.Tensor,
    out_mask: torch.Tensor,
    precision_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Gather-GEMM-accumulate over kernel taps, one tap at a time.

    features: (N_in, Cin); rulebook: (K^3, N_out) int32 (-1 = inactive);
    weights: (K^3, Cin, Cout); out_mask: (N_out,) bool. Accumulates in f32.
    The per-tap loop never materializes the (K^3, N, Cin) gather."""
    k3, n_out = rulebook.shape
    cdt = precision_dtype or features.dtype
    f = features.to(cdt)
    w = weights.to(cdt)
    out = torch.zeros(n_out, weights.shape[2], dtype=torch.float32,
                      device=features.device)
    for k in range(k3):
        idx = rulebook[k]
        live = (idx >= 0)[:, None]
        g = f[idx.clamp(min=0).to(torch.int64)]
        g = torch.where(live, g, torch.zeros((), dtype=cdt, device=g.device))
        out += (g @ w[k]).float()
    out = torch.where(out_mask[:, None], out, torch.zeros((), device=out.device))
    return out.to(features.dtype)


class _SubmConvSymmetric(torch.autograd.Function):
    """The JAX package's ``subm_conv_symmetric`` custom VJP
    (``ponderv2_tpu/ops/spconv.py:1131-1201``): the plain gather conv forward
    with a gather-only backward. For a subm rulebook the adjoint of tap k's
    gather is tap (K^3-1-k)'s gather, so one mirrored gather of the
    cotangent per tap serves both cotangents:

        dW[k] = x^T @ gather_{rb[K3-1-k]}(g),  dx += gather_{rb[K3-1-k]}(g) @ W[k]^T

    and autograd saves only the inputs, not every tap's gathered rows."""

    @staticmethod
    def forward(ctx, features, weights, rulebook, out_mask, compute_dtype):
        ctx.save_for_backward(features, weights)
        ctx.rulebook, ctx.out_mask, ctx.cdt = rulebook, out_mask, compute_dtype
        return apply_sparse_conv(features, rulebook, weights, out_mask,
                                 compute_dtype)

    @staticmethod
    def backward(ctx, g):
        features, weights = ctx.saved_tensors
        rulebook, cdt = ctx.rulebook, ctx.cdt
        k3 = rulebook.shape[0]
        g = torch.where(ctx.out_mask[:, None], g,
                        torch.zeros((), dtype=g.dtype, device=g.device))
        gc = g.to(cdt)
        fc = features.to(cdt)
        zero = torch.zeros((), dtype=cdt, device=g.device)
        dx = torch.zeros(features.shape, dtype=torch.float32, device=g.device)
        dw = torch.empty(weights.shape, dtype=torch.float32, device=g.device)
        for k in range(k3):
            midx = rulebook[k3 - 1 - k]
            gg = torch.where((midx >= 0)[:, None],
                             gc[midx.clamp(min=0).to(torch.int64)], zero)
            dw[k] = (fc.T @ gg).float()
            dx += (gg @ weights[k].to(cdt).T).float()
        return dx.to(features.dtype), dw.to(weights.dtype), None, None, None


def subm_conv_symmetric(features: torch.Tensor, rulebook: torch.Tensor,
                        weights: torch.Tensor, out_mask: torch.Tensor,
                        precision_dtype: Optional[torch.dtype] = None
                        ) -> torch.Tensor:
    """``apply_sparse_conv`` over a submanifold (mirror-symmetric) rulebook,
    differentiable in ``features`` and ``weights`` with the mirrored-gather
    backward."""
    return _SubmConvSymmetric.apply(features, weights, rulebook, out_mask,
                                    precision_dtype or features.dtype)


def _packed_tap_matmul(features, tap, weights, compute_dtype):
    """(N, Cin) x per-row tap-selected (Cin, Cout) -> (N, Cout) f32: one
    masked matmul per tap (K^3-fold FLOPs, as in the JAX package)."""
    k3 = weights.shape[0]
    x = features.to(compute_dtype)
    w = weights.to(compute_dtype)
    zero = torch.zeros((), dtype=compute_dtype, device=x.device)
    out = torch.zeros(x.shape[0], w.shape[2], dtype=torch.float32, device=x.device)
    for t in range(k3):
        out += (torch.where((tap == t)[:, None], x, zero) @ w[t]).float()
    return out


def strided_conv_packed(
    features: torch.Tensor,
    parent: torch.Tensor,
    tap: torch.Tensor,
    weights: torch.Tensor,
    out_capacity: int,
    out_mask: torch.Tensor,
    precision_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Input-major k == s strided conv: out[parent[i]] += x[i] @ W[tap[i]].
    Rows with parent -1 land in a dump row (JAX wraps -1 to the last row and
    adds zeros there; torch's index_add_ raises on -1)."""
    cdt = precision_dtype or features.dtype
    y = _packed_tap_matmul(features, tap, weights, cdt)
    live = parent >= 0
    y = torch.where(live[:, None], y, torch.zeros((), device=y.device))
    dst = torch.where(live, parent, torch.full_like(parent, out_capacity))
    out = torch.zeros(out_capacity + 1, weights.shape[2], dtype=torch.float32,
                      device=features.device)
    out.index_add_(0, dst.to(torch.int64), y)
    out = out[:out_capacity]
    out = torch.where(out_mask[:, None], out, torch.zeros((), device=out.device))
    return out.to(features.dtype)


def inverse_conv_packed(
    features: torch.Tensor,
    parent: torch.Tensor,
    tap: torch.Tensor,
    weights: torch.Tensor,
    fine_mask: torch.Tensor,
    precision_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Input-major k == s inverse conv: out[i] = x_coarse[parent[i]] @ W[tap[i]]
    over the down plan's own pairing (spconv indice_key reuse)."""
    cdt = precision_dtype or features.dtype
    live = (parent >= 0)[:, None]
    g = features.to(cdt)[parent.clamp(min=0).to(torch.int64)]
    g = torch.where(live, g, torch.zeros((), dtype=cdt, device=g.device))
    out = _packed_tap_matmul(g, tap, weights, cdt)
    out = torch.where(fine_mask[:, None], out, torch.zeros((), device=out.device))
    return out.to(features.dtype)
