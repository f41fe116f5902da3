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
package leaves them to XLA's autodiff. With ``PONDER_WINDOWED_GATHER`` set,
a gather conv of at least 4096 output rows and at most 128 channels takes
the windowed route (``apply_sparse_conv_windowed``: K4 / K5 plus their
residual), as the JAX package's does.
"""

from __future__ import annotations

import itertools
import os
import weakref
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from . import hashing
from .scatter import DUMP_ROWS, dump_ids, ordered_scatter_add, sum_dtype
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
    queries outside the spatial shape. The key is linear in the query, so
    it is the row's base key plus the tap's offset key; each axis is
    checked against the shape by comparing the tap's offset with the row's
    bounds, so no (T, N, 3) array is made."""
    dims = tuple(int(v) for v in spatial_shape)
    dev = coords.device
    c = coords.to(torch.int64)
    s, p = _triple(stride), _triple(padding)
    off = torch.tensor(offsets, dtype=torch.int64, device=dev).reshape(-1, 3)
    valid = (c[:, 0] >= 0)[None]
    base = c[:, 0]
    for a in range(3):
        q0 = c[:, 1 + a] * s[a] - p[a]
        o = off[:, a, None]
        valid = valid & (o >= -q0) & (o < dims[a] - q0)
        base = base * dims[a] + q0
    off_key = (off[:, 0] * dims[1] + off[:, 1]) * dims[2] + off[:, 2]
    key = base[None] + off_key[:, None]
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


class BandedRulebook(NamedTuple):
    """A plain (K^3, N) rulebook with the level's band plan attached: the
    carrier of models that build raw rulebooks (MinkUNet), so that one band
    plan serves every block of the level (JAX ``BandedRulebook``)."""

    legacy: torch.Tensor
    band: Optional[tuple] = None


def attach_band_rulebook(legacy: torch.Tensor) -> BandedRulebook:
    """Wrap a (K^3, N) subm rulebook with its band plan (k3 only), built
    with the budget retry of the attached plans (``build_band_plan_auto``:
    both budgets doubled while ``ok`` is False). The JAX package builds this
    carrier's plan once at the default budgets (ROADMAP Queue 3)."""
    from .band_conv import build_band_plan_auto

    return BandedRulebook(legacy, build_band_plan_auto(legacy, 3))


def plan_contract_flags(rb) -> list:
    """The loud-failure contract flags a rulebook/plan carries:
    ``SubmPlan.sorted_ok`` and the ``BandPlan.ok`` of an attached plan
    (on a ``SubmPlan`` or a ``BandedRulebook``)."""
    flags = []
    if isinstance(rb, SubmPlan):
        flags.append(rb.sorted_ok)
        if rb.band is not None:
            flags.append(rb.band.ok)
    elif isinstance(rb, BandedRulebook) and rb.band is not None:
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


def _gather_conv_sum(f: torch.Tensor, rulebook: torch.Tensor,
                     w: torch.Tensor) -> torch.Tensor:
    """sum_k f[rulebook[k]] @ w[k] over the live entries, (N_out, Cout) in
    ``sum_dtype`` of the compute-dtype operands ``f`` and ``w``, one tap at a
    time, so the (K^3, N, Cin) gather is never materialized."""
    k3, n_out = rulebook.shape
    acc = sum_dtype(f.dtype)
    out = torch.zeros(n_out, w.shape[2], dtype=acc, device=f.device)
    for k in range(k3):
        idx = rulebook[k]
        live = (idx >= 0)[:, None]
        g = f[idx.clamp(min=0).to(torch.int64)]
        g = torch.where(live, g, torch.zeros((), dtype=f.dtype, device=g.device))
        out += (g @ w[k]).to(acc)
    return out


def apply_sparse_conv(
    features: torch.Tensor,
    rulebook: torch.Tensor,
    weights: torch.Tensor,
    out_mask: torch.Tensor,
    precision_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Gather-GEMM-accumulate over kernel taps, one tap at a time.

    features: (N_in, Cin); rulebook: (K^3, N_out) int32 (-1 = inactive);
    weights: (K^3, Cin, Cout); out_mask: (N_out,) bool. Accumulates in f32
    (f64 for f64 operands: ``sum_dtype``)."""
    cdt = precision_dtype or features.dtype
    out = _gather_conv_sum(features.to(cdt), rulebook, weights.to(cdt))
    out = torch.where(out_mask[:, None], out, torch.zeros((), device=out.device))
    return out.to(features.dtype)


# ------------------------------------------------ windowed gather-GEMM route
#
# Rulebooks are per-tap monotone over their valid entries (rows sorted by
# ravel key, a tap adding a constant to the key), so a block of output rows
# reads its inputs from a narrow window. The JAX package's XLA form
# (``ponderv2_tpu/ops/spconv.py:930-1121``) is the substrate of its Pallas
# kernels K4/K5; here the route runs their Hopper ports
# (``ops/windowed_gather.py``). K4 and K5 drop an entry outside its window,
# as the TPU kernels do; the route adds those entries back as a residual, so
# the result is exact, as the JAX form's per-block fallback makes its own.
# The residual is a compacted list, in the style of the band conv's overflow
# residual: the entries outside their windows grouped by tap, one matmul a
# tap, summed into their rows in a fixed order with no atomics. Building it
# reads the count of such entries on the host (and, where there are any,
# their count per tap); with none, nothing else runs. A residual over the
# whole rulebook with its in-window entries set to -1 needs no host read,
# but costs a plain gather conv: on the card it took the windowed forward
# from K4's 1.3 ms to 22.1 ms, against 21.0 ms for the plain conv, with
# every entry inside its window (PERF.md, the windowed route's findings).

WINDOW_BLOCK = 512  # output rows of one K4 / K5 block
WINDOW_WB = 1024  # rows of a window block; a window is two of them


def use_windowed_gather(n_out: int, cin: int, cout: int) -> bool:
    """The JAX package's switch (``spconv.py:948-958``), read at call time:
    with ``PONDER_WINDOWED_GATHER`` unset or "0" no conv takes the route;
    otherwise a conv of at least 4096 output rows and at most 128 channels
    either side does."""
    flag = os.environ.get("PONDER_WINDOWED_GATHER", "0")
    if flag == "0":
        return False
    return n_out >= 4096 and max(cin, cout) <= 128


def _window_geometry(rulebook: torch.Tensor, n_in: int, window: int, block: int):
    """The JAX form's per-(tap, block) windows: ``(rbb (K3, nb, block),
    starts (K3, nb), covered (nb,))``, ``covered[j]`` True iff every tap's
    valid entries of block j lie in ``[start, start + window)``.
    Integer-equal to JAX ``_window_geometry``."""
    k3, n_out = rulebook.shape
    nb = -(-n_out // block)
    rbb = torch.full((k3, nb * block), -1, dtype=rulebook.dtype, device=rulebook.device)
    rbb[:, :n_out] = rulebook
    rbb = rbb.reshape(k3, nb, block)
    valid = rbb >= 0
    big = torch.iinfo(torch.int32).max
    mn = torch.where(valid, rbb, big).amin(dim=2)
    mx = torch.where(valid, rbb, -1).amax(dim=2)
    starts = torch.where(mn == big, 0, mn).clamp(0, max(n_in - window, 0))
    covered = ((mx - starts) < window).all(dim=0)
    return rbb, starts, covered


def windowed_coverage(rulebook: torch.Tensor, n_in: int, window: int = 1024,
                      block: int = WINDOW_BLOCK) -> torch.Tensor:
    """Diagnostic: the share of output blocks whose entries all fit the JAX
    form's per-tap windows (JAX ``windowed_coverage``)."""
    _, _, covered = _window_geometry(rulebook, n_in, window, block)
    return covered.to(torch.float32).mean()


def tap_group(k3: int) -> int:
    """K4's tap group: the taps that share a leading (x) offset, whose y / z
    shifts move the ravel key by a few rows (9 of a k3 kernel's 27, 25 of
    the k5 stem's 125, 4 of a k2 kernel's 8), as phase 12 of
    ``chip_smoke.py`` and ``tools/experiments/probe_windowed_torch.py``
    group them. A kernel that is not a cube takes one tap a group."""
    k = round(k3 ** (1 / 3))
    return k3 // k if k ** 3 == k3 else 1


class WindowedRoute(NamedTuple):
    """One rulebook's windowed route: K4 / K5's geometry (tap group
    ``group``, blocks of ``WINDOW_BLOCK`` rows, windows of two
    ``WINDOW_WB``-row blocks), and the residual: the entries outside their
    window (what K4 / K5 drop) by tap, ``res_rows`` / ``res_cols`` (E,)
    int64 output and input rows, ``res_counts`` their count per tap;
    ``inside`` / ``live`` () int64 device tensors, the valid entries inside
    their windows and all the valid entries."""

    geom: tuple
    group: int
    res_rows: torch.Tensor
    res_cols: torch.Tensor
    res_counts: Tuple[int, ...]
    inside: torch.Tensor
    live: torch.Tensor


def build_windowed_route(rulebook: torch.Tensor, n_in: int) -> WindowedRoute:
    """K4 / K5's geometry of a (K3, N_out) rulebook over ``n_in`` input
    rows, with its residual and its counts. Reads the number of entries
    outside their windows on the host (a sync), and their count per tap
    where there are any."""
    from .windowed_gather import prepare_geometry

    k3 = rulebook.shape[0]
    group = tap_group(k3)
    geom = prepare_geometry(rulebook.to(torch.int32), n_in, WINDOW_BLOCK, WINDOW_WB,
                            group)
    nb = geom.rbb.shape[1]
    rbb = geom.rbb.reshape(k3, nb, WINDOW_BLOCK)
    lo = (geom.w0 * WINDOW_WB).repeat_interleave(group, 0)[:, :, None]
    inside = ((rbb >= lo) & (rbb < lo + 2 * WINDOW_WB)).reshape(k3, -1)
    rbb = rbb.reshape(k3, -1)
    taps, rows = ((rbb >= 0) & ~inside).nonzero(as_tuple=True)
    counts = (0,) * k3
    if rows.numel():
        counts = tuple(torch.bincount(taps, minlength=k3).tolist())
    return WindowedRoute(geom, group, rows, rbb[taps, rows].to(torch.int64), counts,
                         inside.sum(), (rbb >= 0).sum())


# routes by (id(rulebook), n_in): (weak reference to the rulebook, its
# version counter, the route); an entry leaves when its rulebook is freed
_ROUTES: dict = {}


def windowed_route(rulebook: torch.Tensor, n_in: int) -> WindowedRoute:
    """``build_windowed_route``, built once per rulebook: the convs that
    share a rulebook (a level's blocks, the remat recompute, a subm conv's
    backward) take the route built for the first of them while the
    rulebook lives and is not modified in place."""
    key = (id(rulebook), int(n_in))
    hit = _ROUTES.get(key)
    if hit is not None and hit[0]() is rulebook and hit[1] == rulebook._version:
        return hit[2]
    route = build_windowed_route(rulebook, n_in)
    ref = weakref.ref(rulebook, lambda _, key=key: _ROUTES.pop(key, None))
    _ROUTES[key] = (ref, rulebook._version, route)
    return route


def _residual_sum(out: torch.Tensor, f: torch.Tensor, route: WindowedRoute,
                  w: torch.Tensor) -> torch.Tensor:
    """``out`` plus the residual's products, f[col] @ w[tap] added into
    row ``row`` for each entry outside its window, each row's in entry
    order (``ordered_scatter_add``)."""
    if not route.res_rows.numel():
        return out
    cols = route.res_cols.split(route.res_counts)
    vals = torch.cat([(f[c] @ w[t]).to(out.dtype) for t, c in enumerate(cols)])
    return ordered_scatter_add(out, route.res_rows, vals)


def _windowed_conv_sum(features: torch.Tensor, route: WindowedRoute,
                       weights: torch.Tensor, cdt: torch.dtype) -> torch.Tensor:
    """K4 plus its residual: (nb * block, Cout) f32 of the compute-dtype
    features and weights."""
    from . import windowed_gather as wg

    n_pad = wg.padded_rows(features.shape[0], WINDOW_WB)
    f = wg.pad_features(features, n_pad, cdt)
    w = weights.to(cdt).contiguous()
    out = wg.windowed_conv_fwd(f, route.geom, w, WINDOW_WB, route.group)
    return _residual_sum(out, f, route, w)


def _windowed_apply(features, route, weights, out_mask, cdt):
    """The windowed conv's masked output in ``features.dtype``."""
    out = _windowed_conv_sum(features, route, weights, cdt)[:out_mask.shape[0]]
    out = torch.where(out_mask[:, None], out, torch.zeros((), device=out.device))
    return out.to(features.dtype)


def _windowed_dw(features: torch.Tensor, route: WindowedRoute, g: torch.Tensor,
                 cdt: torch.dtype) -> torch.Tensor:
    """dW[t] = gather_t(x)^T @ g: K5 plus the residual's dW (one matmul a
    tap over its entries), (K3, Cin, Cout) f32 (JAX ``_windowed_dw``)."""
    from . import windowed_gather as wg

    n_pad = wg.padded_rows(features.shape[0], WINDOW_WB)
    f = wg.pad_features(features, n_pad, cdt)
    gp = torch.zeros((route.geom.rbb.shape[1] * WINDOW_BLOCK, g.shape[1]), dtype=cdt,
                     device=g.device)
    gp[:g.shape[0]] = g.to(cdt)
    dw = wg.windowed_conv_dw(f, route.geom, gp, WINDOW_WB, route.group)
    if route.res_rows.numel():
        cols = route.res_cols.split(route.res_counts)
        rows = route.res_rows.split(route.res_counts)
        for t, (c, r) in enumerate(zip(cols, rows)):
            if c.numel():
                dw[t] += (f[c].T @ gp[r]).to(dw.dtype)
    return dw


class _WindowedConv(torch.autograd.Function):
    """``apply_sparse_conv`` on the windowed route: K4 (+ residual) forward;
    dx by the rulebook backward (what autograd gives ``apply_sparse_conv``,
    and JAX's autodiff the windowed form: each tap's rows of g @ W[t]^T
    added back into the rows they were gathered from), dW by K5 (+
    residual)."""

    @staticmethod
    def forward(ctx, features, weights, rulebook, out_mask, compute_dtype, route):
        ctx.save_for_backward(features, weights)
        ctx.rulebook, ctx.out_mask, ctx.cdt, ctx.route = (rulebook, out_mask,
                                                          compute_dtype, route)
        return _windowed_apply(features, route, weights, out_mask, compute_dtype)

    @staticmethod
    def backward(ctx, g):
        features, weights = ctx.saved_tensors
        rulebook, cdt = ctx.rulebook, ctx.cdt
        zero = torch.zeros((), dtype=cdt, device=g.device)
        gc = torch.where(ctx.out_mask[:, None], g, torch.zeros((), dtype=g.dtype,
                                                               device=g.device)).to(cdt)
        dx = torch.zeros(features.shape, dtype=cdt, device=g.device)
        for t in range(rulebook.shape[0]):
            idx = rulebook[t]
            rows = torch.where((idx >= 0)[:, None], gc @ weights[t].to(cdt).T, zero)
            dx.index_put_((idx.clamp(min=0).to(torch.int64),), rows, accumulate=True)
        dw = _windowed_dw(features, ctx.route, gc, cdt)
        return dx.to(features.dtype), dw.to(weights.dtype), None, None, None, None


def apply_sparse_conv_windowed(
    features: torch.Tensor,
    rulebook: torch.Tensor,
    weights: torch.Tensor,
    out_mask: torch.Tensor,
    precision_dtype: Optional[torch.dtype] = None,
    route: Optional[WindowedRoute] = None,
) -> torch.Tensor:
    """Windowed form of :func:`apply_sparse_conv` (same contract: the
    masked output in ``features.dtype``), differentiable in ``features``
    and ``weights``. On CUDA tensors it launches K4 (and K5 in the
    backward) or raises; on CPU tensors it runs their plain versions.
    ``route`` is the rulebook's ``windowed_route`` when the caller has it."""
    route = route or windowed_route(rulebook, features.shape[0])
    return _WindowedConv.apply(features, weights, rulebook, out_mask,
                               precision_dtype or features.dtype, route)


class _SubmConvSymmetric(torch.autograd.Function):
    """The JAX package's ``subm_conv_symmetric`` custom VJP
    (``ponderv2_tpu/ops/spconv.py:1131-1201``): the plain gather conv forward
    with a gather-only backward. For a subm rulebook the adjoint of tap k's
    gather is tap (K^3-1-k)'s gather, so one mirrored gather of the
    cotangent per tap serves both cotangents:

        dW[k] = x^T @ gather_{rb[K3-1-k]}(g),  dx += gather_{rb[K3-1-k]}(g) @ W[k]^T

    and autograd saves only the inputs, not every tap's gathered rows."""

    @staticmethod
    def forward(ctx, features, weights, rulebook, out_mask, compute_dtype, route):
        ctx.save_for_backward(features, weights)
        ctx.rulebook, ctx.out_mask, ctx.cdt, ctx.route = (rulebook, out_mask,
                                                          compute_dtype, route)
        if route is not None:
            return _windowed_apply(features, route, weights, out_mask, compute_dtype)
        return apply_sparse_conv(features, rulebook, weights, out_mask,
                                 compute_dtype)

    @staticmethod
    def backward(ctx, g):
        features, weights = ctx.saved_tensors
        rulebook, cdt = ctx.rulebook, ctx.cdt
        k3 = rulebook.shape[0]
        g = torch.where(ctx.out_mask[:, None], g,
                        torch.zeros((), dtype=g.dtype, device=g.device))
        if ctx.route is not None:
            # dx = sum_k gather_{rb[K3-1-k]}(g) @ W[k]^T: with t = K3-1-k the
            # forward conv of g with the mirrored, transposed weights (JAX
            # ``spconv.py:1159-1171``)
            w_bwd = weights.flip(0).transpose(1, 2)
            dx = _windowed_apply(g, ctx.route, w_bwd, ctx.out_mask, cdt)
            dw = _windowed_dw(features, ctx.route, g, cdt)
            return (dx.to(features.dtype), dw.to(weights.dtype), None, None, None,
                    None)
        gc = g.to(cdt)
        fc = features.to(cdt)
        zero = torch.zeros((), dtype=cdt, device=g.device)
        acc = sum_dtype(cdt)
        dx = torch.zeros(features.shape, dtype=acc, device=g.device)
        dw = torch.empty(weights.shape, dtype=acc, device=g.device)
        for k in range(k3):
            midx = rulebook[k3 - 1 - k]
            gg = torch.where((midx >= 0)[:, None],
                             gc[midx.clamp(min=0).to(torch.int64)], zero)
            dw[k] = (fc.T @ gg).to(acc)
            dx += (gg @ weights[k].to(cdt).T).to(acc)
        return dx.to(features.dtype), dw.to(weights.dtype), None, None, None, None


def subm_conv_symmetric(features: torch.Tensor, rulebook: torch.Tensor,
                        weights: torch.Tensor, out_mask: torch.Tensor,
                        precision_dtype: Optional[torch.dtype] = None,
                        route: Optional[WindowedRoute] = None) -> torch.Tensor:
    """``apply_sparse_conv`` over a submanifold (mirror-symmetric) rulebook,
    differentiable in ``features`` and ``weights`` with the mirrored-gather
    backward. On the windowed route where ``use_windowed_gather`` holds, as
    the JAX function is, over ``route`` (default the rulebook's
    ``windowed_route``); a ``route`` given takes the windowed route
    whatever the switch."""
    if route is None and use_windowed_gather(rulebook.shape[1], weights.shape[1],
                                             weights.shape[2]):
        route = windowed_route(rulebook, features.shape[0])
    return _SubmConvSymmetric.apply(features, weights, rulebook, out_mask,
                                    precision_dtype or features.dtype, route)


def subm_conv_gather(features: torch.Tensor, rulebook: torch.Tensor,
                     weights: torch.Tensor, out_mask: torch.Tensor,
                     precision_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``subm_conv_symmetric`` on the plain gather conv whatever the switch:
    the function of the JAX slab conv, which never takes the windowed
    route."""
    return _SubmConvSymmetric.apply(features, weights, rulebook, out_mask,
                                    precision_dtype or features.dtype, None)


def _packed_tap_matmul(features, tap, weights, compute_dtype):
    """(N, Cin) x per-row tap-selected (Cin, Cout) -> (N, Cout) f32 (f64 for
    f64): one masked matmul per tap (K^3-fold FLOPs, as in the JAX package)."""
    k3 = weights.shape[0]
    x = features.to(compute_dtype)
    w = weights.to(compute_dtype)
    zero = torch.zeros((), dtype=compute_dtype, device=x.device)
    acc = sum_dtype(compute_dtype)
    out = torch.zeros(x.shape[0], w.shape[2], dtype=acc, device=x.device)
    for t in range(k3):
        out += (torch.where((tap == t)[:, None], x, zero) @ w[t]).to(acc)
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
    Rows with parent -1 land in dump rows (JAX wraps -1 to the last row and
    adds zeros there). Each output row sums its (at most K^3) children in
    one fixed order (``ordered_scatter_add``)."""
    cdt = precision_dtype or features.dtype
    y = _packed_tap_matmul(features, tap, weights, cdt)
    live = parent >= 0
    y = torch.where(live[:, None], y, torch.zeros((), device=y.device))
    dst = dump_ids(parent, ~live, out_capacity)
    out = torch.zeros(out_capacity + DUMP_ROWS, weights.shape[2], dtype=y.dtype,
                      device=features.device)
    out = ordered_scatter_add(out, dst, y)[:out_capacity]
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
