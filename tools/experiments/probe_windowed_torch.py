"""Probe: the port's windowed gather-GEMM conv kernels (K4 forward, K5 dW)
and the P7 ablation kernels against their plain PyTorch versions on a CUDA
GPU.

    python tools/experiments/probe_windowed_torch.py [--dtype bfloat16|float32]

The counterpart of ``probe_pallas_windowed.py``, at its three shapes (N =
163,840 rows, output blocks of 512, window blocks of 1024; (taps, cin,
cout, tap group) = (27, 32, 32, 9), (27, 96, 96, 9), (125, 8, 32, 25)) and
on its synthetic monotone rulebooks, plus ``probe_pallas_profile.py``'s
full kernel (27 taps, 32 -> 32, one window per tap, its rulebook of rows
shifted by up to 300 per entry). Per shape it prints the share of
output blocks whose entries fit their window (``covered``), K4's and K5's
time (CUDA events, after a warm-up) beside their plain versions', and the
relative error of each against the plain version on the same inputs.

Then, as the counterpart of ``probe_pallas_profile.py``'s ablations V2-V5
(V1 is the "profile" case above), each at the probe's shape and on its own
inputs (``RandomState(0)``, drawn as the probe draws them): the kernel's
device time with the L2 cache flushed before each call (and warm, beside
it) next to its plain version's and its bound, and its error against the
plain version. It needs a CUDA device and refuses to run without one.

It also holds what the other probe entry points (``probe_gather_torch.py``,
``probe_bisect_torch.py``) share: ``Variant``, one ported probe function
at its probe's shape, and how one is checked and timed (``agree``,
``measure``).
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

N, BLOCK, WB = 163_840, 512, 1024
SHAPES = [(27, 32, 32, 9), (27, 96, 96, 9), (125, 8, 32, 25)]


def make_monotone_rulebook(n, k3, rng, miss=0.3, group=9):
    """Group-coherent per-tap shifts, like real rulebooks: taps within a
    leading-offset group differ by a few rows (y/z ravel steps), groups by a
    lot (probe_pallas_windowed.py's generator)."""
    rbs = []
    for t in range(k3):
        shift = rng.randint(-600, 600) if t % group == 0 else shift
        idx = np.arange(n) + shift + t % group * 3 + rng.randint(-8, 8, n)
        idx = np.clip(np.sort(idx), 0, n - 1)
        invalid = rng.rand(n) < miss
        rbs.append(np.where(invalid, -1, idx))
    return np.stack(rbs).astype(np.int32)


def profile_rulebook(n, k3, rng, miss=0.3):
    """``probe_pallas_profile.py``'s rulebook: every tap's rows shifted by up
    to 300 per entry and sorted, ``miss`` of the entries absent."""
    rb = np.sort(np.arange(n)[None, :].repeat(k3, 0)
                 + rng.randint(-300, 300, (k3, n)), axis=1)
    rb = np.clip(rb, 0, n - 1).astype(np.int32)
    rb[rng.rand(k3, n) < miss] = -1
    return rb


def cases(rng):
    """(label, tap group, rulebook (k3, N) int32, cin, cout) of every probe
    shape."""
    out = [(f"k3={k3} c={cin}->{cout} group {group}", group,
            make_monotone_rulebook(N, k3, rng, group=group), cin, cout)
           for k3, cin, cout, group in SHAPES]
    out.append(("profile k3=27 c=32->32 group 1", 1, profile_rulebook(N, 27, rng), 32, 32))
    return out


def covered_share(geom, wb):
    """The share of (tap group, output block) windows that hold every one of
    their entries (``geom.covered`` is True iff this is 1)."""
    import torch

    k3, nb, _, block = geom.rbb.shape
    ngroups = geom.w0.shape[0]
    rb = geom.rbb.reshape(ngroups, k3 // ngroups, nb, block).to(torch.int64)
    lo = (geom.w0.to(torch.int64) * wb)[:, None, :, None]
    outside = (rb >= 0) & ((rb < lo) | (rb >= lo + 2 * wb))
    return float((~outside.any(dim=(1, 3))).float().mean())


def _live(geom, wb, windows):
    """The rulebook's rows (k3, nb, B) int64, each entry's window start
    (k3, nb, 1) and whether the entry lies inside its window of ``windows``
    blocks."""
    import torch

    k3, nb, _, block = geom.rbb.shape
    group = k3 // geom.w0.shape[0]
    rb = geom.rbb.reshape(k3, nb, block).to(torch.int64)
    lo = (geom.w0.to(torch.int64) * wb).repeat_interleave(group, 0)[:, :, None]
    return rb, lo, (rb >= lo) & (rb < lo + windows * wb)


def live_entries(geom, wb, windows=2):
    """Entries inside their window of ``windows`` blocks: the ones the
    kernels multiply."""
    return int(_live(geom, wb, windows)[2].sum())


def k4_rows_multiplied(geom, wb, windows=2):
    """Rows K4 (or, with ``windows``, the P7 forward over the same tile)
    multiplies per output column tile, counted from the geometry as its slab
    tile (``mma_tile.cuh:gather_gemm``) decides: every 16-row slab that
    holds a live entry of the tap."""
    live = _live(geom, wb, windows)[2]
    return int(live.reshape(live.shape[0], -1, 16).any(2).sum()) * 16


def k5_rows_multiplied(geom, wb, plan, dtype):
    """Rows K5 multiplies per channel tile, counted from the geometry as
    ``mma_tile.cuh:dw_gather_gemm`` decides (``plan``:
    ``windowed_dw_plan``): per (row chunk, tap, 1024-row window from the
    chunk's start) the live entries, rounded up to the mma depth (16 rows in
    bf16, 8 in f32)."""
    import torch

    live = _live(geom, wb, 2)[2]
    k3 = live.shape[0]
    live = live.reshape(k3, -1)
    i = torch.arange(live.shape[1], device=live.device)
    per_chunk = -(-plan.chunk // 1024)
    window = i // plan.chunk * per_chunk + i % plan.chunk // 1024
    counts = torch.zeros((k3, plan.nchunks * per_chunk), dtype=torch.int64,
                         device=live.device)
    counts.index_add_(1, window, live.to(torch.int64))
    depth = 16 if dtype == torch.bfloat16 else 8
    return int(((counts + depth - 1) // depth * depth).sum())


def rows_read(geom, wb, windows=2, slab=False, rebase=False):
    """Distinct feature rows a forward reads over its live entries: each
    entry's own row (K4), or with ``slab`` the head of its 8-row slab, less
    its window start with ``rebase`` (``windowed_slab_fwd``, P7 V2-V4)."""
    import torch

    rb, lo, live = _live(geom, wb, windows)
    if slab:
        rb = (rb & ~7) - (lo if rebase else 0)
    return int(torch.unique(rb[live]).numel())


def case_inputs(rulebook, cin, cout, seed, device):
    """Features (n, cin), weights (k3, cin, cout) and a cotangent (n, cout)
    in f32 from ``seed``, for the (k3, n) ``rulebook``."""
    import torch

    k3, n = rulebook.shape
    gen = torch.Generator(device=device).manual_seed(seed)
    feats = torch.randn(n, cin, device=device, generator=gen)
    w = torch.randn(k3, cin, cout, device=device, generator=gen) * 0.05
    g = torch.randn(n, cout, device=device, generator=gen)
    return feats, w, g


def windowed_conv(rulebook, feats, w, g, block, wb, group, dtype, plain=False):
    """The windowed conv of one rulebook: its geometry, K4's output rows
    (n, cout) f32 and K5's dW (k3, cin, cout) f32 of ``feats``/``w``/``g``
    cast to ``dtype``; ``plain`` takes the plain PyTorch versions."""
    import torch

    from ponderv2_tpu_torch.ops import windowed_gather as wg

    n = rulebook.shape[1]
    geom = wg.prepare_geometry(rulebook, n, block, wb, group)
    f = wg.pad_features(feats, wg.padded_rows(n, wb), dtype)
    fwd = wg.windowed_conv_fwd_plain if plain else wg.windowed_conv_fwd
    dw_fn = wg.windowed_conv_dw_plain if plain else wg.windowed_conv_dw
    out = fwd(f, geom, w.to(dtype).contiguous(), wb, group)[:n]
    rows = geom.rbb.shape[1] * block
    gc = torch.zeros((rows, g.shape[1]), dtype=dtype, device=g.device)
    gc[:n] = g.to(dtype)
    return geom, out, dw_fn(f, geom, gc, wb, group)


def moved_bytes(geom, cin, cout, n_in, dtype, weights=True):
    """What K4 (``weights``) or K5 must move, each input read once and each
    output written once: ``n_in`` feature rows, rulebook and window table, then W in and
    f32 rows out (K4) or the cotangent in and f32 dW out (K5)."""
    import torch

    k3, nb, _, block = geom.rbb.shape
    elt = 2 if dtype == torch.bfloat16 else 4
    nrows = nb * block
    idx = 4 * (geom.rbb.numel() + geom.w0.numel())
    feat = n_in * cin * elt
    if weights:
        return feat + idx + k3 * cin * cout * elt + nrows * cout * 4
    return feat + idx + nrows * cout * elt + k3 * cin * cout * 4


def bound_ms(geom, wb, cin, cout, n_in, dtype, weights=True, windows=2):
    """The least time an H100 SXM could take for K4 (``weights``) or K5:
    max(bytes / 3.35 TB/s, FLOPs / peak) with ``moved_bytes``; FLOPs = 2 x
    in-window entries x cin x cout, at the tensor cores' rate where K4 and
    K5 run (``chip_smoke.PEAK_FLOPS``: 989 TFLOP/s in bf16, 165 in f32 at
    f32 accuracy, 3xTF32). Returns (ms, term)."""
    from chip_smoke import PEAK_FLOPS

    flops = 2.0 * live_entries(geom, wb, windows) * cin * cout
    return bound_of(moved_bytes(geom, cin, cout, n_in, dtype, weights), flops,
                    PEAK_FLOPS[str(dtype).rsplit(".", 1)[-1]])


# H100 SXM (NVIDIA's data sheet, 700 W): HBM bytes/s; dense FLOP/s of bf16
# on the tensor cores (the gather-GEMM tiles: P3 k2, P5 kd, P7 V2-V4) and of
# f32 on the CUDA cores (the probe kernels whose work is f32 adds: P1-P4's
# row and window sums, P5 ka-kc2, P7 V5's head sums)
HBM_BYTES_S = 3.35e12
PEAK_BF16, PEAK_F32 = 989e12, 67e12


def bound_of(moved, flops, peak):
    """max(bytes / 3.35 TB/s, FLOPs / ``peak``) in ms, and its term."""
    t_bytes, t_ops = moved / HBM_BYTES_S * 1e3, flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class Variant(NamedTuple):
    """One ported probe function at its probe's shape, on its probe's
    inputs. ``run(plain)`` calls the port's entry point: on CUDA tensors its
    kernel (``kernel``, a ``_CudaKernel``), or with ``plain`` its plain
    version. ``tol`` holds the kernel to the plain version: "exact" (equal)
    or "rel" (within 1e-5 of max|ref|: the same products summed in another
    order). The bound takes ``moved``
    bytes (what the function must read and write, once) and ``flops`` at
    ``peak`` FLOP/s; ``library`` is one PyTorch call computing the same
    function, or None. ``rows``: for a kernel on a gather-GEMM tile, the
    rows it multiplies per output column tile and the live entries, counted
    from the geometry. ``floor``: (what it is, a PyTorch call) that moves
    no more bytes than the function and computes less (the same output from
    as many input rows, or all of the input into part of the output), timed
    beside as a floor."""

    name: str
    replaces: str
    kernel: object
    run: Callable
    tol: object
    moved: float
    flops: float
    peak: float
    library: Optional[Callable] = None
    rows: Optional[Tuple[int, int]] = None
    floor: Optional[Tuple[str, Callable]] = None


def agree(out, ref, tol):
    """(whether ``out`` meets ``tol`` against ``ref`` with the same shape,
    max |out - ref|)."""
    import torch

    if out.shape != ref.shape or out.dtype != ref.dtype:
        return False, float("inf")
    err = float((out - ref).abs().max()) if out.numel() else 0.0
    scale = float(ref.abs().max()) if ref.numel() else 0.0
    ok = torch.equal(out, ref) if tol == "exact" else err <= 1e-5 * scale
    return ok and bool(torch.isfinite(out).all()), err


# twice the H100's 50 MB L2: reading it evicts what an earlier call left there
L2_FLUSH_BYTES = 100 * 2 ** 20
TIMING = ("device time: CUDA-graph replay, L2 flushed before each call (the "
          "flush's own time taken off)")


def graph_ms(fn, iters, cold=True, reps=5):
    """The device time of one call of ``fn``, without the host's time to
    issue it (which exceeds a small kernel's): ``iters`` calls captured in a
    CUDA graph (after a warm-up call on a side stream) and replayed between
    CUDA events; the median of ``reps`` replays. ``cold``: each call
    follows a read of ``L2_FLUSH_BYTES``, so that it finds its inputs in
    HBM as a caller with other work between calls would; a graph of the
    reads alone, replayed beside it, gives their time to take off."""
    import torch

    buf = torch.ones(L2_FLUSH_BYTES // 4, device="cuda") if cold else None

    def flush():
        buf.sum()

    def flushed():
        flush()
        fn()

    bodies = [flushed, flush] if cold else [fn]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for body in bodies:
            body()
    torch.cuda.current_stream().wait_stream(side)
    graphs = []
    for body in bodies:
        graphs.append(torch.cuda.CUDAGraph())
        with torch.cuda.graph(graphs[-1]):
            for _ in range(iters):
                body()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))

    def replay_ms(graph):
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end)

    for graph in graphs:
        replay_ms(graph)  # warm-up
    times = []
    for _ in range(reps):
        t = [replay_ms(graph) for graph in graphs]
        times.append(t[0] - (t[1] if cold else 0.0))
    return sorted(times)[reps // 2] / iters


def measure(v, out, iters):
    """Hold ``out`` (one launch of ``v``'s kernel) to the plain version and
    time kernel, plain version and library call: ``ms``, ``plain_ms`` and
    ``library_ms`` on the device with a cold L2 (``graph_ms``); beside them
    the kernel's device time with the L2 warm from the call before
    (``warm_ms``) and the time per call issued one by one from Python
    (``eager_ms``, ``cuda_ms``: CUDA events around ``iters`` calls after a
    warm-up), host overhead included, and the floor call's device time
    (``floor_ms``, None without one). A dict of those, ``agree``,
    ``max_abs_err``, ``bound_ms`` and ``bound_by``."""
    ok, err = agree(out, v.run(True), v.tol)
    b, term = bound_of(v.moved, v.flops, v.peak)
    calls = {"kernel": lambda: v.run(False), "plain": lambda: v.run(True),
             "library": v.library}
    device = {k: graph_ms(fn, iters) if fn else None for k, fn in calls.items()}
    eager = {k: cuda_ms(fn, iters) if fn else None for k, fn in calls.items()}
    return {"agree": ok, "max_abs_err": err, "ms": device["kernel"],
            "plain_ms": device["plain"], "library_ms": device["library"],
            "bound_ms": b, "bound_by": term,
            "warm_ms": graph_ms(calls["kernel"], iters, cold=False), "eager_ms": eager,
            "floor_ms": graph_ms(v.floor[1], iters) if v.floor else None}


def report(v, m):
    """One line of a variant's measurement."""
    def ms(d, k):
        return "n/a" if d[k] is None else f"{d[k]:.4f}"

    dev = {"kernel": m["ms"], "plain": m["plain_ms"], "library": m["library_ms"]}
    return (f"{v.name} ({v.replaces}): {'OK' if m['agree'] else 'DISAGREES'} "
            f"max_abs_err {m['max_abs_err']:.3e} ({v.tol}); "
            "device ms, L2 cold, kernel / plain / library "
            + " / ".join(ms(dev, k) for k in dev)
            + f"; kernel L2 warm {m['warm_ms']:.4f}"
            + "; per eager call " + " / ".join(ms(m["eager_ms"], k) for k in dev)
            + f"; bound {m['bound_ms']:.3e} ms ({m['bound_by']})"
            + ("" if v.rows is None else f"; rows multiplied {v.rows[0]} against "
               f"{v.rows[1]} live entries ({v.rows[0] / max(v.rows[1], 1):.2f}x)")
            + ("" if v.floor is None else f"; floor, {v.floor[0]} (not the same function): "
               f"{m['floor_ms']:.4f} ms, L2 cold"))


def run_variants(variants, iters):
    """Launch, check and time each variant; print a line each. Returns
    whether every kernel agreed with its plain version."""
    import torch

    ok = True
    for v in variants:
        out = v.run(False)
        torch.cuda.synchronize()
        m = measure(v, out, iters)
        ok &= m["agree"]
        print(report(v, m), flush=True)
    return ok


def probe_w0(rbb, wb, n_pad):
    """The probes' window table: per (tap, output block) of a (K3, nb, B)
    rulebook, the window block of its least live entry, clipped to [0,
    n_pad / wb - 2]; a block with no live entry takes the top (2**30 // wb
    clipped), as the probes compute it."""
    lo = np.where(rbb >= 0, rbb, 2 ** 30).min(axis=-1) // wb
    return np.clip(lo, 0, n_pad // wb - 2).astype(np.int32)


def window_rows_read(w0, wb, offsets):
    """Distinct rows ``w0[t, j] * wb + offset`` over a (T, nb) window table
    and the given offsets: what a window read must load."""
    import torch

    rows = (w0.to(torch.int64) * wb)[..., None] + torch.as_tensor(offsets, device=w0.device)
    return int(torch.unique(rows).numel())


PROFILE = "tools/experiments/probe_pallas_profile.py"
PROFILE_K3, PROFILE_C = 27, 32


def profile_inputs(n=N, k3=PROFILE_K3, seed=0):
    """``probe_pallas_profile.py``'s inputs at ``n`` rows and ``k3`` taps,
    drawn from ``RandomState(seed)`` in its order: features as (n_pad / 8,
    8 C) slabs, weights (k3, C, C) x 0.05, the rulebook (k3, n) int32; the
    first two as f32 (the probe rounds them to bf16)."""
    rng = np.random.RandomState(seed)
    n_pad = (n // WB + 1) * WB
    feats8 = rng.randn(n_pad // 8, 8 * PROFILE_C).astype(np.float32)
    w = (rng.randn(k3, PROFILE_C, PROFILE_C) * 0.05).astype(np.float32)
    return feats8, w, profile_rulebook(n, k3, rng)


def profile_variants(device, n=N, k3=PROFILE_K3):
    """The ablations V2-V5 of ``probe_pallas_profile.py`` on its inputs, as
    ``Variant``s of the port's entry points (``windowed_slab_fwd``, on K4's
    slab tile, with the rows it multiplies; ``window_head_sum``)."""
    import torch

    from ponderv2_tpu_torch.ops import probe_kernels as pk
    from ponderv2_tpu_torch.ops import windowed_gather as wg

    feats8, w, rb = profile_inputs(n, k3)
    nb, n_pad = n // BLOCK, (n // WB + 1) * WB
    x = torch.from_numpy(feats8).to(device).bfloat16().reshape(n_pad, PROFILE_C)
    wt = torch.from_numpy(w).to(device).bfloat16()
    rbb = torch.from_numpy(rb).to(device).reshape(k3, nb, 1, BLOCK)
    w0 = torch.from_numpy(probe_w0(rb.reshape(k3, nb, BLOCK), WB, n_pad)).to(device)
    lo = (w0.to(torch.int64) * WB)[:, :, None, None]
    covered = ((rbb < 0) | ((rbb >= lo) & (rbb < lo + 2 * WB))).all()
    geom = wg.WindowGeometry(rbb, w0, covered)
    out = []
    for label, line, windows, rebase in (("V2 no-rbc", 114, 2, False),
                                         ("V3 static-windows", 114, 2, True),
                                         ("V4 single-window", 147, 1, False)):
        def run(plain, windows=windows, rebase=rebase):
            fn = wg.windowed_slab_fwd_plain if plain else wg.windowed_slab_fwd
            return fn(x, geom, wt, WB, 1, windows, rebase)

        heads = rows_read(geom, WB, windows, slab=True, rebase=rebase)
        live = live_entries(geom, WB, windows)
        out.append(Variant(
            f"P7 {label}", f"{PROFILE}:{line}", wg.WINDOWED_SLAB_FWD, run, "rel",
            moved_bytes(geom, PROFILE_C, PROFILE_C, heads, torch.bfloat16),
            2.0 * live * PROFILE_C * PROFILE_C, PEAK_BF16,
            rows=(k4_rows_multiplied(geom, WB, windows), live)))
    # the plain version sums each head row in the kernel's order: exact
    out.append(Variant(
        "P7 V5 dma-only", f"{PROFILE}:181", pk.WINDOW_HEAD_SUM,
        lambda plain: (pk.window_head_sum_plain if plain else pk.window_head_sum)(
            x, w0, WB, BLOCK), "exact",
        window_rows_read(w0, WB, [0, WB]) * PROFILE_C * 2 + 4 * w0.numel()
        + n * PROFILE_C * 4, 2.0 * k3 * nb * PROFILE_C, PEAK_F32))
    return out


def cuda_ms(fn, iters):
    import torch

    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    fn()  # warm-up
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main(argv=None) -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"))
    parser.add_argument("--iters", type=int, default=10)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_windowed_torch: needs a CUDA GPU", file=sys.stderr)
        return 2
    from ponderv2_tpu_torch.ops import probe_kernels as pk
    from ponderv2_tpu_torch.ops import windowed_gather as wg
    from ponderv2_tpu_torch.ops.cuda_build import load_libraries

    torch.backends.cuda.matmul.allow_tf32 = False
    dtype = getattr(torch, args.dtype)
    dev = torch.device("cuda")
    load_libraries("windowed_gather", "probe_kernels")
    wg.build_kernels()
    pk.build_kernels()
    print(f"device {torch.cuda.get_device_name(0)}; dtype {args.dtype}; TF32 off")
    print(os.popen("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader").read().strip())
    for label, group, rb, cin, cout in cases(np.random.RandomState(0)):
        rb = torch.from_numpy(rb).to(dev)
        feats, w, g = case_inputs(rb, cin, cout, 0, dev)
        geom, out, dw = windowed_conv(rb, feats, w, g, BLOCK, WB, group, dtype)
        _, out_p, dw_p = windowed_conv(rb, feats, w, g, BLOCK, WB, group, dtype,
                                       plain=True)
        f = wg.pad_features(feats, wg.padded_rows(N, WB), dtype)
        wc = w.to(dtype).contiguous()
        gc = torch.zeros((geom.rbb.shape[1] * BLOCK, cout), dtype=dtype, device=dev)
        gc[:N] = g.to(dtype)
        times = {
            "K4": cuda_ms(lambda: wg.windowed_conv_fwd(f, geom, wc, WB, group), args.iters),
            "K4 plain": cuda_ms(lambda: wg.windowed_conv_fwd_plain(f, geom, wc, WB, group),
                                args.iters),
            "K5": cuda_ms(lambda: wg.windowed_conv_dw(f, geom, gc, WB, group), args.iters),
            "K5 plain": cuda_ms(lambda: wg.windowed_conv_dw_plain(f, geom, gc, WB, group),
                                args.iters),
        }
        rel4 = float((out - out_p).abs().max() / out_p.abs().max().clamp(min=1e-30))
        rel5 = float((dw - dw_p).abs().max() / dw_p.abs().max().clamp(min=1e-30))
        b4, t4 = bound_ms(geom, WB, cin, cout, N, dtype, weights=True)
        b5, t5 = bound_ms(geom, WB, cin, cout, N, dtype, weights=False)
        print(f"{label}: covered={bool(geom.covered)} "
              f"(share {covered_share(geom, WB):.4f}); K4 {times['K4']:.3f} ms vs plain "
              f"{times['K4 plain']:.3f} ms (bound {b4:.4f} ms, {t4}) relerr={rel4:.2e}; "
              f"K5 {times['K5']:.3f} ms vs plain {times['K5 plain']:.3f} ms (bound "
              f"{b5:.4f} ms, {t5}) relerr={rel5:.2e}")
    # the ablations V2-V5, in the probe's bf16
    return 0 if run_variants(profile_variants(dev), args.iters) else 1


if __name__ == "__main__":
    sys.exit(main())
