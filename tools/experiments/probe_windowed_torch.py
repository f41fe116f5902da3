"""Probe: the port's windowed gather-GEMM conv kernels (K4 forward, K5 dW)
against their plain PyTorch versions on a CUDA GPU.

    python tools/experiments/probe_windowed_torch.py [--dtype bfloat16|float32]

The counterpart of ``probe_pallas_windowed.py``, at its three shapes (N =
163,840 rows, output blocks of 512, window blocks of 1024; (taps, cin,
cout, tap group) = (27, 32, 32, 9), (27, 96, 96, 9), (125, 8, 32, 25)) and
on its synthetic monotone rulebooks, plus ``probe_pallas_profile.py``'s
full kernel (27 taps, 32 -> 32, one window per tap, its rulebook of rows
shifted by up to 300 per entry). Per shape it prints the share of
output blocks whose entries fit their window (``covered``), K4's and K5's
time (CUDA events, after a warm-up) beside their plain versions', and the
relative error of each against the plain version on the same inputs. It
needs a CUDA device and refuses to run without one.
"""

from __future__ import annotations

import argparse
import os
import sys

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


def live_entries(geom, wb):
    """Entries inside their window: the ones the kernels multiply."""
    import torch

    k3, nb, _, block = geom.rbb.shape
    group = k3 // geom.w0.shape[0]
    rb = geom.rbb.reshape(k3, nb, block).to(torch.int64)
    lo = (geom.w0.to(torch.int64) * wb).repeat_interleave(group, 0)[:, :, None]
    return int(((rb >= lo) & (rb < lo + 2 * wb)).sum())


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


def bound_ms(geom, wb, cin, cout, n_in, dtype, weights=True):
    """The least time an H100 SXM could take for K4 (``weights``) or K5:
    max(bytes / 3.35 TB/s, FLOPs / peak) with each input read once and each
    output written once; FLOPs = 2 x in-window entries x cin x cout, at
    67 TFLOP/s (f32, CUDA cores) or 989 TFLOP/s (bf16). Returns (ms, term)."""
    import torch

    k3, nb, _, block = geom.rbb.shape
    elt = 2 if dtype == torch.bfloat16 else 4
    nrows = nb * block
    idx = 4 * (geom.rbb.numel() + geom.w0.numel())
    feat = n_in * cin * elt
    if weights:  # x, rulebook, W in; f32 out
        moved = feat + idx + k3 * cin * cout * elt + nrows * cout * 4
    else:  # x, rulebook, g in; f32 dW out
        moved = feat + idx + nrows * cout * elt + k3 * cin * cout * 4
    flops = 2.0 * live_entries(geom, wb) * cin * cout
    peak = 989e12 if dtype == torch.bfloat16 else 67e12
    t_bytes, t_ops = moved / 3.35e12 * 1e3, flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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
    from ponderv2_tpu_torch.ops import windowed_gather as wg

    torch.backends.cuda.matmul.allow_tf32 = False
    dtype = getattr(torch, args.dtype)
    dev = torch.device("cuda")
    wg.build_kernels()
    print(f"device {torch.cuda.get_device_name(0)}; dtype {args.dtype}; TF32 off")
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
