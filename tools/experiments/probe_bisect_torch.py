"""Probe: the port's kernels for the TPU compile bisects (P3, P4, P5)
against their plain PyTorch versions on a CUDA GPU.

    python tools/experiments/probe_bisect_torch.py [--iters 50]

The counterpart of ``probe_pallas_bisect.py`` (P3: ``k0`` a window copy,
``k1`` a one-window gather, ``k2`` the windowed forward, which is K4),
``probe_pallas_bisect2.py`` (P4: the window copy with static, prefetched,
data-dependent windows, then an added int32 term) and
``probe_pallas_bisect3.py`` (P5: ``ka`` a row's slab slots as a column,
``kb`` a lane concatenation, ``kc2`` a sum of 9 rows, ``kd`` a grouped
weight matmul). Each variant runs at its probe's shape on its probe's
inputs (``RandomState(0)``, drawn as the probe draws them). It prints the
kernel's device time with the L2 cache flushed before each call
(``probe_windowed_torch.measure``) beside its plain version's,
the library call's where one PyTorch call computes the same function
(``torch.cat`` for P5 ``kb``, ``torch.sum`` for ``kc2``, ``torch.mm`` for
``kd``), and the bound, and whether the kernel agrees with the plain
version. The window copies (P3 ``k0``, P4 A-D) sum 4 windows per block,
which no single call does; beside them it times a floor, a slice's
``copy_`` into an output of the same shape. Beside P5 ``kb`` it times x's
``copy_`` into the first 8 C columns of its output: all that ``kb`` reads,
8/9 of what it writes. Beside ``ka`` it times the ``copy_`` of rb's first
row into each of the 8 columns of its output: the same bytes read and
written with the conversion to f32, without the modulo and the mask. It
needs a CUDA device and refuses to run without one.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from probe_windowed_torch import (PEAK_BF16, PEAK_F32, Variant,  # noqa: E402
                                  live_entries, moved_bytes, probe_w0, rows_read,
                                  run_variants, window_rows_read)

N, B, WB, C = 8192, 512, 1024, 32
BISECT, BISECT2, BISECT3 = (f"tools/experiments/probe_pallas_bisect{s}.py"
                            for s in ("", "2", "3"))


def bisect_inputs(seed=0):
    """``probe_pallas_bisect.py``'s inputs: the rulebook (4, N) int32 (-1
    absent), its window table w0 (4, N / B), features (N + WB, C) and
    weights (4, C, C) x 0.05 in f32 (the probe rounds both to bf16)."""
    k3, nb = 4, N // B
    rng = np.random.RandomState(seed)
    rb = np.clip(np.sort(np.arange(N)[None, :].repeat(k3, 0)
                         + rng.randint(-40, 40, (k3, N)), axis=1), 0, N - 1).astype(np.int32)
    rb[rng.rand(k3, N) < 0.3] = -1
    n_pad = (N // WB + 1) * WB
    feats = rng.randn(n_pad, C).astype(np.float32)
    w = (rng.randn(k3, C, C) * 0.05).astype(np.float32)
    return rb, probe_w0(rb.reshape(k3, nb, B), WB, n_pad), feats, w


def bisect2_inputs(seed=0):
    """``probe_pallas_bisect2.py``'s inputs: features (N + WB, C) f32 (the
    probe rounds them to bf16) and the window table w0 (N / B,) int32."""
    rng = np.random.RandomState(seed)
    feats = rng.randn(N + WB, C).astype(np.float32)
    return feats, rng.randint(0, N // WB, (N // B,)).astype(np.int32)


def bisect3_inputs(seed=0):
    """``probe_pallas_bisect3.py``'s inputs: x (512, 8 C) f32, rb (16, 512)
    int32 in [-1, 511], w (1, 9 C, C) f32 and g (512, 9 C) f32 (the probe
    rounds x, w and g to bf16)."""
    b, tg = 512, 16
    rng = np.random.RandomState(seed)
    x = rng.randn(b, 8 * C).astype(np.float32)
    rb = rng.randint(-1, b, (tg, b)).astype(np.int32)
    w = rng.randn(1, 9 * C, C).astype(np.float32)
    return x, rb, w, rng.randn(b, 9 * C).astype(np.float32)


def _pair(fn, plain_fn, *args, **kw):
    """run(plain) of a port entry point and its plain version."""
    return lambda plain: (plain_fn if plain else fn)(*args, **kw)


def p3_variants(device):
    """``probe_pallas_bisect.py``'s k0, k1 and k2 (through K4)."""
    import torch

    from ponderv2_tpu_torch.ops import probe_kernels as pk
    from ponderv2_tpu_torch.ops import row_gather as rg
    from ponderv2_tpu_torch.ops import windowed_gather as wg

    rb, w0, feats, w = bisect_inputs()
    k3, nb = w0.shape
    rb = torch.from_numpy(rb).to(device)
    w0 = torch.from_numpy(w0).to(device)
    x = torch.from_numpy(feats).to(device).bfloat16()
    wt = torch.from_numpy(w).to(device).bfloat16()
    out_bytes = N * C * 4
    window = window_rows_read(w0, WB, np.arange(B)) * C * 2 + 4 * w0.numel()
    lo = (w0.to(torch.int64) * WB).repeat_interleave(B, 1)
    live = (rb >= lo) & (rb < lo + WB)
    gathered = int(torch.unique(rb[live]).numel()) * C * 2
    geom = wg.prepare_geometry(rb, N, B, WB, 1)
    return [
        Variant("P3 k0 window-copy", f"{BISECT}:68", pk.WINDOW_COPY_SUM,
                _pair(pk.window_copy_sum, pk.window_copy_sum_plain, x, w0, WB, B),
                "exact", window + out_bytes, float(k3 * N * C), PEAK_F32,
                floor=slice_copy(x)),
        Variant("P3 k1 onehot-lo", f"{BISECT}:78", rg.GATHER_SUM,
                _pair(rg.window_gather_sum, rg.window_gather_sum_plain, x, rb, w0, B, WB),
                "exact", gathered + 4 * (rb.numel() + w0.numel()) + out_bytes,
                float(k3 * N * C), PEAK_F32),
        Variant("P3 k2 full (K4)", f"{BISECT}:96", wg.WINDOWED_FWD,
                _pair(wg.windowed_conv_fwd, wg.windowed_conv_fwd_plain, x, geom, wt, WB, 1),
                "rel", moved_bytes(geom, C, C, rows_read(geom, WB), torch.bfloat16),
                2.0 * live_entries(geom, WB) * C * C, PEAK_BF16),
    ]


def slice_copy(x):
    """A window copy's floor: ``copy_`` of the first ``N`` rows of ``x``
    into an (N, C) f32 output, one window read per block instead of 4
    summed."""
    import torch

    out = torch.empty((N, C), dtype=torch.float32, device=x.device)
    return "a slice's copy_ to the (N, C) f32 output", lambda: out.copy_(x[:N])


def p4_variants(device):
    """``probe_pallas_bisect2.py``'s a.k, b.k, c.k and d.k: the window copy
    over 4 taps with window tables ``j mod 8`` (A, B) and ``w0[j]`` (C, D),
    D adding ``rb[(t nb + j) B]`` (its rb is zeros, as in the probe)."""
    import torch

    from ponderv2_tpu_torch.ops import probe_kernels as pk

    taps, nb = 4, N // B
    feats, w0 = bisect2_inputs()
    x = torch.from_numpy(feats).to(device).bfloat16()
    static = (torch.arange(nb, device=device, dtype=torch.int32) % (N // WB)).expand(taps, nb)
    dynamic = torch.from_numpy(w0).to(device).expand(taps, nb)
    rb = torch.zeros(nb * taps * B, dtype=torch.int32, device=device)
    add = rb.view(taps, nb, B)[:, :, 0]
    out = []
    for label, line, table, extra in (("A grid+static+revisit", 35, static, None),
                                      ("B prefetch+static", 54, static, None),
                                      ("C prefetch+dynamic-window", 76, dynamic, None),
                                      ("D +1d-int32-block", 100, dynamic, add)):
        moved = window_rows_read(table, WB, np.arange(B)) * C * 2 + 4 * nb + N * C * 4
        moved += 0 if extra is None else 4 * extra.numel()
        adds = taps * N * C * (1 if extra is None else 2)
        out.append(Variant(f"P4 {label}", f"{BISECT2}:{line}", pk.WINDOW_COPY_SUM,
                           _pair(pk.window_copy_sum, pk.window_copy_sum_plain, x, table,
                                 WB, B, extra),
                           "exact", moved, float(adds), PEAK_F32, floor=slice_copy(x)))
    return out


def p5_variants(device):
    """``probe_pallas_bisect3.py``'s ka, kb, kc2 and kd."""
    import torch

    from ponderv2_tpu_torch.ops import probe_kernels as pk

    x, rb, w, g = bisect3_inputs()
    b = rb.shape[1]
    x = torch.from_numpy(x).to(device).bfloat16()
    rb = torch.from_numpy(rb).to(device)
    w = torch.from_numpy(w).to(device).bfloat16()
    g = torch.from_numpy(g).to(device).bfloat16()
    cat_out = torch.empty((b, 9 * C), dtype=torch.float32, device=device)
    slot_out = torch.empty((b, 8), dtype=torch.float32, device=device)
    slices = [x[:, p % 8 * C:(p % 8 + 1) * C] for p in range(9)]
    return [
        Variant("P5 ka eye-transpose", f"{BISECT3}:54", pk.SLAB_SLOTS,
                _pair(pk.slab_slots, pk.slab_slots_plain, rb), "exact",
                4 * b + b * 8 * 4, float(2 * b), PEAK_F32,
                floor=(f"rb's first row's copy_ into each column of a ({b}, 8) f32 output",
                       lambda: slot_out.copy_(rb[0, :, None].expand(-1, 8)))),
        Variant("P5 kb lane-concat9", f"{BISECT3}:65", pk.LANE_CONCAT,
                _pair(pk.lane_concat, pk.lane_concat_plain, x, C, 9), "exact",
                x.numel() * 2 + b * 9 * C * 4, 0.0, PEAK_F32,
                lambda: torch.cat(slices, 1, out=cat_out),
                floor=(f"x's copy_ into the first {8 * C} columns of the ({b}, {9 * C}) f32 "
                       "output", lambda: cat_out[:, :8 * C].copy_(x))),
        Variant("P5 kc2 sublane-slices", f"{BISECT3}:83", pk.SUM_ROWS,
                _pair(pk.sum_rows, pk.sum_rows_plain, rb, 9), "exact",
                4 * 9 * b + 4 * b, float(9 * b), PEAK_F32,
                lambda: torch.sum(rb[:9], dim=0, dtype=torch.float32)),
        Variant("P5 kd grouped-weights-matmul", f"{BISECT3}:96", pk.TILE_MATMUL,
                _pair(pk.tile_matmul, pk.tile_matmul_plain, g, w), "rel",
                2 * (g.numel() + w.numel()) + 4 * b * C, 2.0 * b * 9 * C * C, PEAK_BF16,
                lambda: torch.mm(g, w[0])),
    ]


def slab_slots_empty_ms(device, iters=20):
    """An empty kernel at P5 ``ka``'s grid (``probe_kernels.cu`` with
    ``slab_slots`` emptied, ``probe_mma_variants_torch.SLOTS["empty"]``) on
    ``ka``'s inputs, timed as the probes are."""
    import torch

    import probe_mma_variants_torch as mv
    from ponderv2_tpu_torch.ops import probe_kernels as pk

    rb = torch.from_numpy(bisect3_inputs()[1]).to(device)
    return mv.empty_kernel_ms("probe_kernels", mv.SLOTS["empty"], pk.SLAB_SLOTS,
                              lambda: pk.slab_slots(rb), iters)


def variants(device):
    """Every ported function of the three bisect probes, in their order."""
    return p3_variants(device) + p4_variants(device) + p5_variants(device)


def main(argv=None) -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--iters", type=int, default=50)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_bisect_torch: needs a CUDA GPU", file=sys.stderr)
        return 2
    from ponderv2_tpu_torch.ops import probe_kernels as pk
    from ponderv2_tpu_torch.ops import row_gather as rg
    from ponderv2_tpu_torch.ops import windowed_gather as wg
    from ponderv2_tpu_torch.ops.cuda_build import load_libraries

    torch.backends.cuda.matmul.allow_tf32 = False
    load_libraries("row_gather", "windowed_gather", "probe_kernels")
    for mod in (rg, wg, pk):
        mod.build_kernels()
    print(f"device {torch.cuda.get_device_name(0)}; TF32 off")
    return 0 if run_variants(variants(torch.device("cuda")), args.iters) else 1


if __name__ == "__main__":
    sys.exit(main())
