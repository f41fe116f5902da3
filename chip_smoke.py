#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port: build the band and windowed conv
kernels and the probe kernels, check them, serve ScanNet-scale scenes,
train SpUNet-v1m1 at ScanNet's batch, pretrain PonderIndoor-v2 at bench.py's
workload and run every probe kernel at its probe's shape.

    python3 chip_smoke.py [--parent-log LOG]

Needs one CUDA GPU (Hopper: the kernels are built for sm_90a) and runs in
phases; any failure exits non-zero:

1. print the card's name and power limit; refuse to run without CUDA;
2. build every kernel with nvcc, one process per source in parallel: K1
   (``ponderv2_tpu_torch/csrc/band_conv.cu``), K2 and K3
   (``csrc/band_conv_bwd.cu``; K1-K5, P5 ``kd`` and P7 V2-V4 on the
   tensor-core tiles of ``csrc/mma_tile.cuh``), K4, K5 and the P7
   ablations' forward on K4's kernel (``csrc/windowed_gather.cu``), the row
   gather-sum (``csrc/row_gather.cu``) and the window-read and
   grouped-construct kernels (``csrc/probe_kernels.cu``); print ptxas
   registers and spills;
3. compare K1 with its plain PyTorch version on the card at every distinct
   (level, Cin, Cout) band conv of the serving slice, at the level row
   counts of a real fragment, in f32 (TF32 off) and bf16, plus a
   window-overflow case and a zero-gated (``pair_budget=0``) case, and time
   both; print each conv's live entries and the rows the compacted and the
   slab tile multiply (K1 runs the first in f32 and the second in bf16, K2's
   dx the second), counted from the plan;
4. serve ``configs/_test_/semseg_spunet_scannet_synthetic.py`` through
   ``tools/test_torch.py:main_worker`` with seeded random weights: 2 scenes x
   4 rotations x (6 or 9) fragments = 60 forwards of 78-85k voxels at full
   width; check K1's launch count, every ``contract_ok`` and the logits;
5. run one fragment again with K1 replaced by its plain version and compare
   the logits;
6. train ``configs/_test_/semseg_spunet_scannet_synthetic_train.py``
   through ``tools/train_torch.py:main_worker``: 3 steps of 12 scenes
   (1,572,864-row budget) at full width and depth, then one SemSegEvaluator
   pass; check every step's loss, ``contract_ok``, lr and K1/K2/K3 launch
   counts against the routing, and that the checkpoint loads;
7. compare K1, K2 and K3 with their plain versions at every distinct
   (level, Cin, Cout) band conv of that training batch, in f32 and bf16,
   time each in f32 where the step runs it (with the rows K1 and K2's dx
   multiply), and run the backward through
   the autograd wrapper with window overflow and with ``pair_budget=0``;
8. run one step's forward and backward from the saved state twice with
   the kernels, then twice with all three replaced by their plain versions
   (and once more with the plain versions summing in another order: taps
   reversed, dW rows in two halves); require equal bits between the two
   runs of each path (loss and every gradient), and hold the kernel path's
   loss and gradients to the plain path's (each gradient within 1e-3 of its
   max|ref| plus 3x its difference between the plain and the reordered
   plain run);
9. pretrain ``configs/_test_/pretrain_bench_torch.py`` (bench.py's
   workload: PonderIndoor-v2 with SpUNet-v1m1, UNet3D-v1m2 and NeuS at full
   width, bf16, batch 2 of 100k-point RGB-D scenes) through
   ``tools/train_torch.py:main_worker`` for 3 steps; check every step's
   loss, ``contract_ok``, lr and K1/K2/K3 launches against the routing;
10. compare K1, K2 and K3 with their plain versions at every distinct
    (level, Cin, Cout) band conv of that pretrain batch, in f32 and bf16,
    and time each in bf16 (the step's dtype) where the step runs it (with
    the rows K1 and K2's dx multiply);
11. run one pretrain step's forward and backward from the seeded state
    (the same random draws each time) as in 8: equal bits run to run on
    each path, and kernel vs plain within 3e-2 (the bf16 bound of
    bench.py:227) of max|ref| plus 3x the reordered plain run's difference;
12. run the windowed conv entry point
    (``tools/experiments/probe_windowed_torch.py:windowed_conv``, K4 and
    K5) in bf16 at the probe's four shapes and on two rulebooks of the
    pretrain batch (the k5 stem's, 6->32, and L0's k3 at 32->32), count
    its launches, compare each kernel with its plain version in f32 and
    bf16, require equal bits from a second launch in each dtype, time both
    (and the kernels in f32), and report the share of covered windows, the
    tile each kernel ran and the rows it multiplies against the live
    entries (counted from the geometry); with ``--parent-log`` (a log of
    another tree's run) each conv's bf16 times beside that tree's;
13. run every ported probe function (P1-P5, P7 V2-V5; PERF.md's kernel
    table) through its entry point (``tools/experiments/
    probe_{gather,bisect,windowed}_torch.py``) at its probe's shape and on
    its inputs, with the counts set to 0 before each and read after: its
    kernel launched once and no other; hold each against its plain version
    on the card (equal, or within 1e-5 of max|ref| where the products are
    summed in another order: P3 ``k2`` through K4, P5 ``kd``, P7 V2-V4) and
    time kernel, plain version and library call on the device (replayed
    from a CUDA graph, the L2 flushed before each call; the kernel with it
    warm too) and per call issued from Python; for P7 V2-V4 (K4's slab
    tile) print the rows multiplied against the live entries; with
    ``--parent-log`` each kernel's time beside that tree's;
14. print times and peak memory, a JSON line of the kernels, and last
    ``{"ok": true, "device": {...}}``.
"""

import argparse
import gc
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "configs/_test_/semseg_spunet_scannet_synthetic.py")
TRAIN_CONFIG = os.path.join(ROOT, "configs/_test_/semseg_spunet_scannet_synthetic_train.py")
PRETRAIN_CONFIG = os.path.join(ROOT, "configs/_test_/pretrain_bench_torch.py")
SEED = 0
# band convs per forward of SpUNet-v1m1 at ScanNet's sparse_shape, from the
# routing (models/sparse_unet/layers.py:subm_route): L0 runs the last decoder
# stage's 2 blocks (4 convs, inline band plans since cin > 64); L1-L4 carry
# attached band plans and run enc/dec blocks 2+2, 3+2, 4+2 and 6 -> 8, 10,
# 12, 12 convs. The stem (k5), strided/inverse convs and head are not band.
BAND_CONVS_PER_FORWARD = 46
KERNEL_SOURCES = {
    "band_fwd_core": ("ponderv2_tpu_torch/csrc/band_conv.cu",
                      "ponderv2_tpu/ops/band_conv.py:192"),
    "band_dxdw_core": ("ponderv2_tpu_torch/csrc/band_conv_bwd.cu",
                       "ponderv2_tpu/ops/band_conv.py:278"),
    "band_dw_core": ("ponderv2_tpu_torch/csrc/band_conv_bwd.cu",
                     "ponderv2_tpu/ops/band_conv.py:222"),
    "windowed_conv_fwd": ("ponderv2_tpu_torch/csrc/windowed_gather.cu",
                          "ponderv2_tpu/ops/pallas_gather.py:147"),
    "windowed_conv_dw": ("ponderv2_tpu_torch/csrc/windowed_gather.cu",
                         "ponderv2_tpu/ops/pallas_gather.py:197"),
}
BAND_CORES = ("band_fwd_core", "band_dxdw_core", "band_dw_core")
# H100 SXM peaks (NVIDIA's data sheet, 700 W): HBM bytes/s; FLOP/s of bf16
# on the tensor cores, and of f32 at f32 accuracy: 3xTF32 (K2's f32 route,
# three TF32 products per f32 product) at a third of the 495 TFLOP/s TF32
# rate, above the CUDA cores' 67
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 495e12 / 3}
F32_PEAK = "165 TFLOP/s: 3xTF32, a third of the 495 TFLOP/s TF32 rate"
# what "ms" of a K1-K5 row is (the probe rows say theirs)
EAGER_TIMING = ("CUDA events around calls issued one by one from Python after a "
                "warm-up, L2 not flushed")


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


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


def max_err(out, ref):
    return (out - ref.float()).abs().max().item(), ref.float().abs().max().item()


def seeded_state_dict(model, batch, device):
    """Seeded random weights, with BN running stats calibrated on one
    fragment (train-mode statistics taken with momentum 1), so activations
    keep their scale through the ~60 layers instead of shrinking."""
    import torch

    from ponderv2_tpu_torch.models.norm import MaskedBatchNorm

    model.reset_parameters(torch.Generator().manual_seed(SEED))
    model.to(device)
    bns = [m for m in model.modules() if isinstance(m, MaskedBatchNorm)]
    for m in bns:
        m.momentum = 1.0
    model.train()
    with torch.no_grad():
        model(batch)
    for m in bns:
        m.momentum = 0.01
    model.eval()
    return {k: v.detach().cpu() for k, v in model.state_dict().items()}


def band_convs(spunet, level_rb):
    """Every band conv of one SpUNet forward: {(level, cin, cout): count}."""
    from ponderv2_tpu_torch.models.sparse_unet.layers import subm_route

    convs = {}
    for level, blocks in ([(s + 1, spunet.enc[s]) for s in range(4)]
                          + [(r, spunet.dec[r]) for r in range(4)]):
        for block in blocks.values():
            for conv in (block.conv1, block.conv2):
                key = (level, conv.in_channels, conv.out_channels)
                if subm_route(level_rb[level], *key[1:], 3).startswith("band"):
                    convs[key] = convs.get(key, 0) + 1
    return convs


def level_plans(spunet, st):
    """The conv plans of ``st`` as the backbone builds them: per level the
    k3 plan (SubmPlan or plain rulebook) and the level's coords, and the k5
    stem's plan."""
    from ponderv2_tpu_torch.models.sparse_unet.plans import (
        build_spunet_plans_auto, capacity_schedule)

    plans = build_spunet_plans_auto(
        st.coords, st.spatial_shape, st.batch_size,
        spunet.capacities or capacity_schedule(st.capacity, spunet.num_stages),
        spunet.channels)
    return ([plans.l0] + list(plans.subm),
            [st.coords] + [s[0] for s in plans.strided], plans.stem)


def band_routing(spunet, level_rb):
    """The band convs of one forward and their backward route: ({(level,
    cin, cout): count}, {key: fused}, K1/K2/K3 launches per train step)."""
    from ponderv2_tpu_torch.ops import band_conv as bc

    convs = band_convs(spunet, level_rb)
    fused = {key: bc.fused_bwd_fits(-(-key[1] // 128) * 128, -(-key[2] // 128) * 128)
             for key in convs}
    n_band = sum(convs.values())
    n_fused = sum(c for key, c in convs.items() if fused[key])
    return convs, fused, [n_band + (n_band - n_fused), n_fused, n_band - n_fused]


def bound_ms(moved_bytes, flops, dtype):
    """The least time an H100 SXM could take: (max(bytes / 3.35 TB/s,
    FLOPs / peak of the dtype) in ms, the bytes-time, the FLOP-time)."""
    t_bytes = moved_bytes / HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[str(dtype).rsplit(".", 1)[-1]] * 1e3
    return max(t_bytes, t_ops), t_bytes, t_ops


def band_live_mask(plan, n, kz=3, block=None, window=None):
    """(n, K^3) bool: the in-window entries of a band plan over its first
    ``n`` rows, the ones K1-K3 multiply (overflow entries go to the plain
    residual); ``block``/``window`` default to the band conv's."""
    import torch

    from ponderv2_tpu_torch.ops import band_conv as bc

    block, window = block or bc.BLOCK, window or bc.WINDOW
    rbt = plan.rbt[:n].to(torch.int64)
    i = torch.arange(n, device=rbt.device)
    cols = torch.arange(rbt.shape[1], device=rbt.device) // kz
    pos = rbt - plan.w0.to(torch.int64)[cols[None, :], (i // block)[:, None]]
    return (rbt >= 0) & (pos >= 0) & (pos < window)


def band_live_entries(plan, n, kz=3):
    return int(band_live_mask(plan, n, kz).sum())


def band_rows_multiplied(plan, n, kz=3, block=None, window=None):
    """(in-window entries, rows the compacted tile multiplies, rows the slab
    tile multiplies) of a band plan over its first ``n`` rows, per output
    column tile, counted from the plan as the tiles decide: the compacted
    tile (``mma_tile.cuh:compact_gather_gemm``, K1 in f32) multiplies, per
    tile of ``K1_TILE`` rows and tap, the live entries rounded up to whole
    16-row slabs; the slab tile (``gather_gemm``: K2's dx, K1 in bf16)
    every 16-row slab that holds a live entry of the tap."""
    import torch

    from ponderv2_tpu_torch.ops import band_conv as bc

    live = band_live_mask(plan, n, kz, block, window)
    k3 = live.shape[1]
    rows = bc.K1_TILE[0]
    live = torch.cat([live, live.new_zeros((-n % rows, k3))])
    per_tile = live.reshape(-1, rows, k3).sum(1)
    compacted = int(((per_tile + 15) // 16 * 16).sum())
    slabs = int(live.reshape(-1, 16, k3).any(1).sum()) * 16
    return int(live.sum()), compacted, slabs


def k1_tile(dtype):
    """Which tile K1 runs in ``dtype`` (``ops/band_conv.py:fwd_plan``)."""
    from ponderv2_tpu_torch.ops import band_conv as bc

    return "compacted" if bc.fwd_plan(1, 8, 8, 27, dtype).compact else "slabs"


def band_op_bound(op, plan, n, cin, cout, dtype):
    """``bound_ms`` of one band-conv kernel call: each input read once,
    each output written once; 2 FLOPs per in-window entry and channel pair
    (twice that for K2's dx + dW), f32 at the 3xTF32 rate (``F32_PEAK``)."""
    import torch

    elt = 2 if dtype == torch.bfloat16 else 4
    idx = 4 * (plan.rbt.numel() + plan.w0.numel())
    wts = 27 * cin * cout * elt
    fin, gin, dx, dw = n * cin * elt, n * cout * elt, n * cin * 4, 27 * cin * cout * 4
    moved = {"fwd": fin + idx + wts + n * cout * 4, "dx": gin + idx + wts + dx,
             "dxdw": gin + fin + idx + wts + dx + dw, "dw": fin + gin + idx + dw}[op]
    flops = 2.0 * band_live_entries(plan, n) * cin * cout * (2 if op == "dxdw" else 1)
    return bound_ms(moved, flops, dtype)


def compare_band_kernels(convs, fused, level_rb, level_coords, gen, dtype, stats):
    """K1, K2 and K3 against their plain versions at every band conv of
    ``convs`` ({(level, cin, cout): count per forward}), in f32 (1e-4 of
    max(|ref|, 1)) and bf16 (3e-2 of max|ref|); each op the train step runs
    on a conv is timed in ``dtype`` and added, times its count, to
    ``stats[core]`` (ms, plain_ms, bound_ms, bytes_ms, ops_ms, err, err_bf16)."""
    import torch

    from ponderv2_tpu_torch.ops import band_conv as bc

    dev = level_coords[0].device
    owner = {"fwd": "band_fwd_core", "dx": "band_fwd_core",
             "dxdw": "band_dxdw_core", "dw": "band_dw_core"}
    for (level, cin, cout), count in sorted(convs.items()):
        legacy, plan = band_plan_of(level_rb[level])
        n = legacy.shape[1]
        valid = (level_coords[level][:, 0] >= 0)[:, None]
        f = torch.randn(n, cin, device=dev, generator=gen) * valid
        g = torch.randn(n, cout, device=dev, generator=gen) * valid
        w = torch.randn(27, cin, cout, device=dev, generator=gen) / (27 * cin) ** 0.5
        wmt = w.flip(0).transpose(1, 2).contiguous()
        args, tail = (plan.rbt, plan.w0), (3, bc.BLOCK, bc.WINDOW)
        calls = {
            "fwd": (lambda a, b, c, d: bc.band_fwd_core(a, *args, c, *tail),
                    lambda a, b, c, d: bc.band_fwd_core_plain(a, *args, c, *tail)),
            "dx": (lambda a, b, c, d: bc.band_fwd_core(b, *args, d, *tail),
                   lambda a, b, c, d: bc.band_fwd_core_plain(b, *args, d, *tail)),
            "dxdw": (lambda a, b, c, d: bc.band_dxdw_core(b, a, *args, d, *tail),
                     lambda a, b, c, d: bc.band_dxdw_core_plain(b, a, *args, d, *tail)),
            "dw": (lambda a, b, c, d: bc.band_dw_core(a, b, *args, *tail),
                   lambda a, b, c, d: bc.band_dw_core_plain(a, b, *args, *tail)),
        }
        low = (f.bfloat16(), g.bfloat16(), w.bfloat16(), wmt.bfloat16())
        timed = low if dtype == torch.bfloat16 else (f, g, w, wmt)
        line = []
        for op, (kern, plain) in calls.items():
            def pairs(outs, refs):
                return list(zip(outs, refs)) if op == "dxdw" else [(outs, refs)]

            errs = [max_err(o, r) for o, r in pairs(kern(f, g, w, wmt), plain(f, g, w, wmt))]
            torch.cuda.synchronize()
            check(all(e <= 1e-4 * max(s, 1.0) for e, s in errs),
                  f"{op} f32 L{level} {cin}->{cout}: {errs}")
            errs_b = [max_err(o, r) for o, r in pairs(kern(*low), plain(*low))]
            check(all(e <= 3e-2 * s for e, s in errs_b),
                  f"{op} bf16 L{level} {cin}->{cout}: {errs_b}")
            st = stats[owner[op]]
            st["err"] = max(st["err"], max(e for e, _ in errs))
            st["err_bf16"] = max(st["err_bf16"], max(e for e, _ in errs_b))
            # time where the step runs it: the forward on every band conv,
            # K2 on the fused ones, K1 (dx) + K3 on the split ones
            runs = {"fwd": True, "dx": not fused[(level, cin, cout)],
                    "dxdw": fused[(level, cin, cout)],
                    "dw": not fused[(level, cin, cout)]}[op]
            timing = ""
            if runs:
                t_k = cuda_ms(lambda: kern(*timed), 5)
                t_p = cuda_ms(lambda: plain(*timed), 3)
                b, b_bytes, b_ops = band_op_bound(op, plan, n, cin, cout, dtype)
                for key, v in (("ms", t_k), ("plain_ms", t_p), ("bound_ms", b),
                               ("bytes_ms", b_bytes), ("ops_ms", b_ops)):
                    st[key] += count * v
                timing = f" {t_k:.3f}/{t_p:.3f} ms (bound {b:.4f})"
            line.append(f"{op} err {max(e for e, _ in errs):.2e} "
                        f"bf16 {max(e for e, _ in errs_b):.2e}{timing}")
        live, compacted, slabs = band_rows_multiplied(plan, n)
        print(f"[band] L{level} rows {n} {cin}->{cout} x{count} "
              f"{'fused' if fused[(level, cin, cout)] else 'split'}: " + "; ".join(line)
              + f"; live entries {live}, rows multiplied per column tile: compacted "
              f"{compacted}, slabs {slabs} (K1 {k1_tile(dtype)}, K2's dx slabs)")
        del f, g, w, wmt, low, timed


def reordered_fwd(f, rbt, w0, w, kz, block, window):
    """K1's function as its plain version computes it, but with the taps
    summed in reverse: another f32 order, for the spread of a grads check."""
    from ponderv2_tpu_torch.ops import band_conv as bc

    n = f.shape[0]
    out = 0.0
    for t in reversed(range(w.shape[0])):
        out = out + bc._tap_rows(f, rbt, w0, t, n, kz, block, window).float() @ w[t].float()
    return out


def reordered_dw(f, g, rbt, w0, kz, block, window):
    """K3's function with the rows summed in two halves, the second first."""
    import torch

    from ponderv2_tpu_torch.ops import band_conv as bc

    n = f.shape[0]
    h = n // 2
    ff = f.float()
    dwr = []
    for t in range(rbt.shape[1]):
        rows = bc._tap_rows(g, rbt, w0, t, n, kz, block, window).float()
        dwr.append(ff[h:].T @ rows[h:] + ff[:h].T @ rows[:h])
    return torch.stack(dwr)


def reordered_dxdw(g, f, rbt, w0, wmt, kz, block, window):
    """K2's function summed in another order (``reordered_fwd``,
    ``reordered_dw``)."""
    return (reordered_fwd(g, rbt, w0, wmt, kz, block, window),
            reordered_dw(f, g, rbt, w0, kz, block, window))


def band_plan_of(rb):
    """The band plan a conv on this level runs (attached, or inline with
    the budget retry, as SubMConv builds it)."""
    from ponderv2_tpu_torch.ops import band_conv as bc
    from ponderv2_tpu_torch.ops.spconv import SubmPlan

    if isinstance(rb, SubmPlan):
        return rb.legacy, rb.band
    return rb, bc.build_band_plan_auto(rb, 3)


def windowed_cases(probe, dev, level_rb, stem):
    """Phase 12's six convs, (label, tap group, rulebook (k3, n) int32 on
    ``dev``, cin, cout): the probe's four shapes (``probe``:
    ``probe_windowed_torch``), then the rulebooks of the pretrain batch's k5
    stem (6 -> 32) and L0 k3 convs (32 -> 32) from ``level_plans``."""
    import numpy as np
    import torch

    from ponderv2_tpu_torch.ops.spconv import SubmPlan

    def legacy(rb):
        return (rb.legacy if isinstance(rb, SubmPlan) else rb).contiguous()

    return ([(f"probe {label}", group, torch.from_numpy(rb).to(dev), cin, cout)
             for label, group, rb, cin, cout in probe.cases(np.random.RandomState(SEED))]
            + [("pretrain stem k5 6->32", 25, legacy(stem), 6, 32),
               ("pretrain L0 k3 32->32", 9, legacy(level_rb[0]), 32, 32)])


def parent_times(path):
    """{conv label: (K4 ms, K5 ms)} from the ``[windowed]`` lines of another
    tree's phase 12 log, in bf16."""
    line = re.compile(r"^\[windowed\] (.+?) \(\d+ rows, group \d+\):.*? K4 ([\d.]+) ms"
                      r".*? K5 ([\d.]+) ms")
    with open(path) as f:
        return {m[1]: (float(m[2]), float(m[3])) for m in map(line.match, f) if m}


def parent_probe_times(path):
    """{probe function: kernel ms (device, L2 cold)} from the ``[probe]``
    lines of another tree's phase 13 log."""
    line = re.compile(r"^\[probe\] (.+?) \([^()]*\): .*?kernel / plain / library ([\d.]+) /")
    with open(path) as f:
        return {m[1]: float(m[2]) for m in map(line.match, f) if m}


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent-log",
                        help="print phases 12's and 13's times beside this log's")
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke needs "
              "a CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    sys.path.insert(0, os.path.join(ROOT, "tools", "experiments"))
    import numpy as np

    from ponderv2_tpu_torch.datasets import build_dataset, collate_fn
    from ponderv2_tpu_torch.engines.common import split_batch
    from ponderv2_tpu_torch.engines.defaults import default_config_parser
    from ponderv2_tpu_torch.engines.hooks import HookBase
    from ponderv2_tpu_torch.models import build_model
    from ponderv2_tpu_torch.models.default import batch_to_sparse_tensor
    from ponderv2_tpu_torch.models.sparse_unet.layers import SubMConv
    from ponderv2_tpu_torch.ops import band_conv as bc
    from ponderv2_tpu_torch.ops import probe_kernels as pk
    from ponderv2_tpu_torch.ops import row_gather as rg
    from ponderv2_tpu_torch.ops import windowed_gather as wg
    from ponderv2_tpu_torch.ops.cuda_build import BUILD_LOGS, load_libraries
    from ponderv2_tpu_torch.ops.sparse import make_sparse_tensor, maybe_sort_by_key
    from ponderv2_tpu_torch.ops.spconv import SubmPlan, apply_sparse_conv
    from ponderv2_tpu_torch.utils.config import Config
    from test_torch import main_worker
    from train_torch import main_worker as train_main_worker
    import probe_bisect_torch
    import probe_gather_torch
    import probe_windowed_torch as probe

    phase_s = {}
    tic = time.perf_counter()

    def phase_done(name):
        nonlocal tic
        now = time.perf_counter()
        phase_s[name] = now - tic
        print(f"[phase] {name}: {phase_s[name]:.2f} s", flush=True)
        tic = now

    # ---- 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}; "
          "TF32 off for matmul and cuDNN")
    phase_done("1 card")

    # ---- 2. build every kernel: one nvcc per source, all started together
    all_kernels = bc.KERNELS + wg.KERNELS + wg.PROBE_KERNELS + rg.KERNELS + pk.KERNELS
    sources = sorted({k.source for k in all_kernels})
    load_libraries(*sources)
    for module in (bc, wg, rg, pk):
        module.build_kernels()
    for name in sources:
        for ln in BUILD_LOGS.get(name, "").splitlines():
            if "registers" in ln or "spill" in ln or "Compiling entry" in ln:
                print(f"[build] {name}: {ln.strip()}")
    phase_done("2 build")

    # per kernel and path: max error vs plain (f32, bf16), and the ms of the
    # kernel, its plain version and its bound over one train step (or, for
    # K4/K5, one run of the windowed conv entry point)
    def new_stats():
        return {name: dict(err=0.0, err_bf16=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0,
                           bytes_ms=0.0, ops_ms=0.0) for name in KERNEL_SOURCES}

    stats, pstats = new_stats(), new_stats()  # fine-tune path; pretrain path

    cfg = Config.fromfile(CONFIG)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        cfg.save_path = tmp
        cfg.seed = SEED
        cfg.device = "cuda"
        model = build_model(dict(cfg.model))
        spunet = model.backbone
        dataset = build_dataset(dict(cfg.data.test))
        # scene 0 gives 4 x 6 fragments, scene 1 4 x 9 (the most points in
        # one 2 cm voxel sets the count): 60 forwards
        scenes = [dataset[i] for i in range(len(dataset))]
        n_fragments = sum(len(s["fragment_list"]) for s in scenes)
        frag = scenes[0]["fragment_list"][0]
        batch = collate_fn([dict(frag)], point_budget=cfg.point_budget_test,
                           scene_budget=1)
        arrays, _ = split_batch(batch)
        inputs = {k: torch.as_tensor(v, device=dev) for k, v in arrays.items()}
        inputs.update(spatial_shape=tuple(cfg.sparse_shape), batch_size=1)

        # ---- 3. K1 against its plain version at the serving slice's shapes
        coords = torch.cat([inputs["batch"][:, None].int(),
                            inputs["grid_coord"].int()], 1)
        st = make_sparse_tensor(inputs["feat"], coords, cfg.sparse_shape, 1)
        level_rb, level_coords, _ = level_plans(spunet, st)
        convs = band_convs(spunet, level_rb)
        check(sum(convs.values()) == BAND_CONVS_PER_FORWARD,
              f"routing gives {sum(convs.values())} band convs per forward")

        gen = torch.Generator(device=dev).manual_seed(SEED)
        k1_serve_err, k1_ms, plain_ms = 0.0, 0.0, 0.0
        for (level, cin, cout), count in sorted(convs.items()):
            legacy, plan = band_plan_of(level_rb[level])
            n = legacy.shape[1]
            valid = (level_coords[level][:, 0] >= 0)[:, None]
            f = torch.randn(n, cin, device=dev, generator=gen) * valid
            w = torch.randn(27, cin, cout, device=dev, generator=gen) / (27 * cin) ** 0.5
            args = (plan.rbt, plan.w0)
            tail = (3, bc.BLOCK, bc.WINDOW)
            out = bc.band_fwd_core(f, *args, w, *tail)
            ref = bc.band_fwd_core_plain(f, *args, w, *tail)
            torch.cuda.synchronize()
            err, scale = max_err(out, ref)
            # f32 both ways; only the order of the 27 x Cin-term sums differs
            check(err <= 1e-4 * max(scale, 1.0),
                  f"K1 f32 L{level} {cin}->{cout}: err {err:.3e} scale {scale:.3e}")
            fb, wb = f.bfloat16(), w.bfloat16()
            errb, _ = max_err(bc.band_fwd_core(fb, *args, wb, *tail),
                              bc.band_fwd_core_plain(fb, *args, wb, *tail))
            # bf16 inputs, f32 products and sums in both, in another order;
            # held to the bench's bf16 bound, 3e-2 (bench.py:227)
            check(errb <= 3e-2 * scale, f"K1 bf16 L{level} {cin}->{cout}: err {errb:.3e}")
            t_k = cuda_ms(lambda: bc.band_fwd_core(f, *args, w, *tail), 10)
            t_p = cuda_ms(lambda: bc.band_fwd_core_plain(f, *args, w, *tail), 10)
            k1_serve_err = max(k1_serve_err, err)
            k1_ms += count * t_k
            plain_ms += count * t_p
            live, compacted, slabs = band_rows_multiplied(plan, n)
            print(f"[K1] L{level} rows {n} {cin}->{cout} x{count}: max_abs_err f32 "
                  f"{err:.3e} (max|ref| {scale:.3e}) bf16 {errb:.3e}; "
                  f"K1 ({k1_tile(torch.float32)}) {t_k:.4f} ms plain {t_p:.4f} "
                  f"ms; band ok {bool(plan.ok)} overflow entries {sum(plan.ov_counts)}; live "
                  f"entries {live}, rows multiplied per column tile: compacted {compacted}, "
                  f"slabs {slabs}")

        # window overflow (block 32 / window 8) and budget gating, through
        # the whole band_subm_conv wrapper against the plain gather conv
        rb4 = level_rb[4]
        n4 = rb4.legacy.shape[1]
        mask4 = level_coords[4][:, 0] >= 0
        f4 = torch.randn(n4, 256, device=dev, generator=gen) * mask4[:, None]
        w4 = torch.randn(27, 256, 256, device=dev, generator=gen) / (27 * 256) ** 0.5
        ovf_plan = bc.build_band_plan(rb4.legacy, 3, block=32, window=8,
                                      pair_budget=10 ** 6, entry_budget=27 * n4)
        check(bool(ovf_plan.ok) and sum(ovf_plan.ov_counts) > 0,
              "block 32 / window 8 plan should be ok with overflow entries")
        with torch.no_grad():
            out = bc.band_subm_conv((3, 32, 8), f4, ovf_plan, w4, mask4)
        ref = apply_sparse_conv(f4, rb4.legacy, w4, mask4)
        err = (out - ref).abs().max().item()
        check(err <= 1e-4 * max(ref.abs().max().item(), 1.0),
              f"overflow case err {err:.3e}")
        k1_serve_err = max(k1_serve_err, err)
        print(f"[K1] block 32 / window 8 at L4: {sum(ovf_plan.ov_counts)} overflow "
              f"entries, max_abs_err vs plain conv {err:.3e}")
        gated = bc.build_band_plan(rb4.legacy, 3, block=32, window=8, pair_budget=0)
        check(not bool(gated.ok), "pair_budget=0 plan should not be ok")
        with torch.no_grad():
            zero = bc.band_subm_conv((3, 32, 8), f4, gated, w4, mask4)
        check(float(zero.abs().sum()) == 0.0, "pair_budget=0 must give exact zeros")
        print("[K1] pair_budget=0: ok False, output exactly zero")
        stats["band_fwd_core"]["err"] = k1_serve_err
        phase_done("3 K1 vs plain, serving shapes")

        # ---- 4. the serving slice: all fragments through main_worker
        weights = os.path.join(tmp, "spunet_seeded.pth")
        torch.save(seeded_state_dict(model, inputs, dev), weights)
        cfg.weight = weights
        torch.cuda.reset_peak_memory_stats(dev)
        for k in bc.KERNELS:
            k.launches = 0
        t0 = time.perf_counter()
        tester = main_worker(cfg)
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        serve_launches = [k.launches for k in bc.KERNELS]
        serve_peak_gib = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        forwards = len(tester.fragment_seconds)
        routes = [m.last_route for m in tester.model.modules()
                  if isinstance(m, SubMConv)]
        per_fwd = sum(r.startswith("band") for r in routes)
        print(f"[slice] {forwards} forwards in {serve_s:.2f} s; K1 launches "
              f"{serve_launches[0]}; band convs in the last forward {per_fwd}; peak "
              f"memory {serve_peak_gib:.3f} GiB")
        check(forwards == n_fragments,
              f"expected {n_fragments} forwards, ran {forwards}")
        check(per_fwd == BAND_CONVS_PER_FORWARD, f"last forward ran {per_fwd} band convs")
        check(serve_launches == [BAND_CONVS_PER_FORWARD * forwards, 0, 0],
              f"serving launches (K1, K2, K3) {serve_launches} != "
              f"({BAND_CONVS_PER_FORWARD} x {forwards}, 0, 0)")
        check(all(tester.contract_ok), "a forward reported contract_ok False")
        phase_done("4 serving slice")

        # ---- 5. one fragment through the plain versions, same weights
        def run(plain):
            core = bc.band_fwd_core
            if plain:
                bc.band_fwd_core = bc.band_fwd_core_plain
            try:
                torch.cuda.synchronize()
                t = time.perf_counter()
                with torch.inference_mode():
                    out = tester.model(inputs)
                logits = out["seg_logits"].float()
                torch.cuda.synchronize()
                return logits, bool(out["contract_ok"]), time.perf_counter() - t
            finally:
                bc.band_fwd_core = core

        lk, ok_k, t_k1 = run(False)
        lp, ok_p, t_p1 = run(True)
        _, _, t_p2 = run(True)
        _, _, t_k2 = run(False)
        valid = inputs["batch"] >= 0
        check(ok_k and ok_p, "contract_ok False on the check fragment")
        check(tuple(lk.shape) == (cfg.point_budget_test, 20), f"logits shape {lk.shape}")
        check(bool(torch.isfinite(lk).all()), "non-finite logits")
        check(float(lk[~valid].abs().sum()) == 0.0, "padding rows must be zero")
        scale = lk.abs().max().item()
        diff = (lk - lp).abs().max().item()
        check(diff <= 1e-4 * scale, f"kernel vs plain logits: {diff:.3e} > 1e-4 x {scale:.3e}")
        frag_ms = 1e3 * float(np.median(tester.fragment_seconds))
        print(f"[slice] kernel vs plain path logits: max_abs_diff {diff:.3e}, "
              f"max|logits| {scale:.3e}")
        print(f"[time] per-fragment latency in the tester (median of {forwards}, "
              f"host to logits on host): {frag_ms:.2f} ms")
        print(f"[time] one fragment's forward, kernel path {1e3 * t_k1:.2f} / "
              f"{1e3 * t_k2:.2f} ms, plain path {1e3 * t_p1:.2f} / {1e3 * t_p2:.2f} ms")
        print(f"[time] K1 per serving forward ({BAND_CONVS_PER_FORWARD} band convs): "
              f"{k1_ms:.3f} ms vs plain {plain_ms:.3f} ms")
        del tester, model, spunet, level_rb, level_coords, st, inputs
        gc.collect()
        torch.cuda.empty_cache()
        phase_done("5 serving kernel vs plain")

        # ---- 6. the training slice: 3 steps + one evaluation via main_worker
        def step_probe(records):
            class StepProbe(HookBase):
                """Per step: the synced metrics, the step's K1-K5 launches
                and the lr the schedule gives; keeps the first batch."""

                def before_step(self):
                    self.before = [k.launches for k in bc.KERNELS + wg.KERNELS]

                def after_step(self):
                    trainer = self.trainer
                    metrics = trainer.sync_metrics()
                    metrics["launches"] = [k.launches - b for k, b
                                           in zip(bc.KERNELS + wg.KERNELS, self.before)]
                    metrics["schedule_lr"] = trainer.schedule(trainer.step - 1)
                    records["steps"].append(metrics)
                    records.setdefault("batch", trainer.comm_info["input_dict"])

            return StepProbe

        records = {"steps": []}
        tcfg = default_config_parser(TRAIN_CONFIG, {"save_path": os.path.join(tmp, "train")})
        tcfg.seed = SEED
        tcfg.device = "cuda"
        tcfg.hooks = list(tcfg.hooks) + [dict(type=step_probe(records))]
        torch.cuda.reset_peak_memory_stats(dev)
        for k in bc.KERNELS:
            k.launches = 0
        t0 = time.perf_counter()
        trainer = train_main_worker(tcfg)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        train_launches = [k.launches for k in bc.KERNELS]
        train_peak_gib = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        steps = records["steps"]
        n_val = len(trainer.val_loader)
        val_band = sum(m.last_route.startswith("band") for m in trainer.model.modules()
                       if isinstance(m, SubMConv))  # the last forward was a val one
        print(f"[train] {len(steps)} steps + {n_val} val forwards in {train_s:.2f} s; "
              f"launches (K1, K2, K3) {train_launches}; peak memory "
              f"{train_peak_gib:.3f} GiB")

        # the routing of a training batch (derived, as for serving above)
        batch12 = records["batch"]
        b_inputs = {k: torch.as_tensor(v, device=dev)
                    for k, v in split_batch(batch12)[0].items()}
        b_inputs.update(trainer.static_ctx)
        st12, _ = maybe_sort_by_key(batch_to_sparse_tensor(b_inputs))
        spunet = trainer.model.backbone
        level_rb, level_coords, _ = level_plans(spunet, st12)
        tconvs, fused, per_step = band_routing(spunet, level_rb)
        n_band, n_fused = sum(tconvs.values()), per_step[1]
        live = int((b_inputs["batch"] >= 0).sum())
        print(f"[train] routing at batch {tcfg.batch_size}: {n_band} band convs per "
              f"forward ({sum(isinstance(rb, SubmPlan) for rb in level_rb)} of 5 "
              f"levels with attached plans), {n_fused} fused backward (K2), "
              f"{n_band - n_fused} split (K1 + K3): launches per step {per_step}; "
              f"{live} live rows of {st12.capacity}")
        check(len(steps) == len(trainer.train_loader) == 3, f"{len(steps)} steps")
        for i, m in enumerate(steps):
            print(f"[train] step {i}: loss {m['loss']:.6f} lr {m['lr']:.6e} "
                  f"contract_ok {m['contract_ok']} launches {m['launches']}")
            check(np.isfinite(m["loss"]), f"step {i} loss {m['loss']}")
            check(m["contract_ok"] == 1.0, f"step {i} contract_ok False")
            check(m["lr"] == m["schedule_lr"], f"step {i} lr {m['lr']} != schedule")
            check(m["launches"] == per_step + [0, 0],
                  f"step {i} launches {m['launches']} != routing {per_step}")
        check(val_band == BAND_CONVS_PER_FORWARD,
              f"val forward ran {val_band} band convs")
        check(train_launches == [3 * per_step[0] + n_val * val_band,
                                 3 * per_step[1], 3 * per_step[2]],
              f"training launches {train_launches}")
        ckpt_path = os.path.join(tcfg.save_path, "model", "model_last.pth")
        ckpt = torch.load(ckpt_path, map_location="cpu", weights_only=True)
        fresh = build_model(dict(tcfg.model))
        fresh.load_state_dict(ckpt["state_dict"])
        check(ckpt["step"] == 3 and all(
            torch.equal(v.cpu(), fresh.state_dict()[k])
            for k, v in trainer.model.state_dict().items()),
            "checkpoint does not hold the trained state")
        batch_times = [v for v, _ in trainer.storage.history("batch_time").values()]
        data_times = [v for v, _ in trainer.storage.history("data_time").values()]
        val_miou = trainer.storage.history("val/mIoU").latest()
        print(f"[train] checkpoint {ckpt_path} (step {ckpt['step']}) loads into a fresh "
              f"model; val mIoU {val_miou:.4f} (random-init weights after 3 steps)")
        # IterationTimer's batch_time runs from the end of one step to the end
        # of the next, so it holds the data wait; the step is the difference
        step_times = [b - d for b, d in zip(batch_times, data_times)]
        print(f"[time] train step (host clock, batch to device .. metrics synced): "
              f"{', '.join(f'{1e3 * t:.1f}' for t in step_times)} ms, median of "
              f"the last 2 {1e3 * float(np.median(step_times[1:])):.1f} ms; data "
              f"wait {', '.join(f'{1e3 * t:.1f}' for t in data_times)} ms")
        print(f"[memory] training peak {train_peak_gib:.3f} GiB")
        state = {k: v.detach().clone() for k, v in trainer.model.state_dict().items()}
        static_ctx = dict(trainer.static_ctx)
        del trainer, fresh, ckpt
        gc.collect()
        torch.cuda.empty_cache()
        phase_done("6 training slice")

        # ---- 7. K1, K2, K3 vs plain at the training batch's shapes
        def bound32(err, scale):
            return err <= 1e-4 * max(scale, 1.0)

        compare_band_kernels(tconvs, fused, level_rb, level_coords, gen, torch.float32,
                             stats)

        # the autograd wrapper's backward with window overflow and gating
        legacy4 = level_rb[4].legacy if isinstance(level_rb[4], SubmPlan) else level_rb[4]
        n4 = legacy4.shape[1]
        mask4 = level_coords[4][:, 0] >= 0
        f4 = torch.randn(n4, 256, device=dev, generator=gen) * mask4[:, None]
        w4 = torch.randn(27, 256, 256, device=dev, generator=gen) / (27 * 256) ** 0.5
        cot = torch.randn(n4, 256, device=dev, generator=gen)
        ovf_plan = bc.build_band_plan(legacy4, 3, block=32, window=8,
                                      pair_budget=10 ** 6, entry_budget=27 * n4)
        gated = bc.build_band_plan(legacy4, 3, block=32, window=8, pair_budget=0)
        check(bool(ovf_plan.ok) and not bool(gated.ok), "overflow / gated plans")
        fp, wp = f4.clone().requires_grad_(), w4.clone().requires_grad_()
        apply_sparse_conv(fp, legacy4, wp, mask4).backward(cot)
        route = bc.fused_bwd_fits
        try:
            for use_fused in (True, False):
                bc.fused_bwd_fits = lambda *a, **k: use_fused
                fb, wb = f4.clone().requires_grad_(), w4.clone().requires_grad_()
                bc.band_subm_conv((3, 32, 8), fb, ovf_plan, wb, mask4).backward(cot)
                (ex, sx), (ew, sw) = max_err(fb.grad, fp.grad), max_err(wb.grad, wp.grad)
                check(bound32(ex, sx) and bound32(ew, sw),
                      f"overflow backward ({use_fused}): dx {ex:.3e}/{sx:.3e} "
                      f"dW {ew:.3e}/{sw:.3e}")
                fz, wz = f4.clone().requires_grad_(), w4.clone().requires_grad_()
                zero = bc.band_subm_conv((3, 32, 8), fz, gated, wz, mask4)
                zero.backward(cot)
                check(float(zero.abs().sum()) == 0.0 and float(fz.grad.abs().sum()) == 0.0
                      and float(wz.grad.abs().sum()) == 0.0,
                      "pair_budget=0 must give exact zero output, dx and dW")
                print(f"[bwd] block 32 / window 8 at L4 ({n4} rows, "
                      f"{sum(ovf_plan.ov_counts)} overflow entries), "
                      f"{'K2' if use_fused else 'K1 + K3'}: dx err {ex:.3e} "
                      f"(max {sx:.3e}), dW err {ew:.3e} (max {sw:.3e}) vs autograd "
                      "through the plain conv; pair_budget=0: zero out, dx, dW")
        finally:
            bc.fused_bwd_fits = route
        del f4, w4, cot, fp, wp
        gc.collect()
        torch.cuda.empty_cache()
        phase_done("7 K1/K2/K3 vs plain, training shapes")

        # ---- 8. one step's grads from the saved state: kernels vs plain
        plain_cores = {name: getattr(bc, f"{name}_plain") for name in BAND_CORES}
        reordered_cores = {"band_fwd_core": reordered_fwd,
                           "band_dxdw_core": reordered_dxdw,
                           "band_dw_core": reordered_dw}

        def step_grads(gmodel, inputs, cores=None):
            saved = {name: getattr(bc, name) for name in BAND_CORES}
            if cores:
                for name, fn in cores.items():
                    setattr(bc, name, fn)
            try:
                gmodel.zero_grad(set_to_none=True)
                before = [k.launches for k in bc.KERNELS]
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = gmodel(inputs)
                out["loss"].backward()
                torch.cuda.synchronize()
                secs = time.perf_counter() - t
                launched = [k.launches - b for k, b in zip(bc.KERNELS, before)]
                grads = {n: p.grad.detach().clone() for n, p in gmodel.named_parameters()
                         if p.grad is not None}
                return float(out["loss"].detach()), grads, launched, secs
            finally:
                for name, fn in saved.items():
                    setattr(bc, name, fn)

        def grads_kernel_vs_plain(tag, gmodel, inputs, expect, loss_rel, grad_rel,
                                  loss_spread):
            """Two runs of each path, and one of the plain path summing in
            another order (``reordered_fwd``). The step is reproducible
            (cuDNN deterministic, every sum in a fixed order), so the two
            runs of a path must give equal bits, loss and every gradient.
            The kernels sum in another order than the plain versions, and
            the deepest encoder convs' dW, summed over up to ~1M rows into a
            BN-centred cotangent, cancel; so each gradient is held to
            ``grad_rel`` of its max|ref| plus 3x its difference between the
            plain run and the reordered plain run (a real change of
            summation order); the loss to ``loss_rel`` (plus 3x that
            difference if ``loss_spread``)."""
            kern = [step_grads(gmodel, inputs) for _ in range(2)]
            plain = [step_grads(gmodel, inputs, plain_cores) for _ in range(2)]
            reordered = step_grads(gmodel, inputs, reordered_cores)
            (loss_k, grads_k, launched_k, secs_k), (loss_p, grads_p, launched_p, secs_p) = (
                kern[0], plain[0])
            check(launched_k == expect and launched_p == [0, 0, 0],
                  f"{tag}: launches kernel path {launched_k}, plain path {launched_p}")
            for path, (first, second) in (("kernel", kern), ("plain", plain)):
                unequal = [n for n, g in first[1].items() if not torch.equal(second[1][n], g)]
                check(first[0] == second[0] and not unequal,
                      f"{tag}: two runs of the {path} path differ: loss {first[0]!r} vs "
                      f"{second[0]!r}, {len(unequal)} grads, e.g. {unequal[:3]}")
            spread_l = abs(reordered[0] - loss_p)
            check(abs(loss_k - loss_p) <= loss_rel * abs(loss_p)
                  + (3 * spread_l if loss_spread else 0.0),
                  f"{tag}: loss kernel {loss_k} vs plain {loss_p} (reordered {reordered[0]})")
            check(sorted(grads_k) == sorted(grads_p), f"{tag}: grads of other params")
            rows, margins = [], []
            for name, ref in grads_p.items():
                scale = ref.abs().max().item()
                err = (grads_k[name] - ref).abs().max().item()
                spread = (reordered[1][name] - ref).abs().max().item()
                rows.append((err / max(scale, 1e-30), spread / max(scale, 1e-30), name))
                margins.append((err / max(grad_rel * scale + 3 * spread, 1e-30), name, err,
                                scale, spread))
            margins.sort()
            print(f"[grad] {tag}: the 3 grads closest to their bound (err / (grad_rel "
                  "x max|ref| + 3 x reordered)): " + "; ".join(
                      f"{name} {m:.3f} (err {e:.3e}, max|ref| {sc:.3e}, reordered {sp:.3e})"
                      for m, name, e, sc, sp in margins[-3:]), flush=True)
            for m, name, err, scale, spread in margins:
                check(m <= 1.0, f"{tag}: grad {name}: err {err:.3e} > {grad_rel} x "
                      f"{scale:.3e} + 3 x reordered {spread:.3e}")
            rows.sort()
            strict = sum(r[0] <= 1e-3 for r in rows)
            print(f"[grad] {tag}: two runs of each path equal bit for bit; loss kernel "
                  f"{loss_k:.7f} plain {loss_p:.7f} (reordered plain {reordered[0]:.7f}); "
                  f"{strict} of {len(rows)} grads within 1e-3 of their max|ref|; worst "
                  f"{rows[-1][2]} at {rows[-1][0]:.3e} (reordered plain {rows[-1][1]:.3e}); "
                  f"largest reordered-plain difference {max(r[1] for r in rows):.3e}; "
                  f"forward+backward {1e3 * secs_k:.1f} / {1e3 * kern[1][3]:.1f} ms with the "
                  f"kernels, {1e3 * secs_p:.1f} / {1e3 * plain[1][3]:.1f} ms plain")
            for ratio, spread, name in rows[-5:]:
                print(f"[grad]   {name}: kernel vs plain {ratio:.3e}, reordered plain "
                      f"{spread:.3e} (of max|ref|)")

        gmodel = build_model(dict(tcfg.model)).to(dev)
        gmodel.load_state_dict(state)
        gmodel.train()
        grads_kernel_vs_plain("fine-tune step from the trained state", gmodel, b_inputs,
                              per_step, 1e-5, 1e-3, False)
        del gmodel, state, b_inputs, level_rb, level_coords, st12
        gc.collect()
        torch.cuda.empty_cache()
        phase_done("8 grads kernel vs plain")

        # ---- 9. the pretrain step: 3 steps of bench.py's workload
        precords = {"steps": []}
        pcfg = default_config_parser(PRETRAIN_CONFIG,
                                     {"save_path": os.path.join(tmp, "pretrain")})
        pcfg.seed = SEED
        pcfg.device = "cuda"
        pcfg.hooks = list(pcfg.hooks) + [dict(type=step_probe(precords))]
        torch.cuda.reset_peak_memory_stats(dev)
        for k in bc.KERNELS + wg.KERNELS:
            k.launches = 0
        t0 = time.perf_counter()
        trainer = train_main_worker(pcfg)
        torch.cuda.synchronize()
        pretrain_s = time.perf_counter() - t0
        pretrain_launches = [k.launches for k in bc.KERNELS + wg.KERNELS]
        pretrain_peak_gib = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        psteps = precords["steps"]
        p_inputs = {k: torch.as_tensor(v, device=dev)
                    for k, v in split_batch(precords["batch"])[0].items()}
        p_inputs.update(trainer.static_ctx)
        st2, _ = maybe_sort_by_key(batch_to_sparse_tensor(p_inputs))
        spunet = trainer.model.backbone
        level_rb, level_coords, stem = level_plans(spunet, st2)
        pconvs, pfused, p_step = band_routing(spunet, level_rb)
        n_attached = sum(isinstance(rb, SubmPlan) and rb.band is not None
                         for rb in level_rb)
        live = int((p_inputs["batch"] >= 0).sum())
        print(f"[pretrain] {len(psteps)} steps in {pretrain_s:.2f} s; launches (K1..K5) "
              f"{pretrain_launches}; peak memory {pretrain_peak_gib:.3f} GiB")
        print(f"[pretrain] routing at batch {pcfg.batch_size}: {sum(pconvs.values())} band "
              f"convs per forward ({n_attached} of 5 levels with attached band plans), "
              f"{p_step[1]} fused backward (K2), {p_step[2]} split (K1 + K3): launches "
              f"per step {p_step}; {live} live rows of {st2.capacity}; stem route "
              f"{'slab' if isinstance(stem, SubmPlan) else 'plain'}")
        check(len(psteps) == len(trainer.train_loader) == 3, f"{len(psteps)} pretrain steps")
        check(n_attached == 5, f"{n_attached} of 5 levels with attached band plans")
        for i, m in enumerate(psteps):
            print(f"[pretrain] step {i}: loss {m['loss']:.6f} lr {m['lr']:.6e} contract_ok "
                  f"{m['contract_ok']} launches {m['launches']} "
                  + " ".join(f"{k} {m[k]:.4f}" for k in pcfg.metric_keys if k in m))
            check(np.isfinite(m["loss"]), f"pretrain step {i} loss {m['loss']}")
            check(m["contract_ok"] == 1.0, f"pretrain step {i} contract_ok False")
            check(m["lr"] == m["schedule_lr"], f"pretrain step {i} lr != schedule")
            check(m["launches"] == p_step + [0, 0],
                  f"pretrain step {i} launches {m['launches']} != routing {p_step}")
        check(pretrain_launches == [3 * c for c in p_step] + [0, 0],
              f"pretrain launches {pretrain_launches}")
        ckpt = torch.load(os.path.join(pcfg.save_path, "model", "model_last.pth"),
                          map_location="cpu", weights_only=True)
        check(ckpt["step"] == 3, "pretrain checkpoint step")
        batch_times = [v for v, _ in trainer.storage.history("batch_time").values()]
        data_times = [v for v, _ in trainer.storage.history("data_time").values()]
        pstep_times = [b - d for b, d in zip(batch_times, data_times)]
        print(f"[time] pretrain step (host clock, batch to device .. metrics synced): "
              f"{', '.join(f'{1e3 * t:.1f}' for t in pstep_times)} ms, median of the "
              f"last 2 {1e3 * float(np.median(pstep_times[1:])):.1f} ms; data wait "
              f"{', '.join(f'{1e3 * t:.1f}' for t in data_times)} ms")
        print(f"[memory] pretrain peak {pretrain_peak_gib:.3f} GiB")
        del trainer, ckpt
        gc.collect()
        torch.cuda.empty_cache()
        phase_done("9 pretrain steps")

        # ---- 10. K1, K2, K3 vs plain at the pretrain batch's shapes, timed in bf16
        compare_band_kernels(pconvs, pfused, level_rb, level_coords, gen, torch.bfloat16,
                             pstats)
        phase_done("10 K1/K2/K3 vs plain, pretrain shapes")

        # ---- 11. one pretrain step's grads: kernels vs plain, same draws,
        # from the seeded initial state (the trained state of phase 9 has
        # taken a step at the peak lr and is further from smooth)
        gmodel = build_model(dict(pcfg.model))
        gmodel.reset_parameters(torch.Generator().manual_seed(SEED))
        gmodel.to(dev).train()
        B, V, H, W = p_inputs["depth"].shape
        draws = gmodel.draw_noise(torch.Generator(device=dev).manual_seed(SEED), B, V, H * W)
        grads_kernel_vs_plain("pretrain step from the seeded state (bf16)", gmodel,
                              {**p_inputs, "draws": draws}, p_step, 3e-2, 3e-2, True)

        del gmodel, draws
        gc.collect()
        torch.cuda.empty_cache()
        phase_done("11 pretrain grads kernel vs plain")

        # ---- 12. the windowed conv entry point (K4, K5): the probe's shapes
        # and two rulebooks of the pretrain batch
        check([k.launches for k in wg.KERNELS] == [0, 0],
              "K4/K5 launched outside the windowed conv entry point")
        cases = windowed_cases(probe, dev, level_rb, stem)
        inputs_w = [probe.case_inputs(rb, cin, cout, SEED + i, dev)
                    for i, (_, _, rb, cin, cout) in enumerate(cases)]
        parent = parent_times(opts.parent_log) if opts.parent_log else {}
        f32_ms = [0.0, 0.0]  # K4, K5 over the six convs
        bf16 = torch.bfloat16
        for k in wg.KERNELS:
            k.launches = 0
        path = [probe.windowed_conv(rb, *inputs_w[i], probe.BLOCK, probe.WB, group, bf16)
                for i, (_, group, rb, _, _) in enumerate(cases)]
        torch.cuda.synchronize()
        windowed_launches = [k.launches for k in wg.KERNELS]
        check(windowed_launches == [len(cases)] * 2,
              f"windowed conv launches {windowed_launches} for {len(cases)} convs")
        for i, (label, group, rb, cin, cout) in enumerate(cases):
            geom, out, dw = path[i]
            feats, w, g = inputs_w[i]
            _, out_p, dw_p = probe.windowed_conv(rb, feats, w, g, probe.BLOCK, probe.WB,
                                                 group, bf16, plain=True)
            _, out32, dw32 = probe.windowed_conv(rb, feats, w, g, probe.BLOCK, probe.WB,
                                                 group, torch.float32)
            _, out32p, dw32p = probe.windowed_conv(rb, feats, w, g, probe.BLOCK, probe.WB,
                                                   group, torch.float32, plain=True)
            # a second launch of each kernel, in each dtype: equal bits
            for dtype, first in ((bf16, (out, dw)), (torch.float32, (out32, dw32))):
                again = probe.windowed_conv(rb, feats, w, g, probe.BLOCK, probe.WB, group,
                                            dtype)[1:]
                check(all(torch.equal(a, b) for a, b in zip(again, first)),
                      f"{label}: a second K4/K5 launch in {dtype} differs")
            torch.cuda.synchronize()
            # the plain versions sum the same products (bf16 values, f32
            # accumulation) in another order: 1e-4 of max(|ref|, 1) in both
            errs = {}
            for kname, o, r in (("windowed_conv_fwd", out, out_p),
                                ("windowed_conv_dw", dw, dw_p),
                                ("windowed_conv_fwd", out32, out32p),
                                ("windowed_conv_dw", dw32, dw32p)):
                e, sc = max_err(o, r)
                check(e <= 1e-4 * max(sc, 1.0), f"{kname} {label}: err {e:.3e} at {sc:.3e}")
                errs.setdefault(kname, []).append(e)
            n = rb.shape[1]
            # the kernels in f32, timed on their own
            f = wg.pad_features(feats, wg.padded_rows(n, probe.WB), torch.float32)
            gc_ = torch.zeros((geom.rbb.shape[1] * probe.BLOCK, cout), device=dev)
            gc_[:n] = g
            ms32 = (cuda_ms(lambda: wg.windowed_conv_fwd(f, geom, w, probe.WB, group), 5),
                    cuda_ms(lambda: wg.windowed_conv_dw(f, geom, gc_, probe.WB, group), 5))
            f32_ms = [a + b for a, b in zip(f32_ms, ms32)]
            f = wg.pad_features(feats, wg.padded_rows(n, probe.WB), bf16)
            wc = w.to(bf16).contiguous()
            gc_ = torch.zeros((geom.rbb.shape[1] * probe.BLOCK, cout), dtype=bf16,
                              device=dev)
            gc_[:n] = g.to(bf16)
            calls = {
                "windowed_conv_fwd": (
                    lambda: wg.windowed_conv_fwd(f, geom, wc, probe.WB, group),
                    lambda: wg.windowed_conv_fwd_plain(f, geom, wc, probe.WB, group),
                    probe.bound_ms(geom, probe.WB, cin, cout, n, bf16, weights=True)),
                "windowed_conv_dw": (
                    lambda: wg.windowed_conv_dw(f, geom, gc_, probe.WB, group),
                    lambda: wg.windowed_conv_dw_plain(f, geom, gc_, probe.WB, group),
                    probe.bound_ms(geom, probe.WB, cin, cout, n, bf16, weights=False)),
            }
            line, calls_ms = [], {}
            for kname, (kern, plain, (b, term)) in calls.items():
                t_k, t_p = cuda_ms(kern, 5), cuda_ms(plain, 3)
                calls_ms[kname] = t_k
                st = pstats[kname]
                st["err_bf16"] = max(st["err_bf16"], errs[kname][0])
                st["err"] = max(st["err"], errs[kname][1])
                st["ms"] += t_k
                st["plain_ms"] += t_p
                st["bound_ms"] += b
                st["bytes_ms" if term == "bytes" else "ops_ms"] += b
                line.append(f"{'K4' if kname.endswith('fwd') else 'K5'} {t_k:.3f} ms vs "
                            f"plain {t_p:.3f} ms (bound {b:.4f} ms, {term}), err bf16 "
                            f"{errs[kname][0]:.2e} f32 {errs[kname][1]:.2e}")
            live = probe.live_entries(geom, probe.WB)
            print(f"[windowed] {label} ({n} rows, group {group}): covered "
                  f"{bool(geom.covered)} (share {probe.covered_share(geom, probe.WB):.4f}, "
                  f"{live} in-window entries); " + "; ".join(line))
            k3, nrows = rb.shape[0], geom.rbb.shape[1] * probe.BLOCK
            fplan = wg.windowed_fwd_plan(nrows, cin, cout, k3, bf16)
            dplan = wg.windowed_dw_plan(nrows, cin, cout, k3, bf16)
            k4_rows = probe.k4_rows_multiplied(geom, probe.WB)
            k5_rows = probe.k5_rows_multiplied(geom, probe.WB, dplan, bf16)
            print(f"[windowed] {label}: K4 tile slabs {bc.DX_ROWS} x {fplan.co_tile} "
                  f"({fplan.ctas} CTAs), K5 tile {dplan.co_tile} x {dplan.ci_tile} of dW^T "
                  f"({dplan.ctas} CTAs, {dplan.nchunks} chunks of {dplan.chunk} rows; a "
                  f"second launch: equal bits); rows multiplied per channel tile against "
                  f"{live} live entries: K4 {k4_rows} ({k4_rows / max(live, 1):.2f}x), K5 "
                  f"{k5_rows} ({k5_rows / max(live, 1):.2f}x); f32 K4 {ms32[0]:.3f} ms, K5 "
                  f"{ms32[1]:.3f} ms")
            if label in parent:
                (p4, p5), t4, t5 = parent[label], calls_ms["windowed_conv_fwd"], calls_ms[
                    "windowed_conv_dw"]
                print(f"[windowed] {label}: parent -> this tree, K4 {p4:.3f} -> {t4:.3f} ms, "
                      f"K5 {p5:.3f} -> {t5:.3f} ms")
            del f, wc, gc_
        print(f"[windowed] {len(cases)} convs (bf16): K4 {pstats['windowed_conv_fwd']['ms']:.3f} "
              f"ms, K5 {pstats['windowed_conv_dw']['ms']:.3f} ms"
              + (f" (parent {sum(v[0] for v in parent.values()):.3f} / "
                 f"{sum(v[1] for v in parent.values()):.3f} ms over {len(parent)} convs)"
                 if parent else "") + f"; f32: K4 {f32_ms[0]:.3f} ms, K5 {f32_ms[1]:.3f} ms")
        del path, inputs_w, cases, level_rb, level_coords, stem
        phase_done("12 windowed conv K4/K5")

        # ---- 13. the probe kernels: each probe function through its entry
        # point, at its probe's shape and on its inputs
        probe_rows = []
        parent = parent_probe_times(opts.parent_log) if opts.parent_log else {}
        for v in (probe_gather_torch.variants(dev) + probe_bisect_torch.variants(dev)
                  + probe.profile_variants(dev)):
            for k in all_kernels:
                k.launches = 0
            out = v.run(False)
            torch.cuda.synchronize()
            launched = {k.symbol: k.launches for k in all_kernels if k.launches}
            check(launched == {v.kernel.symbol: 1}, f"{v.name}: launches {launched}")
            m = probe.measure(v, out, 20)
            print("[probe] " + probe.report(v, m), flush=True)
            if v.name in parent:
                print(f"[probe] {v.name}: parent -> this tree {parent[v.name]:.4f} -> "
                      f"{m['ms']:.4f} ms (device, L2 cold)")
            check(m["agree"], f"{v.name}: kernel vs plain max_abs_err {m['max_abs_err']}")
            probe_rows.append((v, m, launched[v.kernel.symbol]))
            del out
        phase_done("13 probe kernels")

        # ---- 14. output
        print(f"[time] per fine-tune step at batch {tcfg.batch_size} (f32): "
              + "; ".join(f"{name} {stats[name]['ms']:.3f} ms vs plain "
                          f"{stats[name]['plain_ms']:.3f} ms (bound "
                          f"{stats[name]['bound_ms']:.3f} ms)" for name in BAND_CORES))
        print(f"[time] per pretrain step at batch {pcfg.batch_size} (bf16): "
              + "; ".join(f"{name} {pstats[name]['ms']:.3f} ms vs plain "
                          f"{pstats[name]['plain_ms']:.3f} ms (bound "
                          f"{pstats[name]['bound_ms']:.3f} ms)" for name in BAND_CORES))
        print(f"[time] phases: " + ", ".join(f"{k} {v:.1f} s" for k, v in phase_s.items()))

        def entry(name, launches, st):
            return {
                "launches": launches,
                "max_abs_err": st["err"],
                "ms": st["ms"],
                "plain_ms": st["plain_ms"],
                "bound_ms": st["bound_ms"],
                "bound_by": "bytes" if st["bytes_ms"] >= st["ops_ms"] else "operations",
                "library_ms": None,
                "timing": EAGER_TIMING,
            }

        # the main path of K1-K3 is the pretrain step (bf16; launches over its
        # 3 steps, times per step); the fine-tune step's numbers (f32) and the
        # serving launches ride along. K4/K5: one run of the windowed conv
        # entry point over its convs
        main_launches = dict(zip(KERNEL_SOURCES, pretrain_launches[:3] + windowed_launches))
        kernels = []
        for name in KERNEL_SOURCES:
            row = {"name": name, "route": "cuda", "source": KERNEL_SOURCES[name][0],
                   "replaces": KERNEL_SOURCES[name][1]}
            row.update(entry(name, main_launches[name], pstats[name]))
            row["max_abs_err_bf16"] = pstats[name]["err_bf16"]
            if name in BAND_CORES:
                i = BAND_CORES.index(name)
                row["fine_tune"] = entry(name, train_launches[i], stats[name])
                row["fine_tune"]["f32_peak"] = F32_PEAK
                row["serving_launches"] = serve_launches[i]
            kernels.append(row)
        # the probe kernels: one row per ported probe function, its launches
        # from its own run through the entry point
        for v, m, launches in probe_rows:
            kernels.append({
                "name": v.name, "route": "cuda",
                "source": f"ponderv2_tpu_torch/csrc/{v.kernel.source}.cu",
                "replaces": v.replaces, "launches": launches,
                **{key: m[key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                           "bound_by", "library_ms", "warm_ms",
                                           "eager_ms")},
                "timing": probe.TIMING})
        print(json.dumps({"kernels": kernels}))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
