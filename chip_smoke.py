#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port: build K1, check it, serve ScanNet-scale scenes.

    python3 chip_smoke.py

Needs one CUDA GPU (Hopper: the kernel is built for sm_90a) and runs in
phases; any failure exits non-zero:

1. print the card's name and power limit; refuse to run without CUDA;
2. build the band conv kernel K1 (``ponderv2_tpu_torch/csrc/band_conv.cu``)
   with nvcc;
3. compare K1 with its plain PyTorch version on the card at every distinct
   (level, Cin, Cout) band conv of the slice, at the level row counts of a
   real fragment, in f32 (TF32 off) and bf16, plus a window-overflow case
   and a zero-gated (``pair_budget=0``) case, and time both;
4. serve ``configs/_test_/semseg_spunet_scannet_synthetic.py`` through
   ``tools/test_torch.py:main_worker`` with seeded random weights: 2 scenes x
   4 rotations x (6 or 9) fragments = 60 forwards of 78-85k voxels at full
   width; check K1's launch count, every ``contract_ok`` and the logits;
5. run one fragment again with K1 replaced by its plain version and compare
   the logits;
6. print times and peak memory, a JSON line of the kernels, and last
   ``{"ok": true, "device": {...}}``.
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "configs/_test_/semseg_spunet_scannet_synthetic.py")
SEED = 0
# band convs per forward of SpUNet-v1m1 at ScanNet's sparse_shape, from the
# routing (models/sparse_unet/layers.py:subm_route): L0 runs the last decoder
# stage's 2 blocks (4 convs, inline band plans since cin > 64); L1-L4 carry
# attached band plans and run enc/dec blocks 2+2, 3+2, 4+2 and 6 -> 8, 10,
# 12, 12 convs. The stem (k5), strided/inverse convs and head are not band.
BAND_CONVS_PER_FORWARD = 46


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke needs "
              "a CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import numpy as np

    from ponderv2_tpu_torch.datasets import build_dataset, collate_fn
    from ponderv2_tpu_torch.engines.common import split_batch
    from ponderv2_tpu_torch.models import build_model
    from ponderv2_tpu_torch.models.sparse_unet.layers import SubMConv, subm_route
    from ponderv2_tpu_torch.models.sparse_unet.plans import (
        build_spunet_plans_auto, capacity_schedule)
    from ponderv2_tpu_torch.ops import band_conv as bc
    from ponderv2_tpu_torch.ops.cuda_build import BUILD_LOGS
    from ponderv2_tpu_torch.ops.sparse import make_sparse_tensor
    from ponderv2_tpu_torch.ops.spconv import SubmPlan, apply_sparse_conv
    from ponderv2_tpu_torch.utils.config import Config
    from test_torch import main_worker

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

    # ---- 2. build K1
    t0 = time.perf_counter()
    bc.BAND_FWD.lib()
    print(f"[build] K1 built in {time.perf_counter() - t0:.2f} s")
    ptxas = [ln for ln in BUILD_LOGS.get("band_conv", "").splitlines()
             if "registers" in ln or "spill" in ln]
    for ln in ptxas:
        print(f"[build] {ln.strip()}")

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

        # ---- 3. K1 against its plain version at the slice's shapes
        coords = torch.cat([inputs["batch"][:, None].int(),
                            inputs["grid_coord"].int()], 1)
        st = make_sparse_tensor(inputs["feat"], coords, cfg.sparse_shape, 1)
        plans = build_spunet_plans_auto(
            st.coords, st.spatial_shape, 1,
            capacity_schedule(st.capacity, spunet.num_stages), spunet.channels)
        level_rb = [plans.l0] + list(plans.subm)
        level_coords = [st.coords] + [s[0] for s in plans.strided]
        # every band conv of one forward: (level, cin, cout), with its count
        convs = {}
        for level, blocks in ([(s + 1, spunet.enc[s]) for s in range(4)]
                              + [(r, spunet.dec[r]) for r in range(4)]):
            for block in blocks.values():
                for conv in (block.conv1, block.conv2):
                    key = (level, conv.in_channels, conv.out_channels)
                    route = subm_route(level_rb[level], *key[1:], 3)
                    if route.startswith("band"):
                        convs[key] = convs.get(key, 0) + 1
        check(sum(convs.values()) == BAND_CONVS_PER_FORWARD,
              f"routing gives {sum(convs.values())} band convs per forward")

        gen = torch.Generator(device=dev).manual_seed(SEED)
        max_err, k1_ms, plain_ms = 0.0, 0.0, 0.0
        for (level, cin, cout), count in sorted(convs.items()):
            rb = level_rb[level]
            legacy = rb.legacy if isinstance(rb, SubmPlan) else rb
            plan = rb.band if isinstance(rb, SubmPlan) else bc.build_band_plan(legacy, 3)
            n = legacy.shape[1]
            valid = (level_coords[level][:, 0] >= 0)[:, None]
            f = torch.randn(n, cin, device=dev, generator=gen) * valid
            w = torch.randn(27, cin, cout, device=dev, generator=gen) / (27 * cin) ** 0.5
            args = (plan.rbt, plan.w0)
            tail = (3, bc.BLOCK, bc.WINDOW)
            out = bc.band_fwd_core(f, *args, w, *tail)
            ref = bc.band_fwd_core_plain(f, *args, w, *tail)
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            scale = ref.abs().max().item()
            # f32 both ways; only the order of the 27 x Cin-term sums differs
            check(err <= 1e-4 * max(scale, 1.0),
                  f"K1 f32 L{level} {cin}->{cout}: err {err:.3e} scale {scale:.3e}")
            fb, wb = f.bfloat16(), w.bfloat16()
            errb = (bc.band_fwd_core(fb, *args, wb, *tail)
                    - bc.band_fwd_core_plain(fb, *args, wb, *tail)).abs().max().item()
            # bf16 inputs, f32 accumulation; the plain version rounds each
            # tap's product to bf16 (the bench's 3e-2 bound, bench.py:227)
            check(errb <= 3e-2 * scale, f"K1 bf16 L{level} {cin}->{cout}: err {errb:.3e}")
            t_k = cuda_ms(lambda: bc.band_fwd_core(f, *args, w, *tail), 10)
            t_p = cuda_ms(lambda: bc.band_fwd_core_plain(f, *args, w, *tail), 10)
            max_err = max(max_err, err)
            k1_ms += count * t_k
            plain_ms += count * t_p
            print(f"[K1] L{level} rows {n} {cin}->{cout} x{count}: max_abs_err f32 "
                  f"{err:.3e} (max|ref| {scale:.3e}) bf16 {errb:.3e}; "
                  f"K1 {t_k:.4f} ms plain {t_p:.4f} ms; band ok {bool(plan.ok)} "
                  f"overflow entries {sum(plan.ov_counts)}")

        # window overflow (block 32 / window 8) and budget gating, through
        # the whole band_subm_conv wrapper against the plain gather conv
        rb4 = plans.subm[3]
        n4 = rb4.legacy.shape[1]
        mask4 = level_coords[4][:, 0] >= 0
        f4 = torch.randn(n4, 256, device=dev, generator=gen) * mask4[:, None]
        w4 = torch.randn(27, 256, 256, device=dev, generator=gen) / (27 * 256) ** 0.5
        ovf_plan = bc.build_band_plan(rb4.legacy, 3, block=32, window=8,
                                      pair_budget=10 ** 6, entry_budget=27 * n4)
        check(bool(ovf_plan.ok) and sum(ovf_plan.ov_counts) > 0,
              "block 32 / window 8 plan should be ok with overflow entries")
        out = bc.band_subm_conv((3, 32, 8), f4, ovf_plan, w4, mask4)
        ref = apply_sparse_conv(f4, rb4.legacy, w4, mask4)
        err = (out - ref).abs().max().item()
        check(err <= 1e-4 * max(ref.abs().max().item(), 1.0),
              f"overflow case err {err:.3e}")
        max_err = max(max_err, err)
        print(f"[K1] block 32 / window 8 at L4: {sum(ovf_plan.ov_counts)} overflow "
              f"entries, max_abs_err vs plain conv {err:.3e}")
        gated = bc.build_band_plan(rb4.legacy, 3, block=32, window=8, pair_budget=0)
        check(not bool(gated.ok), "pair_budget=0 plan should not be ok")
        zero = bc.band_subm_conv((3, 32, 8), f4, gated, w4, mask4)
        check(float(zero.abs().sum()) == 0.0, "pair_budget=0 must give exact zeros")
        print("[K1] pair_budget=0: ok False, output exactly zero")

        # ---- 4. the slice: serve all fragments through main_worker
        weights = os.path.join(tmp, "spunet_seeded.pth")
        torch.save(seeded_state_dict(model, inputs, dev), weights)
        cfg.weight = weights
        torch.cuda.reset_peak_memory_stats(dev)
        bc.BAND_FWD.launches = 0
        t0 = time.perf_counter()
        tester = main_worker(cfg)
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        launches = bc.BAND_FWD.launches
        peak_gib = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        forwards = len(tester.fragment_seconds)
        routes = [m.last_route for m in tester.model.modules()
                  if isinstance(m, SubMConv)]
        per_fwd = sum(r.startswith("band") for r in routes)
        print(f"[slice] {forwards} forwards in {serve_s:.2f} s; K1 launches "
              f"{launches}; band convs in the last forward {per_fwd}; peak "
              f"memory {peak_gib:.3f} GiB")
        check(forwards == n_fragments,
              f"expected {n_fragments} forwards, ran {forwards}")
        check(per_fwd == BAND_CONVS_PER_FORWARD, f"last forward ran {per_fwd} band convs")
        check(launches == BAND_CONVS_PER_FORWARD * forwards,
              f"K1 launches {launches} != {BAND_CONVS_PER_FORWARD} x {forwards}")
        check(all(tester.contract_ok), "a forward reported contract_ok False")

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
        print(f"[time] K1 per forward (46 band convs): {k1_ms:.3f} ms vs plain "
              f"{plain_ms:.3f} ms")

        print(json.dumps({"kernels": [{
            "name": "band_fwd_core",
            "route": "cuda",
            "source": "ponderv2_tpu_torch/csrc/band_conv.cu",
            "replaces": "ponderv2_tpu/ops/band_conv.py:192",
            "launches": launches,
            "max_abs_err": max_err,
            "ms": k1_ms,
            "plain_ms": plain_ms,
        }]}))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
