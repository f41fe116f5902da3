#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port: build the band kernels, check them,
serve ScanNet-scale scenes and train SpUNet-v1m1 at ScanNet's batch.

    python3 chip_smoke.py

Needs one CUDA GPU (Hopper: the kernels are built for sm_90a) and runs in
phases; any failure exits non-zero:

1. print the card's name and power limit; refuse to run without CUDA;
2. build the band conv kernels with nvcc, one process per source in
   parallel: K1 (``ponderv2_tpu_torch/csrc/band_conv.cu``), K2 and K3
   (``csrc/band_conv_bwd.cu``); print ptxas registers and spills;
3. compare K1 with its plain PyTorch version on the card at every distinct
   (level, Cin, Cout) band conv of the serving slice, at the level row
   counts of a real fragment, in f32 (TF32 off) and bf16, plus a
   window-overflow case and a zero-gated (``pair_budget=0``) case, and time
   both;
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
   time each where the step runs it, and run the backward through the
   autograd wrapper with window overflow and with ``pair_budget=0``;
8. run one step's forward and backward from the saved state twice with the
   kernels, then twice with all three replaced by their plain versions, and
   compare the loss and every parameter's gradient (within 1e-3 of its
   max|ref| plus 3x the measured run-to-run spread);
9. print times and peak memory, a JSON line of the kernels, and last
   ``{"ok": true, "device": {...}}``.
"""

import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "configs/_test_/semseg_spunet_scannet_synthetic.py")
TRAIN_CONFIG = os.path.join(ROOT, "configs/_test_/semseg_spunet_scannet_synthetic_train.py")
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
}


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
    k3 plan (SubmPlan or plain rulebook) and the level's coords."""
    from ponderv2_tpu_torch.models.sparse_unet.plans import (
        build_spunet_plans_auto, capacity_schedule)

    plans = build_spunet_plans_auto(
        st.coords, st.spatial_shape, st.batch_size,
        capacity_schedule(st.capacity, spunet.num_stages), spunet.channels)
    return ([plans.l0] + list(plans.subm),
            [st.coords] + [s[0] for s in plans.strided])


def band_plan_of(rb):
    """The band plan a conv on this level runs (attached, or inline with
    the budget retry, as SubMConv builds it)."""
    from ponderv2_tpu_torch.ops import band_conv as bc
    from ponderv2_tpu_torch.ops.spconv import SubmPlan

    if isinstance(rb, SubmPlan):
        return rb.legacy, rb.band
    return rb, bc.build_band_plan_auto(rb, 3)


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
    from ponderv2_tpu_torch.engines.defaults import default_config_parser
    from ponderv2_tpu_torch.engines.hooks import HookBase
    from ponderv2_tpu_torch.models import build_model
    from ponderv2_tpu_torch.models.default import batch_to_sparse_tensor
    from ponderv2_tpu_torch.models.sparse_unet.layers import SubMConv
    from ponderv2_tpu_torch.ops import band_conv as bc
    from ponderv2_tpu_torch.ops.cuda_build import BUILD_LOGS
    from ponderv2_tpu_torch.ops.sparse import make_sparse_tensor, maybe_sort_by_key
    from ponderv2_tpu_torch.ops.spconv import SubmPlan, apply_sparse_conv
    from ponderv2_tpu_torch.utils.config import Config
    from test_torch import main_worker
    from train_torch import main_worker as train_main_worker

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

    # ---- 2. build K1, K2, K3
    bc.build_kernels()
    for name in ("band_conv", "band_conv_bwd"):
        for ln in BUILD_LOGS.get(name, "").splitlines():
            if "registers" in ln or "spill" in ln or "Compiling entry" in ln:
                print(f"[build] {name}: {ln.strip()}")
    phase_done("2 build")

    # per kernel: max f32 error vs plain, and ms per training step (kernel, plain)
    stats = {name: dict(err=0.0, ms=0.0, plain_ms=0.0) for name in KERNEL_SOURCES}

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
        level_rb, level_coords = level_plans(spunet, st)
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
            # bf16 inputs, f32 accumulation; the plain version rounds each
            # tap's product to bf16 (the bench's 3e-2 bound, bench.py:227)
            check(errb <= 3e-2 * scale, f"K1 bf16 L{level} {cin}->{cout}: err {errb:.3e}")
            t_k = cuda_ms(lambda: bc.band_fwd_core(f, *args, w, *tail), 10)
            t_p = cuda_ms(lambda: bc.band_fwd_core_plain(f, *args, w, *tail), 10)
            k1_serve_err = max(k1_serve_err, err)
            k1_ms += count * t_k
            plain_ms += count * t_p
            print(f"[K1] L{level} rows {n} {cin}->{cout} x{count}: max_abs_err f32 "
                  f"{err:.3e} (max|ref| {scale:.3e}) bf16 {errb:.3e}; "
                  f"K1 {t_k:.4f} ms plain {t_p:.4f} ms; band ok {bool(plan.ok)} "
                  f"overflow entries {sum(plan.ov_counts)}")

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
        records = {"steps": []}

        class StepProbe(HookBase):
            """Per step: the synced metrics, the step's kernel launches and
            the lr the schedule gives; keeps the first batch."""

            def before_step(self):
                self.before = [k.launches for k in bc.KERNELS]

            def after_step(self):
                trainer = self.trainer
                metrics = trainer.sync_metrics()
                metrics["launches"] = [k.launches - b for k, b
                                       in zip(bc.KERNELS, self.before)]
                metrics["schedule_lr"] = trainer.schedule(trainer.step - 1)
                records["steps"].append(metrics)
                records.setdefault("batch", trainer.comm_info["input_dict"])

        tcfg = default_config_parser(TRAIN_CONFIG, {"save_path": os.path.join(tmp, "train")})
        tcfg.seed = SEED
        tcfg.device = "cuda"
        tcfg.hooks = list(tcfg.hooks) + [dict(type=StepProbe)]
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
        level_rb, level_coords = level_plans(spunet, st12)
        tconvs = band_convs(spunet, level_rb)
        def pad128(c):
            return -(-c // 128) * 128

        fused = {key: bc.fused_bwd_fits(pad128(key[1]), pad128(key[2]))
                 for key in tconvs}
        n_band = sum(tconvs.values())
        n_fused = sum(c for key, c in tconvs.items() if fused[key])
        per_step = [n_band + (n_band - n_fused), n_fused, n_band - n_fused]
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
            check(m["launches"] == per_step,
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

        for (level, cin, cout), count in sorted(tconvs.items()):
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
            owner = {"fwd": "band_fwd_core", "dx": "band_fwd_core",
                     "dxdw": "band_dxdw_core", "dw": "band_dw_core"}
            line = []
            for op, (kern, plain) in calls.items():
                outs = kern(f, g, w, wmt)
                refs = plain(f, g, w, wmt)
                torch.cuda.synchronize()
                pairs = list(zip(outs, refs)) if op == "dxdw" else [(outs, refs)]
                errs = [max_err(o, r) for o, r in pairs]
                check(all(bound32(e, s) for e, s in errs),
                      f"{op} f32 L{level} {cin}->{cout}: {errs}")
                low = (f.bfloat16(), g.bfloat16(), w.bfloat16(), wmt.bfloat16())
                outs_b, refs_b = kern(*low), plain(*low)
                pairs_b = (list(zip(outs_b, refs_b)) if op == "dxdw"
                           else [(outs_b, refs_b)])
                errs_b = [max_err(o, r) for o, r in pairs_b]
                check(all(e <= 3e-2 * s for e, s in errs_b),
                      f"{op} bf16 L{level} {cin}->{cout}: {errs_b}")
                err = max(e for e, _ in errs)
                st_k = stats[owner[op]]
                st_k["err"] = max(st_k["err"], err)
                # time where the step runs it: the forward on every band conv,
                # K2 on the fused ones, K1 (dx) + K3 on the split ones
                runs = {"fwd": True, "dx": not fused[(level, cin, cout)],
                        "dxdw": fused[(level, cin, cout)],
                        "dw": not fused[(level, cin, cout)]}[op]
                timing = ""
                if runs:
                    t_k = cuda_ms(lambda: kern(f, g, w, wmt), 5)
                    t_p = cuda_ms(lambda: plain(f, g, w, wmt), 3)
                    st_k["ms"] += count * t_k
                    st_k["plain_ms"] += count * t_p
                    timing = f" {t_k:.3f}/{t_p:.3f} ms"
                line.append(f"{op} err {err:.2e} bf16 {max(e for e, _ in errs_b):.2e}{timing}")
            print(f"[bwd] L{level} rows {n} {cin}->{cout} x{count} "
                  f"{'fused' if fused[(level, cin, cout)] else 'split'}: "
                  + "; ".join(line))
            del f, g, w, wmt

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
        gmodel = build_model(dict(tcfg.model)).to(dev)
        gmodel.load_state_dict(state)
        gmodel.train()
        plain_cores = {"band_fwd_core": bc.band_fwd_core_plain,
                       "band_dxdw_core": bc.band_dxdw_core_plain,
                       "band_dw_core": bc.band_dw_core_plain}

        def step_grads(plain):
            saved = {name: getattr(bc, name) for name in plain_cores}
            if plain:
                for name, fn in plain_cores.items():
                    setattr(bc, name, fn)
            try:
                gmodel.zero_grad(set_to_none=True)
                before = [k.launches for k in bc.KERNELS]
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = gmodel(b_inputs)
                out["loss"].backward()
                torch.cuda.synchronize()
                secs = time.perf_counter() - t
                launched = [k.launches - b for k, b in zip(bc.KERNELS, before)]
                grads = {n: p.grad.detach().clone() for n, p in gmodel.named_parameters()}
                return float(out["loss"].detach()), grads, launched, secs
            finally:
                for name, fn in saved.items():
                    setattr(bc, name, fn)

        # two runs of each path: the step's grads are not bitwise reproducible
        # (index_add_ and the backward of row gathers accumulate with
        # atomics), and the deepest encoder convs' dW, summed over ~1M rows
        # into a BN-centred cotangent, cancel to ~1e-4, so f32 order noise
        # reaches ~1e-2 of their max|grad| between two runs of the SAME path.
        # Each tensor is held to 1e-3 of its max|ref| plus 3x that measured
        # run-to-run spread.
        loss_k, grads_k, launched_k, secs_k = step_grads(False)
        _, grads_k2, _, _ = step_grads(False)
        loss_p, grads_p, launched_p, secs_p = step_grads(True)
        _, grads_p2, _, _ = step_grads(True)
        check(launched_k == per_step and launched_p == [0, 0, 0],
              f"launches kernel path {launched_k}, plain path {launched_p}")
        check(abs(loss_k - loss_p) <= 1e-5 * abs(loss_p),
              f"loss kernel {loss_k} vs plain {loss_p}")
        rows = []
        for name, ref in grads_p.items():
            scale = ref.abs().max().item()
            err = (grads_k[name] - ref).abs().max().item()
            spread = max((grads_p2[name] - ref).abs().max().item(),
                         (grads_k2[name] - grads_k[name]).abs().max().item())
            rows.append((err / max(scale, 1e-30), spread / max(scale, 1e-30), name))
            check(err <= 1e-3 * scale + 3 * spread,
                  f"grad {name}: err {err:.3e} > 1e-3 x {scale:.3e} + 3 x spread "
                  f"{spread:.3e}")
        rows.sort()
        strict = sum(r[0] <= 1e-3 for r in rows)
        print(f"[grad] one step from the trained state: loss kernel {loss_k:.7f} plain "
              f"{loss_p:.7f}; {strict} of {len(rows)} grads within 1e-3 of their "
              f"max|ref|; worst {rows[-1][2]} at {rows[-1][0]:.3e} (run-to-run "
              f"spread {rows[-1][1]:.3e}); largest spread "
              f"{max(r[1] for r in rows):.3e}; forward+backward {1e3 * secs_k:.1f} ms "
              f"with the kernels, {1e3 * secs_p:.1f} ms plain")
        for ratio, spread, name in rows[-5:]:
            print(f"[grad]   {name}: kernel vs plain {ratio:.3e}, spread {spread:.3e} "
                  "(of max|ref|)")
        phase_done("8 grads kernel vs plain")

        # ---- 9. output
        print(f"[time] per training step at batch {tcfg.batch_size}: "
              + "; ".join(f"{name} {s['ms']:.3f} ms vs plain {s['plain_ms']:.3f} ms"
                          for name, s in stats.items()))
        print(f"[time] phases: " + ", ".join(f"{k} {v:.1f} s" for k, v in phase_s.items()))
        print(json.dumps({"kernels": [{
            "name": name,
            "route": "cuda",
            "source": KERNEL_SOURCES[name][0],
            "replaces": KERNEL_SOURCES[name][1],
            "launches": launches,
            "max_abs_err": stats[name]["err"],
            "ms": stats[name]["ms"],
            "plain_ms": stats[name]["plain_ms"],
        } for name, launches in zip(KERNEL_SOURCES, train_launches)]}))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
