#!/usr/bin/env python3
"""Run-to-run reproducibility of the port's training steps, on a GPU.

    python tools/experiments/repro_torch.py [--root DIR] [--runs 3]
        [--steps finetune,pretrain] [--deterministic]

Takes the first batch of the fine-tune step
(``configs/_test_/semseg_spunet_scannet_synthetic_train.py``: SpUNet-v1m1,
f32, 12 scenes) and of the pretrain step
(``configs/_test_/pretrain_bench_torch.py``: PonderIndoor-v2, bf16, 2
scenes), seeds the model as ``Trainer`` does (``default_setup``, then
``reset_parameters``), and runs the step's forward and backward ``--runs``
times from the same state, inputs and random draws. Prints each run's time
(host clock, synchronized; the first run builds and warms up) and whether the
loss and every gradient have the first run's bits; where they differ, the
count of gradients that differ, the largest difference in units of its
max|grad|, and the modules whose forward output first differs between two
more runs (float64 sums taken by forward hooks).

``--root`` imports the package and the configs from another checkout (the
parent commit, unpacked with ``git archive``), so that two trees run on one
card in one call; ``--cudnn-deterministic 0`` overrides the switch that
``set_seed`` sets, to time what it costs. ``--deterministic`` runs under
``torch.use_deterministic_algorithms(True, warn_only=True)`` (set
``CUBLAS_WORKSPACE_CONFIG=:4096:8`` in the environment) and prints the
warning of every op that has no deterministic implementation.
"""

import argparse
import os
import sys
import tempfile
import time
import warnings

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def first_batch(cfg, dev):
    """The train loader's first batch as the step's inputs, with the static
    context ``Trainer`` adds."""
    import torch

    from ponderv2_tpu_torch.datasets import build_dataloader, build_dataset
    from ponderv2_tpu_torch.engines.common import split_batch

    loader = build_dataloader(build_dataset(dict(cfg.data.train)), batch_size=cfg.batch_size,
                              num_workers=0, shuffle=True, drop_last=True,
                              point_budget=cfg.get("point_budget"),
                              scene_budget=cfg.batch_size, mix_prob=cfg.get("mix_prob", 0.0),
                              seed=cfg.seed)
    inputs = {k: torch.as_tensor(v, device=dev)
              for k, v in split_batch(next(iter(loader)))[0].items()}
    inputs.update(spatial_shape=tuple(cfg.get("sparse_shape", (1024, 1024, 1024))),
                  batch_size=int(cfg.batch_size))
    inputs.update(cfg.get("static_ctx", {}))
    return inputs


def run_step(model, inputs, hooks=None):
    """(loss, {name: grad}, seconds) of one forward and backward."""
    import torch

    model.zero_grad(set_to_none=True)
    handles = []
    if hooks is not None:
        def hook(name):
            def record(_, __, out):
                outs = out.values() if isinstance(out, dict) else (
                    out if isinstance(out, (tuple, list)) else (out,))
                sums = [o.detach().double().sum() for o in outs
                        if isinstance(o, torch.Tensor) and o.is_floating_point()]
                if sums:
                    hooks.append((name, torch.stack(sums).sum()))
            return record

        handles = [m.register_forward_hook(hook(n)) for n, m in model.named_modules() if n]
    try:
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss = model(inputs)["loss"]
        loss.backward()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
    finally:
        for h in handles:
            h.remove()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()
             if p.grad is not None}
    return loss.detach().clone(), grads, secs


def compare(tag, model, inputs, runs):
    import torch

    results = [run_step(model, inputs) for _ in range(runs)]
    loss0, grads0, _ = results[0]
    times = ", ".join(f"{1e3 * r[2]:.1f}" for r in results)
    print(f"[{tag}] forward+backward ms per run: {times}", flush=True)
    diverged = False
    for i, (loss, grads, _) in enumerate(results[1:], 1):
        same_loss = torch.equal(loss, loss0)
        diff = []
        for name, g in grads0.items():
            if not torch.equal(grads[name], g):
                scale = g.abs().max().item()
                diff.append(((grads[name] - g).abs().max().item() / max(scale, 1e-30), name))
        diff.sort()
        diverged |= bool(diff) or not same_loss
        print(f"[{tag}] run {i} vs run 0: loss {'equal' if same_loss else 'DIFFERS'} "
              f"({loss.item():.9g} vs {loss0.item():.9g}); {len(diff)} of {len(grads0)} "
              f"grads differ" + (f", largest {diff[-1][0]:.3e} of max|grad| at {diff[-1][1]}"
                                 if diff else ""), flush=True)
    if diverged:
        a, b = [], []
        run_step(model, inputs, a)
        run_step(model, inputs, b)
        firsts = [na for (na, x), (nb, y) in zip(a, b) if not torch.equal(x, y)]
        print(f"[{tag}] {len(firsts)} of {len(a)} module outputs differ between two runs; "
              f"first in call order: {firsts[:8]}", flush=True)
    return not diverged


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", default=HERE)
    parser.add_argument("--runs", type=int, default=3)
    parser.add_argument("--steps", default="finetune,pretrain")
    parser.add_argument("--deterministic", action="store_true")
    parser.add_argument("--cudnn-deterministic", type=int, choices=(0, 1), default=None,
                        help="override set_seed's cudnn.deterministic (to time its cost)")
    args = parser.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("repro_torch: needs a CUDA GPU", file=sys.stderr)
        return 2
    from ponderv2_tpu_torch.engines.defaults import default_config_parser, default_setup
    from ponderv2_tpu_torch.models import build_model

    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"root {root}; " + os.popen("nvidia-smi --query-gpu=name,power.limit "
                                      "--format=csv,noheader").read().strip(), flush=True)
    if args.deterministic:
        torch.use_deterministic_algorithms(True, warn_only=True)
    configs = {"finetune": "semseg_spunet_scannet_synthetic_train.py",
               "pretrain": "pretrain_bench_torch.py"}
    ok = True
    with tempfile.TemporaryDirectory(prefix="repro_") as tmp, \
            warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for step in args.steps.split(","):
            # the fine-tune step without the backbone's remat, as it was timed
            # before remat became the default (the pretrain config sets it)
            opts = {"save_path": os.path.join(tmp, step)}
            if step == "finetune":
                opts["model.backbone.remat"] = False
            cfg = default_config_parser(os.path.join(root, "configs", "_test_", configs[step]),
                                        opts)
            cfg = default_setup(cfg)
            if args.cudnn_deterministic is not None:
                torch.backends.cudnn.deterministic = bool(args.cudnn_deterministic)
            print(f"[{step}] cudnn.deterministic {torch.backends.cudnn.deterministic} "
                  f"benchmark {torch.backends.cudnn.benchmark}", flush=True)
            inputs = first_batch(cfg, dev)
            model = build_model(dict(cfg.model))
            model.reset_parameters(torch.Generator().manual_seed(cfg.seed))
            model.to(dev).train()
            if hasattr(model, "draw_noise"):
                b, v, h, w = inputs["depth"].shape
                inputs["draws"] = model.draw_noise(
                    torch.Generator(device=dev).manual_seed(cfg.seed), b, v, h * w)
            ok &= compare(step, model, inputs, args.runs)
            del model, inputs
            torch.cuda.empty_cache()
    if args.deterministic:
        seen = sorted({str(w.message).split("\n")[0] for w in caught
                       if "deterministic" in str(w.message)})
        print(f"[deterministic] {len(seen)} ops without a deterministic implementation:")
        for msg in seen:
            print(f"[deterministic]   {msg}")
    print(f"[repro] {'every run equal' if ok else 'runs differ'}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
