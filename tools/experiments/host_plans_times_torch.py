"""Times of the pretrain step's conv plans: the host build against the
in-step build, and the step with the host plan prefetch on and off.

Runs ``configs/_test_/pretrain_bench_torch.py`` (bf16, batch 2, full width)
on the card:

1. The first ``--steps`` train batches' plans, each built on the CPU
   (``engines/plan_prefetch.py:attach_plans``, the prefetch thread's build,
   here alone) and on the card (``build_spunet_plans_auto`` on the sorted
   coords, the in-step build), with ``ops/spconv.py:_tap_keys`` in two
   forms: ``tap_keys_3d`` below, which makes the (T, N, 3) query array, and
   the package's, which adds each tap's offset key to the row's base key.
   The forms run in the order 3d, package, package, 3d; their plans must be
   integer-equal. Each form's ``_tap_keys`` alone is timed on the k5 stem's
   (125, N) query too.
2. ``--runs`` pairs of ``Trainer`` runs over ``2 * --steps`` scenes, with
   ``host_plans`` off and on, in the order off, on, on, off, ...: per step
   the data wait (``next`` on the loader), the step (batch to the card ..
   metrics synced) and their sum, which is what a user waits for. The
   losses must be bit-equal across all runs (else the exit code is 1).

Prints the card's name and power limit, a line per measurement, and one
JSON object on its last line::

    python tools/experiments/host_plans_times_torch.py [--steps 8] [--runs 2]

``--device cpu`` with ``--options`` (dotted ``key=value`` config overrides)
runs it at a test size without a card.
"""

from __future__ import annotations

import argparse
import ast
import gc
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from ponderv2_tpu_torch.ops import hashing, spconv  # noqa: E402

CONFIG = os.path.join(ROOT, "configs", "_test_", "pretrain_bench_torch.py")
SEED = 0


def tap_keys_3d(coords, offsets, stride, padding, spatial_shape) -> torch.Tensor:
    """``_tap_keys`` through the (T, N, 3) query array: each tap's query
    cell made, bounds-checked and ravelled per axis."""
    X, Y, Z = (int(s) for s in spatial_shape)
    dev = coords.device
    c = coords.to(torch.int64)
    b = c[:, 0]
    s = torch.tensor(spconv._triple(stride), dtype=torch.int64, device=dev)
    p = torch.tensor(spconv._triple(padding), dtype=torch.int64, device=dev)
    off = torch.tensor(offsets, dtype=torch.int64, device=dev).reshape(-1, 3)
    q = c[None, :, 1:4] * s - p + off[:, None, :]  # (T, N, 3)
    dims = torch.tensor([X, Y, Z], dtype=torch.int64, device=dev)
    valid = (b >= 0)[None] & (q >= 0).all(-1) & (q < dims).all(-1)
    key = ((b[None] * X + q[..., 0]) * Y + q[..., 1]) * Z + q[..., 2]
    return torch.where(valid, key, torch.full_like(key, hashing.INVALID_KEY))


FORMS = {"3d": tap_keys_3d, "package": spconv._tap_keys}


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def timed(fn, dev):
    """(fn's result, its seconds with the device synced either side)."""
    sync(dev)
    t = time.perf_counter()
    out = fn()
    sync(dev)
    return out, time.perf_counter() - t


def leaves(tree, path="plans"):
    """[(path, leaf)] of a plan tree, NamedTuple fields by name."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [x for f, v in zip(tree._fields, tree) for x in leaves(v, f"{path}.{f}")]
    if isinstance(tree, (tuple, list)):
        return [x for i, v in enumerate(tree) for x in leaves(v, f"{path}[{i}]")]
    return [(path, tree)]


def same_plans(a, b) -> bool:
    la, lb = leaves(a), leaves(b)
    if [p for p, _ in la] != [p for p, _ in lb]:
        return False
    for (_, x), (_, y) in zip(la, lb):
        if isinstance(x, torch.Tensor) and isinstance(y, torch.Tensor):
            if not torch.equal(x.cpu(), y.cpu()):
                return False
        elif x != y:
            return False
    return True


def make_trainer(args, tmp, name, host_plans, scenes):
    from ponderv2_tpu_torch.engines.defaults import default_config_parser, default_setup
    from ponderv2_tpu_torch.engines.train import Trainer

    options = {"save_path": os.path.join(tmp, name), "host_plans": host_plans,
               "data.train.num_scenes": scenes, **args.options}
    cfg = default_config_parser(args.config, options)
    cfg.seed = SEED
    cfg.device = args.device
    return Trainer(default_setup(cfg))


def build_times(args, dev, tmp):
    """Part 1: per batch and form, the host build's and the in-step build's
    seconds."""
    from ponderv2_tpu_torch.engines.plan_prefetch import attach_plans, plan_cfg_from_model_cfg
    from ponderv2_tpu_torch.models.default import batch_to_sparse_tensor
    from ponderv2_tpu_torch.models.sparse_unet.plans import (build_spunet_plans_auto,
                                                             capacity_schedule)
    from ponderv2_tpu_torch.ops.sparse import maybe_sort_by_key

    trainer = make_trainer(args, tmp, "build", False, 2 * args.steps)
    plan_cfg = plan_cfg_from_model_cfg(dict(trainer.cfg.model), trainer.static_ctx)
    assert plan_cfg is not None, "the config takes no host plans"
    spunet = trainer.model.backbone
    batches = [b for _, b in zip(range(args.steps), trainer.train_loader)]
    ctx = trainer.static_ctx
    del trainer
    gc.collect()

    host = {f: [] for f in FORMS}
    device = {f: [] for f in FORMS}
    alone = {f: {"cpu": [], dev.type: []} for f in FORMS}
    order = ["3d", "package", "package", "3d"]
    for i, batch in enumerate(batches):
        arrays = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()
                  if isinstance(v, np.ndarray)}
        st, _ = maybe_sort_by_key(batch_to_sparse_tensor({**arrays, **ctx}), True)
        caps = spunet.capacities or capacity_schedule(st.capacity, spunet.num_stages)
        built = {}
        for form in order:
            spconv._tap_keys = FORMS[form]
            try:
                hp, hs = timed(lambda: attach_plans(batch, plan_cfg)["spunet_plans"],
                               torch.device("cpu"))
                dp, ds = timed(lambda: build_spunet_plans_auto(
                    st.coords, st.spatial_shape, st.batch_size, caps, spunet.channels), dev)
                for d, c in ((torch.device("cpu"), st.coords.cpu()), (dev, st.coords)):
                    alone[form][d.type].append(timed(lambda: FORMS[form](
                        c, spconv.kernel_offsets(5), 1, 2, st.spatial_shape), d)[1])
            finally:
                spconv._tap_keys = FORMS["package"]
            host[form].append(hs)
            device[form].append(ds)
            built.setdefault(form, (hp, dp))
        equal = (same_plans(built["3d"][0], built["package"][0])
                 and same_plans(built["3d"][1], built["package"][1])
                 and same_plans(built["package"][0], built["package"][1]))
        assert equal, f"batch {i}: the two forms' plans differ"
        print(f"[build] batch {i}: host build ms " + ", ".join(
            f"{f} {1e3 * host[f][-2]:.1f} / {1e3 * host[f][-1]:.1f}" for f in FORMS)
            + "; in-step build ms " + ", ".join(
            f"{f} {1e3 * device[f][-2]:.1f} / {1e3 * device[f][-1]:.1f}" for f in FORMS)
            + "; plans integer-equal across forms and devices", flush=True)
        del built, arrays, st
        gc.collect()
    out = {}
    for f in FORMS:
        # the first batch's first calls pay the allocator's and the
        # kernels' warm-up: medians over the rest
        out[f] = dict(host_ms=[1e3 * t for t in host[f]],
                      device_ms=[1e3 * t for t in device[f]],
                      host_ms_median=1e3 * float(np.median(host[f][2:] or host[f])),
                      device_ms_median=1e3 * float(np.median(device[f][2:] or device[f])),
                      stem_keys_cpu_ms=1e3 * float(np.median(alone[f]["cpu"][2:]
                                                             or alone[f]["cpu"])),
                      stem_keys_device_ms=1e3 * float(np.median(alone[f][dev.type][2:]
                                                                or alone[f][dev.type])))
        print(f"[build] _tap_keys {f}: host build {out[f]['host_ms_median']:.1f} ms, "
              f"in-step build {out[f]['device_ms_median']:.1f} ms (medians after the first "
              f"batch); the k5 stem's keys alone {out[f]['stem_keys_cpu_ms']:.1f} ms on the "
              f"CPU, {out[f]['stem_keys_device_ms']:.3f} ms on {dev.type}", flush=True)
    return out


def trainer_run(args, dev, tmp, name, host_plans):
    """Part 2: one run of ``2 * --steps`` scenes; per step (wait, step)
    seconds and the loss."""
    trainer = make_trainer(args, tmp, name, host_plans, 2 * args.steps)
    rec = dict(wait=[], step=[], loss=[])
    batches = iter(trainer.train_loader)
    for _ in range(len(trainer.train_loader)):
        sync(dev)
        t0 = time.perf_counter()
        batch = next(batches)
        t1 = time.perf_counter()
        trainer.comm_info["input_dict"] = batch
        trainer.run_step()
        metrics = trainer.sync_metrics()
        sync(dev)
        rec["wait"].append(t1 - t0)
        rec["step"].append(time.perf_counter() - t1)
        rec["loss"].append(metrics["loss"])
    del trainer, batches
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    total = [w + s for w, s in zip(rec["wait"], rec["step"])]
    print(f"[step] {name} (host_plans {'on' if host_plans else 'off'}): per step ms "
          + "; ".join(f"wait {1e3 * w:.1f} + step {1e3 * s:.1f} = {1e3 * t:.1f}"
                      for w, s, t in zip(rec["wait"], rec["step"], total))
          + f"; all {1e3 * sum(total):.1f}, after the first {1e3 * sum(total[1:]):.1f}",
          flush=True)
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default=CONFIG)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--options", nargs="*", default=[],
                    help="dotted key=value config overrides")
    args = ap.parse_args()
    args.options = {k: ast.literal_eval(v) for k, v in
                    (o.split("=", 1) for o in args.options)}
    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            print("no CUDA device", file=sys.stderr)
            return 2
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True).stdout.strip()
        print(f"[card] {card}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        builds = build_times(args, dev, tmp)
        runs = {True: [], False: []}
        for r in range(args.runs):
            for host_plans in ((False, True) if r % 2 == 0 else (True, False)):
                name = f"run{len(runs[True]) + len(runs[False])}"
                runs[host_plans].append(trainer_run(args, dev, tmp, name, host_plans))
    losses = [rec["loss"] for recs in runs.values() for rec in recs]
    same = all(ls == losses[0] for ls in losses)
    steps = {}
    for host_plans, recs in runs.items():
        key = "on" if host_plans else "off"
        total = [[1e3 * (w + s) for w, s in zip(rec["wait"], rec["step"])] for rec in recs]
        later = [t for ts in total for t in ts[1:]]
        steps[key] = dict(
            wait_ms=[[1e3 * w for w in rec["wait"]] for rec in recs],
            step_ms=[[1e3 * s for s in rec["step"]] for rec in recs],
            total_ms=total, first_ms=[ts[0] for ts in total],
            later_mean_ms=float(np.mean(later)), later_median_ms=float(np.median(later)),
            run_ms=[sum(ts) for ts in total])
        print(f"[step] host_plans {key}: wait + step after the first step, mean "
              f"{steps[key]['later_mean_ms']:.1f} ms, median "
              f"{steps[key]['later_median_ms']:.1f} ms over {len(later)} steps; first "
              f"step {', '.join(f'{t:.1f}' for t in steps[key]['first_ms'])} ms; runs "
              f"{', '.join(f'{t:.1f}' for t in steps[key]['run_ms'])} ms", flush=True)
    print(f"[step] losses {'bit-equal' if same else 'NOT bit-equal'} across the "
          f"{len(losses)} runs: {losses}", flush=True)
    print(json.dumps({"builds": builds, "steps": steps, "n_steps": args.steps,
                      "runs": args.runs, "losses_equal": same}))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
