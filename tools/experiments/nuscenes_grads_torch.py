"""Where the nuScenes semseg step's grads part from float64: by kernel and
by loss term.

    python tools/experiments/nuscenes_grads_torch.py [--sweep] [--out exp/nuscenes_grads.json]

Writes ``chip_smoke.py`` phase 18's procedural scans, trains
``configs/nuscenes/semseg-ppt-v1m1-0-nu-sk-wa-spunet-ft.py`` its 3 steps
(``chip_smoke.py:train_and_check``) to take the first batch, and then,
from the seeded state, runs one forward and backward through each of: the
plain versions in float64 (the reference), the plain versions in f32, all
three kernels, and each of K1, K2 and K3 alone (the other two plain). It
does so with the config's loss (CE + Lovasz), with Lovasz's sort orders
pinned to the float64 run's, and with CE alone. Per run it prints the
parameters furthest from float64 (|grad - float64| / max|float64 grad|)
and, for the Lovasz runs, the share of sorted positions whose element
differs from the float64 run's. With ``--sweep``, then (``k1_sweep``)
K1 at one call of the step at a time, K1's error reshaped, and K1's and
plain f32's error statistics at the call that moves the watched grads
most. Writes every parameter's numbers to ``--out``. Needs a CUDA GPU.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tools")]

# the parameters chip_smoke.py phase 18's seeded grads check named
WATCH = ("backbone.dec.2.block1.conv2.weight", "backbone.dec.2.block1.bn2.bias")


class PinnedLovasz:
    """Swaps ``lovasz._lovasz_flat`` for one that records each call's sort
    order (``record``), or sorts by the recorded orders (``replay``) and
    counts the positions whose element its own sort would have changed."""

    def __init__(self):
        self.orders, self.moved, self.mode, self.i = [], [], None, 0

    def __call__(self, errors, fg):
        import torch

        from ponderv2_tpu_torch.models.losses import lovasz

        own = torch.sort(-errors, stable=True).indices
        if self.mode == "record":
            self.orders.append(own)
            order = own
        else:
            order = self.orders[self.i]
            self.moved.append(int((own != order).sum()))
        self.i += 1
        if self.mode == "count":
            order = own
        return torch.dot(errors[order], lovasz._lovasz_grad(fg[order]))

    def run(self, mode, fn):
        from ponderv2_tpu_torch.models.losses import lovasz

        saved = lovasz._lovasz_flat
        self.mode, self.i, self.moved = mode, 0, []
        lovasz._lovasz_flat = self
        try:
            return fn()
        finally:
            lovasz._lovasz_flat = saved


def watched(grads, grads_r):
    """|grad - float64| of the ``WATCH`` parameters."""
    return [(grads[n].double() - grads_r[n]).abs().max().item() for n in WATCH]


def k1_sweep(cs, gmodel, inputs, grads_r):
    """With the config's loss from the seeded state: K1 launched at one
    band_fwd_core call of the step only (the plain versions elsewhere), for
    each call; then K1's error against the plain version at every call
    (kernel - plain) added to the plain output with a random sign per
    element, negated, halved and doubled; and the per-call statistics of
    K1's and plain f32's errors against float64 at the call that moves the
    watched grads most."""
    import torch

    from ponderv2_tpu_torch.ops import band_conv as bc

    kern, plain = bc.band_fwd_core, bc.band_fwd_core_plain
    base = {n: getattr(bc, f"{n}_plain") for n in cs.BAND_CORES}
    count = {"n": 0}

    def counting(*args):
        count["n"] += 1
        return plain(*args)

    cs.step_grads(gmodel, inputs, {**base, "band_fwd_core": counting})
    calls, out = count["n"], {"one_call": [], "error_forms": {}}
    print(f"[K1 sweep] {calls} band_fwd_core calls a step", flush=True)
    for index in range(calls):
        state = {"i": 0, "shape": None}

        def one(f, rbt, w0, w, kz, block, window, index=index, state=state):
            i = state["i"]
            state["i"] += 1
            if i != index:
                return plain(f, rbt, w0, w, kz, block, window)
            state["shape"] = (f.shape[0], f.shape[1], w.shape[2], int(rbt.shape[0]))
            return kern(f, rbt, w0, w, kz, block, window)

        _, grads, launched, _ = cs.step_grads(gmodel, inputs, {**base, "band_fwd_core": one})
        errs = watched(grads, grads_r)
        out["one_call"].append(dict(call=index, shape=state["shape"], launched=launched,
                                    watched=errs))
        print(f"[K1 sweep] call {index} (rows, cin, cout, rbt rows) {state['shape']}: "
              "watched " + ", ".join(f"{e:.3e}" for e in errs), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    for form, scale in (("random sign", None), ("negated", -1.0), ("halved", 0.5),
                        ("doubled", 2.0), ("as is", 1.0)):
        def shaped(f, rbt, w0, w, kz, block, window, scale=scale):
            p = plain(f, rbt, w0, w, kz, block, window)
            e = kern(f, rbt, w0, w, kz, block, window) - p
            if scale is None:
                sign = torch.randint(0, 2, e.shape, generator=gen, device=e.device) * 2 - 1
                return p + sign.to(e.dtype) * e
            return p + scale * e

        _, grads, _, _ = cs.step_grads(gmodel, inputs, {**base, "band_fwd_core": shaped})
        errs = watched(grads, grads_r)
        out["error_forms"][form] = errs
        print(f"[K1 error] plain + ({form}) (K1 - plain) at every call: watched "
              + ", ".join(f"{e:.3e}" for e in errs), flush=True)

    worst = max(out["one_call"], key=lambda r: r["watched"][0])["call"]
    state = {"i": 0}

    def stats(f, rbt, w0, w, kz, block, window):
        i = state["i"]
        state["i"] += 1
        p = plain(f, rbt, w0, w, kz, block, window)
        if i == worst:
            k = kern(f, rbt, w0, w, kz, block, window)
            exact = plain(f.double(), rbt, w0, w.double(), kz, block, window)
            mag = plain(f.double().abs(), rbt, w0, w.double().abs(), kz, block, window)
            live = mag > 0
            row = {}
            for name, o in (("K1", k), ("plain f32", p)):
                e = (o.double() - exact)[live]
                rel = e / mag[live]
                row[name] = dict(max_abs=e.abs().max().item(), mean=e.mean().item(),
                                 mean_rel_to_sum_abs=rel.mean().item(),
                                 rms_rel_to_sum_abs=rel.pow(2).mean().sqrt().item(),
                                 toward_zero=((e * exact[live]) < 0).double().mean().item())
            out["worst_call"] = dict(call=worst, rows=f.shape[0], cin=f.shape[1],
                                     cout=w.shape[2], **row)
            print(f"[K1 error] call {worst} ({f.shape[0]} rows, {f.shape[1]} -> "
                  f"{w.shape[2]}) against float64 over its live outputs: " + "; ".join(
                      f"{name} max {r['max_abs']:.3e}, mean {r['mean']:+.3e}, mean / "
                      f"sum|products| {r['mean_rel_to_sum_abs']:+.3e}, rms / sum|products| "
                      f"{r['rms_rel_to_sum_abs']:.3e}, share toward zero "
                      f"{r['toward_zero']:.4f}" for name, r in row.items()), flush=True)
        return p

    cs.step_grads(gmodel, inputs, {**base, "band_fwd_core": stats})
    return out


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--sweep", action="store_true",
                        help="also run k1_sweep (about 4 minutes on an H100)")
    parser.add_argument("--out", default=os.path.join(ROOT, "exp",
                                                      "nuscenes_grads.json"))
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        print("nuscenes_grads_torch: needs a CUDA GPU", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from ponderv2_tpu_torch.datasets.preprocessing.synthetic_nuscenes import (
        write_synthetic_nuscenes)
    from ponderv2_tpu_torch.engines.defaults import default_config_parser
    from ponderv2_tpu_torch.models import build_model
    from ponderv2_tpu_torch.ops import band_conv as bc
    from ponderv2_tpu_torch.ops.cuda_build import load_libraries
    from ponderv2_tpu_torch.utils.config import Config

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    load_libraries(*sorted({k.source for k in bc.KERNELS}))
    bc.build_kernels()

    tmp = tempfile.mkdtemp(prefix="nuscenes_grads_")
    try:
        root = os.path.join(tmp, "nuscenes_semseg")
        workers = cs.nuscenes_num_worker(Config.fromfile(cs.NUSCENES_SEMSEG).num_worker)
        write_synthetic_nuscenes(root, {"train": cs.NUSCENES_SEMSEG_SCANS,
                                        "val": cs.NUSCENES_VAL_SCANS}, cs.SEED + 2,
                                 cameras=False, workers=workers)
        cfg = default_config_parser(cs.NUSCENES_SEMSEG, cs.nuscenes_options(
            cs.NUSCENES_SEMSEG, root, os.path.join(tmp, "train"), workers))
        cfg.seed = cs.SEED
        cfg.device = str(dev)
        run = cs.train_and_check("nuscenes-semseg", cfg, dev)
        inputs = run.b_inputs
        del run
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    plain = {name: getattr(bc, f"{name}_plain") for name in cs.BAND_CORES}
    variants = {"plain f32": plain, "K1+K2+K3": {}}
    for i, name in enumerate(cs.BAND_CORES):
        variants[f"K{i + 1} alone"] = {n: f for n, f in plain.items() if n != name}

    losses = {"CE + Lovasz": None, "CE + Lovasz, sort pinned": None, "CE alone": [
        c for c in cfg.model["criteria"] if c["type"] == "CrossEntropyLoss"]}
    report = {"card": smi, "runs": {}}
    for loss_name, criteria in losses.items():
        model_cfg = dict(cfg.model)
        if criteria is not None:
            model_cfg["criteria"] = criteria
        gmodel = build_model(model_cfg)
        gmodel.reset_parameters(torch.Generator().manual_seed(cs.SEED))
        gmodel.to(dev).train()
        pin = PinnedLovasz()
        lovasz = criteria is None
        pinned = loss_name.endswith("pinned")
        t0 = time.perf_counter()
        if lovasz:
            loss_r, grads_r, _ = pin.run("record", lambda: cs.float64_step_grads(gmodel, inputs))
        else:
            loss_r, grads_r, _ = cs.float64_step_grads(gmodel, inputs)
        print(f"[{loss_name}] float64 plain: loss {loss_r:.12f} ({time.perf_counter() - t0:.1f} s)",
              flush=True)
        for var_name, cores in variants.items():
            step = lambda: cs.step_grads(gmodel, inputs, cores)  # noqa: E731
            if lovasz:
                loss, grads, launched, _ = pin.run("replay" if pinned else "count", step)
            else:
                loss, grads, launched, _ = step()
            rows = {}
            for name, ref in grads_r.items():
                scale = ref.abs().max().item()
                err = (grads[name].double() - ref).abs().max().item()
                rows[name] = dict(err=err, scale=scale, rel=err / max(scale, 1e-30))
            worst = sorted(rows, key=lambda n: rows[n]["rel"], reverse=True)[:3]
            moved = ""
            if lovasz:
                n = sum(int(o.numel()) for o in pin.orders)
                moved = (f"; sorted positions whose element its own sort moves off "
                         f"float64's: {sum(pin.moved)} of {n}")
            print(f"[{loss_name}] {var_name}: launches {launched}, loss {loss:.12f} "
                  f"(float64 {loss - loss_r:+.3e}){moved}; watched: " + ", ".join(
                      f"{n.split('backbone.')[-1]} {rows[n]['err']:.3e} of "
                      f"{rows[n]['scale']:.3e}" for n in WATCH) + "; furthest: " + ", ".join(
                      f"{n.split('backbone.')[-1]} {rows[n]['rel']:.3e}" for n in worst),
                  flush=True)
            report["runs"][f"{loss_name} / {var_name}"] = dict(
                loss=loss, loss_float64=loss_r, launches=launched,
                lovasz_moved=sum(pin.moved) if lovasz else None, grads=rows)
        if loss_name == "CE + Lovasz" and opts.sweep:
            kept = (gmodel, grads_r)
        else:
            del gmodel, grads_r
        torch.cuda.empty_cache()
    if opts.sweep:
        report["k1_calls"] = k1_sweep(cs, kept[0], inputs, kept[1])
        del kept
    os.makedirs(os.path.dirname(opts.out), exist_ok=True)
    with open(opts.out, "w") as f:
        json.dump(report, f)
    print(f"wrote {opts.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
