"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout on a machine with the cards the cell asks
for. With ``--trace 0`` the result's metrics are the cell's end-to-end
ones, with ``--trace 1`` its per-layer ones. The last line of standard
output is one JSON object; the numbers of the correctness check, each
beside its limit, are the last lines of standard error and the last key
of that object.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def result(bench, ctx, run, check, trace: bool) -> dict:
    """The run's line: its metrics as the cell's entries name them, the
    device, and last the check's numbers with their limits."""
    from benchmark.harness import core, readers

    import torch

    section = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in core.cell_metrics(bench, ctx.workload, section):
        value = core.metric_reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": int(ctx.cell["chips"]), "memory_peak_bytes": int(run.peak_bytes)}
    out = {"correct": check.correct, "attempted": run.attempted, "failed": run.failed,
           "metrics": metrics, "device": device}
    if trace and run.trace is not None:
        device["busy_s"] = run.trace.busy_s()
        device["window_s"] = run.trace.window_s
        out["breakdown"] = {"device_ops": run.trace.top_ops(),
                            "idle_gaps": run.trace.idle_gaps()}
    out["run"] = {"setup_s": run.setup_s, "setup": run.setup,
                  "benchmark_s": run.benchmark_s, "window_s": run.window_s,
                  "count": run.count, "check_s": run.check_s,
                  "unit_ms": {f"p{round(q * 100)}": readers.quantile_ms(run, q)
                              for q in (0.5, 0.75, 0.9, 0.95)}}
    out["checks"] = check.report()
    return out


def main(argv=None) -> int:
    args = parse(argv)
    sys.path.insert(0, ROOT)
    from benchmark.harness import core

    core.set_cache_dirs()
    bench = core.benchmark()
    chips = int(core.cell(args.workload, bench)["chips"])

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    with tempfile.TemporaryDirectory(prefix="bench-") as tmp:
        ctx = core.Ctx(args.workload, args.seed, args.seconds, bool(args.trace),
                       tmp=tmp, bench=bench, t0=T0)
        run, program, _ = core.driver(ctx.mix["driver"]).run(ctx)
    check = core.Check(ctx.limits)
    for name, value in program.items():
        check.add(name, value)
    found = core.forbidden_modules()
    if found:
        print(f"benchmark: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    out = result(bench, ctx, run, check, bool(args.trace))
    for line in check.lines():
        print(line, file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
