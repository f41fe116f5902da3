"""Readings that the limits of a cell's correctness check are set from.

    python3 benchmark/calibrate.py --workload <name> --seeds S1 S2 ... \
        [--control-seeds C1 C2 ...] [--seconds S]

Runs the cell in one process for each seed (the window ``--seconds``
long) and prints one JSON line a seed: the program's numbers, and on the control seeds the control's
(the plain reference in TF32 in the program's place, against the f32
reference), then a summary: the largest program reading and the smallest
control reading of each number. Not run by the benchmark's own runs.
"""

import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=0.0)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    from benchmark.harness import core

    import torch

    core.set_cache_dirs()
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    bench = core.benchmark()
    lows, highs = {}, {}
    for seed in args.seeds + [s for s in args.control_seeds if s not in args.seeds]:
        controls = ("tf32",) if seed in args.control_seeds else ()
        t = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="bench-cal-") as tmp:
            ctx = core.Ctx(args.workload, seed, args.seconds, False, tmp=tmp,
                           bench=bench, controls=controls)
            run, program, ctrl = core.driver(ctx.mix["driver"]).run(ctx)
        line = {"seed": seed, "program": program, **ctrl, "setup_s": run.setup_s,
                "setup": run.setup, "count": run.count, "check_s": run.check_s,
                "seconds": time.perf_counter() - t,
                "peak_bytes": run.peak_bytes}
        if seed in args.seeds:
            for k, v in program.items():
                lows[k] = max(lows.get(k, 0.0), v)
        for readings in ctrl.values():
            for k, v in readings.items():
                highs[k] = min(highs.get(k, float("inf")), v)
        print(json.dumps(line), flush=True)
        torch.cuda.reset_peak_memory_stats()
    print(json.dumps({"summary": True, "program_max": lows, "control_min": highs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
