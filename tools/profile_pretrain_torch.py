"""Where one pretrain step's time goes, on a CUDA GPU.

    python tools/profile_pretrain_torch.py [--out DIR]

Builds the port's ``Trainer`` on ``configs/_test_/pretrain_bench_torch.py``
(bench.py's PonderIndoor-v2 workload: batch 2, bf16) with seeded weights,
takes the loader's first batch, runs 2 warm-up steps on it, then prints (as
one JSON line) the host-clock median of 3 steps (batch to device ..
``loss.backward()``, SGD step, synchronised), the peak memory, and from a
``torch.profiler`` trace of one step: device busy time, idle share, kernel
launches, K1/K2/K3's device time, and the device time of the largest
kernels by name. ``--out`` also writes the profiler table and a Chrome
trace there.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tools")]

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

BAND_KERNELS = {"K1": "band_fwd_kernel", "K2": "band_dxdw_kernel", "K3": "band_dw_kernel"}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None, help="directory for table + trace")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_pretrain_torch: needs a CUDA GPU")
    from ponderv2_tpu_torch.engines.defaults import default_config_parser
    from ponderv2_tpu_torch.engines.train import Trainer

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = default_config_parser(
        os.path.join(ROOT, "configs/_test_/pretrain_bench_torch.py"),
        {"save_path": tempfile.mkdtemp(prefix="profile_pretrain_"), "seed": 0,
         "device": "cuda", "hooks": []})
    trainer = Trainer(cfg)
    trainer.comm_info["input_dict"] = next(iter(trainer.train_loader))

    def step():
        trainer.run_step()
        torch.cuda.synchronize()

    for _ in range(2):
        step()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(3):
        t = time.perf_counter()
        step()
        times.append(time.perf_counter() - t)
    step_ms = 1e3 * float(np.median(times))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]
    result = dict(
        step_ms=step_ms,
        peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
        device_busy_ms=busy,
        idle_share=1.0 - busy / step_ms,
        kernel_launches=sum(e.count for e in kernels),
        **{f"{k}_ms": sum(e.self_device_time_total for e in kernels if name in e.key) / 1e3
           for k, name in BAND_KERNELS.items()},
        top_kernels=[(e.key[:90], e.count, e.self_device_time_total / 1e3) for e in top],
    )
    print(json.dumps(result))
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "pretrain_profile_table.txt"), "w") as f:
            f.write(prof.key_averages().table(
                sort_by="self_device_time_total", row_limit=50,
                max_name_column_width=90))
        prof.export_chrome_trace(os.path.join(args.out, "pretrain_step_trace.json"))


if __name__ == "__main__":
    main()
